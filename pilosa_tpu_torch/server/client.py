"""HTTP client (reference: http/client.go InternalClient).

Used by applications, the CLI's import, export, backup and restore
commands, and the cluster layer's node-to-node calls (fan-out legs,
replicated imports, control messages, anti-entropy, resize). stdlib
urllib; no external deps. It speaks the JSON wire of the port's server
and of the TPU package's alike, and the protobuf wire
of stock Pilosa clients (`query_proto`, `import_bits_proto`,
`import_values_proto`, `import_roaring_proto`) through the port's
hand-written codec (numpy, no torch).

Resilience: every request takes an optional per-request deadline, and
idempotent requests (GETs, DELETEs, and the import paths — set-bit and
roaring imports re-apply cleanly, BSI values are last-write-wins) retry
transient failures with bounded, jittered exponential backoff. A 503
with ``Retry-After`` (readiness gating, resize-queue overflow) is always
retryable — the server has explicitly promised the request will work
later — and the advertised delay is honored up to the backoff cap."""

import json
import random
import threading
import time
import urllib.error
import urllib.request

# -- HTTP data-plane byte accounting ------------------------------------
# Response bytes of node-to-node REMOTE query fan-out — the cluster's
# HTTP DATA plane (result payloads), as opposed to control traffic.
# Process-wide (every Client instance counts).
_data_plane_lock = threading.Lock()
_data_plane_bytes = 0


def _note_data_plane(n):
    global _data_plane_bytes
    with _data_plane_lock:
        _data_plane_bytes += int(n)


def data_plane_bytes():
    with _data_plane_lock:
        return _data_plane_bytes


def reset_data_plane_bytes():
    """Bench/test isolation."""
    global _data_plane_bytes
    with _data_plane_lock:
        _data_plane_bytes = 0


class ClientError(Exception):
    def __init__(self, status, message):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class DeadlineExceeded(ClientError):
    """The per-request deadline expired before a successful response
    (status 0: the failure is client-side, no HTTP status exists)."""

    def __init__(self, message):
        super().__init__(0, message)


class Client:
    def __init__(self, base_url, timeout=30, tls_skip_verify=False,
                 ca_cert=None, retries=2, backoff=0.1, backoff_max=2.0,
                 deadline=None):
        """tls_skip_verify / ca_cert: https trust options (reference:
        tls.skip-verify / tls.ca-certificate server config).

        retries: extra attempts for retryable failures (0 disables);
        backoff/backoff_max: jittered exponential backoff bounds, also
        the cap on an honored ``Retry-After``; deadline: default
        per-request wall-clock budget in seconds across ALL attempts
        (None = no deadline; per-attempt socket timeout still applies)."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.backoff_max = backoff_max
        self.deadline = deadline
        self._ssl_context = None
        if base_url.startswith("https"):
            import ssl

            if tls_skip_verify:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                self._ssl_context = ctx
            elif ca_cert:
                self._ssl_context = ssl.create_default_context(
                    cafile=ca_cert)

    def _request(self, method, path, body=None,
                 content_type="application/json", idempotent=None,
                 deadline=None, headers=None):
        """idempotent: may network-level failures be retried? (an HTTP
        503 is retried regardless — the server rejected the request
        before doing work). Defaults to True for GET/DELETE.
        headers: extra request headers sent on every attempt (e.g. the
        forwarded X-Request-Deadline on cluster fan-out)."""
        if idempotent is None:
            idempotent = method in ("GET", "DELETE")
        if deadline is None:
            deadline = self.deadline
        deadline_at = None if deadline is None else \
            time.monotonic() + deadline
        attempt = 0
        while True:
            retry_after = None
            try:
                return self._request_once(method, path, body, content_type,
                                          deadline_at, headers)
            except ClientError as e:
                if e.status != 503 or attempt >= self.retries:
                    raise
                retry_after = getattr(e, "retry_after", None)
            except (urllib.error.URLError, TimeoutError, OSError):
                # includes socket.timeout and connection refused/reset;
                # non-idempotent requests may have partially executed
                if not idempotent or attempt >= self.retries:
                    raise
            delay = min(self.backoff_max,
                        self.backoff * (2 ** attempt))
            delay *= random.uniform(0.5, 1.0)  # jitter: decorrelate peers
            if retry_after is not None:
                # the server knows better than our backoff curve, but
                # never wait longer than the configured cap
                delay = min(max(delay, retry_after), self.backoff_max)
            if deadline_at is not None and \
                    time.monotonic() + delay >= deadline_at:
                raise DeadlineExceeded(
                    f"deadline exceeded after {attempt + 1} attempt(s): "
                    f"{method} {path}")
            time.sleep(delay)
            attempt += 1

    def _request_once(self, method, path, body, content_type, deadline_at,
                      headers=None):
        from ..utils import tracing

        timeout = self.timeout
        if deadline_at is not None:
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"deadline exceeded: {method} {path}")
            timeout = min(timeout, remaining)
        req = urllib.request.Request(
            self.base_url + path, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", content_type)
        if headers:
            for k, v in headers.items():
                req.add_header(k, v)
        for k, v in tracing.inject_headers().items():
            req.add_header(k, v)  # the caller's trace context (client inject)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout,
                    context=self._ssl_context) as resp:
                data = resp.read()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read().decode()).get("error", str(e))
            except Exception:
                message = str(e)
            err = ClientError(e.code, message)
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra is not None:
                try:
                    err.retry_after = float(ra)
                except ValueError:
                    pass
            # which shedding site rejected us (admission, coalesce,
            # ingest, resize_queue) — lets the cluster layer tell an
            # OVERLOADED peer from an unready/dead one
            shed = e.headers.get("X-Pilosa-Shed") if e.headers else None
            if shed is not None:
                err.shed = shed
            raise err from e
        if "/query" in path and "remote=true" in path:
            # JSON-wire remote fan-out: result bytes over HTTP
            _note_data_plane(len(data))
        if ctype.startswith("application/json"):
            return json.loads(data.decode()) if data else None
        return data

    # -- schema --------------------------------------------------------------

    def create_index(self, name, keys=False, track_existence=True):
        return self._request("POST", f"/index/{name}", json.dumps({
            "options": {"keys": keys, "trackExistence": track_existence},
        }).encode())

    def delete_index(self, name):
        return self._request("DELETE", f"/index/{name}")

    def create_field(self, index, field, options=None):
        return self._request(
            "POST", f"/index/{index}/field/{field}",
            json.dumps({"options": options or {}}).encode())

    def delete_field(self, index, field):
        return self._request("DELETE", f"/index/{index}/field/{field}")

    def schema(self):
        return self._request("GET", "/schema")

    # -- queries -------------------------------------------------------------

    @staticmethod
    def _query_headers(deadline, query_class):
        """X-Request-Deadline / X-Query-Class headers (None when
        neither is set). `deadline` is a RELATIVE budget in seconds —
        the receiving edge re-anchors it against its own clock, so
        coordinator/peer clock skew never corrupts the deadline."""
        headers = {}
        if deadline is not None:
            headers["X-Request-Deadline"] = f"{float(deadline):.6f}"
        if query_class is not None:
            headers["X-Query-Class"] = query_class
        return headers or None

    def query_proto(self, index, pql, shards=None, remote=False,
                    exclude_row_attrs=False, exclude_columns=False,
                    deadline=None, query_class=None):
        """Query over the protobuf data plane (reference:
        InternalClient.QueryNode posts proto QueryRequests). Returns
        (results, err). deadline: remaining budget in seconds, sent as
        X-Request-Deadline AND bounding local retries."""
        from .. import encoding

        body = encoding.encode_query_request(
            pql, shards=shards, remote=remote,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns)
        data = self._request(
            "POST", f"/index/{index}/query", body,
            content_type=encoding.CONTENT_TYPE_PROTOBUF,
            deadline=deadline,
            headers=self._query_headers(deadline, query_class))
        if remote and isinstance(data, (bytes, bytearray)):
            _note_data_plane(len(data))
        return encoding.decode_query_response(data)

    def _import_proto(self, path, message, clear, deadline):
        """POST one protobuf import message; returns the ImportResponse's
        Err ("" on success). Idempotent, like the JSON imports."""
        from ..encoding import CONTENT_TYPE_PROTOBUF, wire

        if clear:
            path += ("&" if "?" in path else "?") + "clear=true"
        data = self._request(
            "POST", path, message.SerializeToString(),
            content_type=CONTENT_TYPE_PROTOBUF, idempotent=True,
            deadline=deadline)
        return wire.ImportResponse.FromString(data).Err

    def import_bits_proto(self, index, field, row_ids, column_ids,
                          timestamps=None, clear=False, row_keys=None,
                          column_keys=None, deadline=None):
        """A stock client's ImportRequest (reference: handlePostImport
        http/handler.go:1076): ids as arrays or lists, timestamps as unix
        nanoseconds (0 = none). Returns the response's Err."""
        from ..encoding import wire

        msg = wire.ImportRequest(Index=index, Field=field)
        msg.RowIDs.extend(row_ids if row_keys is None else [])
        msg.ColumnIDs.extend(column_ids if column_keys is None else [])
        if timestamps is not None:
            msg.Timestamps.extend(timestamps)
        if row_keys is not None:
            msg.RowKeys.extend(row_keys)
        if column_keys is not None:
            msg.ColumnKeys.extend(column_keys)
        return self._import_proto(f"/index/{index}/field/{field}/import",
                                  msg, clear, deadline)

    def import_values_proto(self, index, field, column_ids, values,
                            clear=False, column_keys=None, deadline=None):
        """A stock client's ImportValueRequest for an int field. Returns
        the response's Err."""
        from ..encoding import wire

        msg = wire.ImportValueRequest(Index=index, Field=field)
        msg.ColumnIDs.extend(column_ids if column_keys is None else [])
        msg.Values.extend(values)
        if column_keys is not None:
            msg.ColumnKeys.extend(column_keys)
        return self._import_proto(f"/index/{index}/field/{field}/import",
                                  msg, clear, deadline)

    def import_roaring_proto(self, index, field, shard, views, clear=False,
                             deadline=None):
        """A stock client's ImportRoaringRequest: `views` maps a view
        name ("" or "standard" for the standard view) to one serialized
        roaring blob of row * SHARD_WIDTH + offset positions. Returns the
        response's Err."""
        from ..encoding import wire

        msg = wire.ImportRoaringRequest(Clear=clear)
        for name, data in views.items():
            msg.views.add(Name=name, Data=data)
        return self._import_proto(
            f"/index/{index}/field/{field}/import-roaring/{shard}", msg,
            False, deadline)

    def query(self, index, pql, shards=None, remote=False,
              exclude_row_attrs=False, exclude_columns=False,
              profile=False, explain=None, deadline=None,
              query_class=None):
        """(reference: InternalClient.QueryNode http/client.go:268; remote
        marks node-to-node fan-out requests that must not re-fan-out;
        profile asks the server to return the query's span-tree profile
        alongside the results; explain="plan" returns the annotated plan
        WITHOUT executing, explain="analyze" executes and returns the
        plan with actual costs grafted on; deadline: remaining budget in
        seconds,
        sent as X-Request-Deadline and bounding local retries;
        query_class: admission class forwarded as X-Query-Class)"""
        path = f"/index/{index}/query"
        params = []
        if shards is not None:
            params.append("shards=" + ",".join(str(s) for s in shards))
        if remote:
            params.append("remote=true")
        if exclude_row_attrs:
            params.append("excludeRowAttrs=true")
        if exclude_columns:
            params.append("excludeColumns=true")
        if profile:
            params.append("profile=true")
        if explain:
            params.append(f"explain={explain}")
        if params:
            path += "?" + "&".join(params)
        return self._request(
            "POST", path, pql.encode(), content_type="text/plain",
            deadline=deadline,
            headers=self._query_headers(deadline, query_class))

    # -- imports -------------------------------------------------------------

    def import_bits(self, index, field, row_ids, column_ids,
                    timestamps=None, clear=False, remote=False,
                    row_keys=None, column_keys=None, deadline=None):
        """idempotent=True: re-setting a set bit is a no-op, so a retry
        after an ambiguous network failure cannot corrupt anything."""
        path = f"/index/{index}/field/{field}/import"
        params = []
        if clear:
            params.append("clear=true")
        if remote:
            params.append("remote=true")
        if params:
            path += "?" + "&".join(params)
        body = {}
        if row_keys is not None:
            body["rowKeys"] = list(row_keys)
        else:
            body["rowIDs"] = [int(r) for r in row_ids]
        if column_keys is not None:
            body["columnKeys"] = list(column_keys)
        else:
            body["columnIDs"] = [int(c) for c in column_ids]
        if timestamps is not None:
            body["timestamps"] = timestamps
        return self._request("POST", path, json.dumps(body).encode(),
                             idempotent=True, deadline=deadline)

    def import_values(self, index, field, column_ids, values, remote=False,
                      column_keys=None, clear=False, deadline=None):
        """idempotent=True: replaying the same value assignment is
        last-write-wins over itself."""
        path = f"/index/{index}/field/{field}/import"
        params = [p for p, on in (("remote=true", remote),
                                  ("clear=true", clear)) if on]
        if params:
            path += "?" + "&".join(params)
        body = {"values": [int(v) for v in values]}
        if column_keys is not None:
            body["columnKeys"] = list(column_keys)
        else:
            body["columnIDs"] = [int(c) for c in column_ids]
        return self._request("POST", path, json.dumps(body).encode(),
                             idempotent=True, deadline=deadline)

    def import_roaring(self, index, field, shard, data, clear=False,
                       view="standard", remote=False, deadline=None):
        path = (f"/index/{index}/field/{field}/import-roaring/{shard}"
                f"?view={view}")
        if clear:
            path += "&clear=true"
        if remote:
            path += "&remote=true"
        return self._request(
            "POST", path, data, content_type="application/octet-stream",
            idempotent=True, deadline=deadline)

    # -- misc ----------------------------------------------------------------

    def status(self):
        return self._request("GET", "/status")

    def info(self):
        return self._request("GET", "/info")

    # -- debug / observability -----------------------------------------------

    def debug_oplog(self):
        """The peer's durable-oplog summary (segments, checkpoint,
        replay lag); {"enabled": False} when the node runs without one."""
        return self._request("GET", "/debug/oplog")

    def debug_dispatch(self):
        """The peer's per-kernel dispatch-phase decomposition."""
        return self._request("GET", "/debug/dispatch")

    def debug_kernels(self, costs=True):
        """The peer's per-family kernel attribution; costs=False skips
        the declared costs of the launched kernel shapes."""
        path = "/debug/kernels" + ("" if costs else "?costs=false")
        return self._request("GET", path)

    def debug_plans(self, limit=None):
        """The peer's retained (misestimated) EXPLAIN ANALYZE plans +
        misestimate counters; limit=0 fetches counters only."""
        path = "/debug/plans"
        if limit is not None:
            path += f"?limit={int(limit)}"
        return self._request("GET", path)

    def debug_flightrecorder(self, limit=None):
        """The peer's flight-recorder tail."""
        path = "/debug/flightrecorder"
        if limit is not None:
            path += f"?limit={int(limit)}"
        return self._request("GET", path)

    def debug_hbm(self, top=50):
        """The peer's device-memory ledger (a coordinator's /status
        roll-up reads this from every peer)."""
        return self._request("GET", f"/debug/hbm?top={top}")

    def debug_device(self, limit=None):
        """The peer's device-link health (state machine + canary ring);
        limit=0 fetches the state summary without the ring."""
        path = "/debug/device"
        if limit is not None:
            path += f"?limit={int(limit)}"
        return self._request("GET", path)

    def debug_workload(self, top=None):
        """The peer's per-fingerprint workload table (top-K rankings);
        top=1 fetches the headline entry only."""
        path = "/debug/workload"
        if top is not None:
            path += f"?top={int(top)}"
        return self._request("GET", path)

    def debug_heat(self, top=None):
        """The peer's fragment heat ledger joined against device
        residency; top=0 fetches totals without the ranked lists."""
        path = "/debug/heat"
        if top is not None:
            path += f"?top={int(top)}"
        return self._request("GET", path)

    def debug_slo(self):
        """The peer's SLO burn-rate state (objectives, windows,
        alerting flags)."""
        return self._request("GET", "/debug/slo")

    def debug_admission(self):
        """The peer's admission-controller snapshot (ladder state,
        token buckets, queue occupancy); {"enabled": False} when the
        node runs with --admission off."""
        return self._request("GET", "/debug/admission")

    def debug_trace(self, trace_id, deadline=2.0):
        """The peer's LOCAL finished spans for one trace id (the
        cross-node assembly getter: the coordinator merges these into
        one tree with skew-corrected timestamps). Short default deadline:
        assembly is best-effort garnish on a finished query, never worth
        blocking the response on a slow peer."""
        return self._request(
            "GET", f"/debug/traces/{trace_id}?local=true",
            deadline=deadline)

    def debug_incidents(self):
        """The peer's postmortem-bundle listing ({"enabled": False} when
        the node runs without --incident-dir)."""
        return self._request("GET", "/debug/incidents")

    def debug_spmd(self, deadline=2.0):
        """The peer's collective-plane snapshot (serve mode, step
        lifecycle counters, stream and observatory state); {"enabled":
        False} when the node runs without --spmd. Short deadline: the
        /status roll-up must never wedge behind a stalled group."""
        return self._request("GET", "/debug/spmd", deadline=deadline)

    def debug_spmd_steps(self, seq=None, limit=None, deadline=2.0):
        """The peer's LOCAL slice of the collective step timeline (its
        step ring with per-phase walls, stamped with the peer's wall
        clock): the ?local=true form, so the coordinator skew-corrects
        from the RPC envelope and merges, and the fan-out never
        recurses."""
        path = "/debug/spmd/steps"
        if seq is not None:
            path += f"/{int(seq)}"
        path += "?local=true"
        if limit is not None:
            path += f"&limit={int(limit)}"
        return self._request("GET", path, deadline=deadline)

    def export_csv(self, index, field, shard):
        data = self._request(
            "GET", f"/export?index={index}&field={field}&shard={shard}")
        return data.decode() if isinstance(data, bytes) else data

    def nodes(self):
        return self._request("GET", "/internal/nodes")

    # -- node-to-node internals (reference: http/client.go internal paths) ---

    def index_shards(self, index):
        """Available shards on this node (reference: availableShards
        gossip; here an internal endpoint)."""
        return self._request("GET", f"/internal/index/{index}/shards")

    def spmd_step(self, step):
        """Announce a collective step (control plane; the result itself
        merges over the process group). Never retried: a step entered
        twice would unpair the collectives."""
        return self._request("POST", "/internal/spmd/step",
                             json.dumps(step).encode())

    def spmd_stream(self, step):
        """Announce a STREAMED collective step (serve mode on): the peer
        enqueues it by sequence number and acks at once, without waiting
        for the collective. Never retried, as spmd_step."""
        return self._request("POST", "/internal/spmd/stream",
                             json.dumps(step).encode())

    def spmd_validate(self, step):
        """Pre-flight a collective step (cheap, short deadline)."""
        return self._request("POST", "/internal/spmd/validate",
                             json.dumps(step).encode())

    def spmd_initiate(self, payload):
        """Forward an eligible call to the coordinator, which initiates
        its collective step (the non-coordinator's one hop)."""
        return self._request("POST", "/internal/spmd/initiate",
                             json.dumps(payload).encode())

    def shard_fragments(self, index, shard):
        """(field, view) fragments a node holds for one shard (backup's
        discovery: the views are data-dependent)."""
        return self._request(
            "GET", f"/internal/index/{index}/shard/{shard}/fragments")

    def send_message(self, data):
        """POST a control-plane message (reference: SendMessage
        http/client.go:1017 -> /internal/cluster/message)."""
        return self._request(
            "POST", "/internal/cluster/message", data,
            content_type="application/octet-stream")

    def fragment_blocks(self, index, field, view, shard):
        """(reference: /internal/fragment/blocks handler.go:300)"""
        return self._request(
            "GET", f"/internal/fragment/blocks?index={index}&field={field}"
                   f"&view={view}&shard={shard}")

    def fragment_block_data(self, index, field, view, shard, block):
        """(reference: /internal/fragment/block/data)"""
        return self._request(
            "GET", f"/internal/fragment/block/data?index={index}"
                   f"&field={field}&view={view}&shard={shard}&block={block}")

    def fragment_data(self, index, field, view, shard):
        """Whole serialized fragment (reference: /internal/fragment/data,
        http/client.go:742)."""
        return self._request(
            "GET", f"/internal/fragment/data?index={index}&field={field}"
                   f"&view={view}&shard={shard}")

    def translate_entries(self, index, field="", offset=0):
        """Translate-store replication feed (reference: /internal/translate/
        data holder.go:702-880)."""
        return self._request(
            "GET", f"/internal/translate/data?index={index}&field={field}"
                   f"&offset={offset}")

    # -- resize admin (reference: /cluster/resize/* api.go:1193-1267) --------

    def resize_add_node(self, node_id, uri):
        return self._request(
            "POST", "/cluster/resize/add-node",
            json.dumps({"id": node_id, "uri": uri}).encode())

    def resize_remove_node(self, node_id):
        return self._request(
            "POST", "/cluster/resize/remove-node",
            json.dumps({"id": node_id}).encode())

    def resize_abort(self):
        return self._request("POST", "/cluster/resize/abort", b"{}")

    def resize_status(self):
        return self._request("GET", "/cluster/resize/status")

    def set_coordinator(self, node_id):
        return self._request(
            "POST", "/cluster/resize/set-coordinator",
            json.dumps({"id": node_id}).encode())

    def translate_keys_create(self, index, field, keys):
        """Allocate key ids on the primary (reference: translate key
        writes route to primary http/handler.go:518-522)."""
        return self._request(
            "POST", "/internal/translate/keys",
            json.dumps({"index": index, "field": field,
                        "keys": list(keys)}).encode())

    def attr_blocks(self, index, field=""):
        """(reference: attr diff endpoints api.go:817-891)"""
        return self._request(
            "GET", f"/internal/attr/blocks?index={index}&field={field}")

    def attr_block_data(self, index, field="", block=0):
        return self._request(
            "GET", f"/internal/attr/data?index={index}&field={field}"
                   f"&block={block}")

    def attr_diff(self, index, blocks, field=""):
        """Post local block checksums, receive attrs from every block the
        peer has that differs (reference: handler.go:312,315)."""
        path = f"/internal/index/{index}/attr/diff" if not field else \
            f"/internal/index/{index}/field/{field}/attr/diff"
        return self._request(
            "POST", path, json.dumps({"blocks": blocks}).encode())
