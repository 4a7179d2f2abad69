"""HTTP transport (reference: http/handler.go).

Stdlib ThreadingHTTPServer + a regex router over the reference's public
single-node REST surface, the node internals that backup, export and
restore read (/internal/...), the cluster's routes (control messages,
fragment placement, key and attribute replication, /cluster/resize/*;
`remote=true` marks a peer's fan-out leg or forwarded import), and the
debug surface (GET /debug lists
it): metrics (/metrics, /debug/vars), query profiles (?profile=true,
/debug/queries), traces, the flight recorder, the dispatch-phase split,
thread dumps and a sampling profiler, batching, the oplog and fault
points, device health (/readyz, /debug/device), the workload table,
fragment heat, SLO burn, the HBM ledger, incident bundles, the
kernels' declared costs (/debug/kernels), misestimated plans
(/debug/plans), the adaptive engine (/debug/optimizer), the ingest
engine (/debug/ingest), whole-plan fusion (/debug/fusion) and the
admission controller (/debug/admission), with the TPU package's JSON
wire shapes. A query's `?explain=true|plan|analyze` returns its plan
tree beside the results (exec/plan.py); its `X-Request-Deadline` and
`X-Query-Class` headers reach the API's deadline checks and admission
gate, and a response served while the degradation ladder allows stale
reads says `"stale": true`. Every request runs under a span
continued from its trace headers and is timed into
`http_request_seconds{route,method,status}`.

A body sent as application/x-protobuf to the query, import and
import-roaring routes is decoded with the hand-written codec of
`encoding/` (QueryRequest, ImportRequest / ImportValueRequest by field
type, ImportRoaringRequest) and answered in protobuf, as the reference
serves stock Pilosa clients. With `tls_cert`/`tls_key` the listener
serves HTTPS (`reload_tls` swaps the pair in place, keeping the last
good one on a bad rotation); with `allowed_origins` it answers CORS
preflights and adds Access-Control-Allow-Origin to matching requests.
"""

import datetime
import json
import re
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import encoding
from ..core import timeq
from ..core.field import FIELD_TYPE_INT
from ..core.index import IndexOptions
from ..encoding import wire
from ..exec import ExecOptions
from ..utils import devhealth, faultpoints, flightrec, incident, tracing
from ..utils import workload, workpool
from ..utils import profile as profile_mod
from ..utils.stats import global_stats, registry_of
from .admission import CLASSES as QUERY_CLASSES
from .admission import parse_deadline
from .api import ApiError, GatewayTimeoutError, NotFoundError, \
    ServiceUnavailableError, field_options_from_json, result_to_json


class Route:
    def __init__(self, method, pattern, fn, args=None):
        self.method = method
        # the raw pattern doubles as the route's metrics label: bounded
        # cardinality, unlike raw request paths
        self.pattern = pattern
        self.regex = re.compile("^" + pattern + "$")
        self.fn = fn
        # allowed query-string arg names; None = no validation
        self.args = frozenset(args) if args is not None else None


class Request:
    __slots__ = ("params", "query", "body", "content_type", "headers")

    def __init__(self, params, query, body, content_type="", headers=None):
        self.params = params
        self.query = query
        self.body = body
        self.content_type = content_type
        # the raw http.client message (dict-like, case-insensitive) —
        # None in tests that build Requests by hand
        self.headers = headers

    @property
    def protobuf(self):
        return self.content_type.startswith(encoding.CONTENT_TYPE_PROTOBUF)

    def json(self):
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


class RawResponse:
    """A non-JSON response body (CSV export, protobuf)."""
    __slots__ = ("body", "content_type")

    def __init__(self, body, content_type):
        self.body = body
        self.content_type = content_type


class PilosaHTTPServer:
    """Owns the listening socket and the route table. `port=0` binds an
    ephemeral port; `self.port` holds the bound one after start().
    `tls_cert`/`tls_key` (PEM files) serve HTTPS; `allowed_origins` (a
    list, "*" for any) turns on CORS."""

    def __init__(self, api, host="127.0.0.1", port=10101, stats=None,
                 tls_cert=None, tls_key=None, allowed_origins=None):
        self.api = api
        self.host = host
        self.port = port
        # the configured metrics sink; the global registry stays the
        # default so /metrics always has data
        self.stats = stats if stats is not None else global_stats
        # TLS (reference: server/tlsconfig.go; config tls.certificate/key)
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self._tls_ctx = None
        self._tls_last_good = None
        # CORS (reference: http/handler.go:83-91 OptHandlerAllowedOrigins):
        # origins allowed to hit the API from a browser; "*" allows all
        self.allowed_origins = list(allowed_origins or [])
        self._profiler = None
        self.routes = [
            Route("GET", r"/", self._home),
            Route("GET", r"/index", self._get_indexes),
            Route("POST", r"/index/(?P<index>[^/]+)", self._post_index),
            Route("GET", r"/index/(?P<index>[^/]+)", self._get_index),
            Route("DELETE", r"/index/(?P<index>[^/]+)", self._delete_index),
            Route("POST", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                  self._post_field),
            Route("DELETE", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                  self._delete_field),
            Route("POST", r"/index/(?P<index>[^/]+)/query",
                  self._post_query,
                  args=("shards", "remote", "columnAttrs",
                        "excludeRowAttrs", "excludeColumns", "profile",
                        "explain")),
            Route("POST", r"/index/(?P<index>[^/]+)/query-batch",
                  self._post_query_batch, args=("shards",)),
            Route("POST",
                  r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import",
                  self._post_import,
                  args=("clear", "remote", "ignoreKeyCheck")),
            Route("POST",
                  r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
                  r"/import-roaring/(?P<shard>[0-9]+)",
                  self._post_import_roaring,
                  args=("view", "clear", "remote")),
            Route("GET", r"/export", self._get_export,
                  args=("index", "field", "shard")),
            Route("GET", r"/schema", self._get_schema),
            Route("POST", r"/schema", self._post_schema),
            Route("GET", r"/status", self._get_status),
            Route("GET", r"/healthz", self._get_healthz),
            Route("GET", r"/readyz", self._get_readyz),
            Route("GET", r"/info", self._get_info),
            Route("GET", r"/version", self._get_version),
            Route("POST", r"/recalculate-caches", self._recalculate_caches),
            Route("GET", r"/internal/shards/max", self._get_shards_max),
            Route("GET", r"/internal/nodes", self._get_nodes),
            Route("GET", r"/internal/index/(?P<index>[^/]+)/shards",
                  self._get_index_shards),
            Route("GET",
                  r"/internal/index/(?P<index>[^/]+)/shard/(?P<shard>[0-9]+)"
                  r"/fragments",
                  self._get_shard_fragments),
            Route("GET", r"/internal/fragment/blocks",
                  self._get_fragment_blocks,
                  args=("index", "field", "view", "shard")),
            Route("GET", r"/internal/fragment/block/data",
                  self._get_fragment_block_data),
            Route("GET", r"/internal/fragment/data",
                  self._get_fragment_data,
                  args=("index", "field", "view", "shard")),
            Route("POST", r"/internal/cluster/message", self._post_message),
            Route("POST", r"/internal/spmd/step", self._post_spmd_step),
            Route("POST", r"/internal/spmd/stream",
                  self._post_spmd_stream),
            Route("POST", r"/internal/spmd/validate",
                  self._post_spmd_validate),
            Route("POST", r"/internal/spmd/initiate",
                  self._post_spmd_initiate),
            Route("GET", r"/internal/spmd/stats", self._get_spmd_stats),
            Route("GET", r"/internal/fragment/nodes",
                  self._get_fragment_nodes),
            Route("DELETE",
                  r"/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
                  r"/remote-available-shards/(?P<shard>[0-9]+)",
                  self._delete_remote_available_shard),
            Route("GET", r"/internal/translate/data",
                  self._get_translate_data),
            Route("POST", r"/internal/translate/data",
                  self._post_translate_data),
            Route("POST", r"/internal/translate/keys",
                  self._post_translate_keys),
            Route("GET", r"/internal/attr/blocks", self._get_attr_blocks),
            Route("GET", r"/internal/attr/data", self._get_attr_block_data),
            Route("POST", r"/internal/index/(?P<index>[^/]+)/attr/diff",
                  self._post_index_attr_diff),
            Route("POST",
                  r"/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
                  r"/attr/diff",
                  self._post_field_attr_diff),
            Route("POST", r"/cluster/resize/add-node", self._resize_add_node),
            Route("POST", r"/cluster/resize/remove-node",
                  self._resize_remove_node),
            Route("POST", r"/cluster/resize/abort", self._resize_abort),
            Route("GET", r"/cluster/resize/status", self._resize_status),
            Route("POST", r"/cluster/resize/set-coordinator",
                  self._set_coordinator),
            Route("GET", r"/metrics", self._get_metrics),
            Route("GET", r"/debug", self._get_debug_index),
            Route("GET", r"/debug/vars", self._get_debug_vars),
            Route("GET", r"/debug/queries", self._get_debug_queries),
            Route("GET", r"/debug/traces", self._get_debug_traces),
            Route("GET", r"/debug/traces/(?P<trace_id>[^/?]+)",
                  self._get_debug_trace, args=("local",)),
            Route("GET", r"/debug/flightrecorder",
                  self._get_flightrecorder, args=("limit",)),
            Route("GET", r"/debug/dispatch", self._get_debug_dispatch),
            Route("GET", r"/debug/device", self._get_debug_device,
                  args=("limit",)),
            Route("GET", r"/debug/hbm", self._get_debug_hbm,
                  args=("top",)),
            Route("GET", r"/debug/kernels", self._get_debug_kernels,
                  args=("costs",)),
            Route("GET", r"/debug/plans", self._get_debug_plans,
                  args=("limit",)),
            Route("GET", r"/debug/optimizer", self._get_debug_optimizer),
            Route("GET", r"/debug/ingest", self._get_debug_ingest),
            Route("GET", r"/debug/fusion", self._get_debug_fusion),
            Route("GET", r"/debug/spmd", self._get_debug_spmd),
            Route("POST", r"/debug/spmd", self._post_debug_spmd),
            Route("GET", r"/debug/spmd/steps", self._get_debug_spmd_steps,
                  args=("local", "limit")),
            Route("GET", r"/debug/spmd/steps/(?P<seq>[0-9]+)",
                  self._get_debug_spmd_step, args=("local", "limit")),
            Route("GET", r"/debug/admission", self._get_debug_admission),
            Route("GET", r"/debug/workload", self._get_debug_workload,
                  args=("top",)),
            Route("GET", r"/debug/heat", self._get_debug_heat,
                  args=("top",)),
            Route("GET", r"/debug/slo", self._get_debug_slo),
            Route("GET", r"/debug/incidents", self._get_debug_incidents),
            Route("GET", r"/debug/incidents/(?P<incident_id>[^/?]+)",
                  self._get_debug_incident),
            Route("GET", r"/debug/batching", self._get_debug_batching),
            Route("GET", r"/debug/oplog", self._get_debug_oplog),
            Route("GET", r"/debug/faultpoints", self._get_faultpoints),
            Route("POST", r"/debug/faultpoints", self._post_faultpoints),
            Route("GET", r"/debug/threads", self._get_threads),
            Route("GET", r"/debug/pprof/goroutine", self._get_threads),
            Route("POST", r"/debug/pprof/profile/start",
                  self._profile_start),
            Route("POST", r"/debug/pprof/profile/stop", self._profile_stop),
        ]
        self._httpd = None
        self._thread = None

    # -- handlers ------------------------------------------------------------

    def _home(self, req):
        return {"pilosa_tpu_torch": "the bitmap index on PyTorch and CUDA",
                "version": self.api.info()["version"],
                "device": str(self.api.device)}

    def _get_indexes(self, req):
        return self.api.schema()

    def _get_schema(self, req):
        return self.api.schema()

    def _post_schema(self, req):
        self.api.apply_schema(req.json())
        return None

    def _get_status(self, req):
        # ?observability=true: a cluster coordinator also gathers every
        # peer's roll-up (short-timeout client fetches)
        return self.api.status(
            include_remote_observability=(
                self._q1(req, "observability", "false") == "true"))

    def _get_healthz(self, req):
        """Liveness: the process is up and serving HTTP. Deliberately
        ignores the device link — a wedged card needs draining
        (/readyz), not a restart loop."""
        return {"status": "ok"}

    def _get_readyz(self, req):
        """Readiness, gated on the device-link prober: LIVE, DEGRADED,
        and DISABLED (no prober configured) serve; DOWN answers 503 +
        Retry-After so load balancers drain the node until canary
        probes recover."""
        state = devhealth.state()
        if state == devhealth.DOWN:
            raise ServiceUnavailableError(
                f"not ready: device link {state}",
                retry_after=devhealth.retry_after_seconds())
        return {"status": "ok", "device_link": state}

    def _get_info(self, req):
        return self.api.info()

    def _get_version(self, req):
        return {"version": self.api.info()["version"]}

    def _recalculate_caches(self, req):
        self.api.recalculate_caches()
        return None

    def _post_index(self, req):
        body = req.json() or {}
        opts = body.get("options", {})
        self.api.create_index(req.params["index"], IndexOptions(
            keys=bool(opts.get("keys", False)),
            track_existence=bool(opts.get("trackExistence", True))))
        return {"success": True}

    def _get_index(self, req):
        idx = self.api.holder.index(req.params["index"])
        if idx is None:
            raise NotFoundError("index not found")
        return {"name": idx.name, "options": idx.options.to_dict()}

    def _delete_index(self, req):
        self.api.delete_index(req.params["index"])
        return {"success": True}

    def _post_field(self, req):
        body = req.json() or {}
        options = field_options_from_json(body.get("options"))
        self.api.create_field(req.params["index"], req.params["field"],
                              options)
        return {"success": True}

    def _delete_field(self, req):
        self.api.delete_field(req.params["index"], req.params["field"])
        return {"success": True}

    @staticmethod
    def _admission_headers(req):
        """(absolute time.monotonic() deadline, query class) from the
        request's `X-Request-Deadline` and `X-Query-Class` headers, each
        None when absent. A malformed value is a 400 at the edge; an
        already-negative budget still parses (api.query answers it with
        504)."""
        hdrs = req.headers
        qclass = None
        raw = hdrs.get("X-Query-Class") if hdrs is not None else None
        if raw is not None:
            qclass = raw.strip().lower()
            if qclass not in QUERY_CLASSES:
                raise ApiError(
                    "X-Query-Class must be interactive|batch|internal, "
                    f"got {raw!r}")
        deadline = None
        raw = hdrs.get("X-Request-Deadline") if hdrs is not None else None
        if raw is not None:
            try:
                remaining = parse_deadline(raw)
            except ValueError as e:
                raise ApiError(
                    f"invalid X-Request-Deadline {raw!r}: {e}") from e
            deadline = time.monotonic() + remaining
        return deadline, qclass

    @staticmethod
    def _decode(cls, req):
        """One protobuf message of `cls` from the request body; a body
        that is not one is a 400."""
        try:
            return cls.FromString(req.body)
        except wire.DecodeError as e:
            raise ApiError(f"invalid {cls.__name__} body: {e}") from e

    def _post_query_proto(self, req, deadline, qclass):
        """The protobuf data plane, wire-compatible with the reference's
        QueryRequest/QueryResponse (encoding/proto/proto.go): query
        errors (a missing index too) travel in-band in
        QueryResponse.Err; an unready node (503) and a lapsed deadline
        (504) stay HTTP-visible."""
        q = self._decode(wire.QueryRequest, req)
        options = ExecOptions(
            remote=q.Remote, column_attrs=q.ColumnAttrs,
            exclude_row_attrs=q.ExcludeRowAttrs,
            exclude_columns=q.ExcludeColumns)
        try:
            results = self.api.query(
                req.params["index"], q.Query, shards=list(q.Shards) or None,
                options=options, deadline=deadline, query_class=qclass)
            attr_sets = self.api.column_attr_sets(
                req.params["index"], results) if q.ColumnAttrs else None
            body = encoding.encode_query_response(
                results, column_attr_sets=attr_sets)
        except (ServiceUnavailableError, GatewayTimeoutError):
            # the status code and Retry-After must reach the client; an
            # embedded error string would lose them
            raise
        except ApiError as e:
            body = encoding.encode_query_response([], err=str(e))
        return RawResponse(body, encoding.CONTENT_TYPE_PROTOBUF)

    def _post_query(self, req):
        deadline, qclass = self._admission_headers(req)
        if req.protobuf:
            return self._post_query_proto(req, deadline, qclass)
        pql = req.body.decode("utf-8")
        shards = None
        if "shards" in req.query:
            shards = [int(s) for s in req.query["shards"][0].split(",") if s]

        def flag(name):
            return req.query.get(name, ["false"])[0] == "true"

        column_attrs = flag("columnAttrs")
        want_profile = flag("profile")
        # ?explain=true|plan plans without executing; ?explain=analyze
        # executes and grafts actual costs (see exec/plan.py)
        explain = None
        raw_explain = req.query.get("explain", [None])[0]
        if raw_explain is not None:
            explain = {"true": "plan", "plan": "plan",
                       "analyze": "analyze",
                       "false": None}.get(raw_explain.lower(), "bad")
            if explain == "bad":
                raise ApiError(
                    f"explain must be true|plan|analyze, "
                    f"got {raw_explain!r}")
        options = ExecOptions(
            exclude_columns=flag("excludeColumns"),
            column_attrs=column_attrs,
            exclude_row_attrs=flag("excludeRowAttrs"),
            remote=flag("remote"), profile=want_profile, explain=explain)
        results = self.api.query(req.params["index"], pql, shards=shards,
                                 options=options, deadline=deadline,
                                 query_class=qclass)
        out = {"results": [result_to_json(r) for r in results]}
        if self.api.serving_stale():
            # degradation ladder at STALE_OK+: reads may lag the ingest
            # staleness bound — marked so clients can tell
            out["stale"] = True
        if explain is not None:
            from ..exec import plan as plan_mod

            # the executor stashed this thread's plan envelope
            out["plan"] = plan_mod.take_last()
        if want_profile:
            # api.query stashed the finished profile on this thread
            out["profile"] = profile_mod.take_last()
        if column_attrs:
            # reference: QueryResponse "columnAttrs" JSON field
            out["columnAttrs"] = self.api.column_attr_sets(
                req.params["index"], results)
        return out

    def _post_query_batch(self, req):
        """Batched query endpoint: a JSON list of PQL strings executed as
        batched launches (the coalescer's executor path). Body:
        {"queries": ["Count(Row(f=1))", ...]} — or a bare JSON list.
        Per-query error isolation: each slot of "results" is either
        {"results": [...], "batch": n} or {"error": "..."}."""
        try:
            body = req.json()
        except ValueError as e:
            raise ApiError(f"invalid JSON body: {e}") from e
        queries = body.get("queries") if isinstance(body, dict) else body
        if not isinstance(queries, list) \
                or not all(isinstance(q, str) for q in queries):
            raise ApiError(
                'body must be {"queries": [<pql>, ...]} or a JSON list '
                "of PQL strings")
        shards = None
        if "shards" in req.query:
            shards = [int(s) for s in req.query["shards"][0].split(",") if s]
        out = []
        for results, error, bsize in self.api.query_batch(
                req.params["index"], queries, shards=shards):
            if error is not None:
                out.append({"error": str(error)})
            else:
                out.append({"results": [result_to_json(r)
                                        for r in results],
                            "batch": bsize})
        return {"results": out}

    def _get_debug_batching(self, req):
        """Coalescer queue depth / occupancy histogram / rejects plus the
        batched-launch counters."""
        return self.api.batching_stats()

    def _post_import_proto(self, req, clear, remote=False):
        """A stock client's protobuf import (reference: handlePostImport
        http/handler.go:1076): ImportValueRequest for an int field,
        ImportRequest otherwise, timestamps in unix NANOseconds;
        answered with ImportResponse bytes. Failures answer a non-proto
        error body with a non-200 status, as the reference does. Ids and
        values go to the API as the decoder's numpy arrays."""
        index, field = req.params["index"], req.params["field"]
        fld = self.api._field(index, field)  # 404 on unknown
        if fld.type == FIELD_TYPE_INT:
            msg = self._decode(wire.ImportValueRequest, req)
            self.api.import_values(
                index, field, msg.ColumnIDs.array, msg.Values.array,
                clear=clear, remote=remote,
                column_keys=list(msg.ColumnKeys) or None)
        else:
            msg = self._decode(wire.ImportRequest, req)
            timestamps = None
            if msg.Timestamps.array.any():
                timestamps = [
                    datetime.datetime.fromtimestamp(
                        ts / 1e9, datetime.timezone.utc).replace(
                            tzinfo=None) if ts else None
                    for ts in msg.Timestamps]
            self.api.import_bits(
                index, field, msg.RowIDs.array, msg.ColumnIDs.array,
                timestamps=timestamps, clear=clear, remote=remote,
                row_keys=list(msg.RowKeys) or None,
                column_keys=list(msg.ColumnKeys) or None)
        return RawResponse(wire.ImportResponse(Err="").SerializeToString(),
                           encoding.CONTENT_TYPE_PROTOBUF)

    def _post_import(self, req):
        clear = req.query.get("clear", ["false"])[0] == "true"
        # remote=true: a cluster peer's forwarded slice, applied here only
        remote = req.query.get("remote", ["false"])[0] == "true"
        if req.protobuf:
            return self._post_import_proto(req, clear, remote)
        body = req.json()
        if body is None:
            raise ApiError("import requires a JSON body")
        index, field = req.params["index"], req.params["field"]
        if "values" in body:
            changed = self.api.import_values(
                index, field, body.get("columnIDs", []), body["values"],
                clear=clear, remote=remote,
                column_keys=body.get("columnKeys"))
        else:
            timestamps = body.get("timestamps")
            if timestamps is not None:
                timestamps = [timeq.parse_time(t) if t else None
                              for t in timestamps]
            changed = self.api.import_bits(
                index, field, body.get("rowIDs", []),
                body.get("columnIDs", []), timestamps=timestamps,
                clear=clear, remote=remote, row_keys=body.get("rowKeys"),
                column_keys=body.get("columnKeys"))
        return {"changed": changed}

    def _post_import_roaring(self, req):
        """The body is one serialized roaring bitmap of row * SHARD_WIDTH
        + offset positions for shard {shard} of `view` — or, sent as
        application/x-protobuf, an ImportRoaringRequest with one blob per
        view (an empty view name is the standard view), answered with
        ImportResponse bytes (reference: handlePostImportRoaring
        http/handler.go)."""
        remote = req.query.get("remote", ["false"])[0] == "true"
        if req.protobuf:
            msg = self._decode(wire.ImportRoaringRequest, req)
            for v in msg.views:
                self.api.import_roaring(
                    req.params["index"], req.params["field"],
                    int(req.params["shard"]), v.Data, clear=msg.Clear,
                    view=v.Name or "standard", remote=remote)
            return RawResponse(
                wire.ImportResponse(Err="").SerializeToString(),
                encoding.CONTENT_TYPE_PROTOBUF)
        changed = self.api.import_roaring(
            req.params["index"], req.params["field"],
            int(req.params["shard"]), req.body,
            clear=req.query.get("clear", ["false"])[0] == "true",
            view=req.query.get("view", ["standard"])[0], remote=remote)
        return {"changed": changed}

    def _get_shards_max(self, req):
        return self.api.shards_max()

    def _get_nodes(self, req):
        return self.api.hosts()

    def _get_index_shards(self, req):
        return self.api.index_shards(req.params["index"])

    def _get_shard_fragments(self, req):
        return self.api.shard_fragments(
            req.params["index"], req.params["shard"])

    # -- cluster internals (control messages, placement, keys, attrs) -------

    def _post_message(self, req):
        self.api.receive_message(req.body)
        return None

    # -- the collective data plane's control routes (cluster/spmd.py) -----

    def _post_spmd_step(self, req):
        return {"value": self.api.spmd_step(req.json())}

    def _post_spmd_stream(self, req):
        """Streamed step announcement (serve mode on): enqueue and ack;
        the peer's stream runner runs the step, which is what lets the
        coordinator announce the next one at the ack."""
        return self.api.spmd_stream(req.json())

    def _post_spmd_validate(self, req):
        if self.api.spmd is None:
            return {"ok": False, "reason": "spmd mode not enabled"}
        return self.api.spmd.validate(req.json())

    def _post_spmd_initiate(self, req):
        """Non-coordinators forward eligible calls here: the coordinator
        is the single step initiator."""
        if self.api.spmd is None:
            return {"used": False}
        return self.api.spmd.initiate(req.json())

    def _get_spmd_stats(self, req):
        if self.api.spmd is None:
            return {"steps": 0, "initialized": False}
        return self.api.spmd.stats()

    def _get_debug_spmd(self, req):
        """The collective plane's state: serve mode and mesh shape, the
        per-node step-lifecycle counters (announced/entered/exited),
        stream state, mesh-cache stats, and the HTTP data-plane byte
        counter."""
        return self.api.spmd_debug()

    def _post_debug_spmd(self, req):
        """Run-time serve-mode switch: {"serve_mode": off|on|shadow|http}
        ("http" forces the HTTP fan-out for A/B runs on one cluster)."""
        body = req.json() or {}
        return self.api.spmd_set_mode(body.get("serve_mode"))

    def _get_debug_spmd_steps(self, req, seq=None):
        """The cross-node collective step timeline: every peer's
        per-phase step walls skew-corrected onto this node's clock and
        merged by seq, with per-phase straggler attribution. ?local=true
        returns this node's raw slice (what the coordinator fans out
        for)."""
        local_only = (self._q1(req, "local", "") or "").lower() \
            in ("1", "true", "yes")
        limit = self._q1(req, "limit", None)
        limit = int(limit) if limit is not None else 32
        return self.api.spmd_debug_steps(seq=seq, limit=limit,
                                         local_only=local_only)

    def _get_debug_spmd_step(self, req):
        """One step of the cross-node timeline by sequence number."""
        return self._get_debug_spmd_steps(req, seq=int(req.params["seq"]))

    def _get_fragment_nodes(self, req):
        """Owner nodes of one shard (reference: http/handler.go:311
        handleGetFragmentNodes — a stock internal client resolves fragment
        placement through this exact path)."""
        shard = self._q1(req, "shard")
        if shard is None or not shard.isdigit():
            raise ApiError("shard should be an unsigned integer")
        index = self._q1(req, "index")
        if not index:
            raise ApiError("index required")
        return self.api.shard_nodes(index, int(shard))

    def _delete_remote_available_shard(self, req):
        """(reference: http/handler.go:316 handleDeleteRemoteAvailableShard)"""
        self.api.delete_available_shard(
            req.params["index"], req.params["field"],
            int(req.params["shard"]))
        return {"success": True}

    def _get_translate_data(self, req):
        return self.api.translate_data(
            self._q1(req, "index"), self._q1(req, "field", ""),
            int(self._q1(req, "offset", "0")))

    def _post_translate_data(self, req):
        """POST sibling of the GET feed (reference: handler.go routes both
        methods to handleGetTranslateData): replication readers that carry
        the cursor in a JSON body instead of the query string."""
        body = req.json() or {}
        return self.api.translate_data(
            body.get("index", ""), body.get("field", ""),
            int(body.get("offset", 0)))

    def _post_translate_keys(self, req):
        body = req.json() or {}
        return self.api.translate_keys_create(
            body.get("index", ""), body.get("field", ""),
            body.get("keys", []))

    def _get_attr_blocks(self, req):
        return self.api.attr_blocks(
            self._q1(req, "index"), self._q1(req, "field", ""))

    def _get_attr_block_data(self, req):
        return self.api.attr_block_data(
            self._q1(req, "index"), self._q1(req, "field", ""),
            int(self._q1(req, "block", "0")))

    def _post_index_attr_diff(self, req):
        """(reference: handler.go:312 handlePostIndexAttrDiff)"""
        body = req.json() or {}
        return self.api.attr_diff(
            req.params["index"], "", body.get("blocks", []))

    def _post_field_attr_diff(self, req):
        """(reference: handler.go:315 handlePostFieldAttrDiff)"""
        body = req.json() or {}
        return self.api.attr_diff(
            req.params["index"], req.params["field"],
            body.get("blocks", []))

    # -- resize admin (reference: /cluster/resize/* api.go:1193-1267) ---------

    def _resize_add_node(self, req):
        return self.api.resize_add_node(req.json() or {})

    def _resize_remove_node(self, req):
        body = req.json() or {}
        return self.api.resize_remove_node(body.get("id"))

    def _resize_abort(self, req):
        return self.api.resize_abort()

    def _resize_status(self, req):
        return self.api.resize_status()

    def _set_coordinator(self, req):
        body = req.json() or {}
        return self.api.set_coordinator(body.get("id"))

    def _q1(self, req, key, default=None):
        return req.query.get(key, [default])[0]

    def _get_fragment_blocks(self, req):
        return self.api.fragment_blocks(
            self._q1(req, "index"), self._q1(req, "field"),
            self._q1(req, "view", "standard"), self._q1(req, "shard", "0"))

    def _get_fragment_block_data(self, req):
        return self.api.fragment_block_data(
            self._q1(req, "index"), self._q1(req, "field"),
            self._q1(req, "view", "standard"), self._q1(req, "shard", "0"),
            self._q1(req, "block", "0"))

    def _get_fragment_data(self, req):
        data = self.api.fragment_data(
            self._q1(req, "index"), self._q1(req, "field"),
            self._q1(req, "view", "standard"), self._q1(req, "shard", "0"))
        return RawResponse(data, "application/octet-stream")

    def _get_debug_oplog(self, req):
        """Durable-oplog summary: segments, checkpoint, replay lag."""
        oplog = self.api.oplog
        if oplog is None:
            return {"enabled": False,
                    "hint": "node started without a write-ahead oplog "
                            "(storage oplog=false or no data dir)"}
        out = oplog.summary()
        out["enabled"] = True
        return out

    def _get_faultpoints(self, req):
        """Armed fault points + hit counters (crash-test introspection)."""
        return faultpoints.snapshot()

    def _post_faultpoints(self, req):
        """Arm/disarm fault points on a live server. Body:
        ``{"arm": "<spec>" | ["<spec>", ...], "disarm": "<name>"|"all"}``
        (spec grammar in utils/faultpoints.py). Test-only surface — it
        mutates process behavior, so it is part of the debug namespace,
        not the public API."""
        body = json.loads(req.body.decode() or "{}")
        disarm = body.get("disarm")
        if disarm is not None:
            faultpoints.disarm(None if disarm == "all" else disarm)
        arm = body.get("arm")
        if arm is not None:
            specs = arm if isinstance(arm, list) else [arm]
            try:
                for spec in specs:
                    faultpoints.arm(spec)
            except ValueError as e:
                raise ApiError(str(e)) from e
        return faultpoints.snapshot()

    # -- observability -------------------------------------------------------

    def _get_metrics(self, req):
        return RawResponse(registry_of(self.stats).prometheus_text().encode(),
                           "text/plain; version=0.0.4")

    def _get_debug_vars(self, req):
        """expvar-style JSON metrics (reference: /debug/vars route
        http/handler.go:281), plus the stacked-evaluator cache counters
        and the worker pool."""
        out = json.loads(registry_of(self.stats).expvar_json())
        out["stacked"] = self.api.local_executor.stacked_stats()
        if self.api.spmd is not None:
            out["spmd"] = self.api.spmd.stats()
        out["workpool"] = workpool.get_pool().stats()
        return RawResponse(json.dumps(out).encode(), "application/json")

    def _get_debug_queries(self, req):
        """Recent query profiles, newest first (the bounded ring every
        profiled query — ?profile=true or long-query-time — lands in)."""
        return profile_mod.recent()

    def _get_debug_traces(self, req):
        """Dump of the retained span ring when an InMemoryTracer is
        installed (--tracing memory); tells you how to enable it when
        the zero-overhead nop default is active."""
        tracer = tracing.get_tracer()
        index_stats = tracing.trace_index().stats()
        if isinstance(tracer, tracing.InMemoryTracer):
            return {"enabled": True, "maxSpans": tracer.max_spans,
                    "traceIndex": index_stats,
                    "spans": tracer.to_dicts()}
        return {"enabled": False, "spans": [],
                "traceIndex": index_stats,
                "hint": "run the server with --tracing memory to retain "
                        "spans; profiled queries land in the trace index "
                        "either way (GET /debug/traces/{trace_id})"}

    def _get_debug_trace(self, req):
        """One assembled trace: this node's spans merged with every
        peer's (skew-corrected) unless ?local=true — the local form is
        what peers serve to the assembling coordinator, so assembly
        cannot recurse."""
        local_only = (self._q1(req, "local", "") or "").lower() \
            in ("1", "true", "yes")
        return self.api.debug_trace(req.params["trace_id"],
                                    local_only=local_only)

    def _get_flightrecorder(self, req):
        """The black-box event ring: the last N things this process did
        (dispatches, cache churn, stalls...). ?limit= bounds the tail."""
        limit = self._q1(req, "limit")
        return flightrec.snapshot(limit=int(limit) if limit else None)

    def _get_debug_dispatch(self, req):
        """Per-kernel dispatch-phase decomposition: where each family's
        launches and fetches go (lock_wait / dispatch_ack / sync)."""
        return self.api.local_executor.dispatch_phase_stats()

    def _get_debug_device(self, req):
        """Device-link health: the prober's state machine plus the full
        canary sample ring (?limit= bounds the ring; 0 = summary only)."""
        limit = self._q1(req, "limit")
        return devhealth.snapshot(
            limit=int(limit) if limit is not None else None)

    def _get_debug_hbm(self, req):
        """HBM ledger: resident stack-cache bytes per (index, field,
        pool), entries ranked by bytes + last-hit age, eviction causes,
        and the card's memory headroom."""
        return self.api.local_executor.hbm_stats(
            top=int(self._q1(req, "top", "50")))

    def _get_debug_kernels(self, req):
        """Per-kernel-family attribution + the declared cost of every
        launched kernel shape (?costs=false skips the costs)."""
        return self.api.local_executor.kernel_stats(
            include_costs=self._q1(req, "costs", "true") != "false")

    def _get_debug_plans(self, req):
        """Misestimated EXPLAIN ANALYZE plans, newest first (the ring
        exec/plan.py retains when actual cost deviates from the estimate
        past the configured factor), plus the cumulative flag counters.
        ?limit=0 returns counters only."""
        from ..exec import plan as plan_mod

        limit = self._q1(req, "limit")
        out = dict(plan_mod.stats())
        out["plans"] = plan_mod.recent(
            limit=int(limit) if limit is not None else None)
        return out

    def _get_debug_optimizer(self, req):
        """Adaptive execution engine state: mode, per-kernel-family
        calibration with sources (ewma|cost_analysis|default), strategy/
        tile/cache/admission decision counters, and the recent-decision
        ring (exec/adaptive.py)."""
        from ..exec import adaptive

        return adaptive.snapshot(stacked=self.api.local_executor._stacked)

    def _get_debug_fusion(self, req):
        """Whole-plan fusion state: mode + knobs, the bounded program
        ledger (per-entry compile ms / hits / age) and the
        fuse-vs-interpret decision counters (exec/fusion.py)."""
        from ..exec import fusion

        return fusion.snapshot()

    def _get_debug_admission(self, req):
        """Admission controller snapshot: ladder state + transitions,
        per-class token buckets and queues, calibration
        ({"enabled": false} when --admission off)."""
        return self.api.admission_stats()

    def _get_debug_ingest(self, req):
        """Streaming ingest engine: delta buffer depth, merge counters,
        deferred oplog watermarks ({"enabled": false} when off)."""
        return self.api.ingest_stats()

    def _get_debug_workload(self, req):
        """Query fingerprint table: top-K shapes by frequency, total
        wall, and misestimate rate (utils/workload.py). ?top=0 returns
        counters only."""
        return workload.table().snapshot(top=int(self._q1(req, "top", "20")))

    def _get_debug_heat(self, req):
        """Fragment heat cross-referenced against the HBM ledger:
        hot-but-not-resident (admission candidates) and
        resident-but-cold (eviction candidates)."""
        return workload.heat().report(
            self.api.local_executor.hbm_stats(top=0),
            top=int(self._q1(req, "top", "50")))

    def _get_debug_slo(self, req):
        """SLO objectives with fast/slow-window error-budget burn rates
        (empty objectives list when no --slo is configured)."""
        return workload.slo().snapshot()

    def _get_debug_incidents(self, req):
        """Postmortem bundle listing: trigger counters + every retained
        bundle's metadata ({"enabled": false} without --incident-dir)."""
        return incident.snapshot()

    def _get_debug_incident(self, req):
        """One postmortem bundle with its files inlined."""
        mgr = incident.get_manager()
        if mgr is None:
            raise NotFoundError(
                "incident bundles disabled (start with --incident-dir)")
        out = mgr.get(req.params["incident_id"])
        if out is None:
            raise NotFoundError("no such incident bundle")
        return out

    #: every debug endpoint the port serves, with a one-line description
    DEBUG_ENDPOINTS = {
        "/debug/vars": "expvar-style counters, gauges, and p50/p99 "
                       "timing summaries",
        "/debug/queries": "recent per-query profiles (span tree + "
                          "dispatch/lock/cache counters), newest first",
        "/debug/traces": "retained raw spans (needs --tracing memory) + "
                         "trace-index stats",
        "/debug/traces/{trace_id}": "ONE trace's spans and their tree",
        "/debug/dispatch": "dispatch-phase decomposition (lock_wait / "
                           "dispatch_ack / sync)",
        "/debug/hbm": "HBM ledger: resident stack-cache bytes per "
                      "(index, field, pool) + device headroom",
        "/debug/kernels": "per-kernel-family dispatch counts, wall, and "
                          "declared costs",
        "/debug/plans": "misestimated EXPLAIN ANALYZE plans, deduped "
                        "per query fingerprint, newest first",
        "/debug/optimizer": "adaptive execution engine: calibration "
                            "sources, decision counters, recent "
                            "decisions",
        "/debug/ingest": "streaming ingest engine: delta buffer depth, "
                         "merge counters, deferred oplog watermarks",
        "/debug/fusion": "whole-plan fusion: mode, program cache "
                         "(fingerprint / compile-ms / hits / last-hit "
                         "age), evictions, fuse-vs-interpret decision "
                         "counters",
        "/debug/spmd": "collective data plane: serve mode, step "
                       "lifecycle counters, stream + observatory state, "
                       "mesh-resident cache (POST switches serve mode)",
        "/debug/spmd/steps": "cross-node collective step timeline: "
                             "per-peer phase walls skew-corrected and "
                             "merged by seq with straggler attribution; "
                             "/debug/spmd/steps/{seq} for one step, "
                             "?local=true for this node's raw ring",
        "/debug/admission": "admission controller: degradation-ladder "
                            "state + transitions, per-class token "
                            "buckets, queue occupancy, rejections",
        "/debug/device": "device-link health: canary probe state "
                         "machine, RTT samples, transitions",
        "/debug/workload": "query fingerprint table: per-shape counts, "
                           "p50/p99, strategies, misestimates",
        "/debug/heat": "fragment heat vs HBM residency: admission and "
                       "eviction candidates",
        "/debug/slo": "SLO objectives and multi-window error-budget "
                      "burn rates",
        "/debug/incidents": "anomaly-triggered postmortem bundles "
                            "(flightrec + stacks + debug snapshots), "
                            "newest first; /debug/incidents/{id} inlines "
                            "one bundle",
        "/debug/batching": "query coalescer: queue depth, batch "
                           "occupancy histogram, rejects, batched-launch "
                           "counters",
        "/debug/oplog": "write-ahead oplog: LSNs, checkpoint, fsync "
                        "policy, segment state",
        "/debug/flightrecorder": "black-box event ring (dispatches, "
                                 "cache churn, stalls)",
        "/debug/faultpoints": "fault-injection points (GET state, POST "
                              "to arm)",
        "/debug/threads": "all-thread stack dump (text)",
        "/debug/pprof/goroutine": "all-thread stack dump",
        "/debug/pprof/profile/start": "POST: start a sampling profile of "
                                      "every thread",
        "/debug/pprof/profile/stop": "POST: stop it; frames, hottest "
                                     "first (text)",
    }

    def _get_debug_index(self, req):
        """GET /debug: enumerate every debug endpoint."""
        return {"endpoints": [
            {"path": path, "description": desc}
            for path, desc in sorted(self.DEBUG_ENDPOINTS.items())]}

    def _get_threads(self, req):
        """Stack dump of every live thread (the goroutine-dump analog)."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            out.append(f"thread {names.get(ident, '?')} ({ident}):")
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
            out.append("")
        return RawResponse("\n".join(out).encode(), "text/plain")

    _profiler_lock = threading.Lock()

    def _profile_start(self, req):
        """Begin a sampling CPU profile of ALL threads (cProfile is
        per-thread and would only see the handler thread that started it;
        a sampler over sys._current_frames covers the whole serving
        path)."""
        interval = float(self._q1(req, "interval", "0.01"))
        with self._profiler_lock:
            if self._profiler is not None:
                raise ApiError("profile already running")
            self._profiler = _SamplingProfiler(interval).start()
        return None

    def _profile_stop(self, req):
        """Stop profiling and return sampled frames, hottest first."""
        with self._profiler_lock:
            prof = self._profiler
            if prof is None:
                raise ApiError("no profile running")
            self._profiler = None
        return RawResponse(prof.stop().encode(), "text/plain")

    def _get_export(self, req):
        index = req.query.get("index", [None])[0]
        field = req.query.get("field", [None])[0]
        shard = req.query.get("shard", ["0"])[0]
        if not index or not field:
            raise ApiError("index and field query params required")
        csv_text = self.api.export_csv(index, field, int(shard))
        return RawResponse(csv_text.encode(), "text/csv")

    # -- transport -----------------------------------------------------------

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self):
                server.dispatch(self)

            do_GET = do_POST = do_DELETE = do_OPTIONS = _dispatch

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self._httpd = _Server((self.host, self.port), Handler)
        if self.tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.tls_cert, self.tls_key)
            self._tls_ctx = ctx
            self._stash_keypair()
            # Defer the handshake to the per-connection worker thread
            # (first read); a handshake in accept() would let one stalled
            # client block ALL new connections.
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pilosa-http", daemon=True)
        self._thread.start()
        return self

    def reload_tls(self):
        """Re-read the certificate/key files into the live TLS context:
        new handshakes serve the new keypair, existing connections are
        untouched (reference: keypairReloader server/tlsconfig.go:68-90,
        which reloads on SIGHUP; the CLI wires SIGHUP to this method).
        Raises on a bad keypair, keeping the old one serving.

        load_cert_chain mutates the context in stages (cert chain, then
        key, then pair check), so a half-bad rotation could strand the
        LIVE context with new-cert/old-key. So the files are validated in
        a scratch context first, and if the live load still fails (a
        file changed between the two loads), the stashed last-good PEMs
        go back into the live context."""
        if not self.tls_cert or self._tls_ctx is None:
            raise RuntimeError("TLS not enabled on this server")
        import ssl

        scratch = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        scratch.load_cert_chain(self.tls_cert, self.tls_key)
        try:
            self._tls_ctx.load_cert_chain(self.tls_cert, self.tls_key)
        except Exception:
            self._restore_last_good_keypair()
            raise
        self._stash_keypair()

    def _stash_keypair(self):
        with open(self.tls_cert, "rb") as f:
            cert_pem = f.read()
        with open(self.tls_key, "rb") as f:
            key_pem = f.read()
        self._tls_last_good = (cert_pem, key_pem)

    def _restore_last_good_keypair(self):
        import tempfile

        if not self._tls_last_good:
            return
        cert_pem, key_pem = self._tls_last_good
        with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                tempfile.NamedTemporaryFile(suffix=".key") as kf:
            cf.write(cert_pem)
            cf.flush()
            kf.write(key_pem)
            kf.flush()
            self._tls_ctx.load_cert_chain(cf.name, kf.name)

    def stop(self):
        with self._profiler_lock:
            prof, self._profiler = self._profiler, None
        if prof is not None:
            prof.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def uri(self):
        scheme = "https" if self.tls_cert else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def _cors_origin(self, handler):
        """The Access-Control-Allow-Origin value for this request, or None
        (reference: http/handler.go:83-91 OptHandlerAllowedOrigins wraps
        the router in gorilla handlers.CORS; absent the option, no CORS
        headers are emitted and browsers refuse cross-origin reads)."""
        if not self.allowed_origins:
            return None
        origin = handler.headers.get("Origin")
        if origin is None:
            return None
        if "*" in self.allowed_origins:
            return "*"
        return origin if origin in self.allowed_origins else None

    def dispatch(self, handler):
        parsed = urlparse(handler.path)
        path = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query)
        length = int(handler.headers.get("Content-Length", 0))
        body = handler.rfile.read(length) if length else b""
        cors = self._cors_origin(handler)
        if handler.command == "OPTIONS":
            # Preflight: answer with the allowed surface, no body.
            handler.send_response(200 if cors else 403)
            if self.allowed_origins:
                # response varies by Origin -> shared caches must key on it
                handler.send_header("Vary", "Origin")
            if cors:
                handler.send_header("Access-Control-Allow-Origin", cors)
                handler.send_header("Access-Control-Allow-Methods",
                                    "GET, POST, DELETE, OPTIONS")
                handler.send_header("Access-Control-Allow-Headers",
                                    "Content-Type")
            handler.send_header("Content-Length", "0")
            handler.end_headers()
            return
        t0 = time.perf_counter()
        status, payload = 404, {"error": "not found"}
        out_type = "application/json"
        extra_headers = None  # e.g. Retry-After on a 503
        matched = None  # Route whose pattern labels this request's metrics
        trace_id = None  # histogram-exemplar link; the span ends before
        # the timing below is recorded, so capture its id inside the with
        for route in self.routes:
            if route.method != handler.command:
                continue
            m = route.regex.match(path)
            if m is None:
                continue
            matched = route
            if route.args is not None:
                unknown = set(query) - route.args
                if unknown:
                    status, payload = 400, {
                        "error": "invalid query params: "
                                 + ", ".join(sorted(unknown))}
                    break
            req = Request(m.groupdict(), query, body,
                          handler.headers.get("Content-Type", ""),
                          headers=handler.headers)
            # continue a caller's trace from its headers (reference:
            # http/handler.go:321 extractTracing middleware)
            with tracing.span_from_headers(
                    f"http.{handler.command} {path}", handler.headers,
                    method=handler.command) as span:
                try:
                    result = route.fn(req)
                    if isinstance(result, RawResponse):
                        status, payload, out_type = (
                            200, result.body, result.content_type)
                    else:
                        status, payload = 200, result
                except ApiError as e:
                    status, payload = e.status, {"error": str(e)}
                    extra_headers = e.headers
                except Exception as e:  # internal error
                    status, payload = 500, {"error": str(e)}
                if span is not None:
                    span.set_tag("status", status)
                    trace_id = span.trace_id
            break
        data = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        # Per-route/per-status request metrics, tagged with the matched
        # route PATTERN (raw paths are unbounded label values). The
        # finally counts every response: 400s, 404s ("unmatched"), 500s,
        # even a write that died on a closed socket.
        try:
            handler.send_response(status)
            handler.send_header("Content-Type", out_type)
            handler.send_header("Content-Length", str(len(data)))
            for name, value in (extra_headers or {}).items():
                handler.send_header(name, value)
            if self.allowed_origins:
                handler.send_header("Vary", "Origin")
            if cors:
                handler.send_header("Access-Control-Allow-Origin", cors)
            handler.end_headers()
            handler.wfile.write(data)
        finally:
            tags = {"route": matched.pattern if matched else "unmatched",
                    "method": handler.command, "status": str(status)}
            self.stats.timing("http_request_seconds",
                              time.perf_counter() - t0, tags,
                              trace_id=trace_id)
            if status >= 400:
                self.stats.count("http_errors", 1, tags)
            if status >= 500:
                flightrec.record("http.5xx", route=tags["route"],
                                 method=handler.command, status=status)


class _SamplingProfiler:
    """Wall-clock stack sampler across every thread (py-spy style).
    `self` = samples where the frame is the leaf; `cum` = samples where it
    appears anywhere in a stack."""

    def __init__(self, interval=0.01):
        self.interval = max(interval, 0.001)
        self.self_counts = {}
        self.cum_counts = {}
        self.n_samples = 0
        self._stop_evt = threading.Event()
        self._thread = None

    def _sample(self):
        me = threading.get_ident()
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            self.n_samples += 1
            leaf = True
            seen = set()
            while frame is not None:
                code = frame.f_code
                key = f"{code.co_filename}:{frame.f_lineno} {code.co_name}"
                if leaf:
                    self.self_counts[key] = self.self_counts.get(key, 0) + 1
                    leaf = False
                if key not in seen:  # count recursion once per stack
                    seen.add(key)
                    self.cum_counts[key] = self.cum_counts.get(key, 0) + 1
                frame = frame.f_back

    def _run(self):
        while not self._stop_evt.wait(self.interval):
            self._sample()

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="pilosa-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        self._thread.join(timeout=5)
        lines = [f"samples: {self.n_samples} "
                 f"(interval {self.interval * 1000:.0f}ms)",
                 "", "self  cum   frame"]
        ranked = sorted(self.self_counts.items(),
                        key=lambda kv: -kv[1])[:50]
        for key, n in ranked:
            lines.append(f"{n:>5} {self.cum_counts.get(key, 0):>5} {key}")
        return "\n".join(lines) + "\n"
