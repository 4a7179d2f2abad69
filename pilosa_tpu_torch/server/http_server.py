"""HTTP transport (reference: http/handler.go).

Stdlib ThreadingHTTPServer + a regex router over the reference's public
single-node REST surface, with the TPU package's JSON wire shapes. The
protobuf wire is not served: a body sent as application/x-protobuf gets
415.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..core import timeq
from ..core.index import IndexOptions
from ..exec import ExecOptions
from .api import ApiError, NotFoundError, field_options_from_json, \
    result_to_json


class Route:
    def __init__(self, method, pattern, fn, args=None):
        self.method = method
        self.pattern = pattern
        self.regex = re.compile("^" + pattern + "$")
        self.fn = fn
        # allowed query-string arg names; None = no validation
        self.args = frozenset(args) if args is not None else None


class Request:
    __slots__ = ("params", "query", "body")

    def __init__(self, params, query, body):
        self.params = params
        self.query = query
        self.body = body

    def json(self):
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))


class RawResponse:
    """A non-JSON response body (CSV export)."""
    __slots__ = ("body", "content_type")

    def __init__(self, body, content_type):
        self.body = body
        self.content_type = content_type


class PilosaHTTPServer:
    """Owns the listening socket and the route table. `port=0` binds an
    ephemeral port; `self.port` holds the bound one after start()."""

    def __init__(self, api, host="127.0.0.1", port=10101):
        self.api = api
        self.host = host
        self.port = port
        self.routes = [
            Route("GET", r"/", self._home),
            Route("GET", r"/index", self._get_schema),
            Route("POST", r"/index/(?P<index>[^/]+)", self._post_index),
            Route("GET", r"/index/(?P<index>[^/]+)", self._get_index),
            Route("DELETE", r"/index/(?P<index>[^/]+)", self._delete_index),
            Route("POST", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                  self._post_field),
            Route("DELETE", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                  self._delete_field),
            Route("POST", r"/index/(?P<index>[^/]+)/query",
                  self._post_query,
                  args=("shards", "columnAttrs", "excludeRowAttrs",
                        "excludeColumns")),
            Route("POST", r"/index/(?P<index>[^/]+)/query-batch",
                  self._post_query_batch, args=("shards",)),
            Route("POST",
                  r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import",
                  self._post_import, args=("clear",)),
            Route("POST",
                  r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)"
                  r"/import-roaring/(?P<shard>[0-9]+)",
                  self._post_import_roaring, args=("view", "clear")),
            Route("GET", r"/export", self._get_export,
                  args=("index", "field", "shard")),
            Route("GET", r"/schema", self._get_schema),
            Route("POST", r"/schema", self._post_schema),
            Route("GET", r"/status", self._get_status),
            Route("GET", r"/healthz", self._get_healthz),
            Route("GET", r"/info", self._get_info),
            Route("GET", r"/version", self._get_version),
            Route("POST", r"/recalculate-caches", self._recalculate_caches),
            Route("GET", r"/debug/batching", self._get_debug_batching),
        ]
        self._httpd = None
        self._thread = None

    # -- handlers ------------------------------------------------------------

    def _home(self, req):
        return {"pilosa_tpu_torch": "the bitmap index on PyTorch and CUDA",
                "version": self.api.info()["version"],
                "device": str(self.api.device)}

    def _get_schema(self, req):
        return self.api.schema()

    def _post_schema(self, req):
        self.api.apply_schema(req.json())
        return None

    def _get_status(self, req):
        return self.api.status()

    def _get_healthz(self, req):
        """Liveness: the process is up and serving HTTP."""
        return {"status": "ok"}

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

    def _post_query(self, req):
        pql = req.body.decode("utf-8")
        shards = None
        if "shards" in req.query:
            shards = [int(s) for s in req.query["shards"][0].split(",") if s]

        def flag(name):
            return req.query.get(name, ["false"])[0] == "true"

        column_attrs = flag("columnAttrs")
        options = ExecOptions(
            exclude_columns=flag("excludeColumns"),
            column_attrs=column_attrs,
            exclude_row_attrs=flag("excludeRowAttrs"))
        results = self.api.query(req.params["index"], pql, shards=shards,
                                 options=options)
        out = {"results": [result_to_json(r) for r in results]}
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

    def _post_import(self, req):
        clear = req.query.get("clear", ["false"])[0] == "true"
        body = req.json()
        if body is None:
            raise ApiError("import requires a JSON body")
        index, field = req.params["index"], req.params["field"]
        if "values" in body:
            changed = self.api.import_values(
                index, field, body.get("columnIDs", []), body["values"],
                clear=clear, column_keys=body.get("columnKeys"))
        else:
            timestamps = body.get("timestamps")
            if timestamps is not None:
                timestamps = [timeq.parse_time(t) if t else None
                              for t in timestamps]
            changed = self.api.import_bits(
                index, field, body.get("rowIDs", []),
                body.get("columnIDs", []), timestamps=timestamps,
                clear=clear, row_keys=body.get("rowKeys"),
                column_keys=body.get("columnKeys"))
        return {"changed": changed}

    def _post_import_roaring(self, req):
        """The body is one serialized roaring bitmap of row * SHARD_WIDTH
        + offset positions for shard {shard} of `view`."""
        changed = self.api.import_roaring(
            req.params["index"], req.params["field"],
            int(req.params["shard"]), req.body,
            clear=req.query.get("clear", ["false"])[0] == "true",
            view=req.query.get("view", ["standard"])[0])
        return {"changed": changed}

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

            do_GET = do_POST = do_DELETE = _dispatch

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pilosa-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def uri(self):
        return f"http://{self.host}:{self.port}"

    def dispatch(self, handler):
        parsed = urlparse(handler.path)
        path = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query)
        length = int(handler.headers.get("Content-Length", 0))
        body = handler.rfile.read(length) if length else b""
        protobuf = handler.headers.get("Content-Type", "").startswith(
            "application/x-protobuf")
        status, payload = 404, {"error": "not found"}
        out_type = "application/json"
        extra_headers = None  # e.g. Retry-After on a 503
        for route in self.routes:
            if route.method != handler.command:
                continue
            m = route.regex.match(path)
            if m is None:
                continue
            if route.args is not None:
                unknown = set(query) - route.args
                if unknown:
                    status, payload = 400, {
                        "error": "invalid query params: "
                                 + ", ".join(sorted(unknown))}
                    break
            if protobuf:
                status, payload = 415, {
                    "error": "application/x-protobuf bodies are not "
                             "served; send JSON (or PQL text to a query "
                             "route)"}
                break
            try:
                result = route.fn(Request(m.groupdict(), query, body))
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
            break
        data = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", out_type)
        handler.send_header("Content-Length", str(len(data)))
        for name, value in (extra_headers or {}).items():
            handler.send_header(name, value)
        handler.end_headers()
        handler.wfile.write(data)
