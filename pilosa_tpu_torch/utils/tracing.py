"""Tracing: global-tracer indirection with nop default.

Reference: tracing/tracing.go:27-75 (GlobalTracer var + StartSpanFromContext)
and the opentracing adapter wired by cmd/server.go:78-93. Here the same
shape: a process-global `Tracer` defaulting to nop, spans started on every
executor/API hot path, and trace context propagated across nodes via HTTP
headers (reference: http/handler.go extractTracing / http/client.go inject).

Backends: `NopTracer` (default, zero overhead), `InMemoryTracer` (tests +
/debug inspection), and — when opentelemetry happens to be importable —
`OTelTracer` adapting to an OTel tracer. No hard OTel dependency.
"""

import contextlib
import random
import threading
import time
from collections import OrderedDict

TRACE_HEADER = "X-Pilosa-Trace-Id"
PARENT_HEADER = "X-Pilosa-Span-Id"

_local = threading.local()


class Span:
    """One timed operation. Finished spans carry duration + tags.

    `start` is wall-clock (for display and cross-node alignment);
    `duration` is measured on the monotonic clock so NTP steps and
    operator clock changes cannot corrupt it — durations feed both the
    profile tree and the skew estimator, which assumes they are real
    elapsed time."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "tags",
                 "start", "duration", "_t0")

    def __init__(self, name, trace_id, span_id, parent_id, tags):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tags = dict(tags)
        self.start = time.time()
        self.duration = None
        self._t0 = time.perf_counter()

    @classmethod
    def from_dict(cls, d):
        """Rebuild a (finished) span from its to_dict shape — used when the
        coordinator merges spans fetched from remote nodes."""
        span = cls(d.get("name", ""), d.get("traceID"), d.get("spanID"),
                   d.get("parentID"), d.get("tags") or {})
        span.start = d.get("start")
        span.duration = d.get("duration")
        return span

    def set_tag(self, key, value):
        self.tags[key] = value

    def finish(self):
        if self.duration is None:
            self.duration = time.perf_counter() - self._t0

    def to_dict(self):
        """JSON shape for /debug/traces and query profiles."""
        return {"name": self.name, "traceID": self.trace_id,
                "spanID": self.span_id, "parentID": self.parent_id,
                "tags": dict(self.tags), "start": self.start,
                "duration": self.duration}


class NopTracer:
    """Default tracer: allocates nothing, records nothing."""

    def on_finish(self, span):
        pass


class InMemoryTracer:
    """Collects finished spans in a bounded ring — the OLDEST spans are
    evicted past max_spans, so /debug/traces always shows recent activity
    on a long-lived server (trace retention); for tests and debugging."""

    def __init__(self, max_spans=10000):
        self.max_spans = max_spans
        self.spans = []
        self._lock = threading.Lock()

    def on_finish(self, span):
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.max_spans:
                del self.spans[:len(self.spans) - self.max_spans]

    def find(self, name):
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def to_dicts(self):
        """JSON dump for GET /debug/traces, oldest first."""
        with self._lock:
            return [s.to_dict() for s in self.spans]

    def clear(self):
        with self._lock:
            self.spans.clear()


class TraceIndex:
    """Finished spans indexed by trace id in a bounded two-level ring:
    at most `max_traces` trace ids retained (oldest-touched evicted), at
    most `max_spans_per_trace` spans per trace (later spans dropped and
    counted). This is the per-node half of cross-node trace assembly —
    the coordinator pulls a remote node's slice of a trace via
    GET /debug/traces/{trace_id}?local=true and merges it into one tree.

    Always on, but free on the default path: under the NopTracer with no
    incoming trace context no Span objects exist to index (see
    start_span's nop-fast path), so the index only ever sees spans from
    profiled / explicitly traced queries."""

    def __init__(self, max_traces=256, max_spans_per_trace=256):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._traces = OrderedDict()  # trace_id -> [Span, ...]
        self._lock = threading.Lock()
        self.dropped_spans = 0
        self.evicted_traces = 0

    def add(self, span):
        if span.trace_id is None:
            return
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = self._traces[span.trace_id] = []
            else:
                self._traces.move_to_end(span.trace_id)
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)
            else:
                self.dropped_spans += 1
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
                self.evicted_traces += 1

    def get(self, trace_id):
        """Finished spans of one trace as dicts (oldest-started first),
        or [] when unknown/evicted."""
        with self._lock:
            spans = list(self._traces.get(trace_id, ()))
        return [s.to_dict() for s in spans]

    def stats(self):
        with self._lock:
            return {"traces": len(self._traces),
                    "maxTraces": self.max_traces,
                    "maxSpansPerTrace": self.max_spans_per_trace,
                    "droppedSpans": self.dropped_spans,
                    "evictedTraces": self.evicted_traces}

    def clear(self):
        with self._lock:
            self._traces.clear()
            self.dropped_spans = 0
            self.evicted_traces = 0


_global_tracer = NopTracer()

# Secondary finished-span consumer (utils/profile.py registers its
# per-query router here). Separate from the tracer so query profiling
# works with the nop tracer still installed.
_span_sink = None

# Per-node finished-span index for cross-node assembly. Module-level and
# always present (zero-cost when no spans are created — see class doc).
_trace_index = TraceIndex()


def set_tracer(tracer):
    """Install the process-global tracer (reference: tracing.go SetGlobal)."""
    global _global_tracer
    _global_tracer = tracer if tracer is not None else NopTracer()


def get_tracer():
    return _global_tracer


def set_span_sink(sink):
    global _span_sink
    _span_sink = sink


def trace_index():
    return _trace_index


def configure_trace_index(max_traces=256, max_spans_per_trace=256):
    """Resize (and reset) the per-node trace index; max_traces=0 disables
    retention entirely (spans still flow to the tracer/sink)."""
    global _trace_index
    _trace_index = TraceIndex(max_traces=max_traces,
                              max_spans_per_trace=max_spans_per_trace)
    return _trace_index


def index_span(span):
    """Feed one finished span into the trace index (also called by
    profile.finish for the query root span, which bypasses start_span)."""
    if _trace_index.max_traces > 0:
        _trace_index.add(span)


def get_trace(trace_id):
    """This node's finished spans for one trace id, as dicts."""
    return _trace_index.get(trace_id)


def _new_id():
    return "%016x" % random.getrandbits(64)


def new_trace_id():
    return _new_id()


def current_span():
    return getattr(_local, "span", None)


@contextlib.contextmanager
def with_span(span):
    """Adopt `span` as the active context on THIS thread (for worker
    threads continuing a request's trace; does not finish the span)."""
    prev = current_span()
    _local.span = span
    try:
        yield span
    finally:
        _local.span = prev


class _NopSpanContext:
    """What start_span returns on its nop-fast path: enters as None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOP_SPAN = _NopSpanContext()


def start_span(name, **tags):
    """Start a child of the current thread's active span (or a new trace).

    Nop-fast: when the global tracer is the NopTracer and there is no
    incoming context, this allocates no Span at all (and no generator:
    the shared `_NOP_SPAN` context enters as None).
    """
    if isinstance(_global_tracer, NopTracer) and current_span() is None:
        return _NOP_SPAN
    return _span(name, tags)


@contextlib.contextmanager
def _span(name, tags):
    tracer = _global_tracer
    parent = current_span()
    trace_id = parent.trace_id if parent else _new_id()
    span = Span(name, trace_id, _new_id(),
                parent.span_id if parent else None, tags)
    prev = parent
    _local.span = span
    try:
        yield span
    finally:
        _local.span = prev
        span.finish()
        tracer.on_finish(span)
        if _span_sink is not None:
            _span_sink(span)
        index_span(span)


# -- cross-node propagation (reference: handler extractTracing / client
#    inject) ---------------------------------------------------------------

def inject_headers(headers=None):
    """Add trace context headers for an outgoing internal request."""
    headers = dict(headers or {})
    span = current_span()
    if span is not None:
        headers[TRACE_HEADER] = span.trace_id
        headers[PARENT_HEADER] = span.span_id
    return headers


def _header_get(headers, name):
    """Case-insensitive header lookup. http.server's Message headers are
    already case-insensitive, but plain dicts (tests, proxies that
    lowercase header names per HTTP/2) are not — fall back to a scan."""
    value = headers.get(name)
    if value is not None or hasattr(headers, "get_all"):
        return value  # a Message's get() already ignored the case
    want = name.lower()
    for k in headers:
        if isinstance(k, str) and k.lower() == want:
            return headers[k]
    return None


def span_from_headers(name, headers, **tags):
    """Continue a remote trace from incoming HTTP headers (case-insensitive
    lookup — see _header_get); without them, start_span."""
    trace_id = _header_get(headers, TRACE_HEADER)
    if trace_id is None:
        return start_span(name, **tags)
    return _remote_span(name, trace_id, _header_get(headers, PARENT_HEADER),
                        tags)


@contextlib.contextmanager
def _remote_span(name, trace_id, parent_id, tags):
    tracer = _global_tracer
    span = Span(name, trace_id, _new_id(), parent_id, tags)
    prev = current_span()
    _local.span = span
    try:
        yield span
    finally:
        _local.span = prev
        span.finish()
        tracer.on_finish(span)
        if _span_sink is not None:
            _span_sink(span)
        index_span(span)


# -- cross-node assembly (Dapper, Sigelman et al. 2010 §5) ------------------
#
# Remote nodes timestamp spans with THEIR wall clock. The coordinator
# estimates each node's clock offset from the fan-out request it sent:
# for a request dispatched at local wall time t_send that returned at
# t_recv, the remote handler span covering it ran [r_start, r_end] in
# remote wall time. Assuming symmetric network delay (NTP's assumption):
#
#     theta = ((r_start - t_send) + (r_end - t_recv)) / 2
#
# is the remote clock minus the local clock; subtracting theta from
# every remote span start places it on the coordinator's timeline. When
# several request/response pairs exist for one node, the pair with the
# smallest round-trip envelope (t_recv - t_send) bounds theta tightest
# and wins. Durations are never adjusted — they are monotonic-clock
# measurements and already comparable across nodes.

def estimate_skew(local_spans, remote_spans):
    """Estimate one remote node's clock offset (remote - local, seconds).

    `local_spans`: span dicts recorded on this node (the fan-out client
    spans among them). `remote_spans`: span dicts fetched from the
    remote node. A pairing is any remote span whose parentID is a local
    span's spanID — i.e. the remote server span directly under our
    client span. Returns 0.0 when no pairing exists (spans merge
    uncorrected rather than not at all)."""
    by_id = {s["spanID"]: s for s in local_spans
             if s.get("spanID") and s.get("duration") is not None}
    best = None  # (rtt, theta)
    for r in remote_spans:
        local = by_id.get(r.get("parentID"))
        if local is None or r.get("duration") is None:
            continue
        t_send, t_recv = local["start"], local["start"] + local["duration"]
        r_start, r_end = r["start"], r["start"] + r["duration"]
        theta = ((r_start - t_send) + (r_end - t_recv)) / 2.0
        rtt = local["duration"]
        if best is None or rtt < best[0]:
            best = (rtt, theta)
    return best[1] if best else 0.0


def merge_remote_spans(local_spans, remote_by_node):
    """Merge per-node remote span dicts into the local timeline.

    Returns (all_spans, skew_by_node): remote starts are shifted by each
    node's estimated offset, every remote span is tagged with its node
    id, and duplicates (same spanID) are dropped. `remote_by_node` maps
    node id -> list of span dicts as returned by get_trace()."""
    seen = {s["spanID"] for s in local_spans if s.get("spanID")}
    merged = list(local_spans)
    skew_by_node = {}
    for node_id, spans in remote_by_node.items():
        theta = estimate_skew(local_spans, spans)
        skew_by_node[node_id] = theta
        for s in spans:
            if s.get("spanID") in seen:
                continue
            seen.add(s.get("spanID"))
            s = dict(s)
            if s.get("start") is not None:
                s["start"] = s["start"] - theta
            tags = dict(s.get("tags") or {})
            tags.setdefault("node", node_id)
            s["tags"] = tags
            merged.append(s)
    return merged, skew_by_node


def assemble_tree(spans):
    """Build the span forest from flat span dicts: children nested under
    their parentID when present, orphans become roots. Children sort by
    corrected start time. Returns the list of root nodes."""
    nodes = {}
    for s in spans:
        n = dict(s)
        n["children"] = []
        nodes[s["spanID"]] = n
    roots = []
    for s in spans:
        n = nodes[s["spanID"]]
        parent = nodes.get(s.get("parentID"))
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)

    def _sort(children):
        children.sort(key=lambda c: (c.get("start") or 0.0))
        for c in children:
            _sort(c["children"])
    _sort(roots)
    return roots
