"""Per-query profiles: the span tree + counters that explain ONE query.

The stats registry (utils/stats.py) answers "how is the server doing";
the tracer (utils/tracing.py) answers "what happened, globally". Neither
answers the production question "why was THIS query slow" — on this
architecture that means: how many pairwise dispatches, how long the
process-wide dispatch lock was contended, kernel wall time, stacked-cache
hits/misses, bytes materialized to device, and per-node fan-out timings
(Dapper, Sigelman et al. 2010, is the shape; the reference's
long-query-time log is the trigger).

A `QueryProfile` is begun by `api.Query` when the request asked for it
(`?profile=true`) or when the server has a slow-query threshold
configured. While active it is registered by trace id, so finished spans
from ANY thread of the query — executor spans, stacked kernel spans,
cluster fan-out spans (which share the trace id via
`tracing.with_span` / the X-Pilosa-Trace-Id headers) — are captured into
the profile by the tracing span-sink without the tracer needing to be
non-nop. With no profile active and the nop tracer installed, no span
objects are ever allocated: the default hot path is unchanged.

Finished profiles land in a bounded ring (`recent()`, served at
GET /debug/queries) and are stashed per-thread for the HTTP handler to
attach to the response (`take_last()`).
"""

import threading
import time
from collections import deque

from . import tracing

#: spans retained per profile; past this the tree truncates (counted in
#: the `spans_dropped` tag) rather than growing without bound
MAX_PROFILE_SPANS = 512

#: finished profiles retained for GET /debug/queries
MAX_RECENT = 128

_active = {}  # trace_id -> QueryProfile (only while the query runs)
_recent = deque(maxlen=MAX_RECENT)
_recent_lock = threading.Lock()
_local = threading.local()


class QueryProfile:
    """Span tree + counter accumulator for one query."""

    def __init__(self, index, query, slow_threshold=None):
        self.index = index
        self.query = query
        self.slow_threshold = slow_threshold
        self.start = time.time()
        self.duration = None
        self.slow = False
        self._lock = threading.Lock()
        self._spans = []
        self._dropped = 0
        self._tags = {}
        # the query's root span: created unconditionally (even under the
        # nop tracer) so every start_span below it allocates a real child
        self.root = tracing.Span(
            "query", tracing.new_trace_id(), tracing.new_trace_id(),
            None, {"index": index})

    # -- collection (called from arbitrary query threads) --------------------

    def record(self, span):
        with self._lock:
            if len(self._spans) < MAX_PROFILE_SPANS:
                self._spans.append(span)
            else:
                self._dropped += 1

    def add(self, key, value):
        """Accumulate a numeric profile tag (lock waits, dispatch counts,
        byte totals...)."""
        with self._lock:
            self._tags[key] = self._tags.get(key, 0) + value

    def set_tag(self, key, value):
        with self._lock:
            self._tags[key] = value

    def note(self, key, value):
        """Append to a LIST-valued profile tag (e.g. the per-op strategy
        records the executor's decision points emit) — `add` sums and
        `set_tag` overwrites; ordered events need neither."""
        with self._lock:
            self._tags.setdefault(key, []).append(value)

    def tag(self, key, default=None):
        with self._lock:
            return self._tags.get(key, default)

    def spans_snapshot(self):
        """Finished spans recorded so far (cross-node assembly reads the
        local fan-out spans from here to estimate per-node clock skew)."""
        with self._lock:
            return list(self._spans)

    # -- lifecycle -----------------------------------------------------------

    def begin(self):
        """Register so span finishes (any thread) feed this profile."""
        _active[self.root.trace_id] = self
        return self

    def finish(self):
        """Close the root span, unregister, and publish: into the recent
        ring always, and to this thread's `take_last` stash."""
        self.root.finish()
        self.duration = self.root.duration
        _active.pop(self.root.trace_id, None)
        # the root span bypasses start_span, so index it here — this is
        # what lets GET /debug/traces/{trace_id} resolve a profiled query
        # (e.g. from a metrics exemplar) after it finished
        tracing.index_span(self.root)
        if self.slow_threshold is not None \
                and self.duration > self.slow_threshold:
            self.slow = True
        snapshot = self.to_dict()
        with _recent_lock:
            _recent.append(snapshot)
        _local.last = snapshot
        return snapshot

    # -- output --------------------------------------------------------------

    def to_dict(self):
        """JSON shape: flat tags + the span TREE rooted at the query span.
        Spans whose parent was dropped (or finished after the root) attach
        to the root so nothing silently disappears."""
        with self._lock:
            spans = list(self._spans)
            tags = dict(self._tags)
            dropped = self._dropped
        nodes = {}
        for s in spans:
            nodes[s.span_id] = dict(
                name=s.name, start=s.start, duration=s.duration,
                tags=dict(s.tags), children=[])
        root = dict(name=self.root.name, start=self.root.start,
                    duration=self.root.duration, tags=dict(self.root.tags),
                    children=[])
        for s in spans:
            parent = nodes.get(s.parent_id)
            (parent["children"] if parent is not None
             else root["children"]).append(nodes[s.span_id])
        out = {
            "index": self.index,
            "query": self.query[:500],
            "traceID": self.root.trace_id,
            "start": self.start,
            "duration": self.duration,
            "slow": self.slow,
            "tags": tags,
            "spans": root,
        }
        if dropped:
            out["spansDropped"] = dropped
        return out


def begin(index, query, slow_threshold=None):
    return QueryProfile(index, query,
                        slow_threshold=slow_threshold).begin()


def current():
    """The active profile owning this thread's span context, or None.
    Dispatch hot paths call this per device launch; with no profile
    active anywhere it is one empty-dict check."""
    if not _active:
        return None
    span = tracing.current_span()
    if span is None:
        return None
    return _active.get(span.trace_id)


def _deliver(span):
    """tracing span-sink: route a finished span to its query's profile."""
    if not _active:
        return
    prof = _active.get(span.trace_id)
    if prof is not None:
        prof.record(span)


tracing.set_span_sink(_deliver)


def take_last():
    """Pop the profile dict the current thread's last profiled query
    produced (the HTTP handler attaches it to the response)."""
    last = getattr(_local, "last", None)
    _local.last = None
    return last


def recent():
    """Newest-first finished profiles (GET /debug/queries)."""
    with _recent_lock:
        return list(reversed(_recent))


def clear_recent():
    with _recent_lock:
        _recent.clear()
