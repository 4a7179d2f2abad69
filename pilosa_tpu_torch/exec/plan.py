"""PQL EXPLAIN/ANALYZE: cost-model-backed plan introspection.

The runtime observability stack (profiles, histograms, the flight
recorder, the HBM/kernel ledgers) answers "what happened"; this module
answers "what WILL happen and why" — which execution strategy the
executor will pick for each PQL call (stacked-kernel dispatch vs.
per-shard host fallback), the pairwise GroupBy tiling shape, how much of
the working set is already resident in HBM, and what each node should
cost. In the spirit of SQL `EXPLAIN ANALYZE`:

- `?explain=true|plan` builds the plan tree WITHOUT executing anything:
  the planner mirrors every strategy gate in exec/executor.py using only
  host-side work (signature walks, fragment metadata, cache-residency
  probes) — the acceptance contract is a stacked dispatch-counter delta
  of exactly zero.
- `?explain=analyze` executes the query and grafts actuals onto each
  top-level plan node: wall clock, kernel wall (from the per-family
  `_locked_dispatch` ledger), dispatch/pairwise counters, upload bytes,
  and the strategy the executor ACTUALLY took (recorded at each decision
  point). Nodes whose actual cost deviates from the estimate by more
  than `misestimate_factor()` (default 3x, either direction) are
  flagged, counted in `explain_misestimates_total{op}`, and the whole
  plan is retained in the `/debug/plans` ring alongside /debug/queries.

The cost model prices a dispatch of kernel family F from the best
available source, in order: the evaluator's own measured per-family
means (exec/stacked._kernels), the `kernel_seconds{kernel}` histograms
in the global stats registry (survive evaluator replacement), the
declared cost's `optimal_seconds` of a kernel shape the family has
launched (each wrapper's `*_cost` in ops/, cached by GET /debug/kernels;
the TPU package reads XLA's cost_analysis there and names the source
"xla", a name kept for the wire), and finally a fixed cold-process
default. Every estimate carries its source so a reader knows how much to
trust it.

This module is the TPU package's `exec/plan.py`, copied whole; it reads
host metadata only, so nothing in it changed but the Options wrapper's
option copy (the port's ExecOptions carries no shard list).
"""

import threading
from collections import OrderedDict

from ..shardwidth import WORDS_PER_ROW
from ..utils.stats import global_stats

#: retained (misestimated) plans, newest first on read
DEFAULT_PLAN_RING = 128
#: estimate-vs-actual deviation (either direction) that flags a node
DEFAULT_MISESTIMATE_FACTOR = 3.0
#: per-dispatch wall fallback for a cold process with no kernel history
#: and no cached cost_analysis — the order of magnitude of a small fused
#: popcount dispatch on the CPU backend; real measurements replace it
#: after the first queries.
DEFAULT_DISPATCH_SECONDS = 2e-3

#: comparison floors: below these, estimate-vs-actual ratios are noise
#: (timer jitter, a single warm-up dispatch) and must not flag
WALL_FLOOR_SECONDS = 2e-3
DISPATCH_FLOOR = 1.0
BYTES_FLOOR = 1 << 16

_lock = threading.Lock()
#: retained plans keyed by workload fingerprint (or a per-record
#: sequence number when none is known): one HOT mis-modeled shape keeps
#: ONE slot — latest plan + repeat count — instead of evicting every
#: other entry from the ring
_ring = OrderedDict()
_ring_max = DEFAULT_PLAN_RING
_anon_seq = 0
_local = threading.local()
_misestimate_factor = DEFAULT_MISESTIMATE_FACTOR
_misestimates_flagged = 0  # cumulative, for the observability roll-up
_repeats_collapsed = 0     # re-records absorbed by fingerprint dedupe
#: --coalesce-window (seconds); > 0 means serving folds concurrent
#: batchable queries into fused vmapped dispatches, and plans annotate
#: the batched strategy
_coalesce_window = 0.0


def configure(ring_size=None, misestimate_factor=None,
              coalesce_window=None):
    """Apply --plan-ring-size / --explain-misestimate-factor /
    --coalesce-window. Resizing keeps the newest entries (ring
    semantics). The coalesce window lets plans annotate the batched
    dispatch strategy (EXPLAIN shows what serving would do)."""
    global _ring_max, _misestimate_factor, _coalesce_window
    with _lock:
        if ring_size is not None:
            _ring_max = max(1, int(ring_size))
            while len(_ring) > _ring_max:
                _ring.popitem(last=False)
        if misestimate_factor is not None:
            _misestimate_factor = float(misestimate_factor)
        if coalesce_window is not None:
            _coalesce_window = float(coalesce_window)


def misestimate_factor():
    return _misestimate_factor


def coalesce_window():
    return _coalesce_window


def record(plan, fingerprint=None):
    """Retain one (misestimated) plan dict in the /debug/plans ring.
    With a fingerprint, a repeat replaces that shape's slot (latest plan
    wins, `repeat_count` accumulates); without one the entry is
    standalone."""
    global _anon_seq, _repeats_collapsed
    with _lock:
        if fingerprint is None:
            _anon_seq += 1
            key = f"#{_anon_seq}"
        else:
            key = fingerprint
        old = _ring.pop(key, None)
        entry = dict(plan)
        entry["repeat_count"] = 1 if old is None \
            else old.get("repeat_count", 1) + 1
        if old is not None:
            _repeats_collapsed += 1
        if fingerprint is not None:
            entry["fingerprint"] = fingerprint
        _ring[key] = entry
        while len(_ring) > _ring_max:
            _ring.popitem(last=False)


def recent(limit=None):
    """Retained plans, newest first (GET /debug/plans)."""
    with _lock:
        out = list(_ring.values())
    out.reverse()
    if limit is not None:
        out = out[: max(0, int(limit))]
    return out


def clear_recent():
    global _misestimates_flagged, _repeats_collapsed
    with _lock:
        _ring.clear()
        _misestimates_flagged = 0
        _repeats_collapsed = 0


def stats():
    """Roll-up summary for /status observability."""
    with _lock:
        return {"retained": len(_ring), "ring_size": _ring_max,
                "misestimates_flagged": _misestimates_flagged,
                "repeats_collapsed": _repeats_collapsed,
                "misestimate_factor": _misestimate_factor}


def _count_misestimate(op):
    global _misestimates_flagged
    from ..utils import workload

    global_stats.count("explain_misestimates", 1, {"op": op})
    workload.note_misestimate()  # attribute to the in-flight fingerprint
    with _lock:
        _misestimates_flagged += 1


def stash(plan):
    """Thread-local handoff executor -> HTTP layer (same pattern as
    utils/profile.take_last: the layers share a request thread)."""
    _local.last = plan


def take_last():
    plan = getattr(_local, "last", None)
    _local.last = None
    return plan


# ---------------------------------------------------------------- plan tree


class PlanNode:
    """One node per PQL call. `annotations` hold strategy inputs (shards,
    tile shape, views, cache residency); `estimate` the cost-model
    prediction; `actual` (analyze only) the measured counters; and
    `misestimates` the >factor deviations between the two."""

    __slots__ = ("op", "pql", "strategy", "reason", "fields", "annotations",
                 "estimate", "actual", "misestimates", "children")

    def __init__(self, op, pql="", strategy="", reason="", fields=()):
        self.op = op
        self.pql = pql
        self.strategy = strategy
        self.reason = reason
        self.fields = list(fields)
        self.annotations = {}
        self.estimate = {}
        self.actual = None
        self.misestimates = []
        self.children = []

    def walk(self):
        yield self
        for child in self.children:
            if isinstance(child, PlanNode):
                yield from child.walk()

    def to_dict(self):
        out = {"op": self.op, "strategy": self.strategy}
        if self.pql:
            out["pql"] = self.pql
        if self.reason:
            out["reason"] = self.reason
        if self.fields:
            out["fields"] = list(self.fields)
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        if self.estimate:
            out["estimate"] = dict(self.estimate)
        if self.actual is not None:
            out["actual"] = dict(self.actual)
        if self.misestimates:
            out["misestimates"] = list(self.misestimates)
        # cluster sub-plans arrive as already-serialized dicts
        out["children"] = [c.to_dict() if isinstance(c, PlanNode) else c
                           for c in self.children]
        return out


def envelope(index_name, mode, nodes, shards=None, trace_id=None):
    """The wire shape of a whole plan: one entry per top-level call."""
    out = {"index": index_name, "mode": mode,
           "calls": [n.to_dict() if isinstance(n, PlanNode) else n
                     for n in nodes]}
    if shards is not None:
        out["shards"] = shards
    if trace_id is not None:
        out["traceID"] = trace_id
    mis = sum(len(n.misestimates) for n in nodes
              if isinstance(n, PlanNode))
    if mode == "analyze":
        out["misestimates"] = mis
    return out


def summary(nodes):
    """One-line `op=strategy` summary for SLOW QUERY log lines; `!` marks
    a misestimated node. Accepts PlanNodes or serialized dicts."""
    parts = []
    for n in nodes:
        if isinstance(n, PlanNode):
            op, strat, mis = n.op, n.strategy, bool(n.misestimates)
        else:
            op, strat = n.get("op", "?"), n.get("strategy", "?")
            mis = bool(n.get("misestimates"))
        parts.append(f"{op}={strat}" + ("!" if mis else ""))
    return ",".join(parts)


# ---------------------------------------------------------------- cost model


class CostModel:
    """Per-dispatch wall pricing, best source first:

    1. "measured"  — the evaluator's own per-family means
       (stacked._kernels, updated by every _locked_dispatch)
    2. "histogram" — `kernel_seconds{kernel}` means from the global
       stats registry (survive an evaluator swap / invalidate)
    3. "xla"       — the declared `optimal_seconds` of a kernel shape
       the family launched, ALREADY cached by GET /debug/kernels (none
       on a CPU evaluator). The explain=plan path does zero device
       work.
    4. "default"   — DEFAULT_DISPATCH_SECONDS (cold process)
    """

    def __init__(self, stacked):
        self._stacked = stacked
        self._measured = {}
        if stacked is not None:
            try:
                self._measured = stacked.kernel_profile()
            except Exception:  # pragma: no cover - observability only
                self._measured = {}
        self._hist = self._histogram_means()
        self._xla = self._cached_xla_seconds(stacked)

    @staticmethod
    def _histogram_means():
        out = {}
        for (name, tags), (count, total) in \
                global_stats.timing_summary("kernel_seconds").items():
            family = dict(tags).get("kernel")
            if family and count:
                out[family] = total / count
        return out

    @staticmethod
    def _cached_xla_seconds(stacked):
        """{family: optimal_seconds} from costs ALREADY computed by a
        prior /debug/kernels request — reading must not compile."""
        if stacked is None:
            return {}
        out = {}
        try:
            with stacked._lock:
                costs = dict(stacked._kernel_costs)
        except Exception:  # pragma: no cover
            return {}
        for key, cost in costs.items():
            secs = (cost or {}).get("optimal_seconds")
            if isinstance(secs, (int, float)) and secs > 0:
                family = str(key[0])
                out[family] = max(out.get(family, 0.0), float(secs))
        return out

    def dispatch_seconds(self, family):
        """(seconds, source) for one dispatch of `family`."""
        m = self._measured.get(family)
        if m and m.get("count"):
            return m["seconds"] / m["count"], "measured"
        h = self._hist.get(family)
        if h:
            return h, "histogram"
        x = self._xla.get(family)
        if x:
            return x, "xla"
        return DEFAULT_DISPATCH_SECONDS, "default"

    def price(self, node, kernels):
        """Fill node.estimate's wall from a {family: n_dispatches} map.
        The estimate's source is the WEAKEST source used — one "default"
        family taints the whole number, and the reader should know."""
        rank = {"measured": 0, "histogram": 1, "xla": 2, "default": 3}
        wall = 0.0
        worst = "measured"
        for family, n in kernels.items():
            secs, src = self.dispatch_seconds(family)
            wall += secs * n
            if rank[src] > rank[worst]:
                worst = src
        node.estimate["kernels"] = dict(kernels)
        node.estimate["kernel_wall_seconds"] = round(wall, 6)
        node.estimate["cost_source"] = worst


# ----------------------------------------------------------------- planner


class Planner:
    """Builds the plan tree by mirroring each _exec_* strategy gate in
    exec/executor.py with HOST-ONLY work: signature walks, fragment
    metadata (row_ids / TopN caches), and lock-guarded cache-residency
    probes. It must never call filter_stack/_gather/try_* — those
    materialize device stacks. Keeping the gates in sync with the
    executor is the module's maintenance contract; tests/test_explain.py
    pins plan-vs-actual strategy agreement per op family."""

    def __init__(self, executor):
        self.ex = executor
        self.stacked = executor._stacked
        self.cost = CostModel(executor._stacked)

    # -- entry ---------------------------------------------------------------

    def plan_query(self, idx, calls, shards, opt):
        nodes = [self.plan_call(idx, call, shards, opt) for call in calls]
        self._annotate_fusion(idx, calls, nodes)
        return nodes

    def _annotate_fusion(self, idx, calls, nodes):
        """Whole-plan fusion annotation (host metadata only — the plan
        path's zero-dispatch contract holds): when fusion is enabled
        and every top-level call is a stacked-covered Count, serving
        would run the whole query as ONE fused dispatch (exec/fusion.py),
        so each node gains `fused: true` plus the program-cache key
        status for the query's workload fingerprint (cached = a program
        table is live; uncompiled = the first admitted execution would
        build and upload it)."""
        from ..pql.ast import Query
        from ..utils import workload
        from . import fusion

        if not fusion.enabled() or not calls:
            return
        if any(c.name != "Count" or len(c.children) != 1
               for c in calls):
            return
        if any(n.strategy != "stacked" for n in nodes):
            return
        fp, _ = workload.fingerprint(idx.name, Query(list(calls)))
        status = fusion.cache_status(fp)
        for n in nodes:
            n.annotations["fused"] = True
            n.annotations["fusion_fingerprint"] = fp
            n.annotations["fusion_program"] = status

    def plan_call(self, idx, call, shards, opt):
        handler = {
            "Count": self._plan_count,
            "Sum": self._plan_sum,
            "Min": self._plan_min,
            "Max": self._plan_max,
            "MinRow": self._plan_minmax_row,
            "MaxRow": self._plan_minmax_row,
            "TopN": self._plan_topn,
            "Rows": self._plan_rows,
            "GroupBy": self._plan_group_by,
            "Options": self._plan_options,
        }.get(call.name)
        if handler is not None:
            return handler(idx, call, shards, opt)
        if call.writes():
            return self._plan_write(idx, call, shards, opt)
        return self._plan_bitmap(idx, call, shards, opt)

    # -- shared helpers ------------------------------------------------------

    def _shards(self, idx, shards):
        return list(self.ex._call_shards(idx, shards))

    def _min_shards(self):
        from .stacked import MIN_SHARDS

        return MIN_SHARDS

    def _batch_buckets(self):
        from .stacked import BATCH_BUCKETS

        return BATCH_BUCKETS

    def _plane_bytes(self, shard_tuple):
        return self.stacked._padded_len(shard_tuple) * WORDS_PER_ROW * 4

    def _node(self, call, strategy="", reason=""):
        from ..pql import call_to_pql

        try:
            pql = call_to_pql(call)
        except Exception:
            pql = call.name
        return PlanNode(call.name, pql=pql, strategy=strategy, reason=reason)

    def _coverage(self, idx, call, shard_tuple):
        """Host-only stack-coverage + HBM residency of a bitmap tree."""
        return self.stacked.residency_probe(idx, call, shard_tuple)

    def _tree_size(self, call):
        return 1 + sum(self._tree_size(c) for c in call.children)

    def _adaptive_choice(self, node, op, kernels, shard_list,
                         fallback_strategy):
        """Price the stacked-vs-fallback decision the executor will make
        with the SAME inputs (kernel map + bytes_materialized) and
        annotate it: `chosen_by` + both priced alternatives. With the
        engine acting, a fallback-priced node mirrors the executor —
        strategy flips to the per-shard variant — so plan-vs-actual
        strategy agreement holds under --adaptive on. No-op when the
        engine is off (legacy plans are byte-identical)."""
        from . import adaptive

        if not adaptive.enabled():
            return None
        dec = adaptive.decide_strategy(
            op, kernels, len(shard_list),
            node.estimate.get("bytes_materialized", 0),
            stacked=self.stacked)
        node.annotations["chosen_by"] = dec.chosen_by
        node.annotations["alternatives"] = {
            "stacked_ms": round(dec.est_stacked * 1000, 3),
            "fallback_ms": round(dec.est_fallback * 1000, 3),
            "cost_source": dec.source,
        }
        if dec.act and dec.strategy == "fallback":
            node.strategy = fallback_strategy
            node.reason = "cost-model: fallback priced cheaper"
        return dec

    def _stacked_gate(self, node, idx, filter_call, shard_list):
        """The shared MIN_SHARDS + filter-coverage gate. Returns
        (eligible, probe) and records the blocking reason on the node."""
        if len(shard_list) < self._min_shards():
            node.reason = (f"{len(shard_list)} shard(s) < MIN_SHARDS="
                           f"{self._min_shards()}")
            return False, None
        probe = self._coverage(idx, filter_call, tuple(shard_list)) \
            if filter_call is not None else None
        if probe is not None and not probe["covered"]:
            node.reason = "filter tree is not stack-coverable"
            return False, probe
        return True, probe

    @staticmethod
    def _merge_extras(kernels, probe):
        """Fold the gather-side dispatches (bsi_condition, time_union)
        into a {family: n} kernel map; returns how many were added."""
        extra = 0
        for family, n in (probe or {}).get("extra_kernels", {}).items():
            kernels[family] = kernels.get(family, 0) + n
            extra += n
        return extra

    @staticmethod
    def _cache_state(probe):
        if probe is None or probe["leaves"] == 0:
            return "n/a"
        if probe["resident"] == probe["leaves"]:
            return "warm"
        if probe["resident"] == 0:
            return "cold"
        return "partial"

    def _annotate_probe(self, node, probe):
        if probe is None:
            return
        node.annotations["cache"] = self._cache_state(probe)
        node.annotations["leaves"] = probe["leaves"]
        node.annotations["resident_leaves"] = probe["resident"]
        # per-leaf container representation ("repr: dense|sparse|rle"
        # with leaf counts) + the compressed-bytes estimate the chooser
        # committed to — resident containers report exact bytes, cold
        # leaves fall back to the fragment ledger's last build
        rc = probe.get("repr_counts")
        if rc:
            node.annotations["repr"] = dict(rc)
        node.estimate["bytes_materialized"] = \
            node.estimate.get("bytes_materialized", 0) \
            + probe["missing_bytes"]

    # -- bitmap call trees ---------------------------------------------------

    def _plan_bitmap(self, idx, call, shards, opt, validate=True):
        """Bitmap calls always run per-shard plane chains (one device
        chain per shard, merged on host) — there is no stacked strategy
        to choose, but the node still reports shard/view touch counts and
        whether the tree WOULD be stack-coverable (a Count/filter wrapped
        around it could then go stacked)."""
        if validate:
            self.ex.validate_bitmap_call(idx, call)
        shard_list = self._shards(idx, shards)
        node = self._node(call, strategy="per-shard-planes")
        probe = self._coverage(idx, call, tuple(shard_list))
        node.annotations["shards"] = len(shard_list)
        node.annotations["stack_coverable"] = probe["covered"]
        if probe["covered"]:
            self._annotate_probe(node, probe)
            if coalesce_window() > 0:
                node.annotations["batched"] = True
                node.annotations["batch_buckets"] = \
                    list(self._batch_buckets())
            # residency bytes only matter if a stacked consumer builds
            # the stacks; the per-shard chain itself uploads nothing
            node.estimate.pop("bytes_materialized", None)
        ops = self._tree_size(call)
        node.estimate["dispatches"] = 0
        node.estimate["device_ops"] = ops * len(shard_list)
        node.estimate["bytes_touched"] = (
            probe["leaves"] * len(shard_list) * WORDS_PER_ROW * 4
            if probe["covered"] else ops * len(shard_list)
            * WORDS_PER_ROW * 4)
        node.estimate["kernel_wall_seconds"] = 0.0
        node.estimate["cost_source"] = "structural"
        for child in call.children:
            node.children.append(
                self._plan_bitmap(idx, child, shards, opt, validate=False))
        return node

    # -- aggregates ----------------------------------------------------------

    def _plan_count(self, idx, call, shards, opt):
        from .executor import ExecError

        if len(call.children) != 1:
            raise ExecError("Count() takes exactly one row query")
        self.ex.validate_bitmap_call(idx, call.children[0])
        shard_list = self._shards(idx, shards)
        node = self._node(call)
        node.annotations["shards"] = len(shard_list)
        child = self._plan_bitmap(idx, call.children[0], shards, opt,
                                  validate=False)
        node.children.append(child)

        probe = self._coverage(idx, call.children[0], tuple(shard_list))
        if len(shard_list) >= self._min_shards() and probe["covered"]:
            node.strategy = "stacked"
            self._annotate_probe(node, probe)
            if coalesce_window() > 0:
                # serving would fold this query into a fused vmapped
                # dispatch with concurrent same-shape arrivals
                node.annotations["batched"] = True
                node.annotations["batch_buckets"] = \
                    list(self._batch_buckets())
            kernels = {"count": 1}
            node.estimate["dispatches"] = \
                1 + self._merge_extras(kernels, probe)
            # bytes_touched prices what the count kernel actually reads
            # (compressed container bytes); dense_bytes_touched is the
            # plane-scan baseline the chooser competed against — analyze
            # compares the two to catch repr-misestimates
            dense_bytes = \
                probe["leaves"] * self._plane_bytes(tuple(shard_list))
            node.estimate["bytes_touched"] = \
                probe.get("compressed_bytes", dense_bytes)
            node.estimate["dense_bytes_touched"] = dense_bytes
            self.cost.price(node, kernels)
            self._adaptive_choice(node, "Count", kernels, shard_list,
                                  "per-shard")
        else:
            node.strategy = "per-shard"
            if not probe["covered"]:
                node.reason = "tree is not stack-coverable"
            else:
                node.reason = (f"{len(shard_list)} shard(s) < MIN_SHARDS="
                               f"{self._min_shards()}")
            node.estimate["dispatches"] = 0
            node.estimate["device_ops"] = \
                (self._tree_size(call.children[0]) + 1) * len(shard_list)
            node.estimate["kernel_wall_seconds"] = 0.0
            node.estimate["cost_source"] = "structural"
        return node

    def _plan_sum(self, idx, call, shards, opt):
        return self._plan_bsi_agg(idx, call, shards, opt, family="sum",
                                  strategy="stacked-sum")

    def _plan_min(self, idx, call, shards, opt):
        return self._plan_bsi_agg(idx, call, shards, opt, family="minmax",
                                  strategy="stacked-minmax")

    def _plan_max(self, idx, call, shards, opt):
        return self._plan_bsi_agg(idx, call, shards, opt, family="minmax",
                                  strategy="stacked-minmax")

    def _plan_bsi_agg(self, idx, call, shards, opt, family, strategy):
        """Sum/Min/Max share one gate chain: MIN_SHARDS -> filter
        coverage -> BSI view present (try_sum/try_minmax in stacked.py)."""
        field = self.ex._agg_field(idx, call)
        filter_call = self.ex._agg_filter_call(idx, call)
        shard_list = self._shards(idx, shards)
        node = self._node(call)
        node.fields = [field.name]
        node.annotations["shards"] = len(shard_list)
        if filter_call is not None:
            node.children.append(self._plan_bitmap(
                idx, filter_call, shards, opt, validate=False))

        eligible, probe = self._stacked_gate(node, idx, filter_call,
                                             shard_list)
        bsi_view = field.view(field.bsi_view_name())
        if eligible and bsi_view is None:
            eligible = False
            node.reason = "BSI view not present locally"
        if eligible:
            node.strategy = strategy
            depth = field.options.bit_depth
            st = tuple(shard_list)
            node.annotations["bit_depth"] = depth
            self._annotate_probe(node, probe)
            kernels = {family: 1}
            dispatches = 1
            if filter_call is not None:
                kernels["filter"] = 1
                dispatches += 1 + self._merge_extras(kernels, probe)
            if not self.stacked.bsi_stack_resident(idx, field.name, st):
                node.estimate["bytes_materialized"] = \
                    node.estimate.get("bytes_materialized", 0) \
                    + (depth + 2) * self._plane_bytes(st)
                node.annotations["bsi_cache"] = "cold"
            else:
                node.annotations["bsi_cache"] = "warm"
            node.estimate["dispatches"] = dispatches
            node.estimate["bytes_touched"] = \
                (depth + 2) * self._plane_bytes(st)
            self.cost.price(node, kernels)
            self._adaptive_choice(node, node.op, kernels, shard_list,
                                  "per-shard")
        else:
            node.strategy = "per-shard"
            node.estimate["dispatches"] = 0
            node.estimate["device_ops"] = len(shard_list)
            node.estimate["kernel_wall_seconds"] = 0.0
            node.estimate["cost_source"] = "structural"
        return node

    def _plan_minmax_row(self, idx, call, shards, opt):
        """MinRow/MaxRow only have the per-shard first-qualifying-row
        scan — annotate the scan breadth instead of a strategy choice."""
        field = self.ex._set_field(idx, call)
        shard_list = self._shards(idx, shards)
        node = self._node(call, strategy="per-shard-scan")
        node.fields = [field.name]
        node.annotations["shards"] = len(shard_list)
        if call.children:
            self.ex.validate_bitmap_call(idx, call.children[0])
            node.children.append(self._plan_bitmap(
                idx, call.children[0], shards, opt, validate=False))
        node.estimate["dispatches"] = 0
        node.estimate["device_ops"] = len(shard_list)
        node.estimate["kernel_wall_seconds"] = 0.0
        node.estimate["cost_source"] = "structural"
        return node

    # -- TopN ----------------------------------------------------------------

    def _plan_topn(self, idx, call, shards, opt):
        field = self.ex._set_field(idx, call)
        if call.children:
            self.ex.validate_bitmap_call(idx, call.children[0])
        shard_list = self._shards(idx, shards)
        ids = call.args.get("ids")
        filter_call = call.children[0] if call.children else None
        node = self._node(call)
        node.fields = [field.name]
        node.annotations["shards"] = len(shard_list)
        if filter_call is not None:
            node.children.append(self._plan_bitmap(
                idx, filter_call, shards, opt, validate=False))

        # the SAME candidate policy as _row_counts: fragment TopN caches
        # when populated, else all present rows (host containers only)
        from ..core.view import VIEW_STANDARD

        candidates = self.ex._candidate_rows(
            field, shard_list, ids, ids is None, VIEW_STANDARD)
        node.annotations["candidate_rows"] = len(candidates)

        eligible, probe = self._stacked_gate(node, idx, filter_call,
                                             shard_list)
        if eligible:
            node.strategy = "stacked-row-counts"
            st = tuple(shard_list)
            chunk = self.stacked.row_chunk_size(st)
            n_chunks = -(-len(candidates) // chunk) if candidates else 0
            node.annotations["row_chunk_size"] = chunk
            self._annotate_probe(node, probe)
            kernels = {}
            dispatches = n_chunks
            if n_chunks:
                kernels["row_counts"] = n_chunks
            if filter_call is not None:
                kernels["filter"] = 1
                dispatches += 1 + self._merge_extras(kernels, probe)
            missing_rows = self._missing_row_chunks(
                idx, field.name, candidates, chunk, st)
            node.estimate["bytes_materialized"] = \
                node.estimate.get("bytes_materialized", 0) \
                + missing_rows * self._plane_bytes(st)
            node.estimate["dispatches"] = dispatches
            node.estimate["bytes_touched"] = \
                len(candidates) * self._plane_bytes(st)
            self.cost.price(node, kernels)
            self._adaptive_choice(node, node.op, kernels, shard_list,
                                  "per-shard-chunked")
        else:
            from .executor import _TOPN_STACK_CHUNK

            node.strategy = "per-shard-chunked"
            per_shard_chunks = -(-len(candidates) // _TOPN_STACK_CHUNK) \
                if candidates else 0
            node.estimate["dispatches"] = 0
            node.estimate["device_ops"] = per_shard_chunks * len(shard_list)
            node.estimate["kernel_wall_seconds"] = 0.0
            node.estimate["cost_source"] = "structural"
        return node

    def _missing_row_chunks(self, idx, field_name, rows, chunk, shard_tuple,
                            view_name=None):
        """How many [chunk, S, W] row stacks the stacked path would have
        to build (vs. serve from the rows pool)."""
        from ..core.view import VIEW_STANDARD

        view_name = view_name or VIEW_STANDARD
        missing = 0
        for i in range(0, len(rows), chunk):
            part = tuple(rows[i:i + chunk])
            if not self.stacked.rows_chunk_resident(
                    idx, field_name, part, shard_tuple, view_name):
                missing += len(part)
        return missing

    # -- Rows ----------------------------------------------------------------

    def _plan_rows(self, idx, call, shards, opt):
        """Rows() is pure host metadata (fragment row_ids / contains) —
        no device work on any path."""
        field = self.ex._set_field(idx, call)
        shard_list = self._shards(idx, shards)
        node = self._node(call, strategy="host-metadata")
        node.fields = [field.name]
        views = self.ex._rows_views(field, call)
        node.annotations["shards"] = len(shard_list)
        node.annotations["views"] = list(views)
        node.estimate["dispatches"] = 0
        node.estimate["device_ops"] = 0
        node.estimate["kernel_wall_seconds"] = 0.0
        node.estimate["cost_source"] = "structural"
        return node

    # -- GroupBy -------------------------------------------------------------

    def _plan_group_by(self, idx, call, shards, opt):
        from ..pql import Call
        from .executor import ExecError, groupby_previous

        if not call.children:
            raise ExecError("GroupBy requires at least one Rows() child")
        for child in call.children:
            if child.name != "Rows":
                raise ExecError("GroupBy children must be Rows() calls")
        previous = groupby_previous(call, len(call.children))
        filter_call = call.args.get("filter")
        if filter_call is not None:
            if not isinstance(filter_call, Call):
                raise ExecError("GroupBy filter must be a row query")
            self.ex.validate_bitmap_call(idx, filter_call)

        fields = [self.ex._set_field(idx, child) for child in call.children]
        shard_list = self._shards(idx, shards)
        node = self._node(call)
        node.fields = [f.name for f in fields]
        node.annotations["shards"] = len(shard_list)
        for child in call.children:
            node.children.append(self._plan_rows(idx, child, shards, opt))
        if filter_call is not None:
            node.children.append(self._plan_bitmap(
                idx, filter_call, shards, opt, validate=False))

        # the executor's own (host-only) child row resolution, including
        # the cursor's outer-row pruning — the estimates below are exact
        # row counts, not guesses
        child_rows = [self.ex._exec_rows(idx, child, shards, opt).rows
                      for child in call.children]
        if previous is not None:
            lo = previous[0] + (1 if len(child_rows) == 1 else 0)
            child_rows[0] = [r for r in child_rows[0] if r >= lo]
        node.annotations["rows_per_field"] = [len(r) for r in child_rows]

        eligible, probe = self._stacked_gate(node, idx, filter_call,
                                             shard_list)
        if not eligible:
            node.strategy = "per-shard"
            combos = 1
            for rows in child_rows:
                combos *= len(rows)
            node.estimate["dispatches"] = 0
            node.estimate["device_ops"] = combos * len(shard_list)
            node.estimate["kernel_wall_seconds"] = 0.0
            node.estimate["cost_source"] = "structural"
            return node

        st = tuple(shard_list)
        self._annotate_probe(node, probe)
        kernels = {}
        dispatches = 0
        upload_bytes = node.estimate.get("bytes_materialized", 0)
        if filter_call is not None:
            kernels["filter"] = 1
            dispatches += 1 + self._merge_extras(kernels, probe)
        chunk = self.stacked.row_chunk_size(st)

        if len(fields) == 1:
            node.strategy = "stacked-row-counts"
            rows = child_rows[0]
            n_chunks = -(-len(rows) // chunk) if rows else 0
            node.annotations["row_chunk_size"] = chunk
            if n_chunks:
                kernels["row_counts"] = n_chunks
            dispatches += n_chunks
            upload_bytes += self._missing_row_chunks(
                idx, fields[0].name, rows, chunk, st) \
                * self._plane_bytes(st)
        else:
            node.strategy = "stacked-pairwise"
            a_rows, b_rows = child_rows[-2], child_rows[-1]
            outer = 1
            for rows in child_rows[:-2]:
                outer *= len(rows)
            # mirror the executor's adaptive tile so the plan's shape
            # and dispatch count match what execution will actually run
            from . import adaptive

            tile_dec = adaptive.decide_tile(
                chunk, len(a_rows), len(b_rows), outer=outer) \
                if (adaptive.enabled() and a_rows and b_rows) else None
            t = tile_dec.tile if (tile_dec is not None
                                  and tile_dec.act) else chunk
            a_tiles = -(-len(a_rows) // t) if a_rows else 0
            b_tiles = -(-len(b_rows) // t) if b_rows else 0
            pairwise = outer * a_tiles * b_tiles
            node.annotations["tile"] = [min(len(a_rows), t),
                                        min(len(b_rows), t)]
            if tile_dec is not None:
                node.annotations["tile_chosen_by"] = tile_dec.chosen_by
            node.annotations["pairwise_tiles"] = [a_tiles, b_tiles]
            node.annotations["outer_combinations"] = outer
            if pairwise:
                kernels["pairwise"] = pairwise
            dispatches += pairwise
            node.estimate["pairwise_dispatches"] = pairwise
            for field, rows in zip(fields[-2:], (a_rows, b_rows)):
                upload_bytes += self._missing_row_chunks(
                    idx, field.name, rows, chunk, st) \
                    * self._plane_bytes(st)
            for field, rows in zip(fields[:-2], child_rows[:-2]):
                upload_bytes += self._missing_row_chunks(
                    idx, field.name, rows, chunk, st) \
                    * self._plane_bytes(st)
        total_rows = sum(len(r) for r in child_rows)
        node.estimate["dispatches"] = dispatches
        node.estimate["bytes_materialized"] = upload_bytes
        node.estimate["bytes_touched"] = \
            total_rows * self._plane_bytes(st)
        self.cost.price(node, kernels)
        self._adaptive_choice(node, "GroupBy", kernels, shard_list,
                              "per-shard")
        return node

    # -- Options / writes ----------------------------------------------------

    def _plan_options(self, idx, call, shards, opt):
        # one Options() layer, exactly as _exec_options peels it (nested
        # wrappers recurse through plan_call on the child)
        from .executor import ExecError, ExecOptions

        if len(call.children) != 1:
            raise ExecError("Options() takes exactly one query")
        merged = ExecOptions(
            exclude_columns=opt.exclude_columns,
            column_attrs=opt.column_attrs,
            exclude_row_attrs=opt.exclude_row_attrs,
            remote=opt.remote, profile=opt.profile)
        merged.explain = getattr(opt, "explain", None)
        for key, value in call.args.items():
            if key == "shards":
                if not isinstance(value, list):
                    raise ExecError("Options(): shards must be a list")
                shards = [int(s) for s in value]
            elif key == "excludeColumns":
                merged.exclude_columns = bool(value)
            elif key == "columnAttrs":
                merged.column_attrs = bool(value)
            elif key == "excludeRowAttrs":
                merged.exclude_row_attrs = bool(value)
            else:
                raise ExecError(f"Options(): unknown arg {key!r}")
        node = self._node(call, strategy="option-wrapper")
        node.annotations["overrides"] = sorted(call.args)
        node.children.append(
            self.plan_call(idx, call.children[0], shards, merged))
        node.estimate["dispatches"] = \
            node.children[0].estimate.get("dispatches", 0)
        node.estimate["kernel_wall_seconds"] = \
            node.children[0].estimate.get("kernel_wall_seconds", 0.0)
        node.estimate["cost_source"] = \
            node.children[0].estimate.get("cost_source", "structural")
        return node

    def _plan_write(self, idx, call, shards, opt):
        node = self._node(call, strategy="write")
        node.annotations["mutates"] = True
        node.estimate["dispatches"] = 0
        node.estimate["device_ops"] = 0
        node.estimate["kernel_wall_seconds"] = 0.0
        node.estimate["cost_source"] = "structural"
        return node


# ------------------------------------------------------- analyze grafting


def graft_actual(node, wall_seconds, before, after, kernel_before,
                 kernel_after, strategies=None, phases_before=None,
                 phases_after=None):
    """Attach measured actuals (stacked cache_stats + per-family kernel
    seconds deltas) onto one TOP-LEVEL plan node, then compare against
    the estimate. Deltas are exact when queries are serialized (the
    acceptance path) and order-of-magnitude under concurrency — same
    caveat as the QueryProfile counter deltas. phases_before/after are
    StackedEvaluator.dispatch_phases() snapshots; when given, the actual
    gains a per-phase RTT decomposition (`phase_seconds`) so the cost
    model can price lock wait / compile / dispatch ack / device sync
    separately from kernel wall."""
    actual = {
        "wall_seconds": round(wall_seconds, 6),
        "dispatches": after["dispatches"] - before["dispatches"],
        "pairwise_dispatches": (after["pairwise_dispatches"]
                                - before["pairwise_dispatches"]),
        "cache_hits": after["hits"] - before["hits"],
        "cache_misses": after["misses"] - before["misses"],
        "bytes_materialized": (after["planes_uploaded"]
                               - before["planes_uploaded"])
        * WORDS_PER_ROW * 4,
    }
    k_wall = 0.0
    k_bytes = 0
    k_by_family = {}
    for family, k in kernel_after.items():
        prev = kernel_before.get(family, {"count": 0, "seconds": 0.0})
        dn = k["count"] - prev["count"]
        ds = k["seconds"] - prev["seconds"]
        db = k.get("bytes_in", 0) - prev.get("bytes_in", 0)
        if dn > 0:
            k_by_family[family] = dn
            k_wall += ds
            if db > 0:
                k_bytes += db
    actual["kernel_wall_seconds"] = round(k_wall, 6)
    # bytes the dispatched kernels actually read (compressed container
    # bytes under --container-repr auto, dense plane bytes otherwise) —
    # the analyze-side ground truth for the repr-misestimate check
    actual["bytes_touched"] = k_bytes
    if k_by_family:
        actual["kernels"] = k_by_family
    if phases_before is not None and phases_after is not None:
        phase_seconds = {}
        for family, fam in phases_after.items():
            prev_fam = phases_before.get(family, {})
            for phase, p in fam.items():
                prev = prev_fam.get(phase, {"count": 0, "seconds": 0.0})
                ds = p["seconds"] - prev["seconds"]
                if p["count"] - prev["count"] > 0:
                    phase_seconds[phase] = round(
                        phase_seconds.get(phase, 0.0) + ds, 6)
        if phase_seconds:
            actual["phase_seconds"] = phase_seconds
    if strategies:
        mine = [s for s in strategies if s.get("op") == node.op]
        if mine:
            actual["strategy"] = mine[0]["strategy"]
            # fused-dispatch occupancy this execution rode (the count
            # group-commit or the coalescer), so analyze distinguishes
            # a query slowed by batching from one slowed by the kernel
            if "batch" in mine[0]:
                actual["batch"] = mine[0]["batch"]
    node.actual = actual
    flag_misestimates(node)
    return node


def _deviation(estimated, actual, floor):
    est = max(float(estimated), floor)
    act = max(float(actual), floor)
    return act / est if act >= est else est / act


def flag_misestimates(node, factor=None):
    """Compare estimate vs. actual on the three costed metrics; flag a
    node when any deviates by more than the configured factor in EITHER
    direction (a 10x overestimate hides capacity exactly like a 10x
    underestimate hides a regression). One `explain_misestimates_total
    {op}` tick per flagged node, not per metric."""
    if node.actual is None or not node.estimate:
        return node
    if node.annotations.get("fused"):
        # the estimate priced the interpreted per-call path, but the
        # node executed inside ONE fused program — any deviation is the
        # strategy change itself, not cost-model drift, and flagging it
        # would spam the triage ring on every fused analyze
        node.misestimates = []
        return node
    factor = _misestimate_factor if factor is None else factor
    checks = (
        ("kernel_wall_seconds", WALL_FLOOR_SECONDS),
        ("dispatches", DISPATCH_FLOOR),
        ("bytes_materialized", BYTES_FLOOR),
    )
    flags = []
    for metric, floor in checks:
        if metric not in node.estimate or metric not in node.actual:
            continue
        est, act = node.estimate[metric], node.actual[metric]
        if max(float(est), float(act)) < floor:
            continue  # both below the noise floor
        dev = _deviation(est, act, floor)
        if dev > factor:
            flags.append({"metric": metric, "estimated": est,
                          "actual": act, "deviation": round(dev, 2)})
    # repr-misestimate: the chooser committed to a compressed
    # representation, but the kernels read MORE bytes than the dense
    # plane scan would have — the choice made the query worse. Rides
    # the same ring/counter as the cost misestimates.
    dense_est = node.estimate.get("dense_bytes_touched")
    act_bytes = node.actual.get("bytes_touched", 0)
    reprs = node.annotations.get("repr") or {}
    if (dense_est and act_bytes > dense_est
            and any(k != "dense" for k in reprs)):
        flags.append({"metric": "container_repr",
                      "estimated": dense_est, "actual": act_bytes,
                      "deviation": round(act_bytes / dense_est, 2)})
    node.misestimates = flags
    if flags:
        _count_misestimate(node.op)
        _adaptive_feedback(node, flags)
    return node


def _adaptive_feedback(node, flags):
    """Misestimates are the adaptive engine's correction signal: a
    kernel-wall deviation re-seeds the involved families'
    EWMA calibration from the OBSERVED wall; a container_repr
    misestimate strikes the node's fragments toward a forced-dense
    rebuild. No-op when the engine is off."""
    from . import adaptive

    if not adaptive.enabled():
        return
    for f in flags:
        if f["metric"] == "kernel_wall_seconds":
            kernels = (node.actual or {}).get("kernels") \
                or node.estimate.get("kernels") or {}
            adaptive.note_wall_misestimate(
                kernels, (node.actual or {}).get(
                    "kernel_wall_seconds", 0.0))
        elif f["metric"] == "container_repr":
            from ..utils import workload

            adaptive.note_repr_misestimate(
                workload.current_index(), node.fields)
