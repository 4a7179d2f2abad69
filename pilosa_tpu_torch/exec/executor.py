"""PQL executor: stacked Count/TopN/GroupBy/Sum/Min/Max/MinRow/MaxRow,
Rows, bitmap calls, Options, writes.

Reference: executor.go (Execute :113, executeCall :274, executeCount
:1790, executeTopN :930, executeRows :1280, executeGroupBy :1098,
executeSum :331, executeBitmapCallShard :651). The port's slice:

- Count over two or more shards of a stack-coverable tree (Row, BSI
  condition Row, time-range Row / Intersect / Union / Difference / Xor /
  Not) runs as ONE launch of K1 over cached [S, W] device stacks
  (exec/stacked.py), after one K5 launch per condition leaf; anything
  else counts shard by shard with the PyTorch plane ops
  (ops/bitplane.py), summed exactly.
- Sum, Min and Max over two or more shards walk the field's cached
  [D+2, S, W] bit-plane stack once (Sum: three K3 launches); fewer
  shards, or a filter the stacked path cannot express, run the same ops
  shard by shard.
- TopN and single-field GroupBy count candidate rows in [R, S, W] chunks
  with K3 (one launch per chunk); GroupBy over two or more fields counts
  its innermost two fields' cross product with K4 (one launch per tile
  pair). Fewer than two shards, or a filter the stacked path cannot
  express, count shard by shard instead — on the device all the same.
- Rows lists row ids from the host fragments.
- Bitmap calls evaluate shard by shard on the device and return a Row;
  a condition Row is one K5 launch per shard. Inside a Count or a filter
  over two or more shards, Shift is a leaf of the stacked tree: its
  child evaluated over every shard, shifted within each shard.
- MinRow and MaxRow walk the field's rows in direction order, one K3
  chunk at a time, and stop at the first chunk with a non-zero count.
- Options narrows the shard list and sets result options for its child.
- Set, Clear, ClearRow, Store, SetRowAttrs and SetColumnAttrs write
  through the host fragments and attribute stores; the next query
  patches the cached stacks in place. Store evaluates its child over
  every shard at once and fetches the [S, W] result in one copy.
- `execute_batch` (the query-batch route) and `launch_batch` /
  `resolve_batch` (the query coalescer) run lists of single-call reads:
  batchable Counts and bitmap trees as batched launches grouped by
  signature, with one fetch for the whole batch; every other member
  takes the per-query path.

Per-shard work fans over the shared worker pool and reduces IN SHARD
ORDER, so every worker count gives identical results.

`?explain=true` (ExecOptions.explain "plan") builds the plan tree of
exec/plan.py from host metadata and runs nothing; "analyze" runs each
call and grafts its measured counters onto its plan node. With the
adaptive engine on (exec/adaptive.py) each stacked decision point prices
the stacked path against the per-shard one, GroupBy prices its K4 tile,
and `maybe_proactive_admit` builds hot fragments' stacks in idle windows.
With whole-plan fusion on (exec/fusion.py) a query whose every top-level
call is a Count runs as ONE fused dispatch (`fusion.maybe_execute`,
before the per-call loop); `?explain=analyze` grafts that dispatch onto
the first plan node (`_fused_analyze`).

Every query runs under an `executor.Execute` span with one
`executor.execute{Call}` span per call, times each call into
`query_op_seconds{op}`, and with a query profile active adds its
stacked-counter deltas to the profile (the TPU package's names). Every
non-remote query is fingerprinted into the workload table with its
counter deltas and the strategies its decision points took
(utils/workload.py), and Row leaves evaluated shard by shard bump the
fragment heat ledger as cache probes do. A request deadline
(`ExecOptions.deadline`) is checked between calls and before every
launch.
"""

import math
import threading
import time

import numpy as np
import torch

from ..core.field import FIELD_TYPE_INT, FIELD_TYPE_TIME, FieldOptions
from ..core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from ..core.row import Row
from ..core import timeq
from ..core.view import VIEW_STANDARD
from ..device import resolve_devices
from ..ops import bitplane
from ..ops import bsi as bsi_ops
from ..ops.row_counts import row_counts as _row_counts_kernel
from ..pql import Call, Condition, parse
from ..shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from ..utils import profile as profile_mod
from ..utils import tracing
from ..utils import workload as workload_mod
from ..utils.stats import global_stats
from ..utils.workpool import shard_map_reduce
from . import adaptive as adaptive_mod
from . import fusion as fusion_mod
from .bsicond import BsiConditionError, apply_bsi_condition, \
    bsi_condition_plan
from .result import FieldRow, GroupCount, Pair, RowIdentifiers, ValCount
from .stacked import DeadlineExceededError, last_batch_size, \
    note_batch_size, set_thread_deadline

_TOPN_STACK_CHUNK = 256  # rows per device stack on the per-shard path


class ExecError(Exception):
    pass


class FieldNotFound(ExecError):
    pass


class ExecOptions:
    def __init__(self, exclude_columns=False, column_attrs=False,
                 exclude_row_attrs=False, remote=False, profile=False,
                 explain=None):
        self.exclude_columns = exclude_columns
        self.column_attrs = column_attrs
        self.exclude_row_attrs = exclude_row_attrs
        self.remote = remote
        # ?profile=true: the API begins a QueryProfile for this query
        self.profile = profile
        # None (execute normally), "plan" (?explain=true: build the plan
        # tree, execute NOTHING), or "analyze" (?explain=analyze: execute
        # and graft actual costs onto the plan) — see exec/plan.py
        self.explain = explain
        # absolute time.monotonic() deadline of the request (the API sets
        # it from X-Request-Deadline); None: unbounded
        self.deadline = None


def unwrap_options(call, opt, shards=None):
    """(inner_call, merged_opt, shards) through nested Options() wrappers
    (reference: executeOptionsCall executor.go:244). Each level takes
    exactly one child; `shards` narrows the shard list (the innermost
    level wins), the flags override the caller's options, and any other
    argument is an error."""
    while call.name == "Options":
        if len(call.children) != 1:
            raise ExecError("Options() takes exactly one query")
        merged = ExecOptions(
            exclude_columns=opt.exclude_columns,
            column_attrs=opt.column_attrs,
            exclude_row_attrs=opt.exclude_row_attrs, remote=opt.remote,
            explain=getattr(opt, "explain", None))
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
        opt = merged
        call = call.children[0]
    return call, opt, shards


def uint_arg(call, key):
    """(value, present) for a non-negative integer argument; rejects
    negatives with the reference's message (pql.Call.UintArg
    pql/ast.go:315: "value for 'x' must be positive, but got -1" — the
    reference errors rather than silently serving an empty result)."""
    val = call.args.get(key)
    if val is None:
        return 0, False
    if isinstance(val, bool) or not isinstance(val, int):
        raise ExecError(
            f"could not convert {val!r} to an unsigned integer "
            f"for '{key}'")
    if val < 0:
        raise ExecError(
            f"value for '{key}' must be positive, but got {val}")
    return val, True


def uint_arg_or_none(call, key):
    """Validated optional unsigned arg: the value, or None when absent."""
    val, has = uint_arg(call, key)
    return val if has else None


#: the non-negative integer arguments of each call, checked tree-wide at
#: a cluster coordinator before it fans a query out
_UINT_ARGS_BY_CALL = {
    "TopN": ("n", "threshold", "tanimotoThreshold"),
    "Rows": ("limit", "previous", "column"),
    "GroupBy": ("limit", "offset"),
}


def validate_uint_args(call):
    """Negative-argument rejection for a whole call tree, run at the
    cluster coordinator (after key translation) so a bad argument fails
    once, with the local executor's message, instead of once per leg."""
    for key in _UINT_ARGS_BY_CALL.get(call.name, ()):
        if key in call.args:
            uint_arg(call, key)
    if call.name == "GroupBy" and "previous" in call.args:
        groupby_previous(call, len(call.children))
    for child in call.children:
        validate_uint_args(child)
    filt = call.args.get("filter")
    if isinstance(filt, Call):
        validate_uint_args(filt)


def check_write_limit(query, max_writes):
    """(reference: executor.Execute executor.go:135 + ErrTooManyWrites)"""
    if max_writes and max_writes > 0:
        n = sum(1 for c in query.calls if c.writes())
        if n > max_writes:
            raise ExecError("too many write commands")


def groupby_previous(call, n_children):
    """Validated GroupBy `previous` list cursor, or None when absent: one
    non-negative row id per Rows child, naming the last group a prior page
    returned; results resume lexicographically after it. Per-child
    validation mirrors the reference (Call.UintSliceArg pql/ast.go +
    executeGroupBy's per-field check, executor.go:2737-2745) — a length
    mismatch or a non-uint element errors rather than silently serving
    the wrong page."""
    prev = call.args.get("previous")
    if prev is None:
        return None
    if not isinstance(prev, (list, tuple)):
        raise ExecError(
            "'previous' argument must be a list of row ids for GroupBy")
    if len(prev) != n_children:
        raise ExecError(
            "'previous' argument must have a value for each GroupBy field")
    out = []
    for val in prev:
        if isinstance(val, bool) or not isinstance(val, int):
            raise ExecError(
                f"could not convert {val!r} to an unsigned integer "
                f"for 'previous'")
        if val < 0:
            raise ExecError(
                f"value for 'previous' must be positive, but got {val}")
        out.append(val)
    return out


def fragment_topn_candidates(frag, use_cache=True):
    """THE per-fragment TopN candidate policy: cache ids when a cache is
    populated (the reference's approximation), else every present row."""
    if use_cache and frag.cache is not None and len(frag.cache):
        return frag.cache.ids()
    return frag.row_ids()


#: bitmap calls: each evaluates to a Row (validate_bitmap_call,
#: bitmap_call_shard)
BITMAP_CALLS = frozenset((
    "Row", "Range", "Intersect", "Union", "Difference", "Xor", "Not",
    "Shift", "All"))

#: every call the port executes: the handler table of `execute_call`
#: and the bitmap calls, as in the TPU package
PORTED_CALLS = frozenset((
    "Sum", "Min", "Max", "MinRow", "MaxRow", "Count", "TopN", "Rows",
    "GroupBy", "Options", "Set", "Clear", "ClearRow", "Store",
    "SetRowAttrs", "SetColumnAttrs")) | BITMAP_CALLS


class Executor:
    """Single-node executor over a Holder, on `device` (default cuda:
    every visible card, as the TPU package serves from every local chip;
    raises when CUDA is absent and the CPU was not asked for). `device`
    may name several parts (`device.resolve_devices`): the stacked path
    then splits every stack over them (exec/parts.py), and the per-shard
    path runs on the first. A query with more than
    `max_writes_per_request` write calls is refused (<= 0: no limit)."""

    def __init__(self, holder, device=None, max_writes_per_request=0):
        from .parts import PartedEvaluator
        from .stacked import StackedEvaluator

        self.holder = holder
        self.max_writes_per_request = max_writes_per_request
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self._stacked = StackedEvaluator(self.device) \
            if len(self.devices) == 1 else PartedEvaluator(self.devices)
        # ?explain=analyze strategy capture: decision points append the
        # path they actually took to `notes` (set per top-level call by
        # explain_analyze_call; every strategy choice runs on the calling
        # thread, so a thread-local cannot observe another query's calls)
        self._explain_tls = threading.local()

    def stacked_stats(self):
        return self._stacked.cache_stats()

    def hbm_stats(self, top=50):
        """HBM ledger snapshot (see StackedEvaluator.hbm_snapshot)."""
        return self._stacked.hbm_snapshot(top=top)

    def kernel_stats(self, include_costs=True):
        """Per-kernel attribution (see StackedEvaluator.kernels_snapshot)."""
        return self._stacked.kernels_snapshot(include_costs=include_costs)

    def dispatch_phase_stats(self):
        """Per-kernel dispatch-phase decomposition (see
        StackedEvaluator.dispatch_phases)."""
        return {"phases": self._stacked.dispatch_phases()}

    # ------------------------------------------------------------------ API

    def execute(self, index_name, query, shards=None, options=None):
        """Execute a PQL string or Query; returns a list of results, one per
        top-level call (reference: executor.Execute executor.go:113)."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = parse(query)
        opt = options or ExecOptions()
        check_write_limit(query, self.max_writes_per_request)

        # Key translation happens only on the coordinating node (reference:
        # executor.go:2610).
        if not opt.remote:
            from .translate import translate_calls, translate_results

            translate_calls(idx, query.calls)

        explain = getattr(opt, "explain", None)
        if explain == "plan":
            # EXPLAIN without ANALYZE: build the annotated plan tree from
            # host-side metadata only and execute NOTHING — the launch
            # counters must not move (tests pin the delta at 0)
            from . import plan as plan_mod

            nodes = plan_mod.Planner(self).plan_query(
                idx, query.calls, shards, opt)
            plan_mod.stash(plan_mod.envelope(
                idx.name, "plan", nodes,
                shards=len(self._call_shards(idx, shards))))
            return []

        # Per-query stacked-counter deltas: the before/after diff
        # attributes launches, cache traffic and upload bytes to THIS
        # query — for the profile when one is active, and for the
        # always-on workload fingerprint table on every non-remote query
        # (the evaluator is shared, so concurrent queries can bleed into
        # each other's deltas; exact when queries are serialized).
        prof = profile_mod.current()
        wctx = None if opt.remote else workload_mod.begin_query(
            idx.name, query)
        wl_before = self._stacked.counters() if wctx is not None else None
        before = self._stacked.cache_stats() if prof is not None else None
        # a previous query's batch stamp must not leak into this query's
        # batch= attribution; same for the whole-plan fused= stamp (both
        # take-last thread-locals, reset per query)
        note_batch_size(0)
        fusion_mod.note_fused(0)
        plan_nodes = [] if explain == "analyze" else None
        results = []
        t_query = time.perf_counter()
        # Deadline propagation: arm the dispatch-boundary thread-local for
        # this query (the stacked evaluator refuses expired work before
        # taking the dispatch lock) and check between top-level calls.
        # None: both checks are no-ops.
        deadline = opt.deadline
        if deadline is not None:
            set_thread_deadline(deadline)
        try:
            with tracing.start_span("executor.Execute",
                                    index=index_name) as span:
                # Whole-plan fusion: an eligible multi-call query runs as
                # ONE fused dispatch (exec/fusion.py); None → the per-call
                # loop, as without fusion
                fused_results = None
                if fusion_mod.enabled():
                    if plan_nodes is None:
                        fused_results = fusion_mod.maybe_execute(
                            self, idx, query, shards, opt)
                    else:
                        fused_results = self._fused_analyze(
                            idx, query, shards, opt, plan_nodes)
                if fused_results is not None:
                    results = fused_results
                else:
                    for call in query.calls:
                        if deadline is not None \
                                and time.monotonic() >= deadline:
                            raise DeadlineExceededError(
                                "request deadline expired between calls")
                        t_call = time.perf_counter()
                        self._explain_tls.last = None
                        with tracing.start_span(
                                f"executor.execute{call.name}"):
                            if plan_nodes is None:
                                results.append(self.execute_call(
                                    idx, call, shards, opt))
                            else:
                                result, node = self.explain_analyze_call(
                                    idx, call, shards, opt)
                                results.append(result)
                                plan_nodes.append(node)
                        call_wall = time.perf_counter() - t_call
                        # per-PQL-op latency histogram (the global
                        # registry, which /metrics resolves to)
                        global_stats.timing("query_op_seconds", call_wall,
                                            {"op": call.name})
                        if adaptive_mod.enabled():
                            # observed per-shard fallback walls calibrate
                            # the engine's est_fallback side (shadow
                            # learns too)
                            last = getattr(self._explain_tls, "last",
                                           None)
                            if last is not None \
                                    and last[0] == call.name \
                                    and last[1].startswith("per-shard"):
                                adaptive_mod.observe_fallback(
                                    call.name, call_wall,
                                    len(self._call_shards(idx, shards)))
                if span is not None:
                    span.set_tag("calls", len(query.calls))
            if prof is not None:
                after = self._stacked.cache_stats()
                prof.set_tag("shards_touched",
                             len(self._call_shards(idx, shards)))
                for key, tag in (("dispatches", "dispatches"),
                                 ("pairwise_dispatches",
                                  "pairwise_dispatches"),
                                 ("pairwise_syncs", "pairwise_syncs"),
                                 ("hits", "cache_hits"),
                                 ("misses", "cache_misses")):
                    prof.add(tag, after[key] - before[key])
                prof.add("bytes_materialized",
                         (after["planes_uploaded"]
                          - before["planes_uploaded"])
                         * WORDS_PER_ROW * 4)
        finally:
            if deadline is not None:
                set_thread_deadline(None)
            # even a failed query records its shape — a recurring error
            # shape is exactly what the workload view should surface
            if wctx is not None:
                wl_after = self._stacked.counters()
                workload_mod.end_query(
                    wctx, time.perf_counter() - t_query, deltas={
                        "dispatches": wl_after[0] - wl_before[0],
                        "cache_hits": wl_after[1] - wl_before[1],
                        "cache_misses": wl_after[2] - wl_before[2],
                        "bytes_materialized":
                            (wl_after[3] - wl_before[3])
                            * WORDS_PER_ROW * 4,
                    })

        if plan_nodes is not None:
            from . import plan as plan_mod

            env = plan_mod.envelope(
                idx.name, "analyze", plan_nodes,
                shards=len(self._call_shards(idx, shards)),
                trace_id=prof.root.trace_id if prof is not None else None)
            plan_mod.stash(env)
            if prof is not None:
                prof.set_tag("plan_summary", plan_mod.summary(plan_nodes))
            # only misestimated plans earn a ring slot: the ring is the
            # triage queue for cost-model drift, not a second query log
            if any(n.misestimates for n in plan_nodes):
                plan_mod.record(
                    env,
                    fingerprint=wctx.fingerprint
                    if wctx is not None else None)

        if not opt.remote:
            results = translate_results(idx, query.calls, results)
        return results

    def explain_analyze_call(self, idx, call, shards, opt):
        """One ?explain=analyze step: build the call's plan node FIRST
        (so estimates can't peek at the outcome), execute it while
        capturing strategy notes + stacked-counter and per-kernel-family
        deltas, then graft the actuals and flag misestimates. Returns
        (result, PlanNode)."""
        from . import plan as plan_mod

        node = plan_mod.Planner(self).plan_call(idx, call, shards, opt)
        notes = self._explain_tls.notes = []
        before = self._stacked.cache_stats()
        kern_before = self._stacked.kernel_profile()
        phases_before = self._stacked.dispatch_phases()
        t0 = time.perf_counter()
        try:
            result = self.execute_call(idx, call, shards, opt)
        finally:
            self._explain_tls.notes = None
        wall = time.perf_counter() - t0
        plan_mod.graft_actual(
            node, wall, before, self._stacked.cache_stats(),
            kern_before, self._stacked.kernel_profile(), strategies=notes,
            phases_before=phases_before,
            phases_after=self._stacked.dispatch_phases())
        return result, node

    def _fused_analyze(self, idx, query, shards, opt, plan_nodes):
        """?explain=analyze over the fused path: build EVERY top-level
        plan node first (so estimates can't peek at the outcome), then
        run the whole query as one fused dispatch, then graft the single
        dispatch's actuals — the whole-query delta lands on the first
        node and the rest graft a zero delta, so the summed per-node
        `dispatches` actuals equal the real total. Returns the results
        list, or None when the query didn't fuse — the caller's analyze
        loop then builds its own nodes (the ones made here are
        discarded)."""
        from . import plan as plan_mod

        nodes = plan_mod.Planner(self).plan_query(
            idx, query.calls, shards, opt)
        notes = self._explain_tls.notes = []
        before = self._stacked.cache_stats()
        kern_before = self._stacked.kernel_profile()
        phases_before = self._stacked.dispatch_phases()
        t0 = time.perf_counter()
        try:
            results = fusion_mod.maybe_execute(
                self, idx, query, shards, opt)
        finally:
            self._explain_tls.notes = None
        if results is None:
            return None
        wall = time.perf_counter() - t0
        after = self._stacked.cache_stats()
        kern_after = self._stacked.kernel_profile()
        phases_after = self._stacked.dispatch_phases()
        for i, node in enumerate(nodes):
            if i == 0:
                plan_mod.graft_actual(
                    node, wall, before, after, kern_before, kern_after,
                    strategies=notes, phases_before=phases_before,
                    phases_after=phases_after)
            else:
                # later calls rode the first node's dispatch: zero delta
                plan_mod.graft_actual(node, 0.0, after, after,
                                      kern_after, kern_after,
                                      strategies=notes)
        plan_nodes.extend(nodes)
        return results

    def _note_strategy(self, op, strategy, **detail):
        """Record the strategy a decision point ACTUALLY took. Feeds the
        analyze grafting (thread-local notes), the workload fingerprint
        table's per-shape strategy distribution (always on), and, when a
        profile is active, the profile's `strategies` tag — which is
        what SLOW QUERY lines print, so a wedge can be triaged from logs
        alone."""
        workload_mod.note_strategy(op, strategy)
        # last (op, strategy) taken on THIS thread — execute()'s per-call
        # timing reads it to attribute fallback walls to the adaptive
        # engine's per-shard calibration
        self._explain_tls.last = (op, strategy)
        notes = getattr(self._explain_tls, "notes", None)
        prof = profile_mod.current()
        if notes is None and prof is None:
            return  # nothing else listening: stay off the hot path
        entry = {"op": op, "strategy": strategy}
        entry.update(detail)
        if notes is not None:
            notes.append(entry)
        if prof is not None:
            prof.note("strategies", entry)

    # ------------------------------------------------------------ adaptive

    def _adaptive_decide(self, op, idx, cover_call, shard_list, kernels,
                         extra_missing_bytes=0):
        """Stacked-vs-fallback pricing for one ELIGIBLE decision point.
        Mirrors the planner's kernel map for the op (exec/plan.py builds
        the same {family: n} before pricing), so the plan path and the
        execute path reach the same decision from the same calibration.
        Returns None when the engine is off or the static gates already
        force the choice — a None means "behave exactly as before"."""
        from .stacked import MIN_SHARDS

        if not adaptive_mod.enabled():
            return None
        if len(shard_list) < MIN_SHARDS:
            return None
        kernels = dict(kernels)
        missing = int(extra_missing_bytes)
        if cover_call is not None:
            # side-effect-free residency walk (no stacks built, no heat)
            probe = self._stacked.residency_probe(
                idx, cover_call, tuple(shard_list))
            if not probe.get("covered"):
                return None
            for family, n in probe.get("extra_kernels", {}).items():
                kernels[family] = kernels.get(family, 0) + n
            missing += int(probe.get("missing_bytes", 0))
        return adaptive_mod.decide_strategy(
            op, kernels, len(shard_list), missing, stacked=self._stacked)

    @staticmethod
    def _chosen_detail(dec):
        """EXPLAIN detail for a priced decision (empty when static)."""
        return {} if dec is None else {"chosen_by": dec.chosen_by}

    @staticmethod
    def _fallback_chosen(dec):
        """True when an acting engine priced the per-shard path cheaper."""
        return dec is not None and dec.act and dec.strategy == "fallback"

    def _bsi_missing_bytes(self, idx, field, shard_list):
        """Upload bytes a cold BSI stack build would pay — the planner's
        (depth + 2) planes pricing (_plan_bsi_agg); 0 without a probe
        when the adaptive engine is off (nothing prices them)."""
        if not adaptive_mod.enabled():
            return 0
        st = tuple(shard_list)
        if self._stacked.bsi_stack_resident(idx, field.name, st):
            return 0
        plane = self._stacked._padded_len(st) * WORDS_PER_ROW * 4
        return (field.options.bit_depth + 2) * plane

    def _row_counts_decision(self, idx, field, call, candidates,
                             filter_call, shard_list, view_name):
        """Adaptive pricing for the chunked row-counts gate (TopN /
        single-field GroupBy) — the planner's _plan_topn kernel map."""
        if call is None or not adaptive_mod.enabled():
            return None
        st = tuple(shard_list)
        chunk = self._stacked.row_chunk_size(st)
        n_chunks = -(-len(candidates) // chunk) if candidates else 0
        kernels = {}
        if n_chunks:
            kernels["row_counts"] = n_chunks
        if filter_call is not None:
            kernels["filter"] = 1
        missing_rows = 0
        plane = self._stacked._padded_len(st) * WORDS_PER_ROW * 4
        for i in range(0, len(candidates), chunk):
            part = tuple(candidates[i:i + chunk])
            if not self._stacked.rows_chunk_resident(
                    idx, field.name, part, st, view_name):
                missing_rows += len(part)
        return self._adaptive_decide(
            call.name, idx, filter_call, shard_list, kernels,
            extra_missing_bytes=missing_rows * plane)

    def maybe_proactive_admit(self, max_rows=None, max_bytes=None):
        """Bounded proactive admission of hot_but_not_resident fragments
        — called from idle windows (the coalescer drain loop between
        batches) so demand heat translates into residency BEFORE the
        next query pays the cold build. Skips entirely when the adaptive
        engine is off or a launch is in flight (admission must never
        queue behind — or ahead of — real serving traffic). Returns the
        number of fragments admitted (shadow: candidates counted, none
        built)."""
        if not adaptive_mod.enabled():
            return 0
        st_eval = self._stacked
        if st_eval._dispatch_lock.locked():
            return 0
        max_rows = adaptive_mod.ADMIT_MAX_ROWS if max_rows is None \
            else int(max_rows)
        max_bytes = adaptive_mod.ADMIT_MAX_BYTES if max_bytes is None \
            else int(max_bytes)
        try:
            report = workload_mod.heat().report(
                st_eval.hbm_snapshot(top=0), top=8)
        except Exception:  # noqa: BLE001 — admission is best effort
            return 0
        candidates = report.get("hot_but_not_resident") or []
        if not candidates:
            return 0
        adaptive_mod.note_admission_round()
        admitted = rows_built = bytes_built = 0
        for cand in candidates:
            if rows_built >= max_rows or bytes_built >= max_bytes:
                break
            idx = self.holder.index(cand["index"])
            field = idx.field(cand["field"]) if idx is not None else None
            if field is None:
                continue
            if not adaptive_mod.acting():
                adaptive_mod.note_admission(cand["index"], cand["field"],
                                            0, 0, shadow=True)
                continue
            shard_list = self._call_shards(idx, None)
            if not shard_list:
                continue
            st = tuple(shard_list)
            plane_bytes = st_eval._padded_len(st) * WORDS_PER_ROW * 4
            frag_rows = frag_bytes = 0
            if field.type == FIELD_TYPE_INT:
                if st_eval.bsi_stack(idx, field.name, st) is None:
                    continue
                frag_rows = field.options.bit_depth + 2
                frag_bytes = frag_rows * plane_bytes
            else:
                view = field.view(VIEW_STANDARD)
                if view is None:
                    continue
                row_ids = sorted({r for shard in st
                                  for frag in (view.fragment(shard),)
                                  if frag is not None
                                  for r in frag.row_ids()})
                budget_rows = min(len(row_ids), max_rows - rows_built)
                for row_id in row_ids[:budget_rows]:
                    if bytes_built + frag_bytes >= max_bytes:
                        break
                    if st_eval.leaf_stack(idx, field.name, row_id,
                                          st) is None:
                        break
                    frag_rows += 1
                    frag_bytes += plane_bytes
                if frag_rows == 0:
                    continue
            rows_built += frag_rows
            bytes_built += frag_bytes
            admitted += 1
            # converge /debug/heat: the fragment is resident now, so its
            # heat drops to the hot threshold and the candidate list
            # stops re-recommending it
            workload_mod.heat().note_admitted(cand["index"], cand["field"])
            adaptive_mod.note_admission(cand["index"], cand["field"],
                                        frag_rows, frag_bytes)
            global_stats.count("stacked_admissions", 1, {"cause": "heat"})
        return admitted

    def execute_call(self, idx, call, shards, opt):
        handler = {
            "Sum": self._exec_sum,
            "Min": self._exec_min,
            "Max": self._exec_max,
            "MinRow": self._exec_min_row,
            "MaxRow": self._exec_max_row,
            "Count": self._exec_count,
            "TopN": self._exec_topn,
            "Rows": self._exec_rows,
            "GroupBy": self._exec_group_by,
            "Options": self._exec_options,
            "Set": self._exec_set,
            "Clear": self._exec_clear,
            "ClearRow": self._exec_clear_row,
            "Store": self._exec_store,
            "SetRowAttrs": self._exec_set_row_attrs,
            "SetColumnAttrs": self._exec_set_column_attrs,
        }.get(call.name)
        if handler is not None:
            return handler(idx, call, shards, opt)
        # default: bitmap call (unknown names fail its validation)
        return self._exec_bitmap_call(idx, call, shards, opt)

    def _call_shards(self, idx, shards):
        if shards is not None:
            return list(shards)
        return idx.available_shards()

    def _bump_fallback_heat(self, idx, call):
        """Shard-by-shard accesses feed the fragment heat ledger too: a
        working set that never enters the stacked path must still look
        hot (the stacked cache probes cover the cached path). One bump
        per Row/Range leaf per query — demand frequency, not shard
        fan-out."""
        if call.name in ("Row", "Range") and call.args:
            from ..pql.ast import is_reserved_arg

            field_name = next(
                (k for k in call.args if not is_reserved_arg(k)), None)
            if field_name is not None \
                    and idx.field(field_name) is not None:
                workload_mod.heat_bump(idx.name, field_name, VIEW_STANDARD)
        for child in call.children:
            self._bump_fallback_heat(idx, child)

    # --------------------------------------------------- batched execution

    #: single-call read families the batched pipeline serves with one
    #: launch per group; anything else (aggregates, TopN, writes,
    #: multi-call requests) takes the per-query path per member
    BATCHABLE_CALLS = frozenset((
        "Count", "Row", "Range", "Intersect", "Union", "Difference",
        "Xor"))

    def launch_batch(self, index_name, queries, shards=None, options=None):
        """Phase 1 of batched execution: parse/translate/classify every
        query, gather leaf stacks for the batchable ones, and launch them
        in groups (StackedEvaluator.launch_query_batch) WITHOUT waiting
        for results. Returns (handle, state) for resolve_batch. A
        member's own failure is kept in its slot, never raised — one bad
        query must not sink its batchmates. A failed launch is kept as
        the handle and becomes the error of every member that rode it."""
        import copy

        from .translate import translate_calls

        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecError(f"index not found: {index_name}")
        opt = options or ExecOptions()
        shard_list = self._call_shards(idx, shards)
        entries = []
        items = []
        # Coalesced traffic repeats hot queries, so identical PQL strings
        # in one batch share a single parsed (and translated) AST. Key
        # translation mutates the tree in place and is not idempotent, so
        # a shared tree is translated exactly once.
        parsed_cache = {}
        translated = set()
        for query in queries:
            # e["raw"] is the member's UNTRANSLATED form: every per-query
            # re-execution (not-batchable shape, gather miss) starts from
            # it, never from e["query"], which execute() would translate
            # again
            e = {"query": query, "raw": query, "error": None, "item": None,
                 "fallback": False, "call": None, "kind": None,
                 "wctx": None, "deltas": None, "t0": time.perf_counter()}
            entries.append(e)
            try:
                if isinstance(query, str):
                    q = parsed_cache.get(query)
                    if q is None:
                        q = parsed_cache[query] = parse(query)
                    query = e["query"] = q
                check_write_limit(query, self.max_writes_per_request)
                call = query.calls[0] if len(query.calls) == 1 else None
                if call is None or call.name not in self.BATCHABLE_CALLS:
                    e["fallback"] = True  # execute() translates it
                    continue
                if not opt.remote:
                    if not isinstance(e["raw"], str):
                        e["raw"] = copy.deepcopy(query)
                    if id(query) not in translated:
                        translate_calls(idx, query.calls)
                        translated.add(id(query))
                if call.name == "Count":
                    if len(call.children) != 1:
                        raise ExecError(
                            "Count() takes exactly one row query")
                    tree, kind = call.children[0], "count"
                else:
                    tree, kind = call, "plane"
                self.validate_bitmap_call(idx, tree)
                if kind == "plane":
                    self._bump_fallback_heat(idx, call)
                wctx = workload_mod.begin_query(idx.name, query)
                e["wctx"] = wctx
                wl_before = self._stacked.counters()
                gathered = self._stacked.gather_for_batch(
                    idx, tree, shard_list)
                if gathered is None:
                    # not stack-coverable: the per-query path opens (and
                    # records) its own context
                    workload_mod.abort_query(wctx)
                    e["wctx"] = None
                    e["fallback"] = True
                    continue
                wl_after = self._stacked.counters()
                # gather-side deltas now, the launch at resolve: a batched
                # launch serves the whole batch, so resolve_batch charges
                # each launch to exactly ONE of the members that rode it
                e["deltas"] = {
                    "dispatches": 0,
                    "cache_hits": wl_after[1] - wl_before[1],
                    "cache_misses": wl_after[2] - wl_before[2],
                    "bytes_materialized":
                        (wl_after[3] - wl_before[3]) * WORDS_PER_ROW * 4,
                }
                e["call"] = call
                e["kind"] = kind
                sig, stacks = gathered
                e["item"] = len(items)
                items.append((kind, sig, stacks))
            except Exception as exc:  # noqa: BLE001 — per-query isolation
                if e["wctx"] is not None:
                    workload_mod.abort_query(e["wctx"])
                    e["wctx"] = None
                e["error"] = exc
        handle = []
        if items:
            try:
                handle = self._stacked.launch_query_batch(items)
            except Exception as exc:  # noqa: BLE001 — the riders' error
                handle = exc
        return handle, (idx, opt, shards, shard_list, entries)

    def resolve_batch(self, handle, state):
        """Phase 2: ONE wait for the batch's copy to the host, then the
        per-member demux — counts to exact ints, plane stacks to Row
        segments — and fallback members run the ordinary per-query path.
        Returns (results, error, batch_size) per member in submission
        order: error is the member's exception (None on success),
        batch_size the occupancy of the launch it rode (0 = per-query
        path). A failed launch or fetch is the error of every member that
        rode it; nothing re-runs them."""
        from .translate import translate_results

        idx, opt, shards, shard_list, entries = state
        batch_error = handle if isinstance(handle, Exception) else None
        resolved = {}
        if handle and batch_error is None:
            try:
                resolved = self._stacked.resolve_query_batch(handle)
            except Exception as exc:  # noqa: BLE001 — the riders' error
                batch_error = exc
        out = []
        charged = set()  # batched launches already attributed to a member
        for e in entries:
            query = e["query"]
            wctx = e["wctx"]
            try:
                if e["error"] is not None:
                    raise e["error"]
                if e["fallback"]:
                    # from the untranslated form: e["query"] may already
                    # be key-translated, and translation is not idempotent
                    results = self.execute(
                        idx.name, e["raw"], shards=shards, options=opt)
                    out.append((results, None, 0))
                    continue
                if batch_error is not None:
                    raise batch_error
                val, bsize, seq = resolved[e["item"]]
                if seq not in charged:
                    charged.add(seq)
                    e["deltas"]["dispatches"] = 1
                if e["kind"] == "count":
                    results = [val]
                else:
                    row = Row()
                    for j, shard in enumerate(shard_list):
                        seg = val[j]
                        if seg.any():
                            # copy: a view would pin the whole [n, S, W]
                            # host buffer for the row's lifetime
                            row.segments[shard] = np.array(seg)
                    if opt.exclude_columns:
                        row.segments = {}
                    if not opt.remote:
                        self.attach_row_attrs(idx, e["call"], row, opt)
                    results = [row]
                if not opt.remote:
                    results = translate_results(idx, query.calls, results)
                # strategy + batch attribution on the member's own context
                # (the thread-local points at the LAST member begun, so
                # write through the entry's handle)
                wctx.strategies.append(f"{e['call'].name}=stacked-batched")
                wctx.batch = bsize
                workload_mod.end_query(
                    wctx, time.perf_counter() - e["t0"],
                    deltas=e["deltas"])
                out.append((results, None, bsize))
            except Exception as exc:  # noqa: BLE001 — per-query isolation
                if wctx is not None:
                    workload_mod.abort_query(wctx)
                out.append((None, exc, 0))
        return out

    def execute_batch(self, index_name, queries, shards=None,
                      options=None):
        """Batched execution, launch + resolve in one call (the explicit
        POST /index/{i}/query-batch route). The coalescer drives the two
        phases separately so batch N+1's launch overlaps batch N's
        resolve (double buffering)."""
        handle, state = self.launch_batch(
            index_name, queries, shards=shards, options=options)
        return self.resolve_batch(handle, state)

    # ------------------------------------------------------- bitmap calls

    def validate_bitmap_call(self, idx, call):
        """Structural checks independent of shard data (so empty indexes
        still reject malformed queries, matching the reference's per-shard
        errors)."""
        name = call.name
        if name in ("Intersect", "Difference", "Xor") and not call.children:
            raise ExecError(f"empty {name} query is currently not supported")
        if name == "Not":
            if len(call.children) != 1:
                raise ExecError("Not() takes exactly one row query")
            if not idx.options.track_existence:
                raise ExecError("Not() requires existence tracking on the index")
        if name == "Shift" and len(call.children) != 1:
            raise ExecError("Shift() takes exactly one row query")
        if name in ("Row", "Range"):
            field_name = call.field_arg() if not call.has_conditions() else \
                next(iter(call.args))
            if idx.field(field_name) is None:
                raise FieldNotFound(f"field not found: {field_name}")
        if name not in BITMAP_CALLS:
            raise ExecError(f"unknown call: {name}")
        for child in call.children:
            self.validate_bitmap_call(idx, child)

    def _exec_bitmap_call(self, idx, call, shards, opt):
        self.validate_bitmap_call(idx, call)
        self._bump_fallback_heat(idx, call)
        shard_list = self._call_shards(idx, shards)
        per_shard = shard_map_reduce(
            shard_list, lambda shard: self.bitmap_call_shard(idx, call, shard))
        row = Row()
        for shard, plane in zip(shard_list, per_shard):
            if plane is None:
                continue
            host = bitplane.to_host(plane)
            if host.any():
                row.segments[shard] = host
        if opt.exclude_columns:
            row.segments = {}
        if not opt.remote:
            self.attach_row_attrs(idx, call, row, opt)
        return row

    def attach_row_attrs(self, idx, call, row, opt):
        """Coordinator-side Row result decoration (reference:
        executeBitmapCall executor.go:605-645)."""
        if call.name in ("Row", "Range") and not call.has_conditions() \
                and "from" not in call.args and "to" not in call.args:
            if opt.exclude_row_attrs:
                row.attrs = {}
            else:
                field_name = call.field_arg()
                field = idx.field(field_name) if field_name else None
                row_id = call.args.get(field_name) if field_name else None
                if field is not None and field.row_attr_store is not None \
                        and isinstance(row_id, int) \
                        and not isinstance(row_id, bool):
                    attrs = field.row_attr_store.attrs(row_id)
                    if attrs:
                        row.attrs = attrs
        if opt.exclude_columns:
            row.segments = {}

    def _zeros(self):
        return torch.zeros(WORDS_PER_ROW, dtype=torch.int32, device=self.device)

    def bitmap_call_shard(self, idx, call, shard):
        """Evaluate a bitmap call tree for one shard -> device plane (or
        None when provably empty). Reference: executeBitmapCallShard
        executor.go:651."""
        name = call.name
        if name in ("Row", "Range"):
            return self._row_shard(idx, call, shard)
        if name == "Intersect":
            planes = [self.bitmap_call_shard(idx, c, shard)
                      for c in call.children]
            if any(p is None for p in planes):
                return None
            out = planes[0]
            for p in planes[1:]:
                out = bitplane.intersect(out, p)
            return out
        if name == "Union":
            planes = [self.bitmap_call_shard(idx, c, shard)
                      for c in call.children]
            planes = [p for p in planes if p is not None]
            if not planes:
                return None
            out = planes[0]
            for p in planes[1:]:
                out = bitplane.union(out, p)
            return out
        if name == "Difference":
            first = self.bitmap_call_shard(idx, call.children[0], shard)
            if first is None:
                return None
            out = first
            for c in call.children[1:]:
                p = self.bitmap_call_shard(idx, c, shard)
                if p is not None:
                    out = bitplane.difference(out, p)
            return out
        if name == "Xor":
            planes = [self.bitmap_call_shard(idx, c, shard)
                      for c in call.children]
            planes = [p if p is not None else self._zeros() for p in planes]
            out = planes[0]
            for p in planes[1:]:
                out = bitplane.xor(out, p)
            return out
        if name == "Not":
            exists = self._existence_plane(idx, shard)
            if exists is None:
                return None
            child = self.bitmap_call_shard(idx, call.children[0], shard)
            if child is None:
                return exists
            return bitplane.difference(exists, child)
        if name == "Shift":
            n = int(call.args.get("n", 1))
            child = self.bitmap_call_shard(idx, call.children[0], shard)
            if child is None:
                return None
            # within the shard: bits past its last column drop (reference
            # Row.Shift shifts within segments)
            return bitplane.shift(child, n)
        if name == "All":
            return self._existence_plane(idx, shard)
        raise ExecError(f"unknown call: {name}")

    def _existence_plane(self, idx, shard):
        field = idx.existence_field()
        if field is None:
            return None
        return self._fragment_row_plane(field, VIEW_STANDARD, shard, 0)

    def _fragment_row_plane(self, field, view_name, shard, row_id):
        """Device plane of one fragment row (uploaded from the host
        fragment's dense words), or None when the fragment is absent."""
        view = field.view(view_name)
        if view is None:
            return None
        frag = view.fragment(shard)
        if frag is None:
            return None
        return bitplane.to_device(frag.row_plane(row_id), self.device)

    def _row_shard(self, idx, call, shard):
        """Row(field=rowID), Row(field=rowID, from=..., to=...), or BSI
        Row(field <op> value). Reference: executeRowShard executor.go:1441."""
        if call.has_conditions():
            return self._row_bsi_shard(idx, call, shard)
        field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        row_id = call.args[field_name]
        if isinstance(row_id, bool):
            row_id = 1 if row_id else 0
        if not isinstance(row_id, int):
            raise ExecError(
                f"Row(): row ID must be an integer or key: {row_id!r}")

        if "from" not in call.args and "to" not in call.args:
            return self._fragment_row_plane(field, VIEW_STANDARD, shard,
                                            row_id)
        if field.type != FIELD_TYPE_TIME:
            raise ExecError(f"field {field_name} is not a time field")
        from_t = timeq.parse_time(call.args["from"]) if "from" in call.args \
            else timeq.parse_time("1970-01-01T00:00")
        to_t = timeq.parse_time(call.args["to"]) if "to" in call.args \
            else timeq.parse_time("2100-01-01T00:00")
        out = None
        for view_name in timeq.views_by_time_range(
                VIEW_STANDARD, from_t, to_t, field.time_quantum()):
            plane = self._fragment_row_plane(field, view_name, shard, row_id)
            if plane is None:
                continue
            out = plane if out is None else bitplane.union(out, plane)
        return out

    # -- BSI row conditions --------------------------------------------------

    def _bsi_meta(self, idx, field_name):
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        if field.type != FIELD_TYPE_INT:
            raise ExecError(f"field {field_name} is not an int field")
        return field

    def _bsi_planes(self, field, shard):
        """(planes [D, W], sign [W], exists [W]): views of one [D+2, W]
        device upload of the shard's bit-plane rows, or None when the
        fragment is absent."""
        view = field.view(field.bsi_view_name())
        if view is None:
            return None
        frag = view.fragment(shard)
        if frag is None:
            return None
        rows = [BSI_EXISTS_BIT, BSI_SIGN_BIT] + [
            BSI_OFFSET_BIT + i for i in range(field.options.bit_depth)]
        stack = self._fragment_rows(frag, rows)
        return stack[2:], stack[1], stack[0]

    def _not_null_plane(self, field, shard):
        return self._fragment_row_plane(field, field.bsi_view_name(), shard,
                                        BSI_EXISTS_BIT)

    def _row_bsi_shard(self, idx, call, shard):
        """Row(field <op> value) for one shard via the shared condition
        plan (exec/bsicond.py — the same plan and K5 evaluate the stacked
        [D, S, W] planes on the serving path). Reference:
        executeRowBSIGroupShard executor.go:1533."""
        if len(call.args) != 1:
            raise ExecError("Row(): condition required" if not call.args
                            else "Row(): too many arguments")
        field_name, cond = next(iter(call.args.items()))
        if not isinstance(cond, Condition):
            raise ExecError("Row(): expected condition argument")
        field = self._bsi_meta(idx, field_name)
        try:
            plan = bsi_condition_plan(field.options, cond)
        except BsiConditionError as e:
            raise ExecError(str(e)) from e
        if plan[0] == "empty":
            return None
        if plan[0] == "notnull":
            return self._not_null_plane(field, shard)
        data = self._bsi_planes(field, shard)
        if data is None:
            return None
        planes, sign, exists = data
        return apply_bsi_condition(plan, planes, sign, exists)

    # ------------------------------------------------------------ aggregates

    def _exec_count(self, idx, call, shards, opt):
        """(reference: executeCount executor.go:1790)"""
        if len(call.children) != 1:
            raise ExecError("Count() takes exactly one row query")
        self.validate_bitmap_call(idx, call.children[0])
        shard_list = self._call_shards(idx, shards)
        dec = self._adaptive_decide("Count", idx, call.children[0],
                                    shard_list, {"count": 1})
        # Fast path: coverable Row/set-op trees evaluate over ALL shards
        # in one launch on generation-cached [S, W] stacks.
        fast = None if self._fallback_chosen(dec) \
            else self._stacked.try_count(idx, call.children[0], shard_list)
        if fast is not None:
            # how many concurrent queries shared the launch (GroupCommit
            # stamps it on this thread)
            n = last_batch_size() or 1
            self._note_strategy("Count", "stacked", batch=n,
                                **self._chosen_detail(dec))
            if n > 1:
                workload_mod.note_batch(n)
            return fast
        self._note_strategy("Count", "per-shard",
                            **self._chosen_detail(dec))

        def count_shard(shard):
            plane = self.bitmap_call_shard(idx, call.children[0], shard)
            return None if plane is None else bitplane.popcount(plane)

        counts = [c for c in shard_map_reduce(shard_list, count_shard)
                  if c is not None]
        if not counts:
            return 0
        return int(torch.stack(counts).sum())

    def _sum_filter_planes(self, idx, call, shard):
        """Returns (has_filter, plane). has_filter with plane None means the
        filter is provably empty in this shard — the shard contributes
        nothing (distinct from 'no filter given')."""
        if call.children:
            self.validate_bitmap_call(idx, call.children[0])
            return True, self.bitmap_call_shard(idx, call.children[0], shard)
        return False, None

    def _agg_field(self, idx, call):
        field_name = call.args.get("field") or call.args.get("_field")
        if field_name is None:
            field_name = call.field_arg()
        return self._bsi_meta(idx, field_name)

    def _agg_filter_call(self, idx, call):
        """The optional filter child of an aggregate call, validated."""
        if call.children:
            self.validate_bitmap_call(idx, call.children[0])
            return call.children[0]
        return None

    def _exec_sum(self, idx, call, shards, opt):
        """(reference: executeSum executor.go:331 + fragment.sum)"""
        field = self._agg_field(idx, call)
        opts = field.options
        depth = opts.bit_depth
        shard_list = self._call_shards(idx, shards)
        filter_call = self._agg_filter_call(idx, call)
        kernels = {"sum": 1}
        if filter_call is not None:
            kernels["filter"] = 1
        dec = self._adaptive_decide(
            "Sum", idx, filter_call, shard_list, kernels,
            extra_missing_bytes=self._bsi_missing_bytes(
                idx, field, shard_list))
        # Fast path: K3 over the stacked BSI planes of every shard (falls
        # back when the filter tree isn't stack-coverable).
        fast = None if self._fallback_chosen(dec) \
            else self._stacked.try_sum(idx, field, filter_call, shard_list)
        if fast is not None:
            self._note_strategy("Sum", "stacked-sum",
                                **self._chosen_detail(dec))
            total, count = fast
            return ValCount(total + opts.base * count, count)
        self._note_strategy("Sum", "per-shard", **self._chosen_detail(dec))

        def sum_shard(shard):
            data = self._bsi_planes(field, shard)
            if data is None:
                return None
            planes, sign, exists = data
            has_filter, filt = self._sum_filter_planes(idx, call, shard)
            if has_filter and filt is None:
                return None  # empty filter -> shard contributes nothing
            pos, neg, cnt = bsi_ops.bsi_plane_counts(planes, sign, exists,
                                                     filt)
            return torch.cat([pos, neg, cnt.reshape(1)])

        total, count = 0, 0
        for counts in shard_map_reduce(shard_list, sum_shard):
            if counts is None:
                continue
            vals = counts.tolist()
            total += sum((vals[i] - vals[depth + i]) << i
                         for i in range(depth))
            count += vals[-1]
        # base contributes once per existing column (reference: Sum adds
        # base*count since stored values are base-adjusted)
        total += opts.base * count
        return ValCount(total, count)

    def _minmax_shard(self, field, idx, call, shard, is_max):
        data = self._bsi_planes(field, shard)
        if data is None:
            return ValCount()
        planes, sign, exists = data
        consider = exists
        has_filter, filt = self._sum_filter_planes(idx, call, shard)
        if has_filter and filt is None:
            return ValCount()
        if filt is not None:
            consider = bitplane.intersect(consider, filt)
        if not bool(consider.any()):
            return ValCount()
        pos = bitplane.difference(consider, sign)
        neg = bitplane.intersect(consider, sign)
        has_pos = bool(pos.any())
        has_neg = bool(neg.any())
        if is_max:
            # highest positive, else closest-to-zero negative (reference:
            # fragment.max fragment.go:1190)
            if has_pos:
                bits, final = bsi_ops.max_unsigned(planes, pos)
                sign_mult = 1
            else:
                bits, final = bsi_ops.min_unsigned(planes, neg)
                sign_mult = -1
        else:
            # lowest negative (largest magnitude), else lowest positive
            if has_neg:
                bits, final = bsi_ops.max_unsigned(planes, neg)
                sign_mult = -1
            else:
                bits, final = bsi_ops.min_unsigned(planes, pos)
                sign_mult = 1
        mag = sum(b << i for i, b in enumerate(bits.tolist()))
        count = int(bitplane.popcount(final))
        return ValCount(sign_mult * mag + field.options.base, count)

    def _exec_min(self, idx, call, shards, opt):
        return self._exec_minmax(idx, call, shards, is_max=False)

    def _exec_max(self, idx, call, shards, opt):
        return self._exec_minmax(idx, call, shards, is_max=True)

    def _exec_minmax(self, idx, call, shards, is_max):
        field = self._agg_field(idx, call)
        shard_list = self._call_shards(idx, shards)
        # Fast path: the narrowing bit-plane walk runs ONCE over stacked
        # [D, S, W] planes (globally — identical result to the per-shard
        # merge) instead of once per shard.
        op_name = "Max" if is_max else "Min"
        filter_call = self._agg_filter_call(idx, call)
        kernels = {"minmax": 1}
        if filter_call is not None:
            kernels["filter"] = 1
        dec = self._adaptive_decide(
            op_name, idx, filter_call, shard_list, kernels,
            extra_missing_bytes=self._bsi_missing_bytes(
                idx, field, shard_list))
        fast = None if self._fallback_chosen(dec) \
            else self._stacked.try_minmax(idx, field, filter_call,
                                          shard_list, is_max)
        if fast is not None:
            self._note_strategy(op_name, "stacked-minmax",
                                **self._chosen_detail(dec))
            mag, count = fast
            if mag is None:
                return ValCount()
            return ValCount(mag + field.options.base, count)
        self._note_strategy(op_name, "per-shard",
                            **self._chosen_detail(dec))
        # Ordered reduce: larger/smaller tie-breaking is order-sensitive,
        # so the pool's shard-order reduction is what keeps every worker
        # count bit-identical to the serial loop.
        return shard_map_reduce(
            shard_list,
            lambda shard: self._minmax_shard(field, idx, call, shard, is_max),
            reducer=lambda out, vc: out.larger(vc) if is_max
            else out.smaller(vc),
            initial=ValCount())

    def _exec_min_row(self, idx, call, shards, opt):
        """(reference: executeMinRow executor.go:380 + fragment.minRow)"""
        return self._minmax_row(idx, call, shards, is_max=False)

    def _exec_max_row(self, idx, call, shards, opt):
        return self._minmax_row(idx, call, shards, is_max=True)

    def _minmax_row(self, idx, call, shards, is_max):
        """Pair(row, count) of the lowest (highest) row of the field whose
        count under the optional filter is non-zero, its count summed over
        every shard; Pair(0, 0) when there is none. Over two or more
        shards the field's rows are walked in direction order one K3
        chunk at a time, stopping at the first chunk with a non-zero
        count; fewer shards, or a filter the stacked path can't express,
        scan shard by shard as the TPU package does. Both give the TPU
        package's merge: the extreme row non-empty in some shard, summed
        over the shards where it is non-empty."""
        from .stacked import MIN_SHARDS

        field = self._set_field(idx, call)
        filter_call = self._agg_filter_call(idx, call)
        shard_list = self._call_shards(idx, shards)
        if len(shard_list) >= MIN_SHARDS:
            best = self._minmax_row_stacked(idx, field, filter_call,
                                            tuple(shard_list), is_max)
            if best is not None:
                return best

        def shard_best(shard):
            """This shard's first non-empty row in direction order."""
            view = field.view(VIEW_STANDARD)
            frag = view.fragment(shard) if view else None
            if frag is None:
                return None
            filt = None
            if filter_call is not None:
                filt = self.bitmap_call_shard(idx, filter_call, shard)
                if filt is None:
                    return None
            for row_id in (reversed(frag.row_ids()) if is_max
                           else frag.row_ids()):
                plane = bitplane.to_device(frag.row_plane(row_id),
                                           self.device)
                if filt is not None:
                    plane = bitplane.intersect(plane, filt)
                cnt = int(bitplane.popcount(plane))
                if cnt > 0:
                    return (row_id, cnt)
            return None

        def merge(best, cand):
            if cand is None:
                return best
            row_id, cnt = cand
            if best is None or (is_max and row_id > best[0]) or \
                    (not is_max and row_id < best[0]):
                return (row_id, cnt)
            if row_id == best[0]:
                return (row_id, best[1] + cnt)
            return best

        best = shard_map_reduce(shard_list, shard_best, reducer=merge)
        if best is None:
            return Pair(0, 0)
        return Pair(best[0], best[1])

    def _minmax_row_stacked(self, idx, field, filter_call, shards, is_max):
        """The stacked MinRow/MaxRow walk, or None to fall back."""
        covered, filt = self._stacked.filter_stack(idx, filter_call, shards)
        if not covered:
            return None
        rows = self._candidate_rows(field, shards, None, False,
                                    VIEW_STANDARD)
        if is_max:
            rows.reverse()
        chunk_size = self._stacked.row_chunk_size(shards)
        for i in range(0, len(rows), chunk_size):
            chunk = rows[i:i + chunk_size]
            counts = self._stacked.row_counts(idx, field.name, chunk, filt,
                                              shards)
            if counts is None:
                return None
            for row_id in chunk:
                if counts[row_id] > 0:
                    return Pair(row_id, counts[row_id])
        return Pair(0, 0)

    def _set_field(self, idx, call):
        field_name = call.args.get("field") or call.args.get("_field")
        if field_name is None:
            field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        return field

    # ---------------------------------------------------------------- TopN

    def _exec_topn(self, idx, call, shards, opt):
        """TopN via exact device popcounts over cache-selected candidates.

        The reference approximates with per-fragment rank caches + heap
        merge (executor.go:930, fragment.top fragment.go:1570); here the
        cache bounds which row planes get stacked, then exact counts come
        from K3 launches (O(1) in shards on the stacked path). Cache-less
        fields fall back to an exact full-row scan.

        threshold / tanimotoThreshold follow executor.go:947-995 +
        fragment.top fragment.go:1570-1700: threshold drops rows whose
        (filtered) count is below it; tanimotoThreshold T (1-100, requires
        a source row) keeps rows where ceil(100·|row ∩ src| /
        (|row| + |src| - |row ∩ src|)) > T."""
        field = self._set_field(idx, call)
        if field.type == FIELD_TYPE_INT:
            raise ExecError(
                f'cannot compute TopN() on integer field: "{field.name}"')
        if len(call.children) > 1:
            raise ExecError("TopN() can only have one input bitmap")
        if call.children:
            self.validate_bitmap_call(idx, call.children[0])
        n = uint_arg_or_none(call, "n")
        ids = call.args.get("ids")
        if ids is not None and (
                not isinstance(ids, list)
                or any(isinstance(r, bool) or not isinstance(r, int)
                       for r in ids)):
            # (reference: validateCallArgs executor.go:342-358)
            raise ExecError(f"invalid call.Args[ids]: {ids!r}")
        thr = uint_arg_or_none(call, "threshold")
        threshold = 1 if thr is None else thr
        tanimoto, _ = uint_arg(call, "tanimotoThreshold")
        if tanimoto > 100:  # negatives already rejected by uint_arg
            raise ExecError("Tanimoto Threshold is from 1 to 100 only")
        if tanimoto > 0 and not call.children:
            raise ExecError(
                "TopN(): tanimotoThreshold requires a source row query")
        counts = self._row_counts(idx, field, call, shards,
                                  restrict_ids=ids, use_cache=ids is None)
        # row-attribute filter (reference: attrName/attrValues
        # executor.go:982-1005)
        attr_name = call.args.get("attrName")
        if attr_name is not None and field.row_attr_store is not None:
            attr_values = call.args.get("attrValues")
            if not isinstance(attr_values, list):
                raise ExecError("TopN(): attrValues must be a list")
            counts = {
                r: c for r, c in counts.items()
                if field.row_attr_store.attrs(r).get(attr_name) in attr_values
            }
        src = call.children[0] if call.children else None
        # tanimoto needs each row's UNFILTERED cardinality and the source
        # row's count; both come from host container cardinalities / the
        # count fast path — no extra per-shard device work.
        if tanimoto > 0 and src is not None:
            shard_list = self._call_shards(idx, shards)
            plain = self._plain_row_counts(field, counts, shard_list)
            src_count = self._count_of(idx, src, shard_list)
            kept = {}
            for row_id, cnt in counts.items():
                if cnt <= 0:
                    continue
                denom = plain[row_id] + src_count - cnt
                coeff = math.ceil(cnt * 100 / denom) if denom else 100
                if coeff > tanimoto:
                    kept[row_id] = cnt
            counts = kept
        # threshold and tanimoto are either/or (fragment.top:1610-1620).
        min_count = 1 if (tanimoto > 0 and src is not None) \
            else max(threshold, 1)
        pairs = [Pair(row_id, cnt) for row_id, cnt in counts.items()
                 if cnt >= min_count]
        pairs.sort(key=lambda p: (-p.count, p.id))
        # remote shards return untrimmed pairs so the coordinator's merge
        # stays exact (reference: executeTopN trims only when !opt.Remote)
        if n is not None and ids is None and not opt.remote:
            pairs = pairs[:int(n)]
        return pairs

    def _plain_row_counts(self, field, row_ids, shard_list):
        """row -> UNFILTERED global cardinality, from host container
        cardinalities (no device work; reference: fragment.rowCount)."""
        totals = {int(r): 0 for r in row_ids}
        view = field.view(VIEW_STANDARD)
        if view is None:
            return totals
        keys = list(totals)

        def shard_counts(shard):
            frag = view.fragment(shard)
            if frag is None:
                return None
            return [frag.row_count(r) for r in keys]

        for counts in shard_map_reduce(shard_list, shard_counts):
            if counts is None:
                continue
            for r, c in zip(keys, counts):
                totals[r] += c
        return totals

    def _count_of(self, idx, call, shard_list):
        """Count of a bitmap call over shards (K1 on the stacked path,
        else a per-shard popcount sum)."""
        fast = self._stacked.try_count(idx, call, shard_list)
        if fast is not None:
            return fast

        def count_one(shard):
            plane = self.bitmap_call_shard(idx, call, shard)
            if plane is None:
                return 0
            return int(bitplane.popcount(plane))

        return shard_map_reduce(
            shard_list, count_one,
            reducer=lambda acc, c: acc + c, initial=0)

    def _candidate_rows(self, field, shard_list, restrict_ids, use_cache,
                        view_name):
        """Global candidate row set: union over fragments of their TopN
        cache ids (when populated) or all present rows."""
        view = field.view(view_name)
        if view is None:
            return []

        def shard_rows(shard):
            frag = view.fragment(shard)
            if frag is None:
                return None
            return fragment_topn_candidates(frag, use_cache)

        rows = set()
        for cand in shard_map_reduce(shard_list, shard_rows):
            if cand is not None:
                rows.update(cand)
        if restrict_ids is not None:
            wanted = {int(r) for r in restrict_ids}
            rows &= wanted
        return sorted(rows)

    def _row_counts(self, idx, field, call, shards, restrict_ids=None,
                    view_name=VIEW_STANDARD, use_cache=False):
        """row -> total count across shards, optionally intersected with the
        call's first child as filter. With use_cache, candidate rows come
        from the fragment's TopN cache when one is populated (the
        reference's approximation: only cached rows compete).

        Fast path: candidate rows stack into [R, S, W] chunks and ALL
        shards count in O(rows/chunk) launches of K3 — independent of the
        shard count. Falls back per-shard when the filter tree isn't
        stack-coverable (conditions, time ranges, ...) or the query names
        fewer than MIN_SHARDS shards."""
        from .stacked import MIN_SHARDS

        shard_list = self._call_shards(idx, shards)
        filter_call = call.children[0] \
            if (call is not None and call.children) else None

        dec = None
        if len(shard_list) >= MIN_SHARDS:
            covered, filt = self._stacked.filter_stack(
                idx, filter_call, tuple(shard_list))
            if covered:
                candidates = self._candidate_rows(
                    field, shard_list, restrict_ids, use_cache, view_name)
                dec = self._row_counts_decision(
                    idx, field, call, candidates, filter_call,
                    shard_list, view_name)
                totals = None if self._fallback_chosen(dec) \
                    else self._stacked.row_counts(
                        idx, field.name, candidates, filt, shard_list,
                        view_name)
                if totals is not None:
                    if call is not None:
                        self._note_strategy(call.name,
                                            "stacked-row-counts",
                                            **self._chosen_detail(dec))
                    if restrict_ids is not None:
                        for r in restrict_ids:
                            totals.setdefault(int(r), 0)
                    return totals
        if call is not None:
            self._note_strategy(call.name, "per-shard-chunked",
                                **self._chosen_detail(dec))

        # Fallback: per-shard chunks, but over the SAME global candidate
        # set as the fast path (union across fragments), so both paths
        # return identical counts for identical data.
        candidates = self._candidate_rows(
            field, shard_list, restrict_ids, use_cache, view_name)
        totals = {}

        def shard_chunks(shard):
            """Per-shard chunked K3 counts (single-device launches; safe
            to issue concurrently from pool workers)."""
            view = field.view(view_name)
            frag = view.fragment(shard) if view else None
            if frag is None:
                return []
            filt = None
            if filter_call is not None:
                filt = self.bitmap_call_shard(idx, filter_call, shard)
                if filt is None:
                    return []  # empty filter -> zero counts in this shard
            present = set(frag.row_ids())
            row_ids = [r for r in candidates if r in present]
            out = []
            for i in range(0, len(row_ids), _TOPN_STACK_CHUNK):
                chunk = row_ids[i:i + _TOPN_STACK_CHUNK]
                stack = self._fragment_rows(frag, chunk)
                out.append((chunk, _row_counts_kernel(stack, filt)))
            return out

        pending = [pc for per_shard in
                   shard_map_reduce(shard_list, shard_chunks)
                   for pc in per_shard]
        for chunk, dev_counts in pending:
            for r, c in zip(chunk, dev_counts.cpu().tolist()):
                totals[r] = totals.get(r, 0) + c
        if restrict_ids is not None:
            for r in restrict_ids:
                totals.setdefault(int(r), 0)
        return totals

    def _fragment_rows(self, frag, row_ids):
        """[R, W] device stack of one fragment's rows (one upload)."""
        host = np.stack([frag.row_plane(r) for r in row_ids])
        return bitplane.to_device(host, self.device)

    # ---------------------------------------------------------------- Rows

    def _rows_views(self, field, call):
        """View names Rows() inspects: the standard view, or for a time
        field with from/to (or noStandardView) the minimal quantum-view
        cover of the range, clamped to the views that actually exist
        (reference: executeRowsShard executor.go:1338-1400 +
        minMaxViews/timeOfView time.go:240-340)."""
        if field.type != FIELD_TYPE_TIME:
            return [VIEW_STANDARD]
        from_t = timeq.parse_time(call.args["from"]) \
            if "from" in call.args else None
        to_t = timeq.parse_time(call.args["to"]) \
            if "to" in call.args else None
        if from_t is None and to_t is None \
                and not field.options.no_standard_view:
            return [VIEW_STANDARD]
        quantum = field.time_quantum()
        if not quantum:
            return []
        vmin, vmax = timeq.min_max_views(
            list(field.views), quantum, VIEW_STANDARD)
        if vmin is None:
            return []
        min_t = timeq.time_of_view(vmin, VIEW_STANDARD)
        max_t = timeq.time_of_view(vmax, VIEW_STANDARD, adj=True)
        if from_t is None or from_t < min_t:
            from_t = min_t
        if to_t is None or to_t > max_t:
            to_t = max_t
        return timeq.views_by_time_range(
            VIEW_STANDARD, from_t, to_t, quantum)

    def _exec_rows(self, idx, call, shards, opt):
        """(reference: executeRows executor.go:1280)"""
        field = self._set_field(idx, call)
        limit = uint_arg_or_none(call, "limit")
        previous = uint_arg_or_none(call, "previous")
        column = uint_arg_or_none(call, "column")

        rows = set()
        shard_list = self._call_shards(idx, shards)
        for view_name in self._rows_views(field, call):
            view = field.view(view_name)
            if view is None:
                continue

            def shard_rows(shard, view=view):
                frag = view.fragment(shard)
                if frag is None:
                    return None
                if column is not None:
                    if column // SHARD_WIDTH != shard:
                        return None
                    return {r for r in frag.row_ids()
                            if frag.contains(r, column)}
                return set(frag.row_ids())

            for found in shard_map_reduce(shard_list, shard_rows):
                if found is not None:
                    rows.update(found)
        out = sorted(rows)
        if previous is not None:
            out = [r for r in out if r > previous]
        if limit is not None and not opt.remote:
            out = out[:limit]
        return RowIdentifiers(rows=out)

    # -------------------------------------------------------------- GroupBy

    def _exec_group_by(self, idx, call, shards, opt):
        """(reference: executeGroupBy executor.go:1098)"""
        if not call.children:
            raise ExecError("GroupBy requires at least one Rows() child")
        for child in call.children:
            if child.name != "Rows":
                raise ExecError("GroupBy children must be Rows() calls")
        limit = uint_arg_or_none(call, "limit")
        offset = uint_arg_or_none(call, "offset")
        previous = groupby_previous(call, len(call.children))
        filter_call = call.args.get("filter")
        if filter_call is not None:
            if not isinstance(filter_call, Call):
                raise ExecError("GroupBy filter must be a row query")
            self.validate_bitmap_call(idx, filter_call)

        fields = [self._set_field(idx, child) for child in call.children]
        shard_list = self._call_shards(idx, shards)

        # Child Rows() limit/previous/column apply to the GLOBAL merged row
        # set (exactly Rows() semantics, reused).
        child_rows = [
            self._exec_rows(idx, child, shards, opt).rows
            for child in call.children
        ]
        if previous is not None:
            # Seed the outermost child's row start (the reference seeks
            # each row iterator, executor.go:1403-1406; later iterators
            # cycle back to their full row sets, so only the outermost —
            # which never wraps — prunes soundly). Groups at or before
            # the cursor are dropped lexicographically below.
            lo = previous[0] + (1 if len(child_rows) == 1 else 0)
            child_rows[0] = [r for r in child_rows[0] if r >= lo]

        dec, tile_dec, tile = self._group_by_decision(
            idx, fields, child_rows, filter_call, shard_list)
        totals = None if self._fallback_chosen(dec) \
            else self._group_by_stacked(
                idx, fields, child_rows, filter_call, shard_list,
                tile=tile)
        if totals is None:
            self._note_strategy("GroupBy", "per-shard",
                                **self._chosen_detail(dec))
            totals = self._group_by_per_shard(
                idx, fields, child_rows, filter_call, shard_list)
        elif len(fields) == 1:
            self._note_strategy("GroupBy", "stacked-row-counts",
                                **self._chosen_detail(dec))
        else:
            shown = tile if tile is not None \
                else self._stacked.row_chunk_size(tuple(shard_list))
            detail = self._chosen_detail(dec)
            if tile_dec is not None:
                detail["tile_chosen_by"] = tile_dec.chosen_by
            self._note_strategy("GroupBy", "stacked-pairwise",
                                tile=[shown, shown], **detail)
        if previous is not None:
            prev_t = tuple(previous)
            totals = {g: c for g, c in totals.items() if g > prev_t}

        out = [
            GroupCount(
                [FieldRow(f.name, rid) for f, rid in zip(fields, group)],
                cnt)
            for group, cnt in sorted(totals.items())
        ]
        if limit is not None and not opt.remote:
            out = out[:limit]
        # offset applies after the limit-bounded merge, and is a NO-OP
        # when it reaches past the result set (reference guards
        # `offset < len(results)`: executeGroupBy executor.go:1134-1143)
        if offset is not None and not opt.remote and offset < len(out):
            out = out[offset:]
        return out

    def _group_by_decision(self, idx, fields, child_rows, filter_call,
                           shard_list):
        """(strategy decision, tile decision, tile override) for one
        GroupBy — the planner's _plan_group_by kernel map. The tile
        override is None unless the engine is acting AND chose a
        non-static shape."""
        if not adaptive_mod.enabled():
            return None, None, None
        st = tuple(shard_list)
        chunk = self._stacked.row_chunk_size(st)
        plane = self._stacked._padded_len(st) * WORDS_PER_ROW * 4
        # the planner prices cold row-chunk uploads the same way
        # (_plan_group_by's _missing_row_chunks loop) — keep the two
        # sides' est_stacked in agreement
        missing = 0
        for field, rows in zip(fields, child_rows):
            for i in range(0, len(rows), chunk):
                part = tuple(rows[i:i + chunk])
                if not self._stacked.rows_chunk_resident(
                        idx, field.name, part, st, VIEW_STANDARD):
                    missing += len(part) * plane
        if len(fields) == 1:
            n = -(-len(child_rows[0]) // chunk) if child_rows[0] else 0
            dec = self._adaptive_decide(
                "GroupBy", idx, filter_call, shard_list,
                {"row_counts": n} if n else {},
                extra_missing_bytes=missing)
            return dec, None, None
        a_rows, b_rows = child_rows[-2], child_rows[-1]
        outer = 1
        for rows in child_rows[:-2]:
            outer *= max(1, len(rows))
        tile_dec = adaptive_mod.decide_tile(
            chunk, len(a_rows), len(b_rows), outer=outer) \
            if a_rows and b_rows else None
        tile = tile_dec.tile if (tile_dec is not None and tile_dec.act
                                 and tile_dec.tile != chunk) else None
        t = tile if tile is not None else chunk
        pairwise = (-(-len(a_rows) // t)) * (-(-len(b_rows) // t)) \
            * outer if a_rows and b_rows else 0
        dec = self._adaptive_decide(
            "GroupBy", idx, filter_call, shard_list,
            {"pairwise": pairwise} if pairwise else {},
            extra_missing_bytes=missing)
        return dec, tile_dec, tile

    def _group_by_stacked(self, idx, fields, child_rows, filter_call,
                          shard_list, tile=None):
        """Thin layer over the stacked kernels: the innermost TWO levels
        are one tiled cross-product count matrix
        (StackedEvaluator.pairwise_counts — one K4 launch and one host
        fetch per tile pair, at `tile` when the adaptive engine chose
        one); outer levels walk row combinations as
        [S, W] device intersections in chunks; a single-field GroupBy
        counts its rows with K3. Returns None to fall back (too few
        shards, a filter the stacked path can't express, or a field/view
        vanishing mid-query)."""
        from .stacked import MIN_SHARDS

        if len(shard_list) < MIN_SHARDS:
            return None
        shards = tuple(shard_list)
        covered, filt = self._stacked.filter_stack(idx, filter_call, shards)
        if not covered:
            return None

        if len(fields) == 1:
            counts = self._stacked.row_counts(
                idx, fields[0].name, child_rows[0], filt, shards)
            if counts is None:
                return None
            return {(r,): c for r, c in counts.items() if c > 0}

        totals = {}
        a_field, b_field = fields[-2], fields[-1]
        a_rows, b_rows = child_rows[-2], child_rows[-1]
        chunk_size = self._stacked.row_chunk_size(shards)

        def recurse(level, plane, prefix):
            """plane: accumulated [S, W] restriction (None = everything).
            Returns False to abort (stack construction failed; caller
            falls back to the per-shard path)."""
            if level == len(fields) - 2:
                groups = self._stacked.pairwise_counts(
                    idx, a_field.name, a_rows, b_field.name, b_rows,
                    plane, shards, tile=tile)
                if groups is None:
                    return False
                for pair, c in groups.items():
                    key = prefix + pair
                    totals[key] = totals.get(key, 0) + c
                return True
            # Outer-level row planes come from the rows pool in chunks (not
            # the leaf pool: a wide outer field must not evict the hot
            # Count stacks), sliced per combination.
            rows = child_rows[level]
            for i in range(0, len(rows), chunk_size):
                chunk = tuple(rows[i:i + chunk_size])
                stack = self._stacked.rows_stack(
                    idx, fields[level].name, chunk, shards)
                if stack is None:
                    return False
                for j, row_id in enumerate(chunk):
                    combined = stack[j] if plane is None \
                        else plane & stack[j]
                    if not recurse(level + 1, combined, prefix + (row_id,)):
                        return False
            return True

        if not recurse(0, filt, ()):
            return None
        return totals

    def _group_by_per_shard(self, idx, fields, child_rows, filter_call,
                            shard_list):
        def shard_totals(shard):
            """This shard's group -> count map (device intersect chains +
            one host fetch; independent across shards)."""
            frag_rows = []
            for field, rows in zip(fields, child_rows):
                view = field.view(VIEW_STANDARD)
                frag = view.fragment(shard) if view else None
                if frag is None:
                    return None
                present = set(frag.row_ids())
                frag_rows.append((frag, [r for r in rows if r in present]))
            filt = None
            if filter_call is not None:
                filt = self.bitmap_call_shard(idx, filter_call, shard)
                if filt is None:
                    return None

            # depth-first cross product
            pending = []

            def recurse(level, plane, prefix):
                frag, row_ids = frag_rows[level]
                for row_id in row_ids:
                    p = bitplane.to_device(frag.row_plane(row_id),
                                           self.device)
                    combined = p if plane is None \
                        else bitplane.intersect(plane, p)
                    if level + 1 == len(frag_rows):
                        pending.append((prefix + (row_id,),
                                        bitplane.popcount(combined)))
                    else:
                        recurse(level + 1, combined, prefix + (row_id,))

            recurse(0, filt, ())
            out = {}
            if pending:
                groups, dev_counts = zip(*pending)
                host = torch.stack(list(dev_counts)).cpu().tolist()
                for group, c in zip(groups, host):
                    if c > 0:
                        out[group] = out.get(group, 0) + c
            return out

        totals = {}
        for shard_counts in shard_map_reduce(shard_list, shard_totals):
            if not shard_counts:
                continue
            for group, c in shard_counts.items():
                totals[group] = totals.get(group, 0) + c
        return totals

    # -------------------------------------------------------------- Options

    def _exec_options(self, idx, call, shards, opt):
        """(reference: executeOptionsCall executor.go:244)"""
        inner, new_opt, shards = unwrap_options(call, opt, shards)
        return self.execute_call(idx, inner, shards, new_opt)

    # ---------------------------------------------------------------- writes

    def _exec_set(self, idx, call, shards, opt):
        """(reference: executeSet executor.go:2067)"""
        col = self._require_col(call)
        field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        value = call.args[field_name]

        if field.type == FIELD_TYPE_INT:
            if not isinstance(value, int) or isinstance(value, bool):
                raise ExecError("Set(): int field requires an integer value")
            changed = field.set_value(col, value)
        else:
            timestamp = None
            if "_timestamp" in call.args:
                timestamp = timeq.parse_time(call.args["_timestamp"])
            if isinstance(value, bool):
                row_id = 1 if value else 0
            elif isinstance(value, int):
                row_id = value
            else:
                raise ExecError(
                    f"Set(): row must be an integer or key: {value!r}")
            changed = field.set_bit(row_id, col, timestamp=timestamp)
        idx.add_existence([col])
        return bool(changed)

    def _exec_clear(self, idx, call, shards, opt):
        col = self._require_col(call)
        field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        value = call.args[field_name]
        if field.type == FIELD_TYPE_INT:
            return bool(field.clear_value(col))
        if isinstance(value, bool):
            row_id = 1 if value else 0
        else:
            row_id = int(value)
        return bool(field.clear_bit(row_id, col))

    def _exec_clear_row(self, idx, call, shards, opt):
        """(reference: executeClearRow executor.go:1825)"""
        field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            raise FieldNotFound(f"field not found: {field_name}")
        row_id = int(call.args[field_name])
        zeros = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
        changed = False
        shard_list = self._call_shards(idx, shards)
        # every non-BSI view, so time views stay consistent with the
        # standard view (reference: executeClearRowShard walks f.views())
        for view_name, view in list(field.views.items()):
            if view_name.startswith("bsig_"):
                continue

            def clear_shard(shard, view=view):
                frag = view.fragment(shard)
                if frag is None:
                    return False
                return bool(frag.set_row_plane(row_id, zeros))

            changed |= any(shard_map_reduce(shard_list, clear_shard))
        return changed

    def _exec_store(self, idx, call, shards, opt):
        """(reference: executeSetRow executor.go:1900) Store(child, f=row):
        the child evaluated over every shard, then written shard by shard
        in shard order (the fragment dict of the view must not race)."""
        if len(call.children) != 1:
            raise ExecError("Store() takes exactly one row query")
        field_name = call.field_arg()
        field = idx.field(field_name)
        if field is None:
            # the reference creates the field on demand for Store
            field = idx.create_field(field_name, FieldOptions())
        row_id = int(call.args[field_name])
        view = field.create_view_if_not_exists(VIEW_STANDARD)
        shard_list = self._call_shards(idx, shards)
        planes = self._store_planes(idx, call.children[0], shard_list)
        changed = False
        for shard, host in zip(shard_list, planes):
            frag = view.create_fragment_if_not_exists(shard)
            changed |= bool(frag.set_row_plane(row_id, host))
        return changed

    def _store_planes(self, idx, child, shard_list):
        """Host uint32 plane of `child` per shard of `shard_list`: over two
        or more shards ONE [S, W] evaluation (filter_stack) and ONE copy
        to the host; otherwise shard by shard."""
        from .stacked import MIN_SHARDS

        if len(shard_list) >= MIN_SHARDS:
            covered, stack = self._stacked.filter_stack(
                idx, child, tuple(shard_list))
            if covered:
                # a copy: on the CPU the fetch may alias a cached leaf
                return np.array(self._stacked.host_planes(stack))

        def gather_shard(shard):
            plane = self.bitmap_call_shard(idx, child, shard)
            return (np.zeros(WORDS_PER_ROW, dtype=np.uint32)
                    if plane is None else bitplane.to_host(plane))

        return shard_map_reduce(shard_list, gather_shard)

    def _exec_set_row_attrs(self, idx, call, shards, opt):
        field = idx.field(call.args["_field"])
        if field is None:
            raise FieldNotFound(f"field not found: {call.args['_field']}")
        if field.row_attr_store is None:
            raise ExecError("row attributes not configured")
        row_id = int(call.args["_row"])
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        field.row_attr_store.set_attrs(row_id, attrs)
        return None

    def _exec_set_column_attrs(self, idx, call, shards, opt):
        if idx.column_attr_store is None:
            raise ExecError("column attributes not configured")
        col = self._require_col(call)
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        idx.column_attr_store.set_attrs(col, attrs)
        return None

    def _require_col(self, call):
        col = call.args.get("_col")
        if col is None:
            raise ExecError(f"{call.name}() requires a column argument")
        if not isinstance(col, int) or isinstance(col, bool):
            raise ExecError(f"column must be an integer or key: {col!r}")
        return col

