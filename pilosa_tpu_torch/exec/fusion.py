"""Whole-plan fusion: an entire multi-call PQL query served as ONE
device dispatch, its program cached by workload fingerprint (the TPU
package's exec/fusion.py).

Without fusion each top-level Count of a query is its own launch, its own
dispatch-lock hold and its own fetch. An eligible query (every top-level
call a Count over a stack-coverable tree, two or more shards) instead
runs `StackedEvaluator.fused_count`: one locked dispatch in which every
call that ends in K1 rides ONE launch of K1's multi-tree entry
(ops/count_expr.py `count_expr_multi`) and the others (K2's block-sparse
counts, the run-length sums) their own count programs, then one fetch of
every total. Dense, sparse, run-length and overlay-carrying leaves sit
side by side, each call keeping the route `count_program` would take, so
the answers are the interpreted loop's exactly.

Program identity is the workload fingerprint (the literal-free query
shape hash) refined by what it cannot see: the gathered containers'
gsig (repr kind + component shapes) and the shard count. The "program"
is the multi entry's program table (per member its postfix code and
descriptor), built on the host and copied to the device by the first
dispatch on a key; the port compiles nothing at run time, so that first
dispatch is what the TPU package times as its trace + compile
(`compile_ms`, the `compile` dispatch phase). The table lives in the
evaluator's `_fn_specs` under the key `fused_count` returns, so this
module's LRU eviction drops it.

Admission is frequency-gated: a COLD fingerprint never builds a program.
The workload table's per-fingerprint query count is the signal — only a
shape seen >= --fusion-min-hits times (or one whose program is already
cached) may fuse. When the adaptive engine is enabled it additionally
prices compile-amortized fused cost against the interpreted dispatch
count and may veto (`decide_fuse`); in shadow mode it logs the verdict
and vetoes nothing.

Escape hatch: --fusion off|on|shadow. `off` (the default) keeps every
interpreted code path as it was — the executor hook is one attribute
read. `shadow` counts what WOULD have fused but builds nothing and
touches no cache. Module-singleton state with configure()/reset(), like
exec/adaptive.py. A failure of the card itself (a kernel wrapper's
failed launch, a CUDA error) propagates out of the query; anything else
the fused path trips over (an ineligible shape, a vanished field, a
validation error) falls back to the interpreted loop, which reports it
as usual. A cluster coordinator's fused COLLECTIVE step
(cluster/spmd.py `maybe_execute_fused`) is ledgered here too, under the
mesh-shaped key `mesh_program_key` gives; its program table lives in the
data plane's `_fn_specs`, so the same LRU drops it.
"""

import threading
import time
from collections import OrderedDict

from ..utils import flightrec as _flightrec
from ..utils.stats import global_stats

MODES = ("off", "on", "shadow")

#: bounded program-ledger size: entries are bookkeeping (the program
#: tables themselves live in StackedEvaluator._fn_specs), but unbounded
#: fingerprints would leak under a shape-churning client
DEFAULT_CACHE_SIZE = 64

#: a fingerprint must have completed this many queries before its first
#: program build — the compile-admission floor (cold shapes never build)
DEFAULT_MIN_HITS = 2

_lock = threading.Lock()
_mode = "off"
_cache_size = DEFAULT_CACHE_SIZE
_min_hits = DEFAULT_MIN_HITS

#: (fingerprint, gsigs, bucket) -> entry dict; ordered = LRU
_programs = OrderedDict()
#: fingerprint -> set of live _programs keys (plan-path status probe)
_by_fp = {}

_counters = {
    "fused": 0,              # queries served by one fused dispatch
    "interpreted_cold": 0,   # vetoed: fingerprint below min-hits
    "interpreted_priced": 0,  # vetoed: adaptive priced interpret cheaper
    "ineligible": 0,         # shape/coverage can't fuse (interpreted)
    "shadow_would_fuse": 0,  # shadow: admission passed, nothing ran
    "evictions": 0,
}

_local = threading.local()


def configure(mode=None, cache_size=None, min_hits=None):
    """Apply --fusion / --fusion-cache-size / --fusion-min-hits."""
    global _mode, _cache_size, _min_hits
    if mode is not None:
        if mode not in MODES:
            raise ValueError(
                f"fusion mode must be one of {'|'.join(MODES)}: {mode!r}")
        with _lock:
            _mode = mode
    if cache_size is not None:
        with _lock:
            _cache_size = max(1, int(cache_size))
            _evict_over_budget()
    if min_hits is not None:
        with _lock:
            _min_hits = max(0, int(min_hits))


def mode():
    return _mode


def enabled():
    """True when the fused path observes (on OR shadow)."""
    return _mode != "off"


def acting():
    """True only when eligible queries actually run fused."""
    return _mode == "on"


def min_hits():
    return _min_hits


def reset():
    """Test isolation: back to cold defaults (mode off, empty cache)."""
    global _mode, _cache_size, _min_hits
    with _lock:
        _mode = "off"
        _cache_size = DEFAULT_CACHE_SIZE
        _min_hits = DEFAULT_MIN_HITS
        _programs.clear()
        _by_fp.clear()
        for k in _counters:
            _counters[k] = 0
    _local.fused = 0


def _bump(counter):
    with _lock:
        _counters[counter] += 1


# ------------------------------------------------- per-query attribution


def note_fused(n):
    """Stamp how many top-level calls the current thread's query fused
    (0 = interpreted). The executor resets it at query start; SLOW QUERY
    reads it after the query returns — same take-last handoff as
    stacked.note_batch_size."""
    _local.fused = int(n)


def last_fused():
    """Fused-call count of the last query on THIS thread (0 when it ran
    interpreted — also the pre-PR default, so log parsing stays total)."""
    return getattr(_local, "fused", 0)


# ------------------------------------------------------- program ledger


def _evict_over_budget():
    """Caller holds _lock. Trim the LRU past the configured bound; the
    program table itself is dropped from the evaluator's `_fn_specs` so
    an evicted program is rebuilt (and re-counted) on re-entry."""
    while len(_programs) > _cache_size:
        key, entry = _programs.popitem(last=False)
        _counters["evictions"] += 1
        keys = _by_fp.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                _by_fp.pop(key[0], None)
        ev = entry.get("evaluator")
        fn_key = entry.get("fn_key")
        if ev is not None and fn_key is not None:
            with ev._lock:
                ev._fn_specs.pop(fn_key, None)
        _flightrec.record("fusion.evict", fingerprint=key[0],
                          hits=entry["hits"],
                          compile_ms=entry["compile_ms"])


def has_program(fp):
    """True when any compiled program is live for this fingerprint —
    the plan path's cache-key status probe and the warm half of the
    admission gate (a cached program costs nothing to reuse, so the
    min-hits floor no longer applies)."""
    with _lock:
        return bool(_by_fp.get(fp))


def cache_status(fp):
    """"cached" | "uncompiled" for ?explain=true annotation."""
    return "cached" if has_program(fp) else "uncompiled"


def _touch_program(key, ev, fn_key, compile_ms=None):
    """Record one fused execution against `key`; returns True when the
    entry already existed (a program-cache hit)."""
    now = time.time()
    with _lock:
        entry = _programs.get(key)
        hit = entry is not None
        if entry is None:
            entry = _programs[key] = {
                "fingerprint": key[0], "gsigs": key[1], "bucket": key[2],
                "compile_ms": 0.0, "hits": 0, "created": now,
                "last_hit": now, "evaluator": ev, "fn_key": fn_key,
            }
            if len(key) > 3:
                entry["mesh"] = list(key[3])
            _by_fp.setdefault(key[0], set()).add(key)
            _evict_over_budget()
        else:
            _programs.move_to_end(key)
        entry["hits"] += 1
        entry["last_hit"] = now
        if compile_ms is not None:
            entry["compile_ms"] = round(compile_ms, 3)
    return hit


# ------------------------------------------------------- compile admission


def admit(fp):
    """Shared compile-admission verdict for a fingerprint: a live
    program, or enough completed queries to cross the min-hits floor.
    The collective fused path (cluster/spmd.maybe_execute_fused) applies
    the same cold-shape-never-builds rule as the local fused path."""
    from ..utils import workload as workload_mod

    if has_program(fp):
        return True
    return workload_mod.fingerprint_hits(fp) >= _min_hits


# ------------------------------------------------- mesh (collective) programs


def mesh_program_key(fp, sigs, bucket, mesh):
    """Ledger key for a fused COLLECTIVE program: the local key's
    (fingerprint, signatures, bucket) extended by the mesh shape
    ([ranks, devices per rank]) — the same fingerprint stepped over a
    different group is a different program."""
    return (fp, tuple(sigs), int(bucket), tuple(int(m) for m in mesh))


def touch_mesh_program(key, ev, fn_key, compile_ms=None):
    """Record one fused collective execution. `ev` follows the
    evaluator contract (`_lock` + `_fn_specs`): SpmdDataPlane qualifies,
    so eviction drops its program table exactly like a local program's.
    MUST be called after the data plane's step lock is released:
    eviction takes ev._lock (see _evict_over_budget).

    Returns True on a program-cache hit."""
    hit = _touch_program(key, ev, fn_key, compile_ms=compile_ms)
    if compile_ms is not None:
        _flightrec.record("fusion.compile", fingerprint=key[0],
                          calls=len(key[1]), bucket=key[2],
                          mesh=list(key[3]),
                          compile_ms=round(compile_ms, 3))
    _bump("fused")
    global_stats.count("fused_dispatches_total", 1)
    if hit:
        global_stats.count("fusion_cache_hits_total", 1)
    return hit


# ------------------------------------------------------------- execution


def _eligible_calls(query, opt):
    """The fused dispatch covers exactly the shapes the stacked count
    path covers: every top-level call must be Count(tree) — multi-call
    queries fuse into one dispatch with one [n_calls] int64 output.
    Returns the calls list or None. (explain=plan never executes at
    all; explain=analyze enters through the executor's fused-analyze
    wrapper, which grafts the single dispatch onto the plan nodes.)"""
    if opt.remote:
        return None
    calls = query.calls
    if not calls:
        return None
    for call in calls:
        if call.name != "Count" or len(call.children) != 1:
            return None
    return calls


def maybe_execute(executor, idx, query, shards, opt):
    """Try to serve the whole query as ONE fused device dispatch.
    Returns the per-call results list, or None → the caller runs the
    interpreted per-call loop (which also reproduces any validation
    error this path sidestepped). Raises only a failure of the card
    itself (a kernel wrapper's failed launch, a CUDA error): the
    interpreted loop would launch on the same card, and a card fault
    must reach the client, not be retried silently."""
    if _mode == "off":
        return None
    try:
        return _maybe_execute(executor, idx, query, shards, opt)
    except Exception as e:  # noqa: BLE001 — fall back, but not past the card
        from ..ops.cuda_build import is_device_failure

        if is_device_failure(e):
            raise
        return None


def _maybe_execute(executor, idx, query, shards, opt):
    from ..utils import workload as workload_mod
    from . import adaptive as adaptive_mod
    from .stacked import MIN_SHARDS

    calls = _eligible_calls(query, opt)
    if calls is None:
        _bump("ineligible")
        return None
    shard_list = tuple(executor._call_shards(idx, shards))
    if len(shard_list) < MIN_SHARDS:
        _bump("ineligible")
        return None

    # -- compile admission: the workload table's frequency ranking is
    # the signal. A fingerprint below the floor with no live program
    # runs interpreted — a cold shape NEVER pays a program build.
    fp = workload_mod.current_fingerprint()
    if fp is None:
        fp, _ = workload_mod.fingerprint(idx.name, query)
    cached = has_program(fp)
    fp_hits = workload_mod.fingerprint_hits(fp)
    if not cached and fp_hits < _min_hits:
        _bump("interpreted_cold")
        return None
    if adaptive_mod.enabled():
        dec = adaptive_mod.decide_fuse(
            len(calls), fp_hits, cached,
            stacked=executor._stacked)
        if dec is not None and dec.act and not dec.fuse:
            _bump("interpreted_priced")
            return None
    if _mode == "shadow":
        # admission passed: count what WOULD fuse, touch nothing —
        # shadow must have zero cache/program side effects
        _bump("shadow_would_fuse")
        return None

    # -- gather: same coverage walk as the per-call stacked path; any
    # non-coverable tree (or vanished field) sends the whole query back
    # to the interpreted loop so per-call fallback semantics are unchanged
    ev = executor._stacked
    plans, stacks_per_call, gsigs = [], [], []
    for call in calls:
        executor.validate_bitmap_call(idx, call.children[0])
        g = ev._gather(idx, call.children[0], shard_list)
        if g is None:
            _bump("ineligible")
            return None
        sig, stacks = g
        plans.append((sig, tuple(c.csig for c in stacks)))
        stacks_per_call.append(stacks)
        gsigs.append(tuple(c.gsig for c in stacks))
    bucket = ev._padded_len(shard_list)
    key = (fp, tuple(gsigs), bucket)

    t0 = time.perf_counter()
    counts, fn_key, compiled = ev.fused_count(
        tuple(plans), stacks_per_call)
    wall = time.perf_counter() - t0

    hit = _touch_program(key, ev, fn_key,
                         compile_ms=wall * 1000 if compiled else None)
    if compiled:
        _flightrec.record("fusion.compile", fingerprint=fp,
                          calls=len(calls), bucket=bucket,
                          compile_ms=round(wall * 1000, 3))
        # calibrate the adaptive engine's compile prior from reality
        adaptive_mod.observe_fuse_compile(wall)
    _bump("fused")
    global_stats.count("fused_dispatches_total", 1)
    if hit:
        global_stats.count("fusion_cache_hits_total", 1)
    note_fused(len(calls))
    workload_mod.note_batch(len(calls))
    program = "compile" if compiled else ("hit" if hit else "warm")
    per_call = wall / len(calls)
    for _ in calls:
        executor._note_strategy("Count", "fused", batch=len(calls),
                                program=program)
        global_stats.timing("query_op_seconds", per_call,
                            {"op": "Count"})
    return counts


# ------------------------------------------------------------- /debug view


def snapshot():
    """GET /debug/fusion: mode + knobs, the program ledger (per-entry
    fingerprint/compile-ms/hits/last-hit-age), and the fuse-vs-interpret
    decision counters."""
    now = time.time()
    with _lock:
        entries = [{
            "fingerprint": e["fingerprint"],
            "bucket": e["bucket"],
            "calls": len(e["gsigs"]),
            "compile_ms": e["compile_ms"],
            "hits": e["hits"],
            "age_seconds": round(now - e["created"], 1),
            "last_hit_age_seconds": round(now - e["last_hit"], 1),
            **({"mesh": e["mesh"]} if "mesh" in e else {}),
        } for e in _programs.values()]
        return {
            "mode": _mode,
            "cache_size": _cache_size,
            "min_hits": _min_hits,
            "entries": len(entries),
            "evictions": _counters["evictions"],
            "decisions": {k: v for k, v in _counters.items()
                          if k != "evictions"},
            "programs": entries[::-1],  # most-recently used first
        }


def decision_counts():
    """Flat counters for bench attempt tagging."""
    with _lock:
        return dict(_counters)
