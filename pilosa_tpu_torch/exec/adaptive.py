"""Adaptive execution engine: the consumer that closes the loop from the
observability stack (cost model, kernel timings, fragment heat, container
ledger) back into dispatch decisions.

Three decision surfaces, all priced through one calibration table:

1. **Strategy** — stacked vs per-shard-fallback for Count/Sum/Min/Max/
   TopN/GroupBy. The static gates (MIN_SHARDS + coverage) stay as hard
   eligibility; when they pass, the adaptive layer prices BOTH paths and
   may send an eligible query down the fallback anyway (a cold one-off
   over many missing fragments can be cheaper per-shard than paying the
   stack build). Decisions change *which path* runs, never *what answer*
   comes back — both paths are exact.
2. **Tiling** — the GroupBy pairwise [tile, tile] shape. Dispatch count
   falls with tile² while per-dispatch wall grows with tile²; the sweet
   spot moves with the dispatch RTT regime, so it is priced from
   per-tile EWMA observations instead of pinned at CHUNK_BYTES.
3. **Cache policy** — victim selection in both stack-cache pools moves
   from pure LRU to a heat×cost benefit score:

       benefit = heat × rebuild_seconds / resident_bytes

   (heat: the workload ledger's decayed access count; rebuild: fixed
   dispatch overhead + upload of the entry's *actual* resident bytes —
   compressed containers are cheaper to rebuild and score accordingly).
   The lowest-benefit entry is evicted — which may be the entry just
   admitted, i.e. the score doubles as an admission filter: a one-off
   export can no longer strip a hot TopN field's residency. A bounded
   *proactive* admission path (Executor.maybe_proactive_admit) pulls
   `hot_but_not_resident` fragments back in during idle dispatch-lock
   windows.

Calibration: per-kernel-family seconds come from the `kernel_seconds`
EWMA (utils/stats.py — recency-weighted, unlike the cumulative /metrics
histograms), seeded when no sample exists yet from the kernels' declared
costs (each wrapper's `*_cost` in ops/: bytes over the card's memory
rate, cached by GET /debug/kernels; the TPU package reads XLA's
cost_analysis there, and the source keeps its name "cost_analysis"),
with DEFAULT_DISPATCH_SECONDS as the cold-process floor. Fallback
(per-shard) costs are learned the same way from observed fallback walls.
/debug/plans misestimates feed back in two ways: a >factor wall deviation
re-injects the observed per-dispatch seconds into the family's EWMA
(`note_wall_misestimate`), and a repeated `container_repr` misestimate
forces the offending fragments dense at next rebuild
(ops/containers.py repr overrides).

Escape hatch: --adaptive off|on|shadow. `off` (the default) keeps every
legacy code path byte-for-byte — zero probes, zero scoring. `shadow`
computes, counts, and logs every decision but acts on none of them — the
A/B harness for the bench gates. Module-singleton state with
configure()/reset(), like exec/plan.py and utils/workload.py.
"""

import threading
import time

from ..utils.stats import global_stats

MODES = ("off", "on", "shadow")

#: cold-process per-dispatch floor (mirrors exec/plan.py's constant;
#: defined locally so plan can import adaptive without a cycle)
DEFAULT_DISPATCH_SECONDS = 2e-3

#: per-shard fallback op floor before any observation: one dispatch-ish
#: unit per shard, which reproduces the static gate's bias (stacked wins
#: at MIN_SHARDS+) until real fallback walls teach otherwise
DEFAULT_FALLBACK_SHARD_SECONDS = 2e-3

#: host→device upload pricing for cold-stack builds (~8 GB/s effective;
#: only relative scale matters — it prices missing bytes against
#: dispatch counts, and EWMA recalibration dominates once samples exist)
UPLOAD_SECONDS_PER_BYTE = 1.0 / (8 << 30)

#: fixed component of a rebuild (one dispatch round trip) in the cache
#: benefit score — keeps small-but-hot entries from scoring as free
REBUILD_FIXED_SECONDS = DEFAULT_DISPATCH_SECONDS

#: on-device bytes-touched pricing for incremental stack patches: the
#: scatter's functional update copies the whole resident stack at HBM
#: speed (~64 GB/s effective), which is ~8x cheaper per byte than the
#: host→device re-upload a rebuild pays — so the priced patch/rebuild
#: cutoff lands near 7/8 of the shards drifted, not the static half
DEVICE_TOUCH_SECONDS_PER_BYTE = 1.0 / (64 << 30)

#: proactive admission bounds per idle window: never more than this many
#: leaf builds / bytes in one round, so admission can't monopolize the
#: dispatch lock ahead of real queries
ADMIT_MAX_ROWS = 64
ADMIT_MAX_BYTES = 32 << 20

#: container_repr misestimate strikes before the fragment's next rebuild
#: is forced dense ("repeatedly", not a single noisy sample)
REPR_STRIKE_LIMIT = 2

#: recent-decision ring size for /debug/optimizer
DECISION_RING = 64

_lock = threading.Lock()
_mode = "off"
_forced_tile = None  # bench sweep override (decide_tile honors it)

# EWMA state the stats module doesn't own: per-op fallback per-shard
# seconds and per-tile pairwise per-dispatch seconds.
_EWMA_ALPHA = 0.2
_fallback = {}   # op -> [ewma_seconds_per_shard, samples]
_pairwise = {}   # tile -> [ewma_seconds_per_dispatch, samples]

# decision counters + recent ring (all guarded by _lock)
_strategy_counts = {}   # (op, strategy) -> count
_tile_counts = {}       # tile -> count
_recent = []            # bounded decision dicts, newest last
_cache_counters = {
    "benefit_evictions": 0,   # victims chosen by score (mode=on)
    "lru_evictions": 0,       # victims chosen by recency (off/shadow)
    "shadow_divergences": 0,  # shadow: score disagreed with LRU
}
_admission_counters = {
    "admitted_fragments": 0, "admitted_rows": 0, "admitted_bytes": 0,
    "shadow_candidates": 0, "rounds": 0,
}
_calibration_bumps = {}  # family -> count (wall-misestimate feedback)
_repr_strikes = {}       # (index, field) -> strikes
_patch_counts = {"patch": 0, "rebuild": 0}  # decide_patch outcomes


def configure(mode=None, forced_tile=None):
    """Apply --adaptive (off|on|shadow). `forced_tile` pins the GroupBy
    pairwise tile regardless of pricing — the bench sweep's hook."""
    global _mode, _forced_tile
    if mode is not None:
        if mode not in MODES:
            raise ValueError(
                f"adaptive mode must be one of {'|'.join(MODES)}: "
                f"{mode!r}")
        with _lock:
            _mode = mode
    if forced_tile is not None:
        with _lock:
            _forced_tile = int(forced_tile) if forced_tile else None


def set_forced_tile(tile):
    """Pin (or with None, unpin) the pairwise tile for sweeps."""
    global _forced_tile
    with _lock:
        _forced_tile = int(tile) if tile else None


def mode():
    return _mode


def enabled():
    """True when the engine observes and decides (on OR shadow)."""
    return _mode != "off"


def acting():
    """True only when decisions are allowed to change behavior."""
    return _mode == "on"


def reset():
    """Test isolation: back to cold defaults (mode off, no state)."""
    global _mode, _forced_tile
    with _lock:
        _mode = "off"
        _forced_tile = None
        _fallback.clear()
        _pairwise.clear()
        _fuse_compile.clear()
        _strategy_counts.clear()
        _tile_counts.clear()
        _recent.clear()
        for k in _cache_counters:
            _cache_counters[k] = 0
        for k in _admission_counters:
            _admission_counters[k] = 0
        _calibration_bumps.clear()
        _repr_strikes.clear()
        for k in _patch_counts:
            _patch_counts[k] = 0


# ------------------------------------------------------------- calibration


def _kernel_ewma():
    """{family: (seconds, samples)} from the kernel_seconds EWMA — the
    recency-weighted view stats.py keeps alongside the cumulative
    histograms (satellite: the cumulative mean can never forget a slow
    cold-start regime; this can)."""
    out = {}
    for (_, tags), (ewma, n) in \
            global_stats.timing_ewma("kernel_seconds").items():
        family = dict(tags).get("kernel")
        if family and n:
            out[family] = (ewma, n)
    return out


def _xla_seconds(stacked):
    """{family: optimal_seconds} from the kernels' declared costs ALREADY
    computed by a prior /debug/kernels request (same contract as the
    plan cost model); a CPU evaluator declares none."""
    if stacked is None:
        return {}
    out = {}
    try:
        with stacked._lock:
            costs = dict(stacked._kernel_costs)
    except Exception:  # pragma: no cover - observability only
        return {}
    for key, cost in costs.items():
        secs = (cost or {}).get("optimal_seconds")
        if isinstance(secs, (int, float)) and secs > 0:
            family = str(key[0])
            out[family] = max(out.get(family, 0.0), float(secs))
    return out


def dispatch_seconds(family, stacked=None, ewma=None, xla=None):
    """(seconds, source) for one dispatch of `family`. Source ranking:
    ewma (recent observed) > cost_analysis (cached declared costs) >
    default."""
    ewma = _kernel_ewma() if ewma is None else ewma
    e = ewma.get(family)
    if e is not None:
        return e[0], "ewma"
    xla = _xla_seconds(stacked) if xla is None else xla
    x = xla.get(family)
    if x:
        return x, "cost_analysis"
    return DEFAULT_DISPATCH_SECONDS, "default"


def fallback_seconds(op):
    """(per-shard seconds, source) of the per-shard fallback for `op`."""
    with _lock:
        e = _fallback.get(op)
        if e is not None and e[1]:
            return e[0], "ewma"
    return DEFAULT_FALLBACK_SHARD_SECONDS, "default"


def _ewma_update(table, key, value, alpha=_EWMA_ALPHA):
    e = table.get(key)
    if e is None:
        table[key] = [float(value), 1]
    else:
        e[0] += alpha * (float(value) - e[0])
        e[1] += 1


def observe_fallback(op, wall_seconds, n_shards):
    """Feed one observed per-shard fallback wall (any enabled mode —
    shadow learns too, that's what makes its decisions honest)."""
    if _mode == "off" or n_shards <= 0 or wall_seconds <= 0:
        return
    with _lock:
        _ewma_update(_fallback, op, wall_seconds / n_shards)


def observe_pairwise(tile, wall_seconds):
    """Feed one observed pairwise dispatch wall at nominal `tile`."""
    if _mode == "off" or wall_seconds <= 0:
        return
    with _lock:
        _ewma_update(_pairwise, int(tile), wall_seconds)


def note_wall_misestimate(kernels, actual_wall_seconds):
    """A strategy's kernel-wall estimate deviated past the misestimate
    factor: re-inject the OBSERVED per-dispatch seconds into each
    family's EWMA at full weight, so the next estimate starts from
    reality instead of repeating the drifted number."""
    if _mode == "off" or not kernels:
        return
    total = sum(kernels.values())
    if total <= 0 or actual_wall_seconds <= 0:
        return
    per_dispatch = actual_wall_seconds / total
    for family in kernels:
        global_stats.timing_ewma_force(
            "kernel_seconds", per_dispatch, {"kernel": family})
        with _lock:
            _calibration_bumps[family] = \
                _calibration_bumps.get(family, 0) + 1


def note_repr_misestimate(index, fields):
    """A plan's container_repr choice read MORE bytes than the dense
    scan it competed against. Strike each involved fragment; past
    REPR_STRIKE_LIMIT the fragment is forced dense at its next rebuild
    (shadow: strikes count, no override lands)."""
    if _mode == "off" or not index or not fields:
        return
    from ..ops import containers

    for field in fields:
        with _lock:
            k = (index, field)
            _repr_strikes[k] = _repr_strikes.get(k, 0) + 1
            strikes = _repr_strikes[k]
        if strikes >= REPR_STRIKE_LIMIT and _mode == "on":
            containers.set_repr_override(index, field, "dense")


# --------------------------------------------------------------- decisions


class Decision:
    """One priced strategy choice. `act` is False in shadow mode — the
    caller computes-and-logs but follows the static path."""

    __slots__ = ("op", "strategy", "act", "est_stacked", "est_fallback",
                 "source", "chosen_by")

    def __init__(self, op, strategy, act, est_stacked, est_fallback,
                 source):
        self.op = op
        self.strategy = strategy
        self.act = act
        self.est_stacked = est_stacked
        self.est_fallback = est_fallback
        self.source = source
        self.chosen_by = (
            f"cost-model (est stacked={est_stacked * 1000:.2f}ms vs "
            f"fallback={est_fallback * 1000:.2f}ms)")


def _record_decision(kind, detail):
    with _lock:
        _recent.append({"kind": kind, "ts": round(time.time(), 3),
                        **detail})
        del _recent[:-DECISION_RING]


def decide_strategy(op, kernels, n_shards, missing_bytes=0, stacked=None):
    """Price stacked (Σ family dispatches × calibrated seconds + cold
    upload) vs per-shard fallback (shards × learned per-shard seconds)
    for one ELIGIBLE query. Returns None when the engine is off; the
    static gates have already vetoed ineligible shapes before this is
    called. The same inputs produce the same decision on the plan path
    (exec/plan.py) and the execute path — that is the plan-vs-actual
    agreement contract."""
    if _mode == "off":
        return None
    ewma = _kernel_ewma()
    xla = _xla_seconds(stacked)
    est_stacked = missing_bytes * UPLOAD_SECONDS_PER_BYTE
    rank = {"ewma": 0, "cost_analysis": 1, "default": 2}
    worst = "ewma"
    for family, n in (kernels or {}).items():
        secs, src = dispatch_seconds(family, ewma=ewma, xla=xla)
        est_stacked += secs * n
        if rank[src] > rank[worst]:
            worst = src
    fb_secs, fb_src = fallback_seconds(op)
    est_fallback = n_shards * fb_secs
    if rank[fb_src] > rank[worst]:
        worst = fb_src
    strategy = "stacked" if est_stacked <= est_fallback else "fallback"
    dec = Decision(op, strategy, acting(), est_stacked, est_fallback,
                   worst)
    with _lock:
        k = (op, strategy)
        _strategy_counts[k] = _strategy_counts.get(k, 0) + 1
    _record_decision("strategy", {
        "op": op, "strategy": strategy, "acted": dec.act,
        "est_stacked_ms": round(est_stacked * 1000, 3),
        "est_fallback_ms": round(est_fallback * 1000, 3),
        "source": worst})
    return dec


class FuseDecision:
    """One priced fuse-vs-interpret choice (exec/fusion.py consults it
    AFTER the frequency gate has already admitted the fingerprint)."""

    __slots__ = ("fuse", "act", "est_fused", "est_interpret", "source",
                 "chosen_by")

    def __init__(self, fuse, act, est_fused, est_interpret, source):
        self.fuse = fuse
        self.act = act
        self.est_fused = est_fused
        self.est_interpret = est_interpret
        self.source = source
        self.chosen_by = (
            f"cost-model (est fused={est_fused * 1000:.2f}ms vs "
            f"interpret={est_interpret * 1000:.2f}ms)")


#: compile-cost prior for one fused trace before any observation:
#: trace+compile of a small count DAG is tens-of-ms-scale on every
#: backend we run; the fused_compile_ms EWMA replaces it after the
#: first real compile
DEFAULT_FUSE_COMPILE_SECONDS = 50e-3

_fuse_compile = {}  # single-key EWMA table: "compile" -> [seconds, n]


def observe_fuse_compile(wall_seconds):
    """Feed one observed fused trace+compile wall (any enabled mode)."""
    if _mode == "off" or wall_seconds <= 0:
        return
    with _lock:
        _ewma_update(_fuse_compile, "compile", wall_seconds)


def decide_fuse(n_calls, fp_hits, cached, stacked=None):
    """Price fused (one dispatch + compile amortized over the
    fingerprint's observed frequency) vs interpreted (one count
    dispatch per top-level call). `cached`: a live program means the
    compile is sunk and fused strictly dominates. Returns None when
    the engine is off — the fusion module then relies on its frequency
    gate alone."""
    if _mode == "off":
        return None
    per_dispatch, source = dispatch_seconds("count", stacked=stacked)
    est_interpret = n_calls * per_dispatch
    if cached:
        est_fused = per_dispatch
    else:
        with _lock:
            e = _fuse_compile.get("compile")
        compile_s = e[0] if e is not None and e[1] \
            else DEFAULT_FUSE_COMPILE_SECONDS
        # amortize the compile over the reuse the frequency ranking
        # predicts: a shape seen N times is priced as if it returns N
        # more times before churning out of the workload
        est_fused = per_dispatch + compile_s / max(1, fp_hits)
    fuse = est_fused <= est_interpret
    dec = FuseDecision(fuse, acting(), est_fused, est_interpret, source)
    with _lock:
        k = ("Fuse", "fused" if fuse else "interpret")
        _strategy_counts[k] = _strategy_counts.get(k, 0) + 1
    _record_decision("fuse", {
        "calls": n_calls, "fp_hits": fp_hits, "cached": cached,
        "fuse": fuse, "acted": dec.act,
        "est_fused_ms": round(est_fused * 1000, 3),
        "est_interpret_ms": round(est_interpret * 1000, 3),
        "source": source})
    return dec


def decide_patch(n_changed, n_shards, rows, plane_bytes):
    """Price the read-path patch-vs-rebuild cutoff for a stale cached
    stack with `n_changed` of `n_shards` drifted shard rows (`rows`
    planes of `plane_bytes` each per shard). Patch = one dispatch +
    upload only the drifted planes + the on-device copy of the whole
    stack the functional scatter pays; rebuild = one dispatch + re-upload
    of every plane. Returns True to patch. Only consulted when
    acting() — off/shadow keep exec/stacked's static half-the-shards
    rule, so the default path stays byte-identical."""
    row_bytes = rows * plane_bytes
    est_patch = (DEFAULT_DISPATCH_SECONDS
                 + n_changed * row_bytes * UPLOAD_SECONDS_PER_BYTE
                 + n_shards * row_bytes * DEVICE_TOUCH_SECONDS_PER_BYTE)
    est_rebuild = (REBUILD_FIXED_SECONDS
                   + n_shards * row_bytes * UPLOAD_SECONDS_PER_BYTE)
    patch = est_patch <= est_rebuild
    with _lock:
        _patch_counts["patch" if patch else "rebuild"] += 1
    _record_decision("patch", {
        "changed": n_changed, "shards": n_shards, "rows": rows,
        "patch": patch, "acted": True,
        "est_patch_ms": round(est_patch * 1000, 3),
        "est_rebuild_ms": round(est_rebuild * 1000, 3)})
    return patch


class TileDecision:
    __slots__ = ("tile", "act", "estimates", "source", "chosen_by")

    def __init__(self, tile, act, estimates, source, static_tile):
        self.tile = tile
        self.act = act
        self.estimates = estimates
        self.source = source
        self.chosen_by = (
            f"cost-model (tile {tile} est "
            f"{estimates.get(tile, 0.0) * 1000:.2f}ms; static "
            f"{static_tile} est "
            f"{estimates.get(static_tile, 0.0) * 1000:.2f}ms)")


def _pairwise_model():
    """(overhead_seconds, seconds_per_cell, source) fitted from the
    per-tile EWMA samples: per_dispatch(t) = overhead + t² × cell. With
    no samples the cell term is 0 — every candidate prices identically
    per-tile, the dispatch-count term dominates, and the largest
    (static) tile wins, reproducing the legacy choice."""
    overhead = DEFAULT_DISPATCH_SECONDS
    with _lock:
        samples = {t: e[0] for t, e in _pairwise.items() if e[1]}
    if not samples:
        return overhead, 0.0, "default"
    # the smallest sampled tile's wall is the best overhead estimate
    # available (its t² term is the smallest share of its wall)
    t_min = min(samples)
    overhead = min(overhead, samples[t_min])
    cells = [max(w - overhead, 0.0) / float(t * t)
             for t, w in samples.items() if t > 0]
    cell = sum(cells) / len(cells) if cells else 0.0
    return overhead, cell, "ewma"


def decide_tile(static_tile, n_a, n_b, outer=1):
    """Choose the pairwise [tile, tile] shape from {static, static/2,
    static/4, static/8} by total priced wall: tiles(t) × per_dispatch(t).
    Honors the bench sweep's forced tile. Returns None when off."""
    if _mode == "off":
        return None
    with _lock:
        forced = _forced_tile
    overhead, cell, source = _pairwise_model()
    candidates = sorted({max(1, static_tile >> s) for s in range(4)})
    estimates = {}
    for t in candidates:
        tiles = (-(-n_a // t)) * (-(-n_b // t)) * max(1, outer)
        # price the full [t, t] shape per dispatch — the kernel pads
        # ragged edges to it, which is exactly why an oversized static
        # tile loses on small row sets (1 padded dispatch costs t² cells
        # no matter how few rows are real)
        estimates[t] = tiles * (overhead + cell * t * t)
    if forced:
        best = forced
    else:
        best = min(sorted(estimates, reverse=True),
                   key=lambda t: estimates[t])
    dec = TileDecision(best, acting(), estimates, source, static_tile)
    with _lock:
        _tile_counts[best] = _tile_counts.get(best, 0) + 1
    _record_decision("tile", {
        "tile": best, "acted": dec.act, "forced": bool(forced),
        "estimates_ms": {t: round(s * 1000, 3)
                         for t, s in estimates.items()},
        "source": source})
    return dec


# ------------------------------------------------------------ cache policy


def cache_mode():
    """off|on|shadow for the stack-cache eviction sites — one read, so
    a concurrent configure() can't split a single eviction's checks."""
    return _mode


def benefit_score(heat, nbytes):
    """heat × rebuild_seconds / resident_bytes — the admission/eviction
    score. Lower = better victim. Compressed entries hold fewer bytes
    AND rebuild cheaper, so the two effects don't cancel: small hot
    entries dominate, large cold entries go first."""
    nbytes = max(int(nbytes), 1)
    rebuild = REBUILD_FIXED_SECONDS + nbytes * UPLOAD_SECONDS_PER_BYTE
    return heat * rebuild / nbytes


def select_victim(entries):
    """Victim key among [(key, heat, nbytes)] — the minimum benefit
    score; FIFO position breaks exact ties (entries arrive in LRU
    order, so degenerate inputs still evict like LRU)."""
    best_key, best_score = None, None
    for key, heat, nbytes in entries:
        score = benefit_score(heat, nbytes)
        if best_score is None or score < best_score:
            best_key, best_score = key, score
    return best_key


def note_eviction(policy, diverged=False):
    """Count one eviction by the policy that chose the victim."""
    with _lock:
        if policy == "benefit":
            _cache_counters["benefit_evictions"] += 1
        else:
            _cache_counters["lru_evictions"] += 1
            if diverged:
                _cache_counters["shadow_divergences"] += 1


# -------------------------------------------------------------- admission


def note_admission(index, field, rows, nbytes, shadow=False):
    with _lock:
        if shadow:
            _admission_counters["shadow_candidates"] += 1
            return
        _admission_counters["admitted_fragments"] += 1
        _admission_counters["admitted_rows"] += rows
        _admission_counters["admitted_bytes"] += nbytes


def note_admission_round():
    with _lock:
        _admission_counters["rounds"] += 1


# ------------------------------------------------------------- /debug view


def snapshot(stacked=None):
    """GET /debug/optimizer: mode, the calibration table with per-family
    sources, decision counters, cache/admission counters, calibration
    bumps, repr strikes, and the recent-decision ring."""
    ewma = _kernel_ewma()
    xla = _xla_seconds(stacked)
    families = sorted(set(ewma) | set(xla))
    calibration = {}
    for family in families:
        secs, src = dispatch_seconds(family, ewma=ewma, xla=xla)
        calibration[family] = {
            "seconds": round(secs, 6), "source": src,
            "samples": ewma.get(family, (0, 0))[1]}
    with _lock:
        fallback = {op: {"seconds_per_shard": round(e[0], 6),
                         "source": "ewma", "samples": e[1]}
                    for op, e in _fallback.items()}
        pairwise = {t: {"seconds": round(e[0], 6), "samples": e[1]}
                    for t, e in _pairwise.items()}
        strategy = {}
        for (op, chosen), n in _strategy_counts.items():
            strategy.setdefault(op, {})[chosen] = n
        out = {
            "mode": _mode,
            "forced_tile": _forced_tile,
            "calibration": {
                "kernels": calibration,
                "fallback": fallback,
                "pairwise_tiles": pairwise,
                "default_dispatch_seconds": DEFAULT_DISPATCH_SECONDS,
            },
            "decisions": {
                "strategy": strategy,
                "tile": dict(sorted(_tile_counts.items())),
                "patch": dict(_patch_counts),
                "cache": dict(_cache_counters),
                "admission": dict(_admission_counters),
            },
            "calibration_bumps": dict(_calibration_bumps),
            "repr_strikes": {f"{i}/{f}": n
                             for (i, f), n in _repr_strikes.items()},
            "recent": list(_recent),
        }
    return out


def decision_counts():
    """Flat counters for bench attempt tagging (one JSON-safe dict)."""
    with _lock:
        strategy = {}
        for (op, chosen), n in _strategy_counts.items():
            strategy[f"{op}:{chosen}"] = n
        return {
            "strategy": strategy,
            "tile": {str(t): n for t, n in _tile_counts.items()},
            "patch": dict(_patch_counts),
            "cache": dict(_cache_counters),
            "admission": dict(_admission_counters),
        }
