"""Workload observatory: query fingerprints, fragment heat, SLO burn.

The other instruments — per-query profiles, latency histograms, the
HBM/kernel ledgers, device-link health — do not aggregate by WORKLOAD:
which query shapes recur, which fragments are actually hot, and whether
serving is inside its latency objectives. This module is that
aggregation layer, the port's copy of the TPU package's (same
fingerprints, heat arithmetic and JSON shapes). Three subsystems:

1. Query fingerprinting. Every parsed PQL query normalizes to a
   literal-free shape (pql/ast.Call.shape: call names, field names,
   condition operators, and nesting survive; row ids, values, and time
   bounds collapse to `_`), prefixed with the index name and hashed.
   `Count(Row(f=3))` and `Count(Row(f=9))` share one fingerprint;
   `Count(Row(g=3))` does not. A bounded LRU table keeps rolling stats
   per fingerprint — count, wall histogram (log buckets shared with
   utils/stats), dispatch/cache deltas, strategy distribution from the
   executor's decision points, misestimate count from a planner — served
   at GET /debug/workload ranked by frequency, total wall, and
   misestimate rate.

2. Fragment heat. Every stacked-cache hit/miss and host-fallback access
   bumps an exponentially decayed counter per (index, field, view):
   heat(t) = heat(t0) * 0.5^((t-t0)/half_life) + 1 per touch, decayed
   lazily on touch/read so the hot path is one dict update. GET
   /debug/heat cross-references heat against the stacked HBM ledger and
   emits the two lists a cache-admission policy needs: hot-but-not-
   resident (admission/prefetch candidates) and resident-but-cold
   (eviction candidates). Top-N heat exports as fragment_heat gauges.

3. SLO burn rate. `--slo "query=50ms@p99"` declares an objective: 99%
   of the `query` op family under 50ms. The engine samples the EXISTING
   cumulative timing histograms (utils/stats) into a ring of
   (time, total, over-threshold) points and computes the error-budget
   burn rate over a fast and a slow window — burn 1.0 consumes the
   budget exactly at the sustainable rate; burn N consumes it N times
   too fast. Both windows over threshold => one slo.burn_alert flight-
   recorder event (edge-triggered, re-armed when the fast window
   recovers). Served at GET /debug/slo + slo_burn_rate{objective,window}
   gauges. Thresholds snap UP to the nearest histogram bucket bound.

All three are module-level singletons (like flightrec):
the HTTP layer, the API roll-up, and the executor share them without
threading instance handles through every layer. `reset()` restores a
pristine state for tests.
"""

import bisect
import hashlib
import threading
import time
from collections import OrderedDict

from .stats import TIMING_BUCKETS, _quantile, global_stats, tail_count

#: per-fingerprint rolling-stats entries retained (LRU beyond this)
DEFAULT_MAX_FINGERPRINTS = 512
#: fragment heat halves every this many seconds without a touch
DEFAULT_HEAT_HALF_LIFE = 300.0
#: decayed heat at/above which a fragment counts as "hot" (~one touch
#: within the last half-life)
HEAT_HOT_MIN = 1.0
#: top-N heat entries exported as fragment_heat gauges
HEAT_GAUGE_TOP = 10
#: SLO burn-rate windows (seconds): fast catches an active incident,
#: slow filters one-off spikes; an alert needs BOTH over threshold
SLO_FAST_WINDOW = 60.0
SLO_SLOW_WINDOW = 600.0
#: default burn rate that trips slo.burn_alert (budget consumed 6x
#: faster than sustainable)
DEFAULT_BURN_ALERT_THRESHOLD = 6.0
#: successive engine samples closer than this reuse the last one (the
#: gauge_fns would otherwise resample per scrape per objective)
SLO_MIN_SAMPLE_INTERVAL = 1.0


#: shape -> digest memo: a serving workload repeats a small set of
#: shapes, so the blake2b drops out of the steady-state per-query cost.
#: Unbounded growth is a fingerprint-cardinality attack, so it clears
#: wholesale at the cap (dict reads are GIL-atomic; no lock needed).
_FP_CACHE_MAX = 4096
_fp_cache = {}


def fingerprint(index_name, query):
    """(hash, shape) for a parsed Query: the literal-free shape prefixed
    with the index name, hashed to 16 hex chars. Stable across processes
    (content hash, no seed) so fleet-wide logs correlate."""
    global _fp_cache
    shape = f"{index_name}:{query.shape()}"
    fp = _fp_cache.get(shape)
    if fp is None:
        fp = hashlib.blake2b(
            shape.encode("utf-8"), digest_size=8).hexdigest()
        if len(_fp_cache) >= _FP_CACHE_MAX:
            _fp_cache = {}
        _fp_cache[shape] = fp
    return fp, shape


# --------------------------------------------------------------- table


class WorkloadTable:
    """Bounded per-fingerprint rolling stats, LRU-evicted: a burst of
    one-off shapes can displace idle entries but the hot shapes re-enter
    on their next query with only history lost, never correctness."""

    def __init__(self, max_entries=DEFAULT_MAX_FINGERPRINTS):
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # fingerprint -> mutable entry
        self.max_entries = max_entries
        self.evicted = 0
        self.total_queries = 0

    def record(self, fp, shape, index, wall_seconds, deltas=None,
               strategies=None, misestimates=0, batch=0):
        """Fold one finished query into its fingerprint's entry.
        `deltas` carries the per-query stacked-counter diffs
        (dispatches, cache_hits, cache_misses, bytes_materialized);
        `batch` is the fused-batch size the query rode (0 or 1 = solo),
        so the table answers which shapes actually coalesce."""
        deltas = deltas or {}
        with self._lock:
            self.total_queries += 1
            e = self._entries.get(fp)
            if e is None:
                e = self._entries[fp] = {
                    "fingerprint": fp, "shape": shape, "index": index,
                    "count": 0, "wall_sum": 0.0,
                    "buckets": [0] * (len(TIMING_BUCKETS) + 1),
                    "dispatches": 0, "cache_hits": 0, "cache_misses": 0,
                    "bytes_materialized": 0, "misestimates": 0,
                    "strategies": {},
                    "batched_queries": 0, "batch_size_sum": 0,
                }
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.evicted += 1
            else:
                self._entries.move_to_end(fp)
            e["count"] += 1
            e["wall_sum"] += wall_seconds
            e["buckets"][
                bisect.bisect_left(TIMING_BUCKETS, wall_seconds)] += 1
            for k in ("dispatches", "cache_hits", "cache_misses",
                      "bytes_materialized"):
                e[k] += int(deltas.get(k, 0))
            e["misestimates"] += misestimates
            for s in strategies or ():
                e["strategies"][s] = e["strategies"].get(s, 0) + 1
            if batch > 1:
                e["batched_queries"] += 1
                e["batch_size_sum"] += int(batch)
            e["last_seen"] = time.time()

    def _render(self, e):
        hits, misses = e["cache_hits"], e["cache_misses"]
        return {
            "fingerprint": e["fingerprint"],
            "shape": e["shape"],
            "index": e["index"],
            "count": e["count"],
            "total_wall_seconds": round(e["wall_sum"], 6),
            "p50_ms": round(
                _quantile(e["count"], e["buckets"], 0.50) * 1000, 3),
            "p99_ms": round(
                _quantile(e["count"], e["buckets"], 0.99) * 1000, 3),
            "dispatches": e["dispatches"],
            "bytes_materialized": e["bytes_materialized"],
            "cache_hit_ratio": round(hits / (hits + misses), 4)
            if hits + misses else None,
            "strategies": dict(sorted(e["strategies"].items())),
            "batched_queries": e["batched_queries"],
            "avg_batch_size": round(
                e["batch_size_sum"] / e["batched_queries"], 2)
            if e["batched_queries"] else None,
            "misestimates": e["misestimates"],
            "misestimate_rate": round(e["misestimates"] / e["count"], 4),
            "idle_seconds": round(time.time() - e["last_seen"], 1),
        }

    def hits(self, fp):
        """Completed-query count for one fingerprint (0 when unseen or
        evicted). NOT an access (no LRU touch): a compile-admission gate
        probing it on every query must not keep cold shapes resident by
        refreshing their recency."""
        with self._lock:
            e = self._entries.get(fp)
            return e["count"] if e is not None else 0

    def snapshot(self, top=20):
        """GET /debug/workload: the three rankings the optimizer loop
        reads — what runs most, what costs most, what the cost model
        gets wrong. top=0 returns counters only (peer roll-up shape)."""
        with self._lock:
            rendered = [self._render(e) for e in self._entries.values()]
        out = {
            "total_queries": self.total_queries,
            "unique_fingerprints": len(rendered),
            "max_fingerprints": self.max_entries,
            "evicted": self.evicted,
        }
        top = max(0, int(top))
        out["by_frequency"] = sorted(
            rendered, key=lambda e: -e["count"])[:top]
        out["by_total_wall"] = sorted(
            rendered, key=lambda e: -e["total_wall_seconds"])[:top]
        out["by_misestimate_rate"] = sorted(
            (e for e in rendered if e["misestimates"]),
            key=lambda e: -e["misestimate_rate"])[:top]
        return out

    def summary(self):
        """Compact roll-up for /status observability."""
        with self._lock:
            top = max(self._entries.values(), key=lambda e: e["count"]) \
                if self._entries else None
            return {
                "total_queries": self.total_queries,
                "unique_fingerprints": len(self._entries),
                "evicted": self.evicted,
                "top": {"fingerprint": top["fingerprint"],
                        "shape": top["shape"], "count": top["count"]}
                if top else None,
            }

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.evicted = 0
            self.total_queries = 0


# ---------------------------------------------------------------- heat


class HeatLedger:
    """Exponentially decayed access counts per (index, field, view).
    Decay is lazy — each entry stores (value, as_of) and decays only
    when touched or read — so a bump is one dict lookup, one pow, one
    store, cheap enough to ride every cache probe."""

    def __init__(self, half_life=DEFAULT_HEAT_HALF_LIFE):
        self._lock = threading.Lock()
        self._heat = {}  # (index, field, view) -> [value, as_of, touches]
        self.half_life = half_life
        self._gauged = set()  # keys currently exported as gauges

    def bump(self, index, field, view, amount=1.0, now=None):
        if now is None:
            now = time.time()
        key = (index, field, view)
        with self._lock:
            e = self._heat.get(key)
            if e is None:
                self._heat[key] = [amount, now, 1]
            else:
                dt = now - e[1]
                # sub-ms gaps skip the pow AND the as_of advance (the
                # un-decayed sliver stays banked in dt); the bias is
                # bounded by 1ms/half_life — unmeasurable at 300s
                if dt > 0.001:
                    e[0] *= 0.5 ** (dt / self.half_life)
                    e[1] = now
                e[0] += amount
                e[2] += 1

    def _decayed(self, e, now):
        dt = now - e[1]
        return e[0] * 0.5 ** (dt / self.half_life) if dt > 0 else e[0]

    def value(self, index, field, view, now=None):
        """Current decayed heat of ONE key (0.0 if untracked) — the
        cache benefit score's read path, so it must stay a single dict
        lookup plus one pow."""
        with self._lock:
            e = self._heat.get((index, field, view))
            if e is None:
                return 0.0
            return self._decayed(e, time.time() if now is None else now)

    def note_admitted(self, index, field, now=None):
        """An admission driven by hot_but_not_resident landed: scale the
        (index, field) group's summed heat down to exactly HEAT_HOT_MIN.
        Below the threshold the group can't re-recommend (the list
        converges); pinning AT the threshold — not
        zero — keeps the fresh admission out of resident_but_cold, which
        would nominate it for instant eviction."""
        if now is None:
            now = time.time()
        with self._lock:
            group = [(k, e) for k, e in self._heat.items()
                     if k[0] == index and k[1] == field]
            total = sum(self._decayed(e, now) for _, e in group)
            if total <= HEAT_HOT_MIN or total <= 0:
                return
            scale = HEAT_HOT_MIN / total
            for _, e in group:
                e[0] = self._decayed(e, now) * scale
                e[1] = now

    def snapshot(self, now=None):
        """All tracked keys with their current (decayed) heat, hottest
        first."""
        if now is None:
            now = time.time()
        with self._lock:
            out = [{"index": k[0], "field": k[1], "view": k[2],
                    "heat": round(self._decayed(e, now), 4),
                    "touches": e[2],
                    "idle_seconds": round(now - e[1], 1)}
                   for k, e in self._heat.items()]
        out.sort(key=lambda e: -e["heat"])
        return out

    def report(self, hbm_snapshot, top=50, now=None):
        """GET /debug/heat: heat joined against the HBM ledger. The two
        derived lists are the optimizer's inputs — hot_but_not_resident
        (demanded but evicted or never admitted: admission/prefetch
        candidates, hottest first) and resident_but_cold (holding HBM
        without recent demand: eviction candidates, largest first). The
        join is at (index, field) — heat per view is summed; residency
        comes from the ledger's by_index_field attribution."""
        entries = self.snapshot(now=now)
        heat_by_if = {}
        for e in entries:
            k = (e["index"], e["field"])
            heat_by_if[k] = heat_by_if.get(k, 0.0) + e["heat"]
        resident = {}
        for r in (hbm_snapshot or {}).get("by_index_field", ()):
            k = (r["index"], r["field"])
            resident[k] = resident.get(k, 0) + r["bytes"]
        hot_not_resident = sorted(
            (self._price_admission(i, f, h)
             for (i, f), h in heat_by_if.items()
             if h >= HEAT_HOT_MIN and (i, f) not in resident),
            key=lambda e: -e["heat"])
        resident_cold = sorted(
            ({"index": i, "field": f, "bytes": b,
              "heat": round(heat_by_if.get((i, f), 0.0), 4)}
             for (i, f), b in resident.items()
             if heat_by_if.get((i, f), 0.0) < HEAT_HOT_MIN),
            key=lambda e: -e["bytes"])
        self._export_gauges(entries[:HEAT_GAUGE_TOP])
        top = max(0, int(top))
        return {
            "half_life_seconds": self.half_life,
            "hot_threshold": HEAT_HOT_MIN,
            "tracked": len(entries),
            "entries": entries[:top],
            "hot_but_not_resident": hot_not_resident[:top],
            "hot_but_not_resident_total": len(hot_not_resident),
            "resident_but_cold": resident_cold[:top],
            "resident_but_cold_total": len(resident_cold),
        }

    @staticmethod
    def _price_admission(index, field, heat):
        """One hot_but_not_resident candidate, priced by what admission
        would ACTUALLY cost on the device: the container ledger's
        compressed bytes from the fragment's last build (the chooser is
        deterministic in the data, so the last build predicts the
        next). Fragments never built carry no estimate — the candidate
        still lists, unpriced."""
        e = {"index": index, "field": field, "heat": round(heat, 4)}
        try:
            from ..ops import containers

            est = containers.field_estimate(index, field)
        except Exception:  # pragma: no cover - observability only
            est = None
        if est is not None:
            e["est_bytes"] = est["bytes"]
            e["est_dense_bytes"] = est["dense_bytes"]
            e["compression_ratio"] = est["ratio"]
            e["reprs"] = est["reprs"]
        return e

    def _export_gauges(self, hottest):
        """fragment_heat gauges for the current top-N; keys that fell
        out of the top-N zero (a frozen stale gauge reads as hot)."""
        current = set()
        for e in hottest:
            key = (e["index"], e["field"], e["view"])
            current.add(key)
            global_stats.gauge("fragment_heat", e["heat"], {
                "index": key[0], "field": key[1], "view": key[2]})
        for key in self._gauged - current:
            global_stats.gauge("fragment_heat", 0.0, {
                "index": key[0], "field": key[1], "view": key[2]})
        self._gauged = current

    def summary(self):
        entries = self.snapshot()
        return {"tracked": len(entries),
                "hottest": {k: entries[0][k]
                            for k in ("index", "field", "view", "heat")}
                if entries else None}

    def clear(self):
        with self._lock:
            self._heat.clear()
            self._gauged.clear()


# ----------------------------------------------------------------- SLO


class SloObjective:
    """One parsed `name=50ms@p99` spec. `name` selects a timing family:
    `query` = every query_op_seconds series, `query.Count` = one op,
    `http` = every http_request_seconds series, anything else = an exact
    timing-family name in the registry."""

    def __init__(self, name, threshold_seconds, quantile):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"SLO quantile must be in (0, 1): {quantile}")
        self.name = name
        self.threshold_seconds = threshold_seconds
        self.quantile = quantile
        self.budget = 1.0 - quantile  # allowed over-threshold fraction

    def spec(self):
        t = self.threshold_seconds
        thr = f"{t:g}s" if t >= 1.0 else f"{t * 1000:g}ms"
        return f"{self.name}={thr}@p{self.quantile * 100:g}"


def parse_slo(spec):
    """Parse `query=50ms@p99` / `http=250ms@p99.9` / `query.GroupBy=1s@p95`
    into an SloObjective. Raises ValueError with the offending spec."""
    try:
        name, rest = spec.split("=", 1)
        threshold, q = rest.split("@", 1)
        name = name.strip()
        threshold = threshold.strip().lower()
        if threshold.endswith("ms"):
            seconds = float(threshold[:-2]) / 1000.0
        elif threshold.endswith("us"):
            seconds = float(threshold[:-2]) / 1e6
        elif threshold.endswith("s"):
            seconds = float(threshold[:-1])
        else:
            raise ValueError("threshold needs a unit (us/ms/s)")
        q = q.strip().lower()
        if not q.startswith("p"):
            raise ValueError("quantile must look like p99")
        quantile = float(q[1:]) / 100.0
        if not name or seconds <= 0:
            raise ValueError("empty name or non-positive threshold")
        return SloObjective(name, seconds, quantile)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"bad SLO spec {spec!r} "
                         f"(want name=50ms@p99): {e}") from e


class SloEngine:
    """Multi-window error-budget burn over the cumulative histograms.

    Each sample() reads (total, over-threshold) cumulative counts per
    objective from the stats registry and appends them to a ring; a
    window's burn rate is the over-threshold fraction of the requests
    that arrived inside the window, divided by the objective's budget.
    Cumulative counters mean no per-request work lands here — the engine
    costs one histogram scan per sample, rate-limited to
    SLO_MIN_SAMPLE_INTERVAL."""

    def __init__(self, stats=None):
        self._lock = threading.Lock()
        self._stats = stats or global_stats
        self.objectives = []
        self.burn_threshold = DEFAULT_BURN_ALERT_THRESHOLD
        self._samples = {}   # objective name -> list of (t, total, bad)
        self._alerting = {}  # objective name -> bool
        self._burns = {}     # objective name -> {"fast": x, "slow": y}
        self._last_sample = 0.0
        self.alerts_total = 0
        self._gauges_registered = set()

    def configure(self, objectives, burn_threshold=None):
        with self._lock:
            self.objectives = list(objectives)
            if burn_threshold is not None:
                self.burn_threshold = float(burn_threshold)
            for o in self.objectives:
                self._samples.setdefault(o.name, [])
                self._alerting.setdefault(o.name, False)
        # scrape-time gauges: evaluating one triggers a (rate-limited)
        # sample, so /metrics alone keeps the burn rates fresh
        for o in self.objectives:
            for window in ("fast", "slow"):
                reg_key = (o.name, window)
                if reg_key in self._gauges_registered:
                    continue
                self._gauges_registered.add(reg_key)
                self._stats.gauge_fn(
                    "slo_burn_rate",
                    (lambda name=o.name, w=window:
                     self.sample().get(name, {}).get(w, 0.0)),
                    {"objective": o.name, "window": window})

    def _cumulative(self, objective):
        """(total, over-threshold) requests to date for one objective's
        timing family."""
        hists = self._stats.histograms()
        total = bad = 0
        name = objective.name
        family, op = "query_op_seconds", None
        if name == "http":
            family = "http_request_seconds"
        elif name.startswith("query."):
            op = name.split(".", 1)[1]
        elif name != "query":
            family = name
        for (fam, tags), (count, _sum, buckets) in hists.items():
            if fam != family:
                continue
            if op is not None and ("op", op) not in tags:
                continue
            total += count
            bad += tail_count(buckets, objective.threshold_seconds)
        return total, bad

    def sample(self, now=None, force=False):
        """Take one (rate-limited) sample per objective, update burn
        rates, fire/clear alerts. Returns {objective: {window: burn}}."""
        from . import flightrec

        if now is None:
            now = time.time()
        with self._lock:
            if not self.objectives:
                return {}
            if not force and now - self._last_sample \
                    < SLO_MIN_SAMPLE_INTERVAL:
                return dict(self._burns)
            self._last_sample = now
            objectives = list(self.objectives)
        alerts = []
        for o in objectives:
            total, bad = self._cumulative(o)
            with self._lock:
                ring = self._samples[o.name]
                ring.append((now, total, bad))
                # keep one point older than the slow window as the diff
                # base; everything older than that is dead weight
                while len(ring) > 2 and ring[1][0] <= now - SLO_SLOW_WINDOW:
                    ring.pop(0)
                burns = {
                    "fast": self._burn(ring, o, now, SLO_FAST_WINDOW),
                    "slow": self._burn(ring, o, now, SLO_SLOW_WINDOW)}
                self._burns[o.name] = burns
                firing = (burns["fast"] > self.burn_threshold
                          and burns["slow"] > self.burn_threshold)
                if firing and not self._alerting[o.name]:
                    self._alerting[o.name] = True
                    self.alerts_total += 1
                    alerts.append((o, burns))
                elif not firing and self._alerting[o.name] \
                        and burns["fast"] <= self.burn_threshold:
                    self._alerting[o.name] = False
        for o, burns in alerts:  # outside the lock: recorder, logger
            flightrec.record(
                "slo.burn_alert", objective=o.name, spec=o.spec(),
                burn_fast=round(burns["fast"], 2),
                burn_slow=round(burns["slow"], 2),
                threshold=self.burn_threshold)
            self._stats.count("slo_burn_alerts", 1, {"objective": o.name})
            from . import incident

            incident.maybe_trigger(
                "slo_burn", objective=o.name, spec=o.spec(),
                burn_fast=round(burns["fast"], 2),
                burn_slow=round(burns["slow"], 2))
        with self._lock:
            return dict(self._burns)

    @staticmethod
    def _burn(ring, objective, now, window):
        """Burn over one window: over-threshold fraction of the requests
        inside the window / budget. Caller holds the lock."""
        cutoff = now - window
        base = ring[0]
        for point in ring:
            if point[0] > cutoff:
                break
            base = point
        tip = ring[-1]
        d_total = tip[1] - base[1]
        d_bad = tip[2] - base[2]
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / objective.budget

    def _exemplars_for(self, objective):
        """Over-threshold histogram exemplars for one objective — the
        direct link from a burning objective to assembled traces
        (GET /debug/traces/{traceID}). Empty unless the registry has
        exemplar capture enabled (--metrics-exemplars)."""
        from .stats import registry_of

        reg = registry_of(self._stats)
        if not hasattr(reg, "exemplars"):
            return []
        name = objective.name
        family, op = "query_op_seconds", None
        if name == "http":
            family = "http_request_seconds"
        elif name.startswith("query."):
            op = name.split(".", 1)[1]
        elif name != "query":
            family = name
        out = []
        for (_fam, tags), per in reg.exemplars(family).items():
            if op is not None and ("op", op) not in tags:
                continue
            for le, e in per.items():
                if e["value"] > objective.threshold_seconds:
                    out.append({"traceID": e["traceID"],
                                "seconds": round(e["value"], 6),
                                "le": le, "tags": dict(tags),
                                "timestamp": e["timestamp"]})
        out.sort(key=lambda e: -e["seconds"])
        return out[:8]

    def snapshot(self):
        """GET /debug/slo."""
        burns = self.sample()
        exemplars = {o.name: self._exemplars_for(o)
                     for o in list(self.objectives)}
        with self._lock:
            out = {
                "windows": {"fast_seconds": SLO_FAST_WINDOW,
                            "slow_seconds": SLO_SLOW_WINDOW},
                "burn_alert_threshold": self.burn_threshold,
                "alerts_total": self.alerts_total,
                "objectives": [],
            }
            for o in self.objectives:
                ring = self._samples.get(o.name) or []
                tip = ring[-1] if ring else (0.0, 0, 0)
                entry = {
                    "name": o.name,
                    "spec": o.spec(),
                    "threshold_ms": round(o.threshold_seconds * 1000, 3),
                    "quantile": o.quantile,
                    "error_budget": round(o.budget, 6),
                    "total_requests": tip[1],
                    "over_threshold": tip[2],
                    "burn_rate": {
                        k: round(v, 4)
                        for k, v in burns.get(o.name, {}).items()},
                    "alerting": self._alerting.get(o.name, False),
                }
                if exemplars.get(o.name):
                    entry["exemplars"] = exemplars[o.name]
                out["objectives"].append(entry)
        return out

    def summary(self):
        """Compact roll-up for /status observability."""
        burns = self.sample()
        with self._lock:
            worst = max((b.get("fast", 0.0) for b in burns.values()),
                        default=0.0)
            return {
                "objectives": len(self.objectives),
                "alerting": sorted(
                    n for n, a in self._alerting.items() if a),
                "alerts_total": self.alerts_total,
                "worst_fast_burn": round(worst, 4),
            }

    def clear(self):
        with self._lock:
            self.objectives = []
            self._samples.clear()
            self._alerting.clear()
            self._burns.clear()
            self._last_sample = 0.0
            self.alerts_total = 0


# ----------------------------------------------- module state + hot path

_table = WorkloadTable()
_heat = HeatLedger()
_slo = SloEngine()
_local = threading.local()


def table():
    return _table


def heat():
    return _heat


def slo():
    return _slo


def heat_bump(index, field, view, amount=1.0):
    """Per-access hot-path entry (stacked cache probes, host fallbacks).
    Module-level alias so call sites pay one attribute lookup."""
    _heat.bump(index, field, view, amount=amount)


class _QueryCtx:
    __slots__ = ("fingerprint", "shape", "index", "strategies",
                 "misestimates", "batch")

    def __init__(self, fp, shape, index):
        self.fingerprint = fp
        self.shape = shape
        self.index = index
        self.strategies = []
        self.misestimates = 0
        self.batch = 0  # fused-batch size this query rode (0/1 = solo)


def begin_query(index_name, query):
    """Fingerprint one parsed query and open its thread-local recording
    context (exec/executor.py, once per non-remote query). Decision
    points contribute via note_strategy()/note_misestimate() until
    end_query() folds everything into the table."""
    fp, shape = fingerprint(index_name, query)
    ctx = _QueryCtx(fp, shape, index_name)
    _local.ctx = ctx
    return ctx


def end_query(ctx, wall_seconds, deltas=None):
    """Close the context and fold the finished query into the table.
    The fingerprint stays in take-last position for the SLOW QUERY log
    line (same thread, same handoff pattern as utils/profile)."""
    if getattr(_local, "ctx", None) is ctx:
        _local.ctx = None
    _local.last_fingerprint = ctx.fingerprint
    _table.record(ctx.fingerprint, ctx.shape, ctx.index, wall_seconds,
                  deltas=deltas, strategies=ctx.strategies,
                  misestimates=ctx.misestimates, batch=ctx.batch)


def abort_query(ctx):
    """Discard an open context WITHOUT recording: a batch member that
    falls back mid-gather re-enters through the per-query path, which
    opens (and records) its own context — recording both would double
    count the shape."""
    if getattr(_local, "ctx", None) is ctx:
        _local.ctx = None


def note_strategy(op, strategy):
    """Executor decision points report the strategy actually taken; the
    table keeps the distribution per fingerprint."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None:
        ctx.strategies.append(f"{op}={strategy}")


def note_batch(n):
    """The batch paths report how many queries shared the in-flight
    query's fused dispatch (workload-table batch attribution)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None:
        ctx.batch = max(ctx.batch, int(n))


def note_misestimate():
    """A planner's misestimate flagging attributes to the in-flight
    query's fingerprint."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None:
        ctx.misestimates += 1


def current_fingerprint():
    ctx = getattr(_local, "ctx", None)
    return ctx.fingerprint if ctx is not None else None


def current_index():
    """Index of the in-flight query on THIS thread (None outside one) —
    a planner's misestimate feedback uses it to strike container-repr
    overrides at (index, field) granularity."""
    ctx = getattr(_local, "ctx", None)
    return ctx.index if ctx is not None else None


def last_fingerprint():
    """The fingerprint of the last query finished on THIS thread (the
    slow-query log reads it after the executor returns)."""
    return getattr(_local, "last_fingerprint", None)


def fingerprint_hits(fp):
    """How many queries of this shape have COMPLETED — the frequency
    signal a compile-admission gate reads."""
    return _table.hits(fp)


def maybe_sample_slo():
    """Cheap per-query tick (server/api.py): with objectives configured,
    take a rate-limited burn sample so alerts fire from serving traffic
    alone, without waiting for a metrics scrape. The rate-limit check is
    lock-free (GIL-atomic float read) so the common case costs one
    comparison; sample() re-checks under its lock."""
    if _slo.objectives and \
            time.time() - _slo._last_sample >= SLO_MIN_SAMPLE_INTERVAL:
        _slo.sample()


def configure(max_fingerprints=None, heat_half_life=None):
    """Apply server knobs (cli.py)."""
    if max_fingerprints is not None:
        _table.max_entries = max(1, int(max_fingerprints))
    if heat_half_life is not None:
        _heat.half_life = max(0.001, float(heat_half_life))


def configure_slo(specs, burn_threshold=None, logger=None):
    """Parse and install --slo objectives; bad specs raise ValueError
    (a misspelled objective silently tracking nothing is worse than a
    failed boot)."""
    objectives = [parse_slo(s) for s in specs]
    _slo.configure(objectives, burn_threshold=burn_threshold)
    if logger is not None and objectives:
        logger.printf("SLO objectives: %s (burn alert > %gx)",
                      ", ".join(o.spec() for o in objectives),
                      _slo.burn_threshold)
    return objectives


def reset():
    """Pristine module state (tests)."""
    _table.clear()
    _table.max_entries = DEFAULT_MAX_FINGERPRINTS
    _heat.clear()
    _heat.half_life = DEFAULT_HEAT_HALF_LIFE
    _slo.clear()
    _slo.burn_threshold = DEFAULT_BURN_ALERT_THRESHOLD
    _local.ctx = None
    _local.last_fingerprint = None
