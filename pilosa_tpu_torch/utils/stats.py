"""Metrics (reference: stats/stats.go StatsClient iface + backends).

The reference's pluggable StatsClient (stats/stats.go:31) with the same
backend set: in-process registry with Prometheus/expvar exposition
(prometheus/prometheus.go, stats.go:84), StatsD UDP emitter
(statsd/statsd.go, DataDog-tagged datagrams), nop, and multi fan-out
(stats.go:164). `RuntimeMonitor` is the runtime sampler loop
(server.go:813-860, gcnotify/gopsutil analog) publishing process gauges.

Metric names, tag keys and both exposition formats are the TPU
package's (the `pilosa_tpu_` Prometheus prefix included), so a dashboard
or a test written for one package reads the other. Nothing here imports
torch: the device gauges read it from sys.modules."""

import bisect
import json
import os
import socket
import threading
import time
from collections import defaultdict

from . import tracing

#: log-spaced latency bucket upper bounds (seconds) shared by every
#: timing series — 100µs to 10s, ~×2.5 per step, with an implicit +Inf
#: bucket. Log spacing keeps relative error roughly constant from
#: cache-hit kernels to slow cluster fan-outs.
TIMING_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: smoothing factor for the per-series timing EWMA — ~last 5 samples
#: dominate, so a post-warmup regime shift shows within a handful of
#: observations where the cumulative mean would take thousands
EWMA_ALPHA = 0.2


def new_series():
    """One timing series: [count, total seconds, per-bucket counts (+Inf
    last), EWMA seconds]."""
    return [0, 0.0, [0] * (len(TIMING_BUCKETS) + 1), 0.0]


def observe(series, seconds):
    """Fold one observation into a timing series; returns its bucket
    index. The registry's own update, shared with the scrape-time
    sources that accumulate series of their own (add_source)."""
    i = bisect.bisect_left(TIMING_BUCKETS, seconds)
    series[0] += 1
    series[1] += seconds
    series[2][i] += 1
    # first sample seeds the EWMA; later samples alpha-blend
    series[3] = seconds if series[0] == 1 \
        else series[3] + EWMA_ALPHA * (seconds - series[3])
    return i


def _key(name, tags):
    if not tags:
        return name, ()
    return name, tuple(sorted(tags.items()))


def _escape_label(value):
    """Escape one label VALUE per the Prometheus exposition format
    (backslash, double-quote, and newline must be escaped; anything else
    passes through)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _quantile(count, bucket_counts, q):
    """Estimate the q-quantile from log-bucket counts: linear
    interpolation inside the target bucket (Prometheus histogram_quantile
    semantics; the lowest bucket interpolates from 0)."""
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0
    for i, n in enumerate(bucket_counts):
        if n <= 0:
            continue
        if cum + n >= target:
            lo = 0.0 if i == 0 else TIMING_BUCKETS[i - 1]
            # +Inf bucket: report the largest finite bound rather than inf
            hi = TIMING_BUCKETS[i] if i < len(TIMING_BUCKETS) \
                else TIMING_BUCKETS[-1]
            return lo + (hi - lo) * (target - cum) / n
        cum += n
    return TIMING_BUCKETS[-1]


def tail_count(bucket_counts, threshold_seconds):
    """Observations ABOVE `threshold_seconds` from per-bucket counts
    (+Inf last, aligned to TIMING_BUCKETS). The threshold snaps UP to
    the nearest bucket bound — bucket resolution is the guarantee, so an
    SLO threshold between bounds under-counts rather than over-counts.
    Thresholds past the largest finite bound (10s) are untrackable and
    return 0."""
    i = bisect.bisect_left(TIMING_BUCKETS, threshold_seconds)
    if i >= len(TIMING_BUCKETS):
        return 0
    return sum(bucket_counts[i + 1:])


class StatsClient:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = defaultdict(float)
        self._gauges = {}
        self._gauge_fns = {}
        # per series: [count, total seconds, per-bucket counts (+Inf
        # last), EWMA seconds]. Fields 0-2 are the cumulative series
        # /metrics exposes (unchanged forever); field 3 is the
        # recency-weighted view the adaptive layer calibrates from.
        self._timings = defaultdict(new_series)
        # scrape-time sources (add_source): their series add to these
        self._sources = []
        # Exemplars (OpenMetrics): when enabled, each timing series keeps
        # ONE recent (trace_id, value, wall_ts) per bucket, linking a
        # histogram bucket straight to an assembled trace. Off by default:
        # the flag check is the only cost on the disabled path.
        self._exemplars_on = False
        self._exemplars = {}  # series key -> [exemplar|None per bucket]

    def count(self, name, value=1, tags=None):
        with self._lock:
            self._counters[_key(name, tags)] += value

    def gauge(self, name, value, tags=None):
        with self._lock:
            self._gauges[_key(name, tags)] = value

    def gauge_fn(self, name, fn, tags=None):
        """Scrape-time gauge: `fn()` is evaluated on every snapshot. For
        liveness ages (e.g. seconds since a sampler last ran) — a stored
        gauge freezes when its writer wedges, which is exactly the moment
        the metric matters."""
        with self._lock:
            self._gauge_fns[_key(name, tags)] = fn

    def enable_exemplars(self, enabled=True):
        with self._lock:
            self._exemplars_on = bool(enabled)
            if not enabled:
                self._exemplars.clear()

    def add_source(self, fn):
        """Register a scrape-time source: `fn()` returns (counters,
        timings), dicts keyed like the registry's own series ((name,
        sorted tag pairs)), counters as numbers and timings as
        `new_series` lists. Every read of the registry adds them to its
        own series of the same key, so a hot path can accumulate under a
        lock it already holds instead of taking the registry's for each
        observation; the exposition is the same as if it had called
        count() and timing()."""
        with self._lock:
            self._sources.append(fn)

    def _merged(self):
        """(counters, timing series) of the registry with its sources
        added in, as copies."""
        with self._lock:
            counters = dict(self._counters)
            series = {k: [v[0], v[1], list(v[2]), v[3]]
                      for k, v in self._timings.items()}
            sources = list(self._sources)
        for fn in sources:
            s_counters, s_series = fn()
            for k, v in s_counters.items():
                counters[k] = counters.get(k, 0.0) + v
            for k, v in s_series.items():
                mine = series.get(k)
                if mine is None:
                    series[k] = [v[0], v[1], list(v[2]), v[3]]
                else:  # the registry's own EWMA is kept
                    mine[0] += v[0]
                    mine[1] += v[1]
                    mine[2] = [a + b for a, b in zip(mine[2], v[2])]
        return counters, series

    def timing(self, name, seconds, tags=None, trace_id=None):
        k = _key(name, tags)
        with self._lock:
            i = observe(self._timings[k], seconds)
            if self._exemplars_on:
                if trace_id is None:
                    span = tracing.current_span()
                    trace_id = span.trace_id if span is not None else None
                if trace_id is not None:
                    ex = self._exemplars.get(k)
                    if ex is None:
                        ex = self._exemplars[k] = \
                            [None] * (len(TIMING_BUCKETS) + 1)
                    ex[i] = (trace_id, seconds, time.time())

    def exemplars(self, name=None):
        """{series key: {le_label: {"traceID","value","timestamp"}}} for
        series with at least one exemplar; `name` filters to one family
        (how /debug/slo links a burning objective to traces)."""
        with self._lock:
            items = [(k, list(v)) for k, v in self._exemplars.items()
                     if name is None or k[0] == name]
        out = {}
        for k, buckets in items:
            per = {}
            for i, e in enumerate(buckets):
                if e is None:
                    continue
                le = (f"{TIMING_BUCKETS[i]:g}"
                      if i < len(TIMING_BUCKETS) else "+Inf")
                per[le] = {"traceID": e[0], "value": e[1],
                           "timestamp": e[2]}
            if per:
                out[k] = per
        return out

    def snapshot(self):
        """(counters, gauges, timings) — timings as (count, sum) pairs;
        `histograms()` adds the bucket counts."""
        counters, series = self._merged()
        timings = {k: (v[0], v[1]) for k, v in series.items()}
        with self._lock:
            gauges = dict(self._gauges)
            fns = list(self._gauge_fns.items())
        for k, fn in fns:  # outside the lock: fns may call gauge()
            try:
                gauges[k] = fn()
            except Exception:
                pass
        return (counters, gauges, timings)

    def histograms(self):
        """{key: (count, sum, bucket_counts)} — bucket_counts are
        per-bucket (NOT cumulative), +Inf last, aligned to
        TIMING_BUCKETS."""
        return {k: (v[0], v[1], tuple(v[2]))
                for k, v in self._merged()[1].items()}

    def timing_summary(self, name):
        """{(name, tags): (count, sum)} for ONE timing family — the
        explain cost model reads `kernel_seconds{kernel}` means without
        copying every histogram's buckets."""
        return {k: (v[0], v[1]) for k, v in self._merged()[1].items()
                if k[0] == name}

    def timing_ewma(self, name):
        """{(name, tags): (ewma_seconds, count)} for ONE timing family —
        the recency-weighted companion to `timing_summary`. The
        cumulative /metrics series are untouched; this view exists so
        the adaptive layer can forget a slow cold-start regime."""
        return {k: (v[3], v[0]) for k, v in self._merged()[1].items()
                if k[0] == name}

    def timing_ewma_force(self, name, seconds, tags=None):
        """Overwrite a series' EWMA with an observed value WITHOUT
        touching the cumulative count/sum/buckets — the misestimate
        feedback path: a >3× plan-vs-actual deviation re-seeds the
        calibration from reality instead of waiting for the blend to
        catch up."""
        with self._lock:
            t = self._timings[_key(name, tags)]
            t[3] = seconds

    def prometheus_text(self):
        """Prometheus exposition format (reference: prometheus/prometheus.go
        + /metrics route http/handler.go:282): escaped label values, one
        # TYPE line per metric family, and real histogram series
        (_bucket{le=...}/_count/_sum) for timings."""
        counters, gauges, _ = self.snapshot()
        hists = self.histograms()
        with self._lock:
            exemplars = {k: list(v) for k, v in self._exemplars.items()}
        lines = []
        seen_families = set()

        def exemplar_suffix(key, bucket_i):
            # OpenMetrics exemplar: `value # {trace_id="..."} v ts`.
            # Exemplar-aware scrapers (and humans) get the trace link;
            # plain Prometheus text parsers that reject it simply should
            # not enable --metrics-exemplars.
            ex = exemplars.get(key)
            if not ex or ex[bucket_i] is None:
                return ""
            tid, v, ts = ex[bucket_i]
            return (f' # {{trace_id="{_escape_label(tid)}"}}'
                    f" {v:g} {ts:.3f}")

        def family(fqname, typ):
            # dedupe: one TYPE line per family, before its first sample
            if fqname not in seen_families:
                seen_families.add(fqname)
                lines.append(f"# TYPE {fqname} {typ}")

        def fmt(name, labels, value, extra=()):
            pairs = tuple(labels) + tuple(extra)
            if pairs:
                inner = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in pairs)
                return f"{name}{{{inner}}} {value}"
            return f"{name} {value}"

        for (name, labels), value in sorted(counters.items()):
            fq = f"pilosa_tpu_{name}_total"
            family(fq, "counter")
            lines.append(fmt(fq, labels, value))
        for (name, labels), value in sorted(gauges.items()):
            fq = f"pilosa_tpu_{name}"
            family(fq, "gauge")
            lines.append(fmt(fq, labels, value))
        for (name, labels), (count, total, buckets) in sorted(hists.items()):
            fq = f"pilosa_tpu_{name}"
            family(fq, "histogram")
            key = (name, labels)
            cum = 0
            for i, (bound, n) in enumerate(zip(TIMING_BUCKETS, buckets)):
                cum += n
                lines.append(fmt(f"{fq}_bucket", labels, cum,
                                 extra=(("le", f"{bound:g}"),))
                             + exemplar_suffix(key, i))
            lines.append(fmt(f"{fq}_bucket", labels, count,
                             extra=(("le", "+Inf"),))
                         + exemplar_suffix(key, len(TIMING_BUCKETS)))
            lines.append(fmt(f"{fq}_count", labels, count))
            lines.append(fmt(f"{fq}_sum", labels, total))
        return "\n".join(lines) + "\n"

    def expvar_json(self):
        """JSON snapshot (reference: expvar backend stats.go:84 + the
        /debug/vars route http/handler.go:281). Timings carry estimated
        p50/p99 from the log buckets."""
        counters, gauges, _ = self.snapshot()
        hists = self.histograms()

        def flat(d):
            return {
                (name if not labels else
                 name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"):
                    value
                for (name, labels), value in sorted(d.items())}

        return json.dumps({
            "counters": flat(counters),
            "gauges": flat(gauges),
            "timings": {k: {"count": c, "sum": s,
                            "p50": _quantile(c, b, 0.50),
                            "p99": _quantile(c, b, 0.99)}
                        for k, (c, s, b) in flat(hists).items()},
        })


class NopStats:
    """Discards everything (reference: nopStatsClient stats.go:54)."""

    def count(self, name, value=1, tags=None):
        pass

    def gauge(self, name, value, tags=None):
        pass

    def timing(self, name, seconds, tags=None, trace_id=None):
        pass


class StatsDClient:
    """UDP StatsD emitter with DataDog-style |#k:v tags (reference:
    statsd/statsd.go). Fire-and-forget: send errors are ignored, matching
    UDP statsd semantics."""

    def __init__(self, host="127.0.0.1", port=8125, prefix="pilosa_tpu"):
        self.prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # Resolve once and connect() so the datagram hot path never
            # does a DNS lookup (the http dispatch emits per request).
            self._sock.connect((host, port))
        except OSError:
            pass  # unresolvable now; sends just drop (UDP semantics)

    def _send(self, name, value, kind, tags):
        msg = f"{self.prefix}.{name}:{value}|{kind}"
        if tags:
            msg += "|#" + ",".join(f"{k}:{v}" for k, v in sorted(tags.items()))
        try:
            self._sock.send(msg.encode())
        except OSError:
            pass

    def count(self, name, value=1, tags=None):
        self._send(name, value, "c", tags)

    def gauge(self, name, value, tags=None):
        self._send(name, value, "g", tags)

    def timing(self, name, seconds, tags=None, trace_id=None):
        self._send(name, round(seconds * 1000, 3), "ms", tags)

    def close(self):
        self._sock.close()


class MultiStats:
    """Fans every metric out to several clients (reference: multiStatsClient
    stats.go:164). The registry is usually first so exposition still works."""

    def __init__(self, clients):
        self.clients = list(clients)

    def count(self, name, value=1, tags=None):
        for c in self.clients:
            c.count(name, value, tags)

    def gauge(self, name, value, tags=None):
        for c in self.clients:
            c.gauge(name, value, tags)

    def timing(self, name, seconds, tags=None, trace_id=None):
        for c in self.clients:
            c.timing(name, seconds, tags, trace_id=trace_id)


class RuntimeMonitor:
    """Background sampler publishing process runtime gauges every interval
    (reference: server.monitorRuntime server.go:813-860 — goroutines, heap,
    GC; here: threads, RSS, fds, uptime from /proc)."""

    def __init__(self, stats, interval=10.0):
        self.stats = stats
        # Event.wait(0) would busy-spin the sampler loop.
        self.interval = max(float(interval), 1.0)
        self._stop = threading.Event()
        self._thread = None
        self._t0 = time.time()
        self.last_sample_time = None

    def sample(self):
        self.stats.gauge("uptime_seconds", time.time() - self._t0)
        self.stats.gauge("threads", threading.active_count())
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.stats.gauge(
                            "rss_bytes", int(line.split()[1]) * 1024)
                        break
            self.stats.gauge("open_fds", len(os.listdir("/proc/self/fd")))
        except OSError:
            pass  # non-procfs platform
        self._sample_devices()
        self.last_sample_time = time.time()

    def _sample_devices(self):
        """Per-device CUDA memory gauges so device memory pressure sits
        next to RSS. Reads torch from sys.modules only (this module never
        imports it) and samples only when CUDA is ALREADY initialized in
        this process: metrics must never be what initializes the card.
        The same three gauges as the TPU package's, under
        device="cuda:<i>": bytes allocated now, the allocator's peak, and
        the card's total memory."""
        import sys

        torch = sys.modules.get("torch")
        if torch is None:
            return
        try:
            if not torch.cuda.is_initialized():
                return
            for i in range(torch.cuda.device_count()):
                mem = torch.cuda.memory_stats(i)
                tags = {"device": f"cuda:{i}"}
                self.stats.gauge("device_memory_bytes",
                                 mem.get("allocated_bytes.all.current", 0),
                                 tags)
                self.stats.gauge("device_peak_memory_bytes",
                                 mem.get("allocated_bytes.all.peak", 0),
                                 tags)
                self.stats.gauge("device_memory_limit_bytes",
                                 torch.cuda.mem_get_info(i)[1], tags)
        except Exception:
            pass  # a card gone or a torch without CUDA introspection

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def _sample_age(self):
        return (time.time() - self.last_sample_time
                if self.last_sample_time is not None else -1)

    def start(self):
        # Evaluated at scrape time, so a wedged sampler thread shows up
        # as an ever-growing age instead of a frozen small value.
        registry_of(self.stats).gauge_fn(
            "runtime_monitor_last_sample_age_seconds", self._sample_age)
        self.sample()
        self._thread = threading.Thread(
            target=self._run, name="pilosa-runtime-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


def registry_of(stats):
    """The exposition-capable registry behind a configured stats client
    (a MultiStats wraps one; NopStats has none -> global registry)."""
    if isinstance(stats, StatsClient):
        return stats
    if isinstance(stats, MultiStats):
        for c in stats.clients:
            if isinstance(c, StatsClient):
                return c
    return global_stats


def build_stats(kind, statsd_host=None, registry=None):
    """Config-selected backend (reference: server.go:419 NewStatsClient).
    `kind`: "local" (registry only, default), "statsd" (registry + UDP so
    /metrics keeps working), "none", or "expvar" (alias of local)."""
    registry = registry if registry is not None else global_stats
    if kind in (None, "", "local", "expvar", "prometheus"):
        return registry
    if kind == "none":
        return NopStats()
    if kind == "statsd":
        host, _, port = (statsd_host or "127.0.0.1:8125").partition(":")
        return MultiStats(
            [registry, StatsDClient(host, int(port or 8125))])
    raise ValueError(f"unknown stats backend {kind!r}")


def configure_exemplars(enabled, registry=None):
    """Toggle histogram exemplar capture on the exposition registry
    (--metrics-exemplars). Nop-cheap when off: one flag check per
    timing() call."""
    (registry if registry is not None else global_stats) \
        .enable_exemplars(enabled)


global_stats = StatsClient()
