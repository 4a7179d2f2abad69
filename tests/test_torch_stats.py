"""The port's stats module against the TPU package's, on the CPU.

Ported from tests/test_stats.py: the registry's Prometheus and expvar
exposition, statsd datagrams, MultiStats/NopStats, backend selection,
the runtime sampler, registry_of, and a port server (`--device cpu`)
exposing its injected registry at /metrics and /debug/vars.
Differential: one seeded sequence of count/gauge/timing calls runs on a
registry of each package, and the Prometheus text, the expvar JSON and
the statsd datagrams must be equal byte for byte. The CUDA device
gauges are checked with torch.cuda's introspection calls replaced (the
tests run without a card), and the sampler must initialize none.
"""

import json
import re
import socket

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.utils import stats as ref_stats  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402
from pilosa_tpu_torch.utils import stats as stats_mod  # noqa: E402
from pilosa_tpu_torch.utils.stats import (  # noqa: E402
    MultiStats,
    NopStats,
    RuntimeMonitor,
    StatsClient,
    StatsDClient,
    build_stats,
    registry_of,
)


def test_registry_and_prometheus_text():
    s = StatsClient()
    s.count("queries", 2, tags={"index": "i"})
    s.gauge("shards", 5)
    s.timing("exec_seconds", 0.25)
    text = s.prometheus_text()
    assert 'pilosa_tpu_queries_total{index="i"} 2' in text
    assert "pilosa_tpu_shards 5" in text
    assert "pilosa_tpu_exec_seconds_count 1" in text
    assert "pilosa_tpu_exec_seconds_sum 0.25" in text


def test_expvar_json():
    s = StatsClient()
    s.count("q", 1)
    s.gauge("g", 2, tags={"a": "b"})
    s.timing("t", 0.5)
    data = json.loads(s.expvar_json())
    assert data["counters"]["q"] == 1
    assert data["gauges"]["g{a=b}"] == 2
    t = data["timings"]["t"]
    assert t["count"] == 1 and t["sum"] == 0.5
    assert 0.25 <= t["p50"] <= 0.5
    assert 0.25 <= t["p99"] <= 0.5


def test_statsd_datagrams():
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(5)
    port = recv.getsockname()[1]
    c = StatsDClient("127.0.0.1", port)
    try:
        c.count("queries", 3, tags={"index": "i"})
        c.gauge("shards", 7)
        c.timing("exec", 0.5)
        got = sorted(recv.recv(1024).decode() for _ in range(3))
        assert got == [
            "pilosa_tpu.exec:500.0|ms",
            "pilosa_tpu.queries:3|c|#index:i",
            "pilosa_tpu.shards:7|g",
        ]
    finally:
        c.close()
        recv.close()


def test_multi_and_nop():
    reg = StatsClient()
    multi = MultiStats([reg, NopStats()])
    multi.count("x")
    multi.gauge("y", 1)
    multi.timing("z", 0.1)
    counters, gauges, timings = reg.snapshot()
    assert counters and gauges and timings


def test_build_stats_selection():
    reg = StatsClient()
    assert build_stats("local", registry=reg) is reg
    assert isinstance(build_stats("none"), NopStats)
    multi = build_stats("statsd", statsd_host="127.0.0.1:9", registry=reg)
    assert isinstance(multi, MultiStats) and multi.clients[0] is reg
    multi.clients[1].close()
    with pytest.raises(ValueError):
        build_stats("bogus")


def test_runtime_monitor_samples():
    import os

    reg = StatsClient()
    mon = RuntimeMonitor(reg, interval=1000)
    mon.start()
    mon.stop()
    _, gauges, _ = reg.snapshot()
    names = {name for name, _ in gauges}
    assert "uptime_seconds" in names
    assert "threads" in names
    if os.path.exists("/proc/self/status"):
        assert "rss_bytes" in names


def test_registry_of():
    reg = StatsClient()
    assert registry_of(reg) is reg
    assert registry_of(MultiStats([NopStats(), reg])) is reg
    assert registry_of(NopStats()) is stats_mod.global_stats


def test_server_exposes_injected_registry(tmp_path):
    """Metrics routes read the server's configured registry, not the
    global one."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.http_server import PilosaHTTPServer

    holder = Holder(str(tmp_path)).open()
    reg = StatsClient()
    reg.count("private_marker", 42)
    srv = PilosaHTTPServer(API(holder, device="cpu"), host="127.0.0.1",
                           port=0, stats=reg).start()
    try:
        text = Client(srv.uri)._request("GET", "/metrics")
        assert b"pilosa_tpu_private_marker_total 42" in text
    finally:
        srv.stop()
        holder.close()


def test_server_exposes_debug_vars(tmp_path):
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path), "--device", "cpu"])
    try:
        c = Client(srv.uri)
        c.create_index("i")
        data = c._request("GET", "/debug/vars")
        assert "counters" in data and "timings" in data
        assert "dispatches" in data["stacked"]
        assert data["workpool"]["workers"] >= 1
        text = c._request("GET", "/metrics")
        assert b"http_request_seconds" in text
    finally:
        srv.stop()


# -------------------------------------------------------------- differential


def _drive(reg, seed, n=300):
    """One seeded sequence of count/gauge/timing calls with tags, label
    values that need escaping included."""
    rng = np.random.default_rng(seed)
    names = ["queries", "http_request_seconds", "kernel_seconds", "g"]
    tagsets = [None, {"index": "i"}, {"kernel": "count", "phase": "sync"},
               {"q": 'he said "hi"', "b": "a\\b", "n": "x\ny"}]
    for _ in range(n):
        kind = int(rng.integers(0, 3))
        name = names[int(rng.integers(0, len(names)))]
        tags = tagsets[int(rng.integers(0, len(tagsets)))]
        if kind == 0:
            reg.count(name + "_c", int(rng.integers(1, 5)), tags=tags)
        elif kind == 1:
            reg.gauge(name + "_g", float(rng.integers(0, 1000)), tags=tags)
        else:
            # log-uniform over the bucket range, plus the +Inf bucket
            reg.timing(name, float(10 ** rng.uniform(-5, 1.3)), tags=tags)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_equal_byte_for_byte(seed):
    got, want = StatsClient(), ref_stats.StatsClient()
    _drive(got, seed)
    _drive(want, seed)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.expvar_json() == want.expvar_json()
    assert got.histograms() == want.histograms()
    assert got.timing_ewma("kernel_seconds") \
        == want.timing_ewma("kernel_seconds")


def test_exemplars_equal_but_for_timestamps():
    got, want = StatsClient(), ref_stats.StatsClient()
    for reg in (got, want):
        reg.enable_exemplars(True)
        rng = np.random.default_rng(9)
        for i in range(50):
            reg.timing("lat_seconds", float(10 ** rng.uniform(-4, 0.5)),
                       {"op": "x"}, trace_id=f"t{i % 7}")

    def strip(text):
        return re.sub(r"(# \{trace_id=\"[^\"]*\"\} \S+) \S+", r"\1", text)

    assert strip(got.prometheus_text()) == strip(want.prometheus_text())
    assert {k: {le: (e["traceID"], e["value"]) for le, e in v.items()}
            for k, v in got.exemplars().items()} \
        == {k: {le: (e["traceID"], e["value"]) for le, e in v.items()}
            for k, v in want.exemplars().items()}


def test_statsd_datagrams_equal():
    socks, clients = [], []
    for mod in (stats_mod, ref_stats):
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(5)
        socks.append(recv)
        clients.append(mod.StatsDClient("127.0.0.1", recv.getsockname()[1]))
    try:
        rng = np.random.default_rng(4)
        ops = [(int(rng.integers(0, 3)), int(rng.integers(1, 9)),
                float(rng.random())) for _ in range(20)]
        for c in clients:
            for kind, v, t in ops:
                if kind == 0:
                    c.count("q", v, tags={"index": "i", "a": "b"})
                elif kind == 1:
                    c.gauge("shards", v)
                else:
                    c.timing("exec", t, tags={"op": "Count"})
        got = [sorted(s.recv(1024).decode() for _ in ops) for s in socks]
        assert got[0] == got[1]
    finally:
        for c in clients:
            c.close()
        for s in socks:
            s.close()


def test_quantile_and_tail_count_equal():
    rng = np.random.default_rng(6)
    for _ in range(20):
        counts = [int(x) for x in rng.integers(0, 50, size=17)]
        q = float(rng.random())
        assert stats_mod._quantile(sum(counts), counts, q) \
            == ref_stats._quantile(sum(counts), counts, q)
        thr = float(10 ** rng.uniform(-4, 1.5))
        assert stats_mod.tail_count(counts, thr) \
            == ref_stats.tail_count(counts, thr)
    assert stats_mod.TIMING_BUCKETS == ref_stats.TIMING_BUCKETS


# ---------------------------------------------------------- device gauges


def test_device_gauges_need_an_initialized_card(monkeypatch):
    """No card has been initialized in this process: the sampler emits no
    device gauge and initializes nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: calls.append(i) or {})
    reg = StatsClient()
    RuntimeMonitor(reg)._sample_devices()
    _, gauges, _ = reg.snapshot()
    assert not [k for k in gauges if k[0].startswith("device_")]
    assert calls == []


def test_device_gauges_per_cuda_device(monkeypatch):
    stats_by_dev = {
        0: {"allocated_bytes.all.current": 1000,
            "allocated_bytes.all.peak": 5000},
        1: {"allocated_bytes.all.current": 7,
            "allocated_bytes.all.peak": 9}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: stats_by_dev[i])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (1, 80 << 30))
    reg = StatsClient()
    RuntimeMonitor(reg)._sample_devices()
    _, gauges, _ = reg.snapshot()
    for i, mem in stats_by_dev.items():
        tags = (("device", f"cuda:{i}"),)
        assert gauges[("device_memory_bytes", tags)] \
            == mem["allocated_bytes.all.current"]
        assert gauges[("device_peak_memory_bytes", tags)] \
            == mem["allocated_bytes.all.peak"]
        assert gauges[("device_memory_limit_bytes", tags)] == 80 << 30
    assert 'pilosa_tpu_device_memory_bytes{device="cuda:0"} 1000' \
        in reg.prometheus_text()


@pytest.mark.parametrize("seed", [3, 4])
def test_scrape_time_source_adds_like_direct_observations(seed):
    """A registry whose hot path observes into a scrape-time source
    (add_source, as the stacked evaluator's launch series do) exposes
    exactly what the TPU package's registry exposes when it takes every
    observation itself."""
    got, want = StatsClient(), ref_stats.StatsClient()
    counters, series = {}, {}
    got.add_source(lambda: (dict(counters), {
        k: [v[0], v[1], list(v[2]), v[3]] for k, v in series.items()}))
    rng = np.random.default_rng(seed)
    for _ in range(400):
        kind = ["count", "row_counts"][int(rng.integers(0, 2))]
        seconds = float(10 ** rng.uniform(-6, 0.5))
        nbytes = int(rng.integers(0, 1 << 20))
        tags = {"kernel": kind}
        want.timing("kernel_seconds", seconds, tags)
        want.count("kernel_bytes_in", nbytes, tags)
        if rng.random() < 0.5:  # half directly, half through the source
            got.timing("kernel_seconds", seconds, tags)
            got.count("kernel_bytes_in", nbytes, tags)
        else:
            key = ("kernel_seconds", (("kernel", kind),))
            stats_mod.observe(series.setdefault(key, stats_mod.new_series()),
                              seconds)
            key = ("kernel_bytes_in", (("kernel", kind),))
            counters[key] = counters.get(key, 0.0) + nbytes
    # equal line for line; a sum is added in another order, so equal to
    # the last few bits
    g_lines, w_lines = (r.prometheus_text().splitlines() for r in (got, want))
    assert len(g_lines) == len(w_lines)
    for g, w in zip(g_lines, w_lines):
        if "_sum" in g.split(" ")[0]:
            assert g.split(" ")[0] == w.split(" ")[0]
            assert float(g.split(" ")[1]) == pytest.approx(
                float(w.split(" ")[1]), rel=1e-12)
        else:
            assert g == w
    g_hist, w_hist = got.histograms(), want.histograms()
    assert g_hist.keys() == w_hist.keys()
    for k in g_hist:
        assert g_hist[k][0] == w_hist[k][0] and g_hist[k][2] == w_hist[k][2]
        assert g_hist[k][1] == pytest.approx(w_hist[k][1], rel=1e-12)
