"""End-to-end query observability of the port against the TPU package's,
on the CPU.

Ported from tests/test_observability.py: per-query span-tree profiles
(?profile=true) whose kernel spans and dispatch tags agree with the
exported counters, the nop default, the /debug/queries ring, the
slow-query log with its embedded profile, /debug/traces, Prometheus
histogram exposition under escaping and concurrency, per-route request
metrics and the runtime sampler's shutdown. Then what this port adds to
it: the dispatch-phase split (every family's phase seconds sum to its
wall, in the evaluator and in a profile; the lock is never held across
a result fetch), the SIGTERM chain (a server child dumps its flight
recorder AND stops cleanly, so its next boot replays nothing), the
debug routes and the server flags.

Server level, both packages' servers run in this process (the TPU
package's through tests/harness.ServerHarness, the port's with
`--device cpu`), get the same PQL, and must agree on the ?profile=true
span names, the profile's counter keys, the /metrics metric names and
the slow-query line's fields (timings excluded). On a 2-node cluster of
each package, a fan-out query's per-node spans and its profile agree.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.exec import stacked as ref_stacked  # noqa: E402
from pilosa_tpu.utils import flightrec as ref_flightrec  # noqa: E402
from pilosa_tpu.utils import profile as ref_profile  # noqa: E402
from pilosa_tpu.utils import stats as ref_stats  # noqa: E402
from pilosa_tpu.utils import tracing as ref_tracing  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.exec import stacked  # noqa: E402
from pilosa_tpu_torch.server import Client, ClientError  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils import flightrec  # noqa: E402
from pilosa_tpu_torch.utils import profile as profile_mod  # noqa: E402
from pilosa_tpu_torch.utils import stats as stats_mod  # noqa: E402
from pilosa_tpu_torch.utils import tracing  # noqa: E402
from pilosa_tpu_torch.utils.logger import CaptureLogger  # noqa: E402
from pilosa_tpu_torch.utils.stats import (  # noqa: E402
    TIMING_BUCKETS,
    RuntimeMonitor,
    StatsClient,
)

from tests.harness import ServerHarness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_registry(reg):
    with reg._lock:
        reg._counters.clear()
        reg._gauges.clear()
        reg._gauge_fns.clear()
        reg._timings.clear()
        reg._exemplars.clear()


@pytest.fixture(autouse=True)
def pristine():
    """Both packages' global registries, rings, dispatch-phase aggregates,
    tracers and profile rings start empty."""
    for st, fr, tr, pr, sk in (
            (stats_mod, flightrec, tracing, profile_mod, stacked),
            (ref_stats, ref_flightrec, ref_tracing, ref_profile,
             ref_stacked)):
        _reset_registry(st.global_stats)
        fr.configure(fr.DEFAULT_RING_SIZE)
        tr.set_tracer(None)
        pr.clear_recent()
        sk.reset_global_dispatch_phases()
    yield
    for fr, tr in ((flightrec, tracing), (ref_flightrec, ref_tracing)):
        fr.stop_watchdog()
        tr.set_tracer(None)


def _port(tmp_path, *flags):
    return start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path), "--device", "cpu", *flags])


def _seed_groupby(c, index="gp", n_shards=3, n=300, seed=7):
    """Two set fields with bits spread across n_shards shards (over
    HTTP, so both packages' servers take the same requests)."""
    c.create_index(index)
    c.create_field(index, "a")
    c.create_field(index, "b")
    rng = np.random.default_rng(seed)
    cols = rng.choice(n_shards * SHARD_WIDTH, size=n, replace=False)
    ra = rng.integers(0, 5, size=n)
    rb = rng.integers(0, 4, size=n)
    c.import_bits(index, "a", ra.tolist(), cols.tolist())
    c.import_bits(index, "b", rb.tolist(), cols.tolist())
    return cols


def _walk(node):
    yield node
    for child in node["children"]:
        yield from _walk(child)


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*='
    r'"(?:[^"\\\n]|\\.)*",?)*)\})?'
    r' (?P<value>[-+.0-9eE]+|\+Inf|NaN)$')

_TYPE_RE = re.compile(
    r"^# TYPE (?P<family>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r" (?:counter|gauge|histogram)$")


def _parse_prometheus(text):
    samples, families = {}, []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            assert m, f"malformed comment line: {line!r}"
            families.append(m.group("family"))
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        samples[(m.group("name"), m.group("labels") or "")] = \
            float(m.group("value"))
    return samples, families


def _histogram_series(samples, family, label_filter):
    buckets = []
    count = total = None
    for (name, labels), value in samples.items():
        if not all(f in labels for f in label_filter):
            continue
        if name == f"{family}_bucket":
            le = re.search(r'le="([^"]*)"', labels).group(1)
            buckets.append((float("inf") if le == "+Inf" else float(le),
                            value))
        elif name == f"{family}_count":
            count = value
        elif name == f"{family}_sum":
            total = value
    buckets.sort()
    return buckets, count, total


# ---------------------------------------------------- profiles (port alone)


def test_profile_span_tree_matches_dispatch_counters(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        cols = _seed_groupby(c)
        before = c._request("GET", "/debug/vars")["stacked"][
            "pairwise_dispatches"]
        resp = c.query("gp", "GroupBy(Rows(a), Rows(b))", profile=True)
        after = c._request("GET", "/debug/vars")["stacked"][
            "pairwise_dispatches"]
        assert resp["results"]
        prof = resp["profile"]
        assert prof["index"] == "gp"
        assert prof["query"].startswith("GroupBy")
        assert prof["duration"] > 0 and not prof["slow"]
        root = prof["spans"]
        assert root["name"] == "query"
        names = {s["name"] for s in _walk(root)}
        assert {"api.Query", "executor.Execute",
                "executor.executeGroupBy"} <= names
        kernels = [s for s in _walk(root) if s["name"] == "stacked.kernel"]
        assert kernels and all(s["duration"] is not None for s in kernels)
        assert root["duration"] >= sum(s["duration"] for s in kernels)
        pairwise = [s for s in kernels if s["tags"].get("op") == "pairwise"]
        assert after - before >= 1
        assert prof["tags"]["pairwise_dispatches"] == after - before
        assert prof["tags"]["pairwise_dispatches"] == len(pairwise)
        tags = prof["tags"]
        assert tags["shards_touched"] == \
            len({int(x) // SHARD_WIDTH for x in cols})
        assert tags["locked_dispatches"] == len(kernels)
        assert tags["kernel_wall_seconds"] >= 0
        assert tags["dispatch_lock_wait_seconds"] >= 0
        assert tags["bytes_materialized"] >= 0
        assert tags["cache_hits"] >= 0 and tags["cache_misses"] >= 0
        for s in kernels:
            assert s["tags"]["lock_wait_seconds"] >= 0
        text = c._request("GET", "/metrics").decode()
        assert 'pilosa_tpu_query_op_seconds_count{op="GroupBy"}' in text
        # the finished profile resolves by trace id afterwards
        trace = c._request("GET", f"/debug/traces/{prof['traceID']}")
        assert trace["found"] and trace["tree"][0]["name"] == "query"
    finally:
        srv.stop()


def test_profile_off_by_default(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        c.create_index("np")
        c.create_field("np", "f")
        c.query("np", "Set(1, f=10)")
        resp = c.query("np", "Count(Row(f=10))")
        assert resp == {"results": [1]}
        assert profile_mod.take_last() is None
        assert profile_mod.recent() == []
        assert not profile_mod._active
        assert tracing.current_span() is None
    finally:
        srv.stop()


def test_profile_registry_drains_after_profiled_query(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        _seed_groupby(c, index="dr", n=50)
        c.query("dr", "Count(Row(a=1))", profile=True)
        assert not profile_mod._active
        with pytest.raises(ClientError):
            c.query("dr", "Bogus(Row(a=1))", profile=True)
        assert not profile_mod._active
    finally:
        srv.stop()


def test_slow_query_logged_with_profile_and_ring(tmp_path):
    srv = _port(tmp_path)
    try:
        log = CaptureLogger()
        srv.api.long_query_time = 0.0  # everything is slow
        srv.api.logger = log
        c = Client(srv.uri)
        c.create_index("sq")
        c.create_field("sq", "f")
        c.query("sq", "Set(1, f=10)")
        c.query("sq", "Count(Row(f=10))")
        slow = [line for line in log.lines if "SLOW QUERY" in line]
        assert len(slow) == 2
        assert all("profile=" in line for line in slow)
        tree = json.loads(slow[-1].split("profile=", 1)[1])
        assert tree["spans"]["name"] == "query"
        assert tree["slow"] is True
        assert "Count" in tree["query"]
        recent = c._request("GET", "/debug/queries")
        assert [p["index"] for p in recent] == ["sq", "sq"]
        assert all(p["slow"] for p in recent)
        assert recent[0]["query"].startswith("Count")
        slow_events = [e for e in flightrec.snapshot()["events"]
                       if e["kind"] == "query.slow"]
        assert [e["tags"]["batch"] for e in slow_events] == [1, 1]
    finally:
        srv.stop()


def test_debug_queries_ring_is_bounded():
    for i in range(profile_mod.MAX_RECENT + 10):
        profile_mod.begin("ring", f"Count(Row(f={i}))").finish()
    recent = profile_mod.recent()
    assert len(recent) == profile_mod.MAX_RECENT
    assert recent[0]["query"] == \
        f"Count(Row(f={profile_mod.MAX_RECENT + 9}))"


def test_debug_traces_requires_memory_tracer(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        off = c._request("GET", "/debug/traces")
        assert off["enabled"] is False and off["spans"] == []
        tracing.set_tracer(tracing.InMemoryTracer(max_spans=50))
        c.create_index("tr")
        c.create_field("tr", "f")
        c.query("tr", "Count(Row(f=1))")
        on = c._request("GET", "/debug/traces")
        assert on["enabled"] is True and on["maxSpans"] == 50
        names = {s["name"] for s in on["spans"]}
        assert "api.Query" in names
        assert any(n.startswith("http.POST") for n in names)
        for _ in range(30):
            c.query("tr", "Count(Row(f=1))")
        assert len(c._request("GET", "/debug/traces")["spans"]) <= 50
    finally:
        srv.stop()


# -------------------------------------------------- exposition formats


def test_prometheus_escaping_and_histogram_validity():
    s = StatsClient()
    s.count("esc", 1, tags={"q": 'he said "hi"', "b": "a\\b", "n": "x\ny"})
    s.count("esc", 2, tags={"q": "plain"})
    values = (0.0002, 0.003, 0.003, 0.07, 1.5)
    for v in values:
        s.timing("lat_seconds", v, tags={"op": "x"})
    text = s.prometheus_text()
    assert '\\"hi\\"' in text and "a\\\\b" in text and "x\\ny" in text
    samples, families = _parse_prometheus(text)
    assert len(families) == len(set(families))
    buckets, count, total = _histogram_series(
        samples, "pilosa_tpu_lat_seconds", ['op="x"'])
    assert count == len(values)
    assert total == pytest.approx(sum(values))
    assert len(buckets) == len(TIMING_BUCKETS) + 1
    cum = [c for _, c in buckets]
    assert cum == sorted(cum)
    assert buckets[-1][0] == float("inf") and buckets[-1][1] == count
    by_bound = dict(buckets)
    assert by_bound[0.005] - by_bound[0.001] == 2


def test_expvar_quantiles_move_with_the_data():
    s = StatsClient()
    for _ in range(50):
        s.timing("q", 0.002)
    for _ in range(50):
        s.timing("q", 9.0)
    t = json.loads(s.expvar_json())["timings"]["q"]
    assert t["count"] == 100
    assert 0.001 <= t["p50"] <= 0.0025
    assert t["p99"] > 1.0


def test_concurrent_stats_hammer():
    s = StatsClient()
    n_threads, n_iter = 8, 300
    start = threading.Barrier(n_threads + 1)

    def work(i):
        start.wait()
        for j in range(n_iter):
            s.count("ham_c", 1, tags={"w": str(i % 2)})
            s.timing("ham_t", 0.001 * (j % 7))
            s.gauge("ham_g", j)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()

    def total_of(data):
        return sum(v for k, v in data["counters"].items()
                   if k.startswith("ham_c"))

    last = 0
    for _ in range(25):
        _, families = _parse_prometheus(s.prometheus_text())
        assert len(families) == len(set(families))
        total = total_of(json.loads(s.expvar_json()))
        assert total >= last
        last = total
    for t in threads:
        t.join()
    data = json.loads(s.expvar_json())
    assert total_of(data) == n_threads * n_iter
    assert data["timings"]["ham_t"]["count"] == n_threads * n_iter


def test_per_route_request_metrics(tmp_path):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.http_server import PilosaHTTPServer

    holder = Holder(str(tmp_path)).open()
    reg = StatsClient()
    srv = PilosaHTTPServer(API(holder, device="cpu"), host="127.0.0.1",
                           port=0, stats=reg).start()
    try:
        c = Client(srv.uri)
        c.create_index("i")
        c.create_field("i", "f")
        c.query("i", "Count(Row(f=1))")
        with pytest.raises(ClientError):
            c._request("GET", "/definitely/not/a/route")
        qlabels = ('method="POST",route="/index/(?P<index>[^/]+)/query",'
                   'status="200"')
        deadline = time.time() + 2.0
        while True:
            samples, _ = _parse_prometheus(reg.prometheus_text())
            try:
                assert samples[("pilosa_tpu_http_request_seconds_count",
                                qlabels)] == 1
                assert samples[
                    ("pilosa_tpu_http_errors_total",
                     'method="GET",route="unmatched",status="404"')] == 1
                break
            except (KeyError, AssertionError):
                if time.time() > deadline:
                    raise
                time.sleep(0.01)
        assert ("pilosa_tpu_http_errors_total", qlabels) not in samples
    finally:
        srv.stop()
        holder.close()


def test_runtime_monitor_clean_shutdown():
    reg = StatsClient()
    mon = RuntimeMonitor(reg, interval=1.0)
    before = {t.ident for t in threading.enumerate()}
    mon.start()
    assert mon._thread.is_alive()
    mon.stop()
    assert not mon._thread.is_alive()
    assert not ({t.ident for t in threading.enumerate()} - before)
    _, gauges, _ = reg.snapshot()
    assert {"uptime_seconds", "threads"} <= {name for name, _ in gauges}


# ---------------------------------------------- dispatch phases and locks


def _phase_sums_match_walls(ev):
    phases, walls = ev.dispatch_phases(), ev.kernel_walls()
    assert set(phases) == set(walls)
    for kind, fam in phases.items():
        assert set(fam) <= set(stacked.DISPATCH_PHASES), (kind, fam)
        total = sum(p["seconds"] for name, p in fam.items()
                    if name != "lock_wait")
        assert total == pytest.approx(walls[kind]["seconds"], rel=1e-9,
                                      abs=1e-12), kind
        # one lock_wait per locked dispatch
        assert fam["lock_wait"]["count"] == walls[kind]["count"], kind


def test_phase_seconds_sum_to_each_family_wall(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        _seed_groupby(c, index="ph")
        c.create_field("ph", "v", {"type": "int", "min": 0, "max": 1000})
        c.import_values("ph", "v", [1, 2, SHARD_WIDTH + 3], [5, 9, 700])
        pql = ["Count(Intersect(Row(a=1), Row(b=2)))", "TopN(a, n=3)",
               "GroupBy(Rows(a), Rows(b))", "Sum(Row(a=1), field=v)",
               "Max(field=v)", "Count(Row(v > 6))",
               "Count(Shift(Row(a=2), n=3))"]
        for q in pql:
            resp = c.query("ph", q, profile=True)
            tags = resp["profile"]["tags"]
            phase_total = sum(v for k, v in tags.items()
                              if k.startswith("phase_"))
            assert phase_total == pytest.approx(
                tags["kernel_wall_seconds"], rel=1e-9, abs=1e-12), q
        c.query("ph", "Set(7, a=1)")
        c.query("ph", "Count(Intersect(Row(a=1), Row(b=2)))")  # a patch
        ev = srv.api.executor._stacked
        _phase_sums_match_walls(ev)
        fams = set(ev.dispatch_phases())
        assert {"count", "row_counts", "pairwise", "sum", "minmax",
                "filter", "bsi_condition", "shift", "patch"} <= fams
        # the fetches are timed as sync, after the lock was released
        for kind in ("count", "row_counts", "pairwise", "sum", "minmax"):
            assert ev.dispatch_phases()[kind]["sync"]["count"] >= 1
        served = c._request("GET", "/debug/dispatch")["phases"]
        assert served == json.loads(json.dumps(ev.dispatch_phases()))
        assert stacked.global_dispatch_phases().keys() >= fams
    finally:
        srv.stop()


def test_batched_paths_attribute_their_families(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        _seed_groupby(c, index="bq")
        out = c._request("POST", "/index/bq/query-batch", json.dumps(
            {"queries": ["Count(Row(a=1))", "Count(Row(a=2))",
                         "Row(b=1)", "Row(b=2)"]}).encode())
        assert all("results" in r for r in out["results"])
        ev = srv.api.executor._stacked
        _phase_sums_match_walls(ev)
        phases = ev.dispatch_phases()
        assert phases["count_batched"]["lock_wait"]["count"] == 1
        assert phases["plane_batched"]["lock_wait"]["count"] == 1
        kinds = [e["tags"]["kernel"] for e in flightrec.snapshot()["events"]
                 if e["kind"] == "batch.dispatch"]
        assert sorted(kinds) == ["count_batched", "plane_batched"]
    finally:
        srv.stop()


def test_no_fetch_under_the_dispatch_lock(tmp_path, monkeypatch):
    """Every device->host fetch runs with the dispatch lock free, so a
    concurrent query can launch meanwhile."""
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        _seed_groupby(c, index="lk")
        held = []
        lock = stacked._DISPATCH_LOCK
        real_fetch = stacked.StackedEvaluator._fetch
        real_sync = stacked.StackedEvaluator._timed_sync

        def fetch(self, values):
            held.append(lock.locked())
            return real_fetch(self, values)

        def timed_sync(self, kind):
            held.append(lock.locked())
            return real_sync(self, kind)

        monkeypatch.setattr(stacked.StackedEvaluator, "_fetch", fetch)
        monkeypatch.setattr(stacked.StackedEvaluator, "_timed_sync",
                            timed_sync)
        for q in ("Count(Row(a=1))", "TopN(a, n=2)",
                  "GroupBy(Rows(a), Rows(b))"):
            c.query("lk", q)
        assert held and not any(held)
    finally:
        srv.stop()


def test_dispatch_route_counts_one_lock_wait_per_count(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        _seed_groupby(c, index="dc")
        c.query("dc", "Count(Row(a=1))")

        def n_count():
            phases = c.debug_dispatch()["phases"]
            return phases.get("count", {}).get("lock_wait", {}).get(
                "count", 0)

        before = n_count()
        for r in range(4):
            c.query("dc", f"Count(Intersect(Row(a={r}), Row(b=1)))")
        assert n_count() == before + 4
        kinds = [e["kind"] for e in c.debug_flightrecorder()["events"]]
        assert kinds.count("dispatch.start") == kinds.count("dispatch.end")
    finally:
        srv.stop()


# --------------------------------------------------- debug routes, flags


def test_debug_routes(tmp_path):
    srv = _port(tmp_path)
    try:
        c = Client(srv.uri)
        listed = {e["path"] for e in c._request("GET", "/debug")["endpoints"]}
        for path in ("/debug/vars", "/debug/queries", "/debug/traces",
                     "/debug/dispatch", "/debug/flightrecorder",
                     "/debug/threads", "/debug/pprof/goroutine",
                     "/debug/batching", "/debug/oplog",
                     "/debug/faultpoints", "/debug/hbm", "/debug/device",
                     "/debug/workload", "/debug/heat", "/debug/slo",
                     "/debug/incidents", "/debug/kernels", "/debug/plans",
                     "/debug/optimizer", "/debug/ingest"):
            assert path in listed
            c._request("GET", path)  # every listed GET route answers
        threads = c._request("GET", "/debug/threads").decode()
        assert "pilosa-http" in threads
        c._request("POST", "/debug/pprof/profile/start?interval=0.001",
                   b"")
        with pytest.raises(ClientError):
            c._request("POST", "/debug/pprof/profile/start", b"")
        time.sleep(0.05)
        out = c._request("POST", "/debug/pprof/profile/stop", b"").decode()
        assert out.startswith("samples: ")
        with pytest.raises(ClientError):
            c._request("POST", "/debug/pprof/profile/stop", b"")
        with pytest.raises(ClientError) as e:
            c._request("GET", "/debug/flightrecorder?bogus=1")
        assert e.value.status == 400
    finally:
        srv.stop()


def test_server_flags(tmp_path):
    from pilosa_tpu_torch.utils import workpool

    old_pool = workpool.get_pool()
    srv = _port(tmp_path, "--long-query-time", "0s", "--stats", "local",
                "--tracing", "memory", "--metrics-exemplars",
                "--flight-recorder-size", "64", "--watchdog-deadline",
                "30s", "--workers", "3", "--statsd-host", "127.0.0.1:9")
    try:
        assert srv.api.long_query_time == 0.0
        assert isinstance(tracing.get_tracer(), tracing.InMemoryTracer)
        assert flightrec.get_recorder().size == 64
        assert flightrec.get_watchdog() is srv.watchdog
        assert srv.watchdog.deadline == 30.0
        assert workpool.worker_count() == 3
        c = Client(srv.uri)
        _seed_groupby(c, index="fl", n=20)
        c.query("fl", "Count(Row(a=1))")
        text = c._request("GET", "/metrics").decode()
        assert "# {trace_id=" in text  # exemplars on
    finally:
        srv.stop()
        workpool.configure(old_pool.workers)
        stats_mod.configure_exemplars(False)
    assert flightrec.get_watchdog() is None  # stopped with its server


def test_config_prints_the_observability_flags():
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch", "config",
         "--long-query-time", "2s", "--tracing", "memory", "--workers",
         "4", "--flight-recorder-size", "128", "--watchdog-deadline",
         "1m", "--metrics-exemplars"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for line in ('long-query-time = "2s"', 'tracing = "memory"',
                 "workers = 4", "flight-recorder-size = 128",
                 'watchdog-deadline = "1m"', "metrics-exemplars = true"):
        assert line in proc.stdout, proc.stdout


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(data, port):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device",
         "cpu", "--bind", f"127.0.0.1:{port}", "--data-dir", data],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    uri = f"http://127.0.0.1:{port}"
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            Client(uri, timeout=2, retries=0).info()
            return proc, Client(uri)
        except Exception:  # noqa: BLE001 — still booting
            if proc.poll() is not None:
                raise AssertionError(proc.communicate()[1])
            time.sleep(0.2)
    proc.kill()
    raise AssertionError("server did not come up")


def test_sigterm_dumps_and_stops_cleanly(tmp_path):
    """SIGTERM to a server child dumps the flight recorder AND runs the
    clean stop (the oplog's shutdown checkpoint): the next boot replays
    nothing. A SIGKILL, the control, leaves records to replay."""
    data = str(tmp_path / "data")
    port = _free_port()
    proc, c = _boot(data, port)
    c.create_index("i")
    c.create_field("i", "f")
    c.import_bits("i", "f", [1, 1], [3, SHARD_WIDTH + 4])
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "flightrec dump (SIGTERM)" in err
    assert "cache.put" in err or "flight recorder tail" in err
    proc, c = _boot(data, port)
    try:
        assert c.query("i", "Count(Row(f=1))")["results"] == [2]
        c.import_bits("i", "f", [1], [9])
    finally:
        proc.kill()
        out, _ = proc.communicate(timeout=60)
    assert "oplog: replayed" not in out
    proc, c = _boot(data, port)  # after the SIGKILL: the control
    try:
        assert c.query("i", "Count(Row(f=1))")["results"] == [3]
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    assert "oplog: replayed 1 record(s)" in out


# ---------------------------------------- server level: port vs reference


@pytest.fixture
def pair(tmp_path):
    """The TPU package's server as its `server` command runs it (an oplog
    and a runtime sampler beside the in-process harness) and the port's."""
    from pilosa_tpu.storage.oplog import OpLog

    oplog = OpLog(str(tmp_path / "ref-oplog")).open()
    ref = ServerHarness(data_dir=str(tmp_path / "ref"), oplog=oplog)
    monitor = ref_stats.RuntimeMonitor(ref_stats.global_stats).start()
    port = _port(tmp_path / "port")
    try:
        yield ref, port
    finally:
        port.stop()
        monitor.stop()
        ref.close()
        oplog.close()


DIFF_PQL = ["Count(Intersect(Row(a=1), Row(b=2)))", "TopN(a, n=3)",
            "GroupBy(Rows(a), Rows(b))", "Count(Row(a=3))"]

#: profile tags of the TPU package's that the port does not write:
#: compile (a JAX program's first call; the port's kernels are built
#: before their first launch)
LATER_TAGS = {"phase_compile_seconds"}


def _span_names(prof):
    return {s["name"] for s in _walk(prof["spans"])}


def _tag_keys(span):
    return {k for k in span["tags"] if not k.startswith("phase_")}


def test_profiles_equal_to_reference(pair):
    ref, port = pair
    clients = (ref.client, Client(port.uri))
    for c in clients:
        _seed_groupby(c, index="d")
    for q in DIFF_PQL:
        want, got = (c.query("d", q, profile=True) for c in clients)
        assert got["results"] == want["results"], q
        assert _span_names(got["profile"]) == _span_names(want["profile"]), q
        ref_keys = set(want["profile"]["tags"]) - LATER_TAGS
        port_keys = set(got["profile"]["tags"])
        assert {k for k in port_keys if not k.startswith("phase_")} \
            == {k for k in ref_keys if not k.startswith("phase_")}, q
        assert set(got["profile"]) == set(want["profile"])
        for name in ("api.Query", "executor.Execute", "stacked.kernel"):
            # span tag keys; the phases differ by design (see LATER_TAGS
            # and the port's sync outside the lock)
            assert [_tag_keys(s) for s in _walk(got["profile"]["spans"])
                    if s["name"] == name][:1] \
                == [_tag_keys(s) for s in _walk(want["profile"]["spans"])
                    if s["name"] == name][:1], (q, name)


def _families(text):
    return {m.group("family") for m in map(_TYPE_RE.match,
                                           text.splitlines()) if m}


def test_metrics_names_equal_to_reference(pair):
    ref, port = pair
    clients = (ref.client, Client(port.uri))
    for c in clients:
        _seed_groupby(c, index="m")
        for q in DIFF_PQL:
            c.query("m", q)
        with pytest.raises(Exception):
            c._request("GET", "/nope")
    time.sleep(0.2)  # request metrics land after the response is sent
    want, got = (_families(c._request("GET", "/metrics").decode())
                 for c in clients)
    assert got == want, (got - want, want - got)
    for name in ("pilosa_tpu_http_request_seconds",
                 "pilosa_tpu_http_errors_total",
                 "pilosa_tpu_query_op_seconds", "pilosa_tpu_kernel_seconds",
                 "pilosa_tpu_dispatch_phase_seconds",
                 "pilosa_tpu_hbm_stack_bytes"):
        assert name in got


def test_slow_query_line_fields_equal_to_reference(pair):
    ref, port = pair
    logs = (CaptureLogger(), CaptureLogger())
    for api, log in ((ref.api, logs[0]), (port.api, logs[1])):
        api.long_query_time = 0.0
        api.logger = log
    clients = (ref.client, Client(port.uri))
    for c in clients:
        c.create_index("s")
        c.create_field("s", "f")
        c.query("s", "Set(1, f=10)")
        c.query("s", "Count(Row(f=10))")

    def fields(line):
        head, _, prof = line.partition(" profile=")
        keys = re.findall(r" ([a-z]+)=", head)
        return keys, json.loads(prof)

    for want, got in zip(*(
            [line for line in log.lines if "SLOW QUERY" in line]
            for log in logs)):
        (wkeys, wprof), (gkeys, gprof) = fields(want), fields(got)
        assert gkeys == wkeys
        assert got.split(" ", 3)[1:3] == want.split(" ", 3)[1:3]
        assert set(gprof) == set(wprof)
        for key in ("index", "query", "slow"):
            assert gprof[key] == wprof[key]
        assert re.search(r" batch=1 ", got) and re.search(r" batch=1 ",
                                                          want)
    events = [[e["tags"] for e in mod.snapshot()["events"]
               if e["kind"] == "query.slow"]
              for mod in (ref_flightrec, flightrec)]
    assert [set(t) for t in events[1]] == [set(t) for t in events[0]]
    assert [t["pql"] for t in events[1]] == [t["pql"] for t in events[0]]


def test_obs_cost_tool_prints_every_piece():
    """tools/obs_cost.py, which times the hot path's pieces on a host,
    runs on the CPU and prints one line per piece."""
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.tools.obs_cost",
         "--calls", "20"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 8 and all(line.endswith(" us") for line in lines)
    assert lines[5].startswith("locked launch bookkeeping")


def _walk_spans(node):
    out = [node]
    for c in node.get("children", []):
        out.extend(_walk_spans(c))
    return out


def test_cluster_fanout_node_spans_and_profile():
    """A fan-out query through the non-owner of a 2-node cluster gives
    one `cluster.mapReduce.node` span per target node on the
    coordinator's trace, and its ?profile=true profile holds them with
    their timings, on the port's cluster as on the TPU package's."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    out = []
    for harness, tr in ((JaxClusterHarness, ref_tracing),
                        (ClusterHarness, tracing)):
        t = tr.InMemoryTracer()
        tr.set_tracer(t)
        c = harness(2)
        try:
            c[0].client.create_index("cf")
            c[0].client.create_field("cf", "f")
            c[0].client.import_bits("cf", "f", [3, 3], [1, SHARD_WIDTH + 1])
            non_owner = c.non_owner_of("cf", 0)
            t.clear()
            resp = non_owner.client.query("cf", "Count(Row(f=3))",
                                          profile=True)
            node_spans = t.find("cluster.mapReduce.node")
            assert node_spans
            assert len({s.trace_id for s in node_spans}) == 1
            assert all(s.duration is not None for s in node_spans)
            prof = resp["profile"]
            prof_nodes = [s for s in _walk_spans(prof["spans"])
                          if s["name"] == "cluster.mapReduce.node"]
            assert len(prof_nodes) == len(node_spans)
            assert prof["duration"] >= max(s["duration"]
                                           for s in prof_nodes)
            out.append((resp["results"], len(node_spans),
                        sorted(bool(s.tags.get("remote"))
                               for s in node_spans)))
        finally:
            tr.set_tracer(None)
            c.close()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1][0] == [2] and True in out[1][2]
