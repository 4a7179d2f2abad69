"""The port's flight recorder and watchdog against the TPU package's, on
the CPU.

Ported from tests/test_flightrec.py: the ring (drops, limits, a
disabled ring, a thread hammer), the stall watchdog (synthetic stalls,
its thread, its dump), the stack cache's events and cause-tagged
eviction counters with an exact byte ledger under randomized puts,
evictions and invalidations, per-family kernel attribution through a
real Count, the /debug/flightrecorder route, the http.5xx event, the
bare debug server, the runtime sampler's scrape-time age gauge and the
SIGTERM dump. Differential: the same seeded event sequence recorded by
both packages' rings gives equal snapshots once timestamps are dropped,
and a synthetic stall gives the same event. Also ported: the HBM
snapshot after a query, /debug/hbm (its total equal to the pools' byte
counters; no headroom on the CPU, where no card is initialized) and
/status's observability block; a watchdog trip writes an incident
bundle; and /debug/kernels with its declared kernel costs (the port's
stand-in for the TPU package's XLA cost analysis).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.utils import flightrec as ref_flightrec  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.exec import stacked  # noqa: E402
from pilosa_tpu_torch.server import Client, ClientError  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils import flightrec  # noqa: E402
from pilosa_tpu_torch.utils.logger import CaptureLogger  # noqa: E402
from pilosa_tpu_torch.utils.stats import StatsClient, global_stats  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Every test gets its own rings (both packages'); defaults restored."""
    for mod in (flightrec, ref_flightrec):
        mod.configure(mod.DEFAULT_RING_SIZE)
    yield
    for mod in (flightrec, ref_flightrec):
        mod.stop_watchdog()
        mod.configure(mod.DEFAULT_RING_SIZE)


# ------------------------------------------------------------------- ring


def test_ring_records_and_snapshots():
    rec = flightrec.FlightRecorder(size=8)
    rec.record("dispatch.start", {"kernel": "count"})
    rec.record("dispatch.end", {"kernel": "count"})
    snap = rec.snapshot()
    assert snap["size"] == 8
    assert snap["total_events"] == 2
    assert snap["dropped"] == 0
    assert [e["kind"] for e in snap["events"]] == [
        "dispatch.start", "dispatch.end"]
    assert snap["events"][0]["tags"] == {"kernel": "count"}
    assert snap["events"][0]["seq"] == 1
    assert snap["events"][0]["ts"] <= time.time()


def test_ring_drops_oldest_and_counts():
    rec = flightrec.FlightRecorder(size=4)
    for i in range(10):
        rec.record("e", {"i": i})
    snap = rec.snapshot()
    assert snap["total_events"] == 10
    assert snap["dropped"] == 6
    assert rec.dropped == 6
    assert [e["tags"]["i"] for e in snap["events"]] == [6, 7, 8, 9]
    assert [e["tags"]["i"]
            for e in rec.snapshot(limit=2)["events"]] == [8, 9]


def test_disabled_recorder_is_inert():
    rec = flightrec.configure(0)
    assert not rec.enabled
    flightrec.record("x", a=1)
    assert flightrec.snapshot()["events"] == []
    assert flightrec.snapshot()["total_events"] == 0


def test_ring_thread_safety_hammer():
    rec = flightrec.configure(256)
    n_threads, per_thread = 8, 500

    def pound(t):
        for i in range(per_thread):
            flightrec.record("hammer", thread=t, i=i)

    threads = [threading.Thread(target=pound, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = rec.snapshot()
    assert snap["total_events"] == n_threads * per_thread
    assert len(snap["events"]) == 256
    seqs = [e["seq"] for e in snap["events"]]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_format_tail_and_stacks_are_strings():
    flightrec.record("x", a=1)
    tail = flightrec.get_recorder().format_tail()
    assert "flight recorder tail" in tail and "x a=1" in tail
    stacks = flightrec.format_all_stacks()
    assert "thread" in stacks and "test_torch_flightrec" in stacks


def _strip_ts(snap):
    snap = dict(snap)
    snap["events"] = [{k: v for k, v in e.items() if k != "ts"}
                      for e in snap["events"]]
    return snap


@pytest.mark.parametrize("size", [0, 16, 2048])
def test_ring_snapshots_equal(size):
    rng = np.random.default_rng(size)
    kinds = ["dispatch.start", "dispatch.end", "cache.put", "cache.evict",
             "oplog.rotate", "query.slow"]
    for mod in (flightrec, ref_flightrec):
        mod.configure(size)
    for _ in range(300):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        tags = {"kernel": "count", "n": int(rng.integers(0, 100)),
                "pool": ["stack", "rows"][int(rng.integers(0, 2))]}
        for mod in (flightrec, ref_flightrec):
            mod.record(kind, **tags)
    for limit in (None, 0, 5, 5000):
        assert _strip_ts(flightrec.snapshot(limit=limit)) \
            == _strip_ts(ref_flightrec.snapshot(limit=limit))

    def tail(mod):  # the log dump's lines, timestamps dropped
        return [re.sub(r"^(  #\d+) \S+ ", r"\1 ", line)
                for line in mod.get_recorder().format_tail().splitlines()]

    assert tail(flightrec) == tail(ref_flightrec)


# --------------------------------------------------------------- watchdog


def test_watchdog_trips_synthetic_stall():
    wd = flightrec.Watchdog(deadline=0.05)  # not started: check() driven
    token = wd.begin_op("dispatch.synthetic", index="i")
    assert wd.check() == []
    time.sleep(0.08)
    tripped = wd.check()
    assert len(tripped) == 1 and tripped[0].kind == "dispatch.synthetic"
    assert wd.stalls == 1
    assert wd.check() == []
    assert wd.stalls == 1
    wd.end_op(token)
    events = [e for e in flightrec.snapshot()["events"]
              if e["kind"] == "watchdog.stall"]
    assert len(events) == 1
    tags = events[0]["tags"]
    assert tags["kind"] == "dispatch.synthetic"
    assert tags["index"] == "i"
    assert tags["running_seconds"] >= 0.05


def test_stall_event_equal_to_reference():
    """The same synthetic stall gives the same event in both rings (but
    for the thread name and the measured seconds)."""
    ops = []
    for mod in (flightrec, ref_flightrec):
        wd = mod.Watchdog(deadline=0.01, logger=CaptureLogger())
        ops.append((mod, wd, wd.begin_op("dispatch.count", index="i")))
    time.sleep(0.03)
    now = time.monotonic()
    for mod, wd, token in ops:
        wd.check(now=now)
        wd.end_op(token)
    events = [[e for e in mod.snapshot()["events"]
               if e["kind"] == "watchdog.stall"] for mod, _, _ in ops]
    got, want = ({k: v for k, v in evs[0]["tags"].items()
                  if k not in ("running_seconds", "thread")}
                 for evs in events)
    assert got == want


def test_watchdog_no_trip_inside_deadline():
    wd = flightrec.Watchdog(deadline=30.0)
    token = wd.begin_op("quick")
    assert wd.check() == []
    wd.end_op(token)
    time.sleep(0.02)
    assert wd.check() == [] and wd.stalls == 0


def test_watchdog_stall_dumps_tail_and_stacks():
    log = CaptureLogger()
    wd = flightrec.Watchdog(deadline=0.01, logger=log)
    flightrec.record("breadcrumb", step=7)
    wd.begin_op("wedged")
    time.sleep(0.03)
    wd.check()
    dump = "\n".join(log.lines)
    assert "WATCHDOG STALL" in dump
    assert "flight recorder tail" in dump and "breadcrumb" in dump
    assert "thread" in dump


def test_watchdog_thread_trips_without_manual_check():
    wd = flightrec.configure_watchdog(0.05, logger=CaptureLogger())
    assert flightrec.get_watchdog() is wd
    token = flightrec.watch_begin("stuck_dispatch")
    assert token is not None
    deadline = time.time() + 5
    while not wd.stalls and time.time() < deadline:
        time.sleep(0.01)
    flightrec.watch_end(token)
    assert wd.stalls >= 1
    counters, _, _ = global_stats.snapshot()
    assert [k for k in counters if k[0] == "watchdog_stalls"]
    flightrec.stop_watchdog()
    assert flightrec.get_watchdog() is None


def test_watch_begin_none_without_watchdog():
    flightrec.stop_watchdog()
    token = flightrec.watch_begin("anything")
    assert token is None
    flightrec.watch_end(token)


def test_watchdog_rejects_bad_deadline():
    with pytest.raises(ValueError):
        flightrec.Watchdog(deadline=0)


# --------------------------------------------- stack cache: ledger, events


def _assert_ledger_exact(ev):
    for pool in ("leaf", "rows"):
        entries = ev._pools[pool]
        assert ev._pool_bytes[pool] == sum(e[2] for e in entries.values())
        assert sum(ev.hbm_ledger(pool).values()) == ev._pool_bytes[pool]
        want = {}
        for key, e in entries.items():
            want[(key[1], key[2])] = want.get((key[1], key[2]), 0) + e[2]
        assert ev.hbm_ledger(pool) == want


def test_hbm_ledger_exact_under_randomized_stress(monkeypatch):
    monkeypatch.setattr(stacked, "MAX_STACK_BYTES", 4096)
    monkeypatch.setattr(stacked, "MAX_ROWS_STACK_BYTES", 2048)
    ev = stacked.StackedEvaluator("cpu")
    rng = np.random.default_rng(99)
    for step in range(2000):
        roll = rng.integers(0, 100)
        idx = ["i0", "i1", "i2"][int(rng.integers(0, 3))]
        fld = ["f0", "f1"][int(rng.integers(0, 2))]
        if roll < 2:
            ev.invalidate()
        elif roll < 50:
            key = ("leaf", idx, fld, int(rng.integers(0, 6)), (0, 1))
            ev._cache_put(key, (("g", step),), object(),
                          int(rng.integers(1, 900)), stamp=("s", step))
        else:
            key = ("rows", idx, fld, "standard",
                   int(rng.integers(0, 4)), (0, 1))
            ev._cache_put(key, (("g", step),), object(),
                          int(rng.integers(1, 600)), stamp=("s", step))
        if step % 50 == 0:
            _assert_ledger_exact(ev)
    _assert_ledger_exact(ev)
    assert sum(ev._pool_evictions.values()) > 0
    assert any(c == "budget" for (_, c) in ev.pool_evictions)


def test_eviction_counters_by_pool_and_cause(monkeypatch):
    monkeypatch.setattr(stacked, "MAX_STACK_BYTES", 1000)
    ev = stacked.StackedEvaluator("cpu")
    for i in range(4):
        ev._cache_put(("leaf", "i", "f", i, (0,)), ("g",), object(), 400)
    assert ev.pool_evictions[("stack", "budget")] >= 1
    assert ev.cache_stats()["evictions_by_cause"]["stack.budget"] >= 1
    ev.invalidate()
    assert ev.pool_evictions[("stack", "invalidate")] >= 1
    assert ev._pool_bytes["leaf"] == 0 and ev._hbm_ledger == {}
    text = global_stats.prometheus_text()
    assert 'pilosa_tpu_stacked_evictions_total{' in text
    assert 'cause="budget"' in text and 'cause="invalidate"' in text
    assert 'pilosa_tpu_hbm_stack_bytes{' in text


def test_cache_events_recorded(monkeypatch):
    monkeypatch.setattr(stacked, "MAX_STACK_BYTES", 500)
    ev = stacked.StackedEvaluator("cpu")
    ev._cache_put(("leaf", "idx", "fld", 1, (0,)), ("g",), object(), 400)
    ev._cache_put(("leaf", "idx", "fld", 2, (0,)), ("g",), object(), 400)
    kinds = [e["kind"] for e in flightrec.snapshot()["events"]]
    assert kinds.count("cache.put") == 2
    assert "cache.evict" in kinds
    evict = [e for e in flightrec.snapshot()["events"]
             if e["kind"] == "cache.evict"][0]
    assert evict["tags"] == {"pool": "stack", "index": "idx",
                             "field": "fld", "bytes": 400,
                             "cause": "budget"}
    ev.invalidate()
    inv = [e for e in flightrec.snapshot()["events"]
           if e["kind"] == "cache.invalidate"]
    assert inv[-1]["tags"] == {"stack_entries": 1, "rows_entries": 0}


def test_cache_events_equal_to_reference(monkeypatch):
    """The same puts into both packages' evaluators record the same
    cache events (the port's leaf pool is the TPU package's "stack")."""
    from pilosa_tpu.exec import stacked as ref_stacked

    monkeypatch.setattr(stacked, "MAX_STACK_BYTES", 1000)
    monkeypatch.setattr(ref_stacked, "MAX_STACK_BYTES", 1000)
    monkeypatch.setattr(stacked, "MAX_ROWS_STACK_BYTES", 700)
    monkeypatch.setattr(ref_stacked, "MAX_ROWS_STACK_BYTES", 700)
    evs = [stacked.StackedEvaluator("cpu"), ref_stacked.StackedEvaluator()]
    rng = np.random.default_rng(12)
    for step in range(60):
        if rng.random() < 0.5:
            key = ("leaf", "i", f"f{int(rng.integers(0, 2))}",
                   int(rng.integers(0, 5)), (0, 1))
        else:
            key = ("rows", "i", "f0", "standard",
                   int(rng.integers(0, 3)), (0, 1))
        nbytes = int(rng.integers(1, 500))
        for ev in evs:
            ev._cache_put(key, (("g", step),), object(), nbytes)
    for ev in evs:
        ev.invalidate()
    got, want = (_strip_ts(mod.snapshot())["events"]
                 for mod in (flightrec, ref_flightrec))
    assert got == want
    assert evs[0].pool_evictions == evs[1].pool_evictions


# ------------------------------------------------- kernel attribution


def test_note_kernel_and_walls():
    ev = stacked.StackedEvaluator("cpu")
    ev._note("count", [("lock_wait", 0.0), ("dispatch_ack", 0.01)], 0.01,
             1024, 8)
    ev._note("count", [("lock_wait", 0.0), ("dispatch_ack", 0.02)], 0.02,
             1024, 8)
    k = ev.kernel_walls()["count"]
    assert k["count"] == 2
    assert k["seconds"] == pytest.approx(0.03)
    assert k["bytes_in"] == 2048 and k["bytes_out"] == 16
    text = global_stats.prometheus_text()
    assert 'pilosa_tpu_kernel_seconds_count{kernel="count"}' in text
    assert 'pilosa_tpu_kernel_bytes_in_total{kernel="count"}' in text


def test_dispatch_instruments_kernels(tmp_path):
    """A real Count through the executor attributes its launch and
    records dispatch.start/end with the lock-wait and wall split."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor

    holder = Holder(str(tmp_path)).open()
    try:
        idx = holder.create_index("ka")
        idx.create_field("f")
        idx.field("f").import_bits(
            np.array([1, 1, 1], dtype=np.uint64),
            np.array([5, 9, SHARD_WIDTH + 40], dtype=np.uint64))
        ex = Executor(holder, device="cpu")
        assert ex.execute("ka", "Count(Row(f=1))")[0] == 3
        kernels = ex._stacked.kernel_walls()
        assert kernels["count"]["count"] == 1
        assert kernels["count"]["bytes_in"] > 0
        events = flightrec.snapshot()["events"]
        kinds = [e["kind"] for e in events]
        assert "dispatch.start" in kinds and "dispatch.end" in kinds
        end = [e for e in events if e["kind"] == "dispatch.end"][-1]
        assert end["tags"]["kernel"] == "count"
        assert end["tags"]["kernel_wall_seconds"] >= 0
        assert end["tags"]["lock_wait_seconds"] >= 0
        # the declared costs: computed on request, cached, never raise
        st = ex._stacked
        assert st.kernels_snapshot(include_costs=False)["kernels"] \
            == kernels
        compiled = st.kernels_snapshot()["compiled"]
        assert isinstance(compiled, list) and compiled
        assert all("family" in c and "cost" in c for c in compiled)
        assert compiled == st.kernels_snapshot()["compiled"]
    finally:
        holder.close()


# ------------------------------------------------------- /debug endpoints


@pytest.fixture
def server(tmp_path):
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path), "--device", "cpu"])
    yield srv
    srv.stop()


def _warm_query(c):
    c.create_index("dbg")
    c.create_field("dbg", "f")
    c.query("dbg", "Set(3, f=11)")
    c.query("dbg", f"Set({SHARD_WIDTH + 5}, f=11)")  # a second shard
    c.query("dbg", "Count(Row(f=11))")


def test_hbm_snapshot_entries_after_query(tmp_path):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor

    holder = Holder(str(tmp_path)).open()
    try:
        idx = holder.create_index("hb")
        idx.create_field("f")
        idx.field("f").import_bits(
            np.array([2, 2], dtype=np.uint64),
            np.array([1, SHARD_WIDTH + 7], dtype=np.uint64))
        ex = Executor(holder, device="cpu")
        ex.execute("hb", "Count(Row(f=2))")
        snap = ex._stacked.hbm_snapshot()
        assert snap["total_bytes"] > 0
        assert snap["total_bytes"] == \
            snap["stack_bytes"] + snap["rows_stack_bytes"]
        stats_ = ex.stacked_stats()
        assert snap["total_bytes"] == stats_["bytes"] + stats_["rows_bytes"]
        entry = snap["entries"][0]
        assert entry["index"] == "hb" and entry["field"] == "f"
        assert entry["bytes"] > 0 and entry["pool"] == "stack"
        assert entry["last_hit_age_seconds"] >= 0
        assert snap["by_index_field"][0]["index"] == "hb"
        assert sum(r["bytes"] for r in snap["by_index_field"]) \
            == snap["total_bytes"]
        assert snap["device_memory"] is None  # no card initialized
    finally:
        holder.close()


def test_debug_hbm_endpoint(server):
    c = Client(server.uri)
    _warm_query(c)
    snap = c._request("GET", "/debug/hbm?top=3")
    assert snap["total_bytes"] == \
        snap["stack_bytes"] + snap["rows_stack_bytes"]
    assert snap["total_bytes"] > 0
    assert len(snap["entries"]) <= 3
    assert snap["entries"][0]["index"] == "dbg"
    assert "evictions" in snap and "device_memory" in snap


def test_debug_kernels_endpoint(server):
    c = Client(server.uri)
    _warm_query(c)
    snap = c.debug_kernels(costs=False)
    assert "count" in snap["kernels"]
    assert "compiled" not in snap
    full = c.debug_kernels()
    assert isinstance(full.get("compiled"), list)


def test_status_carries_local_observability(server):
    c = Client(server.uri)
    _warm_query(c)
    node = c.status()["observability"]["local"]
    assert node["hbm"]["total_bytes"] > 0
    assert "count" in node["kernels"]
    assert node["kernels"]["count"]["count"] >= 1
    assert "oplog" in node  # the server keeps a write-ahead oplog


def test_watchdog_trip_writes_incident_bundle(tmp_path):
    """A stalled op trips the watchdog, and the trip writes a
    watchdog_stall bundle naming the op, with the open-op table."""
    from pilosa_tpu_torch.utils import incident

    mgr = incident.configure(str(tmp_path / "inc"), min_interval=0.0)
    try:
        wd = flightrec.Watchdog(deadline=0.01, logger=CaptureLogger())
        token = wd.begin_op("dispatch.count", index="i")
        time.sleep(0.03)
        wd.check()
        deadline = time.time() + 5
        while not mgr.list() and time.time() < deadline:
            time.sleep(0.02)
        wd.end_op(token)
        (meta,) = mgr.list()
        assert meta["kind"] == "watchdog_stall"
        assert meta["trigger"]["op"] == "dispatch.count"
        assert meta["trigger"]["device_link_state"] == "DISABLED"
        assert "open_ops.json" in meta["files"]
    finally:
        incident.stop()


def test_debug_flightrecorder_endpoint(server):
    c = Client(server.uri)
    _warm_query(c)
    snap = c.debug_flightrecorder()
    assert snap["size"] == flightrec.get_recorder().size
    kinds = [e["kind"] for e in snap["events"]]
    assert "dispatch.start" in kinds and "cache.put" in kinds
    assert len(c.debug_flightrecorder(limit=1)["events"]) == 1


def test_http_5xx_records_event(server):
    def boom():
        raise RuntimeError("kaboom")

    server.api.schema = boom
    with pytest.raises(ClientError):
        Client(server.uri, retries=0).schema()
    events = []
    deadline = time.time() + 5
    while not events and time.time() < deadline:
        events = [e for e in flightrec.snapshot()["events"]
                  if e["kind"] == "http.5xx"]
        if not events:
            time.sleep(0.01)
    assert events
    assert events[-1]["tags"] == {"route": "/schema", "method": "GET",
                                  "status": 500}


def test_start_debug_server_serves_ring_and_dispatch():
    flightrec.record("child.start", pid=1)
    srv = flightrec.start_debug_server()
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/flightrecorder",
                timeout=5) as resp:
            snap = json.loads(resp.read().decode())
        assert any(e["kind"] == "child.start" for e in snap["events"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/dispatch",
                timeout=5) as resp:
            assert "phases" in json.loads(resp.read().decode())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/nope", timeout=5)
    finally:
        srv.shutdown()


# -------------------------------------------------------- stats satellite


def test_runtime_monitor_sample_age_gauge():
    from pilosa_tpu_torch.utils.stats import RuntimeMonitor

    stats = StatsClient()
    mon = RuntimeMonitor(stats, interval=60)
    mon.start()
    try:
        _, gauges, _ = stats.snapshot()
        key = ("runtime_monitor_last_sample_age_seconds", ())
        assert 0 <= gauges[key] < 5
        mon.last_sample_time = time.time() - 120
        _, gauges, _ = stats.snapshot()
        assert gauges[key] >= 119
    finally:
        mon.stop()


def test_gauge_fn_errors_do_not_break_snapshot():
    stats = StatsClient()
    stats.gauge("ok", 1)
    stats.gauge_fn("bad", lambda: 1 / 0)
    _, gauges, _ = stats.snapshot()
    assert gauges[("ok", ())] == 1
    assert ("bad", ()) not in gauges


# ------------------------------------------------------------ crash handler


def test_crash_handler_dumps_on_sigterm():
    code = (
        "import signal\n"
        "from pilosa_tpu_torch.utils import flightrec\n"
        "flightrec.record('last.breadcrumb', step=42)\n"
        "flightrec.install_crash_handler()\n"
        "signal.raise_signal(signal.SIGTERM)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60, cwd=REPO, env=env)
    assert proc.returncode != 0  # the chained default handler still kills
    assert "flightrec dump (SIGTERM)" in proc.stderr
    assert "last.breadcrumb" in proc.stderr
