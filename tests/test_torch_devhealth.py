"""The port's device-link health (utils/devhealth.py) against the TPU
package's, on the CPU.

`tests/test_devhealth.py` ported: the canary prober's state machine
with hysteresis, a wedged canary's timeout handling, the lock-wait /
pure-RTT split, continuous probing, the zero-launch guarantee when the
module is never configured, readiness gating (/readyz and the query
fail-fast 503 with Retry-After), /status's device_link roll-up,
/debug/device, the dispatch-phase decomposition (GET /debug/dispatch,
a profiled query's phase tags and the EXPLAIN ANALYZE actuals'
phase_seconds), the watchdog's device_link_state tag and the bare
flightrec debug server's /debug/device.

Beside them: the same scripted canary sequence of ok, failed and
timed-out samples, stepped through `probe_once()` in both packages,
gives the same states, transitions and probe counters; the port's
default canary (a one-element `x + 1` launched under the dispatch lock
and read back) runs on the CPU device; and a process that imports
devhealth and never configures it initializes no CUDA.

Every test stops its prober, watchdog and server in a fixture; every
wait is bounded (at most a few seconds).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import devhealth, flightrec
from pilosa_tpu_torch.utils import profile as profile_mod
from pilosa_tpu_torch.utils.stats import global_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_modules():
    """Every test gets a clean prober slot and flight-recorder ring."""
    flightrec.configure(flightrec.DEFAULT_RING_SIZE)
    yield
    devhealth.stop()
    flightrec.stop_watchdog()
    flightrec.configure(flightrec.DEFAULT_RING_SIZE)
    profile_mod.take_last()


@pytest.fixture
def server(tmp_path):
    from pilosa_tpu_torch.cli import start_server
    from pilosa_tpu_torch.server import Client

    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path / "data"), "--device", "cpu"])
    try:
        yield srv, Client(srv.uri)
    finally:
        srv.stop()


def _warm_stacked(c):
    """Two-shard data so Count takes the stacked (launching) path."""
    c.create_index("dh")
    c.create_field("dh", "f")
    c.query("dh", "Set(3, f=11)")
    c.query("dh", f"Set({SHARD_WIDTH + 5}, f=11)")
    c.query("dh", "Count(Row(f=11))")


def _http(url):
    """(status, headers, body_json) — 4xx/5xx included, not raised."""
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, dict(resp.headers), \
                json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        body = e.read().decode()
        return e.code, dict(e.headers), json.loads(body) if body else None


# ------------------------------------------------------------ state machine

def test_state_machine_hysteresis_and_recovery():
    """LIVE -> DEGRADED on the 1st failure, -> DOWN on the 3rd, and back
    to LIVE only after live_after consecutive successes."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 4:
            raise RuntimeError("card gone")
        return 0.0

    p = devhealth.configure(canary=flaky, interval=0.01, deadline=2.0,
                            start=False)
    assert p.state == devhealth.LIVE
    states = []
    for _ in range(8):
        p.probe_once()
        states.append(p.state)
    assert states == ["DEGRADED", "DEGRADED", "DOWN", "DOWN", "DOWN",
                      "LIVE", "LIVE", "LIVE"]
    snap = devhealth.snapshot()
    assert [t["to"] for t in snap["transitions"]] == \
        ["DEGRADED", "DOWN", "LIVE"]
    assert snap["probes"]["error"] == 4 and snap["probes"]["ok"] == 4
    kinds = [e["kind"] for e in flightrec.snapshot()["events"]]
    assert kinds.count("devhealth.transition") == 3
    _, gauges, _ = global_stats.snapshot()
    assert gauges[("device_link_state", ())] == \
        devhealth.STATE_CODES[devhealth.LIVE]


def test_canary_timeout_and_wedged_runner():
    """A canary that never returns: the probe slot times out at the
    deadline, follow-up slots fail immediately ('still in flight'), and
    probing resumes once the wedged call finally completes."""
    release = threading.Event()

    def slow():
        release.wait(10)
        return 0.0

    p = devhealth.configure(canary=slow, interval=0.01, deadline=0.05,
                            down_after=2, start=False)
    try:
        p.probe_once()
        assert p.state == devhealth.DEGRADED
        assert p.last_sample["timeout"]
        assert p.last_sample["error"] == "canary deadline exceeded"
        assert p.last_sample["rtt_seconds"] is None
        p.probe_once()
        assert p.state == devhealth.DOWN
        assert p.last_sample["error"] == "canary still in flight"
        assert devhealth.is_down()
    finally:
        release.set()
    deadline = time.time() + 5
    while p._runner.busy and time.time() < deadline:
        time.sleep(0.01)
    p.probe_once()
    p.probe_once()
    assert p.state == devhealth.LIVE
    assert p.probes_timeout == 2 and p.probes_ok == 2


def test_sample_splits_lock_wait_from_pure_rtt():
    def canary():
        time.sleep(0.02)
        return 0.015  # of which 15ms was spent waiting on the lock

    p = devhealth.configure(canary=canary, deadline=1.0, start=False)
    p.probe_once()
    s = p.last_sample
    assert s["ok"] and not s["timeout"]
    assert s["rtt_seconds"] >= 0.02
    assert s["lock_wait_seconds"] == pytest.approx(0.015)
    assert s["pure_rtt_seconds"] == pytest.approx(
        s["rtt_seconds"] - 0.015, abs=1e-5)


def test_started_prober_probes_continuously():
    p = devhealth.configure(canary=lambda: 0.0, interval=0.01,
                            deadline=1.0)
    deadline = time.time() + 5
    while p.probes_total < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert p.probes_total >= 3
    assert p.state == devhealth.LIVE
    s = devhealth.summary()
    assert s["probes"]["ok"] >= 3
    assert s["last"]["rtt_seconds"] >= 0


def test_default_canary_on_the_cpu_device():
    """The port's default canary: `x + 1` launched under the dispatch
    lock on the executor's device and read back; the lock wait is its
    return value."""
    from pilosa_tpu_torch.exec import stacked

    assert devhealth.default_canary("cpu") >= 0.0
    p = devhealth.configure(interval=1.0, deadline=5.0, start=False,
                            device="cpu")
    p.probe_once()
    p.probe_once()
    assert p.state == devhealth.LIVE and p.probes_ok == 2
    # a held dispatch lock is lock wait, and the canary waits behind it
    stacked._DISPATCH_LOCK.acquire()
    threading.Timer(0.05, stacked._DISPATCH_LOCK.release).start()
    p.probe_once()
    assert p.last_sample["ok"]
    assert p.last_sample["lock_wait_seconds"] >= 0.03


# ------------------------------------------------------- disabled guarantee

def test_disabled_module_is_inert_and_dispatch_free():
    """Never configured: DISABLED (deliberately ready), empty snapshot,
    and the canary is NEVER invoked — zero device launches."""
    assert devhealth.state() == devhealth.DISABLED
    assert not devhealth.is_down()
    assert devhealth.summary() == {"state": devhealth.DISABLED}
    snap = devhealth.snapshot()
    assert snap["ring"] == [] and snap["transitions"] == []
    assert devhealth.get_prober() is None
    calls = []
    devhealth.configure(canary=lambda: calls.append(1) or 0.0,
                        start=False)
    time.sleep(0.05)
    assert calls == []  # built but not started: still no canary calls
    devhealth.stop()
    assert devhealth.state() == devhealth.DISABLED
    _, gauges, _ = global_stats.snapshot()
    assert gauges[("device_link_state", ())] == \
        devhealth.STATE_CODES[devhealth.DISABLED]


def test_never_configured_initializes_no_cuda():
    """A process that imports devhealth (and serves queries on the CPU)
    without configuring it loads no torch through devhealth and never
    asks torch to initialize CUDA."""
    code = r"""
import sys
from pilosa_tpu_torch.utils import devhealth
assert "torch" not in sys.modules, "devhealth imported torch"
import torch
def boom(*a, **k):
    raise AssertionError("CUDA initialization requested")
torch.cuda._lazy_init = boom
torch.cuda.init = boom
import tempfile
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.server.api import API
api = API(Holder(tempfile.mkdtemp()).open(), device="cpu")
api.create_index("i")
api.create_field("i", "f")
api.query("i", "Set(1, f=1)")
assert api.query("i", "Count(Row(f=1))") == [1]
assert devhealth.state() == devhealth.DISABLED
assert devhealth.snapshot()["ring"] == []
assert api.status()["observability"]["local"]["device_link"] \
    == {"state": "DISABLED"}
assert not torch.cuda.is_initialized()
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ------------------------------------------------------ both packages

def _scripted(script, release):
    """A canary following `script`: "ok" returns, "fail" raises, "hang"
    blocks until `release` is set."""
    steps = iter(script)

    def canary():
        step = next(steps)
        if step == "fail":
            raise RuntimeError("scripted failure")
        if step == "hang":
            release.wait(5)
        return 0.0
    return canary


@pytest.mark.parametrize("script", [
    ["ok", "fail", "ok", "fail", "fail", "fail", "ok", "ok", "ok"],
    ["fail", "hang", "ok", "ok", "fail", "ok", "ok"],
    ["ok", "ok", "hang", "ok", "fail", "ok", "ok", "ok"],
])
def test_state_machine_equal_to_reference(script):
    """The same scripted canary through probe_once() in both packages:
    the same state after every probe, the same transitions and the same
    probe counters. A hung canary times out at its deadline, and the
    next slot waits for the release first (so both sides see the same
    number of in-flight failures)."""
    pytest.importorskip("jax")
    from pilosa_tpu.utils import devhealth as jdevhealth

    outs = []
    for mod in (jdevhealth, devhealth):
        release = threading.Event()
        p = mod.DeviceLinkProber(canary=_scripted(script, release),
                                 deadline=0.05)
        states = []
        try:
            for step in script:
                p.probe_once()
                states.append(p.state)
                if step == "hang":
                    release.set()
                    deadline = time.time() + 5
                    while p._runner.busy and time.time() < deadline:
                        time.sleep(0.005)
        finally:
            release.set()
            p.stop()
        snap = p.snapshot()
        outs.append((states, [(t["from"], t["to"])
                              for t in snap["transitions"]],
                     snap["probes"],
                     [(s["ok"], s["timeout"], s["error"])
                      for s in snap["ring"]]))
    assert outs[1] == outs[0]


# -------------------------------------------------------- readiness gating

def test_readyz_flips_and_query_fails_fast(server):
    from pilosa_tpu_torch.server.api import ServiceUnavailableError

    srv, c = server
    c.create_index("dh")
    c.create_field("dh", "f")
    c.query("dh", "Set(3, f=1)")

    code, _, body = _http(srv.uri + "/readyz")
    assert code == 200 and body["device_link"] == devhealth.DISABLED

    mode = {"ok": False}

    def canary():
        if not mode["ok"]:
            raise RuntimeError("card gone")
        return 0.0

    p = devhealth.configure(canary=canary, interval=0.5, deadline=1.0,
                            start=False)
    for _ in range(3):
        p.probe_once()
    assert devhealth.state() == devhealth.DOWN

    code, headers, _ = _http(srv.uri + "/readyz")
    assert code == 503
    assert headers.get("Retry-After") == "1"
    code, _, _ = _http(srv.uri + "/healthz")
    assert code == 200

    before = srv.api.executor.stacked_stats()["dispatches"]
    with pytest.raises(ServiceUnavailableError) as ei:
        srv.api.query("dh", "Count(Row(f=1))")
    assert ei.value.status == 503
    assert ei.value.headers["Retry-After"] == "1"
    assert srv.api.executor.stacked_stats()["dispatches"] == before
    kinds = [e["kind"] for e in flightrec.snapshot()["events"]]
    assert "query.rejected" in kinds
    with pytest.raises(ServiceUnavailableError):
        srv.api.query_batch("dh", ["Count(Row(f=1))"])

    mode["ok"] = True
    p.probe_once()
    p.probe_once()
    assert devhealth.state() == devhealth.LIVE
    code, _, body = _http(srv.uri + "/readyz")
    assert code == 200 and body["device_link"] == devhealth.LIVE
    assert srv.api.query("dh", "Count(Row(f=1))") == [1]


def test_status_observability_carries_device_link(server):
    srv, c = server
    p = devhealth.configure(canary=lambda: 0.0, start=False)
    p.probe_once()
    link = c.status()["observability"]["local"]["device_link"]
    assert link["state"] == devhealth.LIVE
    assert link["probes"]["ok"] == 1


# ------------------------------------------------------- /debug endpoints

def test_debug_device_endpoint(server):
    srv, c = server
    snap = c._request("GET", "/debug/device")
    assert snap["state"] == devhealth.DISABLED
    p = devhealth.configure(canary=lambda: 0.0, start=False)
    for _ in range(5):
        p.probe_once()
    snap = c._request("GET", "/debug/device")
    assert snap["state"] == devhealth.LIVE
    assert len(snap["ring"]) == 5
    assert all(s["ok"] for s in snap["ring"])
    assert snap["thresholds"] == {
        "degraded_after": 1, "down_after": 3, "live_after": 2}
    limited = c._request("GET", "/debug/device?limit=2")
    assert len(limited["ring"]) == 2


def test_debug_dispatch_phase_decomposition(server):
    """Phase seconds (minus lock_wait) sum to the family's kernel wall —
    exact by construction; rel=5% is the acceptance bound."""
    srv, c = server
    _warm_stacked(c)
    snap = c.debug_dispatch()
    fam = snap["phases"]["count"]
    assert "sync" in fam and "lock_wait" in fam
    wall = srv.api.executor._stacked.kernel_walls()["count"]["seconds"]
    total = sum(p["seconds"] for name, p in fam.items()
                if name != "lock_wait")
    assert total == pytest.approx(wall, rel=0.05)


def test_profile_carries_phase_attribution(server):
    """A profiled query's stacked.kernel spans carry the phase split,
    and the phases net out against the query's kernel wall."""
    srv, c = server
    _warm_stacked(c)
    prof = c.query("dh", "Count(Row(f=11))", profile=True)["profile"]
    tags = prof["tags"]
    ph = {k[len("phase_"):-len("_seconds")]: v for k, v in tags.items()
          if k.startswith("phase_")}
    assert "sync" in ph or "dispatch_ack" in ph
    assert all(v >= 0 for v in ph.values())
    assert sum(v for k, v in ph.items() if k != "lock_wait") == \
        pytest.approx(tags["kernel_wall_seconds"], rel=0.05, abs=1e-4)


def test_explain_analyze_carries_phase_attribution(server):
    from pilosa_tpu_torch.exec import plan as plan_mod
    from pilosa_tpu_torch.exec.executor import ExecOptions

    srv, c = server
    _warm_stacked(c)
    srv.api.query("dh", "Count(Row(f=11))",
                  options=ExecOptions(explain="analyze"))
    env = plan_mod.take_last()
    actual = env["calls"][0]["actual"]
    ph = actual.get("phase_seconds")
    assert ph, "analyze grafted no per-phase attribution"
    assert "sync" in ph or "dispatch_ack" in ph
    assert all(v >= 0 for v in ph.values())
    # the decomposition nets out against the actual kernel wall
    assert sum(v for k, v in ph.items() if k != "lock_wait") == \
        pytest.approx(actual["kernel_wall_seconds"], rel=0.05, abs=1e-4)


# ------------------------------------------------------ flightrec satellite

def test_watchdog_stall_includes_device_link_state():
    p = devhealth.configure(canary=lambda: 0.0, start=False)
    p.probe_once()
    wd = flightrec.Watchdog(deadline=0.01)
    token = wd.begin_op("wedged")
    time.sleep(0.03)
    wd.check()
    wd.end_op(token)
    evt = [e for e in flightrec.snapshot()["events"]
           if e["kind"] == "watchdog.stall"][-1]
    assert evt["tags"]["device_link_state"] == devhealth.LIVE


def test_flightrec_debug_server_serves_device():
    """The bare debug port exposes the prober's state so a supervisor
    can fail a run fast."""
    p = devhealth.configure(canary=lambda: 0.0, start=False)
    p.probe_once()
    srv = flightrec.start_debug_server()
    try:
        port = srv.server_address[1]
        code, _, snap = _http(f"http://127.0.0.1:{port}/debug/device")
        assert code == 200
        assert snap["state"] == devhealth.LIVE
        assert len(snap["ring"]) == 1
        code, _, inc = _http(f"http://127.0.0.1:{port}/debug/incidents")
        assert code == 200 and inc["enabled"] is False
    finally:
        srv.shutdown()
        srv.server_close()
