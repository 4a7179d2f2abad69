"""The port's collective-plane observatory (pilosa_tpu_torch/cluster/
spmd.py), in one process.

`tests/test_meshobs.py` ported (23 cases): the step clock's residual
fold (per-phase seconds sum EXACTLY to the step wall), the bounded
per-node step ring, envelope clock-skew correction, straggler
attribution under synthetic skew, edge-triggered straggler flags,
stream-gap onset events and stall accounting, the collective_stall
incident trigger (the stream-gap and the watchdog `spmd.*` op paths),
the `spmd` collector in every bundle, the gap-timeout override, the
/status roll-up and /debug/spmd/steps over HTTP.

The pure functions (`envelope_skew`, `attribute_stragglers`, the clock)
are held to the TPU package's on the same inputs. The port's phase
taxonomy is the TPU package's plus `upload` (the host-to-device copy
the port times apart from the gather), and its psum comes after the
partial's fetch (gloo reduces host tensors).
"""

import time

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from pilosa_tpu.cluster import spmd as jspmd  # noqa: E402
from pilosa_tpu_torch.cluster import spmd as spmd_mod  # noqa: E402
from pilosa_tpu_torch.cluster.spmd import (  # noqa: E402
    STEP_PHASES,
    SpmdDataPlane,
    _StepClock,
    attribute_stragglers,
    envelope_skew,
)
from pilosa_tpu_torch.tools.cluster import NodeHarness  # noqa: E402
from pilosa_tpu_torch.utils import flightrec, incident  # noqa: E402


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(0.02)
    return cond()


def _events(kind):
    return [e for e in flightrec.snapshot()["events"] if e["kind"] == kind]


@pytest.fixture
def recorder():
    rec = flightrec.configure(256)
    yield rec
    flightrec.configure(flightrec.DEFAULT_RING_SIZE)


@pytest.fixture
def manager(tmp_path):
    mgr = incident.configure(str(tmp_path / "incidents"), min_interval=0.0)
    yield mgr
    incident.stop()


def _plane(serve_mode="off", **kw):
    return SpmdDataPlane(None, None, None, serve_mode=serve_mode, **kw)


def _run_fake_steps(plane, n, body=None, start_seq=1):
    """Drive n steps through run_step with the collective body replaced
    (the real one needs a holder and a group); the lifecycle, clock and
    ring paths are the genuine ones."""
    plane._run_step_locked = body or (lambda step: 0)
    for i in range(start_seq, start_seq + n):
        plane.run_step({"seq": i, "index": "i", "kind": "count"})


# -- step clock: the residual-fold contract on the step plane ----------------


def test_step_clock_phases_sum_exactly_to_wall():
    for cls in (_StepClock, jspmd._StepClock):
        clk = cls()
        time.sleep(0.002)
        clk.mark("announce_recv")
        time.sleep(0.001)
        clk.mark("stack_gather")
        wall = clk.close("exit")
        # the close() fold leaves NO residual: exact, not approximate
        assert sum(s for _, s in clk.phases) == pytest.approx(wall,
                                                              rel=1e-9)
        assert [p for p, _ in clk.phases] \
            == ["announce_recv", "stack_gather", "exit"]
        assert all(s >= 0 for _, s in clk.phases)


def test_step_clock_t0_covers_announce_wait():
    """t0 = the announcement-receipt stamp: queue/lock wait that
    happened BEFORE the clock existed lands in the first mark."""
    t0 = time.perf_counter()
    time.sleep(0.01)
    clk = _StepClock(t0=t0)
    clk.mark("announce_recv")
    wall = clk.close()
    assert dict(clk.phases)["announce_recv"] >= 0.01
    assert sum(s for _, s in clk.phases) == pytest.approx(wall, rel=1e-9)


def test_step_phases_taxonomy_complete():
    assert STEP_PHASES == ("announce_recv", "stack_gather", "upload",
                           "device_enter", "result_fetch", "psum", "exit")
    assert set(STEP_PHASES) == set(jspmd.STEP_PHASES) | {"upload"}


# -- envelope skew ------------------------------------------------------------


def test_envelope_skew_recovers_known_offset():
    # peer clock runs +5s ahead; symmetric 100ms network legs
    t_send, offset, leg = 1000.0, 5.0, 0.1
    remote_now = (t_send + leg) + offset  # the peer stamps the midpoint
    t_recv = t_send + 2 * leg
    assert envelope_skew(t_send, t_recv, remote_now) \
        == pytest.approx(offset)
    assert envelope_skew(t_send, t_recv, remote_now) \
        == jspmd.envelope_skew(t_send, t_recv, remote_now)
    # zero offset, zero rtt: no correction
    assert envelope_skew(10.0, 10.0, 10.0) == 0.0


# -- straggler oracle ---------------------------------------------------------


def _both_stragglers(peers, factor, floor):
    got = attribute_stragglers(peers, factor, floor)
    assert got == jspmd.attribute_stragglers(peers, factor, floor)
    return got


def test_straggler_attribution_flags_slow_peer():
    flags = _both_stragglers(
        {"n0": {"psum": 0.5, "stack_gather": 0.01},
         "n1": {"psum": 0.1, "stack_gather": 0.01}},
        factor=2.0, floor=0.025)
    assert len(flags) == 1
    f = flags[0]
    assert (f["node"], f["phase"]) == ("n0", "psum")
    assert f["ratio"] == pytest.approx(5.0)
    assert f["median_seconds"] == pytest.approx(0.1)


def test_straggler_attribution_noise_floor_and_factor():
    # 9x ratio but microseconds of absolute skew: jitter, not a straggler
    assert _both_stragglers(
        {"n0": {"g": 0.0009}, "n1": {"g": 0.0001}}, 2.0, 0.025) == []
    # a big absolute gap but under the factor: not flagged
    assert _both_stragglers(
        {"n0": {"g": 0.15}, "n1": {"g": 0.10}}, 2.0, 0.025) == []
    # a single reporting peer can never be a straggler
    assert _both_stragglers({"n0": {"g": 9.0}}, 2.0, 0.025) == []


def test_straggler_median_excludes_candidate():
    """On a 2-node group the baseline must be the OTHER peer: a median
    over both would dilute the straggler into its own baseline."""
    flags = _both_stragglers(
        {"a": {"psum": 0.5}, "b": {"psum": 0.1}}, 2.0, 0.025)
    assert flags and flags[0]["median_seconds"] == pytest.approx(0.1)
    # three peers, one slow in the upload phase only the port has
    flags = _both_stragglers(
        {"a": {"upload": 0.2, "psum": 0.1}, "b": {"upload": 0.01,
                                                  "psum": 0.1},
         "c": {"upload": 0.012, "psum": 0.11}}, 2.0, 0.025)
    assert [(f["node"], f["phase"]) for f in flags] == [("a", "upload")]


# -- step ring + phase tables -------------------------------------------------


def test_step_ring_records_phases_summing_to_wall():
    p = _plane("on")

    def body(step):
        p._mark_phase("stack_gather")
        time.sleep(0.002)
        p._mark_phase("psum")
        return 42

    _run_fake_steps(p, 3, body=body)
    snap = p.steps_local()
    assert [r["seq"] for r in snap["steps"]] == [1, 2, 3]
    for rec in snap["steps"]:
        assert rec["ok"] is True
        assert set(rec["phases"]) \
            == {"announce_recv", "stack_gather", "psum", "exit"}
        assert sum(rec["phases"].values()) \
            == pytest.approx(rec["wall_seconds"], abs=5e-6)
    obs = p.observatory_stats()
    assert obs["steps_recorded"] == 3
    assert obs["phase_totals"]["psum"]["count"] == 3
    assert p.steps_entered == p.steps_exited == 3
    # the record has the reference's keys
    ref = jspmd.SpmdDataPlane(None, None, None, serve_mode="on")
    ref._run_step_locked = lambda step: 0
    ref.run_step({"seq": 1, "index": "i", "kind": "count"})
    assert set(snap["steps"][0]) == set(ref.steps_local()["steps"][0])
    assert set(p.observatory_stats()) == set(ref.observatory_stats())


def test_step_ring_is_bounded():
    class _Small(SpmdDataPlane):
        STEP_RING_SIZE = 8

    p = _Small(None, None, None, serve_mode="on")
    _run_fake_steps(p, 20)
    snap = p.steps_local()
    assert len(snap["steps"]) == 8
    assert [r["seq"] for r in snap["steps"]] == list(range(13, 21))
    # per-phase totals keep the full history as the ring wraps
    assert p.observatory_stats()["phase_totals"]["exit"]["count"] == 20


def test_steps_local_seq_filter_and_limit():
    p = _plane("on")
    _run_fake_steps(p, 10)
    one = p.steps_local(seq=7)["steps"]
    assert len(one) == 1 and one[0]["seq"] == 7
    assert len(p.steps_local(limit=4)["steps"]) == 4
    assert p.steps_local(seq=99)["steps"] == []


def test_failed_step_recorded_not_ok():
    p = _plane("on")

    def boom(step):
        raise RuntimeError("collective failed")

    p._run_step_locked = boom
    with pytest.raises(RuntimeError):
        p.run_step({"seq": 1, "index": "i", "kind": "count"})
    rec = p.steps_local()["steps"][0]
    assert rec["ok"] is False
    assert sum(rec["phases"].values()) \
        == pytest.approx(rec["wall_seconds"], abs=5e-6)
    assert p.steps_entered == p.steps_exited == 1


# -- local timeline merge -----------------------------------------------------


def test_steps_timeline_local_only_merges_by_seq():
    p = _plane("on")
    _run_fake_steps(p, 4)
    tl = p.steps_timeline(local_only=True)
    assert [s["seq"] for s in tl["steps"]] == [1, 2, 3, 4]
    for s in tl["steps"]:
        assert set(s["peers"]) == {"local"}
        peer = s["peers"]["local"]
        assert sum(peer["phases"].values()) \
            == pytest.approx(peer["wall_seconds"], abs=5e-6)
        assert s["stragglers"] == []  # one peer: never a straggler
    assert tl["skew_seconds"] == {"local": 0.0}


def test_step_carries_trace_id_into_ring():
    p = _plane("on")
    p._run_step_locked = lambda step: 0
    p.run_step({"seq": 1, "index": "i", "kind": "count", "trace": "t-abc"})
    rec = p.steps_local()["steps"][0]
    assert rec["trace"] == "t-abc"


# -- edge-triggered straggler flags ------------------------------------------


def test_straggler_flags_edge_triggered(recorder):
    p = _plane("on")
    flags = [{"phase": "psum", "node": "n1", "seconds": 0.5,
              "median_seconds": 0.1, "ratio": 5.0}]
    p._flag_stragglers(7, flags)
    p._flag_stragglers(7, flags)  # same (seq, node, phase): no re-fire
    assert p.straggler_flags_total == 1
    evts = _events("spmd.straggler")
    assert len(evts) == 1
    assert evts[0]["tags"]["node"] == "n1"
    assert evts[0]["tags"]["phase"] == "psum"
    p._flag_stragglers(8, flags)  # a new seq fires again
    assert p.straggler_flags_total == 2


# -- stream-gap onset + collective_stall autopsy ------------------------------


def test_stream_gap_onset_event_resync_and_stall_accounting(
        recorder, manager):
    p = _plane("on", stream_gap_timeout=0.15)
    p._run_step_locked = lambda step: 0
    spmd_mod.set_active_plane(p)
    try:
        p.run_stream({"seq": 1, "index": "i", "kind": "count"})
        _wait_for(lambda: p.steps_exited == 1)
        # seq 2 never arrives; seq 3 queues behind the gap
        p.run_stream({"seq": 3, "index": "i", "kind": "count"})
        # the gap is announced at ONSET, before any resync
        assert _wait_for(lambda: p.gap_onsets == 1)
        onset = _events("spmd.stream_gap")
        assert onset and onset[0]["tags"]["expected"] == 2
        # then the timeout fires and the runner skips ahead
        assert _wait_for(lambda: p.stream_resyncs == 1)
        assert _wait_for(lambda: p.steps_exited == 2)
        assert p.gap_stall_seconds >= 0.1
        assert p.occupancy()["gap_onsets"] == 1
        # the autopsy: a collective_stall bundle, written while the gap
        # was open, carrying the spmd collector's observatory
        bundles = _wait_for(manager.list)
        assert bundles and "collective_stall" in bundles[0]["id"]
        bundle = manager.get(bundles[0]["id"])
        spmd_state = bundle["contents"].get("spmd.json")
        assert spmd_state is not None
        assert spmd_state["enabled"] is True
        assert "observatory" in spmd_state
        assert "steps_local" in spmd_state
    finally:
        spmd_mod.set_active_plane(None)
        p.close()


def test_gap_closed_by_arrival_accounts_stall_without_resync(recorder):
    p = _plane("on", stream_gap_timeout=5.0)
    p._run_step_locked = lambda step: 0
    p.run_stream({"seq": 1, "index": "i", "kind": "count"})
    _wait_for(lambda: p.steps_exited == 1)
    p.run_stream({"seq": 3, "index": "i", "kind": "count"})
    assert _wait_for(lambda: p.gap_onsets == 1)
    time.sleep(0.05)
    p.run_stream({"seq": 2, "index": "i", "kind": "count"})  # gap closes
    assert _wait_for(lambda: p.steps_exited == 3)
    assert p.stream_resyncs == 0
    assert p.gap_stall_seconds >= 0.04
    p.close()


def test_watchdog_spmd_op_triggers_collective_stall(manager):
    """A collective step stuck past its deadline (entered > exited) maps
    to the collective_stall trigger; any other op stays watchdog_stall."""
    wd = flightrec.Watchdog(deadline=0.01)
    tok = wd.begin_op("spmd.step", seq=9, op="count")
    time.sleep(0.02)
    assert wd.check()  # trips
    wd.end_op(tok)
    bundles = _wait_for(manager.list)
    assert bundles and "collective_stall" in bundles[0]["id"]
    tok = wd.begin_op("query", index="i")
    time.sleep(0.02)
    assert wd.check()
    wd.end_op(tok)
    bundles = _wait_for(lambda: len(manager.list()) == 2 and
                        manager.list())
    assert any("watchdog_stall" in b["id"] for b in bundles)


def test_every_bundle_captures_spmd_state(manager):
    """The spmd collector rides in ALL bundles (manual, devhealth_down,
    ...), not just collective_stall."""
    p = _plane("on")
    _run_fake_steps(p, 2)
    spmd_mod.set_active_plane(p)
    try:
        manager.trigger("manual", sync=True)
        bundle = manager.get(manager.list()[0]["id"])
        content = bundle["contents"]["spmd.json"]
        assert content["enabled"] is True
        assert content["steps_local"]["steps"][-1]["seq"] == 2
    finally:
        spmd_mod.set_active_plane(None)


def test_observatory_snapshot_disabled_without_plane():
    assert spmd_mod.observatory_snapshot() == {"enabled": False} \
        == jspmd.observatory_snapshot()


# -- configurable gap timeout -------------------------------------------------


def test_stream_gap_timeout_constructor_override():
    assert _plane().STREAM_GAP_TIMEOUT == 30 \
        == jspmd.SpmdDataPlane.STREAM_GAP_TIMEOUT
    assert _plane(stream_gap_timeout=2.5).STREAM_GAP_TIMEOUT == 2.5
    # invalid values keep the class default rather than wedging boot
    assert _plane(stream_gap_timeout=0).STREAM_GAP_TIMEOUT == 30
    assert SpmdDataPlane.STREAM_GAP_TIMEOUT == 30  # class attr untouched
    snap = _plane(stream_gap_timeout=2.5).debug_snapshot()
    assert snap["stream_gap_timeout"] == 2.5


# -- /status observability + debug surfaces -----------------------------------


def test_node_observability_rolls_up_spmd():
    h = NodeHarness(device="cpu")
    try:
        obs = h.api._node_observability()
        assert "spmd" not in obs  # no plane on this node
        h.api.spmd = _plane("on")
        obs = h.api._node_observability()
        assert obs["spmd"]["serve_mode"] == "on"
        assert obs["spmd"]["steps"]["entered"] == 0
        assert "gap_stall_seconds" in obs["spmd"]["stream"]
        ref = jspmd.SpmdDataPlane(None, None, None, serve_mode="on")
        assert set(obs["spmd"]) == set(ref.summary())
        assert obs["spmd"]["steps"].keys() == ref.summary()["steps"].keys()
    finally:
        h.api.spmd = None
        h.close()


def test_debug_spmd_steps_disabled_node():
    h = NodeHarness(device="cpu")
    try:
        assert h.client._request("GET", "/debug/spmd/steps") \
            == {"enabled": False}
        assert h.client._request("GET", "/debug/spmd/steps/5") \
            == {"enabled": False}
    finally:
        h.close()


def test_debug_spmd_steps_local_roundtrip():
    """The HTTP surface end to end on one node: ring -> ?local=true
    slice -> merged timeline, straggler-free."""
    h = NodeHarness(device="cpu")
    try:
        p = _plane("on")
        _run_fake_steps(p, 3)
        h.api.spmd = p
        local = h.client._request(
            "GET", "/debug/spmd/steps?local=true&limit=2")
        assert local["enabled"] is True
        assert [r["seq"] for r in local["steps"]] == [2, 3]
        merged = h.client._request("GET", "/debug/spmd/steps/2")
        assert [s["seq"] for s in merged["steps"]] == [2]
        assert merged["steps"][0]["stragglers"] == []
        assert h.client.debug_spmd_steps(limit=1)["steps"][0]["seq"] == 3
        assert h.client.debug_spmd()["serve_mode"] == "on"
    finally:
        h.api.spmd = None
        h.close()
