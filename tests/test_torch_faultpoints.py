"""The port's fault-injection framework (`pilosa_tpu_torch.utils.
faultpoints`): the cases of `tests/test_faultpoints.py`.

The spec grammar, arming and disarming, trigger windows (@nth, xTimes),
the unarmed fast path, arming from the environment at boot, and the
HTTP arm/disarm endpoints, here on the port's own server (an in-process
`tools.cluster.NodeHarness` on the CPU).
"""

import json
import time

import pytest

from pilosa_tpu_torch.utils import faultpoints


@pytest.fixture(autouse=True)
def _disarm():
    faultpoints.disarm()
    yield
    faultpoints.disarm()


class TestParse:
    def test_raise_defaults(self):
        s = faultpoints.parse_spec("import.post-append=raise")
        assert s.name == "import.post-append"
        assert s.action == "raise"
        assert s.param is None
        assert s.nth == 1
        assert s.times == 1  # raise is one-shot by default

    def test_delay_defaults(self):
        s = faultpoints.parse_spec("oplog.fsync=delay")
        assert s.action == "delay"
        assert s.param == 0.1
        assert s.times is None  # a delay is a slowdown, every hit

    def test_delay_param(self):
        s = faultpoints.parse_spec("oplog.fsync=delay:0.25")
        assert s.param == 0.25

    def test_exit_parses_despite_the_x(self):
        # 'exit' contains an 'x' — must not be eaten by the xTimes suffix
        s = faultpoints.parse_spec("import.pre-ack=exit")
        assert s.action == "exit"
        assert s.times == 1

    def test_exit_nth(self):
        s = faultpoints.parse_spec("import.post-append=exit@5")
        assert s.action == "exit"
        assert s.nth == 5

    def test_times_suffix(self):
        s = faultpoints.parse_spec("p=raisex3")
        assert s.times == 3

    def test_times_inf(self):
        s = faultpoints.parse_spec("p=raisexinf")
        assert s.times is None

    def test_nth_and_times(self):
        s = faultpoints.parse_spec("p=raise@2x4")
        assert s.nth == 2
        assert s.times == 4

    @pytest.mark.parametrize("bad", [
        "noequals", "=raise", "p=", "p=frobnicate", "p=raise@x",
    ])
    def test_invalid_specs(self, bad):
        with pytest.raises(ValueError):
            faultpoints.parse_spec(bad)


class TestTriggering:
    def test_unarmed_reached_is_a_noop(self):
        assert not faultpoints.armed()
        faultpoints.reached("anything")  # must not raise

    def test_raise_fires_once(self):
        faultpoints.arm("p=raise")
        with pytest.raises(faultpoints.FaultInjected):
            faultpoints.reached("p")
        faultpoints.reached("p")  # one-shot: second hit passes

    def test_unrelated_name_does_not_fire(self):
        faultpoints.arm("p=raise")
        faultpoints.reached("q")  # armed, but not this point

    def test_nth_window(self):
        faultpoints.arm("p=raise@3")
        faultpoints.reached("p")
        faultpoints.reached("p")
        with pytest.raises(faultpoints.FaultInjected):
            faultpoints.reached("p")

    def test_times_cap(self):
        faultpoints.arm("p=raisex2")
        for _ in range(2):
            with pytest.raises(faultpoints.FaultInjected):
                faultpoints.reached("p")
        faultpoints.reached("p")  # cap reached

    def test_delay_sleeps(self):
        faultpoints.arm("p=delay:0.05")
        t0 = time.monotonic()
        faultpoints.reached("p")
        faultpoints.reached("p")  # delays repeat by default
        assert time.monotonic() - t0 >= 0.1

    def test_disarm_one(self):
        faultpoints.arm("p=raise")
        faultpoints.arm("q=raise")
        faultpoints.disarm("p")
        assert faultpoints.armed()  # q still armed
        faultpoints.reached("p")
        with pytest.raises(faultpoints.FaultInjected):
            faultpoints.reached("q")

    def test_disarm_all_clears_fast_path(self):
        faultpoints.arm("p=raise")
        faultpoints.disarm()
        assert not faultpoints.armed()

    def test_rearm_resets_counters(self):
        faultpoints.arm("p=raise")
        with pytest.raises(faultpoints.FaultInjected):
            faultpoints.reached("p")
        faultpoints.arm("p=raise")
        with pytest.raises(faultpoints.FaultInjected):
            faultpoints.reached("p")

    def test_snapshot_counts(self):
        faultpoints.arm("p=raise@2")
        faultpoints.reached("p")
        snap = faultpoints.snapshot()
        assert snap["armed"] is True
        (pt,) = snap["points"]
        assert pt["name"] == "p"
        assert pt["hits"] == 1
        assert pt["fired"] == 0


class TestEnv:
    def test_configure_from_env(self):
        n = faultpoints.configure_from_env(
            {faultpoints.ENV_VAR: "a=raise; b=delay:0.2@3"})
        assert n == 2
        snap = {p["name"]: p for p in faultpoints.snapshot()["points"]}
        assert snap["a"]["action"] == "raise"
        assert snap["b"]["action"] == "delay"
        assert snap["b"]["nth"] == 3

    def test_empty_env_is_fine(self):
        assert faultpoints.configure_from_env({}) == 0
        assert not faultpoints.armed()


class TestHTTP:
    def test_arm_and_disarm_over_http(self, tmp_path):
        from pilosa_tpu_torch.tools.cluster import NodeHarness

        h = NodeHarness(data_dir=str(tmp_path / "d"), device="cpu")
        try:
            out = h.client._request("GET", "/debug/faultpoints")
            assert out["armed"] is False
            out = h.client._request(
                "POST", "/debug/faultpoints",
                json.dumps({"arm": "import.post-append=raise"}).encode())
            assert out["armed"] is True
            names = [p["name"] for p in out["points"]]
            assert "import.post-append" in names
            # a list arms several at once
            out = h.client._request(
                "POST", "/debug/faultpoints",
                json.dumps({"arm": ["a=raise", "b=delay:0.01"]}).encode())
            names = [p["name"] for p in out["points"]]
            assert {"a", "b"} <= set(names)
            out = h.client._request(
                "POST", "/debug/faultpoints",
                json.dumps({"disarm": "all"}).encode())
            assert out["armed"] is False
        finally:
            h.close()
            faultpoints.disarm()

    def test_bad_spec_is_400(self, tmp_path):
        from pilosa_tpu_torch.server.client import ClientError
        from pilosa_tpu_torch.tools.cluster import NodeHarness

        h = NodeHarness(data_dir=str(tmp_path / "d"), device="cpu")
        try:
            with pytest.raises(ClientError) as ei:
                h.client._request(
                    "POST", "/debug/faultpoints",
                    json.dumps({"arm": "nonsense"}).encode())
            assert ei.value.status == 400
        finally:
            h.close()
