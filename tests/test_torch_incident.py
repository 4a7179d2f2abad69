"""The port's incident autopsy (utils/incident.py) and the trace and
exemplar surfaces it links to, on the CPU.

`tests/test_incident.py` ported (the cross-node profile assembly on a
2-node cluster of each package, beside the skew estimate and the merge
it rests on): postmortem bundles written on devhealth DOWN and on a deadline
storm, the refractory period, retention, path traversal, a failing
collector, the disabled default, /debug/incidents[/{id}] over HTTP,
trace-index bounds, monotonic span durations, the profile span cap
under concurrent finishes, and metrics exemplars that resolve through
GET /debug/traces/{trace_id}.

Beside them:
- a bundle's sections equal the TPU package's for the same trigger
  (the `fusion` collector came with whole-plan fusion, the `spmd`
  collector with mesh-resident serving);
- `X-Request-Deadline` already expired answers 504 without a launch,
  and a storm of them writes a `deadline_storm` bundle; a deadline that
  lapses between a query's calls answers 504 too;
- SIGTERM to a `server --incident-dir` process writes a `fatal_signal`
  bundle (with the server's `oplog` collector) and still stops cleanly.

Every wait is bounded; each test stops what it starts.
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
import urllib.error
import urllib.request

import pytest

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import devhealth, incident, profile, stats, \
    tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_observability_state():
    yield
    profile.take_last()
    profile.clear_recent()
    tracing.trace_index().clear()
    incident.stop()
    devhealth.stop()


@pytest.fixture
def tracer():
    t = tracing.InMemoryTracer()
    tracing.set_tracer(t)
    yield t
    tracing.set_tracer(None)


@pytest.fixture
def manager(tmp_path):
    mgr = incident.configure(str(tmp_path / "incidents"), min_interval=0.0)
    yield mgr
    incident.stop()


@pytest.fixture
def server(tmp_path):
    from pilosa_tpu_torch.cli import start_server
    from pilosa_tpu_torch.server import Client

    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path / "port"), "--device", "cpu"])
    try:
        yield srv, Client(srv.uri)
    finally:
        srv.stop()


def _wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    return cond()


def _flatten(node):
    out = [node]
    for c in node["children"]:
        out.extend(_flatten(c))
    return out


# -- traces -------------------------------------------------------------------


def test_estimate_skew_and_merge():
    """NTP-style offset: a remote request/response bracketed by the local
    client span recovers the clock offset exactly on synthetic data."""
    local = {"name": "http.POST", "traceID": "t", "spanID": "L",
             "parentID": None, "tags": {}, "start": 100.0, "duration": 0.2}
    remote = {"name": "api.Query", "traceID": "t", "spanID": "R",
              "parentID": "L", "tags": {}, "start": 150.05, "duration": 0.1}
    theta = tracing.estimate_skew([local], [remote])
    assert theta == pytest.approx(50.0, abs=1e-9)
    merged, skew = tracing.merge_remote_spans([local], {"n1": [remote]})
    assert skew["n1"] == pytest.approx(50.0, abs=1e-9)
    shifted = [s for s in merged if s["spanID"] == "R"][0]
    assert shifted["start"] == pytest.approx(100.05, abs=1e-9)
    assert shifted["tags"]["node"] == "n1"
    assert shifted["duration"] == 0.1
    orphan = dict(remote, parentID="nope", spanID="R2")
    assert tracing.estimate_skew([local], [orphan]) == 0.0
    tree = tracing.assemble_tree(merged)
    assert len(tree) == 1 and tree[0]["spanID"] == "L"
    assert tree[0]["children"][0]["spanID"] == "R"


def test_trace_index_bounds_and_eviction():
    idx = tracing.TraceIndex(max_traces=2, max_spans_per_trace=3)
    for t in ("t1", "t2", "t3"):
        for i in range(5):
            s = tracing.Span("s%d" % i, t, "%s-%d" % (t, i), None, {})
            s.finish()
            idx.add(s)
    st = idx.stats()
    assert st["traces"] == 2
    assert st["evictedTraces"] == 1
    assert st["droppedSpans"] == 3 * 2
    assert idx.get("t1") == []
    assert len(idx.get("t3")) == 3


def test_profile_finish_indexes_root_span(tracer):
    prof = profile.begin("i", "Count(Row(f=1))")
    snap = prof.finish()
    got = tracing.get_trace(snap["traceID"])
    assert got and got[0]["name"] == "query"


def test_span_duration_survives_wall_clock_step():
    s = tracing.Span("x", "t", "s", None, {})
    s.start -= 3600.0  # a backwards NTP step after the span started
    s.finish()
    assert 0.0 <= s.duration < 60.0


def test_profile_span_overflow_concurrent():
    """Concurrent span finishes past MAX_PROFILE_SPANS: exactly the cap
    is retained and every overflow is counted in spansDropped."""
    tracing.set_tracer(None)
    prof = profile.begin("i", "q")
    threads_n, per_thread = 8, 100
    total = threads_n * per_thread
    assert total > profile.MAX_PROFILE_SPANS
    start = threading.Barrier(threads_n)

    def worker():
        start.wait(timeout=10)
        with tracing.with_span(prof.root):
            for _ in range(per_thread):
                with tracing.start_span("w"):
                    pass

    ts = [threading.Thread(target=worker) for _ in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = prof.finish()
    assert snap["spansDropped"] == total - profile.MAX_PROFILE_SPANS
    assert len(_flatten(snap["spans"])) - 1 == profile.MAX_PROFILE_SPANS


# -- bundles ------------------------------------------------------------------


def test_devhealth_down_writes_bundle(manager):
    def bad():
        raise RuntimeError("induced canary failure")

    p = devhealth.configure(canary=bad, down_after=2, start=False)
    p.probe_once()
    p.probe_once()
    assert p.state == devhealth.DOWN
    bundles = _wait_for(manager.list)
    assert bundles, "DOWN transition did not write a bundle"
    meta = bundles[0]
    assert meta["kind"] == "devhealth_down"
    for name in ("flightrec.json", "threads.txt", "device.json",
                 "dispatch.json", "workload.json", "heat.json"):
        assert name in meta["files"]
    got = manager.get(meta["id"])
    assert got["contents"]["device.json"]["state"] == devhealth.DOWN
    assert "MainThread" in got["contents"]["threads.txt"]
    assert got["trigger"]["to"] == devhealth.DOWN


def test_deadline_storm_triggers_bundle(tmp_path):
    mgr = incident.IncidentManager(str(tmp_path), min_interval=0.0,
                                   storm_count=5, storm_window=30.0)
    for _ in range(4):
        mgr.note_deadline_expiry()
    assert mgr.list() == []
    mgr.note_deadline_expiry()
    bundles = _wait_for(mgr.list)
    assert bundles and bundles[0]["kind"] == "deadline_storm"
    assert bundles[0]["trigger"]["count"] == 5


def test_refractory_suppression(tmp_path):
    mgr = incident.IncidentManager(str(tmp_path), min_interval=300.0)
    assert mgr.trigger("manual", sync=True) is not None
    assert mgr.trigger("manual", sync=True) is None
    assert mgr.suppressed_total == 1
    assert mgr.trigger("watchdog_stall", sync=True) is not None


def test_retention_cap(tmp_path):
    mgr = incident.IncidentManager(str(tmp_path), max_incidents=3,
                                   min_interval=0.0)
    for i in range(5):
        assert mgr.trigger("manual", sync=True, n=i) is not None
    got = mgr.list()
    assert len(got) == 3
    assert [m["trigger"]["n"] for m in got] == [4, 3, 2]


def test_bundle_get_rejects_traversal(manager):
    manager.trigger("manual", sync=True)
    assert manager.get("../" + manager.list()[0]["id"]) is None
    assert manager.get("..") is None


def test_collector_failure_isolated(manager):
    manager.register_collector("boom", lambda: 1 / 0)
    manager.register_collector("ok", lambda: {"fine": True})
    manager.trigger("manual", sync=True)
    got = manager.get(manager.list()[0]["id"])
    assert "error" in got["contents"]["boom.json"]
    assert got["contents"]["ok.json"] == {"fine": True}


def test_disabled_default_snapshot():
    incident.stop()
    snap = incident.snapshot()
    assert snap["enabled"] is False
    assert incident.maybe_trigger("manual") is None
    incident.note_deadline_expiry()


def test_bundle_sections_equal_reference_minus_fusion_and_spmd(tmp_path):
    pytest.importorskip("jax")
    from pilosa_tpu.utils import incident as jincident

    files = []
    for mod, sub in ((jincident, "ref"), (incident, "port")):
        mgr = mod.IncidentManager(str(tmp_path / sub), min_interval=0.0)
        mgr.trigger("manual", sync=True, note="same")
        (meta,) = mgr.list()
        assert meta["trigger"] == {"note": "same"}
        files.append(set(meta["files"]))
    assert files[1] == files[0]
    assert {"fusion.json", "spmd.json"} <= files[0]


def test_incident_http_endpoints(manager, server):
    srv, c = server
    manager.trigger("manual", sync=True, note="from-test")
    snap = c._request("GET", "/debug/incidents")
    assert snap["enabled"] is True
    assert snap["written_total"] == 1
    iid = snap["incidents"][0]["id"]
    got = c._request("GET", f"/debug/incidents/{iid}")
    assert got["kind"] == "manual"
    assert got["trigger"]["note"] == "from-test"
    assert "flightrec.json" in got["contents"]
    with pytest.raises(Exception):
        c._request("GET", "/debug/incidents/nope")
    text = urllib.request.urlopen(
        srv.uri + "/debug/threads", timeout=5).read().decode()
    assert "MainThread" in text
    paths = {e["path"] for e in c._request("GET", "/debug")["endpoints"]}
    assert {"/debug/incidents", "/debug/threads",
            "/debug/traces/{trace_id}"} <= paths


def _post_query(uri, pql, deadline):
    req = urllib.request.Request(uri + "/index/dl/query", data=pql.encode(),
                                 method="POST")
    req.add_header("X-Request-Deadline", deadline)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_expired_deadlines_answer_504_and_storm_writes_bundle(tmp_path,
                                                              server):
    srv, c = server
    c.create_index("dl")
    c.create_field("dl", "f")
    c.query("dl", f"Set(1, f=1) Set({SHARD_WIDTH + 1}, f=1)")
    mgr = incident.configure(str(tmp_path / "inc"), min_interval=0.0,
                             storm_count=3, storm_window=30.0)
    assert _post_query(srv.uri, "Count(Row(f=1))", "5s") \
        == (200, {"results": [2]})
    assert _post_query(srv.uri, "Count(Row(f=1))", "soon-ish")[0] == 400
    before = srv.api.executor.stacked_stats()["dispatches"]
    for _ in range(3):
        status, body = _post_query(srv.uri, "Count(Row(f=1))", "-1")
        assert status == 504 and "deadline" in body["error"]
    assert srv.api.executor.stacked_stats()["dispatches"] == before
    bundles = _wait_for(mgr.list)
    assert [b["kind"] for b in bundles] == ["deadline_storm"]
    assert bundles[0]["trigger"]["count"] == 3


def test_deadline_lapsing_between_calls_answers_504(server, monkeypatch):
    from pilosa_tpu_torch.server.api import GatewayTimeoutError

    srv, c = server
    c.create_index("dl")
    c.create_field("dl", "f")
    c.query("dl", f"Set(1, f=1) Set({SHARD_WIDTH + 1}, f=1)")
    ex = srv.api.executor
    real = ex.execute_call

    def slow_call(*a, **k):
        time.sleep(0.2)
        return real(*a, **k)

    monkeypatch.setattr(ex, "execute_call", slow_call)
    with pytest.raises(GatewayTimeoutError):
        srv.api.query("dl", "Count(Row(f=1)) Count(Row(f=1))",
                      deadline=time.monotonic() + 0.1)
    assert srv.api.query("dl", "Count(Row(f=1))") == [2]


# -- exemplars ----------------------------------------------------------------


def test_exemplars_unit():
    c = stats.StatsClient()
    c.timing("query_seconds", 0.05, trace_id="deadbeef")
    assert c.exemplars() == {}
    c.enable_exemplars(True)
    c.timing("query_seconds", 0.05, trace_id="deadbeef")
    c.timing("query_seconds", 2.5, {"op": "count"}, trace_id="cafe01")
    ex = c.exemplars("query_seconds")
    flat = {e["traceID"] for by_bucket in ex.values()
            for e in by_bucket.values()}
    assert flat == {"deadbeef", "cafe01"}
    text = c.prometheus_text()
    assert '# {trace_id="deadbeef"} 0.05' in text
    assert '# {trace_id="cafe01"} 2.5' in text
    c.enable_exemplars(False)
    assert c.exemplars() == {}
    assert "# {" not in c.prometheus_text()


def test_slo_snapshot_attaches_exemplars():
    from pilosa_tpu_torch.utils import workload

    sc = stats.StatsClient()
    sc.enable_exemplars(True)
    eng = workload.SloEngine(stats=sc)
    eng.configure([workload.parse_slo("query=10ms@p99")])
    sc.timing("query_op_seconds", 0.5, {"op": "count"}, trace_id="aa11")
    sc.timing("query_op_seconds", 0.002, {"op": "count"}, trace_id="bb22")
    obj = eng.snapshot()["objectives"][0]
    assert [e["traceID"] for e in obj["exemplars"]] == ["aa11"]
    assert obj["exemplars"][0]["seconds"] == pytest.approx(0.5)
    sc.enable_exemplars(False)
    assert "exemplars" not in eng.snapshot()["objectives"][0]


def test_metrics_exemplar_resolves_via_trace(tracer, server):
    srv, c = server
    reg = stats.registry_of(srv.http.stats)
    try:
        reg.enable_exemplars(True)
        c.create_index("ex")
        c.create_field("ex", "f")
        c.query("ex", "Set(1, f=3)")
        text = urllib.request.urlopen(
            srv.uri + "/metrics", timeout=5).read().decode()
        m = re.search(
            r'http_request_seconds_bucket\{[^}]*\}\s+\d+\s+'
            r'# \{trace_id="([0-9a-f]+)"\}', text)
        assert m, "no http_request_seconds exemplar on /metrics"
        out = c._request("GET", f"/debug/traces/{m.group(1)}")
        assert out["found"]
        assert any(s["name"].startswith("http.") for s in out["spans"])
    finally:
        reg.enable_exemplars(False)


# -- a server process ---------------------------------------------------------


def test_sigterm_writes_fatal_signal_bundle(tmp_path):
    """SIGTERM to `server --incident-dir` writes a fatal_signal bundle
    synchronously (with the server's oplog collector) and the server
    still stops cleanly. Waits: boot 120 s, stop 120 s."""
    from pilosa_tpu_torch.server import Client

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    inc = tmp_path / "inc"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device",
         "cpu", "--bind", f"127.0.0.1:{port}", "--data-dir",
         str(tmp_path / "data"), "--incident-dir", str(inc),
         "--incident-max", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                Client(f"http://127.0.0.1:{port}", timeout=2,
                       retries=0).info()
                break
            except Exception:  # noqa: BLE001 — still booting
                if proc.poll() is not None or time.time() > deadline:
                    proc.kill()
                    raise AssertionError(proc.communicate(timeout=60)[1])
                time.sleep(0.2)
        snap = Client(f"http://127.0.0.1:{port}")._request(
            "GET", "/debug/incidents")
        assert snap["enabled"] and snap["max_incidents"] == 4
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    (bundle,) = os.listdir(inc)
    with open(inc / bundle / "meta.json") as f:
        meta = json.load(f)
    assert meta["kind"] == "fatal_signal"
    assert meta["trigger"] == {"signal": "SIGTERM"}
    assert "oplog.json" in meta["files"]
    with open(inc / bundle / "oplog.json") as f:
        assert json.load(f)["enabled"] is True


def test_cross_node_profile_assembly():
    """A profiled fan-out query through the non-owner of a 2-node cluster
    returns ONE merged span tree: the coordinator's spans plus the remote
    leg's server-side spans beneath its `cluster.mapReduce.node` span,
    with per-node skew tags; /debug/traces/{id} serves the local form to
    peers and the assembled form to clients. The TPU package's cluster
    gives the same answer, the same assembly tags and the same remote
    span names."""
    pytest.importorskip("jax")
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    out = []
    for harness in (JaxClusterHarness, ClusterHarness):
        ch = harness(2)
        try:
            coord = ch.non_owner_of("ti", 0)
            ch[0].client.create_index("ti")
            ch[0].client.create_field("ti", "f")
            ch[0].client.import_bits("ti", "f", [10, 10],
                                     [5, SHARD_WIDTH + 5])
            resp = coord.client.query("ti", "Count(Row(f=10))", profile=True)
            prof = resp["profile"]
            spans = _flatten(prof["spans"])
            fanouts = [s for s in spans
                       if s["name"] == "cluster.mapReduce.node"]
            remote = [f for f in fanouts if f["tags"].get("remote")]
            assert len(remote) == 1
            remote_names = {s["name"] for s in _flatten(remote[0])}
            assert {"api.Query", "executor.Execute"} <= remote_names
            assert any(c["name"].startswith("http.POST")
                       for c in remote[0]["children"])
            skews = prof["tags"]["clock_skew_seconds"]
            assert len(skews) == 1
            # in-process nodes share a clock: the corrected skew is tiny
            assert abs(next(iter(skews.values()))) < 1.0
            for s in spans:
                if s.get("start") is not None:
                    assert abs(s["start"] - prof["start"]) < 5.0
            tid = prof["traceID"]
            local = coord.client.debug_trace(tid)
            assert local["found"] and local["spans"]
            full = coord.client._request("GET", f"/debug/traces/{tid}")
            assert full["found"] and full["tree"]
            assert len(full["spans"]) >= len(local["spans"])
            node_info = next(iter(full["nodes"].values()))
            assert node_info["spans"] > 0
            assert "clock_skew_seconds" in node_info
            out.append((resp["results"], len(fanouts),
                        sorted(k for k in prof["tags"]
                               if k in ("clock_skew_seconds",
                                        "remote_spans")),
                        sorted({"api.Query", "executor.Execute",
                                "executor.executeCount"} & remote_names),
                        len(full["nodes"])))
        finally:
            ch.close()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1][0] == [2]
