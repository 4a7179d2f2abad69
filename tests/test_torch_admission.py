"""The port's admission control, deadline propagation and degradation
ladder (server/admission.py and its API and HTTP hooks) against the TPU
package's, on the CPU.

Every single-node case of `tests/test_admission.py` runs on both
packages. Where a case drives the controller directly, the same calls
run on both packages' AdmissionController and their states, retry-afters,
counters and snapshots are compared; where it serves HTTP, both servers
take the same requests and answer with the same status, the same
headers that matter (Retry-After, X-Pilosa-Shed) and the same body:

- a malformed `X-Request-Deadline` or `X-Query-Class` is a 400 at the
  edge;
- expired on arrival is a 504 with no dispatch, and a deadline that
  lapses in the admission queue is dropped with a 504 before it ever
  reaches the dispatch lock;
- `--admission off` (the default) builds nothing;
- every shedding site rejects through the one jittered `shed_reject`
  with the shared `rejections_total{site,class}` counter and the
  `X-Pilosa-Shed` marker;
- the ladder escalates at once and steps down one rung per hold, LIFEBOAT
  sheds writes and batch, SHED_BATCH parks batch and holds the ingest
  engine's interval merges off, STALE_OK marks responses stale;
- pricing goes through the planner and launches nothing.

The reference's three cluster cases (the deadline across a 2-node
fan-out and the peer overload/unready retries) run on a 2-node cluster
of each package.
"""

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.exec as jax_exec  # noqa: E402
import pilosa_tpu.server.admission as jax_admission  # noqa: E402
import pilosa_tpu.server.api as jax_api  # noqa: E402
import pilosa_tpu.utils.devhealth as jax_devhealth  # noqa: E402
import pilosa_tpu.utils.flightrec as jax_flightrec  # noqa: E402
import pilosa_tpu.utils.stats as jax_stats  # noqa: E402
import pilosa_tpu.utils.workload as jax_workload  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.exec as torch_exec  # noqa: E402
import pilosa_tpu_torch.server.admission as torch_admission  # noqa: E402
import pilosa_tpu_torch.server.api as torch_api  # noqa: E402
import pilosa_tpu_torch.utils.devhealth as torch_devhealth  # noqa: E402
import pilosa_tpu_torch.utils.flightrec as torch_flightrec  # noqa: E402
import pilosa_tpu_torch.utils.stats as torch_stats  # noqa: E402
import pilosa_tpu_torch.utils.workload as torch_workload  # noqa: E402
from pilosa_tpu.pql import parse as jax_parse  # noqa: E402
from pilosa_tpu_torch.pql import parse  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402
from pilosa_tpu_torch.server.http_server import PilosaHTTPServer  # noqa: E402,E501
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from tests.harness import ServerHarness as JaxHarness  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(
        name="jax", adm=jax_admission, api=jax_api, exec=jax_exec,
        devhealth=jax_devhealth, flightrec=jax_flightrec,
        workload=jax_workload, stats=jax_stats.global_stats,
        parse=jax_parse),
    "port": SimpleNamespace(
        name="port", adm=torch_admission, api=torch_api, exec=torch_exec,
        devhealth=torch_devhealth, flightrec=torch_flightrec,
        workload=torch_workload, stats=torch_stats.global_stats,
        parse=parse),
}
BOTH = tuple(PKGS.values())


@pytest.fixture(autouse=True)
def _pristine():
    for p in BOTH:
        p.flightrec.configure(p.flightrec.DEFAULT_RING_SIZE)
        p.workload.reset()
    yield
    for p in BOTH:
        p.devhealth.stop()
        p.workload.reset()
        p.flightrec.configure(p.flightrec.DEFAULT_RING_SIZE)


def _counter(pkg, name):
    counters, _, _ = pkg.stats.snapshot()
    return sum(v for k, v in counters.items()
               if (k[0] if isinstance(k, tuple) else k) == name)


def _dispatches(api):
    local = getattr(api.executor, "local", api.executor)
    return local._stacked.counters()[0]


def _post(url, body=b"", headers=None):
    """(status, headers, json_body) — 4xx/5xx returned, not raised."""
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", "text/plain")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers), \
                json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode())


def _snap(adm):
    """A controller snapshot without its clock-driven numbers."""
    snap = adm.snapshot()
    snap.pop("state_age_seconds")
    for c in snap["classes"].values():
        c.pop("tokens_ms")
    for t in snap["transitions"]:
        t.pop("at")
    return snap


# ------------------------------------------------------------ unit: classes


def test_classify_defaults():
    for p in BOTH:
        adm = p.adm
        assert adm.classify(query=p.parse("Count(Row(f=1))")) \
            == adm.INTERACTIVE
        assert adm.classify(query=p.parse("Set(1, f=1)")) == adm.BATCH
        assert adm.classify(path_internal=True) == adm.INTERNAL
        # the validated header always wins
        assert adm.classify(header="batch",
                            query=p.parse("Count(Row(f=1))")) == adm.BATCH
    for name in ("CLASSES", "STATES", "DEFAULT_SHARES", "DEFAULT_QUEUE_DEPTH",
                 "DEFAULT_QUEUE_TIMEOUT", "DEFAULT_CAPACITY_MS_PER_S",
                 "LADDER_HOLD_SECONDS", "FALLBACK_COST_MS"):
        assert getattr(torch_admission, name) == \
            getattr(jax_admission, name), name


def test_parse_deadline_forms():
    for adm in (jax_admission, torch_admission):
        assert adm.parse_deadline("2.5") == pytest.approx(2.5)
        assert adm.parse_deadline("250ms") == pytest.approx(0.25)
        assert adm.parse_deadline("1m30s") == pytest.approx(90.0)
        # absolute epoch deadline, relative to a pinned "now"
        assert adm.parse_deadline("@1000.5", now=1000.0) \
            == pytest.approx(0.5)
        assert adm.parse_deadline("@999", now=1000.0) < 0  # expired
        for bad in ("", "soon", "12parsecs", "@then"):
            with pytest.raises(ValueError):
                adm.parse_deadline(bad)


def test_token_bucket_math():
    for adm in (jax_admission, torch_admission):
        b = adm.TokenBucket(100.0, burst_seconds=2.0)  # 100 ms/s
        assert b.burst == pytest.approx(200.0)
        assert b.tokens == pytest.approx(200.0)  # starts full
        now = time.monotonic()
        assert b.try_debit(150.0, now)
        assert b.tokens == pytest.approx(50.0)
        assert not b.try_debit(100.0, now)  # dry
        # refill accrues rate * dt, capped at burst
        b.refill(now + 0.5)
        assert b.tokens == pytest.approx(100.0)
        b.refill(now + 100.0)
        assert b.tokens == pytest.approx(200.0)
        # deficit: time until cost fits at the refill rate
        b.tokens = 0.0
        assert b.deficit_seconds(50.0) == pytest.approx(0.5)


def _controllers(**kw):
    kw.setdefault("capacity_ms_per_s", 1000.0)
    return [p.adm.AdmissionController(**kw) for p in BOTH]


def test_admit_and_queue_full_rejection():
    out = []
    for p, adm in zip(BOTH, _controllers(capacity_ms_per_s=0.001,
                                         queue_depth=0)):
        try:
            # a full bucket always grants one burst-capped request
            adm.admit(p.adm.INTERACTIVE, 1.0)
            # now the bucket is dry (refill ~0.0006 ms/s) and queue_depth
            # 0 -> immediate 503-shaped rejection
            with pytest.raises(p.adm.Rejected) as ei:
                adm.admit(p.adm.INTERACTIVE, 1.0)
            assert ei.value.retry_after > 0
            assert ei.value.qclass == p.adm.INTERACTIVE
            snap = adm.snapshot()
            assert snap["classes"]["interactive"]["rejected"] == 1
            out.append((round(ei.value.retry_after), str(ei.value),
                        _snap(adm)))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_admit_expired_in_queue_never_dispatches():
    out = []
    for p, adm in zip(BOTH, _controllers(capacity_ms_per_s=0.001,
                                         queue_depth=8, queue_timeout=30.0)):
        try:
            adm.admit(p.adm.INTERACTIVE, 1.0)  # drain the full bucket
            t0 = time.monotonic()
            with pytest.raises(p.adm.Expired):
                adm.admit(p.adm.INTERACTIVE, 5.0,
                          deadline=time.monotonic() + 0.15)
            assert time.monotonic() - t0 < 5.0  # gave up at the deadline
            assert adm.snapshot()["classes"]["interactive"][
                "expired_dropped"] == 1
            out.append(_snap(adm))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_ladder_escalates_immediately_deescalates_one_rung_with_hold():
    out = []
    for p, adm in zip(BOTH, _controllers()):
        a = p.adm
        try:
            signals = [(a.LIFEBOAT, "forced")]
            adm._target_state = lambda s=signals: s[0]
            now = time.monotonic()
            states = [adm.maybe_update_ladder(now + 2)]
            # recovery: target NORMAL, but the ladder holds the rung,
            # then steps DOWN one rung at a time
            signals[0] = (a.NORMAL, "recovered")
            states.append(adm.maybe_update_ladder(now + 4))
            t_hold = now + 4 + a.LADDER_HOLD_SECONDS
            states.append(adm.maybe_update_ladder(t_hold + 1))
            states.append(adm.maybe_update_ladder(
                t_hold + a.LADDER_HOLD_SECONDS + 2))
            assert states == [a.LIFEBOAT, a.LIFEBOAT, a.STALE_OK,
                              a.SHED_BATCH]
            kinds = [e["kind"] for e in p.flightrec.snapshot()["events"]]
            assert kinds.count("admission.state") == 3  # edge-triggered
            assert adm.snapshot()["transitions"][-1]["to"] == a.SHED_BATCH
            out.append((states, _snap(adm)))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_lifeboat_rejects_batch_and_writes():
    out = []
    for p, adm in zip(BOTH, _controllers()):
        a = p.adm
        try:
            adm._target_state = lambda a=a: (a.LIFEBOAT, "forced")
            adm.maybe_update_ladder(time.monotonic() + 2)
            with pytest.raises(a.Rejected) as e1:
                adm.admit(a.BATCH, 1.0)
            with pytest.raises(a.Rejected) as e2:
                adm.admit(a.INTERACTIVE, 1.0, is_write=True)
            # interactive reads and internal traffic still flow
            assert adm.admit(a.INTERACTIVE, 1.0) is not None
            assert adm.admit(a.INTERNAL, 1.0) is not None
            assert adm.snapshot()["shed_by_state"][a.LIFEBOAT] == 2
            out.append((e1.value.retry_after, e2.value.retry_after,
                        str(e1.value), _snap(adm)))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_shed_batch_parks_batch_even_with_tokens():
    out = []
    for p, adm in zip(BOTH, _controllers(queue_timeout=0.2)):
        a = p.adm
        try:
            adm._target_state = lambda a=a: (a.SHED_BATCH, "forced")
            adm.maybe_update_ladder(time.monotonic() + 2)
            assert adm.buckets[a.BATCH].tokens > 1.0  # tokens banked
            t0 = time.monotonic()
            with pytest.raises(a.Rejected):  # queued-only: times out
                adm.admit(a.BATCH, 1.0)
            assert time.monotonic() - t0 >= 0.15
            # interactive is untouched at this rung
            assert adm.admit(a.INTERACTIVE, 1.0) is not None
            assert adm.shed_merges()
            assert not adm.serving_stale()
            out.append(_snap(adm))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_calibration_ewma_and_refund():
    out = []
    for p, adm in zip(BOTH, _controllers()):
        a = p.adm
        try:
            ticket = adm.admit(a.INTERACTIVE, 100.0)
            tokens_after_debit = adm.buckets[a.INTERACTIVE].tokens
            # measured 10ms against priced 100ms: refund ~90ms, EWMA dips
            adm.note_done(ticket, 0.010)
            assert adm._calibration < 1.0
            assert adm.buckets[a.INTERACTIVE].tokens \
                > tokens_after_debit + 80.0
            c1 = adm._calibration
            # over-run drags the EWMA the other way
            t2 = adm.admit(a.INTERACTIVE, 1.0)
            adm.note_done(t2, 1.0)
            assert adm._calibration > 0.9
            out.append((c1, adm._calibration, adm._calibration_n))
        finally:
            adm.close()
    assert out[0] == out[1]


def test_shed_reject_unifies_retry_after_and_counter():
    for p in BOTH:
        before = _counter(p, "rejections_total")
        with pytest.raises(p.api.ServiceUnavailableError) as ei:
            p.api.shed_reject("testsite", "too busy", 4.0, qclass="batch")
        ra = float(ei.value.headers["Retry-After"])
        assert 4.0 <= ra <= 5.0  # jitter x1.0-1.25
        assert ei.value.headers["X-Pilosa-Shed"] == "testsite"
        assert ei.value.status == 503
        assert _counter(p, "rejections_total") == before + 1


# ------------------------------------------------------------ http surface


class _Harness:
    """One in-process port node on the CPU: holder + API + HTTP."""

    def __init__(self, data_dir, **api_kwargs):
        self.holder = torch_core.Holder(
            str(data_dir), use_snapshot_queue=False).open()
        self.api = torch_api.API(self.holder, device="cpu", **api_kwargs)
        self.server = PilosaHTTPServer(self.api, host="127.0.0.1",
                                       port=0).start()
        self.client = Client(self.server.uri)
        self.address = self.server.uri

    def close(self):
        self.server.stop()
        self.api.close()
        self.holder.close()


def _pair(tmp_path, **api_kwargs):
    return {"jax": JaxHarness(data_dir=str(tmp_path / "jax"), **api_kwargs),
            "port": _Harness(tmp_path / "port", **api_kwargs)}


@pytest.fixture
def hs(tmp_path):
    hs = _pair(tmp_path)
    yield hs
    for h in hs.values():
        h.close()


@pytest.fixture
def hs_on(tmp_path):
    hs = _pair(tmp_path, admission="on")
    yield hs
    for h in hs.values():
        h.close()


def _seed(h, idx="adm"):
    h.client.create_index(idx)
    h.client.create_field(idx, "f")
    h.client.query(idx, "Set(3, f=1)")
    h.client.query(idx, f"Set({SHARD_WIDTH + 5}, f=1)")
    h.client.query(idx, "Count(Row(f=1))")  # warm the stacked path
    return idx


def _both_post(hs, path_fn, body, headers=None):
    """The same POST to both servers: {name: (status, headers, body)}."""
    return {name: _post(f"{h.address}{path_fn(h)}", body, headers)
            for name, h in hs.items()}


def test_malformed_deadline_is_400(hs):
    for h in hs.values():
        _seed(h)
    got = _both_post(hs, lambda h: "/index/adm/query", b"Count(Row(f=1))",
                     {"X-Request-Deadline": "whenever"})
    for status, _, body in got.values():
        assert status == 400
        assert "X-Request-Deadline" in body["error"]
    assert got["port"][2] == got["jax"][2]


def test_bad_query_class_is_400(hs):
    for h in hs.values():
        _seed(h)
    got = _both_post(hs, lambda h: "/index/adm/query", b"Count(Row(f=1))",
                     {"X-Query-Class": "vip"})
    for status, _, body in got.values():
        assert status == 400
        assert "X-Query-Class" in body["error"]
    assert got["port"][2] == got["jax"][2]


def test_expired_on_arrival_504_zero_dispatches(hs):
    before = {}
    for name, h in hs.items():
        _seed(h)
        before[name] = _dispatches(h.api)
    got = _both_post(hs, lambda h: "/index/adm/query", b"Count(Row(f=1))",
                     {"X-Request-Deadline": "-1"})
    for name, (status, _, body) in got.items():
        assert status == 504
        assert "deadline" in body["error"]
        assert _dispatches(hs[name].api) == before[name], \
            "expired work must never reach the dispatch lock"
    assert got["port"][2] == got["jax"][2]


def test_generous_deadline_serves_normally(hs):
    for h in hs.values():
        _seed(h)
    got = _both_post(hs, lambda h: "/index/adm/query", b"Count(Row(f=1))",
                     {"X-Request-Deadline": "30s",
                      "X-Query-Class": "interactive"})
    for status, _, body in got.values():
        assert status == 200
        assert body["results"] == [2]
        assert "stale" not in body
    assert got["port"][2] == got["jax"][2]


def test_admission_off_is_inert(hs):
    for h in hs.values():
        _seed(h)
        assert h.api._admission is None
        assert h.api.admission_stats() == {"enabled": False}
        assert not h.api.serving_stale()
    got = _both_post(hs, lambda h: "/index/adm/query", b"Count(Row(f=1))")
    for status, _, body in got.values():
        assert status == 200 and body["results"] == [2]
    assert hs["port"].client._request("GET", "/debug/admission") == \
        {"enabled": False}


def test_admission_on_serves_and_reports(hs_on):
    snaps = {}
    for h in hs_on.values():
        _seed(h)
    got = _both_post(hs_on, lambda h: "/index/adm/query", b"Count(Row(f=1))")
    for name, h in hs_on.items():
        status, _, body = got[name]
        assert status == 200 and body["results"] == [2]
        snap = h.client._request("GET", "/debug/admission")
        assert snap["enabled"] and snap["state"] == "NORMAL"
        assert snap["classes"]["interactive"]["admitted"] >= 1
        assert snap["classes"]["batch"]["admitted"] >= 2  # the Sets
        # calibration learned from completed queries
        assert snap["calibration_samples"] >= 1
        snaps[name] = (sorted(snap), sorted(snap["classes"]),
                       {c: v["admitted"]
                        for c, v in snap["classes"].items()},
                       snap["calibration_samples"])
    assert snaps["port"] == snaps["jax"]


def _seed_off_path(h, idx="adm"):
    """Seed data through the API directly (bypassing admission), for
    tests whose controller is configured to shed everything."""
    h.api.create_index(idx)
    h.api.create_field(idx, "f")
    h.api._query_admitted(idx, "Set(3, f=1)", None, None)
    return idx


def test_admission_shed_503_with_retry_after(tmp_path):
    hs = _pair(tmp_path, admission="on", admission_capacity=0.001,
               admission_queue_depth=0)
    try:
        before = {}
        for name, h in hs.items():
            _seed_off_path(h)
            # first request drains the (burst-capped) full bucket
            h.api._admission.admit(PKGS[name].adm.INTERACTIVE, 1.0)
            before[name] = (_counter(PKGS[name], "rejections_total"),
                            _dispatches(h.api))
        got = _both_post(hs, lambda h: "/index/adm/query",
                         b"Count(Row(f=1))")
        for name, (status, headers, body) in got.items():
            h = hs[name]
            assert status == 503
            assert float(headers["Retry-After"]) >= 1.0
            assert headers["X-Pilosa-Shed"] == "admission"
            assert _counter(PKGS[name], "rejections_total") == \
                before[name][0] + 1
            assert _dispatches(h.api) == before[name][1]
            assert h.api.admission_stats()["classes"]["interactive"][
                "rejected"] >= 1
        assert got["port"][2] == got["jax"][2]
    finally:
        for h in hs.values():
            h.close()


def test_queue_lapsed_deadline_504_zero_dispatches(tmp_path):
    hs = _pair(tmp_path, admission="on", admission_capacity=0.001,
               admission_queue_depth=16, admission_queue_timeout=30.0)
    try:
        before = {}
        for name, h in hs.items():
            _seed_off_path(h)
            # drain the full bucket so the deadline-bearing request waits
            h.api._admission.admit(PKGS[name].adm.INTERACTIVE, 1.0)
            before[name] = _dispatches(h.api)
        t0 = time.monotonic()
        got = _both_post(hs, lambda h: "/index/adm/query",
                         b"Count(Row(f=1))", {"X-Request-Deadline": "200ms"})
        assert time.monotonic() - t0 < 10.0  # dropped at the deadline
        for name, (status, _, body) in got.items():
            h = hs[name]
            assert status == 504
            assert _dispatches(h.api) == before[name]  # never dispatched
            assert h.api.admission_stats()["classes"]["interactive"][
                "expired_dropped"] == 1
            assert "admission queue" in body["error"]
    finally:
        for h in hs.values():
            h.close()


def test_debug_surfaces(hs_on):
    rolled = {}
    for name, h in hs_on.items():
        _seed(h)
        paths = {e["path"] for e in
                 h.client._request("GET", "/debug")["endpoints"]}
        assert "/debug/admission" in paths
        # /status rolls the summary up under the node's observability
        status = h.client._request("GET", "/status?observability=true")
        local = status["observability"]["local"]
        assert local["admission"]["state"] == "NORMAL"
        assert local["admission"]["admitted"] >= 1
        rolled[name] = local["admission"]
    assert rolled["port"] == rolled["jax"]


def test_stale_marker_on_stale_ok(hs_on):
    for name, h in hs_on.items():
        _seed(h)
        adm = h.api._admission
        a = PKGS[name].adm
        adm._target_state = lambda a=a: (a.STALE_OK, "forced")
        adm.maybe_update_ladder(time.monotonic() + 2)
    got = _both_post(hs_on, lambda h: "/index/adm/query", b"Count(Row(f=1))")
    for status, _, body in got.values():
        assert status == 200
        assert body["stale"] is True
    assert got["port"][2] == got["jax"][2]


def test_ingest_sheds_interval_merges_not_overflow(tmp_path):
    hs = _pair(tmp_path, admission="on", ingest_interval=0.05)
    try:
        for name, h in hs.items():
            idx = _seed(h, "ing")
            adm = h.api._admission
            a = PKGS[name].adm
            adm._target_state = lambda a=a: (a.SHED_BATCH, "forced")
            adm.maybe_update_ladder(time.monotonic() + 2)
            assert h.api.ingest._shed_probe == adm.shed_merges
            h.client.import_bits(idx, "f", [2], [7])
        time.sleep(0.25)  # several ticks land while shedding
        for h in hs.values():
            snap = h.api.ingest.snapshot()
            assert snap["merges_shed"] >= 1
            assert snap["pending"]["entries"] >= 1  # deltas still buffered
    finally:
        for h in hs.values():
            h.close()


def test_zero_priced_dispatches(tmp_path):
    """price() keeps the planner's zero-dispatch contract — cost
    estimation can never execute the query — and both packages price
    the same query from the same floor."""
    hs = _pair(tmp_path, admission="on")
    try:
        for name, h in hs.items():
            p = PKGS[name]
            idx = _seed(h, "pz")
            adm = h.api._admission
            before = _dispatches(h.api)
            cost = adm.price(h.api.executor, h.api.holder.index(idx),
                             p.parse("GroupBy(Rows(f))"), None,
                             p.exec.ExecOptions())
            assert cost >= p.adm.FALLBACK_COST_MS
            assert _dispatches(h.api) == before
    finally:
        for h in hs.values():
            h.close()


# ------------------------------------------------------- cluster fan-out

def _cluster(pkg, index):
    """A 2-node, replicas-1 cluster of `pkg` (ModHasher: both nodes own
    shards) with 6 shards of one bit each in `index`."""
    if pkg.name == "jax":
        import pilosa_tpu.cluster as cmod

        from tests.harness import ClusterHarness as harness
    else:
        import pilosa_tpu_torch.cluster as cmod
        from pilosa_tpu_torch.tools.cluster import ClusterHarness as harness

    h = harness(2, replica_n=1, hasher=cmod.ModHasher())
    h[0].client.create_index(index)
    h[0].client.create_field(index, "f")
    time.sleep(0.3)  # DDL broadcast settles
    cols = [s * SHARD_WIDTH + 2 for s in range(6)]
    h[0].client.import_bits(index, "f", [1] * len(cols), cols)
    owners = {h[0].cluster.shard_nodes(index, s)[0].id for s in range(6)}
    assert len(owners) == 2, "ModHasher should use both nodes"
    return h


def test_deadline_survives_cluster_fanout():
    """A generous deadline rides the whole fan-out and serves; one
    expired on arrival at the coordinator is a 504 and NO node launches
    anything — on both packages' clusters."""
    out = []
    for p in BOTH:
        h = _cluster(p, "cd")
        try:
            ok = h[0].client.query("cd", "Count(Row(f=1))",
                                   deadline=30.0)["results"]
            before = [_dispatches(n.api) for n in h.nodes]
            status, _, body = _post(
                f"{h[0].address}/index/cd/query", b"Count(Row(f=1))",
                {"X-Request-Deadline": "-0.5"})
            out.append((ok, status, body,
                        [_dispatches(n.api) for n in h.nodes] == before))
        finally:
            h.close()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1][0] == [6] and out[1][1] == 504 and out[1][3]


def test_peer_overload_retried_same_replica_not_marked_unready():
    """A peer shedding (503 + X-Pilosa-Shed) past the coordinator's
    client retries gets ONE same-replica retry from the cluster executor,
    which serves: `cluster.node_overload` is recorded, never
    `cluster.node_unready`."""
    out = []
    for p in BOTH:
        h = _cluster(p, "ov")
        try:
            peer = h[1]
            real_query = peer.api.query
            state = {"shed": 3}

            def flaky_query(*a, real_query=real_query, state=state, p=p,
                            **kw):
                if kw.get("options") is not None and kw["options"].remote \
                        and state["shed"] > 0:
                    state["shed"] -= 1
                    p.api.shed_reject("admission", "synthetic overload", 1,
                                      qclass="interactive")
                return real_query(*a, **kw)

            peer.api.query = flaky_query
            resp = h[0].client.query("ov", "Count(Row(f=1))")
            kinds = [e["kind"] for e in p.flightrec.snapshot()["events"]]
            out.append((resp["results"], "cluster.node_overload" in kinds,
                        "cluster.node_unready" in kinds, state["shed"]))
        finally:
            h.close()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1] == ([6], True, False, 0)


def test_peer_unready_503_still_flagged_unready():
    """A peer answering a plain 503 (its device link DOWN) is flagged
    `cluster.node_unready`, not overloaded; with replicas 1 its shards
    have no replica, so the query fails."""
    out = []
    for p in BOTH:
        h = _cluster(p, "ur")
        try:
            peer = h[1]
            real_query = peer.api.query

            def unready_query(*a, real_query=real_query, p=p, **kw):
                if kw.get("options") is not None and kw["options"].remote:
                    raise p.api.ServiceUnavailableError(
                        "device link DOWN", retry_after=5)
                return real_query(*a, **kw)

            peer.api.query = unready_query
            with pytest.raises(Exception) as err:
                h[0].client.query("ur", "Count(Row(f=1))")
            kinds = [e["kind"] for e in p.flightrec.snapshot()["events"]]
            out.append((getattr(err.value, "status", None),
                        "cluster.node_unready" in kinds,
                        "cluster.node_overload" in kinds))
        finally:
            h.close()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1][1:] == (True, False)
