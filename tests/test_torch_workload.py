"""The port's workload observatory (utils/workload.py) against the TPU
package's, on the CPU: query fingerprints and the per-shape table, the
fragment heat ledger joined against the HBM ledger, and SLO burn.

`tests/test_workload.py` ported to the port's executor and server (the
/status roll-up on one node and on a 2-node cluster of each package; the
misestimate attribution at the workload API and through the planner's
analyze).
Beside them:

- `fingerprint(index, query)` gives the same (fingerprint, shape) in
  both packages for a corpus of 120 PQL queries covering every call of
  the port's PORTED_CALLS with varied literals, each package parsing
  its own query;
- the heat ledger gives equal values after the same bumps at fixed
  times (1e-12 relative: the decay is a float power);
- /debug/workload after the same served queries gives the same
  fingerprints, shapes and counts on both servers.
"""

import json
import re

import numpy as np
import pytest

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import stacked
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import flightrec
from pilosa_tpu_torch.utils import profile as profile_mod
from pilosa_tpu_torch.utils import workload
from pilosa_tpu_torch.utils.logger import CaptureLogger
from pilosa_tpu_torch.utils.stats import StatsClient, global_stats

N_SHARDS = 3  # >= MIN_SHARDS so the stacked cache engages


@pytest.fixture(autouse=True)
def _pristine_workload():
    workload.reset()
    yield
    workload.reset()


@pytest.fixture
def env(tmp_path):
    h = Holder(str(tmp_path / "data")).open()
    idx = h.create_index("i")
    idx.create_field("a")
    idx.create_field("b")
    cols = [s * SHARD_WIDTH + off
            for s in range(N_SHARDS) for off in (0, 3, 7, 11)]
    idx.field("a").import_bits([i % 3 for i in range(len(cols))], cols)
    idx.field("b").import_bits([i % 2 for i in range(len(cols))], cols)
    e = Executor(h, device="cpu")
    yield h, e
    h.close()


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


# ------------------------------------------------------------ fingerprints


def test_fingerprint_strips_literals_keeps_shape():
    def fp(q):
        return workload.fingerprint("i", parse(q))[0]

    assert fp("Count(Row(f=3))") == fp("Count(Row(f=999))")
    assert fp("Row(v > 10)") == fp("Row(v > 7777)")
    assert fp("Row(f=1, from='2020-01-01T00:00', to='2020-02-01T00:00')") \
        == fp("Row(f=1, from='2024-06-01T00:00', to='2024-07-01T00:00')")
    assert fp("Count(Row(f=3))") != fp("Count(Row(g=3))")
    assert fp("Row(v > 10)") != fp("Row(v < 10)")
    assert fp("Count(Row(f=3))") != fp("Row(f=3)")
    assert fp("Intersect(Row(f=1), Row(g=1))") \
        != fp("Union(Row(f=1), Row(g=1))")
    assert workload.fingerprint("i", parse("Row(f=1)"))[0] \
        != workload.fingerprint("j", parse("Row(f=1)"))[0]
    assert fp("GroupBy(Rows(f), limit=10)") == fp("GroupBy(Rows(f), limit=99)")


def test_executor_folds_same_shape_into_one_entry(env):
    _, e = env
    for row in (0, 1, 2):
        e.execute("i", f"Count(Row(a={row}))")
    e.execute("i", "Count(Row(b=0))")
    snap = workload.table().snapshot(top=10)
    assert snap["total_queries"] == 4
    assert snap["unique_fingerprints"] == 2
    by_shape = {e_["shape"]: e_ for e_ in snap["by_frequency"]}
    a_entry = by_shape["i:Count(Row(a=_))"]
    assert a_entry["count"] == 3
    assert a_entry["total_wall_seconds"] > 0
    assert a_entry["dispatches"] >= 1
    assert by_shape["i:Count(Row(b=_))"]["count"] == 1


def test_strategy_distribution_lands_on_fingerprint(env):
    _, e = env
    e.execute("i", "Count(Row(a=1))")
    e.execute("i", "Count(Row(a=1))", shards=[0])
    snap = workload.table().snapshot(top=5)
    strategies = snap["by_frequency"][0]["strategies"]
    assert strategies == {"Count=per-shard": 1, "Count=stacked": 1}


def test_table_bounded_lru_eviction():
    t = workload.WorkloadTable(max_entries=4)
    for i in range(6):
        t.record(f"fp{i}", f"shape{i}", "i", 0.001)
    snap = t.snapshot(top=10)
    assert snap["unique_fingerprints"] == 4
    assert snap["evicted"] == 2
    assert snap["total_queries"] == 6
    kept = {e["fingerprint"] for e in snap["by_frequency"]}
    assert kept == {"fp2", "fp3", "fp4", "fp5"}
    t.record("fp2", "shape2", "i", 0.001)
    t.record("fp6", "shape6", "i", 0.001)
    kept = {e["fingerprint"]
            for e in t.snapshot(top=10)["by_frequency"]}
    assert "fp2" in kept and "fp3" not in kept


def test_plan_ring_dedupes_by_fingerprint():
    """Repeats of one misestimated shape hold ONE ring slot with a
    repeat count; anonymous records keep plain ring semantics."""
    from pilosa_tpu_torch.exec import plan as plan_mod

    plan_mod.clear_recent()
    try:
        for i in range(3):
            plan_mod.record({"index": "i", "seq": i}, fingerprint="abcd")
        got = plan_mod.recent()
        assert len(got) == 1
        assert got[0]["repeat_count"] == 3
        assert got[0]["fingerprint"] == "abcd"
        assert got[0]["seq"] == 2  # latest plan wins the slot
        assert plan_mod.stats()["repeats_collapsed"] == 2
        plan_mod.record({"index": "i"}, fingerprint="efgh")
        assert [p.get("fingerprint") for p in plan_mod.recent()] \
            == ["efgh", "abcd"]
    finally:
        plan_mod.clear_recent()


def test_misestimates_attribute_to_fingerprint(env, monkeypatch):
    """A misestimate noted while a query's context is open counts
    against that fingerprint and ranks it in by_misestimate_rate; a
    wildly wrong cost estimate of the planner's analyze counts against
    the in-flight query's fingerprint AND dedupes its retained plans."""
    from pilosa_tpu_torch.exec import plan as plan_mod
    from pilosa_tpu_torch.exec.executor import ExecOptions

    ctx = workload.begin_query("i", parse("Count(Row(a=1))"))
    workload.note_misestimate()
    workload.note_misestimate()
    workload.end_query(ctx, 0.002)
    ctx = workload.begin_query("i", parse("Count(Row(a=2))"))
    workload.end_query(ctx, 0.001)
    entry = workload.table().snapshot(top=5)["by_misestimate_rate"][0]
    assert entry["misestimates"] == 2
    assert entry["misestimate_rate"] == 1.0
    assert entry["count"] == 2
    assert workload.last_fingerprint() == entry["fingerprint"]

    workload.reset()
    plan_mod.clear_recent()
    _, e = env
    monkeypatch.setattr(plan_mod.CostModel, "dispatch_seconds",
                        lambda self, family: (100.0, "default"))
    try:
        for row in (1, 2):
            e.execute("i", f"Count(Row(a={row}))",
                      options=ExecOptions(explain="analyze"))
        entry = workload.table().snapshot(top=5)["by_misestimate_rate"][0]
        assert entry["misestimates"] >= 2
        assert entry["misestimate_rate"] > 0
        # both analyze runs share one fingerprint -> one retained plan
        plans = plan_mod.recent()
        assert len(plans) == 1
        assert plans[0]["repeat_count"] == 2
        assert plans[0]["fingerprint"] == entry["fingerprint"]
    finally:
        plan_mod.clear_recent()


# ------------------------------------------------------------------- heat


def test_heat_decay_halves_per_half_life():
    led = workload.HeatLedger(half_life=1.0)
    led.bump("i", "f", "standard", now=100.0)
    led.bump("i", "f", "standard", now=100.0)
    snap = led.snapshot(now=101.0)
    assert snap[0]["heat"] == pytest.approx(1.0, abs=1e-6)
    snap = led.snapshot(now=103.0)
    assert snap[0]["heat"] == pytest.approx(0.25, abs=1e-6)
    led.bump("i", "f", "standard", now=101.0)
    snap = led.snapshot(now=101.0)
    assert snap[0]["heat"] == pytest.approx(2.0, abs=1e-6)
    assert snap[0]["touches"] == 3


def test_heat_report_joins_residency():
    led = workload.HeatLedger(half_life=300.0)
    led.bump("i", "hot_gone", "standard", amount=5.0, now=100.0)
    led.bump("i", "hot_here", "standard", amount=5.0, now=100.0)
    led.bump("i", "cold_here", "standard", amount=0.01, now=100.0)
    hbm = {"by_index_field": [
        {"index": "i", "field": "hot_here", "pool": "stack", "bytes": 4096},
        {"index": "i", "field": "cold_here", "pool": "stack", "bytes": 8192},
    ]}
    rep = led.report(hbm, top=10, now=100.0)
    assert [(e["index"], e["field"]) for e in rep["hot_but_not_resident"]] \
        == [("i", "hot_gone")]
    assert [(e["index"], e["field"]) for e in rep["resident_but_cold"]] \
        == [("i", "cold_here")]
    assert rep["resident_but_cold"][0]["bytes"] == 8192
    assert rep["hot_but_not_resident_total"] == 1
    assert rep["resident_but_cold_total"] == 1
    _, gauges, _ = global_stats.snapshot()
    assert any(k[0] == "fragment_heat" and v > 0 for k, v in gauges.items())


def test_heat_both_lists_under_constrained_budget(tmp_path, monkeypatch):
    """A cache budget too small for the working set leaves evicted but
    demanded fields hot and resident fields cold."""
    monkeypatch.setattr(stacked, "MAX_STACK_BYTES", 4096)
    h = Holder(str(tmp_path / "data")).open()
    try:
        idx = h.create_index("w")
        cols = [s * SHARD_WIDTH + off
                for s in range(N_SHARDS) for off in (0, 5)]
        for name in ("f0", "f1", "f2", "f3"):
            idx.create_field(name)
            idx.field(name).import_bits([1] * len(cols), cols)
        e = Executor(h, device="cpu")
        for name in ("f0", "f1", "f2", "f3"):
            e.execute("w", f"Count(Row({name}=1))")
        hbm = e.hbm_stats(top=0)
        resident = {(r["index"], r["field"])
                    for r in hbm["by_index_field"]}
        assert resident, "nothing resident — cache never engaged"
        tracked = {(k[0], k[1]) for k in workload.heat()._heat}
        evicted = tracked - resident
        assert evicted, "budget fit the whole working set — not constrained"
        with workload.heat()._lock:
            for entry in workload.heat()._heat.values():
                entry[1] -= 3600.0
        hot_idx, hot_field = next(iter(evicted))
        workload.heat_bump(hot_idx, hot_field, "standard", amount=5.0)
        rep = workload.heat().report(e.hbm_stats(top=0), top=10)
        hot_missing = [(x["index"], x["field"])
                       for x in rep["hot_but_not_resident"]]
        assert (hot_idx, hot_field) in hot_missing
        assert rep["resident_but_cold"]
        assert all(x["heat"] < workload.HEAT_HOT_MIN
                   for x in rep["resident_but_cold"])
    finally:
        h.close()


# -------------------------------------------------------------------- SLO


def test_parse_slo_specs():
    o = workload.parse_slo("query=50ms@p99")
    assert (o.name, o.threshold_seconds, o.quantile) == ("query", 0.05, 0.99)
    assert o.budget == pytest.approx(0.01)
    o = workload.parse_slo("http=1s@p99.9")
    assert o.threshold_seconds == 1.0
    assert o.quantile == pytest.approx(0.999)
    o = workload.parse_slo("query.GroupBy=250us@p95")
    assert o.threshold_seconds == pytest.approx(250e-6)
    for bad in ("nounit=50@p99", "noq=50ms", "q=50ms@99", "q=0ms@p99",
                "=50ms@p99", "q=50ms@p0", "q=50ms@p100"):
        with pytest.raises(ValueError):
            workload.parse_slo(bad)


def test_slo_burn_trajectory_and_alert(tmp_path):
    """Good traffic burns ~0; an injected spike drives both windows over
    threshold, fires ONE edge-triggered slo.burn_alert (and an slo_burn
    incident bundle), and re-arms only after the fast window
    recovers."""
    from pilosa_tpu_torch.utils import incident

    stats = StatsClient()
    eng = workload.SloEngine(stats=stats)
    eng.configure([workload.parse_slo("query=1ms@p90")], burn_threshold=2.0)
    t0 = 1000.0
    for _ in range(100):
        stats.timing("query_op_seconds", 0.0001, {"op": "Count"})
    eng.sample(now=t0, force=True)
    burns = eng.sample(now=t0 + 1, force=True)
    assert burns["query"]["fast"] == 0.0
    for _ in range(50):
        stats.timing("query_op_seconds", 0.5, {"op": "Count"})
    flightrec.configure(256)
    mgr = incident.configure(str(tmp_path / "inc"), min_interval=0.0)
    try:
        burns = eng.sample(now=t0 + 2, force=True)
        assert burns["query"]["fast"] > 2.0
        assert burns["query"]["slow"] > 2.0
        assert eng.alerts_total == 1
        events = [e for e in flightrec.snapshot()["events"]
                  if e["kind"] == "slo.burn_alert"]
        assert len(events) == 1
        assert events[0]["tags"]["objective"] == "query"
        assert events[0]["tags"]["burn_fast"] > 2.0
        eng.sample(now=t0 + 3, force=True)
        assert eng.alerts_total == 1
        for _ in range(5000):
            stats.timing("query_op_seconds", 0.0001, {"op": "Count"})
        burns = eng.sample(now=t0 + 30, force=True)
        assert burns["query"]["fast"] <= 2.0
        snap = eng.snapshot()
        assert snap["objectives"][0]["alerting"] is False
        assert snap["alerts_total"] == 1
        import time as _time

        deadline = _time.time() + 5
        while not mgr.list() and _time.time() < deadline:
            _time.sleep(0.02)
        assert [m["kind"] for m in mgr.list()] == ["slo_burn"]
    finally:
        incident.stop()
        flightrec.configure(flightrec.DEFAULT_RING_SIZE)


def test_slo_gauges_and_snapshot_shape():
    workload.configure_slo(["wl_probe_seconds=1ms@p90"], burn_threshold=3.0)
    for _ in range(10):
        global_stats.timing("wl_probe_seconds", 0.5)
    workload.slo().sample(force=True)
    snap = workload.slo().snapshot()
    obj = snap["objectives"][0]
    assert obj["spec"] == "wl_probe_seconds=1ms@p90"
    assert obj["total_requests"] >= 10
    assert obj["over_threshold"] >= 10
    assert set(obj["burn_rate"]) == {"fast", "slow"}
    _, gauges, _ = global_stats.snapshot()
    windows = {dict(tags).get("window") for (name, tags) in gauges
               if name == "slo_burn_rate"
               and dict(tags).get("objective") == "wl_probe_seconds"}
    assert windows == {"fast", "slow"}
    with pytest.raises(ValueError):
        workload.configure_slo(["broken spec"])


# ----------------------------------------------------------- HTTP surface


def test_debug_endpoints_over_http(server):
    srv, c = server
    c.create_index("hx")
    c.create_field("hx", "f")
    c.query("hx", "Set(1, f=10)")
    c.query("hx", "Count(Row(f=10))")
    c.query("hx", "Count(Row(f=11))")
    wl = c._request("GET", "/debug/workload?top=5")
    assert wl["total_queries"] >= 3
    count_entry = next(e for e in wl["by_frequency"]
                       if e["shape"] == "hx:Count(Row(f=_))")
    assert count_entry["count"] == 2
    ht = c._request("GET", "/debug/heat?top=5")
    assert set(ht) >= {"tracked", "entries", "hot_but_not_resident",
                       "resident_but_cold", "half_life_seconds"}
    workload.configure_slo(["query=10s@p99"])
    sl = c._request("GET", "/debug/slo")
    assert sl["objectives"][0]["spec"] == "query=10s@p99"
    assert sl["windows"] == {"fast_seconds": 60.0, "slow_seconds": 600.0}
    index = c._request("GET", "/debug")
    paths = {e["path"] for e in index["endpoints"]}
    assert {"/debug/workload", "/debug/heat", "/debug/slo",
            "/debug/vars", "/debug/hbm"} <= paths
    assert all(e["description"] for e in index["endpoints"])


def test_slow_query_log_carries_fingerprint(server):
    """SLOW QUERY lines carry fingerprint=; profile= stays the LAST
    field; a coalesced query's line carries its own fingerprint."""
    srv, c = server
    log = CaptureLogger()
    srv.api.long_query_time = 0.0
    srv.api.logger = log
    profile_mod.clear_recent()
    c.create_index("sq")
    c.create_field("sq", "f")
    c.query("sq", "Set(1, f=10)")
    c.query("sq", "Count(Row(f=10))")
    slow = [line for line in log.lines if "SLOW QUERY" in line]
    m = re.search(r"fingerprint=([0-9a-f]{16})", slow[-1])
    assert m, slow[-1]
    assert m.group(1) == workload.fingerprint(
        "sq", parse("Count(Row(f=10))"))[0]
    json.loads(slow[-1].split("profile=", 1)[1])
    events = [e for e in flightrec.snapshot()["events"]
              if e["kind"] == "query.slow"]
    assert events[-1]["tags"]["fingerprint"] == m.group(1)


def test_status_rolls_up_observatory(server):
    """/status carries the node's workload, heat and slo summaries (the
    reference's cluster roll-up, for the one node)."""
    srv, c = server
    c.create_index("ci")
    c.create_field("ci", "f")
    for col in (1, SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 1):
        c.query("ci", f"Set({col}, f=7)")
    for row in (7, 8, 9, 10):
        c.query("ci", f"Count(Row(f={row}))")
    obs = c._request("GET", "/status?observability=true")["observability"]
    assert set(obs) == {"local"}
    summary = obs["local"]
    assert set(summary) >= {"workload", "heat", "slo", "hbm", "kernels",
                            "device_link"}
    assert summary["slo"]["objectives"] == 0
    assert summary["workload"]["total_queries"] == 7
    assert summary["workload"]["top"]["shape"] == "ci:Count(Row(f=_))"
    assert summary["heat"]["hottest"]["field"] == "f"


def test_batched_members_charge_one_launch(server):
    """A query-batch of Counts records each member under its shape, the
    batch size it rode, and ONE launch for the group."""
    srv, c = server
    c.create_index("qb")
    c.create_field("qb", "f")
    for col in (1, SHARD_WIDTH + 1):
        c.query("qb", f"Set({col}, f=1) Set({col}, f=2)")
    workload.reset()
    out = c._request("POST", "/index/qb/query-batch",
                     json.dumps({"queries": ["Count(Row(f=1))",
                                             "Count(Row(f=2))"]}).encode())
    assert [r["batch"] for r in out["results"]] == [2, 2]
    (entry,) = workload.table().snapshot(top=5)["by_frequency"]
    assert entry["count"] == 2
    assert entry["dispatches"] == 1
    assert entry["strategies"] == {"Count=stacked-batched": 2}
    assert entry["avg_batch_size"] == 2


# ------------------------------------------------------ both packages


def _corpus(n=120, seed=5):
    """PQL over every call of PORTED_CALLS, literals drawn from a seed."""
    rng = np.random.default_rng(seed)

    def r(hi=50):
        return int(rng.integers(0, hi))

    templates = [
        lambda: f"Row(f={r()})",
        lambda: f"Row(v > {r(900)})",
        lambda: f"Row(v >< [{r(10)}, {r(900) + 10}])",
        lambda: f"Range(f={r()}, from=2017-01-0{r(9) + 1}T00:00, "
                f"to=2018-0{r(9) + 1}-01T00:00)",
        lambda: f"Range(v < {r(900)})",
        lambda: f"Count(Intersect(Row(f={r()}), Row(g={r()})))",
        lambda: f"Union(Row(f={r()}), Row(g={r()}), Row(f={r()}))",
        lambda: f"Difference(Row(f={r()}), Row(g={r()}))",
        lambda: f"Xor(Row(f={r()}), Row(g={r()}))",
        lambda: f"Count(Not(Row(f={r()})))",
        lambda: f"Count(Shift(Row(f={r()}), n={r(70)}))",
        lambda: "Count(All())",
        lambda: f"Sum(Row(f={r()}), field=v)",
        lambda: "Min(field=v)" if r(2) else f"Min(Row(g={r()}), field=v)",
        lambda: f"Max(Row(f={r()}), field=v)",
        lambda: "MinRow(field=f)",
        lambda: f"MaxRow(Row(g={r()}), field=f)",
        lambda: f"TopN(f, Row(g={r()}), n={r(20) + 1})",
        lambda: f"Rows(f, limit={r(20) + 1})",
        lambda: f"GroupBy(Rows(f), Rows(g), limit={r(9) + 1})",
        lambda: f"Options(Count(Row(f={r()})), shards=[{r(3)}, {r(3) + 3}])",
        lambda: f"Set({r(10000)}, f={r()})",
        lambda: f"Clear({r(10000)}, g={r()})",
        lambda: f"ClearRow(f={r()})",
        lambda: f"Store(Row(f={r()}), g={r()})",
        lambda: f'SetRowAttrs(f, {r()}, color="c{r()}")',
        lambda: f"SetColumnAttrs({r(10000)}, n={r()})",
        lambda: f"Row(t={r()}, from='2019-0{r(9) + 1}-01T00:00', "
                f"to='2019-1{r(3)}-01T00:00')",
    ]
    queries = [t() for t in templates]
    while len(queries) < n:
        queries.append(templates[r(len(templates))]())
    return queries


def test_fingerprints_equal_to_reference():
    pytest.importorskip("jax")
    from pilosa_tpu.pql import parse as jparse
    from pilosa_tpu.utils import workload as jworkload
    from pilosa_tpu_torch.exec.executor import PORTED_CALLS

    corpus = _corpus()
    assert len(corpus) >= 100
    seen = set()

    def names(call):
        seen.add(call.name)
        for ch in call.children:
            names(ch)

    for q in corpus:
        for call in parse(q).calls:
            names(call)
        for index in ("i", "idx-2"):
            assert workload.fingerprint(index, parse(q)) \
                == jworkload.fingerprint(index, jparse(q)), q
    assert PORTED_CALLS <= seen, PORTED_CALLS - seen


def test_heat_equal_to_reference():
    pytest.importorskip("jax")
    from pilosa_tpu.utils import workload as jworkload

    rng = np.random.default_rng(9)
    bumps = [(f"i{int(rng.integers(0, 2))}", f"f{int(rng.integers(0, 4))}",
              ("standard", "bsi", "standard_2019")[int(rng.integers(0, 3))],
              float(rng.uniform(0.1, 3.0)), 1000.0 + float(t))
             for t in np.sort(rng.uniform(0, 900, 200))]
    ledgers = (workload.HeatLedger(half_life=60.0),
               jworkload.HeatLedger(half_life=60.0))
    for led in ledgers:
        for index, field, view, amount, now in bumps:
            led.bump(index, field, view, amount=amount, now=now)
    for now in (1900.0, 2500.0):
        got, want = (led.snapshot(now=now) for led in ledgers)
        assert [(e["index"], e["field"], e["view"], e["touches"])
                for e in got] == [(e["index"], e["field"], e["view"],
                                   e["touches"]) for e in want]
        for g, w in zip(got, want):
            assert g["heat"] == pytest.approx(w["heat"], rel=1e-12)
        for index, field, view, _, _ in bumps[:20]:
            assert ledgers[0].value(index, field, view, now=now) \
                == pytest.approx(ledgers[1].value(index, field, view,
                                                  now=now), rel=1e-12)
    hbm = {"by_index_field": [
        {"index": "i0", "field": "f1", "pool": "stack", "bytes": 512}]}
    got, want = (led.report(hbm, top=5, now=1900.0) for led in ledgers)
    assert set(got) == set(want)
    assert [(e["index"], e["field"]) for e in got["hot_but_not_resident"]] \
        == [(e["index"], e["field"]) for e in want["hot_but_not_resident"]]


def test_debug_workload_equal_to_reference(tmp_path):
    """The same queries served by both servers: /debug/workload lists the
    same fingerprints, shapes and counts."""
    pytest.importorskip("jax")
    from pilosa_tpu.utils import workload as jworkload
    from pilosa_tpu_torch.cli import start_server
    from pilosa_tpu_torch.server import Client
    from tests.harness import ServerHarness

    jworkload.reset()
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        clients = (ref.client, Client(port.uri))
        for c in clients:
            c.create_index("d")
            c.create_field("d", "f")
            c.create_field("d", "g")
            for col in (1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3):
                c.query("d", f"Set({col}, f={col % 3}) Set({col}, g=1)")
            for q in ("Count(Row(f=1))", "Count(Row(f=2))", "Row(g=1)",
                      "TopN(f, n=2)", "Count(Intersect(Row(f=0), Row(g=1)))",
                      "GroupBy(Rows(f))", "Count(Row(f=0))"):
                c.query("d", q)

        def view(c):
            snap = c._request("GET", "/debug/workload?top=50")
            return snap["total_queries"], sorted(
                (e["fingerprint"], e["shape"], e["count"])
                for e in snap["by_frequency"])

        assert view(clients[1]) == view(clients[0])
    finally:
        port.stop()
        ref.close()
        jworkload.reset()


def test_cluster_status_rolls_up_observatory():
    """The coordinator's /status?observability=true carries the workload,
    heat and slo summaries of EVERY node, on a 2-node cluster of each
    package given the same writes and reads: the same summary keys per
    node, no degraded peer fetch, and the same headline shape."""
    pytest.importorskip("jax")
    import pilosa_tpu.utils.workload as jax_workload
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    out = []
    for harness, wl in ((JaxClusterHarness, jax_workload),
                        (ClusterHarness, workload)):
        wl.reset()
        c = harness(2)
        try:
            coord = c.node_by_id(c[0].cluster.coordinator.id)
            coord.client.create_index("ci")
            coord.client.create_field("ci", "f")
            for col in (1, SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 1):
                coord.client.query("ci", f"Set({col}, f=7)")
            for row in (7, 8, 9, 10):  # 4 reads > 3 writes: Count is top
                coord.client.query("ci", f"Count(Row(f={row}))")
            obs = coord.client._request(
                "GET", "/status?observability=true")["observability"]
            assert len(obs) == 2
            for node_id, summary in obs.items():
                assert "error" not in summary, (node_id, summary)
                assert set(summary) >= {"workload", "heat", "slo"}
                assert summary["slo"]["objectives"] == 0
            local = obs[coord.cluster.local_id]
            peer = next(s for n, s in obs.items()
                        if n != coord.cluster.local_id)
            out.append((sorted(local), sorted(peer),
                        local["workload"]["total_queries"],
                        local["workload"]["top"]["shape"],
                        peer["workload"]["top"]))
        finally:
            c.close()
            wl.reset()
    assert out[1] == out[0], (out[1], out[0])
    assert out[1][3] == "ci:Count(Row(f=_))"
