"""The port's collective data plane (pilosa_tpu_torch/cluster/spmd.py) on
a real 3-process cluster: `python -m pilosa_tpu_torch server --device cpu
--spmd --spmd-cpu-collectives gloo --replicas 1` children on localhost
(`tools.cluster.ProcCluster`), every node one rank of one gloo group.
Count, Sum, Min/Max, TopN and GroupBy merges must ride the group's
collective — every process runs the step, its step counter advances —
not the HTTP merge.

The cases of the TPU package's process suite, each run on the port:
- tests/test_spmd.py (13): every collective kind from the coordinator
  and forwarded from the other nodes, the amortized pre-flight, BSI
  conditions and time ranges as leaves, uncoverable calls and Row
  results on the HTTP path, GroupBy pagination;
- tests/test_golden_cluster.py::test_golden_over_spmd_cluster: the 43
  golden PQL cases (tests/testdata/golden_pql.json) through every node;
and the port's own: a card failure on one rank (the `spmd.launch` fault
point, armed on that node over POST /debug/faultpoints) fails the query
with a 500 that names the node, counts no fallback and wedges nothing;
a failed host gather on one rank (`spmd.gather`) falls back to the HTTP
merge and answers right;
EXPLAIN and analyze plan and run the per-node fan-out (serve off, as in
the TPU package) and run no step.

Every answer is also held to the TPU package's: an in-process
`pilosa_tpu` server (JAX on the CPU, tests/harness) takes each write the
cluster takes, or the golden file's `want`s. The TPU package's
collective-plane skip probe is not copied: the group forms here, so
every step-counter assertion runs. The children run one OpenMP thread
each (three torch processes spinning on shared cores slow every CPU
launch a hundredfold). PILOSA_TPU_PROC_TESTS=0 skips the file.
"""

import os
import shutil
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cluster import spmd  # noqa: E402
from pilosa_tpu_torch.server.client import ClientError  # noqa: E402
from pilosa_tpu_torch.tools.cluster import ProcCluster, free_ports  # noqa: E402,E501

from tests.harness import ServerHarness  # noqa: E402
from tests.test_golden_cluster import (  # noqa: E402
    _apply_setup, _create_schema, load_golden)

pytestmark = pytest.mark.skipif(
    os.environ.get("PILOSA_TPU_PROC_TESTS", "1") == "0",
    reason="process cluster tests disabled")


class Mirror:
    """The port's cluster (written through its coordinator) and the TPU
    package's single node, fed the same writes."""

    def __init__(self, cluster, ref):
        self.cluster = cluster
        self.ref = ref
        self.coord = cluster.clients[cluster.coord]

    def create_field(self, field, options=None):
        self.coord.create_field("sp", field, options)
        self.ref.client.create_field("sp", field, options)

    def import_bits(self, field, rows, cols, **kw):
        self.coord.import_bits("sp", field, rows, cols, **kw)
        self.ref.client.import_bits("sp", field, rows, cols, **kw)

    def import_values(self, field, cols, vals):
        self.coord.import_values("sp", field, cols, vals)
        self.ref.client.import_values("sp", field, cols, vals)

    def ask(self, pql, node=None):
        """results[0] through node `node` (the coordinator by default),
        checked equal to the TPU package's answer."""
        client = self.coord if node is None else self.cluster.clients[node]
        got = client.query("sp", pql)["results"][0]
        want = self.ref.client.query("sp", pql)["results"][0]
        assert got == want, (pql, got, want)
        return got


@pytest.fixture(scope="module")
def cluster():
    spmd_port = free_ports(1)[0]
    c = ProcCluster(
        3, replica_n=1, device="cpu",
        extra_flags=["--spmd", "--spmd-port", str(spmd_port),
                     "--spmd-cpu-collectives", "gloo"],
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    # placement sorts nodes by id; the coordinator (the step initiator)
    # is the smallest host:port, not necessarily clients[0]
    c.coord = min(range(3), key=lambda i: c.hosts[i])
    ref = ServerHarness()
    try:
        c.wait_ready(timeout=120)
        c.clients[0].create_index("sp")
        ref.client.create_index("sp")
        c.mirror = Mirror(c, ref)
        c.mirror.create_field("f")
        c.mirror.create_field("g")
        time.sleep(1.0)  # DDL broadcast settles
        yield c
    finally:
        codes = c.close()
        c.remove_dirs()
        ref.close()
        shutil.rmtree(ref.data_dir, ignore_errors=True)
    # every node leaves the group and stops cleanly on SIGTERM
    assert codes == [0, 0, 0], codes


def _stats(cluster):
    return [cl._request("GET", "/internal/spmd/stats")
            for cl in cluster.clients]


def _spmd_steps(cluster):
    return [s["steps"] for s in _stats(cluster)]


def _advanced(cluster, before, n):
    after = _spmd_steps(cluster)
    assert all(a - b == n for a, b in zip(after, before)), (before, after)
    return after


def test_count_merges_via_collective(cluster):
    m = cluster.mirror
    # bits across 6 shards -> shards land on all 3 nodes (jump hash)
    cols = [s * SHARD_WIDTH + off for s in range(6) for off in (0, 7, 99)]
    m.import_bits("f", [1] * len(cols), cols)
    m.import_bits("g", [2] * (len(cols) // 2), cols[::2])

    before = _spmd_steps(cluster)
    assert m.ask("Count(Row(f=1))") == len(cols)
    assert m.ask("Count(Intersect(Row(f=1), Row(g=2)))") == len(cols[::2])
    # EVERY process ran both steps: the merge was one collective over
    # the group, not an HTTP reduce
    _advanced(cluster, before, 2)
    launches = [s["launches"]["count_expr"] for s in _stats(cluster)]
    assert launches == [0, 0, 0]  # the CPU runs K1's plain version

    # a profiled Count carries the step's phases on its spmd.step span,
    # with no span per gathered shard (a profile keeps at most 512)
    prof = m.coord.query("sp", "Count(Row(f=1))", profile=True)["profile"]
    steps = [s for s in _walk(prof["spans"]) if s["name"] == "spmd.step"]
    assert len(steps) == 1, prof
    assert set(steps[0]["tags"]["phases_ms"]) == set(spmd.STEP_PHASES)
    assert not [s for s in _walk(steps[0]) if s["name"] == "workpool.task"]


def _walk(span):
    yield span
    for child in span["children"]:
        yield from _walk(child)


def test_non_coordinator_initiates_via_forward(cluster):
    """A query POSTed to a NON-coordinator node still rides the
    collective: the node forwards the eligible call to the coordinator
    in one hop."""
    m = cluster.mirror
    cols = [s * SHARD_WIDTH + 3 for s in range(4)]
    m.import_bits("f", [9] * len(cols), cols)
    time.sleep(0.2)
    before = _spmd_steps(cluster)
    for i in range(3):
        node = (cluster.coord + i) % 3
        assert m.ask("Count(Row(f=9))", node=node) == len(cols)
    _advanced(cluster, before, 3)
    forwards = [s["forwarded"] for s in _stats(cluster)]
    assert sum(forwards) >= 2, forwards


def test_uncoverable_falls_back(cluster):
    m = cluster.mirror
    cols = [s * SHARD_WIDTH + 3 for s in range(4)]
    m.import_bits("f", [9] * len(cols), cols)
    time.sleep(0.2)
    before = _spmd_steps(cluster)
    # an uncoverable tree (Shift): HTTP merge on the coordinator AND
    # through a non-coordinator
    for node in (cluster.coord, (cluster.coord + 1) % 3):
        assert m.ask("Count(Shift(Row(f=9), n=1))", node=node) == len(cols)
    assert _spmd_steps(cluster) == before


def test_count_preflight_amortized(cluster):
    """A steady-state Count costs ONE control-plane round: the
    validation round runs once per (index, membership) epoch."""
    coord = cluster.clients[cluster.coord]

    def stats():
        return coord._request("GET", "/internal/spmd/stats")

    cluster.mirror.ask("Count(Row(f=1))")  # prime the epoch
    s0 = stats()
    cluster.mirror.ask("Count(Row(f=1))")
    cluster.mirror.ask("Count(Row(f=9))")
    s1 = stats()
    assert s1["steps"] - s0["steps"] == 2
    assert s1["validations"] == s0["validations"], (s0, s1)
    assert s1["validations_skipped"] - s0["validations_skipped"] == 2


def test_row_results_still_http(cluster):
    """Non-aggregate calls keep the HTTP data plane and stay correct."""
    m = cluster.mirror
    cols = [s * SHARD_WIDTH + 11 for s in range(3)]
    m.import_bits("f", [42] * len(cols), cols)
    time.sleep(0.2)
    before = _spmd_steps(cluster)
    got = m.ask("Row(f=42)", node=0)
    assert sorted(got["columns"]) == sorted(cols)
    assert _spmd_steps(cluster) == before


def test_sum_merges_via_collective(cluster):
    m = cluster.mirror
    m.create_field("v", {"type": "int", "min": -1000, "max": 1000})
    time.sleep(1.0)  # DDL broadcast settles
    cols = [s * SHARD_WIDTH + off for s in range(6) for off in (2, 33)]
    vals = [((i * 37) % 2001) - 1000 for i in range(len(cols))]
    m.import_values("v", cols, vals)

    before = _spmd_steps(cluster)
    assert m.ask("Sum(field=v)") == {"value": sum(vals), "count": len(vals)}
    before = _advanced(cluster, before, 1)

    # a filtered Sum (coverable filter) also rides the collective
    m.import_bits("f", [77] * (len(cols) // 2), cols[::2])
    assert m.ask("Sum(Row(f=77), field=v)") == {
        "value": sum(vals[::2]), "count": len(cols[::2])}
    _advanced(cluster, before, 1)


def test_topn_merges_via_collective(cluster):
    m = cluster.mirror
    m.create_field("tf")
    time.sleep(1.0)
    # row 1: 12 cols, row 2: 6 cols, row 3: 2 cols across 6 shards
    rows, cols = [], []
    for s in range(6):
        rows += [1, 1, 2]
        cols += [s * SHARD_WIDTH + 1, s * SHARD_WIDTH + 2,
                 s * SHARD_WIDTH + 3]
    rows += [3, 3]
    cols += [5, SHARD_WIDTH + 5]
    m.import_bits("tf", rows, cols)

    before = _spmd_steps(cluster)
    assert m.ask("TopN(tf, n=2)") == [{"id": 1, "count": 12},
                                      {"id": 2, "count": 6}]
    before = _advanced(cluster, before, 1)

    # a filtered TopN (coverable source row) also rides the collective
    m.import_bits("g", [9] * 6, [s * SHARD_WIDTH + 1 for s in range(6)])
    assert m.ask("TopN(tf, Row(g=9), n=3)") == [{"id": 1, "count": 6}]
    _advanced(cluster, before, 1)


def test_minmax_merges_via_collective(cluster):
    """Min/Max ride the collective: each rank walks its own shards, one
    all_gather combines the extremes."""
    m = cluster.mirror
    m.create_field("w", {"type": "int", "min": -500, "max": 500})
    time.sleep(1.0)
    cols = [s * SHARD_WIDTH + off for s in range(6) for off in (4, 19)]
    vals = [((i * 53) % 901) - 450 for i in range(len(cols))]
    m.import_values("w", cols, vals)

    before = _spmd_steps(cluster)
    assert m.ask("Min(field=w)") == {"value": min(vals),
                                     "count": vals.count(min(vals))}
    assert m.ask("Max(field=w)") == {"value": max(vals),
                                     "count": vals.count(max(vals))}
    before = _advanced(cluster, before, 2)

    # a filtered Min (coverable filter) also rides the collective
    m.import_bits("f", [88] * (len(cols) // 2), cols[::2])
    fv = vals[::2]
    assert m.ask("Min(Row(f=88), field=w)") == {"value": min(fv),
                                                "count": fv.count(min(fv))}
    _advanced(cluster, before, 1)


def test_all_aggregates_from_all_nodes(cluster):
    """Every collective kind initiates from EVERY node."""
    m = cluster.mirror
    m.create_field("af")
    m.create_field("av", {"type": "int", "min": 0, "max": 100})
    time.sleep(1.0)
    cols = [s * SHARD_WIDTH + 6 for s in range(6)]
    m.import_bits("af", [4] * len(cols), cols)
    m.import_values("av", cols, [10 * (i + 1) for i in range(len(cols))])
    queries = [
        ("Count(Row(af=4))", len(cols)),
        ("Sum(field=av)", {"value": sum(10 * (i + 1)
                                        for i in range(len(cols))),
                           "count": len(cols)}),
        ("Min(field=av)", {"value": 10, "count": 1}),
        ("Max(field=av)", {"value": 60, "count": 1}),
        ("TopN(af, n=1)", [{"id": 4, "count": len(cols)}]),
        ("GroupBy(Rows(af))",
         [{"group": [{"field": "af", "rowID": 4}], "count": len(cols)}]),
    ]
    before = _spmd_steps(cluster)
    for i, (pql, want) in enumerate(queries):
        assert m.ask(pql, node=i % 3) == want, pql
    _advanced(cluster, before, len(queries))


def test_bsi_condition_count_via_collective(cluster):
    """Count(Row(v > t)) rides the collective: each process contributes
    locally evaluated condition planes."""
    m = cluster.mirror
    m.create_field("cv", {"type": "int", "min": -100, "max": 100})
    time.sleep(1.0)
    cols = [s * SHARD_WIDTH + off for s in range(6) for off in (8, 21)]
    vals = [((i * 17) % 201) - 100 for i in range(len(cols))]
    m.import_values("cv", cols, vals)

    before = _spmd_steps(cluster)
    assert m.ask("Count(Row(cv > 0))") == sum(1 for v in vals if v > 0)
    assert m.ask("Count(Row(cv >< [-10, 10]))") == sum(
        1 for v in vals if -10 <= v <= 10)
    before = _advanced(cluster, before, 2)

    # condition leaves also work as aggregate FILTERS over the collective
    m.create_field("cw", {"type": "int", "min": 0, "max": 50})
    time.sleep(1.0)
    m.import_values("cw", cols, [i + 1 for i in range(len(cols))])
    want = sum(i + 1 for i, v in enumerate(vals) if v > 0)
    assert m.ask("Sum(Row(cv > 0), field=cw)") == {
        "value": want, "count": sum(1 for v in vals if v > 0)}
    _advanced(cluster, before, 1)


def test_groupby_merges_via_collective(cluster):
    """GroupBy rides the collective: per-child candidate rows union in
    the validation round, each rank counts the cross product with K4's
    plain version, one all_reduce of the cells."""
    m = cluster.mirror
    m.create_field("ga")
    m.create_field("gb")
    m.create_field("gc")
    time.sleep(1.0)
    rows_a, cols_a, rows_b, cols_b = [], [], [], []
    for s in range(6):
        base = s * SHARD_WIDTH
        rows_a += [1, 1, 2]
        cols_a += [base + 0, base + 1, base + 2]
        rows_b += [10, 11, 11]
        cols_b += [base + 0, base + 1, base + 2]
    m.import_bits("ga", rows_a, cols_a)
    m.import_bits("gb", rows_b, cols_b)
    m.import_bits("gc", [5, 6] * 6, [s * SHARD_WIDTH + off
                                     for s in range(6) for off in (1, 2)])

    expected = [
        {"group": [{"field": "ga", "rowID": 1},
                   {"field": "gb", "rowID": 10}], "count": 6},
        {"group": [{"field": "ga", "rowID": 1},
                   {"field": "gb", "rowID": 11}], "count": 6},
        {"group": [{"field": "ga", "rowID": 2},
                   {"field": "gb", "rowID": 11}], "count": 6},
    ]
    before = _spmd_steps(cluster)
    assert m.ask("GroupBy(Rows(ga), Rows(gb))") == expected
    before = _advanced(cluster, before, 1)

    # non-coordinator initiation works for GroupBy too (one forward hop)
    other = (cluster.coord + 1) % 3
    assert m.ask("GroupBy(Rows(ga), Rows(gb), limit=2)",
                 node=other) == expected[:2]
    before = _advanced(cluster, before, 1)

    # three fields: the outer rows intersect into K4's filter, with a
    # filter of its own
    got = m.ask("GroupBy(Rows(gc), Rows(ga), Rows(gb), "
                "filter=Row(ga=1))")
    assert got == [{"group": [{"field": "gc", "rowID": 5},
                              {"field": "ga", "rowID": 1},
                              {"field": "gb", "rowID": 11}], "count": 6}]
    _advanced(cluster, before, 1)


def test_time_range_count_via_collective(cluster):
    """Time-range Row trees ride the collective: each process contributes
    the union of its local quantum-view blocks."""
    m = cluster.mirror
    m.create_field("tt", {"type": "time", "timeQuantum": "YMD"})
    time.sleep(1.0)
    cols = [s * SHARD_WIDTH + 13 for s in range(6)]
    m.import_bits("tt", [1] * len(cols), cols,
                  timestamps=["2019-01-02T03:04"] * 3
                  + ["2020-06-07T08:09"] * 3)

    before = _spmd_steps(cluster)
    assert m.ask("Count(Row(tt=1, from=2019-01-01T00:00, "
                 "to=2019-02-01T00:00))") == 3
    _advanced(cluster, before, 1)


def test_groupby_previous_pagination_any_plane(cluster):
    """GroupBy list-cursor pagination answers identically over the
    collective plane: pages concatenate to the one-shot result."""
    m = cluster.mirror
    m.create_field("pa")
    m.create_field("pb")
    time.sleep(1.0)
    cols = [s * SHARD_WIDTH + off for s in range(6) for off in range(8)]
    m.import_bits("pa", [i % 3 for i in range(len(cols))], cols)
    m.import_bits("pb", [i % 4 for i in range(len(cols))], cols)

    full = m.ask("GroupBy(Rows(pa), Rows(pb))")
    assert len(full) == 12  # (i%3, i%4) cycles with period 12: all pairs
    pages, prev = [], None
    for _ in range(len(full) + 2):  # bounded: must terminate
        pql = "GroupBy(Rows(pa), Rows(pb), limit=5{})".format(
            "" if prev is None else f", previous=[{prev[0]}, {prev[1]}]")
        page = m.ask(pql)
        if not page:
            break
        assert len(page) <= 5
        pages.extend(page)
        prev = (page[-1]["group"][0]["rowID"],
                page[-1]["group"][1]["rowID"])
    assert pages == full

    # a malformed cursor errors on the wire instead of serving page 1
    with pytest.raises(ClientError):
        m.coord.query("sp", "GroupBy(Rows(pa), Rows(pb), previous=[1])")


def test_device_failure_on_one_rank_is_a_500(cluster):
    """Trap 30 on the plane: a rank whose card fails at the step's
    launch still enters the collective with its failure slot set, so
    the query fails with a 500 naming that node — no HTTP fallback, no
    wedge — and the next query is served over the collective again."""
    m = cluster.mirror
    coord = cluster.clients[cluster.coord]
    peer = (cluster.coord + 1) % 3
    want = m.ask("Count(Row(f=1))")
    for armed, via in ((peer, cluster.coord), (cluster.coord, peer)):
        cluster.clients[armed]._request(
            "POST", "/debug/faultpoints",
            b'{"arm": "spmd.launch=raise"}')
        s0 = _stats(cluster)
        with pytest.raises(ClientError) as e:
            cluster.clients[via].query("sp", "Count(Row(f=1))")
        assert e.value.status == 500
        assert cluster.hosts[armed] in str(e.value), str(e.value)
        assert "CUDA error" in str(e.value)
        s1 = _stats(cluster)
        # the collective ran on every rank (nobody was left in it) ...
        assert [b["steps"] - a["steps"] for a, b in zip(s0, s1)] \
            == [1, 1, 1]
        # ... and the failure was not served over HTTP behind the card
        assert [b["fallbacks"] for b in s1] == [a["fallbacks"] for a in s0]
        assert coord._request("GET", "/internal/spmd/stats")[
            "device_failures"] >= 1
        # the next query: the collective again, equal to the reference
        assert m.ask("Count(Row(f=1))", node=via) == want
        assert [s["steps"] for s in _stats(cluster)] \
            == [s["steps"] + 2 for s in s0]


def test_golden_over_spmd_cluster(cluster):
    """The 43 golden cases through every node, against the wants the
    TPU package's executor produced; every node's step counter moves."""
    setup, cases = load_golden()
    _create_schema(cluster.clients[cluster.coord])
    time.sleep(1.0)  # DDL broadcast settles
    _apply_setup(cluster.clients[cluster.coord], setup)
    assert len(cases) == 43
    before = _spmd_steps(cluster)
    failures = []
    for node, client in enumerate(cluster.clients):
        for name, pql, want, whole in cases:
            results = client.query("gold", pql)["results"]
            got = results if whole else results[0]
            if got != want:
                failures.append(f"{name} (via node {node}): {pql}\n"
                                f"  got:  {got}\n  want: {want}")
    assert not failures, "\n".join(failures)
    after = _spmd_steps(cluster)
    assert all(a - b > 0 for a, b in zip(after, before)), (before, after)
    assert len(set(a - b for a, b in zip(after, before))) == 1
    stats = _stats(cluster)
    assert all(s["fallbacks"] == 0 for s in stats), stats


def test_explain_shows_the_http_plan_and_runs_no_step(cluster):
    """Serve-off, as in the TPU package: EXPLAIN plans the per-node
    fan-out, its call node marked `spmd_bypassed`, and runs no
    collective step; analyze runs the fan-out legs and answers right."""
    m = cluster.mirror
    coord = cluster.clients[cluster.coord]
    pql = "Count(Row(f=1))"
    want = m.ask(pql)
    before = _spmd_steps(cluster)
    plan = coord.query("sp", pql, explain="plan")["plan"]
    node = plan["calls"][0]
    assert node["strategy"] == "cluster-map-reduce"
    assert node["annotations"]["spmd_bypassed"] is True
    resp = coord.query("sp", pql, explain="analyze")
    assert resp["results"] == [want]
    assert resp["plan"]["calls"][0]["annotations"]["spmd_bypassed"] is True
    assert _spmd_steps(cluster) == before


@pytest.mark.parametrize("leaf", ["row", "condition"])
def test_gather_failure_on_one_rank_falls_back_to_http(cluster, leaf):
    """A rank whose host gather fails (the `spmd.gather` fault point:
    a Row leaf's fragment gather, or a BSI condition leaf's) still
    enters the collective, its failure slot set to a non-card failure:
    the coordinator serves the call over the HTTP merge, equal to the
    reference, counts one fallback, and the next query rides the
    collective again."""
    m = cluster.mirror
    if leaf == "row":
        pql = "Count(Row(f=1))"
    else:
        m.create_field("gq", {"type": "int", "min": -50, "max": 50})
        time.sleep(1.0)  # DDL broadcast settles
        cols = [s * SHARD_WIDTH + off for s in range(6) for off in (4, 40)]
        m.import_values("gq", cols, [(i % 11) - 5 for i in range(len(cols))])
        pql = "Count(Row(gq > 0))"
    want = m.ask(pql)
    peer = (cluster.coord + 1) % 3
    cluster.clients[peer]._request("POST", "/debug/faultpoints",
                                   b'{"arm": "spmd.gather=raise"}')
    s0 = _stats(cluster)
    assert m.ask(pql) == want
    s1 = _stats(cluster)
    armed = cluster.clients[peer]._request("GET", "/debug/faultpoints")
    assert [p["fired"] for p in armed["points"]
            if p["name"] == "spmd.gather"] == [1], armed
    # every rank ran the step, and the coordinator fell back once
    assert [b["steps"] - a["steps"] for a, b in zip(s0, s1)] == [1, 1, 1]
    assert s1[cluster.coord]["fallbacks"] \
        == s0[cluster.coord]["fallbacks"] + 1
    assert [b["device_failures"] for b in s1] \
        == [a["device_failures"] for a in s0]
    # the next query: the collective again, no new fallback
    assert m.ask(pql) == want
    s2 = _stats(cluster)
    assert [b["steps"] - a["steps"] for a, b in zip(s1, s2)] == [1, 1, 1]
    assert [b["fallbacks"] for b in s2] == [a["fallbacks"] for a in s1]
