"""Mesh-resident serving on the port's collective plane over a REAL
3-process gloo group.

`tests/test_spmd_mesh.py` ported (6 cases) on three `python -m
pilosa_tpu_torch server --device cpu --spmd --spmd-serve on --fusion on
--coalesce-window 20ms --replicas 1` children (`tools.cluster.
ProcCluster`), every node one rank of one gloo group:

- on (cold, then warm: mesh-cache hits and fused steps), off and http
  answer the full query mix identically, and equal to an in-process
  `pilosa_tpu` server (JAX on the CPU) fed the same writes;
- K distinct Counts coalesced into one batch run as ONE step on every
  rank (one `spmd_count_batch` dispatch a rank);
- a warm fused multi-call query is ONE step on every rank and moves ZERO
  result bytes over the HTTP data plane, its program ledgered in
  /debug/fusion under the mesh shape [3, 1];
- ?explain reports the mesh plan, and analyze grafts the one dispatch;
- the step-stream lifecycle counters agree (entered == exited, no stream
  error or resync);
- GET /debug/spmd/steps merges every node's ring: each step has all
  three peers, each peer's phases sum to its wall, no straggler at rest.

The port's own cases: warm Counts add mesh-cache hits and no misses on
every rank; a one-bit write invalidates only its owner's leaf and the
next Count reads the bit; and a card failure on one rank under serve on
(the `spmd.launch` fault point) is a 500 naming the node, through the
coordinator's coalesced batch and through a forwarded call, with no
fallback, after which the stream runner serves the next query.

Unlike the reference file this one is not marked slow: it runs in the
tier-1 suite (~20 s), each child with one OpenMP thread (trap 37).
PILOSA_TPU_PROC_TESTS=0 skips it.
"""

import http.client
import itertools
import json
import os
import shutil
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cluster.spmd import STEP_PHASES  # noqa: E402
from pilosa_tpu_torch.server.client import ClientError  # noqa: E402
from pilosa_tpu_torch.tools.cluster import ProcCluster, free_ports  # noqa: E402,E501

from tests.harness import ServerHarness  # noqa: E402

pytestmark = pytest.mark.skipif(
    os.environ.get("PILOSA_TPU_PROC_TESTS", "1") == "0",
    reason="process cluster tests disabled")

N = 3
#: seconds of warm rounds the merged-timeline test may run looking for a
#: round at rest (one with no straggler)
ROUNDS_DEADLINE = 90.0

#: the differential mix: every collective kind, BSI conditions, a time
#: range, and one non-collective call that stays on HTTP either way
QUERY_MIX = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(g=2)))",
    "Count(Difference(Row(f=1), Row(g=2)))",
    "Count(Xor(Row(f=1), Row(g=2)))",
    "Count(Row(v > 0))",
    "Count(Row(v >< [-10, 10]))",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "TopN(f, n=2)",
    "GroupBy(Rows(f), Rows(g))",
    "Count(Row(t=1, from=2019-01-01T00:00, to=2019-02-01T00:00))",
    "Row(f=1)",
]


@pytest.fixture(scope="module")
def cluster():
    c = ProcCluster(
        N, replica_n=1, device="cpu",
        extra_flags=["--spmd", "--spmd-port", str(free_ports(1)[0]),
                     "--spmd-cpu-collectives", "gloo",
                     "--spmd-serve", "on", "--fusion", "on",
                     "--coalesce-window", "20ms"],
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    c.coord = min(range(N), key=lambda i: c.hosts[i])
    ref = ServerHarness()
    try:
        c.wait_ready(timeout=120)
        coord = c.clients[c.coord]
        coord.create_index("m")
        ref.client.create_index("m")
        for name, opts in (("f", None), ("g", None), ("bf", None),
                           ("v", {"type": "int", "min": -1000,
                                  "max": 1000}),
                           ("t", {"type": "time", "timeQuantum": "YMD"})):
            coord.create_field("m", name, opts)
            ref.client.create_field("m", name, opts)
        time.sleep(1.0)  # DDL broadcast settles

        def both(method, *args, **kw):
            getattr(coord, method)("m", *args, **kw)
            getattr(ref.client, method)("m", *args, **kw)

        # 6 shards -> every rank owns some (jump hash)
        cols = [s * SHARD_WIDTH + off for s in range(6)
                for off in (0, 7, 99, 1000)]
        both("import_bits", "f", [1] * len(cols), cols)
        both("import_bits", "g", [2] * (len(cols) // 2), cols[::2])
        vals = [((i * 37) % 2001) - 1000 for i in range(len(cols))]
        both("import_values", "v", cols, vals)
        both("import_bits", "t", [1] * 6,
             [s * SHARD_WIDTH + 13 for s in range(6)],
             timestamps=["2019-01-02T03:04"] * 3
             + ["2020-06-07T08:09"] * 3)
        # bf rows 1..6 with distinct counts, for the K-batch
        for row in range(1, 7):
            both("import_bits", "bf", [row] * row,
                 [s * SHARD_WIDTH + 40 + row for s in range(row)])
        c.ref = ref
        c.expect = {"cols": cols, "vals": vals}
        yield c
    finally:
        codes = c.close()
        c.remove_dirs()
        ref.close()
        shutil.rmtree(ref.data_dir, ignore_errors=True)
    # every node leaves the group and stops cleanly on SIGTERM
    assert codes == [0] * N, codes


def _set_mode(cluster, mode):
    """The run-time serve-mode switch on EVERY node."""
    for cl in cluster.clients:
        assert cl._request("POST", "/debug/spmd", body=json.dumps(
            {"serve_mode": mode}).encode()) == {"serve_mode": mode}


def _debug(cluster, timeout=30.0):
    """Every node's /debug/spmd once the ranks have settled. Under serve
    on the coordinator answers when ITS part of a step is done, while a
    peer's stream runner may still be closing the same step (its
    counters, its ring record): every step runs on every rank, so the
    ranks are settled when each has exited as many steps as it entered,
    and all the same number."""
    deadline = time.monotonic() + timeout
    while True:
        d = [cl._request("GET", "/debug/spmd") for cl in cluster.clients]
        steps = [x["steps"] for x in d]
        if len({x["exited"] for x in steps}) == 1 \
                and all(x["entered"] == x["exited"] for x in steps):
            return d
        assert time.monotonic() < deadline, f"ranks never settled: {steps}"
        time.sleep(0.02)


def _stats(cluster):
    _debug(cluster)
    return [cl._request("GET", "/internal/spmd/stats")
            for cl in cluster.clients]


def _dispatches(cluster, family):
    _debug(cluster)
    out = []
    for cl in cluster.clients:
        phases = cl._request("GET", "/debug/dispatch")["phases"]
        out.append(phases.get(family, {}).get("lock_wait", {})
                   .get("count", 0))
    return out


def _burst(cluster, node, queries):
    """results[0] of each query sent to `node` at once: one connection a
    query, all connected first, then every request written back to back
    before any answer is read, so the burst reaches the server well
    inside its coalescing window (client threads would serialize on
    this process's GIL)."""
    host, port = cluster.hosts[node].rsplit(":", 1)
    conns = [http.client.HTTPConnection(host, int(port), timeout=120)
             for _ in queries]
    try:
        for c in conns:
            c.connect()
        for c, q in zip(conns, queries):
            c.request("POST", "/index/m/query", body=q.encode(),
                      headers={"Content-Type": "text/plain"})
        return [json.loads(c.getresponse().read())["results"][0]
                for c in conns]
    finally:
        for c in conns:
            c.close()


def _run_mix(client):
    return [client.query("m", q)["results"] for q in QUERY_MIX]


def test_on_matches_off_http_and_reference(cluster):
    """THE acceptance differential: serve on (cold, then warm: mesh-cache
    hits and fused steps), the serve-off step plane and the plain HTTP
    fan-out answer the whole mix identically, and equal to the TPU
    package's server; every rank's warm Counts are mesh-cache hits."""
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    on_cold = _run_mix(coord)
    mc0 = [d["mesh_cache"] for d in _debug(cluster)]
    on_warm = _run_mix(coord)
    mc1 = [d["mesh_cache"] for d in _debug(cluster)]
    _set_mode(cluster, "off")
    legacy = _run_mix(coord)
    _set_mode(cluster, "http")
    http = _run_mix(coord)
    _set_mode(cluster, "on")
    ref = _run_mix(cluster.ref.client)
    for q, a, b, c, d, e in zip(QUERY_MIX, on_cold, on_warm, legacy, http,
                                ref):
        assert a == b == c == d == e, (q, a, b, c, d, e)
    # against ground truth, not only cross-plane agreement
    cols, vals = cluster.expect["cols"], cluster.expect["vals"]
    assert on_cold[0] == [len(cols)]
    assert on_cold[5] == [sum(1 for v in vals if v > 0)]
    assert on_cold[7] == [{"value": sum(vals), "count": len(vals)}]
    # the warm pass gathered nothing on any rank: hits only
    for a, b in zip(mc0, mc1):
        assert b["hits"] > a["hits"], (a, b)
        assert b["misses"] == a["misses"], (a, b)
        assert b["entries"] > 0 and b["bytes"] > 0
        assert all(e["bytes"] > 0 for e in b["ledger"])


def test_batch_of_k_counts_is_one_collective_step(cluster):
    """K distinct Counts arriving inside one coalesce window run as ONE
    step on every rank: one announcement, one K1 launch (one
    spmd_count_batch dispatch) a rank, one all_reduce."""
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    coord.query("m", "Count(Row(bf=1))")  # prime the epoch
    k = 6
    want = {f"Count(Row(bf={r}))": r for r in range(1, k + 1)}
    for _ in range(10):  # windows are timing-dependent: retry
        before = _debug(cluster)
        disp0 = _dispatches(cluster, "spmd_count_batch")
        got = dict(zip(want, _burst(cluster, cluster.coord, list(want))))
        assert got == want  # right whether or not they coalesced
        after = _debug(cluster)
        d_batched = after[cluster.coord]["queries"]["batched"] \
            - before[cluster.coord]["queries"]["batched"]
        d_batches = after[cluster.coord]["steps"]["batch"] \
            - before[cluster.coord]["steps"]["batch"]
        if d_batched == k and d_batches == 1:
            d_steps = [a["steps"]["run"] - b["steps"]["run"]
                       for a, b in zip(after, before)]
            assert d_steps == [1] * N, (d_batched, d_steps)
            assert [a - b for a, b in zip(
                _dispatches(cluster, "spmd_count_batch"), disp0)] \
                == [1] * N
            assert [a["steps"]["batch"] - b["steps"]["batch"]
                    for a, b in zip(after, before)] == [1] * N
            break
    else:
        pytest.fail("no round coalesced all %d Counts into one batch" % k)


def test_warm_fused_query_one_step_zero_http_bytes(cluster):
    """A warm multi-call cluster query is ONE fused step on every rank
    and moves ZERO result bytes over the HTTP data plane."""
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    pql = ("Count(Row(f=1)) Count(Row(g=2)) "
           "Count(Intersect(Row(f=1), Row(g=2)))")
    cols = cluster.expect["cols"]
    want = [len(cols), len(cols[::2]), len(cols[::2])]
    assert cluster.ref.client.query("m", pql)["results"] == want
    # cold runs cross the fusion min-hits floor (2): the fused path
    # admits by the 3rd run
    for _ in range(3):
        assert coord.query("m", pql)["results"] == want
    before = _debug(cluster)
    assert coord.query("m", pql)["results"] == want
    after = _debug(cluster)
    for b, a in zip(before, after):
        assert a["steps"]["run"] - b["steps"]["run"] == 1, (b, a)
        assert a["http_data_plane_bytes"] == b["http_data_plane_bytes"]
        assert a["mesh_cache"]["misses"] == b["mesh_cache"]["misses"]
    co, cb = after[cluster.coord], before[cluster.coord]
    assert co["queries"]["fused"] - cb["queries"]["fused"] == 1
    assert co["steps"]["fused"] - cb["steps"]["fused"] == 1
    # the fused collective program is in the fusion ledger, mesh-tagged
    fusion = coord._request("GET", "/debug/fusion")
    mesh_programs = [p for p in fusion["programs"] if p.get("mesh")]
    assert mesh_programs and mesh_programs[0]["mesh"] == [N, 1]


def _find_spmd_nodes(node, out):
    if isinstance(node, dict):
        ann = node.get("annotations") or {}
        if ann.get("spmd"):
            out.append(node)
        # per-node fan-out children wrap their sub-plan in {"plan": ...}
        if isinstance(node.get("plan"), dict):
            _find_spmd_nodes(node["plan"], out)
        for child in node.get("children") or []:
            _find_spmd_nodes(child, out)
    return out


def test_explain_reports_mesh_plan(cluster):
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    # ?explain=true: annotated, nothing runs (no step advances)
    before = [s["steps"] for s in _stats(cluster)]
    resp = coord.query("m", "Count(Row(f=1))", explain="true")
    assert resp["results"] == []
    assert [s["steps"] for s in _stats(cluster)] == before
    nodes = _find_spmd_nodes({"children": resp["plan"]["calls"]}, [])
    assert nodes, resp["plan"]
    assert any(n.get("strategy") == "spmd-collective" for n in nodes)
    assert any(n["annotations"].get("dispatches") == 0 for n in nodes)
    assert any(n["annotations"].get("mesh") == [N, 1] for n in nodes)

    # ?explain=analyze: runs over the group and grafts the single
    # dispatch, the collective's bytes and the step's phases
    resp = coord.query("m", "Count(Row(f=1))", explain="analyze")
    assert resp["results"] == [len(cluster.expect["cols"])]
    nodes = _find_spmd_nodes({"children": resp["plan"]["calls"]}, [])
    analyzed = [n for n in nodes
                if n["annotations"].get("dispatches") == 1]
    assert analyzed, nodes
    assert analyzed[0]["annotations"]["psum_bytes"] >= 8
    assert set(analyzed[0]["annotations"]["phases_ms"]) <= set(STEP_PHASES)


def test_one_bit_write_invalidates_only_its_owner(cluster):
    """A Set into one shard bumps that fragment's generation: only its
    owner's mesh cache drops the leaf (one invalidation), the other
    ranks keep hitting, and the next Count reads the bit."""
    m = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    pql = "Count(Row(f=1))"
    want = m.query("m", pql)["results"][0]
    m.query("m", pql)  # warm on every rank
    before = [d["mesh_cache"] for d in _debug(cluster)]
    col = 3 * SHARD_WIDTH + 5
    owner = cluster.clients[cluster.coord]._request(
        "GET", "/internal/fragment/nodes?index=m&shard=3")
    owner_id = owner[0]["id"]
    m.query("m", f"Set({col}, f=1)")
    cluster.ref.client.query("m", f"Set({col}, f=1)")
    got = m.query("m", pql)["results"][0]
    assert got == want + 1 \
        == cluster.ref.client.query("m", pql)["results"][0]
    after = [d["mesh_cache"] for d in _debug(cluster)]
    inval = {cluster.hosts[i]: a["invalidations"] - b["invalidations"]
             for i, (a, b) in enumerate(zip(after, before))}
    assert inval == {h: int(h == owner_id) for h in cluster.hosts}, inval
    for i, (a, b) in enumerate(zip(after, before)):
        if cluster.hosts[i] != owner_id:
            assert a["misses"] == b["misses"] and a["hits"] > b["hits"]


def test_stream_lifecycle_counters_consistent(cluster):
    """After everything above: every announced step entered and exited
    on every process, the stream saw no error or resync, and the wedge
    classifier would read each node as healthy."""
    _set_mode(cluster, "on")
    for d in _debug(cluster):
        assert d["enabled"] and d["serve_mode"] == "on"
        assert d["mesh"] == [N, 1]
        s = d["steps"]
        assert s["entered"] == s["exited"] > 0, s
        assert d["stream"]["errors"] == 0
        assert d["stream"]["resyncs"] == 0
        assert d["observatory"]["occupancy"]["gap_onsets"] == 0
    coord = _debug(cluster)[cluster.coord]
    assert coord["steps"]["announced"] > 0
    assert coord["steps"]["last_seq"] > 0
    assert all(s["seq_mismatches"] == 0 and s["fallbacks"] == 0
               for s in _stats(cluster))
    # the /status roll-up carries every node's spmd summary
    obs = cluster.clients[cluster.coord]._request(
        "GET", "/status?observability=true")["observability"]
    assert {n: o["spmd"]["serve_mode"] for n, o in obs.items()} \
        == {h: "on" for h in cluster.hosts}


def test_merged_timeline_every_peer_phase_sums_no_stragglers(cluster):
    """GET /debug/spmd/steps returns a skew-corrected per-peer timeline
    in which every process reports each step, each peer's phases sum to
    its step wall (<= 5% residual), and a warm same-host group flags no
    straggler (the 25 ms noise floor swallows scheduler jitter). On a
    host loaded by other test workers a process can really be
    descheduled for tens of ms, a true straggler: a Sum step's plain K3
    work takes 58-77 ms a rank at rest, and under load one rank's
    device_enter ran 100-390 ms longer than the others', whose psum
    (the wait for it) was then flagged. So the test asks for one
    straggler-free round of warm steps, running rounds (at least three)
    until one is or ROUNDS_DEADLINE seconds have passed, every round
    checked for the rest. A false straggler that is systematic flags
    every round and still fails."""
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    warm = ("Count(Row(f=1))", "Sum(field=v)", "TopN(f, n=2)")
    for q in warm:
        coord.query("m", q)
    flagged = []
    deadline = time.monotonic() + ROUNDS_DEADLINE
    for round_no in itertools.count():
        if round_no >= 3 and time.monotonic() > deadline:
            break
        marker = _debug(cluster)[cluster.coord]["steps"]["last_seq"]
        for q in warm:
            coord.query("m", q)
        _debug(cluster)  # every rank's ring holds the steps
        tl = coord._request("GET", "/debug/spmd/steps?limit=64")
        assert tl["enabled"] is True
        assert len(tl["skew_seconds"]) == N  # one envelope theta a node
        fresh = [s for s in tl["steps"] if s["seq"] > marker]
        assert len(fresh) >= len(warm), tl["steps"]
        for s in fresh:
            assert len(s["peers"]) == N, s
            for peer in s["peers"].values():
                wall = peer["wall_seconds"]
                assert set(peer["phases"]) <= set(STEP_PHASES)
                residual = abs(sum(peer["phases"].values()) - wall)
                assert residual <= 0.05 * wall + 1e-5, (residual, peer)
            starts = [p["start"] for p in s["peers"].values()]
            assert max(starts) - min(starts) < 1.0, s
        flagged = [s for s in fresh if s["stragglers"]]
        if not flagged:
            break
    assert flagged == [], flagged

    # the single-seq endpoint returns exactly that step, every peer
    seq = fresh[-1]["seq"]
    one = coord._request("GET", "/debug/spmd/steps/%d" % seq)
    assert [x["seq"] for x in one["steps"]] == [seq]
    assert len(one["steps"][0]["peers"]) == N


def test_device_failure_under_on_is_a_500(cluster):
    """Traps 30 and 35 under serve on: a rank whose card fails at the
    step's launch still enters the collective with its failure slot
    set, so the query fails with a 500 naming that node — through the
    coordinator's coalesced batch step and through a call forwarded to
    it — with no HTTP fallback; the armed peer's stream runner counts
    the failed step and serves the next one."""
    coord = cluster.clients[cluster.coord]
    _set_mode(cluster, "on")
    pql = "Count(Row(f=1))"
    want = coord.query("m", pql)["results"][0]
    peer = (cluster.coord + 1) % N
    for armed, via in ((peer, cluster.coord), (cluster.coord, peer)):
        cluster.clients[armed]._request(
            "POST", "/debug/faultpoints", b'{"arm": "spmd.launch=raise"}')
        s0, d0 = _stats(cluster), _debug(cluster)
        with pytest.raises(ClientError) as e:
            cluster.clients[via].query("m", pql)
        assert e.value.status == 500
        assert cluster.hosts[armed] in str(e.value), str(e.value)
        assert "CUDA error" in str(e.value)
        s1 = _stats(cluster)
        # the step ran on every rank (nobody was left in it) ...
        assert [b["steps"] - a["steps"] for a, b in zip(s0, s1)] == [1] * N
        # ... and nothing was served over HTTP behind the card
        assert [b["fallbacks"] for b in s1] == [a["fallbacks"] for a in s0]
        # every peer's runner saw the failed step (it counts it just
        # after the step exits) and lives on
        want_errors = [a["stream"]["errors"] + int(i != cluster.coord)
                       for i, a in enumerate(d0)]
        deadline = time.monotonic() + 30
        while [d["stream"]["errors"] for d in _debug(cluster)] \
                != want_errors and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [d["stream"]["errors"] for d in _debug(cluster)] \
            == want_errors
        # the next query: the collective again, equal to the reference
        assert cluster.clients[via].query("m", pql)["results"][0] == want
        assert [s["steps"] for s in _stats(cluster)] \
            == [s["steps"] + 2 for s in s0]
