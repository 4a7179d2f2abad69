"""The validate-to-step wedge window of the port's collective plane
(pilosa_tpu_torch/cluster/spmd.py `maybe_execute`'s fallback).

`tests/test_spmd_wedge.py` ported (3 cases) on the port's in-process
`tools.cluster.ClusterHarness`, with the TPU package's scheme: a peer
that validated (or whose count epoch is already validated) dies before
its step; on the coordinator that shows as the step raising out of the
collective. The plane must (a) fall back to the HTTP merge, so the query
still answers right, (b) invalidate the validation epoch, and (c) let
the NEXT query re-validate and ride the collective again.

As in the reference, the peers only ack their steps (`run_step` is
stubbed), and the coordinator's plane is a group of one: no process
group is formed in this process, so its engine reduces nothing and the
coordinator's step counts its own shards. The data therefore lives on
shards the coordinator owns. Every answer is also held to an in-process
`pilosa_tpu` server (tests/harness.ServerHarness) fed the same writes.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402

from tests.harness import ServerHarness  # noqa: E402


def _attach(c, plane_cls, api_cls, client_cls, **api_kw):
    for h in c.nodes:
        spmd = plane_cls(h.holder, h.cluster, client_cls)
        h.api.close()
        h.api = api_cls(h.holder, cluster=h.cluster,
                        client_factory=client_cls, spmd=spmd, **api_kw)
        h.server.api = h.api
        h.spmd = spmd
    c.coord = c.node_by_id(min(h.cluster.local_id for h in c.nodes))
    for h in c.nodes:
        if h is not c.coord:
            # the peers ack their steps without running them: the
            # coordinator's group of one computes the answer alone
            h.spmd.run_step = lambda step: {"ok": True}


@pytest.fixture()
def spmd_cluster():
    from pilosa_tpu_torch.cluster.spmd import SpmdDataPlane
    from pilosa_tpu_torch.server import API, Client
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    c = ClusterHarness(3, device="cpu")
    try:
        _attach(c, SpmdDataPlane, API, Client, device="cpu")
        yield c
    finally:
        c.close()


@pytest.fixture()
def reference():
    """The TPU package's single node, for the answers."""
    ref = ServerHarness()
    try:
        yield ref
    finally:
        ref.close()


def _coord_shards(cluster, want=2, probe=40):
    """The first `want` shards the coordinator owns: a group of one
    counts only the executing node's blocks."""
    out = []
    for s in range(probe):
        if cluster.owner_of("wz", s) is cluster.coord:
            out.append(s)
            if len(out) == want:
                return out
    raise RuntimeError("the coordinator owns too few probed shards")


def _load(c, ref, fields, rows_cols):
    c.coord.client.create_index("wz")
    ref.client.create_index("wz")
    for f in fields:
        c.coord.client.create_field("wz", f)
        ref.client.create_field("wz", f)
    for f, (rows, cols) in rows_cols.items():
        c.coord.client.import_bits("wz", f, rows, cols)
        ref.client.import_bits("wz", f, rows, cols)


def _ask(c, ref, pql):
    got = c.coord.client.query("wz", pql)["results"][0]
    assert got == ref.client.query("wz", pql)["results"][0], pql
    return got


def test_wedge_window_watchdog_falls_back_and_recovers(spmd_cluster,
                                                       reference):
    c = spmd_cluster
    shards = _coord_shards(c)
    cols = [s * SHARD_WIDTH + off for s in shards for off in (0, 7, 99)]
    _load(c, reference, ["f"], {"f": ([1] * len(cols), cols)})

    spmd = c.coord.spmd
    # prime: the validation round runs and the step rides the collective
    assert _ask(c, reference, "Count(Row(f=1))") == len(cols)
    assert spmd.steps_run >= 1
    assert spmd.validations >= 1
    steps0, vals0, falls0 = (spmd.steps_run, spmd.validations,
                             spmd.fallbacks)

    # the wedge: the peer validated (the epoch is primed), then died
    # before its step; on the coordinator the collective raises
    real_run = spmd._run_step_locked

    def dead_peer_collective(step):
        raise RuntimeError(
            "simulated: peer exited between validate and step "
            "(collective rendezvous timeout)")

    spmd._run_step_locked = dead_peer_collective
    try:
        got = _ask(c, reference, "Count(Row(f=1))")
    finally:
        spmd._run_step_locked = real_run
    # the right answer over the HTTP merge, one fallback, no step
    # completed, the epoch invalidated for a re-probe
    assert got == len(cols)
    assert spmd.fallbacks == falls0 + 1
    assert spmd.steps_run == steps0
    assert spmd._count_epochs.get("wz") is None

    # recovery: the next query re-validates (a fresh epoch, not a stale
    # skip) and rides the collective
    assert _ask(c, reference, "Count(Row(f=1))") == len(cols)
    assert spmd.steps_run == steps0 + 1
    assert spmd.validations == vals0 + 1


def test_wedge_window_groupby_falls_back(spmd_cluster, reference):
    """The same contract on the GroupBy step: the collective failure
    must not fail the query OR leave a stale epoch."""
    c = spmd_cluster
    shards = _coord_shards(c)
    cols = [s * SHARD_WIDTH + off for s in shards for off in range(8)]
    _load(c, reference, ["a", "b"], {
        "a": ([i % 2 for i in range(len(cols))], cols),
        "b": ([i % 3 for i in range(len(cols))], cols)})

    def groups(res):
        return {tuple(fr["rowID"] for fr in g["group"]): g["count"]
                for g in res}

    want = groups(_ask(c, reference, "GroupBy(Rows(a), Rows(b))"))
    assert want  # a non-empty cross product

    spmd = c.coord.spmd
    falls0 = spmd.fallbacks
    real_run = spmd._run_step_locked
    spmd._run_step_locked = lambda step: (_ for _ in ()).throw(
        RuntimeError("simulated dead peer"))
    try:
        got = groups(_ask(c, reference, "GroupBy(Rows(a), Rows(b))"))
    finally:
        spmd._run_step_locked = real_run
    assert got == want
    assert spmd.fallbacks == falls0 + 1
    assert spmd._count_epochs.get("wz") is None


def test_groupby_previous_pagination_rides_collective(spmd_cluster,
                                                      reference):
    """The GroupBy step honors the `previous` list cursor as the local
    path does: the cursor is validated and the outer row start seeded
    BEFORE the collective round, the pages concatenate to the one-shot
    result, and every page rides the collective (no fallback)."""
    c = spmd_cluster
    shards = _coord_shards(c)
    cols = [s * SHARD_WIDTH + off for s in shards for off in range(12)]
    _load(c, reference, ["a", "b"], {
        "a": ([i % 3 for i in range(len(cols))], cols),
        "b": ([i % 4 for i in range(len(cols))], cols)})

    full = _ask(c, reference, "GroupBy(Rows(a), Rows(b))")
    assert len(full) == 12

    spmd = c.coord.spmd
    steps0, falls0 = spmd.steps_run, spmd.fallbacks
    pages, prev = [], None
    n_pages = 0
    for _ in range(len(full) + 2):  # bounded: must terminate
        pql = "GroupBy(Rows(a), Rows(b), limit=5{})".format(
            "" if prev is None else f", previous=[{prev[0]}, {prev[1]}]")
        page = _ask(c, reference, pql)
        if not page:
            break
        n_pages += 1
        pages.extend(page)
        prev = (page[-1]["group"][0]["rowID"],
                page[-1]["group"][1]["rowID"])
    assert pages == full
    assert spmd.fallbacks == falls0
    assert spmd.steps_run - steps0 >= n_pages  # each page: the collective
