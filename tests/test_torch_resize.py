"""The port's cluster resize (pilosa_tpu_torch/cluster/resize.py and the
API's resize write queue) against the TPU package's, on the CPU.

Every case of tests/test_resize.py runs on one in-process resizable
cluster of each package (2 active nodes and a standby that joins through
the coordinator's resize; JAX on the CPU beside torch on the CPU): the
same DDL, imports, resize calls, aborts and injected failures go to
both, and what each observes (counts from every node, topology sizes,
states, job states, the shards each node holds against placement, the
errors raised) must be equal.

One case is the port's own: after `clean_holder` drops a fragment of a
shard this node no longer owns, the evaluator's cached device stacks do
not serve it (the view's mutation stamp moves, the next read rebuilds).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.cluster as jax_cluster  # noqa: E402
import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.server as jax_server  # noqa: E402
import pilosa_tpu_torch.cluster as torch_cluster  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.server as torch_server  # noqa: E402
import pilosa_tpu_torch.server.api as torch_api  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.tools.cluster import NodeHarness  # noqa: E402

from tests.harness import ServerHarness  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(
        name="jax", cluster=jax_cluster, Holder=jax_core.Holder,
        API=jax_server.API, Client=jax_server.Client,
        ApiError=jax_server.ApiError,
        NotFoundError=jax_server.api.NotFoundError,
        harness=ServerHarness, api_kwargs={}),
    "port": SimpleNamespace(
        name="port", cluster=torch_cluster, Holder=torch_core.Holder,
        API=torch_api.API, Client=torch_server.Client,
        ApiError=torch_api.ApiError, NotFoundError=torch_api.NotFoundError,
        harness=NodeHarness, api_kwargs={"device": "cpu"}),
}


def wait_until(fn, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_node(pkg, harness):
    return pkg.cluster.Node(id=harness.address.split("//", 1)[1],
                            uri=harness.address)


def attach_cluster(pkg, harness, node_list, replica_n=1):
    local_id = harness.address.split("//", 1)[1]
    cluster = pkg.cluster.Cluster(
        nodes=[pkg.cluster.Node(n.id, n.uri, is_coordinator=n.is_coordinator)
               for n in node_list],
        local_id=local_id, replica_n=replica_n, path=harness.data_dir)
    harness.api = pkg.API(harness.holder, cluster=cluster,
                          client_factory=pkg.Client, **pkg.api_kwargs)
    harness.server.api = harness.api
    harness.cluster = cluster


class ResizableCluster:
    """2 active nodes + 1 standby that will join via resize."""

    def __init__(self, pkg, replica_n=1):
        self.pkg = pkg
        self.all = [pkg.harness() for _ in range(3)]
        nodes = [make_node(pkg, h) for h in self.all]
        nodes[0].is_coordinator = True
        # nodes 0,1 know a 2-node cluster; node 2 bootstraps knowing all 3
        for h in self.all[:2]:
            attach_cluster(pkg, h, nodes[:2], replica_n)
        attach_cluster(pkg, self.all[2], nodes, replica_n)

    def close(self):
        for h in self.all:
            h.close()


@pytest.fixture
def rclusters():
    made = []
    try:
        for name in ("jax", "port"):
            made.append(ResizableCluster(PKGS[name]))
        yield made
    finally:
        for c in made:
            c.close()


def run_both(rclusters, scenario):
    """scenario(pkg, cluster) on both packages; their observations must
    be equal. Returns the port's."""
    out = [scenario(c.pkg, c) for c in rclusters]
    assert out[1] == out[0], (out[1], out[0])
    return out[1]


def _local_fragment_shards(harness, index, field):
    idx = harness.holder.index(index)
    if idx is None:
        return set()
    view = idx.field(field).view()
    return set(view.fragments) if view else set()


def _count(h, index, pql):
    return h.client.query(index, pql)["results"][0]


def test_add_node_streams_fragments(rclusters):
    rng = np.random.default_rng(11)
    cols = rng.integers(0, 6 * SHARD_WIDTH, 500, dtype=np.uint64)
    rows = rng.integers(0, 4, 500, dtype=np.uint64)
    want_truth = len({int(c) for c, r in zip(cols, rows) if r == 1})

    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("ri")
        a.api.create_field("ri", "f")
        a.api.import_bits("ri", "f", rows, cols)
        before = _count(a, "ri", "Count(Row(f=1))")
        assert before == want_truth, (before, want_truth)
        a.client.resize_add_node(make_node(pkg, new).id, new.address)
        assert wait_until(
            lambda: a.client.resize_status()["job"] is not None
            and a.client.resize_status()["job"]["state"] == "DONE")
        for h in c.all:
            assert len(h.cluster.nodes) == 3
            assert h.cluster.state == "NORMAL"
        counts = [_count(h, "ri", "Count(Row(f=1))") for h in c.all]
        owned_by_new = {s for s in range(6) if new.cluster.owns_shard(
            new.cluster.local_id, "ri", s)}
        assert owned_by_new
        assert owned_by_new <= _local_fragment_shards(new, "ri", "f")
        for h in (a, b):
            for s in _local_fragment_shards(h, "ri", "f"):
                assert h.cluster.owns_shard(h.cluster.local_id, "ri", s)
        held = sorted(s for h in c.all
                      for s in _local_fragment_shards(h, "ri", "f"))
        return before, counts, held

    before, counts, held = run_both(rclusters, scenario)
    assert counts == [before] * 3
    assert sorted(set(held)) == list(range(6))


def test_remove_node_redistributes(rclusters):
    cols = np.arange(0, 4 * SHARD_WIDTH, 997, dtype=np.uint64)

    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("rr")
        a.api.create_field("rr", "f")
        a.api.import_bits("rr", "f", np.zeros(len(cols), np.uint64), cols)
        want = _count(a, "rr", "Count(Row(f=0))")
        a.client.resize_add_node(make_node(pkg, new).id, new.address)
        assert wait_until(
            lambda: a.client.resize_status()["job"]["state"] == "DONE")
        grown = _count(new, "rr", "Count(Row(f=0))")
        b_id = b.cluster.local_id
        a.client.resize_remove_node(b_id)
        assert wait_until(
            lambda: a.client.resize_status()["job"]["state"] == "DONE")
        assert all(n.id != b_id for n in a.cluster.nodes)
        return (want, grown, len(a.cluster.nodes),
                [_count(h, "rr", "Count(Row(f=0))") for h in (a, new)])

    want, grown, n_nodes, after = run_both(rclusters, scenario)
    assert want == len(cols) and grown == want
    assert n_nodes == 2 and after == [want, want]


def test_queries_blocked_while_resizing(rclusters):
    def scenario(pkg, c):
        a = c.all[0]
        a.api.create_index("rb")
        a.api.create_field("rb", "f")
        a.api.import_bits("rb", "f", [0], [1])
        a.cluster.state = "RESIZING"
        try:
            with pytest.raises(pkg.ApiError, match="resizing") as err:
                a.api.query("rb", "Count(Row(f=0))")
        finally:
            a.cluster.state = "NORMAL"
        return str(err.value), _count(a, "rb", "Count(Row(f=0))")

    assert run_both(rclusters, scenario)[1] == 1


def test_unreachable_node_aborts_cleanly(rclusters):
    def scenario(pkg, c):
        a = c.all[0]
        a.api.create_index("ra")
        a.api.create_field("ra", "f")
        a.api.import_bits("ra", "f", [0], [1])
        with pytest.raises(pkg.cluster.ResizeError):
            a.api.resize.add_node(
                pkg.cluster.Node(id="ghost", uri="http://127.0.0.1:1"))
        return (len(a.cluster.nodes), a.cluster.state,
                _count(a, "ra", "Count(Row(f=0))"))

    assert run_both(rclusters, scenario) == (2, "NORMAL", 1)


def test_abort_restores_topology(rclusters):
    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("ra2")
        a.api.create_field("ra2", "f")
        a.api.import_bits("ra2", "f", [0], [1])
        # a "ghost" node whose URI is b's server: instructions deliver,
        # but b reports completion under its own id, so the job never
        # completes and can be aborted
        job = a.api.resize.add_node(
            pkg.cluster.Node(id="zzz-ghost", uri=b.address))
        states = [job.state, a.cluster.state]
        aborted = a.client.resize_abort()
        return (states, aborted["state"], len(a.cluster.nodes),
                a.cluster.state, _count(a, "ra2", "Count(Row(f=0))"))

    assert run_both(rclusters, scenario) == (
        ["RUNNING", "RESIZING"], "ABORTED", 2, "NORMAL", 1)


def test_failed_instruction_reverts_topology(rclusters):
    """A follower reporting an error fails the job and restores the old
    topology instead of leaving the cluster RESIZING forever."""
    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("rf")
        a.api.create_field("rf", "f")
        a.api.import_bits("rf", "f", [0], [1])
        job = a.api.resize.add_node(
            pkg.cluster.Node(id="zzz-ghost", uri=b.address))
        first = job.state
        a.api.resize.mark_complete(job.id, "zzz-ghost", error="stream failed")
        return (first, job.state, len(a.cluster.nodes), a.cluster.state,
                _count(a, "rf", "Count(Row(f=0))"))

    assert run_both(rclusters, scenario) == (
        "RUNNING", "FAILED", 2, "NORMAL", 1)


def test_remove_coordinator_forbidden(rclusters):
    def scenario(pkg, c):
        a = c.all[0]
        with pytest.raises(pkg.cluster.ResizeError,
                           match="coordinator") as err:
            a.api.resize.remove_node(a.cluster.local_id)
        # the port's API surface answers the same over HTTP
        with pytest.raises(Exception) as http_err:
            a.client.resize_remove_node(a.cluster.local_id)
        return str(err.value), getattr(http_err.value, "status", None)

    assert run_both(rclusters, scenario)[1] == 400


def test_clean_holder_unit(tmp_path):
    removed = {}
    for name in ("jax", "port"):
        pkg = PKGS[name]
        holder = pkg.Holder(str(tmp_path / name),
                            use_snapshot_queue=False).open()
        try:
            f = holder.create_index("ch").create_field("f")
            f.set_bit(0, 1)
            f.set_bit(0, SHARD_WIDTH + 1)
            f.set_bit(3, 5 * SHARD_WIDTH + 1)
            # a cluster where this node owns nothing
            cluster = pkg.cluster.Cluster(
                nodes=[pkg.cluster.Node("other", "http://x")],
                local_id="me", replica_n=1)
            removed[name] = pkg.cluster.clean_holder(holder, cluster)
            view = holder.index("ch").field("f").view()
            assert not (set(view.fragments) if view else set())
            frag_dir = tmp_path / name / "ch" / "f" / "views" / "standard" \
                / "fragments"
            assert not frag_dir.exists() or not any(
                p.name.isdigit() for p in frag_dir.iterdir())
        finally:
            holder.close()
    assert removed["port"] == removed["jax"] >= 3


def test_clean_holder_invalidates_cached_stacks(tmp_path):
    """The port's own: a Count that cached its device stacks over eight
    shards answers over the ones left after clean_holder drops those this
    node no longer owns (the view's mutation stamp moved, so the stack is
    rebuilt, not served)."""
    from pilosa_tpu_torch.exec import Executor

    holder = torch_core.Holder(str(tmp_path), use_snapshot_queue=False).open()
    try:
        f = holder.create_index("i").create_field("f")
        g = holder.index("i").create_field("g")
        for shard in range(8):
            for col in (1, 2):
                f.set_bit(1, shard * SHARD_WIDTH + col)
                g.set_bit(1, shard * SHARD_WIDTH + col)
        ex = Executor(holder, device="cpu")
        pql = "Count(Intersect(Row(f=1), Row(g=1)))"
        assert ex.execute("i", pql) == [16]
        assert ex.execute("i", pql) == [16]  # served from the cached stacks
        nodes = [torch_cluster.Node("me", "http://a"),
                 torch_cluster.Node("other", "http://b")]
        cluster = torch_cluster.Cluster(nodes=nodes, local_id="me",
                                        replica_n=1)
        keep = [s for s in range(8) if cluster.owns_shard("me", "i", s)]
        assert 0 < len(keep) < 8, keep
        torch_cluster.clean_holder(holder, cluster)
        assert ex.execute("i", pql) == [2 * len(keep)]
        assert ex.execute("i", pql, shards=list(range(8))) == [2 * len(keep)]
    finally:
        holder.close()


# -------------------------------------------------- writes during resize

def _slow_stream(mgr, release):
    """Make `mgr`'s fragment streaming block until `release` is set, so
    tests get a deterministic RESIZING window."""
    orig = mgr._retrieve_shard

    def slowed(src):
        release.wait(timeout=30)
        return orig(src)

    mgr._retrieve_shard = slowed


def test_import_during_resize_lands_after_completion(rclusters):
    base_cols = list(range(0, 6 * SHARD_WIDTH, 100_003))
    extra_cols = [c0 + 1 for c0 in base_cols]
    want = len(base_cols) + len(extra_cols)

    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("wr")
        a.api.create_field("wr", "f")
        a.api.import_bits("wr", "f", [0] * len(base_cols), base_cols)
        release = threading.Event()
        _slow_stream(new.api.resize, release)
        a.client.resize_add_node(make_node(pkg, new).id, new.address)
        state = a.cluster.state
        queued = a.api.import_bits("wr", "f", [0] * len(extra_cols),
                                   extra_cols)
        release.set()
        assert wait_until(
            lambda: a.client.resize_status()["job"]["state"] == "DONE")
        assert wait_until(
            lambda: _count(a, "wr", "Count(Row(f=0))") == want), \
            "queued import lost after resize completion"
        return state, queued, [_count(h, "wr", "Count(Row(f=0))")
                               for h in c.all]

    assert run_both(rclusters, scenario) == ("RESIZING", 0, [want] * 3)


def test_import_during_resize_lands_after_abort(rclusters):
    base_cols = list(range(0, 4 * SHARD_WIDTH, 99_991))
    extra_cols = [c0 + 2 for c0 in base_cols]
    want = len(base_cols) + len(extra_cols)

    def scenario(pkg, c):
        a, b, new = c.all
        a.api.create_index("wa")
        a.api.create_field("wa", "f")
        a.api.import_bits("wa", "f", [0] * len(base_cols), base_cols)
        release = threading.Event()
        _slow_stream(new.api.resize, release)
        a.client.resize_add_node(make_node(pkg, new).id, new.address)
        state = a.cluster.state
        queued = a.api.import_bits("wa", "f", [0] * len(extra_cols),
                                   extra_cols)
        a.api.resize.abort()
        release.set()
        after = (a.cluster.state, len(a.cluster.nodes))
        assert wait_until(
            lambda: _count(a, "wa", "Count(Row(f=0))") == want), \
            "queued import lost after resize abort"
        return state, queued, after, _count(a, "wa", "Count(Row(f=0))")

    assert run_both(rclusters, scenario) == (
        "RESIZING", 0, ("NORMAL", 2), want)


def test_resize_write_queue_backpressure(rclusters):
    def scenario(pkg, c):
        a = c.all[0]
        a.api.create_index("wq")
        a.api.create_field("wq", "f")
        a.api.RESIZE_QUEUE_MAX = 2  # instance override
        a.cluster.state = "RESIZING"
        try:
            queued = [a.api.import_bits("wq", "f", [0], [1]),
                      a.api.import_bits("wq", "f", [0], [2])]
            with pytest.raises(pkg.ApiError, match="queue full") as err:
                a.api.import_bits("wq", "f", [0], [3])
        finally:
            a.cluster.state = "NORMAL"
            a.api._drain_resize_writes()
        assert wait_until(lambda: _count(a, "wq", "Count(Row(f=0))") == 2)
        return (queued, err.value.status,
                (err.value.headers or {}).get("X-Pilosa-Shed"))

    assert run_both(rclusters, scenario) == ([0, 0], 503, "resize_queue")


def test_remote_import_slices_rejected_while_resizing(rclusters):
    """Internal fan-out hops (remote=True) are NOT queued: they get the
    reference's RESIZING rejection."""
    def scenario(pkg, c):
        a = c.all[0]
        a.api.create_index("wrr")
        a.api.create_field("wrr", "f")
        a.cluster.state = "RESIZING"
        try:
            with pytest.raises(pkg.ApiError, match="resizing") as err:
                a.api.import_bits("wrr", "f", [0], [1], remote=True)
        finally:
            a.cluster.state = "NORMAL"
        return str(err.value), _count(a, "wrr", "Count(Row(f=0))")

    assert run_both(rclusters, scenario)[1] == 0


def test_doomed_import_404s_even_while_resizing(rclusters):
    """Validation precedes queueing: an import that can never succeed
    fails NOW, not at replay."""
    def scenario(pkg, c):
        a = c.all[0]
        a.api.create_index("wv")
        a.cluster.state = "RESIZING"
        try:
            with pytest.raises(pkg.NotFoundError) as e1:
                a.api.import_bits("wv", "no_such_field", [0], [1])
            with pytest.raises(pkg.NotFoundError) as e2:
                a.api.import_values("no_such_index", "f", [1], [5])
        finally:
            a.cluster.state = "NORMAL"
        return str(e1.value), str(e2.value)

    run_both(rclusters, scenario)
