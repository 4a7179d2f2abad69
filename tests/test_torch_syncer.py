"""The port's anti-entropy (pilosa_tpu_torch/server/syncer.py) against the
TPU package's, on the CPU.

Every case of tests/test_syncer.py runs on both packages:

- `merge_block` over the same fragments and replica sets: the deltas it
  returns, the bits it leaves and the fragment's serialized storage must
  equal the TPU package's bit for bit;
- the cluster cases diverge the replicas of one in-process 3-node,
  replicas-2 cluster of each package the same way (writes applied on one
  replica only), run `HolderSyncer` on both, and compare what every
  replica holds afterwards, the sync counts and the serialized fragments
  of every owner.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.cluster as jax_cluster  # noqa: E402
import pilosa_tpu.server.client as jax_client  # noqa: E402
import pilosa_tpu.server.syncer as jax_syncer  # noqa: E402
import pilosa_tpu_torch.cluster as torch_cluster  # noqa: E402
import pilosa_tpu_torch.server.client as torch_client  # noqa: E402
import pilosa_tpu_torch.server.syncer as torch_syncer  # noqa: E402
from pilosa_tpu.core.fragment import Fragment as JaxFragment  # noqa: E402
from pilosa_tpu.core.fragment import HASH_BLOCK_SIZE  # noqa: E402
from pilosa_tpu.roaring import serialize as jax_serialize  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment  # noqa: E402
from pilosa_tpu_torch.roaring import serialize  # noqa: E402

from tests.test_torch_cluster import Dual  # noqa: E402

SIDES = (("jax", JaxFragment, jax_syncer, jax_serialize),
         ("port", Fragment, torch_syncer, serialize))


# ---------------------------------------------------------------- merge_block

def _merge_both(tmp_path, bits, pair_sets, block=0):
    """merge_block on a fragment of each package holding `bits`; returns
    the port's (deltas, fragment) after checking them against the TPU
    package's."""
    out = {}
    for name, frag_cls, syncer, ser in SIDES:
        frag = frag_cls(str(tmp_path / name), "i", "f", "standard", 0).open()
        for row, col in bits:
            frag.set_bit(row, col)
        deltas = syncer.merge_block(frag, block, pair_sets)
        out[name] = ([(list(map(int, s)), list(map(int, c)))
                      for s, c in deltas],
                     ser(frag.storage), frag)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    out["jax"][2].close()
    return out["port"][0], out["port"][2]


def test_merge_block_union_two_replicas(tmp_path):
    # RF=2: majority = (2+1)//2 = 1 -> union semantics (ties count as set)
    deltas, frag = _merge_both(tmp_path, [(0, 1), (0, 2)],
                               [([0, 0], [2, 5])])
    try:
        assert frag.contains(0, 5) and frag.contains(0, 1)
        assert deltas == [([1], [])]
    finally:
        frag.close()


def test_merge_block_majority_three_replicas(tmp_path):
    # RF=3: majority = 2. A bit on only one replica is cleared.
    deltas, frag = _merge_both(tmp_path, [(0, 1), (0, 9)],
                               [([0, 0], [1, 2]), ([0], [2])])
    try:
        assert frag.contains(0, 1) and frag.contains(0, 2)
        assert not frag.contains(0, 9)
        assert deltas == [([], []), ([1], [])]
    finally:
        frag.close()


def test_merge_block_respects_block_range(tmp_path):
    # bits outside block 0 (row >= HASH_BLOCK_SIZE) are not touched
    deltas, frag = _merge_both(tmp_path, [(HASH_BLOCK_SIZE, 3), (0, 1)],
                               [([], [])])
    try:
        assert frag.contains(HASH_BLOCK_SIZE, 3)
        assert deltas == [([1], [])]
    finally:
        frag.close()
    # and a random three-replica block of the second hash block
    rng = np.random.default_rng(7)
    rows = rng.integers(HASH_BLOCK_SIZE, 2 * HASH_BLOCK_SIZE, 300)
    cols = rng.integers(0, SHARD_WIDTH, 300)
    local = list(zip(rows[:150].tolist(), cols[:150].tolist()))
    remotes = [(rows[50:200].tolist(), cols[50:200].tolist()),
               (rows[100:].tolist(), cols[100:].tolist())]
    sub = tmp_path / "random"
    sub.mkdir()
    _, frag = _merge_both(sub, local, remotes, block=1)
    frag.close()


# ------------------------------------------------------------- cluster sync

@pytest.fixture(scope="module")
def cluster3():
    d = Dual(3, replica_n=2)
    yield d
    d.close()


def _local_columns(harness, index, field, row, shard=0):
    """Row columns one node holds locally (no fan-out)."""
    view = harness.holder.index(index).field(field).view()
    frag = view.fragment(shard) if view else None
    if frag is None:
        return []
    return sorted(int(c) for c in frag.row_columns(row))


def _both(cluster3, fn):
    """fn(cluster, syncer module, Client, cluster module, serialize) on
    each package; the answers must be equal."""
    return cluster3.both(lambda c: fn(c, *(
        (jax_syncer, jax_client.Client, jax_cluster, jax_serialize)
        if c is cluster3.jax else
        (torch_syncer, torch_client.Client, torch_cluster, serialize))))


def test_sync_repairs_missing_replica(cluster3):
    def run(c, syncer, client, cluster_mod, ser):
        c[0].api.create_index("aesync")
        c[0].api.create_field("aesync", "f")
        owners = c[0].cluster.shard_nodes("aesync", 0)
        assert len(owners) == 2
        a, b = c.node_by_id(owners[0].id), c.node_by_id(owners[1].id)
        # diverge: write to replica A only (remote=True applies locally)
        a.api.import_bits("aesync", "f", [7, 7, 8], [1, 2, 3], remote=True)
        before = _local_columns(b, "aesync", "f", 7)
        synced = syncer.HolderSyncer(a.holder, a.cluster,
                                     client).sync_holder()
        frag_b = b.holder.index("aesync").field("f").view().fragment(0)
        return (before, synced, _local_columns(b, "aesync", "f", 7),
                _local_columns(b, "aesync", "f", 8), ser(frag_b.storage))

    before, synced, seven, eight, _ = _both(cluster3, run)
    assert before == [] and synced >= 1
    assert seven == [1, 2] and eight == [3]


def test_sync_is_idempotent(cluster3):
    def run(c, syncer, client, cluster_mod, ser):
        owners = c[0].cluster.shard_nodes("aesync", 0)
        a = c.node_by_id(owners[0].id)
        s = syncer.HolderSyncer(a.holder, a.cluster, client)
        s.sync_holder()
        return s.sync_holder()

    assert _both(cluster3, run) == 0  # converged: no differing blocks


def test_sync_attrs(cluster3):
    def run(c, syncer, client, cluster_mod, ser):
        c[0].api.create_index("aeattr")
        c[0].api.create_field("aeattr", "g")
        idx0 = c[0].holder.index("aeattr")
        idx0.column_attr_store.set_attrs(42, {"city": "sf"})
        idx0.field("g").row_attr_store.set_attrs(7, {"label": "seven"})
        # sync FROM a peer: it pulls node 0's differing attr blocks
        syncer.HolderSyncer(c[1].holder, c[1].cluster, client).sync_holder()
        idx1 = c[1].holder.index("aeattr")
        return (idx1.column_attr_store.attrs(42),
                idx1.field("g").row_attr_store.attrs(7))

    assert _both(cluster3, run) == ({"city": "sf"}, {"label": "seven"})


def test_unreachable_peer_does_not_clear_local_bits(cluster3):
    """A fetch failure aborts the sync, it does not vote as an empty
    replica (otherwise RF>=3 majority would clear live local bits)."""
    def run(c, syncer, client, cluster_mod, ser):
        c[0].api.create_index("aedown")
        c[0].api.create_field("aedown", "f")
        dead = cluster_mod.Cluster(nodes=[
            cluster_mod.Node(id=c[0].cluster.local_id, uri=c[0].address),
            cluster_mod.Node(id="dead1", uri="http://127.0.0.1:1"),
            cluster_mod.Node(id="dead2", uri="http://127.0.0.1:1"),
        ], local_id=c[0].cluster.local_id, replica_n=3)
        c[0].api.import_bits("aedown", "f", [5], [1], remote=True)
        frag = c[0].holder.index("aedown").field("f").view().fragment(0)
        synced = syncer.FragmentSyncer(frag, "aedown", dead,
                                       client).sync_fragment()
        return synced, bool(frag.contains(5, 1))

    assert _both(cluster3, run)[1] is True


def test_parse_duration():
    from pilosa_tpu.cli import parse_duration as jax_parse_duration
    from pilosa_tpu_torch.cli import parse_duration

    for text in ("10m", "30s", "500ms", "1h30m", "1.5h", "45", "2s",
                 "250ms", "5s"):
        assert parse_duration(text) == jax_parse_duration(text)
    assert parse_duration("10m") == 600
    assert parse_duration("500ms") == 0.5
    assert parse_duration("1h30m") == 5400
    with pytest.raises(ValueError):
        parse_duration("10 bananas")


def test_sync_full_cluster_convergence(cluster3):
    """After syncing every node twice, all replicas agree on a
    multi-shard spread of bits, and every owner's fragment is the TPU
    package's byte for byte."""
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 200, dtype=np.uint64)
    rows = rng.integers(0, 5, 200, dtype=np.uint64)

    def run(c, syncer, client, cluster_mod, ser):
        c[0].api.create_index("aeconv")
        c[0].api.create_field("aeconv", "f")
        # uneven scatter: each node applies its slice locally only; the
        # slices follow the nodes' sorted ids, so both clusters diverge
        # the same way
        nodes = sorted(c.nodes, key=lambda h: h.cluster.local_id)
        for i, h in enumerate(nodes):
            h.api.import_bits("aeconv", "f", rows[i::3], cols[i::3],
                              remote=True)
        for _ in range(2):
            for h in nodes:
                syncer.HolderSyncer(h.holder, h.cluster, client).sync_holder()
        want = int(c[0].api.query("aeconv", "Count(Row(f=1))")[0])
        union, blobs = set(), []
        for shard in range(3):
            owners = c[0].cluster.shard_nodes("aeconv", shard)
            per_owner = [set(_local_columns(c.node_by_id(n.id), "aeconv",
                                            "f", 1, shard)) for n in owners]
            assert all(p == per_owner[0] for p in per_owner)
            union |= per_owner[0]
            for n in owners:
                v = c.node_by_id(n.id).holder.index("aeconv").field("f") \
                    .view()
                frag = v.fragment(shard)
                blobs.append(ser(frag.storage) if frag else b"")
        return want, len(union), sorted(set(blobs))

    want, got, _ = _both(cluster3, run)
    assert got == want

