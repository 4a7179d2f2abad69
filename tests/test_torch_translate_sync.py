"""The port's key replication (pilosa_tpu_torch/server/translate_sync.py)
against the TPU package's, on the CPU.

Every case of tests/test_translate_sync.py runs on one in-process 3-node,
replicas-2 cluster of each package, each node with a TranslateReplicator
pumped by hand in chain order (head, mid, tail: the cluster's sorted
ids): which stores are read-only, the ids keys resolve to on every node,
forwarded creates, keyed queries through replicas, field keys and the
head's promotion after a topology change must all equal the TPU
package's.
"""

from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.server as jax_server  # noqa: E402
import pilosa_tpu.storage as jax_storage  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.server as torch_server  # noqa: E402
import pilosa_tpu_torch.storage as torch_storage  # noqa: E402
from pilosa_tpu_torch.server.translate_sync import (  # noqa: E402
    TranslateReplicator)
from pilosa_tpu_torch.tools.cluster import ClusterHarness  # noqa: E402

from tests.harness import ClusterHarness as JaxClusterHarness  # noqa: E402

SIDES = (
    SimpleNamespace(name="jax", harness=JaxClusterHarness, core=jax_core,
                    Client=jax_server.Client,
                    Replicator=jax_server.TranslateReplicator,
                    ReadOnly=jax_storage.TranslateReadOnlyError),
    SimpleNamespace(name="port", harness=ClusterHarness, core=torch_core,
                    Client=torch_server.Client, Replicator=TranslateReplicator,
                    ReadOnly=torch_storage.TranslateReadOnlyError),
)


@pytest.fixture()
def clusters():
    made = []
    try:
        for side in SIDES:
            c = side.harness(3, replica_n=2)
            made.append((side, c))
            # a replicator per node (not started: tests pump by hand)
            for h in c.nodes:
                h.replicator = side.Replicator(h.holder, h.cluster,
                                               side.Client)
        yield made
    finally:
        for _, c in made:
            c.close()


def chain_order(c):
    """Harness nodes in cluster (sorted-id) order: [head, mid, tail]."""
    return [c.node_by_id(n.id) for n in c[0].cluster.nodes]


def pump(c):
    """One replication pass on every node, chain order (head first)."""
    for h in chain_order(c):
        h.replicator.replicate_once()


def run_both(clusters, scenario):
    out = [scenario(side, c) for side, c in clusters]
    assert out[1] == out[0], (out[1], out[0])
    return out[1]


def _keyed(side):
    return side.core.IndexOptions(keys=True)


def test_replica_stores_are_read_only(clusters):
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t", options=_keyed(side))
        flags = [head.holder.index("t").translate_store.read_only]
        for h in (mid, tail):
            store = h.holder.index("t").translate_store
            flags.append(store.read_only)
            # a direct create without the forwarding hook raises
            store.remote_create = None
            with pytest.raises(side.ReadOnly):
                store.translate_key("nope")
            h.replicator.configure_store(store)  # restore the hook
        return flags

    assert run_both(clusters, scenario) == [False, True, True]


def test_chain_replication_propagates_keys(clusters):
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t2", options=_keyed(side))
        ids = head.holder.index("t2").translate_store.translate_keys(
            ["alpha", "beta", "gamma"])
        pump(c)  # head->mid, then mid->tail
        return ids, [h.holder.index("t2").translate_store.translate_ids(ids)
                     for h in (mid, tail)]

    _, keys = run_both(clusters, scenario)
    assert keys == [["alpha", "beta", "gamma"]] * 2


def test_replica_create_forwards_to_primary(clusters):
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t3", options=_keyed(side))
        tail_store = tail.holder.index("t3").translate_store
        ids = tail_store.translate_keys(["via-tail"])
        seen = [head.holder.index("t3").translate_store.translate_ids(ids),
                tail_store.translate_ids(ids)]
        pump(c)
        seen.append(mid.holder.index("t3").translate_store.translate_ids(ids))
        return ids, seen

    ids, seen = run_both(clusters, scenario)
    assert ids == [1] and seen == [["via-tail"]] * 3


def test_keyed_query_via_replica_consistent_ids(clusters):
    """Set() with keys through a replica allocates on the primary, so
    every node agrees key<->id after replication."""
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t4", options=_keyed(side))
        head.api.create_field("t4", "f")
        tail.api.query("t4", 'Set("colA", f=3)')
        mid.api.query("t4", 'Set("colB", f=3)')
        pump(c)
        stores = [h.holder.index("t4").translate_store
                  for h in (head, mid, tail)]
        ids_a = sorted({s.translate_key("colA", create=False)
                        for s in stores})
        ids_b = sorted({s.translate_key("colB", create=False)
                        for s in stores})
        rows = [sorted(h.api.query("t4", "Row(f=3)")[0].keys)
                for h in (head, mid, tail)]
        return ids_a, ids_b, rows

    ids_a, ids_b, rows = run_both(clusters, scenario)
    assert len(ids_a) == 1 and None not in ids_a
    assert len(ids_b) == 1 and None not in ids_b and ids_a != ids_b
    assert rows == [["colA", "colB"]] * 3


def test_field_key_replication(clusters):
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t5")
        head.api.create_field("t5", "kf",
                              options=side.core.FieldOptions(keys=True))
        tail.api.query("t5", 'Set(7, kf="rowkey")')
        pump(c)
        ids = [h.holder.index("t5").field("kf").translate_store
               .translate_key("rowkey", create=False)
               for h in (head, mid, tail)]
        return ids, [int(x) for x in
                     head.api.query("t5", 'Row(kf="rowkey")')[0].columns()]

    ids, cols = run_both(clusters, scenario)
    assert None not in ids and len(set(ids)) == 1
    assert cols == [7]


def test_refresh_after_topology_change(clusters):
    """With the head gone from the topology, the next node becomes
    writable after refresh()."""
    def scenario(side, c):
        head, mid, tail = chain_order(c)
        head.api.create_index("t6", options=_keyed(side))
        mid_store = mid.holder.index("t6").translate_store
        before = mid_store.read_only
        mid.cluster.nodes = [n for n in mid.cluster.nodes
                             if n.id != head.cluster.local_id]
        mid.replicator.refresh()
        return before, mid_store.read_only, \
            mid_store.translate_key("promoted") is not None

    assert run_both(clusters, scenario) == (True, False, True)
