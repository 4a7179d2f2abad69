"""The port's cluster layer (pilosa_tpu_torch/cluster/) against the TPU
package's, on the CPU.

Every case of `tests/test_cluster.py` runs on both packages:

- hashing, placement, cluster state, topology persistence, fragment
  sources, the control-message serializer and the PQL writer run the
  same calls on both packages' modules and compare what they return
  (placement on one fixed node list: both must put every shard on the
  same nodes);
- the multi-node cases boot one in-process cluster of each package (the
  TPU package's `tests/harness.ClusterHarness`, JAX on the CPU, and the
  port's `pilosa_tpu_torch.tools.cluster.ClusterHarness`, torch on the
  CPU), send both the same DDL, writes and queries, and compare the
  answers. Ephemeral ports give the two clusters different node ids, and
  placement follows the sorted ids, so answers are compared, not which
  node served a shard.

Two cases are the port's own: a local fan-out leg whose kernel fails on
the card (a wrapper raising RuntimeError("... CUDA error ...")) fails the
query with a 500 and is never retried on a peer, and a remote leg that
fails over to a replica is counted.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.cluster as jax_cluster  # noqa: E402
import pilosa_tpu.server.client as jax_client  # noqa: E402
import pilosa_tpu_torch.cluster as torch_cluster  # noqa: E402
import pilosa_tpu_torch.server.client as torch_client  # noqa: E402
from pilosa_tpu.pql import parse as jax_parse  # noqa: E402
from pilosa_tpu.pql import query_to_pql as jax_query_to_pql  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.pql import parse, query_to_pql  # noqa: E402
from pilosa_tpu_torch.tools.cluster import ClusterHarness  # noqa: E402

from tests.harness import ClusterHarness as JaxClusterHarness  # noqa: E402

PKGS = (jax_cluster, torch_cluster)


def make_cluster(pkg, n, replica_n=1, hasher=None, local=0):
    nodes = [pkg.Node(f"node{i}", f"http://127.0.0.1:{10000 + i}")
             for i in range(n)]
    return pkg.Cluster(nodes=nodes, local_id=f"node{local}",
                       replica_n=replica_n, hasher=hasher)


def _ids(nodes):
    return [n.id for n in nodes]


# ----------------------------------------------------------------- hashing

class TestHashing:
    def test_fnv1a64_known_vectors(self):
        for pkg in PKGS:
            assert pkg.fnv1a64(b"") == 0xcbf29ce484222325
            assert pkg.fnv1a64(b"a") == 0xaf63dc4c8601ec8c
            assert pkg.fnv1a64(b"foobar") == 0x85944171f73967e8
        rng = np.random.default_rng(5)
        for _ in range(50):
            data = rng.bytes(int(rng.integers(0, 40)))
            assert torch_cluster.fnv1a64(data) == jax_cluster.fnv1a64(data)

    def test_partition_stable(self):
        for pkg in PKGS:
            p1 = pkg.partition_hash("i", 0, 256)
            assert p1 == pkg.partition_hash("i", 0, 256)
            assert 0 <= p1 < 256
        for index in ("i", "j", "golden", "b"):
            for shard in range(0, 1000, 37):
                assert torch_cluster.partition_hash(index, shard, 256) \
                    == jax_cluster.partition_hash(index, shard, 256)

    def test_jump_hash_properties(self):
        for pkg in PKGS:
            h = pkg.JmpHasher()
            for key in range(100):
                for n in (1, 3, 16):
                    b = h.hash(key, n)
                    assert 0 <= b < n
                    assert b == h.hash(key, n)
            moved = sum(1 for key in range(1000)
                        if h.hash(key, 4) != h.hash(key, 5))
            assert moved < 1000 * 0.35

    def test_jump_hash_reference_values(self):
        hj, ht = jax_cluster.JmpHasher(), torch_cluster.JmpHasher()
        assert ht.hash(0, 1) == 0
        for key in list(range(64)) + [2 ** 40 + 7, 2 ** 63 - 1]:
            for n in (1, 2, 3, 4, 7, 256):
                assert ht.hash(key, n) == hj.hash(key, n)


# --------------------------------------------------------------- placement

class TestPlacement:
    def test_replica_sets(self):
        owners = {}
        for pkg in PKGS:
            c = make_cluster(pkg, 4, replica_n=2)
            got = c.shard_nodes("i", 0)
            assert len(got) == 2 and got[0].id != got[1].id
            c2 = make_cluster(pkg, 4, replica_n=2, local=3)
            assert _ids(c2.shard_nodes("i", 0)) == _ids(got)
            owners[pkg] = [_ids(c.shard_nodes("i", s)) for s in range(200)]
        assert owners[torch_cluster] == owners[jax_cluster]

    def test_replica_n_capped_by_nodes(self):
        for pkg in PKGS:
            c = make_cluster(pkg, 2, replica_n=5)
            assert len(c.shard_nodes("i", 7)) == 2

    def test_shards_by_node_covers_all(self):
        shards = list(range(954))
        got = {}
        for pkg in PKGS:
            c = make_cluster(pkg, 3, replica_n=2)
            by_node = c.shards_by_node("b", shards)
            assert sorted(s for ss in by_node.values() for s in ss) == shards
            got[pkg] = {n.id: list(ss) for n, ss in by_node.items()}
        assert got[torch_cluster] == got[jax_cluster]

    def test_mod_hasher_deterministic(self):
        for pkg in PKGS:
            c = make_cluster(pkg, 3, hasher=pkg.ModHasher())
            p = c.partition("i", 0)
            assert c.shard_nodes("i", 0)[0].id == f"node{p % 3}"
        cj = make_cluster(jax_cluster, 3, hasher=jax_cluster.ModHasher())
        ct = make_cluster(torch_cluster, 3, hasher=torch_cluster.ModHasher())
        assert [_ids(ct.shard_nodes("i", s)) for s in range(64)] == \
            [_ids(cj.shard_nodes("i", s)) for s in range(64)]

    def test_owns_shard(self):
        for pkg in PKGS:
            c = make_cluster(pkg, 3, replica_n=3)
            for nid in ("node0", "node1", "node2"):
                assert c.owns_shard(nid, "i", 5)
        cj = make_cluster(jax_cluster, 3, replica_n=2)
        ct = make_cluster(torch_cluster, 3, replica_n=2)
        for s in range(100):
            for nid in ("node0", "node1", "node2"):
                assert ct.owns_shard(nid, "i", s) == cj.owns_shard(nid, "i", s)


class TestClusterState:
    def test_degraded_on_node_down(self):
        for pkg in PKGS:
            c = make_cluster(pkg, 3, replica_n=2)
            assert c.state == pkg.CLUSTER_STATE_NORMAL
            c.set_node_state("node1", "DOWN")
            assert c.state == pkg.CLUSTER_STATE_DEGRADED
            c.set_node_state("node1", "READY")
            assert c.state == pkg.CLUSTER_STATE_NORMAL

    def test_unavailable_when_too_many_down(self):
        for pkg in PKGS:
            c = make_cluster(pkg, 3, replica_n=1)
            c.set_node_state("node1", "DOWN")
            assert c.state == "STARTING"


class TestTopology:
    def test_persistence(self, tmp_path):
        """Each package loads its own .topology and the other's."""
        for writer, reader in ((torch_cluster, torch_cluster),
                               (torch_cluster, jax_cluster),
                               (jax_cluster, torch_cluster)):
            d = tmp_path / f"{writer.__name__}-{reader.__name__}"
            d.mkdir()
            nodes = [writer.Node("a", "http://h1"),
                     writer.Node("b", "http://h2")]
            writer.Cluster(nodes=nodes, local_id="a",
                           path=str(d)).save_topology()
            c2 = reader.Cluster(nodes=[], local_id="a", path=str(d))
            assert c2.load_topology()
            assert [n.id for n in c2.nodes] == ["a", "b"]


class TestFragSources:
    def test_new_node_fetches_from_old_owner(self):
        got = {}
        for pkg in PKGS:
            old = [pkg.Node("a", "http://h1"), pkg.Node("b", "http://h2")]
            new = old + [pkg.Node("c", "http://h3")]
            c = pkg.Cluster(nodes=new, local_id="a", replica_n=1)
            sources = c.frag_sources(old, new, "i", list(range(50)))
            for dest_id, pairs in sources.items():
                for shard, src_id in pairs:
                    assert src_id in set(_ids(c.shard_nodes("i", shard, old)))
                    new_owners = set(_ids(c.shard_nodes("i", shard, new)))
                    assert dest_id in new_owners
                    assert dest_id not in set(
                        _ids(c.shard_nodes("i", shard, old)))
            got[pkg] = {k: sorted(v) for k, v in sources.items()}
        assert got[torch_cluster] == got[jax_cluster]


class TestSerializer:
    def test_roundtrip(self):
        payload = {"index": "i", "options": {}}
        for pkg in PKGS:
            data = pkg.Serializer.marshal(pkg.MessageType.CREATE_INDEX,
                                          payload)
            msg_type, got = pkg.Serializer.unmarshal(data)
            assert msg_type == pkg.MessageType.CREATE_INDEX
            assert got == payload
        # the wire is shared: each package reads the other's messages
        assert torch_cluster.MessageType.ALL == jax_cluster.MessageType.ALL
        for mt in jax_cluster.MessageType.ALL:
            data = jax_cluster.Serializer.marshal(mt, payload)
            assert torch_cluster.Serializer.marshal(mt, payload) == data
            assert torch_cluster.Serializer.unmarshal(data) == (mt, payload)

    def test_unknown_type_rejected(self):
        for pkg in PKGS:
            with pytest.raises(ValueError):
                pkg.Serializer.marshal("bogus", {})
            with pytest.raises(ValueError):
                pkg.Serializer.unmarshal(b'{"type": "bogus"}')


class TestPqlWriter:
    def test_roundtrip(self):
        cases = [
            "Set(1, f=10)",
            'Set(1, f=10, 2019-01-02T03:04)',
            "Clear(1, f=10)",
            "Row(f=10)",
            "Count(Intersect(Row(f=10), Row(g=3)))",
            "Union(Row(f=1), Row(f=2), Row(f=3))",
            "Not(Row(f=1))",
            "TopN(f, n=5)",
            "Rows(f, limit=3, previous=2)",
            "GroupBy(Rows(f), Rows(g), limit=10)",
            "Row(v > 5)",
            "Row(v >< [3, 9])",
            'Row(f="key")',
            "Sum(Row(f=1), field=v)",
            "Min(field=v)",
            "Store(Row(f=1), g=2)",
            'SetRowAttrs(f, 1, color="red")',
            'SetColumnAttrs(3, name="x")',
            "ClearRow(f=2)",
            "Options(Row(f=1), excludeColumns=true)",
        ]
        for pql in cases:
            q1 = parse(pql)
            text = query_to_pql(q1)
            assert parse(text) == q1, f"{pql!r} -> {text!r}"
            # the fan-out legs' PQL is the TPU package's text
            assert text == jax_query_to_pql(jax_parse(pql))


# --------------------------------------------------------------- multi-node

class Dual:
    """A cluster of each package; `both(fn)` runs fn on each and checks
    that they agree."""

    def __init__(self, n, replica_n=1):
        self.jax = JaxClusterHarness(n, replica_n=replica_n)
        try:
            self.port = ClusterHarness(n, replica_n=replica_n)
        except BaseException:
            self.jax.close()
            raise

    def both(self, fn):
        want = fn(self.jax)
        got = fn(self.port)
        assert got == want, (got, want)
        return got

    def each(self):
        return (self.jax, self.port)

    def close(self):
        self.port.close()
        self.jax.close()


@pytest.fixture(scope="module")
def tri_cluster():
    d = Dual(3, replica_n=1)
    yield d
    d.close()


def _sorted_columns(resp):
    return sorted(resp["results"][0]["columns"])


class TestMultiNode:
    def test_schema_propagates(self, tri_cluster):
        for h in tri_cluster.each():
            h[0].client.create_index("mi")
            h[0].client.create_field("mi", "mf")
            for node in h.nodes:
                assert node.holder.index("mi") is not None
                assert node.holder.index("mi").field("mf") is not None
            h[1].client.create_field("mi", "tmp")
            h[1].client.delete_field("mi", "tmp")
        time.sleep(0.3)  # async broadcast settles
        for h in tri_cluster.each():
            for node in h.nodes:
                assert node.holder.index("mi").field("tmp") is None
        tri_cluster.both(lambda h: [n.client.schema() for n in h.nodes])

    def test_set_routes_to_owner(self, tri_cluster):
        col = 2 * SHARD_WIDTH + 7
        for h in tri_cluster.each():
            h[0].client.create_index("ri")
            h[0].client.create_field("ri", "rf")
        time.sleep(0.2)
        for h in tri_cluster.each():
            writer = h.non_owner_of("ri", 2) or h[0]
            resp = writer.client.query("ri", f"Set({col}, rf=1)")
            assert resp["results"] == [True]
            frag = h.owner_of("ri", 2).holder.index("ri").field("rf") \
                .view("standard").fragment(2)
            assert frag is not None and frag.contains(1, col)
        assert tri_cluster.both(lambda h: [
            n.client.query("ri", "Count(Row(rf=1))")["results"]
            for n in h.nodes]) == [[1]] * 3

    def test_import_routes_and_queries_merge(self, tri_cluster):
        cols = [s * SHARD_WIDTH + (s % 5) for s in range(6)]
        for h in tri_cluster.each():
            h[0].client.create_index("qi")
            h[0].client.create_field("qi", "qf")
        time.sleep(0.2)
        tri_cluster.both(lambda h: (
            h[1].client.import_bits("qi", "qf", [1] * 6, cols),
            h[1].client.import_bits("qi", "qf", [2] * 3, cols[:3])))
        out = tri_cluster.both(lambda h: [
            (n.client.query("qi", "Count(Row(qf=1))")["results"],
             _sorted_columns(n.client.query("qi", "Row(qf=1)")),
             n.client.query("qi", "TopN(qf, n=2)")["results"],
             n.client.query("qi", "Rows(qf)")["results"])
            for n in h.nodes])
        for count, columns, topn, rows in out:
            assert count == [6]
            assert columns == sorted(cols)
            assert topn[0] == [{"id": 1, "count": 6}, {"id": 2, "count": 3}]
            assert rows[0] == {"rows": [1, 2]}

    def test_bsi_sum_across_nodes(self, tri_cluster):
        cols = [s * SHARD_WIDTH for s in range(4)]
        for h in tri_cluster.each():
            h[0].client.create_index("bi")
            h[0].client.create_field(
                "bi", "bv", options={"type": "int", "min": 0, "max": 1000})
        time.sleep(0.2)
        tri_cluster.both(lambda h: h[2].client.import_values(
            "bi", "bv", cols, [10, 20, 30, 40]))
        out = tri_cluster.both(lambda h: [
            (n.client.query("bi", "Sum(field=bv)")["results"],
             _sorted_columns(n.client.query("bi", "Row(bv > 15)")),
             n.client.query("bi", "Max(field=bv)")["results"],
             n.client.query("bi", "Min(field=bv)")["results"])
            for n in h.nodes])
        for sum_, gt, mx, _ in out:
            assert sum_ == [{"value": 100, "count": 4}]
            assert gt == cols[1:]
            assert mx == [{"value": 40, "count": 1}]

    def test_groupby_across_nodes(self, tri_cluster):
        cols = [s * SHARD_WIDTH + 1 for s in range(4)]
        for h in tri_cluster.each():
            h[0].client.create_index("gi")
            h[0].client.create_field("gi", "ga")
            h[0].client.create_field("gi", "gb")
        time.sleep(0.2)
        tri_cluster.both(lambda h: (
            h[0].client.import_bits("gi", "ga", [1] * 4, cols),
            h[0].client.import_bits("gi", "gb", [7, 7, 8, 8], cols)))
        out = tri_cluster.both(lambda h: [
            n.client.query("gi", "GroupBy(Rows(ga), Rows(gb))")["results"]
            for n in h.nodes])
        for res in out:
            assert res[0] == [
                {"group": [{"field": "ga", "rowID": 1},
                           {"field": "gb", "rowID": 7}], "count": 2},
                {"group": [{"field": "ga", "rowID": 1},
                           {"field": "gb", "rowID": 8}], "count": 2},
            ]


class TestMultiNodeEdgeCases:
    def test_empty_index_results_match_single_node_shapes(self, tri_cluster):
        for h in tri_cluster.each():
            h[0].client.create_index("ei")
            h[0].client.create_field("ei", "ef")
        out = tri_cluster.both(lambda h: [
            h[0].client.query("ei", q)["results"]
            for q in ("Count(Row(ef=1))", "Row(ef=1)", "TopN(ef, n=3)",
                      "Rows(ef)", "GroupBy(Rows(ef))")])
        assert out[:3] == [[0], [{"attrs": {}, "columns": []}], [[]]]

    def test_import_roaring_routes_to_owner(self, tri_cluster):
        from pilosa_tpu.roaring import Bitmap, serialize

        shard = 3
        bm = Bitmap()
        bm.add(1 * SHARD_WIDTH + (shard * SHARD_WIDTH + 11) % SHARD_WIDTH)
        blob = serialize(bm)
        for h in tri_cluster.each():
            h[0].client.create_index("rri")
            h[0].client.create_field("rri", "rrf")
            sender = h.non_owner_of("rri", shard) or h[0]
            assert sender.client.import_roaring(
                "rri", "rrf", shard, blob)["changed"] == 1
        assert tri_cluster.both(lambda h: [
            n.client.query("rri", "Count(Row(rrf=1))")["results"]
            for n in h.nodes]) == [[1]] * 3

    def test_remote_import_reports_changed(self, tri_cluster):
        cols = [s * SHARD_WIDTH + 1 for s in range(4)]
        for h in tri_cluster.each():
            h[0].client.create_index("ci2")
            h[0].client.create_field("ci2", "cf2")
        out = tri_cluster.both(lambda h: [
            n.client.import_bits("ci2", "cf2", [9] * len(cols), cols)
            ["changed"] for n in h.nodes])
        # the first import changes 4 bits; the repeats change none
        assert out == [4, 0, 0]

    def test_options_wrapped_limit_applies(self, tri_cluster):
        for h in tri_cluster.each():
            h[0].client.create_index("oi")
            h[0].client.create_field("oi", "of")
        tri_cluster.both(lambda h: h[0].client.import_bits(
            "oi", "of", [1, 2, 3], [0, 1, 2]))
        out = tri_cluster.both(lambda h: [
            n.client.query("oi", "Options(Rows(of, limit=1))")["results"]
            for n in h.nodes])
        assert out[0] == [{"rows": [1]}]


class TestReplication:
    def test_writes_hit_all_replicas_and_survive_node_loss(self):
        d = Dual(3, replica_n=2)
        cols = [s * SHARD_WIDTH + 3 for s in range(5)]
        try:
            for h in d.each():
                h[0].client.create_index("fi")
                h[0].client.create_field("fi", "ff")
            time.sleep(0.2)
            d.both(lambda h: h[0].client.import_bits(
                "fi", "ff", [4] * 5, cols))
            for h in d.each():
                for s in range(5):
                    owners = h[0].cluster.shard_nodes("fi", s)
                    assert len(owners) == 2
                    for owner in owners:
                        frag = h.node_by_id(owner.id).holder.index("fi") \
                            .field("ff").view("standard").fragment(s)
                        assert frag is not None, (s, owner.id)
                        assert frag.contains(4, cols[s])
                victim = h[1]
                victim.server.stop()
                victim.holder.close()
            assert d.both(lambda h: [
                h[i].client.query("fi", "Count(Row(ff=4))")["results"]
                for i in (0, 2)]) == [[5], [5]]
        finally:
            for h in d.each():
                for node in h.nodes:
                    try:
                        node.close()
                    except Exception:  # noqa: BLE001 — the stopped victim
                        pass


def test_shards_by_node_skips_down_primary():
    """Reads route to a live replica when the primary is DOWN (degraded
    reads; reference: executor.go:2490 replica retry + DEGRADED state)."""
    got = {}
    for pkg in PKGS:
        nodes = [pkg.Node(id=f"n{i}", uri=f"http://h{i}") for i in range(3)]
        c = pkg.Cluster(nodes=nodes, local_id="n0", replica_n=2)
        shards = list(range(8))
        normal = c.shards_by_node("i", shards)
        victim = sorted(normal, key=lambda n: n.id)[0]
        c.set_node_state(victim.id, pkg.NODE_STATE_DOWN)
        degraded = c.shards_by_node("i", shards)
        assert victim.id not in _ids(degraded)
        assert sorted(s for ss in degraded.values() for s in ss) == shards
        got[pkg] = {n.id: list(ss) for n, ss in degraded.items()}
        for n in nodes:
            c.set_node_state(n.id, pkg.NODE_STATE_DOWN)
        assert sorted(s for ss in c.shards_by_node("i", shards).values()
                      for s in ss) == shards
    assert got[torch_cluster] == got[jax_cluster]


def test_shard_discovery_gossips_not_polls():
    """Steady-state shard discovery does ZERO per-query HTTP: nodes push
    their shards over the control plane (CREATE_SHARD) and queries read
    the local map; peers are fetched only to seed it."""
    d = Dual(3, replica_n=1)
    cols = [s * SHARD_WIDTH + 1 for s in range(6)]
    try:
        for h in d.each():
            h[0].client.create_index("gi")
            h[0].client.create_field("gi", "gf")
        time.sleep(0.2)
        d.both(lambda h: h[0].client.import_bits("gi", "gf", [1] * 6, cols))
        time.sleep(0.5)  # async CREATE_SHARD pushes settle
        assert d.both(lambda h: [
            n.client.query("gi", "Count(Row(gf=1))")["results"]
            for n in h.nodes]) == [[6]] * 3
        for h, mod in ((d.jax, jax_client), (d.port, torch_client)):
            calls = {"n": 0}
            orig = mod.Client.index_shards

            def counted(self, index, orig=orig, calls=calls):
                calls["n"] += 1
                return orig(self, index)

            mod.Client.index_shards = counted
            try:
                for node in h.nodes:
                    assert node.client.query(
                        "gi", "Count(Row(gf=1))")["results"] == [6]
                assert calls["n"] == 0, calls
                h[0].client.query("gi", f"Set({7 * SHARD_WIDTH + 9}, gf=1)")
                time.sleep(0.5)
                for node in h.nodes:
                    assert node.client.query(
                        "gi", "Count(Row(gf=1))")["results"] == [7]
                assert calls["n"] == 0, calls
            finally:
                mod.Client.index_shards = orig
    finally:
        d.close()


def test_row_attrs_and_excludes_across_nodes():
    """Row attrs attach ONCE on the coordinator (remote partials skip
    decoration) and Options-wrapped exclude flags apply in a cluster."""
    d = Dual(3, replica_n=1)
    cols = [s * SHARD_WIDTH + 1 for s in range(4)]
    try:
        for h in d.each():
            h[0].client.create_index("ra")
            h[0].client.create_field("ra", "f")
        time.sleep(0.2)
        d.both(lambda h: (
            h[0].client.import_bits("ra", "f", [10] * len(cols), cols),
            h[0].client.query("ra", 'SetRowAttrs(f, 10, color="red")')))
        time.sleep(0.3)  # attr fan-out settles

        def read(h):
            out = []
            for node in h.nodes:
                got = node.client.query("ra", "Row(f=10)")["results"][0]
                out.append((got["attrs"], sorted(got["columns"])))
                got = node.client.query(
                    "ra", "Options(Row(f=10), excludeColumns=true)"
                )["results"][0]
                out.append((got["attrs"], got["columns"]))
                got = node.client.query(
                    "ra", "Options(Row(f=10), excludeRowAttrs=true)"
                )["results"][0]
                out.append((got["attrs"], sorted(got["columns"])))
            return out

        out = d.both(read)
        assert out[:3] == [({"color": "red"}, sorted(cols)),
                           ({"color": "red"}, []), ({}, sorted(cols))]
    finally:
        d.close()


# ---------------------------------------------------- the port's own cases

def test_local_leg_device_failure_is_a_500_not_a_retry(monkeypatch):
    """A local leg whose kernel fails on the card propagates out of the
    query as a 500, and no peer serves it instead: with replicas 2 on 2
    nodes the peer holds every shard, yet it gets no leg and the retry
    counter stays 0."""
    import urllib.error
    import urllib.request

    from pilosa_tpu_torch.ops import count_expr as k1

    h = ClusterHarness(2, replica_n=2)
    try:
        h[0].client.create_index("df")
        h[0].client.create_field("df", "f")
        cols = [s * SHARD_WIDTH + 5 for s in range(32)]
        h[0].client.import_bits("df", "f", [1] * 32, cols)
        assert h[0].client.query("df", "Count(Row(f=1))")["results"] == [32]

        def launch_failure(*a, **k):
            raise RuntimeError("count_expr kernel launch failed: "
                               "CUDA error 700")

        legs = []
        orig = torch_client.Client.query_proto

        def spy(self, *a, **k):
            legs.append(self.base_url)
            return orig(self, *a, **k)

        monkeypatch.setattr(k1, "count_expr_reference", launch_failure)
        monkeypatch.setattr(torch_client.Client, "query_proto", spy)
        for node in h.nodes:
            # the shards this node is primary for: its legs are all local
            own = [s for n, ss in node.cluster.shards_by_node(
                "df", range(32)).items() if n.id == node.node_id for s in ss]
            assert own
            req = urllib.request.Request(
                node.address + "/index/df/query?shards="
                + ",".join(map(str, own)),
                data=b"Count(Intersect(Row(f=1), Row(f=1)))", method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 500
            assert "CUDA error 700" in err.value.read().decode()
        assert legs == []
        for node in h.nodes:
            assert node.api.status()["cluster"]["leg_retries"] == 0
    finally:
        h.close()


def test_remote_leg_failover_is_counted():
    """A remote leg to a dead peer re-runs on the shard's next replica:
    the answer stays right, each re-run counts in `leg_retries`
    (/status's cluster block) and leaves a `cluster.leg_retry` event
    naming the failed node."""
    from pilosa_tpu_torch.utils import flightrec

    h = ClusterHarness(3, replica_n=2)
    try:
        h[0].client.create_index("fo")
        h[0].client.create_field("fo", "f")
        cols = [s * SHARD_WIDTH + 2 for s in range(12)]
        h[0].client.import_bits("fo", "f", [3] * 12, cols)
        coord = h[0]
        assert coord.client.query("fo", "Count(Row(f=3))")["results"] == [12]
        assert coord.api.status()["cluster"]["leg_retries"] == 0
        # a peer that is primary for some shards dies (not yet marked
        # DOWN: no health monitor runs in the harness)
        by_node = coord.cluster.shards_by_node("fo", range(12))
        victim = next(h.node_by_id(n.id) for n in by_node
                      if n.id != coord.node_id)
        victim.server.stop()
        assert coord.client.query("fo", "Count(Row(f=3))")["results"] == [12]
        retries = coord.api.status()["cluster"]["leg_retries"]
        assert retries >= 1
        events = [e for e in flightrec.snapshot(limit=200)["events"]
                  if e.get("kind") == "cluster.leg_retry"]
        assert events and events[-1]["tags"]["node"] == victim.node_id
    finally:
        h.close()
