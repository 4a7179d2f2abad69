"""Randomized cluster differential on the port: tests/test_fuzz_cluster.py
on the port's in-process cluster (torch on the CPU), with two more
oracles beside its naive model.

Random imports land through different coordinating nodes of a 3-node
port cluster (each import's shard slicing and replica fan-out runs on a
different node), and the same imports go to a single-node server of the
TPU package (JAX on the CPU) and a single-node server of the port. Every
random query is answered by every cluster node in turn and must equal
the model, the TPU package's single node and the port's single node.
"""

import random

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.tools.cluster import (  # noqa: E402
    ClusterHarness, NodeHarness)

from tests.harness import ServerHarness  # noqa: E402

N_SHARDS = 6
UNIVERSE = SHARD_WIDTH * N_SHARDS
ROWS = (0, 1, 2, 3)


class Model:
    def __init__(self):
        self.rows = {r: set() for r in ROWS}
        self.ints = {}


class Fixture:
    """The port's cluster, the TPU package's single node and the port's
    single node, fed the same imports."""

    def __init__(self, seed, replica_n):
        self.model = Model()
        self.singles = []
        self.cl = ClusterHarness(3, replica_n=replica_n)
        try:
            self.singles = [ServerHarness(), NodeHarness()]
            self._populate(random.Random(seed))
        except BaseException:
            self.close()
            raise

    def _populate(self, rnd):
        singles = [s.client for s in self.singles]
        for c in [self.cl[0].client] + singles:
            c.create_index("fc")
            c.create_field("fc", "f", {"type": "set"})
            c.create_field("fc", "v", {"type": "int",
                                       "min": -100, "max": 10_000})
        for i in range(12):
            r = rnd.choice(ROWS)
            cols = rnd.sample(range(UNIVERSE), rnd.randint(10, 120))
            for c in [self.cl[i % 3].client] + singles:
                c.import_bits("fc", "f", [r] * len(cols), cols)
            self.model.rows[r].update(cols)
        for i in range(6):
            cols = rnd.sample(range(UNIVERSE), rnd.randint(10, 60))
            vals = [rnd.randint(-100, 10_000) for _ in cols]
            for c in [self.cl[i % 3].client] + singles:
                c.import_values("fc", "v", cols, vals)
            self.model.ints.update(zip(cols, vals))

    def answer(self, i, pql, pick):
        """The cluster node i%3's answer, after checking both single
        nodes give the same."""
        got = pick(self.cl[i % 3].client.query("fc", pql)["results"][0])
        for s in self.singles:
            want = pick(s.client.query("fc", pql)["results"][0])
            assert got == want, (pql, got, want, type(s).__module__)
        return got

    def close(self):
        self.cl.close()
        for s in self.singles:
            s.close()


def _same(x):
    return x


@pytest.mark.parametrize("seed", [29, 47])
def test_cluster_differential(seed):
    fx = Fixture(seed, replica_n=2)
    model = fx.model
    rnd = random.Random(seed * 7)
    try:
        for i in range(30):
            kind = rnd.choice(["count", "row", "topn", "sum", "bsicount"])
            if kind == "count":
                a, b = rnd.choice(ROWS), rnd.choice(ROWS)
                want = len(model.rows[a] & model.rows[b])
                got = fx.answer(
                    i, f"Count(Intersect(Row(f={a}), Row(f={b})))", _same)
            elif kind == "row":
                r = rnd.choice(ROWS)
                want = sorted(model.rows[r])
                got = fx.answer(i, f"Row(f={r})", lambda x: x["columns"])
            elif kind == "topn":
                truth = sorted(((len(model.rows[r]), r) for r in ROWS),
                               key=lambda t: (-t[0], t[1]))
                want = [{"id": r, "count": n} for n, r in truth if n][:2]
                got = fx.answer(i, "TopN(f, n=2)", _same)
            elif kind == "sum":
                r = rnd.choice(ROWS)
                in_f = [v for c, v in model.ints.items()
                        if c in model.rows[r]]
                want = {"value": sum(in_f), "count": len(in_f)}
                got = fx.answer(i, f"Sum(Row(f={r}), field=v)", _same)
            else:
                x = rnd.randint(-150, 10_100)
                want = sum(1 for v in model.ints.values() if v > x)
                got = fx.answer(i, f"Count(Row(v > {x}))", _same)
            assert got == want, \
                f"seed={seed} i={i} node={i % 3} {kind}: {got} != {want}"
    finally:
        fx.close()


@pytest.mark.parametrize("seed", [61])
def test_cluster_differential_replica1(seed):
    """replicaN=1: every shard has exactly one owner, so every cross-node
    query MUST fan out correctly or lose whole shards."""
    fx = Fixture(seed, replica_n=1)
    rnd = random.Random(seed * 13)
    try:
        for i in range(12):
            r = rnd.choice(ROWS)
            got = fx.answer(i, f"Count(Row(f={r}))", _same)
            assert got == len(fx.model.rows[r]), \
                f"seed={seed} i={i} node={i % 3}"
    finally:
        fx.close()
