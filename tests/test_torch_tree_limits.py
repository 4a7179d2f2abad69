"""Counts over trees beyond K1's limits (more than 16 leaf slots, a
program of more than 64 steps, a stack depth above 8): the port against
the TPU package, end to end on the CPU.

`count_expr` brings such a tree within K1's limits with `fit_tree`
(sub-trees folded to planes by torch elementwise ops) on every device,
so these CPU runs take the same split the card does. A data directory
written by `pilosa_tpu.core.Holder` (rows drawn from a numpy seed) is
served by the TPU package's Executor (JAX on the CPU) and by the port's
Executor (device="cpu"); the same PQL must give equal results. A unit
test holds `fit_tree` itself to `compile_program` and to a numpy count
of the original tree. Tolerance: exact equality.
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.ops import containers as jc  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.ops import containers as tc  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as k1  # noqa: E402
from tests.test_containers import _stack  # noqa: E402

N_SHARDS = 2
N_ROWS = 40
MIXED = ("clustered_0.1pct", "runs", "random_50pct")  # sparse, rle, dense


def _rows(n):
    return [f"Row(f={i})" for i in n]


def _call(name, children):
    return f"{name}({', '.join(children)})"


def _right_nested(depth, ops=("Intersect", "Union")):
    """Calls alternating over `ops`, nested to the right: stack depth
    `depth` over rows 0..depth-1."""
    pql = f"Row(f={depth - 1})"
    for i in range(depth - 2, -1, -1):
        pql = _call(ops[i % len(ops)], [f"Row(f={i})", pql])
    return pql


# > 64 steps over 10 slots: 40 leaf occurrences compile to 79 steps
LONG = _call("Union", [_call("Xor", _rows(range(10))),
                       _call("Difference", _rows(range(9, -1, -1))),
                       _call("Xor", _rows([3, 4, 5, 6, 7, 8, 9, 0, 1, 2])),
                       _call("Union", _rows(range(10)))])

QUERIES = {
    "union_17": _call("Union", _rows(range(17))),
    "union_33": _call("Union", _rows(range(33))),
    "xor_17": _call("Xor", _rows(range(17))),
    "difference_20": _call("Difference", _rows(range(20))),
    "program_79_steps": LONG,
    "right_nested_depth_9": _right_nested(9),
    "right_nested_depth_12": _right_nested(12, ("Union", "Difference",
                                                "Xor", "Intersect")),
    "wide_and_deep": _call("Union", _rows(range(20, 37))
                           + [_right_nested(10)]),
}


def _write_dir(path, seed=23):
    """Field f: N_ROWS rows of 5% random columns over N_SHARDS shards.
    Field c: 17 rows cycling over a sparse, a run-length and a dense
    density pattern (each row shifted by its own number of blocks)."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    n = N_SHARDS * SHARD_WIDTH
    for row in range(N_ROWS):
        cols = rng.choice(n, size=n // 20, replace=False).astype(np.uint64)
        f.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
    c = idx.create_field("c")
    for row in range(17):
        stack = np.roll(_stack(MIXED[row % 3], s=N_SHARDS), 128 * row, axis=1)
        bits = np.unpackbits(stack.view(np.uint8), axis=1, bitorder="little")
        shard, off = np.nonzero(bits)
        cols = (shard * SHARD_WIDTH + off).astype(np.uint64)
        c.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
    h.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("tree_limits")
    src = str(base / "src")
    _write_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jc.repr_mode()
    jc.configure("dense")
    try:
        yield JaxExecutor(jh), th
    finally:
        jc.configure(prev)
        jh.close()
        th.close()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_count_beyond_limits_matches_reference(pair, name):
    jex, th = pair
    pql = f"Count({QUERIES[name]})"
    ex = Executor(th, device="cpu")
    want = jex.execute("i", pql)
    assert want[0] > 0
    assert ex.execute("i", pql) == want
    assert ex.stacked_stats()["dispatches"] == 1  # one stacked Count


@pytest.fixture
def auto_mode():
    """The auto chooser at CPU scale: the 4 MiB floor drops to 0."""
    saved = (tc.repr_mode(), tc.AUTO_COMPRESS_FLOOR)
    tc.configure("auto")
    tc.AUTO_COMPRESS_FLOOR = 0
    yield
    tc.configure(saved[0])
    tc.AUTO_COMPRESS_FLOOR = saved[1]


MIXED_QUERIES = {
    "union_17": _call("Union", [f"Row(c={i})" for i in range(17)]),
    "xor_17": _call("Xor", [f"Row(c={i})" for i in range(17)]),
    "difference_of_union_and_intersect": _call("Difference", [
        _call("Union", [f"Row(c={i})" for i in range(9)]),
        _call("Intersect", [f"Row(c={i})" for i in (9, 12, 15)]),
        _call("Union", [f"Row(c={i})" for i in (10, 11, 13, 14, 16)])]),
}


@pytest.mark.parametrize("name", sorted(MIXED_QUERIES))
def test_mixed_containers_beyond_limits(pair, auto_mode, name):
    jex, th = pair
    pql = f"Count({MIXED_QUERIES[name]})"
    ex = Executor(th, device="cpu")
    want = jex.execute("i", pql)
    assert want[0] > 0
    assert ex.execute("i", pql) == want
    kinds = {tc.kind_of(e[1]) for e in ex._stacked._pools["leaf"].values()}
    assert kinds == {"dense", "sparse", "rle"}


# ------------------------------------------------------------ fit_tree alone

OPS = "&|^-"


def _random_tree(rng, n_leaves, levels, n_slots):
    """A tree of exactly n_leaves leaf occurrences over slots 0..n_slots-1,
    nested `levels` deep along one branch, ops and fan-outs random."""
    def build(n, d):
        if n == 1 or d == 1:
            return ("leaf", int(rng.integers(n_slots)))
        k = int(rng.integers(2, min(n, 6) + 1))
        cuts = np.sort(rng.choice(np.arange(1, n), k - 1, replace=False))
        sizes = np.diff(np.concatenate([[0], cuts, [n]]))
        deep = int(rng.integers(k))
        subs = tuple(build(int(s), d - 1 if i == deep
                           else int(rng.integers(1, d)))
                     for i, s in enumerate(sizes))
        return (OPS[int(rng.integers(len(OPS)))], subs)
    return build(n_leaves, levels)


def _numpy_count(sig, planes):
    def ev(node):
        if node[0] == "leaf":
            return planes[node[1]]
        acc = ev(node[1][0])
        for sub in node[1][1:]:
            p = ev(sub)
            acc = {"&": acc & p, "|": acc | p, "^": acc ^ p,
                   "-": acc & ~p}[node[0]]
        return acc
    return int(np.bitwise_count(ev(sig)).sum(dtype=np.int64))


@pytest.mark.parametrize("levels", [1, 2, 5, 8, 9, 12])
@pytest.mark.parametrize("n_leaves", [1, 2, 5, 16, 17, 24, 33, 40])
def test_fit_tree_within_kernel_limits(n_leaves, levels):
    rng = np.random.default_rng(n_leaves * 100 + levels)
    n_slots = n_leaves if n_leaves % 2 == 0 else n_leaves // 2 + 1
    sig = _random_tree(rng, n_leaves, levels, n_slots)
    planes = rng.integers(0, 1 << 32, (n_slots, 2, 8), dtype=np.uint32)
    stacks = [torch.from_numpy(p.view(np.int32)) for p in planes]
    fitted, leaves = k1.fit_tree(sig, stacks)
    k1.compile_program(fitted)  # raises past any limit
    assert 1 <= len(leaves) <= k1.MAX_LEAVES
    assert max(k1._leaf_slots(fitted, {})) < len(leaves)
    want = _numpy_count(sig, planes)
    assert int(k1.count_expr_reference(fitted, leaves)) == want
    assert int(k1.count_expr(sig, stacks)) == want


def test_fit_tree_folds_as_little_as_needed():
    """A 17-way union folds only its first two operands; a 33-way union
    its first 18; a right-nested depth-9 tree only its deepest node."""
    x = [torch.full((1, WORDS_PER_ROW), i, dtype=torch.int32)
         for i in range(33)]
    for n, folded in ((17, 2), (33, 18)):
        sig = ("|", tuple(("leaf", i) for i in range(n)))
        fitted, leaves = k1.fit_tree(sig, x[:n])
        assert fitted == ("|", (("leaf", 15),)
                          + tuple(("leaf", i) for i in range(15)))
        assert [id(t) for t in leaves[:15]] == [id(t) for t in x[folded:n]]
        assert torch.equal(leaves[15], k1.tree_eval(
            ("|", sig[1][:folded]), x))
    deep = ("leaf", 0)
    for i in range(1, 9):
        deep = ("&", (("leaf", i), deep))
    fitted, leaves = k1.fit_tree(deep, x[:9])
    assert [id(t) for t in leaves[:7]] == [id(t) for t in x[2:9]]
    assert len(leaves) == 8
    assert len(k1.compile_program(fitted)) == 15
    small = ("-", (("leaf", 1), ("leaf", 0)))
    assert k1.fit_tree(small, x[:2]) == (small, x[:2])
