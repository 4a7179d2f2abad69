"""The port's plane algebra (`pilosa_tpu_torch.ops.bitplane`) against
naive set algebra, on CPU tensors: the cases of `tests/test_bitplane.py`
over the functions the port keeps.

The matrix is (density regime) x (op): empty, sparse (array regime),
dense (bitmap regime), runs (run regime) and a 70,000-bit block, every
pair for every op. `hi_lo`, `combine_hi_lo`, `pairwise_counts*`,
`topn_counts`, `union_rows`, `any_set`, `not_` and `count_intersect`
were left out of the port (its counts are exact int64 and its TopN,
GroupBy and Not run through K3, K4 and the existence plane), so their
cases are not here. Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.ops import bitplane  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402


def plane_of(cols):
    """Set of shard-relative columns -> [WORDS_PER_ROW] uint32 plane."""
    bits = np.zeros(WORDS_PER_ROW * 32, dtype=np.uint8)
    bits[np.fromiter(cols, dtype=np.int64, count=len(cols))] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def set_of(plane):
    """Plane (numpy uint32 words or an int32 tensor) -> set of columns."""
    if isinstance(plane, torch.Tensor):
        plane = bitplane.to_host(plane)
    bits = np.unpackbits(np.asarray(plane, dtype=np.uint32).view(np.uint8),
                         bitorder="little")
    return set(np.nonzero(bits)[0].tolist())


def dev(cols):
    return bitplane.to_device(plane_of(cols), "cpu")


def random_cols(rng, n, width=SHARD_WIDTH):
    return set(int(x) for x in rng.choice(width, size=min(n, width),
                                          replace=False))


def regimes(rng):
    dense = random_cols(rng, 200_000)
    sparse = random_cols(rng, 50)
    runs = set()
    for start in range(0, SHARD_WIDTH, 65536):
        runs.update(range(start, start + 1000))
    return {
        "empty": set(),
        "sparse": sparse,
        "dense": dense,
        "runs": runs,
        "block": set(range(0, min(70000, SHARD_WIDTH))),
    }


@pytest.mark.parametrize("op,naive_op", [
    ("intersect", lambda a, b: a & b),
    ("union", lambda a, b: a | b),
    ("difference", lambda a, b: a - b),
    ("xor", lambda a, b: a ^ b),
])
def test_pairwise_ops(rng, op, naive_op):
    regs = regimes(rng)
    fn = getattr(bitplane, op)
    for na, a in regs.items():
        for nb, b in regs.items():
            got = set_of(fn(dev(a), dev(b)))
            assert got == naive_op(a, b), f"{op} failed for {na} x {nb}"


def test_popcount(rng):
    for name, cols in regimes(rng).items():
        got = bitplane.popcount(dev(cols))
        assert got.dtype == torch.int64
        assert int(got) == len(cols), name


def test_popcount_rows(rng):
    sets = list(regimes(rng).values())
    stack = bitplane.to_device(np.stack([plane_of(s) for s in sets]), "cpu")
    got = bitplane.popcount_rows(stack)
    assert got.tolist() == [len(s) for s in sets]


@pytest.mark.parametrize("n", [1, 7, 32, 33, 100, 65536])
def test_shift(rng, n):
    cols = random_cols(rng, 5000)
    got = set_of(bitplane.shift(dev(cols), n))
    assert got == {c + n for c in cols if c + n < SHARD_WIDTH}


def test_plane_from_columns_roundtrip(rng):
    cols = sorted(random_cols(rng, 10_000))
    plane = bitplane.plane_from_columns(cols)
    assert set_of(plane) == set(cols)
    assert list(bitplane.columns_from_plane(plane)) == cols
