"""Differential tests of K4's plain version (pilosa_tpu_torch.ops.pairwise)
against the TPU package: the Pallas `pairwise_counts_stack` run in
interpret mode (as tests/test_pallas.py runs it on the CPU), the jnp
tile function `bitplane.pairwise_counts_hi_lo`, and the tiled host
`bitplane.pairwise_counts` against the port's served tiling loop
(`StackedEvaluator.pairwise_counts`).
Inputs come from numpy seeds; row counts are ragged (not multiples of 8,
16 or 128), the words carry the edge values, and empty sides are
covered. Tolerance: exact equality.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.ops import bitplane as jax_bp  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.shardwidth import WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.exec import stacked as port_stacked  # noqa: E402
from pilosa_tpu_torch.ops import pairwise as k4  # noqa: E402

EDGE_WORDS = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000001, 0],
                      dtype=np.uint32)


def _stacks(rng, r, s):
    x = rng.integers(0, 1 << 32, (r, s, WORDS_PER_ROW), dtype=np.uint32)
    if r:
        x[:, :, :len(EDGE_WORDS)] = EDGE_WORDS
        x[r // 2, :, 9:2000] = 0
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _naive(a, b, filt=None):
    r1, r2 = a.shape[0], b.shape[0]
    a2, b2 = a.reshape(r1, -1), b.reshape(r2, -1)
    if filt is not None:
        a2 = a2 & filt.reshape(1, -1)
    out = np.zeros((r1, r2), dtype=np.int64)
    for i in range(r1):
        out[i] = np.bitwise_count(a2[i][None, :] & b2).sum(
            axis=-1, dtype=np.int64)
    return out


@pytest.mark.parametrize("r1,r2", [(1, 1), (5, 4), (8, 8), (3, 7), (1, 8),
                                   (9, 5), (13, 130)])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("has_filt", [False, True])
def test_plain_k4_matches_pallas_interpret(r1, r2, s, has_filt):
    rng = np.random.default_rng(r1 * 1000 + r2 * 10 + s)
    a, b = _stacks(rng, r1, s), _stacks(rng, r2, s)
    filt = rng.integers(0, 1 << 32, (s, WORDS_PER_ROW), dtype=np.uint32) \
        if has_filt else None
    want = np.asarray(pk.pairwise_counts_stack(a, b, filt))
    got = k4.pairwise_counts_stack(_t(a), _t(b),
                                   None if filt is None else _t(filt))
    assert got.dtype == torch.int64
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == _naive(a, b, filt).tolist()


@pytest.mark.parametrize("r1,r2", [(0, 3), (3, 0), (0, 0)])
def test_empty_side_returns_zeros(r1, r2):
    rng = np.random.default_rng(1)
    a, b = _stacks(rng, r1, 1), _stacks(rng, r2, 1)
    want = np.asarray(pk.pairwise_counts_stack(a, b))
    got = k4.pairwise_counts_stack(_t(a), _t(b))
    assert tuple(got.shape) == want.shape == (r1, r2)
    assert got.dtype == torch.int64 and not got.any()


def test_tile_matches_jax_hi_lo():
    """The port's device tile function (`pairwise_counts_stack`, what the
    served path launches per tile pair) against the TPU package's
    (hi, lo) tile function, recombined."""
    rng = np.random.default_rng(2)
    a, b = _stacks(rng, 6, 3), _stacks(rng, 7, 3)
    filt = rng.integers(0, 1 << 32, (3, WORDS_PER_ROW), dtype=np.uint32)
    for f in (None, filt):
        want = jax_bp.combine_hi_lo(*jax_bp.pairwise_counts_hi_lo(a, b, f))
        got = k4.pairwise_counts_stack(
            _t(a), _t(b), None if f is None else _t(f))
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("tile", [None, 2, 3])
def test_tiled_host_matrix_matches_jax(tile, monkeypatch):
    """The served tiling loop, with CHUNK_BYTES cut to `tile` rows, gives
    the TPU package's tiled host matrix (its nonzero entries) and
    launches one tile pair per (A-tile, B-tile)."""
    rng = np.random.default_rng(3)
    s = 2
    a, b = _stacks(rng, 7, s), _stacks(rng, 6, s)
    filt = rng.integers(0, 1 << 32, (s, WORDS_PER_ROW), dtype=np.uint32)
    want = jax_bp.pairwise_counts(a, b, filt, tile=tile)
    if tile is not None:
        monkeypatch.setattr(port_stacked, "CHUNK_BYTES",
                            tile * s * WORDS_PER_ROW * 4)
    ev = port_stacked.StackedEvaluator("cpu")
    planes = {"a": _t(a), "b": _t(b)}
    monkeypatch.setattr(
        ev, "rows_stack", lambda idx, field, chunk, shards, view_name,
        cache: planes[field][list(chunk)])
    got = ev.pairwise_counts(None, "a", list(range(7)), "b", list(range(6)),
                             _t(filt), tuple(range(s)))
    assert got == {(int(i), int(j)): int(want[i, j])
                   for i, j in zip(*np.nonzero(want))}
    t = tile or 7
    assert ev.pairwise_dispatches == -(-7 // t) * -(-6 // t)


def test_pairwise_tile_budget_matches_jax():
    """The served tile (rows per [R, S, W] chunk) is the TPU package's
    host pairwise tile at every shard count."""
    ev = port_stacked.StackedEvaluator("cpu")
    for s in (1, 10, 954, 5000):
        assert ev.row_chunk_size(tuple(range(s))) == jax_bp.pairwise_tile(s)
    assert port_stacked.CHUNK_BYTES == jax_bp.PAIRWISE_TILE_BYTES


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x55555555])
def test_edge_words_exact(word):
    a = np.full((2, 1, WORDS_PER_ROW), word, dtype=np.uint32)
    b = np.full((3, 1, WORDS_PER_ROW), 0xFFFFFFFF, dtype=np.uint32)
    want = np.asarray(pk.pairwise_counts_stack(a, b))
    assert (want == WORDS_PER_ROW * bin(word).count("1")).all()
    assert k4.pairwise_counts_stack(_t(a), _t(b)).tolist() == want.tolist()


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        k4.pairwise_counts(a, a.to(torch.int64))
    with pytest.raises(ValueError, match="words per row"):
        k4.pairwise_counts(a, a[:, :4])
    with pytest.raises(ValueError, match="filter shape"):
        k4.pairwise_counts(a, a, torch.zeros(3, dtype=torch.int32))
    assert k4.pairwise_counts.launches == 0  # CPU tensors never launch
