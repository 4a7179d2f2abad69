"""Differential tests of K3's plain version (pilosa_tpu_torch.ops.row_counts)
against the TPU package: the Pallas `topn_counts_stack` run in interpret
mode (as tests/test_pallas.py runs it on the CPU), its jnp counterpart
`bitplane.topn_counts`, and numpy over flattened multi-shard chunks.
Inputs come from numpy seeds; row counts are ragged (not multiples of 8,
16 or 128) and carry the edge words. Tolerance: exact equality, the
order of tied counts included.

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
from pilosa_tpu_torch.ops import cuda_build  # noqa: E402
from pilosa_tpu_torch.ops import row_counts as k3  # noqa: E402

EDGE_WORDS = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000001, 0],
                      dtype=np.uint32)


def _rows(rng, r, words=WORDS_PER_ROW):
    x = rng.integers(0, 1 << 32, (r, words), dtype=np.uint32)
    if r:
        x[:, :len(EDGE_WORDS)] = EDGE_WORDS
        x[r // 2, -1] = 0x80000000
        x[r // 2, 7:4096] = 0  # one much sparser row
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _numpy_counts(rows, filt):
    x = rows if filt is None else rows & filt[None, :]
    return np.bitwise_count(x).sum(axis=-1, dtype=np.int64)


@pytest.mark.parametrize("r", [1, 5, 17, 37])
@pytest.mark.parametrize("k", [1, 5, "all"])
def test_topn_matches_pallas_interpret(r, k):
    rng = np.random.default_rng(r)
    rows = _rows(rng, r)
    filt = rng.integers(0, 1 << 32, WORDS_PER_ROW, dtype=np.uint32)
    filt[:2] = [0xFFFFFFFF, 0x80000000]
    k = r if k == "all" else min(k, r)
    want_v, want_i = pk.topn_counts_stack(rows, filt, k)
    got_v, got_i = k3.topn_counts_stack(_t(rows), _t(filt), k)
    assert got_v.dtype == torch.int64 and got_i.dtype == torch.int64
    assert got_v.tolist() == np.asarray(want_v).tolist()
    assert got_i.tolist() == np.asarray(want_i).tolist()


@pytest.mark.parametrize("r", [3, 20])
def test_ties_go_to_lowest_index(r):
    """Duplicated rows give equal counts; both packages list them in
    ascending row order."""
    rng = np.random.default_rng(100 + r)
    base = _rows(rng, 2)
    rows = base[rng.integers(0, 2, size=r)]
    filt = np.full(WORDS_PER_ROW, 0xFFFFFFFF, dtype=np.uint32)
    want_v, want_i = pk.topn_counts_stack(rows, filt, r)
    got_v, got_i = k3.topn_counts_stack(_t(rows), _t(filt), r)
    assert got_v.tolist() == np.asarray(want_v).tolist()
    assert got_i.tolist() == np.asarray(want_i).tolist()
    # and the jnp path of the TPU package agrees
    jv, ji = jax_bp.topn_counts(rows, filt, r)
    assert got_i.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("r,s", [(1, 1), (7, 3), (19, 2)])
@pytest.mark.parametrize("has_filt", [True, False])
def test_row_counts_over_flat_chunks(r, s, has_filt):
    """[R, S, W] chunks viewed flat as [R, S·W]: the stacked TopN's
    shape."""
    rng = np.random.default_rng(10 * r + s)
    rows = _rows(rng, r, s * WORDS_PER_ROW)
    filt = rng.integers(0, 1 << 32, s * WORDS_PER_ROW, dtype=np.uint32) \
        if has_filt else None
    got = k3.row_counts(_t(rows), None if filt is None else _t(filt))
    assert got.tolist() == _numpy_counts(rows, filt).tolist()
    if s == 1:
        # unfiltered equals Pallas with an all-ones filter
        ones = np.full(WORDS_PER_ROW, 0xFFFFFFFF, dtype=np.uint32)
        f = ones if filt is None else filt
        want_v, want_i = pk.topn_counts_stack(rows, f, r)
        counts = np.zeros(r, dtype=np.int64)
        counts[np.asarray(want_i)] = np.asarray(want_v)
        assert got.tolist() == counts.tolist()


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x55555555, 1])
def test_edge_words_exact(word):
    rows = np.full((3, WORDS_PER_ROW), word, dtype=np.uint32)
    filt = np.full(WORDS_PER_ROW, 0xFFFFFFFF, dtype=np.uint32)
    want_v, _ = pk.topn_counts_stack(rows, filt, 3)
    assert np.asarray(want_v).tolist() == \
        [WORDS_PER_ROW * bin(word).count("1")] * 3
    assert k3.row_counts(_t(rows)).tolist() == np.asarray(want_v).tolist()


def test_empty_stack_returns_zeros():
    empty = np.zeros((0, WORDS_PER_ROW), dtype=np.uint32)
    filt = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
    want_v, want_i = pk.topn_counts_stack(empty, filt, 4)
    got_v, got_i = k3.topn_counts_stack(_t(empty), _t(filt), 4)
    assert got_v.tolist() == np.asarray(want_v).tolist() == [0] * 4
    assert got_i.tolist() == np.asarray(want_i).tolist()
    assert k3.row_counts(_t(empty)).shape == (0,)


def test_bitplane_topn_counts_matches_jax():
    """The port's top-k (`topn_counts_stack`) against the TPU package's
    jnp `bitplane.topn_counts`."""
    rng = np.random.default_rng(4)
    rows = _rows(rng, 11)
    filt = rng.integers(0, 1 << 32, WORDS_PER_ROW, dtype=np.uint32)
    jv, ji = jax_bp.topn_counts(rows, filt, 6)
    pv, pi = k3.topn_counts_stack(_t(rows), _t(filt), 6)
    assert pv.tolist() == np.asarray(jv).tolist()
    assert pi.tolist() == np.asarray(ji).tolist()


def test_k_past_rows_raises_like_reference():
    rows = np.ones((3, WORDS_PER_ROW), dtype=np.uint32)
    with pytest.raises(ValueError):
        pk.topn_counts_stack(rows, rows[0], 5)
    with pytest.raises(ValueError, match="k = 5 > 3"):
        k3.topn_counts_stack(_t(rows), _t(rows[0]), 5)


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        k3.row_counts(a.to(torch.int64))
    with pytest.raises(ValueError, match=r"\[R, T\]"):
        k3.row_counts(a[0])
    with pytest.raises(ValueError, match="filter shape"):
        k3.row_counts(a, torch.zeros(4, dtype=torch.int32))
    assert k3.row_counts.launches == 0  # CPU tensors never launch


def test_launch_counter_counts_every_concurrent_launch():
    """Wrappers are called from pool threads; no launch may be lost."""
    import threading

    def fake():
        pass

    fake.launches = 0

    def bump():
        for _ in range(20_000):
            cuda_build.count_launch(fake)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fake.launches == 8 * 20_000
