"""Differential tests of the port's BSI ops (pilosa_tpu_torch.ops.bsi and
K5's plain version, pilosa_tpu_torch.ops.bsi_range) against the TPU
package: the Pallas `bsi_range_mask` run in interpret mode (as
tests/test_pallas.py runs it on the CPU), the jnp range ops
`ops.bsi._range_{eq,lt,gt}_jnp`, and the jnp comparator, between, Sum
counts and Min/Max walks. Inputs come from numpy seeds, with edge words
and columns equal to the predicate planted. Tolerance: exact equality
(every result is a bit mask or an integer).

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.ops import bsi as jax_bsi  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.shardwidth import WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.ops import bsi  # noqa: E402
from pilosa_tpu_torch.ops import bsi_range as k5  # noqa: E402

EDGE_WORDS = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000001, 0],
                      dtype=np.uint32)
# (op, allow_eq): the combinations tests/test_pallas.py covers
OP_CASES = [("eq", False), ("lt", False), ("lt", True), ("gt", False),
            ("gt", True)]
DEPTHS = [1, 13, 21, 40, 64]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


def _bsi_inputs(rng, depth, pred, shape=(WORDS_PER_ROW,)):
    """Random planes, sign and exists with edge words, and a run of words
    whose columns all hold the predicate's magnitude (so eq is exercised)."""
    planes = rng.integers(0, 1 << 32, (depth, *shape), dtype=np.uint32)
    sign = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    exists = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    flat = planes.reshape(depth, -1)
    flat[:, :len(EDGE_WORDS)] = EDGE_WORDS
    for d in range(depth):
        flat[d, 8:40] = 0xFFFFFFFF if (pred >> d) & 1 else 0
    sign.reshape(-1)[8:24] = 0
    sign.reshape(-1)[24:40] = 0xFFFFFFFF
    exists.reshape(-1)[8:40] = 0xFFFFFFFF
    return planes, sign, exists


def _jnp_range(op, planes, sign, exists, pbits, neg_pred, allow_eq):
    if op == "eq":
        return jax_bsi._range_eq_jnp(planes, sign, exists, pbits, neg_pred)
    fn = jax_bsi._range_lt_jnp if op == "lt" else jax_bsi._range_gt_jnp
    return fn(planes, sign, exists, pbits, neg_pred, allow_eq)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("neg_pred", [False, True])
@pytest.mark.parametrize("op,allow_eq", OP_CASES)
def test_plain_k5_matches_pallas_and_jnp(op, allow_eq, neg_pred, depth):
    rng = np.random.default_rng(depth * 10 + len(op) + allow_eq)
    pred = int.from_bytes(rng.bytes(8), "little") & ((1 << depth) - 1)
    planes, sign, exists = _bsi_inputs(rng, depth, pred)
    pbits = bsi.predicate_bits(pred, depth)
    got = _u(k5.bsi_range_mask(op, _t(planes), _t(sign), _t(exists), pbits,
                               neg_pred, allow_eq))
    want = np.asarray(pk.bsi_range_mask(op, planes, sign, exists, pbits,
                                        neg_pred, allow_eq))
    assert np.array_equal(got, want)
    jnp_want = np.asarray(_jnp_range(op, planes, sign, exists, pbits,
                                     neg_pred, allow_eq))
    assert np.array_equal(got, jnp_want)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("which", ["zero", "all_ones"])
def test_plain_k5_extreme_predicates(depth, which):
    """Predicates 0 and 2^D - 1, every op and sign, against the jnp ops."""
    pred = 0 if which == "zero" else (1 << depth) - 1
    rng = np.random.default_rng(depth)
    planes, sign, exists = _bsi_inputs(rng, depth, pred, shape=(512,))
    pbits = bsi.predicate_bits(pred, depth)
    for op, allow_eq in OP_CASES:
        for neg_pred in (False, True):
            got = _u(bsi.range_eq(_t(planes), _t(sign), _t(exists), pbits,
                                  neg_pred) if op == "eq" else
                     (bsi.range_lt if op == "lt" else bsi.range_gt)(
                         _t(planes), _t(sign), _t(exists), pbits, neg_pred,
                         allow_eq))
            want = np.asarray(_jnp_range(op, planes, sign, exists, pbits,
                                         neg_pred, allow_eq))
            assert np.array_equal(got, want), (op, allow_eq, neg_pred)


@pytest.mark.parametrize("op,allow_eq", OP_CASES)
def test_stacked_view_equals_per_shard(op, allow_eq):
    """A [D, S, W] stacked view in one call equals S per-shard calls."""
    depth, s = 21, 3
    rng = np.random.default_rng(7)
    pred = int(rng.integers(0, 1 << depth))
    planes, sign, exists = _bsi_inputs(rng, depth, pred,
                                       shape=(s, WORDS_PER_ROW))
    pbits = bsi.predicate_bits(pred, depth)
    whole = _u(k5.bsi_range_mask(op, _t(planes), _t(sign), _t(exists),
                                 pbits, False, allow_eq))
    assert whole.shape == (s, WORDS_PER_ROW)
    for j in range(s):
        one = _u(k5.bsi_range_mask(op, _t(planes[:, j]), _t(sign[j]),
                                   _t(exists[j]), pbits, False, allow_eq))
        assert np.array_equal(whole[j], one), j


@pytest.mark.parametrize("depth", [1, 21, 64])
def test_compare_unsigned_matches_jax(depth):
    rng = np.random.default_rng(depth + 1)
    pred = int.from_bytes(rng.bytes(8), "little") & ((1 << depth) - 1)
    planes, _, _ = _bsi_inputs(rng, depth, pred, shape=(2, 1024))
    pbits = bsi.predicate_bits(pred, depth)
    got = bsi.compare_unsigned(_t(planes), pbits)
    want = jax_bsi.compare_unsigned(planes, pbits)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w))


@pytest.mark.parametrize("lo,hi", [(0, 5), (3, 3), (17, 900), (900, 17)])
def test_range_between_unsigned_matches_jax(lo, hi):
    depth = 10
    rng = np.random.default_rng(lo + hi)
    planes, _, _ = _bsi_inputs(rng, depth, lo, shape=(2048,))
    filt = rng.integers(0, 1 << 32, 2048, dtype=np.uint32)
    lo_bits = bsi.predicate_bits(lo, depth)
    hi_bits = bsi.predicate_bits(hi, depth)
    got = bsi.range_between_unsigned(_t(planes), _t(filt), lo_bits, hi_bits)
    want = jax_bsi.range_between_unsigned(planes, filt, lo_bits, hi_bits)
    assert np.array_equal(_u(got), np.asarray(want))


@pytest.mark.parametrize("depth", [1, 21, 40])
@pytest.mark.parametrize("shape", [(WORDS_PER_ROW,), (3, WORDS_PER_ROW)])
def test_bsi_plane_counts_matches_jax(depth, shape):
    """Sum's per-plane counts through K3's plain version, on one shard
    and on the stacked [D, S, W] view."""
    rng = np.random.default_rng(depth)
    planes, sign, exists = _bsi_inputs(rng, depth, 0, shape=shape)
    filt = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    pos, neg, cnt = bsi.bsi_plane_counts(_t(planes), _t(sign), _t(exists),
                                         _t(filt))
    flat = (planes.reshape(depth, -1), sign.reshape(-1), exists.reshape(-1),
            filt.reshape(-1))
    wp, wn, wc = jax_bsi.bsi_plane_counts(*flat)
    assert pos.tolist() == np.asarray(wp).tolist()
    assert neg.tolist() == np.asarray(wn).tolist()
    assert int(cnt) == int(wc)
    ones = np.full(flat[1].shape, 0xFFFFFFFF, dtype=np.uint32)
    _, _, all_cnt = bsi.bsi_plane_counts(_t(planes), _t(sign), _t(exists))
    assert int(all_cnt) == int(jax_bsi.bsi_plane_counts(*flat[:3], ones)[2])


@pytest.mark.parametrize("fn", ["max_unsigned", "min_unsigned"])
@pytest.mark.parametrize("density", ["dense", "sparse", "empty"])
def test_narrowing_walks_match_jax(fn, density):
    depth = 21
    rng = np.random.default_rng(len(fn) + len(density))
    planes = rng.integers(0, 1 << 32, (depth, 2, 2048), dtype=np.uint32)
    filt = np.zeros((2, 2048), dtype=np.uint32)
    if density == "dense":
        filt = rng.integers(0, 1 << 32, (2, 2048), dtype=np.uint32)
    elif density == "sparse":
        filt[1, 77] = 0x00010000
        filt[0, 5] = 0x80000001
    bits, final = getattr(bsi, fn)(_t(planes), _t(filt))
    wbits, wfinal = getattr(jax_bsi, fn)(planes, filt)
    assert bits.dtype == torch.int32
    assert bits.tolist() == np.asarray(wbits).tolist()
    assert np.array_equal(_u(final), np.asarray(wfinal))


def test_predicate_bits_matches_jax_and_raises_when_over_wide():
    for value, depth in ((0, 1), (1, 1), (5, 3), ((1 << 64) - 1, 64)):
        assert bsi.predicate_bits(value, depth).tolist() == \
            jax_bsi.predicate_bits(value, depth).tolist()
    with pytest.raises(ValueError, match="caller must clamp"):
        bsi.predicate_bits(8, 3)
    with pytest.raises(ValueError):
        jax_bsi.predicate_bits(8, 3)


def test_wrapper_rejects_bad_inputs():
    planes = torch.zeros((3, 8), dtype=torch.int32)
    row = torch.zeros(8, dtype=torch.int32)
    pbits = [0, 1, 0]
    with pytest.raises(ValueError, match="unknown BSI range op"):
        k5.bsi_range_mask("lte", planes, row, row, pbits, False, True)
    with pytest.raises(ValueError, match="depth 0"):
        k5.bsi_range_mask("lt", planes[:0], row, row, [], False, True)
    with pytest.raises(ValueError, match="depth 65"):
        k5.bsi_range_mask("lt", torch.zeros((65, 8), dtype=torch.int32),
                          row, row, [0] * 65, False, True)
    with pytest.raises(ValueError, match="predicate bits"):
        k5.bsi_range_mask("lt", planes, row, row, [1], False, True)
    with pytest.raises(ValueError, match="not 0 or 1"):
        k5.bsi_range_mask("lt", planes, row, row, [0, 2, 0], False, True)
    with pytest.raises(ValueError, match="shaped like one plane"):
        k5.bsi_range_mask("lt", planes, row[:4], row, pbits, False, True)
    with pytest.raises(TypeError, match="dtype"):
        k5.bsi_range_mask("lt", planes.long(), row, row, pbits, False, True)
    assert k5.bsi_range_mask.launches == 0  # CPU tensors never launch
