"""BSI (bit-sliced index) ops.

The reference stores integer values sign-magnitude across bit-plane rows
of a `bsig_<field>` view: row 0 = existence, row 1 = sign, row 2+i =
magnitude bit i (reference: fragment.go:91-93, value/setValue
fragment.go:896-1000). Range queries are bit-plane scans (reference:
rangeEQ/rangeLT/rangeGT/rangeLTUnsigned fragment.go:1292-1470); Sum,
Min and Max walk the planes (fragment.go:1068-1227).

Layout here: `planes` is a [D, ...] int32 stack, planes[i] = magnitude bit
i (LSB first); `sign`, `exists` and filters are shaped like one plane —
[W] for one shard, [S, W] for the stacked path. Predicates arrive as a
[D] 0/1 vector of magnitude bits built on the host.

- `range_eq`, `range_lt`, `range_gt`: one launch of K5
  (ops/bsi_range.py) each.
- `bsi_plane_counts`: per-plane popcounts for Sum, three launches of K3
  (ops/row_counts.py) over the [D, T] plane view.
- `compare_unsigned`, `range_between_unsigned`, `max_unsigned`,
  `min_unsigned`: PyTorch elementwise ops (in the TPU package, XLA).
"""

import numpy as np
import torch

from .bsi_range import bsi_range_mask, compare_planes, predicate_value
from .row_counts import row_counts

__all__ = [
    "predicate_bits",
    "compare_unsigned",
    "range_eq",
    "range_lt",
    "range_gt",
    "range_between_unsigned",
    "bsi_plane_counts",
    "max_unsigned",
    "min_unsigned",
]


def predicate_bits(upredicate, depth):
    """Host helper: magnitude bits of an unsigned predicate as a [depth]
    uint32 0/1 vector (LSB first).

    Raises ValueError when the predicate doesn't fit in `depth` bits: the
    correct result then depends on the comparison operator (everything is LT
    an over-wide predicate, nothing is EQ/GT it), so the executor must clamp
    BEFORE building bits (see exec layer rangeOp handling)."""
    if int(upredicate) >> depth:
        raise ValueError(
            f"predicate magnitude {upredicate} does not fit in bitDepth {depth}; "
            "caller must clamp")
    return np.array(
        [(int(upredicate) >> i) & 1 for i in range(depth)], dtype=np.uint32
    )


def compare_unsigned(planes, pbits):
    """(lt, eq, gt) masks of per-column magnitudes against the predicate,
    each shaped like one plane (reference: rangeLTUnsigned /
    rangeGTUnsigned / rangeEQ fragment.go:1357-1470, computed at once)."""
    return compare_planes(planes, predicate_value(pbits))


def range_eq(planes, sign, exists, pbits, neg_predicate):
    """Columns whose signed value == predicate (reference: rangeEQ
    fragment.go:1292)."""
    return bsi_range_mask("eq", planes, sign, exists, pbits, neg_predicate,
                          False)


def range_lt(planes, sign, exists, pbits, neg_predicate, allow_eq):
    """Columns whose signed value < predicate (<= when allow_eq).

    Sign-magnitude semantics (reference: rangeLT fragment.go:1335):
      pred >= 0: all negatives qualify; positives compare magnitudes.
      pred <  0: only negatives, with magnitude > |pred| (reversed order).
    """
    return bsi_range_mask("lt", planes, sign, exists, pbits, neg_predicate,
                          allow_eq)


def range_gt(planes, sign, exists, pbits, neg_predicate, allow_eq):
    """Columns whose signed value > predicate (>= when allow_eq).
    Mirror of range_lt (reference: rangeGT fragment.go:1403)."""
    return bsi_range_mask("gt", planes, sign, exists, pbits, neg_predicate,
                          allow_eq)


def range_between_unsigned(planes, filter_plane, lo_bits, hi_bits):
    """filter ∩ {lo <= value <= hi} on magnitudes only (reference:
    rangeBetweenUnsigned fragment.go:1489; the executor handles sign
    split)."""
    lt_lo, _, _ = compare_unsigned(planes, lo_bits)
    lt_hi, eq_hi, _ = compare_unsigned(planes, hi_bits)
    return filter_plane & ~lt_lo & (lt_hi | eq_hi)


def bsi_plane_counts(planes, sign, exists, filter_plane=None):
    """Per-plane popcounts for Sum (reference: fragment.sum
    fragment.go:1068).

    Returns (pos_counts [D], neg_counts [D], count) as int64 tensors on the
    planes' device: the host computes sum = Σ 2^i·pos[i] − Σ 2^i·neg[i] in
    Python ints. No filter counts every existing column."""
    consider = exists if filter_plane is None else exists & filter_plane
    pos = consider & ~sign
    neg = consider & sign
    flat = planes.reshape(planes.shape[0], -1)
    pos_counts = row_counts(flat, pos.reshape(-1))
    neg_counts = row_counts(flat, neg.reshape(-1))
    count = row_counts(consider.reshape(1, -1))[0]
    return pos_counts, neg_counts, count


def _narrow(planes, filter_plane, keep_set):
    """The MSB-down narrowing walk shared by max and min: at each plane,
    keep the columns whose bit is `keep_set` when any remain. Selection
    is by 0-d device tensors, so the walk never waits on the device."""
    filt = filter_plane
    found = []
    for d in range(planes.shape[0] - 1, -1, -1):
        cand = filt & planes[d] if keep_set else filt & ~planes[d]
        nonzero = cand.any()
        filt = torch.where(nonzero, cand, filt)
        found.append(nonzero)
    return torch.stack(found[::-1]), filt


def max_unsigned(planes, filter_plane):
    """(max magnitude, columns achieving it) under filter — MSB-down
    narrowing walk (reference: maxUnsigned fragment.go:1139).

    Returns (bits [D] int32, LSB first, final filter plane)."""
    found, final = _narrow(planes, filter_plane, True)
    return found.to(torch.int32), final


def min_unsigned(planes, filter_plane):
    """(min magnitude, columns achieving it) under filter (reference:
    minUnsigned fragment.go:1110): a bit is in the min when no column can
    keep it clear."""
    found, final = _narrow(planes, filter_plane, False)
    return (~found).to(torch.int32), final
