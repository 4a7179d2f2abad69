"""Plane algebra over dense row planes, in PyTorch.

A "plane" is one row of one shard: SHARD_WIDTH bits packed little-endian
into uint32 words, held as an int32 tensor of shape [WORDS_PER_ROW] (the
bit patterns are the uint32 words'). A "stack" is [R, WORDS_PER_ROW].

These serve the per-shard fallback of Count and the bitmap calls, and
`shift` serves Shift on both routes: a plane [W] per shard, or a stack
[S, W] whose rows shift each within its own shard. Counts
are exact int64 totals (the TPU package split them into hi/lo int32
halves because its device ran without 64-bit integers).
"""

import numpy as np
import torch

from ..shardwidth import SHARD_WIDTH, WORD_BITS, WORDS_PER_ROW
from .count_expr import popcount_total, popcount_words

__all__ = [
    "intersect",
    "union",
    "difference",
    "xor",
    "popcount",
    "popcount_rows",
    "shift",
    "plane_from_columns",
    "columns_from_plane",
    "to_device",
    "to_host",
]


def intersect(a, b):
    return a & b


def union(a, b):
    return a | b


def difference(a, b):
    return a & ~b


def xor(a, b):
    return a ^ b


def shift(a, n=1):
    """Shift every plane of `a` ([W] or [S, W]) toward higher column ids
    by n bits (reference: Row.Shift row.go:241). Each row is one shard:
    bits shifted past its last column are dropped, never carried into
    the next shard (the TPU package's per-shard semantics), so n of a
    shard width or more gives an empty plane. int32 `>>` sign-extends,
    so the carry is masked after the shift."""
    n = int(n)
    if n < 0:
        raise ValueError(
            "shift supports non-negative n only (toward higher columns)")
    if n == 0:
        return a
    width = a.shape[-1]
    word_shift, bit_shift = divmod(n, WORD_BITS)
    out = torch.zeros_like(a)
    if word_shift >= width:
        return out
    out[..., word_shift:] = a[..., :width - word_shift]
    if bit_shift:
        carry = torch.zeros_like(out)
        carry[..., 1:] = (out[..., :-1] >> (WORD_BITS - bit_shift)) \
            & ((1 << bit_shift) - 1)
        out = (out << bit_shift) | carry
    return out


def popcount(a):
    """Exact number of set bits in a plane or stack (0-d int64 tensor)."""
    return popcount_total(a)


def popcount_rows(stack):
    """Per-row popcount over a stack [R, W] -> [R] int64."""
    return popcount_words(stack).sum(dim=-1, dtype=torch.int64)


def to_device(words, device):
    """Upload host uint32 words as an int32 tensor on `device` (a
    reinterpreting view on the host, one copy to the device)."""
    host = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(host).to(device)


def to_host(plane):
    """Host uint32 words of an int32 plane tensor."""
    return plane.detach().cpu().numpy().view(np.uint32)


def plane_from_columns(cols):
    """Host helper: a [WORDS_PER_ROW] uint32 plane from shard-relative
    column offsets. Offsets must already be shard-relative — a value
    >= SHARD_WIDTH means the caller forgot to subtract the shard base."""
    from .. import native

    cols = np.asarray(cols, dtype=np.uint64)
    if cols.size and int(cols.max()) >= SHARD_WIDTH:
        raise ValueError(
            f"column offset {int(cols.max())} >= shard width {SHARD_WIDTH}")
    plane = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
    native.scatter(cols, plane)
    return plane


def columns_from_plane(plane):
    """Host helper: shard-relative column offsets of set bits, sorted."""
    from .. import native

    return native.extract(np.asarray(plane, dtype=np.uint32))
