"""K3: per-row filtered popcounts over [R, T] row stacks.

`row_counts(rows, filt)` is out[r] = Σ_w popcount(rows[r, w] & filt[w]),
exact int64, for rows [R, T] int32 words and an optional filter [T]. A
[R, S, W] row chunk is passed viewed flat (T = S·W, contiguous). With
S = 1 this is the body of the TPU kernel it replaces, `topn_counts_stack`
(pilosa_tpu/ops/pallas_kernels.py:515, body :260); the TPU package's
stacked TopN and single-field GroupBy count exactly this over row chunks
(pilosa_tpu/exec/stacked.py:1784-1801) in an XLA fusion, and the port
routes them through the same kernel.

`row_counts` is the wrapper: a CPU tensor goes to the plain version
`row_counts_reference`; a CUDA tensor goes to the hand-written kernel
`csrc/row_counts.cu` (see that file for its design and bound) or raises.
An empty stack returns zeros without a launch.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .count_expr import popcount_words

__all__ = [
    "row_counts",
    "row_counts_cost",
    "row_counts_reference",
    "topn_counts_stack",
]


def _check(rows, filt):
    if not isinstance(rows, torch.Tensor):
        raise TypeError(f"rows must be a tensor, got {type(rows)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows dtype {rows.dtype} != torch.int32")
    if rows.dim() != 2:
        raise ValueError(f"rows must be [R, T], got {tuple(rows.shape)}")
    if filt is not None:
        if filt.dtype != torch.int32:
            raise TypeError(f"filter dtype {filt.dtype} != torch.int32")
        if filt.shape != (rows.shape[1],):
            raise ValueError(
                f"filter shape {tuple(filt.shape)} != ({rows.shape[1]},)")
        if filt.device != rows.device:
            raise ValueError("rows and filter lie on different devices")


def row_counts_reference(rows, filt=None):
    """The plain version of K3: mask, SWAR popcount, int64 row sums."""
    _check(rows, filt)
    x = rows if filt is None else rows & filt[None, :]
    return popcount_words(x).sum(dim=-1, dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/row_counts.cu (built at first use)."""
    fn = cuda_build.load("row_counts").row_counts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch(rows, filt):
    fn = _kernel_fn()
    for t in (rows,) if filt is None else (rows, filt):
        if not t.is_contiguous():
            raise ValueError("row_counts inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("row_counts inputs must be 16-byte aligned")
    n_rows, n_words = rows.shape
    if n_words % 4:
        raise ValueError("words per row must be a multiple of 4")
    if n_rows > 2**31 - 1:
        raise ValueError(f"{n_rows} rows exceed the kernel's int range")
    out = torch.empty((n_rows,), dtype=torch.int64, device=rows.device)
    with cuda_build.on_card(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), None if filt is None else filt.data_ptr(),
                 n_rows, n_words, out.data_ptr(), stream)
    if err != 0:
        raise cuda_build.launch_error("row_counts", rows.device, err)
    cuda_build.count_launch(row_counts)
    return out


def row_counts(rows, filt=None):
    """Exact int64 [R] tensor of Σ popcount(rows[r] & filt) on the rows'
    device. CPU tensors take the plain version; CUDA tensors launch K3
    (an empty stack returns zeros without a launch)."""
    _check(rows, filt)
    dev = rows.device
    if dev.type == "cpu":
        return row_counts_reference(rows, filt)
    if dev.type != "cuda":
        raise ValueError(f"row_counts: unsupported device {dev}")
    if rows.shape[0] == 0 or rows.shape[1] == 0:
        return torch.zeros((rows.shape[0],), dtype=torch.int64, device=dev)
    return _launch(rows, filt)


#: K3 launches since the last reset (read by chip_smoke.py)
row_counts.launches = 0


def topn_counts_stack(rows, filter_plane, k):
    """`topn_counts_stack` of the TPU package: per-row popcount(row &
    filter) over rows [R, W] and filter [W], then the top k. Returns
    (vals [k], idx [k]) int64, equal counts in ascending row order (the
    order `jax.lax.top_k` gives: a stable descending sort, since
    `torch.topk`'s tie order is unspecified). Zero counts stay in;
    callers drop them. An empty stack returns k zeros of each."""
    n = int(rows.shape[0])
    if n == 0:
        z = torch.zeros((k,), dtype=torch.int64, device=rows.device)
        return z, z.clone()
    if k > n:
        raise ValueError(f"k = {k} > {n} rows")
    vals, idx = torch.sort(row_counts(rows, filter_plane), descending=True,
                           stable=True)
    return vals[:k], idx[:k]


def row_counts_cost(r, n_words, has_filter, device=None):
    """K3's declared cost over [R, N] rows (with an [N] filter when
    `has_filter`): every row and the filter read once, R int64 counts
    written (cuda_build.declared_cost)."""
    return cuda_build.declared_cost(
        (r + bool(has_filter)) * n_words * 4 + 8 * r, device)

