"""K4: pairwise intersect-count matrix over [R, T] row stacks.

`pairwise_counts(a, b, filt)` is out[i, j] = Σ_w popcount(a[i, w] &
filt[w] & b[j, w]), exact int64 [R1, R2], for a [R1, T] and b [R2, T]
int32 words and an optional filter [T] — the GroupBy cross product of
two fields' row chunks ([R, S, W] viewed flat, T = S·W). It replaces
the TPU kernel `pairwise_counts_stack`
(pilosa_tpu/ops/pallas_kernels.py:373, body :318-343).

`pairwise_counts` is the wrapper: a CPU tensor goes to the plain version
`pairwise_counts_reference`; a CUDA tensor goes to the hand-written
kernel `csrc/pairwise_counts.cu` (see that file for its design and its
bounds) or raises. An empty R1 or R2 returns zeros without a launch.
The kernel picks its path by shape alone: for R1, R2 <= 8 one
exact-shape kernel, which keeps its running sums, with the blocks
arrived, in a per-stream state of 64 int64, made zero once on that
stream and left zero by every launch (`_state`); past that a tiled
kernel on the tensor cores' 1-bit mma.
"""

import ctypes
import functools
import threading

import torch

from . import cuda_build
from .count_expr import popcount_words

__all__ = [
    "pairwise_cost",
    "pairwise_counts",
    "pairwise_counts_reference",
    "pairwise_counts_stack",
]


def _check(a, b, filt):
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype} != torch.int32")
        if t.dim() != 2:
            raise ValueError(f"{name} must be [R, T], got {tuple(t.shape)}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"a and b differ in words per row: {a.shape[1]} vs {b.shape[1]}")
    if b.device != a.device:
        raise ValueError("a and b lie on different devices")
    if filt is not None:
        if filt.dtype != torch.int32:
            raise TypeError(f"filter dtype {filt.dtype} != torch.int32")
        if filt.shape != (a.shape[1],):
            raise ValueError(
                f"filter shape {tuple(filt.shape)} != ({a.shape[1]},)")
        if filt.device != a.device:
            raise ValueError("a and filter lie on different devices")


def pairwise_counts_reference(a, b, filt=None):
    """The plain version of K4: per A row, mask against every B row, SWAR
    popcount and int64 row sums (one [R2, T] intermediate at a time)."""
    _check(a, b, filt)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return out
    af = a if filt is None else a & filt[None, :]
    for i in range(a.shape[0]):
        out[i] = popcount_words(af[i][None, :] & b).sum(
            dim=-1, dtype=torch.int64)
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/pairwise_counts.cu (built at first
    use)."""
    fn = cuda_build.load("pairwise_counts").pairwise_counts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


#: the small kernel's per-stream state (a running sum and the blocks
#: arrived per output), keyed (device index, stream handle)
_states = {}
_states_lock = threading.Lock()


def _state(stream):
    """The stream's 64-int64 state of the small kernel's reduction, made
    zero once on that stream; every launch leaves it zero. One per
    stream, so launches on two streams never share one."""
    key = (stream.device.index, stream.cuda_stream)
    t = _states.get(key)
    if t is None:
        with _states_lock, torch.cuda.stream(stream):
            t = _states.get(key)
            if t is None:
                t = _states[key] = torch.zeros(
                    64, dtype=torch.int64, device=stream.device)
    return t


def _launch(a, b, filt):
    fn = _kernel_fn()
    for t in (a, b) if filt is None else (a, b, filt):
        if not t.is_contiguous():
            raise ValueError("pairwise_counts inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("pairwise_counts inputs must be 16-byte aligned")
    n_a, n_words = a.shape
    n_b = b.shape[0]
    if n_words % 4:
        raise ValueError("words per row must be a multiple of 4")
    if max(n_a, n_b) > 2**31 - 1:
        raise ValueError("row counts exceed the kernel's int range")
    out = torch.empty((n_a, n_b), dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device)
    state = _state(stream)
    with cuda_build.on_card(a.device):
        err = fn(a.data_ptr(), n_a, b.data_ptr(), n_b,
                 None if filt is None else filt.data_ptr(), n_words,
                 out.data_ptr(), state.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise cuda_build.launch_error("pairwise_counts", a.device, err)
    cuda_build.count_launch(pairwise_counts)
    return out


def pairwise_counts(a, b, filt=None):
    """Exact int64 [R1, R2] tensor of Σ popcount(a[i] & filt & b[j]) on
    the inputs' device. CPU tensors take the plain version; CUDA tensors
    launch K4 (an empty side returns zeros without a launch)."""
    _check(a, b, filt)
    dev = a.device
    if dev.type == "cpu":
        return pairwise_counts_reference(a, b, filt)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_counts: unsupported device {dev}")
    if a.shape[0] == 0 or b.shape[0] == 0 or a.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                           device=dev)
    return _launch(a, b, filt)


#: K4 launches since the last reset (read by chip_smoke.py)
pairwise_counts.launches = 0


def pairwise_counts_stack(a, b, filt=None):
    """`pairwise_counts_stack` of the TPU package: the [R1, R2] count
    matrix of row stacks a [R1, S, W] and b [R2, S, W] (filt [S, W]
    optional), as exact int64 (the TPU kernel's was int32)."""
    r1, r2 = int(a.shape[0]), int(b.shape[0])
    t = int(a.shape[1]) * int(a.shape[2])
    return pairwise_counts(a.reshape(r1, t), b.reshape(r2, t),
                           None if filt is None else filt.reshape(t))


def pairwise_cost(r1, r2, t, has_filter, device=None):
    """K4's declared cost for [R1, T] and [R2, T] row stacks (and a [T]
    filter when `has_filter`): both stacks and the filter read once, the
    [R1, R2] int64 matrix written, and R1·R2·T word popcounts (R1·R2·T·32
    bit pairs, at the card's 1-bit tensor-core rate); its bound is the
    larger of the two times (cuda_build.declared_cost)."""
    nbytes = (r1 + r2 + bool(has_filter)) * t * 4 + r1 * r2 * 8
    return cuda_build.declared_cost(nbytes, device, popc=r1 * r2 * t)

