"""K2: popcounts over block-sparse containers.

A block-sparse container (ops/containers.py) keeps only the non-empty
128-word blocks of an [S, W] plane stack: block ids [NB] int32, sorted,
and blocks [NB, 128] of uint32 words held as int32. Padding ids are
SPARSE_SENTINEL and their blocks are zero. Two entries, each an exact
int64 0-d tensor:

    count_blocks(blocks)                           Σ popcount(blocks)
    count_and_blocks(ids_a, blocks_a, ids_b, blocks_b)
                                                   Σ popcount(a ∩ b)

They are the TPU kernels `count_blocks_stack` and `count_and_blocks_stack`
(pilosa_tpu/ops/pallas_kernels.py:235, :245); the second takes its
caller's alignment of b onto a's block ids (`searchsorted`,
pilosa_tpu/ops/containers.py:757-761) into the kernel, which intersects
the two sorted id lists tile by tile. Bound: memory (the id arrays and
the blocks that count, read once; see csrc/count_blocks.cu).

Each wrapper takes its plain version for CPU tensors and launches the
hand-written kernel `csrc/count_blocks.cu` for CUDA tensors, or raises.
An empty input returns 0 without a launch.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .count_expr import popcount_total

__all__ = [
    "BLOCK_WORDS",
    "SPARSE_SENTINEL",
    "align_blocks",
    "count_and_blocks",
    "count_and_blocks_cost",
    "count_and_blocks_reference",
    "count_blocks",
    "count_blocks_cost",
    "count_blocks_reference",
]

#: words per block-sparse block
BLOCK_WORDS = 128
#: block id of sparse padding: above every real (shard, block) id, so a
#: scatter can drop it and an intersection never matches it
SPARSE_SENTINEL = 1 << 30

_MODES = {"blocks": 0, "fused": 2}


def _check_blocks(blocks, name="blocks"):
    if not isinstance(blocks, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(blocks)}")
    if blocks.dtype != torch.int32:
        raise TypeError(f"{name} dtype {blocks.dtype} != torch.int32")
    if blocks.dim() != 2 or blocks.shape[1] != BLOCK_WORDS:
        raise ValueError(
            f"{name} must be [NB, {BLOCK_WORDS}], got {tuple(blocks.shape)}")


def _check_ids(ids, blocks, name):
    if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor")
    if ids.shape != (blocks.shape[0],):
        raise ValueError(
            f"{name} shape {tuple(ids.shape)} != ({blocks.shape[0]},)")
    if ids.device != blocks.device:
        raise ValueError(f"{name} and its blocks lie on different devices")


def _same_device(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("K2 inputs lie on different devices")
    return dev


def _zero(dev):
    return torch.zeros((), dtype=torch.int64, device=dev)


def align_blocks(ids_a, ids_b, blocks_b):
    """b's blocks aligned onto a's block ids: row i is b's block with id
    ids_a[i], or zeros where b has none (padding ids never match)."""
    if ids_a.shape[0] == 0 or ids_b.shape[0] == 0:
        return torch.zeros((ids_a.shape[0], BLOCK_WORDS), dtype=torch.int32,
                           device=ids_a.device)
    pos = torch.searchsorted(ids_b, ids_a).clamp_(max=ids_b.shape[0] - 1)
    match = (ids_b[pos] == ids_a) & (ids_a != SPARSE_SENTINEL)
    return torch.where(match[:, None], blocks_b[pos], 0)


def count_blocks_reference(blocks):
    """The plain version of `count_blocks`: SWAR popcount, int64 sum."""
    _check_blocks(blocks)
    return popcount_total(blocks)


def count_and_blocks_reference(ids_a, blocks_a, ids_b, blocks_b):
    """The plain version of `count_and_blocks`: searchsorted, clip, match
    mask, where, popcount."""
    _check_fused(ids_a, blocks_a, ids_b, blocks_b)
    return popcount_total(blocks_a & align_blocks(ids_a, ids_b, blocks_b))


def _check_fused(ids_a, blocks_a, ids_b, blocks_b):
    _check_blocks(blocks_a, "blocks_a")
    _check_blocks(blocks_b, "blocks_b")
    _check_ids(ids_a, blocks_a, "ids_a")
    _check_ids(ids_b, blocks_b, "ids_b")
    return _same_device(ids_a, blocks_a, ids_b, blocks_b)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/count_blocks.cu (built at first use)."""
    fn = cuda_build.load("count_blocks").count_blocks_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch(mode, wrapper, a, b=None, ids_a=None, ids_b=None):
    fn = _kernel_fn()
    for t in (a, b, ids_a, ids_b):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("K2 inputs must be 16-byte aligned")
    out = torch.empty((1,), dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_MODES[mode], a.data_ptr(),
             None if b is None else b.data_ptr(),
             None if ids_a is None else ids_a.data_ptr(),
             None if ids_b is None else ids_b.data_ptr(),
             a.shape[0], 0 if b is None else b.shape[0],
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"count_blocks kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(wrapper)
    return out[0]


def _route(dev, name):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def count_blocks(blocks):
    """Σ popcount over a [NB, 128] block stack as a 0-d int64 tensor on
    its device: the plain version for a CPU tensor, a K2 launch for a
    CUDA tensor."""
    _check_blocks(blocks)
    if not _route(blocks.device, "count_blocks"):
        return count_blocks_reference(blocks)
    if blocks.shape[0] == 0:
        return _zero(blocks.device)
    return _launch("blocks", count_blocks, blocks)


def count_and_blocks(ids_a, blocks_a, ids_b, blocks_b):
    """Σ popcount of the intersection of two block-sparse containers of
    one [S, W] geometry: a's blocks AND b's block of the same id, blocks
    without a partner (or with the padding id) counting zero."""
    dev = _check_fused(ids_a, blocks_a, ids_b, blocks_b)
    if not _route(dev, "count_and_blocks"):
        return count_and_blocks_reference(ids_a, blocks_a, ids_b, blocks_b)
    if blocks_a.shape[0] == 0 or blocks_b.shape[0] == 0:
        return _zero(dev)
    return _launch("fused", count_and_blocks, blocks_a, blocks_b, ids_a,
                   ids_b)


#: K2 launches since the last reset, per entry (chip_smoke.py sums them)
count_blocks.launches = 0
count_and_blocks.launches = 0


def count_blocks_cost(nb, device=None):
    """count_blocks' declared cost over [NB, 128] blocks: every block
    read once, one int64 written (cuda_build.declared_cost)."""
    return cuda_build.declared_cost(nb * BLOCK_WORDS * 4 + 8, device)


def count_and_blocks_cost(na, nb, matched=None, device=None):
    """count_and_blocks' declared cost for id lists of NA and NB
    entries: both id lists read once, the blocks of both sides whose ids
    match (padding never matches), one int64 written. `matched` is the
    data's count of matching ids, which the shapes alone cannot see:
    without it the cost declares the most, min(NA, NB)."""
    if matched is None:
        matched = min(na, nb)
    return cuda_build.declared_cost(
        (na + nb) * 4 + 2 * matched * BLOCK_WORDS * 4 + 8, device)

