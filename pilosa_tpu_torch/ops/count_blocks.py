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

Their batched entry counts B members of one shape in one launch, each
total its own, as the TPU package's vmapped count program
(`_vmap_count_fn`, pilosa_tpu/exec/stacked.py:1620) makes one kernel of
a batch of sparse Counts:

    count_blocks_batch([blocks, ...])              [B] Σ popcount
    count_and_blocks_batch([(ids_a, blocks_a, ids_b, blocks_b), ...])
                                                   [B] Σ popcount(a ∩ b)

Up to `by_value_cap(mode)` members (128 in mode 0, 32 fused) the call is
that one kernel and nothing else: the members' pointers ride in the
launch's parameters, and each member's total reaches `out` through a
per-stream state word that the kernel leaves zero, so no table is
built, pinned or copied and no memset runs. Larger batches pass a
device table of pointers first.

Each wrapper takes its plain version for CPU tensors and launches the
hand-written kernel `csrc/count_blocks.cu` for CUDA tensors, or raises.
An empty input returns 0 without a launch (zeros, for a batch).
"""

import ctypes
import functools
import threading

import torch

from . import cuda_build
from .count_expr import popcount_total

__all__ = [
    "BLOCK_WORDS",
    "SPARSE_SENTINEL",
    "align_blocks",
    "count_and_blocks",
    "count_and_blocks_batch",
    "count_and_blocks_batch_cost",
    "count_and_blocks_batch_reference",
    "count_and_blocks_cost",
    "count_and_blocks_reference",
    "count_blocks",
    "count_blocks_batch",
    "count_blocks_batch_cost",
    "count_blocks_batch_reference",
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
    """The C entry point of csrc/count_blocks.cu (built at first use).
    A lone Count keeps this single entry (count_program_batch counts a
    batch of one as count_program does). The batched entry at B = 1 now
    costs about the same: +0.6 to +2.1 us a call by CUDA events, called
    in alternation with this one (+48.1 to +64.4 us before it carried
    its pointers by value), on an H100 80GB HBM3 at 700 W
    (tools/ab_k2.py; PERF.md §6)."""
    fn = cuda_build.load("count_blocks").count_blocks_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check_launchable(tensors):
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("K2 inputs must be 16-byte aligned")


def _launch(mode, wrapper, a, b=None, ids_a=None, ids_b=None):
    fn = _kernel_fn()
    _check_launchable((a, b, ids_a, ids_b))
    out = torch.empty((1,), dtype=torch.int64, device=a.device)
    with cuda_build.on_card(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_MODES[mode], a.data_ptr(),
                 None if b is None else b.data_ptr(),
                 None if ids_a is None else ids_a.data_ptr(),
                 None if ids_b is None else ids_b.data_ptr(),
                 a.shape[0], 0 if b is None else b.shape[0],
                 out.data_ptr(), stream)
    if err != 0:
        raise cuda_build.launch_error("count_blocks", a.device, err)
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


# ------------------------------------------------------- the batched entry

#: grid.y's limit: the batched kernels' member axis
MAX_BATCH = 65535


def count_blocks_batch_reference(blocks_per_member):
    """The plain version of `count_blocks_batch`: one
    `count_blocks_reference` per member, as a [B] int64 tensor."""
    if not blocks_per_member:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.stack([count_blocks_reference(blocks)
                        for blocks in blocks_per_member])


def count_and_blocks_batch_reference(members):
    """The plain version of `count_and_blocks_batch`: one
    `count_and_blocks_reference` per member, as a [B] int64 tensor."""
    if not members:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.stack([count_and_blocks_reference(*m) for m in members])


@functools.lru_cache(maxsize=None)
def _batch_kernel_fn():
    """The batched C entry point of csrc/count_blocks.cu."""
    fn = cuda_build.load("count_blocks").count_blocks_batch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def by_value_cap(mode):
    """The most members ("blocks" or "fused" mode) whose pointers the
    batched launch carries in its parameters, from the card's build
    (csrc/count_blocks.cu's `count_blocks_batch_by_value_cap`: 128 pointer
    slots, 1 a member in mode 0 and 4 fused)."""
    fn = cuda_build.load("count_blocks").count_blocks_batch_by_value_cap
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(_MODES[mode])


def _check_batch(rows, dev, name):
    """Every member's arrays of one shape per slot, on `dev`, and at most
    MAX_BATCH members."""
    if len(rows) > MAX_BATCH:
        raise ValueError(f"{name}: {len(rows)} members > {MAX_BATCH}")
    first = rows[0]
    for row in rows:
        for t, t0 in zip(row, first):
            if t.shape != t0.shape:
                raise ValueError(
                    f"{name}: members must share one shape per slot, got "
                    f"{tuple(t.shape)} and {tuple(t0.shape)}")
            if t.device != dev:
                raise ValueError(f"{name}: members lie on different devices")


def batch_route(n_members, cap):
    """How a batch of n_members reaches the kernel: "by_value" (the
    pointers in the launch's parameters, no table) up to `cap`
    (`by_value_cap` of its mode), else "table" (a device array of
    pointers)."""
    return "by_value" if n_members <= cap else "table"


def kernel_rows(mode, members):
    """Each member's tensors in the order the kernel reads its pointers:
    mode 0 ("blocks", a member is its blocks) a's blocks; fused (a member
    is (ids_a, blocks_a, ids_b, blocks_b)) a's blocks, b's blocks, a's
    ids, b's ids."""
    if mode == "blocks":
        return [(blocks,) for blocks in members]
    return [(blocks_a, blocks_b, ids_a, ids_b)
            for ids_a, blocks_a, ids_b, blocks_b in members]


def pack_pointers(mode, members):
    """The members' pointers flat, in the kernel's order: member q's
    `kernel_rows` data_ptr()s at [q * K, q * K + K)."""
    return [t.data_ptr() for row in kernel_rows(mode, members) for t in row]


#: the batched kernels' per-stream state (a running total and the CTAs
#: arrived, one int64 a member), keyed (device index, stream handle)
_batch_states = {}
_batch_states_lock = threading.Lock()


def _batch_state(stream, n_members):
    """The stream's state of at least n_members int64, made zero on that
    stream when it is first made or grown; every launch leaves the words
    it used zero. One per stream, so launches on two streams never share
    one."""
    key = (stream.device.index, stream.cuda_stream)
    t = _batch_states.get(key)
    if t is None or t.numel() < n_members:
        with _batch_states_lock, torch.cuda.stream(stream):
            t = _batch_states.get(key)
            if t is None or t.numel() < n_members:
                # one allocation serves every batch of up to 128 members
                size = max(n_members, 128)
                t = _batch_states[key] = torch.zeros(
                    1 << (size - 1).bit_length(), dtype=torch.int64,
                    device=stream.device)
    return t


def _launch_batch(mode, wrapper, members, nb_a, nb_b):
    """One launch of the batched kernel over `members` (CUDA tensors of
    one shape, nb_a and nb_b >= 1): their pointers by value up to
    by_value_cap(mode), so the call is that one kernel and nothing else;
    past the cap, a device table copied from pinned memory first."""
    fn = _batch_kernel_fn()
    rows = kernel_rows(mode, members)
    for row in rows:
        _check_launchable(row)
    dev = rows[0][0].device
    ptrs = pack_pointers(mode, members)
    table = None
    if batch_route(len(members), by_value_cap(mode)) == "by_value":
        host = (ctypes.c_longlong * len(ptrs))(*ptrs)
    else:
        # [B, K] pointers copied from pinned memory without a wait: the
        # host allocator keeps the pinned rows until the copy has run
        host = None
        table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
    out = torch.empty((len(members),), dtype=torch.int64, device=dev)
    with cuda_build.on_card(dev):
        stream = torch.cuda.current_stream(dev)
        state = _batch_state(stream, len(members))
        err = fn(_MODES[mode], host,
                 None if table is None else table.data_ptr(), len(members),
                 nb_a, nb_b, out.data_ptr(), state.data_ptr(),
                 stream.cuda_stream)
    if err != 0:
        raise cuda_build.launch_error("count_blocks batch", dev, err)
    cuda_build.count_launch(wrapper)
    return out


def count_blocks_batch(blocks_per_member):
    """[B] int64 tensor of Σ popcount over each member's [NB, 128]
    blocks, every member of one NB on one device: the plain version for
    CPU tensors, ONE launch of the batched kernel for CUDA tensors (none
    for NB = 0; an empty batch gives an empty tensor)."""
    for blocks in blocks_per_member:
        _check_blocks(blocks)
    if not blocks_per_member:
        return torch.zeros((0,), dtype=torch.int64)
    dev = blocks_per_member[0].device
    rows = kernel_rows("blocks", blocks_per_member)
    _check_batch(rows, dev, "count_blocks_batch")
    if not _route(dev, "count_blocks_batch"):
        return count_blocks_batch_reference(blocks_per_member)
    nb = blocks_per_member[0].shape[0]
    if nb == 0:
        return torch.zeros((len(rows),), dtype=torch.int64, device=dev)
    return _launch_batch("blocks", count_blocks_batch, blocks_per_member,
                         nb, 0)


def count_and_blocks_batch(members):
    """[B] int64 tensor of each member's `count_and_blocks`: members are
    (ids_a, blocks_a, ids_b, blocks_b) tuples, all of one NB_a and one
    NB_b on one device. CPU tensors take the plain version, CUDA tensors
    ONE launch of the batched kernel (none when NB_a or NB_b is 0; an
    empty batch gives an empty tensor)."""
    members = [tuple(m) for m in members]
    devs = [_check_fused(*m) for m in members]
    if not members:
        return torch.zeros((0,), dtype=torch.int64)
    dev = devs[0]
    _check_batch(members, dev, "count_and_blocks_batch")
    if not _route(dev, "count_and_blocks_batch"):
        return count_and_blocks_batch_reference(members)
    nb_a, nb_b = members[0][1].shape[0], members[0][3].shape[0]
    if nb_a == 0 or nb_b == 0:
        return torch.zeros((len(members),), dtype=torch.int64, device=dev)
    return _launch_batch("fused", count_and_blocks_batch, members, nb_a,
                         nb_b)


#: launches of the batched entry since the last reset, per mode
#: (chip_smoke.py sums them)
count_blocks_batch.launches = 0
count_and_blocks_batch.launches = 0


#: bytes a member of the batched entry adds to its single cost: its
#: int64 state word (a running total and the CTAs arrived)
STATE_BYTES = 8


def count_blocks_batch_cost(b, nb, device=None):
    """The batched entry's declared cost for B members of [NB, 128]
    blocks: the sum of the members' `count_blocks_cost` and their state
    words."""
    return cuda_build.declared_cost(
        b * (count_blocks_cost(nb)["bytes accessed"] + STATE_BYTES), device)


def count_and_blocks_batch_cost(b, na, nb, device=None):
    """The batched entry's declared cost for B members of id lists of NA
    and NB entries: the sum of the members' `count_and_blocks_cost`,
    each declaring the most (the shapes do not show the matched ids),
    and their state words."""
    return cuda_build.declared_cost(
        b * (count_and_blocks_cost(na, nb)["bytes accessed"] + STATE_BYTES),
        device)
