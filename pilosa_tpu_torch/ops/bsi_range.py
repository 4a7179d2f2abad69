"""K5: signed BSI range mask over bit planes.

`bsi_range_mask(op, planes, sign, exists, pbits, neg_pred, allow_eq)` is
the columns whose signed value compares `op` ("eq", "lt" or "gt"; "lt"
and "gt" take the bound itself when `allow_eq`) to the predicate whose
magnitude bits are `pbits` ([D] 0/1, LSB first) and whose sign is
`neg_pred`. `planes` is [D, ...] magnitude bit planes (LSB first) held as
int32 words; `sign` and `exists` are shaped like one plane, and so is the
mask. A [D, S, W] stacked view and a [D, W] shard both fit. neq, lte and
gte are composed by the caller, as the TPU package does (exec/bsicond.py).

It replaces the TPU kernel `bsi_range_mask`
(pilosa_tpu/ops/pallas_kernels.py:493, body :422), whose semantics are
those of the TPU package's jnp range ops (pilosa_tpu/ops/bsi.py:99-127).

`bsi_range_mask` is the wrapper: a CPU tensor goes to the plain version
`bsi_range_mask_reference`; a CUDA tensor goes to the hand-written kernel
`csrc/bsi_range.cu` (see that file for its design and bound) or raises.
An empty plane returns an empty mask without a launch.
"""

import ctypes
import functools

import torch

from . import cuda_build

__all__ = [
    "OPS",
    "MAX_DEPTH",
    "bsi_range_cost",
    "bsi_range_mask",
    "bsi_range_mask_reference",
    "compare_planes",
    "predicate_value",
]

OPS = ("eq", "lt", "gt")
MAX_DEPTH = 64

_OPCODES = {"eq": 0, "lt": 1, "gt": 2}


def predicate_value(pbits):
    """The predicate magnitude as an int from its [D] 0/1 bits (LSB
    first); bit d of the result is plane d's predicate bit."""
    value = 0
    for d, bit in enumerate(pbits):
        bit = int(bit)
        if bit not in (0, 1):
            raise ValueError(f"predicate bit {d} is {bit}, not 0 or 1")
        value |= bit << d
    return value


def compare_planes(planes, pred):
    """(lt, eq, gt) int32 masks of each column's magnitude against the
    unsigned predicate `pred`: the MSB-first comparator, one elementwise
    pass per plane. pmask is an int32 −1/0 per plane; no plane is ever
    shifted (int32 `>>` sign-extends)."""
    eq = torch.full(planes.shape[1:], -1, dtype=torch.int32,
                    device=planes.device)
    lt = torch.zeros_like(eq)
    gt = torch.zeros_like(eq)
    for d in range(planes.shape[0] - 1, -1, -1):
        plane = planes[d]
        pmask = -1 if (pred >> d) & 1 else 0
        gt = gt | (eq & plane & ~pmask)
        lt = lt | (eq & ~plane & pmask)
        eq = eq & ~(plane ^ pmask)
    return lt, eq, gt


def _check(op, planes, sign, exists, pbits):
    """Validate the arguments; returns the predicate magnitude."""
    if op not in _OPCODES:
        raise ValueError(f"unknown BSI range op {op!r} (not one of {OPS})")
    for name, t in (("planes", planes), ("sign", sign), ("exists", exists)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype} != torch.int32")
        if t.device != planes.device:
            raise ValueError("planes, sign and exists lie on different devices")
    if planes.dim() < 2:
        raise ValueError(f"planes must be [D, ...], got {tuple(planes.shape)}")
    if sign.shape != planes.shape[1:] or exists.shape != planes.shape[1:]:
        raise ValueError(
            f"sign {tuple(sign.shape)} and exists {tuple(exists.shape)} must "
            f"be shaped like one plane {tuple(planes.shape[1:])}")
    depth = planes.shape[0]
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside 1..{MAX_DEPTH}")
    if len(pbits) != depth:
        raise ValueError(f"{len(pbits)} predicate bits for depth {depth}")
    return predicate_value(pbits)


def bsi_range_mask_reference(op, planes, sign, exists, pbits, neg_pred,
                             allow_eq):
    """The plain version of K5: the comparator, then the sign-magnitude
    combine of `_bsi_range_kernel` (reference: rangeEQ/rangeLT/rangeGT
    fragment.go:1292-1470)."""
    pred = _check(op, planes, sign, exists, pbits)
    lt, eq, gt = compare_planes(planes, pred)
    pos = exists & ~sign
    neg = exists & sign
    eqm = eq if allow_eq else torch.zeros_like(eq)
    if op == "eq":
        return (neg if neg_pred else pos) & eq
    if op == "lt":
        return neg & (gt | eqm) if neg_pred else neg | (pos & (lt | eqm))
    return pos | (neg & (lt | eqm)) if neg_pred else pos & (gt | eqm)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/bsi_range.cu (built at first use)."""
    fn = cuda_build.load("bsi_range").bsi_range_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    return fn


def _launch(op, planes, sign, exists, pred, neg_pred, allow_eq):
    fn = _kernel_fn()
    if not (planes[0].is_contiguous() and sign.is_contiguous()
            and exists.is_contiguous()):
        raise ValueError("bsi_range_mask: each plane, sign and exists must "
                         "be contiguous")
    if any(t.data_ptr() % 16 for t in (planes, sign, exists)):
        raise ValueError("bsi_range_mask inputs must be 16-byte aligned")
    n_words = sign.numel()
    stride = planes.stride(0)
    if n_words % 4 or stride % 4:
        raise ValueError("words per plane and the plane stride must be "
                         "multiples of 4")
    out = torch.empty_like(sign)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = fn(planes.data_ptr(), stride, planes.shape[0], pred,
             sign.data_ptr(), exists.data_ptr(), _OPCODES[op],
             int(bool(neg_pred)), int(bool(allow_eq)), out.data_ptr(),
             n_words, stream)
    if err != 0:
        raise RuntimeError(f"bsi_range kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(bsi_range_mask)
    return out


def bsi_range_mask(op, planes, sign, exists, pbits, neg_pred, allow_eq):
    """The int32 mask, shaped like `sign`, of the columns whose signed
    value compares `op` to the predicate. CPU tensors take the plain
    version; CUDA tensors launch K5 (an empty plane returns an empty mask
    without a launch)."""
    pred = _check(op, planes, sign, exists, pbits)
    dev = planes.device
    if dev.type == "cpu":
        return bsi_range_mask_reference(op, planes, sign, exists, pbits,
                                        neg_pred, allow_eq)
    if dev.type != "cuda":
        raise ValueError(f"bsi_range_mask: unsupported device {dev}")
    if sign.numel() == 0:
        return torch.empty_like(sign)
    return _launch(op, planes, sign, exists, pred, neg_pred, allow_eq)


#: K5 launches since the last reset (read by chip_smoke.py)
bsi_range_mask.launches = 0


def bsi_range_cost(depth, t, device=None):
    """K5's declared cost over D magnitude planes of T words plus sign
    and exists: every plane read once, the [T] mask written
    (cuda_build.declared_cost)."""
    return cuda_build.declared_cost((depth + 3) * t * 4, device)

