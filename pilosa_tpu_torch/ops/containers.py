"""Device-resident plane containers: dense, block-sparse and run-length.

A Container is one leaf fragment's device stack in one of three forms,
picked per fragment by measured density (the TPU package's
`ops/containers.py`, whose policy, chooser and host builders are copied
here verbatim):

  dense   — one [S, W] int32 stack of uint32 words.
  sparse  — block-sparse: only the non-empty BLOCK_WORDS-word blocks
            survive, as (block_ids [NB] int32 sorted, blocks [NB, BW]).
            Ids linearize (shard, block) row-major; padding uses an
            out-of-range sentinel id with zero blocks.
  rle     — run-length: sorted disjoint [start, end) bit intervals as
            (run_shard, run_start, run_end) int32 triples with
            shard-relative offsets. Padding runs are (shard=-1, 0, 0).

The chooser is deterministic in the host data, so a rebuild of
unchanged data re-picks the same representation. It keeps the TPU
package's int32 gates (S · SHARD_WIDTH < 2^31) though the port counts in
int64, so both packages pick the same form for the same stack. Its
counts (`analyze`) are taken on the device from the uploaded dense
stack: a cold leaf pays a few elementwise launches, not a host scan of
the whole stack.

A compressed leaf absorbs the streaming ingest merge's writes as
overlay terms (`with_overlay`): full replacement [K, W] planes of the
K drifted shards, parked after its base arrays and applied in append
order whenever it densifies, so it keeps its form between merges. The
chooser's picks are noted per leaf in a module ledger keyed (index,
field, view, row) that the planner's cost model, /debug/hbm's
compression ratios and /debug/heat's admission pricing read; the
adaptive engine may force a field dense at its next build
(`set_repr_override`).

`count_program` counts a tree over containers without densifying where
it can: a single sparse leaf and a pure-`&` tree of sparse leaves go to
K2 (ops/count_blocks.py), rle leaves to torch sums of run lengths and
overlaps, and anything else — a leaf with overlay terms included —
densifies its leaves on the device and goes to K1 (ops/count_expr.py).
`count_program_multi` counts a whole query's trees (whole-plan fusion):
every member that would end in K1 rides ONE launch of K1's multi-tree
entry, the others their own `count_program`. `plane_program` densifies
every leaf and evaluates the tree. Every count is an exact int64.
"""

import os
import threading

import numpy as np
import torch

from ..shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from .count_blocks import (
    BLOCK_WORDS,
    SPARSE_SENTINEL,
    align_blocks,
    count_and_blocks,
    count_blocks,
)
from .count_expr import count_expr, count_expr_batch, count_expr_multi, \
    popcount_total, tree_eval

__all__ = [
    "BLOCK_WORDS",
    "Container",
    "OVERLAY_MAX_TERMS",
    "analyze",
    "build",
    "choose",
    "configure",
    "container_to_dense",
    "count_kernels",
    "count_kernels_multi",
    "count_program",
    "count_program_multi",
    "dense_container",
    "field_estimate",
    "flat_arity",
    "flatten",
    "fragment_estimate",
    "fragment_ledger",
    "from_host",
    "kind_of",
    "norm_csig",
    "overlay_rows",
    "plane_program",
    "repr_mode",
    "reset_ledger",
    "to_dense",
    "unflatten",
    "with_overlay",
]

#: auto-chooser caps: rle only pays off when the run count is small, and
#: the pairwise intersect is O(NA * NB) — keep both bounded.
MAX_RLE_RUNS = 4096
MAX_RLE_PAIR = 1 << 22

#: a compressed representation must at least halve the bytes before auto
#: picks it — hysteresis against flapping near break-even, and it keeps
#: the (cheap, fused) dense kernels for data that barely compresses.
COMPRESS_ADVANTAGE = 0.5

#: auto only compresses fragments whose dense stack is at least this
#: big (default 4 MiB ≈ a 32-shard stack); forced sparse/rle ignore it,
#: and ops can lower it with PILOSA_TPU_COMPRESS_FLOOR.
AUTO_COMPRESS_FLOOR = int(os.environ.get(
    "PILOSA_TPU_COMPRESS_FLOOR", 4 << 20))

_ARITY = {"dense": 1, "sparse": 2, "rle": 3}
_MODES = ("auto", "dense", "sparse", "rle")

#: max pending-delta overlay terms a compressed container accumulates
#: before the ingest merge forces a full rebuild (repr re-chosen from
#: the measured density). Each term adds to the leaf's densify work, so
#: the cap bounds it (the TPU package's value, where each term is also a
#: program variant to compile).
OVERLAY_MAX_TERMS = 4

_MODE_LOCK = threading.Lock()
_MODE = os.environ.get("PILOSA_TPU_CONTAINER_REPR", "auto")
if _MODE not in _MODES:
    _MODE = "auto"


def configure(repr_mode=None):
    """Apply --container-repr (auto|dense|sparse|rle). `dense` is the
    bit-identical escape hatch; `sparse`/`rle` force a representation
    where eligible (int32-safety gates still win) — for differential
    tests and capacity experiments."""
    global _MODE
    if repr_mode is None:
        return
    if repr_mode not in _MODES:
        raise ValueError(
            f"container repr must be one of {'|'.join(_MODES)}: "
            f"{repr_mode!r}")
    with _MODE_LOCK:
        _MODE = repr_mode


def repr_mode():
    return _MODE


# ------------------------------------------------------------------ ledger
#
# Per-leaf representation ledger: what the chooser last picked for each
# built leaf — keyed (index, field, view[, leaf]) since different rows
# of one fragment pick independently. Read by exec/plan.py (compressed
# bytes_touched estimates for non-resident leaves), /debug/hbm
# (compression ratios), and utils/workload.py (admission candidates
# priced by compressed bytes). Writes happen at stack-build time only —
# never on the per-query hot path.

_LEDGER_LOCK = threading.Lock()
_LEDGER = {}


def _ledger_note(fragment, kind, nbytes, dense_bytes, density):
    if fragment is None:
        return
    entry = {
        "repr": kind,
        "bytes": int(nbytes),
        "dense_bytes": int(dense_bytes),
        "ratio": round(dense_bytes / nbytes, 3) if nbytes else 1.0,
        "density": round(float(density), 6),
    }
    with _LEDGER_LOCK:
        _LEDGER[tuple(fragment)] = entry


def fragment_estimate(index, field, view, leaf=None):
    """Build-ledger estimate for one leaf of an (index, field, view)
    fragment: the exact record when `leaf` (e.g. a row id) was built
    before, else the per-leaf mean over every leaf of the fragment with
    the most common repr (different rows of one fragment legitimately
    pick different representations). None when never built."""
    with _LEDGER_LOCK:
        if leaf is not None:
            e = _LEDGER.get((index, field, view, leaf))
            if e is not None:
                return dict(e)
        entries = [e for k, e in _LEDGER.items()
                   if k[:3] == (index, field, view)]
    if not entries:
        return None
    n = len(entries)
    kinds = {}
    for e in entries:
        kinds[e["repr"]] = kinds.get(e["repr"], 0) + 1
    bytes_mean = sum(e["bytes"] for e in entries) // n
    dense_mean = sum(e["dense_bytes"] for e in entries) // n
    return {"repr": max(sorted(kinds), key=lambda k: kinds[k]),
            "bytes": bytes_mean,
            "dense_bytes": dense_mean,
            "ratio": round(dense_mean / bytes_mean, 3)
            if bytes_mean else 1.0,
            "density": round(
                sum(e["density"] for e in entries) / n, 6)}


def field_estimate(index, field):
    """Aggregate over every built leaf for the /debug/heat admission
    join (heat is summed at (index, field) there too — the sum prices
    re-admitting the field's whole built working set): {bytes,
    dense_bytes, ratio, reprs} or None."""
    total = dense = 0
    kinds = set()
    with _LEDGER_LOCK:
        for k, e in _LEDGER.items():
            if k[0] == index and k[1] == field:
                total += e["bytes"]
                dense += e["dense_bytes"]
                kinds.add(e["repr"])
    if not kinds:
        return None
    return {"bytes": total, "dense_bytes": dense,
            "ratio": round(dense / total, 3) if total else 1.0,
            "reprs": sorted(kinds)}


def fragment_ledger():
    """Snapshot for /debug surfaces: {"index/field/view": entry}."""
    with _LEDGER_LOCK:
        return {"/".join(map(str, k)): dict(e) for k, e in _LEDGER.items()}


def reset_ledger():
    with _LEDGER_LOCK:
        _LEDGER.clear()
        _REPR_OVERRIDES.clear()


# Per-(index, field) representation overrides from the adaptive layer's
# misestimate feedback: a fragment whose container_repr plan repeatedly
# reads MORE bytes than the dense scan it displaced gets forced dense at
# its next rebuild. Consulted in build() only under auto mode — forced
# --container-repr modes are the operator's word and win.
_REPR_OVERRIDES = {}  # (index, field) -> kind


def set_repr_override(index, field, kind):
    if kind not in _ARITY:
        raise ValueError(f"unknown container repr: {kind!r}")
    with _LEDGER_LOCK:
        _REPR_OVERRIDES[(index, field)] = kind


def repr_override(index, field):
    with _LEDGER_LOCK:
        return _REPR_OVERRIDES.get((index, field))


def repr_overrides():
    with _LEDGER_LOCK:
        return {f"{i}/{f}": k for (i, f), k in _REPR_OVERRIDES.items()}


# --------------------------------------------------------------- container


class Container:
    """One leaf fragment's device-resident plane stack in one of the
    three representations. `arrays` are the int32 device tensors (arity
    by kind: dense 1, sparse 2, rle 3); `shape` is the logical dense
    [S, W]; `nbytes` the device bytes actually held (what the leaf pool
    charges); `meta` the chooser's analysis (dense_bytes, density,
    ratio) for /debug/hbm.

    `overlay` counts pending-delta overlay terms parked after the base
    arrays by the streaming ingest merge (exec/ingest.py): each term is
    an (idx [K] int32, planes [K, W]) pair of full replacement row
    planes, applied in append order after densifying — so a compressed
    fragment absorbs write churn without decaying to dense between
    merges. Dense containers never carry one (their writes copy in
    place)."""

    __slots__ = ("kind", "shape", "arrays", "nbytes", "meta", "overlay")

    def __init__(self, kind, shape, arrays, nbytes, meta=None, overlay=0):
        if kind not in _ARITY:
            raise ValueError(f"unknown container repr: {kind!r}")
        self.kind = kind
        self.shape = tuple(shape)
        self.arrays = tuple(arrays)
        self.nbytes = int(nbytes)
        self.meta = meta or {}
        self.overlay = int(overlay)

    @property
    def csig(self):
        """Signature of the container in a program: dense is ("dense",)
        (its size is read off the array); compressed kinds carry S,
        which their component shapes don't determine, plus the overlay
        term count when deltas are parked (a different flat arity)."""
        if self.kind == "dense":
            return ("dense",)
        if self.overlay:
            return (self.kind, self.shape[0], self.overlay)
        return (self.kind, self.shape[0])

    @property
    def gsig(self):
        """Grouping signature of a batch member: the kind and the exact
        shape of every component (the TPU package's `gsig`)."""
        return (self.kind,) + tuple(tuple(a.shape) for a in self.arrays)


def kind_of(arrays):
    """Representation of a cached pool entry: rows and BSI entries are
    raw dense tensors (never Containers)."""
    return arrays.kind if isinstance(arrays, Container) else "dense"


def dense_container(stack):
    """Wrap an existing [S, W] device stack without copying."""
    nbytes = stack.numel() * stack.element_size()
    return Container("dense", tuple(stack.shape), (stack,), nbytes,
                     {"dense_bytes": nbytes, "ratio": 1.0})


def flatten(containers):
    """Device tensors of the containers, in leaf-slot order."""
    return [a for c in containers for a in c.arrays]


def flat_arity(csig):
    return sum(_ARITY[entry[0]]
               + 2 * (entry[2] if len(entry) > 2 else 0)
               for entry in norm_csig(csig))


def norm_csig(csig):
    """Container signature from an arity int (N dense stacks) or an
    already-proper tuple."""
    if isinstance(csig, int):
        return (("dense",),) * csig
    return tuple(csig)


def unflatten(csig, flat):
    """Inverse of flatten: [(kind, arrays, S)], S = -1 for dense (read
    off the array), or [(kind, arrays, S, ((oidx, oplanes), ...))] for
    entries whose csig carries overlay terms."""
    out, i = [], 0
    for entry in norm_csig(csig):
        kind = entry[0]
        n = _ARITY[kind]
        cont = (kind, tuple(flat[i:i + n]),
                entry[1] if len(entry) > 1 else -1)
        i += n
        terms = entry[2] if len(entry) > 2 else 0
        if terms:
            cont = cont + (tuple((flat[i + 2 * t], flat[i + 2 * t + 1])
                                 for t in range(terms)),)
            i += 2 * terms
        out.append(cont)
    if i != len(flat):
        raise ValueError(f"{len(flat)} tensors for a signature of {i}")
    return out


def from_host(kind, shape, host_arrays, device):
    """A Container of `kind` placed on `device` from its host numpy
    arrays (the builders' output: uint32 words and int32 ids/runs), each
    as an int32 tensor."""
    if len(host_arrays) != _ARITY[kind]:
        raise ValueError(f"{kind} container takes {_ARITY[kind]} arrays, "
                         f"got {len(host_arrays)}")
    arrays, nbytes = [], 0
    for a in host_arrays:
        # a CPU tensor shares the array's memory: read-only arrays copy
        a = np.require(a, requirements=("C", "W")).view(np.int32)
        arrays.append(torch.from_numpy(a).to(device))
        nbytes += a.nbytes
    return Container(kind, shape, arrays, nbytes)


# ---------------------------------------------------------------- analysis

def _shifted_left(stack):
    """bit i-1 of the plane at bit i's position (little-endian words,
    cross-word carry; column 0 sees 0)."""
    carry = np.concatenate(
        [np.zeros((stack.shape[0], 1), np.uint32), stack[:, :-1] >> 31],
        axis=1)
    return (stack << np.uint32(1)) | carry


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def analyze(stack):
    """Chooser analysis of an [S, W] int32 stack of uint32 words, on the
    stack's device: exact bit count, density, non-empty block count, run
    count, and the projected device bytes of each representation (padded
    to the power-of-two component sizes the builders use). The same dict,
    key for key, as the TPU package's host `analyze` of those words; one
    host sync."""
    s, w = stack.shape
    bp = w // BLOCK_WORDS
    # bit i-1 at bit i's position (cross-word carry; column 0 sees 0):
    # `<<` on int32 shifts the unsigned bits, `>>` is arithmetic
    carry = torch.cat([torch.zeros((s, 1), dtype=stack.dtype,
                                   device=stack.device),
                       (stack[:, :-1] >> 31) & 1], dim=1)
    starts = stack & ~((stack << 1) | carry)
    bits, nonempty, runs = torch.stack([
        popcount_total(stack),
        (stack.reshape(s, bp, BLOCK_WORDS) != 0).any(dim=2).sum(),
        popcount_total(starts)]).tolist()
    nb_pad = _pow2(max(1, nonempty))
    nr_pad = _pow2(max(1, runs))
    return {
        "bits": bits,
        "density": bits / float(s * w * 32) if s and w else 0.0,
        "total_blocks": s * bp,
        "nonempty_blocks": nonempty,
        "runs": runs,
        "dense_bytes": s * w * 4,
        "sparse_bytes": nb_pad * (BLOCK_WORDS * 4 + 4),
        "rle_bytes": nr_pad * 12,
    }


def _sparse_eligible(s, w):
    # int32-exact totals AND sentinel strictly above every real id
    return (s * SHARD_WIDTH < 2**31
            and s * (w // BLOCK_WORDS) < SPARSE_SENTINEL)


def _rle_eligible(s, _w):
    # shard-relative [start, end] offsets go up to SHARD_WIDTH inclusive
    return s * SHARD_WIDTH < 2**31 and SHARD_WIDTH <= 2**30


def choose(info, s, w, mode=None):
    """Representation for a stack with this analysis under `mode`.
    Deterministic in (info, shape, mode) — the chooser-stability
    contract. Forced modes honor the int32-safety gates but skip the
    byte-advantage hysteresis."""
    mode = repr_mode() if mode is None else mode
    if mode == "dense":
        return "dense"
    if mode == "sparse":
        return "sparse" if _sparse_eligible(s, w) else "dense"
    if mode == "rle":
        return "rle" if _rle_eligible(s, w) else "dense"
    if info["dense_bytes"] < AUTO_COMPRESS_FLOOR:
        return "dense"
    budget = info["dense_bytes"] * COMPRESS_ADVANTAGE
    best, best_bytes = "dense", info["dense_bytes"]
    if (_sparse_eligible(s, w) and info["sparse_bytes"] <= budget
            and info["sparse_bytes"] < best_bytes):
        best, best_bytes = "sparse", info["sparse_bytes"]
    if (_rle_eligible(s, w) and info["runs"] <= MAX_RLE_RUNS
            and info["rle_bytes"] <= budget
            and info["rle_bytes"] < best_bytes):
        best, best_bytes = "rle", info["rle_bytes"]
    return best


# ------------------------------------------------------------ host builders


def _sparse_host(stack):
    """(block_ids [NBp] int32 sorted, blocks [NBp, BW] uint32), padded
    to a power of two with sentinel ids + zero blocks."""
    s, w = stack.shape
    bp = w // BLOCK_WORDS
    b3 = stack.reshape(s, bp, BLOCK_WORDS)
    ss, bb = np.nonzero(b3.any(axis=2))  # row-major: ids come out sorted
    ids = (ss.astype(np.int64) * bp + bb).astype(np.int32)
    n = len(ids)
    n_pad = _pow2(max(1, n))
    ids_p = np.full(n_pad, SPARSE_SENTINEL, dtype=np.int32)
    ids_p[:n] = ids
    blocks_p = np.zeros((n_pad, BLOCK_WORDS), dtype=np.uint32)
    blocks_p[:n] = b3[ss, bb]
    return ids_p, blocks_p


def _bit_positions(mask):
    """(shard_idx, bit_offset) of every set bit in a [S, W] mask, sorted
    by (shard, offset). Only the non-zero words are expanded — the masks
    this serves (run transitions) are sparse by construction."""
    ws, ww = np.nonzero(mask)
    if len(ws) == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    bits = (mask[ws, ww][:, None] >> np.arange(32, dtype=np.uint32)) & 1
    rows, cols = np.nonzero(bits)
    return (ws[rows].astype(np.int32),
            (ww[rows] * 32 + cols).astype(np.int32))


def _rle_host(stack):
    """(run_shard, run_start, run_end) int32 triples of the maximal
    [start, end) set-bit runs per shard row, sorted by (shard, start)
    and padded to a power of two with empty (-1, 0, 0) runs."""
    s, w = stack.shape
    shifted = _shifted_left(stack)
    s_sh, s_pos = _bit_positions(stack & ~shifted)   # 0 -> 1 transitions
    e_sh, e_pos = _bit_positions(~stack & shifted)   # 1 -> 0 transitions
    # runs still open at the end of the shard close at SHARD_WIDTH
    tail = np.nonzero((stack[:, -1] >> np.uint32(31)) & 1)[0]
    if len(tail):
        e_sh = np.concatenate([e_sh, tail.astype(np.int32)])
        e_pos = np.concatenate(
            [e_pos, np.full(len(tail), w * 32, dtype=np.int32)])
        order = np.lexsort((e_pos, e_sh))
        e_sh, e_pos = e_sh[order], e_pos[order]
    if len(s_sh) != len(e_sh):  # pragma: no cover — structural invariant
        raise AssertionError("run transition mismatch")
    n = len(s_sh)
    n_pad = _pow2(max(1, n))
    run_shard = np.full(n_pad, -1, dtype=np.int32)
    run_start = np.zeros(n_pad, dtype=np.int32)
    run_end = np.zeros(n_pad, dtype=np.int32)
    run_shard[:n] = s_sh
    run_start[:n] = s_pos
    run_end[:n] = e_pos
    return run_shard, run_start, run_end


def build(host_stack, device, mode=None, fragment=None):
    """One leaf stack placed on `device`: the dense stack goes up first
    and is analyzed there; a leaf the chooser compresses is then built on
    the host (`_sparse_host`, `_rle_host`) and placed in its stead. Under
    auto a per-field override (`set_repr_override`) wins over the
    chooser. `fragment` — (index, field, view, row) — records the choice
    in the ledger."""
    host_stack = np.ascontiguousarray(host_stack, dtype=np.uint32)
    s, w = host_stack.shape
    dense = from_host("dense", (s, w), (host_stack,), device)
    info = analyze(dense.arrays[0])
    kind = choose(info, s, w, mode)
    if ((mode or repr_mode()) == "auto" and fragment is not None
            and len(fragment) >= 2):
        override = repr_override(fragment[0], fragment[1])
        if override is not None:
            kind = override
    if kind == "dense":
        cont = dense
    else:
        host = _sparse_host(host_stack) if kind == "sparse" \
            else _rle_host(host_stack)
        cont = from_host(kind, (s, w), host, device)
    cont.meta = {"dense_bytes": info["dense_bytes"],
                 "density": round(info["density"], 6),
                 "ratio": round(info["dense_bytes"] / cont.nbytes, 3)
                 if cont.nbytes else 1.0}
    _ledger_note(fragment, kind, cont.nbytes, info["dense_bytes"],
                 info["density"])
    return cont


# ------------------------------------------------ counts and intersections
#
# Every count is an exact int64 0-d tensor on the containers' device.


def sparse_count(ids, blocks):  # noqa: ARG001 — ids fix the layout
    """Σ popcount of a block-sparse container: one K2 launch."""
    return count_blocks(blocks)


def sparse_intersect_blocks(ids_a, blocks_a, ids_b, blocks_b):
    """blocks_a ∩ blocks_b aligned onto a's block index: for each a
    block, binary-search b's sorted ids; unmatched blocks intersect to
    zero."""
    return blocks_a & align_blocks(ids_a, ids_b, blocks_b)


def rle_count(run_shard, run_start, run_end):  # noqa: ARG001
    """Σ (end − start) over the runs (padding runs are empty)."""
    return (run_end - run_start).sum(dtype=torch.int64)


def rle_intersect(a_sh, a_st, a_en, b_sh, b_st, b_en):
    """Pairwise [NA, NB] interval-overlap count restricted to matching
    shards; runs are disjoint within a container so the overlaps sum
    exactly. Padding runs (shard -1, empty) overlap nothing."""
    ov = (torch.minimum(a_en[:, None], b_en[None, :])
          - torch.maximum(a_st[:, None], b_st[None, :])).clamp_(min=0)
    same = a_sh[:, None] == b_sh[None, :]
    return torch.where(same, ov, 0).sum(dtype=torch.int64)


# -------------------------------------------------------------- densifiers


def sparse_to_dense(ids, blocks, s, w):
    """Exact dense [S, W] stack from sparse blocks: one index_copy_ into
    [NB + 1, BW] words whose last row takes every padding block (torch
    scatters have no drop mode), then a view of the first NB rows."""
    nb = (s * w) // BLOCK_WORDS
    flat = torch.zeros((nb + 1, BLOCK_WORDS), dtype=torch.int32,
                       device=blocks.device)
    flat.index_copy_(0, ids.long().clamp_(max=nb), blocks)
    return flat[:nb].view(s, w)


def _wrap_int32(x):
    """int64 words in [0, 2^32) as the int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def rle_to_dense(run_shard, run_start, run_end, s, w):
    """Exact dense [S, W] stack from runs, words filled straight from
    the runs with no per-shard loop: a run's interior words are full
    (a +1/-1 delta over the flat word axis, prefix-summed to coverage)
    and its first and last words take bit masks, added in (runs are
    disjoint, so their masks in one word share no bit and the sum is
    the OR)."""
    dev = run_start.device
    valid = (run_shard >= 0) & (run_end > run_start)
    sh = run_shard.long().clamp(min=0)
    st = run_start.long()
    last = (run_end.long() - 1).clamp(min=0)
    ws, we = st >> 5, last >> 5
    lo, hi = st & 31, (last & 31) + 1
    one_word = ws == we
    base = sh * w
    # interior words ws+1 .. we-1: coverage by prefix sum
    inner = valid & (we > ws + 1)
    delta = torch.zeros(s * w + 1, dtype=torch.int32, device=dev)
    step = inner.to(torch.int32)
    delta.index_add_(0, torch.where(inner, base + ws + 1, 0), step)
    delta.index_add_(0, torch.where(inner, base + we, 0), -step)
    cover = torch.cumsum(delta[:-1], 0, dtype=torch.int32)
    dense = (cover > 0).to(torch.int32).neg_()  # full words are -1
    # edge words: bits [lo, 32) of ws (or [lo, hi) for a one-word run),
    # bits [0, hi) of we
    head_top = torch.where(one_word, hi, 32)
    head = (1 << head_top) - (1 << lo)
    tail = (1 << hi) - 1
    head = torch.where(valid, head, 0)
    tail = torch.where(valid & ~one_word, tail, 0)
    dense.index_add_(0, base + ws, _wrap_int32(head))
    dense.index_add_(0, base + we, _wrap_int32(tail))
    return dense.view(s, w)


def _has_overlay(cont):
    return len(cont) > 3 and cont[3]


def to_dense(cont):
    """Dense [S, W] view of an unflattened (kind, arrays, S) container —
    identity for dense. Pending-delta overlay terms copy in append order
    after the base densifies: each term's planes are full replacements
    gathered from the authoritative host fragment, so later terms
    override earlier ones."""
    kind, arrays, s = cont[0], cont[1], cont[2]
    if kind == "dense":
        dense = arrays[0]
    elif kind == "sparse":
        dense = sparse_to_dense(arrays[0], arrays[1], s, WORDS_PER_ROW)
    else:
        dense = rle_to_dense(arrays[0], arrays[1], arrays[2], s,
                             WORDS_PER_ROW)
    if _has_overlay(cont):
        for oidx, oplanes in cont[3]:
            dense.index_copy_(0, oidx.long(), oplanes)
    return dense


def container_to_dense(cont):
    """Dense [S, W] of a Container object, overlay applied (the
    read-path patch's decay)."""
    return to_dense(unflatten((cont.csig,), cont.arrays)[0])


# ---------------------------------------------------------------- programs


def _count_container(cont):
    kind, arrays = cont[0], cont[1]
    if not _has_overlay(cont):
        if kind == "sparse":
            return sparse_count(*arrays)
        if kind == "rle":
            return rle_count(*arrays)
    # overlay terms replace whole planes, so the compressed direct counts
    # can't subtract what they cover: densify (exact) and count with K1
    return count_expr(("leaf", 0), [to_dense(cont)])


def _pure_intersect_leaves(sig):
    """Leaf slots of an all-& tree, or None for any other shape."""
    if sig[0] == "leaf":
        return [sig[1]]
    op, subs = sig
    if op != "&":
        return None
    out = []
    for sub in subs:
        r = _pure_intersect_leaves(sub)
        if r is None:
            return None
        out.extend(r)
    return out


def _count_route(sig, conts):
    """The strategy `count_program` takes for one tree over unflattened
    containers: "sparse" or "rle" (a single compressed leaf), "sparse_and"
    (strategy 2), "rle_and" (strategy 3), or "k1" — one K1 launch over the
    densified tree (a single dense leaf, or strategy 4)."""
    if sig[0] == "leaf":
        cont = conts[sig[1]]
        return "k1" if cont[0] == "dense" or _has_overlay(cont) \
            else cont[0]
    leaf_ids = _pure_intersect_leaves(sig)
    if (leaf_ids is not None and len(leaf_ids) >= 2
            and not any(_has_overlay(conts[i]) for i in leaf_ids)):
        kinds = {conts[i][0] for i in leaf_ids}
        if kinds == {"sparse"}:
            return "sparse_and"
        if kinds == {"rle"} and len(leaf_ids) == 2:
            a, b = conts[leaf_ids[0]], conts[leaf_ids[1]]
            if a[1][0].shape[0] * b[1][0].shape[0] <= MAX_RLE_PAIR:
                return "rle_and"
    return "k1"


class _Shaped:
    """A stand-in for a tensor that has only a shape (count_kernels)."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


def count_kernels(sig, csig, shapes, batch=1):
    """The hand-written kernels `count_program` (batch 1) or one group of
    `count_program_batch` launches for one tree, from the signature and
    the shapes of its flattened args alone: [(kernel, cost args)] as
    `ops.declared_cost` takes them. A batch of K1 members is one launch
    of the batched entry; other members launch one by one; the
    run-length sums launch nothing hand-written."""
    conts = unflatten(csig, [_Shaped(s) for s in shapes])
    route = _count_route(sig, conts)
    if route == "k1":
        first = conts[0]
        s = first[1][0].shape[0] if first[0] == "dense" else first[2]
        if batch > 1:
            return [("count_expr_batch",
                     (batch, len(conts), s, WORDS_PER_ROW))]
        return [("count_expr", (len(conts), s, WORDS_PER_ROW))]
    if route == "sparse":
        return [("count_blocks", (conts[sig[1]][1][1].shape[0],))]
    if route == "sparse_and":
        leaf_ids = _pure_intersect_leaves(sig)
        return [("count_and_blocks",
                 (conts[leaf_ids[0]][1][0].shape[0],
                  conts[leaf_ids[-1]][1][0].shape[0]))]
    return []


def count_program(sig, csig, flat):
    """Exact int64 count (0-d tensor) of one tree over flattened
    container args, by the first strategy that applies:

    1. single leaf               -> sparse: K2; rle: Σ run lengths;
                                    dense: K1
    2. pure-& tree, all sparse   -> the first pairs intersected in torch,
                                    the last pair in one K2 launch with
                                    its block search fused
    3. pure-& pair of small rle  -> pairwise interval overlap
    4. anything else             -> every leaf densified on the device,
                                    one K1 launch over the dense tree

    A leaf with overlay terms never takes 1-3: it densifies (its terms
    copied over the base) and counts with K1.

    All four give the same exact total."""
    conts = unflatten(csig, flat)
    if sig[0] == "leaf":
        return _count_container(conts[sig[1]])
    route = _count_route(sig, conts)
    if route == "k1":
        return count_expr(sig, [to_dense(c) for c in conts])
    leaf_ids = _pure_intersect_leaves(sig)
    if route == "sparse_and":
        acc_ids, acc_blocks = conts[leaf_ids[0]][1]
        for i in leaf_ids[1:-1]:
            acc_blocks = sparse_intersect_blocks(
                acc_ids, acc_blocks, *conts[i][1])
        return count_and_blocks(acc_ids, acc_blocks,
                                *conts[leaf_ids[-1]][1])
    return rle_intersect(*conts[leaf_ids[0]][1], *conts[leaf_ids[1]][1])


def count_program_batch(sig, csig, flats):
    """[B] int64 counts of B trees of one signature, each over its own
    flattened container args, equal to `count_program` member by member.
    A lone member is `count_program`; otherwise the members whose count
    ends in K1 are counted by ONE launch of K1's batched entry
    (`count_expr_batch`), the others (K2, the run-length sums) by
    `count_program` one by one."""
    if len(flats) == 1:
        return count_program(sig, csig, flats[0]).reshape(1)
    members = [unflatten(csig, flat) for flat in flats]
    k1 = [i for i, conts in enumerate(members)
          if _count_route(sig, conts) == "k1"]
    out = [None if i in k1 else count_program(sig, csig, flats[i])
           for i in range(len(members))]
    if k1:
        vals = count_expr_batch(
            sig, [[to_dense(c) for c in members[i]] for i in k1])
        if len(k1) == len(members):
            return vals
        for j, i in enumerate(k1):
            out[i] = vals[j]
    return torch.stack(out)


def count_program_multi(plans, flats_per_call, program=None):
    """[n_calls] int64 counts of a whole query's Count trees, each over
    its own flattened container args, equal to `count_program` call by
    call (the TPU package's `fused_count_fn` body). `plans` holds one
    (sig, csig) per call. Each call keeps its own `count_program` route:
    the calls whose route is "k1" (dense leaves, overlay-carrying ones,
    anything densified) are counted by ONE launch of K1's multi-tree
    entry (`count_expr_multi`) whatever their number, the others (K2, the
    run-length sums) by their own `count_program`. `program`, a
    count_expr.MultiProgram, keeps the multi entry's program table
    between calls."""
    conts = [unflatten(csig, flat)
             for (_sig, csig), flat in zip(plans, flats_per_call)]
    k1 = [i for i, (sig, _csig) in enumerate(plans)
          if _count_route(sig, conts[i]) == "k1"]
    out = [None if i in k1 else count_program(sig, csig, flats_per_call[i])
           for i, (sig, csig) in enumerate(plans)]
    if k1:
        vals = count_expr_multi(
            [plans[i][0] for i in k1],
            [[to_dense(c) for c in conts[i]] for i in k1], program=program)
        if len(k1) == len(plans):
            return vals
        for j, i in enumerate(k1):
            out[i] = vals[j]
    return torch.stack(out)


def count_kernels_multi(plans, shapes_per_call):
    """The hand-written kernels one `count_program_multi` launches, from
    the plans and the shapes of each call's flattened args alone, as
    `count_kernels` gives them: one launch of the multi-tree entry for
    the K1 calls (its cost args: each call's leaf count, S and W), then
    the other calls' own."""
    out, leaf_counts, s = [], [], None
    for (sig, csig), shapes in zip(plans, shapes_per_call):
        conts = unflatten(csig, [_Shaped(x) for x in shapes])
        if _count_route(sig, conts) == "k1":
            first = conts[0]
            s = first[1][0].shape[0] if first[0] == "dense" else first[2]
            leaf_counts.append(len(conts))
        else:
            out.extend(count_kernels(sig, csig, shapes))
    if leaf_counts:
        out.insert(0, ("count_expr_multi",
                       (tuple(leaf_counts), s, WORDS_PER_ROW)))
    return out


def plane_program(sig, csig, flat):
    """Dense [S, W] materialization of one tree over flattened container
    args — filter stacks must come out as the exact planes, so every
    leaf densifies first."""
    return tree_eval(sig, [to_dense(c) for c in unflatten(csig, flat)])


# -------------------------------------------------------- ingest overlay


def with_overlay(cont, device, oidx, oplanes):
    """New Container with one more pending-delta overlay term appended
    after `cont`'s arrays: `oidx` [K] stack-row indices (int32) and
    `oplanes` [K, W] full replacement planes (uint32 words), placed on
    `device` as int32 tensors. The base representation is untouched —
    this is how the interval merge folds writes into a sparse/rle
    fragment without decaying it to dense."""
    oidx = np.require(np.asarray(oidx, dtype=np.int32),
                      requirements=("C", "W"))
    oplanes = np.require(np.asarray(oplanes, dtype=np.uint32),
                         requirements=("C", "W")).view(np.int32)
    arrays = cont.arrays + (torch.from_numpy(oidx).to(device),
                            torch.from_numpy(oplanes).to(device))
    nbytes = cont.nbytes + int(oidx.nbytes + oplanes.nbytes)
    return Container(cont.kind, cont.shape, arrays, nbytes,
                     dict(cont.meta), overlay=cont.overlay + 1)


def overlay_rows(cont):
    """Total stack rows covered by a Container's overlay terms (the
    merge's rebuild-threshold input; counts duplicates across terms)."""
    base = _ARITY[cont.kind]
    return sum(int(cont.arrays[base + 2 * t].shape[0])
               for t in range(cont.overlay))
