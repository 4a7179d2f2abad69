"""K1: fused expression-count over [S, W] shard stacks.

Σ popcount(tree(leaves)) over every word of every shard, where `tree` is
a nested signature of `&`, `|`, `^` and `-` (and-not) over leaf slots:

    ("leaf", i)                      leaf stack i
    (op, (sub, sub, ...))            left-to-right fold of op over subs

— the same signatures exec/stacked.py builds and `tree_eval` evaluates.
The TPU kernel this replaces is `count_expr_stack`
(pilosa_tpu/ops/pallas_kernels.py:141), which takes only a flat op
chain; `chain_signature` maps such a chain onto a tree.

Stacks are uint32 words held as int32 tensors (PyTorch lacks `~` and
`>>` for uint32 on the CPU). Totals are exact int64.

`count_expr` is the wrapper: a CPU tensor goes to the plain version
`count_expr_reference`; a CUDA tensor goes to the hand-written kernel
`csrc/count_expr.cu` (see that file for its design and bound) or raises.

`count_expr_batch` is K1's batched entry: B members of one signature,
each over its own leaves, counted in one launch into a [B] int64 tensor
(the counterpart of the TPU package's vmapped batch count programs,
pilosa_tpu/exec/stacked.py:1424, :1620). Its plain version is
`count_expr_batch_reference`.

`count_expr_multi` is K1's multi-tree entry: n members, each with its own
signature and leaves, counted in one launch into an [n] int64 tensor (the
counterpart of the TPU package's whole-plan fusion program
`fused_count_fn`, pilosa_tpu/exec/stacked.py:1452). Its program table
(`MultiProgram`) is built on the host and copied to the device once per
member list; its plain version is `count_expr_multi_reference`.
"""

import ctypes
import functools

import torch

from . import cuda_build

__all__ = [
    "MAX_LEAVES",
    "MAX_PROGRAM",
    "MAX_STACK",
    "MultiProgram",
    "chain_signature",
    "compile_program",
    "count_expr",
    "count_expr_batch",
    "count_expr_batch_cost",
    "count_expr_batch_reference",
    "count_expr_cost",
    "count_expr_multi",
    "count_expr_multi_cost",
    "count_expr_multi_reference",
    "count_expr_reference",
    "count_expr_stack",
    "fit_tree",
    "popcount_total",
    "tree_eval",
]

MAX_LEAVES = 16
MAX_PROGRAM = 64
MAX_STACK = 8

_OPCODES = {"&": 16, "|": 17, "^": 18, "-": 19}


def chain_signature(n_operands, ops):
    """Tree signature of the left-to-right chain `ops` over operands
    0..n-1 (the `count_expr_stack` contract)."""
    ops = tuple(ops)
    if len(ops) != n_operands - 1:
        raise ValueError(
            f"op chain length {len(ops)} != operand count {n_operands - 1}")
    sig = ("leaf", 0)
    for i, op in enumerate(ops, start=1):
        if op not in _OPCODES:
            raise ValueError(f"unknown op {op!r}")
        sig = (op, (sig, ("leaf", i)))
    return sig


def compile_program(sig):
    """Postfix program bytes of a tree signature: leaf i pushes (opcode
    i), each fold step pops two and pushes one (opcodes 16..19). Raises
    when the program, the leaf index or the stack depth exceeds what the
    kernel holds."""
    code = []
    depth = max_depth = 0

    def emit(node):
        nonlocal depth, max_depth
        if node[0] == "leaf":
            i = int(node[1])
            if not 0 <= i < MAX_LEAVES:
                raise ValueError(f"leaf slot {i} outside 0..{MAX_LEAVES - 1}")
            code.append(i)
            depth += 1
            max_depth = max(max_depth, depth)
            return
        op, subs = node
        if op not in _OPCODES or not subs:
            raise ValueError(f"bad tree node {node!r}")
        emit(subs[0])
        for sub in subs[1:]:
            emit(sub)
            code.append(_OPCODES[op])
            depth -= 1

    emit(sig)
    if len(code) > MAX_PROGRAM:
        raise ValueError(f"program of {len(code)} steps > {MAX_PROGRAM}")
    if max_depth > MAX_STACK:
        raise ValueError(f"tree needs stack depth {max_depth} > {MAX_STACK}")
    return bytes(code)


def _leaf_slots(sig, out):
    """Counts of each leaf slot's occurrences in `sig`, added to `out`."""
    if sig[0] == "leaf":
        out[sig[1]] = out.get(sig[1], 0) + 1
    else:
        for sub in sig[1]:
            _leaf_slots(sub, out)
    return out


def _depth(sig):
    """Stack depth `compile_program` needs for `sig`: the first operand of
    a fold sits at the node's own level, every later one a level up."""
    if sig[0] == "leaf":
        return 1
    subs = sig[1]
    return max([_depth(subs[0])] + [1 + _depth(s) for s in subs[1:]])


def _fits(sig, n_slots):
    return (_excess(n_slots, sum(_leaf_slots(sig, {}).values())) == 0
            and _depth(sig) <= MAX_STACK)


def fit_tree(sig, stacks):
    """(sig', stacks') with the same count as (sig, stacks) and within
    K1's limits (MAX_LEAVES slots, MAX_PROGRAM steps, MAX_STACK depth).

    A tree that fits comes back as it is. Otherwise sub-trees are folded
    to dense [S, W] planes with `tree_eval` (torch elementwise ops), each
    plane a new leaf, as few folded leaves as the limits allow:

    1. depth: a node that would sit at stack depth MAX_STACK with
       operands of its own is folded whole;
    2. slots and steps: while the tree has more than MAX_LEAVES slots or
       more than MAX_PROGRAM / 2 leaf occurrences, the group that removes
       the most of that excess per folded step is folded (the largest that
       does not overshoot). A group is a whole node, or the first k
       operands of a node: every fold is a left fold, so
       op(c0, ..., cn) == op(op(c0, ..., ck-1), ck, ..., cn), `-`
       included.

    Slots are renumbered to the leaves the result uses, stacks first in
    slot order, then the planes. Each plane is transient."""
    stacks = list(stacks)
    if _fits(sig, len(stacks)):
        return sig, stacks
    sig = _fit_depth(sig, MAX_STACK, stacks)
    while True:
        counts = _leaf_slots(sig, {})
        if _excess(len(counts), sum(counts.values())) == 0:
            break
        path, k = _best_group(sig, counts)
        sig = _fold(sig, path, k, stacks)
    used = sorted(_leaf_slots(sig, {}))
    slot = {old: new for new, old in enumerate(used)}
    return _renumber(sig, slot), [stacks[i] for i in used]


def _excess(n_slots, occurrences):
    """How far a tree of that many slots and leaf occurrences is past
    K1's slot and step limits (2m - 1 steps for m occurrences)."""
    return max(0, n_slots - MAX_LEAVES,
               occurrences - (MAX_PROGRAM + 1) // 2)


def _plane_leaf(node, stacks):
    stacks.append(tree_eval(node, stacks))
    return ("leaf", len(stacks) - 1)


def _fit_depth(sig, budget, stacks):
    if sig[0] == "leaf" or _depth(sig) <= budget:
        return sig
    if budget == 1:
        return _plane_leaf(sig, stacks)
    op, subs = sig
    return (op, (_fit_depth(subs[0], budget, stacks),)
            + tuple(_fit_depth(s, budget - 1, stacks) for s in subs[1:]))


def _best_group(sig, counts):
    """(path, k) of the group whose fold removes the most excess per
    torch step, ties to the larger gain: the first k operands of the node
    reached by following child indices `path` from the root. Folding the
    whole root always removes all of it, so some group gains."""
    n_slots, total = len(counts), sum(counts.values())
    excess = _excess(n_slots, total)
    best, best_key = None, None
    todo = [((), sig)]
    while todo:
        path, node = todo.pop()
        if node[0] == "leaf":
            continue
        group, complete, n = {}, 0, 0
        for k, sub in enumerate(node[1], start=1):
            todo.append((path + (k - 1,), sub))
            for slot, c in _leaf_slots(sub, {}).items():
                group[slot] = group.get(slot, 0) + c
                complete += group[slot] == counts[slot]
                n += c
            if k < 2:
                continue
            # the plane replaces n occurrences (n - 1 torch steps) and the
            # `complete` slots that occur only inside the group
            gain = excess - _excess(n_slots - complete + 1, total - n + 1)
            key = (gain / (n - 1), gain)
            if best_key is None or key > best_key:
                best, best_key = (path, k), key
    return best


def _fold(sig, path, k, stacks):
    if path:
        op, subs = sig
        i = path[0]
        return (op, subs[:i] + (_fold(subs[i], path[1:], k, stacks),)
                + subs[i + 1:])
    op, subs = sig
    leaf = _plane_leaf((op, subs[:k]), stacks)
    return leaf if k == len(subs) else (op, (leaf,) + subs[k:])


def _renumber(sig, slot):
    if sig[0] == "leaf":
        return ("leaf", slot[sig[1]])
    return (sig[0], tuple(_renumber(s, slot) for s in sig[1]))


def tree_eval(sig, stacks):
    """Plain PyTorch tree evaluation over aligned int32 stacks — THE
    expression semantics of the port (the TPU package's
    StackedEvaluator._tree_eval)."""
    if sig[0] == "leaf":
        return stacks[sig[1]]
    op, subs = sig
    acc = tree_eval(subs[0], stacks)
    for sub in subs[1:]:
        p = tree_eval(sub, stacks)
        if op == "&":
            acc = acc & p
        elif op == "|":
            acc = acc | p
        elif op == "^":
            acc = acc ^ p
        elif op == "-":
            acc = acc & ~p
        else:
            raise ValueError(f"unknown op {op!r}")
    return acc


def popcount_words(x):
    """Per-word popcount of int32 words (SWAR). int32 `>>` is arithmetic,
    so every shifted term is masked before it is added."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def popcount_total(x):
    """Exact int64 Σ popcount over an int32 tensor (0-d tensor)."""
    return popcount_words(x).sum(dtype=torch.int64)


def count_expr_reference(sig, stacks):
    """The plain version of K1: tree-eval, SWAR popcount, int64 sum."""
    _check_stacks(sig, stacks)
    if stacks[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=stacks[0].device)
    return popcount_total(tree_eval(sig, stacks))


def _check_stacks(sig, stacks):
    stacks = list(stacks)
    if not stacks:
        raise ValueError("count_expr needs at least one leaf stack")
    if max(_leaf_slots(sig, {})) >= len(stacks):
        raise ValueError("signature names a leaf slot with no stack")
    first = stacks[0]
    for s in stacks:
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"leaf stack must be a tensor, got {type(s)}")
        if s.dtype != torch.int32:
            raise TypeError(f"leaf stack dtype {s.dtype} != torch.int32")
        if s.dim() != 2 or s.shape != first.shape:
            raise ValueError(
                f"leaf stacks must share one [S, W] shape: "
                f"{tuple(s.shape)} vs {tuple(first.shape)}")
        if s.device != first.device:
            raise ValueError("leaf stacks lie on different devices")
    return stacks


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/count_expr.cu (built at first use)."""
    fn = cuda_build.load("count_expr").count_expr_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _launch(sig, stacks):
    fn = _kernel_fn()
    code = compile_program(sig)
    for s in stacks:
        if not s.is_contiguous():
            raise ValueError("leaf stacks must be contiguous")
        if s.data_ptr() % 16:
            raise ValueError("leaf stacks must be 16-byte aligned")
    if stacks[0].shape[1] % 4:
        raise ValueError("words per shard must be a multiple of 4")
    out = torch.empty((1,), dtype=torch.int64, device=stacks[0].device)
    ptrs = (ctypes.c_void_p * len(stacks))(*[s.data_ptr() for s in stacks])
    stream = torch.cuda.current_stream(stacks[0].device).cuda_stream
    err = fn(ptrs, len(stacks), code, len(code), stacks[0].numel(),
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"count_expr kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(count_expr)
    return out[0]


def count_expr(sig, stacks):
    """Σ popcount(tree(stacks)) as a 0-d int64 tensor on the stacks'
    device. A tree beyond K1's limits is first brought within them by
    `fit_tree`, on every device. CPU stacks then take the plain version;
    CUDA stacks launch K1 once (an empty stack returns 0 without a
    launch)."""
    sig, stacks = fit_tree(sig, _check_stacks(sig, stacks))
    dev = stacks[0].device
    if dev.type == "cpu":
        return count_expr_reference(sig, stacks)
    if dev.type != "cuda":
        raise ValueError(f"count_expr: unsupported device {dev}")
    if stacks[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    return _launch(sig, stacks)


#: K1 launches since the last reset (read by chip_smoke.py)
count_expr.launches = 0


def count_expr_cost(n_leaves, s, w, device=None):
    """K1's declared cost for one launch over `n_leaves` [S, W] stacks:
    each leaf read once, one int64 written (cuda_build.declared_cost)."""
    return cuda_build.declared_cost(n_leaves * s * w * 4 + 8, device)


def count_expr_stack(first, rest, ops):
    """`count_expr_stack` of the TPU package: Σ popcount of the chain
    `ops` folded left-to-right over (first, *rest)."""
    return count_expr(chain_signature(1 + len(rest), ops), [first, *rest])


def count_expr_batch_reference(sig, stacks_per_member):
    """The plain version of K1's batched entry: one `count_expr_reference`
    per member, as a [B] int64 tensor."""
    return torch.stack([count_expr_reference(sig, stacks)
                        for stacks in stacks_per_member])


@functools.lru_cache(maxsize=None)
def _batch_kernel_fn():
    """The batched C entry point of csrc/count_expr.cu."""
    fn = cuda_build.load("count_expr").count_expr_batch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch_batch(sig, members):
    fn = _batch_kernel_fn()
    code = compile_program(sig)
    first = members[0][0]
    for stacks in members:
        for s in stacks:
            if not s.is_contiguous():
                raise ValueError("leaf stacks must be contiguous")
            if s.data_ptr() % 16:
                raise ValueError("leaf stacks must be 16-byte aligned")
    if first.shape[1] % 4:
        raise ValueError("words per shard must be a multiple of 4")
    dev = first.device
    # [B, n] leaf pointers, copied from pinned memory without a wait: the
    # host allocator keeps the pinned rows until the copy has run
    table = torch.tensor([[s.data_ptr() for s in stacks]
                          for stacks in members],
                         dtype=torch.int64).pin_memory().to(
                             dev, non_blocking=True)
    out = torch.empty((len(members),), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(code, len(code), table.data_ptr(), len(members[0]),
             len(members), first.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"count_expr_batch kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(count_expr_batch)
    return out


def count_expr_batch(sig, stacks_per_member):
    """[B] int64 tensor of Σ popcount(tree(stacks)) for each member's
    stacks, all members over one signature `sig`. `fit_tree` runs per
    member first, and every member must come out with the same fitted
    signature. Every member's stacks must share one [S, W] shape, dtype
    and device. CPU stacks take the plain version; CUDA stacks launch the
    batched kernel once (an empty stack returns zeros without a
    launch)."""
    members = [_check_stacks(sig, stacks) for stacks in stacks_per_member]
    if not members:
        raise ValueError("count_expr_batch needs at least one member")
    first = members[0][0]
    for stacks in members:
        s = stacks[0]
        if s.shape != first.shape or s.dtype != first.dtype \
                or s.device != first.device:
            raise ValueError(
                f"members' leaf stacks must share one [S, W] shape, dtype "
                f"and device: {tuple(s.shape)} {s.dtype} {s.device} vs "
                f"{tuple(first.shape)} {first.dtype} {first.device}")
    fitted = [fit_tree(sig, stacks) for stacks in members]
    fsig = fitted[0][0]
    if any(f[0] != fsig or len(f[1]) != len(fitted[0][1]) for f in fitted):
        raise AssertionError(
            "members of one signature fitted to different trees")
    members = [f[1] for f in fitted]
    dev = first.device
    if dev.type == "cpu":
        return count_expr_batch_reference(fsig, members)
    if dev.type != "cuda":
        raise ValueError(f"count_expr_batch: unsupported device {dev}")
    if first.shape[0] == 0:
        return torch.zeros((len(members),), dtype=torch.int64, device=dev)
    return _launch_batch(fsig, members)


#: launches of the batched entry since the last reset (read by
#: chip_smoke.py)
count_expr_batch.launches = 0


def count_expr_batch_cost(b, n_leaves, s, w, device=None):
    """The batched entry's declared cost for B members of `n_leaves`
    [S, W] stacks each: every member's leaves and its row of the [B, n]
    int64 pointer table read once, B int64 totals written."""
    return cuda_build.declared_cost(
        b * n_leaves * (s * w * 4 + 8) + 8 * b, device)


def count_expr_multi_reference(sigs, stacks_per_member):
    """The plain version of K1's multi-tree entry: one
    `count_expr_reference` per member, as an [n] int64 tensor."""
    return torch.stack([count_expr_reference(sig, stacks)
                        for sig, stacks in zip(sigs, stacks_per_member)])


#: int32 words of one member's descriptor in the multi-tree program table
#: (K1M_DESC in csrc/count_expr.cu)
MULTI_DESC = 5


def _is_chain(code):
    """True for L0 L1 op L2 op ... (csrc/count_expr.cu's is_chain)."""
    if len(code) % 2 == 0 or code[0] >= MAX_LEAVES:
        return False
    return all((k % 2 == 1) == (code[k] < MAX_LEAVES)
               for k in range(1, len(code)))


class MultiProgram:
    """The program table of K1's multi-tree entry for one list of member
    signatures (each within K1's limits): per member MULTI_DESC int32 —
    code offset, code length, leaf offset, leaf count, chain flag — then
    every member's postfix code bytes, zero-padded to whole int32 words.
    `bind` builds it on the host (again only when the signatures change);
    `table` copies it to a device once and keeps the copy, so a cached
    program costs a launch only its leaf pointers."""

    __slots__ = ("sigs", "n_leaves", "host", "_tables")

    def __init__(self):
        self.sigs = None
        self.n_leaves = None
        self.host = None
        self._tables = {}

    def bind(self, sigs, n_leaves):
        sigs, n_leaves = tuple(sigs), tuple(int(n) for n in n_leaves)
        if sigs == self.sigs and n_leaves == self.n_leaves:
            return self
        desc, codes, leaf_off = [], b"", 0
        for sig, n in zip(sigs, n_leaves):
            if not 1 <= n <= MAX_LEAVES:
                raise ValueError(f"member of {n} leaves outside "
                                 f"1..{MAX_LEAVES}")
            code = compile_program(sig)
            desc.extend((len(codes), len(code), leaf_off, n,
                         int(_is_chain(code))))
            codes += code
            leaf_off += n
        codes += bytes(-len(codes) % 4)
        self.host = torch.cat([
            torch.tensor(desc, dtype=torch.int32),
            torch.frombuffer(bytearray(codes), dtype=torch.int32)])
        self.sigs, self.n_leaves = sigs, n_leaves
        self._tables = {}
        return self

    def table(self, device):
        """The table on `device`, copied there on first use."""
        t = self._tables.get(str(device))
        if t is None:
            t = self.host.pin_memory().to(device, non_blocking=True)
            self._tables[str(device)] = t
        return t


@functools.lru_cache(maxsize=None)
def _multi_kernel_fn():
    """The multi-tree C entry point of csrc/count_expr.cu."""
    fn = cuda_build.load("count_expr").count_expr_multi_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch_multi(program, members):
    fn = _multi_kernel_fn()
    first = members[0][0]
    for stacks in members:
        for s in stacks:
            if not s.is_contiguous():
                raise ValueError("leaf stacks must be contiguous")
            if s.data_ptr() % 16:
                raise ValueError("leaf stacks must be 16-byte aligned")
    if first.shape[1] % 4:
        raise ValueError("words per shard must be a multiple of 4")
    dev = first.device
    table = program.table(dev)
    # the leaf pointers, copied from pinned memory without a wait: the
    # host allocator keeps the pinned buffer until the copy has run
    ptrs = torch.tensor([s.data_ptr() for stacks in members for s in stacks],
                        dtype=torch.int64).pin_memory().to(
                            dev, non_blocking=True)
    out = torch.empty((len(members),), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(table.data_ptr(), len(members), ptrs.data_ptr(), first.numel(),
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"count_expr_multi kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(count_expr_multi)
    return out


def count_expr_multi(sigs, stacks_per_member, program=None):
    """[n] int64 tensor of Σ popcount(sigs[i](stacks_per_member[i])): n
    trees that need not share a signature or a leaf count, each over its
    own stacks. `fit_tree` runs per member first. Every stack of every
    member must share one [S, W] shape, dtype and device. CPU stacks take
    the plain version; CUDA stacks launch the multi-tree kernel once (an
    empty stack returns zeros without a launch). `program`, a
    MultiProgram, keeps the program table between calls (it is rebound
    when the fitted signatures differ)."""
    sigs = list(sigs)
    if len(sigs) != len(stacks_per_member):
        raise ValueError(f"{len(sigs)} signatures for "
                         f"{len(stacks_per_member)} members")
    if not sigs:
        raise ValueError("count_expr_multi needs at least one member")
    members = [_check_stacks(sig, stacks)
               for sig, stacks in zip(sigs, stacks_per_member)]
    first = members[0][0]
    for stacks in members:
        s = stacks[0]
        if s.shape != first.shape or s.dtype != first.dtype \
                or s.device != first.device:
            raise ValueError(
                f"members' leaf stacks must share one [S, W] shape, dtype "
                f"and device: {tuple(s.shape)} {s.dtype} {s.device} vs "
                f"{tuple(first.shape)} {first.dtype} {first.device}")
    fitted = [fit_tree(sig, stacks) for sig, stacks in zip(sigs, members)]
    fsigs = [f[0] for f in fitted]
    members = [f[1] for f in fitted]
    dev = first.device
    if dev.type == "cpu":
        return count_expr_multi_reference(fsigs, members)
    if dev.type != "cuda":
        raise ValueError(f"count_expr_multi: unsupported device {dev}")
    if first.shape[0] == 0:
        return torch.zeros((len(members),), dtype=torch.int64, device=dev)
    program = (program if program is not None else MultiProgram()).bind(
        fsigs, [len(m) for m in members])
    return _launch_multi(program, members)


#: launches of the multi-tree entry since the last reset (read by
#: chip_smoke.py)
count_expr_multi.launches = 0


def count_expr_multi_cost(leaf_counts, s, w, device=None):
    """The multi-tree entry's declared cost for members of `leaf_counts`
    [S, W] stacks each: every member's leaves read once, its descriptor
    (MULTI_DESC int32), its code (2n - 1 bytes for n leaf slots each
    used once) and its leaf pointers read once, one int64 total written
    per member."""
    n, leaves = len(leaf_counts), sum(leaf_counts)
    return cuda_build.declared_cost(
        leaves * s * w * 4 + 4 * MULTI_DESC * n
        + sum(2 * k - 1 for k in leaf_counts) + 8 * leaves + 8 * n, device)
