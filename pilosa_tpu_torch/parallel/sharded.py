"""Sharded query execution over a group of ranks.

The TPU package maps the reference's scale-out axis (shards
range-partitioned over nodes, results tree-reduced over HTTP; reference:
executor.mapReduce executor.go:2455) onto a `jax.sharding.Mesh` axis:
stacks shard across devices and the reduce is an XLA-inserted psum. The
port maps it onto a `torch.distributed` process group, one rank per
device: each rank holds a contiguous slice of the global [S, W] stack on
its own device, counts it with the port's hand-written kernel (K1
count_expr, K3 row_counts, K4 pairwise_counts), and the int64 partials
meet in ONE `all_reduce` per step. A rank may also drive several local
parts, as a TPU host drives every local chip: its slice splits again
into one contiguous range per part, each kernel launches once per part,
and the partials sum in the process before the one `all_reduce`.

Two groups: the control group (gloo, the world by default) and the data
group. Where every rank has a card of its own (`collective_backend`),
the data group is NCCL and a partial is reduced ON its card, as the TPU
package's psum reduces on the device, then fetched once. Otherwise
(ranks on the CPU, or sharing a card: NCCL refuses two ranks on one)
there is no data group of its own: the partial is fetched and reduced
over the gloo group, with any extra slots in the same collective.

Two layers:
- `QueryKernels`: stacked-plane kernels on one device, one launch for
  every shard of the stack.
- `ShardedQueryEngine`: one rank's view of the group, its devices and
  its slice of each stack, and the collective steps.

A group of size 1 needs no launcher: without an initialized process
group the engine is one rank and reduces nothing. Nothing here imports
torch at module import (trap 19).
"""

import numpy as np

__all__ = ["QueryKernels", "ShardedQueryEngine", "apply_op_chain",
           "build_global_mesh", "card_identity", "collective_backend"]


def apply_op_chain(acc, planes, ops):
    """Fold an operator chain (e.g. "&|") left-to-right over aligned
    plane stacks — THE definition of expression semantics, shared by the
    single-device and group paths."""
    from ..ops.count_expr import chain_signature, tree_eval

    if len(ops) != len(planes):
        raise ValueError(
            f"op chain length {len(ops)} != operand count {len(planes)}")
    return tree_eval(chain_signature(1 + len(planes), tuple(ops)),
                     [acc, *planes])


def _dist():
    import torch.distributed as dist

    return dist


def build_global_mesh(group=None):
    """The ordered global ranks of `group` (default: the world), one
    rank per device, process-major — the counterpart of the TPU
    package's 1-D mesh over the global device list. Every rank builds
    the same list, which is what collectives need to line up. Without an
    initialized process group it is the lone rank [0]."""
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized():
        return [0]
    if group is None:
        return list(range(dist.get_world_size()))
    return sorted(dist.get_process_group_ranks(group))


def card_identity(device):
    """This rank's identity for the backend choice: "cpu", or (hostname,
    UUID of the card) for a CUDA device. Cards compare by UUID, never
    by index: cuda:0 on two hosts is two cards."""
    import socket

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return (socket.gethostname(),
            str(torch.cuda.get_device_properties(index).uuid))


def collective_backend(identities, nccl_available):
    """"nccl" when every rank (its `card_identity`, in rank order) is on
    a card, no two ranks share a card, and NCCL is available; else
    "gloo". Every rank computes it from the same list, so every rank
    makes the same choice."""
    ids = [tuple(i) if isinstance(i, (list, tuple)) else i
           for i in identities]
    if not ids or not nccl_available or any(i == "cpu" for i in ids):
        return "gloo"
    return "nccl" if len(set(ids)) == len(ids) else "gloo"


_count_expr_cache = {}


def _count_expr_fn(ops, arity):
    """Module-cached fused expression count over `arity` aligned [S, W]
    stacks: a function returning Σ popcount of the chain `ops` as a 0-d
    int64 tensor on the stacks' device (one K1 launch on a CUDA tensor,
    K1's plain version on a CPU one)."""
    fn = _count_expr_cache.get((ops, arity))
    if fn is None:
        from ..ops.count_expr import chain_signature, count_expr

        sig = chain_signature(arity, tuple(ops))

        def fn(*planes):
            return count_expr(sig, planes)

        _count_expr_cache[(ops, arity)] = fn
    return fn


class QueryKernels:
    """Stacked-plane kernels: each is ONE launch for all shards."""

    @staticmethod
    def count_intersect(a, b):
        """Σ_shards popcount(a & b) — the north-star query."""
        return QueryKernels.count_expr([a, b], "&")

    @staticmethod
    def count_expr(planes, ops):
        """Exact Python int Σ popcount of the op chain `ops` (e.g. "&|^")
        folded left-to-right over the aligned [S, W] stacks `planes`."""
        return int(_count_expr_fn(tuple(ops), len(planes))(*planes))


class ShardedQueryEngine:
    """One rank of a group: its devices, its slice of every stack, and
    the query steps — a local launch of K1, K3 or K4 over the slice (once
    per local part), then ONE all_reduce of the int64 partials (the
    counterpart of the TPU package's shard_map + psum).

    `devices`: this rank's parts (`device.resolve_devices`: a
    torch.device or name, a comma list or a list, a card or the CPU
    repeated to split it), every visible card by default, as the TPU
    package's engine takes every device. Every rank of a group drives as
    many parts. `group`: the gloo control group, the world by default;
    without an initialized process group the engine is a group of
    one. `data_group`: a group of the same ranks for the data
    collectives, always used when given, even a group of one. On it a
    step takes two phases: extra slots ride the control group first
    (`vote`), then the partial rides the data group, on the card when
    it is NCCL (the first part's card, which must be the rank's NCCL
    card) or fetched first when it is gloo. Without one, the partial and
    its extra slots are fetched and ride ONE collective of the control
    group."""

    def __init__(self, devices=None, group=None, data_group=None):
        from ..device import resolve_devices

        self.devices = resolve_devices(devices)
        self.device = self.devices[0]
        self.group = group
        self.data_group = data_group
        dist = _dist()
        self._distributed = dist.is_available() and dist.is_initialized()
        self.mesh = build_global_mesh(group)
        self.rank = self.mesh.index(dist.get_rank()) \
            if self._distributed else 0
        #: "nccl" or "gloo": the backend the partials are reduced over
        self.collective_backend = "gloo" if data_group is None \
            else str(dist.get_backend(data_group)).lower()
        if self.collective_backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL data group needs the rank's parts on "
                             "its card")
        #: data collectives this engine entered (all_reduce and
        #: all_gather over the data group)
        self.data_collectives = 0

    @property
    def n_ranks(self):
        """Ranks in the group."""
        return len(self.mesh)

    @property
    def n_devices(self):
        """Parts in the group: ranks x each rank's local parts (the TPU
        package's mesh size)."""
        return len(self.mesh) * len(self.devices)

    def pad_shards(self, n_shards):
        """Shard count padded to a multiple of the group's parts (padding
        shards are all-zero planes and cannot affect set-algebra
        results)."""
        d = self.n_devices
        return ((n_shards + d - 1) // d) * d

    def place(self, stack):
        """This rank's contiguous slice of a global host stack on its
        device, as int32 words: [S, W] slices rows, [R, S, W] (and
        [D, S, W]) slices the shard axis, which is always the one before
        the words. With several local parts, a list of the slice's
        contiguous pieces, one on each part's device. S must be a
        multiple of the group's parts (`pad_shards`)."""
        import torch

        if isinstance(stack, torch.Tensor):
            stack = stack.cpu().numpy()
        stack = np.asarray(stack)
        axis = stack.ndim - 2
        n = stack.shape[axis]
        if n % self.n_devices:
            raise ValueError(
                f"{n} shards do not split over {self.n_devices} parts; "
                "pad with pad_shards")
        per = n // self.n_devices
        pieces = [
            torch.from_numpy(np.ascontiguousarray(np.take(
                stack, range(first * per, (first + 1) * per),
                axis=axis)).view(np.int32)).to(dev)
            for first, dev in enumerate(self.devices,
                                        self.rank * len(self.devices))]
        return pieces[0] if len(pieces) == 1 else pieces

    def _per_part(self, fn, *args):
        """`fn` over this rank's slices: once per local part where the
        arguments are `place`'s lists of pieces (an argument that is not
        a list goes to every part), the int64 partials summed on the
        first part's device."""
        if not any(isinstance(a, list) for a in args):
            return fn(*args)
        outs = [fn(*[a[p] if isinstance(a, list) else a for a in args])
                for p in range(len(self.devices))]
        total = outs[0]
        for o in outs[1:]:
            total = total + o.to(total.device)
        return total

    # -- the collectives ----------------------------------------------------

    def _all_reduce(self, partial, extra=None):
        """Σ over the group of each rank's int64 `partial`, as a host
        tensor. Without a data group: the partial fetched, then ONE
        all_reduce over the control group (nothing for a group of one),
        `extra` (host int64 values, the data plane's failure slots)
        riding after the partial. With one: `extra` reduced over the
        control group first (`vote`), then the partial over the data
        group (`_data_reduce`) and fetched once. With `extra` the call
        returns (partial sums, extra sums)."""
        import torch

        if self.data_group is not None:
            tail = None if extra is None else self.vote(extra)
            sums = self._data_reduce(partial).cpu()
            return sums if extra is None else (sums, tail)
        partial = partial.cpu().reshape(-1)
        n = partial.numel()
        buf = partial.contiguous() if extra is None else torch.cat(
            [partial, torch.as_tensor(extra, dtype=torch.int64).reshape(-1)])
        if self._distributed and self.n_ranks > 1:
            _dist().all_reduce(buf, group=self.group)
        return buf if extra is None else (buf[:n], buf[n:])

    def vote(self, slots):
        """Σ over the control group (gloo, host int64) of each rank's
        `slots`: the data plane's failure and step slots, which never
        ride an NCCL collective."""
        import torch

        buf = torch.as_tensor(slots, dtype=torch.int64).cpu().reshape(-1) \
            .clone()
        if self._distributed and self.n_ranks > 1:
            _dist().all_reduce(buf, group=self.group)
        return buf

    def _on_data_side(self, t):
        """`t` where the data group reduces it: on this rank's card for
        NCCL, on the host for gloo; int64, flat, contiguous."""
        import torch

        t = torch.as_tensor(t, dtype=torch.int64).reshape(-1)
        if self.collective_backend == "nccl":
            return t.to(self.device).contiguous()
        return t.cpu().contiguous()

    def _data_reduce(self, partial):
        """ONE all_reduce of the int64 `partial` over the data group,
        where it lives: on the card for NCCL (the result stays there;
        the caller fetches it once), on the host for gloo. NCCL runs on
        its own stream: the collective waits for the launches queued on
        the card's current stream, and the current stream waits for the
        collective, so a fetch after it reads the sums."""
        t = self._on_data_side(partial)
        with self._on_card():
            _dist().all_reduce(t, group=self.data_group,
                               async_op=True).wait()
        self.data_collectives += 1
        return t

    def _all_gather(self, row):
        """Every rank's int64 `row` as one [ranks, n] tensor in group rank
        order: ONE all_gather over the data group (on the card for NCCL,
        left there for the caller's one fetch), or without one, of host
        rows over the control group (this rank's row alone without a
        process group)."""
        import torch

        dist = _dist()
        row = self._on_data_side(row)
        if self.data_group is None and not self._distributed:
            return row.reshape(1, -1)
        group = self.group if self.data_group is None else self.data_group
        rows = [torch.zeros_like(row)
                for _ in range(dist.get_world_size(group))]
        with self._on_card():
            dist.all_gather(rows, row, group=group, async_op=True).wait()
        if self.data_group is not None:
            self.data_collectives += 1
        return torch.stack(rows)

    def _on_card(self):
        """The rank's card as the current device for an NCCL call (a
        no-op context otherwise)."""
        import contextlib

        if self.collective_backend != "nccl":
            return contextlib.nullcontext()
        import torch

        return torch.cuda.device(self.device)

    # -- the local partials: one kernel path each, no collective ------------

    @staticmethod
    def count_partial(sig, planes):
        """K1: Σ popcount of the count tree `sig` over this rank's
        aligned [S, W] slices, a [1] int64 tensor on their device."""
        from ..ops.count_expr import count_expr

        return count_expr(sig, planes).reshape(1)

    @staticmethod
    def count_batch_partial(sigs, members, program=None):
        """K Count trees over this rank's slices in ONE K1 launch, a [K]
        int64 tensor on their device: K1's batched entry when every tree
        has one signature and leaf count (bucket padding makes that
        common), else its multi-tree entry (`program`, a MultiProgram,
        keeps that entry's table between calls). Trees past K1's limits
        are fitted by the entries themselves (fit_tree)."""
        from ..ops.count_expr import count_expr_batch, count_expr_multi

        sigs = list(sigs)
        if len(set(sigs)) == 1 and len({len(m) for m in members}) == 1:
            return count_expr_batch(sigs[0], members)
        return count_expr_multi(sigs, members, program=program)

    @staticmethod
    def row_counts_partial(stack, filt=None):
        """K3: per-row popcount(row & filt) of this rank's [R, S, W] (or
        [R, S·W]) slice, an int64 [R] tensor on its device."""
        from ..ops.row_counts import row_counts

        r = int(stack.shape[0])
        return row_counts(stack.reshape(r, -1),
                          None if filt is None else filt.reshape(-1))

    @staticmethod
    def pairwise_partial(a, b, filt=None):
        """K4: the [R1, R2] Σ popcount(a[i] & filt & b[j]) of this rank's
        row slices a [R1, ...] and b [R2, ...], int64 on their device."""
        from ..ops.pairwise import pairwise_counts

        r1, r2 = int(a.shape[0]), int(b.shape[0])
        return pairwise_counts(a.reshape(r1, -1), b.reshape(r2, -1),
                               None if filt is None else filt.reshape(-1))

    @staticmethod
    def sum_partial(planes, sign, exists, filt=None):
        """K3 three times: per-plane positive and negative counts and
        the consider count of this rank's slices, an int64 [2D + 1]
        tensor on their device."""
        import torch

        from ..ops.bsi import bsi_plane_counts

        pos, neg, count = bsi_plane_counts(planes, sign, exists, filt)
        return torch.cat([pos, neg, count.reshape(1)])

    @staticmethod
    def sum_fold(vals, depth):
        """(total, count) of the group's reduced [2D + 1] Sum counts: the
        signed fold in Python ints (reference per-shard algorithm:
        fragment.sum fragment.go:1068)."""
        total = 0
        for i in range(depth):
            total += (vals[i] - vals[depth + i]) << i
        return total, vals[2 * depth]

    @staticmethod
    def top_k(totals, k):
        """The k largest of the reduced [R] counts, ties to the lowest
        row (trap 4): (totals [k] int64, order [k] int32)."""
        totals = np.asarray(totals, dtype=np.int64)
        order = np.lexsort((np.arange(len(totals)), -totals))[:k]
        return totals[order], order.astype(np.int32)

    # -- query steps: a local partial, then ONE all_reduce ------------------

    def count_intersect(self, a, b):
        """Distributed Intersect+Count: K1 over each rank's slice, one
        all_reduce of the int64 totals."""
        return self.query_step([a, b], "&")

    def query_step(self, planes, ops):
        """Distributed fused expression count: `planes` are this rank's
        [S, W] slices, `ops` the operator chain (QueryKernels.count_expr).
        One K1 launch, one all_reduce."""
        total = self._per_part(_count_expr_fn(tuple(ops), len(planes)),
                               *planes)
        return int(self._all_reduce(total.reshape(1))[0])

    def topn_step(self, stack, filter_stack, k):
        """Distributed TopN over a [R, S, W] row×shard slice: K3's
        per-row counts of row ∩ filter, one all_reduce of [R], then the
        top k on the host. Returns (totals [k] int64, order [k] int32)."""
        counts = self._per_part(self.row_counts_partial, stack, filter_stack)
        return self.top_k(self._all_reduce(counts).numpy(), k)

    def pairwise_step(self, a, b, filt=None):
        """Distributed pairwise intersect-count matrix (the GroupBy cross
        product) of row slices a [R1, S, W] and b [R2, S, W], with an
        optional filter slice [S, W]: K4 over the slices, one all_reduce
        of [R1, R2]. Returns the host int64 [R1, R2] matrix."""
        counts = self._per_part(self.pairwise_partial, a, b, filt)
        return self._all_reduce(counts).numpy().astype(np.int64).reshape(
            counts.shape)

    def sum_step(self, planes, sign, exists, filt):
        """Distributed BSI Sum: K3 three times over the slices, ONE
        all_reduce of the [2D + 1] counts, then the signed fold. planes
        [D, S, W]; sign, exists, filt [S, W] (filt may be None). Returns
        (total, count)."""
        vals = self._all_reduce(
            self._per_part(self.sum_partial, planes, sign, exists, filt))
        depth = (planes[0] if isinstance(planes, list) else planes).shape[0]
        return self.sum_fold(vals.tolist(), int(depth))
