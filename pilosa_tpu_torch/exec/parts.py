"""One node over several parts: every stack split along the shard axis.

The TPU package serves a node from every local chip. It places each
cached stack with `NamedSharding(Mesh(jax.local_devices(), ("shards",)),
PartitionSpec("shards"))`, zero-pads the shard axis to a multiple of the
device count (`_padded_len`, pilosa_tpu/exec/stacked.py:535-590), and XLA
partitions every launch over the mesh and inserts the reduce. The port
does the same by hand over a list of torch devices (`device.
resolve_devices`: every visible card, or named parts, a card repeated to
split it):

- The layout. S shards pad to S_pad = k * ceil(S / k); part p holds the
  contiguous positions [p * n, (p + 1) * n) of the padded list, n =
  S_pad / k, as the mesh lays out `PartitionSpec("shards")`. Padding
  positions carry shard ids -1, -2, ... that no fragment has, so a part
  gathers zero planes for them and every filter and row stack of a part
  lines up with every other of that part.
- The caches. Each part is a StackedEvaluator on its device (`parts`)
  with its own pools (1/k of each budget, so the node's bytes count
  against the TPU package's budgets), its cache validation and in-place
  patches (a write reaches only the part that holds its shard), its
  compressed containers and its gather-side launches (K5 masks, time
  unions, Shift planes). The ingest merge folds each part's pools.
  Where the TPU package uploads a compressed container replicated over
  the mesh (`_place_replicated`: a GSPMD program needs each operand
  sharded or replicated, and a compressed array has no shard axis), the
  port builds one container per part from that part's range: a
  block-sparse part keeps its own blocks with ids from its first shard,
  a run-length part its own runs, and each card counts its own with K2
  or the run sums and holds nothing of another's. A part's chooser sees
  its own range, so it may pick another repr than a one-part node does;
  answers agree, reprs need not.
- The launches. Every entry has one body, StackedEvaluator's: it asks
  this evaluator for each part's containers or tensors (`_leaf_parts`,
  `_tensors`, `_plan_parts`), launches the kernel entry once a part on
  that part's card (`cuda_build.on_card`) under ONE hold of the dispatch
  lock, and sums the int64 partials exactly on the first part's card
  (`_reduce`) before one fetch. TopN's per-row counts and GroupBy's
  cells are summed before the caller takes its top-k or its limit;
  Min/Max combines each part's walk by the collective plane's rule
  (`cluster.spmd.combine_minmax`: -0 below +0, counts summed at the
  extreme, empty parts never win).

This module keeps the layout (`split`, the padding), the gathers that
route to the parts (`_gather`, `leaf_stack`, `rows_stack`, `bsi_stack`,
the residency probes) and the node's counters. The node caches nothing
itself: a lookup that reaches its own pools raises. With one part the
executor keeps a plain StackedEvaluator: no padding, one launch per
Count.
"""

import torch

from ..core.view import VIEW_STANDARD
from .stacked import StackedEvaluator


class PartedLeaf:
    """One leaf of a gathered tree over every part: a Container per part.
    Its container and grouping signatures are the parts' in part order,
    so two trees group (and fuse) only when every part agrees."""

    __slots__ = ("parts", "n_shards")

    def __init__(self, parts, n_shards):
        self.parts = tuple(parts)
        self.n_shards = n_shards

    @property
    def csig(self):
        return tuple(c.csig for c in self.parts)

    @property
    def gsig(self):
        return tuple(c.gsig for c in self.parts)

    @property
    def nbytes(self):
        return sum(c.nbytes for c in self.parts)

    @property
    def shape(self):
        """[S, W] of the leaf over the node's shards, the padding left
        out."""
        return (self.n_shards, *self.parts[0].shape[1:])


class Parted:
    """A plane stack split over the parts: one tensor per part, the shard
    axis (the one before the words) cut into the parts' ranges, padding
    at the end of the last. Indexing a row, `&` and `reshape` act part
    by part."""

    __slots__ = ("parts", "n_shards")

    def __init__(self, parts, n_shards):
        self.parts = list(parts)
        self.n_shards = n_shards

    def __getitem__(self, i):
        return Parted([t[i] for t in self.parts], self.n_shards)

    def __and__(self, other):
        return Parted([a & b for a, b in zip(self.parts, other.parts)],
                      self.n_shards)

    def reshape(self, *shape):
        return Parted([t.reshape(*shape) for t in self.parts], self.n_shards)

    def numel(self):
        return sum(t.numel() for t in self.parts)


class PartedEvaluator(StackedEvaluator):
    """The stacked path of a node over `devices` (two or more parts):
    StackedEvaluator's entries over the parts (`parts`, one
    StackedEvaluator a device entry, each with 1/k of the budgets), which
    share this node's attribution tables, so /debug/dispatch and
    /debug/kernels read one node."""

    def __init__(self, devices):
        devices = [torch.device(d) for d in devices]
        if len(devices) < 2:
            raise ValueError("a parted node needs two or more parts")
        super().__init__(devices[0])
        self.devices = devices
        self.parts = [StackedEvaluator(d, budget_parts=len(devices))
                      for d in devices]
        self._cards = tuple(dict.fromkeys(devices))
        for part in self.parts:
            part._siblings = tuple(self.parts)
            part._kernels = self._kernels
            part._dispatch_phases = self._dispatch_phases
            part._fn_specs = self._fn_specs
            part._kernel_costs = self._kernel_costs
            part._count_spec_keys = self._count_spec_keys

    def _cache_get(self, key, gens, stamp=None):
        # every pool lookup passes here (the fast path never hits an
        # empty pool): the parts hold every stack
        raise RuntimeError(f"a node of {len(self.parts)} parts caches "
                           f"nothing itself ({key[0]} stack of "
                           f"{key[1]}/{key[2]}): route through its parts")

    # -- layout --------------------------------------------------------------

    def _padded_len(self, shards):
        """S zero-padded to a multiple of the part count (the TPU
        package's `_padded_len` over its mesh)."""
        k = len(self.parts)
        return -(-len(shards) // k) * k

    def split(self, shards):
        """Each part's contiguous range of the padded shard list; padding
        positions are the shard ids -1, -2, ..., which no fragment has."""
        shards = tuple(shards)
        k = len(self.parts)
        n = self._padded_len(shards) // k
        padded = shards + tuple(-1 - i for i in range(n * k - len(shards)))
        return [padded[p * n:(p + 1) * n] for p in range(k)]

    def _caches(self):
        return self.parts

    def _tensors(self, stack):
        if stack is None:
            return [None] * len(self.parts)
        return stack.parts

    def _join(self, tensors, n_shards):
        return Parted(tensors, n_shards)

    def _leaf_parts(self, stacks):
        return [[s.parts[p] for s in stacks] for p in range(len(self.parts))]

    def _plan_parts(self, plans):
        return [tuple((sig, tuple(leaf[p] for leaf in csig))
                      for sig, csig in plans)
                for p in range(len(self.parts))]

    # -- counters and ledgers ------------------------------------------------

    _SUMMED = ("hits", "misses", "evictions", "patches", "stale_serves",
               "planes_uploaded", "entries", "bytes", "rows_entries",
               "rows_bytes", "rows_evictions", "dispatches")

    def counters(self):
        with self._lock:
            out = [self.dispatches, self.hits, self.misses,
                   self.planes_uploaded]
        for part in self.parts:
            for i, v in enumerate(part.counters()):
                out[i] += v
        return tuple(out)

    def cache_stats(self):
        """The node's counters: this evaluator's launches (one locked
        dispatch for the k launches of a Count) plus the parts' gather
        side, whose cache traffic, patches and bytes count per part."""
        out = super().cache_stats()
        parts = [part.cache_stats() for part in self.parts]
        for key in self._SUMMED:
            out[key] += sum(p[key] for p in parts)
        causes = {}
        for p in parts:
            for cause, n in p["evictions_by_cause"].items():
                causes[cause] = causes.get(cause, 0) + n
        out["evictions_by_cause"] = dict(sorted(causes.items()))
        out["devices"] = [str(d) for d in self.devices]
        return out

    def invalidate(self):
        for part in self.parts:
            part.invalidate()

    # -- gathers -------------------------------------------------------------

    def _gather(self, idx, call, shards):
        """Tree coverage, then every part's leaf containers over its
        range: (sig, [PartedLeaf per leaf slot]) or None."""
        leaves = {}
        sig = self.signature(idx, call, leaves)
        if sig is None or not leaves:
            return None
        ordered = [k for k, _ in sorted(leaves.items(), key=lambda kv: kv[1])]
        per_part = []
        for part, part_shards in zip(self.parts, self.split(shards)):
            conts = part._leaf_containers(idx, ordered, part_shards)
            if conts is None:
                return None
            per_part.append(conts)
        n = len(shards)
        return sig, [PartedLeaf([c[i] for c in per_part], n)
                     for i in range(len(ordered))]

    def rows_stack(self, idx, field_name, row_chunk, shards,
                   view_name=VIEW_STANDARD, cache=True):
        """The parts' [R, n, W] stacks of a row chunk (each cached and
        patched in its part's rows pool), or None."""
        out = []
        for part, part_shards in zip(self.parts, self.split(shards)):
            s = part.rows_stack(idx, field_name, row_chunk, part_shards,
                                view_name, cache)
            if s is None:
                return None
            out.append(s)
        return Parted(out, len(shards))

    def leaf_stack(self, idx, field_name, row_id, shards):
        """One row's leaf over every part (each part's Container cached
        in its own leaf pool), or None."""
        out = []
        for part, part_shards in zip(self.parts, self.split(shards)):
            c = part.leaf_stack(idx, field_name, row_id, part_shards)
            if c is None:
                return None
            out.append(c)
        return PartedLeaf(out, len(shards))

    def bsi_stack(self, idx, field_name, shards):
        """(planes, sign, exists) of a BSI field, each Parted (every
        part's stack cached in its own leaf pool), or None."""
        out = []
        for part, part_shards in zip(self.parts, self.split(shards)):
            data = part.bsi_stack(idx, field_name, part_shards)
            if data is None:
                return None
            out.append(data)
        return tuple(Parted(ts, len(shards)) for ts in zip(*out))

    # -- plan-mode introspection (host only, no side effects) ----------------

    def rows_chunk_resident(self, idx, field_name, row_chunk, shards,
                            view_name=VIEW_STANDARD):
        return all(part.rows_chunk_resident(idx, field_name, row_chunk, ps,
                                            view_name)
                   for part, ps in zip(self.parts, self.split(shards)))

    def bsi_stack_resident(self, idx, field_name, shards):
        return all(part.bsi_stack_resident(idx, field_name, ps)
                   for part, ps in zip(self.parts, self.split(shards)))

    def residency_probe(self, idx, call, shards):
        """StackedEvaluator's probe over every part: a leaf is resident
        when every part holds it; bytes and extra launches sum over the
        parts; the repr counts are the first part's."""
        outs = [part.residency_probe(idx, call, ps)
                for part, ps in zip(self.parts, self.split(shards))]
        out = dict(outs[0])
        if not out["covered"]:
            return out
        out["resident"] = min(o["resident"] for o in outs)
        for key in ("resident_bytes", "missing_bytes", "compressed_bytes"):
            out[key] = sum(o[key] for o in outs)
        extra = {}
        for o in outs:
            for k, v in o["extra_kernels"].items():
                extra[k] = extra.get(k, 0) + v
        out["extra_kernels"] = extra
        return out
