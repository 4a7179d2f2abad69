"""Mesh-resident leaf blocks: the collective data plane's device cache.

A serve-off step (cluster/spmd.py) re-materializes every leaf for every
query: it gathers this rank's [seg_len, W] host block from the node's
fragments, uploads it, counts it and throws it away. This module keeps
the uploaded block resident on the serving device per process,
validated by the same per-shard (fragment uid, generation) fingerprint
the local stack cache uses (exec/stacked._fragment_gens), so a warm step
re-uses device memory instead of gathering and uploading again (the TPU
package's cluster/meshstacks.py, which caches the handle of a globally
sharded array; the port has no global array, each rank holds its own
block and its kernels count it).

Per-rank divergence is safe by construction: a rank's block feeds only
that rank's kernel launch, and the partials meet in the step's one
collective. When rank A hits its cache and rank B rebuilds after a local
write, the collective still sums A's (validated, unchanged) partial and
B's fresh one. Only the step sequence and the partials' shapes must
agree across ranks, and those ride in the step itself.

Carried per entry:
- HBM ledger: device bytes per (index, field, "mesh", repr) flow into the
  `hbm_stack_bytes` gauge, pool-tagged "mesh", so /metrics separates
  mesh-resident bytes from the local serving pools.
- heat: every probe (hit or miss) bumps the fragment heat ledger, so mesh
  demand makes a fragment an admission candidate like local demand.
- compressed reprs: blocks stay DENSE on the device (every rank runs the
  same dense step), but each entry records the chooser's verdict
  (dense/sparse/RLE + projected bytes) for its own block, from the port's
  `containers.analyze`/`choose`, so /debug/spmd shows what a compressed
  collective plane would save per node.

Shadow support: `shadow_probe` compares a freshly gathered block against
the cached entry's content digest without touching the serving path —
the --spmd-serve shadow mode's divergence detector.

No torch at module import (trap 19): the chooser is imported when an
entry is classified.
"""

import threading
import zlib
from collections import OrderedDict

import numpy as np

from ..core.view import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD
from ..utils.logger import NopLogger
from ..utils.stats import global_stats

#: per-process device-byte budget for mesh-resident blocks (dense
#: [seg_len, W] int32 tensors; LRU past this)
DEFAULT_MAX_BYTES = 256 * 1024 * 1024


def entry_key(wire_leaf):
    """Hashable cache key component from a step's wire leaf entry
    (["row", f, r] | ["bsicond", f, op, vals] | ["timerow", f, r, views])."""
    kind = wire_leaf[0]
    if kind == "bsicond":
        # vals is a scalar for single-threshold ops (v > 0) and a list
        # for between: hash both forms
        _, field_name, op, vals = wire_leaf
        if isinstance(vals, (list, tuple)):
            vals = tuple(vals)
        return ("bsicond", field_name, op, vals)
    if kind == "timerow":
        _, field_name, row_id, views = wire_leaf
        return ("timerow", field_name, int(row_id), tuple(views))
    _, field_name, row_id = wire_leaf
    return ("row", field_name, int(row_id))


def leaf_views(wire_leaf):
    """(field, view names) a wire leaf reads — its gen-validation
    surface. A bsicond leaf is derived from the field's BSI plane group,
    so that view's fragment generations cover it."""
    kind = wire_leaf[0]
    field_name = wire_leaf[1]
    if kind == "bsicond":
        return field_name, (VIEW_BSI_GROUP_PREFIX + field_name,)
    if kind == "timerow":
        return field_name, tuple(wire_leaf[3])
    return field_name, (VIEW_STANDARD,)


class MeshStackCache:
    """LRU of this rank's device leaf blocks keyed by (index, leaf,
    seg_len, my_shards), validated per hit against this process's
    fragment generations. One instance per SpmdDataPlane."""

    def __init__(self, logger=None, max_bytes=DEFAULT_MAX_BYTES):
        self.logger = logger or NopLogger()
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # key -> [gens, block, nbytes, repr_kind, digest, repr_meta]
        self._entries = OrderedDict()
        self._ledger = {}  # (index, field, repr) -> bytes
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.shadow_probes = 0
        self.shadow_hits = 0
        self.shadow_mismatches = 0

    # -- validation ----------------------------------------------------------

    def gens(self, idx, wire_leaf, my_shards):
        """Per-(view, shard) (fragment uid, generation) stamp for this
        process's block of one leaf — exec/stacked._fragment_gens'
        invalidation contract applied to the leaf's whole view surface.
        None when the field vanished (the caller skips the cache; the
        gather contributes zero planes either way)."""
        field_name, views = leaf_views(wire_leaf)
        field = idx.field(field_name) if idx is not None else None
        if field is None:
            return None
        gens = []
        for view_name in views:
            view = field.view(view_name)
            for shard in my_shards:
                frag = view.fragment(shard) if view is not None else None
                gens.append((-1, -1) if frag is None
                            else (frag.uid, frag.generation))
        return tuple(gens)

    # -- probe / fill --------------------------------------------------------

    def get(self, key, gens):
        """Cached device block for `key`, or None. A generation mismatch
        invalidates the entry (this process's fragments changed; peers
        validate their own blocks independently)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == gens \
                    and entry[1] is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                block = entry[1]
            else:
                if entry is not None:
                    # stale gens, or a block-less shadow-parked entry
                    # left behind by a runtime shadow->on switch
                    if entry[0] != gens:
                        self.invalidations += 1
                    self._drop_locked(key, entry)
                self.misses += 1
                block = None
        self._heat_bump(key)
        return block

    def put(self, key, gens, block, local_block):
        """Admit one device block. `local_block` is this process's host
        copy of it (uint32 or int32 words): digested for shadow
        comparison; the repr verdict is taken on `block` itself when it
        is a tensor (on its device), else on the host copy. Device bytes
        charged are the dense block this process holds."""
        repr_kind, repr_meta = self._classify(block, local_block)
        nbytes = int(local_block.size) * 4
        digest = zlib.crc32(np.ascontiguousarray(local_block).tobytes())
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_locked(key, old, popped=True)
            self._entries[key] = [gens, block, nbytes, repr_kind,
                                  digest, repr_meta]
            self.bytes += nbytes
            self._ledger_add(key, nbytes, repr_kind)
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                vkey, ventry = self._entries.popitem(last=False)
                self.evictions += 1
                self._drop_locked(vkey, ventry, popped=True)

    def shadow_probe(self, key, gens, local_block):
        """--spmd-serve shadow: would the cache have served this block
        correctly? Parks the digest on a miss, compares digests on a
        hit; the serving path keeps using the fresh gather either way."""
        self.shadow_probes += 1
        digest = zlib.crc32(np.ascontiguousarray(local_block).tobytes())
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == gens:
                self._entries.move_to_end(key)
                self.shadow_hits += 1
                if entry[4] != digest:
                    self.shadow_mismatches += 1
                    self.logger.printf(
                        "spmd shadow: mesh cache divergence on %s "
                        "(gens matched, content differs)", key[:2])
                return
            if entry is not None:
                self.invalidations += 1
                self._drop_locked(key, entry)
        # miss: park the digest + repr verdict (no device block: shadow
        # must not hold device memory the serving path never reads)
        repr_kind, repr_meta = self._classify(None, local_block)
        with self._lock:
            self._entries[key] = [gens, None, 0, repr_kind, digest,
                                  repr_meta]

    def invalidate_index(self, index_name):
        """Drop every entry of one index (DDL hook)."""
        with self._lock:
            for key in [k for k in self._entries if k[0] == index_name]:
                entry = self._entries.pop(key)
                self.invalidations += 1
                self._drop_locked(key, entry, popped=True)

    # -- internals -----------------------------------------------------------

    def _drop_locked(self, key, entry, popped=False):
        if not popped:
            self._entries.pop(key, None)
        self.bytes -= entry[2]
        self._ledger_add(key, -entry[2], entry[3])

    def _ledger_add(self, key, delta, repr_kind):
        """(index, field, "mesh", repr) ledger in lockstep with the pool
        bytes, mirrored into the hbm_stack_bytes gauge (the caller holds
        self._lock)."""
        if delta == 0:
            return  # shadow-parked entries hold no device bytes
        index_name, leaf = key[0], key[1]
        lkey = (index_name, leaf[1], repr_kind)
        new = self._ledger.get(lkey, 0) + delta
        if new <= 0:
            self._ledger.pop(lkey, None)
            new = 0
        else:
            self._ledger[lkey] = new
        global_stats.gauge("hbm_stack_bytes", new, {
            "index": index_name, "field": leaf[1], "pool": "mesh",
            "repr": repr_kind})

    def _heat_bump(self, key):
        from ..utils import workload as _workload

        leaf = key[1]
        try:
            _, views = leaf_views(leaf)
            _workload.heat_bump(key[0], leaf[1], views[0])
        except Exception:  # noqa: BLE001 — heat is observability only
            pass

    @staticmethod
    def _classify(block, local_block):
        """The chooser's verdict for this process's dense block: what
        repr it WOULD compress to, and the projected bytes — carried as
        metadata (the device copy stays dense; see the module doc)."""
        try:
            import torch

            from ..ops import containers as _containers

            if not isinstance(block, torch.Tensor):
                block = torch.from_numpy(
                    np.ascontiguousarray(local_block).view(np.int32))
            info = _containers.analyze(block)
            s, w = block.shape
            kind = _containers.choose(info, s, w)
            return kind, {
                "density": round(info["density"], 6),
                "dense_bytes": info["dense_bytes"],
                "sparse_bytes": info["sparse_bytes"],
                "rle_bytes": info["rle_bytes"],
            }
        except Exception:  # noqa: BLE001 — metadata only
            return "dense", {}

    # -- observability -------------------------------------------------------

    def stats(self):
        with self._lock:
            by_repr = {}
            for entry in self._entries.values():
                by_repr[entry[3]] = by_repr.get(entry[3], 0) + 1
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "reprs": by_repr,
                "shadow": {
                    "probes": self.shadow_probes,
                    "hits": self.shadow_hits,
                    "mismatches": self.shadow_mismatches,
                },
                "ledger": [
                    {"index": i, "field": f, "repr": r, "bytes": b}
                    for (i, f, r), b in sorted(self._ledger.items())],
            }
