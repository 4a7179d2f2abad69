"""Stacked serving fast path: Count, TopN, GroupBy, Sum, Min and Max over
every shard.

The general executor evaluates call trees shard by shard. This module
evaluates ALL shards at once: fragment rows become [shards, words] int32
stacks resident on the device, and

- Count (reference: executeCount executor.go:1790): the call tree becomes
  a signature over leaf slots whose row leaves are Containers, built
  dense, block-sparse or run-length by measured density
  (ops/containers.py); `count_program` counts block-sparse leaves and
  their intersections with K2 (ops/count_blocks.py), run-length ones with
  torch sums, and anything else with one launch of K1
  (ops/count_expr.py), which evaluates the densified tree, takes the
  popcount and sums over every shard into an exact int64;
- TopN and single-field GroupBy: candidate rows stack into [R, S, W]
  chunks and one launch of K3 (ops/row_counts.py) per chunk counts each
  row against an optional [S, W] filter (`filter_stack`, a tree evaluated
  with PyTorch elementwise ops); one host fetch serves every chunk;
- GroupBy over two or more fields: one launch of K4 (ops/pairwise.py)
  per pair of row tiles of its innermost two fields gives their
  [R1, R2] count matrix;
- BSI conditions (`Row(v > 10)`) are leaves too: one launch of K5
  (ops/bsi_range.py) turns the field's cached [D+2, S, W] bit-plane stack
  into an [S, W] mask (`bsi_condition_stack`); a time-range row
  (`Row(t=1, from=..., to=...)`) is the union of its quantum views' row
  stacks (`time_row_stack`);
- Sum: three launches of K3 over the [D, S·W] plane view and one host
  fetch (`try_sum`); Min and Max: the narrowing plane walk in PyTorch
  ops, selected on the device, one host fetch (`try_minmax`).

Stacks are cached per (index, field, row, shard-set) — leaf stacks — or
per (index, field, depth, shard-set) — BSI stacks, in the leaf pool too —
or per (index, field, view, row chunk, shard-set) — row-chunk stacks — in
two pools with their own byte budgets and LRU order, so churning TopN
candidates never evict the Count path's leaves. All are validated by
the fragments' write-generation counters (fragment.generation — bumped
by every mutation), so a stale stack never serves a query. A view-level
(uid, mutations) stamp makes the hit check O(1); a drifted entry is
patched in place, re-uploading only the changed shards' planes (at
SHARD_WIDTH = 2^20 a 954-shard leaf stack is 125 MB).

Every launch and every in-place patch holds one process-wide dispatch
lock. Concurrent queries are batched, as in the TPU package:

- Counts go through a GroupCommit (`_count_commit`): the first thread to
  arrive leads and drains every Count queued meanwhile, groups them by
  signature, container signature and shapes, counts each dense group
  with ONE launch of K1's batched entry (`containers.count_program_batch`
  -> `count_expr_batch`) and each other group member by member, and
  fetches every total with ONE device->host copy. A lone Count takes the
  plain one-launch path.
- TopN, GroupBy, Sum, Min and Max share their result fetches through a
  second GroupCommit (`_fetch_commit`).
- The query coalescer and the query-batch route (server/api.py) run
  `launch_query_batch` / `resolve_query_batch`: batched Counts and plane
  trees, grouped by (kind, signature, component shapes), launched
  without a wait, and fetched by one asynchronous copy into pinned host
  memory that `resolve` alone waits for, so a batch's fetch overlaps the
  next batch's launch.
"""

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..core import timeq
from ..core.field import FIELD_TYPE_INT, FIELD_TYPE_TIME
from ..core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.view import VIEW_STANDARD
from ..ops import bitplane as _bitplane
from ..ops import containers as _containers
from ..ops.bsi import bsi_plane_counts, max_unsigned, min_unsigned
from ..ops.count_expr import tree_eval
from ..ops.pairwise import pairwise_counts_stack as _pairwise_kernel
from ..ops.row_counts import row_counts as _row_counts_kernel
from ..pql import Condition
from ..shardwidth import WORDS_PER_ROW
from .bsicond import (
    BsiConditionError,
    apply_bsi_condition,
    bsi_condition_plan,
    condition_from_key,
    normalize_bsi_condition,
)

# Device-byte budget for cached leaf stacks; excess evicts
# least-recently-used.
MAX_STACK_BYTES = 512 * 1024 * 1024
# Separate budget for TopN/GroupBy row-chunk stacks ([rows, shards, words]
# keyed by the exact candidate tuple): they are large and churn with any
# candidate-set change, so they must not be able to evict the long-lived
# leaf stacks the Count path depends on. (The TPU package's value, sized
# for a 16 GB TPU, kept for parity.)
MAX_ROWS_STACK_BYTES = 256 * 1024 * 1024
# Below this many shards the per-shard path's launch count is too small
# to matter.
MIN_SHARDS = 2
# Transient row-chunk stacks ([rows, shards, words]) are built at most this
# large, so TopN/GroupBy launch count is O(rows/chunk) — independent of
# the shard count. (The TPU package's value, kept for parity.)
CHUNK_BYTES = 128 * 1024 * 1024
# Time-range leaves union one cached stack per quantum view in the range
# cover; wider covers (a years-long hourly span) use the per-shard path.
MAX_TIME_VIEWS = 64

_OPS = {"Intersect": "&", "Union": "|", "Difference": "-", "Xor": "^"}

#: serializes every device launch and in-place stack patch in the process
_DISPATCH_LOCK = threading.Lock()

#: padding buckets of the TPU package's batched programs (it pads a batch
#: up to the next one, repeating query 0, to bound its compiled programs).
#: A CUDA kernel takes B at run time, so the port launches only the real
#: members; the buckets stay as the batch size limits (64 a launch).
BATCH_BUCKETS = (1, 4, 16, 64)


def batch_bucket(n):
    """Smallest padding bucket holding `n` queries."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return BATCH_BUCKETS[-1]


#: thread-local batch attribution: the batch paths stamp how many queries
#: shared the thread's last batched launch
_BATCH_TLS = threading.local()


def note_batch_size(n):
    """Record the batch size the current thread's query rode (0 resets;
    1 = solo launch)."""
    _BATCH_TLS.size = int(n)


def last_batch_size():
    """Batch size stamped by the last batched launch on THIS thread (0
    when the thread never rode one)."""
    return getattr(_BATCH_TLS, "size", 0)


class GroupCommit:
    """Group-commit batching for the serving path (cross-query batching).

    Resolving a result costs one device->host round trip. Serving threads
    therefore amortize it: the first thread to arrive becomes the LEADER
    and drains everything queued, processing the WHOLE batch with one
    `process` call (one fetch — or one batched launch + one fetch);
    threads that arrive while the leader works queue up for the next
    leader. Leadership transfers by the emptiness rule: whoever appends to
    an EMPTY queue leads. Zero added latency for a lone query (its leader
    drains immediately); under concurrency, batch size grows to the
    natural arrival rate — classic group commit.

    A leader failure propagates to EVERY waiter in its batch — events
    always fire, so no HTTP thread can hang on a dead leader."""

    #: a batch slower than this is round-trip dominated (a remote device);
    #: batching windows only engage then
    RTT_DOMINATED_S = 0.02
    #: leader pause before draining on round-trip dominated transports —
    #: lets concurrent queries pile into the batch; NEVER applied on fast
    #: local transports
    WINDOW_S = 0.005

    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []
        self._window_s = 0.0  # adaptive: engages once batches measure slow
        # Minimum observed batch latency ~ the transport's round-trip
        # floor: a large batch is slow everywhere, but only a transport
        # whose FASTEST batch is still slow is round-trip dominated.
        self._min_elapsed_s = float("inf")
        # batches/batched expose the achieved batching factor
        # (batched/batches ≈ queries per round trip)
        self.batches = 0
        self.batched = 0

    def submit(self, payload, process):
        """Enqueue `payload`; the batch leader calls
        `process([payloads...]) -> [results...]` once for everything it
        drained. Returns this payload's result; re-raises the leader's
        exception if its batch failed."""
        entry = [payload, None, None, threading.Event()]
        with self._lock:
            self._queue.append(entry)
            leader = len(self._queue) == 1
        if not leader:
            entry[3].wait()
            if entry[2] is not None:
                raise entry[2]
            return entry[1]
        if self._window_s > 0.0:
            time.sleep(self._window_s)
        with self._lock:
            batch = self._queue
            self._queue = []
        try:
            t0 = time.perf_counter()
            results = process([e[0] for e in batch])
            elapsed = time.perf_counter() - t0
            self._min_elapsed_s = min(self._min_elapsed_s, elapsed)
            self._window_s = self.WINDOW_S \
                if self._min_elapsed_s > self.RTT_DOMINATED_S else 0.0
            with self._lock:  # two leaders may finish at once
                self.batches += 1
                self.batched += len(batch)
            for e, r in zip(batch, results):
                e[1] = r
        except BaseException as exc:
            for e in batch:
                e[2] = exc
            raise
        finally:
            for e in batch:
                if e is not entry:
                    e[3].set()
        return entry[1]


def _device_get_batch(payloads):
    """GroupCommit `process` for plain result fetches: each payload is a
    tuple of int64 tensors on one device; ONE device->host copy resolves
    them all. Returns per payload a list of host numpy arrays, each of
    its tensor's shape."""
    flat = [t for tensors in payloads for t in tensors]
    if len(flat) == 1:
        host = flat[0].reshape(-1).cpu().numpy()
    else:
        host = torch.cat([t.reshape(-1) for t in flat]).cpu().numpy()
    out, i = [], 0
    for tensors in payloads:
        vals = []
        for t in tensors:
            vals.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        out.append(vals)
    return out


def time_range_views(idx, field_name, args):
    """Quantum-view name cover for a time-range Row, or None when the
    field isn't a time field / has no quantum. Pure function of the
    schema + call args (semantics identical to the executor's per-shard
    _row_shard)."""
    field = idx.field(field_name)
    if field is None or field.type != FIELD_TYPE_TIME:
        return None
    quantum = field.time_quantum()
    if not quantum:
        return None
    try:
        from_t = timeq.parse_time(args["from"]) if "from" in args \
            else timeq.parse_time("1970-01-01T00:00")
        to_t = timeq.parse_time(args["to"]) if "to" in args \
            else timeq.parse_time("2100-01-01T00:00")
    except (ValueError, OverflowError, OSError):
        return None  # malformed timestamps: per-shard path raises cleanly
    views = tuple(timeq.views_by_time_range(
        VIEW_STANDARD, from_t, to_t, quantum))
    if len(views) > MAX_TIME_VIEWS:
        return None  # a huge hourly span: per-shard path handles it
    return views


def intern_time_leaf(idx, field_name, row_id, args, leaves):
    '''THE ("timerow", field, row, views) leaf interner, so the leaf key
    shape lives in one place.'''
    views = time_range_views(idx, field_name, args)
    if views is None:
        return None
    key = ("timerow", field_name, int(row_id), views)
    if key not in leaves:
        leaves[key] = len(leaves)
    return ("leaf", leaves[key])


def tree_signature(idx, call, leaves, leaf, bsi_leaf=None, time_leaf=None,
                   shift_leaf=None):
    """THE coverage walk for the stacked path: turns a bitmap call tree
    into an operator signature over leaf slots, or None when any shape
    isn't expressible (keys, a negative Shift, ...).
    `leaf(idx, field_name, row_id, leaves)` decides row-leaf eligibility
    and interns the slot.
    `bsi_leaf(idx, field_name, cond, leaves)` (optional) covers BSI
    condition leaves like Row(v > 10) the same way (reference algorithm:
    fragment.go:1357-1470); None declines conditions entirely.
    `time_leaf(idx, field_name, row_id, args, leaves)` (optional) covers
    time-range rows Row(t=1, from=..., to=...) as a union over the
    quantum-view cover (reference: viewsByTimeRange time.go:91); None
    declines time ranges entirely.
    `shift_leaf(idx, call, leaves)` (optional) covers Shift(child, n=k)
    as one leaf: the child tree, evaluated over every shard and shifted
    within each shard; None declines Shift entirely."""
    name = call.name
    if name in ("Row", "Range"):
        if "from" in call.args or "to" in call.args:
            if time_leaf is None or call.has_conditions():
                return None
            field_name = call.field_arg()
            if field_name is None:
                return None
            row_id = call.args.get(field_name)
            if isinstance(row_id, bool):
                row_id = int(row_id)
            if not isinstance(row_id, int):
                return None
            return time_leaf(idx, field_name, row_id, call.args, leaves)
        if call.has_conditions():
            if bsi_leaf is None or len(call.args) != 1:
                return None
            field_name, cond = next(iter(call.args.items()))
            if not isinstance(cond, Condition):
                return None
            return bsi_leaf(idx, field_name, cond, leaves)
        field_name = call.field_arg()
        if field_name is None:
            return None
        row_id = call.args.get(field_name)
        if isinstance(row_id, bool):
            row_id = int(row_id)
        if not isinstance(row_id, int):
            return None
        return leaf(idx, field_name, row_id, leaves)
    if name in _OPS and call.children:
        subs = tuple(
            tree_signature(idx, c, leaves, leaf, bsi_leaf, time_leaf,
                           shift_leaf)
            for c in call.children)
        if any(s is None for s in subs):
            return None
        return (_OPS[name], subs)
    if name == "Not" and len(call.children) == 1 \
            and idx.options.track_existence \
            and idx.field(EXISTENCE_FIELD_NAME) is not None:
        child = tree_signature(idx, call.children[0], leaves, leaf,
                               bsi_leaf, time_leaf, shift_leaf)
        if child is None:
            return None
        exists = leaf(idx, EXISTENCE_FIELD_NAME, 0, leaves)
        if exists is None:
            return None
        return ("-", (exists, child))
    if name == "Shift" and len(call.children) == 1 \
            and shift_leaf is not None:
        return shift_leaf(idx, call, leaves)
    return None


class StackedEvaluator:
    def __init__(self, device):
        self.device = torch.device(device)
        # two byte-budgeted LRU pools, picked by _pool_of(key): "leaf"
        # (Count leaves, [S, W] Containers, and BSI [D+2, S, W] stacks)
        # and "rows" (TopN/GroupBy row chunks and time-view rows,
        # [R, S, W] tensors); entry = [gens, value, nbytes, stamp]
        self._pools = {"leaf": OrderedDict(), "rows": OrderedDict()}
        self._pool_bytes = {"leaf": 0, "rows": 0}
        self._pool_evictions = {"leaf": 0, "rows": 0}
        self._lock = threading.Lock()
        self._dispatch_lock = _DISPATCH_LOCK
        # counters: launches (tests assert the stacked path ran), cache
        # traffic, upload volume in planes, and the pairwise GroupBy's
        # launches and host syncs
        self.dispatches = 0
        self.hits = 0
        self.misses = 0
        self.patches = 0
        self.planes_uploaded = 0
        self.pairwise_dispatches = 0
        self.pairwise_syncs = 0
        # cross-query batching: Counts fuse into one launch per group and
        # one fetch (_count_commit); TopN/GroupBy/Sum/Min/Max share their
        # fetches (_fetch_commit); launch_query_batch counts its launches
        # and fetches
        self._count_commit = GroupCommit()
        self._fetch_commit = GroupCommit()
        self.batch_dispatches = 0
        self.batched_queries = 0
        self.batch_fetches = 0
        # device bytes resident per (pool, index, field)
        self._hbm_ledger = {}

    def cache_stats(self):
        with self._lock:
            return {"dispatches": self.dispatches, "hits": self.hits,
                    "misses": self.misses,
                    "evictions": self._pool_evictions["leaf"],
                    "patches": self.patches,
                    "planes_uploaded": self.planes_uploaded,
                    "entries": len(self._pools["leaf"]),
                    "bytes": self._pool_bytes["leaf"],
                    "rows_entries": len(self._pools["rows"]),
                    "rows_bytes": self._pool_bytes["rows"],
                    "rows_evictions": self._pool_evictions["rows"],
                    "pairwise_dispatches": self.pairwise_dispatches,
                    "pairwise_syncs": self.pairwise_syncs,
                    "group_fetches": self._fetch_commit.batches,
                    "group_fetched_queries": self._fetch_commit.batched,
                    "count_batches": self._count_commit.batches,
                    "count_batched_queries": self._count_commit.batched,
                    "batch_dispatches": self.batch_dispatches,
                    "batched_queries": self.batched_queries,
                    "batch_fetches": self.batch_fetches,
                    "device": str(self.device)}

    def _place(self, host_stack):
        """Upload a host uint32 stack as an int32 device tensor."""
        host = np.ascontiguousarray(host_stack, dtype=np.uint32)
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    # -- tree analysis -------------------------------------------------------

    def _leaf(self, idx, field_name, row_id, leaves):
        field = idx.field(field_name)
        if field is None or field.view(VIEW_STANDARD) is None:
            return None
        key = ("row", field_name, int(row_id))
        if key not in leaves:
            leaves[key] = len(leaves)
        return ("leaf", leaves[key])

    def _bsi_leaf(self, idx, field_name, cond, leaves):
        """Condition-leaf eligibility: an int field with a BSI view and a
        normalizable condition. The leaf key carries (op, values) so
        identical conditions share one slot."""
        field = idx.field(field_name)
        if field is None or field.type != FIELD_TYPE_INT \
                or field.view(field.bsi_view_name()) is None:
            return None
        norm = normalize_bsi_condition(cond)
        if norm is None:
            return None
        op, vals = norm
        key = ("bsicond", field_name, op, vals)
        if key not in leaves:
            leaves[key] = len(leaves)
        return ("leaf", leaves[key])

    def _shift_leaf(self, idx, call, leaves):
        """Shift-leaf eligibility: a non-negative integer n and a child
        tree the stacked path covers. The key carries n, the child's
        signature and its leaf keys in slot order, so `_leaf_containers`
        rebuilds the child from the key alone and identical Shifts share
        one slot. A negative n declines: the per-shard route raises."""
        n = call.args.get("n", 1)
        if isinstance(n, bool) or not isinstance(n, int) or n < 0:
            return None
        sub_leaves = {}
        sub_sig = self.signature(idx, call.children[0], sub_leaves)
        if sub_sig is None or not sub_leaves:
            return None
        sub_keys = tuple(k for k, _ in sorted(sub_leaves.items(),
                                              key=lambda kv: kv[1]))
        key = ("shift", n, sub_sig, sub_keys)
        if key not in leaves:
            leaves[key] = len(leaves)
        return ("leaf", leaves[key])

    def signature(self, idx, call, leaves):
        """Tree signature with leaf slots, or None (use the per-shard
        path)."""
        return tree_signature(idx, call, leaves, self._leaf, self._bsi_leaf,
                              intern_time_leaf, self._shift_leaf)

    # -- stack cache ---------------------------------------------------------

    @staticmethod
    def _fragment_gens(view, shards):
        """Cache-validation fingerprint: per-shard (fragment uid,
        generation) of `view` — the standard view for leaves, a quantum
        view for time rows, the bsig view for BSI stacks."""
        gens = []
        for shard in shards:
            frag = view.fragment(shard)
            gens.append((-1, -1) if frag is None
                        else (frag.uid, frag.generation))
        return tuple(gens)

    @staticmethod
    def _pool_of(key):
        """Row-chunk stacks live in their own pool; leaf and BSI stacks
        share the leaf pool."""
        return "rows" if key[0] == "rows" else "leaf"

    def _cache_get_fast(self, key, stamp):
        """O(1) hit check via the view-level (uid, mutations) stamp: a
        match proves no fragment of the view changed since the put, so
        the per-shard generation walk is skipped."""
        with self._lock:
            entries = self._pools[self._pool_of(key)]
            hit = entries.get(key)
            if hit is not None and hit[3] == stamp:
                entries.move_to_end(key)
                self.hits += 1
                return hit[1]
        return None

    def _cache_get(self, key, gens, stamp=None):
        """Second-level check: exact per-shard generations. A hit
        refreshes the stamp (a mutation elsewhere in the view moved the
        counter without touching these shards)."""
        with self._lock:
            entries = self._pools[self._pool_of(key)]
            hit = entries.get(key)
            if hit is not None and hit[0] == gens:
                entries.move_to_end(key)
                if stamp is not None:
                    hit[3] = stamp
                self.hits += 1
                return hit[1]
            self.misses += 1
        return None

    def _ledger_add(self, key, delta):
        """Move the per-(pool, index, field) byte ledger in lockstep with
        the pool byte counter (caller holds self._lock)."""
        lkey = (self._pool_of(key), key[1], key[2])
        new = self._hbm_ledger.get(lkey, 0) + delta
        if new <= 0:
            self._hbm_ledger.pop(lkey, None)
        else:
            self._hbm_ledger[lkey] = new

    @staticmethod
    def _budget(pool):
        return MAX_STACK_BYTES if pool == "leaf" else MAX_ROWS_STACK_BYTES

    def _cache_put(self, key, gens, value, nbytes, stamp=None):
        pool = self._pool_of(key)
        entries = self._pools[pool]
        with self._lock:
            old = entries.pop(key, None)
            if old is not None:
                self._pool_bytes[pool] -= old[2]
                self._ledger_add(key, -old[2])
            entries[key] = [gens, value, nbytes, stamp]
            self._pool_bytes[pool] += nbytes
            self._ledger_add(key, nbytes)
            while self._pool_bytes[pool] > self._budget(pool) \
                    and len(entries) > 1:
                ekey, evicted = entries.popitem(last=False)
                self._pool_bytes[pool] -= evicted[2]
                self._ledger_add(ekey, -evicted[2])
                self._pool_evictions[pool] += 1

    def hbm_ledger(self, pool="leaf"):
        """{(index, field): resident device bytes} of one pool; sums to
        that pool's byte counter."""
        with self._lock:
            return {(k[1], k[2]): v for k, v in self._hbm_ledger.items()
                    if k[0] == pool}

    def _stale_entry(self, key, gens):
        """The cached entry for `key` whose shard set matches `gens`
        (its generations may have drifted), or None."""
        with self._lock:
            entry = self._pools[self._pool_of(key)].get(key)
            if entry is None or len(entry[0]) != len(gens):
                return None
            return entry

    @staticmethod
    def _changed_shards(old_gens, gens):
        """Stack rows whose (uid, generation) drifted, or None when a
        patch isn't worthwhile (nothing changed, or more than half the
        shards — a scatter past that costs about as much as a rebuild)."""
        changed = [j for j, (o, n) in enumerate(zip(old_gens, gens))
                   if o != n]
        if not changed or len(changed) * 2 > len(gens):
            return None
        return changed

    def _patch(self, key, stale, gens, stamp, view, row_ids, shards):
        """Re-gather only the drifted shards of a cached stack and copy
        them into it in place, or None when a patch isn't worthwhile."""
        changed = self._changed_shards(stale[0], gens)
        if changed is None:
            return None
        block = self._host_rows(view, row_ids, [shards[j] for j in changed])
        value, nbytes = stale[1], stale[2]
        cols = torch.tensor(changed, dtype=torch.long, device=self.device)
        with self._dispatch_lock:
            if isinstance(value, _containers.Container):
                if value.kind != "dense":
                    # a compressed leaf has no per-shard planes to copy
                    # into: it decompresses on the device once and decays
                    # to dense (the chooser re-picks at the next rebuild)
                    value = _containers.dense_container(
                        _containers.container_to_dense(value))
                    nbytes = value.nbytes
                stack = value.arrays[0][None]
            else:
                stack = value  # an [R, S, W] rows chunk or BSI stack
            stack.index_copy_(1, cols, self._place(block))
        with self._lock:
            self.patches += 1
        self._cache_put(key, gens, value, nbytes, stamp)
        return value

    def leaf_stack(self, idx, field_name, row_id, shards):
        """Cached Container of one row's [S, W] plane stack over `shards`:
        a cold build uploads the stack, analyzes it on the device and
        keeps it dense or rebuilds it block-sparse or run-length under the
        --container-repr mode (ops/containers.build)."""
        key = ("leaf", idx.name, field_name, row_id, shards)
        field = idx.field(field_name)
        view = field.view(VIEW_STANDARD) if field is not None else None
        if view is None:
            return None
        stamp = (view.uid, view.mutations)
        hit = self._cache_get_fast(key, stamp)
        if hit is not None:
            return hit
        gens = self._fragment_gens(view, shards)
        hit = self._cache_get(key, gens, stamp)
        if hit is not None:
            return hit
        # Incremental maintenance: when few shards drifted (a write bumps
        # only its fragment's generation), gather + upload ONLY those
        # planes and copy them into the cached device stack in place,
        # instead of re-uploading the whole [S, W] stack for one set_bit.
        stale = self._stale_entry(key, gens)
        if stale is not None:
            patched = self._patch(key, stale, gens, stamp, view, [row_id],
                                  shards)
            if patched is not None:
                return patched
        host = self._host_rows(view, [row_id], shards)
        cont = _containers.build(host[0], self.device)
        self._cache_put(key, gens, cont, cont.nbytes, stamp)
        return cont

    def rows_stack(self, idx, field_name, row_chunk, shards,
                   view_name=VIEW_STANDARD, cache=True):
        """Cached [R, S, W] device stack of a chunk of rows (TopN/GroupBy
        candidates) from the rows pool, patched in place after writes.
        `row_chunk` must be a tuple (cache key). cache=False builds a
        transient stack (freed after use) — callers pass it when the full
        candidate set exceeds the rows pool, so oversized scans don't
        churn out every reusable chunk. None when the field/view
        vanished."""
        key = ("rows", idx.name, field_name, view_name, row_chunk, shards)
        field = idx.field(field_name)
        view = field.view(view_name) if field is not None else None
        if view is None:
            return None
        return self._rows_of_view(key, view, list(row_chunk), shards, cache)

    def _rows_of_view(self, key, view, row_ids, shards, cache=True):
        """The cached [R, S, W] device stack of `row_ids` of one view
        under `key`: a hit, an in-place patch of the drifted shards, or a
        fresh gather and upload (kept in its pool when `cache`)."""
        stamp = (view.uid, view.mutations)
        if cache:
            hit = self._cache_get_fast(key, stamp)
            if hit is not None:
                return hit
        gens = self._fragment_gens(view, shards)
        hit = self._cache_get(key, gens, stamp if cache else None)
        if hit is not None:
            return hit
        if cache:
            stale = self._stale_entry(key, gens)
            if stale is not None:
                patched = self._patch(key, stale, gens, stamp, view,
                                      row_ids, shards)
                if patched is not None:
                    return patched
        stack = self._place(self._host_rows(view, row_ids, shards))
        if cache:
            self._cache_put(key, gens, stack, stack.numel() * 4, stamp)
        return stack

    def bsi_stack(self, idx, field_name, shards):
        """(planes [D, S, W], sign [S, W], exists [S, W]) of a BSI field
        over `shards`: views of ONE cached [D+2, S, W] device stack of its
        bit-plane rows (row 0 exists, row 1 sign, rows 2.. magnitude bits;
        reference layout fragment.go:91-93) in the leaf pool, so one
        in-place patch after a write updates all three. None when the
        field/view vanished."""
        field = idx.field(field_name)
        if field is None:
            return None
        view = field.view(field.bsi_view_name())
        if view is None:
            return None
        depth = field.options.bit_depth
        key = ("bsi", idx.name, field_name, depth, shards)
        rows = [BSI_EXISTS_BIT, BSI_SIGN_BIT] + [
            BSI_OFFSET_BIT + i for i in range(depth)]
        stack = self._rows_of_view(key, view, rows, shards)
        return stack[2:], stack[1], stack[0]

    def bsi_condition_stack(self, idx, key, shards):
        """[S, W] mask of a BSI condition leaf over the cached (and
        incrementally patched) BSI stack: one or two K5 launches
        (reference per-shard algorithm fragment.go:1357-1470). The empty
        and notnull plans gather no magnitude planes. None when the field
        vanished or the condition is malformed (the per-shard path
        raises)."""
        _, field_name, op, vals = key
        field = idx.field(field_name)
        if field is None or field.type != FIELD_TYPE_INT:
            return None
        try:
            plan = bsi_condition_plan(
                field.options, condition_from_key(op, vals))
        except BsiConditionError:
            return None
        if plan[0] == "empty":
            return torch.zeros((self._padded_len(shards), WORDS_PER_ROW),
                               dtype=torch.int32, device=self.device)
        if plan[0] == "notnull":
            stack = self.rows_stack(idx, field_name, (BSI_EXISTS_BIT,),
                                    shards, view_name=field.bsi_view_name())
            return None if stack is None else stack[0]
        data = self.bsi_stack(idx, field_name, shards)
        if data is None:
            return None
        planes, sign, exists = data
        with self._lock:
            self.dispatches += 1
        with self._dispatch_lock:
            return apply_bsi_condition(plan, planes, sign, exists)

    def time_row_stack(self, idx, key, shards):
        """[S, W] union of one row across the quantum-view cover (the
        time-range leaf). Each view's row stack is cached and patched
        like any other rows-pool chunk; views absent here contribute
        nothing (the executor's per-shard union semantics)."""
        _, field_name, row_id, views = key
        field = idx.field(field_name)
        if field is None:
            return None
        stacks = []
        for view_name in views:
            if field.view(view_name) is None:
                continue  # no data in this quantum bucket
            stack = self.rows_stack(idx, field_name, (row_id,), shards,
                                    view_name=view_name)
            if stack is not None:
                stacks.append(stack[0])
        if not stacks:
            return torch.zeros((self._padded_len(shards), WORDS_PER_ROW),
                               dtype=torch.int32, device=self.device)
        if len(stacks) == 1:
            return stacks[0]
        with self._lock:
            self.dispatches += 1
        with self._dispatch_lock:
            return tree_eval(("|", tuple(("leaf", i)
                                         for i in range(len(stacks)))),
                             stacks)

    def _host_rows(self, view, row_ids, shards):
        """Host [R, S, W] uint32 gather of rows over shards. The per-shard
        gathers fan out over the shared worker pool: each task fills its
        own out[:, j] column, and the numpy copies release the GIL."""
        from ..utils.workpool import get_pool

        out = np.zeros((len(row_ids), len(shards), WORDS_PER_ROW),
                       dtype=np.uint32)

        def gather_column(j):
            frag = view.fragment(shards[j])
            if frag is None:
                return
            for i, row_id in enumerate(row_ids):
                plane = frag.row_plane(row_id)
                if plane is not None:
                    out[i, j] = np.asarray(plane)

        get_pool().map_ordered(gather_column, range(len(shards)))
        with self._lock:
            self.planes_uploaded += len(row_ids) * len(shards)
        return out

    def _padded_len(self, shards):
        """Shard-axis length of every stack: the filter [S, W] and the
        rows [R, S, W] stacks must agree. One device, so no padding (the
        TPU package pads to a multiple of its mesh's devices)."""
        return len(shards)

    def row_chunk_size(self, shards):
        """Rows per [R, S, W] chunk under the CHUNK_BYTES budget."""
        return max(
            1, CHUNK_BYTES // (self._padded_len(shards) * WORDS_PER_ROW * 4))

    # -- evaluation ----------------------------------------------------------

    def _count_fn(self, sig, stacks):
        """Tree -> exact int count over all shards: one count program
        over the leaves' containers (K2 for sparse leaves, torch sums for
        rle ones, else K1 over the densified tree) under the dispatch
        lock, then one host sync."""
        flat = _containers.flatten(stacks)
        csig = tuple(c.csig for c in stacks)
        with self._dispatch_lock:
            total = _containers.count_program(sig, csig, flat)
        return int(total)

    #: Counts a GroupCommit leader counts in one launch at most (the TPU
    #: package's MAX_COUNT_BATCH)
    MAX_COUNT_BATCH = 32

    def _batched_count(self, sig, stacks):
        """Group-commit count execution: the batch leader drains every
        queued Count, groups them by signature, counts each group with
        one launch and fetches ALL results in one copy. Solo queries
        take `_count_fn`; leader failures propagate to every waiter
        (GroupCommit contract). The batch size is stamped into the
        waiter's thread-local (`last_batch_size`)."""
        count, size = self._count_commit.submit(
            (sig, tuple(stacks)), self._process_count_batch)
        note_batch_size(size)
        return count

    def _process_count_batch(self, payloads):
        """GroupCommit `process` for Counts: payloads are (sig, stacks)
        pairs; returns (count, batch size) pairs in order, the size being
        how many queries shared the payload's launch. Payloads group by
        signature, container signature and component shapes; each group
        is `count_program_batch` (one launch of K1's batched entry for a
        dense group of two or more), and every group's totals come back
        in ONE device->host copy."""
        if len(payloads) == 1:
            sig, stacks = payloads[0]
            return [(self._count_fn(sig, stacks), 1)]
        # the exact component shapes too: concurrent Counts over other
        # shard sets (another index, a `shards` argument) count apart
        groups = {}
        for pos, (sig, stacks) in enumerate(payloads):
            csig = tuple(c.csig for c in stacks)
            gsig = tuple(c.gsig for c in stacks)
            groups.setdefault((sig, csig, gsig), []).append(pos)
        outs = []
        for (sig, csig, _gsig), positions in groups.items():
            for i in range(0, len(positions), self.MAX_COUNT_BATCH):
                chunk = positions[i:i + self.MAX_COUNT_BATCH]
                flats = [_containers.flatten(payloads[pos][1])
                         for pos in chunk]
                with self._dispatch_lock:
                    out = _containers.count_program_batch(sig, csig, flats)
                outs.append((chunk, out))
        vals = torch.cat([out for _, out in outs]).tolist()  # ONE fetch
        results = [None] * len(payloads)
        i = 0
        for chunk, _ in outs:
            for pos in chunk:
                results[pos] = (vals[i], len(chunk))
                i += 1
        return results

    def _fetch(self, values):
        """Host numpy copy of one int64 device tensor, the fetch shared
        with concurrently serving queries through the group commit."""
        return self._fetch_commit.submit((values,), _device_get_batch)[0]

    # -- batched launches (query coalescer, query-batch route) ----------------

    def gather_for_batch(self, idx, call, shards):
        """Batch-member coverage + leaf-stack gather: (sig, stacks) or None
        when the tree isn't batchable on the stacked path (the caller
        falls back to the per-query path)."""
        shards = tuple(shards)
        if len(shards) < MIN_SHARDS:
            return None
        return self._gather(idx, call, shards)

    def launch_query_batch(self, items):
        """Launch every gathered query in `items` — (kind, sig, stacks)
        triples, kind "count" or "plane" — and enqueue the copy of every
        result into pinned host memory, WITHOUT waiting for any of it.
        Items group on (kind, sig, gsig) and chunk at BATCH_BUCKETS[-1]:
        a count group is `count_program_batch` (one launch of K1's
        batched entry when its leaves are dense), a plane group one
        `plane_program` per member. Returns the handle
        `resolve_query_batch` turns into per-item results.

        The split is the double buffer: the coalescer launches batch N+1
        before it resolves batch N, and N's copy, enqueued right after
        N's launches with an event behind it, is all that resolve waits
        for."""
        groups = {}
        for pos, (kind, sig, stacks) in enumerate(items):
            gsig = tuple(c.gsig for c in stacks)
            groups.setdefault((kind, sig, gsig), []).append(pos)
        launched = []
        for (kind, sig, _gsig), positions in groups.items():
            csig = tuple(c.csig for c in items[positions[0]][2])
            for i in range(0, len(positions), BATCH_BUCKETS[-1]):
                chunk = positions[i:i + BATCH_BUCKETS[-1]]
                flats = [_containers.flatten(items[pos][2]) for pos in chunk]
                with self._lock:
                    self.dispatches += 1
                    self.batch_dispatches += 1
                    self.batched_queries += len(chunk)
                with self._dispatch_lock:
                    if kind == "count":
                        out = _containers.count_program_batch(
                            sig, csig, flats)
                    else:
                        out = [_containers.plane_program(sig, csig, flat)
                               for flat in flats]
                launched.append((kind, chunk, out))
        return self._copy_to_host(launched)

    def _copy_to_host(self, launched):
        """Enqueue the device->host copy of every launched result: the
        counts into one pinned int64 buffer, the planes into one pinned
        [n, S, W] buffer, and one event behind them. On the CPU the
        buffers are the results' own copies and there is no event."""
        cuda = self.device.type == "cuda"
        n_counts = sum(len(chunk) for kind, chunk, _ in launched
                       if kind == "count")
        planes = [p for kind, _, out in launched if kind != "count"
                  for p in out]
        counts_h = torch.empty((n_counts,), dtype=torch.int64,
                               pin_memory=cuda)
        planes_h = None
        if planes:
            planes_h = torch.empty((len(planes), *planes[0].shape),
                                   dtype=torch.int32, pin_memory=cuda)
        i = j = 0
        for kind, chunk, out in launched:
            if kind == "count":
                counts_h[i:i + len(chunk)].copy_(out, non_blocking=cuda)
                i += len(chunk)
            else:
                for plane in out:
                    planes_h[j].copy_(plane, non_blocking=cuda)
                    j += 1
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return [(kind, chunk) for kind, chunk, _ in launched], counts_h, \
            planes_h, event

    def resolve_query_batch(self, handle):
        """Wait for the ONE copy `launch_query_batch` enqueued and split
        it. Returns {item position: (result, batch size)}: count results
        are exact Python ints, plane results host [S, W] uint32 arrays
        (row j = the j-th shard the stacks were gathered over)."""
        launched, counts_h, planes_h, event = handle
        if event is not None:
            event.synchronize()
        with self._lock:
            self.batch_fetches += 1
        counts = counts_h.tolist()
        planes = None if planes_h is None \
            else planes_h.numpy().view(np.uint32)
        results = {}
        i = j = 0
        for kind, chunk in launched:
            for pos in chunk:
                if kind == "count":
                    results[pos] = (counts[i], len(chunk))
                    i += 1
                else:
                    results[pos] = (planes[j], len(chunk))
                    j += 1
        return results

    # -- public entry points -------------------------------------------------

    def _gather(self, idx, call, shards):
        """Tree coverage + leaf-stack gather: (sig, stacks) or None when
        the tree isn't stack-coverable or a leaf's field vanished."""
        leaves = {}
        sig = self.signature(idx, call, leaves)
        if sig is None or not leaves:
            return None
        ordered = [k for k, _ in sorted(leaves.items(), key=lambda kv: kv[1])]
        stacks = self._leaf_containers(idx, ordered, shards)
        if stacks is None:
            return None
        return sig, stacks

    def _leaf_containers(self, idx, keys, shards):
        """Containers of the leaf `keys` over `shards`, in order, or None
        when a leaf's field vanished. Row leaves come from the leaf pool;
        condition masks, time unions and Shift planes are fresh [S, W]
        planes, wrapped without copying like any dense leaf and never
        pooled."""
        stacks = []
        for key in keys:
            if key[0] == "row":
                s = self.leaf_stack(idx, key[1], key[2], shards)
                if s is None:
                    return None
                stacks.append(s)
                continue
            if key[0] == "bsicond":
                s = self.bsi_condition_stack(idx, key, shards)
            elif key[0] == "shift":
                s = self.shift_stack(idx, key, shards)
            else:
                s = self.time_row_stack(idx, key, shards)
            if s is None:
                return None
            stacks.append(_containers.dense_container(s))
        return stacks

    def shift_stack(self, idx, key, shards):
        """[S, W] plane of a Shift leaf: its child tree evaluated over
        every shard (`plane_program`, torch elementwise ops over the
        child's leaves), then each shard's row shifted by n within that
        shard (`bitplane.shift`: bits past a shard's last column drop,
        as on the per-shard route). None when a child leaf vanished."""
        _, n, sub_sig, sub_keys = key
        conts = self._leaf_containers(idx, sub_keys, shards)
        if conts is None:
            return None
        csig = tuple(c.csig for c in conts)
        with self._lock:
            self.dispatches += 1
        with self._dispatch_lock:
            plane = _containers.plane_program(
                sub_sig, csig, _containers.flatten(conts))
            return _bitplane.shift(plane, n)

    def try_count(self, idx, call_child, shards):
        """Count(call_child) over `shards` in one launch, or None when
        the tree isn't coverable (caller falls back to per-shard)."""
        shards = tuple(shards)
        if len(shards) < MIN_SHARDS:
            return None
        gathered = self._gather(idx, call_child, shards)
        if gathered is None:
            return None
        sig, stacks = gathered
        with self._lock:
            self.dispatches += 1
        # group commit: concurrent Counts fuse into one launch per group
        # and one fetch (see _batched_count)
        return self._batched_count(sig, stacks)

    def filter_stack(self, idx, call, shards):
        """Materialize a bitmap call tree as one [S, W] device stack.
        Returns (covered, stack): covered=False means the tree has shapes
        the stacked path can't express (fall back to per-shard);
        stack=None with covered=True means "no filter given". The TPU
        package evaluates the tree as one XLA elementwise program; here it
        is PyTorch elementwise ops over the cached leaves, each compressed
        leaf densified first (containers.plane_program)."""
        if call is None:
            return True, None
        shards = tuple(shards)
        gathered = self._gather(idx, call, shards)
        if gathered is None:
            return False, None
        sig, stacks = gathered
        with self._lock:
            self.dispatches += 1
        csig = tuple(c.csig for c in stacks)
        with self._dispatch_lock:
            out = _containers.plane_program(sig, csig,
                                            _containers.flatten(stacks))
        return True, out

    def row_counts(self, idx, field_name, row_ids, filt, shards,
                   view_name=VIEW_STANDARD):
        """{row_id: exact count of row ∩ filt summed over shards}, in
        O(rows/chunk) launches of K3 independent of the shard count, and
        ONE host fetch for every chunk. `filt` is a [S, W] device stack
        from filter_stack (or None). Returns None when the field/view
        vanished mid-query."""
        shards = tuple(shards)
        out = {}
        chunk_size = self.row_chunk_size(shards)
        # Oversized candidate sets can't all stay resident: build those
        # chunks transiently instead of churning out every cached chunk.
        total_bytes = (len(row_ids) * self._padded_len(shards)
                       * WORDS_PER_ROW * 4)
        cache = total_bytes <= MAX_ROWS_STACK_BYTES
        flat_filt = None if filt is None else filt.reshape(-1)
        pending = []
        for i in range(0, len(row_ids), chunk_size):
            chunk = tuple(row_ids[i:i + chunk_size])
            stack = self.rows_stack(idx, field_name, chunk, shards,
                                    view_name, cache=cache)
            if stack is None:
                return None
            with self._lock:
                self.dispatches += 1
            with self._dispatch_lock:
                counts = _row_counts_kernel(
                    stack.reshape(len(chunk), -1), flat_filt)
                if not cache and self.device.type == "cuda":
                    # Transient chunks: finish before the next one is
                    # built, so peak device memory stays ~CHUNK_BYTES.
                    del stack
                    torch.cuda.current_stream(self.device).synchronize()
            pending.append((chunk, counts))
        if pending:
            vals = self._fetch(torch.cat([c for _, c in pending])).tolist()
            k = 0
            for chunk, _ in pending:
                for row_id in chunk:
                    out[row_id] = vals[k]
                    k += 1
        return out

    def pairwise_counts(self, idx, a_field, a_rows, b_field, b_rows, filt,
                        shards, view_name=VIEW_STANDARD):
        """{(a_row, b_row): count > 0} of the two-field GroupBy cross
        product: counts[i, j] = popcount(a_rows[i] & b_rows[j] & filt)
        summed over `shards`. Both fields' row stacks come from the rows
        pool in row_chunk_size tiles ([R, S, W], patched in place like
        any chunk); each (A-tile, B-tile) pair's count matrix is ONE
        launch of K4 and ONE host fetch. Replaces the TPU package's
        `pairwise_counts_hi_lo` + host `pairwise_counts`
        (pilosa_tpu/ops/bitplane.py:238-285). Returns None when a
        field/view vanished mid-query (caller falls back)."""
        shards = tuple(shards)
        out = {}
        if not a_rows or not b_rows:
            return out
        tile = self.row_chunk_size(shards)
        row_bytes = self._padded_len(shards) * WORDS_PER_ROW * 4
        cache_a = len(a_rows) * row_bytes <= MAX_ROWS_STACK_BYTES
        cache_b = len(b_rows) * row_bytes <= MAX_ROWS_STACK_BYTES
        for i in range(0, len(a_rows), tile):
            a_chunk = tuple(a_rows[i:i + tile])
            a_stack = self.rows_stack(idx, a_field, a_chunk, shards,
                                      view_name, cache=cache_a)
            if a_stack is None:
                return None
            for j in range(0, len(b_rows), tile):
                b_chunk = tuple(b_rows[j:j + tile])
                b_stack = self.rows_stack(idx, b_field, b_chunk, shards,
                                          view_name, cache=cache_b)
                if b_stack is None:
                    return None
                with self._lock:
                    self.dispatches += 1
                    self.pairwise_dispatches += 1
                with self._dispatch_lock:
                    counts = _pairwise_kernel(a_stack, b_stack, filt)
                # ONE host fetch for the whole [tile, tile] matrix (it
                # also bounds transient tiles' device memory), shared with
                # concurrent queries through the group commit
                totals = self._fetch(counts)
                with self._lock:
                    self.pairwise_syncs += 1
                for x, y in zip(*np.nonzero(totals)):
                    out[(a_chunk[x], b_chunk[y])] = int(totals[x, y])
        return out

    def _bsi_filtered(self, idx, field, filter_call, shards):
        """(planes, sign, exists, filt) for Sum/Min/Max over `shards`, or
        None to fall back (too few shards, an uncoverable filter, or the
        field vanished)."""
        if len(shards) < MIN_SHARDS:
            return None
        covered, filt = self.filter_stack(idx, filter_call, shards)
        if not covered:
            return None
        data = self.bsi_stack(idx, field.name, shards)
        if data is None:
            return None
        return (*data, filt)

    def try_sum(self, idx, field, filter_call, shards):
        """(signed magnitude total, count) for Sum over the stacked BSI
        planes, or None to fall back: K3 over the [D, S·W] plane view
        with the positive and with the negative consider mask, and over
        the consider mask itself, then ONE host fetch. The caller adds
        base*count (field.go:1583). Python ints take Σ (pos[i] − neg[i])
        << i, which D = 64 would overflow in int64."""
        data = self._bsi_filtered(idx, field, filter_call, tuple(shards))
        if data is None:
            return None
        planes, sign, exists, filt = data
        depth = planes.shape[0]
        with self._lock:
            self.dispatches += 1
        with self._dispatch_lock:
            pos, neg, count = bsi_plane_counts(planes, sign, exists, filt)
        vals = self._fetch(torch.cat([pos, neg, count.reshape(1)])).tolist()
        total = 0
        for i in range(depth):
            total += (vals[i] - vals[depth + i]) << i
        return total, vals[-1]

    def try_minmax(self, idx, field, filter_call, shards, is_max):
        """(signed magnitude, count) of the Min/Max value over the stacked
        BSI planes, or None to fall back; (None, 0) when no column
        qualifies. The caller adds base (reference: fragment.go:1110-1227).

        Both the positive-branch and the negative-branch narrowing walks
        run (ops.bsi max/min_unsigned over [D, S, W] planes with [S, W]
        filters: the walk's any() is global over every shard), and the
        reference's sign rules pick one with 0-d device selects — Max:
        highest positive, else closest-to-zero negative; Min: most
        negative, else lowest positive — so nothing waits on the device
        until the one fetch at the end."""
        data = self._bsi_filtered(idx, field, filter_call, tuple(shards))
        if data is None:
            return None
        planes, sign, exists, filt = data
        with self._lock:
            self.dispatches += 1
        with self._dispatch_lock:
            consider = exists if filt is None else exists & filt
            pos = consider & ~sign
            neg = consider & sign
            has_pos = pos.any()
            has_neg = neg.any()
            if is_max:
                b_pos, f_pos = max_unsigned(planes, pos)
                b_neg, f_neg = min_unsigned(planes, neg)
                use_neg = ~has_pos
            else:
                b_neg, f_neg = max_unsigned(planes, neg)
                b_pos, f_pos = min_unsigned(planes, pos)
                use_neg = has_neg
            bits = torch.where(use_neg, b_neg, b_pos)
            final = torch.where(use_neg, f_neg, f_pos)
            count = _row_counts_kernel(final.reshape(1, -1))
            flags = torch.stack([has_pos | has_neg, use_neg])
        vals = self._fetch(torch.cat([flags.to(torch.int64),
                                      bits.to(torch.int64), count])).tolist()
        if not vals[0]:
            return None, 0
        mag = sum(b << i for i, b in enumerate(vals[2:-1]))
        return (-mag if vals[1] else mag), vals[-1]
