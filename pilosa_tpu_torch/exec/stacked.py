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
SHARD_WIDTH = 2^20 a 954-shard leaf stack is 125 MB). With a streaming
ingest engine (exec/ingest.py) a drifted entry whose every changed shard
is covered by a pending delta serves as it stands (`_serve_stale`), and
the engine's interval merge folds the drift in place (`merge_swap`); a
compressed leaf then takes an overlay term instead of decaying to dense.
Over budget, a pool evicts its least recently used entry, or under
`--adaptive on` its lowest heat x rebuild-cost entry (`_pop_victim`).

Every launch and every in-place patch holds one process-wide dispatch
lock, taken through `_locked_dispatch`, which attributes each launch to a
kernel family (`count`, `filter`, `row_counts`, `pairwise`, `sum`,
`minmax`, `bsi_condition`, `time_union`, the batched entries
`count_batched` / `plane_batched`, and the port's own `shift` and
`patch`): lock wait and the phases marked under the lock, flight-recorder
`dispatch.start` / `dispatch.end` events, a watchdog op, and with a query
profile active a `stacked.kernel` span. The port fetches results OUTSIDE
the lock (a host sync under it would serialize every concurrent query
behind a device round trip); `_timed_sync` times each such fetch as its
family's `sync` phase, so the phases of a family still sum to its wall
(GET /debug/dispatch). Concurrent queries are batched, as in the TPU
package:

- Counts go through a GroupCommit (`_count_commit`): the first thread to
  arrive leads and drains every Count queued meanwhile, groups them by
  signature, container signature and shapes, counts each dense group
  with ONE launch of K1's batched entry (`containers.count_program_batch`
  -> `count_expr_batch`), each block-sparse group with ONE launch of
  K2's (`count_blocks_batch`, `count_and_blocks_batch`) and each
  run-length group member by member, and fetches every total with ONE
  device->host copy. A lone Count takes the
  plain one-launch path.
- TopN, GroupBy, Sum, Min and Max share their result fetches through a
  second GroupCommit (`_fetch_commit`).
- Whole-plan fusion (exec/fusion.py) runs a query's every top-level
  Count as ONE locked dispatch (`fused_count`, family `fused`): the
  calls that end in K1 ride one launch of K1's multi-tree entry
  (`containers.count_program_multi` -> `count_expr_multi`), the others
  their own count programs, and one fetch through `_fetch_commit`
  returns every total. The "program" cached under the fusion key is the
  multi entry's device-resident program table, kept in `_fn_specs`.
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
from ..ops import count_expr as _count_expr
from ..ops.bsi import bsi_plane_counts, max_unsigned, min_unsigned
from ..ops.count_expr import tree_eval
from ..ops.pairwise import pairwise_counts_stack as _pairwise_kernel
from ..ops.row_counts import row_counts as _row_counts_kernel
from ..pql import Condition
from ..shardwidth import WORDS_PER_ROW
from ..utils import flightrec as _flightrec
from ..utils import profile as _profile
from ..utils import tracing as _tracing
from ..utils import workload as _workload
from ..utils.stats import global_stats, new_series, observe
from . import adaptive as _adaptive
from . import ingest as _ingest
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


class DeadlineExceededError(Exception):
    """The request's deadline lapsed mid-query — raised at the dispatch
    boundary BEFORE the launch, so expired work never holds the dispatch
    lock. server/api.py maps it to 504."""


_deadline_tls = threading.local()


def set_thread_deadline(at):
    """Arm (or with None, clear) this thread's request deadline — an
    absolute time.monotonic() instant. Checked before each dispatch-lock
    acquisition; the executor sets it around each query's call loop."""
    _deadline_tls.at = at


def _check_thread_deadline():
    at = getattr(_deadline_tls, "at", None)
    if at is not None and time.monotonic() >= at:
        raise DeadlineExceededError(
            "request deadline expired before dispatch")

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


#: process-wide dispatch-phase aggregate, folded in lockstep with each
#: evaluator's own table: the bare flightrec debug server serves it at
#: GET /debug/dispatch without a handle on any evaluator. The one lock
#: below also guards every evaluator's `_kernels` / `_dispatch_phases`
#: and the registry series next to it, so a launch's bookkeeping takes
#: one lock.
_GLOBAL_PHASES = {}
_GLOBAL_PHASES_LOCK = threading.Lock()

#: the dispatch families' registry series, process-wide like the TPU
#: package's: `kernel_seconds{kernel}` and `dispatch_phase_seconds{kernel,
#: phase}` timings and `kernel_bytes_in/out{kernel}` counters. Launches
#: fold into them under _GLOBAL_PHASES_LOCK, and the global registry adds
#: them to its exposition at scrape time (_dispatch_series is its source)
#: rather than taking its own lock for each of a launch's five to seven
#: observations.
_SERIES = {}  # (kind, phase or None) -> series
_COUNTERS = {}  # registry key -> bytes


def _series(kind, phase=None):
    """The registry series `kernel_seconds{kernel}`, or with a phase
    `dispatch_phase_seconds{kernel,phase}` (caller holds
    _GLOBAL_PHASES_LOCK)."""
    series = _SERIES.get((kind, phase))
    if series is None:
        series = _SERIES[(kind, phase)] = new_series()
    return series


def _dispatch_series():
    """The registry's scrape-time source: copies of _COUNTERS, _SERIES."""
    with _GLOBAL_PHASES_LOCK:
        series = {}
        for (kind, phase), v in _SERIES.items():
            key = ("kernel_seconds", (("kernel", kind),)) if phase is None \
                else ("dispatch_phase_seconds",
                      (("kernel", kind), ("phase", phase)))
            series[key] = [v[0], v[1], list(v[2]), v[3]]
        return dict(_COUNTERS), series


global_stats.add_source(_dispatch_series)


def global_dispatch_phases():
    """{kernel: {phase: {count, seconds}}} across every evaluator in the
    process (utils/flightrec._DebugHandler)."""
    with _GLOBAL_PHASES_LOCK:
        return {k: {p: dict(v) for p, v in fam.items()}
                for k, fam in _GLOBAL_PHASES.items()}


def reset_global_dispatch_phases():
    """Pristine module aggregates (tests)."""
    with _GLOBAL_PHASES_LOCK:
        _GLOBAL_PHASES.clear()
        _SERIES.clear()
        _COUNTERS.clear()


#: dispatch-phase taxonomy (GET /debug/dispatch): lock_wait is measured by
#: _locked_dispatch itself; dispatch_ack (the launch calls returned) and,
#: where a site blocks under the lock, sync are marked inside the lock;
#: sync is also the phase _timed_sync records for a fetch made after the
#: lock is released. compile labels the first fused dispatch of a program
#: key (`fused_count`): the port compiles nothing at run time, so its
#: "compile" is that dispatch, the building and upload of the multi-tree
#: entry's program table included. The TPU package's transfer_in phase
#: does not occur: uploads run outside the lock.
DISPATCH_PHASES = ("lock_wait", "compile", "dispatch_ack", "sync")


class _PhaseClock:
    """Phase marks within one locked dispatch. `mark(phase)` attributes
    the time since the previous mark (or lock acquisition) to `phase`;
    _locked_dispatch folds any residual into the last mark on exit so the
    per-phase seconds sum EXACTLY to the dispatch wall."""

    __slots__ = ("_t", "phases")

    def __init__(self, t1):
        self._t = t1
        self.phases = []

    def mark(self, phase):
        now = time.perf_counter()
        self.phases.append([phase, now - self._t])
        self._t = now


class _LockedDispatch:
    """StackedEvaluator._locked_dispatch's context manager (a class, not
    a generator: it runs around every launch)."""

    __slots__ = ("ev", "kind", "nbytes_in", "nbytes_out", "prof", "token",
                 "t0", "t1", "ph", "span_cm", "span")

    def __init__(self, ev, kind, nbytes_in, nbytes_out):
        self.ev = ev
        self.kind = kind
        self.nbytes_in = nbytes_in
        self.nbytes_out = nbytes_out

    def __enter__(self):
        _check_thread_deadline()
        kind = self.kind
        self.prof = _profile.current()
        _flightrec.record("dispatch.start", kernel=kind)
        self.token = _flightrec.watch_begin("dispatch." + kind)
        self.t0 = time.perf_counter()
        try:
            self.ev._dispatch_lock.acquire()
        except BaseException:
            _flightrec.watch_end(self.token)
            raise
        self.t1 = time.perf_counter()
        self.ph = _PhaseClock(self.t1)
        self.span_cm = None
        if self.prof is not None:
            self.span_cm = _tracing.start_span("stacked.kernel", op=kind)
            self.span = self.span_cm.__enter__()
            if self.span is not None:
                self.span.set_tag("lock_wait_seconds",
                                  round(self.t1 - self.t0, 6))
        return self.ph

    def __exit__(self, exc_type, exc, tb):
        ph = self.ph
        try:
            if self.span_cm is not None:
                if self.span is not None and exc_type is None:
                    for phase, dt in ph.phases:
                        self.span.set_tag(f"phase_{phase}_seconds",
                                          round(dt, 6))
                self.span_cm.__exit__(exc_type, exc, tb)
            t2 = time.perf_counter()
        finally:
            self.ev._dispatch_lock.release()
            _flightrec.watch_end(self.token)
        if exc_type is not None:
            return False
        kind, t1 = self.kind, self.t1
        wait, wall = t1 - self.t0, t2 - t1
        # fold the residual (span bookkeeping, unmarked tails) into the
        # last phase so the phases sum exactly to the dispatch wall; a
        # site that never marked attributes its whole wall in one piece
        if ph.phases:
            ph.phases[-1][1] += t2 - ph._t
        else:
            ph.phases.append(["dispatch_ack", wall])
        phases = [("lock_wait", wait)] + [tuple(p) for p in ph.phases]
        self.ev._note(kind, phases, wall, self.nbytes_in, self.nbytes_out)
        _flightrec.record("dispatch.end", kernel=kind,
                          lock_wait_seconds=round(wait, 6),
                          kernel_wall_seconds=round(wall, 6))
        prof = self.prof
        if prof is not None:
            prof.add("dispatch_lock_wait_seconds", wait)
            prof.add("kernel_wall_seconds", wall)
            prof.add("locked_dispatches", 1)
            for phase, dt in phases[1:]:  # lock_wait counted above
                prof.add(f"phase_{phase}_seconds", dt)
        return False


class _TimedSync:
    """StackedEvaluator._timed_sync's context manager."""

    __slots__ = ("ev", "kind", "t0")

    def __init__(self, ev, kind):
        self.ev = ev
        self.kind = kind

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        dt = time.perf_counter() - self.t0
        self.ev._note(self.kind, (("sync", dt),), dt, launch=False)
        prof = _profile.current()
        if prof is not None:
            prof.add("kernel_wall_seconds", dt)
            prof.add("phase_sync_seconds", dt)
        return False


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


def _device_memory():
    """Per-card memory headroom from torch, or None. Read only when CUDA
    is ALREADY initialized in this process (a snapshot must never be
    what initializes the card): bytes the allocator holds for tensors,
    bytes it has reserved, the card's total and free memory, and the
    headroom — free memory plus what the allocator reserved but no
    tensor uses."""
    try:
        if not torch.cuda.is_initialized():
            return None
        out = []
        for i in range(torch.cuda.device_count()):
            mem = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
            in_use = int(mem.get("allocated_bytes.all.current", 0))
            reserved = int(mem.get("reserved_bytes.all.current", 0))
            out.append({"device": f"cuda:{i}", "platform": "cuda",
                        "bytes_in_use": in_use,
                        "bytes_reserved": reserved,
                        "bytes_limit": int(total),
                        "bytes_free": int(free),
                        "headroom_bytes": int(free) + reserved - in_use})
        return out or None
    except Exception:  # noqa: BLE001 — a card gone or no CUDA build
        return None


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


def minmax_walk(planes, sign, exists, filt, is_max):
    """The Min/Max walk over [D, S, W] BSI planes with [S, W] sign,
    exists and optional filter stacks, on their device, as one int64
    tensor [2 + D + 1]: (non-empty, negative branch chosen, the D bits
    LSB first, the count of columns at the extreme). Both the
    positive-branch and the negative-branch narrowing walks run (ops.bsi
    max/min_unsigned: the walk's any() is global over every shard), and
    the reference's sign rules pick one with 0-d device selects — Max:
    highest positive, else closest-to-zero negative; Min: most negative,
    else lowest positive — so nothing waits on the device. The count is
    one K3 launch (`minmax_decode` reads the tensor)."""
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
    return torch.cat([flags.to(torch.int64), bits.to(torch.int64), count])


def minmax_decode(vals):
    """(non-empty, negative, magnitude, count) from `minmax_walk`'s
    fetched values."""
    mag = sum(b << i for i, b in enumerate(vals[2:-1]))
    return bool(vals[0]), bool(vals[1]), mag, vals[-1]


class StackedEvaluator:
    def __init__(self, device, budget_parts=1):
        self.device = torch.device(device)
        # a part of a node split over several (exec/parts.py) holds 1/k
        # of every stack, so its pools take 1/k of the node's budgets and
        # its ledger gauges report the node's bytes, summed over the
        # parts (`_siblings`); one part is the whole node
        self.budget_parts = int(budget_parts)
        self._siblings = (self,)
        self._cards = (self.device,)
        # two byte-budgeted LRU pools, picked by _pool_of(key): "leaf"
        # (Count leaves, [S, W] Containers, and BSI [D+2, S, W] stacks)
        # and "rows" (TopN/GroupBy row chunks and time-view rows,
        # [R, S, W] tensors); entry = [gens, value, nbytes, stamp,
        # last-hit time]
        self._pools = {"leaf": OrderedDict(), "rows": OrderedDict()}
        self._pool_bytes = {"leaf": 0, "rows": 0}
        self._pool_evictions = {"leaf": 0, "rows": 0}
        # {(pool name, cause): evictions}, cause "budget" or "invalidate";
        # the pool names are the TPU package's ("stack" is the leaf pool)
        self.pool_evictions = {}
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
        # device bytes resident per (pool, index, field, repr)
        self._hbm_ledger = {}
        # per-kernel-family attribution: {kind: {count, seconds, bytes_in,
        # bytes_out}} and {kind: {phase: {count, seconds}}}
        self._kernels = {}
        self._dispatch_phases = {}
        # launched kernel shapes per family: (family, kernel, shape) ->
        # the wrapper's declared-cost arguments, noted at the launch
        # site; their costs are computed on the first GET /debug/kernels
        # and cached in _kernel_costs (the planner's third price source);
        # beside them, under ("fused", plans), whole-plan fusion's
        # programs (count_expr.MultiProgram), which its LRU evicts
        self._fn_specs = {}
        self._kernel_costs = {}
        self._count_spec_keys = set()
        # streaming ingest: reads served from a stale entry whose drift
        # is covered by pending ingest deltas (exec/ingest.py)
        self.stale_serves = 0
        # whole-plan fusion: queries whose every top-level Count rode
        # ONE fused dispatch (exec/fusion.py)
        self.fused_dispatches = 0

    def counters(self):
        """(dispatches, hits, misses, planes_uploaded) — the per-query
        delta source of the workload table: a bare tuple read, since it
        runs twice per query."""
        with self._lock:
            return (self.dispatches, self.hits, self.misses,
                    self.planes_uploaded)

    def cache_stats(self):
        with self._lock:
            return {"dispatches": self.dispatches, "hits": self.hits,
                    "misses": self.misses,
                    "evictions": self._pool_evictions["leaf"],
                    "patches": self.patches,
                    "stale_serves": self.stale_serves,
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
                    "fused_dispatches": self.fused_dispatches,
                    "evictions_by_cause": {
                        f"{p}.{c}": n
                        for (p, c), n in sorted(self.pool_evictions.items())},
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

    @staticmethod
    def _heat_key(key):
        """(index, field, view) for the fragment heat ledger. Leaf and
        rows stacks cache the standard view (rows keys carry the actual
        view name at key[3] — time-quantum views differ); BSI stacks
        cache the field's BSI bit planes."""
        if key[0] == "rows":
            return key[1], key[2], key[3]
        if key[0] == "bsi":
            return key[1], key[2], "bsi"
        return key[1], key[2], VIEW_STANDARD

    def _cache_get_fast(self, key, stamp):
        """O(1) hit check via the view-level (uid, mutations) stamp: a
        match proves no fragment of the view changed since the put, so
        the per-shard generation walk is skipped."""
        with self._lock:
            entries = self._pools[self._pool_of(key)]
            hit = entries.get(key)
            if hit is not None and hit[3] == stamp:
                entries.move_to_end(key)
                hit[4] = time.time()  # last-hit age for /debug/hbm
                self.hits += 1
                hit = hit[1]
            else:
                hit = None
        if hit is not None:
            # heat rides every probe that RESOLVED here (outside the
            # evaluator lock: the ledger has its own)
            _workload.heat_bump(*self._heat_key(key))
        return hit

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
                hit[4] = time.time()
                self.hits += 1
                hit = hit[1]
            else:
                self.misses += 1
                hit = None
        # misses bump too: demand for an absent fragment is precisely
        # what makes it an admission candidate in /debug/heat
        _workload.heat_bump(*self._heat_key(key))
        return hit

    @staticmethod
    def _pool_name(pool):
        """The TPU package's name of a pool in metrics and events."""
        return "stack" if pool == "leaf" else pool

    def _ledger_add(self, key, delta, repr_kind="dense"):
        """Move the per-(pool, index, field, repr) byte ledger in lockstep
        with the pool byte counter (caller holds self._lock), and its
        `hbm_stack_bytes` gauge with it: puts and evictions are cache-fill
        events, not the per-query hot path."""
        pool = self._pool_of(key)
        lkey = (pool, key[1], key[2], repr_kind)
        new = self._hbm_ledger.get(lkey, 0) + delta
        if new <= 0:
            self._hbm_ledger.pop(lkey, None)
        else:
            self._hbm_ledger[lkey] = new
        if len(self._siblings) > 1:
            new = sum(s._hbm_ledger.get(lkey, 0) for s in self._siblings)
        global_stats.gauge("hbm_stack_bytes", max(new, 0), {
            "index": key[1], "field": key[2],
            "pool": self._pool_name(pool), "repr": repr_kind})

    def _count_eviction(self, pool_name, cause, n=1):
        """Per-pool, cause-tagged eviction counters (caller holds
        self._lock); exported as stacked_evictions_total{pool,cause}."""
        k = (pool_name, cause)
        self.pool_evictions[k] = self.pool_evictions.get(k, 0) + n
        global_stats.count("stacked_evictions", n,
                           {"pool": pool_name, "cause": cause})

    def _budget(self, pool):
        return (MAX_STACK_BYTES if pool == "leaf"
                else MAX_ROWS_STACK_BYTES) // self.budget_parts

    def _pop_victim(self, entries):
        """One over-budget victim of a pool (caller holds self._lock).
        Least recently used when the adaptive engine is off; the lowest
        heat x cost benefit score when on — which may be the entry just
        inserted, making the score an admission filter too; shadow
        scores, counts the divergence, and still evicts LRU. Heat reads
        are decayed point lookups in the workload ledger (its own lock —
        the ledger never calls back into this module, so the ordering is
        one-way)."""
        amode = _adaptive.cache_mode()
        lru_key = next(iter(entries))
        if amode == "off":
            ekey = lru_key
        else:
            heat = _workload.heat()
            best = _adaptive.select_victim(
                [(k, heat.value(*self._heat_key(k)), e[2])
                 for k, e in entries.items()])
            if amode == "on":
                ekey = best
                _adaptive.note_eviction("benefit")
            else:
                ekey = lru_key
                _adaptive.note_eviction("lru", diverged=best != lru_key)
        return ekey, entries.pop(ekey)

    def _cache_put(self, key, gens, value, nbytes, stamp=None):
        pool = self._pool_of(key)
        pool_name = self._pool_name(pool)
        entries = self._pools[pool]
        repr_kind = _containers.kind_of(value)
        evicted_keys = []
        with self._lock:
            old = entries.pop(key, None)
            if old is not None:
                self._pool_bytes[pool] -= old[2]
                self._ledger_add(key, -old[2], _containers.kind_of(old[1]))
            entries[key] = [gens, value, nbytes, stamp, time.time()]
            self._pool_bytes[pool] += nbytes
            self._ledger_add(key, nbytes, repr_kind)
            while self._pool_bytes[pool] > self._budget(pool) \
                    and len(entries) > 1:
                ekey, evicted = self._pop_victim(entries)
                self._pool_bytes[pool] -= evicted[2]
                self._ledger_add(ekey, -evicted[2],
                                 _containers.kind_of(evicted[1]))
                self._pool_evictions[pool] += 1
                self._count_eviction(pool_name, "budget")
                evicted_keys.append((ekey, evicted[2]))
        _flightrec.record("cache.put", pool=pool_name, index=key[1],
                          field=key[2], bytes=nbytes, repr=repr_kind)
        for ekey, ebytes in evicted_keys:
            _flightrec.record("cache.evict", pool=pool_name, index=ekey[1],
                              field=ekey[2], bytes=ebytes, cause="budget")

    def merge_swap(self, key, old_entry, gens, value, nbytes):
        """Install an ingest merge's result over the exact entry it was
        planned from (identity compare — a concurrent rebuild or
        eviction wins and the merge result is dropped). The entry
        updates IN PLACE under the lock; the stamp resets to None so the
        next read revalidates with one gens walk instead of trusting a
        view stamp that predates the merge. Returns True on install."""
        pool = self._pool_of(key)
        with self._lock:
            cur = self._pools[pool].get(key)
            if cur is not old_entry:
                return False
            old_bytes = cur[2]
            old_kind = _containers.kind_of(cur[1])
            cur[0] = gens
            cur[1] = value
            cur[2] = nbytes
            cur[3] = None
            cur[4] = time.time()
            self._pool_bytes[pool] += nbytes - old_bytes
            self._ledger_add(key, -old_bytes, old_kind)
            self._ledger_add(key, nbytes, _containers.kind_of(value))
        self._note_patch("merge")
        return True

    def merge_drop(self, key, old_entry):
        """Evict an entry the ingest merge decided not to fold (too
        drifted, vanished field): the next read rebuilds cold. Identity
        compare like merge_swap. Returns True when dropped."""
        pool = self._pool_of(key)
        with self._lock:
            cur = self._pools[pool].get(key)
            if cur is not old_entry:
                return False
            self._pools[pool].pop(key)
            self._pool_bytes[pool] -= cur[2]
            self._pool_evictions[pool] += 1
            self._ledger_add(key, -cur[2], _containers.kind_of(cur[1]))
            self._count_eviction(self._pool_name(pool), "ingest")
        return True

    def invalidate(self):
        """Drop every cached stack of both pools; the ledger gauges go to
        zero (a scraper must see the flush), each dropped entry counts as
        an `invalidate` eviction, and one `cache.invalidate` event
        records the flush."""
        with self._lock:
            n_stack = len(self._pools["leaf"])
            n_rows = len(self._pools["rows"])
            for pool in self._pools:
                self._pools[pool].clear()
                self._pool_bytes[pool] = 0
            for (pool, index, field, repr_kind) in list(self._hbm_ledger):
                global_stats.gauge("hbm_stack_bytes", 0, {
                    "index": index, "field": field,
                    "pool": self._pool_name(pool), "repr": repr_kind})
            self._hbm_ledger.clear()
            if n_stack:
                self._count_eviction("stack", "invalidate", n_stack)
            if n_rows:
                self._count_eviction("rows", "invalidate", n_rows)
        if n_stack or n_rows:
            _flightrec.record("cache.invalidate", stack_entries=n_stack,
                              rows_entries=n_rows)

    def hbm_ledger(self, pool="leaf"):
        """{(index, field): resident device bytes} of one pool over every
        part; sums to that pool's byte counters."""
        out = {}
        for part in self._caches():
            with part._lock:
                for (p, index, field, _), v in part._hbm_ledger.items():
                    if p == pool:
                        out[(index, field)] = out.get((index, field), 0) + v
        return out

    def hbm_snapshot(self, top=50):
        """What is resident on the device and for whom (GET /debug/hbm):
        per-(index, field, pool) byte attribution from the repr-keyed
        ledger, the resident entries ranked by bytes with last-hit age,
        eviction causes, and the card's headroom from torch. Pools carry
        the TPU package's names ("stack" is the leaf pool). `total_bytes`
        is EXACTLY the two pools' byte counters (the ledger moves in
        lockstep under the same lock). A node of several parts sums its
        parts' (the budgets are the node's), tags each entry with its
        part and card, and adds the bytes `by_part` and `by_device`."""
        now = time.time()
        caches = self._caches()
        entries, ledger, evictions = [], {}, {}
        pool_bytes = {"leaf": 0, "rows": 0}
        pool_entries = {"leaf": 0, "rows": 0}
        by_part = []
        for n, part in enumerate(caches):
            with part._lock:
                for pool, entries_of in part._pools.items():
                    pool_bytes[pool] += part._pool_bytes[pool]
                    pool_entries[pool] += len(entries_of)
                    for key, entry in entries_of.items():
                        e = {
                            "pool": self._pool_name(pool),
                            "kind": key[0],
                            "index": key[1],
                            "field": key[2],
                            "bytes": entry[2],
                            "repr": _containers.kind_of(entry[1]),
                            "last_hit_age_seconds": round(now - entry[4], 3),
                            "key": repr(key),
                        }
                        if isinstance(entry[1], _containers.Container):
                            ratio = entry[1].meta.get("ratio")
                            if ratio is not None:
                                e["compression_ratio"] = ratio
                            if entry[1].overlay:
                                e["overlay_terms"] = entry[1].overlay
                        if len(caches) > 1:
                            e["part"] = n
                            e["device"] = str(part.device)
                        entries.append(e)
                for k, b in part._hbm_ledger.items():
                    ledger[k] = ledger.get(k, 0) + b
                for k, c in part.pool_evictions.items():
                    evictions[k] = evictions.get(k, 0) + c
                by_part.append({"part": n, "device": str(part.device),
                                "bytes": sum(part._pool_bytes.values())})
        agg = {}
        by_repr = {}
        for (p, i, f, r), b in ledger.items():
            k = (i, f, self._pool_name(p))
            agg[k] = agg.get(k, 0) + b
            by_repr[r] = by_repr.get(r, 0) + b
        snap = {
            "total_bytes": sum(pool_bytes.values()),
            "stack_bytes": pool_bytes["leaf"],
            "stack_entries": pool_entries["leaf"],
            "stack_budget_bytes": MAX_STACK_BYTES,
            "rows_stack_bytes": pool_bytes["rows"],
            "rows_stack_entries": pool_entries["rows"],
            "rows_stack_budget_bytes": MAX_ROWS_STACK_BYTES,
            "by_index_field": [
                {"index": i, "field": f, "pool": p, "bytes": b}
                for (i, f, p), b in sorted(
                    agg.items(), key=lambda kv: -kv[1])],
            "by_index_field_repr": [
                {"index": i, "field": f, "pool": self._pool_name(p),
                 "repr": r, "bytes": b}
                for (p, i, f, r), b in sorted(
                    ledger.items(), key=lambda kv: -kv[1])],
            "by_repr": by_repr,
            "evictions": {
                f"{p}.{c}": n for (p, c), n in sorted(evictions.items())},
        }
        entries.sort(key=lambda e: -e["bytes"])
        snap["entries"] = entries[:top]
        if len(caches) > 1:
            snap["by_part"] = by_part
            by_device = {}
            for e in by_part:
                d = by_device.setdefault(e["device"], {
                    "device": e["device"], "parts": 0, "bytes": 0})
                d["parts"] += 1
                d["bytes"] += e["bytes"]
            snap["by_device"] = list(by_device.values())
        snap["container_fragments"] = _containers.fragment_ledger()
        snap["device_memory"] = _device_memory()
        return snap

    def _stale_entry(self, key, gens):
        """The cached entry for `key` whose shard set matches `gens`
        (its generations may have drifted), or None."""
        with self._lock:
            entry = self._pools[self._pool_of(key)].get(key)
            if entry is None or len(entry[0]) != len(gens):
                return None
            return entry

    def _changed_shards(self, old_gens, gens, shards, rows=1):
        """Stack row indices whose (uid, generation) drifted, or None
        when a patch isn't worthwhile. The cutoff is the static
        half-the-shards rule (a copy past it costs about as much as a
        rebuild) — except under --adaptive on, where the cost model
        prices upload vs on-device copy bytes (exec/adaptive.decide_patch)
        and typically patches up to ~7/8 drift."""
        changed = [j for j, (o, n) in enumerate(zip(old_gens, gens))
                   if o != n]
        if not changed:
            return None
        if _adaptive.acting():
            if not _adaptive.decide_patch(len(changed), len(shards), rows,
                                          WORDS_PER_ROW * 4):
                return None
        elif len(changed) * 2 > len(shards):
            return None
        return changed

    def _note_patch(self, path):
        """Count one incremental stack patch, tagged by where it ran:
        "read" = the in-query repair, "merge" = the ingest engine's
        interval fold. Exported as stacked_patches_total{path} so the two
        are distinguishable on /metrics (the ingest tests assert the
        read-path count stays flat while deltas are pending)."""
        with self._lock:
            self.patches += 1
        global_stats.count("stacked_patches", 1, {"path": path})

    def _serve_stale(self, key, view, shards, stale, gens):
        """True when a stale entry may serve AS-IS because every drifted
        shard is covered by a pending ingest delta (exec/ingest.py) — the
        interval merge folds the drift off the read path; staleness is
        bounded by the merge interval. One list check when no ingest
        engine is active (the default)."""
        if not _ingest.covers_pending(key[1], key[2], view.name, shards,
                                      stale[0], gens):
            return False
        with self._lock:
            self.stale_serves += 1
        global_stats.count("stacked_stale_serves", 1)
        return True

    def _patch(self, key, stale, gens, stamp, view, row_ids, shards):
        """Re-gather only the drifted shards of a cached stack and copy
        them into it in place, or None when a patch isn't worthwhile."""
        changed = self._changed_shards(stale[0], gens, shards,
                                       rows=len(row_ids))
        if changed is None:
            return None
        block = self._host_rows(view, row_ids, [shards[j] for j in changed],
                                pad=False)
        value, nbytes = stale[1], stale[2]
        cols = torch.tensor(changed, dtype=torch.long, device=self.device)
        with self._locked_dispatch("patch", nbytes_in=block.nbytes,
                                   nbytes_out=block.nbytes) as ph:
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
            ph.mark("dispatch_ack")
        self._note_patch("read")
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
            if self._serve_stale(key, view, shards, stale, gens):
                return stale[1]
            patched = self._patch(key, stale, gens, stamp, view, [row_id],
                                  shards)
            if patched is not None:
                return patched
        host = self._host_rows(view, [row_id], shards)
        cont = _containers.build(
            host[0], self.device,
            fragment=(idx.name, field_name, VIEW_STANDARD, row_id))
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
                if self._serve_stale(key, view, shards, stale, gens):
                    return stale[1]
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
        self._note_spec("bsi_condition", "bsi_range_mask",
                        (planes.shape[0], sign.numel()))
        with self._locked_dispatch(
                "bsi_condition",
                nbytes_in=(planes.numel() + sign.numel()
                           + exists.numel()) * 4,
                nbytes_out=sign.numel() * 4) as ph:
            out = apply_bsi_condition(plan, planes, sign, exists)
            ph.mark("dispatch_ack")
            return out

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
        with self._locked_dispatch(
                "time_union",
                nbytes_in=sum(s.numel() for s in stacks) * 4,
                nbytes_out=stacks[0].numel() * 4) as ph:
            out = tree_eval(("|", tuple(("leaf", i)
                                        for i in range(len(stacks)))),
                            stacks)
            ph.mark("dispatch_ack")
            return out

    def _host_rows(self, view, row_ids, shards, pad=True):
        """Host [R, S, W] uint32 gather of rows over shards (pad=False
        skips the padding of the shard axis to `_padded_len` — patch and
        merge gathers address existing stack rows directly; one device
        pads nothing either way). The per-shard gathers fan out over the
        shared worker pool: each task fills its own out[:, j] column, and
        the numpy copies release the GIL."""
        from ..utils.workpool import get_pool

        n = self._padded_len(shards) if pad else len(shards)
        out = np.zeros((len(row_ids), n, WORDS_PER_ROW), dtype=np.uint32)

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
        rows [R, S, W] stacks must agree. One part, so no padding (a node
        of k parts pads to a multiple of k, exec/parts.py, as the TPU
        package pads to a multiple of its mesh's devices)."""
        return len(shards)

    # -- parts: the layout hooks a node of several overrides (exec/parts.py)

    def split(self, shards):
        """Each part's range of `shards`: one part holds them all."""
        return [tuple(shards)]

    def _caches(self):
        """The evaluators whose pools hold the stacks, one a part."""
        return (self,)

    def _tensors(self, stack):
        """Each part's tensor of a stack (None, no filter: None a part)."""
        return [stack]

    def _join(self, tensors, n_shards):
        """The stack over `n_shards` shards made of each part's tensor."""
        return tensors[0]

    def _leaf_parts(self, stacks):
        """Each part's leaf containers of a gathered tree."""
        return [stacks]

    def _plan_parts(self, plans):
        """Each part's fused plans: (sig, csig) a call, the csig that
        part's containers'."""
        return [plans]

    def _part_args(self, stacks):
        """[(csig, flat args)] a part of a gathered tree's leaves."""
        return [(tuple(c.csig for c in conts), _containers.flatten(conts))
                for conts in self._leaf_parts(stacks)]

    def _reduce(self, outs):
        """Σ of the parts' int64 partials (one shape) on the first part's
        card: a peer copy for a part on another card, none on the first;
        one part's own partial as it is."""
        acc = outs[0]
        for o in outs[1:]:
            acc = acc + o.to(self.device, non_blocking=True)
        return acc

    def host_planes(self, stack):
        """Host uint32 [S, W] words of a `filter_stack` result: the
        parts' planes in shard order, any padding dropped."""
        tensors = self._tensors(stack)
        if len(tensors) == 1:
            return _bitplane.to_host(tensors[0])
        return np.concatenate([_bitplane.to_host(t)
                               for t in tensors])[:stack.n_shards]

    def row_chunk_size(self, shards):
        """Rows per [R, S, W] chunk under the CHUNK_BYTES budget."""
        return max(
            1, CHUNK_BYTES // (self._padded_len(shards) * WORDS_PER_ROW * 4))

    # -- dispatch attribution (GET /debug/dispatch) ---------------------------

    def _locked_dispatch(self, kind, nbytes_in=0, nbytes_out=0):
        """Context manager holding the process-wide dispatch lock around
        one launch.

        Always on (a few dict and deque operations beside a launch):
        per-family wall and bytes (`kernel_seconds{kernel}` histograms),
        `dispatch.start` / `dispatch.end` flight-recorder events, and a
        watchdog op covering the lock wait and hold. With a QueryProfile
        active it also opens a `stacked.kernel` span (op=kind) and adds
        this query's lock wait, kernel wall and phases to the profile.

        Yields a _PhaseClock: sites mark "dispatch_ack" once the launch
        calls return (and "sync" where they block under the lock). The
        result fetch that follows OUTSIDE the lock is timed by
        `_timed_sync` under the same family."""
        return _LockedDispatch(self, kind, nbytes_in, nbytes_out)

    def _timed_sync(self, kind):
        """Context manager timing a device->host fetch made after the
        dispatch lock was released as the `sync` phase of family `kind`:
        it joins the family's wall (so its phases still sum to that wall)
        and, with a profile active, the query's kernel wall and
        phase_sync_seconds. The lock is not held, so concurrent queries
        launch meanwhile."""
        return _TimedSync(self, kind)

    def _note(self, kind, phases, wall, nbytes_in=0, nbytes_out=0,
              launch=True):
        """Fold one locked dispatch (`launch`: its wall, bytes and
        phases, lock_wait first) or one fetch after it (a lone sync
        phase) into the family's tables, the process-wide aggregate and
        the registry series, under one lock. With exemplars on, the
        registry takes the observations itself, so each keeps its
        trace id."""
        exemplars = global_stats._exemplars_on
        with _GLOBAL_PHASES_LOCK:
            k = self._kernels.get(kind)
            if k is None:
                k = self._kernels[kind] = {
                    "count": 0, "seconds": 0.0,
                    "bytes_in": 0, "bytes_out": 0}
            k["seconds"] += wall
            fam = self._dispatch_phases.get(kind)
            if fam is None:
                fam = self._dispatch_phases[kind] = {}
                _GLOBAL_PHASES.setdefault(kind, {})
            gfam = _GLOBAL_PHASES[kind]
            for phase, dt in phases:
                for table in (fam, gfam):
                    p = table.get(phase)
                    if p is None:
                        p = table[phase] = {"count": 0, "seconds": 0.0}
                    p["count"] += 1
                    p["seconds"] += dt
                if not exemplars:
                    observe(_series(kind, phase), dt)
            if launch:
                k["count"] += 1
                k["bytes_in"] += nbytes_in
                k["bytes_out"] += nbytes_out
                if not exemplars:
                    observe(_series(kind), wall)
                    tags = (("kernel", kind),)
                    if nbytes_in:
                        key = ("kernel_bytes_in", tags)
                        _COUNTERS[key] = _COUNTERS.get(key, 0.0) + nbytes_in
                    if nbytes_out:
                        key = ("kernel_bytes_out", tags)
                        _COUNTERS[key] = _COUNTERS.get(key, 0.0) + nbytes_out
        if exemplars:
            for phase, dt in phases:
                global_stats.timing("dispatch_phase_seconds", dt,
                                    {"kernel": kind, "phase": phase})
            if launch:
                tags = {"kernel": kind}
                global_stats.timing("kernel_seconds", wall, tags)
                if nbytes_in:
                    global_stats.count("kernel_bytes_in", nbytes_in, tags)
                if nbytes_out:
                    global_stats.count("kernel_bytes_out", nbytes_out,
                                       tags)

    def dispatch_phases(self):
        """{kernel: {phase: {count, seconds}}} snapshot — the round-trip
        decomposition behind GET /debug/dispatch. Phase seconds other
        than lock_wait sum to the family's wall (`kernel_walls`) by
        construction; lock_wait counts one per locked dispatch."""
        with _GLOBAL_PHASES_LOCK:
            return {k: {p: dict(v) for p, v in fam.items()}
                    for k, fam in self._dispatch_phases.items()}

    def kernel_walls(self):
        """{kernel: {count, seconds, bytes_in, bytes_out}}: locked
        dispatches per family and their wall, the fetches timed by
        `_timed_sync` included."""
        with _GLOBAL_PHASES_LOCK:
            return {k: dict(v) for k, v in self._kernels.items()}

    # -- evaluation ----------------------------------------------------------

    def _count_fn(self, sig, stacks):
        """Tree -> exact int count over all shards: one count program
        over the leaves' containers (K2 for sparse leaves, torch sums for
        rle ones, else K1 over the densified tree) under the dispatch
        lock, then one host sync after it. A node of several parts runs
        the program once a part and sums the partials on its first card."""
        args = self._part_args(stacks)
        for csig, flat in args:
            self._note_count_specs("count", sig, csig, flat)
        with self._locked_dispatch(
                "count", nbytes_in=sum(c.nbytes for c in stacks),
                nbytes_out=8 * len(args)) as ph:
            total = self._reduce([_containers.count_program(sig, csig, flat)
                                  for csig, flat in args])
            ph.mark("dispatch_ack")
        with self._timed_sync("count"):
            return int(total)

    def fused_count(self, plans, stacks_per_call):
        """A whole query's Count calls as ONE locked dispatch + one
        group-committed fetch (exec/fusion.py; the TPU package's
        `fused_count`). `plans` is a tuple of (sig, csig) per top-level
        call; the trees need not share a signature. Returns (counts,
        key, compiled): per-call host ints in call order, the program's
        key in `_fn_specs` (fusion's LRU eviction pops it), and whether
        THIS call built the program: the first on a key, whose dispatch
        is the `compile` phase. The program is the multi-tree entry's
        count_expr.MultiProgram a part (each part's calls route by its
        own containers), its device table uploaded by that first
        dispatch; the parts' [n] totals sum on the first card."""
        key = ("fused", plans)
        plans_parts = self._plan_parts(plans)
        with self._lock:
            programs = self._fn_specs.get(key)
            compiled = programs is None
            if compiled:
                programs = self._fn_specs[key] = [
                    _count_expr.MultiProgram() for _ in plans_parts]
            self.dispatches += 1
            self.fused_dispatches += 1
        per_call = [self._leaf_parts(stacks) for stacks in stacks_per_call]
        flats_parts = []
        for p, plans_p in enumerate(plans_parts):
            flats = [_containers.flatten(parts[p]) for parts in per_call]
            self._note_fused_specs(plans_p, flats)
            flats_parts.append(flats)
        with self._locked_dispatch(
                "fused",
                nbytes_in=sum(c.nbytes for stacks in stacks_per_call
                              for c in stacks),
                nbytes_out=8 * len(plans)) as ph:
            out = self._reduce([
                _containers.count_program_multi(plans_p, flats,
                                                program=program)
                for plans_p, flats, program in zip(plans_parts, flats_parts,
                                                   programs)])
            ph.mark("compile" if compiled else "dispatch_ack")
        with self._timed_sync("fused"):
            counts = [int(v) for v in self._fetch(out)]
        return counts, key, compiled

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
        dense group of two or more, one of K2's for a block-sparse one),
        and every group's totals come back in ONE device->host copy."""
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
        for (sig, _csig, _gsig), positions in groups.items():
            for i in range(0, len(positions), self.MAX_COUNT_BATCH):
                chunk = positions[i:i + self.MAX_COUNT_BATCH]
                members = [payloads[pos][1] for pos in chunk]
                with self._locked_dispatch(
                        "count",
                        nbytes_in=sum(c.nbytes for m in members for c in m),
                        nbytes_out=8 * len(chunk)) as ph:
                    out = self._count_group("count", sig, members)
                    ph.mark("dispatch_ack")
                outs.append((chunk, out))
        with self._timed_sync("count"):
            vals = torch.cat([out for _, out in outs]).tolist()  # ONE fetch
        results = [None] * len(payloads)
        i = 0
        for chunk, _ in outs:
            for pos in chunk:
                results[pos] = (vals[i], len(chunk))
                i += 1
        return results

    def _count_group(self, family, sig, members):
        """[B] int64 counts of a batch group, under a held dispatch: the
        members are leaf-container lists of one grouping signature, and
        `count_program_batch` counts them once a part (one launch of K1's
        batched entry for a dense group of two or more, one of K2's for a
        block-sparse one), the parts' counts summed on the first card."""
        outs = []
        for conts in zip(*[self._leaf_parts(m) for m in members]):
            csig = tuple(c.csig for c in conts[0])
            flats = [_containers.flatten(c) for c in conts]
            self._note_count_specs(family, sig, csig, flats[0],
                                   batch=len(flats))
            outs.append(_containers.count_program_batch(sig, csig, flats))
        return self._reduce(outs)

    def _plane_group(self, sig, members):
        """Each member's [S, W] plane of a plane batch group (one
        `plane_program` a member and part), under a held dispatch."""
        per_part = []
        for conts in zip(*[self._leaf_parts(m) for m in members]):
            csig = tuple(c.csig for c in conts[0])
            per_part.append([_containers.plane_program(
                sig, csig, _containers.flatten(c)) for c in conts])
        return [self._join(list(planes), m[0].shape[0])
                for m, planes in zip(members, zip(*per_part))]

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
        batched entry when its leaves are dense, one of K2's when they
        are block-sparse), a plane group one
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
            kname = "count_batched" if kind == "count" else "plane_batched"
            for i in range(0, len(positions), BATCH_BUCKETS[-1]):
                chunk = positions[i:i + BATCH_BUCKETS[-1]]
                members = [items[pos][2] for pos in chunk]
                with self._lock:
                    self.dispatches += 1
                    self.batch_dispatches += 1
                    self.batched_queries += len(chunk)
                bucket = batch_bucket(len(chunk))
                _flightrec.record("batch.dispatch", kernel=kname,
                                  queries=len(chunk), bucket=bucket)
                global_stats.count("batch_dispatch_total", 1, {
                    "kernel": kname, "bucket": str(bucket)})
                # batch-size histogram: occupancy per batched launch
                global_stats.timing("coalesce_batch_size", float(len(chunk)))
                nbytes_in = sum(c.nbytes for m in members for c in m)
                with self._locked_dispatch(kname,
                                           nbytes_in=nbytes_in) as ph:
                    if kind == "count":
                        out = self._count_group(kname, sig, members)
                    else:
                        out = self._plane_group(sig, members)
                    ph.mark("dispatch_ack")
                launched.append((kind, chunk, out))
        return self._copy_to_host(launched)

    def _copy_to_host(self, launched):
        """Enqueue the device->host copy of every launched result: the
        counts into one pinned int64 buffer, each plane's parts into its
        rows of one pinned [n, S_pad, W] buffer (handed back without the
        padding), and one event a card behind them. On the CPU the
        buffers are the results' own copies and there is no event."""
        cuda = self.device.type == "cuda"
        n_counts = sum(len(chunk) for kind, chunk, _ in launched
                       if kind == "count")
        outs = [p for kind, _, out in launched if kind != "count"
                for p in out]
        planes = [self._tensors(p) for p in outs]
        counts_h = torch.empty((n_counts,), dtype=torch.int64,
                               pin_memory=cuda)
        planes_h = None
        if planes:
            n = planes[0][0].shape[0]
            planes_h = torch.empty((len(planes), n * len(planes[0]),
                                    WORDS_PER_ROW),
                                   dtype=torch.int32, pin_memory=cuda)
        i = 0
        for kind, chunk, out in launched:
            if kind == "count":
                counts_h[i:i + len(chunk)].copy_(out, non_blocking=cuda)
                i += len(chunk)
        for j, tensors in enumerate(planes):
            for p, t in enumerate(tensors):
                planes_h[j, p * n:(p + 1) * n].copy_(t, non_blocking=cuda)
        events = []
        if cuda:
            for dev in self._cards:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                events.append(event)
        if planes and len(planes[0]) > 1:
            planes_h = planes_h[:, :outs[0].n_shards]
        return [(kind, chunk) for kind, chunk, _ in launched], counts_h, \
            planes_h, events

    def resolve_query_batch(self, handle):
        """Wait for the ONE copy `launch_query_batch` enqueued and split
        it. Returns {item position: (result, batch size, launch)}: count
        results are exact Python ints, plane results host [S, W] uint32
        arrays (row j = the j-th shard the stacks were gathered over);
        `launch` numbers the batched launch the item rode."""
        launched, counts_h, planes_h, events = handle
        if events and launched:
            # the events stand behind every launch of the handle; their
            # wait is the sync of the family launched last
            kname = "count_batched" if launched[-1][0] == "count" \
                else "plane_batched"
            with self._timed_sync(kname):
                for event in events:
                    event.synchronize()
        with self._lock:
            self.batch_fetches += 1
        counts = counts_h.tolist()
        planes = None if planes_h is None \
            else planes_h.numpy().view(np.uint32)
        results = {}
        i = j = 0
        for seq, (kind, chunk) in enumerate(launched):
            for pos in chunk:
                if kind == "count":
                    results[pos] = (counts[i], len(chunk), seq)
                    i += 1
                else:
                    results[pos] = (planes[j], len(chunk), seq)
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
        with self._locked_dispatch(
                "shift", nbytes_in=sum(c.nbytes for c in conts),
                nbytes_out=conts[0].shape[0] * WORDS_PER_ROW * 4) as ph:
            plane = _containers.plane_program(
                sub_sig, csig, _containers.flatten(conts))
            out = _bitplane.shift(plane, n)
            ph.mark("dispatch_ack")
            return out

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
        with self._locked_dispatch(
                "filter", nbytes_in=sum(c.nbytes for c in stacks),
                nbytes_out=self._padded_len(shards) * WORDS_PER_ROW * 4) \
                as ph:
            out = self._join([_containers.plane_program(sig, csig, flat)
                              for csig, flat in self._part_args(stacks)],
                             len(shards))
            ph.mark("dispatch_ack")
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
            n_in = stack.numel() * 4 + (0 if filt is None
                                        else filt.numel() * 4)
            self._note_spec("row_counts", "row_counts",
                            (len(chunk), stack[0].numel(), filt is not None))
            with self._locked_dispatch("row_counts", nbytes_in=n_in,
                                       nbytes_out=8 * len(chunk)) as ph:
                counts = self._row_counts_launch(stack, flat_filt,
                                                 len(chunk))
                ph.mark("dispatch_ack")
                if not cache and self.device.type == "cuda":
                    # Transient chunks: finish before the next one is
                    # built, so peak device memory stays ~CHUNK_BYTES.
                    del stack
                    self._sync_device()
                    ph.mark("sync")
            pending.append((chunk, counts))
        if pending:
            with self._timed_sync("row_counts"):
                vals = self._fetch(
                    torch.cat([c for _, c in pending])).tolist()
            k = 0
            for chunk, _ in pending:
                for row_id in chunk:
                    out[row_id] = vals[k]
                    k += 1
        return out

    def _row_counts_launch(self, stack, flat_filt, n_rows):
        """K3 over an [R, S, W] row chunk and a flat filter once a part,
        the [R] int64 counts summed on the first card BEFORE the caller's
        top-k (trap 4)."""
        return self._reduce([
            _row_counts_kernel(s.reshape(n_rows, -1), f)
            for s, f in zip(self._tensors(stack), self._tensors(flat_filt))])

    def _sync_device(self):
        for dev in self._cards:
            torch.cuda.current_stream(dev).synchronize()

    def pairwise_counts(self, idx, a_field, a_rows, b_field, b_rows, filt,
                        shards, view_name=VIEW_STANDARD, tile=None):
        """{(a_row, b_row): count > 0} of the two-field GroupBy cross
        product: counts[i, j] = popcount(a_rows[i] & b_rows[j] & filt)
        summed over `shards`. Both fields' row stacks come from the rows
        pool in row_chunk_size tiles ([R, S, W], patched in place like
        any chunk); each (A-tile, B-tile) pair's count matrix is ONE
        launch of K4 and ONE host fetch. Replaces the TPU package's
        `pairwise_counts_hi_lo` + host `pairwise_counts`
        (pilosa_tpu/ops/bitplane.py:238-285). `tile` overrides the static
        CHUNK_BYTES-derived tile (the adaptive tile decision); with the
        adaptive engine on, per-launch walls feed its per-tile EWMA.
        Returns None when a field/view vanished mid-query (caller falls
        back)."""
        shards = tuple(shards)
        out = {}
        if not a_rows or not b_rows:
            return out
        if tile is None or tile < 1:
            tile = self.row_chunk_size(shards)
        observe = _adaptive.enabled()
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
                n_in = (a_stack.numel() + b_stack.numel()
                        + (0 if filt is None else filt.numel())) * 4
                self._note_spec(
                    "pairwise", "pairwise_counts",
                    (len(a_chunk), len(b_chunk),
                     a_stack[0].numel(), filt is not None))
                t_disp = time.perf_counter() if observe else 0.0
                with self._locked_dispatch(
                        "pairwise", nbytes_in=n_in,
                        nbytes_out=8 * len(a_chunk) * len(b_chunk)) as ph:
                    counts = self._pairwise_launch(a_stack, b_stack, filt)
                    ph.mark("dispatch_ack")
                if observe:
                    # calibrate the per-launch wall at the NOMINAL tile —
                    # ragged last tiles blend in, which is fine: the
                    # model prices whole shapes, not single tiles
                    _adaptive.observe_pairwise(
                        tile, time.perf_counter() - t_disp)
                # ONE host fetch for the whole [tile, tile] matrix (it
                # also bounds transient tiles' device memory), shared with
                # concurrent queries through the group commit
                with self._timed_sync("pairwise"):
                    totals = self._fetch(counts)
                with self._lock:
                    self.pairwise_syncs += 1
                for x, y in zip(*np.nonzero(totals)):
                    out[(a_chunk[x], b_chunk[y])] = int(totals[x, y])
        return out

    def _pairwise_launch(self, a_stack, b_stack, filt):
        """K4 over two [R, S, W] row tiles and a filter once a part, the
        [R1, R2] int64 cells summed on the first card before the
        caller's limit and offset."""
        return self._reduce([
            _pairwise_kernel(a, b, f)
            for a, b, f in zip(self._tensors(a_stack), self._tensors(b_stack),
                               self._tensors(filt))])

    def _bsi_parts(self, idx, field, filter_call, shards):
        """[(planes, sign, exists, filt) a part] for Sum/Min/Max over
        `shards`, or None to fall back (too few shards, an uncoverable
        filter, or the field vanished)."""
        if len(shards) < MIN_SHARDS:
            return None
        covered, filt = self.filter_stack(idx, filter_call, shards)
        if not covered:
            return None
        out = []
        for part, part_shards, f in zip(self._caches(), self.split(shards),
                                        self._tensors(filt)):
            data = part.bsi_stack(idx, field.name, part_shards)
            if data is None:
                return None
            out.append((*data, f))
        return out

    @staticmethod
    def _bsi_bytes(parts):
        return sum((planes.numel() + sign.numel() + exists.numel()
                    + (0 if filt is None else filt.numel())) * 4
                   for planes, sign, exists, filt in parts)

    def try_sum(self, idx, field, filter_call, shards):
        """(signed magnitude total, count) for Sum over the stacked BSI
        planes, or None to fall back: K3 over the [D, S·W] plane view
        with the positive and with the negative consider mask, and over
        the consider mask itself, then ONE host fetch. The caller adds
        base*count (field.go:1583). Python ints take Σ (pos[i] − neg[i])
        << i, which D = 64 would overflow in int64. A node of several
        parts launches them once a part and sums the [2D + 1] counts on
        its first card."""
        parts = self._bsi_parts(idx, field, filter_call, tuple(shards))
        if parts is None:
            return None
        depth = parts[0][0].shape[0]
        with self._lock:
            self.dispatches += 1
        # bsi_plane_counts: K3 over the planes with the positive and with
        # the negative consider mask, then over the consider mask alone
        for _planes, sign, _exists, _filt in parts:
            self._note_spec("sum", "row_counts", (depth, sign.numel(), True))
            self._note_spec("sum", "row_counts", (1, sign.numel(), False))
        with self._locked_dispatch("sum", nbytes_in=self._bsi_bytes(parts),
                                   nbytes_out=8 * (2 * depth + 1)) as ph:
            sums = []
            for data in parts:
                pos, neg, count = bsi_plane_counts(*data)
                sums.append(torch.cat([pos, neg, count.reshape(1)]))
            total = self._reduce(sums)
            ph.mark("dispatch_ack")
        with self._timed_sync("sum"):
            vals = self._fetch(total).tolist()
        total = 0
        for i in range(depth):
            total += (vals[i] - vals[depth + i]) << i
        return total, vals[-1]

    def try_minmax(self, idx, field, filter_call, shards, is_max):
        """(signed magnitude, count) of the Min/Max value over the stacked
        BSI planes, or None to fall back; (None, 0) when no column
        qualifies. The caller adds base (reference: fragment.go:1110-1227).
        One `minmax_walk` a part under the dispatch lock, one fetch of
        the parts' rows, then the collective plane's combine
        (`cluster.spmd.combine_minmax`: -0 below +0, counts summed at the
        extreme, empty parts never win)."""
        from ..cluster.spmd import combine_minmax

        parts = self._bsi_parts(idx, field, filter_call, tuple(shards))
        if parts is None:
            return None
        with self._lock:
            self.dispatches += 1
        for _planes, sign, _exists, _filt in parts:
            self._note_spec("minmax", "row_counts", (1, sign.numel(), False))
        with self._locked_dispatch("minmax",
                                   nbytes_in=self._bsi_bytes(parts)) as ph:
            walks = [minmax_walk(*data, is_max) for data in parts]
            walk = walks[0][None] if len(walks) == 1 else torch.stack(
                [w.to(self.device, non_blocking=True) for w in walks])
            ph.mark("dispatch_ack")
        with self._timed_sync("minmax"):
            rows = self._fetch(walk).tolist()
        empty, negative, mag, count = combine_minmax(
            [minmax_decode(r) for r in rows], is_max)
        if empty:
            return None, 0
        return (-mag if negative else mag), count

    # -- declared kernel costs (GET /debug/kernels) ---------------------------

    def _note_spec(self, family, kernel, args):
        """Note one launched kernel shape of a dispatch family: `args`
        are the wrapper's declared-cost arguments (ops/*: `*_cost`). One
        dict probe per launch; the cost itself is computed on the first
        GET /debug/kernels, never on the serving path."""
        key = (family, kernel, args)
        if key not in self._fn_specs:
            self._fn_specs[key] = args

    def _note_count_specs(self, family, sig, csig, flat, batch=1):
        """Note the kernels a count program launches for one tree over
        these containers (`containers.count_kernels`: K1, its batched
        entry, K2's two entries, or none for the run-length sums)."""
        shapes = tuple(tuple(a.shape) for a in flat)
        seen = (family, sig, csig, shapes, batch)
        if seen in self._count_spec_keys:
            return
        self._count_spec_keys.add(seen)
        for kernel, args in _containers.count_kernels(sig, csig, shapes,
                                                      batch):
            self._note_spec(family, kernel, args)

    def _note_fused_specs(self, plans, flats):
        """Note the kernels one fused dispatch launches
        (`containers.count_kernels_multi`), once per plan and shapes."""
        shapes = tuple(tuple(tuple(a.shape) for a in flat) for flat in flats)
        seen = ("fused", plans, shapes)
        if seen in self._count_spec_keys:
            return
        self._count_spec_keys.add(seen)
        for kernel, args in _containers.count_kernels_multi(plans, shapes):
            self._note_spec("fused", kernel, args)

    def kernel_profile(self):
        """Per-family dispatch counters snapshot ({family: {count,
        seconds, bytes_in, bytes_out}}) — the cost model's "measured"
        source and the analyze path's before/after delta basis."""
        return self.kernel_walls()

    def kernels_snapshot(self, include_costs=True):
        """Per-kernel-family attribution (counts, wall seconds, bytes
        in/out from _locked_dispatch) plus, per launched kernel shape,
        the wrapper's declared cost: bytes accessed (each input read
        once, the output written once), K4's POPC count, and on a CUDA
        device the bound in seconds (`optimal_seconds`) — the port's
        stand-in for the TPU package's XLA cost_analysis."""
        snap = {"kernels": self.kernel_walls()}
        if include_costs:
            snap["compiled"] = self._kernel_cost_list()
        return snap

    def _kernel_cost_list(self):
        from ..ops import declared_cost

        # launched shapes only: the fused programs kept beside them are
        # not cost arguments
        specs = [(k, a) for k, a in list(self._fn_specs.items())
                 if isinstance(a, tuple)]
        out = []
        for key, args in specs:
            cost = self._kernel_costs.get(key)
            if cost is None:
                cost = declared_cost(key[1], args, self.device)
                with self._lock:
                    self._kernel_costs[key] = cost
            out.append({"family": key[0], "kernel": key[1],
                        "key": repr(key), "cost": cost})
        out.sort(key=lambda e: e["key"])
        return out

    # -- plan-mode introspection (exec/plan.py) ------------------------------
    #
    # EXPLAIN mirrors the strategy gates WITHOUT executing: everything
    # below is host-only (schema lookups, fragment generation walks, pool
    # membership under the lock) and side-effect free — no LRU bumps, no
    # hit/miss counters, no stack builds, no launches. The acceptance
    # contract for ?explain=true is a launch-counter delta of zero.

    def _probe(self, key, idx, field_name, view_name):
        """Presence + freshness of one pool entry with NO side effects
        (see _probe_entry)."""
        return self._probe_entry(key, idx, field_name, view_name)[0]

    def _probe_entry(self, key, idx, field_name, view_name):
        """(resident, resident_bytes, repr) of one pool entry with NO
        side effects. Mirrors _cache_get_fast/_cache_get validation
        (view stamp first, per-shard generation walk second) but never
        touches LRU order, last-hit stamps, or the hit/miss counters —
        a plan must not distort the telemetry it is trying to explain.
        bytes/repr are the RESIDENT entry's (compressed container bytes
        for compressed leaf stacks); (0, "dense") when absent."""
        field = idx.field(field_name)
        view = field.view(view_name) if field is not None else None
        if view is None:
            return False, 0, "dense"
        pool = self._pools[self._pool_of(key)]
        with self._lock:
            hit = pool.get(key)
            if hit is None:
                return False, 0, "dense"
            if hit[3] == (view.uid, view.mutations):
                return True, hit[2], _containers.kind_of(hit[1])
        # stamp drifted: fall back to the exact generation walk (done
        # outside the pool lock — it touches fragment containers)
        gens = self._fragment_gens(view, key[-1])
        with self._lock:
            hit = pool.get(key)
            if hit is not None and hit[0] == gens:
                return True, hit[2], _containers.kind_of(hit[1])
            return False, 0, "dense"

    def rows_chunk_resident(self, idx, field_name, row_chunk, shards,
                            view_name=VIEW_STANDARD):
        """Would rows_stack() serve this chunk from the rows pool?"""
        key = ("rows", idx.name, field_name, view_name, tuple(row_chunk),
               tuple(shards))
        return self._probe(key, idx, field_name, view_name)

    def bsi_stack_resident(self, idx, field_name, shards):
        """Would bsi_stack() serve this field's plane stack from HBM?"""
        field = idx.field(field_name)
        if field is None:
            return False
        key = ("bsi", idx.name, field_name, field.options.bit_depth,
               tuple(shards))
        return self._probe(key, idx, field_name, field.bsi_view_name())

    def residency_probe(self, idx, call, shards):
        """Host-only coverage + device residency of a bitmap call tree:

        {covered, leaves, resident, resident_bytes, missing_bytes,
         extra_kernels, repr_counts, compressed_bytes}

        covered mirrors _gather's verdict (same signature walk); per
        interned leaf the probe reports whether its device stack(s) are
        already resident and how many bytes a cold build would upload.
        extra_kernels counts launches _gather itself would make on top
        of the consumer's own kernel (bsi_condition masks, time_union
        folds, shift planes) so estimates don't undercount."""
        shards = tuple(shards)
        out = {"covered": False, "leaves": 0, "resident": 0,
               "resident_bytes": 0, "missing_bytes": 0,
               "extra_kernels": {}, "repr_counts": {},
               "compressed_bytes": 0}
        leaves = {}
        sig = self.signature(idx, call, leaves)
        if sig is None or not leaves:
            return out
        out["covered"] = True
        out["leaves"] = len(leaves)
        plane = self._padded_len(shards) * WORDS_PER_ROW * 4
        for key in leaves:
            # per-leaf representation + compressed-bytes estimate for
            # the cost model: actual container bytes when resident, the
            # fragment ledger's last-build record when not (the chooser
            # is deterministic in the data, so the last build predicts
            # the next), dense otherwise. resident/missing_bytes keep
            # their dense meaning — they price the HOST gather a cold
            # build pays, which is dense either way.
            resident, nbytes, ckind, cbytes = self._probe_leaf(
                idx, key, shards, plane, out)
            rc = out["repr_counts"]
            rc[ckind] = rc.get(ckind, 0) + 1
            out["compressed_bytes"] += cbytes if cbytes is not None \
                else nbytes
            if resident:
                out["resident"] += 1
                out["resident_bytes"] += nbytes
            else:
                out["missing_bytes"] += nbytes
        return out

    def _probe_leaf(self, idx, key, shards, plane, out):
        """(resident, cold_bytes, repr, compressed bytes or None) of one
        interned leaf key."""
        if key[0] == "bsicond":
            return self._probe_bsicond(idx, key, shards, plane, out) \
                + ("dense", None)
        if key[0] == "timerow":
            return self._probe_timerow(idx, key, shards, plane, out) \
                + ("dense", None)
        if key[0] == "shift":
            return self._probe_shift(idx, key, shards, plane, out) \
                + ("dense", plane)
        _, field_name, row_id = key
        leaf_key = ("leaf", idx.name, field_name, row_id, shards)
        resident, ebytes, ekind = self._probe_entry(
            leaf_key, idx, field_name, VIEW_STANDARD)
        if resident:
            return True, plane, ekind, ebytes
        est = _containers.fragment_estimate(
            idx.name, field_name, VIEW_STANDARD, row_id)
        if est is not None:
            return False, plane, est["repr"], est["bytes"]
        return False, plane, "dense", None

    def _probe_bsicond(self, idx, key, shards, plane, out):
        """(resident, cold_bytes) of one condition leaf; counts the
        bsi_condition launch the gather would add."""
        _, field_name, op, vals = key
        field = idx.field(field_name)
        if field is None:
            return False, 0
        try:
            plan = bsi_condition_plan(
                field.options, condition_from_key(op, vals))
        except BsiConditionError:
            return False, 0
        if plan[0] == "empty":
            return True, 0  # constant zeros, nothing uploaded
        if plan[0] == "notnull":
            return self.rows_chunk_resident(
                idx, field_name, (BSI_EXISTS_BIT,), shards,
                view_name=field.bsi_view_name()), plane
        ek = out["extra_kernels"]
        ek["bsi_condition"] = ek.get("bsi_condition", 0) + 1
        depth = field.options.bit_depth
        return (self.bsi_stack_resident(idx, field_name, shards),
                (depth + 2) * plane)

    def _probe_timerow(self, idx, key, shards, plane, out):
        """(resident, cold_bytes) of one time-range leaf: one cached
        single-row chunk per locally-present quantum view, plus a
        time_union launch when more than one contributes."""
        _, field_name, row_id, views = key
        field = idx.field(field_name)
        if field is None:
            return False, 0
        present = [v for v in views if field.view(v) is not None]
        if len(present) > 1:
            ek = out["extra_kernels"]
            ek["time_union"] = ek.get("time_union", 0) + 1
        resident = all(
            self.rows_chunk_resident(idx, field_name, (row_id,), shards,
                                     view_name=v)
            for v in present)
        return resident, len(present) * plane

    def _probe_shift(self, idx, key, shards, plane, out):
        """(resident, cold_bytes) of one Shift leaf (the port's own leaf
        kind): its child leaves, probed like any leaf, plus the shift
        launch the gather would add."""
        ek = out["extra_kernels"]
        ek["shift"] = ek.get("shift", 0) + 1
        resident, nbytes = True, 0
        for sub in key[3]:
            r, b, _, _ = self._probe_leaf(idx, sub, shards, plane, out)
            resident = resident and r
            nbytes += b
        return resident, nbytes

