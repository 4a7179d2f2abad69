"""API facade (reference: api.go): between the HTTP transport and the
holder/executor. Single node; wire shapes follow the TPU package's.
Index and field DDL (create, delete, apply a schema), bit, value and
roaring imports (with row and column keys), CSV export, cache
recalculation and the column attribute sets of a query's Row results.

With a coalesce window (`API(coalesce_window=...)`, `server
--coalesce-window`), concurrent batchable queries fuse into batched
launches through the QueryCoalescer; window 0, the default, builds none
and every query takes the per-query path.

Every query runs under an `api.Query` span and a watchdog op; with
`?profile=true` or a slow-query threshold (`API(long_query_time=...)`,
`server --long-query-time`) it also runs under a QueryProfile, and a
query slower than the threshold logs one `SLOW QUERY` line (the TPU
package's format, with the query's workload fingerprint) and a
`query.slow` flight-recorder event. While the device-link prober says
DOWN (utils/devhealth.py) a query is refused at once with 503 and
Retry-After; a request deadline (`X-Request-Deadline`) that expires
before or during the query answers 504, and a storm of those triggers
an incident bundle (utils/incident.py). Each finished query ticks the
SLO engine (utils/workload.py).

With a write-ahead oplog (`API(oplog=...)`, on by default in `server`),
every bit, value and roaring import is appended to the log before it is
applied and acknowledged, and `replay_oplog()` re-applies at boot what a
crash left unapplied. Records are the TPU package's: a log written by
either package replays in the other.

With an ingest merge interval (`API(ingest_interval=...)`, `server
--ingest-merge-interval`), imports also buffer their deltas in a
streaming ingest engine (exec/ingest.py) that folds them into the
resident stacks once an interval, off the read path; a buffer past its
high-water mark refuses an import with 503 and Retry-After before the
oplog append. Interval 0, the default, builds no engine.

`?explain=true|analyze` plans a query (exec/plan.py); `?explain=analyze`
and `--long-query-time` profile it, and its SLOW QUERY line carries the
plan summary and how many of its calls rode one fused dispatch
(`fused=`, exec/fusion.py).

With `API(admission="on")` (`server --admission on`) every query passes
an admission controller (server/admission.py) before it can launch: it
is classified (`X-Query-Class` or its PQL shape), priced through the
planner's cost model (no launch), and admitted against its class's
token bucket, queued in a bounded FIFO, or shed with 503, Retry-After
and `X-Pilosa-Shed: admission`; a deadline that lapses in the queue
answers 504. The controller's degradation ladder holds the ingest
engine's interval merges off from SHED_BATCH up and marks responses
stale from STALE_OK up.

With a cluster (`API(cluster=...)`, `server --cluster-hosts` or
`--join`), queries run through the ClusterExecutor (cluster/executor.py:
each node's own shards on its own card, the rest over HTTP to their
owners, merged here) and skip the coalescer; DDL is broadcast to every
peer; every import routes each shard's slice to all of its replica
owners, tolerating a lagging replica while one owner took the write
(anti-entropy repairs the rest); writes that arrive while the cluster
is RESIZING queue and replay once it is NORMAL again. The node-to-node
internals behind anti-entropy, key replication, resize and the
`/status` observability roll-up live here too."""

import array
import base64
import contextlib
import csv
import io
import random
import threading
import time

import numpy as np

from ..cluster.broadcast import MessageType, Serializer
from ..core import FieldOptions
from ..core.field import (
    FIELD_TYPE_BOOL,
    FIELD_TYPE_INT,
    FIELD_TYPE_MUTEX,
    FIELD_TYPE_SET,
    FIELD_TYPE_TIME,
)
from ..core.index import IndexOptions
from ..exec import ExecOptions, Executor
from ..exec.stacked import DeadlineExceededError
from ..pql import parse
from ..shardwidth import SHARD_WIDTH
from ..utils import devhealth, faultpoints, flightrec, tracing
from ..utils import incident as incident_mod
from ..utils import profile as profile_mod
from ..utils import workload as workload_mod
from ..utils.stats import global_stats
from .. import __version__


class ApiError(Exception):
    status = 400
    #: optional extra response headers ({name: value})
    headers = None


class NotFoundError(ApiError):
    status = 404


class ConflictError(ApiError):
    status = 409


class GatewayTimeoutError(ApiError):
    """504: the request's deadline (X-Request-Deadline) expired before
    or during execution; nothing past the expiry point was dispatched."""
    status = 504


class ServiceUnavailableError(ApiError):
    """503: the node cannot serve right now. Carries Retry-After so
    clients back off."""
    status = 503

    def __init__(self, message, retry_after=None):
        super().__init__(message)
        if retry_after is not None:
            self.headers = {
                "Retry-After": str(max(1, int(round(retry_after))))}


def shed_reject(site, message, retry_after, qclass=None):
    """THE 503 rejection path of a load-shedding site: one shared
    `rejections_total{site,class}` counter, one jitter rule (x1.0-1.25,
    so synchronized client retries decorrelate) and the `X-Pilosa-Shed`
    header naming the site, which tells a shedding node from a dead
    one."""
    global_stats.count("rejections_total", 1,
                       {"site": site, "class": qclass or "none"})
    ra = max(1.0, float(retry_after)) * random.uniform(1.0, 1.25)
    err = ServiceUnavailableError(message, retry_after=ra)
    err.headers["X-Pilosa-Shed"] = site
    raise err


#: oplog binary-list type codes -> array.array typecodes ('I' is only
#: u4 where the platform says so; the log is node-local, so the machine
#: that wrote a record is the machine that replays it)
_OPLOG_DT = {"u4": "I", "u8": "Q", "i8": "q"}
_U4_OK = array.array("I").itemsize == 4


def _oplog_pack_ints(v):
    """base64-of-packed-ints record field for an id/value list, or None
    when ``v`` isn't an int list (keys, mixed). Tries u4 first — the
    common case for row ids and per-shard column ids — then i8;
    ndarrays pack through numpy without a Python-object round trip."""
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "u":
            b = np.ascontiguousarray(v, dtype="<u8").tobytes()
            return {"__b": base64.b64encode(b).decode(), "dt": "u8"}
        if v.dtype.kind == "i":
            b = np.ascontiguousarray(v, dtype="<i8").tobytes()
            return {"__b": base64.b64encode(b).decode(), "dt": "i8"}
        return None
    if _U4_OK:
        try:
            b = array.array("I", v).tobytes()
            return {"__b": base64.b64encode(b).decode(), "dt": "u4"}
        except (OverflowError, TypeError, ValueError):
            pass
    try:
        b = array.array("q", v).tobytes()
        return {"__b": base64.b64encode(b).decode(), "dt": "i8"}
    except (OverflowError, TypeError, ValueError):
        return None


def field_options_from_json(opts):
    """FieldOptions from the reference's JSON field-options wire shape
    (reference: http/handler.go:870 + FieldOptions.MarshalJSON
    field.go:1471)."""
    opts = opts or {}
    typ = opts.get("type", FIELD_TYPE_SET)
    if typ == FIELD_TYPE_INT:
        return FieldOptions.int_field(
            min=int(opts.get("min", -(1 << 31))),
            max=int(opts.get("max", (1 << 31) - 1)))
    if typ == FIELD_TYPE_TIME:
        return FieldOptions.time_field(
            opts.get("timeQuantum", ""),
            no_standard_view=bool(opts.get("noStandardView", False)),
            keys=bool(opts.get("keys", False)))
    if typ == FIELD_TYPE_MUTEX:
        return FieldOptions.mutex_field(
            cache_type=opts.get("cacheType", "ranked"),
            cache_size=int(opts.get("cacheSize", 50000)),
            keys=bool(opts.get("keys", False)))
    if typ == FIELD_TYPE_BOOL:
        return FieldOptions.bool_field()
    if typ != FIELD_TYPE_SET:
        raise ApiError(f"invalid field type: {typ}")
    return FieldOptions(
        cache_type=opts.get("cacheType", "ranked"),
        cache_size=int(opts.get("cacheSize", 50000)),
        keys=bool(opts.get("keys", False)))


def field_options_to_json(o):
    out = {"type": o.type, "keys": o.keys}
    if o.type == FIELD_TYPE_INT:
        out.update({"min": o.min, "max": o.max, "base": o.base,
                    "bitDepth": o.bit_depth})
    elif o.type == FIELD_TYPE_TIME:
        out.update({"timeQuantum": o.time_quantum,
                    "noStandardView": o.no_standard_view})
    else:
        out.update({"cacheType": o.cache_type, "cacheSize": o.cache_size})
    return out


def result_to_json(result):
    """One executor result in the reference's QueryResponse JSON shape
    (reference: QueryResponse.MarshalJSON handler.go:61)."""
    from ..core.row import Row
    from ..exec.result import GroupCount, Pair, RowIdentifiers, ValCount

    if isinstance(result, Row):
        out = {"attrs": result.attrs or {},
               "columns": [int(c) for c in result.columns()]}
        if result.keys is not None:
            out["keys"] = result.keys
        return out
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, (ValCount, Pair, RowIdentifiers, GroupCount)):
        return result.to_json()
    if result is None or isinstance(result, (bool, int, float, str, dict)):
        return result
    raise ApiError(f"unencodable result type {type(result)!r}")


class QueryCoalescer:
    """Folds concurrent batchable queries into batched launches
    (exec/stacked.launch_query_batch), so the per-query launch and fetch
    are paid once per batch instead of once per query.

    Lifecycle: HTTP handler threads submit() parsed single-call queries
    and block on a per-query event; one lazily started daemon drain
    thread owns the pipeline. On an idle→busy transition it holds the
    batch open for `window` seconds so batchmates arriving within the
    window fuse; while the pipeline is busy the launch+resolve of the
    previous batch IS the accumulation window (no extra sleep). The loop
    is double-buffered: batch N+1 is launched (Executor.launch_batch)
    BEFORE batch N's results are waited for (resolve_batch), so batch
    N's copy to the host overlaps batch N+1's launch.

    Overload: a queue past `max_queue` rejects with 503 + Retry-After —
    never an unbounded wait."""

    def __init__(self, api, window, max_queue=256):
        self.api = api
        self.window = float(window)
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._queue = []  # member dicts, FIFO
        self._thread = None
        self._closed = False
        # GET /debug/batching
        self.batches = 0            # batched launches issued
        self.coalesced = 0          # queries that rode one
        self.rejected = 0           # overload 503s
        self.max_occupancy = 0      # largest single batch seen
        self.batch_hist = {}        # occupancy -> count

    def submit(self, index_name, query):
        """Enqueue one parsed batchable query and wait for its slot of the
        batched result. Returns (results, batch_size); re-raises the
        member's own error (a batchmate's failure is not ours)."""
        m = {"index": index_name, "query": query, "event": threading.Event(),
             "t0": time.monotonic(), "results": None, "error": None,
             "batch": 0}
        with self._cond:
            if self._closed:
                raise ServiceUnavailableError(
                    "query coalescer shut down", retry_after=1)
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                global_stats.count("batch_rejected_total", 1)
                shed_reject(
                    "coalesce",
                    f"coalesce queue full ({self.max_queue}); shed load "
                    "or raise --coalesce-max-queue", 1,
                    qclass="interactive")
            self._queue.append(m)
            if self._thread is None:
                self._start_thread_locked()
            self._cond.notify()
        # Bounded waits + a liveness check: the drain loop delivers every
        # member's event even on internal errors (its whole body is
        # exception-guarded), but if the thread is ever lost anyway, fail
        # this handler fast instead of blocking it forever, and leave the
        # coalescer usable for the next submit.
        while not m["event"].wait(0.5):
            with self._cond:
                t = self._thread
                if t is not None and t.is_alive():
                    continue
                if m in self._queue:
                    self._queue.remove(m)
                self._thread = None
                if self._queue and not self._closed:
                    self._start_thread_locked()
            if not m["event"].is_set():
                m["error"] = ServiceUnavailableError(
                    "coalescer drain thread died; retry", retry_after=1)
            break
        if m["error"] is not None:
            raise m["error"]
        return m["results"], m["batch"]

    def _start_thread_locked(self):
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="query-coalescer")
        self._thread.start()

    def close(self):
        """Shut down the pipeline: wake the drain thread, deliver
        in-flight batches, fail queued members with 503 so blocked
        handler threads return instead of hanging past server shutdown,
        and refuse new submits. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            t = self._thread
            self._cond.notify_all()
        if t is not None and t.is_alive():
            t.join(timeout=5)
        # no drain thread (never started, or already dead): fail the
        # leftovers here; otherwise the loop's shutdown path did it
        self._fail(self._pop_members(), ServiceUnavailableError(
            "query coalescer shut down", retry_after=1))

    @staticmethod
    def _fail(members, exc):
        for m in members:
            if not m["event"].is_set():
                m["error"] = exc
                m["event"].set()

    def stats(self):
        with self._cond:
            return {
                "enabled": True,
                "window_seconds": self.window,
                "max_queue": self.max_queue,
                "queue_depth": len(self._queue),
                "batches": self.batches,
                "coalesced_queries": self.coalesced,
                "rejected": self.rejected,
                "max_occupancy": self.max_occupancy,
                "occupancy_hist": dict(sorted(self.batch_hist.items())),
            }

    def _pop_members(self):
        """Drain everything queued right now (caller holds no lock)."""
        with self._cond:
            members, self._queue = self._queue, []
            return members

    def _drain_loop(self):
        ex = self.api.batch_executor()
        pending = []  # [(handle, state, members)] launched, unresolved
        while True:
            with self._cond:
                idle = not self._queue and not pending and not self._closed
            if idle:
                # idle dispatch-lock window: bounded proactive admission
                # of hot_but_not_resident fragments (exec/adaptive) —
                # exception-guarded and a no-op with the engine off, so
                # serving can never wedge on an admission failure
                try:
                    ex.maybe_proactive_admit()
                except Exception:  # noqa: BLE001 — best effort
                    pass
            with self._cond:
                while not self._queue and not pending \
                        and not self._closed:
                    self._cond.wait()
                if self._closed:
                    break
            # Everything below is exception-guarded: an error ANYWHERE in
            # the iteration (grouping, counters — not just the
            # launch/resolve calls, which guard themselves) is delivered
            # to every affected member and the loop keeps serving. An
            # unguarded escape would kill the singleton thread and wedge
            # every future submit.
            members = []
            launched = []
            try:
                was_idle = not pending
                members = self._pop_members()
                if members and was_idle and self.window > 0:
                    # idle→busy: hold the window open so concurrent
                    # arrivals fuse into this batch; close() cuts the
                    # wait short
                    with self._cond:
                        self._cond.wait_for(lambda: self._closed,
                                            timeout=self.window)
                    members += self._pop_members()
                for index_name, group in self._group(members).items():
                    now = time.monotonic()
                    for m in group:
                        global_stats.timing(
                            "coalesce_wait_seconds", now - m["t0"])
                    try:
                        handle, state = ex.launch_batch(
                            index_name, [m["query"] for m in group])
                    except Exception as exc:  # noqa: BLE001 — deliver
                        self._fail(group, exc)
                        continue
                    with self._cond:
                        self.batches += 1
                        self.coalesced += len(group)
                        n = len(group)
                        self.max_occupancy = max(self.max_occupancy, n)
                        self.batch_hist[n] = self.batch_hist.get(n, 0) + 1
                    flightrec.record("batch.coalesce", index=index_name,
                                     queries=len(group))
                    launched.append((handle, state, group))
                # double buffer: batch N+1 is in flight; NOW resolve N
                for handle, state, group in pending:
                    self._resolve(ex, handle, state, group)
                pending = launched
            except Exception as exc:  # noqa: BLE001 — deliver, don't die
                self._fail(members, exc)
                for _, _, group in pending + launched:
                    self._fail(group, exc)
                pending = []
        # closed: deliver in-flight batches (already launched — the
        # results are real), then fail whatever is still queued
        for handle, state, group in pending:
            self._resolve(ex, handle, state, group)
        self._fail(self._pop_members(), ServiceUnavailableError(
            "query coalescer shut down", retry_after=1))

    @staticmethod
    def _group(members):
        by_index = {}
        for m in members:
            by_index.setdefault(m["index"], []).append(m)
        return by_index

    @staticmethod
    def _resolve(ex, handle, state, group):
        try:
            outs = ex.resolve_batch(handle, state)
        except Exception as exc:  # noqa: BLE001 — deliver, don't die
            for m in group:
                m["error"] = exc
                m["event"].set()
            return
        for m, (results, error, bsize) in zip(group, outs):
            m["results"] = results
            m["error"] = error
            m["batch"] = bsize
            m["event"].set()


class API:
    """Holds the holder and the port's Executor on `device` (a
    ClusterExecutor around it when a cluster is given), the query
    coalescer when `coalesce_window` > 0 on a single node (or on a
    cluster node whose collective plane boots serving the mesh), and the
    write-ahead oplog when one is given."""

    def __init__(self, holder, device=None, coalesce_window=0.0,
                 coalesce_max_queue=256, max_writes_per_request=0,
                 oplog=None, logger=None, long_query_time=None,
                 ingest_interval=0.0, ingest_max_rows=None,
                 ingest_max_bytes=None, admission="off",
                 admission_capacity=None, admission_queue_depth=None,
                 admission_queue_timeout=None, cluster=None,
                 client_factory=None, spmd=None):
        from ..utils.logger import StandardLogger

        self.holder = holder
        self.cluster = cluster
        # the collective data plane (cluster/spmd.py): when set, coverable
        # cross-node merges ride the process group instead of HTTP
        self.spmd = spmd
        self.logger = logger if logger is not None else StandardLogger()
        # last per-index shard set pushed to peers (gossiped shard map)
        self._pushed_shards = {}
        if client_factory is None:
            from .client import Client as client_factory  # noqa: N813
        self.client_factory = client_factory
        if cluster is not None:
            from ..cluster import ClusterExecutor, ResizeManager

            self.executor = ClusterExecutor(
                holder, cluster, client_factory, device=device,
                logger=self.logger,
                max_writes_per_request=max_writes_per_request, spmd=spmd)
            if spmd is not None:
                # the plane's condition leaves and launches go through
                # the serving executor (its device, dispatch lock and
                # accounting), not a second evaluator
                spmd._local_exec = self.executor.local
            self.resize = ResizeManager(holder, cluster, self.client_factory)
            # Writes arriving while RESIZING are queued and replayed once
            # the cluster returns to NORMAL (see import_bits); the resize
            # manager pings us at every RESIZING->NORMAL transition,
            # including on followers and aborts.
            self.resize.on_state_normal = self._drain_resize_writes
        else:
            self.executor = Executor(
                holder, device=device,
                max_writes_per_request=max_writes_per_request)
            self.resize = None
        # Durable write-ahead oplog (storage/oplog.py): when set, every
        # import appends its record BEFORE any ack path can return, and
        # replay_oplog() re-applies unapplied records at boot. None (the
        # default, and what in-process test harnesses use) keeps the
        # pre-oplog behavior exactly.
        self.oplog = oplog
        # replay_lsn: the original record's LSN while a boot replay is
        # re-running an import through the normal path (no re-append —
        # the record already stands; apply-marking reuses its LSN)
        self._oplog_tls = threading.local()
        self._oplog_ckpt_lock = threading.Lock()
        if oplog is not None:
            oplog.on_rotate = self._oplog_rotate_checkpoint
        # slow-query threshold in seconds (reference: long-query-time);
        # None disables the log and the profiling it implies
        self.long_query_time = long_query_time
        # window 0 — the default — builds no coalescer: every query takes
        # the per-query path. A cluster node coalesces only when its
        # collective plane serves the mesh (serve mode != off at boot):
        # eligible batches then run as ONE collective step
        # (SpmdBatchRunner); on the HTTP fan-out the legs are where
        # launches happen, so coordinator coalescing would only add
        # latency.
        self.coalesce_window = float(coalesce_window or 0.0)
        self.coalesce_max_queue = int(coalesce_max_queue)
        self._coalescer = None
        if self.coalesce_window > 0 and (
                cluster is None
                or (spmd is not None
                    and getattr(spmd, "serve_mode", "off") != "off")):
            self._coalescer = QueryCoalescer(
                self, self.coalesce_window, self.coalesce_max_queue)
        # Streaming ingest engine (exec/ingest.py): interval 0 — the
        # default — never constructs one, so the import path is a single
        # `is None` check and every read repairs its stacks as before.
        self.ingest = None
        if float(ingest_interval or 0.0) > 0:
            from ..exec.ingest import IngestEngine

            self.ingest = IngestEngine(
                self, float(ingest_interval),
                max_rows=ingest_max_rows, max_bytes=ingest_max_bytes)
        # Admission control + degradation ladder (server/admission.py):
        # "off" — the default — never constructs a controller, so the
        # query path's only residue is one `is None` check.
        if admission not in ("off", "on"):
            raise ValueError(
                f"admission must be on|off, got {admission!r}")
        self._admission = None
        if admission == "on":
            from . import admission as admission_mod

            self._admission = admission_mod.AdmissionController(
                capacity_ms_per_s=admission_capacity,
                queue_depth=admission_mod.DEFAULT_QUEUE_DEPTH
                if admission_queue_depth is None else admission_queue_depth,
                queue_timeout=admission_mod.DEFAULT_QUEUE_TIMEOUT
                if admission_queue_timeout is None
                else admission_queue_timeout,
                logger=self.logger)
            if self.ingest is not None:
                # degradation-ladder shed policy for interval merges
                # (overflow-forced merges still run)
                self.ingest.set_shed_probe(self._admission.shed_merges)
        self._resize_writes = []  # queued (kind, kwargs, lsn) while RESIZING
        self._resize_writes_lock = threading.Lock()
        self._resize_draining = False  # replay thread active
        # marks the replay thread itself: ITS imports must apply, not
        # re-queue (the queue-while-draining rule is for new client
        # writes, which wait their turn behind the backlog)
        self._resize_replay_tls = threading.local()

    @property
    def local_executor(self):
        """This node's own Executor (the ClusterExecutor's `local` on a
        cluster): its evaluator, ledgers and launch counters."""
        return getattr(self.executor, "local", self.executor)

    @property
    def device(self):
        return self.local_executor.device

    def batch_executor(self):
        """The executor the coalescer drains into: the local batched
        pipeline on a single node, the collective batch adapter on a
        cluster with a collective plane."""
        if self.cluster is not None and self.spmd is not None:
            from ..cluster.spmd import SpmdBatchRunner

            return SpmdBatchRunner(self)
        return self.local_executor

    # -- cluster state and the resize write queue ----------------------------

    def _validate_state(self):
        """Most methods are forbidden while RESIZING (reference:
        api.validate api.go:119 + apimethod_string.go)."""
        if self.cluster is not None and self.cluster.state == "RESIZING":
            raise ApiError("cluster is resizing; try again later")

    # Queue cap: past this, imports get the reference's RESIZING rejection
    # instead (backpressure; a resize should finish long before a client
    # can push 10k batches).
    RESIZE_QUEUE_MAX = 10_000
    # Replay attempts per queued write before it is dropped (transient
    # peer errors heal; a write is only lost after all retries, counted
    # in resize_replay_dropped).
    RESIZE_REPLAY_RETRIES = 3

    #: Retry-After on a full resize queue: one drain pass over a full
    #: backlog comfortably finishes within this; a still-running resize
    #: answers the retry with another (cheap) queue append.
    RESIZE_QUEUE_RETRY_AFTER = 5

    def _queue_resize_write(self, kind, kwargs, lsn=None):
        """True = the write was queued for post-resize replay (caller
        returns immediately); False = cluster not resizing, proceed.

        The state re-check happens INSIDE the queue lock, which the drain
        also holds for its swap: either this append lands before a swap
        (drained), or the drain already ran — in which case the state is
        NORMAL here and the write proceeds normally. While a drain is
        replaying, new writes keep queueing behind it so replay order is
        arrival order (a stale queued value must not clobber a newer
        acknowledged one).

        ``lsn``: the write's oplog record (already durable — the append
        happens before the queue check). The drain marks it applied once
        the queued write lands, so a crash mid-drain replays the rest of
        the backlog from the log at next boot instead of dropping it."""
        if self.cluster is None:
            return False
        if getattr(self._resize_replay_tls, "active", False):
            return False  # the drain's own replay: apply directly
        if kwargs.get("remote"):
            # Internal fan-out hop, not a client write: queueing would
            # replay it LOCALLY on a node the resize may have just
            # de-ownered. Reject like the reference; the coordinating
            # node's degraded-write policy reports the failure.
            self._validate_state()
            return False
        with self._resize_writes_lock:
            if self.cluster.state != "RESIZING" \
                    and not self._resize_draining:
                return False
            if len(self._resize_writes) >= self.RESIZE_QUEUE_MAX:
                # 503 + Retry-After, not a generic client error: a full
                # queue is backpressure, and well-behaved clients (our
                # server/client.py included) back off and retry instead
                # of treating it as a server bug. The rejected write's
                # record is marked applied — a 503 promises nothing, and
                # an eternally-unapplied lsn would pin the checkpoint.
                self._oplog_applied(lsn)
                shed_reject(
                    "resize_queue",
                    "cluster is resizing; try again later "
                    "(write queue full)",
                    self.RESIZE_QUEUE_RETRY_AFTER, qclass="batch")
            self._resize_writes.append((kind, kwargs, lsn))
        return True

    def _drain_resize_writes(self):
        """Replay queued imports after a RESIZING->NORMAL transition
        (resize completion OR abort): routing now follows the installed
        topology, so every queued bit lands on its owners. Runs on a
        background thread — the resize manager calls this while holding
        its own lock, and replay fans out over HTTP. Loops until the
        queue is empty so writes arriving mid-drain replay after the
        backlog, preserving arrival order."""
        with self._resize_writes_lock:
            if self._resize_draining or not self._resize_writes:
                return
            self._resize_draining = True

        def replay_one(kind, kwargs, lsn):
            """Apply one queued write with bounded in-place retries.
            Retrying IN PLACE (not re-queueing at the tail) is load-
            bearing: replay order is arrival order, and a failed write
            pushed behind later writes to the same bit could clobber a
            newer acknowledged value. Only after the retries are
            exhausted is the write dropped — that is the documented
            crash-semantics loss, counted in resize_replay_dropped, not
            a silent one.

            Durability: the queued write's oplog record (``lsn``) is
            marked applied only here — on success AND on a counted drop
            (else the checkpoint watermark pins forever on a record no
            one will ever apply). A crash BEFORE this line leaves the
            record below the watermark, so boot replay resumes the
            backlog instead of dropping it."""
            for attempt in range(self.RESIZE_REPLAY_RETRIES):
                try:
                    faultpoints.reached("resize.drain.apply")
                    if kind == "bits":
                        self.import_bits(**kwargs)
                    else:
                        self.import_values(**kwargs)
                    self._oplog_applied(lsn)
                    return
                except Exception:
                    where = {k: kwargs[k] for k in
                             ("index_name", "field_name")}
                    if attempt + 1 < self.RESIZE_REPLAY_RETRIES:
                        global_stats.count("resize_replay_retries")
                        flightrec.record("cluster.replay_retry", kind=kind,
                                         attempt=attempt + 1, **where)
                        self.logger.printf(
                            "resize write replay failed (attempt %d/%d, "
                            "retrying): %s %r", attempt + 1,
                            self.RESIZE_REPLAY_RETRIES, kind, where)
                        time.sleep(0.2 * (2 ** attempt))
                    else:
                        global_stats.count("resize_replay_dropped")
                        flightrec.record("cluster.replay_dropped",
                                         kind=kind, **where)
                        self.logger.printf(
                            "resize write replay DROPPED after %d "
                            "attempts: %s %r", self.RESIZE_REPLAY_RETRIES,
                            kind, where)
                        self._oplog_applied(lsn)  # counted loss, not a wedge

        def replay():
            self._resize_replay_tls.active = True
            while True:
                with self._resize_writes_lock:
                    queued = self._resize_writes
                    self._resize_writes = []
                    if not queued:
                        self._resize_draining = False
                        return
                for kind, kwargs, lsn in queued:
                    replay_one(kind, kwargs, lsn)

        threading.Thread(target=replay, daemon=True,
                         name="resize-write-drain").start()

    def query(self, index_name, pql, shards=None, options=None,
              deadline=None, query_class=None):
        """(reference: api.Query api.go:135)

        `deadline` — absolute time.monotonic() instant parsed from
        `X-Request-Deadline` at the HTTP edge (None = unbounded); checked
        here, at admission queue pop and before each launch.
        `query_class` — the validated `X-Query-Class` header value (None
        = classify from the PQL shape)."""
        self._validate_state()
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        # Expired on arrival: drop BEFORE any launch can start — the
        # client already gave up, so executing is pure waste.
        if deadline is not None and time.monotonic() >= deadline:
            flightrec.record("query.rejected", index=index_name,
                             reason="deadline_expired")
            incident_mod.note_deadline_expiry()
            raise GatewayTimeoutError(
                "request deadline expired before execution")
        # Device-link fail-fast: with the link DOWN a query would wedge
        # behind the dispatch lock until the watchdog fires; reject in
        # microseconds instead. DEGRADED still serves — hysteresis keeps
        # one flaky probe from shedding load.
        if devhealth.is_down():
            retry = devhealth.retry_after_seconds()
            flightrec.record("query.rejected", index=index_name,
                             reason="device_link_down")
            raise ServiceUnavailableError(
                "device link DOWN (canary probes failing); "
                f"retry in {retry:.0f}s", retry_after=retry)
        # Admission gate (server/admission.py): classify, price via the
        # cost model (no launch), debit the class's token bucket —
        # queueing bounded-FIFO in front of the dispatch lock when dry,
        # shedding with 503 + Retry-After past the bound. Remote legs are
        # not re-admitted: their coordinator already paid for the query.
        ticket = None
        adm = self._admission
        if adm is not None and not (options is not None
                                    and options.remote):
            ticket = self._admit_query(
                adm, index_name, pql, shards, options, deadline,
                query_class)
        if deadline is not None:
            options = options or ExecOptions()
            options.deadline = deadline
        t_admitted = time.monotonic()
        try:
            return self._query_admitted(
                index_name, pql, shards, options, deadline)
        finally:
            if ticket is not None:
                adm.note_done(ticket, time.monotonic() - t_admitted)

    def _admit_query(self, adm, index_name, pql, shards, options,
                     deadline, query_class):
        """Price + admit one query; translates the controller's
        exceptions onto the shared rejection paths: a deadline that
        lapsed in the queue is 504 (and counts toward a deadline
        storm), a shed is `shed_reject("admission", ...)`. Parse errors
        fall through unadmitted so the query path reports them as the
        usual 400."""
        from . import admission as admission_mod

        try:
            parsed = parse(pql) if isinstance(pql, str) else pql
        except Exception:  # noqa: BLE001 — the query path owns the 400
            return None
        qclass = admission_mod.classify(header=query_class, query=parsed)
        is_write = any(c.writes() for c in parsed.calls)
        cost_ms = adm.price(self.executor, self.holder.index(index_name),
                            parsed, shards, options or ExecOptions())
        try:
            return adm.admit(qclass, cost_ms, deadline=deadline,
                             is_write=is_write)
        except admission_mod.Expired as e:
            flightrec.record("query.rejected", index=index_name,
                             reason="deadline_expired_in_queue")
            incident_mod.note_deadline_expiry()
            raise GatewayTimeoutError(str(e)) from e
        except admission_mod.Rejected as e:
            flightrec.record("query.rejected", index=index_name,
                             reason="admission", qclass=e.qclass,
                             state=adm.state)
            shed_reject("admission", str(e), e.retry_after,
                        qclass=e.qclass)

    def _query_admitted(self, index_name, pql, shards, options,
                        deadline=None):
        """The query path past the admission gate (all of it when
        admission is off)."""
        # coalescer routing: batchable single-call reads with default
        # options fuse with concurrent arrivals into one batched launch;
        # ineligible queries (and window 0) take the per-query path
        if self._coalescer is not None:
            routed = self._try_coalesce(index_name, pql, shards, options)
            if routed is not None:
                return routed[0]
        # Profile when the request asked (?profile=true) or a slow-query
        # threshold is configured, so a slow query's log line carries the
        # full span tree, not just its total.
        prof = None
        if not (options is not None and options.remote) and (
                (options is not None and options.profile)
                or (options is not None
                    and getattr(options, "explain", None) == "analyze")
                or self.long_query_time is not None):
            prof = profile_mod.begin(
                index_name, pql if isinstance(pql, str) else str(pql),
                slow_threshold=self.long_query_time)
        t0 = time.monotonic()
        # watchdog coverage for the WHOLE query, not only its launches
        wtoken = flightrec.watch_begin("query", index=index_name)
        try:
            # with a profile, adopt its root span so every span below, the
            # stacked kernel launches included, joins its trace
            with (tracing.with_span(prof.root) if prof is not None
                  else contextlib.nullcontext()):
                with tracing.start_span("api.Query", index=index_name):
                    query = parse(pql) if isinstance(pql, str) else pql
                    results = self.executor.execute(
                        index_name, query, shards=shards,
                        options=options or ExecOptions())
        except ApiError:
            raise
        except DeadlineExceededError as e:
            flightrec.record("query.rejected", index=index_name,
                             reason="deadline_expired_mid_query")
            incident_mod.note_deadline_expiry()
            raise GatewayTimeoutError(str(e)) from e
        except Exception as e:
            from ..ops.cuda_build import is_device_failure

            if is_device_failure(e):
                raise  # the card failed: a 500, not a client error
            raise ApiError(str(e)) from e
        finally:
            flightrec.watch_end(wtoken)
            if prof is not None:
                prof.finish()
        self._log_slow_query(index_name, pql, time.monotonic() - t0, prof)
        # SLO tick: with objectives configured, serving traffic alone
        # keeps burn rates fresh and fires alerts (rate-limited inside)
        workload_mod.maybe_sample_slo()
        if any(c.writes() for c in query.calls):
            self._broadcast_shards_if_changed(index_name)
        return results

    def _try_coalesce(self, index_name, pql, shards, options):
        """Route one query through the coalescer when eligible. Returns a
        1-tuple (results,) on the coalesced path, or None to fall through
        to the per-query path (an ineligible query — or a parse error,
        which the per-query path re-raises as an ApiError)."""
        if shards is not None or not isinstance(pql, str):
            return None
        o = options
        if o is not None and (o.remote or o.profile or o.explain
                              or o.exclude_columns or o.exclude_row_attrs
                              or o.deadline is not None):
            return None
        try:
            query = parse(pql)
        except Exception:  # noqa: BLE001 — the per-query path reports it
            return None
        call = query.calls[0] if len(query.calls) == 1 else None
        if call is None or call.writes() \
                or call.name not in self.executor.BATCHABLE_CALLS:
            return None
        t0 = time.monotonic()
        wtoken = flightrec.watch_begin("query", index=index_name)
        try:
            # the span is the handler's whole wait: queue time, the
            # batched launch and the split of its results
            with tracing.start_span("coalesce.wait", index=index_name):
                results, bsize = self._coalescer.submit(index_name, query)
        except ApiError:
            raise
        except Exception as e:
            from ..ops.cuda_build import is_device_failure

            if is_device_failure(e):
                raise  # the card failed: a 500, not a client error
            raise ApiError(str(e)) from e
        finally:
            flightrec.watch_end(wtoken)
        # the member's fingerprint: its workload record was made on the
        # coalescer thread, so this thread's last_fingerprint() is stale
        self._log_slow_query(index_name, pql, time.monotonic() - t0,
                             batch=bsize,
                             fp=workload_mod.fingerprint(index_name,
                                                         query)[0])
        workload_mod.maybe_sample_slo()
        return (results,)

    def _log_slow_query(self, index_name, pql, elapsed, prof=None,
                        batch=None, fp=None):
        """Slow-query log (reference: LongQueryTime api.go:1157), in the
        TPU package's format. With a profile in hand the line carries the
        full span tree and counters as JSON (`profile=` stays the LAST
        field). fingerprint= is the query's workload fingerprint (the
        coalesced path passes its member's; the executor just finished a
        direct query on THIS thread, so its fingerprint is in take-last
        position), so slow lines of one shape grep together. batch= is
        the batched-launch occupancy the query rode (1 = solo). plan= is
        the analyze plan's summary (`!` marks a misestimated op), else
        the strategies the decision points noted ("-" without any).
        fused= is how many top-level calls rode ONE fused dispatch
        (exec/fusion.py), 0 when the query ran interpreted; a coalesced
        member (its fp passed in) ran on the coalescer thread, which
        never fuses whole plans, so it reports 0."""
        if (self.long_query_time is None
                or elapsed <= self.long_query_time):
            return
        import json as _json

        from ..exec.stacked import last_batch_size

        from ..exec import fusion as fusion_mod

        q = pql if isinstance(pql, str) else str(pql)
        coalesced = fp is not None
        if fp is None:
            fp = workload_mod.last_fingerprint() or "-"
        if batch is None:
            batch = last_batch_size()
        batch = max(1, int(batch))
        fused = 0 if coalesced else fusion_mod.last_fused()
        flightrec.record("query.slow", index=index_name,
                         seconds=round(elapsed, 3), pql=q[:200],
                         fingerprint=fp, batch=batch, fused=fused)
        if prof is not None:
            plan = prof.tag("plan_summary")
            if not plan:
                strategies = prof.tag("strategies")
                plan = ",".join(
                    f"{s.get('op', '?')}={s.get('strategy', '?')}"
                    for s in strategies) if strategies else "-"
            self.logger.printf(
                "%.03fs SLOW QUERY index=%s %s trace=%s fingerprint=%s "
                "batch=%d fused=%d plan=%s profile=%s", elapsed,
                index_name, q[:500], prof.root.trace_id, fp, batch,
                fused, plan, _json.dumps(prof.to_dict()))
        else:
            self.logger.printf(
                "%.03fs SLOW QUERY index=%s %s fingerprint=%s "
                "batch=%d fused=%d",
                elapsed, index_name, q[:500], fp, batch, fused)

    def debug_trace(self, trace_id, local_only=False):
        """GET /debug/traces/{trace_id}: one assembled span tree.

        Local spans come from the bounded per-node trace index (plus the
        InMemoryTracer ring when one is installed). On a cluster
        coordinator the default form also pulls every peer's slice of
        the trace (client.debug_trace → the peers' ?local=true form, so
        the fan-out cannot recurse) and merges it with per-node
        clock-skew correction — see utils/tracing.estimate_skew."""
        local = tracing.get_trace(trace_id)
        tracer = tracing.get_tracer()
        if hasattr(tracer, "to_dicts"):
            seen = {s["spanID"] for s in local}
            local += [s for s in tracer.to_dicts()
                      if s.get("traceID") == trace_id
                      and s.get("spanID") not in seen]
        if local_only or self.cluster is None \
                or len(self.cluster.nodes) <= 1 \
                or not hasattr(self.executor, "_client"):
            return {"traceID": trace_id, "found": bool(local),
                    "spans": local, "tree": tracing.assemble_tree(local)}
        remote_by_node = {}
        with tracing.with_span(None):  # don't trace the assembly fetches
            for node in list(self.cluster.nodes):
                if node.id == self.cluster.local_id:
                    continue
                try:
                    resp = self.executor._client(node).debug_trace(trace_id)
                except Exception:  # noqa: BLE001 — assembly is best-effort
                    continue
                spans = (resp or {}).get("spans") or []
                if spans:
                    remote_by_node[node.id] = spans
        merged, skew = tracing.merge_remote_spans(local, remote_by_node)
        return {"traceID": trace_id, "found": bool(merged),
                "spans": merged,
                "nodes": {nid: {"spans": len(remote_by_node[nid]),
                                "clock_skew_seconds": round(th, 6)}
                          for nid, th in skew.items()},
                "tree": tracing.assemble_tree(merged)}

    def query_batch(self, index_name, pqls, shards=None):
        """Execute a list of PQL queries as batched launches (the POST
        /index/{i}/query-batch route, the coalescer's executor path).
        Returns (results, error, batch_size) per query in request order —
        per-query error isolation, like the coalescer's."""
        self._validate_state()
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        if devhealth.is_down():
            retry = devhealth.retry_after_seconds()
            raise ServiceUnavailableError(
                "device link DOWN (canary probes failing); "
                f"retry in {retry:.0f}s", retry_after=retry)
        if self.cluster is not None:
            # cluster coordinators fan out per query; batching happens
            # on the legs' own launch paths
            out = []
            for pql in pqls:
                try:
                    out.append((self.query(index_name, pql,
                                           shards=shards), None, 0))
                except Exception as exc:  # noqa: BLE001 — per-query
                    out.append((None, exc, 0))
            return out
        return self.executor.execute_batch(
            index_name, list(pqls), shards=shards)

    def batching_stats(self):
        """GET /debug/batching: the coalescer's occupancy and queue stats
        plus the batched-launch counters of the stacked evaluator."""
        if self._coalescer is not None:
            co = self._coalescer.stats()
        else:
            co = {"enabled": False,
                  "window_seconds": self.coalesce_window,
                  "max_queue": self.coalesce_max_queue}
        st = self.local_executor.stacked_stats()
        return {
            "coalescer": co,
            "batch_dispatches": st["batch_dispatches"],
            "batched_queries": st["batched_queries"],
            "count_batches": st["count_batches"],
            "count_batched_queries": st["count_batched_queries"],
        }

    def admission_stats(self):
        """GET /debug/admission: the controller's full snapshot — ladder
        state + transition history, per-class token buckets and queue
        occupancy, calibration factor ({"enabled": False} when off)."""
        if self._admission is None:
            return {"enabled": False}
        return self._admission.snapshot()

    def serving_stale(self):
        """True when the degradation ladder is at STALE_OK or worse —
        the HTTP layer marks query responses with "stale": true so
        clients know reads may lag the ingest staleness bound."""
        return self._admission is not None \
            and self._admission.serving_stale()

    def close(self):
        """Release serving-side background state — the admission
        controller (its queued waiters get a 503), the ingest merge
        engine (final flush drains buffered deltas and releases any
        group-committed oplog watermarks) and the query coalescer,
        whose blocked waiters get a 503 instead of hanging on a daemon
        thread that dies with the process. Idempotent; default
        deployments (no controller, engine or coalescer) no-op."""
        if self._admission is not None:
            self._admission.close()
        if self.ingest is not None:
            self.ingest.close()
        if self._coalescer is not None:
            self._coalescer.close()
        if self.spmd is not None:
            self.spmd.close()

    def spmd_step(self, step):
        """Run one collective step the coordinator announced (POST
        /internal/spmd/step)."""
        if self.spmd is None:
            raise ApiError("spmd mode not enabled on this node")
        return self.spmd.run_step(step)

    def spmd_stream(self, step):
        """Enqueue one STREAMED collective step (serve mode on; POST
        /internal/spmd/stream): acks before the step runs."""
        if self.spmd is None:
            raise ApiError("spmd mode not enabled on this node")
        return self.spmd.run_stream(step)

    def spmd_debug(self):
        """GET /debug/spmd payload."""
        if self.spmd is None:
            return {"enabled": False}
        snap = self.spmd.debug_snapshot()
        snap["enabled"] = True
        return snap

    def spmd_debug_steps(self, seq=None, limit=32, local_only=False):
        """GET /debug/spmd/steps[/{seq}] payload: the cross-node step
        timeline (merged, skew-corrected, straggler-attributed), or this
        node's local slice with ?local=true (what the peers answer, so
        the fan-out never recurses)."""
        if self.spmd is None:
            return {"enabled": False}
        if local_only:
            out = self.spmd.steps_local(seq=seq, limit=limit)
        else:
            out = self.spmd.steps_timeline(seq=seq, limit=limit)
        out["enabled"] = True
        return out

    def spmd_set_mode(self, mode):
        """POST /debug/spmd {"serve_mode": ...}: the run-time serve-mode
        switch (off|on|shadow|http; http forces the HTTP fan-out for A/B
        runs on one cluster)."""
        from ..cluster.spmd import SpmdError

        if self.spmd is None:
            raise ApiError("spmd mode not enabled on this node")
        try:
            return {"serve_mode": self.spmd.set_serve_mode(mode)}
        except SpmdError as e:  # an unknown mode
            raise ApiError(str(e)) from e

    def create_index(self, name, options=None, remote=False):
        """(reference: api.CreateIndex; a cluster broadcasts it to every
        peer, which applies it with remote=True)"""
        from ..core.holder import HolderError
        from ..core.index import IndexError_

        try:
            idx = self.holder.create_index(
                name, options=options, if_not_exists=remote)
        except HolderError as e:
            raise ConflictError(str(e)) from e
        except IndexError_ as e:
            raise ApiError(str(e)) from e
        if not remote:
            self._broadcast(MessageType.CREATE_INDEX, {
                "index": name,
                "options": idx.options.to_dict()})
        return idx

    def delete_index(self, name, remote=False):
        """(reference: api.DeleteIndex). Device stacks of the deleted
        index stay in their pools until evicted; a re-created index never
        reads them, as its fragments' uids differ."""
        from ..core.holder import HolderError

        try:
            self.holder.delete_index(name)
        except HolderError as e:
            raise NotFoundError(str(e)) from e
        self._pushed_shards.pop(name, None)
        if self.spmd is not None:
            # mesh-resident blocks of a deleted index must not pin device
            # memory (gen validation already keeps them unread)
            self.spmd.mesh_cache.invalidate_index(name)
        if self.cluster is not None:
            self.cluster.drop_remote_index(name)
        if not remote:
            self._broadcast(MessageType.DELETE_INDEX, {"index": name})

    def create_field(self, index_name, field_name, options=None,
                     remote=False):
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            field = idx.create_field(
                field_name, options=options, if_not_exists=remote)
        except IndexError_ as e:
            if "already exists" in str(e):
                raise ConflictError(str(e)) from e
            raise ApiError(str(e)) from e
        if not remote:
            self._broadcast(MessageType.CREATE_FIELD, {
                "index": index_name, "field": field_name,
                "options": field.options.to_dict()})
        return field

    def delete_field(self, index_name, field_name, remote=False):
        """(reference: api.DeleteField)"""
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            idx.delete_field(field_name)
        except IndexError_ as e:
            raise NotFoundError(str(e)) from e
        if not remote:
            self._broadcast(MessageType.DELETE_FIELD, {
                "index": index_name, "field": field_name})

    def _broadcast(self, msg_type, payload, sync=True):
        """Schema DDL fans out synchronously to every peer (reference: DDL
        via SendSync broadcast.go / api.go)."""
        if self.cluster is None or len(self.cluster.nodes) <= 1:
            return
        from ..cluster import HTTPBroadcaster

        b = HTTPBroadcaster(self.cluster, self.client_factory)
        if sync:
            b.send_sync(msg_type, payload)
        else:
            b.send_async(msg_type, payload)

    def _broadcast_shards_if_changed(self, index_name):
        """Push this node's per-index available shards to peers when they
        changed (reference: availableShards gossiped via
        CreateShardMessage / NodeStatus, cluster.go) so shard discovery
        reads the pushed map instead of per-query peer GETs."""
        if self.cluster is None or len(self.cluster.nodes) <= 1:
            return
        idx = self.holder.index(index_name)
        if idx is None:
            return
        shards = set(idx.available_shards())
        if self._pushed_shards.get(index_name) == shards:
            return
        self._pushed_shards[index_name] = shards
        try:
            self._broadcast(MessageType.CREATE_SHARD, {
                "index": index_name,
                "node": self.cluster.local_id,
                "shards": sorted(shards)}, sync=False)
        except Exception:  # noqa: BLE001
            # best-effort: the lazy per-peer seed fetch still converges
            pass

    def receive_message(self, data):
        """Handle one control-plane message (reference:
        server.receiveMessage server.go:569)."""
        msg_type, payload = Serializer.unmarshal(data)
        if msg_type == MessageType.CREATE_INDEX:
            self.create_index(
                payload["index"],
                options=IndexOptions.from_dict(payload["options"]),
                remote=True)
        elif msg_type == MessageType.DELETE_INDEX:
            self.delete_index(payload["index"], remote=True)
        elif msg_type == MessageType.CREATE_FIELD:
            self.create_field(
                payload["index"], payload["field"],
                options=FieldOptions.from_dict(payload["options"]),
                remote=True)
        elif msg_type == MessageType.DELETE_FIELD:
            self.delete_field(payload["index"], payload["field"], remote=True)
        elif msg_type == MessageType.RECALCULATE_CACHES:
            self.holder.recalculate_caches()
        elif msg_type == MessageType.CREATE_SHARD:
            # a peer pushed its per-index available shards (gossiped
            # shard map; reference: CreateShardMessage handling)
            if self.cluster is not None \
                    and payload.get("node") != self.cluster.local_id:
                self.cluster.set_remote_shards(
                    payload["node"], payload["index"],
                    payload.get("shards", []))
        elif self.resize is not None and self.resize.receive(
                msg_type, payload):
            pass  # resize/cluster-status/coordinator handled
        elif msg_type == MessageType.NODE_STATE:
            if self.cluster is not None:
                self.cluster.set_node_state(
                    payload["id"], payload["state"])
        elif msg_type in (MessageType.NODE_EVENT, MessageType.NODE_STATUS,
                          MessageType.CLUSTER_STATUS,
                          MessageType.CREATE_VIEW, MessageType.DELETE_VIEW,
                          MessageType.SET_COORDINATOR,
                          MessageType.UPDATE_COORDINATOR,
                          MessageType.RESIZE_INSTRUCTION,
                          MessageType.RESIZE_INSTRUCTION_COMPLETE):
            # single-node mode: no resize manager; tolerated
            pass
        else:
            raise ApiError(f"unhandled message type: {msg_type}")

    def apply_schema(self, schema):
        """Create every index and field of a schema in the camelCase wire
        shape that are missing (reference: handlePostSchema)."""
        for idx_desc in schema.get("indexes", []):
            opts = idx_desc.get("options", {})
            idx = self.holder.create_index(
                idx_desc["name"],
                options=IndexOptions(
                    keys=bool(opts.get("keys", False)),
                    track_existence=bool(opts.get("trackExistence", True))),
                if_not_exists=True)
            for f_desc in idx_desc.get("fields", []):
                idx.create_field(
                    f_desc["name"],
                    options=field_options_from_json(f_desc.get("options")),
                    if_not_exists=True)

    def _field(self, index_name, field_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        field = idx.field(field_name)
        if field is None:
            raise NotFoundError(f"field not found: {field_name}")
        return field

    def _translate_import_keys(self, index_name, field_name,
                               row_keys, column_keys):
        """String keys -> ids for a bulk import (reference: api.Import key
        translation api.go:920-1000). Returns (row_ids, column_ids) for
        whichever key lists were given. Both options are checked before
        either list translates: translation allocates ids for good, so a
        rejected import must leave no new keys behind."""
        idx = self.holder.index(index_name)
        field = idx.field(field_name)
        if column_keys is not None and not idx.options.keys:
            raise ApiError(f"index {index_name} does not use column keys")
        if row_keys is not None and not field.options.keys:
            raise ApiError(f"field {field_name} does not use row keys")
        row_ids = column_ids = None
        if column_keys is not None:
            column_ids = list(
                idx.translate_store.translate_keys(column_keys))
        if row_keys is not None:
            row_ids = list(field.translate_store.translate_keys(row_keys))
        return row_ids, column_ids

    def _route_import(self, index_name, shard):
        """(local_apply, remote_nodes) for one shard's import slice
        (reference: api.Import forwards to FragmentNodes, all replicas)."""
        if self.cluster is None or len(self.cluster.nodes) <= 1:
            return True, []
        owners = self.cluster.shard_nodes(index_name, shard)
        local = any(n.id == self.cluster.local_id for n in owners)
        remotes = [n for n in owners if n.id != self.cluster.local_id]
        return local, remotes

    def _fan_out_writes(self, jobs, covered_locally, count_shards=(),
                        index_name=None):
        """Run remote import forwards (one worker per TARGET NODE, its jobs
        sequential — bounded like the executor's per-node mapReduce fan-out)
        and apply the degraded-write policy.

        `jobs`: list of (shard, node, thunk). A forward failure is tolerated
        as long as the shard reached at least one owner (this node or
        another replica) — the lagging replica is repaired by anti-entropy
        (reference: DEGRADED semantics cluster.go:571-583 + fragment
        syncer). A shard that reached NO owner fails the import.

        `count_shards`: shards NOT applied locally; returns their total
        logical change count taken from replica responses (replicas report
        the same count, so max per shard).
        """
        from ..cluster.node import NODE_STATE_DOWN

        results, errors, skipped = {}, {}, {}
        lock = threading.Lock()
        by_node = {}
        for shard, node, thunk in jobs:
            by_node.setdefault(node.id, (node, []))[1].append((shard, thunk))

        def run(node, node_jobs):
            for shard, thunk in node_jobs:
                if getattr(node, "state", None) == NODE_STATE_DOWN:
                    # health monitor flagged the node mid-import: don't
                    # burn a full timeout per remaining shard (retried
                    # below only if the shard reaches no other owner)
                    with lock:
                        errors[(shard, node.id)] = ApiError(
                            f"node {node.id} is down")
                        skipped[(shard, node.id)] = thunk
                    continue
                try:
                    resp = thunk()
                    with lock:
                        results[(shard, node.id)] = resp
                except Exception as e:
                    with lock:
                        errors[(shard, node.id)] = e

        threads = [threading.Thread(target=run, args=pair)
                   for pair in by_node.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        def uncovered():
            reached = set(covered_locally)
            reached.update(shard for shard, _ in results)
            return sorted({s for (s, _) in errors} - reached)

        # A DOWN mark can be a false positive; when a skipped node was a
        # shard's ONLY owner, attempt the send anyway before failing.
        for (shard, node_id), thunk in skipped.items():
            if shard in uncovered():
                try:
                    results[(shard, node_id)] = thunk()
                    del errors[(shard, node_id)]
                except Exception as e:
                    errors[(shard, node_id)] = e
        failed = uncovered()
        if failed:
            cause = next(e for (s, _), e in errors.items() if s in failed)
            raise ApiError(
                f"import failed: no reachable owner for shards {failed}: "
                f"{cause}")
        for (shard, node_id), e in errors.items():
            self.logger.printf(
                "import: replica %s unreachable for shard %d (%s); "
                "anti-entropy will repair", node_id, shard, e)
        # read-your-writes for shard discovery: this node just confirmed
        # these shards landed on these peers — record them now instead of
        # waiting for the peers' async CREATE_SHARD pushes (which can lag
        # the ack and leave an immediate query missing a fresh shard)
        if self.cluster is not None and index_name is not None:
            for (shard, node_id) in results:
                self.cluster.record_remote_shards(
                    node_id, index_name, [shard])
        remote_changed = {s: 0 for s in count_shards}
        for (shard, _), resp in results.items():
            if shard in remote_changed and isinstance(resp, dict):
                remote_changed[shard] = max(
                    remote_changed[shard], resp.get("changed", 0))
        return results, sum(remote_changed.values())

    def import_bits(self, index_name, field_name, row_ids, column_ids,
                    timestamps=None, clear=False, remote=False,
                    row_keys=None, column_keys=None):
        """(reference: api.Import api.go:920; string keys translate to ids
        first, on the coordinating node). The record reaches the oplog
        before the apply, with the keys as given. On a cluster each
        shard's slice goes to every replica owner (remote=True on the
        forwarded hop, which applies locally).

        During RESIZING the reference rejects imports outright
        (api.go:101); here they QUEUE and replay once the cluster returns
        to NORMAL, by the then-installed topology, so completion AND
        abort both land every bit. The queue is process memory: bounded,
        and lost on a crash like any unflushed WAL tail (the oplog
        replays it). Index and field existence is checked BEFORE
        queueing, so a doomed import 404s now."""
        field = self._field(index_name, field_name)
        n_points = (len(column_ids) if column_ids is not None
                    else len(column_keys or ()))
        self._ingest_admit(n_points, 16 * n_points)
        kwargs = dict(index_name=index_name, field_name=field_name,
                      row_ids=row_ids, column_ids=column_ids,
                      timestamps=timestamps, clear=clear,
                      remote=remote, row_keys=row_keys,
                      column_keys=column_keys)
        lsn = self._oplog_append("bits", kwargs)
        faultpoints.reached("import.post-append")
        if self._queue_resize_write("bits", kwargs, lsn=lsn):
            return 0
        try:
            if row_keys is not None or column_keys is not None:
                t_rows, t_cols = self._translate_import_keys(
                    index_name, field_name, row_keys, column_keys)
                if t_rows is not None:
                    row_ids = t_rows
                if t_cols is not None:
                    column_ids = t_cols
            if remote or self.cluster is None \
                    or len(self.cluster.nodes) <= 1:
                changed = field.import_bits(
                    row_ids, column_ids, timestamps=timestamps, clear=clear)
                # the columns exist after a clear import too, as in the
                # TPU package (a cleared bit is still a column written)
                self.holder.index(index_name).add_existence(column_ids)
                if self.ingest is not None:
                    self._ingest_record(
                        index_name, field,
                        self._ingest_shard_rows(column_ids),
                        16 * len(column_ids))
                self._broadcast_shards_if_changed(index_name)
                faultpoints.reached("import.pre-ack")
                return changed

            from ..core.timeq import TIME_FORMAT

            row_ids = np.asarray(row_ids, dtype=np.uint64)
            column_ids = np.asarray(column_ids, dtype=np.uint64)
            shards = column_ids // np.uint64(SHARD_WIDTH)
            changed = 0
            jobs, covered, remote_only = [], set(), set()
            for shard in np.unique(shards):
                shard = int(shard)
                mask = shards == shard
                local, remotes = self._route_import(index_name, shard)
                slice_rows = row_ids[mask]
                slice_cols = column_ids[mask]
                slice_ts = None
                if timestamps is not None:
                    ts_arr = np.asarray(timestamps, dtype=object)
                    slice_ts = ts_arr[mask].tolist()
                if local:
                    changed += field.import_bits(
                        slice_rows, slice_cols, timestamps=slice_ts,
                        clear=clear)
                    self.holder.index(index_name).add_existence(slice_cols)
                    covered.add(shard)
                else:
                    remote_only.add(shard)
                wire_ts = None
                if slice_ts is not None:
                    wire_ts = [
                        t.strftime(TIME_FORMAT) if t is not None else None
                        for t in slice_ts]
                for node in remotes:
                    jobs.append((shard, node, (
                        lambda n=node, r=slice_rows, c=slice_cols, w=wire_ts:
                        self.client_factory(n.uri).import_bits(
                            index_name, field_name, r.tolist(), c.tolist(),
                            timestamps=w, clear=clear, remote=True))))
            if self.ingest is not None and covered:
                self._ingest_record(
                    index_name, field,
                    {s: int((shards == np.uint64(s)).sum())
                     for s in covered},
                    16 * len(column_ids))
            _, remote_changed = self._fan_out_writes(
                jobs, covered, count_shards=remote_only,
                index_name=index_name)
            self._broadcast_shards_if_changed(index_name)
            faultpoints.reached("import.pre-ack")
            return changed + remote_changed
        finally:
            # an exception here means NO ack went out, so the record
            # needs no replay guarantee — mark it applied either way so
            # one failed import can't pin the checkpoint watermark
            # forever (a process crash skips this; that's the point)
            self._oplog_applied_or_defer(lsn)

    def import_values(self, index_name, field_name, column_ids, values,
                      remote=False, column_keys=None, clear=False):
        """Bulk BSI values (reference: api.ImportValue api.go:1035), routed
        per shard like import_bits. clear=True removes the listed
        columns' values (OptImportOptionsClear -> field.importValue
        field.go:1285)."""
        field = self._field(index_name, field_name)
        n_points = (len(column_ids) if column_ids is not None
                    else len(column_keys or ()))
        self._ingest_admit(n_points, 16 * n_points)
        kwargs = dict(index_name=index_name, field_name=field_name,
                      column_ids=column_ids, values=values,
                      remote=remote, column_keys=column_keys,
                      clear=clear)
        lsn = self._oplog_append("values", kwargs)
        faultpoints.reached("import.post-append")
        if self._queue_resize_write("values", kwargs, lsn=lsn):
            return 0
        try:
            if column_keys is not None:
                _, column_ids = self._translate_import_keys(
                    index_name, field_name, None, column_keys)
            if remote or self.cluster is None \
                    or len(self.cluster.nodes) <= 1:
                changed = field.import_values(column_ids, values, clear=clear)
                if not clear:
                    self.holder.index(index_name).add_existence(column_ids)
                if self.ingest is not None:
                    self._ingest_record(
                        index_name, field,
                        self._ingest_shard_rows(column_ids),
                        16 * len(column_ids), existence=not clear)
                self._broadcast_shards_if_changed(index_name)
                faultpoints.reached("import.pre-ack")
                return changed

            column_ids = np.asarray(column_ids, dtype=np.uint64)
            values = np.asarray(values, dtype=np.int64)
            shards = column_ids // np.uint64(SHARD_WIDTH)
            changed = 0
            jobs, covered, remote_only = [], set(), set()
            for shard in np.unique(shards):
                shard = int(shard)
                mask = shards == shard
                local, remotes = self._route_import(index_name, shard)
                if local:
                    changed += field.import_values(
                        column_ids[mask], values[mask], clear=clear)
                    if not clear:
                        self.holder.index(index_name).add_existence(
                            column_ids[mask])
                    covered.add(shard)
                else:
                    remote_only.add(shard)
                for node in remotes:
                    jobs.append((shard, node, (
                        lambda n=node, c=column_ids[mask], v=values[mask]:
                        self.client_factory(n.uri).import_values(
                            index_name, field_name, c.tolist(), v.tolist(),
                            remote=True, clear=clear))))
            if self.ingest is not None and covered:
                self._ingest_record(
                    index_name, field,
                    {s: int((shards == np.uint64(s)).sum())
                     for s in covered},
                    16 * len(column_ids), existence=not clear)
            _, remote_changed = self._fan_out_writes(
                jobs, covered, count_shards=remote_only,
                index_name=index_name)
            self._broadcast_shards_if_changed(index_name)
            faultpoints.reached("import.pre-ack")
            return changed + remote_changed
        finally:
            self._oplog_applied_or_defer(lsn)

    def import_roaring(self, index_name, field_name, shard, data,
                       clear=False, view="standard", remote=False):
        """Merge a serialized roaring blob of row * SHARD_WIDTH + offset
        positions into one shard of one view (reference: api.ImportRoaring
        api.go:368). Like bit imports, the blob routes to every replica
        owner of the shard. Returns the number of bits changed."""
        self._validate_state()
        field = self._field(index_name, field_name)
        shard = int(shard)
        self._ingest_admit(1, len(data))
        lsn = self._oplog_append("roaring", dict(
            index_name=index_name, field_name=field_name, shard=shard,
            data=data, clear=clear, view=view, remote=remote))
        faultpoints.reached("import.post-append")
        try:
            local, remotes = (True, []) if remote else \
                self._route_import(index_name, shard)
            changed = 0
            if local:
                v = field.create_view_if_not_exists(view)
                frag = v.create_fragment_if_not_exists(shard)
                changed = frag.import_roaring(data, clear=clear)
                if self.ingest is not None:
                    self._ingest_record(
                        index_name, field, {shard: 1}, len(data),
                        existence=False)
            jobs = [(shard, node, (
                lambda n=node: self.client_factory(n.uri).import_roaring(
                    index_name, field_name, shard, data, clear=clear,
                    view=view, remote=True))) for node in remotes]
            _, remote_changed = self._fan_out_writes(
                jobs, {shard} if local else set(),
                count_shards=() if local else {shard},
                index_name=index_name)
            self._broadcast_shards_if_changed(index_name)
            faultpoints.reached("import.pre-ack")
            return changed if local else remote_changed
        finally:
            self._oplog_applied_or_defer(lsn)

    # -- durable oplog (storage/oplog.py) ------------------------------------

    def _oplog_append(self, kind, kwargs):
        """Append one import's record BEFORE any queue/apply/ack step;
        returns its LSN (None when no oplog is attached). A boot replay
        re-entering the import path reuses the original record's LSN
        instead of re-appending; the resize drain's own replay likewise
        appends nothing — its queued records already stand in the log."""
        if self.oplog is None:
            return None
        replay_lsn = getattr(self._oplog_tls, "replay_lsn", None)
        if replay_lsn is not None:
            return replay_lsn
        if getattr(self._resize_replay_tls, "active", False):
            return None
        return self.oplog.append(self._oplog_encode(kind, kwargs))

    def _oplog_applied(self, lsn):
        """The write at ``lsn`` finished its synchronous apply (or was
        counted as dropped): advance the applied watermark."""
        if lsn is not None and self.oplog is not None:
            self.oplog.mark_applied(lsn)

    def _oplog_applied_or_defer(self, lsn):
        """Like _oplog_applied, but under fsync=interval with the ingest
        engine active the watermark advance group-commits at the next
        merge instead of per record (bounded by the oplog's gap set; a
        crash before the flush replays the records, which is safe —
        they applied to host fragments idempotently)."""
        ing = self.ingest
        if ing is not None and ing.defer_applied(lsn):
            return
        self._oplog_applied(lsn)

    # -- streaming ingest (exec/ingest.py) ------------------------------------

    def _ingest_admit(self, rows, nbytes):
        """503 + Retry-After back-pressure when the delta buffer is past
        its high-water mark — checked BEFORE the oplog append so a
        rejected import leaves no record behind."""
        ing = self.ingest
        if ing is None:
            return
        retry = ing.admit(rows, nbytes)
        if retry is not None:
            shed_reject(
                "ingest",
                "ingest delta buffer full; merge in progress",
                retry, qclass="batch")

    def _ingest_record(self, index_name, field, shard_rows, nbytes,
                       existence=True):
        """Buffer one applied import's deltas (incl. the index's
        existence field, which add_existence just wrote — roaring
        imports skip it, they never touch existence)."""
        ing = self.ingest
        if ing is None or not shard_rows:
            return
        ing.record(index_name, field, shard_rows, nbytes)
        if not existence:
            return
        idx = self.holder.index(index_name)
        ef = idx.existence_field() if idx is not None else None
        if ef is not None and ef is not field:
            ing.record(index_name, ef, shard_rows, nbytes)

    @staticmethod
    def _ingest_shard_rows(column_ids):
        """{shard: landed rows} for the ingest buffer's accounting."""
        cols = np.asarray(column_ids, dtype=np.uint64)
        if cols.size == 0:
            return {}
        shards, counts = np.unique(cols // np.uint64(SHARD_WIDTH),
                                   return_counts=True)
        return {int(s): int(n) for s, n in zip(shards, counts)}

    def ingest_stats(self):
        """GET /debug/ingest payload ({"enabled": False} when off)."""
        if self.ingest is None:
            return {"enabled": False, "interval_seconds": 0.0}
        return self.ingest.snapshot()

    @staticmethod
    def _oplog_encode(kind, kwargs):
        """JSON-safe record for one import call, captured PRE-translation
        (keys replay through the durable translate stores and get the
        same ids) with datetimes as wire strings and roaring blobs as
        base64. Numeric id/value lists ride as base64 of packed
        fixed-width ints (:func:`_oplog_pack_ints`) — this sits on the
        ack path, and at import batch sizes that serializes ~2x faster
        and smaller than a JSON int list of the same data."""
        rec = {"kind": kind}
        for k, v in kwargs.items():
            if v is None or isinstance(v, (bool, int, float, str)):
                rec[k] = v
            elif k == "timestamps":
                from ..core.timeq import TIME_FORMAT

                rec[k] = [t if (t is None or isinstance(t, str))
                          else t.strftime(TIME_FORMAT) for t in v]
            elif k == "data":
                rec[k] = base64.b64encode(bytes(v)).decode()
            else:
                packed = _oplog_pack_ints(v)
                if packed is None:  # key lists (strings), mixed lists
                    rec[k] = np.asarray(v).tolist()
                else:
                    rec[k] = packed
        return rec

    @staticmethod
    def _oplog_decode_kwargs(record):
        """Invert :meth:`_oplog_encode`'s binary list packing (replay
        path only — cold)."""
        kw = {}
        for k, v in record.items():
            if k == "kind":
                continue
            if isinstance(v, dict) and "__b" in v:
                arr = array.array(_OPLOG_DT[v.get("dt", "i8")])
                arr.frombytes(base64.b64decode(v["__b"]))
                v = arr.tolist()
            kw[k] = v
        return kw

    def _apply_oplog_record(self, record):
        """Replay one decoded record through the NORMAL import path (so
        key translation and existence tracking behave exactly like the
        original call did)."""
        kind = record.get("kind")
        kw = self._oplog_decode_kwargs(record)
        if kind == "bits":
            ts = kw.get("timestamps")
            if ts is not None:
                from ..core import timeq

                kw["timestamps"] = [
                    timeq.parse_time(t) if t else None for t in ts]
            return self.import_bits(**kw)
        if kind == "values":
            return self.import_values(**kw)
        if kind == "roaring":
            kw["data"] = base64.b64decode(kw["data"])
            return self.import_roaring(**kw)
        raise ApiError(f"unknown oplog record kind: {kind!r}")

    def replay_oplog(self):
        """Boot-time crash recovery: re-apply every record past the last
        checkpoint, in LSN (== arrival) order. Idempotent — set-bit
        records re-set already-set bits, BSI value records replay
        last-write-wins — so records that were applied (even fsynced)
        before the crash converge to the pre-crash state. Returns the
        number of records applied. Call BEFORE serving."""
        if self.oplog is None:
            return 0

        def apply(lsn, record):
            self._oplog_tls.replay_lsn = lsn
            try:
                self._apply_oplog_record(record)
            finally:
                self._oplog_tls.replay_lsn = None

        applied, failed = self.holder.replay_oplog(
            self.oplog, apply, logger=self.logger)
        if applied:
            # everything replayed is in fragment WALs now; make it
            # durable and move the checkpoint so the NEXT restart
            # replays only what this boot couldn't finish
            self.holder.sync_fragments()
            self.oplog.checkpoint()
        return applied

    def _oplog_rotate_checkpoint(self, _sealed_last_lsn):
        """Segment rotation is the checkpoint trigger that keeps the log
        bounded: fsync every fragment (making all applied records
        durable BELOW the log) then checkpoint at the applied watermark,
        dropping fully-applied sealed segments. Runs on its own thread —
        the append that tripped the rotation must not wait out a full
        fragment fsync sweep — and the non-blocking lock collapses
        back-to-back rotations into one sweep."""
        if not self._oplog_ckpt_lock.acquire(blocking=False):
            return

        def run():
            try:
                self.holder.sync_fragments()
                self.oplog.checkpoint()
            except Exception as e:  # noqa: BLE001 — retried at next rotate
                self.logger.printf(
                    "oplog checkpoint after rotation failed: %s", e)
            finally:
                self._oplog_ckpt_lock.release()

        threading.Thread(target=run, daemon=True,
                         name="oplog-checkpoint").start()

    def export_csv(self, index_name, field_name, shard):
        """(reference: api.ExportCSV api.go:500) row,col lines for one
        shard of the standard view, ids translated back to keys on keyed
        fields and indexes (api.go:538-557), so an export re-imports
        losslessly."""
        idx = self.holder.index(index_name)
        field = self._field(index_name, field_name)
        view = field.view()
        frag = view.fragment(int(shard)) if view else None
        buf = io.StringIO()
        writer = csv.writer(buf)
        if frag is None:
            return buf.getvalue()

        def batch_translate(store, ids, what):
            """Batched id->key that fails loudly: a silently empty cell
            would break the export->import round trip."""
            out = {}
            for id_, key in zip(ids, store.translate_ids(ids)):
                if key is None:
                    raise ApiError(
                        f"translating {what} id {id_} failed: key not "
                        "found")
                out[id_] = key
            return out

        row_ids = frag.row_ids()
        row_out = {r: r for r in row_ids}
        if field.options.keys:
            row_out = batch_translate(field.translate_store, row_ids, "row")
        col_memo = {}
        for row_id in row_ids:
            cols = [int(c) for c in frag.row_columns(row_id)]
            if idx.options.keys:
                missing = [c for c in cols if c not in col_memo]
                if missing:
                    col_memo.update(batch_translate(
                        idx.translate_store, missing, "column"))
                for col in cols:
                    writer.writerow([row_out[row_id], col_memo[col]])
            else:
                for col in cols:
                    writer.writerow([row_out[row_id], col])
        return buf.getvalue()

    def recalculate_caches(self):
        """(reference: api.RecalculateCaches) rebuild every fragment's
        TopN rank cache, here and on every peer."""
        self.holder.recalculate_caches()
        self._broadcast(MessageType.RECALCULATE_CACHES, {}, sync=False)

    def column_attr_sets(self, index_name, results):
        """{"id", "attrs"} of every column of the Row results that has
        attributes, in column order (reference: QueryResponse
        ColumnAttrSets, filled when a query asks for columnAttrs)."""
        from ..core.row import Row

        idx = self.holder.index(index_name)
        if idx is None or idx.column_attr_store is None:
            return []
        cols = set()
        for r in results:
            if isinstance(r, Row):
                cols.update(int(c) for c in r.columns())
        out = []
        for c in sorted(cols):
            attrs = idx.column_attr_store.attrs(c)
            if attrs:
                out.append({"id": c, "attrs": attrs})
        return out

    def schema(self):
        """Public schema in the reference's camelCase wire shape."""
        out = []
        for iname in sorted(self.holder.indexes):
            idx = self.holder.indexes[iname]
            fields = []
            for fname in sorted(idx.public_fields()):
                f = idx.fields[fname]
                fields.append({
                    "name": fname,
                    "options": field_options_to_json(f.options),
                    "shards": f.available_shards(),
                })
            out.append({
                "name": iname,
                "options": {"keys": idx.options.keys,
                            "trackExistence": idx.options.track_existence},
                "fields": fields,
            })
        return {"indexes": out}

    def info(self):
        return {"shardWidth": SHARD_WIDTH, "version": __version__}

    def shards_max(self):
        out = {}
        for name, idx in self.holder.indexes.items():
            shards = idx.available_shards()
            out[name] = shards[-1] if shards else 0
        return {"standard": out}

    def hosts(self):
        if self.cluster is not None:
            return self.cluster.nodes_json()
        return [{"id": "local", "isCoordinator": True}]

    # -- node internals: backup, export and restore read fragments here ------

    def index_shards(self, index_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        return {"shards": idx.available_shards()}

    def shard_nodes(self, index_name, shard):
        """Owner nodes of one shard, as node JSON (reference:
        api.ShardNodes api.go:1086, served by handler.go:311)."""
        if self.cluster is None:
            return [{"id": "local", "isCoordinator": True}]
        return [n.to_json()
                for n in self.cluster.shard_nodes(index_name, int(shard))]

    def delete_available_shard(self, index_name, field_name, shard):
        """Forget a remotely-advertised shard for a field (reference:
        api.DeleteAvailableShard api.go:1266 -> Field.RemoveAvailableShard
        field.go:513; used when a remote's shard advertisement turns out
        stale).

        As in the TPU package, availability is tracked per INDEX in the
        gossiped shard map, not per field as in the reference: the route
        accepts (and validates) a field name for wire compatibility, but
        removal drops the shard from every peer's record for the WHOLE
        index. The next gossip push from the owning node restores it if
        any field still has data."""
        self._field(index_name, field_name)  # 404 on unknown index/field
        if self.cluster is not None:
            self.cluster.remove_remote_shard(index_name, int(shard))
        return None

    def _fragment(self, index_name, field_name, view_name, shard):
        field = self._field(index_name, field_name)
        view = field.view(view_name)
        frag = view.fragment(int(shard)) if view else None
        if frag is None:
            raise NotFoundError(
                f"fragment not found: {index_name}/{field_name}/"
                f"{view_name}/{shard}")
        return frag

    def shard_fragments(self, index_name, shard):
        """Every (field, view) fragment present for a shard on this node
        (the views are data-dependent, so a reader can't know them)."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        shard = int(shard)
        out = []
        for field in idx.fields.values():
            for vname, view in field.views.items():
                if view.fragment(shard) is not None:
                    out.append({"field": field.name, "view": vname})
        return {"fragments": out}

    def fragment_blocks(self, index_name, field_name, view_name, shard):
        """(reference: /internal/fragment/blocks handler.go:300)"""
        frag = self._fragment(index_name, field_name, view_name, shard)
        return {"blocks": [{"id": bid, "checksum": chk.hex()}
                           for bid, chk in frag.blocks()]}

    def fragment_block_data(self, index_name, field_name, view_name, shard,
                            block):
        frag = self._fragment(index_name, field_name, view_name, shard)
        rows, cols = frag.block_data(int(block))
        return {"rowIDs": [int(r) for r in rows],
                "columnIDs": [int(c) for c in cols]}

    def fragment_data(self, index_name, field_name, view_name, shard):
        """Whole fragment as a serialized roaring blob (reference:
        /internal/fragment/data)."""
        from ..roaring import serialize

        frag = self._fragment(index_name, field_name, view_name, shard)
        return serialize(frag.storage)

    # -- key replication and attribute anti-entropy --------------------------

    def translate_data(self, index_name, field_name="", offset=0):
        """Translate-entry feed from a given ID offset (reference:
        http/translator.go + holder.go:702-880)."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        if field_name:
            field = idx.field(field_name)
            if field is None:
                raise NotFoundError(f"field not found: {field_name}")
            store = field.translate_store
        else:
            store = idx.translate_store
        if store is None:
            return {"entries": []}
        return {"entries": [e.to_json() for e in store.entries(int(offset))]}

    def translate_keys_create(self, index_name, field_name, keys):
        """Allocate ids for keys — served by the chain head; a replica
        receiving this forwards through its own remote_create hook
        (reference: translate key writes route to the primary,
        http/handler.go:518-522)."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        if field_name:
            field = idx.field(field_name)
            if field is None:
                raise NotFoundError(f"field not found: {field_name}")
            store = field.translate_store
        else:
            store = idx.translate_store
        if store is None:
            raise ApiError(
                f"keys not enabled: {index_name}/{field_name or '<index>'}")
        return {"ids": store.translate_keys(list(keys), create=True)}

    def _attr_store(self, index_name, field_name=""):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        if field_name:
            field = idx.field(field_name)
            if field is None:
                raise NotFoundError(f"field not found: {field_name}")
            return field.row_attr_store
        return idx.column_attr_store

    def attr_blocks(self, index_name, field_name=""):
        """(reference: attr diff api.go:817-891)"""
        store = self._attr_store(index_name, field_name)
        if store is None:
            return {"blocks": []}
        return {"blocks": [{"id": bid, "checksum": chk}
                           for bid, chk in store.blocks()]}

    def attr_block_data(self, index_name, field_name="", block=0):
        store = self._attr_store(index_name, field_name)
        if store is None:
            return {"attrs": {}}
        return {"attrs": {str(id): attrs for id, attrs
                          in store.block_data(int(block)).items()}}

    def attr_diff(self, index_name, field_name, remote_blocks):
        """Attrs from every local block that differs from (or is absent
        in) the caller's checksum list — one round trip of the attr
        anti-entropy protocol (reference: api.IndexAttrDiff api.go:817 +
        attrBlocks.Diff attr.go:90; served at
        /internal/index/{i}/attr/diff and .../field/{f}/attr/diff, which
        a stock internal client posts to)."""
        store = self._attr_store(index_name, field_name)  # 404s for us
        if store is None:
            return {"attrs": {}}
        return {"attrs": {str(id): a
                          for id, a in store.diff(remote_blocks).items()}}

    # -- resize admin (reference: api.go:1193-1267) ---------------------------

    def _resize_manager(self):
        from ..cluster import ResizeError

        if self.resize is None:
            raise ApiError("not a cluster")
        if not self.cluster.is_coordinator():
            coord = self.cluster.coordinator
            raise ApiError(
                f"not the coordinator (coordinator: "
                f"{coord.id if coord else 'unknown'})")
        return self.resize, ResizeError

    def resize_add_node(self, node_json):
        from ..cluster import Node

        mgr, ResizeError = self._resize_manager()
        node = Node.from_json(node_json)
        try:
            return mgr.add_node(node).to_json()
        except ResizeError as e:
            raise ApiError(str(e)) from e

    def resize_remove_node(self, node_id):
        mgr, ResizeError = self._resize_manager()
        try:
            return mgr.remove_node(node_id).to_json()
        except ResizeError as e:
            raise ApiError(str(e)) from e

    def resize_abort(self):
        mgr, ResizeError = self._resize_manager()
        try:
            return mgr.abort().to_json()
        except ResizeError as e:
            raise ApiError(str(e)) from e

    def resize_status(self):
        if self.resize is None or self.resize.job is None:
            return {"job": None}
        return {"job": self.resize.job.to_json()}

    def set_coordinator(self, node_id):
        """(reference: api.SetCoordinator api.go:1221)"""
        if self.cluster is None:
            raise ApiError("not a cluster")
        if self.cluster.node(node_id) is None:
            raise ApiError(f"node not in cluster: {node_id}")
        for n in self.cluster.nodes:
            n.is_coordinator = (n.id == node_id)
        self.cluster.save_topology()
        self._broadcast(MessageType.SET_COORDINATOR, {"id": node_id})
        return {"coordinator": node_id}

    def status(self, include_remote_observability=False):
        """The node's (or the cluster's) state, with the `observability`
        roll-up of this node under its id ("local" on a single node;
        totals only: the full views live at /debug/hbm, /debug/dispatch,
        /debug/device, /debug/workload, /debug/heat and /debug/slo). With
        `include_remote_observability` (?observability=true) a cluster
        coordinator adds every peer's roll-up, fetched with a short
        timeout. A cluster node also reports its fan-out counters under
        `cluster` (`leg_retries`: remote legs re-run on a replica)."""
        if self.cluster is not None:
            state = self.cluster.state
            replica_n = self.cluster.replica_n
            nodes = self.cluster.nodes_json()
        else:
            state, replica_n = "NORMAL", 1
            nodes = [{"id": "local", "uri": {"scheme": "http"},
                      "isCoordinator": True, "state": "READY"}]
        # replicaN lets a --join'ing node inherit the replication factor
        out = {"state": state, "nodes": nodes, "replicaN": replica_n,
               "localShardWidth": SHARD_WIDTH}
        local_id = self.cluster.local_id if self.cluster is not None \
            else "local"
        obs = {local_id: self._node_observability()}
        if include_remote_observability and self.cluster is not None:
            coord = self.cluster.coordinator
            if coord is not None and coord.id == self.cluster.local_id:
                for node in self.cluster.nodes:
                    if node.id == self.cluster.local_id:
                        continue
                    obs[node.id] = self._peer_observability(node)
        out["observability"] = obs
        if self.cluster is not None:
            out["cluster"] = self.executor.stats()
        return out

    def _node_observability(self):
        """Compact local HBM + kernel + plans + device-link + workload
        summary (the TPU package's block)."""
        from ..exec import plan as plan_mod

        local = self.local_executor
        hbm = local.hbm_stats(top=0)
        walls = local._stacked.kernel_walls()
        out = {
            "hbm": {k: hbm[k] for k in (
                "total_bytes", "stack_bytes", "stack_entries",
                "rows_stack_bytes", "rows_stack_entries")},
            "kernels": {
                kind: {"count": v["count"],
                       "seconds": round(v["seconds"], 6)}
                for kind, v in sorted(walls.items())},
            "plans": plan_mod.stats(),
            "device_link": devhealth.summary(),
            "workload": workload_mod.table().summary(),
            "heat": workload_mod.heat().summary(),
            "slo": workload_mod.slo().summary(),
        }
        if self._admission is not None:
            out["admission"] = self._admission.summary()
        if self.oplog is not None:
            out["oplog"] = self.oplog.summary(compact=True)
        if self.spmd is not None:
            # the collective plane's roll-up: serve mode, step lifecycle,
            # stream health, mesh-cache stats (full views at /debug/spmd
            # and /debug/spmd/steps)
            out["spmd"] = self.spmd.summary()
        return out

    #: peer observability fetches must never wedge a /status response
    #: behind a dead node (client default is 30s)
    OBSERVABILITY_PEER_TIMEOUT = 2

    def _peer_observability(self, node):
        """One peer's compact summary via its debug endpoints; failures
        degrade to an error entry instead of failing /status."""
        try:
            client = self.client_factory(node.uri)
            if hasattr(client, "timeout"):
                client.timeout = self.OBSERVABILITY_PEER_TIMEOUT
            hbm = client.debug_hbm(top=0)
            kernels = client.debug_kernels(costs=False).get("kernels", {})
            out = {
                "hbm": {k: hbm.get(k) for k in (
                    "total_bytes", "stack_bytes", "stack_entries",
                    "rows_stack_bytes", "rows_stack_entries")},
                "kernels": {
                    kind: {"count": v.get("count"),
                           "seconds": round(v.get("seconds", 0.0), 6)}
                    for kind, v in sorted(kernels.items())},
            }
            plans = client.debug_plans(limit=0)
            out["plans"] = {k: plans.get(k) for k in
                            ("retained", "misestimates_flagged")}
            # device-link roll-up: the coordinator's /status answers
            # "which node's card is failing" without a per-node login
            dev = client.debug_device(limit=0)
            out["device_link"] = {k: dev.get(k) for k in
                                  ("state", "state_since",
                                   "consecutive_failures", "probes",
                                   "last")}
            op = client.debug_oplog()
            if op.get("enabled"):
                out["oplog"] = {k: op.get(k) for k in
                                ("fsync", "last_lsn", "checkpoint_lsn",
                                 "replay_lag", "unapplied", "segments",
                                 "truncated_tails")}
            # workload observatory roll-up (top=0/1: counters, not
            # rankings — the full views stay on each node's debug
            # endpoints)
            wl = client.debug_workload(top=1)
            out["workload"] = {k: wl.get(k) for k in
                               ("total_queries", "unique_fingerprints",
                                "evicted")}
            top_freq = wl.get("by_frequency") or []
            out["workload"]["top"] = {
                k: top_freq[0].get(k)
                for k in ("fingerprint", "shape", "count")} \
                if top_freq else None
            ht = client.debug_heat(top=0)
            out["heat"] = {
                "tracked": ht.get("tracked"),
                "hot_but_not_resident":
                    ht.get("hot_but_not_resident_total"),
                "resident_but_cold":
                    ht.get("resident_but_cold_total")}
            sl = client.debug_slo()
            out["slo"] = {
                "objectives": len(sl.get("objectives") or []),
                "alerting": [o.get("name")
                             for o in sl.get("objectives") or []
                             if o.get("alerting")],
                "alerts_total": sl.get("alerts_total")}
            adm = client.debug_admission()
            if adm.get("enabled"):
                out["admission"] = {k: adm.get(k) for k in
                                    ("state", "state_age_seconds",
                                     "calibration")}
            sp = client.debug_spmd()
            if sp.get("enabled"):
                out["spmd"] = {
                    "serve_mode": sp.get("serve_mode"),
                    "steps": sp.get("steps"),
                    "stream": sp.get("stream"),
                    "mesh_cache": {
                        k: (sp.get("mesh_cache") or {}).get(k)
                        for k in ("hits", "misses", "entries",
                                  "bytes")},
                }
            return out
        except Exception as e:  # noqa: BLE001 — degraded, not fatal
            return {"error": str(e)}

