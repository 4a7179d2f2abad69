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
stale from STALE_OK up."""

import array
import base64
import contextlib
import csv
import io
import random
import threading
import time

import numpy as np

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
    """Holds the holder and the port's Executor on `device`, the query
    coalescer when `coalesce_window` > 0, and the write-ahead oplog when
    one is given."""

    def __init__(self, holder, device=None, coalesce_window=0.0,
                 coalesce_max_queue=256, max_writes_per_request=0,
                 oplog=None, logger=None, long_query_time=None,
                 ingest_interval=0.0, ingest_max_rows=None,
                 ingest_max_bytes=None, admission="off",
                 admission_capacity=None, admission_queue_depth=None,
                 admission_queue_timeout=None):
        from ..utils.logger import StandardLogger

        self.holder = holder
        self.executor = Executor(
            holder, device=device,
            max_writes_per_request=max_writes_per_request)
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
        self.logger = logger if logger is not None else StandardLogger()
        # slow-query threshold in seconds (reference: long-query-time);
        # None disables the log and the profiling it implies
        self.long_query_time = long_query_time
        # window 0 — the default — builds no coalescer: every query takes
        # the per-query path
        self.coalesce_window = float(coalesce_window or 0.0)
        self.coalesce_max_queue = int(coalesce_max_queue)
        self._coalescer = None
        if self.coalesce_window > 0:
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

    @property
    def device(self):
        return self.executor.device

    def batch_executor(self):
        """The executor the coalescer drains into."""
        return self.executor

    def query(self, index_name, pql, shards=None, options=None,
              deadline=None, query_class=None):
        """(reference: api.Query api.go:135)

        `deadline` — absolute time.monotonic() instant parsed from
        `X-Request-Deadline` at the HTTP edge (None = unbounded); checked
        here, at admission queue pop and before each launch.
        `query_class` — the validated `X-Query-Class` header value (None
        = classify from the PQL shape)."""
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
            raise ApiError(str(e)) from e
        finally:
            flightrec.watch_end(wtoken)
            if prof is not None:
                prof.finish()
        self._log_slow_query(index_name, pql, time.monotonic() - t0, prof)
        # SLO tick: with objectives configured, serving traffic alone
        # keeps burn rates fresh and fires alerts (rate-limited inside)
        workload_mod.maybe_sample_slo()
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

    def debug_trace(self, trace_id):
        """GET /debug/traces/{trace_id}: this node's spans of one trace
        (the per-node trace index plus the InMemoryTracer ring when one
        is installed) and their tree. Peers' spans join with the cluster
        layer."""
        local = tracing.get_trace(trace_id)
        tracer = tracing.get_tracer()
        if hasattr(tracer, "to_dicts"):
            seen = {s["spanID"] for s in local}
            local += [s for s in tracer.to_dicts()
                      if s.get("traceID") == trace_id
                      and s.get("spanID") not in seen]
        return {"traceID": trace_id, "found": bool(local),
                "spans": local, "tree": tracing.assemble_tree(local)}

    def query_batch(self, index_name, pqls, shards=None):
        """Execute a list of PQL queries as batched launches (the POST
        /index/{i}/query-batch route, the coalescer's executor path).
        Returns (results, error, batch_size) per query in request order —
        per-query error isolation, like the coalescer's."""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        if devhealth.is_down():
            retry = devhealth.retry_after_seconds()
            raise ServiceUnavailableError(
                "device link DOWN (canary probes failing); "
                f"retry in {retry:.0f}s", retry_after=retry)
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
        st = self.executor.stacked_stats()
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

    def create_index(self, name, options=None):
        from ..core.holder import HolderError
        from ..core.index import IndexError_

        try:
            return self.holder.create_index(name, options=options)
        except HolderError as e:
            raise ConflictError(str(e)) from e
        except IndexError_ as e:
            raise ApiError(str(e)) from e

    def delete_index(self, name):
        """(reference: api.DeleteIndex, single node). Device stacks of the
        deleted index stay in their pools until evicted; a re-created
        index never reads them, as its fragments' uids differ."""
        from ..core.holder import HolderError

        try:
            self.holder.delete_index(name)
        except HolderError as e:
            raise NotFoundError(str(e)) from e

    def create_field(self, index_name, field_name, options=None):
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            return idx.create_field(field_name, options=options)
        except IndexError_ as e:
            if "already exists" in str(e):
                raise ConflictError(str(e)) from e
            raise ApiError(str(e)) from e

    def delete_field(self, index_name, field_name):
        """(reference: api.DeleteField, single node)"""
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            idx.delete_field(field_name)
        except IndexError_ as e:
            raise NotFoundError(str(e)) from e

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

    def import_bits(self, index_name, field_name, row_ids, column_ids,
                    timestamps=None, clear=False, remote=False,
                    row_keys=None, column_keys=None):
        """(reference: api.Import api.go:920, single node; string keys
        translate to ids first). The record reaches the oplog before the
        apply, with the keys as given; `remote` is carried for the TPU
        package's record shape and means nothing on one node."""
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
        try:
            if row_keys is not None or column_keys is not None:
                t_rows, t_cols = self._translate_import_keys(
                    index_name, field_name, row_keys, column_keys)
                if t_rows is not None:
                    row_ids = t_rows
                if t_cols is not None:
                    column_ids = t_cols
            changed = field.import_bits(
                row_ids, column_ids, timestamps=timestamps, clear=clear)
            # the columns exist after a clear import too, as in the TPU
            # package (a cleared bit is still a column that was written)
            self.holder.index(index_name).add_existence(column_ids)
            if self.ingest is not None:
                self._ingest_record(
                    index_name, field,
                    self._ingest_shard_rows(column_ids),
                    16 * len(column_ids))
            faultpoints.reached("import.pre-ack")
            return changed
        finally:
            # an exception here means NO ack went out, so the record
            # needs no replay guarantee — mark it applied either way so
            # one failed import can't pin the checkpoint watermark
            # forever (a process crash skips this; that's the point)
            self._oplog_applied_or_defer(lsn)

    def import_values(self, index_name, field_name, column_ids, values,
                      remote=False, column_keys=None, clear=False):
        """Bulk BSI values (reference: api.ImportValue api.go:1035, single
        node). clear=True removes the listed columns' values."""
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
        try:
            if column_keys is not None:
                _, column_ids = self._translate_import_keys(
                    index_name, field_name, None, column_keys)
            changed = field.import_values(column_ids, values, clear=clear)
            if not clear:
                self.holder.index(index_name).add_existence(column_ids)
            if self.ingest is not None:
                self._ingest_record(
                    index_name, field,
                    self._ingest_shard_rows(column_ids),
                    16 * len(column_ids), existence=not clear)
            faultpoints.reached("import.pre-ack")
            return changed
        finally:
            self._oplog_applied_or_defer(lsn)

    def import_roaring(self, index_name, field_name, shard, data,
                       clear=False, view="standard", remote=False):
        """Merge a serialized roaring blob of row * SHARD_WIDTH + offset
        positions into one shard of one view (reference: api.ImportRoaring
        api.go:368, single node). Returns the number of bits changed."""
        field = self._field(index_name, field_name)
        shard = int(shard)
        self._ingest_admit(1, len(data))
        lsn = self._oplog_append("roaring", dict(
            index_name=index_name, field_name=field_name, shard=shard,
            data=data, clear=clear, view=view, remote=remote))
        faultpoints.reached("import.post-append")
        try:
            v = field.create_view_if_not_exists(view)
            frag = v.create_fragment_if_not_exists(shard)
            changed = frag.import_roaring(data, clear=clear)
            if self.ingest is not None:
                self._ingest_record(
                    index_name, field, {shard: 1}, len(data),
                    existence=False)
            faultpoints.reached("import.pre-ack")
            return changed
        finally:
            self._oplog_applied_or_defer(lsn)

    # -- durable oplog (storage/oplog.py) ------------------------------------

    def _oplog_append(self, kind, kwargs):
        """Append one import's record BEFORE any apply/ack step; returns
        its LSN (None when no oplog is attached). A boot replay
        re-entering the import path reuses the original record's LSN
        instead of re-appending."""
        if self.oplog is None:
            return None
        replay_lsn = getattr(self._oplog_tls, "replay_lsn", None)
        if replay_lsn is not None:
            return replay_lsn
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
        TopN rank cache."""
        self.holder.recalculate_caches()

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
        return [{"id": "local", "isCoordinator": True}]

    # -- node internals: backup, export and restore read fragments here ------

    def index_shards(self, index_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        return {"shards": idx.available_shards()}

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

    def status(self):
        """The node's state, with the `observability` roll-up of this
        node under "local" (totals only: the full views live at
        /debug/hbm, /debug/dispatch, /debug/device, /debug/workload,
        /debug/heat and /debug/slo)."""
        nodes = [{"id": "local", "uri": {"scheme": "http"},
                  "isCoordinator": True, "state": "READY"}]
        return {"state": "NORMAL", "nodes": nodes, "replicaN": 1,
                "localShardWidth": SHARD_WIDTH,
                "observability": {"local": self._node_observability()}}

    def _node_observability(self):
        """Compact local HBM + kernel + plans + device-link + workload
        summary (the TPU package's block)."""
        from ..exec import plan as plan_mod

        hbm = self.executor.hbm_stats(top=0)
        walls = self.executor._stacked.kernel_walls()
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
        return out

