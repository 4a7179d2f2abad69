"""Shared bounded worker pool for host-side shard work.

Reference: executor.mapReduce fans per-shard work across a bounded worker
pool (executor.go:2455 + shardsByNode). This module is that pool, the
port's copy of the TPU package's:

- `WorkPool.map_ordered(fn, items)` — results in SUBMISSION order, so an
  order-sensitive reduce (Min/Max tie-breaking, MinRow best-tracking)
  over pool results is bit-identical to the serial loop it replaced.
- Fail-fast: the first task error cancels every not-yet-claimed task in
  the job and re-raises on the submitter. In-flight tasks finish (they
  hold locks and device handles the pool cannot safely interrupt).
- `shard_map_reduce(shards, mapper, reducer)` — the per-shard loop shape
  in one place: ordered map, then an ordered host reduce.
- Per-task trace spans: tasks adopt the SUBMITTER's span context, so a
  query profile attributes pool work to the query that submitted it.
- Queue-depth / busy-worker gauges in the global stats registry
  (`workpool_*` at /metrics, snapshot dict at /debug/vars).

Concurrency discipline (load-bearing):

- Workers do host work (per-shard gathers, per-shard evaluation) and
  at most single-shard device ops, safe to issue from many threads.
  Every launch of the stacked path goes through exec/stacked.py's
  process-wide dispatch lock, so the pool parallelizes the work AROUND
  the lock.
- Worker threads NEVER block on the pool: a map_ordered call made from
  inside a worker runs its tasks inline (serially) on that worker.
  Submitters therefore always make progress, nested fan-out cannot
  deadlock a bounded pool, and the thread count stays exactly
  `workers` no matter how deep the call tree.
- `workers=1` (or a single-item job) bypasses the threads entirely and
  runs inline on the caller — byte-for-byte the old serial behavior,
  which the differential tests use as the oracle.

Pool size: `--workers` flag / PILOSA_TPU_WORKERS env, default
min(32, cpu). Threads (not processes) suffice: the gathers are
numpy-copy heavy and numpy releases the GIL in the copies.
"""

import os
import queue
import threading

from . import flightrec, tracing
from .stats import global_stats


def default_workers():
    """min(32, cpu), overridable via PILOSA_TPU_WORKERS (invalid or
    non-positive values fall back to the default rather than crashing
    the server at import time)."""
    env = os.environ.get("PILOSA_TPU_WORKERS")
    if env:
        try:
            n = int(env)
            if n >= 1:
                return n
        except ValueError:
            pass
    return min(32, os.cpu_count() or 1)


class _Job:
    """One map_ordered call: a task vector with ordered results.

    Claim protocol: workers (and nothing else) claim the next unclaimed
    index under the job lock; the first error flips the job into
    cancelled state, so later claims return None and unclaimed tasks
    never run. Completion = every index claimed AND every claimed task
    finished."""

    __slots__ = ("fn", "items", "results", "error", "lock", "next_idx",
                 "in_flight", "cancelled_at", "done", "span")

    def __init__(self, fn, items, span):
        self.fn = fn
        self.items = items
        self.results = [None] * len(items)
        self.error = None
        self.lock = threading.Lock()
        self.next_idx = 0
        self.in_flight = 0
        self.cancelled_at = None  # first index that never ran
        self.done = threading.Event()
        self.span = span  # submitter's trace context

    def claim(self):
        with self.lock:
            if self.error is not None or self.next_idx >= len(self.items):
                return None
            i = self.next_idx
            self.next_idx += 1
            self.in_flight += 1
            return i

    def _finish_locked(self):
        if self.in_flight == 0 and (
                self.error is not None or self.next_idx >= len(self.items)):
            self.done.set()

    def run_one(self, i):
        try:
            r = self.fn(self.items[i])
        except BaseException as exc:  # noqa: BLE001 — re-raised on submitter
            with self.lock:
                if self.error is None:
                    self.error = exc
                    # cancel: unclaimed indices never run
                    self.cancelled_at = self.next_idx
                    self.next_idx = len(self.items)
                self.in_flight -= 1
                self._finish_locked()
            return
        with self.lock:
            self.results[i] = r
            self.in_flight -= 1
            self._finish_locked()


class WorkPool:
    """Bounded pool of daemon worker threads shared by every submitter.

    One instance per process (see get_pool); tests build private
    instances to pin the worker count."""

    def __init__(self, workers=None, name="workpool"):
        self.workers = int(workers) if workers else default_workers()
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        self.name = name
        self._queue = queue.SimpleQueue()
        self._threads = []
        self._threads_lock = threading.Lock()
        self._stop = False
        self._in_worker = threading.local()
        # observability (pushed as gauges; snapshot at /debug/vars)
        self._stats_lock = threading.Lock()
        self._queued_tasks = 0
        self._busy = 0
        self.tasks_total = 0
        self.jobs_total = 0
        self.inline_jobs_total = 0
        self.errors_total = 0
        self._push_gauges()  # register the metrics at zero

    # -- lifecycle -----------------------------------------------------------

    def _ensure_threads(self):
        """Start workers lazily: importing the module (or a workers=1
        pool) must never spawn threads."""
        if self._threads or self.workers <= 1:
            return
        with self._threads_lock:
            if self._threads or self._stop:
                return
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._worker_loop,
                    name=f"pilosa-{self.name}-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    def shutdown(self):
        """Stop the workers (tests; the server relies on daemon exit).
        Workers exit only via the sentinel AFTER finishing any job they
        hold, and jobs that raced into the queue are drained inline here,
        so no submitter can hang on a replaced pool."""
        with self._threads_lock:
            self._stop = True
            threads = list(self._threads)
        for _ in threads:
            self._queue.put(None)
        for t in threads:
            t.join(timeout=5)
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is None:
                continue
            while True:
                i = job.claim()
                if i is None:
                    break
                job.run_one(i)

    # -- gauges --------------------------------------------------------------

    def _push_gauges(self):
        global_stats.gauge("workpool_queue_depth", self._queued_tasks)
        global_stats.gauge("workpool_busy_workers", self._busy)

    def stats(self):
        """Snapshot for /debug/vars."""
        with self._stats_lock:
            return {
                "workers": self.workers,
                "queue_depth": self._queued_tasks,
                "busy_workers": self._busy,
                "tasks": self.tasks_total,
                "jobs": self.jobs_total,
                "inline_jobs": self.inline_jobs_total,
                "errors": self.errors_total,
            }

    # -- execution -----------------------------------------------------------

    def _worker_loop(self):
        self._in_worker.active = True
        while True:
            job = self._queue.get()
            if job is None:  # exit ONLY via sentinel: a popped job is
                return       # always drained, never dropped on shutdown
            while True:
                i = job.claim()
                if i is None:
                    break
                with self._stats_lock:
                    self._queued_tasks -= 1
                    self._busy += 1
                    self._push_gauges()
                try:
                    self._run_traced(job, i)
                finally:
                    with self._stats_lock:
                        self._busy -= 1
                        self._push_gauges()

    def _run_traced(self, job, i):
        """Run one task under the submitter's trace context so profiles
        and traces attribute pool work to the submitting query."""
        if job.span is None:
            job.run_one(i)
            return
        with tracing.with_span(job.span):
            with tracing.start_span(f"{self.name}.task", task=i):
                job.run_one(i)

    def _run_inline(self, fn, items):
        """The workers=1 / nested / single-item path: the exact serial
        loop (no threads, no spans, no counters beyond totals)."""
        with self._stats_lock:
            self.inline_jobs_total += 1
            self.tasks_total += len(items)
        return [fn(item) for item in items]

    def map_ordered(self, fn, items):
        """fn over items on the pool; returns results in ITEM order.
        The first task exception cancels unclaimed tasks and re-raises
        here. Calls from inside a pool worker run inline (see module
        docstring)."""
        items = list(items)
        if self.workers == 1 or len(items) <= 1 \
                or getattr(self._in_worker, "active", False) or self._stop:
            return self._run_inline(fn, items)
        self._ensure_threads()
        job = _Job(fn, items, tracing.current_span())
        with self._stats_lock:
            self.jobs_total += 1
            self.tasks_total += len(items)
            # Saturation: every worker is already busy when more work
            # arrives — the new job queues behind in-flight shards.
            saturated = self._busy >= self.workers and self._queued_tasks > 0
            backlog = self._queued_tasks
            self._queued_tasks += len(items)
            self._push_gauges()
        if saturated:
            flightrec.record("workpool.saturated", pool=self.name,
                             workers=self.workers, backlog=backlog,
                             incoming=len(items))
        for _ in range(min(self.workers, len(items))):
            self._queue.put(job)
        while not job.done.wait(timeout=1.0):
            if self._stop:
                # pool replaced mid-job (configure during serving): the
                # submitter finishes the remaining tasks itself, then
                # waits out whatever is still in flight on old workers
                while True:
                    i = job.claim()
                    if i is None:
                        break
                    job.run_one(i)
                job.done.wait()
                break
        if job.error is not None:
            with self._stats_lock:
                self.errors_total += 1
                # cancelled tasks were counted queued; settle the gauge
                if job.cancelled_at is not None:
                    self._queued_tasks -= len(items) - job.cancelled_at
                    self._push_gauges()
            raise job.error
        return job.results


# ---------------------------------------------------------------- process pool

# Register the gauges at import (zero), so /metrics and /debug/vars show
# them before the first job ever runs.
global_stats.gauge("workpool_queue_depth", 0)
global_stats.gauge("workpool_busy_workers", 0)

_pool = None
_pool_lock = threading.Lock()


def get_pool():
    """The process-shared pool (created on first use)."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = WorkPool()
    return _pool


def configure(workers):
    """Install a process pool of the given size (--workers flag; tests).
    Replaces any existing pool; its workers drain and exit."""
    global _pool
    with _pool_lock:
        old = _pool
        _pool = WorkPool(workers)
    if old is not None:
        old.shutdown()
    return _pool


def worker_count():
    return get_pool().workers


def shard_map_reduce(shards, mapper, reducer=None, initial=None, pool=None):
    """Map `mapper` over `shards` on the shared pool, then reduce the
    results IN SHARD ORDER on the caller: ordered reduction makes
    order-sensitive merges (Min/Max tie-breaks, MinRow best-tracking)
    identical at every worker count — `workers=1` is the oracle the
    differential tests compare against.

    reducer(acc, result) -> acc; None returns the ordered result list.
    """
    results = (pool or get_pool()).map_ordered(mapper, shards)
    if reducer is None:
        return results
    acc = initial
    for r in results:
        acc = reducer(acc, r)
    return acc
