"""Black-box flight recorder + stall watchdog.

The serving path can wedge in ways per-query profiles never see: a
launch or a fetch that never returns leaves only silence. This module is
the always-on, crash-surviving half of observability, the port's copy
of the TPU package's (same event kinds, tags and JSON shapes):

- `FlightRecorder` — a fixed-size, thread-safe ring of structured events
  (timestamp, kind, tags). Producers call the module-level `record()`
  which is a lock + deque append (~µs); when the ring is full the oldest
  event drops and a counter remembers how many were lost. Served at
  `GET /debug/flightrecorder` and dumped to the log on SIGTERM and
  watchdog stalls — the last N things the process did, readable after
  the fact like an aircraft flight recorder.
- `Watchdog` — a registry of in-flight ops (dispatches under the
  process-wide dispatch lock, whole queries) polled by one daemon
  thread. An op running past its deadline trips ONCE: increments the
  `watchdog_stalls` counter, records a `watchdog.stall` event, and dumps
  every thread stack plus the recorder tail to the log.
- `install_crash_handler()` — `faulthandler` for C-level fatal signals
  (SIGSEGV/SIGABRT/...: all thread stacks to stderr even when the
  interpreter is wedged) plus a chained Python SIGTERM handler that logs
  the recorder tail and then runs whatever handler was there before
  (the server's clean stop).
- `start_debug_server()` — a minimal stdlib HTTP server exposing the
  recorder on an ephemeral localhost port, for processes that run no
  PilosaHTTPServer: a supervisor fetches the tail BEFORE killing a hung
  child.

Everything is optional and cheap when off: `configure(0)` disables the
ring (record() becomes one attribute check), and with no watchdog
configured `watch_begin()` returns None without taking a lock.

Event kinds the port records:
  dispatch.*   launches under the dispatch lock (exec/stacked.py)
  batch.*      batched launches and coalescer batches
  cache.*      stack-cache put/evict/invalidate
  workpool.*   pool saturation (every worker busy with a queue backlog)
  oplog.*      write-ahead log rotation, tail truncation, boot replay
  query.slow   queries past --long-query-time
  query.rejected  queries refused before they ran (device link DOWN,
                  request deadline expired)
  http.5xx     handler failures
  watchdog.*   stall trips
  devhealth.transition  device-link state changes (utils/devhealth.py)
  slo.burn_alert  error-budget burn over threshold in BOTH windows
                  (utils/workload.py SloEngine; edge-triggered)
  incident.*   postmortem bundles triggered and written
                (utils/incident.py)
  spmd.*       the collective plane's step lifecycle (cluster/spmd.py):
               step_announce on the coordinator, step_enter/step_exit on
               every process (tags: seq, ok), stream_gap at the ONSET of
               a step-stream sequence gap, stream_resync when the runner
               skips past it, straggler (edge-triggered) when one node's
               phase wall stands out in the merged step timeline
"""

import collections
import faulthandler
import http.server
import itertools
import json
import logging
import signal
import sys
import threading
import time
import traceback

from .stats import global_stats

DEFAULT_RING_SIZE = 2048

_log = logging.getLogger("pilosa_tpu_torch.flightrec")


class FlightRecorder:
    """Fixed-size ring of (seq, ts, kind, tags) events.

    One lock, one deque append per event: cheap enough to leave on in
    the dispatch path (µs vs ms-scale kernels). `size=0` disables —
    producers see `enabled` False and skip the call entirely."""

    def __init__(self, size=DEFAULT_RING_SIZE):
        self.size = int(size)
        self.enabled = self.size > 0
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=self.size or 1)
        self._seq = 0

    def record(self, kind, tags=None):
        if not self.enabled:
            return
        evt = (time.time(), kind, tags or {})
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, ) + evt)

    @property
    def dropped(self):
        with self._lock:
            return self._seq - len(self._events)

    def snapshot(self, limit=None):
        """Events oldest-first as dicts (the exposition format)."""
        with self._lock:
            events = list(self._events)
            total = self._seq
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return {
            "size": self.size,
            "total_events": total,
            "dropped": total - len(self._events) if self.size else total,
            "events": [
                {"seq": seq, "ts": ts, "kind": kind, "tags": tags}
                for seq, ts, kind, tags in events
            ],
        }

    def tail(self, n=64):
        return self.snapshot(limit=n)

    def format_tail(self, n=64):
        """Human-readable tail for log dumps."""
        snap = self.snapshot(limit=n)
        lines = [
            "flight recorder tail (%d/%d events, %d dropped):"
            % (len(snap["events"]), snap["total_events"], snap["dropped"])
        ]
        for e in snap["events"]:
            tags = " ".join(
                f"{k}={v}" for k, v in sorted(e["tags"].items()))
            lines.append("  #%d %.6f %s %s"
                         % (e["seq"], e["ts"], e["kind"], tags))
        return "\n".join(lines)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._seq = 0


# ------------------------------------------------------------- module recorder

_recorder = FlightRecorder()


def get_recorder():
    return _recorder


def configure(size):
    """Install a fresh ring of the given size (0 disables). Returns it."""
    global _recorder
    _recorder = FlightRecorder(size)
    return _recorder


def record(kind, **tags):
    """The producer fast path: one attribute check when disabled."""
    rec = _recorder
    if rec.enabled:
        rec.record(kind, tags)


def snapshot(limit=None):
    return _recorder.snapshot(limit=limit)


def tail(n=64):
    return _recorder.tail(n)


# ------------------------------------------------------------------ stack dump

def format_all_stacks():
    """Every thread's Python stack (same shape as GET /debug/pprof/threads)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append("thread %s (%s):" % (names.get(ident, "?"), ident))
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out)


class _PrintfAdapter:
    """Adapt the repo's printf-style Logger (utils/logger.py) to the
    stdlib error/exception calls used here."""

    def __init__(self, inner):
        self._inner = inner

    def error(self, fmt, *args):
        self._inner.printf(fmt, *args)

    def exception(self, fmt, *args):
        self._inner.printf(fmt + "\n" + traceback.format_exc(), *args)


def _coerce_logger(logger):
    if logger is None:
        return _log
    if hasattr(logger, "error"):
        return logger
    if hasattr(logger, "printf"):
        return _PrintfAdapter(logger)
    return _log


def dump(logger=None, reason="dump"):
    """Recorder tail + all thread stacks to the log, one call."""
    logger = _coerce_logger(logger)
    logger.error("flightrec dump (%s)\n%s\n%s",
                 reason, _recorder.format_tail(), format_all_stacks())


# -------------------------------------------------------------------- watchdog

class _Op:
    __slots__ = ("kind", "start", "deadline", "thread", "tags", "tripped")

    def __init__(self, kind, start, deadline, thread, tags):
        self.kind = kind
        self.start = start
        self.deadline = deadline
        self.thread = thread
        self.tags = tags
        self.tripped = False


class Watchdog:
    """Trips when a registered op (a dispatch holding _DISPATCH_LOCK, a
    whole query) runs past its deadline: counter + event + full dump.

    begin/end are two dict ops under a lock — cheap enough for every
    dispatch. Each op trips at most once; it stays registered so the log
    shows how long past the deadline it eventually ran (or never ended)."""

    def __init__(self, deadline, logger=None, poll_interval=None):
        if deadline <= 0:
            raise ValueError("watchdog deadline must be > 0")
        self.deadline = float(deadline)
        self.logger = _coerce_logger(logger)
        self.poll_interval = poll_interval or min(
            max(self.deadline / 4.0, 0.01), 1.0)
        self.stalls = 0
        self._ops = {}
        self._lock = threading.Lock()
        self._tokens = itertools.count(1)
        self._stop = threading.Event()
        self._thread = None

    # -- op registry ---------------------------------------------------------

    def begin_op(self, kind, deadline=None, **tags):
        op = _Op(kind, time.monotonic(), deadline or self.deadline,
                 threading.current_thread().name, tags)
        token = next(self._tokens)
        with self._lock:
            self._ops[token] = op
        return token

    def end_op(self, token):
        if token is None:
            return
        with self._lock:
            self._ops.pop(token, None)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="pilosa-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- detection -----------------------------------------------------------

    def check(self, now=None):
        """One poll pass; factored out of the loop so tests (and the
        a supervisor) can force a check without waiting for the
        thread. Returns the ops that tripped on THIS pass."""
        now = time.monotonic() if now is None else now
        tripped = []
        with self._lock:
            for op in self._ops.values():
                if not op.tripped and now - op.start > op.deadline:
                    op.tripped = True
                    tripped.append(op)
        for op in tripped:
            self._trip(op, now)
        return tripped

    def _trip(self, op, now):
        self.stalls += 1
        overdue = now - op.start
        tags = {"kind": op.kind}
        global_stats.count("watchdog_stalls", 1, tags)
        # the device-link state splits "stall" into its two causes at a
        # glance: DOWN/DEGRADED = a wedged card, LIVE = lock contention or
        # genuinely slow work (lazy import — devhealth imports stats too)
        from . import devhealth as _devhealth

        link_state = _devhealth.state()
        evt = dict(op.tags, kind=op.kind, thread=op.thread,
                   running_seconds=round(overdue, 3),
                   deadline_seconds=op.deadline,
                   device_link_state=link_state)
        if _recorder.enabled:
            _recorder.record("watchdog.stall", evt)
        self.logger.error(
            "WATCHDOG STALL: op %r on thread %s running %.3fs "
            "(deadline %.3fs) device_link=%s tags=%s\n%s\n%s",
            op.kind, op.thread, overdue, op.deadline, link_state, op.tags,
            _recorder.format_tail(), format_all_stacks())
        from . import incident as _incident

        # evt's "kind" is the stalled OP's kind — rename so it cannot
        # collide with the trigger kind parameter. A wedged collective
        # step (an spmd.* op: entered, never exited past its deadline) is
        # its own incident class: its bundle also carries every peer's
        # step ring through the spmd collector.
        trigger = "collective_stall" if op.kind.startswith("spmd.") \
            else "watchdog_stall"
        _incident.maybe_trigger(
            trigger,
            **{("op" if k == "kind" else k): v for k, v in evt.items()})

    def open_ops(self, now=None):
        """Snapshot of every in-flight op (incident bundles + debug):
        what was holding the dispatch lock / running a query at the
        moment of the anomaly."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ops = list(self._ops.values())
        return [dict(op.tags, kind=op.kind, thread=op.thread,
                     running_seconds=round(now - op.start, 3),
                     deadline_seconds=op.deadline, tripped=op.tripped)
                for op in ops]

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                self.logger.exception("watchdog check failed")


_watchdog = None


def get_watchdog():
    return _watchdog


def configure_watchdog(deadline, logger=None):
    """Install and start the process watchdog (0/None uninstalls)."""
    global _watchdog
    old = _watchdog
    _watchdog = Watchdog(deadline, logger=logger).start() \
        if deadline and deadline > 0 else None
    if old is not None:
        old.stop()
    return _watchdog


def stop_watchdog():
    configure_watchdog(0)


def watch_begin(kind, deadline=None, **tags):
    """Register an in-flight op; None token when no watchdog is running."""
    wd = _watchdog
    if wd is None:
        return None
    return wd.begin_op(kind, deadline=deadline, **tags)


def watch_end(token):
    if token is None:
        return
    wd = _watchdog
    if wd is not None:
        wd.end_op(token)


# --------------------------------------------------------------- crash handler

_crash_installed = False


def install_crash_handler(logger=None):
    """Fatal-signal forensics, installed once per process:

    - `faulthandler.enable()`: C-level handler dumps every thread stack
      to stderr on SIGSEGV/SIGFPE/SIGABRT/SIGBUS/SIGILL — works even
      when the interpreter can't run Python code.
    - a Python SIGTERM handler that logs the recorder tail + stacks,
      then CHAINS to whatever handler was installed before (cli.py owns
      SIGHUP for TLS reload; we must not clobber other handlers).

    Main-thread only (signal.signal requirement); a no-op elsewhere."""
    global _crash_installed
    if _crash_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        faulthandler.enable()
    except Exception:  # noqa: BLE001 — stderr may be closed under tests
        pass

    logger = _coerce_logger(logger)
    prev = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        try:
            dump(logger, reason="SIGTERM")
        except Exception:  # noqa: BLE001 — never mask the shutdown
            pass
        try:
            # synchronous: the process is dying, there is no later
            from . import incident as _incident

            _incident.maybe_trigger("fatal_signal", sync=True,
                                    signal="SIGTERM")
        except Exception:  # noqa: BLE001 — never mask the shutdown
            pass
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_term)
        _crash_installed = True
    except (ValueError, OSError):
        pass


# ---------------------------------------------------------------- debug server

class _DebugHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        if path == "/debug/device":
            # a supervisor reads the prober through this same bare port
            # to diagnose (and fast-abort on) a dead device
            from . import devhealth as _devhealth

            body = json.dumps(_devhealth.snapshot(limit=8)).encode()
        elif path == "/debug/flightrecorder":
            body = json.dumps(snapshot()).encode()
        elif path == "/debug/dispatch":
            # process-wide dispatch-phase aggregate: which phase
            # (lock_wait / dispatch_ack / sync) a wedged process's
            # dispatches were spending in (imports torch on first use)
            from ..exec.stacked import global_dispatch_phases

            body = json.dumps(
                {"phases": global_dispatch_phases()}).encode()
        elif path == "/debug/incidents":
            # the newest postmortem bundle's path for a failed run's
            # record
            from . import incident as _incident

            body = json.dumps(_incident.snapshot()).encode()
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass


def start_debug_server(host="127.0.0.1", port=0):
    """Expose the recorder on a bare localhost HTTP port for processes
    that run no PilosaHTTPServer. Returns the server;
    its bound port is `server.server_address[1]`."""
    srv = http.server.ThreadingHTTPServer((host, port), _DebugHandler)
    srv.daemon_threads = True
    t = threading.Thread(
        target=srv.serve_forever, name="pilosa-flightrec-debug", daemon=True)
    t.start()
    return srv
