"""Anomaly-triggered postmortem bundles — the push half of observability.

The rest of observability (flightrec ring, devhealth prober, dispatch
phase clocks, workload/SLO tables, query profiles) is pull-only: an
operator curls /debug/* AFTER noticing a problem, and the evidence dies
with the process. This module inverts the flow: the existing EDGE
signals

    devhealth_down    device-link prober transitions to DOWN
    watchdog_stall    an in-flight op ran past its watchdog deadline
    collective_stall  the collective plane wedged: a step-stream sequence
                      gap opened (cluster/spmd.py _stream_loop, at ONSET)
                      or a collective step ran past its watchdog deadline
                      (flightrec Watchdog, spmd.* op kinds)
    slo_burn          error-budget burn alert fired (both windows)
    deadline_storm    >= N deadline-expired rejections inside a window
    fatal_signal      SIGTERM / crash-handler chain
    manual            POSTed by an operator or a test

trigger a bundle write: a timestamped directory under --incident-dir
containing the flightrec dump, every thread's stack, the /debug/*
snapshots an operator would have curled (device, dispatch, workload,
heat, slo, fusion, oplog, spmd...), recent query profiles, and the
open-op table.
Bundles are capped (--incident-max, oldest deleted), rate-limited per
trigger kind, and written off-thread (except on the dying-process path).
Served at GET /debug/incidents.

Default path cost: with no manager configured every hook is one module
global check (`maybe_trigger` / `note_deadline_expiry` return
immediately), the same discipline as flightrec/devhealth.
"""

import json
import os
import shutil
import threading
import time

from . import flightrec
from .stats import global_stats

DEFAULT_MAX_INCIDENTS = 16
#: per-kind refractory period — one DOWN flap must not write 50 bundles
DEFAULT_MIN_INTERVAL = 30.0
#: deadline-expiry storm edge: this many rejections inside the window
DEADLINE_STORM_COUNT = 20
DEADLINE_STORM_WINDOW = 10.0

#: cap on any single file returned inline by GET /debug/incidents/{id}
MAX_INLINE_BYTES = 1 << 20


def _json_default(obj):
    return repr(obj)


class IncidentManager:
    """Writes, caps, and serves postmortem bundles for one process."""

    def __init__(self, directory, max_incidents=DEFAULT_MAX_INCIDENTS,
                 min_interval=DEFAULT_MIN_INTERVAL,
                 storm_count=DEADLINE_STORM_COUNT,
                 storm_window=DEADLINE_STORM_WINDOW, logger=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_incidents = int(max_incidents)
        self.min_interval = float(min_interval)
        self.storm_count = int(storm_count)
        self.storm_window = float(storm_window)
        self.logger = logger
        self._lock = threading.Lock()
        self._last_trigger = {}   # kind -> monotonic time of last bundle
        self._storm = []          # monotonic times of deadline expiries
        self._seq = 0
        self._writing = False
        self.written_total = 0
        self.suppressed_total = 0
        self.errors_total = 0
        # collector name -> zero-arg fn returning a JSON-able object;
        # each becomes <name>.json in the bundle. Failures are captured
        # per-collector ({"error": ...}) — one broken surface must not
        # sink the whole autopsy.
        self._collectors = dict(_default_collectors())

    def register_collector(self, name, fn):
        with self._lock:
            self._collectors[str(name)] = fn

    # -- triggers ------------------------------------------------------------

    def trigger(self, kind, sync=False, **tags):
        """Request a bundle for `kind`. Returns the bundle path (sync) or
        the reserved path (async), or None when rate-limited / busy.

        Async by default: collectors walk every /debug surface and the
        write hits disk — none of that belongs on a prober/watchdog/SLO
        thread. `sync=True` is for the dying-process (SIGTERM) path and
        tests."""
        now = time.monotonic()
        with self._lock:
            last = self._last_trigger.get(kind)
            if last is not None and now - last < self.min_interval:
                self.suppressed_total += 1
                return None
            if self._writing:
                self.suppressed_total += 1
                return None
            self._last_trigger[kind] = now
            self._writing = True
            self._seq += 1
            seq = self._seq
        wall = time.time()
        incident_id = "%s-%03d-%s" % (
            time.strftime("%Y%m%dT%H%M%S", time.gmtime(wall)), seq, kind)
        path = os.path.join(self.directory, incident_id)
        flightrec.record("incident.triggered", id=incident_id, trigger=kind,
                         **{k: v for k, v in tags.items()
                            if k != "kind"
                            and isinstance(v, (str, int, float, bool))})
        if sync:
            self._write(incident_id, kind, tags, wall)
            return path
        t = threading.Thread(
            target=self._write, args=(incident_id, kind, tags, wall),
            name="pilosa-incident-writer", daemon=True)
        t.start()
        return path

    def note_deadline_expiry(self):
        """One deadline-expired rejection. A few are client impatience;
        a storm of them inside the window means the server (or the
        device link under it) stopped making progress — edge-trigger a
        bundle then."""
        now = time.monotonic()
        fire = 0
        with self._lock:
            self._storm.append(now)
            cutoff = now - self.storm_window
            while self._storm and self._storm[0] < cutoff:
                self._storm.pop(0)
            if len(self._storm) >= self.storm_count:
                fire = len(self._storm)
                self._storm.clear()
        if fire:
            self.trigger("deadline_storm", count=fire,
                         window_seconds=self.storm_window)

    # -- bundle writer -------------------------------------------------------

    def _write(self, incident_id, kind, tags, wall):
        try:
            self._write_bundle(incident_id, kind, tags, wall)
        except Exception:  # noqa: BLE001 — autopsy must never crash serving
            self.errors_total += 1
            if self.logger is not None:
                try:
                    self.logger.error(
                        "incident bundle %s failed to write", incident_id)
                except Exception:  # noqa: BLE001
                    pass
        finally:
            with self._lock:
                self._writing = False

    def _write_bundle(self, incident_id, kind, tags, wall):
        path = os.path.join(self.directory, incident_id)
        os.makedirs(path, exist_ok=True)
        files = []

        def put(name, payload, text=False):
            try:
                if text:
                    body = payload
                else:
                    body = json.dumps(payload, indent=1, sort_keys=True,
                                      default=_json_default)
            except Exception as e:  # noqa: BLE001 — capture, don't die
                name = name.rsplit(".", 1)[0] + ".json"
                body = json.dumps({"error": repr(e)})
            with open(os.path.join(path, name), "w") as f:
                f.write(body)
            files.append(name)

        put("flightrec.json", flightrec.snapshot(limit=512))
        put("threads.txt", flightrec.format_all_stacks(), text=True)
        with self._lock:
            collectors = list(self._collectors.items())
        for name, fn in collectors:
            try:
                payload = fn()
            except Exception as e:  # noqa: BLE001 — per-collector isolation
                payload = {"error": repr(e)}
            put(f"{name}.json", payload)
        # meta.json is written LAST: its presence marks the bundle
        # complete, so listings never show a half-written directory
        meta = {
            "id": incident_id,
            "kind": kind,
            "t": wall,
            "iso_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime(wall)),
            "pid": os.getpid(),
            "trigger": {k: v for k, v in tags.items()},
            "files": sorted(files),
        }
        put("meta.json", meta)
        self.written_total += 1
        global_stats.count("incidents_written", 1, {"kind": kind})
        flightrec.record("incident.written", id=incident_id, trigger=kind)
        if self.logger is not None:
            try:
                self.logger.error("incident bundle written: %s (%s)",
                                  path, kind)
            except Exception:  # noqa: BLE001
                pass
        self._sweep()

    def _sweep(self):
        """Retention: delete the oldest bundles past max_incidents."""
        entries = sorted(
            e for e in os.listdir(self.directory)
            if os.path.isdir(os.path.join(self.directory, e)))
        for e in entries[:max(0, len(entries) - self.max_incidents)]:
            shutil.rmtree(os.path.join(self.directory, e),
                          ignore_errors=True)

    # -- readers -------------------------------------------------------------

    def list(self):
        """Completed bundles, newest first (GET /debug/incidents)."""
        out = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return out
        for e in sorted(entries, reverse=True):
            meta_path = os.path.join(self.directory, e, "meta.json")
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue  # half-written or foreign directory
            meta["path"] = os.path.join(self.directory, e)
            out.append(meta)
        return out

    def get(self, incident_id):
        """One bundle with file contents inlined (JSON parsed, text
        passed through, each capped at MAX_INLINE_BYTES), or None."""
        if os.sep in incident_id or incident_id in (".", ".."):
            return None
        path = os.path.join(self.directory, incident_id)
        meta_path = os.path.join(path, "meta.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        contents = {}
        for name in meta.get("files", []):
            try:
                with open(os.path.join(path, name)) as f:
                    body = f.read(MAX_INLINE_BYTES)
            except OSError:
                continue
            if name.endswith(".json"):
                try:
                    contents[name] = json.loads(body)
                except ValueError:
                    contents[name] = body
            else:
                contents[name] = body
        meta["path"] = path
        meta["contents"] = contents
        return meta

    def snapshot(self):
        with self._lock:
            stats = {
                "written_total": self.written_total,
                "suppressed_total": self.suppressed_total,
                "errors_total": self.errors_total,
            }
        return {
            "enabled": True,
            "dir": self.directory,
            "max_incidents": self.max_incidents,
            "min_interval_seconds": self.min_interval,
            "deadline_storm": {"count": self.storm_count,
                               "window_seconds": self.storm_window},
            **stats,
            "incidents": self.list(),
        }


def _default_collectors():
    """The /debug surfaces every bundle snapshots. Each import is lazy
    and each call is wrapped by the writer — surfaces that are not
    configured in this process degrade to their 'disabled' snapshot or
    an {"error": ...} stub instead of failing the bundle."""

    def device():
        from . import devhealth
        return devhealth.snapshot(limit=64)

    def dispatch():
        from ..exec.stacked import global_dispatch_phases
        return {"phases": global_dispatch_phases()}

    def workload_():
        from . import workload
        return workload.table().snapshot(top=20)

    def heat():
        from . import workload
        return workload.heat().report(None, top=20)

    def slo():
        from . import workload
        return workload.slo().snapshot()

    def fusion():
        from ..exec import fusion as _fusion
        return _fusion.snapshot()

    def queries():
        from . import profile
        return {"recent": profile.recent()[:16]}

    def open_ops():
        wd = flightrec.get_watchdog()
        return {"watchdog": None if wd is None else wd.open_ops()}

    def traces():
        from . import tracing
        return tracing.trace_index().stats()

    def spmd():
        # the collective plane's observatory: step ring, per-phase tables
        # and (best effort) the cross-node timeline — in EVERY bundle, so
        # a devhealth_down or watchdog_stall autopsy also shows where the
        # collective plane was
        from ..cluster import spmd as spmd_mod
        return spmd_mod.observatory_snapshot()

    return {"device": device, "dispatch": dispatch,
            "workload": workload_, "heat": heat, "slo": slo,
            "fusion": fusion, "queries": queries,
            "open_ops": open_ops, "traces": traces, "spmd": spmd}


# -- module singleton (the flightrec/devhealth pattern) ----------------------

_manager = None


def configure(directory, max_incidents=DEFAULT_MAX_INCIDENTS,
              min_interval=DEFAULT_MIN_INTERVAL,
              storm_count=DEADLINE_STORM_COUNT,
              storm_window=DEADLINE_STORM_WINDOW, logger=None):
    """Install the process incident manager (None/"" directory disables).
    Returns it."""
    global _manager
    if not directory:
        _manager = None
        return None
    _manager = IncidentManager(
        directory, max_incidents=max_incidents, min_interval=min_interval,
        storm_count=storm_count, storm_window=storm_window, logger=logger)
    return _manager


def stop():
    global _manager
    _manager = None


def get_manager():
    return _manager


def maybe_trigger(kind, sync=False, **tags):
    """Producer fast path: one global check when no manager is installed."""
    mgr = _manager
    if mgr is None:
        return None
    try:
        return mgr.trigger(kind, sync=sync, **tags)
    except Exception:  # noqa: BLE001 — never let autopsy break the signal path
        return None


def note_deadline_expiry():
    mgr = _manager
    if mgr is None:
        return
    try:
        mgr.note_deadline_expiry()
    except Exception:  # noqa: BLE001
        pass


def register_collector(name, fn):
    mgr = _manager
    if mgr is not None:
        mgr.register_collector(name, fn)


def snapshot():
    mgr = _manager
    if mgr is None:
        return {"enabled": False,
                "hint": "start the server with --incident-dir to enable "
                        "anomaly-triggered postmortem bundles"}
    return mgr.snapshot()
