"""Device-link health: a continuous canary prober + readiness state.

A wedged card or driver shows first as silence: queries hang, and
nothing in the process can say whether the device is alive. This module
keeps one cheap, continuously-refreshed answer: a background prober
issues tiny canary launches on a jittered interval through the SAME
process-wide dispatch lock as real queries and reads the result back on
the default stream (so a wedged kernel queued before it also wedges the
canary — which is the point: the canary measures the serving path, not a
side channel), keeps a bounded ring of
samples with the pure-RTT vs lock-wait split, and drives a

    LIVE -> DEGRADED -> DOWN

state machine with hysteresis. Transitions emit flight-recorder events
and Prometheus gauges; the full ring is served at `GET /debug/device`;
`/readyz` and the query fail-fast gate read `state()`.

Module-singleton pattern like utils/flightrec.py: `configure()` builds
and starts the prober, `state()`/`snapshot()` read it, `stop()` tears it
down. When never configured, `state()` is DISABLED and the module is
guaranteed to issue ZERO device launches — tools and pure-host tests
import this file without ever touching torch, and a never-configured
prober never initializes CUDA.

A canary that never returns cannot be cancelled (a blocked device call
is not interruptible from Python), so probes run on a dedicated runner
thread: the prober submits a probe and waits up to the deadline. On
timeout the sample is recorded as failed and the runner stays wedged on
the in-flight call; follow-up probe slots are marked failed immediately
("canary still in flight") until the wedged call finally returns — at
which point normal probing resumes and the recovery hysteresis applies.
At most one extra (daemon) thread can be wedged at any time.
"""

import random
import threading
import time

from .stats import global_stats

#: state machine vocabulary; DISABLED means "no prober running" and is
#: deliberately ready (a node without a device link still serves
#: host-side work, and tests/CLI default to no prober).
LIVE = "LIVE"
DEGRADED = "DEGRADED"
DOWN = "DOWN"
DISABLED = "DISABLED"

#: numeric codes for the `device_link_state` gauge (alert rules compare
#: numbers, not strings)
STATE_CODES = {LIVE: 0, DEGRADED: 1, DOWN: 2, DISABLED: -1}

DEFAULT_INTERVAL = 1.0
DEFAULT_DEADLINE = 5.0
DEFAULT_RING = 256

#: the canary's one-element input per device, made at its first probe
_canary_inputs = {}


def default_canary(device="cuda"):
    """One tiny device round trip through the real dispatch path.

    Launches a one-element int32 `x + 1` on `device` under the stacked
    evaluator's process-wide `_DISPATCH_LOCK` (the same serialization
    point every query launch goes through), then reads the result back
    with a blocking `.item()` outside the lock, as the port's queries
    fetch: the read waits for every kernel queued on the stream before
    it. Returns the seconds spent waiting on the lock so the prober can
    split lock contention from pure link RTT. torch is imported here —
    merely importing this module must never load it.
    """
    import torch

    from ..exec import stacked as _stacked

    dev = torch.device(device)
    t0 = time.perf_counter()
    with _stacked._DISPATCH_LOCK:
        t1 = time.perf_counter()
        x = _canary_inputs.get(dev)
        if x is None:
            x = _canary_inputs[dev] = torch.ones(1, dtype=torch.int32,
                                                 device=dev)
        out = x + 1
    if out.item() != 2:
        raise RuntimeError("canary x + 1 did not give 2")
    return t1 - t0


class _CanaryRunner(threading.Thread):
    """Dedicated thread that actually calls the canary, so a hung device
    call wedges THIS thread instead of the prober's control loop."""

    def __init__(self, canary):
        super().__init__(name="devhealth-canary", daemon=True)
        self._canary = canary
        self._go = threading.Event()
        self._stopped = False
        #: set while a canary call is in flight (read by the prober to
        #: mark follow-up probe slots failed without stacking threads)
        self.busy = False
        self.result = None  # (ok, lock_wait_seconds, wall_seconds, err)
        self.done = threading.Event()

    def submit(self):
        self.busy = True
        self.done.clear()
        self._go.set()

    def stop(self):
        self._stopped = True
        self._go.set()

    def run(self):
        while True:
            self._go.wait()
            self._go.clear()
            if self._stopped:
                return
            t0 = time.perf_counter()
            try:
                lock_wait = self._canary()
                ok, err = True, None
            except Exception as e:  # noqa: BLE001 — any failure = link sample
                lock_wait, ok, err = 0.0, False, f"{type(e).__name__}: {e}"
            wall = time.perf_counter() - t0
            self.result = (ok, float(lock_wait or 0.0), wall, err)
            self.busy = False
            self.done.set()


class DeviceLinkProber:
    """Background prober + LIVE/DEGRADED/DOWN state machine."""

    def __init__(self, canary=None, interval=DEFAULT_INTERVAL,
                 deadline=DEFAULT_DEADLINE, ring_size=DEFAULT_RING,
                 degraded_after=1, down_after=3, live_after=2,
                 jitter=0.2, logger=None, device="cuda"):
        """degraded_after/down_after: consecutive canary failures before
        leaving LIVE / entering DOWN. live_after: consecutive successes
        before a degraded or down link is trusted again (hysteresis — one
        lucky probe must not flip a dead tunnel back to ready).
        jitter: +/- fraction applied to every sleep so a fleet of nodes
        doesn't synchronize its probes. device: where the default
        canary launches (the executor's device)."""
        self.canary = canary or (lambda: default_canary(device))
        self.interval = float(interval)
        self.deadline = float(deadline)
        self.degraded_after = max(1, int(degraded_after))
        self.down_after = max(self.degraded_after, int(down_after))
        self.live_after = max(1, int(live_after))
        self.jitter = float(jitter)
        self.logger = logger
        self._ring_size = int(ring_size)
        self._lock = threading.Lock()
        self._ring = []  # newest last, trimmed to ring_size
        self._transitions = []  # last 32 transitions, newest last
        self.state = LIVE
        self.state_since = time.time()
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.probes_total = 0
        self.probes_ok = 0
        self.probes_timeout = 0
        self.probes_error = 0
        self.last_sample = None
        self._last_probe_mono = None
        self._stop = threading.Event()
        self._runner = _CanaryRunner(self.canary)
        self._thread = threading.Thread(
            target=self._loop, name="devhealth-prober", daemon=True)
        self._started = False
        global_stats.gauge("device_link_state", STATE_CODES[self.state])
        global_stats.gauge_fn(
            "device_link_last_probe_age_seconds", self._probe_age)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if not self._started:
            self._started = True
            self._runner.start()
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._runner.stop()
        if self._started:
            self._thread.join(timeout=2)

    # -- probe loop ----------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            self.probe_once()
            sleep = self.interval * (
                1.0 + random.uniform(-self.jitter, self.jitter))
            self._stop.wait(max(0.01, sleep))

    def probe_once(self):
        """One probe slot: submit a canary (unless one is still wedged in
        flight) and judge it against the deadline. Called by the loop;
        tests call it directly for deterministic stepping."""
        self._last_probe_mono = time.monotonic()
        if not self._runner.is_alive():
            # start(start=False) probers stepped by hand still need the
            # runner thread — without it every slot times out
            try:
                self._runner.start()
            except RuntimeError:  # already started and since stopped
                pass
        if self._runner.busy:
            # previous canary still in flight past its deadline: the
            # link is not answering — fail this slot without waiting
            self._record(ok=False, timeout=True, lock_wait=0.0,
                         wall=None, error="canary still in flight")
            return
        self._runner.submit()
        if not self._runner.done.wait(self.deadline):
            self._record(ok=False, timeout=True, lock_wait=0.0,
                         wall=None, error="canary deadline exceeded")
            return
        ok, lock_wait, wall, err = self._runner.result
        self._record(ok=ok, timeout=False, lock_wait=lock_wait,
                     wall=wall, error=err)

    def _record(self, ok, timeout, lock_wait, wall, error):
        sample = {
            "t": round(time.time(), 3),
            "ok": bool(ok),
            "timeout": bool(timeout),
            "rtt_seconds": round(wall, 6) if wall is not None else None,
            "lock_wait_seconds": round(lock_wait, 6),
            "pure_rtt_seconds": (round(max(0.0, wall - lock_wait), 6)
                                 if wall is not None else None),
            "error": error,
        }
        with self._lock:
            self.probes_total += 1
            if ok:
                self.probes_ok += 1
            elif timeout:
                self.probes_timeout += 1
            else:
                self.probes_error += 1
            self.last_sample = sample
            self._ring.append(sample)
            if len(self._ring) > self._ring_size:
                del self._ring[:len(self._ring) - self._ring_size]
        if ok and wall is not None:
            global_stats.timing("device_canary_rtt_seconds", wall)
            global_stats.timing(
                "device_canary_pure_rtt_seconds",
                max(0.0, wall - lock_wait))
            global_stats.gauge("device_link_last_rtt_seconds",
                               round(wall, 6))
        self._advance(ok)
        sample["state"] = self.state

    # -- state machine -------------------------------------------------------

    def _advance(self, ok):
        if ok:
            self.consecutive_failures = 0
            self.consecutive_successes += 1
            if self.state in (DEGRADED, DOWN) \
                    and self.consecutive_successes >= self.live_after:
                self._transition(LIVE)
        else:
            self.consecutive_successes = 0
            self.consecutive_failures += 1
            if self.state == LIVE \
                    and self.consecutive_failures >= self.degraded_after:
                self._transition(DEGRADED)
            if self.state == DEGRADED \
                    and self.consecutive_failures >= self.down_after:
                self._transition(DOWN)

    def _transition(self, new):
        old, self.state = self.state, new
        self.state_since = time.time()
        evt = {
            "t": round(self.state_since, 3),
            "from": old, "to": new,
            "consecutive_failures": self.consecutive_failures,
            "consecutive_successes": self.consecutive_successes,
        }
        with self._lock:
            self._transitions.append(evt)
            del self._transitions[:-32]
        global_stats.gauge("device_link_state", STATE_CODES[new])
        global_stats.count("device_link_transitions", 1,
                           {"from": old, "to": new})
        from . import flightrec as _flightrec

        _flightrec.record("devhealth.transition", **evt)
        if new == DOWN:
            # edge-triggered postmortem: capture the process state the
            # moment the link dies, not when an operator shows up
            from . import incident as _incident

            _incident.maybe_trigger("devhealth_down", **evt)
        if self.logger is not None:
            try:
                self.logger.error(
                    "DEVICE LINK %s -> %s (failures=%d successes=%d)",
                    old, new, self.consecutive_failures,
                    self.consecutive_successes)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    # -- readers -------------------------------------------------------------

    def _probe_age(self):
        if self._last_probe_mono is None:
            return -1.0
        return round(time.monotonic() - self._last_probe_mono, 3)

    def summary(self):
        """Compact roll-up (no ring) for /status observability."""
        with self._lock:
            last = dict(self.last_sample) if self.last_sample else None
        return {
            "state": self.state,
            "state_since": round(self.state_since, 3),
            "consecutive_failures": self.consecutive_failures,
            "consecutive_successes": self.consecutive_successes,
            "interval_seconds": self.interval,
            "deadline_seconds": self.deadline,
            "probes": {
                "total": self.probes_total, "ok": self.probes_ok,
                "timeout": self.probes_timeout,
                "error": self.probes_error,
            },
            "last": last,
        }

    def snapshot(self, limit=None):
        """Full ring + transitions for GET /debug/device."""
        out = self.summary()
        with self._lock:
            ring = list(self._ring)
            out["transitions"] = list(self._transitions)
        if limit is not None and limit >= 0:
            ring = ring[-limit:] if limit else []
        out["ring"] = ring
        out["thresholds"] = {
            "degraded_after": self.degraded_after,
            "down_after": self.down_after,
            "live_after": self.live_after,
        }
        return out


# -- module singleton (the flightrec pattern) --------------------------------

_prober = None
_mod_lock = threading.Lock()


def configure(canary=None, interval=DEFAULT_INTERVAL,
              deadline=DEFAULT_DEADLINE, ring_size=DEFAULT_RING,
              degraded_after=1, down_after=3, live_after=2,
              jitter=0.2, logger=None, start=True, device="cuda"):
    """Build (replacing any previous) and optionally start the process
    prober. Returns it. start=False builds an idle prober for tests that
    step `probe_once()` by hand; `device` is where the default canary
    launches."""
    global _prober
    with _mod_lock:
        if _prober is not None:
            _prober.stop()
        _prober = DeviceLinkProber(
            canary=canary, interval=interval, deadline=deadline,
            ring_size=ring_size, degraded_after=degraded_after,
            down_after=down_after, live_after=live_after,
            jitter=jitter, logger=logger, device=device)
        if start:
            _prober.start()
        return _prober


def get_prober():
    return _prober


def stop():
    global _prober
    with _mod_lock:
        if _prober is not None:
            _prober.stop()
            _prober = None
    global_stats.gauge("device_link_state", STATE_CODES[DISABLED])


def state():
    """Current link state; DISABLED (ready) when no prober runs."""
    p = _prober
    return p.state if p is not None else DISABLED


def is_down():
    p = _prober
    return p is not None and p.state == DOWN


def retry_after_seconds():
    """What a 503 should tell clients: one probe interval from now the
    state machine will have fresh evidence."""
    p = _prober
    return p.interval if p is not None else DEFAULT_INTERVAL


def summary():
    p = _prober
    if p is None:
        return {"state": DISABLED}
    return p.summary()


def snapshot(limit=None):
    p = _prober
    if p is None:
        return {"state": DISABLED, "ring": [], "transitions": []}
    return p.snapshot(limit=limit)
