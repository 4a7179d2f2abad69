"""Named fault points for crash/fault testing (utils/faultpoints.py).

Production code marks the instants a crash test wants to hit —
``faultpoints.reached("oplog.fsync")`` — and tests arm those names to
raise, delay, or kill the process there. The discipline is the same as
the nop tracer and the disabled device-link prober: when nothing is
armed, the producer hook is ONE module-global check and returns, so the
hot write path pays nothing (verified by a bench_suite gate).

Arming:
  - env: ``PILOSA_TPU_FAULTPOINTS="import.post-append=exit@3;oplog.fsync=delay:0.2"``
    parsed by :func:`configure_from_env` (the server calls it at boot, so
    a crash-matrix harness arms a child before it starts serving);
  - HTTP: ``POST /debug/faultpoints {"arm": "resize.drain.apply=raise"}``
    on a live server (``GET`` lists armed points + hit counts).

Spec grammar: ``name=action[:param][@nth][xTimes]``
  - action ``raise``  -> raise :class:`FaultInjected` (default 1 time);
  - action ``delay``  -> sleep ``param`` seconds (default 0.1, default
    unlimited times — a delay is a slowdown, not a one-shot);
  - action ``exit``   -> ``os._exit(EXIT_CODE)`` — a hard crash: no
    atexit, no finally, no flush. Exactly what a kill -9 test wants.
  - ``@nth``   -> trigger starting at the Nth hit (1-based; default 1),
    so ``exit@5`` crashes under load, not on the first write;
  - ``xTimes`` -> trigger at most that many times (``xinf`` = unlimited).

Well-known point names (grep for ``faultpoints.reached``):
  ``import.post-append``      after the oplog append, before apply/ack
  ``import.pre-ack``          after apply, before the ack returns
  ``oplog.fsync``             inside the oplog, before os.fsync
  ``resize.drain.apply``      before applying one queued resize write
  ``resize.fetch``            before a resize shard fetch (drain timing)
  ``fragment.snapshot.rename``before the snapshot temp->live rename
  ``spmd.gather``             before a collective step's host gather
  ``spmd.launch``             at a collective step's kernel launch
"""

import os
import threading
import time

#: exit status used by the ``exit`` action — distinguishable in a crash
#: harness from an ordinary interpreter death
EXIT_CODE = 86

ENV_VAR = "PILOSA_TPU_FAULTPOINTS"


class FaultInjected(Exception):
    """Raised at an armed ``raise`` fault point."""


#: "no explicit xTimes suffix" marker — distinct from None (= unlimited)
_UNSET = object()


class _Spec:
    __slots__ = ("name", "action", "param", "nth", "times", "hits", "fired")

    def __init__(self, name, action, param=None, nth=1, times=_UNSET):
        if action not in ("raise", "delay", "exit"):
            raise ValueError(f"unknown fault action: {action!r}")
        self.name = name
        self.action = action
        self.param = param
        self.nth = max(1, int(nth))
        # raise/exit default to one-shot; a delay is a slowdown and
        # defaults to every hit
        if times is _UNSET:
            times = None if action == "delay" else 1
        self.times = times  # None = unlimited
        self.hits = 0
        self.fired = 0

    def to_json(self):
        return {"name": self.name, "action": self.action,
                "param": self.param, "nth": self.nth,
                "times": self.times, "hits": self.hits,
                "fired": self.fired}


_lock = threading.Lock()
_specs = {}
#: fast-path flag — `reached()` checks ONLY this when nothing is armed
_armed = False


def parse_spec(text):
    """``name=action[:param][@nth][xTimes]`` -> :class:`_Spec`."""
    text = text.strip()
    name, sep, rhs = text.partition("=")
    if not sep or not name or not rhs:
        raise ValueError(f"invalid fault spec: {text!r}")
    times = _UNSET
    if "x" in rhs:
        # only a real ``xN``/``xinf`` suffix — the action ``exit``
        # contains an 'x' of its own
        head, _, t = rhs.rpartition("x")
        if t.isdigit() or t.lower() == "inf":
            rhs = head
            times = None if t.lower() == "inf" else int(t)
    nth = 1
    if "@" in rhs:
        rhs, _, n = rhs.partition("@")
        nth = int(n)
    action, _, param = rhs.partition(":")
    parsed = None
    if param:
        parsed = float(param)
    elif action == "delay":
        parsed = 0.1
    return _Spec(name.strip(), action.strip(), param=parsed,
                 nth=nth, times=times)


def arm(spec_text):
    """Arm one fault point from its spec string; re-arming a name
    replaces its spec (hit counters restart)."""
    global _armed
    spec = parse_spec(spec_text)
    with _lock:
        _specs[spec.name] = spec
        _armed = True
    return spec


def disarm(name=None):
    """Disarm one point, or every point when name is None."""
    global _armed
    with _lock:
        if name is None:
            _specs.clear()
        else:
            _specs.pop(name, None)
        _armed = bool(_specs)


def configure_from_env(environ=None):
    """Arm every ``;``-separated spec in $PILOSA_TPU_FAULTPOINTS. Called
    by the server at boot so subprocess crash harnesses arm points the
    child reaches before HTTP is up (boot replay, fragment open)."""
    raw = (environ if environ is not None else os.environ).get(ENV_VAR, "")
    specs = [s for s in raw.split(";") if s.strip()]
    for s in specs:
        arm(s)
    return len(specs)


def reached(name):
    """Producer hook. Unarmed: one global check, nothing else — safe to
    leave on the hottest write path."""
    if not _armed:
        return
    _fire(name)


def _fire(name):
    with _lock:
        spec = _specs.get(name)
        if spec is None:
            return
        spec.hits += 1
        if spec.hits < spec.nth:
            return
        if spec.times is not None and spec.fired >= spec.times:
            return
        spec.fired += 1
        action, param = spec.action, spec.param
    # act OUTSIDE the lock: a delay must not serialize unrelated points,
    # and a raise must not leave the registry wedged
    if action == "delay":
        time.sleep(param)
    elif action == "exit":
        os._exit(EXIT_CODE)
    else:
        raise FaultInjected(f"fault point triggered: {name}")


def armed():
    return _armed


def snapshot():
    """State for GET /debug/faultpoints."""
    with _lock:
        return {"armed": _armed,
                "points": [s.to_json() for s in _specs.values()]}
