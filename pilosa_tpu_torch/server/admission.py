"""Cost-aware admission control, deadline propagation, and the
degradation ladder: overload must degrade gracefully (the TPU package's
server/admission.py, copied whole).

It acts on signals the serving substrate already has:

- exec/plan.py's cost model prices a query in device-milliseconds from
  host-side metadata only — zero launches — so admission can charge
  a GroupBy 100x what it charges a Count BEFORE either touches the
  dispatch lock.
- utils/workload.py's SLO burn engine fires `slo.burn_alert` events.
- utils/devhealth.py's prober knows the device link is DOWN long
  before a queued query would find out.

Three mechanisms, one controller:

1. **Classes + token buckets.** Every query lands in one of three
   classes — interactive (default for reads), batch (writes, exports,
   anything header-marked), internal (health/debug traffic) — each
   with its own token bucket holding *device-milliseconds*. A bucket
   refills at `capacity_ms_per_s * share` and is debited the priced
   cost of each admitted query, so one expensive GroupBy cannot starve
   a thousand cheap Counts and a write flood cannot starve reads.
   Estimates are calibrated against measured walls (EWMA) so drifting
   cost-model numbers do not silently over/under-admit.

2. **Bounded per-class wait queue.** A query whose bucket is dry waits
   (FIFO within its class) in front of the dispatch lock — bounded:
   past `queue_depth` waiters the request is rejected immediately with
   503 + Retry-After sized to the bucket's refill deficit. A waiter
   whose deadline lapses in queue is dropped at wake-up — it never
   reaches the dispatch lock (tests pin the stacked dispatch and kernel
   launch counters flat).

3. **Degradation ladder.** NORMAL → SHED_BATCH → STALE_OK → LIFEBOAT,
   driven by the SLO burn engine and devhealth:

       NORMAL      everything admitted per bucket
       SHED_BATCH  batch is queued-only: it waits even when its bucket
                   has tokens, and the ingest engine defers interval
                   merges (overflow still forces one)
       STALE_OK    + reads may serve resident stacks past the ingest
                   staleness bound; responses are marked "stale"
       LIFEBOAT    only internal traffic and interactive *reads*
                   admitted; writes and batch shed outright

   Transitions are edge-triggered into the flight recorder
   (`admission.state`) and exported as the `admission_state` gauge;
   GET /debug/admission serves the full picture.

Default OFF: `--admission off` never constructs a controller, and the
query path's only residue is one `is None` check (the escape-hatch
convention of coalesce-window=0 and ingest-merge-interval=0).
"""

import threading
import time

# ------------------------------------------------------------- classes

INTERACTIVE = "interactive"
BATCH = "batch"
INTERNAL = "internal"
CLASSES = (INTERACTIVE, BATCH, INTERNAL)

# ------------------------------------------------------- ladder states

NORMAL = "NORMAL"
SHED_BATCH = "SHED_BATCH"
STALE_OK = "STALE_OK"
LIFEBOAT = "LIFEBOAT"
STATES = (NORMAL, SHED_BATCH, STALE_OK, LIFEBOAT)
STATE_RANK = {s: i for i, s in enumerate(STATES)}

#: device-milliseconds refilled per wall second with no --admission-
#: capacity override: one device-second of modeled kernel wall per
#: second (the cost model prices in single-device dispatch walls)
DEFAULT_CAPACITY_MS_PER_S = 1000.0
#: per-class slices of that capacity; interactive gets the majority so
#: a write flood can never starve reads (the failure mode that
#: motivates per-class buckets over one global one)
DEFAULT_SHARES = {INTERACTIVE: 0.6, BATCH: 0.3, INTERNAL: 0.1}
#: burst: a bucket holds at most this many seconds of refill, so an
#: idle class can absorb a spike without banking unbounded credit
BURST_SECONDS = 2.0
#: waiters per class past which admission rejects immediately
DEFAULT_QUEUE_DEPTH = 64
#: longest a dry-bucket waiter parks before giving up with 503 (a
#: request deadline shortens it; nothing lengthens it)
DEFAULT_QUEUE_TIMEOUT = 5.0
#: priced cost when the planner errors out mid-estimate — small, so a
#: pricing bug degrades to near-legacy admission, not an outage
FALLBACK_COST_MS = 1.0
#: ladder holds a rung at least this long before stepping DOWN (up is
#: immediate); flapping between NORMAL and SHED_BATCH every sample
#: would churn clients worse than either state
LADDER_HOLD_SECONDS = 10.0
#: ladder re-evaluation cadence on the serving path
LADDER_SAMPLE_INTERVAL = 1.0
#: burn multiples (of the engine's alert threshold) that escalate past
#: SHED_BATCH — see _target_state
STALE_BURN_FACTOR = 2.0
LIFEBOAT_BURN_FACTOR = 4.0


class Rejected(Exception):
    """Admission shed this request (maps to 503 + Retry-After)."""

    def __init__(self, message, retry_after, qclass):
        super().__init__(message)
        self.retry_after = retry_after
        self.qclass = qclass


class Expired(Exception):
    """The request deadline lapsed before dispatch (maps to 504)."""


def parse_deadline(raw, now=None):
    """`X-Request-Deadline` header -> seconds of budget remaining.

    Accepts a bare number (seconds, e.g. "0.25"), a duration with
    units ("250ms", "2s", "1m30s"), or "@<unix-seconds>" for an
    absolute epoch deadline. Returns the remaining budget in seconds —
    zero or negative means expired-on-arrival (the caller answers 504
    without dispatching). Raises ValueError on anything unparseable
    (the caller answers 400)."""
    s = str(raw).strip()
    if not s:
        raise ValueError("empty deadline")
    if s.startswith("@"):
        if now is None:
            now = time.time()
        return float(s[1:]) - now
    try:
        return float(s)
    except ValueError:
        pass
    from ..cli import parse_duration

    return float(parse_duration(s))


def classify(header=None, query=None, path_internal=False):
    """Request class: the `X-Query-Class` header wins when present
    (validated upstream), else PQL shape — writes and exports are
    batch, /debug and health probes internal, reads interactive."""
    if header:
        return header
    if path_internal:
        return INTERNAL
    if query is not None:
        try:
            if any(c.writes() for c in query.calls):
                return BATCH
        except Exception:  # noqa: BLE001 — unparseable shapes default
            pass
    return INTERACTIVE


class TokenBucket:
    """Device-millisecond budget for one class. Not thread-safe on its
    own — the controller's lock covers every call."""

    def __init__(self, rate_ms_per_s, burst_seconds=BURST_SECONDS):
        self.rate = float(rate_ms_per_s)
        self.burst = self.rate * burst_seconds
        self.tokens = self.burst  # start full: no cold-start shedding
        self._at = time.monotonic()

    def refill(self, now):
        self.tokens = min(self.burst,
                          self.tokens + (now - self._at) * self.rate)
        self._at = now

    def try_debit(self, cost_ms, now):
        self.refill(now)
        if self.tokens >= cost_ms:
            self.tokens -= cost_ms
            return True
        return False

    def credit(self, ms):
        """Refund over-charged estimate (never past the burst cap)."""
        self.tokens = min(self.burst, self.tokens + ms)

    def deficit_seconds(self, cost_ms):
        """Refill time until `cost_ms` fits — the honest Retry-After."""
        if self.rate <= 0:
            return DEFAULT_QUEUE_TIMEOUT
        return max(0.0, (cost_ms - self.tokens) / self.rate)


# live controllers (normally one per process) — bench attempt tagging
_REGISTRY = []


def mode():
    """'off' or 'on state=<ladder rung>' — bench attempt tagging:
    serving numbers are only comparable across runs measured under the
    same admission policy and degradation rung."""
    if not _REGISTRY:
        return "off"
    return f"on state={_REGISTRY[0].state}"


class AdmissionController:
    """The QoS gate in front of the executor. One per API; every
    method is thread-safe. See the module docstring for the model."""

    def __init__(self, capacity_ms_per_s=None, shares=None,
                 queue_depth=DEFAULT_QUEUE_DEPTH,
                 queue_timeout=DEFAULT_QUEUE_TIMEOUT, logger=None):
        self.capacity = float(capacity_ms_per_s
                              or DEFAULT_CAPACITY_MS_PER_S)
        self.shares = dict(DEFAULT_SHARES)
        if shares:
            self.shares.update(shares)
        self.queue_depth = int(queue_depth)
        self.queue_timeout = float(queue_timeout)
        self.logger = logger
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.buckets = {
            c: TokenBucket(self.capacity * self.shares[c])
            for c in CLASSES}
        self._waiting = {c: 0 for c in CLASSES}
        self._queue = {c: [] for c in CLASSES}  # ticket FIFO per class
        self._ticket = 0  # monotone ticket numbers, FIFO within a class
        self._closed = False
        # pricing calibration: EWMA of measured_wall / priced_cost for
        # completed queries; multiplies future debits so a cost model
        # that under-prices by 3x doesn't over-admit by 3x
        self._calibration = 1.0
        self._calibration_n = 0
        # ladder
        self.state = NORMAL
        self.state_since = time.monotonic()
        self._ladder_checked = 0.0
        self.transitions = []  # bounded ring of {from,to,reason,at}
        # counters (under _lock)
        self.admitted = {c: 0 for c in CLASSES}
        self.rejected = {c: 0 for c in CLASSES}
        self.queued = {c: 0 for c in CLASSES}
        self.expired = {c: 0 for c in CLASSES}
        self.shed_by_state = {s: 0 for s in STATES}
        from ..utils.stats import global_stats

        global_stats.gauge_fn(
            "admission_state",
            lambda: STATE_RANK.get(self.state, 0))
        _REGISTRY.append(self)

    # -- pricing -----------------------------------------------------------

    def price(self, executor, idx, query, shards, opt):
        """Priced cost of one query in device-milliseconds, from the
        EXPLAIN cost model — host-side metadata only, zero dispatches
        (the planner's contract; tests pin the dispatch-counter delta
        at 0 across a price() call). Any pricing failure degrades to a
        small flat cost rather than failing the query."""
        try:
            from ..exec import plan as plan_mod

            local = getattr(executor, "local", executor)
            nodes = plan_mod.Planner(local).plan_query(
                idx, query.calls, shards, opt)
            wall = 0.0
            for root in nodes:
                for node in root.walk():
                    wall += node.estimate.get("kernel_wall_seconds", 0.0)
            return max(wall * 1000.0, FALLBACK_COST_MS)
        except Exception:  # noqa: BLE001 — pricing must never 500
            return FALLBACK_COST_MS

    # -- admission ---------------------------------------------------------

    def admit(self, qclass, cost_ms, deadline=None, is_write=False,
              now=None):
        """Admit, queue, or shed one request. Returns a ticket (pass it
        to note_done) or raises Rejected / Expired. `deadline` is an
        absolute time.monotonic() instant."""
        if qclass not in CLASSES:
            qclass = INTERACTIVE
        if now is None:
            now = time.monotonic()
        self.maybe_update_ladder(now)
        with self._lock:
            state = self.state
            rank = STATE_RANK[state]
            # ladder gating before any token math: LIFEBOAT serves only
            # internal traffic and interactive reads
            if rank >= STATE_RANK[LIFEBOAT] and (
                    is_write or qclass == BATCH):
                self.rejected[qclass] += 1
                self.shed_by_state[state] += 1
                raise Rejected(
                    f"admission state {state}: only internal and "
                    "interactive reads served", LADDER_HOLD_SECONDS,
                    qclass)
            bucket = self.buckets[qclass]
            # cap the debit at the bucket's burst: a cost above it could
            # never be granted (refill tops out at burst), so without the
            # cap one over-priced — or legitimately huge — request waits
            # out the queue timeout instead of draining the bucket whole
            cost = min(cost_ms * self._calibration, bucket.burst)
            # SHED_BATCH+: batch is queued-only — no immediate grants,
            # even with tokens banked; it parks below and only drains
            # once the ladder steps back down
            queued_only = (qclass == BATCH
                           and rank >= STATE_RANK[SHED_BATCH])
            if not queued_only and bucket.try_debit(cost, now):
                self.admitted[qclass] += 1
                return {"class": qclass, "cost_ms": cost_ms,
                        "debited_ms": cost, "t0": now}
            # dry bucket (or batch under shed): bounded FIFO wait
            if self._waiting[qclass] >= self.queue_depth:
                self.rejected[qclass] += 1
                retry = bucket.deficit_seconds(cost) + 1.0
                raise Rejected(
                    f"admission queue full for class {qclass} "
                    f"({self.queue_depth} waiting)", retry, qclass)
            self._ticket += 1
            my_turn = self._ticket
            self._waiting[qclass] += 1
            self._queue[qclass].append(my_turn)
            self.queued[qclass] += 1
            try:
                give_up = now + self.queue_timeout
                if deadline is not None:
                    give_up = min(give_up, deadline)
                while True:
                    wait_now = time.monotonic()
                    # queue pop: an expired waiter is DROPPED here —
                    # it never reaches the dispatch lock
                    if deadline is not None and wait_now >= deadline:
                        self.expired[qclass] += 1
                        raise Expired(
                            f"deadline lapsed after "
                            f"{wait_now - now:.3f}s in admission queue")
                    if self._closed:
                        raise Rejected("admission controller shut down",
                                       1.0, qclass)
                    state = self.state
                    queued_only = (qclass == BATCH and STATE_RANK[state]
                                   >= STATE_RANK[SHED_BATCH])
                    if not queued_only and self._head_of_class(
                            qclass, my_turn) and bucket.try_debit(
                                cost, wait_now):
                        self.admitted[qclass] += 1
                        return {"class": qclass, "cost_ms": cost_ms,
                                "debited_ms": cost, "t0": now}
                    if wait_now >= give_up:
                        self.rejected[qclass] += 1
                        retry = bucket.deficit_seconds(cost) + 1.0
                        raise Rejected(
                            f"admission wait timed out for class "
                            f"{qclass}", retry, qclass)
                    # wake at the earliest of: refill covers the cost,
                    # give-up, deadline — bounded so a lost notify
                    # can't park a handler forever
                    self._cond.wait(min(
                        0.05 + bucket.deficit_seconds(cost),
                        max(give_up - wait_now, 0.001)))
            finally:
                self._waiting[qclass] -= 1
                self._queue[qclass].remove(my_turn)
                self._cond.notify_all()

    def _head_of_class(self, qclass, my_turn):
        """FIFO within a class: only the oldest live waiter may debit,
        so a lucky late arrival can't starve an earlier one forever.
        Caller holds the lock."""
        q = self._queue[qclass]
        return not q or q[0] == my_turn

    def note_done(self, ticket, wall_seconds):
        """Completion hook: calibrate pricing against the measured
        wall and refund gross over-charges so capacity isn't wasted on
        bad estimates."""
        if ticket is None:
            return
        measured_ms = max(wall_seconds * 1000.0, 0.01)
        with self._lock:
            est = max(ticket.get("cost_ms", FALLBACK_COST_MS), 0.01)
            ratio = min(max(measured_ms / est, 0.01), 100.0)
            # slow EWMA: one wild outlier shouldn't swing admission
            alpha = 0.05
            self._calibration = min(max(
                (1 - alpha) * self._calibration + alpha * ratio,
                0.05), 20.0)
            self._calibration_n += 1
            debited = ticket.get("debited_ms", 0.0)
            if debited > measured_ms:
                self.buckets[ticket["class"]].credit(
                    debited - measured_ms)
            self._cond.notify_all()

    # -- degradation ladder ------------------------------------------------

    def maybe_update_ladder(self, now=None):
        """Re-derive the ladder state from SLO burn + devhealth, rate-
        limited to LADDER_SAMPLE_INTERVAL. Escalation is immediate;
        de-escalation steps one rung per LADDER_HOLD_SECONDS so the
        ladder can't flap with a noisy burn signal."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if now - self._ladder_checked < LADDER_SAMPLE_INTERVAL:
                return self.state
            self._ladder_checked = now
        target, reason = self._target_state()
        with self._lock:
            cur = self.state
            if target == cur:
                return cur
            if STATE_RANK[target] > STATE_RANK[cur]:
                new = target  # escalate straight to the signal's rung
            else:
                if now - self.state_since < LADDER_HOLD_SECONDS:
                    return cur
                new = STATES[STATE_RANK[cur] - 1]  # step down one rung
                reason = f"recovering (target {target})"
            self.state = new
            self.state_since = now
            self.transitions.append({
                "from": cur, "to": new, "reason": reason,
                "at": time.time()})
            del self.transitions[:-50]
            self._cond.notify_all()
        self._record_transition(cur, new, reason)
        return new

    def _target_state(self):
        """(state, reason) the signals currently call for."""
        from ..utils import devhealth
        from ..utils import workload as workload_mod

        if devhealth.is_down():
            return LIFEBOAT, "device link DOWN"
        slo = workload_mod.slo()
        summary = slo.summary()
        alerting = summary.get("alerting") or []
        worst = summary.get("worst_fast_burn", 0.0)
        threshold = getattr(slo, "burn_threshold", 6.0) or 6.0
        if alerting:
            if worst >= threshold * LIFEBOAT_BURN_FACTOR:
                return LIFEBOAT, (
                    f"burn {worst:.1f}x budget "
                    f">= {LIFEBOAT_BURN_FACTOR:g}x threshold")
            if worst >= threshold * STALE_BURN_FACTOR:
                return STALE_OK, (
                    f"burn {worst:.1f}x budget "
                    f">= {STALE_BURN_FACTOR:g}x threshold")
            return SHED_BATCH, (
                "SLO alerting: " + ",".join(map(str, alerting)))
        if devhealth.state() == devhealth.DEGRADED:
            return SHED_BATCH, "device link DEGRADED"
        return NORMAL, "signals nominal"

    def _record_transition(self, old, new, reason):
        from ..utils import flightrec
        from ..utils.stats import global_stats

        flightrec.record("admission.state", from_state=old, to=new,
                         reason=reason)
        global_stats.count("admission_transitions", 1,
                           {"from": old, "to": new})
        if self.logger is not None:
            try:
                self.logger.printf(
                    f"admission: {old} -> {new} ({reason})")
            except Exception:  # noqa: BLE001 — logging is best-effort
                pass

    def serving_stale(self):
        """True when responses should carry the `stale` marker: the
        ladder is at STALE_OK or worse, so reads are served from
        resident stacks while ingest merges are deferred."""
        return STATE_RANK[self.state] >= STATE_RANK[STALE_OK]

    def shed_merges(self):
        """Ingest shed-policy probe: defer interval merges from
        SHED_BATCH up (overflow-forced merges still run — the engine
        distinguishes the wake cause)."""
        return STATE_RANK[self.state] >= STATE_RANK[SHED_BATCH]

    # -- lifecycle / observability -----------------------------------------

    def close(self):
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        try:
            _REGISTRY.remove(self)
        except ValueError:
            pass

    def snapshot(self):
        """GET /debug/admission payload."""
        now = time.monotonic()
        with self._lock:
            classes = {}
            for c in CLASSES:
                b = self.buckets[c]
                b.refill(now)
                classes[c] = {
                    "share": self.shares[c],
                    "rate_ms_per_s": round(b.rate, 3),
                    "tokens_ms": round(b.tokens, 3),
                    "burst_ms": round(b.burst, 3),
                    "admitted": self.admitted[c],
                    "rejected": self.rejected[c],
                    "queued_total": self.queued[c],
                    "expired_dropped": self.expired[c],
                    "waiting_now": self._waiting[c],
                }
            return {
                "enabled": True,
                "state": self.state,
                "state_rank": STATE_RANK[self.state],
                "state_age_seconds": round(now - self.state_since, 3),
                "capacity_ms_per_s": self.capacity,
                "queue_depth": self.queue_depth,
                "queue_timeout_seconds": self.queue_timeout,
                "calibration": round(self._calibration, 4),
                "calibration_samples": self._calibration_n,
                "classes": classes,
                "shed_by_state": dict(self.shed_by_state),
                "transitions": list(self.transitions),
            }

    def summary(self):
        """Compact roll-up for /status observability."""
        with self._lock:
            return {
                "state": self.state,
                "admitted": sum(self.admitted.values()),
                "rejected": sum(self.rejected.values()),
                "expired_dropped": sum(self.expired.values()),
                "waiting_now": sum(self._waiting.values()),
            }
