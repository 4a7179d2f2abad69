"""The collective data plane: cross-node query merge over torch.distributed.

The reference merges cross-node partials over HTTP (executor.remoteExec
executor.go:2414). The TPU package replaces that data plane with one
global JAX distributed system: each leaf is a globally sharded array and
one jitted program runs on every process, XLA inserting the all-reduce.
The port joins every server process into ONE `torch.distributed` process
group (gloo, the control group), and each of those programs becomes two
things on every rank: a launch of the port's hand-written kernel over
the rank's own shards (K1 count_expr for a Count, K3 row_counts for Sum
and TopN, K4 pairwise_counts for GroupBy; Min/Max walks as the single
node does, its count with K3), and the collective of the int64 partials.
At boot the ranks exchange their cards' identities over gloo; when every
rank has a card of its own they form an NCCL data group
(`parallel.sharded.collective_backend`), and a step's collective takes
two phases: a vote of the failure and step slots over gloo, then, only
when the vote is clean, the partials reduced (Min/Max: gathered) on the
cards over NCCL and fetched once. A rank whose card failed never enters
an NCCL collective: it would wedge the others until NCCL's watchdog
tore their processes down. Ranks on the CPU, or sharing a card (NCCL
refuses two ranks on one), reduce host partials over gloo in ONE
collective that carries the slots too.
The Count, Sum, TopN and GroupBy kernels and their all_reduce are
`parallel.sharded.ShardedQueryEngine`'s, one engine per rank.
Covered merges: Count, Sum, Min/Max, TopN, GroupBy.

HTTP stays the CONTROL plane: the cluster coordinator announces each step
with POST /internal/spmd/step, every process (the coordinator included)
runs the step, and the reduced result is read locally — no result bytes
cross HTTP.

Execution model:
- Only the coordinator initiates steps, serialized under `_lock`; peers
  run them on their HTTP handler thread under the same per-process lock.
  With one initiator every process issues its collectives in the same
  order — what the group needs to match them. Nothing else in the
  process uses the group.
- A query at a NON-coordinator forwards the eligible call to the
  coordinator in one hop (POST /internal/spmd/initiate).
- Steps carry a fully resolved plan (operator signature + leaf list,
  candidate rows, bit depth); peers re-derive nothing. Anything missing
  locally gathers as zero planes (count-neutral), and every local
  failure, a gather's included, still enters the collective: the reduced
  vector carries one failure slot per node. A rank whose card failed
  (`cuda_build.is_device_failure`) reports 1 there, so every rank learns
  of it in the same collective, nobody wedges, and the query fails with
  a 500 that names the node (trap 30) — it is never hidden behind an HTTP
  fallback. Any other local failure reports 2, and the coordinator falls
  back to the HTTP merge, as the TPU package's watchdog does.
- Steps are gated on every node being READY and the membership being the
  one the group was formed with; otherwise the call takes the HTTP path.

- gloo matches collectives by call order, not by step. Every reduced
  vector therefore also carries one slot per node with the step number
  that rank ran (on NCCL, the vote does); a rank that finds the slots
  unequal raises on every rank (a non-card failure: the coordinator
  falls back to HTTP), so two different steps are never summed into one
  answer. The Min/Max all_gather rows carry the same number.

Serve modes (`--spmd-serve`, switched at run time by POST /debug/spmd):
- `off` (the default): every step gathers its leaves from the host
  fragments and uploads them, and peers run steps on their HTTP handler
  thread, announced by a blocking POST /internal/spmd/step.
- `on`: mesh-resident serving. Each rank keeps its own [seg_len, W]
  block of each plan leaf on its device (cluster/meshstacks.py),
  validated by fragment generations, so a warm step touches no host
  fragment. Steps are announced over the step STREAM (POST
  /internal/spmd/stream): a peer enqueues by sequence number and acks at
  once, and its stream runner thread runs the steps in order. The
  coalescer's Count batches (SpmdBatchRunner) and whole multi-Count
  queries (maybe_execute_fused) each run as ONE step: ONE K1 launch a
  rank (its batched entry for one signature, its multi-tree entry for
  mixed ones) and one all_reduce of the [K] counts.
- `shadow`: serves as `off`, and probes the mesh cache with each fresh
  gather to detect divergence.
- `http` (run time only): every call takes the HTTP merge, for A/B runs
  on one cluster.

The observatory: every step runs under a phase clock whose phases sum
exactly to the step wall, and lands in a bounded ring; GET
/debug/spmd/steps merges every node's ring into one skew-corrected
timeline with per-phase straggler attribution.

Nothing here imports torch at module import; `torch.distributed` is
imported only to form the group and to reduce (trap 19).
"""

import itertools
import statistics
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager

import numpy as np

from ..core.view import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD
from ..pql import Call, call_to_pql, parse
from ..shardwidth import WORDS_PER_ROW
from ..utils.logger import NopLogger

#: the kernel wrappers a step may launch, by their launch-counter names
STEP_KERNELS = ("count_expr", "row_counts", "pairwise_counts", "bsi_range",
                "count_expr_batch", "count_expr_multi")


def _launches():
    """{kernel: launches so far in this process} of STEP_KERNELS."""
    from ..ops.bsi_range import bsi_range_mask
    from ..ops.count_expr import (count_expr, count_expr_batch,
                                  count_expr_multi)
    from ..ops.pairwise import pairwise_counts
    from ..ops.row_counts import row_counts

    return {"count_expr": count_expr.launches,
            "row_counts": row_counts.launches,
            "pairwise_counts": pairwise_counts.launches,
            "bsi_range": bsi_range_mask.launches,
            "count_expr_batch": count_expr_batch.launches,
            "count_expr_multi": count_expr_multi.launches}


class SpmdError(Exception):
    pass


class SpmdDeviceFailure(RuntimeError):
    """A collective step failed on a rank's card. The text carries "CUDA
    error", so `cuda_build.is_device_failure` holds for it wherever it
    propagates (trap 30)."""


# -- plan wire encoding -------------------------------------------------------

def sig_to_wire(sig):
    """Operator signature -> JSON-able nested lists (steps carry the plan
    so every process evaluates the IDENTICAL program)."""
    if sig is None:
        return None
    if sig[0] == "leaf":
        return ["leaf", sig[1]]
    op, subs = sig
    return [op, [sig_to_wire(s) for s in subs]]


def sig_from_wire(wire):
    if wire is None:
        return None
    if wire[0] == "leaf":
        return ("leaf", int(wire[1]))
    return (wire[0], tuple(sig_from_wire(s) for s in wire[1]))


# -- step phases --------------------------------------------------------------

#: step-phase taxonomy (the spmd.step span's `phases_ms`): announce_recv —
#: announcement receipt to step entry (the step-lock wait on peers, the
#: announcement fan-out on the coordinator); stack_gather — host fragment
#: gathers (and condition leaves evaluated per shard); upload — the
#: host-to-device copies; device_enter — the kernel launches and the wait
#: for them; result_fetch — the partial's device-to-host copy; psum — the
#: collective; exit — residual (decode and bookkeeping), so the phases
#: sum EXACTLY to the step wall. On an NCCL data group the partial is
#: reduced on the card before it is fetched: psum (the vote and the data
#: collective) then comes before result_fetch.
STEP_PHASES = ("announce_recv", "stack_gather", "upload", "device_enter",
               "result_fetch", "psum", "exit")

#: failure-slot codes: the card failed / any other local failure
FAIL_DEVICE = 1
FAIL_OTHER = 2


def combine_minmax(parts, is_max):
    """The global Min/Max from each rank's (non-empty, negative,
    magnitude, count): the extreme over the non-empty ranks, compared as
    (value, not negative) so -0 sorts below +0 as the reference's sign
    rules order them (Max: highest positive, else closest-to-zero
    negative; Min: most negative, else lowest positive), with the count
    summed over the ranks at it. Returns (empty, negative, magnitude,
    count)."""
    parts = [p for p in parts if p[0]]
    if not parts:
        return True, False, 0, 0

    def key(p):
        return (-p[2] if p[1] else p[2], 0 if p[1] else 1)

    best = (max if is_max else min)(key(p) for p in parts)
    return (False, best[1] == 0, abs(best[0]),
            sum(p[3] for p in parts if key(p) == best))


class _StepClock:
    """Phase marks within one collective step: `mark(phase)` attributes
    the time since the previous mark (or the announcement receipt) to
    `phase`; `close()` folds any residual into the terminal phase so the
    per-phase seconds sum exactly to the step wall."""

    __slots__ = ("t0", "_t", "phases")

    def __init__(self, t0=None):
        now = time.perf_counter()
        self.t0 = self._t = now if t0 is None else t0
        self.phases = []

    def mark(self, phase):
        now = time.perf_counter()
        self.phases.append([phase, now - self._t])
        self._t = now

    def close(self, phase="exit"):
        """Fold the residual into `phase` and return the step wall."""
        self.mark(phase)
        return self._t - self.t0


def envelope_skew(t_send, t_recv, remote_now):
    """NTP-style clock-offset estimate (remote - local, seconds) from one
    RPC envelope: the peer stamped `remote_now` (its wall clock) while
    handling a request sent at local wall time `t_send` and answered at
    `t_recv`. Assuming symmetric network delay (tracing.estimate_skew's
    assumption), the remote stamp corresponds to the local midpoint."""
    return remote_now - (t_send + t_recv) / 2.0


def attribute_stragglers(peers_phases, factor, noise_floor):
    """Per-phase straggler attribution for ONE step's merged per-peer
    phase walls. `peers_phases`: {node_id: {phase: seconds}}. A node is
    the phase's straggler when its wall is the slowest AND exceeds the
    median of the OTHER peers by `factor` (excluding the candidate: on a
    2-node group a median over both would dilute the straggler's own wall
    into the baseline) AND by more than `noise_floor` seconds in absolute
    terms (so microsecond jitter between healthy peers never flags).
    Returns [{phase, node, seconds, median_seconds, ratio}]."""
    flags = []
    phases = set()
    for ph in peers_phases.values():
        phases.update(ph)
    for phase in sorted(phases):
        walls = {node: ph[phase] for node, ph in peers_phases.items()
                 if phase in ph}
        if len(walls) < 2:
            continue
        worst_node = max(walls, key=walls.get)
        worst = walls[worst_node]
        med = statistics.median(v for n, v in walls.items()
                                if n != worst_node)
        if worst > med * factor and worst - med > noise_floor:
            flags.append({
                "phase": phase,
                "node": worst_node,
                "seconds": round(worst, 6),
                "median_seconds": round(med, 6),
                "ratio": round(worst / med, 2) if med > 0 else None,
            })
    return flags


#: the serving process's data plane (set by the server command): what the
#: incident bundles' `spmd` collector snapshots into EVERY bundle without
#: holding an instance handle (utils/incident.py)
_active_plane = None


def set_active_plane(plane):
    global _active_plane
    _active_plane = plane
    return plane


def active_plane():
    return _active_plane


def observatory_snapshot():
    """Incident-bundle collector payload: the active plane's observatory
    state (step ring, phase tables and a best-effort cross-node
    timeline), or the disabled stub."""
    plane = _active_plane
    if plane is None:
        return {"enabled": False}
    try:
        return dict(plane.incident_snapshot(), enabled=True)
    except Exception as e:  # noqa: BLE001 — never fail the bundle
        return {"enabled": True, "error": str(e)}


class SpmdDataPlane:
    #: process-wide: the group is formed once per process
    _initialized = False

    #: seconds a step announcement, and a collective, may block (gloo's
    #: own default is 30 minutes)
    STEP_TIMEOUT = 300
    #: seconds for the cheap pre-flight validation round
    VALIDATE_TIMEOUT = 5
    #: candidate-row cap for a TopN step; larger sets take the HTTP path
    TOPN_MAX_ROWS = 4096
    #: group-cell cap for a GroupBy step
    GROUPBY_MAX_CELLS = 4096
    #: program-table cache bound of the batch and fused steps
    MAX_FNS = 128
    #: serve modes settable at run time (POST /debug/spmd). "http" is run
    #: time only: maybe_execute declines, so the SAME cluster can run the
    #: HTTP fan-out for an A/B comparison.
    SERVE_MODES = ("off", "on", "shadow", "http")
    #: seconds a peer's stream runner waits on a sequence gap before
    #: resyncing to the lowest queued step (a lost announcement must not
    #: wedge the stream; the coordinator's collective for the lost step
    #: fails at the group's timeout and falls back)
    STREAM_GAP_TIMEOUT = 30
    #: bounded per-node step ring: the most recent steps with per-phase
    #: walls, what GET /debug/spmd/steps merges across nodes
    STEP_RING_SIZE = 256
    #: a node is a phase's straggler when its wall exceeds the peer median
    #: by this factor AND by STRAGGLER_NOISE_FLOOR seconds (2x of a 50 us
    #: gather is jitter, not a straggler)
    STRAGGLER_FACTOR = 2.0
    STRAGGLER_NOISE_FLOOR = 0.025
    #: edge-trigger memory: (seq, node, phase) keys already counted, so
    #: repeated scrapes of the same ring don't re-fire (bounded FIFO)
    STRAGGLER_FLAGS_MAX = 1024

    #: process-wide: the NCCL data group when every rank has a card of
    #: its own (None: the data collectives ride the gloo group), and its
    #: backend's name
    _data_group = None
    _backend = "gloo"

    @classmethod
    def initialize(cls, coordinator_address, num_processes, process_id,
                   cpu_collectives=None, device=None):
        """Join the process group: gloo, its TCP store on
        `coordinator_address` (host:port, served by rank 0), the timeout
        STEP_TIMEOUT. Blocks until every rank has joined. That gloo group
        is the control group whatever `cpu_collectives` says ("none" or
        "gloo", the TPU package's choices for CPU ranks). Then the data
        group: this rank's card (`device`, resolved for `process_id`),
        its identity exchanged with every rank's (`form_data_group`)."""
        if cls._initialized:
            return
        if cpu_collectives not in (None, "none", "gloo"):
            raise ValueError(
                f"--spmd-cpu-collectives must be none|gloo, got "
                f"{cpu_collectives!r}")
        from datetime import timedelta

        import torch.distributed as dist

        from ..device import resolve_devices

        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timedelta(seconds=cls.STEP_TIMEOUT))
        cls._initialized = True
        cls.form_data_group(resolve_devices(device, rank=process_id)[0])

    @classmethod
    def form_data_group(cls, device):
        """Every rank's `card_identity` gathered over the (initialized)
        gloo group, the same `collective_backend` chosen on every rank,
        and for "nccl" a new NCCL group of every rank, brought up at once
        by one all_reduce on `device` (this rank's card): an NCCL group
        that was chosen and does not come up fails the boot with its
        error, never falling back to gloo. Returns the backend."""
        from datetime import timedelta

        import torch
        import torch.distributed as dist

        from ..parallel.sharded import card_identity, collective_backend

        ids = [None] * dist.get_world_size()
        dist.all_gather_object(ids, card_identity(device))
        backend = collective_backend(ids, dist.is_nccl_available())
        if backend == "nccl":
            group = dist.new_group(
                backend="nccl", timeout=timedelta(seconds=cls.STEP_TIMEOUT))
            with torch.cuda.device(device):
                probe = torch.ones(1, dtype=torch.int64, device=device)
                dist.all_reduce(probe, group=group)
                if int(probe) != len(ids):
                    raise RuntimeError(
                        f"the NCCL data group summed {int(probe)} over "
                        f"{len(ids)} ranks")
            cls._data_group = group
        cls._backend = backend
        return backend

    @classmethod
    def shutdown(cls):
        """Leave the data group and the process group (server stop)."""
        if not cls._initialized:
            return
        import torch.distributed as dist

        groups = [cls._data_group] if cls._data_group is not None else []
        for group in groups + [None]:  # None: the world, last
            try:
                dist.destroy_process_group(group)
            except Exception:  # noqa: BLE001 — shutting down regardless
                pass
        cls._data_group, cls._backend = None, "gloo"
        cls._initialized = False

    def __init__(self, holder, cluster, client_factory, logger=None,
                 serve_mode="off", stream_gap_timeout=None):
        from .meshstacks import MeshStackCache

        self.holder = holder
        self.cluster = cluster
        self.client_factory = client_factory
        self.logger = logger or NopLogger()
        self._lock = threading.Lock()  # one step at a time per process
        self._step_id = 0
        # --spmd-serve (an unknown boot value degrades to off)
        self.serve_mode = serve_mode if serve_mode in self.SERVE_MODES \
            else "off"
        self.mesh_cache = MeshStackCache(logger=self.logger)
        # the batch and fused steps' program tables (count_expr's
        # MultiProgram), by ("count_batch", sigs, arities); the fusion
        # ledger's eviction drops entries under self._lock
        self._fn_specs = OrderedDict()
        # the step stream (serve on): peers run announced steps in
        # sequence order on a runner thread, not on the announcing HTTP
        # handler thread, so the coordinator's announcement returns at
        # the ack
        self._stream_cond = threading.Condition()
        self._stream_queue = {}  # seq -> step
        self._stream_next = None  # next seq to run (set by the first recv)
        self._stream_thread = None
        self._stream_closed = False
        # the outbound stream sequence: apart from _step_id, so steps of
        # serve off/shadow never open gaps in the stream
        self._stream_seq_out = 0
        self.stream_errors = 0
        self.stream_resyncs = 0
        if stream_gap_timeout is not None and stream_gap_timeout > 0:
            self.STREAM_GAP_TIMEOUT = float(stream_gap_timeout)
        # -- the observatory: its own lock, so the ring can be read while
        # a step holds _lock
        self._obs_lock = threading.Lock()
        self._step_ring = deque(maxlen=self.STEP_RING_SIZE)
        self._phase_totals = {}  # phase -> [count, seconds]
        self._step_clock = None  # the in-flight step's (under _lock)
        # last completed step record, thread-local: the coordinator's
        # query thread IS its step thread, so ?profile=true grafts its
        # own step's phases race-free
        self._step_tls = threading.local()
        self.gap_onsets = 0
        self.gap_stall_seconds = 0.0
        self._straggler_flags = OrderedDict()  # (seq, node, phase) -> 1
        self.straggler_flags_total = 0
        # the step lifecycle: announced > entered means a peer never
        # reached the step, entered > exited that the step itself hung
        self.steps_announced = 0
        self.steps_entered = 0
        self.steps_exited = 0
        self.last_seq = 0
        # batched and fused Count steps
        self.batch_steps = 0
        self.batched_queries = 0
        self.fused_steps = 0
        self.fused_queries = 0
        # steps whose ranks reported different step numbers (gloo paired
        # two steps' collectives)
        self.seq_mismatches = 0
        # Count pre-flight epochs: {index: membership epoch} of the last
        # successful validation round (steps carry resolved plans, so one
        # validation round per epoch suffices)
        self._count_epochs = OrderedDict()
        # /internal/spmd/stats
        self.steps_run = 0
        self.validations = 0
        self.validations_skipped = 0
        self.forwarded = 0
        self.forward_errors = 0
        self.fallbacks = 0  # eligible calls whose step failed or over cap
        self.device_failures = 0  # steps a card failure ended (500s)
        #: declines before any step, by reason (each a call the HTTP
        #: merge served)
        self.declined = {"not_ready": 0, "membership": 0,
                         "no_coordinator": 0, "uncoverable": 0}
        self._stats_lock = threading.Lock()  # handler threads count
        self._local_exec = None  # set by the API (its serving executor)
        self._sharded = None  # this rank's ShardedQueryEngine (lazy)
        #: kernel launches made by this process's steps (a process-wide
        #: counter also moves for the HTTP legs of declined calls)
        self.step_launches = dict.fromkeys(STEP_KERNELS, 0)
        # the group is fixed at boot: a grown or shrunk cluster declines
        self._boot_node_ids = tuple(sorted(n.id for n in cluster.nodes)) \
            if cluster is not None else ()

    def _count(self, what, n=1):
        """Add n to a counter of stats(): an attribute, or a decline
        reason."""
        with self._stats_lock:
            if what in self.declined:
                self.declined[what] += n
            else:
                setattr(self, what, getattr(self, what) + n)

    # -- the group ------------------------------------------------------------

    @staticmethod
    def _dist():
        import torch.distributed as dist

        return dist

    def _num_processes(self):
        dist = self._dist()
        return dist.get_world_size() if dist.is_initialized() else 1

    def mesh_shape(self):
        """(processes, devices per process) — the shape EXPLAIN and the
        fusion ledger report. One card per rank."""
        return [self._num_processes(), 1]

    def set_serve_mode(self, mode):
        """Run-time serve-mode switch (POST /debug/spmd). Raises on an
        unknown mode (the caller answers 400)."""
        if mode not in self.SERVE_MODES:
            raise SpmdError(f"unknown spmd serve mode: {mode!r}")
        self.serve_mode = mode
        return self.serve_mode

    # -- signature helper -----------------------------------------------------

    def _signature(self, idx, call):
        """Tree signature for coverage (coordinator side only — the
        resolved plan ships IN the step). Same shape rules as the stacked
        evaluator (exec.stacked.tree_signature), but leaf checks consult
        only replicated state (the schema): a node that owns no shards of
        a field contributes zero planes."""
        from ..exec.bsicond import normalize_bsi_condition
        from ..exec.stacked import intern_time_leaf, tree_signature

        def leaf(idx, field_name, row_id, leaves):
            if idx.field(field_name) is None:
                return None
            key = ("row", field_name, int(row_id))
            if key not in leaves:
                leaves[key] = len(leaves)
            return ("leaf", leaves[key])

        def bsi_leaf(idx, field_name, cond, leaves):
            field = idx.field(field_name)
            if field is None or field.options.type != "int":
                return None
            norm = normalize_bsi_condition(cond)
            if norm is None:
                return None
            op, vals = norm
            key = ("bsicond", field_name, op, vals)
            if key not in leaves:
                leaves[key] = len(leaves)
            return ("leaf", leaves[key])

        leaves = {}
        sig = tree_signature(idx, call, leaves, leaf, bsi_leaf,
                             intern_time_leaf)
        if sig is None or not leaves:
            return None
        ordered = sorted(leaves.items(), key=lambda kv: kv[1])
        return sig, [key for key, _ in ordered]

    @staticmethod
    def _leaf_to_wire(key):
        """Leaf key -> JSON-able tagged entry: ["row", field, row_id],
        ["bsicond", field, op, values] or ["timerow", field, row, views]."""
        if key[0] == "bsicond":
            _, field_name, op, vals = key
            return ["bsicond", field_name, op,
                    list(vals) if isinstance(vals, tuple) else vals]
        if key[0] == "timerow":
            _, field_name, row_id, views = key
            return ["timerow", field_name, row_id, list(views)]
        _, field_name, row_id = key
        return ["row", field_name, row_id]

    def _plan_filter(self, idx, step, filter_call):
        """Attach an optional filter plan to a step; False when the filter
        tree isn't coverable (the caller falls back to HTTP)."""
        if filter_call is None:
            step["sig"] = None
            step["leaves"] = []
            return True
        sig_leaves = self._signature(idx, filter_call)
        if sig_leaves is None:
            return False
        sig, leaf_keys = sig_leaves
        step["sig"] = sig_to_wire(sig)
        step["leaves"] = [self._leaf_to_wire(k) for k in leaf_keys]
        return True

    # -- entry (any node) -----------------------------------------------------

    @staticmethod
    def _call_kind(call):
        if call.name == "Count" and len(call.children) == 1:
            return "count"
        if call.name == "Sum":
            return "sum"
        if call.name == "TopN":
            return "topn"
        if call.name in ("Min", "Max"):
            return "minmax"
        if call.name == "GroupBy":
            return "groupby"
        return None

    def _gate_decline(self):
        """The reason the cluster cannot run a step now, or None."""
        from .node import NODE_STATE_READY

        cluster = self.cluster
        if any(n.state != NODE_STATE_READY for n in cluster.nodes):
            return "not_ready"  # a hung participant would stall the group
        if tuple(sorted(n.id for n in cluster.nodes)) != self._boot_node_ids:
            return "membership"  # the group was formed with other nodes
        if cluster.coordinator is None:
            return "no_coordinator"
        return None

    def maybe_execute(self, idx, call, shards, forwarded=False):
        """THE ClusterExecutor entry: (used, result). used=False means the
        caller takes the HTTP merge. Runs on ANY node: the coordinator
        initiates directly; other nodes forward eligible calls to it in
        one hop. A card failure on any rank raises (a 500), never falls
        back (trap 30)."""
        if self.serve_mode == "http":
            return False, None  # A/B: force the HTTP fan-out
        kind = self._call_kind(call)
        if kind is None:
            return False, None
        cluster = self.cluster
        if cluster is None or len(cluster.nodes) < 2:
            return False, None
        reason = self._gate_decline()
        if reason is not None:
            self._count(reason)
            return False, None
        coord = cluster.coordinator
        if coord.id != cluster.local_id:
            if forwarded:
                return False, None  # never bounce a forwarded call again
            # schema-level pre-check so a call the coordinator would
            # refuse anyway never pays the forward hop
            if not self._eligible(idx, call, kind):
                self._count("uncoverable")
                return False, None
            return self._forward(idx, call, shards, coord)
        try_fn = {
            "count": self._try_count,
            "sum": self._try_sum,
            "topn": self._try_topn,
            "minmax": self._try_minmax,
            "groupby": self._try_groupby,
        }[kind]
        from ..ops.cuda_build import is_device_failure
        from ..utils import tracing

        before = getattr(self._step_tls, "rec", None)
        try:
            # the collective data plane is otherwise invisible to a query
            # profile: this span records that the query went over the
            # group (and where the step's wall went) instead of HTTP
            with tracing.start_span("spmd.step", kind=kind,
                                    shards=len(shards)) as span:
                result = try_fn(idx, call, list(shards))
                self._graft_span(span, before=before)
        except Exception as e:
            if is_device_failure(e):
                self._count("device_failures")
                raise
            # a failed or timed-out collective: invalidate the epoch so
            # the next query re-probes the peers, and serve over HTTP
            self._count("fallbacks")
            self._count_epochs.pop(idx.name, None)
            self.logger.printf(
                "spmd: %s step failed (%s); epoch invalidated, falling "
                "back to HTTP merge", kind, e)
            return False, None
        if result is None:
            self._count("uncoverable")
            return False, None
        return True, result

    def _eligible(self, idx, call, kind):
        """Replicated-schema eligibility shared by the forward pre-check
        and the coordinator: every check depends only on state all nodes
        agree on."""
        if kind == "count":
            return self._signature(idx, call.children[0]) is not None
        if kind in ("sum", "minmax"):
            if self._agg_field(idx, call, want_int=True) is None:
                return False
            filter_call = call.children[0] if call.children else None
            return filter_call is None \
                or self._signature(idx, filter_call) is not None
        if kind == "topn":
            field_name = call.args.get("_field") or call.field_arg()
            field = idx.field(field_name) if field_name else None
            if field is None or field.options.type == "int":
                return False
            if call.args.get("tanimotoThreshold") \
                    or call.args.get("attrName") is not None \
                    or call.args.get("ids") is not None \
                    or len(call.children) > 1:
                return False
            filter_call = call.children[0] if call.children else None
            return filter_call is None \
                or self._signature(idx, filter_call) is not None
        if kind == "groupby":
            if self._groupby_fields(idx, call) is None:
                return False
            filter_call = call.args.get("filter")
            if filter_call is None:
                return True
            return isinstance(filter_call, Call) \
                and self._signature(idx, filter_call) is not None
        return False

    def _forward(self, idx, call, shards, coord):
        """Non-coordinator hop: hand the eligible call to the coordinator
        for step initiation (a single initiator keeps the step order
        global). A card failure the coordinator reports raises here."""
        try:
            client = self.client_factory(coord.uri)
            client.timeout = self.STEP_TIMEOUT + 30
            resp = client.spmd_initiate({
                "index": idx.name,
                "pql": call_to_pql(call),
                "shards": list(shards),
            })
        except Exception as e:
            self._count("forward_errors")
            self.logger.printf(
                "spmd: initiate forward to coordinator failed "
                "(falling back to HTTP merge): %s", e)
            return False, None
        if resp.get("device_failure"):
            self._count("device_failures")
            raise SpmdDeviceFailure(resp["device_failure"])
        if not resp.get("used"):
            return False, None
        self._count("forwarded")
        from .executor import result_from_json

        return True, result_from_json(resp.get("result"))

    def initiate(self, payload):
        """Coordinator side of POST /internal/spmd/initiate."""
        from ..ops.cuda_build import is_device_failure

        idx = self.holder.index(payload["index"])
        if idx is None:
            return {"used": False}
        call = parse(payload["pql"]).calls[0]
        try:
            used, result = self.maybe_execute(
                idx, call, [int(s) for s in payload["shards"]],
                forwarded=True)
        except Exception as e:
            if is_device_failure(e):
                return {"used": False, "device_failure": str(e)}
            raise
        if not used:
            return {"used": False}
        return {"used": True, "result": self._wire_result(result)}

    @staticmethod
    def _wire_result(result):
        from ..exec.result import GroupCount, Pair, ValCount

        if isinstance(result, ValCount):
            return result.to_json()
        if isinstance(result, list):
            if result and isinstance(result[0], (Pair, GroupCount)):
                return [r.to_json() for r in result]
            return list(result)
        return int(result)  # count

    # -- coordinator ----------------------------------------------------------

    def _gate(self, idx, shards):
        """Shard-segment skeleton of a step: each node's owned shards and
        the segment length every rank gathers (zero planes past a node's
        own shards; one device per rank, so no further padding)."""
        by_node = self.cluster.shards_by_node(idx.name, list(shards))
        segments = {node.id: sorted(s) for node, s in by_node.items()}
        dev_pp = 1
        longest = max((len(s) for s in segments.values()), default=0)
        return {
            "index": idx.name,
            "segments": segments,
            "seg_len": max(dev_pp, longest),
            "dev_pp": dev_pp,
            "nodes": list(self._boot_node_ids),
        }

    def _execute_step(self, step):
        """Announce and run one validated step (coordinator side).

        Serve off/shadow: a blocking POST /internal/spmd/step per peer,
        joined around the local step.

        Serve on (streamed): POST /internal/spmd/stream per peer, which
        enqueues the step by sequence number and acks before running it,
        so this call returns as soon as the LOCAL step completes (the
        collective itself is the synchronization) and the acks are
        collected after the step lock is released."""
        from ..utils import flightrec, tracing

        streamed = self.serve_mode == "on"
        # carry the coordinator's trace id, so every node's step record
        # (and the merged timeline) joins back to the query
        span = tracing.current_span()
        if span is not None and "trace" not in step:
            step["trace"] = span.trace_id
        errors = []
        with self._lock:
            # announce_recv t0 on the coordinator: the announcement
            # fan-out (peers stamp their own receipt)
            step["_recv_t"] = time.perf_counter()
            self._step_id += 1
            step["step"] = self._step_id
            if streamed:
                self._stream_seq_out += 1
                step["seq"] = self._stream_seq_out
            self.steps_announced += 1
            flightrec.record(
                "spmd.step_announce", index=step.get("index", ""),
                op=step.get("kind", "count"),
                seq=step.get("seq", self._step_id), streamed=streamed)
            wire = {k: v for k, v in step.items() if not k.startswith("_")}

            def post(node):
                try:
                    client = self.client_factory(node.uri)
                    client.timeout = self.STEP_TIMEOUT
                    if streamed:
                        client.spmd_stream(wire)
                    else:
                        client.spmd_step(wire)
                except Exception as e:  # surfaced after the step
                    errors.append((node.id, e))

            threads = [threading.Thread(target=post, args=(n,),
                                        daemon=True)
                       for n in self.cluster.peers()]
            for t in threads:
                t.start()
            try:
                # join the step ourselves: the peers are inside run_step
                # (or their stream runner) now
                result = self._enter_exit_run(step)
            finally:
                if not streamed:
                    for t in threads:
                        t.join()
                    self._log_peer_errors(step, errors, streamed)
        if streamed:
            # the acks raced the step: collect them without the lock
            for t in threads:
                t.join(timeout=self.VALIDATE_TIMEOUT)
            self._log_peer_errors(step, errors, streamed)
        return result

    def _log_peer_errors(self, step, errors, streamed):
        if not errors:
            return
        # every process reached the collective (or the step raised): these
        # are lost responses or acks, or peers reporting the failure the
        # step already carried
        if streamed:
            self.stream_errors += len(errors)
        self.logger.printf("spmd: peer errors on step %s: %s",
                           step["step"], errors)

    def _enter_exit_run(self, step):
        """_run_step_locked bracketed by the step-lifecycle counters and
        events and a flight-recorder watchdog (a step stuck past its
        deadline trips a collective_stall bundle), under a _StepClock
        whose t0 is the announcement receipt, so announce_recv covers the
        stream-queue and step-lock wait. The finished step lands in the
        ring. Caller holds self._lock."""
        from ..utils import flightrec

        seq = int(step.get("seq") or step.get("step") or 0)
        kind = step.get("kind", "count")
        started = time.time()
        clk = _StepClock(t0=step.pop("_recv_t", None))
        clk.mark("announce_recv")
        self._step_clock = clk
        self.steps_entered += 1
        self.last_seq = max(self.last_seq, seq)
        flightrec.record("spmd.step_enter", index=step.get("index", ""),
                         op=kind, seq=seq)
        token = flightrec.watch_begin("spmd.step", seq=seq, op=kind,
                                      index=step.get("index", ""))
        ok = False
        try:
            result = self._run_step_locked(step)
            ok = True
            return result
        finally:
            flightrec.watch_end(token)
            self._step_clock = None
            wall = clk.close("exit")
            self.steps_exited += 1
            flightrec.record("spmd.step_exit", index=step.get("index", ""),
                             op=kind, seq=seq, ok=ok)
            self._note_step(step, seq, started, wall, clk.phases, ok)

    def _mark_phase(self, phase):
        """Attribute time since the last mark to `phase` on the in-flight
        step's clock (no-op outside a step)."""
        clk = self._step_clock
        if clk is not None:
            clk.mark(phase)

    def _note_step(self, step, seq, started, wall, phase_marks, ok):
        """Fold one finished step into the observatory: the bounded ring
        and the per-phase totals (under _obs_lock, so readers never touch
        the step lock), the thread-local last record, and the
        `spmd_step_seconds{phase}` and `spmd_step_wall_seconds` timings
        with the step's trace id as exemplar."""
        phases = {}
        for name, secs in phase_marks:
            phases[name] = phases.get(name, 0.0) + secs
        rec = {"seq": seq, "step": step.get("step", 0),
               "kind": step.get("kind", "count"),
               "index": step.get("index", ""), "start": started,
               "wall_seconds": round(wall, 6), "ok": ok,
               "phases": {p: round(s, 6) for p, s in phases.items()}}
        trace = step.get("trace")
        if trace:
            rec["trace"] = trace
        with self._obs_lock:
            self._step_ring.append(rec)
            for name, secs in phases.items():
                tot = self._phase_totals.get(name)
                if tot is None:
                    tot = self._phase_totals[name] = [0, 0.0]
                tot[0] += 1
                tot[1] += secs
        self._step_tls.rec = rec
        try:
            from ..utils.stats import global_stats

            for name, secs in phases.items():
                global_stats.timing("spmd_step_seconds", secs,
                                    tags={"phase": name}, trace_id=trace)
            global_stats.timing("spmd_step_wall_seconds", wall,
                                trace_id=trace)
        except Exception:  # noqa: BLE001 — stats must never fail a step
            pass

    def _graft_span(self, span, before=None):
        """Tag the query's spmd.step span with the per-phase walls of the
        step THIS thread just ran (none when the call was forwarded)."""
        if span is None:
            return
        rec = getattr(self._step_tls, "rec", None)
        if rec is None or rec is before:
            return
        span.set_tag("phases_ms", {p: round(s * 1000, 3)
                                   for p, s in rec["phases"].items()})
        span.set_tag("step_seq", rec["seq"])

    def _try_count(self, idx, call, shards):
        """Count(call) merged over the group, or None to fall back."""
        sig_leaves = self._signature(idx, call.children[0])
        if sig_leaves is None:
            return None
        step = self._gate(idx, shards)
        sig, leaf_keys = sig_leaves
        step["kind"] = "count"
        step["sig"] = sig_to_wire(sig)
        step["leaves"] = [self._leaf_to_wire(k) for k in leaf_keys]
        # pre-flight once per membership epoch: the step carries its
        # whole plan, so the per-peer checks are epoch-constant
        if not self._ensure_count_epoch(step):
            return None
        return self._execute_step(step)

    # -- batched and fused Count steps ----------------------------------------

    def _cluster_ready(self):
        """The maybe_execute gates shared by the batch and fused entries
        (called on the serving node by the coalescer and the executor):
        this node is the coordinator, every node is READY, the membership
        is the group's."""
        cluster = self.cluster
        if cluster is None or len(cluster.nodes) < 2:
            return False
        if self._gate_decline() is not None:
            return False
        return cluster.coordinator.id == cluster.local_id

    def _count_plans(self, idx, calls):
        """Wire plans of a list of Count calls, or None when any call is
        not coverable (the whole batch falls back: splitting it would
        break the one-announcement contract)."""
        plans = []
        for call in calls:
            if self._call_kind(call) != "count":
                return None
            sig_leaves = self._signature(idx, call.children[0])
            if sig_leaves is None:
                return None
            sig, leaf_keys = sig_leaves
            plans.append({"sig": sig_to_wire(sig),
                          "leaves": [self._leaf_to_wire(k)
                                     for k in leaf_keys]})
        return plans

    def _batch_step(self, idx, plans, shards):
        """A count_batch step of `plans`, padded to the batch bucket by
        repeating plan 0 (its leaves are the same blocks, so a repeat
        costs the kernel one more member and no gather), or None when
        the pre-flight declines."""
        from ..exec.stacked import batch_bucket

        step = self._gate(idx, shards)
        step["kind"] = "count_batch"
        bucket = batch_bucket(len(plans))
        step["plans"] = plans + [plans[0]] * (bucket - len(plans))
        step["bucket"] = bucket
        if not self._ensure_count_epoch(step):
            return None
        return step

    def _step_or_fallback(self, idx, step, kind, k, shards):
        """Run a count_batch step under its spmd.step span: the counts,
        or None after a non-card failure (the epoch invalidated, the
        caller serves per query). A card failure raises (trap 30)."""
        from ..ops.cuda_build import is_device_failure
        from ..utils import tracing

        try:
            with tracing.start_span("spmd.step", kind=kind,
                                    shards=len(shards), batch=k) as span:
                counts = self._execute_step(step)
                self._graft_span(span)
        except Exception as e:
            if is_device_failure(e):
                self._count("device_failures")
                raise
            self._count("fallbacks")
            self._count_epochs.pop(idx.name, None)
            self.logger.printf(
                "spmd: %s step failed (%s); epoch invalidated, falling "
                "back to the per-query path", kind, e)
            return None
        return counts

    def maybe_execute_batch(self, idx, calls, shards):
        """K eligible Count calls as ONE collective step: (used, counts).
        The coalescer's cluster adapter (SpmdBatchRunner) lands here;
        serve mode must be on (batching changes the control plane's
        shape, so it never runs on the serve-off path)."""
        if self.serve_mode != "on" or not calls:
            return False, None
        if not self._cluster_ready():
            return False, None
        plans = self._count_plans(idx, calls)
        if plans is None:
            return False, None
        step = self._batch_step(idx, plans, shards)
        if step is None:
            return False, None
        counts = self._step_or_fallback(idx, step, "count_batch",
                                        len(plans), shards)
        if counts is None:
            return False, None
        self._count("batched_queries", len(plans))
        return True, counts[:len(plans)]

    def maybe_execute_fused(self, idx, query, shards):
        """A whole multi-call Count query as ONE collective step: (used,
        counts). Gated by fusion's admission (a cold fingerprint never
        builds a program table) and ledgered under the mesh-shaped
        program key, so /debug/fusion shows the collective programs. Warm
        path: one announcement, one K1 launch a rank, zero result bytes
        over HTTP."""
        from ..exec import fusion as fusion_mod

        if self.serve_mode != "on" or not fusion_mod.acting():
            return False, None
        calls = list(query.calls)
        if not calls or any(self._call_kind(c) != "count" for c in calls):
            return False, None
        if not self._cluster_ready():
            return False, None
        from ..utils import workload as workload_mod

        fp = workload_mod.current_fingerprint()
        if fp is None:
            fp, _ = workload_mod.fingerprint(idx.name, query)
        if not fusion_mod.admit(fp):
            return False, None
        plans = self._count_plans(idx, calls)
        if plans is None:
            return False, None
        step = self._batch_step(idx, plans, shards)
        if step is None:
            return False, None
        fn_key = self._program_key(step)
        compiled = fn_key not in self._fn_specs
        t0 = time.perf_counter()
        counts = self._step_or_fallback(idx, step, "fused", len(plans),
                                        shards)
        if counts is None:
            return False, None
        wall = time.perf_counter() - t0
        # ledger AFTER _execute_step released self._lock: fusion's
        # eviction takes it to drop a program table
        key = fusion_mod.mesh_program_key(
            fp, fn_key[1], step["bucket"], self.mesh_shape())
        fusion_mod.touch_mesh_program(
            key, self, fn_key, compile_ms=wall * 1000 if compiled else None)
        fusion_mod.note_fused(len(plans))
        workload_mod.note_batch(len(plans))
        self._count("fused_steps")
        self._count("fused_queries")
        return True, counts[:len(plans)]

    @staticmethod
    def _program_key(step):
        """("count_batch", sigs, arities) of a count_batch step: its
        program table's key in _fn_specs."""
        plans = step["plans"]
        return ("count_batch",
                tuple(sig_from_wire(p["sig"]) for p in plans),
                tuple(len(p["leaves"]) for p in plans))

    def _program(self, fn_key):
        """The multi-tree entry's program table for `fn_key` (built on
        the first launch of the key, LRU past MAX_FNS). Caller holds
        self._lock."""
        from ..ops.count_expr import MultiProgram

        program = self._fn_specs.get(fn_key)
        if program is None:
            program = self._fn_specs[fn_key] = MultiProgram()
            while len(self._fn_specs) > self.MAX_FNS:
                self._fn_specs.popitem(last=False)
        else:
            self._fn_specs.move_to_end(fn_key)
        return program

    # -- EXPLAIN (plan + analyze) ---------------------------------------------

    def plan_eligible(self, idx, call):
        """Would the normal serving path take the collective plane for
        this call? The ?explain=true gate. As in the TPU package only a
        mesh-serving plane (serve mode "on") claims it, so serve-off
        plans show the per-node fan-out."""
        if self.serve_mode != "on":
            return False
        kind = self._call_kind(call)
        if kind is None or self.cluster is None \
                or len(self.cluster.nodes) < 2:
            return False
        return self._gate_decline() is None \
            and self._eligible(idx, call, kind)

    def plan_node(self, idx, call, shards):
        """Serialized plan entry for ?explain=true: the collective path
        runs ZERO dispatches from the coordinator's view."""
        return {
            "op": call.name,
            "strategy": "spmd-collective",
            "annotations": {
                "spmd": True,
                "mesh": self.mesh_shape(),
                "dispatches": 0,
                "shards": len(shards or []),
            },
            "children": [],
        }

    @staticmethod
    def _psum_bytes(kind, result):
        """Collective output payload per process (without the failure
        slots): 8 bytes per int64."""
        if isinstance(result, (list, tuple)):
            return 8 * max(1, len(result))
        return 8

    def maybe_execute_analyze(self, idx, call, shards):
        """?explain=analyze through the collective plane: execute, then
        graft the step's dispatch, collective bytes and phases onto a
        mesh plan entry. (used, result, plan_entry). Mesh-serving only,
        as in the TPU package; serve-off analyzes per node."""
        if self.serve_mode != "on":
            return False, None, None
        before = getattr(self._step_tls, "rec", None)
        t0 = time.perf_counter()
        used, result = self.maybe_execute(idx, call, shards)
        if not used:
            return False, None, None
        wall = time.perf_counter() - t0
        entry = {
            "node": "mesh",
            "shards": len(shards or []),
            "plan": {
                "op": call.name,
                "strategy": "spmd-collective",
                "annotations": {
                    "spmd": True,
                    "mesh": self.mesh_shape(),
                    "dispatches": 1,
                    "psum_bytes": self._psum_bytes(
                        self._call_kind(call), result),
                    "wall_ms": round(wall * 1000, 3),
                },
                "children": [],
            },
        }
        rec = getattr(self._step_tls, "rec", None)
        if rec is not None and rec is not before:
            entry["plan"]["annotations"]["phases_ms"] = {
                p: round(s * 1000, 3) for p, s in rec["phases"].items()}
            entry["plan"]["annotations"]["step_seq"] = rec["seq"]
        return True, result, entry

    def _membership_epoch(self):
        return tuple((n.id, n.state) for n in self.cluster.nodes)

    def _ensure_count_epoch(self, step):
        epoch = self._membership_epoch()
        if self._count_epochs.get(step["index"]) == epoch:
            self._count("validations_skipped")
            return True
        if self._validate_on_peers(step) is None:
            return False
        self._count_epochs[step["index"]] = epoch
        while len(self._count_epochs) > 64:
            self._count_epochs.popitem(last=False)
        return True

    @staticmethod
    def _agg_field(idx, call, want_int):
        field_name = call.args.get("field") or call.args.get("_field") \
            or call.field_arg()
        field = idx.field(field_name) if field_name else None
        if field is None:
            return None
        if want_int != (field.options.type == "int"):
            return None
        return field

    def _try_sum(self, idx, call, shards):
        """Sum(filter?, field=f) merged over the group: each rank counts
        its BSI planes with K3, one all_reduce of the [2D + 1] counts.
        Returns the ValCount with the field base applied (field.go:1583),
        or None to fall back."""
        from ..exec.result import ValCount

        field = self._agg_field(idx, call, want_int=True)
        if field is None:
            return None
        filter_call = call.children[0] if call.children else None
        step = self._gate(idx, shards)
        step["kind"] = "sum"
        step["field"] = field.name
        if not self._plan_filter(idx, step, filter_call):
            return None
        resps = self._validate_on_peers(step)
        if resps is None:
            return None
        # depth can differ per node (it grows with out-of-range writes):
        # the step uses the cluster-wide max, peers zero-extend
        step["depth"] = max(
            [field.options.bit_depth]
            + [int(r.get("bit_depth", 0)) for r in resps])
        total, count = self._execute_step(step)
        return ValCount(total + field.options.base * count, count)

    def _try_minmax(self, idx, call, shards):
        """Min/Max over the group: each rank's (empty, sign, magnitude,
        count) from the single node's walk, one all_gather, then the
        extreme over the non-empty ranks with the count summed over the
        ranks at it (reference merge: ValCount.Smaller/Larger over
        per-node partials, executor.go:380-474)."""
        from ..exec.result import ValCount

        field = self._agg_field(idx, call, want_int=True)
        if field is None:
            return None
        filter_call = call.children[0] if call.children else None
        step = self._gate(idx, shards)
        step["kind"] = "minmax"
        step["field"] = field.name
        step["is_max"] = call.name == "Max"
        if not self._plan_filter(idx, step, filter_call):
            return None
        resps = self._validate_on_peers(step)
        if resps is None:
            return None
        step["depth"] = max(
            [field.options.bit_depth]
            + [int(r.get("bit_depth", 0)) for r in resps])
        empty, use_neg, mag, count = self._execute_step(step)
        if empty:
            return ValCount()
        return ValCount((-mag if use_neg else mag) + field.options.base,
                        count)

    def _try_topn(self, idx, call, shards):
        """TopN merged over the group: candidate rows union across nodes
        in the validation round, each rank counts them with K3, one
        all_reduce of [R]. Returns the trimmed pair list (reference merge:
        Pairs.Add cache.go:356 + executor.go:925), or None to fall back
        (attr filters, tanimoto, ids and oversized candidate sets take
        the HTTP path)."""
        field_name = call.args.get("_field") or call.field_arg()
        field = idx.field(field_name) if field_name else None
        if field is None or field.options.type == "int":
            return None
        if call.args.get("tanimotoThreshold") \
                or call.args.get("attrName") is not None \
                or call.args.get("ids") is not None:
            return None
        if len(call.children) > 1:
            return None
        filter_call = call.children[0] if call.children else None
        step = self._gate(idx, shards)
        step["kind"] = "topn"
        step["field"] = field.name
        if not self._plan_filter(idx, step, filter_call):
            return None
        resps = self._validate_on_peers(step)
        if resps is None:
            return None
        rows = set(self._topn_candidates(idx, field.name))
        for r in resps:
            rows.update(int(x) for x in r.get("rows", []))
        rows = sorted(rows)
        if not rows:
            return []
        if len(rows) > self.TOPN_MAX_ROWS:
            self._count("fallbacks")
            self.logger.printf(
                "spmd: TopN(%s) candidate set %d exceeds cap %d; "
                "falling back to HTTP merge", field.name, len(rows),
                self.TOPN_MAX_ROWS)
            return None
        step["rows"] = rows
        counts = self._execute_step(step)

        from ..exec.result import Pair

        threshold = max(int(call.args.get("threshold") or 1), 1)
        pairs = [Pair(r, c) for r, c in zip(rows, counts) if c >= threshold]
        pairs.sort(key=lambda p: (-p.count, p.id))
        n = call.args.get("n")
        if n is not None:
            pairs = pairs[:int(n)]
        return pairs

    @staticmethod
    def _groupby_fields(idx, call):
        """The GroupBy's Rows fields, or None when a child is not a plain
        Rows of a set-like field (time fields and column- or time-scoped
        Rows take the HTTP path)."""
        from ..core.field import FIELD_TYPE_INT, FIELD_TYPE_TIME

        if not call.children:
            return None
        fields = []
        for child in call.children:
            if child.name != "Rows":
                return None
            if "column" in child.args or "from" in child.args \
                    or "to" in child.args:
                return None
            fname = child.args.get("_field") or child.args.get("field") \
                or child.field_arg()
            field = idx.field(fname) if fname else None
            if field is None or field.type in (FIELD_TYPE_INT,
                                               FIELD_TYPE_TIME):
                return None
            fields.append(field)
        return fields

    def _try_groupby(self, idx, call, shards):
        """GroupBy merged over the group: per-child candidate rows union
        across nodes in the validation round, each rank counts the row
        cross-product (K3 for one field, K4 over the last two fields for
        more, the outer rows intersected into the filter), one all_reduce
        of the [C] cells (reference merge: mergeGroupCounts,
        executor.go:1098-1237)."""
        from ..exec.executor import groupby_previous
        from ..exec.result import FieldRow, GroupCount

        fields = self._groupby_fields(idx, call)
        if fields is None:
            return None
        # the call-level `previous` cursor is validated BEFORE the round:
        # a malformed cursor must not cost a step just to fall back and
        # raise the same error on the HTTP path
        previous = groupby_previous(call, len(call.children))
        prev_t = tuple(previous) if previous is not None else None
        filter_call = call.args.get("filter")
        step = self._gate(idx, shards)
        step["kind"] = "groupby"
        step["fields"] = [f.name for f in fields]
        if not self._plan_filter(idx, step, filter_call):
            return None
        resps = self._validate_on_peers(step)
        if resps is None:
            return None
        child_rows = []
        for i, (child, field) in enumerate(zip(call.children, fields)):
            rows = set(self._rows_candidates(idx, field.name))
            for r in resps:
                per_child = r.get("rows", [])
                if i < len(per_child):
                    rows.update(int(x) for x in per_child[i])
            # over-cap decline BEFORE previous/limit pruning: the per-node
            # lists are truncated at the cap, so pruning first could shrink
            # an incomplete set under it and serve a partial result
            if len(rows) > self.GROUPBY_MAX_CELLS:
                self._count("fallbacks")
                self.logger.printf(
                    "spmd: GroupBy child %s has %d candidate rows (cap "
                    "%d); falling back to HTTP merge", field.name,
                    len(rows), self.GROUPBY_MAX_CELLS)
                return None
            rows = sorted(rows)
            # child Rows() args apply to the GLOBAL merged set
            child_prev = child.args.get("previous")
            if child_prev is not None:
                rows = [r for r in rows if r > int(child_prev)]
            limit = child.args.get("limit")
            if limit is not None:
                rows = rows[:int(limit)]
            child_rows.append(rows)
        # seed the outermost child from the cursor; groups at or before
        # it are dropped lexicographically below
        if previous is not None:
            lo = previous[0] + (1 if len(child_rows) == 1 else 0)
            child_rows[0] = [r for r in child_rows[0] if r >= lo]
        cells = 1
        for rows in child_rows:
            cells *= len(rows)
        if cells == 0:
            return []
        if cells > self.GROUPBY_MAX_CELLS:
            self._count("fallbacks")
            self.logger.printf(
                "spmd: GroupBy cross-product %d cells exceeds cap %d; "
                "falling back to HTTP merge", cells, self.GROUPBY_MAX_CELLS)
            return None
        step["rows"] = child_rows
        counts = self._execute_step(step)

        # cell order == itertools.product order == lexicographic by the
        # row-id tuple (child_rows are sorted): the local executor's order
        out = []
        for group, cnt in zip(itertools.product(*child_rows), counts):
            if cnt > 0 and (prev_t is None or group > prev_t):
                out.append(GroupCount(
                    [FieldRow(f.name, rid) for f, rid in zip(fields, group)],
                    cnt))
        limit = call.args.get("limit")
        if limit is not None:
            out = out[:int(limit)]
        # offset after the limit-bounded merge, a no-op past the end
        # (reference parity: executeGroupBy executor.go:1134-1143)
        offset = call.args.get("offset")
        if offset is not None and int(offset) < len(out):
            out = out[int(offset):]
        return out

    def _topn_candidates(self, idx, field_name):
        """This node's TopN candidate rows (the shared policy,
        exec.executor.fragment_topn_candidates), capped at
        TOPN_MAX_ROWS + 1 (one node past the cap already declines)."""
        from ..exec.executor import fragment_topn_candidates

        field = idx.field(field_name)
        view = field.view(VIEW_STANDARD) if field is not None else None
        if view is None:
            return []
        rows = set()
        for frag in list(view.fragments.values()):
            rows.update(fragment_topn_candidates(frag))
        return sorted(rows)[:self.TOPN_MAX_ROWS + 1]

    def _rows_candidates(self, idx, field_name):
        """This node's present rows of a field (GroupBy child candidates;
        reference: fragment.rows via executeRowsShard executor.go:1319),
        capped at GROUPBY_MAX_CELLS + 1."""
        field = idx.field(field_name)
        view = field.view(VIEW_STANDARD) if field is not None else None
        if view is None:
            return []
        rows = set()
        for frag in list(view.fragments.values()):
            rows.update(frag.row_ids())
        return sorted(rows)[:self.GROUPBY_MAX_CELLS + 1]

    def _validate_on_peers(self, step):
        """Pre-flight every peer; the list of OK responses, or None when
        any peer declined or was unreachable."""
        self._count("validations")
        resps = []

        def probe(node):
            try:
                client = self.client_factory(node.uri)
                client.timeout = self.VALIDATE_TIMEOUT
                resps.append(client.spmd_validate(step))
            except Exception:  # noqa: BLE001 — a decline
                resps.append({"ok": False})

        threads = [threading.Thread(target=probe, args=(n,))
                   for n in self.cluster.peers()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(resps) != len(self.cluster.peers()) \
                or not all(r.get("ok") for r in resps):
            return None
        return resps

    def validate(self, step):
        """Peer side of POST /internal/spmd/validate: static checks only
        (the step carries its plan), plus what aggregate kinds merge:
        bit_depth for sum/minmax, candidate rows for topn/groupby."""
        idx = self.holder.index(step["index"])
        if idx is None:
            return {"ok": False, "reason": "index not found"}
        if int(step["dev_pp"]) != 1:
            return {"ok": False, "reason": "device count mismatch"}
        if tuple(step.get("nodes", ())) != self._boot_node_ids:
            return {"ok": False, "reason": "membership mismatch"}
        out = {"ok": True}
        kind = step.get("kind", "count")
        if kind in ("sum", "minmax"):
            field = idx.field(step["field"])
            if field is None or field.options.type != "int":
                return {"ok": False, "reason": "not an int field"}
            out["bit_depth"] = field.options.bit_depth
        elif kind == "topn":
            field = idx.field(step["field"])
            if field is None or field.options.type == "int":
                return {"ok": False, "reason": "not a set field"}
            out["rows"] = self._topn_candidates(idx, step["field"])
        elif kind == "groupby":
            out["rows"] = [self._rows_candidates(idx, f)
                           for f in step["fields"]]
        return out

    # -- step execution (every process) ---------------------------------------

    def run_step(self, step):
        """HTTP-handler entry for peers (POST /internal/spmd/step, serve
        off/shadow)."""
        # announce_recv then measures this node's step-lock wait (any
        # stamp that came over the wire is another process's clock)
        step["_recv_t"] = time.perf_counter()
        with self._lock:
            return self._enter_exit_run(step)

    def run_stream(self, step):
        """HTTP-handler entry for STREAMED announcements (serve on):
        enqueue by sequence number and ack at once; the stream runner
        thread runs the steps in seq order."""
        seq = int(step["seq"])
        # announce_recv t0 at ENQUEUE: it then measures the stream-queue
        # wait and the step-lock wait
        step["_recv_t"] = time.perf_counter()
        with self._stream_cond:
            self._stream_queue[seq] = step
            if self._stream_next is None:
                self._stream_next = seq
            if self._stream_thread is None \
                    or not self._stream_thread.is_alive():
                self._stream_thread = threading.Thread(
                    target=self._stream_loop, name="spmd-stream",
                    daemon=True)
                self._stream_thread.start()
            self._stream_cond.notify_all()
            return {"ok": True, "seq": seq,
                    "queued": len(self._stream_queue)}

    def close(self):
        """Server shutdown: stop the stream runner, leave the process
        group."""
        with self._stream_cond:
            self._stream_closed = True
            self._stream_cond.notify_all()
        type(self).shutdown()

    def _stream_loop(self):
        """Peer-side stream runner: runs queued steps strictly in
        sequence order. A gap (an announcement lost while later steps
        keep arriving) is announced at its ONSET (the spmd.stream_gap
        event and a collective_stall incident), times out after
        STREAM_GAP_TIMEOUT and resyncs to the lowest queued seq: the
        coordinator's collective for the lost step has failed at the
        group's timeout and fallen back, so skipping it keeps the same
        step order on every process for the steps that did run."""
        from ..utils import flightrec, incident

        while True:
            with self._stream_cond:
                deadline = None
                gap_started = None
                while not self._stream_closed:
                    nxt = self._stream_next
                    if nxt is not None and nxt in self._stream_queue:
                        break
                    if self._stream_queue:
                        now = time.monotonic()
                        if deadline is None:
                            # gap ONSET: later steps queued, the expected
                            # one missing
                            deadline = now + self.STREAM_GAP_TIMEOUT
                            gap_started = now
                            self.gap_onsets += 1
                            flightrec.record(
                                "spmd.stream_gap", expected=nxt,
                                queued=len(self._stream_queue),
                                timeout_seconds=self.STREAM_GAP_TIMEOUT)
                            incident.maybe_trigger(
                                "collective_stall", cause="stream_gap",
                                expected_seq=nxt if nxt is not None
                                else -1,
                                queued=len(self._stream_queue))
                        if now >= deadline:
                            resync = min(self._stream_queue)
                            self.stream_resyncs += 1
                            self.gap_stall_seconds += now - gap_started
                            gap_started = None
                            flightrec.record(
                                "spmd.stream_resync",
                                expected=nxt, resync=resync)
                            self.logger.printf(
                                "spmd: stream gap at seq %s; resyncing "
                                "to %s", nxt, resync)
                            self._stream_next = resync
                            break
                        self._stream_cond.wait(deadline - now)
                    else:
                        deadline = None
                        gap_started = None
                        self._stream_cond.wait(1.0)
                if gap_started is not None:
                    # the gap closed by arrival (or shutdown): account
                    # the time the stream stood blocked on it
                    self.gap_stall_seconds += time.monotonic() \
                        - gap_started
                if self._stream_closed:
                    return
                step = self._stream_queue.pop(self._stream_next)
                self._stream_next += 1
            try:
                with self._lock:
                    # the result is the coordinator's to read
                    self._enter_exit_run(step)
            except Exception as e:  # noqa: BLE001 — keep the runner alive
                # the coordinator saw the same failure in the step's
                # collective; the next step must still run
                self.stream_errors += 1
                self.logger.printf(
                    "spmd: streamed step %s failed on this node: %s",
                    step.get("seq"), e)

    def _run_step_locked(self, step):
        # Every failure past this point still enters the collective
        # (_collective), so no validated peer can leave the others
        # blocked in it. steps_run moves under self._lock.
        idx = self.holder.index(step["index"])
        kind = step.get("kind", "count")
        run = {"count": self._run_count_step,
               "sum": self._run_sum_step,
               "minmax": self._run_minmax_step,
               "topn": self._run_topn_step,
               "groupby": self._run_groupby_step,
               "count_batch": self._run_count_batch_step}.get(kind)
        if run is None:
            raise SpmdError(f"unknown spmd step kind: {kind}")
        return run(idx, step)

    def _local_executor(self):
        """The serving executor (shared by the API), or a private one on
        the port's default device (cuda) for a plane built without an
        API."""
        if self._local_exec is None:
            from ..exec.executor import Executor

            self._local_exec = Executor(self.holder)
        return self._local_exec

    def _engine(self):
        """This rank's ShardedQueryEngine on the serving device, over
        the world group and the data group formed at boot: the steps'
        kernels and their collectives."""
        if self._sharded is None:
            from ..parallel.sharded import ShardedQueryEngine

            self._sharded = ShardedQueryEngine(
                devices=self._local_executor().device,
                data_group=type(self)._data_group)
        return self._sharded

    @property
    def collective_backend(self):
        """"nccl" or "gloo": what this plane's data collectives run over,
        chosen at boot (`form_data_group`)."""
        if self._sharded is not None:
            return self._sharded.collective_backend
        return type(self)._backend

    def _my_shards(self, step):
        seg_len = int(step["seg_len"])
        mine = list(step["segments"].get(self.cluster.local_id, []))
        if len(mine) > seg_len:
            # cannot happen with a correct coordinator; truncate loudly
            # rather than fail the step
            self.logger.printf(
                "spmd: segment length %d exceeds seg_len %d on step %s; "
                "truncating", len(mine), seg_len, step.get("step"))
            mine = mine[:seg_len]
        return seg_len, mine

    def _host_rows(self, idx, step, field_name, row_ids, view_name=None):
        """This rank's host [R, seg_len, W] uint32 block of rows over its
        owned shards, the shards' gathers on the shared worker pool. Zero
        planes for shards, fragments, fields, views — or a whole index —
        this process doesn't hold (count-neutral for every covered op).
        Any other failure raises into the step's failure slot, and the
        coordinator serves the call over HTTP."""
        from ..utils import faultpoints, tracing
        from ..utils.workpool import get_pool

        faultpoints.reached("spmd.gather")
        seg_len, mine = self._my_shards(step)
        out = np.zeros((len(row_ids), seg_len, WORDS_PER_ROW),
                       dtype=np.uint32)
        field = idx.field(field_name) if idx is not None else None
        view = field.view(view_name or VIEW_STANDARD) \
            if field is not None else None
        if view is not None and row_ids:
            def column(j):
                frag = view.fragment(mine[j])
                if frag is None:
                    return
                for i, row_id in enumerate(row_ids):
                    plane = frag.row_plane(row_id)
                    if plane is not None:
                        out[i, j] = np.asarray(plane)

            # no span per shard: a rank gathers hundreds, and a query
            # profile keeps at most 512 spans
            with tracing.with_span(None):
                get_pool().map_ordered(column, range(len(mine)))
        return out

    def _cond_block(self, idx, step, entry):
        """This rank's [seg_len, W] device block of one BSI condition leaf
        (e.g. v > 10), each owned shard evaluated by the executor against
        its LOCAL planes with the shared condition plan (per-node clamping
        to local bit depth is exact for local data). A shard without the
        field's data is a zero plane; a failure raises, as in
        _host_rows."""
        import torch

        from ..exec.bsicond import condition_from_key
        from ..utils import faultpoints

        faultpoints.reached("spmd.gather")
        _, field_name, op, vals = entry
        ex = self._local_executor()
        seg_len, mine = self._my_shards(step)
        out = torch.zeros((seg_len, WORDS_PER_ROW), dtype=torch.int32,
                          device=ex.device)
        call = Call("Row", args={field_name: condition_from_key(op, vals)})
        with self._counting():
            for j, shard in enumerate(mine):
                plane = ex.bitmap_call_shard(idx, call, shard)
                if plane is not None:
                    out[j] = plane
        return out

    def _upload(self, host):
        """Host uint32 words -> int32 tensor on the serving device."""
        import torch

        words = np.ascontiguousarray(host).view(np.int32)
        return torch.from_numpy(words).to(self._local_executor().device)

    def _sync(self):
        dev = self._engine().device
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)

    def _leaf_blocks(self, idx, step):
        """This rank's [seg_len, W] device blocks of a step's plan leaves
        (tagged wire entries: ["row", f, r] | ["bsicond", f, op, vals] |
        ["timerow", f, r, views]), in leaf order, mesh-cache aware:

        - serve on: each leaf probes the mesh cache first; a hit is the
          resident device block, with no gather and no upload (a rank's
          block feeds only its own launch, so per-rank divergence is
          safe). A miss gathers, uploads and fills the cache.
        - serve shadow: the gather serves; each fresh block feeds the
          cache's divergence detector.
        - serve off/http: the gather serves, the cache untouched.

        A condition leaf is built on the card; filling (or probing) the
        cache with it fetches the block once to digest it. Marks
        stack_gather and upload."""
        from .meshstacks import entry_key

        entries = step.get("leaves", [])
        seg_len, mine = self._my_shards(step)
        mode = self.serve_mode
        blocks = [None] * len(entries)
        host = {}
        fill = {}  # leaf position -> (cache key, gens) to put or probe
        for i, entry in enumerate(entries):
            if mode in ("on", "shadow"):
                # gens BEFORE the gather: a write racing it leaves the
                # entry stale, never stale data under fresh gens
                gens = self.mesh_cache.gens(idx, entry, mine)
                if gens is not None:
                    key = (step["index"], entry_key(entry), seg_len,
                           tuple(mine))
                    if mode == "on":
                        hit = self.mesh_cache.get(key, gens)
                        if hit is not None:
                            blocks[i] = hit
                            continue
                    fill[i] = (key, gens)
            if entry[0] == "bsicond":
                blocks[i] = self._cond_block(idx, step, entry)
            elif entry[0] == "timerow":
                # union across the quantum-view cover, on the host
                _, field_name, row_id, views = entry
                acc = None
                for view_name in views:
                    part = self._host_rows(idx, step, field_name,
                                           [int(row_id)], view_name)[0]
                    acc = part if acc is None else acc | part
                if acc is None:
                    acc = np.zeros((seg_len, WORDS_PER_ROW), dtype=np.uint32)
                host[i] = acc
            else:
                _, field_name, row_id = entry
                host[i] = self._host_rows(idx, step, field_name,
                                          [int(row_id)])[0]
        self._mark_phase("stack_gather")
        for i, words in host.items():
            blocks[i] = self._upload(words)
        self._sync()
        for i, (key, gens) in fill.items():
            local = host.get(i)
            if local is None:
                local = blocks[i].cpu().numpy()
            if mode == "on":
                self.mesh_cache.put(key, gens, blocks[i], local)
            else:
                self.mesh_cache.shadow_probe(key, gens, local)
        self._mark_phase("upload")
        return blocks

    def _filter(self, step, blocks):
        """The step's filter plane from its leaf blocks (the single
        node's filter_stack: elementwise ops over the leaves), or None."""
        sig = sig_from_wire(step.get("sig"))
        if sig is None:
            return None
        from ..ops.count_expr import tree_eval

        return tree_eval(sig, blocks)

    def _fetch(self, values, host=False):
        """Wait for the step's launches (device_enter), then copy the
        int64 partial to the host (result_fetch). On an NCCL data group
        the partial stays on the card, for `_collective` to reduce
        there and fetch once, unless `host` asks for it here."""
        self._sync()
        self._mark_phase("device_enter")
        if not host and self.collective_backend == "nccl":
            return values
        out = values.cpu()
        self._mark_phase("result_fetch")
        return out

    @contextmanager
    def _counting(self):
        """Add the kernel launches made inside to `step_launches` (the
        step runs under self._lock, one at a time)."""
        before = _launches()
        try:
            yield
        finally:
            for name, n in _launches().items():
                self.step_launches[name] += n - before[name]

    @contextmanager
    def _dispatch(self, kind, nbytes_in, nbytes_out):
        """The serving evaluator's dispatch lock and accounting around a
        step's launches (family `spmd_<kind>` in /debug/dispatch), their
        kernels counted in `step_launches`."""
        ev = self._local_executor()._stacked
        with ev._locked_dispatch("spmd_" + kind, nbytes_in=nbytes_in,
                                 nbytes_out=nbytes_out) as ph, \
                self._counting():
            yield ph

    @staticmethod
    def _fault_point():
        """`spmd.launch` (utils/faultpoints): an armed `raise` there
        stands for the card failing at the step's launch."""
        from ..utils import faultpoints

        try:
            faultpoints.reached("spmd.launch")
        except faultpoints.FaultInjected as e:
            raise RuntimeError(
                f"spmd step launch failed: CUDA error (injected at {e})") \
                from e

    def _node_slot(self, step):
        nodes = list(step.get("nodes") or self._boot_node_ids)
        return nodes, nodes.index(self.cluster.local_id)

    def _local_or_failure(self, step, local):
        """(host int64 partial, failure code) of this rank's part."""
        from ..ops.cuda_build import is_device_failure

        try:
            return local(), 0
        except Exception as e:
            self.logger.printf("spmd: %s step %s failed on this node: %s",
                               step.get("kind", "count"), step.get("step"),
                               e)
            return None, FAIL_DEVICE if is_device_failure(e) else FAIL_OTHER

    def _raise_failures(self, step, nodes, codes):
        failed = [n for n, c in zip(nodes, codes) if c]
        if not failed:
            return
        kind = step.get("kind", "count")
        on_card = [n for n, c in zip(nodes, codes) if c == FAIL_DEVICE]
        if on_card:
            raise SpmdDeviceFailure(
                f"spmd {kind} step {step.get('step')} failed on the card "
                f"of node {', '.join(on_card)}: CUDA error reported in the "
                "step's failure slot")
        raise SpmdError(f"spmd {kind} step {step.get('step')} failed on "
                        f"node {', '.join(failed)}")

    def _check_seqs(self, step, nodes, seqs):
        """Raise on every rank when the ranks ran different steps: gloo
        matches collectives by call order, not by step, so a rank that
        resynced past a lost announcement could pair its step N + 1 with
        another rank's step N. The sums are then never returned; the
        failure is not the card's, so the coordinator falls back to
        HTTP."""
        mine = int(step.get("step") or 0)
        if all(int(q) == mine for q in seqs):
            return
        self._count("seq_mismatches")
        raise SpmdError(
            f"spmd {step.get('kind', 'count')} step {mine}: the ranks ran "
            f"different steps ({dict(zip(nodes, (int(q) for q in seqs)))}"
            "); the collective paired two steps, its sums are dropped")

    def _collective(self, step, n, local):
        """Run this rank's part `local()` (an int64 tensor [n]) and
        reduce it over the group with two slots per node: the failure
        slots (a rank whose part raised reports its failure code, so
        every rank learns the outcome) and the step slots (each rank's
        step number, checked equal on every rank). Without a data group
        the slots ride the engine's ONE all_reduce after the partial (a
        failed rank contributes zeros). With one, they are voted first
        over the gloo control group, and only a clean vote lets the
        ranks reduce the partial over the data group (on the card for
        NCCL) and fetch it once. Returns the reduced [n] as Python ints,
        or raises the failure on every rank."""
        import torch

        nodes, me = self._node_slot(step)
        vals, code = self._local_or_failure(step, local)
        slots = self._slots(step, nodes, me, code)
        engine = self._engine()
        if engine.data_group is None:
            if vals is None:
                vals = torch.zeros(n, dtype=torch.int64)
            sums, tail = engine._all_reduce(vals, extra=slots)
            self._mark_phase("psum")
            self.steps_run += 1
            self._check_slots(step, nodes, me, engine, tail.tolist())
            return sums.tolist()
        self._vote(step, nodes, me, engine, slots)
        sums = engine._data_reduce(vals)
        self._mark_phase("psum")
        out = sums.cpu()
        self._mark_phase("result_fetch")
        return out.tolist()

    @staticmethod
    def _slots(step, nodes, me, code):
        """This rank's failure slots (its code at its node's place) and
        step slots (its step number there), one int64 each a node."""
        import torch

        slots = torch.zeros(2 * len(nodes), dtype=torch.int64)
        slots[me] = code
        slots[len(nodes) + me] = int(step.get("step") or 0)
        return slots

    def _vote(self, step, nodes, me, engine, slots):
        """Phase 1 on a data group: the failure and step slots summed
        over the gloo control group (host int64); a failure or a step
        mismatch raises on every rank here, so no rank enters the data
        collective."""
        tail = engine.vote(slots).tolist()
        self.steps_run += 1
        self._check_slots(step, nodes, me, engine, tail)

    def _check_slots(self, step, nodes, me, engine, tail):
        """Raise on a step mismatch or a failure in the reduced slots. A
        group of one (no process group) reduces nothing: only this
        rank's own slots carry anything."""
        self._check_seqs(step, nodes, tail[len(nodes):]
                         if engine.n_ranks > 1 else [tail[len(nodes) + me]])
        self._raise_failures(step, nodes, tail[:len(nodes)])

    def _gather_collective(self, step, n, local):
        """Like _collective, but ONE all_gather: every rank's [n] partial
        beside its node slot (and, without a data group, its failure
        code and step number), in node order. With a data group the
        slots are voted first, as in _collective, and the rows gathered
        over the data group (on the card for NCCL) and fetched once."""
        import torch

        nodes, me = self._node_slot(step)
        vals, code = self._local_or_failure(step, local)
        engine = self._engine()
        if engine.data_group is None:
            row = torch.zeros(n + 3, dtype=torch.int64)
            if vals is not None:
                row[:n] = vals.reshape(-1)
            row[n] = code
            row[n + 1] = me
            row[n + 2] = int(step.get("step") or 0)
            rows = engine._all_gather(row)
            self._mark_phase("psum")
            self.steps_run += 1
            self._check_seqs(step, nodes, [int(r[n + 2]) for r in rows])
            by_node = {int(r[n + 1]): r.tolist() for r in rows}
            codes = [by_node.get(i, [0] * (n + 1))[n]
                     for i in range(len(nodes))]
            self._raise_failures(step, nodes, codes)
            return [by_node[i][:n] for i in sorted(by_node)]
        self._vote(step, nodes, me, engine,
                   self._slots(step, nodes, me, code))
        rows = engine._all_gather(torch.cat([
            vals.reshape(-1).to(torch.int64),
            torch.tensor([me], dtype=torch.int64)]))
        self._mark_phase("psum")
        rows = rows.cpu()
        self._mark_phase("result_fetch")
        by_node = {int(r[n]): r[:n].tolist() for r in rows}
        return [by_node[i] for i in sorted(by_node)]

    def _run_count_step(self, idx, step):
        """K1 over the leaves' blocks (count_expr, fit past K1's limits),
        one all_reduce."""
        def local():
            sig = sig_from_wire(step["sig"])
            blocks = self._leaf_blocks(idx, step)
            with self._dispatch("count", sum(b.numel() for b in blocks) * 4,
                                8) as ph:
                self._fault_point()
                total = self._engine().count_partial(sig, blocks)
                ph.mark("dispatch_ack")
            return self._fetch(total)

        return self._collective(step, 1, local)[0]

    def _run_count_batch_step(self, idx, step):
        """K Count plans in ONE step: every distinct leaf of the plans
        gathered (or served from the mesh cache) once, ONE K1 launch over
        all K trees (the engine's count_batch_partial: the batched entry
        for one signature, the multi-tree entry for mixed ones), ONE
        all_reduce of the [K] counts — the counterpart of the TPU
        package's _count_batch_fn and its one [2, K] reduce."""
        from .meshstacks import entry_key

        plans = step["plans"]
        k = len(plans)
        fn_key = self._program_key(step)

        def local():
            sigs = list(fn_key[1])
            order, slot = [], {}
            for plan in plans:
                for entry in plan["leaves"]:
                    ek = entry_key(entry)
                    if ek not in slot:
                        slot[ek] = len(order)
                        order.append(entry)
            blocks = self._leaf_blocks(idx, dict(step, leaves=order))
            members = [[blocks[slot[entry_key(e)]] for e in plan["leaves"]]
                       for plan in plans]
            program = self._program(fn_key)
            n_in = sum(b.numel() for b in blocks) * 4
            with self._dispatch("count_batch", n_in, 8 * k) as ph:
                self._fault_point()
                counts = self._engine().count_batch_partial(
                    sigs, members, program=program)
                ph.mark("dispatch_ack")
            return self._fetch(counts)

        out = self._collective(step, k, local)
        self.batch_steps += 1
        return out

    def _bsi_blocks(self, idx, step):
        """(planes [D, seg_len, W], sign, exists, filter or None) device
        blocks of a sum/minmax step. Zero-extension to the cluster-wide
        max depth is exact (absent planes add 0 to every count); at least
        one magnitude plane keeps the stack non-empty."""
        from ..core.fragment import (BSI_EXISTS_BIT, BSI_OFFSET_BIT,
                                     BSI_SIGN_BIT)

        depth = max(1, int(step["depth"]))
        rows = [BSI_EXISTS_BIT, BSI_SIGN_BIT] \
            + [BSI_OFFSET_BIT + i for i in range(depth)]
        host = self._host_rows(idx, step, step["field"], rows,
                               VIEW_BSI_GROUP_PREFIX + step["field"])
        blocks = self._leaf_blocks(idx, step)  # marks the gather/upload
        dev = self._upload(host)
        self._sync()
        self._mark_phase("upload")
        return dev[2:], dev[1], dev[0], self._filter(step, blocks)

    def _run_sum_step(self, idx, step):
        """K3 three times (the engine's sum_partial: per-plane positive
        and negative counts, the consider count), ONE all_reduce of the
        [2D + 1] counts, the engine's signed fold."""
        depth = max(1, int(step["depth"]))

        def local():
            planes, sign, exists, filt = self._bsi_blocks(idx, step)
            n_in = (planes.numel() + 2 * sign.numel()
                    + (0 if filt is None else filt.numel())) * 4
            with self._dispatch("sum", n_in, 8 * (2 * depth + 1)) as ph:
                self._fault_point()
                counts = self._engine().sum_partial(planes, sign, exists,
                                                    filt)
                ph.mark("dispatch_ack")
            return self._fetch(counts)

        return self._engine().sum_fold(
            self._collective(step, 2 * depth + 1, local), depth)

    def _run_minmax_step(self, idx, step):
        """Each rank's Min/Max over its shards (exec.stacked.minmax_walk,
        the single node's walk, its count with K3), ONE all_gather of
        (non-empty, negative, magnitude, count), then `combine_minmax`.
        Returns (empty, negative, magnitude, count)."""
        is_max = bool(step["is_max"])

        def local():
            import torch

            from ..exec.stacked import minmax_decode, minmax_walk

            planes, sign, exists, filt = self._bsi_blocks(idx, step)
            n_in = (planes.numel() + 2 * sign.numel()
                    + (0 if filt is None else filt.numel())) * 4
            with self._dispatch("minmax", n_in, 8 * (planes.shape[0] + 3)) \
                    as ph:
                self._fault_point()
                walk = minmax_walk(planes, sign, exists, filt, is_max)
                ph.mark("dispatch_ack")
            nonempty, use_neg, mag, count = minmax_decode(
                self._fetch(walk, host=True).tolist())
            return torch.tensor([int(nonempty), int(use_neg), mag, count],
                                dtype=torch.int64)

        return combine_minmax(self._gather_collective(step, 4, local),
                              is_max)

    def _row_chunk(self, step):
        """Rows per gathered [R, seg_len, W] chunk under CHUNK_BYTES."""
        from ..exec.stacked import CHUNK_BYTES

        return max(1, CHUNK_BYTES // (int(step["seg_len"])
                                      * WORDS_PER_ROW * 4))

    def _rows_counts(self, idx, step, kind, field_name, rows, filt):
        """K3 over `rows` of a field, chunk by chunk (each gathered,
        uploaded and counted against `filt`): a device int64 [R]."""
        import torch

        flat = None if filt is None else filt.reshape(-1)
        chunk = self._row_chunk(step)
        counts = []
        for i in range(0, len(rows), chunk):
            part = rows[i:i + chunk]
            host = self._host_rows(idx, step, field_name, part)
            self._mark_phase("stack_gather")
            block = self._upload(host).reshape(len(part), -1)
            self._sync()
            self._mark_phase("upload")
            n_in = (block.numel() + (0 if flat is None else flat.numel())) * 4
            with self._dispatch(kind, n_in, 8 * len(part)) as ph:
                self._fault_point()
                counts.append(self._engine().row_counts_partial(block,
                                                                flat))
                ph.mark("dispatch_ack")
        return torch.cat(counts)

    def _run_topn_step(self, idx, step):
        """Candidate-row counts: K3 over [rows, seg_len, W] chunks with
        the filter (reference per-shard scan: fragment.top
        fragment.go:1570; the heap merge becomes the all_reduce)."""
        rows = [int(r) for r in step["rows"]]

        def local():
            filt = self._filter(step, self._leaf_blocks(idx, step))
            return self._fetch(self._rows_counts(
                idx, step, "topn", step["field"], rows, filt))

        return self._collective(step, len(rows), local)

    def _run_groupby_step(self, idx, step):
        """Cross-product counts in itertools.product order: K3 with the
        filter for one field; for more, K4 over the last two fields'
        rows, once per combination of the outer fields' rows intersected
        into the filter (the executor's recursion). ONE all_reduce of
        the [C] cells."""
        fields = list(step["fields"])
        rows = [[int(r) for r in rs] for rs in step["rows"]]
        cells = 1
        for rs in rows:
            cells *= len(rs)

        def local():
            filt = self._filter(step, self._leaf_blocks(idx, step))
            if len(fields) == 1:
                return self._fetch(self._rows_counts(
                    idx, step, "groupby", fields[0], rows[0], filt))
            return self._fetch(self._groupby_cells(
                idx, step, fields, rows, filt, cells))

        return self._collective(step, cells, local)

    def _groupby_cells(self, idx, step, fields, rows, filt, cells):
        """K4 per combination of the outer fields' rows: the [C] cells
        on the device. Every field's rows are gathered and uploaded
        once for the whole step (the last two in row chunks)."""
        import torch

        dev = self._local_executor().device
        out = torch.zeros(cells, dtype=torch.int64, device=dev)
        outer = []
        for field_name, rs in zip(fields[:-2], rows[:-2]):
            outer.append(self._upload(self._host_rows(idx, step, field_name,
                                                      rs)))
        (a_field, b_field), (a_rows, b_rows) = fields[-2:], rows[-2:]
        chunk = self._row_chunk(step)

        def tiles(field_name, rs):
            return [(i, part, self._upload(self._host_rows(
                idx, step, field_name, part)).reshape(len(part), -1))
                for i in range(0, len(rs), chunk)
                for part in [rs[i:i + chunk]]]

        a_tiles, b_tiles = tiles(a_field, a_rows), tiles(b_field, b_rows)
        self._mark_phase("stack_gather")
        block = len(a_rows) * len(b_rows)
        for c, combo in enumerate(itertools.product(
                *[range(len(rs)) for rs in rows[:-2]])):
            f = filt
            for blocks, r in zip(outer, combo):
                f = blocks[r] if f is None else f & blocks[r]
            flat = None if f is None else f.reshape(-1)
            mat = torch.zeros((len(a_rows), len(b_rows)), dtype=torch.int64,
                              device=dev)
            for i, a_part, a in a_tiles:
                for j, b_part, b in b_tiles:
                    n_in = (a.numel() + b.numel()
                            + (0 if flat is None else flat.numel())) * 4
                    with self._dispatch("groupby", n_in,
                                        8 * len(a_part) * len(b_part)) as ph:
                        self._fault_point()
                        mat[i:i + len(a_part), j:j + len(b_part)] = \
                            self._engine().pairwise_partial(a, b, flat)
                        ph.mark("dispatch_ack")
            out[c * block:(c + 1) * block] = mat.reshape(-1)
        return out

    def stats(self):
        """GET /internal/spmd/stats: the TPU package's keys, the port's
        declines by reason, card failures and step-number mismatches,
        this process's kernel launch counters (`launches`) and the
        launches its steps made (`step_launches`)."""
        return {"steps": self.steps_run,
                "initialized": type(self)._initialized,
                "collective_backend": self.collective_backend,
                "serve_mode": self.serve_mode,
                "validations": self.validations,
                "validations_skipped": self.validations_skipped,
                "forwarded": self.forwarded,
                "forward_errors": self.forward_errors,
                "fallbacks": self.fallbacks,
                "batch_steps": self.batch_steps,
                "batched_queries": self.batched_queries,
                "fused_steps": self.fused_steps,
                "fused_queries": self.fused_queries,
                "declined": dict(self.declined),
                "device_failures": self.device_failures,
                "seq_mismatches": self.seq_mismatches,
                "launches": _launches(),
                "step_launches": dict(self.step_launches)}

    def _counters(self):
        """The step-lifecycle and query counters of /debug/spmd and the
        /status roll-up."""
        return {
            "steps": {
                "run": self.steps_run,
                "announced": self.steps_announced,
                "entered": self.steps_entered,
                "exited": self.steps_exited,
                "last_seq": self.last_seq,
                "batch": self.batch_steps,
                "fused": self.fused_steps,
            },
            "queries": {
                "batched": self.batched_queries,
                "fused": self.fused_queries,
                "forwarded": self.forwarded,
                "fallbacks": self.fallbacks,
            },
        }

    def debug_snapshot(self):
        """GET /debug/spmd: serve mode and mesh shape, the step-lifecycle
        counters (announced vs entered vs exited per node), stream state,
        the observatory's counters, mesh-cache stats, and the HTTP
        data-plane byte counter (flat while collectives serve)."""
        from ..server import client as client_mod

        with self._stream_cond:
            stream = {
                "next": self._stream_next,
                "queued": len(self._stream_queue),
                "errors": self.stream_errors,
                "resyncs": self.stream_resyncs,
            }
        try:
            mesh = self.mesh_shape()
        except Exception:  # noqa: BLE001 — no group yet
            mesh = None
        return {
            "serve_mode": self.serve_mode,
            "initialized": type(self)._initialized,
            "mesh": mesh,
            **self._counters(),
            "stream": stream,
            "stream_gap_timeout": self.STREAM_GAP_TIMEOUT,
            "observatory": self.observatory_stats(),
            "mesh_cache": self.mesh_cache.stats(),
            "http_data_plane_bytes": client_mod.data_plane_bytes(),
        }

    # -- the observatory (read side) ------------------------------------------

    def observatory_stats(self):
        """Compact observatory counters (no ring contents): per-phase
        totals, stream occupancy, gap and straggler tallies."""
        with self._obs_lock:
            totals = {p: {"count": c, "seconds": round(sec, 6)}
                      for p, (c, sec) in self._phase_totals.items()}
            ring = len(self._step_ring)
        return {
            "steps_recorded": ring,
            "ring_size": self.STEP_RING_SIZE,
            "phase_totals": totals,
            "occupancy": self.occupancy(),
            "straggler_flags": self.straggler_flags_total,
        }

    def occupancy(self):
        """Step-stream occupancy: queue depth, how far this node's
        execution lags the highest announced seq it has seen, and the
        time the runner stood blocked on sequence gaps."""
        with self._stream_cond:
            queued = len(self._stream_queue)
            head = max(self._stream_queue) if self._stream_queue else None
            nxt = self._stream_next
        return {
            "queue_depth": queued,
            "seq_lag": max(0, (head or self.last_seq) - self.last_seq),
            "stream_next": nxt,
            "last_seq": self.last_seq,
            "gap_onsets": self.gap_onsets,
            "gap_stall_seconds": round(self.gap_stall_seconds, 6),
        }

    def register_gauges(self):
        """Scrape-time stream-occupancy gauges on the process-global stats
        client (called once by the server command, not by __init__, so
        short-lived planes in tests leave no gauge closures behind)."""
        from ..utils.stats import global_stats

        if not hasattr(global_stats, "gauge_fn"):
            return
        global_stats.gauge_fn(
            "spmd_stream_queue_depth",
            lambda: len(self._stream_queue))
        global_stats.gauge_fn(
            "spmd_stream_seq_lag",
            lambda: max(0, (max(self._stream_queue)
                            if self._stream_queue else self.last_seq)
                        - self.last_seq))
        global_stats.gauge_fn(
            "spmd_stream_gap_stall_seconds",
            lambda: self.gap_stall_seconds)

    def _local_node_id(self):
        if self.cluster is not None:
            return self.cluster.local_id
        return "local"

    def steps_local(self, seq=None, limit=None):
        """This node's slice of the step timeline (what the coordinator
        fans out for with ?local=true): recent step records with
        per-phase walls, stamped with this node's wall clock so the
        caller can skew-correct from the RPC envelope."""
        with self._obs_lock:
            steps = list(self._step_ring)
        if seq is not None:
            steps = [r for r in steps if r["seq"] == seq]
        elif limit is not None and limit > 0:
            steps = steps[-int(limit):]
        return {
            "node": self._local_node_id(),
            "time": time.time(),
            "steps": steps,
            "occupancy": self.occupancy(),
        }

    def steps_timeline(self, seq=None, limit=32, local_only=False):
        """GET /debug/spmd/steps[/{seq}]: the cross-node step timeline.

        Fans out to the peers for their local slices (?local=true),
        estimates each peer's clock offset from the RPC envelope
        (envelope_skew), shifts every peer's step starts onto this node's
        clock, and merges per seq into one timeline with per-phase
        straggler attribution. Straggler flags are edge-triggered: each
        (seq, node, phase) counts toward
        spmd_step_straggler_total{node,phase} and fires the
        spmd.straggler event exactly once, however often the timeline is
        scraped."""
        local_id = self._local_node_id()
        payloads = {local_id: (self.steps_local(seq=seq, limit=limit),
                               0.0)}
        if not local_only and self.cluster is not None \
                and len(self.cluster.nodes) > 1:
            from ..utils import tracing

            with tracing.with_span(None):  # debug plumbing: never traced
                for node in self.cluster.peers():
                    try:
                        client = self.client_factory(node.uri)
                        t_send = time.time()
                        remote = client.debug_spmd_steps(seq=seq,
                                                         limit=limit)
                        t_recv = time.time()
                    except Exception:  # noqa: BLE001 — best effort
                        continue
                    if not remote or remote.get("steps") is None:
                        continue
                    theta = envelope_skew(
                        t_send, t_recv,
                        float(remote.get("time") or t_recv))
                    payloads[remote.get("node", node.id)] = (remote,
                                                             theta)
        merged = {}
        for node, (payload, theta) in payloads.items():
            for rec in payload.get("steps", []):
                st = merged.setdefault(rec["seq"], {
                    "seq": rec["seq"],
                    "kind": rec.get("kind", "count"),
                    "index": rec.get("index", ""),
                    "peers": {},
                })
                if rec.get("trace") and not st.get("trace"):
                    st["trace"] = rec["trace"]
                st["peers"][node] = {
                    # the peer's wall-clock start shifted onto OUR clock
                    "start": round(rec["start"] - theta, 6),
                    "wall_seconds": rec["wall_seconds"],
                    "phases": rec.get("phases", {}),
                    "ok": rec.get("ok", True),
                }
        steps = [merged[k] for k in sorted(merged)]
        for st in steps:
            st["stragglers"] = attribute_stragglers(
                {n: p["phases"] for n, p in st["peers"].items()},
                self.STRAGGLER_FACTOR, self.STRAGGLER_NOISE_FLOOR)
            self._flag_stragglers(st["seq"], st["stragglers"])
        return {
            "node": local_id,
            "skew_seconds": {n: round(th, 6)
                             for n, (_, th) in payloads.items()},
            "straggler_factor": self.STRAGGLER_FACTOR,
            "noise_floor_seconds": self.STRAGGLER_NOISE_FLOOR,
            "steps": steps,
        }

    def _flag_stragglers(self, seq, flags):
        """Edge-triggered straggler accounting (see steps_timeline)."""
        if not flags:
            return
        from ..utils import flightrec
        from ..utils.stats import global_stats

        for flag in flags:
            key = (seq, flag["node"], flag["phase"])
            with self._obs_lock:
                if key in self._straggler_flags:
                    continue
                self._straggler_flags[key] = 1
                while len(self._straggler_flags) \
                        > self.STRAGGLER_FLAGS_MAX:
                    self._straggler_flags.popitem(last=False)
                self.straggler_flags_total += 1
            try:
                global_stats.count(
                    "spmd_step_straggler_total",
                    tags={"node": str(flag["node"]),
                          "phase": flag["phase"]})
            except Exception:  # noqa: BLE001
                pass
            flightrec.record(
                "spmd.straggler", seq=seq, node=str(flag["node"]),
                phase=flag["phase"], ratio=flag.get("ratio") or 0,
                seconds=flag["seconds"])

    def summary(self):
        """Compact roll-up for /status?observability=true: serve mode,
        step-lifecycle counters, stream health, mesh-cache stats."""
        occ = self.occupancy()
        counters = self._counters()
        counters["steps"].pop("run")
        return {
            "serve_mode": self.serve_mode,
            **counters,
            "stream": {
                "errors": self.stream_errors,
                "resyncs": self.stream_resyncs,
                "queue_depth": occ["queue_depth"],
                "seq_lag": occ["seq_lag"],
                "gap_onsets": occ["gap_onsets"],
                "gap_stall_seconds": occ["gap_stall_seconds"],
            },
            "straggler_flags": self.straggler_flags_total,
            "mesh_cache": self.mesh_cache.stats(),
        }

    def incident_snapshot(self):
        """Postmortem-bundle payload (utils/incident.py `spmd`
        collector): the debug snapshot, this node's step ring and, best
        effort, the merged cross-node timeline — captured while a
        collective_stall is still open, so the bundle shows WHERE every
        peer was when the stream wedged."""
        snap = self.debug_snapshot()
        snap["steps_local"] = self.steps_local(limit=64)
        try:
            snap["timeline"] = self.steps_timeline(limit=16)
        except Exception as e:  # noqa: BLE001 — never fail the bundle
            snap["timeline_error"] = str(e)
        return snap


class SpmdBatchRunner:
    """The coalescer's adapter on a mesh-serving cluster coordinator: it
    presents Executor.launch_batch/resolve_batch's (handle, state) ->
    [(results, error, batch_size)] contract, but resolves
    eligible Count batches as ONE collective step
    (SpmdDataPlane.maybe_execute_batch) instead of local batched
    launches: one announcement, one K1 launch a rank, one all_reduce for
    K queries. Launch is deliberately cheap: the collective IS the
    batched launch, so the coalescer's double buffering degenerates to
    serial resolution without waste. A batch the plane declines, or a
    non-card failure, re-runs per member on the ordinary cluster path
    (per-query error isolation); a card failure fails every member of
    the batch with the same error (a 500 naming the node), never re-run
    over HTTP (trap 30)."""

    #: what server.api._try_coalesce admits on a cluster coordinator:
    #: only Count merges collectively
    BATCHABLE_CALLS = frozenset(("Count",))

    def __init__(self, api):
        self.api = api
        self.spmd = api.spmd

    def launch_batch(self, index_name, queries, shards=None,
                     options=None):
        return None, (index_name, list(queries))

    def resolve_batch(self, handle, state):
        import copy

        from ..exec.executor import validate_uint_args
        from ..exec.stacked import BATCH_BUCKETS
        from ..exec.translate import translate_calls, translate_results
        from ..utils import workload as workload_mod

        index_name, queries = state
        executor = self.api.executor
        idx = executor.holder.index(index_name)
        entries = []
        for query in queries:
            # e["raw"] is the untranslated form every fallback re-runs:
            # translation mutates the call tree in place
            e = {"query": query, "raw": query, "error": None,
                 "eligible": False, "out": None}
            entries.append(e)
            if idx is None:
                e["error"] = SpmdError(f"index not found: {index_name}")
                continue
            try:
                if isinstance(query, str):
                    query = e["query"] = parse(query)
                calls = query.calls
                if len(calls) == 1 and calls[0].name == "Count" \
                        and len(calls[0].children) == 1 \
                        and not calls[0].writes():
                    if not isinstance(e["raw"], str):
                        e["raw"] = copy.deepcopy(query)
                    translate_calls(idx, query.calls)
                    validate_uint_args(calls[0])
                    e["eligible"] = True
            except Exception as exc:  # noqa: BLE001 — per-query isolation
                e["error"] = exc
        eligible = [e for e in entries
                    if e["eligible"] and e["error"] is None]
        if eligible:
            cluster_shards = executor.cluster_shards(idx)
            cap = BATCH_BUCKETS[-1]
            for i in range(0, len(eligible), cap):
                chunk = eligible[i:i + cap]
                calls = [e["query"].calls[0] for e in chunk]
                t0 = time.perf_counter()
                try:
                    used, counts = self.spmd.maybe_execute_batch(
                        idx, calls, cluster_shards)
                except Exception as exc:  # noqa: BLE001 — a card failure
                    for e in chunk:
                        e["out"] = (None, exc, 0)
                    continue
                if not used:
                    continue  # the whole chunk re-runs per query below
                wall = time.perf_counter() - t0
                k = len(chunk)
                for j, (e, count) in enumerate(zip(chunk, counts)):
                    try:
                        wctx = workload_mod.begin_query(
                            idx.name, e["query"])
                        wctx.strategies.append("Count=spmd-collective")
                        workload_mod.note_batch(k)
                        # the step's one launch is charged to exactly ONE
                        # member
                        workload_mod.end_query(wctx, wall / k, deltas={
                            "dispatches": 1 if j == 0 else 0,
                            "cache_hits": 0, "cache_misses": 0,
                            "bytes_materialized": 0})
                        results = translate_results(
                            idx, e["query"].calls, [int(count)])
                        e["out"] = (results, None, k)
                    except Exception as exc:  # noqa: BLE001
                        e["out"] = (None, exc, 0)
        outs = []
        for e in entries:
            if e["out"] is not None:
                outs.append(e["out"])
            elif e["error"] is not None:
                outs.append((None, e["error"], 0))
            else:
                try:
                    outs.append((executor.execute(index_name, e["raw"]),
                                 None, 0))
                except Exception as exc:  # noqa: BLE001
                    outs.append((None, exc, 0))
        return outs
