"""Cross-node query execution: mapReduce over the cluster.

Reference: executor.mapReduce (executor.go:2455) — shards are grouped by
primary owner (shardsByNode), local shards run on this node's devices,
remote groups are forwarded as `Remote:true` queries with an explicit shard
list (remoteExec executor.go:2414), and responses reduce as they arrive
(:2483-2503) with failed nodes' shards retried on their replicas.

Writes route differently: Set/Clear target every replica of the owning
shard (executor.go:2137-2160), attribute writes fan out to all nodes
(attrs are stored on every node), and schema DDL is broadcast by the API
layer before any of this runs.

Here "local shards" means the shards this node serves from its own card:
the local reduce happens inside the node's kernel launches
(exec.Executor), and only per-node partial results cross HTTP (protobuf
by default, JSON with PILOSA_TPU_INTERNAL_WIRE=json).

Failover is for peers only. A remote leg that fails (a dead, paused or
unready peer) is retried on the shard's next replica, and every such
retry is counted (`leg_retries`, a `cluster.leg_retry` flight-recorder
event). A LOCAL leg that fails because of this node's card
(`cuda_build.is_device_failure`) is never retried on a peer: it
propagates out of the query, so a failing card is seen, not hidden
behind another process.

With a collective data plane (cluster/spmd.py, `server --spmd`),
coverable Count, Sum, Min/Max, TopN and GroupBy calls merge over the
process group instead (`maybe_execute`); anything it declines takes the
HTTP map-reduce below. Under `--spmd-serve on` with `--fusion on`, a
whole multi-Count query runs as one collective step
(`maybe_execute_fused`).
"""

import os
import threading
import time as _time

from ..core.row import Row
from ..exec.executor import ExecOptions, Executor
from ..ops.cuda_build import is_device_failure
from ..exec.result import FieldRow, GroupCount, Pair, RowIdentifiers, ValCount
from ..pql import call_to_pql, parse
from ..shardwidth import SHARD_WIDTH
from ..utils.workpool import get_pool


class ClusterExecError(Exception):
    pass


# ---------------------------------------------------------------- decoding

def _internal_wire():
    """Node-to-node encoding: "proto" (default) or "json". Unknown values
    fail fast rather than silently selecting proto."""
    wire = os.environ.get("PILOSA_TPU_INTERNAL_WIRE", "proto").lower()
    if wire not in ("proto", "json"):
        raise ClusterExecError(
            f"PILOSA_TPU_INTERNAL_WIRE must be 'proto' or 'json', "
            f"got {wire!r}")
    return wire


def result_from_json(d):
    """Decode one remote result by JSON shape (the reference decodes by
    protobuf type tag, http/client.go QueryResponse)."""
    if d is None or isinstance(d, (bool, int, float, str)):
        return d
    if isinstance(d, dict):
        if "columns" in d or "keys" in d and "rows" not in d:
            row = Row.from_columns(d.get("columns", []))
            row.attrs = d.get("attrs") or None
            row.keys = d.get("keys")
            return row
        if "rows" in d:
            return RowIdentifiers(rows=d.get("rows", []), keys=d.get("keys"))
        if "value" in d and "count" in d:
            return ValCount(d["value"], d["count"])
        if "id" in d and "count" in d:
            return Pair(d["id"], d["count"], key=d.get("key"))
        raise ClusterExecError(f"undecodable result dict: {d!r}")
    if isinstance(d, list):
        if not d:
            return []
        if isinstance(d[0], dict) and "group" in d[0]:
            return [
                GroupCount(
                    [FieldRow(fr["field"], fr.get("rowID", 0),
                              row_key=fr.get("rowKey"))
                     for fr in gc["group"]],
                    gc["count"])
                for gc in d
            ]
        if isinstance(d[0], dict) and "id" in d[0]:
            return [Pair(p["id"], p["count"], key=p.get("key")) for p in d]
        raise ClusterExecError(f"undecodable result list: {d!r}")
    raise ClusterExecError(f"undecodable result: {d!r}")


# ---------------------------------------------------------------- reduction

def reduce_results(call, a, b):
    """Merge two per-node partial results for one call (reference: the
    reduceFn closures in executor.go per call type)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, bool):
        return a or b
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return a + b
    if isinstance(a, Row):
        return a.merge(b)
    if isinstance(a, ValCount):
        if call.name == "Min":
            return a.smaller(b)
        if call.name == "Max":
            return a.larger(b)
        return a.add(b)  # Sum
    if isinstance(a, Pair):  # MinRow/MaxRow
        if a.id == b.id:
            return Pair(a.id, a.count + b.count, key=a.key)
        if call.name == "MaxRow":
            return a if a.id > b.id else b
        return a if a.id < b.id else b
    if isinstance(a, RowIdentifiers):
        merged = sorted(set(a.rows) | set(b.rows))
        return RowIdentifiers(rows=merged)
    if isinstance(a, list):
        if not a:
            return b
        if not b:
            return a
        if isinstance(a[0], Pair):  # TopN partials (Pairs.Add cache.go:356)
            counts = {}
            for p in a + b:
                counts[p.id] = counts.get(p.id, 0) + p.count
            out = [Pair(id, cnt) for id, cnt in counts.items()]
            out.sort(key=lambda p: (-p.count, p.id))
            return out
        if isinstance(a[0], GroupCount):
            totals = {}
            for gc in a + b:
                key = tuple((fr.field, fr.row_id) for fr in gc.group)
                if key in totals:
                    totals[key] = GroupCount(gc.group,
                                             totals[key].count + gc.count)
                else:
                    totals[key] = gc
            return [totals[k] for k in sorted(totals)]
        raise ClusterExecError(f"unreducible list result: {type(a[0])}")
    raise ClusterExecError(f"unreducible result type: {type(a)}")


def finalize_result(call, result):
    """Apply coordinator-side trims that remote partials skipped."""
    if call.name == "Options" and call.children:
        return finalize_result(call.children[0], result)
    if isinstance(result, list) and result and isinstance(result[0], Pair):
        n = call.args.get("n")
        if call.name == "TopN" and n is not None \
                and call.args.get("ids") is None:
            return result[:int(n)]
    if isinstance(result, list) and result \
            and isinstance(result[0], GroupCount):
        limit = call.args.get("limit")
        if limit is not None:
            result = result[:int(limit)]
        # offset applies AFTER the limit-bounded merge and is a NO-OP when
        # it reaches past the result set — this matches the reference's
        # effective behavior (`offset < len(results)` guard after the
        # limit-bounded merge, executeGroupBy executor.go:1134-1149), NOT
        # SQL's offset-then-limit; keep in sync with the local-executor
        # copy (exec/executor.py _exec_group_by).
        offset = call.args.get("offset")
        if offset is not None and int(offset) < len(result):
            result = result[int(offset):]
        return result
    if isinstance(result, RowIdentifiers):
        limit = call.args.get("limit")
        if limit is not None and result.keys is None:
            result.rows = result.rows[:int(limit)]
    return result


# ---------------------------------------------------------------- executor

class ClusterExecutor:
    """Coordinating executor: local device execution + remote fan-out.

    Wraps exec.Executor on `device`. With a single-node cluster (or
    none) it degrades to purely local execution."""

    #: what the query coalescer may batch THROUGH a cluster coordinator:
    #: only Count (the collective plane's batch step, with mesh-resident
    #: serving); the local Executor's wider set applies on single nodes
    #: and fan-out legs
    BATCHABLE_CALLS = frozenset(("Count",))

    def __init__(self, holder, cluster, client_factory, device=None,
                 logger=None, max_writes_per_request=0, spmd=None):
        from ..utils.logger import NopLogger

        self.holder = holder
        self.cluster = cluster
        self.client_factory = client_factory
        self.spmd = spmd
        self.logger = logger or NopLogger()
        self.local = Executor(
            holder, device=device,
            max_writes_per_request=max_writes_per_request)
        # remote legs re-run on another replica (or, for a shedding
        # peer, on the same one): every retry counts here
        self._stats_lock = threading.Lock()
        self.leg_retries = 0

    @property
    def device(self):
        return self.local.device

    def stats(self):
        """The fan-out's counters (`/status`'s `cluster` block)."""
        with self._stats_lock:
            return {"leg_retries": self.leg_retries}

    def _note_retry(self, node, error, index):
        from ..utils import flightrec
        from ..utils.stats import global_stats

        with self._stats_lock:
            self.leg_retries += 1
        global_stats.count("cluster_leg_retries")
        flightrec.record("cluster.leg_retry", node=node.id, index=index,
                         error=str(error)[:200])

    # -- public entry --------------------------------------------------------

    def execute(self, index_name, query, shards=None, options=None):
        idx = self.holder.index(index_name)
        if idx is None:
            raise ClusterExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = parse(query)
        opt = options or ExecOptions()
        from ..exec.executor import check_write_limit

        check_write_limit(query, self.local.max_writes_per_request)

        if self.cluster is None or len(self.cluster.nodes) <= 1 or opt.remote:
            # single-node, or we ARE the remote: pure local execution
            return self.local.execute(index_name, query, shards=shards,
                                      options=opt)

        from ..exec.executor import validate_uint_args
        from ..exec.translate import translate_calls, translate_results

        translate_calls(idx, query.calls)
        # negative-arg rejection AFTER translation (keyed args become
        # ints) and before any fan-out, so a bad argument is one error,
        # not one per node
        for c in query.calls:
            validate_uint_args(c)
        # fetch the cluster-wide shard list ONCE per query, not per call
        if shards is None and any(not c.writes() for c in query.calls):
            shards = self.cluster_shards(idx)

        explain = getattr(opt, "explain", None)
        if explain == "plan":
            return self._explain_cluster_plan(idx, query, shards, opt)

        # The coordinator fingerprints the whole query; remote legs
        # carry opt.remote so they never record themselves, and local
        # legs go through execute_call (not execute), so this is the
        # single recording site for a fanned-out query.
        from ..utils import workload as workload_mod

        wctx = workload_mod.begin_query(idx.name, query)
        before = self.local._stacked.counters()
        t_query = _time.perf_counter()
        try:
            plan_calls = [] if explain == "analyze" else None
            # the fused collective step (mesh serving + fusion on): the
            # WHOLE multi-call Count query runs as one step, one K1
            # launch a rank, zero result bytes over HTTP. A decline (a
            # cold fingerprint, an uncoverable tree, a degraded cluster)
            # falls through to the per-call loop; a card failure raises.
            if self.spmd is not None and plan_calls is None \
                    and all(not c.writes() for c in query.calls):
                used, counts = self.spmd.maybe_execute_fused(
                    idx, query, shards)
                if used:
                    return translate_results(idx, query.calls, counts)
            results = []
            deadline = getattr(opt, "deadline", None)
            for call in query.calls:
                if deadline is not None \
                        and _time.monotonic() >= deadline:
                    from ..exec.stacked import DeadlineExceededError

                    raise DeadlineExceededError(
                        "request deadline expired between calls")
                if plan_calls is None:
                    results.append(self._execute_call(idx, call, shards, opt))
                    continue
                # ?explain=analyze: every fan-out leg runs its own analyze
                # and hands back a sub-plan; the coordinator node wraps them
                sink = []
                results.append(
                    self._execute_call(idx, call, shards, opt, plan_sink=sink))
                plan_calls.append(
                    self._cluster_plan_node(idx, call, shards, sink))
            if plan_calls is not None:
                self._stash_cluster_plan(idx, "analyze", plan_calls, shards)
            return translate_results(idx, query.calls, results)
        finally:
            if wctx is not None:
                from ..shardwidth import WORDS_PER_ROW

                after = self.local._stacked.counters()
                workload_mod.end_query(
                    wctx, _time.perf_counter() - t_query, deltas={
                        "dispatches": after[0] - before[0],
                        "cache_hits": after[1] - before[1],
                        "cache_misses": after[2] - before[2],
                        "bytes_materialized":
                            (after[3] - before[3]) * WORDS_PER_ROW * 4,
                    })

    def _cluster_plan_node(self, idx, call, shards, children):
        """The coordinator's node for one fanned-out call: per-node
        sub-plans as children (already-serialized dicts)."""
        from ..exec import plan as plan_mod

        node = plan_mod.PlanNode(
            call.name, pql=call_to_pql(call),
            strategy="write" if call.writes() else "cluster-map-reduce")
        node.annotations["nodes"] = len(children)
        node.annotations["shards"] = len(shards or [])
        if self.spmd is not None and not call.writes():
            if any(isinstance(c, dict) and c.get("node") == "mesh"
                   for c in children):
                # the call executed (or would execute) over the
                # collective plane: the mesh identity at the call node
                node.strategy = "spmd-collective"
                node.annotations["spmd"] = True
                node.annotations["mesh"] = self.spmd.mesh_shape()
            else:
                # the collective plane is bypassed under explain so the
                # per-node sub-plans can be captured: the normal path
                # may differ
                node.annotations["spmd_bypassed"] = True
        node.children = list(children)
        return node

    def _stash_cluster_plan(self, idx, mode, plan_calls, shards):
        from ..exec import plan as plan_mod
        from ..utils import profile as profile_mod

        prof = profile_mod.current()
        env = plan_mod.envelope(
            idx.name, mode, plan_calls, shards=len(shards or []),
            trace_id=prof.root.trace_id if prof is not None else None)
        if mode == "analyze":
            # the coordinator node itself never flags; the misestimates
            # live inside the per-node sub-plans — roll them up
            mis = sum(
                len(child["plan"].get("misestimates") or [])
                for node in env["calls"]
                for child in node.get("children", [])
                if isinstance(child, dict)
                and isinstance(child.get("plan"), dict))
            env["misestimates"] = mis
            if mis:
                plan_mod.record(env)
        plan_mod.stash(env)
        return env

    def _explain_cluster_plan(self, idx, query, shards, opt):
        """?explain=true on a cluster: per call, gather one sub-plan per
        owning node — the local planner for our shards, an
        explain="plan" fan-out request for peers (host-side planning on
        each node; nothing executes anywhere)."""
        from ..exec import plan as plan_mod

        local_planner = plan_mod.Planner(self.local)
        plan_calls = []
        for call in query.calls:
            if call.writes():
                plan_calls.append(
                    local_planner.plan_call(idx, call, shards, opt))
                continue
            if self.spmd is not None \
                    and self.spmd.plan_eligible(idx, call):
                # the serving path is the collective plane: ONE mesh
                # child with zero dispatches, annotated spmd + mesh shape
                plan_calls.append(self._cluster_plan_node(
                    idx, call, shards,
                    [{"node": "mesh", "shards": len(shards or []),
                      "plan": self.spmd.plan_node(idx, call, shards)}]))
                continue
            by_node = self.cluster.shards_by_node(idx.name, shards or [])
            children = []
            for node, node_shards in by_node.items():
                entry = {"node": node.id, "shards": len(node_shards)}
                try:
                    if node.id == self.cluster.local_id:
                        entry["plan"] = local_planner.plan_call(
                            idx, call, node_shards,
                            self._remote_opt(opt)).to_dict()
                    else:
                        resp = self._client(node).query(
                            idx.name, call_to_pql(call),
                            shards=node_shards, remote=True,
                            explain="plan")
                        sub = resp.get("plan") or {}
                        calls = sub.get("calls") or [None]
                        entry["plan"] = calls[0]
                except Exception as e:  # degraded, not fatal: a plan
                    entry["error"] = str(e)  # must never fail the query
                children.append(entry)
            plan_calls.append(
                self._cluster_plan_node(idx, call, shards, children))
        self._stash_cluster_plan(idx, "plan", plan_calls, shards)
        return []

    # -- per-call ------------------------------------------------------------

    def _execute_call(self, idx, call, shards, opt, plan_sink=None):
        if call.name in ("Set", "Clear"):
            return self._execute_replicated_write(idx, call)
        if call.name in ("SetRowAttrs", "SetColumnAttrs"):
            return self._execute_attr_write(idx, call)
        return self._map_reduce(idx, call, shards, opt, plan_sink=plan_sink)

    def _remote_opt(self, opt):
        out = ExecOptions(
            exclude_columns=opt.exclude_columns,
            column_attrs=opt.column_attrs,
            exclude_row_attrs=opt.exclude_row_attrs,
            remote=True, profile=opt.profile)
        out.deadline = getattr(opt, "deadline", None)
        return out

    def _execute_replicated_write(self, idx, call):
        """Set/Clear: apply on every replica of the owning shard
        (reference: executeSetBitField executor.go:2137)."""
        col = call.args.get("_col")
        if not isinstance(col, int) or isinstance(col, bool):
            raise ClusterExecError(f"{call.name}() requires a column")
        shard = col // SHARD_WIDTH
        pql = call_to_pql(call)
        ret = False
        ok = 0
        errors = []
        for node in self.cluster.shard_nodes(idx.name, shard):
            if node.id == self.cluster.local_id:
                out = self.local.execute_call(
                    idx, call, [shard], ExecOptions(remote=True))
                ret = ret or bool(out)
                ok += 1
            else:
                try:
                    resp = self._client(node).query(
                        idx.name, pql, remote=True)
                    out = resp["results"][0]
                    ret = ret or bool(out)
                    ok += 1
                    # read-your-writes for shard discovery: the owner just
                    # acked this shard; don't wait for its async push.
                    # Set only — Clear never materializes a fragment, so
                    # recording it would register a phantom shard.
                    if call.name == "Set":
                        self.cluster.record_remote_shards(
                            node.id, idx.name, [shard])
                except Exception as e:
                    errors.append((node.id, e))
        if ok == 0:
            raise ClusterExecError(f"write failed on all replicas: {errors}")
        return ret

    def _execute_attr_write(self, idx, call):
        """Attr stores live on every node — apply locally, fan out to all
        peers (reference: executeSetRowAttrs executor.go:2212)."""
        result = self.local.execute_call(
            idx, call, None, ExecOptions(remote=True))
        pql = call_to_pql(call)
        for node in self.cluster.peers():
            try:
                self._client(node).query(idx.name, pql, remote=True)
            except Exception as e:
                # replica divergence heals via the anti-entropy attr diff,
                # but an operator must be able to SEE it happened
                self.logger.printf(
                    "attr write %s diverged on %s (anti-entropy will "
                    "repair): %s", call.name, node.id, e)
        return result

    # -- mapReduce -----------------------------------------------------------

    def _map_reduce(self, idx, call, shards, opt, plan_sink=None):
        if shards is None:
            shards = self.cluster_shards(idx)
        # The collective data plane: coverable trees merge over the
        # process group, initiated from any node (non-coordinators forward
        # in one hop); what it declines takes the HTTP merge below. A card
        # failure on any rank raises out of it (trap 30). Under
        # explain=analyze it reports the path that serves, when it serves.
        if self.spmd is not None and plan_sink is None:
            used, result = self.spmd.maybe_execute(idx, call, shards)
            if used:
                return result
        elif self.spmd is not None:
            used, result, entry = self.spmd.maybe_execute_analyze(
                idx, call, shards)
            if used:
                plan_sink.append(entry)
                return result
        by_node = self.cluster.shards_by_node(idx.name, shards)

        lock = threading.Lock()
        merged = [None]
        merged_any = [False]
        errors = []
        device_failures = []  # this node's card failed on a local leg
        overload_retried = set()  # node ids given their one same-node retry
        deadline = getattr(opt, "deadline", None)

        def merge_in(result):
            with lock:
                if not merged_any[0]:
                    merged[0] = result
                    merged_any[0] = True
                else:
                    merged[0] = reduce_results(call, merged[0], result)

        use_proto = _internal_wire() != "json"
        pql = call_to_pql(call)  # invariant across nodes and retries

        def note_plan(node, node_shards, sub_plan):
            with lock:
                plan_sink.append({"node": node.id,
                                  "shards": len(node_shards),
                                  "plan": sub_plan})

        def run_node(node, node_shards, tried=()):
            from ..exec.stacked import (DeadlineExceededError,
                                        set_thread_deadline)

            try:
                # Deadline at leg start: an expired leg is dropped, never
                # dispatched — locally OR on a peer. Remaining budget is
                # forwarded RELATIVE (the peer's edge re-anchors against
                # its own clock; clock skew never corrupts it).
                remaining = None
                if deadline is not None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise DeadlineExceededError(
                            "request deadline expired before fan-out leg")
                if node.id == self.cluster.local_id:
                    # local legs run execute_call on a pool thread — the
                    # coordinator's thread-local dispatch deadline doesn't
                    # travel here, so arm this thread's own
                    if deadline is not None:
                        set_thread_deadline(deadline)
                    try:
                        if plan_sink is not None:
                            result, pnode = self.local.explain_analyze_call(
                                idx, call, node_shards, self._remote_opt(opt))
                            note_plan(node, node_shards, pnode.to_dict())
                        else:
                            result = self.local.execute_call(
                                idx, call, node_shards, self._remote_opt(opt))
                    finally:
                        if deadline is not None:
                            set_thread_deadline(None)
                elif plan_sink is not None:
                    # analyze legs ride the JSON wire regardless of the
                    # configured internal encoding: the proto response has
                    # no plan slot
                    resp = self._client(node).query(
                        idx.name, pql, shards=node_shards, remote=True,
                        exclude_row_attrs=opt.exclude_row_attrs,
                        exclude_columns=opt.exclude_columns,
                        explain="analyze", deadline=remaining)
                    result = result_from_json(resp["results"][0])
                    sub = resp.get("plan") or {}
                    calls = sub.get("calls") or [None]
                    note_plan(node, node_shards, calls[0])
                elif use_proto:
                    # protobuf data plane for node-to-node fan-out
                    # (reference: remoteExec posts proto QueryRequests,
                    # executor.go:2414 + http/client.go:268)
                    results, err = self._client(node).query_proto(
                        idx.name, pql, shards=node_shards, remote=True,
                        exclude_row_attrs=opt.exclude_row_attrs,
                        exclude_columns=opt.exclude_columns,
                        deadline=remaining)
                    if err:
                        raise ClusterExecError(err)
                    if not results:
                        raise ClusterExecError(
                            f"malformed proto response from {node.id}: "
                            "no results and no error")
                    r = results[0]
                    # proto Rows decode to their wire dict; everything else
                    # is already a result object
                    result = result_from_json(r) if isinstance(r, dict) \
                        else r
                else:
                    resp = self._client(node).query(
                        idx.name, pql, shards=node_shards, remote=True,
                        exclude_row_attrs=opt.exclude_row_attrs,
                        exclude_columns=opt.exclude_columns,
                        deadline=remaining)
                    result = result_from_json(resp["results"][0])
                merge_in(result)
            except Exception as e:
                from ..server.client import DeadlineExceeded
                from ..utils import flightrec

                if node.id == self.cluster.local_id \
                        and is_device_failure(e):
                    # this node's card failed: no peer retry — the query
                    # fails with the card's error
                    flightrec.record("cluster.local_device_failure",
                                     node=node.id, index=idx.name,
                                     error=str(e)[:200])
                    with lock:
                        device_failures.append(e)
                    return
                if isinstance(e, (DeadlineExceededError, DeadlineExceeded)) \
                        or getattr(e, "status", None) == 504:
                    # every replica shares the same lapsed deadline —
                    # retrying is pure waste, drop the leg
                    with lock:
                        errors.append((node.id, e))
                    return
                if getattr(e, "status", None) == 503:
                    shed = getattr(e, "shed", None)
                    if shed is not None:
                        # the peer is SHEDDING (X-Pilosa-Shed: admission /
                        # coalesce / ingest back-pressure), not dead:
                        # honor its Retry-After (capped — a fan-out leg
                        # can't idle for seconds) and retry the SAME
                        # replica once before moving on
                        with lock:
                            first = node.id not in overload_retried
                            overload_retried.add(node.id)
                        flightrec.record(
                            "cluster.node_overload", node=node.id,
                            index=idx.name, site=shed,
                            retry_after=getattr(e, "retry_after", None))
                        if first:
                            _time.sleep(min(
                                getattr(e, "retry_after", None) or 0.05,
                                0.5))
                            self._note_retry(node, e, idx.name)
                            return run_node(node, node_shards, tried)
                    else:
                        # the peer REJECTED fast (its device-link prober
                        # says DOWN) rather than timing out — name the
                        # node in the recorder so a cluster slowdown is
                        # attributable (the coordinator's
                        # /status?observability=true roll-up shows the
                        # same state via /debug/device)
                        flightrec.record(
                            "cluster.node_unready", node=node.id,
                            index=idx.name, error=str(e))
                # retry each shard on its next replica (reference:
                # mapReduce error path executor.go:2490-2503)
                retried = False
                tried = tuple(tried) + (node.id,)
                regroup = {}
                for shard in node_shards:
                    for replica in self.cluster.shard_nodes(idx.name, shard):
                        if replica.id not in tried:
                            regroup.setdefault(
                                replica.id, (replica, []))[1].append(shard)
                            break
                for replica, rshards in regroup.values():
                    retried = True
                    self._note_retry(node, e, idx.name)
                    run_node(replica, rshards, tried)
                if not regroup and node_shards:
                    with lock:
                        errors.append((node.id, e))

        # Fan-out workers must carry the request's trace context (the span
        # is thread-local; reference: client-side inject http/client.go).
        from ..utils import tracing

        parent_span = tracing.current_span()

        def run_node_traced(node, node_shards):
            with tracing.with_span(parent_span):
                # Per-node fan-out span: its duration is this node's whole
                # contribution (local execute or remote RTT + retries), so
                # a profile shows WHICH node a slow fan-out waited on.
                with tracing.start_span(
                        "cluster.mapReduce.node", node=node.id,
                        shards=len(node_shards),
                        remote=node.id != self.cluster.local_id):
                    run_node(node, node_shards)

        # Bounded fan-out on the shared worker pool (was an unbounded
        # thread per node per query). run_node catches its own errors
        # into `errors` and reduces as results arrive via merge_in, so
        # the pool's fail-fast never triggers here and the
        # reduce-as-they-arrive + replica-retry semantics are unchanged.
        get_pool().map_ordered(
            lambda item: run_node_traced(*item), list(by_node.items()))

        # Cross-node trace assembly (?profile=true): each remote leg's
        # spans stayed on the node that recorded them — without this a
        # profiled cluster query shows the fan-out span and nothing
        # underneath it. Pull the peers' slices of the trace and merge
        # them (skew-corrected) into the active profile. Best-effort and
        # profile-gated: the default path never gets here with a profile.
        self._collect_remote_spans(by_node)

        if device_failures:
            raise device_failures[0]
        if errors:
            from ..exec.stacked import DeadlineExceededError
            from ..server.client import DeadlineExceeded

            for _nid, e in errors:
                if isinstance(e, DeadlineExceededError):
                    raise e
                if isinstance(e, DeadlineExceeded) \
                        or getattr(e, "status", None) == 504:
                    # a remote leg's budget lapsed (client-side or the
                    # peer's own 504) — same 504 at the coordinator
                    raise DeadlineExceededError(str(e)) from e
            raise ClusterExecError(f"query failed: {errors}")
        if not merged_any[0]:
            # zero shards anywhere: run locally over an empty shard list so
            # the result has the call's natural empty shape (0, empty Row…)
            merged[0] = self.local.execute_call(
                idx, call, [], self._remote_opt(opt))
        result = finalize_result(call, merged[0])
        if isinstance(result, Row):
            # remote partials skip decoration; the coordinator attaches
            # row attrs / applies exclude options once on the merged Row
            # (unwrapping Options so the effective call + flags apply)
            from ..exec.executor import unwrap_options

            eff_call, eff_opt, _ = unwrap_options(call, opt)
            self.local.attach_row_attrs(idx, eff_call, result, eff_opt)
        return result

    def _collect_remote_spans(self, by_node):
        """Merge remote-leg spans into the active query profile.

        Skew correction (utils/tracing.estimate_skew): a remote node's
        http span is the child of this coordinator's
        `cluster.mapReduce.node` span — that request/response envelope
        brackets the remote clock, NTP-style. The peer fetch runs under
        with_span(None) so it neither injects trace headers nor adds
        spans of its own to the trace it is assembling."""
        from ..utils import profile as profile_mod
        from ..utils import tracing

        prof = profile_mod.current()
        if prof is None:
            return
        remote_nodes = [n for n in by_node
                        if n.id != self.cluster.local_id]
        if not remote_nodes:
            return
        trace_id = prof.root.trace_id
        local_dicts = [s.to_dict() for s in prof.spans_snapshot()]
        remote_by_node = {}
        with tracing.with_span(None):
            for node in remote_nodes:
                try:
                    resp = self._client(node).debug_trace(trace_id)
                except Exception:  # noqa: BLE001 — assembly is best-effort
                    continue
                spans = (resp or {}).get("spans") or []
                if spans:
                    remote_by_node[node.id] = spans
        if not remote_by_node:
            return
        merged, skew = tracing.merge_remote_spans(
            local_dicts, remote_by_node)
        local_ids = {s["spanID"] for s in local_dicts}
        added = 0
        for s in merged:
            if s["spanID"] in local_ids:
                continue
            prof.record(tracing.Span.from_dict(s))
            added += 1
        # in-process clusters deliver remote spans through the shared span
        # sink, so `added` can be 0 — the skew estimate is still real
        prof.set_tag("remote_spans",
                     {nid: len(s) for nid, s in remote_by_node.items()})
        prof.set_tag("clock_skew_seconds",
                     {nid: round(th, 6) for nid, th in skew.items()})

    # -- shard discovery -----------------------------------------------------

    def cluster_shards(self, idx):
        """Union of available shards across all live nodes. Steady state:
        ZERO shard-discovery HTTP — peers PUSH their per-index shard sets
        over the control plane on every change (CREATE_SHARD messages;
        the reference gossips availableShards the same way) and this just
        reads the local map. A peer is fetched over HTTP only to SEED the
        map: once per (peer, index), and again after a node-state flap
        (its pushes may have been lost while unreachable)."""
        shards = set(idx.available_shards())

        from .node import NODE_STATE_DOWN

        stale = [n for n in self.cluster.peers()
                 if not self.cluster.shards_synced(n.id, idx.name)]

        def fetch(node):
            try:
                client = self._client(node)
                if node.state == NODE_STATE_DOWN:
                    # Probe DOWN-marked peers with a short deadline: a
                    # healed-but-not-yet-READY node still contributes its
                    # exclusive shards; a truly dead one costs ~2s, not a
                    # full client timeout. Shards it shares with replicas
                    # surface from their fetches regardless.
                    client.timeout = 2
                resp = client.index_shards(idx.name)
                self.cluster.set_remote_shards(
                    node.id, idx.name, resp.get("shards", []))
            except Exception:
                # not marked synced -> retried next query; replicated
                # shards come from its replicas meanwhile
                pass

        if stale:
            # fetch() swallows its own errors, so pool fail-fast is inert
            get_pool().map_ordered(fetch, stale)
        shards |= self.cluster.remote_available_shards(idx.name)
        return sorted(shards)

    def _client(self, node):
        return self.client_factory(node.uri)
