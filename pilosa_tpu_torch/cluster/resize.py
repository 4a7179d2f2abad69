"""Cluster resize: node join/leave with fragment streaming.

Reference: §3.5 — unprotectedGenerateResizeJob cluster.go:1196,
followResizeInstruction cluster.go:1297, distributeResizeInstructions
cluster.go:1545, holderCleaner holder.go:1126, abort api.go:1250.

Flow (coordinator-driven, matching the reference):
  1. Coordinator diffs old->new topology; per destination node it lists
     every shard the node must fetch and a live source that owned it
     (Cluster.frag_sources).
  2. Cluster state -> RESIZING, broadcast to old+new nodes.
  3. Each node with sources gets a RESIZE_INSTRUCTION (includes the
     schema, like the reference's NodeStatus piggyback) and executes it
     on a background thread: apply schema, then for each (index, shard,
     source) stream every field/view fragment via
     /internal/fragment/data and merge it locally (import-roaring path).
  4. Nodes report RESIZE_INSTRUCTION_COMPLETE to the coordinator; when
     all have, the coordinator installs the new topology and broadcasts
     CLUSTER_STATUS NORMAL with the node list; every node installs it and
     drops fragments it no longer owns (holderCleaner).
"""

import logging
import threading
import uuid

from ..utils import faultpoints, flightrec
from .broadcast import MessageType, Serializer
from .node import CLUSTER_STATE_NORMAL, CLUSTER_STATE_RESIZING, Node

logger = logging.getLogger("pilosa_tpu_torch.resize")


class ResizeError(Exception):
    pass


def clean_holder(holder, cluster):
    """Drop fragments whose shard this node no longer owns (reference:
    holderCleaner.CleanHolder holder.go:1126). Returns removed count."""
    import os

    removed = 0
    for idx in list(holder.indexes.values()):
        for field in list(idx.fields.values()):
            for view in list(field.views.values()):
                for shard in list(view.fragments):
                    if cluster.owns_shard(cluster.local_id, idx.name, shard):
                        continue
                    frag = view.remove_fragment(shard)
                    frag.close()
                    for p in (frag.path, frag.cache_path):
                        if os.path.exists(p):
                            os.remove(p)
                    removed += 1
    return removed


class ResizeJob:
    """Coordinator-side tracking of one resize (reference: resizeJob
    cluster.go:1447)."""

    def __init__(self, id, action, old_nodes, new_nodes, instructions):
        self.id = id
        self.action = action  # "add" | "remove"
        self.old_nodes = old_nodes  # list[Node] — restored on abort
        self.new_nodes = new_nodes  # list[Node]
        self.instructions = instructions  # {node_id: instruction payload}
        self.expected = set(instructions)
        self.completed = set()
        self.state = "RUNNING"  # RUNNING | DONE | ABORTED

    def to_json(self):
        return {"id": self.id, "action": self.action, "state": self.state,
                "expected": sorted(self.expected),
                "completed": sorted(self.completed)}


class ResizeManager:
    """Per-node resize logic; the coordinator role activates on demand."""

    def __init__(self, holder, cluster, client_factory, broadcaster=None):
        from .broadcast import HTTPBroadcaster

        self.holder = holder
        self.cluster = cluster
        self.client_factory = client_factory
        self.broadcaster = broadcaster or HTTPBroadcaster(
            cluster, client_factory)
        self.job = None  # coordinator: current ResizeJob
        self._lock = threading.RLock()
        self.on_complete = None  # test hook
        # Fired on EVERY local RESIZING->NORMAL transition (finalize,
        # revert/abort, follower CLUSTER_STATUS): the API drains its
        # queued-while-resizing writes here.
        self.on_state_normal = None

    # ---------------------------------------------------------- coordinator

    def add_node(self, node):
        """Begin a resize admitting `node` (coordinator only; reference:
        nodeJoin cluster.go:1796)."""
        return self._begin("add", node)

    def remove_node(self, node_id):
        """(reference: api.RemoveNode api.go:1193; like the reference, the
        coordinator cannot remove itself — transfer coordination first)"""
        node = self.cluster.node(node_id)
        if node is None:
            raise ResizeError(f"node not in cluster: {node_id}")
        if node.is_coordinator:
            raise ResizeError(
                "cannot remove the coordinator; set a new coordinator "
                "first (/cluster/resize/set-coordinator)")
        return self._begin("remove", node)

    def _begin(self, action, node):
        if not self.cluster.is_coordinator():
            raise ResizeError("not the coordinator")
        with self._lock:
            if self.job is not None and self.job.state == "RUNNING":
                raise ResizeError("resize already in progress")
            # deep-copy both topologies: Node objects must not be shared
            # between the old snapshot (restored on abort) and the new list
            old_nodes = [Node.from_json(n.to_json())
                         for n in self.cluster.nodes]
            if action == "add":
                if self.cluster.node(node.id) is not None:
                    raise ResizeError(f"node already in cluster: {node.id}")
                new_nodes = sorted(
                    [Node.from_json(n.to_json()) for n in old_nodes]
                    + [Node.from_json(node.to_json())], key=lambda n: n.id)
            else:
                new_nodes = [Node.from_json(n.to_json())
                             for n in old_nodes if n.id != node.id]
                if not new_nodes:
                    raise ResizeError("cannot remove the last node")

            # may raise (unreachable node); nothing mutated yet
            instructions = self._generate_instructions(old_nodes, new_nodes)
            if action == "add" and node.id not in instructions:
                # the joining node always needs the schema, even when no
                # data moves to it (reference: NodeStatus schema sync on
                # join gossip/gossip.go LocalState)
                instructions[node.id] = {
                    "node": node.id, "sources": [],
                    "schema": self.holder.schema()}
            job = ResizeJob(uuid.uuid4().hex[:12], action, old_nodes,
                            new_nodes, instructions)
            self.job = job
            flightrec.record("cluster.resize_begin", job=job.id,
                             action=action, node=node.id,
                             instructions=len(instructions))

            # Block queries BEFORE the new placement becomes visible, so
            # no request routes by the new topology while data is moving.
            self.cluster.state = CLUSTER_STATE_RESIZING
            self.cluster.nodes = sorted(new_nodes, key=lambda n: n.id)
            self.cluster.save_topology()

            # nothing to move: finalize immediately
            if not instructions:
                self._finalize(job)
                return job

            self._broadcast_status(CLUSTER_STATE_RESIZING, new_nodes,
                                   targets=old_nodes + new_nodes)
            try:
                for node_id, instr in instructions.items():
                    self._send_instruction(node_id, instr, new_nodes)
            except Exception as e:
                self._revert(job, "ABORTED")
                raise ResizeError(
                    f"resize instruction delivery failed: {e}") from e
            return job

    def _revert(self, job, state):
        """Restore the pre-resize topology (abort/failure path)."""
        job.state = state
        flightrec.record("cluster.resize_abort", job=job.id, state=state)
        self.cluster.nodes = sorted(job.old_nodes, key=lambda n: n.id)
        self.cluster.state = CLUSTER_STATE_NORMAL
        self.cluster.save_topology()
        self.cluster.invalidate_shard_map()
        self._broadcast_status(CLUSTER_STATE_NORMAL, job.old_nodes,
                               targets=job.old_nodes + job.new_nodes)
        if self.on_state_normal:
            self.on_state_normal()

    def _cluster_shards(self, index_name, old_nodes):
        """Union of available shards across every old node — the
        coordinator's local holder only knows its own fragments
        (reference: Index.AvailableShards is cluster-wide via
        CreateShardMessage broadcasts index.go:292)."""
        idx = self.holder.index(index_name)
        shards = set(idx.available_shards()) if idx else set()
        for node in old_nodes:
            if node.id == self.cluster.local_id:
                continue
            try:
                resp = self.client_factory(node.uri).index_shards(index_name)
                shards.update(resp.get("shards", []))
            except Exception as e:
                raise ResizeError(
                    f"cannot enumerate shards on {node.id}: {e}") from e
        return sorted(shards)

    def _generate_instructions(self, old_nodes, new_nodes):
        """{dest_node_id: instruction} (reference:
        unprotectedGenerateResizeJob cluster.go:1196)."""
        schema = self.holder.schema()
        by_dest = {}
        for idx in self.holder.indexes.values():
            shards = self._cluster_shards(idx.name, old_nodes)
            if not shards:
                continue
            sources = self.cluster.frag_sources(
                old_nodes, new_nodes, idx.name, shards)
            for dest_id, pairs in sources.items():
                for shard, src_id in pairs:
                    src = next(n for n in old_nodes if n.id == src_id)
                    by_dest.setdefault(dest_id, []).append({
                        "index": idx.name, "shard": shard,
                        "sourceID": src.id, "sourceURI": src.uri})
        # jobID is stamped by _send_instruction once the job exists
        return {dest_id: {"node": dest_id, "sources": srcs, "schema": schema}
                for dest_id, srcs in by_dest.items()}

    def _send_instruction(self, node_id, instr, new_nodes):
        instr = dict(instr)
        instr["jobID"] = self.job.id
        instr["coordinatorURI"] = self.cluster.local_node.uri
        target = next((n for n in new_nodes if n.id == node_id), None)
        if target is None:
            raise ResizeError(f"instruction for unknown node {node_id}")
        if node_id == self.cluster.local_id:
            threading.Thread(
                target=self.follow_instruction, args=(instr,),
                daemon=True, name="resize-local").start()
        else:
            self.broadcaster.send_to(
                target, MessageType.RESIZE_INSTRUCTION, instr)

    def mark_complete(self, job_id, node_id, error=None):
        """(reference: markResizeInstructionComplete cluster.go:1413) A
        reported error fails the whole job and reverts the topology —
        leaving the cluster RESIZING forever would reject all traffic."""
        with self._lock:
            job = self.job
            if job is None or job.id != job_id or job.state != "RUNNING":
                return
            if error:
                logger.error("resize job %s failed on %s: %s",
                             job_id, node_id, error)
                self._revert(job, "FAILED")
                return
            job.completed.add(node_id)
            if job.completed >= job.expected:
                self._finalize(job)

    def _finalize(self, job):
        self.cluster.nodes = sorted(job.new_nodes, key=lambda n: n.id)
        self.cluster.state = CLUSTER_STATE_NORMAL
        self.cluster.save_topology()
        self.cluster.invalidate_shard_map()
        self._broadcast_status(CLUSTER_STATE_NORMAL, job.new_nodes,
                               targets=job.old_nodes + job.new_nodes)
        clean_holder(self.holder, self.cluster)
        # DONE only after peers were told NORMAL: a client that polls
        # status DONE must not then hit a follower still rejecting queries
        job.state = "DONE"
        flightrec.record("cluster.resize_finalize", job=job.id,
                         action=job.action, nodes=len(job.new_nodes))
        if self.on_state_normal:
            self.on_state_normal()
        if self.on_complete:
            self.on_complete(job)

    def abort(self):
        """(reference: api.ResizeAbort api.go:1250) Revert to the old
        topology; moved data is reclaimed later by holderCleaner."""
        with self._lock:
            job = self.job
            if job is None or job.state != "RUNNING":
                raise ResizeError("no resize job running")
            self._revert(job, "ABORTED")
            return job

    def _broadcast_status(self, state, nodes, targets):
        """Send CLUSTER_STATUS (state + node list) to every target but
        this node (the joining node isn't in cluster.peers() yet)."""
        payload = {"state": state, "nodes": [n.to_json() for n in nodes]}
        by_id = {n.id: n for n in targets}
        by_id.pop(self.cluster.local_id, None)
        for node in by_id.values():
            try:
                self.broadcaster.send_to(
                    node, MessageType.CLUSTER_STATUS, payload)
            except Exception:
                logger.warning("cluster-status to %s failed", node.id)

    # ----------------------------------------------------------- follower

    def follow_instruction(self, instr):
        """Execute one resize instruction: apply schema, stream each
        source fragment, report completion — or the failure, so the
        coordinator can fail the job instead of hanging RESIZING
        (reference: followResizeInstruction cluster.go:1297)."""
        error = None
        try:
            self.holder.apply_schema(instr.get("schema", []))
            for src in instr.get("sources", []):
                self._retrieve_shard(src)
        except Exception as e:
            logger.exception("resize instruction failed")
            error = str(e) or type(e).__name__
        try:
            self._report_complete(instr, error=error)
        except Exception:
            logger.exception("reporting resize completion failed")

    def _retrieve_shard(self, src):
        """Stream every field/view fragment of (index, shard) from the
        source node and merge locally (reference:
        RetrieveShardFromURI http/client.go:742 + importRoaring). The
        source enumerates its fragments — views are data-dependent, so
        the destination cannot know them from the schema alone."""
        index, shard = src["index"], int(src["shard"])
        # crash-test timing hook: arming a delay here holds the cluster
        # in RESIZING long enough to queue writes deterministically
        faultpoints.reached("resize.fetch")
        client = self.client_factory(src["sourceURI"])
        idx = self.holder.index(index)
        if idx is None:
            return
        listing = client.shard_fragments(index, shard)
        for entry in listing.get("fragments", []):
            field = idx.field(entry["field"])
            if field is None:
                continue  # not in the schema we were sent; skip
            data = client.fragment_data(
                index, entry["field"], entry["view"], shard)
            if not data:
                continue
            view = field.create_view_if_not_exists(entry["view"])
            frag = view.create_fragment_if_not_exists(shard)
            frag.import_roaring(data)

    def _report_complete(self, instr, error=None):
        payload = {"jobID": instr["jobID"], "node": self.cluster.local_id,
                   "error": error}
        coord_uri = instr.get("coordinatorURI")
        if (self.cluster.local_node is not None
                and coord_uri == self.cluster.local_node.uri):
            self.mark_complete(payload["jobID"], payload["node"],
                               error=error)
            return
        self.client_factory(coord_uri).send_message(
            Serializer.marshal(
                MessageType.RESIZE_INSTRUCTION_COMPLETE, payload))

    # ----------------------------------------------------------- dispatch

    def receive(self, msg_type, payload):
        """Handle resize-related control messages; returns True when
        handled."""
        if msg_type == MessageType.RESIZE_INSTRUCTION:
            threading.Thread(
                target=self.follow_instruction, args=(payload,),
                daemon=True, name="resize-follow").start()
            return True
        if msg_type == MessageType.RESIZE_INSTRUCTION_COMPLETE:
            self.mark_complete(payload["jobID"], payload["node"],
                               error=payload.get("error"))
            return True
        if msg_type == MessageType.CLUSTER_STATUS:
            state = payload.get("state")
            nodes = payload.get("nodes")
            with self._lock:
                if nodes:
                    self.cluster.nodes = sorted(
                        (Node.from_json(d) for d in nodes),
                        key=lambda n: n.id)
                    self.cluster.save_topology()
                if state:
                    self.cluster.state = state
            # placement changed (or is about to): everything learned about
            # peers' shards is suspect — force a re-seed on next query
            self.cluster.invalidate_shard_map()
            if state == CLUSTER_STATE_NORMAL and nodes:
                clean_holder(self.holder, self.cluster)
            if state == CLUSTER_STATE_NORMAL and self.on_state_normal:
                self.on_state_normal()
            return True
        if msg_type == MessageType.SET_COORDINATOR:
            with self._lock:
                for n in self.cluster.nodes:
                    n.is_coordinator = (n.id == payload.get("id"))
                self.cluster.save_topology()
            return True
        return False
