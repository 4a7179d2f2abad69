"""Cluster: node list, shard placement, states, topology persistence, and
resize source planning.

Reference: cluster.go — defaultPartitionN=256 (:44), placement
(:871-960), cluster states (:45-50), Topology persisted in `.topology`
(:1580-1692), resize fragment sources (fragSources :784).

Placement: partition = FNV-1a(index, shard) % partitionN; primary node =
jump_hash(partition, len(nodes)); owners = replicaN successive nodes on the
ring. Nodes sort by ID so every node computes identical placement.
"""

import json
import os
import threading

from .hash import JmpHasher, partition_hash
from .node import (
    CLUSTER_STATE_DEGRADED,
    CLUSTER_STATE_NORMAL,
    CLUSTER_STATE_STARTING,
    NODE_STATE_DOWN,
    NODE_STATE_READY,
    Node,
)

DEFAULT_PARTITION_N = 256  # reference: defaultPartitionN cluster.go:44


class ClusterError(Exception):
    pass


class Cluster:
    def __init__(self, nodes=None, local_id=None, replica_n=1,
                 partition_n=DEFAULT_PARTITION_N, hasher=None, path=None):
        """nodes: list[Node]; local_id: this process's node id; path: data
        dir for `.topology` persistence (None = ephemeral)."""
        self.nodes = sorted(nodes or [], key=lambda n: n.id)
        self.local_id = local_id
        self.replica_n = max(1, int(replica_n))
        self.partition_n = int(partition_n)
        self.hasher = hasher or JmpHasher()
        self.path = path
        self.state = CLUSTER_STATE_NORMAL if self.nodes else \
            CLUSTER_STATE_STARTING
        self._lock = threading.RLock()
        if self.nodes and not any(n.is_coordinator for n in self.nodes):
            self.nodes[0].is_coordinator = True
        # Gossiped shard map (reference: availableShards carried in gossip
        # NodeStatus / CreateShardMessage, cluster.go): peers PUSH their
        # per-index available shards over the control plane so queries
        # never do per-peer shard-discovery HTTP in the steady state.
        # Entries MERGE by union (pushes are unordered best-effort async;
        # a reordered older full list must not shrink the set — shrink
        # events, resize/delete, invalidate the whole map instead), and
        # seeds carry a timestamp: a seed older than SHARD_MAP_TTL is
        # re-fetched once, bounding the staleness window of a LOST push.
        self._remote_shards = {}   # node_id -> {index: set(shards)}
        self._shards_synced = {}   # (node_id, index) -> monotonic seed time

    # -- identity ------------------------------------------------------------

    @property
    def local_node(self):
        for n in self.nodes:
            if n.id == self.local_id:
                return n
        return None

    @property
    def coordinator(self):
        for n in self.nodes:
            if n.is_coordinator:
                return n
        return self.nodes[0] if self.nodes else None

    def is_coordinator(self):
        node = self.local_node
        return node is not None and node.is_coordinator

    def node(self, node_id):
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    def peers(self):
        """Every node but this one."""
        return [n for n in self.nodes if n.id != self.local_id]

    # -- placement (reference: cluster.go:871-960) ---------------------------

    def partition(self, index, shard):
        return partition_hash(index, shard, self.partition_n)

    def partition_nodes(self, partition_id, nodes=None):
        """replicaN successive owners on the ring for a partition."""
        nodes = self.nodes if nodes is None else nodes
        if not nodes:
            return []
        replica_n = min(self.replica_n, len(nodes))
        primary = self.hasher.hash(partition_id, len(nodes))
        return [nodes[(primary + i) % len(nodes)] for i in range(replica_n)]

    def shard_nodes(self, index, shard, nodes=None):
        """Owner nodes for (index, shard) — primary first
        (reference: cluster.ShardNodes cluster.go:883)."""
        return self.partition_nodes(self.partition(index, shard), nodes)

    def owns_shard(self, node_id, index, shard):
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def shards_by_node(self, index, shards):
        """{node: [shards]} using each shard's first NON-DOWN owner (reads
        stay available in DEGRADED state by routing straight to a live
        replica instead of timing out on the primary; reference:
        executor.shardsByNode + the replica-retry path executor.go:2490).
        Falls back to the primary when every owner is down so the caller
        surfaces a clean error."""
        out = {}
        for shard in shards:
            owners = self.shard_nodes(index, shard)
            if not owners:
                continue
            live = [n for n in owners if n.state != NODE_STATE_DOWN]
            out.setdefault((live or owners)[0], []).append(shard)
        return out

    def local_shards(self, index, shards):
        return [s for s in shards if self.owns_shard(self.local_id, index, s)]

    # -- state (reference: determineClusterState cluster.go:571-583) ---------

    def determine_state(self):
        with self._lock:
            if self.state == "RESIZING":
                # only the resize manager may leave RESIZING (finalize,
                # abort, or failure) — health transitions must not unblock
                # queries mid-stream
                return self.state
            down = sum(1 for n in self.nodes if n.state == NODE_STATE_DOWN)
            if down == 0:
                self.state = CLUSTER_STATE_NORMAL
            elif down < self.replica_n:
                # reads still servable from replicas
                self.state = CLUSTER_STATE_DEGRADED
            else:
                self.state = CLUSTER_STATE_STARTING
            return self.state

    def set_node_state(self, node_id, state):
        with self._lock:
            node = self.node(node_id)
            if node is not None and node.state != state:
                node.state = state
                # a node that flapped may have grown shards while its
                # pushes were lost; force one re-seed fetch on next query
                self._shards_synced = {
                    key: ts for key, ts in self._shards_synced.items()
                    if key[0] != node_id}
                self.determine_state()
                return True
        return False

    def live_nodes(self):
        return [n for n in self.nodes if n.state == NODE_STATE_READY]

    # -- gossiped shard map ---------------------------------------------------

    #: seconds before a peer's seed is re-fetched once — bounds how long a
    #: LOST async push can leave the map stale (the reference's gossip
    #: re-converges continuously; this is the pull-side analog)
    SHARD_MAP_TTL = 30.0

    def set_remote_shards(self, node_id, index, shards):
        """Merge a peer's pushed per-index shard list. UNION, not replace:
        async pushes can arrive out of order and an older (smaller) full
        list must not erase shards a newer push already delivered. Shard
        sets only shrink on resize/delete, which invalidate the whole map
        (invalidate_shard_map / drop_remote_index)."""
        import time as _time

        with self._lock:  # RLock: record nests under the same lock
            self.record_remote_shards(node_id, index, shards)
            self._shards_synced[(node_id, index)] = _time.monotonic()

    def record_remote_shards(self, node_id, index, shards):
        """Union shards into a peer's map WITHOUT marking it seeded:
        used by the write path for read-your-writes — a node that just
        forwarded an import slice KNOWS the target now holds that shard
        and must not wait for the target's async push (which can lag the
        ack and leave an immediate query silently missing the shard).
        The seed fetch still runs for peers never fully synced."""
        with self._lock:
            self._remote_shards.setdefault(node_id, {}).setdefault(
                index, set()).update(int(s) for s in shards)

    def shards_synced(self, node_id, index):
        import time as _time

        with self._lock:
            ts = self._shards_synced.get((node_id, index))
            return ts is not None \
                and _time.monotonic() - ts < self.SHARD_MAP_TTL

    def remote_available_shards(self, index):
        """Union of every peer's last-pushed shards for an index."""
        out = set()
        with self._lock:
            for per_index in self._remote_shards.values():
                out |= per_index.get(index, set())
        return out

    def remove_remote_shard(self, index, shard):
        """Drop ONE advertised shard from every peer's record (reference:
        Field.RemoveAvailableShard field.go:513, reached via DELETE
        remote-available-shards handler.go:316 — stale-advertisement
        cleanup). The next gossip push from a peer that really has the
        shard re-adds it."""
        with self._lock:
            for per_index in self._remote_shards.values():
                per_index.get(index, set()).discard(int(shard))

    def drop_remote_index(self, index):
        with self._lock:
            for per_index in self._remote_shards.values():
                per_index.pop(index, None)
            self._shards_synced = {
                key: ts for key, ts in self._shards_synced.items()
                if key[1] != index}

    def invalidate_shard_map(self):
        """Drop everything learned about peers' shards. Called on ANY
        membership/placement change (node join/leave, resize completion):
        a resize re-sorts the node list, so EXISTING nodes can gain shards
        (streamed outside the push hooks) and stale entries would serve
        silently incomplete shard lists. The next query re-seeds each peer
        once."""
        with self._lock:
            self._remote_shards.clear()
            self._shards_synced.clear()

    # -- membership changes ---------------------------------------------------

    def add_node(self, node):
        """(reference: cluster.addNode; triggers resize planning upstream)"""
        with self._lock:
            if self.node(node.id) is not None:
                return False
            self.nodes = sorted(self.nodes + [node], key=lambda n: n.id)
            if not any(n.is_coordinator for n in self.nodes):
                self.nodes[0].is_coordinator = True
            self.save_topology()
            self.invalidate_shard_map()
            return True

    def remove_node(self, node_id):
        with self._lock:
            node = self.node(node_id)
            if node is None:
                return False
            self.nodes = [n for n in self.nodes if n.id != node_id]
            if node.is_coordinator and self.nodes:
                self.nodes[0].is_coordinator = True
            self.save_topology()
            self.invalidate_shard_map()
            return True

    # -- topology persistence (reference: cluster.go:1580-1692) ---------------

    @property
    def topology_path(self):
        return os.path.join(self.path, ".topology") if self.path else None

    def save_topology(self):
        if not self.topology_path:
            return
        os.makedirs(self.path, exist_ok=True)
        tmp = self.topology_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"nodeIDs": [n.id for n in self.nodes],
                       "nodes": [n.to_json() for n in self.nodes]}, f)
        os.replace(tmp, self.topology_path)

    def load_topology(self):
        """Returns True when a topology file existed and was loaded."""
        if not self.topology_path or not os.path.exists(self.topology_path):
            return False
        with open(self.topology_path) as f:
            data = json.load(f)
        if data.get("nodes"):
            self.nodes = sorted(
                (Node.from_json(d) for d in data["nodes"]),
                key=lambda n: n.id)
        return True

    # -- resize planning (reference: fragSources cluster.go:784) --------------

    def frag_sources(self, old_nodes, new_nodes, index, shards):
        """For a topology change old->new: {dest_node_id: [(shard,
        source_node_id)]} listing every shard a node must fetch and a live
        node that owned it before. Used by resize jobs (§3.5)."""
        old_sorted = sorted(old_nodes, key=lambda n: n.id)
        new_sorted = sorted(new_nodes, key=lambda n: n.id)
        out = {}
        for shard in shards:
            p = self.partition(index, shard)
            old_owner_ids = {
                n.id for n in self.partition_nodes(p, old_sorted)}
            for dest in self.partition_nodes(p, new_sorted):
                if dest.id in old_owner_ids:
                    continue  # already has it
                sources = [
                    n for n in old_sorted
                    if n.id in old_owner_ids and n.state == NODE_STATE_READY]
                if not sources:
                    raise ClusterError(
                        f"no available source for shard {shard} of {index}")
                out.setdefault(dest.id, []).append((shard, sources[0].id))
        return out

    # -- serialization ---------------------------------------------------------

    def status_json(self):
        return {"state": self.state,
                "nodes": [n.to_json() for n in self.nodes]}

    def nodes_json(self):
        return [n.to_json() for n in self.nodes]
