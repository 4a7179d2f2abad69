"""Cluster layer: node membership, shard placement, cross-node query
fan-out, replication, anti-entropy and resize.

Reference: cluster.go (placement + resize), broadcast.go (messaging),
gossip/ (membership). The same placement algebra (FNV-1a partitions,
jump consistent hashing, replicaN successors), a static bootstrap plus an
HTTP health monitor instead of SWIM gossip, and the control plane as JSON
messages over HTTP (the reference's 16-type taxonomy, broadcast.go:55-72).
Each node serves its own shards with its own kernels; the coordinator
merges the per-node results on the host.
"""

from .hash import JmpHasher, ModHasher, fnv1a64, partition_hash
from .node import (
    Node,
    NODE_STATE_READY,
    NODE_STATE_DOWN,
    CLUSTER_STATE_STARTING,
    CLUSTER_STATE_NORMAL,
    CLUSTER_STATE_DEGRADED,
    CLUSTER_STATE_RESIZING,
)
from .cluster import Cluster, DEFAULT_PARTITION_N
from .broadcast import (
    MessageType,
    Serializer,
    NopBroadcaster,
    HTTPBroadcaster,
)
from .membership import HealthMonitor
from .resize import ResizeError, ResizeJob, ResizeManager, clean_holder


def __getattr__(name):
    # the fan-out executor loads the executor stack (and torch) on first
    # use, so the placement and messaging modules, and the collective
    # plane's mesh cache, import without it (trap 19)
    if name in ("ClusterExecutor", "result_from_json"):
        from . import executor

        return getattr(executor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Cluster",
    "ClusterExecutor",
    "DEFAULT_PARTITION_N",
    "HTTPBroadcaster",
    "HealthMonitor",
    "JmpHasher",
    "MessageType",
    "ModHasher",
    "Node",
    "NopBroadcaster",
    "ResizeError",
    "ResizeJob",
    "ResizeManager",
    "clean_holder",
    "Serializer",
    "fnv1a64",
    "partition_hash",
    "result_from_json",
    "NODE_STATE_READY",
    "NODE_STATE_DOWN",
    "CLUSTER_STATE_STARTING",
    "CLUSTER_STATE_NORMAL",
    "CLUSTER_STATE_DEGRADED",
    "CLUSTER_STATE_RESIZING",
]
