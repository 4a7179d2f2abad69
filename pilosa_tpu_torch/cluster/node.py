"""Cluster node identity and states.

Reference: Node struct (pilosa.go), cluster states cluster.go:45-50, node
states (STARTING/READY/DOWN)."""

# Cluster states (reference: cluster.go:45-50)
CLUSTER_STATE_STARTING = "STARTING"
CLUSTER_STATE_NORMAL = "NORMAL"
CLUSTER_STATE_DEGRADED = "DEGRADED"
CLUSTER_STATE_RESIZING = "RESIZING"

# Node states
NODE_STATE_READY = "READY"
NODE_STATE_DOWN = "DOWN"


class Node:
    __slots__ = ("id", "uri", "is_coordinator", "state")

    def __init__(self, id, uri, is_coordinator=False, state=NODE_STATE_READY):
        self.id = id
        self.uri = uri.rstrip("/")
        self.is_coordinator = is_coordinator
        self.state = state

    def to_json(self):
        return {"id": self.id, "uri": self.uri,
                "isCoordinator": self.is_coordinator, "state": self.state}

    @classmethod
    def from_json(cls, d):
        return cls(d["id"], d["uri"],
                   is_coordinator=d.get("isCoordinator", False),
                   state=d.get("state", NODE_STATE_READY))

    def __eq__(self, other):
        return isinstance(other, Node) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        flags = " coordinator" if self.is_coordinator else ""
        return f"<Node {self.id} {self.uri} {self.state}{flags}>"
