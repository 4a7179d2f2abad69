"""Control-plane messaging.

Reference: broadcast.go — the `broadcaster` interface {SendSync, SendAsync,
SendTo} (:30), `Serializer` (:24), and the 16-message taxonomy (:55-72).
The reference carries these as type-prefixed protobuf over gossip/memberlist
or HTTP POST /internal/cluster/message (server.go:695-705).

Here the taxonomy is identical but the wire format is a type-tagged JSON
object POSTed to the same endpoint — schema/membership traffic is tiny and
host-side, so JSON over HTTP is enough (the data plane, the fan-out
legs, rides protobuf: cluster/executor.py).
"""

import json
import threading


class MessageType:
    """(reference: message type constants broadcast.go:55-72)"""

    CREATE_SHARD = "create-shard"
    CREATE_INDEX = "create-index"
    DELETE_INDEX = "delete-index"
    CREATE_FIELD = "create-field"
    DELETE_FIELD = "delete-field"
    CREATE_VIEW = "create-view"
    DELETE_VIEW = "delete-view"
    CLUSTER_STATUS = "cluster-status"
    RESIZE_INSTRUCTION = "resize-instruction"
    RESIZE_INSTRUCTION_COMPLETE = "resize-instruction-complete"
    SET_COORDINATOR = "set-coordinator"
    UPDATE_COORDINATOR = "update-coordinator"
    NODE_STATE = "node-state"
    RECALCULATE_CACHES = "recalculate-caches"
    NODE_EVENT = "node-event"
    NODE_STATUS = "node-status"

    ALL = (
        CREATE_SHARD, CREATE_INDEX, DELETE_INDEX, CREATE_FIELD, DELETE_FIELD,
        CREATE_VIEW, DELETE_VIEW, CLUSTER_STATUS, RESIZE_INSTRUCTION,
        RESIZE_INSTRUCTION_COMPLETE, SET_COORDINATOR, UPDATE_COORDINATOR,
        NODE_STATE, RECALCULATE_CACHES, NODE_EVENT, NODE_STATUS,
    )


class Serializer:
    """Type-tagged JSON encoding (reference: Serializer broadcast.go:24 +
    encoding/proto/proto.go:29)."""

    @staticmethod
    def marshal(msg_type, payload):
        if msg_type not in MessageType.ALL:
            raise ValueError(f"unknown message type: {msg_type}")
        return json.dumps({"type": msg_type, "payload": payload}).encode()

    @staticmethod
    def unmarshal(data):
        d = json.loads(data.decode() if isinstance(data, bytes) else data)
        msg_type = d.get("type")
        if msg_type not in MessageType.ALL:
            raise ValueError(f"unknown message type: {msg_type}")
        return msg_type, d.get("payload")


class NopBroadcaster:
    """(reference: NopBroadcaster broadcast.go:41)"""

    def send_sync(self, msg_type, payload):
        return None

    def send_async(self, msg_type, payload):
        return None

    def send_to(self, node, msg_type, payload):
        return None


class HTTPBroadcaster:
    """Delivers control messages to peers over HTTP POST
    /internal/cluster/message (reference: server.go:695-705 +
    http/client.go:1017 SendMessage).

    send_sync posts to every peer and raises on any failure; send_async
    posts on a background thread per peer, best-effort (the reference's
    gossip queue semantics)."""

    def __init__(self, cluster, client_factory):
        self.cluster = cluster
        self.client_factory = client_factory

    def _post(self, node, data):
        client = self.client_factory(node.uri)
        client.send_message(data)

    def send_to(self, node, msg_type, payload):
        self._post(node, Serializer.marshal(msg_type, payload))

    def send_sync(self, msg_type, payload):
        data = Serializer.marshal(msg_type, payload)
        errors = []
        for node in self.cluster.peers():
            try:
                self._post(node, data)
            except Exception as e:  # collect; sync = all-or-error
                errors.append((node.id, e))
        if errors:
            raise RuntimeError(f"broadcast failures: {errors}")

    def send_async(self, msg_type, payload):
        data = Serializer.marshal(msg_type, payload)
        for node in self.cluster.peers():
            t = threading.Thread(
                target=self._try_post, args=(node, data), daemon=True)
            t.start()

    def _try_post(self, node, data):
        try:
            self._post(node, data)
        except Exception:
            pass
