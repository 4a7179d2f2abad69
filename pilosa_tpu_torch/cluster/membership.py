"""Membership / failure detection.

Reference: gossip/gossip.go (SWIM memberlist) + cluster.confirmNodeDown
(cluster.go:1724-1752): suspicion from gossip is double-checked with up to
10 direct /status probes before a node is marked down.

Replacement here: hosts are static (listed up front), so
membership reduces to a health monitor — every node probes its peers'
/status on an interval; a peer failing `confirm_retries` consecutive
probes is marked DOWN (cluster state recomputed: NORMAL/DEGRADED), and a
recovered peer is marked READY again. Elastic add/remove arrives via the
control plane (node-event messages), not via discovery.
"""

import threading

from ..utils import flightrec
from .node import NODE_STATE_DOWN, NODE_STATE_READY


class HealthMonitor:
    def __init__(self, cluster, client_factory, interval=1.0,
                 confirm_retries=3, on_change=None):
        """confirm_retries: consecutive probe failures before DOWN
        (reference uses 10 fast retries in confirmNodeDown; health probes
        here are already periodic so the default is lower)."""
        self.cluster = cluster
        self.client_factory = client_factory
        self.interval = interval
        self.confirm_retries = confirm_retries
        self.on_change = on_change  # callback(node, new_state)
        self._failures = {}
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="health-monitor")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.interval):
            self.probe_all()

    def probe_all(self):
        for node in self.cluster.peers():
            self.probe(node)

    def probe(self, node):
        ok = self._check(node)
        if ok:
            self._failures[node.id] = 0
            if node.state == NODE_STATE_DOWN:
                self.cluster.set_node_state(node.id, NODE_STATE_READY)
                flightrec.record("cluster.node_up", node=node.id)
                if self.on_change:
                    self.on_change(node, NODE_STATE_READY)
        else:
            n = self._failures.get(node.id, 0) + 1
            self._failures[node.id] = n
            if n >= self.confirm_retries and node.state != NODE_STATE_DOWN:
                self.cluster.set_node_state(node.id, NODE_STATE_DOWN)
                flightrec.record("cluster.node_down", node=node.id,
                                 failures=n)
                if self.on_change:
                    self.on_change(node, NODE_STATE_DOWN)

    def _check(self, node):
        try:
            client = self.client_factory(node.uri)
            # Probes need a tight deadline (reference: memberlist probe
            # timeouts are sub-second); inheriting the default 30s client
            # timeout would stall down-detection by minutes.
            if hasattr(client, "timeout"):
                client.timeout = 2
            status = client.status()
            return isinstance(status, dict)
        except Exception:
            return False
