"""Clusters of the port's servers on one host, for tests and the card's
smoke run.

`ClusterHarness(n, replica_n=...)` boots n in-process nodes (holder, API
and HTTP server each, ephemeral ports) and then attaches a cluster-aware
API to each, as the TPU package's `tests/harness.ClusterHarness` does: a
static topology, real HTTP between the nodes, every node on `device`
(the CPU unless asked otherwise).

`ProcCluster(n, replica_n=..., device=...)` starts n real
`python -m pilosa_tpu_torch server` processes with `--cluster-hosts`,
`--node-id` and `--replicas`, each with a data directory of its own, and
waits for every node to report the cluster NORMAL. `pause(i)`/`resume(i)`
send SIGSTOP/SIGCONT, `join()` starts one more node with `--join`, and
`close()` stops every process (SIGTERM, then SIGKILL past a timeout).

Placement follows the sorted node ids, and ephemeral ports differ from
run to run, so compare two clusters by their answers, not by which node
served a shard.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class NodeHarness:
    """One in-process node: holder + API + HTTP on an ephemeral port."""

    def __init__(self, data_dir=None, device="cpu", **api_kwargs):
        from ..core import Holder
        from ..server import API, Client, PilosaHTTPServer

        self.data_dir = data_dir or tempfile.mkdtemp(prefix="pilosa_torch_")
        self.device = device
        self.holder = Holder(self.data_dir, use_snapshot_queue=False).open()
        self.api = API(self.holder, device=device, **api_kwargs)
        self.server = PilosaHTTPServer(self.api, host="127.0.0.1",
                                       port=0).start()
        self.client = Client(self.server.uri)
        self.cluster = None

    @property
    def address(self):
        return self.server.uri

    @property
    def node_id(self):
        return self.address.split("//", 1)[1]

    def close(self):
        self.server.stop()
        self.api.close()
        self.holder.close()


class ClusterHarness:
    """n in-process nodes with a shared static topology (reference:
    test.MustRunCluster test/pilosa.go:390 — real servers, real HTTP,
    ephemeral ports; a ModHasher may be given for fixed placement)."""

    def __init__(self, n, replica_n=1, hasher=None, api_kwargs=None,
                 device="cpu"):
        from ..cluster import Cluster, Node
        from ..server import API, Client

        # phase 1: boot cluster-less servers to learn their ports
        self.nodes = [NodeHarness(device=device) for _ in range(n)]
        node_list = [Node(id=h.node_id, uri=h.address) for h in self.nodes]
        # phase 2: attach cluster-aware APIs now that every URI is known
        for h in self.nodes:
            cluster = Cluster(
                nodes=[Node(n_.id, n_.uri) for n_ in node_list],
                local_id=h.node_id, replica_n=replica_n, hasher=hasher,
                path=h.data_dir)
            h.api.close()
            h.api = API(h.holder, device=device, cluster=cluster,
                        client_factory=Client, **(api_kwargs or {}))
            h.server.api = h.api
            h.cluster = h.api.cluster

    def __getitem__(self, i):
        return self.nodes[i]

    def __len__(self):
        return len(self.nodes)

    def owner_of(self, index, shard):
        """The node that is primary owner of (index, shard)."""
        primary = self.nodes[0].cluster.shard_nodes(index, shard)[0]
        return self.node_by_id(primary.id)

    def non_owner_of(self, index, shard):
        owners = {n.id for n in
                  self.nodes[0].cluster.shard_nodes(index, shard)}
        for h in self.nodes:
            if h.cluster.local_id not in owners:
                return h
        return None

    def node_by_id(self, node_id):
        for h in self.nodes:
            if h.cluster.local_id == node_id:
                return h
        return None

    def close(self):
        for h in self.nodes:
            try:
                h.close()
            except Exception:  # noqa: BLE001 — a node a test stopped
                pass


def free_ports(n):
    """n distinct free TCP ports on 127.0.0.1 (held open together, so no
    two are the same)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ProcCluster:
    """n `python -m pilosa_tpu_torch server` processes forming one
    static cluster on 127.0.0.1. `extra_flags` go to every node;
    `config` (TOML text) is written to each node's data directory and
    passed with --config."""

    def __init__(self, n, replica_n=1, device="cpu", extra_flags=(),
                 config=None, env=None, base_dir=None, log_dir=None,
                 client_timeout=120):
        self.device = device
        self.client_timeout = client_timeout
        self.replica_n = replica_n
        self.extra_flags = list(extra_flags)
        self.config = config
        self.env = dict(os.environ if env is None else env)
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="pilosa-pc-")
        self.log_dir = log_dir or self.base_dir
        self.ports = free_ports(n)
        self.hosts = [f"127.0.0.1:{p}" for p in self.ports]
        self.procs, self.logs, self.dirs, self.clients = [], [], [], []
        for i in range(n):
            self._spawn(i, ["--cluster-hosts", ",".join(self.hosts),
                            "--replicas", str(replica_n)])

    def _spawn(self, i, cluster_flags):
        from ..server import Client

        data_dir = os.path.join(self.base_dir, f"node{i}")
        os.makedirs(data_dir, exist_ok=True)
        flags = ["--bind", self.hosts[i], "--node-id", self.hosts[i],
                 "--data-dir", data_dir, "--device", self.device,
                 *cluster_flags, *self.extra_flags]
        if self.config is not None:
            path = os.path.join(data_dir, "node.toml")
            with open(path, "w") as f:
                f.write(self.config)
            flags += ["--config", path]
        log = open(os.path.join(self.log_dir, f"node{i}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server", *flags],
            stdout=log, stderr=subprocess.STDOUT, env=self.env, cwd=REPO)
        self.procs.append(proc)
        self.logs.append(log)
        self.dirs.append(data_dir)
        self.clients.append(Client(f"http://{self.hosts[i]}",
                                   timeout=self.client_timeout))

    def wait_ready(self, timeout=120, nodes=None):
        """Every node up and reporting the cluster NORMAL with all
        `nodes` (default: every process started) members."""
        want = len(self.procs) if nodes is None else nodes
        deadline = time.monotonic() + timeout
        pending = set(range(len(self.procs)))
        while pending and time.monotonic() < deadline:
            for i in sorted(pending):
                if self.procs[i].poll() is not None:
                    raise RuntimeError(f"node {i} exited: {self.tail(i)}")
                try:
                    st = self.clients[i].status()
                except Exception:  # noqa: BLE001 — still booting
                    continue
                if st.get("state") == "NORMAL" \
                        and len(st.get("nodes", [])) == want:
                    pending.discard(i)
            if pending:
                time.sleep(0.2)
        if pending:
            raise TimeoutError(
                f"nodes {sorted(pending)} not ready: "
                + "; ".join(self.tail(i) for i in sorted(pending)))
        return self

    def join(self, seed=0):
        """Start one more node with --join to node `seed`; returns its
        position."""
        i = len(self.procs)
        self.ports += free_ports(1)
        self.hosts.append(f"127.0.0.1:{self.ports[-1]}")
        self._spawn(i, ["--join", self.hosts[seed]])
        return i

    def pause(self, i):
        self.procs[i].send_signal(signal.SIGSTOP)

    def resume(self, i):
        self.procs[i].send_signal(signal.SIGCONT)

    def tail(self, i, n=3000):
        if not self.logs[i].closed:
            self.logs[i].flush()
        with open(self.logs[i].name, errors="replace") as f:
            return f.read()[-n:]

    def close(self, timeout=20):
        """SIGTERM every node (SIGCONT first, for a paused one), wait,
        SIGKILL what is left; returns the exit codes."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGCONT)
                    p.terminate()
                except OSError:
                    pass
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait(timeout=timeout))
        for log in self.logs:
            log.close()
        return codes

    def remove_dirs(self):
        shutil.rmtree(self.base_dir, ignore_errors=True)
