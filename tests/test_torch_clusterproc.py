"""The port's HTTP cluster as real processes on the CPU: `python -m
pilosa_tpu_torch server --device cpu --cluster-hosts ... --replicas N`
children on localhost, against the TPU package's answers.

The cases of the TPU package's process suites, each run on the port:

- tests/test_clusterproc.py (4): schema replication, an import visible
  from every node, an import while one node is frozen (SIGSTOP) and
  anti-entropy repairing it after SIGCONT, and a SIGKILL'd single node
  replaying every acknowledged write;
- tests/test_golden_cluster.py's HTTP half: the 43 golden PQL cases
  (tests/testdata/golden_pql.json) through every node of a 3-node,
  replicas-2 cluster;
- tests/test_join.py (2): a node started with --join enters through the
  coordinator's resize, with and without writes in flight;
- tests/test_netfault.py (1): one node's network blackholed behind a
  pausable proxy (the process stays alive), marked DOWN, reads served by
  the replicas, then healed and repaired;
- tests/test_crashmatrix.py::test_crash_mid_resize_drain: writes queued
  during a resize survive the coordinator dying mid-drain.

Every answer is compared with the TPU package's on the same writes: an
in-process `pilosa_tpu` server (JAX on the CPU, tests/harness) takes
each import the cluster takes, or the golden file's `want`s, which the
TPU package's executor produced. The clusters of the first four cases
share one 3-node cluster per module (anti-entropy every 2 s), as the
reference shares one per module; the golden suite runs on a cluster of
its own at the default anti-entropy interval, as
tests/test_golden_cluster.py runs it. PILOSA_TPU_PROC_TESTS=0 skips the
file.
"""

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.client import Client, ClientError  # noqa: E402
from pilosa_tpu_torch.tools.cluster import ProcCluster, free_ports  # noqa: E402,E501

from tests.harness import ServerHarness  # noqa: E402
from tests.test_golden_cluster import (  # noqa: E402
    _apply_setup, _create_schema, load_golden)
from tests.test_netfault import PausableProxy, wait_until  # noqa: E402
from tests.test_torch_crashmatrix import CrashNode, _row_cols  # noqa: E402

pytestmark = pytest.mark.skipif(
    os.environ.get("PILOSA_TPU_PROC_TESTS", "1") == "0",
    reason="process cluster tests disabled")

ANTI_ENTROPY_2S = '[anti-entropy]\ninterval = "2s"\n'
_CWD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    """The TPU package's single node, fed the same writes."""
    h = ServerHarness()
    h.client.create_index("ci")
    h.client.create_field("ci", "f")
    yield h
    h.close()
    shutil.rmtree(h.data_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def cluster():
    # 60 s: an import during a node pause blocks until the forward to the
    # frozen node times out (~30 s)
    c = ProcCluster(3, replica_n=2, config=ANTI_ENTROPY_2S,
                    client_timeout=60)
    try:
        c.wait_ready()
        c.clients[0].create_index("ci")
        c.clients[0].create_field("ci", "f")
        time.sleep(1.0)  # DDL broadcast settles
        yield c
    finally:
        codes = c.close()
        c.remove_dirs()
    # every node stops cleanly on SIGTERM (nothing had to be killed)
    assert codes == [0, 0, 0], codes


def _counts(cluster, index, pql):
    return [cl.query(index, pql)["results"][0] for cl in cluster.clients]


def _ref_count(ref, index, pql):
    return ref.client.query(index, pql)["results"][0]


def test_schema_replicates(cluster):
    for cl in cluster.clients:
        names = {i["name"] for i in cl.schema()["indexes"]}
        assert "ci" in names


def test_import_visible_from_every_node(cluster, ref):
    rows = [1] * 600
    cols = [i * (SHARD_WIDTH // 100) for i in range(600)]  # ~6 shards
    cluster.clients[0].import_bits("ci", "f", rows, cols)
    ref.client.import_bits("ci", "f", rows, cols)
    want = _ref_count(ref, "ci", "Count(Row(f=1))")
    assert want == 600
    assert _counts(cluster, "ci", "Count(Row(f=1))") == [want] * 3


def test_convergence_after_node_pause(cluster, ref):
    """Import while node 2 is frozen; after it thaws, anti-entropy must
    repair its replicas (reference: clustertests cluster_test.go:68-78)."""
    rows = [7] * 500
    cols = [i * (SHARD_WIDTH // 80) for i in range(500)]
    ref.client.import_bits("ci", "f", rows, cols)
    want = _ref_count(ref, "ci", "Count(Row(f=7))")
    cluster.pause(2)
    try:
        try:
            cluster.clients[0].import_bits("ci", "f", rows, cols)
        except Exception as e:
            raise AssertionError(
                f"import during pause failed: {e}\n--- node0 log:\n"
                + cluster.tail(0)) from e
        live = [cluster.clients[i].query("ci", "Count(Row(f=7))")
                ["results"][0] for i in (0, 1)]
        assert live == [want, want]
    finally:
        cluster.resume(2)
    deadline = time.time() + 120
    last = None
    while time.time() < deadline:
        try:
            last = _counts(cluster, "ci", "Count(Row(f=7))")
            if last == [want] * 3:
                break
        except (ClientError, OSError):
            pass
        time.sleep(2)
    assert last == [want] * 3, f"cluster did not converge: {last}"


def test_kill9_recovery_single_node(tmp_path):
    """SIGKILL a port server after acknowledged writes, restart it on the
    same data dir: every acknowledged bit is back, held to the TPU
    package's count of the same writes, and the fragment files pass
    `check`."""
    from pilosa_tpu_torch.cli import main as cli_main

    port = free_ports(1)[0]
    datadir = str(tmp_path / "k9")

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server",
             "--device", "cpu", "--bind", f"127.0.0.1:{port}",
             "--data-dir", datadir],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=_CWD)

    def wait_ready(client, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                client.status()
                return
            except Exception:  # noqa: BLE001 — still booting
                time.sleep(0.2)
        raise TimeoutError("server not ready")

    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    proc = spawn()
    client = Client(f"http://127.0.0.1:{port}", timeout=30)
    try:
        wait_ready(client)
        cols = list(range(0, 3_000_000, 1009))
        for c in (client, ref.client):
            c.create_index("k9")
            c.create_field("k9", "f", {"type": "set"})
            c.import_bits("k9", "f", [0] * len(cols), cols)
            # single Set()s land in the op log, not the import path
            for i in range(20):
                c.query("k9", f"Set({10_000_000 + i}, f=0)")
        want = ref.client.query("k9", "Count(Row(f=0))")["results"][0]
        assert want == len(cols) + 20
        assert client.query("k9", "Count(Row(f=0))")["results"][0] == want

        proc.send_signal(signal.SIGKILL)  # no shutdown hooks run
        proc.wait(timeout=10)
        proc = spawn()
        wait_ready(client)
        got = client.query("k9", "Count(Row(f=0))")["results"][0]
        assert got == want, f"lost acknowledged writes: {got} != {want}"
        frag_files = [os.path.join(root, f)
                      for root, _dirs, files in os.walk(datadir)
                      for f in files if f.isdigit()]
        assert frag_files, "no fragment files found"
        assert cli_main(["check", *frag_files]) == 0
    finally:
        proc.kill()
        proc.wait(timeout=10)
        ref.close()


@pytest.fixture(scope="module")
def golden_cluster():
    """A 3-node, replicas-2 cluster at the default anti-entropy interval,
    as tests/test_golden_cluster.py runs the golden cases. The module's
    shared cluster syncs replicas every 2 s for the convergence case,
    and anti-entropy merges a block to the union of two replicas: a run
    that lands between the replicas' halves of the cases' ClearRow (or
    Store) sets the row's bits again on the replica that had cleared
    them, which a loaded host made likely enough to fail the case."""
    c = ProcCluster(3, replica_n=2, client_timeout=60)
    try:
        c.wait_ready()
        yield c
    finally:
        codes = c.close()
        c.remove_dirs()
    assert codes == [0, 0, 0], codes


def _wait_schema(clients, index, fields, timeout=60):
    """Every node lists `index` with every one of `fields`."""
    deadline = time.time() + timeout
    while True:
        have = []
        for cl in clients:
            idx = [i for i in cl.schema()["indexes"] if i["name"] == index]
            have.append(set() if not idx else
                        {f["name"] for f in idx[0].get("fields", [])})
        if all(fields <= h for h in have):
            return
        assert time.time() < deadline, f"schema never reached: {have}"
        time.sleep(0.1)


def test_golden_over_http_cluster(golden_cluster):
    """The 43 golden cases through every node in turn, against the wants
    the TPU package's executor produced."""
    cluster = golden_cluster
    setup, cases = load_golden()
    _create_schema(cluster.clients[0])
    _wait_schema(cluster.clients, "gold",
                 {"f", "g", "m", "b", "v", "t", "kf", "w"})
    _apply_setup(cluster.clients[0], setup)
    assert len(cases) == 43
    failures = []
    for node, client in enumerate(cluster.clients):
        for name, pql, want, whole in cases:
            results = client.query("gold", pql)["results"]
            got = results if whole else results[0]
            if got != want:
                failures.append(f"{name} (via node {node}): {pql}\n"
                                f"  got:  {got}\n  want: {want}")
    assert not failures, "\n".join(failures)


# ----------------------------------------------------------------- join

def _wait_members(clients, n, timeout=60):
    deadline = time.time() + timeout
    statuses = []
    while time.time() < deadline:
        try:
            statuses = [c.status() for c in clients]
        except Exception:  # noqa: BLE001 — a member still booting
            time.sleep(0.3)
            continue
        if all(len(s["nodes"]) == n and s["state"] == "NORMAL"
               for s in statuses):
            return
        time.sleep(0.3)
    raise AssertionError("join never converged: " + str(
        [(len(s["nodes"]), s["state"]) for s in statuses]))


def test_dynamic_join(tmp_path):
    c = ProcCluster(2, replica_n=1, base_dir=str(tmp_path),
                    client_timeout=30)
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    try:
        c.wait_ready()
        cols = [s * SHARD_WIDTH + off for s in range(6) for off in (1, 9)]
        for cl in (c.clients[0], ref.client):
            cl.create_index("j")
            cl.create_field("j", "f")
        time.sleep(0.5)
        for cl in (c.clients[0], ref.client):
            cl.import_bits("j", "f", [1] * len(cols), cols)
        want = ref.client.query("j", "Count(Row(f=1))")["results"][0]
        assert want == len(cols)
        assert c.clients[0].query("j", "Count(Row(f=1))")["results"][0] \
            == want

        joiner = c.join(seed=0)
        _wait_members(c.clients, 3)
        for cl in c.clients:
            assert cl.query("j", "Count(Row(f=1))")["results"][0] == want
        shard_sets = [set(cl.index_shards("j").get("shards", []))
                      for cl in c.clients]
        assert shard_sets[joiner], "joiner owns no shards after resize"

        free_col = 7 * SHARD_WIDTH + 3
        c.clients[joiner].query("j", f"Set({free_col}, f=1)")
        ref.client.query("j", f"Set({free_col}, f=1)")
        want = ref.client.query("j", "Count(Row(f=1))")["results"][0]
        time.sleep(0.5)
        for cl in c.clients:
            assert cl.query("j", "Count(Row(f=1))")["results"][0] == want
    finally:
        c.close()
        ref.close()


def test_join_under_concurrent_writes(tmp_path):
    """A node joins WHILE writes are in flight: every acknowledged write
    is visible from every node after convergence (a write applied whose
    response was lost in the resize churn may push the count up to the
    attempted ceiling)."""
    c = ProcCluster(2, replica_n=1, base_dir=str(tmp_path),
                    client_timeout=30)
    try:
        c.wait_ready()
        c.clients[0].create_index("jw")
        c.clients[0].create_field("jw", "f")
        time.sleep(0.5)
        stop = threading.Event()
        landed, attempted = [], []
        lock = threading.Lock()

        def writer():
            wc = Client(f"http://{c.hosts[0]}", timeout=30)
            i = 0
            while not stop.is_set():
                col = (i % 8) * SHARD_WIDTH + 100 + i
                with lock:
                    attempted.append(col)
                try:
                    wc.query("jw", f"Set({col}, f=1)")
                except Exception:  # noqa: BLE001 — resize window rejects
                    pass
                else:
                    with lock:
                        landed.append(col)
                i += 1
                time.sleep(0.01)

        t = threading.Thread(target=writer)
        t.start()
        try:
            time.sleep(0.5)
            c.join(seed=0)
            _wait_members(c.clients, 3)
            time.sleep(1.0)
        finally:
            stop.set()
            t.join(timeout=60)
        with lock:
            want = len(set(landed))
            ceiling = len(set(attempted))
        assert want > 0
        time.sleep(0.5)
        for cl in c.clients:
            got = cl.query("jw", "Count(Row(f=1))")["results"][0]
            assert want <= got <= ceiling, (want, got, ceiling)
        # the acknowledged columns themselves, not only their number
        got_cols = set(c.clients[0].query(
            "jw", "Row(f=1)")["results"][0]["columns"])
        assert set(landed) <= got_cols
    finally:
        c.close()


# ------------------------------------------------------------- netfault

def test_partition_degraded_reads_and_heal(tmp_path):
    """Blackhole one node's network (its process stays alive): the live
    nodes mark it DOWN through hung probes and keep answering through the
    replicas; after the heal anti-entropy repairs it. Counts are held to
    the TPU package's on the same imports."""
    n = 3
    ports = free_ports(2 * n)
    real, proxy = ports[:n], ports[n:]
    proxies = [PausableProxy(pp, rp) for pp, rp in zip(proxy, real)]
    hosts = ",".join(f"127.0.0.1:{p}" for p in proxy)
    procs, logs = [], []
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    try:
        for i in range(n):
            d = tmp_path / f"node{i}"
            d.mkdir()
            cfg = d / "config.toml"
            cfg.write_text(ANTI_ENTROPY_2S)
            log = open(d / "server.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch", "server",
                 "--device", "cpu", "--bind", f"127.0.0.1:{real[i]}",
                 "--node-id", f"127.0.0.1:{proxy[i]}",
                 "--data-dir", str(d), "--cluster-hosts", hosts,
                 "--replicas", "2", "--config", str(cfg)],
                stdout=log, stderr=subprocess.STDOUT, cwd=_CWD))
        clients = [Client(f"http://127.0.0.1:{p}", timeout=30)
                   for p in proxy]
        assert wait_until(lambda: all(cl.status() for cl in clients),
                          timeout=90)

        def node_states(via):
            return {nd["id"]: nd.get("state")
                    for nd in clients[via].status().get("nodes", [])}

        cols = list(range(0, 6 * SHARD_WIDTH, 50_021))
        for cl in (clients[0], ref.client):
            cl.create_index("nf")
            cl.create_field("nf", "f", {"type": "set"})
        time.sleep(1.0)
        for cl in (clients[0], ref.client):
            cl.import_bits("nf", "f", [0] * len(cols), cols)
        want = ref.client.query("nf", "Count(Row(f=0))")["results"][0]
        assert wait_until(lambda: clients[0].query(
            "nf", "Count(Row(f=0))")["results"][0] == want)

        victim = 2
        victim_id = f"127.0.0.1:{proxy[victim]}"
        proxies[victim].pause()
        assert wait_until(lambda: node_states(0).get(victim_id) == "DOWN",
                          timeout=60), "partitioned node never marked DOWN"
        for i in (0, 1):
            got = clients[i].query("nf", "Count(Row(f=0))")["results"][0]
            assert got == want, f"degraded read via node {i}: {got}"
        extra = [c0 + 1 for c0 in cols]
        for cl in (clients[0], ref.client):
            cl.import_bits("nf", "f", [0] * len(extra), extra)
        want2 = ref.client.query("nf", "Count(Row(f=0))")["results"][0]
        assert wait_until(lambda: clients[0].query(
            "nf", "Count(Row(f=0))")["results"][0] == want2)

        proxies[victim].resume()
        assert wait_until(lambda: node_states(0).get(victim_id) != "DOWN",
                          timeout=60), "healed node never recovered"
        assert wait_until(lambda: clients[victim].query(
            "nf", "Count(Row(f=0))")["results"][0] == want2, timeout=60), \
            "anti-entropy did not reconverge the healed node"
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for log in logs:
            log.close()
        for px in proxies:
            px.close()
        ref.close()


# ------------------------------------------------------- resize + crash

def test_crash_mid_resize_drain():
    """Remove a node while importing: writes during RESIZING are queued
    (and acked — they're in the oplog). Kill the coordinator on the 2nd
    drained record; after restart, boot replay delivers the whole queued
    backlog and resize_replay_dropped stays 0."""
    ports = free_ports(2)
    hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
    dirs = [tempfile.mkdtemp(prefix="pilosa-torch-crashrz-") for _ in ports]
    nodes = [CrashNode(p, d, extra_args=[
                 "--cluster-hosts", hosts, "--replicas", "1"])
             for p, d in zip(ports, dirs)]
    try:
        for nd in nodes:
            nd.spawn()
        for nd in nodes:
            nd.wait_ready()
        st = nodes[0].client.status()
        coord_uri = next(nd["uri"] for nd in st["nodes"]
                         if nd.get("isCoordinator"))
        coord = next(nd for nd in nodes if str(nd.port) in coord_uri)
        victim = next(nd for nd in nodes if nd is not coord)
        victim_id = next(nd["id"] for nd in st["nodes"]
                         if str(victim.port) in nd["uri"])

        coord.client.create_index("rz")
        coord.client.create_field("rz", "f")
        time.sleep(0.5)
        base_cols = [s * SHARD_WIDTH + 1 for s in range(8)]
        coord.client.import_bits("rz", "f", [1] * len(base_cols), base_cols)

        coord.arm("resize.fetch=delay:0.8", "resize.drain.apply=exit@2")
        coord.client.resize_remove_node(victim_id)
        acked = list(base_cols)
        i = 0
        while coord.proc.poll() is None and i < 400:
            col = 500 + i
            i += 1
            try:
                coord.client.import_bits("rz", "f", [1], [col])
                acked.append(col)
            except Exception:  # noqa: BLE001 — the crash cut it
                break
            time.sleep(0.01)
        coord.wait_crash(timeout=120)
        assert len(acked) > len(base_cols), \
            "no writes were queued during the resize window"

        coord.spawn().wait_ready()
        got = _row_cols(coord.client, "rz", 1)
        missing = set(acked) - got
        assert not missing, \
            f"lost {len(missing)} acked writes across resize-drain " \
            f"crash: {sorted(missing)[:10]}..."
        dbg = coord.client._request("GET", "/debug/vars")
        dropped = [v for k, v in dbg.items()
                   if "resize_replay_dropped" in str(k)]
        assert all(not v for v in dropped), \
            f"resize_replay_dropped nonzero: {dropped}"
    finally:
        for nd in nodes:
            nd.close()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
