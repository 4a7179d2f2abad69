"""Crash matrix of the port's server: kill a real `python -m
pilosa_tpu_torch server --device cpu` subprocess at armed fault points
under load, restart it on the same data directory, and prove that no
acknowledged import is lost — rounds 1-4 of tests/test_crashmatrix.py.

Each round arms one fault point over HTTP (POST /debug/faultpoints) on a
server running with `--fsync always`, drives imports until the armed
`exit` action kills the process with os._exit(86) (no atexit, no
finally — a hard crash), then restarts the server and asserts every
acknowledged column is readable. The rounds chain on ONE data directory,
so each boot also replays the previous round's unapplied tail; the run
ends with the port's `check` on every fragment file.

Matrix (fault point -> crash window):
  import.post-append       appended, not applied, not acked
  import.pre-ack           appended + applied, not acked
  oplog.fsync              inside fsync, concurrent ingest
  fragment.snapshot.rename between snapshot temp write and rename

Gated by PILOSA_TPU_PROC_TESTS=0 like tests/test_crashmatrix.py.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from pilosa_tpu_torch.cli import main as cli_main
from pilosa_tpu_torch.server import Client
from pilosa_tpu_torch.utils.faultpoints import EXIT_CODE

pytestmark = pytest.mark.skipif(
    os.environ.get("PILOSA_TPU_PROC_TESTS", "1") == "0",
    reason="process cluster tests disabled")

_CWD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CrashNode:
    """One restartable port server subprocess on a fixed port + data
    directory."""

    def __init__(self, port, datadir, extra_args=()):
        self.port = port
        self.datadir = datadir
        self.extra_args = list(extra_args)
        self.logpath = os.path.join(datadir, "server.log")
        self.proc = None
        self.client = Client(f"http://127.0.0.1:{port}",
                             timeout=30, retries=0)

    def spawn(self):
        log = open(self.logpath, "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server",
             "--device", "cpu", "--bind", f"127.0.0.1:{self.port}",
             "--data-dir", self.datadir, "--fsync", "always",
             *self.extra_args],
            stdout=log, stderr=subprocess.STDOUT, cwd=_CWD)
        log.close()
        return self

    def wait_ready(self, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"server exited rc={self.proc.returncode}: "
                    + self.tail())
            try:
                self.client._request("GET", "/status")
                return self
            except Exception:
                time.sleep(0.1)
        raise TimeoutError("server not ready: " + self.tail())

    def wait_crash(self, timeout=60):
        """Block until the armed exit fires; assert the fault exit code."""
        rc = self.proc.wait(timeout=timeout)
        assert rc == EXIT_CODE, \
            f"expected fault exit {EXIT_CODE}, got {rc}: " + self.tail()
        return rc

    def arm(self, *specs):
        self.client._request(
            "POST", "/debug/faultpoints",
            json.dumps({"arm": list(specs)}).encode())

    def tail(self):
        try:
            with open(self.logpath) as f:
                return f.read()[-2000:]
        except OSError:
            return "<no log>"

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def _row_cols(client, index, row):
    res = client.query(index, f"Row(f={row})")
    return set(res["results"][0]["columns"])


def test_crash_matrix_single_node():
    datadir = tempfile.mkdtemp(prefix="pilosa-torch-crashmx-")
    # small max-op-n so bulk imports trip the snapshot path in round 4
    cfg = os.path.join(datadir, "config.toml")
    with open(cfg, "w") as f:
        f.write("max-op-n = 8\n")
    node = CrashNode(_free_port(), datadir, extra_args=["--config", cfg])
    try:
        node.spawn().wait_ready()
        node.client.create_index("cm")
        node.client.create_field("cm", "f")

        # -- round 1: crash after the oplog append, before apply --------
        # The write is NOT acked (the connection dies), but it reached
        # the durable log — boot replay must still apply it.
        node.arm("import.post-append=exit")
        with pytest.raises(Exception):
            node.client.import_bits("cm", "f", [1], [101])
        node.wait_crash()
        node.spawn().wait_ready()
        assert 101 in _row_cols(node.client, "cm", 1), \
            "appended record did not replay after crash: " + node.tail()
        assert "oplog: replayed 1 record(s)" in node.tail()

        # -- round 2: crash after apply, before the ack returns ---------
        node.arm("import.pre-ack=exit@3")
        acked = []
        for col in (201, 202, 203):
            try:
                node.client.import_bits("cm", "f", [2], [col])
                acked.append(col)
            except Exception:
                break
        assert acked == [201, 202]
        node.wait_crash()
        node.spawn().wait_ready()
        got = _row_cols(node.client, "cm", 2)
        assert set(acked) <= got, f"lost acked writes: {set(acked) - got}"

        # -- round 3: crash inside fsync under concurrent ingest --------
        node.arm("oplog.fsync=exit@40")
        acked3, lock = [], threading.Lock()

        def ingest(tid):
            c = Client(f"http://127.0.0.1:{node.port}",
                       timeout=10, retries=0)
            for i in range(200):
                col = 300 + tid * 1000 + i
                try:
                    c.import_bits("cm", "f", [3], [col])
                except Exception:
                    return
                with lock:
                    acked3.append(col)

        threads = [threading.Thread(target=ingest, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        node.wait_crash(timeout=60)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert acked3, "no writes acked before the fsync crash"
        node.spawn().wait_ready()
        got = _row_cols(node.client, "cm", 3)
        missing = set(acked3) - got
        assert not missing, f"lost {len(missing)} acked writes: " \
            f"{sorted(missing)[:10]}..."

        # -- round 4: crash between snapshot temp write and rename ------
        # max-op-n=8: every batched import appends one op, so ~9 batches
        # push a fragment over the threshold and the background snapshot
        # dies at the rename point mid-ingest. @3: the fragment's op
        # count carries over from round 3, so the first armed snapshot
        # can fire before anything is acked — let two pass first.
        node.arm("fragment.snapshot.rename=exit@3")
        acked4 = []
        for i in range(200):
            cols = list(range(10_000 + i * 5, 10_000 + i * 5 + 5))
            try:
                node.client.import_bits("cm", "f", [4] * len(cols), cols)
                acked4.extend(cols)
            except Exception:
                break
            if node.proc.poll() is not None:
                break
        node.wait_crash(timeout=60)
        assert acked4, "no writes acked before the snapshot crash"
        node.spawn().wait_ready()
        got = _row_cols(node.client, "cm", 4)
        missing = set(acked4) - got
        assert not missing, f"lost {len(missing)} acked writes " \
            f"across snapshot crash: {sorted(missing)[:10]}..."
        node.close()

        # fragment files still pass the port's consistency check
        frag_files = []
        for root, _dirs, files in os.walk(datadir):
            frag_files += [os.path.join(root, fn) for fn in files
                           if fn.isdigit()]
        assert frag_files, "no fragment files found"
        assert cli_main(["check", *frag_files]) == 0
    finally:
        node.close()
        shutil.rmtree(datadir, ignore_errors=True)
