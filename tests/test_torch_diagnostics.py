"""The port's diagnostics phone-home (server/diagnostics.py), on the CPU.

`tests/test_diagnostics.py` ported: posts go to a local in-test HTTP
endpoint — nothing leaves the host. The payload is anonymized and its
platform block names torch, its CUDA and the executor's card in place
of JAX's backend; the flush posts and reads a newer-version notice; a
dead endpoint never raises. Beside them: the `[diagnostics]` config
block turns the loop on in `server` (off by default) and the server's
stop ends it.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.diagnostics import Diagnostics, _version_tuple
from pilosa_tpu_torch.utils.logger import CaptureLogger


@pytest.fixture
def sink():
    """Local endpoint that records diagnostics payloads and answers with a
    configurable version."""
    received = []
    reply = {"version": "0.0.0"}

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            body = json.dumps(reply).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/diag"
    yield received, reply, url
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=5)


def _api(tmp_path):
    holder = Holder(str(tmp_path)).open()
    api = API(holder, device="cpu")
    api.create_index("d1")
    api.create_field("d1", "f")
    api.import_bits("d1", "f", [1], [5])
    return holder, api


def test_payload_is_anonymized(tmp_path, sink):
    import torch

    received, reply, url = sink
    holder, api = _api(tmp_path)
    try:
        p = Diagnostics(api, url).payload()
        assert p["numIndexes"] == 1 and p["numFields"] >= 1
        assert p["numShards"] == 1 and p["numNodes"] == 1
        blob = json.dumps(p)
        assert "d1" not in blob and "uri" not in blob
        # the platform block: torch, its CUDA, the card (none on a CPU
        # executor, and no CUDA initialized to find out)
        assert p["torch"] == torch.__version__
        assert p["cuda"] == torch.version.cuda
        assert (p["backend"], p["numDevices"], p["deviceName"]) \
            == ("cpu", 0, None)
        assert not torch.cuda.is_initialized()
    finally:
        holder.close()


def test_flush_posts_and_checks_version(tmp_path, sink):
    received, reply, url = sink
    reply["version"] = "99.0.0"
    holder, api = _api(tmp_path)
    log = CaptureLogger()
    try:
        d = Diagnostics(api, url, logger=log)
        d.flush()
        assert len(received) == 1
        assert received[0]["version"]
        assert any("newer" in line for line in log.lines)
    finally:
        holder.close()


def test_flush_survives_dead_endpoint(tmp_path):
    holder, api = _api(tmp_path)
    try:
        d = Diagnostics(api, "http://127.0.0.1:9/nope")
        d.flush()  # must not raise
        assert d.last_response is None
    finally:
        holder.close()


def test_version_compare():
    assert _version_tuple("v1.2.3") == (1, 2, 3)
    d = Diagnostics.__new__(Diagnostics)
    d.logger = CaptureLogger()
    assert d.check_version({"version": "0.0.1"}) is False
    assert d.check_version({}) is False


def test_server_config_block_starts_and_stops_the_loop(tmp_path, sink):
    """`[diagnostics] enabled = true` + an endpoint in the config file
    starts the loop with the server (its first flush posts at once);
    without the block the server runs none."""
    import time

    from pilosa_tpu_torch.cli import start_server

    received, _, url = sink
    plain = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                          str(tmp_path / "a"), "--device", "cpu"])
    try:
        assert plain.diagnostics is None
    finally:
        plain.stop()
    conf = tmp_path / "c.toml"
    conf.write_text(f'[diagnostics]\nenabled = true\nendpoint = "{url}"\n'
                    'interval = "1h"\n')
    srv = start_server(["--config", str(conf), "--bind", "127.0.0.1:0",
                        "--data-dir", str(tmp_path / "b"), "--device",
                        "cpu"])
    try:
        deadline = time.time() + 10
        while not received and time.time() < deadline:
            time.sleep(0.02)
        assert received and received[0]["backend"] == "cpu"
    finally:
        srv.stop()
    assert not srv.diagnostics._thread.is_alive()
