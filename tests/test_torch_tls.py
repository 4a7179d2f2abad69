"""TLS and CORS of the port's server (reference: server/tlsconfig.go,
tls.certificate/key config; http/handler.go:83-91 allowed origins).

`tests/test_tls.py` ported to the port's server, with the pair made by
the openssl binary as there (skipped when openssl is unavailable):
HTTPS end to end (a Count over JSON and over protobuf), a stalled TLS
client does not block accept, and `reload_tls` rotates the served pair
and keeps the last good one on a bad rotation. Beside them: SIGHUP to a
`server --tls-certificate --tls-key` child process reloads the pair the
same way, and the CORS headers and preflight of the reference's
`tests/test_http.py` (`test_cors_allowed_origins`,
`test_cors_disabled_by_default`) against the port's server.
"""

import os
import shutil
import signal
import socket
import ssl
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.client import Client
from pilosa_tpu_torch.server.http_server import PilosaHTTPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_openssl = pytest.mark.skipif(
    shutil.which("openssl") is None, reason="openssl not available")


def _mk_cert(path_prefix, cn):
    cert, key = f"{path_prefix}.pem", f"{path_prefix}.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", f"/CN={cn}",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return cert, key


@pytest.fixture
def certs(tmp_path):
    return _mk_cert(str(tmp_path / "c"), "127.0.0.1")


def _server(tmp_path, name, **kw):
    holder = Holder(str(tmp_path / name)).open()
    srv = PilosaHTTPServer(API(holder, device="cpu"), host="127.0.0.1",
                           port=0, **kw).start()
    return holder, srv


@needs_openssl
def test_https_end_to_end(tmp_path, certs):
    cert, key = certs
    holder, srv = _server(tmp_path, "data", tls_cert=cert, tls_key=key)
    try:
        assert srv.uri.startswith("https://")
        client = Client(srv.uri, ca_cert=cert)
        client.create_index("t")
        client.create_field("t", "f")
        client.query("t", "Set(1, f=2)")
        assert client.query("t", "Count(Row(f=2))")["results"] == [1]
        # the protobuf wire over the same TLS listener
        assert client.query_proto("t", "Count(Row(f=2))") == ([1], None)
        # skip-verify mode also works (self-signed without the CA)
        c2 = Client(srv.uri, tls_skip_verify=True)
        assert c2.query("t", "Count(Row(f=2))")["results"] == [1]
    finally:
        srv.stop()
        holder.close()


@needs_openssl
def test_stalled_client_does_not_block_accept(tmp_path, certs):
    """A TCP client that never sends a ClientHello must not wedge the
    accept loop (the handshake is deferred to the worker thread)."""
    cert, key = certs
    holder, srv = _server(tmp_path, "data2", tls_cert=cert, tls_key=key)
    try:
        stalled = socket.create_connection(("127.0.0.1", srv.port))
        try:
            client = Client(srv.uri, ca_cert=cert, timeout=10)
            client.create_index("t2")
            assert "t2" in {i["name"]
                            for i in client.schema()["indexes"]}
        finally:
            stalled.close()
    finally:
        srv.stop()
        holder.close()


def _served_cn(address):
    host, port = urllib.parse.urlparse(address).netloc.split(":")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    with socket.create_connection((host, int(port)), timeout=5) as sock:
        with ctx.wrap_socket(sock, server_hostname=host) as tls:
            der = tls.getpeercert(binary_form=True)
    with tempfile.NamedTemporaryFile(suffix=".der") as f:
        f.write(der)
        f.flush()
        out = subprocess.run(
            ["openssl", "x509", "-inform", "der", "-in", f.name,
             "-noout", "-subject"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


@needs_openssl
def test_sighup_style_keypair_reload(tmp_path):
    """reload_tls() re-reads the cert/key files in place: new handshakes
    serve the rotated keypair without a restart; a broken keypair is
    rejected and the old one keeps serving (reference: keypairReloader
    server/tlsconfig.go:68-90 + maybeReload)."""
    cert, key = _mk_cert(str(tmp_path / "old"), "old.example")
    holder, srv = _server(tmp_path, "data", tls_cert=cert, tls_key=key)
    try:
        assert "old.example" in _served_cn(srv.uri)
        new_cert, new_key = _mk_cert(str(tmp_path / "new"), "new.example")
        shutil.copy(new_cert, cert)
        shutil.copy(new_key, key)
        srv.reload_tls()
        assert "new.example" in _served_cn(srv.uri)
        # the KEY failure is the dangerous stage: a naive load on the
        # live context installs the new cert before it finds the key
        # mismatch, failing every later handshake
        third_cert, _ = _mk_cert(str(tmp_path / "third"), "third.example")
        shutil.copy(third_cert, cert)  # cert rotated, key NOT -> mismatch
        with pytest.raises(Exception):
            srv.reload_tls()
        assert "new.example" in _served_cn(srv.uri)
        with open(cert, "w") as f:
            f.write("not a pem")
        with pytest.raises(Exception):
            srv.reload_tls()
        assert "new.example" in _served_cn(srv.uri)
    finally:
        srv.stop()
        holder.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@needs_openssl
def test_sighup_reloads_the_pair_of_a_server_process(tmp_path):
    """SIGHUP to `python -m pilosa_tpu_torch server --tls-certificate
    --tls-key` rotates the pair; a bad pair keeps the last good one and
    the server keeps serving; SIGTERM still stops it cleanly. Every wait
    is bounded (boot 120 s, reload 30 s, stop 120 s)."""
    cert, key = _mk_cert(str(tmp_path / "srv"), "first.example")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device",
         "cpu", "--bind", f"127.0.0.1:{port}", "--data-dir",
         str(tmp_path / "data"), "--tls-certificate", cert, "--tls-key",
         key, "--allowed-origins", "http://ui.example"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    uri = f"https://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                Client(uri, tls_skip_verify=True, timeout=2,
                       retries=0).info()
                break
            except Exception:  # noqa: BLE001 — still booting
                if proc.poll() is not None or time.time() > deadline:
                    proc.kill()
                    raise AssertionError(proc.communicate(timeout=60)[1])
                time.sleep(0.2)
        assert "first.example" in _served_cn(uri)
        new_cert, new_key = _mk_cert(str(tmp_path / "b"), "second.example")
        shutil.copy(new_cert, cert)
        shutil.copy(new_key, key)
        proc.send_signal(signal.SIGHUP)
        deadline = time.time() + 30
        while "second.example" not in _served_cn(uri):
            assert time.time() < deadline, "SIGHUP did not reload the pair"
            time.sleep(0.1)
        with open(key, "w") as f:
            f.write("not a key")
        proc.send_signal(signal.SIGHUP)
        time.sleep(0.5)
        assert "second.example" in _served_cn(uri)
        c = Client(uri, tls_skip_verify=True)
        c.create_index("h")
        assert c.query("h", "Count(All())")["results"] == [0]
        req = urllib.request.Request(uri + "/version")
        req.add_header("Origin", "http://ui.example")
        ctx = ssl.create_default_context(cafile=new_cert)
        with urllib.request.urlopen(req, timeout=5, context=ctx) as resp:
            assert resp.headers["Access-Control-Allow-Origin"] \
                == "http://ui.example"
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    assert "SIGHUP: reloaded TLS certificate and key" in out
    assert "SIGHUP: keeping old TLS keypair" in out


def _get(uri, origin=None, method="GET"):
    req = urllib.request.Request(uri + "/version", method=method)
    if origin:
        req.add_header("Origin", origin)
    try:
        resp = urllib.request.urlopen(req, timeout=5)
        return resp.status, resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.headers


def test_cors_allowed_origins(tmp_path):
    """CORS headers appear only when the server is configured with
    allowed origins and the request Origin matches."""
    holder, srv = _server(tmp_path, "cors",
                          allowed_origins=["http://example.com"])
    try:
        _, headers = _get(srv.uri, "http://example.com")
        assert headers.get("Access-Control-Allow-Origin") \
            == "http://example.com"
        assert headers.get("Vary") == "Origin"
        _, headers = _get(srv.uri, "http://evil.example")
        assert headers.get("Access-Control-Allow-Origin") is None
        _, headers = _get(srv.uri, None)
        assert headers.get("Access-Control-Allow-Origin") is None
        status, headers = _get(srv.uri, "http://example.com",
                               method="OPTIONS")
        assert status == 200
        assert "POST" in headers.get("Access-Control-Allow-Methods", "")
        assert headers.get("Access-Control-Allow-Headers") == "Content-Type"
        status, _ = _get(srv.uri, "http://evil.example", method="OPTIONS")
        assert status == 403
    finally:
        srv.stop()
        holder.close()


def test_cors_wildcard_and_disabled_by_default(tmp_path):
    holder, srv = _server(tmp_path, "cors2", allowed_origins=["*"])
    try:
        _, headers = _get(srv.uri, "http://any.example")
        assert headers.get("Access-Control-Allow-Origin") == "*"
    finally:
        srv.stop()
        holder.close()
    holder, srv = _server(tmp_path, "cors3")
    try:
        _, headers = _get(srv.uri, "http://example.com")
        assert headers.get("Access-Control-Allow-Origin") is None
        assert headers.get("Vary") is None
    finally:
        srv.stop()
        holder.close()


def test_cors_headers_equal_reference(tmp_path):
    """The same requests to both servers, each with the same allowed
    origins: equal status and CORS headers."""
    pytest.importorskip("jax")
    from pilosa_tpu.core import Holder as JHolder
    from pilosa_tpu.server import API as JAPI
    from pilosa_tpu.server import PilosaHTTPServer as JServer

    jholder = JHolder(str(tmp_path / "ref"), use_snapshot_queue=False).open()
    ref = JServer(JAPI(jholder), host="127.0.0.1", port=0,
                  allowed_origins=["http://a.example", "http://b.example"]
                  ).start()
    holder, srv = _server(
        tmp_path, "port",
        allowed_origins=["http://a.example", "http://b.example"])
    names = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
             "Access-Control-Allow-Headers", "Vary")
    try:
        for origin in ("http://a.example", "http://b.example",
                       "http://c.example", None):
            for method in ("GET", "OPTIONS"):
                want = _get(ref.address, origin, method)
                got = _get(srv.uri, origin, method)
                assert got[0] == want[0], (origin, method)
                assert [got[1].get(n) for n in names] \
                    == [want[1].get(n) for n in names], (origin, method)
    finally:
        srv.stop()
        holder.close()
        ref.stop()
        jholder.close()
