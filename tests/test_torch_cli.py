"""The port's command line and Client against the TPU package's, on the
CPU.

`generate-config`, `config` and `holder` print what the TPU package's
print for the same input (apart from the port's default data directory).
`import` (set, int, time and keyed CSVs), `export`, `backup`, `restore`,
`inspect` and `check` run against two servers in this process, the TPU
package's (JAX on the CPU) and the port's (`--device cpu`), each over
its own data directory, and every answer must be equal; a backup made by
either package restores into the other. The Client's retry, Retry-After
and deadline cases of `tests/test_oplog.py` run against a scripted
server, and the node-internal routes (/internal/*) and
/debug/faultpoints are held to the TPU package's server request by
request. Tolerance: exact equality.
"""

import glob
import io
import json
import os
import threading
import time
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
tomllib = pytest.importorskip("tomllib")

from pilosa_tpu.cli import main as jax_main  # noqa: E402
from pilosa_tpu.core import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cli import main, start_server  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402
from pilosa_tpu_torch.server.client import (  # noqa: E402
    ClientError, DeadlineExceeded)

from tests.harness import ServerHarness  # noqa: E402
from tests.test_torch_http_surface import Pair  # noqa: E402


def _run(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(argv):
    """(rc, stdout) of the port's CLI after checking the TPU package's
    gave the same."""
    want = _run(jax_main, argv)
    got = _run(main, argv)
    assert got == want, (got, want)
    return got


@pytest.fixture
def servers(tmp_path):
    """{"jax": address, "port": address} of two empty servers."""
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        yield {"jax": ref.address, "port": port.uri}
    finally:
        port.stop()
        ref.close()


MAINS = {"jax": jax_main, "port": main}


def _each(servers, argv_of):
    """Run the CLI of each package against its own server; returns
    {package: (rc, stdout)}."""
    return {name: _run(MAINS[name], argv_of(uri))
            for name, uri in servers.items()}


def _query(servers, index, pql):
    """The port server's answer after checking the TPU package's."""
    out = {name: Client(uri).query(index, pql)
           for name, uri in servers.items()}
    assert out["port"] == out["jax"], (pql, out)
    return out["port"]["results"]


# -- configuration and diagnostics ----------------------------------------


def test_generate_config_has_the_reference_keys():
    rc, out = _run(main, ["generate-config"])
    _, want = _run(jax_main, ["generate-config"])
    assert rc == 0
    cfg, ref = tomllib.loads(out), tomllib.loads(want)
    assert cfg["data-dir"] == "~/.pilosa_tpu_torch"
    cfg["data-dir"] = ref["data-dir"]
    assert cfg == ref
    assert cfg["bind"] == "127.0.0.1:10101"


@pytest.mark.parametrize("argv", [
    ["--max-writes-per-request", "3"],
    ["--bind", "0.0.0.0:1234", "--fsync", "always", "--no-oplog",
     "--oplog-segment-bytes", "4096", "--container-repr", "dense",
     "--coalesce-window", "1ms", "--coalesce-max-queue", "9"],
])
def test_config_prints_effective_merge(tmp_path, monkeypatch, argv):
    """file < env < flags, as the TPU package merges and prints it."""
    p = tmp_path / "c.toml"
    p.write_text('bind = "10.0.0.1:7777"\nmax-op-n = 5\n'
                 '[storage]\nfsync = "interval"\n'
                 '[[cluster.nodes]]\nhost = "n1:10101"\n')
    monkeypatch.setenv("PILOSA_TPU_DATA_DIR", "/env/dir")
    rc, out = _both(["config", "--config", str(p), *argv])
    assert rc == 0
    cfg = tomllib.loads(out)
    assert cfg["data-dir"] == "/env/dir"           # env beats default
    assert cfg["max-op-n"] == 5                    # file
    assert cfg["cluster"]["nodes"] == [{"host": "n1:10101"}]
    if "--bind" in argv:                           # flag beats file
        assert cfg["bind"] == "0.0.0.0:1234"
        assert cfg["storage"] == {"fsync": "always", "oplog": False,
                                  "oplog-segment-bytes": 4096}
    else:
        assert cfg["bind"] == "10.0.0.1:7777"
        assert cfg["max-writes-per-request"] == 3


def test_holder_command(tmp_path, monkeypatch):
    """`holder` loads a data directory written by the TPU package and
    prints what the TPU package prints, without touching a device."""
    d = str(tmp_path / "hd")
    h = JaxHolder(d).open()
    idx = h.create_index("diag")
    idx.create_field("f")
    idx.create_field("v", JaxFieldOptions.int_field(min=0, max=10))
    idx.field("f").set_bit(1, 2)
    h.close()
    monkeypatch.delenv("PILOSA_TPU_DATA_DIR", raising=False)
    rc, out = _both(["holder", "--data-dir", d])
    assert rc == 0
    assert "indexes: 1" in out
    assert "diag: " in out and "f(set)" in out and "v(int)" in out
    # a mistyped path must error, not be silently created and blessed
    assert _both(["holder", "--data-dir", str(tmp_path / "typo")])[0] == 1
    assert not torch.cuda.is_initialized()


# -- import and export ----------------------------------------------------


def _csv(path, lines):
    path.write_text("".join(",".join(map(str, ln)) + "\n" for ln in lines))
    return str(path)


def test_import_set_int_time_csv(servers, tmp_path):
    sets = [(1, 5), (1, SHARD_WIDTH + 9), (2, 7), (3, 3 * SHARD_WIDTH),
            (1, 6), (2, 2 * SHARD_WIDTH + 1)]
    ints = [(5, 33), (7, 44), (SHARD_WIDTH + 2, -3), (9, 1000)]
    times = [(1, 4, "2024-03-05T10:00"), (1, 8, "2024-04-01T00:00"),
             (2, 4, "")]
    files = {"set": _csv(tmp_path / "s.csv", sets),
             "int": _csv(tmp_path / "i.csv", ints),
             "time": _csv(tmp_path / "t.csv", times)}
    for ftype, fname, extra in (("set", "f", []),
                                ("int", "v", ["--min", "-10"]),
                                ("time", "t", ["--time-quantum", "YMD"])):
        out = _each(servers, lambda uri: [
            "import", "--host", uri, "--index", "im", "--field", fname,
            "--create", "--field-type", ftype, "--batch-size", "2", *extra,
            files[ftype]])
        assert out["port"] == out["jax"], out
        assert out["port"][0] == 0
    assert _query(servers, "im", "Count(Row(f=1))") == [3]
    assert _query(servers, "im", "Row(f=2)")[0]["columns"] == [
        7, 2 * SHARD_WIDTH + 1]
    assert _query(servers, "im", "Sum(field=v)") == [
        {"value": 1074, "count": 4}]
    _query(servers, "im", "Row(v < 0)")
    assert _query(
        servers, "im",
        "Row(t=1, from=2024-03-04T00:00, to=2024-03-06T00:00)"
    )[0]["columns"] == [4]
    _query(servers, "im", "Count(Not(Row(f=1)))")
    assert [i["name"] for i in Client(servers["port"]).schema()["indexes"]] \
        == ["im"]


def test_import_keyed_csv(servers, tmp_path):
    for uri in servers.values():
        c = Client(uri)
        c.create_index("ki", keys=True)
        c.create_field("ki", "kf", {"keys": True})
        c.create_field("ki", "n", {"type": "int", "min": 0, "max": 100})
    keyed = _csv(tmp_path / "k.csv", [("red", "c1"), ("blue", "c2"),
                                      ("red", "c3"), ("green", "c1")])
    vals = _csv(tmp_path / "n.csv", [("c1", 4), ("c3", 9)])
    for fname, ftype, path in (("kf", "set", keyed), ("n", "int", vals)):
        out = _each(servers, lambda uri: [
            "import", "--host", uri, "--index", "ki", "--field", fname,
            "--field-type", ftype, path])
        assert out["port"] == out["jax"] and out["port"][0] == 0, out
    assert _query(servers, "ki", 'Row(kf="red")')[0]["keys"] == ["c1", "c3"]
    assert _query(servers, "ki", "Sum(field=n)") == [
        {"value": 13, "count": 2}]
    _query(servers, "ki", "TopN(kf)")
    out = _each(servers, lambda uri: [
        "export", "--host", uri, "--index", "ki", "--field", "kf"])
    assert out["port"] == out["jax"]
    assert out["port"][1].splitlines() == [
        "red,c1", "red,c3", "blue,c2", "green,c1"]


def test_import_rejects_bad_record(servers, tmp_path):
    bad = _csv(tmp_path / "b.csv", [(1, 2), ("x", 3)])
    for name, uri in servers.items():
        with pytest.raises(SystemExit, match="invalid record on line 2"):
            MAINS[name](["import", "--host", uri, "--index", "i",
                         "--field", "f", "--create", bad])


def test_export_equal_csv(servers, tmp_path):
    lines = [(r, c) for r in (1, 2, 9) for c in
             (3, 70000, SHARD_WIDTH + r, 2 * SHARD_WIDTH + 5 * r)]
    path = _csv(tmp_path / "e.csv", lines)
    for name, uri in servers.items():
        assert MAINS[name](["import", "--host", uri, "--index", "ex",
                            "--field", "f", "--create", path]) == 0
    for extra in ([], ["--shards", "2"]):
        out = _each(servers, lambda uri: [
            "export", "--host", uri, "--index", "ex", "--field", "f",
            *extra])
        assert out["port"] == out["jax"], out
    rows = sorted(tuple(map(int, ln.split(",")))
                  for ln in out["port"][1].splitlines())
    assert rows == sorted((r, c) for r, c in lines if c < 2 * SHARD_WIDTH)


# -- backup, restore, inspect, check ---------------------------------------


def _populate(uri):
    c = Client(uri)
    c.create_index("bk")
    c.create_field("bk", "f")
    c.create_field("bk", "age", options={"type": "int", "min": 0,
                                          "max": 1000})
    c.create_field("bk", "t", options={"type": "time",
                                        "timeQuantum": "YM"})
    c.import_bits("bk", "f", [1, 1, 2], [5, SHARD_WIDTH + 9, 7])
    c.import_values("bk", "age", [5, 7], [33, 44])
    c.import_bits("bk", "t", [1], [5], timestamps=["2024-03-05T10:00"])
    c.create_index("other")
    c.create_field("other", "g")
    c.query("other", "Set(3, g=1)")


BACKUP_QUERIES = [
    ("bk", "Count(Row(f=1))"), ("bk", "Count(Row(f=2))"), ("bk", "Row(f=1)"),
    ("bk", "Sum(field=age)"), ("bk", "Count(Range(age > 40))"),
    ("bk", "Row(t=1, from=2024-03-01T00:00, to=2024-04-01T00:00)"),
    ("bk", "Count(Not(Row(f=1)))"), ("other", "Count(Row(g=1))"),
]


def _answers(uri):
    c = Client(uri)
    return [c.query(i, q)["results"] for i, q in BACKUP_QUERIES]


@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")])
@pytest.mark.parametrize("index", [None, "bk"])
def test_backup_restore_cycle(tmp_path, src, dst, index):
    """Populate a server, back it up with its package's CLI, restore
    into a fresh server with the other package's CLI: equal answers."""
    tar = str(tmp_path / "bk.tar")
    pair = {"jax": lambda d: ServerHarness(data_dir=d),
            "port": lambda d: start_server([
                "--bind", "127.0.0.1:0", "--data-dir", d,
                "--device", "cpu"])}

    def uri_of(s):
        return s.address if hasattr(s, "address") else s.uri

    def stop(s):
        (s.close if hasattr(s, "close") else s.stop)()

    s = pair[src](str(tmp_path / "src"))
    try:
        _populate(uri_of(s))
        want = _answers(uri_of(s))
        sel = [] if index is None else ["--index", index]
        rc, out = _run(MAINS[src], ["backup", "--host", uri_of(s), *sel,
                                    "--output", tar])
        assert rc == 0 and out.startswith(
            f"backed up {1 if index else 2} index(es)"), out
    finally:
        stop(s)
    assert os.path.exists(tar) and not os.path.exists(tar + ".partial")
    d = pair[dst](str(tmp_path / "dst"))
    try:
        rc, out = _run(MAINS[dst], ["restore", "--host", uri_of(d),
                                    "--input", tar])
        assert rc == 0 and out.startswith("restored "), out
        got = _answers(uri_of(d)) if index is None else \
            [Client(uri_of(d)).query(i, q)["results"]
             for i, q in BACKUP_QUERIES if i == index]
        assert got == (want if index is None else want[:-1])
    finally:
        stop(d)


def test_backup_output_equal_across_packages(servers, tmp_path):
    for uri in servers.values():
        _populate(uri)
    out = _each(servers, lambda uri: [
        "backup", "--host", uri, "--output",
        str(tmp_path / f"{uri.rsplit(':', 1)[1]}.tar")])
    assert out["port"][0] == 0
    assert out["port"][1].split(" to ")[0] == out["jax"][1].split(" to ")[0]


def test_backup_refuses_partial_without_flag(tmp_path, monkeypatch):
    """A fragment that cannot be fetched makes the archive partial: no
    file at --output unless --allow-partial is given."""
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path / "d"), "--device", "cpu"])
    try:
        _populate(srv.uri)

        def broken(*a, **kw):
            raise RuntimeError("disk gone")

        monkeypatch.setattr(srv.api, "fragment_data", broken)
        tar = str(tmp_path / "p.tar")
        with pytest.raises(SystemExit, match="partial"):
            main(["backup", "--host", srv.uri, "--output", tar])
        assert not os.path.exists(tar)
        assert not os.path.exists(tar + ".partial")
        assert main(["backup", "--host", srv.uri, "--output", tar,
                     "--allow-partial"]) == 0
        assert os.path.exists(tar)
    finally:
        srv.stop()


def test_inspect_and_check_cli(tmp_path):
    """inspect dumps fragment bit counts; check validates container
    invariants and fails on corruption, with the TPU package's output."""
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path / "ic"), "--device", "cpu"])
    try:
        c = Client(srv.uri)
        c.create_index("ic")
        c.create_field("ic", "f")
        c.import_bits("ic", "f", [1, 1, 2, 5], [5, 9, 7, 70000])
    finally:
        srv.stop()  # flushes fragment files
    frag_files = [p for p in glob.glob(
        str(tmp_path / "ic" / "ic" / "**" / "fragments" / "*"),
        recursive=True) if not p.endswith(".cache") and os.path.isfile(p)]
    assert frag_files
    rc, out = _both(["inspect", frag_files[0]])
    assert rc == 0 and "bits:" in out
    rc, out = _both(["check", *frag_files])
    assert rc == 0 and out.count(": ok") == len(frag_files)
    with open(frag_files[0], "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")
    rc, out = _both(["check", frag_files[0]])
    assert rc == 1 and "FAILED" in out


# -- node internals and fault points over HTTP -------------------------------


@pytest.fixture
def pair(tmp_path):
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        yield Pair(ref.address, port.uri)
    finally:
        port.stop()
        ref.close()


def test_internal_routes(pair):
    p = pair
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    p.both("POST", "/index/i/field/t",
           json.dumps({"options": {"type": "time", "timeQuantum": "YM"}}))
    p.both("POST", "/index/i/field/f/import", json.dumps({
        "rowIDs": [1, 1, 2, 7], "columnIDs": [3, SHARD_WIDTH + 5, 70000,
                                              3 * SHARD_WIDTH + 1]}))
    p.both("POST", "/index/i/field/t/import", json.dumps({
        "rowIDs": [1], "columnIDs": [3 * SHARD_WIDTH + 2],
        "timestamps": ["2024-03-05T10:00"]}))
    p.both("POST", "/index/e", "{}")
    assert p.both("GET", "/internal/shards/max")[1] == {
        "standard": {"i": 3, "e": 0}}
    assert p.both("GET", "/internal/nodes")[1] == [
        {"id": "local", "isCoordinator": True}]
    assert p.both("GET", "/internal/index/i/shards")[1] == {
        "shards": [0, 1, 3]}
    assert p.both("GET", "/internal/index/x/shards")[0] == 404
    frags = {shard: p.both(
        "GET", f"/internal/index/i/shard/{shard}/fragments")[1]["fragments"]
        for shard in (0, 1, 2, 3)}
    assert frags[2] == []
    assert {fr["view"] for fr in frags[3]} == {
        "standard", "standard_2024", "standard_202403"}
    assert p.both("GET", "/internal/index/x/shard/0/fragments")[0] == 404
    q = "index=i&field=f&view=standard&shard=0"
    _, blocks = p.both("GET", f"/internal/fragment/blocks?{q}")
    assert blocks["blocks"]
    for b in blocks["blocks"]:
        p.both("GET", f"/internal/fragment/block/data?{q}&block={b['id']}")
    for shard in (0, 1, 3):
        for fr in frags[shard]:
            st, body = p.both(
                "GET", f"/internal/fragment/data?index=i&field={fr['field']}"
                       f"&view={fr['view']}&shard={shard}")
            assert st == 200 and body
    assert p.both("GET", "/internal/fragment/data?index=i&field=f"
                         "&view=standard&shard=2")[0] == 404
    assert p.both("GET", "/internal/fragment/blocks?index=i&field=f"
                         "&view=standard&shard=0&bogus=1")[0] == 400
    assert p.both("GET", "/internal/fragment/data?index=i&field=nope"
                         "&view=standard&shard=0")[0] == 404


def test_debug_faultpoints_routes(pair):
    p = pair
    assert p.both("GET", "/debug/faultpoints")[0] == 200
    p.both("POST", "/debug/faultpoints",
           json.dumps({"arm": ["import.pre-ack=raise@3", "oplog.fsync=delay:0"]}))
    assert p.both("POST", "/debug/faultpoints",
                  json.dumps({"arm": "bogus"}))[0] == 400
    p.both("POST", "/debug/faultpoints", json.dumps({"disarm": "oplog.fsync"}))
    _, snap = p.both("POST", "/debug/faultpoints",
                     json.dumps({"disarm": "all"}))
    assert p.both("GET", "/debug/faultpoints")[1] == snap


# -- client resilience (tests/test_oplog.py's scripted server) --------------


class _ScriptedHandler(BaseHTTPRequestHandler):
    """Responds per the server-attached script: a list of
    (status, headers, body) consumed one per request."""

    def _serve(self):
        self.server.hits.append(self.path)
        if self.server.script:
            status, headers, body = self.server.script.pop(0)
        else:
            status, headers, body = 200, {}, b"{}"
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_DELETE = _serve

    def log_message(self, *args):
        pass


@pytest.fixture
def scripted_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _ScriptedHandler)
    srv.script = []
    srv.hits = []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


def _client(srv, **kw):
    kw.setdefault("backoff", 0.01)
    kw.setdefault("backoff_max", 0.05)
    return Client("http://127.0.0.1:%d" % srv.server_address[1], **kw)


def test_client_503_retried_with_retry_after(scripted_server):
    scripted_server.script = [
        (503, {"Retry-After": "0.01"}, b'{"error": "resizing"}'),
        (503, {"Retry-After": "0.01"}, b'{"error": "resizing"}'),
        (200, {}, b'{"ok": true}'),
    ]
    assert _client(scripted_server)._request("GET", "/status") == {
        "ok": True}
    assert len(scripted_server.hits) == 3


def test_client_503_retries_exhausted_raises(scripted_server):
    scripted_server.script = [(503, {}, b'{"error": "nope"}')] * 10
    with pytest.raises(ClientError) as ei:
        _client(scripted_server, retries=2)._request("GET", "/status")
    assert ei.value.status == 503
    assert len(scripted_server.hits) == 3  # 1 try + 2 retries


def test_client_non_idempotent_post_not_retried_on_network_error():
    c = Client("http://127.0.0.1:1", retries=3, backoff=0.01)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        c._request("POST", "/index/i/query", b"Set(1, f=1)")
    assert time.monotonic() - t0 < 1.0
    # ...but the idempotent import path IS retried
    hits = []
    orig = c._request_once

    def counting(*a, **kw):
        hits.append(1)
        return orig(*a, **kw)

    c._request_once = counting
    with pytest.raises(OSError):
        c.import_bits("i", "f", [1], [1])
    assert len(hits) == 4  # 1 try + 3 retries


def test_client_deadline_exceeded(scripted_server):
    scripted_server.script = [
        (503, {"Retry-After": "30"}, b'{"error": "busy"}')] * 10
    c = _client(scripted_server, retries=8, backoff=0.05, backoff_max=0.2)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded):
        c._request("GET", "/status", deadline=0.3)
    assert time.monotonic() - t0 < 2.0


def test_client_server_error_not_retried(scripted_server):
    scripted_server.script = [(500, {}, b'{"error": "boom"}')] * 3
    with pytest.raises(ClientError):
        _client(scripted_server)._request("GET", "/status")
    assert len(scripted_server.hits) == 1


def test_max_writes_per_request(tmp_path):
    """`--max-writes-per-request 1` refuses a query with two writes, as
    the TPU package's API(max_writes_per_request=1) does, in a query and
    in a query batch."""
    ref = ServerHarness(data_dir=str(tmp_path / "ref"),
                        max_writes_per_request=1)
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu",
                         "--max-writes-per-request", "1"])
    try:
        p = Pair(ref.address, port.uri)
        p.both("POST", "/index/i", "{}")
        p.both("POST", "/index/i/field/f", "{}")
        assert p.both("POST", "/index/i/query", "Set(1, f=1)")[0] == 200
        st, body = p.both("POST", "/index/i/query",
                          "Set(2, f=1) Set(3, f=1)")
        assert (st, body) == (400, {"error": "too many write commands"})
        assert p.both("POST", "/index/i/query",
                      "Count(Row(f=1)) Row(f=1)")[1]["results"][0] == 1
        p.both("POST", "/index/i/query-batch", json.dumps(
            {"queries": ["Count(Row(f=1))", "Set(4, f=1) Set(5, f=1)"]}))
    finally:
        port.stop()
        ref.close()


def test_backup_covers_whole_cluster(tmp_path):
    """`backup` from one node of a 2-node cluster includes the shards
    only its peer holds; restored into a single node of the other
    package, the count is whole. Both directions: the port's cluster to
    the TPU package's node, the TPU package's cluster to the port's."""
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    cols = [5, SHARD_WIDTH + 9, 2 * SHARD_WIDTH + 1, 3 * SHARD_WIDTH + 4]
    for name, harness, backup, restore in (
            ("port", ClusterHarness, main, jax_main),
            ("jax", JaxClusterHarness, jax_main, main)):
        tar_path = str(tmp_path / f"{name}.tar")
        c = harness(2)
        try:
            c[0].client.create_index("bk")
            c[0].client.create_field("bk", "f")
            c[0].client.import_bits("bk", "f", [1] * len(cols), cols)
            assert c[0].client.query(
                "bk", "Count(Row(f=1))")["results"] == [4]
            assert backup(["backup", "--host", c[0].address,
                           "--output", tar_path]) == 0
        finally:
            c.close()
        if restore is main:
            dst = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                                str(tmp_path / f"dst-{name}"),
                                "--device", "cpu"])
            uri, client, stop = dst.uri, Client(dst.uri), dst.stop
        else:
            dst = ServerHarness(data_dir=str(tmp_path / f"dst-{name}"))
            uri, client, stop = dst.address, dst.client, dst.close
        try:
            assert restore(["restore", "--host", uri,
                            "--input", tar_path]) == 0
            assert client.query("bk", "Count(Row(f=1))")["results"] == [4]
            assert sorted(client.query("bk", "Row(f=1)")["results"][0]
                          ["columns"]) == cols
        finally:
            stop()
