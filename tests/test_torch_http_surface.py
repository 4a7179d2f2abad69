"""The port's public HTTP routes against the TPU package's server.

Both servers run in this process on ephemeral ports, each over its own
empty data directory: the TPU package's (JAX on the CPU) and the port's
(`--device cpu`). Every request goes to both, and the status and body of
the answers must be equal: DDL (GET /index, DELETE index and field, POST
/schema), imports (bits with row and column keys, roaring), GET /export,
columnAttrs, /info, /version, /healthz and /recalculate-caches. A body
sent as application/x-protobuf is answered 415 by the port alone (the
TPU package decodes protobuf; the port does not).
"""

import json
import urllib.error
import urllib.request

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.roaring import Bitmap, serialize  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402

from tests.harness import ServerHarness  # noqa: E402


def _request(uri, method, path, body=None, content_type=None):
    data = body if isinstance(body, (bytes, type(None))) else body.encode()
    req = urllib.request.Request(uri + path, data=data, method=method)
    if content_type:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


class Pair:
    """The two servers; `both` sends one request to each."""

    def __init__(self, ref_uri, port_uri):
        self.ref_uri = ref_uri
        self.port_uri = port_uri

    def both(self, method, path, body=None, content_type=None):
        """(status, decoded body) of the port, after checking that the
        TPU package's server answered the same."""
        want = _request(self.ref_uri, method, path, body, content_type)
        got = _request(self.port_uri, method, path, body, content_type)
        assert got[0] == want[0], (path, got, want)
        assert got[1] == want[1], (path, got, want)
        if got[1] == "application/json":
            g, w = json.loads(got[2]), json.loads(want[2])
        else:
            g, w = got[2], want[2]
        assert g == w, (path, g, w)
        return got[0], g

    def port(self, method, path, body=None, content_type=None):
        return _request(self.port_uri, method, path, body, content_type)


@pytest.fixture
def servers(tmp_path):
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        yield Pair(ref.address, port.uri)
    finally:
        port.stop()
        ref.close()


def _import(pair, index, field, rows, cols, **kw):
    body = {"rowIDs": rows, "columnIDs": cols}
    body.update(kw)
    return pair.both("POST", f"/index/{index}/field/{field}/import",
                     json.dumps(body))


def test_schema_roundtrip_and_post_schema(servers):
    p = servers
    p.both("POST", "/index/i", json.dumps({"options": {"keys": False}}))
    p.both("POST", "/index/i/field/f",
           json.dumps({"options": {"type": "set", "cacheType": "ranked"}}))
    p.both("POST", "/index/i/field/n",
           json.dumps({"options": {"type": "int", "min": -10, "max": 100}}))
    p.both("POST", "/index/i/field/t",
           json.dumps({"options": {"type": "time", "timeQuantum": "YM"}}))
    assert p.both("POST", "/index/i", "{}")[0] == 409
    assert p.both("POST", "/index/i/field/f", "{}")[0] == 409
    _, schema = p.both("GET", "/schema")
    assert [f["name"] for f in schema["indexes"][0]["fields"]] \
        == ["f", "n", "t"]
    assert p.both("GET", "/index") == (200, schema)
    p.both("GET", "/index/i")
    status, body = p.both("POST", "/schema", json.dumps({"indexes": [
        {"name": "x", "options": {"keys": True},
         "fields": [{"name": "f", "options": {"type": "time",
                                              "timeQuantum": "YMD"}},
                    {"name": "m", "options": {"type": "mutex"}}]},
        {"name": "i", "fields": [{"name": "f"}, {"name": "g"}]}]}))
    assert (status, body) == (200, None)
    _, schema = p.both("GET", "/schema")
    assert [x["name"] for x in schema["indexes"]] == ["i", "x"]
    assert [f["name"] for f in schema["indexes"][0]["fields"]] \
        == ["f", "g", "n", "t"]


def test_delete_then_recreate_reads_only_new_bits(servers):
    """A Count caches the field's device stacks; after DELETE and a
    re-create with other bits, the Count reads only the new bits."""
    p = servers
    p.both("POST", "/index/d", "{}")
    p.both("POST", "/index/d/field/h", "{}")
    old = [3, SHARD_WIDTH + 4, 2 * SHARD_WIDTH + 5, 3 * SHARD_WIDTH + 6]
    _import(p, "d", "h", [1] * 4, old)
    pql = "Count(Row(h=1)) Row(h=1)"
    assert p.both("POST", "/index/d/query", pql)[1]["results"][0] == 4
    assert p.both("DELETE", "/index/d/field/h") == (200, {"success": True})
    assert p.both("POST", "/index/d/query", pql)[0] == 400
    assert p.both("DELETE", "/index/d/field/h")[0] == 404
    p.both("POST", "/index/d/field/h", "{}")
    new = [7, 2 * SHARD_WIDTH + 9, 3 * SHARD_WIDTH + 11]
    _import(p, "d", "h", [1] * 3, new)
    _, out = p.both("POST", "/index/d/query", pql)
    assert out["results"] == [3, {"attrs": {}, "columns": new}]
    # the whole index, the same way
    assert p.both("DELETE", "/index/d") == (200, {"success": True})
    assert p.both("DELETE", "/index/d")[0] == 404
    assert p.both("POST", "/index/d/query", pql)[0] == 404
    p.both("POST", "/index/d", "{}")
    p.both("POST", "/index/d/field/h", "{}")
    _import(p, "d", "h", [1, 1], [SHARD_WIDTH + 1, 3 * SHARD_WIDTH + 2])
    _, out = p.both("POST", "/index/d/query", pql)
    assert out["results"] == [2, {"attrs": {},
                                  "columns": [SHARD_WIDTH + 1,
                                              3 * SHARD_WIDTH + 2]}]


def test_import_roaring(servers):
    p = servers
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    blob = serialize(Bitmap.from_bits(
        [7 * SHARD_WIDTH + 5, 7 * SHARD_WIDTH + 6, 2 * SHARD_WIDTH + 9]))
    assert p.both("POST", "/index/i/field/f/import-roaring/1", blob) \
        == (200, {"changed": 3})
    p.both("POST", "/index/i/query", "Row(f=7) Row(f=2) Count(Row(f=7))")
    clear = serialize(Bitmap.from_bits([7 * SHARD_WIDTH + 5]))
    assert p.both("POST", "/index/i/field/f/import-roaring/1?clear=true",
                  clear) == (200, {"changed": 1})
    assert p.both("POST", "/index/i/query", "Row(f=7)")[1]["results"] \
        == [{"attrs": {}, "columns": [SHARD_WIDTH + 6]}]
    p.both("POST", "/index/i/field/t",
           json.dumps({"options": {"type": "time", "timeQuantum": "Y"}}))
    p.both("POST", "/index/i/field/t/import-roaring/0?view=standard_2019",
           serialize(Bitmap.from_bits([3 * SHARD_WIDTH + 8])))
    p.both("POST", "/index/i/query",
           "Row(t=3, from=2019-01-01T00:00, to=2020-01-01T00:00)")
    assert p.both("POST", "/index/i/field/f/import-roaring/1?bogus=1",
                  blob)[0] == 400
    assert p.both("POST", "/index/i/field/nope/import-roaring/1",
                  blob)[0] == 404


def test_export_csv(servers):
    p = servers
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    _import(p, "i", "f", [1, 2, 1], [10, 20, SHARD_WIDTH + 3])
    status, text = p.both("GET", "/export?index=i&field=f&shard=0")
    assert status == 200
    assert sorted(text.decode().strip().splitlines()) == ["1,10", "2,20"]
    p.both("GET", "/export?index=i&field=f&shard=1")
    p.both("GET", "/export?index=i&field=f&shard=5")
    assert p.both("GET", "/export?index=i")[0] == 400
    assert p.both("GET", "/export?index=i&field=nope&shard=0")[0] == 404


def test_keyed_import_results_and_export(servers):
    p = servers
    p.both("POST", "/index/xk", json.dumps({"options": {"keys": True}}))
    p.both("POST", "/index/xk/field/f", json.dumps({"options":
                                                    {"keys": True}}))
    _import(p, "xk", "f", [], [], rowKeys=["red", "blue", "red"],
            columnKeys=["c1", "c2", "c3"])
    for pql in ('Row(f="red")', 'Count(Row(f="red"))', "TopN(f)",
                'MinRow(field=f)', 'MaxRow(field=f)', "Rows(f)",
                'Options(Row(f="blue"), excludeColumns=true)'):
        p.both("POST", "/index/xk/query", pql)
    _, text = p.both("GET", "/export?index=xk&field=f&shard=0")
    assert sorted(text.decode().strip().splitlines()) \
        == ["blue,c2", "red,c1", "red,c3"]
    # keys on an index or field without them are refused, by both
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    assert _import(p, "i", "f", [1], [], columnKeys=["c1"])[0] == 400
    assert _import(p, "i", "f", [], [1], rowKeys=["r"])[0] == 400
    p.both("POST", "/index/xk/field/n", json.dumps({"options": {
        "type": "int", "min": 0, "max": 1000}}))
    p.both("POST", "/index/xk/field/n/import",
           json.dumps({"columnKeys": ["c1", "c9"], "values": [5, 700]}))
    p.both("POST", "/index/xk/query", "Row(n > 6) Sum(field=n)")


def test_column_attrs(servers):
    p = servers
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    _import(p, "i", "f", [1, 1, 2], [3, SHARD_WIDTH + 4, 9])
    p.both("POST", "/index/i/query",
           'SetColumnAttrs(3, name="x", n=2) '
           f'SetColumnAttrs({SHARD_WIDTH + 4}, name="y") '
           'SetColumnAttrs(9, name="z") SetRowAttrs(f, 1, color="red")')
    _, out = p.both("POST", "/index/i/query?columnAttrs=true",
                    "Row(f=1) Count(Row(f=2))")
    assert out["columnAttrs"] == [
        {"id": 3, "attrs": {"n": 2, "name": "x"}},
        {"id": SHARD_WIDTH + 4, "attrs": {"name": "y"}}]
    assert out["results"][0]["attrs"] == {"color": "red"}
    p.both("POST", "/index/i/query?columnAttrs=true&excludeRowAttrs=true",
           "Union(Row(f=1), Row(f=2))")
    p.both("POST", "/index/i/query?columnAttrs=false", "Row(f=2)")


def test_info_version_healthz_recalculate(servers):
    p = servers
    _, info = p.both("GET", "/info")
    assert info["shardWidth"] == SHARD_WIDTH
    p.both("GET", "/version")
    assert p.both("GET", "/healthz") == (200, {"status": "ok"})
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    _import(p, "i", "f", [1, 1, 2], [3, 4, 5])
    assert p.both("POST", "/recalculate-caches") == (200, None)
    p.both("POST", "/index/i/query", "TopN(f)")


def test_unknown_routes_and_methods(servers):
    p = servers
    assert p.both("GET", "/nope")[0] == 404
    assert p.both("DELETE", "/schema")[0] == 404
    assert p.both("DELETE", "/index/none")[0] == 404
    assert p.both("DELETE", "/index/none/field/f")[0] == 404


@pytest.mark.parametrize("path", [
    "/index/i/query", "/index/i/field/f/import",
    "/index/i/field/f/import-roaring/0"])
def test_protobuf_body_gets_415(servers, path):
    p = servers
    p.both("POST", "/index/i", "{}")
    p.both("POST", "/index/i/field/f", "{}")
    status, ctype, body = p.port("POST", path, b"\x0a\x03abc",
                                 "application/x-protobuf")
    assert (status, ctype) == (415, "application/json")
    assert "application/x-protobuf" in json.loads(body)["error"]
    # nothing was written
    assert p.both("POST", "/index/i/query", "Count(Row(f=0))")[1] \
        == {"results": [0]}
