"""The port's hand-written protobuf codec against the protobuf runtime
and against the TPU package's serializer, on the CPU.

- Every message of pilosa.proto: the codec's bytes equal `pilosa_pb2`'s
  `SerializeToString()` for the same fields, and each side parses the
  other's bytes to equal fields — for a message with every field set,
  and under a hypothesis property over random messages (uint64 at
  2^64 - 1, negative int64, -0.0 and NaN doubles, empty and
  set-but-empty submessages, unicode strings, unpacked repeated input).
- The same queries run by both executors: the port's
  `encode_query_response` bytes equal `pilosa_tpu.encoding`'s for Row,
  Count, TopN pairs, GroupBy, ValCount, RowIdentifiers, bools, keyed
  results, column attribute sets and errors.
- `tests/test_encoding.py` ported: the codec's round trips, the wire
  field numbers, and the port server's protobuf query and import routes
  (query, import bits / values / timestamps, import-roaring).
- Each result type a cluster fan-out leg carries over the protobuf
  internal wire (TopN pairs with and without keys, a MinRow pair,
  GroupBy counts, ValCount, RowIdentifiers with and without keys, Rows
  with and without keys): bytes equal the TPU package's, and the port's
  decode through `cluster.executor.result_from_json` gives the leg's
  result back.

Only the tests that hold the codec against `pilosa_pb2` need
`google.protobuf` and skip without it. Tolerance: exact equality of
bytes, ints and strings.
"""

import math
import struct
import urllib.request

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pilosa_tpu_torch import encoding
from pilosa_tpu_torch.encoding import wire
from pilosa_tpu_torch.encoding.serializer import (
    decode_query_response_full, encode_query_response)
from pilosa_tpu_torch.exec.result import (
    FieldRow, GroupCount, Pair, RowIdentifiers, ValCount)

U64_MAX = (1 << 64) - 1


def _pb():
    pytest.importorskip("google.protobuf")
    from pilosa_tpu.encoding import pilosa_pb2

    return pilosa_pb2


# -- field values: one spec fills both a wire message and a pb2 message ------

def _apply(msg, cls, spec):
    """Write `spec` ({field name: value}) into `msg` (a wire or pb2
    message of wire class `cls`): repeated fields extend, submessages
    recurse (an empty spec sets an empty submessage)."""
    for f in cls.FIELDS:
        if f.name not in spec:
            continue
        v = spec[f.name]
        if f.kind == wire.MESSAGE and f.repeated:
            for sub in v:
                _apply(getattr(msg, f.name).add(), f.message, sub)
        elif f.kind == wire.MESSAGE:
            sub = getattr(msg, f.name)
            sub.SetInParent()
            _apply(sub, f.message, v)
        elif f.repeated:
            getattr(msg, f.name).extend(v)
        else:
            setattr(msg, f.name, v)
    return msg


def _fields(msg, cls):
    """Comparable {field: value} of a wire or pb2 message: doubles as
    their bytes (NaN, -0.0), unset submessages as None."""
    out = {}
    for f in cls.FIELDS:
        v = getattr(msg, f.name)
        if f.kind == wire.MESSAGE and f.repeated:
            out[f.name] = [_fields(m, f.message) for m in v]
        elif f.kind == wire.MESSAGE:
            out[f.name] = _fields(v, f.message) \
                if msg.HasField(f.name) else None
        elif f.repeated:
            out[f.name] = list(v)
        elif f.kind == wire.DOUBLE:
            out[f.name] = struct.pack("<d", v)
        else:
            out[f.name] = v
    return out


def _full_spec(cls, depth=0):
    """Every field set, edge values included."""
    vals = {wire.UINT64: U64_MAX, wire.INT64: -(1 << 63),
            wire.UINT32: (1 << 32) - 1, wire.BOOL: True,
            wire.STRING: "ключ-é-日本", wire.BYTES: b"\x00\xff\x80",
            wire.DOUBLE: -0.0}
    reps = {wire.UINT64: [0, 1, 127, 128, 300, U64_MAX],
            wire.INT64: [-1, 0, 1, -(1 << 63), (1 << 63) - 1],
            wire.STRING: ["", "a", "ü"], wire.BYTES: [b"", b"x"]}
    spec = {}
    for f in cls.FIELDS:
        if f.kind == wire.MESSAGE:
            sub = _full_spec(f.message, depth + 1) if depth < 2 else {}
            spec[f.name] = [sub, {}] if f.repeated else sub
        elif f.repeated:
            spec[f.name] = reps[f.kind]
        else:
            spec[f.name] = vals[f.kind]
    return spec


MESSAGE_NAMES = sorted(wire.MESSAGES)


@pytest.mark.parametrize("name", MESSAGE_NAMES)
def test_every_message_equals_pb2_both_ways(name):
    pb = _pb()
    cls = wire.MESSAGES[name]
    for spec in (_full_spec(cls), {}):
        ours = _apply(cls(), cls, spec)
        theirs = _apply(getattr(pb, name)(), cls, spec)
        assert ours.SerializeToString() == theirs.SerializeToString(), name
        got = cls.FromString(theirs.SerializeToString())
        want = getattr(pb, name).FromString(ours.SerializeToString())
        assert _fields(got, cls) == _fields(theirs, cls)
        assert _fields(want, cls) == _fields(ours, cls)


def _values(kind):
    return {
        wire.UINT64: st.one_of(st.integers(0, U64_MAX),
                               st.sampled_from([0, 127, 128, U64_MAX])),
        wire.INT64: st.one_of(st.integers(-(1 << 63), (1 << 63) - 1),
                              st.sampled_from([-1, 0, -(1 << 63)])),
        wire.UINT32: st.integers(0, (1 << 32) - 1),
        wire.BOOL: st.booleans(),
        wire.STRING: st.text(max_size=8),
        wire.BYTES: st.binary(max_size=8),
        wire.DOUBLE: st.one_of(st.floats(allow_nan=True),
                               st.sampled_from([0.0, -0.0])),
    }[kind]


@st.composite
def _spec(draw, cls, depth=0):
    spec = {}
    for f in cls.FIELDS:
        if not draw(st.booleans()):
            continue
        if f.kind == wire.MESSAGE:
            sub = (_spec(f.message, depth + 1) if depth < 2
                   else st.just({}))
            spec[f.name] = draw(st.lists(sub, max_size=3)) if f.repeated \
                else draw(sub)
        elif f.repeated:
            spec[f.name] = draw(st.lists(_values(f.kind), max_size=6))
        else:
            spec[f.name] = draw(_values(f.kind))
    return spec


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), name=st.sampled_from(MESSAGE_NAMES))
def test_random_messages_equal_pb2(data, name):
    pb = _pb()
    cls = wire.MESSAGES[name]
    spec = data.draw(_spec(cls))
    ours = _apply(cls(), cls, spec)
    theirs = _apply(getattr(pb, name)(), cls, spec)
    blob = theirs.SerializeToString()
    assert ours.SerializeToString() == blob
    assert _fields(cls.FromString(blob), cls) == _fields(theirs, cls)
    assert _fields(getattr(pb, name).FromString(ours.SerializeToString()),
                   cls) == _fields(ours, cls)


def _varint(v):
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(-(1 << 63), (1 << 63) - 1), max_size=12),
       st.lists(st.integers(0, U64_MAX), max_size=12),
       st.integers(0, 3))
def test_unpacked_and_packed_repeated_input(values, columns, split):
    """Repeated integers sent unpacked (one varint field each), packed,
    or both in runs parse to the same values on both sides; unknown
    fields in between are skipped."""
    pb = _pb()
    blob = bytearray()
    packed = wire.encode_varints(np.array(columns[:split], np.uint64))
    blob += b"\x2a" + _varint(len(packed)) + packed  # ColumnIDs packed
    for c in columns[split:]:
        blob += b"\x28" + _varint(c)  # ColumnIDs (5) unpacked
    for v in values:
        blob += b"\x30" + _varint(v & U64_MAX)  # Values (6) unpacked
    blob += b"\xf8\x07\x05" + b"\x82\x08\x02hi"  # unknown fields 127, 128
    ours = wire.ImportValueRequest.FromString(bytes(blob))
    theirs = pb.ImportValueRequest.FromString(bytes(blob))
    assert list(ours.ColumnIDs) == list(theirs.ColumnIDs) == columns
    assert list(ours.Values) == list(theirs.Values) == values


def test_set_but_empty_submessages():
    """A submessage written to — even by an empty extend — is set and
    serialized; one only read is not."""
    r = wire.QueryResult()
    _ = r.Row
    assert r.SerializeToString() == b"" and not r.HasField("Row")
    r.Row.Columns.extend([])
    r.ValCount.Val = 0
    r.RowIdentifiers.Keys.extend([])
    assert r.SerializeToString() == b"\x0a\x00\x2a\x00\x4a\x00"
    assert wire.QueryResult.FromString(b"\x0a\x00").HasField("Row")
    assert not wire.QueryResult.FromString(b"").HasField("Row")


def test_numeric_edges_bytes():
    assert wire.ValCount(Val=-1).SerializeToString() \
        == b"\x08" + b"\xff" * 9 + b"\x01"
    assert wire.Attr(FloatValue=-0.0).SerializeToString() \
        == b"\x31" + struct.pack("<d", -0.0)
    assert wire.Attr(FloatValue=0.0).SerializeToString() == b""
    nan = wire.Attr.FromString(wire.Attr(
        FloatValue=math.nan).SerializeToString()).FloatValue
    assert math.isnan(nan)
    with pytest.raises(ValueError):
        wire.QueryRequest(Shards=[-1])
    with pytest.raises(ValueError):
        wire.QueryRequest(Shards=[U64_MAX + 1])
    with pytest.raises(ValueError):
        wire.QueryResult(Type=1 << 32)


@pytest.mark.parametrize("blob", [
    b"\x0a\x05ab",                 # length past the end
    b"\x10" + b"\x80" * 11,        # varint over 10 bytes
    b"\x1a\x02\xff\xfe",           # Keys (3): not UTF-8
    b"\x0f",                       # wire type 7
    b"\x12\x02\x80\x80",           # packed varint truncated
])
def test_decode_errors_match_runtime(blob):
    pb = _pb()
    from google.protobuf.message import DecodeError

    with pytest.raises(wire.DecodeError):
        wire.Row.FromString(blob)
    with pytest.raises(DecodeError):
        pb.Row.FromString(blob)


def test_million_packed_values_equal_pb2():
    """A Row of 1,000,000 columns over the 954-shard range and an import
    of 1,000,000 values: the vectorised encoder's bytes equal the
    runtime's, and the decoder gives the arrays back."""
    pb = _pb()
    rng = np.random.default_rng(7)
    cols = np.sort(rng.integers(0, 954 << 20, 1_000_000, dtype=np.uint64))
    ours = wire.Row()
    ours.Columns.extend(cols)
    theirs = pb.Row()
    theirs.Columns.extend(cols.tolist())
    blob = ours.SerializeToString()
    assert blob == theirs.SerializeToString()
    assert np.array_equal(wire.Row.FromString(blob).Columns.array, cols)
    vals = rng.integers(-(1 << 40), 1 << 40, 1_000_000, dtype=np.int64)
    ours = wire.ImportValueRequest()
    ours.Values.extend(vals)
    theirs = pb.ImportValueRequest(Values=vals.tolist())
    assert ours.SerializeToString() == theirs.SerializeToString()
    assert np.array_equal(
        wire.ImportValueRequest.FromString(
            theirs.SerializeToString()).Values.array, vals)


# -- tests/test_encoding.py, ported -------------------------------------------

def test_query_request_roundtrip():
    blob = encoding.encode_query_request(
        "Count(Row(f=1))", shards=[0, 5], remote=True)
    q = encoding.decode_query_request(blob)
    assert q == {"query": "Count(Row(f=1))", "shards": [0, 5],
                 "remote": True, "column_attrs": False,
                 "exclude_row_attrs": False, "exclude_columns": False}


def test_result_types_roundtrip():
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.ops import bitplane

    row = Row()
    row.segments[0] = bitplane.plane_from_columns([3, 9, 100])
    results = [
        None,
        row,
        True,
        42,
        ValCount(7, 3),
        Pair(5, 9, key="k"),
        [Pair(1, 10), Pair(2, 5)],
        RowIdentifiers([1, 2, 3]),
        [GroupCount([FieldRow("f", 1), FieldRow("g", 2, row_key="x")], 11)],
    ]
    blob = encoding.encode_query_response(results)
    decoded, err = encoding.decode_query_response(blob)
    assert err is None
    assert decoded[0] is None
    assert decoded[1] == {"columns": [3, 9, 100]}
    assert decoded[2] is True
    assert decoded[3] == 42
    assert decoded[4] == ValCount(7, 3)
    assert decoded[5] == Pair(5, 9, key="k")
    assert decoded[6] == [Pair(1, 10), Pair(2, 5)]
    assert decoded[7] == RowIdentifiers([1, 2, 3])
    assert decoded[8] == [
        GroupCount([FieldRow("f", 1), FieldRow("g", 2, row_key="x")], 11)]


def test_error_response():
    blob = encoding.encode_query_response([], err="field not found: q")
    results, err = encoding.decode_query_response(blob)
    assert results == [] and err == "field not found: q"


def test_wire_field_numbers_match_reference():
    """QueryRequest.Query=1 (tag 0x0a), Shards=2 packed (0x12), Remote=5
    (0x28)."""
    blob = encoding.encode_query_request("x", shards=[1], remote=True)
    assert blob == bytes([0x0A, 0x01, ord("x"), 0x12, 0x01, 0x01,
                          0x28, 0x01])


@pytest.fixture
def port_server(tmp_path):
    from pilosa_tpu_torch.cli import start_server
    from pilosa_tpu_torch.server import Client

    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path / "port"), "--device", "cpu"])
    try:
        yield srv, Client(srv.uri)
    finally:
        srv.stop()


def test_proto_data_plane_live(port_server):
    srv, c = port_server
    c.create_index("pi")
    c.create_field("pi", "f")
    c.query("pi", "Set(1, f=10) Set(2, f=10)")
    results, err = c.query_proto(
        "pi", "Count(Row(f=10)) Row(f=10) TopN(f, n=2)")
    assert err is None
    assert results[0] == 2
    assert results[1] == {"columns": [1, 2]}
    assert results[2] == [Pair(10, 2)]
    # errors come back in-band, as the reference encodes them
    results, err = c.query_proto("pi", "Count(Row(nope=1))")
    assert err and "nope" in err


def test_column_attr_sets_roundtrip_and_live(port_server):
    blob = encode_query_response(
        [7], column_attr_sets=[
            {"id": 3, "attrs": {"name": "x", "n": 5, "ok": True,
                                "w": 1.5}}])
    results, err, attr_sets = decode_query_response_full(blob)
    assert results == [7] and err is None
    assert attr_sets == [
        {"id": 3, "attrs": {"name": "x", "n": 5, "ok": True, "w": 1.5}}]

    srv, c = port_server
    c.create_index("ca")
    c.create_field("ca", "f")
    c.query("ca", "Set(1, f=10) Set(2, f=10)")
    c.query("ca", 'SetColumnAttrs(1, city="nyc")')
    out = c._request("POST", "/index/ca/query?columnAttrs=true",
                     b"Row(f=10)", content_type="text/plain")
    assert out["columnAttrs"] == [{"id": 1, "attrs": {"city": "nyc"}}]
    out = c.query("ca", "Row(f=10)")
    assert "columnAttrs" not in out
    # and on the protobuf wire: QueryRequest.ColumnAttrs
    data = c._request(
        "POST", "/index/ca/query",
        wire.QueryRequest(Query="Row(f=10)", ColumnAttrs=True)
        .SerializeToString(), content_type=encoding.CONTENT_TYPE_PROTOBUF)
    results, err, attr_sets = decode_query_response_full(data)
    assert err is None and results == [{"columns": [1, 2]}]
    assert attr_sets == [{"id": 1, "attrs": {"city": "nyc"}}]


def _post_proto(uri, path, payload):
    req = urllib.request.Request(uri + path, data=payload, method="POST")
    req.add_header("Content-Type", "application/x-protobuf")
    req.add_header("Accept", "application/x-protobuf")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return wire.ImportResponse.FromString(resp.read())


def test_protobuf_import_wire(port_server):
    """A stock client's protobuf import: ImportRequest/ImportValueRequest
    by field type, nanosecond timestamps, ImportResponse back."""
    srv, c = port_server
    c.create_index("pbi")
    c.create_field("pbi", "f", {"type": "set"})
    c.create_field("pbi", "t", {"type": "time", "timeQuantum": "YMD"})
    c.create_field("pbi", "v", {"type": "int", "min": -10, "max": 1000})

    def post(field, msg):
        return _post_proto(srv.uri, f"/index/pbi/field/{field}/import",
                           msg.SerializeToString())

    msg = wire.ImportRequest(
        Index="pbi", Field="f", RowIDs=[1, 1, 2], ColumnIDs=[5, 9, 5])
    assert post("f", msg).Err == ""
    assert c.query("pbi", "Row(f=1)")["results"][0]["columns"] == [5, 9]
    ns = 1_546_300_800_000_000_000  # 2019-01-01T00:00:00Z
    msg = wire.ImportRequest(
        Index="pbi", Field="t", RowIDs=[3], ColumnIDs=[7], Timestamps=[ns])
    assert post("t", msg).Err == ""
    got = c.query("pbi",
                  "Row(t=3, from=2018-12-01T00:00, to=2019-02-01T00:00)")
    assert got["results"][0]["columns"] == [7]
    msg = wire.ImportValueRequest(
        Index="pbi", Field="v", ColumnIDs=[5, 9], Values=[-7, 400])
    assert post("v", msg).Err == ""
    assert c.query("pbi", "Sum(field=v)")["results"][0] \
        == {"value": 393, "count": 2}
    # the Client's helpers send the same messages
    assert c.import_bits_proto("pbi", "f", [2], [11]) == ""
    assert c.import_values_proto("pbi", "v", [11], [-3]) == ""
    assert c.query("pbi", "Row(f=2)")["results"][0]["columns"] == [5, 11]
    assert c.query("pbi", "Sum(field=v)")["results"][0] \
        == {"value": 390, "count": 3}
    # a body that is not an ImportRequest is a 400, not a 500
    req = urllib.request.Request(
        srv.uri + "/index/pbi/field/f/import", data=b"\x0a\x09ab",
        method="POST")
    req.add_header("Content-Type", "application/x-protobuf")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def test_protobuf_import_roaring_wire(port_server):
    """Stock-client roaring ingest: an ImportRoaringRequest with one blob
    per view (an empty view name is the standard view)."""
    from pilosa_tpu_torch.roaring import Bitmap, serialize

    srv, c = port_server
    c.create_index("pbr")
    c.create_field("pbr", "f", {"type": "set"})
    b = Bitmap()
    b.add_many([1, 5, 70000])  # row 0 of the shard (cols 1, 5, 70000)
    msg = wire.ImportRoaringRequest()
    v = msg.views.add()
    v.Name = ""
    v.Data = serialize(b)
    out = _post_proto(srv.uri, "/index/pbr/field/f/import-roaring/0",
                      msg.SerializeToString())
    assert out.Err == ""
    assert c.query("pbr", "Row(f=0)")["results"][0]["columns"] \
        == [1, 5, 70000]
    b2 = Bitmap()
    b2.add_many([(1 << 20) + 4])  # row 1, column 4
    assert c.import_roaring_proto("pbr", "f", 0,
                                  {"standard": serialize(b2)}) == ""
    assert c.query("pbr", "Row(f=1)")["results"][0]["columns"] == [4]


# -- query responses of both executors ----------------------------------------

N_SHARDS = 3


def _seed(api, index, keyed):
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(11)
    cols = [int(s * SHARD_WIDTH + c) for s in range(N_SHARDS)
            for c in rng.choice(SHARD_WIDTH, 30, replace=False)]
    pql = []
    for i, col in enumerate(cols):
        if keyed:
            pql.append(f'Set("c{col}", k="r{i % 4}")')
        else:
            pql.append(f"Set({col}, f={i % 5}) Set({col}, g={i % 3})")
            pql.append(f"Set({col}, v={i * 7 - 90})")
    for q in pql:
        api.query(index, q)
    if not keyed:
        api.query(index, f'SetColumnAttrs({cols[0]}, city="nyc", n=3)')
        api.query(index, f"SetColumnAttrs({cols[1]}, ok=true, w=1.5)")


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    pytest.importorskip("jax")
    from pilosa_tpu.core import FieldOptions as JFieldOptions
    from pilosa_tpu.core import Holder as JHolder
    from pilosa_tpu.core.index import IndexOptions as JIndexOptions
    from pilosa_tpu.server.api import API as JAPI
    from pilosa_tpu_torch.core import FieldOptions, Holder
    from pilosa_tpu_torch.core.index import IndexOptions
    from pilosa_tpu_torch.server.api import API

    root = tmp_path_factory.mktemp("enc")
    jh = JHolder(str(root / "ref"), use_snapshot_queue=False).open()
    th = Holder(str(root / "port")).open()
    out = (JAPI(jh), API(th, device="cpu"))
    for api, FO, IO in ((out[0], JFieldOptions, JIndexOptions),
                        (out[1], FieldOptions, IndexOptions)):
        api.create_index("e")
        api.create_field("e", "f")
        api.create_field("e", "g")
        api.create_field("e", "v", FO(type="int", min=-100, max=1000))
        api.create_index("kx", IO(keys=True))
        api.create_field("kx", "k", FO(keys=True))
        _seed(api, "e", keyed=False)
        _seed(api, "kx", keyed=True)
    yield out
    out[1].close()
    jh.close()
    th.close()


RESPONSE_QUERIES = [
    ("e", "Row(f=1)"), ("e", "Count(Intersect(Row(f=1), Row(g=2)))"),
    ("e", "TopN(f, n=3)"), ("e", "GroupBy(Rows(f), Rows(g))"),
    ("e", "Sum(field=v)"), ("e", "Min(field=v)"), ("e", "Max(field=v)"),
    ("e", "Rows(f)"), ("e", "Set(3, f=9)"), ("e", "Clear(3, f=9)"),
    ("e", "Row(f=2) Count(Row(g=1)) TopN(g, Row(f=0), n=2)"),
    ("e", "Union(Row(f=0), Row(f=1))"),
    ("kx", 'Row(k="r1")'), ("kx", "TopN(k, n=2)"), ("kx", "Rows(k)"),
    ("kx", "GroupBy(Rows(k))"),
]


@pytest.mark.parametrize("index,pql", RESPONSE_QUERIES)
def test_query_response_bytes_equal_reference(apis, index, pql):
    from pilosa_tpu import encoding as jencoding

    ref, port = apis
    want = jencoding.encode_query_response(ref.query(index, pql))
    got = encoding.encode_query_response(port.query(index, pql))
    assert got == want


def test_column_attrs_and_error_bytes_equal_reference(apis):
    from pilosa_tpu import encoding as jencoding
    from pilosa_tpu.server.api import ApiError as JApiError
    from pilosa_tpu_torch.server.api import ApiError

    ref, port = apis
    jres, tres = (api.query("e", "Row(f=0)") for api in apis)
    want = jencoding.encode_query_response(
        jres, column_attr_sets=ref.column_attr_sets("e", jres))
    got = encoding.encode_query_response(
        tres, column_attr_sets=port.column_attr_sets("e", tres))
    assert got == want
    errs = []
    for api, exc in ((ref, JApiError), (port, ApiError)):
        with pytest.raises(exc) as e:
            api.query("e", "Count(Row(nope=1))")
        errs.append(str(e.value))
    assert encoding.encode_query_response([], err=errs[1]) \
        == jencoding.encode_query_response([], err=errs[0])


def test_proto_query_route_equals_reference(tmp_path):
    """The same protobuf QueryRequest to both servers: equal status,
    content type and bytes, for results and for an in-band error."""
    pytest.importorskip("jax")
    from pilosa_tpu_torch.cli import start_server
    from tests.harness import ServerHarness

    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        outs = []
        for uri in (ref.address, port.uri):
            for path, body in (("/index/p", b"{}"),
                               ("/index/p/field/f", b"{}"),
                               ("/index/p/query", b"Set(1, f=3) Set(9, f=3)")):
                urllib.request.urlopen(urllib.request.Request(
                    uri + path, data=body, method="POST"), timeout=10)
            got = []
            for q in ("Row(f=3) Count(Row(f=3)) TopN(f)", "Row(nope=1)"):
                req = urllib.request.Request(
                    uri + "/index/p/query", method="POST",
                    data=encoding.encode_query_request(q))
                req.add_header("Content-Type", "application/x-protobuf")
                with urllib.request.urlopen(req, timeout=10) as resp:
                    got.append((resp.status,
                                resp.headers.get("Content-Type"),
                                resp.read()))
            outs.append(got)
        assert outs[0] == outs[1]
    finally:
        port.stop()
        ref.close()


def _leg_results(res, row_cls):
    """One fan-out leg's result of each kind a remote leg decodes, built
    from package `res` (exec.result) and `row_cls` (core.row.Row)."""
    keyed = row_cls.from_columns([4, 1 << 20, 3 << 20])
    keyed.keys = ["a", "b", "c"]
    return {
        "pairs": [res.Pair(7, 12), res.Pair(3, 12), res.Pair(9, 1)],
        "pairs_keyed": [res.Pair(1, 5, key="x"), res.Pair(2, 4, key="y")],
        "min_row": res.Pair(4, 2),
        "group_counts": [
            res.GroupCount([res.FieldRow("f", 1), res.FieldRow("g", 7)], 3),
            res.GroupCount([res.FieldRow("f", 2),
                            res.FieldRow("g", 0, row_key="k")], 1)],
        "val_count": res.ValCount(-17, 5),
        "row_identifiers": res.RowIdentifiers([1, 5, 9]),
        "row_identifiers_keyed": res.RowIdentifiers([], keys=["p", "q"]),
        "row": row_cls.from_columns([0, 2, (5 << 20) + 1]),
        "row_keyed": keyed,
    }


@pytest.mark.parametrize("kind", [
    "pairs", "pairs_keyed", "min_row", "group_counts", "val_count",
    "row_identifiers", "row_identifiers_keyed", "row", "row_keyed"])
def test_fanout_leg_result_roundtrip(kind):
    """Each result type a cluster fan-out leg carries over the protobuf
    internal wire: the port's QueryResponse bytes equal the TPU
    package's (whose codec is `pilosa_pb2`), and the port's decode,
    through the cluster executor's `result_from_json`, gives back the
    result the leg sent."""
    _pb()
    import pilosa_tpu.core.row as jax_row
    import pilosa_tpu.encoding as jencoding
    import pilosa_tpu.exec.result as jax_result
    from pilosa_tpu_torch.cluster.executor import result_from_json
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.exec import result as port_result

    mine = _leg_results(port_result, Row)[kind]
    ref = _leg_results(jax_result, jax_row.Row)[kind]
    blob = encoding.encode_query_response([mine])
    assert blob == jencoding.encode_query_response([ref])
    decoded, err = encoding.decode_query_response(blob)
    assert err is None and len(decoded) == 1
    got = decoded[0]
    if isinstance(got, dict):  # proto Rows decode to their wire dict
        got = result_from_json(got)
    if isinstance(mine, Row):
        assert [int(c) for c in got.columns()] == \
            [int(c) for c in mine.columns()]
        assert got.keys == mine.keys
    else:
        assert got == mine
    # and the TPU package's decoder reads the same answer
    jdecoded, jerr = jencoding.decode_query_response(blob)
    assert jerr is None
    if isinstance(mine, Row):
        assert jdecoded[0].get("columns", []) == \
            [int(c) for c in mine.columns()]
    else:
        assert repr(jdecoded[0]) == repr(ref)
