"""Protobuf serializer for the query data plane.

Wire-compatible with the reference (encoding/proto/proto.go:29-45
Serializer; QueryResult type tags :1055-1067), so a stock Pilosa client
POSTing `Content-Type: application/x-protobuf` QueryRequests receives
byte-compatible QueryResponses. The messages are `wire.py`'s hand-written
codec of `pilosa.proto` (no protobuf runtime); a Row's columns go to and
from the wire as one numpy array.
"""

from . import wire as pb

CONTENT_TYPE_PROTOBUF = "application/x-protobuf"

# QueryResult.Type tags (reference: encoding/proto/proto.go:1055-1067)
TYPE_NIL = 0
TYPE_ROW = 1
TYPE_PAIRS = 2
TYPE_VALCOUNT = 3
TYPE_UINT64 = 4
TYPE_BOOL = 5
TYPE_ROWIDS = 6
TYPE_GROUPCOUNTS = 7
TYPE_ROWIDENTIFIERS = 8
TYPE_PAIR = 9


# -- requests ---------------------------------------------------------------

def encode_query_request(query, shards=None, remote=False,
                         column_attrs=False, exclude_row_attrs=False,
                         exclude_columns=False):
    m = pb.QueryRequest(Query=query, Remote=remote, ColumnAttrs=column_attrs,
                        ExcludeRowAttrs=exclude_row_attrs,
                        ExcludeColumns=exclude_columns)
    if shards:
        m.Shards.extend(int(s) for s in shards)
    return m.SerializeToString()


def decode_query_request(data):
    m = pb.QueryRequest.FromString(data)
    return {
        "query": m.Query,
        "shards": list(m.Shards) or None,
        "remote": m.Remote,
        "column_attrs": m.ColumnAttrs,
        "exclude_row_attrs": m.ExcludeRowAttrs,
        "exclude_columns": m.ExcludeColumns,
    }


# -- results ----------------------------------------------------------------

def _encode_result(result, out):
    from ..core.row import Row
    from ..exec.result import GroupCount, Pair, RowIdentifiers, ValCount

    if result is None:
        out.Type = TYPE_NIL
    elif isinstance(result, Row):
        out.Type = TYPE_ROW
        out.Row.Columns.extend(result.columns())
        if result.keys is not None:
            out.Row.Keys.extend(result.keys)
    elif isinstance(result, bool):
        out.Type = TYPE_BOOL
        out.Changed = result
    elif isinstance(result, int):
        out.Type = TYPE_UINT64
        out.N = result
    elif isinstance(result, ValCount):
        out.Type = TYPE_VALCOUNT
        out.ValCount.Val = result.val
        out.ValCount.Count = result.count
    elif isinstance(result, Pair):
        out.Type = TYPE_PAIR
        _set_pair(out.Pairs.add(), result)
    elif isinstance(result, RowIdentifiers):
        out.Type = TYPE_ROWIDENTIFIERS
        out.RowIdentifiers.Rows.extend(int(r) for r in result.rows)
        if result.keys is not None:
            out.RowIdentifiers.Keys.extend(result.keys)
    elif isinstance(result, list) and result and isinstance(
            result[0], GroupCount):
        out.Type = TYPE_GROUPCOUNTS
        for gc in result:
            g = out.GroupCounts.add()
            g.Count = gc.count
            for fr in gc.group:
                f = g.Group.add()
                f.Field = fr.field
                f.RowID = fr.row_id
                if fr.row_key is not None:
                    f.RowKey = fr.row_key
    elif isinstance(result, list):
        # Pairs (TopN) — possibly empty; empty lists encode as empty pairs
        out.Type = TYPE_PAIRS
        for p in result:
            _set_pair(out.Pairs.add(), p)
    else:
        raise ValueError(f"unencodable result type {type(result)!r}")


def _set_pair(slot, p):
    slot.ID = p.id
    slot.Count = p.count
    if p.key is not None:
        slot.Key = p.key


def _decode_result(m):
    from ..exec.result import (
        FieldRow, GroupCount, Pair, RowIdentifiers, ValCount)

    t = m.Type
    if t == TYPE_NIL:
        return None
    if t == TYPE_ROW:
        out = {"columns": list(m.Row.Columns)}
        if m.Row.Keys:
            out["keys"] = list(m.Row.Keys)
        return out
    if t == TYPE_BOOL:
        return m.Changed
    if t == TYPE_UINT64:
        return m.N
    if t == TYPE_VALCOUNT:
        return ValCount(m.ValCount.Val, m.ValCount.Count)
    if t == TYPE_PAIR:
        p = m.Pairs[0]
        return Pair(p.ID, p.Count, p.Key or None)
    if t == TYPE_PAIRS:
        return [Pair(p.ID, p.Count, p.Key or None) for p in m.Pairs]
    if t == TYPE_ROWIDENTIFIERS:
        return RowIdentifiers(
            list(m.RowIdentifiers.Rows),
            list(m.RowIdentifiers.Keys) or None)
    if t == TYPE_GROUPCOUNTS:
        return [GroupCount(
            [FieldRow(f.Field, f.RowID, f.RowKey or None) for f in g.Group],
            g.Count) for g in m.GroupCounts]
    raise ValueError(f"unknown QueryResult type {t}")


# Attr type tags (reference: attr.go:27-30)
_ATTR_STRING, _ATTR_INT, _ATTR_BOOL, _ATTR_FLOAT = 1, 2, 3, 4


def _encode_attrs(attrs, slot_adder):
    for key, value in sorted(attrs.items()):
        a = slot_adder()
        a.Key = key
        if isinstance(value, bool):
            a.Type, a.BoolValue = _ATTR_BOOL, value
        elif isinstance(value, int):
            a.Type, a.IntValue = _ATTR_INT, value
        elif isinstance(value, float):
            a.Type, a.FloatValue = _ATTR_FLOAT, value
        else:
            a.Type, a.StringValue = _ATTR_STRING, str(value)


def _decode_attrs(pb_attrs):
    out = {}
    for a in pb_attrs:
        if a.Type == _ATTR_BOOL:
            out[a.Key] = a.BoolValue
        elif a.Type == _ATTR_INT:
            out[a.Key] = a.IntValue
        elif a.Type == _ATTR_FLOAT:
            out[a.Key] = a.FloatValue
        else:
            out[a.Key] = a.StringValue
    return out


def encode_query_response(results, err=None, column_attr_sets=None):
    m = pb.QueryResponse()
    if err:
        m.Err = str(err)
    for r in results or []:
        _encode_result(r, m.Results.add())
    for cas in column_attr_sets or []:
        slot = m.ColumnAttrSets.add()
        slot.ID = cas["id"]
        _encode_attrs(cas.get("attrs") or {}, slot.Attrs.add)
    return m.SerializeToString()


def decode_query_response(data):
    """-> (results list, err string or None). Row results decode to the
    JSON-ish dict shape (columns/keys) since the wire Row has no segment
    structure. Use decode_query_response_full for column attr sets."""
    results, err, _ = decode_query_response_full(data)
    return results, err


def decode_query_response_full(data):
    """-> (results, err, column_attr_sets)."""
    m = pb.QueryResponse.FromString(data)
    attr_sets = [{"id": c.ID, "attrs": _decode_attrs(c.Attrs)}
                 for c in m.ColumnAttrSets]
    return ([_decode_result(r) for r in m.Results], m.Err or None,
            attr_sets)
