"""A hand-written proto3 codec for the messages of `pilosa.proto`.

Each message class has the field attributes of the classes `protoc`
generates from that schema, `SerializeToString()`, `ParseFromString()`,
`FromString()`, `HasField()`, `SetInParent()`, `CopyFrom()` and
`Clear()`, and writes the same bytes as the protobuf runtime does for
the same fields:

- fields in field-number order; a scalar at its default (0, "", b"",
  False, +0.0) is left out, a set submessage is written even when it is
  empty. A submessage becomes set when any of its fields is written or
  any of its repeated fields is extended or added to, even by nothing;
  reading it does not set it;
- an int64 below zero is the 10-byte varint of its two's complement; a
  double is 8 little-endian bytes, and -0.0 and NaN are not defaults;
- repeated integers are written packed, repeated strings, bytes and
  messages one field each.

Parsing takes packed and unpacked repeated integers alike (the runs of
both forms append in order), lets the last value of a repeated scalar
field win, merges a submessage that appears more than once, skips fields
it does not know and fields whose wire type does not fit, and raises
DecodeError on a truncated buffer, a varint longer than 10 bytes, a
string that is not UTF-8 or an unknown wire type.

Repeated integers live in numpy arrays: a packed field of a million
values is encoded and decoded by whole-array operations, not a Python
step per value.
"""

import operator
import struct

import numpy as np


class DecodeError(ValueError):
    """A buffer that is not a valid encoding of the message."""


UINT64, INT64, UINT32, BOOL, STRING, BYTES, DOUBLE, MESSAGE = range(8)
_INT_KINDS = (UINT64, INT64, UINT32, BOOL)
_LIMITS = {UINT64: (0, (1 << 64) - 1), INT64: (-(1 << 63), (1 << 63) - 1),
           UINT32: (0, (1 << 32) - 1)}
_MASK64 = (1 << 64) - 1
_U64_SHIFTS = [np.uint64(7 * j) for j in range(10)]
_U64_BOUNDS = [np.uint64(1 << (7 * k)) for k in range(1, 10)]


# -- varints ------------------------------------------------------------------

def _varint(value, out):
    """Append the varint of a non-negative int below 2^64 to `out`."""
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _read_varint(buf, pos, end):
    """(value, next pos) of the varint at `pos`; bits past 64 drop."""
    value = shift = 0
    for i in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value & _MASK64, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def encode_varints(values):
    """Packed varints of a uint64 array, as bytes."""
    a = np.ascontiguousarray(values, dtype=np.uint64)
    if a.size == 0:
        return b""
    nb = np.ones(a.shape, np.int64)
    for bound in _U64_BOUNDS:
        nb += a >= bound
    longest = int(nb.max())
    if longest == 1:
        return a.astype(np.uint8).tobytes()
    shortest = int(nb.min())
    ends = np.cumsum(nb)
    starts = ends - nb
    out = np.empty(int(ends[-1]), np.uint8)
    for j in range(longest):
        if j < shortest:
            part, at, lens = a, starts, nb
        else:
            sel = np.flatnonzero(nb > j)
            part, at, lens = a[sel], starts[sel], nb[sel]
        byte = ((part >> _U64_SHIFTS[j]) & np.uint64(0x7F)).astype(np.uint8)
        byte |= (lens > j + 1).astype(np.uint8) << np.uint8(7)
        out[at + j] = byte
    return out.tobytes()


def decode_varints(data):
    """uint64 array of the packed varints in `data` (bytes-like)."""
    b = np.frombuffer(data, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    ends = np.flatnonzero(b < 0x80)
    if ends.size == 0 or ends[-1] != b.size - 1:
        raise DecodeError("truncated packed varint")
    if ends.size == b.size:
        return b.astype(np.uint64)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    longest = int(lens.max())
    if longest > 10:
        raise DecodeError("varint longer than 10 bytes")
    payload = (b & 0x7F).astype(np.uint64)
    out = payload[starts]
    for j in range(1, longest):
        sel = np.flatnonzero(lens > j)
        out[sel] |= payload[starts[sel] + j] << _U64_SHIFTS[j]
    return out


# -- repeated containers ------------------------------------------------------

def _as_int_array(values, kind):
    """`values` (an array or an iterable of ints) as the field's numpy
    array, range-checked as the protobuf runtime checks it."""
    dtype = np.int64 if kind == INT64 else np.uint64
    if isinstance(values, np.ndarray):
        if values.dtype.kind == "b":
            return values.astype(dtype)
        if values.dtype.kind not in "iu":
            raise TypeError(f"integers required, not {values.dtype}")
        if values.size:
            lo, hi = _LIMITS[kind]
            if int(values.min()) < lo or int(values.max()) > hi:
                raise ValueError("value out of range")
        return values.astype(dtype)
    if not isinstance(values, (list, tuple)):
        values = list(values)
    try:
        return np.array(values, dtype=dtype).reshape(-1)
    except OverflowError as e:
        raise ValueError(f"value out of range: {e}") from e


class RepeatedInts:
    """A repeated uint64/int64 field, held as one numpy array. Iteration
    and indexing give Python ints; `array` is the numpy array itself."""

    __slots__ = ("_owner", "_kind", "_arr", "_tail")

    def __init__(self, owner, kind):
        self._owner = owner
        self._kind = kind
        self._arr = np.zeros(0, np.int64 if kind == INT64 else np.uint64)
        self._tail = []  # values appended one at a time, not yet in _arr

    @property
    def array(self):
        if self._tail:
            add = _as_int_array(self._tail, self._kind)
            self._tail = []
            self._arr = np.concatenate((self._arr, add))
        return self._arr

    def extend(self, values):
        add = _as_int_array(values, self._kind)
        arr = self.array
        self._arr = np.concatenate((arr, add)) if arr.size else add
        self._owner._touch()

    def append(self, value):
        self._tail.append(_check_scalar(self._kind, value))
        self._owner._touch()

    def __len__(self):
        return int(self._arr.size) + len(self._tail)

    def __iter__(self):
        return iter(self.array.tolist())

    def __getitem__(self, i):
        return self.array[i].tolist()

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return repr(self.array.tolist())


class RepeatedScalars:
    """A repeated string or bytes field."""

    __slots__ = ("_owner", "_kind", "_items")

    def __init__(self, owner, kind):
        self._owner = owner
        self._kind = kind
        self._items = []

    def append(self, value):
        self._items.append(_check_scalar(self._kind, value))
        self._owner._touch()

    def extend(self, values):
        self._items.extend(_check_scalar(self._kind, v) for v in values)
        self._owner._touch()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other):
        return self._items == list(other)

    def __repr__(self):
        return repr(self._items)


class RepeatedMessages:
    """A repeated message field; `add(**fields)` appends a new element
    and returns it."""

    __slots__ = ("_owner", "_cls", "_items")

    def __init__(self, owner, cls):
        self._owner = owner
        self._cls = cls
        self._items = []

    def add(self, **fields):
        m = self._cls(**fields)
        self._items.append(m)
        self._owner._touch()
        return m

    def append(self, message):
        self.add().CopyFrom(message)

    def extend(self, messages):
        for m in messages:
            self.append(m)
        self._owner._touch()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other):
        return self._items == list(other)

    def __repr__(self):
        return repr(self._items)


# -- scalars ------------------------------------------------------------------

def _check_scalar(kind, value):
    if kind in _LIMITS:
        value = operator.index(value)
        lo, hi = _LIMITS[kind]
        if not lo <= value <= hi:
            raise ValueError(f"value out of range: {value}")
        return value
    if kind == BOOL:
        return bool(operator.index(value))
    if kind == STRING:
        if not isinstance(value, str):
            raise TypeError(f"str required, not {type(value).__name__}")
        return value
    if kind == BYTES:
        if not isinstance(value, (bytes, bytearray)):
            raise TypeError(f"bytes required, not {type(value).__name__}")
        return bytes(value)
    if kind == DOUBLE:
        if isinstance(value, (str, bytes)):
            raise TypeError("float required")
        return float(value)
    raise TypeError("not a scalar field")


_DEFAULTS = {UINT64: 0, INT64: 0, UINT32: 0, BOOL: False, STRING: "",
             BYTES: b"", DOUBLE: 0.0}


def _is_default(kind, value):
    if kind == DOUBLE:
        return struct.pack("<d", value) == bytes(8)
    return value == _DEFAULTS[kind]


# -- messages -----------------------------------------------------------------

class Field:
    """One field of a message: name, number, kind, repeated, and the
    message class of a MESSAGE field."""

    __slots__ = ("name", "number", "kind", "repeated", "message", "tag")

    def __init__(self, name, number, kind, repeated=False, message=None):
        self.name = name
        self.number = number
        self.kind = kind
        self.repeated = repeated
        self.message = message
        if kind == DOUBLE:
            wire = 1
        elif kind in _INT_KINDS and not repeated:
            wire = 0
        else:
            wire = 2
        tag = bytearray()
        _varint(number << 3 | wire, tag)
        self.tag = bytes(tag)


class Message:
    """Base of the message classes: keeps the set fields in `_values`;
    an unset submessage read through its attribute is a stub that joins
    its parent's `_values` at its first write."""

    __slots__ = ("_values", "_stubs", "_parent")
    FIELDS = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        for f in cls.FIELDS:
            setattr(cls, f.name, _field_property(f))

    def __init__(self, **fields):
        self._values = {}
        self._stubs = {}
        self._parent = None
        for name, value in fields.items():
            f = next((f for f in self.FIELDS if f.name == name), None)
            if f is None:
                raise ValueError(
                    f"{type(self).__name__} has no field {name!r}")
            if f.repeated:
                getattr(self, name).extend(value)
            elif f.kind == MESSAGE:
                getattr(self, name).CopyFrom(value)
            else:
                setattr(self, name, value)

    def _touch(self):
        """A write reached this message: a stub joins its parent."""
        parent = self._parent
        if parent is not None:
            owner, name = parent
            self._parent = None
            owner._stubs.pop(name, None)
            owner._values[name] = self
            owner._touch()

    def SetInParent(self):
        """Mark this (possibly empty) submessage set in its parent."""
        self._touch()

    def HasField(self, name):
        f = next((f for f in self.FIELDS if f.name == name), None)
        if f is None or f.repeated:
            raise ValueError(f"{name!r} is not a singular field")
        if f.kind != MESSAGE:
            raise ValueError(f"{name!r} has no presence in proto3")
        return name in self._values

    def _clear(self):
        self._values = {}
        self._stubs = {}

    # a field named Clear (ImportRoaringRequest.Clear) shadows this name
    # in its class, as in the protobuf runtime; internals call _clear()
    Clear = _clear

    def CopyFrom(self, other):
        if other is self:
            return
        self._clear()
        self.MergeFromString(other.SerializeToString())
        self._touch()

    @classmethod
    def FromString(cls, data):
        m = cls()
        m.ParseFromString(data)
        return m

    def ParseFromString(self, data):
        self._clear()
        return self.MergeFromString(data)

    def MergeFromString(self, data):
        buf = bytes(data)
        self._merge(buf, 0, len(buf))
        return len(buf)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        for f in self.FIELDS:
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.kind == MESSAGE and not f.repeated:
                if (f.name in self._values) != (f.name in other._values):
                    return False
            if f.repeated and list(a) != list(b):
                return False
            if not f.repeated and a != b:
                return False
        return True

    def __repr__(self):
        parts = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{type(self).__name__}({parts})"

    # -- encoding ------------------------------------------------------------

    def SerializeToString(self):
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _write(self, out):
        values = self._values
        for f in self.FIELDS:
            v = values.get(f.name)
            if v is None:
                continue
            kind = f.kind
            if f.repeated:
                if not len(v):
                    continue
                if kind in (UINT64, INT64):
                    payload = encode_varints(v.array.view(np.uint64))
                    out += f.tag
                    _varint(len(payload), out)
                    out += payload
                elif kind == MESSAGE:
                    for m in v:
                        sub = m.SerializeToString()
                        out += f.tag
                        _varint(len(sub), out)
                        out += sub
                else:
                    for s in v:
                        b = s.encode("utf-8") if kind == STRING else s
                        out += f.tag
                        _varint(len(b), out)
                        out += b
            elif kind == MESSAGE:
                sub = v.SerializeToString()
                out += f.tag
                _varint(len(sub), out)
                out += sub
            elif _is_default(kind, v):
                continue
            elif kind in _INT_KINDS:
                out += f.tag
                _varint(int(v) & _MASK64, out)
            elif kind == DOUBLE:
                out += f.tag
                out += struct.pack("<d", v)
            else:
                b = v.encode("utf-8") if kind == STRING else v
                out += f.tag
                _varint(len(b), out)
                out += b

    # -- decoding ------------------------------------------------------------

    def _merge(self, buf, pos, end):
        by_number = self._BY_NUMBER
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if wire == 0:
                value, pos = _read_varint(buf, pos, end)
                if f is not None and f.kind in _INT_KINDS:
                    value = _from_u64(f.kind, value)
                    if f.repeated:
                        getattr(self, f.name).append(value)
                    else:
                        self._values[f.name] = value
            elif wire == 2:
                size, pos = _read_varint(buf, pos, end)
                stop = pos + size
                if stop > end:
                    raise DecodeError("truncated length-delimited field")
                if f is not None:
                    self._merge_delimited(f, buf, pos, stop)
                pos = stop
            elif wire == 1:
                if pos + 8 > end:
                    raise DecodeError("truncated fixed64")
                if f is not None and f.kind == DOUBLE and not f.repeated:
                    self._values[f.name] = struct.unpack_from(
                        "<d", buf, pos)[0]
                pos += 8
            elif wire == 5:
                if pos + 4 > end:
                    raise DecodeError("truncated fixed32")
                pos += 4
            elif wire == 3:
                pos = _skip_group(buf, pos, end, number)
            else:
                raise DecodeError(f"wire type {wire}")

    def _merge_delimited(self, f, buf, pos, stop):
        kind = f.kind
        if kind == MESSAGE:
            if f.repeated:
                sub = getattr(self, f.name).add()
            else:
                sub = getattr(self, f.name)
            sub._merge(buf, pos, stop)
            sub._touch()
        elif kind in (STRING, BYTES):
            raw = buf[pos:stop]
            if kind == STRING:
                try:
                    raw = raw.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"invalid UTF-8 in {f.name}") from e
            if f.repeated:
                getattr(self, f.name).append(raw)
            else:
                self._values[f.name] = raw
        elif f.repeated and kind in (UINT64, INT64):
            vals = decode_varints(memoryview(buf)[pos:stop])
            getattr(self, f.name).extend(
                vals.view(np.int64) if kind == INT64 else vals)
        # a singular scalar sent length-delimited is a wire-type mismatch:
        # skipped like an unknown field


def _from_u64(kind, value):
    if kind == INT64:
        return value - (1 << 64) if value >> 63 else value
    if kind == UINT32:
        return value & 0xFFFFFFFF
    if kind == BOOL:
        return value != 0
    return value


def _skip_group(buf, pos, end, number):
    """Position past the end-group tag matching a start-group of
    `number` (nested groups and every field inside skipped)."""
    while True:
        key, pos = _read_varint(buf, pos, end)
        wire = key & 7
        if wire == 4:
            if key >> 3 != number:
                raise DecodeError("mismatched end-group")
            return pos
        if wire == 0:
            _, pos = _read_varint(buf, pos, end)
        elif wire == 1:
            pos += 8
        elif wire == 2:
            size, pos = _read_varint(buf, pos, end)
            pos += size
        elif wire == 5:
            pos += 4
        elif wire == 3:
            pos = _skip_group(buf, pos, end, key >> 3)
        else:
            raise DecodeError(f"wire type {wire}")
        if pos > end:
            raise DecodeError("truncated group")


def _field_property(f):
    name = f.name
    if f.repeated:
        if f.kind == MESSAGE:
            def make(owner):
                return RepeatedMessages(owner, f.message)
        elif f.kind in (UINT64, INT64):
            def make(owner):
                return RepeatedInts(owner, f.kind)
        else:
            def make(owner):
                return RepeatedScalars(owner, f.kind)

        def get(self):
            v = self._values.get(name)
            if v is None:
                v = self._values[name] = make(self)
            return v

        def set_(self, value):
            raise AttributeError(
                f"assignment to repeated field {name!r}; use extend()")
        return property(get, set_)
    if f.kind == MESSAGE:
        cls = f.message

        def get(self):
            v = self._values.get(name)
            if v is None:
                v = self._stubs.get(name)
                if v is None:
                    v = self._stubs[name] = cls()
                    v._parent = (self, name)
            return v

        def set_(self, value):
            raise AttributeError(
                f"assignment to message field {name!r}; use CopyFrom()")
        return property(get, set_)
    kind = f.kind
    default = _DEFAULTS[kind]

    def get(self):
        return self._values.get(name, default)

    def set_(self, value):
        self._values[name] = _check_scalar(kind, value)
        self._touch()
    return property(get, set_)


# -- the messages of pilosa.proto ---------------------------------------------

class Attr(Message):
    __slots__ = ()
    FIELDS = (Field("Key", 1, STRING), Field("Type", 2, UINT64),
              Field("StringValue", 3, STRING), Field("IntValue", 4, INT64),
              Field("BoolValue", 5, BOOL), Field("FloatValue", 6, DOUBLE))


class Row(Message):
    __slots__ = ()
    FIELDS = (Field("Columns", 1, UINT64, True),
              Field("Attrs", 2, MESSAGE, True, Attr),
              Field("Keys", 3, STRING, True))


class RowIdentifiers(Message):
    __slots__ = ()
    FIELDS = (Field("Rows", 1, UINT64, True), Field("Keys", 2, STRING, True))


class Pair(Message):
    __slots__ = ()
    FIELDS = (Field("ID", 1, UINT64), Field("Count", 2, UINT64),
              Field("Key", 3, STRING))


class FieldRow(Message):
    __slots__ = ()
    FIELDS = (Field("Field", 1, STRING), Field("RowID", 2, UINT64),
              Field("RowKey", 3, STRING))


class GroupCount(Message):
    __slots__ = ()
    FIELDS = (Field("Group", 1, MESSAGE, True, FieldRow),
              Field("Count", 2, UINT64))


class ValCount(Message):
    __slots__ = ()
    FIELDS = (Field("Val", 1, INT64), Field("Count", 2, INT64))


class ColumnAttrSet(Message):
    __slots__ = ()
    FIELDS = (Field("ID", 1, UINT64), Field("Attrs", 2, MESSAGE, True, Attr),
              Field("Key", 3, STRING))


class QueryRequest(Message):
    __slots__ = ()
    FIELDS = (Field("Query", 1, STRING), Field("Shards", 2, UINT64, True),
              Field("ColumnAttrs", 3, BOOL), Field("Remote", 5, BOOL),
              Field("ExcludeRowAttrs", 6, BOOL),
              Field("ExcludeColumns", 7, BOOL))


class QueryResult(Message):
    __slots__ = ()
    FIELDS = (Field("Row", 1, MESSAGE, False, Row), Field("N", 2, UINT64),
              Field("Pairs", 3, MESSAGE, True, Pair),
              Field("Changed", 4, BOOL),
              Field("ValCount", 5, MESSAGE, False, ValCount),
              Field("Type", 6, UINT32), Field("RowIDs", 7, UINT64, True),
              Field("GroupCounts", 8, MESSAGE, True, GroupCount),
              Field("RowIdentifiers", 9, MESSAGE, False, RowIdentifiers))


class QueryResponse(Message):
    __slots__ = ()
    FIELDS = (Field("Err", 1, STRING),
              Field("Results", 2, MESSAGE, True, QueryResult),
              Field("ColumnAttrSets", 3, MESSAGE, True, ColumnAttrSet))


class ImportRequest(Message):
    __slots__ = ()
    FIELDS = (Field("Index", 1, STRING), Field("Field", 2, STRING),
              Field("Shard", 3, UINT64), Field("RowIDs", 4, UINT64, True),
              Field("ColumnIDs", 5, UINT64, True),
              Field("Timestamps", 6, INT64, True),
              Field("RowKeys", 7, STRING, True),
              Field("ColumnKeys", 8, STRING, True))


class ImportValueRequest(Message):
    __slots__ = ()
    FIELDS = (Field("Index", 1, STRING), Field("Field", 2, STRING),
              Field("Shard", 3, UINT64), Field("ColumnIDs", 5, UINT64, True),
              Field("Values", 6, INT64, True),
              Field("ColumnKeys", 7, STRING, True))


class ImportRoaringRequestView(Message):
    __slots__ = ()
    FIELDS = (Field("Name", 1, STRING), Field("Data", 2, BYTES))


class ImportRoaringRequest(Message):
    __slots__ = ()
    FIELDS = (Field("Clear", 1, BOOL),
              Field("views", 2, MESSAGE, True, ImportRoaringRequestView))


class ImportResponse(Message):
    __slots__ = ()
    FIELDS = (Field("Err", 1, STRING),)


class TranslateKeysRequest(Message):
    __slots__ = ()
    FIELDS = (Field("Index", 1, STRING), Field("Field", 2, STRING),
              Field("Keys", 3, STRING, True))


class TranslateKeysResponse(Message):
    __slots__ = ()
    FIELDS = (Field("IDs", 3, UINT64, True),)


#: every message of pilosa.proto, by name
MESSAGES = {cls.__name__: cls for cls in (
    Attr, Row, RowIdentifiers, Pair, FieldRow, GroupCount, ValCount,
    ColumnAttrSet, QueryRequest, QueryResult, QueryResponse, ImportRequest,
    ImportValueRequest, ImportRoaringRequestView, ImportRoaringRequest,
    ImportResponse, TranslateKeysRequest, TranslateKeysResponse)}
