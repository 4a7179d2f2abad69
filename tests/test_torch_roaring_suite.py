"""The port's roaring layer (`pilosa_tpu_torch.roaring`): the cases of
`tests/test_roaring.py`: containers and their conversions, bitmap
mutation against Python sets, codec round trips and header layout, the
official formats, and the op log (encode, checksum, replay, a corrupt
tail). `tests/test_torch_roaring.py` holds the run containers' words and
a WAL reopen.
"""

import struct

import numpy as np
import pytest

from pilosa_tpu_torch.roaring import (
    Bitmap,
    Container,
    FormatError,
    OP_ADD,
    OP_ADD_BATCH,
    OP_ADD_ROARING,
    OP_REMOVE,
    decode_op,
    deserialize,
    encode_op,
    serialize,
)
from pilosa_tpu_torch.roaring.containers import (
    TYPE_ARRAY,
    TYPE_BITMAP,
    TYPE_RUN,
    words_to_values,
    values_to_words,
)


def bit_sets(rng):
    """Bit sets spanning container representations and multiple keys."""
    return {
        "empty": set(),
        "single": {5},
        "array": set(int(x) for x in rng.choice(1 << 16, 100, replace=False)),
        "bitmap": set(int(x) for x in rng.choice(1 << 16, 30_000, replace=False)),
        "run": set(range(1000, 9000)),
        "multikey": {1, 70_000, (5 << 16) + 3, (1 << 30) + 7, (1 << 45) + 1},
        "mixed": set(int(x) for x in rng.choice(1 << 20, 60_000, replace=False))
        | set(range(200_000, 210_000)),
    }


# -- container level --------------------------------------------------------

def test_container_conversions(rng):
    c = Container()
    assert c.typ == TYPE_ARRAY
    # push past ARRAY_MAX_SIZE -> bitmap
    for v in range(5000):
        assert c.add(v)
    assert c.typ == TYPE_BITMAP and c.n == 5000
    # removal far below threshold -> back to array
    for v in range(4000):
        assert c.remove(v)
    assert c.typ == TYPE_ARRAY and c.n == 1000
    assert set(c.to_values()) == set(range(4000, 5000))


def test_container_runs_roundtrip():
    c = Container.from_runs([[3, 10], [100, 100], [65530, 65535]])
    assert c.n == 8 + 1 + 6
    assert c.contains(3) and c.contains(10) and c.contains(100) and c.contains(65535)
    assert not c.contains(11)
    vals = set(c.to_values())
    assert vals == set(range(3, 11)) | {100} | set(range(65530, 65536))
    # dense roundtrip
    assert set(words_to_values(c.to_dense_words())) == vals
    # mutation forces conversion out of run type
    c.add(50)
    assert c.typ != TYPE_RUN and c.contains(50) and c.n == 16


def test_container_optimized_picks_smallest():
    runs = Container.from_values(list(range(6000))).optimized()
    assert runs.typ == TYPE_RUN  # 1 run beats bitmap
    arr = Container.from_values([1, 5, 9]).optimized()
    assert arr.typ == TYPE_ARRAY
    scattered = Container.from_values(list(range(0, 65536, 2))).optimized()
    assert scattered.typ == TYPE_BITMAP  # 32768 values, 16384 runs


def test_words_values_roundtrip(rng):
    vals = np.sort(rng.choice(1 << 16, 5000, replace=False)).astype(np.uint16)
    assert np.array_equal(words_to_values(values_to_words(vals)), vals)


# -- bitmap level -----------------------------------------------------------

def test_bitmap_add_remove_differential(rng):
    want = set()
    b = Bitmap()
    ops = rng.integers(0, 1 << 21, size=3000)
    for i, bit in enumerate(ops):
        bit = int(bit)
        if i % 3 == 2:
            assert b.remove(bit) == (bit in want)
            want.discard(bit)
        else:
            assert b.add(bit) == (bit not in want)
            want.add(bit)
    assert b.count() == len(want)
    assert set(int(x) for x in b.slice_range(0, 1 << 22)) == want


def test_bitmap_bulk_differential(rng):
    for name, bits in bit_sets(rng).items():
        b = Bitmap()
        changed = b.add_many(list(bits))
        assert changed == len(bits), name
        assert b.count() == len(bits), name
        assert set(int(x) for x in b.slice_range(0, 1 << 50)) == bits, name
        # re-adding changes nothing
        assert b.add_many(list(bits)) == 0, name
        # remove half
        half = sorted(bits)[::2]
        assert b.remove_many(half) == len(half), name
        assert set(int(x) for x in b.slice_range(0, 1 << 50)) == bits - set(half), name


def test_count_range(rng):
    bits = set(int(x) for x in rng.choice(1 << 20, 10_000, replace=False))
    b = Bitmap.from_bits(list(bits))
    for lo, hi in [(0, 1 << 20), (1000, 2000), (65536, 131072), (0, 1), (99, 700_000)]:
        assert b.count_range(lo, hi) == len([x for x in bits if lo <= x < hi])


def test_dense_range_words(rng):
    bits = set(int(x) for x in rng.choice(1 << 20, 20_000, replace=False))
    b = Bitmap.from_bits(list(bits))
    plane = b.dense_range_words(0, 16)  # whole shard 0 row
    got = set()
    vals = words_to_values  # container-sized chunks
    for k in range(16):
        chunk = plane[k * 2048:(k + 1) * 2048]
        got |= {int(v) + (k << 16) for v in words_to_values(chunk)}
    assert got == bits


def test_replace_and_merge_dense(rng):
    b = Bitmap.from_bits([1, 2, 3, 70_000])
    plane = np.zeros(2048, dtype=np.uint32)
    plane[0] = 0b1010  # bits 1,3
    changed = b.merge_dense_words(0, plane)
    assert changed == 0  # both already set
    plane[1] = 1  # bit 32
    assert b.merge_dense_words(0, plane) == 1
    assert b.contains(32)
    # clear
    assert b.merge_dense_words(0, plane, clear=True) == 3
    assert not b.contains(1) and not b.contains(3) and not b.contains(32)
    assert b.contains(2) and b.contains(70_000)


# -- codec ------------------------------------------------------------------

def test_serialize_roundtrip(rng):
    for name, bits in bit_sets(rng).items():
        b = Bitmap.from_bits(list(bits))
        data = serialize(b)
        b2, flags, op_count = deserialize(data)
        assert flags == 0 and op_count == 0
        assert set(int(x) for x in b2.slice_range(0, 1 << 50)) == bits, name
        # container metadata consistent
        for key in b2.keys():
            assert b2.containers[key].n == b2.containers[key]._count(), name


def test_serialize_header_layout(rng):
    b = Bitmap.from_bits([0, 2, 9])  # 3 runs > n/2 -> stays array
    data = serialize(b)
    magic, version, flags = struct.unpack_from("<HBB", data, 0)
    assert magic == 12348 and version == 0 and flags == 0
    assert struct.unpack_from("<I", data, 4)[0] == 1  # one container
    key, typ, n1 = struct.unpack_from("<QHH", data, 8)
    assert key == 0 and typ == TYPE_ARRAY and n1 == 2
    offset = struct.unpack_from("<I", data, 20)[0]
    assert offset == 24
    assert np.frombuffer(data, dtype="<u2", count=3, offset=24).tolist() == [0, 2, 9]


def test_optimize_rule_matches_reference():
    # run when runs <= n/2 and <= 2048; contiguous triple -> run
    assert Container.from_values([0, 1, 2]).optimized().typ == TYPE_RUN


def test_serialize_flags_roundtrip():
    b = Bitmap.from_bits([7])
    data = serialize(b, flags=1)
    _, flags, _ = deserialize(data)
    assert flags == 1


def test_official_format_no_runs():
    # Hand-build an official-format blob: cookie 12346, 1 container,
    # key=0, card=3, offsets, then array [10, 20, 30].
    blob = struct.pack("<II", 12346, 1)
    blob += struct.pack("<HH", 0, 2)  # key, card-1
    blob += struct.pack("<I", len(blob) + 4)  # offset section
    blob += struct.pack("<HHH", 10, 20, 30)
    b, flags, ops = deserialize(blob)
    assert set(int(x) for x in b.slice_range(0, 1 << 20)) == {10, 20, 30}


def test_official_format_runs():
    # cookie 12347 with count-1 in high bits; run flag bitset marks container
    # 0 as run; runs stored [start, length-1].
    cookie = 12347 | (0 << 16)
    blob = struct.pack("<I", cookie)
    blob += bytes([0b1])  # run bitset, 1 container
    blob += struct.pack("<HH", 0, 9)  # key 0, card-1 = 9
    blob += struct.pack("<H", 1)  # one run
    blob += struct.pack("<HH", 5, 9)  # start 5, len-1 9 -> [5, 14]
    b, _, _ = deserialize(blob)
    assert set(int(x) for x in b.slice_range(0, 1 << 20)) == set(range(5, 15))


def test_op_encode_decode(rng):
    data = encode_op(OP_ADD, value=12345)
    typ, value, values, roaring, op_n, pos = decode_op(data, 0)
    assert (typ, value, pos) == (OP_ADD, 12345, 13)

    vals = rng.integers(0, 1 << 40, size=17).astype(np.uint64)
    data = encode_op(OP_ADD_BATCH, values=vals)
    typ, _, got, _, _, pos = decode_op(data, 0)
    assert typ == OP_ADD_BATCH and np.array_equal(got, vals) and pos == len(data)

    blob = serialize(Bitmap.from_bits([1, 2, 3]))
    data = encode_op(OP_ADD_ROARING, roaring=blob, op_n=3)
    typ, _, _, got, op_n, pos = decode_op(data, 0)
    assert typ == OP_ADD_ROARING and got == blob and op_n == 3


def test_op_checksum_rejects_corruption():
    data = bytearray(encode_op(OP_ADD, value=99))
    data[2] ^= 0xFF
    with pytest.raises(FormatError):
        decode_op(bytes(data), 0)


def test_op_log_replay(rng):
    b = Bitmap.from_bits([1, 2, 3])
    data = serialize(b)
    # Append ops: add 100, remove 2, batch add [500, 600], roaring-add {9}.
    data += encode_op(OP_ADD, value=100)
    data += encode_op(OP_REMOVE, value=2)
    data += encode_op(OP_ADD_BATCH, values=np.array([500, 600], dtype=np.uint64))
    blob = serialize(Bitmap.from_bits([9]))
    data += encode_op(OP_ADD_ROARING, roaring=blob, op_n=1)
    b2, _, op_count = deserialize(data)
    assert op_count == 4
    assert set(int(x) for x in b2.slice_range(0, 1 << 20)) == {1, 3, 9, 100, 500, 600}


def test_op_log_stops_at_corrupt_tail():
    data = serialize(Bitmap.from_bits([1]))
    data += encode_op(OP_ADD, value=7)
    data += b"\x00garbage"  # truncated/corrupt op
    b2, _, op_count = deserialize(data)
    assert op_count == 1
    assert b2.contains(7) and b2.contains(1)


def test_empty_bitmap_roundtrip():
    data = serialize(Bitmap())
    b, flags, ops = deserialize(data)
    assert b.count() == 0
    # empty bitmap + op log still replays
    data += encode_op(OP_ADD, value=42)
    b, _, ops = deserialize(data)
    assert ops == 1 and b.contains(42)
