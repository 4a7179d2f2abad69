"""The port's data hierarchy (`pilosa_tpu_torch.core`): the cases of
`tests/test_core.py` against the same literals: fragment persistence,
WAL and snapshot, field types, time views, index and holder lifecycle,
the mutex rows-vector.

The reference's `test_row_device_cache_invalidation` is not ported: the
port's fragments keep no per-row device cache (`Fragment.row_device`);
device planes live in the executor's stack pool, whose in-place patch
after a write is held by `tests/test_torch_stacked_serving.py`.
"""

import datetime as dt
import os

import numpy as np
import pytest

from pilosa_tpu_torch.core import (
    EXISTENCE_FIELD_NAME,
    FieldOptions,
    Holder,
    IndexOptions,
    Row,
)
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture
def holder(tmp_path):
    h = Holder(str(tmp_path / "data"), use_snapshot_queue=False)
    h.open()
    yield h
    h.close()


# -- fragment ---------------------------------------------------------------

def test_fragment_set_clear_persist(tmp_path):
    path = str(tmp_path / "frag0")
    f = Fragment(path, "i", "f", "standard", 0).open()
    assert f.set_bit(10, 100)
    assert not f.set_bit(10, 100)  # already set
    assert f.set_bit(10, 200)
    assert f.set_bit(99, SHARD_WIDTH - 1)
    assert f.clear_bit(10, 200)
    assert not f.clear_bit(10, 200)
    f.close()

    f2 = Fragment(path, "i", "f", "standard", 0).open()
    assert f2.contains(10, 100)
    assert not f2.contains(10, 200)
    assert f2.contains(99, SHARD_WIDTH - 1)
    assert f2.row_ids() == [10, 99]
    f2.close()


def test_fragment_shard_offset(tmp_path):
    f = Fragment(str(tmp_path / "frag3"), "i", "f", "standard", 3).open()
    col = 3 * SHARD_WIDTH + 17
    assert f.set_bit(5, col)
    assert list(f.row_columns(5)) == [col]
    with pytest.raises(ValueError):
        f.set_bit(5, 17)  # wrong shard
    f.close()


def test_fragment_snapshot_resets_oplog(tmp_path):
    path = str(tmp_path / "frag")
    f = Fragment(path, "i", "f", "standard", 0, max_op_n=10).open()
    for i in range(25):
        f.set_bit(1, i)
    # 25 ops with threshold 10 -> snapshotted at least twice, op_n small
    assert f.op_n <= 10
    size_with_ops = os.path.getsize(path)
    f.snapshot()
    assert f.op_n == 0
    f.close()
    f2 = Fragment(path, "i", "f", "standard", 0).open()
    assert f2.storage.count() == 25
    f2.close()


def test_fragment_bulk_import_and_blocks(tmp_path, rng):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    rows = rng.integers(0, 500, 5000).astype(np.uint64)
    cols = rng.integers(0, SHARD_WIDTH, 5000).astype(np.uint64)
    f.bulk_import(rows, cols)
    want = {(int(r), int(c)) for r, c in zip(rows, cols)}
    assert f.cardinality() == len(want)
    blocks = f.blocks()
    assert [b for b, _ in blocks] == sorted({r // 100 for r, _ in want})
    # block_data roundtrip
    rs, cs = f.block_data(blocks[0][0])
    got = {(int(r), int(c)) for r, c in zip(rs, cs)}
    assert got == {(r, c) for r, c in want if r // 100 == blocks[0][0]}
    # checksums change on write
    before = dict(f.blocks())
    f.set_bit(int(rows[0]), int((cols[0] + 1) % SHARD_WIDTH))
    after = dict(f.blocks())
    assert before[int(rows[0]) // 100] != after[int(rows[0]) // 100]
    f.close()


def test_fragment_import_roaring(tmp_path):
    from pilosa_tpu_torch.roaring import Bitmap, serialize

    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    bits = [5 * SHARD_WIDTH + 10, 5 * SHARD_WIDTH + 99, 7 * SHARD_WIDTH + 3]
    changed = f.import_roaring(serialize(Bitmap.from_bits(bits)))
    assert changed == 3
    assert f.contains(5, 10) and f.contains(5, 99) and f.contains(7, 3)
    # clear path
    changed = f.import_roaring(
        serialize(Bitmap.from_bits(bits[:1])), clear=True)
    assert changed == 1 and not f.contains(5, 10)
    f.close()
    # WAL replay preserves roaring import
    f2 = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    assert not f2.contains(5, 10) and f2.contains(5, 99) and f2.contains(7, 3)
    f2.close()


def test_fragment_bsi_values(tmp_path):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "bsig_f", 0).open()
    assert f.set_value(10, 8, 100)
    assert f.set_value(11, 8, -100)
    assert f.set_value(12, 8, 0)
    assert f.value(10, 8) == (100, True)
    assert f.value(11, 8) == (-100, True)
    assert f.value(12, 8) == (0, True)
    assert f.value(13, 8) == (0, False)
    # overwrite
    assert f.set_value(10, 8, 7)
    assert f.value(10, 8) == (7, True)
    # clear
    assert f.clear_value(11, 8)
    assert f.value(11, 8) == (0, False)
    f.close()


def test_fragment_mutex(tmp_path):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0,
                 mutexed=True).open()
    assert f.set_bit(3, 50)
    assert f.set_bit(7, 50)  # moves column 50 from row 3 to 7
    assert not f.contains(3, 50)
    assert f.contains(7, 50)
    # bulk mutex import: last write per column wins
    f.bulk_import([1, 2, 1], [60, 60, 61])
    assert f.row_for_column(60) == 2
    assert f.row_for_column(61) == 1
    f.close()


def test_fragment_set_row_plane(tmp_path):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    f.set_bit(4, 1)
    f.set_bit(4, 2)
    new = np.zeros(SHARD_WIDTH // 32, dtype=np.uint32)
    new[0] = 0b1000  # bit 3 only
    f.set_row_plane(4, new)
    assert list(f.row_columns(4)) == [3]
    f.close()
    f2 = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0).open()
    assert list(f2.row_columns(4)) == [3]
    f2.close()


# -- time views -------------------------------------------------------------

def test_views_by_time():
    t = dt.datetime(2019, 1, 2, 3, 0)
    assert timeq.views_by_time("standard", t, "YMDH") == [
        "standard_2019", "standard_201901", "standard_20190102",
        "standard_2019010203"]
    assert timeq.views_by_time("standard", t, "MD") == [
        "standard_201901", "standard_20190102"]


def test_views_by_time_range():
    # mirror of reference TestViewsByTimeRange cases (time_internal_test.go)
    start = dt.datetime(2017, 1, 1, 0, 0)
    end = dt.datetime(2019, 1, 1, 0, 0)
    assert timeq.views_by_time_range("f", start, end, "Y") == [
        "f_2017", "f_2018"]
    start = dt.datetime(2016, 11, 1)
    end = dt.datetime(2017, 3, 1)
    assert timeq.views_by_time_range("f", start, end, "YM") == [
        "f_201611", "f_201612", "f_201701", "f_201702"]
    # ragged edges: hours at the start, days in the middle
    start = dt.datetime(2018, 1, 1, 22, 0)
    end = dt.datetime(2018, 1, 3, 0, 0)
    assert timeq.views_by_time_range("f", start, end, "DH") == [
        "f_2018010122", "f_2018010123", "f_20180102"]


def test_quantum_validation():
    with pytest.raises(timeq.InvalidTimeQuantum):
        timeq.validate_quantum("YMX")
    timeq.validate_quantum("YMDH")


# -- field ------------------------------------------------------------------

def test_field_set_time_fanout(holder):
    idx = holder.create_index("i")
    fld = idx.create_field("events", FieldOptions.time_field("YMD"))
    t = dt.datetime(2019, 8, 5, 13, 0)
    assert fld.set_bit(7, 1234, timestamp=t)
    assert set(fld.views.keys()) == {
        "standard", "standard_2019", "standard_201908", "standard_20190805"}
    for view in fld.views.values():
        assert view.fragment(0).contains(7, 1234)


def test_field_int_values(holder):
    idx = holder.create_index("i")
    fld = idx.create_field("n", FieldOptions.int_field(min=-1000, max=1000))
    assert fld.set_value(1, 500)
    assert fld.set_value(2, -37)
    assert fld.value(1) == (500, True)
    assert fld.value(2) == (-37, True)
    assert fld.value(3) == (0, False)
    with pytest.raises(Exception):
        fld.set_value(4, 2000)  # above max
    # base offsetting: min>0 field stores value-base
    fld2 = idx.create_field("m", FieldOptions.int_field(min=100, max=200))
    fld2.set_value(1, 150)
    assert fld2.options.base == 100
    assert fld2.value(1) == (150, True)
    frag = fld2.view(fld2.bsi_view_name()).fragment(0)
    assert frag.value(1, fld2.options.bit_depth) == (50, True)  # stored adjusted


def test_field_import_values(holder):
    idx = holder.create_index("i")
    fld = idx.create_field("v", FieldOptions.int_field(min=-100, max=100))
    cols = [1, 2, SHARD_WIDTH + 5]
    vals = [10, -20, 99]
    fld.import_values(cols, vals)
    for c, v in zip(cols, vals):
        assert fld.value(c) == (v, True)


def test_field_bulk_import_multi_shard(holder, rng):
    idx = holder.create_index("i")
    fld = idx.create_field("f")
    cols = rng.integers(0, 4 * SHARD_WIDTH, 2000).astype(np.uint64)
    rows = rng.integers(0, 10, 2000).astype(np.uint64)
    fld.import_bits(rows, cols)
    assert fld.available_shards() == sorted(
        {int(c) // SHARD_WIDTH for c in cols})
    # spot-check membership
    for r, c in list(zip(rows, cols))[:20]:
        frag = fld.view().fragment(int(c) // SHARD_WIDTH)
        assert frag.contains(int(r), int(c))


def test_field_mutex_and_bool(holder):
    idx = holder.create_index("i")
    m = idx.create_field("m", FieldOptions.mutex_field())
    m.set_bit(1, 10)
    m.set_bit(2, 10)
    assert not m.view().fragment(0).contains(1, 10)
    b = idx.create_field("b", FieldOptions.bool_field())
    b.set_bool(5, True)
    b.set_bool(5, False)
    frag = b.view().fragment(0)
    assert frag.contains(0, 5) and not frag.contains(1, 5)


# -- index/holder -----------------------------------------------------------

def test_holder_reopen_preserves_schema(tmp_path):
    h = Holder(str(tmp_path / "d"), use_snapshot_queue=False).open()
    idx = h.create_index("myindex", IndexOptions(keys=False))
    idx.create_field("f1")
    idx.create_field("n1", FieldOptions.int_field(min=0, max=100))
    idx.fields["f1"].set_bit(3, 7)
    h.close()

    h2 = Holder(str(tmp_path / "d"), use_snapshot_queue=False).open()
    idx2 = h2.index("myindex")
    assert idx2 is not None
    assert set(idx2.public_fields()) == {"f1", "n1"}
    assert idx2.field("n1").options.type == "int"
    assert idx2.field("f1").view().fragment(0).contains(3, 7)
    h2.close()


def test_existence_field(holder):
    idx = holder.create_index("i")
    assert idx.existence_field() is not None
    idx.add_existence([1, 5, SHARD_WIDTH + 2])
    frag = idx.existence_field().view().fragment(0)
    assert frag.contains(0, 1) and frag.contains(0, 5)
    assert EXISTENCE_FIELD_NAME not in idx.public_fields()


def test_delete_field_and_index(holder):
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.delete_field("f")
    assert idx.field("f") is None
    assert not os.path.exists(os.path.join(idx.path, "f"))
    holder.delete_index("i")
    assert holder.index("i") is None


def test_name_validation(holder):
    with pytest.raises(Exception):
        holder.create_index("BadName")
    with pytest.raises(Exception):
        holder.create_index("1abc")
    idx = holder.create_index("good-name_1")
    with pytest.raises(Exception):
        idx.create_field("Bad")


def test_schema_apply(holder, tmp_path):
    idx = holder.create_index("i")
    idx.create_field("f", FieldOptions.time_field("YM"))
    schema = holder.schema()
    h2 = Holder(str(tmp_path / "other"), use_snapshot_queue=False).open()
    h2.apply_schema(schema)
    assert h2.index("i").field("f").options.time_quantum == "YM"
    h2.close()


# -- row --------------------------------------------------------------------

def test_row_merge_count_columns():
    r1 = Row.from_columns([1, 5, SHARD_WIDTH + 3])
    r2 = Row.from_columns([5, 2 * SHARD_WIDTH + 7])
    r1.merge(r2)
    assert r1.count() == 4
    assert list(r1.columns()) == [1, 5, SHARD_WIDTH + 3, 2 * SHARD_WIDTH + 7]
    assert r1 == Row.from_columns([1, 5, SHARD_WIDTH + 3, 2 * SHARD_WIDTH + 7])


def test_mutex_bulk_clear(tmp_path):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0,
                 mutexed=True).open()
    f.set_bit(3, 50)
    f.bulk_import([3], [50], clear=True)
    assert not f.contains(3, 50)
    # clear of an unset bit must not set it
    f.bulk_import([9], [60], clear=True)
    assert not f.contains(9, 60)
    f.close()


def test_clear_bit_on_int_field_raises(holder):
    idx = holder.create_index("i")
    fld = idx.create_field("n", FieldOptions.int_field(min=0, max=10))
    with pytest.raises(Exception):
        fld.clear_bit(0, 1)


def test_mutex_rows_vector_o1(tmp_path):
    """Single mutex set_bit must be O(1), not O(rows): after the rows
    vector is built, a write performs ZERO per-row storage scans
    (reference keeps a rowsVector for this, fragment.go:3102). Also a
    micro-benchmark: writes over many rows stay flat vs row count."""
    import time

    f = Fragment(str(tmp_path / "frag"), "i", "m", "standard", 0,
                 mutexed=True).open()
    n_rows = 300
    for r in range(n_rows):
        f.set_bit(r, r)  # one column per row -> n_rows rows exist
    f.row_for_column(0)  # build the vector

    scans = {"n": 0}
    bitmap_cls = type(f.storage)
    orig = bitmap_cls.slice_range

    def counted(self, *a, **k):
        scans["n"] += 1
        return orig(self, *a, **k)

    bitmap_cls.slice_range = counted
    try:
        # moves col 5 from row 5 to row 250: vector lookup + two bit
        # flips, no row scans
        assert f.set_bit(250, 5)
        assert f.row_for_column(5) == 250
        assert scans["n"] == 0, "mutex write scanned rows"
    finally:
        bitmap_cls.slice_range = orig

    # vector survives bulk mutex import (patched, not rebuilt) and stays
    # correct
    f.bulk_import([7, 9], [5, 6])
    assert f.row_for_column(5) == 7
    assert f.row_for_column(6) == 9
    assert not f.contains(250, 5)

    # timing smoke: 200 writes with 300 rows resident finish fast (the
    # old path probed all rows per write -> ~60k row scans)
    t0 = time.perf_counter()
    for i in range(200):
        f.set_bit(i % n_rows, 1000 + i)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2.0, f"mutex writes too slow: {elapsed:.2f}s"
    f.close()


def test_mutex_rows_vector_invalidation(tmp_path):
    """Bulk ops invalidate the vector; reads after them are correct."""
    f = Fragment(str(tmp_path / "frag"), "i", "m", "standard", 0,
                 mutexed=True).open()
    f.set_bit(1, 10)
    assert f.row_for_column(10) == 1
    # whole-row overwrite bypasses the mutex path entirely
    new = np.zeros(SHARD_WIDTH // 32, dtype=np.uint32)
    new[0] = 1 << 10
    f.set_row_plane(2, new)
    f.set_row_plane(1, np.zeros(SHARD_WIDTH // 32, dtype=np.uint32))
    assert f.row_for_column(10) == 2
    # import_roaring-style bulk positions also invalidate
    f.import_positions([f.pos(3, 11)], [])
    assert f.row_for_column(11) == 3
    f.close()


def test_mutex_rows_vector_large_row_id(tmp_path):
    """Row ids past 2^31 must not overflow the rows-vector (int64)."""
    f = Fragment(str(tmp_path / "frag"), "i", "m", "standard", 0,
                 mutexed=True).open()
    big = 1 << 31
    f.set_bit(1, 5)
    assert f.set_bit(big, 5)  # moves col 5 to the huge row
    assert f.row_for_column(5) == big
    assert not f.contains(1, 5)
    f.close()


def test_mutex_vector_lru_bounded(tmp_path, monkeypatch):
    """Resident mutex rows-vectors are LRU-bounded across fragments
    (~8 MB each): touching many mutex fragments must not pin a vector per
    fragment forever."""
    from pilosa_tpu_torch.core import fragment as fragment_mod
    from pilosa_tpu_torch.core.field import FieldOptions

    monkeypatch.setattr(fragment_mod, "_MUTEX_VECTOR_CAP", 2)
    holder = Holder(str(tmp_path / "mvec")).open()
    idx = holder.create_index("i")
    f = idx.create_field("m", FieldOptions(type="mutex"))
    frags = []
    for shard in range(4):
        col = shard * SHARD_WIDTH + 5
        f.set_bit(1, col)
        f.set_bit(2, col)  # mutex overwrite exercises the vector
        frag = f.view("standard").fragment(shard)
        assert frag.row_for_column(col) == 2
        frags.append(frag)
    resident = [fr for fr in frags if fr._mutex_vec is not None]
    assert len(resident) <= 2, [fr.shard for fr in resident]
    # evicted vectors rebuild lazily and stay correct
    assert frags[0].row_for_column(0 * SHARD_WIDTH + 5) == 2
    holder.close()
