"""The port's host-side stores (`pilosa_tpu_torch.storage`): the cases
of `tests/test_storage.py`, each store case under both the `sqlite` and
the `mem` store.

Key translation (monotonic allocation, batches, read-only, replicated
entries, persistence, type checks), attribute stores (merge semantics,
bulk, value types, blocks and checksums) and keyed queries end to end
through the port's Executor on the CPU.
"""

import pytest

from pilosa_tpu_torch.storage import (
    MemAttrStore,
    MemTranslateStore,
    SqliteAttrStore,
    SqliteTranslateStore,
    TranslateReadOnlyError,
)


@pytest.fixture(params=["sqlite", "mem"])
def tstore(request, tmp_path):
    if request.param == "sqlite":
        s = SqliteTranslateStore(str(tmp_path / "keys.db"), index="i")
    else:
        s = MemTranslateStore(index="i")
    yield s
    s.close()


@pytest.fixture(params=["sqlite", "mem"])
def astore(request, tmp_path):
    if request.param == "sqlite":
        s = SqliteAttrStore(str(tmp_path / "attrs.db"))
    else:
        s = MemAttrStore()
    yield s
    s.close()


class TestTranslateStore:
    def test_monotonic_allocation(self, tstore):
        assert tstore.translate_key("foo") == 1
        assert tstore.translate_key("bar") == 2
        assert tstore.translate_key("foo") == 1
        assert tstore.max_id() == 2

    def test_batch(self, tstore):
        ids = tstore.translate_keys(["a", "b", "a", "c"])
        assert ids == [1, 2, 1, 3]
        assert tstore.translate_ids(ids) == ["a", "b", "a", "c"]
        assert tstore.translate_id(99) is None

    def test_no_create(self, tstore):
        assert tstore.translate_key("missing", create=False) is None
        assert tstore.max_id() == 0

    def test_read_only(self, tstore):
        tstore.translate_key("pre")
        tstore.set_read_only(True)
        assert tstore.translate_key("pre") == 1  # reads still fine
        with pytest.raises(TranslateReadOnlyError):
            tstore.translate_key("new")

    def test_force_set_and_entries(self, tstore):
        # replica applies replicated entries out of band
        tstore.force_set(5, "five")
        tstore.force_set(2, "two")
        assert tstore.translate_id(5) == "five"
        assert tstore.max_id() == 5
        got = [(e.id, e.key) for e in tstore.entries(0)]
        assert got == [(2, "two"), (5, "five")]
        got = [(e.id, e.key) for e in tstore.entries(2)]
        assert got == [(5, "five")]
        # future allocations never collide with replicated ids
        tstore.set_read_only(False)
        assert tstore.translate_key("six") == 6

    def test_persistence(self, tmp_path):
        path = str(tmp_path / "p.db")
        s = SqliteTranslateStore(path)
        s.translate_keys(["x", "y"])
        s.close()
        s = SqliteTranslateStore(path)
        assert s.translate_key("x") == 1
        assert s.translate_key("z") == 3
        s.close()

    def test_type_check(self, tstore):
        with pytest.raises(TypeError):
            tstore.translate_key(42)


class TestAttrStore:
    def test_merge_semantics(self, astore):
        astore.set_attrs(1, {"a": 1, "b": "x"})
        astore.set_attrs(1, {"b": "y", "c": True})
        assert astore.attrs(1) == {"a": 1, "b": "y", "c": True}
        # None deletes
        astore.set_attrs(1, {"a": None})
        assert astore.attrs(1) == {"b": "y", "c": True}
        assert astore.attrs(2) == {}

    def test_bulk(self, astore):
        astore.set_bulk_attrs({1: {"x": 1}, 250: {"y": 2.5}})
        assert astore.attrs(250) == {"y": 2.5}

    def test_value_types(self, astore):
        astore.set_attrs(3, {"s": "str", "i": 7, "f": 1.5, "b": False,
                             "l": ["a", "b"]})
        assert astore.attrs(3)["l"] == ["a", "b"]
        with pytest.raises(TypeError):
            astore.set_attrs(3, {"bad": {"nested": 1}})

    def test_blocks_and_diff(self, astore):
        astore.set_attrs(5, {"v": 1})
        astore.set_attrs(105, {"v": 2})
        blocks = dict(astore.blocks())
        assert set(blocks) == {0, 1}
        assert astore.block_data(1) == {105: {"v": 2}}
        # identical stores produce identical checksums; diverged ones don't
        other = MemAttrStore()
        other.set_attrs(5, {"v": 1})
        other.set_attrs(105, {"v": 2})
        assert dict(other.blocks()) == blocks
        other.set_attrs(105, {"v": 3})
        assert dict(other.blocks())[1] != blocks[1]

    def test_sqlite_persistence(self, tmp_path):
        path = str(tmp_path / "a.db")
        s = SqliteAttrStore(path)
        s.set_attrs(9, {"k": "v"})
        s.close()
        s = SqliteAttrStore(path)
        assert s.attrs(9) == {"k": "v"}
        s.close()


class TestKeyedQueries:
    """Keyed index/field end-to-end through the executor (reference:
    executor_test.go keyed cases + executor.go translateCall)."""

    @pytest.fixture
    def keyed(self, tmp_path):
        from pilosa_tpu_torch.core import Holder
        from pilosa_tpu_torch.core.field import FieldOptions
        from pilosa_tpu_torch.core.index import IndexOptions
        from pilosa_tpu_torch.exec.executor import Executor

        holder = Holder(str(tmp_path / "data"))
        holder.open()
        idx = holder.create_index("ki", IndexOptions(keys=True))
        idx.create_field("kf", FieldOptions(keys=True))
        idx.create_field("plain")
        yield holder, Executor(holder, device="cpu")
        holder.close()

    def test_set_and_row_by_key(self, keyed):
        holder, ex = keyed
        r = ex.execute("ki", 'Set("alpha", kf="red")')
        assert r == [True]
        r = ex.execute("ki", 'Set("beta", kf="red")')
        r = ex.execute("ki", 'Set("alpha", kf="blue")')
        out = ex.execute("ki", 'Row(kf="red")')[0]
        assert out.keys == ["alpha", "beta"]
        out = ex.execute("ki", 'Row(kf="blue")')[0]
        assert out.keys == ["alpha"]
        out = ex.execute("ki", 'Count(Row(kf="red"))')[0]
        assert out == 2

    def test_string_col_requires_keys(self, tmp_path):
        from pilosa_tpu_torch.core import Holder
        from pilosa_tpu_torch.exec.executor import Executor

        holder = Holder(str(tmp_path / "data2"))
        holder.open()
        idx = holder.create_index("plain_i")
        idx.create_field("f")
        ex = Executor(holder, device="cpu")
        with pytest.raises(Exception, match="keys"):
            ex.execute("plain_i", 'Set("alpha", f=1)')
        holder.close()

    def test_string_row_requires_field_keys(self, keyed):
        holder, ex = keyed
        with pytest.raises(Exception, match="keys"):
            ex.execute("ki", 'Set("alpha", plain="red")')

    def test_int_col_rejected_when_keyed(self, keyed):
        holder, ex = keyed
        with pytest.raises(Exception, match="string"):
            ex.execute("ki", "Set(1, kf=2)")

    def test_keyed_topn_and_rows(self, keyed):
        holder, ex = keyed
        for col in ("a", "b", "c"):
            ex.execute("ki", f'Set("{col}", kf="hot")')
        ex.execute("ki", 'Set("a", kf="cold")')
        pairs = ex.execute("ki", "TopN(kf, n=2)")[0]
        assert [(p.key, p.count) for p in pairs] == [("hot", 3), ("cold", 1)]
        rows = ex.execute("ki", "Rows(kf)")[0]
        assert rows.keys == ["hot", "cold"]
        assert rows.rows == []

    def test_keyed_groupby(self, keyed):
        holder, ex = keyed
        ex.execute("ki", 'Set("a", kf="x")')
        ex.execute("ki", 'Set("b", kf="x")')
        groups = ex.execute("ki", "GroupBy(Rows(kf))")[0]
        assert groups[0].group[0].row_key == "x"
        assert groups[0].count == 2

    def test_keyed_persistence(self, tmp_path):
        from pilosa_tpu_torch.core import Holder
        from pilosa_tpu_torch.core.field import FieldOptions
        from pilosa_tpu_torch.core.index import IndexOptions
        from pilosa_tpu_torch.exec.executor import Executor

        path = str(tmp_path / "data3")
        holder = Holder(path)
        holder.open()
        idx = holder.create_index("ki", IndexOptions(keys=True))
        idx.create_field("kf", FieldOptions(keys=True))
        Executor(holder, device="cpu").execute("ki", 'Set("alpha", kf="red")')
        holder.close()

        holder = Holder(path)
        holder.open()
        ex = Executor(holder, device="cpu")
        out = ex.execute("ki", 'Row(kf="red")')[0]
        assert out.keys == ["alpha"]
        holder.close()

    def test_keyed_store(self, keyed):
        holder, ex = keyed
        ex.execute("ki", 'Set("a", kf="red")')
        ex.execute("ki", 'Set("b", kf="red")')
        assert ex.execute("ki", 'Store(Row(kf="red"), kf="copy")') == [True]
        out = ex.execute("ki", 'Row(kf="copy")')[0]
        assert out.keys == ["a", "b"]

    def test_set_column_attrs_attr_named_like_field(self, keyed):
        # an attribute whose name matches a keyed field must NOT be
        # translated as a row key
        holder, ex = keyed
        ex.execute("ki", 'SetColumnAttrs("alpha", kf="green")')
        idx = holder.index("ki")
        col = idx.translate_store.translate_key("alpha")
        assert idx.column_attr_store.attrs(col) == {"kf": "green"}
        # and no phantom row key was allocated in kf's store
        field = idx.field("kf")
        assert field.translate_store.translate_key("green", create=False) is None

    def test_options_wrapped_keyed_result(self, keyed):
        holder, ex = keyed
        ex.execute("ki", 'Set("a", kf="red")')
        pairs = ex.execute("ki", "Options(TopN(kf, n=2))")[0]
        assert [(p.key, p.count) for p in pairs] == [("red", 1)]

    def test_keyed_row_hides_internal_ids(self, keyed):
        from pilosa_tpu_torch.server.api import result_to_json

        holder, ex = keyed
        ex.execute("ki", 'Set("a", kf="red")')
        out = ex.execute("ki", 'Row(kf="red")')[0]
        encoded = result_to_json(out)
        assert encoded["keys"] == ["a"]
        assert encoded["columns"] == []

    def test_batch_failure_leaves_no_partial_state(self, tmp_path):
        s = SqliteTranslateStore(str(tmp_path / "b.db"))
        with pytest.raises(TypeError):
            s.translate_keys(["a", 42])
        # the failed batch must not have allocated anything
        assert s.translate_key("b") == 1
        assert s.translate_key("a", create=False) is None or \
            s.translate_key("a", create=False) > 1
        s.close()

    def test_row_attrs_via_query(self, keyed):
        holder, ex = keyed
        ex.execute("ki", 'SetRowAttrs(kf, "red", weight=10)')
        field = holder.index("ki").field("kf")
        row_id = field.translate_store.translate_key("red")
        assert field.row_attr_store.attrs(row_id) == {"weight": 10}

    def test_column_attrs_via_query(self, keyed):
        holder, ex = keyed
        ex.execute("ki", 'SetColumnAttrs("alpha", name="first")')
        idx = holder.index("ki")
        col = idx.translate_store.translate_key("alpha")
        assert idx.column_attr_store.attrs(col) == {"name": "first"}
