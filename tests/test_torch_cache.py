"""The port's TopN caches (`pilosa_tpu_torch.core.cache`): the cases of
`tests/test_cache.py`: the rank and LRU caches, their persistence, and
the fragment's cache through writes, imports, reopen, recalculation and
TopN on the port's Executor (CPU)."""

import numpy as np
import pytest

from pilosa_tpu_torch.core.cache import (
    LRUCache,
    RankCache,
    load_cache,
    new_cache,
    save_cache,
)


class TestRankCache:
    def test_ordering(self):
        c = RankCache(10)
        c.add(1, 5)
        c.add(2, 9)
        c.add(3, 5)
        assert c.top() == [(2, 9), (1, 5), (3, 5)]
        assert c.ids() == [2, 1, 3]

    def test_zero_removes(self):
        c = RankCache(10)
        c.add(1, 5)
        c.add(1, 0)
        assert len(c) == 0

    def test_prune_keeps_top(self):
        c = RankCache(10)
        for i in range(30):
            c.add(i, i + 1)
        assert len(c) <= 11  # max_entries * 1.1
        top = c.top()
        assert top[0] == (29, 30)
        # the floor is enforced: tiny new entries are ignored once pruned
        c.add(100, 1)
        assert c.get(100) == 0
        # but large ones still enter
        c.add(101, 99)
        assert c.get(101) == 99

    def test_update_existing_below_threshold(self):
        c = RankCache(5)
        for i in range(10):
            c.add(i, 100 + i)
        survivor = c.ids()[0]
        c.add(survivor, 1)  # updates allowed for tracked ids
        assert c.get(survivor) == 1


class TestLRUCache:
    def test_eviction(self):
        c = LRUCache(3)
        for i in range(5):
            c.add(i, 10 + i)
        assert len(c) == 3
        assert c.get(0) == 0  # evicted
        assert c.get(4) == 14

    def test_get_refreshes(self):
        c = LRUCache(2)
        c.add(1, 1)
        c.add(2, 2)
        assert c.get(1) == 1  # refresh 1
        c.add(3, 3)           # evicts 2
        assert c.get(2) == 0
        assert c.get(1) == 1


class TestFactoryAndPersistence:
    def test_factory(self):
        assert isinstance(new_cache("ranked", 10), RankCache)
        assert isinstance(new_cache("lru", 10), LRUCache)
        assert new_cache("none") is None
        with pytest.raises(ValueError):
            new_cache("bogus")

    def test_save_load_roundtrip(self, tmp_path):
        path = str(tmp_path / "f.cache")
        c = RankCache(10)
        c.add(7, 3)
        c.add(9, 8)
        save_cache(c, path)
        c2 = RankCache(10)
        load_cache(c2, path)
        assert c2.top() == [(9, 8), (7, 3)]

    def test_save_empty_removes_file(self, tmp_path):
        path = str(tmp_path / "f.cache")
        c = RankCache(10)
        c.add(1, 1)
        save_cache(c, path)
        c.clear()
        save_cache(c, path)
        import os

        assert not os.path.exists(path)


class TestFragmentCacheIntegration:
    @pytest.fixture
    def holder(self, tmp_path):
        from pilosa_tpu_torch.core import Holder

        h = Holder(str(tmp_path / "data"))
        h.open()
        yield h
        h.close()

    def test_cache_tracks_writes(self, holder):
        from pilosa_tpu_torch.core.field import FieldOptions

        idx = holder.create_index("i")
        f = idx.create_field("f", FieldOptions(cache_type="ranked",
                                               cache_size=100))
        f.set_bit(1, 0)
        f.set_bit(1, 5)
        f.set_bit(2, 3)
        frag = f.view("standard").fragment(0)
        assert frag.cache.top() == [(1, 2), (2, 1)]
        f.clear_bit(1, 0)
        assert frag.cache.top() == [(1, 1), (2, 1)]

    def test_cache_tracks_bulk_import(self, holder):
        idx = holder.create_index("i")
        f = idx.create_field("f")
        f.import_bits(np.array([4, 4, 4, 6], dtype=np.uint64),
                      np.array([1, 2, 3, 9], dtype=np.uint64))
        frag = f.view("standard").fragment(0)
        assert frag.cache.top() == [(4, 3), (6, 1)]

    def test_cache_persists_across_reopen(self, holder):
        idx = holder.create_index("i")
        f = idx.create_field("f")
        f.set_bit(10, 1)
        f.set_bit(10, 2)
        holder.reopen()
        frag = holder.index("i").field("f").view("standard").fragment(0)
        assert frag.cache.top() == [(10, 2)]

    def test_bsi_views_have_no_cache(self, holder):
        from pilosa_tpu_torch.core.field import FieldOptions

        idx = holder.create_index("i")
        f = idx.create_field("v", FieldOptions.int_field(0, 100))
        f.set_value(3, 42)
        frag = f.view(f.bsi_view_name()).fragment(0)
        assert frag.cache is None

    def test_recalculate_caches(self, holder):
        idx = holder.create_index("i")
        f = idx.create_field("f")
        f.set_bit(1, 0)
        frag = f.view("standard").fragment(0)
        frag.cache.clear()
        holder.recalculate_caches()
        assert frag.cache.top() == [(1, 1)]

    def test_topn_uses_cache_candidates(self, holder):
        from pilosa_tpu_torch.exec.executor import Executor

        idx = holder.create_index("i")
        f = idx.create_field("f")
        for col in range(3):
            f.set_bit(5, col)
        f.set_bit(8, 0)
        idx.add_existence([0, 1, 2])
        ex = Executor(holder, device="cpu")
        pairs = ex.execute("i", "TopN(f, n=5)")[0]
        assert [(p.id, p.count) for p in pairs] == [(5, 3), (8, 1)]
        # drop a row from the cache: TopN no longer considers it
        # (the reference's cache approximation)
        frag = f.view("standard").fragment(0)
        frag.cache.invalidate(8)
        pairs = ex.execute("i", "TopN(f, n=5)")[0]
        assert [(p.id, p.count) for p in pairs] == [(5, 3)]

    def test_topn_attr_filter(self, holder):
        from pilosa_tpu_torch.exec.executor import Executor

        idx = holder.create_index("i")
        f = idx.create_field("f")
        f.set_bit(1, 0)
        f.set_bit(2, 0)
        f.row_attr_store.set_attrs(1, {"category": "a"})
        f.row_attr_store.set_attrs(2, {"category": "b"})
        ex = Executor(holder, device="cpu")
        pairs = ex.execute(
            "i", 'TopN(f, n=5, attrName="category", attrValues=["a"])')[0]
        assert [p.id for p in pairs] == [1]
