"""The port's stacked serving paths on the CPU: the cases of
`tests/test_stacked_serving.py`.

Sum/Min/Max, GroupBy (two and three fields, with and without a filter),
BSI conditions and time ranges, stacked against the per-shard path and
against the answers computed from the same numpy draws; TopN threshold
and tanimoto; the in-place patch of one shard's planes after a write;
dispatches per query that do not grow with the shard count, counted by
`stacked_stats()["dispatches"]` and by the calls of the kernel wrappers
(on the CPU each takes its plain version, so a launch counter would
stay at 0); the pairwise tile bound; the counters.

The port sums counts in int64 and has no hi/lo split, so the overflow
case asserts the exact count past 2^31 from K1's and K3's entries. The
reference's mesh case (`test_count_overflow_over_mesh`) is held by
`tests/test_torch_sharded.py`. Tolerance: exact equality.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.core import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec.result import Pair  # noqa: E402
from pilosa_tpu_torch.server.api import API  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402


@pytest.fixture
def env(tmp_path):
    holder = Holder(str(tmp_path)).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    yield holder, api, Executor(holder, device="cpu")
    holder.close()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of every kernel wrapper the serving paths reach, at their use
    sites: K1 and K2 (ops/containers.py), K3 (exec/stacked.py,
    exec/executor.py, ops/bsi.py), K4 (exec/stacked.py), K5 (ops/bsi.py)."""
    from pilosa_tpu_torch.exec import executor as executor_mod
    from pilosa_tpu_torch.exec import stacked as stacked_mod
    from pilosa_tpu_torch.ops import bsi as bsi_mod
    from pilosa_tpu_torch.ops import containers as containers_mod

    calls = collections.Counter()
    for mod, name in ((containers_mod, "count_expr"),
                      (containers_mod, "count_expr_batch"),
                      (containers_mod, "count_blocks"),
                      (containers_mod, "count_and_blocks"),
                      (stacked_mod, "_row_counts_kernel"),
                      (stacked_mod, "_pairwise_kernel"),
                      (executor_mod, "_row_counts_kernel"),
                      (bsi_mod, "row_counts"),
                      (bsi_mod, "bsi_range_mask")):
        orig = getattr(mod, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


def _mk_set_field(api, name="f"):
    api.create_field("i", name)
    return name


# ---------------------------------------------------------------- aggregates


def test_sum_min_max_stacked_matches_per_shard(env):
    holder, api, e = env
    api.create_field("i", "v", FieldOptions.int_field(min=-500, max=500))
    rng = np.random.default_rng(11)
    cols = rng.choice(4 * SHARD_WIDTH, size=300, replace=False)
    vals = rng.integers(-500, 501, size=300)
    f = holder.index("i").field("v")
    for c, v in zip(cols.tolist(), vals.tolist()):
        f.set_value(c, v)

    got = e.execute("i", "Sum(field=v)")[0]
    assert got.val == int(vals.sum())
    assert got.count == 300
    assert e.execute("i", "Min(field=v)")[0].val == int(vals.min())
    assert e.execute("i", "Max(field=v)")[0].val == int(vals.max())
    # counts of columns achieving the extremum
    assert e.execute("i", "Min(field=v)")[0].count == \
        int((vals == vals.min()).sum())
    assert e.execute("i", "Max(field=v)")[0].count == \
        int((vals == vals.max()).sum())

    # filtered variants against a hand-computed subset
    api.create_field("i", "s")
    sel = cols[: len(cols) // 2]
    api.import_bits("i", "s", [7] * len(sel), sel.tolist())
    want = vals[: len(cols) // 2]
    got = e.execute("i", "Sum(Row(s=7), field=v)")[0]
    assert got.val == int(want.sum())
    assert got.count == len(sel)
    assert e.execute("i", "Min(Row(s=7), field=v)")[0].val == int(want.min())
    assert e.execute("i", "Max(Row(s=7), field=v)")[0].val == int(want.max())

    # per-shard fallback agrees (single-shard execution is below MIN_SHARDS)
    per_shard_sum = sum(
        e.execute("i", "Sum(field=v)", shards=[s])[0].val
        for s in range(4))
    assert per_shard_sum == int(vals.sum())


def test_groupby_stacked_matches_per_shard(env):
    holder, api, e = env
    api.create_field("i", "a")
    api.create_field("i", "b")
    rng = np.random.default_rng(13)
    n = 400
    cols = rng.choice(3 * SHARD_WIDTH, size=n, replace=False)
    rows_a = rng.integers(0, 3, size=n)
    rows_b = rng.integers(10, 13, size=n)
    api.import_bits("i", "a", rows_a.tolist(), cols.tolist())
    api.import_bits("i", "b", rows_b.tolist(), cols.tolist())

    got = e.execute("i", "GroupBy(Rows(a), Rows(b))")[0]
    want = {}
    for ra, rb in zip(rows_a.tolist(), rows_b.tolist()):
        want[(ra, rb)] = want.get((ra, rb), 0) + 1
    got_map = {
        (g.group[0].row_id, g.group[1].row_id): g.count for g in got}
    assert got_map == {k: v for k, v in want.items() if v > 0}

    # filter= goes through the stacked path too
    api.create_field("i", "flt")
    sel = cols[cols % 2 == 0]
    api.import_bits("i", "flt", [1] * len(sel), sel.tolist())
    got = e.execute("i", "GroupBy(Rows(a), Rows(b), filter=Row(flt=1))")[0]
    want = {}
    for c, ra, rb in zip(cols.tolist(), rows_a.tolist(), rows_b.tolist()):
        if c % 2 == 0:
            want[(ra, rb)] = want.get((ra, rb), 0) + 1
    got_map = {
        (g.group[0].row_id, g.group[1].row_id): g.count for g in got}
    assert got_map == {k: v for k, v in want.items() if v > 0}


# ------------------------------------------------------- threshold / tanimoto


def _tanimoto_fixture(api):
    """The reference's TestFragment_Tanimoto data
    (fragment_internal_test.go:1463): src={1,2,3}; row 100={1,2,3,200},
    row 101={1,3}, row 102={1,2,10,12}."""
    api.create_field("i", "f")
    api.create_field("i", "other")
    api.import_bits("i", "other", [9, 9, 9], [1, 2, 3])
    api.import_bits("i", "f",
                    [100, 100, 100, 100, 101, 101, 102, 102, 102, 102],
                    [1, 3, 2, 200, 1, 3, 1, 2, 10, 12])


def test_topn_tanimoto(env):
    holder, api, e = env
    _tanimoto_fixture(api)
    got = e.execute(
        "i", "TopN(f, Row(other=9), tanimotoThreshold=50)")[0]
    assert got == [Pair(100, 3), Pair(101, 2)]


def test_topn_tanimoto_zero_is_ignored(env):
    holder, api, e = env
    _tanimoto_fixture(api)
    got = e.execute(
        "i", "TopN(f, Row(other=9), tanimotoThreshold=0)")[0]
    assert got == [Pair(100, 3), Pair(101, 2), Pair(102, 2)]


def test_topn_tanimoto_out_of_range(env):
    holder, api, e = env
    _tanimoto_fixture(api)
    from pilosa_tpu_torch.exec.executor import ExecError

    with pytest.raises(ExecError, match="Tanimoto Threshold is from 1 to 100"):
        e.execute("i", "TopN(f, Row(other=9), tanimotoThreshold=101)")


def test_topn_threshold(env):
    holder, api, e = env
    api.create_field("i", "f")
    # row 1: 5 cols, row 2: 3 cols, row 3: 1 col — spread over shards
    api.import_bits(
        "i", "f",
        [1, 1, 1, 1, 1, 2, 2, 2, 3],
        [0, 1, SHARD_WIDTH, SHARD_WIDTH + 1, 2 * SHARD_WIDTH, 2, 3,
         SHARD_WIDTH + 2, 4])
    assert e.execute("i", "TopN(f, threshold=3)")[0] == \
        [Pair(1, 5), Pair(2, 3)]
    assert e.execute("i", "TopN(f, threshold=4)")[0] == [Pair(1, 5)]
    # threshold also applies to intersection counts when filtered
    api.create_field("i", "g")
    api.import_bits("i", "g", [9, 9, 9], [0, 1, 2])
    got = e.execute("i", "TopN(f, Row(g=9), threshold=2)")[0]
    assert got == [Pair(1, 2)]  # f=1 ∩ g=9 = {0,1}; f=2 ∩ = {2} dropped


def test_topn_on_int_field_errors(env):
    holder, api, e = env
    api.create_field("i", "v", FieldOptions.int_field(min=0, max=10))
    from pilosa_tpu_torch.exec.executor import ExecError

    with pytest.raises(ExecError, match="cannot compute TopN"):
        e.execute("i", "TopN(v, n=2)")


# ----------------------------------------------------- dispatch-count bound


def _build_index(tmp_path, name, n_shards):
    holder = Holder(str(tmp_path / name)).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "flt")
    rows, cols = [], []
    for s in range(n_shards):
        for r in range(6):
            rows += [r, r]
            cols += [s * SHARD_WIDTH + r, s * SHARD_WIDTH + 64 + r]
    api.import_bits("i", "f", rows, cols)
    api.import_bits("i", "flt", [1] * n_shards,
                    [s * SHARD_WIDTH for s in range(n_shards)])
    return holder, api


@pytest.mark.parametrize("query", [
    "Count(Row(f=1))",
    "TopN(f, n=3)",
    "TopN(f, Row(flt=1), n=3)",
    "GroupBy(Rows(f))",
])
def test_dispatch_count_independent_of_shards(tmp_path, query,
                                              wrapper_calls):
    """The serving guarantee: kernel dispatches per query do NOT grow with
    the shard count (the reference's per-shard mapReduce is O(shards);
    executor.go:2455), nor do the kernel wrappers' calls."""
    counts, calls = {}, {}
    for n_shards in (3, 6):
        holder, api = _build_index(tmp_path, f"d{n_shards}", n_shards)
        e = Executor(holder, device="cpu")
        e.execute("i", query)  # warm stacks
        before = e._stacked.dispatches
        wrapper_calls.clear()
        e.execute("i", query)
        counts[n_shards] = e._stacked.dispatches - before
        calls[n_shards] = dict(wrapper_calls)
        holder.close()
    assert counts[3] == counts[6], counts
    assert counts[3] > 0  # the stacked path actually ran
    assert calls[3] == calls[6] and sum(calls[3].values()) > 0, calls


def test_stacked_rows_cache_hit(tmp_path):
    """Second identical TopN must not rebuild host stacks (no row_plane
    calls): the generation-fingerprinted cache serves it entirely."""
    from pilosa_tpu_torch.core import fragment as fragment_mod

    holder, api = _build_index(tmp_path, "cache", 4)
    e = Executor(holder, device="cpu")
    e.execute("i", "TopN(f, n=3)")
    calls = {"n": 0}
    orig = fragment_mod.Fragment.row_plane

    def counted(self, row_id):
        calls["n"] += 1
        return orig(self, row_id)

    fragment_mod.Fragment.row_plane = counted
    try:
        r1 = e.execute("i", "TopN(f, n=3)")
        assert calls["n"] == 0
    finally:
        fragment_mod.Fragment.row_plane = orig
    holder.close()


def _build_bsi_index(tmp_path, name, n_shards, seed=7):
    holder = Holder(str(tmp_path / name)).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    api.create_field("i", "v", FieldOptions.int_field(min=-200, max=200))
    api.create_field("i", "f")
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(n_shards * SHARD_WIDTH, size=40 * n_shards,
                              replace=False))
    vals = rng.integers(-200, 201, size=cols.size)
    api.import_values("i", "v", cols.tolist(), vals.tolist())
    api.import_bits("i", "f", (cols % 3).tolist(), cols.tolist())
    return holder, api, cols, vals


@pytest.mark.parametrize("pql,pred", [
    ("Count(Row(v > 10))", lambda v: v > 10),
    ("Count(Row(v <= -5))", lambda v: v <= -5),
    ("Count(Row(v == 0))", lambda v: v == 0),
    ("Count(Row(v != 17))", lambda v: v != 17),
    ("Count(Row(v >< [-50, 50]))", lambda v: (v >= -50) & (v <= 50)),
])
def test_bsi_condition_count_stacked(tmp_path, pql, pred):
    """Condition trees are stacked-coverable: Count(Row(v > 10)) runs in
    O(1)-in-shards dispatches (VERDICT r4 item 4; reference algorithm
    fragment.go:1357-1470) and matches numpy."""
    holder, api, cols, vals = _build_bsi_index(
        tmp_path, f"cond{abs(hash(pql)) % 1000}", 4)
    e = Executor(holder, device="cpu")
    assert e.execute("i", pql)[0] == int(pred(vals).sum())
    holder.close()


def test_bsi_condition_dispatch_invariance(tmp_path, wrapper_calls):
    """Dispatch-invariance in the test_stacked_serving.py:201 style for a
    condition query, plus agreement with the per-shard path."""
    counts, calls = {}, {}
    for n_shards in (3, 6):
        holder, api, cols, vals = _build_bsi_index(
            tmp_path, f"cd{n_shards}", n_shards)
        e = Executor(holder, device="cpu")
        e.execute("i", "Count(Row(v > 10))")  # warm stacks
        before = e._stacked.dispatches
        wrapper_calls.clear()
        got = e.execute("i", "Count(Row(v > 10))")[0]
        counts[n_shards] = e._stacked.dispatches - before
        calls[n_shards] = dict(wrapper_calls)
        assert got == int((vals > 10).sum())
        # per-shard fallback path agrees (single shard < MIN_SHARDS)
        per_shard = sum(
            e.execute("i", "Count(Row(v > 10))", shards=[s])[0]
            for s in range(n_shards))
        assert per_shard == got
        holder.close()
    assert counts[3] == counts[6] > 0, counts
    assert calls[3] == calls[6], calls
    assert calls[3].get("bsi_range_mask", 0) > 0, calls


def test_bsi_condition_filtered_aggregates_stacked(tmp_path):
    """Condition leaves compose as filters: condition-filtered Sum/TopN/
    intersections ride the stacked path and stay exact."""
    holder, api, cols, vals = _build_bsi_index(tmp_path, "condagg", 4)
    e = Executor(holder, device="cpu")

    got = e.execute("i", "Sum(Row(v > 0), field=v)")[0]
    sel = vals > 0
    assert got.val == int(vals[sel].sum())
    assert got.count == int(sel.sum())

    got = e.execute("i", "Count(Intersect(Row(f=1), Row(v >= 100)))")[0]
    assert got == int(((cols % 3 == 1) & (vals >= 100)).sum())

    got = e.execute("i", "TopN(f, Row(v < 0), n=3)")[0]
    want = {r: int(((cols % 3 == r) & (vals < 0)).sum()) for r in range(3)}
    assert {p.id: p.count for p in got} == \
        {r: c for r, c in want.items() if c > 0}

    # a write patches the BSI stack and the next condition count is exact
    holder.index("i").field("v").set_value(2 * SHARD_WIDTH + 123, 150)
    got = e.execute("i", "Count(Row(v > 10))")[0]
    assert got == int((vals > 10).sum()) + 1
    holder.close()


def test_time_range_count_stacked(tmp_path):
    """Time-range Row trees are stacked-coverable: Count(Row(t=1,
    from=..., to=...)) unions the quantum-view cover's cached stacks in
    O(1)-in-shards dispatches and matches the per-shard path exactly."""
    holder = Holder(str(tmp_path / "trc")).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    api.create_field("i", "t", FieldOptions.time_field("YMD"))
    api.create_field("i", "flt")
    n_shards = 4
    stamps = ["2019-01-02T03:04", "2019-01-05T00:00", "2019-02-01T00:00",
              "2020-06-07T08:09"]
    cols, wire_stamps = [], []
    for s in range(n_shards):
        for k, st in enumerate(stamps):
            cols.append(s * SHARD_WIDTH + 10 + k)
            wire_stamps.append(st)
    from pilosa_tpu_torch.core.timeq import parse_time

    api.import_bits("i", "t", [1] * len(cols), cols,
                    timestamps=[parse_time(w) for w in wire_stamps])
    api.import_bits("i", "flt", [7] * (2 * n_shards), cols[::2])
    e = Executor(holder, device="cpu")

    q = "Count(Row(t=1, from=2019-01-01T00:00, to=2019-03-01T00:00))"
    want = 3 * n_shards  # Jan x2 + Feb, every shard
    assert e.execute("i", q)[0] == want
    # dispatch-invariance: warm, then count stays O(1)-in-shards
    e.execute("i", q)
    d0 = e._stacked.dispatches
    assert e.execute("i", q)[0] == want
    per_query = e._stacked.dispatches - d0
    assert 0 < per_query <= 3, per_query

    # composes with other leaves
    q2 = ("Count(Intersect(Row(flt=7), "
          "Row(t=1, from=2019-01-01T00:00, to=2019-03-01T00:00)))")
    host = {c for c, st in zip(cols, wire_stamps)
            if st.startswith("2019-0")} & set(cols[::2])
    assert e.execute("i", q2)[0] == len(host)

    # per-shard fallback agrees shard by shard
    per_shard = sum(e.execute("i", q, shards=[s])[0]
                    for s in range(n_shards))
    assert per_shard == want

    # a write into one quantum view is count-visible immediately
    api.query("i", f"Set({2 * SHARD_WIDTH + 99}, t=1, 2019-01-09T00:00)")
    assert e.execute("i", q)[0] == want + 1
    holder.close()


def test_count_patch_on_single_shard_write(tmp_path):
    """A write to ONE of many shards must NOT re-upload the whole serving
    stack: the next Count patches only the drifted shard's plane on device
    (device analog of op-log deltas over a snapshot, roaring.go:228-249)
    and stays exact."""
    n_shards = 16
    holder, api = _build_index(tmp_path, "patch", n_shards)
    e = Executor(holder, device="cpu")
    base = e.execute("i", "Count(Row(f=1))")[0]
    st = e._stacked

    # one set_bit into one shard -> next Count uploads O(1) planes
    api.query("i", f"Set({3 * SHARD_WIDTH + 500}, f=1)")
    up0, p0 = st.planes_uploaded, st.patches
    got = e.execute("i", "Count(Row(f=1))")[0]
    assert got == base + 1
    assert st.patches == p0 + 1
    assert st.planes_uploaded - up0 == 1, (st.planes_uploaded - up0)

    # clear it again: another 1-plane patch, exact result
    api.query("i", f"Clear({3 * SHARD_WIDTH + 500}, f=1)")
    up0 = st.planes_uploaded
    assert e.execute("i", "Count(Row(f=1))")[0] == base
    assert st.planes_uploaded - up0 == 1
    holder.close()


def test_sum_patch_on_single_shard_write(tmp_path):
    """BSI stacks patch incrementally too: a single set_value re-uploads
    one shard's D+2 planes, not depth x shards."""
    holder = Holder(str(tmp_path / "bsipatch")).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    api.create_field("i", "v", FieldOptions.int_field(min=0, max=1000))
    n_shards = 8
    cols = [s * SHARD_WIDTH + 3 for s in range(n_shards)]
    vals = [10 * (s + 1) for s in range(n_shards)]
    api.import_values("i", "v", cols, vals)
    e = Executor(holder, device="cpu")
    assert e.execute("i", "Sum(field=v)")[0].val == sum(vals)
    st = e._stacked

    holder.index("i").field("v").set_value(5 * SHARD_WIDTH + 9, 7)
    up0, p0 = st.planes_uploaded, st.patches
    got = e.execute("i", "Sum(field=v)")[0]
    assert got.val == sum(vals) + 7
    assert got.count == n_shards + 1
    assert st.patches == p0 + 1
    depth = holder.index("i").field("v").options.bit_depth
    # one shard's exists+sign+magnitude planes only
    assert st.planes_uploaded - up0 == depth + 2
    holder.close()


def test_topn_rows_stack_patch_on_write(tmp_path):
    """TopN candidate chunks patch per-shard as well: a one-bit write
    costs rows x 1 plane uploads, not rows x shards."""
    n_shards = 12
    holder, api = _build_index(tmp_path, "rowspatch", n_shards)
    e = Executor(holder, device="cpu")
    r1 = e.execute("i", "TopN(f, n=6)")[0]
    st = e._stacked

    api.query("i", f"Set({7 * SHARD_WIDTH + 900}, f=2)")
    up0, p0 = st.planes_uploaded, st.patches
    r2 = e.execute("i", "TopN(f, n=6)")[0]
    assert st.patches == p0 + 1
    # 6 candidate rows, 1 drifted shard
    assert st.planes_uploaded - up0 == 6
    want = {p.id: p.count for p in r1}
    want[2] += 1
    assert {p.id: p.count for p in r2} == want
    holder.close()


# ---------------------------------------------------- pairwise GroupBy fused


def _build_groupby_index(tmp_path, name, n_shards=3, n=420, seed=17):
    holder = Holder(str(tmp_path / name)).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    for fname in ("ga", "gb", "gc", "flt"):
        api.create_field("i", fname)
    rng = np.random.default_rng(seed)
    cols = rng.choice(n_shards * SHARD_WIDTH, size=n, replace=False)
    ra = rng.integers(0, 5, size=n)
    rb = rng.integers(10, 14, size=n)
    rc = rng.integers(0, 3, size=n)
    api.import_bits("i", "ga", ra.tolist(), cols.tolist())
    api.import_bits("i", "gb", rb.tolist(), cols.tolist())
    api.import_bits("i", "gc", rc.tolist(), cols.tolist())
    sel = cols[cols % 2 == 0]
    api.import_bits("i", "flt", [1] * len(sel), sel.tolist())
    return holder, api, cols, ra, rb, rc


@pytest.mark.parametrize("with_filter", [False, True])
def test_groupby_three_fields_pairwise_matches_per_shard(
        tmp_path, with_filter):
    """>2 GroupBy fields: outer levels recurse over [S, W] planes, the
    innermost TWO ride the fused pairwise kernel. Must agree exactly with
    the untouched per-shard fallback AND the host ground truth, with and
    without a filter."""
    from pilosa_tpu_torch.pql import parse

    holder, api, cols, ra, rb, rc = _build_groupby_index(
        tmp_path, f"g3{int(with_filter)}")
    e = Executor(holder, device="cpu")
    idx = holder.index("i")
    fields = [idx.field(f) for f in ("gc", "ga", "gb")]
    child_rows = [sorted(set(rc.tolist())), sorted(set(ra.tolist())),
                  sorted(set(rb.tolist()))]
    filter_call = parse("Row(flt=1)").calls[0] if with_filter else None
    shard_list = sorted(idx.available_shards())

    pd0 = e._stacked.pairwise_dispatches
    stacked = e._group_by_stacked(
        idx, fields, child_rows, filter_call, shard_list)
    assert stacked is not None
    assert e._stacked.pairwise_dispatches > pd0  # pairwise kernel ran
    per_shard = e._group_by_per_shard(
        idx, fields, child_rows, filter_call, shard_list)
    assert stacked == per_shard

    want = {}
    for c, x, y, z in zip(cols.tolist(), rc.tolist(), ra.tolist(),
                          rb.tolist()):
        if with_filter and c % 2 != 0:
            continue
        want[(x, y, z)] = want.get((x, y, z), 0) + 1
    assert stacked == want
    holder.close()


def test_groupby_pairwise_dispatch_tile_bound(tmp_path, monkeypatch):
    """Acceptance: pairwise dispatches AND host syncs per GroupBy are
    O(⌈R1/tile⌉·⌈R2/tile⌉), NOT O(R1·R2) — force tile < R by shrinking
    the chunk budget, then count both on the serving cache."""
    import math

    import pilosa_tpu_torch.exec.stacked as stacked_mod

    holder, api, cols, ra, rb, rc = _build_groupby_index(tmp_path, "tile")
    e = Executor(holder, device="cpu")
    idx = holder.index("i")
    st = e._stacked
    shards = tuple(sorted(idx.available_shards()))
    row_bytes = st._padded_len(shards) * WORDS_PER_ROW * 4
    monkeypatch.setattr(stacked_mod, "CHUNK_BYTES", 2 * row_bytes)
    tile = st.row_chunk_size(shards)
    assert tile == 2

    r1 = len(set(ra.tolist()))
    r2 = len(set(rb.tolist()))
    assert tile < min(r1, r2)
    e.execute("i", "GroupBy(Rows(ga), Rows(gb))")  # warm stacks + compiles
    d0, s0 = st.pairwise_dispatches, st.pairwise_syncs
    got = e.execute("i", "GroupBy(Rows(ga), Rows(gb))")[0]
    want_pairs = math.ceil(r1 / tile) * math.ceil(r2 / tile)
    assert st.pairwise_dispatches - d0 == want_pairs
    assert st.pairwise_syncs - s0 == want_pairs
    assert want_pairs < r1 * r2  # strictly better than one trip per pair

    # the tiled result is still exact
    want = {}
    for x, y in zip(ra.tolist(), rb.tolist()):
        want[(x, y)] = want.get((x, y), 0) + 1
    got_map = {
        (g.group[0].row_id, g.group[1].row_id): g.count for g in got}
    assert got_map == want
    holder.close()


def test_groupby_pairwise_counters_exported(tmp_path):
    holder, api, cols, ra, rb, rc = _build_groupby_index(tmp_path, "ctr")
    e = Executor(holder, device="cpu")
    e.execute("i", "GroupBy(Rows(ga), Rows(gb))")
    stats = e.stacked_stats()
    assert stats["pairwise_dispatches"] >= 1
    assert stats["pairwise_syncs"] >= 1
    holder.close()


# ------------------------------------------------------------ int32 overflow


def test_count_overflow_past_2048_shards():
    """Counts past 2^31 must not wrap: 2056 all-ones shards counted by
    K1's entry (a 2-leaf & tree) and by K3's (one row) give the exact
    int64 total."""
    from pilosa_tpu_torch.ops.count_expr import count_expr
    from pilosa_tpu_torch.ops.row_counts import row_counts

    S = 2056  # > 2048; all-ones planes -> 2056 * 2^20 bits > 2^31
    want = S * SHARD_WIDTH
    assert want > 2**31
    prev = torch.get_num_threads()
    torch.set_num_threads(4)  # 2^26 words per plain count
    try:
        ones = torch.full((S, WORDS_PER_ROW), -1, dtype=torch.int32)
        got = count_expr(("&", [("leaf", 0), ("leaf", 1)]), [ones, ones])
        assert got.dtype == torch.int64 and int(got) == want
        got = row_counts(ones.reshape(1, -1))
        assert got.dtype == torch.int64 and got.tolist() == [want]
    finally:
        torch.set_num_threads(prev)


def test_cache_stats_exported(tmp_path):
    holder, api = _build_index(tmp_path, "stats", 4)
    e = Executor(holder, device="cpu")
    e.execute("i", "Count(Row(f=1))")
    e.execute("i", "Count(Row(f=1))")
    stats = e.stacked_stats()
    assert stats["misses"] >= 1     # first build
    assert stats["hits"] >= 1       # second query served from cache
    assert stats["bytes"] > 0
    assert stats["dispatches"] >= 2
    holder.close()


def test_debug_vars_includes_stacked(tmp_path):
    from pilosa_tpu_torch.server.http_server import PilosaHTTPServer

    holder, api = _build_index(tmp_path, "dv", 3)
    import json
    import urllib.request

    srv = PilosaHTTPServer(api, host="127.0.0.1", port=0)
    srv.start()
    try:
        api.query("i", "Count(Row(f=1))")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/debug/vars") as r:
            body = json.loads(r.read())
        assert "stacked" in body
        assert body["stacked"]["dispatches"] >= 1
    finally:
        srv.stop()
        holder.close()
