"""The port's Executor on the CPU: the 37 golden call cases of
`tests/test_executor.py` against the same literals, errors included.

Every PQL call on one node over several shards: Set/Clear/ClearRow/
Store, the bitmap calls and Not over the existence field, Shift, BSI
values and conditions (negatives, BETWEEN, clamped out-of-range
predicates), TopN, Rows (time ranges too), GroupBy (filter, limit,
offset, the `previous` cursor and its validation), MinRow/MaxRow,
Options, mutex and bool fields, the write limit per request, Clear
across quantum views and row attributes. The paginated GroupBy is held
to the JAX package's answer on a copy of the same data directory as
well. Tolerance: exact equality.
"""

import numpy as np
import pytest

from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.exec import (
    ExecError,
    Executor,
    FieldRow,
    GroupCount,
    Pair,
    RowIdentifiers,
    ValCount,
)
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture
def env(tmp_path):
    h = Holder(str(tmp_path / "data"), use_snapshot_queue=False).open()
    yield h, Executor(h, device="cpu")
    h.close()


def cols(result):
    return list(int(c) for c in result.columns())


def same_as_jax(holder, tmp_path_factory, index, queries):
    """The JAX package, on a copy of `holder`'s data directory, answers
    each query as the port does (both results as the HTTP JSON)."""
    import shutil

    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.exec import Executor as JaxExecutor
    from pilosa_tpu.server.api import result_to_json as jax_to_json
    from pilosa_tpu_torch.server.api import result_to_json

    copy = str(tmp_path_factory.mktemp("jax") / "data")
    shutil.copytree(holder.path, copy)
    jh = JaxHolder(copy, use_snapshot_queue=False).open()
    try:
        ex, jex = Executor(holder, device="cpu"), JaxExecutor(jh)
        for q in queries:
            got = [result_to_json(r) for r in ex.execute(index, q)]
            want = [jax_to_json(r) for r in jex.execute(index, q)]
            assert got == want, q
    finally:
        jh.close()


def test_set_and_row(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(0, f=10)")
    r = e.execute("i", "Set(1, f=10) Set(100, f=10) Set(3, f=11)")
    assert r == [True, True, True]
    assert e.execute("i", "Set(1, f=10)") == [False]  # no change
    assert cols(e.execute("i", "Row(f=10)")[0]) == [0, 1, 100]
    assert cols(e.execute("i", "Row(f=11)")[0]) == [3]
    assert cols(e.execute("i", "Row(f=99)")[0]) == []


def test_missing_field_errors(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(0, f=1)")  # make a shard exist
    # reference requires the field to exist (ErrFieldNotFound)
    with pytest.raises(Exception):
        e.execute("i", "Row(nonexistent=1)")
    with pytest.raises(Exception):
        e.execute("i", "Set(0, nonexistent=1)")


def test_multi_shard_row(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    columns = [1, SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 5, 5]
    f.import_bits([7] * len(columns), columns)
    assert cols(e.execute("i", "Row(f=7)")[0]) == sorted(columns)
    assert e.execute("i", "Count(Row(f=7))")[0] == 4


def test_intersect_union_difference_xor(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    a = [1, 2, 3, SHARD_WIDTH + 1]
    b = [2, 3, 4, 2 * SHARD_WIDTH + 9]
    f.import_bits([1] * len(a) + [2] * len(b), a + b)
    assert cols(e.execute("i", "Intersect(Row(f=1), Row(f=2))")[0]) == [2, 3]
    assert cols(e.execute("i", "Union(Row(f=1), Row(f=2))")[0]) == sorted(set(a) | set(b))
    assert cols(e.execute("i", "Difference(Row(f=1), Row(f=2))")[0]) == [1, SHARD_WIDTH + 1]
    assert cols(e.execute("i", "Xor(Row(f=1), Row(f=2))")[0]) == sorted(
        set(a) ^ set(b))
    assert e.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))")[0] == 2


def test_not_with_existence(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(1, f=10) Set(2, f=10) Set(3, f=11)")
    # universe is {1,2,3} via _exists
    assert cols(e.execute("i", "Not(Row(f=10))")[0]) == [3]
    assert cols(e.execute("i", "Not(Row(f=99))")[0]) == [1, 2, 3]
    assert cols(e.execute("i", "Not(Union(Row(f=10), Row(f=11)))")[0]) == []


def test_all(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(9, f=1) Set(70, f=2)")
    assert cols(e.execute("i", "All()")[0]) == [9, 70]


def test_shift(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(1, f=10) Set(5, f=10)")
    assert cols(e.execute("i", "Shift(Row(f=10), n=2)")[0]) == [3, 7]
    assert cols(e.execute("i", "Shift(Row(f=10))")[0]) == [2, 6]


def test_clear_and_clearrow(env):
    h, e = env
    h.create_index("i").create_field("f")
    e.execute("i", "Set(1, f=10) Set(2, f=10)")
    assert e.execute("i", "Clear(1, f=10)") == [True]
    assert e.execute("i", "Clear(1, f=10)") == [False]
    assert cols(e.execute("i", "Row(f=10)")[0]) == [2]
    assert e.execute("i", "ClearRow(f=10)") == [True]
    assert cols(e.execute("i", "Row(f=10)")[0]) == []


def test_store(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("f")
    e.execute("i", "Set(1, f=10) Set(9, f=10) Set(9, f=11)")
    e.execute("i", "Store(Intersect(Row(f=10), Row(f=11)), g=1)")
    assert cols(e.execute("i", "Row(g=1)")[0]) == [9]
    # store overwrites
    e.execute("i", "Store(Row(f=10), g=1)")
    assert cols(e.execute("i", "Row(g=1)")[0]) == [1, 9]


def test_count_multiple_calls(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("f")
    e.execute("i", "Set(1, f=10) Set(2, f=10)")
    assert e.execute("i", "Count(Row(f=10)) Count(Row(f=11))") == [2, 0]


def test_bsi_set_sum_minmax(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("n", FieldOptions.int_field(min=-1000, max=1000))
    e.execute("i", "Set(1, n=100) Set(2, n=-300) Set(3, n=42)")
    assert e.execute("i", "Sum(field=n)")[0] == ValCount(-158, 3)
    assert e.execute("i", "Min(field=n)")[0] == ValCount(-300, 1)
    assert e.execute("i", "Max(field=n)")[0] == ValCount(100, 1)
    # with filter
    idx.create_field("f")
    e.execute("i", "Set(1, f=7) Set(3, f=7)")
    assert e.execute("i", "Sum(Row(f=7), field=n)")[0] == ValCount(142, 2)
    assert e.execute("i", "Min(Row(f=7), field=n)")[0] == ValCount(42, 1)
    assert e.execute("i", "Max(Row(f=7), field=n)")[0] == ValCount(100, 1)


def test_bsi_row_conditions(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("n", FieldOptions.int_field(min=-1000, max=1000))
    values = {1: 100, 2: -300, 3: 42, 4: 0, SHARD_WIDTH + 1: 100}
    for c, v in values.items():
        e.execute("i", f"Set({c}, n={v})")

    def check(q, want):
        assert cols(e.execute("i", q)[0]) == sorted(want), q

    check("Row(n == 100)", [c for c, v in values.items() if v == 100])
    check("Row(n != 100)", [c for c, v in values.items() if v != 100])
    check("Row(n < 42)", [c for c, v in values.items() if v < 42])
    check("Row(n <= 42)", [c for c, v in values.items() if v <= 42])
    check("Row(n > 0)", [c for c, v in values.items() if v > 0])
    check("Row(n >= 0)", [c for c, v in values.items() if v >= 0])
    check("Row(n > -301)", list(values))
    check("Row(n < -500)", [])
    check("Row(0 < n < 101)", [c for c, v in values.items() if 0 < v < 101])
    check("Row(n >< [-300, 42])", [c for c, v in values.items() if -300 <= v <= 42])
    check("Row(n != null)", list(values))
    # out-of-depth-range predicates clamp, not truncate
    check("Row(n > 100000)", [])
    check("Row(n < 100000)", list(values))
    check("Row(n == 100000)", [])
    check("Row(n != 100000)", list(values))


def test_bsi_negative_between(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("n", FieldOptions.int_field(min=-100, max=100))
    vals = {1: -50, 2: -10, 3: 0, 4: 10, 5: 50}
    for c, v in vals.items():
        e.execute("i", f"Set({c}, n={v})")
    assert cols(e.execute("i", "Row(n >< [-20, 20])")[0]) == [2, 3, 4]
    assert cols(e.execute("i", "Row(n >< [-60, -10])")[0]) == [1, 2]
    assert cols(e.execute("i", "Row(n >< [10, 60])")[0]) == [4, 5]


def test_topn(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    # row 1: 4 cols, row 2: 2 cols, row 3: 1 col (across shards)
    f.import_bits(
        [1, 1, 1, 1, 2, 2, 3],
        [0, 1, SHARD_WIDTH, SHARD_WIDTH + 1, 2, 3, 4])
    assert e.execute("i", "TopN(f, n=2)")[0] == [Pair(1, 4), Pair(2, 2)]
    assert e.execute("i", "TopN(f)")[0] == [Pair(1, 4), Pair(2, 2), Pair(3, 1)]
    # with filter: restrict to columns {0, 2}
    idx.create_field("g")
    e.execute("i", "Set(0, g=9) Set(2, g=9)")
    assert e.execute("i", "TopN(f, Row(g=9), n=5)")[0] == [
        Pair(1, 1), Pair(2, 1)]
    # ids form: zero-count ids are omitted (reference: fragment.top skips
    # empty rows)
    assert e.execute("i", "TopN(f, ids=[2, 3, 9])")[0] == [
        Pair(2, 2), Pair(3, 1)]


def test_rows(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.import_bits([1, 5, 9], [0, SHARD_WIDTH, 7])
    assert e.execute("i", "Rows(f)")[0] == RowIdentifiers([1, 5, 9])
    assert e.execute("i", "Rows(f, previous=1)")[0] == RowIdentifiers([5, 9])
    assert e.execute("i", "Rows(f, limit=2)")[0] == RowIdentifiers([1, 5])
    assert e.execute("i", "Rows(f, column=7)")[0] == RowIdentifiers([9])
    assert e.execute("i", f"Rows(f, column={SHARD_WIDTH})")[0] == RowIdentifiers([5])


def test_group_by(env):
    h, e = env
    idx = h.create_index("i")
    a = idx.create_field("a")
    b = idx.create_field("b")
    # a: row0={0,1,2}, row1={1,2}; b: row10={0,1}, row11={2, SW+1}
    a.import_bits([0, 0, 0, 1, 1], [0, 1, 2, 1, 2])
    b.import_bits([10, 10, 11, 11], [0, 1, 2, SHARD_WIDTH + 1])
    got = e.execute("i", "GroupBy(Rows(a), Rows(b))")[0]
    assert got == [
        GroupCount([FieldRow("a", 0), FieldRow("b", 10)], 2),
        GroupCount([FieldRow("a", 0), FieldRow("b", 11)], 1),
        GroupCount([FieldRow("a", 1), FieldRow("b", 10)], 1),
        GroupCount([FieldRow("a", 1), FieldRow("b", 11)], 1),
    ]
    got = e.execute("i", "GroupBy(Rows(a), Rows(b), filter=Row(a=1))")[0]
    assert got == [
        GroupCount([FieldRow("a", 0), FieldRow("b", 10)], 1),
        GroupCount([FieldRow("a", 0), FieldRow("b", 11)], 1),
        GroupCount([FieldRow("a", 1), FieldRow("b", 10)], 1),
        GroupCount([FieldRow("a", 1), FieldRow("b", 11)], 1),
    ]
    got = e.execute("i", "GroupBy(Rows(a), limit=1)")[0]
    assert got == [GroupCount([FieldRow("a", 0)], 3)]


def test_minrow_maxrow(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.import_bits([3, 3, 7, 9], [0, 1, 2, SHARD_WIDTH + 4])
    assert e.execute("i", "MinRow(field=f)")[0] == Pair(3, 2)
    assert e.execute("i", "MaxRow(field=f)")[0] == Pair(9, 1)


def test_time_range_row(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("t", FieldOptions.time_field("YMD"))
    e.execute("i", 'Set(1, t=10, 2019-01-05T00:00)')
    e.execute("i", 'Set(2, t=10, 2019-02-10T00:00)')
    e.execute("i", 'Set(3, t=10, 2020-06-01T00:00)')
    # standard view has everything
    assert cols(e.execute("i", "Row(t=10)")[0]) == [1, 2, 3]
    r = e.execute(
        "i", "Row(t=10, from=2019-01-01T00:00, to=2019-03-01T00:00)")[0]
    assert cols(r) == [1, 2]
    r = e.execute(
        "i", "Row(t=10, from=2019-02-01T00:00, to=2021-01-01T00:00)")[0]
    assert cols(r) == [2, 3]


def test_options_shards(env):
    h, e = env
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.import_bits([1, 1, 1], [0, SHARD_WIDTH, 2 * SHARD_WIDTH])
    r = e.execute("i", "Options(Row(f=1), shards=[0, 2])")[0]
    assert cols(r) == [0, 2 * SHARD_WIDTH]


def test_mutex_field_query(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("m", FieldOptions.mutex_field())
    e.execute("i", "Set(1, m=10) Set(1, m=11)")
    assert cols(e.execute("i", "Row(m=10)")[0]) == []
    assert cols(e.execute("i", "Row(m=11)")[0]) == [1]


def test_bool_field_query(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("b", FieldOptions.bool_field())
    e.execute("i", "Set(1, b=true) Set(2, b=false) Set(3, b=true)")
    assert cols(e.execute("i", "Row(b=true)")[0]) == [1, 3]
    assert cols(e.execute("i", "Row(b=false)")[0]) == [2]
    e.execute("i", "Set(1, b=false)")
    assert cols(e.execute("i", "Row(b=true)")[0]) == [3]


def test_errors(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("f")
    with pytest.raises(ExecError):
        e.execute("i", "Intersect()")
    with pytest.raises(ExecError):
        e.execute("i", "Count(Row(f=1)) Count()")
    with pytest.raises(Exception):
        e.execute("badindex", "Row(f=1)")
    with pytest.raises(ExecError):
        e.execute("i", "Badcall(Row(f=1))")


def test_sum_on_empty_field(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("n", FieldOptions.int_field(min=0, max=10))
    assert e.execute("i", "Sum(field=n)")[0] == ValCount(0, 0)
    assert e.execute("i", "Min(field=n)")[0] == ValCount(0, 0)
    assert e.execute("i", "Max(field=n)")[0] == ValCount(0, 0)


def test_sum_filter_empty_in_some_shard(env):
    # regression: filter field absent in shard 1 must contribute nothing
    h, e = env
    idx = h.create_index("i")
    idx.create_field("n", FieldOptions.int_field(min=0, max=1000))
    idx.create_field("f")
    e.execute("i", f"Set(1, n=100) Set({SHARD_WIDTH + 1}, n=50)")
    e.execute("i", "Set(1, f=7)")  # filter only touches shard 0
    assert e.execute("i", "Sum(Row(f=7), field=n)")[0] == ValCount(100, 1)
    assert e.execute("i", "Max(Row(f=7), field=n)")[0] == ValCount(100, 1)
    assert e.execute("i", "Min(Row(f=7), field=n)")[0] == ValCount(100, 1)


def test_clearrow_clears_time_views(env):
    h, e = env
    idx = h.create_index("i")
    idx.create_field("t", FieldOptions.time_field("YMD"))
    e.execute("i", "Set(1, t=10, 2019-01-05T00:00)")
    assert e.execute("i", "ClearRow(t=10)") == [True]
    r = e.execute(
        "i", "Row(t=10, from=2019-01-01T00:00, to=2019-02-01T00:00)")[0]
    assert cols(r) == []


def test_bsi_condition_on_missing_field_raises(env):
    h, e = env
    h.create_index("i")
    with pytest.raises(Exception):
        e.execute("i", "Row(typo > 5)")


def test_count_on_missing_field_empty_index(env):
    # regression: aggregates validate subqueries even with zero shards
    h, e = env
    h.create_index("i")
    with pytest.raises(Exception):
        e.execute("i", "Count(Row(nonexistent=1))")
    with pytest.raises(Exception):
        e.execute("i", "TopN(nonexistent)")


def test_group_by_limit_applies_globally(env):
    # regression: child Rows() limit is global, not per shard
    h, e = env
    idx = h.create_index("i")
    a = idx.create_field("a")
    a.import_bits([1, 2, 2], [0, 1, SHARD_WIDTH + 1])
    got = e.execute("i", "GroupBy(Rows(a, limit=1))")[0]
    assert got == [GroupCount([FieldRow("a", 1)], 1)]
    got = e.execute("i", "GroupBy(Rows(a))")[0]
    assert got == [GroupCount([FieldRow("a", 1)], 1),
                   GroupCount([FieldRow("a", 2)], 2)]


def test_rows_time_range(env):
    """Rows() on a time field with from/to walks quantum views, clamped to
    existing views (reference: executeRowsShard executor.go:1338-1400)."""
    from pilosa_tpu_torch.core import timeq

    holder, e = env
    idx = holder.create_index("i")
    idx.create_field("t", FieldOptions.time_field("YMD"))
    f = idx.field("t")
    f.set_bit(1, 10, timestamp=timeq.parse_time("2019-01-15T00:00"))
    f.set_bit(2, 11, timestamp=timeq.parse_time("2019-02-10T00:00"))
    f.set_bit(3, 12, timestamp=timeq.parse_time("2019-03-05T00:00"))
    idx.add_existence([10, 11, 12])

    # full range (no args): standard view -> all rows
    assert e.execute("i", "Rows(t)")[0].rows == [1, 2, 3]
    # Jan..Feb only
    got = e.execute(
        "i", 'Rows(t, from="2019-01-01T00:00", to="2019-03-01T00:00")')[0]
    assert got.rows == [1, 2]
    # open-ended from: clamps to earliest existing view
    got = e.execute("i", 'Rows(t, to="2019-02-01T00:00")')[0]
    assert got.rows == [1]
    # open-ended to: clamps to latest existing view
    got = e.execute("i", 'Rows(t, from="2019-02-01T00:00")')[0]
    assert got.rows == [2, 3]
    # out-of-range window -> empty
    got = e.execute(
        "i", 'Rows(t, from="2020-01-01T00:00", to="2020-02-01T00:00")')[0]
    assert got.rows == []


def test_rows_time_no_standard_view(env):
    from pilosa_tpu_torch.core import timeq  # noqa: F401

    holder, e = env
    idx = holder.create_index("i")
    idx.create_field(
        "tn", FieldOptions.time_field("YM", no_standard_view=True))
    f = idx.field("tn")
    f.set_bit(7, 3, timestamp=timeq.parse_time("2019-05-01T00:00"))
    # no standard view: Rows() must still answer via the time views
    assert e.execute("i", "Rows(tn)")[0].rows == [7]


def test_group_by_offset(env):
    """(reference: executeGroupBy offset executor.go:1134)"""
    h, e = env
    idx = h.create_index("i")
    idx.create_field("g")
    f = idx.field("g")
    f.import_bits([0, 1, 2, 3], [0, 1, 2, 3])
    all_groups = e.execute("i", "GroupBy(Rows(g))")[0]
    assert len(all_groups) == 4
    got = e.execute("i", "GroupBy(Rows(g), offset=2)")[0]
    assert got == all_groups[2:]
    got = e.execute("i", "GroupBy(Rows(g), limit=3, offset=1)")[0]
    assert got == all_groups[:3][1:]
    # offset past the end is a NO-OP, not empty (reference guards
    # offset < len(results))
    got = e.execute("i", "GroupBy(Rows(g), offset=10)")[0]
    assert got == all_groups


def test_group_by_previous_validation(env):
    """`previous` is a per-field list cursor; malformed cursors error like
    the reference (executor.go:2737-2745) instead of serving a wrong
    page."""
    h, e = env
    idx = h.create_index("i")
    idx.create_field("a").import_bits([1, 2], [0, 1])
    idx.create_field("b").import_bits([1, 2], [0, 1])
    cases = [
        # the key-translation pass rejects shape errors first
        # (reference: translateGroupByCall executor.go:2718)...
        ("GroupBy(Rows(a), Rows(b), previous=3)",
         "'previous' argument must be a list"),
        ("GroupBy(Rows(a), Rows(b), previous=[1])",
         "mismatched lengths for previous"),
        ("GroupBy(Rows(a), Rows(b), previous=[1, 2, 3])",
         "mismatched lengths for previous"),
        # ...value errors surface from the executor's own validation
        ("GroupBy(Rows(a), Rows(b), previous=[1, -2])",
         "must be positive, but got"),
    ]
    for pql, msg in cases:
        with pytest.raises(Exception, match=msg):
            e.execute("i", pql)

    # the executor validates independently of the translate pass (the spmd
    # data plane calls it directly, before any collective round)
    from pilosa_tpu_torch.exec.executor import groupby_previous
    from pilosa_tpu_torch.pql import Call

    for args, msg in [
            ({"previous": 3}, "must be a list of row ids"),
            ({"previous": [1]}, "must have a value for each"),
            ({"previous": [1, True]}, "could not convert"),
            ({"previous": [1, "x"]}, "could not convert"),
            ({"previous": [1, -2]}, "must be positive, but got"),
    ]:
        with pytest.raises(ExecError, match=msg):
            groupby_previous(Call("GroupBy", args=args), 2)
    assert groupby_previous(Call("GroupBy", args={}), 2) is None
    assert groupby_previous(
        Call("GroupBy", args={"previous": [4, 7]}), 2) == [4, 7]


def test_group_by_previous_pagination_golden(env, tmp_path_factory):
    """Paginate a 2-field GroupBy to completion with limit + previous=[last
    group]: the concatenated pages ARE the full result — no duplicate, no
    gap (reference: executeGroupBy previous seeding executor.go:1403)."""
    h, e = env
    idx = h.create_index("i")
    rng = np.random.default_rng(5)
    n = 300
    cc = rng.choice(2 * SHARD_WIDTH, size=n, replace=False)
    ra = rng.integers(0, 4, size=n)
    rb = rng.integers(0, 5, size=n)
    idx.create_field("a").import_bits(ra.tolist(), cc.tolist())
    idx.create_field("b").import_bits(rb.tolist(), cc.tolist())

    full = e.execute("i", "GroupBy(Rows(a), Rows(b))")[0]
    assert len(full) > 6
    pages, prev = [], None
    for _ in range(len(full) + 2):  # bounded: must terminate
        pql = "GroupBy(Rows(a), Rows(b), limit=3{})".format(
            "" if prev is None else f", previous=[{prev[0]}, {prev[1]}]")
        page = e.execute("i", pql)[0]
        if not page:
            break
        assert len(page) <= 3
        pages.extend(page)
        prev = (page[-1].group[0].row_id, page[-1].group[1].row_id)
    assert pages == full

    # single-field pagination: previous=[row] resumes strictly after it
    full1 = e.execute("i", "GroupBy(Rows(a))")[0]
    pages, prev = [], None
    for _ in range(len(full1) + 2):
        pql = "GroupBy(Rows(a), limit=2{})".format(
            "" if prev is None else f", previous=[{prev}]")
        page = e.execute("i", pql)[0]
        if not page:
            break
        pages.extend(page)
        prev = page[-1].group[0].row_id
    assert pages == full1

    g = full[len(full) // 2].group
    same_as_jax(h, tmp_path_factory, "i", [
        "GroupBy(Rows(a), Rows(b))", "GroupBy(Rows(a))",
        f"GroupBy(Rows(a), Rows(b), limit=3, "
        f"previous=[{g[0].row_id}, {g[1].row_id}])"])


# -------- argument validation parity (reference: executor_test.go
# TestExecutor_Execute_Query_Error + Call.UintArg pql/ast.go:315,
# TestExecutor_Execute_ErrMaxWritesPerRequest executor_test.go:2514)


def test_negative_uint_args_rejected(env):
    """Negative limit/offset/n/previous error like the reference instead
    of silently serving an empty result."""
    h, e = env
    h.create_index("i").create_field("general")
    cases = [
        "Rows(general, limit=-1)",
        "Rows(general, previous=-2)",
        "Rows(general, column=-1)",
        "TopN(general, n=-1)",
        "TopN(general, threshold=-1)",
        "GroupBy(Rows(general), limit=-1)",
        "GroupBy(Rows(general), offset=-1)",
        "GroupBy(Rows(general, limit=-1))",
    ]
    for q in cases:
        with pytest.raises(Exception, match="must be positive, but got"):
            e.execute("i", q)
    # GroupBy(Rows()) still parses-or-errors, never silently succeeds
    with pytest.raises(Exception):
        e.execute("i", "GroupBy(Rows())")


def test_max_writes_per_request(tmp_path):
    """(reference: ErrTooManyWrites — 'too many write commands')"""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server.api import API, ApiError

    holder = Holder(str(tmp_path / "mw")).open()
    api = API(holder, device="cpu", max_writes_per_request=3)
    api.create_index("i")
    api.create_field("i", "f")
    # 3 writes pass
    assert api.query("i", "Set(1, f=1) Set(2, f=1) Clear(3, f=1)")
    # 4 writes rejected, nothing about reads
    with pytest.raises(ApiError, match="too many write commands"):
        api.query("i", "Set(1, f=1) Clear(2, f=1) Set(3, f=1) Set(4, f=1)")
    # reads don't count toward the limit
    assert api.query(
        "i", "Count(Row(f=1)) Count(Row(f=1)) Count(Row(f=1)) "
             "Count(Row(f=1)) Set(9, f=1)")
    holder.close()


def test_time_clear_across_quantum_views(tmp_path):
    """Clear() removes a column from EVERY quantum view, so time-range
    reads never resurrect cleared bits (golden behavior from reference
    executor_test.go:2579 TestExecutor_Time_Clear_Quantums, all quantum
    configurations)."""
    from pilosa_tpu_torch.core.field import FieldOptions

    cases = {
        "Y": [3, 4, 5, 6], "M": [3, 4, 5, 6], "D": [3, 4, 5, 6],
        "H": [3, 4, 5, 6, 7], "YM": [3, 4, 5, 6], "YMD": [3, 4, 5, 6],
        "YMDH": [3, 4, 5, 6, 7], "MD": [3, 4, 5, 6],
        "MDH": [3, 4, 5, 6, 7], "DH": [3, 4, 5, 6, 7],
    }
    populate = [
        "Set(2, f=1, 1999-12-31T00:00)",
        "Set(3, f=1, 2000-01-01T00:00)",
        "Set(4, f=1, 2000-01-02T00:00)",
        "Set(5, f=1, 2000-02-01T00:00)",
        "Set(6, f=1, 2001-01-01T00:00)",
        "Set(7, f=1, 2002-01-01T02:00)",
        "Set(2, f=1, 1999-12-30T00:00)",
        "Set(2, f=1, 2002-02-01T00:00)",
        "Set(2, f=10, 2001-01-01T00:00)",
    ]
    check = "Row(f=1, from=1999-12-31T00:00, to=2002-01-01T03:00)"
    for i, (quantum, expected) in enumerate(cases.items()):
        h = Holder(str(tmp_path / f"q{i}"), use_snapshot_queue=False).open()
        idx = h.create_index("i")
        idx.create_field("f", FieldOptions.time_field(quantum))
        e = Executor(h, device="cpu")
        e.execute("i", " ".join(populate))
        e.execute("i", "Clear(2, f=1)")
        got = cols(e.execute("i", check)[0])
        assert got == expected, (quantum, got, expected)
        h.close()


def test_row_attrs_attached_and_exclude_options(tmp_path):
    """Row() responses carry the row's attributes; excludeRowAttrs strips
    them and excludeColumns strips the column payload (reference:
    executeBitmapCall executor.go:605-645 + executeOptionsCall)."""
    from pilosa_tpu_torch.server.api import API

    holder = Holder(str(tmp_path / "ra")).open()
    api = API(holder, device="cpu")
    api.create_index("i")
    api.create_field("i", "f")
    api.query("i", "Set(3, f=10)")
    api.query("i", 'SetRowAttrs(f, 10, color="red", rank=7)')

    row = api.query("i", "Row(f=10)")[0]
    assert row.attrs == {"color": "red", "rank": 7}
    assert cols(row) == [3]

    row = api.query(
        "i", "Options(Row(f=10), excludeRowAttrs=true)")[0]
    assert not row.attrs
    assert cols(row) == [3]

    row = api.query(
        "i", "Options(Row(f=10), excludeColumns=true)")[0]
    assert row.attrs == {"color": "red", "rank": 7}
    assert cols(row) == []
    holder.close()
