"""The port's remaining PQL calls against the TPU package, on the CPU.

Shift (stacked and per shard), MinRow/MaxRow, Options, ClearRow, Store,
SetRowAttrs and SetColumnAttrs. A data directory written by
`pilosa_tpu.core.Holder` from one numpy seed (6 shards at the real
shard width; rows present in only some shards; a bit in every shard's
last words; a time field; a keyed field) is copied twice: the TPU
package's Executor (JAX on the CPU) serves one copy, the port's Executor
(device="cpu") the other. Every query, writes included, runs on both,
and the results must be equal. Tolerance: exact equality.
"""

import inspect
import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.core import timeq as jax_timeq  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec import executor as jax_executor  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import executor as torch_executor  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as torch_count_expr  # noqa: E402
from pilosa_tpu_torch.ops import row_counts as torch_row_counts  # noqa: E402

N_SHARDS = 6
#: row of f -> the shards it has bits in
F_LAYOUT = {1: [4], 2: [0, 1], 3: list(range(N_SHARDS)), 4: [1, 3],
            5: [2, 5], 6: [5]}
DAYS = ("2019-02-03T00:00", "2019-02-04T00:00", "2019-03-01T00:00")


def _cols_in(rng, shards, n):
    return np.concatenate([
        s * SHARD_WIDTH + rng.choice(SHARD_WIDTH, size=n, replace=False)
        for s in shards]).astype(np.uint64)


def _write_reference_dir(path, seed=41):
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    seen = []
    for row, shards in F_LAYOUT.items():
        cols = _cols_in(rng, shards, 400)
        f.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
        seen.append(cols)
    # row 3: bits in the last two words of every shard, so every shift
    # drops bits at a shard's end
    edge = np.array([s * SHARD_WIDTH + SHARD_WIDTH - 1 - d
                     for s in range(N_SHARDS) for d in (0, 1, 31, 32, 33)],
                    dtype=np.uint64)
    f.import_bits(np.full(len(edge), 3, dtype=np.uint64), edge)
    g = idx.create_field("g")
    for row, shards in ((1, range(N_SHARDS)), (2, range(N_SHARDS)),
                        (3, [0])):
        cols = _cols_in(rng, list(shards), 900)
        g.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
        seen.append(cols)
    t = idx.create_field("t", JaxFieldOptions(type="time",
                                              time_quantum="YMD"))
    stamps = [jax_timeq.parse_time(d) for d in DAYS]
    for row in (1, 2):
        cols = _cols_in(rng, range(N_SHARDS), 300)
        t.import_bits(np.full(len(cols), row, dtype=np.uint64), cols,
                      timestamps=[stamps[i % 3] for i in range(len(cols))])
        seen.append(cols)
    idx.add_existence(np.concatenate(seen))
    idx.create_field("k", JaxFieldOptions(keys=True))
    ex = JaxExecutor(h)
    ex.execute("i", f'Set(1, k="red") Set({SHARD_WIDTH + 2}, k="blue") '
                    f'Set({3 * SHARD_WIDTH + 5}, k="red") '
                    f'Set({5 * SHARD_WIDTH + 7}, k="green")')
    h.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("pqlcalls")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    try:
        yield JaxExecutor(jh), Executor(th, device="cpu")
    finally:
        jax_containers.configure(prev)
        jh.close()
        th.close()


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of K1's and K3's plain versions (what a CPU tensor runs in
    place of a launch)."""
    calls = {"k1": 0, "k3": 0}
    real_k1 = torch_count_expr.count_expr_reference
    real_k3 = torch_row_counts.row_counts_reference

    def k1(sig, stacks):
        calls["k1"] += 1
        return real_k1(sig, stacks)

    def k3(rows, filt=None):
        calls["k3"] += 1
        return real_k3(rows, filt)

    monkeypatch.setattr(torch_count_expr, "count_expr_reference", k1)
    monkeypatch.setattr(torch_row_counts, "row_counts_reference", k3)
    return calls


def _norm(result):
    """Comparable form of one result of either package."""
    if hasattr(result, "segments"):
        return ("row", [int(c) for c in result.columns()],
                dict(result.attrs or {}), result.keys)
    if isinstance(result, list):
        return [_norm(r) for r in result]
    if hasattr(result, "to_json"):
        return result.to_json()
    return result


def _both(pair, pql, shards=None):
    jex, tex = pair
    want = _norm(jex.execute("i", pql, shards=shards))
    got = _norm(tex.execute("i", pql, shards=shards))
    assert got == want, pql
    return got


# ------------------------------------------------------------------ Shift

SHIFTS = [0, 1, 31, 32, 33, (1 << 20) - 1, 1 << 20, (1 << 20) + 5]


@pytest.mark.parametrize("n", SHIFTS)
def test_shift_count_is_one_stacked_k1(pair, plain_calls, n):
    """Over every shard a Count of a Shift is one K1 call (its plain
    version here), and equals the TPU package's per-shard answer."""
    before = plain_calls["k1"]
    got = _both(pair, f"Count(Shift(Row(f=3), n={n}))")
    assert plain_calls["k1"] == before + 1
    if n >= SHARD_WIDTH:
        assert got == [0]
    before = plain_calls["k1"]
    _both(pair, f"Count(Intersect(Shift(Row(f=3), n={n}), Row(g=1)))")
    assert plain_calls["k1"] == before + 1


@pytest.mark.parametrize("n", SHIFTS)
def test_shift_per_shard_route(pair, plain_calls, n):
    """One shard, and a Shift at the top of a query, take the per-shard
    route: no K1, the same answers."""
    before = plain_calls["k1"]
    _both(pair, f"Count(Shift(Row(f=3), n={n}))", shards=[5])
    _both(pair, f"Shift(Row(f=3), n={n})")
    assert plain_calls["k1"] == before


def test_shift_drops_bits_at_each_shard_end(pair):
    """Row 3 has every shard's last column set: a shift by one drops it,
    and never carries it into the next shard's first column."""
    jex, tex = pair
    (src,) = jex.execute("i", "Row(f=3)")
    want = {int(c) + 1 for c in src.columns()
            if int(c) % SHARD_WIDTH != SHARD_WIDTH - 1}
    (row,) = tex.execute("i", "Shift(Row(f=3), n=1)")
    got = {int(c) for c in row.columns()}
    assert got == want
    for s in range(N_SHARDS):
        assert s * SHARD_WIDTH + SHARD_WIDTH - 1 in got  # from SW - 2
        assert (s + 1) * SHARD_WIDTH not in got


def test_shift_negative_raises_like_reference(pair):
    jex, tex = pair
    with pytest.raises(ValueError, match="non-negative"):
        jex.execute("i", "Count(Shift(Row(f=3), n=-1))")
    with pytest.raises(ValueError, match="non-negative"):
        tex.execute("i", "Count(Shift(Row(f=3), n=-1))")


@pytest.mark.parametrize("pql", [
    "Count(Shift(Intersect(Row(f=3), Row(g=1)), n=7))",
    "Count(Shift(Shift(Row(f=3), n=1), n=32))",
    "Count(Union(Shift(Row(f=2), n=3), Not(Shift(Row(g=2), n=1))))",
    "Count(Difference(Shift(Row(f=3), n=65), Shift(Row(f=3), n=65)))",
    "TopN(f, Shift(Row(g=1), n=5), n=3)",
    "TopN(f, Intersect(Shift(Row(g=2), n=40), Row(g=1)))",
    "GroupBy(Rows(f), Rows(g), filter=Shift(Row(g=1), n=2))",
    "GroupBy(Rows(f), filter=Shift(Row(f=3), n=33))",
])
def test_shift_inside_trees_and_filters(pair, pql):
    _both(pair, pql)


def test_shift_filters_take_the_stacked_route(pair):
    """TopN's filter with a Shift is one filter stack, not a per-shard
    walk: the stacked dispatch counter moves."""
    _, tex = pair
    before = tex.stacked_stats()["dispatches"]
    _both(pair, "TopN(f, Shift(Row(g=1), n=9), n=2)")
    assert tex.stacked_stats()["dispatches"] > before


# ---------------------------------------------------------- MinRow / MaxRow


@pytest.mark.parametrize("pql", [
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "MinRow(Row(g=1), field=f)",
    "MaxRow(Row(g=1), field=f)",
    # g=3 lies in shard 0 only: the extreme rows with it are row 2 / 3
    "MinRow(Row(g=3), field=f)",
    "MaxRow(Row(g=3), field=f)",
    # an empty filter: no row qualifies
    "MinRow(Row(g=9), field=f)",
    "MaxRow(Intersect(Row(g=1), Row(g=9)), field=f)",
    "MaxRow(Shift(Row(g=3), n=3), field=f)",
    "MinRow(field=k)",
    "MaxRow(field=k)",
    "MaxRow(field=g)",
])
def test_minrow_maxrow_match_reference(pair, plain_calls, pql):
    before = plain_calls["k3"]
    _both(pair, pql)
    assert plain_calls["k3"] > before  # the stacked walk ran K3


@pytest.mark.parametrize("shards", [[4], [5], [0, 5]])
def test_minrow_maxrow_shard_subsets(pair, shards):
    for pql in ("MinRow(field=f)", "MaxRow(field=f)",
                "MaxRow(Row(g=1), field=f)"):
        _both(pair, pql, shards=shards)


def test_minrow_stops_at_first_nonzero_chunk(pair, plain_calls,
                                             monkeypatch):
    """With one row per K3 chunk, MinRow counts rows 1 and 2 only (row 1
    is empty under Row(g=3)); MaxRow from 6 down counts rows 6, 5, 4, 3,
    2 before row 2 (in shard 0 with g=3) answers."""
    from pilosa_tpu_torch.exec import stacked

    _, tex = pair
    monkeypatch.setattr(stacked, "CHUNK_BYTES",
                        N_SHARDS * SHARD_WIDTH // 8)
    before = plain_calls["k3"]
    _both(pair, "MinRow(Row(g=3), field=f)")
    assert plain_calls["k3"] == before + 2
    before = plain_calls["k3"]
    _both(pair, "MaxRow(Row(g=3), field=f)")
    assert plain_calls["k3"] == before + 5


def test_minrow_unknown_field_raises(pair):
    jex, tex = pair
    with pytest.raises(Exception, match="field not found"):
        jex.execute("i", "MinRow(field=nope)")
    with pytest.raises(Exception, match="field not found"):
        tex.execute("i", "MinRow(field=nope)")


# --------------------------------------------------------------- Options


def test_options_shards_count_is_one_k1(pair, plain_calls):
    before = plain_calls["k1"]
    _both(pair, "Options(Count(Intersect(Row(f=3), Row(g=1))), "
                "shards=[0, 2, 4])")
    assert plain_calls["k1"] == before + 1
    _, tex = pair
    keys = [k for k in tex._stacked._pools["leaf"] if k[2] == "g"]
    assert ("leaf", "i", "g", 1, (0, 2, 4)) in keys


@pytest.mark.parametrize("pql", [
    "Options(Row(f=3), shards=[1, 3])",
    "Options(Row(f=3), excludeColumns=true)",
    "Options(Row(f=3), columnAttrs=true)",
    "Options(Row(f=3), excludeRowAttrs=true)",
    "Options(Options(Count(Row(f=3)), shards=[1, 2]), shards=[0])",
    "Options(TopN(f, n=2), shards=[5])",
    "Options(MinRow(field=f), shards=[2, 3])",
])
def test_options_match_reference(pair, pql):
    _both(pair, pql)


@pytest.mark.parametrize("pql", [
    "Options(Row(f=3), banana=1)",
    "Options(Row(f=3), shards=3)",
])
def test_options_errors_match_reference(pair, pql):
    from pilosa_tpu.exec.executor import ExecError as JaxExecError
    from pilosa_tpu_torch.exec.executor import ExecError

    jex, tex = pair
    with pytest.raises(JaxExecError) as want:
        jex.execute("i", pql)
    with pytest.raises(ExecError) as got:
        tex.execute("i", pql)
    assert str(got.value) == str(want.value)


def test_options_keyed_results(pair):
    _both(pair, 'Options(Row(k="red"), shards=[0, 3])')
    _both(pair, "Options(MaxRow(field=k), shards=[0, 1])")


# ------------------------------------------------------- writes and attrs


def test_clear_row_over_time_views(pair):
    rng_q = ("Count(Row(t=1, from=2019-02-01T00:00, to=2019-02-05T00:00))",
             "Count(Row(t=1))", "Count(Row(t=2))",
             "Row(t=1, from=2019-03-01T00:00, to=2019-03-02T00:00)")
    for pql in rng_q:  # warm the cached stacks first
        _both(pair, pql)
    assert _both(pair, "ClearRow(t=1)") == [True]
    for pql in rng_q:
        _both(pair, pql)
    assert _both(pair, "Count(Row(t=1))") == [0]
    assert _both(pair, "ClearRow(t=1)") == [False]


def test_store_into_existing_and_missing_field(pair):
    jex, tex = pair
    assert _both(pair, "Count(Row(f=7))") == [0]
    _both(pair, "Store(Intersect(Row(f=3), Row(g=1)), f=7)")
    _both(pair, "Count(Row(f=7))")
    _both(pair, "Row(f=7)")
    assert _both(pair, "Count(Row(f=7))") \
        == _both(pair, "Count(Intersect(Row(f=3), Row(g=1)))")
    assert tex.holder.index("i").field("h") is None
    _both(pair, "Store(Shift(Row(g=2), n=3), h=1)")
    assert tex.holder.index("i").field("h") is not None
    _both(pair, "Count(Row(h=1))")
    _both(pair, "TopN(h)")
    assert sorted(tex.holder.index("i").field("h").available_shards()) \
        == sorted(jex.holder.index("i").field("h").available_shards())
    # overwrite with another tree, then one shard per shard
    _both(pair, "Store(Row(g=3), h=1)")
    _both(pair, "Count(Row(h=1))")
    _both(pair, "Options(Store(Row(f=2), h=2), shards=[1])")
    _both(pair, "Row(h=2)")


def test_set_row_and_column_attrs(pair):
    jex, tex = pair
    _both(pair, 'SetRowAttrs(f, 2, color="red", rank=7)')
    got = _both(pair, "Row(f=2)")
    assert got[0][2] == {"color": "red", "rank": 7}
    _both(pair, "Options(Row(f=2), excludeRowAttrs=true)")
    _both(pair, "Options(Row(f=2), excludeColumns=true)")
    _both(pair, 'SetColumnAttrs(5, name="x", n=3)')
    _both(pair, f'SetColumnAttrs({SHARD_WIDTH + 1}, name="y")')
    for col in (5, SHARD_WIDTH + 1, 6):
        assert tex.holder.index("i").column_attr_store.attrs(col) \
            == jex.holder.index("i").column_attr_store.attrs(col)
    assert tex.holder.index("i").column_attr_store.attrs(5) \
        == {"name": "x", "n": 3}


# ------------------------------------------------------------- coverage


def _reference_call_names():
    """The TPU package's handler table and bitmap calls, read from its
    source."""
    table = inspect.getsource(jax_executor.Executor.execute_call)
    handlers = set(re.findall(r'"(\w+)": self\._exec_', table))
    validate = inspect.getsource(jax_executor.Executor.validate_bitmap_call)
    known = re.search(r"known = \{([^}]*)\}", validate).group(1)
    return handlers | set(re.findall(r'"(\w+)"', known))


def test_ported_calls_cover_the_reference():
    names = _reference_call_names()
    assert len(names) == 25
    assert torch_executor.PORTED_CALLS == names
    assert torch_executor.BITMAP_CALLS <= torch_executor.PORTED_CALLS
