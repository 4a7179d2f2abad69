"""The port's BSI and time-range slice against the TPU package, on the CPU.

A data directory written by `pilosa_tpu.core.Holder` from a numpy seed
(4 shards at the real shard width) holds:

- s: a signed int field (min -1000, max 1000, base 0, depth 10);
- u: a min=0 int field (max 2^20, depth 21);
- b: an int field with a base offset (min 100, max 5000, base 100);
- e: an int field with no values;
- t: a time field with quantum YMD, row 0 over three months and row 1
  over two days;
- f: a set field whose row 1 lies only in shards 0 and 2 (a filter that
  is empty in some shards) and whose row 2 covers every valued column.

It is copied twice: the TPU package's Executor (JAX on the CPU, dense
containers) serves one copy, the port's Executor (device="cpu") the
other. The same PQL list, shard subsets and writes included, must give
exactly equal results.
"""

import json
import shutil
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.core import timeq as jax_timeq  # noqa: E402
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec.executor import ExecError as JaxExecError  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu.server.api import result_to_json as jax_to_json  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec.executor import ExecError  # noqa: E402
from pilosa_tpu_torch.ops import bsi_range as k5  # noqa: E402
from pilosa_tpu_torch.ops import row_counts as k3  # noqa: E402
from pilosa_tpu_torch.server.api import result_to_json  # noqa: E402

N_SHARDS = 4
DATES = ("2019-01-15T00:00", "2019-02-15T00:00", "2019-03-15T00:00")
JAN_FEB = 'from="2019-01-01T00:00", to="2019-03-01T00:00"'


def _write_reference_dir(path, seed=31):
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    fields = {"s": (-1000, 1000), "u": (0, 1 << 20), "b": (100, 5000),
              "e": (-50, 50)}
    for name, (lo, hi) in fields.items():
        idx.create_field(name, JaxFieldOptions.int_field(min=lo, max=hi))
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=6000,
                      replace=False).astype(np.uint64)
    for name in ("s", "u", "b"):
        lo, hi = fields[name]
        vals = rng.integers(lo, hi + 1, size=len(cols))
        vals[:3] = [lo, hi, (lo + hi) // 2]  # the extremes are present
        idx.field(name).import_values(cols, vals)
    idx.add_existence(cols)
    t = idx.create_field("t", JaxFieldOptions(type="time",
                                              time_quantum="YMD"))
    months = [jax_timeq.parse_time(d) for d in DATES]
    which = rng.integers(0, 3, size=len(cols))
    t.import_bits(np.zeros(len(cols), dtype=np.uint64), cols,
                  timestamps=[months[m] for m in which])
    days = [jax_timeq.parse_time("2019-02-03T00:00"),
            jax_timeq.parse_time("2019-02-04T00:00")]
    pick = cols[:500]
    t.import_bits(np.ones(len(pick), dtype=np.uint64), pick,
                  timestamps=[days[i % 2] for i in range(len(pick))])
    f = idx.create_field("f")
    in_02 = cols[(cols // SHARD_WIDTH) % 2 == 0][:800]
    f.import_bits(np.ones(len(in_02), dtype=np.uint64), in_02)
    f.import_bits(np.full(len(cols), 2, dtype=np.uint64), cols)
    h.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("bsi")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    try:
        yield JaxExecutor(jh), Executor(th, device="cpu"), src
    finally:
        jax_containers.configure(prev)
        jh.close()
        th.close()


def _same(jex, tex, pql, shards=None):
    want = [jax_to_json(r) for r in jex.execute("i", pql, shards=shards)]
    got = [result_to_json(r) for r in tex.execute("i", pql, shards=shards)]
    assert got == want, pql
    return got


CONDITIONS = [
    # every operator on the signed field, inside its range
    "s == 17", "s == -17", "s != 17", "s != -400", "s < 250", "s <= 250",
    "s < -250", "s <= -250", "s > 250", "s >= 250", "s > -250", "s >= -250",
    "s == 0", "s > 0", "s < 0", "s != null",
    # BETWEEN: both bounds >= 0, both < 0, straddling zero, inverted
    "s >< [10, 400]", "s >< [-700, -20]", "s >< [-30, 700]",
    "s >< [400, 10]", "-5 < s <= 10",
    # predicates at, and clamped beyond, the field's range and depth
    "s > 1000", "s >= 1000", "s < -1000", "s <= -1000", "s > 5000",
    "s < -5000", "s >= -5000", "s <= 5000", "s == 99999", "s != 99999",
    "s >< [-99999, 99999]", "s >< [-99999, -1500]", "s >< [2000, 99999]",
    # the min=0 field, with predicates past its depth of 21 bits
    "u > 524288", "u <= 3", "u == 1048576", "u < 4194304", "u > 4194304",
    "u >< [1000, 900000]", "u != 0",
    # the base-offset field
    "b > 4000", "b < 150", "b == 100", "b >< [99, 101]", "b >= 0",
    # the field with no values
    "e > 0", "e != null", "e >< [-10, 10]",
]


@pytest.mark.parametrize("cond", CONDITIONS)
def test_condition_counts_and_rows(pair, cond):
    jex, tex, _ = pair
    _same(jex, tex, f"Count(Row({cond}))")
    _same(jex, tex, f"Row({cond})", shards=[1])


AGGREGATES = [
    "Sum(field=s)", "Sum(field=u)", "Sum(field=b)", "Sum(field=e)",
    "Sum(Row(f=1), field=s)", "Sum(Row(f=2), field=b)",
    f"Sum(Row(t=0, {JAN_FEB}), field=u)",
    f"Sum(Intersect(Row(t=0, {JAN_FEB}), Row(s > 0)), field=s)",
    "Min(field=s)", "Max(field=s)", "Min(field=u)", "Max(field=u)",
    "Min(field=b)", "Max(field=b)", "Min(field=e)", "Max(field=e)",
    "Min(Row(f=1), field=s)", "Max(Row(f=1), field=s)",
    "Min(Row(s < 0), field=s)", "Max(Row(s < 0), field=s)",
    "Min(Row(s > 0), field=s)", "Max(Row(s > 0), field=s)",
    f"Min(Row(t=0, {JAN_FEB}), field=u)",
    f"Max(Row(t=0, {JAN_FEB}), field=u)",
    "Sum(Row(f=9), field=s)", "Max(Row(f=9), field=s)",
]


@pytest.mark.parametrize("pql", AGGREGATES)
def test_aggregates(pair, pql):
    jex, tex, _ = pair
    _same(jex, tex, pql)


TIME_QUERIES = [
    f"Row(t=0, {JAN_FEB})",
    'Row(t=1, from="2019-02-01T00:00")',
    'Row(t=0, to="2019-02-16T00:00")',
    'Row(t=1, from="2019-02-03T00:00", to="2019-02-04T00:00")',
    f"Count(Row(t=0, {JAN_FEB}))",
    'Count(Row(t=0, from="2018-01-01T00:00", to="2020-01-01T00:00"))',
    'Count(Row(t=1, from="2019-02-04T00:00", to="2019-02-05T00:00"))',
    f"Count(Intersect(Row(s > 0), Row(t=0, {JAN_FEB})))",
    f"Count(Union(Row(u < 1000), Difference(Row(t=0, {JAN_FEB}), "
    "Row(s >< [-30, 700]))))",
    f"Count(Xor(Row(t=1, {JAN_FEB}), Row(f=1)))",
    "Count(Not(Row(s > 0)))",
    'Count(Row(t=0, from="2019-05-01T00:00", to="2019-06-01T00:00"))',
]


@pytest.mark.parametrize("pql", TIME_QUERIES)
def test_time_ranges(pair, pql):
    jex, tex, _ = pair
    _same(jex, tex, pql)


@pytest.mark.parametrize("shards", [[0], [3], [1, 3], [0, 1, 2, 3]])
@pytest.mark.parametrize("pql", [
    "Count(Row(s >< [-30, 700]))",
    f"Count(Intersect(Row(u > 524288), Row(t=0, {JAN_FEB})))",
    f"Sum(Row(t=0, {JAN_FEB}), field=s)",
    "Sum(Row(f=1), field=u)",
    "Min(Row(f=1), field=s)",
    "Max(field=b)",
])
def test_stacked_and_per_shard_paths_agree(pair, shards, pql):
    """One shard takes the per-shard path, two or more the stacked one;
    both equal the TPU package (which takes the same split)."""
    jex, tex, _ = pair
    _same(jex, tex, pql, shards=shards)


def test_stacked_path_launch_shape(pair, monkeypatch):
    """A condition Count gathers the BSI stack once and then hits; a Sum
    is three K3 launches; Count and Sum both count as stacked dispatches
    (CPU tensors never launch a kernel, so the counters stay at 0)."""
    _, tex, _ = pair
    tex = Executor(tex.holder, device="cpu")  # an empty stack cache
    tex.execute("i", "Count(Row(s > 3))")
    first = tex.stacked_stats()
    assert first["misses"] == 1 and first["dispatches"] == 2
    tex.execute("i", "Count(Row(s < 3))")
    assert tex.stacked_stats()["planes_uploaded"] \
        == first["planes_uploaded"] == 12 * N_SHARDS
    ledger = tex._stacked.hbm_ledger()
    assert sum(ledger.values()) == tex.stacked_stats()["bytes"]
    assert ("i", "s") in ledger
    calls = []
    real = k3.row_counts_reference

    def spy(rows, filt=None):
        calls.append(tuple(rows.shape))
        return real(rows, filt)

    monkeypatch.setattr(k3, "row_counts_reference", spy)
    tex.execute("i", "Sum(field=s)")
    assert calls == [(10, N_SHARDS * 32768)] * 2 + [(1, N_SHARDS * 32768)]
    assert k5.bsi_range_mask.launches == 0


def test_set_value_then_sum_reads_own_write(pair):
    jex, tex, _ = pair
    col = 2 * SHARD_WIDTH + 4321
    other = 3 * SHARD_WIDTH + 99
    for pql in ("Sum(field=s)", f"Set({col}, s=-777)", "Sum(field=s)",
                "Count(Row(s == -777))", "Min(field=s)",
                f"Set({other}, s=1000)", "Max(field=s)",
                f"Clear({col}, s=0)", "Sum(field=s)",
                "Count(Row(s == -777))"):
        _same(jex, tex, pql)
    # each write drifted one of four shards: patched in place, not rebuilt
    assert tex.stacked_stats()["patches"] >= 3


def test_set_time_bit_then_time_count(pair):
    jex, tex, _ = pair
    col = SHARD_WIDTH + 5
    for pql in (f"Count(Row(t=0, {JAN_FEB}))",
                f'Set({col}, t=0, 2019-01-20T10:00)',
                f"Count(Row(t=0, {JAN_FEB}))",
                f"Row(t=0, {JAN_FEB})"):
        _same(jex, tex, pql)


@pytest.mark.parametrize("pql,match", [
    ("Sum(field=f)", "not an int field"),
    ("Min(Row(f=1), field=f)", "not an int field"),
    ("Count(Row(f > 1))", "not an int field"),
    ("Sum(field=nope)", "field not found"),
    (f"Count(Row(f=1, {JAN_FEB}))", "not a time field"),
])
def test_errors_match_reference(pair, pql, match):
    jex, tex, _ = pair
    with pytest.raises(JaxExecError, match=match):
        jex.execute("i", pql)
    with pytest.raises(ExecError, match=match):
        tex.execute("i", pql)


def _http(uri, path, body=None):
    req = urllib.request.Request(
        uri + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_import_values_end_to_end(pair, tmp_path):
    """POST …/field/u/import with a "values" body, then Sum, Count and a
    condition over HTTP equal the TPU package after the same import."""
    _, _, src = pair
    data = str(tmp_path / "served")
    shutil.copytree(src, data)
    ref = str(tmp_path / "ref")
    shutil.copytree(src, ref)
    cols = [5, 6, 70_000, SHARD_WIDTH + 8]  # two of four shards drift
    vals = [123456, 0, 1 << 20, 42]
    queries = ["Sum(field=u)", "Count(Row(u == 42))",
               "Max(field=u)", f"Sum(Row(t=0, {JAN_FEB}), field=u)"]
    jh = JaxHolder(ref, use_snapshot_queue=False).open()
    try:
        jh.index("i").field("u").import_values(
            np.asarray(cols, dtype=np.uint64), np.asarray(vals))
        jex = JaxExecutor(jh)
        want = [jax_to_json(jex.execute("i", q)[0]) for q in queries]
    finally:
        jh.close()
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", data,
                        "--device", "cpu"])
    try:
        before = [_http(srv.uri, "/index/i/query", q)["results"][0]
                  for q in queries]
        out = _http(srv.uri, "/index/i/field/u/import",
                    json.dumps({"columnIDs": cols, "values": vals}))
        assert out["changed"] > 0
        got = [_http(srv.uri, "/index/i/query", q)["results"][0]
               for q in queries]
        assert got == want
        assert got != before
        assert srv.api.executor.stacked_stats()["patches"] >= 1
    finally:
        srv.stop()
