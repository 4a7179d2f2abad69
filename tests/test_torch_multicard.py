"""One node over several parts (`pilosa_tpu_torch/exec/parts.py`) on the
CPU, against the same node over one part and the TPU package on its
8-device CPU mesh.

A data directory written by `pilosa_tpu.core.Holder` from a numpy seed
holds 5 shards at the real shard width (5 is a multiple of none of the
part counts 2, 3 and 8; at 8 three parts hold only padding):

- f: a set field: rows 1-6 over every shard; rows 10, 11 and 12 of 300
  columns each, row 10 in shard 0, row 11 in shard 4 and row 12 half in
  shard 1 and half in shard 3, so TopN ties across parts;
- g, h: set fields for trees and 2- and 3-field GroupBy;
- s: a signed int field (-1000..1000) with its extremes present;
- z: an int field (-10..10) holding +0 in shards 0 and 3 and, in
  shard 1, a 0 whose sign bit is set (-0), with -3 and 7 in shard 2;
- t: a time field with quantum YMD over three months;
- existence for Not.

The TPU package's Executor serves one copy (dense containers), the
port's Executors over ["cpu"] * k the other, k in 1, 2, 3 and 8, under
the container reprs auto, dense, sparse and rle (auto with its 4 MiB
floor at 0, so that parts compress). Every answer is compared exactly.
The writes (one Set a part, then read-backs) go to both copies.
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.core import timeq as jax_timeq  # noqa: E402
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.core.fragment import BSI_SIGN_BIT  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu.server.api import result_to_json as jax_to_json  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import fusion  # noqa: E402
from pilosa_tpu_torch.exec.parts import PartedEvaluator  # noqa: E402
from pilosa_tpu_torch.exec.stacked import StackedEvaluator  # noqa: E402
from pilosa_tpu_torch.ops import containers  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as k1  # noqa: E402
from pilosa_tpu_torch.server.api import result_to_json  # noqa: E402

N_SHARDS = 5
KS = (1, 2, 3, 8)
REPRS = ("auto", "dense", "sparse", "rle")
JAN_FEB = 'from="2019-01-01T00:00", to="2019-03-01T00:00"'


def _write_reference_dir(path, seed=20):
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=6000,
                      replace=False).astype(np.uint64)
    idx.add_existence(cols)
    f = idx.create_field("f")
    for row in range(1, 7):
        pick = rng.choice(cols, size=400 + 150 * row, replace=False)
        f.import_bits(np.full(len(pick), row, np.uint64), pick)
    ties = {10: rng.choice(SHARD_WIDTH, 300, replace=False),
            11: 4 * SHARD_WIDTH + rng.choice(SHARD_WIDTH, 300, replace=False),
            12: np.concatenate([
                SHARD_WIDTH + rng.choice(SHARD_WIDTH, 150, replace=False),
                3 * SHARD_WIDTH + rng.choice(SHARD_WIDTH, 150,
                                             replace=False)])}
    for row, tcols in ties.items():
        f.import_bits(np.full(len(tcols), row, np.uint64),
                      tcols.astype(np.uint64))
    for name, rows in (("g", 3), ("h", 2)):
        fld = idx.create_field(name)
        for row in range(1, rows + 1):
            pick = rng.choice(cols, size=900 * row, replace=False)
            fld.import_bits(np.full(len(pick), row, np.uint64), pick)
    s = idx.create_field("s", JaxFieldOptions.int_field(min=-1000, max=1000))
    vals = rng.integers(-1000, 1001, size=len(cols))
    vals[:3] = [-1000, 1000, 0]
    s.import_values(cols, vals)
    z = idx.create_field("z", JaxFieldOptions.int_field(min=-10, max=10))
    zc = np.array([5, 3 * SHARD_WIDTH + 9, SHARD_WIDTH + 77,
                   2 * SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 2], np.uint64)
    z.import_values(zc, np.array([0, 0, 0, -3, 7]))
    z.view(z.bsi_view_name()).set_bit(BSI_SIGN_BIT, int(zc[2]))  # -0
    t = idx.create_field("t", JaxFieldOptions(type="time",
                                              time_quantum="YMD"))
    months = [jax_timeq.parse_time(d) for d in (
        "2019-01-15T00:00", "2019-02-15T00:00", "2019-03-15T00:00")]
    which = rng.integers(0, 3, size=len(cols))
    t.import_bits(np.zeros(len(cols), dtype=np.uint64), cols,
                  timestamps=[months[m] for m in which])
    h.close()


QUERIES = [
    # the headline Count and trees of &, |, ^, &~, Shift and Not
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Row(f=2))",
    "Count(Union(Row(f=1), Row(g=2), Row(h=1)))",
    "Count(Xor(Row(f=3), Row(g=1)))",
    "Count(Difference(Row(f=4), Row(g=2)))",
    "Count(Intersect(Union(Row(f=1), Row(f=2)), Not(Row(g=3))))",
    "Count(Shift(Row(f=5), n=3))",
    "Count(Not(Row(f=6)))",
    "Count(Union(Row(f=10), Row(f=11), Row(f=12)))",
    # TopN with ties across parts, Rows
    "TopN(f, n=2)",
    "TopN(f, Row(g=1), n=4)",
    "TopN(f, n=3, ids=[10, 11, 12])",
    "Rows(f)",
    # GroupBy of 2 and 3 fields, with limit and a filter
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), limit=5)",
    "GroupBy(Rows(g), Rows(h), Rows(f), limit=7)",
    "GroupBy(Rows(g), Rows(h), filter=Row(f=1))",
    # every BSI operator, Sum, Min and Max, negatives and -0
    "Count(Row(s == 17))", "Count(Row(s != 17))", "Count(Row(s < -250))",
    "Count(Row(s <= 250))", "Count(Row(s > 0))", "Count(Row(s >= -5))",
    "Count(Row(s >< [-700, 20]))", "Count(Row(s != null))",
    "Sum(field=s)", "Sum(Row(f=1), field=s)",
    "Min(field=s)", "Max(field=s)", "Min(Row(s < 0), field=s)",
    "Max(Row(s < 0), field=s)", "Min(Row(f=2), field=s)",
    "Min(field=z)", "Max(field=z)", "Sum(field=z)",
    "Max(Row(z < 1), field=z)", "Min(Row(z > -1), field=z)",
    "Max(Row(z < 0), field=z)",
    # time ranges
    f"Count(Row(t=0, {JAN_FEB}))",
    f"Count(Intersect(Row(t=0, {JAN_FEB}), Row(f=1)))",
    f"Sum(Row(t=0, {JAN_FEB}), field=s)",
]


#: a query whose three Counts ride one fused dispatch under fusion on
FUSED = ("Count(Intersect(Row(f=1), Row(g=1))) Count(Row(f=10)) "
         "Count(Not(Row(g=2)))")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: under a parallel test run the parts' small
    elementwise ops would otherwise contend with every other worker's
    threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX executor, port holder, JAX answers, reference dir)."""
    base = tmp_path_factory.mktemp("multicard")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    jex = JaxExecutor(jh)
    try:
        want = {q: [jax_to_json(r) for r in jex.execute("i", q)]
                for q in QUERIES + [FUSED]}
        yield jex, th, want
    finally:
        jax_containers.configure(prev)
        jh.close()
        th.close()


@pytest.fixture
def repr_mode(request):
    prev, floor = containers.repr_mode(), containers.AUTO_COMPRESS_FLOOR
    containers.configure(request.param)
    containers.AUTO_COMPRESS_FLOOR = 0
    try:
        yield request.param
    finally:
        containers.configure(prev)
        containers.AUTO_COMPRESS_FLOOR = floor


def _answers(ex, queries):
    return {q: [result_to_json(r) for r in ex.execute("i", q)]
            for q in queries}


@pytest.mark.parametrize("repr_mode", REPRS, indirect=True)
@pytest.mark.parametrize("k", KS)
def test_answers_equal_one_part_and_reference(world, k, repr_mode):
    """Every query at k parts equals the JAX package on its 8-device
    mesh (and so k = 1), exactly."""
    _jex, th, want = world
    ex = Executor(th, device=["cpu"] * k)
    got = _answers(ex, QUERIES)
    for q in QUERIES:
        assert got[q] == want[q], (k, repr_mode, q)


def test_the_ties_and_the_zeros_are_what_the_test_says(world):
    """The data has what the module docstring promises: TopN's rows 10,
    11 and 12 tie at 300 (lowest row first), and z's extremes are -0 /
    +0 where the sign rules make them so."""
    _jex, _th, want = world
    assert want["TopN(f, n=3, ids=[10, 11, 12])"] == [[
        {"id": 10, "count": 300}, {"id": 11, "count": 300},
        {"id": 12, "count": 300}]]
    assert want["Min(field=z)"] == [{"value": -3, "count": 1}]
    assert want["Max(Row(z < 0), field=z)"] == [{"value": 0, "count": 1}]
    assert want["Max(Row(z < 1), field=z)"] == [{"value": 0, "count": 2}]


@pytest.mark.parametrize("k", KS)
def test_shard_axis_padded_to_a_multiple_of_the_parts(world, k):
    """S pads to a multiple of k; each part holds one contiguous range,
    the padding (shard ids that no fragment has) at the end; a part of
    only padding holds zero planes. One part pads nothing."""
    _jex, th, _want = world
    ex = Executor(th, device=["cpu"] * k)
    ev = ex._stacked
    shards = tuple(range(N_SHARDS))
    s_pad = -(-N_SHARDS // k) * k
    assert ev._padded_len(shards) == s_pad
    if k == 1:
        assert type(ev) is StackedEvaluator
        return
    assert isinstance(ev, PartedEvaluator)
    parts = ev.split(shards)
    assert [len(p) for p in parts] == [s_pad // k] * k
    flat = [s for p in parts for s in p]
    assert flat[:N_SHARDS] == list(shards)
    assert all(s < 0 for s in flat[N_SHARDS:])
    ex.execute("i", "Count(Row(f=1))")
    for part, part_shards in zip(ev.parts, parts):
        (key, entry), = part._pools["leaf"].items()
        assert key[-1] == part_shards
        plane = containers.container_to_dense(entry[1])
        assert plane.shape == (s_pad // k, plane.shape[1])
        if all(s < 0 for s in part_shards):
            assert not bool(plane.any())
    snap = ev.hbm_snapshot()
    assert [p["part"] for p in snap["by_part"]] == list(range(k))
    assert snap["total_bytes"] == sum(p["bytes"] for p in snap["by_part"])
    assert snap["by_device"] == [{"device": "cpu", "parts": k,
                                  "bytes": snap["total_bytes"]}]


@pytest.mark.parametrize("k", KS)
def test_each_kernel_runs_once_per_part(world, k, monkeypatch):
    """The plain versions run once per part: K1 for a dense Count, K3
    for TopN (one chunk), K4 for a 2-field GroupBy (one tile pair), K5
    for a condition leaf, K3 three times a part for Sum (a CUDA node
    launches each kernel once per card the same way); a one-part node
    runs each once, as before."""
    from pilosa_tpu_torch.ops import bsi_range as k5
    from pilosa_tpu_torch.ops import pairwise as k4
    from pilosa_tpu_torch.ops import row_counts as k3

    _jex, th, want = world
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(k1, "count_expr_reference")
    spy(k3, "row_counts_reference")
    spy(k4, "pairwise_counts_reference")
    spy(k5, "bsi_range_mask_reference")
    prev = containers.repr_mode()
    containers.configure("dense")
    try:
        ex = Executor(th, device=["cpu"] * k)
        for q, name, n in (
                ("Count(Intersect(Row(f=1), Row(g=1)))",
                 "count_expr_reference", k),
                ("TopN(f, Row(g=1), n=4)", "row_counts_reference", k),
                ("GroupBy(Rows(f), Rows(g))", "pairwise_counts_reference",
                 k),
                ("Count(Row(s < -250))", "bsi_range_mask_reference", k),
                ("Sum(field=s)", "row_counts_reference", 3 * k)):
            calls.clear()
            assert _answers(ex, [q])[q] == want[q]
            assert calls.get(name) == n, (q, calls)
    finally:
        containers.configure(prev)


@pytest.mark.parametrize("k", KS)
def test_query_batch_and_fused_query(world, k):
    """A query-batch (Counts of one signature, a sparse mix and Row
    read-backs) and a fused multi-call query equal the one-part node."""
    _jex, th, want = world
    batch = ["Count(Intersect(Row(f=1), Row(g=1)))",
             "Count(Intersect(Row(f=2), Row(g=2)))",
             "Count(Intersect(Row(f=3), Row(g=1)))",
             "Count(Row(f=10))", "Count(Row(f=11))",
             "Row(f=12)", "Row(f=11)", "Count(Row(s > 0))"]
    one = Executor(th, device="cpu").execute_batch("i", batch)
    ex = Executor(th, device=["cpu"] * k)
    got = ex.execute_batch("i", batch)
    for (r1, e1, _), (rk, ek, _), q in zip(one, got, batch):
        assert e1 is None and ek is None, q
        assert [result_to_json(r) for r in rk] \
            == [result_to_json(r) for r in r1], (k, q)
    fusion.configure(mode="on", min_hits=0)
    try:
        before = fusion.decision_counts().get("fused", 0)
        got = [result_to_json(r) for r in ex.execute("i", FUSED)]
        assert fusion.decision_counts().get("fused", 0) == before + 1
    finally:
        fusion.reset()
    assert got == want[FUSED]


@pytest.mark.parametrize("k", (2, 3, 8))
def test_writes_patch_each_part_and_read_back(tmp_path, world, k):
    """A Set in one shard of each part, then the read-backs: equal to the
    JAX package given the same writes, and the parts of two or more
    shards patch their stacks in place instead of rebuilding."""
    _jex, th, _want = world
    src = str(tmp_path / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(tmp_path / "jax"))
    jh = JaxHolder(str(tmp_path / "jax"), use_snapshot_queue=False).open()
    th2 = Holder(src, use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    try:
        jex = JaxExecutor(jh)
        ex = Executor(th2, device=["cpu"] * k)
        reads = ["Count(Intersect(Row(f=1), Row(g=1)))", "TopN(f, n=3)",
                 "GroupBy(Rows(f), Rows(g), limit=4)", "Sum(field=s)",
                 "Max(field=s)", "Row(f=1)"]
        _answers(ex, reads)  # warm every stack
        parts = ex._stacked.split(tuple(range(N_SHARDS)))
        writes = []
        for p, part_shards in enumerate(parts):
            real = [s for s in part_shards if s >= 0]
            if real:
                col = real[-1] * SHARD_WIDTH + 4242 + p
                writes += [f"Set({col}, f=1)", f"Set({col}, g=1)",
                           f"Set({col}, s=999)"]
        for w in writes:
            jex.execute("i", w)
            ex.execute("i", w)
        patches0 = ex._stacked.cache_stats()["patches"]
        want = {q: [jax_to_json(r) for r in jex.execute("i", q)]
                for q in reads}
        assert _answers(ex, reads) == want
        if k < N_SHARDS:  # parts of >= 2 shards patch in place
            assert ex._stacked.cache_stats()["patches"] > patches0
    finally:
        jax_containers.configure(prev)
        jh.close()
        th2.close()


@pytest.mark.parametrize("k", (2, 3))
def test_proactive_admission_fills_each_part(world, k):
    """With the adaptive engine on, admission of a hot set field and a
    hot int field builds their stacks in every part's own pools over
    that part's range, and the queries that follow hit them. The node
    itself caches nothing: a lookup in its own pools raises."""
    from pilosa_tpu_torch.core.view import VIEW_STANDARD
    from pilosa_tpu_torch.exec import adaptive
    from pilosa_tpu_torch.utils import workload

    _jex, th, want = world
    ex = Executor(th, device=["cpu"] * k)
    ev = ex._stacked
    workload.reset()  # the heat of the module's earlier queries
    adaptive.configure(mode="on")
    try:
        for _ in range(10):
            workload.heat_bump("i", "g", VIEW_STANDARD)
            workload.heat_bump("i", "s", "bsi")
        assert ex.maybe_proactive_admit() == 2
        parts = ev.split(tuple(range(N_SHARDS)))
        for part, part_shards in zip(ev.parts, parts):
            keys = {(key[0], key[2]): key[-1]
                    for key in part._pools["leaf"]}
            assert keys == {("leaf", "g"): part_shards,
                            ("bsi", "s"): part_shards}
        assert not ev._pools["leaf"] and not ev._pools["rows"]
        adaptive.reset()  # the queries take the static stacked path
        before = ev.cache_stats()
        for q in ("Count(Intersect(Row(f=1), Row(g=1)))", "Sum(field=s)"):
            assert _answers(ex, [q])[q] == want[q]
        after = ev.cache_stats()
        # g's leaf and s's stack hit in every part; f=1, the one leaf
        # not admitted, misses once a part
        assert after["hits"] >= before["hits"] + 2 * k
        assert after["misses"] == before["misses"] + k
        with pytest.raises(RuntimeError, match="caches nothing itself"):
            StackedEvaluator.leaf_stack(ev, th.index("i"), "g", 1,
                                        tuple(range(N_SHARDS)))
    finally:
        adaptive.reset()
        workload.reset()


def test_a_part_card_failure_is_a_500_naming_the_card(world, monkeypatch):
    """A launch that fails on one part's card fails the query with a 500
    naming that card: no retry on another part, no per-shard fallback
    (trap 30's rule). The next query is served."""
    import json
    import urllib.error
    import urllib.request

    from pilosa_tpu_torch.ops import cuda_build
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.http_server import PilosaHTTPServer

    _jex, th, want = world
    api = API(th, device=["cpu"] * 2)
    srv = PilosaHTTPServer(api, host="127.0.0.1", port=0).start()
    real = containers.count_program
    calls = []

    def failing(sig, csig, flat):
        calls.append(flat[0].shape)
        if len(calls) == 2:  # part 1's launch
            raise cuda_build.launch_error("count_expr", "cuda:1", 700)
        return real(sig, csig, flat)

    q = "Count(Intersect(Row(f=1), Row(g=1)))"

    def post():
        req = urllib.request.Request(srv.uri + "/index/i/query",
                                     data=q.encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    try:
        monkeypatch.setattr(containers, "count_program", failing)
        status, body = post()
        assert status == 500 and "cuda:1" in body and "CUDA error" in body
        assert len(calls) == 2  # no third launch, no fallback
        monkeypatch.setattr(containers, "count_program", real)
        assert post() == (200, {"results": want[q]})
    finally:
        srv.stop()
        api.close()
