"""The PQL fuzz differential, the roaring and oplog fuzz and the corpus
replays of `tests/test_fuzz.py`, held against the port on the CPU.

Every randomized tree of `pilosa_tpu_torch.tools.fuzz` runs on the
port's Executor (device="cpu", each kernel wrapper taking its plain
version) under each container repr, `auto`, `dense`, `sparse` and
`rle` (`ops.containers.configure`, restored afterwards): as a Count
and as the Row's exact columns, against the naive set model. A forced
`sparse` reaches K2's plain versions (a lone leaf, and the fused pair of
a pure-& tree), a forced `rle` the run-length sums, and every mixed tree
the densify-then-K1 fallback; the fixed-set cases pin each route.

The drift guard holds the port's generators and models to the
reference's for every seed, so the reference's own `tests/test_fuzz.py`
holds the JAX package to the same model on the same data and trees.
The JAX package also serves a copy of one seed's data directory of each
fuzz, written by the port, and of the corpus fixture, and must answer
every tree, aggregate and corpus query alike. Tolerance: exact equality
throughout.
"""

import collections
import random
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import ExecError as JaxExecError  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server.api import result_to_json as jax_to_json  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec.executor import ExecError  # noqa: E402
from pilosa_tpu_torch.ops import containers  # noqa: E402
from pilosa_tpu_torch.pql import parse  # noqa: E402
from pilosa_tpu_torch.pql.writer import query_to_pql  # noqa: E402
from pilosa_tpu_torch.roaring import codec  # noqa: E402
from pilosa_tpu_torch.roaring.bitmap import Bitmap  # noqa: E402
from pilosa_tpu_torch.server.api import result_to_json  # noqa: E402
from pilosa_tpu_torch.tools import fuzz  # noqa: E402

from tests import test_fuzz as ref  # noqa: E402

REPRS = ("auto", "dense", "sparse", "rle")
SET_SEEDS = (7, 23, 1009)
AGG_SEEDS = (3, 17)
FULL_SEEDS = (13, 101)
TESTDATA = ref.TESTDATA


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each (the suite runs several
    workers side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=REPRS)
def repr_mode(request):
    prev = containers.repr_mode()
    containers.configure(request.param)
    try:
        yield request.param
    finally:
        containers.configure(prev)


@pytest.fixture
def routes(monkeypatch):
    """Calls of each count route of ops/containers.py, by name."""
    calls = collections.Counter()
    for name in ("count_blocks", "count_and_blocks", "rle_count",
                 "rle_intersect", "count_expr", "to_dense"):
        orig = getattr(containers, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(containers, name, spy)
    return calls


# ------------------------------------------------------ set differential


@pytest.mark.parametrize("seed", SET_SEEDS)
def test_pql_differential(tmp_path, repr_mode, seed):
    holder, api, model = fuzz.build(tmp_path, seed, device="cpu")
    try:
        done = fuzz.check_set(api.executor, model, random.Random(seed * 31),
                              25, tag=f"{repr_mode} seed={seed}")
        assert len(done) == 25
    finally:
        holder.close()


@pytest.mark.parametrize("seed", AGG_SEEDS)
def test_pql_aggregates_differential(tmp_path, repr_mode, seed):
    holder, api, model = fuzz.build(tmp_path, seed, device="cpu")
    try:
        assert len(fuzz.check_aggregates(api.executor, model,
                                         tag=repr_mode)) == 2
    finally:
        holder.close()


# the count route each forced repr must reach on the fixed set
WANT_ROUTES = {
    "auto": {"count_expr"},
    "dense": {"count_expr"},
    "sparse": {"count_blocks", "count_and_blocks"},
    "rle": {"rle_count", "rle_intersect"},
}


def test_fixed_set_reaches_each_route(tmp_path, repr_mode, routes):
    holder, api, model = fuzz.build(tmp_path, 7, device="cpu")
    try:
        done = fuzz.check_fixed(api.executor, "fz", model,
                                fuzz.fixed_set_queries(), tag=repr_mode)
        assert len(done) == 24
        for name in WANT_ROUTES[repr_mode]:
            assert routes[name] > 0, (name, dict(routes))
        if repr_mode == "dense":
            assert not routes["count_blocks"] and not routes["rle_count"]
    finally:
        holder.close()


def test_mixed_trees_densify_then_k1(tmp_path, routes):
    """Under a forced sparse repr, a tree that is no pure-& of sparse
    leaves densifies every leaf and counts with one K1 call."""
    prev = containers.repr_mode()
    containers.configure("sparse")
    holder, api, model = fuzz.build(tmp_path, 7, device="cpu")
    try:
        pql = "Count(Union(Row(f=1), Not(Row(g=2)), Xor(Row(f=0), Row(g=3))))"
        want = len((model.rows[("f", 1)]
                    | (model.exists - model.rows[("g", 2)]))
                   | (model.rows[("f", 0)] ^ model.rows[("g", 3)]))
        routes.clear()
        assert api.executor.execute("fz", pql)[0] == want
        assert routes["count_expr"] == 1 and routes["to_dense"] >= 4
        assert not routes["count_blocks"] and not routes["count_and_blocks"]
    finally:
        holder.close()
        containers.configure(prev)


# --------------------------------------------------------- roaring fuzz


def random_bitmap(rnd, rng):
    """A bitmap mixing array, bitmap, run and boundary containers across
    several 2^16 key spaces (the reference fuzz's generator)."""
    b = Bitmap()
    for key in rnd.sample(range(0, 64), rnd.randint(1, 5)):
        shape = rnd.choice(["array", "dense", "runs", "edge"])
        lo = key << 16
        if shape == "array":
            vals = rng.choice(65536, size=rnd.randint(1, 200), replace=False)
        elif shape == "dense":
            vals = rng.choice(65536, size=rnd.randint(5000, 9000),
                              replace=False)
        elif shape == "runs":
            vals = []
            start = 0
            for _ in range(rnd.randint(1, 10)):
                start += rnd.randint(1, 3000)
                length = rnd.randint(1, 2000)
                vals.extend(range(start, min(start + length, 65536)))
                start += length
            vals = np.array(sorted(set(vals)), dtype=np.int64)
        else:
            vals = np.array([0, 1, 65534, 65535], dtype=np.int64)
        b.add_many([lo + int(v) for v in vals])
    return b


@pytest.mark.parametrize("seed", [11, 42, 77])
def test_roaring_roundtrip_fuzz(seed):
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    for i in range(5):
        b = random_bitmap(rnd, rng)
        blob = codec.serialize(b)
        b2, flags, opn = codec.deserialize(blob)
        assert opn == 0, (seed, i)
        assert b2.count() == b.count(), (seed, i)
        assert list(b2.slice_range(0, 1 << 40)) == \
            list(b.slice_range(0, 1 << 40)), (seed, i)
        # the reference's codec reads the port's blob alike
        from pilosa_tpu.roaring import codec as jax_codec

        b3, _, _ = jax_codec.deserialize(blob)
        assert list(b3.slice_range(0, 1 << 40)) == \
            list(b.slice_range(0, 1 << 40)), (seed, i)


@pytest.mark.parametrize("seed", [5, 19])
def test_oplog_replay_fuzz(seed):
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    b = random_bitmap(rnd, rng)
    blob = bytearray(codec.serialize(b))
    mirror = set(int(v) for v in b.slice_range(0, 1 << 40))
    for _ in range(30):
        op = rnd.choice(["add", "remove", "add_batch", "remove_batch"])
        if op == "add":
            v = rnd.randrange(1 << 22)
            blob += codec.encode_op(codec.OP_ADD, value=v)
            mirror.add(v)
        elif op == "remove":
            v = (rnd.choice(sorted(mirror)) if mirror and rnd.random() < .7
                 else rnd.randrange(1 << 22))
            blob += codec.encode_op(codec.OP_REMOVE, value=v)
            mirror.discard(v)
        elif op == "add_batch":
            vs = [rnd.randrange(1 << 22) for _ in range(rnd.randint(1, 50))]
            blob += codec.encode_op(codec.OP_ADD_BATCH, values=vs)
            mirror.update(vs)
        else:
            vs = rnd.sample(sorted(mirror), min(len(mirror), 20)) if mirror \
                else [1]
            blob += codec.encode_op(codec.OP_REMOVE_BATCH, values=vs)
            mirror.difference_update(vs)
    b2, _, opn = codec.deserialize(bytes(blob))
    assert opn == 30
    assert set(int(v) for v in b2.slice_range(0, 1 << 40)) == mirror


# ------------------------------------------------ full-type differential


@pytest.mark.parametrize("seed", FULL_SEEDS)
def test_full_type_differential(tmp_path, repr_mode, seed):
    holder, api, model = fuzz.build_full(tmp_path, seed, device="cpu")
    try:
        tag = f"{repr_mode} seed={seed}"
        done = fuzz.check_full(api.executor, model,
                               random.Random(seed * 101), 40, tag=tag)
        assert len(done) == 40
        assert len(fuzz.check_bsi_aggregates(api.executor, model,
                                             tag=tag)) == 12
        fuzz.check_fixed(api.executor, "fz2", model,
                         fuzz.fixed_bsi_queries(), tag=tag)
    finally:
        holder.close()


# ------------------------------------------------------- corpus replays


def test_roaring_corpus_replay():
    paths = sorted((TESTDATA / "roaring").glob("*.roaring"))
    assert paths, "roaring corpus missing"
    for path in paths:
        blob = path.read_bytes()
        b, _flags, _opn = codec.deserialize(blob)
        for key in b.keys():
            c = b.containers[key]
            assert c.n == c._count(), f"{path.name}: bad cardinality"
        blob2 = codec.serialize(b)
        b2, _, opn2 = codec.deserialize(blob2)
        assert opn2 == 0
        assert list(b2.slice_range(0, 1 << 64)) == \
            list(b.slice_range(0, 1 << 64)), path.name


def _corpus():
    lines = [
        ln.strip() for ln in
        (TESTDATA / "pql" / "corpus.txt").read_text().splitlines()
        if ln.strip() and not ln.startswith("#")]
    assert lines, "pql corpus missing"
    return lines


def test_pql_corpus_replay(tmp_path):
    holder, api, _model = fuzz.build_full(tmp_path, 7, device="cpu")
    try:
        for pql in _corpus():
            q1 = parse(pql)
            assert query_to_pql(parse(query_to_pql(q1))) == \
                query_to_pql(q1), f"writer round-trip unstable: {pql}"
            try:
                api.executor.execute("fz2", pql)
            except ExecError:
                pass  # a clean refusal is acceptable; crashes are not
    finally:
        holder.close()


# ---------------------------------------------- the JAX package, same data


def _copy_for_jax(holder, path, tmp_path):
    """Close the port's holder, copy its directory for the JAX package,
    and reopen both: (port holder, JAX executor, JAX holder)."""
    holder.close()
    shutil.copytree(str(path), str(tmp_path / "jax"))
    jh = JaxHolder(str(tmp_path / "jax"), use_snapshot_queue=False).open()
    return Holder(str(path)).open(), JaxExecutor(jh), jh


def _answer(ex, index, pql, to_json, error):
    """One package's answer as the HTTP JSON, or its refusal."""
    try:
        return [r if isinstance(r, (bool, int)) else to_json(r)
                for r in ex.execute(index, pql)]
    except error as e:
        return ("error", type(e).__name__)


def _same_answers(tex, jex, index, queries):
    for pql in queries:
        assert _answer(tex, index, pql, result_to_json, ExecError) == \
            _answer(jex, index, pql, jax_to_json, JaxExecError), pql


# One seed of each fuzz against the JAX package: the reference's own
# test_fuzz.py holds the JAX package to the model on every seed, and the
# drift guard below holds the port's data and trees to the reference's,
# so the other seeds agree by way of the model.
@pytest.mark.parametrize("seed", [7])
def test_set_fuzz_matches_jax(tmp_path, seed):
    from pilosa_tpu_torch.exec import Executor

    path = tmp_path / "port"
    holder, _api, model = fuzz.build(path, seed, device="cpu")
    holder, jex, jh = _copy_for_jax(holder, path, tmp_path)
    try:
        tex = Executor(holder, device="cpu")
        rnd = random.Random(seed * 31)
        queries = ["TopN(f, n=4)", "Rows(f)", "Rows(g)"]
        for _ in range(25):
            pql, _ev = fuzz.gen_call(rnd)
            queries += [pql, f"Count({pql})"]
        _same_answers(tex, jex, "fz", queries)
    finally:
        jh.close()
        holder.close()


@pytest.mark.parametrize("seed", [13])
def test_full_fuzz_matches_jax(tmp_path, seed):
    from pilosa_tpu_torch.exec import Executor

    path = tmp_path / "port"
    holder, _api, model = fuzz.build_full(path, seed, device="cpu")
    holder, jex, jh = _copy_for_jax(holder, path, tmp_path)
    try:
        tex = Executor(holder, device="cpu")
        rnd = random.Random(seed * 101)
        queries = [f"{c}(Row(s={r}), field=v)"
                   for c in ("Sum", "Min", "Max") for r in range(4)]
        queries += [pql for pql, _ in fuzz.fixed_bsi_queries()]
        for _ in range(40):
            pql, _ev = fuzz.gen_full_call(rnd)
            queries += [pql, f"Count({pql})"]
        _same_answers(tex, jex, "fz2", queries)
    finally:
        jh.close()
        holder.close()


def test_pql_corpus_matches_jax(tmp_path):
    """Each corpus query answers alike on both packages, or is refused
    by both, in order (its writes reach both copies)."""
    from pilosa_tpu_torch.exec import Executor

    path = tmp_path / "port"
    holder, _api, _model = fuzz.build_full(path, 7, device="cpu")
    holder, jex, jh = _copy_for_jax(holder, path, tmp_path)
    try:
        tex = Executor(holder, device="cpu")
        _same_answers(tex, jex, "fz2", _corpus())
    finally:
        jh.close()
        holder.close()


# ------------------------------------------------------------ drift guard


def _same_models(a, b):
    return all(getattr(a, k) == getattr(b, k) for k in vars(a))


@pytest.mark.parametrize("seed", SET_SEEDS + AGG_SEEDS)
def test_set_generator_matches_reference(tmp_path, seed):
    """The port's copy draws the same data and the same trees as the
    reference's fuzz, and its evaluators give the same answers."""
    holder, _api, model = fuzz.build(tmp_path / "port", seed, device="cpu")
    holder.close()
    jh, ref_model = ref.build(tmp_path / "ref", seed)
    jh.close()
    assert _same_models(model, ref_model)
    a, b = random.Random(seed * 31), random.Random(seed * 31)
    for i in range(25):
        pql, ev = fuzz.gen_call(a)
        ref_pql, ref_ev = ref.gen_call(b)
        assert pql == ref_pql, (seed, i)
        assert ev(model) == ref_ev(ref_model), (seed, i, pql)
    assert a.random() == b.random()


@pytest.mark.parametrize("seed", FULL_SEEDS + (7,))
def test_full_generator_matches_reference(tmp_path, seed):
    holder, _api, model = fuzz.build_full(tmp_path / "port", seed,
                                          device="cpu")
    holder.close()
    jh, _jex, ref_model = ref.build_full(tmp_path / "ref", seed)
    jh.close()
    assert _same_models(model, ref_model)
    a, b = random.Random(seed * 101), random.Random(seed * 101)
    for i in range(40):
        pql, ev = fuzz.gen_full_call(a)
        ref_pql, ref_ev = ref.gen_full_call(b)
        assert pql == ref_pql, (seed, i)
        assert ev(model) == ref_ev(ref_model), (seed, i, pql)
    assert a.random() == b.random()
