"""The port's compressed containers and K2 against the TPU package, on
the CPU.

Same numpy inputs through `pilosa_tpu.ops.containers` (JAX on the CPU;
the Pallas block kernels in interpret mode) and through
`pilosa_tpu_torch.ops.containers` / `ops.count_blocks` (torch on the CPU,
plain versions): the chooser, the host builders, the direct counts, the
count and plane programs, and served results (Count, Row, TopN with a
compressed filter) under every --container-repr mode. Tolerance: exact
equality everywhere.
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec.stacked import StackedEvaluator as JaxStacked  # noqa: E402
from pilosa_tpu.ops import containers as jc  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.server.api import result_to_json as jax_to_json  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.cli import _parser, start_server  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.ops import containers as tc  # noqa: E402
from pilosa_tpu_torch.ops import count_blocks as k2  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as k1  # noqa: E402
from pilosa_tpu_torch.server.api import result_to_json  # noqa: E402
from tests.test_containers import DENSITIES, _stack  # noqa: E402

MODES = ("auto", "dense", "sparse", "rle")


@pytest.fixture(autouse=True)
def _restore_modes():
    """Both packages keep the mode and the auto floor as module state:
    the corpus runs at CPU scale, far below the 4 MiB floor, so the
    floor drops to 0 and both knobs come back afterwards."""
    saved = [(m, m.repr_mode(), m.AUTO_COMPRESS_FLOOR) for m in (jc, tc)]
    jc.AUTO_COMPRESS_FLOOR = tc.AUTO_COMPRESS_FLOOR = 0
    yield
    for m, mode, floor in saved:
        m.configure(mode)
        m.AUTO_COMPRESS_FLOOR = floor


def _np_count(stack):
    return int(np.unpackbits(np.ascontiguousarray(stack).view(np.uint8)).sum())


def _words(t):
    """A port int32 tensor as the uint32 numpy words it holds."""
    return t.cpu().numpy().view(np.uint32)


def _jax_total(hi_lo):
    hi, lo = hi_lo
    return (int(np.sum(hi)) << 16) + int(np.sum(lo))


def _jax_build(stack, mode):
    return jc.build(stack, place_sharded=jnp.asarray,
                    place_replicated=jnp.asarray, mode=mode)


def _port_from_jax(c):
    """The port's Container holding the JAX-built arrays."""
    return tc.from_host(c.kind, c.shape, [np.asarray(a) for a in c.arrays],
                        "cpu")


# ---------------------------------------------------------- chooser, builders


@pytest.mark.parametrize("name", DENSITIES)
def test_analyze_matches_reference(name):
    """The port analyzes the int32 tensor on its device; the TPU package
    the uint32 words on the host."""
    stack = _stack(name)
    assert tc.analyze(_t(stack)) == jc.analyze(stack)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", DENSITIES)
def test_choose_matches_reference(name, mode):
    stack = _stack(name)
    s, w = stack.shape
    info = jc.analyze(stack)
    assert tc.choose(info, s, w, mode) == jc.choose(info, s, w, mode)
    # the int32 gate: too many shards for int32 totals keeps it dense
    too_many = 2**31 // SHARD_WIDTH + 1
    assert tc.choose(info, too_many, w, mode) \
        == jc.choose(info, too_many, w, mode) == "dense"


@pytest.mark.parametrize("name", DENSITIES)
def test_choose_floor_matches_reference(name):
    stack = _stack(name)
    info = jc.analyze(stack)
    jc.AUTO_COMPRESS_FLOOR = tc.AUTO_COMPRESS_FLOOR = info["dense_bytes"] + 1
    for mode in MODES:
        assert tc.choose(info, *stack.shape, mode) \
            == jc.choose(info, *stack.shape, mode)
    assert tc.choose(info, *stack.shape, "auto") == "dense"


@pytest.mark.parametrize("name", DENSITIES)
def test_host_builders_match_reference(name):
    stack = _stack(name)
    for got, want in zip(tc._sparse_host(stack), jc._sparse_host(stack)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tc._rle_host(stack), jc._rle_host(stack)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", DENSITIES)
def test_build_picks_reference_choice(name, mode):
    """build analyzes the uploaded stack on the device and keeps or
    rebuilds it as the TPU package's chooser picks for the same words."""
    stack = _stack(name)
    c = tc.build(stack, "cpu", mode=mode)
    assert c.kind == jc.choose(jc.analyze(stack), *stack.shape, mode)
    np.testing.assert_array_equal(_words(tc.container_to_dense(c)), stack)


def test_configure_rejects_bad_mode():
    with pytest.raises(ValueError):
        tc.configure("roaring")


# ------------------------------------------------------ build, densify, count


@pytest.mark.parametrize("mode", ["sparse", "rle"])
@pytest.mark.parametrize("name", DENSITIES)
def test_build_roundtrip_and_direct_count(name, mode):
    stack = _stack(name)
    c = tc.build(stack, "cpu", mode=mode)
    assert c.kind == mode  # 2-shard stacks pass every eligibility gate
    np.testing.assert_array_equal(_words(tc.container_to_dense(c)), stack)
    got = int(tc._count_container((c.kind, c.arrays, c.shape[0])))
    want = _jax_total(jc._count_container(
        (lambda j: (j.kind, j.arrays, j.shape[0]))(_jax_build(stack, mode))))
    assert got == want == _np_count(stack)


def test_from_host_takes_jax_arrays():
    conts = [_jax_build(_stack("runs"), "rle"),
             _jax_build(_stack("single_bit"), "sparse"),
             _jax_build(_stack("random_50pct"), "dense")]
    ported = [_port_from_jax(c) for c in conts]
    for c, p in zip(conts, ported):
        assert (p.kind, p.shape, p.nbytes, p.csig) \
            == (c.kind, c.shape, c.nbytes, c.csig)
        for a, b in zip(p.arrays, c.arrays):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(b).view(np.int32))
    csig = tuple(p.csig for p in ported)
    assert tc.flat_arity(csig) == 3 + 2 + 1
    assert tc.norm_csig(2) == (("dense",), ("dense",))
    back = tc.unflatten(csig, tc.flatten(ported))
    assert [b[0] for b in back] == ["rle", "sparse", "dense"]
    assert back[0][2] == 2 and back[2][2] == -1  # dense: size from array


def _ref_eval(sig, planes):
    if sig[0] == "leaf":
        return planes[sig[1]]
    op, subs = sig
    acc = _ref_eval(subs[0], planes)
    for s in subs[1:]:
        p = _ref_eval(s, planes)
        acc = {"&": acc & p, "|": acc | p, "^": acc ^ p,
               "-": acc & ~p}[op]
    return acc


KINDS = [("sparse", "sparse"), ("sparse", "sparse", "sparse"),
         ("rle", "rle"), ("sparse", "rle"), ("dense", "sparse"),
         ("dense", "dense")]


@pytest.mark.parametrize("op", ["&", "|"])
@pytest.mark.parametrize("kinds", KINDS, ids=["-".join(k) for k in KINDS])
def test_count_program_matches_reference(kinds, op):
    names = ("clustered_0.1pct", "runs", "single_bit")
    stacks = [_stack(n) for n in names[:len(kinds)]]
    conts = [_jax_build(st, k) for st, k in zip(stacks, kinds)]
    sig = (op, tuple(("leaf", i) for i in range(len(conts))))
    csig = tuple(c.csig for c in conts)
    want = _jax_total(jc.count_program(sig, csig, jc.flatten(conts),
                                       JaxStacked._tree_eval))
    ported = [_port_from_jax(c) for c in conts]
    got = int(tc.count_program(sig, tuple(p.csig for p in ported),
                               tc.flatten(ported)))
    assert got == want == _np_count(_ref_eval(sig, stacks))


def test_plane_program_matches_reference():
    stacks = [_stack("runs"), _stack("clustered_0.1pct")]
    conts = [_jax_build(stacks[0], "rle"), _jax_build(stacks[1], "sparse")]
    sig = ("&", (("leaf", 0), ("leaf", 1)))
    want = np.asarray(jc.plane_program(
        sig, tuple(c.csig for c in conts), jc.flatten(conts),
        JaxStacked._tree_eval))
    ported = [_port_from_jax(c) for c in conts]
    got = tc.plane_program(sig, tuple(p.csig for p in ported),
                           tc.flatten(ported))
    np.testing.assert_array_equal(_words(got), want)
    np.testing.assert_array_equal(want, stacks[0] & stacks[1])


# which plain version each count_program branch reaches (CPU tensors take
# the plain versions, so spies on them stand in for the launch counters)
ROUTES = [
    (("sparse",), ("leaf", 0), {"blocks": 1}),
    (("sparse", "sparse"), "&", {"fused": 1}),
    (("sparse", "sparse", "sparse"), "&", {"fused": 1}),
    (("rle",), ("leaf", 0), {}),
    (("rle", "rle"), "&", {}),
    (("sparse", "rle"), "&", {"k1": 1}),
    (("sparse", "sparse"), "|", {"k1": 1}),
    (("dense",), ("leaf", 0), {"k1": 1}),
]


@pytest.mark.parametrize("kinds,op,want", ROUTES,
                         ids=[f"{'-'.join(k)}{o if isinstance(o, str) else ''}"
                              for k, o, _ in ROUTES])
def test_count_program_routes(kinds, op, want, monkeypatch):
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(k2, "count_blocks_reference",
                        spy("blocks", k2.count_blocks_reference))
    monkeypatch.setattr(k2, "count_and_blocks_reference",
                        spy("fused", k2.count_and_blocks_reference))
    monkeypatch.setattr(k1, "count_expr_reference",
                        spy("k1", k1.count_expr_reference))
    names = ("clustered_0.1pct", "runs", "single_bit")
    stacks = [_stack(n) for n in names[:len(kinds)]]
    conts = [tc.build(st, "cpu", mode=k) for st, k in zip(stacks, kinds)]
    sig = op if len(kinds) == 1 else \
        (op, tuple(("leaf", i) for i in range(len(kinds))))
    got = tc.count_program(sig, tuple(c.csig for c in conts),
                           tc.flatten(conts))
    assert int(got) == _np_count(_ref_eval(sig, stacks))
    assert got.dtype == torch.int64
    assert calls == want


# ----------------------------------------------------------- K2 plain versions


def _blocks(rng, n):
    x = rng.integers(0, 2**32, size=(n, 128), dtype=np.uint64).astype(
        np.uint32)
    if n:
        x[0, :2] = [0xFFFFFFFF, 0x80000000]
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 33])
def test_plain_k2_matches_pallas(n):
    rng = np.random.default_rng(11 + n)
    a, b = _blocks(rng, n), _blocks(rng, n)
    want = int(pk.count_blocks_stack(a))
    want_and = int(pk.count_and_blocks_stack(a, b))
    assert want == _np_count(a) and want_and == _np_count(a & b)
    for fn in (k2.count_blocks_reference, k2.count_blocks):
        got = fn(_t(a))
        assert got.dtype == torch.int64 and int(got) == want
    # the fused entry over identical id arrays is the aligned TPU contract
    ids = torch.arange(n, dtype=torch.int32)
    for fn in (k2.count_and_blocks_reference, k2.count_and_blocks):
        assert int(fn(ids, _t(a), ids, _t(b))) == want_and


@pytest.mark.parametrize("nb_a,nb_b", [(8, 8), (16, 4), (4, 16), (33, 1),
                                       (1, 33)])
def test_fused_plain_matches_reference_intersect(nb_a, nb_b):
    """Ids only partly shared, sentinel padding on both sides, NB_b
    smaller and larger than NB_a."""
    rng = np.random.default_rng(nb_a * 100 + nb_b)
    pool = rng.choice(64, size=max(nb_a, nb_b) + 8, replace=False)

    def side(n, shared):
        real = max(1, n - 2)
        ids = np.sort(np.concatenate([
            shared[:real // 2],
            rng.choice(np.setdiff1d(pool, shared), real - real // 2,
                       replace=False)])).astype(np.int32)
        ids = np.unique(ids)[:real]
        out = np.full(n, k2.SPARSE_SENTINEL, dtype=np.int32)
        out[:len(ids)] = ids
        blocks = _blocks(rng, n)
        blocks[len(ids):] = 0
        return out, blocks

    shared = pool[:8]
    ids_a, blocks_a = side(nb_a, shared)
    ids_b, blocks_b = side(nb_b, shared)
    inter = jc.sparse_intersect_blocks(jnp.asarray(ids_a),
                                       jnp.asarray(blocks_a),
                                       jnp.asarray(ids_b),
                                       jnp.asarray(blocks_b))
    want = _np_count(np.asarray(inter))
    args = (_t(ids_a), _t(blocks_a), _t(ids_b), _t(blocks_b))
    for fn in (k2.count_and_blocks_reference, k2.count_and_blocks):
        got = fn(*args)
        assert got.dtype == torch.int64 and int(got) == want
    np.testing.assert_array_equal(
        _words(tc.sparse_intersect_blocks(*args)), np.asarray(inter))


def test_k2_rejects_bad_shapes():
    with pytest.raises(ValueError):
        k2.count_blocks(torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(TypeError):
        k2.count_blocks(torch.zeros((4, 128), dtype=torch.int64))
    z = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        k2.count_and_blocks(torch.zeros(3, dtype=torch.int32), z,
                            torch.zeros(4, dtype=torch.int32), z)


# ------------------------------------------------------------------ serving


ROW_PATTERN = {0: "empty", 1: "single_bit", 2: "clustered_0.1pct",
               3: "random_50pct", 4: "full", 5: "runs", 6: "alternating"}
WIDE_ROW, WIDE_SHARDS = 7, 8


def _columns(name, s):
    stack = _stack(name, s=s)
    cols = []
    for shard in range(s):
        bits = np.nonzero(np.unpackbits(
            stack[shard].view(np.uint8), bitorder="little"))[0]
        cols.append(shard * SHARD_WIDTH + bits.astype(np.uint64))
    return np.concatenate(cols)


QUERIES = (
    [f"Count(Row(f={r}))" for r in ROW_PATTERN]
    + [f"Count(Row(f={WIDE_ROW}))",
       "Count(Intersect(Row(f=2), Row(f=4)))",
       "Count(Intersect(Row(f=2), Row(f=2)))",
       "Count(Intersect(Row(f=5), Row(f=4)))",
       "Count(Intersect(Row(f=3), Row(f=5)))",
       f"Count(Intersect(Row(f={WIDE_ROW}), Row(f=5)))",
       "Count(Union(Row(f=1), Row(f=5), Row(f=2)))",
       "Count(Difference(Row(f=4), Row(f=5)))",
       "Row(f=2)", "Row(f=5)",
       "TopN(f, n=5)",
       "TopN(f, Row(f=4), n=3)"]
    # beyond the TPU package's corpus: a three-leaf & chain and filters
    # whose leaves hold two and three arrays each
    + ["Count(Intersect(Row(f=2), Row(f=3), Row(f=4)))",
       "TopN(f, Intersect(Row(f=5), Row(f=4)), n=3)",
       "TopN(f, Union(Row(f=2), Row(f=1)), n=4)"])
COUNT_QUERIES = tuple(q for q in QUERIES if q.startswith("Count"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The serving corpus of tests/test_containers.py, written by the TPU
    package and opened by both: (JAX executor, port holder, JAX dense
    answers)."""
    base = tmp_path_factory.mktemp("torch_containers")
    src = str(base / "src")
    h = JaxHolder(src, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    field = idx.create_field("f")
    for row, name in ROW_PATTERN.items():
        cols = _columns(name, 2)
        if len(cols):
            field.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
    wide = _columns("random_50pct", WIDE_SHARDS)
    field.import_bits(np.full(len(wide), WIDE_ROW, dtype=np.uint64), wide)
    h.close()
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jc.repr_mode()
    jc.configure("dense")
    try:
        jex = JaxExecutor(jh)
        # the dense answers, computed once for the whole module
        want = {q: [jax_to_json(r) for r in jex.execute("i", q)]
                for q in QUERIES}
    finally:
        jc.configure(prev)
    try:
        yield jex, th, want
    finally:
        jh.close()
        th.close()


def _run(holder, mode, queries=QUERIES):
    tc.configure(mode)
    ex = Executor(holder, device="cpu")
    return ex, {q: [result_to_json(r) for r in ex.execute("i", q)]
                for q in queries}


@pytest.mark.parametrize("mode", MODES)
def test_served_results_match_reference(corpus, mode):
    _, th, want = corpus
    assert want[f"Count(Row(f={WIDE_ROW}))"] == [
        _np_count(_stack("random_50pct", s=WIDE_SHARDS))]
    for row, name in ROW_PATTERN.items():
        assert want[f"Count(Row(f={row}))"] == [_np_count(_stack(name))]
    _, got = _run(th, mode)
    assert got == want


def _leaf_kinds(ex):
    return {key[3]: tc.kind_of(entry[1])
            for key, entry in ex._stacked._pools["leaf"].items()}


def test_auto_pool_holds_every_kind_and_rebuild_repicks(corpus):
    _, th, _ = corpus
    ex, _ = _run(th, "auto", COUNT_QUERIES)
    first = _leaf_kinds(ex)
    assert set(first.values()) == {"dense", "sparse", "rle"}, first
    # each form is the port's own choose(analyze(stack)) of its leaf
    st = ex._stacked
    view = th.index("i").field("f").view("standard")
    for key, entry in st._pools["leaf"].items():
        host = st._host_rows(view, [key[3]], key[4])[0]
        assert tc.kind_of(entry[1]) == tc.choose(tc.analyze(_t(host)),
                                                 *host.shape)
    assert st.cache_stats()["bytes"] == sum(
        e[2] for e in st._pools["leaf"].values())
    assert st.cache_stats()["bytes"] == sum(st.hbm_ledger().values())
    ex2, _ = _run(th, "auto", COUNT_QUERIES)  # a fresh pool rebuilds
    assert _leaf_kinds(ex2) == first, "repr flapped on rebuild"


@pytest.mark.parametrize("row,kind", [(2, "sparse"), (5, "rle")])
def test_set_on_compressed_leaf_decays_to_dense(corpus, row, kind):
    """A Set in one shard of a compressed leaf patches one plane, decays
    the entry to dense, reads the write back and keeps the pool's byte
    counter equal to its entries and to the HBM ledger."""
    jex, th, _ = corpus
    tc.configure("auto")
    ex = Executor(th, device="cpu")
    pql = f"Count(Row(f={row}))"
    base = ex.execute("i", pql)[0]
    st = ex._stacked
    assert _leaf_kinds(ex)[row] == kind
    bit = SHARD_WIDTH + 12345  # a column no pattern of the corpus sets
    stats = st.cache_stats()
    for e in (ex, jex):
        assert e.execute("i", f"Set({bit}, f={row})") == [True]
    assert ex.execute("i", pql) == jex.execute("i", pql) == [base + 1]
    after = st.cache_stats()
    assert after["patches"] == stats["patches"] + 1
    assert after["planes_uploaded"] == stats["planes_uploaded"] + 1
    assert _leaf_kinds(ex)[row] == "dense"
    ((key, entry),) = [(k, e) for k, e in st._pools["leaf"].items()
                       if k[3] == row]
    assert entry[2] == entry[1].nbytes == len(key[4]) * WORDS_PER_ROW * 4
    assert after["bytes"] == sum(e[2] for e in st._pools["leaf"].values())
    assert after["bytes"] == sum(st.hbm_ledger().values())
    for e in (ex, jex):
        assert e.execute("i", f"Clear({bit}, f={row})") == [True]
    assert ex.execute("i", pql) == [base]


@pytest.mark.parametrize("mode", MODES)
def test_server_container_repr_flag(tmp_path, mode):
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path), "--device", "cpu",
                        "--container-repr", mode])
    try:
        assert tc.repr_mode() == mode
    finally:
        srv.stop()


def test_server_container_repr_rejects_unknown(capsys):
    with pytest.raises(SystemExit):
        _parser().parse_args(["server", "--container-repr", "roaring"])
    assert "invalid choice" in capsys.readouterr().err
    assert _parser().parse_args(["server"]).container_repr is None
