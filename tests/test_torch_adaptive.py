"""The port's adaptive execution engine (exec/adaptive.py and its hooks
in the executor and the evaluator) against the TPU package's, on the
CPU.

Every case of `tests/test_adaptive.py` runs in one pytest process: the
engine's unit oracles on both packages' modules alike (they are the
same host code), and the integration cases on the port (device="cpu")
with its answers held to the TPU package's over the same corpus:
`--adaptive on` answers exactly as `off` does across stacked counts,
per-shard fallbacks, pairwise GroupBy, compressed containers and
batched counts; `shadow` leaves every side effect untouched; the
benefit-score eviction keeps a hot entry LRU would strip; proactive
admission converges /debug/heat. Tolerance: exact equality.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.exec as jax_exec  # noqa: E402
import pilosa_tpu.exec.adaptive as jax_adaptive  # noqa: E402
import pilosa_tpu.exec.plan as jax_plan  # noqa: E402
import pilosa_tpu.exec.stacked as jax_stacked  # noqa: E402
import pilosa_tpu.ops.containers as jax_cont  # noqa: E402
import pilosa_tpu.utils.stats as jax_stats  # noqa: E402
import pilosa_tpu.utils.workload as jax_workload  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.exec as torch_exec  # noqa: E402
import pilosa_tpu_torch.exec.adaptive as torch_adaptive  # noqa: E402
import pilosa_tpu_torch.exec.plan as torch_plan  # noqa: E402
import pilosa_tpu_torch.exec.stacked as torch_stacked  # noqa: E402
import pilosa_tpu_torch.ops.containers as torch_cont  # noqa: E402
import pilosa_tpu_torch.utils.stats as torch_stats  # noqa: E402
import pilosa_tpu_torch.utils.workload as torch_workload  # noqa: E402
from pilosa_tpu_torch.core.view import VIEW_STANDARD  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(
        name="jax", core=jax_core, exec=jax_exec, adaptive=jax_adaptive,
        plan=jax_plan, stacked=jax_stacked, cont=jax_cont,
        stats=jax_stats.global_stats, workload=jax_workload, ex_kw={}),
    "port": SimpleNamespace(
        name="port", core=torch_core, exec=torch_exec,
        adaptive=torch_adaptive, plan=torch_plan, stacked=torch_stacked,
        cont=torch_cont, stats=torch_stats.global_stats,
        workload=torch_workload, ex_kw={"device": "cpu"}),
}
PORT = PKGS["port"]
BOTH = pytest.mark.parametrize("name", ["jax", "port"])


@pytest.fixture(autouse=True)
def _isolate():
    """Adaptive state is module-singleton: reset the engine, the heat
    ledger and any container repr overrides of both packages around
    every test, and restore the stack-cache budgets tests shrink."""
    saved = {n: (p.stacked.MAX_STACK_BYTES, p.cont.repr_mode(),
                 p.cont.AUTO_COMPRESS_FLOOR) for n, p in PKGS.items()}
    for p in PKGS.values():
        p.adaptive.reset()
        p.workload.reset()
    yield
    for n, p in PKGS.items():
        p.stacked.MAX_STACK_BYTES = saved[n][0]
        p.cont.configure(saved[n][1])
        p.cont.AUTO_COMPRESS_FLOOR = saved[n][2]
        p.cont.reset_ledger()
        p.adaptive.reset()
        p.workload.reset()


# ------------------------------------------------------------ unit oracles


@BOTH
def test_modes_and_reset(name):
    adaptive = PKGS[name].adaptive
    assert adaptive.mode() == "off"
    assert not adaptive.enabled() and not adaptive.acting()
    adaptive.configure(mode="shadow")
    assert adaptive.enabled() and not adaptive.acting()
    adaptive.configure(mode="on")
    assert adaptive.enabled() and adaptive.acting()
    with pytest.raises(ValueError):
        adaptive.configure(mode="sometimes")
    adaptive.reset()
    assert adaptive.mode() == "off"


@BOTH
def test_off_mode_is_inert(name):
    """Mode off: no decisions, no learning — the static-path guarantee
    reduces to these early returns plus the callers' enabled() gates."""
    adaptive = PKGS[name].adaptive
    assert adaptive.decide_strategy("Count", {"count": 1}, 4) is None
    assert adaptive.decide_tile(64, 10, 10) is None
    adaptive.observe_fallback("Count", 0.5, 4)
    adaptive.observe_pairwise(64, 0.01)
    adaptive.note_wall_misestimate({"count": 2}, 0.5)
    adaptive.note_repr_misestimate("i", ["f"])
    snap = adaptive.snapshot()
    assert snap["calibration"]["fallback"] == {}
    assert snap["calibration"]["pairwise_tiles"] == {}
    assert snap["recent"] == []
    assert snap["calibration_bumps"] == {}


@BOTH
def test_benefit_score_shape(name):
    adaptive = PKGS[name].adaptive
    assert adaptive.benefit_score(5.0, 1024) > adaptive.benefit_score(
        1.0, 1024)
    assert adaptive.benefit_score(1.0, 1 << 20) < adaptive.benefit_score(
        1.0, 1 << 10)
    assert adaptive.benefit_score(0.0, 1 << 30) == 0.0


@BOTH
def test_select_victim_prefers_cold_and_large(name):
    adaptive = PKGS[name].adaptive
    assert adaptive.select_victim(
        [("hot", 5.0, 1024), ("cold", 0.1, 1024)]) == "cold"
    assert adaptive.select_victim(
        [("small", 1.0, 1024), ("big", 1.0, 1 << 24)]) == "big"
    assert adaptive.select_victim(
        [("lru", 1.0, 1024), ("mru", 1.0, 1024)]) == "lru"


@BOTH
def test_decide_strategy_default_calibration(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="on")
    dec = adaptive.decide_strategy("Count", {"_unit_probe": 1}, 4)
    assert dec.strategy == "stacked" and dec.act
    assert dec.source == "default"
    assert "cost-model" in dec.chosen_by and "ms" in dec.chosen_by
    dec = adaptive.decide_strategy("Count", {"_unit_probe": 1}, 4,
                                   missing_bytes=1 << 34)
    assert dec.strategy == "fallback"
    assert dec.est_stacked > dec.est_fallback


@BOTH
def test_decide_strategy_learns_from_fallback_walls(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="on")
    for _ in range(3):
        adaptive.observe_fallback("Count", 2e-6, 2)
    dec = adaptive.decide_strategy("Count", {"_unit_probe": 1}, 2)
    assert dec.strategy == "fallback"
    assert dec.source == "default"
    snap = adaptive.snapshot()
    assert snap["calibration"]["fallback"]["Count"]["samples"] == 3


@BOTH
def test_decide_strategy_shadow_never_acts(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="shadow")
    dec = adaptive.decide_strategy("Count", {"_unit_probe": 1}, 4)
    assert dec is not None and not dec.act
    adaptive.observe_fallback("Count", 0.5, 4)
    snap = adaptive.snapshot()
    assert snap["decisions"]["strategy"]["Count"]["stacked"] == 1
    assert snap["calibration"]["fallback"]["Count"]["samples"] == 1


@BOTH
def test_decide_tile_static_without_samples(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="on")
    dec = adaptive.decide_tile(64, 100, 100)
    assert dec.tile == 64 and dec.act
    assert dec.source == "default"
    assert set(dec.estimates) == {64, 32, 16, 8}


@BOTH
def test_decide_tile_shrinks_when_cells_dominate(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="on")
    adaptive.observe_pairwise(8, 1e-4)
    adaptive.observe_pairwise(64, 0.4)
    dec = adaptive.decide_tile(64, 10, 10)
    assert 10 <= dec.tile < 64
    assert dec.source == "ewma"
    assert dec.estimates[dec.tile] <= dec.estimates[64]


@BOTH
def test_decide_tile_forced_override(name):
    adaptive = PKGS[name].adaptive
    adaptive.configure(mode="on")
    adaptive.set_forced_tile(16)
    assert adaptive.decide_tile(64, 100, 100).tile == 16
    adaptive.set_forced_tile(None)
    assert adaptive.decide_tile(64, 100, 100).tile == 64


@BOTH
def test_stats_timing_ewma_satellite(name):
    """The kernel_seconds series keeps a recency-weighted EWMA beside
    the cumulative /metrics fields, which stay untouched. Its own
    series name: tests/test_adaptive.py counts the samples of
    `_ewma_probe` in the TPU package's global stats, which this test
    shares when both files run in one process."""
    stats = PKGS[name].stats
    tags = {"kernel": "_ewma_probe_both"}
    stats.timing("kernel_seconds", 0.010, tags)
    stats.timing("kernel_seconds", 0.020, tags)
    ew = {dict(k[1]).get("kernel"): v
          for k, v in stats.timing_ewma("kernel_seconds").items()}
    ewma, n = ew["_ewma_probe_both"]
    assert n >= 2
    stats.timing_ewma_force("kernel_seconds", 0.5, tags)
    ew = {dict(k[1]).get("kernel"): v
          for k, v in stats.timing_ewma("kernel_seconds").items()}
    assert ew["_ewma_probe_both"] == (0.5, n)


@BOTH
def test_wall_misestimate_reseeds_calibration(name):
    adaptive, stats = PKGS[name].adaptive, PKGS[name].stats
    adaptive.configure(mode="on")
    stats.timing("kernel_seconds", 1e-4, {"kernel": "_mis_probe"})
    adaptive.note_wall_misestimate({"_mis_probe": 2}, 0.2)
    secs, src = adaptive.dispatch_seconds("_mis_probe")
    assert src == "ewma"
    assert secs == pytest.approx(0.1)
    assert adaptive.snapshot()["calibration_bumps"]["_mis_probe"] == 1


@BOTH
def test_repr_misestimate_strikes_force_dense(name):
    adaptive, cont = PKGS[name].adaptive, PKGS[name].cont
    adaptive.configure(mode="shadow")
    adaptive.note_repr_misestimate("i", ["f"])
    adaptive.note_repr_misestimate("i", ["f"])
    assert cont.repr_override("i", "f") is None
    assert adaptive.snapshot()["repr_strikes"]["i/f"] == 2
    adaptive.reset()
    adaptive.configure(mode="on")
    adaptive.note_repr_misestimate("i", ["f"])
    assert cont.repr_override("i", "f") is None
    adaptive.note_repr_misestimate("i", ["f"])
    assert cont.repr_override("i", "f") == "dense"
    cont.reset_ledger()
    assert cont.repr_override("i", "f") is None


def test_repr_override_forces_the_port_build_dense():
    """A forced-dense override wins over the auto chooser at the next
    build (and only under auto), and the ledger records every build."""
    cont = PORT.cont
    host = np.zeros((4, SHARD_WIDTH // 32), np.uint32)
    host[:, 7] = 1
    cont.configure("auto")
    cont.AUTO_COMPRESS_FLOOR = 0
    assert cont.build(host, "cpu", fragment=("i", "f", "standard", 1)) \
        .kind != "dense"
    cont.set_repr_override("i", "f", "dense")
    built = cont.build(host, "cpu", fragment=("i", "f", "standard", 1))
    assert built.kind == "dense" and built.meta["ratio"] == 1.0
    assert cont.fragment_estimate("i", "f", "standard", 1)["repr"] == \
        "dense"
    assert cont.field_estimate("i", "f")["reprs"] == ["dense"]
    assert cont.build(host, "cpu", mode="sparse",
                      fragment=("i", "f", "standard", 1)).kind == "sparse"


# ------------------------------------------------------ differential corpus


def _populate(pkg, h):
    """Multi-shard corpus covering every adaptive decision point: set
    fields for Count/TopN/GroupBy (3 shards, above MIN_SHARDS), a BSI
    int field for Sum/Min/Max, and a single-shard field whose queries
    stay on the per-shard fallback."""
    idx = h.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(7)
    rows, cols = [], []
    for row in range(6):
        for shard in range(3):
            n = int(rng.integers(1, 40))
            c = rng.choice(SHARD_WIDTH, size=n, replace=False)
            rows.extend([row] * n)
            cols.extend((shard * SHARD_WIDTH + c).tolist())
    f.import_bits(np.asarray(rows, dtype=np.uint64),
                  np.asarray(cols, dtype=np.uint64))
    g = idx.create_field("g")
    g.import_bits(
        np.asarray([10] * 3 + [11] * 3, dtype=np.uint64),
        np.asarray([0, 5, SHARD_WIDTH + 1, 7, SHARD_WIDTH + 9,
                    2 * SHARD_WIDTH + 3], dtype=np.uint64))
    idx.create_field("n", pkg.core.FieldOptions.int_field(min=-1000,
                                                          max=1000))
    e = pkg.exec.Executor(h, **pkg.ex_kw)
    e.execute("i", "Set(1, n=100) Set(2, n=-300) Set(3, n=42)"
                   f" Set({SHARD_WIDTH + 4}, n=7)"
                   f" Set({2 * SHARD_WIDTH + 8}, n=-9)")
    s = idx.create_field("s")
    s.import_bits(np.asarray([1, 1, 2], dtype=np.uint64),
                  np.asarray([0, 3, 4], dtype=np.uint64))
    return idx


QUERIES = (
    "Count(Row(f=0))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=0), Row(f=3), Row(f=5)))",
    "Count(Row(s=1))",                       # single shard: fallback
    "Row(f=4)",
    "Sum(field=n)",
    "Sum(Row(f=1), field=n)",
    "Min(field=n)",
    "Max(field=n)",
    "TopN(f, n=4)",
    "TopN(f, Row(g=10), n=3)",
    "GroupBy(Rows(f, limit=3), Rows(g))",    # pairwise tiles
    "GroupBy(Rows(g))",                      # single-field row_counts
)

#: batched counts (the query-batch route)
BATCH = ["Count(Row(f=%d))" % r for r in range(4)]


def _norm(r):
    cols = getattr(r, "columns", None)
    if callable(cols):
        return ("row", tuple(int(c) for c in cols()))
    if isinstance(r, (list, tuple)):
        return tuple(_norm(x) for x in r)
    if hasattr(r, "group"):
        return ("group", tuple((fr.field, fr.row_id) for fr in r.group),
                r.count)
    if hasattr(r, "val"):
        return ("vc", r.val, r.count)
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", r.id, r.count)
    return r


def _run_corpus(pkg, holder, repeat=2):
    """Fresh executor, the full corpus `repeat` times (cold build then
    warm cache), plus one batched round. Returns (executor, results)."""
    ex = pkg.exec.Executor(holder, **pkg.ex_kw)
    out = []
    for _ in range(repeat):
        for q in QUERIES:
            out.append(_norm(ex.execute("i", q)))
    for results, error, *_ in ex.execute_batch("i", BATCH):
        assert error is None
        out.append(_norm(results))
    return ex, out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    holders = {}
    for name, pkg in PKGS.items():
        h = pkg.core.Holder(str(tmp_path_factory.mktemp(f"ad-{name}")),
                            use_snapshot_queue=False).open()
        _populate(pkg, h)
        holders[name] = h
    yield holders
    for h in holders.values():
        h.close()


def _baseline(pkg, holder):
    """Mode-off answers under the container config the adaptive run
    uses (auto, floor 0)."""
    pkg.adaptive.reset()
    pkg.cont.AUTO_COMPRESS_FLOOR = 0
    pkg.cont.configure("auto")
    return _run_corpus(pkg, holder)[1]


def test_adaptive_on_bit_identical(corpus):
    """--adaptive on answers exactly like off over stacked, fallback,
    pairwise GroupBy, compressed containers and batched counts — and
    like the TPU package."""
    want = _baseline(PORT, corpus["port"])
    assert want == _baseline(PKGS["jax"], corpus["jax"])
    PORT.adaptive.configure(mode="on")
    ex, got = _run_corpus(PORT, corpus["port"])
    assert got == want
    snap = PORT.adaptive.snapshot(stacked=ex._stacked)
    assert sum(n for per_op in snap["decisions"]["strategy"].values()
               for n in per_op.values()) > 0


def test_shadow_zero_side_effects(corpus):
    """Shadow prices and logs every decision but acts on none: answers,
    cache-pool contents, and repr overrides all match mode off."""
    want = _baseline(PORT, corpus["port"])
    ex_off, _ = _run_corpus(PORT, corpus["port"])
    pools = ex_off._stacked._pools
    off_pools = (sorted(map(str, pools["leaf"])),
                 sorted(map(str, pools["rows"])))
    PORT.adaptive.configure(mode="shadow")
    ex, got = _run_corpus(PORT, corpus["port"])
    assert got == want
    pools = ex._stacked._pools
    assert (sorted(map(str, pools["leaf"])),
            sorted(map(str, pools["rows"]))) == off_pools
    assert PORT.cont.repr_overrides() == {}
    snap = PORT.adaptive.snapshot(stacked=ex._stacked)
    assert snap["mode"] == "shadow"
    assert snap["recent"]
    assert snap["decisions"]["cache"]["benefit_evictions"] == 0


def test_explain_chosen_by_dispatch_free(corpus):
    """EXPLAIN surfaces chosen_by + both priced alternatives from the
    plan path with ZERO launches."""
    PORT.adaptive.configure(mode="on")
    ex = PORT.exec.Executor(corpus["port"], device="cpu")
    before = ex._stacked.dispatches

    def walk(node):
        yield node
        for c in node.get("children", ()):
            yield from walk(c)

    anns = []
    for q in ("Count(Row(f=0))", "Sum(field=n)",
              "GroupBy(Rows(f, limit=3), Rows(g))"):
        assert ex.execute("i", q, options=PORT.exec.ExecOptions(
            explain="plan")) == []
        plan = PORT.plan.take_last()
        assert plan is not None, q
        anns.extend(n["annotations"] for call in plan["calls"]
                    for n in walk(call)
                    if "chosen_by" in n.get("annotations", {}))
    assert ex._stacked.dispatches == before
    assert anns, "no chosen_by annotation on any plan node"
    for ann in anns:
        assert "cost-model" in ann["chosen_by"]
        alt = ann["alternatives"]
        assert set(alt) >= {"stacked_ms", "fallback_ms", "cost_source"}
        assert alt["cost_source"] in ("ewma", "cost_analysis", "default")


def test_debug_optimizer_snapshot_shape(corpus):
    PORT.adaptive.configure(mode="on")
    ex, _ = _run_corpus(PORT, corpus["port"], repeat=1)
    snap = PORT.adaptive.snapshot(stacked=ex._stacked)
    assert snap["mode"] == "on"
    assert set(snap["calibration"]) == {
        "kernels", "fallback", "pairwise_tiles",
        "default_dispatch_seconds"}
    for entry in snap["calibration"]["kernels"].values():
        assert entry["source"] in ("ewma", "cost_analysis", "default")
    assert set(snap["decisions"]) == {
        "strategy", "tile", "cache", "admission", "patch"}
    json.dumps(snap)
    counts = PORT.adaptive.decision_counts()
    assert set(counts) == {"strategy", "tile", "cache", "admission",
                           "patch"}
    json.dumps(counts)


def test_adaptive_tile_launches_k4_at_the_chosen_tile(corpus):
    """With the tile pinned (the bench sweep's hook), the engine's tile
    decision reaches the evaluator: K4 launches at that tile and the
    answer is equal to mode off."""
    want = _norm(PORT.exec.Executor(corpus["port"], device="cpu").execute(
        "i", "GroupBy(Rows(f), Rows(g))"))
    PORT.adaptive.configure(mode="on")
    # an expensive taught fallback keeps the GroupBy on the stacked path
    PORT.adaptive.observe_fallback("GroupBy", 100.0, 1)
    PORT.adaptive.set_forced_tile(2)
    ex = PORT.exec.Executor(corpus["port"], device="cpu")
    seen = []
    real = PORT.stacked._pairwise_kernel

    def spy(a, b, filt=None):
        seen.append((a.shape[0], b.shape[0]))
        return real(a, b, filt)

    PORT.stacked._pairwise_kernel = spy
    try:
        got = _norm(ex.execute("i", "GroupBy(Rows(f), Rows(g))"))
    finally:
        PORT.stacked._pairwise_kernel = real
    assert got == want
    # f has 6 rows and g 2: tile 2 gives 3 x 1 launches of [2, 2]
    assert seen == [(2, 2)] * 3
    assert PORT.adaptive.decision_counts()["tile"] == {"2": 1}


# ------------------------------------------------- cache policy integration


def _three_fields(pkg, tmp_path):
    h = pkg.core.Holder(str(tmp_path / pkg.name),
                        use_snapshot_queue=False).open()
    idx = h.create_index("i")
    for fname in ("hot", "cold", "late"):
        fld = idx.create_field(fname)
        fld.import_bits(
            np.asarray([1, 1], dtype=np.uint64),
            np.asarray([0, SHARD_WIDTH + 1], dtype=np.uint64))
    return h


def _eviction_run(pkg, tmp_path, mode):
    """Fill the leaf pool with hot then cold, heat hot far above them,
    shrink the budget to what is resident and insert late: the fields
    left resident and the cache decision counters."""
    h = _three_fields(pkg, tmp_path)
    try:
        pkg.adaptive.configure(mode=mode)
        # pin the strategy side: an expensive taught fallback keeps all
        # three Counts on the stacked path
        pkg.adaptive.observe_fallback("Count", 100.0, 1)
        ex = pkg.exec.Executor(h, **pkg.ex_kw)
        ex.execute("i", "Count(Row(hot=1))")   # oldest entry = LRU victim
        ex.execute("i", "Count(Row(cold=1))")
        st = ex._stacked
        pool = st._stacks if pkg.name == "jax" else st._pools["leaf"]
        assert len(pool) == 2
        for _ in range(50):
            pkg.workload.heat_bump("i", "hot", VIEW_STANDARD)
        pkg.stacked.MAX_STACK_BYTES = st._stack_bytes \
            if pkg.name == "jax" else st._pool_bytes["leaf"]
        ex.execute("i", "Count(Row(late=1))")
        return (sorted(k[2] for k in pool),
                pkg.adaptive.snapshot()["decisions"]["cache"])
    finally:
        h.close()


def test_benefit_eviction_keeps_hot_entry(tmp_path):
    """Constrained budget, one hot field: the benefit policy (on) keeps
    it and sheds a cold one instead — as the TPU package does."""
    ref = _eviction_run(PKGS["jax"], tmp_path, "on")
    got = _eviction_run(PORT, tmp_path, "on")
    fields, cache = got
    assert "hot" in fields, f"benefit policy evicted the hot entry: {fields}"
    assert "cold" not in fields
    assert cache["benefit_evictions"] >= 1
    assert cache["lru_evictions"] == 0
    assert got == ref


def test_shadow_eviction_is_lru_but_counts_divergence(tmp_path):
    ref = _eviction_run(PKGS["jax"], tmp_path, "shadow")
    got = _eviction_run(PORT, tmp_path, "shadow")
    fields, cache = got
    assert "hot" not in fields
    assert cache["lru_evictions"] >= 1
    assert cache["benefit_evictions"] == 0
    assert cache["shadow_divergences"] >= 1
    assert got == ref


# ------------------------------------------------------ proactive admission


def test_proactive_admission_converges_heat(tmp_path):
    """Demand heat without residency -> maybe_proactive_admit builds the
    stack in the idle window, the heat ledger converges (the fragment
    leaves hot_but_not_resident), and the admission counter moves."""
    h = PORT.core.Holder(str(tmp_path / "d"),
                         use_snapshot_queue=False).open()
    try:
        idx = h.create_index("i")
        fld = idx.create_field("f")
        fld.import_bits(
            np.asarray([1, 1, 2], dtype=np.uint64),
            np.asarray([0, SHARD_WIDTH + 1, 5], dtype=np.uint64))
        PORT.adaptive.configure(mode="on")
        ex = PORT.exec.Executor(h, device="cpu")
        for _ in range(10):
            PORT.workload.heat_bump("i", "f", VIEW_STANDARD)
        report = PORT.workload.heat().report(ex._stacked.hbm_snapshot(top=0))
        assert any(c["field"] == "f"
                   for c in report["hot_but_not_resident"])
        before = PORT.adaptive.decision_counts()["admission"]
        assert ex.maybe_proactive_admit() >= 1
        after = PORT.adaptive.decision_counts()["admission"]
        assert after["admitted_fragments"] > before["admitted_fragments"]
        assert after["admitted_rows"] > 0 and after["admitted_bytes"] > 0
        report = PORT.workload.heat().report(ex._stacked.hbm_snapshot(top=0))
        assert not any(c["field"] == "f"
                       for c in report["hot_but_not_resident"])
        assert PORT.workload.heat().value("i", "f", VIEW_STANDARD) == \
            pytest.approx(PORT.workload.HEAT_HOT_MIN, rel=1e-3)
        misses = ex._stacked.misses
        assert _norm(ex.execute("i", "Row(f=1)"))[0] == (
            "row", (0, SHARD_WIDTH + 1))
        assert ex._stacked.misses == misses
    finally:
        h.close()


def test_proactive_admission_shadow_counts_only(tmp_path):
    h = PORT.core.Holder(str(tmp_path / "d"),
                         use_snapshot_queue=False).open()
    try:
        idx = h.create_index("i")
        fld = idx.create_field("f")
        fld.import_bits(
            np.asarray([1, 1], dtype=np.uint64),
            np.asarray([0, SHARD_WIDTH + 1], dtype=np.uint64))
        PORT.adaptive.configure(mode="shadow")
        ex = PORT.exec.Executor(h, device="cpu")
        for _ in range(10):
            PORT.workload.heat_bump("i", "f", VIEW_STANDARD)
        assert ex.maybe_proactive_admit() == 0
        counts = PORT.adaptive.decision_counts()["admission"]
        assert counts["shadow_candidates"] >= 1
        assert counts["admitted_fragments"] == 0
        assert len(ex._stacked._pools["leaf"]) == 0  # nothing built
    finally:
        h.close()


def test_proactive_admission_off_is_noop(tmp_path):
    h = PORT.core.Holder(str(tmp_path / "d"),
                         use_snapshot_queue=False).open()
    try:
        idx = h.create_index("i")
        fld = idx.create_field("f")
        fld.import_bits(np.asarray([1], dtype=np.uint64),
                        np.asarray([0], dtype=np.uint64))
        ex = PORT.exec.Executor(h, device="cpu")
        for _ in range(10):
            PORT.workload.heat_bump("i", "f", VIEW_STANDARD)
        assert ex.maybe_proactive_admit() == 0
        assert PORT.adaptive.decision_counts()["admission"]["rounds"] == 0
    finally:
        h.close()
