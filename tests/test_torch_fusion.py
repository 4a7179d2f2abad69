"""The port's whole-plan fusion (exec/fusion.py, StackedEvaluator.
fused_count, containers.count_program_multi) against the TPU package's,
on the CPU.

Every case of `tests/test_fusion.py` runs on both packages (the port on
device="cpu", where K1's multi-tree entry takes its plain version):
modes and knobs, the adaptive fuse-vs-interpret oracles, the frequency
gate, bit identity over dense, sparse and run-length leaves and 1..3-call
queries, the one-dispatch warm query, literal sharing, shadow's zero side
effects, LRU eviction dropping the cached program table, the `fused`
dispatch family with its `compile` phase, GroupBy staying interpreted,
the EXPLAIN annotations and the analyze grafting, /debug/fusion, the
SLOW QUERY `fused=` field and the CLI flags. Each served case runs the
same corpus and the same queries through both packages and compares the
answers with each other and with each package's interpreted loop, and
the decision counters, program ledgers and annotations between the
packages.

Beside them: a fused Count over an overlay-carrying leaf (the streaming
ingest merge's term), the routes one fused query takes (one multi-tree
K1 call, K2 for the sparse members, none for the run-length pair), and a
kernel wrapper's CUDA failure propagating out of a fused query instead
of falling back.
"""

import io
import re
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.exec as jax_exec  # noqa: E402
import pilosa_tpu.exec.adaptive as jax_adaptive  # noqa: E402
import pilosa_tpu.exec.fusion as jax_fusion  # noqa: E402
import pilosa_tpu.exec.plan as jax_plan  # noqa: E402
import pilosa_tpu.ops.containers as jax_cont  # noqa: E402
import pilosa_tpu.server.api as jax_api  # noqa: E402
import pilosa_tpu.utils.profile as jax_profile  # noqa: E402
import pilosa_tpu.utils.workload as jax_workload  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.exec as torch_exec  # noqa: E402
import pilosa_tpu_torch.exec.adaptive as torch_adaptive  # noqa: E402
import pilosa_tpu_torch.exec.fusion as torch_fusion  # noqa: E402
import pilosa_tpu_torch.exec.plan as torch_plan  # noqa: E402
import pilosa_tpu_torch.ops.containers as torch_cont  # noqa: E402
import pilosa_tpu_torch.server.api as torch_api  # noqa: E402
import pilosa_tpu_torch.utils.profile as torch_profile  # noqa: E402
import pilosa_tpu_torch.utils.workload as torch_workload  # noqa: E402
from pilosa_tpu.pql import parse as jax_parse  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as k1  # noqa: E402
from pilosa_tpu_torch.pql import parse  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402
from pilosa_tpu_torch.server.http_server import PilosaHTTPServer  # noqa: E402,E501
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils.logger import CaptureLogger  # noqa: E402
from tests.harness import ServerHarness as JaxHarness  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(
        name="jax", core=jax_core, exec=jax_exec, fusion=jax_fusion,
        adaptive=jax_adaptive, plan=jax_plan, cont=jax_cont,
        workload=jax_workload, profile=jax_profile, parse=jax_parse,
        api=jax_api, ex_kw={}),
    "port": SimpleNamespace(
        name="port", core=torch_core, exec=torch_exec, fusion=torch_fusion,
        adaptive=torch_adaptive, plan=torch_plan, cont=torch_cont,
        workload=torch_workload, profile=torch_profile, parse=parse,
        api=torch_api, ex_kw={"device": "cpu"}),
}
BOTH = tuple(PKGS.values())


@pytest.fixture(autouse=True)
def _isolate():
    """Fusion state is module-singleton in each package (like
    exec/adaptive.py): reset both packages' program ledgers, the
    adaptive engines they consult and the workload tables that drive
    compile admission around every test."""
    saved = {p.name: (p.cont.repr_mode(), p.cont.AUTO_COMPRESS_FLOOR)
             for p in BOTH}

    def reset():
        for p in BOTH:
            p.fusion.reset()
            p.adaptive.reset()
            p.workload.reset()
            p.plan.clear_recent()

    reset()
    yield
    for p in BOTH:
        p.cont.configure(saved[p.name][0])
        p.cont.AUTO_COMPRESS_FLOOR = saved[p.name][1]
    reset()


def _executor(pkg, holder):
    return pkg.exec.Executor(holder, **pkg.ex_kw)


def _strip(snap):
    """A /debug/fusion snapshot without its wall-clock numbers and shard
    buckets (the TPU package pads the shard axis to its 8 test devices,
    trap 27; the port's bucket is the shard count)."""
    out = dict(snap)
    out["programs"] = [{k: v for k, v in e.items()
                        if k not in ("compile_ms", "age_seconds",
                                     "last_hit_age_seconds", "bucket")}
                       for e in snap["programs"]]
    return out


# ------------------------------------------------------------ unit oracles


def test_modes_and_reset():
    for pkg in BOTH:
        fusion = pkg.fusion
        assert fusion.mode() == "off"
        assert not fusion.enabled() and not fusion.acting()
        fusion.configure(mode="shadow")
        assert fusion.enabled() and not fusion.acting()
        fusion.configure(mode="on")
        assert fusion.enabled() and fusion.acting()
        with pytest.raises(ValueError):
            fusion.configure(mode="sometimes")
        fusion.reset()
        assert fusion.mode() == "off"
        assert fusion.min_hits() == fusion.DEFAULT_MIN_HITS
    assert torch_fusion.MODES == jax_fusion.MODES
    assert torch_fusion.DEFAULT_MIN_HITS == jax_fusion.DEFAULT_MIN_HITS
    assert torch_fusion.DEFAULT_CACHE_SIZE == jax_fusion.DEFAULT_CACHE_SIZE


def test_configure_clamps_knobs():
    for pkg in BOTH:
        pkg.fusion.configure(cache_size=0)  # floor: a 0-slot cache is off,
        snap = pkg.fusion.snapshot()        # and off exists as a mode
        assert snap["cache_size"] == 1
        pkg.fusion.configure(min_hits=-5)
        assert pkg.fusion.min_hits() == 0
    assert torch_fusion.snapshot() == jax_fusion.snapshot()


def test_off_mode_is_inert():
    """Mode off: the executor hook is maybe_execute's first return —
    no executor attribute is ever touched, so None stands in for one."""
    for pkg in BOTH:
        fusion = pkg.fusion
        assert fusion.maybe_execute(None, None, None, None, None) is None
        assert fusion.last_fused() == 0
        snap = fusion.snapshot()
        assert snap["mode"] == "off"
        assert snap["entries"] == 0 and snap["programs"] == []
        assert all(v == 0 for v in fusion.decision_counts().values())
    assert torch_fusion.decision_counts() == jax_fusion.decision_counts()


def test_note_fused_take_last():
    for pkg in BOTH:
        pkg.fusion.note_fused(3)
        assert pkg.fusion.last_fused() == 3
        pkg.fusion.note_fused(0)  # the executor's per-query reset
        assert pkg.fusion.last_fused() == 0


def test_decide_fuse_pricing():
    """Adaptive fuse-vs-interpret oracles on both engines: a cached
    program strictly dominates; a cold build on a rare shape loses to
    interpreting a single call; frequency amortizes the build away."""
    got = {}
    for pkg in BOTH:
        adaptive = pkg.adaptive
        assert adaptive.decide_fuse(2, 5, True) is None  # engine off
        adaptive.configure(mode="on")
        decs = []
        dec = adaptive.decide_fuse(1, 1, True)
        assert dec.fuse and dec.act                  # sunk build: fuse
        assert dec.est_fused <= dec.est_interpret
        decs.append(dec)
        dec = adaptive.decide_fuse(1, 1, False)      # compile/1 >> saved
        assert not dec.fuse
        decs.append(dec)
        dec = adaptive.decide_fuse(4, 10_000, False)  # amortized away
        assert dec.fuse
        assert "cost-model" in dec.chosen_by and "ms" in dec.chosen_by
        decs.append(dec)
        counts = adaptive.decision_counts()["strategy"]
        assert sum(n for k, n in counts.items()
                   if k.startswith("Fuse:")) == 3
        # the estimates read each process's measured dispatch history,
        # which other tests in the same process move: compare verdicts
        got[pkg.name] = [(d.fuse, d.act, d.est_fused <= d.est_interpret,
                          d.chosen_by.split(" (")[0]) for d in decs]
    assert got["port"] == got["jax"]


def test_decide_fuse_shadow_does_not_act():
    for pkg in BOTH:
        pkg.adaptive.configure(mode="shadow")
        dec = pkg.adaptive.decide_fuse(1, 1, False)
        assert not dec.fuse and not dec.act  # priced, logged, never vetoes


def test_fingerprint_hits_is_not_an_access(tmp_path):
    """workload.fingerprint_hits reads the frequency count WITHOUT
    touching the entry (the admission gate must not inflate the signal
    it reads) — the same fingerprint and count in both packages."""
    fps = []
    for pkg in BOTH:
        h = pkg.core.Holder(str(tmp_path / pkg.name),
                            use_snapshot_queue=False).open()
        try:
            idx = h.create_index("i")
            idx.create_field("f")
            ex = _executor(pkg, h)
            ex.execute("i", "Count(Row(f=1))")
            ex.execute("i", "Count(Row(f=2))")  # same shape, other literal
            fp, _ = pkg.workload.fingerprint(
                "i", pkg.parse("Count(Row(f=3))"))
            assert pkg.workload.fingerprint_hits(fp) == 2
            for _ in range(50):  # probing must not count as traffic
                pkg.workload.fingerprint_hits(fp)
            assert pkg.workload.fingerprint_hits(fp) == 2
            assert pkg.workload.fingerprint_hits("0" * 16) == 0
            fps.append(fp)
        finally:
            h.close()
    assert fps[0] == fps[1]


# ------------------------------------------------- differential corpus


def _populate(h):
    """Two set fields spread over 3 shards (>= MIN_SHARDS so the
    stacked/fused path engages) with deterministic contents, as the TPU
    package's corpus, plus field r: rows 20 and 21 of long runs in every
    shard (run-length leaves under the auto chooser), and field s: rows
    30 and 31 of random words in four 128-word blocks a shard, two of
    them shared (block-sparse leaves under the auto chooser)."""
    idx = h.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(16)
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
    r = idx.create_field("r")
    rows, cols = [], []
    for shard in range(3):
        for row, (lo, hi) in ((20, (1000, 9000)), (21, (5000, 14000))):
            c = np.arange(shard * SHARD_WIDTH + lo, shard * SHARD_WIDTH + hi)
            rows.extend([row] * len(c))
            cols.extend(c.tolist())
    r.import_bits(np.asarray(rows, dtype=np.uint64),
                  np.asarray(cols, dtype=np.uint64))
    sf = idx.create_field("s")
    rows, cols = [], []
    block_bits = 128 * 32
    for shard in range(3):
        for row, blocks in ((30, (3, 9, 40, 77)), (31, (9, 40, 100, 200))):
            for b in blocks:
                c = np.flatnonzero(rng.integers(0, 2, block_bits))
                c = shard * SHARD_WIDTH + b * block_bits + c
                rows.extend([row] * len(c))
                cols.extend(c.tolist())
    sf.import_bits(np.asarray(rows, dtype=np.uint64),
                   np.asarray(cols, dtype=np.uint64))
    return idx


#: the TPU package's 1..3-call batches over every coverable op, then the
#: run-length rows alone, paired and beside dense and sparse calls
QUERIES = (
    "Count(Row(f=0))",
    "Count(Intersect(Row(f=1), Row(g=10)))",
    "Count(Union(Row(f=0), Row(f=3), Row(f=5)))",
    "Count(Difference(Row(f=1), Row(f=2)))",
    "Count(Xor(Row(f=2), Row(f=4)))",
    "Count(Row(f=0)) Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=10))) Count(Row(f=2))"
    " Count(Union(Row(f=3), Row(f=4)))",
    "Count(Row(r=20))",
    "Count(Row(g=10)) Count(Intersect(Row(r=20), Row(r=21)))"
    " Count(Union(Row(f=0), Row(r=21)))",
    "Count(Row(s=30)) Count(Intersect(Row(s=30), Row(s=31)))"
    " Count(Union(Row(s=31), Row(f=2)))",
)


def _run_corpus(pkg, holder, repeat=2):
    ex = _executor(pkg, holder)
    out = []
    for _ in range(repeat):
        for q in QUERIES:
            out.append(ex.execute("i", q))
    return ex, out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    holders = {}
    for pkg in BOTH:
        h = pkg.core.Holder(str(tmp_path_factory.mktemp(f"fusion-{pkg.name}")),
                            use_snapshot_queue=False).open()
        _populate(h)
        holders[pkg.name] = h
    yield holders
    for h in holders.values():
        h.close()


def _bit_identity(corpus):
    got = {}
    for pkg in BOTH:
        pkg.fusion.reset()  # mode off baseline: the interpreted loop
        _, want = _run_corpus(pkg, corpus[pkg.name])
        pkg.fusion.configure(mode="on", min_hits=0)
        ex, fused = _run_corpus(pkg, corpus[pkg.name])
        assert fused == want, pkg.name
        assert pkg.fusion.decision_counts()["fused"] > 0
        assert ex._stacked.cache_stats()["fused_dispatches"] > 0
        got[pkg.name] = (fused, pkg.fusion.decision_counts())
    assert got["port"] == got["jax"]
    return got


def test_fused_bit_identity(corpus):
    """The acceptance gate: --fusion on answers exactly like off over
    multi-op chains and 1..3-call batches, in both packages, and both
    fused the same queries."""
    _bit_identity(corpus)


def test_fused_bit_identity_compressed(corpus):
    """Same gate under forced container compression: sparse and
    run-length count programs ride the fused dispatch beside the
    multi-tree K1 members (a distinct gsig key). The port's pool must
    hold both compressed forms, so both routes ran."""
    for pkg in BOTH:
        pkg.cont.AUTO_COMPRESS_FLOOR = 0
        pkg.cont.configure("auto")
    _bit_identity(corpus)
    ex = _executor(PKGS["port"], corpus["port"])
    for q in QUERIES:
        ex.execute("i", q)
    reprs = {e["repr"] for e in ex._stacked.hbm_snapshot(top=100)["entries"]
             if e["kind"] == "leaf"}
    assert {"sparse", "rle"} <= reprs, reprs


def _overlay_run(pkg, tmp_path):
    """A compressed leaf that carries an overlay term (one drifted shard
    folded in by the ingest merge), counted fused beside a dense and a
    run-length call: (interpreted answers, fused answers, whether the
    leaf held an overlay term — the port's evaluator only)."""
    pkg.cont.AUTO_COMPRESS_FLOOR = 0
    pkg.cont.configure("auto")
    holder = pkg.core.Holder(str(tmp_path / pkg.name),
                             use_snapshot_queue=False).open()
    api = pkg.api.API(holder, ingest_interval=3600.0, **pkg.ex_kw)
    try:
        _populate(holder)
        q = ("Count(Row(f=1)) Count(Union(Row(f=1), Row(f=2)))"
             " Count(Intersect(Row(r=20), Row(r=21)))")
        ex = api.executor
        ex.execute("i", q)  # the leaves resident before the writes
        api.import_bits("i", "f", [1], [SHARD_WIDTH + 12345])
        api.ingest.flush()
        want = ex.execute("i", q)
        has_overlay = None
        if pkg.name == "port":
            has_overlay = any(
                isinstance(v[1], torch_cont.Container) and v[1].overlay
                for v in ex._stacked._pools["leaf"].values())
        pkg.fusion.configure(mode="on", min_hits=0)
        got = [ex.execute("i", q) for _ in range(2)]
        pkg.fusion.reset()
        return want, got, has_overlay
    finally:
        api.close()
        holder.close()


def test_fused_bit_identity_overlay(tmp_path):
    """A fused query over an overlay-carrying leaf (the ingest merge's
    parked term) answers as the interpreted loop does, in both
    packages: the overlay leaf densifies and rides the multi-tree K1
    member (trap 10), never K2."""
    ref = _overlay_run(PKGS["jax"], tmp_path)
    got = _overlay_run(PKGS["port"], tmp_path)
    assert got[2] is True, "the port's leaf took no overlay term"
    assert ref[1] == [ref[0]] * 2
    assert got[1] == [got[0]] * 2
    assert got[0] == ref[0]


def test_cold_fingerprint_never_compiles(corpus):
    """A shape below --fusion-min-hits runs interpreted with an empty
    program ledger; crossing the floor admits it — the same counters in
    both packages."""
    snaps = {}
    for pkg in BOTH:
        fusion = pkg.fusion
        fusion.configure(mode="on")  # default min_hits=2
        ex = _executor(pkg, corpus[pkg.name])
        q = "Count(Row(f=5)) Count(Row(g=11))"

        ex.execute("i", q)   # completed queries: 0 -> vetoed cold
        assert fusion.snapshot()["entries"] == 0
        assert fusion.decision_counts()["interpreted_cold"] == 1
        ex.execute("i", q)   # completed: 1 -> still cold
        assert fusion.snapshot()["entries"] == 0
        assert fusion.decision_counts()["interpreted_cold"] == 2

        ex.execute("i", q)   # completed: 2 >= floor -> builds
        snap = fusion.snapshot()
        assert snap["entries"] == 1
        assert snap["programs"][0]["compile_ms"] > 0
        assert fusion.decision_counts()["fused"] == 1
        snaps[pkg.name] = _strip(snap)
    assert snaps["port"] == snaps["jax"]


def test_single_dispatch_per_warm_query(corpus, monkeypatch):
    """The headline claim: a warm 3-call query costs exactly ONE device
    dispatch in both packages (the interpreted loop pays one per call);
    in the port that dispatch is one call of K1's multi-tree entry."""
    q = ("Count(Row(f=0)) Count(Intersect(Row(f=1), Row(g=10)))"
         " Count(Row(f=3))")
    got = {}
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0)
        ex = _executor(pkg, corpus[pkg.name])
        ex.execute("i", q)  # compile round
        calls = []
        if pkg.name == "port":
            real = torch_cont.count_expr_multi
            monkeypatch.setattr(
                torch_cont, "count_expr_multi",
                lambda *a, **k: calls.append(1) or real(*a, **k))
        before = ex._stacked.dispatches
        got[pkg.name] = ex.execute("i", q)
        assert ex._stacked.dispatches - before == 1
        assert pkg.fusion.last_fused() == 3
        if pkg.name == "port":
            assert calls == [1]
    assert got["port"] == got["jax"]


def test_program_shared_across_literals(corpus):
    """`Count(Row(f=3))` and `Count(Row(f=9))` are the same program: the
    cache key is the literal-free fingerprint + gsigs + shard bucket."""
    snaps = {}
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0)
        ex = _executor(pkg, corpus[pkg.name])
        for row in (0, 1, 2, 3):
            ex.execute("i", f"Count(Row(f={row}))")
        snap = pkg.fusion.snapshot()
        assert snap["entries"] == 1
        assert snap["programs"][0]["hits"] == 4
        assert pkg.fusion.decision_counts()["fused"] == 4
        snaps[pkg.name] = snap["programs"][0]
    # the port's shard bucket is the real shard count; the TPU package
    # pads the shard axis to its 8 test devices (trap 27)
    assert snaps["port"]["bucket"] == 3
    assert snaps["port"]["fingerprint"] == snaps["jax"]["fingerprint"]


def test_shadow_zero_side_effects(corpus):
    """Shadow admits and counts but builds nothing: answers, program
    ledger and the evaluator's dispatch mix all match mode off."""
    got = {}
    for pkg in BOTH:
        pkg.fusion.reset()
        ex_off, want = _run_corpus(pkg, corpus[pkg.name])
        off_fused = ex_off._stacked.cache_stats()["fused_dispatches"]

        pkg.fusion.configure(mode="shadow", min_hits=0)
        ex, out = _run_corpus(pkg, corpus[pkg.name])
        assert out == want
        snap = pkg.fusion.snapshot()
        assert snap["mode"] == "shadow"
        assert snap["entries"] == 0
        dc = pkg.fusion.decision_counts()
        assert dc["shadow_would_fuse"] > 0
        assert dc["fused"] == 0
        assert ex._stacked.cache_stats()["fused_dispatches"] \
            == off_fused == 0
        got[pkg.name] = (out, dc)
    assert got["port"] == got["jax"]
    # the port never built a program table
    assert not any(k[0] == "fused" and len(k) == 2
                   for k in ex._stacked._fn_specs)


def test_lru_eviction_drops_compiled_fn(corpus):
    """A 1-slot cache: warming a second shape evicts the first AND pops
    its program from the evaluator (the TPU package's jitted fn in
    `_fns`, the port's program table in `_fn_specs`), so re-entry
    rebuilds it."""
    def fused_keys(ex, pkg):
        if pkg.name == "jax":
            return [k for k in ex._stacked._fns
                    if isinstance(k, tuple) and k and k[0] == "fused"]
        return [k for k in ex._stacked._fn_specs
                if len(k) == 2 and k[0] == "fused"]

    snaps = {}
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0, cache_size=1)
        ex = _executor(pkg, corpus[pkg.name])
        ex.execute("i", "Count(Row(f=0))")
        assert len(fused_keys(ex, pkg)) == 1
        ex.execute("i", "Count(Row(f=1)) Count(Row(f=2))")  # other shape
        snap = pkg.fusion.snapshot()
        assert snap["entries"] == 1
        assert snap["evictions"] == 1
        assert snap["programs"][0]["calls"] == 2  # survivor: 2-call shape
        assert len(fused_keys(ex, pkg)) == 1  # evicted program is GONE
        assert pkg.fusion.decision_counts()["fused"] == 2
        # re-entry of the evicted shape: the port rebuilds its program
        # table, a `compile` dispatch again (the TPU package re-traces
        # but keys its compile label on shapes it has seen)
        builds = ex._stacked.dispatch_phases()["fused"]["compile"]["count"]
        ex.execute("i", "Count(Row(f=3))")
        if pkg.name == "port":
            assert ex._stacked.dispatch_phases()["fused"]["compile"][
                "count"] == builds + 1
        snaps[pkg.name] = _strip(pkg.fusion.snapshot())
    assert snaps["port"] == snaps["jax"]


def test_watchdog_and_phase_clock_registration(corpus):
    """Fused dispatches go through _locked_dispatch like every kernel
    family: per-family attribution and the phase decomposition both
    carry a 'fused' entry; the first dispatch on a program is labelled
    `compile` (the port: its program table's build and upload)."""
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0)
        ex = _executor(pkg, corpus[pkg.name])
        ex.execute("i", "Count(Row(f=0)) Count(Row(f=1))")  # build round
        ex.execute("i", "Count(Row(f=2)) Count(Row(f=3))")  # warm round
        fam = ex._stacked._kernels.get("fused")
        assert fam is not None and fam["count"] == 2
        assert fam["bytes_in"] > 0
        phases = ex._stacked.dispatch_phases().get("fused")
        assert phases is not None
        assert {"compile", "dispatch_ack", "sync"} <= set(phases)
        assert phases["compile"]["count"] == 1
    assert set(torch_fusion.snapshot()) == set(jax_fusion.snapshot())


def test_groupby_stays_interpreted(corpus):
    """Non-Count top-level calls are ineligible — the whole query runs
    the interpreted loop."""
    q = "GroupBy(Rows(f, limit=2), Rows(g))"
    got = {}
    for pkg in BOTH:
        pkg.fusion.reset()
        ex = _executor(pkg, corpus[pkg.name])
        want = ex.execute("i", q)
        pkg.fusion.configure(mode="on", min_hits=0)
        out = ex.execute("i", q)
        assert out == want
        dc = pkg.fusion.decision_counts()
        assert dc["ineligible"] >= 1 and dc["fused"] == 0
        got[pkg.name] = dc
    assert got["port"] == got["jax"]


# ------------------------------------------------------------- EXPLAIN


def _annotations(env):
    return [{k: v for k, v in n["annotations"].items()
             if k.startswith("fus")} for n in env["calls"]]


def test_explain_plan_annotates_fusion_dispatch_free(corpus):
    """?explain=true marks every fusable node fused:true with the
    program-cache status, with ZERO dispatches — the same annotations,
    fingerprint included, in both packages."""
    q = "Count(Row(f=0)) Count(Row(f=1))"
    anns = {}
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0)
        ex = _executor(pkg, corpus[pkg.name])
        opts = pkg.exec.ExecOptions
        before = ex._stacked.dispatches
        assert ex.execute("i", q, options=opts(explain="plan")) == []
        assert ex._stacked.dispatches == before
        env = pkg.plan.take_last()
        assert len(env["calls"]) == 2
        for node in env["calls"]:
            ann = node["annotations"]
            assert ann["fused"] is True
            assert ann["fusion_program"] == "uncompiled"
            assert re.fullmatch(r"[0-9a-f]{16}", ann["fusion_fingerprint"])
        cold = _annotations(env)

        ex.execute("i", q)  # build it
        ex.execute("i", q, options=opts(explain="plan"))
        env = pkg.plan.take_last()
        assert all(n["annotations"]["fusion_program"] == "cached"
                   for n in env["calls"])
        anns[pkg.name] = (cold, _annotations(env))
    assert anns["port"] == anns["jax"]


def test_explain_analyze_grafts_single_dispatch(corpus):
    """?explain=analyze through the fused path: the query's ONE dispatch
    lands on the first node, zero on the rest, strategy 'fused', and no
    spurious misestimate flags — in both packages."""
    q = ("Count(Row(f=0)) Count(Intersect(Row(f=1), Row(g=10)))"
         " Count(Row(f=2))")
    got = {}
    for pkg in BOTH:
        pkg.fusion.configure(mode="on", min_hits=0)
        ex = _executor(pkg, corpus[pkg.name])
        ex.execute("i", q)  # warm the program
        res = ex.execute("i", q,
                         options=pkg.exec.ExecOptions(explain="analyze"))
        env = pkg.plan.take_last()
        nodes = env["calls"]
        assert len(nodes) == len(res) == 3
        assert [n["actual"]["dispatches"] for n in nodes] == [1, 0, 0]
        assert all(n["actual"]["strategy"] == "fused" for n in nodes)
        assert all(n["actual"]["batch"] == 3 for n in nodes)
        assert all(n["annotations"]["fused"] is True for n in nodes)
        assert env["misestimates"] == 0
        got[pkg.name] = (res, [
            {k: n["actual"].get(k) for k in ("dispatches", "strategy",
                                             "batch", "program")}
            for n in nodes])
    assert got["port"] == got["jax"]


# --------------------------------------------------------- HTTP surface


class _Harness:
    """One in-process port node on the CPU: holder + API + HTTP."""

    def __init__(self, data_dir, **api_kwargs):
        self.holder = torch_core.Holder(
            str(data_dir), use_snapshot_queue=False).open()
        self.api = torch_api.API(self.holder, device="cpu", **api_kwargs)
        self.server = PilosaHTTPServer(self.api, host="127.0.0.1",
                                       port=0).start()
        self.client = Client(self.server.uri)

    def close(self):
        self.server.stop()
        self.api.close()
        self.holder.close()


def _harnesses(tmp_path):
    return {"jax": JaxHarness(data_dir=str(tmp_path / "jax")),
            "port": _Harness(tmp_path / "port")}


def test_debug_fusion_over_http(tmp_path):
    hs = _harnesses(tmp_path)
    shapes = {}
    try:
        for name, h in hs.items():
            pkg = PKGS[name]
            pkg.fusion.configure(mode="on", min_hits=0)
            h.client.create_index("hx")
            h.client.create_field("hx", "f")
            h.client.query("hx", "Set(1, f=10)")
            h.client.query("hx", f"Set({SHARD_WIDTH + 1}, f=10)")
            res = h.client.query("hx", "Count(Row(f=10)) Count(Row(f=11))")

            snap = h.client._request("GET", "/debug/fusion")
            assert snap["mode"] == "on"
            assert snap["entries"] == 1
            prog = snap["programs"][0]
            assert set(prog) >= {"fingerprint", "bucket", "calls",
                                 "compile_ms", "hits", "age_seconds"}
            assert prog["calls"] == 2
            assert set(snap["decisions"]) >= {
                "fused", "interpreted_cold", "ineligible",
                "shadow_would_fuse"}
            index = h.client._request("GET", "/debug")
            assert "/debug/fusion" in {e["path"]
                                       for e in index["endpoints"]}
            shapes[name] = (res["results"], sorted(snap), sorted(prog),
                            snap["decisions"])
        # /metrics counters moved (the port's registry)
        from pilosa_tpu_torch.utils.stats import global_stats
        counters, _, _ = global_stats.snapshot()
        assert sum(v for k, v in counters.items()
                   if k[0] == "fused_dispatches_total") >= 1
    finally:
        for h in hs.values():
            h.close()
    assert shapes["port"] == shapes["jax"]


def test_slow_query_log_carries_fused(tmp_path):
    """SLOW QUERY's pinned order has fused= between batch= and plan=;
    an interpreted query stamps fused=0 — as the TPU package's does."""
    hs = _harnesses(tmp_path)
    fused = {}
    try:
        for name, h in hs.items():
            pkg = PKGS[name]
            log = CaptureLogger()
            h.api.long_query_time = 0.0  # everything is slow
            h.api.logger = log
            pkg.profile.clear_recent()
            h.client.create_index("sq")
            h.client.create_field("sq", "f")
            h.client.query("sq", "Set(1, f=10)")
            h.client.query("sq", f"Set({SHARD_WIDTH + 1}, f=10)")

            pkg.fusion.configure(mode="on", min_hits=0)
            h.client.query("sq", "Count(Row(f=10)) Count(Row(f=11))")
            slow = [line for line in log.lines if "SLOW QUERY" in line]
            m = re.search(r"fingerprint=[0-9a-f]{16} batch=\d+ fused=(\d+)",
                          slow[-1])
            assert m, f"pinned order broken in: {slow[-1]}"
            on = int(m.group(1))

            pkg.fusion.configure(mode="off")
            h.client.query("sq", "Count(Row(f=10)) Count(Row(f=11))")
            slow = [line for line in log.lines if "SLOW QUERY" in line]
            m = re.search(r"fused=(\d+)", slow[-1])
            assert m
            fused[name] = (on, int(m.group(1)))
    finally:
        for h in hs.values():
            h.close()
    assert fused["port"] == fused["jax"] == (2, 0)


# ----------------------------------------------------------------- CLI


def test_cli_config_merges_fusion_flags(tmp_path):
    """`config` prints the file < flags merge including the fusion
    knobs the server command would apply at startup — the same keys
    and values as the TPU package's."""
    from pilosa_tpu.cli import main as jax_main
    from pilosa_tpu_torch.cli import main

    try:
        import tomllib
    except ImportError:
        tomllib = pytest.importorskip("tomli")

    p = tmp_path / "c.toml"
    p.write_text('fusion = "shadow"\nfusion-cache-size = 16\n')
    cfgs = []
    for fn in (jax_main, main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = fn(["config", "--config", str(p),
                     "--fusion", "on", "--fusion-min-hits", "3"])
        assert rc == 0
        cfg = tomllib.loads(buf.getvalue())
        assert cfg["fusion"] == "on"              # flag beats file
        assert cfg["fusion-cache-size"] == 16     # file survives the merge
        assert cfg["fusion-min-hits"] == 3
        cfgs.append({k: v for k, v in cfg.items() if k.startswith("fusion")})
    assert cfgs[0] == cfgs[1]


# ------------------------------------------------- the port's own checks


def test_fused_query_routes_one_multi_call(corpus, monkeypatch):
    """The routes of one warm fused query over dense, sparse and
    run-length leaves (chip_smoke's served 5-call shape): the K1 calls
    ride exactly ONE call of the multi-tree entry, the sparse ones take
    K2 (count_blocks for the lone leaf, count_and_blocks for the pair),
    the run-length pair no kernel, and no single K1 call runs — and the
    answers equal the TPU package's and the interpreted loop's. A query
    with one K1 call still takes the multi entry."""
    for pkg in BOTH:
        pkg.cont.AUTO_COMPRESS_FLOOR = 0
        pkg.cont.configure("auto")
    q = ("Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=2),"
         " Row(f=3))) Count(Row(s=30)) Count(Intersect(Row(s=30),"
         " Row(s=31))) Count(Intersect(Row(r=20), Row(r=21)))")
    want = {}
    for pkg in BOTH:
        ex = _executor(pkg, corpus[pkg.name])
        want[pkg.name] = ex.execute("i", q)
    assert want["port"] == want["jax"]

    calls = {"multi": 0, "single": 0, "blocks": 0, "and_blocks": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, attr in (("multi", "count_expr_multi"),
                       ("single", "count_expr"),
                       ("blocks", "count_blocks"),
                       ("and_blocks", "count_and_blocks")):
        monkeypatch.setattr(torch_cont, attr,
                            spy(name, getattr(torch_cont, attr)))
    torch_fusion.configure(mode="on", min_hits=0)
    ex = _executor(PKGS["port"], corpus["port"])
    assert ex.execute("i", q) == want["port"]  # builds the program
    for k in calls:
        calls[k] = 0
    assert ex.execute("i", q) == want["port"]
    assert calls == {"multi": 1, "single": 0, "blocks": 1,
                     "and_blocks": 1}, calls
    for k in calls:
        calls[k] = 0
    q1 = "Count(Union(Row(f=4), Row(s=30))) Count(Row(s=31))"
    assert ex.execute("i", q1) == \
        _executor(PKGS["jax"], corpus["jax"]).execute("i", q1)
    assert calls["multi"] == 1 and calls["single"] == 0


def test_kernel_launch_failure_propagates_out_of_a_fused_query(
        corpus, monkeypatch):
    """The fused path's catch-all falls back to the interpreted loop on
    what it is for (here: a plain ValueError), but a kernel wrapper's
    launch failure — the RuntimeError("... CUDA error N") every wrapper
    raises on the card — propagates out of the query: the card's fault
    is never hidden behind a silent retry."""
    torch_fusion.configure(mode="on", min_hits=0)
    ex = _executor(PKGS["port"], corpus["port"])
    q = "Count(Row(f=0)) Count(Intersect(Row(f=1), Row(g=10)))"
    want = ex.execute("i", q)

    def launch_failure(*a, **k):
        raise RuntimeError(
            "count_expr_multi kernel launch failed: CUDA error 700")

    monkeypatch.setattr(k1, "count_expr_multi_reference", launch_failure)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ex.execute("i", q)
    assert torch_fusion.last_fused() == 0

    def not_the_card(*a, **k):
        raise ValueError("not a device failure")

    monkeypatch.setattr(k1, "count_expr_multi_reference", not_the_card)
    fused_before = torch_fusion.decision_counts()["fused"]
    assert ex.execute("i", q) == want  # fell back to the interpreted loop
    assert torch_fusion.decision_counts()["fused"] == fused_before
    assert torch_fusion.last_fused() == 0


def test_count_program_multi_declares_one_multi_launch():
    """containers.count_kernels_multi: the K1 calls of a fused query are
    one `count_expr_multi` launch (its cost args: each call's leaf count,
    S and W), the sparse calls their own K2 launch, the run-length
    sums none."""
    w = SHARD_WIDTH // 32
    dense = (("dense",), ((3, w),))
    sparse = (("sparse", 3), ((5,), (5, 128)))
    plans, shapes = [], []
    for sig, conts in ((("&", (("leaf", 0), ("leaf", 1))), [dense, dense]),
                       (("leaf", 0), [sparse]),
                       (("leaf", 0), [dense])):
        plans.append((sig, tuple(c[0] for c in conts)))
        shapes.append(tuple(s for c in conts for s in c[1]))
    got = torch_cont.count_kernels_multi(tuple(plans), tuple(shapes))
    assert got == [("count_expr_multi", ((2, 1), 3, w)),
                   ("count_blocks", (5,))]
