"""The port's streaming ingest engine (exec/ingest.py, the compressed
leaves' overlay, the API hooks) against the TPU package's, on the CPU.

Every case of `tests/test_ingest.py` runs through both packages in one
pytest process (JAX on the CPU as its own tests run it; the port with
device="cpu"), and the port must do what the reference does:

- the differential (dense and auto) feeds the same seeded imports to a
  legacy server (no engine) and an engine server of each package: every
  answer equal across the packages before the flush and after it, equal
  to the legacy answers after it, zero read-path patches while the
  deltas are pending, and every resident stack plane equal across the
  packages after each merge;
- the overlay and its rebuild, the 503 back-pressure, the group-committed
  oplog watermark, the merge's wait for the dispatch lock, the adaptive
  patch pricing, the background interval, and the crash between the
  buffer and the merge (a `--device cpu` server subprocess).

Tolerance: exact equality.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.exec as jax_exec  # noqa: E402
import pilosa_tpu.exec.adaptive as jax_adaptive  # noqa: E402
import pilosa_tpu.exec.ingest as jax_ingest  # noqa: E402
import pilosa_tpu.exec.stacked as jax_stacked  # noqa: E402
import pilosa_tpu.ops.containers as jax_cont  # noqa: E402
import pilosa_tpu.server as jax_server  # noqa: E402
import pilosa_tpu.server.api as jax_api  # noqa: E402
import pilosa_tpu.storage.oplog as jax_oplog  # noqa: E402
import pilosa_tpu.utils.flightrec as jax_flightrec  # noqa: E402
import pilosa_tpu.utils.stats as jax_stats  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.exec as torch_exec  # noqa: E402
import pilosa_tpu_torch.exec.adaptive as torch_adaptive  # noqa: E402
import pilosa_tpu_torch.exec.ingest as torch_ingest  # noqa: E402
import pilosa_tpu_torch.exec.stacked as torch_stacked  # noqa: E402
import pilosa_tpu_torch.ops.containers as torch_cont  # noqa: E402
import pilosa_tpu_torch.server as torch_server  # noqa: E402
import pilosa_tpu_torch.server.api as torch_api  # noqa: E402
import pilosa_tpu_torch.storage.oplog as torch_oplog  # noqa: E402
import pilosa_tpu_torch.utils.flightrec as torch_flightrec  # noqa: E402
import pilosa_tpu_torch.utils.stats as torch_stats  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(
        name="jax", core=jax_core, exec=jax_exec, adaptive=jax_adaptive,
        ingest=jax_ingest, stacked=jax_stacked, cont=jax_cont,
        server=jax_server, api=jax_api, oplog=jax_oplog,
        flightrec=jax_flightrec, stats=jax_stats.global_stats,
        api_kw={}, ex_kw={}),
    "port": SimpleNamespace(
        name="port", core=torch_core, exec=torch_exec,
        adaptive=torch_adaptive, ingest=torch_ingest,
        stacked=torch_stacked, cont=torch_cont, server=torch_server,
        api=torch_api, oplog=torch_oplog, flightrec=torch_flightrec,
        stats=torch_stats.global_stats, api_kw={"device": "cpu"},
        ex_kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _isolate():
    # CPU-scale corpora sit far below the production auto-compress
    # floor; drop it so `auto` actually chooses. Restore every global
    # knob and make sure no engine outlives its test (a registered
    # engine changes covers_pending for EVERY evaluator in-process).
    saved = {n: (p.cont.repr_mode(), p.cont.AUTO_COMPRESS_FLOOR)
             for n, p in PKGS.items()}
    for p in PKGS.values():
        p.cont.AUTO_COMPRESS_FLOOR = 0
    yield
    for n, p in PKGS.items():
        p.cont.configure(saved[n][0])
        p.cont.AUTO_COMPRESS_FLOOR = saved[n][1]
        p.cont.reset_ledger()
        p.adaptive.reset()
        for eng in list(p.ingest._REGISTRY):
            eng.close()


def _mk(pkg, tmp_path, name, **api_kwargs):
    holder = pkg.core.Holder(str(tmp_path / f"{pkg.name}-{name}"),
                             use_snapshot_queue=False).open()
    return holder, pkg.api.API(holder, **pkg.api_kw, **api_kwargs)


def _counter(pkg, name, **tags):
    key = (name, tuple(sorted(tags.items())))
    return pkg.stats._counters.get(key, 0)


def _norm(r):
    """One result as plain Python data, the same for both packages."""
    cols = getattr(r, "columns", None)
    if callable(cols):
        return ("row", tuple(int(c) for c in cols()))
    if isinstance(r, (list, tuple)):
        return tuple(_norm(x) for x in r)
    if hasattr(r, "val"):
        return ("vc", r.val, r.count)
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", r.id, r.count)
    return r


# ------------------------------------------------- flush == legacy corpus


N_SHARDS = 2

QUERIES = (
    "Count(Row(f=1))",
    "Count(Row(f=2))",
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=2), Row(f=3)))",
    "Row(f=1)",
    "TopN(f, n=3)",
    "Count(Row(v > 50))",
)


def _base_cols(row, shard):
    base = shard * SHARD_WIDTH
    if row == 1:  # clustered -> sparse under auto
        return [base + b * 4096 + 7 * k
                for b in (3, 9) for k in range(40)]
    if row == 2:  # one long run -> rle under auto
        return list(range(base + 1000, base + 6000))
    # scattered pseudo-random -> incompressible, stays dense
    rng = np.random.default_rng(11 + shard)
    return sorted(base + c for c in
                  rng.choice(SHARD_WIDTH, size=4000, replace=False))


def _delta_cols(row, shard):
    base = shard * SHARD_WIDTH
    if row == 1:
        return [base + 20 * 4096 + 3 * k for k in range(40)]
    if row == 2:
        return list(range(base + 7000, base + 7400))
    rng = np.random.default_rng(77 + shard)
    return sorted(base + c for c in
                  rng.choice(SHARD_WIDTH, size=200, replace=False))


def _seed(pkg, api):
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "v", pkg.core.FieldOptions.int_field(0, 1000))
    for row in (1, 2, 3):
        for shard in range(N_SHARDS):
            cols = _base_cols(row, shard)
            api.import_bits("i", "f", [row] * len(cols), cols)
    vcols = [37 * k for k in range(60)]
    api.import_values("i", "v", vcols, [k % 97 for k in range(60)])


def _delta(api):
    # every delta lands in shard 0 only: 1 of 2 shards drifts, under
    # the static patch cutoff, so the legacy pass patches (not rebuilds)
    for row in (1, 2, 3):
        cols = _delta_cols(row, 0)
        api.import_bits("i", "f", [row] * len(cols), cols)
    vcols = [37 * 60 + 11 * k for k in range(30)]
    api.import_values("i", "v", vcols, [60 + k % 37 for k in range(30)])


def _run(api):
    ex = api.executor
    return [_norm(ex.execute("i", q)) for q in QUERIES]


def _planes(pkg, ev, n_shards):
    """{repr(key): uint32 planes} of every resident stack, the shard axis
    cut to the real shards (the TPU package pads it to its devices) and a
    BSI stack as [exists, sign, magnitudes...] (the port's one stack)."""
    def host(a):
        a = np.asarray(a.cpu() if hasattr(a, "cpu") else a)
        return a.view(np.uint32) if a.dtype == np.int32 else a

    out = {}
    if pkg.name == "jax":
        items = list(ev._stacks.items()) + list(ev._rows_stacks.items())
    else:
        items = list(ev._pools["leaf"].items()) \
            + list(ev._pools["rows"].items())
    for key, entry in items:
        val = entry[1]
        if isinstance(val, pkg.cont.Container):
            arr = host(pkg.cont.container_to_dense(val))[:n_shards]
        elif key[0] == "bsi" and pkg.name == "jax":
            planes, sign, exists = (host(a) for a in val)
            arr = np.concatenate([exists[None], sign[None], planes],
                                 axis=0)[:, :n_shards]
        else:
            arr = host(val)[:, :n_shards]
        out[repr(key)] = arr
    return out


def _differential(pkg, tmp_path, mode):
    """One package's run of the reference's differential: the legacy
    oracle's answers, then the engine's before, during and after its
    merge, its counters, and its resident planes after each merge."""
    pkg.cont.configure(mode)
    obs = {}
    holder_a, api_a = _mk(pkg, tmp_path, f"legacy-{mode}")
    try:
        _seed(pkg, api_a)
        _run(api_a)  # warm stacks so the delta exercises the patch path
        _delta(api_a)
        obs["want"] = _run(api_a)
    finally:
        api_a.close()
        holder_a.close()

    holder_b, api_b = _mk(pkg, tmp_path, f"ingest-{mode}",
                          ingest_interval=3600.0)
    try:
        eng = api_b.ingest
        assert eng is not None
        assert pkg.ingest.mode() == "interval=3600s"
        _seed(pkg, api_b)
        eng.flush()  # fold the seed churn; start the window clean
        st = api_b.executor._stacked
        obs["planes_seed"] = _planes(pkg, st, N_SHARDS)
        obs["pre"] = _run(api_b)
        read0 = _counter(pkg, "stacked_patches", path="read")
        stale0 = st.stale_serves

        _delta(api_b)
        snap = eng.snapshot()
        obs["pending"] = (snap["pending"]["entries"],
                          snap["pending"]["rows"])
        obs["mid"] = _run(api_b)
        obs["read_patches_pending"] = \
            _counter(pkg, "stacked_patches", path="read") - read0
        obs["stale_served"] = st.stale_serves > stale0

        merge0 = _counter(pkg, "stacked_patches", path="merge")
        eng.flush()
        obs["pending_after"] = eng.snapshot()["pending"]["entries"]
        obs["merge_patches"] = \
            _counter(pkg, "stacked_patches", path="merge") - merge0
        obs["merges"] = eng.merges
        obs["planes_merged"] = _planes(pkg, st, N_SHARDS)
        obs["post"] = _run(api_b)
        obs["read_patches_post"] = \
            _counter(pkg, "stacked_patches", path="read") - read0

        counts = [q for q in QUERIES if q.startswith("Count")]
        obs["batch"] = [(_norm(res), err is None) for res, err, *_ in
                        api_b.executor.execute_batch("i", counts)]
        obs["overlay_or_rebuild"] = \
            eng.overlay_entries + eng.rebuilt_entries
        obs["kinds"] = {e["kind"] for e in
                        pkg.flightrec.snapshot()["events"]}
    finally:
        api_b.close()
        holder_b.close()
    return obs


@pytest.mark.parametrize("mode", ["dense", "auto"])
def test_flush_equals_legacy_differential(tmp_path, mode):
    """The acceptance gate, twice: forced-dense (in-place merges) and
    auto (sparse/rle entries take overlay terms or interval rebuilds).
    In both packages and both modes, pre-merge reads serve the exact
    pre-delta snapshot with ZERO read-path patches, post-flush answers
    equal the legacy write path's, and the port's answers and resident
    planes equal the TPU package's at every step."""
    ref = _differential(PKGS["jax"], tmp_path, mode)
    got = _differential(PKGS["port"], tmp_path, mode)
    for obs in (ref, got):
        assert obs["pending"][0] > 0 and obs["pending"][1] > 0
        want_by_q = dict(zip(QUERIES, obs["want"]))
        for q, m, p in zip(QUERIES, obs["mid"], obs["pre"]):
            if q.startswith("Count"):
                # Count trees serve from the device stacks: with deltas
                # pending they answer from the pre-delta snapshot
                assert m == p, (q, "pre-merge count left the snapshot")
            else:
                # Row/TopN read host fragments: either snapshot, never a
                # blend of a patched stack
                assert m in (p, want_by_q[q]), q
        assert obs["read_patches_pending"] == 0, \
            "a read repaired a stack whose drift was pending"
        assert obs["stale_served"]
        assert obs["pending_after"] == 0
        assert obs["merge_patches"] > 0
        assert obs["merges"] >= 1
        assert obs["post"] == obs["want"], f"mode={mode}: flush diverged"
        assert obs["read_patches_post"] == 0
        counts = [q for q in QUERIES if q.startswith("Count")]
        assert obs["batch"] == [(want_by_q[q], True) for q in counts]
        if mode == "auto":
            assert obs["overlay_or_rebuild"] > 0, \
                "no compressed entry went through the merge"
        assert "ingest.merge" in obs["kinds"]
    # (how many entries took an overlay or a rebuild is not compared:
    # the TPU package pads the shard axis to its 8 test devices, so its
    # chooser weighs 8 shards' dense bytes where the port weighs 2 and
    # compresses more leaves; the planes below are compared instead)
    for k in ("want", "pre", "mid", "post", "pending", "merge_patches",
              "batch"):
        assert got[k] == ref[k], k
    for stage in ("planes_seed", "planes_merged"):
        assert set(got[stage]) == set(ref[stage]), stage
        for key, planes in ref[stage].items():
            assert np.array_equal(got[stage][key], planes), (stage, key)


@pytest.mark.parametrize("name", ["jax", "port"])
def test_interval_zero_is_legacy(tmp_path, name):
    pkg = PKGS[name]
    holder, api = _mk(pkg, tmp_path, "off")
    try:
        assert api.ingest is None
        assert api.ingest_stats() == {"enabled": False,
                                      "interval_seconds": 0.0}
        assert pkg.ingest.mode() == "off"
        assert not pkg.ingest.covers_pending(
            "i", "f", "standard", (0,), ((1, 1),), ((1, 2),))
        api.create_index("i")
        api.create_field("i", "f")
        api.import_bits("i", "f", [1], [5])  # no admit/record layer
        assert api.executor.execute("i", "Count(Row(f=1))")[0] == 1
    finally:
        api.close()
        holder.close()


# --------------------------------------------- compressed overlay policy


def _overlay_then_rebuild(pkg, tmp_path):
    pkg.cont.configure("auto")
    holder, api = _mk(pkg, tmp_path, "ovl", ingest_interval=3600.0)
    steps = []
    try:
        api.create_index("i")
        api.create_field("i", "f")
        for shard in range(4):
            cols = [shard * SHARD_WIDTH + 3 * 4096 + 5 * k
                    for k in range(50)]
            api.import_bits("i", "f", [1] * len(cols), cols)
        eng = api.ingest
        eng.flush()
        ex = api.executor
        st = ex._stacked

        def leaf_state():
            count = ex.execute("i", "Count(Row(f=1))")[0]
            return ([e["repr"] for e in st.hbm_snapshot(top=50)["entries"]
                     if e["kind"] == "leaf"],
                    count, eng.overlay_entries, eng.rebuilt_entries)

        steps.append(leaf_state())
        # one drifted shard of four: within the overlay budget
        api.import_bits("i", "f", [1], [123])
        eng.flush()
        steps.append(leaf_state())
        # two more drifted shards: overlay_rows 1 + 2 > 4 // 2 -> rebuild
        api.import_bits("i", "f", [1, 1],
                        [SHARD_WIDTH + 77, 2 * SHARD_WIDTH + 77])
        eng.flush()
        steps.append(leaf_state())
    finally:
        api.close()
        holder.close()
    return steps


def test_compressed_merge_overlay_then_rebuild(tmp_path):
    """A compressed entry absorbs a small merge as an overlay term (repr
    preserved — no decay to dense); past the overlay budget the interval
    rebuild re-chooses the representation. Counts stay exact at every
    step, and a Count over the overlay leaf densifies and launches K1
    (never K2) — the same steps in both packages."""
    from pilosa_tpu_torch.ops import count_blocks, count_expr

    ref = _overlay_then_rebuild(PKGS["jax"], tmp_path)
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = count_expr.count_expr_reference, \
        count_blocks.count_blocks_reference

    def spy_k1(*a, **k):
        calls["k1"] += 1
        return real_k1(*a, **k)

    def spy_k2(*a, **k):
        calls["k2"] += 1
        return real_k2(*a, **k)

    count_expr.count_expr_reference = spy_k1
    count_blocks.count_blocks_reference = spy_k2
    try:
        got = _overlay_then_rebuild(PKGS["port"], tmp_path)
    finally:
        count_expr.count_expr_reference = real_k1
        count_blocks.count_blocks_reference = real_k2
    base = ref[0][1]
    assert ref[0][0] == ["sparse"]
    assert ref[1] == (["sparse"], base + 1, 1, 0), \
        "overlay merge must not decay the repr"
    assert ref[2][1:] == (base + 3, 1, 1)
    assert got == ref
    # step 0 counted the plain sparse leaf with K2; step 1's leaf
    # carried an overlay term, so its Count took K1 and not K2
    assert calls["k2"] == 1 and calls["k1"] >= 1


def test_overlay_leaf_counts_through_k1_never_k2():
    """containers.count_program over a sparse and an rle leaf with an
    overlay term: densified on the device and counted by K1, equal to
    the dense count; the plain sparse pair still takes K2."""
    from pilosa_tpu_torch.ops import containers as c

    rng = np.random.default_rng(5)
    s, w = 4, SHARD_WIDTH // 32
    a = np.zeros((s, w), np.uint32)
    a[:, 100:110] = rng.integers(0, 2**32, (s, 10), dtype=np.uint32)
    b = np.zeros((s, w), np.uint32)
    b[:, 105:300] = 0xFFFFFFFF
    ca = c.build(a, "cpu", mode="sparse")
    cb = c.build(b, "cpu", mode="rle")
    assert (ca.kind, cb.kind) == ("sparse", "rle")
    planes = rng.integers(0, 2**32, (1, w), dtype=np.uint32)
    oa = c.with_overlay(ca, "cpu", np.array([2], np.int32), planes)
    ob = c.with_overlay(cb, "cpu", np.array([0], np.int32), planes)
    a2, b2 = a.copy(), b.copy()
    a2[2], b2[0] = planes[0], planes[0]
    assert c.overlay_rows(oa) == 1 and oa.overlay == 1
    assert oa.csig == ("sparse", s, 1)
    sig = ("&", (("leaf", 0), ("leaf", 1)))
    for conts, dense in (((oa, ob), (a2, b2)), ((ca, oa), (a, a2))):
        csig = tuple(x.csig for x in conts)
        flat = c.flatten(conts)
        assert c._count_route(sig, c.unflatten(csig, flat)) == "k1"
        assert c.count_kernels(
            sig, csig, tuple(tuple(t.shape) for t in flat)) == \
            [("count_expr", (2, s, w))]
        want = sum(bin(int(x)).count("1")
                   for x in (dense[0] & dense[1]).ravel())
        assert int(c.count_program(sig, csig, flat)) == want
        assert np.array_equal(
            c.container_to_dense(conts[0]).numpy().view(np.uint32),
            dense[0])
    # one overlay leaf alone: K1 too; the plain sparse leaf: K2
    assert c._count_route(("leaf", 0), c.unflatten(
        (oa.csig,), oa.arrays)) == "k1"
    assert c._count_route(("leaf", 0), c.unflatten(
        (ca.csig,), ca.arrays)) == "sparse"
    assert int(c.count_program(("leaf", 0), (oa.csig,),
                               list(oa.arrays))) == sum(
        bin(int(x)).count("1") for x in a2.ravel())


# --------------------------------------------------- overflow back-pressure


@pytest.mark.parametrize("name", ["jax", "port"])
def test_overflow_backpressure_503_retry_after(tmp_path, name):
    pkg = PKGS[name]
    holder = pkg.core.Holder(str(tmp_path / "bp"),
                             use_snapshot_queue=False).open()
    api = pkg.api.API(holder, ingest_interval=3600.0, ingest_max_rows=10,
                      **pkg.api_kw)
    server = pkg.server.PilosaHTTPServer(api, host="127.0.0.1", port=0)
    server.start()
    try:
        client = pkg.server.Client(
            getattr(server, "address", None) or server.uri, retries=0)
        client.create_index("i")
        client.create_field("i", "f")
        # 4 points buffer 8 rows (field + _exists) — under the mark
        client.import_bits("i", "f", [1] * 4, [1, 2, 3, 4])
        with pytest.raises(Exception) as exc:
            client.import_bits("i", "f", [1] * 4, [5, 6, 7, 8])
        assert exc.value.status == 503
        assert getattr(exc.value, "retry_after", None) is not None
        assert exc.value.retry_after >= 1
        assert api.ingest.overflows >= 1
        # in-process surface: same gate, typed error with the header
        with pytest.raises(pkg.api.ServiceUnavailableError) as iexc:
            api._ingest_admit(1000, 0)
        assert iexc.value.headers.get("Retry-After") is not None
        # a drain releases the back-pressure
        api.ingest.flush()
        client.import_bits("i", "f", [1] * 4, [5, 6, 7, 8])

        # /debug/ingest serves the engine snapshot + the index lists it
        dbg = client._request("GET", "/debug/ingest")
        assert dbg["enabled"] is True
        assert dbg["interval_seconds"] == 3600.0
        assert dbg["overflows"] >= 1
        index = client._request("GET", "/debug")
        assert any(e["path"] == "/debug/ingest"
                   for e in index["endpoints"])
    finally:
        server.stop()
        api.close()
        holder.close()


# ------------------------------------------------- group-committed oplog


def _group_commit(pkg, tmp_path, fsync):
    holder = pkg.core.Holder(str(tmp_path / f"gc-{fsync}"),
                             use_snapshot_queue=False).open()
    oplog = pkg.oplog.OpLog(str(tmp_path / f"gc-{fsync}" / "oplog"),
                            fsync=fsync).open()
    api = pkg.api.API(holder, oplog=oplog, ingest_interval=3600.0,
                      **pkg.api_kw)
    try:
        api.create_index("i")
        api.create_field("i", "f")
        lag0 = oplog.summary()["replay_lag"]
        for col in (1, 2, 3):
            api.import_bits("i", "f", [1], [col])
        lag_pending = oplog.summary()["replay_lag"] - lag0
        api.ingest.flush()
        lag_after = oplog.summary()["replay_lag"] - lag0
        key = ("oplog_group_commit_records", ())
        timings = pkg.stats._timings.get(key)
        return (lag_pending, lag_after, api.ingest.group_commit_flushed,
                bool(timings and timings[0] >= 1))
    finally:
        api.close()
        oplog.close()
        holder.close()


def test_group_commit_under_interval_fsync(tmp_path):
    """fsync=interval imports defer mark_applied to the merge, in both
    packages alike."""
    ref = _group_commit(PKGS["jax"], tmp_path / "jax", "interval")
    got = _group_commit(PKGS["port"], tmp_path / "port", "interval")
    assert ref == (3, 0, 3, True)
    assert got == ref


def test_no_group_commit_under_fsync_always(tmp_path):
    """fsync=always keeps the per-record applied watermark."""
    for name in ("jax", "port"):
        pkg = PKGS[name]
        holder = pkg.core.Holder(str(tmp_path / name / "ga"),
                                 use_snapshot_queue=False).open()
        oplog = pkg.oplog.OpLog(str(tmp_path / name / "ga" / "oplog"),
                                fsync="always").open()
        api = pkg.api.API(holder, oplog=oplog, ingest_interval=3600.0,
                          **pkg.api_kw)
        try:
            api.create_index("i")
            api.create_field("i", "f")
            api.import_bits("i", "f", [1], [1])
            assert oplog.summary()["replay_lag"] == 0, name
        finally:
            api.close()
            oplog.close()
            holder.close()


# ------------------------------------------- merge vs dispatch exclusion


@pytest.mark.parametrize("name", ["jax", "port"])
def test_merge_waits_for_dispatch_lock(tmp_path, name):
    """The interval merge copies under the process-wide dispatch lock:
    while a (simulated) serving launch holds it, the drain blocks before
    any copy — merges never interleave with a launch."""
    pkg = PKGS[name]
    pkg.cont.configure("dense")  # keep the in-place (launching) merge
    holder, api = _mk(pkg, tmp_path, "lock", ingest_interval=3600.0)
    try:
        api.create_index("i")
        api.create_field("i", "f")
        for shard in range(2):
            cols = [shard * SHARD_WIDTH + c for c in range(64)]
            api.import_bits("i", "f", [1] * len(cols), cols)
        eng = api.ingest
        eng.flush()
        ex = api.executor
        ex.execute("i", "Count(Row(f=1))")  # resident 2-shard stack
        api.import_bits("i", "f", [1], [999])  # pending delta, 1 shard

        merges0 = eng.merges
        assert pkg.stacked._DISPATCH_LOCK.acquire(timeout=5)
        t = threading.Thread(target=eng.flush, daemon=True)
        try:
            t.start()
            deadline = time.time() + 1.0
            while time.time() < deadline:
                assert eng.merges == merges0, \
                    "merge completed while the dispatch lock was held"
                time.sleep(0.05)
            assert t.is_alive()
        finally:
            pkg.stacked._DISPATCH_LOCK.release()
        t.join(timeout=30)
        assert not t.is_alive()
        assert eng.merges == merges0 + 1
        assert eng.scatter_entries >= 1
        assert ex.execute("i", "Count(Row(f=1))")[0] == 129
    finally:
        api.close()
        holder.close()


# ------------------------------------------------- adaptive patch pricing


def test_adaptive_patch_pricing_cutoffs():
    """decide_patch prices upload vs on-device copy: with the fixed
    terms equal, the cutoff is n_changed <= 7/8 of the shards — deeper
    than the static half rule, at any stack size — equal in both."""
    plane = 32768 * 4
    cases = [(1, 8, 1), (7, 8, 1), (8, 8, 1), (840, 960, 4), (841, 960, 4)]
    out = {}
    for name, pkg in PKGS.items():
        pkg.adaptive.reset()
        out[name] = [pkg.adaptive.decide_patch(n, s, r, plane)
                     for n, s, r in cases]
        counts = pkg.adaptive.decision_counts()["patch"]
        assert counts["patch"] == 3 and counts["rebuild"] == 2
        assert pkg.adaptive.snapshot()["decisions"]["patch"] == counts
    assert out["jax"] == [True, True, False, True, False]
    assert out["port"] == out["jax"]


def test_changed_shards_static_vs_adaptive(tmp_path):
    """The evaluator keeps the static half-the-shards rule with adaptive
    off and prices through decide_patch only when acting — in both."""
    old = tuple((1, g) for g in range(8))
    drift5 = tuple((1, g + (100 if g < 5 else 0)) for g in range(8))
    shards = tuple(range(8))
    for name, pkg in PKGS.items():
        holder = pkg.core.Holder(str(tmp_path / name),
                                 use_snapshot_queue=False).open()
        try:
            st = pkg.exec.Executor(holder, **pkg.ex_kw)._stacked
            pkg.adaptive.reset()  # mode off
            assert st._changed_shards(old, drift5, shards) is None, name
            pkg.adaptive.configure("on")
            assert st._changed_shards(old, drift5, shards) == \
                [0, 1, 2, 3, 4], name
            pkg.adaptive.configure("shadow")
            assert st._changed_shards(old, drift5, shards) is None, name
        finally:
            pkg.adaptive.reset()
            holder.close()


# --------------------------------------------------- background interval


@pytest.mark.parametrize("name", ["jax", "port"])
def test_background_merge_fires_on_interval(tmp_path, name):
    pkg = PKGS[name]
    holder, api = _mk(pkg, tmp_path, "bg", ingest_interval=0.1)
    try:
        api.create_index("i")
        api.create_field("i", "f")
        api.import_bits("i", "f", [1], [42])
        eng = api.ingest
        deadline = time.time() + 10
        while time.time() < deadline and eng.merges == 0:
            time.sleep(0.05)
        assert eng.merges >= 1, "interval merger never drained"
        assert eng.snapshot()["pending"]["entries"] == 0
    finally:
        api.close()
        holder.close()


# --------------------------------------------------- crash window (proc)


@pytest.mark.skipif(
    os.environ.get("PILOSA_TPU_PROC_TESTS", "1") == "0",
    reason="process tests disabled")
def test_crash_between_buffer_and_merge():
    """Kill a real port server at ingest.pre-merge — deltas buffered,
    merge not run. Acked writes are already oplog-durable + host-applied,
    so the restarted server serves every acked column and the fragment
    files pass `check`: the device stack cache is the ONLY thing a crash
    loses.

    The TPU package's test arms the exit before its imports and waits
    for a 200 ms merge tick, which can fire between an import's buffer
    append and its ack. Here no tick can fire (a one-hour interval): the
    imports are acked first, the exit is armed after them, and the
    SIGTERM's clean stop drains the buffer — the drain that trips it."""
    from pilosa_tpu_torch.cli import main as cli_main
    from pilosa_tpu_torch.server import Client
    from pilosa_tpu_torch.utils.faultpoints import EXIT_CODE

    datadir = tempfile.mkdtemp(prefix="pilosa-torch-ingest-crash-")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    logpath = os.path.join(datadir, "server.log")
    client = Client(f"http://127.0.0.1:{port}", timeout=30, retries=0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO

    def spawn():
        log = open(logpath, "a")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server",
             "--device", "cpu", "--bind", f"127.0.0.1:{port}",
             "--data-dir", os.path.join(datadir, "data"),
             "--fsync", "always", "--ingest-merge-interval", "1h"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        log.close()
        return proc

    def wait_ready(proc, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited rc={proc.returncode}")
            try:
                client._request("GET", "/status")
                return
            except Exception:  # noqa: BLE001 — still booting
                time.sleep(0.25)
        raise TimeoutError("server not ready")

    proc = spawn()
    try:
        wait_ready(proc)
        client.create_index("cw")
        client.create_field("cw", "f")
        dbg = client._request("GET", "/debug/ingest")
        assert dbg["enabled"] is True
        acked = []
        for col in (11, 12, 13):
            client.import_bits("cw", "f", [1], [col])
            acked.append(col)
        assert client._request(
            "GET", "/debug/ingest")["pending"]["entries"] > 0
        client._request("POST", "/debug/faultpoints", json.dumps(
            {"arm": ["ingest.pre-merge=exit"]}).encode())
        proc.terminate()  # the clean stop's drain trips the exit
        rc = proc.wait(timeout=60)
        assert rc == EXIT_CODE, f"expected fault exit, rc={rc}"

        proc = spawn()
        wait_ready(proc)
        res = client.query("cw", "Row(f=1)")
        got = set(res["results"][0]["columns"])
        assert set(acked) <= got, f"lost acked writes: {set(acked) - got}"

        proc.terminate()
        proc.wait(timeout=60)
        frag_files = []
        for root, _dirs, files in os.walk(os.path.join(datadir, "data")):
            frag_files += [os.path.join(root, fn) for fn in files
                           if fn.isdigit()]
        assert frag_files, "no fragment files found"
        assert cli_main(["check", *frag_files]) == 0
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        shutil.rmtree(datadir, ignore_errors=True)
