"""The port's batched serving pipeline against the TPU package, on the CPU:
GroupCommit (`StackedEvaluator.try_count`), `Executor.execute_batch`, the
query coalescer (`API(coalesce_window=...)`) and the HTTP query-batch
route.

A data directory written by `pilosa_tpu.core.Holder` (random rows from a
numpy seed, a few shards at the real shard width) is copied twice: the
TPU package's Executor (JAX on the CPU, dense containers) serves one
copy, the port's (device="cpu") the other. Batched execution must give
the JAX package's results member by member — counts as exact ints, rows
with identical columns — and the same batch sizes. Tolerance: exact
equality.

The TPU package's tests of workload charging, flight-recorder events,
the SLOW QUERY line, the bare flight-recorder server and the plan
annotation read observability the port does not have, and have no
counterpart here.
"""

import json
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec import stacked as jax_stacked  # noqa: E402
from pilosa_tpu.ops import containers as jc  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.core.field import FieldOptions  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import stacked as torch_stacked  # noqa: E402
from pilosa_tpu_torch.ops import containers as tc  # noqa: E402
from pilosa_tpu_torch.server.api import (  # noqa: E402
    API,
    ApiError,
    ServiceUnavailableError,
)
from tests.test_containers import _stack  # noqa: E402

N_SHARDS = 3
N_ROWS = 6
MIXED = ("clustered_0.1pct", "runs", "random_50pct")  # sparse, rle, dense


def _write_reference_dir(path, seed=17):
    """Fields f and g: N_ROWS rows over 600 random columns each, in
    N_SHARDS shards (tests/test_batching.py's data). Field c: 6 rows
    cycling over a sparse, a run-length and a dense pattern."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    for fname in ("f", "g"):
        field = idx.create_field(fname)
        cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=600, replace=False)
        rows = rng.integers(0, N_ROWS, size=600)
        field.import_bits(rows.astype(np.uint64), cols.astype(np.uint64))
        idx.add_existence(cols.astype(np.uint64))
    c = idx.create_field("c")
    for row in range(6):
        stack = np.roll(_stack(MIXED[row % 3], s=N_SHARDS), 128 * row, axis=1)
        bits = np.unpackbits(stack.view(np.uint8), axis=1, bitorder="little")
        shard, off = np.nonzero(bits)
        cols = (shard * SHARD_WIDTH + off).astype(np.uint64)
        c.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
    h.close()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_batching")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = (jc.repr_mode(), tc.repr_mode())
    jc.configure("dense")
    tc.configure("dense")
    try:
        yield JaxExecutor(jh), API(th, device="cpu"), src
    finally:
        jc.configure(prev[0])
        tc.configure(prev[1])
        jh.close()
        th.close()


def _norm(result):
    """A result as plain data: a Row as its columns, a TopN/GroupBy list
    as its JSON, so the two packages' result classes compare."""
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    if isinstance(result, list):
        return [_norm(r) for r in result]
    if hasattr(result, "to_json"):
        return result.to_json()
    return result


def _norm_all(results):
    return None if results is None else [_norm(r) for r in results]


@pytest.fixture
def spy(monkeypatch):
    """Calls of K1's two entries as the count programs reach them: a
    list of member counts per batched call, and the single-query calls."""
    calls = {"batch": [], "single": 0}
    real_batch, real_single = tc.count_expr_batch, tc.count_expr

    def batch(sig, members):
        calls["batch"].append(len(members))
        return real_batch(sig, members)

    def single(sig, stacks):
        calls["single"] += 1
        return real_single(sig, stacks)

    monkeypatch.setattr(tc, "count_expr_batch", batch)
    monkeypatch.setattr(tc, "count_expr", single)
    return calls


# ------------------------------------------------------------ unit level


def test_batch_bucket_boundaries():
    assert torch_stacked.BATCH_BUCKETS == jax_stacked.BATCH_BUCKETS \
        == (1, 4, 16, 64)
    for n in range(1, 130):
        assert torch_stacked.batch_bucket(n) == jax_stacked.batch_bucket(n)
    assert torch_stacked.batch_bucket(100) == 64


def test_group_commit_leader_failure_reaches_every_waiter():
    gc = torch_stacked.GroupCommit()
    gc._window_s = gc.WINDOW_S = 0.2
    gc.RTT_DOMINATED_S = -1.0  # keep the window: every batch "slow"
    seen, errors = [], []
    start = threading.Barrier(4)

    def process(payloads):
        seen.append(list(payloads))
        raise RuntimeError("device lost")

    def worker(i):
        start.wait()
        try:
            gc.submit(i, process)
        except RuntimeError as e:
            errors.append(str(e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert errors == ["device lost"] * 4
    assert sorted(p for batch in seen for p in batch) == [0, 1, 2, 3]
    assert len(seen) < 4  # at least two waiters shared a leader


def test_group_commit_stress_no_lost_update():
    """16 threads x 150 submits with a short switch interval: every
    submit gets its own payload's result, and the batch counters add up
    to every submit (concurrent leaders update them under the lock)."""
    gc = torch_stacked.GroupCommit()
    n_threads, per_thread = 16, 150
    bad = []

    def worker(i):
        for k in range(per_thread):
            payload = (i, k)
            if gc.submit(payload, lambda ps: [p[::-1] for p in ps]) \
                    != payload[::-1]:
                bad.append(payload)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert bad == []
    assert gc.batched == n_threads * per_thread
    assert gc.batches <= gc.batched


# ------------------------------------------------- differential identity


CORPUS_SEED = 5


def _corpus():
    rng = np.random.default_rng(CORPUS_SEED)
    corpus = [f"Count(Row(f={rng.integers(0, N_ROWS)}))" for _ in range(17)]
    corpus += [f"Row(g={rng.integers(0, N_ROWS)})" for _ in range(6)]
    corpus += [f"Union(Row(f={rng.integers(0, N_ROWS)}), "
               f"Row(g={rng.integers(0, N_ROWS)}))" for _ in range(3)]
    corpus += ["Count(Intersect(Row(f=1), Row(g=2)))",
               "Difference(Row(f=0), Row(g=0))"]
    corpus += ["TopN(f, n=2)", "Count(Row(f=997))"]
    return corpus


def test_batched_bit_identical_across_buckets(env, spy):
    """Row/Intersect/Union/Count corpus with groups of 18, 6, 3 and 1
    (the TPU package's buckets 64, 16, 4, 1): results and batch sizes
    equal the TPU package's execute_batch member by member, and the
    18-member Count group is ONE call of K1's batched entry."""
    jex, api, _ = env
    ex = api.executor
    corpus = _corpus()
    want = jex.execute_batch("i", list(corpus))
    before = ex.stacked_stats()
    got = ex.execute_batch("i", list(corpus))
    assert len(got) == len(corpus)
    for pql, (res, err, bsize), (jres, jerr, jsize, _) in zip(
            corpus, got, want):
        assert err is None and jerr is None, (pql, err, jerr)
        assert _norm_all(res) == _norm_all(jres), pql
        assert _norm_all(res) == _norm_all(ex.execute("i", pql)), pql
        assert bsize == jsize, pql
    sizes = {}
    for pql, (_, _, bsize) in zip(corpus, got):
        name = pql.split("(", 1)[0]
        sizes[name] = max(sizes.get(name, 0), bsize)
    assert sizes == {"Count": 18, "Row": 6, "Union": 3, "Difference": 1,
                     "TopN": 0}
    assert 18 in spy["batch"]
    after = ex.stacked_stats()
    assert after["batch_dispatches"] - before["batch_dispatches"] == 5
    assert after["batched_queries"] - before["batched_queries"] == 29
    assert after["batch_fetches"] - before["batch_fetches"] == 1


def test_batch_error_isolation(env):
    jex, api, _ = env
    ex = api.executor
    queries = ["Count(Row(f=1))", "Count(Row(nosuch=1))", "Count(Row(f=2))"]
    out = ex.execute_batch("i", queries)
    jout = jex.execute_batch("i", queries)
    assert out[1][0] is None and "nosuch" in str(out[1][1])
    assert jout[1][1] is not None
    for i in (0, 2):
        res, err, bsize = out[i]
        assert err is None
        assert res == jout[i][0] == jex.execute("i", queries[i])
        assert bsize == jout[i][2] == 2


def test_batch_fallback_keyed_not_double_translated(env):
    """A member that falls back (never batchable, or a gather miss on a
    one-shard index) re-executes from its UNTRANSLATED form: key
    translation is not idempotent."""
    jex, api, _ = env
    ex = api.executor
    jex.holder.create_index("kd").create_field(
        "kf", JaxFieldOptions(keys=True))
    api.create_index("kd")
    api.create_field("kd", "kf", FieldOptions(keys=True))
    for pql in ('Set(7, kf="abc")', 'Set(9, kf="abc")'):
        jex.execute("kd", pql)
        api.query("kd", pql)
    queries = ['Count(Row(kf="abc"))', "TopN(kf)"]
    out = ex.execute_batch("kd", queries)
    jout = jex.execute_batch("kd", queries)
    assert out[0][1] is None, out[0][1]
    assert out[1][1] is None, out[1][1]
    assert out[0][0] == jout[0][0] == [2]
    assert _norm_all(out[1][0]) == _norm_all(jout[1][0])
    assert (out[0][2], out[1][2]) == (jout[0][2], jout[1][2]) == (0, 0)


def test_lone_count_takes_the_plain_path(env, spy):
    """A lone Count through try_count is one single-query K1 call and no
    batched one; its GroupCommit batch has one query."""
    jex, api, _ = env
    ex = api.executor
    pql = "Count(Intersect(Row(f=2), Row(g=3)))"
    ex.execute("i", pql)  # warm the leaves
    spy["single"] = 0
    before = ex.stacked_stats()
    assert ex.execute("i", pql) == jex.execute("i", pql)
    after = ex.stacked_stats()
    assert spy == {"batch": [], "single": 1}
    assert after["count_batches"] - before["count_batches"] == 1
    assert after["count_batched_queries"] \
        - before["count_batched_queries"] == 1
    assert torch_stacked.last_batch_size() == 1


def test_failed_batched_launch_reaches_its_members(env, monkeypatch):
    """A batched launch that fails is the error of every member that rode
    it; the per-query members still answer, and nothing re-runs."""
    jex, api, _ = env
    ex = api.executor
    runs = []

    def broken(*args):
        runs.append(args)
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tc, "count_program_batch", broken)
    queries = ["Count(Row(f=1))", "Count(Row(f=2))", "TopN(f, n=1)"]
    executed = []
    real_execute = ex.execute
    monkeypatch.setattr(ex, "execute", lambda *a, **k: executed.append(a)
                        or real_execute(*a, **k))
    out = ex.execute_batch("i", queries)
    assert [str(err) for _, err, _ in out[:2]] == ["launch failed"] * 2
    assert out[0][0] is None and out[1][0] is None
    assert out[2][1] is None
    assert _norm_all(out[2][0]) \
        == _norm_all(jex.execute("i", "TopN(f, n=1)"))
    assert len(runs) == 1
    assert [a[1] for a in executed] == ["TopN(f, n=1)"]


def test_failed_fetch_reaches_its_members(env, monkeypatch):
    jex, api, _ = env
    ex = api.executor

    def broken(handle):
        raise RuntimeError("fetch failed")

    monkeypatch.setattr(ex._stacked, "resolve_query_batch", broken)
    out = ex.execute_batch("i", ["Row(f=1)", "Count(Row(g=1))",
                                 "Count(Row(f=1)) Count(Row(g=1))"])
    assert [str(err) for _, err, _ in out[:2]] == ["fetch failed"] * 2
    assert out[2][1] is None
    assert out[2][0] == jex.execute("i", "Count(Row(f=1)) Count(Row(g=1))")


# ------------------------------------------------------------ GroupCommit


def _concurrent(fn, args):
    """fn(*a) for each a in `args` from its own thread, all released at
    one barrier; returns the results in order."""
    start = threading.Barrier(len(args))
    out = [None] * len(args)
    errors = []

    def worker(i):
        start.wait()
        try:
            out[i] = fn(*args[i])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    return out


def _slow_transport(ev):
    """Hold each GroupCommit leader 0.2 s before it drains, as on a
    round-trip dominated device, so threads released together batch."""
    for gc in (ev._count_commit, ev._fetch_commit):
        gc._window_s = gc.WINDOW_S = 0.2
        gc.RTT_DOMINATED_S = -1.0


def test_group_commit_concurrent_counts_match_reference(env, spy):
    """Counts released together from threads at a barrier fuse; those
    over other shard sets (a `shards` argument) count apart, all equal
    to the JAX executor's."""
    jex, api, _ = env
    ex = Executor(api.holder, device="cpu")
    queries = [f"Count(Intersect(Row(f={a}), Row(g={b})))"
               for a in range(N_ROWS) for b in range(2)]
    args = [("i", q) for q in queries] \
        + [("i", q, [0, 2]) for q in queries[:4]]
    for a in args:
        ex.execute(*a)  # warm the leaves: the gathers are hits
    _slow_transport(ex._stacked)
    before = ex.stacked_stats()
    got = _concurrent(ex.execute, args)
    assert got == [jex.execute(*a) for a in args]
    after = ex.stacked_stats()
    batches = after["count_batches"] - before["count_batches"]
    queued = after["count_batched_queries"] - before["count_batched_queries"]
    assert queued == len(args)
    assert queued > batches
    assert max(spy["batch"]) >= 2  # a dense group counted in one call


@pytest.fixture
def auto_mode():
    """The auto chooser at CPU scale: the 4 MiB floor drops to 0."""
    saved = (tc.repr_mode(), tc.AUTO_COMPRESS_FLOOR)
    tc.configure("auto")
    tc.AUTO_COMPRESS_FLOOR = 0
    yield
    tc.configure(saved[0])
    tc.AUTO_COMPRESS_FLOOR = saved[1]


MIXED_COUNTS = [
    "Count(Row(c=0))", "Count(Row(c=3))",            # sparse: K2
    "Count(Row(c=1))", "Count(Row(c=4))",            # rle: run sums
    "Count(Row(c=2))", "Count(Row(c=5))",            # dense: K1
    "Count(Intersect(Row(c=0), Row(c=3)))",          # sparse pair: K2
    "Count(Intersect(Row(c=1), Row(c=4)))",          # rle pair
    "Count(Union(Row(c=0), Row(c=2)))",              # densified: K1
    "Count(Union(Row(c=3), Row(c=5)))",
    "Count(Xor(Row(c=1), Row(c=2)))",
    "Count(Xor(Row(c=4), Row(c=5)))",
]


def test_group_commit_mixed_containers(env, auto_mode, spy):
    """Concurrent Counts over sparse, run-length and dense leaves under
    the auto chooser: each group takes its own count strategy inside one
    GroupCommit batch, and every answer is the JAX executor's."""
    jex, api, _ = env
    ex = Executor(api.holder, device="cpu")
    for pql in MIXED_COUNTS:
        ex.execute("i", pql)
    kinds = {tc.kind_of(e[1]) for e in ex._stacked._pools["leaf"].values()}
    assert kinds == {"dense", "sparse", "rle"}
    _slow_transport(ex._stacked)
    before = ex.stacked_stats()
    got = _concurrent(ex.execute, [("i", q) for q in MIXED_COUNTS])
    assert got == [jex.execute("i", q) for q in MIXED_COUNTS]
    after = ex.stacked_stats()
    assert after["count_batched_queries"] - before["count_batched_queries"] \
        > after["count_batches"] - before["count_batches"]


def test_group_commit_shares_fetches(env):
    """Concurrent TopN and GroupBy share their device->host fetches
    through the fetch GroupCommit, with the JAX executor's answers."""
    jex, api, _ = env
    ex = Executor(api.holder, device="cpu")
    queries = ["TopN(f, n=3)", "TopN(g, Row(f=1), n=2)",
               "GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(g))"] * 2
    want = [_norm_all(jex.execute("i", q)) for q in queries]
    for q in queries:
        ex.execute("i", q)
    _slow_transport(ex._stacked)
    before = ex.stacked_stats()
    got = _concurrent(ex.execute, [("i", q) for q in queries])
    assert [_norm_all(r) for r in got] == want
    after = ex.stacked_stats()
    fetched = after["group_fetched_queries"] - before["group_fetched_queries"]
    assert fetched > after["group_fetches"] - before["group_fetches"]


# ------------------------------------------------------- coalescer layer


def test_coalescer_fuses_concurrent_queries(env):
    jex, api, _ = env
    capi = API(api.holder, device="cpu", coalesce_window=0.005)
    try:
        queries = [f"Count(Row(f={r}))" for r in range(N_ROWS)]
        got = _concurrent(capi.query, [("i", q) for q in queries])
        assert got == [jex.execute("i", q) for q in queries]
        st = capi.batching_stats()["coalescer"]
        assert st["enabled"]
        assert st["coalesced_queries"] == N_ROWS
        assert st["max_occupancy"] >= 2
        assert st["queue_depth"] == 0
    finally:
        capi.close()


def test_coalescer_ineligible_queries_use_legacy_path(env):
    jex, api, _ = env
    capi = API(api.holder, device="cpu", coalesce_window=0.005)
    try:
        assert _norm_all(capi.query("i", "TopN(f, n=2)")) \
            == _norm_all(jex.execute("i", "TopN(f, n=2)"))
        multi = "Count(Row(f=1)) Count(Row(f=2))"
        assert capi.query("i", multi) == jex.execute("i", multi)
        with pytest.raises(ApiError):
            capi.query("i", "Count(Row(f=")
        assert capi.batching_stats()["coalescer"]["coalesced_queries"] == 0
    finally:
        capi.close()


def test_window_zero_is_legacy_path(env):
    jex, api, _ = env
    assert api._coalescer is None
    st = api.batching_stats()
    assert st["coalescer"]["enabled"] is False
    before = api.executor.stacked_stats()["batch_dispatches"]
    assert api.query("i", "Count(Row(f=3))") \
        == jex.execute("i", "Count(Row(f=3))")
    assert api.executor.stacked_stats()["batch_dispatches"] == before


def test_coalescer_overload_rejects_503(env):
    _, api, _ = env
    capi = API(api.holder, device="cpu", coalesce_window=0.005,
               coalesce_max_queue=0)
    with pytest.raises(ServiceUnavailableError) as ei:
        capi.query("i", "Count(Row(f=1))")
    assert ei.value.status == 503
    assert int(ei.value.headers["Retry-After"]) >= 1
    assert ei.value.headers["X-Pilosa-Shed"] == "coalesce"
    assert capi._coalescer.stats()["rejected"] == 1
    capi.close()


def test_coalescer_survives_drain_loop_errors(env, monkeypatch):
    """An exception outside the guarded launch/resolve calls (here: the
    loop's grouping) is delivered to the waiting members — not left to
    kill the drain thread — and the thread keeps serving."""
    jex, api, _ = env
    capi = API(api.holder, device="cpu", coalesce_window=0.001)
    real, armed = capi._coalescer._group, [True]

    def bad_group(members):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("grouping exploded")
        return real(members)

    monkeypatch.setattr(capi._coalescer, "_group", bad_group)
    try:
        with pytest.raises(ApiError, match="grouping exploded"):
            capi.query("i", "Count(Row(f=1))")
        thread = capi._coalescer._thread
        assert capi.query("i", "Count(Row(f=1))") \
            == jex.execute("i", "Count(Row(f=1))")
        assert capi._coalescer._thread is thread and thread.is_alive()
    finally:
        capi.close()


def test_coalescer_close_unblocks_waiters(env):
    jex, api, _ = env
    api.close()  # window 0: no coalescer, a no-op
    capi = API(api.holder, device="cpu", coalesce_window=30.0)
    done = []

    def worker():
        try:
            done.append(("ok", capi.query("i", "Count(Row(f=1))")))
        except Exception as e:  # noqa: BLE001 — surfaced via done
            done.append(("err", e))

    t = threading.Thread(target=worker)
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline \
            and capi._coalescer._thread is None and not done:
        time.sleep(0.002)
    time.sleep(0.02)  # let the drain thread pop into its window wait
    capi.close()
    t.join(timeout=10)
    assert not t.is_alive(), "close() left a waiter hanging"
    kind, val = done[0]
    if kind == "ok":  # batch launched before close: real results
        assert val == jex.execute("i", "Count(Row(f=1))")
    else:
        assert isinstance(val, ApiError)
    with pytest.raises(ServiceUnavailableError):
        capi._coalescer.submit("i", None)
    capi.close()  # idempotent


# ------------------------------------------------------------ HTTP layer


def _http(uri, path, body=None):
    req = urllib.request.Request(
        uri + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture
def served(env, tmp_path):
    jex, _, src = env
    data = str(tmp_path / "served")
    shutil.copytree(src, data)
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", data,
                        "--device", "cpu", "--coalesce-window", "1ms"])
    yield jex, srv
    srv.stop()


def test_http_query_batch_route(served):
    jex, srv = served
    queries = ["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=1)",
               "Count(Row(bad=1))", "Count(Intersect(Row(f=2), Row(g=2)))",
               "Count(Row(f=4))"]
    out = _http(srv.uri, "/index/i/query-batch",
                json.dumps({"queries": queries}))["results"]
    jout = jex.execute_batch("i", queries)
    assert out[0]["results"] == jout[0][0]
    assert out[1]["results"][0]["columns"] \
        == [int(c) for c in jout[1][0][0].columns()]
    assert out[2]["results"][0] == [p.to_json() for p in jout[2][0][0]]
    assert "bad" in out[3]["error"]
    assert out[4]["results"] == jout[4][0]
    assert out[5]["results"] == jout[5][0]
    assert [o.get("batch") for o in out] == [2, 1, 0, None, 1, 2]
    assert _http(srv.uri, "/index/i/query-batch",
                 json.dumps(queries[:1]))["results"][0]["results"] \
        == jout[0][0]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _http(srv.uri, "/index/i/query-batch", '{"queries": "not-a-list"}')
    assert ei.value.code == 400


def test_http_debug_batching(served):
    jex, srv = served
    queries = [f"Count(Row(g={r}))" for r in range(N_ROWS)]
    got = _concurrent(lambda q: _http(srv.uri, "/index/i/query", q),
                      [(q,) for q in queries])
    assert [g["results"] for g in got] \
        == [jex.execute("i", q) for q in queries]
    st = _http(srv.uri, "/debug/batching")
    assert st["coalescer"]["enabled"] is True
    assert st["coalescer"]["window_seconds"] == 0.001
    assert st["coalescer"]["coalesced_queries"] == N_ROWS
    assert st["batched_queries"] >= N_ROWS
    assert {"batch_dispatches", "count_batches",
            "count_batched_queries"} <= set(st)


def test_http_overload_503_headers(env, tmp_path):
    """A full coalesce queue answers 503 with Retry-After and
    X-Pilosa-Shed over HTTP."""
    _, _, src = env
    data = str(tmp_path / "shed")
    shutil.copytree(src, data)
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", data,
                        "--device", "cpu", "--coalesce-window", "1ms",
                        "--coalesce-max-queue", "0"])
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http(srv.uri, "/index/i/query", "Count(Row(f=1))")
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert ei.value.headers["X-Pilosa-Shed"] == "coalesce"
    finally:
        srv.stop()
