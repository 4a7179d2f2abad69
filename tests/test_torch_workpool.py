"""The port's worker pool, on the CPU.

Ported from tests/test_workpool.py, test_workpool_differential.py and
test_workpool_serving.py: bounded concurrency, submission-ordered
results, fail-fast cancellation of unclaimed tasks, the workers=1
serial oracle, inline nested calls, shutdown draining, `configure`, the
gauges and `stats()`, tasks adopting the submitter's span; then a
corpus of every query class through the port's executor at workers=1
and workers=8 (stacked and with the stacked fast paths disabled), equal
to each other and to the TPU package's executor on a copy of the same
data; and concurrent stacked and per-shard queries from many threads,
which must neither wedge nor diverge.
"""

import shutil
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils import flightrec, profile, tracing  # noqa: E402
from pilosa_tpu_torch.utils import workpool  # noqa: E402
from pilosa_tpu_torch.utils.stats import global_stats  # noqa: E402
from pilosa_tpu_torch.utils.workpool import (  # noqa: E402
    WorkPool,
    shard_map_reduce,
)


def test_ordered_results_match_serial():
    pool = WorkPool(workers=4)
    try:
        items = list(range(100))

        def slow_square(x):
            time.sleep(0.001 * (x % 7))
            return x * x

        assert pool.map_ordered(slow_square, items) == \
            [x * x for x in items]
    finally:
        pool.shutdown()


def test_bounded_concurrency():
    workers = 3
    pool = WorkPool(workers=workers)
    try:
        active, peak = [0], [0]
        lock = threading.Lock()

        def task(_):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.01)
            with lock:
                active[0] -= 1

        pool.map_ordered(task, range(30))
        assert 1 < peak[0] <= workers
    finally:
        pool.shutdown()


def test_error_propagates_and_cancels_queued():
    workers = 2
    pool = WorkPool(workers=workers)
    try:
        failed = threading.Event()
        ran_after_error = [0]

        def task(i):
            if i == 0:
                failed.set()
                raise ValueError("boom")
            if failed.wait(timeout=5):
                time.sleep(0.005)
            if failed.is_set():
                ran_after_error[0] += i > workers
            return i

        with pytest.raises(ValueError, match="boom"):
            pool.map_ordered(task, range(50))
        assert ran_after_error[0] <= workers
        assert pool.stats()["errors"] == 1
        assert pool.stats()["queue_depth"] == 0
    finally:
        pool.shutdown()


def test_workers_1_runs_inline_on_caller():
    pool = WorkPool(workers=1)
    try:
        caller = threading.current_thread().ident
        threads = pool.map_ordered(
            lambda _: threading.current_thread().ident, range(10))
        assert set(threads) == {caller}
        assert pool._threads == []
        assert pool.stats()["inline_jobs"] == 1
    finally:
        pool.shutdown()


def test_nested_submit_from_worker_runs_inline():
    pool = WorkPool(workers=2)
    try:
        def outer(x):
            return sum(pool.map_ordered(lambda y: y + 1, range(x)))

        assert pool.map_ordered(outer, range(8)) == \
            [sum(y + 1 for y in range(x)) for x in range(8)]
    finally:
        pool.shutdown()


def test_shard_map_reduce_ordered_reduce():
    pool = WorkPool(workers=4)
    try:
        out = shard_map_reduce(
            range(20), lambda x: str(x),
            reducer=lambda acc, s: acc + s, initial="", pool=pool)
        assert out == "".join(str(x) for x in range(20))
        assert shard_map_reduce(range(5), lambda x: -x, pool=pool) == \
            [0, -1, -2, -3, -4]
    finally:
        pool.shutdown()


def test_serial_oracle_equivalence():
    serial, parallel = WorkPool(workers=1), WorkPool(workers=8)
    try:
        items = list(range(200))
        mapper = lambda x: (x * 7919) % 1000  # noqa: E731
        assert shard_map_reduce(items, mapper, pool=serial) \
            == shard_map_reduce(items, mapper, pool=parallel)
    finally:
        serial.shutdown()
        parallel.shutdown()


def test_shutdown_drains_queued_jobs():
    pool = WorkPool(workers=2)
    pool.map_ordered(lambda x: x, range(4))
    done = threading.Event()
    results = []

    def submit():
        results.append(pool.map_ordered(lambda x: x * 2, range(20)))
        done.set()

    t = threading.Thread(target=submit)
    t.start()
    pool.shutdown()
    assert done.wait(timeout=10), "submitter hung across shutdown"
    t.join()
    assert results == [[x * 2 for x in range(20)]]


def test_configure_replaces_process_pool():
    old = workpool.get_pool()
    try:
        p = workpool.configure(3)
        assert workpool.get_pool() is p
        assert workpool.worker_count() == 3
        assert p.map_ordered(lambda x: x + 1, range(5)) == [1, 2, 3, 4, 5]
    finally:
        workpool.configure(old.workers)


def test_default_workers_env(monkeypatch):
    import os

    default = min(32, os.cpu_count() or 1)
    monkeypatch.setenv("PILOSA_TPU_WORKERS", "5")
    assert workpool.default_workers() == 5
    monkeypatch.setenv("PILOSA_TPU_WORKERS", "nope")
    assert workpool.default_workers() == default
    monkeypatch.setenv("PILOSA_TPU_WORKERS", "-2")
    assert workpool.default_workers() == default


def test_gauges_and_stats_settle_to_zero():
    pool = WorkPool(workers=4)
    try:
        pool.map_ordered(lambda x: x, range(64))
        s = pool.stats()
        assert s["queue_depth"] == 0 and s["busy_workers"] == 0
        assert s["tasks"] == 64 and s["jobs"] == 1
        _, gauges, _ = global_stats.snapshot()
        assert gauges[("workpool_queue_depth", ())] == 0
        assert gauges[("workpool_busy_workers", ())] == 0
    finally:
        pool.shutdown()


def test_tasks_adopt_the_submitters_span():
    """Pool work lands in the submitting query's profile: each task runs
    under a `workpool.task` span that is a child of the submitter's."""
    pool = WorkPool(workers=3)
    prof = profile.begin("i", "Count(Row(f=1))")
    try:
        with tracing.with_span(prof.root):
            pool.map_ordered(lambda x: x, range(6))
    finally:
        prof.finish()
        pool.shutdown()
    tree = prof.to_dict()["spans"]
    tasks = [c for c in tree["children"] if c["name"] == "workpool.task"]
    assert sorted(c["tags"]["task"] for c in tasks) == list(range(6))


def test_saturation_event():
    pool = WorkPool(workers=2)
    gate = threading.Event()
    try:
        flightrec.configure(64)
        t = threading.Thread(
            target=pool.map_ordered, args=(lambda _: gate.wait(5), range(6)))
        t.start()
        deadline = time.time() + 5
        while pool.stats()["busy_workers"] < 2 and time.time() < deadline:
            time.sleep(0.005)
        t2 = threading.Thread(target=pool.map_ordered,
                              args=(lambda x: x, range(3)))
        t2.start()
        gate.set()
        t.join()
        t2.join()
        events = [e for e in flightrec.snapshot()["events"]
                  if e["kind"] == "workpool.saturated"]
        assert events and events[0]["tags"]["workers"] == 2
    finally:
        gate.set()
        pool.shutdown()
        flightrec.configure(flightrec.DEFAULT_RING_SIZE)


# ------------------------------------------------------------ differential

N_SHARDS = 12

CORPUS = [
    "Row(f=1)",
    "Row(f=2)",
    "Intersect(Row(f=1), Row(f=2))",
    "Union(Row(f=1), Row(f=2), Row(f=3))",
    "Difference(Row(f=1), Row(f=2))",
    "Xor(Row(f=1), Row(f=2))",
    "Not(Row(f=1))",
    "Count(Row(f=1))",
    "Count(Union(Row(f=1), Row(f=2)))",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Min(Row(f=2), field=v)",
    "Max(Row(f=2), field=v)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "TopN(f, n=3)",
    "TopN(f)",
    "TopN(f, Row(g=9), n=5)",
    "Rows(f)",
    "Rows(f, limit=2)",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=1))",
    "Row(v > 3)",
    "Row(v < 9)",
    "Count(Row(v >= 5))",
]


def normalize(result):
    """Comparable across packages: Rows become their column tuples,
    result objects their JSON shape; lists recurse."""
    if isinstance(result, list):
        return [normalize(r) for r in result]
    if hasattr(result, "columns"):
        return ("row", tuple(int(c) for c in result.columns()))
    if hasattr(result, "to_json"):
        return result.to_json()
    return result


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """The same data written through the TPU package, copied twice."""
    base = tmp_path_factory.mktemp("wpdiff")
    src = str(base / "src")
    h = JaxHolder(src, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    v = idx.create_field("v", JaxFieldOptions(type="int", min=0, max=1000))
    rng = np.random.RandomState(7)
    rows, cols = [], []
    for shard in range(N_SHARDS):
        base_col = shard * SHARD_WIDTH
        n = 40 + (shard % 5) * 10
        cs = rng.choice(10_000, size=n, replace=False).astype(np.int64) \
            + base_col
        rows.extend(int(r) for r in rng.randint(1, 6, size=n))
        cols.extend(int(c) for c in cs)
    f.import_bits(rows, cols)
    g.import_bits([9] * (len(cols) // 2), cols[: len(cols) // 2])
    v.import_values(cols, [c % 17 for c in cols])
    idx.add_existence(cols)
    h.close()
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    return str(base / "jax"), str(base / "torch")


@pytest.fixture(scope="module")
def port_holder(data_dirs):
    h = Holder(data_dirs[1], use_snapshot_queue=False).open()
    yield h
    h.close()


def run_corpus(holder, workers, force_fallback):
    pool = WorkPool(workers=workers)
    e = Executor(holder, device="cpu")
    if force_fallback:
        # neuter every stacked fast path so the per-shard loops run
        e._stacked.try_count = lambda *a, **k: None
        e._stacked.try_sum = lambda *a, **k: None
        e._stacked.try_minmax = lambda *a, **k: None
        e._stacked.filter_stack = lambda *a, **k: (False, None)
    old = workpool._pool
    workpool._pool = pool
    try:
        return [normalize(e.execute("i", q)) for q in CORPUS]
    finally:
        workpool._pool = old
        pool.shutdown()


@pytest.mark.parametrize("force_fallback", [False, True],
                         ids=["stacked", "fallback"])
def test_workers_1_vs_8_bit_identical(port_holder, force_fallback):
    serial = run_corpus(port_holder, 1, force_fallback)
    parallel = run_corpus(port_holder, 8, force_fallback)
    for q, r1, r8 in zip(CORPUS, serial, parallel):
        assert r1 == r8, f"divergence at workers=8 for {q!r}"


def test_corpus_equals_the_reference(data_dirs, port_holder):
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    jh = JaxHolder(data_dirs[0], use_snapshot_queue=False).open()
    try:
        jex = JaxExecutor(jh)
        want = [normalize(jex.execute("i", q)) for q in CORPUS]
    finally:
        jh.close()
        jax_containers.configure(prev)
    got = run_corpus(port_holder, 8, False)
    for q, g, w in zip(CORPUS, got, want):
        assert g == w, q


def test_fallback_matches_stacked_serial(port_holder):
    assert run_corpus(port_holder, 1, False) \
        == run_corpus(port_holder, 1, True)


# ----------------------------------------------------------------- serving


def test_concurrent_stacked_and_fallback_no_wedge(port_holder):
    """Warm and cold stacked caches and per-shard fallbacks serve one
    holder from six threads through an 8-worker pool: nobody wedges on
    the dispatch lock, every answer equals the serial one."""
    old = workpool._pool
    pool = workpool.WorkPool(workers=8)
    workpool._pool = pool
    try:
        e = Executor(port_holder, device="cpu")
        queries = ["Count(Row(f=1))", "Count(Union(Row(f=1), Row(f=2)))",
                   "TopN(f, n=2)", "GroupBy(Rows(f))"]
        expected = {q: normalize(e.execute("i", q)[0]) for q in queries}
        e2 = Executor(port_holder, device="cpu")  # a cold cache too
        errors = []
        barrier = threading.Barrier(6)

        def client(k):
            ex = e if k % 2 == 0 else e2
            try:
                barrier.wait(timeout=30)
                for _ in range(5):
                    for q, want in expected.items():
                        got = normalize(ex.execute("i", q)[0])
                        if got != want:
                            errors.append((q, want, got))
            except Exception as exc:  # noqa: BLE001 — reported via errors
                errors.append(("exception", k, repr(exc)))

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not [t.name for t in threads if t.is_alive()]
        assert not errors, errors[:3]
        # queries submitted FROM pool workers run their shard loops
        # inline on that worker, without deadlock
        count = e.execute("i", "Count(Row(f=1))")[0]
        assert pool.map_ordered(
            lambda _: e.execute("i", "Count(Row(f=1))")[0],
            range(12)) == [count] * 12
    finally:
        workpool._pool = old
        pool.shutdown()
