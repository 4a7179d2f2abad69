"""Concurrency stress and the storage invariant checks, held against
the port on the CPU: the cases of `tests/test_stress.py` and
`tests/test_paranoia.py`.

The stress cases run under PILOSA_TPU_PARANOIA=1, so every fragment
write is checked against the storage invariants. One round
(`pilosa_tpu_torch.tools.stress.concurrent_round`) runs writers on
disjoint column ranges of 3 shards, readers through the stacked paths,
a snapshotter and a DDL churn at once; afterwards every row must equal
the writers' record and every fragment must pass `storage.check()`. A
second case holds the mutex invariant (one row per column) under
concurrent writers. Every thread joins with a timeout. Torch runs one
intra-op thread in this module: the threads here are Python threads
over small CPU tensors.

The paranoia cases hold `Bitmap.check` and `container_check` to the
reference's corruptions, the rejection of a corrupt roaring import under
PILOSA_TPU_PARANOIA=1, and `/debug/pprof` on the port's own server.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.core import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.roaring.bitmap import Bitmap  # noqa: E402
from pilosa_tpu_torch.roaring.containers import (  # noqa: E402
    TYPE_ARRAY, TYPE_BITMAP, TYPE_RUN, Container, container_check)
from pilosa_tpu_torch.server.api import API  # noqa: E402
from pilosa_tpu_torch.tools import stress  # noqa: E402

OPS_PER_WRITER = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_PARANOIA", "1")
    holder = Holder(str(tmp_path)).open()
    yield holder, API(holder, device="cpu"), Executor(holder, device="cpu")
    holder.close()


def test_concurrent_read_write_snapshot_ddl(env):
    _, api, ex = env
    n = stress.concurrent_round(api, ex, ops_per_writer=OPS_PER_WRITER)
    assert 0 < n <= stress.N_WRITERS * OPS_PER_WRITER


def test_concurrent_mutex_last_write_wins(env):
    """Concurrent mutex writes to distinct columns keep the one-row-per-
    column invariant under interleaving."""
    holder, api, ex = env
    api.create_index("st")
    api.create_field("st", "m", FieldOptions.mutex_field())
    idx = holder.index("st")
    errors = []

    def writer(i):
        try:
            rng = np.random.default_rng(i)
            for _ in range(100):
                # disjoint columns per writer
                col = int(rng.integers(0, 500)) * stress.N_WRITERS + i
                api.query("st", f"Set({col}, m={int(rng.integers(0, 6))})")
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(stress.N_WRITERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=stress.JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in threads), "mutex writers hung"
    assert not errors, errors

    # invariant: every column is set in at most one row
    view = idx.field("m").view("standard")
    for frag in view.fragments.values():
        seen = {}
        for row in frag.row_ids():
            for col in np.asarray(frag.row_columns(row)).tolist():
                assert col not in seen, (col, seen[col], row)
                seen[col] = row


# ------------------------------------------------------------- paranoia


def test_healthy_bitmap_checks_clean():
    b = Bitmap.from_bits([1, 5, 100000, 2**33, 2**33 + 1])
    assert b.check() is True


def test_check_catches_bad_cardinality():
    b = Bitmap.from_bits([1, 2, 3])
    key = b.keys()[0]
    b.containers[key].n = 99
    with pytest.raises(AssertionError, match="values"):
        b.check()


def test_check_catches_unsorted_array():
    c = Container(TYPE_ARRAY,
                  values=np.array([5, 3, 9], dtype=np.uint16), n=3)
    assert any("sorted" in e for e in container_check(c))


def test_check_catches_bitmap_miscount():
    words = np.zeros(2048, dtype=np.uint32)
    words[0] = 0b111
    c = Container(TYPE_BITMAP, words=words, n=5)
    assert any("bits set" in e for e in container_check(c))


def test_check_catches_overlapping_runs():
    c = Container(TYPE_RUN,
                  runs=np.array([[0, 10], [5, 20]], dtype=np.uint16))
    assert any("overlap" in e for e in container_check(c))


def test_paranoia_env_rejects_corrupt_import(tmp_path, monkeypatch):
    """PILOSA_TPU_PARANOIA=1 validates foreign roaring blobs before merge
    (import paths accept data from other nodes)."""
    from pilosa_tpu_torch.core import FieldOptions, Holder
    from pilosa_tpu_torch.roaring import codec

    bad = Bitmap.from_bits([1, 2, 3])
    # corrupt: unsorted array payload (parses fine, violates invariants)
    bad.containers[bad.keys()[0]].values = np.array(
        [9, 3, 5], dtype=np.uint16)
    blob = codec.serialize(bad, optimize=False)

    monkeypatch.setenv("PILOSA_TPU_PARANOIA", "1")
    holder = Holder(str(tmp_path)).open()
    try:
        idx = holder.create_index("p")
        idx.create_field("f", FieldOptions())
        view = idx.field("f").create_view_if_not_exists("standard")
        frag = view.create_fragment_if_not_exists(0)
        with pytest.raises(AssertionError):
            frag.import_roaring(blob)
    finally:
        holder.close()


def test_debug_pprof_routes(tmp_path):
    from pilosa_tpu_torch.tools.cluster import NodeHarness

    h = NodeHarness(data_dir=str(tmp_path), device="cpu")
    try:
        dump = h.client._request("GET", "/debug/pprof/goroutine")
        assert b"thread" in dump
        h.client._request(
            "POST", "/debug/pprof/profile/start?interval=0.002")
        h.client.create_index("pp")
        h.client.create_field("pp", "f")
        for i in range(20):  # serving work on OTHER threads gets sampled
            h.client.query("pp", f"Set({i}, f=1)")
        stats = h.client._request("POST", "/debug/pprof/profile/stop")
        text = stats.decode()
        assert "samples:" in text
        n = int(text.split("samples:")[1].split()[0])
        assert n > 0, text  # cross-thread sampling actually captured work
    finally:
        h.close()
