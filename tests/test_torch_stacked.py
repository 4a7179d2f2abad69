"""The port's stacked Count path (`pilosa_tpu_torch.exec.stacked`) on
the CPU: the cases of `tests/test_stacked.py`.

One-dispatch whole-index Counts over generation-invalidated stacks,
against the per-shard path, the JAX package on a copy of the same data
directory, and writes through every path; the stack pool's byte bound;
a dropped and re-created field; `test_stacks_sharded_over_devices`
over a node of several parts (exec/parts.py): one part per device
entry, S padded to a multiple of the parts. Tolerance: exact equality.
"""

import numpy as np
import pytest

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture
def setup(tmp_path):
    holder = Holder(str(tmp_path)).open()
    api = API(holder, device="cpu")
    api.create_index("st")
    api.create_field("st", "f")
    api.create_field("st", "g")
    rng = np.random.default_rng(5)
    for field in ("f", "g"):
        for row in (1, 2):
            cols = rng.choice(4 * SHARD_WIDTH, size=500, replace=False)
            api.import_bits("st", field, [row] * len(cols), cols.tolist())
    yield holder, api
    holder.close()


QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=1), Row(g=2), Row(f=2)))",
    "Count(Difference(Row(f=1), Row(g=1)))",
    "Count(Xor(Row(f=1), Row(g=2)))",
    "Count(Not(Row(f=1)))",
    "Count(Intersect(Union(Row(f=1), Row(g=1)), Not(Row(g=2))))",
]


def test_fast_path_matches_general(setup):
    holder, api = setup
    ex = Executor(holder, device="cpu")
    for q in QUERIES:
        fast = ex.execute("st", q)[0]
        # force the general path by dropping below MIN_SHARDS per call
        general = sum(
            ex.execute("st", q, shards=[s])[0] for s in range(4))
        assert fast == general, q


def test_fast_path_actually_used(setup):
    holder, api = setup
    ex = Executor(holder, device="cpu")
    ex.execute("st", "Count(Row(f=1))")
    assert len(ex._stacked._pools["leaf"]) > 0
    # below MIN_SHARDS the per-shard path serves and never populates the
    # pool (the port stacks Shift leaves, so the reference's Shift probe
    # would not fall back here)
    before = len(ex._stacked._pools["leaf"])
    ex.execute("st", "Count(Row(g=2))", shards=[1])
    assert len(ex._stacked._pools["leaf"]) == before


def test_write_invalidates_stack(setup):
    holder, api = setup
    ex = Executor(holder, device="cpu")
    n0 = ex.execute("st", "Count(Row(f=1))")[0]
    # a write through ANY path bumps fragment.generation
    taken = set(int(c) for c in api.query("st", "Row(f=1)")[0].columns())
    free = next(c for c in range(SHARD_WIDTH) if c not in taken)
    api.query("st", f"Set({free}, f=1)")
    assert ex.execute("st", "Count(Row(f=1))")[0] == n0 + 1
    api.query("st", f"Clear({free}, f=1)")
    assert ex.execute("st", "Count(Row(f=1))")[0] == n0


def test_lru_byte_bound(setup):
    from pilosa_tpu_torch.exec import stacked
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    holder, api = setup
    ex = Executor(holder, device="cpu")
    orig = stacked.MAX_STACK_BYTES
    stacked.MAX_STACK_BYTES = 3 * 4 * WORDS_PER_ROW * 4  # ~3 4-shard stacks
    try:
        for row in (1, 2):
            for field in ("f", "g"):
                ex.execute("st", f"Count(Row({field}={row}))")
        assert ex._stacked._pool_bytes["leaf"] <= stacked.MAX_STACK_BYTES
        assert len(ex._stacked._pools["leaf"]) <= 3
        # evicted rows still answer correctly (rebuilt on demand)
        assert ex.execute("st", "Count(Row(f=1))")[0] > 0
    finally:
        stacked.MAX_STACK_BYTES = orig


def test_field_recreate_not_stale(setup):
    """Dropping and recreating a field must never serve the old field's
    cached stacks (fragment uids distinguish the incarnations even when
    generation counters collide)."""
    holder, api = setup
    ex = Executor(holder, device="cpu")

    api.create_field("st", "tmp")
    cols = list(range(0, 4 * SHARD_WIDTH, SHARD_WIDTH // 2))
    api.import_bits("st", "tmp", [1] * len(cols), cols)
    n0 = ex.execute("st", "Count(Row(tmp=1))")[0]
    assert n0 == len(cols)
    api.delete_field("st", "tmp")
    api.create_field("st", "tmp")
    api.import_bits("st", "tmp", [1, 1], [3, SHARD_WIDTH + 4])
    assert ex.execute("st", "Count(Row(tmp=1))")[0] == 2


def test_missing_fragments_are_zero(setup):
    holder, api = setup
    ex = Executor(holder, device="cpu")
    api.create_field("st", "empty")
    assert ex.execute("st", "Count(Row(empty=9))")[0] == 0
    n = ex.execute("st", "Count(Row(f=1))")[0]
    assert ex.execute(
        "st", "Count(Union(Row(f=1), Row(empty=9)))")[0] == n


def test_fast_path_matches_jax(setup, tmp_path_factory):
    """The JAX package on a copy of the same data directory answers every
    query alike."""
    import shutil

    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.exec import Executor as JaxExecutor

    holder, api = setup
    copy = str(tmp_path_factory.mktemp("jax") / "data")
    shutil.copytree(holder.path, copy)
    jh = JaxHolder(copy, use_snapshot_queue=False).open()
    try:
        ex, jex = Executor(holder, device="cpu"), JaxExecutor(jh)
        for q in QUERIES:
            assert ex.execute("st", q) == jex.execute("st", q), q
    finally:
        jh.close()


@pytest.mark.parametrize("k", [2, 3, 8])
def test_stacks_sharded_over_devices(setup, k):
    """On a node of k parts the cached stacks are split over them, one
    contiguous range a part (the reference's mesh-sharded stacks): a
    part per device entry, S zero-padded to a multiple of k, and the
    Count equal to the one-part node's."""
    holder, api = setup
    one = Executor(holder, device="cpu").execute("st", "Count(Row(f=1))")[0]
    ex = Executor(holder, device=["cpu"] * k)
    assert ex.execute("st", "Count(Row(f=1))")[0] == one > 0
    parts = ex._stacked.parts
    assert len(parts) == len(ex.devices) == k
    n = -(-4 // k)  # 4 shards
    for part in parts:
        (entry,) = list(part._pools["leaf"].values())
        stack = entry[1].arrays[0]  # dense container: (plane stack,)
        assert stack.device == part.device
        assert stack.shape[0] == n
    assert n * k % k == 0 and n * k >= 4  # zero-padded
