"""K2's batched entry against the TPU package, on the CPU.

The kernel module: `count_blocks_batch` and `count_and_blocks_batch`
(plain versions on the CPU) must equal the single plain versions member
by member, over seeded ids with padding, members of padding only, no
matches and a b denser than a, and the TPU package's `count_blocks_stack`
/ `count_and_blocks_stack` under `jax.vmap` (one Pallas kernel with the
batch as a grid axis, in interpret mode).

The path: batches of sparse, sparse-pair, three-leaf `&`, run-length and
dense Counts under `configure("auto")` with `AUTO_COMPRESS_FLOOR = 0` go
through the port's `launch_query_batch` (`execute_batch`) and its
GroupCommit, and each answer is held to the TPU package's
`execute_batch` / `execute` on a copy of the same data, its Pallas
kernels switched on so that its vmapped count program runs them in
interpret mode. Each block-sparse group is ONE call of K2's batched
entry and no single K2 call; the dense groups keep one call of K1's.

Tolerance: exact equality. Answers are compared, not reprs (the TPU
package pads the shard axis to 8 devices, so its chooser may pick other
forms at this size).
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.ops import containers as jc  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.ops import containers as tc  # noqa: E402
from pilosa_tpu_torch.ops import count_blocks as k2  # noqa: E402
from pilosa_tpu_torch.ops import declared_cost  # noqa: E402
from pilosa_tpu_torch.server.api import API  # noqa: E402
from tests.test_torch_batching import _concurrent, _slow_transport  # noqa: E402

BW = k2.BLOCK_WORDS
SENTINEL = k2.SPARSE_SENTINEL


# ------------------------------------------------------------ the module


def _member(rng, nb, ids):
    """(ids [nb] int32, blocks [nb, 128] int32) on the CPU: `ids` (sorted)
    first, sentinel padding with zero blocks after, edge words planted."""
    blocks = rng.integers(0, 1 << 32, (nb, BW), dtype=np.uint32)
    blocks[:, :2] = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    blocks[len(ids):] = 0
    full = np.full(nb, SENTINEL, dtype=np.int32)
    full[:len(ids)] = np.sort(ids)
    return torch.from_numpy(full), torch.from_numpy(blocks.view(np.int32))


def _ids(rng, n, space=1 << 16, avoid=None, keep=None):
    keep = np.empty(0, np.int64) if keep is None else np.asarray(keep)
    pool = np.arange(space)
    if avoid is not None:
        pool = np.setdiff1d(pool, avoid)
    pool = np.setdiff1d(pool, keep)
    return np.sort(np.concatenate(
        [keep, rng.choice(pool, n - len(keep), replace=False)]))


def _pairs(case, b, seed):
    """B (ids_a, blocks_a, ids_b, blocks_b) members of one shape: every
    member's real ids, its share matched in b, then one member of the
    case's edge."""
    rng = np.random.default_rng(seed)
    nb_a, nb_b = {"padded": (64, 64), "b_denser": (32, 256),
                  "a_denser": (256, 32), "identical": (64, 64)}[case]
    out = []
    for q in range(b):
        real_a = nb_a - nb_a // 4 - q % 3
        ids_a = _ids(rng, real_a)
        if case == "identical":
            a = _member(rng, nb_a, ids_a)
            out.append((*a, a[0], _member(rng, nb_a, ids_a)[1]))
            continue
        real_b = nb_b - nb_b // 4
        share = min(real_a, real_b) * (q % 3) // 2  # none, half, all
        keep = rng.choice(ids_a, share, replace=False) if share else None
        ids_b = _ids(rng, real_b, avoid=ids_a, keep=keep)
        out.append((*_member(rng, nb_a, ids_a), *_member(rng, nb_b, ids_b)))
    # the edge members: a of padding only, and b of padding only
    if b > 2:
        out[-1] = (*_member(rng, nb_a, []), *out[-1][2:])
        out[-2] = (*out[-2][:2], *_member(rng, nb_b, []))
    return out


@pytest.mark.parametrize("b", [1, 2, 3, 7])
@pytest.mark.parametrize("nb", [0, 1, 8, 33, 256])
def test_count_blocks_batch_equals_singles(b, nb):
    rng = np.random.default_rng(nb * 11 + b)
    members = [_member(rng, nb, _ids(rng, max(0, nb - nb // 4 - q)))[1]
               for q in range(b)]
    if b > 2 and nb:
        members[-1] = _member(rng, nb, [])[1]  # padding only
    got = k2.count_blocks_batch(members)
    want = [int(k2.count_blocks_reference(m)) for m in members]
    assert got.dtype == torch.int64 and got.shape == (b,)
    assert got.tolist() == want
    assert got.tolist() == [
        int(np.unpackbits(m.numpy().view(np.uint8)).sum()) for m in members]


@pytest.mark.parametrize("b", [1, 2, 5])
@pytest.mark.parametrize("case", ["padded", "b_denser", "a_denser",
                                  "identical"])
def test_count_and_blocks_batch_equals_singles(case, b):
    members = _pairs(case, b, seed=b * 7 + len(case))
    got = k2.count_and_blocks_batch(members)
    want = [int(k2.count_and_blocks_reference(*m)) for m in members]
    assert got.dtype == torch.int64 and got.shape == (b,)
    assert got.tolist() == want
    # against numpy: the blocks of a whose id b holds too
    for m, total in zip(members, got.tolist()):
        ids_a, blocks_a, ids_b, blocks_b = (t.numpy() for t in m)
        pos = {int(i): j for j, i in enumerate(ids_b) if i != SENTINEL}
        expect = 0
        for j, i in enumerate(ids_a):
            if int(i) in pos:
                both = blocks_a[j] & blocks_b[pos[int(i)]]
                expect += int(np.unpackbits(both.view(np.uint8)).sum())
        assert total == expect


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
def test_batched_plain_matches_vmapped_pallas(b):
    """The plain batched versions against the TPU package's K2 vmapped
    over the batch (pallas_kernels.py:218 under jax.vmap: one kernel with
    a batch grid axis), in interpret mode; the fused mode's alignment
    done as the TPU package's count_program does it. B = 1-5: the small
    batches that concurrent Counts form."""
    members = _pairs("padded", b, seed=3)
    blocks = np.stack([m[1].numpy().view(np.uint32) for m in members])
    want = jax.vmap(pk.count_blocks_stack)(jnp.asarray(blocks))
    got = k2.count_blocks_batch([m[1] for m in members])
    assert got.tolist() == [int(x) for x in np.asarray(want)]

    def aligned(m):
        ids_a, _, ids_b, blocks_b = (np.asarray(t.numpy()) for t in m)
        pos = np.clip(np.searchsorted(ids_b, ids_a), 0, len(ids_b) - 1)
        match = ids_b[pos] == ids_a
        return np.where(match[:, None], blocks_b.view(np.uint32)[pos], 0)

    a = np.stack([m[1].numpy().view(np.uint32) for m in members])
    b = np.stack([aligned(m) for m in members]).astype(np.uint32)
    want = jax.vmap(pk.count_and_blocks_stack)(jnp.asarray(a),
                                               jnp.asarray(b))
    got = k2.count_and_blocks_batch(members)
    assert got.tolist() == [int(x) for x in np.asarray(want)]


@pytest.mark.parametrize("b", [1, 2, 4, 31, 32, 33, 127, 128, 129, 257,
                               65535])
@pytest.mark.parametrize("cap", [128, 32])
def test_batch_route_by_members(cap, b):
    """The wrapper's route by B alone: the pointers by value (one device
    operation a call) up to its mode's cap (the kernel's 128 pointer
    slots: 128 members in mode 0, 32 fused; read from the card's build),
    the device table past it."""
    assert k2.batch_route(b, cap) == ("by_value" if b <= cap else "table")


class _Fake:
    """Stands in for a CUDA tensor: only its data_ptr is read."""

    def __init__(self, ptr):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


@pytest.mark.parametrize("b", [1, 3, 33])
def test_pack_pointers_in_kernel_order(b):
    """The pointers the batched launch passes, by value or in its device
    table (33 fused members are past the cap): mode 0 each member's
    blocks; the fused mode a's blocks, b's blocks, a's ids, b's ids of
    each member (members come as (ids_a, blocks_a, ids_b, blocks_b)),
    member after member."""
    rows = [_Fake(1000 + 16 * q) for q in range(b)]
    assert k2.pack_pointers("blocks", rows) == [1000 + 16 * q
                                                for q in range(b)]
    members = [tuple(_Fake(100 * q + j) for j in (1, 2, 3, 4))
               for q in range(b)]  # ids_a, blocks_a, ids_b, blocks_b
    assert k2.pack_pointers("fused", members) == [
        p for q in range(b) for p in (100 * q + 2, 100 * q + 4,
                                      100 * q + 1, 100 * q + 3)]


def test_empty_batches_and_mismatched_members():
    assert k2.count_blocks_batch([]).shape == (0,)
    assert k2.count_and_blocks_batch([]).shape == (0,)
    rng = np.random.default_rng(1)
    a, b = _member(rng, 8, [1, 2]), _member(rng, 16, [1, 3])
    with pytest.raises(ValueError, match="one shape"):
        k2.count_blocks_batch([a[1], b[1]])
    with pytest.raises(ValueError, match="one shape"):
        k2.count_and_blocks_batch([(*a, *b), (*b, *a)])
    with pytest.raises(ValueError):
        k2.count_blocks_batch([a[1][:, :64]])
    with pytest.raises(TypeError):
        k2.count_and_blocks_batch([(a[0].long(), a[1], *b)])


@pytest.mark.parametrize("b,na,nb", [(1, 8, 8), (4, 32768, 32768),
                                     (16, 32768, 32768)])
def test_batch_costs_are_the_sum_of_single_costs(b, na, nb):
    """A batch declares its members' single costs plus each member's
    8-byte state word."""
    one = declared_cost("count_blocks", (na,))["bytes accessed"] \
        + k2.STATE_BYTES
    assert k2.STATE_BYTES == 8
    assert declared_cost("count_blocks_batch", (b, na))[
        "bytes accessed"] == b * one
    pair = declared_cost("count_and_blocks", (na, nb))["bytes accessed"] \
        + k2.STATE_BYTES
    assert declared_cost("count_and_blocks_batch", (b, na, nb))[
        "bytes accessed"] == b * pair
    card = declared_cost("count_blocks_batch", (b, na), "cuda:0")
    assert card["optimal_seconds"] == pytest.approx(b * one / 3.35e12)


# -------------------------------------------------------------- the path

N_SHARDS = 3
SPARSE_ROWS = 5  # field s: rows 0-3 overlap, row 4 shares no block with 0
BLOCKS_PER_SHARD = 4  # so every row of s pads to one NB (12 -> 16)
RUN_BITS = 3 * BW * 32 + 37  # bits a run of field r


def _sparse_rows(rng):
    """Field s as [N_SHARDS, W] stacks: BLOCKS_PER_SHARD random 128-word
    blocks a shard, rows 0-3 drawn from a shared pool of 6 blocks a shard
    (their intersections are not empty), row 4 from blocks row 0 lacks."""
    bps = WORDS_PER_ROW // BW
    rows = np.zeros((SPARSE_ROWS, N_SHARDS, bps, BW), dtype=np.uint32)
    for shard in range(N_SHARDS):
        pool = rng.choice(bps, 6, replace=False)
        picks = [rng.choice(pool, BLOCKS_PER_SHARD, replace=False)
                 for _ in range(SPARSE_ROWS - 1)]
        rest = np.setdiff1d(np.arange(bps), picks[0])
        picks.append(rng.choice(rest, BLOCKS_PER_SHARD, replace=False))
        for row, blocks in enumerate(picks):
            words = rng.integers(0, 1 << 32, (BLOCKS_PER_SHARD, BW),
                                 dtype=np.uint32)
            rows[row, shard, blocks] = words | 1  # no empty block
    return rows.reshape(SPARSE_ROWS, N_SHARDS, WORDS_PER_ROW)


def _run_rows():
    """Field r: two rows of three runs of RUN_BITS bits a shard, each
    crossing block and word edges (run-length)."""
    nbits = WORDS_PER_ROW * 32
    rows = np.zeros((2, N_SHARDS, WORDS_PER_ROW), dtype=np.uint32)
    for row in range(2):
        for shard in range(N_SHARDS):
            bits = np.zeros(nbits, dtype=np.uint8)
            for k in range(3):
                lo = (k * nbits) // 3 + 37 * (row + 1) + shard
                bits[lo:lo + RUN_BITS] = 1
            rows[row, shard] = np.packbits(
                bits, bitorder="little").view(np.uint32)
    return rows


def _dense_rows(rng):
    """Field d: two rows of random words at a 5 % word density: every
    block holds some, and too many runs for run-length (dense)."""
    words = rng.integers(0, 1 << 32, (2, N_SHARDS, WORDS_PER_ROW),
                         dtype=np.uint32)
    return np.where(rng.random(words.shape) < 0.05, words, 0).astype(
        np.uint32)


def _write(path, seed=29):
    rng = np.random.default_rng(seed)
    fields = {"s": _sparse_rows(rng), "r": _run_rows(),
              "d": _dense_rows(rng)}
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    for name, rows in fields.items():
        field = idx.create_field(name)
        for row, stack in enumerate(rows):
            bits = np.unpackbits(stack.view(np.uint8), axis=1,
                                 bitorder="little")
            shard, off = np.nonzero(bits)
            cols = (shard * SHARD_WIDTH + off).astype(np.uint64)
            field.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
            idx.add_existence(cols)
    h.close()


#: (query, the port's route under auto at N_SHARDS); a group per route
#: and signature
PATH = [
    ("Count(Row(s=0))", "sparse"),
    ("Count(Row(s=1))", "sparse"),
    ("Count(Row(s=3))", "sparse"),
    ("Count(Row(s=4))", "sparse"),
    ("Count(Intersect(Row(s=0), Row(s=1)))", "sparse_and"),
    ("Count(Intersect(Row(s=2), Row(s=3)))", "sparse_and"),
    ("Count(Intersect(Row(s=0), Row(s=4)))", "sparse_and"),  # no match
    ("Count(Intersect(Row(s=0), Row(s=1), Row(s=2)))", "sparse_and"),
    ("Count(Intersect(Row(s=1), Row(s=2), Row(s=3)))", "sparse_and"),
    ("Count(Row(r=0))", "rle"),
    ("Count(Row(r=1))", "rle"),
    ("Count(Intersect(Row(r=0), Row(r=1)))", "rle_and"),
    ("Count(Intersect(Row(r=1), Row(r=0)))", "rle_and"),
    ("Count(Row(d=0))", "k1"),
    ("Count(Row(d=1))", "k1"),
    ("Count(Union(Row(s=0), Row(d=0)))", "k1"),
    ("Count(Union(Row(s=1), Row(d=1)))", "k1"),
]
QUERIES = [q for q, _ in PATH]
#: member counts of each entry's calls for one batch of QUERIES
WANT_CALLS = {"count_blocks_batch": [4], "count_and_blocks_batch": [2, 3],
              "count_blocks": [], "count_and_blocks": [],
              "count_expr_batch": [2, 2], "count_expr": []}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both packages over copies of one data directory, auto chooser at
    CPU scale, the TPU package's Pallas kernels on (interpret mode on the
    CPU) for every program it builds here."""
    base = tmp_path_factory.mktemp("torch_k2_batch")
    src = str(base / "src")
    _write(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    saved = [(m, m.repr_mode(), m.AUTO_COMPRESS_FLOOR) for m in (jc, tc)]
    for m in (jc, tc):
        m.configure("auto")
        m.AUTO_COMPRESS_FLOOR = 0
    mp = pytest.MonkeyPatch()
    mp.setattr(pk, "enabled", lambda: True)
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    try:
        yield JaxExecutor(jh), API(th, device="cpu")
    finally:
        mp.undo()
        for m, mode, floor in saved:
            m.configure(mode)
            m.AUTO_COMPRESS_FLOOR = floor
        jh.close()
        th.close()


@pytest.fixture
def calls(monkeypatch):
    """Member counts of every call the count programs make of K1's and
    K2's entries (K2's single entries count 1 a call)."""
    seen = {name: [] for name in WANT_CALLS}

    def spy(name, size):
        real = getattr(tc, name)

        def fn(*args):
            seen[name].append(size(*args))
            return real(*args)

        monkeypatch.setattr(tc, name, fn)

    spy("count_blocks_batch", len)
    spy("count_and_blocks_batch", len)
    spy("count_blocks", lambda *_: 1)
    spy("count_and_blocks", lambda *_: 1)
    spy("count_expr_batch", lambda _sig, members: len(members))
    spy("count_expr", lambda *_: 1)
    return seen


def _sorted(seen):
    return {k: sorted(v) for k, v in seen.items()}


def test_routes_under_auto(env):
    """Every leaf takes the form its query's route needs (the port's
    chooser at CPU scale), so the batches below reach each entry."""
    jex, api = env
    ex = api.executor
    for q in QUERIES:
        ex.execute("i", q)
    leaves = {(k[2], k[3]): e[1]
              for k, e in ex._stacked._pools["leaf"].items()
              if k[1] == "i" and k[2] in ("s", "r", "d")}
    assert {f"{f}={r}": tc.kind_of(c) for (f, r), c in leaves.items()} == {
        **{f"s={r}": "sparse" for r in range(SPARSE_ROWS)},
        "r=0": "rle", "r=1": "rle", "d=0": "dense", "d=1": "dense"}
    assert {c.arrays[0].shape[0] for (f, _), c in leaves.items()
            if f == "s"} == {16}


def test_execute_batch_matches_reference(env, calls):
    """One execute_batch (launch_query_batch) of every route: answers and
    batch sizes equal the TPU package's, and each sparse group is one
    call of K2's batched entry, no single K2 call."""
    jex, api = env
    ex = api.executor
    want = jex.execute_batch("i", list(QUERIES))
    got = ex.execute_batch("i", list(QUERIES))
    for q, (res, err, size), (jres, jerr, jsize, _) in zip(QUERIES, got,
                                                          want):
        assert err is None and jerr is None, (q, err, jerr)
        assert res == jres == jex.execute("i", q), q
        assert size == jsize, q
    assert _sorted(calls) == WANT_CALLS
    # /debug/kernels names each batched launch with its declared cost:
    # each member's blocks, total and state word
    compiled = {(c["family"], c["kernel"]): c["cost"]
                for c in ex.kernel_stats()["compiled"]}
    assert compiled[("count_batched", "count_blocks_batch")][
        "bytes accessed"] == 4 * (16 * 512 + 8 + 8)
    assert ("count_batched", "count_and_blocks_batch") in compiled
    assert ("count_batched", "count_expr_batch") in compiled


@pytest.mark.parametrize("repeat", [1, 8])
def test_query_batch_route_repeats(env, calls, repeat):
    """The query-batch route's shape: each sparse query `repeat` times,
    one group per route and signature however many members it has."""
    jex, api = env
    sparse = [q for q, route in PATH if route.startswith("sparse")]
    queries = sparse * repeat
    out = api.query_batch("i", queries)
    want = {q: jex.execute("i", q) for q in sparse}
    group = {q: (4 if q.startswith("Count(Row") else 3 if q.count("Row") == 2
                 else 2) * repeat for q in sparse}
    for q, (res, err, size) in zip(queries, out):
        assert err is None, (q, err)
        assert res == want[q], q
        assert size == group[q], q
    assert _sorted(calls) == {
        **{k: [] for k in WANT_CALLS},
        "count_blocks_batch": [4 * repeat],
        "count_and_blocks_batch": [2 * repeat, 3 * repeat]}


def test_group_commit_matches_reference(env, calls):
    """Counts released together from threads (a 0.2 s leader window):
    once every query rides one GroupCommit batch, each sparse group is
    one K2 batched call and no single K2 call; answers equal the TPU
    package's execute."""
    jex, api = env
    ex = Executor(api.holder, device="cpu")
    want = [jex.execute("i", q) for q in QUERIES]
    for q in QUERIES:
        ex.execute("i", q)  # warm: every gather a hit
    _slow_transport(ex._stacked)
    for _ in range(3):  # a thread late for the window makes 2 batches
        for v in calls.values():
            v.clear()
        before = ex.stacked_stats()
        got = _concurrent(ex.execute, [("i", q) for q in QUERIES])
        after = ex.stacked_stats()
        assert got == want
        if after["count_batches"] - before["count_batches"] == 1:
            break
    assert after["count_batched_queries"] \
        - before["count_batched_queries"] == len(QUERIES)
    assert after["count_batches"] - before["count_batches"] == 1
    assert _sorted(calls) == WANT_CALLS
