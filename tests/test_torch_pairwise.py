"""Differential tests of K4's plain version (pilosa_tpu_torch.ops.pairwise)
against the TPU package: the Pallas `pairwise_counts_stack` run in
interpret mode (as tests/test_pallas.py runs it on the CPU), at the small
kernel's shapes (R1, R2 <= 8) and the tiled kernel's (R1 or R2 > 8), the
jnp tile function `bitplane.pairwise_counts_hi_lo`, the tiled host
`bitplane.pairwise_counts` against the port's served tiling loop
(`StackedEvaluator.pairwise_counts`), and a two-field GroupBy over a
field of more than 8 rows through both packages' executors.
Inputs come from numpy seeds; row counts are ragged (not multiples of 8,
16 or 128), the words carry the edge values, and empty sides are
covered. Tolerance: exact equality.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.ops import bitplane as jax_bp  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.shardwidth import WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.exec import stacked as port_stacked  # noqa: E402
from pilosa_tpu_torch.ops import pairwise as k4  # noqa: E402

EDGE_WORDS = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000001, 0],
                      dtype=np.uint32)


def _stacks(rng, r, s):
    x = rng.integers(0, 1 << 32, (r, s, WORDS_PER_ROW), dtype=np.uint32)
    if r:
        x[:, :, :len(EDGE_WORDS)] = EDGE_WORDS
        x[r // 2, :, 9:2000] = 0
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _naive(a, b, filt=None):
    r1, r2 = a.shape[0], b.shape[0]
    a2, b2 = a.reshape(r1, -1), b.reshape(r2, -1)
    if filt is not None:
        a2 = a2 & filt.reshape(1, -1)
    out = np.zeros((r1, r2), dtype=np.int64)
    for i in range(r1):
        out[i] = np.bitwise_count(a2[i][None, :] & b2).sum(
            axis=-1, dtype=np.int64)
    return out


@pytest.mark.parametrize("r1,r2", [(1, 1), (5, 4), (8, 8), (3, 7), (1, 8),
                                   (9, 5), (13, 130), (9, 3), (13, 17),
                                   (17, 9)])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("has_filt", [False, True])
def test_plain_k4_matches_pallas_interpret(r1, r2, s, has_filt):
    rng = np.random.default_rng(r1 * 1000 + r2 * 10 + s)
    a, b = _stacks(rng, r1, s), _stacks(rng, r2, s)
    filt = rng.integers(0, 1 << 32, (s, WORDS_PER_ROW), dtype=np.uint32) \
        if has_filt else None
    want = np.asarray(pk.pairwise_counts_stack(a, b, filt))
    got = k4.pairwise_counts_stack(_t(a), _t(b),
                                   None if filt is None else _t(filt))
    assert got.dtype == torch.int64
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == _naive(a, b, filt).tolist()


@pytest.mark.parametrize("r1,r2", [(0, 3), (3, 0), (0, 0)])
def test_empty_side_returns_zeros(r1, r2):
    rng = np.random.default_rng(1)
    a, b = _stacks(rng, r1, 1), _stacks(rng, r2, 1)
    want = np.asarray(pk.pairwise_counts_stack(a, b))
    got = k4.pairwise_counts_stack(_t(a), _t(b))
    assert tuple(got.shape) == want.shape == (r1, r2)
    assert got.dtype == torch.int64 and not got.any()


def test_tile_matches_jax_hi_lo():
    """The port's device tile function (`pairwise_counts_stack`, what the
    served path launches per tile pair) against the TPU package's
    (hi, lo) tile function, recombined."""
    rng = np.random.default_rng(2)
    a, b = _stacks(rng, 6, 3), _stacks(rng, 7, 3)
    filt = rng.integers(0, 1 << 32, (3, WORDS_PER_ROW), dtype=np.uint32)
    for f in (None, filt):
        want = jax_bp.combine_hi_lo(*jax_bp.pairwise_counts_hi_lo(a, b, f))
        got = k4.pairwise_counts_stack(
            _t(a), _t(b), None if f is None else _t(f))
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("tile", [None, 2, 3])
def test_tiled_host_matrix_matches_jax(tile, monkeypatch):
    """The served tiling loop, with CHUNK_BYTES cut to `tile` rows, gives
    the TPU package's tiled host matrix (its nonzero entries) and
    launches one tile pair per (A-tile, B-tile)."""
    rng = np.random.default_rng(3)
    s = 2
    a, b = _stacks(rng, 7, s), _stacks(rng, 6, s)
    filt = rng.integers(0, 1 << 32, (s, WORDS_PER_ROW), dtype=np.uint32)
    want = jax_bp.pairwise_counts(a, b, filt, tile=tile)
    if tile is not None:
        monkeypatch.setattr(port_stacked, "CHUNK_BYTES",
                            tile * s * WORDS_PER_ROW * 4)
    ev = port_stacked.StackedEvaluator("cpu")
    planes = {"a": _t(a), "b": _t(b)}
    monkeypatch.setattr(
        ev, "rows_stack", lambda idx, field, chunk, shards, view_name,
        cache: planes[field][list(chunk)])
    got = ev.pairwise_counts(None, "a", list(range(7)), "b", list(range(6)),
                             _t(filt), tuple(range(s)))
    assert got == {(int(i), int(j)): int(want[i, j])
                   for i, j in zip(*np.nonzero(want))}
    t = tile or 7
    assert ev.pairwise_dispatches == -(-7 // t) * -(-6 // t)


def test_pairwise_tile_budget_matches_jax():
    """The served tile (rows per [R, S, W] chunk) is the TPU package's
    host pairwise tile at every shard count."""
    ev = port_stacked.StackedEvaluator("cpu")
    for s in (1, 10, 954, 5000):
        assert ev.row_chunk_size(tuple(range(s))) == jax_bp.pairwise_tile(s)
    assert port_stacked.CHUNK_BYTES == jax_bp.PAIRWISE_TILE_BYTES


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x55555555])
def test_edge_words_exact(word):
    a = np.full((2, 1, WORDS_PER_ROW), word, dtype=np.uint32)
    b = np.full((3, 1, WORDS_PER_ROW), 0xFFFFFFFF, dtype=np.uint32)
    want = np.asarray(pk.pairwise_counts_stack(a, b))
    assert (want == WORDS_PER_ROW * bin(word).count("1")).all()
    assert k4.pairwise_counts_stack(_t(a), _t(b)).tolist() == want.tolist()


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        k4.pairwise_counts(a, a.to(torch.int64))
    with pytest.raises(ValueError, match="words per row"):
        k4.pairwise_counts(a, a[:, :4])
    with pytest.raises(ValueError, match="filter shape"):
        k4.pairwise_counts(a, a, torch.zeros(3, dtype=torch.int32))
    assert k4.pairwise_counts.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("query,limit", [
    ("GroupBy(Rows(f), Rows(g))", None),
    ("GroupBy(Rows(g), Rows(f), filter=Row(g=2))", None),
    ("GroupBy(Rows(f), Rows(f))", None),
    ("GroupBy(Rows(f), Rows(g), limit=7)", 7),
])
def test_group_by_past_8_rows_matches_jax(tmp_path, query, limit):
    """A two-field GroupBy whose fields hold more rows than the small
    kernel's 8 (f 13 rows, g 9) over 3 shards: the port's executor takes
    the stacked pairwise path (one tile pair: K4's tiled kernel on a
    card) and answers as the JAX package's executor does on a copy of
    the same data directory."""
    import shutil

    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.exec import Executor as JaxExecutor
    from pilosa_tpu.server.api import result_to_json as jax_to_json
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.server.api import result_to_json
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(23)
    h = Holder(str(tmp_path / "data"), use_snapshot_queue=False).open()
    try:
        idx = h.create_index("i")
        for name, n_rows in (("f", 13), ("g", 9)):
            # 3,000 columns in each shard, so that rows meet
            rows = rng.integers(0, n_rows, 6000).astype(np.uint64)
            cols = (rng.integers(0, 3, 6000) * SHARD_WIDTH
                    + rng.integers(0, 3000, 6000)).astype(np.uint64)
            idx.create_field(name).import_bits(rows, cols)
        ex = Executor(h, device="cpu")
        before = ex.stacked_stats()["pairwise_dispatches"]
        got = [result_to_json(r) for r in ex.execute("i", query)]
        assert ex.stacked_stats()["pairwise_dispatches"] == before + 1
        copy = str(tmp_path / "jax")
        shutil.copytree(h.path, copy)
    finally:
        h.close()
    jh = JaxHolder(copy, use_snapshot_queue=False).open()
    try:
        want = [jax_to_json(r) for r in JaxExecutor(jh).execute("i", query)]
    finally:
        jh.close()
    assert got == want
    if limit is None:
        assert len(got[0]) > 8
    else:
        assert len(got[0]) == limit


def test_k4_peak_and_ab_tools_import_without_cuda():
    """tools/k4_peak.py and tools/ab_k4.py import on a machine without
    CUDA (their kernels build at first use on a card), and the peak
    tool's bit-pair arithmetic is each route's: 16 x 8 x 256 an mma,
    64 word pairs a POPC iteration, 4 x 16 a Harley-Seal one."""
    from pilosa_tpu_torch.tools import ab_k4, k4_peak

    assert {r[0] for r in k4_peak.ROUTES} == {"mma_b1", "popc",
                                              "harley_seal"}
    assert k4_peak.bit_pairs(0, 2, 64, 3) == 2 * 2 * 3 * 4 * 16 * 8 * 256
    assert k4_peak.bit_pairs(1, 2, 64, 3) == 2 * 64 * 3 * 64 * 32
    assert k4_peak.bit_pairs(2, 2, 64, 3) == 2 * 64 * 3 * 4 * 16 * 32
    assert {sh[0] for sh in ab_k4.SHAPES} >= {
        "5x4 S=10", "1x1 S=954", "100x5 S=10", "100x100 S=10",
        "102x102 S=10", "13x130 S=10"}


@pytest.mark.parametrize("r1,r2,s,has_filt", [
    (102, 102, 10, False), (100, 100, 10, False), (100, 5, 10, False),
    (13, 130, 10, False), (5, 4, 10, True), (1, 1, 954, False)])
def test_k4_bound_is_the_declared_cost(r1, r2, s, has_filt):
    """chip_smoke's K4 bound (bytes at 3.35 TB/s or bit pairs at the
    fastest measured rate, whichever is larger) is the bound the wrapper
    declares, and the tiled shapes are bound by their bytes."""
    import importlib.util
    import pathlib

    from pilosa_tpu_torch.ops import cuda_build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    t = s * WORDS_PER_ROW
    bound_ms, bound_by, bytes_ms, ops_ms = cs.k4_bound(r1, r2, t, has_filt)
    cost = k4.pairwise_cost(r1, r2, t, has_filt, device="cuda")
    assert bound_ms / 1e3 == pytest.approx(cost["optimal_seconds"])
    assert ops_ms / 1e3 == pytest.approx(
        r1 * r2 * t * 32 / cuda_build.AND_POPC_BIT_PAIRS_PER_SECOND)
    assert bound_by == "bytes" and bound_ms == bytes_ms
