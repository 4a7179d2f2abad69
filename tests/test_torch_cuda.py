"""K1 (and its batched and multi-tree entries), K2, K3, K4 and K5 on the
card: each CUDA kernel against its plain PyTorch version.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test skips (with the reason) where no CUDA device is present.
Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.ops import bsi_range as k5
from pilosa_tpu_torch.ops import count_blocks as k2
from pilosa_tpu_torch.ops import count_expr as k1
from pilosa_tpu_torch.ops import pairwise as k4
from pilosa_tpu_torch.ops import row_counts as k3
from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _stacks(n, s, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (n, s, WORDS_PER_ROW), dtype=np.uint32)
    if s:
        x[:, :, :2] = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    t = torch.from_numpy(x.view(np.int32)).to(device)
    return [t[i].contiguous() for i in range(n)]


SIGS = [
    k1.chain_signature(2, "&"),
    k1.chain_signature(3, "|-"),
    k1.chain_signature(6, "&|^-&"),
    ("|", (("&", (("leaf", 0), ("leaf", 1))),
           ("-", (("leaf", 2), ("leaf", 3))))),
    ("leaf", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0, 1, 7, 33])
@pytest.mark.parametrize("sig", SIGS, ids=[str(i) for i in range(len(SIGS))])
def test_kernel_matches_plain(cuda, sig, s):
    stacks = _stacks(6, s, seed=s, device=cuda)
    before = k1.count_expr.launches
    got = k1.count_expr(sig, stacks)
    torch.cuda.synchronize()
    want = k1.count_expr_reference(sig, stacks)
    assert int(got) == int(want)
    assert k1.count_expr.launches == before + (1 if s else 0)


@pytest.mark.cuda
def test_kernel_rejects_misaligned(cuda):
    base = torch.zeros(2 * WORDS_PER_ROW + 1, dtype=torch.int32,
                       device=cuda)
    odd = base[1:].view(2, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k1.count_expr(("leaf", 0), [odd])


def _right_nested(depth):
    """Intersect/Union alternating, nested to the right: needs stack depth
    `depth`, one more than K1 holds at depth 9."""
    sig = ("leaf", 0)
    for i in range(1, depth):
        sig = ("&" if i % 2 else "|", (("leaf", i), sig))
    return sig, depth


BEYOND_LIMITS = {
    "union_17_leaves": (("|", tuple(("leaf", i) for i in range(17))), 17),
    "right_nested_depth_9": _right_nested(9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BEYOND_LIMITS))
def test_tree_beyond_limits_one_launch(cuda, name):
    """fit_tree folds sub-trees to planes; the Count is still one K1
    launch, equal to the plain tree evaluation over every leaf."""
    sig, n = BEYOND_LIMITS[name]
    stacks = _stacks(n, 7, seed=n, device=cuda)
    before = k1.count_expr.launches
    got = k1.count_expr(sig, stacks)
    torch.cuda.synchronize()
    assert int(got) == int(k1.popcount_total(k1.tree_eval(sig, stacks)))
    assert k1.count_expr.launches == before + 1


def _members(sig, b, s, device, shared):
    """b members of `sig`, each a list of leaf stacks from one pool:
    with `shared`, member q takes pool leaves q.. (neighbours share
    leaves), else every member has leaves of its own."""
    n = max(k1._leaf_slots(sig, {})) + 1
    size = n + b if shared else n * b
    pool = _stacks(size, s, seed=b * 100 + s + n, device=device)
    if shared:
        return [[pool[(q + i) % size] for i in range(n)] for q in range(b)]
    return [pool[q * n:(q + 1) * n] for q in range(b)]


BATCH_SIGS = SIGS + [BEYOND_LIMITS["union_17_leaves"][0]]


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 17, 32, 64])
@pytest.mark.parametrize("sig", BATCH_SIGS,
                         ids=[str(i) for i in range(len(BATCH_SIGS))])
def test_batch_kernel_matches_plain(cuda, sig, b, shared):
    """K1's batched entry against its plain version: chain and tree
    programs, a tree past K1's limits, members that share leaves and
    members that do not; one launch per batch."""
    members = _members(sig, b, 10, cuda, shared)
    before = k1.count_expr_batch.launches
    got = k1.count_expr_batch(sig, members)
    torch.cuda.synchronize()
    assert k1.count_expr_batch.launches == before + 1
    want = k1.count_expr_batch_reference(sig, members)
    assert got.dtype == torch.int64 and got.shape == (b,)
    assert got.tolist() == want.tolist()


MULTI_SIGS = BATCH_SIGS


def _multi(n, s, device, shared):
    """n members cycling through MULTI_SIGS (chain, tree, a single leaf,
    a tree past K1's limits), from one pool: with `shared` neighbours
    share leaves, else every member has leaves of its own."""
    sigs = [MULTI_SIGS[q % len(MULTI_SIGS)] for q in range(n)]
    slots = [max(k1._leaf_slots(sig, {})) + 1 for sig in sigs]
    size = max(slots) + n if shared else sum(slots)
    pool = _stacks(size, s, seed=n * 100 + s, device=device)
    members, off = [], 0
    for q, k in enumerate(slots):
        if shared:
            members.append([pool[(q + i) % size] for i in range(k)])
        else:
            members.append(pool[off:off + k])
            off += k
    return sigs, members


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("s", [1, 7, 33])
@pytest.mark.parametrize("n", [1, 2, 5, 17, 64])
def test_multi_kernel_matches_plain(cuda, n, s, shared):
    """K1's multi-tree entry against its plain version: members of
    different programs (chain, tree, a single leaf, fitted past K1's
    limits), shared and own leaves; one launch per call, and a kept
    program table reused by the next call."""
    sigs, members = _multi(n, s, cuda, shared)
    prog = k1.MultiProgram()
    before = k1.count_expr_multi.launches
    got = k1.count_expr_multi(sigs, members, program=prog)
    again = k1.count_expr_multi(sigs, members, program=prog)
    torch.cuda.synchronize()
    assert k1.count_expr_multi.launches == before + 2
    want = k1.count_expr_multi_reference(sigs, members)
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert got.tolist() == again.tolist() == want.tolist()


@pytest.mark.cuda
def test_multi_kernel_empty_and_misaligned(cuda):
    sigs = [k1.chain_signature(2, "&"), ("leaf", 0)]
    empty = torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32, device=cuda)
    before = k1.count_expr_multi.launches
    out = k1.count_expr_multi(sigs, [[empty, empty], [empty]])
    assert out.tolist() == [0, 0] and out.device.type == "cuda"
    assert k1.count_expr_multi.launches == before  # S = 0: no launch
    a = _stacks(2, 2, seed=1, device=cuda)
    base = torch.zeros(2 * WORDS_PER_ROW + 4, dtype=torch.int32,
                       device=cuda)
    misaligned = base[1:1 + 2 * WORDS_PER_ROW].view(2, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k1.count_expr_multi(sigs, [[a[0], a[1]], [misaligned]])
    assert k1.count_expr_multi.launches == before


@pytest.mark.cuda
def test_batch_kernel_edge_words_exact(cuda):
    """Every word all ones: each member's total is S·W·32, no
    accumulation overflows."""
    ones = torch.full((33, WORDS_PER_ROW), -1, dtype=torch.int32,
                      device=cuda)
    got = k1.count_expr_batch(k1.chain_signature(2, "&"),
                              [[ones, ones]] * 5)
    torch.cuda.synchronize()
    assert got.tolist() == [33 * WORDS_PER_ROW * 32] * 5


@pytest.mark.cuda
def test_batch_kernel_two_streams(cuda):
    """Back-to-back batches on two streams, unsynchronised: each result
    equals the plain version."""
    sigs = [SIGS[0], SIGS[3], SIGS[2]]
    inputs = [(sig, _members(sig, b, 7, cuda, shared=True))
              for sig, b in zip(sigs, (4, 17, 3))]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before = k1.count_expr_batch.launches
    got = []
    for rnd in range(4):
        for i, (sig, members) in enumerate(inputs):
            with torch.cuda.stream(streams[(i + rnd) % 2]):
                got.append(k1.count_expr_batch(sig, members))
    torch.cuda.synchronize()
    assert k1.count_expr_batch.launches == before + 4 * len(inputs)
    for k, out in enumerate(got):
        sig, members = inputs[k % len(inputs)]
        assert out.tolist() \
            == k1.count_expr_batch_reference(sig, members).tolist()


@pytest.mark.cuda
def test_batch_kernel_empty_and_mismatched(cuda):
    sig = k1.chain_signature(2, "&")
    empty = torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32, device=cuda)
    before = k1.count_expr_batch.launches
    out = k1.count_expr_batch(sig, [[empty, empty]] * 4)
    assert out.device.type == "cuda" and out.tolist() == [0] * 4
    assert k1.count_expr_batch.launches == before  # S = 0: no launch
    a = _stacks(2, 3, seed=1, device=cuda)
    with pytest.raises(ValueError, match="device"):
        k1.count_expr_batch(sig, [a, [t.cpu() for t in a]])
    with pytest.raises(ValueError, match="device"):
        k1.count_expr_batch(sig, [a, [a[0], a[1].cpu()]])
    base = torch.zeros(3 * WORDS_PER_ROW + 1, dtype=torch.int32,
                       device=cuda)
    odd = base[1:].view(3, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k1.count_expr_batch(sig, [a, [odd, odd]])
    assert k1.count_expr_batch.launches == before


def _rows(r, t, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (r, t), dtype=np.uint32)
    if r:
        x[:, :2] = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
        x[r // 2, 4:1000] = 0
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(0, 1), (1, 1), (5, 1), (102, 1), (5, 10),
                                 (70000, 1)])
@pytest.mark.parametrize("has_filt", [False, True])
def test_row_counts_kernel_matches_plain(cuda, r, s, has_filt):
    t = s * WORDS_PER_ROW if r < 70000 else 64  # past 65535 grid rows
    rows = _rows(r, t, seed=r + s, device=cuda)
    filt = _rows(1, t, seed=99, device=cuda)[0] if has_filt else None
    before = k3.row_counts.launches
    got = k3.row_counts(rows, filt)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.row_counts_reference(rows, filt))
    assert k3.row_counts.launches == before + (1 if r else 0)


@pytest.mark.cuda
def test_topn_kernel_ties_lowest_index(cuda):
    base = _rows(2, WORDS_PER_ROW, seed=5, device=cuda)
    rows = base[torch.tensor([1, 0, 1, 1, 0], device=cuda)].contiguous()
    filt = _rows(1, WORDS_PER_ROW, seed=6, device=cuda)[0]
    vals, idx = k3.topn_counts_stack(rows, filt, 5)
    want = k3.row_counts_reference(rows, filt)
    order = sorted(range(5), key=lambda i: (-int(want[i]), i))
    assert idx.tolist() == order
    assert vals.tolist() == [int(want[i]) for i in order]


@pytest.mark.cuda
@pytest.mark.parametrize("r1,r2", [(0, 3), (1, 1), (5, 4), (8, 8), (9, 3),
                                   (13, 130), (102, 102)])
@pytest.mark.parametrize("s", [1, 10])
@pytest.mark.parametrize("has_filt", [False, True])
def test_pairwise_kernel_matches_plain(cuda, r1, r2, s, has_filt):
    t = s * WORDS_PER_ROW
    a = _rows(r1, t, seed=r1, device=cuda)
    b = _rows(r2, t, seed=1000 + r2, device=cuda)
    filt = _rows(1, t, seed=7, device=cuda)[0] if has_filt else None
    before = k4.pairwise_counts.launches
    got = k4.pairwise_counts(a, b, filt)
    torch.cuda.synchronize()
    assert torch.equal(got, k4.pairwise_counts_reference(a, b, filt))
    assert k4.pairwise_counts.launches == before + (1 if r1 and r2 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r1", range(1, 9))
@pytest.mark.parametrize("r2", range(1, 9))
@pytest.mark.parametrize("s", [1, 10])
@pytest.mark.parametrize("has_filt", [False, True])
def test_pairwise_small_kernel_every_shape(cuda, r1, r2, s, has_filt):
    """The small kernel's 64 exact shapes, R1, R2 in 1..8."""
    t = s * WORDS_PER_ROW
    a = _rows(r1, t, seed=10 * r1 + r2, device=cuda)
    b = _rows(r2, t, seed=100 + 10 * r1 + r2, device=cuda)
    filt = _rows(1, t, seed=8, device=cuda)[0] if has_filt else None
    before = k4.pairwise_counts.launches
    got = k4.pairwise_counts(a, b, filt)
    torch.cuda.synchronize()
    assert torch.equal(got, k4.pairwise_counts_reference(a, b, filt))
    assert k4.pairwise_counts.launches == before + 1


def _ragged_words(device, which):
    """Word counts whose vectors do not split evenly over the small
    kernel's grid: 4 words (one vector), or, for every whole number k of
    256-thread blocks an SM can hold, k blocks per SM at one vector a
    thread (SMs x k x 256 x 4 words) +- 4. The launch's own grid, SMs x
    the occupancy of its instantiation, is one of these."""
    if which == "one_vector":
        return [4]
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048) // 256
    step = 4 if which == "grid_plus_4" else -4
    return [props.multi_processor_count * k * 256 * 4 + step
            for k in range(1, per_sm + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("r1,r2", [(1, 1), (5, 4), (3, 7), (8, 8)])
@pytest.mark.parametrize("which", ["one_vector", "grid_minus_4",
                                   "grid_plus_4"])
@pytest.mark.parametrize("has_filt", [False, True])
def test_pairwise_small_kernel_ragged_words(cuda, r1, r2, which, has_filt):
    for t in _ragged_words(cuda, which):
        a = _rows(r1, t, seed=t % 1000 + r1, device=cuda)
        b = _rows(r2, t, seed=t % 1000 + 50 + r2, device=cuda)
        filt = _rows(1, t, seed=9, device=cuda)[0] if has_filt else None
        before = k4.pairwise_counts.launches
        got = k4.pairwise_counts(a, b, filt)
        torch.cuda.synchronize()
        assert torch.equal(got, k4.pairwise_counts_reference(a, b, filt)), t
        assert k4.pairwise_counts.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000])
@pytest.mark.parametrize("r1,r2", [(1, 1), (5, 4), (8, 8), (9, 3)])
def test_pairwise_kernel_edge_words(cuda, word, r1, r2):
    t = 10 * WORDS_PER_ROW
    full = np.full((max(r1, r2) + 1, t), word, dtype=np.uint32)
    x = torch.from_numpy(full.view(np.int32)).to(cuda)
    a, b, filt = x[:r1], x[:r2], x[-1]
    want = t * bin(word).count("1")
    for f in (None, filt):
        got = k4.pairwise_counts(a, b, f)
        torch.cuda.synchronize()
        assert torch.equal(got, k4.pairwise_counts_reference(a, b, f))
        assert (got == want).all()


@pytest.mark.cuda
def test_pairwise_small_kernel_two_streams(cuda):
    """Back-to-back launches on two streams, unsynchronised: each stream
    has its own state (running sums and arrivals), each result is right,
    and every state is left at zero."""
    t = 10 * WORDS_PER_ROW
    shapes = [(5, 4), (2, 3), (8, 8), (1, 1)]
    inputs = [(_rows(r1, t, seed=r1, device=cuda),
               _rows(r2, t, seed=20 + r2, device=cuda)) for r1, r2 in shapes]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before = k4.pairwise_counts.launches
    got = []
    for rnd in range(4):
        for i, (a, b) in enumerate(inputs):
            with torch.cuda.stream(streams[(i + rnd) % 2]):
                got.append(k4.pairwise_counts(a, b))
    torch.cuda.synchronize()
    assert k4.pairwise_counts.launches == before + 4 * len(inputs)
    for k, out in enumerate(got):
        a, b = inputs[k % len(inputs)]
        assert torch.equal(out, k4.pairwise_counts_reference(a, b))
    keys = {(cuda.index or 0, st.cuda_stream) for st in streams}
    assert keys <= set(k4._states)
    assert not any(k4._states[k].any() for k in keys)


@pytest.mark.cuda
def test_new_kernels_reject_misaligned(cuda):
    base = torch.zeros(2 * WORDS_PER_ROW + 1, dtype=torch.int32, device=cuda)
    odd = base[1:].view(2, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k3.row_counts(odd)
    with pytest.raises(ValueError, match="aligned"):
        k4.pairwise_counts(odd, odd)


K5_OPS = [("eq", False), ("lt", False), ("lt", True), ("gt", False),
          ("gt", True)]


def _bsi(depth, s, pred, seed, device):
    """[D+2, S, W] stack (exists, sign, planes) with a run of words whose
    columns hold the predicate's magnitude, as the BSI stack lays it out."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (depth + 2, s, WORDS_PER_ROW),
                     dtype=np.uint32)
    x[:, :, :2] = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    for d in range(depth):
        x[2 + d, :, 8:40] = 0xFFFFFFFF if (pred >> d) & 1 else 0
    x[0, :, 8:40] = 0xFFFFFFFF
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 21, 64])
@pytest.mark.parametrize("s", [1, 7])
@pytest.mark.parametrize("neg_pred", [False, True])
@pytest.mark.parametrize("op,allow_eq", K5_OPS)
@pytest.mark.parametrize("which", ["random", "zero", "all_ones"])
def test_bsi_range_kernel_matches_plain(cuda, op, allow_eq, neg_pred, depth,
                                        s, which):
    rng = np.random.default_rng(depth * 7 + s)
    pred = {"random": int.from_bytes(rng.bytes(8), "little"), "zero": 0,
            "all_ones": -1}[which] & ((1 << depth) - 1)
    stack = _bsi(depth, s, pred, seed=depth + s, device=cuda)
    planes, sign, exists = stack[2:], stack[1], stack[0]
    pbits = [(pred >> d) & 1 for d in range(depth)]
    before = k5.bsi_range_mask.launches
    got = k5.bsi_range_mask(op, planes, sign, exists, pbits, neg_pred,
                            allow_eq)
    torch.cuda.synchronize()
    want = k5.bsi_range_mask_reference(op, planes, sign, exists, pbits,
                                       neg_pred, allow_eq)
    assert torch.equal(got, want)
    assert k5.bsi_range_mask.launches == before + 1
    # one shard's [D, W] planes of the same stack give that shard's mask
    one = k5.bsi_range_mask(op, planes[:, s - 1], sign[s - 1],
                            exists[s - 1], pbits, neg_pred, allow_eq)
    assert torch.equal(one, want[s - 1])


@pytest.mark.cuda
def test_bsi_range_kernel_empty_and_misaligned(cuda):
    planes = torch.zeros((3, 0), dtype=torch.int32, device=cuda)
    row = torch.zeros((0,), dtype=torch.int32, device=cuda)
    before = k5.bsi_range_mask.launches
    out = k5.bsi_range_mask("lt", planes, row, row, [1, 0, 1], False, True)
    assert out.shape == (0,) and k5.bsi_range_mask.launches == before
    base = torch.zeros(3 * WORDS_PER_ROW + 1, dtype=torch.int32, device=cuda)
    odd = base[1:].view(3, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k5.bsi_range_mask("gt", odd[1:], odd[0], odd[0], [1, 1], False,
                          False)
    wide = torch.zeros((65, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="depth 65"):
        k5.bsi_range_mask("eq", wide, wide[0], wide[0], [0] * 65, False,
                          False)


def _sparse(nb, n_real, ids, seed, device):
    """(ids [nb] int32, blocks [nb, 128]) of a block-sparse container:
    `ids` (sorted) on the first n_real rows, sentinel padding with zero
    blocks after, edge words planted."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 1 << 32, (nb, 128), dtype=np.uint32)
    blocks[:, :2] = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    blocks[n_real:] = 0
    full = np.full(nb, k2.SPARSE_SENTINEL, dtype=np.int32)
    full[:n_real] = ids
    return (torch.from_numpy(full).to(device),
            torch.from_numpy(blocks.view(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("nb_a,nb_b", [(0, 4), (4, 0), (1, 1), (7, 33),
                                       (33, 7), (8, 8), (4096, 1024)])
@pytest.mark.parametrize("shared", [0.0, 0.5, 1.0])
def test_count_blocks_kernels_match_plain(cuda, nb_a, nb_b, shared):
    rng = np.random.default_rng(nb_a * 7 + nb_b)
    real_a, real_b = nb_a - nb_a // 4, nb_b - nb_b // 4
    ids_a = np.sort(rng.choice(1 << 20, real_a, replace=False))
    keep = rng.random(real_a) < shared
    rest = np.setdiff1d(np.arange(1 << 20), ids_a)
    ids_b = np.sort(np.concatenate([
        ids_a[keep][:real_b],
        rng.choice(rest, max(0, real_b - min(real_b, int(keep.sum()))),
                   replace=False)]))
    a = _sparse(nb_a, real_a, ids_a, seed=1, device=cuda)
    b = _sparse(nb_b, real_b, ids_b, seed=2, device=cuda)
    before = (k2.count_blocks.launches, k2.count_and_blocks.launches)
    got = k2.count_blocks(a[1])
    fused = k2.count_and_blocks(*a, *b)
    # identical id arrays: b's blocks already aligned onto a's
    other = a[1].flip(0).contiguous()
    same = k2.count_and_blocks(a[0], a[1], a[0], other)
    torch.cuda.synchronize()
    assert int(got) == int(k2.count_blocks_reference(a[1]))
    assert int(fused) == int(k2.count_and_blocks_reference(*a, *b))
    assert int(same) == int(k2.count_and_blocks_reference(a[0], a[1], a[0],
                                                          other))
    assert (k2.count_blocks.launches, k2.count_and_blocks.launches) == (
        before[0] + (1 if nb_a else 0),
        before[1] + (1 if nb_a else 0) + (1 if nb_a and nb_b else 0))


def _edge_ids(case, rng):
    """(ids_a, nb_a, ids_b, nb_b) of one edge case of the fused entry's
    tile-wise intersection; the real ids come first, padding after."""
    pool = np.arange(0, 1 << 21, 32)
    if case == "b_16x_denser":  # a tile's b window spans several chunks
        a = np.sort(rng.choice(pool, 300, replace=False))
        rest = np.setdiff1d(np.arange(a[0], a[-1]), a)
        b = np.sort(np.concatenate([a[::2], rng.choice(rest, 15 * 300,
                                                       replace=False)]))
        return a, 320, b, len(b) + 64
    if case == "identical":
        a = np.sort(rng.choice(pool, 1000, replace=False))
        return a, 1100, a, 1100
    if case in ("a_above_b", "a_below_b"):
        lo = np.sort(rng.choice(1 << 20, 3000, replace=False))
        hi = np.sort(rng.choice(1 << 20, 500, replace=False)) + (1 << 20)
        if case == "a_above_b":
            return hi, 512, lo, 3072
        return lo[:500], 512, hi, 3072
    if case == "ragged":  # NB_a not a multiple of the 128-id tile
        a = np.sort(rng.choice(pool, 290, replace=False))
        b = np.sort(np.concatenate([a[1::2], np.setdiff1d(
            rng.choice(pool, 400, replace=False), a)]))
        return a, 300, b, len(b) + 5
    if case == "a_padding":
        return np.empty(0, np.int64), 256, np.arange(0, 5000, 3), 2000
    if case == "b_padding":
        return np.arange(0, 5000, 3)[:1500], 1600, np.empty(0, np.int64), 700
    if case == "nb_a_1":
        b = np.sort(rng.choice(pool, 5000, replace=False))
        return b[2345:2346], 1, b, 5000
    raise ValueError(case)


EDGE_CASES = ["b_16x_denser", "identical", "a_above_b", "a_below_b",
              "ragged", "a_padding", "b_padding", "nb_a_1"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_kernel_edge_cases(cuda, case):
    rng = np.random.default_rng(len(case))
    ids_a, nb_a, ids_b, nb_b = _edge_ids(case, rng)
    a = _sparse(nb_a, len(ids_a), ids_a, seed=3, device=cuda)
    b = _sparse(nb_b, len(ids_b), ids_b, seed=4, device=cuda)
    before = k2.count_and_blocks.launches
    got = k2.count_and_blocks(*a, *b)
    torch.cuda.synchronize()
    assert int(got) == int(k2.count_and_blocks_reference(*a, *b))
    assert k2.count_and_blocks.launches == before + 1


@pytest.mark.cuda
def test_count_blocks_kernels_reject_misaligned(cuda):
    base = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda)
    odd = base[1:].view(4, 128)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        k2.count_blocks(odd)
    with pytest.raises(ValueError, match="aligned"):
        k2.count_and_blocks(ids, odd, ids, odd)


def _k2_batch_members(b, nb_a, nb_b, device):
    """B (ids_a, blocks_a, ids_b, blocks_b) members of one shape: each
    matching none, half or all of a's real ids in b, one member whose a
    is padding only and one whose b is (at B >= 3)."""
    rng = np.random.default_rng(b * 31 + nb_a)
    out = []
    for q in range(b):
        real_a, real_b = nb_a - nb_a // 4 - q % 5, nb_b - nb_b // 4
        if q == b - 1 and b >= 3:
            real_a = 0
        if q == b - 2 and b >= 3:
            real_b = 0
        ids_a = np.sort(rng.choice(1 << 20, real_a, replace=False))
        share = min(real_a, real_b) * (q % 3) // 2
        rest = np.setdiff1d(np.arange(1 << 20), ids_a)
        ids_b = np.sort(np.concatenate([
            rng.choice(ids_a, share, replace=False),
            rng.choice(rest, real_b - share, replace=False)]))
        out.append((*_sparse(nb_a, real_a, ids_a, seed=2 * q, device=device),
                    *_sparse(nb_b, real_b, ids_b, seed=2 * q + 1,
                             device=device)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,nb_a,nb_b", [(1, 64, 64), (3, 200, 1100),
                                         (5, 1100, 200), (16, 32768, 32768)])
def test_count_blocks_batch_kernel_matches_plain_and_singles(cuda, b, nb_a,
                                                             nb_b):
    """Both modes of K2's batched entry: one launch each, equal to the
    plain version and to B single launches, padding-only members 0."""
    members = _k2_batch_members(b, nb_a, nb_b, cuda)
    blocks = [m[1] for m in members]
    before = (k2.count_blocks_batch.launches,
              k2.count_and_blocks_batch.launches)
    got = k2.count_blocks_batch(blocks)
    fused = k2.count_and_blocks_batch(members)
    torch.cuda.synchronize()
    assert (k2.count_blocks_batch.launches,
            k2.count_and_blocks_batch.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert got.device.type == "cuda" and got.shape == (b,)
    assert got.tolist() == k2.count_blocks_batch_reference(blocks).tolist()
    assert got.tolist() == [int(k2.count_blocks(x)) for x in blocks]
    assert fused.tolist() == \
        k2.count_and_blocks_batch_reference(members).tolist()
    assert fused.tolist() == [int(k2.count_and_blocks(*m)) for m in members]
    if b >= 3:
        assert fused.tolist()[-2:] == [0, 0]


@pytest.mark.cuda
def test_count_blocks_batch_kernel_empty_and_misaligned(cuda):
    """An empty batch, NB = 0 and NB_b = 0 give zeros without a launch;
    misaligned blocks and mismatched members are refused."""
    before = (k2.count_blocks_batch.launches,
              k2.count_and_blocks_batch.launches)
    assert k2.count_blocks_batch([]).shape == (0,)
    empty = _sparse(0, 0, [], seed=0, device=cuda)
    some = _sparse(8, 6, np.arange(6), seed=1, device=cuda)
    out = k2.count_blocks_batch([empty[1]] * 3)
    assert out.device.type == "cuda" and out.tolist() == [0, 0, 0]
    out = k2.count_and_blocks_batch([(*some, *empty)] * 2)
    assert out.device.type == "cuda" and out.tolist() == [0, 0]
    assert (k2.count_blocks_batch.launches,
            k2.count_and_blocks_batch.launches) == before
    base = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda)
    odd = base[1:].view(4, 128)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    good = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        k2.count_blocks_batch([good, odd])
    with pytest.raises(ValueError, match="aligned"):
        k2.count_and_blocks_batch([(ids, good, ids, good),
                                   (ids, odd, ids, good)])
    with pytest.raises(ValueError, match="one shape"):
        k2.count_blocks_batch([good, some[1]])
    assert (k2.count_blocks_batch.launches,
            k2.count_and_blocks_batch.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "blocks", "runs", "empty"])
def test_analyze_on_card_matches_cpu(cuda, pattern):
    """The chooser's counts taken on the card equal those of the same
    words on the CPU, and build keeps or compresses the leaf alike."""
    from pilosa_tpu_torch.ops import containers

    rng = np.random.default_rng(len(pattern))
    s = 40  # 5 MiB dense: above the 4 MiB auto floor
    x = np.zeros((s, WORDS_PER_ROW), dtype=np.uint32)
    if pattern == "random":
        x[:] = rng.integers(0, 1 << 32, x.shape, dtype=np.uint32)
    elif pattern == "blocks":
        b = x.reshape(s, -1, 128)
        b[:, :3] = rng.integers(0, 1 << 32, (s, 3, 128), dtype=np.uint32)
    elif pattern == "runs":
        x[:, 100:4000] = 0xFFFFFFFF
        x[:, 99] = 0x80000000
    t = torch.from_numpy(x.view(np.int32))
    assert containers.analyze(t.to(cuda)) == containers.analyze(t)
    got = containers.build(x, cuda, mode="auto")
    want = containers.build(x, "cpu", mode="auto")
    assert got.kind == want.kind and got.nbytes == want.nbytes
    for a, b in zip(got.arrays, want.arrays):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_ingest_merge_and_overlay_on_card(cuda, tmp_path):
    """The streaming ingest merge on CUDA stacks: a dense leaf copied in
    place and a sparse leaf given an overlay term, both still on the
    card; Counts equal the host bits, and the overlay leaf counts with
    K1 (densified), not K2. The planner's declared costs carry the
    card's bound."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.ops import containers
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    floor, mode = containers.AUTO_COMPRESS_FLOOR, containers.repr_mode()
    containers.AUTO_COMPRESS_FLOOR = 0
    containers.configure("auto")
    holder = Holder(str(tmp_path), use_snapshot_queue=False).open()
    api = API(holder, device="cuda", ingest_interval=3600.0)
    try:
        api.create_index("i")
        api.create_field("i", "f")
        rng = np.random.default_rng(3)
        dense = [s * SHARD_WIDTH + int(c) for s in range(4)
                 for c in rng.choice(SHARD_WIDTH, 20000, replace=False)]
        sparse = [s * SHARD_WIDTH + 5 * k for s in range(4)
                  for k in range(40)]
        api.import_bits("i", "f", [1] * len(dense), dense)
        api.import_bits("i", "f", [2] * len(sparse), sparse)
        api.ingest.flush()
        ex = api.executor
        assert ex.execute("i", "Count(Row(f=1))") == [len(dense)]
        assert ex.execute("i", "Count(Row(f=2))") == [len(sparse)]
        pool = ex._stacked._pools["leaf"]
        kinds = {k[3]: e[1].kind for k, e in pool.items()}
        assert kinds == {1: "dense", 2: "sparse"}
        api.import_bits("i", "f", [1, 2], [1, 2 * SHARD_WIDTH + 7])
        api.ingest.flush()
        assert api.ingest.scatter_entries >= 1
        assert api.ingest.overlay_entries == 1
        leaves = {k[3]: e[1] for k, e in pool.items()}
        assert leaves[2].kind == "sparse" and leaves[2].overlay == 1
        assert all(a.is_cuda for c in leaves.values() for a in c.arrays)
        before = (k1.count_expr.launches, k2.count_blocks.launches)
        assert ex.execute("i", "Count(Row(f=1))") == [len(dense) + 1]
        assert ex.execute("i", "Count(Row(f=2))") == [len(sparse) + 1]
        assert (k1.count_expr.launches - before[0],
                k2.count_blocks.launches - before[1]) == (2, 0)
        costs = ex.kernel_stats()["compiled"]
        assert costs and all("optimal_seconds" in c["cost"] for c in costs)
    finally:
        api.close()
        holder.close()
        containers.AUTO_COMPRESS_FLOOR = floor
        containers.configure(mode)


@pytest.mark.cuda
def test_fuzz_trees_sparse_through_kernels(cuda, tmp_path):
    """Five random trees of tools/fuzz.py's set fuzz (seed 7) and its
    fixed set, under a forced sparse repr on the card: every Count and
    Row equals the naive model, and K2's two entries and K1 launch."""
    import random

    from pilosa_tpu_torch.ops import containers
    from pilosa_tpu_torch.tools import fuzz

    prev = containers.repr_mode()
    containers.configure("sparse")
    holder, api, model = fuzz.build(tmp_path, 7, device=cuda)
    try:
        for fn in (k1.count_expr, k2.count_blocks, k2.count_and_blocks):
            fn.launches = 0
        done = fuzz.check_set(api.executor, model, random.Random(7 * 31), 5)
        fuzz.check_fixed(api.executor, "fz", model, fuzz.fixed_set_queries())
        # a mixed tree: every leaf densified, one K1 launch
        mixed = "Count(Union(Row(f=1), Not(Row(g=2))))"
        want = len(model.rows[("f", 1)]
                   | (model.exists - model.rows[("g", 2)]))
        assert api.executor.execute("fz", mixed) == [want]
        assert len(done) == 5
        assert k2.count_blocks.launches > 0
        assert k2.count_and_blocks.launches > 0
        assert k1.count_expr.launches > 0
    finally:
        holder.close()
        containers.configure(prev)
