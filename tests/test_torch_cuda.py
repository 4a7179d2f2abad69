"""K1, K3 and K4 on the card: each CUDA kernel against its plain PyTorch
version.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test skips (with the reason) where no CUDA device is present.
Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch

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
def test_new_kernels_reject_misaligned(cuda):
    base = torch.zeros(2 * WORDS_PER_ROW + 1, dtype=torch.int32, device=cuda)
    odd = base[1:].view(2, WORDS_PER_ROW)
    with pytest.raises(ValueError, match="aligned"):
        k3.row_counts(odd)
    with pytest.raises(ValueError, match="aligned"):
        k4.pairwise_counts(odd, odd)
