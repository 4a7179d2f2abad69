"""The collective data plane's host pieces, in this process: the plan's
wire encoding against the TPU package's, the Min/Max combine of the
ranks' partials against one walk over every rank's values (the
reference's sign rules, -0 included), and the Min/Max comparison tool's
two ways agreeing on three spawned CPU ranks."""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from pilosa_tpu.cluster import spmd as jax_spmd  # noqa: E402
from pilosa_tpu_torch.cluster import spmd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_sig(rng, depth=0):
    if depth > 3 or rng.random() < 0.3:
        return ("leaf", int(rng.integers(0, 6)))
    op = ["&", "|", "^", "-"][int(rng.integers(0, 4))]
    return (op, tuple(_random_sig(rng, depth + 1)
                      for _ in range(int(rng.integers(1, 4)))))


@pytest.mark.parametrize("seed", range(20))
def test_sig_wire_equals_reference(seed):
    sig = _random_sig(np.random.default_rng(seed))
    wire = spmd.sig_to_wire(sig)
    assert wire == jax_spmd.sig_to_wire(sig)
    assert spmd.sig_from_wire(wire) == jax_spmd.sig_from_wire(wire) == sig
    assert spmd.sig_to_wire(None) is None and spmd.sig_from_wire(None) is None


def _one_walk(items, is_max):
    """(empty, negative, magnitude, count) of one walk over (negative,
    magnitude) values with the reference's sign rules
    (fragment.go:1110-1227): Max — highest positive, else the negative
    closest to zero; Min — most negative, else the lowest positive."""
    pos = [m for neg, m in items if not neg]
    negs = [m for neg, m in items if neg]
    if not items:
        return True, False, 0, 0
    use_neg = not pos if is_max else bool(negs)
    pool = negs if use_neg else pos
    best = min(pool) if is_max == use_neg else max(pool)
    return False, use_neg, best, pool.count(best)


@pytest.mark.parametrize("seed", range(40))
@pytest.mark.parametrize("is_max", [True, False])
def test_combine_minmax_equals_one_walk(seed, is_max):
    rng = np.random.default_rng(seed)
    ranks = []
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(0, 6))
        # magnitudes from a small range, so ties, zeros and -0 occur
        ranks.append([(bool(rng.integers(0, 2)), int(rng.integers(0, 4)))
                      for _ in range(n)])
    parts = []
    for items in ranks:
        empty, neg, mag, count = _one_walk(items, is_max)
        parts.append([int(not empty), int(neg), mag, count])
    want = _one_walk(list(itertools.chain(*ranks)), is_max)
    assert spmd.combine_minmax(parts, is_max) == want


def test_combine_minmax_orders_negative_zero_below_positive_zero():
    neg_zero, pos_zero = [1, 1, 0, 2], [1, 0, 0, 3]
    assert spmd.combine_minmax([neg_zero, pos_zero], True) \
        == (False, False, 0, 3)
    assert spmd.combine_minmax([neg_zero, pos_zero], False) \
        == (False, True, 0, 2)
    assert spmd.combine_minmax([[0, 0, 0, 0]], True) == (True, False, 0, 0)


def test_minmax_tool_ways_agree_on_three_cpu_ranks():
    """The gather design and the D + 2 collective walk give the same
    Max and Min over three ranks (the tool asserts it)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.tools.spmd_minmax",
         "--ranks", "3", "--shards", "2", "--depth", "9", "--device",
         "cpu", "--reps", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"collectives": {"gather": 1, "walk": 11}' in proc.stdout
