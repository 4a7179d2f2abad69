"""The port's shard-width matrix: the counterpart of
tests/test_shardwidth_matrix.py for pilosa_tpu_torch.

Both packages read PILOSA_TPU_SHARD_EXP once, at import, so a subset of
the port's differential tests runs in subprocesses at 2^16 and at 2^24
columns a shard, beside the suite's default 2^20. The subset is what
depends on the geometry: the plain versions of K1 (with its batched and
multi-tree entries), K2 (its batched entry included: a block id packs
(shard, block) with W / 128 blocks a shard, 16 at 2^16 and 4096 at 2^24)
and K5; the container chooser and builders; the roaring codec's run
containers; the slice's served Counts; and the batched K2 path. `-k`
narrows each file so that a subprocess ends in about a minute, and each
gets one OpenMP thread (ROADMAP trap 37). Tolerance: the selected tests'
own (exact equality).

Left out at both widths: for wall time, K1's chains over 16 and 17
shards (0 and 1 shard run the same code) and the chooser's served
corpora (`served_results`, `set_on_compressed_leaf`; the slice's and
the K2 batch path's served Counts run instead): these 6 tests pass at
2^24 but take ~125 s on one thread; and the tests that do not depend on
the width (input checks, flags, imports, HTTP). Where the selections
differ by width:
- at 2^16 K5's plain version is held to the TPU package's jnp range ops
  (`test_plain_k5_extreme_predicates` and the comparator cases), not to
  its Pallas `bsi_range_mask`: that kernel tiles the words in blocks of
  4096 (`_BSI_BLOCK_WORDS`, pilosa_tpu/ops/pallas_kernels.py:419), so
  at 2048 words a row its grid is empty and its output undefined, while
  the port's answers equal the jnp ops;
- at 2^24 K5 is held to the Pallas kernel at depth 21 only, and
  `plane_counts` is left out, for wall time: the other depths and
  `plane_counts` pass at 2^24 but add ~95 s to the subprocess on one
  thread; they run at 2^16 (plane_counts) and at the suite's 2^20;
- at 2^24 the chooser's dense-pattern cases (`random_50pct`,
  `alternating`, `auto_pool`) take ~85 s on one thread, so they run in a
  subprocess of their own (`test_port_dense_patterns_at_2_24`);
- at 2^16 `test_fragment_reopens_rows_of_many_runs` is left out: its
  fixture draws 24 blocks of a shard, more than the 16 a shard holds.
"""

import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(__file__)

K5_JNP = "extreme_predicates or compare_unsigned or range_between"
CONTAINERS = ("analyze or choose or host_builders or build_ or plain_k2 "
              "or fused_plain or count_program or plane_program")
DENSE_PATTERNS = "random_50pct or alternating or auto_pool"

#: file -> {exponent: -k expression, None for every test}
SELECTION = {
    "test_torch_count_expr.py": dict.fromkeys(
        ("16", "24"),
        "(plain_k1_matches_pallas_chain and (0- or 1-)) or edge_words "
        "or tree_eval or batch_reference or multi_reference "
        "or program_compilation"),
    "test_torch_containers.py": {
        "16": CONTAINERS,
        "24": f"({CONTAINERS}) and not ({DENSE_PATTERNS})"},
    "test_torch_k2_batch.py": {"16": None, "24": None},
    "test_torch_bsi.py": {
        "16": f"{K5_JNP} or plane_counts",
        "24": f"(plain_k5_matches_pallas and 21) or {K5_JNP}"},
    "test_torch_roaring.py": {
        "16": "not fragment_reopens_rows_of_many_runs", "24": None},
    "test_torch_slice.py": dict.fromkeys(
        ("16", "24"),
        "port_matches_reference or fallback_and_shard_subsets "
        "or stacked_path or own_write"),
}


@pytest.mark.parametrize("name", sorted(SELECTION))
@pytest.mark.parametrize("exp", ["16", "24"])
def test_port_subset_at_exponent(exp, name):
    _run_at(exp, name, SELECTION[name][exp])


def test_port_dense_patterns_at_2_24():
    _run_at("24", "test_torch_containers.py",
            f"({CONTAINERS}) and ({DENSE_PATTERNS})")


def _run_at(exp, name, expr):
    """pytest over tests/`name` -k `expr` (every test for None) in a
    subprocess at PILOSA_TPU_SHARD_EXP=`exp`; asserts it passed."""
    args = [os.path.join(TESTS, name)]
    if expr is not None:
        args += ["-k", expr]
    env = dict(os.environ, PILOSA_TPU_SHARD_EXP=exp, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-x", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", *args],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(TESTS), timeout=600)
    # a selection that matches nothing exits 5: a failure too
    assert proc.returncode == 0 and " passed" in proc.stdout, \
        f"SHARD_EXP={exp} {name} -k {expr!r} (rc {proc.returncode}):\n" \
        f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}"
