"""The port's run containers against the TPU package's, on the CPU.

`runs_to_words` fills a run container's words with no per-run loop; the
TPU package fills each run in turn. Both must give the same words for
the same runs, and a fragment whose WAL holds rows of many runs must
reopen to the rows that were written. Tolerance: exact equality.
"""

import numpy as np
import pytest

from pilosa_tpu.roaring import containers as jrc
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.roaring import containers as trc
from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW


def _runs_of(bits):
    """[R, 2] uint16 [start, last] runs of a bool array of 2^16 bits."""
    d = np.diff(np.concatenate([[0], bits.astype(np.int8), [0]]))
    return np.stack([np.nonzero(d == 1)[0],
                     np.nonzero(d == -1)[0] - 1], axis=1).astype(np.uint16)


def _bits(case):
    rng = np.random.default_rng(len(case))
    bits = np.zeros(1 << 16, dtype=bool)
    if case == "full":
        bits[:] = True
    elif case == "first_and_last_bit":
        bits[[0, (1 << 16) - 1]] = True
    elif case == "inside_one_word":
        bits[37:45] = True
    elif case == "word_edges":
        bits[31:33] = True
        bits[64:96] = True
        bits[127:1000] = True
    elif case == "random_words":
        words = rng.integers(0, 1 << 32, 96, dtype=np.uint32)
        bits[:96 * 32] = np.unpackbits(words.view(np.uint8),
                                       bitorder="little").astype(bool)
    elif case == "long_runs":
        for a in rng.choice(60000, 12, replace=False):
            bits[a:a + int(rng.integers(1, 5000))] = True
    return bits


CASES = ["empty", "full", "first_and_last_bit", "inside_one_word",
         "word_edges", "random_words", "long_runs"]


@pytest.mark.parametrize("case", CASES)
def test_run_container_words_match_reference(case):
    bits = _bits(case)
    runs = _runs_of(bits)
    got = trc.Container(trc.TYPE_RUN, runs=runs).to_dense_words()
    want = jrc.Container(jrc.TYPE_RUN, runs=runs).to_dense_words()
    assert got.dtype == np.uint32 and got.shape == (trc.WORDS,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.packbits(bits, bitorder="little").view(np.uint32))


def test_fragment_reopens_rows_of_many_runs(tmp_path):
    """Rows of random 128-word blocks and of long runs, written whole, come
    back word for word when the fragment's WAL is replayed at open."""
    rng = np.random.default_rng(5)
    blocks = np.zeros((WORDS_PER_ROW // 128, 128), dtype=np.uint32)
    where = rng.choice(len(blocks), 24, replace=False)
    blocks[where] = rng.integers(0, 1 << 32, (24, 128), dtype=np.uint32)
    runs = np.zeros(WORDS_PER_ROW * 32, dtype=np.uint8)
    runs[1000:6242] = 1
    runs[700000:705242] = 1
    rows = {10: blocks.reshape(-1),
            20: np.packbits(runs, bitorder="little").view(np.uint32)}
    h = Holder(str(tmp_path), use_snapshot_queue=False).open()
    frag = h.create_index("b").create_field("f").create_view_if_not_exists(
        "standard").create_fragment_if_not_exists(0)
    for row, plane in rows.items():
        assert frag.set_row_plane(row, plane)
    h.close()
    h = Holder(str(tmp_path), use_snapshot_queue=False).open()
    try:
        frag = h.index("b").field("f").view("standard").fragment(0)
        for row, plane in rows.items():
            np.testing.assert_array_equal(frag.row_plane(row), plane)
    finally:
        h.close()
