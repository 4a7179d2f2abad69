"""The port's native host kernels (`pilosa_tpu_torch.native`) against
their pure-Python fallbacks: the cases of `tests/test_native.py`.

Each case runs the same inputs through the native path and through the
fallback (forced by masking the loaded library) and compares. The port
has no `native.fill_range`: run containers become words through
`roaring.containers.runs_to_words`, which builds the planes here, so the
reference's fill_range-only case (numpy scalar arguments) is not ported.
"""

import contextlib

import numpy as np
import pytest

from pilosa_tpu_torch import native
from pilosa_tpu_torch.roaring.containers import runs_to_words


@contextlib.contextmanager
def fallback_only():
    """Force the pure-Python fallbacks regardless of build state."""
    saved_lib, saved_tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = saved_lib, saved_tried


def test_library_builds_and_loads():
    # The toolchain is part of this image; the native path must be active.
    assert native.enabled()


def test_fnv1a32_differential(rng):
    for size in (0, 1, 13, 1000):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        want = native.fnv1a32(data)
        with fallback_only():
            assert native.fnv1a32(data) == want
    # chaining: h(a+b) == h(b, h0=h(a))
    a, b = b"hello ", b"world"
    assert native.fnv1a32(a + b) == native.fnv1a32(b, h0=native.fnv1a32(a))


def test_popcount_differential(rng):
    words = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    want_total = int(np.sum([bin(w).count("1") for w in words]))
    for impl in (lambda: native.popcount(words),):
        assert impl() == want_total
    with fallback_only():
        assert native.popcount(words) == want_total
    per = native.popcount_per_word(words)
    with fallback_only():
        np.testing.assert_array_equal(native.popcount_per_word(words), per)
    assert int(per.sum()) == want_total


def test_scatter_extract_roundtrip(rng):
    for n in (0, 1, 100, 5000):
        pos = np.unique(rng.integers(0, 32768 * 32, n, dtype=np.uint64))
        p1 = np.zeros(32768, dtype=np.uint32)
        native.scatter(pos, p1)
        with fallback_only():
            p2 = np.zeros(32768, dtype=np.uint32)
            native.scatter(pos, p2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(native.extract(p1), pos)
        with fallback_only():
            np.testing.assert_array_equal(native.extract(p1), pos)


def test_scatter_ignores_out_of_range():
    plane = np.zeros(4, dtype=np.uint32)  # 128 bits
    native.scatter(np.array([0, 127, 128, 10**9], dtype=np.uint64), plane)
    assert native.popcount(plane) == 2


def test_scatter_u16_extract_u16(rng):
    vals = np.unique(rng.integers(0, 65536, 300).astype(np.uint16))
    p1 = np.zeros(2048, dtype=np.uint32)
    native.scatter_u16(vals, p1)
    np.testing.assert_array_equal(native.extract_u16(p1), vals)
    with fallback_only():
        p2 = np.zeros(2048, dtype=np.uint32)
        native.scatter_u16(vals, p2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(native.extract_u16(p2), vals)


@pytest.mark.parametrize("pattern", [
    [], [(0, 0)], [(0, 65535)], [(5, 10), (12, 12), (100, 200)],
    [(0, 31)], [(31, 32)], [(65530, 65535)],
])
def test_runs_roundtrip(pattern):
    plane = runs_to_words(np.array(pattern, dtype=np.int64).reshape(-1, 2))
    runs = native.extract_runs(plane)
    assert [(int(s), int(l)) for s, l in runs] == pattern
    with fallback_only():
        r2 = native.extract_runs(plane)
        np.testing.assert_array_equal(np.asarray(runs), np.asarray(r2))


def test_extract_runs_random_differential(rng):
    plane = rng.integers(0, 1 << 32, 2048, dtype=np.uint32)
    runs = native.extract_runs(plane)
    # reconstruct and compare
    np.testing.assert_array_equal(plane, runs_to_words(runs))
    with fallback_only():
        r2 = native.extract_runs(plane)
    np.testing.assert_array_equal(np.asarray(runs), np.asarray(r2))


def test_inplace_contract_rejects_copies():
    with pytest.raises(ValueError):
        native.scatter(np.array([1], dtype=np.uint64),
                       np.zeros(4, dtype=np.uint64))  # wrong dtype
    with pytest.raises(ValueError):
        native.scatter_u16(np.array([1], dtype=np.uint16),
                           [0, 0, 0])  # not an ndarray
