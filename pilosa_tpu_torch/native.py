"""ctypes bindings for the native host-side kernels (native/pilosa_native.cpp).

Loads `native/libpilosa_native.so`, building it once with `make` if absent
(and a compiler is available). Every entry point has a pure-Python/numpy
fallback so the package works without a toolchain; `PILOSA_TPU_NATIVE=0`
forces the fallbacks.

The split mirrors the reference: query algebra is device-side
(ops/bitplane.py); this module covers the host storage loops — WAL op
checksums (reference: roaring.go:4694), position<->plane conversion on
import/export (fragment.go:1997, roaring.go:1511), and run detection for
container optimization (roaring.go:2334).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libpilosa_native.so")


def _load():
    """Load (building if needed) the shared library; None on any failure."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        lib = None
        if os.environ.get("PILOSA_TPU_NATIVE", "1") != "0":
            try:
                # Build to a process-private name then atomically publish:
                # concurrent processes (multi-node-on-one-host, xdist) must
                # never CDLL a half-written .so. make no-ops when current.
                tmp = f"{_SO_PATH}.{os.getpid()}"
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"SO_OUT={tmp}"],
                    check=True, capture_output=True, timeout=120)
                if os.path.exists(tmp):
                    os.replace(tmp, _SO_PATH)
                lib = ctypes.CDLL(_SO_PATH)
                _declare(lib)
            except Exception as e:
                import warnings

                warnings.warn(
                    f"pilosa_tpu_torch native library unavailable, using Python "
                    f"fallbacks ({type(e).__name__}: {e})", RuntimeWarning)
                lib = None
        _lib = lib
        _tried = True
        return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    size_t = ctypes.c_size_t

    lib.pilosa_fnv1a32.restype = ctypes.c_uint32
    lib.pilosa_fnv1a32.argtypes = [u8p, size_t, ctypes.c_uint32]
    lib.pilosa_popcount.restype = ctypes.c_int64
    lib.pilosa_popcount.argtypes = [u32p, size_t]
    lib.pilosa_popcount_per_word.restype = None
    lib.pilosa_popcount_per_word.argtypes = [u32p, size_t, i64p]
    lib.pilosa_scatter_u64.restype = size_t
    lib.pilosa_scatter_u64.argtypes = [u64p, size_t, u32p, size_t]
    lib.pilosa_scatter_u16.restype = size_t
    lib.pilosa_scatter_u16.argtypes = [u16p, size_t, u32p, size_t]
    lib.pilosa_extract_u64.restype = size_t
    lib.pilosa_extract_u64.argtypes = [u32p, size_t, u64p]
    lib.pilosa_extract_u16.restype = size_t
    lib.pilosa_extract_u16.argtypes = [u32p, size_t, u16p]
    lib.pilosa_extract_runs_u16.restype = size_t
    lib.pilosa_extract_runs_u16.argtypes = [u32p, size_t, u16p]


def enabled():
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_inplace(plane):
    """Functions mutating a plane require a C-contiguous uint32 buffer —
    a silent dtype/layout copy would discard the caller's writes."""
    if not (isinstance(plane, np.ndarray) and plane.dtype == np.uint32
            and plane.flags.c_contiguous and plane.flags.writeable):
        raise ValueError(
            "in-place plane op requires a writeable C-contiguous uint32 "
            f"ndarray, got {type(plane).__name__}"
            + (f" dtype={plane.dtype}" if isinstance(plane, np.ndarray)
               else ""))
    return plane


# ---------------------------------------------------------------------------
# Entry points (native with Python fallback)
# ---------------------------------------------------------------------------

def fnv1a32(data, h0=2166136261):
    """FNV-1a 32 over bytes/ndarray, chainable via h0."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8)
    if lib is not None:
        return int(lib.pilosa_fnv1a32(
            _ptr(buf, ctypes.c_uint8), buf.size, h0))
    h = h0
    for b in buf.tobytes():
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def popcount(words):
    """Total set bits of a uint32 ndarray."""
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is not None:
        return int(lib.pilosa_popcount(_ptr(words, ctypes.c_uint32),
                                       words.size))
    return int(np.sum(_popcount_per_word_py(words)))


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _popcount_per_word_py(words):
    return _POP8[words.view(np.uint8)].reshape(-1, 4).sum(
        axis=1, dtype=np.int64)


def popcount_per_word(words):
    """Per-uint32-word popcount -> int64 ndarray."""
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is not None:
        out = np.empty(words.size, dtype=np.int64)
        lib.pilosa_popcount_per_word(
            _ptr(words, ctypes.c_uint32), words.size,
            _ptr(out, ctypes.c_int64))
        return out
    return _popcount_per_word_py(words)


def scatter(positions, plane):
    """OR bit positions into a uint32 plane in place; ignores out-of-range."""
    lib = _load()
    plane = _check_inplace(plane)
    if lib is not None:
        pos = np.ascontiguousarray(positions, dtype=np.uint64)
        lib.pilosa_scatter_u64(
            _ptr(pos, ctypes.c_uint64), pos.size,
            _ptr(plane, ctypes.c_uint32), plane.size)
        return plane
    pos = np.asarray(positions, dtype=np.uint64)
    pos = pos[pos < np.uint64(plane.size * 32)]
    np.bitwise_or.at(plane, (pos // 32).astype(np.int64),
                     np.uint32(1) << (pos % np.uint64(32)).astype(np.uint32))
    return plane


def extract(plane):
    """Sorted uint64 set-bit positions of a uint32 plane."""
    lib = _load()
    plane = np.ascontiguousarray(plane, dtype=np.uint32)
    if lib is not None:
        out = np.empty(popcount(plane), dtype=np.uint64)
        n = lib.pilosa_extract_u64(
            _ptr(plane, ctypes.c_uint32), plane.size,
            _ptr(out, ctypes.c_uint64))
        return out[:n]
    nz = np.nonzero(plane)[0]
    if len(nz) == 0:
        return np.empty(0, dtype=np.uint64)
    bits = np.unpackbits(plane[nz].view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    w, b = np.nonzero(bits)
    return nz[w].astype(np.uint64) * 32 + b.astype(np.uint64)


def extract_u16(plane):
    """Sorted uint16 set-bit positions of a container plane (<=2^16 bits)."""
    lib = _load()
    plane = np.ascontiguousarray(plane, dtype=np.uint32)
    if lib is not None:
        out = np.empty(popcount(plane), dtype=np.uint16)
        n = lib.pilosa_extract_u16(
            _ptr(plane, ctypes.c_uint32), plane.size,
            _ptr(out, ctypes.c_uint16))
        return out[:n]
    return extract(plane).astype(np.uint16)


def scatter_u16(values, plane):
    """OR uint16 positions into a container plane in place."""
    lib = _load()
    plane = _check_inplace(plane)
    if lib is not None:
        pos = np.ascontiguousarray(values, dtype=np.uint16)
        lib.pilosa_scatter_u16(
            _ptr(pos, ctypes.c_uint16), pos.size,
            _ptr(plane, ctypes.c_uint32), plane.size)
        return plane
    return scatter(np.asarray(values, dtype=np.uint64), plane)


def extract_runs(plane):
    """[R, 2] uint16 [start, last] inclusive runs of a container plane."""
    lib = _load()
    plane = np.ascontiguousarray(plane, dtype=np.uint32)
    if lib is not None:
        out = np.empty((plane.size * 16 + 1, 2), dtype=np.uint16)
        n = lib.pilosa_extract_runs_u16(
            _ptr(plane, ctypes.c_uint32), plane.size,
            _ptr(out, ctypes.c_uint16))
        return out[:n].copy()
    values = extract(plane).astype(np.int64)
    if len(values) == 0:
        return np.empty((0, 2), dtype=np.uint16)
    breaks = np.nonzero(np.diff(values) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(values) - 1]])
    return np.stack([values[starts], values[ends]], axis=1).astype(np.uint16)

