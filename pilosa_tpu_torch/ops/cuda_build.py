"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is
compiled with `nvcc` for Hopper (`sm_90a`) into a shared library under
`pilosa_tpu_torch/_build/`, named by a hash of the source and the flags so
an edited source never loads a stale library, and loaded with ctypes.
Nothing is compiled when a module is imported: the CPU tests import every
module on machines without `nvcc`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the card the declared costs' `optimal_seconds` are stated for: an
#: NVIDIA H100 80GB HBM3 — its memory rate (bytes/s, NVIDIA data sheet)
#: and its POPC issue rate (16 results per SM per clock, CUDA C
#: Programming Guide, cc 9.0, x 132 SMs x 1.98 GHz)
COST_CARD = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_SECOND = 3.35e12
POPC_PER_SECOND = 16 * 132 * 1.98e9

_lock = threading.Lock()
_libs = {}
#: per-kernel build record: {name: {"seconds", "cached", "log"}}
build_info = {}
_launch_lock = threading.Lock()


def nvcc_path():
    """`nvcc` from CUDA_HOME, then PATH, then the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from source at first use")


def source_path(name):
    return os.path.join(CSRC_DIR, name + ".cu")


def _lib_path(name):
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name):
    """Compile `csrc/<name>.cu` (if its library is not built yet) and
    return the library path. Raises with nvcc's output on failure."""
    out = _lib_path(name)
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "cached": True,
                                     "log": ""})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds, "cached": False,
                        "log": proc.stdout + proc.stderr}
    return out


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
    return lib


def count_launch(wrapper):
    """Add one to a kernel wrapper's `launches` counter. Wrappers are
    called from concurrent threads (the per-shard fallbacks fan out over
    the worker pool), and `+= 1` on an attribute is not atomic."""
    with _launch_lock:
        wrapper.launches += 1


def is_device_failure(exc):
    """True for a failure of the card itself: a kernel wrapper's failed
    launch ("... kernel launch failed: CUDA error N") or an error torch
    raises from a CUDA call ("CUDA error: ..."). Fallback paths that
    swallow other errors must let these through."""
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def declared_cost(nbytes, device=None, popc=None):
    """The cost a kernel wrapper declares for one launch, pure host
    arithmetic on its shapes (the port's stand-in for XLA's
    cost_analysis): `bytes accessed` — each input read once and the
    output written once, as PERF.md counts a kernel's bound — and, for
    K4, its `popc` count. `optimal_seconds`, the bound (the larger of
    bytes over COST_CARD's memory rate and POPCs over its issue rate),
    is declared only for a CUDA device; on the CPU it is absent, as
    XLA's is there."""
    cost = {"bytes accessed": int(nbytes)}
    seconds = nbytes / HBM_BYTES_PER_SECOND
    if popc is not None:
        cost["popc"] = int(popc)
        seconds = max(seconds, popc / POPC_PER_SECOND)
    dev = getattr(device, "type", device)
    if dev is not None and str(dev).startswith("cuda"):
        cost["optimal_seconds"] = seconds
        cost["card"] = COST_CARD
    return cost

