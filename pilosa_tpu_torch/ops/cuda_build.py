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
