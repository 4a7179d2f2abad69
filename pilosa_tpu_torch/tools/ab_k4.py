"""A/B of K4 (the pairwise count matrix) between two checkouts on one
CUDA card.

    python -m pilosa_tpu_torch.tools.ab_k4 --a DIR --b DIR [--reps 50]
        [--stateless A|B] [--only NAME,...]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the rows, the flush and the trace). It builds each
side's `pilosa_tpu_torch/csrc/pairwise_counts.cu` with the port's nvcc
flags into a temporary directory and calls its C entry point
`pairwise_counts_launch` through ctypes, with a zeroed state of its own
as the wrapper hands it over; the side named by --stateless has the
entry of c78a462 and before, which takes no state argument (give
`--stateless A` when A is that tree). Shapes: GroupBy's served tile
5 x 4 x S = 10 without and with a filter, 8 x 8 and 2 x 2 at S = 10, a
1B-column GroupBy's 1 x 1 x S = 954 (the small kernel), and the tiled
kernel's: the served 100 x 5 and 100 x 100 (GroupBy(Rows(f), Rows(a))
and GroupBy(Rows(f), Rows(f)) over config 3's 10 shards), 102 x 102
(config 3's full row chunk) and a ragged 13 x 130, all at S = 10. Every
result is checked against
`pairwise_counts_reference` first. Each side's device time per call
comes from a torch.profiler trace of `reps` calls, summed over every
device operation the call issues (a memset included; the flush's own
kernels left out), beside the K4 kernel's time alone, in four states of
the 50 MB L2: flushed by a 128 MB write right before every call
("dirty"), the same with the device then left idle for 0.1 ms
("dirty_idle"), flushed by a 128 MB read (a row-wise max, "clean")
and warm. The sides take turns A, B, B, A in each state. It prints a first JSON line with
each side's nvcc seconds and ptxas register lines, then one per shape
with every time in µs as [all operations, kernel] pairs, the bytes the
call must move, its bound (the larger of the bytes at 3.35 TB/s and the
bit pairs at the card's fastest rate for them, `chip_smoke.k4_bound`)
and what bounds it, the device operations counted in each state, and
the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FLUSHES = ("dirty", "dirty_idle", "clean", "warm")
IDLE_S = 1e-4
# (name, R1, R2, S, filter)
SHAPES = (("5x4 S=10", 5, 4, 10, False), ("5x4 S=10 filter", 5, 4, 10, True),
          ("8x8 S=10", 8, 8, 10, False), ("2x2 S=10", 2, 2, 10, False),
          ("1x1 S=954", 1, 1, 954, False),
          ("100x5 S=10", 100, 5, 10, False),
          ("100x100 S=10", 100, 100, 10, False),
          ("102x102 S=10", 102, 102, 10, False),
          ("13x130 S=10", 13, 130, 10, False))


def _build(checkout, out_dir, tag, cuda_build):
    src = os.path.join(checkout, "pilosa_tpu_torch", "csrc",
                       "pairwise_counts.cu")
    path = os.path.join(out_dir, f"libpairwise_counts_{tag}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", path,
         src], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(path), {"nvcc_s": seconds, "ptxas": regs}


def _launcher(torch, lib, stateless):
    """launch(a, b, filt, out) for one side's library; `stateless` for
    an entry without the state argument."""
    fn = lib.pairwise_counts_launch
    fn.restype = ctypes.c_int
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [ptr, i32, ptr, i32, ptr, i64, ptr]
    stream = torch.cuda.current_stream()
    if stateless:
        fn.argtypes = head + [ptr]

        def launch(a, b, filt, out):
            return fn(a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
                      filt, a.shape[1], out.data_ptr(), stream.cuda_stream)
        return launch
    fn.argtypes = head + [ptr] * 2
    state = torch.zeros(64, dtype=torch.int64, device="cuda")

    def launch(a, b, filt, out):
        return fn(a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0], filt,
                  a.shape[1], out.data_ptr(), state.data_ptr(),
                  stream.cuda_stream)
    return launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. a parent)")
    ap.add_argument("--b", required=True, help="checkout B")
    ap.add_argument("--stateless", choices=("A", "B"),
                    help="the side whose pairwise_counts_launch takes no "
                         "state argument (c78a462 and before)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default="",
                    help="comma-separated shape names (default: all)")
    args = ap.parse_args(argv)
    shapes = [sh for sh in SHAPES
              if not args.only or sh[0] in args.only.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("ab_k4: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from pilosa_tpu_torch.ops import cuda_build
    from pilosa_tpu_torch.ops import pairwise as k4
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    tmp = tempfile.mkdtemp(prefix="ab-k4-")
    fns, builds = {}, {}
    try:
        for side, checkout in (("A", args.a), ("B", args.b)):
            lib, builds[side] = _build(checkout, tmp, side.lower(), cuda_build)
            fns[side] = _launcher(torch, lib, args.stateless == side)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card, "a": args.a, "b": args.b,
                      "stateless": args.stateless, "build": builds}),
          flush=True)
    junk = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def device_us(fn, flush):
        def timed():
            if flush.startswith("dirty"):
                junk.fill_(1)
            elif flush == "clean":  # a row-wise max: no memset, small output
                junk.view(-1, 4096).amax(dim=1)
            if flush == "dirty_idle":
                torch.cuda.synchronize()
                time.sleep(IDLE_S)
            fn()
        for _ in range(3):  # a trace now and then holds no device time
            got = cs.call_device_ms(torch, timed, args.reps, "pairwise_",
                                    launches=1)
            if got is not None:
                return [got[0] * 1e3, got[1] * 1e3], got[2]
        raise RuntimeError("three profiler traces held no K4 kernel")

    rng = np.random.default_rng(cs.SEED + 2)
    for name, r1, r2, s, has_filt in shapes:
        t = s * WORDS_PER_ROW
        a = torch.from_numpy(cs._edge_rows(rng, r1, t).view(np.int32)).cuda()
        b = torch.from_numpy(cs._edge_rows(rng, r2, t).view(np.int32)).cuda()
        f = torch.from_numpy(cs._edge_rows(rng, 1, t)[0].view(
            np.int32)).cuda() if has_filt else None
        fp = None if f is None else f.data_ptr()
        out = torch.empty((r1, r2), dtype=torch.int64, device="cuda")
        want = k4.pairwise_counts_reference(a, b, f)
        for side, launch in fns.items():
            out.fill_(-1)
            err = launch(a, b, fp, out)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}: side {side}: CUDA error {err}")
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: side {side} != plain")
        us = {side: {fl: [] for fl in FLUSHES} for side in fns}
        ops = {side: {} for side in fns}
        for flush in FLUSHES:
            for side in ("A", "B", "B", "A"):
                got, ops[side][flush] = device_us(
                    lambda: fns[side](a, b, fp, out), flush)
                us[side][flush].append(got)
        bound_ms, bound_by, bytes_ms, ops_ms = cs.k4_bound(
            r1, r2, t, has_filt)
        print(json.dumps({
            "shape": name, "bytes": round(bytes_ms / 1e3 * cs.H100_BYTES_PER_S),
            "bound_us": bound_ms * 1e3, "bytes_us": bytes_ms * 1e3,
            "bit_pairs_us": ops_ms * 1e3, "bound_by": bound_by, "us": us,
            "ops": ops, "card": card}),
            flush=True)
        del a, b, f
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
