"""A/B of K2's fused entry (`count_and_blocks`) between two checkouts on
one CUDA card.

    python -m pilosa_tpu_torch.tools.ab_k2 --a DIR --b DIR [--reps 50]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the data and the timer). It builds each side's
`pilosa_tpu_torch/csrc/count_blocks.cu` with the port's nvcc flags into a
temporary directory and calls its C entry point `count_blocks_launch` in
mode 2 (the fused entry) through ctypes. Shapes: the served f=10 & g=10
pair of chip_smoke's index b (954 shards, the auto chooser's block-sparse
form), and NB = 32768 and 131072 with half of a's ids matched, drawn as
chip_smoke's check_k2 draws them. Each side's device time per launch comes
from a torch.profiler trace (chip_smoke.device_ms, `reps` launches) in
four states of the 50 MB L2: flushed by a 128 MB write right before
every launch ("dirty"; chip_smoke's flush), the same with the device
then left idle for 0.1 ms ("dirty_idle": a served launch follows its
query's host work, and a call through the Python wrapper takes ~0.1 ms),
flushed by a 128 MB read ("clean") and warm. The sides take turns
A, B, B, A in each state.
Every result is checked against `count_and_blocks_reference` first. It
prints one JSON line per shape with every time in µs, the bytes the
launch must read and its bound at 3.35 TB/s, and the card's name and
power limit.
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


def _build(checkout, out_dir, tag, cuda_build):
    src = os.path.join(checkout, "pilosa_tpu_torch", "csrc",
                       "count_blocks.cu")
    lib = os.path.join(out_dir, f"libcount_blocks_{tag}.so")
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(lib).count_blocks_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
    return fn


def _shapes(torch, cs, containers, words):
    comp = cs.compressible_rows(words)
    f10 = containers.build(comp[("f", 10)], "cuda", mode="auto")
    g10 = containers.build(comp[("g", 10)], "cuda", mode="auto")
    shapes = {"served f=10 & g=10": (*f10.arrays, *g10.arrays)}
    rng = np.random.default_rng(cs.COMP_SEED)
    for nb in (32768, 131072):
        real = nb - nb // 4
        ids_a = cs.k2_ids(rng, real)
        a = cs.k2_sparse(torch, rng, nb, ids_a)
        ids_b = cs.k2_ids(rng, real, avoid=ids_a,
                          keep=rng.choice(ids_a, real // 2, replace=False))
        shapes[f"NB={nb} half matched"] = (
            *a, *cs.k2_sparse(torch, rng, nb, ids_b))
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. a parent)")
    ap.add_argument("--b", required=True, help="checkout B")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_k2: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from pilosa_tpu_torch.ops import containers, cuda_build
    from pilosa_tpu_torch.ops import count_blocks as k2
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    tmp = tempfile.mkdtemp(prefix="ab-k2-")
    try:
        fns = {"A": _build(args.a, tmp, "a", cuda_build),
               "B": _build(args.b, tmp, "b", cuda_build)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped
    out = torch.empty(1, dtype=torch.int64, device="cuda")

    def launch(side, ids_a, blocks_a, ids_b, blocks_b):
        err = fns[side](2, blocks_a.data_ptr(), blocks_b.data_ptr(),
                        ids_a.data_ptr(), ids_b.data_ptr(), blocks_a.shape[0],
                        blocks_b.shape[0], out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"side {side}: CUDA error {err}")
        return out[0]

    junk = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def device_us(fn, flush):
        def timed():
            if flush.startswith("dirty"):
                junk.fill_(1)
            elif flush == "clean":
                junk.view(torch.int32).sum()
            if flush == "dirty_idle":
                torch.cuda.synchronize()
                time.sleep(IDLE_S)
            fn()
        for _ in range(3):  # a trace now and then holds no device time
            ms = cs.device_ms(torch, timed, args.reps, "count_blocks_kernel")
            if ms is not None:
                return ms * 1e3
        raise RuntimeError("three profiler traces held no K2 kernel")

    card = cs.nvidia_smi("name,power.limit")
    for name, shape in _shapes(torch, cs, containers, WORDS_PER_ROW).items():
        want = int(k2.count_and_blocks_reference(*shape))
        for side in fns:
            got = int(launch(side, *shape))
            if got != want:
                raise AssertionError(f"{name}: side {side} {got} != {want}")
        nbytes, matched = cs.k2_fused_bytes(shape[0], shape[2])
        us = {side: {f: [] for f in FLUSHES} for side in fns}
        for flush in FLUSHES:
            for side in ("A", "B", "B", "A"):
                us[side][flush].append(device_us(
                    lambda: launch(side, *shape), flush))
        print(json.dumps({
            "shape": name, "matched_blocks": matched, "bytes": nbytes,
            "bound_us": nbytes / cs.H100_BYTES_PER_S * 1e6, "us": us,
            "a": args.a, "b": args.b, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
