"""The card's rate for K4's function, Σ popcount(a & b), in bit pairs a
second, by three routes (`csrc/k4_peak.cu`):

    python -m pilosa_tpu_torch.tools.k4_peak [--ms 20]

- ``mma_b1``: the tensor cores' ``mma.sync ... m16n8k256 ... b1.b1.s32
  .and.popc`` (32,768 bit pairs an instruction);
- ``popc``: the CUDA cores, one ``LOP3`` + ``POPC`` + ``IADD`` a word;
- ``harley_seal``: the CUDA cores, a carry-save count (15 adders of two
  ``LOP3`` each and one ``POPC`` per 16 words).

Each runs from registers at full occupancy (every SM filled with as many
256-thread blocks as it holds) with no memory traffic; its rate is the
median of 5 launches timed by CUDA events, each sized to take about
``--ms`` milliseconds, after a warm-up. It prints one JSON object with
the three rates, the fastest, and the card's name and power limit
(nvidia-smi). `K4's bound` (`cuda_build.AND_POPC_BIT_PAIRS_PER_SECOND`)
takes the fastest rate this tool measured on an H100.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

from ..ops import cuda_build

#: (name, mode of k4_peak_launch, bit pairs a thread an iteration)
ROUTES = (("mma_b1", 0, None), ("popc", 1, 8 * 8 * 32),
          ("harley_seal", 2, 4 * 16 * 32))
#: independent mma chains a warp (K4P_CHAINS in csrc/k4_peak.cu), each
#: instruction 16 x 8 x 256 bit pairs
MMA_CHAINS = 4
MMA_BIT_PAIRS = 16 * 8 * 256
THREADS = 256


def bit_pairs(mode, blocks, threads, iters):
    """Bit pairs one launch of `mode` counts."""
    if mode == 0:
        return blocks * (threads // 32) * iters * MMA_CHAINS * MMA_BIT_PAIRS
    per = dict((m, n) for _, m, n in ROUTES)[mode]
    return blocks * threads * iters * per


def _lib():
    lib = cuda_build.load("k4_peak")
    lib.k4_peak_launch.restype = ctypes.c_int
    lib.k4_peak_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.k4_peak_occupancy.restype = ctypes.c_int
    lib.k4_peak_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def rates(torch, target_ms=20.0):
    """{route: {"bit_pairs_per_s", "blocks", "iters", "ms"}} on the
    current card, and "fastest": the route with the highest rate."""
    lib = _lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream()
    out = {}
    for name, mode, _ in ROUTES:
        per_sm = lib.k4_peak_occupancy(mode, THREADS)
        if per_sm < 1:
            raise RuntimeError(f"k4_peak: no occupancy for {name}")
        blocks = sms * per_sm
        buf = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")

        def launch(iters):
            err = lib.k4_peak_launch(mode, blocks, THREADS, iters,
                                     buf.data_ptr(), stream.cuda_stream)
            if err:
                raise RuntimeError(f"k4_peak {name}: CUDA error {err}")

        def timed(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(iters)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)

        iters = 64
        timed(iters)  # warm-up (and the first launch's set-up)
        while True:  # grow the loop until a launch takes target_ms
            ms = timed(iters)
            if ms >= target_ms / 4 or iters >= 1 << 30:
                break
            iters *= 4
        iters = max(1, int(iters * target_ms / max(ms, 1e-3)))
        ms = statistics.median(timed(iters) for _ in range(5))
        out[name] = {"bit_pairs_per_s": bit_pairs(mode, blocks, THREADS,
                                                   iters) / (ms / 1e3),
                     "blocks": blocks, "iters": iters, "ms": ms}
        del buf
    out["fastest"] = max((r for r, _, _ in ROUTES),
                         key=lambda r: out[r]["bit_pairs_per_s"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", type=float, default=20.0,
                    help="milliseconds a timed launch should take")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k4_peak: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    got = rates(torch, args.ms)
    got["card"] = card
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
