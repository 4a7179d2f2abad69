"""A/B of K2 between checkouts on one CUDA card: its fused single entry
(`count_and_blocks`) and its batched entry (`count_blocks_batch`,
`count_and_blocks_batch`).

    python -m pilosa_tpu_torch.tools.ab_k2 --a DIR --b DIR [--c DIR]
        [--reps 50] [--only single|batch]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the data and the timer). The sides take turns A, B,
(C, C,) B, A.

The single entry: it builds each side's
`pilosa_tpu_torch/csrc/count_blocks.cu` with the port's nvcc flags into
a temporary directory and calls its C entry point `count_blocks_launch`
in mode 2 (the fused entry) through ctypes. Shapes: the served f=10 &
g=10 pair of chip_smoke's index b (954 shards, the auto chooser's
block-sparse form), and NB = 32768 and 131072 with half of a's ids
matched, drawn as chip_smoke's check_k2 draws them. Each side's device
time per launch comes from a torch.profiler trace (chip_smoke.device_ms,
`reps` launches) in four states of the 50 MB L2: flushed by a 128 MB
write right before every launch ("dirty"; chip_smoke's flush), the same
with the device then left idle for 0.1 ms ("dirty_idle": a served launch
follows its query's host work, and a call through the Python wrapper
takes ~0.1 ms), flushed by a 128 MB read ("clean") and warm. Every
result is checked against `count_and_blocks_reference` first. It prints
one JSON line per shape with every time in µs, the bytes the launch must
read and its bound at 3.35 TB/s, and the card's name and power limit.

The batched entry: its C signature differs between checkouts, so each
turn of a side is a process of its own (`--side DIR`) that imports that
checkout's `pilosa_tpu_torch` (built into the checkout's `_build/`) and
calls its Python wrappers, as the server does. On the served f=10, f=11
and g=10 (NB 32,768 each), both modes at B in BATCH_SIZES (B <= 4: the
pairs f=10 & g=10, f=11 & g=10, f=10 & f=11, g=10 & f=11 and the rows
f=10, f=11, g=10, f=10 in order; B = 16: the served query-batch's group,
two pairs or two rows alternating), every member a copy of its own; the
single entries on the served pair and on f=10 beside them. Every result
is checked against the plain version first. Times, L2 cold
(`chip_smoke.cold_call`: a 128 MB read before each call, each call on
the next of the sets of input copies that fill 2 GiB): device time a
call from a profiler trace of `reps` calls, per device operation (name,
µs a call, operations a call) and summed, and the kernel's alone; then
the time a call by CUDA events (warm, as chip_smoke's "by events"), and
the batched entry at B = 1 against the single entry on the same member
by CUDA events, called in alternation (medians of each and of their
difference). It prints one JSON line per (entry, B) with every turn's
numbers and the bound at 3.35 TB/s.
"""

import argparse
import ctypes
import importlib.util
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
#: batches timed: B = 1 (against the single entry), the small groups
#: that concurrent Counts form, the served query-batch's group
BATCH_SIZES = (1, 2, 4, 16)


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
    return shapes, comp


def _turns(sides):
    """A, B, B, A; or A, B, C, C, B, A."""
    names = list(sides)
    return names + names[::-1]


def _single(args, sides, torch, cs, shapes, card):
    from pilosa_tpu_torch.ops import cuda_build
    from pilosa_tpu_torch.ops import count_blocks as k2

    tmp = tempfile.mkdtemp(prefix="ab-k2-")
    try:
        fns = {side: _build(path, tmp, side.lower(), cuda_build)
               for side, path in sides.items()}
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

    for name, shape in shapes.items():
        want = int(k2.count_and_blocks_reference(*shape))
        for side in fns:
            got = int(launch(side, *shape))
            if got != want:
                raise AssertionError(f"{name}: side {side} {got} != {want}")
        nbytes, matched = cs.k2_fused_bytes(shape[0], shape[2])
        us = {side: {f: [] for f in FLUSHES} for side in fns}
        for flush in FLUSHES:
            for side in _turns(fns):
                us[side][flush].append(device_us(
                    lambda: launch(side, *shape), flush))
        print(json.dumps({
            "entry": "single fused", "shape": name,
            "matched_blocks": matched, "bytes": nbytes,
            "bound_us": nbytes / cs.H100_BYTES_PER_S * 1e6, "us": us,
            "sides": sides, "card": card}), flush=True)
    del junk, out


def _batch(args, sides, torch, comp, containers, card):
    """Each turn of each side in a process of its own (`--side`), on the
    served rows saved once to a temporary file."""
    tmp = tempfile.mkdtemp(prefix="ab-k2b-")
    try:
        data = os.path.join(tmp, "rows.pt")
        rows = {}
        for key in (("f", 10), ("f", 11), ("g", 10)):
            c = containers.build(comp[key], "cuda", mode="auto")
            if c.kind != "sparse":
                raise AssertionError(f"{key} built as {c.kind}, not sparse")
            rows[f"{key[0]}={key[1]}"] = [t.cpu() for t in c.arrays]
        torch.save(rows, data)
        del rows
        turns = {side: [] for side in sides}
        for side in _turns(sides):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side",
                 sides[side], "--data", data, "--reps", str(args.reps),
                 "--root", os.getcwd()]
                + (["--unchecked", side] if side in args.unchecked else []),
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"side {side} ({sides[side]}) failed:\n"
                                   f"{proc.stdout[-4000:]}"
                                   f"{proc.stderr[-4000:]}")
            turns[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first = next(iter(turns.values()))[0]
    print(json.dumps({"entry": "events B=1 against single",
                      "sides": sides, "card": card,
                      **{side: [r["rows"]["events B=1 against single"]
                                for r in runs]
                         for side, runs in turns.items()}}), flush=True)
    for key in first["rows"]:
        if key.startswith("events"):
            continue
        line = {"entry": key, "sides": sides, "card": card,
                "bytes": first["rows"][key]["bytes"],
                "bound_us": first["rows"][key]["bound_us"]}
        for side, runs in turns.items():
            line[side] = {f: [r["rows"][key][f] for r in runs]
                          for f in ("all_us", "kernel_us", "events_us",
                                    "ops_per_call", "ops", "exact")}
        print(json.dumps(line), flush=True)


def _load_chip_smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _paired_events(torch, fn_a, fn_b, reps):
    """Medians of µs a call by CUDA events of fn_a and fn_b called in
    alternation (after warm-up), and the median of their differences
    a pair."""
    import statistics

    def one(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3

    for _ in range(3):
        one(fn_a), one(fn_b)
    pairs = [(one(fn_a), one(fn_b)) for _ in range(reps)]
    return {"a_us": statistics.median(p[0] for p in pairs),
            "b_us": statistics.median(p[1] for p in pairs),
            "a_minus_b_us": statistics.median(p[0] - p[1] for p in pairs)}


def side_main(args):
    """One turn of one side: that checkout's wrappers on the saved rows;
    prints one JSON line."""
    sys.path.insert(0, os.path.abspath(args.side))
    import torch

    cs = _load_chip_smoke(args.root)
    from pilosa_tpu_torch.ops import count_blocks as k2

    if not k2.__file__.startswith(os.path.abspath(args.side)):
        raise RuntimeError(f"imported {k2.__file__}, not {args.side}'s")
    rows = {k: [t.cuda() for t in v]
            for k, v in torch.load(args.data).items()}
    f10, f11, g10 = rows["f=10"], rows["f=11"], rows["g=10"]
    pairs = [(*f10, *g10), (*f11, *g10), (*f10, *f11), (*g10, *f11)]
    singles = [f10[1], f11[1], g10[1], f10[1]]
    nb = f10[0].shape[0]
    out = {}

    def timed(key, fn, members, plain, nbytes, kernel):
        got, want = fn(*members), plain(*members)
        torch.cuda.synchronize()
        if got.tolist() != want.tolist() and not args.unchecked:
            raise AssertionError(f"{key}: {got.tolist()} != {want.tolist()}")
        cold = cs.cold_call(torch, fn, members)
        ops, kernel_us = cs.device_ops(torch, cold, args.reps, kernel)
        del cold
        out[key] = {
            "all_us": sum(v[0] for v in ops.values()), "kernel_us": kernel_us,
            "ops_per_call": sum(v[1] for v in ops.values()), "ops": ops,
            "events_us": cs.time_cuda(torch, lambda: fn(*members),
                                      args.reps) * 1e3,
            "bytes": nbytes, "bound_us": nbytes / cs.H100_BYTES_PER_S * 1e6,
            "exact": got.tolist() == want.tolist()}

    for b in BATCH_SIZES:
        src_p, src_r = (pairs, singles) if b <= 4 else (pairs[:2], singles[:2])
        own_p = [tuple(t.clone() for t in src_p[q % len(src_p)])
                 for q in range(b)]
        own_r = [src_r[q % len(src_r)].clone() for q in range(b)]
        # the bound's bytes: each member's single bytes and its 8-byte
        # state word (the change's declared cost), for either side
        state = 8 * b
        timed(f"batch mode 0 B={b}", k2.count_blocks_batch, (own_r,),
              k2.count_blocks_batch_reference, b * (nb * 512 + 8) + state,
              "count_blocks_batch_kernel")
        timed(f"batch fused B={b}", k2.count_and_blocks_batch, (own_p,),
              k2.count_and_blocks_batch_reference,
              sum(cs.k2_fused_bytes(p[0], p[2])[0] for p in own_p) + state,
              "fused_batch")
        del own_p, own_r
    # by events, the batched entry at B = 1 and the single entry on the
    # same member in alternation, so that both see the same host
    one = [tuple(t.clone() for t in pairs[0])]
    out["events B=1 against single"] = _paired_events(
        torch, lambda: k2.count_and_blocks_batch(one),
        lambda: k2.count_and_blocks(*one[0]), 4 * args.reps)
    timed("single fused", k2.count_and_blocks, pairs[0],
          k2.count_and_blocks_reference, cs.k2_fused_bytes(f10[0], g10[0])[0],
          "count_blocks_kernel")
    timed("single mode 0", k2.count_blocks, (f10[1],),
          k2.count_blocks_reference, nb * 512 + 8, "count_blocks_kernel")
    print(json.dumps({"side": args.side, "rows": out}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="checkout A (e.g. a parent)")
    ap.add_argument("--b", help="checkout B")
    ap.add_argument("--c", help="checkout C (optional)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", choices=("single", "batch"))
    ap.add_argument("--unchecked", action="append", default=[],
                    metavar="SIDE",
                    help="a side whose batched results are reported, not "
                    "held to the plain version (a build cut short to time "
                    "a phase)")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        return side_main(args)
    if not (args.a and args.b):
        ap.error("--a and --b are required")

    import torch

    if not torch.cuda.is_available():
        print("ab_k2: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from pilosa_tpu_torch.ops import containers
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    sides = {"A": args.a, "B": args.b}
    if args.c:
        sides["C"] = args.c
    card = cs.nvidia_smi("name,power.limit")
    shapes, comp = _shapes(torch, cs, containers, WORDS_PER_ROW)
    if args.only != "batch":
        _single(args, sides, torch, cs, shapes, card)
    del shapes
    torch.cuda.empty_cache()
    if args.only != "single":
        _batch(args, sides, torch, comp, containers, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
