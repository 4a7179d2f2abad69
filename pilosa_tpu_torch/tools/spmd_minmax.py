"""Min/Max across ranks: one all_gather against D + 2 collectives.

    python -m pilosa_tpu_torch.tools.spmd_minmax --ranks 3 --shards 318 \
        --depth 21 --device cuda

Starts `--ranks` processes (one gloo group on 127.0.0.1, every rank on
`--device`; several ranks may share one card), each holding random BSI
planes of `--shards` shards, and times two ways of a global Max and Min
over them, each `--reps` times:

- gather: the collective plane's design (cluster/spmd.py): each rank
  walks its own shards (exec.stacked.minmax_walk, its count with K3),
  fetches (non-empty, negative, magnitude, count), and ONE all_gather
  combines the ranks;
- walk: the global walk of the TPU package's `_minmax_fn`, with each
  `any()` reduced across ranks: one all_reduce of both sign branches'
  `any()`, one per plane step of the MSB-first walk, and one of the
  count — D + 2 collectives, each after a device sync.

Both answers must agree. Rank 0 prints one JSON line: each way's
median (ms) for one Min or Max, its number of collectives, the shapes,
the device and the answers.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _global_walk(dist, torch, planes, sign, exists, is_max):
    """The D + 2 collective walk: (empty, negative, magnitude, count)."""
    from ..ops.row_counts import row_counts

    pos = exists & ~sign
    neg = exists & sign
    flags = torch.stack([pos.any(), neg.any()]).to(torch.int64).cpu()
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    has_pos, has_neg = bool(flags[0]), bool(flags[1])
    if not (has_pos or has_neg):
        return True, False, 0, 0
    use_neg = not has_pos if is_max else has_neg
    filt = neg if use_neg else pos
    # the largest magnitude for a positive Max or a negative Min, else the
    # smallest (ops.bsi max_unsigned / min_unsigned)
    keep_set = is_max != use_neg
    mag = 0
    for d in range(planes.shape[0] - 1, -1, -1):
        cand = filt & planes[d] if keep_set else filt & ~planes[d]
        nz = cand.any().to(torch.int64).reshape(1).cpu()
        dist.all_reduce(nz, op=dist.ReduceOp.MAX)
        if bool(nz[0]):
            filt = cand
            mag |= (1 << d) if keep_set else 0
        elif not keep_set:
            mag |= 1 << d
    count = row_counts(filt.reshape(1, -1)).cpu()
    dist.all_reduce(count)
    return False, use_neg, mag, int(count[0])


def _gathered(dist, torch, planes, sign, exists, is_max):
    """The collective plane's way: (empty, negative, magnitude, count)."""
    from ..cluster.spmd import combine_minmax
    from ..exec.stacked import minmax_decode, minmax_walk

    nonempty, use_neg, mag, count = minmax_decode(
        minmax_walk(planes, sign, exists, None, is_max).cpu().tolist())
    row = torch.tensor([int(nonempty), int(use_neg), mag, count],
                       dtype=torch.int64)
    rows = [torch.zeros_like(row) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, row)
    return combine_minmax([r.tolist() for r in rows], is_max)


def _rank(args):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from ..device import resolve_devices

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}",
        world_size=args.ranks, rank=args.rank,
        timeout=timedelta(seconds=300))
    dev = resolve_devices(args.device, rank=args.rank)[0]
    gen = torch.Generator(device=dev).manual_seed(1000 + args.rank)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    w = 1 << 15
    planes = words(args.depth, args.shards, w)
    # a sparse value set: every column exists with p = 1/16
    exists = words(args.shards, w) & words(args.shards, w) \
        & words(args.shards, w) & words(args.shards, w)
    sign = words(args.shards, w)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for name, fn in (("gather", _gathered), ("walk", _global_walk)):
        times = []
        for i in range(args.reps + 2):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            res = [fn(dist, torch, planes, sign, exists, m)
                   for m in (True, False)]
            times.append(time.perf_counter() - t0)
            out.setdefault(name + "_answers", res)
        out[name + "_ms"] = 1e3 * statistics.median(times[2:]) / 2
    if out["gather_answers"] != out["walk_answers"]:
        raise AssertionError(f"the two ways disagree: {out}")
    if args.rank == 0:
        print(json.dumps({
            "ranks": args.ranks, "shards_per_rank": args.shards,
            "depth": args.depth, "device": str(dev),
            "gather_ms": out["gather_ms"], "walk_ms": out["walk_ms"],
            "collectives": {"gather": 1, "walk": args.depth + 2},
            "answers": out["gather_answers"]}), flush=True)
    dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(prog="spmd_minmax",
                                description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=3)
    p.add_argument("--shards", type=int, default=318,
                   help="shards per rank")
    p.add_argument("--depth", type=int, default=21)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank(args)
        return 0
    from .cluster import free_ports

    port = free_ports(1)[0]
    base = [sys.executable, "-m", "pilosa_tpu_torch.tools.spmd_minmax",
            "--ranks", str(args.ranks), "--shards", str(args.shards),
            "--depth", str(args.depth), "--device", args.device,
            "--reps", str(args.reps), "--port", str(port)]
    procs = [subprocess.Popen(base + ["--rank", str(r)],
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for r in range(args.ranks)]
    codes = [proc.wait(timeout=900) for proc in procs]
    return 0 if codes == [0] * len(codes) else 1


if __name__ == "__main__":
    sys.exit(main())
