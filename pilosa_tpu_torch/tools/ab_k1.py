"""A/B of K1 (`csrc/count_expr.cu`, all three entries) between checkouts
on one CUDA card.

    python -m pilosa_tpu_torch.tools.ab_k1 --a DIR --b DIR [--c DIR]
        [--reps 30] [--only NAME ...]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the timer and the stream yardstick, and its K1 and K3
wrappers for the plain version and the K3 yardstick). It builds each
side's `pilosa_tpu_torch/csrc/count_expr.cu` with the port's nvcc flags
into a temporary directory, prints ptxas's registers, stack frame and
spills for every kernel of each side, and calls the C entry points
(`count_expr_launch`, `count_expr_batch_launch`, `count_expr_multi_launch`)
through ctypes. The shapes are `SHAPES`: K1's 2-leaf chain at one part's
shape on a node of 1, 2, 4 and 8 cards, the nested 4-leaf tree at 954
shards, the batched entry at B = 4 x 954 shards and B = 64 x 10, and the
multi-tree entry at the served fused query's two members.

Every side's result is checked against `count_expr_reference` first.
Then each side's device time per call comes from a torch.profiler trace
of `reps` calls, L2 cold (`chip_smoke.cold_call`: a 128 MB read before
each call, each call on the next of the sets of input copies that fill
2 GiB), summed over every device operation of a call (the memset of the
totals included) and over the K1 kernel alone; the sides take turns
A, B, (C, C,) B, A. Beside them: the stream yardstick (`chip_smoke.
stream_ms`, one PyTorch read of the same bytes, timed the same way) and,
for a 2-leaf chain, K3 over `[1, S x W]` with a filter (the same
function). It prints one JSON line per shape with every time in µs, the
bytes the call must move and its bound at 3.35 TB/s, and the card's name
and power limit.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

from ..ops import count_expr as k1

#: (name, entry, leaves per member, S, members)
SHAPES = (
    ("chain S=954", "single", 2, 954, 1),
    ("chain S=477", "single", 2, 477, 1),
    ("chain S=239", "single", 2, 239, 1),
    ("chain S=120", "single", 2, 120, 1),
    ("tree S=954", "single", 4, 954, 1),
    ("batch 4 x S=954", "batch", 2, 954, 4),
    ("batch 64 x S=10", "batch", 2, 10, 64),
    ("multi served S=954", "multi", 2, 954, 2),
)

#: the nested 4-leaf tree (chip_smoke's `nested[0]`)
TREE = ("|", (("&", (("leaf", 0), ("leaf", 1))),
              ("-", (("leaf", 2), ("leaf", 3)))))


def signatures(shape):
    """Each member's tree: the chain of `&` over the leaves, the nested
    tree for 4 leaves, and the served fused query's `&` and `|` chains
    for the multi-tree entry."""
    _, entry, n, _, members = shape
    if entry == "multi":
        return [k1.chain_signature(n, "&" * (n - 1)),
                k1.chain_signature(n, "|" * (n - 1))][:members]
    sig = TREE if n == 4 else k1.chain_signature(n, "&" * (n - 1))
    return [sig] * members


def shape_bytes(shape, words):
    """Bytes one call must move: every member's leaves read once and its
    total written; the batched entry also reads its [B, n] pointer table,
    the multi-tree entry its descriptors (5 int32 a member), code bytes
    and leaf pointers."""
    _, entry, n, s, members = shape
    leaves = n * s * words * 4
    if entry == "single":
        return leaves + 8
    if entry == "batch":
        return members * (leaves + n * 8 + 8)
    code = sum(len(k1.compile_program(sig)) for sig in signatures(shape))
    return members * (leaves + 5 * 4 + n * 8 + 8) + code


class Side:
    """One checkout's K1 library and its three C entry points."""

    def __init__(self, tag, checkout, out_dir, cuda_build):
        src = os.path.join(checkout, "pilosa_tpu_torch", "csrc",
                           "count_expr.cu")
        lib = os.path.join(out_dir, f"libcount_expr_{tag}.so")
        proc = subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        self.tag = tag
        self.report = cuda_build.kernel_report(proc.stdout + proc.stderr)
        cdll = ctypes.CDLL(lib)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.single = cdll.count_expr_launch
        self.single.argtypes = [p, i, ctypes.c_char_p, i, ll, p, p]
        self.batch = cdll.count_expr_batch_launch
        self.batch.argtypes = [ctypes.c_char_p, i, p, i, i, ll, p, p]
        self.multi = cdll.count_expr_multi_launch
        self.multi.argtypes = [p, i, p, ll, p, p]
        for fn in (self.single, self.batch, self.multi):
            fn.restype = ctypes.c_int


def _launcher(torch, side, shape, sigs):
    """fn(members) -> [members] int64 totals through `side`'s entry; the
    device pointer tables of each set of copies are made once and kept
    (cold_call's sets are walked once before a trace)."""
    entry = shape[1]
    out = torch.empty(shape[4], dtype=torch.int64, device="cuda")
    tables = {}
    code = k1.compile_program(sigs[0])
    if entry == "multi":
        program = k1.MultiProgram().bind(sigs, [shape[2]] * shape[4])

    def ptr_table(members):
        key = tuple(s.data_ptr() for m in members for s in m)
        t = tables.get(key)
        if t is None:
            t = tables[key] = torch.tensor(key, dtype=torch.int64,
                                           device="cuda")
        return t

    def fn(members):
        stream = torch.cuda.current_stream().cuda_stream
        words = members[0][0].numel()
        if entry == "single":
            stacks = members[0]
            ptrs = (ctypes.c_void_p * len(stacks))(
                *[s.data_ptr() for s in stacks])
            err = side.single(ptrs, len(stacks), code, len(code), words,
                              out.data_ptr(), stream)
        elif entry == "batch":
            err = side.batch(code, len(code), ptr_table(members).data_ptr(),
                             len(members[0]), len(members), words,
                             out.data_ptr(), stream)
        else:
            err = side.multi(program.table(out.device).data_ptr(),
                             len(members), ptr_table(members).data_ptr(),
                             words, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"side {side.tag}: CUDA error {err}")
        return out

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. a parent)")
    ap.add_argument("--b", required=True, help="checkout B")
    ap.add_argument("--c", help="checkout C (a third design)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--only", nargs="*", default=(),
                    help="shape names to run (substrings of SHAPES' names)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_k1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ..ops import cuda_build
    from ..ops import row_counts as k3
    from ..shardwidth import WORDS_PER_ROW

    tags = [("A", args.a), ("B", args.b)] + ([("C", args.c)] if args.c
                                             else [])
    tmp = tempfile.mkdtemp(prefix="ab-k1-")
    sides, errors = {}, []

    def build(tag, checkout):
        try:
            sides[tag] = Side(tag, checkout, tmp, cuda_build)
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    try:
        threads = [threading.Thread(target=build, args=t) for t in tags]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped
    card = cs.nvidia_smi("name,power.limit")
    for tag, checkout in tags:
        for fn, r in sorted(sides[tag].report.items()):
            print(f"ab_k1: build {tag} ({checkout}): {fn}: "
                  f"{r.get('registers')} registers, {r.get('stack')} bytes "
                  f"stack frame, {r.get('spill_stores')} bytes spill stores, "
                  f"{r.get('spill_loads')} bytes spill loads", flush=True)
    order = [t for t, _ in tags] + [t for t, _ in reversed(tags)]
    gen = torch.Generator(device="cuda").manual_seed(22)
    for shape in SHAPES:
        name, entry, n, s, b = shape
        if args.only and not any(o in name for o in args.only):
            continue
        sigs = signatures(shape)
        pool = torch.randint(-(1 << 31), (1 << 31) - 1,
                             (b * n, s, WORDS_PER_ROW), dtype=torch.int32,
                             device="cuda", generator=gen)
        members = [[pool[q * n + i] for i in range(n)] for q in range(b)]
        want = [int(k1.count_expr_reference(sig, m))
                for sig, m in zip(sigs, members)]
        fns = {t: _launcher(torch, sides[t], shape, sigs) for t in sides}
        for t, fn in fns.items():
            got = fn(members).tolist()
            torch.cuda.synchronize()
            if got != want:
                raise AssertionError(f"{name}: side {t} {got} != {want}")
        us = {t: {"call": [], "kernel": []} for t in sides}
        for t in order:
            timed = cs.cold_call(torch, fns[t], (members,))
            for _ in range(timed.sets):
                timed()
            all_ms, kernel_ms, _ = cs.traced_call_ms(torch, timed, args.reps,
                                                     "count_")
            us[t]["call"].append(all_ms * 1e3)
            us[t]["kernel"].append(kernel_ms * 1e3)
            del timed
        nbytes = shape_bytes(shape, WORDS_PER_ROW)
        stream_us = cs.stream_ms(torch, nbytes, args.reps)[0] * 1e3
        k3_us = None
        if entry == "single" and n == 2:
            row, filt = pool[0].reshape(1, -1), pool[1].reshape(-1)
            k3_us = cs.traced_call_ms(
                torch, cs.cold_call(torch, k3.row_counts, (row, filt)),
                args.reps, "row_counts_kernel")[0] * 1e3
        del pool, members
        torch.cuda.empty_cache()
        bound_us = nbytes / cs.H100_BYTES_PER_S * 1e6
        print(json.dumps({
            "shape": name, "entry": entry, "leaves": n, "shards": s,
            "members": b, "bytes": nbytes, "bound_us": bound_us, "us": us,
            "stream_us": stream_us, "k3_us": k3_us,
            "checkouts": dict(tags), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
