#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device: the card's name, power limit and top SM clock (nvidia-smi);
2. build: every kernel of the served paths (K1 count_expr and its
   batched entry, K2 count_blocks, K3 row_counts, K4 pairwise_counts, K5
   bsi_range), one nvcc per source, all started together, from the
   checkout; registers and spills from ptxas;
3. kernels: each kernel against its plain PyTorch version on the card —
   exact equality on every case:
   - K1 at S in {0, 1, 7, 954}, 1 to 6 leaves, every op and nested trees;
   - K3 at R in {0, 1, 5, 102} x S in {1, 10}, and R = 1 at S = 954, with
     and without a filter, edge words planted, plus a tie case for the
     top-k;
   - K4 at (R1, R2) in {(0, 3), (1, 1), (5, 4), (13, 130), (102, 102)} x
     S in {1, 10}, and at every (R1, R2) in 1..8 x 1..8 at S = 10 (the
     small kernel's exact shapes), with and without a filter;
   - K5 at every (op, allow_eq, neg_pred) of tests/test_pallas.py x depth
     in {1, 21, 64} x S in {0, 1, 7, 128}, random sign and exists,
     predicates 0, 2^D - 1 and random, edge words and columns equal to
     the predicate planted;
   - K2's two entries, `count_blocks` and the fused `count_and_blocks`
     (the counterpart of `count_and_blocks_stack`), at NB in {0, 1, 7, 8,
     33, 32768, 131072}, with sentinel padding, edge words planted, and
     for the fused entry match fractions 0, 1/2 and 1 at NB_b = NB/2, NB
     and 2 NB, identical id arrays, and the tile-wise intersection's edge
     cases (b 16x denser than a, a above or below all of b, a ragged last
     tile, a or b all padding, NB_a = 1);
   - K1's batched entry (`count_expr_batch`) at B in {1, 2, 3, 4, 5, 17,
     32, 64} at S = 10, chain, tree and 17-leaf programs, members that
     share leaves and members that do not, and S = 0 (no launch);
   and times per launch beside each bound and the plain version's time:
   K1 at S = 954 with two leaves; K3 at the served TopN shape
   [100, 10 x 32768], at [1, 954 x 32768] with a filter and at Sum's
   [21, 128 x 32768] with a filter; K4 at the served GroupBy tile
   5 x 4 x S = 10 with and without a filter, at a 1B-column GroupBy's
   1 x 1 x S = 954 and at 102 x 102 x S = 10, each with L2 flushed and
   warm, summed over every device operation of a call (memset included)
   beside the kernel alone, with bytes, bound and share;
   K5 at [21, 128 x 32768] and [21, 954 x 32768]; K2's entries at
   NB = 32768 and 131072 (L2 flushed; the fused one also warm); K1's
   batched entry at B = 4 x 2 leaves x S = 954 beside four single K1
   launches on the same members, and at B = 64 x 2 leaves x S = 10, over
   every device operation of a call (memset and pointer-table copy
   included);
4. data, in one data directory, written through the port's Holder:
   - index tg, BASELINE config 3 at bench_suite.bench_topn_groupby's
     chip shape (10 shards; field f with 100 rows of 100000/(r+1)+100
     random columns; fields a (5 rows) x b (4 rows) over 300,000 distinct
     columns; seed 7);
   - index br, BASELINE config 4 drawn as bench_suite.bench_bsi_range_sum
     draws it (int field v, min 0, max 2^20: depth 21; time field t,
     quantum YMD; seed 11), at 128 shards with 100,000 valued columns per
     shard, each with a t row 0 bit on 2019-01-15, 02-15 or 03-15;
   - index b, the 1B-column index of bench_suite.measure_served_1b (954
     shards of 2^20 columns, fields f and g, rows 1 and 2, word density
     0.05, seed 3), plus compressible rows drawn the way
     bench_suite.bench_compression draws its corpus (seed 5): f=10, f=11
     and g=10 with 24 random 128-word blocks per shard, each word random
     (g=10 shares 12 of f=10's blocks in every shard), and f=20 and g=20
     with two runs of 2^20 // 200 bits per shard (g=20's start half a
     run later);
5. serve: one HTTP server on that directory (--device cuda, an ephemeral
   port) answers, each checked against numpy:
   - Count path: /status, the four Count(Intersect(Row, Row)) queries, a
     nested Count, a Count(Xor), and a Set whose next Count reads the
     write back; then, over index tg, Counts past K1's limits: a 17-leaf
     and a 33-leaf Union (a 65-step program) and a right-nested depth-9
     Intersect/Union tree; K1's counter must advance by exactly 1 on
     every Count;
   - batched paths: one POST /index/b/query-batch of 64 Counts (the four
     Intersect pairs and four single rows, 8 times each: two groups of
     32, two launches of K1's batched entry and no single K1 launch);
     200 warm Counts from 1 client thread and the same 200 from 8
     (GroupCommit), with QPS, p50, p99 and the batching factor; then a
     second server with --coalesce-window 1ms over a copy of index tg
     alone answers 8 threads x 25 Counts and Rows as the first server
     does, with /debug/batching showing 200 coalesced queries and a
     batch of two or more;
   - TopN/GroupBy path: three TopN, Rows, three GroupBy, and a Set whose
     next TopN reads the write back through a patched row chunk; K3's
     counter must advance on every TopN and K4's on every two-field
     GroupBy;
   - BSI path (config 4): the bench's eight Count(Row(v > t)), the
     Jan+Feb Sum, Min and Max, Count(Row(v == x)), Count(Row(v != x)),
     Count(Row(v >< [lo, hi])) and a condition intersected with a time
     range; then an import of 1,000 values and a Set whose next Sum and
     Count read them back through an in-place patch of the BSI stack;
     K5, K1 and K3 must move by exactly what each query launches;
   - observability (serve_observe, after the BSI path; the server runs
     with --watchdog-deadline 60s): per path, the Count of
     Intersect(Row(f=2), Row(g=2)) over index b (K1), config 3's
     TopN(f, n=10) (K3) and config 4's Jan+Feb Sum (K3), 20 ?profile=true
     warm queries give the host split (medians of client wall, the
     server's http_request_seconds, the profile's root span,
     executor.Execute, lock wait, each dispatch phase, kernel wall) and
     one torch.profiler trace of 10 warm queries the card's busy share
     and its longest operations; then /metrics must carry
     device_memory_bytes{device="cuda:0"} > 0, /debug/dispatch's count
     family must have grown by exactly the phase's K1 launches, the
     flight recorder must hold dispatch.start/end pairs and the watchdog
     must not have tripped;
   - compressed path (the auto chooser over index b): Counts over the
     sparse rows (K2), the run-length rows (torch sums), a union and a
     dense-with-sparse intersection (densify + K1), each launch delta
     exact; the pool's forms and resident bytes; cold and warm p50s of
     the K2 pair and the rle pair; a Set that decays a sparse leaf to
     dense through a patch; then K2 timed on the served containers and
     a cold leaf build split into upload, the chooser's `analyze` on the
     card (its counts checked against numpy) and the host builder, for
     a dense, a sparse and a run-length leaf;
   - command-line tools and durable imports (serve_tools): a second
     server, `python -m pilosa_tpu_torch server --device cuda --config
     <toml>` (max-op-n 10000, [storage] fsync "always") as a child
     process over a fresh data directory, takes a CSV `import` of
     1,000,000 (row, column) records (rows 1-4, columns over all 954
     shards, seed 3) and 100,000 int values; a fault point armed over
     POST /debug/faultpoints kills it at import.post-append (rc 86), and
     its restart replays the one record; Counts and a Sum there against
     numpy; `backup` of index b from the first server and `restore` of
     its field f into the child (the cut: on an H100's host the whole
     index's restore takes 44-50 s), three Counts equal to the first server's and numpy's;
     `backup` of the imported index from the child and `restore` into
     the first server, three Counts each one K1 launch there; `export`
     against the CSV; then, the child stopped, `check` on every fragment
     file of its directory and `inspect` on one; walls, records/s, tar
     bytes and fragments/s;
   each path runs with every launch counter set to 0 just before it and
   read just after; cold latency of each first query and warm HTTP p50s.

The line before the last is a JSON object with a `kernels` list; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
# POPC results per SM per clock, compute capability 9.0 (CUDA C
# Programming Guide, arithmetic-instruction throughput table)
POPC_PER_SM_PER_CLOCK = 16
N_SHARDS = 954
DENSITY = 0.05
SEED = 3
TG_SHARDS = 10
TG_SEED = 7
BR_SHARDS = 128
BR_SEED = 11
BR_VALUES_PER_SHARD = 100_000
BR_DATES = ("2019-01-15T00:00", "2019-02-15T00:00", "2019-03-15T00:00")
BR_JAN_FEB = 'from="2019-01-01T00:00", to="2019-03-01T00:00"'
KERNELS = ("count_expr", "row_counts", "pairwise_counts", "bsi_range",
           "count_blocks")
# the kernels line's entries: one per source, and K1's batched entry,
# which lives in count_expr.cu
ENTRIES = KERNELS + ("count_expr_batch",)
COMP_SEED = 5
SPARSE_BLOCKS = 24  # non-empty 128-word blocks per shard of f=10, f=11, g=10
SHARED_BLOCKS = 12  # of them shared by f=10 and g=10 in every shard
RUN_BITS = (1 << 20) // 200  # bits per run of f=20 and g=20, two per shard
TOOLS_RECORDS = 1_000_000  # (row, column) records of the CLI import
TOOLS_VALUES = 100_000  # int values of the CLI import
ROOT = os.path.dirname(os.path.abspath(__file__))
K2_NBS = (0, 1, 7, 8, 33, 32768, 131072)
K2_ID_SPACE = 1 << 21  # block ids drawn below the sentinel 2^30
# (op, allow_eq) of tests/test_pallas.py's BSI range cases
K5_CASES = (("eq", False), ("lt", False), ("lt", True), ("gt", False),
            ("gt", True))


def log(msg):
    print(msg, flush=True)


_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)],
                  dtype=np.uint8)


def popcount(words):
    return int(_POP16[np.ascontiguousarray(
        words, dtype=np.uint32).view(np.uint16)].sum(dtype=np.int64))


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(torch, fn, reps):
    """Median milliseconds per call over `reps` calls, each between its
    own pair of CUDA events (after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _trace(torch, fn, reps):
    """key_averages of a torch.profiler (CUPTI) trace of `reps` calls
    after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(torch, fn, reps, kernel):
    """Mean device milliseconds per call spent in CUDA kernels whose name
    contains `kernel`, from a torch.profiler (CUPTI) trace of `reps`
    calls after one warm-up; None when the trace holds no such kernel.
    Unlike events around one call, this leaves out the wrapper's host
    time before the launch, which is larger than a small kernel."""
    total_us = 0.0
    n = 0
    for e in _trace(torch, fn, reps):
        if kernel in e.key:
            total_us += getattr(e, "device_time_total", 0.0) \
                or getattr(e, "cuda_time_total", 0.0)
            n += e.count
    return total_us / reps / 1e3 if n else None


# the L2 flushes' own kernels (a write: junk.fill_; a read: a reduction)
FLUSH_KERNELS = ("FillFunctor", "reduce_kernel")


def call_device_ms(torch, fn, reps, kernel, skip=FLUSH_KERNELS):
    """(all_ms, kernel_ms, names): mean device milliseconds per call
    summed over every device operation of the trace (kernels, memsets,
    copies) but those whose name holds a `skip` term, the same over
    kernels whose name holds `kernel` alone, and the names summed in
    all_ms; None when the trace holds no such kernel."""
    from torch.autograd import DeviceType

    total_us = kernel_us = 0.0
    n = 0
    names = []
    for e in _trace(torch, fn, reps):
        if e.device_type != DeviceType.CUDA or any(k in e.key for k in skip):
            continue
        us = getattr(e, "device_time_total", 0.0) \
            or getattr(e, "cuda_time_total", 0.0)
        total_us += us
        names.append(e.key)
        if kernel in e.key:
            kernel_us += us
            n += e.count
    if not n:
        return None
    return total_us / reps / 1e3, kernel_us / reps / 1e3, names


L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2


def kernel_ms(torch, fn, reps, kernel, cold_l2=False):
    """(ms, call_ms, source): the kernel's device time per launch from
    the profiler (asked twice), or — where the trace shows no device
    time — the CUDA event time per call; call_ms is always the event
    time per call. With cold_l2, every profiled call first writes
    L2_FLUSH_BYTES, so inputs that fit in L2 are read from HBM as a
    query that finds them cold would read them (the flush's own kernel
    is not counted)."""
    call_ms = time_cuda(torch, fn, reps)
    timed = fn
    if cold_l2:
        junk = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

        def timed():
            junk.fill_(1)
            fn()
    ms = device_ms(torch, timed, reps, kernel)
    if ms is None:
        ms = device_ms(torch, timed, reps, kernel)
    if ms is None:
        return call_ms, call_ms, "events"
    return ms, call_ms, "profiler" + (", L2 flushed" if cold_l2 else "")


def build_kernels(cuda_build):
    """One nvcc per kernel source, all started together; then load."""
    errors = []

    def one(name):
        try:
            cuda_build.build(name)
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(n,)) for n in KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name in KERNELS:
        cuda_build.load(name)
        info = cuda_build.build_info[name]
        log(f"build: {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")


def _edge_rows(rng, r, t):
    x = rng.integers(0, 1 << 32, (r, t), dtype=np.uint32)
    if r:
        x[:, 0] = 0xFFFFFFFF
        x[:, 1] = 0x80000000
        x[r // 2, 2:6] = [0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF]
        x[r // 2, 6:4000] = 0
    return x


def check_k1(torch, k1, words):
    """K1 against the plain version on the card; returns (max_abs_err,
    timing dict at S = 954, two leaves)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    chains = ["&", "|", "^", "-", "&|", "|-^", "^-&|", "-&^|&"]
    nested = [
        ("|", (("&", (("leaf", 0), ("leaf", 1))),
               ("-", (("leaf", 2), ("leaf", 3))))),
        ("^", (("leaf", 5), ("|", (("leaf", 1), ("&", (("leaf", 2),
                                                       ("leaf", 4))))))),
    ]
    max_err = 0
    n_cases = 0
    timing = None
    for s in (0, 1, 7, N_SHARDS):
        host = rng.integers(0, 1 << 32, (6, s, words), dtype=np.uint32)
        if s:
            host[:, :, 0] = 0xFFFFFFFF
            host[:, :, 1] = 0x80000000
            host[:, s // 2, 2:6] = [0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF]
        stacks = [torch.from_numpy(host[i].view(np.int32)).to(dev)
                  for i in range(6)]
        del host
        sigs = [("leaf", 0)] + [k1.chain_signature(len(c) + 1, c)
                                for c in chains] + nested
        for sig in sigs:
            got = k1.count_expr(sig, stacks)
            torch.cuda.synchronize()
            want = k1.count_expr_reference(sig, stacks)
            err = abs(int(got) - int(want))
            max_err = max(max_err, err)
            n_cases += 1
            if err:
                raise AssertionError(
                    f"K1 != plain at S={s} sig={sig}: {int(got)} vs "
                    f"{int(want)}")
        if s == N_SHARDS:
            sig = k1.chain_signature(2, "&")
            pair = stacks[:2]
            ms, call_ms, how = kernel_ms(
                torch, lambda: k1.count_expr(sig, pair), 50,
                "count_chain_kernel")
            plain_ms = time_cuda(
                torch, lambda: k1.count_expr_reference(sig, pair), 10)
            nbytes = sum(t.numel() * 4 for t in pair) + 8
            timing = {"ms": ms, "call_ms": call_ms, "how": how,
                      "plain_ms": plain_ms, "bytes": nbytes,
                      "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                      "bound_by": "bytes"}
            tree_ms, tree_call, how = kernel_ms(
                torch, lambda: k1.count_expr(nested[0], stacks), 20,
                "count_tree_kernel")
            tree_bytes = 4 * stacks[0].numel() * 4 + 8
            log(f"kernels: K1 nested 4-leaf tree at S={s}: "
                f"{tree_ms * 1e3:.2f} us/launch ({how}; "
                f"{tree_call * 1e3:.2f} us per call by events), bound "
                f"{tree_bytes / H100_BYTES_PER_S * 1e6:.2f} us")
        del stacks
        torch.cuda.empty_cache()
    log(f"kernels: K1 == plain on {n_cases} cases "
        f"(S in 0,1,7,{N_SHARDS}; 1-6 leaves; nested trees)")
    return max_err, timing


K1B_SIZES = (1, 2, 3, 4, 5, 17, 32, 64)


def traced_call_ms(torch, fn, reps, kernel):
    """(all_ms, kernel_ms, names) of one call of `fn` from a profiler
    trace: every device operation it issues (memsets and copies
    included) and the kernels named `kernel` alone."""
    for _ in range(3):  # a trace now and then holds no device time
        got = call_device_ms(torch, fn, reps, kernel)
        if got is not None:
            return got
    raise RuntimeError(f"three profiler traces held no {kernel}")


def check_k1_batch(torch, k1, words, card):
    """K1's batched entry against its plain version on the card: B in
    K1B_SIZES at S = 10, chain and tree programs (and one past K1's
    limits), members that share leaves and members that do not, and
    S = 0; then timed at B = 4 x 2 leaves x S = N_SHARDS beside four
    single K1 launches on the same inputs, and at B = 64 x 2 leaves x
    S = 10. Returns (max_abs_err, timing dict at B = 4, S = N_SHARDS)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    sigs = [k1.chain_signature(2, "&"), k1.chain_signature(4, "|-^"),
            ("|", (("&", (("leaf", 0), ("leaf", 1))),
                   ("-", (("leaf", 2), ("leaf", 3))))),
            ("leaf", 0), ("|", tuple(("leaf", i) for i in range(17)))]
    pool_host = _edge_rows(rng, 96 * TG_SHARDS, words).reshape(
        96, TG_SHARDS, words)
    pool = [torch.from_numpy(pool_host[i].view(np.int32)).to(dev)
            for i in range(96)]
    del pool_host
    max_err = 0
    n_cases = 0
    for sig in sigs:
        n = max(k1._leaf_slots(sig, {})) + 1
        for b in K1B_SIZES:
            for shared in (False, True):
                if shared:
                    members = [[pool[(q + i) % (n + b)] for i in range(n)]
                               for q in range(b)]
                else:
                    members = [[pool[(q * n + i) % len(pool)]
                                for i in range(n)] for q in range(b)]
                before = k1.count_expr_batch.launches
                got = k1.count_expr_batch(sig, members)
                torch.cuda.synchronize()
                want = k1.count_expr_batch_reference(sig, members)
                if k1.count_expr_batch.launches != before + 1:
                    raise AssertionError(f"batched K1 launches wrong at B={b}")
                err = int((got - want).abs().max())
                max_err = max(max_err, err)
                n_cases += 1
                if err or got.shape != (b,):
                    raise AssertionError(
                        f"batched K1 != plain at B={b} sig={sig} "
                        f"shared={shared}: {got.tolist()} vs {want.tolist()}")
    empty = torch.zeros((0, words), dtype=torch.int32, device=dev)
    before = k1.count_expr_batch.launches
    got = k1.count_expr_batch(sigs[0], [[empty, empty]] * 4)
    if got.tolist() != [0] * 4 or k1.count_expr_batch.launches != before:
        raise AssertionError("batched K1 at S = 0 launched or was not 0")
    n_cases += 1
    log(f"kernels: batched K1 == plain on {n_cases} cases (B in "
        f"{list(K1B_SIZES)} at S={TG_SHARDS}; chain, tree and 17-leaf "
        f"programs; shared and own leaves; S = 0 without a launch)")

    sig = k1.chain_signature(2, "&")
    timing = None
    for b, s, reps in ((4, N_SHARDS, 20), (64, TG_SHARDS, 20)):
        host = rng.integers(0, 1 << 32, (2 * b, s, words), dtype=np.uint32)
        leaves = [torch.from_numpy(host[i].view(np.int32)).to(dev)
                  for i in range(2 * b)]
        del host
        members = [leaves[2 * q:2 * q + 2] for q in range(b)]
        nbytes = 2 * b * s * words * 4 + 2 * b * 8 + b * 8
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        batch = lambda: k1.count_expr_batch(sig, members)  # noqa: E731
        all_ms, kernel_only, names = traced_call_ms(torch, batch, reps,
                                                    "_batch_kernel")
        singles = lambda: [k1.count_expr(sig, m)  # noqa: E731
                           for m in members]
        single_all = traced_call_ms(torch, singles, reps,
                                    "count_chain_kernel")
        call_ms = time_cuda(torch, batch, reps)
        plain_ms = time_cuda(
            torch, lambda: k1.count_expr_batch_reference(sig, members), 3)
        log(f"kernels: batched K1 at B={b} x 2 leaves x S={s} ({nbytes} "
            f"bytes): {all_ms * 1e3:.2f} us device per call over "
            f"{sorted(set(names))} ({kernel_only * 1e3:.2f} us in the "
            f"kernel; {bound_ms / all_ms:.0%} of the bound), "
            f"{call_ms * 1e3:.2f} us per call by events; {b} single K1 "
            f"launches on the same members: "
            f"{single_all[0] * 1e3:.2f} us device; bound "
            f"{bound_ms * 1e3:.2f} us at 3.35 TB/s; plain "
            f"{plain_ms * 1e3:.2f} us; card {card}")
        if timing is None:
            timing = {"ms": all_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
        del leaves, members
        torch.cuda.empty_cache()
    return max_err, timing


def check_k3(torch, k3, words):
    """K3 against the plain version on the card; returns (max_abs_err,
    timing dict at the served TopN shape)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    max_err = 0
    n_cases = 0
    cases = [(r, s) for r in (0, 1, 5, 102) for s in (1, 10)]
    cases.append((1, N_SHARDS))
    for r, s in cases:
        t = s * words
        rows = torch.from_numpy(_edge_rows(rng, r, t).view(np.int32)).to(dev)
        filt = torch.from_numpy(_edge_rows(rng, 1, t)[0].view(np.int32)).to(dev)
        for f in (None, filt):
            before = k3.row_counts.launches
            got = k3.row_counts(rows, f)
            torch.cuda.synchronize()
            want = k3.row_counts_reference(rows, f)
            if k3.row_counts.launches != before + (1 if r else 0):
                raise AssertionError(f"K3 launches wrong at R={r} S={s}")
            err = int((got - want).abs().max()) if r else 0
            max_err = max(max_err, err)
            n_cases += 1
            if err or got.shape != want.shape:
                raise AssertionError(f"K3 != plain at R={r} S={s} "
                                     f"filter={f is not None}")
        del rows, filt
    # ties: duplicated rows must list in ascending index order
    base = torch.from_numpy(_edge_rows(rng, 2, words).view(np.int32)).to(dev)
    rows = base[torch.tensor([1, 0, 1, 1, 0, 0, 1], device=dev)].contiguous()
    filt = torch.from_numpy(_edge_rows(rng, 1, words)[0].view(np.int32)).to(dev)
    vals, idx = k3.topn_counts_stack(rows, filt, 7)
    want = k3.row_counts_reference(rows, filt).tolist()
    order = sorted(range(7), key=lambda i: (-want[i], i))
    if idx.tolist() != order or vals.tolist() != [want[i] for i in order]:
        raise AssertionError(f"K3 top-k tie order: {idx.tolist()} vs {order}")
    n_cases += 1
    log(f"kernels: K3 == plain on {n_cases} cases (R in 0,1,5,102 x S in "
        f"1,10 and R=1 at S={N_SHARDS}, with and without a filter; ties)")

    served = torch.from_numpy(
        _edge_rows(rng, 100, TG_SHARDS * words).view(np.int32)).to(dev)
    ms, call_ms, how = kernel_ms(
        torch, lambda: k3.row_counts(served), 50, "row_counts_kernel")
    plain_ms = time_cuda(torch, lambda: k3.row_counts_reference(served), 10)
    nbytes = served.numel() * 4 + 100 * 8
    timing = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
              "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    log(f"kernels: K3 at the served TopN shape [100, {TG_SHARDS}x{words}] "
        f"({nbytes} bytes): {ms * 1e3:.2f} us/launch ({how}; "
        f"{call_ms * 1e3:.2f} us per call by events), bound "
        f"{timing['bound_ms'] * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us")
    del served
    big = torch.from_numpy(
        _edge_rows(rng, 1, N_SHARDS * words).view(np.int32)).to(dev)
    bfilt = torch.from_numpy(
        _edge_rows(rng, 1, N_SHARDS * words)[0].view(np.int32)).to(dev)
    big_ms, big_call, how = kernel_ms(
        torch, lambda: k3.row_counts(big, bfilt), 50, "row_counts_kernel")
    big_plain = time_cuda(
        torch, lambda: k3.row_counts_reference(big, bfilt), 10)
    big_bytes = (big.numel() + bfilt.numel()) * 4 + 8
    log(f"kernels: K3 at [1, {N_SHARDS}x{words}] with a filter "
        f"({big_bytes} bytes): {big_ms * 1e3:.2f} us/launch ({how}; "
        f"{big_call * 1e3:.2f} us per call by events), bound "
        f"{big_bytes / H100_BYTES_PER_S * 1e6:.2f} us, plain "
        f"{big_plain * 1e3:.2f} us")
    del big, bfilt
    torch.cuda.empty_cache()
    return max_err, timing


def k4_bound(r1, r2, t, sms, clock_hz, has_filt=False):
    """(bound_ms, bound_by, bytes_ms, popc_ms) of one K4 launch: bytes
    in (the filter's too) and out over HBM, or R1·R2·T POPC at the SMs'
    issue rate, whichever is larger."""
    nbytes = (r1 + r2 + has_filt) * t * 4 + r1 * r2 * 8
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    popc_ms = r1 * r2 * t / (sms * POPC_PER_SM_PER_CLOCK * clock_hz) * 1e3
    if popc_ms > bytes_ms:
        return popc_ms, "operations", bytes_ms, popc_ms
    return bytes_ms, "bytes", bytes_ms, popc_ms


def k4_call_ms(torch, fn, reps, cold_l2):
    """(all_ms, kernel_ms) of one K4 call from a profiler trace: every
    device operation the call issues (a memset included), and the K4
    kernel alone; with cold_l2 each call first writes L2_FLUSH_BYTES
    (the flush is not counted)."""
    timed = fn
    if cold_l2:
        junk = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

        def timed():
            junk.fill_(1)
            fn()
    for _ in range(3):  # a trace now and then holds no device time
        got = call_device_ms(torch, timed, reps, "pairwise_")
        if got is not None:
            return got[:2]
    raise RuntimeError("three profiler traces held no K4 kernel")


# K4's timed shapes: (R1, R2, S, filter, profiled calls, plain calls);
# the served GroupBy tile first, a 1B-column GroupBy's 1 x 1 tile, and
# the tiled kernel at a full tile
K4_TIMED = ((5, 4, TG_SHARDS, False, 50, 10), (5, 4, TG_SHARDS, True, 50, 10),
            (1, 1, N_SHARDS, False, 20, 3), (102, 102, TG_SHARDS, False, 20, 3))


def check_k4(torch, k4, words, sms, clock_hz, card):
    """K4 against the plain version on the card; returns (max_abs_err,
    timing dict at the served GroupBy shape, L2 flushed)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    max_err = 0
    n_cases = 0
    cases = [(r1, r2, s) for r1, r2 in ((0, 3), (1, 1), (5, 4), (13, 130),
                                        (102, 102)) for s in (1, 10)]
    cases += [(r1, r2, TG_SHARDS) for r1 in range(1, 9) for r2 in range(1, 9)]
    for r1, r2, s in cases:
        t = s * words
        a = torch.from_numpy(_edge_rows(rng, r1, t).view(np.int32)).to(dev)
        b = torch.from_numpy(_edge_rows(rng, r2, t).view(np.int32)).to(dev)
        filt = torch.from_numpy(
            _edge_rows(rng, 1, t)[0].view(np.int32)).to(dev)
        for f in (None, filt):
            before = k4.pairwise_counts.launches
            got = k4.pairwise_counts(a, b, f)
            torch.cuda.synchronize()
            want = k4.pairwise_counts_reference(a, b, f)
            if k4.pairwise_counts.launches != \
                    before + (1 if r1 and r2 else 0):
                raise AssertionError(f"K4 launches wrong at {r1}x{r2}")
            err = int((got - want).abs().max()) if r1 and r2 else 0
            max_err = max(max_err, err)
            n_cases += 1
            if err or got.shape != want.shape:
                raise AssertionError(
                    f"K4 != plain at {r1}x{r2} S={s} "
                    f"filter={f is not None}")
        del a, b, filt
    log(f"kernels: K4 == plain on {n_cases} cases ((R1,R2) in (0,3),(1,1),"
        f"(5,4),(13,130),(102,102) x S in 1,10, and every (R1,R2) in "
        f"1..8 x 1..8 at S={TG_SHARDS}, with and without a filter)")

    timing = None
    for r1, r2, s, has_filt, reps, plain_reps in K4_TIMED:
        t = s * words
        a = torch.from_numpy(_edge_rows(rng, r1, t).view(np.int32)).to(dev)
        b = torch.from_numpy(_edge_rows(rng, r2, t).view(np.int32)).to(dev)
        f = torch.from_numpy(_edge_rows(rng, 1, t)[0].view(np.int32)).to(
            dev) if has_filt else None
        call = lambda: k4.pairwise_counts(a, b, f)  # noqa: E731
        call_ms = time_cuda(torch, call, reps)
        flushed, flushed_kernel = k4_call_ms(torch, call, reps, True)
        warm, warm_kernel = k4_call_ms(torch, call, reps, False)
        plain_ms = time_cuda(
            torch, lambda: k4.pairwise_counts_reference(a, b, f), plain_reps)
        bound_ms, bound_by, bytes_ms, popc_ms = k4_bound(
            r1, r2, t, sms, clock_hz, has_filt)
        nbytes = bytes_ms / 1e3 * H100_BYTES_PER_S
        log(f"kernels: K4 at {r1}x{r2} x S={s}"
            f"{' with a filter' if has_filt else ''} ({nbytes:.0f} bytes): "
            f"{flushed * 1e3:.2f} us device per call with L2 flushed "
            f"({flushed_kernel * 1e3:.2f} us in the kernel; "
            f"{bound_ms / flushed:.0%} of the bound), {warm * 1e3:.2f} us "
            f"warm ({warm_kernel * 1e3:.2f} us in the kernel; "
            f"{bound_ms / warm:.0%}), {call_ms * 1e3:.2f} us per call by "
            f"events; bound {bound_ms * 1e3:.2f} us by {bound_by} (bytes "
            f"{bytes_ms * 1e3:.2f} us at 3.35 TB/s, POPC "
            f"{popc_ms * 1e3:.2f} us at {sms} SMs x "
            f"{POPC_PER_SM_PER_CLOCK}/clock x {clock_hz / 1e9:.3f} GHz); "
            f"plain {plain_ms * 1e3:.2f} us; card {card}")
        if timing is None:
            timing = {"ms": flushed, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        del a, b, f
    torch.cuda.empty_cache()
    return max_err, timing


def bsi_stack_on_card(torch, depth, s, words, seed):
    """A [D+2, S, W] int32 stack laid out as the BSI stack is (row 0
    exists, row 1 sign, rows 2.. magnitude planes), drawn on the card
    from `seed`, with the edge words planted in every row."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randint(-2**31, 2**31, (depth + 2, s, words),
                      dtype=torch.int32, device="cuda", generator=gen)
    if s:
        x[:, :, 0] = -1
        x[:, :, 1] = -2**31
    return x


def plant_predicate(stack, pred):
    """Make words 8..39 of every shard hold existing columns whose
    magnitude is `pred`, so the eq branch meets real matches."""
    if stack.shape[1] == 0:
        return
    stack[0, :, 8:40] = -1
    for d in range(stack.shape[0] - 2):
        stack[2 + d, :, 8:40] = -1 if (pred >> d) & 1 else 0


def mask_err(got, want):
    """Largest |got - want| over the masks' words read as uint32."""
    if got.numel() == 0:
        return 0
    diff = (got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)
    return int(diff.abs().max())


def check_k5(torch, k5, k3, words, card):
    """K5 against the plain version on the card; returns (max_abs_err,
    timing dict at the served shape [21, 128 x 32768])."""
    rng = np.random.default_rng(BR_SEED)
    max_err = 0
    n_cases = 0
    for depth in (1, 21, 64):
        for s in (0, 1, 7, BR_SHARDS):
            stack = bsi_stack_on_card(torch, depth, s, words,
                                      seed=depth * 1000 + s)
            planes, sign, exists = stack[2:], stack[1], stack[0]
            top = (1 << depth) - 1
            rand = int.from_bytes(rng.bytes(8), "little") & top
            for pred in (0, top, rand):
                plant_predicate(stack, pred)
                pbits = [(pred >> d) & 1 for d in range(depth)]
                for op, allow_eq in K5_CASES:
                    for neg in (False, True):
                        before = k5.bsi_range_mask.launches
                        got = k5.bsi_range_mask(op, planes, sign, exists,
                                                pbits, neg, allow_eq)
                        torch.cuda.synchronize()
                        want = k5.bsi_range_mask_reference(
                            op, planes, sign, exists, pbits, neg, allow_eq)
                        if k5.bsi_range_mask.launches != \
                                before + (1 if s else 0):
                            raise AssertionError(
                                f"K5 launches wrong at D={depth} S={s}")
                        err = mask_err(got, want)
                        max_err = max(max_err, err)
                        n_cases += 1
                        if err or got.shape != want.shape:
                            raise AssertionError(
                                f"K5 != plain: {op} allow_eq={allow_eq} "
                                f"neg={neg} D={depth} S={s} pred={pred}")
            del stack, planes, sign, exists
        torch.cuda.empty_cache()
    log(f"kernels: K5 == plain on {n_cases} cases ((op, allow_eq) x neg "
        f"x D in 1,21,64 x S in 0,1,7,{BR_SHARDS} x predicates 0, "
        f"2^D-1, random)")

    timing = None
    depth = 21
    for s, reps, plain_reps in ((BR_SHARDS, 50, 5), (N_SHARDS, 20, 3)):
        stack = bsi_stack_on_card(torch, depth, s, words, seed=s)
        pred = int(rng.integers(0, 1 << 20))
        plant_predicate(stack, pred)
        planes, sign, exists = stack[2:], stack[1], stack[0]
        pbits = [(pred >> d) & 1 for d in range(depth)]
        args = ("gt", planes, sign, exists, pbits, False, False)
        ms, call_ms, how = kernel_ms(
            torch, lambda: k5.bsi_range_mask(*args), reps,
            "bsi_range_kernel")
        plain_ms = time_cuda(
            torch, lambda: k5.bsi_range_mask_reference(*args), plain_reps)
        nbytes = (depth + 3) * s * words * 4
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        log(f"kernels: K5 gt at [{depth}, {s}x{words}] ({nbytes} bytes): "
            f"{ms * 1e3:.2f} us/launch ({how}; {call_ms * 1e3:.2f} us per "
            f"call by events), bound {bound_ms * 1e3:.2f} us at 3.35 TB/s, "
            f"plain {plain_ms * 1e3:.2f} us; card {card}")
        if timing is None:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes"}
            # K3 at Sum's shape: the [D, S·W] plane view with a filter
            flat = planes.reshape(depth, -1)
            filt = sign.reshape(-1)
            k3_ms, k3_call, how = kernel_ms(
                torch, lambda: k3.row_counts(flat, filt), reps,
                "row_counts_kernel")
            k3_plain = time_cuda(
                torch, lambda: k3.row_counts_reference(flat, filt),
                plain_reps)
            k3_bytes = (depth + 1) * s * words * 4 + depth * 8
            log(f"kernels: K3 at Sum's [{depth}, {s}x{words}] with a "
                f"filter ({k3_bytes} bytes): {k3_ms * 1e3:.2f} us/launch "
                f"({how}; {k3_call * 1e3:.2f} us per call by events), "
                f"bound {k3_bytes / H100_BYTES_PER_S * 1e6:.2f} us, plain "
                f"{k3_plain * 1e3:.2f} us; card {card}")
            del flat, filt
        del stack, planes, sign, exists
        torch.cuda.empty_cache()
    return max_err, timing


def k2_ids(rng, n, avoid=None, keep=None):
    """n distinct sorted block ids below K2_ID_SPACE: the ids of `keep`
    first, the rest drawn outside `avoid`."""
    keep = np.empty(0, np.int64) if keep is None else keep
    pool = np.arange(K2_ID_SPACE)
    if avoid is not None and len(avoid):
        pool = np.setdiff1d(pool, avoid, assume_unique=True)
    rest = rng.choice(pool, n - len(keep), replace=False)
    return np.sort(np.concatenate([keep, rest]))


def k2_sparse(torch, rng, nb, ids):
    """(ids [nb], blocks [nb, 128]) on the card: `ids` on the first rows,
    sentinel padding with zero blocks after, edge words planted."""
    from pilosa_tpu_torch.ops.count_blocks import SPARSE_SENTINEL

    full = np.full(nb, SPARSE_SENTINEL, dtype=np.int32)
    full[:len(ids)] = ids
    blocks = rng.integers(0, 1 << 32, (nb, 128), dtype=np.uint32)
    if nb:
        blocks[:, 0] = 0xFFFFFFFF
        blocks[:, 1] = 0x80000000
    blocks[len(ids):] = 0
    return (torch.from_numpy(full).cuda(),
            torch.from_numpy(blocks.view(np.int32)).cuda())


K2_EDGE_CASES = ("b_16x_denser", "a_above_b", "a_below_b", "ragged",
                 "a_padding", "b_padding", "nb_a_1")


def k2_edge_ids(case, rng):
    """(ids_a, nb_a, ids_b, nb_b) of one edge case of the fused entry's
    tile-wise intersection (128 ids of a per CTA, b's ids walked 1024 at
    a time): real ids first, padding after."""
    pool = np.arange(0, K2_ID_SPACE, 32)
    if case == "b_16x_denser":  # a tile's b window spans several chunks
        a = np.sort(rng.choice(pool, 3000, replace=False))
        rest = np.setdiff1d(np.arange(a[0], a[-1]), a)
        b = np.sort(np.concatenate(
            [a[::2], rng.choice(rest, 15 * len(a), replace=False)]))
        return a, 3100, b, len(b) + 100
    lo = np.sort(rng.choice(K2_ID_SPACE // 2, 30000, replace=False))
    hi = np.sort(rng.choice(K2_ID_SPACE // 2, 5000, replace=False)) \
        + K2_ID_SPACE // 2
    if case == "a_above_b":
        return hi, 5120, lo, 32768
    if case == "a_below_b":
        return lo[:5000], 5120, hi, 32768
    if case == "ragged":  # NB_a not a multiple of the tile
        b = np.concatenate([lo[1:2900:2], hi[:4000]])
        return lo[:2900], 3000, b, len(b) + 50
    if case == "a_padding":
        return np.empty(0, np.int64), 4096, lo, 32768
    if case == "b_padding":
        return lo[:3000], 3200, np.empty(0, np.int64), 7000
    if case == "nb_a_1":
        return lo[12345:12346], 1, lo, 32768
    raise ValueError(case)


def k2_launches(k2):
    return k2.count_blocks.launches + k2.count_and_blocks.launches


def k2_fused_bytes(ids_a, ids_b):
    """Bytes count_and_blocks must read: both id arrays and the blocks
    of both sides whose ids match (padding never matches)."""
    from pilosa_tpu_torch.ops.count_blocks import SPARSE_SENTINEL

    a, b = ids_a.cpu().numpy(), ids_b.cpu().numpy()
    matched = len(np.intersect1d(a[a != SPARSE_SENTINEL], b))
    return (len(a) + len(b)) * 4 + 2 * matched * 512 + 8, matched


def check_k2(torch, k2, card):
    """K2's two entries against their plain versions on the card;
    returns max_abs_err. Times each entry at NB = 32768 and 131072."""
    rng = np.random.default_rng(COMP_SEED)
    max_err = 0
    n_cases = 0

    def same(name, got, want, launched, before):
        nonlocal max_err, n_cases
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        max_err = max(max_err, err)
        n_cases += 1
        if err or k2_launches(k2) != before + launched:
            raise AssertionError(
                f"K2 {name}: {int(got)} vs plain {int(want)}, launches "
                f"{k2_launches(k2) - before} (want {launched})")

    for nb in K2_NBS:
        real = nb - nb // 4
        ids_a = k2_ids(rng, real)
        ids, blocks = k2_sparse(torch, rng, nb, ids_a)
        other = k2_sparse(torch, rng, nb, ids_a)[1]
        before = k2_launches(k2)
        same(f"count_blocks NB={nb}", k2.count_blocks(blocks),
             k2.count_blocks_reference(blocks), 1 if nb else 0, before)
        before = k2_launches(k2)
        same(f"count_and_blocks NB={nb} identical ids",
             k2.count_and_blocks(ids, blocks, ids, other),
             k2.count_and_blocks_reference(ids, blocks, ids, other),
             1 if nb else 0, before)
        for nb_b in sorted({nb // 2, nb, 2 * nb}):
            real_b = nb_b - nb_b // 4
            for frac in (0.0, 0.5, 1.0):
                n_keep = int(round(frac * min(real, real_b)))
                keep = rng.choice(ids_a, n_keep, replace=False) \
                    if n_keep else None
                ids_b = k2_ids(rng, real_b, avoid=ids_a, keep=keep)
                b = k2_sparse(torch, rng, nb_b, ids_b)
                before = k2_launches(k2)
                same(f"count_and_blocks NB={nb} NB_b={nb_b} match={frac}",
                     k2.count_and_blocks(ids, blocks, *b),
                     k2.count_and_blocks_reference(ids, blocks, *b),
                     1 if nb and nb_b else 0, before)
        if nb in (32768, 131072):
            ids_b = k2_ids(rng, real, avoid=ids_a,
                           keep=rng.choice(ids_a, real // 2, replace=False))
            b = k2_sparse(torch, rng, nb, ids_b)
            fused_bytes, matched = k2_fused_bytes(ids, b[0])
            for name, fn, plain, kernel_bytes in (
                    ("count_blocks", lambda: k2.count_blocks(blocks),
                     lambda: k2.count_blocks_reference(blocks),
                     nb * 512 + 8),
                    ("count_and_blocks",
                     lambda: k2.count_and_blocks(ids, blocks, *b),
                     lambda: k2.count_and_blocks_reference(ids, blocks, *b),
                     fused_bytes)):
                ms, call_ms, how = kernel_ms(torch, fn, 50,
                                             "count_blocks_kernel",
                                             cold_l2=True)
                warm = ""
                if name == "count_and_blocks":
                    warm_ms = kernel_ms(torch, fn, 50,
                                        "count_blocks_kernel")[0]
                    warm = f"; {warm_ms * 1e3:.2f} us with the inputs in L2"
                plain_ms = time_cuda(torch, plain, 10)
                log(f"kernels: K2 {name} at NB={nb}"
                    + (f" (half matched: {matched} blocks)"
                       if name == "count_and_blocks" else "")
                    + f" ({kernel_bytes} bytes): {ms * 1e3:.2f} us/launch "
                    f"({how}{warm}; {call_ms * 1e3:.2f} us per call by "
                    f"events), bound "
                    f"{kernel_bytes / H100_BYTES_PER_S * 1e6:.2f} us at "
                    f"3.35 TB/s, plain {plain_ms * 1e3:.2f} us; card {card}")
            del b
        del ids, blocks, other
    for case in K2_EDGE_CASES:
        ids_a, nb_a, ids_b, nb_b = k2_edge_ids(case, rng)
        a = k2_sparse(torch, rng, nb_a, ids_a)
        b = k2_sparse(torch, rng, nb_b, ids_b)
        before = k2_launches(k2)
        same(f"count_and_blocks {case} (NB_a={nb_a}, NB_b={nb_b})",
             k2.count_and_blocks(*a, *b),
             k2.count_and_blocks_reference(*a, *b), 1, before)
    torch.cuda.empty_cache()
    log(f"kernels: K2 == plain on {n_cases} cases (NB in "
        f"{','.join(map(str, K2_NBS))}; fused at NB_b = NB/2, NB, 2NB x "
        f"match 0, 1/2, 1 and on identical ids; sentinel padding, edge "
        f"words; {', '.join(K2_EDGE_CASES)})")
    return max_err


def compressible_rows(words):
    """The compressed path's rows of index b as [N_SHARDS, W] host
    stacks, keyed (field, row), drawn from COMP_SEED: f=10, f=11 and
    g=10 hold SPARSE_BLOCKS random 128-word blocks per shard, each word
    random (about half its bits set), g=10 sharing SHARED_BLOCKS of
    f=10's blocks in every shard; f=20 and g=20 hold two runs of
    RUN_BITS bits per shard, g=20's starting RUN_BITS // 2 later."""
    rng = np.random.default_rng(COMP_SEED)
    bps = words // 128
    perm = np.argsort(rng.random((N_SHARDS, bps)), axis=1)
    other = np.argsort(rng.random((N_SHARDS, bps)), axis=1)
    where = {
        ("f", 10): perm[:, :SPARSE_BLOCKS],
        ("g", 10): np.concatenate(
            [perm[:, :SHARED_BLOCKS],
             perm[:, SPARSE_BLOCKS:2 * SPARSE_BLOCKS - SHARED_BLOCKS]],
            axis=1),
        ("f", 11): other[:, :SPARSE_BLOCKS],
    }
    shard_ix = np.arange(N_SHARDS)[:, None]
    rows = {}
    for key, blocks in where.items():
        stack = np.zeros((N_SHARDS, bps, 128), dtype=np.uint32)
        stack[shard_ix, blocks] = rng.integers(
            0, 1 << 32, (N_SHARDS, SPARSE_BLOCKS, 128), dtype=np.uint32)
        rows[key] = stack.reshape(N_SHARDS, words)
    nbits = words * 32
    for key in (("f", 20), ("g", 20)):
        rows[key] = np.zeros((N_SHARDS, words), dtype=np.uint32)
    for shard in range(N_SHARDS):
        starts = (int(rng.integers(0, nbits // 2 - 2 * RUN_BITS)),
                  int(rng.integers(nbits // 2, nbits - 2 * RUN_BITS)))
        for key, shift in ((("f", 20), 0), (("g", 20), RUN_BITS // 2)):
            bits = np.zeros(nbits, dtype=np.uint8)
            for a in starts:
                bits[a + shift:a + shift + RUN_BITS] = 1
            rows[key][shard] = np.packbits(
                bits, bitorder="little").view(np.uint32)
    return rows


def build_count_data(path, words):
    """Index b: the Count path's rows 1 and 2 of f and g, one random
    plane repeated over every shard, and the compressed path's rows
    (compressible_rows). Returns (planes, compressed stacks)."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import FieldOptions

    rng = np.random.default_rng(SEED)
    planes = {}
    for fname in ("f", "g"):
        for row in (1, 2):
            dense = rng.integers(0, 1 << 32, words, dtype=np.uint32)
            keep = rng.random(words) < DENSITY
            planes[(fname, row)] = np.where(keep, dense, 0).astype(np.uint32)
    comp = compressible_rows(words)
    holder = Holder(path, use_snapshot_queue=False).open()
    try:
        idx = holder.create_index("b")
        for fname in ("f", "g"):
            field = idx.create_field(fname, FieldOptions())
            view = field.create_view_if_not_exists("standard")
            for shard in range(N_SHARDS):
                frag = view.create_fragment_if_not_exists(shard)
                for row in (1, 2):
                    frag.set_row_plane(row, planes[(fname, row)])
                for (f, row), stack in comp.items():
                    if f == fname:
                        frag.set_row_plane(row, stack[shard])
    finally:
        holder.close()
    return planes, comp


def build_topn_data(path):
    """BASELINE config 3 at bench_suite.bench_topn_groupby's chip shape,
    drawn exactly as that function draws it."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    n_cols = TG_SHARDS * SHARD_WIDTH
    rng = np.random.default_rng(TG_SEED)
    f_cols = []
    for r in range(100):
        n = int(100_000 / (r + 1)) + 100
        f_cols.append(rng.integers(0, n_cols, size=n, dtype=np.uint64))
    g_cols = rng.choice(n_cols, size=300_000, replace=False)
    a_rows = rng.integers(0, 5, size=len(g_cols)).astype(np.uint64)
    b_rows = rng.integers(0, 4, size=len(g_cols)).astype(np.uint64)
    holder = Holder(path, use_snapshot_queue=False).open()
    try:
        idx = holder.create_index("tg")
        for fname in ("f", "a", "b"):
            idx.create_field(fname)
        idx.field("f").import_bits(
            np.concatenate([np.full(len(c), r, dtype=np.uint64)
                            for r, c in enumerate(f_cols)]),
            np.concatenate(f_cols))
        idx.field("a").import_bits(a_rows, g_cols.astype(np.uint64))
        idx.field("b").import_bits(b_rows, g_cols.astype(np.uint64))
    finally:
        holder.close()
    return {"f": [np.unique(c).astype(np.int64) for c in f_cols],
            "g_cols": g_cols.astype(np.int64),
            "a": a_rows.astype(np.int64), "b": b_rows.astype(np.int64)}


def _plane_of(offsets, shard_width):
    """Dense uint32 words of one row with the given shard offsets set."""
    bits = np.zeros(shard_width, dtype=bool)
    bits[offsets] = True
    return np.packbits(bits, bitorder="little").view(np.uint32)


def build_bsi_data(path):
    """BASELINE config 4 at BR_SHARDS shards, drawn as
    bench_suite.bench_bsi_range_sum draws it (uniform values on distinct
    columns, one t bit per valued column in one of three months), its
    rows written whole with Fragment.set_row_plane: Field.import_values
    loops in Python over each value's ~23 positions, far too slow for
    12.8M values. Returns the drawn columns, values and months."""
    from pilosa_tpu_torch.core import Holder, timeq
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(BR_SEED)
    cols, vals, months = [], [], []
    holder = Holder(path, use_snapshot_queue=False).open()
    try:
        idx = holder.create_index("br")
        v = idx.create_field("v", FieldOptions.int_field(min=0, max=1 << 20))
        t = idx.create_field("t", FieldOptions.time_field("YMD"))
        depth = v.options.bit_depth
        bsi_view = v.create_view_if_not_exists(v.bsi_view_name())
        # per month: its year, month and day views; every valued column
        # is in the standard view and the 2019 view
        month_views = [timeq.views_by_time("standard", timeq.parse_time(d),
                                           "YMD")[1:] for d in BR_DATES]
        all_views = ["standard", "standard_2019"] + [
            n for names in month_views for n in names]
        views = {n: t.create_view_if_not_exists(n) for n in all_views}
        for shard in range(BR_SHARDS):
            off = rng.choice(SHARD_WIDTH, BR_VALUES_PER_SHARD, replace=False)
            val = rng.integers(0, 1 << 20, BR_VALUES_PER_SHARD)
            mon = rng.integers(0, 3, BR_VALUES_PER_SHARD)
            everyone = _plane_of(off, SHARD_WIDTH)
            frag = bsi_view.create_fragment_if_not_exists(shard)
            frag.set_row_plane(BSI_EXISTS_BIT, everyone)
            for i in range(depth):
                frag.set_row_plane(
                    BSI_OFFSET_BIT + i,
                    _plane_of(off[(val >> i) & 1 == 1], SHARD_WIDTH))
            for name in ("standard", "standard_2019"):
                views[name].create_fragment_if_not_exists(
                    shard).set_row_plane(0, everyone)
            for m, names in enumerate(month_views):
                plane = _plane_of(off[mon == m], SHARD_WIDTH)
                for name in names:
                    views[name].create_fragment_if_not_exists(
                        shard).set_row_plane(0, plane)
            cols.append(off.astype(np.int64) + shard * SHARD_WIDTH)
            vals.append(val.astype(np.int64))
            months.append(mon.astype(np.int8))
    finally:
        holder.close()
    return {"cols": np.concatenate(cols), "vals": np.concatenate(vals),
            "months": np.concatenate(months), "depth": depth}


def topn_expect(tg):
    """Expected JSON of each checked TopN/Rows/GroupBy query, from numpy."""
    f = tg["f"]
    counts = [len(c) for c in f]
    a_sets = [np.sort(tg["g_cols"][tg["a"] == i]) for i in range(5)]

    def pairs(cnt, n, minimum=1):
        keep = [r for r in range(100) if cnt[r] >= minimum]
        keep.sort(key=lambda r: (-cnt[r], r))
        return [{"id": r, "count": int(cnt[r])} for r in keep[:n]]

    filtered = [len(np.intersect1d(c, a_sets[1], assume_unique=True))
                for c in f]

    def groups(mask):
        out = []
        for i in range(5):
            for j in range(4):
                n = int(np.sum((tg["a"] == i) & (tg["b"] == j) & mask))
                if n:
                    out.append({"group": [{"field": "a", "rowID": i},
                                          {"field": "b", "rowID": j}],
                                "count": n})
        return out

    everything = np.ones(len(tg["g_cols"]), dtype=bool)
    in_f0 = np.isin(tg["g_cols"], f[0])
    return {
        "TopN(f, n=10)": pairs(counts, 10),
        "TopN(f, Row(a=1), n=5)": pairs(filtered, 5),
        "TopN(f, n=5, threshold=5000)": pairs(counts, 5, 5000),
        "Rows(a)": {"rows": [i for i in range(5) if len(a_sets[i])]},
        "GroupBy(Rows(a))": [
            {"group": [{"field": "a", "rowID": i}], "count": len(a_sets[i])}
            for i in range(5) if len(a_sets[i])],
        "GroupBy(Rows(a), Rows(b))": groups(everything),
        "GroupBy(Rows(a), Rows(b), filter=Row(f=0))": groups(in_f0),
    }


def http(uri, path, body=None):
    req = urllib.request.Request(
        uri + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
    if isinstance(out, dict) and "error" in out:
        raise RuntimeError(f"{path}: {out['error']}")
    return out


def reset_counters(mods):
    for fn in mods.values():
        fn.launches = 0


def serve_count_path(srv, k1, planes, card):
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    P = planes
    expect = {}
    for a in (1, 2):
        for b in (1, 2):
            expect[f"Count(Intersect(Row(f={a}), Row(g={b})))"] = \
                N_SHARDS * popcount(P[("f", a)] & P[("g", b)])
    nested = ("Count(Union(Intersect(Row(f=1), Row(g=1)), "
              "Difference(Row(f=2), Row(g=2))))")
    expect[nested] = N_SHARDS * popcount(
        (P[("f", 1)] & P[("g", 1)]) | (P[("f", 2)] & ~P[("g", 2)]))
    xor = "Count(Xor(Row(f=1), Row(g=2)))"
    expect[xor] = N_SHARDS * popcount(P[("f", 1)] ^ P[("g", 2)])
    # a column whose f=1 bit is clear, in a middle shard
    shard = N_SHARDS // 2
    word = int(np.nonzero(P[("f", 1)] == 0)[0][0])
    col = shard * SHARD_WIDTH + word * 32
    single = "Count(Row(f=1))"
    expect[single] = N_SHARDS * popcount(P[("f", 1)])

    def count(pql):
        before = k1.count_expr.launches
        t = time.perf_counter()
        got = http(srv.uri, "/index/b/query", pql)["results"][0]
        dt = time.perf_counter() - t
        if k1.count_expr.launches != before + 1:
            raise AssertionError(f"{pql}: K1 launches moved by "
                                 f"{k1.count_expr.launches - before}, not 1")
        return got, dt

    status = http(srv.uri, "/status")
    if status.get("state") != "NORMAL":
        raise AssertionError(f"/status: {status}")
    cold = {}
    for pql, want in expect.items():
        got, dt = count(pql)
        cold[pql] = dt
        if got != want:
            raise AssertionError(f"{pql}: {got} != {want}")
        log(f"serve: {pql} = {got} (cold {dt * 1e3:.1f} ms)")
    ok = http(srv.uri, "/index/b/query", f"Set({col}, f=1)")["results"]
    if ok != [True]:
        raise AssertionError(f"Set({col}, f=1) -> {ok}")
    got, dt = count(single)
    if got != expect[single] + 1:
        raise AssertionError(
            f"read-your-write: {got} != {expect[single] + 1}")
    log(f"serve: Set({col}, f=1) then {single} = {got} "
        f"(patched, {dt * 1e3:.1f} ms)")
    patches = srv.api.executor.stacked_stats()["patches"]
    if patches < 1:
        raise AssertionError("Set did not patch the cached stack")
    warm = []
    pairs = [q for q in expect if q.startswith("Count(Intersect")]
    for _ in range(25):
        for pql in pairs:
            got, dt = count(pql)
            if got != expect[pql]:
                raise AssertionError(f"{pql} warm: {got}")
            warm.append(dt)
    cold_pairs = [cold[q] for q in pairs]
    log(f"serve: Count(Intersect(Row, Row)) over {N_SHARDS} shards on "
        f"{card}: cold (upload) p50 "
        f"{statistics.median(cold_pairs) * 1e3:.3f} ms, warm p50 "
        f"{statistics.median(warm) * 1e3:.3f} ms over {len(warm)} "
        f"queries; K1 launches on the path: {k1.count_expr.launches}")
    return shard, word  # where the Set added a bit to f=1 (bit 0)


def right_nested(depth):
    """(PQL, ops) of Intersect/Union alternating over rows f=0..depth-1,
    nested to the right: K1 stack depth `depth`."""
    ops = [("Intersect", "Union")[i % 2] for i in range(depth - 1)]
    pql = f"Row(f={depth - 1})"
    for i in range(depth - 2, -1, -1):
        pql = f"{ops[i]}(Row(f={i}), {pql})"
    return pql, ops


def serve_tree_limits(srv, k1, tg, card):
    """Counts over index tg past K1's limits (16 leaves, 64 steps, stack
    depth 8), each equal to numpy and each exactly one K1 launch: the
    port folds sub-trees to planes first (`count_expr.fit_tree`)."""
    f = tg["f"]
    expect = {}
    for n in (17, 33):
        rows = ", ".join(f"Row(f={i})" for i in range(n))
        expect[f"Count(Union({rows}))"] = len(
            np.unique(np.concatenate(f[:n])))
    deep, ops = right_nested(9)
    acc = f[8]
    for i in range(7, -1, -1):
        acc = (np.intersect1d if ops[i] == "Intersect" else np.union1d)(
            f[i], acc)
    expect[f"Count({deep})"] = len(acc)
    for pql, want in expect.items():
        before = k1.count_expr.launches
        t0 = time.perf_counter()
        got = http(srv.uri, "/index/tg/query", pql)["results"][0]
        dt = time.perf_counter() - t0
        if k1.count_expr.launches != before + 1:
            raise AssertionError(f"{pql[:40]}...: K1 launches moved by "
                                 f"{k1.count_expr.launches - before}, not 1")
        if got != want:
            raise AssertionError(f"{pql}: {got} != {want}")
        log(f"serve: {pql[:60]}... over {TG_SHARDS} shards = {got} "
            f"(past K1's limits; one K1 launch; cold {dt * 1e3:.1f} ms "
            f"on {card})")


def count_expect(planes):
    """Numpy answers of the four Count(Intersect(Row(f=a), Row(g=b)))
    and the four single-row Counts over index b."""
    expect = {}
    for a in (1, 2):
        for b in (1, 2):
            expect[f"Count(Intersect(Row(f={a}), Row(g={b})))"] = \
                N_SHARDS * popcount(planes[("f", a)] & planes[("g", b)])
    for f in ("f", "g"):
        for r in (1, 2):
            expect[f"Count(Row({f}={r}))"] = \
                N_SHARDS * popcount(planes[(f, r)])
    return expect


def _clients(uri, queries, n_threads):
    """`queries` split over `n_threads` client threads, each sending its
    share one at a time; returns (wall seconds, [(pql, answer, seconds)])."""
    shares = [queries[i::n_threads] for i in range(n_threads)]
    done = [[] for _ in range(n_threads)]
    errors = []
    start = threading.Barrier(n_threads + 1)

    def client(i):
        start.wait()
        try:
            for pql in shares[i]:
                t = time.perf_counter()
                got = http(uri, "/index/b/query", pql)["results"][0]
                done[i].append((pql, got, time.perf_counter() - t))
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, [x for d in done for x in d]


def serve_batch_path(srv, k1, planes, set_at, card):
    """The batched paths over index b (954 shards): a POST query-batch of
    64 Counts (32 Intersect pairs, one group; 32 single rows, another),
    sent twice, must be two launches of K1's batched entry each time and
    no single K1 launch;
    then 200 warm Counts from one client and the same 200 from 8 client
    threads through /query (GroupCommit). Every answer equals numpy."""
    expect = count_expect(planes)
    # the Count path's Set: bit 0 of a word of f=1 that was clear
    _, word = set_at
    expect["Count(Row(f=1))"] += 1
    for g in (1, 2):
        expect[f"Count(Intersect(Row(f=1), Row(g={g})))"] += \
            int(planes[("g", g)][word]) & 1
    pairs = [q for q in expect if q.startswith("Count(Intersect")]
    singles = [q for q in expect if q.startswith("Count(Row")]
    batch = (pairs + singles) * 8
    walls = []
    for _ in range(2):  # the first re-gathers leaves the pool evicted
        b0, s0 = k1.count_expr_batch.launches, k1.count_expr.launches
        t0 = time.perf_counter()
        out = http(srv.uri, "/index/b/query-batch",
                   json.dumps({"queries": batch}))["results"]
        walls.append(time.perf_counter() - t0)
        for pql, slot in zip(batch, out):
            if slot.get("results") != [expect[pql]]:
                raise AssertionError(f"query-batch {pql}: {slot} != "
                                     f"{expect[pql]}")
            if slot.get("batch") != 32:
                raise AssertionError(f"query-batch {pql}: batch "
                                     f"{slot.get('batch')}, not 32")
        launched = (k1.count_expr_batch.launches - b0,
                    k1.count_expr.launches - s0)
        if launched != (2, 0):
            raise AssertionError(f"query-batch of 64 Counts launched "
                                 f"batched K1 / K1 {launched} times, not "
                                 f"(2, 0)")
    log(f"serve: POST query-batch of {len(batch)} Counts over {N_SHARDS} "
        f"shards = numpy, twice: {walls[0] * 1e3:.1f} ms (leaves evicted "
        f"by the tree-limit Counts re-gathered), then {walls[1] * 1e3:.1f} "
        f"ms warm; each two groups of 32, two batched K1 launches, no "
        f"single K1 launch; card {card}")

    queries = [pql for _ in range(25) for pql in expect]  # 200 warm Counts
    for n_threads in (1, 8):
        st0 = srv.api.executor.stacked_stats()
        wall, done = _clients(srv.uri, queries, n_threads)
        st1 = srv.api.executor.stacked_stats()
        for pql, got, _ in done:
            if got != expect[pql]:
                raise AssertionError(f"{n_threads} clients: {pql} = {got}, "
                                     f"numpy {expect[pql]}")
        lat = sorted(t for _, _, t in done)
        batches = st1["count_batches"] - st0["count_batches"]
        batched = st1["count_batched_queries"] - st0["count_batched_queries"]
        log(f"serve: {len(done)} warm Counts over {N_SHARDS} shards from "
            f"{n_threads} client thread(s): {len(done) / wall:.1f} QPS, "
            f"p50 {statistics.median(lat) * 1e3:.3f} ms, p99 "
            f"{lat[int(0.99 * (len(lat) - 1))] * 1e3:.3f} ms; GroupCommit "
            f"count_batches {batches}, count_batched_queries {batched} "
            f"({batched / max(batches, 1):.2f} a batch); card {card}")


def serve_coalescer(srv, data_dir, card):
    """A second server with --coalesce-window 1ms over a copy of index
    tg alone: 8 client threads x 25 Counts and Rows, each equal to the
    first server's answer; /debug/batching must show 200 coalesced
    queries and a batch of two or more."""
    queries = [f"Count(Intersect(Row(a={i}), Row(b={j})))"
               for i in range(5) for j in range(4)]
    queries += [f"Count(Row(f={r}))" for r in range(80, 95)]
    queries += [f"Row(f={r})" for r in range(85, 100)]
    want = {q: http(srv.uri, "/index/tg/query", q)["results"] for q in queries}
    from pilosa_tpu_torch.cli import start_server

    t0 = time.perf_counter()
    co = start_server(["--bind", "127.0.0.1:0", "--data-dir", data_dir,
                       "--device", "cuda", "--coalesce-window", "1ms"])
    log(f"serve: coalescing server up in {time.perf_counter() - t0:.1f} s "
        f"(index tg alone)")
    try:
        sent = [queries[(7 * k) % len(queries)] for k in range(200)]
        shares = [sent[i::8] for i in range(8)]
        errors = []

        def client(share):
            try:
                for q in share:
                    got = http(co.uri, "/index/tg/query", q)["results"]
                    if got != want[q]:
                        raise AssertionError(f"coalesced {q}: {got} != "
                                             f"{want[q]}")
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(sh,))
                   for sh in shares]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        st = http(co.uri, "/debug/batching")
        c = st["coalescer"]
        if c["coalesced_queries"] != 200 or c["max_occupancy"] < 2:
            raise AssertionError(f"/debug/batching: {st}")
        log(f"serve: coalescer (1 ms window) over {TG_SHARDS} shards: 200 "
            f"Counts and Rows from 8 threads = the first server's in "
            f"{wall:.2f} s ({200 / wall:.1f} QPS); {c['batches']} batches, "
            f"max occupancy {c['max_occupancy']}, occupancy histogram "
            f"{c['occupancy_hist']}; batched launches "
            f"{st['batch_dispatches']}; card {card}")
    finally:
        co.stop()


def serve_topn_path(srv, k3, k4, tg, card):
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    expect = topn_expect(tg)

    def query(pql, k3_step=0, k4_step=0):
        b3, b4 = k3.row_counts.launches, k4.pairwise_counts.launches
        t = time.perf_counter()
        got = http(srv.uri, "/index/tg/query", pql)["results"][0]
        dt = time.perf_counter() - t
        if k3.row_counts.launches < b3 + k3_step:
            raise AssertionError(f"{pql}: K3 did not launch")
        if k4.pairwise_counts.launches < b4 + k4_step:
            raise AssertionError(f"{pql}: K4 did not launch")
        if pql in expect and got != expect[pql]:
            raise AssertionError(f"{pql}: {got} != {expect[pql]}")
        return got, dt

    # (query, K3 launches at least, K4 launches at least); the first two
    # are cold: they gather and upload their row chunks
    cold = {}
    for pql, k3_step, k4_step in (
            ("TopN(f, n=10)", 1, 0),
            ("GroupBy(Rows(a), Rows(b))", 0, 1),
            ("TopN(f, Row(a=1), n=5)", 1, 0),
            ("TopN(f, n=5, threshold=5000)", 1, 0),
            ("Rows(a)", 0, 0),
            ("GroupBy(Rows(a))", 1, 0),
            ("GroupBy(Rows(a), Rows(b), filter=Row(f=0))", 0, 1)):
        got, dt = query(pql, k3_step, k4_step)
        cold[pql] = dt
        log(f"serve: {pql} = {json.dumps(got)[:160]} ({dt * 1e3:.1f} ms)")
    # read-your-write through a patched row chunk: one more bit in f=9
    row, shard = 9, 3
    present = set(tg["f"][row].tolist())
    col = next(c for c in range(shard * SHARD_WIDTH, (shard + 1) * SHARD_WIDTH)
               if c not in present)
    patches = srv.api.executor.stacked_stats()["patches"]
    ok = http(srv.uri, "/index/tg/query", f"Set({col}, f={row})")["results"]
    if ok != [True]:
        raise AssertionError(f"Set({col}, f={row}) -> {ok}")
    want = [dict(p) for p in expect["TopN(f, n=10)"]]
    for p in want:
        if p["id"] == row:
            p["count"] += 1
    expect["TopN(f, n=10)"] = want
    got, dt = query("TopN(f, n=10)", 1, 0)
    if srv.api.executor.stacked_stats()["patches"] <= patches:
        raise AssertionError("Set did not patch the cached row chunk")
    log(f"serve: Set({col}, f={row}) then TopN(f, n=10) reads it back "
        f"(patched row chunk, {dt * 1e3:.1f} ms)")
    warm = {"TopN(f, n=10)": [], "GroupBy(Rows(a), Rows(b))": []}
    for _ in range(60):
        warm["TopN(f, n=10)"].append(query("TopN(f, n=10)", 1, 0)[1])
        warm["GroupBy(Rows(a), Rows(b))"].append(
            query("GroupBy(Rows(a), Rows(b))", 0, 1)[1])
    for pql, times in warm.items():
        log(f"serve: {pql} over {TG_SHARDS} shards on {card}: cold "
            f"{cold[pql] * 1e3:.3f} ms, warm p50 "
            f"{statistics.median(times) * 1e3:.3f} ms over {len(times)} "
            f"queries")
    log(f"serve: launches on the TopN/GroupBy path: K3 "
        f"{k3.row_counts.launches}, K4 {k4.pairwise_counts.launches}")
    return row, col  # the Set's bit of index tg


def http_raw(uri, method, path, body=None):
    """(status, content type, body bytes) of one request; HTTP errors are
    answers too."""
    data = body if isinstance(body, (bytes, type(None))) else body.encode()
    req = urllib.request.Request(uri + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def shift_plane(plane, n):
    """Numpy Shift of one shard's plane: bits move n columns up, and
    those past the shard's last column drop."""
    bits = np.unpackbits(plane.view(np.uint8), bitorder="little")
    out = np.zeros_like(bits)
    if n < len(bits):
        out[n:] = bits[:len(bits) - n]
    return np.packbits(out, bitorder="little").view(np.uint32)


def csv_lines(rows):
    """The export's row,col lines of {row: sorted columns}."""
    return [f"{r},{c}" for r in sorted(rows) for c in rows[r]]


def plane_columns(plane, base):
    bits = np.unpackbits(plane.view(np.uint8), bitorder="little")
    return (np.nonzero(bits)[0] + base).tolist()


def serve_pql_surface(srv, k1, k3, planes, comp, tg, set_at, tg_set, card):
    """The remaining PQL calls and the public routes over index b (954
    shards), index tg and a small keyed index, every answer against
    numpy and every launch delta exact: Count(Shift) at n = 1, 33 (with
    an Intersect) and 2^20 - 1, and an Options(shards) Count, one K1
    launch each; MinRow/MaxRow on b's and tg's f, with and without a
    filter, one K3 launch per row chunk walked and no K1; Store into a
    new field and ClearRow, each read back by a Count; an import-roaring
    into a new field; GET /export of b's f, shard 0; DELETE of the
    stored field, re-create and import, then a Count; keyed import, Row,
    TopN and export; row and column attributes with columnAttrs=true.
    Only fields and indexes this phase makes are written or deleted."""
    from pilosa_tpu_torch.roaring import Bitmap, serialize
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    F1, G1, G2 = planes[("f", 1)], planes[("g", 1)], planes[("g", 2)]
    shard1, word1 = set_at  # the Count path's Set: bit 0, f=1
    F1s = F1.copy()
    F1s[word1] |= np.uint32(1)
    # the compressed path's Set: bit 0 of the first clear word of f=10
    # in shard N_SHARDS // 3
    shard10 = N_SHARDS // 3
    word10 = int(np.nonzero(comp[("f", 10)][shard10] == 0)[0][0])

    def total(fn):
        """Σ over index b's shards of popcount(fn(f=1 plane))."""
        return (N_SHARDS - 1) * popcount(fn(F1)) + popcount(fn(F1s))

    def query(index, pql, k1_step, k3_step, path_args=""):
        before = (k1.count_expr.launches, k3.row_counts.launches)
        t0 = time.perf_counter()
        got = http(srv.uri, f"/index/{index}/query{path_args}", pql)
        dt = time.perf_counter() - t0
        moved = (k1.count_expr.launches - before[0],
                 k3.row_counts.launches - before[1])
        if moved != (k1_step, k3_step):
            raise AssertionError(f"{pql[:60]}: launches (K1, K3) moved by "
                                 f"{moved}, not {(k1_step, k3_step)}")
        return got, dt

    def check(index, pql, want, k1_step, k3_step):
        got, dt = query(index, pql, k1_step, k3_step)
        if got["results"][0] != want:
            raise AssertionError(f"{pql[:60]}: {got['results'][0]} != {want}")
        return dt

    # Shift: one K1 launch over the transient shifted [S, W] leaf
    shift_cases = [
        ("Count(Shift(Row(f=1), n=1))",
         total(lambda p: shift_plane(p, 1))),
        ("Count(Intersect(Shift(Row(f=1), n=33), Row(g=1)))",
         total(lambda p: shift_plane(p, 33) & G1)),
        (f"Count(Shift(Row(f=1), n={SHARD_WIDTH - 1}))",
         total(lambda p: shift_plane(p, SHARD_WIDTH - 1))),
    ]
    cold = {}
    for pql, want in shift_cases:
        cold[pql] = check("b", pql, want, 1, 0)
        log(f"serve: {pql} over {N_SHARDS} shards = {want} (one K1 launch; "
            f"first call {cold[pql] * 1e3:.1f} ms)")
    pql = shift_cases[0][0]
    warm = [check("b", pql, shift_cases[0][1], 1, 0) for _ in range(20)]
    log(f"serve: {pql} over {N_SHARDS} shards on {card}: cold "
        f"{cold[pql] * 1e3:.3f} ms, warm p50 "
        f"{statistics.median(warm) * 1e3:.3f} ms over {len(warm)} queries")

    # Options(shards): one K1 launch over 477-shard leaf stacks
    half = N_SHARDS // 2
    pql = (f"Options(Count(Intersect(Row(f=1), Row(g=1))), "
           f"shards=[{', '.join(str(i) for i in range(half))}])")
    dt = check("b", pql, half * popcount(F1 & G1), 1, 0)
    log(f"serve: Options(Count(Intersect(Row(f=1), Row(g=1))), shards=[0.."
        f"{half - 1}]) = {half * popcount(F1 & G1)} (one K1 launch, "
        f"{dt * 1e3:.1f} ms)")

    # MinRow/MaxRow: the rows in direction order, one K3 launch per row
    # chunk until one has a non-zero count
    b_rows = {1: None, 2: None, 10: comp[("f", 10)], 11: comp[("f", 11)],
              20: comp[("f", 20)]}

    def b_count(row, filt):
        if b_rows[row] is None:
            plane = planes[("f", row)]
            n = N_SHARDS * popcount(plane if filt is None else plane & filt)
            if row == 1:
                n += 1 if filt is None else int(filt[word1]) & 1
            return n
        stack = b_rows[row]
        n = popcount(stack if filt is None else stack & filt[None, :])
        if row == 10:
            n += 1 if filt is None else int(filt[word10]) & 1
        return n

    chunk_b = max(1, (128 * 1024 * 1024) // (N_SHARDS * SHARD_WIDTH // 8))

    def walk(order, count_of, chunk):
        """(row, count, K3 launches) of the first non-zero row."""
        for i, row in enumerate(order):
            n = count_of(row)
            if n:
                return row, n, i // chunk + 1
        return 0, 0, -(-len(order) // chunk)

    f_sets = [set(c.tolist()) for c in tg["f"]]
    f_sets[tg_set[0]].add(tg_set[1])
    a1 = set(tg["g_cols"][tg["a"] == 1].tolist())
    chunk_tg = max(1, (128 * 1024 * 1024) // (TG_SHARDS * SHARD_WIDTH // 8))
    mm_cases = []
    for call, filt_pql, filt in (("MinRow", "", None),
                                 ("MaxRow", "", None),
                                 ("MinRow", "Row(g=2), ", G2),
                                 ("MaxRow", "Row(g=2), ", G2)):
        order = sorted(b_rows, reverse=call == "MaxRow")
        row, n, k3_n = walk(order, lambda r: b_count(r, filt), chunk_b)
        mm_cases.append(("b", f"{call}({filt_pql}field=f)",
                         {"id": row, "count": n}, k3_n))
    for call, filt_pql, filt in (("MinRow", "", None),
                                 ("MaxRow", "", None),
                                 ("MaxRow", "Row(a=1), ", a1)):
        order = sorted(range(100), reverse=call == "MaxRow")
        row, n, k3_n = walk(
            order, lambda r: len(f_sets[r] if filt is None
                                 else f_sets[r] & filt), chunk_tg)
        mm_cases.append(("tg", f"{call}({filt_pql}field=f)",
                         {"id": row, "count": n}, k3_n))
    for index, pql, want, k3_n in mm_cases:
        dt = check(index, pql, want, 0, k3_n)
        cold[(index, pql)] = dt
        log(f"serve: {pql} over index {index} = {want} (K3 +{k3_n}, "
            f"{dt * 1e3:.1f} ms)")
    index, pql, want, k3_n = mm_cases[0]
    warm = [check(index, pql, want, 0, k3_n) for _ in range(20)]
    log(f"serve: {pql} over {N_SHARDS} shards on {card}: cold "
        f"{cold[(index, pql)] * 1e3:.3f} ms, warm p50 "
        f"{statistics.median(warm) * 1e3:.3f} ms over {len(warm)} queries")

    # Store into a new field h, read back; ClearRow, read back
    stored = total(lambda p: p & G1)
    readback = "Count(Intersect(Row(h=1), Row(f=1)))"
    t0 = time.perf_counter()
    got, _ = query("b", "Store(Intersect(Row(f=1), Row(g=1)), h=1)", 0, 0)
    wall = time.perf_counter() - t0
    if got["results"] != [True]:
        raise AssertionError(f"Store: {got}")
    dt = check("b", readback, stored, 1, 0)
    log(f"serve: Store(Intersect(Row(f=1), Row(g=1)), h=1) over {N_SHARDS} "
        f"shards: wall {wall * 1e3:.1f} ms on {card}; then {readback} = "
        f"{stored} (one K1 launch, {dt * 1e3:.1f} ms)")
    t0 = time.perf_counter()
    got, _ = query("b", "ClearRow(h=1)", 0, 0)
    wall = time.perf_counter() - t0
    if got["results"] != [True]:
        raise AssertionError(f"ClearRow: {got}")
    dt = check("b", readback, 0, 1, 0)
    log(f"serve: ClearRow(h=1): wall {wall * 1e3:.1f} ms; then {readback} "
        f"= 0 (one K1 launch, {dt * 1e3:.1f} ms)")

    # import-roaring into a new field r, shard 0
    http(srv.uri, "/index/b/field/r", "{}")
    rng = np.random.default_rng(SEED)
    r_cols = {r: np.sort(rng.choice(SHARD_WIDTH, 50, replace=False))
              for r in (1, 2)}
    blob = serialize(Bitmap.from_bits(
        [r * SHARD_WIDTH + int(c) for r, cs in r_cols.items() for c in cs]))
    st, _, body = http_raw(srv.uri, "POST",
                           "/index/b/field/r/import-roaring/0", blob)
    if st != 200 or json.loads(body) != {"changed": 100}:
        raise AssertionError(f"import-roaring: {st} {body[:200]}")
    want = len(np.union1d(r_cols[1], r_cols[2]))
    check("b", "Count(Union(Row(r=1), Row(r=2)))", want, 1, 0)
    log(f"serve: import-roaring of 100 bits into b's r, shard 0, then "
        f"Count(Union(Row(r=1), Row(r=2))) = {want} (one K1 launch)")

    # GET /export of f, shard 0 (not a shard an earlier Set wrote)
    t0 = time.perf_counter()
    st, ctype, body = http_raw(srv.uri, "GET",
                               "/export?index=b&field=f&shard=0")
    dt = time.perf_counter() - t0
    want = csv_lines({r: plane_columns(
        planes[("f", r)] if b_rows[r] is None else b_rows[r][0], 0)
        for r in b_rows})
    if st != 200 or ctype != "text/csv" \
            or body.decode().splitlines() != want:
        raise AssertionError(f"export: {st} {ctype} {body[:200]}")
    log(f"serve: GET /export index b field f shard 0 = numpy: {len(want)} "
        f"lines, {len(body)} bytes in {dt * 1e3:.1f} ms")

    # DELETE h, re-create it, import other bits: only they count
    st, _, body = http_raw(srv.uri, "DELETE", "/index/b/field/h")
    if st != 200:
        raise AssertionError(f"DELETE field h: {st} {body[:200]}")
    http(srv.uri, "/index/b/field/h", "{}")
    cols = [5, 3 * SHARD_WIDTH + 7, (N_SHARDS - 1) * SHARD_WIDTH + 9]
    http(srv.uri, "/index/b/field/h/import",
         json.dumps({"rowIDs": [1, 1, 2], "columnIDs": cols}))
    check("b", "Count(Union(Row(h=1), Row(h=2)))", 3, 1, 0)
    log("serve: DELETE field h, re-create, import 3 bits, then "
        "Count(Union(Row(h=1), Row(h=2))) = 3 (one K1 launch, no stale "
        "stack)")

    # row and column attributes, columnAttrs=true
    http(srv.uri, "/index/b/query",
         f'SetRowAttrs(h, 1, color="red") SetColumnAttrs({cols[1]}, '
         f'name="x")')
    got, _ = query("b", "Row(h=1)", 0, 0, "?columnAttrs=true")
    want = {"results": [{"attrs": {"color": "red"}, "columns": cols[:2]}],
            "columnAttrs": [{"id": cols[1], "attrs": {"name": "x"}}]}
    if got != want:
        raise AssertionError(f"columnAttrs: {got} != {want}")
    log(f"serve: Row(h=1)?columnAttrs=true = {json.dumps(got)}")

    # keyed index: import with row and column keys, Row, TopN, export
    http(srv.uri, "/index/kx", json.dumps({"options": {"keys": True}}))
    http(srv.uri, "/index/kx/field/kf",
         json.dumps({"options": {"keys": True}}))
    http(srv.uri, "/index/kx/field/kf/import", json.dumps({
        "rowKeys": ["red", "blue", "red", "green"],
        "columnKeys": ["c1", "c2", "c3", "c4"]}))
    for pql, want, k3_n in (
            ('Row(kf="red")', {"attrs": {}, "columns": [],
                               "keys": ["c1", "c3"]}, 0),
            ("TopN(kf)", [{"id": 0, "count": 2, "key": "red"},
                          {"id": 0, "count": 1, "key": "blue"},
                          {"id": 0, "count": 1, "key": "green"}], 1)):
        check("kx", pql, want, 0, k3_n)
    st, _, body = http_raw(srv.uri, "GET",
                           "/export?index=kx&field=kf&shard=0")
    want = ["red,c1", "red,c3", "blue,c2", "green,c4"]
    if st != 200 or body.decode().splitlines() != want:
        raise AssertionError(f"keyed export: {st} {body[:200]}")
    log("serve: keyed index kx: import by keys, Row, TopN and export = "
        "expected")
    st, _, body = http_raw(srv.uri, "DELETE", "/index/kx")
    if st != 200:
        raise AssertionError(f"DELETE index kx: {st} {body[:200]}")
    log(f"serve: launches on the PQL/HTTP surface path: K1 "
        f"{k1.count_expr.launches}, K3 {k3.row_counts.launches}")


def cli(*argv, timeout=600):
    """`python -m pilosa_tpu_torch <argv>` from the checkout, as a user
    runs it; returns (wall seconds, stdout). A non-zero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv[:2])}: rc {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return wall, proc.stdout


class ServerProcess:
    """`python -m pilosa_tpu_torch server` as a child process on a fixed
    port and data directory, its output in `log_path`."""

    def __init__(self, argv, port, log_path):
        self.argv = list(argv)
        self.port = port
        self.uri = f"http://127.0.0.1:{port}"
        self.log_path = log_path
        self.proc = None
        self.mark = 0  # where the log of the running process starts

    def start(self, timeout=300):
        """Spawn and wait for the "listening" line; returns (seconds from
        spawn to that line, the line)."""
        with open(self.log_path, "a") as out:
            mark = self.mark = out.tell()
            t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch", "server",
                 *self.argv, "--bind", f"127.0.0.1:{self.port}"],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        while time.perf_counter() - t0 < timeout:
            for line in self.log()[mark:].splitlines():
                if line.startswith("listening on "):
                    return time.perf_counter() - t0, line
            if self.proc.poll() is not None:
                raise AssertionError(f"server exited rc "
                                     f"{self.proc.returncode}: "
                                     f"{self.log()[-2000:]}")
            time.sleep(0.05)
        raise AssertionError(f"server not up in {timeout} s: "
                             f"{self.log()[-2000:]}")

    def log(self):
        with open(self.log_path) as f:
            return f.read()

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def concurrently(*fns):
    """Run each function in a thread of its own; returns their results
    in order and re-raises the first error."""
    results, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def timed(fn, *args, **kwargs):
    """(seconds, result) of one call."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return time.perf_counter() - t0, out


def serve_tools(srv, k1, planes, comp, card):
    """The command line and the durable imports against a second server,
    a `python -m pilosa_tpu_torch server` child on the card over a fresh
    data directory (max-op-n 10000, fsync always): a CSV `import` of
    TOOLS_RECORDS (row, column) bits and TOOLS_VALUES values; a clean
    restart (its shutdown checkpoints the oplog), then a crash at
    import.post-append and a restart that replays that one record;
    `backup` of index b from `srv` and `restore` of its field f into the
    child, `backup` of the imported index from the child and `restore`
    into `srv`; `export`, then, with the child stopped, `check` on every
    fragment file of its directory and `inspect` on one. Every answer
    against numpy, and K1's launches on `srv` +1 per Count. Steps that
    touch different processes run at once (the b backup beside the
    clean restart; the b restore into the child beside the imported
    index's backup and restore; the child's shutdown beside the Counts
    on `srv`; `check` in four processes); each line says so, and every
    line carries the seconds since the phase began."""
    from pilosa_tpu_torch.server import Client
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    device = srv.api.device.type
    work = tempfile.mkdtemp(prefix="pilosa-torch-smoke-tools-")
    t_phase = time.perf_counter()

    def tlog(msg):
        log(f"tools: [{time.perf_counter() - t_phase:.1f} s] {msg}")

    try:
        config = os.path.join(work, "tools.toml")
        with open(config, "w") as f:
            f.write('max-op-n = 10000\n\n[storage]\nfsync = "always"\n')
        data = os.path.join(work, "data")
        child = ServerProcess(
            ["--device", device, "--config", config, "--data-dir", data],
            free_port(), os.path.join(work, "server.log"))
        try:
            boot, line = child.start()
            if f"(device {device}" not in line:
                raise AssertionError(f"child server: {line!r}")
            tlog(f"child server {line!r} in {boot:.2f} s")
            c = Client(child.uri, timeout=600)

            # CSV import of set bits and int values over the CLI
            rng = np.random.default_rng(SEED)
            n_cols = N_SHARDS * SHARD_WIDTH
            rows = rng.integers(1, 5, TOOLS_RECORDS)
            cols = rng.integers(0, n_cols, TOOLS_RECORDS)
            f_csv = os.path.join(work, "f.csv")
            with open(f_csv, "w") as f:
                f.write("".join(f"{r},{c_}\n" for r, c_ in
                                zip(rows.tolist(), cols.tolist())))
            # one value per column of the first TOOLS_VALUES column ids,
            # in a random order: the ids key translation hands out
            v_cols = rng.permutation(TOOLS_VALUES)
            v_vals = rng.integers(0, 1_000_001, TOOLS_VALUES)
            v_csv = os.path.join(work, "v.csv")
            with open(v_csv, "w") as f:
                f.write("".join(f"{c_},{v}\n" for c_, v in
                                zip(v_cols.tolist(), v_vals.tolist())))
            # one request: the server's cost grows with the containers a
            # request touches, and 100,000 records already touch most of
            # them
            wall, out = cli("import", "--host", child.uri, "--index", "imp",
                            "--field", "f", "--create", "--batch-size",
                            str(TOOLS_RECORDS), f_csv)
            tlog(f"import of {TOOLS_RECORDS} (row, column) records into "
                 f"imp/f over {N_SHARDS} shards: {wall:.2f} s, "
                 f"{TOOLS_RECORDS / wall:.0f} records/s ({out.strip()}); "
                 f"fsync always; card {card}")
            wall, out = cli("import", "--host", child.uri, "--index", "imp",
                            "--field", "v", "--create", "--field-type",
                            "int", "--min", "0", "--max", "1000000", v_csv)
            tlog(f"import of {TOOLS_VALUES} values into imp/v: {wall:.2f} "
                 f"s, {TOOLS_VALUES / wall:.0f} records/s")

            # a clean stop checkpoints the log, so the next boot replays
            # nothing; beside it, index b's backup from srv
            def restart():
                child.stop()
                return child.start()

            b_tar = os.path.join(work, "b.tar")
            (boot, _), (wall_b, out) = concurrently(
                restart, lambda: cli("backup", "--host", srv.uri, "--index",
                                     "b", "--output", b_tar))
            if "oplog: replayed" in child.log()[child.mark:]:
                raise AssertionError(f"replay after a clean stop: "
                                     f"{child.log()[-2000:]}")
            n_frags = int(out.split(", ")[1].split()[0])
            tlog(f"clean stop and restart, nothing replayed, in {boot:.2f} "
                 f"s (spawn to listening); beside it, backup of index b "
                 f"({N_SHARDS} shards) from the first server: {wall_b:.2f} "
                 f"s, {os.path.getsize(b_tar)} bytes, {n_frags} fragments, "
                 f"{n_frags / wall_b:.1f} fragments/s; card {card}")

            # a crash between the oplog append and the apply, on the card
            sets = {r: set(cols[rows == r].tolist()) for r in range(1, 5)}
            crash_col = n_cols - 1
            while crash_col in sets[1]:
                crash_col -= 1
            c._request("POST", "/debug/faultpoints", json.dumps(
                {"arm": "import.post-append=exit"}).encode())
            try:
                c.import_bits("imp", "f", [1], [crash_col])
            except Exception:  # the server died mid-request: no ack
                pass
            else:
                raise AssertionError("import at import.post-append=exit "
                                     "was acknowledged")
            rc = child.proc.wait(timeout=60)
            if rc != 86:
                raise AssertionError(f"child exited rc {rc}, not 86")
            boot, line = child.start()
            if "oplog: replayed 1 record(s)" not in child.log()[child.mark:]:
                raise AssertionError(f"no replay: {child.log()[-2000:]}")
            tlog(f"crash at import.post-append (rc 86), restart with "
                 f"replay of 1 record in {boot:.2f} s (spawn to listening)")
            sets[1].add(crash_col)
            want = {
                "Count(Row(f=1))": len(sets[1]),
                "Count(Intersect(Row(f=1), Row(f=2)))":
                    len(sets[1] & sets[2]),
                "Sum(field=v)": {"value": int(v_vals.sum()),
                                 "count": TOOLS_VALUES},
            }
            for pql, w in want.items():
                dt, got = timed(c.query, "imp", pql)
                if got["results"][0] != w:
                    raise AssertionError(f"child {pql}: {got} != {w}")
                tlog(f"child {pql} = {w} (numpy, the replayed bit "
                     f"included; {dt * 1e3:.1f} ms)")

            # The restore into the child is cut to index b's field f (the
            # archive's other fields' fragments dropped; the schema kept):
            # on an H100's host the whole index takes 44-50 s to restore,
            # which with two boots of the child passes the phase's 150 s.
            # Beside it, the imported index's backup from the child and
            # restore into srv.
            bf_tar = os.path.join(work, "b_f.tar")
            with tarfile.open(b_tar) as src, tarfile.open(bf_tar, "w") as dst:
                for m in src:
                    if m.name == "schema.json" or m.name.startswith("b/f/"):
                        dst.addfile(m, src.extractfile(m))
            os.unlink(b_tar)
            with tarfile.open(bf_tar) as t:
                n_f = len(t.getmembers()) - 1
            imp_tar = os.path.join(work, "imp.tar")

            def imp_round_trip():
                back = cli("backup", "--host", child.uri, "--index", "imp",
                           "--output", imp_tar)
                return back, cli("restore", "--host", srv.uri, "--input",
                                 imp_tar)

            (wall_r, _), ((wall_ib, out), (wall_ir, _)) = concurrently(
                lambda: cli("restore", "--host", child.uri, "--input",
                            bf_tar), imp_round_trip)
            tlog(f"restore of index b's field f ({n_f} fragments, "
                 f"{os.path.getsize(bf_tar)} bytes) into the child (fsync "
                 f"always): {wall_r:.2f} s, {n_f / wall_r:.1f} fragments/s; "
                 f"beside it, imp backed up from the child in {wall_ib:.2f} "
                 f"s ({os.path.getsize(imp_tar)} bytes; {out.strip()}) and "
                 f"restored into the first server in {wall_ir:.2f} s")
            os.unlink(bf_tar)
            # + 1: the Count path's Set (f=1) and the compressed path's
            # (f=10), each of a bit that was clear
            b_want = {
                "Count(Row(f=1))": N_SHARDS * popcount(planes[("f", 1)]) + 1,
                "Count(Row(f=10))": popcount(comp[("f", 10)]) + 1,
                "Count(Row(f=20))": popcount(comp[("f", 20)]),
            }
            for pql, w in b_want.items():
                here = http(srv.uri, "/index/b/query", pql)["results"][0]
                dt, there = timed(c.query, "b", pql)
                if not here == there["results"][0] == w:
                    raise AssertionError(f"{pql}: first server {here}, "
                                         f"restored {there}, numpy {w}")
                tlog(f"restored b: {pql} = {w} (first server and numpy; "
                     f"{dt * 1e3:.1f} ms cold in the child)")
            unions = {
                "Count(Union(Row(f=1), Row(f=2)))": len(sets[1] | sets[2]),
                "Count(Intersect(Row(f=1), Union(Row(f=2), Row(f=3))))":
                    len(sets[1] & (sets[2] | sets[3])),
                "Count(Union(Row(f=1), Row(f=2), Row(f=3), Row(f=4)))":
                    len(set().union(*sets.values())),
            }
            for pql, w in unions.items():
                there = c.query("imp", pql)["results"][0]
                if there != w:
                    raise AssertionError(f"child {pql}: {there} != {w}")

            # export of imp/f over the CLI
            wall, out = cli("export", "--host", child.uri, "--index", "imp",
                            "--field", "f")
            n_bits = sum(len(s) for s in sets.values())
            if len(out.splitlines()) != n_bits:
                raise AssertionError(f"export: {len(out.splitlines())} "
                                     f"lines, {n_bits} distinct bits")
            tlog(f"export of imp/f: {n_bits} lines (the CSV's distinct "
                 f"bits and the replayed one) in {wall:.2f} s")

            # the restored imp on srv (one K1 launch a Count), beside the
            # child's shutdown
            def restored_imp():
                for pql, w in unions.items():
                    before = k1.count_expr.launches
                    dt, here = timed(http, srv.uri, "/index/imp/query", pql)
                    if k1.count_expr.launches != before + 1:
                        raise AssertionError(
                            f"{pql}: K1 launches moved by "
                            f"{k1.count_expr.launches - before}, not 1")
                    if here["results"][0] != w:
                        raise AssertionError(f"{pql}: restored {here}, "
                                             f"child and numpy {w}")
                    tlog(f"restored imp: {pql} = {w} (child and numpy; one "
                         f"K1 launch; {dt * 1e3:.1f} ms)")
                here = http(srv.uri, "/index/imp/query",
                            "Sum(field=v)")["results"][0]
                if here != want["Sum(field=v)"]:
                    raise AssertionError(f"restored Sum(field=v): {here}")

            concurrently(child.stop, restored_imp)
        finally:
            child.stop()
        frags = [os.path.join(root, fn)
                 for root, _, files in os.walk(data)
                 for fn in files if fn.isdigit()]
        t0 = time.perf_counter()
        outs = concurrently(*[
            (lambda part=frags[i::4]: cli("check", *part)[1])
            for i in range(4)])
        wall = time.perf_counter() - t0
        if sum(o.count(": ok") for o in outs) != len(frags):
            raise AssertionError(f"check: {[o[-500:] for o in outs]}")
        one = os.path.join(data, "imp", "f", "views", "standard",
                           "fragments", "0")
        _, out = cli("inspect", one)
        if "row 1:" not in out:
            raise AssertionError(f"inspect: {out[-2000:]}")
        tlog(f"check of {len(frags)} fragment files of the stopped child "
             f"(four processes): all ok in {wall:.2f} s; inspect {one}: "
             f"{out.splitlines()[2]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tlog(f"phase done; K1 launches on the first server "
         f"{k1.count_expr.launches}; card {card}")


def serve_bsi_path(srv, k1, k3, k5, br, card):
    """BASELINE config 4 over HTTP, every result against numpy."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    cols, vals, months = br["cols"], br["vals"].copy(), br["months"]
    n_rows = br["depth"] + 2
    rng = np.random.default_rng(BR_SEED + 1)
    thresholds = [int(t) for t in rng.integers(0, 1 << 20, size=8)]
    jan_feb = months < 2
    time_row = f"Row(t=0, {BR_JAN_FEB})"
    sum_pql = f"Sum({time_row}, field=v)"

    def query(pql, k1_step, k3_step, k5_step):
        before = (k1.count_expr.launches, k3.row_counts.launches,
                  k5.bsi_range_mask.launches)
        t0 = time.perf_counter()
        got = http(srv.uri, "/index/br/query", pql)["results"][0]
        dt = time.perf_counter() - t0
        moved = (k1.count_expr.launches - before[0],
                 k3.row_counts.launches - before[1],
                 k5.bsi_range_mask.launches - before[2])
        if moved != (k1_step, k3_step, k5_step):
            raise AssertionError(f"{pql}: launches (K1, K3, K5) moved by "
                                 f"{moved}, not {(k1_step, k3_step, k5_step)}")
        return got, dt

    def check(pql, want, steps):
        got, dt = query(pql, *steps)
        if got != want:
            raise AssertionError(f"{pql}: {got} != {want}")
        return dt

    def sum_want():
        sel = vals[jan_feb]
        return {"value": int(sel.sum()), "count": int(sel.size)}

    def extreme(fn):
        sel = vals[jan_feb]
        best = int(fn(sel))
        return {"value": best, "count": int(np.sum(sel == best))}

    cold = {}
    for i, t in enumerate(thresholds):
        pql = f"Count(Row(v > {t}))"
        dt = check(pql, int(np.sum(vals > t)), (1, 0, 1))
        if i == 0:
            cold["range"] = dt
        log(f"serve: {pql} = {int(np.sum(vals > t))} ({dt * 1e3:.1f} ms)")
    cold["sum"] = check(sum_pql, sum_want(), (0, 3, 0))
    x = int(vals[12345])
    lo, hi = 200_000, 700_000
    n_eq = int(np.sum(vals == x))
    for pql, want, steps in (
            (f"Min({time_row}, field=v)", extreme(np.min), (0, 1, 0)),
            (f"Max({time_row}, field=v)", extreme(np.max), (0, 1, 0)),
            (f"Count(Row(v == {x}))", n_eq, (1, 0, 1)),
            (f"Count(Row(v != {x}))", int(vals.size) - n_eq, (1, 0, 1)),
            (f"Count(Row(v >< [{lo}, {hi}]))",
             int(np.sum((vals >= lo) & (vals <= hi))), (1, 0, 2)),
            (f"Count(Intersect(Row(v > {thresholds[0]}), {time_row}))",
             int(np.sum((vals > thresholds[0]) & jan_feb)), (1, 0, 1))):
        dt = check(pql, want, steps)
        log(f"serve: {pql} = {json.dumps(want)} ({dt * 1e3:.1f} ms)")
    log(f"serve: {sum_pql} = {json.dumps(sum_want())} (cold "
        f"{cold['sum'] * 1e3:.1f} ms)")

    # writes: 1,000 imported values over two shards and one Set in a
    # third; the next query patches those three shards' planes in place
    stats = srv.api.executor.stacked_stats()
    n = BR_VALUES_PER_SHARD
    first, second, third = (BR_SHARDS // 25, BR_SHARDS * 3 // 5,
                            BR_SHARDS * 4 // 5)
    sel = np.concatenate([np.arange(first * n, first * n + 500),
                          np.arange(second * n, second * n + 500)])
    new_vals = rng.integers(0, 1 << 20, size=sel.size)
    out = http(srv.uri, "/index/br/field/v/import", json.dumps(
        {"columnIDs": cols[sel].tolist(), "values": new_vals.tolist()}))
    if out.get("changed", 0) < 1:
        raise AssertionError(f"import of values: {out}")
    vals[sel] = new_vals
    taken = set(cols[third * n:(third + 1) * n].tolist())
    col = next(c for c in range(third * SHARD_WIDTH,
                                (third + 1) * SHARD_WIDTH) if c not in taken)
    set_val = 777_777
    ok = http(srv.uri, "/index/br/query", f"Set({col}, v={set_val})")
    if ok["results"] != [True]:
        raise AssertionError(f"Set({col}, v={set_val}) -> {ok}")
    # the Set column has a value and no t bit
    vals = np.append(vals, set_val)
    jan_feb = np.append(jan_feb, False)
    dt = check(sum_pql, sum_want(), (0, 3, 0))
    after = srv.api.executor.stacked_stats()
    uploaded = after["planes_uploaded"] - stats["planes_uploaded"]
    if uploaded != n_rows * 3 or after["patches"] <= stats["patches"]:
        raise AssertionError(
            f"writes in 3 shards: {uploaded} planes uploaded (want "
            f"{n_rows} x 3), patches {stats['patches']} -> "
            f"{after['patches']}")
    n_set = int(np.sum(vals == set_val))
    check(f"Count(Row(v == {set_val}))", n_set, (1, 0, 1))
    log(f"serve: import of 1000 values + Set({col}, v={set_val}) then "
        f"{sum_pql} reads them back ({dt * 1e3:.1f} ms; {uploaded} planes "
        f"uploaded = {n_rows} x 3 shards, patched in place) and "
        f"Count(Row(v == {set_val})) = {n_set}")

    warm = {"range": [], "sum": []}
    range_pql = f"Count(Row(v > {thresholds[0]}))"
    range_want = int(np.sum(vals > thresholds[0]))
    want = sum_want()
    for _ in range(60):
        warm["range"].append(check(range_pql, range_want, (1, 0, 1)))
        warm["sum"].append(check(sum_pql, want, (0, 3, 0)))
    for name, pql in (("range", "Count(Row(v > t))"), ("sum", sum_pql)):
        log(f"serve: {pql} over {BR_SHARDS} shards on {card}: cold "
            f"{cold[name] * 1e3:.3f} ms, warm p50 "
            f"{statistics.median(warm[name]) * 1e3:.3f} ms over "
            f"{len(warm[name])} queries")
    log(f"serve: launches on the BSI path: K5 {k5.bsi_range_mask.launches}, "
        f"K1 {k1.count_expr.launches}, K3 {k3.row_counts.launches}")
    return sum_pql, want  # the Sum and its numpy answer after the writes


OBSERVE_PROFILED = 20  # ?profile=true warm queries per path
OBSERVE_TRACED = 10  # warm queries per path under one torch.profiler trace


def _walk_spans(node):
    yield node
    for child in node["children"]:
        yield from _walk_spans(child)


def _device_busy(torch, fn, n, counter):
    """(device ms, wall ms, ops, launches) of `n` calls of fn under one
    torch.profiler (CUPTI) trace: every device operation's time (kernels,
    memsets, copies) summed, over the wall of the n calls and a final
    sync; ops lists (name, count, ms) of every operation, longest first;
    launches is how far `counter` (a kernel wrapper's launch count)
    moved meanwhile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = counter.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [(e.key, e.count, (getattr(e, "device_time_total", 0.0)
                             or getattr(e, "cuda_time_total", 0.0)) / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda o: -o[2])
    return sum(o[2] for o in ops), wall * 1e3, ops, \
        counter.launches - before


def _dispatch_pairs(events):
    """Check the ring's dispatch.start / dispatch.end events pair up per
    kernel family, in order; returns the number of complete pairs."""
    open_, pairs = {}, 0
    for e in events:
        if e["kind"] == "dispatch.start":
            open_[e["tags"]["kernel"]] = open_.get(e["tags"]["kernel"], 0) + 1
        elif e["kind"] == "dispatch.end":
            k = e["tags"]["kernel"]
            if open_.get(k, 0) > 0:  # the ring may have cut a start off
                open_[k] -= 1
                pairs += 1
    if any(open_.values()):
        raise AssertionError(f"flight recorder: dispatches never ended: "
                             f"{open_}")
    return pairs


def serve_observe(srv, torch, k1, k3, planes, tg, tg_set, bsi_sum, card):
    """The observability phase over the served Count (index b, K1),
    config 3's TopN (index tg, K3) and config 4's Sum (index br, K3),
    through HTTP on the main server (started with --watchdog-deadline):
    per path, 20 ?profile=true warm queries give the host split of a warm
    query (client wall, the profile's root span, executor.Execute, the
    dispatch lock wait, each dispatch phase, kernel wall) as medians,
    and one torch.profiler trace of 10 warm queries the device's busy
    share. Checks: every answer against numpy, /metrics carries the
    card's memory gauge, /debug/dispatch's count family grew by exactly
    the K1 launches of the phase, the flight recorder holds
    dispatch.start/end pairs, and the watchdog never tripped."""
    from pilosa_tpu_torch.utils import flightrec
    from pilosa_tpu_torch.utils.stats import registry_of

    want_count = N_SHARDS * popcount(planes[("f", 2)] & planes[("g", 2)])
    want_topn = [dict(p) for p in topn_expect(tg)["TopN(f, n=10)"]]
    for p in want_topn:
        if p["id"] == tg_set[0]:
            p["count"] += 1
    sum_pql, want_sum = bsi_sum
    # (name, index, query, numpy answer, the launch counter of its
    # kernel, that kernel's names in a trace)
    k1_names = ("count_chain_kernel", "count_tree_kernel")
    paths = (("Count", "b", "Count(Intersect(Row(f=2), Row(g=2)))",
              want_count, k1.count_expr, k1_names),
             ("TopN", "tg", "TopN(f, n=10)", want_topn, k3.row_counts,
              ("row_counts_kernel",)),
             ("Sum", "br", sum_pql, want_sum, k3.row_counts,
              ("row_counts_kernel",)))
    wd = flightrec.get_watchdog()
    if wd is None:
        raise AssertionError("observe: the server runs no watchdog")

    def count_lock_waits():
        phases = http(srv.uri, "/debug/dispatch")["phases"]
        return phases.get("count", {}).get("lock_wait", {}).get("count", 0)

    k1_before, lw_before = k1.count_expr.launches, count_lock_waits()
    reg = registry_of(srv.http.stats)
    report = {}
    for name, index, pql, want, counter, knames in paths:
        path = f"/index/{index}/query"

        def run(query_path=path, pql=pql, want=want):
            t = time.perf_counter()
            out = http(srv.uri, query_path, pql)
            dt = time.perf_counter() - t
            if out["results"][0] != want:
                raise AssertionError(f"observe: {pql}: "
                                     f"{out['results'][0]} != {want}")
            return out, dt

        for _ in range(5):  # warm-up
            run()
        plain = [run()[1] for _ in range(OBSERVE_PROFILED)]
        key = ("http_request_seconds", (
            ("method", "POST"), ("route", "/index/(?P<index>[^/]+)/query"),
            ("status", "200")))
        time.sleep(0.05)  # the last request's timing lands after its reply
        h0 = reg.timing_summary("http_request_seconds").get(key, (0, 0.0))
        rows = []
        for _ in range(OBSERVE_PROFILED):
            out, dt = run(path + "?profile=true")
            prof = out["profile"]
            tags = prof["tags"]
            execute = [s["duration"] for s in _walk_spans(prof["spans"])
                       if s["name"] == "executor.Execute"]
            phases = {k[len("phase_"):-len("_seconds")]: v
                      for k, v in tags.items() if k.startswith("phase_")}
            if abs(sum(phases.values()) - tags["kernel_wall_seconds"]) \
                    > 1e-9:
                raise AssertionError(f"observe: {pql}: phases {phases} do "
                                     f"not sum to the kernel wall")
            rows.append({"http_client": dt, "api_query": prof["duration"],
                         "executor": execute[0],
                         "lock_wait": tags["dispatch_lock_wait_seconds"],
                         "kernel_wall": tags["kernel_wall_seconds"],
                         "launches": tags["locked_dispatches"],
                         **{f"phase_{k}": v for k, v in phases.items()}})
        time.sleep(0.05)
        h1 = reg.timing_summary("http_request_seconds")[key]
        med = {k: statistics.median(r.get(k, 0.0) for r in rows)
               for k in rows[0]}
        med["http_server_mean"] = (h1[1] - h0[1]) / (h1[0] - h0[0])
        med["http_client_unprofiled"] = statistics.median(plain)
        dev_ms, wall_ms, ops, launched = _device_busy(
            torch, run, OBSERVE_TRACED, counter)
        # the trace may hold fewer of the kernel's launches than its
        # wrapper counted; then the kernel's mean time per traced launch
        # stands in for the launches the trace lacks
        kern = [(c, ms) for k, c, ms in ops if any(n in k for n in knames)]
        caught = sum(c for c, _ in kern)
        kern_ms = sum(ms for _, ms in kern)
        scaled_ms = dev_ms - kern_ms + (kern_ms / caught * launched
                                        if caught else 0.0)
        med["device_ms"], med["trace_wall_ms"] = dev_ms, wall_ms
        med["busy_share"] = dev_ms / wall_ms
        med["kernel_launches"], med["kernel_launches_traced"] = \
            launched, caught
        med["busy_share_scaled"] = scaled_ms / wall_ms
        report[name] = med
        ms = {k: v * 1e3 for k, v in med.items()
              if k not in ("launches", "busy_share", "device_ms",
                           "trace_wall_ms", "kernel_launches",
                           "kernel_launches_traced", "busy_share_scaled")}
        log(f"observe: {name} {pql} over index {index} on {card}, medians "
            f"of {OBSERVE_PROFILED} ?profile=true warm queries (ms): HTTP "
            f"request (client wall) {ms['http_client']:.3f} "
            f"[server http_request_seconds mean "
            f"{ms['http_server_mean']:.3f}; unprofiled client wall "
            f"{ms['http_client_unprofiled']:.3f}]; api query (profile "
            f"root) {ms['api_query']:.3f}; executor.Execute "
            f"{ms['executor']:.3f}; dispatch_lock_wait "
            f"{ms['lock_wait']:.4f}; "
            + "; ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items())
                        if k.startswith("phase_"))
            + f"; kernel_wall {ms['kernel_wall']:.4f} over "
            f"{med['launches']:.0f} locked launches; so HTTP + transport "
            f"{ms['http_client'] - ms['api_query']:.3f}, parse + API "
            f"{ms['api_query'] - ms['executor']:.3f}, executor host "
            f"{ms['executor'] - ms['kernel_wall'] - ms['lock_wait']:.3f}")
        log(f"observe: {name} device busy share on {card}: "
            f"{dev_ms:.3f} ms of device operations over {wall_ms:.3f} ms "
            f"wall of {OBSERVE_TRACED} warm queries (one torch.profiler "
            f"trace) = {100 * med['busy_share']:.2f} %; the trace holds "
            f"{caught} of the {launched} launches its kernel's wrapper "
            f"counted, so with each missing launch at the traced mean: "
            f"{scaled_ms:.3f} ms = {100 * med['busy_share_scaled']:.2f} %; "
            "longest: "
            + "; ".join(f"{k[:60]} x{c} {ms:.3f} ms" for k, c, ms in ops[:4]))

    k1_moved = k1.count_expr.launches - k1_before
    lw_moved = count_lock_waits() - lw_before
    if lw_moved != k1_moved or k1_moved < OBSERVE_PROFILED:
        raise AssertionError(f"observe: /debug/dispatch count family grew "
                             f"by {lw_moved}, K1 launched {k1_moved}")
    text = urllib.request.urlopen(srv.uri + "/metrics", timeout=60).read()
    deadline = time.time() + 30
    while True:  # the runtime sampler runs every 10 s
        m = re.search(rb'^pilosa_tpu_device_memory_bytes\{device="cuda:0"\}'
                      rb" (\S+)$", text, re.M)
        if m or time.time() > deadline:
            break
        time.sleep(1)
        text = urllib.request.urlopen(srv.uri + "/metrics",
                                      timeout=60).read()
    if not m or float(m.group(1)) <= 0:
        raise AssertionError("observe: /metrics has no "
                             'device_memory_bytes{device="cuda:0"} > 0')
    ring = http(srv.uri, "/debug/flightrecorder?limit=400")["events"]
    pairs = _dispatch_pairs(ring)
    if pairs < 1:
        raise AssertionError("observe: no dispatch.start/end pair in the "
                             "flight recorder")
    stalls = [e for e in http(srv.uri, "/debug/flightrecorder")["events"]
              if e["kind"] == "watchdog.stall"]
    if wd.stalls or stalls or b"pilosa_tpu_watchdog_stalls" in text:
        raise AssertionError(f"observe: the watchdog tripped: {stalls[:3]}")
    log(f"observe: checks passed: count family +{lw_moved} lock waits = "
        f"K1 +{k1_moved} launches; device_memory_bytes{{cuda:0}} "
        f"{float(m.group(1)):.0f}; {pairs} dispatch.start/end pairs in the "
        f"last 400 events; watchdog ({wd.deadline:.0f} s) stalls 0")
    log("observe-json: " + json.dumps(
        {"card": card, "paths": report}, sort_keys=True))


def serve_compressed_path(srv, k1, k2, planes, comp, set_at, card):
    """Counts over index b's compressible rows under the auto chooser,
    every result against numpy and every launch delta exact. Returns the
    served f=10 and g=10 containers (for timing K2 on them)."""
    from pilosa_tpu_torch.ops import containers
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    f10, f11, g10 = comp[("f", 10)], comp[("f", 11)], comp[("g", 10)]
    f20, g20 = comp[("f", 20)], comp[("g", 20)]
    # f=1 is one plane in every shard, plus the Count path's Set (bit 0
    # of word `word` in shard `shard`)
    shard, word = set_at
    f1_and_f11 = popcount(f11 & planes[("f", 1)][None, :]) + int(
        f11[shard, word] & 1)
    # (query, expected, K1 launches, K2 launches)
    cases = [
        ("Count(Row(f=10))", popcount(f10), 0, 1),
        ("Count(Intersect(Row(f=10), Row(g=10)))", popcount(f10 & g10), 0, 1),
        ("Count(Intersect(Row(f=10), Row(f=11), Row(g=10)))",
         popcount(f10 & f11 & g10), 0, 1),
        ("Count(Row(f=20))", popcount(f20), 0, 0),
        ("Count(Intersect(Row(f=20), Row(g=20)))", popcount(f20 & g20), 0, 0),
        ("Count(Union(Row(f=10), Row(g=20)))", popcount(f10 | g20), 1, 0),
        ("Count(Intersect(Row(f=1), Row(f=11)))", f1_and_f11, 1, 0),
    ]

    def query(pql, want, k1_step, k2_step):
        before = (k1.count_expr.launches, k2_launches(k2))
        t0 = time.perf_counter()
        got = http(srv.uri, "/index/b/query", pql)["results"][0]
        dt = time.perf_counter() - t0
        moved = (k1.count_expr.launches - before[0],
                 k2_launches(k2) - before[1])
        if moved != (k1_step, k2_step):
            raise AssertionError(f"{pql}: launches (K1, K2) moved by "
                                 f"{moved}, not {(k1_step, k2_step)}")
        if got != want:
            raise AssertionError(f"{pql}: {got} != {want}")
        return dt

    cold = {}
    for pql, want, k1_step, k2_step in cases:
        cold[pql] = query(pql, want, k1_step, k2_step)
        log(f"serve: {pql} = {want} (cold {cold[pql] * 1e3:.1f} ms; K1 "
            f"+{k1_step}, K2 +{k2_step})")

    st = srv.api.executor._stacked
    want_kinds = {("f", 10): "sparse", ("f", 11): "sparse",
                  ("g", 10): "sparse", ("f", 20): "rle", ("g", 20): "rle",
                  ("f", 1): "dense"}

    def resident():
        return {(k[2], k[3]): e[1] for k, e in st._pools["leaf"].items()
                if k[1] == "b" and (k[2], k[3]) in want_kinds}

    held = resident()
    kinds = {k: containers.kind_of(c) for k, c in held.items()}
    if kinds != want_kinds:
        raise AssertionError(f"leaf forms {kinds} != {want_kinds}")
    for (fname, row), c in sorted(held.items()):
        log(f"serve: leaf {fname}={row} resident as {c.kind}: {c.nbytes} "
            f"bytes on the card (dense {f10.nbytes} bytes)")

    warm = {}
    for name, (pql, want, k1_step, k2_step) in (
            ("K2 pair", cases[1]), ("rle pair", cases[4])):
        warm[name] = [query(pql, want, k1_step, k2_step) for _ in range(60)]
        log(f"serve: {pql} over {N_SHARDS} shards ({name}) on {card}: "
            f"cold {cold[pql] * 1e3:.3f} ms, warm p50 "
            f"{statistics.median(warm[name]) * 1e3:.3f} ms over 60 queries")

    # a Set in one shard of the sparse f=10 leaf: the next Count reads
    # it back through a patch that decays the leaf to dense (K1, not K2)
    served = (held[("f", 10)], held[("g", 10)])
    shard = N_SHARDS // 3
    word = int(np.nonzero(f10[shard] == 0)[0][0])
    col = shard * SHARD_WIDTH + word * 32
    patches = st.patches
    ok = http(srv.uri, "/index/b/query", f"Set({col}, f=10)")["results"]
    if ok != [True]:
        raise AssertionError(f"Set({col}, f=10) -> {ok}")
    dt = query("Count(Row(f=10))", popcount(f10) + 1, 1, 0)
    kind = containers.kind_of(resident()[("f", 10)])
    if st.patches != patches + 1 or kind != "dense":
        raise AssertionError(f"Set on sparse f=10: patches {patches} -> "
                             f"{st.patches}, leaf now {kind}")
    log(f"serve: Set({col}, f=10) then Count(Row(f=10)) = "
        f"{popcount(f10) + 1} (patched, leaf decayed sparse -> dense, "
        f"{dt * 1e3:.1f} ms)")
    log(f"serve: launches on the compressed path: K2 {k2_launches(k2)} "
        f"(count_blocks {k2.count_blocks.launches}, count_and_blocks "
        f"{k2.count_and_blocks.launches}), K1 {k1.count_expr.launches}")
    return served


def time_served_k2(torch, k2, served, card):
    """K2 on the served f=10 and g=10 containers: the fused pair (the
    served launch) and count_blocks of f=10. Returns the pair's timing."""
    (ids_a, blocks_a), (ids_b, blocks_b) = (c.arrays for c in served)
    fused_bytes, matched = k2_fused_bytes(ids_a, ids_b)
    args = (ids_a, blocks_a, ids_b, blocks_b)
    got = k2.count_and_blocks(*args)
    torch.cuda.synchronize()
    err = abs(int(got) - int(k2.count_and_blocks_reference(*args)))
    if err:
        raise AssertionError(f"K2 on the served pair: error {err}")
    bound_ms = fused_bytes / H100_BYTES_PER_S * 1e3
    one_bytes = blocks_a.numel() * 4 + 8
    out = None
    for name, fn, plain, nbytes in (
            (f"count_and_blocks on the served f=10 & g=10 (NB "
             f"{ids_a.shape[0]} and {ids_b.shape[0]}, {matched} matched "
             f"blocks)", lambda: k2.count_and_blocks(*args),
             lambda: k2.count_and_blocks_reference(*args), fused_bytes),
            ("count_blocks on the served f=10",
             lambda: k2.count_blocks(blocks_a),
             lambda: k2.count_blocks_reference(blocks_a), one_bytes)):
        # L2-warm: the same query back to back finds its 17 MB leaf in
        # the 50 MB L2; L2-cold: a query after others reads it from HBM
        warm_ms, call_ms, _ = kernel_ms(torch, fn, 50, "count_blocks_kernel")
        ms, _, how = kernel_ms(torch, fn, 50, "count_blocks_kernel",
                               cold_l2=True)
        plain_ms = time_cuda(torch, plain, 10)
        log(f"kernels: K2 {name} ({nbytes} bytes): {ms * 1e3:.2f} us/launch "
            f"({how}; {warm_ms * 1e3:.2f} us with the inputs in L2; "
            f"{call_ms * 1e3:.2f} us per call by events), bound "
            f"{nbytes / H100_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s, plain "
            f"{plain_ms * 1e3:.2f} us; card {card}")
        if out is None:
            out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes"}
    return err, out


def time_analyze(torch, planes, comp, card):
    """A cold leaf build's parts, timed on the dense f=1, the sparse f=10
    and the run-length f=20 954-shard leaves: the upload, the chooser's
    `analyze` on the card (its bit and block counts held to numpy, its
    run count to the two runs per shard of f=20), and the host builder
    of a compressed form."""
    from pilosa_tpu_torch.ops import containers

    dense = np.ascontiguousarray(np.broadcast_to(
        planes[("f", 1)], (N_SHARDS, planes[("f", 1)].shape[0])))
    for name, stack, want in (("f=1", dense, "dense"),
                              ("f=10", comp[("f", 10)], "sparse"),
                              ("f=20", comp[("f", 20)], "rle")):
        t0 = time.perf_counter()
        cont = containers.from_host("dense", stack.shape, (stack,), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = containers.analyze(cont.arrays[0])
        t2 = time.perf_counter()
        kind = containers.choose(info, *stack.shape, "auto")
        builder = {"sparse": containers._sparse_host,
                   "rle": containers._rle_host}.get(kind)
        if builder is not None:
            builder(stack)
        t3 = time.perf_counter()
        nonempty = int(stack.reshape(N_SHARDS, -1, 128).any(axis=2).sum())
        if (kind != want or info["bits"] != popcount(stack)
                or info["nonempty_blocks"] != nonempty
                or (name == "f=20" and info["runs"] != 2 * N_SHARDS)):
            raise AssertionError(f"analyze of {name}: {info}, picks {kind}")
        log(f"chooser: cold build of the {kind} leaf {name} ({stack.nbytes} "
            f"bytes, {N_SHARDS} shards) on {card}: upload {t1 - t0:.4f} s, "
            f"analyze on the card {t2 - t1:.4f} s ({info['runs']} runs, "
            f"{info['nonempty_blocks']} non-empty blocks), host builder "
            f"{t3 - t2:.4f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.cli import start_server
    from pilosa_tpu_torch.ops import bsi_range as k5
    from pilosa_tpu_torch.ops import count_blocks as k2
    from pilosa_tpu_torch.ops import count_expr as k1
    from pilosa_tpu_torch.ops import cuda_build
    from pilosa_tpu_torch.ops import pairwise as k4
    from pilosa_tpu_torch.ops import row_counts as k3
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

    if SHARD_WIDTH != 1 << 20:
        raise SystemExit(f"shard width {SHARD_WIDTH} != 2^20")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"device: {kind} | nvidia-smi: {card} | max SM clock {clock_mhz} "
        f"MHz, {sms} SMs | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    build_kernels(cuda_build)
    errs, timings = {}, {}
    errs["count_expr"], timings["count_expr"] = check_k1(
        torch, k1, WORDS_PER_ROW)
    t = timings["count_expr"]
    log(f"kernels: K1 at S={N_SHARDS}, 2 leaves ({t['bytes']} bytes): "
        f"{t['ms'] * 1e3:.2f} us/launch ({t['how']}; "
        f"{t['call_ms'] * 1e3:.2f} us per call by events), bound "
        f"{t['bound_ms'] * 1e3:.2f} us at 3.35 TB/s, plain version "
        f"{t['plain_ms'] * 1e3:.2f} us; card {card}")
    errs["row_counts"], timings["row_counts"] = check_k3(
        torch, k3, WORDS_PER_ROW)
    errs["pairwise_counts"], timings["pairwise_counts"] = check_k4(
        torch, k4, WORDS_PER_ROW, sms, clock_mhz * 1e6, card)
    errs["bsi_range"], timings["bsi_range"] = check_k5(
        torch, k5, k3, WORDS_PER_ROW, card)
    errs["count_blocks"] = check_k2(torch, k2, card)
    errs["count_expr_batch"], timings["count_expr_batch"] = check_k1_batch(
        torch, k1, WORDS_PER_ROW, card)
    log(f"kernels: {list(ENTRIES)}")

    mods = {"count_expr": k1.count_expr, "row_counts": k3.row_counts,
            "pairwise_counts": k4.pairwise_counts,
            "bsi_range": k5.bsi_range_mask,
            "count_blocks": k2.count_blocks,
            "count_and_blocks": k2.count_and_blocks,
            "count_expr_batch": k1.count_expr_batch}
    launches = {}
    tmp = tempfile.mkdtemp(prefix="pilosa-torch-smoke-")
    co_dir = tempfile.mkdtemp(prefix="pilosa-torch-smoke-co-")
    try:
        # configs 3 and 4 first: each writer opens a Holder on the
        # directory, and opening the 954-shard index alone takes about a
        # minute
        t0 = time.perf_counter()
        tg = build_topn_data(tmp)
        t1 = time.perf_counter()
        br = build_bsi_data(tmp)
        t2 = time.perf_counter()
        planes, comp = build_count_data(tmp, WORDS_PER_ROW)
        log(f"data: BASELINE config 3 over {TG_SHARDS} shards (index tg) "
            f"written in {t1 - t0:.1f} s; config 4 over {BR_SHARDS} shards "
            f"x {BR_VALUES_PER_SHARD} values (index br) in {t2 - t1:.1f} s; "
            f"{N_SHARDS} shards x 2 fields x 2 rows + 5 compressible rows "
            f"(index b) in {time.perf_counter() - t2:.1f} s")
        # index tg alone, before any write, for the coalescing server
        shutil.copytree(os.path.join(tmp, "tg"), os.path.join(co_dir, "tg"))
        t0 = time.perf_counter()
        srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", tmp,
                            "--device", "cuda", "--watchdog-deadline",
                            "60s"])
        log(f"serve: server up at {srv.uri} in "
            f"{time.perf_counter() - t0:.1f} s (holder open)")
        try:
            reset_counters(mods)  # the Count path's run starts here
            set_at = serve_count_path(srv, k1, planes, card)
            serve_tree_limits(srv, k1, tg, card)
            launches["count_expr"] = k1.count_expr.launches
            if k1.count_expr_batch.launches:
                raise AssertionError("a lone Count launched the batched "
                                     "entry on the Count path")
            reset_counters(mods)  # the batched paths' run starts here
            serve_batch_path(srv, k1, planes, set_at, card)
            serve_coalescer(srv, co_dir, card)
            launches["count_expr_batch"] = k1.count_expr_batch.launches
            reset_counters(mods)  # the TopN/GroupBy path's run starts here
            tg_set = serve_topn_path(srv, k3, k4, tg, card)
            launches["row_counts"] = k3.row_counts.launches
            launches["pairwise_counts"] = k4.pairwise_counts.launches
            reset_counters(mods)  # the BSI path's run starts here
            bsi_sum = serve_bsi_path(srv, k1, k3, k5, br, card)
            launches["bsi_range"] = k5.bsi_range_mask.launches
            reset_counters(mods)  # the observability phase starts here
            t0 = time.perf_counter()
            serve_observe(srv, torch, k1, k3, planes, tg, tg_set, bsi_sum,
                          card)
            log(f"observe: phase in {time.perf_counter() - t0:.1f} s")
            launches["count_expr"] += k1.count_expr.launches
            launches["row_counts"] += k3.row_counts.launches
            reset_counters(mods)  # the compressed path's run starts here
            served = serve_compressed_path(srv, k1, k2, planes, comp, set_at,
                                           card)
            launches["count_blocks"] = k2_launches(k2)
            err, timings["count_blocks"] = time_served_k2(
                torch, k2, served, card)
            errs["count_blocks"] = max(errs["count_blocks"], err)
            del served
            time_analyze(torch, planes, comp, card)
            reset_counters(mods)  # the PQL/HTTP surface path starts here
            t0 = time.perf_counter()
            serve_pql_surface(srv, k1, k3, planes, comp, tg, set_at, tg_set,
                              card)
            log(f"serve: PQL/HTTP surface phase in "
                f"{time.perf_counter() - t0:.1f} s")
            launches["count_expr"] += k1.count_expr.launches
            launches["row_counts"] += k3.row_counts.launches
            reset_counters(mods)  # the command-line tools' run starts here
            serve_tools(srv, k1, planes, comp, card)
            launches["count_expr"] += k1.count_expr.launches
        finally:
            srv.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(co_dir, ignore_errors=True)
    for name in ENTRIES:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")

    sources = {"count_expr": "pilosa_tpu/ops/pallas_kernels.py:141",
               "row_counts": "pilosa_tpu/ops/pallas_kernels.py:515",
               "pairwise_counts": "pilosa_tpu/ops/pallas_kernels.py:373",
               "bsi_range": "pilosa_tpu/ops/pallas_kernels.py:493",
               "count_blocks": "pilosa_tpu/ops/pallas_kernels.py:235",
               "count_expr_batch": "pilosa_tpu/ops/pallas_kernels.py:141, "
                                   "vmapped by pilosa_tpu/exec/stacked.py:1620"}
    log(card)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/"
                  f"{'count_expr' if name == 'count_expr_batch' else name}.cu",
        "replaces": sources[name],
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": timings[name]["ms"],
        "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"],
        "bound_by": timings[name]["bound_by"],
        "library_ms": None,
    } for name in ENTRIES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
