"""A/B of the served Count path between two checkouts on one CUDA card.

    python -m pilosa_tpu_torch.tools.ab_count --a DIR --b DIR \\
        [--rounds 20] [--queries 100]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the data and the numpy answers). It writes
chip_smoke.py's 1B-column index once (index b: 954 shards of 2^20
columns, fields f and g, rows 1 and 2, word density 0.05, seed 3),
copies it for each side, and starts `python -m pilosa_tpu_torch server
--device cuda` from each checkout, both on the same card. Each side
answers the four Count(Intersect(Row(f=a), Row(g=b))) queries once cold
and 20 more times to warm up. Then, in every round, the two sides take
turns, A first in even rounds and B first in odd ones, each answering
`queries` warm Counts over HTTP one at a time. It prints each round's
warm p50 per side, then per side the median of the round p50s and its
quartiles, and how many rounds B was faster. Every answer is checked
against numpy; any mismatch or failed server exits non-zero.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WARMUP = 20


def _start(checkout, data_dir, log_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(checkout)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--bind",
         "127.0.0.1:0", "--data-dir", data_dir, "--device", "cuda"],
        cwd=checkout, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    log.close()
    return proc


def _uri(proc, log_path):
    """The server's URI from its first line ("listening on URI ...")."""
    line = proc.stdout.readline()
    if not line.startswith("listening on "):
        proc.wait(timeout=60)
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"server failed (rc {proc.returncode}): "
                           f"{line!r}\n{tail}")
    return line.split()[2]


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_count")
    p.add_argument("--a", required=True, help="checkout of side A")
    p.add_argument("--b", required=True, help="checkout of side B")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--queries", type=int, default=100)
    args = p.parse_args(argv)

    import chip_smoke as cs
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    print(f"card: {cs.nvidia_smi('name,power.limit')}", flush=True)
    tmp = tempfile.mkdtemp(prefix="pilosa-torch-ab-")
    procs = []
    try:
        t0 = time.perf_counter()
        planes = cs.build_count_data(os.path.join(tmp, "data"), WORDS_PER_ROW)
        expect = {}
        for a in (1, 2):
            for b in (1, 2):
                expect[f"Count(Intersect(Row(f={a}), Row(g={b})))"] = \
                    cs.N_SHARDS * cs.popcount(planes[("f", a)]
                                              & planes[("g", b)])
        sides = {"A": args.a, "B": args.b}
        logs = {}
        for name, checkout in sides.items():
            data = os.path.join(tmp, f"data-{name}")
            shutil.copytree(os.path.join(tmp, "data"), data)
            logs[name] = os.path.join(tmp, f"server-{name}.log")
            procs.append(_start(checkout, data, logs[name]))
        uris = {name: _uri(proc, logs[name])
                for name, proc in zip(sides, procs)}
        print(f"data written and both servers up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        pql = list(expect)

        def run(name, n):
            times = []
            for i in range(n):
                q = pql[i % len(pql)]
                t = time.perf_counter()
                got = cs.http(uris[name], "/index/b/query", q)["results"][0]
                times.append(time.perf_counter() - t)
                if got != expect[q]:
                    raise AssertionError(f"{name} ({sides[name]}): {q} = "
                                         f"{got}, numpy {expect[q]}")
            return times

        for name in sides:
            cold = run(name, len(pql))
            run(name, WARMUP)
            print(f"{name} ({sides[name]}): cold p50 "
                  f"{statistics.median(cold) * 1e3:.3f} ms", flush=True)
        p50 = {"A": [], "B": []}
        for r in range(args.rounds):
            order = ("A", "B") if r % 2 == 0 else ("B", "A")
            for name in order:
                p50[name].append(
                    statistics.median(run(name, args.queries)) * 1e3)
            print(f"round {r}: A {p50['A'][-1]:.4f} ms, B "
                  f"{p50['B'][-1]:.4f} ms ({order[0]} first)", flush=True)
        b_wins = sum(b < a for a, b in zip(p50["A"], p50["B"]))
        summary = {"card": cs.nvidia_smi("name,power.limit"),
                   "queries_per_round": args.queries, "rounds": args.rounds,
                   "b_faster_rounds": b_wins}
        for name in sides:
            q1, q3 = _quartiles(p50[name])
            summary[name] = {"checkout": sides[name],
                             "median_p50_ms": statistics.median(p50[name]),
                             "q1_ms": q1, "q3_ms": q3,
                             "round_p50_ms": p50[name]}
            print(f"{name} ({sides[name]}): warm p50 median "
                  f"{summary[name]['median_p50_ms']:.4f} ms over "
                  f"{args.rounds} rounds, quartiles [{q1:.4f}, {q3:.4f}] ms",
                  flush=True)
        print(f"B faster in {b_wins} of {args.rounds} rounds", flush=True)
        print(json.dumps(summary), flush=True)
    finally:
        for proc in procs:
            _stop(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
