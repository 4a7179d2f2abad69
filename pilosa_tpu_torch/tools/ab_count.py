"""A/B of the served Count path between two checkouts on one CUDA card.

    python -m pilosa_tpu_torch.tools.ab_count --a DIR --b DIR \\
        [--rounds 20] [--queries 100] [--clients 1[,8...]] \\
        [--coalesce-window D]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py` for the data and the numpy answers). It writes
chip_smoke.py's 1B-column index once (index b: 954 shards of 2^20
columns, fields f and g, rows 1 and 2, word density 0.05, seed 3),
copies it for each side, and starts `python -m pilosa_tpu_torch server
--device cuda` from each checkout, both on the same card. Each side
answers the four Count(Intersect(Row(f=a), Row(g=b))) queries once cold
and 20 more times to warm up. Then, in every round, the two sides take
turns, A first in even rounds and B first in odd ones, each answering
`queries` warm Counts over HTTP from N client threads (each thread
sending its share one at a time), for every N of `--clients`. It prints
each round's queries per second and warm p50 per side and N, then per
side and N the median over rounds of both, the quartiles of the p50s,
and how many rounds B had the lower p50. `--coalesce-window` starts a
side's server with that query coalescer window, where the side's
`server --help` lists the flag (older checkouts have none). Every answer
is checked against numpy; any mismatch or failed server exits non-zero.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

WARMUP = 20


def _env(checkout):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(checkout)
    return env


def _has_flag(checkout, flag):
    """True when the checkout's `server --help` lists `flag`."""
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--help"],
        cwd=checkout, env=_env(checkout), capture_output=True, text=True,
        timeout=120)
    return flag in out.stdout


def _start(checkout, data_dir, log_path, extra=()):
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--bind",
         "127.0.0.1:0", "--data-dir", data_dir, "--device", "cuda", *extra],
        cwd=checkout, env=_env(checkout), stdout=subprocess.PIPE, stderr=log,
        text=True)
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
    p.add_argument("--clients", default="1",
                   type=lambda v: [int(n) for n in v.split(",")],
                   help="client threads per round, or a comma list of "
                        "counts each round runs in turn (default 1)")
    p.add_argument("--coalesce-window", default=None,
                   help="query coalescer window for the sides whose "
                        "server takes --coalesce-window (e.g. 1ms)")
    args = p.parse_args(argv)

    import chip_smoke as cs
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    print(f"card: {cs.nvidia_smi('name,power.limit')}", flush=True)
    tmp = tempfile.mkdtemp(prefix="pilosa-torch-ab-")
    procs = []
    try:
        t0 = time.perf_counter()
        planes, _ = cs.build_count_data(os.path.join(tmp, "data"),
                                        WORDS_PER_ROW)
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
            extra = ()
            if args.coalesce_window is not None:
                if _has_flag(checkout, "--coalesce-window"):
                    extra = ("--coalesce-window", args.coalesce_window)
                print(f"{name} ({checkout}): coalesce window "
                      f"{extra[1] if extra else 'not taken'}", flush=True)
            procs.append(_start(checkout, data, logs[name], extra))
        uris = {name: _uri(proc, logs[name])
                for name, proc in zip(sides, procs)}
        print(f"data written and both servers up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        pql = list(expect)

        def run(name, n, clients=1):
            """(wall seconds, per-query seconds) of n Counts from
            `clients` threads."""
            shares = [list(range(c, n, clients)) for c in range(clients)]
            times = [[] for _ in range(clients)]
            errors = []
            start = threading.Barrier(clients + 1)

            def client(c):
                start.wait()
                try:
                    for i in shares[c]:
                        q = pql[i % len(pql)]
                        t = time.perf_counter()
                        got = cs.http(uris[name], "/index/b/query",
                                      q)["results"][0]
                        times[c].append(time.perf_counter() - t)
                        if got != expect[q]:
                            raise AssertionError(
                                f"{name} ({sides[name]}): {q} = {got}, "
                                f"numpy {expect[q]}")
                except Exception as e:  # re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(clients)]
            for t in threads:
                t.start()
            start.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            if errors:
                raise errors[0]
            return wall, [x for ts in times for x in ts]

        for name in sides:
            _, cold = run(name, len(pql))
            run(name, WARMUP)
            print(f"{name} ({sides[name]}): cold p50 "
                  f"{statistics.median(cold) * 1e3:.3f} ms", flush=True)
        p50 = {(s, n): [] for s in sides for n in args.clients}
        qps = {(s, n): [] for s in sides for n in args.clients}
        for r in range(args.rounds):
            order = ("A", "B") if r % 2 == 0 else ("B", "A")
            for n in args.clients:
                for name in order:
                    wall, times = run(name, args.queries, n)
                    p50[(name, n)].append(statistics.median(times) * 1e3)
                    qps[(name, n)].append(len(times) / wall)
                print(f"round {r}, {n} client(s): A "
                      f"{p50[('A', n)][-1]:.4f} ms, "
                      f"{qps[('A', n)][-1]:.1f} QPS; B "
                      f"{p50[('B', n)][-1]:.4f} ms, "
                      f"{qps[('B', n)][-1]:.1f} QPS ({order[0]} first)",
                      flush=True)
        summary = {"card": cs.nvidia_smi("name,power.limit"),
                   "queries_per_round": args.queries, "rounds": args.rounds,
                   "coalesce_window": args.coalesce_window}
        for n in args.clients:
            b_wins = sum(b < a for a, b in zip(p50[("A", n)],
                                               p50[("B", n)]))
            cell = {"b_faster_rounds": b_wins}
            for name in sides:
                q1, q3 = _quartiles(p50[(name, n)])
                cell[name] = {
                    "checkout": sides[name],
                    "median_p50_ms": statistics.median(p50[(name, n)]),
                    "q1_ms": q1, "q3_ms": q3,
                    "median_qps": statistics.median(qps[(name, n)]),
                    "round_p50_ms": p50[(name, n)],
                    "round_qps": qps[(name, n)]}
                print(f"{name} ({sides[name]}), {n} client(s): warm p50 "
                      f"median {cell[name]['median_p50_ms']:.4f} ms over "
                      f"{args.rounds} rounds, quartiles [{q1:.4f}, "
                      f"{q3:.4f}] ms; median {cell[name]['median_qps']:.1f} "
                      f"QPS", flush=True)
            print(f"{n} client(s): B's p50 lower in {b_wins} of "
                  f"{args.rounds} rounds", flush=True)
            summary[f"clients_{n}"] = cell
        print(json.dumps(summary), flush=True)
    finally:
        for proc in procs:
            _stop(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
