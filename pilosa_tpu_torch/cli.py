"""Command line: `python -m pilosa_tpu_torch server [--bind H:P]
[--data-dir D] [--device cuda|cpu] [--container-repr auto|dense|sparse|rle]
[--coalesce-window DURATION] [--coalesce-max-queue N]`.

The server opens the data directory (a `pilosa_tpu` data directory opens
as is: the roaring fragment files are the interchange format), serves
the HTTP API until SIGINT/SIGTERM, then closes the holder. It runs on
`cuda` unless `--device cpu` is given, and exits with an error when no
CUDA device is present and the CPU was not asked for.
"""

import argparse
import os
import re
import signal
import sys
import threading


def parse_duration(s):
    """'10m', '30s', '500ms', '1h30m' -> seconds (Go time.ParseDuration
    forms); a bare number is seconds."""
    s = str(s).strip()
    units = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1, "m": 60, "h": 3600}
    parts = re.findall(r"(\d+(?:\.\d+)?)(ns|us|ms|s|m|h)", s)
    if not parts:
        return float(s)
    consumed = "".join(n + u for n, u in parts)
    if consumed != s:
        raise ValueError(f"invalid duration: {s!r}")
    return sum(float(n) * units[u] for n, u in parts)


def _parser():
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("server", help="serve the HTTP API")
    s.add_argument("--bind", default="127.0.0.1:10101",
                   help="host:port to listen on (port 0 = ephemeral)")
    s.add_argument("--data-dir", default="~/.pilosa_tpu_torch")
    s.add_argument("--device", default="cuda",
                   help="torch device for the query path (cuda or cpu)")
    s.add_argument("--container-repr", default=None,
                   choices=["auto", "dense", "sparse", "rle"],
                   help="leaf container representation: auto (default, or "
                        "PILOSA_TPU_CONTAINER_REPR) picks dense/block-sparse/"
                        "run-length per fragment by measured density; dense "
                        "forces plain planes; sparse/rle force one "
                        "compressed form where eligible")
    s.add_argument("--coalesce-window", type=parse_duration, default=0.0,
                   help="query coalescer window (e.g. 1ms): concurrent "
                        "batchable queries arriving within it fuse into "
                        "batched launches (default 0 = off: every query "
                        "takes the per-query path)")
    s.add_argument("--coalesce-max-queue", type=int, default=256,
                   help="coalesce queue cap: past it, queries get 503 + "
                        "Retry-After instead of an unbounded wait")
    return p


class Server:
    """A started server: holder + API + HTTP transport."""

    def __init__(self, holder, api, http):
        self.holder = holder
        self.api = api
        self.http = http

    @property
    def uri(self):
        return self.http.uri

    def stop(self):
        self.http.stop()
        self.api.close()
        self.holder.close()


def start_server(argv):
    """Parse `server` flags (without the subcommand word), open the
    holder and start the HTTP server; returns a Server."""
    from .core import Holder
    from .device import resolve_device
    from .ops import containers
    from .server import API, PilosaHTTPServer

    args = _parser().parse_args(["server", *argv])
    device = resolve_device(args.device)
    # module state of ops/containers: applied before the holder opens, so
    # a bad mode fails at start, not at the first query
    containers.configure(args.container_repr)
    host, _, port = args.bind.rpartition(":")
    holder = Holder(os.path.expanduser(args.data_dir)).open()
    try:
        api = API(holder, device=device,
                  coalesce_window=args.coalesce_window,
                  coalesce_max_queue=args.coalesce_max_queue)
        http = PilosaHTTPServer(api, host=host or "127.0.0.1",
                                port=int(port)).start()
    except BaseException:
        holder.close()
        raise
    return Server(holder, api, http)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.cmd != "server":  # pragma: no cover — argparse enforces
        return 2
    try:
        srv = start_server(argv[1:])
    except RuntimeError as e:
        print(f"pilosa_tpu_torch: {e}", file=sys.stderr)
        return 1
    print(f"listening on {srv.uri} (device {srv.api.device})", flush=True)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    srv.stop()
    return 0
