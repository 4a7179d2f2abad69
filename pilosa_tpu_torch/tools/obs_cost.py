"""Host cost of the observability hot path, per call.

    python -m pilosa_tpu_torch.tools.obs_cost [--calls 20000]

Times, with timeit on the host CPU (no card needed), each piece a served
query pays: a clock read, a nop span (`tracing.start_span`), an HTTP
request's span (`tracing.span_from_headers` over a request's headers
without trace context), a registry timing with three tags, a
flight-recorder event, one locked launch's bookkeeping
(`StackedEvaluator._locked_dispatch` around an empty body with one phase
mark) and one fetch's (`_timed_sync`), beside a 100-step Python loop as
the host's yardstick. Prints microseconds per call.
"""

import argparse
import http.client
import io
import time
import timeit

_HEADERS = (b"Accept-Encoding: identity\r\nContent-Type: text/plain\r\n"
            b"Content-Length: 36\r\nHost: 127.0.0.1:10101\r\n"
            b"User-Agent: Python-urllib/3.12\r\nConnection: close\r\n\r\n")


def main(argv=None):
    p = argparse.ArgumentParser(prog="obs_cost")
    p.add_argument("--calls", type=int, default=20000)
    args = p.parse_args(argv)

    from ..exec.stacked import StackedEvaluator
    from ..utils import flightrec, tracing
    from ..utils.stats import StatsClient

    headers = http.client.parse_headers(io.BytesIO(_HEADERS))
    registry = StatsClient()
    ev = StackedEvaluator("cpu")

    def nop_span():
        with tracing.start_span("executor.Execute"):
            pass

    def request_span():
        with tracing.span_from_headers("http.POST /index/b/query", headers,
                                       method="POST"):
            pass

    def launch():
        with ev._locked_dispatch("count", 250_000_000, 8) as ph:
            ph.mark("dispatch_ack")

    def fetch():
        with ev._timed_sync("count"):
            pass

    def loop():
        x = 0
        for i in range(100):
            x += i

    for name, fn in (
            ("clock read (perf_counter)", time.perf_counter),
            ("nop span", nop_span),
            ("request span (no trace headers)", request_span),
            ("registry timing, 3 tags",
             lambda: registry.timing("http_request_seconds", 0.002, {
                 "route": "/index/(?P<index>[^/]+)/query",
                 "method": "POST", "status": "200"})),
            ("flight-recorder event",
             lambda: flightrec.record("dispatch.start", kernel="count")),
            ("locked launch bookkeeping", launch),
            ("fetch bookkeeping", fetch),
            ("100-step Python loop", loop)):
        per = timeit.timeit(fn, number=args.calls) / args.calls
        print(f"{name:34s} {per * 1e6:8.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
