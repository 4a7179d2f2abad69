"""The port's tracing module against the TPU package's, on the CPU.

Ported from tests/test_tracing.py: span nesting, the nop fast path,
header inject/extract (case-insensitive), the Client re-injecting the
current span on every request, executor and API spans through a port
server (`--device cpu`), and the slow-query log. Differential: the same
sequence of span operations (seeded with numpy) runs on both packages'
modules, and the span trees must be equal by name and parent; the
cross-node assembly helpers (`estimate_skew`, `merge_remote_spans`,
`assemble_tree`) must give equal output on the same span dicts; and a
fan-out query carries its trace id across a 2-node cluster of each
package.
"""

import http.server
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.utils import tracing as ref_tracing  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402
from pilosa_tpu_torch.utils import tracing  # noqa: E402
from pilosa_tpu_torch.utils.logger import CaptureLogger  # noqa: E402


@pytest.fixture(autouse=True)
def nop_tracers():
    tracing.set_tracer(None)
    ref_tracing.set_tracer(None)
    yield
    tracing.set_tracer(None)
    ref_tracing.set_tracer(None)


@pytest.fixture
def tracer():
    t = tracing.InMemoryTracer()
    tracing.set_tracer(t)
    yield t
    tracing.set_tracer(None)


def test_nop_by_default():
    with tracing.start_span("x") as span:
        assert span is None  # zero-allocation fast path
    assert tracing.current_span() is None


def test_span_nesting_and_finish(tracer):
    with tracing.start_span("parent", index="i") as p:
        with tracing.start_span("child") as c:
            assert c.trace_id == p.trace_id
            assert c.parent_id == p.span_id
            assert tracing.current_span() is c
        assert tracing.current_span() is p
    assert tracing.current_span() is None
    names = [s.name for s in tracer.spans]
    assert names == ["child", "parent"]  # children finish first
    assert all(s.duration is not None for s in tracer.spans)
    assert tracer.find("parent")[0].tags == {"index": "i"}


def test_inject_and_extract_headers(tracer):
    assert tracing.inject_headers() == {}
    with tracing.start_span("origin") as origin:
        headers = tracing.inject_headers()
        assert headers[tracing.TRACE_HEADER] == origin.trace_id
        assert headers[tracing.PARENT_HEADER] == origin.span_id
    with tracing.span_from_headers("remote", headers) as remote:
        assert remote.trace_id == origin.trace_id
        assert remote.parent_id == origin.span_id


def test_span_from_headers_without_context(tracer):
    with tracing.span_from_headers("h", {}) as span:
        assert span.parent_id is None


def test_extract_headers_case_insensitive(tracer):
    with tracing.start_span("origin") as origin:
        headers = tracing.inject_headers()
    lowered = {k.lower(): v for k, v in headers.items()}
    assert lowered != headers  # the canonical names ARE mixed-case
    with tracing.span_from_headers("remote", lowered) as remote:
        assert remote.trace_id == origin.trace_id
        assert remote.parent_id == origin.span_id
    weird = {"x-pILOSA-tRACE-iD": "t123", "X-PILOSA-SPAN-ID": "s456"}
    with tracing.span_from_headers("remote2", weird) as remote:
        assert remote.trace_id == "t123"
        assert remote.parent_id == "s456"


def test_trace_headers_reinjected_on_each_request(tracer):
    """Every Client request injects the CURRENT span's headers, so a
    retry inside the same span carries the trace context again."""
    seen = []

    class Sink(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(dict(self.headers.items()))
            body = b"{}"
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = Client(f"http://127.0.0.1:{srv.server_address[1]}")
        with tracing.start_span("fanout") as span:
            client.status()
            client.status()
        assert len(seen) == 2
        for headers in seen:
            got = {k.lower(): v for k, v in headers.items()}
            assert got[tracing.TRACE_HEADER.lower()] == span.trace_id
            assert got[tracing.PARENT_HEADER.lower()] == span.span_id
    finally:
        srv.shutdown()


def test_executor_spans(tracer, tmp_path):
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                        str(tmp_path), "--device", "cpu"])
    try:
        c = Client(srv.uri)
        c.create_index("ti")
        c.create_field("ti", "f")
        c.query("ti", "Set(1, f=10)")
        c.query("ti", "Count(Row(f=10))")
    finally:
        srv.stop()
    assert tracer.find("api.Query")
    assert tracer.find("executor.Execute")
    assert tracer.find("executor.executeCount")
    http_spans = [s for s in tracer.spans if s.name.startswith("http.POST")]
    assert http_spans
    exec_span = tracer.find("executor.Execute")[-1]
    assert any(s.trace_id == exec_span.trace_id for s in http_spans)


def test_slow_query_log(tmp_path):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server.api import API

    log = CaptureLogger()
    holder = Holder(str(tmp_path)).open()
    try:
        api = API(holder, device="cpu", long_query_time=0.0, logger=log)
        api.create_index("i")
        api.create_field("i", "f")
        api.query("i", "Count(Row(f=3))")
    finally:
        holder.close()
    assert any("SLOW QUERY" in line and "Count" in line for line in log.lines)


# -------------------------------------------------------------- differential


def _span_program(seed, n_ops=60):
    """A seeded list of ("open", name, tags) / ("close",) operations that
    nests spans up to depth 4 and closes every span it opens."""
    rng = np.random.default_rng(seed)
    ops, depth = [], 0
    for i in range(n_ops):
        if depth and (depth >= 4 or rng.random() < 0.45):
            ops.append(("close",))
            depth -= 1
        else:
            ops.append(("open", f"op{int(rng.integers(0, 6))}",
                        {"i": i, "k": int(rng.integers(0, 3))}))
            depth += 1
    ops.extend([("close",)] * depth)
    return ops


def _run_spans(mod, ops):
    """Run the program through `mod`'s start_span with an in-memory
    tracer; returns the finished spans as (name, parent name, tags) in
    finish order."""
    tracer = mod.InMemoryTracer()
    mod.set_tracer(tracer)
    stack = []
    try:
        for op in ops:
            if op[0] == "open":
                cm = mod.start_span(op[1], **op[2])
                cm.__enter__()
                stack.append(cm)
            else:
                stack.pop().__exit__(None, None, None)
    finally:
        mod.set_tracer(None)
    by_id = {s.span_id: s.name for s in tracer.spans}
    return [(s.name, by_id.get(s.parent_id), s.tags) for s in tracer.spans]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_trees_equal_by_name_and_parent(seed):
    ops = _span_program(seed)
    assert _run_spans(tracing, ops) == _run_spans(ref_tracing, ops)


def _remote_fixture(seed):
    """Seeded local fan-out spans and per-node remote spans as dicts."""
    rng = np.random.default_rng(seed)
    local = [{"name": "query", "traceID": "t", "spanID": "root",
              "parentID": None, "tags": {}, "start": 100.0,
              "duration": 1.0}]
    remote = {}
    for n in range(3):
        t_send = 100.0 + float(rng.random()) * 0.1
        rtt = 0.05 + float(rng.random()) * 0.1
        local.append({"name": "fanout", "traceID": "t",
                      "spanID": f"c{n}", "parentID": "root", "tags": {},
                      "start": t_send, "duration": rtt})
        theta = float(rng.normal()) * 5
        work = rtt * 0.6
        remote[f"node{n}"] = [
            {"name": "http.POST", "traceID": "t", "spanID": f"r{n}",
             "parentID": f"c{n}", "tags": {},
             "start": t_send + theta + (rtt - work) / 2,
             "duration": work},
            {"name": "executor.Execute", "traceID": "t",
             "spanID": f"e{n}", "parentID": f"r{n}", "tags": {},
             "start": t_send + theta + rtt / 2, "duration": work / 3},
        ]
    return local, remote


@pytest.mark.parametrize("seed", [3, 4])
def test_cross_node_assembly_equal(seed):
    local, remote = _remote_fixture(seed)
    for node, spans in remote.items():
        assert tracing.estimate_skew(local, spans) \
            == ref_tracing.estimate_skew(local, spans)
    got = tracing.merge_remote_spans(local, remote)
    want = ref_tracing.merge_remote_spans(local, remote)
    assert got == want
    assert tracing.assemble_tree(got[0]) == ref_tracing.assemble_tree(want[0])
    # every remote span hangs under the local fan-out span that sent it
    tree = tracing.assemble_tree(got[0])
    assert [r["name"] for r in tree] == ["query"]
    assert {c["name"] for c in tree[0]["children"]} == {"fanout"}


def test_trace_index_equal_under_the_same_spans():
    """The per-node trace index keeps and evicts the same spans."""
    got, want = tracing.TraceIndex(max_traces=3, max_spans_per_trace=2), \
        ref_tracing.TraceIndex(max_traces=3, max_spans_per_trace=2)
    rng = np.random.default_rng(5)
    for i in range(40):
        tid = f"t{int(rng.integers(0, 6))}"
        for idx, mod in ((got, tracing), (want, ref_tracing)):
            span = mod.Span(f"s{i}", tid, f"id{i}", None, {"i": i})
            span.finish()
            idx.add(span)
    assert got.stats() == want.stats()
    for t in range(6):
        assert [s["name"] for s in got.get(f"t{t}")] \
            == [s["name"] for s in want.get(f"t{t}")]


def test_trace_headers_are_the_reference_names():
    assert tracing.TRACE_HEADER == ref_tracing.TRACE_HEADER
    assert tracing.PARENT_HEADER == ref_tracing.PARENT_HEADER


def test_index_span_feeds_get_trace():
    """A profiled query's root span reaches GET /debug/traces/{id}."""
    tracing.configure_trace_index()
    span = tracing.Span("query", "tx", "root", None, {})
    span.finish()
    tracing.index_span(span)
    assert [s["spanID"] for s in tracing.get_trace("tx")] == ["root"]
    assert tracing.get_trace("unknown") == []


def test_cross_node_trace_propagation(tracer):
    """A fan-out query through the non-owner of a 2-node cluster carries
    one trace id through the remote node's HTTP layer (reference: handler
    extractTracing / client inject), on the port's cluster as on the TPU
    package's."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    ref_tracer = ref_tracing.InMemoryTracer()
    ref_tracing.set_tracer(ref_tracer)
    out = []
    try:
        for harness, t in ((JaxClusterHarness, ref_tracer),
                           (ClusterHarness, tracer)):
            c = harness(2)
            try:
                c[0].client.create_index("ti")
                c[0].client.create_field("ti", "f")
                # bits in two shards: the query fans out to both nodes
                c[0].client.import_bits("ti", "f", [10, 10],
                                        [5, SHARD_WIDTH + 5])
                non_owner = c.non_owner_of("ti", 0)
                t.clear()
                result = non_owner.client.query(
                    "ti", "Count(Row(f=10))")["results"]
            finally:
                c.close()
            remote_spans = [s for s in t.spans
                            if s.name.startswith("http.POST")
                            and s.parent_id]
            assert remote_spans, "no remote http span continued a trace"
            trace_ids = {s.trace_id for s in t.find("executor.Execute")}
            continued = any(s.trace_id in trace_ids for s in remote_spans)
            out.append((result, continued))
    finally:
        ref_tracing.set_tracer(None)
    assert out[1] == out[0] == ([2], True)
