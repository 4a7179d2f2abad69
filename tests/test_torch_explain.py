"""The port's PQL EXPLAIN/ANALYZE (exec/plan.py and its hooks) and the
kernels' declared costs, against the TPU package's, on the CPU.

Every case of `tests/test_explain.py` runs on the port (device="cpu"),
the cluster one on a 2-node cluster of each package: zero-launch planning,
the strategy per op family, the MIN_SHARDS fallback, validation, the
analyze grafting with exact dispatch estimates, misestimate flagging and
the /debug/plans ring, the HTTP and SLOW QUERY surfaces and the CLI
flags. The plans of the same corpus from both packages must match node
for node: op, strategy, reason, dispatch estimate, kernel map and
residency. Seconds may differ (their sources differ), and so may bytes
and row-chunk sizes: the TPU package pads the shard axis to its 8 test
devices.

Declared costs: each kernel wrapper's `*_cost` must declare the bytes
PERF.md §6 counts as its bound at the table's shapes, and K4 its word
popcounts, whose bit pairs at the card's 1-bit mma rate can bound it.
"""

import io
import json
from contextlib import redirect_stdout

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec import plan as jax_plan  # noqa: E402
from pilosa_tpu.exec.executor import ExecOptions as JaxExecOptions  # noqa: E402,E501
from pilosa_tpu_torch.core import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.exec import ExecError, Executor  # noqa: E402
from pilosa_tpu_torch.exec import plan as plan_mod  # noqa: E402
from pilosa_tpu_torch.exec.executor import ExecOptions  # noqa: E402
from pilosa_tpu_torch.ops import declared_cost  # noqa: E402
from pilosa_tpu_torch.server import Client, ClientError  # noqa: E402
from pilosa_tpu_torch.server.api import API  # noqa: E402
from pilosa_tpu_torch.server.http_server import PilosaHTTPServer  # noqa: E402,E501
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils import profile as profile_mod  # noqa: E402
from pilosa_tpu_torch.utils.logger import CaptureLogger  # noqa: E402

N_SHARDS = 3  # >= MIN_SHARDS so stacked strategies are eligible


def _populate(holder, field_options):
    idx = holder.create_index("i")
    idx.create_field("a")
    idx.create_field("b")
    idx.create_field("v", field_options.int_field(min=0, max=1000))
    cols = [s * SHARD_WIDTH + off
            for s in range(N_SHARDS) for off in (0, 3, 7, 11, 19)]
    idx.field("a").import_bits([i % 3 for i in range(len(cols))], cols)
    idx.field("b").import_bits([i % 2 for i in range(len(cols))], cols)
    idx.field("v").import_values(cols, [(i * 37) % 1000
                                        for i in range(len(cols))])


@pytest.fixture
def env(tmp_path):
    h = Holder(str(tmp_path / "data"), use_snapshot_queue=False).open()
    _populate(h, FieldOptions)
    e = Executor(h, device="cpu")
    yield h, e
    h.close()


def plan_of(e, pql, mode="plan"):
    out = e.execute("i", pql, options=ExecOptions(explain=mode))
    penv = plan_mod.take_last()
    assert penv is not None, "executor stashed no plan envelope"
    return out, penv


def walk(d):
    yield d
    for c in d.get("children", []):
        if isinstance(c, dict):
            yield from walk(c)


# ------------------------------------------------ zero-dispatch planning


def test_explain_plan_zero_dispatch_intersect_count(env):
    h, e = env
    d0 = e._stacked.cache_stats()["dispatches"]
    out, penv = plan_of(e, "Count(Intersect(Row(a=1), Row(b=1)))")
    assert out == []
    assert e._stacked.cache_stats()["dispatches"] == d0, \
        "explain=plan launched on the device"
    assert penv["mode"] == "plan"
    assert penv["index"] == "i"
    top = penv["calls"][0]
    assert top["op"] == "Count"
    assert top["strategy"] == "stacked"
    assert top["estimate"]["dispatches"] == 1
    assert top["estimate"]["kernels"] == {"count": 1}
    assert top["estimate"]["kernel_wall_seconds"] >= 0
    assert top["estimate"]["cost_source"] in (
        "measured", "histogram", "xla", "default")
    assert top["annotations"]["cache"] in ("cold", "warm", "partial")
    inter = top["children"][0]
    assert inter["op"] == "Intersect"
    assert inter["strategy"] == "per-shard-planes"
    assert inter["annotations"]["stack_coverable"] is True
    assert [c["op"] for c in inter["children"]] == ["Row", "Row"]


def test_explain_plan_zero_dispatch_pairwise_groupby(env):
    h, e = env
    d0 = e._stacked.cache_stats()["dispatches"]
    out, penv = plan_of(e, "GroupBy(Rows(a), Rows(b))")
    assert out == []
    assert e._stacked.cache_stats()["dispatches"] == d0
    top = penv["calls"][0]
    assert top["op"] == "GroupBy"
    assert top["strategy"] == "stacked-pairwise"
    ann = top["annotations"]
    assert ann["rows_per_field"] == [3, 2]
    assert ann["tile"] == [3, 2]
    assert ann["pairwise_tiles"] == [1, 1]
    assert ann["outer_combinations"] == 1
    assert top["estimate"]["pairwise_dispatches"] == 1
    assert top["estimate"]["dispatches"] == 1
    assert [c["strategy"] for c in top["children"][:2]] == \
        ["host-metadata", "host-metadata"]


# -------------------------------------------- plan shape per op family


ORACLE = [
    ("Row(a=1)", "Row", "per-shard-planes"),
    ("Intersect(Row(a=1), Row(b=1))", "Intersect", "per-shard-planes"),
    ("Union(Row(a=1), Row(b=1))", "Union", "per-shard-planes"),
    ("Count(Row(a=1))", "Count", "stacked"),
    ("Count(Union(Row(a=1), Row(b=0)))", "Count", "stacked"),
    ("TopN(a, n=2)", "TopN", "stacked-row-counts"),
    ("Sum(field=v)", "Sum", "stacked-sum"),
    ("Min(field=v)", "Min", "stacked-minmax"),
    ("Max(field=v)", "Max", "stacked-minmax"),
    ("Count(Row(v > 5))", "Count", "stacked"),  # Range-BSI
    ("Rows(a)", "Rows", "host-metadata"),
    ("GroupBy(Rows(a))", "GroupBy", "stacked-row-counts"),
    ("GroupBy(Rows(a), Rows(b))", "GroupBy", "stacked-pairwise"),
    ("MinRow(field=a)", "MinRow", "per-shard-scan"),
]


def test_plan_strategy_oracle_per_op_family(env):
    h, e = env
    for pql, op, strategy in ORACLE:
        _, penv = plan_of(e, pql)
        top = penv["calls"][0]
        assert (top["op"], top["strategy"]) == (op, strategy), pql
        est = top["estimate"]
        assert "cost_source" in est and "kernel_wall_seconds" in est, pql
    # Range-BSI condition: the gather itself launches a bsi_condition
    # kernel, so the estimate prices 2 dispatches, not 1
    _, penv = plan_of(e, "Count(Row(v > 5))")
    est = penv["calls"][0]["estimate"]
    assert est["dispatches"] == 2
    assert est["kernels"].get("bsi_condition") == 1


#: what must match node for node between the packages' plans
_NODE_ANNOTATIONS = ("shards", "cache", "leaves", "resident_leaves",
                     "stack_coverable", "rows_per_field", "tile",
                     "pairwise_tiles", "outer_combinations", "bsi_cache",
                     "candidate_rows", "views", "overrides", "repr")


def _node_shape(node):
    ann = node.get("annotations", {})
    est = node.get("estimate", {})
    return (node["op"], node["strategy"], node.get("reason", ""),
            est.get("dispatches"), est.get("kernels"),
            est.get("pairwise_dispatches"),
            {k: ann[k] for k in _NODE_ANNOTATIONS if k in ann},
            [_node_shape(c) for c in node.get("children", [])])


def test_plans_match_the_reference_node_for_node(env, tmp_path):
    """The same corpus planned by both packages, cold and then warm:
    every node's op, strategy, reason, dispatch estimate, kernel map and
    residency agree."""
    h, e = env
    jh = JaxHolder(str(tmp_path / "jax"), use_snapshot_queue=False).open()
    try:
        _populate(jh, JaxFieldOptions)
        je = JaxExecutor(jh)
        queries = [q for q, _, _ in ORACLE] + [
            "Options(Count(Row(a=0)), shards=[0])",
            "Count(Intersect(Row(a=1), Row(b=1)))",
            "TopN(a, Row(b=1), n=2)", "Sum(Row(a=1), field=v)"]
        for phase in ("cold", "warm"):
            for q in queries:
                _, mine = plan_of(e, q)
                je.execute("i", q, options=JaxExecOptions(explain="plan"))
                ref = jax_plan.take_last()
                assert [_node_shape(n) for n in mine["calls"]] == \
                    [_node_shape(n) for n in ref["calls"]], (phase, q)
            for q in queries:  # warm every stack the plans probe
                e.execute("i", q)
                je.execute("i", q)
    finally:
        jh.close()


def test_plan_falls_back_under_min_shards(env):
    h, e = env
    _, penv = plan_of(e, "Options(Count(Row(a=0)), shards=[0])")
    top = penv["calls"][0]
    assert top["strategy"] == "option-wrapper"
    inner = top["children"][0]
    assert inner["strategy"] == "per-shard"
    assert "MIN_SHARDS" in inner["reason"]
    assert top["estimate"]["dispatches"] == 0


def test_plan_mirrors_executor_validation(env):
    h, e = env
    for pql in ("GroupBy(Row(a=1))",
                "Options(Count(Row(a=0)), banana=1)"):
        with pytest.raises(ExecError):
            e.execute("i", pql, options=ExecOptions(explain="plan"))


# ---------------------------------------------------- analyze grafting


def test_analyze_grafts_actuals_and_matches_estimates(env):
    h, e = env
    want = e.execute("i", "Count(Intersect(Row(a=1), Row(b=1)))")[0]
    out, penv = plan_of(e, "Count(Intersect(Row(a=1), Row(b=1)))",
                        mode="analyze")
    assert out == [want]
    assert penv["mode"] == "analyze"
    assert "misestimates" in penv
    top = penv["calls"][0]
    act = top["actual"]
    assert act["wall_seconds"] > 0
    assert act["dispatches"] == top["estimate"]["dispatches"] == 1
    assert act["strategy"] == top["strategy"] == "stacked"
    assert act["kernels"].get("count") == 1


def test_analyze_dispatch_estimates_exact_across_ops(env):
    h, e = env
    for pql in ("GroupBy(Rows(a), Rows(b))", "TopN(a, n=2)",
                "Sum(field=v)", "Count(Row(v > 5))"):
        _, penv = plan_of(e, pql, mode="analyze")
        top = penv["calls"][0]
        assert top["actual"]["dispatches"] == \
            top["estimate"]["dispatches"], pql


def test_misestimate_flagging_and_ring(env, monkeypatch):
    h, e = env
    plan_mod.clear_recent()
    flagged0 = plan_mod.stats()["misestimates_flagged"]
    monkeypatch.setattr(plan_mod.CostModel, "dispatch_seconds",
                        lambda self, family: (100.0, "default"))
    _, penv = plan_of(e, "Count(Intersect(Row(a=1), Row(b=1)))",
                      mode="analyze")
    top = penv["calls"][0]
    assert top["misestimates"], "100s/dispatch estimate was not flagged"
    flag = top["misestimates"][0]
    assert flag["metric"] == "kernel_wall_seconds"
    assert flag["deviation"] > plan_mod.misestimate_factor()
    assert penv["misestimates"] >= 1
    assert plan_mod.stats()["misestimates_flagged"] == flagged0 + 1
    retained = plan_mod.recent()
    assert retained and retained[0]["calls"][0]["op"] == "Count"
    plan_mod.clear_recent()


def test_accurate_analyze_not_retained(env):
    h, e = env
    pql = "Count(Row(a=1))"
    e.execute("i", pql)
    plan_mod.clear_recent()
    _, penv = plan_of(e, pql, mode="analyze")
    # (a node serializes "misestimates" only when it has some)
    if not penv["calls"][0].get("misestimates"):
        assert plan_mod.recent() == []
    plan_mod.clear_recent()


def test_flag_misestimates_unit():
    node = plan_mod.PlanNode("Count", strategy="stacked")
    node.estimate = {"kernel_wall_seconds": 0.010, "dispatches": 1,
                     "bytes_materialized": 0}
    node.actual = {"kernel_wall_seconds": 0.100, "dispatches": 1,
                   "bytes_materialized": 0}
    plan_mod.flag_misestimates(node, factor=3.0)
    assert [f["metric"] for f in node.misestimates] == \
        ["kernel_wall_seconds"]
    assert node.misestimates[0]["deviation"] == 10.0
    node2 = plan_mod.PlanNode("Count")
    node2.estimate = {"kernel_wall_seconds": 1e-9}
    node2.actual = {"kernel_wall_seconds": 1e-6}
    plan_mod.flag_misestimates(node2, factor=3.0)
    assert node2.misestimates == []
    node3 = plan_mod.PlanNode("Count")
    node3.estimate = {"dispatches": 40}
    node3.actual = {"dispatches": 2}
    plan_mod.flag_misestimates(node3, factor=3.0)
    assert node3.misestimates[0]["deviation"] == 20.0


def test_ring_configure_bounds():
    plan_mod.clear_recent()
    old = plan_mod.stats()["ring_size"]
    try:
        plan_mod.configure(ring_size=3)
        for i in range(7):
            plan_mod.record({"index": f"r{i}", "mode": "analyze",
                             "calls": []})
        got = plan_mod.recent()
        assert len(got) == 3
        assert got[0]["index"] == "r6"
        assert plan_mod.recent(limit=1) == [got[0]]
    finally:
        plan_mod.configure(ring_size=old)
        plan_mod.clear_recent()


def test_summary_marks_misestimated_nodes():
    n1 = plan_mod.PlanNode("Count", strategy="stacked")
    n2 = plan_mod.PlanNode("GroupBy", strategy="stacked-pairwise")
    n2.misestimates = [{"metric": "dispatches"}]
    assert plan_mod.summary([n1, n2]) == \
        "Count=stacked,GroupBy=stacked-pairwise!"


# ------------------------------------------------------- HTTP surface


class _Harness:
    """One in-process port node on the CPU: holder + API + HTTP."""

    def __init__(self, data_dir, **api_kwargs):
        self.holder = Holder(str(data_dir), use_snapshot_queue=False).open()
        self.api = API(self.holder, device="cpu", **api_kwargs)
        self.server = PilosaHTTPServer(self.api, host="127.0.0.1",
                                       port=0).start()
        self.client = Client(self.server.uri)

    def close(self):
        self.server.stop()
        self.api.close()
        self.holder.close()


def test_http_explain_param_and_debug_plans(tmp_path, monkeypatch):
    h = _Harness(tmp_path)
    try:
        h.client.create_index("hx")
        h.client.create_field("hx", "f")
        cols = [s * SHARD_WIDTH + o for s in range(N_SHARDS)
                for o in (1, 5)]
        h.client.import_bits("hx", "f", [1] * len(cols), cols)

        resp = h.client.query("hx", "Count(Row(f=1))", explain="true")
        assert resp["results"] == []
        assert resp["plan"]["mode"] == "plan"
        assert resp["plan"]["calls"][0]["strategy"] == "stacked"

        resp = h.client.query("hx", "Count(Row(f=1))", explain="analyze")
        assert resp["results"] == [len(cols)]
        assert resp["plan"]["calls"][0]["actual"]["dispatches"] >= 1

        with pytest.raises(ClientError) as ei:
            h.client.query("hx", "Count(Row(f=1))", explain="banana")
        assert ei.value.status == 400
        assert "explain" in str(ei.value)

        plan_mod.clear_recent()
        monkeypatch.setattr(plan_mod.CostModel, "dispatch_seconds",
                            lambda self, family: (100.0, "default"))
        h.client.query("hx", "Count(Row(f=1))", explain="analyze")
        out = h.client.debug_plans()
        assert out["retained"] >= 1
        assert out["misestimates_flagged"] >= 1
        assert out["plans"][0]["calls"][0]["misestimates"]
        out0 = h.client.debug_plans(limit=0)
        assert out0["plans"] == [] and out0["retained"] >= 1

        status = h.client._request("GET", "/status")
        local = next(iter(status["observability"].values()))
        assert local["plans"]["retained"] >= 1
        assert local["plans"]["misestimates_flagged"] >= 1
        index = h.client._request("GET", "/debug")
        paths = {e["path"] for e in index["endpoints"]}
        assert {"/debug/plans", "/debug/kernels", "/debug/optimizer",
                "/debug/ingest"} <= paths
        plan_mod.clear_recent()
    finally:
        h.close()


def test_slow_query_log_carries_plan_and_trace(tmp_path):
    h = _Harness(tmp_path)
    try:
        log = CaptureLogger()
        h.api.long_query_time = 0.0  # everything is slow
        h.api.logger = log
        profile_mod.clear_recent()
        h.client.create_index("sq")
        h.client.create_field("sq", "f")
        cols = [s * SHARD_WIDTH + o for s in range(N_SHARDS)
                for o in (1, 5)]
        h.client.import_bits("sq", "f", [1] * len(cols), cols)
        h.client.query("sq", "Count(Row(f=1))")

        slow = [ln for ln in log.lines if "SLOW QUERY" in ln]
        assert slow
        line = slow[-1]
        assert " trace=" in line and " plan=" in line
        plan_field = line.split(" plan=", 1)[1].split(" profile=", 1)[0]
        assert plan_field == "Count=stacked"
        trace_field = line.split(" trace=", 1)[1].split(" ", 1)[0]
        tree = json.loads(line.split("profile=", 1)[1])
        assert tree["spans"]["name"] == "query"
        assert tree["traceID"] == trace_field

        h.client.query("sq", "Count(Row(f=1))", explain="analyze")
        slow2 = [ln for ln in log.lines if "SLOW QUERY" in ln][-1]
        plan_field2 = slow2.split(" plan=", 1)[1].split(" profile=", 1)[0]
        assert plan_field2.startswith("Count=stacked")
    finally:
        h.close()


# ------------------------------------------------------------ CLI flags


def test_cli_flags_fold_into_config():
    from pilosa_tpu_torch.cli import main

    try:
        import tomllib
    except ImportError:
        tomllib = pytest.importorskip("tomli")

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["config", "--plan-ring-size", "9",
                   "--explain-misestimate-factor", "1.5",
                   "--adaptive", "shadow",
                   "--ingest-merge-interval", "250ms"])
    assert rc == 0
    cfg = tomllib.loads(buf.getvalue())
    assert cfg["plan-ring-size"] == 9
    assert cfg["explain-misestimate-factor"] == 1.5
    assert cfg["adaptive"] == "shadow"
    assert cfg["ingest-merge-interval"] == "250ms"


def test_plan_configure_applies():
    old = plan_mod.stats()
    try:
        plan_mod.configure(ring_size=5, misestimate_factor=2.5)
        assert plan_mod.stats()["ring_size"] == 5
        assert plan_mod.misestimate_factor() == 2.5
    finally:
        plan_mod.configure(ring_size=old["ring_size"],
                           misestimate_factor=old["misestimate_factor"])


# ------------------------------------------------------- declared costs


#: PERF.md §6's bound bytes at the table's shapes (W = 32768 words)
W = 32768
BOUND_BYTES = [
    ("count_expr", (2, 954, W), 250_085_384),
    ("count_expr_batch", (4, 2, 954, W), 1_000_341_600),
    ("count_expr_batch", (64, 2, 10, W), 167_773_696),
    # the multi-tree entry at the served 5-call query's two K1 members
    # (a 2-leaf chain and a 2-leaf union) at S = 954
    ("count_expr_multi", ((2, 2), 954, W), 500_170_846),
    ("count_blocks", (32768,), 16_777_224),
    ("count_blocks", (131072,), 67_108_872),
    # K2's batched entry: the sum of its members' single costs and their
    # 8-byte state words (B = 4 and the served query-batch's 16 at index
    # b's NB = 32,768)
    ("count_blocks_batch", (4, 32768), 67_108_928),
    ("count_blocks_batch", (16, 32768), 268_435_712),
    ("count_and_blocks_batch", (4, 32768, 32768), 135_266_368),
    ("row_counts", (100, 10 * W, False), 131_072_800),
    ("row_counts", (1, 954 * W, True), 250_085_384),
    ("row_counts", (21, 128 * W, True), 369_098_920),
    ("pairwise_counts", (5, 4, 10 * W, False), 11_796_640),
    ("pairwise_counts", (5, 4, 10 * W, True), 13_107_360),
    ("pairwise_counts", (1, 1, 954 * W, False), 250_085_384),
    ("bsi_range_mask", (21, 128 * W), 402_653_184),
    ("bsi_range_mask", (21, 954 * W), 3_001_024_512),
]


@pytest.mark.parametrize("kernel,args,nbytes", BOUND_BYTES)
def test_declared_costs_equal_the_bound_bytes(kernel, args, nbytes):
    """Each wrapper declares the bytes PERF.md §6's bound counts; the
    bound in seconds only for a CUDA device, at the H100's rate."""
    cpu = declared_cost(kernel, args, "cpu")
    assert cpu["bytes accessed"] == nbytes
    assert "optimal_seconds" not in cpu
    card = declared_cost(kernel, args, "cuda:0")
    assert card["bytes accessed"] == nbytes
    if kernel != "pairwise_counts":
        assert card["optimal_seconds"] == pytest.approx(nbytes / 3.35e12)


def test_declared_k2_fused_and_k4_popc_costs():
    from pilosa_tpu_torch.ops.count_blocks import count_and_blocks_cost
    from pilosa_tpu_torch.ops.pairwise import pairwise_cost

    # K2's fused pair reads both id lists and the matched blocks of both
    # sides; without the data's matched count it declares the most
    assert count_and_blocks_cost(4, 8, matched=2)["bytes accessed"] == \
        (4 + 8) * 4 + 2 * 2 * 512 + 8
    assert count_and_blocks_cost(4, 8)["bytes accessed"] == \
        (4 + 8) * 4 + 2 * 4 * 512 + 8
    # K4 at 102 x 102 x S = 10: 3.41e9 word popcounts, 1.09e11 bit pairs,
    # at the H100's 1-bit tensor-core rate (5.259e15 a second, PERF.md §6)
    # 20.74 us: bound by its 267,470,112 bytes (79.84 us), no longer by
    # its POPCs on the CUDA cores (815.25 us)
    cost = pairwise_cost(102, 102, 10 * W, False, device="cuda")
    assert cost["popc"] == 102 * 102 * 10 * W
    assert cost["bytes accessed"] == 267_470_112
    assert cost["optimal_seconds"] * 1e6 == pytest.approx(79.84, abs=0.01)
    # a tile whose bit pairs outweigh its bytes (4096 x 4096 rows of one
    # shard) is bound by them at that rate
    big = pairwise_cost(4096, 4096, W, False, device="cuda")
    assert big["optimal_seconds"] == pytest.approx(
        4096 * 4096 * W * 32 / 5.259e15)


@pytest.mark.parametrize("batch", [1, 2, 16])
def test_count_kernels_declare_k2_batched_entry(batch):
    """A count group's declared launches from its shapes alone: B > 1
    block-sparse members are ONE launch of K2's batched entry (mode 0 for
    a lone leaf, the fused mode for an all-sparse `&` of two or three
    leaves, its NB_a the first leaf's and NB_b the last's), B = 1 the
    single entry; the cost is B single members' bytes."""
    from pilosa_tpu_torch.ops import containers as tc

    leaf = ("leaf", 0)
    pair = ("&", (("leaf", 0), ("leaf", 1)))
    triple = ("&", (("leaf", 0), ("leaf", 1), ("leaf", 2)))
    sp = ("sparse", 954)
    shapes = {32768: ((32768,), (32768, 128)), 16384: ((16384,),
                                                        (16384, 128))}
    got = {
        "leaf": tc.count_kernels(leaf, (sp,), shapes[32768], batch),
        "pair": tc.count_kernels(pair, (sp, sp),
                                 shapes[32768] + shapes[16384], batch),
        "triple": tc.count_kernels(triple, (sp, sp, sp), shapes[16384]
                                   + shapes[32768] + shapes[32768], batch),
    }
    if batch == 1:
        assert got == {"leaf": [("count_blocks", (32768,))],
                       "pair": [("count_and_blocks", (32768, 16384))],
                       "triple": [("count_and_blocks", (16384, 32768))]}
    else:
        assert got == {
            "leaf": [("count_blocks_batch", (batch, 32768))],
            "pair": [("count_and_blocks_batch", (batch, 32768, 16384))],
            "triple": [("count_and_blocks_batch", (batch, 16384, 32768))]}
    one = declared_cost("count_blocks", (32768,))["bytes accessed"]
    pair_one = declared_cost("count_and_blocks", (32768, 16384))[
        "bytes accessed"]
    # a batched member adds its 8-byte state word
    state = 8 if batch > 1 else 0
    (kernel, args), = got["leaf"]
    assert declared_cost(kernel, args)["bytes accessed"] == \
        batch * (one + state)
    (kernel, args), = got["pair"]
    assert declared_cost(kernel, args)["bytes accessed"] == \
        batch * (pair_one + state)


def test_debug_kernels_lists_declared_costs_per_launched_shape(env):
    """GET /debug/kernels' "compiled" list: one entry per launched kernel
    shape of each family with its declared cost (CPU: bytes only)."""
    h, e = env
    e.execute("i", "Count(Intersect(Row(a=1), Row(b=1)))")
    e.execute("i", "GroupBy(Rows(a), Rows(b))")
    e.execute("i", "Count(Row(v > 5))")
    snap = e.kernel_stats()
    by_kernel = {(c["family"], c["kernel"]): c["cost"]
                 for c in snap["compiled"]}
    assert by_kernel[("count", "count_expr")]["bytes accessed"] == \
        2 * N_SHARDS * W * 4 + 8
    assert by_kernel[("pairwise", "pairwise_counts")]["popc"] == \
        3 * 2 * N_SHARDS * W
    assert ("bsi_condition", "bsi_range_mask") in by_kernel
    assert all("optimal_seconds" not in c for c in by_kernel.values())
    assert "compiled" not in e.kernel_stats(include_costs=False)


def test_cluster_plan_embeds_per_node_subplans():
    """A 2-node cluster of each package (ModHasher: shards alternate
    owners, so both the local planner leg and the remote explain leg
    run): ?explain=true wraps one sub-plan per primary owner and
    executes nothing; ?explain=analyze executes every leg's analyze and
    grafts its actuals. The plans' shapes, the per-node shard counts (by
    the node's place in the sorted ids) and the answers are the TPU
    package's."""
    import time

    import pilosa_tpu.cluster as jax_cluster
    import pilosa_tpu_torch.cluster as torch_cluster
    from pilosa_tpu_torch.tools.cluster import ClusterHarness

    from tests.harness import ClusterHarness as JaxClusterHarness

    n_shards = 6
    cols = [s * SHARD_WIDTH + 2 for s in range(n_shards)]
    out = []
    for harness, cmod in ((JaxClusterHarness, jax_cluster),
                          (ClusterHarness, torch_cluster)):
        h = harness(2, replica_n=1, hasher=cmod.ModHasher())
        try:
            h[0].client.create_index("ce")
            h[0].client.create_field("ce", "f")
            time.sleep(0.3)  # DDL broadcast settles
            h[0].client.import_bits("ce", "f", [1] * len(cols), cols)
            order = [n.id for n in h[0].cluster.nodes]
            owners = {h[0].cluster.shard_nodes("ce", s)[0].id
                      for s in range(n_shards)}
            assert len(owners) == 2, "ModHasher should use both nodes"

            resp = h[0].client.query("ce", "Count(Row(f=1))",
                                     explain="true")
            assert resp["results"] == []
            penv = resp["plan"]
            top = penv["calls"][0]
            assert {c["node"] for c in top["children"]} == owners
            planned = (penv["mode"], top["strategy"], sorted(
                (order.index(c["node"]), c["shards"], c["plan"]["op"],
                 c["plan"]["strategy"]) for c in top["children"]))

            resp = h[0].client.query("ce", "Count(Row(f=1))",
                                     explain="analyze")
            top = resp["plan"]["calls"][0]
            assert {c["node"] for c in top["children"]} == owners
            for c in top["children"]:
                assert c["plan"]["actual"]["wall_seconds"] > 0
            assert "misestimates" in resp["plan"]
            analyzed = (resp["results"], top["strategy"], sorted(
                (order.index(c["node"]), c["shards"],
                 c["plan"]["actual"]["dispatches"])
                for c in top["children"]))
            out.append((planned, analyzed))
        finally:
            h.close()
    assert out[1] == out[0], (out[1], out[0])
    planned, analyzed = out[1]
    assert planned[:2] == ("plan", "cluster-map-reduce")
    assert sum(c[1] for c in planned[2]) == n_shards
    assert analyzed[0] == [len(cols)]
