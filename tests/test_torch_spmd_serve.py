"""Mesh-resident serving on the port's collective plane
(pilosa_tpu_torch/cluster/{meshstacks,spmd}.py), in one process.

`tests/test_spmd_serve.py` ported (18 cases), each held to the TPU
package's own objects on the same inputs where both can run: the serve
modes and their run-time switch, `http` declining, /debug/spmd's shape,
`entry_key` and `leaf_views`, the mesh cache's generations, LRU, HBM
ledger, shadow digest and index invalidation (the same call sequence on
both packages' MeshStackCache, every return value and stats() equal),
the batch step's counts (the port's `count_batch_partial`, one K1 launch
over K trees, equal to K serial `count_partial`s and to the reference's
`_count_batch_fn`), the coalescer adapter's contract, EXPLAIN's mesh
node, fusion's mesh program ledger, the step-lifecycle events the
reference's wedge classifier reads (recorded by the port's plane), and
/debug/spmd on a node without a plane.

Beside them: a cache-aware `_leaf_blocks` on a one-rank plane (a warm
step hits, a write invalidates, shadow probes), and a 2-rank gloo group
whose ranks enter one collective with different step numbers: both
raise, and no sum is returned.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.cluster import meshstacks as jmesh  # noqa: E402
from pilosa_tpu.cluster import spmd as jspmd  # noqa: E402
from pilosa_tpu.shardwidth import WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.cluster import meshstacks as mesh  # noqa: E402
from pilosa_tpu_torch.cluster.spmd import (  # noqa: E402
    SpmdBatchRunner,
    SpmdDataPlane,
    SpmdError,
)
from pilosa_tpu_torch.core.view import (  # noqa: E402
    VIEW_BSI_GROUP_PREFIX,
    VIEW_STANDARD,
)

from tests.harness import ServerHarness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plane(serve_mode="off"):
    return SpmdDataPlane(None, None, None, serve_mode=serve_mode)


def _ref_plane(serve_mode="off"):
    return jspmd.SpmdDataPlane(None, None, None, serve_mode=serve_mode)


# -- serve-mode plumbing ------------------------------------------------------


def test_serve_mode_default_and_coercion():
    for mode in (None, "on", "shadow", "sideways"):
        kw = {} if mode is None else {"serve_mode": mode}
        port = SpmdDataPlane(None, None, None, **kw).serve_mode
        ref = jspmd.SpmdDataPlane(None, None, None, **kw).serve_mode
        assert port == ref
    assert _plane().serve_mode == "off"
    assert _plane("on").serve_mode == "on"
    # an unknown boot value degrades to the safe default, never raises
    assert _plane("sideways").serve_mode == "off"
    assert SpmdDataPlane.SERVE_MODES == jspmd.SpmdDataPlane.SERVE_MODES


def test_set_serve_mode_runtime_switch():
    for p, err in ((_plane(), SpmdError), (_ref_plane(), jspmd.SpmdError)):
        assert p.set_serve_mode("on") == "on"
        assert p.serve_mode == "on"
        assert p.set_serve_mode("http") == "http"
        with pytest.raises(err):
            p.set_serve_mode("sideways")
        assert p.serve_mode == "http"  # a failed switch leaves the mode


def test_http_mode_forces_decline():
    """serve mode http declines before touching call or cluster state:
    the same cluster can A/B the HTTP fan-out against the collective."""
    assert _plane("http").maybe_execute(None, None, []) == (False, None)
    assert _ref_plane("http").maybe_execute(None, None, []) == (False, None)


def _shape(obj):
    """Nested key structure of a JSON-like dict."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_debug_snapshot_shape():
    snap = _plane("on").debug_snapshot()
    assert snap["serve_mode"] == "on"
    assert snap["steps"]["announced"] == 0
    assert snap["steps"]["entered"] == 0
    assert snap["steps"]["exited"] == 0
    assert snap["stream"]["errors"] == 0
    assert snap["queries"]["batched"] == 0
    assert snap["queries"]["fused"] == 0
    assert snap["mesh_cache"]["entries"] == 0
    assert "http_data_plane_bytes" in snap
    ref = _ref_plane("on").debug_snapshot()
    # every key the reference reports, with the same nesting (the mesh
    # shape is the port's [ranks, 1])
    assert set(snap) == set(ref)
    for key in ("steps", "queries", "stream", "observatory", "mesh_cache"):
        assert _shape(snap[key]) == _shape(ref[key]), key
    assert snap["mesh"] == [1, 1]


# -- mesh stack cache ---------------------------------------------------------


def test_entry_key_and_leaf_views():
    wires = [["row", "f", 7], ["bsicond", "v", ">", [10]],
             ["bsicond", "v", ">", 0], ["bsicond", "v", "><", [-1, 4]],
             ["timerow", "t", 1, ["std_2019", "std_2020"]]]
    for w in wires:
        assert mesh.entry_key(w) == jmesh.entry_key(w)
        assert mesh.leaf_views(w) == jmesh.leaf_views(w)
    assert mesh.entry_key(["row", "f", 7]) == ("row", "f", 7)
    assert mesh.entry_key(["bsicond", "v", ">", [10]]) \
        == ("bsicond", "v", ">", (10,))
    # single-threshold conditions ship a scalar on the wire
    assert mesh.entry_key(["bsicond", "v", ">", 0]) == ("bsicond", "v", ">", 0)
    assert mesh.entry_key(["timerow", "t", 1, ["std_2019", "std_2020"]]) \
        == ("timerow", "t", 1, ("std_2019", "std_2020"))
    assert mesh.leaf_views(["row", "f", 7]) == ("f", (VIEW_STANDARD,))
    assert mesh.leaf_views(["bsicond", "v", ">", [10]]) \
        == ("v", (VIEW_BSI_GROUP_PREFIX + "v",))
    assert mesh.leaf_views(["timerow", "t", 1, ["a", "b"]]) \
        == ("t", ("a", "b"))


def _block(fill=0):
    b = np.zeros((2, WORDS_PER_ROW), dtype=np.uint32)
    if fill:
        b[0, 0] = fill
    return b


def _key(index="i", field="f", row=1, seg_len=2, shards=(0, 1)):
    return (index, ("row", field, row), seg_len, tuple(shards))


def _both(scenario):
    """Run `scenario(module)` against both packages' meshstacks; the
    returned traces must be equal."""
    port, ref = scenario(mesh), scenario(jmesh)
    assert port == ref
    return port


def test_mesh_cache_hit_requires_matching_gens():
    def scenario(mod):
        c = mod.MeshStackCache()
        key, gens = _key(), ((1, 1), (2, 1))
        arr = object()  # the cache holds the block opaquely
        out = [c.get(key, gens) is None]
        c.put(key, gens, arr, _block(3))
        out.append(c.get(key, gens) is arr)
        # a local write bumps a fragment generation: entry invalidated
        out.append(c.get(key, ((1, 2), (2, 1))) is None)
        return out, c.stats()

    trace, s = _both(scenario)
    assert trace == [True, True, True]
    assert s["hits"] == 1 and s["misses"] == 2
    assert s["invalidations"] == 1
    assert s["entries"] == 0 and s["bytes"] == 0


def test_mesh_cache_lru_eviction_and_ledger():
    nbytes = _block().size * 4

    def scenario(mod):
        c = mod.MeshStackCache(max_bytes=nbytes)  # room for one block
        g = ((1, 1),)
        c.put(_key(row=1), g, object(), _block(1))
        c.put(_key(row=2), g, object(), _block(2))
        return c.evictions, c.get(_key(row=1), g) is None, c.stats()

    evictions, victim_gone, s = _both(scenario)
    assert evictions == 1 and victim_gone  # the LRU victim
    assert s["entries"] == 1 and s["bytes"] == nbytes
    # the HBM ledger tracks the surviving entry only, tagged by repr
    assert sum(e["bytes"] for e in s["ledger"]) == nbytes
    assert all(e["index"] == "i" and e["field"] == "f"
               for e in s["ledger"])


def test_mesh_cache_shadow_probe_digest():
    def scenario(mod):
        c = mod.MeshStackCache()
        key, gens = _key(), ((1, 1),)
        c.shadow_probe(key, gens, _block(5))  # miss: parks the digest
        parked = c.stats()["bytes"]
        c.shadow_probe(key, gens, _block(5))  # same content: clean hit
        c.shadow_probe(key, gens, _block(6))  # same gens, new content
        # a shadow-parked (block-less) entry never serves the hot path
        return parked, c.stats()["shadow"], c.get(key, gens) is None

    parked, shadow, unserved = _both(scenario)
    assert parked == 0
    assert shadow == {"probes": 3, "hits": 2, "mismatches": 1}
    assert unserved


def test_mesh_cache_invalidate_index():
    def scenario(mod):
        c = mod.MeshStackCache()
        g = ((1, 1),)
        c.put(_key(index="a"), g, object(), _block(1))
        c.put(_key(index="b"), g, object(), _block(2))
        c.invalidate_index("a")
        return (c.get(_key(index="a"), g) is None,
                c.get(_key(index="b"), g) is not None, c.stats())

    a_gone, b_kept, s = _both(scenario)
    assert a_gone and b_kept and s["entries"] == 1


# -- the batch step's counts --------------------------------------------------


def _popcount(arr):
    return int(np.unpackbits(arr.view(np.uint8)).sum())


def _np_eval(sig, stacks):
    if sig[0] == "leaf":
        return stacks[sig[1]]
    op, subs = sig
    acc = _np_eval(subs[0], stacks)
    for s in subs[1:]:
        p = _np_eval(s, stacks)
        acc = {"&": acc & p, "|": acc | p, "^": acc ^ p, "-": acc & ~p}[op]
    return acc


def test_count_batch_partial_matches_serial_counts():
    """K trees, one launch: mixed signatures (the multi-tree entry) and
    one repeated signature (the batched entry, as bucket padding makes
    it) both give the serial per-tree counts in plan order, equal to K
    serial count_partials and to the reference's one-program
    _count_batch_fn."""
    from pilosa_tpu_torch.ops import count_expr as k1
    from pilosa_tpu_torch.parallel.sharded import ShardedQueryEngine

    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 2**32, size=(4, WORDS_PER_ROW),
                         dtype=np.uint32) for _ in range(2))
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    leaf = ("leaf", 0)
    inter = ("&", (("leaf", 0), ("leaf", 1)))
    diff = ("-", (("leaf", 0), ("leaf", 1)))
    cases = [
        # (sigs, arities, host stacks, port members)
        ((leaf, inter, leaf, leaf), (1, 2, 1, 1), [a, a, b, a, a],
         [[ta], [ta, tb], [ta], [ta]]),
        ((inter, inter, inter), (2, 2, 2), [a, b, b, a, a, b],
         [[ta, tb], [tb, ta], [ta, tb]]),
        ((diff, leaf), (2, 1), [a, b, b], [[ta, tb], [tb]]),
    ]
    ref = _ref_plane("on")
    for sigs, arities, stacks, members in cases:
        hilo = np.asarray(ref._count_batch_fn(sigs, arities)(*stacks))
        want = [(int(h) << 16) + int(lo) for h, lo in zip(hilo[0], hilo[1])]
        offs = np.cumsum((0,) + arities[:-1])
        assert want == [_popcount(_np_eval(s, stacks[o:o + n]))
                        for s, o, n in zip(sigs, offs, arities)]
        serial = [int(ShardedQueryEngine.count_partial(s, m)[0])
                  for s, m in zip(sigs, members)]
        got = ShardedQueryEngine.count_batch_partial(sigs, members,
                                                     k1.MultiProgram())
        assert got.dtype == torch.int64 and got.shape == (len(sigs),)
        assert got.tolist() == serial == want


def test_count_batch_partial_routes_by_signature(monkeypatch):
    """One signature and one leaf count take K1's batched entry; mixed
    ones its multi-tree entry: one call each, never K count_expr calls."""
    from pilosa_tpu_torch.ops import count_expr as k1
    from pilosa_tpu_torch.parallel.sharded import ShardedQueryEngine

    calls = []
    for name in ("count_expr", "count_expr_batch", "count_expr_multi"):
        real = getattr(k1, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(k1, name, spy)
    t = torch.ones((2, WORDS_PER_ROW), dtype=torch.int32)
    leaf, inter = ("leaf", 0), ("&", (("leaf", 0), ("leaf", 1)))
    ShardedQueryEngine.count_batch_partial([leaf] * 4, [[t]] * 4)
    assert calls == ["count_expr_batch"]
    ShardedQueryEngine.count_batch_partial([leaf, inter], [[t], [t, t]])
    assert calls == ["count_expr_batch", "count_expr_multi"]


# -- coalescer adapter --------------------------------------------------------


def test_spmd_batch_runner_contract():
    """The drain loop's executor contract: Count-only batchability, and
    launch defers all work to resolve (launch runs under the coalescer
    lock; the collective must not)."""

    class _Api:
        spmd = _plane("on")

    class _RefApi:
        spmd = _ref_plane("on")

    r = SpmdBatchRunner(_Api())
    ref = jspmd.SpmdBatchRunner(_RefApi())
    assert r.BATCHABLE_CALLS == ref.BATCHABLE_CALLS == frozenset(("Count",))
    queries = ["Count(Row(f=1))"] * 3
    assert r.launch_batch("i", queries) == ref.launch_batch("i", queries) \
        == (None, ("i", queries))


def test_cluster_executor_exposes_batchable_calls():
    from pilosa_tpu.cluster.executor import ClusterExecutor as JCE
    from pilosa_tpu_torch.cluster.executor import ClusterExecutor

    assert ClusterExecutor.BATCHABLE_CALLS == JCE.BATCHABLE_CALLS \
        == frozenset(("Count",))


# -- EXPLAIN annotations ------------------------------------------------------


def test_plan_node_and_psum_bytes():
    from pilosa_tpu_torch.pql import parse

    call = parse("Count(Row(f=1))").calls[0]
    node = _plane("on").plan_node(None, call, [0, 1, 2])
    ref = _ref_plane("on").plan_node(None, call, [0, 1, 2])
    assert node["strategy"] == ref["strategy"] == "spmd-collective"
    ann = node["annotations"]
    assert set(ann) == set(ref["annotations"])
    assert ann["spmd"] is True
    assert ann["dispatches"] == 0  # zero per-node fan-out dispatches
    assert ann["shards"] == 3
    assert ann["mesh"] == [1, 1]  # one rank, one card per rank
    for kind, result in (("count", 5), ("topn", [1, 2, 3])):
        assert SpmdDataPlane._psum_bytes(kind, result) \
            == jspmd.SpmdDataPlane._psum_bytes(kind, result)
    assert SpmdDataPlane._psum_bytes("count", 5) == 8
    assert SpmdDataPlane._psum_bytes("topn", [1, 2, 3]) == 24


def test_plan_eligible_gated_on_serve_mode():
    from pilosa_tpu_torch.pql import parse

    call = parse("Count(Row(f=1))").calls[0]
    for mode in ("off", "http", "on"):
        # serve on with no cluster still declines (no group to serve)
        assert _plane(mode).plan_eligible(None, call) is False
        assert _ref_plane(mode).plan_eligible(None, call) is False


# -- fusion ledger: mesh programs --------------------------------------------


def test_fusion_mesh_program_key_and_touch():
    from pilosa_tpu.exec import fusion as jfusion
    from pilosa_tpu_torch.exec import fusion
    from pilosa_tpu_torch.ops.count_expr import MultiProgram

    sigs = (("leaf", 0),)
    key = fusion.mesh_program_key("fp1", sigs, 4, [3, 1])
    assert key == jfusion.mesh_program_key("fp1", sigs, 4, [3, 1]) \
        == ("fp1", sigs, 4, (3, 1))
    fusion.reset()
    try:
        plane = _plane("on")
        fn_key = ("count_batch", sigs, (1,))
        plane._fn_specs[fn_key] = MultiProgram()
        assert not fusion.touch_mesh_program(key, plane, fn_key,
                                             compile_ms=12.0)
        # the second touch is a program-cache hit
        assert fusion.touch_mesh_program(key, plane, fn_key)
        entries = [e for e in fusion.snapshot()["programs"]
                   if e["fingerprint"] == "fp1"]
        assert entries and entries[0]["mesh"] == [3, 1]
        assert entries[0]["hits"] == 2 and entries[0]["compile_ms"] == 12.0
        assert fusion.snapshot()["decisions"]["fused"] == 2
        # the LRU drops the plane's program table with the entry
        fusion.configure(cache_size=1)
        fusion.touch_mesh_program(
            fusion.mesh_program_key("fp2", sigs, 4, [3, 1]), plane,
            ("count_batch", sigs, (2,)))
        assert fn_key not in plane._fn_specs
    finally:
        fusion.reset()


# -- step lifecycle events, read by the reference's wedge classifier ---------


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench_for_torch_spmd_wedge", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class _Node:
    def __init__(self, node_id):
        self.id = node_id
        self.uri = "http://" + node_id
        self.state = "READY"


class _Cluster:
    """A static cluster view: `nodes` (ids), this node's id, no peers."""

    def __init__(self, ids, local_id):
        self.nodes = [_Node(i) for i in ids]
        self.local_id = local_id
        self.coordinator = self.nodes[0]

    def peers(self):
        return [n for n in self.nodes if n.id != self.local_id]


def test_classify_wedge_spmd_lifecycle(tmp_path):
    """The port's plane records the step-lifecycle events the TPU
    package's classifier (bench._classify_wedge) reads, with the same
    kinds and tags: a finished step reads healthy; a coordinator that
    announced but never entered its step reads spmd_never_entered; a
    step inside its collective reads spmd_collective_hung; a launch open
    inside a step reads dispatch_wedge."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.utils import flightrec

    bench = _bench()
    up = {"state": "UP"}
    flightrec.configure(256)
    try:
        def tail():
            return flightrec.snapshot()

        def fresh():
            flightrec.configure(256)

        # a finished step: healthy
        fresh()
        p = _plane("on")
        p._run_step_locked = lambda step: 0
        p.run_step({"seq": 4, "index": "i", "kind": "count"})
        assert bench._classify_wedge("main", tail(), up) == "unclassified"

        # inside its collective: entered, not exited
        fresh()
        inside, release = threading.Event(), threading.Event()

        def blocked(step):
            inside.set()
            release.wait(10)
            return 0

        p._run_step_locked = blocked
        t = threading.Thread(target=p.run_step,
                             args=({"seq": 5, "index": "i"},))
        t.start()
        assert inside.wait(10)
        assert bench._classify_wedge("main", tail(), up) \
            == "spmd_collective_hung"
        release.set()
        t.join(10)
        assert bench._classify_wedge("main", tail(), up) == "unclassified"

        # announced (a seq assigned, fanned out) but never entered
        fresh()
        coord = SpmdDataPlane(None, _Cluster(["n0"], "n0"), None,
                              serve_mode="on")
        stuck, release = threading.Event(), threading.Event()

        def never_enters(step):
            stuck.set()
            release.wait(10)
            return 0

        coord._enter_exit_run = never_enters
        t = threading.Thread(target=coord._execute_step,
                             args=({"index": "i", "kind": "count"},))
        t.start()
        assert stuck.wait(10)
        assert bench._classify_wedge("main", tail(), up) \
            == "spmd_never_entered"
        release.set()
        t.join(10)

        # a launch open inside a step: the inner hang outranks the step
        fresh()
        holder = Holder(str(tmp_path / "h"), use_snapshot_queue=False).open()
        try:
            p = _plane("on")
            p._local_exec = Executor(holder, device="cpu")
            inside, release = threading.Event(), threading.Event()

            def launching(step):
                with p._dispatch("count", 0, 8):
                    inside.set()
                    release.wait(10)
                return 0

            p._run_step_locked = launching
            t = threading.Thread(target=p.run_step,
                                 args=({"seq": 6, "index": "i"},))
            t.start()
            assert inside.wait(10)
            assert bench._classify_wedge("main", tail(), up) \
                == "dispatch_wedge"
            release.set()
            t.join(10)
        finally:
            holder.close()
    finally:
        flightrec.configure(flightrec.DEFAULT_RING_SIZE)


# -- /debug/spmd on a node without a plane -----------------------------------


def test_debug_spmd_disabled_node():
    from pilosa_tpu.server import ClientError as JClientError
    from pilosa_tpu_torch.server import ClientError
    from pilosa_tpu_torch.tools.cluster import NodeHarness

    h, ref = NodeHarness(device="cpu"), ServerHarness()
    try:
        body = json.dumps({"serve_mode": "on"}).encode()
        for client, err in ((h.client, ClientError),
                            (ref.client, JClientError)):
            assert client._request("GET", "/debug/spmd") \
                == {"enabled": False}
            with pytest.raises(err) as e:
                client._request("POST", "/debug/spmd", body=body)
            assert e.value.status == 400
    finally:
        h.close()
        ref.close()


def test_api_batch_executor_single_node_is_local():
    """Without a cluster the coalescer drains into the local batched
    pipeline, as before."""
    from pilosa_tpu_torch.tools.cluster import NodeHarness

    h = NodeHarness(device="cpu")
    try:
        ex = h.api.batch_executor()
        assert not isinstance(ex, SpmdBatchRunner)
        assert hasattr(ex, "launch_batch")
        assert ex is h.api.local_executor
    finally:
        h.close()


# -- the cache-aware leaf gather on one rank ---------------------------------


def test_leaf_blocks_hit_invalidate_and_shadow(tmp_path):
    """On a one-rank plane (no process group) over a real holder: serve
    on fills the cache on the first step and serves the warm one from
    it (no gather: the `spmd.gather` fault point stays unreached); a
    write to one shard invalidates that leaf and the next step reads the
    bit; serve shadow gathers and probes, serve off leaves the cache
    alone. Every count equals numpy."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.parallel.sharded import ShardedQueryEngine
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils import faultpoints

    holder = Holder(str(tmp_path / "h"), use_snapshot_queue=False).open()
    try:
        idx = holder.create_index("i")
        for name in ("f", "g"):
            idx.create_field(name)
        cols = [s * SHARD_WIDTH + off for s in range(3)
                for off in (1, 70, 4000)]
        for c in cols:
            idx.field("f").set_bit(1, c)
        for c in cols[::2]:
            idx.field("g").set_bit(2, c)
        p = SpmdDataPlane(holder, _Cluster(["n0"], "n0"), None,
                          serve_mode="on")
        p._local_exec = Executor(holder, device="cpu")
        p._sharded = ShardedQueryEngine(devices="cpu")
        step = {"index": "i", "segments": {"n0": [0, 1, 2]}, "seg_len": 3,
                "dev_pp": 1, "nodes": ["n0"], "kind": "count",
                "sig": ["&", [["leaf", 0], ["leaf", 1]]],
                "leaves": [["row", "f", 1], ["row", "g", 2]]}

        def count():
            p._step_id += 1
            return p._enter_exit_run(dict(step, step=p._step_id))

        want = len(cols[::2])
        assert count() == want
        s = p.mesh_cache.stats()
        assert (s["misses"], s["hits"], s["entries"]) == (2, 0, 2)
        assert s["bytes"] == 2 * 3 * WORDS_PER_ROW * 4
        faultpoints.arm("spmd.gather=raise")
        try:
            assert count() == want  # no gather on a warm step
        finally:
            faultpoints.disarm("spmd.gather")
        assert p.mesh_cache.stats()["hits"] == 2
        # a write into shard 1 of g: that leaf is stale, f stays warm
        idx.field("g").set_bit(2, SHARD_WIDTH + 1)
        assert count() == want + 1
        s = p.mesh_cache.stats()
        assert (s["hits"], s["misses"], s["invalidations"]) == (3, 3, 1)
        # shadow: the gather serves, each block probes the cache
        p.set_serve_mode("shadow")
        assert count() == want + 1
        sh = p.mesh_cache.stats()["shadow"]
        assert sh == {"probes": 2, "hits": 2, "mismatches": 0}
        # off: the cache is not touched
        p.set_serve_mode("off")
        before = p.mesh_cache.stats()
        assert count() == want + 1
        assert p.mesh_cache.stats() == before
        assert p.steps_entered == p.steps_exited == 5
    finally:
        holder.close()


# -- two ranks that ran different steps --------------------------------------


def _rank_main(rank, port, out):
    """One child rank of a 2-rank gloo group: the plane's collectives
    with matching and with different step numbers."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=120))
    from pilosa_tpu_torch.parallel.sharded import ShardedQueryEngine

    nodes = ["n0", "n1"]
    p = SpmdDataPlane(None, _Cluster(nodes, nodes[rank]), None)
    p._sharded = ShardedQueryEngine(devices="cpu")

    def local():
        return torch.tensor([rank + 1, 10 * (rank + 1)], dtype=torch.int64)

    res = {"rank": rank}

    def attempt(name, step, gather=False):
        fn = p._gather_collective if gather else p._collective
        try:
            res[name] = fn(dict(step, nodes=nodes, kind="count"), 2, local)
        except SpmdError as e:
            res[name] = "raised: " + str(e)

    attempt("same", {"step": 9})
    attempt("mismatch", {"step": 7 + rank})
    attempt("same_gather", {"step": 11}, gather=True)
    attempt("mismatch_gather", {"step": 12 + rank}, gather=True)
    res["seq_mismatches"] = p.seq_mismatches
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("torch_spmd_serve_ranks", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ranks_on_different_steps_raise_on_every_rank(tmp_path):
    """gloo pairs collectives by call order: two ranks that enter one
    all_reduce (or all_gather) for different steps must both raise, and
    neither returns a sum; the same step number sums as usual."""
    port = str(_free_port())
    code = _CHILD.format(path=os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), port,
         str(tmp_path / f"rank{rank}.json")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    assert time.monotonic() - t0 < 180
    ranks = []
    for rank in (0, 1):
        with open(tmp_path / f"rank{rank}.json") as f:
            ranks.append(json.load(f))
    for r in ranks:
        assert r["same"] == [3, 30]
        assert r["same_gather"] == [[1, 10], [2, 20]]
        for name in ("mismatch", "mismatch_gather"):
            assert isinstance(r[name], str), (name, r)
            assert r[name].startswith("raised: ") \
                and "different steps" in r[name]
        assert r["seq_mismatches"] == 2
