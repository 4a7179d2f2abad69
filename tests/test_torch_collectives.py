"""The collective plane's data group (`parallel.sharded.collective_backend`,
`ShardedQueryEngine(data_group=...)`, `SpmdDataPlane`'s two-phase
collectives) on the CPU.

- `collective_backend` over identity maps: NCCL exactly when every rank
  is on a card of its own (cards compared by UUID, so cuda:0 on two
  hosts is two cards), NCCL is available, and no rank is on the CPU.
- Three spawned CPU ranks (`OMP_NUM_THREADS=1`, trap 37) join one gloo
  world, choose the backend from their identities (gloo: CPU ranks form
  no data group), then make a second gloo group that stands in for the
  NCCL data group, so that every step takes the two phases an NCCL
  group takes: the failure and step slots voted over the control group,
  then the partial over the data group. Their answers equal the TPU
  package's sharded engine on its 8-device CPU mesh on the same seeded
  inputs. With the `spmd.launch` fault point armed on one rank (and
  with one rank on another step number), every rank raises and no rank
  enters the data collective: the engine's `data_collectives` counter
  stays where it was on every rank; the next step then serves.
- A data group chosen as NCCL that cannot come up (this torch has no
  NCCL) fails the boot: no fallback to gloo is recorded.

The card's side (an NCCL group of one) is in tests/test_torch_cuda.py.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pilosa_tpu_torch.parallel.sharded import (card_identity,
                                               collective_backend)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 21
WORDS = 1 << 15  # words per shard (2^20 columns)
SHARDS = 24  # a multiple of the 3 ranks and of the reference's 8 devices
RANKS = 3
DEPTH = 10


# -- the backend choice -------------------------------------------------------

@pytest.mark.parametrize("ids, nccl, want", [
    # distinct cards on one host
    ([("h", "GPU-a"), ("h", "GPU-b"), ("h", "GPU-c")], True, "nccl"),
    # two ranks on one card: NCCL refuses them (trap 34)
    ([("h", "GPU-a"), ("h", "GPU-a"), ("h", "GPU-b")], True, "gloo"),
    # cuda:0 on two hosts: two cards, by UUID
    ([("h1", "GPU-a"), ("h2", "GPU-b")], True, "nccl"),
    # any CPU rank keeps the whole group on gloo
    ([("h", "GPU-a"), "cpu", ("h", "GPU-b")], True, "gloo"),
    (["cpu", "cpu", "cpu"], True, "gloo"),
    # NCCL unavailable
    ([("h", "GPU-a"), ("h", "GPU-b")], False, "gloo"),
    # one rank on its card, as the identities travel (lists)
    ([["h", "GPU-a"]], True, "nccl"),
    ([], True, "gloo"),
], ids=["distinct-cards", "shared-card", "two-hosts-uuid", "one-cpu-rank",
        "cpu-ranks", "no-nccl", "one-rank", "no-ranks"])
def test_collective_backend(ids, nccl, want):
    assert collective_backend(ids, nccl) == want


def test_cpu_identity():
    assert card_identity("cpu") == "cpu"


# -- three CPU ranks ----------------------------------------------------------

def _plane_words(rng, n):
    cols = rng.choice(WORDS * 32, size=n, replace=False)
    bits = np.zeros(WORDS * 32, dtype=np.uint8)
    bits[cols] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _stack(rng, n):
    return np.stack([_plane_words(rng, n) for _ in range(SHARDS)])


def make_inputs():
    """Every case's numpy inputs and the BSI values, from SEED."""
    rng = np.random.default_rng(SEED)
    out = {"a": _stack(rng, 4000), "b": _stack(rng, 2500),
           "c": _stack(rng, 3000),
           "rows": np.stack([_stack(rng, n) for n in (50, 3000, 700, 90)]),
           "rows2": np.stack([_stack(rng, n) for n in (2000, 400, 1200)]),
           "filt": _stack(rng, 60000)}
    planes = np.zeros((DEPTH, SHARDS, WORDS), dtype=np.uint32)
    sign = np.zeros((SHARDS, WORDS), dtype=np.uint32)
    exists = np.zeros((SHARDS, WORDS), dtype=np.uint32)
    values = []
    for s in range(SHARDS):
        cols = rng.choice(WORDS * 32, 40, replace=False)
        vals = rng.integers(-(1 << DEPTH) + 1, 1 << DEPTH, 40)
        for col, v in zip(cols, vals):
            w, bit = divmod(int(col), 32)
            mask = np.uint32(1 << bit)
            exists[s, w] |= mask
            if v < 0:
                sign[s, w] |= mask
            for i in range(DEPTH):
                if (abs(int(v)) >> i) & 1:
                    planes[i, s, w] |= mask
        values.extend(int(v) for v in vals)
    out.update(planes=planes, sign=sign, exists=exists,
               values=np.array(values, dtype=np.int64))
    return out


class _Node:
    def __init__(self, node_id):
        self.id = node_id


class _Cluster:
    """A static cluster view: `nodes` (ids) and this node's id."""

    def __init__(self, ids, local_id):
        self.nodes = [_Node(i) for i in ids]
        self.local_id = local_id
        self.coordinator = self.nodes[0]


def _step_outcome(fn):
    """(result, None) or (None, the raised exception's class name)."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — the test compares the class
        return None, type(e).__name__


def _rank_main(rank, port, inputs, out):
    """One child rank of the 3-rank group."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank,
                            timeout=timedelta(seconds=120))
    from pilosa_tpu_torch.cluster.spmd import SpmdDataPlane, combine_minmax
    from pilosa_tpu_torch.exec.stacked import minmax_decode, minmax_walk
    from pilosa_tpu_torch.ops.count_expr import chain_signature
    from pilosa_tpu_torch.parallel import ShardedQueryEngine
    from pilosa_tpu_torch.utils import faultpoints

    res = {"rank": rank}
    # the boot's choice over CPU ranks: gloo, and no data group of its own
    res["boot_backend"] = SpmdDataPlane.form_data_group(
        torch.device("cpu"))
    res["boot_data_group"] = SpmdDataPlane._data_group is not None
    data = dist.new_group(backend="gloo")  # stands in for the NCCL group
    eng = ShardedQueryEngine(devices="cpu", data_group=data)
    with np.load(inputs) as npz:
        inp = {k: npz[k] for k in npz.files}
    a, b, c = (eng.place(inp[k]) for k in "abc")
    res["count"] = eng.count_intersect(a, b)
    res["expr"] = [eng.query_step([a, b], "|"),
                   eng.query_step([a, b, c], "&|")]
    filt = eng.place(inp["filt"])
    vals, order = eng.topn_step(eng.place(inp["rows"]), filt, 3)
    res["topn"] = [[int(v) for v in vals], [int(i) for i in order]]
    res["pairwise"] = eng.pairwise_step(
        eng.place(inp["rows"]), eng.place(inp["rows2"]), filt).tolist()
    bsi = [eng.place(inp[k]) for k in ("planes", "sign", "exists")]
    res["sum"] = list(eng.sum_step(*bsi, None))

    # the plane's two phases over the data group
    nodes = [f"n{i}" for i in range(RANKS)]
    plane = SpmdDataPlane(None, _Cluster(nodes, nodes[rank]), None)
    plane._sharded = eng
    res["plane_backend"] = plane.collective_backend
    res["stats_backend"] = plane.stats()["collective_backend"]

    def count_local(fault=False):
        def local():
            if fault:
                plane._fault_point()
            return plane._fetch(eng.count_partial(
                chain_signature(2, "&"), [a, b]))
        return local

    def minmax_local(is_max, fault=False):
        def local():
            if fault:
                plane._fault_point()
            walk = minmax_walk(bsi[0], bsi[1], bsi[2], None, is_max)
            ne, neg, mag, cnt = minmax_decode(
                plane._fetch(walk, host=True).tolist())
            return torch.tensor([int(ne), int(neg), mag, cnt])
        return local

    def step(n, kind="count"):
        return {"step": n, "kind": kind, "nodes": nodes}

    res["plane_count"] = plane._collective(step(1), 1, count_local())[0]
    res["plane_max"] = list(combine_minmax(plane._gather_collective(
        step(2, "minmax"), 4, minmax_local(True)), True))
    res["plane_min"] = list(combine_minmax(plane._gather_collective(
        step(3, "minmax"), 4, minmax_local(False)), False))
    clean = eng.data_collectives
    # a card failure on rank 1 at the step's launch (the fault point
    # fires once an arming)
    if rank == 1:
        faultpoints.arm("spmd.launch=raise")
    res["fault_count"] = _step_outcome(lambda: plane._collective(
        step(4), 1, count_local(fault=rank == 1)))[1]
    if rank == 1:
        faultpoints.arm("spmd.launch=raise")
    res["fault_minmax"] = _step_outcome(lambda: plane._gather_collective(
        step(5, "minmax"), 4, minmax_local(True, fault=rank == 1)))[1]
    faultpoints.disarm()
    # rank 2 on another step number (gloo pairs collectives by order)
    res["mismatch"] = _step_outcome(lambda: plane._collective(
        step(7 if rank == 2 else 6), 1, count_local()))[1]
    res["data_collectives"] = [clean, eng.data_collectives]
    res["steps_run"] = plane.steps_run
    res["seq_mismatches"] = plane.seq_mismatches
    # nobody was left inside a collective: the next step serves
    res["after"] = plane._collective(step(8), 1, count_local())[0]
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("torch_collective_ranks",
                                              {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The three children's results, in rank order."""
    tmp = tmp_path_factory.mktemp("collectives")
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    port = str(_free_port())
    code = _CHILD.format(path=os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), port, path,
         str(tmp / f"rank{rank}.json")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(RANKS)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert [p.returncode for p in procs] == [0] * RANKS, "\n".join(logs)
    out = []
    for rank in range(RANKS):
        with open(tmp / f"rank{rank}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    """The TPU package's answers on its 8-device CPU mesh."""
    jax = pytest.importorskip("jax")
    import jax.sharding as jsh

    from pilosa_tpu.parallel import ShardedQueryEngine

    assert len(jax.devices()) == 8, "the reference runs on 8 CPU devices"
    engine = ShardedQueryEngine()
    place = engine.place

    def rows(x):
        return jax.device_put(x, jsh.NamedSharding(
            engine.mesh, jsh.PartitionSpec(None, engine.axis)))

    a, b, c = (place(inputs[k]) for k in "abc")
    filt = place(inputs["filt"])
    vals, order = engine.topn_step(rows(inputs["rows"]), filt, 3)
    total, count = engine.sum_step(
        rows(inputs["planes"]), place(inputs["sign"]),
        place(inputs["exists"]),
        place(np.full((SHARDS, WORDS), 0xFFFFFFFF, dtype=np.uint32)))
    return {
        "count": engine.count_intersect(a, b),
        "expr": [engine.query_step([a, b], "|"),
                 engine.query_step([a, b, c], "&|")],
        "topn": [[int(v) for v in vals], [int(i) for i in order]],
        "pairwise": np.asarray(engine.pairwise_step(
            rows(inputs["rows"]), rows(inputs["rows2"]), filt)).tolist(),
        "sum": [int(total), int(count)],
    }


@pytest.mark.parametrize("case", ["count", "expr", "topn", "pairwise",
                                  "sum"])
def test_answers_equal_reference_over_data_group(ranks, reference, case):
    """Every rank holds the reduced answer, equal to the reference's."""
    assert [r[case] for r in ranks] == [reference[case]] * RANKS


def test_cpu_ranks_choose_gloo_and_form_no_data_group(ranks):
    assert [(r["boot_backend"], r["boot_data_group"]) for r in ranks] \
        == [("gloo", False)] * RANKS
    # the stand-in data group is gloo: the plane reports it
    assert {r["plane_backend"] for r in ranks} == {"gloo"}
    assert {r["stats_backend"] for r in ranks} == {"gloo"}


def test_plane_two_phases_answer(ranks, inputs):
    """A Count step and both Min/Max steps through the vote and the data
    collective, equal to numpy on every rank."""
    a, b = inputs["a"], inputs["b"]
    want = int(np.unpackbits((a & b).view(np.uint8)).sum())
    vals = inputs["values"]
    hi, lo = int(vals.max()), int(vals.min())
    for r in ranks:
        assert r["plane_count"] == want == r["count"]
        assert r["plane_max"] == [False, hi < 0, abs(hi),
                                  int((vals == hi).sum())]
        assert r["plane_min"] == [False, lo < 0, abs(lo),
                                  int((vals == lo).sum())]
        assert r["after"] == want


def test_failure_raises_on_every_rank_before_the_data_collective(ranks):
    """The fault point armed on rank 1 at the launch: every rank raises
    the card failure from the vote, the Min/Max gather too, and a step
    number mismatch raises everywhere; through all three no rank entered
    the data collective (its counter did not move on any rank)."""
    assert [r["fault_count"] for r in ranks] \
        == ["SpmdDeviceFailure"] * RANKS
    assert [r["fault_minmax"] for r in ranks] \
        == ["SpmdDeviceFailure"] * RANKS
    assert [r["mismatch"] for r in ranks] == ["SpmdError"] * RANKS
    assert [r["seq_mismatches"] for r in ranks] == [1] * RANKS
    for r in ranks:
        clean, after = r["data_collectives"]
        # 9 clean data collectives before (the engine's 6 steps, the
        # plane's Count and its two Min/Max gathers), none through the
        # faults
        assert clean == 9 and after == clean, r["data_collectives"]
    # every step of the plane ran on every rank (the failed ones too)
    assert [r["steps_run"] for r in ranks] == [6] * RANKS


_BOOT_CHILD = """
import sys
import torch
import torch.distributed as dist
from pilosa_tpu_torch.cluster.spmd import SpmdDataPlane
from pilosa_tpu_torch.parallel import sharded

dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1),
                        world_size=1, rank=0)
# every rank's identity says NCCL, but this torch (or this rank) cannot
# bring an NCCL group up
sharded.collective_backend = lambda ids, available: "nccl"
try:
    SpmdDataPlane.form_data_group(torch.device("cpu"))
except Exception as e:
    print("raised", type(e).__name__)
print("backend", SpmdDataPlane._backend,
      "group", SpmdDataPlane._data_group is not None)
dist.destroy_process_group()
"""


def test_chosen_nccl_that_does_not_come_up_fails_the_boot(tmp_path):
    """A data group chosen as NCCL that cannot start raises out of the
    boot; the plane never falls back to gloo behind it (no data group
    and no backend recorded)."""
    proc = subprocess.run(
        [sys.executable, "-c", _BOOT_CHILD, str(tmp_path / "store")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("raised "), proc.stdout
    assert lines[-1] == "backend gloo group False"
