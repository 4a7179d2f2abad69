"""The port's sharded engine (pilosa_tpu_torch/parallel/sharded.py) on a
group of ranks, held exactly to the TPU package's ShardedQueryEngine on
its 8-device CPU mesh.

The cases of the TPU package's tests/test_sharded.py (6),
tests/test_pallas.py::test_query_kernels_dispatch_sharded_inputs and
tests/test_stacked_serving.py::test_count_overflow_over_mesh, plus
pad_shards, each on:
- a group of one rank in this process (no process group, no launcher);
- a 2-rank gloo group: two spawned `python` children on 127.0.0.1, each
  holding its half of every stack (`place`), counting it with the
  kernels' plain versions and meeting the other in one all_reduce;
- one rank over 8 local parts ("1x8", `devices=["cpu"] * 8`), as the
  reference's mesh holds 8 devices: each stack split into 8 pieces,
  each kernel once per piece, the partials summed in the process.

The inputs are numpy stacks drawn from a seed in this process; the
children read them from a file. Answers are compared as exact int64.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 42
WORDS = 1 << 15  # words per shard (2^20 columns)
OVERFLOW_SHARDS = 2056  # all-ones shards: a count past 2^31


def _plane(rng, n):
    """A [WORDS] uint32 plane with n distinct random columns set."""
    cols = rng.choice(WORDS * 32, size=n, replace=False)
    bits = np.zeros(WORDS * 32, dtype=np.uint8)
    bits[cols] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _stack(rng, n_shards, n):
    return np.stack([_plane(rng, n) for _ in range(n_shards)])


def make_inputs():
    """Every case's numpy inputs, from SEED."""
    rng = np.random.default_rng(SEED)
    out = {"a8": _stack(rng, 8, 5000), "b8": _stack(rng, 8, 3000),
           "c8": _stack(rng, 8, 5000), "a5": _stack(rng, 5, 5000),
           "b5": _stack(rng, 5, 3000), "a4": _stack(rng, 4, 5000),
           "b4": _stack(rng, 4, 3000),
           "topn": np.stack([_stack(rng, 8, size)
                             for size in (100, 5000, 50, 2000)]),
           "filt": np.full((8, WORDS), 0xFFFFFFFF, dtype=np.uint32)}
    # BSI: 8 shards of 500 random signed values each, depth 10
    depth = 10
    planes = np.zeros((depth, 8, WORDS), dtype=np.uint32)
    sign = np.zeros((8, WORDS), dtype=np.uint32)
    exists = np.zeros((8, WORDS), dtype=np.uint32)
    for s in range(8):
        cols = rng.choice(100_000, 500, replace=False)
        vals = rng.integers(-500, 500, 500)
        for c, v in zip(cols, vals):
            w, b = divmod(int(c), 32)
            bit = np.uint32(1 << b)
            exists[s, w] |= bit
            if v < 0:
                sign[s, w] |= bit
            for i in range(depth):
                if (abs(int(v)) >> i) & 1:
                    planes[i, s, w] |= bit
    out.update(planes=planes, sign=sign, exists=exists)
    return out


def run_port_cases(engine, inp):
    """Every case on the port's engine (one rank of its group): the
    answers as JSON-able Python values."""
    from pilosa_tpu_torch.parallel import QueryKernels
    import torch

    place = engine.place
    zeros = np.zeros((WORDS,), dtype=np.uint32)

    def padded(stack, n):
        extra = np.stack([zeros] * (n - len(stack))) if n > len(stack) \
            else np.zeros((0, WORDS), np.uint32)
        return np.concatenate([stack, extra])

    res = {}
    res["count_intersect"] = engine.count_intersect(place(inp["a8"]),
                                                    place(inp["b8"]))
    pad = engine.pad_shards(5)
    res["padded"] = engine.count_intersect(place(padded(inp["a5"], pad)),
                                           place(padded(inp["b5"], pad)))
    a, b, c = place(inp["a8"]), place(inp["b8"]), place(inp["c8"])
    res["expr"] = [engine.query_step([a, b], "&"),
                   engine.query_step([a, b], "|"),
                   engine.query_step([a, b], "-"),
                   engine.query_step([a, b, c], "&|")]
    vals, idx = engine.topn_step(place(inp["topn"]), place(inp["filt"]), 2)
    res["topn"] = [[int(v) for v in vals], [int(i) for i in idx]]
    full = place(np.full((8, WORDS), 0xFFFFFFFF, dtype=np.uint32))
    res["sum"] = list(engine.sum_step(
        place(inp["planes"]), place(inp["sign"]), place(inp["exists"]),
        full))
    a4 = torch.from_numpy(inp["a4"].view(np.int32))
    b4 = torch.from_numpy(inp["b4"].view(np.int32))
    res["single_device"] = [int(QueryKernels.count_intersect(a4, b4)),
                            int(QueryKernels.count_expr([a4, b4], "&"))]
    res["dispatch_sharded"] = engine.query_step([a, b], "&")
    n = engine.pad_shards(OVERFLOW_SHARDS)
    ones = place(np.full((n, WORDS), 0xFFFFFFFF, dtype=np.uint32))
    res["overflow"] = [engine.count_intersect(ones, ones),
                       engine.query_step([ones, ones], "|")]
    res["pad_shards"] = [engine.pad_shards(k) for k in range(10)]
    res["ranks"] = engine.n_devices
    return res


def _rank_main(rank, port, inputs, out):
    """One child rank of the 2-rank group."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=120))
    from pilosa_tpu_torch.parallel import ShardedQueryEngine

    with np.load(inputs) as data:
        inp = {k: data[k] for k in data.files}
    res = run_port_cases(ShardedQueryEngine(devices="cpu"), inp)
    res["rank"] = dist.get_rank()
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("torch_sharded_ranks", {path!r})
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
def reference(inputs):
    """The TPU package's answers on its 8-device CPU mesh."""
    jax = pytest.importorskip("jax")
    import jax.sharding as jsh

    from pilosa_tpu.parallel import QueryKernels, ShardedQueryEngine
    from pilosa_tpu.parallel.sharded import _is_multi_device

    assert len(jax.devices()) == 8, "the reference runs on 8 CPU devices"
    engine = ShardedQueryEngine()
    place = engine.place
    res = {}
    res["count_intersect"] = engine.count_intersect(
        place(inputs["a8"]), place(inputs["b8"]))
    pad = engine.pad_shards(5)
    zeros = np.zeros((pad - 5, WORDS), np.uint32)
    res["padded"] = engine.count_intersect(
        place(np.concatenate([inputs["a5"], zeros])),
        place(np.concatenate([inputs["b5"], zeros])))
    a, b, c = (place(inputs[k]) for k in ("a8", "b8", "c8"))
    res["expr"] = [engine.query_step([a, b], "&"),
                   engine.query_step([a, b], "|"),
                   engine.query_step([a, b], "-"),
                   engine.query_step([a, b, c], "&|")]
    stack = jax.device_put(inputs["topn"], jsh.NamedSharding(
        engine.mesh, jsh.PartitionSpec(None, engine.axis)))
    vals, idx = engine.topn_step(stack, place(inputs["filt"]), 2)
    res["topn"] = [[int(v) for v in vals], [int(i) for i in idx]]
    planes = jax.device_put(inputs["planes"], jsh.NamedSharding(
        engine.mesh, jsh.PartitionSpec(None, engine.axis)))
    full = np.full((8, WORDS), 0xFFFFFFFF, dtype=np.uint32)
    total, count = engine.sum_step(planes, place(inputs["sign"]),
                                   place(inputs["exists"]), place(full))
    res["sum"] = [int(total), int(count)]
    res["single_device"] = [
        int(QueryKernels.count_intersect(inputs["a4"], inputs["b4"])),
        int(QueryKernels.count_expr([inputs["a4"], inputs["b4"]], "&"))]
    assert _is_multi_device(a)
    res["dispatch_sharded"] = int(QueryKernels.count_expr([a, b], "&"))
    ones = place(np.full((OVERFLOW_SHARDS, WORDS), 0xFFFFFFFF,
                         dtype=np.uint32))
    res["overflow"] = [engine.count_intersect(ones, ones),
                       engine.query_step([ones, ones], "|")]
    return res


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """{ranks: the port's answers}: one rank in this process, two ranks
    as spawned children."""
    from pilosa_tpu_torch.parallel import ShardedQueryEngine

    out = {1: run_port_cases(ShardedQueryEngine(devices="cpu"), inputs),
           "1x8": run_port_cases(ShardedQueryEngine(devices=["cpu"] * 8),
                                 inputs)}
    tmp = tmp_path_factory.mktemp("sharded")
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    port_no = str(_free_port())
    code = _CHILD.format(path=os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), port_no, path,
         str(tmp / f"rank{rank}.json")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    ranks = []
    for rank in (0, 1):
        with open(tmp / f"rank{rank}.json") as f:
            ranks.append(json.load(f))
    # both ranks hold the same reduced answers
    assert {k: v for k, v in ranks[0].items() if k != "rank"} \
        == {k: v for k, v in ranks[1].items() if k != "rank"}
    assert [r["rank"] for r in ranks] == [0, 1]
    out[2] = ranks[0]
    assert [out[n]["ranks"] for n in (1, 2, "1x8")] == [1, 2, 8]
    return out


RANKS = [1, 2, "1x8"]


@pytest.mark.parametrize("ranks", RANKS)
def test_count_intersect_over_mesh(reference, port, ranks):
    assert port[ranks]["count_intersect"] == reference["count_intersect"]


@pytest.mark.parametrize("ranks", RANKS)
def test_count_intersect_padded_shards(reference, port, ranks):
    # 5 real shards padded with zero planes: to 8 on the reference's mesh,
    # to the rank count here (trap 27)
    assert port[ranks]["padded"] == reference["padded"]


@pytest.mark.parametrize("ranks", RANKS)
def test_query_step_expr(reference, port, ranks):
    assert port[ranks]["expr"] == reference["expr"]


@pytest.mark.parametrize("ranks", RANKS)
def test_topn_step(reference, port, ranks):
    assert port[ranks]["topn"] == reference["topn"]
    # rows 1 and 3 (5000 and 2000 columns in each of 8 shards)
    assert port[ranks]["topn"] == [[40000, 16000], [1, 3]]


@pytest.mark.parametrize("ranks", RANKS)
def test_sum_step(reference, port, ranks, inputs):
    assert port[ranks]["sum"] == reference["sum"]
    assert port[ranks]["sum"][1] == 8 * 500


@pytest.mark.parametrize("ranks", RANKS)
def test_kernels_single_device(reference, port, ranks):
    assert port[ranks]["single_device"] == reference["single_device"]


@pytest.mark.parametrize("ranks", RANKS)
def test_query_kernels_dispatch_sharded_inputs(reference, port, ranks,
                                               inputs):
    """Stacks split over the group still count right: each rank's
    launch covers its slice, the all_reduce the rest."""
    a, b = inputs["a8"], inputs["b8"]
    want = int(np.unpackbits((a & b).view(np.uint8)).sum())
    assert port[ranks]["dispatch_sharded"] \
        == reference["dispatch_sharded"] == want


@pytest.mark.parametrize("ranks", RANKS)
def test_count_overflow_over_mesh(reference, port, ranks):
    """A count past 2^31 bits stays exact (int64 partials)."""
    want = OVERFLOW_SHARDS * (1 << 20)
    assert port[ranks]["overflow"] == reference["overflow"] == [want, want]


@pytest.mark.parametrize("ranks", RANKS)
def test_pad_shards_to_rank_count(port, ranks):
    parts = port[ranks]["ranks"]  # ranks x each rank's local parts
    assert port[ranks]["pad_shards"] == [
        -(-k // parts) * parts for k in range(10)]


def test_all_reduce_carries_an_extra_tail_on_one_rank():
    """The data plane's failure slots ride the engine's one all_reduce
    as an extra tail, returned apart from the partial; the Sum fold and
    the host top-k are the engine's."""
    import torch

    from pilosa_tpu_torch.parallel.sharded import ShardedQueryEngine

    eng = ShardedQueryEngine(devices="cpu")
    sums, extra = eng._all_reduce(torch.tensor([5, 7], dtype=torch.int64),
                                  extra=torch.tensor([0, 2, 0]))
    assert sums.tolist() == [5, 7] and extra.tolist() == [0, 2, 0]
    assert eng._all_reduce(torch.tensor(3, dtype=torch.int64)).tolist() \
        == [3]
    # depth 2: planes (pos 3, 1), (neg 1, 0), count 4 -> (3-1) + (1-0)*2
    assert ShardedQueryEngine.sum_fold([3, 1, 1, 0, 4], 2) == (4, 4)
    totals, order = ShardedQueryEngine.top_k([2, 9, 9, 1], 3)
    assert totals.tolist() == [9, 9, 2] and order.tolist() == [1, 2, 0]
