"""The port's Count slice against the TPU package, end to end on the CPU.

A data directory written by `pilosa_tpu.core.Holder` (random rows from a
numpy seed, a few shards at the real shard width) is copied twice: the
TPU package's Executor (JAX on the CPU, dense containers) serves one
copy, the port's Executor (device="cpu") the other. The same PQL list,
writes included, must give equal results. Tolerance: exact equality.
"""

import json
import os
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.core.row import Row  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec.executor import ExecError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 5
ROWS = (1, 2, 3)


def _write_reference_dir(path, seed=11):
    """Fields f and g, rows 1..3, random columns in N_SHARDS shards,
    written through the TPU package (existence tracked for Not)."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    for fname in ("f", "g"):
        field = idx.create_field(fname)
        for row in ROWS:
            cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=3000,
                              replace=False).astype(np.uint64)
            field.import_bits(np.full(len(cols), row, dtype=np.uint64),
                              cols)
            idx.add_existence(cols)
    h.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("slice")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    try:
        yield JaxExecutor(jh), Executor(th, device="cpu"), str(base / "src")
    finally:
        jax_containers.configure(prev)
        jh.close()
        th.close()


def _norm(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    return result


QUERIES = [
    "Row(f=1)",
    "Intersect(Row(f=1), Row(g=2))",
    "Union(Row(f=1), Row(g=3), Row(f=2))",
    "Difference(Row(f=3), Row(g=1))",
    "Xor(Row(f=2), Row(g=2))",
    "Not(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Intersect(Row(f=1), Row(g=2)), Difference(Row(f=3), Row(g=3))))",
    "Count(Xor(Row(f=2), Row(g=1)))",
    "Count(Not(Union(Row(f=1), Row(g=1))))",
    "Count(Row(f=9))",
    "Count(Intersect(Row(f=1), Row(g=2))) Count(Row(g=3))",
]


@pytest.mark.parametrize("pql", QUERIES)
def test_port_matches_reference(pair, pql):
    jex, tex, _ = pair
    want = [_norm(r) for r in jex.execute("i", pql)]
    got = [_norm(r) for r in tex.execute("i", pql)]
    assert got == want


@pytest.mark.parametrize("shards", [[0], [3], [0, 2, 4]])
def test_count_fallback_and_shard_subsets(pair, shards):
    jex, tex, _ = pair
    pql = "Count(Difference(Union(Row(f=1), Row(g=2)), Row(f=3)))"
    assert tex.execute("i", pql, shards=shards) \
        == jex.execute("i", pql, shards=shards)


def test_stacked_path_used_for_multi_shard_count(pair):
    _, tex, _ = pair
    before = tex.stacked_stats()["dispatches"]
    tex.execute("i", "Count(Intersect(Row(f=2), Row(g=3)))")
    tex.execute("i", "Count(Row(f=2))", shards=[1])  # 1 shard: per-shard
    assert tex.stacked_stats()["dispatches"] == before + 1


def test_set_then_count_reads_own_write(pair):
    jex, tex, _ = pair
    count = "Count(Intersect(Row(f=1), Row(g=1)))"
    assert tex.execute("i", count) == jex.execute("i", count)
    col = 2 * SHARD_WIDTH + 12345
    for pql in (f"Set({col}, f=1)", f"Set({col}, g=1)", count,
                f"Clear({col}, g=1)", count, "Row(g=1)"):
        assert [_norm(r) for r in tex.execute("i", pql)] \
            == [_norm(r) for r in jex.execute("i", pql)], pql
    assert tex.stacked_stats()["patches"] >= 1


def test_stack_cache_evicts_within_byte_budget(pair, monkeypatch):
    from pilosa_tpu_torch.exec import stacked as stacked_mod
    from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

    jex, tex, _ = pair
    tex = Executor(tex.holder, device="cpu")  # an empty stack cache
    leaf_bytes = N_SHARDS * WORDS_PER_ROW * 4
    monkeypatch.setattr(stacked_mod, "MAX_STACK_BYTES", 3 * leaf_bytes)
    ev = tex._stacked
    for a, b in ((1, 1), (2, 2), (3, 3), (1, 3)):
        pql = f"Count(Intersect(Row(f={a}), Row(g={b})))"
        assert tex.execute("i", pql) == jex.execute("i", pql)
        stats = ev.cache_stats()
        assert stats["bytes"] <= 3 * leaf_bytes
        assert sum(ev.hbm_ledger().values()) == stats["bytes"]
    assert ev.cache_stats()["evictions"] == 4  # LRU: f=1 re-enters last


def test_unported_calls_raise(pair):
    """No call of the TPU package is left unported: the calls this test
    once held to a "not yet ported" error answer as the TPU package does,
    and only a call neither package knows raises, with its error."""
    jex, tex, _ = pair
    for pql in ("ClearRow(f=9)", "Count(Shift(Row(f=1), n=1))"):
        assert tex.execute("i", pql) == jex.execute("i", pql)
    from pilosa_tpu.exec.executor import ExecError as JaxExecError

    with pytest.raises(JaxExecError, match="unknown call: Bogus"):
        jex.execute("i", "Count(Bogus(f=1))")
    with pytest.raises(ExecError, match="unknown call: Bogus"):
        tex.execute("i", "Count(Bogus(f=1))")


def test_sum_on_set_field_raises_like_reference(pair):
    from pilosa_tpu.exec.executor import ExecError as JaxExecError

    jex, tex, _ = pair
    with pytest.raises(JaxExecError, match="not an int field"):
        jex.execute("i", "Sum(field=f)")
    with pytest.raises(ExecError, match="not an int field") as err:
        tex.execute("i", "Sum(field=f)")
    assert type(err.value) is ExecError


def test_cuda_default_raises_without_card(pair):
    _, tex, _ = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(tex.holder)


def _http(uri, path, body=None):
    req = urllib.request.Request(
        uri + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_end_to_end(pair, tmp_path):
    jex, _, src = pair
    data = str(tmp_path / "served")
    shutil.copytree(src, data)
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", data,
                        "--device", "cpu"])
    try:
        assert _http(srv.uri, "/status")["state"] == "NORMAL"
        schema = _http(srv.uri, "/schema")
        assert [f["name"] for f in schema["indexes"][0]["fields"]] \
            == ["f", "g"]
        pql = "Count(Intersect(Row(f=3), Row(g=2)))"
        fresh = JaxExecutor(JaxHolder(src, use_snapshot_queue=False).open())
        try:
            want = fresh.execute("i", pql)
        finally:
            fresh.holder.close()
        assert _http(srv.uri, "/index/i/query", pql)["results"] == want
        _http(srv.uri, "/index/j", "{}")
        _http(srv.uri, "/index/j/field/h", "{}")
        _http(srv.uri, "/index/j/field/h/import",
              json.dumps({"rowIDs": [7, 7], "columnIDs": [3, SHARD_WIDTH]}))
        out = _http(srv.uri, "/index/j/query", "Row(h=7) Count(Row(h=7))")
        assert out["results"] == [{"attrs": {}, "columns": [3, SHARD_WIDTH]},
                                  2]
    finally:
        srv.stop()


def test_subprocess_loads_no_jax(tmp_path):
    """The port serves Counts over dense, block-sparse and run-length
    leaves, a query batch and a coalesced query with neither JAX nor any
    pilosa_tpu module loaded (a subprocess: this test process has JAX
    loaded already)."""
    code = f"""
import sys
from pilosa_tpu_torch.cli import start_server
from pilosa_tpu_torch.ops import containers
srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", {str(tmp_path)!r},
                    "--device", "cpu", "--container-repr", "sparse"])
ex = srv.api.executor
srv.api.create_index("i")
srv.api.create_field("i", "f")
srv.api.import_bits("i", "f", [1, 1, 1, 2], [1, 2, 1 << 20, 2])
pql = "Count(Intersect(Row(f=1), Row(f=2)))"
for mode, want in (("sparse", "sparse"), ("rle", "rle"), ("dense", "dense")):
    containers.configure(mode)
    srv.api.executor._stacked._pools["leaf"].clear()
    assert srv.api.query("i", "Count(Row(f=1))") == [3]
    assert srv.api.query("i", pql) == [1]
    kinds = {{containers.kind_of(e[1])
             for e in srv.api.executor._stacked._pools["leaf"].values()}}
    assert kinds == {{want}}, kinds
from pilosa_tpu_torch.server.api import API
out = srv.api.query_batch("i", ["Count(Row(f=1))", "Count(Row(f=2))",
                                "Row(f=2)"])
assert [(o[0], o[2]) for o in out[:2]] == [([3], 2), ([1], 2)], out
assert [int(c) for c in out[2][0][0].columns()] == [2]
capi = API(srv.holder, device="cpu", coalesce_window=0.001)
assert capi.query("i", pql) == [1]
assert capi.batching_stats()["coalescer"]["coalesced_queries"] == 1
capi.close()
srv.stop()
assert "pilosa_tpu_torch.ops.count_blocks" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu"))
print("LOADED", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_sources_import_no_jax_or_reference():
    pkg = os.path.join(REPO, "pilosa_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                for n, line in enumerate(f, 1):
                    text = line.replace("pilosa_tpu_torch", "")
                    if ("import jax" in text or "from jax" in text
                            or "pilosa_tpu." in text
                            or "from pilosa_tpu " in text):
                        offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []


def test_row_results_are_row_objects(pair):
    _, tex, _ = pair
    (row,) = tex.execute("i", "Row(f=2)")
    assert isinstance(row, Row) and row.count() > 0
