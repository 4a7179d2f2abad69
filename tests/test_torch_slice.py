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
    leaves, a query batch, a coalesced query, a stale serve and merge of
    the streaming ingest engine, an adaptive EXPLAIN ANALYZE and a Count
    through the non-owner of a 2-node cluster with neither JAX nor any
    pilosa_tpu module loaded (a subprocess: this
    test process has JAX loaded already)."""
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
from pilosa_tpu_torch.exec import ExecOptions, adaptive
iapi = API(srv.holder, device="cpu", ingest_interval=3600.0)
assert iapi.query("i", "Count(Row(f=1))") == [3]
iapi.import_bits("i", "f", [1], [3])
assert iapi.query("i", "Count(Row(f=1))") == [3]  # pending: stale serve
iapi.ingest.flush()
adaptive.configure(mode="on")
assert iapi.query("i", "Count(Row(f=1))",
                  options=ExecOptions(explain="analyze")) == [4]
adaptive.reset()
iapi.close()
srv.stop()
from pilosa_tpu_torch.tools.cluster import ClusterHarness
c = ClusterHarness(2, replica_n=1)
c[0].client.create_index("ci")
c[0].client.create_field("ci", "f")
c[0].client.import_bits("ci", "f", [1, 1], [5, (1 << 20) + 5])
assert c.non_owner_of("ci", 0).client.query(
    "ci", "Count(Row(f=1))")["results"] == [2]
c.close()
assert "pilosa_tpu_torch.cluster.executor" in sys.modules
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


#: modules that must exist and be scanned: the command line with its
#: tools, the fuzz and stress rounds chip_smoke.py drives on the card,
#: the client and the logger the oplog writes through, the
#: observability and health modules every layer imports, the wire
#: codec, the ingest engine, the adaptive engine, the planner, whole-plan
#: fusion, admission control, the HTTP cluster (placement, messaging,
#: membership, fan-out, resize, anti-entropy, key replication) and the
#: collective plane with its mesh cache
REQUIRED_SOURCES = ("cli.py", "server/client.py", "utils/logger.py",
                    "storage/oplog.py", "server/api.py", "utils/tracing.py",
                    "utils/stats.py", "utils/profile.py",
                    "utils/flightrec.py", "utils/workpool.py",
                    "utils/devhealth.py", "utils/incident.py",
                    "utils/workload.py", "server/diagnostics.py",
                    "encoding/__init__.py", "encoding/serializer.py",
                    "encoding/wire.py", "exec/ingest.py",
                    "exec/adaptive.py", "exec/plan.py", "exec/fusion.py",
                    "server/admission.py", "cluster/__init__.py",
                    "cluster/hash.py", "cluster/node.py",
                    "cluster/cluster.py", "cluster/broadcast.py",
                    "cluster/membership.py", "cluster/executor.py",
                    "cluster/resize.py", "server/syncer.py",
                    "server/translate_sync.py", "tools/cluster.py",
                    "parallel/sharded.py", "cluster/spmd.py",
                    "cluster/meshstacks.py", "tools/fuzz.py",
                    "tools/stress.py")

#: modules a client tool imports, the ingest engine, the adaptive
#: engine, the planner, whole-plan fusion, admission control, the
#: sharded engine and the mesh cache: none may load torch at import
LIGHT_MODULES = ("pilosa_tpu_torch.utils.tracing",
                 "pilosa_tpu_torch.utils.stats",
                 "pilosa_tpu_torch.utils.profile",
                 "pilosa_tpu_torch.utils.flightrec",
                 "pilosa_tpu_torch.utils.workpool",
                 "pilosa_tpu_torch.utils.devhealth",
                 "pilosa_tpu_torch.utils.incident",
                 "pilosa_tpu_torch.utils.workload",
                 "pilosa_tpu_torch.encoding",
                 "pilosa_tpu_torch.server",
                 "pilosa_tpu_torch.server.diagnostics",
                 "pilosa_tpu_torch.exec.ingest",
                 "pilosa_tpu_torch.exec.adaptive",
                 "pilosa_tpu_torch.exec.plan",
                 "pilosa_tpu_torch.exec.fusion",
                 "pilosa_tpu_torch.server.admission",
                 "pilosa_tpu_torch.parallel.sharded",
                 "pilosa_tpu_torch.cluster.meshstacks")

#: the collective modules: neither forms (nor imports the API of) a
#: torch.distributed process group at import (trap 19)
COLLECTIVE_SOURCES = ("parallel/sharded.py", "cluster/spmd.py")


def test_port_sources_import_no_jax_or_reference():
    pkg = os.path.join(REPO, "pilosa_tpu_torch")
    offenders = []
    scanned = set()
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, name)
            scanned.add(os.path.relpath(path, pkg))
            with open(path, encoding="utf-8") as f:
                for n, line in enumerate(f, 1):
                    text = line.replace("pilosa_tpu_torch", "")
                    if ("import jax" in text or "from jax" in text
                            or "pilosa_tpu." in text
                            or "from pilosa_tpu " in text
                            or "google.protobuf" in text
                            or "import google" in text
                            or "from google" in text
                            or "pilosa_pb2" in text):
                        offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []
    assert set(REQUIRED_SOURCES) <= scanned


_BLOCKER = """
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu") \
                or name.startswith("google.protobuf"):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, _Block())
"""

#: runs `python -m pilosa_tpu_torch <argv>` in this process, then reports
#: whether torch was loaded
_TOOL = """
import runpy, sys
sys.argv = ["pilosa_tpu_torch", *sys.argv[1:]]
code = 0
try:
    runpy.run_module("pilosa_tpu_torch", run_name="__main__")
except SystemExit as e:
    code = e.code or 0
print("TORCH LOADED", "torch" in sys.modules)
sys.exit(code)
"""


def test_collective_modules_form_no_group_at_import():
    """parallel/sharded.py and cluster/spmd.py import torch (and
    torch.distributed) only inside the functions that form a group or
    reduce: no module-level line names either. Imported in a subprocess
    with jax and pilosa_tpu blocked, they leave no process group formed,
    and a one-rank ShardedQueryEngine counts on the CPU without one."""
    pkg = os.path.join(REPO, "pilosa_tpu_torch")
    for rel in COLLECTIVE_SOURCES:
        with open(os.path.join(pkg, rel), encoding="utf-8") as f:
            top = [line for line in f if line[:1] not in (" ", "\t")]
        assert not [line for line in top
                    if line.startswith(("import ", "from "))
                    and "torch" in line.replace("pilosa_tpu_torch", "")], rel
    code = _BLOCKER + """
import numpy as np
import pilosa_tpu_torch.parallel.sharded
import pilosa_tpu_torch.cluster.spmd as spmd
import torch
assert not torch.distributed.is_initialized()
assert not spmd.SpmdDataPlane._initialized
from pilosa_tpu_torch.parallel import ShardedQueryEngine
e = ShardedQueryEngine(devices="cpu")
a = np.full((3, 1 << 15), 0xFFFFFFFF, dtype=np.uint32)
assert e.count_intersect(e.place(a), e.place(a)) == 3 << 20
assert e.mesh == [0] and not torch.distributed.is_initialized()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu"))
print("LOADED", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_observability_modules_load_no_torch():
    """Importing the observability and health modules, the wire codec
    and the server package (what the client tools import) loads neither
    torch, jax nor a protobuf runtime."""
    code = ("import importlib, sys\n"
            f"for m in {LIGHT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'pilosa_tpu') "
            "or m.startswith('google.protobuf'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout


def test_file_tools_run_with_jax_blocked(tmp_path):
    """`python -m pilosa_tpu_torch check|inspect|holder` over a data
    directory the port wrote, with jax, jaxlib, pilosa_tpu and the
    protobuf runtime (google.protobuf) blocked from import (a sitecustomize
    that refuses them); then the client tool `export` and a client on
    the protobuf wire (query_proto, import_bits_proto) against a port
    server over a copy of it, which must leave torch unloaded too."""
    from pilosa_tpu_torch.core import Holder as TorchHolder

    data = str(tmp_path / "data")
    h = TorchHolder(data, use_snapshot_queue=False).open()
    h.create_index("i").create_field("f").import_bits(
        [1, 1, 2], [3, SHARD_WIDTH + 4, 5])
    h.close()
    frag = os.path.join(data, "i", "f", "views", "standard", "fragments",
                        "0")
    assert os.path.isfile(frag)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{site}{os.pathsep}{REPO}"
    probe = subprocess.run(
        [sys.executable, "-c", "import jax"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "blocked: jax" in probe.stderr
    for argv, want in ((["check", frag], f"{frag}: ok"),
                       (["inspect", frag], "row 1: 1 bits"),
                       (["holder", "--data-dir", data], "i: _exists(set), "
                                                        "f(set)")):
        proc = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch", *argv], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert want in proc.stdout, proc.stdout
    served = str(tmp_path / "served")
    shutil.copytree(data, served)
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", served,
                        "--device", "cpu"])
    wire_client = f"""
import sys
from pilosa_tpu_torch.server import Client
c = Client({{uri!r}})
assert c.import_bits_proto("i", "f", [7], [{SHARD_WIDTH + 9}]) == ""
results, err = c.query_proto("i", "Count(Row(f=1)) Row(f=7) TopN(f, n=1)")
assert err is None, err
assert results[:2] == [2, {{{{"columns": [{SHARD_WIDTH + 9}]}}}}], results
assert (results[2][0].id, results[2][0].count) == (1, 2), results
print("TORCH LOADED", "torch" in sys.modules)
"""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _TOOL, "export", "--host", srv.uri,
             "--index", "i", "--field", "f", "--shards", "2"], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=120)
        wire_proc = subprocess.run(
            [sys.executable, "-c", wire_client.format(uri=srv.uri)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    finally:
        srv.stop()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(proc.stdout.splitlines()[:-1]) == \
        sorted(["1,3", f"1,{SHARD_WIDTH + 4}", "2,5"])
    assert "TORCH LOADED False" in proc.stdout
    assert wire_proc.returncode == 0, wire_proc.stdout + wire_proc.stderr
    assert "TORCH LOADED False" in wire_proc.stdout


def test_fuzz_tools_run_with_jax_blocked(tmp_path):
    """tools/fuzz.py and tools/stress.py, as chip_smoke.py's serve_fuzz
    phase drives them, with jax, jaxlib and pilosa_tpu blocked from
    import: a set and a full-type data set, five trees of each under a
    forced sparse repr, the fixed sets, and a stress round of 20 writes
    a writer."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{site}{os.pathsep}{REPO}"
    env["OMP_NUM_THREADS"] = "1"
    code = f"""
import random, sys
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.ops import containers
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.tools import fuzz, stress
containers.configure("sparse")
h, api, m = fuzz.build({str(tmp_path / "s")!r}, 7, device="cpu")
assert len(fuzz.check_set(api.executor, m, random.Random(7 * 31), 5)) == 5
fuzz.check_fixed(api.executor, "fz", m, fuzz.fixed_set_queries())
fuzz.check_aggregates(api.executor, m)
h.close()
h, api, m = fuzz.build_full({str(tmp_path / "t")!r}, 13, device="cpu")
assert len(fuzz.check_full(api.executor, m, random.Random(13 * 101), 5)) == 5
fuzz.check_bsi_aggregates(api.executor, m)
fuzz.check_fixed(api.executor, "fz2", m, fuzz.fixed_bsi_queries())
h.close()
h = Holder({str(tmp_path / "st")!r}).open()
assert stress.concurrent_round(API(h, device="cpu"),
                               Executor(h, device="cpu"), 20) > 0
h.close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu"))
print("LOADED", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_row_results_are_row_objects(pair):
    _, tex, _ = pair
    (row,) = tex.execute("i", "Row(f=2)")
    assert isinstance(row, Row) and row.count() > 0
