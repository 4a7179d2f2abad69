"""The port's TopN, Rows and GroupBy against the TPU package, on the CPU.

A data directory written by `pilosa_tpu.core.Holder` from a numpy seed
(5 shards at the real shard width; field f with 14 rows of zipf sizes,
two of them tied, the default ranked TopN cache and row attributes on a
few rows; fields a, b and c for one-, two- and three-field GroupBy; every
field drawn from one 100,000-column universe so filters overlap) is
copied twice: the TPU package's Executor (JAX on the CPU) serves one
copy, the port's Executor (device="cpu") the other. The same PQL list,
shard subsets and writes included, must give exactly equal results.
"""

import json
import shutil
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec import stacked as jax_stacked  # noqa: E402
from pilosa_tpu.ops import containers as jax_containers  # noqa: E402
from pilosa_tpu.server.api import result_to_json as jax_to_json  # noqa: E402
from pilosa_tpu.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.core import Holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import stacked as port_stacked  # noqa: E402
from pilosa_tpu_torch.ops import pairwise as k4  # noqa: E402
from pilosa_tpu_torch.ops import row_counts as k3  # noqa: E402
from pilosa_tpu_torch.server.api import result_to_json  # noqa: E402

N_SHARDS = 5
N_F_ROWS = 14


def _write_reference_dir(path, seed=23):
    rng = np.random.default_rng(seed)
    universe = rng.choice(N_SHARDS * SHARD_WIDTH, size=100_000,
                          replace=False).astype(np.uint64)
    h = JaxHolder(path, use_snapshot_queue=False).open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    for r in range(N_F_ROWS):
        # zipf sizes; rows 12 and 13 share a size, so their counts tie
        n = 20_000 // (r + 1) + 50 if r < 12 else 700
        cols = rng.choice(universe, size=n, replace=False)
        f.import_bits(np.full(n, r, dtype=np.uint64), cols)
        idx.add_existence(cols)
    for fname, n_rows in (("a", 3), ("b", 4), ("c", 2)):
        field = idx.create_field(fname)
        cols = rng.choice(universe, size=30_000, replace=False)
        rows = rng.integers(0, n_rows, size=len(cols)).astype(np.uint64)
        field.import_bits(rows, cols)
        idx.add_existence(cols)
    for r, color in ((0, "red"), (2, "blue"), (5, "red"), (12, "red")):
        f.row_attr_store.set_attrs(r, {"color": color})
    h.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("topn")
    src = str(base / "src")
    _write_reference_dir(src)
    shutil.copytree(src, str(base / "jax"))
    shutil.copytree(src, str(base / "torch"))
    jh = JaxHolder(str(base / "jax"), use_snapshot_queue=False).open()
    th = Holder(str(base / "torch"), use_snapshot_queue=False).open()
    prev = jax_containers.repr_mode()
    jax_containers.configure("dense")
    try:
        yield JaxExecutor(jh), Executor(th, device="cpu"), src
    finally:
        jax_containers.configure(prev)
        jh.close()
        th.close()


def _norm(results):
    return [jax_to_json(r) for r in results]


def _same(jex, tex, pql, shards=None):
    want = _norm(jex.execute("i", pql, shards=shards))
    got = [result_to_json(r) for r in tex.execute("i", pql, shards=shards)]
    assert got == want, pql
    return got


TOPN = [
    "TopN(f)",
    "TopN(f, n=5)",
    "TopN(f, n=3, threshold=3000)",
    "TopN(f, threshold=700)",
    "TopN(f, ids=[1, 3, 12, 13, 99])",
    "TopN(f, Row(a=1), n=6)",
    "TopN(f, Intersect(Row(a=0), Row(b=2)), n=4)",
    "TopN(f, Union(Row(b=1), Row(c=0)), n=8, threshold=40)",
    "TopN(f, Row(f=0), tanimotoThreshold=5)",
    "TopN(f, Row(f=1), n=3, tanimotoThreshold=2)",
    'TopN(f, attrName="color", attrValues=["red"])',
    'TopN(f, Row(a=2), n=2, attrName="color", attrValues=["red", "blue"])',
    "TopN(a)",
]

ROWS = [
    "Rows(f)",
    "Rows(f, limit=4)",
    "Rows(f, previous=5)",
    "Rows(f, previous=2, limit=3)",
    "Rows(b)",
]

GROUP_BY = [
    "GroupBy(Rows(a))",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(a), Rows(b))",
    "GroupBy(Rows(f), Rows(b))",
    "GroupBy(Rows(a), Rows(b), Rows(c))",
    "GroupBy(Rows(a), Rows(b), filter=Row(f=0))",
    "GroupBy(Rows(a), filter=Intersect(Row(f=1), Row(b=3)))",
    "GroupBy(Rows(c), Rows(a), Rows(b), filter=Row(f=2))",
    "GroupBy(Rows(a), Rows(b), limit=5)",
    "GroupBy(Rows(a), Rows(b), limit=7, offset=2)",
    "GroupBy(Rows(a), Rows(b), offset=50)",
    "GroupBy(Rows(a), Rows(b), previous=[1, 2])",
    "GroupBy(Rows(a), Rows(b), Rows(c), previous=[0, 3, 1], limit=4)",
    "GroupBy(Rows(a), previous=[1])",
    "GroupBy(Rows(a, limit=2), Rows(b, previous=1))",
]


@pytest.mark.parametrize("pql", TOPN + ROWS + GROUP_BY)
def test_port_matches_reference(pair, pql):
    jex, tex, _ = pair
    _same(jex, tex, pql)


def test_rows_column_arg(pair):
    jex, tex, _ = pair
    view = tex.holder.index("i").field("f").view("standard")
    frag = view.fragment(3)
    row = frag.row_ids()[0]
    col = 3 * SHARD_WIDTH + int(
        np.flatnonzero(np.unpackbits(
            frag.row_plane(row).view(np.uint8), bitorder="little"))[0])
    got = _same(jex, tex, f"Rows(f, column={col})")
    assert row in got[0]["rows"]
    _same(jex, tex, f"GroupBy(Rows(f, column={col}), Rows(a))")


@pytest.mark.parametrize("shards", [[0], [0, 2, 4]])
@pytest.mark.parametrize("pql", [
    "TopN(f, n=6)",
    "TopN(f, Row(a=1), n=6)",
    "Rows(f)",
    "GroupBy(Rows(a))",
    "GroupBy(Rows(a), Rows(b), filter=Row(f=1))",
    "GroupBy(Rows(a), Rows(b), Rows(c))",
])
def test_shard_subsets(pair, pql, shards):
    jex, tex, _ = pair
    _same(jex, tex, pql, shards=shards)


def test_stacked_paths_launch_k3_and_k4(pair, monkeypatch):
    """On more than one shard TopN and one-field GroupBy go through the
    stacked row counts and two-field GroupBy through the pairwise tiles;
    on one shard they count shard by shard."""
    _, tex, _ = pair
    calls = {"k3": 0, "k4": 0}
    real_k3, real_k4 = k3.row_counts_reference, k4.pairwise_counts_reference

    def spy_k3(*a, **kw):
        calls["k3"] += 1
        return real_k3(*a, **kw)

    def spy_k4(*a, **kw):
        calls["k4"] += 1
        return real_k4(*a, **kw)

    monkeypatch.setattr(k3, "row_counts_reference", spy_k3)
    monkeypatch.setattr(k4, "pairwise_counts_reference", spy_k4)
    stats = tex.stacked_stats()
    tex.execute("i", "TopN(f, n=3)")
    tex.execute("i", "GroupBy(Rows(a))")
    assert calls == {"k3": 2, "k4": 0}
    tex.execute("i", "GroupBy(Rows(a), Rows(b))")
    assert calls == {"k3": 2, "k4": 1}
    after = tex.stacked_stats()
    assert after["pairwise_dispatches"] == stats["pairwise_dispatches"] + 1
    assert after["pairwise_syncs"] == stats["pairwise_syncs"] + 1
    assert after["rows_entries"] >= 3 and after["rows_bytes"] > 0
    assert after["rows_bytes"] == sum(
        tex._stacked.hbm_ledger("rows").values())
    before = after["dispatches"]
    tex.execute("i", "GroupBy(Rows(a), Rows(b))", shards=[1])
    assert tex.stacked_stats()["dispatches"] == before
    assert calls["k4"] == 1  # one shard: per-shard intersections


def test_writes_patch_row_chunks(pair):
    """Set and Clear, then TopN and GroupBy read the writes back through
    row chunks patched in place."""
    jex, tex, _ = pair
    queries = ["TopN(f, n=4)", "TopN(f, Row(a=1), n=4)",
               "GroupBy(Rows(a), Rows(b))", "GroupBy(Rows(f))"]
    for pql in queries:
        _same(jex, tex, pql)
    patches = tex.stacked_stats()["patches"]
    view = tex.holder.index("i").field("f").view("standard")
    frag = view.fragment(2)
    target = frag.row_ids()[-1]  # a small row: a write can move its rank
    empty = np.flatnonzero(frag.row_plane(target) == 0)
    cols = [2 * SHARD_WIDTH + int(w) * 32 + k for w in empty[:40]
            for k in (0, 7)]
    writes = [f"Set({c}, f={target})" for c in cols]
    writes += [f"Set({cols[0]}, a=1)", f"Set({cols[1]}, b=3)",
               f"Clear({cols[2]}, f={target})",
               f"Set({4 * SHARD_WIDTH + 5}, a=2)"]
    for pql in writes:
        _same(jex, tex, pql)
    for pql in queries:
        _same(jex, tex, pql)
    assert tex.stacked_stats()["patches"] > patches


def test_chunks_and_tiles_cross_boundaries(pair, monkeypatch):
    """CHUNK_BYTES cut to three rows' worth in BOTH packages: TopN spans
    several chunks and GroupBy several pairwise tiles per axis."""
    jex, tex, _ = pair
    row_bytes = N_SHARDS * WORDS_PER_ROW * 4
    monkeypatch.setattr(jax_stacked, "CHUNK_BYTES", 3 * row_bytes)
    monkeypatch.setattr(port_stacked, "CHUNK_BYTES", 3 * row_bytes)
    assert tex._stacked.row_chunk_size(tuple(range(N_SHARDS))) == 3
    stats = tex.stacked_stats()
    for pql in ["TopN(f)", "TopN(f, Row(a=0), n=7)",
                "GroupBy(Rows(f), Rows(b))",
                "GroupBy(Rows(f), Rows(b), filter=Row(c=1))",
                "GroupBy(Rows(a), Rows(b), Rows(c))",
                "GroupBy(Rows(f))"]:
        _same(jex, tex, pql)
    after = tex.stacked_stats()
    # GroupBy(Rows(f), Rows(b)) twice: ceil(14/3) x ceil(4/3) tiles each
    assert after["pairwise_dispatches"] - stats["pairwise_dispatches"] \
        >= 2 * 5 * 2


def test_transient_chunks_past_rows_budget(pair, monkeypatch):
    """A candidate set larger than the rows pool is counted in transient
    chunks that never enter the pool."""
    jex, tex, _ = pair
    tex = Executor(tex.holder, device="cpu")  # an empty rows pool
    row_bytes = N_SHARDS * WORDS_PER_ROW * 4
    monkeypatch.setattr(port_stacked, "MAX_ROWS_STACK_BYTES", 4 * row_bytes)
    monkeypatch.setattr(port_stacked, "CHUNK_BYTES", 4 * row_bytes)
    _same(jex, tex, "TopN(f, n=9)")
    assert tex.stacked_stats()["rows_entries"] == 0
    _same(jex, tex, "TopN(f, ids=[0, 1, 2])")
    assert tex.stacked_stats()["rows_entries"] == 1


def test_errors_match(pair):
    jex, tex, _ = pair
    for pql in ["TopN(f, n=-1)", "TopN(f, Row(a=1), tanimotoThreshold=101)",
                "TopN(f, tanimotoThreshold=5)", "TopN(nope)",
                "GroupBy(Row(a=1))", "GroupBy()",
                "GroupBy(Rows(a), Rows(b), previous=[1])",
                "Rows(f, limit=-2)"]:
        with pytest.raises(Exception) as want:
            jex.execute("i", pql)
        with pytest.raises(Exception) as got:
            tex.execute("i", pql)
        assert str(got.value) == str(want.value), pql


def _http(uri, path, body=None):
    req = urllib.request.Request(
        uri + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_shapes_match_reference(pair, tmp_path):
    """TopN, Rows and GroupBy over the port's HTTP server give the JSON
    the TPU package's result encoding gives for its own results."""
    _, _, src = pair
    data = str(tmp_path / "served")
    shutil.copytree(src, data)
    fresh = JaxExecutor(JaxHolder(src, use_snapshot_queue=False).open())
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", data,
                        "--device", "cpu"])
    try:
        for pql in ["TopN(f, n=3)", "Rows(a)", "GroupBy(Rows(a), Rows(c))",
                    "TopN(f, Row(a=1), n=2) GroupBy(Rows(b), limit=2)"]:
            want = _norm(fresh.execute("i", pql))
            assert _http(srv.uri, "/index/i/query", pql)["results"] == want
    finally:
        srv.stop()
        fresh.holder.close()
