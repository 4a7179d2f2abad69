"""The port's durable imports against the TPU package's, on the CPU.

Every case of `tests/test_oplog.py`'s API integration (append then
apply, a crash between append and apply replayed at boot, idempotent
set-bit replay, last-write-wins BSI replay, roaring replay, a failed
import that does not wedge the watermark, raw keys in the record,
timestamps) runs the same steps through both packages' `API` over a
`Holder` and an `OpLog` of their own (JAX on the CPU; the port with
device="cpu"), and the answers and the oplog's watermarks must be
equal. Two interchange cases replay a log written by one package in the
other, and the fragments afterwards must hold the same bits. The
clear-import existence case runs through both APIs and both servers over
HTTP. Tolerance: exact equality.
"""

import os
import shutil
from datetime import datetime
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import pilosa_tpu.core as jax_core  # noqa: E402
import pilosa_tpu.roaring as jax_roaring  # noqa: E402
import pilosa_tpu.server.api as jax_api  # noqa: E402
import pilosa_tpu.storage.oplog as jax_oplog  # noqa: E402
import pilosa_tpu.utils.faultpoints as jax_faultpoints  # noqa: E402
from pilosa_tpu.core.index import IndexOptions as JaxIndexOptions  # noqa: E402
import pilosa_tpu_torch.core as torch_core  # noqa: E402
import pilosa_tpu_torch.roaring as torch_roaring  # noqa: E402
import pilosa_tpu_torch.server.api as torch_api  # noqa: E402
import pilosa_tpu_torch.storage.oplog as torch_oplog  # noqa: E402
import pilosa_tpu_torch.utils.faultpoints as torch_faultpoints  # noqa: E402
from pilosa_tpu_torch.cli import start_server  # noqa: E402
from pilosa_tpu_torch.core.index import IndexOptions  # noqa: E402
from pilosa_tpu_torch.server import Client  # noqa: E402

from tests.harness import ServerHarness  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(
        Holder=jax_core.Holder, FieldOptions=jax_core.FieldOptions,
        IndexOptions=JaxIndexOptions, API=jax_api.API,
        OpLog=jax_oplog.OpLog, oplog_mod=jax_oplog,
        faultpoints=jax_faultpoints, roaring=jax_roaring, api_kw={}),
    "port": SimpleNamespace(
        Holder=torch_core.Holder, FieldOptions=torch_core.FieldOptions,
        IndexOptions=IndexOptions, API=torch_api.API,
        OpLog=torch_oplog.OpLog, oplog_mod=torch_oplog,
        faultpoints=torch_faultpoints, roaring=torch_roaring,
        api_kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    for pkg in PKGS.values():
        pkg.faultpoints.disarm()
        pkg.oplog_mod.set_fsync_policy("never")


class Node:
    """One package's holder + oplog + API over a data directory;
    `restart()` is a fresh process's boot on the same directory."""

    def __init__(self, pkg, path):
        self.pkg = pkg
        self.path = str(path)
        self._open()

    def _open(self):
        self.holder = self.pkg.Holder(
            self.path, use_snapshot_queue=False).open()
        self.oplog = self.pkg.OpLog(os.path.join(self.path, "oplog")).open()
        self.api = self.pkg.API(self.holder, oplog=self.oplog,
                                **self.pkg.api_kw)

    def crash(self):
        """The process dies: fragments close, the oplog is never closed
        (no shutdown checkpoint)."""
        self.holder.close()

    def restart(self):
        self.crash()
        self._open()
        return self.api.replay_oplog()

    def close(self):
        self.holder.close()
        self.oplog.close()

    def columns(self, pql):
        return sorted(int(c) for c in self.api.query("i", pql)[0].columns())

    def fragments(self):
        """{(index, field, view, shard): sorted positions} of every
        fragment."""
        out = {}
        for iname, idx in self.holder.indexes.items():
            for fname, field in idx.fields.items():
                for vname, view in field.views.items():
                    for shard, frag in view.fragments.items():
                        bits = frag.storage.slice_range(0, 1 << 63)
                        out[(iname, fname, vname, shard)] = sorted(
                            int(b) for b in bits)
        return out


def _both(tmp_path, scenario):
    """Run scenario(node) once per package; returns the port's answer
    after asserting the TPU package's is equal."""
    out = {}
    for name, pkg in PKGS.items():
        node = Node(pkg, tmp_path / name)
        try:
            out[name] = scenario(node)
        finally:
            node.close()
    assert out["port"] == out["jax"], out
    return out["port"]


def _replay_kinds(node):
    log = node.pkg.OpLog(node.oplog.path).open()
    return [r["kind"] for _, r in log.replay()]


def test_import_appends_then_applies(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        n.api.create_field("i", "v", n.pkg.FieldOptions.int_field(0, 1000))
        n.api.import_bits("i", "f", [1, 1], [2, 3])
        n.api.import_values("i", "v", [2], [7])
        return (n.oplog.last_lsn, n.oplog.applied_lsn, _replay_kinds(n),
                n.columns("Row(f=1)"))

    assert _both(tmp_path, scenario) == (2, 2, ["bits", "values"], [2, 3])


def test_crash_before_apply_replays_at_boot(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        n.pkg.faultpoints.arm("import.post-append=raise")
        with pytest.raises(n.pkg.faultpoints.FaultInjected):
            n.api.import_bits("i", "f", [1], [5])
        n.pkg.faultpoints.disarm()
        # appended, never applied — the crash window the oplog exists for
        before = (n.oplog.last_lsn, n.columns("Row(f=1)"))
        replayed = n.restart()
        # replay checkpointed: the NEXT boot replays nothing
        return (before, replayed, n.columns("Row(f=1)"),
                n.oplog.checkpoint_lsn, n.restart())

    assert _both(tmp_path, scenario) == ((1, []), 1, [5], 1, 0)


def test_replay_is_idempotent_for_set_bits(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        n.api.import_bits("i", "f", [1, 1, 1], [5, 6, 7])
        # crash post-apply, pre-checkpoint: the restart replays the
        # record over fragments that already hold it
        return n.restart(), n.api.query("i", "Count(Row(f=1))")

    assert _both(tmp_path, scenario) == (1, [3])


def test_bsi_replay_is_last_write_wins(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "v", n.pkg.FieldOptions.int_field(0, 1000))
        n.api.import_values("i", "v", [2], [5])
        n.api.import_values("i", "v", [2], [9])
        return (n.restart(), n.columns("Row(v == 9)"),
                n.columns("Row(v == 5)"), n.api.query("i", "Sum(field=v)")
                [0].to_json())

    assert _both(tmp_path, scenario) == (
        2, [2], [], {"value": 9, "count": 1})


def test_roaring_import_replays(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        bm = n.pkg.roaring.Bitmap()
        bm.add(3)  # row 0, col 3
        n.api.import_roaring("i", "f", 0, n.pkg.roaring.serialize(bm))
        applied = n.oplog.applied_lsn
        return applied, n.restart(), n.columns("Row(f=0)")

    assert _both(tmp_path, scenario) == (1, 1, [3])


def test_failed_import_does_not_wedge_watermark(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        n.api.import_bits("i", "f", [1], [1])
        n.pkg.faultpoints.arm("import.pre-ack=raise")
        with pytest.raises(n.pkg.faultpoints.FaultInjected):
            n.api.import_bits("i", "f", [1], [2])
        # the errored lsn is marked applied (no ack, no promise), so the
        # watermark — and with it checkpointing — keeps moving
        n.api.import_bits("i", "f", [1], [3])
        return n.oplog.applied_lsn, n.columns("Row(f=1)")

    assert _both(tmp_path, scenario) == (3, [1, 2, 3])


def test_keyed_import_records_raw_keys(tmp_path):
    def scenario(n):
        n.api.create_index("ki", n.pkg.IndexOptions(keys=True))
        n.api.create_field("ki", "kf", n.pkg.FieldOptions(keys=True))
        n.api.import_bits("ki", "kf", [], [], row_keys=["r1", "r1"],
                          column_keys=["c1", "c2"])
        recs = list(n.pkg.OpLog(n.oplog.path).open().replay())
        replayed = n.restart()
        return (recs[0][1]["row_keys"], recs[0][1]["column_keys"], replayed,
                n.api.query("ki", "Count(Row(kf=\"r1\"))"))

    assert _both(tmp_path, scenario) == (
        ["r1", "r1"], ["c1", "c2"], 1, [2])


def test_timestamps_roundtrip_through_oplog(tmp_path):
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "t", n.pkg.FieldOptions.time_field("YMD"))
        ts = datetime(2024, 3, 5, 10, 0)
        n.api.import_bits("i", "t", [1], [4], timestamps=[ts])
        rec = next(iter(n.pkg.OpLog(n.oplog.path).open().replay()))[1]
        replayed = n.restart()
        return (rec["timestamps"], replayed, n.columns(
            "Row(t=1, from=2024-03-04T00:00, to=2024-03-06T00:00)"))

    assert _both(tmp_path, scenario) == (["2024-03-05T10:00"], 1, [4])


def _write_unapplied_log(pkg, path):
    """Import through `pkg`'s API so that the log holds four records
    (bits with keys and timestamps, values, roaring) none of which the
    fragments hold: each import dies at import.post-append. Returns the
    schema steps to repeat before the other package replays."""
    node = Node(pkg, path)
    node.api.create_index("i")
    node.api.create_field("i", "f")
    node.api.create_field("i", "t", pkg.FieldOptions.time_field("YMD"))
    node.api.create_field("i", "v", pkg.FieldOptions.int_field(-50, 1000))
    node.api.create_index("ki", pkg.IndexOptions(keys=True))
    node.api.create_field("ki", "kf", pkg.FieldOptions(keys=True))
    bm = pkg.roaring.Bitmap()
    for b in (2 * (1 << 20) + 9, 3 * (1 << 20) + 1):
        bm.add(b)
    steps = [
        lambda a: a.import_bits("i", "f", [1, 2, 1], [3, 4, (1 << 20) + 7]),
        lambda a: a.import_bits("i", "t", [1], [4],
                                timestamps=[datetime(2024, 3, 5, 10, 0)]),
        lambda a: a.import_values("i", "v", [2, 9, 1 << 20], [5, -7, 999]),
        lambda a: a.import_roaring("i", "f", 1, pkg.roaring.serialize(bm)),
        lambda a: a.import_bits("ki", "kf", [], [], row_keys=["r", "s"],
                                column_keys=["c1", "c2"]),
        lambda a: a.import_bits("i", "f", [2], [4], clear=True),
    ]
    for step in steps:
        pkg.faultpoints.arm("import.post-append=raise")
        with pytest.raises(pkg.faultpoints.FaultInjected):
            step(node.api)
        pkg.faultpoints.disarm()
    assert node.oplog.last_lsn == len(steps)
    node.crash()
    return len(steps)


QUERIES = ["Row(f=1)", "Row(f=2)", "Count(Not(Row(f=1)))",
           "Row(t=1, from=2024-03-04T00:00, to=2024-03-06T00:00)",
           "Sum(field=v)", "Row(v < 0)", "Count(Row(f=0))"]


def _answers(node):
    out = []
    for q in QUERIES:
        r = node.api.query("i", q)[0]
        out.append(sorted(int(c) for c in r.columns())
                   if hasattr(r, "columns") else
                   (r.to_json() if hasattr(r, "to_json") else r))
    r = node.api.query("ki", 'Row(kf="r") Row(kf="s")')
    out.append([sorted(x.keys) for x in r])
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_log_interchange(tmp_path, writer, reader):
    """A log one package wrote replays in the other; the fragments and
    the answers afterwards equal the writer's own replay of a copy."""
    n = _write_unapplied_log(PKGS[writer], tmp_path / "w")
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    nodes = {}
    try:
        for name, path in ((writer, tmp_path / "w"), (reader, tmp_path / "r")):
            node = nodes[name] = Node(PKGS[name], path)
            assert node.api.replay_oplog() == n
        assert nodes[reader].fragments() == nodes[writer].fragments()
        assert _answers(nodes[reader]) == _answers(nodes[writer])
        # f=2: the roaring blob's bit in shard 1 (col 4 was cleared);
        # Not(f=1): the existence row of every import, the clear's too
        assert _answers(nodes["port"])[:3] == [
            [3, (1 << 20) + 7], [(1 << 20) + 9], 4]
    finally:
        for node in nodes.values():
            node.close()


CLEAR_STEPS = [([1, 1], [1, 2], False), ([1], [7], True)]


def test_clear_import_adds_existence_api(tmp_path):
    """A clear import adds its columns to the existence row, as the TPU
    package does: Count(Not(Row(f=1))) then counts column 7."""
    def scenario(n):
        n.api.create_index("i")
        n.api.create_field("i", "f")
        for rows, cols, clear in CLEAR_STEPS:
            n.api.import_bits("i", "f", rows, cols, clear=clear)
        return (n.api.query("i", "Count(Not(Row(f=1)))"),
                n.columns("Not(Row(f=1))"))

    assert _both(tmp_path, scenario) == ([1], [7])


def test_clear_import_adds_existence_http(tmp_path):
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu"])
    try:
        answers = []
        for uri in (ref.address, port.uri):
            c = Client(uri)
            c.create_index("i")
            c.create_field("i", "f")
            for rows, cols, clear in CLEAR_STEPS:
                c.import_bits("i", "f", rows, cols, clear=clear)
            answers.append(c.query("i", "Count(Not(Row(f=1)))"))
        assert answers[1] == answers[0] == {"results": [1]}
    finally:
        port.stop()
        ref.close()


def test_debug_oplog_endpoint(tmp_path):
    """GET /debug/oplog as in tests/test_oplog.py: disabled without a
    log, then the log's summary once one is attached."""
    ref = ServerHarness(data_dir=str(tmp_path / "ref"))
    port = start_server(["--bind", "127.0.0.1:0", "--data-dir",
                         str(tmp_path / "port"), "--device", "cpu",
                         "--no-oplog"])
    try:
        for api, uri, pkg in ((ref.api, ref.address, PKGS["jax"]),
                              (port.api, port.uri, PKGS["port"])):
            c = Client(uri)
            assert c.debug_oplog()["enabled"] is False
            api.oplog = pkg.OpLog(str(tmp_path / f"{uri[-5:]}log")).open()
            api.oplog.append({"kind": "bits"})
            out = c.debug_oplog()
            assert out["enabled"] is True
            assert out["last_lsn"] == 1
            assert out["segment_files"]
            api.oplog.close()
        keys = [set(Client(u).debug_oplog()) for u in
                (ref.address, port.uri)]
        assert keys[0] == keys[1]
    finally:
        port.stop()
        ref.close()


def test_server_boot_replays_and_reports(tmp_path, capsys):
    """`server` opens <data-dir>/oplog by default and replays it before
    serving; the log directory is not an index."""
    d = str(tmp_path / "d")
    srv = start_server(["--bind", "127.0.0.1:0", "--data-dir", d,
                        "--device", "cpu"])
    c = Client(srv.uri)
    c.create_index("i")
    c.create_field("i", "f")
    torch_faultpoints.arm("import.post-append=raise")
    with pytest.raises(Exception):
        c.import_bits("i", "f", [1], [11])
    torch_faultpoints.disarm()
    # the process "dies": no shutdown checkpoint
    srv.http.stop()
    srv.holder.close()
    srv2 = start_server(["--bind", "127.0.0.1:0", "--data-dir", d,
                         "--device", "cpu"])
    try:
        assert srv2.replayed == 1
        c2 = Client(srv2.uri)
        assert c2.query("i", "Row(f=1)")["results"][0]["columns"] == [11]
        assert [i["name"] for i in c2.schema()["indexes"]] == ["i"]
        assert c2.debug_oplog()["checkpoint_lsn"] == 1
        # the log's directory name is reserved: an index there would
        # share its files
        with pytest.raises(Exception, match="reserved"):
            c2.create_index("oplog")
    finally:
        srv2.stop()


def test_sync_fragments_races_no_fragment_creation(tmp_path, monkeypatch):
    """Holder.sync_fragments (the oplog rotation checkpoint's fsync
    sweep) while an import creates fragments in the same view: each
    view's fragment map is snapshotted under its lock, so the sweep
    never fails with "dictionary changed size during iteration". Every
    fragment that existed when the sweep reached its view is synced, and
    the next sweep syncs the new ones too."""
    import threading

    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    holder = torch_core.Holder(str(tmp_path / "h"),
                               use_snapshot_queue=False).open()
    try:
        field = holder.create_index("i").create_field("f")
        for shard in range(4):
            field.set_bit(1, shard * SHARD_WIDTH)
        real_sync = Fragment.sync
        synced, created = [], []

        def create_more():
            # an import landing in shards the view does not hold yet
            for shard in range(4, 12):
                field.set_bit(1, shard * SHARD_WIDTH + 3)
                created.append(shard)

        def sync_and_race(frag):
            if not synced:
                t = threading.Thread(target=create_more)
                t.start()
                t.join()
            synced.append(frag.shard)
            return real_sync(frag)

        monkeypatch.setattr(Fragment, "sync", sync_and_race)
        assert holder.sync_fragments() == 4
        assert sorted(synced) == [0, 1, 2, 3] and len(created) == 8
        monkeypatch.setattr(Fragment, "sync", real_sync)
        assert holder.sync_fragments() == 12

        # free-running: a writer thread creating fragments while sweeps
        # run back to back
        stop = threading.Event()

        def writer():
            shard = 12
            while not stop.is_set() and shard < 400:
                field.set_bit(2, shard * SHARD_WIDTH)
                shard += 1

        t = threading.Thread(target=writer)
        t.start()
        try:
            for _ in range(20):
                holder.sync_fragments()
        finally:
            stop.set()
            t.join()
        view = field.view("standard")
        assert holder.sync_fragments() == len(view.fragments)
    finally:
        holder.close()
