"""Holder: root container for all data on a node (reference: holder.go:50).

Opens/closes indexes from the data directory, owns the snapshot queue (the
background persister, reference: fragment.go:187-241), and exposes schema.
"""

import logging
import os
import queue
import shutil
import threading

from ..storage.oplog import OPLOG_DIR
from .field import FieldOptions
from .index import Index, IndexOptions, validate_name


class HolderError(Exception):
    pass


class SnapshotQueue:
    """Single background worker persisting fragments whose op log exceeded
    max_op_n (reference: newSnapshotQueue fragment.go:187). Bounded queue;
    enqueue degrades to synchronous snapshot when full (the reference logs
    and skips; synchronous is safer)."""

    def __init__(self, size=100):
        self._queue = queue.Queue(maxsize=size)
        self._thread = None
        self._stop = threading.Event()

    def start(self):
        self._thread = threading.Thread(
            target=self._worker, name="snapshot-queue", daemon=True)
        self._thread.start()
        return self

    def _worker(self):
        while not self._stop.is_set():
            try:
                frag = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if frag.is_open and frag.op_n > 0:
                    frag.snapshot()
            except Exception:
                logging.getLogger("pilosa_tpu_torch").exception(
                    "snapshot failed for %r", frag)
            finally:
                self._queue.task_done()

    def enqueue(self, fragment):
        try:
            self._queue.put_nowait(fragment)
        except queue.Full:
            fragment.snapshot()

    def stop(self):
        if self._thread is None:
            return
        self._queue.join()
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None


class Holder:
    def __init__(self, path, max_op_n=None, use_snapshot_queue=True,
                 cache_flush_interval=60.0):
        self.path = path
        self.max_op_n = max_op_n
        self.indexes = {}
        # set by the TranslateReplicator before indexes open so replica
        # stores come up read-only with the primary-forward hook installed
        self.translate_configurer = None
        self.snapshot_queue = SnapshotQueue() if use_snapshot_queue else None
        # periodic TopN cache persistence (reference: holder.go:506-549);
        # <=0 disables the ticker (fragments still flush on close)
        self.cache_flush_interval = cache_flush_interval
        self._flush_stop = None
        self._flush_thread = None
        self._lock = threading.RLock()
        self.opened = False

    # -- lifecycle ----------------------------------------------------------

    def open(self):
        """(reference: Holder.Open holder.go:137) Scan data dir and open
        every index."""
        os.makedirs(self.path, exist_ok=True)
        if self.snapshot_queue:
            self.snapshot_queue.start()
        for name in sorted(os.listdir(self.path)):
            sub = os.path.join(self.path, name)
            # the server's write-ahead log lives beside the indexes
            if os.path.isdir(sub) and name != OPLOG_DIR:
                self._new_index(name).open()
        if self.cache_flush_interval > 0:
            self._flush_stop = threading.Event()
            self._flush_thread = threading.Thread(
                target=self._flush_worker, daemon=True,
                name="cache-flush")
            self._flush_thread.start()
        self.opened = True
        return self

    def _flush_worker(self):
        while not self._flush_stop.wait(self.cache_flush_interval):
            try:
                self.flush_caches()
            except Exception:
                pass  # flush is best-effort; fragments also flush on close

    def close(self):
        with self._lock:
            if self._flush_thread is not None:
                self._flush_stop.set()
                self._flush_thread.join(timeout=5)
                self._flush_thread = None
            if self.snapshot_queue:
                self.snapshot_queue.stop()
            for idx in self.indexes.values():
                idx.close()
            self.indexes.clear()
            self.opened = False

    def reopen(self):
        """Close and reopen from disk (test harness parity: test/pilosa.go:120)."""
        self.close()
        self.snapshot_queue = SnapshotQueue() if self.snapshot_queue is not None else None
        return self.open()

    # -- TopN caches ---------------------------------------------------------

    def _all_fragments(self):
        """Every open fragment. Each view's map is snapshotted under the
        view's lock before its fragments are handed out: an import may
        create fragments while a sweep (sync_fragments under the oplog's
        rotation checkpoint, a cache flush) walks them."""
        for idx in list(self.indexes.values()):
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    with view._lock:
                        frags = list(view.fragments.values())
                    yield from frags

    def flush_caches(self):
        """Persist every fragment's TopN cache (reference: holder cache
        flush ticker holder.go:506-549)."""
        for frag in self._all_fragments():
            frag.flush_cache()

    def recalculate_caches(self):
        """(reference: Holder.RecalculateCaches holder.go:553)"""
        for frag in self._all_fragments():
            frag.recalculate_cache()

    # -- durability ----------------------------------------------------------

    def sync_fragments(self):
        """fsync every open fragment's WAL file. Called before an oplog
        checkpoint: once the fragments below the log are durable, the
        checkpointed prefix truly never needs replaying."""
        n = 0
        for frag in self._all_fragments():
            try:
                frag.sync()
                n += 1
            except Exception:
                logging.getLogger("pilosa_tpu_torch").exception(
                    "fsync failed for %r", frag)
        return n

    def replay_oplog(self, oplog, apply, logger=None):
        """Boot-time crash recovery: feed every unapplied oplog record
        through ``apply(lsn, record)`` in LSN order. A record that fails
        is logged and counted, not fatal — one poisoned record must not
        keep the node from booting (same stance as torn-tail
        truncation). Returns ``(applied, failed)``."""
        from ..utils import flightrec

        applied = failed = 0
        first = last = None
        for lsn, record in oplog.replay():
            if first is None:
                first = lsn
            last = lsn
            try:
                apply(lsn, record)
                applied += 1
            except Exception as e:  # noqa: BLE001 — count, don't wedge boot
                failed += 1
                if logger is not None:
                    logger.printf(
                        "oplog replay: record lsn=%d (%s) failed: %s",
                        lsn, record.get("kind"), e)
            finally:
                # failed records advance the watermark too: they are
                # deterministic failures, not transient ones, and must
                # not pin the checkpoint (they were counted above)
                oplog.mark_applied(lsn)
        if applied or failed:
            flightrec.record("oplog.replay", first_lsn=first, last_lsn=last,
                             applied=applied, failed=failed)
            if logger is not None:
                logger.printf(
                    "oplog replay: %d applied, %d failed (lsn %s..%s)",
                    applied, failed, first, last)
        return applied, failed

    # -- indexes ------------------------------------------------------------

    def _new_index(self, name):
        idx = Index(
            os.path.join(self.path, name), name, max_op_n=self.max_op_n,
            snapshot_queue=self.snapshot_queue,
            translate_configurer=self.translate_configurer)
        self.indexes[name] = idx
        return idx

    def translate_stores(self):
        """Every live translate store (index column + field row stores)."""
        for idx in list(self.indexes.values()):
            if idx.translate_store is not None:
                yield idx.translate_store
            for field in list(idx.fields.values()):
                if field.translate_store is not None:
                    yield field.translate_store

    def index(self, name):
        return self.indexes.get(name)

    def create_index(self, name, options=None, if_not_exists=False):
        """(reference: Holder.CreateIndex holder.go:379)"""
        validate_name(name)
        if name == OPLOG_DIR:
            raise HolderError(
                f"index name {name!r} is reserved for the write-ahead log")
        with self._lock:
            existing = self.indexes.get(name)
            if existing is not None:
                if if_not_exists:
                    return existing
                raise HolderError(f"index already exists: {name}")
            idx = self._new_index(name)
            idx.options = options or IndexOptions()
            idx.open()
            return idx

    def delete_index(self, name):
        with self._lock:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise HolderError(f"index not found: {name}")
            idx.close()
            shutil.rmtree(idx.path, ignore_errors=True)

    # -- schema -------------------------------------------------------------

    def schema(self):
        """Serializable schema description (reference: Holder.Schema)."""
        out = []
        for iname in sorted(self.indexes):
            idx = self.indexes[iname]
            fields = []
            for fname in sorted(idx.public_fields()):
                f = idx.fields[fname]
                fields.append({
                    "name": fname,
                    "options": f.options.to_dict(),
                    "shards": f.available_shards(),
                })
            out.append({
                "name": iname,
                "options": idx.options.to_dict(),
                "fields": fields,
            })
        return out

    def apply_schema(self, schema):
        """Create any missing indexes/fields from a schema description
        (cluster DDL sync; reference: api.ApplySchema/holder merge)."""
        for idx_desc in schema:
            idx = self.create_index(
                idx_desc["name"],
                options=IndexOptions.from_dict(idx_desc.get("options", {})),
                if_not_exists=True)
            for f_desc in idx_desc.get("fields", []):
                idx.create_field(
                    f_desc["name"],
                    options=FieldOptions.from_dict(f_desc.get("options", {})),
                    if_not_exists=True)
