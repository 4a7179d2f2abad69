"""Node-local durable write-ahead oplog (storage/oplog.py).

The fragment layer's file is already ``snapshot ++ op log`` (reference:
fragment.go), but nothing above it is durable: the API acks an import
after an in-memory apply, and a queued resize write dies with the
process. This module closes that gap with a node-level WAL the API
appends to BEFORE any ack can return:

  - segmented append-only log: ``oplog/seg-<first_lsn>.wal`` files of
    length-prefixed, CRC32-checksummed JSON records, rotated past
    ``segment_max_bytes``;
  - fsync policy ``always | interval | never``: per-append fsync,
    background fsync every ``fsync_interval`` seconds, or OS-cache only.
    Every append is ``write()+flush()`` regardless, so a plain process
    crash (kill -9) loses nothing even at ``never`` — the policy only
    decides exposure to power/kernel loss;
  - checkpoint-based truncation: ``CHECKPOINT`` records the last LSN
    whose effects are known durable below the log (fragments fsynced);
    whole segments at or below it are deleted;
  - torn-tail recovery: a short/corrupt record at open TRUNCATES the log
    there (flightrec ``oplog.truncated_tail``) instead of failing boot —
    a torn record was never acked, because the append path returns only
    after the full record hit the OS;
  - applied watermark: appends are acked after a synchronous apply, and
    ``mark_applied(lsn)`` advances a contiguous watermark the checkpoint
    never passes, so a checkpoint can't bless a record whose apply raced
    a fragment fsync.

Replay order is LSN order == arrival order: set-bit records are
idempotent and BSI value records are last-write-wins, so re-applying an
already-applied suffix converges to the pre-crash state.

The module also owns the PROCESS-WIDE fsync policy shared with
``core/fragment.py`` (one ``--fsync`` flag / ``[storage]`` config key
covers both layers): ``set_fsync_policy()`` + ``after_append()`` give
fragments the same always/interval/never semantics on their own op
appends, and the interval syncer thread services both.
"""

import json
import os
import struct
import threading
import time
import zlib

from ..utils import faultpoints, flightrec
from ..utils.stats import global_stats

#: record header: payload length, crc32(payload), lsn
_HEADER = struct.Struct("<IIQ")
#: upper bound on a sane record; a longer length prefix is torn garbage
MAX_RECORD_BYTES = 256 << 20

DEFAULT_SEGMENT_BYTES = 64 << 20
DEFAULT_FSYNC_INTERVAL = 0.05

FSYNC_MODES = ("always", "interval", "never")

_CHECKPOINT = "CHECKPOINT"

#: the log's directory under a server's data directory; the holder
#: opens no index there and reserves the name
OPLOG_DIR = "oplog"


class OpLogError(Exception):
    pass


# -- process-wide fsync policy (shared with core/fragment.py) ---------------

_policy = "never"
_policy_interval = DEFAULT_FSYNC_INTERVAL
_dirty_lock = threading.Lock()
_dirty = set()  # file objects awaiting an interval fsync
_syncer = None


def set_fsync_policy(mode, interval=None):
    """Install the process-wide fsync policy (``--fsync`` / ``[storage]
    fsync``). Fragments and any OpLog built without an explicit mode
    follow it."""
    global _policy, _policy_interval
    if mode not in FSYNC_MODES:
        raise ValueError(
            f"invalid fsync mode {mode!r} (want one of {FSYNC_MODES})")
    _policy = mode
    if interval is not None:
        _policy_interval = float(interval)
    if mode == "interval":
        _ensure_syncer()


def fsync_policy():
    return _policy


def fsync_file(f, stat_name=None):
    """flush+fsync one file object, timing into ``stat_name``. Tolerates
    a concurrently-closed file (snapshot rename, shutdown): durability
    of a closed-and-replaced file is the replacer's problem."""
    faultpoints.reached("oplog.fsync")
    t0 = time.monotonic()
    try:
        f.flush()
        os.fsync(f.fileno())
    except (ValueError, OSError):
        return
    if stat_name is not None:
        global_stats.timing(stat_name, time.monotonic() - t0)


def after_append(f, stat_name="fragment_fsync_seconds"):
    """Durability hook for a just-flushed append (fragment op appends
    call this): fsync now (``always``), mark dirty for the background
    syncer (``interval``), or nothing (``never`` — the default, which
    keeps this a single global read on the hot path)."""
    if _policy == "never":
        return
    if _policy == "always":
        fsync_file(f, stat_name)
        return
    with _dirty_lock:
        _dirty.add(f)
    _ensure_syncer()


def _ensure_syncer():
    global _syncer
    if _syncer is not None and _syncer.is_alive():
        return
    _syncer = threading.Thread(
        target=_syncer_loop, name="fsync-interval", daemon=True)
    _syncer.start()


def _syncer_loop():
    while True:
        time.sleep(_policy_interval)
        with _dirty_lock:
            batch = list(_dirty)
            _dirty.clear()
        for f in batch:
            fsync_file(f)


# -- the oplog ---------------------------------------------------------------


class OpLog:
    """Segmented durable write-ahead log of import records.

    Thread-safe; one instance per node, living at ``<data-dir>/oplog``.
    ``append()`` returns only after the record is durable to the
    configured policy; ``mark_applied()`` is called after the write's
    synchronous apply; ``checkpoint()`` persists the applied watermark
    and drops fully-applied segments.
    """

    def __init__(self, path, fsync=None, fsync_interval=None,
                 segment_max_bytes=DEFAULT_SEGMENT_BYTES, logger=None,
                 on_rotate=None):
        self.path = path
        self.fsync = fsync if fsync is not None else _policy
        if self.fsync not in FSYNC_MODES:
            raise ValueError(f"invalid fsync mode {self.fsync!r}")
        self._fsync_interval = (fsync_interval if fsync_interval is not None
                                else _policy_interval)
        self.segment_max_bytes = int(segment_max_bytes)
        self.logger = logger
        #: called with the just-sealed segment's last LSN after a
        #: rotation — the API hooks a fragment-fsync + checkpoint here
        #: so the log stays bounded without a periodic ticker
        self.on_rotate = on_rotate

        self._lock = threading.RLock()
        self._file = None
        # [{name, first_lsn, last_lsn, bytes}] in LSN order; the last
        # entry is the active segment
        self._segments = []
        self._next_lsn = 1
        self._checkpoint_lsn = 0
        self._applied_lsn = 0
        self._applied_gap = set()  # lsns applied out of order
        self._appends = 0
        self._total_bytes = 0
        self._truncated_tail = 0
        self._replayed = 0
        self._opened = False

    # -- lifecycle -----------------------------------------------------------

    def open(self):
        """Scan segments, recover the torn tail, open for append."""
        os.makedirs(self.path, exist_ok=True)
        self._checkpoint_lsn = self._load_checkpoint()
        self._applied_lsn = self._checkpoint_lsn
        names = sorted(n for n in os.listdir(self.path)
                       if n.startswith("seg-") and n.endswith(".wal"))
        last_lsn = self._checkpoint_lsn
        for i, name in enumerate(names):
            seg_path = os.path.join(self.path, name)
            first, last, good_bytes, torn = self._scan_segment(seg_path)
            if torn:
                # torn tail: truncate at the first bad record. Anything
                # past it (including later segments) was never acked —
                # the appender returns only after write+flush succeeds
                # in LSN order — so dropping it loses no acked write.
                with open(seg_path, "r+b") as f:
                    f.truncate(good_bytes)
                self._truncated_tail += 1
                flightrec.record("oplog.truncated_tail", segment=name,
                                 kept_bytes=good_bytes)
                self._log("oplog: torn tail in %s — truncated to %d "
                          "bytes", name, good_bytes)
                for later in names[i + 1:]:
                    os.unlink(os.path.join(self.path, later))
                    flightrec.record("oplog.truncated_tail",
                                     segment=later, kept_bytes=0)
                    self._log("oplog: dropped segment %s after torn "
                              "tail", later)
            if good_bytes == 0 and first is None:
                os.unlink(seg_path)
                if torn:
                    break
                continue
            self._segments.append({
                "name": name, "first_lsn": first, "last_lsn": last,
                "bytes": good_bytes})
            if last is not None:
                last_lsn = max(last_lsn, last)
            if torn:
                break
        self._next_lsn = last_lsn + 1
        if not self._segments:
            self._new_segment()
        else:
            active = os.path.join(self.path, self._segments[-1]["name"])
            self._file = open(active, "ab")
        if self.fsync == "interval":
            _ensure_syncer()
        self._opened = True
        self._update_gauges()
        return self

    def close(self):
        """Clean shutdown: checkpoint at the applied watermark (an
        orderly restart replays nothing) and close the active file."""
        with self._lock:
            if not self._opened:
                return
            try:
                self.checkpoint()
            except Exception:
                pass  # a failed final checkpoint only costs replay time
            if self._file is not None:
                try:
                    if self.fsync != "never":
                        fsync_file(self._file, "oplog_fsync_seconds")
                    self._file.close()
                except (ValueError, OSError):
                    pass
                self._file = None
            self._opened = False

    def _log(self, fmt, *args):
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    # -- append path ---------------------------------------------------------

    def append(self, record):
        """Append one import record (a JSON-safe dict). Returns its LSN
        only after the record is durable per the fsync policy — callers
        ack AFTER this returns, which is the whole durability contract."""
        payload = json.dumps(record, separators=(",", ":")).encode()
        crc = zlib.crc32(payload)
        size = _HEADER.size + len(payload)
        rotated_last = None
        with self._lock:
            if self._file is None:
                raise OpLogError("oplog is closed")
            lsn = self._next_lsn
            self._next_lsn += 1
            self._file.write(_HEADER.pack(len(payload), crc, lsn))
            self._file.write(payload)
            # flush to the OS unconditionally: records survive a process
            # kill even at fsync=never; the policy below only adds
            # power-loss durability
            self._file.flush()
            if self.fsync == "always":
                fsync_file(self._file, "oplog_fsync_seconds")
            elif self.fsync == "interval":
                with _dirty_lock:
                    _dirty.add(self._file)
            seg = self._segments[-1]
            if seg["first_lsn"] is None:
                seg["first_lsn"] = lsn
            seg["last_lsn"] = lsn
            seg["bytes"] += size
            self._total_bytes += size
            self._appends += 1
            if seg["bytes"] >= self.segment_max_bytes:
                rotated_last = self._rotate()
        global_stats.count("oplog_appends_total")
        global_stats.gauge("oplog_bytes", self._total_bytes)
        if rotated_last is not None and self.on_rotate is not None:
            # outside the lock: the hook fsyncs fragments + checkpoints,
            # neither of which should serialize concurrent appends
            self.on_rotate(rotated_last)
        return lsn

    def _rotate(self):
        """Seal the active segment, open the next (lock held)."""
        seg = self._segments[-1]
        if self.fsync != "never":
            fsync_file(self._file, "oplog_fsync_seconds")
        self._file.close()
        last = seg["last_lsn"]
        self._new_segment()
        flightrec.record("oplog.rotate", sealed=seg["name"],
                         last_lsn=last, bytes=seg["bytes"])
        return last

    def _new_segment(self):
        name = f"seg-{self._next_lsn:016d}.wal"
        self._segments.append({
            "name": name, "first_lsn": None, "last_lsn": None, "bytes": 0})
        self._file = open(os.path.join(self.path, name), "ab")

    def sync(self):
        """Force an fsync of the active segment now."""
        with self._lock:
            if self._file is not None:
                fsync_file(self._file, "oplog_fsync_seconds")

    # -- applied watermark + checkpoint --------------------------------------

    def mark_applied(self, lsn):
        """Record that the write at ``lsn`` finished its synchronous
        apply. The watermark advances only over CONTIGUOUS applied LSNs:
        an append whose apply is still in flight pins the checkpoint
        below it, so a crash between fragment fsync and apply can never
        lose it."""
        with self._lock:
            if lsn <= self._applied_lsn:
                return
            self._applied_gap.add(lsn)
            while self._applied_lsn + 1 in self._applied_gap:
                self._applied_lsn += 1
                self._applied_gap.discard(self._applied_lsn)

    def checkpoint(self, lsn=None):
        """Persist the applied-through marker and delete whole segments
        at or below it. ``lsn`` defaults to (and is clamped by) the
        applied watermark — a checkpoint must never claim a record whose
        apply hasn't finished."""
        with self._lock:
            target = self._applied_lsn if lsn is None \
                else min(int(lsn), self._applied_lsn)
            if target < self._checkpoint_lsn:
                return self._checkpoint_lsn
            tmp = os.path.join(self.path, _CHECKPOINT + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"lsn": target}, f)
                if self.fsync != "never":
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, _CHECKPOINT))
            self._checkpoint_lsn = target
            # drop sealed segments that are entirely applied
            keep = []
            for seg in self._segments:
                sealed = seg is not self._segments[-1]
                if sealed and seg["last_lsn"] is not None \
                        and seg["last_lsn"] <= target:
                    os.unlink(os.path.join(self.path, seg["name"]))
                else:
                    keep.append(seg)
            self._segments = keep
        self._update_gauges()
        return target

    def _load_checkpoint(self):
        try:
            with open(os.path.join(self.path, _CHECKPOINT)) as f:
                return int(json.load(f)["lsn"])
        except (OSError, ValueError, KeyError):
            return 0

    # -- replay --------------------------------------------------------------

    def replay(self):
        """Yield ``(lsn, record)`` for every record past the checkpoint,
        in LSN (== arrival) order. Defensive against a record corrupted
        after open: stops there like the open-time torn-tail rule."""
        with self._lock:
            segments = [dict(s) for s in self._segments]
            ckpt = self._checkpoint_lsn
        for seg in segments:
            if seg["last_lsn"] is not None and seg["last_lsn"] <= ckpt:
                continue
            for lsn, record, _off in self._read_segment(
                    os.path.join(self.path, seg["name"])):
                if lsn <= ckpt:
                    continue
                self._replayed += 1
                yield lsn, record

    def _scan_segment(self, path):
        """(first_lsn, last_lsn, good_bytes, torn) for one segment."""
        first = last = None
        good = 0
        torn = False
        try:
            for lsn, _record, end in self._read_segment(path):
                if first is None:
                    first = lsn
                last = lsn
                good = end
            if good < os.path.getsize(path):
                torn = True
        except _TornRecord:
            torn = True
        return first, last, good, torn

    def _read_segment(self, path):
        """Yield ``(lsn, record, end_offset)`` until EOF or the first bad
        record (short header, short payload, insane length, CRC
        mismatch, undecodable JSON) — the torn-tail boundary."""
        with open(path, "rb") as f:
            off = 0
            while True:
                header = f.read(_HEADER.size)
                if not header:
                    return
                if len(header) < _HEADER.size:
                    raise _TornRecord(off)
                length, crc, lsn = _HEADER.unpack(header)
                if length > MAX_RECORD_BYTES:
                    raise _TornRecord(off)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    raise _TornRecord(off)
                try:
                    record = json.loads(payload.decode())
                except (UnicodeDecodeError, ValueError) as e:
                    raise _TornRecord(off) from e
                off += _HEADER.size + length
                yield lsn, record, off

    # -- observability -------------------------------------------------------

    def _update_gauges(self):
        with self._lock:
            self._total_bytes = sum(s["bytes"] for s in self._segments)
            total = self._total_bytes
        global_stats.gauge("oplog_bytes", total)

    @property
    def last_lsn(self):
        with self._lock:
            return self._next_lsn - 1

    @property
    def applied_lsn(self):
        with self._lock:
            return self._applied_lsn

    @property
    def checkpoint_lsn(self):
        with self._lock:
            return self._checkpoint_lsn

    def summary(self, compact=False):
        """State for GET /debug/oplog and the /status observability
        roll-up. ``replay_lag`` = appended-but-not-yet-applied records
        (nonzero under load or with a wedged apply); ``unapplied`` =
        records a crash right now would replay at next boot."""
        with self._lock:
            out = {
                "path": self.path,
                "fsync": self.fsync,
                "last_lsn": self._next_lsn - 1,
                "applied_lsn": self._applied_lsn,
                "checkpoint_lsn": self._checkpoint_lsn,
                "replay_lag": (self._next_lsn - 1) - self._applied_lsn,
                "unapplied": (self._next_lsn - 1) - self._checkpoint_lsn,
                "appends": self._appends,
                "bytes": sum(s["bytes"] for s in self._segments),
                "segments": len(self._segments),
                "truncated_tails": self._truncated_tail,
            }
            if not compact:
                out["segment_files"] = [dict(s) for s in self._segments]
                out["segment_max_bytes"] = self.segment_max_bytes
        return out


class _TornRecord(Exception):
    """Internal: segment read hit a torn/corrupt record at offset."""
