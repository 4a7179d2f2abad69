"""Streaming ingest engine: delta-buffered writes with interval-batched
in-place merges into the resident device stacks (the TPU package's
`exec/ingest.py`, whose buffer, coverage rule, back-pressure, group
commit and merge planning are copied here; only the merge's device side
differs).

The problem: acked writes are durable (the oplog), but stack maintenance
happens on the READ path — every import bumps fragment generations, and
the next query over a stale cached stack repairs it inline (host gather +
device patch under the process-wide dispatch lock), while compressed
containers decay to dense on the first write. Sustained ingest therefore
taxes read latency once per (fragment, interval) — the reference never
pays this because roaring absorbs write churn in an op-log-over-snapshot
delta (roaring.go:228-249); this module is the device analogue.

Shape:

  server/api.py import paths      exec/ingest.py merge thread
  ------------------------------  ---------------------------------
  oplog append  (durability)      every --ingest-merge-interval, or
  fragment apply (host truth)       at the rows/bytes high-water mark:
  record() -> delta buffer        drain: ONE dispatch-lock window
  ack (unchanged)                   copies every pending delta into the
                                    touched resident stacks in place

Reads whose cache-entry drift is FULLY covered by pending deltas serve
the resident stack as-is (bounded staleness <= one merge interval; see
covers_pending). Drift the buffer does not cover — a PQL Set/Clear on a
fragment with no pending entry, a dropped/recreated fragment — falls
back to the read-path repair unchanged. Interval 0 (the default) never
constructs an engine: the import path is one `is None` check and every
read behaves exactly as without the engine.

Crash semantics: buffered-but-unmerged deltas are ALREADY durable — the
oplog record precedes the buffer append, and the host fragments hold the
applied bits. Only the device stack cache is behind; a crash loses
nothing and boot replay needs no new machinery. Under fsync=interval the
engine also group-commits the applied watermark: mark_applied calls for
acked imports batch per merge interval (bounded by the oplog's gap set),
flushed at every drain and at close().

The merge's device side: where the TPU package runs three donated jitted
scatters (`.at[].set`, :108-130), the port copies the drifted shards'
planes into the resident tensors with `index_copy_` — a dense leaf's
[S, W] stack on axis 0, a rows chunk's [R, S, W] and the BSI field's
single [D+2, S, W] stack (rows exists, sign, then the magnitudes) on
axis 1 — all in one `_locked_dispatch("ingest_merge")` window, on the
stacks' own device (no host fold, no host path for a CUDA stack). A
compressed leaf takes an overlay term or a rebuild instead (a new
Container), and every result swaps in by identity (`merge_swap`). The
TPU package warns of a donated buffer read by a reader that dispatches
late; here such a reader sees the newer planes instead: the copy and
every serving launch hold the dispatch lock and run in one stream, so a
launch reads the planes either wholly before or wholly after the copy.
Because the copy writes in place, it first re-reads, under the lock, the
generations of the shards it copies and skips an entry whose fragments
moved since its gather: a read-path patch of the same entry may have
copied newer planes meanwhile, and older ones must not land over them.
"""

import threading
import time

import numpy as np

from ..utils import faultpoints
from ..utils import flightrec as _flightrec
from ..utils.stats import global_stats

__all__ = [
    "IngestEngine",
    "covers_pending",
    "mode",
    "DEFAULT_MAX_ROWS",
    "DEFAULT_MAX_BYTES",
]

#: high-water marks that force an early drain (and 503 back-pressure
#: past them): enough headroom for seconds of bulk import without
#: letting an unmerged backlog grow unboundedly between intervals
DEFAULT_MAX_ROWS = 1_000_000
DEFAULT_MAX_BYTES = 64 << 20

_REGISTRY_LOCK = threading.Lock()
_REGISTRY = []  # active engines; read lock-free on the serving path


def covers_pending(index, field, view, shards, old_gens, gens):
    """True when EVERY drifted shard of a stale cache entry is covered
    by a pending ingest delta at its current generation — the read may
    serve the resident stack as-is and leave the fold to the interval
    merge. One list check when no engine is active (the default)."""
    engines = _REGISTRY
    if not engines:
        return False
    for eng in engines:
        if eng.covers(index, field, view, shards, old_gens, gens):
            return True
    return False


def mode():
    """'off' or 'interval=<seconds>s' — bench attempt tagging."""
    engines = _REGISTRY
    if not engines:
        return "off"
    return f"interval={engines[0].interval:g}s"


class IngestEngine:
    """Bounded host-side delta buffer + background interval merger for
    one API's evaluator. Construct only with interval > 0; the thread
    starts immediately and close() drains the tail."""

    def __init__(self, api, interval, max_rows=None, max_bytes=None):
        if interval <= 0:
            raise ValueError("ingest merge interval must be > 0")
        self.api = api
        self.interval = float(interval)
        self.max_rows = int(max_rows or DEFAULT_MAX_ROWS)
        self.max_bytes = int(max_bytes or DEFAULT_MAX_BYTES)
        # pending: (index, field, view, shard) -> [uid, gen, rows, bytes]
        # — the (uid, gen) is the fragment's generation AFTER the
        # recorded apply, which is what covers() compares reads against
        self._pending = {}
        self._rows = 0
        self._bytes = 0
        self._deferred = []  # lsns whose mark_applied group-commits
        self._plock = threading.Lock()
        self._merge_lock = threading.Lock()  # serializes drains
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        # counters (under _plock; ints, so snapshots are cheap)
        self.merges = 0
        self.merged_keys = 0
        self.scatter_entries = 0
        self.overlay_entries = 0
        self.rebuilt_entries = 0
        self.dropped_entries = 0
        self.skipped_entries = 0
        self.overflows = 0
        self.merges_shed = 0
        self.group_commit_flushed = 0
        self.last_merge = None  # {wall_seconds, at, entries, deltas}
        # admission-ladder hook: when set and truthy at a TIMER tick,
        # the interval merge is skipped (deltas keep buffering; reads
        # serve the resident — stale — stacks). Overflow wakes always
        # merge: shedding those would deadlock the write path behind
        # its own back-pressure gate.
        self._shed_probe = None
        with _REGISTRY_LOCK:
            _REGISTRY.append(self)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ingest-merge")
        self._thread.start()

    # -- write-path hooks (called by server/api.py) ---------------------------

    def set_shed_probe(self, fn):
        """Install the admission ladder's merge-shed predicate (None
        clears)."""
        self._shed_probe = fn

    def admit(self, rows, nbytes):
        """Back-pressure gate BEFORE the oplog append: returns a
        retry-after in seconds when the buffer is past its high-water
        mark (the API turns it into 503 + Retry-After), else None. An
        overflow also wakes the merger immediately."""
        with self._plock:
            over = (self._rows + rows > self.max_rows
                    or self._bytes + nbytes > self.max_bytes)
            if over:
                self.overflows += 1
        if over:
            _flightrec.record("ingest.overflow", rows=self._rows,
                              bytes=self._bytes)
            global_stats.count("ingest_overflows", 1)
            self._wake.set()
            return max(1.0, self.interval)
        return None

    def record(self, index_name, field, shard_rows, nbytes):
        """Buffer one applied import's deltas: for every view of `field`
        and every touched shard, remember the fragment's post-apply
        (uid, generation). The merge gathers planes from the
        authoritative host fragments, so recording the CURRENT gens is
        exact — any earlier un-recorded write to the same fragment rides
        the same fold. `shard_rows` maps shard -> input rows landed
        there; `nbytes` is the import's wire-size estimate (distributed
        per shard for the high-water accounting)."""
        if not shard_rows:
            return
        total = sum(shard_rows.values()) or 1
        entries = []
        for view in list(field.views.values()):
            for shard, n in shard_rows.items():
                frag = view.fragment(shard)
                if frag is None:
                    continue
                entries.append(
                    ((index_name, field.name, view.name, shard),
                     frag.uid, frag.generation, n,
                     nbytes * n // total))
        if not entries:
            return
        high = False
        with self._plock:
            for key, uid, gen, n, nb in entries:
                rec = self._pending.get(key)
                if rec is not None and (rec[0], rec[1]) == (uid, gen):
                    rec[2] += n
                    rec[3] += nb
                else:
                    prev_rows = rec[2] if rec is not None else 0
                    prev_bytes = rec[3] if rec is not None else 0
                    self._pending[key] = [uid, gen, prev_rows + n,
                                          prev_bytes + nb]
                self._rows += n
                self._bytes += nb
            high = (self._rows >= self.max_rows
                    or self._bytes >= self.max_bytes)
        if high:
            self._wake.set()

    def defer_applied(self, lsn):
        """Group-commit hook: True = this record's mark_applied is
        deferred to the next drain (fsync=interval only — under
        fsync=always the watermark IS the durability contract and
        advances per record as before)."""
        if lsn is None or self._closed:
            return False
        oplog = self.api.oplog
        if oplog is None or oplog.fsync != "interval":
            return False
        with self._plock:
            if self._closed:
                return False
            self._deferred.append(lsn)
        return True

    def covers(self, index, field, view, shards, old_gens, gens):
        """True when every drifted shard's current generation matches a
        pending delta record — i.e. the merge will fold exactly the
        drift this read sees."""
        hit = False
        with self._plock:
            pending = self._pending
            for j, (o, n) in enumerate(zip(old_gens, gens)):
                if o == n:
                    continue
                rec = pending.get((index, field, view, shards[j]))
                if rec is None or (rec[0], rec[1]) != n:
                    return False
                hit = True
        return hit

    # -- merge ---------------------------------------------------------------

    def _evaluator(self):
        return getattr(getattr(self.api.executor, "local", self.api.executor),
                       "_stacked", None)

    def flush(self):
        """Synchronous drain (tests; close). Serialized with the
        background thread's drains."""
        with self._merge_lock:
            self._drain()

    def _loop(self):
        while True:
            forced = self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            probe = self._shed_probe
            if not forced and probe is not None and probe():
                # the admission ladder sheds interval merges to keep the
                # device free for interactive reads. Deltas stay
                # buffered; an overflow (forced wake) still merges.
                with self._plock:
                    self.merges_shed += 1
                    pending = bool(self._pending or self._deferred)
                if pending:
                    _flightrec.record("ingest.merge_shed",
                                      rows=self._rows, bytes=self._bytes)
                continue
            try:
                self.flush()
            except Exception as exc:  # noqa: BLE001 — keep merging
                global_stats.count("ingest_merge_errors", 1)
                _flightrec.record("ingest.merge_error", error=str(exc))

    def _drain(self):
        with self._plock:
            snapshot = dict(self._pending)
            deferred = self._deferred
            self._deferred = []
        if not snapshot and not deferred:
            return
        faultpoints.reached("ingest.pre-merge")
        t0 = time.perf_counter()
        stats = {"entries": 0, "scatters": 0, "overlays": 0,
                 "rebuilds": 0, "drops": 0, "skips": 0}
        if snapshot:
            touched = {(k[0], k[1]) for k in snapshot}
            ev = self._evaluator()
            # a node over several parts merges into each part's pools
            for part in getattr(ev, "parts", () if ev is None else (ev,)):
                self._merge_into(part, touched, stats)
        if deferred:
            for lsn in deferred:
                self.api._oplog_applied(lsn)
            global_stats.timing("oplog_group_commit_records",
                                float(len(deferred)))
        # retire folded keys: a record() that landed mid-merge replaced
        # the key's value object, so the identity compare keeps it for
        # the next interval (its write IS newer than the gathered plane)
        with self._plock:
            for k, v in snapshot.items():
                if self._pending.get(k) is v:
                    del self._pending[k]
                    self._rows -= v[2]
                    self._bytes -= v[3]
            if not self._pending:
                self._rows = 0
                self._bytes = 0
            self.merges += 1
            self.merged_keys += len(snapshot)
            self.scatter_entries += stats["scatters"]
            self.overlay_entries += stats["overlays"]
            self.rebuilt_entries += stats["rebuilds"]
            self.dropped_entries += stats["drops"]
            self.skipped_entries += stats["skips"]
            self.group_commit_flushed += len(deferred)
            wall = time.perf_counter() - t0
            self.last_merge = {
                "wall_seconds": round(wall, 6),
                "at": time.time(),
                "entries": stats["entries"],
                "deltas": len(snapshot),
                "group_commit_records": len(deferred),
            }
        global_stats.timing("ingest_merge_seconds", wall)
        _flightrec.record(
            "ingest.merge", deltas=len(snapshot),
            entries=stats["entries"], scatters=stats["scatters"],
            overlays=stats["overlays"], rebuilds=stats["rebuilds"],
            drops=stats["drops"], group_commit=len(deferred),
            wall_seconds=round(wall, 6))

    def _merge_into(self, ev, touched, stats):
        """Fold pending deltas into every touched resident stack: plan +
        host gather + upload outside any lock, then ONE dispatch-lock
        window for every in-place copy, then swap entries in. Entries
        too drifted to patch drop (the next read rebuilds cold — a
        build, not a read-path patch); compressed containers take an
        overlay term or a full rebuild with the repr re-chosen."""
        import torch

        from ..core.fragment import (
            BSI_EXISTS_BIT,
            BSI_OFFSET_BIT,
            BSI_SIGN_BIT,
        )
        from ..core.view import VIEW_STANDARD
        from ..ops import containers as _containers

        holder = self.api.holder
        with ev._lock:
            items = list(ev._pools["leaf"].items()) \
                + list(ev._pools["rows"].items())
        copies = []
        for key, entry in items:
            if (key[1], key[2]) not in touched:
                continue
            kind = key[0]
            idx = holder.index(key[1])
            field = idx.field(key[2]) if idx is not None else None
            if field is None:
                if ev.merge_drop(key, entry):
                    stats["drops"] += 1
                continue
            if kind == "leaf":
                view_name, shards, rows = VIEW_STANDARD, key[4], [key[3]]
            elif kind == "rows":
                view_name, shards, rows = key[3], key[5], list(key[4])
            elif kind == "bsi":
                view_name = field.bsi_view_name()
                shards = key[4]
                rows = [BSI_EXISTS_BIT, BSI_SIGN_BIT] + [
                    BSI_OFFSET_BIT + i for i in range(key[3])]
            else:
                continue
            view = field.view(view_name)
            if view is None:
                if ev.merge_drop(key, entry):
                    stats["drops"] += 1
                continue
            gens = ev._fragment_gens(view, shards)
            old_gens = entry[0]
            if len(old_gens) != len(gens):
                if ev.merge_drop(key, entry):
                    stats["drops"] += 1
                continue
            if old_gens == gens:
                continue  # already current
            changed = [j for j, (o, n) in enumerate(zip(old_gens, gens))
                       if o != n]
            ent = entry[1]
            stats["entries"] += 1
            if (kind == "leaf" and isinstance(ent, _containers.Container)
                    and ent.kind != "dense"):
                self._merge_compressed(ev, key, entry, ent, gens, view,
                                       shards, changed, stats,
                                       _containers, VIEW_STANDARD)
                continue
            if len(changed) * 2 > len(shards):
                # past the patch cutoff a merge-time fold would re-upload
                # most of the stack anyway — drop and let demand rebuild
                if ev.merge_drop(key, entry):
                    stats["drops"] += 1
                continue
            changed_shards = [shards[j] for j in changed]
            block = ev._host_rows(view, rows, changed_shards, pad=False)
            copies.append((
                kind, key, entry, gens, view, changed_shards,
                tuple(gens[j] for j in changed),
                torch.tensor(changed, dtype=torch.long, device=ev.device),
                ev._place(block)))
        if not copies:
            return
        nbytes_in = sum(c[-1].numel() * 4 for c in copies)
        done = []
        with ev._locked_dispatch("ingest_merge", nbytes_in=nbytes_in,
                                 nbytes_out=nbytes_in) as ph:
            for (kind, key, entry, gens, view, changed_shards, want, cols,
                 block) in copies:
                if ev._fragment_gens(view, changed_shards) != want:
                    # a write landed after the gather: a read-path patch
                    # may already hold newer planes — leave the entry
                    # to the next interval
                    stats["skips"] += 1
                    continue
                ent = entry[1]
                if kind == "leaf":
                    stack = ent.arrays[0] \
                        if isinstance(ent, _containers.Container) else ent
                    stack.index_copy_(0, cols, block[0])
                else:  # [R, S, W] rows chunk or [D+2, S, W] BSI stack
                    ent.index_copy_(1, cols, block)
                done.append((key, entry, gens))
            ph.mark("dispatch_ack")
        for key, entry, gens in done:
            if ev.merge_swap(key, entry, gens, entry[1], entry[2]):
                stats["scatters"] += 1

    def _merge_compressed(self, ev, key, entry, ent, gens, view, shards,
                          changed, stats, _containers, view_standard):
        """Compressed leaf: park the drifted planes as an overlay term
        beside the sparse/rle base, or — past the overlay budget — do a
        full rebuild with the representation re-chosen from the measured
        density (the interval is where repr churn is allowed)."""
        over_budget = (
            ent.overlay + 1 > _containers.OVERLAY_MAX_TERMS
            or (_containers.overlay_rows(ent) + len(changed)
                > max(1, len(shards) // 2)))
        if over_budget:
            host = ev._host_rows(view, [key[3]], shards)
            cont = _containers.build(
                host[0], ev.device,
                fragment=(key[1], key[2], view_standard, key[3]))
            if ev.merge_swap(key, entry, gens, cont, cont.nbytes):
                stats["rebuilds"] += 1
            return
        block = ev._host_rows(view, [key[3]],
                              [shards[j] for j in changed], pad=False)
        cont = _containers.with_overlay(
            ent, ev.device, np.asarray(changed, np.int32), block[0])
        if ev.merge_swap(key, entry, gens, cont, cont.nbytes):
            stats["overlays"] += 1

    # -- observability / lifecycle -------------------------------------------

    def snapshot(self):
        """GET /debug/ingest payload."""
        with self._plock:
            per_field = {}
            for (index, field, _view, _shard), v in self._pending.items():
                e = per_field.setdefault(
                    f"{index}/{field}",
                    {"deltas": 0, "rows": 0, "bytes": 0})
                e["deltas"] += 1
                e["rows"] += v[2]
                e["bytes"] += v[3]
            last = dict(self.last_merge) if self.last_merge else None
            out = {
                "enabled": True,
                "interval_seconds": self.interval,
                "max_rows": self.max_rows,
                "max_bytes": self.max_bytes,
                "pending": {
                    "entries": len(self._pending),
                    "rows": self._rows,
                    "bytes": self._bytes,
                    "deferred_lsns": len(self._deferred),
                },
                "per_field": per_field,
                "merges": self.merges,
                "merged_keys": self.merged_keys,
                "scatter_entries": self.scatter_entries,
                "overlay_entries": self.overlay_entries,
                "rebuilt_entries": self.rebuilt_entries,
                "dropped_entries": self.dropped_entries,
                "skipped_entries": self.skipped_entries,
                "overflows": self.overflows,
                "merges_shed": self.merges_shed,
                "group_commit_flushed": self.group_commit_flushed,
                "last_merge": last,
            }
        if last is not None:
            out["last_merge"]["age_seconds"] = round(
                time.time() - last["at"], 3)
        return out

    def close(self):
        """Stop the merger and drain the tail (pending deltas fold,
        deferred watermarks flush). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
        self.flush()
        with _REGISTRY_LOCK:
            try:
                _REGISTRY.remove(self)
            except ValueError:
                pass
