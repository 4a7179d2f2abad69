"""API facade (reference: api.go): between the HTTP transport and the
holder/executor. Single node; wire shapes follow the TPU package's.
Index and field DDL (create, delete, apply a schema), bit, value and
roaring imports (with row and column keys), CSV export, cache
recalculation and the column attribute sets of a query's Row results.

With a coalesce window (`API(coalesce_window=...)`, `server
--coalesce-window`), concurrent batchable queries fuse into batched
launches through the QueryCoalescer; window 0, the default, builds none
and every query takes the per-query path."""

import csv
import io
import random
import threading

from ..core import FieldOptions
from ..core.field import (
    FIELD_TYPE_BOOL,
    FIELD_TYPE_INT,
    FIELD_TYPE_MUTEX,
    FIELD_TYPE_SET,
    FIELD_TYPE_TIME,
)
from ..core.index import IndexOptions
from ..exec import ExecOptions, Executor
from ..pql import parse
from ..shardwidth import SHARD_WIDTH
from .. import __version__


class ApiError(Exception):
    status = 400
    #: optional extra response headers ({name: value})
    headers = None


class NotFoundError(ApiError):
    status = 404


class ConflictError(ApiError):
    status = 409


class ServiceUnavailableError(ApiError):
    """503: the node cannot serve right now. Carries Retry-After so
    clients back off."""
    status = 503

    def __init__(self, message, retry_after=None):
        super().__init__(message)
        if retry_after is not None:
            self.headers = {
                "Retry-After": str(max(1, int(round(retry_after))))}


def shed_reject(site, message, retry_after):
    """THE 503 rejection path of a load-shedding site: one jitter rule
    (x1.0-1.25, so synchronized client retries decorrelate) and the
    `X-Pilosa-Shed` header naming the site, which tells a shedding node
    from a dead one."""
    ra = max(1.0, float(retry_after)) * random.uniform(1.0, 1.25)
    err = ServiceUnavailableError(message, retry_after=ra)
    err.headers["X-Pilosa-Shed"] = site
    raise err


def field_options_from_json(opts):
    """FieldOptions from the reference's JSON field-options wire shape
    (reference: http/handler.go:870 + FieldOptions.MarshalJSON
    field.go:1471)."""
    opts = opts or {}
    typ = opts.get("type", FIELD_TYPE_SET)
    if typ == FIELD_TYPE_INT:
        return FieldOptions.int_field(
            min=int(opts.get("min", -(1 << 31))),
            max=int(opts.get("max", (1 << 31) - 1)))
    if typ == FIELD_TYPE_TIME:
        return FieldOptions.time_field(
            opts.get("timeQuantum", ""),
            no_standard_view=bool(opts.get("noStandardView", False)),
            keys=bool(opts.get("keys", False)))
    if typ == FIELD_TYPE_MUTEX:
        return FieldOptions.mutex_field(
            cache_type=opts.get("cacheType", "ranked"),
            cache_size=int(opts.get("cacheSize", 50000)),
            keys=bool(opts.get("keys", False)))
    if typ == FIELD_TYPE_BOOL:
        return FieldOptions.bool_field()
    if typ != FIELD_TYPE_SET:
        raise ApiError(f"invalid field type: {typ}")
    return FieldOptions(
        cache_type=opts.get("cacheType", "ranked"),
        cache_size=int(opts.get("cacheSize", 50000)),
        keys=bool(opts.get("keys", False)))


def field_options_to_json(o):
    out = {"type": o.type, "keys": o.keys}
    if o.type == FIELD_TYPE_INT:
        out.update({"min": o.min, "max": o.max, "base": o.base,
                    "bitDepth": o.bit_depth})
    elif o.type == FIELD_TYPE_TIME:
        out.update({"timeQuantum": o.time_quantum,
                    "noStandardView": o.no_standard_view})
    else:
        out.update({"cacheType": o.cache_type, "cacheSize": o.cache_size})
    return out


def result_to_json(result):
    """One executor result in the reference's QueryResponse JSON shape
    (reference: QueryResponse.MarshalJSON handler.go:61)."""
    from ..core.row import Row
    from ..exec.result import GroupCount, Pair, RowIdentifiers, ValCount

    if isinstance(result, Row):
        out = {"attrs": result.attrs or {},
               "columns": [int(c) for c in result.columns()]}
        if result.keys is not None:
            out["keys"] = result.keys
        return out
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, (ValCount, Pair, RowIdentifiers, GroupCount)):
        return result.to_json()
    if result is None or isinstance(result, (bool, int, float, str, dict)):
        return result
    raise ApiError(f"unencodable result type {type(result)!r}")


class QueryCoalescer:
    """Folds concurrent batchable queries into batched launches
    (exec/stacked.launch_query_batch), so the per-query launch and fetch
    are paid once per batch instead of once per query.

    Lifecycle: HTTP handler threads submit() parsed single-call queries
    and block on a per-query event; one lazily started daemon drain
    thread owns the pipeline. On an idle→busy transition it holds the
    batch open for `window` seconds so batchmates arriving within the
    window fuse; while the pipeline is busy the launch+resolve of the
    previous batch IS the accumulation window (no extra sleep). The loop
    is double-buffered: batch N+1 is launched (Executor.launch_batch)
    BEFORE batch N's results are waited for (resolve_batch), so batch
    N's copy to the host overlaps batch N+1's launch.

    Overload: a queue past `max_queue` rejects with 503 + Retry-After —
    never an unbounded wait."""

    def __init__(self, api, window, max_queue=256):
        self.api = api
        self.window = float(window)
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._queue = []  # member dicts, FIFO
        self._thread = None
        self._closed = False
        # GET /debug/batching
        self.batches = 0            # batched launches issued
        self.coalesced = 0          # queries that rode one
        self.rejected = 0           # overload 503s
        self.max_occupancy = 0      # largest single batch seen
        self.batch_hist = {}        # occupancy -> count

    def submit(self, index_name, query):
        """Enqueue one parsed batchable query and wait for its slot of the
        batched result. Returns (results, batch_size); re-raises the
        member's own error (a batchmate's failure is not ours)."""
        m = {"index": index_name, "query": query, "event": threading.Event(),
             "results": None, "error": None, "batch": 0}
        with self._cond:
            if self._closed:
                raise ServiceUnavailableError(
                    "query coalescer shut down", retry_after=1)
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                shed_reject(
                    "coalesce",
                    f"coalesce queue full ({self.max_queue}); shed load "
                    "or raise --coalesce-max-queue", 1)
            self._queue.append(m)
            if self._thread is None:
                self._start_thread_locked()
            self._cond.notify()
        # Bounded waits + a liveness check: the drain loop delivers every
        # member's event even on internal errors (its whole body is
        # exception-guarded), but if the thread is ever lost anyway, fail
        # this handler fast instead of blocking it forever, and leave the
        # coalescer usable for the next submit.
        while not m["event"].wait(0.5):
            with self._cond:
                t = self._thread
                if t is not None and t.is_alive():
                    continue
                if m in self._queue:
                    self._queue.remove(m)
                self._thread = None
                if self._queue and not self._closed:
                    self._start_thread_locked()
            if not m["event"].is_set():
                m["error"] = ServiceUnavailableError(
                    "coalescer drain thread died; retry", retry_after=1)
            break
        if m["error"] is not None:
            raise m["error"]
        return m["results"], m["batch"]

    def _start_thread_locked(self):
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="query-coalescer")
        self._thread.start()

    def close(self):
        """Shut down the pipeline: wake the drain thread, deliver
        in-flight batches, fail queued members with 503 so blocked
        handler threads return instead of hanging past server shutdown,
        and refuse new submits. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            t = self._thread
            self._cond.notify_all()
        if t is not None and t.is_alive():
            t.join(timeout=5)
        # no drain thread (never started, or already dead): fail the
        # leftovers here; otherwise the loop's shutdown path did it
        self._fail(self._pop_members(), ServiceUnavailableError(
            "query coalescer shut down", retry_after=1))

    @staticmethod
    def _fail(members, exc):
        for m in members:
            if not m["event"].is_set():
                m["error"] = exc
                m["event"].set()

    def stats(self):
        with self._cond:
            return {
                "enabled": True,
                "window_seconds": self.window,
                "max_queue": self.max_queue,
                "queue_depth": len(self._queue),
                "batches": self.batches,
                "coalesced_queries": self.coalesced,
                "rejected": self.rejected,
                "max_occupancy": self.max_occupancy,
                "occupancy_hist": dict(sorted(self.batch_hist.items())),
            }

    def _pop_members(self):
        """Drain everything queued right now (caller holds no lock)."""
        with self._cond:
            members, self._queue = self._queue, []
            return members

    def _drain_loop(self):
        ex = self.api.batch_executor()
        pending = []  # [(handle, state, members)] launched, unresolved
        while True:
            with self._cond:
                while not self._queue and not pending \
                        and not self._closed:
                    self._cond.wait()
                if self._closed:
                    break
            # Everything below is exception-guarded: an error ANYWHERE in
            # the iteration (grouping, counters — not just the
            # launch/resolve calls, which guard themselves) is delivered
            # to every affected member and the loop keeps serving. An
            # unguarded escape would kill the singleton thread and wedge
            # every future submit.
            members = []
            launched = []
            try:
                was_idle = not pending
                members = self._pop_members()
                if members and was_idle and self.window > 0:
                    # idle→busy: hold the window open so concurrent
                    # arrivals fuse into this batch; close() cuts the
                    # wait short
                    with self._cond:
                        self._cond.wait_for(lambda: self._closed,
                                            timeout=self.window)
                    members += self._pop_members()
                for index_name, group in self._group(members).items():
                    try:
                        handle, state = ex.launch_batch(
                            index_name, [m["query"] for m in group])
                    except Exception as exc:  # noqa: BLE001 — deliver
                        self._fail(group, exc)
                        continue
                    with self._cond:
                        self.batches += 1
                        self.coalesced += len(group)
                        n = len(group)
                        self.max_occupancy = max(self.max_occupancy, n)
                        self.batch_hist[n] = self.batch_hist.get(n, 0) + 1
                    launched.append((handle, state, group))
                # double buffer: batch N+1 is in flight; NOW resolve N
                for handle, state, group in pending:
                    self._resolve(ex, handle, state, group)
                pending = launched
            except Exception as exc:  # noqa: BLE001 — deliver, don't die
                self._fail(members, exc)
                for _, _, group in pending + launched:
                    self._fail(group, exc)
                pending = []
        # closed: deliver in-flight batches (already launched — the
        # results are real), then fail whatever is still queued
        for handle, state, group in pending:
            self._resolve(ex, handle, state, group)
        self._fail(self._pop_members(), ServiceUnavailableError(
            "query coalescer shut down", retry_after=1))

    @staticmethod
    def _group(members):
        by_index = {}
        for m in members:
            by_index.setdefault(m["index"], []).append(m)
        return by_index

    @staticmethod
    def _resolve(ex, handle, state, group):
        try:
            outs = ex.resolve_batch(handle, state)
        except Exception as exc:  # noqa: BLE001 — deliver, don't die
            for m in group:
                m["error"] = exc
                m["event"].set()
            return
        for m, (results, error, bsize) in zip(group, outs):
            m["results"] = results
            m["error"] = error
            m["batch"] = bsize
            m["event"].set()


class API:
    """Holds the holder and the port's Executor on `device`, and the
    query coalescer when `coalesce_window` > 0."""

    def __init__(self, holder, device=None, coalesce_window=0.0,
                 coalesce_max_queue=256):
        self.holder = holder
        self.executor = Executor(holder, device=device)
        # window 0 — the default — builds no coalescer: every query takes
        # the per-query path
        self.coalesce_window = float(coalesce_window or 0.0)
        self.coalesce_max_queue = int(coalesce_max_queue)
        self._coalescer = None
        if self.coalesce_window > 0:
            self._coalescer = QueryCoalescer(
                self, self.coalesce_window, self.coalesce_max_queue)

    @property
    def device(self):
        return self.executor.device

    def batch_executor(self):
        """The executor the coalescer drains into."""
        return self.executor

    def query(self, index_name, pql, shards=None, options=None):
        """(reference: api.Query api.go:135)"""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        # coalescer routing: batchable single-call reads with default
        # options fuse with concurrent arrivals into one batched launch;
        # ineligible queries (and window 0) take the per-query path
        if self._coalescer is not None:
            routed = self._try_coalesce(index_name, pql, shards, options)
            if routed is not None:
                return routed[0]
        try:
            query = parse(pql) if isinstance(pql, str) else pql
            return self.executor.execute(
                index_name, query, shards=shards,
                options=options or ExecOptions())
        except ApiError:
            raise
        except Exception as e:
            raise ApiError(str(e)) from e

    def _try_coalesce(self, index_name, pql, shards, options):
        """Route one query through the coalescer when eligible. Returns a
        1-tuple (results,) on the coalesced path, or None to fall through
        to the per-query path (an ineligible query — or a parse error,
        which the per-query path re-raises as an ApiError)."""
        if shards is not None or not isinstance(pql, str):
            return None
        o = options
        if o is not None and (o.remote or o.exclude_columns
                              or o.exclude_row_attrs):
            return None
        try:
            query = parse(pql)
        except Exception:  # noqa: BLE001 — the per-query path reports it
            return None
        call = query.calls[0] if len(query.calls) == 1 else None
        if call is None or call.writes() \
                or call.name not in self.executor.BATCHABLE_CALLS:
            return None
        try:
            results, _ = self._coalescer.submit(index_name, query)
        except ApiError:
            raise
        except Exception as e:
            raise ApiError(str(e)) from e
        return (results,)

    def query_batch(self, index_name, pqls, shards=None):
        """Execute a list of PQL queries as batched launches (the POST
        /index/{i}/query-batch route, the coalescer's executor path).
        Returns (results, error, batch_size) per query in request order —
        per-query error isolation, like the coalescer's."""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        return self.executor.execute_batch(
            index_name, list(pqls), shards=shards)

    def batching_stats(self):
        """GET /debug/batching: the coalescer's occupancy and queue stats
        plus the batched-launch counters of the stacked evaluator."""
        if self._coalescer is not None:
            co = self._coalescer.stats()
        else:
            co = {"enabled": False,
                  "window_seconds": self.coalesce_window,
                  "max_queue": self.coalesce_max_queue}
        st = self.executor.stacked_stats()
        return {
            "coalescer": co,
            "batch_dispatches": st["batch_dispatches"],
            "batched_queries": st["batched_queries"],
            "count_batches": st["count_batches"],
            "count_batched_queries": st["count_batched_queries"],
        }

    def close(self):
        """Stop the query coalescer: its blocked waiters get a 503
        instead of hanging on a daemon thread that dies with the process.
        Idempotent; a deployment without a coalescer no-ops."""
        if self._coalescer is not None:
            self._coalescer.close()

    def create_index(self, name, options=None):
        from ..core.holder import HolderError
        from ..core.index import IndexError_

        try:
            return self.holder.create_index(name, options=options)
        except HolderError as e:
            raise ConflictError(str(e)) from e
        except IndexError_ as e:
            raise ApiError(str(e)) from e

    def delete_index(self, name):
        """(reference: api.DeleteIndex, single node). Device stacks of the
        deleted index stay in their pools until evicted; a re-created
        index never reads them, as its fragments' uids differ."""
        from ..core.holder import HolderError

        try:
            self.holder.delete_index(name)
        except HolderError as e:
            raise NotFoundError(str(e)) from e

    def create_field(self, index_name, field_name, options=None):
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            return idx.create_field(field_name, options=options)
        except IndexError_ as e:
            if "already exists" in str(e):
                raise ConflictError(str(e)) from e
            raise ApiError(str(e)) from e

    def delete_field(self, index_name, field_name):
        """(reference: api.DeleteField, single node)"""
        from ..core.index import IndexError_

        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            idx.delete_field(field_name)
        except IndexError_ as e:
            raise NotFoundError(str(e)) from e

    def apply_schema(self, schema):
        """Create every index and field of a schema in the camelCase wire
        shape that are missing (reference: handlePostSchema)."""
        for idx_desc in schema.get("indexes", []):
            opts = idx_desc.get("options", {})
            idx = self.holder.create_index(
                idx_desc["name"],
                options=IndexOptions(
                    keys=bool(opts.get("keys", False)),
                    track_existence=bool(opts.get("trackExistence", True))),
                if_not_exists=True)
            for f_desc in idx_desc.get("fields", []):
                idx.create_field(
                    f_desc["name"],
                    options=field_options_from_json(f_desc.get("options")),
                    if_not_exists=True)

    def _field(self, index_name, field_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        field = idx.field(field_name)
        if field is None:
            raise NotFoundError(f"field not found: {field_name}")
        return field

    def _translate_import_keys(self, index_name, field_name,
                               row_keys, column_keys):
        """String keys -> ids for a bulk import (reference: api.Import key
        translation api.go:920-1000). Returns (row_ids, column_ids) for
        whichever key lists were given. Both options are checked before
        either list translates: translation allocates ids for good, so a
        rejected import must leave no new keys behind."""
        idx = self.holder.index(index_name)
        field = idx.field(field_name)
        if column_keys is not None and not idx.options.keys:
            raise ApiError(f"index {index_name} does not use column keys")
        if row_keys is not None and not field.options.keys:
            raise ApiError(f"field {field_name} does not use row keys")
        row_ids = column_ids = None
        if column_keys is not None:
            column_ids = list(
                idx.translate_store.translate_keys(column_keys))
        if row_keys is not None:
            row_ids = list(field.translate_store.translate_keys(row_keys))
        return row_ids, column_ids

    def import_bits(self, index_name, field_name, row_ids, column_ids,
                    timestamps=None, clear=False, row_keys=None,
                    column_keys=None):
        """(reference: api.Import api.go:920, single node; string keys
        translate to ids first)"""
        field = self._field(index_name, field_name)
        if row_keys is not None or column_keys is not None:
            t_rows, t_cols = self._translate_import_keys(
                index_name, field_name, row_keys, column_keys)
            if t_rows is not None:
                row_ids = t_rows
            if t_cols is not None:
                column_ids = t_cols
        changed = field.import_bits(
            row_ids, column_ids, timestamps=timestamps, clear=clear)
        if not clear:
            self.holder.index(index_name).add_existence(column_ids)
        return changed

    def import_values(self, index_name, field_name, column_ids, values,
                      clear=False, column_keys=None):
        """Bulk BSI values (reference: api.ImportValue api.go:1035, single
        node). clear=True removes the listed columns' values."""
        field = self._field(index_name, field_name)
        if column_keys is not None:
            _, column_ids = self._translate_import_keys(
                index_name, field_name, None, column_keys)
        changed = field.import_values(column_ids, values, clear=clear)
        if not clear:
            self.holder.index(index_name).add_existence(column_ids)
        return changed

    def import_roaring(self, index_name, field_name, shard, data,
                       clear=False, view="standard"):
        """Merge a serialized roaring blob of row * SHARD_WIDTH + offset
        positions into one shard of one view (reference: api.ImportRoaring
        api.go:368, single node). Returns the number of bits changed."""
        field = self._field(index_name, field_name)
        v = field.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(int(shard))
        return frag.import_roaring(data, clear=clear)

    def export_csv(self, index_name, field_name, shard):
        """(reference: api.ExportCSV api.go:500) row,col lines for one
        shard of the standard view, ids translated back to keys on keyed
        fields and indexes (api.go:538-557), so an export re-imports
        losslessly."""
        idx = self.holder.index(index_name)
        field = self._field(index_name, field_name)
        view = field.view()
        frag = view.fragment(int(shard)) if view else None
        buf = io.StringIO()
        writer = csv.writer(buf)
        if frag is None:
            return buf.getvalue()

        def batch_translate(store, ids, what):
            """Batched id->key that fails loudly: a silently empty cell
            would break the export->import round trip."""
            out = {}
            for id_, key in zip(ids, store.translate_ids(ids)):
                if key is None:
                    raise ApiError(
                        f"translating {what} id {id_} failed: key not "
                        "found")
                out[id_] = key
            return out

        row_ids = frag.row_ids()
        row_out = {r: r for r in row_ids}
        if field.options.keys:
            row_out = batch_translate(field.translate_store, row_ids, "row")
        col_memo = {}
        for row_id in row_ids:
            cols = [int(c) for c in frag.row_columns(row_id)]
            if idx.options.keys:
                missing = [c for c in cols if c not in col_memo]
                if missing:
                    col_memo.update(batch_translate(
                        idx.translate_store, missing, "column"))
                for col in cols:
                    writer.writerow([row_out[row_id], col_memo[col]])
            else:
                for col in cols:
                    writer.writerow([row_out[row_id], col])
        return buf.getvalue()

    def recalculate_caches(self):
        """(reference: api.RecalculateCaches) rebuild every fragment's
        TopN rank cache."""
        self.holder.recalculate_caches()

    def column_attr_sets(self, index_name, results):
        """{"id", "attrs"} of every column of the Row results that has
        attributes, in column order (reference: QueryResponse
        ColumnAttrSets, filled when a query asks for columnAttrs)."""
        from ..core.row import Row

        idx = self.holder.index(index_name)
        if idx is None or idx.column_attr_store is None:
            return []
        cols = set()
        for r in results:
            if isinstance(r, Row):
                cols.update(int(c) for c in r.columns())
        out = []
        for c in sorted(cols):
            attrs = idx.column_attr_store.attrs(c)
            if attrs:
                out.append({"id": c, "attrs": attrs})
        return out

    def schema(self):
        """Public schema in the reference's camelCase wire shape."""
        out = []
        for iname in sorted(self.holder.indexes):
            idx = self.holder.indexes[iname]
            fields = []
            for fname in sorted(idx.public_fields()):
                f = idx.fields[fname]
                fields.append({
                    "name": fname,
                    "options": field_options_to_json(f.options),
                    "shards": f.available_shards(),
                })
            out.append({
                "name": iname,
                "options": {"keys": idx.options.keys,
                            "trackExistence": idx.options.track_existence},
                "fields": fields,
            })
        return {"indexes": out}

    def info(self):
        return {"shardWidth": SHARD_WIDTH, "version": __version__}

    def status(self):
        nodes = [{"id": "local", "uri": {"scheme": "http"},
                  "isCoordinator": True, "state": "READY"}]
        return {"state": "NORMAL", "nodes": nodes, "replicaN": 1,
                "localShardWidth": SHARD_WIDTH}

