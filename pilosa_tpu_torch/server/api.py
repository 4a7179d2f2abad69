"""API facade (reference: api.go): between the HTTP transport and the
holder/executor. Single node; wire shapes follow the TPU package's."""

from ..core import FieldOptions
from ..core.field import (
    FIELD_TYPE_BOOL,
    FIELD_TYPE_INT,
    FIELD_TYPE_MUTEX,
    FIELD_TYPE_SET,
    FIELD_TYPE_TIME,
)
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


class API:
    """Holds the holder and the port's Executor on `device`."""

    def __init__(self, holder, device=None):
        self.holder = holder
        self.executor = Executor(holder, device=device)

    @property
    def device(self):
        return self.executor.device

    def query(self, index_name, pql, shards=None, options=None):
        """(reference: api.Query api.go:135)"""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            query = parse(pql) if isinstance(pql, str) else pql
            return self.executor.execute(
                index_name, query, shards=shards,
                options=options or ExecOptions())
        except ApiError:
            raise
        except Exception as e:
            raise ApiError(str(e)) from e

    def create_index(self, name, options=None):
        from ..core.holder import HolderError
        from ..core.index import IndexError_

        try:
            return self.holder.create_index(name, options=options)
        except HolderError as e:
            raise ConflictError(str(e)) from e
        except IndexError_ as e:
            raise ApiError(str(e)) from e

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

    def _field(self, index_name, field_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        field = idx.field(field_name)
        if field is None:
            raise NotFoundError(f"field not found: {field_name}")
        return field

    def import_bits(self, index_name, field_name, row_ids, column_ids,
                    timestamps=None, clear=False):
        """(reference: api.Import api.go:920, single node)"""
        field = self._field(index_name, field_name)
        changed = field.import_bits(
            row_ids, column_ids, timestamps=timestamps, clear=clear)
        if not clear:
            self.holder.index(index_name).add_existence(column_ids)
        return changed

    def import_values(self, index_name, field_name, column_ids, values,
                      clear=False):
        """Bulk BSI values (reference: api.ImportValue api.go:1035, single
        node). clear=True removes the listed columns' values."""
        field = self._field(index_name, field_name)
        changed = field.import_values(column_ids, values, clear=clear)
        if not clear:
            self.holder.index(index_name).add_existence(column_ids)
        return changed

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

