"""Translate-store replication: primary -> replica key streaming.

Reference: holder.go:702-880 (holderTranslateStoreReplicator) with
cluster.go:2019's notion of a single writable node. The FIRST node in
sorted order is the writable primary; every other node marks its stores
read-only and continually pulls new entries from the primary. Creates on
a replica forward to the primary via the store's remote_create hook and
are mirrored locally for read-your-writes (reference:
ErrTranslateStoreReadOnly redirect http/handler.go:518-522).

Unlike the reference's predecessor chain, replicas pull from the primary
directly: mirrored forward-writes can land out of ID order on a replica,
so an intermediate chain hop could permanently skip entries; the
primary's feed is strictly monotonic, which makes advance-to-max-pulled
offsets safe. Offsets are replicator-internal (NOT the store's max_id —
mirrored writes leave holes below it) and reset on restart, so a restart
re-pulls the feed once; force_set is idempotent.
"""

import logging
import threading

logger = logging.getLogger("pilosa_tpu_torch.translate")


class TranslateReplicator:
    def __init__(self, holder, cluster, client_factory, interval=1.0):
        self.holder = holder
        self.cluster = cluster
        self.client_factory = client_factory
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        self._offsets = {}  # (index, field) -> last replicated id
        # install on the holder so stores created later are configured
        # at birth (no writable window on replicas)
        holder.translate_configurer = self.configure_store
        for store in holder.translate_stores():
            self.configure_store(store)

    # -- topology ------------------------------------------------------------

    def primary(self):
        """The coordinator is the writable translate primary: it is
        STABLE across joins (a joining node never becomes coordinator
        automatically), its removal is forbidden, and transfer is an
        explicit admin action — so the primary can't silently move to a
        node with an empty key store (which would let fresh allocations
        overwrite existing id->key mappings on replicas)."""
        return self.cluster.coordinator

    def is_replica(self):
        p = self.primary()
        return p is not None and p.id != self.cluster.local_id

    # -- store wiring --------------------------------------------------------

    def configure_store(self, store):
        store.set_read_only(self.is_replica())
        store.remote_create = self._remote_create_fn(store)

    def _remote_create_fn(self, store):
        def create(keys):
            primary = self.primary()
            if primary is None or primary.id == self.cluster.local_id:
                raise RuntimeError(
                    "read-only translate store with no primary to forward to")
            client = self.client_factory(primary.uri)
            resp = client.translate_keys_create(
                store.index, store.field, keys)
            return resp["ids"]
        return create

    def refresh(self):
        """Re-evaluate the chain after a topology change (resize)."""
        for store in self.holder.translate_stores():
            self.configure_store(store)

    # -- replication loop ----------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="translate-replicator", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.refresh()
                self.replicate_once()
            except Exception:
                logger.exception("translate replication pass failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.holder.translate_configurer is self.configure_store:
            self.holder.translate_configurer = None

    def replicate_once(self):
        """Pull new entries for every store from the primary and apply
        them via force_set (reference: replicate() holder.go:837-880).
        Returns entries applied."""
        from .client import ClientError

        if not self.is_replica():
            return 0
        client = self.client_factory(self.primary().uri)
        applied = 0
        for store in self.holder.translate_stores():
            key = (store.index, store.field)
            offset = self._offsets.get(key, 0)
            try:
                resp = client.translate_entries(
                    store.index, store.field, offset=offset)
            except ClientError as e:
                if e.status != 404:  # 404: primary lacks the index yet
                    logger.warning("translate pull %s/%s from primary "
                                   "failed: %s", store.index, store.field, e)
                continue
            except Exception as e:
                logger.warning("translate pull %s/%s from primary "
                               "failed: %s", store.index, store.field, e)
                continue
            for d in resp.get("entries", []):
                old = store.translate_ids([d["id"]])[0]
                if old is not None and old != d["key"]:
                    # should be impossible with a stable primary; scream
                    logger.error(
                        "translate divergence %s/%s id=%d: %r -> %r",
                        store.index, store.field, d["id"], old, d["key"])
                store.force_set(d["id"], d["key"])
                offset = max(offset, d["id"])
                applied += 1
            self._offsets[key] = offset
        return applied
