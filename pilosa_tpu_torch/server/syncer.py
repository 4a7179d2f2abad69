"""Anti-entropy: replica repair (reference: holderSyncer holder.go:911,
fragmentSyncer fragment.go:2861).

Walks the local schema; for every fragment whose shard this node owns, it
compares per-100-row block checksums with the other replica owners, merges
differing blocks to majority consensus (ties count as set — reference:
mergeBlock fragment.go:1875, majorityN=(n+1)/2), applies the local delta
directly and pushes each remote's delta back via the import-roaring path.
Index/field attributes sync by block-checksum diff + bulk merge
(reference: syncIndex holder.go:975, syncField holder.go:1021).
"""

import logging
import threading

import numpy as np

from ..roaring import Bitmap, serialize
from ..shardwidth import SHARD_WIDTH

logger = logging.getLogger("pilosa_tpu_torch.syncer")


def merge_block(fragment, block_id, pair_sets):
    """Merge one hash block across replicas to majority consensus.

    pair_sets: list of (row_ids, column_ids) arrays from each REMOTE
    replica (column ids are shard-relative offsets, as block_data
    returns). The local fragment is replica 0. Applies the local delta
    in place; returns [(set_positions, clear_positions)] per remote.
    (reference: fragment.mergeBlock fragment.go:1875)
    """
    from ..core.fragment import HASH_BLOCK_SIZE

    lo = block_id * HASH_BLOCK_SIZE * SHARD_WIDTH
    hi = (block_id + 1) * HASH_BLOCK_SIZE * SHARD_WIDTH

    # Hold the fragment lock across read + local apply so a concurrent
    # import can't produce a torn snapshot of the block.
    with fragment._lock:
        local = fragment.storage.slice_range(lo, hi).astype(np.uint64)
        all_pos = [local]
        for rows, cols in pair_sets:
            rows = np.asarray(rows, dtype=np.uint64)
            cols = np.asarray(cols, dtype=np.uint64)
            pos = rows * np.uint64(SHARD_WIDTH) + cols
            pos = pos[(pos >= lo) & (pos < hi)]
            all_pos.append(np.unique(pos))

        majority = (len(all_pos) + 1) // 2
        if len(all_pos) > 1:
            uniq, counts = np.unique(
                np.concatenate(all_pos), return_counts=True)
            consensus = uniq[counts >= majority]
        else:
            consensus = local

        deltas = []
        for pos in all_pos:
            sets = np.setdiff1d(consensus, pos, assume_unique=True)
            clears = np.setdiff1d(pos, consensus, assume_unique=True)
            deltas.append((sets, clears))

        local_sets, local_clears = deltas[0]
        if len(local_sets) or len(local_clears):
            fragment.import_positions(local_sets, local_clears)
    return deltas[1:]


def _positions_to_roaring(positions):
    bm = Bitmap()
    bm.add_many(np.asarray(positions, dtype=np.uint64))
    return serialize(bm)


class FragmentSyncer:
    """Sync one fragment with its replica owners (reference:
    fragmentSyncer fragment.go:2832)."""

    def __init__(self, fragment, index_name, cluster, client_factory,
                 is_closing=None):
        self.fragment = fragment
        self.index_name = index_name
        self.cluster = cluster
        self.client_factory = client_factory
        self.is_closing = is_closing or (lambda: False)

    def _peers(self):
        nodes = self.cluster.shard_nodes(self.index_name, self.fragment.shard)
        return [n for n in nodes if n.id != self.cluster.local_id]

    def sync_fragment(self):
        """Block-checksum diff, then per-block merge (reference:
        syncFragment fragment.go:2861)."""
        from .client import ClientError

        peers = self._peers()
        if not peers:
            return 0
        f = self.fragment
        local_blocks = dict(f.blocks())  # id -> checksum bytes
        peer_blocks = []
        for node in peers:
            if self.is_closing():
                return 0
            try:
                resp = self.client_factory(node.uri).fragment_blocks(
                    self.index_name, f.field, f.view, f.shard)
                blocks = {b["id"]: bytes.fromhex(b["checksum"])
                          for b in resp.get("blocks", [])}
            except ClientError as e:
                if e.status != 404:
                    # unreachable peer: abort rather than treat it as empty
                    # (reference: syncFragment returns on any error except
                    # ErrFragmentNotFound fragment.go:2883)
                    logger.warning("abort sync of %s/%s/%s/%s: %s",
                                   self.index_name, f.field, f.view,
                                   f.shard, e)
                    return 0
                # 404: fragment genuinely absent on the replica -> empty
                blocks = {}
            except Exception as e:
                logger.warning("abort sync of %s/%s/%s/%s: %s",
                               self.index_name, f.field, f.view, f.shard, e)
                return 0
            peer_blocks.append(blocks)

        block_ids = set(local_blocks)
        for blocks in peer_blocks:
            block_ids.update(blocks)
        synced = 0
        for bid in sorted(block_ids):
            if self.is_closing():
                break
            chks = [local_blocks.get(bid)] + [b.get(bid) for b in peer_blocks]
            if len({c for c in chks}) <= 1:
                continue  # all replicas agree (including all-missing)
            self.sync_block(bid)
            synced += 1
        return synced

    def sync_block(self, block_id):
        """Fetch the block from every peer, merge to consensus, push each
        peer's delta back via import-roaring (reference: syncBlock
        fragment.go:2941)."""
        from .client import ClientError

        f = self.fragment
        peers = self._peers()
        pair_sets = []
        for node in peers:
            try:
                resp = self.client_factory(node.uri).fragment_block_data(
                    self.index_name, f.field, f.view, f.shard, block_id)
                pair_sets.append((resp.get("rowIDs", []),
                                  resp.get("columnIDs", [])))
            except ClientError as e:
                if e.status != 404:
                    # A fetch failure must NOT count as an empty replica:
                    # with RF>=3 that would vote to clear live bits
                    # (reference: syncBlock aborts on error fragment.go:2966).
                    logger.warning("abort block %d sync: %s", block_id, e)
                    return
                pair_sets.append(([], []))
            except Exception as e:
                logger.warning("abort block %d sync: %s", block_id, e)
                return

        deltas = merge_block(f, block_id, pair_sets)

        for node, (sets, clears) in zip(peers, deltas):
            client = self.client_factory(node.uri)
            try:
                if len(sets):
                    client.import_roaring(
                        self.index_name, f.field, f.shard,
                        _positions_to_roaring(sets), view=f.view, remote=True)
                if len(clears):
                    client.import_roaring(
                        self.index_name, f.field, f.shard,
                        _positions_to_roaring(clears), clear=True,
                        view=f.view, remote=True)
            except Exception:
                logger.exception("pushing block %d delta to %s",
                                 block_id, node.id)


class HolderSyncer:
    """Synchronize all local data with the cluster (reference:
    holderSyncer holder.go:888)."""

    def __init__(self, holder, cluster, client_factory, is_closing=None):
        self.holder = holder
        self.cluster = cluster
        self.client_factory = client_factory
        self.is_closing = is_closing or (lambda: False)
        self._lock = threading.Lock()

    def sync_holder(self):
        """(reference: SyncHolder holder.go:911) Returns fragments synced."""
        with self._lock:
            total = 0
            for iname in sorted(self.holder.indexes):
                if self.is_closing():
                    return total
                idx = self.holder.indexes[iname]
                self._sync_attrs(idx.column_attr_store, iname)
                shards = idx.available_shards()
                for fname in sorted(idx.fields):
                    if self.is_closing():
                        return total
                    field = idx.fields[fname]
                    self._sync_attrs(field.row_attr_store, iname, fname)
                    for view in list(field.views.values()):
                        for shard in shards:
                            if self.is_closing():
                                return total
                            if not self.cluster.owns_shard(
                                    self.cluster.local_id, iname, shard):
                                continue
                            frag = view.fragment(shard)
                            if frag is None:
                                continue
                            total += FragmentSyncer(
                                frag, iname, self.cluster,
                                self.client_factory,
                                self.is_closing).sync_fragment()
            return total

    def _sync_attrs(self, store, index_name, field_name=""):
        """Block-diff attr merge with every peer (reference: syncIndex
        holder.go:975 / syncField holder.go:1021). One POST of our block
        checksums per peer; the peer answers with attrs from every block
        that differs (the reference's attr/diff protocol, handler.go:
        312,315) — one round trip instead of blocks + N block fetches.
        Peers without the diff route fall back to the pull protocol."""
        from .client import ClientError

        if store is None:
            return
        blocks = [{"id": bid, "checksum": chk}
                  for bid, chk in store.blocks()]
        for node in self.cluster.peers():
            if self.is_closing():
                return
            client = self.client_factory(node.uri)
            try:
                data = client.attr_diff(index_name, blocks,
                                        field=field_name)
            except ClientError as e:
                if e.status not in (404, 405):
                    continue  # peer refused; don't retry another way
                # route absent on the peer: pull protocol
                data = self._pull_attr_diff(
                    client, index_name, field_name,
                    {b["id"]: b["checksum"] for b in blocks})
                if data is None:
                    continue
            except Exception:
                continue  # unreachable peer: a second request would
                #           just wait out another timeout
            merged = {int(id_str): attrs for id_str, attrs
                      in data.get("attrs", {}).items()}
            if merged:
                store.set_bulk_attrs(merged)
                blocks = [{"id": bid, "checksum": chk}
                          for bid, chk in store.blocks()]

    @staticmethod
    def _pull_attr_diff(client, index_name, field_name, local):
        """Fallback pull protocol: peer's block list, then each
        differing block's data."""
        try:
            resp = client.attr_blocks(index_name, field_name)
        except Exception:
            return None
        remote = {b["id"]: b["checksum"] for b in resp.get("blocks", [])}
        attrs = {}
        for bid in sorted(bid for bid, chk in remote.items()
                          if local.get(bid) != chk):
            try:
                data = client.attr_block_data(index_name, field_name, bid)
            except Exception:
                continue
            attrs.update(data.get("attrs", {}))
        return {"attrs": attrs}


class AntiEntropyMonitor:
    """Periodic anti-entropy loop (reference: monitorAntiEntropy
    server.go:514). Suspended while the cluster is resizing."""

    def __init__(self, syncer, interval=600.0):
        self.syncer = syncer
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        # stop() must be able to interrupt an in-flight pass
        syncer.is_closing = self._stop.is_set

    def start(self):
        if self.interval <= 0:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="anti-entropy", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                if self.syncer.cluster.state == "RESIZING":
                    continue  # reference: abort anti-entropy cluster.go:269
                self.syncer.sync_holder()
            except Exception:
                logger.exception("anti-entropy pass failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
