"""Placement hashing.

Reference: cluster.go:871-960 — FNV-1a over (index, shard-BE8) mod 256
partitions, then Lamping/Veach jump consistent hashing to pick the primary
node for a partition. ModHasher is the deterministic test stand-in
(test/cluster.go)."""

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def fnv1a64(data):
    """64-bit FNV-1a (reference: hash/fnv, cluster.partition)."""
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def partition_hash(index, shard, partition_n):
    """partition = FNV-1a(index ++ shard_be8) % partitionN
    (reference: cluster.partition cluster.go:871)."""
    data = index.encode() + int(shard).to_bytes(8, "big")
    return fnv1a64(data) % partition_n


class JmpHasher:
    """Jump consistent hash (reference: jmphasher cluster.go:948,
    Lamping & Veach 2014)."""

    def hash(self, key, n):
        key = int(key) & _MASK64
        b, j = -1, 0
        while j < n:
            b = j
            key = (key * 2862933555777941757 + 1) & _MASK64
            j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
        return b


class ModHasher:
    """key % n — deterministic placement for tests
    (reference: test/cluster.go ModHasher)."""

    def hash(self, key, n):
        return int(key) % n
