"""Roaring containers, numpy-backed.

Host-side storage only: the reference implements its entire set-algebra on
these (reference: roaring/roaring.go:3121-5196); in this framework containers
exist solely as the at-rest/interchange representation plus a mutation target
for writes. All query-time algebra happens on dense device planes
(pilosa_tpu_torch.ops.bitplane); a container's job is to (de)serialize and to
convert to/from dense words.

Three kinds, matching the reference's on-disk type ids (roaring/roaring.go:65):
1=array (sorted uint16 values), 2=bitmap (2^16 bits), 3=run ([start,last]
uint16 intervals, inclusive).
"""

import numpy as np

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

# Cardinality threshold at which an array converts to a bitmap (reference:
# roaring ArrayMaxSize = 4096).
ARRAY_MAX_SIZE = 4096
# Bytes of a serialized bitmap container: 2^16 bits.
BITMAP_BYTES = 8192
WORDS = BITMAP_BYTES // 4  # uint32 words
RUN_MAX_SIZE = 2048  # reference: runMaxSize — above this a run container is never smaller


class Container:
    """One 2^16-bit chunk of a bitmap.

    Internally holds exactly one of:
      values: sorted unique uint16 ndarray          (array)
      words:  [2048] uint32 ndarray, little-endian  (bitmap)
      runs:   [R, 2] uint16 ndarray of [start,last] (run)
    """

    __slots__ = ("typ", "values", "words", "runs", "n")

    def __init__(self, typ=TYPE_ARRAY, values=None, words=None, runs=None, n=None):
        self.typ = typ
        if typ == TYPE_ARRAY and values is None:
            values = np.empty(0, dtype=np.uint16)
        self.values = values
        self.words = words
        self.runs = runs
        if n is None:
            n = self._count()
        self.n = n

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_values(cls, values):
        values = np.unique(np.asarray(values, dtype=np.uint16))  # sorted+dedup
        if len(values) > ARRAY_MAX_SIZE:
            return cls.from_dense_words(values_to_words(values))
        return cls(TYPE_ARRAY, values=values)

    @classmethod
    def from_dense_words(cls, words, n=None):
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if n is None:
            n = int(np.sum(popcount32(words)))
        if n <= ARRAY_MAX_SIZE:
            return cls(TYPE_ARRAY, values=words_to_values(words), n=n)
        return cls(TYPE_BITMAP, words=words, n=n)

    @classmethod
    def from_runs(cls, runs):
        runs = np.asarray(runs, dtype=np.uint16).reshape(-1, 2)
        return cls(TYPE_RUN, runs=runs)

    # -- basic ops ----------------------------------------------------------

    def _count(self):
        if self.typ == TYPE_ARRAY:
            return len(self.values) if self.values is not None else 0
        if self.typ == TYPE_BITMAP:
            return int(np.sum(popcount32(self.words)))
        runs = self.runs
        if runs is None or len(runs) == 0:
            return 0
        return int(np.sum(runs[:, 1].astype(np.int64) - runs[:, 0].astype(np.int64) + 1))

    def contains(self, v):
        v = np.uint16(v)
        if self.typ == TYPE_ARRAY:
            i = np.searchsorted(self.values, v)
            return i < len(self.values) and self.values[i] == v
        if self.typ == TYPE_BITMAP:
            return bool((self.words[int(v) >> 5] >> np.uint32(int(v) & 31)) & np.uint32(1))
        for s, l in self.runs:
            if s <= v <= l:
                return True
        return False

    def add(self, v):
        """Returns True if the bit changed. Converts representation as needed
        (reference: container add/array->bitmap conversion roaring.go:2599)."""
        if self.contains(v):
            return False
        v = np.uint16(v)
        if self.typ == TYPE_RUN:
            self._run_to_bitmap_or_array()
            return self.add(v)
        if self.typ == TYPE_ARRAY:
            if self.n >= ARRAY_MAX_SIZE:
                self._array_to_bitmap()
                return self.add(v)
            i = int(np.searchsorted(self.values, v))
            self.values = np.insert(self.values, i, v)
            self.n += 1
            return True
        self.words[int(v) >> 5] |= np.uint32(1) << np.uint32(int(v) & 31)
        self.n += 1
        return True

    def remove(self, v):
        if not self.contains(v):
            return False
        v = np.uint16(v)
        if self.typ == TYPE_RUN:
            self._run_to_bitmap_or_array()
            return self.remove(v)
        if self.typ == TYPE_ARRAY:
            i = int(np.searchsorted(self.values, v))
            self.values = np.delete(self.values, i)
            self.n -= 1
            return True
        self.words[int(v) >> 5] &= ~(np.uint32(1) << np.uint32(int(v) & 31))
        self.n -= 1
        if self.n <= ARRAY_MAX_SIZE // 2:
            # Hysteresis: convert back lazily only when well below threshold.
            self.values = words_to_values(self.words)
            self.words = None
            self.typ = TYPE_ARRAY
        return True

    def add_many(self, values):
        """Bulk union of a sorted-or-not uint16 batch; returns change count."""
        if len(values) == 0:
            return 0
        words = self.to_dense_words().copy()
        before = self.n
        add = values_to_words(np.asarray(values, dtype=np.uint16))
        words |= add
        n = int(np.sum(popcount32(words)))
        self._become_dense(words, n)
        return n - before

    def remove_many(self, values):
        if len(values) == 0:
            return 0
        words = self.to_dense_words().copy()
        before = self.n
        words &= ~values_to_words(np.asarray(values, dtype=np.uint16))
        n = int(np.sum(popcount32(words)))
        self._become_dense(words, n)
        return before - n

    def _become_dense(self, words, n):
        if n <= ARRAY_MAX_SIZE:
            self.typ, self.values, self.words, self.runs = (
                TYPE_ARRAY, words_to_values(words), None, None)
        else:
            self.typ, self.values, self.words, self.runs = (
                TYPE_BITMAP, None, words, None)
        self.n = n

    def _array_to_bitmap(self):
        self.words = values_to_words(self.values)
        self.values = None
        self.typ = TYPE_BITMAP

    def _run_to_bitmap_or_array(self):
        words = self.to_dense_words().copy()
        self._become_dense(words, self.n)

    # -- dense conversion (the TPU upload path) -----------------------------

    def to_dense_words(self):
        """[2048] uint32 dense words (shared buffer for bitmap containers)."""
        if self.typ == TYPE_BITMAP:
            return self.words
        if self.typ == TYPE_ARRAY:
            return values_to_words(self.values)
        return runs_to_words(self.runs)

    def to_values(self):
        """Sorted uint16 values."""
        if self.typ == TYPE_ARRAY:
            return self.values
        if self.typ == TYPE_RUN:
            if len(self.runs) == 0:
                return np.empty(0, dtype=np.uint16)
            return np.concatenate(
                [np.arange(int(s), int(l) + 1, dtype=np.uint16) for s, l in self.runs])
        return words_to_values(self.words)

    def to_runs(self):
        """[R,2] uint16 [start,last] inclusive intervals."""
        from .. import native

        if self.typ == TYPE_RUN:
            return self.runs
        if self.typ == TYPE_BITMAP:
            return native.extract_runs(self.words)
        values = self.to_values().astype(np.int64)
        if len(values) == 0:
            return np.empty((0, 2), dtype=np.uint16)
        breaks = np.nonzero(np.diff(values) != 1)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [len(values) - 1]])
        return np.stack([values[starts], values[ends]], axis=1).astype(np.uint16)

    def optimized(self):
        """Most compact representation, using the reference's selection rule
        (Container.optimize roaring.go:2334-2348): run when run count is both
        <= runMaxSize and <= n/2; else array when n < ArrayMaxSize; else
        bitmap."""
        if self.n == 0:
            return self
        runs = self.to_runs()
        if len(runs) <= RUN_MAX_SIZE and len(runs) <= self.n // 2:
            best = TYPE_RUN
        elif self.n < ARRAY_MAX_SIZE:
            best = TYPE_ARRAY
        else:
            best = TYPE_BITMAP
        if best == self.typ:
            return self
        if best == TYPE_RUN:
            return Container(TYPE_RUN, runs=runs, n=self.n)
        if best == TYPE_ARRAY:
            return Container(TYPE_ARRAY, values=self.to_values(), n=self.n)
        return Container(TYPE_BITMAP, words=self.to_dense_words().copy(), n=self.n)

    def serialized_size(self):
        if self.typ == TYPE_ARRAY:
            return 2 * self.n
        if self.typ == TYPE_RUN:
            return 2 + 4 * len(self.runs)
        return BITMAP_BYTES

    def clone(self):
        return Container(
            self.typ,
            values=None if self.values is None else self.values.copy(),
            words=None if self.words is None else self.words.copy(),
            runs=None if self.runs is None else self.runs.copy(),
            n=self.n,
        )


def runs_to_words(runs):
    """[2048] uint32 words of [R, 2] [start, last] runs, with no per-run
    loop (a container of random words holds hundreds of runs, and the WAL
    replay converts every container it merges): a run's interior words
    are full (a +1/-1 delta over the words, prefix-summed to coverage),
    and its first and last words OR in their bit masks."""
    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 2)
    start, last = runs[:, 0], runs[:, 1]
    ws, we = start >> 5, last >> 5
    inner = we > ws + 1
    delta = (np.bincount(ws[inner] + 1, minlength=WORDS + 1)
             - np.bincount(we[inner], minlength=WORDS + 1))
    words = np.where(np.cumsum(delta[:WORDS]) > 0, np.uint32(0xFFFFFFFF),
                     np.uint32(0))
    head = (0xFFFFFFFF << (start & 31)) & 0xFFFFFFFF
    tail = 0xFFFFFFFF >> (31 - (last & 31))
    one = ws == we
    np.bitwise_or.at(words, ws, np.where(one, head & tail, head)
                     .astype(np.uint32))
    np.bitwise_or.at(words, we[~one], tail[~one].astype(np.uint32))
    return words


def popcount32(words):
    from .. import native

    if words.dtype != np.uint32:
        words = words.astype(np.uint32)
    return native.popcount_per_word(words)


def values_to_words(values):
    from .. import native

    words = np.zeros(WORDS, dtype=np.uint32)
    if len(values):
        native.scatter_u16(np.asarray(values, dtype=np.uint16), words)
    return words


def words_to_values(words):
    """Dense words -> sorted uint16 values."""
    from .. import native

    return native.extract_u16(words)


def container_check(c):
    """Invariant violations of one container as a list of strings
    (reference: Container.check roaring.go:3010)."""
    errors = []
    if c.typ == TYPE_ARRAY:
        if c.values is None:
            return ["array container without values"]
        if len(c.values) != c.n:
            errors.append(f"n={c.n} but {len(c.values)} values")
        if len(c.values) > 1 and not np.all(np.diff(
                c.values.astype(np.int64)) > 0):
            errors.append("array values not sorted unique")
    elif c.typ == TYPE_BITMAP:
        if c.words is None or len(c.words) != WORDS:
            return ["bitmap container with wrong word count"]
        actual = int(np.sum(popcount32(c.words)))
        if actual != c.n:
            errors.append(f"n={c.n} but {actual} bits set")
    elif c.typ == TYPE_RUN:
        runs = c.runs
        if runs is None:
            return ["run container without runs"]
        last_end = -1
        total = 0
        for s, l in runs:
            s, l = int(s), int(l)
            if s <= last_end:
                errors.append(f"run [{s},{l}] overlaps/unsorted")
            if l < s:
                errors.append(f"run [{s},{l}] inverted")
            total += l - s + 1
            last_end = l
        if total != c.n:
            errors.append(f"n={c.n} but runs cover {total}")
    else:
        errors.append(f"unknown type {c.typ}")
    return errors
