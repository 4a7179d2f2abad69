"""A concurrent read/write/snapshot/DDL round over one index, for the
port's tests and the card's smoke run.

`concurrent_round(api, ex)` creates index "st" with a set field f and an
int field v (0..1000) through `api`, then runs at once:

- N_WRITERS writers, each setting `ops_per_writer` random bits of f
  (rows 0..4) inside its own column range of 3 shards (so the final
  state does not depend on the interleaving), and on one write in four
  a value of v;
- N_READERS readers looping Count, Count of an Intersect, TopN, Sum
  and Row through `ex` (the stacked paths and their repair after
  writes);
- a snapshotter rewriting every fragment of f and v every 50 ms;
- a DDL churn creating, writing and deleting a scratch field 30 times.

Every thread is joined within JOIN_TIMEOUT seconds. Afterwards each row
of f must equal the writers' own record of it, the Count of the union of
rows 0..4 the number of columns written, and every fragment of f and v
must pass `storage.check()`; `StressFailure` names the first difference.
Run it with PILOSA_TPU_PARANOIA=1 to have every fragment write checked
against the storage invariants as well. Returns the number of (row,
column) bits written.
"""

import threading

import numpy as np

from ..core import FieldOptions
from ..shardwidth import SHARD_WIDTH

N_WRITERS = 4
N_READERS = 3
JOIN_TIMEOUT = 120.0  # seconds each thread may take to join


class StressFailure(AssertionError):
    """A hung thread, an error raised in a thread, or a final row that
    differs from the writers' record."""


READS = ("Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))",
         "TopN(f, n=3)", "Sum(field=v)", "Row(f=0)")


def concurrent_round(api, ex, ops_per_writer=300):
    api.create_index("st")
    api.create_field("st", "f")
    api.create_field("st", "v", FieldOptions.int_field(min=0, max=1000))
    idx = api.holder.index("st")
    errors = []
    stop = threading.Event()
    rngs = [np.random.default_rng(100 + i) for i in range(N_WRITERS)]
    span = (3 * SHARD_WIDTH) // N_WRITERS
    written = [set() for _ in range(N_WRITERS)]

    def guard(fn):
        def run():
            try:
                fn()
            except Exception as e:  # the failure path: reported below
                errors.append(e)
                stop.set()
        return run

    def writer(i):
        lo = i * span
        for _ in range(ops_per_writer):
            if stop.is_set():
                return
            col = int(rngs[i].integers(lo, lo + span))
            row = int(rngs[i].integers(0, 5))
            api.query("st", f"Set({col}, f={row})")
            written[i].add((row, col))
            if rngs[i].integers(0, 4) == 0:
                api.query("st", f"Set({col}, v={col % 1000})")

    def reader():
        r = np.random.default_rng(7)
        while not stop.is_set():
            out = ex.execute("st", READS[int(r.integers(0, len(READS)))])[0]
            if isinstance(out, int) and out < 0:
                raise StressFailure(f"negative count {out}")

    def snapshotter():
        while not stop.is_set():
            for field in ("f", "v"):
                for view in list(idx.field(field).views.values()):
                    for frag in list(view.fragments.values()):
                        frag.snapshot()
            stop.wait(0.05)

    def ddl_churn():
        for i in range(30):
            if stop.is_set():
                return
            api.create_field("st", "scratch")
            api.query("st", f"Set({i}, scratch=1)")
            api.delete_field("st", "scratch")

    writers = [threading.Thread(target=guard(lambda i=i: writer(i)))
               for i in range(N_WRITERS)]
    others = [threading.Thread(target=guard(reader))
              for _ in range(N_READERS)]
    others += [threading.Thread(target=guard(snapshotter)),
               threading.Thread(target=guard(ddl_churn))]
    for t in writers + others:
        t.start()
    for t in writers:
        t.join(timeout=JOIN_TIMEOUT)
    stop.set()
    for t in others:
        t.join(timeout=JOIN_TIMEOUT)
    if any(t.is_alive() for t in writers + others):
        raise StressFailure("stress threads hung")
    if errors:
        raise StressFailure(f"errors in threads: {errors!r}")

    want_by_row = {}
    for w in written:
        for row, col in w:
            want_by_row.setdefault(row, set()).add(col)
    for row, want in sorted(want_by_row.items()):
        got = set(int(c) for c in ex.execute(
            "st", f"Row(f={row})")[0].columns())
        if got != want:
            raise StressFailure(f"row {row}: {len(got)} vs {len(want)}")
    total = ex.execute("st", "Count(Union(" + ", ".join(
        f"Row(f={r})" for r in range(5)) + "))")[0]
    cols = {c for w in written for _, c in w}
    if total != len(cols):
        raise StressFailure(f"union count {total} vs {len(cols)}")
    for field in ("f", "v"):
        for view in list(idx.field(field).views.values()):
            for frag in list(view.fragments.values()):
                frag.storage.check()
    return sum(len(w) for w in written)
