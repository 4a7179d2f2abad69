"""Randomized differential of PQL trees against naive set models, for the
port's tests and the card's smoke run.

Two layers, each a model, a data writer and a generator:

- the set fuzz: fields f and g, rows 0..3, random columns in N_SHARDS
  shards (`SetModel`, `build`, `gen_call`), trees of Intersect / Union /
  Difference / Xor / Not over Row leaves;
- the full-type fuzz: a set field s, a mutex field m, a bool field b, an
  int field v (negatives, both BETWEEN forms), a YMD time field t whose
  ranges cross quantum boundaries and a keyed field k (`FullModel`,
  `build_full`, `gen_full_call`).

A generator returns `(pql, evaluator)`; the evaluator maps the model to
the exact set of columns the query must answer. `build` and
`build_full` populate through the port's `API` (which keeps the
existence field that `Not` reads) over a fresh `Holder` at `path`, on
`device` (cuda unless the caller names another). Generators and models are pure Python and draw
from `random.Random(seed)` in a fixed order, so one seed always gives
one data set and one list of queries.

    holder, api, model = build(path, seed=7, device="cpu")
    rnd = random.Random(7 * 31)
    pql, ev = gen_call(rnd)
    assert api.query("fz", f"Count({pql})")[0] == len(ev(model))

`check_set(ex, model, rnd, n)` and `check_full(ex, model, rnd, n)` run n
trees in both forms (Count, and the Row's exact columns) and raise
`FuzzMismatch` naming the seed's index and the PQL on the first
disagreement; `check_aggregates` holds TopN and Rows, `check_bsi_aggregates`
the filtered Sum/Min/Max.
"""

import datetime as dt
import random

from ..core import FieldOptions, Holder
from ..shardwidth import SHARD_WIDTH

N_SHARDS = 2
UNIVERSE = SHARD_WIDTH * N_SHARDS
FIELDS = ("f", "g")
ROWS = (0, 1, 2, 3)

FT_UNIVERSE = SHARD_WIDTH * 2
FT_KEYS = ("red", "blue", "green")
# the comparison operators of a BSI condition on the int field v
BSI_OPS = ("<", "<=", ">", ">=", "==", "!=")


class FuzzMismatch(AssertionError):
    """A query whose answer differs from the model's."""


# ------------------------------------------------------------- set fuzz


class SetModel:
    """(field, row) -> set of columns; the existence field is the union of
    everything ever set."""

    def __init__(self):
        self.rows = {(f, r): set() for f in FIELDS for r in ROWS}
        self.exists = set()

    def set_bits(self, field, row, cols):
        self.rows[(field, row)].update(cols)
        self.exists.update(cols)


def _api(path, device):
    from ..server.api import API

    holder = Holder(str(path)).open()
    return holder, API(holder, device=device)


def build(path, seed, device=None):
    """Index fz with fields f and g: each of rows 0..3 gets 0..400 random
    columns of the N_SHARDS shards, imported through the API (which keeps
    the existence field). Returns (holder, api, model)."""
    rnd = random.Random(seed)
    model = SetModel()
    holder, api = _api(path, device)
    api.create_index("fz")
    for f in FIELDS:
        api.create_field("fz", f, FieldOptions())
    for f in FIELDS:
        for r in ROWS:
            cols = rnd.sample(range(UNIVERSE), rnd.randint(0, 400))
            api.import_bits("fz", f, [r] * len(cols), cols)
            model.set_bits(f, r, cols)
    return holder, api, model


def _fold(evs, m, op):
    acc = evs[0](m)
    for e in evs[1:]:
        acc = op(acc, e(m))
    return acc


def gen_call(rnd, depth=0):
    """A random bitmap tree of depth <= 3 over Row(f|g=0..3) leaves, with
    2 or 3 operands per n-ary call: (pql, evaluator)."""
    ops = ["Row"] * 2 + (["Intersect", "Union", "Difference", "Xor", "Not"]
                         if depth < 3 else [])
    op = rnd.choice(ops)
    if op == "Row":
        f, r = rnd.choice(FIELDS), rnd.choice(ROWS)
        return f"Row({f}={r})", lambda m: set(m.rows[(f, r)])
    if op == "Not":
        pql, ev = gen_call(rnd, depth + 1)
        return f"Not({pql})", lambda m: m.exists - ev(m)
    n = rnd.randint(2, 3)
    subs = [gen_call(rnd, depth + 1) for _ in range(n)]
    pqls = ", ".join(p for p, _ in subs)
    evs = [e for _, e in subs]
    if op == "Intersect":
        return f"Intersect({pqls})", lambda m: _fold(
            evs, m, lambda a, b: a & b)
    if op == "Union":
        return f"Union({pqls})", lambda m: _fold(evs, m, lambda a, b: a | b)
    if op == "Difference":
        return f"Difference({pqls})", lambda m: _fold(
            evs, m, lambda a, b: a - b)
    return f"Xor({pqls})", lambda m: _fold(evs, m, lambda a, b: a ^ b)


def _check_tree(ex, index, pql, want, tag):
    got_n = ex.execute(index, f"Count({pql})")[0]
    if got_n != len(want):
        raise FuzzMismatch(
            f"{tag} Count({pql}): got {got_n}, model {len(want)}")
    row = ex.execute(index, pql)[0]
    got = set(int(c) for c in row.columns())
    if got != want:
        raise FuzzMismatch(
            f"{tag} {pql}: {len(got ^ want)} columns differ "
            f"(got {len(got)}, model {len(want)})")


def check_set(ex, model, rnd, n=25, tag=""):
    """n trees of `gen_call(rnd)` against the model, each as a Count and
    as the Row's exact columns. Returns the PQL checked."""
    done = []
    for i in range(n):
        pql, ev = gen_call(rnd)
        _check_tree(ex, "fz", pql, ev(model), f"{tag} i={i}")
        done.append(pql)
    return done


def fixed_set_queries():
    """Count(Row(x=r)) for every row of f and g, and Count(Intersect(
    Row(f=r1), Row(g=r2))) for every pair: [(pql, evaluator)]. Under a
    forced repr these reach the single-leaf and the pure-& pair routes
    whatever the seed draws."""
    out = []
    for f in FIELDS:
        for r in ROWS:
            out.append((f"Count(Row({f}={r}))",
                        lambda m, f=f, r=r: len(m.rows[(f, r)])))
    for r1 in ROWS:
        for r2 in ROWS:
            out.append((f"Count(Intersect(Row(f={r1}), Row(g={r2})))",
                        lambda m, r1=r1, r2=r2: len(
                            m.rows[("f", r1)] & m.rows[("g", r2)])))
    return out


def fixed_bsi_queries():
    """One Count of each BSI operator on v, both BETWEEN forms included:
    [(pql, evaluator)]."""
    leaves = [bsi_leaf(op, 100) for op in BSI_OPS]
    leaves += [bsi_between(-20, 120, inclusive=True),
               bsi_between(-20, 120, inclusive=False)]
    return [(f"Count({pql})", lambda m, ev=ev: len(ev(m)))
            for pql, ev in leaves]


def check_fixed(ex, index, model, queries, tag=""):
    """Each (pql, evaluator) of `queries` against the model."""
    for pql, ev in queries:
        got, want = ex.execute(index, pql)[0], ev(model)
        if got != want:
            raise FuzzMismatch(f"{tag} {pql}: got {got}, model {want}")
    return [pql for pql, _ in queries]


def topn_want(model, n=4):
    want = sorted(((len(model.rows[("f", r)]), r) for r in ROWS),
                  key=lambda t: (-t[0], t[1]))
    return [(r, c) for c, r in want if c > 0][:n]


def check_aggregates(ex, model, tag=""):
    """TopN(f, n=4) and Rows(f) against the model. Returns the PQL
    checked."""
    got = [(p.id, p.count) for p in ex.execute("fz", "TopN(f, n=4)")[0]]
    if got != topn_want(model):
        raise FuzzMismatch(f"{tag} TopN(f, n=4): {got} != {topn_want(model)}")
    rows = list(ex.execute("fz", "Rows(f)")[0].rows)
    want = [r for r in ROWS if model.rows[("f", r)]]
    if rows != want:
        raise FuzzMismatch(f"{tag} Rows(f): {rows} != {want}")
    return ["TopN(f, n=4)", "Rows(f)"]


# ------------------------------------------------------- full-type fuzz


class FullModel:
    """How each field type stores writes: s set rows, m mutex (col ->
    row, the last write wins), b bool (col -> bool), v int (col -> value),
    t time (row -> [(col, timestamp)]), k keyed rows."""

    def __init__(self):
        self.set_rows = {r: set() for r in (0, 1, 2, 3)}
        self.mutex = {}
        self.bools = {}
        self.ints = {}
        self.time_bits = {r: [] for r in (0, 1)}
        self.keyed = {k: set() for k in FT_KEYS}
        self.exists = set()

    def mutex_row(self, r):
        return {c for c, rr in self.mutex.items() if rr == r}

    def bool_row(self, val):
        return {c for c, v in self.bools.items() if v is val}

    def int_cond(self, pred):
        return {c for c, v in self.ints.items() if pred(v)}

    def time_row(self, r, frm=None, to=None):
        out = set()
        for col, ts in self.time_bits[r]:
            if (frm is None or ts >= frm) and (to is None or ts < to):
                out.add(col)
        return out


def build_full(path, seed, device=None):
    """Index fz2 over 500 random columns of 2 shards: s by bulk import,
    m and b by PQL Set (150 and 100 writes), v by a values import (250
    columns in [-50, 250]), t by timestamped imports (midday stamps from
    2018-11-15 over 110 days), k by keyed imports. Returns (holder, api,
    model); `api.executor` serves the queries."""
    rnd = random.Random(seed)
    model = FullModel()
    holder, api = _api(path, device)
    ex = api.executor
    api.create_index("fz2")
    api.create_field("fz2", "s", FieldOptions())
    api.create_field("fz2", "m", FieldOptions.mutex_field())
    api.create_field("fz2", "b", FieldOptions.bool_field())
    api.create_field("fz2", "v", FieldOptions.int_field(min=-50, max=250))
    api.create_field("fz2", "t", FieldOptions.time_field("YMD"))
    api.create_field("fz2", "k", FieldOptions(keys=True))

    cols = rnd.sample(range(FT_UNIVERSE), 500)
    for r in model.set_rows:
        chosen = rnd.sample(cols, rnd.randint(0, 150))
        api.import_bits("fz2", "s", [r] * len(chosen), chosen)
        model.set_rows[r].update(chosen)
        model.exists.update(chosen)
    for _ in range(150):
        c, r = rnd.choice(cols), rnd.randrange(3)
        ex.execute("fz2", f"Set({c}, m={r})")
        model.mutex[c] = r
        model.exists.add(c)
    for _ in range(100):
        c, val = rnd.choice(cols), rnd.random() < 0.5
        ex.execute("fz2", f"Set({c}, b={'true' if val else 'false'})")
        model.bools[c] = val
        model.exists.add(c)
    vcols = rnd.sample(cols, 250)
    vals = [rnd.randint(-50, 250) for _ in vcols]
    api.import_values("fz2", "v", vcols, vals)
    model.ints.update(zip(vcols, vals))
    model.exists.update(vcols)
    epoch = dt.datetime(2018, 11, 15, 12, 0)
    for r in model.time_bits:
        for _ in range(rnd.randint(20, 60)):
            c = rnd.choice(cols)
            ts = epoch + dt.timedelta(days=rnd.randrange(110))
            api.import_bits("fz2", "t", [r], [c], timestamps=[ts])
            model.time_bits[r].append((c, ts))
            model.exists.add(c)
    for key in FT_KEYS:
        chosen = rnd.sample(cols, rnd.randint(5, 80))
        api.import_bits("fz2", "k", [], chosen,
                        row_keys=[key] * len(chosen))
        model.keyed[key].update(chosen)
        model.exists.update(chosen)
    return holder, api, model


_PREDS = {"<": lambda x: lambda v: v < x, ">": lambda x: lambda v: v > x,
          "<=": lambda x: lambda v: v <= x, ">=": lambda x: lambda v: v >= x,
          "==": lambda x: lambda v: v == x, "!=": lambda x: lambda v: v != x}


def bsi_leaf(op, x):
    """Row(v <op> x) and its evaluator; `op` is one of BSI_OPS."""
    pred = _PREDS[op](x)
    return f"Row(v {op} {x})", lambda m: m.int_cond(pred)


def bsi_between(a, b, inclusive):
    """`Row(v >< [a, b])` (inclusive) or `Row(a < v < b)` (strict)."""
    if inclusive:
        return (f"Row(v >< [{a}, {b}])",
                lambda m: m.int_cond(lambda v: a <= v <= b))
    return f"Row({a} < v < {b})", lambda m: m.int_cond(lambda v: a < v < b)


def gen_full_leaf(rnd):
    """One random leaf across every field type: (pql, evaluator)."""
    kind = rnd.choice(["s", "m", "b", "v", "v", "t", "k"])
    if kind == "s":
        r = rnd.randrange(4)
        return f"Row(s={r})", lambda m: set(m.set_rows[r])
    if kind == "m":
        r = rnd.randrange(3)
        return f"Row(m={r})", lambda m: m.mutex_row(r)
    if kind == "b":
        val = rnd.random() < 0.5
        return (f"Row(b={'true' if val else 'false'})",
                lambda m: m.bool_row(val))
    if kind == "v":
        form = rnd.choice(["cmp", "between_chain", "between_op"])
        if form == "cmp":
            op = rnd.choice(["<", ">", "<=", ">=", "==", "!="])
            return bsi_leaf(op, rnd.randint(-60, 260))
        a = rnd.randint(-60, 200)
        b = a + rnd.randint(0, 80)
        return bsi_between(a, b, inclusive=form == "between_op")
    if kind == "t":
        r = rnd.randrange(2)
        if rnd.random() < 0.3:  # no range: standard view, all bits ever
            return f"Row(t={r})", lambda m: m.time_row(r)
        frm = dt.datetime(2018, 10, 1) + dt.timedelta(
            days=rnd.randrange(150))
        to = frm + dt.timedelta(days=rnd.randrange(1, 120))
        f_s, t_s = frm.strftime("%Y-%m-%dT%H:%M"), \
            to.strftime("%Y-%m-%dT%H:%M")
        return (f"Row(t={r}, from={f_s}, to={t_s})",
                lambda m: m.time_row(r, frm, to))
    key = rnd.choice(FT_KEYS)
    return f'Row(k="{key}")', lambda m: set(m.keyed[key])


_FOLDS = {"Intersect": lambda a, b: a & b,
          "Union": lambda a, b: a | b,
          "Difference": lambda a, b: a - b,
          "Xor": lambda a, b: a ^ b}


def gen_full_call(rnd, depth=0):
    """A random tree of depth <= 3 over `gen_full_leaf` leaves."""
    if depth >= 3 or rnd.random() < 0.45:
        return gen_full_leaf(rnd)
    op = rnd.choice(["Intersect", "Union", "Difference", "Xor", "Not"])
    if op == "Not":
        pql, ev = gen_full_call(rnd, depth + 1)
        return f"Not({pql})", lambda m: m.exists - ev(m)
    subs = [gen_full_call(rnd, depth + 1)
            for _ in range(rnd.randint(2, 3))]
    pqls = ", ".join(p for p, _ in subs)
    evs = [e for _, e in subs]
    fold = _FOLDS[op]
    return f"{op}({pqls})", lambda m: _fold(evs, m, fold)


def check_full(ex, model, rnd, n=40, tag=""):
    """n trees of `gen_full_call(rnd)` against the model, each as a Count
    and as the Row's exact columns. Returns the PQL checked."""
    done = []
    for i in range(n):
        pql, ev = gen_full_call(rnd)
        _check_tree(ex, "fz2", pql, ev(model), f"{tag} i={i}")
        done.append(pql)
    return done


def bsi_aggregates_want(model, r):
    """(sum, count), (min, count), (max, count) of v over Row(s=r); a
    None value where no column qualifies."""
    in_f = [v for c, v in model.ints.items() if c in model.set_rows[r]]
    if not in_f:
        return (0, 0), (None, 0), (None, 0)
    lo, hi = min(in_f), max(in_f)
    return ((sum(in_f), len(in_f)), (lo, in_f.count(lo)),
            (hi, in_f.count(hi)))


def check_bsi_aggregates(ex, model, tag=""):
    """Sum/Min/Max(Row(s=r), field=v) for r in 0..3 against the model.
    Returns the PQL checked."""
    done = []
    for r in range(4):
        wants = bsi_aggregates_want(model, r)
        for call, (val, count) in zip(("Sum", "Min", "Max"), wants):
            pql = f"{call}(Row(s={r}), field=v)"
            got = ex.execute("fz2", pql)[0]
            ok = got.count == count and (val is None or got.val == val)
            if not ok:
                raise FuzzMismatch(
                    f"{tag} {pql}: got "
                    f"({got.val}, {got.count}), model ({val}, {count})")
            done.append(pql)
    return done
