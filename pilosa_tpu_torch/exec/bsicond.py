"""BSI condition planning + application, shared across execution paths.

The reference evaluates `Row(v > 10)` per shard inside
executeRowBSIGroupShard (executor.go:1533) with host-side clamping against
the bsiGroup's declared range (bsiGroup.baseValue field.go:1583) and
bit-plane scans (fragment.go:1292-1470). Here that logic is split into:

- `bsi_condition_plan(opts, cond)`: pure host normalization — clamping,
  out-of-range and full-range fast paths — producing a small descriptor
  that depends only on the field's options (never on shard data).
- `apply_bsi_condition(plan, planes, sign, exists)`: maps the descriptor
  onto device planes with the ops.bsi range ops (K5), so the SAME plan
  evaluates one shard ([D, W] planes) or every shard at once ([D, S, W]
  stacked serving planes).

Plan descriptors:
    ("empty",)               provably no column matches
    ("notnull",)             every existing (non-null) column
    (op, base_value)         kernel compare; op in eq/neq/lt/lte/gt/gte
    ("between", lo_c, hi_c)  clamped base-relative range (signed)
"""

from ..ops import bsi as bsi_ops
from ..pql import BETWEEN, Condition, EQ, GT, GTE, LT, LTE, NEQ


class BsiConditionError(Exception):
    pass


def normalize_bsi_condition(cond):
    """(op, vals) hashable key parts for a coverable condition, or None
    when the shape can't ride a leaf (non-integer values, malformed
    BETWEEN). Shared by the stacked and SPMD signature walks so both
    paths cover the identical condition set."""
    if not isinstance(cond, Condition):
        return None
    if cond.op == BETWEEN:
        vals = cond.int_values()
        if len(vals) != 2:
            return None
        return cond.op, tuple(vals)
    if cond.value is None:
        if cond.op != NEQ:
            return None
        return cond.op, None
    if isinstance(cond.value, int) and not isinstance(cond.value, bool):
        return cond.op, cond.value
    return None


def condition_from_key(op, vals):
    """Inverse of normalize_bsi_condition for wire-carried leaves."""
    if isinstance(vals, (tuple, list)):
        return Condition(op, list(vals))
    return Condition(op, vals)


def bsi_condition_plan(opts, cond):
    """Host-side plan for one condition against a BSI field's options
    (reference: executeRowBSIGroupShard executor.go:1533-1664). Raises
    BsiConditionError on malformed conditions (mirrors the executor's
    per-shard errors)."""
    depth = opts.bit_depth
    depth_min = opts.base - (1 << depth) + 1
    depth_max = opts.base + (1 << depth) - 1

    if cond.op == NEQ and cond.value is None:
        return ("notnull",)

    if cond.op == BETWEEN:
        predicates = cond.int_values()
        if len(predicates) != 2:
            raise BsiConditionError(
                "Row(): BETWEEN condition requires exactly two integer "
                "values")
        lo, hi = predicates
        if hi < depth_min or lo > depth_max:
            return ("empty",)
        if lo <= opts.min and hi >= opts.max:
            return ("notnull",)
        lo_c = max(lo, depth_min) - opts.base
        hi_c = min(hi, depth_max) - opts.base
        return ("between", lo_c, hi_c)

    if not isinstance(cond.value, int) or isinstance(cond.value, bool):
        raise BsiConditionError(
            "Row(): conditions only support integer values")
    value = cond.value

    # out-of-depth-range clamping (reference: bsiGroup.baseValue)
    if cond.op in (GT, GTE):
        if value > depth_max:
            return ("empty",)
        base_value = value - opts.base if value > depth_min else \
            depth_min - opts.base
    elif cond.op in (LT, LTE):
        if value < depth_min:
            return ("empty",)
        base_value = (min(value, depth_max)) - opts.base
    else:  # EQ / NEQ
        out_of_range = value < depth_min or value > depth_max
        if out_of_range and cond.op == EQ:
            return ("empty",)
        if out_of_range:  # NEQ out of range -> all not-null
            return ("notnull",)
        base_value = value - opts.base

    # full-range fast path -> notNull (reference: executor.go:1650)
    if ((cond.op == LT and value > opts.max)
            or (cond.op == LTE and value >= opts.max)
            or (cond.op == GT and value < opts.min)
            or (cond.op == GTE and value <= opts.min)):
        return ("notnull",)

    kind = {EQ: "eq", NEQ: "neq", LT: "lt", LTE: "lte",
            GT: "gt", GTE: "gte"}[cond.op]
    return (kind, base_value)


def _pbits(value, depth):
    return bsi_ops.predicate_bits(abs(value), depth)


def between_signed(planes, sign, exists, lo, hi, depth):
    """Signed lo <= value <= hi as the AND of two K5 masks, value >= lo
    and value <= hi. The TPU package unions unsigned magnitude compares
    over the sign slices (reference: fragment.rangeBetween
    fragment.go:1437); the two agree when both bounds are >= 0, both < 0,
    and when the range straddles zero."""
    ge_lo = bsi_ops.range_gt(planes, sign, exists, _pbits(lo, depth),
                             lo < 0, True)
    le_hi = bsi_ops.range_lt(planes, sign, exists, _pbits(hi, depth),
                             hi < 0, True)
    return ge_lo & le_hi


def apply_bsi_condition(plan, planes, sign, exists):
    """Device evaluation of a plan over BSI planes ([D, W] or [D, S, W];
    sign/exists shaped like one plane). Callers handle the ("empty",) and
    ("notnull",) plans themselves (they need no magnitude planes)."""
    depth = planes.shape[0]
    kind = plan[0]
    if kind == "between":
        return between_signed(planes, sign, exists, plan[1], plan[2],
                              depth)
    base_value = plan[1]
    pbits = _pbits(base_value, depth)
    neg = base_value < 0
    if kind == "eq":
        return bsi_ops.range_eq(planes, sign, exists, pbits, neg)
    if kind == "neq":
        eq = bsi_ops.range_eq(planes, sign, exists, pbits, neg)
        return exists & ~eq
    if kind in ("lt", "lte"):
        return bsi_ops.range_lt(planes, sign, exists, pbits, neg,
                                kind == "lte")
    if kind in ("gt", "gte"):
        return bsi_ops.range_gt(planes, sign, exists, pbits, neg,
                                kind == "gte")
    raise BsiConditionError(f"unknown condition plan: {plan!r}")
