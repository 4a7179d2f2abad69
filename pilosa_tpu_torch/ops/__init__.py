"""Device layer: plane algebra in PyTorch and the hand-written Hopper
kernels that replace the TPU package's Pallas kernels."""

from . import bitplane, containers, count_expr


def declared_cost(kernel, args, device=None):
    """The declared cost of one launch of `kernel` (a wrapper's name:
    count_expr, count_expr_batch, count_expr_multi, count_blocks,
    count_and_blocks, row_counts, pairwise_counts, bsi_range_mask) with
    its cost arguments `args` (see each module's `*_cost`)."""
    from . import bsi_range, count_blocks, pairwise, row_counts

    fn = {
        "count_expr": count_expr.count_expr_cost,
        "count_expr_batch": count_expr.count_expr_batch_cost,
        "count_expr_multi": count_expr.count_expr_multi_cost,
        "count_blocks": count_blocks.count_blocks_cost,
        "count_and_blocks": count_blocks.count_and_blocks_cost,
        "row_counts": row_counts.row_counts_cost,
        "pairwise_counts": pairwise.pairwise_cost,
        "bsi_range_mask": bsi_range.bsi_range_cost,
    }[kernel]
    return fn(*args, device=device)
