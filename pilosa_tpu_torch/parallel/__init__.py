"""Stacked-plane query kernels and the sharded engine over a group of
ranks (parallel/sharded.py)."""

from .sharded import (QueryKernels, ShardedQueryEngine, apply_op_chain,
                      build_global_mesh)
