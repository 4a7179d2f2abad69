"""Query engine (reference: executor.go).

The result types load at once; the executor (and with it torch) on first
use, so the wire codec's decoder, which builds result objects, can run
in a client process that never loads torch."""

from .result import FieldRow, GroupCount, Pair, RowIdentifiers, ValCount

_LAZY = {"ExecError", "ExecOptions", "Executor", "FieldNotFound"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from . import executor

    return getattr(executor, name)
