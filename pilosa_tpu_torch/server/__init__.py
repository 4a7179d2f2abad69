"""Server layer: API facade, HTTP transport and client (reference:
api.go, http/).

The client needs only the standard library, so `Client` is imported
here at once and the rest on first use: the command line's client tools
(import, export, backup, restore) start without loading torch."""

from .client import Client, ClientError, DeadlineExceeded

_LAZY = {"API": "api", "ApiError": "api", "ConflictError": "api",
         "NotFoundError": "api", "ServiceUnavailableError": "api",
         "PilosaHTTPServer": "http_server"}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
