"""Server layer: API facade and HTTP transport (reference: api.go, http/)."""

from .api import API, ApiError, ConflictError, NotFoundError, \
    ServiceUnavailableError
from .http_server import PilosaHTTPServer
