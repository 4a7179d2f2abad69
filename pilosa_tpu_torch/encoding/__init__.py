"""Wire encoding (reference: encoding/proto/proto.go Serializer +
internal/public.proto). JSON is the default HTTP encoding; this package adds
the protobuf data plane, wire-compatible with the reference, through a
hand-written codec (wire.py) that needs no protobuf runtime."""

from .serializer import (  # noqa: F401
    CONTENT_TYPE_PROTOBUF,
    decode_query_request,
    decode_query_response,
    encode_query_request,
    encode_query_response,
)
