"""Federated layer of the port: the synchronous runner, communication
strategies and the packed wire transport (the asynchronous runtime is
ROADMAP Queue 1 item 10)."""
from .runtime import FederatedRunner, RoundStats
from .strategies import (
    CommStrategy,
    CompressedGT,
    FullSync,
    GradientTracking,
    LocalOnly,
    QuantizedGT,
    resolve_strategy,
)
from .transport import (
    HEADER_BYTES,
    LeafPayload,
    LeafSpec,
    PackedTree,
    decode_leaf,
    encode_leaf,
    measured_bytes_per_round,
    wire_header_overhead,
)

__all__ = [
    "FederatedRunner",
    "RoundStats",
    "CommStrategy",
    "CompressedGT",
    "FullSync",
    "GradientTracking",
    "LocalOnly",
    "QuantizedGT",
    "resolve_strategy",
    "HEADER_BYTES",
    "LeafPayload",
    "LeafSpec",
    "PackedTree",
    "decode_leaf",
    "encode_leaf",
    "measured_bytes_per_round",
    "wire_header_overhead",
]
