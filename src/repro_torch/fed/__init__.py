"""Federated layer of the port: communication strategies and the packed
wire transport (the runtimes are ROADMAP Queue 1 items 3 and 10)."""
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
