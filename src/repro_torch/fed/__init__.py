"""Federated layer of the port: the synchronous runner and the asynchronous
one (agent shards on their own devices and CUDA streams), communication
strategies (deterministic, client sampling, compressed, stochastic), noise
models, communication accounting, the packed wire transport and the pod
tier's payloads (`fed.pods`; the multi-host runtime is ROADMAP Queue 1
item 10)."""
from .async_runtime import AsyncFederatedRunner
from .comm import comm_table
from .noise import (
    GaussianNoise,
    MinibatchNoise,
    NoiseModel,
    noise_key,
    resolve_noise,
)
from .runtime import FederatedRunner, RoundStats
from .strategies import (
    SAGDA,
    CommStrategy,
    CompressedGT,
    FullSync,
    GradientTracking,
    LocalOnly,
    LocalSGDAPlus,
    PartialParticipation,
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
    "AsyncFederatedRunner",
    "FederatedRunner",
    "RoundStats",
    "CommStrategy",
    "CompressedGT",
    "FullSync",
    "GradientTracking",
    "LocalOnly",
    "LocalSGDAPlus",
    "PartialParticipation",
    "QuantizedGT",
    "SAGDA",
    "resolve_strategy",
    "GaussianNoise",
    "MinibatchNoise",
    "NoiseModel",
    "noise_key",
    "resolve_noise",
    "comm_table",
    "HEADER_BYTES",
    "LeafPayload",
    "LeafSpec",
    "PackedTree",
    "decode_leaf",
    "encode_leaf",
    "measured_bytes_per_round",
    "wire_header_overhead",
]
