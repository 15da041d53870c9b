"""Pod-level wire payloads and pod / shard alignment of the two-level
aggregation tree (port of `repro/fed/pods.py`).

The pod tier sits between the agents and the server: active agents sum
into their pod's partial weighted sum (`core.engine.pod_weighted_sums`),
and each LIVE pod ships one partial payload to the server instead of the
server fanning in every agent.  This module owns the wire side of that
tier, on the packed transport (`fed.transport`):

  * `encode_pod_partials` packs the live pods' partial-sum rows as a
    `transport.PackedTree` with DENSE leaf specs (ratio 1, 32 bits): on
    CUDA tensors through the `pack_payload` kernel's dense encoding, and
    `decode_pod_partials` back through `unpack_payload`.  The dense round
    trip is bitwise, so shipping partials moves no values;
  * `pod_payload_bytes` prices one pod's traffic a round (partial up,
    broadcast down), priced equal to measured as every payload is
    (`sim.elastic.schedule_bytes` adds it for the pod edge);
  * `pod_aligned_shard_count` picks an agent-shard count that keeps whole
    pods inside single shards.
"""
from __future__ import annotations

from ..core.types import Pytree, tree_flatten, tree_leaves
from .transport import (
    LeafSpec,
    PackedTree,
    encode_leaf,
    probe_leaf_bytes,
    wire_header_overhead,
)


def pod_aligned_shard_count(num_pods: int, max_shards: int) -> int:
    """The largest shard count <= max_shards that divides `num_pods`, so
    every shard holds a whole number of pods (a run of quiet pods that
    spans a whole shard leaves that shard idle)."""
    if num_pods < 1 or max_shards < 1:
        raise ValueError(
            f"need num_pods >= 1 and max_shards >= 1, got {num_pods}, "
            f"{max_shards}")
    for d in range(min(num_pods, max_shards), 0, -1):
        if num_pods % d == 0:
            return d
    return 1


def encode_pod_partials(partials: Pytree, *, use_kernel: bool = True) -> PackedTree:
    """Pack per-pod partial aggregates (leaves with a leading pod axis,
    typically only the live pods' rows) into a `PackedTree` of dense
    payloads.  `use_kernel` (default) runs `pack_payload` on CUDA tensors
    (its plain version on CPU tensors); False runs the plain version on
    any device."""
    leaves, unflatten = tree_flatten(partials)
    payloads, specs, shapes = [], [], []
    for u in leaves:
        num_rows = u.shape[0]
        base = LeafSpec.build(tuple(u.shape[1:]), u.dtype, 1.0, 32)
        spec = base.stacked(num_rows)
        flat = u.reshape(num_rows * base.rows, base.cols)
        payload, _ = encode_leaf(flat, None, None, None, spec,
                                 use_kernel=use_kernel)
        payloads.append(payload)
        specs.append(spec)
        shapes.append(tuple(u.shape))
    return PackedTree(payloads, specs, unflatten, shapes, use_kernel=use_kernel)


def pod_payload_bytes(x: Pytree, y: Pytree, *, measured: bool = True,
                      period: int = 0) -> int:
    """Wire bytes of ONE live pod a round on the pod <-> server edge: the
    pod's partial aggregate up and the server's broadcast down, two dense
    (x, y) copies in packed framing (headers included, one per JAX leaf:
    `period`, a model x's pattern length, as `wire_header_overhead`).
    `measured=True`
    sums the buffers the encoder emits (`transport.probe_leaf_bytes`),
    False the spec's arithmetic; the two agree."""
    total = 0
    for u in tree_leaves((x, y)):
        spec = LeafSpec.build(tuple(u.shape), u.dtype, 1.0, 32)
        total += probe_leaf_bytes(spec) if measured else spec.wire_bytes()
    return 2 * total + wire_header_overhead(x, y, period)


def decode_pod_partials(tree: PackedTree) -> Pytree:
    """Inverse of `encode_pod_partials` (bitwise, dense specs), every leaf
    in one decode (one launch on the card)."""
    return tree.decode()
