"""Packed wire transport for compressed tracking corrections (port of
`repro/fed/transport.py`).

  LeafSpec      static layout of one packed leaf: rows (quantization
                groups), cols, kept-per-row k, bits, the chosen encoding
                and the index / scale widths.  `LeafSpec.build` is the one
                owner of the payload arithmetic: the strategies'
                `bytes_per_round` and the encoder's buffer shapes both
                derive from it, so priced bytes equal packed buffer
                lengths.
  LeafPayload   the packed buffers of one leaf: uint32 words (or raw
                values), uint16 / int32 indices, per-row scales.
  encode_leaf / decode_leaf
                pack one flattened [R, C] leaf / scatter it back to the
                dense correction, through the `pack_payload_2d` /
                `unpack_payload_2d` kernels (plain versions on CPU
                tensors); decode(encode(c)) is the dense compressed
                correction, bit for bit.
  PackedTree    what a wire-transport strategy returns from
                `transform_correction`; the engine calls its `decode()`.
  measured_bytes_per_round
                the bytes of the buffers `encode_leaf` really emits, next
                to the analytic price.

Quantization groups are the rows of the [R, C] layout: a per-agent leaf
of shape (.., d) contributes size // d rows of length d (vectors are one
row), each with its own max-abs scale.  Index width follows the row
length (uint16 up to 2^16 columns, int32 beyond).  Values are stored at
`ref.storage_bits(bits)` bits so that levels never straddle words.  Each
packed leaf also carries HEADER_BYTES of static metadata, priced apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..core.types import leaf_groups, tree_leaves
from ..kernels import ref
from ..kernels.pack_payload import pack_payload_2d, unpack_payload_2d

Pytree = Any

#: fixed per-leaf wire header: rows (u32) + cols (u32) + k (u32) +
#: bits/mode/encoding/index-width/scale-width/dtype tags (4 bytes)
HEADER_BYTES = 16


def wire_rows_cols(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """[rows, cols] wire layout of one per-agent leaf: last-axis rows are
    the quantization groups, vectors and scalars a single group."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return 1, max(1, int(shape[0]))
    return math.prod(int(d) for d in shape[:-1]), int(shape[-1])


def index_dtype_for(cols: int) -> torch.dtype:
    """Narrowest integer that indexes a row of `cols` columns: UNSIGNED
    16-bit up to 2^16 columns (a signed halfword would overflow past
    2^15), int32 beyond."""
    return torch.uint16 if cols <= 2 ** 16 else torch.int32


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static wire layout of one packed correction leaf."""

    rows: int
    cols: int
    k: int            # kept entries per row (== cols when not sparsifying)
    bits: int         # quantization grid width (>= 32: unquantized)
    mode: str         # "topk" | "randk" (does not affect bytes)
    dtype: torch.dtype  # leaf value dtype
    #: wire representation, the cheapest of: dense (the full row), sparse
    #: (k values + indices), quant (k bit-packed levels + indices + a
    #: scale per row), quant_dense (all levels bit-packed + a scale, no
    #: indices)
    encoding: str

    @classmethod
    def build(cls, shape, dtype, ratio: float, bits: int,
              mode: str = "topk") -> "LeafSpec":
        """Layout for one per-agent leaf of `shape` / `dtype` compressed at
        (`ratio`, `bits`), with the cheapest encoding by `wire_bytes`
        (ties go to dense).  `bits` < 32 quantizes the values whatever the
        encoding, so a leaf sent "sparse" or "dense" still carries
        quantized values at full storage width."""
        rows, cols = wire_rows_cols(tuple(shape))
        k = cols if ratio >= 1 else max(1, math.ceil(ratio * cols))
        candidates = ["dense"]
        if k < cols:
            candidates.append("sparse")
        if bits < 32:
            candidates.append("quant")
            if k < cols:
                candidates.append("quant_dense")
        base = cls(rows, cols, k, bits, mode, dtype, "dense")
        costs = {
            e: dataclasses.replace(base, encoding=e).wire_bytes()
            for e in candidates
        }
        encoding = min(costs, key=lambda e: (costs[e], e != "dense"))
        return dataclasses.replace(base, encoding=encoding)

    def stacked(self, m: int) -> "LeafSpec":
        """The same layout with m agents' rows stacked (the shape the
        strategies encode)."""
        return dataclasses.replace(self, rows=self.rows * m)

    @property
    def sparse(self) -> bool:
        return self.k < self.cols

    @property
    def index_dtype(self) -> torch.dtype:
        return index_dtype_for(self.cols)

    @property
    def scale_dtype(self) -> torch.dtype:
        return ref.compute_dtype(self.dtype)

    @property
    def words_per_row(self) -> int:
        n = self.cols if self.encoding == "quant_dense" else self.k
        return ref.word_layout(n, self.bits)[2]

    def wire_bytes(self) -> int:
        """Exact payload bytes of the packed buffers (no header)."""
        if self.encoding == "dense":
            return self.rows * self.cols * self.dtype.itemsize
        idx = self.rows * self.k * self.index_dtype.itemsize
        if self.encoding == "sparse":
            return self.rows * self.k * self.dtype.itemsize + idx
        scale = self.rows * self.scale_dtype.itemsize
        words = self.rows * 4 * self.words_per_row
        if self.encoding == "quant_dense":
            return words + scale
        return words + scale + (idx if self.sparse else 0)

    def total_bytes(self) -> int:
        return self.wire_bytes() + HEADER_BYTES


class LeafPayload(NamedTuple):
    """Packed buffers of one leaf.  indices is None for dense encodings
    (and for k == cols, where they are implicit); scales is None unless
    the values are bit-packed levels."""

    data: torch.Tensor
    indices: Optional[torch.Tensor]
    scales: Optional[torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.data, self.indices, self.scales)
            if a is not None
        )


def encode_leaf(
    c: torch.Tensor,  # [rows, cols] flattened leaf (feedback not injected)
    e: Optional[torch.Tensor],
    u_sel: Optional[torch.Tensor],
    u_rnd: Optional[torch.Tensor],
    spec: LeafSpec,
    *,
    use_kernel: bool = True,
) -> Tuple[LeafPayload, torch.Tensor]:
    """Pack one leaf.  Returns (payload, resid), resid = (c + e) -
    decode(payload) in c.dtype: the error-feedback update, the same as the
    dense compress path's.  `use_kernel=False` runs the plain version on
    any device."""
    kw = dict(k=spec.k, bits=spec.bits, mode=spec.mode, encoding=spec.encoding,
              index_dtype=spec.index_dtype)
    if use_kernel:
        data, idx, scale, resid = pack_payload_2d(
            c, e, u_sel, u_rnd, scale_dtype=spec.scale_dtype, **kw)
    else:
        data, idx, scale, resid = ref.pack_payload_ref(c, e, u_sel, u_rnd, **kw)
    keep_idx = spec.sparse and spec.encoding in ("sparse", "quant")
    keep_scale = spec.encoding in ("quant", "quant_dense")
    return (
        LeafPayload(data, idx if keep_idx else None,
                    scale if keep_scale else None),
        resid,
    )


def decode_leaf(payload: LeafPayload, spec: LeafSpec, *,
                use_kernel: bool = True) -> torch.Tensor:
    """Scatter the packed payload back to the dense [rows, cols]
    compressed correction (bitwise the chat that produced it, but for a
    kept -0.0, which lands as +0.0 as in JAX's scatter-add)."""
    data = payload.data
    rows = data.shape[0]
    idx = payload.indices
    if idx is None:  # dense, or k == cols: indices are implicit
        idx = torch.arange(spec.k, dtype=torch.int32,
                           device=data.device).expand(rows, spec.k).contiguous()
    scale = payload.scales
    if scale is None:
        scale = torch.zeros((rows, 1), dtype=spec.scale_dtype, device=data.device)
    kw = dict(cols=spec.cols, dtype=spec.dtype, k=spec.k, bits=spec.bits,
              encoding=spec.encoding)
    if use_kernel:
        return unpack_payload_2d(data, idx, scale, **kw)
    return ref.decode_payload_ref(data, idx, scale, **kw)


class PackedTree:
    """A correction pytree in wire format: what a wire-transport strategy
    returns from `transform_correction` instead of the dense tree.  The
    engine detects it by its `decode` hook and scatters the payloads back
    into dense [m, *leaf_shape] tensors before the local steps."""

    def __init__(self, payloads: List[LeafPayload], specs: List[LeafSpec],
                 unflatten: Callable, shapes: List[Tuple[int, ...]],
                 use_kernel: bool = True, headers: Optional[int] = None):
        self.payloads = payloads
        self.specs = specs
        self.unflatten = unflatten  # rebuilds the tree from its leaves
        self.shapes = shapes        # original [m, *leaf_shape] shapes
        self.use_kernel = use_kernel
        #: JAX's leaves, one header each: a model tree's layers of one
        #: pattern slot share their stacked leaf's (`core.types.leaf_groups`)
        self.headers = len(payloads) if headers is None else headers

    def decode(self) -> Pytree:
        return self.unflatten([
            decode_leaf(p, s, use_kernel=self.use_kernel).reshape(shape)
            for p, s, shape in zip(self.payloads, self.specs, self.shapes)
        ])

    def wire_bytes(self) -> int:
        """Actual packed buffer bytes across all leaves and agents."""
        return sum(p.nbytes for p in self.payloads)

    def total_bytes(self) -> int:
        return self.wire_bytes() + HEADER_BYTES * self.headers


# --------------------------------------------------------------------------
# measured bytes (actual packed buffer lengths, not the price)
# --------------------------------------------------------------------------
def probe_leaf_bytes(spec: LeafSpec) -> int:
    """One leaf's payload bytes, measured by running the plain encoder on a
    leaf of the spec's shape on `meta` (no data, so a production model's
    leaves cost nothing) and summing the buffers `encode_leaf` emits: the
    empirical check on `LeafSpec.wire_bytes` (the two must agree)."""
    c = torch.zeros((spec.rows, spec.cols), dtype=spec.dtype, device="meta")
    u = torch.zeros((spec.rows, spec.cols), dtype=torch.float64, device="meta")
    return encode_leaf(c, None, u, u, spec, use_kernel=False)[0].nbytes


def dense_payload_bytes(tree: Pytree) -> int:
    """Dense payload bytes of one model copy."""
    return sum(
        math.prod(u.shape) * u.dtype.itemsize for u in tree_leaves(tree)
    )


def measured_bytes_per_round(
    strategy, x: Pytree, y: Pytree, num_local_steps: int,
    *, include_headers: bool = True,
) -> int:
    """Per-agent wire bytes of one round, measured from the packed buffers
    the encoder emits (plus HEADER_BYTES per compressed leaf per direction
    unless disabled).  Dense strategies measure their analytic price; a
    compressor with the wire off moves dense masked corrections, so it
    measures at the dense gradient-tracking cost."""
    ratio = getattr(strategy, "_ratio", 1.0)
    bits = getattr(strategy, "_bits", 32)
    if ratio >= 1 and bits >= 32:
        return int(strategy.bytes_per_round(x, y, num_local_steps))
    # the engine casts corrections to correction_dtype before the
    # transform, so that is what moves
    cdt = getattr(strategy, "correction_dtype", None)
    leaves = tree_leaves((x, y))
    if not getattr(strategy, "wire_transport", False):
        corr = sum(math.prod(u.shape) * (cdt or u.dtype).itemsize
                   for u in leaves)
        return 2 * dense_payload_bytes((x, y)) + 2 * corr
    mode = getattr(strategy, "mode", "topk")
    payload = 0
    for u in leaves:
        spec = LeafSpec.build(tuple(u.shape), cdt or u.dtype, ratio, bits, mode)
        payload += probe_leaf_bytes(spec)
    header = wire_header_overhead(
        x, y, getattr(strategy, "layer_period", 0)) // 2
    # up: compressed correction + dense local model; down: compressed
    # global correction + dense averaged model
    total = 2 * dense_payload_bytes((x, y)) + 2 * payload
    if include_headers:
        total += 2 * header
    return int(total)


def wire_header_overhead(x: Pytree, y: Pytree, period: int = 0) -> int:
    """Fixed per-round header bytes: HEADER_BYTES per leaf per direction,
    JAX's leaves (a model x of a pattern of `period` slots holds one per
    stacked slot leaf, `core.types.leaf_groups`)."""
    return 2 * HEADER_BYTES * (len(leaf_groups(x, period)) + len(tree_leaves(y)))
