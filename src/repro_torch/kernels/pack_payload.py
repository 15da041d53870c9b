"""Fused wire-payload kernels: select + quantize + bit-pack, and back.

Port of `repro/kernels/pack_payload.py`.  They produce and consume the
packed wire format of `fed/transport.py`:

  pack_payload_2d      c [R, C] -> (data, idx, scale, resid): feedback
                       injection, exact-k selection, QSGD quantization,
                       ascending kept indices, uint32 bit-packing of the
                       levels, and the residual, one pass per row
                       (`csrc/pack_payload.cu`: one CTA per row, any row
                       length; a row that fits shared memory is staged
                       there, a longer one streams)
  unpack_payload_many  (data, idx, scale) of many leaves -> their dense
                       chat [R, cols]: word unpack, dequantization and the
                       scatter into a zero row, every leaf of one (device,
                       dtype) in one launch (`csrc/unpack_payload.cu`: a
                       table of leaves, each block one row's tile of
                       columns, assembled in shared memory and stored
                       once in 16-byte vectors); `unpack_payload_2d` is
                       its one-leaf case

Unpack's contract: a row's indices are unique, as every producer writes
them (`ref.pack_payload_ref`, the pack kernel, the implicit iota); an
index past the row is dropped, as JAX's scatter drops it.  The plain
version sums a repeated index; the kernel keeps one of them.

Both run their CUDA kernels on CUDA tensors and their plain versions
(`ref.pack_payload_ref`, `ref.decode_payload_ref`) on CPU tensors; every
output is bitwise equal between the two.  There is no fallback: a CUDA
tensor the kernels do not take raises.  `pack_payload_2d.launches` and
`unpack_payload_2d.launches` count kernel launches only, and
`unpack_payload_2d.leaf_decodes` the leaves those launches decoded.  On
DTensors (`_dtensor`) unpack runs on the local shards, rows sharded and
columns replicated; `pack_payload_2d` runs replicated, as a row's k is
chosen over the whole row.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import struct
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build, ref
from ._dtensor import is_dtensor, local_call, local_rows
from .compress_correction import (
    DTYPE_CODES,
    UNIFORM_CODES,
    check_leaf,
    quant_constants,
    stream_of,
)

#: encoding codes of the C launchers (`csrc/pack_payload.cu` `Encoding`)
ENCODING_CODES = {"quant": 0, "quant_dense": 1, "sparse": 2, "dense": 3}
INDEX_DTYPES = (torch.int32, torch.uint16)


def _library() -> ctypes.CDLL:
    lib = _build.load("pack_payload")
    if lib.pack_payload_launch.argtypes is None:
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.pack_payload_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i,
            i, i, d, d, p,
        ]
        lib.pack_payload_launch.restype = i
        lib.pack_payload_staged.argtypes = [i, i, i, i, i, i, i]
        lib.pack_payload_staged.restype = i
        lib.pack_payload_error_string.argtypes = [i]
        lib.pack_payload_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.pack_payload_error_string(err).decode())


def _check_encoding(name: str, encoding: str, bits: int) -> None:
    if encoding not in ENCODING_CODES:
        raise ValueError(f"{name}: unknown payload encoding {encoding!r}")
    if encoding in ("quant", "quant_dense") and bits >= 32:
        raise ValueError(f"{name}: bit-packing needs bits < 32")


def payload_data_shape(encoding: str, R: int, C: int, k: int, bits: int):
    """Shape of the `data` buffer of one [R, C] leaf with k kept per row."""
    if encoding in ("quant", "quant_dense"):
        n = C if encoding == "quant_dense" else k
        return (R, ref.word_layout(n, bits)[2])
    return (R, k) if encoding == "sparse" else (R, C)


@functools.lru_cache(maxsize=256)
def pack_staged(C: int, k: int, mode: str, encoding: str, words: int,
                dtype: torch.dtype, index_dtype: torch.dtype = torch.int32) -> bool:
    """Whether pack stages a row of C columns (k kept, `words` words of
    data) in shared memory on this card; a longer row streams from global
    memory, and its quant levels need a scratch row.  Needs the card."""
    got = _library().pack_payload_staged(
        int(C), int(k), int(mode == "topk"), ENCODING_CODES[encoding],
        int(index_dtype == torch.uint16), int(words), DTYPE_CODES[dtype])
    if got < 0:
        raise ValueError(f"pack_payload: no staging rule for C={C}, k={k}, "
                         f"{dtype}")
    return bool(got)


def pack_payload_2d(
    c: torch.Tensor,
    e: Optional[torch.Tensor],
    u_sel: Optional[torch.Tensor],
    u_rnd: Optional[torch.Tensor],
    *,
    k: int,
    bits: int = 32,
    mode: str = "topk",
    encoding: str = "quant",
    index_dtype: torch.dtype = torch.int32,
    scale_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(data, idx, scale, resid) of one [R, C] leaf, exactly as
    `ref.pack_payload_ref` returns them (see there); index_dtype is uint16
    or int32, and the scale is kept in the compute dtype."""
    k, bits = int(k), int(bits)
    us, ur = check_leaf("pack_payload", c, e, u_sel, u_rnd, k=k, bits=bits,
                        mode=mode)
    _check_encoding("pack_payload", encoding, bits)
    R, C = c.shape
    ct = ref.compute_dtype(c.dtype)
    if k > C:
        raise ValueError(f"pack_payload: k={k} exceeds the row length {C}")
    if index_dtype not in INDEX_DTYPES:
        raise TypeError(f"pack_payload: index dtype {index_dtype} is not "
                        "uint16 or int32")
    if scale_dtype not in (None, ct):
        raise TypeError(f"pack_payload: the scale is kept in {ct}, "
                        f"not {scale_dtype}")
    if is_dtensor(c, e):
        # replicated, as `compress_correction_2d` runs on DTensors
        return local_call(
            lambda c, e, us, ur: pack_payload_2d(
                c, e, us, ur, k=k, bits=bits, mode=mode, encoding=encoding,
                index_dtype=index_dtype, scale_dtype=scale_dtype),
            (c, e, u_sel, u_rnd), ({},) * 4, keep=(), out_maps=({},) * 4)
    if c.device.type == "cpu":
        return ref.pack_payload_ref(c, e, u_sel, u_rnd, k=k, bits=bits,
                                    mode=mode, encoding=encoding,
                                    index_dtype=index_dtype)
    if c.device.type != "cuda":
        raise ValueError(f"pack_payload: no kernel for device {c.device}")
    shape = payload_data_shape(encoding, R, C, k, bits)
    quant = encoding in ("quant", "quant_dense")
    data = torch.empty(shape, dtype=torch.uint32 if quant else c.dtype,
                       device=c.device)
    idx = torch.empty((R, k), dtype=index_dtype, device=c.device)
    scale = torch.empty((R, 1), dtype=ct, device=c.device)
    resid = torch.empty_like(c)
    if R == 0:
        return data, idx, scale, resid
    words = shape[1] if quant else 0
    # the quant levels of a row that streams are staged here
    scratch = (torch.empty((R, k), dtype=torch.uint32, device=c.device)
               if encoding == "quant"
               and not pack_staged(C, k, mode, encoding, words, c.dtype,
                                   index_dtype)
               else None)
    u = us if us is not None else ur
    s, inv_s = quant_constants(bits)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(c.device):
        err = lib.pack_payload_launch(
            c.data_ptr(), ptr(e), ptr(us), ptr(ur), data.data_ptr(),
            idx.data_ptr(), scale.data_ptr(), resid.data_ptr(), ptr(scratch),
            R, C, k, bits, int(mode == "topk"), ENCODING_CODES[encoding],
            int(index_dtype == torch.uint16), words, DTYPE_CODES[c.dtype],
            UNIFORM_CODES[u.dtype] if u is not None else 0, s, inv_s,
            stream_of(c),
        )
    _raise_on(lib, err, "pack_payload")
    pack_payload_2d.launches += 1
    return data, idx, scale, resid


pack_payload_2d.launches = 0


# ------------------------------------------------------------------ unpack
#: the unpack kernel's threads per block, leaves per launch and most output
#: bytes a block's tile holds (`csrc/unpack_payload.cu` kThreads, kLargeCap,
#: kTileBytes)
UNPACK_THREADS = 256
TABLE_CAP = 256
TILE_BYTES = 16384
#: the least output bytes of a tile where a leaf's rows are cut to fill the
#: SMs (a whole row is one tile where it is shorter), and a vector's bytes
MIN_TILE_BYTES = 512
VEC_BYTES = 16
#: one leaf of the launch table as the C launcher reads it (`Leaf`): data,
#: idx, scale, out, out's row stride, s, 1/s, rows, cols, k, bits,
#: encoding, uint16 indices, words, tile, tiles a row, blocks
_UNPACK_LEAF = "4Qqdd10i"

_unpack_lib = None
_sms: Dict[int, int] = {}


class UnpackSpec(NamedTuple):
    """The layout `unpack_payload_many` reads of one leaf; a
    `fed.transport.LeafSpec` carries the same fields and serves as one."""

    cols: int
    dtype: torch.dtype
    k: int
    bits: int = 32
    encoding: str = "quant"


def _unpack_library() -> ctypes.CDLL:
    global _unpack_lib
    if _unpack_lib is None:
        lib = _build.load("unpack_payload")
        fn = lib.unpack_payload_many_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.unpack_payload_error_string.argtypes = [ctypes.c_int]
        lib.unpack_payload_error_string.restype = ctypes.c_char_p
        for name, want in (("unpack_payload_table_capacity", TABLE_CAP),
                           ("unpack_payload_threads", UNPACK_THREADS),
                           ("unpack_payload_tile_bytes", TILE_BYTES)):
            got = getattr(lib, name)()
            if got != want:
                raise RuntimeError(f"unpack_payload: the library's {name} is {got}, "
                                   f"the wrapper's {want}")
        _unpack_lib = lib
    return _unpack_lib


def _sm_count(index: int) -> int:
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def unpack_tile(rows: int, cols: int, itemsize: int, sms: int) -> int:
    """Columns one block of the unpack kernel owns in a leaf of `rows` x
    `cols` values of `itemsize` bytes: a row cut into about sms // rows
    tiles, so that a few rows still fill the SMs ([16, 4096] f64 on 132
    SMs: 8 tiles of 512), each a whole number of 16-byte vectors of at
    least MIN_TILE_BYTES and at most TILE_BYTES; the whole row where that
    is shorter."""
    v = VEC_BYTES // itemsize
    want = -(-cols // max(1, sms // rows))
    tile = max(-(-want // v) * v, MIN_TILE_BYTES // itemsize)
    return min(tile, TILE_BYTES // itemsize, cols)


def plan_unpack(leaves: Sequence[tuple], sms: Callable[[object], int],
                cap: int = TABLE_CAP) -> List[Tuple[object, list]]:
    """The launches of one `unpack_payload_many` call: leaves = (key, data,
    idx, scale, out, out_stride, rows, cols, k, bits, encoding, idx_u16,
    words, itemsize) with key the (device, dtype) a launch holds and the
    pointers as ints (idx and scale 0 where null); sms(key) is the SM
    count of the key's device, which sizes its leaves' tiles.  Returns [(key,
    [record, ...])], one entry per launch: the leaves grouped by key in
    order of first appearance, each group cut into tables of at most
    `cap`; leaves without rows take no entry.  A record is the table's
    `_UNPACK_LEAF`."""
    groups: Dict[object, list] = {}
    for (key, data, idx, scale, out, stride, rows, cols, k, bits, encoding,
         idx_u16, words, itemsize) in leaves:
        if not rows:
            continue
        tile = unpack_tile(rows, cols, itemsize, sms(key))
        tiles = -(-cols // tile)
        s, inv_s = quant_constants(bits)
        groups.setdefault(key, []).append(
            (data, idx, scale, out, stride, s, inv_s, rows, cols, k, bits,
             ENCODING_CODES[encoding], idx_u16, words, tile, tiles, rows * tiles))
    return [(key, recs[i:i + cap]) for key, recs in groups.items()
            for i in range(0, len(recs), cap)]


@functools.lru_cache(maxsize=None)
def _unpack_table(count: int) -> struct.Struct:
    return struct.Struct("<" + _UNPACK_LEAF * count)


def _check_unpack(data, idx, scale, out, cols: int, dtype, k: int, bits: int,
                  encoding: str) -> None:
    _check_encoding("unpack_payload", encoding, bits)
    if dtype not in DTYPE_CODES:
        raise TypeError(f"unpack_payload: unsupported dtype {dtype}")
    R = data.shape[0]
    ct = ref.compute_dtype(dtype)
    want = payload_data_shape(encoding, R, cols, k, bits)
    wdt = torch.uint32 if encoding in ("quant", "quant_dense") else dtype
    if tuple(data.shape) != want or data.dtype != wdt:
        raise ValueError(f"unpack_payload: data must be {want} of {wdt}, got "
                         f"{tuple(data.shape)} of {data.dtype}")
    if idx is not None and (tuple(idx.shape) != (R, k) or idx.dtype not in INDEX_DTYPES):
        raise ValueError(f"unpack_payload: idx must be ({R}, {k}) uint16 or "
                         f"int32, got {tuple(idx.shape)} of {idx.dtype}")
    if scale is not None and (tuple(scale.shape) != (R, 1) or scale.dtype != ct):
        raise ValueError(f"unpack_payload: scale must be ({R}, 1) of {ct}")
    if any(t is not None and t.device != data.device for t in (idx, scale, out)):
        raise ValueError("unpack_payload: operands on different devices")
    if not all(t is None or t.is_contiguous() for t in (data, idx, scale)):
        raise ValueError("unpack_payload: operands must be contiguous")
    if out is not None and (tuple(out.shape) != (R, cols) or out.dtype != dtype
                            or (cols > 1 and out.stride(1) != 1)
                            or (R > 1 and out.stride(0) < cols)):
        raise ValueError(f"unpack_payload: out must be ({R}, {cols}) of {dtype} "
                         f"with unit column stride and rows that do not overlap, "
                         f"got {tuple(out.shape)} of {out.dtype}, strides "
                         f"{tuple(out.stride())}")


def unpack_payload_plain(data: torch.Tensor, idx: Optional[torch.Tensor],
                         scale: Optional[torch.Tensor], spec,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of one leaf of `unpack_payload_many`, on any
    device: `ref.decode_payload_ref` with the implicit iota and a zero
    scale made where they are null, copied into `out` where given."""
    R, k = data.shape[0], int(spec.k)
    if idx is None:
        idx = torch.arange(k, dtype=torch.int32, device=data.device).expand(R, k)
    if scale is None:
        scale = torch.zeros((R, 1), dtype=ref.compute_dtype(spec.dtype),
                            device=data.device)
    dense = ref.decode_payload_ref(data, idx, scale, cols=int(spec.cols),
                                   dtype=spec.dtype, k=k, bits=int(spec.bits),
                                   encoding=spec.encoding)
    return dense if out is None else out.copy_(dense)


def _launch_unpack(plan) -> None:
    lib = _unpack_library()
    for (index, dtype), recs in plan:
        table = _unpack_table(len(recs)).pack(*itertools.chain.from_iterable(recs))
        err = lib.unpack_payload_many_launch(table, len(recs), DTYPE_CODES[dtype], index,
                                             torch.cuda.current_stream(index).cuda_stream)
        if err != 0:
            raise RuntimeError("unpack_payload kernel launch failed: "
                               + lib.unpack_payload_error_string(err).decode())
        unpack_payload_2d.launches += 1
        unpack_payload_2d.leaf_decodes += len(recs)


def unpack_payload_many(
    datas: Sequence[torch.Tensor],
    idxs: Sequence[Optional[torch.Tensor]],
    scales: Sequence[Optional[torch.Tensor]],
    specs: Sequence,
    outs: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """The dense [R, cols] compressed correction of each packed leaf,
    bitwise equal to `ref.decode_payload_ref`; specs[i] holds the leaf's
    cols, dtype, k, bits and encoding (`UnpackSpec`, or a
    `fed.transport.LeafSpec`).

    idxs[i] None is the implicit iota (k == cols, or an encoding that
    carries no indices), scales[i] None a zero scale (an encoding that
    carries none).  Indices are unique within a row, as every producer
    writes them (`ref.pack_payload_ref`, the pack kernel, the iota); an
    index past the row is dropped.  The plain version sums a repeated
    index, the kernel keeps one of them: a repeat is outside the
    contract.  outs[i], where given, is the [R, cols] view (unit column
    stride, rows that do not overlap, any offset) the leaf is decoded into
    and returned.

    The CUDA leaves of one (device, dtype) go to one launch per table of
    `TABLE_CAP` leaves, whatever their encodings and specs; a CPU leaf
    runs the plain version.  DTensor leaves go in as their local shards,
    rows sharded and columns replicated, and come back as DTensors."""
    n = len(datas)
    outs = [None] * n if outs is None else list(outs)
    if not (len(idxs) == len(scales) == len(specs) == len(outs) == n):
        raise ValueError(f"unpack_payload_many: {n} data, {len(idxs)} idx, "
                         f"{len(scales)} scale, {len(specs)} specs and {len(outs)} out")
    result: List = [None] * n
    leaves, wraps = [], []
    for i in range(n):
        data, idx, scale, spec, out = datas[i], idxs[i], scales[i], specs[i], outs[i]
        cols, dtype, k, bits = int(spec.cols), spec.dtype, int(spec.k), int(spec.bits)
        encoding = spec.encoding
        _check_unpack(data, idx, scale, out, cols, dtype, k, bits, encoding)
        R = data.shape[0]
        if is_dtensor(data, idx, scale):
            if out is not None:
                raise ValueError("unpack_payload: DTensor leaves take no out rows")
            (data, idx, scale), wrap = local_rows((data, idx, scale), (R, cols))
            wraps.append((i, wrap))
            R = data.shape[0]
        if not data.is_cuda:
            if data.device.type != "cpu":
                raise ValueError(f"unpack_payload: no kernel for device {data.device}")
            result[i] = unpack_payload_plain(data, idx, scale, spec, out)
            continue
        if out is None:
            out = torch.empty((R, cols), dtype=dtype, device=data.device)
        result[i] = out
        leaves.append(((data.get_device(), dtype), data.data_ptr(),
                       0 if idx is None else idx.data_ptr(),
                       0 if scale is None else scale.data_ptr(), out.data_ptr(),
                       out.stride(0), R, cols, k, bits, encoding,
                       int(idx is not None and idx.dtype == torch.uint16),
                       data.shape[1] if encoding in ("quant", "quant_dense") else 0,
                       out.element_size()))
    if leaves:
        _launch_unpack(plan_unpack(leaves, lambda key: _sm_count(key[0])))
    for i, wrap in wraps:
        result[i] = wrap(result[i])
    return result


def unpack_payload_2d(
    data: torch.Tensor,
    idx: Optional[torch.Tensor],
    scale: Optional[torch.Tensor],
    *,
    cols: int,
    dtype: torch.dtype,
    k: int,
    bits: int = 32,
    encoding: str = "quant",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dense [R, cols] compressed correction of one packed leaf, bitwise
    equal to `ref.decode_payload_ref`: `unpack_payload_many`'s one-leaf
    case (see there for null idx / scale and `out`)."""
    return unpack_payload_many([data], [idx], [scale],
                               [UnpackSpec(cols, dtype, k, bits, encoding)],
                               None if out is None else [out])[0]


unpack_payload_2d.launches = 0
unpack_payload_2d.leaf_decodes = 0
