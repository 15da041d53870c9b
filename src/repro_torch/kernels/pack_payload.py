"""Fused wire-payload kernels: select + quantize + bit-pack, and back.

Port of `repro/kernels/pack_payload.py`.  They produce and consume the
packed wire format of `fed/transport.py`:

  pack_payload_2d    c [R, C] -> (data, idx, scale, resid): feedback
                     injection, exact-k selection, QSGD quantization,
                     ascending kept indices, uint32 bit-packing of the
                     levels, and the residual, one pass per row
  unpack_payload_2d  (data, idx, scale) -> the dense chat [R, cols]: word
                     unpack, dequantization and the scatter back into a
                     zero row

Both run the CUDA kernels of `csrc/pack_payload.cu` on CUDA tensors (one
CTA per row, any row length: a row that fits shared memory is staged
there, a longer one streams) and their plain versions
(`ref.pack_payload_ref`, `ref.decode_payload_ref`) on CPU tensors; every
output is bitwise equal between the two.  There is no fallback: a CUDA
tensor the kernels do not take raises.  `launches` on each wrapper counts
kernel launches only.  On DTensors (`_dtensor`) `unpack_payload_2d` runs
on the local shards, rows sharded and columns replicated; `pack_payload_2d`
runs replicated, as a row's k is chosen over the whole row.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, ref
from ._dtensor import is_dtensor, local_call
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
        lib.unpack_payload_launch.argtypes = [
            p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, d, d, p,
        ]
        lib.unpack_payload_launch.restype = i
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


def unpack_payload_2d(
    data: torch.Tensor,
    idx: torch.Tensor,
    scale: torch.Tensor,
    *,
    cols: int,
    dtype: torch.dtype,
    k: int,
    bits: int = 32,
    encoding: str = "quant",
) -> torch.Tensor:
    """The dense [R, cols] compressed correction of a packed payload,
    bitwise equal to `ref.decode_payload_ref`."""
    cols, k, bits = int(cols), int(k), int(bits)
    _check_encoding("unpack_payload", encoding, bits)
    if dtype not in DTYPE_CODES:
        raise TypeError(f"unpack_payload: unsupported dtype {dtype}")
    R = data.shape[0]
    ct = ref.compute_dtype(dtype)
    want = payload_data_shape(encoding, R, cols, k, bits)
    quant = encoding in ("quant", "quant_dense")
    if tuple(data.shape) != want or data.dtype != (torch.uint32 if quant else dtype):
        raise ValueError(f"unpack_payload: data must be {want} of "
                         f"{torch.uint32 if quant else dtype}, got "
                         f"{tuple(data.shape)} of {data.dtype}")
    if tuple(idx.shape) != (R, k) or idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"unpack_payload: idx must be ({R}, {k}) uint16 or "
                         f"int32, got {tuple(idx.shape)} of {idx.dtype}")
    if tuple(scale.shape) != (R, 1) or scale.dtype != ct:
        raise ValueError(f"unpack_payload: scale must be ({R}, 1) of {ct}")
    if not (data.device == idx.device == scale.device):
        raise ValueError("unpack_payload: operands on different devices")
    if not (data.is_contiguous() and idx.is_contiguous() and scale.is_contiguous()):
        raise ValueError("unpack_payload: operands must be contiguous")
    if is_dtensor(data, idx, scale):
        rows = {0: 0}
        return local_call(
            lambda d, i, s: unpack_payload_2d(d, i, s, cols=cols, dtype=dtype, k=k,
                                              bits=bits, encoding=encoding),
            (data, idx, scale), (rows,) * 3, keep=(0,), out_maps=(rows,),
            out_shapes=((R, cols),))
    if data.device.type == "cpu":
        return ref.decode_payload_ref(data, idx, scale, cols=cols, dtype=dtype,
                                      k=k, bits=bits, encoding=encoding)
    if data.device.type != "cuda":
        raise ValueError(f"unpack_payload: no kernel for device {data.device}")
    out = torch.empty((R, cols), dtype=dtype, device=data.device)
    if R == 0:
        return out
    s, inv_s = quant_constants(bits)
    lib = _library()
    with torch.cuda.device(data.device):
        err = lib.unpack_payload_launch(
            data.data_ptr(), idx.data_ptr(), scale.data_ptr(), out.data_ptr(),
            R, cols, k, bits, ENCODING_CODES[encoding],
            int(idx.dtype == torch.uint16), want[1] if quant else 0,
            DTYPE_CODES[dtype], s, inv_s, stream_of(data),
        )
    _raise_on(lib, err, "unpack_payload")
    unpack_payload_2d.launches += 1
    return out


unpack_payload_2d.launches = 0
