"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref`):

  * gt_update — fused FedGDA-GT inner update (CUDA C++, `csrc/gt_update.cu`)
  * compress_correction_2d — feedback + exact-k select + QSGD + residual
    (CUDA C++, `csrc/compress_correction.cu`)
  * pack_payload_2d / unpack_payload_2d — the same select and quantize
    into packed wire buffers, and back (CUDA C++, `csrc/pack_payload.cu`)

The TPU kernels still to port are listed in ROADMAP.md (Queue 2)."""
from . import ref
from .compress_correction import compress_correction_2d, compress_leaf, fusable_leaf
from .gt_update import gt_update
from .ops import make_gt_update_fn
from .pack_payload import pack_payload_2d, unpack_payload_2d

__all__ = [
    "compress_correction_2d",
    "compress_leaf",
    "fusable_leaf",
    "gt_update",
    "make_gt_update_fn",
    "pack_payload_2d",
    "ref",
    "unpack_payload_2d",
]
