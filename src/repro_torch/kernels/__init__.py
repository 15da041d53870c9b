"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref`):

  * gt_update / gt_update_many — fused FedGDA-GT inner update, every leaf
    of a tree in one launch (CUDA C++, `csrc/gt_update.cu`)
  * compress_correction_2d — feedback + exact-k select + QSGD + residual
    (CUDA C++, `csrc/compress_correction.cu`)
  * pack_payload_2d / unpack_payload_2d — the same select and quantize
    into packed wire buffers, and back (CUDA C++, `csrc/pack_payload.cu`)
  * flash_attention — blocked online-softmax attention with causal /
    window masks, softcap and native GQA, on the tensor cores (CUDA C++,
    `csrc/flash_attention.cu`), differentiable through
  * flash_attention_bwd — its gradient in f32 (CUDA C++,
    `csrc/flash_attention_bwd.cu`)
  * ssm_scan — the Mamba selective scan, y and the final state (CUDA C++,
    `csrc/ssm_scan.cu`), differentiable through
  * ssm_scan_bwd — its gradient (CUDA C++, `csrc/ssm_scan_bwd.cu`)

Every TPU kernel of the JAX package has its counterpart here; the two
backward kernels have none (JAX differentiates its plain model path)."""
from . import ref
from .compress_correction import compress_correction_2d, compress_leaf, fusable_leaf
from .flash_attention import flash_attention, flash_attention_bwd
from .gt_update import gt_update, gt_update_many
from .ops import batched_ssm_scan, grouped_flash_attention, make_gt_update_fn
from .pack_payload import pack_payload_2d, unpack_payload_2d
from .ssm_scan import ssm_scan, ssm_scan_bwd

__all__ = [
    "batched_ssm_scan",
    "compress_correction_2d",
    "compress_leaf",
    "flash_attention",
    "flash_attention_bwd",
    "fusable_leaf",
    "grouped_flash_attention",
    "gt_update",
    "gt_update_many",
    "make_gt_update_fn",
    "pack_payload_2d",
    "ref",
    "ssm_scan",
    "ssm_scan_bwd",
    "unpack_payload_2d",
]
