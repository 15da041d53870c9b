"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref`):

  * gt_update — fused FedGDA-GT inner update (CUDA C++, `csrc/gt_update.cu`)

The TPU kernels still to port are listed in ROADMAP.md (Queue 2)."""
from . import ref
from .gt_update import gt_update
from .ops import make_gt_update_fn

__all__ = ["gt_update", "make_gt_update_fn", "ref"]
