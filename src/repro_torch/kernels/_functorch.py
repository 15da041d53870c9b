"""What the model kernels' autograd Functions (`flash_attention`,
`ssm_scan`) share: whether a gradient may be asked of a call, and the
folding of a `torch.func.vmap` axis into the kernels' batch axis, so the
ctypes launches see plain tensors."""
from __future__ import annotations

from typing import Optional

import torch
from torch._C._functorch import is_functorch_wrapped_tensor


def traced(*ts) -> bool:
    """A gradient may be asked of a result on these inputs: one requires
    it, or one is a `torch.func` transform's wrapper (whose own
    `requires_grad` reads False)."""
    return any(is_functorch_wrapped_tensor(t) for t in ts) or (
        torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def fold(t: Optional[torch.Tensor], dim, n: int) -> Optional[torch.Tensor]:
    """A `vmap` rule's operand with the mapped axis (`dim`, None:
    unmapped, then repeated) folded into its batch axis, [n * B, ...]."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of `fold` on a result: [n * B, ...] -> [n, B, ...]."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])
