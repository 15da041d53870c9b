"""Public wrappers around the port's kernels (port of
`repro/kernels/ops.py`): the pytree `update_fn` over `gt_update`, the
compressed-correction and wire-payload kernels the strategies call leaf
by leaf (`compress_correction_2d`, `pack_payload_2d`,
`unpack_payload_2d`), and the model layout's adapters over the attention
and scan kernels (`grouped_flash_attention`, `batched_ssm_scan`).

The model adapters take `use_kernel`: True runs the kernel wrapper (the
kernel on a CUDA tensor, its plain version on a CPU one), False the plain
version on any device."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..core.types import tree_map
from . import ref
from .compress_correction import compress_correction_2d, compress_leaf
from .flash_attention import flash_attention
from .gt_update import gt_update_many
from .pack_payload import pack_payload_2d, unpack_payload_2d
from .ssm_scan import plain_ssm_scan, ssm_scan

__all__ = [
    "batched_ssm_scan",
    "compress_correction_2d",
    "compress_leaf",
    "grouped_flash_attention",
    "make_gt_update_fn",
    "pack_payload_2d",
    "unpack_payload_2d",
]

Pytree = Any


def make_gt_update_fn() -> Callable:
    """The kernel-backed `update_fn` of the round engine:
    update(z, g, c, eta, sign) applies `gt_update` to every leaf of the
    tree in one launch (`gt_update_many`), and
    update.pair(xs, gx, cx, eta_x, ys, gy, cy, eta_y) -> (xs', ys') updates
    x (descent, sign -1) and y (ascent, +1) together, so that a local step
    is one launch.  The engine calls `pair` where its `update_fn` has one.

    Unlike the JAX wrapper there is no padding to [rows, 128] (the kernel
    masks its own tail) and c is not cast up before the call: the kernel
    reads it in its stored type (bf16 / fp8), which is the point of the
    fusion."""

    def run(parts) -> list:
        """parts: [(z, g, c, scale)] of trees; the updated z trees, from one
        `gt_update_many` call over all their leaves."""
        zs, gs, cs, scales = [], [], [], []
        for z, g, c, s in parts:
            def take(u, gv, cv, s=s):
                zs.append(u)
                gs.append(gv)
                cs.append(cv)
                scales.append(s)

            tree_map(take, z, g, c)
        outs = iter(gt_update_many(zs, gs, cs, scales))
        return [tree_map(lambda _: next(outs), z) for z, *_ in parts]

    def update(z: Pytree, g: Pytree, c: Pytree, eta, sign: float) -> Pytree:
        return run([(z, g, c, float(sign) * float(eta))])[0]

    def pair(xs: Pytree, gx: Pytree, cx: Pytree, eta_x, ys: Pytree, gy: Pytree,
             cy: Pytree, eta_y) -> Tuple[Pytree, Pytree]:
        xs1, ys1 = run([(xs, gx, cx, -1.0 * float(eta_x)),
                        (ys, gy, cy, 1.0 * float(eta_y))])
        return xs1, ys1

    update.pair = pair
    return update


def grouped_flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd] (model layout)
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention in the model's layout, out [B, Sq, H, hd].  The kernel
    reads the [B, S, heads, hd] tensors through transposed views and
    takes the KV heads as they are (JAX's adapter transposes and repeats
    them)."""
    if use_kernel:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = flash_attention(qt, kt, vt, causal=causal, window=window,
                              softcap=softcap)
        return out.transpose(1, 2)
    # on DTensors: query rows sharded, keys whole, so that no score is a
    # partial sum (the kernel's wrapper places its own operands)
    from ..models.placement import queries_local

    q, k, v = queries_local(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                  softcap=softcap)
    return out.transpose(1, 2)


def batched_ssm_scan(
    da: torch.Tensor,  # broadcastable to dbx
    dbx: torch.Tensor,  # [B, S, D, N] or [B, S, H, P, N]
    c_coef: torch.Tensor,  # [B, S, N]
    state0: Optional[torch.Tensor] = None,
    *,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the scan over a batch (`ssm_scan`'s batched
    layouts).  JAX's `batched_ssm_scan` vmaps the one-sequence kernel and
    returns y alone, from a zero state; here the kernel takes the batch
    itself, starts from `state0` and returns the final state too."""
    if dbx.dim() not in (4, 5):
        raise ValueError("batched_ssm_scan: dbx must be [B, S, D, N] or "
                         f"[B, S, H, P, N], got {tuple(dbx.shape)}")
    scan = ssm_scan if use_kernel else plain_ssm_scan
    return scan(da, dbx, c_coef, state0)
