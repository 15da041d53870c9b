"""Adversarial-embedding minimax objective for the assigned architectures
(port of `repro/problems/adversarial.py`).

The paper's robust-regression instantiation (Eq. 14) lifted to sequence
models:  min_params  max_{||delta|| <= eps}  (1/m) sum_i CE_i(params, delta)
where delta in R^{d_model} perturbs every input embedding (a universal
adversarial perturbation).  x = the model's tree of tensors
(`ModelParams.tree()`), y = {"delta": [d_model]}.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.projections import l2_ball_proj
from ..device import DeviceLike, resolve_device
from ..models import chunked_lm_loss, embed_inputs, forward

Pytree = Any


def make_adversarial_loss(
    cfg: ModelConfig,
    remat: bool = True,
    aux_weight: float = 0.0,
    use_kernel: bool = True,
    h_sharding=None,
):
    """Returns loss(params, y, batch) -> scalar for one agent's batch.
    use_kernel=False runs the flash-attention and scan kernels' plain
    versions (the yardstick the kernels' gradients are held to);
    h_sharding places h at every layer boundary (`forward`)."""

    def loss(params: Pytree, y: Dict, batch: Dict) -> torch.Tensor:
        h = embed_inputs(params, cfg, batch)
        h = h + y["delta"].to(h.dtype)
        h, _, aux = forward(params, cfg, h, remat=remat, use_kernel=use_kernel,
                            h_sharding=h_sharding)
        # labels are already next-token aligned by the data pipeline
        out = chunked_lm_loss(params, cfg, h, batch["labels"])
        if aux_weight:
            out = out + aux_weight * aux
        return out

    return loss


def init_delta(cfg: ModelConfig, dtype=torch.float32,
               device: DeviceLike = None) -> Dict:
    return {"delta": torch.zeros(cfg.d_model, dtype=dtype,
                                 device=resolve_device(device))}


def delta_projection(radius: float = 1.0):
    return l2_ball_proj(radius)
