"""Synthetic token streams for LM training/serving paths (port of
`repro/data/tokens.py`).

Tokens are drawn from per-agent Zipfian distributions whose supports are
shifted per agent — this gives *controllable heterogeneity* analogous to the
paper's alpha knob in Section 5.2: `skew` rotates each agent's vocabulary so
local token marginals differ across agents.

The draw is seed-exact: `jax.random.categorical(key, logits, shape)` is
argmax(logits + Gumbel) over the vocabulary, the Gumbel noise
-log(-log(u)) of f32 uniforms u on [tiny, 1) (its default "low" mode),
and the uniforms here are JAX's bit for bit (`prng.uniform`).  Only the
two logs are torch's, not XLA's, so a draw whose best two scores lie
within an ulp or so of each other may pick the other token (the tests
count such flips).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..device import DeviceLike, resolve_device


def synthetic_lm_batch(
    key: torch.Tensor,
    batch: int,
    seq_len: int,
    vocab_size: int,
    skew: int = 0,
    zipf_a: float = 1.2,
    device: DeviceLike = None,
) -> dict:
    """Returns {tokens: [B,S] int32, labels: [B,S] int32} (labels = next
    token) on `device` (default CUDA), from the `prng` key `key`."""
    device = resolve_device(device)
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32, device=device)
    logits = -zipf_a * torch.log(ranks)
    tiny = float(np.finfo(np.float32).tiny)
    u = prng.uniform(key, (batch, seq_len + 1, vocab_size), torch.float32,
                     device, minval=tiny, maxval=1.0)
    gumbel = -torch.log(-torch.log(u))
    del u
    toks = torch.argmax(gumbel + logits, dim=-1)
    toks = (toks + skew) % vocab_size
    return {
        "tokens": toks[:, :-1].to(torch.int32),
        "labels": toks[:, 1:].to(torch.int32),
    }
