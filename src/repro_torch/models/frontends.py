"""Input batches of the text frontend (port of `repro/models/frontends.py`).

The audio and vision_text frontend stubs wait for a later slice (ROADMAP
Queue 1 item 12)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import not_ported


def _text_only(cfg: ModelConfig) -> None:
    if cfg.frontend != "text":
        raise not_ported(f"the {cfg.frontend} frontend ({cfg.name})", "Queue 1 item 12")


def batch_struct(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes and dtypes of one batch as meta tensors (JAX's
    ShapeDtypeStructs)."""
    _text_only(cfg)
    shape = (batch, seq_len)
    return {"tokens": torch.empty(shape, dtype=torch.long, device="meta"),
            "labels": torch.empty(shape, dtype=torch.long, device="meta")}


def random_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                 seq_len: int) -> dict:
    """Uniform random tokens and labels in [0, vocab) from `gen`, on
    `gen.device`."""
    _text_only(cfg)
    draw = lambda: torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                 generator=gen, device=gen.device)
    return {"tokens": draw(), "labels": draw()}
