"""Input batches of the three frontends (port of `repro/models/frontends.py`).

The [audio] and [vlm] architectures specify the transformer backbone
only: the conv feature extractor and the ViT are not implemented, as in
JAX.  These helpers give the precomputed frame / patch embeddings the
backbone consumes, as random tensors and as shapes (meta tensors)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def audio_frames(gen: torch.Generator, cfg: ModelConfig, batch: int,
                 seq_len: int, dtype=torch.float32) -> torch.Tensor:
    """Mel+conv-codec output stand-in: [B, S, frontend_dim] normals."""
    return torch.randn(batch, seq_len, cfg.frontend_dim, generator=gen,
                       device=gen.device, dtype=dtype)


def vision_patches(gen: torch.Generator, cfg: ModelConfig, batch: int,
                   dtype=torch.float32) -> torch.Tensor:
    """ViT/SigLIP patch embeddings stand-in: [B, num_patches,
    frontend_dim] normals."""
    return torch.randn(batch, cfg.num_patches, cfg.frontend_dim, generator=gen,
                       device=gen.device, dtype=dtype)


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens of a `seq_len` batch: all of it but for vision_text,
    whose patches come first."""
    if cfg.frontend != "vision_text":
        return seq_len
    if seq_len <= cfg.num_patches:
        raise ValueError(f"{cfg.name}: seq_len {seq_len} leaves no text after "
                         f"its {cfg.num_patches} patches")
    return seq_len - cfg.num_patches


def batch_struct(cfg: ModelConfig, batch: int, seq_len: int,
                 dtype=torch.float32) -> dict:
    """Shapes and dtypes of one training / prefill batch as meta tensors
    (JAX's ShapeDtypeStructs)."""
    meta = lambda *shape, dt=torch.long: torch.empty(shape, dtype=dt, device="meta")
    labels = meta(batch, seq_len)
    if cfg.frontend == "audio":
        return {"frames": meta(batch, seq_len, cfg.frontend_dim, dt=dtype),
                "labels": labels}
    out = {"tokens": meta(batch, text_len(cfg, seq_len))}
    if cfg.frontend == "vision_text":
        out["patches"] = meta(batch, cfg.num_patches, cfg.frontend_dim, dt=dtype)
    out["labels"] = labels
    return out


def random_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                 seq_len: int, dtype=torch.float32) -> dict:
    """A batch matching `batch_struct`, drawn from `gen` on `gen.device`:
    tokens and labels uniform in [0, vocab), frames and patches normal;
    vision_text labels are -1 (no target) on the patch positions."""
    draw = lambda s: torch.randint(0, cfg.vocab_size, (batch, s), generator=gen,
                                   device=gen.device)
    if cfg.frontend == "audio":
        frames = audio_frames(gen, cfg, batch, seq_len, dtype)
        return {"frames": frames, "labels": draw(seq_len)}
    out = {"tokens": draw(text_len(cfg, seq_len))}
    labels = draw(seq_len)
    if cfg.frontend == "vision_text":
        out["patches"] = vision_patches(gen, cfg, batch, dtype)
        labels[:, :cfg.num_patches] = -1
    out["labels"] = labels
    return out
