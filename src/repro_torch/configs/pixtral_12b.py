"""pixtral-12b [vlm] — pixtral-ViT frontend (stubbed) + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=("attn",),
    frontend="vision_text",
    num_patches=256,
    frontend_dim=1024,
    rope_theta=1e6,
    fed_mode="A",
    supports_decode=True,
    supports_long_context=False,
    citation="hf:mistralai/Pixtral-12B-2409",
)
