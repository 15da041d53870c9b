"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("moe",),
    num_experts=16,
    top_k=1,
    rope_theta=5e5,
    fed_mode="B",  # experts sharded over the data axis -> agents over pods
    supports_decode=True,
    supports_long_context=False,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
