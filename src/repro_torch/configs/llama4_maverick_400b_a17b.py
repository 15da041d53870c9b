"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

The gradient-tracking correction for this model is stored in float8_e4m3fn
(beyond-paper memory optimization, see DESIGN.md §4 and EXPERIMENTS §Perf):
with m=2 pod-agents the GT state would otherwise exceed v5e HBM.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("moe",),
    num_experts=128,
    top_k=1,
    rope_theta=5e5,
    fed_mode="B",
    correction_dtype="float8_e4m3fn",
    supports_decode=True,
    supports_long_context=False,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
