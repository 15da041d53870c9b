"""starcoder2-7b [dense] — GQA + RoPE code model [arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    pattern=("attn",),
    fed_mode="A",
    supports_decode=True,
    supports_long_context=False,
    citation="arXiv:2402.19173",
)
