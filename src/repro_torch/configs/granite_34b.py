"""granite-34b [dense] — llama-arch code model [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=("attn",),
    fed_mode="A",
    supports_decode=True,
    supports_long_context=False,  # pure full attention
    citation="arXiv:2405.04324",
)
