"""hubert-xlarge [audio] — encoder-only transformer over conv-codec frames
(frontend stubbed) [arXiv:2106.07447]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,  # full MHA
    head_dim=80,
    d_ff=5120,
    vocab_size=504,  # masked-unit targets
    pattern=("attn",),
    causal=False,  # bidirectional encoder
    frontend="audio",
    frontend_dim=512,
    fed_mode="A",
    supports_decode=False,  # encoder-only: no decode shapes
    supports_long_context=False,
    citation="arXiv:2106.07447",
)
