"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    pattern=("mamba1",),
    ssm_state=16,
    d_inner=8192,  # 2 * d_model
    conv_width=4,
    fed_mode="A",
    supports_decode=True,
    supports_long_context=True,  # O(1) recurrent state
    citation="arXiv:2410.05355",
)
