"""zamba2-7b [hybrid] — Mamba-2 backbone with a single SHARED attention block
applied every 6 layers [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,  # shared-block MLP dim (recorded; shared block here is attn)
    vocab_size=32000,
    pattern=("mamba2",),
    shared_attn_every=6,
    ssm_state=64,
    d_inner=7168,  # 2 * d_model
    head_p=64,
    conv_width=4,
    fed_mode="A",
    supports_decode=True,
    supports_long_context=True,  # SSM backbone; shared attn context-parallel
    citation="arXiv:2411.15242",
)
