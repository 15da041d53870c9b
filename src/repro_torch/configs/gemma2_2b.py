"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "attn"),  # alternating sliding-window / global
    sliding_window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    fed_mode="A",
    supports_decode=True,
    # local layers bound the KV ring buffer; global layers run
    # context-parallel over the data axis at 500k
    supports_long_context=True,
    citation="arXiv:2408.00118",
)
