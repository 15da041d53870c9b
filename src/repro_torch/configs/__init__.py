"""Architecture registry: 10 assigned architectures + input shapes.

The port's own copy of `repro/configs` (pure data, the same names and
values), so that the port imports nothing of the JAX package."""
from .base import INPUT_SHAPES, ModelConfig, ShapeConfig
from .granite_34b import CONFIG as granite_34b
from .gemma2_2b import CONFIG as gemma2_2b
from .pixtral_12b import CONFIG as pixtral_12b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .llama4_maverick_400b_a17b import CONFIG as llama4_maverick_400b_a17b
from .starcoder2_7b import CONFIG as starcoder2_7b
from .granite_8b import CONFIG as granite_8b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    c.name: c
    for c in [
        granite_34b,
        gemma2_2b,
        pixtral_12b,
        hubert_xlarge,
        falcon_mamba_7b,
        llama4_scout_17b_a16e,
        llama4_maverick_400b_a17b,
        starcoder2_7b,
        granite_8b,
        zamba2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def supported_shapes(cfg: ModelConfig):
    """The (documented) subset of INPUT_SHAPES an architecture runs."""
    out = []
    for s in INPUT_SHAPES.values():
        if s.kind == "decode":
            if not cfg.supports_decode:
                continue
            if s.name == "long_500k" and not cfg.supports_long_context:
                continue
        out.append(s)
    return out


__all__ = [
    "ARCHS",
    "INPUT_SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "supported_shapes",
]
