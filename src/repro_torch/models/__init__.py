"""The model zoo (port of `repro/models`): the forward path, the chunked
LM loss and remat; configs come from `repro_torch.configs`."""
from .frontends import batch_struct, random_batch
from .layers import cross_entropy
from .transformer import (
    ModelParams,
    checkpoint,
    chunked_lm_loss,
    embed_inputs,
    forward,
    init_caches,
    init_params,
    logits_from_hidden,
    num_params,
)

__all__ = [
    "ModelParams",
    "checkpoint",
    "chunked_lm_loss",
    "cross_entropy",
    "embed_inputs",
    "forward",
    "init_caches",
    "init_params",
    "logits_from_hidden",
    "num_params",
    "batch_struct",
    "random_batch",
]
