"""The model zoo's forward path (port of `repro/models`): configs come
from `repro_torch.configs`; `chunked_lm_loss` waits for the training
slice."""
from .frontends import batch_struct, random_batch
from .transformer import (
    ModelParams,
    embed_inputs,
    forward,
    init_caches,
    init_params,
    logits_from_hidden,
    num_params,
)

__all__ = [
    "ModelParams",
    "embed_inputs",
    "forward",
    "init_caches",
    "init_params",
    "logits_from_hidden",
    "num_params",
    "batch_struct",
    "random_batch",
]
