"""Entry points of the port: `launch/serve.py` (the serving entry point),
`launch/train.py` (federated adversarial LM training) and
`launch/multihost.py` (the multi-host federated launch path:
`init_distributed`, `MultiHostRunner` and the packed-payload layout)."""
from .multihost import (
    MultiHostRunner,
    expected_gather_bytes,
    init_distributed,
    leaf_specs,
    payload_structs,
)

__all__ = [
    "MultiHostRunner",
    "expected_gather_bytes",
    "init_distributed",
    "leaf_specs",
    "payload_structs",
]
