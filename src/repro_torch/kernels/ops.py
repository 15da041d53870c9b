"""Public wrappers around the port's kernels (port of
`repro/kernels/ops.py`): the pytree `update_fn` over `gt_update`, and the
compressed-correction and wire-payload kernels the strategies call leaf
by leaf (`compress_correction_2d`, `pack_payload_2d`,
`unpack_payload_2d`)."""
from __future__ import annotations

from typing import Any, Callable

from ..core.types import tree_map
from .compress_correction import compress_correction_2d, compress_leaf
from .gt_update import gt_update
from .pack_payload import pack_payload_2d, unpack_payload_2d

__all__ = [
    "compress_correction_2d",
    "compress_leaf",
    "make_gt_update_fn",
    "pack_payload_2d",
    "unpack_payload_2d",
]

Pytree = Any


def make_gt_update_fn() -> Callable:
    """The kernel-backed `update_fn` of the round engine:
    update(z, g, c, eta, sign) applies `gt_update` leafwise.

    Unlike the JAX wrapper there is no padding to [rows, 128] (the kernel
    masks its own tail) and c is not cast up before the call: the kernel
    reads it in its stored type (bf16 / fp8), which is the point of the
    fusion."""

    def update(z: Pytree, g: Pytree, c: Pytree, eta, sign: float) -> Pytree:
        return tree_map(
            lambda u, gv, cv: gt_update(u, gv, cv, eta=float(eta), sign=sign),
            z, g, c,
        )

    return update
