"""Minimal pytree checkpointing, npz-based (port of
`repro/checkpoint/checkpoint.py`).

Layout: <dir>/ckpt_<step:08d>.npz, written to a temporary file and
published with `os.replace` (atomic), holding the leaves as `leaf_<i>`
and the tree's structure as JSON bytes under `structure`.  The reference
pickles a JAX treedef, which the port cannot read, so the port stores
its own structure: dicts (string keys), lists, tuples and None, with each
leaf's dtype and whether it lived on the CPU.  Leaves come back exactly:
bf16 and fp8 travel as their bits (uint16 / uint8 views), as in
`convert`.  The port does not read the reference's checkpoints.
"""
from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

Pytree = Any

#: torch dtypes numpy has no type for -> the same-width integer view
_BIT_VIEWS = {
    torch.bfloat16: torch.int16,
    torch.float8_e4m3fn: torch.uint8,
    torch.float8_e5m2: torch.uint8,
}


def _encode(tree: Pytree, arrays: dict) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        bad = [k for k in tree if not isinstance(k, str)]
        if bad:
            raise TypeError(f"checkpoint dict keys must be str, got {bad!r}")
        return {"dict": [[k, _encode(v, arrays)] for k, v in tree.items()]}
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return {"tuple": [_encode(v, arrays) for v in tree]}
    if isinstance(tree, list):
        return {"list": [_encode(v, arrays) for v in tree]}
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")
    t = tree.detach()
    name = f"leaf_{len(arrays)}"
    view = _BIT_VIEWS.get(t.dtype)
    bits = t.contiguous().view(view) if view is not None else t
    arrays[name] = bits.cpu().numpy()
    return {"leaf": name, "dtype": str(t.dtype).removeprefix("torch."),
            "cpu": t.device.type == "cpu"}


def _decode(node: Any, z, device: torch.device) -> Pytree:
    if node is None:
        return None
    if "dict" in node:
        return {k: _decode(v, z, device) for k, v in node["dict"]}
    if "tuple" in node:
        return tuple(_decode(v, z, device) for v in node["tuple"])
    if "list" in node:
        return [_decode(v, z, device) for v in node["list"]]
    dtype = getattr(torch, node["dtype"])
    t = torch.from_numpy(np.array(z[node["leaf"]], copy=True))
    if dtype in _BIT_VIEWS:
        t = t.view(dtype)
    return t if node["cpu"] else t.to(device)


def save_checkpoint(directory: str, step: int, tree: Pytree) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    arrays: dict = {}
    structure = json.dumps(_encode(tree, arrays)).encode()
    buf = io.BytesIO()
    np.savez(buf, structure=np.frombuffer(structure, dtype=np.uint8), **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic publish
    return path


def restore_checkpoint(path: str, device: DeviceLike = None) -> Pytree:
    """The tree saved at `path`, its leaves as tensors: a leaf saved from
    the CPU comes back on the CPU (the port keeps PRNG keys there), every
    other leaf on `device` (default CUDA; raises without CUDA unless a
    device is given)."""
    device = resolve_device(device)
    with np.load(path) as z:
        structure = json.loads(z["structure"].tobytes().decode())
        return _decode(structure, z, device)


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(directory, name))
    return best
