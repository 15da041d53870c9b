"""Launch meshes over `torch.distributed` (port of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with JAX's axis
names.  `make_production_mesh` lays the production shapes over a world of
256 or 512 ranks: a real one, or the fake process group the dry-run
builds in one process (`launch.dryrun`).  `make_host_mesh` lays a small
mesh over the current world and, where no process group exists yet,
starts a one-process group itself (NCCL on a card, gloo on the CPU) on an
in-memory `HashStore`, so no TCP port is ever taken.

The rules below read only a mesh's axis names and sizes (`axis_sizes`),
so they also take a plain description of a mesh: an object with
`axis_names` and a `shape` dict, as the sharding tests pass for the
256- and 512-device meshes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..device import DeviceLike, resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order (a `DeviceMesh` or a description)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or of a description whose
    `shape` is that dict already."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (16, 16) over ("data", "model") = 256 ranks.
    Multi-pod:   (2, 16, 16) over ("pod", "data", "model") = 512 ranks.
    The default process group must hold that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device: DeviceLike = None):
    """A (data, model) mesh over the current world, on the card unless
    `device="cpu"`.  Without a process group it starts a one-process group
    (NCCL on a card, gloo on the CPU) on a `HashStore`; the world must then
    be data * model = 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(f"make_host_mesh: a ({data}, {model}) mesh needs "
                             f"a world of {data * model} ranks; start one first")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def fed_axes(mesh, fed_mode: str) -> Tuple[str, ...]:
    """Mesh axes that carry the federated agents."""
    names = axis_names(mesh)
    if fed_mode == "A":
        return tuple(a for a in ("pod", "data") if a in names)
    if fed_mode == "B":
        return tuple(a for a in ("pod",) if a in names)
    raise ValueError(fed_mode)


def agents_mesh(mesh, fed_mode: str):
    """The mesh a train step runs on: `mesh` itself, or where the agents
    lie over two mesh dims (mode A on the multi-pod mesh: ("pod",
    "data")), a 2-D mesh over the same ranks whose first dim, named
    "data", is those two flattened pod-major (JAX's order of the entries
    of a ("pod", "data") spec), beside "model".  The agent axis is then
    sharded on one mesh dim, as DTensor propagates it (a tensor dim split
    over two mesh dims defeats its view rules), and `pod_device_groups`
    gives the same contiguous rank groups.  A mesh description (no
    `DeviceMesh`) is returned as it is."""
    axes = fed_axes(mesh, fed_mode)
    if len(axes) < 2 or not hasattr(mesh, "mesh"):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    names = axis_names(mesh)
    rest = [a for a in names if a not in axes]
    ranks = mesh_ranks(mesh).permute([names.index(a) for a in axes + tuple(rest)])
    sizes = axis_sizes(mesh)
    shape = (num_agents(mesh, fed_mode),) + tuple(sizes[a] for a in rest)
    return DeviceMesh(mesh.device_type, ranks.reshape(shape),
                      mesh_dim_names=("data",) + tuple(rest))


def num_agents(mesh, fed_mode: str) -> int:
    sizes = axis_sizes(mesh)
    return max(math.prod(sizes[a] for a in fed_axes(mesh, fed_mode)), 1)


def mesh_ranks(mesh) -> torch.Tensor:
    """The mesh's ranks laid out in its shape: a `DeviceMesh`'s own, or
    row-major for a description (`init_device_mesh`'s layout)."""
    if hasattr(mesh, "mesh"):
        return mesh.mesh.to("cpu")
    sizes = axis_sizes(mesh)
    shape = [sizes[a] for a in axis_names(mesh)]
    return torch.arange(math.prod(shape)).reshape(shape)


def pod_device_groups(mesh, fed_mode: str, num_pods: int) -> List[List[int]]:
    """Map aggregation pods onto the mesh's federated axes: the ranks
    along `fed_axes` are split into `num_pods` contiguous groups (row-
    major over those axes), one group per pod.  Returns `num_pods` rank
    lists.  `num_pods` must divide the federated device count: more pods
    than federated devices is the simulation regime (a host-side segment
    sum) and is rejected."""
    axes = fed_axes(mesh, fed_mode)
    names = axis_names(mesh)
    if not axes:
        raise ValueError(f"mesh {names} has no federated axes in mode "
                         f"{fed_mode!r} to place pods on")
    order = [names.index(a) for a in axes] + [
        i for i, a in enumerate(names) if a not in axes]
    ranks = mesh_ranks(mesh).permute(order).reshape(num_agents(mesh, fed_mode), -1)
    n_fed = ranks.shape[0]
    if num_pods < 1 or n_fed % num_pods != 0:
        raise ValueError(f"num_pods={num_pods} must divide the federated device "
                         f"count {n_fed} (mesh {axis_sizes(mesh)}, mode {fed_mode!r})")
    per = n_fed // num_pods
    return [ranks[p * per:(p + 1) * per].reshape(-1).tolist()
            for p in range(num_pods)]
