"""Default-device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means CUDA.

    With no CUDA and no explicit device this raises: the port never falls
    back to the CPU quietly (pass `device="cpu"` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available and no device was given; pass "
            "device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported feature raises, naming the ROADMAP
    queue item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})"
    )


def host_to_device(t, device: DeviceLike) -> torch.Tensor:
    """A host array or CPU tensor on `device`: to a card through pinned
    memory and a non-blocking copy, so the host does not wait for the
    device's queue (a pageable copy synchronizes the stream)."""
    t = torch.as_tensor(t)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
