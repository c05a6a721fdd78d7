"""Where the port's entry points put their tensors: the card unless the
caller asks for the CPU, and never the CPU in silence; and which
process-group backend serves a device's collectives."""
from __future__ import annotations

import torch
import torch.distributed as dist

#: the process-group backend each device type's collectives run on
BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def resolve_device(device, what: str = "GraphDB") -> torch.device:
    """``torch.device`` of ``device``; raises for a CUDA device that this
    process cannot use (no silent move to the CPU).  ``what`` names the
    caller in the message."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def check_group_device(group, device: torch.device, what: str) -> None:
    """Raise unless ``group``'s backend serves tensors on ``device``
    (NCCL for ``cuda``, gloo for ``cpu``); nothing is staged through the
    host.  ``what`` names the caller in the message."""
    backend = str(dist.get_backend(group))
    want = BACKEND_FOR.get(torch.device(device).type)
    if backend != want:
        raise ValueError(
            f"{what}: tensors on {device} need a {want or 'supported'} "
            f"process group, this one is {backend!r}")
