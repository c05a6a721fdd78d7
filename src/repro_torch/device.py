"""Where the port's entry points put their tensors: the card unless the
caller asks for the CPU, and never the CPU in silence."""
from __future__ import annotations

import torch


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
