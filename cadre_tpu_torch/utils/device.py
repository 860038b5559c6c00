"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a GPU raises, so
    nothing quietly carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA GPU; "
            "pass device='cpu' to run on the CPU")
    return dev
