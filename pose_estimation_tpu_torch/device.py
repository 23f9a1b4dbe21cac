"""The device an entry point runs on: the card unless the caller asks for
the CPU. A missing card is an error, never a quiet fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device(name), raising when it names a CUDA card and there is
    none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: CUDA is not available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    return dev
