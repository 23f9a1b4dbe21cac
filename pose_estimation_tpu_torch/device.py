"""The device an entry point runs on: the card unless the caller asks for
the CPU. A missing card is an error, never a quiet fall back to the CPU.
Under a process group, "cuda" is this process's own card."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.parallel import dist


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device(name), raising when it names a CUDA card and there is
    none; a bare "cuda" under a process group is cuda:LOCAL_RANK."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: CUDA is not available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", dist.local_rank())
    return dev
