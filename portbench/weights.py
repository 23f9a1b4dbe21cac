"""Seeded weights for both sides: the leaves of the reference model of a
configuration (names and shapes), filled on the device from one
torch.Generator in one large draw. Normalisation scales are 1 and shifts
NORM_SHIFT; every other leaf is uniform in +-1/sqrt(fan-in), the fan-in
of a 3D-GCN leaf being its last dim.

The shift keeps most normalised activations off the relu's kink. With a
shift of 0 a random network of ~100 normalised layers is chaotic: a
rounding error of one layer flips relus downstream and grows until it
saturates, so that bfloat16 and float8 runs differ from float32 alike
(xyz 10% and 56% at a medium width on the CPU) and the comparison could
not tell a sound bfloat16 program from a float8 one; with 0.5 they part
by more than ten times (1.3% and 18%)."""

from __future__ import annotations

import math

import torch

from portbench import found
from portbench.reference.layers import GroupNorm, Precision
from portbench.reference.krrn import ConvLayer, ConvSurface

NORM_SHIFT = 0.5


def reference_model(cfg_file: dict, q: Precision) -> torch.nn.Module:
    return found.family(cfg_file["model"], "reference").reference_model(
        cfg_file, q)


def _bound(name: str, shape, kind: str) -> float | None:
    """None for a normalisation leaf (set to 1 or 0), else the uniform
    bound."""
    if kind == "norm":
        return None
    if kind == "gcn":
        return 1.0 / math.sqrt(shape[-1])
    if name.endswith("bias"):
        return 0.0
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(cfg_file: dict, seed: int, device) -> dict:
    """{name: fp32 tensor on `device`} for the configuration's model.
    A family whose normalisation or 3D-GCN leaves sit in modules of other
    classes names them in its reference half's `leaf_kinds(model)`
    ({leaf: "norm" or "gcn"})."""
    fam = found.family(cfg_file["model"], "reference")
    with torch.device("meta"):
        ref = fam.reference_model(cfg_file, Precision("fp32"))
    kinds = {f"{mn}.{pn}": ("norm" if isinstance(m, GroupNorm) else "gcn")
             for mn, m in ref.named_modules()
             if isinstance(m, (GroupNorm, ConvLayer, ConvSurface))
             for pn, _ in m.named_parameters(recurse=False)}
    if hasattr(fam, "leaf_kinds"):
        kinds.update(fam.leaf_kinds(ref))
    shapes = [(n, p.shape) for n, p in ref.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        b = _bound(name, shape, kinds.get(name, ""))
        if b is None:
            fill = 1.0 if name.endswith("weight") else NORM_SHIFT
            out[name] = torch.full(shape, fill, device=device)
        else:
            out[name] = flat[off:off + n].view(shape) * b
        off += n
    return out
