"""JAX params -> PyTorch state_dict.

Input: the flat dict of `save_params_npz` (pose_estimation_tpu/train/
checkpoint.py): '/'-joined module paths -> numpy arrays. The port's
modules carry the flax names, so a key maps by joining with '.' and
converting the leaf by the module it belongs to:

  Conv_*/kernel           HWIO -> OIHW
  ConvTranspose_*/kernel  [kh, kw, in, out] -> flipped in both spatial
                          axes, [in, out, kh, kw] (see layers.ConvTranspose)
  Dense_*/kernel          [in, out] -> [out, in]
  GroupNorm_*/scale       -> weight
  bias, directions, weights (3D-GCN raw params)   unchanged
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(module: str, leaf: str, value: np.ndarray):
    v = np.array(value, dtype=np.float32)
    if leaf == "kernel":
        if module.startswith("ConvTranspose_"):
            return "weight", np.ascontiguousarray(
                v[::-1, ::-1].transpose(2, 3, 0, 1))
        if module.startswith("Conv_"):
            return "weight", np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        if module.startswith("Dense_"):
            return "weight", np.ascontiguousarray(v.T)
    elif leaf == "scale" and module.startswith("GroupNorm_"):
        return "weight", v
    elif leaf in ("bias", "directions", "weights"):
        return leaf, v
    raise KeyError(f"no conversion rule for leaf {leaf!r} of {module!r}")


def _leaf_back(module: str, name: str, value: np.ndarray):
    """Inverse of _leaf."""
    if name == "weight":
        if module.startswith("ConvTranspose_"):
            return "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        if module.startswith("Conv_"):
            return "kernel", value.transpose(2, 3, 1, 0)
        if module.startswith("Dense_"):
            return "kernel", value.T
        if module.startswith("GroupNorm_"):
            return "scale", value
    elif name in ("bias", "directions", "weights"):
        return name, value
    raise KeyError(f"no conversion rule for {name!r} of {module!r}")


def torch_to_flax(state_dict: dict) -> dict[str, np.ndarray]:
    """state_dict -> the '/'-joined flat params of save_params_npz."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        name, v = _leaf_back(parts[-2] if len(parts) > 1 else "", parts[-1],
                             value.detach().cpu().float().numpy())
        out["/".join(parts[:-1] + [name])] = np.ascontiguousarray(v)
    return out


def flax_to_torch(flat: dict[str, np.ndarray],
                  model: torch.nn.Module | None = None
                  ) -> dict[str, torch.Tensor]:
    """Convert; with `model`, also hold the result to the model's
    state_dict key for key and shape: a key the model lacks, a model key
    left unfilled, or a shape mismatch raises."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        name, v = _leaf(parts[-2] if len(parts) > 1 else "", parts[-1], value)
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(v)
    if model is not None:
        want = model.state_dict()
        unused = sorted(set(out) - set(want))
        missing = sorted(set(want) - set(out))
        if unused or missing:
            raise KeyError(f"params do not match the model: unused "
                           f"{unused[:5]} ({len(unused)}), missing "
                           f"{missing[:5]} ({len(missing)})")
        for k, v in out.items():
            if tuple(want[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(want[k].shape)}")
    return out


def load_flax_params(model: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """Convert strictly and load into `model` (in place)."""
    model.load_state_dict(flax_to_torch(flat, model), strict=True)
    return model


def load_params_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return load_flax_params(model, flat)
