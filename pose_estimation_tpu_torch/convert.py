"""JAX params and batch_stats -> PyTorch state_dict, and back.

Input: the flat dict of `save_params_npz` (pose_estimation_tpu/train/
checkpoint.py): '/'-joined module paths -> numpy arrays, and, for a
BatchNorm model (module.norm="bn"), its `batch_stats` tree flattened the
same way. The port's modules carry the flax names, so a key maps by
joining with '.' and converting the leaf by the module it belongs to:

  Conv_*/kernel           HWIO -> OIHW
  ConvTranspose_*/kernel  [kh, kw, in, out] -> flipped in both spatial
                          axes, [in, out, kh, kw] (see layers.ConvTranspose)
  Dense_*/kernel          [in, out] -> [out, in]
  GroupNorm_*/scale, BatchNorm_*/scale, LayerNorm_*/scale -> weight
  bias, directions, weights (3D-GCN raw params)   unchanged
  query|key|value|out/kernel (attention), EqualizedDense_*/kernel,
  prelu_alpha             unchanged, in flax's shapes: the attention
                          kernels [d, heads, head_dim] and [heads,
                          head_dim, d], EqualizedDense's [in, out], the
                          PReLU slope 0-d (an EqualizedConv's Conv_0 is a
                          Conv)
  BatchNorm_*/mean, BatchNorm_*/var (batch_stats) -> running_mean,
                          running_var (buffers)

The rule is by key and shape only, so it converts any parameter-shaped
tree the same way: gradients, Ranger's moments (mu, nu) and Lookahead's
slow weights (`tree_to_torch`). `flax_axis0_dim` says where flax's axis 0
of a leaf lands in the port's layout (gradient centralisation groups by
it, train/optim.py).
"""

from __future__ import annotations

import numpy as np
import torch


NORMS = ("GroupNorm_", "BatchNorm_", "LayerNorm_")
# leaves kept in flax's shape and name: the attention's DenseGeneral
# kernels, EqualizedDense's kernel
FLAX_SHAPED = ("query", "key", "value", "out", "EqualizedDense_")


def _leaf(module: str, leaf: str, value: np.ndarray):
    v = np.array(value, dtype=np.float32)
    if leaf == "kernel":
        if module.startswith(FLAX_SHAPED):
            return leaf, v
        if module.startswith("ConvTranspose_"):
            return "weight", np.ascontiguousarray(
                v[::-1, ::-1].transpose(2, 3, 0, 1))
        if module.startswith("Conv_"):
            return "weight", np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        if module.startswith("Dense_"):
            return "weight", np.ascontiguousarray(v.T)
    elif leaf == "scale" and module.startswith(NORMS):
        return "weight", v
    elif leaf in ("mean", "var") and module.startswith("BatchNorm_"):
        return f"running_{leaf}", v
    elif leaf in ("bias", "directions", "weights", "prelu_alpha"):
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
        if module.startswith(NORMS):
            return "scale", value
    elif name in ("running_mean", "running_var") and module.startswith(
            "BatchNorm_"):
        return name[len("running_"):], value
    elif name == "kernel" and module.startswith(FLAX_SHAPED):
        return name, value
    elif name in ("bias", "directions", "weights", "prelu_alpha"):
        return name, value
    raise KeyError(f"no conversion rule for {name!r} of {module!r}")


def torch_to_flax(state_dict: dict) -> dict[str, np.ndarray]:
    """state_dict (or named_parameters) -> '/'-joined flat leaves in the
    flax layout: the params of save_params_npz, and a BatchNorm's running
    statistics as its batch_stats leaves `mean` and `var`. The arrays are
    copies: a later in-place update of the model leaves them as they
    were."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        name, v = _leaf_back(parts[-2] if len(parts) > 1 else "", parts[-1],
                             value.detach().cpu().float().numpy())
        out["/".join(parts[:-1] + [name])] = np.array(v, order="C")
    return out


def flax_to_torch(flat: dict[str, np.ndarray],
                  model: torch.nn.Module | None = None,
                  batch_stats: dict[str, np.ndarray] | None = None
                  ) -> dict[str, torch.Tensor]:
    """Convert the flat params and, for a BatchNorm model, the flat
    batch_stats; with `model`, also hold the result to the model's
    state_dict key for key and shape: a key the model lacks, a model key
    left unfilled (a running statistic without `batch_stats` too), or a
    shape mismatch raises."""
    out = {}
    for key, value in {**flat, **(batch_stats or {})}.items():
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


def flax_trees(model: torch.nn.Module) -> tuple[dict, dict]:
    """The model as the JAX package's two flat trees: (params,
    batch_stats); batch_stats is empty without BatchNorm."""
    return (torch_to_flax(dict(model.named_parameters())),
            torch_to_flax(dict(model.named_buffers())))


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested mapping of arrays (flax params, gradients, optimizer
    moments) -> the '/'-joined flat dict of save_params_npz."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def tree_to_torch(tree) -> dict[str, torch.Tensor]:
    """Any parameter-shaped nested tree -> {port parameter name: tensor}."""
    return flax_to_torch(flatten_tree(tree))


def flax_axis0_dim(name: str) -> int:
    """The dim of the port's tensor `name` (a state_dict key) that holds
    flax's axis 0 of the same leaf: a conv kernel's row (HWIO -> OIHW, and
    the transposed conv's [in, out, kh, kw]) is dim 2, a Dense kernel's
    input is dim 1, everything else keeps its layout (the attention and
    EqualizedDense kernels are stored in flax's shapes: dim 0)."""
    parts = name.split(".")
    module = parts[-2] if len(parts) > 1 else ""
    if parts[-1] == "weight" and module.startswith(("Conv_",
                                                    "ConvTranspose_")):
        return 2
    if parts[-1] == "weight" and module.startswith("Dense_"):
        return 1
    return 0


def load_flax_params(model: torch.nn.Module, flat: dict,
                     batch_stats: dict | None = None) -> torch.nn.Module:
    """Convert strictly and load into `model` (in place)."""
    model.load_state_dict(flax_to_torch(flat, model, batch_stats),
                          strict=True)
    return model


def load_params_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return load_flax_params(model, flat)
