"""The serving comparison. After the window, with the program's objects
released, the fp32 reference runs each pool batch in blocks of rows:

- its forward from the batch (the HRNet backbone and heads, the pixel
  gather, FusionNetLite, the translation head) against the program's
  last forward of that batch: `xyz_gap`, the worst frame's RMS gap of the
  predicted model coordinates over the reference's RMS;
- its PnP-RANSAC with the batch's subsets on the program's own model
  coordinates (the solve cannot be compared on coordinates that differ
  by rounding: RANSAC on a network with seeded weights picks another
  hypothesis for the smallest change), against every request's poses:
  `rot_gap_deg`, `pnp_t_gap_mm` (the inlier counts are not compared: the
  control moves none of them);
- every request's regressed translation against the reference
  forward's: `pred_t_gap_mm`.

The control puts the reference in the program's place one precision
down: the forward in float8 e4m3 where the program runs bfloat16, the
solve on bfloat16 inputs where the program keeps float32 (TF32 products,
the step between, changed no pose at 256 frames a request: the solve's
products are too small for the tensor cores)."""

from __future__ import annotations

import torch

from portbench.reference.layers import Precision
from portbench.reference.solvers import pnp_ransac, rotation_deg
from portbench.weights import reference_model

BLOCK = 8                   # rows of a batch the reference runs at once
NUMBERS = ("xyz_gap", "pred_t_gap_mm", "rot_gap_deg", "pnp_t_gap_mm")


def _reference(cfg_file, weights, device, mode="fp32"):
    model = reference_model(cfg_file, Precision(mode))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


@torch.no_grad()
def forward(model, batch):
    """(xyz_emb, pred_t) of the reference, in blocks of rows."""
    xs, ts = [], []
    for r in range(0, batch["img"].shape[0], BLOCK):
        b = {k: v[r:r + BLOCK] for k, v in batch.items()}
        out = model(b["img"], b["cloud"], b["choose"], b["cls"])
        xs.append(out["xyz_emb"])
        ts.append(out["pred_t"])
    return torch.cat(xs), torch.cat(ts)


@torch.no_grad()
def solve(xyz_emb, batch, ev: dict, low: bool = False):
    """The serving solve: every stride-th chosen point (num_pnp_points of
    them), denormalised, then PnP-RANSAC on the batch's subsets; `low`
    rounds the solver's inputs to bfloat16 (the control)."""
    n = batch["choose"].shape[1]
    m = ev["num_pnp_points"]
    sel = torch.arange(m, device=xyz_emb.device) * max(n // m, 1) % n
    b = xyz_emb.shape[0]
    pw = (xyz_emb[:, sel].float() * batch["extent"].reshape(b, 1, 3)
          + batch["lf_border"].reshape(b, 1, 3))
    uv = batch["xy_choosed"][:, sel]
    if low:
        pw, uv = (t.to(torch.bfloat16).float() for t in (pw, uv))
    return pnp_ransac(pw, uv, batch["k"], batch["subset_ids"],
                      robust=ev["robust_refine"], top_k=ev["refine_top_k"])


def xyz_gap(xyz, ref):
    """Worst frame's RMS gap over the reference's RMS."""
    num = torch.sqrt(torch.mean((xyz.float() - ref) ** 2, dim=(1, 2)))
    den = torch.sqrt(torch.mean(ref ** 2, dim=(1, 2)))
    return float(torch.max(num / den))


def pose_gaps(poses: dict, solved: dict) -> dict:
    r = poses["pred_r"].to(solved["r"].device).float()
    return {
        "rot_gap_deg": float(rotation_deg(r, solved["r"]).max()),
        "pnp_t_gap_mm": float(torch.linalg.norm(
            poses["pnp_t"].to(solved["t"].device) - solved["t"],
            dim=-1).max() * 1e3)}


def _worst(acc: dict, new: dict):
    for k, v in new.items():
        if k not in acc or not acc[k] >= v:     # NaN is the worst
            acc[k] = v


def numbers(driver, limits=None) -> dict:
    """The numbers of a run: the program's outputs in driver.outputs and
    driver.forward_out against the reference."""
    dev, ev = driver.dev, driver.cfg_file["schema"]["eval"]
    ref = _reference(driver.cfg_file, driver.weights, dev)
    worst = {}
    for p, batch in enumerate(driver.pool):
        if p not in driver.forward_out:     # a batch no request has used
            continue
        b = {k: v.to(dev) for k, v in batch.items()}
        xyz_ref, t_ref = forward(ref, b)
        xyz_p, _ = driver.forward_out[p]
        if xyz_p.shape != xyz_ref.shape:    # rows left out or added
            _worst(worst, dict.fromkeys(NUMBERS, float("inf")))
            continue
        solved = solve(xyz_p, b, ev)
        _worst(worst, {"xyz_gap": xyz_gap(xyz_p, xyz_ref)})
        for q, host in driver.outputs:
            if q != p:
                continue
            gaps = pose_gaps(host, solved)
            gaps["pred_t_gap_mm"] = float(torch.linalg.norm(
                host["pred_t"].to(dev).float() - t_ref, dim=-1).max() * 1e3)
            _worst(worst, gaps)
    for k in NUMBERS:                       # nothing served reads no gap
        worst.setdefault(k, float("inf"))
    return worst


def control_numbers(driver) -> dict:
    """The same numbers with the reference one precision down in the
    program's place, on the driver's pool."""
    dev, ev = driver.dev, driver.cfg_file["schema"]["eval"]
    ref = _reference(driver.cfg_file, driver.weights, dev)
    low = _reference(driver.cfg_file, driver.weights, dev, "fp8")
    worst = {}
    for batch in driver.pool:
        b = {k: v.to(dev) for k, v in batch.items()}
        xyz_ref, t_ref = forward(ref, b)
        xyz_c, t_c = forward(low, b)
        out = solve(xyz_c, b, ev, low=True)
        poses = {"pred_r": out["r"], "pnp_t": out["t"]}
        gaps = pose_gaps(poses, solve(xyz_c, b, ev))
        gaps["xyz_gap"] = xyz_gap(xyz_c, xyz_ref)
        gaps["pred_t_gap_mm"] = float(torch.linalg.norm(
            t_c - t_ref, dim=-1).max() * 1e3)
        _worst(worst, gaps)
    return worst
