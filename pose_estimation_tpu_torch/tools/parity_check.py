"""Card-vs-CPU numerical parity of the port's solvers (counterpart of
tools/parity_check.py).

Runs the full EPnP, PnP-RANSAC (the batched solver at B = 1), Umeyama-
RANSAC and the rotation-representation round trips on the card and on
the CPU in one process, and reports the pose errors against the ground
truth per backend (rotation degrees, translation metres) and the
cross-backend deltas of their medians. The RANSAC subsets and the Umeyama
hypotheses are drawn once, on the CPU, and handed to both backends, so
that the deltas measure numerics, not two random streams. The solvers run
in fp32 with TF32 off (both flags printed).

  python -m pose_estimation_tpu_torch.tools.parity_check [--device cpu]

writes build/parity_check.json (PARITY.json is the JAX tool's). Without a
card it raises unless given --device cpu, which runs the CPU backend
alone.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def make_scenes(n_scenes: int, n_pts: int, noise_px: float,
                outlier_frac: float, seed: int = 0):
    """Noisy projective scenes with known gt pose (float64 host gen)."""
    rng = np.random.RandomState(seed)
    k = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]])
    scenes = []
    for _ in range(n_scenes):
        # random rotation via QR
        q, _ = np.linalg.qr(rng.randn(3, 3))
        r = q * np.sign(np.linalg.det(q))
        t = np.array([rng.uniform(-.1, .1), rng.uniform(-.1, .1),
                      rng.uniform(0.5, 1.2)])
        pw = rng.uniform(-0.06, 0.06, (n_pts, 3))
        pc = pw @ r.T + t
        uv = (pc @ k.T)
        uv = uv[:, :2] / uv[:, 2:3]
        uv += rng.randn(n_pts, 2) * noise_px
        uv_clean = uv.copy()            # noisy but outlier-free, for raw EPnP
        n_out = int(outlier_frac * n_pts)
        out_idx = rng.choice(n_pts, n_out, replace=False)
        uv[out_idx] += rng.uniform(-80, 80, (n_out, 2))
        scenes.append(dict(pw=pw, uv=uv, uv_clean=uv_clean, k=k, r=r, t=t))
    return scenes


RANSAC = dict(num_hypotheses=32, sample_size=6)
UMEYAMA = dict(num_hypotheses=128, sample_size=4)


def draw(scenes, seed: int = 100) -> list[dict]:
    """Scene i's RANSAC subsets [1, 32, 6] and Umeyama hypotheses
    [128, 4], from a CPU generator seeded seed + i."""
    from pose_estimation_tpu_torch.core.solvers.pnp import minimal_subsets
    out = []
    for i, s in enumerate(scenes):
        g = torch.Generator().manual_seed(seed + i)
        n = len(s["pw"])
        out.append({
            "subsets": minimal_subsets(g, torch.ones(1, n),
                                       RANSAC["sample_size"],
                                       RANSAC["num_hypotheses"]),
            "hypotheses": torch.randint(0, n, (UMEYAMA["num_hypotheses"],
                                               UMEYAMA["sample_size"]),
                                        generator=g)})
    return out


def _pose_errors(r_pred, t_pred, r_gt, t_gt):
    cos = (np.trace(r_pred.T @ r_gt) - 1.0) / 2.0
    deg = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    return deg, float(np.linalg.norm(t_pred - t_gt))


def _np(x):
    return x.detach().double().cpu().numpy()


def run_backend(device, scenes, draws, dtype=torch.float32) -> list[dict]:
    """Every solver on `device` for each scene; per-scene error rows."""
    from pose_estimation_tpu_torch.core.geometry.rotations import (
        axis_angle_to_matrix, matrix_to_axis_angle, matrix_to_ortho6d,
        matrix_to_quat, ortho6d_to_matrix, quat_to_matrix)
    from pose_estimation_tpu_torch.core.geometry.umeyama import (
        umeyama_ransac)
    from pose_estimation_tpu_torch.core.solvers.epnp import epnp
    from pose_estimation_tpu_torch.core.solvers.pnp import pnp_ransac

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    rows = []
    for i, s in enumerate(scenes):
        pw, k = t(s["pw"]), t(s["k"])
        re, te = epnp(pw, t(s["uv_clean"]), k)
        deg_e, tm_e = _pose_errors(_np(re), _np(te), s["r"], s["t"])
        out = pnp_ransac(pw[None], t(s["uv"])[None], k[None],
                         subset_ids=draws[i]["subsets"].to(device),
                         inlier_px=2.0, **RANSAC)
        deg_r, tm_r = _pose_errors(_np(out["r"][0]), _np(out["t"][0]),
                                   s["r"], s["t"])
        # rigid alignment parity: corrupt 20% correspondences
        dst = s["pw"] @ s["r"].T + s["t"]
        dst2 = dst.copy()
        n_bad = len(dst) // 5
        dst2[:n_bad] += np.random.RandomState(i).uniform(
            -0.3, 0.3, (n_bad, 3))
        ur, ut, _, _ = umeyama_ransac(None, pw, t(dst2),
                                      hypotheses=draws[i]["hypotheses"],
                                      **UMEYAMA)
        deg_u, tm_u = _pose_errors(_np(ur), _np(ut), s["r"], s["t"])
        r = t(s["r"])
        rr = (quat_to_matrix(matrix_to_quat(r)),
              axis_angle_to_matrix(matrix_to_axis_angle(r)),
              ortho6d_to_matrix(matrix_to_ortho6d(r)[None])[0])
        rows.append(dict(epnp_deg=deg_e, epnp_m=tm_e,
                         ransac_deg=deg_r, ransac_m=tm_r,
                         umeyama_deg=deg_u, umeyama_m=tm_u,
                         rot_roundtrip=max(float((e - r).abs().max())
                                           for e in rr)))
    return rows


def summarize(rows):
    out = {}
    for key in rows[0]:
        vals = np.array([r[key] for r in rows])
        out[key] = {"median": round(float(np.median(vals)), 6),
                    "max": round(float(vals.max()), 6)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--points", type=int, default=128)
    p.add_argument("--noise_px", type=float, default=1.0)
    p.add_argument("--outliers", type=float, default=0.25)
    p.add_argument("--out", default="build/parity_check.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card against the CPU; no card "
                        "raises) or cpu (the CPU alone)")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    print("tf32", json.dumps(tf32))

    scenes = make_scenes(args.scenes, args.points, args.noise_px,
                         args.outliers)
    draws = draw(scenes)
    backends = {"cpu_f32": torch.device("cpu")}
    if dev.type != "cpu":
        backends[f"{dev.type}_f32"] = dev

    report = {"config": vars(args), "tf32": tf32, "backends": {}}
    for name, d in backends.items():
        rows = run_backend(d, scenes, draws)
        report["backends"][name] = summarize(rows)
        print(name, json.dumps(report["backends"][name]))

    # cross-backend deltas on the summary level
    if len(report["backends"]) == 2:
        a, b = report["backends"].values()
        report["cross_backend_delta"] = {
            k: round(abs(a[k]["median"] - b[k]["median"]), 6) for k in a}
        print("cross_backend_delta",
              json.dumps(report["cross_backend_delta"]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
