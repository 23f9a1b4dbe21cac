"""Plain float32 TRPESNet and its training loss: the UNet (encoder
64-128-256-512-512, a colour decoder and a normal/depth trunk), the
completion heads, GeometryNet's per-channel points, DenseFusion at the
chosen pixels and the per-object quaternion / translation / confidence
heads; the confidence-weighted ADD(-S) over every point's hypothesis
(allocentric to egocentric, the symmetric objects' nearest-point
distance), the axis-symmetry rotation term and the normal, depth and
mask completion terms. The chosen pixels are a draw of `generator`, one
permutation of H*W for the batch, as the program draws them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import (
    FP32, Conv, Dense, Named, Norm, resize_bilinear, safe_norm,
    safe_normalize)
from portbench.reference.train import masked_mean, nearest_distance

_EPS = 1e-8


class DoubleConv(Named):
    def __init__(self, in_ch, features, mid=None, q=FP32):
        super().__init__()
        mid = mid or features
        self.child(Conv(in_ch, mid, 3, 1, False, q))
        self.child(Norm(mid, "gn", q))
        self.child(Conv(mid, features, 3, 1, False, q))
        self.child(Norm(features, "gn", q))

    def forward(self, x):
        x = torch.relu(self.Norm_0(self.Conv_0(x)))
        return torch.relu(self.Norm_1(self.Conv_1(x)))


class Down(Named):
    def __init__(self, in_ch, features, q):
        super().__init__()
        self.child(DoubleConv(in_ch, features, q=q))

    def forward(self, x):
        return self.DoubleConv_0(F.max_pool2d(x, 2, 2))


class Up(Named):
    def __init__(self, in_ch, features, q):
        super().__init__()
        self.q = q
        self.child(DoubleConv(in_ch, features, mid=in_ch // 2, q=q))

    def forward(self, x1, x2):
        x1 = self.q(resize_bilinear(x1, x2.shape[2], x2.shape[3]))
        return self.DoubleConv_0(torch.cat([x2, x1], dim=1))


class UNet(Named):
    def __init__(self, q):
        super().__init__()
        self.child(DoubleConv(3, 64, q=q))
        for cin, cout in ((64, 128), (128, 256), (256, 512), (512, 512)):
            self.child(Down(cin, cout, q))
        for cin, cout in ((1024, 256), (512, 128), (256, 64), (128, 64),
                          (1024, 256), (512, 128), (256, 64), (128, 64),
                          (256, 64), (128, 64)):
            self.child(Up(cin, cout, q))

    def forward(self, x):
        x1 = self.DoubleConv_0(x)
        x2 = self.Down_0(x1)
        x3 = self.Down_1(x2)
        x4 = self.Down_2(x3)
        x5 = self.Down_3(x4)
        c = self.Up_2(self.Up_1(self.Up_0(x5, x4), x3), x2)
        color = self.Up_3(c, x1)
        nd = self.Up_5(self.Up_4(x5, x4), x3)
        normal = safe_normalize(self.Up_7(self.Up_6(nd, x2), x1), dim=1)
        depth = self.Up_9(self.Up_8(nd, x2), x1)
        return color, normal, depth


class GeometryNet(Named):
    def __init__(self, in_ch, channels, q):
        super().__init__()
        self.child(Conv(in_ch, channels, 1, 1, True, q))

    def forward(self, feat, intrinsic, xmap, ymap, d_scale):
        dx = torch.relu(self.Conv_0(feat)) * d_scale[:, None, None, None]
        fx, fy, cx, cy = (intrinsic[:, i, None, None, None] for i in range(4))
        u, v = xmap[:, None], ymap[:, None]
        return torch.stack([(u - cx) * dx / fx, (v - cy) * dx / fy, dx], -1)


class DenseFusion(Named):
    def __init__(self, q):
        super().__init__()
        for _ in range(4):
            self.child(Dense(64, 64, q))
        for _ in range(4):
            self.child(Dense(64, 128, q))
        self.child(Dense(512, 1024, q))

    def forward(self, geom_emb, color_emb):
        first = [torch.relu(self.Dense_0(color_emb))] + [
            torch.relu(getattr(self, f"Dense_{1 + a}")(geom_emb[..., a]))
            for a in range(3)]
        second = [torch.relu(getattr(self, f"Dense_{4 + i}")(x))
                  for i, x in enumerate(first)]
        feat1, feat2 = torch.cat(first, -1), torch.cat(second, -1)
        x = torch.relu(self.Dense_8(feat2))
        return torch.cat([feat1, feat2, x.mean(dim=1, keepdim=True)
                          .expand_as(x)], -1)


class PosePredHead(Named):
    def __init__(self, num_obj, q):
        super().__init__()
        self.num_obj = num_obj
        self.branches = []
        for out in (4, 3, 1):
            layers, a = [], 1792
            for b in (640, 256, 128, num_obj * out):
                layers.append(self.child(Dense(a, b, q)))
                a = b
            self.branches.append((out, layers))

    def forward(self, apx, obj):
        outs = []
        for out, layers in self.branches:
            x = apx
            for layer in layers:
                x = layer(x)
            b, n, _ = x.shape
            x = x.reshape(b, n, self.num_obj, out)
            onehot = F.one_hot(obj.long(), self.num_obj).to(x.dtype)
            outs.append((x * onehot[:, None, :, None]).sum(2))
        return outs[0], outs[1], torch.sigmoid(outs[2])


class TRPESNet(Named):
    def __init__(self, schema: dict, q):
        super().__init__()
        self.num_points = schema["data"]["num_points"]
        self.num_obj = schema["module"]["num_cls"]
        self.child(UNet(q))
        self.child(Conv(64, 32, 1, 1, True, q))
        self.child(Conv(64, 32, 1, 1, True, q))
        self.child(Conv(32, 3, 1, 1, True, FP32))
        self.child(Conv(32, 1, 1, 1, True, FP32))
        self.child(Conv(192, 1, 1, 1, True, FP32))
        self.child(GeometryNet(192, 64, q))
        self.child(DenseFusion(q))
        self.child(PosePredHead(self.num_obj, q))

    def forward(self, batch, choose):
        img = batch["img"]
        color, normal_f, depth_f = self.UNet_0(img.permute(0, 3, 1, 2))
        n32 = self.Conv_0(normal_f)
        d32 = torch.relu(self.Conv_1(depth_f))
        feat1 = torch.cat([n32, d32, normal_f, depth_f], 1)
        pred_normal = self.Conv_2(n32)
        pred_depth = torch.relu(self.Conv_3(d32))
        pred_mask = torch.sigmoid(self.Conv_4(feat1))
        geom = self.GeometryNet_0(feat1, batch["intrinsic"], batch["xmap"],
                                  batch["ymap"], batch["d_scale"])
        color_emb = color.flatten(2)[:, :, choose].transpose(1, 2)
        geom_emb = geom.flatten(2, 3)[:, :, choose].transpose(1, 2)
        apx = self.DenseFusion_0(geom_emb, color_emb)
        quat, trans, conf = self.PosePredHead_0(apx, batch["obj"])
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {"quat": quat, "trans": trans, "conf": conf,
                "normal": nhwc(pred_normal), "depth": nhwc(pred_depth),
                "mask": nhwc(pred_mask)}


# -------------------------------------------------------------------- loss

def quat_to_matrix(q):
    q = q / torch.sqrt(torch.clamp(torch.sum(q * q, -1, keepdim=True),
                                   min=1e-16))
    q = torch.where(q[..., :1] < 0, -q, q)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def allo_to_ego(t, rot, eps=1e-4):
    """The egocentric rotation: the allocentric one turned by the rotation
    taking the optical axis onto the ray through `t`."""
    obj = t / torch.sqrt(torch.sum(t * t, -1, keepdim=True) + eps * eps)
    q = torch.stack([1.0 + obj[..., 2], -obj[..., 1], obj[..., 0],
                     torch.zeros_like(obj[..., 0])], -1)
    q = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + eps * eps)
    return quat_to_matrix(q) @ rot


def transparent_loss(pred, batch, weights, w_conf=0.015):
    quat, trans, conf = (pred[k].float() for k in ("quat", "trans", "conf"))
    b, n, _ = quat.shape
    base = allo_to_ego(trans, quat_to_matrix(quat))
    pts = (batch["model_points"][:, None] @ base.transpose(-1, -2)
           + trans[:, :, None, :])                         # [B, n, M, 3]
    target = batch["target"]
    direct = safe_norm(pts - target[:, None], dim=-1).mean(-1)
    chamfer = nearest_distance(pts.reshape(b, -1, 3), target).reshape(
        b, n, -1).mean(-1)
    dis = torch.where(batch["sym_mask"][:, None] > 0, chamfer, direct)
    c = conf[..., 0]
    loss_add = torch.mean(dis * c - w_conf * torch.log(c + _EPS))
    cols_pred = base.transpose(-1, -2)
    cols_gt = batch["r"].transpose(-1, -2)[:, None]
    cos = torch.sum(cols_pred * cols_gt, -1) / torch.clamp(
        torch.linalg.norm(cols_pred, dim=-1)
        * torch.linalg.norm(cols_gt, dim=-1), min=_EPS)
    loss_axis = torch.sum(batch["axis"][:, None, :] * (1.0 - cos), -1)
    loss_rot = torch.mean(c * loss_axis - w_conf * torch.log(c + _EPS))
    gt_n = batch["normal"]
    dot = torch.sum(pred["normal"] * gt_n, -1)
    cosmap = 1.0 - dot / torch.clamp(safe_norm(pred["normal"])
                                     * safe_norm(gt_n), min=1e-6)
    loss_n = masked_mean(cosmap, (gt_n != 0).any(-1).float())
    d = torch.abs(pred["depth"] - batch["depth"])
    loss_d = torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))
    loss_m = torch.mean(torch.abs(pred["mask"] - batch["mask"]))
    return (weights["distance"] * loss_add + weights["normal"] * loss_n
            + weights["depth"] * loss_d + weights["mask"] * loss_m
            + weights["rotation"] * loss_rot)


def loss_weights(schema: dict) -> dict:
    """The configuration's loss weights under the transparent loss's
    names."""
    lw = schema["train"]["loss"]
    return {"distance": lw["weight_pose"], "rotation": lw["weight_region"],
            "normal": lw["weight_normal"], "depth": lw["weight_xyz"],
            "mask": lw["weight_mask"]}
