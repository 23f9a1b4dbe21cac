"""KRRN (counterpart of models/krrn.py).

HRNet backbone, the XYZ/NML decoder heads, the per-class channel select,
the pixel gather at `choose`, the fusion net (FusionNetLite by default,
the full FusionNet with fusion_variant="full"), the translation head and
(enable_rot) the two rotation heads.
Inputs and outputs keep the JAX layouts: x [B, H, W, 3] NHWC crop,
p_emb [B, N, 3] cloud, choose [B, N] flat pixel ids, cls [B]; maps come
back NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pose_estimation_tpu_torch.configs.schema import Config
from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.fusion import FusionNet, FusionNetLite
from pose_estimation_tpu_torch.models.hrnet import DEFAULT_STAGES, HRNet
from pose_estimation_tpu_torch.models.layers import (
    Conv, ConvNorm, ConvTransposeNorm, Named, upsample2x)
from pose_estimation_tpu_torch.models.posenet import (
    PoseNet, rot_mat_y_first, vertical_rot_vectors)


class XYZHead(Named):
    """1/4-res feature -> full-res map: deconv x2, conv, bilinear x2,
    2 convs, fp32 1x1 projection."""

    def __init__(self, in_ch, hidden, out_channels, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.child(ConvTransposeNorm(in_ch, hidden, 3, norm, dtype))
        for _ in range(3):
            self.child(ConvNorm(hidden, hidden, 3, 1, True, norm, dtype))
        self.child(Conv(hidden, out_channels, 1, 1, True, torch.float32))

    def forward(self, x):
        x = self.ConvNorm_0(self.ConvTransposeNorm_0(x))
        x = self.ConvNorm_2(self.ConvNorm_1(upsample2x(x)))
        return self.Conv_0(x)


class NMLHead(Named):
    """1/2-res feature -> full-res normal map: conv, conv, bilinear x2,
    conv, fp32 1x1 projection."""

    def __init__(self, in_ch, hidden, out_channels, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.child(ConvNorm(in_ch, hidden, 3, 1, True, norm, dtype))
        self.child(ConvNorm(hidden, hidden, 3, 1, True, norm, dtype))
        self.child(ConvNorm(hidden, hidden, 3, 1, True, norm, dtype))
        self.child(Conv(hidden, out_channels, 1, 1, True, torch.float32))

    def forward(self, x):
        x = self.ConvNorm_1(self.ConvNorm_0(x))
        return self.Conv_0(self.ConvNorm_2(upsample2x(x)))


def _select_class(maps: torch.Tensor, cls: torch.Tensor,
                  num_cls: int) -> torch.Tensor:
    """[B, H, W, num_cls*3] + [B] class ids -> [B, H, W, 3] (an exact
    selection, as the JAX one-hot contraction is)."""
    b, h, w, _ = maps.shape
    maps = maps.reshape(b, h, w, num_cls, 3)
    return maps[torch.arange(b, device=maps.device), :, :, cls.long()]


def _gather_pixels(maps: torch.Tensor, choose: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] + [B, N] flat pixel ids -> [B, N, C]."""
    b, h, w, c = maps.shape
    idx = choose.long()[..., None].expand(*choose.shape, c)
    return torch.gather(maps.reshape(b, h * w, c), 1, idx)


FUSION = {"lite": (FusionNetLite, 1280), "full": (FusionNet, 1664)}


class KRRN(Named):
    """KRRN; `dtype` is the activation dtype (bf16 for the shipped
    train.amp=True), params stay fp32. `fusion_variant` "lite" (the
    default) or "full" picks the fusion net and `enable_rot` adds the
    rotation heads, as the JAX KRRN's fields."""

    def __init__(self, cfg: Config, dtype=torch.float32,
                 fusion_variant: str = "lite", enable_rot: bool = False):
        super().__init__()
        if fusion_variant not in FUSION:
            raise ValueError(f"fusion_variant {fusion_variant!r}: 'lite' or "
                             "'full'")
        fusion_cls, fusion_width = FUSION[fusion_variant]
        m = cfg.module
        self.cfg, self.dtype = cfg, dtype
        num_cls = m.num_cls
        self.mask_outc = m.masknet.out * num_cls + 1
        self.region_outc = cfg.data.num_regions + 1
        xyz_outc = m.xyznet.out * num_cls
        nml_outc = m.nmlnet.out * num_cls
        outc = m.backbone_outc
        self.child(HRNet(3, outc, m.hrnet_stages or DEFAULT_STAGES,
                         m.stem_width, m.norm, dtype))
        self.child(XYZHead(outc, m.xyznet.hidden,
                           self.mask_outc + self.region_outc + xyz_outc,
                           m.norm, dtype))
        self.child(NMLHead(outc, m.nmlnet.hidden, nml_outc, m.norm, dtype))
        self.fusion_name = f"{fusion_cls.__name__}_0"
        self.child(fusion_cls(m.gcn3d.neighbor_num, m.gcn3d.support_num,
                              m.norm, dtype))
        self.child(PoseNet(fusion_width + num_cls, enable_rot,
                           m.posenet.out_t, m.norm, dtype, m.posenet.outc_r))

    def forward(self, x, p_emb, choose, cls, opt_pose: bool = True,
                train: bool = False, generator=None):
        """train=True draws the PoolLayer subsamples and the dropout masks
        from `generator` (flax's 'pool' and 'dropout' streams) and puts the
        model in training mode, so that BatchNorm normalises with the
        batch's statistics and moves its running ones; train=False is the
        deterministic eval forward, on the running statistics."""
        if self.training != train:
            super().train(train)
        num_cls = self.cfg.module.num_cls
        gen = generator if train else None
        mo, ro = self.mask_outc, self.region_outc
        feat_quarter, feat_half = self.HRNet_0(
            x.permute(0, 3, 1, 2).to(self.dtype))
        xyz_map = self.XYZHead_0(feat_quarter).permute(0, 2, 3, 1)
        nml_map = self.NMLHead_0(feat_half).permute(0, 2, 3, 1)
        xyz_sel = _select_class(xyz_map[..., mo + ro:], cls, num_cls)
        nml_sel = safe_normalize(_select_class(nml_map, cls, num_cls))
        xyz_emb = _gather_pixels(xyz_sel, choose)
        nml_emb = _gather_pixels(nml_sel, choose)
        pred_r = pred_t = t_res = None
        if opt_pose:
            feat = getattr(self, self.fusion_name)(p_emb, xyz_emb, nml_emb,
                                                   gen)
            onehot = F.one_hot(cls.long(), num_cls).to(feat.dtype)
            onehot = onehot[:, None, :].expand(*feat.shape[:2], num_cls)
            feat = torch.cat([feat, onehot], -1)
            green, red, t_res = self.PoseNet_0(feat, train, gen)
            pred_t = torch.mean(p_emb + t_res, dim=1)
            if green is not None:
                gv = safe_normalize(green[:, 1:], eps=1e-6)
                rv = safe_normalize(red[:, 1:], eps=1e-6)
                cg = torch.sigmoid(green[:, :1])
                cr = torch.sigmoid(red[:, :1])
                pred_r = rot_mat_y_first(*vertical_rot_vectors(cr, cg, rv,
                                                               gv))
        return {
            "xyz": xyz_sel,
            "region": xyz_map[..., mo:mo + ro],
            "mask": xyz_map[..., :mo],
            "normal": nml_sel,
            "xyz_emb": xyz_emb,
            "pred_r": pred_r,
            "pred_t": pred_t,
            "t_res": t_res,
        }
