"""TRPESNet, the transparent-object pose network of the UNet generation
(counterpart of models/transparent.py): UNet -> normal / depth / mask
completion heads; GeometryNet lifts a feature map to per-channel 3-D
points with the crop's intrinsics; DenseFusion joins colour and per-axis
geometry embeddings at the chosen pixels with a pooled global feature
(1792 channels); per-point quaternion / translation / confidence heads
with per-object output channels.

Inputs and outputs keep the JAX layouts: img [B, H, W, 3] NHWC, the
completion maps come back NHWC; inside, maps are NCHW. The pixels
`choose` [n] (flat ids into H*W, one set for the whole batch, as the
JAX model draws them) are an argument: None gives the eval stride
arange(n) * max(hw // n, 1) % hw; the train step draws
torch.randperm(hw)[:n] from its generator.

The transformer head (use_transformer) and the equalized layers
(use_equalized) are options the shipped config leaves off: they raise.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.models.layers import Conv, Dense, Named
from pose_estimation_tpu_torch.models.unet import UNet

NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 5)"


class GeometryNet(Named):
    """feat [B, C_in, H, W] -> per-channel points [B, C, H, W, 3]: depths
    dx = relu(conv1x1(feat)) * d_scale, back-projected with the crop's
    pixel-coordinate maps and zoomed intrinsics (fx, fy, cx, cy)."""

    def __init__(self, in_ch, channels=64, dtype=torch.float32):
        super().__init__()
        self.child(Conv(in_ch, channels, 1, 1, True, dtype))

    def forward(self, feat, intrinsic, xmap, ymap, d_scale):
        dx = torch.relu(self.Conv_0(feat)) * d_scale[:, None, None, None]
        fx, fy, cx, cy = (intrinsic[:, i, None, None, None] for i in range(4))
        u, v = xmap[:, None], ymap[:, None]
        return torch.stack([(u - cx) * dx / fx, (v - cy) * dx / fy, dx], -1)


class DenseFusion(Named):
    """geom_emb [B, n, C, 3], color_emb [B, n, 64] -> [B, n, 1792]: 64-wide
    colour and per-axis embeddings (256), 128-wide ones (512) and their
    1024-wide projection averaged over the points (1024)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for _ in range(4):
            self.child(Dense(64, 64, dtype))
        for _ in range(4):
            self.child(Dense(64, 128, dtype))
        self.child(Dense(512, 1024, dtype))

    def forward(self, geom_emb, color_emb):
        first = [torch.relu(self.Dense_0(color_emb))] + [
            torch.relu(getattr(self, f"Dense_{1 + a}")(geom_emb[..., a]))
            for a in range(3)]
        second = [torch.relu(getattr(self, f"Dense_{4 + i}")(x))
                  for i, x in enumerate(first)]
        feat1, feat2 = torch.cat(first, -1), torch.cat(second, -1)
        x = torch.relu(self.Dense_8(feat2))
        pooled = x.mean(dim=1, keepdim=True).expand_as(x)
        return torch.cat([feat1, feat2, pooled], -1)


class PosePredHead(Named):
    """apx [B, n, 1792], obj [B] -> quaternion [B, n, 4], translation
    [B, n, 3], confidence [B, n, 1]: per branch 640 -> 256 -> 128 ->
    num_obj x out (no activation between, as in the JAX head), the
    object's channels selected by a one-hot contraction (a NaN in another
    object's channels reaches the output, as JAX's einsum lets it)."""

    BRANCHES = (4, 3, 1)

    def __init__(self, num_obj, dtype=torch.float32):
        super().__init__()
        self.num_obj = num_obj
        for out in self.BRANCHES:
            for a, b in ((1792, 640), (640, 256), (256, 128),
                         (128, num_obj * out)):
                self.child(Dense(a, b, dtype))

    def forward(self, apx, obj):
        b, n, _ = apx.shape
        outs = []
        for i, out in enumerate(self.BRANCHES):
            x = apx
            for j in range(4):
                x = getattr(self, f"Dense_{4 * i + j}")(x)
            x = x.reshape(b, n, self.num_obj, out)
            onehot = torch.nn.functional.one_hot(
                obj.long(), self.num_obj).to(x.dtype)
            outs.append((x * onehot[:, None, :, None]).sum(2))
        rx, tx, cx = outs
        return rx, tx, torch.sigmoid(cx)


class TRPESNet(Named):
    """img [B, H, W, 3], intrinsic [B, 4] (fx, fy, cx, cy), xmap / ymap
    [B, H, W] the crop's pixel-coordinate maps, d_scale [B], obj [B],
    choose [n] or None -> (quat [B, n, 4], trans [B, n, 3], conf
    [B, n, 1], normal [B, H, W, 3], depth [B, H, W, 1], mask
    [B, H, W, 1]); the heads in `dtype`, the completion maps in fp32."""

    def __init__(self, num_points=500, num_obj=5, use_transformer=False,
                 use_equalized=False, dtype=torch.float32):
        super().__init__()
        if use_transformer:
            raise NotImplementedError(f"TRPESNet(use_transformer=True) "
                                      f"{NOT_PORTED}")
        if use_equalized:
            raise NotImplementedError(f"TRPESNet(use_equalized=True) "
                                      f"{NOT_PORTED}")
        self.num_points, self.num_obj, self.dtype = num_points, num_obj, dtype
        self.child(UNet(dtype))
        self.child(Conv(64, 32, 1, 1, True, dtype))
        self.child(Conv(64, 32, 1, 1, True, dtype))
        self.child(Conv(32, 3, 1, 1, True, torch.float32))
        self.child(Conv(32, 1, 1, 1, True, torch.float32))
        self.child(Conv(192, 1, 1, 1, True, torch.float32))
        self.child(GeometryNet(192, 64, dtype))
        self.child(DenseFusion(dtype))
        self.child(PosePredHead(num_obj, dtype))

    def forward(self, img, intrinsic, xmap, ymap, d_scale, obj, choose=None):
        b, h, w, _ = img.shape
        color, normal_f, depth_f = self.UNet_0(img.permute(0, 3, 1, 2))
        feat0 = torch.cat([normal_f, depth_f], 1)                  # 128
        n32 = self.Conv_0(normal_f)
        d32 = torch.relu(self.Conv_1(depth_f))
        feat1 = torch.cat([n32, d32, feat0], 1)                    # 192
        pred_normal = self.Conv_2(n32.float())
        pred_depth = torch.relu(self.Conv_3(d32.float()))
        pred_mask = torch.sigmoid(self.Conv_4(feat1.float()))
        geom = self.GeometryNet_0(feat1, intrinsic, xmap, ymap, d_scale)

        if choose is None:                       # the eval forward's stride
            choose = (torch.arange(self.num_points, device=img.device)
                      * max(h * w // self.num_points, 1) % (h * w))
        color_emb = color.flatten(2)[:, :, choose].transpose(1, 2)
        geom_emb = geom.flatten(2, 3)[:, :, choose].transpose(1, 2)
        apx = self.DenseFusion_0(geom_emb, color_emb)
        rx, tx, cx = self.PosePredHead_0(apx, obj)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return (rx, tx, cx, nhwc(pred_normal), nhwc(pred_depth),
                nhwc(pred_mask))
