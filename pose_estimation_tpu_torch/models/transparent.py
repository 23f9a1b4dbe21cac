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

The options the shipped config leaves off: use_transformer puts a
post-norm TransformerEncoderBlock after each head branch's 640 layer,
use_equalized swaps the head's Dense layers for EqualizedDense.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pose_estimation_tpu_torch.models.equalized import EqualizedDense
from pose_estimation_tpu_torch.models.layers import (
    Conv, Dense, LayerNorm, Named)
from pose_estimation_tpu_torch.models.unet import UNet


class DenseGeneral(nn.Module):
    """flax DenseGeneral as MultiHeadDotProductAttention uses it: [..,
    *in_shape] -> [.., *out_shape], its kernel [*in_shape, *out_shape] and
    bias [*out_shape] kept in flax's shapes, since gradient centralisation
    groups by flax's axis 0 (the model width for query / key / value,
    whose in_shape is (d,); the head for out, whose in_shape is (heads,
    head_dim))."""

    def __init__(self, in_shape, out_shape, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        fan_in = math.prod(in_shape)
        self.kernel = nn.Parameter(torch.randn(*in_shape, *out_shape)
                                   / fan_in ** 0.5)
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        self.n_in = len(in_shape)

    def forward(self, x):
        k = self.kernel.to(self.dtype)
        flat_in = math.prod(k.shape[:self.n_in])
        y = x.to(self.dtype).flatten(-self.n_in) @ k.reshape(flat_in, -1)
        return (y.unflatten(-1, self.bias.shape)
                + self.bias.to(self.dtype))


class MultiHeadDotProductAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention(num_heads, qkv_features=d)
    self-attention over [B, n, d], no mask, no dropout, computed as flax
    0.12 computes it in the compute dtype: q / sqrt(head_dim) (the root
    cast to the dtype) before q.k, the softmax in the dtype (exp, its sum
    and the quotient each rounded to it, force_fp32_for_softmax=False),
    then the weighted sum of the values and the out projection. Plain
    products and softmax: the JAX package runs attention in XLA, and these
    follow its roundings more closely than a fused call would."""

    def __init__(self, d, heads, dtype=torch.float32):
        super().__init__()
        hd = (heads, d // heads)
        self.query = DenseGeneral((d,), hd, dtype)
        self.key = DenseGeneral((d,), hd, dtype)
        self.value = DenseGeneral((d,), hd, dtype)
        self.out = DenseGeneral(hd, (d,), dtype)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, n, h, e]
        root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32)
        q = q / root.to(q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
        w = e / e.sum(-1, keepdim=True)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TransformerEncoderBlock(Named):
    """The JAX TransformerEncoderBlock, post-norm: x + self-attention,
    LayerNorm (eps 1e-6), x + Dense(dim_ff) -> relu -> Dense(d),
    LayerNorm."""

    def __init__(self, d_model, nhead, dim_ff=2048, dtype=torch.float32):
        super().__init__()
        self.child(MultiHeadDotProductAttention(d_model, nhead, dtype))
        self.child(LayerNorm(d_model, dtype))
        self.child(Dense(d_model, dim_ff, dtype))
        self.child(Dense(dim_ff, d_model, dtype))
        self.child(LayerNorm(d_model, dtype))

    def forward(self, x):
        x = self.LayerNorm_0(x + self.MultiHeadDotProductAttention_0(x))
        ff = self.Dense_1(torch.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + ff)


class GeometryNet(Named):
    """feat [B, C_in, H, W] -> per-channel points [B, C, H, W, 3]: depths
    dx = relu(conv1x1(feat)) * d_scale, back-projected with the crop's
    pixel-coordinate maps and zoomed intrinsics (fx, fy, cx, cy)."""

    def __init__(self, in_ch, channels=64, dtype=torch.float32):
        super().__init__()
        self.child(Conv(in_ch, channels, 1, 1, True, dtype))

    def depths(self, feat):
        return torch.relu(self.Conv_0(feat))

    def forward(self, feat, intrinsic, xmap, ymap, d_scale):
        dx = self.depths(feat) * d_scale[:, None, None, None]
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


def select_object(x, obj, num_obj, out):
    """[B, n, num_obj * out] -> [B, n, out]: the channels of each sample's
    object, selected by a one-hot contraction (a NaN in another object's
    channels reaches the output, as JAX's einsum lets it)."""
    b, n, _ = x.shape
    x = x.reshape(b, n, num_obj, out)
    onehot = torch.nn.functional.one_hot(obj.long(), num_obj).to(x.dtype)
    return (x * onehot[:, None, :, None]).sum(2)


class PosePredHead(Named):
    """apx [B, n, 1792], obj [B] -> quaternion [B, n, 4], translation
    [B, n, 3], confidence [B, n, 1]: per branch 640 -> 256 -> 128 ->
    num_obj x out (no activation between, as in the JAX head), the
    object's channels selected by select_object. use_transformer puts a
    TransformerEncoderBlock (8, 4 and 2 heads for the three branches)
    after the 640 layer and drops the 128 layer; use_equalized makes every
    Dense of the head an EqualizedDense (flax names them
    EqualizedDense_<n> in the same creation order)."""

    BRANCHES = ((4, 8), (3, 4), (1, 2))      # (outputs, attention heads)

    def __init__(self, num_obj, use_transformer=False, use_equalized=False,
                 dtype=torch.float32):
        super().__init__()
        self.num_obj = num_obj
        dense = EqualizedDense if use_equalized else Dense
        widths = (640, 256) if use_transformer else (640, 256, 128)
        self.branches = []
        for out, heads in self.BRANCHES:
            layers, a = [], 1792
            for i, b in enumerate(widths + (num_obj * out,)):
                layers.append(self.child(dense(a, b, dtype=dtype)))
                if use_transformer and i == 0:
                    layers.append(self.child(TransformerEncoderBlock(
                        640, heads, dtype=dtype)))
                a = b
            self.branches.append((out, layers))

    def forward(self, apx, obj):
        outs = []
        for out, layers in self.branches:
            x = apx
            for layer in layers:
                x = layer(x)
            outs.append(select_object(x, obj, self.num_obj, out))
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
        self.num_points, self.num_obj, self.dtype = num_points, num_obj, dtype
        self.child(UNet(dtype))
        self.child(Conv(64, 32, 1, 1, True, dtype))
        self.child(Conv(64, 32, 1, 1, True, dtype))
        self.child(Conv(32, 3, 1, 1, True, torch.float32))
        self.child(Conv(32, 1, 1, 1, True, torch.float32))
        self.child(Conv(192, 1, 1, 1, True, torch.float32))
        self.child(GeometryNet(192, 64, dtype))
        self.child(DenseFusion(dtype))
        self.child(PosePredHead(num_obj, use_transformer, use_equalized,
                                dtype))

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
