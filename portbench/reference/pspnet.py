"""Plain float32 TransparentPoseNet, the PSPNet generation of the
transparent pipeline, and its training loss: a dilated ResNet18 of output
stride 8, PSP pyramid pooling to 1024 channels, three PSPUpsample
decoder branches (colour log-probabilities, normal, depth) with their
fused 192-channel map, the mask and boundary head, GeoNet's per-channel
back-projection, PointFeatNet's 2816-wide DenseFusion features at the
chosen pixels and PosePredNet's per-object quaternion / translation /
confidence heads; the transparent loss of reference/trpesnet.py plus the
boundary term.

The reference repository's model is PoseNet in
version/transparent/lib/networks/network.py:296-367 (backbone.py,
resnet.py), after DenseFusion (arXiv:1901.04780). This file departs from
it where the measured program does, and nowhere else:

- GroupNorm (32 groups, eps 1e-6) in the ResNet, not BatchNorm
  (the configuration's `module.norm` is "gn");
- 'SAME' padding as XLA pads (an even input at stride 2 pads (0, 1)),
  the stem's max-pool padded alike with -inf;
- the pyramid averages windows of (h // size, w // size) at that stride
  and drops the remainder, not adaptive average pooling;
- every bilinear resize has half-pixel centres;
- dropout is element-wise, as flax's nn.Dropout: x / keep_prob where
  the mask keeps, 0 elsewhere, keep_prob in x's precision (the
  reference's decoder follows DenseFusion's PSPNet, whose drops are
  whole channels);
- the pixels are `choose` [B, n], each sample's drawn with replacement
  outside the forward (network.py:339-342 draws inside it), and the
  decoder's seven masks are drawn after them from the same generator
  (`draws`);
- the mask and boundary are one two-channel 1x1 convolution with a
  sigmoid.

`q` is the rounding wherever the program casts to its activation dtype
(reference/layers.py: Precision("fp32") rounds nothing). Where the
program stays in float32 under bfloat16 activations, so does this
model: each decoder branch from its first PReLU on (its scalar
`prelu_alpha` is float32, so the product and the select are), the
branches' later dropouts and resizes, the colour, normal, depth and mask
convolutions, the fused map and the back-projection."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    FP32, Conv, ConvNorm, Dense, Named, Norm, resize_bilinear, same_pads,
    safe_normalize, upsample2x)
from portbench.reference.trpesnet import loss_weights as _weights
from portbench.reference.trpesnet import transparent_loss as _loss

# the decoder's dropout rates in the order the masks are drawn and used:
# the 0.3 one on the PSP map before the colour branch, then two in each
# of the three branches
DROPOUT_RATES = (0.3,) + (0.15,) * 6
PSP_SIZES = (1, 2, 3, 6)
TERMS = ("distance", "rotation", "normal", "depth", "mask")


def feature_size(size: int) -> int:
    """The backbone's output side for an input side of `size`: the stem,
    the max-pool and the second stage each halve it, rounding up."""
    for _ in range(3):
        size = -(-size // 2)
    return size


def dropout_shapes(b: int, h: int, w: int) -> list:
    """NCHW shapes of the seven dropout masks for b crops of h x w."""
    fh, fw = feature_size(h), feature_size(w)
    return [(b, 1024, fh, fw)] + [(b, 256, 2 * fh, 2 * fw),
                                  (b, 64, 4 * fh, 4 * fw)] * 3


def draws(gen, b: int, h: int, w: int, n: int) -> tuple:
    """The training draws from `gen`, in this order: the pixels [b, n],
    each sample's n drawn with replacement from H*W, then the seven keep
    masks, each kept with probability 1 - rate."""
    dev = gen.device
    choose = torch.randint(0, h * w, (b, n), generator=gen, device=dev)
    masks = [torch.rand(s, generator=gen, device=dev) < 1.0 - r
             for s, r in zip(dropout_shapes(b, h, w), DROPOUT_RATES)]
    return choose, masks


def dropout(x, keep, rate: float, q):
    """x / keep_prob where `keep`, else 0, the quotient and keep_prob
    rounded by `q`; `keep` None: no dropout."""
    if keep is None:
        return x
    p = q(torch.tensor(1.0 - rate, device=x.device))
    return torch.where(keep, q(x / p), torch.zeros_like(x))


class DilatedConv(Conv):
    """Conv with 'SAME' padding over a kernel dilated by `dilation`."""

    def __init__(self, in_ch, out_ch, kernel, stride, dilation, q):
        super().__init__(in_ch, out_ch, kernel, stride, False, q)
        self.dilation = dilation

    def forward(self, x):
        q = self.q
        x = q(x)
        ph = same_pads(x.shape[2], self.kernel, self.stride, self.dilation)
        pw = same_pads(x.shape[3], self.kernel, self.stride, self.dilation)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return q(F.conv2d(x, q(self.weight), None, self.stride, 0,
                          self.dilation))


class ResNetBlock(Named):
    def __init__(self, in_ch, features, stride, dilation, q):
        super().__init__()
        self.q = q
        self.child(DilatedConv(in_ch, features, 3, stride, dilation, q),
                   "Conv")
        self.child(Norm(features, "gn", q))
        self.child(DilatedConv(features, features, 3, 1, dilation, q),
                   "Conv")
        self.child(Norm(features, "gn", q))
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.child(ConvNorm(in_ch, features, 1, stride, False, "gn", q))

    def forward(self, x):
        y = torch.relu(self.Norm_0(self.Conv_0(x)))
        y = self.Norm_1(self.Conv_1(y))
        res = self.ConvNorm_0(x) if self.project else x
        return torch.relu(self.q(y + res))


class ResNet18Stride8(Named):
    STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))

    def __init__(self, q):
        super().__init__()
        self.child(ConvNorm(3, 64, 7, 2, True, "gn", q))
        c = 64
        for f, s, d in self.STAGES:
            self.child(ResNetBlock(c, f, s, d, q))
            self.child(ResNetBlock(f, f, 1, d, q))
            c = f

    def forward(self, x):
        x = self.ConvNorm_0(x)
        ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                               value=float("-inf")), 3, 2)
        for i in range(2 * len(self.STAGES)):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        return x


class PSPModule(Named):
    def __init__(self, in_ch, out_features, q):
        super().__init__()
        self.q = q
        for _ in PSP_SIZES:
            self.child(Conv(in_ch, in_ch, 1, 1, False, q))
        self.child(Conv(in_ch * (len(PSP_SIZES) + 1), out_features, 1, 1,
                        True, q))

    def forward(self, x):
        h, w = x.shape[2:]
        priors = []
        for i, size in enumerate(PSP_SIZES):
            ph, pw = h // size, w // size
            pooled = self.q(F.avg_pool2d(x, (ph, pw), (ph, pw)))
            priors.append(self.q(resize_bilinear(
                getattr(self, f"Conv_{i}")(pooled), h, w)))
        priors.append(x)
        return torch.relu(getattr(self, f"Conv_{len(PSP_SIZES)}")(
            torch.cat(priors, 1)))


class PSPUpsample(Named):
    """x2 bilinear, a 3x3 convolution, PReLU with the float32 scalar
    `prelu_alpha`, whose result is float32."""

    def __init__(self, in_ch, features, q):
        super().__init__()
        self.child(Conv(in_ch, features, 3, 1, True, q))
        self.prelu_alpha = nn.Parameter(torch.empty(()))

    def forward(self, x):
        x = self.Conv_0(upsample2x(x))
        return torch.where(x >= 0, x, self.prelu_alpha * x)


class PSPDecoder(Named):
    def __init__(self, q):
        super().__init__()
        self.q = q
        for _ in range(3):
            self.child(PSPUpsample(1024, 256, q))
            self.child(PSPUpsample(256, 64, q))
            self.child(PSPUpsample(64, 64, q))
        self.child(Conv(64, 32, 1, 1, True, FP32))
        self.child(Conv(128, 32, 1, 1, True, q))
        self.child(Conv(128, 32, 1, 1, True, q))
        self.child(Conv(64, 3, 1, 1, True, FP32))
        self.child(Conv(64, 1, 1, 1, True, FP32))

    def forward(self, p, masks=None):
        keep = list(masks) if masks is not None else [None] * 7
        rates = list(DROPOUT_RATES)

        def branch(i, x):
            for j in range(2):
                x = getattr(self, f"PSPUpsample_{3 * i + j}")(x)
                x = dropout(x, keep.pop(0), rates.pop(0), FP32)
            return getattr(self, f"PSPUpsample_{3 * i + 2}")(x)

        c = branch(0, dropout(p, keep.pop(0), rates.pop(0), self.q))
        color = torch.log_softmax(self.Conv_0(c), dim=1)
        f1 = torch.cat([branch(1, p), branch(2, p)], 1)            # 128
        f2 = torch.cat([self.Conv_1(f1), torch.relu(self.Conv_2(f1))], 1)
        normal = safe_normalize(self.Conv_3(f2), dim=1)
        depth = torch.relu(self.Conv_4(f2))
        return color, normal, depth, torch.cat([f1, f2], 1)        # 192


class GeoNet(Named):
    """feat [B, 192, H, W] -> [B, 32, H, W, 3]: depths from two 1x1
    convolutions with ReLU (64, 32), times d_scale, back-projected per
    channel with the crop's pixel maps and zoomed intrinsics."""

    def __init__(self, q):
        super().__init__()
        self.child(Conv(192, 64, 1, 1, True, q))
        self.child(Conv(64, 32, 1, 1, True, q))

    def forward(self, feat, intrinsic, xmap, ymap, d_scale):
        dx = torch.relu(self.Conv_1(torch.relu(self.Conv_0(feat))))
        dx = dx * d_scale[:, None, None, None]
        fx, fy, cx, cy = (intrinsic[:, i, None, None, None] for i in range(4))
        u, v = xmap[:, None], ymap[:, None]
        return torch.stack([(u - cx) * dx / fx, (v - cy) * dx / fy, dx], -1)


class PointFeatNet(Named):
    """geom_emb [B, n, 32, 3], color_emb [B, n, 32] -> [B, n, 2816]."""

    def __init__(self, q):
        super().__init__()
        self.q = q
        for _ in range(4):
            self.child(Dense(32, 64, q))
        for _ in range(4):
            self.child(Dense(64, 128, q))
        self.child(Dense(512, 1024, q))
        self.child(Dense(1024, 2048, q))

    def forward(self, geom_emb, color_emb):
        first = [torch.relu(self.Dense_0(color_emb))] + [
            torch.relu(getattr(self, f"Dense_{1 + a}")(geom_emb[..., a]))
            for a in range(3)]
        second = [torch.relu(getattr(self, f"Dense_{4 + i}")(x))
                  for i, x in enumerate(first)]
        x = torch.relu(self.Dense_9(torch.relu(self.Dense_8(
            torch.cat(second, -1)))))
        pooled = self.q(x.mean(dim=1, keepdim=True)).expand_as(x)
        return torch.cat(first + second + [pooled], -1)


class PosePredNet(Named):
    """apx [B, n, 2816], obj [B] -> quaternion, translation, confidence:
    per branch 640 -> 256 -> 128 -> num_obj x out, ReLU after each but
    the last, the object's channels, the confidence's sigmoid."""

    def __init__(self, num_obj, q):
        super().__init__()
        self.num_obj, self.q = num_obj, q
        self.branches = []
        for out in (4, 3, 1):
            layers, a = [], 2816
            for f in (640, 256, 128, num_obj * out):
                layers.append(self.child(Dense(a, f, q)))
                a = f
            self.branches.append((out, layers))

    def forward(self, apx, obj):
        outs = []
        for out, layers in self.branches:
            x = apx
            for layer in layers[:-1]:
                x = torch.relu(layer(x))
            x = layers[-1](x)
            b, n, _ = x.shape
            x = x.reshape(b, n, self.num_obj, out)
            onehot = F.one_hot(obj.long(), self.num_obj).to(x.dtype)
            outs.append((x * onehot[:, None, :, None]).sum(2))
        return outs[0], outs[1], self.q(torch.sigmoid(outs[2]))


class TransparentPoseNet(Named):
    def __init__(self, schema: dict, q):
        super().__init__()
        self.num_points = schema["data"]["num_points"]
        self.num_obj = schema["module"]["num_cls"]
        self.child(ResNet18Stride8(q))
        self.child(PSPModule(512, 1024, q))
        self.child(PSPDecoder(q))
        self.child(Conv(192, 2, 1, 1, True, FP32))
        self.child(GeoNet(q))
        self.child(PointFeatNet(q))
        self.child(PosePredNet(self.num_obj, q))

    def forward(self, batch, choose, masks=None):
        img = batch["img"]
        f = self.ResNet18Stride8_0(img.permute(0, 3, 1, 2))
        color, normal, depth, f3 = self.PSPDecoder_0(self.PSPModule_0(f),
                                                     masks)
        mask = torch.sigmoid(self.Conv_0(f3))
        geom = self.GeoNet_0(f3, batch["intrinsic"], batch["xmap"],
                             batch["ymap"], batch["d_scale"])
        ids = choose.long()
        color_emb = torch.gather(color.flatten(2), 2, ids[:, None].expand(
            -1, color.shape[1], -1)).transpose(1, 2)            # [B, n, 32]
        flat = geom.flatten(2, 3)                               # [B, C, HW, 3]
        geom_emb = torch.gather(flat, 2, ids[:, None, :, None].expand(
            -1, flat.shape[1], -1, 3)).transpose(1, 2)          # [B, n, C, 3]
        quat, trans, conf = self.PosePredNet_0(
            self.PointFeatNet_0(geom_emb, color_emb), batch["obj"])
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {"quat": quat, "trans": trans, "conf": conf,
                "color": nhwc(color), "normal": nhwc(normal),
                "depth": nhwc(depth), "mask": nhwc(mask[:, 0:1]),
                "boundary": nhwc(mask[:, 1:2])}


# -------------------------------------------------------------------- loss

def loss_weights(schema: dict) -> dict:
    """reference/trpesnet.py's weights and the boundary term's, which is
    the mask's (`weight_mask`)."""
    w = _weights(schema)
    return dict(w, boundary=w["mask"])


def boundary_loss(pred, batch):
    return torch.mean(torch.abs(pred["boundary"] - batch["boundary"]))


def transparent_loss(pred, batch, weights):
    """reference/trpesnet.py's loss plus the boundary term."""
    rest = {k: weights[k] for k in TERMS}
    return (_loss(pred, batch, rest)
            + weights["boundary"] * boundary_loss(pred, batch))


def loss_terms(pred, batch) -> dict:
    """Each term of the loss alone, unweighted: reference/trpesnet.py's
    loss with that term's weight 1 and the others' 0, and the boundary
    term."""
    out = {k: _loss(pred, batch, {t: float(t == k) for t in TERMS})
           for k in TERMS}
    out["boundary"] = boundary_loss(pred, batch)
    return out
