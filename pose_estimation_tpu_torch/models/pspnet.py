"""TransparentPoseNet, the transparent-object pose network of the PSPNet
generation (counterpart of models/pspnet.py): a dilated ResNet18 of
output stride 8, PSP pyramid pooling to 1024 channels, three PSPUpsample
decoder branches (colour: a 32-way log-softmax; normal; depth) sharing a
fused 192-channel map, a sigmoid mask + boundary head, GeoNet's
per-channel back-projection, PointFeatNet's 2816-wide DenseFusion
features and PosePredNet's per-point quaternion / translation /
confidence heads.

Inputs and outputs keep the JAX layouts (img [B, H, W, 3], the maps come
back NHWC); inside, maps are NCHW. The pixels `choose` [B, n] (flat ids
into H*W, one set a sample, gathered per sample) are an argument, as in
the JAX model: the train step draws them with replacement, the eval uses
the stride arange(n) * max(hw // n, 1) % hw. In training the decoder's
seven dropout masks are an argument too (`dropout_shapes` gives their
NCHW shapes in flax's trace order; the train step draws them), applied as
flax's Dropout applies its mask: x / keep_prob where kept, 0 elsewhere,
the quotient in x's dtype.

Under bf16 the dtypes follow the JAX model's promotions: PSPUpsample's
PReLU multiplies by its fp32 `prelu_alpha`, so each branch leaves its
first PSPUpsample in fp32 and resizes in fp32 from there; the colour,
normal, depth and mask convolutions run in fp32; the fused map is fp32.

With tracing on (utils/profiling.py) the forward's parts are the spans
pspnet.backbone (ResNet18Stride8), pspnet.psp (PSPModule),
pspnet.decoder (PSPDecoder and the mask / boundary Conv_0),
pspnet.geometry (GeoNet and the two pixel gathers) and pspnet.points
(PointFeatNet and PosePredNet); none of them synchronises the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.layers import (
    Conv, ConvNorm, Dense, Named, Norm, max_pool_same, resize_bilinear,
    upsample2x)
from pose_estimation_tpu_torch.models.transparent import (
    GeometryNet, TransformerEncoderBlock, select_object)
from pose_estimation_tpu_torch.utils.profiling import span

# the decoder's dropout rates in flax's trace order: the 0.3 one on the
# PSP map before the colour branch, then two in each of the three branches
DROPOUT_RATES = (0.3,) + (0.15,) * 6
PSP_SIZES = (1, 2, 3, 6)


def _cat(xs: list) -> torch.Tensor:
    """Channel concatenation with jnp.concatenate's type promotion."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.cat([x.to(dtype) for x in xs], 1)


def dropout_keep(x: torch.Tensor, keep: torch.Tensor | None,
                 rate: float) -> torch.Tensor:
    """flax nn.Dropout with its mask `keep` given (None: no dropout):
    lax.select(keep, x / keep_prob, 0), keep_prob in x's dtype (filled
    on the device: a host scalar copied there would synchronise)."""
    if keep is None:
        return x
    p = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep.to(x.device), x / p, torch.zeros_like(x))


def feature_size(size: int) -> int:
    """The backbone's output size for an input side of `size`: the stem,
    the max-pool and the second stage each halve it, SAME (rounding up)."""
    for _ in range(3):
        size = -(-size // 2)
    return size


def dropout_shapes(b: int, h: int, w: int) -> list:
    """NCHW shapes of the decoder's seven dropout masks for a batch of b
    crops of h x w, in flax's trace order (DROPOUT_RATES)."""
    fh, fw = feature_size(h), feature_size(w)
    return [(b, 1024, fh, fw)] + [(b, 256, 2 * fh, 2 * fw),
                                  (b, 64, 4 * fh, 4 * fw)] * 3


class ResNetBlock(Named):
    """Two 3x3 convolutions (the first with `stride`, both dilated by
    `dilation`) with Norms, plus the residual (a 1x1 ConvNorm projection
    when the shape changes)."""

    def __init__(self, in_ch, features, stride=1, dilation=1, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.child(Conv(in_ch, features, 3, stride, False, dtype, dilation))
        self.child(Norm(features, norm, dtype=dtype))
        self.child(Conv(features, features, 3, 1, False, dtype, dilation))
        self.child(Norm(features, norm, dtype=dtype))
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.child(ConvNorm(in_ch, features, 1, stride, False, norm,
                                dtype))

    def forward(self, x):
        y = torch.relu(self.Norm_0(self.Conv_0(x)))
        y = self.Norm_1(self.Conv_1(y))
        res = self.ConvNorm_0(x) if self.project else x
        return torch.relu(y + res)


class ResNet18Stride8(Named):
    """img [B, 3, H, W] -> [B, 512, H/8, W/8]: a 7x7 stride-2 ConvNorm, the
    SAME 3x3 stride-2 max-pool, then blocks (64, 1, 1), (128, 2, 1),
    (256, 1, 2), (512, 1, 4) (features, stride, dilation), two each."""

    STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))

    def __init__(self, norm="gn", dtype=torch.float32):
        super().__init__()
        self.child(ConvNorm(3, 64, 7, 2, True, norm, dtype))
        c = 64
        for f, s, d in self.STAGES:
            self.child(ResNetBlock(c, f, s, d, norm, dtype))
            self.child(ResNetBlock(f, f, 1, d, norm, dtype))
            c = f

    def forward(self, x):
        x = max_pool_same(self.ConvNorm_0(x))
        for i in range(2 * len(self.STAGES)):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        return x


class PSPModule(Named):
    """Pyramid pooling as the JAX module computes it, which is not an
    adaptive pool: for each size, an average over windows of (h // size,
    w // size) at the same stride, VALID (the remainder dropped; a size
    over h / 2 pools windows of one pixel), a 1x1 convolution without
    bias, the bilinear resize back to h x w; the priors and x
    concatenated, then a 1x1 convolution to `out_features` with ReLU."""

    def __init__(self, in_ch, out_features=1024, sizes=PSP_SIZES,
                 dtype=torch.float32):
        super().__init__()
        self.sizes = sizes
        for _ in sizes:
            self.child(Conv(in_ch, in_ch, 1, 1, False, dtype))
        self.child(Conv(in_ch * (len(sizes) + 1), out_features, 1, 1, True,
                        dtype))

    def forward(self, x):
        h, w = x.shape[2:]
        priors = []
        for i, size in enumerate(self.sizes):
            ph, pw = h // size, w // size
            if not (ph and pw):
                raise ValueError(f"PSPModule: a {h}x{w} feature map is "
                                 f"smaller than the pyramid's size {size} "
                                 "(the crop needs at least 48 px)")
            pooled = F.avg_pool2d(x, (ph, pw), (ph, pw))
            priors.append(resize_bilinear(
                getattr(self, f"Conv_{i}")(pooled), h, w))
        priors.append(x)
        return torch.relu(getattr(self, f"Conv_{len(self.sizes)}")(
            _cat(priors)))


class PSPUpsample(Named):
    """x2 bilinear, a 3x3 convolution, then PReLU with the fp32 scalar
    parameter `prelu_alpha`: the result is fp32 (JAX promotes alpha * x
    and the select to it)."""

    def __init__(self, in_ch, features, dtype=torch.float32):
        super().__init__()
        self.child(Conv(in_ch, features, 3, 1, True, dtype))
        self.prelu_alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x):
        x = self.Conv_0(upsample2x(x))
        xf = x.to(torch.promote_types(x.dtype, self.prelu_alpha.dtype))
        return torch.where(x >= 0, xf, self.prelu_alpha * xf)


class PSPDecoder(Named):
    """p [B, 1024, h, w] -> (colour log-probabilities [B, 32, 8h, 8w],
    normal [B, 3, ..], depth [B, 1, ..], the fused map [B, 192, ..]):
    three branches of PSPUpsample 256 -> 64 -> 64 (colour on p after
    dropout 0.3; each branch with dropout 0.15 after its first two
    PSPUpsamples); the normal and depth maps from their branches' joined
    features. `masks`: the seven keep masks (dropout_shapes), or None for
    no dropout. The JAX module's `norm` is unused; so it is here."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for _ in range(3):
            self.child(PSPUpsample(1024, 256, dtype))
            self.child(PSPUpsample(256, 64, dtype))
            self.child(PSPUpsample(64, 64, dtype))
        self.child(Conv(64, 32, 1, 1, True, torch.float32))
        self.child(Conv(128, 32, 1, 1, True, dtype))
        self.child(Conv(128, 32, 1, 1, True, dtype))
        self.child(Conv(64, 3, 1, 1, True, torch.float32))
        self.child(Conv(64, 1, 1, 1, True, torch.float32))

    def forward(self, p, masks=None):
        keep = list(masks) if masks is not None else [None] * 7
        rates = iter(DROPOUT_RATES)

        def drop(x):
            return dropout_keep(x, keep.pop(0), next(rates))

        def branch(i, x):
            x = drop(getattr(self, f"PSPUpsample_{3 * i}")(x))
            x = drop(getattr(self, f"PSPUpsample_{3 * i + 1}")(x))
            return getattr(self, f"PSPUpsample_{3 * i + 2}")(x)

        c = branch(0, drop(p))
        color = torch.log_softmax(self.Conv_0(c.float()), dim=1)
        n1, d1 = branch(1, p), branch(2, p)
        f1 = _cat([n1, d1])                                       # 128
        f2 = _cat([self.Conv_1(f1), torch.relu(self.Conv_2(f1))])  # 64
        normal = safe_normalize(self.Conv_3(f2.float()), dim=1)
        depth = torch.relu(self.Conv_4(f2.float()))
        return color, normal, depth, _cat([f1, f2])               # 192


class GeoNet(GeometryNet):
    """feat [B, 192, H, W] -> [B, 32, H, W, 3]: two 1x1 convolutions with
    ReLU (64, then 32) as depths, back-projected per channel as in
    GeometryNet."""

    def __init__(self, dtype=torch.float32):
        super().__init__(192, 64, dtype)
        self.child(Conv(64, 32, 1, 1, True, dtype))

    def depths(self, feat):
        return torch.relu(self.Conv_1(torch.relu(self.Conv_0(feat))))


class PointFeatNet(Named):
    """geom_emb [B, n, 32, 3], color_emb [B, n, 32] -> [B, n, 2816]:
    64-wide colour and per-axis embeddings (256), 128-wide ones (512),
    then 1024 and 2048 wide, the last averaged over the points (2048);
    ReLU after every Dense. Flax's creation order: Dense_0 colour,
    Dense_1-3 the axes, Dense_4 colour, Dense_5-7 the axes, Dense_8,
    Dense_9."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for _ in range(4):
            self.child(Dense(32, 64, dtype))
        for _ in range(4):
            self.child(Dense(64, 128, dtype))
        self.child(Dense(512, 1024, dtype))
        self.child(Dense(1024, 2048, dtype))

    def forward(self, geom_emb, color_emb):
        first = [torch.relu(self.Dense_0(color_emb))] + [
            torch.relu(getattr(self, f"Dense_{1 + a}")(geom_emb[..., a]))
            for a in range(3)]
        second = [torch.relu(getattr(self, f"Dense_{4 + i}")(x))
                  for i, x in enumerate(first)]
        feat1, feat2 = torch.cat(first, -1), torch.cat(second, -1)
        x = torch.relu(self.Dense_9(torch.relu(self.Dense_8(feat2))))
        pooled = x.mean(dim=1, keepdim=True).expand_as(x)
        return torch.cat([feat1, feat2, pooled], -1)


class PosePredNet(Named):
    """apx [B, n, 2816], obj [B] -> quaternion, translation, confidence:
    per branch 640 -> 256 -> 128 -> num_obj x out with ReLU after every
    Dense but the last (unlike TRPESNet's head), the object's channels
    selected, the confidence's sigmoid. use_transformer puts a
    TransformerEncoderBlock (8, 4, 2 heads) between 640 and 256 and keeps
    the 128 layer."""

    BRANCHES = ((4, 8), (3, 4), (1, 2))

    def __init__(self, num_obj, use_transformer=False, dtype=torch.float32):
        super().__init__()
        self.num_obj = num_obj
        self.branches = []
        for out, heads in self.BRANCHES:
            layers = [self.child(Dense(2816, 640, dtype))]
            if use_transformer:
                layers.append(self.child(TransformerEncoderBlock(
                    640, heads, dtype=dtype)))
            layers += [self.child(Dense(640, 256, dtype)),
                       self.child(Dense(256, 128, dtype)),
                       self.child(Dense(128, num_obj * out, dtype))]
            self.branches.append((out, layers))

    def forward(self, apx, obj):
        outs = []
        for out, layers in self.branches:
            x = apx
            for layer in layers[:-1]:
                x = layer(x)
                if isinstance(layer, Dense):
                    x = torch.relu(x)
            outs.append(select_object(layers[-1](x), obj, self.num_obj, out))
        rx, tx, cx = outs
        return rx, tx, torch.sigmoid(cx)


class TransparentPoseNet(Named):
    """img [B, H, W, 3], intrinsic [B, 4] (fx, fy, cx, cy), xmap / ymap
    [B, H, W], d_scale [B], obj [B], choose [B, n] -> dict: quat
    [B, n, 4], trans [B, n, 3], conf [B, n, 1] (in `dtype`); color
    [B, H, W, 32], normal [B, H, W, 3], depth, mask and boundary
    [B, H, W, 1] (fp32). `masks`: the decoder's seven dropout keep masks
    in training (dropout_shapes), None in eval."""

    def __init__(self, num_obj=5, num_points=256, use_transformer=False,
                 norm="gn", dtype=torch.float32):
        super().__init__()
        self.num_obj, self.num_points, self.dtype = num_obj, num_points, dtype
        self.child(ResNet18Stride8(norm, dtype))
        self.child(PSPModule(512, 1024, dtype=dtype))
        self.child(PSPDecoder(dtype))
        self.child(Conv(192, 2, 1, 1, True, torch.float32))
        self.child(GeoNet(dtype))
        self.child(PointFeatNet(dtype))
        self.child(PosePredNet(num_obj, use_transformer, dtype))

    def forward(self, img, intrinsic, xmap, ymap, d_scale, obj, choose,
                masks=None):
        b = img.shape[0]
        with span("pspnet.backbone"):
            f = self.ResNet18Stride8_0(img.permute(0, 3, 1, 2))
        with span("pspnet.psp"):
            p = self.PSPModule_0(f)
        with span("pspnet.decoder"):
            color, normal, depth, f3 = self.PSPDecoder_0(p, masks)
            mask = torch.sigmoid(self.Conv_0(f3.float()))
        with span("pspnet.geometry"):
            geom = self.GeoNet_0(f3, intrinsic, xmap, ymap, d_scale)
            ids = choose.long()
            color_emb = torch.gather(color.flatten(2), 2, ids[:, None].expand(
                -1, color.shape[1], -1)).transpose(1, 2)       # [B, n, 32]
            flat = geom.flatten(2, 3)                           # [B, C, HW, 3]
            geom_emb = torch.gather(flat, 2, ids[:, None, :, None].expand(
                b, flat.shape[1], -1, 3)).transpose(1, 2)      # [B, n, C, 3]
        with span("pspnet.points"):
            apx = self.PointFeatNet_0(geom_emb, color_emb)
            rx, tx, cx = self.PosePredNet_0(apx, obj)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {"quat": rx, "trans": tx, "conf": cx, "color": nhwc(color),
                "normal": nhwc(normal), "depth": nhwc(depth),
                "mask": nhwc(mask[:, 0:1]), "boundary": nhwc(mask[:, 1:2])}
