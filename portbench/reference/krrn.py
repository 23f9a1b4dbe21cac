"""Plain float32 KRRN: the HRNet backbone, the XYZ and normal heads, the
per-class select and the pixel gather, FusionNetLite (three 3D-GCN
streams over one KNN graph, two pooling levels, the 9-D fuse layers,
nearest-point up-sampling) and the translation head.

Every 3D-GCN aggregate is written out here with sorts, gathers and
products (no kernel), in the precision of the module's `Precision`. In
training the five pooling subsamples and the translation head's dropout
mask come from `generator`, drawn in the program's order.

Inputs and outputs in the program's layouts: x [B, H, W, 3], p_emb [B, N,
3], choose [B, N], cls [B]; maps come back NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    FP32, BasicBlock, Bottleneck, Conv, ConvNorm, ConvTransposeNorm, Dense,
    MLP1d, Named, Norm, resize_bilinear, safe_normalize, upsample2x)


# --------------------------------------------------------------------------
# HRNet
# --------------------------------------------------------------------------

class HRModule(Named):
    def __init__(self, channels, num_blocks, norm, q):
        super().__init__()
        nb = len(channels)
        self.q = q
        self.blocks = [[self.child(BasicBlock(channels[i], channels[i], 1,
                                              norm, q))
                        for _ in range(num_blocks)] for i in range(nb)]
        self.fuse = []
        for i in range(nb):
            row = []
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append([self.child(ConvNorm(
                        channels[j], channels[i], 1, 1, False, norm, q))])
                else:
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = channels[i] if last else channels[j]
                        chain.append(self.child(ConvNorm(
                            channels[j], ch, 3, 2, not last, norm, q)))
                    row.append(chain)
            self.fuse.append(row)

    def forward(self, xs):
        feats = []
        for i, blocks in enumerate(self.blocks):
            y = xs[i]
            for blk in blocks:
                y = blk(y)
            feats.append(y)
        fused = []
        for i, row in enumerate(self.fuse):
            acc = None
            for j, ops in enumerate(row):
                if j == i:
                    y = feats[j]
                elif j > i:
                    y = self.q(resize_bilinear(ops[0](feats[j]),
                                               feats[i].shape[2],
                                               feats[i].shape[3]))
                else:
                    y = feats[j]
                    for op in ops:
                        y = op(y)
                acc = y if acc is None else self.q(acc + y)
            fused.append(torch.relu(acc))
        return fused


class HRNet(Named):
    """NCHW crop -> (feat_quarter, feat_half)."""

    def __init__(self, in_ch, backbone_outc, stages, stem_width, norm, q):
        super().__init__()
        self.q = q
        self.child(ConvNorm(in_ch, stem_width, 3, 2, True, norm, q))
        self.child(ConvNorm(stem_width, stem_width, 3, 2, True, norm, q))
        ch = stem_width
        self.stem = []
        for _ in range(4):
            self.stem.append(self.child(Bottleneck(ch, stem_width, 1, norm,
                                                   q)))
            ch = stem_width * 4
        prev = (stem_width * 4,)
        self.stages = []
        for (num_modules, num_blocks, channels) in stages:
            trans = []
            for i, c in enumerate(channels):
                if i < len(prev):
                    trans.append((None if prev[i] == c else self.child(
                        ConvNorm(prev[i], c, 3, 1, True, norm, q)), i))
                else:
                    trans.append((self.child(
                        ConvNorm(prev[-1], c, 3, 2, True, norm, q)), -1))
            mods = [self.child(HRModule(channels, num_blocks, norm, q))
                    for _ in range(num_modules)]
            self.stages.append((trans, mods))
            prev = tuple(channels)
        cat = sum(prev)
        self.child(ConvNorm(cat, cat, 3, 1, True, norm, q))
        self.child(Conv(cat, backbone_outc, 1, 1, True, q))
        self.head_name = f"ConvNorm_{self._counts['ConvNorm'] - 1}"
        self.child(ConvTransposeNorm(cat + backbone_outc, backbone_outc, 4,
                                     norm, q))
        self.child(BasicBlock(backbone_outc, backbone_outc, 1, norm, q))

    def forward(self, x):
        x = self.ConvNorm_1(self.ConvNorm_0(x))
        for blk in self.stem:
            x = blk(x)
        feats = [x]
        for trans, mods in self.stages:
            feats = [feats[src] if mod is None else mod(feats[src])
                     for mod, src in trans]
            for m in mods:
                feats = m(feats)
        h, w = feats[0].shape[2], feats[0].shape[3]
        cat = torch.cat([feats[0]] + [self.q(resize_bilinear(f, h, w))
                                      for f in feats[1:]], dim=1)
        inter = getattr(self, self.head_name)(cat)
        feat_quarter = self.Conv_0(inter)
        feat_half = self.BasicBlock_0(self.ConvTransposeNorm_0(
            torch.cat([inter, feat_quarter], dim=1)))
        return feat_quarter, feat_half


class XYZHead(Named):
    def __init__(self, in_ch, hidden, out_channels, norm, q):
        super().__init__()
        self.q = q
        self.child(ConvTransposeNorm(in_ch, hidden, 3, norm, q))
        for _ in range(3):
            self.child(ConvNorm(hidden, hidden, 3, 1, True, norm, q))
        self.child(Conv(hidden, out_channels, 1, 1, True, FP32))

    def forward(self, x):
        x = self.ConvNorm_0(self.ConvTransposeNorm_0(x))
        x = self.ConvNorm_2(self.ConvNorm_1(self.q(upsample2x(x))))
        return self.Conv_0(x)


class NMLHead(Named):
    def __init__(self, in_ch, hidden, out_channels, norm, q):
        super().__init__()
        self.q = q
        for c in (in_ch, hidden, hidden):
            self.child(ConvNorm(c, hidden, 3, 1, True, norm, q))
        self.child(Conv(hidden, out_channels, 1, 1, True, FP32))

    def forward(self, x):
        x = self.ConvNorm_1(self.ConvNorm_0(x))
        return self.Conv_0(self.ConvNorm_2(self.q(upsample2x(x))))


# --------------------------------------------------------------------------
# 3D-GCN and FusionNetLite
# --------------------------------------------------------------------------

def sqdist(a, b):
    """Squared distances [..., n, m] of [..., n, 3] and [..., m, 3] in
    fp32, as (|a|^2 + |b|^2) - 2 a.b with each dot product summed as
    (x + y) + z, so that near-equal distances order as the program's."""
    a0, a1, a2 = (a[..., :, None, i] for i in range(3))
    b0, b1, b2 = (b[..., None, :, i] for i in range(3))
    inner = a0 * b0 + a1 * b1 + a2 * b2
    return ((a0 * a0 + a1 * a1 + a2 * a2) + (b0 * b0 + b1 * b1 + b2 * b2)
            - 2.0 * inner)


def knn(queries, keys, k, exclude_self):
    """[B, m, k] indices of the nearest keys (a stable sort of the
    distances: ties to the lower index), the first dropped with
    exclude_self."""
    kk = k + 1 if exclude_self else k
    idx = torch.sort(sqdist(queries, keys), dim=-1,
                     stable=True).indices[..., :kk]
    return idx[..., 1:] if exclude_self else idx


def nearest_index(target, source):
    """Index of the nearest source point, ties to the lower index."""
    return torch.min(sqdist(target, source), dim=-1).indices


def gather_rows(features, index):
    idx = index.long()[..., None].expand(*index.shape, features.shape[-1])
    return torch.gather(features, -2, idx)


def gather_neighbors(features, index):
    b, m, k = index.shape
    flat = gather_rows(features, index.reshape(b, m * k))
    return flat.reshape(b, m, k, features.shape[-1])


def neighbor_directions(vertices, index, eps=1e-6):
    """Unit directions [B, n, k, 3] to the neighbours; 0 where they
    coincide."""
    d = gather_neighbors(vertices, index) - vertices[..., :, None, :]
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    degenerate = sq < eps * eps
    safe_n = torch.sqrt(torch.where(degenerate, torch.ones_like(sq), sq))
    return torch.where(degenerate, torch.zeros_like(d), d / safe_n)


def support_sum(acc, support_num):
    """[..., S * O] -> [..., O]: the sum over the supports."""
    return acc.reshape(*acc.shape[:-1], support_num, -1).sum(-2)


def gcn_aggregate(nd, dirs, table, idx, support_num, q):
    """sum_s max_k relu(<nd_k, dir_s>) * table[idx_k]_s; without a table,
    sum_s max_k relu(<nd_k, dir_s>). nd [B, n, k, D], dirs [D, S * O],
    table [B, m, S * O] or None, idx [B, n, k]."""
    theta = torch.relu(q(nd) @ q(dirs))                       # [B,n,k,S*O]
    if table is not None:
        theta = theta * gather_neighbors(table, idx)
    return support_sum(theta.amax(dim=2), support_num)


class ConvSurface(nn.Module):
    def __init__(self, kernel_num, support_num, q):
        super().__init__()
        self.support_num, self.q = support_num, q
        self.directions = nn.Parameter(torch.empty(3, support_num
                                                   * kernel_num))

    def forward(self, idx, vertices):
        dirs = safe_normalize(self.directions, dim=0, eps=1e-12)
        nd = neighbor_directions(vertices, idx)
        return self.q(gcn_aggregate(nd, dirs, None, idx, self.support_num,
                                    self.q))


class ConvLayer(nn.Module):
    """out = X W_0 + b_0 + sum_s max_k relu(<nd_k, dir_s>) (X W_s +
    b_s)[idx_k]."""

    def __init__(self, in_ch, out_channel, support_num, point_dim, q):
        super().__init__()
        s, o = support_num, out_channel
        self.support_num, self.out_channel, self.q = s, o, q
        self.weights = nn.Parameter(torch.empty(in_ch, (s + 1) * o))
        self.bias = nn.Parameter(torch.empty((s + 1) * o))
        self.directions = nn.Parameter(torch.empty(point_dim, s * o))

    def forward(self, idx, vertices, feature_map):
        q, o = self.q, self.out_channel
        dirs = safe_normalize(self.directions, dim=0, eps=1e-12)
        nd = neighbor_directions(vertices, idx)
        feat = q(q(feature_map) @ q(self.weights) + q(self.bias))
        agg = gcn_aggregate(nd, dirs, feat[..., o:], idx, self.support_num,
                            q)
        return q(feat[..., :o] + q(agg))


def pool(vertices, feature_map, generator, rate=4, neighbors=4):
    """Subsample (a random permutation's head with a generator, else every
    rate-th point), then the max of the features over each sampled
    point's `neighbors` nearest points other than itself."""
    n = vertices.shape[-2]
    num = n // rate
    if generator is not None:
        sample = torch.randperm(n, generator=generator,
                                device=generator.device)[:num]
        sample = sample.to(vertices.device)
    else:
        sample = torch.arange(num, device=vertices.device) * rate
    v_s = vertices[:, sample]
    idx = knn(v_s[..., :3], vertices[..., :3], neighbors, True)
    return v_s, gather_neighbors(feature_map, idx).amax(dim=-2)


class Stream(nn.Module):
    def __init__(self, ch0, ch1, ch2, support_num, norm, q):
        super().__init__()
        self.conv0 = ConvSurface(ch0, support_num, q)
        self.conv1 = ConvLayer(ch0, ch1, support_num, 3, q)
        self.conv2 = ConvLayer(ch1, ch2, support_num, 3, q)
        self.norm1 = Norm(ch1, norm, q)
        self.norm2 = Norm(ch2, norm, q)


class FusionNetLite(Named):
    """[B, N, 3] cloud, predicted coordinates and normals -> [B, N, 1280]."""

    def __init__(self, neighbor_num, support_num, norm, q):
        super().__init__()
        self.k, self.s = neighbor_num, support_num
        for _ in range(3):
            self.child(Stream(128, 128, 128, support_num, norm, q),
                       "_Stream")
        self.child(ConvLayer(384, 512, support_num, 9, q))
        self.child(ConvLayer(512, 512, support_num, 9, q))

    def forward(self, vertices, xyz, normal, generator=None):
        k, g = self.k, generator
        streams = [self._Stream_0, self._Stream_1, self._Stream_2]
        pts = [vertices, xyz, normal]
        idx = knn(vertices, vertices, k, True)
        fm_1 = []
        for st, p in zip(streams, pts):
            f0 = torch.relu(st.conv0(idx, p))
            fm_1.append(torch.relu(st.norm1(st.conv1(idx, p, f0))))
        feat_1 = torch.cat(fm_1, -1)
        feat_9d = torch.cat(pts, -1)

        pooled = [pool(p, f, g) for p, f in zip(pts, fm_1)]
        pool_1, _ = pool(feat_9d, feat_1, g)
        pts1 = [p for p, _ in pooled]
        k1 = max(1, min(k, pts1[0].shape[1] // 8))
        idx1 = knn(pts1[0], pts1[0], k1, True)
        fm_2 = [torch.relu(st.norm2(st.conv2(idx1, p, f)))
                for st, p, (_, f) in zip(streams, pts1, pooled)]
        feat_2 = torch.cat(fm_2, -1)
        pool_2, f_pool_2 = pool(pool_1, feat_2, g)

        k2 = max(1, min(k, pool_2.shape[1] // 8))
        idx2 = knn(pool_2[..., :3], pool_2[..., :3], k2, True)
        fm_4 = self.ConvLayer_0(idx2, pool_2, f_pool_2)
        fm_5 = self.ConvLayer_1(idx2, pool_2, fm_4)
        near_1 = nearest_index(vertices, pool_1[..., :3])
        near_2 = nearest_index(vertices, pool_2[..., :3])
        return torch.cat([gather_rows(fm_5, near_2), feat_1,
                          gather_rows(feat_2, near_1)], -1)


# --------------------------------------------------------------------------
# Translation head and KRRN
# --------------------------------------------------------------------------

class TBase(Named):
    rate = 0.2

    def __init__(self, in_f, norm, out_dim, q):
        super().__init__()
        self.child(MLP1d(in_f, (1024, 256, 256), norm, True, q))
        self.child(Dense(256, out_dim, q))

    def forward(self, feat, generator=None):
        x = self.MLP1d_0(feat)
        if generator is not None:
            p = 1.0 - self.rate
            keep = torch.rand(x.shape, generator=generator,
                              device=generator.device) < p
            x = torch.where(keep.to(x.device), x / p, torch.zeros_like(x))
        return self.Dense_0(x)


class PoseNet(Named):
    def __init__(self, in_f, t_dim, norm, q):
        super().__init__()
        self.child(TBase(in_f, norm, t_dim, q))

    def forward(self, feat, generator=None):
        return self.TBase_0(feat, generator)


DEFAULT_STAGES = ((1, 4, (96, 96)), (4, 3, (96, 96, 128)),
                  (3, 3, (96, 96, 128, 256)))


class KRRN(Named):
    """KRRN with FusionNetLite and without the rotation heads, from the
    configuration's `schema` dict."""

    def __init__(self, schema: dict, q):
        super().__init__()
        m, d = schema["module"], schema["data"]
        if m.get("norm", "gn") != "gn":
            raise ValueError("the reference KRRN has group normalisation "
                             "only")
        self.num_cls = m["num_cls"]
        self.mask_outc = m["masknet"]["out"] * self.num_cls + 1
        self.region_outc = d["num_regions"] + 1
        outc, norm = m["backbone_outc"], m["norm"]
        stages = m["hrnet_stages"] or DEFAULT_STAGES
        self.child(HRNet(3, outc, stages, m["stem_width"], norm, q))
        self.child(XYZHead(outc, m["xyznet"]["hidden"],
                           self.mask_outc + self.region_outc
                           + m["xyznet"]["out"] * self.num_cls, norm, q))
        self.child(NMLHead(outc, m["nmlnet"]["hidden"],
                           m["nmlnet"]["out"] * self.num_cls, norm, q))
        self.child(FusionNetLite(m["gcn3d"]["neighbor_num"],
                                 m["gcn3d"]["support_num"], norm, q))
        self.child(PoseNet(1280 + self.num_cls, m["posenet"]["out_t"], norm,
                           q))

    def forward(self, x, p_emb, choose, cls, opt_pose=True, generator=None):
        b = x.shape[0]
        mo, ro, nc = self.mask_outc, self.region_outc, self.num_cls
        feat_quarter, feat_half = self.HRNet_0(x.permute(0, 3, 1, 2))
        xyz_map = self.XYZHead_0(feat_quarter).permute(0, 2, 3, 1)
        nml_map = self.NMLHead_0(feat_half).permute(0, 2, 3, 1)
        rows = torch.arange(b, device=x.device)
        sel = lambda maps: maps.reshape(*maps.shape[:3], nc, 3)[
            rows, :, :, cls.long()]
        xyz_sel = sel(xyz_map[..., mo + ro:])
        nml_sel = safe_normalize(sel(nml_map))
        h, w = xyz_sel.shape[1:3]
        xyz_emb = gather_rows(xyz_sel.reshape(b, h * w, 3), choose)
        nml_emb = gather_rows(nml_sel.reshape(b, h * w, 3), choose)
        pred_t = None
        if opt_pose:
            feat = self.FusionNetLite_0(p_emb, xyz_emb, nml_emb, generator)
            onehot = F.one_hot(cls.long(), nc).to(feat.dtype)
            feat = torch.cat([feat, onehot[:, None, :].expand(
                *feat.shape[:2], nc)], -1)
            t_res = self.PoseNet_0(feat, generator)
            pred_t = torch.mean(p_emb + t_res, dim=1)
        return {"xyz": xyz_sel, "region": xyz_map[..., mo:mo + ro],
                "mask": xyz_map[..., :mo], "normal": nml_sel,
                "xyz_emb": xyz_emb, "pred_t": pred_t}
