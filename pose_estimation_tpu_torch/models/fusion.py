"""Three-stream 3D-GCN fusion (counterpart of models/fusion.py):
FusionNetLite (the default) and the full FusionNet.

Streams over the depth cloud, the predicted model coordinates and the
predicted normals share the KNN graph of the cloud; two pooling levels
N -> N/4 -> N/16; two 9-D fuse ConvLayers; nearest-neighbour upsampling
back to N. FusionNetLite's output is [B, N, 1280]; per forward it
launches the KNN kernel 8 times (3 self searches, 5 in the PoolLayers),
the fused linear aggregate twice (levels 0 and 1), the fused surface
aggregate once and the nearest-source kernel once (the two up-sampling
maps in one launch). FusionNet widens level 1 to 256 channels with three extra
ConvLayers (a third fused linear launch) and outputs [B, N, 1664]; its
first fuse layer reads the 768-wide level-1 features, which is a wide
ConvLayer (the wide-table aggregate kernel) while S*256 <= 768, i.e. at
S = 2 and 3. A `generator` (training) makes the five PoolLayer
subsamples random draws.
"""

from __future__ import annotations

import torch
from torch import nn

from pose_estimation_tpu_torch.core import pointops as po
from pose_estimation_tpu_torch.models.gcn3d import (
    ConvLayer, ConvSurface, PoolLayer)
from pose_estimation_tpu_torch.models.layers import Named, Norm
from pose_estimation_tpu_torch.ops import gcn


class _Stream(nn.Module):
    """One stream: surface conv + 2 graph convs with norms."""

    def __init__(self, ch0, ch1, ch2, support_num, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.conv0 = ConvSurface(ch0, support_num, dtype=dtype)
        self.conv1 = ConvLayer(ch0, ch1, support_num, dtype=dtype)
        self.conv2 = ConvLayer(ch1, ch2, support_num, dtype=dtype)
        self.norm1 = Norm(ch1, norm, dtype=dtype)
        self.norm2 = Norm(ch2, norm, dtype=dtype)


def _fused_convs(convs, idx, pts_list, feat_list, support_num):
    """Narrow ConvLayers sharing one KNN graph through one fused linear
    aggregate. A wide layer (in_ch >= S*O, e.g. any layer at S = 1)
    raises ValueError, as the JAX package's does."""
    parts = [c(idx, p, f, parts=True)
             for c, p, f in zip(convs, pts_list, feat_list)]
    centers, dirs_l, nds, xs, ws, bs = map(list, zip(*parts))
    aggs = gcn.linear_multi(nds, dirs_l, xs, ws, bs, idx, support_num)
    return [c + a.to(c.dtype) for c, a in zip(centers, aggs)]


def _fused_level0(streams, idx, pts_list, support_num, dtype):
    surf = [st.conv0(idx, p, parts=True) for st, p in zip(streams, pts_list)]
    dirs0, nds0 = map(list, zip(*surf))
    f0s = [torch.relu(a.to(dtype))
           for a in gcn.surface_multi(nds0, dirs0, support_num)]
    ys = _fused_convs([st.conv1 for st in streams], idx, pts_list, f0s,
                      support_num)
    return [torch.relu(st.norm1(y)) for st, y in zip(streams, ys)]


def _fused_level1(streams, idx1, pts_list, feat_list, support_num):
    ys = _fused_convs([st.conv2 for st in streams], idx1, pts_list,
                      feat_list, support_num)
    return [torch.relu(st.norm2(y)) for st, y in zip(streams, ys)]


def _upsample_maps(vertices, pool_1, pool_2):
    """Index of the nearest pool_1 and pool_2 point of every vertex, one
    nearest-source launch for both."""
    return po.nearest_index_multi(
        vertices, [p[..., :3].detach().contiguous() for p in (pool_1, pool_2)])


class FusionNetLite(Named):
    """Default fusion. Output [B, N, 1280]."""

    def __init__(self, neighbor_num=10, support_num=7, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.neighbor_num, self.support_num, self.dtype = (
            neighbor_num, support_num, dtype)
        for _ in range(3):
            self.child(_Stream(128, 128, 128, support_num, norm, dtype))
        self.pools = [PoolLayer(4, 4) for _ in range(5)]
        self.child(ConvLayer(384, 512, support_num, point_dim=9, dtype=dtype))
        self.child(ConvLayer(512, 512, support_num, point_dim=9, dtype=dtype))

    def forward(self, vertices, xyz, normal, generator=None):
        k, s = self.neighbor_num, self.support_num
        vertices = vertices.detach().contiguous()
        streams = [self._Stream_0, self._Stream_1, self._Stream_2]
        idx = po.knn_indices(vertices, k)
        fm_1 = _fused_level0(streams, idx, [vertices, xyz, normal], s,
                             self.dtype)
        feat_1 = torch.cat(fm_1, -1)                           # [B,N,384]
        feat_9d = torch.cat([vertices, xyz, normal], -1)       # [B,N,9]

        pool_v, pool_x, pool_n, pool_c1, pool_c2 = self.pools
        g = generator
        v_p1, f_p1_v = pool_v(vertices, fm_1[0], generator=g)
        x_p1, f_p1_x = pool_x(xyz, fm_1[1], generator=g)
        n_p1, f_p1_n = pool_n(normal, fm_1[2], generator=g)
        pool_1, _ = pool_c1(feat_9d, feat_1, generator=g)

        k1 = max(1, min(k, v_p1.shape[1] // 8))
        idx1 = po.knn_indices(v_p1.contiguous(), k1)
        fm_2 = _fused_level1(streams, idx1, [v_p1, x_p1, n_p1],
                             [f_p1_v, f_p1_x, f_p1_n], s)
        feat_2 = torch.cat(fm_2, -1)                           # [B,N/4,384]
        pool_2, f_pool_2 = pool_c2(pool_1, feat_2, generator=g)

        k2 = max(1, min(k, pool_2.shape[1] // 8))
        idx2 = po.knn_indices(pool_2[..., :3].contiguous(), k2)
        fm_4 = self.ConvLayer_0(idx2, pool_2, f_pool_2)
        fm_5 = self.ConvLayer_1(idx2, pool_2, fm_4)

        # nearest-neighbour upsample maps, both from one launch as the JAX
        # package takes both from one distance matrix d1; pool_2's rows are
        # a subsample of pool_1's, so near_2 sees the distances d1[..., s2]
        # holds, element for element
        near_1, near_2 = _upsample_maps(vertices, pool_1, pool_2)
        feat_2_up = po.gather_rows(feat_2, near_1)
        fm_5_up = po.gather_rows(fm_5, near_2)
        return torch.cat([fm_5_up, feat_1, feat_2_up], -1)


class FusionNet(Named):
    """Full fusion. Output [B, N, 1664] = 512 + 384 + 768. Children carry
    flax's names in its creation order: _Stream_0..2, the extra level-1
    ConvLayer_0..2, Norm_0..2, then ConvLayer_3 (fm_4) and ConvLayer_4
    (fm_5); the PoolLayers hold no parameters."""

    def __init__(self, neighbor_num=10, support_num=7, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.neighbor_num, self.support_num, self.dtype = (
            neighbor_num, support_num, dtype)
        self.streams = [self.child(_Stream(128, 128, 256, support_num, norm,
                                           dtype)) for _ in range(3)]
        self.extra = [self.child(ConvLayer(256, 256, support_num,
                                           dtype=dtype)) for _ in range(3)]
        self.pools = [PoolLayer(4, 4) for _ in range(5)]
        self.norms = [self.child(Norm(256, norm, dtype=dtype))
                      for _ in range(3)]
        self.child(ConvLayer(768, 256, support_num, point_dim=9, dtype=dtype))
        self.child(ConvLayer(256, 512, support_num, point_dim=9, dtype=dtype))

    def forward(self, vertices, xyz, normal, generator=None):
        k, s, g = self.neighbor_num, self.support_num, generator
        vertices = vertices.detach().contiguous()
        idx = po.knn_indices(vertices, k)
        inputs = [vertices, xyz, normal]
        fm1 = _fused_level0(self.streams, idx, inputs, s, self.dtype)
        feat_1 = torch.cat(fm1, -1)                            # [B,N,384]
        feat_9d = torch.cat(inputs, -1)                        # [B,N,9]

        pooled = [p(pt, f, generator=g)
                  for p, pt, f in zip(self.pools, inputs, fm1)]
        pool_1, _ = self.pools[3](feat_9d, feat_1, generator=g)
        pts1 = [pt for pt, _ in pooled]

        k1 = max(1, min(k, pts1[0].shape[1] // 8))
        idx1 = po.knn_indices(pts1[0].contiguous(), k1)
        fm2 = _fused_level1(self.streams, idx1, pts1, [f for _, f in pooled],
                            s)
        fm3 = [torch.relu(nm(y)) for nm, y in zip(
            self.norms, _fused_convs(self.extra, idx1, pts1, fm2, s))]
        feat_2 = torch.cat(fm3, -1)                            # [B,N/4,768]

        pool_2, f_pool_2 = self.pools[4](pool_1, feat_2, generator=g)
        k2 = max(1, min(k, pool_2.shape[1] // 8))
        idx2 = po.knn_indices(pool_2[..., :3].contiguous(), k2)
        fm_4 = self.ConvLayer_3(idx2, pool_2, f_pool_2)
        fm_5 = self.ConvLayer_4(idx2, pool_2, fm_4)

        near_1, near_2 = _upsample_maps(vertices, pool_1, pool_2)
        return torch.cat([po.gather_rows(fm_5, near_2), feat_1,
                          po.gather_rows(feat_2, near_1)], -1)
