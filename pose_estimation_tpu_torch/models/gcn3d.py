"""3D-GCN point-cloud convolutions (counterpart of models/gcn3d.py).

  theta[b,n,k,s,o] = relu(<unit dir to neighbour k, learned direction (s,o)>)
  out[b,n,o]       = sum_s max_k theta * (neighbour support feature)

The KNN index comes from the caller, shared across streams. The
aggregates run through ops.gcn: the fusion nets call these layers with
parts=True and run several streams through one fused kernel launch; a
wide ConvLayer (in_ch >= S*O) runs the wide-table aggregate.
"""

from __future__ import annotations

import torch
from torch import nn

from pose_estimation_tpu_torch.core import pointops as po
from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.ops import gcn


def _uniform(shape, stdv):
    return nn.Parameter(torch.empty(shape).uniform_(-stdv, stdv))


class ConvSurface(nn.Module):
    """Structure features from raw coordinates (no input features)."""

    def __init__(self, kernel_num, support_num, point_dim=3,
                 dtype=torch.float32):
        super().__init__()
        self.support_num, self.dtype = support_num, dtype
        stdv = 1.0 / (support_num * kernel_num) ** 0.5
        self.directions = _uniform((point_dim, support_num * kernel_num),
                                   stdv)

    def forward(self, neighbor_index, vertices, parts=False):
        """parts=True returns (dirs, nd) for the fused multi-stream call."""
        dirs = safe_normalize(self.directions, dim=0, eps=1e-12)
        nd = po.neighbor_directions(vertices, neighbor_index)
        if parts:
            return dirs, nd
        return gcn.aggregate(nd, dirs, None, neighbor_index,
                             self.support_num).to(self.dtype)


class ConvLayer(nn.Module):
    """Graph conv on features; point_dim 9 for the fuse layers."""

    def __init__(self, in_ch, out_channel, support_num, point_dim=3,
                 dtype=torch.float32):
        super().__init__()
        s, o = support_num, out_channel
        self.support_num, self.out_channel, self.dtype = s, o, dtype
        self.narrow = in_ch < s * o
        stdv = 1.0 / (o * (s + 1)) ** 0.5
        self.weights = _uniform((in_ch, (s + 1) * o), stdv)
        self.bias = _uniform(((s + 1) * o,), stdv)
        self.directions = _uniform((point_dim, s * o), stdv)

    def forward(self, neighbor_index, vertices, feature_map, parts=False):
        """parts=True (narrow input only) returns (center, dirs, nd, x,
        w_support, b_support) without running the aggregate."""
        s, o = self.support_num, self.out_channel
        dirs = safe_normalize(self.directions, dim=0, eps=1e-12)
        nd = po.neighbor_directions(vertices, neighbor_index)
        x = feature_map.to(self.dtype)
        w = self.weights.to(self.dtype)
        bb = self.bias.to(self.dtype)
        if self.narrow:
            # gather the narrow input, transform after (same math as
            # transforming first, fewer flops while Cin < S*O)
            center = x @ w[:, :o] + bb[:o]
            if parts:
                return center, dirs, nd, x, w[:, o:], bb[o:]
            agg = gcn.aggregate_linear(nd, dirs, x, w[:, o:], bb[o:],
                                       neighbor_index, s)
        else:
            if parts:
                raise ValueError("parts=True requires narrow input (in_ch "
                                 f"{feature_map.shape[-1]} >= s*o {s * o})")
            feat = x @ w + bb
            center = feat[..., :o]
            agg = gcn.aggregate(nd, dirs, feat[..., o:], neighbor_index, s)
        return center + agg.to(self.dtype)


class PoolLayer(nn.Module):
    """Subsample, then max-pool features over the 4 nearest neighbours of
    each sampled point (excluding itself). With a `generator` (training)
    the subsample is the head of one random permutation shared across the
    batch (torch.randperm, as the reference's Pool_layer); without one
    (eval) every pooling_rate-th point. An injected `sample` wins over
    both (tests)."""

    def __init__(self, pooling_rate=4, neighbor_num=4, return_sample=False):
        super().__init__()
        self.pooling_rate, self.neighbor_num = pooling_rate, neighbor_num
        self.return_sample = return_sample

    def forward(self, vertices, feature_map, sample=None, generator=None):
        n = vertices.shape[-2]
        pool_num = n // self.pooling_rate
        if sample is None and generator is not None:
            sample = torch.randperm(n, generator=generator,
                                    device=generator.device)[:pool_num]
            sample = sample.to(vertices.device)
        elif sample is None:
            sample = torch.arange(pool_num,
                                  device=vertices.device) * self.pooling_rate
        v_s = vertices[:, sample]
        idx = po.knn_indices_cross(v_s[..., :3].contiguous(),
                                   vertices[..., :3].contiguous(),
                                   self.neighbor_num, exclude_self=True)
        pooled = po.gather_neighbors_max(feature_map, idx)
        if self.return_sample:
            return v_s, pooled, sample
        return v_s, pooled
