"""HRNet backbone (counterpart of models/hrnet.py), NCHW inside.

Same topology and flax parameter names as the JAX module: stem of two
stride-2 3x3 ConvNorms and 4 Bottlenecks, the transitions and HRModules of
`stages`, then the two heads (feat_quarter at 1/4, feat_half at 1/2).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pose_estimation_tpu_torch.models.layers import (
    BasicBlock, Bottleneck, Conv, ConvNorm, ConvTransposeNorm, Named,
    resize_bilinear)

DEFAULT_STAGES = (
    (1, 4, (96, 96)),
    (4, 3, (96, 96, 128)),
    (3, 3, (96, 96, 128, 256)),
)


class HRModule(Named):
    """Per-branch BasicBlock stacks, then the cross-resolution fusion."""

    def __init__(self, channels: Sequence[int], num_blocks: int, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        nb = len(channels)
        self.channels = tuple(channels)
        self.blocks = [[self.child(BasicBlock(channels[i], channels[i], 1,
                                              norm, dtype))
                        for _ in range(num_blocks)] for i in range(nb)]
        self.fuse = []
        for i in range(nb):
            row = []
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append([self.child(ConvNorm(
                        channels[j], channels[i], 1, 1, False, norm, dtype))])
                else:
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = channels[i] if last else channels[j]
                        chain.append(self.child(ConvNorm(
                            channels[j], ch, 3, 2, not last, norm, dtype)))
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
                    y = resize_bilinear(ops[0](feats[j]), feats[i].shape[2],
                                        feats[i].shape[3])
                else:
                    y = feats[j]
                    for op in ops:
                        y = op(y)
                acc = y if acc is None else acc + y
            fused.append(torch.relu(acc))
        return fused


class HRNet(Named):
    """Returns (feat_quarter, feat_half), NCHW."""

    def __init__(self, in_ch=3, backbone_outc=256, stages: Tuple = DEFAULT_STAGES,
                 stem_width=64, norm="gn", dtype=torch.float32):
        super().__init__()
        self.child(ConvNorm(in_ch, stem_width, 3, 2, True, norm, dtype))
        self.child(ConvNorm(stem_width, stem_width, 3, 2, True, norm, dtype))
        ch = stem_width
        self.stem = []
        for _ in range(4):
            self.stem.append(self.child(Bottleneck(ch, stem_width, 1, norm,
                                                   dtype)))
            ch = stem_width * 4
        prev = (stem_width * 4,)
        self.stages = []
        for (num_modules, num_blocks, channels) in stages:
            # (module or None, source branch): keep, adapt channels, or
            # add a branch by a stride-2 conv of the lowest-resolution one
            trans = []
            for i, c in enumerate(channels):
                if i < len(prev):
                    trans.append((None if prev[i] == c else self.child(
                        ConvNorm(prev[i], c, 3, 1, True, norm, dtype)), i))
                else:
                    trans.append((self.child(
                        ConvNorm(prev[-1], c, 3, 2, True, norm, dtype)), -1))
            mods = [self.child(HRModule(channels, num_blocks, norm, dtype))
                    for _ in range(num_modules)]
            self.stages.append((trans, mods))
            prev = tuple(channels)
        cat = sum(prev)
        self.child(ConvNorm(cat, cat, 3, 1, True, norm, dtype))
        self.child(Conv(cat, backbone_outc, 1, 1, True, dtype))
        self.head_name = f"ConvNorm_{self._counts['ConvNorm'] - 1}"
        self.child(ConvTransposeNorm(cat + backbone_outc, backbone_outc, 4,
                                     norm, dtype))
        self.child(BasicBlock(backbone_outc, backbone_outc, 1, norm, dtype))

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
        cat = torch.cat([feats[0]] + [resize_bilinear(f, h, w)
                                      for f in feats[1:]], dim=1)
        inter = getattr(self, self.head_name)(cat)
        feat_quarter = self.Conv_0(inter)
        y = torch.cat([inter, feat_quarter.to(inter.dtype)], dim=1)
        feat_half = self.BasicBlock_0(self.ConvTransposeNorm_0(y))
        return feat_quarter, feat_half
