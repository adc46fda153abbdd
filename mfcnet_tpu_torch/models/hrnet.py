"""HRNet-W48 segmentation (counterpart of ``mfcnet_tpu/models/hrnet.py``;
reference models/hrnet.py:271-476) under the reference's module names
(``conv1``, ``layer1``, ``transition{1,2,3}``, ``stage{2,3,4}.{m}.branches``,
``.fuse_layers``, ``last_layer``), so ``hrnet_cs_8090_torch11.pth`` loads by
name. NCHW in; raw logits at the input size out.

Stem: two stride-2 3x3 convs at 64 channels; stage 1: four Bottlenecks;
stages 2-4: 1, 4 and 3 modules of 2, 3 and 4 branches, 4 BasicBlocks a
branch, then the fuse (``:85-121``): branch j into branch i by a 1x1 conv,
BN and a bilinear resize (``align_corners=False``) to branch i's exact size
when j > i, by a chain of i - j stride-2 3x3 convs with BN (ReLU on all
but the last) when j < i; the sums in order of j, then ReLU. Head
(``:190-200``): every branch resized to branch 0's size, concatenated, a
1x1 conv with bias, BN, ReLU, a 1x1 conv to the classes, a resize to the
input size.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d
from mfcnet_tpu_torch.ops.resize import resize_bilinear

HRNET_W48 = (48, 96, 192, 384)
STEM_CH = 64


def _conv_bn(in_ch, out_ch, k=3, stride=1, relu=True):
    mods = [nn.Conv2d(in_ch, out_ch, k, stride, k // 2, bias=False),
            BatchNorm2d(out_ch)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


class BasicBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(ch)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = BatchNorm2d(4 * width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_conv_bn(in_ch, 4 * width, 1, relu=False)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        return self.relu(self.bn3(self.conv3(y)) + identity)


class HRModule(nn.Module):
    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c) for _ in range(num_blocks)))
            for c in channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1,
                                        relu=False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1
                                 else channels[j], 3, 2,
                                 relu=k < i - j - 1)
                        for k in range(i - j))))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs):
        ys = [br(x) for br, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            h, w = ys[i].shape[-2:]
            acc = None
            for j, y in enumerate(ys):
                if j > i:
                    y = resize_bilinear(row[j](y), h, w, align_corners=False)
                elif j < i:
                    y = row[j](y)
                acc = y if acc is None else acc + y
            outs.append(self.relu(acc))
        return outs


class HRNetW48(nn.Module):
    """``channels``, ``stage_modules``, ``num_blocks`` and
    ``stage1_width`` shrink it as the JAX registry's ``scale`` does; the
    stem keeps 64 channels and stage 1 four Bottlenecks at any scale."""

    def __init__(self, num_classes: int, channels=HRNET_W48,
                 stage_modules=(1, 4, 3), num_blocks: int = 4,
                 stage1_width: int = 64):
        super().__init__()
        self.num_classes = num_classes
        ch = tuple(channels)
        w = stage1_width
        self.conv1 = nn.Conv2d(3, STEM_CH, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(STEM_CH)
        self.conv2 = nn.Conv2d(STEM_CH, STEM_CH, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(STEM_CH)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(
            Bottleneck(STEM_CH, w, downsample=True),
            *(Bottleneck(4 * w, w) for _ in range(3)))
        self.transition1 = nn.ModuleList([
            _conv_bn(4 * w, ch[0]),
            nn.Sequential(_conv_bn(4 * w, ch[1], stride=2))])
        for s in (2, 3, 4):
            setattr(self, f"stage{s}", nn.Sequential(*(
                HRModule(ch[:s], num_blocks)
                for _ in range(stage_modules[s - 2]))))
            if s < 4:
                setattr(self, f"transition{s}", nn.ModuleList(
                    [None] * s
                    + [nn.Sequential(_conv_bn(ch[s - 1], ch[s], stride=2))]))
        total = sum(ch)
        self.last_layer = nn.Sequential(
            nn.Conv2d(total, total, 1), BatchNorm2d(total),
            nn.ReLU(inplace=True), nn.Conv2d(total, num_classes, 1))

    def forward(self, x):
        H, W = x.shape[-2:]
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [self.transition2[2](xs[-1])])
        xs = self.stage4(xs + [self.transition3[3](xs[-1])])
        h, w = xs[0].shape[-2:]
        y = torch.cat([xs[0]] + [resize_bilinear(t, h, w,
                                                 align_corners=False)
                                 for t in xs[1:]], dim=1)
        return resize_bilinear(self.last_layer(y), H, W, align_corners=False)
