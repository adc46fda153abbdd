"""DeepLabV3 on the dilated ResNet-101 (counterpart of
``mfcnet_tpu/models/deeplab.py``): torchvision's ``deeplabv3_resnet101``
with a fresh ``DeepLabHead(2048, num_classes)`` (reference
models/__init__.py:32-34), under torchvision's key names (``backbone.*``,
``classifier.0.convs.{0..4}``, ``classifier.0.project``, ``classifier.{1,
2,4}``). NCHW in; raw logits at the input size out (bilinear,
``align_corners=False``).

ASPP has no dropout, as in the JAX package (``deeplab.py:58-61``);
torchvision's ends with ``Dropout(0.5)`` (ROADMAP.md Queue 3). Its three
atrous convolutions (rates 12, 24, 36) run as ordinary 3x3 convolutions
on the rate x rate phase sub-grids of their input (space to batch,
:func:`atrous_conv2d`): the same sums, where cuDNN's own dilated kernel
for such rates took 49-77 ms a call on an H100 on the engine's
channels-last 2048x60x80 input, against 0.24-0.36 ms (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d
from mfcnet_tpu_torch.models.resnet import ResNetDilated
from mfcnet_tpu_torch.ops.resize import resize_bilinear

ASPP_RATES = (12, 24, 36)
ASPP_CH = 256


def atrous_conv2d(x, weight, rate: int):
    """A 3x3 convolution at dilation ``rate`` with zero padding ``rate``
    (no bias), as a 3x3 convolution with padding 1 over the rate x rate
    phase sub-grids of ``x`` batched together: output pixel (q r + a,
    q' r + b) reads only sub-grid (a, b), at (q, q') and its neighbours;
    the input is padded with zeros at the end to a multiple of ``rate``."""
    N, Ci, H, W = x.shape
    h, w = -(-H // rate), -(-W // rate)
    x = F.pad(x, (0, w * rate - W, 0, h * rate - H))
    x = x.view(N, Ci, h, rate, w, rate).permute(0, 3, 5, 1, 2, 4)
    y = F.conv2d(x.reshape(N * rate * rate, Ci, h, w), weight, padding=1)
    y = y.view(N, rate, rate, -1, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(N, -1, h * rate, w * rate)[:, :, :H, :W]


class AtrousConv2d(nn.Conv2d):
    """``nn.Conv2d(in, out, 3, padding=rate, dilation=rate, bias=False)``
    (its key names) computed by :func:`atrous_conv2d`."""

    def __init__(self, in_ch: int, out_ch: int, rate: int):
        super().__init__(in_ch, out_ch, 3, padding=rate, dilation=rate,
                         bias=False)

    def forward(self, x):
        return atrous_conv2d(x, self.weight, self.dilation[0])


def _conv_bn_relu(in_ch, out_ch, rate=0):
    conv = (AtrousConv2d(in_ch, out_ch, rate) if rate
            else nn.Conv2d(in_ch, out_ch, 1, bias=False))
    return nn.Sequential(conv, BatchNorm2d(out_ch), nn.ReLU(inplace=True))


class ASPPPooling(nn.Sequential):
    """Image pooling: the spatial mean, 1x1 conv, BN, ReLU, broadcast back
    (``nn.AdaptiveAvgPool2d(1)`` at index 0 keeps torchvision's keys)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(in_ch, out_ch, 1, bias=False),
                         BatchNorm2d(out_ch), nn.ReLU(inplace=True))

    def forward(self, x):
        p = x.mean(dim=(2, 3), keepdim=True)
        for mod in list(self)[1:]:
            p = mod(p)
        return p.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, in_ch: int, rates=ASPP_RATES, out_ch: int = ASPP_CH):
        super().__init__()
        self.convs = nn.ModuleList(
            [_conv_bn_relu(in_ch, out_ch)]
            + [_conv_bn_relu(in_ch, out_ch, r) for r in rates]
            + [ASPPPooling(in_ch, out_ch)])
        self.project = _conv_bn_relu(len(self.convs) * out_ch, out_ch)

    def forward(self, x):
        return self.project(torch.cat([m(x) for m in self.convs], dim=1))


class DeepLabHead(nn.Sequential):
    def __init__(self, in_ch: int, num_classes: int):
        super().__init__(ASPP(in_ch),
                         nn.Conv2d(ASPP_CH, ASPP_CH, 3, padding=1,
                                   bias=False),
                         BatchNorm2d(ASPP_CH), nn.ReLU(inplace=True),
                         nn.Conv2d(ASPP_CH, num_classes, 1))


class DeepLabV3ResNet101(nn.Module):
    def __init__(self, num_classes: int, layers=(3, 4, 23, 3),
                 width: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetDilated(layers, width)
        self.classifier = DeepLabHead(self.backbone.out_channels,
                                      num_classes)

    def forward(self, x):
        H, W = x.shape[-2:]
        return resize_bilinear(self.classifier(self.backbone(x)), H, W,
                               align_corners=False)
