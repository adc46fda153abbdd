"""Dilated ResNet-101 backbone of DeepLabV3 and FCN (counterpart of
``mfcnet_tpu/models/resnet.py``).

torchvision's ``resnet101`` with ``replace_stride_with_dilation=[False,
True, True]`` (output stride 8), as ``deeplabv3_resnet101`` and
``fcn_resnet101`` build it (reference models/__init__.py:32-37), with
torchvision's module names (``conv1``, ``bn1``, ``layer3.0.downsample.0``,
...), so a reference checkpoint's ``backbone.*`` keys load by name. NCHW in,
(N, 8w * 4, H/8, W/8) out.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4), residual
    (``mfcnet_tpu/models/resnet.py:24-63``)."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = BatchNorm2d(4 * width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, 4 * width, 1, stride=stride, bias=False),
            BatchNorm2d(4 * width)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetDilated(nn.Module):
    """``layers`` blocks per stage ((3, 4, 23, 3): ResNet-101), base width
    ``width``. Stages 3 and 4 trade their stride for dilation 2 and 4; the
    first block of a dilated stage keeps the previous dilation, max(1,
    dil // 2) (``mfcnet_tpu/models/resnet.py:96-101``). The stem's
    max-pool pads with -inf (PyTorch's ``MaxPool2d`` does), as the JAX
    package pads (``:81-83``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 width: int = 64):
        super().__init__()
        w = width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(w)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = w
        for si, (f, stride, dil) in enumerate(
                ((w, 1, 1), (2 * w, 2, 1), (4 * w, 1, 2), (8 * w, 1, 4))):
            blocks = []
            for bi in range(layers[si]):
                first = bi == 0
                blocks.append(Bottleneck(
                    in_ch, f, stride=stride if first else 1,
                    dilation=max(1, dil // 2) if first else dil,
                    downsample=first))
                in_ch = 4 * f
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.out_channels = in_ch

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
