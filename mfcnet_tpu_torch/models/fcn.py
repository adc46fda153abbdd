"""FCN on the dilated ResNet-101 (counterpart of
``mfcnet_tpu/models/fcn.py``): torchvision's ``fcn_resnet101`` with a
fresh ``FCNHead(2048, num_classes)`` (reference models/__init__.py:35-37),
under torchvision's key names (``backbone.*``, ``classifier.{0,1,4}``).
NCHW in; raw logits at the input size out (bilinear,
``align_corners=False``). The head's ``Dropout(0.1)`` acts in train mode
and draws from the train step's generator (``common.Dropout``).
"""

from __future__ import annotations

from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d, Dropout
from mfcnet_tpu_torch.models.resnet import ResNetDilated
from mfcnet_tpu_torch.ops.resize import resize_bilinear


class FCNHead(nn.Sequential):
    """Conv3x3 (-> in/4) + BN + ReLU + Dropout(0.1) + Conv1x1."""

    def __init__(self, in_ch: int, num_classes: int):
        mid = in_ch // 4
        super().__init__(nn.Conv2d(in_ch, mid, 3, padding=1, bias=False),
                         BatchNorm2d(mid), nn.ReLU(inplace=True),
                         Dropout(0.1), nn.Conv2d(mid, num_classes, 1))


class FCNResNet101(nn.Module):
    def __init__(self, num_classes: int, layers=(3, 4, 23, 3),
                 width: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetDilated(layers, width)
        self.classifier = FCNHead(self.backbone.out_channels, num_classes)

    def forward(self, x):
        H, W = x.shape[-2:]
        return resize_bilinear(self.classifier(self.backbone(x)), H, W,
                               align_corners=False)
