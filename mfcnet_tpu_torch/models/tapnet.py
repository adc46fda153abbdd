"""TAPNet — motion-prior attention U-Nets (counterpart of
``mfcnet_tpu/models/tapnet.py``; reference models/tap_model.py).

NCHW in and out: ``forward(x, attmap)`` takes the image (B, 3, H, W) and
the attention map (B, 1, H, W), the previous frame's prediction carried
along the flow (``data/attmap.py``). At each decoder stage an
``AttentionModule`` computes ``out = x + x * attmap`` after a ConvReLU and
hands the next stage a learned one-channel map, 2x-upsampled. Its head
is the reference's ``Sigmoid(Conv2dReLU(1x1))``, kept: the learned map
lies in [0.5, 1]. The first stage resizes the input map to its own size
(1/16 for TAPNet11/16, 1/8 for the generic TAPNet) bilinearly,
align_corners False, to ``int(H * s)`` x ``int(W * s)`` as the JAX module
computes it. TAPNet11 and TAPNet16 emit log-probabilities when
``num_classes > 1``; the generic TAPNet raw logits.

The module trees follow the reference (``vgg16`` / ``vgg11`` features
with ``conv1``..``conv5`` slices of them, ``center``, ``dec5``..``dec2``
with ``l.conv1``/``l.conv2`` (bilinear decoder) or ``l.conv``/``l.deconv``
(deconv decoder), ``att5``..``att1`` with ``firstconv.l.conv`` and
``learnable_attmap.0.l.conv``, ``dec1.l.conv``, ``final``), so the
reference's checkpoints load by name. The registry scales only the
encoder (``width_mult`` 1).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import (
    VGG11_STAGES,
    VGG16_STAGES,
    log_softmax_channels,
    vgg_features,
)
from mfcnet_tpu_torch.ops.resize import resize_bilinear


def upsample_2x(x):
    """Bilinear 2x, align_corners False, interpolated in float32."""
    return resize_bilinear(x, x.shape[-2] * 2, x.shape[-1] * 2)


class Conv2dReLU(nn.Module):
    """Conv (k, padding k // 2) + ReLU, keys ``l.conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.l = nn.Sequential(OrderedDict([
            ("conv", nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)),
            ("relu", nn.ReLU(inplace=True))]))

    def forward(self, x):
        return self.l(x)


class Interpolate(nn.Module):
    def forward(self, x):
        return upsample_2x(x)


class DecoderModule(nn.Module):
    """Bilinear 2x -> 2 x ConvReLU (``upsample``), or ConvReLU ->
    ConvTranspose2d(k4 s2 p1) -> ReLU (reference tap_model.py:56-91)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int,
                 upsample: bool = True):
        super().__init__()
        if upsample:
            layers = [("interpolate", Interpolate()),
                      ("conv1", Conv2dReLU(in_ch, mid_ch)),
                      ("conv2", Conv2dReLU(mid_ch, out_ch))]
        else:
            layers = [("conv", Conv2dReLU(in_ch, mid_ch)),
                      ("deconv", nn.ConvTranspose2d(mid_ch, out_ch, 4,
                                                    stride=2, padding=1)),
                      ("relu", nn.ReLU(inplace=True))]
        self.l = nn.Sequential(OrderedDict(layers))

    def forward(self, x):
        return self.l(x)


class AttentionModule(nn.Module):
    """reference tap_model.py:93-118: (x, attmap) -> (x' + x' * attmap,
    sigmoid(relu(conv1x1(...)))) with x' = ConvReLU(x)."""

    def __init__(self, in_ch: int, out_ch: int, scale_factor: float = 1.0):
        super().__init__()
        self.scale_factor = scale_factor
        self.firstconv = Conv2dReLU(in_ch, out_ch)
        self.learnable_attmap = nn.Sequential(Conv2dReLU(out_ch, 1, 1),
                                              nn.Sigmoid())

    def forward(self, x, attmap):
        if self.scale_factor != 1:
            h = int(attmap.shape[-2] * self.scale_factor)
            w = int(attmap.shape[-1] * self.scale_factor)
            attmap = resize_bilinear(attmap, h, w)
        x = self.firstconv(x)
        out = x + x * attmap
        return out, self.learnable_attmap(out)


class _TAPNetVGG(nn.Module):
    """TAPNet11/16's shared body (reference tap_model.py:173-298): a VGG
    encoder, five decoder stages behind five attention modules."""

    def __init__(self, num_classes, stage_convs, upsample, vgg_key,
                 width_mult=1.0):
        super().__init__()
        self.num_classes = num_classes
        self.vgg_key = vgg_key
        enc = vgg_features(stage_convs)
        self.add_module(vgg_key, enc)
        self.maxpool = nn.MaxPool2d(2, 2)
        # the stages as slices of the features (their keys keep the
        # features' layer indices: conv2.5, conv2.7, ... in VGG16)
        start = 0
        for si, stage in enumerate(stage_convs):
            end = start + 2 * len(stage)
            setattr(self, f"conv{si + 1}", enc[start:end])
            start = end + 1

        def c(n):
            return max(1, int(n * width_mult))

        s1, s2, s3, s4, s5 = (stage[-1] for stage in stage_convs)
        d4 = c(256) if upsample else c(128)
        self.center = DecoderModule(s5, c(512), c(256), upsample)
        self.dec5 = DecoderModule(c(256) + c(512), c(512), c(256), upsample)
        self.dec4 = DecoderModule(c(256) + c(512), c(512), d4, upsample)
        self.dec3 = DecoderModule(c(128) + c(256), c(256), c(64), upsample)
        self.dec2 = DecoderModule(c(64) + c(128), c(128), c(32), upsample)
        self.dec1 = Conv2dReLU(c(32) + c(64), c(32))
        self.att5 = AttentionModule(c(256) + s5, c(256) + c(512), 1 / 16)
        self.att4 = AttentionModule(c(256) + s4, c(256) + c(512))
        self.att3 = AttentionModule(d4 + s3, c(128) + c(256))
        self.att2 = AttentionModule(c(64) + s2, c(64) + c(128))
        self.att1 = AttentionModule(c(32) + s1, c(32) + c(64))
        self.final = nn.Conv2d(c(32), num_classes, 1)

    def forward(self, x, attmap):
        p = self.maxpool
        conv1 = self.conv1(x)
        conv2 = self.conv2(p(conv1))
        conv3 = self.conv3(p(conv2))
        conv4 = self.conv4(p(conv3))
        conv5 = self.conv5(p(conv4))
        center = self.center(p(conv5))
        att, a = self.att5(torch.cat([center, conv5], 1), attmap)
        for dec, skip, nxt in ((self.dec5, conv4, self.att4),
                               (self.dec4, conv3, self.att3),
                               (self.dec3, conv2, self.att2),
                               (self.dec2, conv1, self.att1)):
            att, a = nxt(torch.cat([dec(att), skip], 1), upsample_2x(a))
        out = self.final(self.dec1(att))
        if self.num_classes > 1:
            out = log_softmax_channels(out)
        return out


class TAPNet11(_TAPNetVGG):
    """VGG11 encoder, deconv decoder (reference tap_model.py:173-234)."""

    def __init__(self, num_classes: int, stage_convs=VGG11_STAGES,
                 width_mult: float = 1.0):
        super().__init__(num_classes, stage_convs, False, "vgg11",
                         width_mult)


class TAPNet16(_TAPNetVGG):
    """VGG16 encoder, bilinear decoder (reference tap_model.py:237-298)."""

    def __init__(self, num_classes: int, stage_convs=VGG16_STAGES,
                 width_mult: float = 1.0):
        super().__init__(num_classes, stage_convs, True, "vgg16",
                         width_mult)


class UNetModule(nn.Module):
    """2 x ConvReLU (reference tap_model.py:27-42, no BN), keys
    ``l.conv1.l.conv``, ``l.conv2.l.conv``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.l = nn.Sequential(OrderedDict([
            ("conv1", Conv2dReLU(in_ch, out_ch)),
            ("conv2", Conv2dReLU(out_ch, out_ch))]))

    def forward(self, x):
        return self.l(x)


class TAPNet(nn.Module):
    """The generic small TAPNet (reference tap_model.py:122-170): four
    UNetModule stages and a centre, attention from 1/8 up; raw logits."""

    WIDTHS = (32, 64, 128, 256, 512)

    def __init__(self, num_classes: int, in_ch: int = 3):
        super().__init__()
        w1, w2, w3, w4, w5 = self.WIDTHS
        self.conv1 = UNetModule(in_ch, w1)
        self.conv2 = UNetModule(w1, w2)
        self.conv3 = UNetModule(w2, w3)
        self.conv4 = UNetModule(w3, w4)
        self.center = UNetModule(w4, w5)
        self.att4 = AttentionModule(w5 + w4, w5 + w4, 1 / 8)
        self.up4 = UNetModule(w5 + w4, w4)
        self.att3 = AttentionModule(w4 + w3, w4 + w3)
        self.up3 = UNetModule(w4 + w3, w3)
        self.att2 = AttentionModule(w3 + w2, w3 + w2)
        self.up2 = UNetModule(w3 + w2, w2)
        self.att1 = AttentionModule(w2 + w1, w2 + w1)
        self.up1 = UNetModule(w2 + w1, w1)
        self.final = nn.Conv2d(w1, num_classes, 1)

    def forward(self, x, attmap):
        conv1 = self.conv1(x)
        conv2 = self.conv2(F.max_pool2d(conv1, 2))
        conv3 = self.conv3(F.max_pool2d(conv2, 2))
        conv4 = self.conv4(F.max_pool2d(conv3, 2))
        up = self.center(F.max_pool2d(conv4, 2))
        a = attmap
        for i, (skip, att, upm) in enumerate((
                (conv4, self.att4, self.up4), (conv3, self.att3, self.up3),
                (conv2, self.att2, self.up2), (conv1, self.att1, self.up1))):
            x, a = att(torch.cat([skip, upsample_2x(up)], 1),
                       upsample_2x(a) if i else a)
            up = upm(x)
        return self.final(up)
