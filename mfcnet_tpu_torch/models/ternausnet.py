"""TernausNet11 and TernausNet16 — VGG-encoder U-Nets (counterpart of
``mfcnet_tpu/models/ternausnet.py``; reference models/ternausnet.py:45-150).

NCHW in and out. Emits per-pixel log-probabilities when
``num_classes > 1``, raw single-channel logits otherwise. The module trees
are the reference's, so reference checkpoints load with
``load_state_dict`` as they are: ``encoder`` = torchvision VGG ``features``
with views over it (TernausNet16: the ``conv1``..``conv5`` stage
sequences; TernausNet11: the reference's single-conv aliases ``conv1``,
``conv2``, ``conv3s``, ``conv3``, ..., ``conv5``), ``center``,
``dec5``..``dec2`` deconv blocks, ``dec1``, ``final``. Input H, W must be
divisible by 32. ``remat``: while training, the encoder is one
rematerialized segment and each of ``center``, ``dec5``..``dec2`` another
(``models/common.py::run_segment``), as the JAX package's ``nn.remat``
wraps them.
"""

from __future__ import annotations

import torch
from torch import nn

from mfcnet_tpu_torch.models.common import (
    VGG11_STAGES,
    VGG16_STAGES,
    ConvReLU,
    DecoderBlockDeconv,
    log_softmax_channels,
    run_segment,
    vgg_features,
)


class _TernausNet(nn.Module):
    """The shared decoder: ``dec4_out`` is the one width in which
    TernausNet11 (nf * 4) and TernausNet16 (nf * 8) differ. ``stage_convs``
    overrides the encoder widths (tests use tiny stacks); ``num_filters``
    is the decoder's base width."""

    def __init__(self, num_classes, num_filters, stage_convs, dec4_out,
                 remat=False):
        super().__init__()
        self.num_classes = num_classes
        self.remat = remat
        nf = num_filters
        self.pool = nn.MaxPool2d(2, 2)
        self.encoder = vgg_features(stage_convs)
        self.add_views(stage_convs)
        s1, s2, s3, s4, s5 = (stage[-1] for stage in stage_convs)
        self.center = DecoderBlockDeconv(s5, nf * 16, nf * 8)
        self.dec5 = DecoderBlockDeconv(s5 + nf * 8, nf * 16, nf * 8)
        self.dec4 = DecoderBlockDeconv(s4 + nf * 8, nf * 16, dec4_out)
        self.dec3 = DecoderBlockDeconv(s3 + dec4_out, nf * 8, nf * 2)
        self.dec2 = DecoderBlockDeconv(s2 + nf * 2, nf * 4, nf)
        self.dec1 = ConvReLU(s1 + nf, nf)
        self.final = nn.Conv2d(nf, num_classes, kernel_size=1)

    def add_views(self, stage_convs):
        """Register the reference's views over ``encoder`` (before the
        decoder, in the reference's module order)."""
        raise NotImplementedError

    def encode(self, x):
        """The encoder's five stage outputs."""
        raise NotImplementedError

    def forward(self, x):
        return self.decode(*run_segment(self.remat, self.encode, x))

    def decode(self, conv1, conv2, conv3, conv4, conv5):
        def seg(block, x):
            return run_segment(self.remat, block, x)

        center = seg(self.center, self.pool(conv5))
        dec5 = seg(self.dec5, torch.cat([center, conv5], 1))
        dec4 = seg(self.dec4, torch.cat([dec5, conv4], 1))
        dec3 = seg(self.dec3, torch.cat([dec4, conv3], 1))
        dec2 = seg(self.dec2, torch.cat([dec3, conv2], 1))
        dec1 = self.dec1(torch.cat([dec2, conv1], 1))
        out = self.final(dec1)
        if self.num_classes > 1:
            out = log_softmax_channels(out)
        return out


class TernausNet16(_TernausNet):
    """VGG16 encoder (reference models/ternausnet.py:98-150)."""

    def __init__(self, num_classes: int = 1, num_filters: int = 32,
                 stage_convs=VGG16_STAGES, remat: bool = False):
        super().__init__(num_classes, num_filters, stage_convs,
                         num_filters * 8, remat)

    def add_views(self, stage_convs):
        self.relu = nn.ReLU(inplace=True)
        idx = 0
        for si, stage in enumerate(stage_convs):
            mods = []
            for _ in stage:
                mods += [self.encoder[idx], self.relu]
                idx += 2
            idx += 1  # the stage's max-pool
            setattr(self, f"conv{si + 1}", nn.Sequential(*mods))

    def encode(self, x):
        conv1 = self.conv1(x)
        conv2 = self.conv2(self.pool(conv1))
        conv3 = self.conv3(self.pool(conv2))
        conv4 = self.conv4(self.pool(conv3))
        conv5 = self.conv5(self.pool(conv4))
        return conv1, conv2, conv3, conv4, conv5


#: TernausNet11's aliases of its VGG11 encoder's convolutions, at
#: torchvision's layer indices (reference models/ternausnet.py:45-96)
VGG11_ALIASES = (("conv1", 0), ("conv2", 3), ("conv3s", 6), ("conv3", 8),
                 ("conv4s", 11), ("conv4", 13), ("conv5s", 16),
                 ("conv5", 18))


class TernausNet11(_TernausNet):
    """VGG11 encoder, ``dec4`` of nf * 4 channels (reference
    models/ternausnet.py:45-96). The reference's ``center`` declares 256 +
    nf * 8 input channels, which is its encoder's 512 only at nf = 32; it
    takes the encoder's last width here, as the JAX module infers it."""

    def __init__(self, num_classes: int = 1, num_filters: int = 32,
                 stage_convs=VGG11_STAGES, remat: bool = False):
        if tuple(map(len, stage_convs)) != (1, 1, 2, 2, 2):
            raise ValueError("TernausNet11 takes VGG11's stages of 1, 1, 2, "
                             f"2, 2 convolutions, got {stage_convs}")
        super().__init__(num_classes, num_filters, stage_convs,
                         num_filters * 4, remat)

    def add_views(self, stage_convs):
        self.relu = self.encoder[1]
        for name, idx in VGG11_ALIASES:
            setattr(self, name, self.encoder[idx])

    def encode(self, x):
        r, p = self.relu, self.pool
        conv1 = r(self.conv1(x))
        conv2 = r(self.conv2(p(conv1)))
        conv3 = r(self.conv3(r(self.conv3s(p(conv2)))))
        conv4 = r(self.conv4(r(self.conv4s(p(conv3)))))
        conv5 = r(self.conv5(r(self.conv5s(p(conv4)))))
        return conv1, conv2, conv3, conv4, conv5
