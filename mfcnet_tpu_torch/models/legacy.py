"""The reference's unused model families (counterpart of
``mfcnet_tpu/models/legacy.py``): the Du et al. 2018 part-affinity-field
detector (reference models/PAF_model.py), the ResNet50-CSL joint
segmentation and localization net (models/resnet.py) and the Kurmann et
al. 2017 net (models/unet.py:66-118). No entry point of the reference, the
JAX package or the port builds them; they complete the inventory. The
JAX modules fix the reference's bugs (PAF's num_joints attribute, CSL's
stray ``pdb.set_trace()``, Kurmann's ``F.maxpool2d`` typo and undefined
``x_c``, read from the encoder's bottleneck), and so do these.

NCHW in and out. The reference cannot run two of the three as written, so
the modules carry the JAX module tree's names, as the port's UNet does:
flax's auto-names in creation order (``_CBR_i`` with ``Conv_0`` and
``BatchNorm_0``, ``_DBR_i`` with ``TorchConvTranspose_0``,
``Bottleneck_i``, ``ResNetUpProjection_i``, ``UNetBlock_i``, ``UpConv_i``,
``Conv_i``, ``Dense_i``), so that a JAX checkpoint maps onto them name for
name (``compat/from_jax.py``). Every batch norm is
``models/common.py::BatchNorm2d`` (flax's rules).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d
from mfcnet_tpu_torch.models.resnet import Bottleneck
from mfcnet_tpu_torch.models.unet import UNetBlock, UpConv
from mfcnet_tpu_torch.ops.resize import resize_bilinear


class _CBR(nn.Module):
    """Conv + BN + ReLU (reference models/PAF_model.py CBR): a 2x2 stride-2
    conv unpadded, any other kernel padded by k // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        pad = 0 if (kernel, stride) == (2, 2) else kernel // 2
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, stride, pad)
        self.BatchNorm_0 = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _DBR(nn.Module):
    """2x2 stride-2 deconv + BN + ReLU (reference models/PAF_model.py
    DBR)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.TorchConvTranspose_0 = nn.ConvTranspose2d(in_ch, out_ch, 2, 2)
        self.BatchNorm_0 = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.TorchConvTranspose_0(x)))


class PAFDetectionModel(nn.Module):
    """Dual-branch part-affinity-field detector (reference
    models/PAF_model.py:63-164): four down stages of two k2-s2 branches
    fused by a 1x1 CBR, three up stages of two deconv branches (the first
    two with skips), and two deconv heads. Returns (joint heatmaps,
    association fields). ``width`` 64 is the reference's; H and W must be
    divisible by 16."""

    def __init__(self, num_joints: int, num_joint_associations: int,
                 width: int = 64):
        super().__init__()
        w, count = width, {"_CBR": 0, "_DBR": 0}

        def add(mod):
            kind = type(mod).__name__
            self.add_module(f"{kind}_{count[kind]}", mod)
            count[kind] += 1
            return mod

        # flax names a compact module's children as they are built: the
        # outer CBR of ``_CBR(f)(_CBR(f, 2, 2)(x))`` before the inner one
        self._stem = add(_CBR(3, w))
        self._downs = []
        for s in range(4):
            f = w * 2 ** s
            self._downs.append((add(_CBR(f, f)), add(_CBR(f, f, 2, 2)),
                                add(_CBR(f, f)), add(_CBR(f, f, 2, 2)),
                                add(_CBR(2 * f, 2 * f, 1))))
        self._ups = []
        for f in (4 * w, 2 * w, w):
            self._ups.append((add(_CBR(f, f)), add(_DBR(2 * f, f)),
                              add(_CBR(f, f)), add(_DBR(2 * f, f)),
                              add(_CBR(2 * f, 2 * f, 1))))
        h = w // 2
        self._last = (add(_CBR(h, h)), add(_DBR(w, h)), add(_CBR(h, h)),
                      add(_DBR(w, h)))
        self.Conv_0 = nn.Conv2d(h, num_joints, 1)
        self.Conv_1 = nn.Conv2d(h, num_joint_associations, 1)

    @staticmethod
    def _halves(x, a, a_in, b, b_in):
        half = x.shape[1] // 2
        return a(a_in(x[:, :half])), b(b_in(x[:, half:]))

    def forward(self, x):
        x = self._stem(x)
        skips = []
        for a3, a2, b3, b2, fuse in self._downs:
            x = fuse(torch.cat([a3(a2(x)), b3(b2(x))], 1))
            skips.append(x)
        for (a, ad, b, bd, fuse), skip in zip(self._ups,
                                              (skips[2], skips[1], None)):
            x = fuse(torch.cat(self._halves(x, a, ad, b, bd), 1))
            if skip is not None:
                x = x + skip
        joints, assoc = self._halves(x, *self._last)
        return self.Conv_0(joints), self.Conv_1(assoc)


class ResNetUpProjection(nn.Module):
    """Bilinear 2x, then relu(conv5x5) -> conv3x3 plus a conv5x5 shortcut,
    ReLU (reference models/resnet.py:135-150)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 5, padding=2)
        self.Conv_1 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.Conv_2 = nn.Conv2d(in_ch, out_ch, 5, padding=2)

    def forward(self, x):
        x = resize_bilinear(x, x.shape[-2] * 2, x.shape[-1] * 2)
        y = self.Conv_1(F.relu(self.Conv_0(x)))
        return F.relu(y + self.Conv_2(x))


class ResNet50CSL(nn.Module):
    """ResNet50 encoder and up-projection decoder with joint segmentation
    and localization heads (reference models/resnet.py:152-190). Returns
    (class probabilities, localization maps), both resized to the input's
    H and W. ``layers`` and ``width`` shrink for tests; H and W must be
    divisible by 32."""

    def __init__(self, num_classes: int, num_joints: int,
                 layers=(3, 4, 6, 3), width: int = 64):
        super().__init__()
        w = width
        self.Conv_0 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm2d(w)
        in_ch, i, self._stage_ends = w, 0, []
        for si, n in enumerate(layers):
            f = w * 2 ** si
            for bi in range(n):
                self.add_module(f"Bottleneck_{i}", Bottleneck(
                    in_ch, f, stride=2 if si > 0 and bi == 0 else 1,
                    downsample=bi == 0))
                in_ch, i = 4 * f, i + 1
            self._stage_ends.append(i)
        c1, c2, c3, c4 = (4 * w * 2 ** si for si in range(4))
        self.Conv_1 = nn.Conv2d(c4, c4 // 2, 1)
        self.Conv_2 = nn.Conv2d(c3, c3 // 2, 1)
        self.Conv_3 = nn.Conv2d(c2, c2 // 2, 1)
        self.Conv_4 = nn.Conv2d(c1, c1 // 2, 1)
        for j, (cin, cout) in enumerate(((c4 // 2, c3 // 2),
                                         (c3 // 2, c2 // 2),
                                         (c2 // 2, c1 // 2), (c1 // 2, w))):
            self.add_module(f"ResNetUpProjection_{j}",
                            ResNetUpProjection(cin, cout))
        self.Conv_5 = nn.Conv2d(w, num_classes, 1, bias=False)
        self.Conv_6 = nn.Conv2d(w, w // 2, 1)
        self.Conv_7 = nn.Conv2d(w // 2 + num_classes, num_joints, 1,
                                bias=False)

    def forward(self, x):
        H, W = x.shape[-2:]
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        skips, i = [], 0
        for end in self._stage_ends:
            for i in range(i, end):
                x = getattr(self, f"Bottleneck_{i}")(x)
            i = end
            skips.append(x)
        x1, x2, x3, x4 = skips
        y = F.relu(self.Conv_1(x4))
        for j, (conv, skip) in enumerate(((self.Conv_2, x3),
                                          (self.Conv_3, x2),
                                          (self.Conv_4, x1))):
            y = getattr(self, f"ResNetUpProjection_{j}")(y)
            y = y + F.relu(conv(skip))
        y = self.ResNetUpProjection_3(y)
        seg_logits = self.Conv_5(y)
        loc = self.Conv_7(torch.cat([self.Conv_6(y), seg_logits], 1))
        seg = resize_bilinear(F.softmax(seg_logits, dim=1), H, W)
        return seg, resize_bilinear(loc, H, W)


class KurmannEtAl2017Net(nn.Module):
    """Joint segmentation and presence classification (reference
    models/unet.py:66-118): the UNet's six blocks down and five UpConvs
    back to ``num_classes * num_joints`` heatmaps, and from the bottleneck a
    3x3 conv to 128 channels, flattened in the JAX package's (H, W, C)
    order, through three dense layers to class presence probabilities.
    The first dense layer's width follows the input: ``input_hw`` (H and W
    divisible by 32) fixes it. Returns (heatmaps, presence (B, classes))."""

    def __init__(self, num_classes: int, num_joints: int,
                 dims=(64, 128, 256, 512, 1024, 2048), input_hw=(480, 640)):
        super().__init__()
        d = tuple(dims)
        for i, c in enumerate(d):
            self.add_module(f"UNetBlock_{i}",
                            UNetBlock(3 if i == 0 else d[i - 1], c))
        for i in range(5):
            self.add_module(f"UpConv_{i}",
                            UpConv(d[5 - i], d[4 - i], d[4 - i]))
        self.Conv_0 = nn.Conv2d(d[0], num_classes * num_joints, 1)
        self.Conv_1 = nn.Conv2d(d[5], 128, 3, padding=1)
        h, w = input_hw[0] // 32, input_hw[1] // 32
        self.Dense_0 = nn.Linear(128 * h * w, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, num_classes)

    def forward(self, x):
        skips = []
        for i in range(6):
            if i:
                skips.append(x)
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"UNetBlock_{i}")(x)
        enc = x
        for i in range(5):
            x = getattr(self, f"UpConv_{i}")(x, skips.pop())
        c = F.relu(self.Conv_1(enc)).permute(0, 2, 3, 1).flatten(1)
        c = F.relu(self.Dense_1(F.relu(self.Dense_0(c))))
        return self.Conv_0(x), F.softmax(self.Dense_2(c), dim=-1)
