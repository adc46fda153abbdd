"""SegFormer, MiT-B3 encoder and all-MLP decoder (counterpart of
``mfcnet_tpu/models/segformer.py``): the reference's
``segmentation_models_pytorch.Segformer(encoder_name='mit_b3',
activation='logsoftmax')`` (reference models/__init__.py:47-49) under
smp's key names (``encoder.patch_embed{1-4}.{proj,norm}``,
``encoder.block{s}.{i}.{norm1,attn.{q,kv,proj,sr,norm},norm2,
mlp.{fc1,dwconv.dwconv,fc2}}``, ``encoder.norm{1-4}``,
``decoder.mlp_stage.{0-3}.linear``, ``decoder.fuse_stage.{0,1}``,
``segmentation_head.0``). NCHW in; log-probabilities at the input size out.

The JAX package runs no Pallas kernel here; attention is PyTorch's
``scaled_dot_product_attention`` (scale (C/h)^-0.5, its default) on keys
and values reduced by a stride-r conv (r = 8, 4, 2, 1) and a LayerNorm;
where a stage's size is no multiple of r, the reduction pads as the JAX
package's ``SAME`` conv does (the reference's conv pads nothing there:
ROADMAP.md Queue 3; at 480x640 every stage is a multiple).
LayerNorm eps is 1e-5 in the patch embeds and the reduction's norm, 1e-6
in the blocks and the stage norms; the Mix-FFN's GELU is the exact erf
form. In train mode the blocks drop their residual branches per sample at
0.1 * i / (n - 1) for block i of n (``common.DropPath``). The decoder
projects each stage, resizes it to stage 1's size, concatenates the
stages deepest first, fuses by a 1x1 conv, BN and ReLU, and predicts by a
3x3 conv; the logits are resized to the input size with
``align_corners=True`` and turned into log-probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d, DropPath
from mfcnet_tpu_torch.ops.resize import resize_bilinear

MIT_B3 = dict(dims=(64, 128, 320, 512), depths=(3, 4, 18, 3),
              heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1))
DROP_PATH_RATE = 0.1


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _map(x, h, w):
    """(B, H*W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1, h, w)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, h, w):
        B, N, C = x.shape
        nh = self.heads
        q = self.q(x).reshape(B, N, nh, C // nh).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            r, m = self.sr_ratio, _map(x, h, w)
            ph, pw = -h % r, -w % r
            if ph or pw:
                m = F.pad(m, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            kv_in = self.norm(_tokens(self.sr(m)))
        kv = self.kv(kv_in).reshape(B, -1, 2, nh, C // nh).permute(
            2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, kv[0], kv[1])
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, h, w):
        return _tokens(self.dwconv(_map(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, h, w):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, 4 * dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, h, w):
        x = x + self.drop_path(self.attn(self.norm1(x), h, w))
        return x + self.drop_path(self.mlp(self.norm2(x), h, w))


class MixVisionTransformer(nn.Module):
    def __init__(self, dims, depths, heads, sr_ratios,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1)
                 for i in range(total)]
        in_ch, cur = 3, 0
        for s in range(4):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            setattr(self, f"patch_embed{s + 1}",
                    OverlapPatchEmbed(in_ch, dims[s], patch, stride))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(dims[s], heads[s], sr_ratios[s], rates[cur + i])
                for i in range(depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dims[s], eps=1e-6))
            in_ch, cur = dims[s], cur + depths[s]

    def forward(self, x):
        """(B, 3, H, W) -> the four stages' (B, C_s, H_s, W_s) maps."""
        feats = []
        for s in range(1, 5):
            x, h, w = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x, h, w)
            x = _map(getattr(self, f"norm{s}")(x), h, w)
            feats.append(x)
        return feats


class MLPStage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.linear = nn.Linear(in_ch, out_ch)

    def forward(self, x):
        return _map(self.linear(_tokens(x)), x.shape[2], x.shape[3])


class SegFormerMiTB3(nn.Module):
    def __init__(self, num_classes: int, decoder_dim: int = 256,
                 dims=MIT_B3["dims"], depths=MIT_B3["depths"],
                 heads=MIT_B3["heads"], sr_ratios=MIT_B3["sr_ratios"]):
        super().__init__()
        self.num_classes = num_classes
        self.encoder = MixVisionTransformer(dims, depths, heads, sr_ratios)
        self.decoder = nn.Module()
        # mlp_stage.0 projects the deepest stage (smp's order)
        self.decoder.mlp_stage = nn.ModuleList(
            MLPStage(c, decoder_dim) for c in dims[::-1])
        self.decoder.fuse_stage = nn.Sequential(
            nn.Conv2d(4 * decoder_dim, decoder_dim, 1, bias=False),
            BatchNorm2d(decoder_dim), nn.ReLU(inplace=True))
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_dim, num_classes, 3, padding=1))

    def forward(self, x):
        H, W = x.shape[-2:]
        feats = self.encoder(x)[::-1]
        h, w = feats[-1].shape[-2:]
        y = torch.cat([resize_bilinear(m(f), h, w, align_corners=False)
                       for m, f in zip(self.decoder.mlp_stage, feats)],
                      dim=1)
        y = self.segmentation_head(self.decoder.fuse_stage(y))
        y = resize_bilinear(y, H, W, align_corners=True)
        return F.log_softmax(y, dim=1)
