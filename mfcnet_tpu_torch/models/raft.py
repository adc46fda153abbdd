"""RAFT optical flow, raft_large architecture (counterpart of
``mfcnet_tpu/models/raft.py``): the tracker's default frozen flow
provider.

Module names are torchvision ``raft_large``'s (``feature_encoder``,
``context_encoder``, ``update_block.{motion_encoder, recurrent_block,
flow_head}``, ``mask_predictor``; every encoder conv has a bias, as
torchvision builds them), so a public ``raft_large`` ``.pth`` loads with
``load_state_dict`` directly.

Public methods take and return the JAX package's NHWC layout. Inside, the
convolutions run NCHW in ``channels_last`` memory format, so the NHWC
results -- and their token-major (B, H8*W8, C) views, which the fused
update step takes -- are views without a copy.

The correlation lookup samples the (2r+1)^2 window directly (one gather
of the integer patches of all levels and one bilinear blend); the JAX
package's one-hot products, static patches and blocked pyramid replace a
gather the TPU is slow at and are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _nchw(x):
    """NHWC tensor -> NCHW view in channels_last memory format."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    """NCHW tensor -> contiguous NHWC (a view if x is channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _norm_layer(norm: str, ch: int):
    if norm == "instance":
        return nn.InstanceNorm2d(ch)
    if norm == "batch":
        return nn.BatchNorm2d(ch)
    raise ValueError(f"unknown norm {norm!r}")


def _conv_norm_relu(cin, cout, k, stride, norm, relu=True):
    layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=True),
              _norm_layer(norm, cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class ResidualBlock(nn.Module):
    """Two 3x3 conv-norm-relu, a 1x1 strided conv-norm on the skip when
    the shape changes, relu of the sum."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 norm: str = "instance"):
        super().__init__()
        self.convnormrelu1 = _conv_norm_relu(cin, cout, 3, stride, norm)
        self.convnormrelu2 = _conv_norm_relu(cout, cout, 3, 1, norm)
        if stride == 1 and cin == cout:
            self.downsample = nn.Identity()
        else:
            self.downsample = _conv_norm_relu(cin, cout, 1, stride, norm,
                                              relu=False)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        y = self.convnormrelu2(self.convnormrelu1(x))
        return self.relu(self.downsample(x) + y)


class RAFTEncoder(nn.Module):
    """Feature (instance-norm) or context (batch-norm) encoder: NCHW in,
    stride 8, ``out_features`` channels out."""

    def __init__(self, out_features: int = 256, norm: str = "instance",
                 widths=(64, 96, 128)):
        super().__init__()
        w0 = widths[0]
        self.convnormrelu = _conv_norm_relu(3, w0, 7, 2, norm)
        cin = w0
        for i, w in enumerate(widths):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, w, 1 if i == 0 else 2, norm),
                ResidualBlock(w, w, 1, norm),
            ))
            cin = w
        self.num_layers = len(widths)
        self.conv = nn.Conv2d(cin, out_features, 1)

    def forward(self, x):
        x = self.convnormrelu(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.conv(x)


def all_pairs_correlation(f1, f2):
    """(B, H, W, C) x2 -> (B, H*W, H, W) float32 correlation / sqrt(C)
    (operands widened to float32: exact products, float32 sums)."""
    B, H, W, C = f1.shape
    a = f1.reshape(B, H * W, C).float()
    b = f2.reshape(B, H * W, C).float()
    corr = torch.bmm(a, b.transpose(1, 2)) / _sqrt_channels(C, a.device)
    return corr.reshape(B, H * W, H, W)


def _sqrt_channels(C: int, device) -> torch.Tensor:
    """sqrt(C) as a float32 tensor made on ``device`` (a fill, no copy from
    the host), so that a solve captures into a CUDA graph."""
    return torch.full((), float(C), dtype=torch.float32, device=device).sqrt()


def _avg_pool2(x):
    """2x2 / stride-2 average pool of (B, N, H, W); an odd trailing row
    or column is dropped."""
    return F.avg_pool2d(x, 2, stride=2)


def build_corr_pyramid(f1, f2, num_levels: int = 4):
    pyramid = [all_pairs_correlation(f1, f2)]
    for _ in range(num_levels - 1):
        if pyramid[-1].shape[-2] < 2 or pyramid[-1].shape[-1] < 2:
            break  # tiny inputs: stop before a zero-sized level
        pyramid.append(_avg_pool2(pyramid[-1]))
    return pyramid


def num_corr_levels(h8: int, w8: int, num_levels: int = 4) -> int:
    """Levels :func:`build_corr_pyramid` makes for an (h8, w8) grid."""
    n = 1
    for _ in range(num_levels - 1):
        if h8 < 2 or w8 < 2:
            break
        h8, w8, n = h8 // 2, w8 // 2, n + 1
    return n


def _pyramid_index(sizes, K1: int, device):
    """The index constants of a :class:`PackedPyramid` whose levels have
    the (H, W) ``sizes``: each level's scale, flat start (``base``), padded
    width (``wp``), largest window start (``hi``, (x, y)) and the (2r+2)^2
    window offsets. Made on ``device`` by arithmetic on an arange, with
    nothing copied from the host, so that a solve captures into a CUDA
    graph: level l must be (H >> l, W >> l), as :func:`_avg_pool2` makes
    it from level 0's (H, W)."""
    H, W = sizes[0]
    L = len(sizes)
    lvl = torch.arange(L, device=device)
    hl, wl = H // 2 ** lvl, W // 2 ** lvl
    wp = wl + 2 * K1
    area = (hl + 2 * K1) * wp
    ar = torch.arange(K1, device=device)
    offs = ar.view(1, K1, 1) * wp.view(L, 1, 1) + ar.view(1, 1, K1)
    return ((0.5 ** lvl.float()).view(1, L, 1),
            (area.cumsum(0) - area).view(1, L),
            wp.view(1, L),
            torch.stack([wl + K1, hl + K1], dim=-1).float().view(1, L, 2),
            offs.view(1, L, K1 * K1))


class PackedPyramid:
    """A correlation pyramid laid out for one gather per lookup.

    Every level is zero-padded by K+1 = 2r+2 on each side and flattened,
    and the levels are concatenated per token: ``vol`` is (n, S) with
    n = B*H*W tokens. The padding turns zeros-padding into plain reads
    (a window start clamped into the padded range reads the true window,
    or only zeros when the true window lies outside the map), so a lookup
    needs no validity masks, and all levels share one index computation
    and one gather: about twenty small PyTorch operations per lookup, not
    thirty per level. Built once per solve; the pyramid does not change
    over the iterations."""

    def __init__(self, pyramid, radius: int = 4):
        K1 = 2 * radius + 2
        dev = pyramid[0].device
        B, N = pyramid[0].shape[:2]
        self.radius = radius
        self.vol = torch.cat(
            [F.pad(corr, (K1, K1, K1, K1)).reshape(B * N, -1)
             for corr in pyramid], dim=1)
        self.levels = len(pyramid)
        self.scale, self.base, self.wp, self.hi, self.offs = _pyramid_index(
            [tuple(corr.shape[-2:]) for corr in pyramid], K1, dev)

    def lookup(self, coords):
        """coords (B, H, W, 2) -> (B, H, W, levels*(2r+1)^2), see
        :func:`lookup_corr`."""
        B, H, W, _ = coords.shape
        n, L, r = B * H * W, self.levels, self.radius
        K, K1 = 2 * r + 1, 2 * r + 2
        c = coords.reshape(n, 1, 2).float() * self.scale     # (n, L, 2)
        c0 = torch.floor(c)
        t = c - c0
        # window start in padded coordinates, clamped into the padding
        start = torch.minimum((c0 + (K1 - r)).clamp_(min=0.0), self.hi)
        start = start.to(torch.int64)
        first = self.base + start[..., 1] * self.wp + start[..., 0]
        idx = first.unsqueeze(-1) + self.offs                  # (n, L, K1^2)
        patch = self.vol.gather(1, idx.view(n, -1)).view(n, L, K1, K1)
        tx = t[..., 0].view(n, L, 1, 1)
        ty = t[..., 1].view(n, L, 1, 1)
        top = patch[:, :, :K, :K] * (1.0 - tx) + patch[:, :, :K, 1:] * tx
        bot = patch[:, :, 1:, :K] * (1.0 - tx) + patch[:, :, 1:, 1:] * tx
        out = top * (1.0 - ty) + bot * ty                      # (n, L, Ky, Kx)
        return out.transpose(2, 3).reshape(B, H, W, L * K * K)


def lookup_corr(pyramid, coords, radius: int = 4):
    """Sample each pyramid level in a (2r+1)^2 window around ``coords``.

    coords: (B, H, W, 2) flow-displaced pixel coordinates at 1/8
    resolution (x, y). Returns (B, H, W, levels*(2r+1)^2), torchvision's
    channel order: within a level channel a*(2r+1)+b samples offset
    (dx, dy) = (a - r, b - r), x slow and y fast. The offsets are
    integers, so one (2r+2)^2 integer patch is gathered and blended once.
    A solve packs its pyramid once (:class:`PackedPyramid`) and looks up
    through it."""
    return PackedPyramid(pyramid, radius).lookup(coords)


def _conv_relu(cin, cout, k):
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=(k - 1) // 2),
                         nn.ReLU(inplace=True))


class MotionEncoder(nn.Module):
    """NCHW (flow (B, 2, h, w), corr (B, L*81, h, w)) -> (B, 128, h, w):
    126 motion channels then the flow itself."""

    def __init__(self, corr_channels: int = 324):
        super().__init__()
        self.convcorr1 = _conv_relu(corr_channels, 256, 1)
        self.convcorr2 = _conv_relu(256, 192, 3)
        self.convflow1 = _conv_relu(2, 128, 7)
        self.convflow2 = _conv_relu(128, 64, 3)
        self.conv = _conv_relu(192 + 64, 126, 3)

    def forward(self, flow, corr):
        c = self.convcorr2(self.convcorr1(corr))
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], dim=1)), flow], dim=1)


class ConvGRU(nn.Module):
    def __init__(self, input_size, hidden_size, kernel_size, padding):
        super().__init__()
        cin = hidden_size + input_size
        self.convz = nn.Conv2d(cin, hidden_size, kernel_size, padding=padding)
        self.convr = nn.Conv2d(cin, hidden_size, kernel_size, padding=padding)
        self.convq = nn.Conv2d(cin, hidden_size, kernel_size, padding=padding)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """1x5 then 5x1 ConvGRU (torchvision's ``recurrent_block``)."""

    def __init__(self, input_size: int = 256, hidden: int = 128):
        super().__init__()
        self.convgru1 = ConvGRU(input_size, hidden, (1, 5), (0, 2))
        self.convgru2 = ConvGRU(input_size, hidden, (5, 1), (2, 0))

    def forward(self, h, x):
        return self.convgru2(self.convgru1(h, x), x)


class FlowHead(nn.Module):
    def __init__(self, in_channels: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """One recurrent update without the mask head, NCHW:
    (net, inp, corr, flow) -> (net', delta flow)."""

    def __init__(self, corr_channels: int = 324, hidden: int = 128):
        super().__init__()
        self.motion_encoder = MotionEncoder(corr_channels)
        self.recurrent_block = SepConvGRU(128 + hidden, hidden)
        self.flow_head = FlowHead(hidden, 256)

    def forward(self, net, inp, corr, flow):
        motion = self.motion_encoder(flow, corr)
        net = self.recurrent_block(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


class MaskPredictor(nn.Module):
    def __init__(self, in_channels: int = 128, hidden: int = 256):
        super().__init__()
        self.convrelu = _conv_relu(in_channels, hidden, 3)
        self.conv = nn.Conv2d(hidden, 8 * 8 * 9, 1)

    def forward(self, x):
        return 0.25 * self.conv(self.convrelu(x))


def convex_upsample(flow, mask):
    """8x convex upsampling: flow (B, H, W, 2) at 1/8 resolution, mask
    (B, H, W, 576) with channel = n*64 + u*8 + v (neighbour major, as
    torchvision's ``view(B, 1, 9, 8, 8, h, w)``) -> (B, 8H, 8W, 2)."""
    B, H, W, _ = flow.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 8, 8).float(), dim=3)
    fp = F.pad(8.0 * flow.float(), (0, 0, 1, 1, 1, 1))
    neigh = torch.stack(
        [fp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
        dim=3,
    )  # (B, H, W, 9, 2), row-major (dy, dx)
    up = torch.einsum("bhwnuv,bhwnc->bhwuvc", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, H * 8, W * 8, 2)


def coords_grid(B, H8, W8, device):
    """(B, H8, W8, 2) float32 pixel coordinates (x, y)."""
    ys, xs = torch.meshgrid(
        torch.arange(H8, dtype=torch.float32, device=device),
        torch.arange(W8, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(B, H8, W8, 2)


class RAFT(nn.Module):
    """raft_large. ``forward`` returns the final upsampled flow
    (B, H, W, 2) in pixels.

    The per-image encoders and the recurrent solve are separate methods
    so that a video engine can keep ``features`` of earlier frames.
    ``fused_update`` runs the update iterations through the fused update
    step (``ops/raft_update.py``: a hand-written CUDA kernel on the card)
    with operands in ``fused_dtype``; otherwise through
    :class:`UpdateBlock`'s convolutions. ``input_hw``: the image size the
    model will see, when it is so small that the correlation pyramid has
    fewer than ``corr_levels`` levels (the motion encoder's input width
    follows the real number of levels)."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 4, fused_update: bool = False,
                 fused_dtype: str = "bfloat16", input_hw=None):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fused_update = fused_update
        self.fused_dtype = fused_dtype
        levels = corr_levels
        if input_hw is not None:
            levels = num_corr_levels(input_hw[0] // 8, input_hw[1] // 8,
                                     corr_levels)
        self.feature_encoder = RAFTEncoder(256, "instance")
        self.context_encoder = RAFTEncoder(256, "batch")
        self.update_block = UpdateBlock(levels * (2 * corr_radius + 1) ** 2)
        self.mask_predictor = MaskPredictor()
        self.to(memory_format=torch.channels_last)

    def features(self, image):
        """(B, H, W, 3) -> (B, H/8, W/8, 256) correlation features."""
        return _nhwc(self.feature_encoder(_nchw(image)))

    def context(self, image):
        """(B, H, W, 3) -> (net0, inp): GRU initial state and context."""
        ctx = _nhwc(self.context_encoder(_nchw(image)))
        return torch.tanh(ctx[..., :128]), F.relu(ctx[..., 128:])

    def flow_from_features(self, f1, f2, net, inp):
        """Recurrent solve from the encoders' outputs: f1/f2 =
        ``features`` of image1/image2, (net, inp) = ``context`` of
        image1. Returns the upsampled flow (B, H, W, 2) in pixels."""
        if self.fused_update:
            from mfcnet_tpu_torch.ops.raft_update import (
                fused_flow_from_features,
            )

            return fused_flow_from_features(
                self, f1, f2, net, inp, iters=self.iters,
                corr_levels=self.corr_levels, corr_radius=self.corr_radius,
                compute_dtype=getattr(torch, self.fused_dtype),
            )
        pyramid = PackedPyramid(
            build_corr_pyramid(f1, f2, self.corr_levels), self.corr_radius)
        B, H8, W8, _ = f1.shape
        coords0 = coords_grid(B, H8, W8, f1.device)
        dt = f1.dtype
        net_c, inp_c = _nchw(net), _nchw(inp)
        flow = torch.zeros(B, H8, W8, 2, dtype=torch.float32,
                           device=f1.device)
        for _ in range(self.iters):
            corr = pyramid.lookup(coords0 + flow)
            net_c, delta = self.update_block(
                net_c, inp_c, _nchw(corr.to(dt)), _nchw(flow.to(dt)))
            flow = flow + _nhwc(delta).float()
        mask = _nhwc(self.mask_predictor(net_c))
        return convex_upsample(flow, mask)

    def forward(self, image1, image2):
        """Images: (B, H, W, 3), normalized as the caller's pipeline
        normalizes them (the tracker passes its ImageNet-normalized
        frames straight through, as the reference does)."""
        f1 = self.features(image1)
        f2 = self.features(image2)
        net, inp = self.context(image1)
        return self.flow_from_features(f1, f2, net, inp)
