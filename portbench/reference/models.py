"""Plain PyTorch reference of TernausNetMulti-Basic with the frozen RAFT flow
provider, as the tracker runs it, and of RAFT alone on whole frame pairs, as
the offline flow CLI runs it: written from the published architectures
(TernausNet16 on torchvision's VGG16 ``features``; MFCNet's Basic fusion head
with its flow warp on a 576x720 mesh; torchvision's ``raft_large``), in
float32, NCHW, with no kernel, cache, ring or batching of the program.

Weights are a dict of tensors under the published checkpoints' names
(``base_model.encoder.0.weight``, ``multiframe_net.multiframe_net.0.weight``,
``feature_encoder.convnormrelu.0.weight``, ...), the dict the benchmark makes
from its seed. Every convolution goes through :func:`conv`, whose ``q``
rounds its operands and output: ``None`` for the reference, a rounding to a
lower precision for the control (``reference/quant.py``).

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BN_EPS = 1e-5


def conv(x, w, b=None, stride=1, padding=0, q=None, transposed=False):
    """One convolution (or a transposed one). With the quantizer ``q`` its
    operands and its output are rounded, as a program computing in that
    precision holds them."""
    if q is not None:
        x, w = q(x), q(w)
    if transposed:
        y = F.conv_transpose2d(x, w, b, stride=stride, padding=padding)
    else:
        y = F.conv2d(x, w, b, stride=stride, padding=padding)
    return y if q is None else q(y)


def batch_norm_eval(x, p, name):
    """Batch norm by running statistics (eval mode)."""
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], False, 0.0,
                        BN_EPS)


def normalize(frames_u8):
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32: /255, ImageNet mean and
    std."""
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# ----------------------------------------------------------- TernausNet16
def vgg_conv_indices(stages):
    """torchvision's layer index of each VGG convolution, per stage: a conv
    and a ReLU each, then a max-pool closing the stage."""
    out, idx = [], 0
    for stage in stages:
        cur = []
        for _ in stage:
            cur.append(idx)
            idx += 2
        idx += 1
        out.append(cur)
    return out


def ternausnet16_maps(p, x, stages, q=None, prefix="base_model."):
    """(N, 3, H, W) normalized frames -> (N, C, H, W) class probabilities:
    TernausNet16's log-softmax output, exponentiated as the multi-frame
    wrapper feeds it to the head."""
    e = prefix + "encoder."

    def cr(h, name):
        return F.relu(conv(h, p[name + ".weight"], p[name + ".bias"],
                           padding=1, q=q))

    def block(h, name):
        h = cr(h, name + ".block.0.conv")
        h = conv(h, p[name + ".block.1.weight"], p[name + ".block.1.bias"],
                 stride=2, padding=1, q=q, transposed=True)
        return F.relu(h)

    skips, h = [], x
    for si, idxs in enumerate(vgg_conv_indices(stages)):
        if si:
            h = F.max_pool2d(h, 2, 2)
        for i in idxs:
            h = cr(h, f"{e}{i}")
        skips.append(h)
    c1, c2, c3, c4, c5 = skips
    center = block(F.max_pool2d(c5, 2, 2), prefix + "center")
    d5 = block(torch.cat([center, c5], 1), prefix + "dec5")
    d4 = block(torch.cat([d5, c4], 1), prefix + "dec4")
    d3 = block(torch.cat([d4, c3], 1), prefix + "dec3")
    d2 = block(torch.cat([d3, c2], 1), prefix + "dec2")
    d1 = cr(torch.cat([d2, c1], 1), prefix + "dec1.conv")
    out = conv(d1, p[prefix + "final.weight"], p[prefix + "final.bias"], q=q)
    return torch.exp(F.log_softmax(out, dim=1))


# ------------------------------------------------------ MFCNet Basic head
def warp(maps, flow, grid_hw):
    """Bilinear warp of (N, C, H, W) maps by (N, 2, H, W) flow in pixels
    (x first): the sampling grid is the (gh, gw) mesh's top-left (H, W) crop
    plus the flow over (size - 1) / 2, with align_corners, zeros outside."""
    N, _, H, W = maps.shape
    gh, gw = grid_hw
    xs = torch.linspace(-1.0, 1.0, gw, device=maps.device)[:W]
    ys = torch.linspace(-1.0, 1.0, gh, device=maps.device)[:H]
    gx = xs.view(1, 1, W) + flow[:, 0] / ((W - 1) / 2.0)
    gy = ys.view(1, H, 1) + flow[:, 1] / ((H - 1) / 2.0)
    grid = torch.stack([gx, gy], dim=-1)
    return F.grid_sample(maps, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def mfc_head(p, seg, flow, T, C, grid_hw, q=None,
             prefix="multiframe_net.multiframe_net."):
    """(B, T*C, H, W) maps, newest first, and (B, T-1, 2, H, W) flow (None:
    no flow) -> (B, C, H, W) logits: the earlier maps warped into the newest
    frame, then conv 11x11 + BN + ReLU, 2 x (conv 3x3 + BN + ReLU), conv 1x1."""
    B, _, H, W = seg.shape
    if flow is not None:
        earlier = seg[:, C:].reshape(B * (T - 1), C, H, W)
        warped = warp(earlier, flow.reshape(B * (T - 1), 2, H, W), grid_hw)
        seg = torch.cat([seg[:, :C], warped.reshape(B, (T - 1) * C, H, W)], 1)
    h = seg
    for ci, bi, k in ((0, 1, 11), (3, 4, 3), (6, 7, 3)):
        h = conv(h, p[f"{prefix}{ci}.weight"], padding=k // 2, q=q)
        h = F.relu(batch_norm_eval(h, p, f"{prefix}{bi}"))
    return conv(h, p[f"{prefix}9.weight"], q=q)


# ------------------------------------------------------------------ RAFT
def _cnr(p, x, name, stride, norm, q, relu=True):
    w = p[name + ".0.weight"]
    x = conv(x, w, p[name + ".0.bias"], stride=stride,
             padding=(w.shape[-1] - 1) // 2, q=q)
    if norm == "instance":
        x = F.instance_norm(x, eps=BN_EPS)
    else:
        x = batch_norm_eval(x, p, name + ".1")
    return F.relu(x) if relu else x


def raft_encoder(p, x, name, norm, q=None):
    """RAFT's feature (instance norm) or context (batch norm) encoder:
    stride 8, 256 channels out."""
    x = _cnr(p, x, name + ".convnormrelu", 2, norm, q)
    for li in (1, 2, 3):
        for bi in (0, 1):
            blk = f"{name}.layer{li}.{bi}"
            stride = 2 if (li > 1 and bi == 0) else 1
            y = _cnr(p, x, blk + ".convnormrelu1", stride, norm, q)
            y = _cnr(p, y, blk + ".convnormrelu2", 1, norm, q)
            if blk + ".downsample.0.weight" in p:
                x = _cnr(p, x, blk + ".downsample", stride, norm, q,
                         relu=False)
            x = F.relu(x + y)
    return conv(x, p[name + ".conv.weight"], p[name + ".conv.bias"], q=q)


def corr_pyramid(f1, f2, levels):
    """All-pairs correlation of (N, D, h, w) features over sqrt(D), as
    (N*h*w, 1, h, w) volumes, average-pooled into ``levels`` levels."""
    N, D, h, w = f1.shape
    a = f1.reshape(N, D, h * w).transpose(1, 2)
    b = f2.reshape(N, D, h * w)
    corr = torch.bmm(a, b) / math.sqrt(D)
    vol = corr.reshape(N * h * w, 1, h, w)
    out = [vol]
    for _ in range(levels - 1):
        out.append(F.avg_pool2d(out[-1], 2, stride=2))
    return out


def corr_lookup(pyramid, coords, radius):
    """Sample every level in a (2r+1)^2 window around ``coords`` (N, 2, h,
    w) (x, y, at 1/8 resolution): bilinear, zeros outside; within a level
    channel a*(2r+1)+b is the offset (a - r, b - r) in (x, y)."""
    N, _, h, w = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], dim=-1).view(1, 2 * radius + 1,
                                               2 * radius + 1, 2)
    cen = coords.permute(0, 2, 3, 1).reshape(N * h * w, 1, 1, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[-2:]
        pts = cen / 2 ** lvl + delta
        grid = torch.stack([2 * pts[..., 0] / (wl - 1) - 1,
                            2 * pts[..., 1] / (hl - 1) - 1], dim=-1)
        s = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        out.append(s.view(N, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def _gru(p, h, x, name, pad, q):
    hx = torch.cat([h, x], 1)
    z = torch.sigmoid(conv(hx, p[name + ".convz.weight"],
                           p[name + ".convz.bias"], padding=pad, q=q))
    r = torch.sigmoid(conv(hx, p[name + ".convr.weight"],
                           p[name + ".convr.bias"], padding=pad, q=q))
    qh = torch.tanh(conv(torch.cat([r * h, x], 1), p[name + ".convq.weight"],
                         p[name + ".convq.bias"], padding=pad, q=q))
    return (1 - z) * h + z * qh


def update_block(p, net, inp, corr, flow, q=None, name="update_block"):
    """One recurrent update: motion encoder, SepConvGRU (1x5 then 5x1),
    flow head -> (net', delta flow)."""
    m = name + ".motion_encoder."

    def cr(x, n, pad):
        return F.relu(conv(x, p[m + n + ".0.weight"], p[m + n + ".0.bias"],
                           padding=pad, q=q))

    c = cr(cr(corr, "convcorr1", 0), "convcorr2", 1)
    f = cr(cr(flow, "convflow1", 3), "convflow2", 1)
    motion = torch.cat([cr(torch.cat([c, f], 1), "conv", 1), flow], 1)
    x = torch.cat([inp, motion], 1)
    g = name + ".recurrent_block."
    net = _gru(p, net, x, g + "convgru1", (0, 2), q)
    net = _gru(p, net, x, g + "convgru2", (2, 0), q)
    fh = name + ".flow_head."
    hid = F.relu(conv(net, p[fh + "conv1.weight"], p[fh + "conv1.bias"],
                      padding=1, q=q))
    return net, conv(hid, p[fh + "conv2.weight"], p[fh + "conv2.bias"],
                     padding=1, q=q)


def convex_upsample(flow, mask):
    """8x convex upsampling of (N, 2, h, w) flow by (N, 576, h, w) mask
    logits (torchvision's ``upsample_flow``)."""
    N, _, h, w = flow.shape
    m = torch.softmax(mask.view(N, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, kernel_size=3, padding=1).view(N, 2, 9, 1, 1, h, w)
    up = torch.sum(m * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, 2, 8 * h, 8 * w)


def raft_flow(p, feat1, feat2, net, inp, iters, levels, radius, q=None):
    """RAFT's recurrent solve from the encoders' outputs (NCHW): feat1, net,
    inp of image 1, feat2 of image 2 -> (N, 2, 8h, 8w) flow in pixels."""
    N, _, h, w = feat1.shape
    pyr = corr_pyramid(feat1, feat2, levels)
    ys, xs = torch.meshgrid(torch.arange(h, device=feat1.device).float(),
                            torch.arange(w, device=feat1.device).float(),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], 0)[None].expand(N, 2, h, w)
    flow = torch.zeros(N, 2, h, w, device=feat1.device)
    for _ in range(iters):
        corr = corr_lookup(pyr, coords0 + flow, radius)
        net, delta = update_block(p, net, inp, corr, flow, q=q)
        flow = flow + delta
    mp = "mask_predictor."
    hid = F.relu(conv(net, p[mp + "convrelu.0.weight"],
                      p[mp + "convrelu.0.bias"], padding=1, q=q))
    mask = 0.25 * conv(hid, p[mp + "conv.weight"], p[mp + "conv.bias"], q=q)
    return convex_upsample(flow, mask)


def raft_encode(p, half, q=None):
    """Half-resolution normalized frames (N, 3, h, w) -> (features, net,
    inp): the feature encoder's output and the context encoder's split
    into the GRU's initial state (tanh) and its feed (ReLU)."""
    feat = raft_encoder(p, half, "feature_encoder", "instance", q)
    ctx = raft_encoder(p, half, "context_encoder", "batch", q)
    return feat, torch.tanh(ctx[:, :128]), F.relu(ctx[:, 128:])


def pair_flow(p, image1, image2, iters, levels, radius, q=None):
    """RAFT on whole frame pairs (N, 3, H, W), as the offline flow CLI
    feeds them (RGB / 255): both images' features, image 1's context, the
    solve -> (N, 2, H, W) flow in pixels."""
    f1 = raft_encoder(p, image1, "feature_encoder", "instance", q)
    f2 = raft_encoder(p, image2, "feature_encoder", "instance", q)
    ctx = raft_encoder(p, image1, "context_encoder", "batch", q)
    return raft_flow(p, f1, f2, torch.tanh(ctx[:, :128]),
                     F.relu(ctx[:, 128:]), iters, levels, radius, q)


def window_flow(p, enc_newest, feat_earlier, out_hw, iters, levels, radius,
                q=None):
    """The tracker's flow of one window: the newest frame (its encoders'
    outputs ``enc_newest``) paired with each earlier frame (``feat_earlier``
    (T-1, 256, h, w)), solved at half resolution, times 2 and resized
    bilinearly (align_corners) to ``out_hw`` -> (T-1, 2, H, W)."""
    f1, net, inp = enc_newest
    n = feat_earlier.shape[0]
    fl = raft_flow(p, f1.expand(n, -1, -1, -1), feat_earlier,
                   net.expand(n, -1, -1, -1), inp.expand(n, -1, -1, -1),
                   iters, levels, radius, q)
    return F.interpolate(fl / 0.5, size=out_hw, mode="bilinear",
                         align_corners=True)
