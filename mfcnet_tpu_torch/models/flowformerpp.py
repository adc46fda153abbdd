"""FlowFormer++ on its default "things" path (counterpart of
``mfcnet_tpu/models/flowformerpp.py``; reference
models/optical_flow/flowformerplusplus/): the third frozen flow provider.

* timm ``twins_svt_large`` image encoders cut to their first 2 stages
  (patch embeds k4s4 / k2s2 + LayerNorm; per stage a locally grouped
  attention block (7x7 windows), the PEG position convolution and a
  global sub-sampled attention block (sr 8 / 4)) -> (B, H/8, W/8, 256);
* an all-pairs UNnormalized cost volume;
* the cost perceiver: each target-view cost map patch-embedded (three
  k6s2p2 convolutions, a linear sine position embedding, a 1x1 ffn and a
  LayerNorm), 8 latent tokens cross-attending its patches, then 3x
  [latent self-attention; vertical twins attention across source
  positions, conditioned on the context features, with window-local sine
  position embeddings], plus the shortcut;
* the memory decoder: 12 iterations of {9x9 local cost sampling,
  cross-attention of the cost tokens to the memory (k and v computed once
  a solve), GMA aggregation (content-only similarity), the SepConvGRU
  update}, then the convex 8x upsample of the last iteration.

Scope: the optional branches of the reference (NATTEN, SK blocks, quarter
refinement, r_16, use_patch, pretrain_mode, ...) are not implemented, and
:func:`validate_reference_config` and :func:`load_reference_state_dict`
refuse configurations and checkpoints that use them. Every dropout rate of
the "things" configuration is 0. LayerNorm eps: timm's image-encoder block
norms use 1e-6; every other norm (patch embeds, the GSA ``sr`` norms, all
cost-perceiver and decoder norms) PyTorch's 1e-5.

Module names are the reference checkpoint's after the ``module.`` strip
(``memory_encoder.feat_encoder.svt.*``, ``context_encoder.svt.*``,
``memory_encoder.cost_perceiver_encoder.*``, ``memory_decoder.*``), so a
reference ``.pth`` loads by name through :func:`load_reference_state_dict`.
Public methods take and return NHWC, as ``models/raft.py``'s do.

Like RAFT, the per-image encoders and the per-pair solve are separate
methods (``features`` / ``context`` / ``flow_from_features``), so that a
video engine keeps each frame's features; ``context`` returns the raw
context tensor and a (B, 1, 1, 1) placeholder where RAFT returns its GRU
state (net, inp).

Types: a cast to bfloat16 (or float16), as a bfloat16 engine or train
step makes of its provider, computes what the JAX package's bfloat16
FlowFormer++ computes in that type and keeps in float32 what it keeps in
float32. There the cost volume is float32 (``preferred_element_type``),
and flax's promotion then carries float32 through everything that reads
it: the patch embedding, the perceiver (its latents meet the float32
patches in the first attention), the decoder's query encoder, its
cross-attention and the update block (the float32 local cost and flow
promote its convolutions and, from the first iteration on, the GRU
state). So a 16-bit cast keeps in that type the two image encoders, the
decoder's ``proj`` (net and inp) and GMA similarity (``att``), the
latents with the input layer's ``norm1`` and ``q``, and each vertical
block's ``context_proj``; it rounds every other parameter to the type
once and stores it in float32 (:attr:`compute_dtype` records the type).
Cast after loading weights. The flow is float32.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.raft import (
    PackedPyramid,
    _nchw,
    _nhwc,
    convex_upsample,
    coords_grid,
)

#: the trainer's provider scales its frames by this before the forward
#: (the reference's input-range hack, src/engine.py:43,47); the tracker
#: passes its normalized frames unscaled
TRAIN_INPUT_SCALE = 0.225 / 0.5


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def linear_position_embedding_sine(x, dim: int = 128,
                                   factor: float = 1 / 200):
    """x: (..., 2) (x, y) coordinates -> (..., dim) float32, with the
    reference's literal 3.14 (not pi)."""
    freqs = torch.linspace(0, dim // 4 - 1, dim // 4, device=x.device)
    a = 3.14 * x[..., -2:-1] * freqs * factor
    b = 3.14 * x[..., -1:] * freqs * factor
    return torch.cat([torch.sin(a), torch.cos(a), torch.sin(b),
                      torch.cos(b)], dim=-1)


def _coords_xy(H: int, W: int, device):
    """(H, W, 2) float32 coordinates (x = column, y = row)."""
    return coords_grid(1, H, W, device)[0]


def _pad_hw(t, mult: int):
    """Zero-pad (B, H, W, C) at the bottom and right to multiples of
    ``mult``; returns (t, Hp, Wp)."""
    H, W = t.shape[1:3]
    pb, pr = (mult - H % mult) % mult, (mult - W % mult) % mult
    if pb or pr:
        t = F.pad(t, (0, 0, 0, pr, 0, pb))
    return t, H + pb, W + pr


def _window_partition(t, ws: int):
    """(B, Hp, Wp, C) -> (B, nh*nw, ws*ws, C)."""
    B, Hp, Wp, C = t.shape
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, C).transpose(2, 3)
    return t.reshape(B, (Hp // ws) * (Wp // ws), ws * ws, C)


def _window_merge(t, Hp: int, Wp: int, ws: int):
    """(B, nh*nw, ws*ws, C) -> (B, Hp, Wp, C)."""
    B, C = t.shape[0], t.shape[-1]
    t = t.reshape(B, Hp // ws, Wp // ws, ws, ws, C).transpose(2, 3)
    return t.reshape(B, Hp, Wp, C)


def _attend(q, k, v, heads: int):
    """Multi-head softmax attention, scale (dim / heads)^-0.5:
    q (..., Nq, D), k (..., Nk, D), v (..., Nk, Dv) -> (..., Nq, Dv).

    16-bit inputs (the image encoders of a bf16 model) go through
    ``F.scaled_dot_product_attention``, whose kernels keep scores and
    softmax in float32 (the port's bf16 flow then lies as close to the JAX
    float32 flow as the JAX bf16 flow does; with the scores rounded to bf16
    it lay 1.3x as far, ``tests/test_torch_ffpp.py``). float32 inputs (the
    perceiver and the decoder, also in a bf16 model) as products and a
    softmax, as the JAX package computes them: they are many tiny problems
    (one query of 8 keys a pixel, 8 latents of 20-80 patches a cost map),
    on which the fused float32 kernel took a third of the train step's
    provider time on the card (PERF.md section 6, FlowFormer++)."""

    def split(t):
        return t.unflatten(-1, (heads, -1)).transpose(-3, -2)

    q, k, v = split(q), split(k), split(v)
    if q.dtype != torch.float32:
        out = F.scaled_dot_product_attention(q, k, v)
    else:
        attn = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2),
                             dim=-1)
        out = attn @ v
    return out.transpose(-3, -2).flatten(-2)


def _pointwise(conv: nn.Conv2d, x):
    """A 1x1 convolution applied to NHWC (or token-major) ``x``."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class Mlp(nn.Module):
    """timm Mlp: fc1, exact GELU, fc2."""

    def __init__(self, dim: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _ffn(dim: int):
    """The reference's Sequential(Linear, GELU, Dropout, Linear, Dropout):
    its linears at indices 0 and 3 (the dropouts, rate 0, as identities)."""
    return nn.Sequential(nn.Linear(dim, dim), nn.GELU(), nn.Identity(),
                         nn.Linear(dim, dim), nn.Identity())


# ---------------------------------------------------------------------------
# timm twins_svt_large image encoders (2 stages)
# ---------------------------------------------------------------------------
class LocallyGroupedAttn(nn.Module):
    """timm twins LocallyGroupedAttn: fused qkv in ws x ws windows; the
    tokens are zero-padded to the window after the block's norm, and the
    padded tokens take part in the softmax unmasked."""

    def __init__(self, dim: int, heads: int, ws: int = 7):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size):
        (H, W), B, D = size, x.shape[0], x.shape[-1]
        t, Hp, Wp = _pad_hw(x.reshape(B, H, W, D), self.ws)
        q, k, v = self.qkv(_window_partition(t, self.ws)).chunk(3, dim=-1)
        out = _window_merge(_attend(q, k, v, self.heads), Hp, Wp, self.ws)
        return self.proj(out[:, :H, :W].reshape(B, H * W, D))


class GlobalSubSampleAttn(nn.Module):
    """timm twins GlobalSubSampleAttn: q at full resolution, fused kv on
    tokens reduced by a VALID sr x sr stride-sr convolution (rows and
    columns beyond a multiple of sr are dropped) and a LayerNorm."""

    def __init__(self, dim: int, heads: int, sr_ratio: int = 8):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, size):
        (H, W), B, D = size, x.shape[0], x.shape[-1]
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = _nhwc(self.sr(_nchw(x.reshape(B, H, W, D))))
            kv_in = self.norm(kv_in.reshape(B, -1, D))
        k, v = self.kv(kv_in).chunk(2, dim=-1)
        return self.proj(_attend(self.q(x), k, v, self.heads))


class TwinsBlock(nn.Module):
    """timm twins Block, norms with eps 1e-6."""

    def __init__(self, dim: int, heads: int, ws: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalSubSampleAttn(dim, heads, sr_ratio) if ws == 1
                     else LocallyGroupedAttn(dim, heads, ws))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, x, size):
        x = x + self.attn(self.norm1(x), size)
        return x + self.mlp(self.norm2(x))


class PosConv(nn.Module):
    """Twins PEG: depthwise 3x3 convolution plus the residual (``proj.0``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x, size):
        B, D = x.shape[0], x.shape[-1]
        y = _nhwc(self.proj(_nchw(x.reshape(B, *size, D))))
        return x + y.reshape(B, -1, D)


class PatchEmbed(nn.Module):
    """A VALID patch x patch stride-patch convolution and a LayerNorm."""

    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        """NHWC -> (B, h*w, dim) tokens, (h, w)."""
        y = _nhwc(self.proj(_nchw(x)))
        return self.norm(y.flatten(1, 2)), tuple(y.shape[1:3])


class _SVT(nn.Module):
    """timm Twins' attribute layout after the reference's ``del_layers``."""

    def __init__(self, dims, depths, heads, sr_ratios, wss):
        super().__init__()
        self.patch_embeds = nn.ModuleList(
            PatchEmbed(3 if i == 0 else dims[i - 1], d, 4 if i == 0 else 2)
            for i, d in enumerate(dims))
        self.blocks = nn.ModuleList(
            nn.ModuleList(TwinsBlock(d, heads[i], wss[i] if j % 2 == 0 else 1,
                                     sr_ratios[i]) for j in range(depths[i]))
            for i, d in enumerate(dims))
        self.pos_block = nn.ModuleList(PosConv(d) for d in dims)


class TwinsSVTEncoder(nn.Module):
    """timm twins_svt_large cut to 2 stages: (B, H, W, 3) -> (B, H/8, W/8,
    dims[-1])."""

    def __init__(self, dims=(128, 256), depths=(2, 2), heads=(4, 8),
                 sr_ratios=(8, 4), wss=(7, 7)):
        super().__init__()
        self.svt = _SVT(dims, depths, heads, sr_ratios, wss)

    def forward(self, x):
        svt = self.svt
        for embed, blocks, pos in zip(svt.patch_embeds, svt.blocks,
                                      svt.pos_block):
            x, size = embed(x)
            for j, blk in enumerate(blocks):
                x = blk(x, size)
                if j == 0:
                    x = pos(x, size)
            x = x.reshape(x.shape[0], *size, -1)
        return x


# ---------------------------------------------------------------------------
# vertical twins attention with RPE and context (the perceiver's)
# ---------------------------------------------------------------------------
class _RPEContextAttn(nn.Module):
    """Shared parameters of the two vertical attentions: q and k read
    [x, projected context], v reads x."""

    def __init__(self, dim: int, heads: int, vert_c_dim: int,
                 encoder_latent_dim: int, k_in: int):
        super().__init__()
        self.heads = heads
        self.context_proj = nn.Linear(encoder_latent_dim, vert_c_dim)
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.k = nn.Linear(k_in, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def _qk_input(self, x, size, context):
        """x (B*L, H*W, D); context (B, H*W, Cctx) -> x and [x, context
        projected] as (B*L, H, W, .) grids, the context repeated for each
        of the L latent tokens of a source image."""
        (H, W), n, D = size, x.shape[0], x.shape[-1]
        ctx = self.context_proj(context)
        ctx = ctx.to(x.dtype).repeat_interleave(n // ctx.shape[0], dim=0)
        xg = x.reshape(n, H, W, D)
        return xg, torch.cat([xg, ctx.reshape(n, H, W, -1)], dim=-1)


class LocallyGroupedAttnRPEContext(_RPEContextAttn):
    """Windowed vertical attention with the window-local sine position
    embedding on q and k; padded tokens unmasked."""

    def __init__(self, dim, heads, ws, vert_c_dim, encoder_latent_dim=256):
        super().__init__(dim, heads, vert_c_dim, encoder_latent_dim,
                         dim + vert_c_dim)
        self.ws = ws

    def forward(self, x, size, context):
        (H, W), ws = size, self.ws
        xg, xqk = self._qk_input(x, size, context)
        xg, Hp, Wp = _pad_hw(xg, ws)
        xqk, _, _ = _pad_hw(xqk, ws)
        pe = linear_position_embedding_sine(_coords_xy(ws, ws, x.device),
                                            dim=xqk.shape[-1])
        qk = _window_partition(xqk, ws) + pe.reshape(ws * ws, -1)
        v = self.v(_window_partition(xg, ws))
        out = _attend(self.q(qk), self.k(qk), v, self.heads)
        out = _window_merge(out, Hp, Wp, ws)[:, :H, :W]
        return self.proj(out.reshape(x.shape))


class GlobalSubSampleAttnRPEContext(_RPEContextAttn):
    """Global vertical attention: q from [x, ctx] + PE at full (padded)
    resolution, k from ``sr_key([x, ctx])`` + PE on the sub-sampled
    coordinates x sr, v from ``sr_value(x)``; one LayerNorm serves both
    ``sr`` outputs; tokens zero-padded to sr, unmasked."""

    def __init__(self, dim, heads, sr_ratio, vert_c_dim,
                 encoder_latent_dim=256):
        super().__init__(dim, heads, vert_c_dim, encoder_latent_dim, dim)
        self.sr_ratio = sr_ratio
        self.sr_key = nn.Conv2d(dim + vert_c_dim, dim, sr_ratio, sr_ratio)
        self.sr_value = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, size, context):
        (H, W), r, n = size, self.sr_ratio, x.shape[0]
        xg, xqk = self._qk_input(x, size, context)
        xg, Hp, Wp = _pad_hw(xg, r)
        xqk, _, _ = _pad_hw(xqk, r)
        pe_q = linear_position_embedding_sine(
            _coords_xy(Hp, Wp, x.device), dim=xqk.shape[-1])
        q = self.q((xqk + pe_q).reshape(n, Hp * Wp, -1))
        xv = self.norm(_nhwc(self.sr_value(_nchw(xg))))
        xk = self.norm(_nhwc(self.sr_key(_nchw(xqk))))
        pe_k = linear_position_embedding_sine(
            _coords_xy(Hp // r, Wp // r, x.device) * r, dim=xk.shape[-1])
        k = self.k((xk + pe_k).flatten(1, 2))
        v = self.v(xv.flatten(1, 2))
        out = _attend(q, k, v, self.heads).reshape(n, Hp, Wp, -1)
        return self.proj(out[:, :H, :W].reshape(x.shape))


class VerticalBlock(nn.Module):
    """twins Block with PyTorch's default norm (eps 1e-5)."""

    def __init__(self, dim, heads, ws, sr_ratio, vert_c_dim,
                 encoder_latent_dim=256):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = (
            GlobalSubSampleAttnRPEContext(dim, heads, sr_ratio, vert_c_dim,
                                          encoder_latent_dim)
            if ws == 1 else
            LocallyGroupedAttnRPEContext(dim, heads, ws, vert_c_dim,
                                         encoder_latent_dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim)

    def forward(self, x, size, context):
        x = x + self.attn(self.norm1(x), size, context)
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    def __init__(self, dim, heads, vert_c_dim, encoder_latent_dim=256):
        super().__init__()
        self.local_block = VerticalBlock(dim, heads, 7, 4, vert_c_dim,
                                         encoder_latent_dim)
        self.global_block = VerticalBlock(dim, heads, 1, 4, vert_c_dim,
                                          encoder_latent_dim)

    def forward(self, x, size, context):
        x = self.local_block(x, size, context)
        return self.global_block(x, size, context)


# ---------------------------------------------------------------------------
# cost perceiver
# ---------------------------------------------------------------------------
class CostPatchEmbed(nn.Module):
    """Each cost map, zero-padded to a multiple of 8: [conv, ReLU, conv,
    ReLU, conv] (k6 s2 p2), the linear sine PE of the patch centres
    (64 channels) concatenated, a 1x1 ffn (ReLU between), a LayerNorm."""

    def __init__(self, embed_dim: int = 64, pe_dim: int = 64):
        super().__init__()
        d = embed_dim
        self.pe_dim = pe_dim
        self.proj = nn.ModuleList([
            nn.Conv2d(1, d // 4, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(d // 4, d // 2, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(d // 2, d, 6, 2, 2)])
        self.ffn_with_coord = nn.Sequential(
            nn.Conv2d(d + pe_dim, d + pe_dim, 1), nn.ReLU(),
            nn.Conv2d(d + pe_dim, d + pe_dim, 1))
        self.norm = nn.LayerNorm(d + pe_dim, eps=1e-5)

    def forward(self, cost_maps):
        """(N, 1, H2, W2) -> (N, H3*W3, embed_dim + pe_dim) tokens."""
        H2, W2 = cost_maps.shape[-2:]
        x = F.pad(cost_maps, (0, (8 - W2 % 8) % 8, 0, (8 - H2 % 8) % 8))
        for layer in self.proj:
            x = layer(x)
        N, _, H3, W3 = x.shape
        pe = linear_position_embedding_sine(
            _coords_xy(H3, W3, x.device) * 8.0 + 4.0, dim=self.pe_dim)
        x = torch.cat([_nhwc(x), pe.expand(N, H3, W3, self.pe_dim)], dim=-1)
        f0, f1 = self.ffn_with_coord[0], self.ffn_with_coord[2]
        x = _pointwise(f1, F.relu(_pointwise(f0, x)))
        return self.norm(x.reshape(N, H3 * W3, -1))


class _AttnLayer(nn.Module):
    """norm1, q/k/v/proj linears, norm2, ffn: the layout the perceiver's
    input layer, its latent self-attention and the decoder's
    cross-attention share."""

    heads = 8

    def __init__(self, dim: int, kv_in: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(kv_in, dim)
        self.v = nn.Linear(kv_in, dim)
        self.proj = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def _tail(self, x, q, k, v):
        """x + proj(attention), then the ffn's residual."""
        x = x + self.proj(_attend(q.to(k.dtype), k, v, self.heads))
        return x + self.ffn(self.norm2(x))


class CrossAttentionInput(_AttnLayer):
    """The latent tokens (shared by every cost map) cross-attend all
    patches of a map."""

    def forward(self, latents, patches):
        N = patches.shape[0]
        q = self.q(self.norm1(latents)).expand(N, -1, -1)
        x = latents.to(patches.dtype).expand(N, -1, -1)
        return self._tail(x, q, self.k(patches), self.v(patches))


class LatentSelfAttention(_AttnLayer):
    def forward(self, x):
        y = self.norm1(x)
        return self._tail(x, self.q(y), self.k(y), self.v(y))


class CostPerceiverEncoder(nn.Module):
    def __init__(self, latent_dim=128, latent_tokens=8, depth=3,
                 vert_c_dim=64, heads=8, embed_dim=64,
                 encoder_latent_dim=256):
        super().__init__()
        self.patch_embed = CostPatchEmbed(embed_dim)
        self.latent_tokens = nn.Parameter(
            torch.randn(1, latent_tokens, latent_dim))
        self.input_layer = CrossAttentionInput(latent_dim, embed_dim + 64)
        self.encoder_layers = nn.ModuleList(
            LatentSelfAttention(latent_dim, latent_dim) for _ in range(depth))
        self.vertical_encoder_layers = nn.ModuleList(
            VerticalSelfAttentionLayer(latent_dim, heads, vert_c_dim,
                                       encoder_latent_dim)
            for _ in range(depth))

    def forward(self, cost, context):
        """cost (B, H1*W1, H2, W2) float32, context (B, H1*W1, Cctx) ->
        the (B*H1*W1, L, latent_dim) memory."""
        B, n1, H2, W2 = cost.shape
        size = context.shape[1:3]
        patches = self.patch_embed(cost.reshape(B * n1, 1, H2, W2))
        x = self.input_layer(self.latent_tokens, patches)
        short_cut = x
        ctx = context.reshape(B, n1, -1)
        L, D = x.shape[1:]
        for layer, vert in zip(self.encoder_layers,
                               self.vertical_encoder_layers):
            x = layer(x)
            xv = x.reshape(B, n1, L, D).transpose(1, 2).reshape(B * L, n1, D)
            xv = vert(xv, size, ctx)
            x = xv.reshape(B, L, n1, D).transpose(1, 2).reshape(B * n1, L, D)
        return x + short_cut



class MemoryEncoder(nn.Module):
    def __init__(self, enc_dims, enc_depths, enc_heads, **perceiver):
        super().__init__()
        self.feat_encoder = TwinsSVTEncoder(enc_dims, enc_depths, enc_heads)
        self.cost_perceiver_encoder = CostPerceiverEncoder(
            encoder_latent_dim=enc_dims[-1], **perceiver)


# ---------------------------------------------------------------------------
# memory decoder
# ---------------------------------------------------------------------------
class DecoderCrossAttention(_AttnLayer):
    """A cost token (one a pixel) attends the pixel's memory tokens, with
    the linear sine PE of its current target coordinates on the query."""

    def forward(self, query, key, value, coords):
        pe = linear_position_embedding_sine(coords, dim=query.shape[-1])
        return self._tail(query, self.q(self.norm1(query) + pe), key, value)


class MemoryDecoderLayer(nn.Module):
    def __init__(self, query_dim: int, latent_dim: int):
        super().__init__()
        self.cross_attend = DecoderCrossAttention(query_dim, latent_dim)


class GMAAttention(nn.Module):
    """1 head, content-only similarity: (B, h, w, dim) -> (B, h*w, h*w)
    softmax weights (the reference's ``pos_emb`` tables are unused by this
    forward and are not kept)."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, inp):
        q, k = _pointwise(self.to_qk, inp.flatten(1, 2)).chunk(2, dim=-1)
        sim = torch.bmm(q * self.dim_head ** -0.5, k.transpose(1, 2))
        return sim.softmax(dim=-1)


class Aggregate(nn.Module):
    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attention, motion):
        """motion NCHW channels_last (B, 128, h, w) -> motion + gamma *
        (attention @ to_v(motion)), the same layout."""
        m = _nhwc(motion)
        agg = torch.bmm(attention, _pointwise(self.to_v, m.flatten(1, 2)))
        return motion + self.gamma * agg.reshape(m.shape).permute(0, 3, 1, 2)


class MotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow],
                         dim=1)


class SepConvGRU(nn.Module):
    """1x5 then 5x1 ConvGRU under the reference's names (``convz1`` ...
    ``convq2``; the port's RAFT keeps torchvision's)."""

    def __init__(self, hidden: int = 128, input_dim: int = 384):
        super().__init__()
        cin = hidden + input_dim
        for i, (k, p) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for g in "zrq":
                setattr(self, f"conv{g}{i}", nn.Conv2d(cin, hidden, k,
                                                       padding=p))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden_in: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden_in, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class GMAUpdateBlock(nn.Module):
    """Motion encoder, GMA aggregation, SepConvGRU, flow head; the mask
    head (x 0.25) on request. NCHW (channels_last) in and out."""

    def __init__(self, cor_planes: int, hidden: int = 128):
        super().__init__()
        self.encoder = MotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden, hidden + 256)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))
        self.aggregator = Aggregate(128, 128)

    def forward(self, net, inp, corr, flow, attention, with_mask=False):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        mask = 0.25 * self.mask(net) if with_mask else None
        return net, self.flow_head(net), mask


class MemoryDecoder(nn.Module):
    #: the local cost window's radius: (2r+1)^2 samples a pixel
    radius = 4

    def __init__(self, query_dim=64, latent_dim=128, enc_latent_dim=256):
        super().__init__()
        window = (2 * self.radius + 1) ** 2
        self.flow_token_encoder = nn.Sequential(
            nn.Conv2d(window, query_dim, 1), nn.GELU(),
            nn.Conv2d(query_dim, query_dim, 1))
        self.proj = nn.Conv2d(enc_latent_dim, 2 * latent_dim, 1)
        self.decoder_layer = MemoryDecoderLayer(query_dim, latent_dim)
        self.update_block = GMAUpdateBlock(window + query_dim, latent_dim)
        self.att = GMAAttention(latent_dim, latent_dim)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
#: parameters that a 16-bit cast keeps in that type (see the module's note
#: on types); every other parameter is rounded once and stored in float32
_HALF_PARAMS = re.compile(
    r"^(memory_encoder\.feat_encoder\.|context_encoder\."
    r"|memory_decoder\.(proj|att)\."
    r"|memory_encoder\.cost_perceiver_encoder\.(latent_tokens$"
    r"|input_layer\.(norm1|q)\.)|.*\.attn\.context_proj\.)")


class FlowFormerPP(nn.Module):
    """FlowFormer++, default "things" configuration. ``forward(image1,
    image2)`` returns the final upsampled flow (B, H, W, 2) in pixels,
    float32 (the reference's eval output ``flow_up``)."""

    def __init__(self, iters: int = 12, latent_dim: int = 128,
                 latent_tokens: int = 8, query_dim: int = 64,
                 enc_dims=(128, 256), enc_depths=(2, 2), enc_heads=(4, 8),
                 vert_c_dim: int = 64, perceiver_depth: int = 3,
                 perceiver_heads: int = 8, cost_embed_dim: int = 64):
        super().__init__()
        self.iters = iters
        self.latent_dim = latent_dim
        self.memory_encoder = MemoryEncoder(
            enc_dims, enc_depths, enc_heads, latent_dim=latent_dim,
            latent_tokens=latent_tokens, depth=perceiver_depth,
            vert_c_dim=vert_c_dim, heads=perceiver_heads,
            embed_dim=cost_embed_dim)
        self.memory_decoder = MemoryDecoder(query_dim, latent_dim,
                                            enc_dims[-1])
        self.context_encoder = TwinsSVTEncoder(enc_dims, enc_depths,
                                               enc_heads)
        #: the type of the last cast (the 16-bit parts compute in it)
        self.compute_dtype = torch.float32
        self.to(memory_format=torch.channels_last)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        dtype = self.memory_decoder.proj.weight.dtype
        self.compute_dtype = dtype
        if dtype in (torch.bfloat16, torch.float16):
            for name, p in self.named_parameters():
                if not _HALF_PARAMS.match(name):
                    p.data = p.data.float()
        return self

    def features(self, image):
        """(B, H, W, 3) -> (B, H/8, W/8, 256) twins features (per image,
        kept across a video's frames)."""
        return self.memory_encoder.feat_encoder(image)

    def context(self, image):
        """(B, H, W, 3) -> (ctx, placeholder): ``ctx`` the raw twins
        context features (B, H/8, W/8, 256), which condition the
        perceiver and give the decoder's net / inp / attention; the
        (B, 1, 1, 1) placeholder keeps the engine's (features, net, inp)
        ring as it is for RAFT."""
        ctx = self.context_encoder(image)
        return ctx, ctx.new_zeros(image.shape[0], 1, 1, 1)

    def flow_from_features(self, f1, f2, ctx, _unused=None):
        """The per-pair solve: f1 / f2 the ``features`` of image1 /
        image2, ctx the ``context`` of image1 -> flow (B, H, W, 2) in
        pixels, float32."""
        dec = self.memory_decoder
        B, H1, W1, C = f1.shape
        n1 = H1 * W1
        # the all-pairs cost volume, unnormalized, float32 sums
        cost = torch.bmm(f1.reshape(B, n1, C).float(),
                         f2.reshape(B, n1, C).float().transpose(1, 2))
        cost = cost.reshape(B, n1, H1, W1)
        memory = self.memory_encoder.cost_perceiver_encoder(cost, ctx)

        pctx = _pointwise(dec.proj, ctx)
        net = torch.tanh(pctx[..., :self.latent_dim])
        inp = F.relu(pctx[..., self.latent_dim:])
        attention = dec.att(inp).float()
        net, inp = _nchw(net.float()), _nchw(inp.float())

        cross = dec.decoder_layer.cross_attend
        key, value = cross.k(memory), cross.v(memory)
        pyramid = PackedPyramid([cost], dec.radius)
        coords0 = coords_grid(B, H1, W1, f1.device)
        coords1 = coords0
        enc0, enc1 = dec.flow_token_encoder[0], dec.flow_token_encoder[2]
        mask = None
        for it in range(self.iters):
            local = pyramid.lookup(coords1)                 # (B, H1, W1, 81)
            query = _pointwise(enc1, F.gelu(_pointwise(enc0, local)))
            cost_global = cross(query.reshape(B * n1, 1, -1), key, value,
                                coords1.reshape(B * n1, 1, 2))
            corr = torch.cat([cost_global.reshape(B, H1, W1, -1), local],
                             dim=-1)
            flow = coords1 - coords0
            net, delta, mask = dec.update_block(
                net, inp, _nchw(corr), _nchw(flow), attention,
                with_mask=it == self.iters - 1)
            coords1 = coords1 + _nhwc(delta)
        return convex_upsample(coords1 - coords0, _nhwc(mask))

    def forward(self, image1, image2):
        f1 = self.features(image1)
        f2 = self.features(image2)
        ctx, _ = self.context(image1)
        return self.flow_from_features(f1, f2, ctx)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def init_ffpp_weights(model: FlowFormerPP, generator: torch.Generator,
                      flow_gain: float = 1.0):
    """Seeded weights: every convolution and linear layer re-drawn with
    PyTorch's default schemes (kaiming-uniform(a=sqrt(5)) weights, fan-in
    uniform biases), the latent tokens standard normal, LayerNorms at
    weight 1 and bias 0, ``gamma`` 0; the flow head's last convolution
    (``update_block.flow_head.conv2``) scaled by ``flow_gain``, which
    sets the size of the random flow (each iteration adds its output)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5),
                                         generator=generator)
                if mod.bias is not None:
                    b = 1.0 / math.sqrt(mod.weight[0].numel())
                    nn.init.uniform_(mod.bias, -b, b, generator=generator)
        lat = model.memory_encoder.cost_perceiver_encoder.latent_tokens
        lat.normal_(0.0, 1.0, generator=generator)
        head = model.memory_decoder.update_block.flow_head.conv2
        head.weight.mul_(flow_gain)
        head.bias.mul_(flow_gain)
    return model


#: checkpoint keys of optional reference branches this port does not
#: implement (loading would drop their weights silently)
_BRANCH_MARKERS = {
    ".rpb": "NATTEN neighborhood attention "
            "(vertical_encoder_attn=NA/NA-twins, NA.py:97)",
    ".conv_list.": "SK update blocks (gma=GMA-SK, sk.py:9)",
    "quater_upsampler.": "quarter refinement upsampler "
                         "(quater_refine=True, quater_upsampler.py)",
}
#: keys a reference checkpoint holds that this forward does not read: the
#: GMA relative position tables (unused by the content-only similarity)
#: and timm's leftovers around the two kept stages
_UNUSED_KEYS = re.compile(r"^memory_decoder\.att\.pos_emb\.|.*\.svt\.")


def load_reference_state_dict(model: FlowFormerPP, state_dict):
    """Load a reference FlowFormer++ checkpoint (``ffpp_things.pth``'s
    ``state_dict``, ``module.`` prefixes allowed) into ``model`` by name.

    A checkpoint trained with an optional branch (``.rpb``,
    ``.conv_list.``, ``quater_upsampler.`` keys) raises
    ``NotImplementedError``. The GMA ``pos_emb`` tables and timm keys
    outside the two kept stages are dropped; every other key must match
    (a strict load). Returns the sorted dropped keys."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    for marker, what in _BRANCH_MARKERS.items():
        hits = [k for k in sd if marker in k]
        if hits:
            raise NotImplementedError(
                f"FlowFormer++ checkpoint contains {what} parameters "
                f"(e.g. {hits[0]!r}): this optional reference branch is "
                "not implemented — converting would silently drop these "
                "weights. See the scope note in "
                "mfcnet_tpu_torch/models/flowformerpp.py.")
    own = model.state_dict()
    dropped = sorted(k for k in sd if k not in own and _UNUSED_KEYS.match(k))
    model.load_state_dict({k: v for k, v in sd.items() if k not in dropped},
                          strict=True)
    return dropped


# ---------------------------------------------------------------------------
# reference-config validation (scope enforcement)
# ---------------------------------------------------------------------------
# Structural knobs of the reference percostformer3 config whose non-default
# values select code paths this port does not implement.
_STRUCTURAL_DEFAULTS = {
    "vertical_encoder_attn": "twins",
    "gma": "GMA",
    "use_patch": False,
    "r_16": -1,
    "quater_refine": False,
    "pretrain_mode": False,
    "use_rpe": False,
    "flow_or_pe": "and",
    "cross_attn": "all",
    "pe": "linear",
    "patch_embed": "single",
    "use_convertor": False,
    "detach_local": False,
    "no_sc": False,
    "cost_heads_num": 1,
    "dropout": 0.0,
    "droppath": 0.0,
    # the parameter-free residual of the cost encoder: a False config
    # would load every weight and compute another function
    "cost_encoder_res": True,
}
# expand_factor is not validated: only the NATTEN branch reads it, which
# vertical_encoder_attn already refuses
_REJECT_DETAIL = {
    "vertical_encoder_attn": (
        "NA / NA-twins need NATTEN neighborhood attention, whose CUDA "
        "sources are absent even from the reference "
        "(PerCostFormer3/NA.py:9-20)"
    ),
    "gma": (
        "GMA-SK selects the SK update blocks (PerCostFormer3/sk.py); "
        "None selects the no-GMA BasicUpdateBlock — only 'GMA' is "
        "implemented"
    ),
    "use_patch": "cost-patch queries (PerCostFormer3/decoder.py:164,313)",
    "r_16": (
        "1/16-scale auxiliary cost maps "
        "(PerCostFormer3/encoder.py:407, decoder.py:334-339)"
    ),
    "quater_refine": (
        "quarter-resolution refinement upsampler "
        "(PerCostFormer3/quater_upsampler.py:31-119)"
    ),
    "pretrain_mode": "masked-cost pretraining mode (dead for inference)",
    "cost_encoder_res": (
        "the no-residual cost-encoder variant (encoder.py:286,325 with "
        "cost_encoder_res=False); this port hardcodes the residual path"
    ),
}


def _get(c, k, default=None):
    return c.get(k, default) if isinstance(c, dict) else getattr(c, k,
                                                                 default)


def _inner(cfg):
    """The ``percostformer3`` node of a reference config, or the config."""
    inner = _get(cfg, "percostformer3")
    return cfg if inner is None else inner


def validate_reference_config(cfg) -> None:
    """Refuse a reference FlowFormer++ config that enables an
    unimplemented branch (``NotImplementedError`` naming the knob).
    ``cfg``: a dict or an attribute-style object (a yacs CfgNode),
    optionally nested under ``percostformer3``; absent knobs are
    defaults."""
    cfg = _inner(cfg)
    for knob, default in _STRUCTURAL_DEFAULTS.items():
        val = _get(cfg, knob, default)
        # r_16 is off for any value <= 0 (the reference tests > 0)
        ok = (val <= 0) if knob == "r_16" else (val == default)
        if not ok:
            detail = _REJECT_DETAIL.get(
                knob, "a non-default structural branch")
            raise NotImplementedError(
                f"FlowFormer++ config sets {knob}={val!r} (default "
                f"{default!r}): this selects {detail}. This port "
                "implements the default 'things' path only — see the "
                "scope note at the top of "
                "mfcnet_tpu_torch/models/flowformerpp.py.")


def ffpp_from_reference_config(cfg, iters: int | None = None):
    """A :class:`FlowFormerPP` from a reference-style config, validated
    first (structural deviations raise), its dimension knobs mapped onto
    the constructor's arguments."""
    validate_reference_config(cfg)
    inner = _inner(cfg)
    return FlowFormerPP(
        iters=iters if iters is not None
        else int(_get(inner, "decoder_depth", 12)),
        latent_dim=int(_get(inner, "cost_latent_dim", 128)),
        latent_tokens=int(_get(inner, "cost_latent_token_num", 8)),
        query_dim=int(_get(inner, "query_latent_dim", 64)),
        vert_c_dim=int(_get(inner, "vert_c_dim", 64)),
        perceiver_depth=int(_get(inner, "encoder_depth", 3)),
        cost_embed_dim=int(_get(inner, "cost_latent_input_dim", 64)),
    )


def make_ffpp_flow_fn(model: FlowFormerPP, basic: bool = True):
    """The trainer's frozen provider: ``flow_fn(frames)`` maps (B, T, H,
    W, 3) normalized frames, newest first, to (B, T-1, H, W, 2) float32
    flow at the input resolution (``track/outputs.py::
    flow_for_training``), the frames scaled by :data:`TRAIN_INPUT_SCALE`
    first and then cast to the model's ``compute_dtype``. ``basic``:
    flow(frame_i -> frame_0), else flow(frame_0 -> frame_i)."""
    from mfcnet_tpu_torch.track.outputs import flow_for_training

    @torch.no_grad()
    def flow_fn(frames):
        return flow_for_training(
            (frames * TRAIN_INPUT_SCALE).to(model.compute_dtype), model,
            basic=basic)

    flow_fn.model = model
    return flow_fn
