"""Direct 3x3 convolution with fused bias and ReLU (counterpart of
``mfcnet_tpu/experimental/conv3x3_pallas.py::conv3x3_pallas``).

Stride 1, SAME padding, float32 accumulation, the result rounded once to
``x``'s type. Layout: ``x`` (B, H, W, cin) and the result (B, H, W, cout)
are NHWC and ``w`` (3, 3, cin, cout) is HWIO, the JAX function's layout
(for PyTorch: ``x`` is the channels_last storage of an NCHW tensor, and
``w = conv.weight.permute(2, 3, 1, 0)``).

:func:`conv3x3` launches the hand-written kernel of ``csrc/conv3x3.cu`` on
CUDA tensors (bfloat16: the Hopper core of ``csrc/conv_common.cuh``, in the
configuration :func:`conv_plan` picks, or the mma.sync tile kernel for the
shapes whose weights the core cannot keep; float32: FMAs) and runs
:func:`conv3x3_plain` (``F.conv2d`` at the same rounding points) on CPU
tensors. There is no fallback between the two. Each launch adds one to
:data:`LAUNCHES`. Forward only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.ops._build import (
    counted,
    kernel_lib,
    route,
    sm_count,
    stream_of,
)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = counted({"conv3x3": 0})

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the configuration of the bfloat16 core (csrc/conv_common.cuh)
# ---------------------------------------------------------------------------
#: shared memory a block may opt into on an H100 (227 KB), and what the
#: kernels keep of it in static arrays (barriers, vgg_stage1's im2col table)
SMEM_LIMIT, STATIC_SMEM = 232_448, 512
#: im2col columns of vgg_stage1's first convolution (9 cin rounded up to
#: 16) its table holds: cin <= 8, as the JAX kernel takes
MAX_K1 = 80
#: output pixels of a row segment (wgmma's M) and the segment with its ring
SEG, RING_W = 64, 66
#: halo stages of a block: a ring of one or two for each of the two
#: consumer warpgroups
STAGE_CHOICES = (4, 2)
#: the tile kernels (float32, and bfloat16 where the core does not take the
#: shape): 8 x 16 output pixels and 64 output channels a block, one tile
#: each; their shared memory: the 10 x 18 ring tile and the nine taps' weight
#: chunk, 64 channels of cin with rows padded by 8
TILE_H, TILE_W, TILE_N = 8, 16, 64
TILE_SMEM = ((TILE_H + 2) * (TILE_W + 2) * 72 + 9 * 64 * 72) * 2
#: the kernels index with 32-bit integers
INDEX_LIMIT = 2 ** 31
#: (column tile width N, image rows R of a warpgroup's tile) the core is
#: built for, widest first; a thread holds N / 2 x R accumulators (at most
#: 64 registers)
CONV_TILES = ((128, 1), (64, 2), (16, 2))


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _plane(rows: int) -> int:
    """Bytes of one 8-channel plane of a ring tile of ``rows`` rows."""
    return _up(rows * RING_W * 16, 128)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the bfloat16 core cuts one call. A warpgroup's tile is ``rows``
    image rows x 64 pixels x ``n`` output channels; ``tiles`` such tiles
    cover B x H x W, ``col_tiles`` column tiles cover the output channels,
    and each column tile has ``blocks`` persistent blocks, block ``i``
    taking tiles ``i, i + blocks, ...``. ``loader``: "tma" (the halo by
    TMA, where a pixel's 2 cin bytes are a multiple of 16) or "plain"
    (plain loads). ``kpad``: conv3x3's cin, or vgg_stage1's C1, rounded up
    to 16; ``k1pad``: vgg_stage1's 9 cin rounded up to 16 (0 for conv3x3).
    ``kernel``: "core", or "tiles" for the mma.sync tile kernel, whose
    tiles are 8 x 16 pixels (``rows`` 8, :attr:`width` 16), one block each.
    :meth:`ints` is what the C entry point takes, in its order."""
    rows: int
    n: int
    col_tiles: int
    loader: str
    stages: int
    tiles: int
    blocks: int
    smem_bytes: int
    kpad: int
    k1pad: int
    kernel: str = "core"

    @property
    def width(self) -> int:
        """Pixels of a tile's row."""
        return SEG if self.kernel == "core" else TILE_W

    def ints(self):
        return (ctypes.c_int * 11)(
            self.rows, self.n, self.col_tiles, int(self.loader == "tma"),
            self.stages, self.tiles, self.blocks, self.smem_bytes, self.kpad,
            self.k1pad, int(self.kernel == "core"))


def _check_index(name, B, H, W, *channels):
    if B * H * W * max(channels) >= INDEX_LIMIT:
        raise ValueError(f"{name}: the kernel indexes with 32 bits")


def _blocks(tiles: int, col_tiles: int, sms: int) -> int:
    # one block an SM: ~170 to 227 KB of shared memory and two warpgroups'
    # accumulators take it
    return max(1, min(tiles, sms // col_tiles))


def _tiles_plan(B, H, W, n, col_tiles, smem, kpad, k1pad) -> ConvPlan:
    tiles = B * -(-H // TILE_H) * -(-W // TILE_W)
    return ConvPlan(TILE_H, n, col_tiles, "plain", 1, tiles, tiles, smem,
                    kpad, k1pad, "tiles")


@functools.lru_cache(maxsize=256)
def conv_plan(B: int, H: int, W: int, cin: int, cout: int,
              sms: int = 132) -> ConvPlan:
    """The configuration of :func:`conv3x3`'s bfloat16 kernel for one
    shape, on a card of ``sms`` SMs: of :data:`CONV_TILES`, the tile whose
    weights (9 x cin x N, resident) and the most halo stages of
    :data:`STAGE_CHOICES` fit :data:`SMEM_LIMIT`, the fewest computed
    output columns first (the widest tile among equals). Where no tile's
    weights fit (cin > 512), the mma.sync tile kernel, which streams them
    64 channels of cin at a time. Raises on a shape the kernels do not
    take."""
    if min(B, H, W, cin, cout) < 1:
        raise ValueError(f"conv3x3: empty shape {B}x{H}x{W}x{cin}->{cout}")
    _check_index("conv3x3", B, H, W, cin, cout)
    kpad = _up(cin, 16)
    best = None
    for n, rows in CONV_TILES:
        for stages in STAGE_CHOICES:
            smem = 9 * kpad * n * 2 + stages * 8 * _plane(rows + 2) + 128
            if smem <= SMEM_LIMIT - STATIC_SMEM:
                break
        else:
            continue
        col_tiles = -(-cout // n)
        if best is None or col_tiles * n < best[0]:
            best = (col_tiles * n, n, rows, stages, smem, col_tiles)
    if best is None:
        return _tiles_plan(B, H, W, TILE_N, -(-cout // TILE_N), TILE_SMEM,
                           kpad, 0)
    _, n, rows, stages, smem, col_tiles = best
    tiles = B * -(-H // rows) * -(-W // SEG)
    return ConvPlan(rows, n, col_tiles,
                    "tma" if (2 * cin) % 16 == 0 else "plain", stages, tiles,
                    _blocks(tiles, col_tiles, sms), smem, kpad, 0)


@functools.lru_cache(maxsize=256)
def stage1_plan(B: int, H: int, W: int, cin: int, C1: int,
                sms: int = 132) -> ConvPlan:
    """The configuration of :func:`~.stage1.vgg_stage1`'s bfloat16 kernel:
    64-channel column tiles of the second convolution, each block
    computing the first convolution on its tiles' rings (all C1 channels);
    two image rows a tile where the shared memory allows, else one; input
    patches by plain loads. Where the core's weights, im2col rows and ring
    tiles do not fit (cin > 8, C1 > 96), the mma.sync tile kernel, if
    its shared memory fits. Raises on a shape the kernels do not take."""
    if min(B, H, W, cin, C1) < 1:
        raise ValueError(f"vgg_stage1: empty shape {B}x{H}x{W}x{cin}->{C1}")
    _check_index("vgg_stage1", B, H, W, cin, C1)
    c1pad, k1pad = _up(C1, 16), _up(9 * cin, 16)
    col_tiles = -(-C1 // SEG)
    for rows in (2, 1):
        fixed = (9 * c1pad * SEG * 2 + _up(k1pad * c1pad * 2, 128)
                 + 2 * ((k1pad // 8) * _up((rows + 2) * RING_W, 64) * 16
                        + (c1pad // 8) * _plane(rows + 2)))
        patch = _up((rows + 4) * (SEG + 4) * cin * 2, 128)
        for stages in STAGE_CHOICES:
            smem = fixed + stages * patch + 128
            if smem <= SMEM_LIMIT - STATIC_SMEM and k1pad <= MAX_K1:
                tiles = B * -(-H // rows) * -(-W // SEG)
                return ConvPlan(rows, SEG, col_tiles, "plain",
                                stages, tiles, _blocks(tiles, col_tiles, sms),
                                smem, c1pad, k1pad)
    # the tile kernel: the intermediate ring tile (all C1, rows padded by
    # 8), then the larger of the float32 input patch and first weights and
    # one chunk of the second weights
    n = _up(C1, TILE_N)
    first = (_up((TILE_H + 4) * (TILE_W + 4) * cin, 4)
             + _up(9 * cin * C1, 4)) * 4
    smem = ((TILE_H + 2) * (TILE_W + 2) * (n + 8) * 2
            + max(first, 9 * 64 * 72 * 2))
    if smem <= SMEM_LIMIT:
        return _tiles_plan(B, H, W, n, 1, smem, c1pad, k1pad)
    raise ValueError(
        f"vgg_stage1: cin={cin}, C1={C1} need more shared memory than a "
        "block has (227 KB)")


def check_conv_args(name, x, w, bias, cin=None):
    """Shared argument checks of the two experimental kernels: ``x``
    (B, H, W, cin) float32 or bfloat16, ``w`` (3, 3, cin, cout), ``bias``
    (cout) or None; no input may require a gradient."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise TypeError(f"{name}: x must be (B, H, W, C) float32 or "
                        f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    cin = x.shape[-1] if cin is None else cin
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: weight must be (3, 3, {cin}, cout), got "
                         f"{tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[-1],):
        raise ValueError(f"{name}: bias must be ({w.shape[-1]},), got "
                         f"{tuple(bias.shape)}")
    if cin == 0 or w.shape[-1] == 0:
        raise ValueError(f"{name}: zero channels")
    tensors = [t for t in (x, w, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: an input requires a gradient, but the kernel is "
            "forward only (an experiment that no model calls)")
    pixels = x.numel() // max(x.shape[-1], 1)
    if pixels * max(x.shape[-1], cin, w.shape[-1]) >= INDEX_LIMIT:
        raise ValueError(f"{name}: the kernel indexes with 32 bits")


def aligned(t):
    """Contiguous and 16-byte aligned, as the kernels' vector copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def raise_kernel_error(name, rc, plan):
    """Raise for a C entry point's nonzero return code."""
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(f"{name}: the device allows a block less shared "
                           "memory than the kernel's tiles need")
    if rc == 20002:
        raise RuntimeError(f"{name}: the kernel refused the plan {plan}")
    if rc == 20001 or rc > 10000:
        raise RuntimeError(f"{name}: the input's TMA map could not be made "
                           f"(error {rc}: 20001 cuTensorMapEncodeTiled not "
                           f"found in libcuda, else 10000 + its CUresult)")
    raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def conv_nhwc_f32(x, w):
    """float32 ``F.conv2d`` of NHWC ``x`` with HWIO ``w``, SAME padding,
    without TF32 on a card; returns NHWC float32."""
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w, bias=None, relu: bool = False):
    """Plain version of :func:`conv3x3`: the weights rounded to ``x``'s
    type, float32 products and sums, float32 bias, one rounding."""
    y = conv_nhwc_f32(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def conv3x3(x, w, bias=None, relu: bool = False):
    """x (B, H, W, cin) float32 or bfloat16, w (3, 3, cin, cout), bias
    (cout) or None -> (B, H, W, cout) in ``x``'s type: SAME 3x3
    convolution, stride 1, with the bias and the ReLU fused."""
    check_conv_args("conv3x3", x, w, bias)
    if route(x, w, bias) == "cpu":
        return conv3x3_plain(x, w, bias, relu)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    x, w = aligned(x), aligned(w.to(x.dtype))
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = (conv_plan(B, H, W, cin, cout, sm_count(x.device))
            if x.dtype == torch.bfloat16 else None)
    rc = kernel_lib().mfc_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), B, H, W, cin, cout, int(relu), DTYPES[x.dtype],
        None if plan is None else plan.ints(), stream_of(x))
    raise_kernel_error("conv3x3", rc, plan)
    LAUNCHES["conv3x3"] += 1
    return out
