"""Flow warping by bilinear sampling (counterpart of
``mfcnet_tpu/ops/warp.py`` and of the TPU kernel
``mfcnet_tpu/ops/warp_pallas.py::banded_warp_pallas``).

:func:`flow_warp` is the MFCNet Basic head's alignment step: the maps of
an earlier frame sampled at ``base grid + flow`` with zeros padding
(``F.grid_sample`` semantics). On a CUDA tensor it launches the
hand-written kernel of ``csrc/warp.cu`` (one launch; 2D tiles of 64 x 8
pixels, two adjacent x a thread, the flow and each channel's pair moved
as vectors where W is even, the base grid once per tile column and row;
four taps, any flow exact); on a CPU tensor it runs
:func:`flow_warp_plain`, the same arithmetic in plain PyTorch. There is no fallback between the
two. :func:`grid_sample_bilinear` routes through the kernel's second
entry point, which samples at source coordinates as the TPU kernel does,
forming them from the normalized grid itself (one launch on the same 2D
tiles). :func:`backward_warp` is UnFlow's warp (``models/unflow.py``, once
per refinement network): a ``linspace(-1, 1)`` base grid plus the flow in
pixels, sampled as ``F.grid_sample`` does with either ``align_corners`` and
zeros or border padding; the kernel's third entry point forms the
coordinates itself and reads image and flow in place by their strides
(NCHW or ``channels_last``, float32 or bfloat16 flow), one launch and no
copy. Each launch adds one to :data:`LAUNCHES`.

:func:`flow_warp`'s forward is the registered operator
``mfcnet::flow_warp`` (``torch.library.custom_op``): its CPU kernel is
:func:`flow_warp_plain`, its CUDA kernel the launch, so that a
``torch.export`` graph (``serve/export.py``) names it and launches the
kernel on the card. A call that is not traced calls the two directly,
without the dispatcher.

Layout: maps are (B, C, H, W) and flow (B, 2, H, W) -- the layout of the
tracker's ring buffers; the JAX functions take (B, H, W, C) and
(B, H, W, 2). The TPU tiers that exist because TPU gathers are slow (the
banded one-hot products, their slabs and the ``lax.cond`` guard, the 2x2
patch table, ``onehot_window_sample``) are not carried over.

Coordinates are formed in float32 in the JAX code's order, and the four
taps blend with float32 weights whatever the maps' dtype (the TPU kernel
rounds its hat weights to bf16, the gather tier does not); the result is
returned in the maps' dtype.

:func:`flow_warp` is differentiable (a ``torch.autograd.Function``): its
backward is the VJP that the JAX package attaches to the TPU kernel
(``warp_pallas.py::_banded_warp_bwd``, XLA autodiff of the kernel's hat
weights max(1 - |xs - fx|, 0)). On CPU tensors it is
:func:`flow_warp_backward_plain`. On CUDA tensors the maps gradient is the
kernel entry ``mfc_flow_warp_bwd_maps``: one cooperative launch that bins
the source pixels by the destination tiles their taps reach (count, scan,
bin), then sorts each tile's list by tap-box corner in shared memory,
sums each pixel pair in one thread's registers, in float64, and writes
the tile once, rounded: no global accumulator and no global float atomics
(shared float64 atomics only where a chunk's tap-box corner holds more
than 32 entries, as on a flow that converges). The float64 sums make the
result independent of the order the kernel takes its entries in, but for
the rare sum whose float64 rounding decides its float32 one.
:func:`warp_bwd_plan` fixes
its tiles, grid and workspace (worst case: four list entries a pixel), and
the C side refuses any other plan. The flow gradient is
``mfc_flow_warp_bwd_flow``, a gather on the forward's 2D tiles, run only
when the flow requires a gradient. Between taps the flow gradient is the
difference of the two taps; at an exactly integer coordinate k it is the
banded hat convention as XLA differentiates it, v[k] + (v[k+1] - v[k-1]) /
2, not the floor form's v[k+1] - v[k] (the JAX package's gather tier, taken
when the flow leaves the band, differentiates the floor form).

:func:`grid_sample_bilinear` and :func:`backward_warp` are differentiable
too (B3): their backward is XLA's autodiff of the JAX package's
``grid_sample_bilinear`` (``mfcnet_tpu/ops/warp.py``), on the absolute
coordinates that both share, unclamped (:func:`sample_backward`). On CUDA
tensors two kernels: ``mfc_sample_bwd_img`` scatters each output's
upstream gradient to its four taps with the forward's float32 weights into
a zeroed float32 buffer in the image's memory format, cast to the image's
type after. A block owns a 64 x 8 tile of output samples and reduces their
tap box first (:func:`sample_bwd_tiles` computes the same boxes in torch);
where the box times C fits ``SAMPLE_BWD_CAP`` floats it sums the tile's
contributions in a shared-memory image of the box and adds the box to the
buffer row by row (four floats an atomic where aligned), else it adds
them to the buffer directly (runs of equal addresses in consecutive lanes
summed first, one atomic each). The
order of the additions changes from run to run: a pixel's value differs
from the plain version's sum by a few float32 roundings of its partial
sums. ``mfc_sample_bwd_coords`` gathers, per output pixel, the derivative of
the sample along x and y summed over channels. On CPU tensors
:func:`sample_backward_plain`. The derivative is JAX's floor form: between
taps and at an integer coordinate alike it is the difference of the taps
at floor(f) + 1 and floor(f). In ``'border'`` mode the coordinate is
clipped to [0, size - 1] first, and the clip's derivative is XLA's of
``minimum(maximum(f, 0), size - 1)``: 1 inside, 0 outside, and 0.5 exactly
on either limit (the tie of maximum and minimum split evenly), not torch's
``grid_sampler_2d_backward``, which gives 0 there. The coordinates' chain to
the normalized grid, and on to the flow (W / (W - 1) for
``align_corners=False``), is transposed in the JAX code's float32 order in
PyTorch, the same on both routes. A ``channels_last`` image gets a
``channels_last`` gradient; a bfloat16 flow or grid a float32 gradient cast
back to its type.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mfcnet_tpu_torch.ops._build import (
    counted,
    kernel_lib,
    route,
    sm_count,
    stream_of,
    traced,
)

#: kernel launches per entry point since the last :func:`reset_launches`
LAUNCHES = counted({"flow_warp": 0, "warp_abs": 0, "backward_warp": 0,
                    "flow_warp_bwd_maps": 0, "flow_warp_bwd_flow": 0,
                    "sample_bwd_img": 0, "sample_bwd_coords": 0})

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: the maps gradient's kernel (``csrc/warp.cu`` has the same): destination
#: tiles of BWD_TILE_H x BWD_TILE_W pixels, at most BWD_MAX_GROUP_C channels
#: a tile pass, BWD_BLOCKS_PER_SM blocks of BWD_THREADS threads an SM, up to
#: BWD_CAP list entries staged at once, and the error code of a refused plan
BWD_TILE_H, BWD_TILE_W, BWD_MAX_GROUP_C = 8, 64, 6
BWD_BLOCKS_PER_SM, BWD_THREADS, BWD_CAP, PLAN_REFUSED = 3, 256, 1024, 20004
#: tap-box corners (top-left taps) whose boxes reach a tile
BWD_CORNERS = (BWD_TILE_H + 1) * (BWD_TILE_W + 1)
#: B3's image entry (``csrc/warp.cu`` has the same): tiles of
#: SAMPLE_BWD_TILE_H x SAMPLE_BWD_TILE_W output samples; a tile whose tap box
#: times C holds at most SAMPLE_BWD_CAP floats sums in shared memory
SAMPLE_BWD_TILE_H, SAMPLE_BWD_TILE_W, SAMPLE_BWD_CAP = 8, 64, 16384


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class BwdPlan(NamedTuple):
    """Launch plan of ``mfc_flow_warp_bwd_maps`` (see
    :func:`warp_bwd_plan`); its ints are what the C entry point takes, in
    this order."""
    tile_h: int        # rows of a destination tile
    tile_w: int        # ... and its columns
    group_c: int       # channels a tile pass sums
    groups: int        # passes a tile takes
    shared_bytes: int  # dynamic shared memory a block
    tiles: int         # tiles an image
    work_ints: int     # the int32 workspace
    grid: int          # blocks, all resident at once
    threads: int       # threads a block


@functools.lru_cache(maxsize=None)
def warp_bwd_plan(B: int, C: int, H: int, W: int, sms: int) -> BwdPlan:
    """Launch plan of the maps gradient for a (B, C, H, W) upstream
    gradient on a card of ``sms`` SMs: BWD_TILE_H x BWD_TILE_W destination
    tiles; ceil(C / BWD_MAX_GROUP_C) channel groups of equal size (a block
    sums one group of its tile); a cooperative grid of ``sms *
    BWD_BLOCKS_PER_SM`` blocks; the shared memory of a block, whatever B,
    H and W: BWD_CAP staged list entries (each with its coordinates, a
    group of g in 32-bit words and its place in corner order), a count per
    tap-box corner and the total, and the tile's float64 sums; and the
    int32 workspace: each pixel's float32 coordinates (two ints), per
    (image, tile) an offset (and one total) and a cursor, the tile
    counter, and the lists (a pixel and its tap box's corner in the tile,
    two ints an entry), four entries a pixel (the most a pixel's four taps
    can reach), so that no flow overflows them. The C side computes the
    same plan and refuses any other. Raises ``ValueError`` for an empty
    shape or one beyond the kernel's 32-bit indices."""
    if min(B, C, H, W, sms) < 1:
        raise ValueError(f"warp_bwd_plan: empty shape {(B, C, H, W)} or "
                         f"{sms} SMs")
    tiles = -(-H // BWD_TILE_H) * -(-W // BWD_TILE_W)
    groups = -(-C // BWD_MAX_GROUP_C)
    group_c = -(-C // groups)
    nt = B * tiles
    work = 10 * B * H * W + 2 * nt + 2
    if work >= 2 ** 31 or nt * groups >= 2 ** 31:
        raise ValueError(f"warp_bwd_plan: {B} images of {H}x{W} are beyond "
                         "the kernel's 32-bit indices")
    shared = (4 * (BWD_CAP * (3 + group_c) + BWD_CORNERS + 1)
              + 8 * group_c * BWD_TILE_H * BWD_TILE_W)
    return BwdPlan(BWD_TILE_H, BWD_TILE_W, group_c, groups, shared, tiles,
                   work, sms * BWD_BLOCKS_PER_SM, BWD_THREADS)


@functools.lru_cache(maxsize=None)
def _plan_ints(plan: BwdPlan):
    return (ctypes.c_int * len(plan))(*plan)


def _wf(t):
    """The plain versions' working type: float32, or float64 for float64
    inputs (the CPU route only: ``gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _const(v, like):
    """A 0-dim factor or divisor in ``like``'s type and device: a division
    by a Python scalar becomes a product with its reciprocal on CUDA, which
    rounds differently (see :func:`_flow_grid`)."""
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _tap_valid(yf, xf, H, W):
    return (xf >= 0) & (xf <= W - 1) & (yf >= 0) & (yf <= H - 1)


def _tap_plain(flat, yf, xf, H, W):
    """Values (B, C, Ho, Wo) of the taps at integral float rows ``yf`` and
    columns ``xf`` (B, Ho, Wo) of ``flat`` (B, C, H*W), in the
    coordinates' type; zero outside the image."""
    B, C, _ = flat.shape
    Ho, Wo = xf.shape[-2:]
    valid = _tap_valid(yf, xf, H, W)
    xi = xf.clamp(0, W - 1).to(torch.int64)
    yi = yf.clamp(0, H - 1).to(torch.int64)
    idx = (yi * W + xi).reshape(B, 1, Ho * Wo).expand(B, C, Ho * Wo)
    v = flat.gather(2, idx).reshape(B, C, Ho, Wo).to(xf.dtype)
    return v * valid.unsqueeze(1).to(xf.dtype)


def _sample_abs_plain(img, fx, fy):
    """img (B, C, H, W) at absolute float32 coordinates fx, fy
    (B, Ho, Wo): four taps, out-of-image taps contribute zero, float32
    blend in the JAX gather tier's order."""
    B, C, H, W = img.shape
    Ho, Wo = fx.shape[-2:]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0).unsqueeze(1)
    ty = (fy - y0).unsqueeze(1)
    flat = img.reshape(B, C, H * W)

    def tap(yf, xf):
        return _tap_plain(flat, yf, xf, H, W)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return (top * (1.0 - ty) + bot * ty).to(img.dtype)


def _unnormalize(g, size: int, align_corners: bool):
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def _abs_coords(grid_x, grid_y, H, W, align_corners, padding_mode):
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    fx = _unnormalize(grid_x.to(_wf(grid_x)), W, align_corners)
    fy = _unnormalize(grid_y.to(_wf(grid_y)), H, align_corners)
    if padding_mode == "border":
        # torch clamps the unnormalized coordinate, so the fractional
        # weights see the clamped value too
        fx = fx.clamp(0.0, W - 1)
        fy = fy.clamp(0.0, H - 1)
    return fx, fy


def grid_sample_bilinear_plain(img, grid_x, grid_y,
                               align_corners: bool = True,
                               padding_mode: str = "zeros"):
    """Plain version of :func:`grid_sample_bilinear`."""
    fx, fy = _abs_coords(grid_x, grid_y, img.shape[2], img.shape[3],
                         align_corners, padding_mode)
    return _sample_abs_plain(img, fx, fy)


def _flow_grid(flow, grid_hw):
    """Normalized sampling grid ``base + flow`` of :func:`flow_warp`, in
    the JAX code's float32 order. The divisors are 0-dim tensors: a
    division by a Python scalar becomes a product with its reciprocal on
    CUDA, which rounds differently."""
    B, _, H, W = flow.shape
    gh, gw = (H, W) if grid_hw is None else grid_hw
    if gh < H or gw < W:
        raise ValueError(f"grid_hw {grid_hw} smaller than input {(H, W)}")
    flow = flow.to(_wf(flow))

    def c(v):
        return _const(v, flow)

    xs = 2.0 * torch.arange(W, dtype=flow.dtype, device=flow.device) \
        / c(gw - 1) - 1.0
    ys = 2.0 * torch.arange(H, dtype=flow.dtype, device=flow.device) \
        / c(gh - 1) - 1.0
    gx = xs.view(1, 1, W) + flow[:, 0] / c((W - 1) / 2.0)
    gy = ys.view(1, H, 1) + flow[:, 1] / c((H - 1) / 2.0)
    return gx, gy


def flow_warp_plain(maps, flow, grid_hw=None, align_corners: bool = True):
    """Plain version of :func:`flow_warp` (same arithmetic, any device)."""
    gx, gy = _flow_grid(flow, grid_hw)
    return grid_sample_bilinear_plain(maps, gx, gy, align_corners)


def _hat_diff(below, lo, hi, integer):
    """Derivative of a bilinear sample along one axis from the taps below
    the floor, at it and above it: ``hi - lo`` between taps; at an integer
    coordinate XLA's derivative of the hat weights, ``lo + (hi - below) /
    2`` (|.|'s derivative at 0 taken as +1, maximum's tie split 0.5/0.5)."""
    return torch.where(integer, lo + 0.5 * (hi - below), hi - lo)


def _clip_grad(v, hi: float):
    """XLA's derivative of ``minimum(maximum(v, 0), hi)`` (the JAX
    package's ``jnp.clip``): 1 inside, 0 outside, 0.5 on either limit
    (maximum's and minimum's ties split evenly)."""
    def step(above, tie):
        return torch.where(above, 1.0, torch.where(tie, 0.5, 0.0)).to(v.dtype)

    m = v.clamp_min(0.0)
    return step(v > 0, v == 0) * step(m < hi, m == hi)


def sample_abs_backward_plain(g, img, fx, fy, padding_mode: str = "zeros",
                              hat: bool = True):
    """VJP of the bilinear sample of ``img`` (B, C, H, W) at absolute
    float32 coordinates ``fx``, ``fy`` (B, Ho, Wo) for the upstream
    gradient ``g`` (B, C, Ho, Wo). Returns float32 ``(grad_img, grad_fx,
    grad_fy)``: each output's gradient added to its four taps with the
    forward's weights (``index_add_``), and the derivative of the sample
    along x and y summed over channels. At an exactly integer coordinate
    that derivative is, with ``hat``, XLA's of the TPU kernel's hat weights
    (see :func:`_hat_diff`; B1), else XLA's of the JAX gather's floor form,
    the difference of the taps at floor + 1 and floor (B3). ``'border'``
    padding clips the coordinates to the image first and multiplies their
    gradients by the clip's derivative (:func:`_clip_grad`)."""
    B, C, H, W = img.shape
    Ho, Wo = fx.shape[-2:]
    if padding_mode == "border":
        cx, cy = _clip_grad(fx, W - 1), _clip_grad(fy, H - 1)
        fx, fy = fx.clamp(0.0, W - 1), fy.clamp(0.0, H - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    ux, uy = 1.0 - tx, 1.0 - ty
    gf = g.to(fx.dtype)
    acc = torch.zeros(B * H * W, C, dtype=fx.dtype, device=img.device)
    boff = (torch.arange(B, device=img.device) * (H * W)).view(B, 1, 1)
    for dy, dx, w in ((0, 0, ux * uy), (0, 1, tx * uy), (1, 0, ux * ty),
                      (1, 1, tx * ty)):
        yf, xf = y0 + dy, x0 + dx
        valid = _tap_valid(yf, xf, H, W)
        idx = (boff + yf.clamp(0, H - 1).to(torch.int64) * W
               + xf.clamp(0, W - 1).to(torch.int64))
        src = gf * (w * valid.to(fx.dtype)).unsqueeze(1)
        acc.index_add_(0, idx.reshape(-1),
                       src.permute(0, 2, 3, 1).reshape(-1, C))
    grad_img = acc.view(B, H, W, C).permute(0, 3, 1, 2)

    flat = img.reshape(B, C, H * W)

    def tap(dy, dx):
        return _tap_plain(flat, y0 + dy, x0 + dx, H, W)

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    tx, ty, ux, uy = (t.unsqueeze(1) for t in (tx, ty, ux, uy))
    if hat:
        ix, iy = tx == 0, ty == 0
        dxv = (uy * _hat_diff(tap(0, -1), v00, v01, ix)
               + ty * _hat_diff(tap(1, -1), v10, v11, ix))
        dyv = (ux * _hat_diff(tap(-1, 0), v00, v10, iy)
               + tx * _hat_diff(tap(-1, 1), v01, v11, iy))
    else:
        dxv = uy * (v01 - v00) + ty * (v11 - v10)
        dyv = ux * (v10 - v00) + tx * (v11 - v01)
    grad_fx, grad_fy = (gf * dxv).sum(1), (gf * dyv).sum(1)
    if padding_mode == "border":
        grad_fx, grad_fy = grad_fx * cx, grad_fy * cy
    return grad_img, grad_fx, grad_fy


def flow_warp_backward_plain(g, maps, flow, grid_hw=None,
                             align_corners: bool = True):
    """Plain version of :func:`flow_warp`'s backward: for the upstream
    gradient ``g`` (B, C, H, W) returns ``(grad_maps, grad_flow)``, the
    maps gradient in the maps' dtype and the flow gradient (B, 2, H, W)
    float32, the coordinate chain transposed in the JAX code's float32
    order."""
    B, C, H, W = maps.shape
    gx, gy = _flow_grid(flow, grid_hw)
    fx, fy = _abs_coords(gx, gy, H, W, align_corners, "zeros")
    gi, gfx, gfy = sample_abs_backward_plain(g, maps, fx, fy)
    return gi.to(maps.dtype), _flow_chain(gfx, gfy, H, W, align_corners)


def tap_tiles(flow, grid_hw=None, align_corners: bool = True,
              tile=(BWD_TILE_H, BWD_TILE_W)):
    """The maps-gradient kernel's binning: (B, 4, H, W) int64, for each
    pixel the destination tiles (numbers within its image, raster order of
    ``tile``-sized tiles; -1 for none) that its in-image taps reach, each
    tile once: the tile rows of tap rows y0 and y0 + 1 where a tap of that
    row lies in the image, the same for the columns, a second row or
    column dropped where it is the first's tile. Their count over the
    pixels is the list entries one call writes and reads."""
    B, _, H, W = flow.shape
    th, tw = tile
    fx, fy = _abs_coords(*_flow_grid(flow, grid_hw), H, W, align_corners,
                         "zeros")
    x0, y0 = torch.floor(fx), torch.floor(fy)
    vx0, vx1 = (x0 >= 0) & (x0 <= W - 1), (x0 >= -1) & (x0 <= W - 2)
    vy0, vy1 = (y0 >= 0) & (y0 <= H - 1), (y0 >= -1) & (y0 <= H - 2)
    xi = x0.clamp(-1, W - 1).to(torch.int64)
    yi = y0.clamp(-1, H - 1).to(torch.int64)
    none = torch.full_like(xi, -1)
    ra = torch.where(vy0 & (vx0 | vx1), yi.clamp_min(0) // th, none)
    rb = torch.where(vy1 & (vx0 | vx1), (yi + 1) // th, none)
    ca = torch.where(vx0 & (vy0 | vy1), xi.clamp_min(0) // tw, none)
    cb = torch.where(vx1 & (vy0 | vy1), (xi + 1) // tw, none)
    rb = torch.where(rb == ra, none, rb)
    cb = torch.where(cb == ca, none, cb)
    ntx = -(-W // tw)
    keys = [torch.where((r >= 0) & (c >= 0), r * ntx + c, none)
            for r, c in ((ra, ca), (ra, cb), (rb, ca), (rb, cb))]
    return torch.stack(keys, 1)


_BASE_GRIDS = {}


def _base_grid(n: int, device):
    """``linspace(-1, 1, n)`` float32 on ``device``, made once per size and
    device: it steps from both ends, so it is not ``2j/(n-1) - 1`` bit for
    bit, and kernel and plain version read the same vector."""
    key = (n, torch.device(device))
    if key not in _BASE_GRIDS:
        _BASE_GRIDS[key] = torch.linspace(-1.0, 1.0, n, dtype=torch.float32,
                                          device=device)
    return _BASE_GRIDS[key]


def _channels_last(t) -> bool:
    return (not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _format(t):
    return (torch.channels_last if _channels_last(t)
            else torch.contiguous_format)


def _warp_grid(flow):
    """:func:`backward_warp`'s normalized grid: the ``linspace`` base
    grid plus the flow over (size - 1) / 2, in float32 (float64 for a
    float64 flow) with 0-dim divisors."""
    _, _, H, W = flow.shape
    flow = flow.to(_wf(flow))
    xs = _base_grid(W, flow.device).to(flow.dtype)
    ys = _base_grid(H, flow.device).to(flow.dtype)
    return (xs.view(1, 1, W) + flow[:, 0] / _const((W - 1) / 2.0, flow),
            ys.view(1, H, 1) + flow[:, 1] / _const((H - 1) / 2.0, flow))


def _grid_chain(gf, size: int, align_corners: bool):
    """The gradient of an absolute coordinate carried back to its
    normalized grid value: :func:`_unnormalize` transposed in the JAX
    code's float32 order."""
    if align_corners:
        return gf * _const(size - 1, gf) * 0.5
    return gf * 0.5 * _const(size, gf)


def _flow_chain(gfx, gfy, H: int, W: int, align_corners: bool):
    """The coordinates' gradients carried back to a flow in pixels
    (base + flow / ((size - 1) / 2)): (B, 2, H, W)."""
    return torch.stack(
        [_grid_chain(gfx, W, align_corners) / _const((W - 1) / 2.0, gfx),
         _grid_chain(gfy, H, align_corners) / _const((H - 1) / 2.0, gfy)],
        dim=1)


def backward_warp_plain(img, flow, align_corners: bool = False,
                        padding_mode: str = "border"):
    """Plain version of :func:`backward_warp`: the grid of
    :func:`_warp_grid`, then :func:`grid_sample_bilinear_plain`; the result
    in ``img``'s memory format."""
    gx, gy = _warp_grid(flow)
    out = grid_sample_bilinear_plain(img, gx, gy, align_corners, padding_mode)
    return out.contiguous(memory_format=_format(img))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check_maps(maps):
    if maps.dim() != 4:
        raise ValueError(f"maps: expected (B, C, H, W), got {tuple(maps.shape)}")
    if maps.dtype not in _DTYPES and not (maps.dtype == torch.float64
                                          and maps.device.type == "cpu"):
        raise TypeError(f"maps: expected float32 or bfloat16 (float64 on "
                        f"the CPU), got {maps.dtype}")
    if maps.numel() >= 2 ** 31:
        raise ValueError("maps: the kernel indexes with 32 bits; "
                         f"{maps.numel()} elements exceed 2**31 - 1")


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
    LAUNCHES[name] += 1


def grid_sample_bilinear(img, grid_x, grid_y, align_corners: bool = True,
                         padding_mode: str = "zeros"):
    """Sample ``img`` (B, C, H, W) at normalized coordinates ``grid_x``,
    ``grid_y`` (B, Ho, Wo) in [-1, 1] (x indexes width), as
    ``F.grid_sample(mode='bilinear')`` does. ``padding_mode``: 'zeros' or
    'border' (coordinates clamped to the edge). Returns (B, C, Ho, Wo).
    On CUDA tensors one launch of ``mfc_warp_abs``, which unnormalizes and
    clamps the grid itself (float32 or bfloat16 grids; a float32 grid and
    an NCHW image are read in place). Differentiable in all three inputs
    (see the module docstring)."""
    _check_maps(img)
    if grid_x.shape != grid_y.shape or grid_x.dim() != 3 \
            or grid_x.shape[0] != img.shape[0]:
        raise ValueError("grid_x, grid_y: expected two (B, Ho, Wo) tensors")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if _wants_grad(img, grid_x, grid_y):
        return _GridSample.apply(img, grid_x, grid_y, align_corners,
                                 padding_mode)
    return _grid_sample_forward(img, grid_x, grid_y, align_corners,
                                padding_mode)


def _grid_sample_forward(img, grid_x, grid_y, align_corners, padding_mode):
    if route(img, grid_x, grid_y) == "cpu":
        return grid_sample_bilinear_plain(img, grid_x, grid_y, align_corners,
                                          padding_mode)
    if grid_x.dtype not in _DTYPES or grid_y.dtype not in _DTYPES:
        raise TypeError(f"grid: expected float32 or bfloat16, got "
                        f"{grid_x.dtype}, {grid_y.dtype}")
    B, C, H, W = img.shape
    img = img.contiguous()
    gx, gy = grid_x.float().contiguous(), grid_y.float().contiguous()
    Ho, Wo = gx.shape[-2:]
    out = torch.empty(B, C, Ho, Wo, dtype=img.dtype, device=img.device)
    rc = kernel_lib().mfc_warp_abs(
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
        B, C, H, W, Ho, Wo, int(align_corners), int(padding_mode == "border"),
        _DTYPES[img.dtype], stream_of(img))
    _launch("warp_abs", rc)
    return out


def flow_warp(maps, flow, grid_hw=None, align_corners: bool = True):
    """Warp maps by optical flow (MFCNet alignment semantics, reference
    models/multiframe_model.py:141-170).

    maps: (B, C, H, W) float32 or bfloat16; flow: (B, 2, H, W) in pixels,
    channel 0 = x displacement. The sampling grid is ``base + flow`` with
    the flow normalized by (size-1)/2. ``grid_hw``: the size the base mesh
    grid was built at before it was cropped to (H, W); the reference
    builds it at a fixed 576x720, so at 480x640 zero flow is NOT an
    identity sample. ``None`` gives the identity grid. Returns
    (B, C, H, W) in the maps' dtype. Differentiable in maps and flow (see
    the module docstring)."""
    _check_maps(maps)
    B, C, H, W = maps.shape
    if flow.shape != (B, 2, H, W):
        raise ValueError(f"flow: expected {(B, 2, H, W)}, "
                         f"got {tuple(flow.shape)}")
    gh, gw = (H, W) if grid_hw is None else grid_hw
    if gh < H or gw < W:
        raise ValueError(f"grid_hw {grid_hw} smaller than input {(H, W)}")
    if torch.is_grad_enabled() and (maps.requires_grad or flow.requires_grad):
        return _FlowWarp.apply(maps, flow, grid_hw, align_corners)
    return _flow_warp_forward(maps, flow, grid_hw, align_corners)


def _flow_warp_forward(maps, flow, grid_hw, align_corners):
    where = route(maps, flow)
    gh, gw = maps.shape[-2:] if grid_hw is None else grid_hw
    if traced(maps, flow):
        return torch.ops.mfcnet.flow_warp(maps, flow, gh, gw, align_corners)
    impl = _flow_warp_cpu if where == "cpu" else _flow_warp_cuda
    return impl(maps, flow, gh, gw, align_corners)


def _flow_warp_cpu(maps: torch.Tensor, flow: torch.Tensor, grid_h: int,
                   grid_w: int, align_corners: bool) -> torch.Tensor:
    return flow_warp_plain(maps, flow, (grid_h, grid_w),
                           align_corners).contiguous()


# ``mfcnet::flow_warp``: the forward as a registered operator, so that an
# exported graph (``serve/export.py``) names it and launches the kernel on
# the card. Its CPU kernel is the plain version, its CUDA kernel the launch;
# no other device has one. A call that is not traced skips the dispatcher
# and calls the two functions directly (``_flow_warp_forward``).
_flow_warp_op = torch.library.custom_op(
    "mfcnet::flow_warp", _flow_warp_cpu, mutates_args=(), device_types="cpu")


@_flow_warp_op.register_kernel("cuda")
def _flow_warp_cuda(maps, flow, grid_h, grid_w, align_corners):
    _check_maps(maps)
    B, C, H, W = maps.shape
    maps = maps.contiguous()
    flow = flow.float().contiguous()
    out = torch.empty_like(maps)
    rc = kernel_lib().mfc_flow_warp(
        maps.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
        grid_h, grid_w, int(align_corners), _DTYPES[maps.dtype],
        stream_of(maps))
    _launch("flow_warp", rc)
    return out


@_flow_warp_op.register_fake
def _flow_warp_fake(maps, flow, grid_h, grid_w, align_corners):
    return torch.empty_like(maps, memory_format=torch.contiguous_format)


def flow_warp_bwd_maps(g, flow, grid_hw=None, align_corners: bool = True):
    """The maps gradient of :func:`flow_warp` on CUDA tensors: ``g``
    (B, C, H, W) float32 or bfloat16, the upstream gradient; ``flow``
    (B, 2, H, W). One cooperative launch of ``mfc_flow_warp_bwd_maps`` on
    :func:`warp_bwd_plan`'s plan (bin the pixels by destination tile, sum
    each tile in shared memory, write it in g's type). Returns (B, C, H, W)
    in g's type."""
    _check_maps(g)
    B, C, H, W = g.shape
    gh, gw = (H, W) if grid_hw is None else grid_hw
    g = g.contiguous()
    if g.data_ptr() % 4:  # the kernel copies g in aligned 32-bit words
        g = g.clone()
    flow = flow.float().contiguous()
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    plan = warp_bwd_plan(B, C, H, W, sm_count(g.device))
    # scratch of this call: the caching allocator hands the same block back
    # to the next call of the shape, and nothing in it outlives the launch
    work = torch.empty(plan.work_ints, dtype=torch.int32, device=g.device)
    rc = kernel_lib().mfc_flow_warp_bwd_maps(
        g.data_ptr(), flow.data_ptr(), work.data_ptr(), out.data_ptr(),
        B, C, H, W, gh, gw, int(align_corners), _DTYPES[g.dtype],
        _plan_ints(plan), stream_of(g))
    if rc == PLAN_REFUSED:
        raise RuntimeError(f"CUDA kernel flow_warp_bwd_maps refused the plan "
                           f"{plan} for {(B, C, H, W)} (error {rc})")
    _launch("flow_warp_bwd_maps", rc)
    return out


def flow_warp_bwd_flow(g, maps, flow, grid_hw=None,
                       align_corners: bool = True):
    """The flow gradient of :func:`flow_warp` on CUDA tensors: ``g`` and
    ``maps`` (B, C, H, W) of one type, ``flow`` (B, 2, H, W). One launch
    of ``mfc_flow_warp_bwd_flow``. Returns (B, 2, H, W) float32."""
    _check_maps(maps)
    B, C, H, W = maps.shape
    gh, gw = (H, W) if grid_hw is None else grid_hw
    g = g.to(maps.dtype).contiguous()
    maps = maps.contiguous()
    flow = flow.float().contiguous()
    out = torch.empty(B, 2, H, W, dtype=torch.float32, device=maps.device)
    rc = kernel_lib().mfc_flow_warp_bwd_flow(
        g.data_ptr(), maps.data_ptr(), flow.data_ptr(), out.data_ptr(),
        B, C, H, W, gh, gw, int(align_corners), _DTYPES[maps.dtype],
        stream_of(maps))
    _launch("flow_warp_bwd_flow", rc)
    return out


class _FlowWarp(torch.autograd.Function):
    """:func:`flow_warp` with its backward: the kernels on CUDA tensors,
    :func:`flow_warp_backward_plain` on CPU tensors; each gradient only
    where its input requires one."""

    @staticmethod
    def forward(ctx, maps, flow, grid_hw, align_corners):
        ctx.save_for_backward(maps, flow)
        ctx.grid_hw, ctx.align_corners = grid_hw, align_corners
        return _flow_warp_forward(maps, flow, grid_hw, align_corners)

    @staticmethod
    def backward(ctx, g):
        maps, flow = ctx.saved_tensors
        want_maps, want_flow = ctx.needs_input_grad[:2]
        g = g.to(maps.dtype)
        if route(g, maps, flow) == "cpu":
            gm, gf = flow_warp_backward_plain(g, maps, flow, ctx.grid_hw,
                                              ctx.align_corners)
        else:
            gm = (flow_warp_bwd_maps(g, flow, ctx.grid_hw, ctx.align_corners)
                  if want_maps else None)
            gf = (flow_warp_bwd_flow(g, maps, flow, ctx.grid_hw,
                                     ctx.align_corners)
                  if want_flow else None)
        return (gm if want_maps else None,
                gf.to(flow.dtype) if want_flow else None, None, None)


def _dense(t) -> bool:
    return t.is_contiguous() or _channels_last(t)


def backward_warp(img, flow, align_corners: bool = False,
                  padding_mode: str = "border"):
    """Sample ``img`` (B, C, H, W) at ``linspace(-1, 1)`` base grid +
    ``flow`` / ((size-1)/2), as ``F.grid_sample(mode='bilinear')`` does
    (reference models/unflow_model.py:6-17 with its defaults).

    img: float32 or bfloat16, NCHW or ``channels_last``; flow (B, 2, H, W)
    in pixels, channel 0 = x, float32 or bfloat16, any strides. One kernel
    launch on CUDA tensors: no copy of either input, the flow converted on
    load. Returns (B, C, H, W) in ``img``'s type and memory format.
    Differentiable in ``img`` and ``flow`` (see the module docstring)."""
    _check_maps(img)
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    B, C, H, W = img.shape
    if flow.shape != (B, 2, H, W):
        raise ValueError(f"flow: expected {(B, 2, H, W)}, "
                         f"got {tuple(flow.shape)}")
    if flow.dtype not in _DTYPES and not (flow.dtype == torch.float64
                                          and flow.device.type == "cpu"):
        raise TypeError(f"flow: expected float32 or bfloat16, got {flow.dtype}")
    if _wants_grad(img, flow):
        return _BackwardWarp.apply(img, flow, align_corners, padding_mode)
    return _backward_warp_forward(img, flow, align_corners, padding_mode)


def _backward_warp_forward(img, flow, align_corners, padding_mode):
    B, C, H, W = img.shape
    if route(img, flow) == "cpu":
        return backward_warp_plain(img, flow, align_corners, padding_mode)
    if not _dense(img):
        img = img.contiguous()
    if flow.numel() and max(
            abs(st) * (n - 1) for st, n in zip(flow.stride(), flow.shape)
    ) >= 2 ** 31:
        raise ValueError("flow: the kernel indexes with 32 bits")
    out = torch.empty_like(img)  # keeps a dense input's strides
    strides = (ctypes.c_int * 12)(*img.stride(), *flow.stride(),
                                  *out.stride())
    rc = kernel_lib().mfc_backward_warp(
        img.data_ptr(), flow.data_ptr(), out.data_ptr(), strides,
        _base_grid(W, img.device).data_ptr(),
        _base_grid(H, img.device).data_ptr(), B, C, H, W,
        int(align_corners), int(padding_mode == "border"),
        _DTYPES[img.dtype], _DTYPES[flow.dtype], stream_of(img))
    _launch("backward_warp", rc)
    return out


# ---------------------------------------------------------------------------
# B3: the backward of grid_sample_bilinear and backward_warp
# ---------------------------------------------------------------------------
def sample_bwd_tiles(fx, fy, H: int, W: int, C: int,
                     padding_mode: str = "zeros"):
    """The image entry's tiling of ``mfc_sample_bwd_img`` in torch, for
    absolute coordinates ``fx``, ``fy`` (B, Ho, Wo) on an (H, W) image of C
    channels: for each tile of SAMPLE_BWD_TILE_H x SAMPLE_BWD_TILE_W
    samples the box of its valid taps (columns ``x_lo..x_hi``, rows
    ``y_lo..y_hi``; empty where ``x_lo > x_hi``) and whether the box times C
    fits SAMPLE_BWD_CAP floats (the shared-memory route; the others add
    directly). Returns ``(ext, local)``: (B, nty, ntx, 4) int64 (x_lo,
    x_hi, y_lo, y_hi) and (B, nty, ntx) bool."""
    B, Ho, Wo = fx.shape
    fx, fy = fx.float(), fy.float()
    if padding_mode == "border":
        fx, fy = fx.clamp(0.0, W - 1), fy.clamp(0.0, H - 1)
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    valid = (((x0f >= 0) & (x0f <= W - 1)) | ((x0f >= -1) & (x0f <= W - 2))) \
        & (((y0f >= 0) & (y0f <= H - 1)) | ((y0f >= -1) & (y0f <= H - 2)))
    big = 2 ** 40
    x0 = torch.where(valid, x0f.clamp(-1, W - 1), 0).long()
    y0 = torch.where(valid, y0f.clamp(-1, H - 1), 0).long()
    th, tw = SAMPLE_BWD_TILE_H, SAMPLE_BWD_TILE_W
    nty, ntx = -(-Ho // th), -(-Wo // tw)

    def tiles(t, fill):
        t = torch.where(valid, t, fill)
        t = torch.nn.functional.pad(t, (0, ntx * tw - Wo, 0, nty * th - Ho),
                                    value=fill)
        return t.view(B, nty, th, ntx, tw)

    ext = torch.stack([
        tiles(x0.clamp(min=0), big).amin((2, 4)),
        tiles((x0 + 1).clamp(max=W - 1), -big).amax((2, 4)),
        tiles(y0.clamp(min=0), big).amin((2, 4)),
        tiles((y0 + 1).clamp(max=H - 1), -big).amax((2, 4))], -1)
    size = ((ext[..., 1] - ext[..., 0] + 1) * (ext[..., 3] - ext[..., 2] + 1)
            * C)
    local = (ext[..., 0] <= ext[..., 1]) & (size <= SAMPLE_BWD_CAP)
    return ext, local


def sample_backward_plain(g, img, fx, fy, padding_mode: str = "zeros",
                          needs=(True, True)):
    """Plain version of :func:`sample_backward`:
    :func:`sample_abs_backward_plain` in JAX's floor form."""
    gi, gfx, gfy = sample_abs_backward_plain(g, img, fx, fy, padding_mode,
                                             hat=False)
    gi = (gi.to(img.dtype).contiguous(memory_format=_format(img))
          if needs[0] else None)
    return (gi,) + ((gfx, gfy) if needs[1] else (None, None))


def sample_backward(g, img, fx, fy, padding_mode: str = "zeros",
                    needs=(True, True)):
    """The VJP of the bilinear sample of ``img`` (B, C, H, W) at the
    absolute, unclamped coordinates ``fx``, ``fy`` (B, Ho, Wo) in
    ``padding_mode``, for the upstream gradient ``g`` (B, C, Ho, Wo):
    ``(grad_img, grad_fx, grad_fy)``, the image's gradient in its type and
    memory format where ``needs[0]``, the coordinates' float32 gradients
    where ``needs[1]`` (None otherwise). On CUDA tensors one launch of
    ``mfc_sample_bwd_img`` (tile-local sums added into a zeroed float32
    buffer) and one of ``mfc_sample_bwd_coords``, each only where its gradient is
    wanted; on CPU tensors :func:`sample_backward_plain`."""
    if route(g, img, fx, fy) == "cpu":
        return sample_backward_plain(g, img, fx, fy, padding_mode, needs)
    B, C, H, W = img.shape
    Ho, Wo = fx.shape[-2:]
    g = g.to(img.dtype)
    g, img = (t if _dense(t) else t.contiguous() for t in (g, img))
    fx, fy = fx.float().contiguous(), fy.float().contiguous()
    if max(g.numel(), img.numel()) >= 2 ** 31:
        raise ValueError("sample_backward: the kernels index with 32 bits")
    border = int(padding_mode == "border")
    lib, stream = kernel_lib(), stream_of(img)
    gi = gfx = gfy = None
    if needs[0]:
        acc = torch.zeros_like(img, dtype=torch.float32,
                               memory_format=_format(img))
        rc = lib.mfc_sample_bwd_img(
            g.data_ptr(), fx.data_ptr(), fy.data_ptr(), acc.data_ptr(),
            (ctypes.c_int * 8)(*g.stride(), *acc.stride()), B, C, H, W, Ho,
            Wo, border, _DTYPES[img.dtype], stream)
        _launch("sample_bwd_img", rc)
        gi = acc.to(img.dtype)
    if needs[1]:
        gfx, gfy = (torch.empty(B, Ho, Wo, dtype=torch.float32,
                                device=img.device) for _ in range(2))
        rc = lib.mfc_sample_bwd_coords(
            g.data_ptr(), img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            gfx.data_ptr(), gfy.data_ptr(),
            (ctypes.c_int * 8)(*g.stride(), *img.stride()), B, C, H, W, Ho,
            Wo, border, _DTYPES[img.dtype], stream)
        _launch("sample_bwd_coords", rc)
    return gi, gfx, gfy


class _GridSample(torch.autograd.Function):
    """:func:`grid_sample_bilinear` with its backward
    (:func:`sample_backward`, the chain to the grid in PyTorch)."""

    @staticmethod
    def forward(ctx, img, grid_x, grid_y, align_corners, padding_mode):
        ctx.save_for_backward(img, grid_x, grid_y)
        ctx.align_corners, ctx.padding_mode = align_corners, padding_mode
        return _grid_sample_forward(img, grid_x, grid_y, align_corners,
                                    padding_mode)

    @staticmethod
    def backward(ctx, g):
        img, grid_x, grid_y = ctx.saved_tensors
        want_img, want_x, want_y = ctx.needs_input_grad[:3]
        H, W = img.shape[-2:]
        fx, fy = _abs_coords(grid_x, grid_y, H, W, ctx.align_corners,
                             "zeros")
        gi, gfx, gfy = sample_backward(g, img, fx, fy, ctx.padding_mode,
                                       (want_img, want_x or want_y))
        gx = (_grid_chain(gfx, W, ctx.align_corners).to(grid_x.dtype)
              if want_x else None)
        gy = (_grid_chain(gfy, H, ctx.align_corners).to(grid_y.dtype)
              if want_y else None)
        return gi, gx, gy, None, None


class _BackwardWarp(torch.autograd.Function):
    """:func:`backward_warp` with its backward (:func:`sample_backward`, the
    chain to the flow in PyTorch)."""

    @staticmethod
    def forward(ctx, img, flow, align_corners, padding_mode):
        ctx.save_for_backward(img, flow)
        ctx.align_corners, ctx.padding_mode = align_corners, padding_mode
        return _backward_warp_forward(img, flow, align_corners, padding_mode)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        want_img, want_flow = ctx.needs_input_grad[:2]
        H, W = img.shape[-2:]
        gx, gy = _warp_grid(flow)
        fx, fy = _abs_coords(gx, gy, H, W, ctx.align_corners, "zeros")
        gi, gfx, gfy = sample_backward(g, img, fx, fy, ctx.padding_mode,
                                       (want_img, want_flow))
        if not want_flow:
            return gi, None, None, None
        gflow = _flow_chain(gfx, gfy, H, W, ctx.align_corners)
        return (gi, gflow.to(flow.dtype).contiguous(
            memory_format=_format(flow)), None, None)
