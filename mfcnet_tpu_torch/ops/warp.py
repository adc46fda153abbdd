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
when the flow leaves the band, differentiates the floor form). The other
warps (``grid_sample_bilinear``, ``backward_warp``) stay forward only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mfcnet_tpu_torch.ops._build import kernel_lib, route, sm_count, stream_of

#: kernel launches per entry point since the last :func:`reset_launches`
LAUNCHES = {"flow_warp": 0, "warp_abs": 0, "backward_warp": 0,
            "flow_warp_bwd_maps": 0, "flow_warp_bwd_flow": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TRAINING = ("this warp has no backward kernel (the flow providers train "
             "frozen): ROADMAP.md Queue 1 item 8b (training a flow provider: "
             "B2 and the update step's backward)")


#: the maps gradient's kernel (``csrc/warp.cu`` has the same): destination
#: tiles of BWD_TILE_H x BWD_TILE_W pixels, at most BWD_MAX_GROUP_C channels
#: a tile pass, BWD_BLOCKS_PER_SM blocks of BWD_THREADS threads an SM, up to
#: BWD_CAP list entries staged at once, and the error code of a refused plan
BWD_TILE_H, BWD_TILE_W, BWD_MAX_GROUP_C = 8, 64, 6
BWD_BLOCKS_PER_SM, BWD_THREADS, BWD_CAP, PLAN_REFUSED = 3, 256, 1024, 20004
#: tap-box corners (top-left taps) whose boxes reach a tile
BWD_CORNERS = (BWD_TILE_H + 1) * (BWD_TILE_W + 1)


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


def _no_grad_inputs(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"an input requires a gradient, but {_TRAINING}")


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
    dev, dt = flow.device, _wf(flow)

    def c(v):
        return torch.full((), float(v), dtype=dt, device=dev)

    xs = 2.0 * torch.arange(W, dtype=dt, device=dev) / c(gw - 1) - 1.0
    ys = 2.0 * torch.arange(H, dtype=dt, device=dev) / c(gh - 1) - 1.0
    flow = flow.to(dt)
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


def sample_abs_backward_plain(g, img, fx, fy):
    """VJP of the bilinear sample of ``img`` (B, C, H, W) at absolute
    float32 coordinates ``fx``, ``fy`` (B, Ho, Wo), zeros padding, for the
    upstream gradient ``g`` (B, C, Ho, Wo). Returns float32
    ``(grad_img, grad_fx, grad_fy)``: each output's gradient added to its
    four taps with the forward's weights (``index_add_``), and the
    derivative of the sample along x and y summed over channels (see
    :func:`_hat_diff` for integer coordinates)."""
    B, C, H, W = img.shape
    Ho, Wo = fx.shape[-2:]
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
    ix, iy = (tx == 0).unsqueeze(1), (ty == 0).unsqueeze(1)
    tx, ty, ux, uy = (t.unsqueeze(1) for t in (tx, ty, ux, uy))
    dxv = (uy * _hat_diff(tap(0, -1), v00, v01, ix)
           + ty * _hat_diff(tap(1, -1), v10, v11, ix))
    dyv = (ux * _hat_diff(tap(-1, 0), v00, v10, iy)
           + tx * _hat_diff(tap(-1, 1), v01, v11, iy))
    return grad_img, (gf * dxv).sum(1), (gf * dyv).sum(1)


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
    dev, dt = maps.device, fx.dtype

    def c(v):
        return torch.full((), float(v), dtype=dt, device=dev)

    if align_corners:
        cx, cy = gfx * c(W - 1) * 0.5, gfy * c(H - 1) * 0.5
    else:
        cx, cy = gfx * 0.5 * c(W), gfy * 0.5 * c(H)
    grad_flow = torch.stack([cx / c((W - 1) / 2.0), cy / c((H - 1) / 2.0)],
                            dim=1)
    return gi.to(maps.dtype), grad_flow


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


def backward_warp_plain(img, flow, align_corners: bool = False,
                        padding_mode: str = "border"):
    """Plain version of :func:`backward_warp`: the grid in float32 with
    0-dim divisors (see :func:`_flow_grid`), then
    :func:`grid_sample_bilinear_plain`; the result in ``img``'s memory
    format."""
    B, _, H, W = img.shape
    dev = img.device

    def c(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    flow = flow.float()
    gx = _base_grid(W, dev).view(1, 1, W) + flow[:, 0] / c((W - 1) / 2.0)
    gy = _base_grid(H, dev).view(1, H, 1) + flow[:, 1] / c((H - 1) / 2.0)
    out = grid_sample_bilinear_plain(img, gx, gy, align_corners, padding_mode)
    if _channels_last(img):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


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
    an NCHW image are read in place)."""
    _check_maps(img)
    _no_grad_inputs(img, grid_x, grid_y)
    if grid_x.shape != grid_y.shape or grid_x.dim() != 3 \
            or grid_x.shape[0] != img.shape[0]:
        raise ValueError("grid_x, grid_y: expected two (B, Ho, Wo) tensors")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
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
    if route(maps, flow) == "cpu":
        return flow_warp_plain(maps, flow, grid_hw, align_corners)
    B, C, H, W = maps.shape
    gh, gw = (H, W) if grid_hw is None else grid_hw
    maps = maps.contiguous()
    flow = flow.float().contiguous()
    out = torch.empty_like(maps)
    rc = kernel_lib().mfc_flow_warp(
        maps.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
        gh, gw, int(align_corners), _DTYPES[maps.dtype], stream_of(maps))
    _launch("flow_warp", rc)
    return out


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
    load. Returns (B, C, H, W) in ``img``'s type and memory format."""
    _check_maps(img)
    _no_grad_inputs(img, flow)
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    B, C, H, W = img.shape
    if flow.shape != (B, 2, H, W):
        raise ValueError(f"flow: expected {(B, 2, H, W)}, "
                         f"got {tuple(flow.shape)}")
    if flow.dtype not in _DTYPES:
        raise TypeError(f"flow: expected float32 or bfloat16, got {flow.dtype}")
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
