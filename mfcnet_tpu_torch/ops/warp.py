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
entry point, which takes absolute source coordinates as the TPU kernel
does. :func:`backward_warp` is UnFlow's warp (``models/unflow.py``, once
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
returned in the maps' dtype. Forward only: the backward kernel comes with
the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from mfcnet_tpu_torch.ops._build import kernel_lib, route, stream_of

#: kernel launches per entry point since the last :func:`reset_launches`
LAUNCHES = {"flow_warp": 0, "warp_abs": 0, "backward_warp": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TRAINING = ("the warp's backward kernel comes with the training slice: "
             "ROADMAP.md Queue 1 item 8 (training)")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _no_grad_inputs(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"an input requires a gradient, but {_TRAINING}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
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
        valid = (xf >= 0) & (xf <= W - 1) & (yf >= 0) & (yf <= H - 1)
        xi = xf.clamp(0, W - 1).to(torch.int64)
        yi = yf.clamp(0, H - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, 1, Ho * Wo).expand(B, C, Ho * Wo)
        v = flat.gather(2, idx).reshape(B, C, Ho, Wo).float()
        return v * valid.unsqueeze(1).to(torch.float32)

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
    fx = _unnormalize(grid_x.float(), W, align_corners)
    fy = _unnormalize(grid_y.float(), H, align_corners)
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
    dev = flow.device

    def c(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    xs = 2.0 * torch.arange(W, dtype=torch.float32, device=dev) / c(gw - 1) - 1.0
    ys = 2.0 * torch.arange(H, dtype=torch.float32, device=dev) / c(gh - 1) - 1.0
    flow = flow.float()
    gx = xs.view(1, 1, W) + flow[:, 0] / c((W - 1) / 2.0)
    gy = ys.view(1, H, 1) + flow[:, 1] / c((H - 1) / 2.0)
    return gx, gy


def flow_warp_plain(maps, flow, grid_hw=None, align_corners: bool = True):
    """Plain version of :func:`flow_warp` (same arithmetic, any device)."""
    gx, gy = _flow_grid(flow, grid_hw)
    return grid_sample_bilinear_plain(maps, gx, gy, align_corners)


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
    if maps.dtype not in _DTYPES:
        raise TypeError(f"maps: expected float32 or bfloat16, got {maps.dtype}")
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
    'border' (coordinates clamped to the edge). Returns (B, C, Ho, Wo)."""
    _check_maps(img)
    _no_grad_inputs(img, grid_x, grid_y)
    if grid_x.shape != grid_y.shape or grid_x.dim() != 3 \
            or grid_x.shape[0] != img.shape[0]:
        raise ValueError("grid_x, grid_y: expected two (B, Ho, Wo) tensors")
    if route(img, grid_x, grid_y) == "cpu":
        return grid_sample_bilinear_plain(img, grid_x, grid_y, align_corners,
                                          padding_mode)
    B, C, H, W = img.shape
    fx, fy = _abs_coords(grid_x, grid_y, H, W, align_corners, padding_mode)
    fx, fy, img = fx.contiguous(), fy.contiguous(), img.contiguous()
    Ho, Wo = fx.shape[-2:]
    out = torch.empty(B, C, Ho, Wo, dtype=img.dtype, device=img.device)
    rc = kernel_lib().mfc_warp_abs(
        img.data_ptr(), fx.data_ptr(), fy.data_ptr(), out.data_ptr(),
        B, C, H, W, Ho, Wo, _DTYPES[img.dtype], stream_of(img))
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
    (B, C, H, W) in the maps' dtype."""
    _check_maps(maps)
    _no_grad_inputs(maps, flow)
    B, C, H, W = maps.shape
    if flow.shape != (B, 2, H, W):
        raise ValueError(f"flow: expected {(B, 2, H, W)}, "
                         f"got {tuple(flow.shape)}")
    gh, gw = (H, W) if grid_hw is None else grid_hw
    if gh < H or gw < W:
        raise ValueError(f"grid_hw {grid_hw} smaller than input {(H, W)}")
    if route(maps, flow) == "cpu":
        return flow_warp_plain(maps, flow, grid_hw, align_corners)
    maps = maps.contiguous()
    flow = flow.float().contiguous()
    out = torch.empty_like(maps)
    rc = kernel_lib().mfc_flow_warp(
        maps.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
        gh, gw, int(align_corners), _DTYPES[maps.dtype], stream_of(maps))
    _launch("flow_warp", rc)
    return out


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
