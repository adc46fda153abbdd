"""Direct 3x3 convolution with fused bias and ReLU (counterpart of
``mfcnet_tpu/experimental/conv3x3_pallas.py::conv3x3_pallas``).

Stride 1, SAME padding, float32 accumulation, the result rounded once to
``x``'s type. Layout: ``x`` (B, H, W, cin) and the result (B, H, W, cout)
are NHWC and ``w`` (3, 3, cin, cout) is HWIO, the JAX function's layout
(for PyTorch: ``x`` is the channels_last storage of an NCHW tensor, and
``w = conv.weight.permute(2, 3, 1, 0)``).

:func:`conv3x3` launches the hand-written kernel of ``csrc/conv3x3.cu`` on
CUDA tensors (tensor cores for bfloat16, FMAs for float32) and runs
:func:`conv3x3_plain` (``F.conv2d`` at the same rounding points) on CPU
tensors. There is no fallback between the two. Each launch adds one to
:data:`LAUNCHES`. Forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.ops._build import kernel_lib, route, stream_of

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"conv3x3": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if pixels * max(x.shape[-1], cin, w.shape[-1]) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes with 32 bits")


def aligned(t):
    """Contiguous and 16-byte aligned, as the kernels' vector copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    rc = kernel_lib().mfc_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), B, H, W, cin, cout, int(relu), DTYPES[x.dtype],
        stream_of(x))
    if rc == -1:
        raise RuntimeError("conv3x3: the device allows a block less shared "
                           "memory than the kernel's tiles need")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel conv3x3 failed: cudaError {rc}")
    LAUNCHES["conv3x3"] += 1
    return out
