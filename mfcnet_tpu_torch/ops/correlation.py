"""UnFlow's correlation cost volume (counterpart of
``mfcnet_tpu/ops/correlation.py`` and of the TPU kernel
``mfcnet_tpu/ops/correlation_pallas.py::correlation_pallas``).

For feature maps ``f1``, ``f2`` of shape (B, H, W, C), with ``f2`` read as
zero outside the image, and ``D = 2 * (max_displacement // stride) + 1``:

    out[b, y, x, dy_i * D + dx_i]
        = (1 / C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]
    (dx, dy) = ((dx_i - D // 2) * stride, (dy_i - D // 2) * stride)

The channel order is dy-major, and dy moves rows; the window is centred
as in ``correlation_shifts`` (the Pallas kernel's starts at
``-max_displacement``, which is the same only where ``max_displacement``
is a multiple of ``stride``). UnFlow runs it at
``max_displacement=20, stride=2`` (441 channels) on 256-channel features.

:func:`correlation_cost_volume` launches the hand-written kernel of
``csrc/correlation.cu`` on CUDA tensors and runs
:func:`correlation_plain`, the same function in plain PyTorch, on CPU
tensors. There is no fallback between the two. Each launch adds one to
:data:`LAUNCHES`.

Layout: inputs and output are (B, H, W, channels), the JAX functions'
layout. The kernel wants the C values of a pixel contiguous (a dot product
over C per output), and the consumer is the ``combined`` 3x3 convolution
after a concatenation with ``redir`` (``models/unflow.py``), which runs in
``channels_last`` memory format: (B, H, W, 441) *is* the channels_last
storage of the (B, 441, H, W) tensor that convolution takes, so neither
side of the kernel needs a copy.

Types: inputs float32 or bfloat16, read as they are and widened inside
the kernel; float32 sums; float32 output. ``(1 / C)`` is a product with the
rounded reciprocal, as in the TPU kernel (``correlation_shifts`` takes a
mean: one rounding apart). The sum over C runs in another order in the
kernel than in the plain version, so the two agree to atol 1e-5, rtol 1e-5
at float32 (the JAX package's own limit for its kernel), not bit for bit.
Forward only: the backward kernel comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.ops._build import kernel_lib, route, stream_of

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"correlation": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TRAINING = ("the correlation's backward kernel comes with the training "
             "slice: ROADMAP.md Queue 1 item 8 (training)")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def displacements(max_displacement: int, stride: int) -> int:
    """D, the number of displacements per axis."""
    if max_displacement < 0 or stride < 1:
        raise ValueError(f"max_displacement {max_displacement} / stride "
                         f"{stride}: need max_displacement >= 0, stride >= 1")
    return 2 * (max_displacement // stride) + 1


def _check(f1, f2):
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"f1, f2: expected two (B, H, W, C) tensors of one "
                         f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(f"f1, f2: expected both float32 or both bfloat16, "
                        f"got {f1.dtype} and {f2.dtype}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise NotImplementedError(
            f"an input requires a gradient, but {_TRAINING}")


def correlation_plain(f1, f2, max_displacement: int = 20, stride: int = 2):
    """Plain version of :func:`correlation_cost_volume`: one shifted
    product and one sum over C per displacement, any device."""
    B, H, W, C = f1.shape
    md, s = max_displacement, stride
    D = displacements(md, s)
    a = f1.float()
    b = F.pad(f2.float(), (0, 0, md, md, md, md))
    inv_c = 1.0 / C
    outs = []
    for dyi in range(D):
        y0 = md + (dyi - md // s) * s
        for dxi in range(D):
            x0 = md + (dxi - md // s) * s
            win = b[:, y0:y0 + H, x0:x0 + W]
            outs.append((a * win).sum(-1) * inv_c)
    return torch.stack(outs, dim=-1)


def correlation_cost_volume(f1, f2, max_displacement: int = 20,
                            stride: int = 2):
    """(B, H, W, C) x 2, float32 or bfloat16 -> (B, H, W, D*D) float32
    cost volume, channel ``dy_i * D + dx_i`` (see the module docstring)."""
    _check(f1, f2)
    D = displacements(max_displacement, stride)
    if route(f1, f2) == "cpu":
        return correlation_plain(f1, f2, max_displacement, stride)
    B, H, W, C = f1.shape
    if max(f1.numel(), B * H * W * D * D) >= 2 ** 31:
        raise ValueError(
            "correlation: the kernel indexes with 32 bits; "
            f"{max(f1.numel(), B * H * W * D * D)} elements exceed 2**31 - 1")
    # the kernel copies 16 (float32) or 8 (bfloat16) bytes at a time
    f1, f2 = (t if t.data_ptr() % 16 == 0 else t.clone()
              for t in (f1.contiguous(), f2.contiguous()))
    out = torch.empty(B, H, W, D * D, dtype=torch.float32, device=f1.device)
    if out.numel() == 0:
        return out
    rc = kernel_lib().mfc_correlation(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C,
        max_displacement, stride, _DTYPES[f1.dtype], stream_of(f1))
    if rc == -1:
        raise ValueError(
            f"correlation: C={C} with max_displacement={max_displacement} "
            "needs more shared memory than a block has (227 KB)")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel correlation failed: cudaError {rc}")
    LAUNCHES["correlation"] += 1
    return out
