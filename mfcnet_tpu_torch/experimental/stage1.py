"""Fused first VGG stage (counterpart of
``mfcnet_tpu/experimental/stage1_pallas.py::vgg_stage1_pallas``):
``relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2)``, SAME padding.

Both convolutions accumulate in float32; the weights and the intermediate
are rounded to ``x``'s type, the biases stay float32; outside the image
the second convolution sees zeros, not the first convolution's value
there. Layout: ``x`` (B, H, W, cin) and the result (B, H, W, C1) are NHWC,
``k1`` (3, 3, cin, C1) and ``k2`` (3, 3, C1, C1) HWIO, the JAX function's
layout.

:func:`vgg_stage1` launches the hand-written kernel of ``csrc/stage1.cu``
on CUDA tensors, which keeps the intermediate in shared memory, and runs
:func:`vgg_stage1_plain` (two ``F.conv2d`` at the same rounding points) on
CPU tensors. There is no fallback between the two. Each launch adds one to
:data:`LAUNCHES`. Forward only.
"""

from __future__ import annotations

import torch

from mfcnet_tpu_torch.experimental.conv3x3 import (
    DTYPES,
    aligned,
    check_conv_args,
    conv_nhwc_f32,
    raise_kernel_error,
    stage1_plan,
)
from mfcnet_tpu_torch.ops._build import (
    counted,
    kernel_lib,
    route,
    sm_count,
    stream_of,
)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = counted({"vgg_stage1": 0})


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def vgg_stage1_plain(x, k1, b1, k2, b2):
    """Plain version of :func:`vgg_stage1`."""
    y = torch.relu(conv_nhwc_f32(x, k1.to(x.dtype)) + b1.float())
    y = y.to(x.dtype)
    y = torch.relu(conv_nhwc_f32(y, k2.to(x.dtype)) + b2.float())
    return y.to(x.dtype).contiguous()


def vgg_stage1(x, k1, b1, k2, b2):
    """x (B, H, W, cin) float32 or bfloat16, k1 (3, 3, cin, C1), b1 (C1),
    k2 (3, 3, C1, C1), b2 (C1) -> (B, H, W, C1) in ``x``'s type."""
    check_conv_args("vgg_stage1", x, k1, b1)
    C1 = k1.shape[-1]
    check_conv_args("vgg_stage1", x, k2, b2, cin=C1)
    if k2.shape[-1] != C1:
        raise ValueError(f"vgg_stage1: k2 must be (3, 3, {C1}, {C1}), got "
                         f"{tuple(k2.shape)}")
    if route(x, k1, b1, k2, b2) == "cpu":
        return vgg_stage1_plain(x, k1, b1, k2, b2)
    B, H, W, cin = x.shape
    x = x.contiguous()
    k1 = k1.to(x.dtype).contiguous()
    k2 = aligned(k2.to(x.dtype))
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    out = torch.empty(B, H, W, C1, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = (stage1_plan(B, H, W, cin, C1, sm_count(x.device))
            if x.dtype == torch.bfloat16 else None)
    rc = kernel_lib().mfc_vgg_stage1(
        x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, H, W, cin, C1, DTYPES[x.dtype],
        None if plan is None else plan.ints(), stream_of(x))
    if rc == -1:
        raise ValueError(
            f"vgg_stage1: cin={cin}, C1={C1} need more shared memory than "
            "a block has (227 KB)")
    raise_kernel_error("vgg_stage1", rc, plan)
    LAUNCHES["vgg_stage1"] += 1
    return out
