"""Roundings for the control: the reference computed one precision below
the one a configuration states, which ``correct`` has to fail.

bfloat16 -> float8 (e4m3) with one scale per tensor, the usual fp8
inference recipe; float32 -> bfloat16. Each rounds a convolution's operands
and output (``reference/models.py::conv``); the sums stay float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(x):
    """Round to float8 e4m3 after scaling the tensor's largest magnitude to
    the format's largest, and scale back."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


def bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


#: the control's rounding for each stated dtype
BELOW = {"bfloat16": fp8_e4m3, "float32": bf16}
