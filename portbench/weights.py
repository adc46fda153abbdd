"""Seeded weights, made on the device in one draw.

A module built on the ``meta`` device gives the names and shapes; every
convolution and linear weight is drawn uniform in +-1/sqrt(fan in) (PyTorch's
default scheme, fan in = input channels per group x kernel taps; for a
transposed convolution its weight's second axis), each such bias likewise by
its weight's fan in; norm weights are 1 and biases 0, running means 0 and
variances 1. The values are rounded to the type the engine serves them in,
so the program and the reference compute with the same numbers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_NORMS = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm, nn.InstanceNorm2d)
_LINEAR = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _plan(module: nn.Module, prefix: str):
    """[(name, shape, lo, hi)] of every parameter and floating buffer, each
    once (aliased modules are listed under their first name)."""
    out, seen = [], set()
    for mname, mod in module.named_modules():
        for pname, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if id(t) in seen:
                continue
            seen.add(id(t))
            name = f"{prefix}{mname}.{pname}" if mname else prefix + pname
            lo = hi = 0.0
            if isinstance(mod, _LINEAR) and pname in ("weight", "bias"):
                w = mod.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                hi = 1.0 / math.sqrt(fan_in)
                lo = -hi
            elif pname in ("weight", "running_var") and isinstance(mod,
                                                                   _NORMS):
                lo = hi = 1.0
            out.append((name, tuple(t.shape), t.dtype, lo, hi))
    return out


def seeded_weights(modules, seed: int, device, served=torch.bfloat16):
    """{name: float32 tensor} for the (prefix, meta module) pairs
    ``modules``, from one uniform draw of a generator on ``device`` seeded
    with ``seed``, rounded to ``served``. Integer buffers (BN's batch count)
    are zeros."""
    plan = [item for prefix, mod in modules for item in _plan(mod, prefix)]
    floats = [p for p in plan if p[2].is_floating_point]
    sizes = torch.tensor([math.prod(p[1]) for p in floats], device=device)
    lo = torch.tensor([p[3] for p in floats], device=device)
    hi = torch.tensor([p[4] for p in floats], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    u = torch.rand(int(sizes.sum()), generator=gen, device=device)
    flat = (torch.repeat_interleave(lo, sizes)
            + u * torch.repeat_interleave(hi - lo, sizes))
    flat = flat.to(served).float()
    out = dict(zip([p[0] for p in floats],
                   (v.view(p[1]) for v, p in zip(
                       flat.split(sizes.tolist()), floats))))
    for name, shape, dtype, _, _ in plan:
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def load_into(module: nn.Module, weights, prefix: str, device):
    """Materialize a meta ``module`` on ``device`` holding ``weights``."""
    module.to_empty(device=device)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            t.copy_(weights[prefix + name])
    return module
