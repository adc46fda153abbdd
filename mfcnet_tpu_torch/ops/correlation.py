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
:data:`LAUNCHES`. :func:`corr_plan` chooses the kernel's route by shape:

* ``"tc"`` (C a multiple of 8, a window at most 96 sub-grid pixels wide):
  the tensor cores. With stride s the volume splits into s * s residue
  sub-grids (y mod s, x mod s) at stride 1, and each output is an entry of
  a sub-grid's Gram matrix; a block multiplies a tile of f1 pixels with the
  f2 rows its windows reach by ``mma.sync``. bfloat16 inputs: one bf16
  product per 16 channels (exact products, float32 sums). float32 inputs:
  split TF32 ("3xTF32"): each operand is big + small, ``big = tf32(a)``
  and ``small = tf32(a - big)``, and the products small*big + big*small +
  big*big are summed in float32 (``tests/test_torch_corr_plan.py`` models
  the split's error).
* ``"fma"`` (any other shape): float32 multiply-adds, the first design.

The C side refuses a plan that is not :func:`corr_plan`'s for the shape:
the choice is made by shape and stated, never taken when a launch fails.

Layout: inputs and output are (B, H, W, channels), the JAX functions'
layout. The kernel wants the C values of a pixel contiguous (a dot product
over C per output), and the consumer is the ``combined`` 3x3 convolution
after a concatenation with ``redir`` (``models/unflow.py``), which runs in
``channels_last`` memory format: (B, H, W, 441) *is* the channels_last
storage of the (B, 441, H, W) tensor that convolution takes, so neither
side of the kernel needs a copy.

Types: inputs float32 or bfloat16, read as they are; float32 sums; float32
output. ``(1 / C)`` is a product with the rounded reciprocal, as in the TPU
kernel (``correlation_shifts`` takes a mean: one rounding apart). The sum
over C runs in another order in the kernel than in the plain version, so
the two agree to atol 1e-5, rtol 1e-5 (the JAX package's own limit for its
kernel) on both routes and both types, not bit for bit.

The backward (B2; the JAX package attaches ``jax.vjp`` of
``correlation_shifts`` to its kernel with ``jax.custom_vjp``): for the
upstream gradient ``g`` (B, H, W, D*D),

    grad_f1[b, y, x, c] = (1 / C) sum_d g[b, y, x, d] f2[b, y + dy, x + dx, c]
    grad_f2[b, y', x', c] = (1 / C) sum_d g[b, y' - dy, x' - dx, d]
                                          f1[b, y' - dy, x' - dx, c]

over in-image sources only. :func:`correlation_cost_volume` is a
``torch.autograd.Function`` where an input requires a gradient; its
backward is :func:`correlation_backward`, which launches ``csrc/
correlation.cu::mfc_correlation_bwd`` on CUDA tensors (one launch for both
gradients, adding one to ``LAUNCHES["correlation_bwd"]``) and runs
:func:`correlation_backward_plain`, the formula above written out (not
autograd of :func:`correlation_plain`), on CPU tensors. :func:`corr_bwd_plan`
chooses the kernel's route by shape, and the C side refuses any other plan:

* ``"tc"`` (C a multiple of 8): the tensor cores. On a residue sub-grid
  each gradient is a dense product over a tile: a block owns a tile P of
  up to 64 output pixels and 128 channels of one gradient, and walks the
  in-image operand pixels Q that the tile's windows reach (f2's for
  grad_f1, f1's for grad_f2) in chunks of 32: ``grad[P, c] += G[P, Q]
  X[Q, c]``, where ``G`` holds the weights ``g`` scattered into a P x Q
  matrix in shared memory (zeros outside each pixel's window; for grad_f2
  read from the source pixel at the mirrored displacement), by
  ``mma.sync``. float32 inputs: 3xTF32 on both operands, as in the
  forward. bfloat16 inputs: the operand exactly in bf16, ``g`` split into
  three bf16 terms ``hi + mid + lo`` (its 24 bits exactly), three bf16
  products. The tensor core's float32 sums truncate: each chunk's products
  are summed there from zero and added to the running sums by float32 adds
  that round to nearest. A bfloat16 output of the block's top binade whose
  float32 sum lies within a few float32 steps of a bf16 rounding midpoint
  is summed again in this module's plain order and arithmetic, so that it
  rounds as :func:`correlation_backward_plain` rounds it (another order
  would flip some of them by one bf16 step).
* ``"fma"`` (any other C): the first design, a block owning a tile of
  sub-grid pixels and 64 channels of one gradient and summing a row of
  operand pixels at a time with float32 multiply-adds.

On both routes every output has one owner block: no atomics, and the same
result from run to run. Each gradient is computed only where its input
requires one, summed in float32 and returned in its input's type; float64
inputs (the CPU route only: ``gradcheck``) run in float64 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.ops._build import counted, kernel_lib, route, stream_of

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = counted({"correlation": 0, "correlation_bwd": 0})

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: the tensor-core route's block: MROWS f1 pixels (four m16 tiles), at
#: most 8 * NT_MAX f2 pixels (n8 tiles), a ring of slices of KW 32-bit words
#: a pixel, rows padded to LDW words: four stages in a grid of at most
#: SMALL_GRID blocks, else three; SMEM_MAX bytes of shared memory a block
#: may have (H100). ``csrc/correlation.cu`` has the same.
MROWS, NT_MAX, KW, LDW, SMALL_GRID, SMEM_MAX = 64, 12, 32, 36, 1024, 232448
ROUTES = ("fma", "tc")
#: the backward's tensor-core route: blocks of BMROWS output pixels and
#: BTC_CC channels, operand pixels in chunks of BKC through a ring of BSTAGES
#: (float32: the weights too; bfloat16: two buffers of weights);
#: operand rows of BLDX values (BTC_CC + 8), weights in rows of GLD1 / GLD2
#: words (float32: grad_f1 [m][k], grad_f2 [k][m]) or GLH1 / GLH2 bfloat16
#: values. ``csrc/correlation.cu`` has the same.
BMROWS, BKC, BTC_CC, BSTAGES = 64, 32, 128, 3
BLDX = BTC_CC + 8
#: bfloat16 inputs: g as BWD_TERMS bfloat16 terms (24 bits: exact)
BWD_TERMS = 3
GLD1, GLD2, GLH1, GLH2 = BKC + 4, BMROWS + 8, BKC + 8, BMROWS + 8


class CorrPlan(NamedTuple):
    """The kernel's launch plan (see :func:`corr_plan`); its ints are what
    the C entry point takes, in this order."""
    route: str         # "tc" or "fma"
    ty: int            # rows of the f1 tile in a residue sub-grid
    l: int             # ... and its columns
    tz: int            # f2 rows a block takes
    nq: int            # f2 columns of a row that the tile's windows reach
    nt: int            # n8 tiles, even (two halves): 2 ceil(tz * nq / 16)
    stages: int        # cp.async ring stages
    grid: int          # blocks
    shared_bytes: int  # dynamic shared memory a block

    def ints(self):
        return (ROUTES.index(self.route),) + tuple(self)[1:]


def _needed_cols(ws: int, l: int, r: int) -> int:
    """The most f2 columns that one of the x tiles of width ``l`` reaches
    with radius ``r`` in a sub-grid row of ``ws`` pixels."""
    return max(min(ws, x0 + l + r) - max(0, x0 - r)
               for x0 in range(0, ws, l))


@functools.lru_cache(maxsize=None)
def corr_plan(B: int, H: int, W: int, C: int, max_displacement: int,
              stride: int, dtype: str) -> CorrPlan:
    """Launch plan of ``mfc_correlation`` for (B, H, W, C) inputs of
    ``dtype`` ("float32" or "bfloat16").

    Route "tc" where C is a multiple of 8 and a one-column tile's window
    reaches at most 8 * NT_MAX f2 columns of its residue sub-grid (Hs x Ws
    = ceil(H / s) x ceil(W / s)); else "fma" (all other fields 0). On the
    "tc" route a block owns a tile of ``ty`` x ``l`` f1 pixels of one
    sub-grid (at most MROWS: ``l`` near Ws / ceil(Ws / 24), ``ty`` as many
    rows as fit) and a run of ``tz`` f2 rows, counted from the tile's first
    row minus the radius R (so that every (pixel, dy) has one owner); of
    each row the ``nq`` columns its windows reach. ``tz`` is as large as
    8 * NT_MAX f2 pixels allow, and the shared-memory image of the tile's
    outputs (MROWS x tz x D floats). The C side computes the same plan and
    refuses any other."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"corr_plan: dtype must be float32 or bfloat16, "
                         f"got {dtype!r}")
    if min(B, H, W, C) < 1:
        raise ValueError(f"corr_plan: empty input {(B, H, W, C)}")
    s = stride
    R = displacements(max_displacement, s) // 2
    D = 2 * R + 1
    hs, ws = -(-H // s), -(-W // s)
    fma = CorrPlan("fma", 0, 0, 0, 0, 0, 0, 0, 0)
    if C % 8 or _needed_cols(ws, 1, R) > 8 * NT_MAX:
        return fma
    l = -(-ws // -(-ws // 24))
    while _needed_cols(ws, l, R) > 8 * NT_MAX:
        l -= 1
    ty = min(max(1, MROWS // l), hs)
    nq = _needed_cols(ws, l, R)
    tz = max(1, min(8 * NT_MAX // nq, ty + 2 * R))
    while tz > 1 and MROWS * tz * D * 4 > SMEM_MAX:
        tz -= 1
    if MROWS * tz * D * 4 > SMEM_MAX:
        return fma
    nt = 2 * -(-(tz * nq) // 16)
    grid = B * s * s * -(-hs // ty) * -(-ws // l) * -(-(ty + 2 * R) // tz)
    if grid >= 2 ** 31:
        return fma
    stages = 4 if grid <= SMALL_GRID else 3
    shared = max(stages * (MROWS + 8 * nt) * LDW * 4, MROWS * tz * D * 4)
    return CorrPlan("tc", ty, l, tz, nq, nt, stages, grid, shared)


class CorrBwdPlan(NamedTuple):
    """The backward kernel's launch plan (see :func:`corr_bwd_plan`); its
    ints are what the C entry point takes, in this order."""
    route: str         # "tc" or "fma"
    ty: int            # rows of the output tile in a residue sub-grid
    l: int             # ... and its columns
    cc: int            # channels a block
    stages: int        # cp.async ring stages of operand chunks
    grid: int          # blocks of one gradient
    shared_bytes: int  # dynamic shared memory a block

    def ints(self):
        return (ROUTES.index(self.route),) + tuple(self)[1:]


@functools.lru_cache(maxsize=None)
def corr_bwd_plan(B: int, H: int, W: int, C: int, max_displacement: int,
                  stride: int, dtype: str) -> CorrBwdPlan:
    """Launch plan of ``mfc_correlation_bwd`` for (B, H, W, C) inputs of
    ``dtype`` ("float32" or "bfloat16").

    Route "tc" where C is a multiple of 8 (16-byte operand pieces in both
    types), else "fma" (all other fields 0). On the "tc" route a block owns
    a tile of ``ty`` x ``l`` output pixels of one residue sub-grid (the
    forward's tile: ``l`` near Ws / ceil(Ws / 24), ``ty`` as many rows as
    BMROWS pixels allow) and ``cc`` channels of one gradient; ``grid``
    counts the blocks of one gradient (a launch of both has twice as many).
    The C side computes the same plan and refuses any other."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"corr_bwd_plan: dtype must be float32 or bfloat16, "
                         f"got {dtype!r}")
    if min(B, H, W, C) < 1:
        raise ValueError(f"corr_bwd_plan: empty input {(B, H, W, C)}")
    s = stride
    displacements(max_displacement, s)
    fma = CorrBwdPlan("fma", 0, 0, 0, 0, 0, 0)
    if C % 8:
        return fma
    hs, ws = -(-H // s), -(-W // s)
    l = -(-ws // -(-ws // 24))
    ty = min(max(1, BMROWS // l), hs)
    grid = B * s * s * -(-hs // ty) * -(-ws // l) * -(-C // BTC_CC)
    if 2 * grid > 2 ** 31 - 1:
        return fma
    if dtype == "float32":  # the weights in a ring beside the operand's
        shared = BSTAGES * BKC * BLDX * 4 + BSTAGES * BMROWS * GLD1 * 4
    else:
        terms = BWD_TERMS * (max(BMROWS * GLH1, BKC * GLH2) // 2)
        shared = BSTAGES * BKC * BLDX * 2 + 2 * terms * 4
    return CorrBwdPlan("tc", ty, l, BTC_CC, BSTAGES, grid, shared)


def staged_rows(plan: CorrPlan, B: int, H: int, W: int, max_displacement: int,
                stride: int) -> int:
    """Pixel rows (C channels each) that the blocks of a "tc" plan copy out
    of memory: each block's f1 and f2 pixels that lie in the image (the
    others are zero-filled, not read); blocks whose f2 rows all leave the
    image read none. The operand traffic of the route."""
    s, R = stride, max_displacement // stride
    TY, L, TZ, NQ = plan.ty, plan.l, plan.tz, plan.nq
    hs, ws = -(-H // s), -(-W // s)
    rows = 0
    for ry in range(s):
        for rx in range(s):
            Hs, Ws = -(-(H - ry) // s), -(-(W - rx) // s)
            for y0 in range(0, -(-hs // TY) * TY, TY):
                for x0 in range(0, -(-ws // L) * L, L):
                    if y0 >= Hs or x0 >= Ws:
                        continue
                    p = (min(Hs, y0 + TY) - y0) * (min(Ws, x0 + L) - x0)
                    qx0 = max(0, x0 - R)
                    q = min(Ws, qx0 + NQ) - qx0
                    for z0 in range(y0 - R, y0 + TY + R, TZ):
                        zin = min(Hs, z0 + TZ) - max(0, z0)
                        if zin > 0:
                            rows += p + zin * q
    return B * rows


@functools.lru_cache(maxsize=None)
def _plan_ints(plan):
    return (ctypes.c_int * len(plan))(*plan.ints())


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
    cpu64 = f1.dtype == torch.float64 and f1.device.type == "cpu"
    if (f1.dtype not in _DTYPES and not cpu64) or f2.dtype != f1.dtype:
        raise TypeError(f"f1, f2: expected both float32 or both bfloat16 "
                        f"(float64 on the CPU), got {f1.dtype} and {f2.dtype}")


def _wf(t):
    """The plain versions' working type: float32, or float64 for float64
    inputs (the CPU route only: ``gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _windows(md: int, s: int):
    """(channel, row offset, column offset) of each displacement in an
    f2 padded by ``md`` on each side, channels in order."""
    D = displacements(md, s)
    return [(dyi * D + dxi, md + (dyi - md // s) * s, md + (dxi - md // s) * s)
            for dyi in range(D) for dxi in range(D)]


def correlation_plain(f1, f2, max_displacement: int = 20, stride: int = 2):
    """Plain version of :func:`correlation_cost_volume`: one shifted
    product and one sum over C per displacement, any device."""
    B, H, W, C = f1.shape
    md = max_displacement
    a = f1.to(_wf(f1))
    b = F.pad(f2.to(_wf(f2)), (0, 0, md, md, md, md))
    inv_c = 1.0 / C
    outs = [(a * b[:, y0:y0 + H, x0:x0 + W]).sum(-1) * inv_c
            for _, y0, x0 in _windows(md, stride)]
    return torch.stack(outs, dim=-1)


def correlation_backward_plain(g, f1, f2, max_displacement: int = 20,
                               stride: int = 2, needs=(True, True)):
    """Plain version of :func:`correlation_backward`: the module
    docstring's two sums written out, one shifted product per displacement
    (dy-major), in float32 (float64 for float64 inputs), times 1 / C;
    ``(grad_f1, grad_f2)`` in the inputs' type, None where ``needs`` says
    no."""
    B, H, W, C = f1.shape
    md = max_displacement
    wt = _wf(f1)
    gw = g.to(wt)
    a = f1.to(wt)
    b = F.pad(f2.to(wt), (0, 0, md, md, md, md))
    g1 = torch.zeros_like(a) if needs[0] else None
    g2 = torch.zeros_like(b) if needs[1] else None
    for ch, y0, x0 in _windows(md, stride):
        gd = gw[..., ch:ch + 1]
        if g1 is not None:
            g1 = g1 + gd * b[:, y0:y0 + H, x0:x0 + W]
        if g2 is not None:
            g2[:, y0:y0 + H, x0:x0 + W] += gd * a
    inv_c = 1.0 / C
    return ((g1 * inv_c).to(f1.dtype) if g1 is not None else None,
            (g2[:, md:md + H, md:md + W] * inv_c).to(f2.dtype)
            if g2 is not None else None)


def correlation_backward(g, f1, f2, max_displacement: int = 20,
                         stride: int = 2, needs=(True, True)):
    """The gradients of :func:`correlation_cost_volume` for the upstream
    gradient ``g`` (B, H, W, D*D): ``(grad_f1, grad_f2)`` in the inputs'
    type, None where ``needs`` says no. On CUDA tensors one launch of
    ``mfc_correlation_bwd`` (both gradients) on :func:`corr_bwd_plan`'s
    route; on CPU tensors :func:`correlation_backward_plain`."""
    _check(f1, f2)
    if route(g, f1, f2) == "cpu":
        return correlation_backward_plain(g, f1, f2, max_displacement, stride,
                                          needs)
    B, H, W, C = f1.shape
    D = displacements(max_displacement, stride)
    if g.shape != (B, H, W, D * D):
        raise ValueError(f"g: expected {(B, H, W, D * D)}, "
                         f"got {tuple(g.shape)}")
    if max(f1.numel(), g.numel()) >= 2 ** 31:
        raise ValueError("correlation_backward: the kernel indexes pixels "
                         "with 32 bits")
    g = g.float().contiguous()
    # the tensor-core route copies 16-byte pieces of the operands
    f1, f2 = (t if t.data_ptr() % 16 == 0 else t.clone()
              for t in (f1.contiguous(), f2.contiguous()))
    outs = [torch.empty_like(f) if need else None
            for f, need in zip((f1, f2), needs)]
    if not any(needs) or f1.numel() == 0:
        return tuple(o.zero_() if o is not None else None for o in outs)
    plan = corr_bwd_plan(B, H, W, C, max_displacement, stride,
                         str(f1.dtype).split(".")[1])
    rc = kernel_lib().mfc_correlation_bwd(
        g.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        *(o.data_ptr() if o is not None else None for o in outs),
        B, H, W, C, max_displacement, stride, _DTYPES[f1.dtype],
        _plan_ints(plan), stream_of(f1))
    if rc == -1:
        raise ValueError(
            f"correlation_backward: max_displacement={max_displacement} "
            f"with stride={stride} needs more shared memory than a block has")
    if rc == 20003:
        raise RuntimeError(
            f"correlation_backward: the kernel refused the plan {plan}")
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel correlation_bwd failed: cudaError {rc}")
    LAUNCHES["correlation_bwd"] += 1
    return tuple(outs)


class _Correlation(torch.autograd.Function):
    """:func:`correlation_cost_volume` with its backward
    (:func:`correlation_backward`); each gradient only where its input
    requires one."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride):
        ctx.save_for_backward(f1, f2)
        ctx.md, ctx.stride = max_displacement, stride
        return _correlation_forward(f1, f2, max_displacement, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g1, g2 = correlation_backward(g, f1, f2, ctx.md, ctx.stride,
                                      tuple(ctx.needs_input_grad[:2]))
        return g1, g2, None, None


def correlation_cost_volume(f1, f2, max_displacement: int = 20,
                            stride: int = 2):
    """(B, H, W, C) x 2, float32 or bfloat16 -> (B, H, W, D*D) float32
    cost volume, channel ``dy_i * D + dx_i`` (see the module docstring).
    Differentiable in both inputs."""
    _check(f1, f2)
    displacements(max_displacement, stride)
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _Correlation.apply(f1, f2, max_displacement, stride)
    return _correlation_forward(f1, f2, max_displacement, stride)


def _correlation_forward(f1, f2, max_displacement, stride):
    if route(f1, f2) == "cpu":
        return correlation_plain(f1, f2, max_displacement, stride)
    return _correlation_cuda(f1, f2, max_displacement, stride)


def _correlation_cuda(f1, f2, max_displacement, stride):
    B, H, W, C = f1.shape
    D = displacements(max_displacement, stride)
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
    plan = corr_plan(B, H, W, C, max_displacement, stride,
                     str(f1.dtype).split(".")[1])
    rc = kernel_lib().mfc_correlation(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C,
        max_displacement, stride, _DTYPES[f1.dtype], _plan_ints(plan),
        stream_of(f1))
    if rc == -1:
        raise ValueError(
            f"correlation: C={C} with max_displacement={max_displacement} "
            "needs more shared memory than a block has (227 KB)")
    if rc == 20003:
        raise RuntimeError(f"correlation: the kernel refused the plan {plan}")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel correlation failed: cudaError {rc}")
    LAUNCHES["correlation"] += 1
    return out
