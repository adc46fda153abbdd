"""The correlation backward's launch plan and a model of its tensor-core
route on the CPU, pure torch (``csrc/correlation.cu`` runs only on the card).

* ``corr_bwd_plan``'s choices at UnFlow's shapes, the fma route where
  C % 8 != 0, its refusals, and its constants against the C side's;
* a model of the planned tiling -- blocks of (gradient, image, residue
  sub-grid, tile of output pixels, channel chunk), the in-image operand
  pixels the tile's windows reach, the weights scattered into a P x K
  matrix (grad_f1: ``g`` of the output pixel; grad_f2: ``g`` of the source
  pixel at the mirrored displacement), the chunks of BKC operand pixels,
  and the epilogue's stores -- that must write every (pixel, channel) of
  both gradients exactly once and agree with
  ``correlation_backward_plain``;
* the numerics by bits: float32 inputs in 3xTF32 (both operands split into
  a tf32 big part, rounded to nearest with ties away as the kernel's bit
  arithmetic does, and a small part that the tensor core truncates to
  tf32), bfloat16 inputs with the operand exact and ``g`` split into
  three bfloat16 terms (exactly g); products summed exactly, then the
  float32 product with 1/C. Each stays within ``BWD_TOL`` of the plain
  version (chip_smoke.py's limits) at C = 256, md = 20, s = 2, the bfloat16
  route's float32 sums within 1e-6 of the plain version's; one TF32 term,
  or one or two bfloat16 terms of g, do not.

The card's own sums are float32; its check in ``chip_smoke.py`` (and the
CUDA-marked test of ``tests/test_torch_corr_bwd.py``) is final.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcnet_tpu_torch.ops import correlation as co

from torch_threads import _two_torch_threads  # noqa: F401

CORR_CU = (Path(co.__file__).resolve().parents[1] / "csrc"
           / "correlation.cu")

#: chip_smoke.py's BWD_TOL: max |diff| over the plain result's largest
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8 + 1e-5}


def _inputs(shape, md, s, seed):
    rng = np.random.default_rng(seed)
    D = 2 * (md // s) + 1
    return tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                 for sh in (shape, shape, (*shape[:3], D * D)))


@pytest.mark.parametrize("shape,dtype,want", [
    # UnFlow's tracker shape: sub-grids of 16 x 20, tiles of 3 x 20 pixels
    # (six a sub-grid), two chunks of 128 channels: 96 blocks a gradient
    ((2, 32, 40, 256), "float32", ("tc", 3, 20, 128, 3, 96, 79872)),
    ((2, 32, 40, 256), "bfloat16", ("tc", 3, 20, 128, 3, 96, 56832)),
    # the offline CLI's: sub-grids of 32 x 40 in two 20-column tiles
    ((4, 64, 80, 256), "float32", ("tc", 3, 20, 128, 3, 704, 79872)),
    ((4, 64, 80, 256), "bfloat16", ("tc", 3, 20, 128, 3, 704, 56832)),
])
def test_corr_bwd_plan_at_unflow_shapes(shape, dtype, want):
    plan = co.corr_bwd_plan(*shape, 20, 2, dtype)
    assert tuple(plan) == want
    assert plan.ints()[0] == 1
    assert plan.ty * plan.l <= co.BMROWS
    assert co.corr_bwd_plan(*shape, 20, 2, dtype) is plan  # cached


@pytest.mark.parametrize("args", [
    (1, 9, 45, 7, 5, 3, "float32"),      # chip_smoke's fma case
    (1, 9, 45, 7, 5, 3, "bfloat16"),
    (2, 11, 13, 70, 4, 1, "float32"),    # C % 8 == 6
    (2, 32, 40, 255, 20, 2, "float32"),  # UnFlow's shape, one channel less
])
def test_corr_bwd_plan_takes_the_fma_route(args):
    plan = co.corr_bwd_plan(*args)
    assert plan.route == "fma" and plan.ints() == (0,) * 7


def test_corr_bwd_plan_refuses_bad_arguments():
    with pytest.raises(ValueError, match="dtype"):
        co.corr_bwd_plan(1, 8, 8, 8, 4, 2, "float16")
    with pytest.raises(ValueError, match="empty"):
        co.corr_bwd_plan(1, 8, 0, 8, 4, 2, "float32")
    with pytest.raises(ValueError, match="stride"):
        co.corr_bwd_plan(1, 8, 8, 8, 4, 0, "float32")


def test_bwd_plan_constants_are_the_c_sides():
    """The C side computes the plan itself and refuses any other: a
    constant that differs between the two sides refuses every launch."""
    src = CORR_CU.read_text()
    for name, value in (("BMROWS", co.BMROWS), ("BKC", co.BKC),
                        ("BTC_CC", co.BTC_CC), ("BSTAGES", co.BSTAGES),
                        ("BWD_TERMS", co.BWD_TERMS),
                        ("BWD_PLAN_INTS", len(co.CorrBwdPlan._fields)),
                        ("ERR_PLAN", 20003)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value), name
    assert "constexpr int BLDX = BTC_CC + 8;" in src
    assert co.BLDX == co.BTC_CC + 8
    assert "constexpr int GLD1 = BKC + 4, GLD2 = BMROWS + 8;" in src
    assert "constexpr int GLH1 = BKC + 8, GLH2 = BMROWS + 8;" in src
    assert (co.GLD1, co.GLD2, co.GLH1, co.GLH2) == (
        co.BKC + 4, co.BMROWS + 8, co.BKC + 8, co.BMROWS + 8)
    # the choices, as corr_bwd_plan makes them
    for line in ("if (C % 8 != 0) return p;",
                 "const int L = (Ws + xt - 1) / xt;",
                 "const int TY = std::min(std::max(1, BMROWS / L), Hs);",
                 "if (2 * grid > INT_MAX) return p;",
                 "BSTAGES * BKC * BLDX * esize + bwd_gbufs(dtype == 0) * "
                 "gwords * 4;",
                 "constexpr int bwd_gbufs(bool f32) { return f32 ? BSTAGES "
                 ": 2; }"):
        assert line in src, line
    # the weights' two layouts share one buffer; fragment loads hit 32
    # banks: f32 rows of 4 or 8 words mod 32, bf16 ldmatrix rows of 16
    # bytes mod 128 (an odd multiple)
    assert co.BMROWS * co.GLD1 == co.BKC * co.GLD2
    assert co.GLD1 % 32 == 4 and co.GLD2 % 32 == 8 and co.BLDX % 32 == 8
    for halves in (co.GLH1, co.GLH2, co.BLDX):
        assert (2 * halves) % 128 in (16, 48, 80, 112)


def _tf32(x):
    """float32 -> tf32 rounded to nearest, ties away from zero (the
    kernel's ``(w + 0x1000) & 0xffffe000``)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncated(x):
    """float32 -> tf32 as the tensor core reads an operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _exact(a, b):
    return (a.double() @ b.double()).float()


def _split_tf32(a, b):
    """3xTF32 of (M, K) x (K, N): small.big + big.small + big.big, each
    product exact, summed exactly."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _truncated(a - ab), _truncated(b - bb)
    d = torch.float64
    return (as_.to(d) @ bb.to(d) + ab.to(d) @ bs.to(d)
            + ab.to(d) @ bb.to(d)).float()


def _bf16_terms(a, n):
    """a as the sum of n bfloat16 terms, each the rest rounded to
    nearest, as the kernel splits g."""
    terms, rest = [], a
    for _ in range(n):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def _split_bf16(a, b, n=3):
    """The bfloat16 route: the weights a as n bfloat16 terms, times the
    operand b (bfloat16 values), products exact, summed exactly."""
    w = sum(t.double() for t in _bf16_terms(a, n))
    return (w @ b.double()).float()


def _model_bwd(g, f1, f2, md, s, plan, product=_exact, needs=(True, True)):
    """The tensor-core route block by block: which weights a block
    scatters into its P x K matrix, which operand pixels it stages in
    chunks of BKC, and where its epilogue stores. Returns ((grad_f1,
    grad_f2) as float32 before the cast to the inputs' type, the count of
    writes of each (gradient, b, y, x, c))."""
    B, H, W, C = f1.shape
    R = md // s
    D = 2 * R + 1
    TY, L, CC = plan.ty, plan.l, plan.cc
    hs, ws = -(-H // s), -(-W // s)
    nty, ntx, ncc = -(-hs // TY), -(-ws // L), -(-C // CC)
    assert B * s * s * nty * ntx * ncc == plan.grid
    outs = torch.full((2, B, H, W, C), float("nan"))
    count = torch.zeros(2, B, H, W, C, dtype=torch.int32)
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32)
    m = torch.arange(co.BMROWS)
    for grad in (0, 1):
        if not needs[grad]:
            continue
        X = f2 if grad == 0 else f1
        for b in range(B):
            for ry in range(s):
                for rx in range(s):
                    Hs, Ws = -(-(H - ry) // s), -(-(W - rx) // s)
                    for ty in range(nty):
                        for tx in range(ntx):
                            y0, x0 = ty * TY, tx * L
                            if y0 >= Hs or x0 >= Ws:
                                continue
                            ys, xs = y0 + m // L, x0 + m % L
                            mval = (m < TY * L) & (ys < Hs) & (xs < Ws)
                            zlo, zhi = max(0, y0 - R), min(Hs, y0 + TY + R)
                            qx0 = max(0, x0 - R)
                            ncols = min(Ws, x0 + L + R) - qx0
                            K = (zhi - zlo) * ncols
                            nk = -(-K // co.BKC)
                            k = torch.arange(nk * co.BKC)  # chunks, padded
                            kval = k < K
                            zs, xq = zlo + k // ncols, qx0 + k % ncols
                            di = zs[None] - ys[:, None] + R
                            dj = xq[None] - xs[:, None] + R
                            keep = (mval[:, None] & kval[None] & (di >= 0)
                                    & (di < D) & (dj >= 0) & (dj < D))
                            G = torch.zeros(co.BMROWS, nk * co.BKC)
                            mi, ki = torch.nonzero(keep, as_tuple=True)
                            if grad == 0:  # g of the output pixel
                                G[mi, ki] = g[b, s * ys[mi] + ry,
                                              s * xs[mi] + rx,
                                              di[mi, ki] * D + dj[mi, ki]]
                            else:  # g of the source pixel, mirrored
                                G[mi, ki] = g[b, s * zs[ki] + ry,
                                              s * xq[ki] + rx,
                                              (2 * R - di[mi, ki]) * D
                                              + 2 * R - dj[mi, ki]]
                            for cc in range(ncc):
                                c0 = cc * CC
                                c1 = min(C, c0 + CC)
                                Xs = torch.zeros(nk * co.BKC, CC)
                                Xs[:K, :c1 - c0] = X[
                                    b, s * zs[:K] + ry, s * xq[:K] + rx,
                                    c0:c1]
                                prod = product(G, Xs) * inv_c
                                yy = s * ys[mval] + ry
                                xx = s * xs[mval] + rx
                                outs[grad, b, yy, xx, c0:c1] = \
                                    prod[mval, :c1 - c0]
                                count[grad, b, yy, xx, c0:c1] += 1
    return (outs[0], outs[1]), count


@pytest.mark.parametrize("shape,md,s", [
    ((2, 32, 40, 8), 20, 2),    # UnFlow's tracker shape (fewer channels)
    ((1, 64, 80, 8), 20, 2),    # the offline CLI's sub-grids (one pair)
    ((1, 9, 45, 8), 5, 3),      # odd H, W; md no multiple of the stride
    ((2, 7, 13, 16), 3, 1),     # stride 1, a window larger than the image
    ((1, 5, 70, 136), 6, 2),    # several x tiles; two channel chunks, the
                                # second of 8 channels
])
def test_tiling_model_writes_every_output_once(shape, md, s):
    f1, f2, g = _inputs(shape, md, s, 1)
    plan = co.corr_bwd_plan(*shape, md, s, "float32")
    assert plan.route == "tc"
    (m1, m2), count = _model_bwd(g, f1, f2, md, s, plan)
    assert torch.equal(count, torch.ones_like(count))
    p1, p2 = co.correlation_backward_plain(g, f1, f2, md, s)
    torch.testing.assert_close(m1, p1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m2, p2, atol=1e-5, rtol=1e-5)
    # one gradient alone: the blocks of the other are not launched
    (o1, _), c1 = _model_bwd(g, f1, f2, md, s, plan, needs=(True, False))
    assert torch.equal(o1, m1) and int(c1[1].sum()) == 0


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_split_tf32_meets_the_tolerance():
    """float32 inputs at C = 256, md = 20, s = 2: 3xTF32 within BWD_TOL of
    the plain version for both gradients; one TF32 product (big.big) is
    not."""
    shape = (1, 16, 20, 256)
    f1, f2, g = _inputs(shape, 20, 2, 2)
    plan = co.corr_bwd_plan(*shape, 20, 2, "float32")
    plain = co.correlation_backward_plain(g, f1, f2, 20, 2)
    got, count = _model_bwd(g, f1, f2, 20, 2, plan, _split_tf32)
    assert torch.equal(count, torch.ones_like(count))
    one, _ = _model_bwd(g, f1, f2, 20, 2, plan,
                        lambda a, b: _exact(_tf32(a), _tf32(b)))
    for k, o, p in zip(got, one, plain):
        assert _rel(k, p) <= BWD_TOL["float32"] / 10
        assert _rel(o, p) > BWD_TOL["float32"]


def test_three_term_bf16_split_of_g_meets_the_tolerance():
    """bfloat16 inputs at C = 256, md = 20, s = 2: with g as three bfloat16
    terms (exactly g) the float32 results stay within 1e-6 of the largest
    of the plain version's (before the cast to bfloat16); two terms (2^-16
    of g left out: ~3e-6, which flipped bfloat16 roundings of the largest
    outputs on the card) and one do not; the cast results within
    BWD_TOL["bfloat16"]."""
    shape = (1, 16, 20, 256)
    f1, f2, g = _inputs(shape, 20, 2, 3)
    b1, b2 = f1.bfloat16(), f2.bfloat16()
    plan = co.corr_bwd_plan(*shape, 20, 2, "bfloat16")
    assert plan.route == "tc"
    terms = _bf16_terms(g, 3)
    assert torch.equal(terms[0] + terms[1] + terms[2], g)
    wide = co.correlation_backward_plain(g, b1.float(), b2.float(), 20, 2)
    cast = co.correlation_backward_plain(g, b1, b2, 20, 2)
    got, _ = _model_bwd(g, b1.float(), b2.float(), 20, 2, plan, _split_bf16)
    fewer = [_model_bwd(g, b1.float(), b2.float(), 20, 2, plan,
                        lambda a, b, n=n: _split_bf16(a, b, n))[0]
             for n in (1, 2)]
    for i, (k, w, c) in enumerate(zip(got, wide, cast)):
        assert _rel(k, w) <= 1e-6
        assert all(_rel(f[i], w) > 1e-6 for f in fewer)
        assert c.dtype == torch.bfloat16
        assert _rel(k.bfloat16().float(), c.float()) <= BWD_TOL["bfloat16"]
