"""The correlation kernel's launch plan and a model of its tensor-core route
on the CPU, pure torch (``csrc/correlation.cu`` runs only on the card).

* ``corr_plan``'s choices at UnFlow's shapes and its refusals, and its
  constants against the C side's;
* a model of the planned tiling -- blocks of (image, residue sub-grid, f1
  tile, run of f2 rows), the f2 columns each tile reaches, the epilogue's
  staging image and its runs of contiguous stores -- that must write every
  (b, y, x, dy_i, dx_i) exactly once, zeros outside the image, and agree
  with ``correlation_plain``, and whose pixel rows read are the plan's
  ``staged_rows``;
* a model of the float32 inputs' split TF32 ("3xTF32"): big = tf32(a) by
  bit arithmetic (round to nearest, ties away, as ``cvt.rna.tf32.f32``),
  small = a - big as the tensor core reads it (its low 13 bits dropped),
  the three products small*big + big*small + big*big, summed exactly, then
  the float32 product with 1/C, held to the exact function (and, at unit
  scale, to the plain version). It bounds the error the split adds; the
  card's own sums are float32 and its check in ``chip_smoke.py`` (and the
  CUDA-marked test of ``tests/test_torch_correlation.py``) is final.

Tolerance: atol 1e-5, rtol 1e-5, the JAX package's limit for its kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcnet_tpu_torch.ops import correlation as co

CORR_CU = (Path(co.__file__).resolve().parents[1] / "csrc"
           / "correlation.cu")

ATOL = RTOL = 1e-5


def _feats(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                  * np.float32(scale)) for _ in range(2))


@pytest.mark.parametrize("shape,dtype,want", [
    # UnFlow's tracker shape: 2 pairs at 256x320 -> 32x40 conv3 features;
    # residue sub-grids of 16x20, one tile of 3 rows x 20 a block, 4 f2 rows;
    # a small grid: a ring of four stages
    ((2, 32, 40, 256), "float32", ("tc", 3, 20, 4, 20, 10, 4, 288)),
    ((2, 32, 40, 256), "bfloat16", ("tc", 3, 20, 4, 20, 10, 4, 288)),
    # the offline CLI's: 4 pairs at 512x640 -> 64x80; sub-grids of 32x40
    # in two 20-column tiles whose windows reach 30 columns; three stages
    ((4, 64, 80, 256), "float32", ("tc", 3, 20, 3, 30, 12, 3, 2816)),
])
def test_corr_plan_at_unflow_shapes(shape, dtype, want):
    plan = co.corr_plan(*shape, 20, 2, dtype)
    assert tuple(plan)[:8] == want
    assert plan.ints()[0] == 1
    assert plan.ty * plan.l <= co.MROWS and plan.tz * plan.nq <= 8 * plan.nt
    assert plan.nt <= co.NT_MAX and plan.shared_bytes <= co.SMEM_MAX
    assert co.corr_plan(*shape, 20, 2, dtype) is plan  # cached


def test_plan_constants_are_the_c_sides():
    """The C side computes the plan itself and refuses any other, so a
    constant that differs between the two sides refuses every launch; this
    finds such a difference without a card."""
    src = CORR_CU.read_text()
    for name, value in (("MROWS", co.MROWS), ("NT_MAX", co.NT_MAX),
                        ("KW", co.KW), ("SMALL_GRID", co.SMALL_GRID),
                        ("SMEM_MAX", co.SMEM_MAX),
                        ("PLAN_INTS", len(co.CorrPlan._fields)),
                        ("ERR_PLAN", 20003)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value), name
    assert "constexpr int LDW = KW + 4;" in src and co.LDW == co.KW + 4
    # the ring depth and the shared bytes, as corr_plan chooses them
    assert "const int stages = grid <= SMALL_GRID ? 4 : 3;" in src
    assert ("const int ring = stages * (MROWS + 8 * NT) * LDW * 4;"
            in src)


@pytest.mark.parametrize("args", [
    (1, 9, 45, 7, 5, 3, "float32"),     # C % 8 != 0 (chip_smoke's odd case)
    (1, 9, 45, 12, 5, 3, "bfloat16"),
    (1, 8, 400, 16, 100, 1, "float32"),  # a window 201 columns wide
])
def test_corr_plan_takes_the_fma_route(args):
    plan = co.corr_plan(*args)
    assert plan.route == "fma" and plan.ints() == (0,) * 9


def test_corr_plan_refuses_bad_arguments():
    with pytest.raises(ValueError, match="dtype"):
        co.corr_plan(1, 8, 8, 8, 4, 2, "float16")
    with pytest.raises(ValueError, match="empty"):
        co.corr_plan(1, 0, 8, 8, 4, 2, "float32")
    with pytest.raises(ValueError, match="stride"):
        co.corr_plan(1, 8, 8, 8, 4, 0, "float32")


def _model_tc(f1, f2, md, s, plan, product=None):
    """The tensor-core route block by block: which f1 and f2 pixels a block
    stages, which products it keeps, where its epilogue stores. Returns
    (out, count of writes per output element, pixel rows read: the f1 and
    f2 pixels of working blocks that lie in the image). ``product(a, b)``: the
    block's (M, C) x (N, C) -> (M, N) products (exact float64 sums by
    default), before the float32 product with 1/C."""
    B, H, W, C = f1.shape
    R = md // s
    D = 2 * R + 1
    TY, L, TZ, NQ = plan.ty, plan.l, plan.tz, plan.nq
    hs, ws = -(-H // s), -(-W // s)
    nty, ntx, nz = -(-hs // TY), -(-ws // L), -(-(TY + 2 * R) // TZ)
    assert B * s * s * nty * ntx * nz == plan.grid
    assert TY * L <= co.MROWS and TZ * NQ <= 8 * plan.nt
    out = torch.full((B, H, W, D * D), float("nan"))
    count = torch.zeros(B, H, W, D * D, dtype=torch.int32)
    rows = 0
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32)
    if product is None:
        def product(a, b):
            return (a.double() @ b.double().T).float()
    m = torch.arange(TY * L)
    n = torch.arange(TZ * NQ)
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
                        mval = (ys < Hs) & (xs < Ws)
                        qx0 = max(0, x0 - R)
                        for iz in range(nz):
                            z0 = y0 - R + iz * TZ
                            stg = torch.zeros(TY * L, TZ, D)
                            if z0 + TZ > 0 and z0 < Hs:
                                zs, xq = z0 + n // NQ, qx0 + n % NQ
                                nval = (zs >= 0) & (zs < Hs) & (xq < Ws)
                                rows += int(mval.sum()) + int(nval.sum())
                                a = torch.zeros(TY * L, C)
                                a[mval] = f1[b, s * ys[mval] + ry,
                                             s * xs[mval] + rx]
                                bb = torch.zeros(TZ * NQ, C)
                                bb[nval] = f2[b, s * zs[nval] + ry,
                                              s * xq[nval] + rx]
                                prod = product(a, bb) * inv_c
                                dxi = xq[None, :] - xs[:, None] + R
                                keep = (mval[:, None] & nval[None, :]
                                        & (dxi >= 0) & (dxi < D))
                                mi, ni = torch.nonzero(keep, as_tuple=True)
                                stg[mi, n[ni] // NQ, dxi[mi, ni]] = \
                                    prod[mi, ni]
                            for k in torch.nonzero(mval)[:, 0].tolist():
                                dy0 = z0 - int(ys[k]) + R
                                lo, hi = max(0, -dy0), min(TZ, D - dy0)
                                if lo >= hi:
                                    continue
                                y = s * int(ys[k]) + ry
                                x = s * int(xs[k]) + rx
                                sl = slice((dy0 + lo) * D, (dy0 + hi) * D)
                                out[b, y, x, sl] = stg[k, lo:hi].reshape(-1)
                                count[b, y, x, sl] += 1
    return out, count, rows


@pytest.mark.parametrize("shape,md,s", [
    ((2, 32, 40, 8), 20, 2),   # UnFlow's tracker shape (fewer channels)
    ((1, 64, 80, 8), 20, 2),   # the offline CLI's sub-grids (one pair)
    ((1, 9, 45, 8), 5, 3),     # odd H, W; md no multiple of the stride
    ((2, 7, 13, 16), 3, 1),    # stride 1, a window larger than the image
    ((1, 5, 70, 8), 6, 2),     # wide rows: several x tiles, clipped reach
])
def test_tiling_model_writes_every_output_once(shape, md, s):
    f1, f2 = _feats(shape, 1)
    plan = co.corr_plan(*shape, md, s, "float32")
    assert plan.route == "tc"
    out, count, rows = _model_tc(f1, f2, md, s, plan)
    assert torch.equal(count, torch.ones_like(count))
    torch.testing.assert_close(out, co.correlation_plain(f1, f2, md, s),
                               atol=ATOL, rtol=RTOL)
    assert co.staged_rows(plan, *shape[:3], md, s) == rows


def _tf32(x):
    """float32 -> tf32 (10 explicit mantissa bits) rounded to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: by bit arithmetic."""
    u = x.view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncated(x):
    """float32 -> tf32 as the tensor core reads an operand: the low 13
    mantissa bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_products(a, b):
    """3xTF32 of (M, C) x (N, C) as the kernel computes it: big = tf32(a),
    small = a - big read as tf32 (truncated), small*big + big*small +
    big*big, each product exact, summed in float64."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _truncated(a - ab), _truncated(b - bb)
    d = torch.float64
    return (as_.to(d) @ bb.to(d).T + ab.to(d) @ bs.to(d).T
            + ab.to(d) @ bb.to(d).T).float()


def test_tf32_rounding_by_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-3, 1.0 + 2.0 ** -12])
    got = _tf32(x)
    # ties away from zero; everything below half a step rounds down
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                            -(1.0 + 2.0 ** -10), got[4].item(), 1.0]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[4].item() - 3.0e-3) <= 2.0 ** -11 * 3.0e-3


def _exact(a, b):
    return (a.double() @ b.double().T).float()


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_split_tf32_meets_the_tolerance(scale):
    """The split's model on UnFlow's tracker shape, C = 256, against the
    exact function (float64 sums, rounded once to float32, times 1/C):
    within (1e-5, 1e-5) on unit-scale features and on features 30x larger.
    At unit scale it also meets that tolerance against the plain version,
    and big*big alone (plain TF32) does not. At 30x the plain version's own
    float32 sums miss the exact value by more than the tolerance on a few
    outputs near zero (asserted below), so there the exact value is the
    yardstick."""
    f1, f2 = _feats((1, 16, 20, 256), 2, scale)
    plan = co.corr_plan(1, 16, 20, 256, 20, 2, "float32")
    plain = co.correlation_plain(f1, f2, 20, 2)
    exact = _model_tc(f1, f2, 20, 2, plan, _exact)[0]
    got, count, _ = _model_tc(f1, f2, 20, 2, plan, _split_products)
    assert torch.equal(count, torch.ones_like(count))
    torch.testing.assert_close(got, exact, atol=ATOL, rtol=RTOL)
    if scale == 1.0:
        torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)
        big = _model_tc(f1, f2, 20, 2, plan,
                        lambda a, b: _exact(_tf32(a), _tf32(b)))[0]
        assert not torch.allclose(big, plain, atol=ATOL, rtol=RTOL)
    else:
        assert not torch.allclose(plain, exact, atol=ATOL, rtol=RTOL)
