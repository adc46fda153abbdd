"""The sampler's backward (B3): the gradients of the port's
``grid_sample_bilinear`` (both padding modes, both ``align_corners``) and
``backward_warp`` (UnFlow's warp) on the CPU, where the autograd Functions
run ``sample_backward_plain``, against ``jax.vjp`` of the JAX package's
``grid_sample_bilinear`` and ``models/unflow.py::backward_warp`` (XLA's
autodiff): grids and flows that send samples past every edge, coordinates
exactly on the border clamp's limits, where JAX's ``clip`` gives half the
gradient, and exactly on integers, where JAX's floor form takes the taps at
floor + 1 and floor; ``gradcheck`` in float64 away from those kinks; the
gradient's memory format and type. The CUDA case holds both kernels to
their plain versions on the card.

Tolerances: 1e-5 on grid and image gradients (the same float32 weights and
differences; sums over channels and over the samples that reach a tap in
another order; grid gradients of up to ~60). ``backward_warp``: 1e-4 on
the flow gradient and 5e-5 on the image's (``torch.linspace`` and
``jnp.linspace`` round the base grid one float32 step apart, ~1e-6 px,
which moves the blend weights of each tap by as much). A bfloat16 flow's
gradient: one bfloat16 rounding (2^-8 of its largest). On the card: max
|diff| over the plain gradient's largest magnitude, 1e-5 (float32 atomics
add in a run-dependent order), one bfloat16 step more for bfloat16
images."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _exact_grid(n, align_corners):
    """Normalized values whose absolute coordinate is exactly 0, 1, ...,
    for an axis of ``n`` pixels (n - 1 or n a power of two), and that
    coordinate, in the JAX code's float32 operations."""
    k = np.arange(-3, n + 3, dtype=np.float32)
    if align_corners:
        g = k * np.float32(2.0 / (n - 1)) - np.float32(1.0)
        f = (g + np.float32(1.0)) * np.float32(0.5) * np.float32(n - 1)
    else:
        g = (np.float32(2.0) * k + np.float32(1.0)) / np.float32(n) \
            - np.float32(1.0)
        f = ((g + np.float32(1.0)) * np.float32(n) - np.float32(1.0)) \
            * np.float32(0.5)
    return g, f


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_backward_matches_jax(align_corners, padding_mode):
    import jax

    from mfcnet_tpu.ops.warp import grid_sample_bilinear as jgs
    from mfcnet_tpu_torch.ops.warp import grid_sample_bilinear

    # H - 1, W - 1 (align_corners) or H, W powers of two: exact integers
    H, W = (9, 17) if align_corners else (8, 16)
    rng = np.random.default_rng(21)
    B, C, Ho, Wo = 2, 3, 10, 14
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    gx = rng.uniform(-1.4, 1.4, (B, Ho, Wo)).astype(np.float32)
    gy = rng.uniform(-1.4, 1.4, (B, Ho, Wo)).astype(np.float32)
    ex, fx = _exact_grid(W, align_corners)
    ey, fy = _exact_grid(H, align_corners)
    assert np.array_equal(fx, np.arange(-3, W + 3)) and fx[3] == 0
    assert np.array_equal(fy, np.arange(-3, H + 3)) and fy[H + 2] == H - 1
    # rows of integer x (limits and beyond included) at a fractional and an
    # integer y, columns of integer y at a fractional x, and both integer
    gx[0, 0, :] = ex[:Wo]
    gx[0, 1, :] = ex[-Wo:]
    gx[0, 2, :] = ex[-Wo:]
    gy[0, 2, :] = ey[3]
    gy[1, :, 0] = ey[:Ho]
    gy[1, :, 1] = ey[-Ho:]
    gx[1, :, 1] = ex[W + 2]
    g = rng.standard_normal((B, Ho, Wo, C)).astype(np.float32)
    want = jax.jit(lambda a, x, y, ct: jax.vjp(
        lambda p, q, r: jgs(p, q, r, align_corners, padding_mode),
        a, x, y)[1](ct))(img, gx, gy, g)
    a = _nchw(img).requires_grad_()
    x = torch.from_numpy(gx).requires_grad_()
    y = torch.from_numpy(gy).requires_grad_()
    grid_sample_bilinear(a, x, y, align_corners, padding_mode).backward(
        _nchw(g))
    np.testing.assert_allclose(_nhwc(a.grad), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for got, w in ((x.grad, want[1]), (y.grad, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_border_clamp_limits_give_jax_half_gradient():
    """At a coordinate exactly on the border clamp's limits the coordinate
    gradient is half the one-sided difference (JAX's clip), 0 beyond; not
    torch's grid_sampler_2d_backward, which gives 0 at the limits."""
    from mfcnet_tpu_torch.ops.warp import sample_backward

    img = torch.arange(20, dtype=torch.float32).view(1, 1, 4, 5) ** 1.5
    fx = torch.tensor([[[0.0, 4.0, -1.0, 5.0, 2.5]]])
    fy = torch.ones_like(fx)
    _, gfx, _ = sample_backward(torch.ones(1, 1, 1, 5), img, fx, fy,
                                "border")
    row = img[0, 0, 1]
    want = torch.stack([0.5 * (row[1] - row[0]), 0.5 * -row[4],
                        torch.tensor(0.0), torch.tensor(0.0),
                        row[3] - row[2]])
    torch.testing.assert_close(gfx[0, 0], want, rtol=0, atol=1e-6)


def _flows(B, H, W, rng):
    """Flows in pixels that push each image's samples past another edge
    (left, right, top, bottom), a corner past both, and small ones."""
    flow = rng.normal(0, 3, (B, H, W, 2)).astype(np.float32)
    push = 2.0
    flow[0, :, :, 0] -= push * W
    flow[1, :, :, 0] += push * W
    flow[2, :, :, 1] -= push * H
    flow[3, :, :, 1] += push * H
    flow[0, :3, :3] -= 2.0 * max(H, W)
    return flow


@pytest.mark.parametrize("channels_last", [False, True])
def test_backward_warp_backward_matches_jax(channels_last):
    import jax

    from mfcnet_tpu.models.unflow import backward_warp as jbw
    from mfcnet_tpu_torch.ops.warp import backward_warp

    rng = np.random.default_rng(22)
    B, H, W, C = 5, 12, 16, 3
    img = rng.random((B, H, W, C), np.float32)
    flow = _flows(B, H, W, rng)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    want_i, want_f = jax.jit(lambda a, f, ct: jax.vjp(jbw, a, f)[1](ct))(
        img, flow, g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    a = _nchw(img).contiguous(memory_format=fmt).requires_grad_()
    f = _nchw(flow).contiguous(memory_format=fmt).requires_grad_()
    backward_warp(a, f).backward(_nchw(g))
    assert a.grad.is_contiguous(memory_format=fmt)
    np.testing.assert_allclose(_nhwc(a.grad), np.asarray(want_i), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(_nhwc(f.grad), np.asarray(want_f), rtol=0,
                               atol=1e-4)
    # the first image's samples all lie left of the image: clamped to its
    # edge, their x gradient is 0; most of the last image's stay inside
    assert np.abs(np.asarray(want_f)[0, :, :, 0]).max() == 0
    assert (np.asarray(want_f)[B - 1, :, :, 0] != 0).mean() > 0.5


def test_backward_warp_bf16_flow_gets_a_bf16_gradient():
    """A bfloat16 flow's gradient is the float32 one (of the same values)
    rounded once; the image's stays in its type."""
    from mfcnet_tpu_torch.ops.warp import backward_warp

    rng = np.random.default_rng(23)
    img = _nchw(rng.random((4, 12, 16, 3), np.float32))
    flow = _nchw(_flows(4, 12, 16, rng)).bfloat16()
    g = torch.randn(4, 3, 12, 16, generator=torch.Generator().manual_seed(0))
    fb = flow.clone().requires_grad_()
    f32 = flow.float().requires_grad_()
    backward_warp(img, fb).backward(g)
    backward_warp(img, f32).backward(g)
    assert fb.grad.dtype == torch.bfloat16
    assert torch.equal(fb.grad, f32.grad.bfloat16())


@pytest.mark.parametrize("align_corners,padding_mode", [
    (True, "zeros"), (False, "border")])
def test_sampler_gradcheck_float64(align_corners, padding_mode):
    """gradcheck of both wrappers in float64 (the CPU route), random
    coordinates: none on an integer or a clamp limit."""
    from mfcnet_tpu_torch.ops.warp import backward_warp, grid_sample_bilinear

    gen = torch.Generator().manual_seed(7)
    img = torch.rand(1, 2, 5, 6, dtype=torch.float64, generator=gen)
    gx = torch.rand(1, 4, 3, dtype=torch.float64, generator=gen) * 2.4 - 1.2
    gy = torch.rand(1, 4, 3, dtype=torch.float64, generator=gen) * 2.4 - 1.2
    assert torch.autograd.gradcheck(
        lambda a, x, y: grid_sample_bilinear(a, x, y, align_corners,
                                             padding_mode),
        (img.requires_grad_(), gx.requires_grad_(), gy.requires_grad_()),
        eps=1e-6, atol=1e-5)
    flow = torch.randn(1, 2, 5, 6, dtype=torch.float64, generator=gen) * 2.3
    assert torch.autograd.gradcheck(
        lambda a, f: backward_warp(a, f, align_corners, padding_mode),
        (img, flow.requires_grad_()), eps=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_cuda_sampler_backward_matches_plain_version():
    """Both B3 kernels against their plain versions: flows past every edge,
    integer coordinates with the clamp limits, and a 40 px noise flow
    (whose tiles take the image entry's direct route at 4x3x64x96 with
    border padding), both padding modes, NCHW and channels_last, float32
    and bfloat16; one launch each; the
    image gradient in the image's type and memory format; the wrappers'
    gradients through the kernels (run with ``python -m pytest
    tests/test_torch_sample_bwd.py -m cuda --noconftest`` on a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.ops import warp

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    for B, C, H, W in ((4, 3, 64, 96), (4, 2, 37, 61)):
        flow = torch.from_numpy(np.moveaxis(_flows(B, H, W, rng), -1, 1)
                                ).contiguous().cuda()
        fx, fy = warp._abs_coords(*warp._warp_grid(flow), H, W, False, "zeros")
        nx, ny = warp._abs_coords(*warp._warp_grid(
            (torch.randn(B, 2, H, W, generator=gen) * 40).cuda()), H, W,
            False, "zeros")
        if C * H * W > warp.SAMPLE_BWD_CAP:  # no noise tile's box fits
            assert not bool(warp.sample_bwd_tiles(nx, ny, H, W, C,
                                                  "border")[1].any())
        ix = (torch.arange(W).view(1, 1, W) + torch.randint(
            -4, 5, (B, H, W), generator=gen)).clamp(-3, W + 2).float().cuda()
        iy = (torch.arange(H).view(1, H, 1) + torch.randint(
            -4, 5, (B, H, W), generator=gen)).clamp(-3, H + 2).float().cuda()
        for dt, tol in ((torch.float32, 1e-5),
                        (torch.bfloat16, 2.0 ** -8 + 1e-5)):
            for fmt in (torch.contiguous_format, torch.channels_last):
                img = torch.rand(B, C, H, W, generator=gen).cuda().to(
                    dt).contiguous(memory_format=fmt)
                g = torch.randn(B, C, H, W, generator=gen).cuda().to(dt)
                for cx, cy in ((fx, fy), (ix, iy), (nx, ny)):
                    for pm in ("zeros", "border"):
                        warp.reset_launches()
                        got = warp.sample_backward(g, img, cx, cy, pm)
                        assert warp.LAUNCHES["sample_bwd_img"] == 1
                        assert warp.LAUNCHES["sample_bwd_coords"] == 1
                        assert got[0].dtype == dt
                        assert got[0].is_contiguous(memory_format=fmt)
                        want = warp.sample_backward_plain(g, img, cx, cy, pm)
                        for k, p in zip(got, want):
                            err = (k.float() - p.float()).abs().max()
                            assert float(err) <= tol * float(
                                p.float().abs().max())
                im = img.clone().requires_grad_()
                fl = flow.clone().requires_grad_()
                warp.reset_launches()
                warp.backward_warp(im, fl).backward(g)
                assert warp.LAUNCHES["sample_bwd_img"] == 1
                assert warp.LAUNCHES["sample_bwd_coords"] == 1
                assert im.grad.dtype == dt and fl.grad.dtype == torch.float32
    torch.cuda.synchronize()
