"""The port's resize, pair batching and flow warp against the JAX
package's, on the same numpy inputs, at float32 on the CPU (where the
warp's wrapper runs its plain version). The port's spatial layout is NCHW,
the JAX functions' NHWC: the tests transpose.

Tolerances: 1e-6 for resize of values in [0, 1) (the same float32
weights, two products in JAX against four taps in PyTorch), 2e-6 for the warp
(the same coordinates op for op; the four-tap blend is summed in another
order than the TPU tiers' one-hot products)."""

import numpy as np
import pytest
import torch

ATOL_WARP = 2e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((64, 48), (32, 24)), ((30, 40), (60, 80)), ((17, 23), (9, 31)),
    ((480, 640), (240, 320)),
])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    from mfcnet_tpu.ops.resize import resize_nearest as jresize
    from mfcnet_tpu_torch.ops.resize import resize_nearest

    x = np.random.default_rng(0).standard_normal(
        (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jresize(x, *out_hw))
    got = _nhwc(resize_nearest(_nchw(x), *out_hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 32), (64, 64)), ((30, 40), (60, 80)), ((17, 23), (40, 31)),
])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    from mfcnet_tpu.ops.resize import resize_bilinear as jresize
    from mfcnet_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(1).random((2, *in_hw, 2), np.float32)
    want = np.asarray(jresize(x, *out_hw, align_corners=align_corners))
    got = _nhwc(resize_bilinear(_nchw(x), *out_hw,
                                align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_repeat_for_pairs_matches_jax():
    from mfcnet_tpu.ops.pairs import repeat_for_pairs as jrep
    from mfcnet_tpu_torch.ops.pairs import repeat_for_pairs

    x = np.random.default_rng(2).standard_normal((3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        repeat_for_pairs(torch.from_numpy(x), 2).numpy(),
        np.asarray(jrep(x, 2)))


@pytest.fixture(scope="module")
def warp_case():
    """The inputs of the JAX package's own banded-warp test."""
    rng = np.random.default_rng(17)
    B, H, W, C = 2, 64, 48, 5
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    dx = rng.uniform(-9, 9, (B, H, W)).astype(np.float32)
    dy = rng.uniform(-5.5, 5.5, (B, H, W)).astype(np.float32)
    return img, dx, dy


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_bilinear_matches_jax(warp_case, align_corners,
                                          padding_mode):
    from mfcnet_tpu.ops.warp import grid_sample_bilinear as jgs
    from mfcnet_tpu_torch.ops.warp import grid_sample_bilinear

    img, _, _ = warp_case
    rng = np.random.default_rng(3)
    gx = rng.uniform(-1.3, 1.3, (2, 40, 56)).astype(np.float32)
    gy = rng.uniform(-1.3, 1.3, (2, 40, 56)).astype(np.float32)
    want = np.asarray(jgs(img, gx, gy, align_corners=align_corners,
                          padding_mode=padding_mode))
    got = _nhwc(grid_sample_bilinear(
        _nchw(img), torch.from_numpy(gx), torch.from_numpy(gy),
        align_corners=align_corners, padding_mode=padding_mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_WARP)


def _flows(warp_case):
    img, dx, dy = warp_case
    cases = {"bounded": np.stack([dx, dy], -1)}
    # most rows sample far below the image: zeros
    cases["out_of_image"] = np.stack([dx, dy + 3.0 * (64 - 1) / 2.0], -1)
    big = dy.copy()
    big[0, 30, 20] = 30.0  # beyond the TPU tier's +-24-row band
    big[1, 5, 7] = -40.0
    cases["beyond_band"] = np.stack([dx, big], -1)
    cases["zero"] = np.zeros_like(cases["bounded"])
    return cases


@pytest.mark.parametrize("grid_hw", [None, (576, 720)])
@pytest.mark.parametrize("case", ["bounded", "out_of_image", "beyond_band",
                                  "zero"])
def test_flow_warp_matches_jax_gather_and_pallas_tiers(warp_case, case,
                                                       grid_hw):
    """flow_warp (plain version on the CPU) == the JAX gather tier and ==
    the JAX banded tier, whose Pallas kernel runs in interpret mode (and
    whose guard hands 'beyond_band' to the gather tier)."""
    from mfcnet_tpu.ops.warp import flow_warp as jwarp
    from mfcnet_tpu_torch.ops.warp import flow_warp

    img = warp_case[0]
    flow = _flows(warp_case)[case].astype(np.float32)
    got = _nhwc(flow_warp(_nchw(img), _nchw(flow), grid_hw=grid_hw))
    gather = np.asarray(jwarp(img, flow, grid_hw=grid_hw, banded=False))
    banded = np.asarray(jwarp(img, flow, grid_hw=grid_hw, banded=True))
    np.testing.assert_allclose(got, gather, rtol=0, atol=ATOL_WARP)
    np.testing.assert_allclose(got, banded, rtol=0, atol=ATOL_WARP)
    if case == "zero" and grid_hw is not None:
        # the cropped 576x720 grid makes zero flow a non-identity sample
        assert np.abs(got - img).max() > 0.1
    if case == "zero" and grid_hw is None:
        # identity up to the float32 round trip j -> 2j/(W-1)-1 -> pixel
        np.testing.assert_allclose(got, img, rtol=0, atol=1e-4)


def test_flow_warp_bf16_envelope(warp_case):
    """bf16 maps: the port blends with float32 weights and rounds once
    (as the JAX gather tier does); the TPU kernel rounds its hat weights
    to bf16 first. Envelope: one bf16 ulp of the largest map value
    (2^-8 * 4.7 ~ 0.02) against the gather tier, three against the
    banded tier."""
    import jax.numpy as jnp

    from mfcnet_tpu.ops.warp import flow_warp as jwarp
    from mfcnet_tpu_torch.ops.warp import flow_warp

    img = warp_case[0]
    flow = _flows(warp_case)["bounded"].astype(np.float32)
    got = flow_warp(_nchw(img).bfloat16(), _nchw(flow), grid_hw=(576, 720))
    assert got.dtype == torch.bfloat16
    got = _nhwc(got.float())
    jimg = jnp.asarray(img, jnp.bfloat16)
    gather = np.asarray(jwarp(jimg, flow, grid_hw=(576, 720),
                              banded=False).astype(jnp.float32))
    banded = np.asarray(jwarp(jimg, flow, grid_hw=(576, 720),
                              banded=True).astype(jnp.float32))
    ulp = 2.0 ** -8 * np.abs(img).max()
    assert np.abs(got - gather).max() <= ulp
    assert np.abs(got - banded).max() <= 3 * ulp


def test_flow_warp_rejects_gradients_and_bad_shapes(warp_case):
    """flow_warp is differentiable (its gradient flows to maps and flow);
    grid_sample_bilinear still refuses a gradient; bad shapes and types
    raise."""
    from mfcnet_tpu_torch.ops.warp import flow_warp, grid_sample_bilinear

    maps = torch.rand(1, 5, 8, 8)
    flow = torch.zeros(1, 2, 8, 8)
    m = maps.clone().requires_grad_()
    f = flow.clone().requires_grad_()
    flow_warp(m, f).sum().backward()
    assert m.grad is not None and m.grad.shape == maps.shape
    assert f.grad is not None and f.grad.shape == flow.shape
    assert float(m.grad.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        grid_sample_bilinear(maps, flow[:, 0].clone().requires_grad_(),
                             flow[:, 1])
    with torch.no_grad():  # inference over parameters that require grad
        assert not flow_warp(maps.clone().requires_grad_(), flow).requires_grad
    with pytest.raises(ValueError, match="flow"):
        flow_warp(maps, torch.zeros(1, 8, 8, 2))
    with pytest.raises(ValueError, match="grid_hw"):
        flow_warp(maps, flow, grid_hw=(4, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flow_warp(maps.half(), flow)



@pytest.mark.parametrize("grid_hw", [None, (576, 720)])
@pytest.mark.parametrize("case", ["bounded", "out_of_image"])
def test_flow_warp_backward_matches_jax_vjp(warp_case, case, grid_hw):
    """B1's plain version (the autograd Function on CPU tensors) against
    jax.vjp of the JAX flow_warp, whose banded tier runs the Pallas kernel
    in interpret mode with its custom VJP: maps and flow gradients, float32
    at non-integer coordinates, 1e-5 (the chain of float32 sums; flow
    gradients of up to ~15)."""
    import jax

    from mfcnet_tpu.ops.warp import flow_warp as jwarp
    from mfcnet_tpu_torch.ops.warp import flow_warp

    img = warp_case[0]
    flow = _flows(warp_case)[case].astype(np.float32)
    g = np.random.default_rng(5).standard_normal(img.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jwarp(a, b, grid_hw=grid_hw, banded=True),
                     img, flow)
    want_maps, want_flow = vjp(g)
    m = _nchw(img).requires_grad_()
    f = _nchw(flow).requires_grad_()
    flow_warp(m, f, grid_hw=grid_hw).backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(m.grad), np.asarray(want_maps), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(f.grad), np.asarray(want_flow), rtol=0,
                               atol=1e-5)


def test_flow_warp_backward_at_integer_coordinates_matches_xla_kinks():
    """At integer coordinates the JAX VJP of the TPU kernel's hat weights
    (_banded_warp_reference) is v[k] + (v[k+1] - v[k-1]) / 2 along each
    axis (XLA: |.|'s derivative at 0 is +1, maximum's tie splits 0.5/0.5);
    the port's plain backward gives the same, 1e-5."""
    import jax

    from mfcnet_tpu.ops.warp_pallas import _banded_warp_reference
    from mfcnet_tpu_torch.ops.warp import sample_abs_backward_plain

    rng = np.random.default_rng(9)
    B, H, W, C = 2, 32, 24, 3
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    fx = (np.arange(W)[None, None, :] + rng.integers(-2, 3, (B, H, W))
          ).astype(np.float32)
    fy = (np.arange(H)[None, :, None] + rng.integers(-2, 3, (B, H, W))
          ).astype(np.float32)
    fx[0, :4] += 0.25  # some pixels between taps in x only
    bounds = tuple((b * 16 - 4, b * 16 + 20) for b in range(H // 16))
    _, vjp = jax.vjp(
        lambda a, x, y: _banded_warp_reference(a, x, y, bounds, 16),
        img, fx, fy)
    want = vjp(g)
    got = sample_abs_backward_plain(_nchw(g), _nchw(img),
                                    torch.from_numpy(fx),
                                    torch.from_numpy(fy))
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for k in (1, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("grid_hw,align_corners", [
    (None, True), ((10, 12), True), (None, False)])
def test_flow_warp_gradcheck_float64(grid_hw, align_corners):
    """torch.autograd.gradcheck of flow_warp in float64 (the CPU route),
    away from the kinks: random flows put no coordinate on an integer."""
    from mfcnet_tpu_torch.ops.warp import flow_warp

    g = torch.Generator().manual_seed(3)
    maps = torch.rand(1, 2, 6, 7, dtype=torch.float64, generator=g)
    flow = torch.randn(1, 2, 6, 7, dtype=torch.float64, generator=g) * 2.3
    assert torch.autograd.gradcheck(
        lambda m, f: flow_warp(m, f, grid_hw, align_corners),
        (maps.requires_grad_(), flow.requires_grad_()), eps=1e-6, atol=1e-5)


def _backward_warp_inputs(seed=23, B=2, C=3, H=24, W=40):
    rng = np.random.default_rng(seed)
    # values in [0, 1): torch blends the four taps in another float32
    # grouping, a few ulps of the value apart
    img = torch.from_numpy(rng.random((B, C, H, W), np.float32))
    flow = torch.from_numpy(rng.normal(0, 6, (B, 2, H, W)).astype(np.float32))
    return img, flow


def _linspace_grid(flow):
    B, _, H, W = flow.shape
    xs = torch.linspace(-1, 1, W).view(1, 1, W)
    ys = torch.linspace(-1, 1, H).view(1, H, 1)
    return (xs + flow[:, 0].float() / ((W - 1) / 2.0),
            ys + flow[:, 1].float() / ((H - 1) / 2.0))


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners,padding_mode", [
    (False, "border"), (False, "zeros"), (True, "border"), (True, "zeros")])
def test_backward_warp_equals_plain_composition(channels_last, flow_dtype,
                                                align_corners, padding_mode):
    """The one-launch backward warp's wrapper on CPU tensors: bit for bit
    ``grid_sample_bilinear_plain`` on the linspace grid, within 2e-6 of
    ``F.grid_sample`` at float32, for NCHW and ``channels_last`` inputs and
    a bfloat16 flow; the output keeps its input's memory format."""
    import torch.nn.functional as F

    from mfcnet_tpu_torch.ops.warp import (
        backward_warp,
        grid_sample_bilinear_plain,
    )

    img, flow = _backward_warp_inputs()
    flow = flow.to(flow_dtype)
    if channels_last:
        img = img.contiguous(memory_format=torch.channels_last)
        flow = flow.contiguous(memory_format=torch.channels_last)
    got = backward_warp(img, flow, align_corners, padding_mode)
    assert got.dtype == img.dtype and got.shape == img.shape
    assert got.stride() == img.stride()
    gx, gy = _linspace_grid(flow)
    want = grid_sample_bilinear_plain(img, gx, gy, align_corners, padding_mode)
    assert torch.equal(got, want)
    ref = F.grid_sample(img, torch.stack([gx, gy], -1), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    # the same four taps; torch blends with other float32 groupings
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL_WARP)


def test_backward_warp_rejects_gradients_and_bad_inputs():
    from mfcnet_tpu_torch.ops.warp import backward_warp

    img, flow = _backward_warp_inputs()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        backward_warp(img.clone().requires_grad_(), flow)
    with pytest.raises(ValueError, match="flow: expected"):
        backward_warp(img, flow[:, :1])
    with pytest.raises(ValueError, match="padding_mode"):
        backward_warp(img, flow, padding_mode="reflection")
    with pytest.raises(TypeError, match="flow: expected float32"):
        backward_warp(img, flow.half())
    with torch.no_grad():  # a frozen provider inside a training step
        backward_warp(img.clone().requires_grad_(), flow)


@pytest.mark.cuda
def test_cuda_warp_kernel_matches_plain_version():
    """The CUDA kernel against its plain version (run with
    ``python -m pytest tests/test_torch_warp.py -m cuda --noconftest`` on
    a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.ops import warp

    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        # the head's maps on the RAFT path (480x640) and the UnFlow path
        # (512x640): the vector route; an odd width takes the element route
        for shape in ((2, 6, 120, 160), (2, 5, 480, 640), (2, 5, 512, 640),
                      (1, 3, 37, 61)):
            B, C, H, W = shape
            maps = torch.rand(shape, generator=g).cuda().to(dt)
            for scale, shift in ((4.0, 0.0), (50.0, 0.0), (4.0, 400.0)):
                flow = (torch.randn(B, 2, H, W, generator=g) * scale
                        + shift).cuda()
                warp.reset_launches()
                got = warp.flow_warp(maps, flow, (576, 720))
                assert warp.LAUNCHES["flow_warp"] == 1
                want = warp.flow_warp_plain(maps, flow, (576, 720))
                if dt == torch.float32:  # the same operations, op for op
                    assert torch.equal(got, want)
                torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                           atol=ATOL_WARP)
        # grid_sample_bilinear: one launch of warp_abs (the grid
        # unnormalized and clamped in the kernel), bit for bit its plain
        # version in every mode, at an even (vector) and odd output width
        img = torch.randn(2, 3, 50, 70, generator=g).cuda().to(dt)
        for ho, wo in ((100, 120), (37, 61)):
            gx = (torch.rand(2, ho, wo, generator=g) * 2.4 - 1.2).cuda()
            gy = (torch.rand(2, ho, wo, generator=g) * 2.4 - 1.2).cuda()
            for ac in (False, True):
                for pm in ("zeros", "border"):
                    warp.reset_launches()
                    got = warp.grid_sample_bilinear(img, gx, gy, ac, pm)
                    assert warp.LAUNCHES["warp_abs"] == 1
                    assert torch.equal(got, warp.grid_sample_bilinear_plain(
                        img, gx, gy, ac, pm))
        # the one-launch backward warp: bit for bit its plain version,
        # whatever the layout and the flow's type
        frame = torch.randn(2, 3, 64, 96, generator=g).cuda().to(dt)
        for fdt in (torch.float32, torch.bfloat16):
            for fmt in (torch.contiguous_format, torch.channels_last):
                img = frame.contiguous(memory_format=fmt)
                fl = (torch.randn(2, 2, 64, 96, generator=g) * 8).cuda().to(
                    fdt).contiguous(memory_format=fmt)
                for ac in (False, True):
                    for pm in ("zeros", "border"):
                        warp.reset_launches()
                        got = warp.backward_warp(img, fl, ac, pm)
                        assert warp.LAUNCHES["backward_warp"] == 1
                        assert got.stride() == img.stride()
                        assert torch.equal(
                            got, warp.backward_warp_plain(img, fl, ac, pm))
        # B1, both entry points, against the plain backward: float32
        # within 1e-5 (atomics add in another order), bf16 within one bf16
        # rounding of the float32 result (and the float32 margin); where
        # the flow converges, a tap sums thousands of terms, and the bound
        # grows by 8 float32 roundings of the sum of their magnitudes (two
        # summation orders differ by about one). The trainer's width, and
        # an odd H and W: g's channel planes then start at odd element
        # offsets, which the maps kernel's bf16 word staging must follow
        # (on a grid 1.2 times the image, as 576x720 is to 480x640: on
        # 576x720 a 37x61 image's pixels all land within 3 px)
        for (B, C, H, W), grid in (((4, 6, 480, 640), (576, 720)),
                                   ((2, 6, 37, 61), (44, 73))):
            maps = torch.rand(B, C, H, W, generator=g).cuda().to(dt)
            gout = torch.randn(B, C, H, W, generator=g).cuda().to(dt)
            yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                                    torch.arange(W, dtype=torch.float32),
                                    indexing="ij")
            convergent = torch.stack([
                0.6 * W + 0.3 - xx * (W - 1) / (grid[1] - 1),
                0.4 * H + 0.7 - yy * (H - 1) / (grid[0] - 1)])[None] + (
                torch.rand(B, 2, H, W, generator=g) - 0.5) * 4
            long = torch.stack([100 * torch.sin(xx / 97 + yy / 61),
                                100 * torch.cos(xx / 83 - yy / 71)])[None]
            for flow, converges in (
                    (torch.randn(B, 2, H, W, generator=g).cuda() * 8, False),
                    (torch.zeros(B, 2, H, W, device="cuda"), False),
                    (convergent.cuda(), True),
                    (long.expand(B, 2, H, W).contiguous().cuda(), False)):
                warp.reset_launches()
                gm = warp.flow_warp_bwd_maps(gout, flow, grid)
                gf = warp.flow_warp_bwd_flow(gout, maps, flow, grid)
                assert warp.LAUNCHES["flow_warp_bwd_maps"] == 1
                assert warp.LAUNCHES["flow_warp_bwd_flow"] == 1
                pm, pf = warp.flow_warp_backward_plain(gout, maps, flow,
                                                       grid)
                atol = 1e-5
                if converges:
                    atol = atol + 8 * 2.0 ** -24 * \
                        warp.flow_warp_backward_plain(
                            gout.float().abs(), maps.float(), flow,
                            grid)[0]
                if dt == torch.float32 and not converges:
                    torch.testing.assert_close(gm, pm, rtol=0, atol=1e-5)
                elif dt == torch.float32:
                    assert bool(((gm - pm).abs() <= atol).all())
                else:
                    ref = warp.flow_warp_backward_plain(
                        gout.float(), maps.float(), flow, grid)[0]
                    ulp = 2.0 ** -8 * ref.abs().clamp_min(2.0 ** -126)
                    assert bool(((gm.float() - ref).abs()
                                 <= ulp + atol).all())
                torch.testing.assert_close(gf, pf, rtol=1e-5, atol=1e-4)
    torch.cuda.synchronize()
