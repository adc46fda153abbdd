"""The port's two experimental convolutions against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs, at float32 on the CPU
(where the wrappers run their plain versions), at the shapes of
``tests/test_ops.py``'s own parity tests.

Tolerance: atol 2e-5, rtol 1e-5, the JAX tests' own (float32 sums in
another order)."""

import numpy as np
import pytest
import torch

ATOL, RTOL = 2e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,H,W,cin,cout,relu", [
    (1, 24, 30, 64, 32, False),
    (2, 16, 17, 8, 8, True),
])
def test_conv3x3_matches_pallas_kernel(B, H, W, cin, cout, relu):
    from mfcnet_tpu.experimental.conv3x3_pallas import conv3x3_pallas
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3

    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.05
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(conv3x3_pallas(x, w, bias=b, relu=relu, interpret=True))
    got = conv3x3(_t(x), _t(w), _t(b), relu).numpy()
    assert got.shape == want.shape == (B, H, W, cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    want0 = np.asarray(conv3x3_pallas(x, w, relu=relu, interpret=True))
    np.testing.assert_allclose(conv3x3(_t(x), _t(w), None, relu).numpy(),
                               want0, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,W,C1,R", [(32, 48, 16, 8), (16, 24, 16, 4),
                                      (64, 40, 8, 16)])
def test_vgg_stage1_matches_pallas_kernel(H, W, C1, R):
    """Incl. the zero ring between the two convolutions: the Pallas kernel
    masks it, the plain version pads the rounded intermediate with zeros."""
    from mfcnet_tpu.experimental.stage1_pallas import vgg_stage1_pallas
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    k1 = rng.standard_normal((3, 3, 3, C1)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(C1).astype(np.float32) * 0.1
    k2 = rng.standard_normal((3, 3, C1, C1)).astype(np.float32) * 0.05
    b2 = rng.standard_normal(C1).astype(np.float32) * 0.1
    want = np.asarray(vgg_stage1_pallas(x, k1, b1, k2, b2, tile_rows=R))
    got = vgg_stage1(*map(_t, (x, k1, b1, k2, b2))).numpy()
    assert got.shape == want.shape == (2, H, W, C1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the ring matters: conv1's bias makes its value outside the image
    # nonzero, and a version that convolved it would differ at the border
    assert np.abs(got[:, 0]).max() > 0


def test_vgg_stage1_takes_any_size_and_equals_two_conv3x3():
    """No divisibility constraint; the fused stage is conv3x3 twice."""
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 13, 19, 3, generator=g)
    k1, b1 = torch.randn(3, 3, 3, 6, generator=g) * 0.2, torch.randn(6, generator=g)
    k2, b2 = torch.randn(3, 3, 6, 6, generator=g) * 0.1, torch.randn(6, generator=g)
    torch.testing.assert_close(
        vgg_stage1(x, k1, b1, k2, b2),
        conv3x3(conv3x3(x, k1, b1, True), k2, b2, True), rtol=0, atol=1e-6)


def test_bfloat16_rounding_points():
    """bf16: weights and the intermediate are rounded to bf16, sums and
    biases are float32, the result is rounded once."""
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, 9, 3, generator=g).bfloat16()
    k1, b1 = torch.randn(3, 3, 3, 4, generator=g), torch.randn(4, generator=g)
    k2, b2 = torch.randn(3, 3, 4, 4, generator=g), torch.randn(4, generator=g)
    y = conv3x3(x, k1, b1, True)
    assert y.dtype == torch.bfloat16
    want = conv3x3(x.float(), k1.bfloat16().float(), b1, True).bfloat16()
    assert torch.equal(y, want)
    out = vgg_stage1(x, k1, b1, k2, b2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, conv3x3(y, k2, b2, True))


def test_experimental_kernels_reject_bad_inputs():
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    x, w = torch.rand(1, 4, 4, 3), torch.rand(3, 3, 3, 5)
    with pytest.raises(NotImplementedError, match="forward only"):
        conv3x3(x, w.clone().requires_grad_())
    with pytest.raises(ValueError, match=r"\(3, 3, 3, cout\)"):
        conv3x3(x, torch.rand(3, 3, 4, 5))
    with pytest.raises(ValueError, match="bias"):
        conv3x3(x, w, torch.rand(4))
    with pytest.raises(TypeError, match="float32 or"):
        conv3x3(x.half(), w)
    with pytest.raises(ValueError, match="k2"):
        vgg_stage1(x, w, torch.rand(5), torch.rand(3, 3, 5, 6), torch.rand(6))


@pytest.mark.cuda
def test_cuda_conv_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions (run with ``python -m
    pytest tests/test_torch_experimental.py -m cuda --noconftest`` on a
    GPU). float32: the JAX tests' limits; bfloat16: one bf16 step of the
    result (a float32 sum in another order can flip the final rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1

    g = torch.Generator().manual_seed(0)
    for dt, atol, rtol in ((torch.float32, ATOL, RTOL),
                           (torch.bfloat16, 2.0 ** -8, 2.0 ** -7)):
        for B, H, W, cin, cout in ((1, 24, 30, 64, 32), (2, 16, 17, 8, 8),
                                   (1, 9, 21, 3, 70)):
            x = torch.randn(B, H, W, cin, generator=g).cuda().to(dt)
            w = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).cuda()
            b = torch.randn(cout, generator=g).cuda()
            c3.reset_launches()
            got = c3.conv3x3(x, w, b, True)
            assert c3.LAUNCHES["conv3x3"] == 1
            torch.testing.assert_close(
                got.float(), c3.conv3x3_plain(x, w, b, True).float(),
                rtol=rtol, atol=atol)
        x = torch.randn(2, 19, 23, 3, generator=g).cuda().to(dt)
        k1 = (torch.randn(3, 3, 3, 70, generator=g) * 0.2).cuda()
        k2 = (torch.randn(3, 3, 70, 70, generator=g) * 0.05).cuda()
        b1 = (torch.randn(70, generator=g) * 0.1).cuda()
        b2 = (torch.randn(70, generator=g) * 0.1).cuda()
        s1.reset_launches()
        got = s1.vgg_stage1(x, k1, b1, k2, b2)
        assert s1.LAUNCHES["vgg_stage1"] == 1
        torch.testing.assert_close(
            got.float(), s1.vgg_stage1_plain(x, k1, b1, k2, b2).float(),
            rtol=rtol, atol=2 * atol)
    torch.cuda.synchronize()
