"""The port's correlation cost volume against the JAX package's, on the same
numpy inputs, at float32 on the CPU (where the wrapper runs its plain
version): against ``correlation_shifts`` and against the Pallas kernel in
interpret mode, as ``tests/test_correlation_pallas.py`` runs it.

Tolerance: atol 1e-5, rtol 1e-5, the JAX package's own limit for its
kernel (the sum over C is taken in another order, and ``1/C`` is a product
in the kernels and a mean in ``correlation_shifts``)."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

ATOL = RTOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("shape,md,s", [
    ((1, 6, 8, 16), 4, 2),      # the JAX kernel test's forward case
    ((1, 5, 7, 8), 2, 2),       # ... and its gradient case's shapes
    ((2, 9, 11, 5), 3, 1),      # odd H, W, C; stride 1
    ((1, 7, 13, 12), 5, 3),     # max_displacement no multiple of the stride
    ((1, 3, 4, 6), 20, 2),      # UnFlow's 441 channels, window > image
])
def test_correlation_matches_jax_shifts_and_pallas(shape, md, s):
    from mfcnet_tpu.ops.correlation import correlation_shifts
    from mfcnet_tpu.ops.correlation_pallas import correlation_pallas
    from mfcnet_tpu_torch.ops.correlation import (
        correlation_cost_volume,
        displacements,
    )

    f1, f2 = _inputs(shape, 0)
    got = correlation_cost_volume(torch.from_numpy(f1), torch.from_numpy(f2),
                                  md, s).numpy()
    D = displacements(md, s)
    assert got.shape == shape[:3] + (D * D,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(correlation_shifts(f1, f2, md, s)),
                               atol=ATOL, rtol=RTOL)
    if md % s == 0:
        # otherwise the Pallas kernel's window is off centre (it starts at
        # -max_displacement, not at -(max_displacement // stride) * stride)
        # and disagrees with correlation_shifts, which defines the function
        np.testing.assert_allclose(
            got, np.asarray(correlation_pallas(f1, f2, md, s)),
            atol=ATOL, rtol=RTOL)


def test_channel_order_is_dy_major_and_dy_moves_rows():
    """One-hot inputs: f1 lit at (y, x), f2 at (y + dy, x + dx) -> exactly
    channel dy_i * D + dx_i of pixel (y, x) is 1/C * 1."""
    from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume

    H, W, C, md, s = 9, 11, 4, 4, 2
    D = 5
    y, x, dy, dx = 4, 5, 2, -4
    f1 = torch.zeros(1, H, W, C)
    f2 = torch.zeros(1, H, W, C)
    f1[0, y, x, 1] = 1.0
    f2[0, y + dy, x + dx, 1] = 1.0
    out = correlation_cost_volume(f1, f2, md, s)
    hot = torch.nonzero(out)
    assert hot.tolist() == [[0, y, x, (dy // s + D // 2) * D + dx // s + D // 2]]
    assert out[tuple(hot[0])] == pytest.approx(1.0 / C)


def test_bfloat16_inputs_are_widened_exactly():
    from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume

    f1, f2 = (torch.from_numpy(a).bfloat16() for a in _inputs((1, 6, 7, 8), 3))
    got = correlation_cost_volume(f1, f2, 2, 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, correlation_cost_volume(f1.float(), f2.float(), 2, 1),
        rtol=0, atol=0)


def test_correlation_rejects_gradients_and_bad_inputs():
    """An input that requires a gradient gets one (B2's backward, checked
    against JAX in tests/test_torch_corr_bwd.py), only that input; bad
    shapes and types raise."""
    from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume

    f = torch.rand(1, 4, 4, 8)
    a = f.clone().requires_grad_()
    correlation_cost_volume(a, f).sum().backward()
    assert a.grad is not None and a.grad.shape == f.shape
    assert float(a.grad.abs().sum()) > 0
    with torch.no_grad():
        assert not correlation_cost_volume(f.clone().requires_grad_(), f, 2,
                                           2).requires_grad
    with pytest.raises(ValueError, match="one shape"):
        correlation_cost_volume(f, torch.rand(1, 4, 5, 8))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        correlation_cost_volume(f, f.bfloat16())
    with pytest.raises(ValueError, match="stride"):
        correlation_cost_volume(f, f, 4, 0)


@pytest.mark.cuda
def test_cuda_correlation_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on both routes of
    ``corr_plan``: the tensor cores at UnFlow's tracker and offline shapes,
    the FMA body at an odd shape (run with ``python -m pytest
    tests/test_torch_correlation.py -m cuda --noconftest`` on a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.ops import correlation as co

    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for shape, md, s, route in (((2, 32, 40, 256), 20, 2, "tc"),
                                    ((4, 64, 80, 256), 20, 2, "tc"),
                                    ((2, 16, 20, 256), 20, 2, "tc"),
                                    ((1, 9, 45, 7), 5, 3, "fma")):
            name = str(dt).split(".")[1]
            assert co.corr_plan(*shape, md, s, name).route == route
            f1 = torch.randn(shape, generator=g).cuda().to(dt)
            f2 = torch.randn(shape, generator=g).cuda().to(dt)
            co.reset_launches()
            got = co.correlation_cost_volume(f1, f2, md, s)
            assert co.LAUNCHES["correlation"] == 1
            torch.testing.assert_close(got, co.correlation_plain(f1, f2, md, s),
                                       rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
