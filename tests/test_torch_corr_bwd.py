"""The correlation's backward (B2): the port's gradients, through the
autograd Function on CPU tensors (where it runs
``correlation_backward_plain``), against ``jax.vjp`` of the JAX package's
``correlation_pallas`` (its Pallas forward in interpret mode, as
``tests/test_correlation_pallas.py`` runs it, and its custom VJP) where
max_displacement is a multiple of the stride, and of
``correlation_shifts`` otherwise (the Pallas kernel's window is off
centre there); ``gradcheck`` in float64; the written-out plain formula
against PyTorch's autograd of ``correlation_plain``, a second derivation.
The CUDA case holds the kernel to its plain version on the card.

Tolerances: atol 1e-5, rtol 1e-5, the forward's (the JAX package's own
limit for its kernel): a gradient sums up to D^2 products a channel, in
dy-major order here and in XLA's order there, and ``1 / C`` is a product
here and a division in ``jnp.mean``'s transpose. On the card: max |diff|
over the plain gradient's largest magnitude, 1e-5 in float32 (the same sum
with fused multiply-adds), one bfloat16 step (2^-8) more for bfloat16
inputs, whose float32 sums are rounded once."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


ATOL = RTOL = 1e-5

CASES = [
    ((1, 6, 8, 16), 4, 2),      # the JAX kernel test's forward case
    ((1, 5, 7, 8), 2, 2),       # ... and its gradient case's shapes
    ((2, 9, 11, 5), 3, 1),      # odd H, W, C; stride 1
    ((1, 7, 13, 12), 5, 3),     # max_displacement no multiple of the stride
    ((1, 3, 4, 6), 20, 2),      # UnFlow's 441 channels, window > image
]


def _inputs(shape, md, s, seed):
    rng = np.random.default_rng(seed)
    D = 2 * (md // s) + 1
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal((*shape[:3], D * D), dtype=np.float32))


@pytest.mark.parametrize("shape,md,s", CASES)
def test_correlation_backward_matches_jax(shape, md, s):
    import jax

    from mfcnet_tpu.ops.correlation import correlation_shifts
    from mfcnet_tpu.ops.correlation_pallas import correlation_pallas
    from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume

    f1, f2, g = _inputs(shape, md, s, 11)
    fn = correlation_pallas if md % s == 0 else correlation_shifts
    want1, want2 = jax.jit(lambda a, b, ct: jax.vjp(
        lambda x, y: fn(x, y, md, s), a, b)[1](ct))(f1, f2, g)
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    correlation_cost_volume(a, b, md, s).backward(torch.from_numpy(g))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want2), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,md,s", CASES[1:4])
def test_correlation_backward_plain_equals_autograd_of_forward(shape, md, s):
    """The written-out sums == PyTorch's autograd of correlation_plain."""
    from mfcnet_tpu_torch.ops.correlation import (
        correlation_backward_plain,
        correlation_plain,
    )

    f1, f2, g = (torch.from_numpy(x) for x in _inputs(shape, md, s, 12))
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    correlation_plain(a, b, md, s).backward(g)
    g1, g2 = correlation_backward_plain(g, f1, f2, md, s)
    torch.testing.assert_close(g1, a.grad, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(g2, b.grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("md,s", [(4, 2), (3, 2)])
def test_correlation_gradcheck_float64(md, s):
    from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume

    gen = torch.Generator().manual_seed(5)
    a = torch.randn(1, 4, 5, 2, dtype=torch.float64, generator=gen)
    b = torch.randn(1, 4, 5, 2, dtype=torch.float64, generator=gen)
    assert torch.autograd.gradcheck(
        lambda x, y: correlation_cost_volume(x, y, md, s),
        (a.requires_grad_(), b.requires_grad_()))


def test_correlation_backward_only_where_asked_and_in_the_inputs_type():
    """A gradient only for the input that requires one; bfloat16 inputs get
    bfloat16 gradients, the float32 sums rounded once."""
    from mfcnet_tpu_torch.ops.correlation import (
        correlation_backward_plain,
        correlation_cost_volume,
    )

    f1, f2, g = (torch.from_numpy(x) for x in _inputs((1, 6, 8, 16), 4, 2,
                                                      13))
    a = f1.clone().requires_grad_()
    correlation_cost_volume(a, f2, 4, 2).backward(g)
    assert a.grad is not None and not f2.requires_grad
    g1, g2 = correlation_backward_plain(g, f1, f2, 4, 2, (False, True))
    assert g1 is None and g2.shape == f2.shape
    ab, bb = f1.bfloat16().requires_grad_(), f2.bfloat16().requires_grad_()
    correlation_cost_volume(ab, bb, 4, 2).backward(g)
    assert ab.grad.dtype == bb.grad.dtype == torch.bfloat16
    w1, w2 = correlation_backward_plain(g, ab.detach().float(),
                                        bb.detach().float(), 4, 2)
    assert torch.equal(ab.grad, w1.bfloat16())
    assert torch.equal(bb.grad, w2.bfloat16())


@pytest.mark.cuda
def test_cuda_correlation_backward_matches_plain_version():
    """B2's kernel against its plain version on both routes: the tensor
    cores at UnFlow's tracker and offline conv3 shapes and at a shape of
    several tiles a row whose last channel chunk holds 8 channels, the fma
    route where C % 8 != 0; both types, one launch a call, each gradient
    alone equal to both together, two calls bit-equal (run with ``python
    -m pytest tests/test_torch_corr_bwd.py -m cuda --noconftest`` on a
    GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.ops import correlation as co

    gen = torch.Generator().manual_seed(0)
    for shape, md, s, route in (((2, 32, 40, 256), 20, 2, "tc"),
                                ((4, 64, 80, 256), 20, 2, "tc"),
                                ((1, 5, 70, 136), 6, 2, "tc"),
                                ((1, 9, 45, 7), 5, 3, "fma"),
                                ((2, 11, 13, 70), 4, 1, "fma")):
        D = co.displacements(md, s)
        g = torch.randn(*shape[:3], D * D, generator=gen).cuda()
        for dt, tol in ((torch.float32, 1e-5),
                        (torch.bfloat16, 2.0 ** -8 + 1e-5)):
            assert co.corr_bwd_plan(*shape, md, s, str(dt)[6:]).route == route
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            co.reset_launches()
            k1, k2 = co.correlation_backward(g, f1, f2, md, s)
            assert co.LAUNCHES["correlation_bwd"] == 1
            p1, p2 = co.correlation_backward_plain(g, f1, f2, md, s)
            for k, p in ((k1, p1), (k2, p2)):
                assert k.dtype == dt
                err = (k.float() - p.float()).abs().max()
                assert float(err) <= tol * float(p.float().abs().max())
            again = co.correlation_backward(g, f1, f2, md, s)
            assert torch.equal(again[0], k1) and torch.equal(again[1], k2)
            only1 = co.correlation_backward(g, f1, f2, md, s, (True, False))
            only2 = co.correlation_backward(g, f1, f2, md, s, (False, True))
            assert torch.equal(only1[0], k1) and only1[1] is None
            assert torch.equal(only2[1], k2) and only2[0] is None
    torch.cuda.synchronize()
