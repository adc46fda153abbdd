"""UnFlow's gradients: ``loss.backward()`` through the port's ``UnFlow``
(the correlation's and the backward warp's autograd Functions, whose CPU
route is the plain backward) against ``jax.grad`` of the same loss through
the JAX package's ``UnFlow.apply`` (``corr_impl="shifts"``, the function
whose VJP the Pallas kernel carries), on the same weights (He-scaled random
values, carried to the JAX tree by the JAX package's ``convert_unflow``)
and the same 64x64 frames: every parameter's gradient and both frames'.

Both sides compute in float64 (``jax.enable_x64``; the port's float64
model), from the same base grid (the port's ``torch.linspace`` replaced by
the values of the jitted ``jnp.linspace``, 21 of 64 of which lie one
float32 step apart): a float32 comparison would measure float32 roundings
carried across kinks rather than the derivation. A random UnFlow's
gradient is not continuous in its inputs -- LeakyReLU, ``|first - warp|``
and the bilinear sample's derivative all jump -- and float32 runs of the
same port whose flows differ by ~3e-6 of their size gave gradients up to
0.15 of a tensor's largest apart on some seeds (none on others), which no
tolerance that still sees a wrong term can hold. Tolerance: 1e-11 of each
tensor's largest magnitude, float64 sums over ~75 convolutions and their
transposes in other orders (2.5e-14 found). The same gradients in
float32, through the kernels on the card, are held to the plain versions
by ``chip_smoke.py``'s ``phase_unflow_grad_slice``."""

import jax
import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


RTOL = 1e-11
#: of each network's last flow convolution: ~6 px of flow on 64x64 noise
FLOW_GAIN = 1.0 / 20.0


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def grads():
    """(the port's gradients, carried into the JAX tree by
    ``convert_unflow``, by tree path and 'first', 'second'; the JAX
    gradients under the same names): one jitted JAX gradient for the file
    (UnFlow's 441 unrolled shifts compile slowly)."""
    from mfcnet_tpu.compat.torch_convert import convert_unflow
    from mfcnet_tpu.models.unflow import UnFlow as JUnFlow
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights
    from mfcnet_tpu_torch.ops import warp

    model = he_init_weights(UnFlow(), torch.Generator().manual_seed(3),
                            flow_gain=FLOW_GAIN).double()
    variables = convert_unflow({k: v.detach().numpy()
                                for k, v in model.state_dict().items()})
    rng = np.random.default_rng(8)
    a, b = (rng.random((2, 64, 64, 3)) for _ in range(2))
    weight = rng.standard_normal((2, 64, 64, 2))
    jm = JUnFlow(corr_impl="shifts")
    with jax.enable_x64(True):
        def loss(v, x, y):
            return (jm.apply(v, x, y) * weight).sum()

        gv, ga, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            variables, a, b)
        want = _leaves(gv)
        want.update(first=np.asarray(ga), second=np.asarray(gb))
        # the base grid as the jitted model computes it (an eager linspace
        # rounds 21 of 64 values otherwise)
        base = torch.from_numpy(np.array(jax.jit(lambda: jax.numpy.linspace(
            -1.0, 1.0, 64, dtype=jax.numpy.float32))()))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    real = warp._base_grid
    warp._base_grid = lambda n, device: base
    try:
        (model(ta, tb) * torch.from_numpy(weight)).sum().backward()
    finally:
        warp._base_grid = real
    got = _leaves(convert_unflow({k: p.grad.numpy()
                                  for k, p in model.named_parameters()}))
    got.update(first=ta.grad.numpy(), second=tb.grad.numpy())
    return got, want


def test_unflow_gradients_match_jax(grads):
    got, want = grads
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype == np.float64, k
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        err = np.abs(got[k] - want[k]).max()
        assert err <= RTOL * scale, (k, err, scale)


def test_unflow_gradient_reaches_every_network(grads):
    """Each of the three networks' first convolutions and both frames get a
    gradient: the refinements' through the backward warp's flow gradient,
    the first network's also through the correlation's."""
    got, _ = grads
    firsts = [k for k in got if k.endswith("['one']['kernel']")]
    assert len(firsts) == 3
    for k in firsts:
        assert np.abs(got[k]).max() > 0
    assert np.abs(got["first"]).max() > 0 and np.abs(got["second"]).max() > 0
