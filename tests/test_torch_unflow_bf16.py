"""A bfloat16 UnFlow of the port against the JAX package's bfloat16 UnFlow
(parameters cast to bfloat16, bfloat16 inputs), on the same seeded weights
and numpy inputs at 64x64 on the CPU.

The JAX package computes such a model in float32: its float32 channel
means promote the bfloat16 input, and the float32 activations promote every
bfloat16 kernel. The port follows those types (``models/unflow.py``), so
its bfloat16 model must agree with the JAX bfloat16 model as closely as the
two float32 models agree (``tests/test_torch_unflow.py``: atol 5e-4, rtol
1e-3), and in particular by no more than the JAX bfloat16 model differs
from the JAX float32 model, plus that float32 tolerance as the margin.
Before the port followed the JAX types (it ran every layer in bfloat16)
the first difference was of the second's size and exceeded it on some
weights and inputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL, RTOL = 5e-4, 1e-3
FLOW_GAIN = 1.0 / 20.0  # ~1 px of flow on 64x64 noise, as in test_torch_unflow


@pytest.fixture(scope="module")
def models():
    """(jitted JAX UnFlow apply, JAX float32 and bfloat16 variables, the
    port's float32 and bfloat16 models): one jitted function for the file,
    compiled once per type (the 441 unrolled shifts compile slowly)."""
    from mfcnet_tpu.compat.torch_convert import convert_unflow
    from mfcnet_tpu.models.unflow import UnFlow as JUnFlow
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights

    pm = he_init_weights(UnFlow(), torch.Generator().manual_seed(3),
                         flow_gain=FLOW_GAIN).eval()
    v32 = convert_unflow({k: v.detach().numpy()
                          for k, v in pm.state_dict().items()})
    v16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v32)
    return (jax.jit(JUnFlow(corr_impl="shifts").apply), v32, v16, pm,
            copy.deepcopy(pm).bfloat16())


@pytest.mark.parametrize("seed", [0, 6, 7])
def test_bfloat16_unflow_matches_jax_bfloat16_unflow(models, seed):
    apply, v32, v16, _, p16 = models
    rng = np.random.default_rng(seed)
    a, b = (rng.random((1, 64, 64, 3), np.float32) for _ in range(2))
    want32 = np.asarray(apply(v32, a, b))
    want16 = np.asarray(apply(v16, jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16)))
    with torch.no_grad():
        got = p16(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and want16.dtype == np.float32
    got = got.numpy()
    d_port = np.abs(got - want16).max()
    d_jax = np.abs(want16 - want32).max()
    assert d_jax > 20 * ATOL  # bfloat16 weights do move the flow
    assert d_port <= d_jax + ATOL, (d_port, d_jax)
    np.testing.assert_allclose(got, want16, atol=ATOL, rtol=RTOL)


def test_means_stay_float32_in_a_bfloat16_model(models):
    """A bfloat16 cast rounds every parameter to bfloat16 once and keeps it
    in float32 (no cast on a call), rounds the input, and leaves the means
    float32 and unrounded."""
    from mfcnet_tpu_torch.models.unflow import _MEANS_BGR

    p32, p16 = models[3], models[4]
    assert p16.input_dtype == torch.bfloat16
    assert p32.input_dtype == torch.float32
    for (k, w16), w32 in zip(p16.named_parameters(), p32.parameters()):
        assert w16.dtype == torch.float32, k
        assert torch.equal(w16, w32.bfloat16().float()), k
    assert p16.means_bgr.dtype == torch.float32
    assert torch.equal(p16.means_bgr.flatten(), torch.tensor(_MEANS_BGR))
    # a further move keeps the rounding of the input
    assert copy.deepcopy(p16).to("cpu").input_dtype == torch.bfloat16
