"""The four zoo bases of the port (DeepLabV3 and FCN on the dilated
ResNet-101, HRNet-W48, SegFormer MiT-B3) against the JAX package's, on
the CPU: the forward at tiny widths (the JAX registry's ``scale`` rules)
on the same variables, carried into the port by ``compat.from_jax``, in
float32 and bfloat16; the weight round trip JAX -> port ->
``torch_convert.convert_*`` -> JAX; at full width, the key names and
shapes against the reference-layout oracles (``tests/torch_*_ref.py``,
pure torch) and the Multi wrappers' round trip port ->
``convert_multiframe`` -> port.

The JAX variables are filled from numpy over ``jax.eval_shape``'s tree
(no JAX init to compile); the JAX forward is jitted, once per base and
type.

Tolerances: float32 logits (log-probabilities for SegFormer) within 1e-5
(float32 convolutions and sums in another order; read: 2.5e-7 to 1.9e-6);
bfloat16 (a bf16 cast of the port against the JAX package's bf16 model,
variables and input cast, as each tracker casts them) no further from
JAX's float32 output than JAX's bf16 output is, times 1.25, plus 1e-4
(PR 13's rule for FlowFormer++); round trips exact."""

import copy

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

C = 5
H, W = 64, 40  # stride-2 sizes 32x20, 16x10, 8x5, 4x3 (odd), 2x2
SCALE = 0.125
BASES = ("DeepLab_v3", "FCN", "HRNet", "SegFormer")
_JAX = {}


def fill_like(tree, seed):
    """numpy variables over an ``eval_shape`` tree: conv/dense kernels
    normal / sqrt(fan-in), biases and BN/LN parameters near their init,
    running statistics random (mean ~0.1, var in [0.5, 2])."""
    import jax

    rng = np.random.default_rng(seed)

    def one(path, s):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def jax_base(kind):
    """(JAX module, its numpy variables, input, jitted apply) of a tiny
    base, made once per module."""
    if kind not in _JAX:
        import jax

        from mfcnet_tpu.models import get_tooltip_segmentation_model

        jm = get_tooltip_segmentation_model(kind, C, scale=SCALE)
        x = np.random.default_rng(1).standard_normal((2, H, W, 3)).astype(
            np.float32)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
        _JAX[kind] = (jm, fill_like(shapes, 2), x, jax.jit(jm.apply))
    return _JAX[kind]


def port_base(kind, variables):
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    pm = get_tooltip_segmentation_model(kind, C, scale=SCALE)
    return load_jax_variables(pm, variables).eval()


def _forward(pm, x, dtype=torch.float32):
    with torch.no_grad():
        y = pm(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    assert y.dtype == dtype
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", BASES)
def test_base_forward_matches_jax_float32(kind):
    jm, v, x, apply = jax_base(kind)
    want = np.asarray(apply(v, x))
    got = _forward(port_base(kind, v), x)
    assert got.shape == want.shape == (2, H, W, C)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", BASES)
def test_base_forward_bfloat16_within_the_jax_bfloat16_envelope(kind):
    import jax
    import jax.numpy as jnp

    jm, v, x, apply = jax_base(kind)
    want32 = np.asarray(apply(v, x))
    v16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    want16 = np.asarray(apply(v16, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    p16 = copy.deepcopy(port_base(kind, v)).bfloat16()
    got = _forward(p16, x, torch.bfloat16)
    d_jax = np.abs(want16 - want32).max()
    d_port = np.abs(got - want32).max()
    assert d_jax > 1e-3  # bfloat16 does move the output
    assert d_port <= 1.25 * d_jax + 1e-4, (d_port, d_jax)


def _convert(kind, sd):
    """The port's tiny base state_dict -> JAX variables through the JAX
    package's converter for its family, at the tiny depths."""
    from mfcnet_tpu.compat import torch_convert as tc

    sd = {k: t.numpy() for k, t in sd.items()}
    if kind == "DeepLab_v3":
        return tc.convert_deeplabv3_resnet101(sd, layers=(1, 1, 1, 1))
    if kind == "FCN":
        return tc.convert_fcn_resnet101(sd, layers=(1, 1, 1, 1))
    if kind == "HRNet":
        return tc.convert_hrnet(sd, stage_modules=(1, 1, 1), num_blocks=1)
    return tc.convert_segformer(sd, depths=(1, 1, 1, 1))


@pytest.mark.parametrize("kind", BASES)
def test_from_jax_round_trip_through_torch_convert_is_exact(kind):
    """JAX variables -> ``from_jax`` -> the port's state_dict ->
    ``torch_convert.convert_*`` -> the same JAX variables bit for bit."""
    import jax

    jm, v, x, apply = jax_base(kind)
    back = _convert(kind, port_base(kind, v).state_dict())
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(v)}
    got = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
           jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


def _oracle(kind):
    from tests.torch_hrnet_ref import HRNetTorch
    from tests.torch_resnet_ref import SegModelTorch
    from tests.torch_segformer_ref import SegformerTorch

    if kind == "DeepLab_v3":
        return SegModelTorch("deeplab", C, layers=(3, 4, 23, 3), width=64)
    if kind == "FCN":
        return SegModelTorch("fcn", C, layers=(3, 4, 23, 3), width=64)
    if kind == "HRNet":
        return HRNetTorch(C, channels=(48, 96, 192, 384),
                          stage_modules=(1, 4, 3), num_blocks=4,
                          stage1_width=64)
    return SegformerTorch(C)


@pytest.mark.parametrize("kind", BASES)
def test_full_width_keys_equal_the_oracle(kind):
    """Every key and shape of the full-width base equals the reference
    layout's (torchvision, the reference HRNet, smp), so the reference's
    checkpoints load by name; the oracle's weights load strictly and give
    the oracle's output on a small input (eval mode)."""
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    pm = get_tooltip_segmentation_model(kind, C)
    ref = _oracle(kind)
    want = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in pm.state_dict().items()}
    assert got == want
    if kind != "SegFormer":
        return
    # SegFormer's decoder resizes to stage 1's size and the log-softmax
    # follows the final resize: the oracle's output order matches at sizes
    # divisible by 32
    torch.manual_seed(0)
    for p in ref.parameters():
        torch.nn.init.normal_(p, 0, 0.02)
    pm.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        torch.testing.assert_close(pm.eval()(x), ref.eval()(x), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("family", ["DeepLab", "FCN", "HRNet", "SegFormer"])
def test_multi_wrapper_round_trip_at_full_width(family):
    """A full-width ``{family}Multi-Large`` with flow and depth: its
    state_dict -> ``torch_convert.convert_multiframe`` (the reference's
    key names at the reference's depths) -> ``from_jax`` -> the same
    state_dict bit for bit, the 22-channel head included."""
    from mfcnet_tpu.compat.torch_convert import convert_multiframe
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.models import (
        _MULTI_BASES,
        get_multiframe_segmentation_model,
    )

    pm = get_multiframe_segmentation_model(
        f"{family}Multi-Large", C, 3, add_optflow_inputs=True,
        add_depth_inputs=True)
    with torch.no_grad():
        for b in pm.buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5)
    want = pm.state_dict()
    v = convert_multiframe({k: t.numpy() for k, t in want.items()},
                           _MULTI_BASES[f"{family}Multi"])
    back = state_dict_from_jax(v, pm)
    assert set(back) == set(want)
    for k, t in want.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    assert back["multiframe_net.multiframe_net.0.weight"].shape[1] == 22


def test_from_jax_refuses_a_key_without_a_jax_counterpart():
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax

    jm, v, x, apply = jax_base("FCN")
    pm = port_base("FCN", v)
    pm.classifier.add_module("extra", torch.nn.Conv2d(2, 2, 1))
    with pytest.raises(KeyError, match="classifier.extra.weight"):
        state_dict_from_jax(v, pm)
