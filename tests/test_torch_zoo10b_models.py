"""The rest of the zoo's bases in the port -- TernausNet11, UNet, ResUNet,
TAPNet11, TAPNet16 and the generic TAPNet -- against the JAX package's,
on the CPU: the forward at tiny widths (the JAX registry's ``scale``
rules; TAPNet11/16's decoder at 1/8 width, the generic TAPNet at its
only widths) on the same variables,
carried into the port by ``compat.from_jax``, in float32 and bfloat16;
the weight round trip JAX -> port -> ``torch_convert.convert_*`` -> JAX;
at full width, the key names and shapes against the reference-layout
oracles (``tests/torch_resunet_ref.py``, ``tests/torch_tapnet_ref.py``,
pure torch), whose weights load strictly and give their output; and the
two new norms, ``GroupNorm`` and ``WSConv2d``, against flax's and the
JAX ``WSConv``.

The JAX variables are filled from numpy over ``jax.eval_shape``'s tree
(``tests/test_torch_zoo_models.py::fill_like``); each JAX forward is
jitted once per base and type, in a module-scoped fixture.

Tolerances (``tests/test_torch_zoo_models.py``'s): float32 outputs within
1e-5 (float32 convolutions and sums in another order); bfloat16 (a bf16
cast of the port against the JAX bf16 model, variables and input cast) no
further from JAX's float32 output than JAX's bf16 output is, times 1.25,
plus 1e-4; round trips exact."""

import copy

import numpy as np
import pytest
import torch

from tests.test_torch_zoo_models import fill_like
from torch_threads import _two_torch_threads  # noqa: F401

C = 5
H = W = 64
SCALE = 0.0625
BASES = ("TernausNet11", "UNet", "ResUNet", "TAPNet11", "TAPNet16", "TAPNet")


#: TAPNet11/16's decoder width in the parity tests (the registry keeps it
#: at 1: ``test_registry_widths_follow_the_jax_rules``)
TAP_WIDTH = 0.125


def _jax_module(kind):
    from mfcnet_tpu.models import get_tooltip_segmentation_model
    from mfcnet_tpu.models import tapnet

    if kind == "TAPNet":
        return tapnet.TAPNet(num_classes=C)
    if kind.startswith("TAPNet"):
        return getattr(tapnet, kind)(num_classes=C, stage_convs=_stages(kind),
                                     width_mult=TAP_WIDTH)
    return get_tooltip_segmentation_model(kind, C, scale=SCALE)


def _stages(kind):
    from mfcnet_tpu_torch.models.common import VGG11_STAGES, VGG16_STAGES

    stages = VGG11_STAGES if kind == "TAPNet11" else VGG16_STAGES
    return tuple(tuple(max(4, int(c * SCALE)) for c in s) for s in stages)


def _port_module(kind, scale=SCALE):
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.models import tapnet

    if kind == "TAPNet":
        return tapnet.TAPNet(C)
    if kind.startswith("TAPNet") and scale == SCALE:
        return getattr(tapnet, kind)(C, _stages(kind), width_mult=TAP_WIDTH)
    return get_tooltip_segmentation_model(kind, C, scale=scale)


def _inputs(kind):
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, H, W, 3)).astype(np.float32)]
    if kind.startswith("TAPNet"):
        xs.append(rng.random((2, H, W, 1)).astype(np.float32))
    return xs


@pytest.fixture(scope="module")
def jax_bases():
    """kind -> (JAX module, numpy variables, inputs, jitted apply)."""
    import jax

    out = {}
    for kind in BASES:
        jm, xs = _jax_module(kind), _inputs(kind)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *xs))
        out[kind] = (jm, fill_like(shapes, 2), xs, jax.jit(jm.apply))
    return out


def port_base(kind, variables):
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables

    return load_jax_variables(_port_module(kind), variables).eval()


def _forward(pm, xs, dtype=torch.float32):
    with torch.no_grad():
        y = pm(*[torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
                 for x in xs])
    assert y.dtype == dtype
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", BASES)
def test_base_forward_matches_jax_float32(jax_bases, kind):
    jm, v, xs, apply = jax_bases[kind]
    want = np.asarray(apply(v, *xs))
    got = _forward(port_base(kind, v), xs)
    assert got.shape == want.shape == (2, H, W, C)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", BASES)
def test_base_forward_bfloat16_within_the_jax_bfloat16_envelope(jax_bases,
                                                                kind):
    import jax
    import jax.numpy as jnp

    jm, v, xs, apply = jax_bases[kind]
    want32 = np.asarray(apply(v, *xs))
    v16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    want16 = np.asarray(apply(v16, *[jnp.asarray(x, jnp.bfloat16)
                                     for x in xs]).astype(jnp.float32))
    p16 = copy.deepcopy(port_base(kind, v)).bfloat16()
    got = _forward(p16, xs, torch.bfloat16)
    d_jax = np.abs(want16 - want32).max()
    d_port = np.abs(got - want32).max()
    assert d_jax > 1e-3  # bfloat16 does move the output
    assert d_port <= 1.25 * d_jax + 1e-4, (d_port, d_jax)


def _leaves(tree):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _convert(kind, sd):
    """The port's state_dict -> JAX variables: the JAX package's converter
    for TernausNet11, ResUNet and TAPNet11/16; for the UNet, whose port
    carries the JAX tree's names, the layout change alone."""
    from mfcnet_tpu.compat import torch_convert as tc

    sd = {k: t.numpy() for k, t in sd.items()}
    if kind == "TernausNet11":
        return tc.convert_ternausnet(sd, "TernausNet11")
    if kind == "ResUNet":
        return tc.convert_resunet(sd)
    if kind.startswith("TAPNet"):
        return tc.convert_tapnet(sd, kind)
    params, stats = {}, {}
    for k, a in sd.items():
        *path, leaf = k.split(".")
        if leaf == "num_batches_tracked":
            continue
        tree, name = (stats, {"running_mean": "mean",
                              "running_var": "var"}[leaf]) if leaf.startswith(
            "running") else (params, leaf)
        for p in path:
            tree = tree.setdefault(p, {})
        if leaf == "weight" and a.ndim == 4:
            tree["kernel"] = a.transpose(2, 3, 1, 0)
        else:
            tree[{"weight": "scale"}.get(name, name)] = a
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("kind", BASES[:5])
def test_from_jax_round_trip_is_exact(jax_bases, kind):
    """JAX variables -> ``from_jax`` -> the port's state_dict -> the JAX
    layout (``torch_convert.convert_*`` where the JAX package has one) ->
    the same JAX variables bit for bit."""
    jm, v, xs, apply = jax_bases[kind]
    want = _leaves(v)
    got = _leaves(_convert(kind, port_base(kind, v).state_dict()))
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.mark.parametrize("kind", ["ResUNet", "TAPNet16"])
def test_full_width_keys_equal_the_oracle(kind):
    """Every key and shape of the full-width base equals the reference
    layout's oracle, so the reference's checkpoints load by name; the
    oracle's weights load strictly and give the oracle's output (f32,
    32x32, eval mode)."""
    from tests.torch_resunet_ref import ResUnetVBTorch
    from tests.torch_tapnet_ref import TAPNet16Torch

    pm = _port_module(kind, scale=1.0)
    ref = (ResUnetVBTorch(dim=16, out_dim=C, groups=8) if kind == "ResUNet"
           else TAPNet16Torch(C))
    want = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in pm.state_dict().items()}
    assert got == want
    torch.manual_seed(0)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0, 0.02)
    pm.load_state_dict(ref.state_dict(), strict=True)
    xs = [torch.randn(1, 3, 32, 32)]
    if kind == "TAPNet16":
        xs.append(torch.rand(1, 1, 32, 32))
    with torch.no_grad():
        torch.testing.assert_close(pm.eval()(*xs), ref.eval()(*xs), rtol=0,
                                   atol=1e-5)


def test_ternausnet11_keys_are_the_reference_aliases():
    """TernausNet11's encoder views are the reference's single-conv
    aliases (``conv1``, ``conv2``, ``conv3s``, ``conv3``, ..., ``conv5``) of
    ``encoder`` at torchvision's VGG11 indices; its decoder widths are
    TernausNet11's (``dec4`` nf * 4 out)."""
    pm = _port_module("TernausNet11", scale=1.0)
    sd = pm.state_dict()
    for name, idx in (("conv1", 0), ("conv2", 3), ("conv3s", 6),
                      ("conv3", 8), ("conv4s", 11), ("conv4", 13),
                      ("conv5s", 16), ("conv5", 18)):
        assert sd[f"{name}.weight"].data_ptr() == \
            sd[f"encoder.{idx}.weight"].data_ptr()
    assert sd["dec4.block.1.weight"].shape == (1024, 256, 4, 4)
    assert sd["dec3.block.0.conv.weight"].shape == (512, 256 + 256, 3, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_and_ws_conv_match_flax(dtype):
    """``GroupNorm`` is flax's (float32 statistics and normalization, one
    rounding) and ``WSConv2d`` the JAX ``WSConv`` (eps 1e-5 in float32,
    1e-3 in bfloat16): within 1e-5 in float32 (sums in another order; the
    input's mean 5 makes E[y^2] - E[y]^2 cancel ~35 into ~9), one bf16
    step in bfloat16."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from mfcnet_tpu.models.resunet import WSConv
    from mfcnet_tpu_torch.models.common import GroupNorm, WSConv2d

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 9, 11, 8)) * 3 + 5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 8, 6)) * 0.1 + 0.02).astype(
        np.float32)
    kb = rng.normal(0, 0.1, 6).astype(np.float32)

    gn = nn.GroupNorm(num_groups=4, epsilon=1e-5)
    want_gn = np.asarray(jax.jit(gn.apply)(
        {"params": {"scale": jnp.asarray(scale, jdt),
                    "bias": jnp.asarray(bias, jdt)}},
        jnp.asarray(x, jdt)).astype(jnp.float32))
    want_ws = np.asarray(jax.jit(WSConv(6).apply)(
        {"params": {"kernel": jnp.asarray(kernel),
                    "bias": jnp.asarray(kb)}},
        jnp.asarray(x, jdt)).astype(jnp.float32))

    tg = GroupNorm(4, 8).to(tdt)
    ws = WSConv2d(8, 6, 3, padding=1)
    with torch.no_grad():
        tg.weight.copy_(torch.from_numpy(scale))
        tg.bias.copy_(torch.from_numpy(bias))
        ws.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        ws.bias.copy_(torch.from_numpy(kb))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
        got_gn = tg(xt)
        got_ws = ws(xt)
    assert got_gn.dtype == got_ws.dtype == tdt
    got_gn = got_gn.float().permute(0, 2, 3, 1).numpy()
    got_ws = got_ws.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_gn, want_gn, rtol=0, atol=1e-5)
        # outputs of magnitude ~40 (the unit-variance kernel's 72 taps of
        # inputs ~5): float32 sums in another order, 2.5e-6 of that
        np.testing.assert_allclose(got_ws, want_ws, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got_gn, want_gn, rtol=2.0 ** -7,
                                   atol=2.0 ** -7)
        # the float32 kernel standardized with bf16's eps, then the same
        # bf16 convolution: equal within a few bf16 steps of the sums
        np.testing.assert_allclose(got_ws, want_ws, rtol=2.0 ** -6,
                                   atol=2.0 ** -5)
        # the eps by dtype is kept: in float32 with bf16's eps the result
        # moves measurably off the float32 module's
        with torch.no_grad():
            f32 = ws(xt.float())
        assert not torch.allclose(f32, torch.from_numpy(got_ws).permute(
            0, 3, 1, 2), rtol=0, atol=1e-6)


def test_registry_widths_follow_the_jax_rules():
    """``scale`` as the JAX registry reads it: TernausNet11's decoder base
    ``max(4, int(64 s))``; UNet's dims ``max(4, int(d s))``; ResUNet's dim
    ``max(8, int(16 s))`` and 8 groups at s >= 0.5, else 4; TAPNet's
    encoder scaled and its decoder at full width."""
    from mfcnet_tpu_torch.models.common import GroupNorm

    t11 = _port_module("TernausNet11", 0.25)
    assert t11.final.in_channels == 16
    unet = _port_module("UNet", 0.125)
    assert [getattr(unet, f"UNetBlock_{i}").Conv_0.out_channels
            for i in range(6)] == [8, 16, 32, 64, 128, 256]
    for s, dim, groups in ((1.0, 16, 8), (0.5, 8, 8), (0.25, 8, 4)):
        r = _port_module("ResUNet", s)
        gn = [m for m in r.modules() if isinstance(m, GroupNorm)]
        assert r.init_conv.out_channels == dim
        assert {m.num_groups for m in gn} == {groups}
    tap = _port_module("TAPNet16", 0.125)
    assert tap.vgg16[0].out_channels == 8
    assert tap.center.l.conv1.l.conv.out_channels == 512
