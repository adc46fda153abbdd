"""The port's RAFT flow provider and its fused update step against the
JAX package's, with the JAX weights carried across by
``compat.from_jax.raft_state_dict_from_jax`` and the same numpy inputs, at
float32 on the CPU (where the update step's wrapper runs its plain
version). JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them.

Tolerances: float32 convolutions and products summed in another order
(1e-5 .. 5e-5 per module; 2e-5 / 1e-4 for the update step, the JAX test's
own; 1e-3 on the whole model's flow, the COMPONENTS.md gate)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

# jax is imported inside the tests that compare with it: the CUDA-marked
# test runs on a machine that has none

H = W = 64


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(tree, rng):
    for k, x in tree.items():
        if isinstance(x, dict):
            _randomize_bn(x, rng)
        elif k == "mean":
            tree[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 2.0, x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX RAFT, its variables with non-trivial BN statistics, port RAFT
    with the same weights), iters=4."""
    import jax

    from mfcnet_tpu.models.raft import RAFT as JRAFT
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import raft_state_dict_from_jax
    from mfcnet_tpu_torch.models.raft import RAFT

    jm = JRAFT(iters=4)
    d = np.zeros((1, H, W, 3), np.float32)
    v = _np(jit_init(jm, jax.random.PRNGKey(7), d, d))
    _randomize_bn(v["batch_stats"], np.random.default_rng(0))
    pm = RAFT(iters=4).eval()
    pm.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return (rng.random((1, H, W, 3), np.float32) * 2 - 1,
            rng.random((1, H, W, 3), np.float32) * 2 - 1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_state_dict_has_torchvision_raft_large_names(pair):
    """The port's keys are torchvision raft_large's: every key of the
    torch oracle (tests/torch_raft_ref.py, torchvision's module tree) is a
    key of the port with the same shape; the port has, beyond them, only
    the encoder convs' biases, which torchvision's own encoders carry."""
    from tests.torch_raft_ref import RAFTTorch

    ref = RAFTTorch().state_dict()
    port = pair[2].state_dict()
    assert set(ref) <= set(port)
    for k, t in ref.items():
        assert port[k].shape == t.shape, k
    extra = set(port) - set(ref)
    assert extra and all(
        k.endswith(".0.bias") and k.split(".")[0] in
        ("feature_encoder", "context_encoder") for k in extra)


def test_port_matches_torch_oracle_on_its_weights():
    """A state_dict in torchvision's naming loads by name and gives the
    oracle's flow (the oracle's encoder convs have no bias: zeros). At
    128x128: the oracle's grid_sample divides by zero on a 1x1 level."""
    from tests.torch_raft_ref import RAFTTorch

    from mfcnet_tpu_torch.models.raft import RAFT

    torch.manual_seed(0)
    ref = RAFTTorch().eval()
    port = RAFT(iters=3).eval()
    missing = port.load_state_dict(ref.state_dict(), strict=False)
    assert not missing.unexpected_keys
    with torch.no_grad():
        for k in missing.missing_keys:
            port.state_dict()[k].zero_()
        rng = np.random.default_rng(9)
        a, b = (_t(rng.random((1, 128, 128, 3), np.float32) * 2 - 1)
                for _ in range(2))
        want = ref(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2),
                   num_flow_updates=3)[-1].permute(0, 2, 3, 1)
        got = port(a, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["features", "context"])
def test_encoders_match_jax(pair, images, method):
    jm, v, pm = pair
    want = jm.apply(v, images[0], method=method)
    with torch.no_grad():
        got = getattr(pm, method)(_t(images[0]))
    if method == "features":
        want, got = [want], [got]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-5)


@pytest.mark.parametrize("hw", [(8, 8), (15, 20), (4, 4)])
def test_corr_pyramid_matches_jax(hw):
    """Levels, the dropped odd row/column and the stop before a
    zero-sized level."""
    from mfcnet_tpu.models.raft import build_corr_pyramid as jbuild
    from mfcnet_tpu_torch.models.raft import (
        build_corr_pyramid,
        num_corr_levels,
    )

    rng = np.random.default_rng(1)
    f1 = rng.standard_normal((2, *hw, 32)).astype(np.float32)
    f2 = rng.standard_normal((2, *hw, 32)).astype(np.float32)
    want = jbuild(f1, f2, 4)
    got = build_corr_pyramid(_t(f1), _t(f2), 4)
    assert len(got) == len(want) == num_corr_levels(*hw, 4)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("spread", [0.7, 6.0])
def test_lookup_corr_matches_jax(spread):
    """Window samples, channel order x slow / y fast, zeros outside the
    map (spread 6 sends many windows over the border)."""
    import jax.numpy as jnp

    from mfcnet_tpu.models.raft import build_corr_pyramid as jbuild
    from mfcnet_tpu.models.raft import lookup_corr as jlookup
    from mfcnet_tpu_torch.models.raft import lookup_corr

    rng = np.random.default_rng(2)
    B, H8, W8 = 2, 9, 13
    f1 = rng.standard_normal((B, H8, W8, 16)).astype(np.float32)
    f2 = rng.standard_normal((B, H8, W8, 16)).astype(np.float32)
    pyr = jbuild(f1, f2, 4)
    xs, ys = np.meshgrid(np.arange(W8), np.arange(H8))
    coords = (np.stack([xs, ys], -1)[None]
              + rng.normal(0, spread, (B, H8, W8, 2))).astype(np.float32)
    want = np.asarray(jlookup(pyr, jnp.asarray(coords), 4))
    got = lookup_corr([_t(p) for p in pyr], _t(coords), 4)
    assert got.shape == want.shape == (B, H8, W8, len(pyr) * 81)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _update_inputs(B=2, H8=9, W8=13, L=4, seed=0):
    rng = np.random.default_rng(seed)
    corr = rng.standard_normal((B, H8, W8, L * 81)).astype(np.float32)
    inp = np.maximum(rng.standard_normal((B, H8, W8, 128)), 0).astype(
        np.float32)
    net = np.tanh(rng.standard_normal((B, H8, W8, 128))).astype(np.float32)
    flow = rng.standard_normal((B, H8, W8, 2)).astype(np.float32)
    return corr, inp, net, flow


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def test_update_block_matches_jax(pair):
    from mfcnet_tpu.models.raft import UpdateBlock as JUpdate

    _, v, pm = pair
    corr, inp, net, flow = _update_inputs()
    wn, wd, wm = JUpdate().apply(
        {"params": v["params"]["update_block"]}, net, inp, corr, flow)
    with torch.no_grad():
        gn, gd = pm.update_block(_nchw(net), _nchw(inp), _nchw(corr),
                                 _nchw(flow))
        gm = pm.mask_predictor(gn)
    for g, w in ((gn, wn), (gd, wd), (gm, wm)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=2e-5)


def test_convex_upsample_matches_jax():
    from mfcnet_tpu.models.raft import convex_upsample as jup
    from mfcnet_tpu_torch.models.raft import convex_upsample

    rng = np.random.default_rng(3)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    got = convex_upsample(_t(flow), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(jup(flow, mask)),
                               rtol=0, atol=1e-5)


def test_raft_matches_jax(pair, images):
    jm, v, pm = pair
    want = np.asarray(jm.apply(v, *images))
    with torch.no_grad():
        got = pm(_t(images[0]), _t(images[1])).numpy()
    assert got.shape == want.shape == (1, H, W, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------- fused update step
def _tok(a):
    return _t(a).reshape(a.shape[0], -1, a.shape[-1]).contiguous()


def test_pack_update_weights_layout(pair):
    from mfcnet_tpu_torch.ops.raft_update import (
        _KMAJOR_NAMES,
        _WEIGHT_NAMES,
        pack_update_weights,
    )

    packed = pack_update_weights(pair[2].update_block, torch.bfloat16)
    # a pack also holds every weight K-major as the kernel reads it: the
    # bfloat16 weight, or the float32 weight's split into a TF32 part and
    # the rest
    assert set(packed) == set(_WEIGHT_NAMES) | set(
        _KMAJOR_NAMES[torch.bfloat16])
    f32 = pack_update_weights(pair[2].update_block, torch.float32)
    assert set(f32) == set(_WEIGHT_NAMES) | set(_KMAJOR_NAMES[torch.float32])
    for k in _KMAJOR_NAMES[torch.bfloat16]:
        if k.startswith("wt_"):
            assert torch.equal(packed[k],
                               packed["w_" + k[3:]].transpose(1, 2))
    for k in _KMAJOR_NAMES[torch.float32]:
        if k.startswith("wtb_"):
            c = k[4:]
            assert f32[k].dtype == f32["wts_" + c].dtype == torch.float32
            assert f32[k].is_contiguous() and f32["wts_" + c].is_contiguous()
            assert torch.equal(f32[k] + f32["wts_" + c],
                               f32["w_" + c].transpose(1, 2))
    shapes = {k: tuple(t.shape) for k, t in packed.items()}
    assert shapes["w_c2"] == (9, 256, 192) and shapes["w_f2"] == (9, 128, 64)
    assert shapes["w_cv"] == (9, 256, 128) and shapes["w_fl2"] == (9, 256, 16)
    assert shapes["w_zr_h"] == (5, 384, 256) == shapes["w_zr_v"]
    assert shapes["w_q_h"] == (5, 384, 128) and shapes["w_fl1"] == (9, 128, 256)
    for k, t in packed.items():
        assert t.dtype == (torch.bfloat16 if k[0] == "w" else torch.float32)
        assert t.is_contiguous() and not t.requires_grad
    # the padding columns are zero: y's 126..127, the flow head's 2..15
    assert not packed["w_cv"][..., 126:].any()
    assert not packed["w_fl2"][..., 2:].any()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pack_update_weights(pair[2].update_block, torch.float16)


def test_fused_update_step_matches_jax_kernel_and_update_block(pair):
    """raft_update (plain version on the CPU) == the JAX fused step with
    its Pallas kernel in interpret mode == the JAX UpdateBlock, float32,
    on an uneven 2x9x13 token grid."""
    import jax.numpy as jnp

    from mfcnet_tpu.models.raft import UpdateBlock as JUpdate
    from mfcnet_tpu.ops.raft_update_pallas import fused_update_step as jstep
    from mfcnet_tpu.ops.raft_update_pallas import pack_update_weights as jpack
    from mfcnet_tpu_torch.ops.raft_update import (
        fused_update_step,
        pack_update_weights,
    )

    _, v, pm = pair
    ub = v["params"]["update_block"]
    corr, inp, net, flow = _update_inputs()
    B, H8, W8, _ = corr.shape
    wn, wd, _ = JUpdate().apply({"params": ub}, net, inp, corr, flow)
    kn, kd = jstep(ub, jpack(ub, compute_dtype=jnp.float32), corr, inp, net,
                   flow, compute_dtype=jnp.float32, interpret=True)
    packed = pack_update_weights(pm.update_block, torch.float32)
    with torch.no_grad():
        gn, gd = fused_update_step(pm.update_block, packed, _tok(corr),
                                   _tok(inp), _tok(net), _tok(flow), H8, W8)
    gn = gn.reshape(B, H8, W8, 128).numpy()
    gd = gd.reshape(B, H8, W8, 2).numpy()
    for want_n, want_d in ((wn, wd), (kn, kd)):
        np.testing.assert_allclose(gn, np.asarray(want_n), rtol=1e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(gd, np.asarray(want_d), rtol=1e-4,
                                   atol=2e-5)


def test_raft_update_bf16_rounding_points_match_jax_kernel(pair):
    """bfloat16 operands: the same c1/f1 go through the JAX Pallas kernel
    (interpret mode, compute_dtype=bfloat16) and the port's plain version.
    Both round c2, f2, y, net, r*net and the flow head's hidden layer to
    bf16 and accumulate in float32; float32 sums in another order can
    flip a bf16 rounding, one ulp of an O(1) operand (2^-8), which the
    next product carries on. Envelope: 2e-3 on net' (|net| <= 1) and
    on the flow delta."""
    import jax.numpy as jnp

    from mfcnet_tpu.ops.raft_update_pallas import pack_update_weights as jpack
    from mfcnet_tpu.ops.raft_update_pallas import raft_update_pallas
    from mfcnet_tpu_torch.ops.raft_update import (
        pack_update_weights,
        raft_update,
    )

    _, v, pm = pair
    ub = v["params"]["update_block"]
    rng = np.random.default_rng(4)
    B, H8, W8 = 2, 9, 13
    c1 = np.maximum(rng.standard_normal((B, H8, W8, 256)), 0).astype(
        np.float32)
    f1 = np.maximum(rng.standard_normal((B, H8, W8, 128)), 0).astype(
        np.float32)
    _, inp, net, flow = _update_inputs(seed=6)
    kn, kd = raft_update_pallas(
        jnp.asarray(c1), jnp.asarray(f1), jnp.asarray(inp), jnp.asarray(net),
        jnp.asarray(flow), jpack(ub, compute_dtype=jnp.bfloat16), H8, W8,
        compute_dtype=jnp.bfloat16, interpret=True)
    packed = pack_update_weights(pm.update_block, torch.bfloat16)
    gn, gd = raft_update(_tok(c1).bfloat16(), _tok(f1).bfloat16(),
                         _tok(inp).bfloat16(), _tok(net), _tok(flow), packed,
                         H8, W8)
    assert gn.dtype == gd.dtype == torch.float32
    dn = np.abs(gn.reshape(B, H8, W8, 128).numpy() - np.asarray(kn)).max()
    dd = np.abs(gd.reshape(B, H8, W8, 2).numpy() - np.asarray(kd)).max()
    assert dn <= 2e-3 and dd <= 2e-3, (dn, dd)


def test_fused_flow_from_features_matches_jax(pair, images):
    import jax.numpy as jnp

    from mfcnet_tpu.ops.raft_update_pallas import (
        fused_flow_from_features as jfused,
    )
    from mfcnet_tpu_torch.ops.raft_update import fused_flow_from_features

    jm, v, pm = pair
    f1 = jm.apply(v, images[0], method="features")
    f2 = jm.apply(v, images[1], method="features")
    net, inp = jm.apply(v, images[0], method="context")
    want = np.asarray(jfused(v, f1, f2, net, inp, iters=4,
                             compute_dtype=jnp.float32, interpret=True))
    with torch.no_grad():
        got = fused_flow_from_features(
            pm, _t(f1), _t(f2), _t(net), _t(inp), iters=4,
            compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)
    # the model's own switch takes the same path
    pm.fused_update, pm.fused_dtype = True, "float32"
    try:
        with torch.no_grad():
            again = pm.flow_from_features(_t(f1), _t(f2), _t(net), _t(inp))
    finally:
        pm.fused_update = False
    np.testing.assert_array_equal(again.numpy(), got)


def test_raft_update_rejects_gradients_and_bad_inputs(pair):
    from mfcnet_tpu_torch.ops.raft_update import (
        pack_update_weights,
        raft_update,
    )

    packed = pack_update_weights(pair[2].update_block, torch.float32)
    B, H8, W8 = 1, 3, 4
    N = H8 * W8
    c1, f1, inp = (torch.zeros(B, N, c) for c in (256, 128, 128))
    net, flow = torch.zeros(B, N, 128), torch.zeros(B, N, 2)
    raft_update(c1, f1, inp, net, flow, packed, H8, W8)
    with pytest.raises(NotImplementedError, match="fused_update=False"):
        raft_update(c1, f1, inp, net.clone().requires_grad_(), flow, packed,
                    H8, W8)
    with pytest.raises(ValueError, match="tokens"):
        raft_update(c1, f1, inp, net, flow, packed, H8, W8 + 1)
    with pytest.raises(TypeError, match="c1"):
        raft_update(c1.bfloat16(), f1, inp, net, flow, packed, H8, W8)
    with pytest.raises(ValueError, match="contiguous"):
        raft_update(c1, f1, inp, torch.zeros(B, N, 256)[..., :128], flow,
                    packed, H8, W8)


def _solve(packed, c1s, f1s, inp, net, flow, H8, W8, workspace):
    """A short recurrent solve around ``raft_update`` as
    ``fused_flow_from_features`` runs it; returns every call's results."""
    from mfcnet_tpu_torch.ops.raft_update import raft_update

    outs = []
    for c1, f1 in zip(c1s, f1s):
        net, delta = raft_update(c1, f1, inp, net, flow, packed, H8, W8,
                                 workspace=workspace)
        flow = flow + delta
        outs.append((net.clone(), delta.clone()))
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raft_update_workspace_equals_per_call_allocation(pair, dtype):
    """A solve through one reused workspace equals per-call allocation
    exactly (plain route), over 3 iterations and two successive solves of
    different sizes; the caller's ``net`` is never written; ``[net | inp]``
    is written into hx once per solve."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    packed = ru.pack_update_weights(pair[2].update_block, dtype)
    rng = np.random.default_rng(11)
    for B, H8, W8 in ((1, 5, 6), (2, 3, 4)):
        N = H8 * W8

        def t(cols, dt=torch.float32):
            return torch.from_numpy(rng.standard_normal(
                (B, N, cols)).astype(np.float32)).to(dt)

        c1s = [torch.relu(t(256, dtype)) for _ in range(3)]
        f1s = [torch.relu(t(128, dtype)) for _ in range(3)]
        inp, net, flow = torch.relu(t(128, dtype)), torch.tanh(t(128)), t(2)
        net_before = net.clone()
        want = _solve(packed, c1s, f1s, inp, net, flow, H8, W8, None)
        ru.reset_launches()
        ws = ru.UpdateWorkspace(B, H8, W8, packed, "cpu")
        got = _solve(packed, c1s, f1s, inp, net, flow, H8, W8, ws)
        assert ru.COUNTS["hx_fills"] == 1 and ru.LAUNCHES["raft_update"] == 0
        for (gn, gd), (wn, wd) in zip(got, want):
            assert torch.equal(gn, wn) and torch.equal(gd, wd)
        assert torch.equal(net, net_before)
        # a state the workspace did not return (or one changed since) is
        # written into hx again
        ru.raft_update(c1s[0], f1s[0], inp, got[-1][0], flow, packed, H8, W8,
                       workspace=ws)
        assert ru.COUNTS["hx_fills"] == 2
    with pytest.raises(ValueError, match="workspace for"):
        ru.raft_update(c1s[0], f1s[0], inp, net, flow, packed, H8, W8,
                       workspace=ru.UpdateWorkspace(1, 5, 6, packed, "cpu"))


def test_raft_update_workspace_outputs_take_turns(pair):
    """A call never writes the pair it returned last nor its own input
    state: results stay valid until the call after the next."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    packed = ru.pack_update_weights(pair[2].update_block, torch.float32)
    B, H8, W8 = 1, 3, 4
    g = torch.Generator().manual_seed(3)
    c1, f1, inp = (torch.rand(B, 12, c, generator=g) for c in (256, 128, 128))
    net, flow = torch.rand(B, 12, 128, generator=g), torch.zeros(B, 12, 2)
    ws = ru.UpdateWorkspace(B, H8, W8, packed, "cpu")
    n1, d1 = ru.raft_update(c1, f1, inp, net, flow, packed, H8, W8, ws)
    keep = n1.clone()
    n2, d2 = ru.raft_update(c1, f1, inp, n1, flow, packed, H8, W8, ws)
    assert n2 is not n1 and d2 is not d1 and torch.equal(n1, keep)
    # an older state handed in again is not overwritten either
    n3, _ = ru.raft_update(c1, f1, inp, n1, flow, packed, H8, W8, ws)
    assert n3 is not n1 and torch.equal(n1, keep)


@pytest.mark.parametrize("shape,config,tile,clusters", [
    ((1, 2, 2), "clusters", (2, 2), (8,) * 8),
    ((2, 9, 13), "clusters", (9, 13), (8,) * 8),
    ((2, 30, 40), "clusters", (3, 40), (2, 8, 5, 8, 5, 8, 5, 8)),
    ((8, 60, 80), "tiles", (3, 40), (1,) * 8),
    ((1, 5, 300), "clusters", (5, 25), (4, 8, 8, 8, 8, 8, 8, 8)),
    ((16, 30, 40), "tiles", (3, 40), (1,) * 8),
])
def test_raft_update_tile_plan_covers_every_token_once(shape, config, tile,
                                                       clusters):
    """The host-side tile plan of the wgmma design is a pure function of
    the shape: the configuration from the block counts, tiles of whole or
    x-segmented image rows within what a block multiplies (128 tokens) and
    a TMA box holds (256 per side), every token in exactly one tile, the
    column tiles of every launch covering its output columns, and clusters
    that split a tile's taps while a launch has fewer blocks than the
    card wants."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    B, H8, W8 = shape
    plan = ru.tile_plan(B, H8, W8)
    assert plan == ru.tile_plan(B, H8, W8)
    assert plan.config == config and (plan.rows, plan.cols) == tile
    assert plan.clusters == clusters
    assert plan.rows * plan.cols <= ru.TILE_TOKENS
    assert 1 <= plan.rows <= min(H8, 256) and 1 <= plan.cols <= min(W8, 256)
    seen = np.zeros((H8, W8), np.int64)
    tiles = plan.tiles()
    assert len(tiles) == plan.tiles_y * plan.tiles_x
    for (y0, y1), (x0, x1) in tiles:
        seen[y0:min(y1, H8), x0:min(x1, W8)] += 1
    assert (seen == 1).all()
    # launch i: c2 || f2 (192 + 64 columns), cv 128, zr 256, q 128, zr, q,
    # fl1 256, fl2 16; the fewest pipeline steps of a launch's tiles (f2's
    # 9 taps x 2 slices of 64 channels, ...) bound its cluster
    cols = (256, 128, 256, 128, 256, 128, 256, 16)
    steps = (18, 36, 30, 30, 30, 30, 18, 36)
    for n, width, count, cl, st in zip(cols, plan.column_widths,
                                       plan.column_tiles, plan.clusters,
                                       steps):
        assert width in (16, 64, 128, 256) and width * count == n
        assert 1 <= cl <= min(ru.MAX_CLUSTER, st)
        blocks = B * len(tiles) * count
        assert cl == 1 or blocks * cl <= ru.TARGET_BLOCKS


def test_raft_update_tile_plan_limits():
    from mfcnet_tpu_torch.ops import raft_update as ru

    with pytest.raises(ValueError, match="32-bit index limit"):
        ru.tile_plan(ru.MAX_TOKENS // 4800 + 1, 60, 80)
    with pytest.raises(ValueError, match="empty grid"):
        ru.tile_plan(1, 0, 4)
    # 100 token tiles: the widest launches' 200 blocks leave no room to split
    assert ru.tile_plan(10, 30, 40).config == "clusters"
    assert ru.tile_plan(11, 30, 40).config == "tiles"


@pytest.mark.cuda
def test_cuda_raft_update_kernel_matches_plain_version():
    """The CUDA kernel against its plain version (run with
    ``python -m pytest tests/test_torch_raft.py -m cuda --noconftest`` on
    a GPU): the float32 instance (three TF32 products) to the JAX test's
    tolerance, the bfloat16 instance to the rounding-flip envelope."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru

    torch.manual_seed(0)
    ub = UpdateBlock().cuda().eval()
    for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-3)):
        packed = ru.pack_update_weights(ub, dt)
        _, inp, net, flow = _update_inputs(seed=8)
        c1 = torch.relu(torch.randn(2, 117, 256)).cuda().to(dt)
        f1 = torch.relu(torch.randn(2, 117, 128)).cuda().to(dt)
        args = (c1, f1, _tok(inp).cuda().to(dt), _tok(net).cuda(),
                _tok(flow).cuda(), packed, 9, 13)
        ru.reset_launches()
        got = ru.raft_update(*args)
        assert ru.LAUNCHES["raft_update"] == 1
        assert ru.COUNTS["wgmma"] == 1
        want = ru.raft_update_plain(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=atol)
    torch.cuda.synchronize()


# ---------------------------------- the float32 route's split and plan
@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_split_tf32_is_exact_and_big_is_tf32(scale):
    """w = big + small exactly; big keeps 10 explicit mantissa bits (its
    low 13 bits are zero) and is w rounded to the nearest such value
    (ties away from zero), so |small| <= 2^-11 |w|; the kernel splits its
    activations by the same integer operations."""
    from mfcnet_tpu_torch.ops.raft_update import split_tf32

    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal(4099) * scale).astype(
        np.float32))
    w[:3] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11])  # a tie: away
    big, small = split_tf32(w)
    assert torch.equal(big + small, w)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert bool((small.abs() <= 2.0 ** -11 * w.abs()).all())
    assert big[2].item() == 1.0 + 2.0 ** -10
    # the nearest: no other value with 10 mantissa bits is closer
    up = (big.view(torch.int32) + 0x2000).view(torch.float32)
    dn = (big.view(torch.int32) - 0x2000).view(torch.float32)
    nz = w != 0
    assert bool(((w - big).abs()[nz] <= (w - up).abs()[nz]).all())
    assert bool(((w - big).abs()[nz] <= (w - dn).abs()[nz]).all())
    with pytest.raises(TypeError, match="float32"):
        split_tf32(w.double())


def _c_tile_plan(B, H8, W8, target, widths, mt=128, max_box=256,
                 max_cluster=8):
    """``csrc/raft_update.cu::tile_plan_of``, line for line in C's integer
    arithmetic: the 18 ints the C side demands."""
    best, rows, cols = -1, 0, 0
    widest = min(mt, max_box)
    for nx in range(1, W8 + 1):
        c = (W8 + nx - 1) // nx
        if c > widest:
            continue
        r = min(mt // c, H8, max_box)
        n = ((H8 + r - 1) // r) * ((W8 + c - 1) // c)
        if best < 0 or n < best:
            best, rows, cols = n, r, c
        if c == 1:
            break
    tiles = B * ((H8 + rows - 1) // rows) * ((W8 + cols - 1) // cols)
    conv_n = (192, 64, 128, 256, 128, 256, 128, 256, 16)
    stage = (0, 0, 1, 2, 3, 4, 5, 6, 7)
    ct = [0] * 8
    for n, st in zip(conv_n, stage):
        ct[st] += n // widths[st]
    return (rows, cols, *widths,
            *(max(1, min(max_cluster, target // (tiles * c))) for c in ct))


def test_raft_update_tile_plan_is_the_c_sides():
    """The C side recomputes the plan (``tile_plan_of``) and refuses any
    other for the float32 route: its constants are Python's, and its loop,
    transcribed, gives Python's 18 ints over a range of shapes."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    src = (Path(ru.__file__).resolve().parents[1] / "csrc"
           / "raft_update.cu").read_text()
    m = re.search(r"constexpr int COLUMN_WIDTHS\[N_STAGES\] = \{([^}]*)\};",
                  src)
    widths = tuple(int(v) for v in m.group(1).split(","))
    assert re.search(r"constexpr int TARGET_BLOCKS = (\d+);", src).group(1) \
        == str(ru.TARGET_BLOCKS)
    assert re.search(r"constexpr int MAX_CLUSTER = (\d+);", src).group(1) \
        == str(ru.MAX_CLUSTER)
    assert re.search(r"constexpr int MAX_BOX = (\d+);", src).group(1) == "256"
    assert "constexpr int MT = 64 * NWG;" in src and "constexpr int NWG = 2;" \
        in src and ru.TILE_TOKENS == 128
    assert "if (tile[i] != want[i]) return ERR_PLAN;" in src
    for B, H8, W8 in ((1, 1, 1), (1, 2, 2), (2, 9, 13), (2, 30, 40),
                      (8, 60, 80), (1, 5, 300), (16, 30, 40), (3, 1, 257),
                      (1, 129, 1), (4, 17, 129), (11, 30, 40), (2, 64, 64)):
        p = ru.tile_plan(B, H8, W8)
        assert p.column_widths == widths
        assert (p.rows, p.cols, *p.column_widths, *p.clusters) == \
            _c_tile_plan(B, H8, W8, ru.TARGET_BLOCKS, widths), (B, H8, W8)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 9, 13), (2, 30, 40),
                                   (8, 60, 80), (1, 5, 300), (16, 30, 40)])
def test_raft_update_f32_tile_plan_covers_every_token_once(shape):
    """The float32 route runs on the same plan as the bfloat16 one (the
    workspace makes it for either type): every token in exactly one tile,
    and no cluster splits a tile into more blocks than the launch's
    fewest pipeline steps, which for float32 are 32 channels (the C side
    refuses more)."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    B, H8, W8 = shape
    plan = ru.tile_plan(B, H8, W8)
    ws = ru.UpdateWorkspace(B, H8, W8, {"w_c2": torch.zeros(1)}, "cpu")
    assert ws.plan == plan and ws.design == "3xtf32"
    seen = np.zeros((H8, W8), np.int64)
    for (y0, y1), (x0, x1) in plan.tiles():
        seen[y0:min(y1, H8), x0:min(x1, W8)] += 1
    assert (seen == 1).all()
    # a launch's fewest steps: f2's 9 taps x 128 channels / 32, cv's 9 x
    # 256 / 32, the GRU's 5 x 384 / 32, fl1's 9 x 128 / 32, fl2's 9 x 256 / 32
    steps = (36, 72, 60, 60, 60, 60, 36, 72)
    for cl, st in zip(plan.clusters, steps):
        assert 1 <= cl <= min(ru.MAX_CLUSTER, st)
    src = (Path(ru.__file__).resolve().parents[1] / "csrc"
           / "raft_update.cu").read_text()
    assert "CONV_TAPS[i] * CONV_K[i] / (dtype == DT_F32 ? 32 : 64))" in src


def test_raft_update_f32_tile_plan_refusals():
    """What the C side refuses (``tile_plan_of`` returns false), the plan
    refuses first: an empty grid, a grid beyond the kernel's 32-bit
    indices."""
    from mfcnet_tpu_torch.ops import raft_update as ru

    with pytest.raises(ValueError, match="32-bit index limit"):
        ru.tile_plan(ru.MAX_TOKENS // 4800 + 1, 60, 80)
    with pytest.raises(ValueError, match="empty grid"):
        ru.tile_plan(2, 3, 0)
    with pytest.raises(ValueError, match="empty grid"):
        ru.tile_plan(1, 0, 5)
    src = (Path(ru.__file__).resolve().parents[1] / "csrc"
           / "raft_update.cu").read_text()
    assert ("if (B < 1 || H8 < 1 || W8 < 1 || (long long)B * H8 * W8 > "
            "MAX_TOKENS)") in src
    assert "constexpr long long MAX_TOKENS = 2147483647LL / HX;" in src
    assert ru.MAX_TOKENS == (2 ** 31 - 1) // 384
