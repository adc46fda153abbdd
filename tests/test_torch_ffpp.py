"""The port's FlowFormer++ (``mfcnet_tpu_torch/models/flowformerpp.py``)
against the JAX package's on the same weights and numpy inputs, on the CPU:
module by module (the twins encoders, the cost perceiver, one decoder
iteration, the whole forward) at narrow widths, the forward against its
split methods, the default widths with 12 iterations, the torch oracle of
``tests/torch_ffpp_ref.py`` loaded under the reference's key names, the
scope rules, and the bfloat16 model against the JAX bfloat16 model.

Weights: a JAX parameter tree of ``FlowFormerPP`` (its shapes from
``jax.eval_shape`` of the JAX init, which takes ~20 s to compile at any
width) filled from a seeded numpy generator: lecun-normal kernels as flax
draws them, and every bias, LayerNorm parameter and ``gamma`` non-zero
(flax starts them at 0 or 1, which would leave the GMA aggregation and
the norms' affine parts untested); carried across with
``compat.from_jax.ffpp_state_dict_from_jax``.

Tolerances (float32): 1e-4 absolute and relative on the narrow model's
flow and on each module's output (sums in another order); 2e-3 / 1e-3 at
the default widths with 12 iterations, the JAX-versus-oracle tolerance of
``tests/test_compat.py``; 1e-4 against the oracle. 48x80 frames: H/4 = 12
is no multiple of sr = 8 (the GSA drops the last 4 token rows, as at the
engine's 240x320) and H/8 = 6 no multiple of the 7x7 window (padding)."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

HW = (48, 80)
NARROW = dict(enc_dims=(16, 32), latent_dim=16, query_dim=8)
ATOL = RTOL = 1e-4


def jax_variables(seed: int, flow_gain: float = 0.1, **kw):
    """A seeded JAX variable tree of ``FlowFormerPP(**kw)`` (see the module
    docstring); the flow head's last kernel scaled by ``flow_gain`` so that
    the random flows stay within a few pixels."""
    import jax

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    z = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(FlowFormerPP(iters=1, **kw).init,
                            jax.random.PRNGKey(0), z, z)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            a = rng.normal(0.0, std, s.shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, s.shape)
        elif name == "latent_tokens":
            a = rng.normal(0.0, 1.0, s.shape)
        elif name == "gamma":
            a = np.full(s.shape, 0.5)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    v["params"]["update_block"]["flow2"]["kernel"] *= flow_gain
    return v


def port_model(v, **kw):
    from mfcnet_tpu_torch.compat.from_jax import ffpp_state_dict_from_jax
    from mfcnet_tpu_torch.models.flowformerpp import FlowFormerPP

    m = FlowFormerPP(**kw).eval()
    m.load_state_dict(ffpp_state_dict_from_jax(v), strict=True)
    return m


@pytest.fixture(scope="module")
def narrow():
    """(JAX variables, the port's model with iters=2) at narrow widths."""
    v = jax_variables(1, **NARROW)
    return v, port_model(v, iters=2, **NARROW)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(2)
    return tuple(rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32)
                 for _ in range(2))


_JAX = {}


def jax_forward(v, a, b, iters=2, dtype=None):
    """The JAX model's flow (float32 numpy), one jitted function per
    configuration for the module."""
    import jax
    import jax.numpy as jnp

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    key = ("forward", iters)
    if key not in _JAX:
        _JAX[key] = jax.jit(FlowFormerPP(iters=iters, **NARROW).apply)
    if dtype is not None:
        v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), v)
        a, b = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    return np.asarray(_JAX[key](v, a, b), np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("method", ["features", "context"])
def test_twins_encoders_match_jax(narrow, images, method):
    """Both twins encoders: 12x20 stage-1 tokens (sr = 8 keeps 1x2), 6x10
    stage-2 tokens (7x7 windows over a padded 7x14 grid)."""
    import jax

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    v, pm = narrow
    want = jax.jit(lambda v, x: FlowFormerPP(**NARROW).apply(
        v, x, method=method))(v, images[0])
    with torch.no_grad():
        got = getattr(pm, method)(torch.from_numpy(images[0]))
    if method == "context":
        want, got = want[0], got[0]
        assert pm.context(torch.from_numpy(images[0]))[1].shape == (2, 1, 1, 1)
    _close(got, np.asarray(want))


def test_cost_perceiver_matches_jax(narrow):
    """The perceiver on a random cost volume and context: patch embed,
    latents, 3x (self-attention, vertical local and global blocks) and the
    shortcut; the memory (B*H1*W1, 8, latent_dim)."""
    import jax

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    v, pm = narrow
    rng = np.random.default_rng(3)
    h1, w1 = HW[0] // 8, HW[1] // 8
    cost = rng.normal(0, 4, (2, h1, w1, h1, w1)).astype(np.float32)
    ctx = rng.normal(0, 1, (2, h1, w1, 32)).astype(np.float32)
    want, _ = jax.jit(lambda v, c, x: FlowFormerPP(**NARROW).apply(
        v, c, x, method=lambda m, c, x: m.cost_perceiver(c, x)))(v, cost, ctx)
    with torch.no_grad():
        got = pm.memory_encoder.cost_perceiver_encoder(
            torch.from_numpy(cost).reshape(2, h1 * w1, h1, w1),
            torch.from_numpy(ctx))
    _close(got, np.asarray(want))


def test_one_decoder_iteration_matches_jax(narrow):
    """``flow_from_features`` with one iteration from random features and
    context: the cost volume, the perceiver, one decoder iteration (local
    cost, cross-attention, GMA, GRU, flow head) and the mask head."""
    import jax

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    v, pm = narrow
    rng = np.random.default_rng(4)
    f1, f2, ctx = (rng.normal(0, 0.5, (2, HW[0] // 8, HW[1] // 8, 32)
                              ).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda v, *a: FlowFormerPP(iters=1, **NARROW).apply(
        v, *a, method="flow_from_features"))(v, f1, f2, ctx)
    pm.iters = 1
    try:
        with torch.no_grad():
            got = pm.flow_from_features(*map(torch.from_numpy, (f1, f2, ctx)))
    finally:
        pm.iters = 2
    assert np.abs(np.asarray(want)).max() > 0.1
    _close(got, np.asarray(want))


def test_forward_matches_jax(narrow, images):
    v, pm = narrow
    want = jax_forward(v, *images)
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, images))
    assert got.dtype == torch.float32
    assert 0.5 < np.abs(want).max() < 50  # a flow of pixels, not noise
    _close(got, want)


def test_forward_equals_split_methods_pair_by_pair(narrow, images):
    """The batched forward against ``features`` / ``context`` /
    ``flow_from_features`` on one pair at a time (1e-5: batched
    convolutions and products sum in another order)."""
    _, pm = narrow
    a, b = map(torch.from_numpy, images)
    with torch.no_grad():
        want = pm(a, b)
        for k in range(2):
            ctx, ph = pm.context(a[k:k + 1])
            got = pm.flow_from_features(pm.features(a[k:k + 1]),
                                        pm.features(b[k:k + 1]), ctx, ph)
            torch.testing.assert_close(got, want[k:k + 1], rtol=0, atol=1e-5)


def test_default_widths_12_iterations_match_jax():
    """enc_dims (128, 256), latent_dim 128, 8 latents, query_dim 64,
    vert_c_dim 64, perceiver depth 3, cost_embed_dim 64, 12 iterations, at
    64x64 (the 7x7 windows pad the 8x8 token grid)."""
    import jax

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    v = jax_variables(5)
    pm = port_model(v)
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.jit(FlowFormerPP().apply)(v, a, b))
    with torch.no_grad():
        got = pm(torch.from_numpy(a), torch.from_numpy(b))
    assert pm.iters == 12 and np.abs(want).max() > 0.5
    _close(got, want, atol=2e-3, rtol=1e-3)


def test_state_dict_round_trips_through_the_jax_converter():
    """The port's state dict -> ``torch_convert.convert_flowformerpp`` ->
    ``ffpp_state_dict_from_jax`` is the same state dict, key for key."""
    from mfcnet_tpu.compat.torch_convert import convert_flowformerpp
    from mfcnet_tpu_torch.compat.from_jax import ffpp_state_dict_from_jax
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        init_ffpp_weights,
    )

    pm = init_ffpp_weights(FlowFormerPP(), torch.Generator().manual_seed(0))
    sd = pm.state_dict()
    back = ffpp_state_dict_from_jax(convert_flowformerpp(
        {k: t.numpy() for k, t in sd.items()}))
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k


def test_oracle_state_dict_loads_by_name():
    """``tests/torch_ffpp_ref.py``'s reference-named state dict (with a
    DataParallel ``module.`` prefix) loads strictly: exactly the GMA
    ``pos_emb`` tables are dropped, and the flow equals the oracle's."""
    from tests.torch_ffpp_ref import FlowFormerTorch

    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        load_reference_state_dict,
    )

    torch.manual_seed(23)
    oracle = FlowFormerTorch(decoder_depth=2).eval()
    pm = FlowFormerPP(iters=2).eval()
    dropped = load_reference_state_dict(
        pm, {f"module.{k}": t for k, t in oracle.state_dict().items()})
    assert dropped == ["memory_decoder.att.pos_emb.rel_height.weight",
                       "memory_decoder.att.pos_emb.rel_width.weight"]
    rng = np.random.default_rng(23)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (1, *HW, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        want = oracle(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
        got = pm(a, b)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-4,
                               atol=1e-4)
    # a key the port does not know, outside the dropped sets, fails
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_reference_state_dict(pm, {**oracle.state_dict(),
                                       "memory_decoder.extra.weight":
                                           torch.zeros(1)})


# ------------------------------------------------------------ scope rules
REJECTED = [
    ("vertical_encoder_attn", "NA"), ("vertical_encoder_attn", "NA-twins"),
    ("gma", "GMA-SK"), ("gma", None), ("use_patch", True), ("r_16", 16),
    ("quater_refine", True), ("pretrain_mode", True), ("use_rpe", True),
    ("flow_or_pe", "pe"), ("cross_attn", "rep"), ("pe", "exp"),
    ("patch_embed", "double"), ("use_convertor", True),
    ("detach_local", True), ("no_sc", True), ("cost_heads_num", 2),
    ("dropout", 0.1), ("droppath", 0.1), ("cost_encoder_res", False),
]


@pytest.mark.parametrize("knob,val", REJECTED)
def test_validate_reference_config_refuses(knob, val):
    """The same refusals and messages as the JAX package's, nested and
    flat, and the defaults accepted."""
    from mfcnet_tpu.models import flowformerpp as jffpp
    from mfcnet_tpu_torch.models.flowformerpp import (
        validate_reference_config,
    )

    for cfg in ({"percostformer3": {knob: val}}, {knob: val}):
        with pytest.raises(NotImplementedError, match=knob) as got:
            validate_reference_config(cfg)
        with pytest.raises(NotImplementedError) as want:
            jffpp.validate_reference_config(cfg)
        assert str(got.value) == str(want.value).replace(
            "mfcnet_tpu/", "mfcnet_tpu_torch/")
    validate_reference_config({})
    validate_reference_config({"gma": "GMA", "r_16": 0})


@pytest.mark.parametrize("knob,val", REJECTED)
def test_ffpp_from_reference_config_refuses_before_building(knob, val):
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        ffpp_from_reference_config,
    )

    with pytest.raises(NotImplementedError, match=knob):
        ffpp_from_reference_config({"percostformer3": {knob: val}})

    class Inner:
        decoder_depth, cost_latent_dim, cost_latent_token_num = 4, 64, 4
        query_latent_dim, vert_c_dim, encoder_depth = 32, 32, 2
        cost_latent_input_dim = 32

    class Cfg:
        percostformer3 = Inner()

    m = ffpp_from_reference_config(Cfg())
    assert isinstance(m, FlowFormerPP) and m.iters == 4
    per = m.memory_encoder.cost_perceiver_encoder
    assert per.latent_tokens.shape == (1, 4, 64)
    assert len(per.encoder_layers) == 2
    assert per.patch_embed.proj[4].out_channels == 32
    assert m.memory_decoder.flow_token_encoder[0].out_channels == 32
    assert ffpp_from_reference_config({}, iters=3).iters == 3


@pytest.mark.parametrize("key,what", [
    ("memory_encoder.vertical_encoder.rpb", "NATTEN"),
    ("memory_decoder.update_block.encoder.convc1.conv_list.0.weight",
     "SK update blocks"),
    ("memory_decoder.quater_upsampler.conv1.weight", "quarter refinement"),
])
def test_checkpoint_loader_refuses_optional_branches(key, what):
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        load_reference_state_dict,
    )

    pm = FlowFormerPP(**NARROW)
    sd = {**pm.state_dict(), f"module.{key}": torch.zeros(1)}
    with pytest.raises(NotImplementedError, match=what):
        load_reference_state_dict(pm, sd)


# ---------------------------------------------------------------- bfloat16
def test_bfloat16_ffpp_within_the_jax_bfloat16_envelope(narrow, images):
    """A bf16 cast of the port against the JAX package's bf16 model
    (variables and inputs cast): the port keeps float32 where JAX's type
    promotion does (the cost volume, the perceiver, the decoder; see the
    model's note on types), so its distance from the JAX float32 flow is
    that of the JAX bf16 flow, within 25 % of it plus the float32
    tolerance."""
    import copy

    v, pm = narrow
    want32 = jax_forward(v, *images)
    want16 = jax_forward(v, *images, dtype="bfloat16")
    p16 = copy.deepcopy(pm).bfloat16()
    assert p16.compute_dtype == torch.bfloat16
    svt = p16.memory_encoder.feat_encoder.svt
    assert svt.blocks[0][0].norm1.weight.dtype == torch.bfloat16
    per = p16.memory_encoder.cost_perceiver_encoder
    assert per.patch_embed.proj[0].weight.dtype == torch.float32
    assert torch.equal(per.patch_embed.proj[0].weight,
                       pm.memory_encoder.cost_perceiver_encoder.patch_embed
                       .proj[0].weight.bfloat16().float())
    a, b = (torch.from_numpy(x).bfloat16() for x in images)
    with torch.no_grad():
        got = p16(a, b)
    assert got.dtype == torch.float32
    d_jax = np.abs(want16 - want32).max()
    d_port = np.abs(got.numpy() - want32).max()
    assert d_jax > 20 * ATOL  # bfloat16 does move the flow
    assert d_port <= 1.25 * d_jax + ATOL, (d_port, d_jax)
