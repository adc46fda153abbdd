"""The port's UnFlow against the JAX package's (``corr_impl="shifts"``), on
the same numpy inputs and the same weights carried both ways
(``convert_unflow`` on the port's seeded state dict, and
``unflow_state_dict_from_jax`` on JAX-initialised variables), at float32 on
the CPU. The weights are He-style (``he_init_weights``; the JAX-initialised
ones rescaled to the same variances), so that the flow is pixels large,
varies across the image and follows the frames: under default
initializations it is nearly constant, and a wiring fault could hide below
the tolerance. Further: ``backward_warp`` alone; the batched provider function; the offline
flow CLI against the JAX CLI.

Tolerances: atol 5e-4, rtol 1e-3 on the flow of the whole stack (the limit
of ``tests/test_compat.py`` for the same model against its torch oracle:
~75 float32 convolutions in another order, times 20); 5e-5 on the warp
(``torch.linspace`` and ``jnp.linspace`` round the base grid one float32
step apart, 1e-6 px at these widths, which the white-noise image's slope of
up to ~8 per px carries into the sample); 1e-3 on the CLI's ``.flo``
files."""

import jax
import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

ATOL, RTOL = 5e-4, 1e-3
#: of each network's last flow convolution: ~1 px of flow on 64x64 noise
FLOW_GAIN = 1.0 / 20.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def junflow():
    """(jitted JAX UnFlow apply, JAX-initialised variables): one jitted
    function for the whole file (the 441 unrolled shifts compile slowly)."""
    from mfcnet_tpu.models.unflow import UnFlow as JUnFlow
    from mfcnet_tpu.utils.jitinit import jit_init

    jm = JUnFlow(corr_impl="shifts")
    d = np.zeros((1, 64, 64, 3), np.float32)
    variables = _np(jit_init(jm, jax.random.PRNGKey(4), d, d))
    return jax.jit(jm.apply), _he_scaled(variables)


def _he_scaled(variables):
    """JAX-initialised variables with every kernel brought to the variance
    of ``he_init_weights`` (2 / fan-in; a stride-2 deconvolution counting
    the taps that reach one output) and each network's last flow
    convolution scaled by ``FLOW_GAIN``, biases left as drawn (zeros)."""
    def scale(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[-1] != "kernel":
            return leaf
        kh, kw, cin = leaf.shape[:3]
        # the deconvolutions: the 4x4 kernels and ``upscale``, all stride 2
        deconv = kh == 4 or keys[-2] == "upscale"
        taps = kh * kw / 4.0 if deconv else kh * kw
        leaf = leaf * np.float32((2.0 / (cin * taps)) ** 0.5 / leaf.std())
        return leaf * np.float32(FLOW_GAIN) if keys[-2] == "two_out" else leaf

    return jax.tree_util.tree_map_with_path(scale, variables)


@pytest.fixture(scope="module")
def port_model():
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights

    return he_init_weights(UnFlow(), torch.Generator().manual_seed(3),
                           flow_gain=FLOW_GAIN).eval()


def _assert_flow_follows_frames(flow, other):
    """``flow`` (B, H, W, 2) and the flow of another input: both vary across
    the image and differ from each other by far more than the tolerance."""
    assert flow.std(axis=(1, 2)).min() > 100 * ATOL
    assert np.abs(flow - other).mean() > 100 * ATOL


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, np.float32), rng.random(shape, np.float32))


def _state_dict_np(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_unflow_matches_jax_with_port_weights(junflow, port_model, hw):
    """The port's seeded weights -> convert_unflow -> the JAX model."""
    from mfcnet_tpu.compat.torch_convert import convert_unflow

    apply, _ = junflow
    a, b = _pair((2, *hw, 3), 0)
    variables = convert_unflow(_state_dict_np(port_model))
    want = np.asarray(apply(variables, a, b))
    with torch.no_grad():
        got = port_model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, *hw, 2)
    # the order of the pair matters, and so do the frames
    _assert_flow_follows_frames(want, np.asarray(apply(variables, b, a)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_unflow_matches_jax_with_jax_weights(junflow):
    """JAX-initialised variables -> unflow_state_dict_from_jax -> the port;
    the two converters are inverses of each other."""
    from mfcnet_tpu.compat.torch_convert import convert_unflow
    from mfcnet_tpu_torch.compat.from_jax import unflow_state_dict_from_jax
    from mfcnet_tpu_torch.models.unflow import UnFlow

    apply, variables = junflow
    pm = UnFlow().eval()
    sd = unflow_state_dict_from_jax(variables)
    pm.load_state_dict(sd, strict=True)
    back = convert_unflow({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)
    a, b = _pair((1, 64, 64, 3), 1)
    want = np.asarray(apply(variables, a, b))
    with torch.no_grad():
        got = pm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _assert_flow_follows_frames(want, np.asarray(apply(variables, b, a)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_unflow_rejects_sizes_that_are_no_multiple_of_64(port_model):
    x = torch.zeros(1, 240, 320, 3)
    with pytest.raises(ValueError, match="multiples of 64"):
        port_model(x, x)


def test_backward_warp_matches_jax():
    from mfcnet_tpu.models.unflow import backward_warp as jwarp
    from mfcnet_tpu_torch.models.unflow import backward_warp

    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 24, 40, 3)).astype(np.float32)
    flow = rng.normal(0, 6, (2, 24, 40, 2)).astype(np.float32)
    want = np.asarray(jwarp(img, flow))
    got = backward_warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                        torch.from_numpy(flow).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
def test_backward_warp_layouts_match_jax(channels_last, flow_dtype):
    """UnFlow's warp as the network calls it (``channels_last`` frames, a
    flow in the network's type) against the JAX package's on numpy-seeded
    inputs. 5e-5: the same taps, blended in another float32 order from
    coordinates that XLA forms with other roundings; a bfloat16 flow is
    rounded before both see it."""
    from mfcnet_tpu.models.unflow import backward_warp as jwarp
    from mfcnet_tpu_torch.models.unflow import backward_warp

    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 20, 36, 3)).astype(np.float32)
    flow = torch.from_numpy(rng.normal(0, 5, (2, 20, 36, 2)).astype(
        np.float32)).to(flow_dtype)
    want = np.asarray(jwarp(img, flow.float().numpy()))
    ti, tf = torch.from_numpy(img).permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    if not channels_last:
        ti, tf = ti.contiguous(), tf.contiguous()
    got = backward_warp(ti, tf)
    assert got.stride() == ti.stride()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("basic", [True, False])
def test_make_unflow_flow_fn_batched_equals_pair_loop(port_model, basic):
    from mfcnet_tpu_torch.models.unflow import make_unflow_flow_fn

    frames = torch.from_numpy(np.random.default_rng(5).random(
        (2, 3, 64, 64, 3), np.float32))
    got = make_unflow_flow_fn(basic=basic, model=port_model)(frames)
    assert got.shape == (2, 2, 64, 64, 2)
    with torch.no_grad():
        for k in range(2):
            for i in range(2):
                a, b = frames[k, i + 1][None], frames[k, 0][None]
                a, b = (a, b) if basic else (b, a)
                # the batched convolutions sum in another order, and the
                # stack carries a 1e-6 change of its input into 3e-5 px of
                # these ~1 px flows
                torch.testing.assert_close(got[k, i], port_model(a, b)[0],
                                           rtol=1e-4, atol=1e-4)


def test_bfloat16_unflow_runs_in_bfloat16_and_returns_float32(port_model):
    """The dtype decision: parameters and input rounded to bfloat16,
    float32 arithmetic (as the JAX package's bfloat16 UnFlow computes); the
    result leaves in float32,
    inside a bf16 envelope of the float32 model (the weights and the input
    rounded to 8 bits, carried through ~75 convolutions)."""
    import copy

    m16 = copy.deepcopy(port_model).bfloat16()
    a, b = (torch.from_numpy(v) for v in _pair((1, 64, 64, 3), 6))
    with torch.no_grad():
        want = port_model(a, b)
        got = m16(a, b)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 0.1 * want.abs().max() + 0.05


# ------------------------------------------------------------ the offline CLI
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """One JIGSAWS-like video of 4 frames, 64x64 (needs cv2, as the CLI's
    image reading does)."""
    from mfcnet_tpu.data.synthetic import make_jigsaws_like_dataset

    return make_jigsaws_like_dataset(tmp_path_factory.mktemp("ds"),
                                     num_videos=1, frames_per_video=4,
                                     height=64, width=64)


def _flow_cli_args(dataset, model, size, out_dir, *extra):
    return ["--data_dir", str(dataset), "--dataset", "JIGSAWS",
            "--mode", "testing", "--optflow_model", model,
            "--optflow_dir", out_dir, "--input_height", str(size),
            "--input_width", str(size), "--raft_iters", "1",
            "--save_viz", "false", *extra]


def _flo_files(dataset, out_dir):
    return sorted((dataset / "annotations_val" / "video_1" / out_dir
                   ).glob("*.flo"))


@pytest.mark.parametrize("model,size", [("RAFT", 32), ("UnFlow", 64)])
def test_generate_opticalflow_cli_matches_jax_cli(dataset, tmp_path, model,
                                                  size):
    """File count, .flo round trip, --batch 3 (with a padded last chunk) ==
    per pair, and .flo files equal to the JAX CLI's within 1e-3 on the
    same weights: RAFT's are those the JAX CLI draws for itself, carried
    into a .pth; UnFlow's are those brought to He variances (see
    ``_he_scaled``), given to both CLIs, so that the flow follows the
    frames."""
    from mfcnet_tpu.cli.generate_opticalflow import main as jmain
    from mfcnet_tpu.utils.checkpoint import save_params
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.cli.generate_opticalflow import main
    from mfcnet_tpu_torch.compat import from_jax
    from mfcnet_tpu_torch.data.masks import read_flo, write_flo

    if model == "RAFT":
        from mfcnet_tpu.models.raft import RAFT

        jm, to_sd = RAFT(iters=1), from_jax.raft_state_dict_from_jax
    else:
        from mfcnet_tpu.models.unflow import UnFlow

        jm, to_sd = UnFlow(), from_jax.unflow_state_dict_from_jax
    d = np.zeros((1, size, size, 3), np.float32)
    # what the JAX CLI does without --load_wts_model
    variables = _np(jit_init(jm, jax.random.PRNGKey(0), d, d))
    jax_extra = ()
    if model == "UnFlow":
        variables = _he_scaled(variables)
        save_params(tmp_path / "flow.msgpack", variables["params"])
        jax_extra = ("--load_wts_model", str(tmp_path / "flow.msgpack"))
    ck = tmp_path / "flow.pth"
    torch.save(to_sd(variables), ck)

    tag = model.lower()
    args = _flow_cli_args(dataset, model, size, f"port_{tag}",
                          "--load_wts_model", str(ck))
    if not torch.cuda.is_available():
        # the CLI runs on the card unless asked: no silent CPU fallback
        with pytest.raises(SystemExit, match="--device cpu"):
            main(args)
    assert main(args + ["--device", "cpu"]) == 4
    files = _flo_files(dataset, f"port_{tag}")
    assert len(files) == 4
    first = read_flo(files[0])
    assert first.shape == (size, size, 2) and not first.any()  # zero flow
    flo = read_flo(files[1])
    assert np.isfinite(flo).all() and np.abs(flo).max() > 0
    if model == "UnFlow":  # far above the 1e-3 it is held to below
        assert flo.std() > 0.1
    write_flo(tmp_path / "again.flo", flo)
    np.testing.assert_array_equal(read_flo(tmp_path / "again.flo"), flo)

    args3 = _flow_cli_args(dataset, model, size, f"port_{tag}_b3",
                           "--load_wts_model", str(ck), "--batch", "3",
                           "--device", "cpu")
    assert main(args3) == 4
    for a, b in zip(files, _flo_files(dataset, f"port_{tag}_b3")):
        # another batch, another order of sums (see the pair-loop test)
        np.testing.assert_allclose(read_flo(a), read_flo(b), atol=1e-4)

    assert jmain(_flow_cli_args(dataset, model, size, f"jax_{tag}",
                                *jax_extra)) == 4
    for a, b in zip(files, _flo_files(dataset, f"jax_{tag}")):
        assert a.name == b.name
        np.testing.assert_allclose(read_flo(a), read_flo(b), rtol=0,
                                   atol=1e-3)


def test_generate_opticalflow_cli_rejects_bad_sizes(dataset):
    from mfcnet_tpu_torch.cli.generate_opticalflow import main

    with pytest.raises(SystemExit, match="multiples of 64"):
        main(_flow_cli_args(dataset, "UnFlow", 32, "x", "--device", "cpu"))
    with pytest.raises(SystemExit, match="divisible by 8"):
        main(_flow_cli_args(dataset, "RAFT", 36, "x", "--device", "cpu"))


def test_flow_to_color_matches_jax_package():
    from mfcnet_tpu.utils.vis import flow_to_color as jcolor
    from mfcnet_tpu_torch.utils.vis import flow_to_color

    flow = np.random.default_rng(0).normal(0, 3, (16, 20, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(flow_to_color(flow), jcolor(flow))
