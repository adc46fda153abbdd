"""The port's serving functions and artifacts (``mfcnet_tpu_torch/serve``)
on the CPU.

Against the JAX package (the same weights: JAX variables filled from numpy
over ``jax.eval_shape`` and converted with ``compat.from_jax``; the same
uint8 inputs; float32): the full window's serving function, without and
with depth; the incremental step's probabilities over T+1 frames, without
and with depth (the two packages keep their ring state in different
layouts); and the single-frame function for a log-probabilities base
(TernausNet16) and a logits base (ResUNet). Tolerance 1e-4 on the
probabilities: the models' forward-parity tolerance
(``tests/test_torch_models.py``), looser than 1e-5. The flow provider in
the graph is held to the live engine in
``tests/test_torch_artifact_tracking.py`` (the live engine's flow path to
JAX's: ``tests/test_torch_flow_tracker.py``).

Of the port alone: artifacts round-trip (a symbolic batch at B=1 and B=2, a
fixed batch refusing another, bfloat16 and the header), the loader refuses
what is no artifact of the port (another file, a JAX artifact, a cut file,
another device type), and both registered operators pass
``torch.library.opcheck``."""

import jax
import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H = W = 32
T, C, SCALE = 3, 5, 0.1
PROB_TOL = 1e-4


def _filled(jmodel, seed, *args, **kw):
    """JAX variables of ``jmodel`` filled from numpy (no JAX compile)."""
    from tests.test_torch_zoo_models import fill_like

    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    v = fill_like(shapes, seed)
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def multiframe_pair(depth=False, seed=0):
    """(JAX model, variables, port model): TernausNetMulti-Basic at
    ``model_scale`` 0.1 with the same weights."""
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    jm = jget("TernausNetMulti-Basic", C, T, scale=SCALE,
              add_depth_inputs=depth)
    init = {}
    if depth:
        init["depth"] = np.zeros((1, T, H, W, 1), np.float32)
    v = _filled(jm, seed, np.zeros((1, T, H, W, 3), np.float32), **init)
    pm = get_multiframe_segmentation_model("TernausNetMulti-Basic", C, T,
                                           scale=SCALE,
                                           add_depth_inputs=depth)
    return jm, v, load_jax_variables(pm, v).eval()


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("depth", [False, True])
def test_serving_fn_matches_jax(depth):
    from mfcnet_tpu.serve import make_serving_fn as jmake
    from mfcnet_tpu_torch.serve import make_serving_fn

    jm, v, pm = multiframe_pair(depth=depth, seed=int(depth))
    rng = np.random.default_rng(0)
    inputs = [_u8(rng, 2, T, H, W, 3)]
    if depth:
        inputs.append(_u8(rng, 2, T, H, W))
    want = np.asarray(jax.jit(jmake(jm, v, dtype="float32",
                                    add_depth_inputs=depth))(*inputs))
    with torch.no_grad():
        got = make_serving_fn(pm, dtype="float32", add_depth_inputs=depth,
                              device="cpu")(*map(torch.from_numpy, inputs))
    assert got.shape == (2, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("depth", [False, True])
def test_incremental_step_matches_jax(depth):
    """Probabilities over T+1 frames from zero state (the JAX step keeps
    its ring in space-to-depth or NHWC, the port's in the live engine's
    NCHW layout)."""
    from mfcnet_tpu.serve import make_incremental_step as jmake
    from mfcnet_tpu_torch.serve import make_incremental_step

    jm, v, pm = multiframe_pair(depth=depth, seed=2)
    jstep, jspec = jmake(jm, v, height=H, width=W, num_frames=T,
                         num_classes=C, dtype="float32",
                         add_depth_inputs=depth)
    jstep = jax.jit(jstep)
    step, spec = make_incremental_step(
        pm, height=H, width=W, num_frames=T, num_classes=C,
        dtype="float32", add_depth_inputs=depth, device="cpu")
    assert spec["seg_buf"] == ((None, T * C, H, W), "float32")
    assert ("depth_buf" in spec) == depth
    jstate = [np.zeros((2,) + s[1:], np.float32) for s, _ in jspec.values()]
    state = [torch.zeros((2,) + s[1:]) for s, _ in spec.values()]
    rng = np.random.default_rng(3)
    for _ in range(T + 1):
        inputs = [_u8(rng, 2, H, W, 3)]
        if depth:
            inputs.append(_u8(rng, 2, H, W))
        *jstate, want = jstep(*jstate, *inputs)
        with torch.no_grad():
            *state, got = step(*state, *map(torch.from_numpy, inputs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PROB_TOL)


@pytest.mark.parametrize("kind", ["TernausNet16", "ResUNet"])
def test_singleframe_fn_matches_jax(kind):
    """Both output modes: TernausNet16 gives log-probabilities, ResUNet
    logits (a log-softmax first)."""
    from mfcnet_tpu.models import get_tooltip_segmentation_model as jget
    from mfcnet_tpu.serve import make_singleframe_serving_fn as jmake
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import (
        OUTPUT_MODES,
        get_tooltip_segmentation_model,
    )
    from mfcnet_tpu_torch.serve import make_singleframe_serving_fn

    jm = jget(kind, C, scale=SCALE)
    v = _filled(jm, 5, np.zeros((1, H, W, 3), np.float32))
    pm = load_jax_variables(get_tooltip_segmentation_model(kind, C,
                                                           scale=SCALE), v)
    mode = OUTPUT_MODES[kind]
    frames = _u8(np.random.default_rng(4), 2, H, W, 3)
    want = np.asarray(jax.jit(jmake(jm, v, mode, dtype="float32"))(frames))
    with torch.no_grad():
        got = make_singleframe_serving_fn(pm.eval(), mode, dtype="float32",
                                          device="cpu")(
            torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_TOL)
    with pytest.raises(ValueError, match="TAPNet"):
        make_singleframe_serving_fn(pm, "tapnet", device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """A port TernausNetMulti-Basic (32x32, scale 0.1), seeded."""
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    return get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=SCALE,
        generator=torch.Generator().manual_seed(0))


def test_symbolic_batch_roundtrip(tmp_path, tiny):
    """One artifact, two batch sizes; the header's fields; the loaded
    program equal to the live serving module."""
    from mfcnet_tpu_torch.serve import (
        export_serving,
        load_exported,
        make_serving_fn,
        save_exported,
    )

    ep = export_serving(tiny, height=H, width=W, num_frames=T,
                        dtype="float32", device="cpu")
    header = save_exported(tmp_path / "m.pt2", ep,
                           meta={"model_type": "tiny"})
    assert header["format"] == "mfcnet_tpu_torch.serve/1"
    assert header["device"] == "cpu" and header["model_type"] == "tiny"
    assert header["in_specs"] == [[["b", T, H, W, 3], "uint8"]]
    assert header["out_specs"] == [[["b", H, W, C], "float32"]]
    assert header["torch_version"] == torch.__version__
    loaded = load_exported(tmp_path / "m.pt2")
    assert loaded.meta == header
    live = make_serving_fn(tiny, dtype="float32", device="cpu")
    rng = np.random.default_rng(6)
    for B in (1, 2):
        frames = torch.from_numpy(_u8(rng, B, T, H, W, 3))
        got = loaded(frames)
        with torch.no_grad():
            want = live(frames)
        assert got.shape == (B, H, W, C)
        assert torch.equal(got, want)
        torch.testing.assert_close(got.sum(-1), torch.ones(B, H, W))


def test_fixed_batch_refuses_another(tmp_path, tiny):
    from mfcnet_tpu_torch.serve import (
        export_serving,
        load_exported,
        save_exported,
    )

    ep = export_serving(tiny, height=H, width=W, num_frames=T,
                        dtype="float32", batch=2, device="cpu")
    header = save_exported(tmp_path / "b2.pt2", ep)
    assert header["in_specs"] == [[[2, T, H, W, 3], "uint8"]]
    loaded = load_exported(tmp_path / "b2.pt2")
    rng = np.random.default_rng(7)
    assert loaded(_u8(rng, 2, T, H, W, 3)).shape == (2, H, W, C)
    with pytest.raises(Exception, match="2"):
        loaded(_u8(rng, 1, T, H, W, 3))


def test_bfloat16_incremental_roundtrip(tmp_path, tiny):
    """A bfloat16 incremental artifact: its state in bfloat16 from the
    header, each step equal to the live step."""
    from mfcnet_tpu_torch.serve import (
        export_incremental,
        load_exported,
        make_incremental_step,
        save_exported,
        zero_state,
    )

    ep, spec = export_incremental(tiny, height=H, width=W, num_frames=T,
                                  num_classes=C, dtype="bfloat16",
                                  device="cpu")
    meta = {"serving_mode": "incremental", "compute_dtype": "bfloat16",
            "state": {k: [list(s), d] for k, (s, d) in spec.items()}}
    save_exported(tmp_path / "bf.pt2", ep, meta=meta)
    loaded = load_exported(tmp_path / "bf.pt2")
    assert loaded.meta["compute_dtype"] == "bfloat16"
    assert loaded.meta["state"] == {"seg_buf": [[None, T * C, H, W],
                                                "bfloat16"]}
    assert loaded.meta["in_specs"][0] == [["b", T * C, H, W], "bfloat16"]
    live, _ = make_incremental_step(tiny, height=H, width=W, num_frames=T,
                                    num_classes=C, dtype="bfloat16",
                                    device="cpu")
    state = zero_state(loaded.meta, batch=3)
    assert state[0].dtype == torch.bfloat16 and state[0].shape[0] == 3
    lstate = list(state)
    rng = np.random.default_rng(8)
    for _ in range(T + 1):
        frame = torch.from_numpy(_u8(rng, 3, H, W, 3))
        *state, got = loaded(*state, frame)
        with torch.no_grad():
            *lstate, want = live(*lstate, frame)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="not an incremental"):
        zero_state({"device": "cpu"})


def test_load_refuses_what_is_no_artifact(tmp_path, tiny):
    from mfcnet_tpu_torch.serve import (
        export_singleframe,
        load_exported,
        save_exported,
    )

    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not an mfcnet_tpu_torch"):
        load_exported(junk)
    jax_art = tmp_path / "m.stablehlo"
    jax_art.write_bytes(b"MFCNETX1" + b"\x00" * 32)
    with pytest.raises(ValueError, match="JAX package"):
        load_exported(jax_art)
    ep = export_singleframe(tiny.base_model, height=H, width=W,
                            output_mode="log_probs", dtype="float32",
                            device="cpu")
    path = tmp_path / "sf.pt2"
    save_exported(path, ep, meta={"task": "singleframe"})
    with pytest.raises(ValueError, match="device type it was exported for"):
        load_exported(path, device="cuda")
    cut = tmp_path / "cut.pt2"
    cut.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError, match="bytes"):
        load_exported(cut)


def _opcheck_inputs(name):
    g = torch.Generator().manual_seed(10)
    if name == "flow_warp":
        return (torch.rand(2, 5, 6, 7, generator=g),
                4 * torch.randn(2, 2, 6, 7, generator=g), 8, 9, True)
    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru

    ub = init_weights(UpdateBlock(), g)
    packed = ru.pack_update_weights(ub, torch.bfloat16)
    weights = [packed[k] for k in ru._KMAJOR_NAMES[torch.bfloat16]]
    B, H8, W8 = 1, 2, 3
    t = [torch.randn(B, H8 * W8, c, generator=g) for c in (256, 128, 128,
                                                           128, 2)]
    return (*(x.bfloat16() for x in t[:3]), t[3], t[4], weights, H8, W8,
            True)


@pytest.mark.parametrize("name", ["flow_warp", "raft_update"])
def test_ops_pass_opcheck(name):
    """The registered operators' schema, fake kernels and dispatch, on CPU
    tensors (their plain versions)."""
    op = getattr(torch.ops.mfcnet, name).default
    torch.library.opcheck(op, _opcheck_inputs(name))
