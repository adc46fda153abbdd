"""TernausNetMulti-Large in the port against the JAX package's, on the same
weights (the port's seeded init carried into JAX by
``compat.torch_convert.convert_multiframe_ternausnet``, which reads both
variants under one prefix) and the same numpy inputs, at float32 on the
CPU: the fusion module with and without flow and depth, the engine with
the frozen RAFT provider (incremental and full), one train step, the
weight round trip and the refusal of inputs the head was not built for.

Tolerances: 1e-5 on the fusion module's logits (float32 convolutions in
another order; no warp); 1e-3 on the engine's probabilities (the heatmap
gate of BASELINE.json; the outputs are float16 heats) with equal class
masks and equal CSV rows; the train step as in
``tests/test_torch_train_steps.py``."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H, W, T, C = 64, 64, 3, 5
SCALE = 1 / 16
LOSSES = (["nll", "soft_jaccard"], [0.7, 0.3])
CLASS_WEIGHTS = [1, 50, 50, 50, 50]


def _large(flow: bool, depth: bool, seed: int = 3, lecun: bool = True):
    """The port's Large model (weights from ``seed``: lecun-normal, or
    PyTorch's default schemes, whose speckled class maps give the decode
    something to find; random running statistics), eval mode, and its JAX
    variables."""
    from mfcnet_tpu.compat.torch_convert import convert_multiframe_ternausnet
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights_lecun,
    )

    pm = get_multiframe_segmentation_model(
        "TernausNetMulti-Large", C, T, add_optflow_inputs=flow,
        add_depth_inputs=depth, scale=SCALE,
        generator=torch.Generator().manual_seed(seed))
    if lecun:
        init_weights_lecun(pm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in pm.multiframe_net.multiframe_net:
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                mod.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, n).astype(np.float32)))
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    return pm.eval(), convert_multiframe_ternausnet(sd)


def _jax_large():
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget

    return jget("TernausNetMulti-Large", C, T, scale=SCALE)


def _inputs(rng, flow, depth, n=2):
    kw = {}
    if flow:
        kw["optflow"] = rng.normal(0, 3, (n, T - 1, H, W, 2)).astype(
            np.float32)
    if depth:
        kw["depth"] = rng.random((n, T, H, W, 1), np.float32)
    return kw


@pytest.mark.parametrize("flow,depth", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_large_head_matches_jax(flow, depth):
    """The head's input [seg_t..., flow_i..., depth_t...] in JAX's NHWC
    channel order: a wrong order still runs, only this finds it."""
    pm, v = _large(flow, depth)
    head = pm.multiframe_net.multiframe_net[0]
    assert head.in_channels == T * C + 2 * (T - 1) * flow + T * depth
    rng = np.random.default_rng(11)
    kw = _inputs(rng, flow, depth)
    x = rng.random((2, T, H, W, C), np.float32)
    want = np.asarray(_jax_large().apply(v, x, method="fuse_precomputed",
                                         **kw))
    with torch.no_grad():
        got = pm.fuse_precomputed(
            torch.from_numpy(x),
            **{k: torch.from_numpy(a) for k, a in kw.items()}).numpy()
    assert got.shape == want.shape == (2, H, W, C)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_large_forward_matches_jax_and_full_width_head():
    """Base and head together, with flow and depth; at full width with
    RAFT and depth the head's first conv takes 22 channels."""
    from mfcnet_tpu_torch.models.mfcnet import MultiFrameNet

    pm, v = _large(True, True)
    rng = np.random.default_rng(12)
    kw = _inputs(rng, True, True)
    x = rng.standard_normal((2, T, H, W, 3)).astype(np.float32)
    want = np.asarray(_jax_large().apply(v, x, **kw))
    with torch.no_grad():
        got = pm(torch.from_numpy(x),
                 **{k: torch.from_numpy(a) for k, a in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    full = MultiFrameNet(C, T, "large", add_depth_inputs=True,
                         add_optflow_inputs=True)
    assert full.multiframe_net[0].in_channels == 22


def test_large_head_refuses_inputs_it_was_not_built_for():
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    seg = torch.rand(1, T * C, 16, 16)
    flow = torch.rand(1, T - 1, 2, 16, 16)
    depth = torch.rand(1, T, 16, 16)
    for built_flow, built_depth, kw, err in (
            (True, False, {}, "called without optflow"),
            (False, False, {"optflow": flow}, "called with optflow"),
            (True, True, {"optflow": flow}, "called without depth"),
            (True, False, {"optflow": flow, "depth": depth},
             "called with depth")):
        m = get_multiframe_segmentation_model(
            "TernausNetMulti-Large", C, T, add_optflow_inputs=built_flow,
            add_depth_inputs=built_depth, scale=SCALE)
        with pytest.raises(ValueError, match=err):
            m.fuse_nchw(seg, **kw)


def test_large_from_jax_round_trip_is_exact():
    """port state_dict -> torch_convert -> JAX variables -> from_jax ->
    the same state_dict bit for bit, the wider first head conv included;
    the reference's key names load by name."""
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    pm, v = _large(True, True)
    back = state_dict_from_jax(v, get_multiframe_segmentation_model(
        "TernausNetMulti-Large", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=SCALE))
    want = pm.state_dict()
    assert set(back) == set(want)
    for k, t in want.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    assert back["multiframe_net.multiframe_net.0.weight"].shape[1] == 22


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def raft_pair():
    """(JAX RAFT, its variables, port RAFT) on the same lecun-normal
    weights at the engine's half resolution, iters=2."""
    from mfcnet_tpu.compat.torch_convert import convert_raft
    from mfcnet_tpu.models.raft import RAFT as JRAFT
    from mfcnet_tpu_torch.models import init_weights_lecun
    from mfcnet_tpu_torch.models.raft import RAFT

    pf = init_weights_lecun(RAFT(iters=2, input_hw=(H // 2, W // 2)),
                            torch.Generator().manual_seed(4)).eval()
    fv = convert_raft({k: t.numpy() for k, t in pf.state_dict().items()})
    return JRAFT(iters=2), fv, pf


@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_large_engine_matches_jax_engine(raft_pair, mode):
    """The slice as a whole: the Large head with RAFT flow and depth,
    same frames and weights; the host decode's rows from each engine's
    outputs."""
    from mfcnet_tpu.data.synthetic import make_synthetic_frames
    from mfcnet_tpu.track.tracker import InferenceEngine as JEngine
    from mfcnet_tpu.track.tracker import KeypointTracker as JTracker
    from mfcnet_tpu.track.tracker import TrackerConfig as JCfg
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        KeypointTracker,
        TrackerConfig,
    )

    jf, fv, pf = raft_pair
    pm, v = _large(True, True, lecun=False)
    frames = make_synthetic_frames(num_frames=7, height=H, width=W, seed=5)
    depth = np.ascontiguousarray(frames[..., 0])
    kw = dict(num_input_frames=T, num_classes=C, input_height=H,
              input_width=W, dtype="float32", mode=mode, overlay=False,
              add_optflow_inputs=True, add_depth_inputs=True)
    je = JEngine(_jax_large(), v, JCfg(**kw), flow_model=jf,
                 flow_variables=fv)
    pe = InferenceEngine(pm, TrackerConfig(**kw), flow_model=pf,
                         device="cpu")
    jt, pt = JTracker(len(frames), JCfg(**kw)), KeypointTracker(
        len(frames), TrackerConfig(**kw))
    for t in range(len(frames)):
        want, got = je.step(frames[t], depth[t]), pe.step(frames[t],
                                                          depth[t])
        assert (want is None) == (got is None) == (t < T - 1)
        if want is None:
            jt.skip()
            pt.skip()
            continue
        np.testing.assert_allclose(got[1].astype(np.float32),
                                   want[1].astype(np.float32), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(got[0], want[0])
        for tr, (m, h) in ((jt, want), (pt, got)):
            h = h.astype(np.float32)
            tr.update(m, h[..., 1], h[..., 0])
    assert np.isfinite(pt.rows).sum() > 0
    np.testing.assert_array_equal(pt.rows, jt.rows)


def test_large_train_step_matches_jax():
    """One float32 step, base trained, with a fixed flow and depth: loss
    parts, every parameter and the head's running statistics."""
    import jax.numpy as jnp

    from tests.test_torch_train_steps import LR, _assert_sd_close

    from mfcnet_tpu.train.schedule import make_schedule as jsched
    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.state import multiframe_optimizer
    from mfcnet_tpu.train.steps import make_multiframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    B, h, w = 2, 64, 32
    pm, v = _large(True, True, seed=0)
    pm.train()
    rng = np.random.default_rng(0)
    flow = rng.uniform(-4, 4, (B, T - 1, h, w, 2)).astype(np.float32)
    batch = {"frames": rng.standard_normal((B, T, h, w, 3)).astype(
                 np.float32),
             "mask": rng.integers(0, C, (B, h, w)).astype(np.int32),
             "depth": rng.random((B, T, h, w, 1)).astype(np.float32)}

    jm = _jax_large()
    tx = multiframe_optimizer(jsched("StepDecay", LR, 2, 1), T, True, False)
    st = JState.create(jm.apply, v["params"], tx, v["batch_stats"])
    step = jstep(jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
                 train_base_model=True, flow_fn=lambda f: jnp.asarray(flow),
                 donate=False)
    st, jparts = step(st, batch)

    pst = TrainState(pm, make_schedule("StepDecay", LR, 2, 1), T,
                     train_base_model=True)
    pstep = make_multiframe_train_step(
        *LOSSES, C, class_weights=CLASS_WEIGHTS,
        flow_fn=lambda f: torch.from_numpy(flow))
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tb["mask"] = tb["mask"].long()
    pparts = pstep(pst, tb)
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    want = state_dict_from_jax({"params": st.params,
                                "batch_stats": st.batch_stats}, pm)
    _assert_sd_close(pm.state_dict(), want)


@pytest.mark.parametrize("basic", [True, False], ids=["basic", "large"])
def test_training_flow_direction(raft_pair, basic):
    """The train step's frozen provider against the JAX package's
    ``make_raft_flow_fn(basic=...)`` on the same RAFT weights and frames:
    the Basic variant's flow(frame_i -> frame_i's context, frame_0), the
    Large variant's flow(frame_0 -> frame_i) with frame 0's context; a
    wrong direction or context source moves the flow by far more than the
    1e-4 px allowed (float32 convolutions in another order), and the two
    directions differ by more than 0.1 px here. Also all T-1 pairs in one
    solve against the port's RAFT on each pair alone (1e-4 px: batched
    convolutions sum in another order)."""
    from mfcnet_tpu.models.raft import make_raft_flow_fn
    from mfcnet_tpu_torch.track.outputs import flow_for_training

    jf, fv, pf = raft_pair
    frames = np.random.default_rng(8).standard_normal(
        (2, T, H // 2, W // 2, 3)).astype(np.float32)
    want = np.asarray(make_raft_flow_fn(
        basic=basic, iters=2, variables=fv,
        input_hw=(H // 2, W // 2))(frames))
    other = np.asarray(make_raft_flow_fn(
        basic=not basic, iters=2, variables=fv,
        input_hw=(H // 2, W // 2))(frames))
    x = torch.from_numpy(frames)
    with torch.no_grad():
        got = flow_for_training(x, pf, basic=basic)
        for k in range(2):
            for i in range(T - 1):
                a, b = x[k, i + 1][None], x[k, 0][None]
                a, b = (a, b) if basic else (b, a)
                torch.testing.assert_close(got[k, i], pf(a, b)[0],
                                           rtol=1e-4, atol=1e-4)
    assert got.shape == want.shape == (2, T - 1, H // 2, W // 2, 2)
    assert np.abs(want - other).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_train_and_track_clis_take_large(tmp_path):
    """The training CLI trains TernausNetMulti-Large with RAFT and depth
    in the step (2 steps on a pack of the port's generator), and the
    tracking CLI tracks with its checkpoint, the flow in the head."""
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.cli import test_multiframe_segmentation_on_videos
    from mfcnet_tpu_torch.cli import train_multiframe_detection
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.utils.checkpoint import latest_checkpoint

    pack = make_synthetic_pack(tmp_path / "pack",
                               videos=(("train", 1, 2), ("val", 1, 1)),
                               height=64, width=64, seed=0)
    common = ["--model_type", "TernausNetMulti-Large", "--model_scale",
              "0.0625", "--input_height", "64", "--input_width", "64",
              "--add_optflow_inputs", "true", "--add_depth_inputs", "true",
              "--device", "cpu"]
    state = train_multiframe_detection.main(common + [
        "--dataset", "JIGSAWS", "--packed_dir", str(pack),
        "--expt_savedir", str(tmp_path), "--expt_name", "large",
        "--batch_size", "1", "--num_workers", "1", "--num_epochs", "0",
        "--train_base_model", "true"])
    assert state.step == 2
    assert state.model.multiframe_net.multiframe_net[0].in_channels == 22
    for kind in ("vids", "depth"):
        make_synthetic_video(tmp_path / kind / "a.mp4", num_frames=4,
                             height=64, width=64)
    fps = test_multiframe_segmentation_on_videos.main(common + [
        "--videos_dir", str(tmp_path / "vids"),
        "--depth_videos_dir", str(tmp_path / "depth"),
        "--expt_savedir", str(tmp_path), "--expt_name", "vt",
        "--load_wts_model",
        str(latest_checkpoint(tmp_path / "large" / "ckpts")),
        "--compute_dtype", "float32", "--decode", "device"])
    assert len(fps) == 1
    rows = np.loadtxt(tmp_path / "vt" / "video_tracking_results"
                      / "a_tracked.csv", delimiter=",")
    assert rows.shape == (4, 12)
