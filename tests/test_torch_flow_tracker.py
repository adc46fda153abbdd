"""The port's flow path as a whole against the JAX package's, on the same
weights (JAX init -> ``compat.from_jax``) and the same numpy inputs, at
float32 on the CPU: the fusion module with flow and depth, the engine with
the frozen RAFT provider (incremental and full), and the CLI.

Tolerances: 2e-4 on the fusion module's logits (float32 convolutions in
another order), 1e-3 on the engine's probabilities (the heatmap gate of
BASELINE.json; the outputs are float16 heats)."""

import jax
import numpy as np
import pytest
import torch

H = W = 64
T, C = 3, 5
STAGES = ((4,), (8,), (8, 8), (16, 16), (16, 16))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_segmenter(depth: bool, seed: int = 3):
    from mfcnet_tpu.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu.utils.jitinit import jit_init

    jm = MultiFrameSegmenter(
        base=TernausNet16(num_classes=C, num_filters=4, stage_convs=STAGES),
        num_classes=C, num_frames=T, variant="basic", base_output="exp",
    )
    kw = {"optflow": np.zeros((1, T - 1, H, W, 2), np.float32)}
    if depth:
        kw["depth"] = np.zeros((1, T, H, W, 1), np.float32)
    v = _np(jit_init(jm, jax.random.PRNGKey(seed),
                     np.zeros((1, T, H, W, 3), np.float32), **kw))
    rng = np.random.default_rng(seed)
    head = v["batch_stats"]["multiframe_net"]["head"]
    for i in range(3):
        n = head[f"BatchNorm_{i}"]["mean"].shape[0]
        head[f"BatchNorm_{i}"]["mean"] = rng.normal(0, 0.1, n).astype(
            np.float32)
        head[f"BatchNorm_{i}"]["var"] = rng.uniform(0.5, 2.0, n).astype(
            np.float32)
    return jm, v


def _port_segmenter(v, depth: bool):
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import MultiFrameSegmenter, TernausNet16

    return load_jax_variables(
        MultiFrameSegmenter(TernausNet16(C, 4, STAGES), C, T,
                            add_depth_inputs=depth).eval(), v)


@pytest.fixture(scope="module")
def segmenters():
    out = {}
    for depth in (False, True):
        jm, v = _jax_segmenter(depth)
        out[depth] = (jm, v, _port_segmenter(v, depth))
    return out


@pytest.fixture(scope="module")
def flow_models():
    """(JAX RAFT, variables, port RAFT) at the engine's half resolution,
    iters=2."""
    from mfcnet_tpu.models.raft import RAFT as JRAFT
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import raft_state_dict_from_jax
    from mfcnet_tpu_torch.models.raft import RAFT

    jf = JRAFT(iters=2)
    d = np.zeros((1, H // 2, W // 2, 3), np.float32)
    fv = jit_init(jf, jax.random.PRNGKey(4), d, d)
    pf = RAFT(iters=2, input_hw=(H // 2, W // 2)).eval()
    pf.load_state_dict(raft_state_dict_from_jax(_np(fv)))
    return jf, fv, pf


@pytest.mark.parametrize("flow,depth", [(True, False), (False, True),
                                        (True, True)])
@pytest.mark.parametrize("method", ["__call__", "fuse_precomputed"])
def test_multiframe_net_with_flow_and_depth_matches_jax(segmenters, flow,
                                                        depth, method):
    """Warped head inputs in the order [seg_0, warped seg_1.., depth_0,
    warped depth_1..] on the cropped 576x720 grid."""
    jm, v, pm = segmenters[depth]
    rng = np.random.default_rng(11)
    kw = {}
    if flow:
        kw["optflow"] = rng.normal(0, 3, (2, T - 1, H, W, 2)).astype(
            np.float32)
    if depth:
        kw["depth"] = rng.random((2, T, H, W, 1), np.float32)
    if method == "__call__":
        x = rng.standard_normal((2, T, H, W, 3)).astype(np.float32)
        want = np.asarray(jm.apply(v, x, **kw))
        fn = pm
    else:
        x = rng.random((2, T, H, W, C), np.float32)
        want = np.asarray(jm.apply(v, x, method="fuse_precomputed", **kw))
        fn = pm.fuse_precomputed
    with torch.no_grad():
        got = fn(torch.from_numpy(x),
                 **{k: torch.from_numpy(a) for k, a in kw.items()}).numpy()
    assert got.shape == want.shape == (2, H, W, C)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_parity_grid_is_the_default_and_matters(segmenters):
    from mfcnet_tpu_torch.models import MultiFrameSegmenter, TernausNet16

    _, _, pm = segmenters[False]
    assert pm.multiframe_net.parity_grid
    ident = MultiFrameSegmenter(TernausNet16(C, 4, STAGES), C, T,
                                parity_grid=False).eval()
    ident.load_state_dict(pm.state_dict())
    seg = torch.rand(1, T, H, W, C)
    zero = torch.zeros(1, T - 1, H, W, 2)
    with torch.no_grad():
        noflow = pm.fuse_precomputed(seg)
        # zero flow is an identity warp only on the identity grid
        torch.testing.assert_close(ident.fuse_precomputed(seg, optflow=zero),
                                   noflow, rtol=0, atol=1e-4)
        assert (pm.fuse_precomputed(seg, optflow=zero)
                - noflow).abs().max() > 1e-3


def _cfg(**kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    return TrackerConfig(num_input_frames=T, num_classes=C, input_height=H,
                         input_width=W, dtype="float32", **kw)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 255, (6, H, W, 3), dtype=np.uint8),
            rng.integers(0, 255, (6, H, W), dtype=np.uint8))


@pytest.mark.parametrize("mode,depth", [("incremental", False),
                                        ("full", False),
                                        ("incremental", True)])
def test_flow_engine_matches_jax_engine(segmenters, flow_models, frames,
                                        mode, depth):
    """The slice as a whole: same frames, same weights, float32."""
    from mfcnet_tpu.track.tracker import InferenceEngine as JEngine
    from mfcnet_tpu.track.tracker import TrackerConfig as JCfg
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    jm, v, pm = segmenters[depth]
    jf, fv, pf = flow_models
    kw = dict(mode=mode, add_optflow_inputs=True, add_depth_inputs=depth)
    je = JEngine(jm, v, JCfg(num_input_frames=T, num_classes=C,
                             input_height=H, input_width=W, dtype="float32",
                             **kw), flow_model=jf, flow_variables=fv)
    pe = InferenceEngine(pm, _cfg(**kw), flow_model=pf, device="cpu")
    compared = 0
    for t in range(5):
        d = frames[1][t] if depth else None
        want, got = je.step(frames[0][t], d), pe.step(frames[0][t], d)
        assert (want is None) == (got is None) == (t < T - 1)
        if want is None:
            continue
        assert got[0].shape == (H, W) and got[0].dtype == np.uint8
        assert np.isfinite(got[1].astype(np.float32)).all()
        np.testing.assert_allclose(got[1].astype(np.float32),
                                   want[1].astype(np.float32), rtol=0,
                                   atol=1e-3)
        assert (got[0] != want[0]).mean() < 0.01
        compared += 1
    assert compared == 3


def test_flow_engine_incremental_equals_full(segmenters, flow_models,
                                             frames):
    """The feature ring reorders no arithmetic: float16 heats equal up to
    one float16 step of a value that straddles a rounding boundary."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    _, _, pm = segmenters[True]
    engines = {
        mode: InferenceEngine(
            pm, _cfg(mode=mode, add_optflow_inputs=True,
                     add_depth_inputs=True),
            flow_model=flow_models[2], device="cpu")
        for mode in ("incremental", "full")
    }
    for t in range(6):
        outs = {m: e.step(frames[0][t], frames[1][t])
                for m, e in engines.items()}
        if outs["full"] is None:
            assert outs["incremental"] is None
            continue
        np.testing.assert_array_equal(outs["incremental"][0], outs["full"][0])
        np.testing.assert_allclose(
            outs["incremental"][1].astype(np.float32),
            outs["full"][1].astype(np.float32), rtol=0, atol=1.5e-4)


def test_flow_from_feature_ring_equals_flow_for_window(flow_models):
    from mfcnet_tpu_torch.track import outputs as out

    pf = flow_models[2]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, T, 3, H, W)).astype(np.float32))
    with torch.no_grad():
        want = out.flow_for_window(x, pf)
        feats, state = [], None
        for t in range(T):
            f, net, inp = out.flow_ingest(x[:, t], pf)
            feats.append(f)
            if t == 0:
                state = (net, inp)
        got = out.flow_from_feature_ring(torch.stack(feats, 1), *state,
                                         (H, W), pf)
    assert got.shape == want.shape == (2, T - 1, 2, H, W)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_flow_for_window_matches_jax(flow_models):
    from mfcnet_tpu.track.outputs import flow_for_window as jflow
    from mfcnet_tpu_torch.track.outputs import flow_for_window

    jf, fv, pf = flow_models
    x = np.random.default_rng(8).standard_normal(
        (1, T, H, W, 3)).astype(np.float32)
    want = np.asarray(jflow(x, jf, fv))
    with torch.no_grad():
        got = flow_for_window(torch.from_numpy(x).permute(0, 1, 4, 2, 3), pf)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               rtol=0, atol=1e-3)


def test_engine_follows_dtype_and_needs_a_provider(segmenters, flow_models):
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    pm, pf = segmenters[False][2], flow_models[2]
    with pytest.raises(ValueError, match="flow_model"):
        InferenceEngine(pm, _cfg(add_optflow_inputs=True), device="cpu")
    e32 = InferenceEngine(pm, _cfg(add_optflow_inputs=True), flow_model=pf,
                          device="cpu")
    assert not e32.flow_model.fused_update
    cfg16 = _cfg(add_optflow_inputs=True)
    cfg16.dtype = "bfloat16"
    e16 = InferenceEngine(pm, cfg16, flow_model=pf, device="cpu")
    assert e16.flow_model.fused_update
    assert next(e16.flow_model.parameters()).dtype == torch.bfloat16
    assert not pf.fused_update  # the caller's provider is left as it was


def test_track_on_frames_with_flow_and_depth(tmp_path, segmenters,
                                             flow_models, frames):
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    rows, _ = track_on_frames(
        frames[0], segmenters[True][2],
        _cfg(add_optflow_inputs=True, add_depth_inputs=True,
             decode="device", overlay=False),
        tmp_path, name="flow", depth_frames=frames[1],
        flow_model=flow_models[2], device="cpu")
    assert rows.shape == (6, 12) and np.isnan(rows[:T - 1]).all()
    assert (tmp_path / "flow_tracked.csv").exists()


def test_cli_tracks_with_flow_and_depth(tmp_path):
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
        main,
    )
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.raft import RAFT

    make_synthetic_video(tmp_path / "vids" / "a.mp4", num_frames=5,
                         height=64, width=64)
    make_synthetic_video(tmp_path / "depth" / "a.mp4", num_frames=5,
                         height=64, width=64)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=0.1,
        generator=torch.Generator().manual_seed(0))
    assert model.multiframe_net.multiframe_net[0].in_channels == T * (C + 1)
    ck, fck = tmp_path / "model.pth", tmp_path / "raft.pth"
    torch.save({"model": model.state_dict(), "epoch": 1}, ck)
    torch.save(RAFT(input_hw=(32, 32)).state_dict(), fck)
    fps = main([
        "--videos_dir", str(tmp_path / "vids"),
        "--depth_videos_dir", str(tmp_path / "depth"),
        "--expt_savedir", str(tmp_path), "--expt_name", "vt",
        "--model_type", "TernausNetMulti-Basic",
        "--load_wts_model", str(ck), "--load_wts_flow_model", str(fck),
        "--add_optflow_inputs", "True", "--add_depth_inputs", "True",
        "--input_height", "64", "--input_width", "64",
        "--model_scale", "0.1", "--compute_dtype", "float32",
        "--decode", "device", "--device", "cpu",
    ])
    assert len(fps) == 1
    rows = np.loadtxt(tmp_path / "vt" / "video_tracking_results"
                      / "a_tracked.csv", delimiter=",")
    assert rows.shape == (5, 12)
