"""FlowFormer++ on the port's two paths, on the CPU against the JAX
package's: the tracker engine with FFPP as its split-encoder provider
(feature ring of the features, the context features where RAFT keeps its
GRU state), and the train step with FFPP as its frozen provider; the
trainer's 0.225/0.5 input scaling (the tracker passes its frames as they
are) and the training CLI with ``--optflow_model FlowFormerPlusPlus``.
The CUDA-marked cases run FFPP on the card.

FFPP here: narrow widths (``tests/test_torch_ffpp.py``'s), 1 iteration
(that file holds the iterations), weights from its seeded JAX tree.
Tolerances: the engine's class masks and rows equal the JAX engine's and
its float16 heats are within 1e-3 (the heatmap gate of BASELINE.json); the
train step's loss parts within 1e-5 relative and its parameters as
``tests/test_torch_train_steps.py`` holds them; the feature ring equals
the stateless window within 1e-5 px (the same operations, batched
otherwise); the trainer's flow the JAX provider's within 1e-5 px."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

S, T, C = 64, 3, 5
SCALE = 1 / 16
NARROW = dict(enc_dims=(16, 32), latent_dim=16, query_dim=8)


@pytest.fixture(scope="module")
def ffpp():
    """(JAX FlowFormerPP with 1 iteration, its variables, the port's)."""
    from tests.test_torch_ffpp import jax_variables, port_model

    from mfcnet_tpu.models.flowformerpp import FlowFormerPP

    v = jax_variables(7, flow_gain=0.4, **NARROW)
    return FlowFormerPP(iters=1, **NARROW), v, port_model(v, iters=1,
                                                          **NARROW)


@pytest.fixture(scope="module")
def segmenter():
    """The port's TernausNetMulti-Basic (lecun weights from a seed whose
    class maps hold bases and tips on these frames) and its JAX copy."""
    from mfcnet_tpu.compat.torch_convert import convert_multiframe_ternausnet
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights_lecun,
    )

    pm = init_weights_lecun(get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, scale=SCALE),
        torch.Generator().manual_seed(2))
    v = convert_multiframe_ternausnet(
        {k: t.numpy() for k, t in pm.state_dict().items()})
    jm = jget("TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
              scale=SCALE)
    return jm, v, pm


@pytest.fixture(scope="module")
def frames():
    from mfcnet_tpu.data.synthetic import make_synthetic_frames

    return make_synthetic_frames(num_frames=6, height=S, width=S, seed=21)


_JAX_FLOW = {}


def jax_flow(ffpp, basic, frames):
    """The JAX ``make_ffpp_flow_fn``'s flow, one jitted function per
    direction for the module."""
    import jax

    from mfcnet_tpu.models.flowformerpp import make_ffpp_flow_fn

    if basic not in _JAX_FLOW:
        _JAX_FLOW[basic] = jax.jit(make_ffpp_flow_fn(
            basic=basic, variables=ffpp[1], model=ffpp[0]))
    return np.asarray(_JAX_FLOW[basic](frames))


def _cfg(**kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    return TrackerConfig(num_input_frames=T, num_classes=C, input_height=S,
                         input_width=S, dtype="float32", overlay=False,
                         add_optflow_inputs=True, **kw)


def test_engine_matches_jax_engine(tmp_path, ffpp, segmenter, frames):
    """Incremental, f32: each step's class mask equals the JAX engine's
    and its heats are within 1e-3; the tracked rows are equal."""
    from mfcnet_tpu.track.tracker import InferenceEngine as JEngine
    from mfcnet_tpu.track.tracker import TrackerConfig as JCfg
    from mfcnet_tpu.track.tracker import track_on_frames as jtrack
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, track_on_frames

    jf, fv, pf = ffpp
    jm, v, pm = segmenter
    jcfg = JCfg(num_input_frames=T, num_classes=C, input_height=S,
                input_width=S, dtype="float32", overlay=False,
                add_optflow_inputs=True)
    je = JEngine(jm, v, jcfg, flow_model=jf, flow_variables=fv)
    pe = InferenceEngine(pm, _cfg(), flow_model=pf, device="cpu")
    assert pe.flow_split
    for t, frame in enumerate(frames):
        want, got = je.step(frame), pe.step(frame)
        assert (want is None) == (got is None) == (t < T - 1)
        if want is None:
            continue
        # the ring holds the context features where RAFT holds net
        feat, ctx, ph = pe.flow_state
        assert feat.shape == (1, T, S // 16, S // 16, 32)
        assert ctx.shape == (1, S // 16, S // 16, 32) and ph.shape == (1, 1,
                                                                       1, 1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1].astype(np.float32),
                                   want[1].astype(np.float32), rtol=0,
                                   atol=1e-3)
    want, _ = jtrack(frames, jm, v, jcfg, tmp_path / "j", engine=je)
    got, _ = track_on_frames(frames, None, pe.cfg, tmp_path / "p", engine=pe)
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(got, want)


def test_engine_incremental_equals_full(ffpp, segmenter, frames):
    """The feature ring reorders no arithmetic: masks equal, heats within
    one float16 step of a value that straddles a rounding boundary."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    pm, pf = segmenter[2], ffpp[2]
    engines = {m: InferenceEngine(pm, _cfg(mode=m), flow_model=pf,
                                  device="cpu")
               for m in ("incremental", "full")}
    compared = 0
    for frame in frames:
        outs = {m: e.step(frame) for m, e in engines.items()}
        if outs["full"] is None:
            assert outs["incremental"] is None
            continue
        np.testing.assert_array_equal(outs["incremental"][0], outs["full"][0])
        np.testing.assert_allclose(outs["incremental"][1].astype(np.float32),
                                   outs["full"][1].astype(np.float32),
                                   rtol=0, atol=1.5e-4)
        compared += 1
    assert compared == len(frames) - (T - 1)


def test_feature_ring_equals_flow_for_window(ffpp):
    """``flow_ingest`` per frame + ``flow_from_feature_ring`` against the
    stateless ``flow_for_window``, 2 windows at once; the frames go into
    the provider unscaled (the tracker's convention)."""
    from mfcnet_tpu_torch.ops.resize import resize_nearest
    from mfcnet_tpu_torch.track import outputs as out

    pf = ffpp[2]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, T, 3, S, S)).astype(np.float32))
    with torch.no_grad():
        want = out.flow_for_window(x, pf)
        ring = [out.flow_ingest(x[:, t], pf) for t in range(T)]
        got = out.flow_from_feature_ring(torch.stack([r[0] for r in ring], 1),
                                         *ring[0][1:], (S, S), pf)
        half = resize_nearest(x[:, 0], S // 2, S // 2).permute(0, 2, 3, 1)
        torch.testing.assert_close(ring[0][0], pf.features(half), rtol=0,
                                   atol=0)
    assert got.shape == want.shape == (2, T - 1, 2, S, S)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_two_stream_engine_equals_single_engines(ffpp, segmenter):
    """``num_streams=2``: the feature ring (2, T, h, w, C) and the context
    features of both newest frames, all 2*(T-1) pairs in one solve; each
    stream's outputs are its own engine's (masks equal, heats within
    1e-3)."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    pm, pf = segmenter[2], ffpp[2]
    frames = np.random.default_rng(6).integers(0, 255, (4, 2, S, S, 3),
                                               dtype=np.uint8)
    singles = [InferenceEngine(pm, _cfg(), flow_model=pf, device="cpu")
               for _ in range(2)]
    multi = InferenceEngine(pm, _cfg(), flow_model=pf, device="cpu",
                            num_streams=2)
    for t in range(4):
        refs = [singles[b].step(frames[t, b]) for b in range(2)]
        got = multi.step(frames[t])
        assert (got is None) == (refs[0] is None) == (t < T - 1)
        if got is None:
            continue
        assert multi.flow_state[0].shape[:2] == (2, T)
        assert multi.flow_state[1].shape == (2, S // 16, S // 16, 32)
        for b in range(2):
            np.testing.assert_array_equal(got[0][b], refs[b][0])
            np.testing.assert_allclose(got[1][b].astype(np.float32),
                                       refs[b][1].astype(np.float32),
                                       rtol=0, atol=1e-3)


@pytest.mark.parametrize("basic", [True, False], ids=["basic", "large"])
def test_training_flow_direction_matches_jax(ffpp, basic):
    """The trainer's FFPP provider against the JAX ``make_ffpp_flow_fn``
    on the same weights and frames: Basic flow(frame_i -> frame_0) with
    frame_i's context, Large flow(frame_0 -> frame_i) with frame 0's, the
    frames scaled by 0.225/0.5 on both sides (1e-5 px; the two directions
    differ by far more)."""
    from mfcnet_tpu_torch.models.flowformerpp import make_ffpp_flow_fn

    frames = np.random.default_rng(9).standard_normal(
        (2, T, S, S // 2, 3)).astype(np.float32)
    want = jax_flow(ffpp, basic, frames)
    other = jax_flow(ffpp, not basic, frames)
    got = make_ffpp_flow_fn(ffpp[2], basic=basic)(torch.from_numpy(frames))
    assert got.shape == want.shape == (2, T - 1, S, S // 2, 2)
    assert np.abs(want - other).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_train_step_with_ffpp_matches_jax(ffpp, segmenter):
    """One f32 step, base trained, FFPP inside the step on both sides (the
    Basic direction, the 0.225/0.5 scaling): the port's flow against the
    JAX provider's on the step's frames (1e-5 px), the loss parts and every
    parameter and running statistic after the update. The provider's flow
    head is scaled to flows of a few pixels (``flow_gain`` 0.4, up to
    ~4.5 px), as the tracker's random FFPP gives: with sub-pixel flows
    (0.1: ~0.2 px) Adam's first update, lr * g / (|g| + eps), moved one of
    the head's first kernel by 3 % of lr between the packages (found), over
    this tolerance's 2 %: the mechanism ``test_torch_train_steps.py``
    names."""
    import copy

    from tests.test_torch_train_steps import _assert_sd_close

    from mfcnet_tpu.models.flowformerpp import make_ffpp_flow_fn as jmake
    from mfcnet_tpu.train.schedule import make_schedule as jsched
    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.state import multiframe_optimizer
    from mfcnet_tpu.train.steps import make_multiframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.models.flowformerpp import make_ffpp_flow_fn
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    jf, fv, pf = ffpp
    jm, v, pm = segmenter
    pm = copy.deepcopy(pm)
    losses = (["nll", "soft_jaccard"], [0.7, 0.3])
    lr, cw = 1e-3, [1, 50, 50, 50, 50]
    rng = np.random.default_rng(0)
    batch = {"frames": rng.standard_normal((2, T, S, S // 2, 3)).astype(
        np.float32), "mask": rng.integers(0, C, (2, S, S // 2)).astype(
        np.int32)}
    flows = []
    flow_fn = make_ffpp_flow_fn(pf)

    def recording(frames):
        flows.append(flow_fn(frames))
        return flows[-1]

    pst = TrainState(pm, make_schedule("StepDecay", lr, 2, 1), T,
                     train_base_model=True)
    pstep = make_multiframe_train_step(*losses, C, class_weights=cw,
                                       flow_fn=recording)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tb["mask"] = tb["mask"].long()
    pparts = pstep(pst, tb)
    flow = flows[0].numpy()
    want = jax_flow(ffpp, True, batch["frames"])
    assert flow.shape == want.shape == (2, T - 1, S, S // 2, 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(flow, want, rtol=0, atol=1e-5)

    tx = multiframe_optimizer(jsched("StepDecay", lr, 2, 1), T, True, False)
    st = JState.create(jm.apply, v["params"], tx, v["batch_stats"])
    step = jstep(jm, *losses, C, class_weights=cw, train_base_model=True,
                 flow_fn=jmake(basic=True, variables=fv, model=jf),
                 donate=False)
    st, jparts = step(st, batch)
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    _assert_sd_close(pm.state_dict(), state_dict_from_jax(
        {"params": st.params, "batch_stats": st.batch_stats}, pm))


def test_build_flow_fn_scales_frames_and_the_engine_does_not(tmp_path):
    """``build_flow_fn("FlowFormerPlusPlus", ...)``: default widths, 12
    iterations, seeded weights (or a reference ``.pth`` by name), frames x
    0.225/0.5 into ``flow_for_training``; scaled and unscaled frames give
    flows that differ, so the check sees the scaling."""
    from tests.torch_ffpp_ref import FlowFormerTorch

    from mfcnet_tpu_torch.cli.train_multiframe_detection import build_flow_fn
    from mfcnet_tpu_torch.models.flowformerpp import TRAIN_INPUT_SCALE
    from mfcnet_tpu_torch.track.outputs import flow_for_training

    assert TRAIN_INPUT_SCALE == 0.225 / 0.5
    fn = build_flow_fn("FlowFormerPlusPlus", (S, S), device="cpu", seed=3)
    m = fn.model
    assert m.iters == 12 and not any(p.requires_grad for p in m.parameters())
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, T, S, S, 3)).astype(np.float32))
    with torch.no_grad():
        got = fn(frames)
        want = flow_for_training(frames * TRAIN_INPUT_SCALE, m)
        unscaled = flow_for_training(frames, m)
    assert got.shape == (1, T - 1, S, S, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got - unscaled).abs().max() > 1e-2
    # a reference checkpoint loads by name (module. prefixes, pos_emb)
    torch.manual_seed(0)
    ref = FlowFormerTorch(decoder_depth=12)
    torch.save({"model": {f"module.{k}": t
                          for k, t in ref.state_dict().items()}},
               tmp_path / "ffpp.pth")
    fn = build_flow_fn("FlowFormerPlusPlus", (S, S), tmp_path / "ffpp.pth",
                       device="cpu")
    w = fn.model.memory_decoder.update_block.flow_head.conv2.weight
    torch.testing.assert_close(
        w, ref.memory_decoder.update_block.flow_head.conv2.weight,
        rtol=0, atol=0)


def test_train_cli_takes_ffpp(tmp_path):
    """``--optflow_model FlowFormerPlusPlus`` trains (2 steps, depth,
    the base trained) where it used to raise."""
    from mfcnet_tpu_torch.cli import train_multiframe_detection
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    pack = make_synthetic_pack(tmp_path / "pack",
                               videos=(("train", 1, 2), ("val", 1, 1)),
                               height=S, width=S, seed=0)
    state = train_multiframe_detection.main([
        "--dataset", "JIGSAWS", "--packed_dir", str(pack),
        "--expt_savedir", str(tmp_path), "--expt_name", "ffpp",
        "--batch_size", "1", "--num_workers", "1", "--num_epochs", "0",
        "--input_height", str(S), "--input_width", str(S),
        "--model_scale", "0.0625", "--add_optflow_inputs", "true",
        "--add_depth_inputs", "true", "--optflow_model",
        "FlowFormerPlusPlus", "--train_base_model", "true",
        "--device", "cpu"])
    assert state.step == 2


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_ffpp_float32_matches_the_cpu():
    """FFPP at default widths, 12 iterations, on the card in float32 with
    TF32 off against the same model on the CPU, 2 pairs at 64x96: within
    2e-3 px / 1e-3 (float32 sums in other orders through 12 recurrent
    iterations, the default-width tolerance against JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        init_ffpp_weights,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    m = init_ffpp_weights(FlowFormerPP(), torch.Generator().manual_seed(0),
                          flow_gain=0.25).eval()
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 96, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        want = m(a, b)
        with parity_mode():
            got = m.cuda()(a.cuda(), b.cuda()).cpu()
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


@pytest.mark.cuda
def test_cuda_ffpp_engine_launches():
    """A bf16 engine with FFPP and device decode on the card: one flow
    warp a fused frame, no RAFT update step, the decode's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        init_ffpp_weights,
    )
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    gen = torch.Generator().manual_seed(0)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, scale=0.25,
        generator=gen)
    flow = init_ffpp_weights(FlowFormerPP(iters=4), gen, flow_gain=0.25)
    cfg = TrackerConfig(input_height=128, input_width=160, decode="device",
                        decode_tie_fallback=False, overlay=False,
                        add_optflow_inputs=True)
    engine = InferenceEngine(model, cfg, flow_model=flow)
    frames = np.random.default_rng(0).integers(0, 255, (5, 128, 160, 3),
                                               dtype=np.uint8)
    for mod in (cc, raft_update, warp):
        mod.reset_launches()
    outs = [engine.step_async(f) for f in frames]
    torch.cuda.synchronize()
    assert warp.LAUNCHES["flow_warp"] == len(frames) - (T - 1)
    assert raft_update.LAUNCHES["raft_update"] == 0
    assert cc.LAUNCHES["onehot_stats"] > 0
    assert all(torch.isfinite(o[2].float()).all() for o in outs[T - 1:])
