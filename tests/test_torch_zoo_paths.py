"""The zoo's Multi families on the port's main paths, against the JAX
package on the CPU: each family's Basic and Large engine (incremental and
full, float32, host decode) against the JAX engine on the same variables
and frames; the multi-frame train step (DeepLab and HRNet with the base
trained, FCN and SegFormer with it frozen: their dropout and drop-path
draw other numbers than JAX's) and the single-frame train step (DeepLab,
HRNet) against JAX's; the three CLIs with the new types on the CPU, and
with the types of ROADMAP item 10b that they once refused; and, on a card, one
family's engine through the kernels against its plain versions.

Weights: JAX variables filled from numpy over ``jax.eval_shape``'s tree
(``tests/test_torch_zoo_models.py::fill_like``), carried into the port
by ``compat.from_jax``. Tolerances as ``tests/test_torch_large.py``'s:
the engine's probabilities within 1e-3 (the heatmap gate; the outputs
are float16 heats), class masks and CSV rows equal; the train steps as
``tests/test_torch_train_steps.py``'s (loss parts 1e-5 relative;
parameters and running statistics within 1e-5 of each tensor's largest
magnitude plus 1e-4 of the learning rate, one element in a thousand to 2
% of it; a frozen base bit-identical).

The steps that train the base run in float64 on both sides (JAX under
``enable_x64``; the losses stay float32 in both, as both steps cast the
logits): in float32 each train-mode BN carries flax's own float32
statistics error (up to ~1e-5, ``tests/test_torch_zoo_bn.py``) on, through
the ~20 (DeepLab) to ~60 (HRNet) of them, and DeepLab's image-pooling BN
over two positions multiplies it by ~100; the gradients then differ by
~1 %, and Adam's first update, about lr * sign(g), moves every element
whose small gradient changed sign by 2 lr (found: DeepLab 0.67 lr, HRNet
1.9 lr in float32). The frozen-base steps run in float32. In float64 the
float32 losses still leave a gradient of the order of Adam's eps (1e-8) a
relative difference that the update passes on whole: such elements (found:
1 to 36 in a tensor, never more than one in a thousand; up to 0.57 lr)
may be off by up to 2 lr, the rest within the float32 bound
(``_assert_sd_close_f64``)."""

import contextlib

import numpy as np
import pytest
import torch

T, C = 3, 5
SCALE = 0.125
FAMILIES = ("DeepLab", "FCN", "HRNet", "SegFormer")
LOSSES = (["nll", "soft_jaccard"], [0.7, 0.3])
CLASS_WEIGHTS = [1, 50, 50, 50, 50]
LR = 1e-3


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _multi(family, variant, depth, hw, seed=3, flow=False):
    """(JAX Multi model, its numpy variables, the port's model on them)."""
    import jax

    from tests.test_torch_zoo_models import fill_like

    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    mt = f"{family}Multi-{variant}"
    jm = jget(mt, C, T, scale=SCALE)
    h, w = hw
    kw = {}
    if flow:
        kw["optflow"] = np.zeros((1, T - 1, h, w, 2), np.float32)
    if depth:
        kw["depth"] = np.zeros((1, T, h, w, 1), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), np.zeros((1, T, h, w, 3), np.float32),
        **kw))
    v = fill_like(shapes, seed)
    pm = get_multiframe_segmentation_model(
        mt, C, T, add_optflow_inputs=flow and variant == "Large",
        add_depth_inputs=depth, scale=SCALE)
    return jm, v, load_jax_variables(pm, v).eval()


@pytest.mark.parametrize("mode", ["incremental", "full"])
@pytest.mark.parametrize("variant", ["Basic", "Large"])
@pytest.mark.parametrize("family", FAMILIES)
def test_zoo_engine_matches_jax_engine(family, variant, mode):
    """The engine as a whole, float32, host decode: the Basic head on the
    class maps, the Large head with depth; rows from each engine's
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

    H = W = 64
    depth = variant == "Large"
    jm, v, pm = _multi(family, variant, depth, (H, W))
    frames = make_synthetic_frames(num_frames=5, height=H, width=W, seed=5)
    dmaps = np.ascontiguousarray(frames[..., 0])
    kw = dict(num_input_frames=T, num_classes=C, input_height=H,
              input_width=W, dtype="float32", mode=mode, overlay=False,
              add_depth_inputs=depth)
    je = JEngine(jm, v, JCfg(**kw))
    pe = InferenceEngine(pm, TrackerConfig(**kw), device="cpu")
    jt, pt = JTracker(len(frames), JCfg(**kw)), KeypointTracker(
        len(frames), TrackerConfig(**kw))
    for t in range(len(frames)):
        d = dmaps[t] if depth else None
        want, got = je.step(frames[t], d), pe.step(frames[t], d)
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
    np.testing.assert_array_equal(pt.rows, jt.rows)


def _batch(rng, B, h, w, depth=True):
    out = {"frames": rng.standard_normal((B, T, h, w, 3)).astype(np.float32),
           "mask": rng.integers(0, C, (B, h, w)).astype(np.int32)}
    if depth:
        out["depth"] = rng.random((B, T, h, w, 1)).astype(np.float32)
    return out


def _torch_batch(batch):
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tb["mask"] = tb["mask"].long()
    return tb


def jax_tree_as(tree, dtype):
    """Every floating leaf of a tree of numpy arrays as ``dtype``."""
    import jax

    def one(a):
        return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

    return jax.tree_util.tree_map(one, tree)


@contextlib.contextmanager
def _jax_dtype(dt):
    """JAX with 64-bit types for a float64 run."""
    if dt != np.float64:
        yield
        return
    import jax

    with jax.enable_x64(True):
        yield


def _assert_sd_close_f64(got, want):
    """``test_torch_train_steps._assert_sd_close``'s per-tensor bound, but
    its one element in a thousand may be off by up to 2 lr (see the module
    docstring)."""
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        err = (got[k].float() - w).abs()
        tight = 1e-5 * float(w.abs().max())
        assert float(err.max()) <= tight + 2 * LR, (k, float(err.max()))
        n_loose = int((err > tight + 1e-4 * LR).sum())
        assert n_loose <= max(1, err.numel() // 1000), (k, n_loose)


@pytest.mark.parametrize("family,train_base", [
    ("DeepLab", True), ("HRNet", True), ("FCN", False),
    ("SegFormer", False)])
def test_zoo_multiframe_train_step_matches_jax(family, train_base):
    """One float32 step of the Basic model with a fixed flow (the warp,
    and its plain backward where the base trains) and depth: loss parts,
    every parameter, the base's and the head's running statistics; a
    frozen base runs in eval mode and stays bit-identical."""
    import jax.numpy as jnp

    from tests.test_torch_train_steps import _assert_sd_close

    from mfcnet_tpu.train.schedule import make_schedule as jsched
    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.state import multiframe_optimizer
    from mfcnet_tpu.train.steps import make_multiframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    B, h, w = 2, 64, 32
    # float64 where the base trains (see the module docstring); a fixed
    # flow for the warp where it is frozen
    dt = np.float64 if train_base else np.float32
    jm, v, pm = _multi(family, "Basic", True, (h, w), seed=0,
                       flow=not train_base)
    v = jax_tree_as(v, dt)
    pm = pm.to(torch.float64 if train_base else torch.float32)
    v0 = {k: t.clone() for k, t in pm.state_dict().items()}
    rng = np.random.default_rng(0)
    flow = rng.uniform(-4, 4, (B, T - 1, h, w, 2)).astype(np.float32)
    batch = {k: x.astype(dt) if x.dtype == np.float32 else x
             for k, x in _batch(rng, B, h, w).items()}

    with _jax_dtype(dt):
        tx = multiframe_optimizer(jsched("StepDecay", LR, 2, 1), T,
                                  train_base, False)
        st = JState.create(jm.apply, v["params"], tx, v["batch_stats"])
        step = jstep(jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
                     train_base_model=train_base,
                     flow_fn=None if train_base
                     else lambda f: jnp.asarray(flow), donate=False)
        st, jparts = step(st, batch)

    pst = TrainState(pm, make_schedule("StepDecay", LR, 2, 1), T,
                     train_base_model=train_base)
    pstep = make_multiframe_train_step(
        *LOSSES, C, class_weights=CLASS_WEIGHTS,
        flow_fn=None if train_base else lambda f: torch.from_numpy(flow))
    pparts = pstep(pst, _torch_batch(batch))
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    want = state_dict_from_jax({"params": st.params,
                                "batch_stats": st.batch_stats}, pm)
    (_assert_sd_close_f64 if train_base else _assert_sd_close)(
        pm.state_dict(), want)
    base = [k for k in v0 if k.startswith("base_model.")]
    moved = [k for k in base if not torch.equal(pm.state_dict()[k], v0[k])]
    if train_base:
        assert any("running_var" in k for k in moved)
    else:
        assert moved == []


@pytest.mark.parametrize("kind", ["DeepLab_v3", "HRNet"])
def test_zoo_singleframe_train_step_matches_jax(kind):
    """One float32 single-frame step (plain Adam on everything, the logits
    through a float32 log-softmax), batch 1 for DeepLab: its
    image-pooling BN then sees one position per channel."""
    import optax

    from tests.test_torch_zoo_models import jax_base

    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.steps import make_singleframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import (
        load_jax_variables,
        state_dict_from_jax,
    )
    from mfcnet_tpu_torch.models import (
        OUTPUT_MODES,
        get_tooltip_segmentation_model,
    )
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_singleframe_train_step

    jm, v, _, _ = jax_base(kind)
    v = jax_tree_as(v, np.float64)
    B = 1 if kind == "DeepLab_v3" else 2
    rng = np.random.default_rng(4)
    batch = {"image": rng.standard_normal((B, 64, 40, 3)),
             "mask": rng.integers(0, C, (B, 64, 40)).astype(np.int32)}
    with _jax_dtype(np.float64):
        st = JState.create(jm.apply, v["params"], optax.adam(LR),
                           v["batch_stats"])
        st, jparts = jstep(jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
                           output_mode="logits", donate=False)(st, batch)

    # the variables are float32 values: the float32 state_dict is exact
    pm = load_jax_variables(
        get_tooltip_segmentation_model(kind, C, scale=SCALE), v).double()
    pst = TrainState(pm, lambda i: LR, split_base=False)
    pparts = make_singleframe_train_step(
        *LOSSES, C, class_weights=CLASS_WEIGHTS,
        output_mode=OUTPUT_MODES[kind])(pst, _torch_batch(batch))
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    _assert_sd_close_f64(pm.state_dict(), state_dict_from_jax(
        {"params": st.params, "batch_stats": st.batch_stats}, pm))


def test_zoo_clis_take_the_new_types(tmp_path):
    """The single-frame CLI trains SegFormer (drop-path on) and DeepLab_v3;
    the multi-frame CLI trains DeepLabMulti-Basic with that DeepLab as its
    base (``--load_wts_base_model``, by name) and the base trained, and
    HRNetMulti-Large with depth; the tracking CLI tracks with each
    checkpoint, two videos at once for the Large one (``--parallel_videos
    2``). All on the CPU (``--device cpu``), at scale 1/8, 64x64."""
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.cli import test_multiframe_segmentation_on_videos
    from mfcnet_tpu_torch.cli import train_multiframe_detection
    from mfcnet_tpu_torch.cli import train_toolpose_segmentation
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.utils.checkpoint import latest_checkpoint

    pack = make_synthetic_pack(tmp_path / "pack",
                               videos=(("train", 1, 2), ("val", 1, 1)),
                               height=64, width=64, seed=0)
    common = ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
              "--expt_savedir", str(tmp_path), "--batch_size", "2",
              "--num_workers", "1", "--num_epochs", "0",
              "--model_scale", "0.125", "--input_height", "64",
              "--input_width", "64", "--device", "cpu"]
    for kind in ("SegFormer", "DeepLab_v3"):
        sf = train_toolpose_segmentation.main(
            common + ["--model_type", kind, "--expt_name", kind])
        assert sf.step > 0
        assert all(torch.isfinite(p).all() for p in sf.model.parameters())
    base_ck = latest_checkpoint(tmp_path / "DeepLab_v3" / "ckpts")
    for i in range(2):
        for kind, seed in (("vids", i), ("depth", 10 + i)):
            make_synthetic_video(tmp_path / kind / f"v{i}.mp4", num_frames=5,
                                 height=64, width=64, seed=seed)
    for mt, extra, track in (
            ("DeepLabMulti-Basic", ["--train_base_model", "true",
                                    "--load_wts_base_model", str(base_ck)],
             []),
            ("HRNetMulti-Large", ["--add_depth_inputs", "true"],
             ["--add_depth_inputs", "true", "--depth_videos_dir",
              str(tmp_path / "depth"), "--parallel_videos", "2"])):
        mf = train_multiframe_detection.main(
            common + ["--model_type", mt, "--expt_name", mt] + extra)
        assert mf.step > 0
        test_multiframe_segmentation_on_videos.main([
            "--model_type", mt, "--load_wts_model",
            str(latest_checkpoint(tmp_path / mt / "ckpts")),
            "--videos_dir", str(tmp_path / "vids"),
            "--expt_savedir", str(tmp_path), "--expt_name", f"track_{mt}",
            "--model_scale", "0.125", "--input_height", "64",
            "--input_width", "64", "--compute_dtype", "float32",
            "--device", "cpu"] + track)
        out = tmp_path / f"track_{mt}" / "video_tracking_results"
        for i in range(2):
            rows = np.loadtxt(out / f"v{i}_tracked.csv", delimiter=",")
            assert rows.shape == (5, 12)


@pytest.mark.parametrize("cli,argv", [
    ("train_toolpose_segmentation", ["--model_type", "TernausNet11"]),
    ("train_toolpose_segmentation", ["--model_type", "UNet"]),
    ("train_multiframe_detection", ["--model_type", "UNetMulti-Basic"]),
    ("train_multiframe_detection", ["--model_type", "ResUNetMulti-Large"]),
    ("test_multiframe_segmentation_on_videos",
     ["--model_type", "UNetMulti-Large", "--load_wts_model", "x.pth",
      "--videos_dir", "."]),
    ("test_multiframe_segmentation_on_videos",
     ["--model_type", "ResUNetMulti-Basic", "--load_wts_model", "x.pth",
      "--videos_dir", "."]),
])
def test_zoo_clis_refuse_later_types(tmp_path, monkeypatch, cli, argv):
    """TernausNet11, UNet, ResUNet and their Multi families, which the CLIs
    refused until ROADMAP item 10b was ported, now run at 64x64 and scale
    1/16 on the CPU: one train step of each trainer on a pack of one
    sample (TAPNet, which reads the image tree, in
    ``tests/test_torch_zoo10b_paths.py``), and the tracking CLI over a
    4-frame video with a checkpoint of the registry's model."""
    import importlib

    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    main = importlib.import_module(f"mfcnet_tpu_torch.cli.{cli}").main
    monkeypatch.chdir(tmp_path)
    common = ["--expt_savedir", str(tmp_path), "--expt_name", "x",
              "--device", "cpu", "--model_scale", "0.0625",
              "--input_height", "64", "--input_width", "64"]
    if cli.startswith("train"):
        pack = make_synthetic_pack(tmp_path / "pack",
                                   videos=(("train", 1, 1), ("val", 1, 1)),
                                   height=64, width=64, seed=0)
        common += ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
                   "--num_workers", "1", "--num_epochs", "0"]
        state = main(common + argv)
        assert state.step == 1
        assert all(torch.isfinite(p).all() for p in state.model.parameters())
        return
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    torch.save(get_multiframe_segmentation_model(
        argv[1], C, T, scale=0.0625,
        generator=torch.Generator().manual_seed(0)).state_dict(), "x.pth")
    make_synthetic_video(tmp_path / "v.mp4", num_frames=4, height=64,
                         width=64, seed=0)
    main(common + argv + ["--compute_dtype", "float32"])
    rows = np.loadtxt(tmp_path / "x" / "video_tracking_results"
                      / "v_tracked.csv", delimiter=",")
    assert rows.shape == (4, 12)


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel of the RAFT path swapped for its plain version (on the
    same CUDA tensors): the decode's ``cc.cu`` kernels, the flow warp and
    the RAFT update step (``tests/test_torch_streams.py::plain_kernels``;
    on the card the suite runs without its conftest, and this file
    imports no other test module there)."""
    from unittest import mock

    from mfcnet_tpu_torch.models import mfcnet
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track import decode_device as dd

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.multiple(
            cc, connected_components=cc.connected_components_plain,
            flood_cc_cid=cc.flood_cc_cid_plain,
            union_flood_cc_cid=cc.union_flood_cc_cid_plain,
            onehot_stats=cc.onehot_stats_plain))
        stack.enter_context(mock.patch.object(
            dd, "connected_components", cc.connected_components_plain))
        stack.enter_context(mock.patch.object(
            raft_update, "raft_update", raft_update.raft_update_plain))
        stack.enter_context(mock.patch.object(mfcnet, "flow_warp",
                                              warp.flow_warp_plain))
        yield


@pytest.mark.cuda
def test_cuda_hrnet_engine_through_kernels_matches_plain_versions():
    """A bf16 HRNetMulti-Basic engine with RAFT and device decode on the
    card against the same engine with every kernel swapped for its plain
    version: the update step, the warp and the decode's kernels run, and
    the heats agree within 2^-13 and one float16 step near 0.2 (the RAFT
    path's limit, ``chip_smoke.py``'s FLOW_PROB_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    gen = torch.Generator().manual_seed(0)
    model = get_multiframe_segmentation_model(
        "HRNetMulti-Basic", C, T, add_optflow_inputs=True, scale=0.25,
        generator=gen)
    cfg = TrackerConfig(input_height=128, input_width=160, decode="device",
                        decode_tie_fallback=False, overlay=False,
                        add_optflow_inputs=True)
    flow = init_weights(RAFT(iters=4), gen)
    frames = np.random.default_rng(0).integers(0, 255, (5, 128, 160, 3),
                                               dtype=np.uint8)
    engine = InferenceEngine(model, cfg, flow_model=flow)
    plain = InferenceEngine(model, cfg, flow_model=flow)
    for mod in (cc, raft_update, warp):
        mod.reset_launches()
    outs = [engine.step_async(f) for f in frames]
    fused = len(frames) - (T - 1)
    assert raft_update.LAUNCHES["raft_update"] == 4 * fused
    assert warp.LAUNCHES["flow_warp"] == fused
    assert cc.LAUNCHES["onehot_stats"] > 0
    with _plain_kernels():
        want = [plain.step_async(f) for f in frames]
    for got, ref in zip(outs[T - 1:], want[T - 1:]):
        torch.testing.assert_close(got[2].float(), ref[2].float(), rtol=0,
                                   atol=2.0 ** -13 + 2.0 ** -13)
