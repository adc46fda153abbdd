"""The rest of the zoo on the port's main paths, against the JAX package on
the CPU: UNetMulti-Basic with the frozen RAFT provider through the engine
(incremental and full) and ResUNetMulti-Large with depth, against one JAX
engine each; TAPNet's single-frame train and eval steps
(``output_mode="tapnet"``: the image and the attention map); one
UNetMulti-Basic multi-frame step with the base trained; and the
single-frame CLI training TAPNet16 for one epoch on an image tree, which
rewrites its ``attmaps/``.

Weights: JAX variables filled from numpy over ``jax.eval_shape``'s tree
(``tests/test_torch_zoo_models.py::fill_like``), carried into the port by
``compat.from_jax``. Tolerances as ``tests/test_torch_zoo_paths.py``'s:
the engine's probabilities within 1e-3 (the heatmap gate; float16 heats),
class masks and CSV rows equal; the steps' loss parts within 1e-5
relative, parameters as ``tests/test_torch_train_steps.py`` holds them;
the base-trained UNet step in float64 on both sides, as the BN'd bases'
steps of ``tests/test_torch_zoo_paths.py``, its parameters as
``_assert_sd_close_adam`` holds them."""

import numpy as np
import pytest
import torch

from tests.test_torch_zoo_models import fill_like

T, C = 3, 5
H = W = 64
SCALE = 0.0625
LOSSES = (["nll", "soft_jaccard"], [0.7, 0.3])
CLASS_WEIGHTS = [1, 50, 50, 50, 50]
LR = 1e-3


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _multi(model_type, depth, seed=3):
    """(JAX Multi model, its numpy variables, the port's model on them)."""
    import jax

    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    jm = jget(model_type, C, T, scale=SCALE)
    kw = {"depth": np.zeros((1, T, H, W, 1), np.float32)} if depth else {}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), np.zeros((1, T, H, W, 3), np.float32), **kw))
    v = fill_like(shapes, seed)
    pm = get_multiframe_segmentation_model(model_type, C, T,
                                           add_depth_inputs=depth,
                                           scale=SCALE)
    return jm, v, load_jax_variables(pm, v).eval()


@pytest.fixture(scope="module")
def raft():
    """(JAX RAFT, its variables, the port's RAFT on them), iters=2, at the
    engine's half resolution."""
    import jax

    from mfcnet_tpu.models.raft import RAFT as JRAFT
    from mfcnet_tpu_torch.compat.from_jax import raft_state_dict_from_jax
    from mfcnet_tpu_torch.models.raft import RAFT

    jf = JRAFT(iters=2)
    d = np.zeros((1, H // 2, W // 2, 3), np.float32)
    shapes = jax.eval_shape(lambda: jf.init(jax.random.PRNGKey(4), d, d))
    fv = fill_like(shapes, 4)
    pf = RAFT(iters=2, input_hw=(H // 2, W // 2)).eval()
    pf.load_state_dict(raft_state_dict_from_jax(fv))
    return jf, fv, pf


def _track(engines, frames, dmaps=None):
    """Step every engine over the frames; the first is the JAX one. Heats
    within 1e-3 of JAX's, class masks equal, then each engine's rows
    through its own package's tracker, equal."""
    from mfcnet_tpu.track.tracker import KeypointTracker as JTracker
    from mfcnet_tpu_torch.track.tracker import KeypointTracker

    jt = JTracker(len(frames), engines[0].cfg)
    pts = [KeypointTracker(len(frames), e.cfg) for e in engines[1:]]
    for t in range(len(frames)):
        d = None if dmaps is None else dmaps[t]
        outs = [e.step(frames[t], d) for e in engines]
        want = outs[0]
        for got in outs[1:]:
            assert (want is None) == (got is None) == (t < T - 1)
        if want is None:
            for tr in [jt] + pts:
                tr.skip()
            continue
        for got, tr in zip(outs[1:], pts):
            np.testing.assert_allclose(got[1].astype(np.float32),
                                       want[1].astype(np.float32), rtol=0,
                                       atol=1e-3)
            np.testing.assert_array_equal(got[0], want[0])
            h = got[1].astype(np.float32)
            tr.update(got[0], h[..., 1], h[..., 0])
        h = want[1].astype(np.float32)
        jt.update(want[0], h[..., 1], h[..., 0])
    for tr in pts:
        np.testing.assert_array_equal(tr.rows, jt.rows)


@pytest.mark.parametrize("model_type,flow,depth", [
    ("UNetMulti-Basic", True, False), ("ResUNetMulti-Large", False, True)])
def test_engines_match_the_jax_engine(raft, model_type, flow, depth):
    """The JAX engine (incremental) against the port's incremental and
    full engines, float32, host decode: UNetMulti-Basic warping its raw
    logits by RAFT's flow; ResUNetMulti-Large with depth."""
    from mfcnet_tpu.data.synthetic import make_synthetic_frames
    from mfcnet_tpu.track.tracker import InferenceEngine as JEngine
    from mfcnet_tpu.track.tracker import TrackerConfig as JCfg
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    jm, v, pm = _multi(model_type, depth)
    jf, fv, pf = raft
    frames = make_synthetic_frames(num_frames=5, height=H, width=W, seed=5)
    dmaps = np.ascontiguousarray(frames[..., 0]) if depth else None
    kw = dict(num_input_frames=T, num_classes=C, input_height=H,
              input_width=W, dtype="float32", overlay=False,
              add_optflow_inputs=flow, add_depth_inputs=depth)
    je = JEngine(jm, v, JCfg(**kw), **(
        {"flow_model": jf, "flow_variables": fv} if flow else {}))
    pes = [InferenceEngine(pm, TrackerConfig(mode=m, **kw), device="cpu",
                           flow_model=pf if flow else None)
           for m in ("incremental", "full")]
    _track([je] + pes, frames, dmaps)


def _batch(rng, B, h, w, depth=True):
    out = {"frames": rng.standard_normal((B, T, h, w, 3)),
           "mask": rng.integers(0, C, (B, h, w)).astype(np.int32)}
    if depth:
        out["depth"] = rng.random((B, T, h, w, 1))
    return out


def _torch_batch(batch):
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tb["mask"] = tb["mask"].long()
    return tb


def _assert_sd_close_adam(got, want, grads):
    """Every element within 1e-5 of its tensor's largest magnitude plus
    1e-4 of the learning rate, except elements whose gradient is below
    1 % of the tensor's largest gradient, whose sign Adam's first update
    (about lr * sign(g)) may take the other way: up to 2 lr. Their
    gradient is within the noise of a float64 step compared with the JAX
    package's, whose fusion head takes its batch statistics in float32
    whatever the step's type (``mfcnet_tpu/models/mfcnet.py``,
    ``bn_train``); the port's take them in float64 (found: 429 of 332,894
    elements off, all below 0.3 % of their tensor's largest gradient)."""
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        err = (got[k].double() - w.double()).abs()
        tight = 1e-5 * float(w.abs().max()) + 1e-4 * LR
        loose = torch.zeros_like(err, dtype=torch.bool)
        if k in grads:
            g = grads[k].abs()
            loose = g < 1e-2 * float(g.max())
        strict = err[~loose]
        assert strict.numel() == 0 or float(strict.max()) <= tight, (
            k, float(strict.max()), int(loose.sum()))
        assert float(err.max()) <= tight + 2 * LR, (k, float(err.max()))


def test_unet_multiframe_step_with_the_base_trained_matches_jax():
    """One UNetMulti-Basic step with depth, the base trained (its BNs in
    train mode), in float64 on both sides: loss parts, every parameter and
    the base's and head's running statistics."""
    from tests.test_torch_zoo_paths import _jax_dtype, jax_tree_as

    from mfcnet_tpu.train.schedule import make_schedule as jsched
    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.state import multiframe_optimizer
    from mfcnet_tpu.train.steps import make_multiframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    jm, v, pm = _multi("UNetMulti-Basic", True, seed=0)
    v = jax_tree_as(v, np.float64)
    pm = pm.double()
    v0 = {k: t.clone() for k, t in pm.state_dict().items()}
    batch = _batch(np.random.default_rng(0), 2, H, 32)
    with _jax_dtype(np.float64):
        tx = multiframe_optimizer(jsched("StepDecay", LR, 2, 1), T, True,
                                  False)
        st = JState.create(jm.apply, v["params"], tx, v["batch_stats"])
        st, jparts = jstep(jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
                           train_base_model=True, donate=False)(st, batch)
    pst = TrainState(pm, make_schedule("StepDecay", LR, 2, 1), T,
                     train_base_model=True)
    pparts = make_multiframe_train_step(*LOSSES, C,
                                        class_weights=CLASS_WEIGHTS)(
        pst, _torch_batch(batch))
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    # Adam's first moment after one update is 0.1 g
    grads = {n: pst.optimizer.state[p]["exp_avg"] / 0.1
             for n, p in pm.named_parameters() if p in pst.optimizer.state}
    _assert_sd_close_adam(pm.state_dict(), state_dict_from_jax(
        {"params": st.params, "batch_stats": st.batch_stats}, pm), grads)
    moved = [k for k in v0 if k.startswith("base_model.")
             and not torch.equal(pm.state_dict()[k], v0[k])]
    assert any("running_var" in k for k in moved)


@pytest.fixture(scope="module")
def tapnet():
    """(JAX TAPNet11 at a tiny width, its variables, a batch of 4-channel
    images and masks)."""
    import jax

    from mfcnet_tpu.models.tapnet import TAPNet11

    stages = ((4,), (8,), (8, 8), (16, 16), (16, 16))
    jm = TAPNet11(num_classes=C, stage_convs=stages, width_mult=0.0625)
    x = np.zeros((1, H, W, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, x[..., :1]))
    rng = np.random.default_rng(6)
    image = np.concatenate([rng.standard_normal((2, H, W, 3)),
                            rng.random((2, H, W, 1))], -1).astype(np.float32)
    batch = {"image": image,
             "mask": rng.integers(0, C, (2, H, W)).astype(np.int32)}
    return jm, fill_like(shapes, 7), batch, stages


def _port_tapnet(v, stages):
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models.tapnet import TAPNet11

    return load_jax_variables(TAPNet11(C, stages, width_mult=0.0625), v)


def test_tapnet_train_step_matches_jax(tapnet):
    """One float32 ``tapnet`` step (plain Adam): the model takes
    ``x[..., :3]`` and ``x[..., 3:]``; loss parts and every parameter."""
    import optax

    from tests.test_torch_train_steps import _assert_sd_close

    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.steps import make_singleframe_train_step as jstep
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_singleframe_train_step

    jm, v, batch, stages = tapnet
    st = JState.create(jm.apply, v["params"], optax.adam(LR), {})
    st, jparts = jstep(jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
                       output_mode="tapnet", donate=False)(st, batch)
    pm = _port_tapnet(v, stages)
    pst = TrainState(pm, lambda i: LR, split_base=False)
    pparts = make_singleframe_train_step(
        *LOSSES, C, class_weights=CLASS_WEIGHTS, output_mode="tapnet")(
        pst, _torch_batch(batch))
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    want = state_dict_from_jax({"params": st.params}, pm)
    assert any(not torch.equal(t, want[k]) for k, t in
               _port_tapnet(v, stages).state_dict().items())
    _assert_sd_close(pm.state_dict(), want)


def test_tapnet_eval_step_matches_jax(tapnet):
    """The eval step: log-probabilities within 1e-5, losses and IoU/Dice
    within 1e-5 relative."""
    from mfcnet_tpu.train.state import TrainState as JState
    from mfcnet_tpu.train.steps import make_singleframe_eval_step as jstep
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_singleframe_eval_step

    import optax

    jm, v, batch, stages = tapnet
    st = JState.create(jm.apply, v["params"], optax.adam(LR), {})
    jlp, jparts = jstep(jm, *LOSSES, ["iou", "dice"], C,
                        class_weights=CLASS_WEIGHTS,
                        output_mode="tapnet")(st, batch)
    pst = TrainState(_port_tapnet(v, stages), lambda i: LR, split_base=False)
    plp, pparts = make_singleframe_eval_step(
        *LOSSES, ["iou", "dice"], C, class_weights=CLASS_WEIGHTS,
        output_mode="tapnet")(pst, _torch_batch(batch))
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=0,
                               atol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(np.asarray(pparts[k], np.float64),
                                   np.asarray(jparts[k], np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_tapnet16_cli_trains_an_epoch_and_rewrites_the_attention_maps(
        tmp_path_factory):
    """The single-frame CLI with TAPNet16 on a 2-video x 3-frame JIGSAWS
    tree (32x32, OpenCV): one epoch, validation, then every training
    frame's ``attmaps/`` PNG rewritten as uint8(255 * (1 - p(background)))
    of the trained model, each frame given the previous frame's new map
    (zeros at a video's first frame); a pack is refused, naming the
    reason."""
    import cv2

    from mfcnet_tpu_torch.cli import train_toolpose_segmentation as sf
    from mfcnet_tpu_torch.data.files import get_dataset_filenames
    from mfcnet_tpu_torch.data.synthetic import make_jigsaws_like_dataset
    from mfcnet_tpu_torch.data.transforms import TransformConfig

    # no 'frame', 'images' or 'jpg' in the path: the loaders replace them
    root = tmp_path_factory.mktemp("tree")
    h = w = 32
    make_jigsaws_like_dataset(root, num_videos=2, frames_per_video=3,
                              height=h, width=w, seed=0)
    for split in ("annotations_train", "annotations_val"):
        for v in (1, 2):
            d = root / split / f"video_{v}" / "attmaps"
            d.mkdir()
            for f in range(3):
                cv2.imwrite(str(d / f"frame_{f:04d}.png"),
                            np.full((h, w), 128, np.uint8))
    state = sf.main([
        "--dataset", "JIGSAWS", "--data_dir", str(root),
        "--expt_savedir", str(root), "--expt_name", "tap",
        "--model_type", "TAPNet16", "--num_frames_per_video", "3",
        "--batch_size", "2", "--num_workers", "1", "--num_epochs", "0",
        "--model_scale", "0.0625", "--input_height", str(h),
        "--input_width", str(w), "--device", "cpu"])
    assert state.step == 3
    model = state.model.eval()
    files, _ = get_dataset_filenames("JIGSAWS", root, "training")
    tcfg = TransformConfig(out_height=h, out_width=w)
    ds, _, _ = sf.tapnet_loaders(sf.toolposeseg_train_parser().parse_args([
        "--dataset", "JIGSAWS", "--data_dir", str(root),
        "--num_frames_per_video", "3", "--input_height", str(h),
        "--input_width", str(w)]))
    for idx, f in enumerate(files):
        sample = ds[idx]
        batch = sf._single(sf.preprocess_eval_batch(
            sf._frames({k: a[None] for k, a in sample.items()}), tcfg),
            sample["attmap"][None])
        x = batch["image"].permute(0, 3, 1, 2)
        with torch.no_grad():
            fg = 1.0 - torch.exp(model(x[:, :3], x[:, 3:])[0, 0])
        want = (fg.numpy() * 255).astype(np.uint8)
        got = cv2.imread(str(f).replace("images", "attmaps").replace(
            "jpg", "png"), 0)
        np.testing.assert_array_equal(got, want, err_msg=str(f))
        assert (got != 128).any()
    with pytest.raises(SystemExit, match="no attention maps"):
        sf.main(["--model_type", "TAPNet11", "--packed_dir", str(root),
                 "--device", "cpu"])
