"""The port's training CLIs end to end on the CPU (``--device cpu``) on a
pack of the port's synthetic generator: steps, checkpoints, the
interrupt snapshot and an exact resume, the tracking CLI loading the
checkpoint (and its EMA), the single-frame stage feeding
``--load_wts_base_model``, and the checkpoint through the JAX package's
``compat/torch_convert.py`` into the JAX model (the same eval forward,
1e-4 on probabilities: float32 convolutions summed in another order)."""

import json

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while a test runs: the suite runs several
    worker processes at once, and PyTorch's default of one thread per core
    in each of them oversubscribes the CPU (the training CLI test took
    ~16x its time alone with four workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


HW = 64


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    return make_synthetic_pack(tmp_path_factory.mktemp("pack"),
                               videos=(("train", 2, 4), ("val", 1, 2)),
                               height=HW, width=HW, seed=0)


def _common(pack, out, name):
    return ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
            "--expt_savedir", str(out), "--expt_name", name,
            "--batch_size", "2", "--num_workers", "2", "--num_epochs", "0",
            "--print_freq", "1", "--input_height", str(HW),
            "--input_width", str(HW), "--model_scale", "0.0625"]


def _args(pack, out, name, *extra, device="cpu"):
    dev = [] if device is None else ["--device", device]
    return _common(pack, out, name) + [
        "--loss_fns", "nll", "soft_jaccard", "--loss_wts", "0.7", "0.3",
        *dev, *extra]


FLOW_DEPTH = ("--add_optflow_inputs", "true", "--add_depth_inputs", "true",
              "--train_base_model", "true", "--grad_accum", "2",
              "--ema_decay", "0.9")


def test_train_cli_interrupt_resume_and_track(pack, tmp_path, monkeypatch):
    """One epoch (4 micro-steps, 2 updates) with RAFT inside the step,
    depth, the base trained, accumulation and EMA; the same run
    interrupted in its third micro-step and resumed from the snapshot ends
    with the same parameters; the tracking CLI loads the checkpoint with
    and without --use_ema."""
    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.utils.checkpoint import latest_checkpoint

    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(_args(pack, tmp_path, "x", *FLOW_DEPTH, device=None))
    full = cli.main(_args(pack, tmp_path, "full", *FLOW_DEPTH))
    assert (full.step, full.updates) == (4, 2)
    scalars = [json.loads(line) for line in (
        tmp_path / "full" / "logs" / "scalars.jsonl").read_text().split("\n")
        if line]
    tags = {s["tag"] for s in scalars}
    assert {"Training/Loss", "Training/Loss_nll", "Validation/Loss",
            "Validation/iou 1", "Validation/dice 4"} <= tags
    ck = tmp_path / "full" / "ckpts" / "model_000.pth"
    assert latest_checkpoint(ck.parent) == ck
    blob = torch.load(ck, weights_only=False)
    assert {"model", "optimizer", "epoch", "step", "ema"} <= set(blob)

    real = TrainState.apply_gradients

    def interrupting(self):
        if self.step == 2:  # the third micro-step, after its backward
            raise KeyboardInterrupt
        return real(self)

    monkeypatch.setattr(TrainState, "apply_gradients", interrupting)
    with pytest.raises(KeyboardInterrupt):
        cli.main(_args(pack, tmp_path, "cut", *FLOW_DEPTH))
    monkeypatch.setattr(TrainState, "apply_gradients", real)
    snap = tmp_path / "cut" / "ckpts" / "model_999.pth"
    meta = json.loads(snap.with_suffix(".json").read_text())
    assert meta == {"epoch": 0, "batches_done": 2}
    assert latest_checkpoint(snap.parent) == snap
    resumed = cli.main(_args(pack, tmp_path, "cut", *FLOW_DEPTH,
                             "--resume", "true"))
    assert (resumed.step, resumed.updates) == (4, 2)
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in full.ema:
        assert torch.equal(full.ema[k], resumed.ema[k]), k

    from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
        main as track,
    )
    from mfcnet_tpu_torch.data.synthetic import _video

    cv2 = pytest.importorskip("cv2")
    vdir, ddir = tmp_path / "vids", tmp_path / "depth"
    vdir.mkdir()
    ddir.mkdir()
    frames = list(_video(np.random.default_rng(3), HW, HW, 5))
    for d, name, pick in ((vdir, "a.mp4", lambda f: f[0][..., ::-1]),
                          (ddir, "a.mp4", lambda f: np.repeat(
                              f[4][..., None], 3, -1))):
        w = cv2.VideoWriter(str(d / name), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (HW, HW))
        for f in frames:
            w.write(np.ascontiguousarray(pick(f)))
        w.release()
    rows = {}
    for ema in ("false", "true"):
        track(["--videos_dir", str(vdir), "--depth_videos_dir", str(ddir),
               "--expt_savedir", str(tmp_path), "--expt_name", f"t{ema}",
               "--model_type", "TernausNetMulti-Basic",
               "--load_wts_model", str(ck), "--use_ema", ema,
               "--input_height", str(HW), "--input_width", str(HW),
               "--model_scale", "0.0625", "--compute_dtype", "float32",
               "--add_optflow_inputs", "true", "--add_depth_inputs", "true",
               "--device", "cpu"])
        rows[ema] = np.loadtxt(tmp_path / f"t{ema}" / "video_tracking_results"
                               / "a_tracked.csv", delimiter=",")
        assert rows[ema].shape == (5, 12)


def test_single_frame_stage_feeds_the_base_and_converts_to_jax(pack,
                                                               tmp_path):
    """TernausNet16 trained alone; its checkpoint loads as the multi-frame
    model's base (at lr / (100 T)); the multi-frame checkpoint converts
    with the JAX package's torch_convert into the JAX model, which gives
    the port's eval forward."""
    import jax

    from mfcnet_tpu.compat.torch_convert import (
        convert_multiframe_ternausnet,
        load_torch_state_dict,
    )
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.cli.train_multiframe_detection import main
    from mfcnet_tpu_torch.cli.train_toolpose_segmentation import (
        main as sf_main,
    )

    sf = sf_main(_common(pack, tmp_path, "sf") + ["--device", "cpu"])
    assert sf.step == 4
    base_ck = tmp_path / "sf" / "ckpts" / "model_000.pth"
    mf = main(_args(pack, tmp_path, "mf", "--add_depth_inputs", "true",
                    "--train_base_model", "true",
                    "--load_wts_base_model", str(base_ck)))
    head, base = mf.optimizer.param_groups
    assert base["scale"] == pytest.approx(1 / 300)
    assert base["lr"] == pytest.approx(head["lr"] / 300)
    # TAPNet trains from the image tree only (its attention maps);
    # tests/test_torch_zoo10b_paths.py trains it there
    with pytest.raises(SystemExit, match="no attention maps"):
        sf_main(_common(pack, tmp_path, "sf2") + [
            "--model_type", "TAPNet16", "--device", "cpu"])

    sd, epoch = load_torch_state_dict(tmp_path / "mf" / "ckpts"
                                      / "model_000.pth")
    variables = convert_multiframe_ternausnet(sd)
    jm = jget("TernausNetMulti-Basic", 5, 3, add_depth_inputs=True,
              scale=0.0625)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((1, 3, HW, HW, 3)).astype(np.float32)
    depth = rng.random((1, 3, HW, HW, 1)).astype(np.float32)
    want = jax.nn.softmax(jm.apply(variables, frames, depth=depth), -1)
    model = mf.model.eval()
    with torch.no_grad():
        got = torch.softmax(model(torch.from_numpy(frames),
                                  depth=torch.from_numpy(depth)), -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
