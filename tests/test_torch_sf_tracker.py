"""The port's single-frame video tracking CLI against the JAX package's on
the CPU, with the flags of ``tests/test_cli_more.py``'s single-frame video
test: a five-frame 64x64 synthetic video read at 32x32, ``--model_scale
0.1``, float32, the same weights on both sides (JAX variables filled from
numpy, a flax msgpack for the JAX CLI and their ``compat.from_jax``
conversion as the port's ``.pth``).

Held: the host decode's CSV rows equal to the JAX CLI's (float32 heats on
both sides); the device decode on the port's plain route within the north
star's gate of the JAX CLI's device-decode rows (the same detections, tip
RMSE <= 0.5 px) and the engine's probabilities within 1e-3 of the JAX
model's; ``--score_detection_threshold 0.3`` with a logits base (ResUNet), its
rows equal; ``--use_ema`` on a checkpoint of the port's single-frame
trainer; the refusals (TAPNet; ``--spatial_shards``, naming its ROADMAP
item; ``--artifact`` on a file that is no artifact, with the loader's
message); ``--device`` defaulting to the card; and the
annotation-frame CLI writing the JAX CLI's file names and pixels."""

import numpy as np
import pytest
import torch

from tests.test_torch_infer_cli import write_weights
from torch_threads import _two_torch_threads  # noqa: F401

C, HW, SCALE = 5, 32, 0.1
#: the north star's gates (BASELINE.json): heats, tip RMSE in px
HEAT_TOL, TIP_RMSE = 1e-3, 0.5


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_video

    d = tmp_path_factory.mktemp("vids")
    make_synthetic_video(d / "b.mp4", num_frames=5, height=64, width=64)
    return d


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{model type: (msgpack, .pth)} for TernausNet16 and ResUNet."""
    from mfcnet_tpu.models import get_tooltip_segmentation_model as jget
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    d = tmp_path_factory.mktemp("w")
    x0 = np.zeros((1, HW, HW, 3), np.float32)
    return {kind: write_weights(d, jget(kind, C, scale=SCALE), (x0,),
                                get_tooltip_segmentation_model(
                                    kind, C, scale=SCALE), seed)
            for kind, seed in (("TernausNet16", 8), ("ResUNet", 10))}


def _args(video, out, name, kind, weights_path, *extra):
    return ["--videos_dir", str(video), "--expt_savedir", str(out),
            "--expt_name", name, "--model_type", kind,
            "--load_wts_model", str(weights_path), "--input_height", str(HW),
            "--input_width", str(HW), "--model_scale", str(SCALE),
            "--compute_dtype", "float32", *extra]


def _rows(out, name, video="b"):
    return np.loadtxt(out / name / "video_tracking_results"
                      / f"{video}_tracked.csv", delimiter=",")


def _run_both(video, tmp_path, weights, kind, *extra):
    """(port rows, JAX rows) of one flag set."""
    from mfcnet_tpu.cli.test_toolpose_segmentation_on_videos import (
        main as jmain,
    )
    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        main,
    )

    msgpack, pth = weights[kind]
    jmain(_args(video, tmp_path, "jax", kind, msgpack, *extra))
    main(_args(video, tmp_path, "port", kind, pth, *extra, "--device", "cpu"))
    return _rows(tmp_path, "port"), _rows(tmp_path, "jax")


def tip_rmse(a, b):
    """RMSE in px over the tip columns both rows detect, after checking
    that both detect the same keypoints."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    tips = ~np.isnan(a[:, :8])
    if not tips.any():
        return 0.0
    return float(np.sqrt(np.mean((a[:, :8][tips] - b[:, :8][tips]) ** 2)))


def test_host_decode_rows_equal_jax(video, tmp_path, weights):
    got, want = _run_both(video, tmp_path, weights, "TernausNet16")
    assert got.shape == (5, 12)
    assert np.isfinite(got).any()
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port" / "video_tracking_results"
            / "b_tracked.mp4").exists()


def test_device_decode_within_the_gate_of_jax(video, tmp_path, weights):
    """The port's device decode (plain versions of the ``cc.cu`` kernels
    on the CPU) against the JAX CLI's device decode; the engine's
    probabilities against the JAX model's on the video's frames."""
    import cv2
    import jax
    from flax import serialization

    from mfcnet_tpu.models import get_tooltip_segmentation_model as jget
    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        SingleFrameEngine,
    )
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    got, want = _run_both(video, tmp_path, weights, "TernausNet16",
                          "--decode", "device")
    assert got.shape == (5, 12) and np.isfinite(got).any()
    assert tip_rmse(got, want) <= TIP_RMSE

    msgpack, pth = weights["TernausNet16"]
    cap = cv2.VideoCapture(str(video / "b.mp4"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB),
                                 (HW, HW)))
    cap.release()
    frames = np.stack(frames)
    pm = get_tooltip_segmentation_model("TernausNet16", C, scale=SCALE)
    pm.load_state_dict(torch.load(pth)["model"])
    eng = SingleFrameEngine.from_model(pm, TrackerConfig(
        num_input_frames=1, input_height=HW, input_width=HW,
        dtype="float32", decode="device"), "log_probs", device="cpu")
    with torch.no_grad():
        probs = torch.stack([eng.probs(f) for f in frames]).numpy()
    x = (frames.astype(np.float32) / 255.0
         - np.float32([0.485, 0.456, 0.406])) / np.float32(
             [0.229, 0.224, 0.225])
    v = serialization.msgpack_restore(msgpack.read_bytes())
    jprobs = np.exp(np.asarray(jax.jit(jget("TernausNet16", C,
                                            scale=SCALE).apply)(v, x),
                               np.float32))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=HEAT_TOL)
    mask, kps, heats = eng.step_async(frames[0])
    assert heats.dtype == torch.float32 and kps.shape == (2, 3, 3)


def test_score_threshold_with_a_logits_base_equals_jax(video, tmp_path,
                                                       weights):
    """ResUNet (logits, through a log-softmax) with
    ``--score_detection_threshold 0.3``: the class mask by the threshold
    loop, the host decode's rows equal."""
    got, want = _run_both(video, tmp_path, weights, "ResUNet",
                          "--score_detection_threshold", "0.3")
    assert got.shape == (5, 12) and np.isfinite(got).any()
    np.testing.assert_array_equal(got, want)


def test_use_ema_tracks_with_the_trainers_ema_weights(video, tmp_path):
    """A checkpoint of the port's single-frame trainer (one epoch on a
    pack, ``--ema_decay``): ``--use_ema True`` tracks with its ``ema``
    weights, the default with its ``model`` weights."""
    from mfcnet_tpu_torch.cli import test_toolpose_segmentation_on_videos as sf
    from mfcnet_tpu_torch.cli.train_toolpose_segmentation import (
        main as train,
    )
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.track.tracker import TrackerConfig
    from mfcnet_tpu_torch.utils.checkpoint import load_state_dict_file

    pack = make_synthetic_pack(tmp_path / "pack", videos=(("train", 1, 4),
                                                          ("val", 1, 1)),
                               height=HW, width=HW)
    train(["--dataset", "JIGSAWS", "--packed_dir", str(pack),
           "--expt_savedir", str(tmp_path), "--expt_name", "tr",
           "--batch_size", "2", "--num_workers", "1", "--num_epochs", "1",
           "--input_height", str(HW), "--input_width", str(HW),
           "--model_scale", str(SCALE), "--ema_decay", "0.5",
           "--lr", "0.01", "--device", "cpu"])
    ck = tmp_path / "tr" / "ckpts" / "model_001.pth"
    rows = {}
    for ema in ("false", "true"):
        sf.main(_args(video, tmp_path, f"e{ema}", "TernausNet16", ck,
                      "--use_ema", ema, "--device", "cpu"))
        rows[ema] = _rows(tmp_path, f"e{ema}")
        model = get_tooltip_segmentation_model("TernausNet16", C,
                                               scale=SCALE)
        model.load_state_dict(load_state_dict_file(ck, use_ema=ema == "true"))
        eng = sf.SingleFrameEngine.from_model(model, TrackerConfig(
            num_input_frames=1, input_height=HW, input_width=HW,
            dtype="float32"), "log_probs", device="cpu")
        want, _ = sf.track_singleframe_video(video / "b.mp4", eng,
                                             tmp_path / f"w{ema}")
        np.testing.assert_array_equal(rows[ema], want)
    ema_sd = load_state_dict_file(ck, use_ema=True)
    raw_sd = load_state_dict_file(ck)
    assert any(not torch.equal(ema_sd[k], raw_sd[k]) for k in raw_sd)


@pytest.mark.parametrize("extra,match", [
    (("--model_type", "TAPNet16"), "TAPNet video tracking"),
    (("--artifact", "junk.pt2"), "not an mfcnet_tpu_torch serving artifact"),
    (("--spatial_shards", "2"), "Queue 1 item 12"),
    (("--device", "cuda"), "--device cpu"),
])
def test_refusals(video, tmp_path, weights, extra, match):
    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        main,
    )

    if extra[0] == "--device" and torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    args = _args(video, tmp_path, "r", "TernausNet16",
                 weights["TernausNet16"][1])
    if extra[0] == "--model_type":
        args[args.index("--model_type") + 1] = extra[1]
        extra = ()
    if extra and extra[0] == "--artifact":  # a file that is no artifact
        junk = tmp_path / extra[1]
        junk.write_bytes(b"not a serving artifact")
        extra = ("--artifact", str(junk), "--device", "cpu")
    with pytest.raises(SystemExit, match=match):
        main(args + list(extra))


def test_singleframe_engine_defaults_to_the_card(weights):
    import inspect

    from mfcnet_tpu_torch.cli import test_toolpose_segmentation_on_videos as sf
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    assert sf.build_parser().parse_args(
        ["--videos_dir", "v", "--expt_savedir", "o",
         "--expt_name", "n"]).device == "cuda"
    params = inspect.signature(sf.SingleFrameEngine.from_model).parameters
    assert params["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    model = get_tooltip_segmentation_model("TernausNet16", C, scale=SCALE)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sf.SingleFrameEngine.from_model(model, TrackerConfig(), "log_probs")
    with pytest.raises(ValueError, match="TAPNet"):
        sf.SingleFrameEngine.from_model(model, TrackerConfig(), "tapnet", device="cpu")


def test_annotation_frames_equal_jax(tmp_path):
    """Two videos, the random pick and a stride: the same files, the same
    bytes."""
    from mfcnet_tpu.cli.get_frames_for_annotation_from_videos import (
        main as jmain,
    )
    from mfcnet_tpu_torch.cli.get_frames_for_annotation_from_videos import (
        main,
    )
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_video

    for i, n in enumerate((9, 12)):
        make_synthetic_video(tmp_path / "vids" / f"v{i}.mp4", num_frames=n,
                             height=48, width=64, seed=i)
    for seed in ("0", "3"):
        args = ["--videos_dir", str(tmp_path / "vids"), "--num_frames", "3",
                "--frame_stride", "4", "--seed", seed]
        n_port = main(args + ["--output_dir", str(tmp_path / f"p{seed}")])
        n_jax = jmain(args + ["--output_dir", str(tmp_path / f"j{seed}")])
        assert n_port == n_jax == 3
        got = sorted(p.relative_to(tmp_path / f"p{seed}")
                     for p in (tmp_path / f"p{seed}").rglob("*.jpg"))
        want = sorted(p.relative_to(tmp_path / f"j{seed}")
                      for p in (tmp_path / f"j{seed}").rglob("*.jpg"))
        assert got == want and len(got) == 3
        for rel in got:
            assert ((tmp_path / f"p{seed}" / rel).read_bytes()
                    == (tmp_path / f"j{seed}" / rel).read_bytes())


def test_synthetic_video_keypoints_follow_the_jax_walk():
    """The port's scene generator walks the JAX generator's path: the same
    ground-truth keypoints from the same seed (the pixels differ: numpy
    rasterization against OpenCV's)."""
    from mfcnet_tpu.data.synthetic import make_synthetic_frames as jframes
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_frames

    frames, gt = make_synthetic_frames(7, 64, 80, seed=4,
                                       return_keypoints=True)
    jf, jgt = jframes(7, 64, 80, seed=4, return_keypoints=True)
    np.testing.assert_array_equal(gt, jgt)
    assert frames.shape == jf.shape and frames.dtype == np.uint8
    # the noise is drawn in the same order too: the background is equal
    bg = (frames == jf).all(-1)
    assert bg.mean() > 0.8
