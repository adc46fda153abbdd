"""The port's tracker end to end on the CPU: the golden CSVs of the JAX
package from its seeded weights, incremental == full, the CLI on a tiny
video, and the import boundary (nothing of jax, flax or the JAX package
on any path, and no cv2 on the device-decode path)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

GOLDEN_DIR = Path(__file__).parent / "golden"
N_FRAMES, H, W, T, C = 8, 64, 32, 3, 5
STAGES = ((4,), (8,), (8, 8), (16, 16), (16, 16))


@pytest.fixture(scope="module")
def golden_model():
    """The golden test's model (tests/test_golden_csv.py::_track): JAX
    seeded init, converted with compat.from_jax."""
    import jax

    from mfcnet_tpu.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import MultiFrameSegmenter as PortSeg
    from mfcnet_tpu_torch.models import TernausNet16 as PortTN

    jm = MultiFrameSegmenter(
        base=TernausNet16(num_classes=C, num_filters=4, stage_convs=STAGES),
        num_classes=C, num_frames=T, variant="basic", base_output="exp",
    )
    v = jit_init(jm, jax.random.PRNGKey(42),
                 np.zeros((1, T, H, W, 3), np.float32))
    return load_jax_variables(PortSeg(PortTN(C, 4, STAGES), C, T).eval(), v)


@pytest.fixture(scope="module")
def golden_frames():
    from mfcnet_tpu.data.synthetic import make_synthetic_frames

    return make_synthetic_frames(num_frames=N_FRAMES, height=H, width=W,
                                 seed=13)


def _cfg(**kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    return TrackerConfig(num_input_frames=T, num_classes=C, input_height=H,
                         input_width=W, dtype="float32", **kw)


@pytest.mark.parametrize("mode,decode", [
    ("incremental", "host"),
    ("incremental", "device"),
    ("full", "host"),
    ("full", "device"),
])
def test_port_reproduces_golden_csv(tmp_path, golden_model, golden_frames,
                                    mode, decode):
    """Byte equality with the JAX package's committed golden CSVs."""
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    track_on_frames(golden_frames, golden_model,
                    _cfg(mode=mode, decode=decode), tmp_path, name="golden",
                    device="cpu")
    got = (tmp_path / "golden_tracked.csv").read_bytes()
    want = (GOLDEN_DIR / f"tracked_{mode}_{decode}.csv").read_bytes()
    assert got == want, f"{mode}/{decode} CSV differs from the golden file"


def test_incremental_equals_full_and_warmup(tmp_path, golden_model):
    from mfcnet_tpu.data.synthetic import make_synthetic_frames
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        track_on_frames,
    )

    frames = make_synthetic_frames(num_frames=12, height=H, width=W, seed=5)
    rows = {
        mode: track_on_frames(frames, golden_model,
                              _cfg(mode=mode, decode="device",
                                   overlay=False, fetch_batch=3),
                              tmp_path / mode, device="cpu")[0]
        for mode in ("incremental", "full")
    }
    np.testing.assert_array_equal(rows["incremental"], rows["full"])
    assert rows["full"].shape == (12, 12)
    assert np.isnan(rows["full"][:T - 1]).all()

    eng = InferenceEngine(golden_model, _cfg(decode="device", overlay=False),
                          device="cpu")
    outs = [eng.step(f) for f in frames[:T]]
    assert outs[0] is None and outs[1] is None
    mask, kps, heats = outs[2]
    assert mask.shape == (H, W) and mask.dtype == np.uint8
    assert kps.shape == (2, 3, 3) and heats.shape == (H, W, 2)


def test_tracker_rejects_unported_options(golden_model):
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    for kw in ({"spatial_shards": 2}, {"fused_dispatch": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngine(golden_model, _cfg(**kw), device="cpu")
    # the flow path is ported: it asks for its provider
    with pytest.raises(ValueError, match="flow_model"):
        InferenceEngine(golden_model, _cfg(add_optflow_inputs=True),
                        device="cpu")


def test_entry_points_default_to_the_card(tmp_path, golden_model,
                                          golden_frames):
    """The engine and the track_on_* entry points run on the card unless
    the caller passes device="cpu": with no card the default raises and
    names the way to the CPU, and nothing runs on the CPU unasked."""
    import inspect

    from mfcnet_tpu_torch.track import tracker

    for fn in (tracker.InferenceEngine.__init__, tracker.track_on_frames,
               tracker.track_on_video):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        eng = tracker.InferenceEngine(golden_model, _cfg())
        assert eng.device.type == "cuda"
        assert next(eng.model.parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tracker.InferenceEngine(golden_model, _cfg())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tracker.track_on_frames(golden_frames, golden_model, _cfg(),
                                tmp_path)


def test_cli_tracks_a_tiny_video(tmp_path):
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
        main,
    )
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    make_synthetic_video(tmp_path / "vids" / "a.mp4", num_frames=6,
                         height=64, width=64)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=0.1,
        generator=torch.Generator().manual_seed(0))
    ck = tmp_path / "model.pth"
    torch.save({"model": model.state_dict(), "epoch": 1}, ck)
    args = [
        "--videos_dir", str(tmp_path / "vids"),
        "--expt_savedir", str(tmp_path), "--expt_name", "vt",
        "--model_type", "TernausNetMulti-Basic",
        "--load_wts_model", str(ck), "--input_height", "32",
        "--input_width", "32", "--model_scale", "0.1",
        "--compute_dtype", "float32", "--decode", "device",
    ]
    if not torch.cuda.is_available():
        # the CLI runs on the card unless asked: no silent CPU fallback
        with pytest.raises(SystemExit, match="--device cpu"):
            main(args)
    args += ["--device", "cpu"]
    fps = main(args)
    assert len(fps) == 1
    out = tmp_path / "vt" / "video_tracking_results"
    rows = np.loadtxt(out / "a_tracked.csv", delimiter=",")
    assert rows.shape == (6, 12)
    assert (out / "a_tracked.mp4").exists()
    with pytest.raises(SystemExit, match="Queue 1 item 12"):
        main(args + ["--spatial_shards", "2"])
    with pytest.raises(SystemExit, match="depth_videos_dir"):
        main(args + ["--add_depth_inputs", "true"])
    msgpack = list(args)
    msgpack[msgpack.index("--load_wts_model") + 1] = str(tmp_path / "w.msgpack")
    with pytest.raises(SystemExit, match="from_jax"):
        main(msgpack)


_FORBIDDEN = ("mfcnet_tpu", "jax", "jaxlib", "flax")

_IMPORT_CHECK = """
    import importlib, pkgutil, sys, tempfile, types
    import numpy as np, torch
    import mfcnet_tpu_torch
    for m in pkgutil.walk_packages(mfcnet_tpu_torch.__path__,
                                   "mfcnet_tpu_torch."):
        importlib.import_module(m.name)
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import (TrackerConfig,
                                                track_on_frames)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", 5, 3, scale=0.0625,
        generator=torch.Generator().manual_seed(0))
    S = 128 if PROVIDER == "UnFlow" else 32
    frames = np.random.default_rng(0).integers(
        0, 255, (5, S, S, 3), dtype=np.uint8)
    cfg = TrackerConfig(input_height=S, input_width=S, dtype="float32",
                        **CFG)
    flow_model = None
    if cfg.add_optflow_inputs and PROVIDER == "UnFlow":
        from mfcnet_tpu_torch.cli.generate_opticalflow import (
            build_parser, build_provider, flow_pairs)
        from mfcnet_tpu_torch.models.unflow import UnFlow
        flow_model = UnFlow()
        build_parser()
        flows = flow_pairs(build_provider("UnFlow", 64, 64, device="cpu"),
                           frames[:2, :64, :64], frames[1:3, :64, :64])
        assert flows.shape == (2, 64, 64, 2)
    elif cfg.add_optflow_inputs:
        flow_model = RAFT(iters=1, input_hw=(16, 16))
    with tempfile.TemporaryDirectory() as d:
        rows, _ = track_on_frames(frames, model, cfg, d,
                                  flow_model=flow_model, device="cpu")
    assert rows.shape == (5, 12)
    # the single-frame tracker on in-memory frames and the evaluators'
    # device half (the eval step, log-probabilities and IoU/Dice fetched)
    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        SingleFrameEngine, track_singleframe_frames)
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.track.infer_eval import device_half
    from mfcnet_tpu_torch.train.steps import make_singleframe_eval_step
    sf = get_tooltip_segmentation_model("TernausNet16", 5, scale=0.0625)
    sf_cfg = TrackerConfig(num_input_frames=1, input_height=S,
                           input_width=S, dtype="float32",
                           **{k: v for k, v in CFG.items()
                              if k != "add_optflow_inputs"})
    with tempfile.TemporaryDirectory() as d:
        rows, _ = track_singleframe_frames(
            frames, SingleFrameEngine.from_model(sf, sf_cfg, "log_probs", device="cpu"),
            d)
    assert rows.shape == (5, 12)
    lp, iou, dice = device_half(
        types.SimpleNamespace(model=sf),
        make_singleframe_eval_step(["nll"], [1.0], ["iou", "dice"], 5),
        {"image": torch.zeros(1, S, S, 3),
         "mask": torch.zeros(1, S, S, dtype=torch.int64)})
    assert lp.shape == (S, S, 5) and iou.shape == dice.shape == (4,)
    if TRAIN:
        from mfcnet_tpu_torch.cli.train_multiframe_detection import main
        from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
        with tempfile.TemporaryDirectory() as d:
            make_synthetic_pack(d + "/pack", videos=(("train", 1, 2),
                                                     ("val", 1, 1)),
                                height=32, width=32)
            state = main(["--dataset", "JIGSAWS", "--packed_dir",
                          d + "/pack", "--expt_savedir", d,
                          "--batch_size", "1", "--num_workers", "1",
                          "--num_epochs", "0", "--input_height", "32",
                          "--input_width", "32", "--model_scale", "0.0625",
                          "--add_optflow_inputs", "true",
                          "--add_depth_inputs", "true",
                          "--train_base_model", "true", "--device", "cpu"])
        assert state.step == 2
    bad = [m for m in sys.modules
           if m.split(".")[0] in FORBIDDEN]
    print("LOADED", bad)
    sys.exit(1 if bad else 0)
"""


def _run_import_check(cfg_kwargs, forbidden, provider="RAFT", train=False):
    code = (f"CFG = {cfg_kwargs!r}\nFORBIDDEN = {forbidden!r}\n"
            f"PROVIDER = {provider!r}\nTRAIN = {train!r}\n"
            + textwrap.dedent(_IMPORT_CHECK))
    # two intra-op threads: the suite runs several workers at once
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_no_jax_flax_or_cv2():
    """A fresh interpreter: importing every module of the port (the
    training modules, the evaluation layer and the infer and single-frame
    video CLIs included), tracking with decode='device', no overlay and
    the flow provider, the single-frame tracker on in-memory frames, the
    evaluators' device half, and two training steps of the training CLI
    on a pack of the port's synthetic generator (RAFT in the step, depth,
    the base trained) load nothing of jax, jaxlib, flax or the JAX
    package, and no cv2."""
    _run_import_check(
        dict(decode="device", overlay=False, add_optflow_inputs=True),
        _FORBIDDEN + ("cv2",), train=True)


def test_unflow_run_and_flow_cli_import_no_jax_flax_or_cv2():
    """The same for a tracker run with UnFlow as provider and for the
    offline flow CLI's provider and batched forward."""
    _run_import_check(
        dict(decode="device", overlay=False, add_optflow_inputs=True),
        _FORBIDDEN + ("cv2",), provider="UnFlow")


def test_host_decode_and_overlay_import_nothing_of_the_jax_package():
    """The host decode (whose scipy twin the tie fallback runs) and the
    overlay use the port's own OpenCV helpers: no key of sys.modules is or starts
    with mfcnet_tpu., jax, jaxlib or flax after a host-decode run with
    the overlay on."""
    _run_import_check(dict(decode="host", overlay=True), _FORBIDDEN)


_TIE_CHECK = """
    import json, sys
    import numpy as np
    from mfcnet_tpu_torch.track.tracker import KeypointTracker, TrackerConfig
    data = np.load(INPUTS)
    tracker = KeypointTracker(len(data["preds"]), TrackerConfig())
    for pred, heat in zip(data["preds"], data["heats"]):
        kps = np.zeros((2, 3, 3))
        kps[:, 2] = (1.0, 1.0, 2.0)  # both bases flagged as tied
        tracker.update_device(kps, mask_provider=lambda p=pred: p,
                              heat_provider=lambda h=heat: h)
    assert "cv2" not in sys.modules, "the tie re-decode loaded cv2"
    print(json.dumps(np.nan_to_num(tracker.rows, nan=-1.0).tolist()))
"""


def test_tie_fallback_needs_no_cv2_and_equals_host_decode(tmp_path):
    """With the default tie fallback, a side that the device decode flags
    as tied is re-decoded exactly in a fresh interpreter that loads no
    cv2 (a machine may have none), and its rows equal the OpenCV host decode
    of the same class maps and f16 heats."""
    import json

    from mfcnet_tpu_torch.track.tracker import KeypointTracker, TrackerConfig

    rng = np.random.default_rng(5)
    preds, heats = [], []
    for _ in range(4):
        pred = np.zeros((48, 64), np.int64)
        for cls in (1, 2, 3, 4):
            for _ in range(rng.integers(1, 3)):
                y, x = rng.integers(2, 36), rng.integers(2, 52)
                pred[y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] = cls
        preds.append(pred)
        heats.append(rng.random((48, 64, 2)).astype(np.float16))
    np.savez(tmp_path / "inputs.npz", preds=preds, heats=heats)
    code = (f"INPUTS = {str(tmp_path / 'inputs.npz')!r}\n"
            + textwrap.dedent(_TIE_CHECK))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]))
    host = KeypointTracker(len(preds), TrackerConfig())
    for pred, heat in zip(preds, heats):
        host.update(pred, heat[..., 1].astype(np.float32),
                    heat[..., 0].astype(np.float32))
    want = np.nan_to_num(host.rows, nan=-1.0)
    assert (want[:, 8:] >= 0).all(), "every frame should find both bases"
    np.testing.assert_array_equal(rows, want)
