"""Tracking from serving artifacts on the CPU (``serve.ArtifactEngine``,
``cli/export_model.py`` and the tracking CLIs' ``--artifact``).

Held: the JAX package's golden CSVs byte for byte from an incremental and a
full artifact of the golden model (the live engine's are in
``tests/test_torch_tracker.py``); rows equal to the live engine's for two
streams at once, with depth, and with a bfloat16 RAFT provider in the graph
(whose graph names ``mfcnet.raft_update`` and ``mfcnet.flow_warp``); a
fresh process that loads an artifact and tracks with it without importing
the models, JAX, flax or cv2; the engine's refusals; and the CLIs: ``export_model``
with ``--validate``, the multi-frame CLI's ``--artifact`` CSV equal to its
checkpoint run (also with ``--parallel_videos 2``), the single-frame CLI's
likewise, and their refusals."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tracker import golden_frames, golden_model  # noqa: F401
from torch_threads import _two_torch_threads  # noqa: F401

GOLDEN_DIR = Path(__file__).parent / "golden"
H, W, T, C = 64, 32, 3, 5
#: the RAFT artifact's frames: RAFT at half resolution, 32x32 (its
#: ``input_hw``: a 4x4 grid, three pyramid levels)
RS = 64
SCALE = 0.1


def _cfg(hw=(H, W), **kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    kw = {"num_input_frames": T, "num_classes": C, "input_height": hw[0],
          "input_width": hw[1], "dtype": "float32", **kw}
    return TrackerConfig(**kw)


def _meta(mode, hw=(H, W), dtype="float32", depth=False, flow=False,
          spec=None):
    meta = {"serving_mode": mode, "num_classes": C, "num_input_frames": T,
            "input_height": hw[0], "input_width": hw[1],
            "compute_dtype": dtype, "add_depth_inputs": depth,
            "add_optflow_inputs": flow}
    if spec is not None:
        meta["state"] = {k: [list(s), d] for k, (s, d) in spec.items()}
    return meta


def _artifacts(model, out_dir, hw=(H, W), depth=False):
    """{mode: path} of a float32 incremental and full artifact of
    ``model`` (symbolic batch)."""
    from mfcnet_tpu_torch.serve import (
        export_incremental,
        export_serving,
        save_exported,
    )

    kw = dict(height=hw[0], width=hw[1], num_frames=T, dtype="float32",
              add_depth_inputs=depth, device="cpu")
    ep, spec = export_incremental(model, num_classes=C, **kw)
    paths = {"incremental": out_dir / "inc.pt2", "full": out_dir / "full.pt2"}
    save_exported(paths["incremental"], ep,
                  _meta("incremental", hw, depth=depth, spec=spec))
    save_exported(paths["full"], export_serving(model, **kw),
                  _meta("full", hw, depth=depth))
    return paths


@pytest.fixture(scope="module")
def golden_artifacts(golden_model, tmp_path_factory):  # noqa: F811
    return _artifacts(golden_model, tmp_path_factory.mktemp("golden"))


@pytest.mark.parametrize("mode,decode", [
    ("incremental", "host"),
    ("incremental", "device"),
    ("full", "host"),
    ("full", "device"),
])
def test_artifact_engine_reproduces_golden_csv(tmp_path, golden_artifacts,
                                               golden_frames,  # noqa: F811
                                               mode, decode):
    from mfcnet_tpu_torch.serve import ArtifactEngine
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    cfg = _cfg(mode=mode, decode=decode)
    track_on_frames(golden_frames, None, cfg, tmp_path, name="golden",
                    engine=ArtifactEngine(golden_artifacts[mode], cfg))
    got = (tmp_path / "golden_tracked.csv").read_bytes()
    want = (GOLDEN_DIR / f"tracked_{mode}_{decode}.csv").read_bytes()
    assert got == want, f"{mode}/{decode} CSV differs from the golden file"


def _rows_both(engine_a, engine_b, cfg, tmp_path, streams, depth=None):
    """Rows of two engines on the same streams (one engine each)."""
    from mfcnet_tpu_torch.track.tracker import track_on_frame_streams

    return [track_on_frame_streams(streams, None, cfg, tmp_path / name,
                                   depth_streams=depth, engine=e)[0]
            for name, e in (("a", engine_a), ("b", engine_b))]


@pytest.mark.parametrize("mode,decode", [("incremental", "host"),
                                         ("full", "device")])
def test_artifact_streams_equal_live_engine(tmp_path, golden_model,  # noqa: F811
                                            golden_artifacts, mode, decode):
    """Two streams of unequal length in lockstep through one artifact."""
    from mfcnet_tpu_torch.serve import ArtifactEngine
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    rng = np.random.default_rng(1)
    streams = [rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
               for n in (6, 4)]
    cfg = _cfg(mode=mode, decode=decode, overlay=False)
    art, live = _rows_both(
        ArtifactEngine(golden_artifacts[mode], cfg, num_streams=2),
        InferenceEngine(golden_model, cfg, device="cpu", num_streams=2),
        cfg, tmp_path, streams)
    for a, b in zip(art, live):
        np.testing.assert_array_equal(a, b)
    assert art[0].shape == (6, 12) and art[1].shape == (4, 12)


@pytest.fixture(scope="module")
def depth_model(tmp_path_factory):
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_depth_inputs=True, scale=SCALE,
        generator=torch.Generator().manual_seed(3))
    return model, _artifacts(model, tmp_path_factory.mktemp("depth"),
                             hw=(32, 32), depth=True)


@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_artifact_depth_rows_equal_live_engine(tmp_path, depth_model, mode):
    from mfcnet_tpu_torch.serve import ArtifactEngine
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    model, paths = depth_model
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)]
    depth = [rng.integers(0, 256, (5, 32, 32), dtype=np.uint8)]
    cfg = _cfg((32, 32), mode=mode, decode="device", overlay=False,
               add_depth_inputs=True)
    art, live = _rows_both(ArtifactEngine(paths[mode], cfg),
                           InferenceEngine(model, cfg, device="cpu"), cfg,
                           tmp_path, frames, depth)
    np.testing.assert_array_equal(art[0], live[0])


@pytest.fixture(scope="module")
def raft_artifact(tmp_path_factory):
    """A bfloat16 full-window artifact with RAFT x2 and depth at 64x64,
    exported on the CPU for one stream (the symbolic batch is held on the
    golden model's artifacts): (path, model, provider, ExportedProgram)."""
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.serve import export_serving, save_exported

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=0.0625,
        generator=torch.Generator().manual_seed(1))
    raft = init_weights(RAFT(iters=2, input_hw=(RS // 2, RS // 2)),
                        torch.Generator().manual_seed(2))
    ep = export_serving(model, height=RS, width=RS, num_frames=T,
                        dtype="bfloat16", add_depth_inputs=True,
                        flow_model=raft, batch=1, device="cpu")
    path = tmp_path_factory.mktemp("raft") / "raft.pt2"
    save_exported(path, ep, _meta("full", (RS, RS), "bfloat16", depth=True,
                                  flow=True))
    return path, model, raft, ep


@pytest.fixture(scope="module")
def raft_runs(raft_artifact, tmp_path_factory):
    """One window of the bfloat16 flow path through the artifact's
    ``ArtifactEngine`` and through the live engine's full mode on the same
    weights (both run the fused update step on the operators' CPU route):
    (rows of each, float32 probabilities of each, the artifact run's
    [net | inp] fills and kernel launches)."""
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.serve import ArtifactEngine
    from mfcnet_tpu_torch.track.outputs import probs_nhwc
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        track_on_frames,
    )

    path, model, raft, _ = raft_artifact
    cfg = _cfg((RS, RS), mode="full", dtype="bfloat16", decode="device",
               overlay=False, add_depth_inputs=True, add_optflow_inputs=True)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (T, RS, RS, 3), dtype=np.uint8)
    depth = rng.integers(0, 256, (T, RS, RS), dtype=np.uint8)
    art = ArtifactEngine(path, cfg)
    live = InferenceEngine(model, cfg, flow_model=raft, device="cpu")
    probs = {}
    call = art._loaded

    def kept(*args):
        probs["art"] = call(*args)
        return probs["art"]

    def live_outputs(logits):
        probs["live"] = probs_nhwc(logits)
        return InferenceEngine._outputs(live, logits)

    art._loaded, live._outputs = kept, live_outputs
    out = tmp_path_factory.mktemp("raft_rows")
    ru.reset_launches()
    rows_art = track_on_frames(frames, None, cfg, out, name="a",
                               depth_frames=depth, engine=art)[0]
    counts = (ru.COUNTS["hx_fills"], ru.LAUNCHES["raft_update"])
    rows_live = track_on_frames(frames, None, cfg, out, name="l",
                                depth_frames=depth, engine=live)[0]
    return (rows_art, rows_live), (probs["art"], probs["live"]), counts


def test_raft_artifact_names_the_kernels(raft_artifact, raft_runs):
    """The update step and the warp are graph nodes of their registered
    operators (the CUDA kernels on the card): two update steps a solve,
    [net | inp] written by the first only, and the loaded program's
    probabilities equal the live serving module's (the live engine's full
    mode, whose solve goes through the same operators)."""
    ep = raft_artifact[3]
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mfcnet.raft_update.default") == 2
    assert targets.count("mfcnet.flow_warp.default") == 1
    _, (got, want), (fills, launches) = raft_runs
    assert fills == 1 and launches == 0
    assert got.shape == (1, RS, RS, C) and torch.equal(got, want)


def test_raft_artifact_rows_equal_live_engine(raft_runs):
    """The bfloat16 flow path's rows through the artifact equal the live
    engine's full mode on the same weights."""
    (art, live), _, _ = raft_runs
    assert art.shape == (T, 12)
    np.testing.assert_array_equal(art, live)


_FRESH = """
    import sys, tempfile
    import numpy as np
    from mfcnet_tpu_torch.serve import ArtifactEngine, load_exported
    from mfcnet_tpu_torch.track.tracker import TrackerConfig, track_on_frames
    loaded = load_exported(PATH)
    cfg = TrackerConfig(num_input_frames=3, num_classes=5,
                        input_height=64, input_width=32, dtype="float32",
                        mode="incremental", decode="device", overlay=False)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 64, 32, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        rows, _ = track_on_frames(frames, None, cfg, d,
                                  engine=ArtifactEngine(loaded, cfg))
    assert rows.shape == (4, 12)
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("mfcnet_tpu", "jax", "jaxlib", "flax", "cv2")
           or m.startswith("mfcnet_tpu_torch.models")]
    print("LOADED", bad)
    sys.exit(1 if bad else 0)
"""


def test_fresh_process_tracks_without_model_code(golden_artifacts):
    """A new interpreter loads the golden model's incremental artifact (the
    loader registers the two operators a graph may name) and tracks with
    it through the device decode, importing nothing of the models, JAX,
    flax or cv2."""
    code = (f"PATH = {str(golden_artifacts['incremental'])!r}\n"
            + textwrap.dedent(_FRESH))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_artifact_engine_refusals(golden_artifacts):
    from mfcnet_tpu_torch.serve import ArtifactEngine, load_exported
    from mfcnet_tpu_torch.serve.export import LoadedServing

    with pytest.raises(ValueError, match="num_classes"):
        ArtifactEngine(golden_artifacts["full"], _cfg(num_classes=4))
    # the header says flow and the config does not, and the reverse
    loaded = load_exported(golden_artifacts["full"])
    with pytest.raises(ValueError, match="add_optflow_inputs"):
        ArtifactEngine(loaded, _cfg(add_optflow_inputs=True))
    flow = LoadedServing({**loaded.meta, "add_optflow_inputs": True},
                         loaded.exported)
    with pytest.raises(ValueError, match="add_optflow_inputs"):
        ArtifactEngine(flow, _cfg())
    # flow in an incremental artifact
    inc = load_exported(golden_artifacts["incremental"])
    inc_flow = LoadedServing({**inc.meta, "add_optflow_inputs": True},
                             inc.exported)
    with pytest.raises(ValueError, match="'full'-forward only"):
        ArtifactEngine(inc_flow, _cfg(add_optflow_inputs=True))
    single = LoadedServing({**loaded.meta, "task": "singleframe"},
                           loaded.exported)
    with pytest.raises(ValueError, match="singleframe artifact"):
        ArtifactEngine(single, _cfg())


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_video

    d = tmp_path_factory.mktemp("vids")
    for name, n in (("a", 6), ("b", 5)):
        make_synthetic_video(d / f"{name}.mp4", num_frames=n, height=64,
                             width=64)
    return d


def _csv(out, name, video):
    return np.loadtxt(out / name / "video_tracking_results"
                      / f"{video}_tracked.csv", delimiter=",")


def _checkpoint(tmp_path, model):
    ck = tmp_path / "model.pth"
    torch.save({"model": model.state_dict(), "epoch": 7}, ck)
    return ck


def test_video_cli_artifact_matches_checkpoint_run(tmp_path, videos):
    """Checkpoint -> export CLI (validated) -> the multi-frame CLI's
    ``--artifact``: the CSVs equal the checkpoint run's, one video at a
    time and two at once."""
    from mfcnet_tpu_torch.cli.export_model import main as export_main
    from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
        main,
    )
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.serve import load_exported

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=SCALE,
        generator=torch.Generator().manual_seed(5))
    ck = _checkpoint(tmp_path, model)
    art = tmp_path / "m.pt2"
    shape = ["--input_height", "32", "--input_width", "32"]
    export_main(["--model_type", "TernausNetMulti-Basic",
                 "--model_scale", str(SCALE), "--compute_dtype", "float32",
                 "--serving_mode", "incremental", "--load_wts_model",
                 str(ck), "--output", str(art), "--device", "cpu", *shape])
    meta = load_exported(art).meta
    assert meta["epoch"] == 7 and meta["serving_mode"] == "incremental"
    assert meta["state"] == {"seg_buf": [[None, T * C, 32, 32], "float32"]}
    common = ["--videos_dir", str(videos), "--expt_savedir", str(tmp_path),
              "--decode", "device", "--device", "cpu", *shape]
    main(common + ["--expt_name", "ck", "--model_type",
                   "TernausNetMulti-Basic", "--load_wts_model", str(ck),
                   "--model_scale", str(SCALE), "--compute_dtype",
                   "float32"])
    main(common + ["--expt_name", "art", "--artifact", str(art)])
    main(common + ["--expt_name", "par", "--artifact", str(art),
                   "--parallel_videos", "2"])
    for video, n in (("a", 6), ("b", 5)):
        want = _csv(tmp_path, "ck", video)
        assert want.shape == (n, 12)
        np.testing.assert_array_equal(_csv(tmp_path, "art", video), want)
        np.testing.assert_array_equal(_csv(tmp_path, "par", video), want)


@pytest.mark.parametrize("kind,decode", [("TernausNet16", "device"),
                                         ("UNet", "host")])
def test_singleframe_cli_artifact_matches_checkpoint_run(tmp_path, videos,
                                                         kind, decode):
    """Both output modes (TernausNet16 log-probabilities, UNet logits)
    through a validated single-frame artifact: the CSV equals the
    checkpoint run's."""
    from mfcnet_tpu_torch.cli.export_model import main as export_main
    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        main,
    )
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    model = get_tooltip_segmentation_model(
        kind, C, scale=SCALE, generator=torch.Generator().manual_seed(6))
    ck = _checkpoint(tmp_path, model)
    art = tmp_path / "sf.pt2"
    shape = ["--input_height", "32", "--input_width", "32"]
    export_main(["--task", "singleframe", "--model_type", kind,
                 "--model_scale", str(SCALE), "--compute_dtype", "float32",
                 "--load_wts_model", str(ck), "--output", str(art),
                 "--device", "cpu", *shape])
    common = ["--videos_dir", str(videos), "--expt_savedir", str(tmp_path),
              "--decode", decode, "--device", "cpu", "--num_videos", "1",
              *shape]
    main(common + ["--expt_name", "ck", "--model_type", kind,
                   "--load_wts_model", str(ck), "--model_scale", str(SCALE),
                   "--compute_dtype", "float32"])
    main(common + ["--expt_name", "art", "--artifact", str(art)])
    np.testing.assert_array_equal(_csv(tmp_path, "art", "a"),
                                  _csv(tmp_path, "ck", "a"))


def test_cli_refusals(tmp_path, videos, golden_artifacts):
    from mfcnet_tpu_torch.cli import export_model
    from mfcnet_tpu_torch.cli import test_multiframe_segmentation_on_videos
    from mfcnet_tpu_torch.cli import (
        test_toolpose_segmentation_on_videos as sf,
    )

    mf = test_multiframe_segmentation_on_videos
    common = ["--videos_dir", str(videos), "--expt_savedir", str(tmp_path),
              "--expt_name", "r", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--artifact, or --model_type"):
        mf.main(common)
    with pytest.raises(SystemExit, match="--artifact, or --model_type"):
        sf.main(common)
    # each CLI serves its own kind of artifact
    with pytest.raises(SystemExit, match="single-frame video CLI"):
        sf.main(common + ["--artifact", str(golden_artifacts["full"])])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            mf.main(common[:-2] + ["--artifact",
                                   str(golden_artifacts["full"])])
    ck = tmp_path / "w.pth"
    ck.write_bytes(b"")
    base = ["--load_wts_model", str(ck), "--output", str(tmp_path / "x"),
            "--device", "cpu"]
    for extra, match in (
        (("--task", "singleframe", "--model_type", "TAPNet16"), "TAPNet"),
        (("--task", "singleframe", "--model_type", "TernausNet16",
          "--add_depth_inputs", "true"), "no depth/flow"),
        (("--task", "singleframe", "--model_type", "TernausNet16",
          "--serving_mode", "incremental"), "stateless"),
        (("--serving_mode", "incremental", "--add_optflow_inputs", "true"),
         "in-graph flow"),
    ):
        with pytest.raises(SystemExit, match=match):
            export_model.main(base + list(extra))


@pytest.mark.cuda
def test_cuda_raft_artifact_launches_the_kernels(tmp_path):
    """On the card (``python -m pytest tests/test_torch_artifact_tracking.py
    -m cuda --noconftest``): a bf16 RAFT x2 + depth artifact exported there
    launches 2 ``raft_update`` (one hx fill) and 1 ``flow_warp`` a fused
    frame, and its rows and probabilities equal the live engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.serve import (
        ArtifactEngine,
        export_serving,
        save_exported,
    )
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=0.0625,
        generator=torch.Generator().manual_seed(1))
    raft = init_weights(RAFT(iters=2, input_hw=(RS // 2, RS // 2)),
                        torch.Generator().manual_seed(2))
    path = tmp_path / "raft.pt2"
    save_exported(path, export_serving(
        model, height=RS, width=RS, num_frames=T, dtype="bfloat16",
        add_depth_inputs=True, flow_model=raft), _meta(
            "full", (RS, RS), "bfloat16", depth=True, flow=True))
    cfg = _cfg((RS, RS), mode="full", dtype="bfloat16", decode="device",
               overlay=False, decode_tie_fallback=False,
               add_depth_inputs=True, add_optflow_inputs=True)
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (5, RS, RS, 3), dtype=np.uint8)]
    depth = [rng.integers(0, 256, (5, RS, RS), dtype=np.uint8)]
    ru.reset_launches()
    warp.reset_launches()
    art, live = _rows_both(ArtifactEngine(path, cfg),
                           InferenceEngine(model, cfg, flow_model=raft),
                           cfg, tmp_path, frames, depth)
    fused = 2 * (5 - (T - 1))  # both engines' fused frames
    assert ru.LAUNCHES["raft_update"] == 2 * fused
    assert ru.COUNTS["hx_fills"] == fused
    assert warp.LAUNCHES["flow_warp"] == fused
    np.testing.assert_array_equal(art[0], live[0])
