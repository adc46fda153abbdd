"""Single-frame per-video tracking CLI (counterpart of
``mfcnet_tpu/cli/test_toolpose_segmentation_on_videos.py``; reference
scripts/test_toolpose_segmentation_on_videos_v2.py): the multi-frame
CLI's decode and tracking with a per-frame segmentation model (no
temporal window). Writes ``{video}_tracked.csv`` (N x 12 keypoints) and
the overlay MP4 under ``{expt_savedir}/{expt_name}/video_tracking_results``.

    python -m mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos \\
        --videos_dir VIDEOS --expt_savedir OUT --expt_name NAME \\
        --model_type TernausNet16 --load_wts_model model.pth

The per-frame step follows the JAX CLI's: the uint8 frame scaled by 1/255
and normalized in the compute dtype (bfloat16 by default), the model, a
``log_softmax`` for the bases that give logits (``models.OUTPUT_MODES``),
``exp`` in float32, the class mask by argmax (or by the
``--score_detection_threshold`` loop, a later class overwriting) and the
tip heats (classes 2 and 4) in float32. ``--decode device`` decodes the
keypoints on the card (``track/decode_device.py``, the ``cc.cu``
kernels); ``--decode host`` runs the exact OpenCV decode. The tracking
loop is the multi-frame tracker's (``track/tracker.py``), fed by
:class:`SingleFrameEngine` as a one-stream engine.

``--load_wts_model`` takes a reference ``.pth`` (or a checkpoint of the
port's single-frame trainer; ``--use_ema True`` loads its EMA weights).
TAPNet is refused, as in the JAX CLI and the reference: its attention
maps come from the offline dataset pipeline. ``--artifact`` tracks from a
single-frame serving artifact of ``cli/export_model.py`` in place of
``--model_type`` and ``--load_wts_model`` (``SingleFrameEngine.from_artifact``;
a multi-frame artifact is refused). ``--spatial_shards`` raises, naming
ROADMAP item 12, which leaves it out. The tracker runs on the card; ``--device cpu`` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
    DEVICE_DECODE_WARNING,
    check_device,
    list_video_files,
    load_artifact,
    load_reference_state_dict,
    refuse_left_out_flags,
)
from mfcnet_tpu_torch.models import (
    OUTPUT_MODES,
    get_tooltip_segmentation_model,
)
from mfcnet_tpu_torch.serve.export import make_singleframe_serving_fn
from mfcnet_tpu_torch.track.outputs import outputs_from_probs
from mfcnet_tpu_torch.track.tracker import (
    TrackerConfig,
    track_on_frames,
    track_on_video,
)


def _bool(v):
    return v.lower() in ("true", "1", "yes")


def build_parser():
    p = argparse.ArgumentParser(
        description="Test Single-frame Segmentation Model on Videos "
                    "(PyTorch)")
    p.add_argument("--videos_dir", type=str, required=True)
    p.add_argument("--expt_savedir", type=str, required=True)
    p.add_argument("--expt_name", type=str, required=True)
    p.add_argument("--model_type", type=str, default=None,
                   choices=list(OUTPUT_MODES))
    p.add_argument("--load_wts_model", type=str, default=None,
                   help="reference .pth checkpoint")
    p.add_argument("--artifact", type=str, default=None,
                   help="a single-frame serving artifact of "
                        "cli/export_model.py, in place of --model_type and "
                        "--load_wts_model")
    p.add_argument("--use_ema", type=_bool, default=False,
                   help="track with the checkpoint's EMA weights")
    p.add_argument("--num_videos", type=int, default=-1)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--score_detection_threshold", type=float, default=0)
    p.add_argument("--area_threshold", type=int, default=10)
    p.add_argument("--dist_threshold", type=int, default=40)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--model_scale", type=float, default=1.0)
    p.add_argument("--decode", type=str, default="host",
                   choices=["host", "device"],
                   help="host = exact OpenCV-parity decode; device = "
                        "decode on the GPU (CUDA kernels)")
    p.add_argument("--spatial_shards", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


class SingleFrameEngine:
    """A single-frame probabilities function as a one-stream engine of
    ``track/tracker.py``'s tracking loop: ``step_async`` takes one
    (H, W, 3) uint8 frame and returns its device tensors ``(mask, heats)``
    (host decode) or ``(mask, kps, heats)`` (device decode), with float32
    heats; there is no warm-up. ``serving`` maps (1, H, W, 3) uint8 frames
    on ``device`` to (1, H, W, C) float32 probabilities: a model's serving
    module (:meth:`from_model`) or a loaded single-frame artifact
    (:meth:`from_artifact`)."""

    num_streams = 1

    def __init__(self, serving, cfg: TrackerConfig, device):
        cfg.check_ported()
        self.cfg = cfg
        self.serving = serving
        self.device = torch.device(device)

    @classmethod
    def from_model(cls, model, cfg: TrackerConfig, output_mode: str,
                   device="cuda"):
        """The model's serving module
        (``serve/export.py::make_singleframe_serving_fn``): a copy cast to
        ``cfg.dtype`` on ``device``, the card unless the caller passes
        ``"cpu"``; without a card the default raises. The frame is
        normalized in that dtype, then the model, a log-softmax in that
        dtype for a logits base, exp in float32."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SingleFrameEngine(device={str(device)!r}): no CUDA device "
                'is available; pass device="cpu" to run on the CPU')
        if output_mode not in ("log_probs", "logits"):
            raise ValueError(f"SingleFrameEngine: output mode "
                             f"{output_mode!r} (TAPNet takes an attention "
                             "map a video stream does not have)")
        return cls(make_singleframe_serving_fn(model, output_mode,
                                               cfg.dtype, device),
                   cfg, device)

    @classmethod
    def from_artifact(cls, loaded, cfg: TrackerConfig):
        """A single-frame serving artifact (``serve.LoadedServing``) in
        place of the model, on the device it was exported for."""
        meta = loaded.meta
        if meta.get("task") != "singleframe":
            raise ValueError(
                f"a {meta.get('task', 'multiframe')} artifact: the "
                "single-frame video CLI serves single-frame artifacts")
        for key in ("input_height", "input_width", "num_classes"):
            if meta[key] != getattr(cfg, key):
                raise ValueError(f"artifact {key}={meta[key]} != config "
                                 f"{getattr(cfg, key)}")
        return cls(loaded, cfg, loaded.device)

    def reset(self):
        """Nothing carries over from one frame to the next."""

    @torch.no_grad()
    def probs(self, frame_u8):
        """(H, W, 3) uint8 frame -> (H, W, C) float32 probabilities."""
        return self.serving(torch.as_tensor(frame_u8).to(self.device)[None])[0]

    def step_async(self, frame_u8, depth_u8=None):
        return outputs_from_probs(self.probs(frame_u8), self.cfg,
                                  heat_dtype=torch.float32)


def track_singleframe_frames(frames, engine: SingleFrameEngine, output_dir,
                             name: str = "frames", logger=None):
    """Track decoded (H, W, 3) uint8 RGB frames (host arrays or tensors)
    at the engine's size; writes ``{name}_tracked.csv``. Returns (rows,
    frames/s)."""
    return track_on_frames(frames, None, engine.cfg, output_dir, name=name,
                           logger=logger, engine=engine)


def track_singleframe_video(video_path, engine: SingleFrameEngine,
                            output_dir, logger=None):
    """Track one video file (read and resized with OpenCV); writes
    ``{video}_tracked.csv`` and, with ``cfg.overlay``, the MP4. Returns
    (rows, frames/s)."""
    return track_on_video(video_path, None, engine.cfg, output_dir,
                          logger=logger, engine=engine)


def _artifact_engine(args, logger):
    """A :class:`SingleFrameEngine` on ``--artifact``: no model
    code, no checkpoint; the frame size comes from its header."""
    loaded = load_artifact(args.artifact, args.device)
    meta = loaded.meta
    if meta.get("task") != "singleframe":
        raise SystemExit(
            f"{args.artifact} is a {meta.get('task', 'multiframe')} "
            "artifact; this is the single-frame video CLI")
    cfg = TrackerConfig(
        num_input_frames=1, num_classes=meta["num_classes"],
        input_height=meta["input_height"], input_width=meta["input_width"],
        score_detection_threshold=args.score_detection_threshold,
        area_threshold=args.area_threshold,
        dist_threshold=args.dist_threshold, dtype=meta["compute_dtype"],
        decode=args.decode,
    )
    logger.info(f"artifact serving: {args.artifact} ({cfg.input_height}x"
                f"{cfg.input_width}, {meta['device']})")
    return SingleFrameEngine.from_artifact(loaded, cfg)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_left_out_flags(args)
    if args.artifact is None and (args.model_type is None
                                  or args.load_wts_model is None):
        raise SystemExit("give --artifact, or --model_type and "
                         "--load_wts_model")
    if args.artifact is not None:
        return _track(args, None)
    output_mode = OUTPUT_MODES[args.model_type]
    if output_mode == "tapnet":
        # reference parity: TAPNet video tracking is NotImplementedError
        # there too (test_toolpose_segmentation_on_videos_v2.py:224-225)
        raise SystemExit(
            "TAPNet video tracking is not implemented (the reference "
            "raises NotImplementedError as well); use "
            "infer_toolpose_segmentation on an attmap-equipped dataset")
    return _track(args, output_mode)


def _track(args, output_mode):
    """Track ``--videos_dir`` through an engine of the model and its
    weights (``output_mode``), or of ``--artifact`` (``output_mode``
    None)."""
    out_dir = Path(args.expt_savedir) / args.expt_name / (
        "video_tracking_results")
    check_device(args.device)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger("sf_video_tracking_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.addHandler(logging.FileHandler(out_dir / "log.log"))
    logger.addHandler(logging.StreamHandler(sys.stdout))
    engine = (_artifact_engine(args, logger) if output_mode is None
              else _live_engine(args, output_mode, logger))
    if args.decode == "device":
        logger.warning(DEVICE_DECODE_WARNING)
    videos = list_video_files(args.videos_dir)
    if args.num_videos > 0:
        videos = videos[: args.num_videos]
    logger.info(f"Processing {len(videos)} videos")
    fps_all = []
    for video in videos:
        logger.info(f"Processing video: {video}")
        _, fps = track_singleframe_video(video, engine, out_dir, logger)
        fps_all.append(fps)
    if fps_all:
        logger.info(f"mean throughput: {np.mean(fps_all):.1f} frames/s")
    return fps_all


def _live_engine(args, output_mode, logger):
    """The model with its checkpoint's weights as a
    :class:`SingleFrameEngine` on ``--device``."""
    num_classes = 5
    H, W = args.input_height, args.input_width
    model = get_tooltip_segmentation_model(args.model_type, num_classes,
                                           scale=args.model_scale)
    model.load_state_dict(load_reference_state_dict(args.load_wts_model,
                                                    args.use_ema))
    logger.info(f"Loaded model weights from {args.load_wts_model}"
                + (" (EMA)" if args.use_ema else ""))
    cfg = TrackerConfig(
        num_input_frames=1, num_classes=num_classes, input_height=H,
        input_width=W,
        score_detection_threshold=args.score_detection_threshold,
        area_threshold=args.area_threshold,
        dist_threshold=args.dist_threshold, dtype=args.compute_dtype,
        decode=args.decode,
    )
    return SingleFrameEngine.from_model(model, cfg, output_mode,
                                        device=args.device)


if __name__ == "__main__":
    main()
