"""Per-video tracking CLI (counterpart of
``mfcnet_tpu/cli/test_multiframe_segmentation_on_videos.py``; reference
scripts/test_multiframe_segmentation_on_videos_v3.py). Writes
``{video}_tracked.csv`` (N x 12 keypoints) and, with overlays, MP4s under
``{expt_savedir}/{expt_name}/video_tracking_results``.

Same flags as the JAX CLI. ``--load_wts_model`` takes a reference
``.pth`` (a ``{model, optimizer, epoch}`` dict or a bare state_dict,
DataParallel ``module.`` prefixes allowed), such as a checkpoint of the
port's trainer; ``--use_ema True`` loads that checkpoint's EMA weights.
``--add_optflow_inputs True`` adds the frozen RAFT flow provider;
``--load_wts_flow_model`` takes a
torchvision ``raft_large`` ``.pth`` (its key names load directly), and
without it the provider keeps its seeded random weights.
``--add_depth_inputs True`` reads one depth video per RGB video from
``--depth_videos_dir``. ``--model_type`` takes the
``{TernausNet,DeepLab,FCN,HRNet,SegFormer,UNet,ResUNet}Multi-{Basic,Large}``
types: a Basic model warps the earlier maps by the flow, a Large one takes
the flow raw into its head. ``--parallel_videos P`` tracks the videos in groups of
up to P at once, through one engine with ``num_streams`` = the group's
size (one engine kept per group size): each group's frames are read into
memory first, and the CSVs are those of the sequential run. The tracker runs on
the card; ``--device cpu`` asks for the CPU, and without a card the
default is an error. Flags of later slices are accepted and raise an
error that names their ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
from mfcnet_tpu_torch.track.tracker import (
    InferenceEngine,
    TrackerConfig,
    track_on_frame_streams,
    track_on_video,
)

_MODELS = [
    "TernausNetMulti-Basic", "TernausNetMulti-Large",
    "DeepLabMulti-Basic", "DeepLabMulti-Large",
    "FCNMulti-Basic", "FCNMulti-Large",
    "SegFormerMulti-Basic", "SegFormerMulti-Large",
    "HRNetMulti-Basic", "HRNetMulti-Large",
    "UNetMulti-Basic", "UNetMulti-Large",
    "ResUNetMulti-Basic", "ResUNetMulti-Large",
]

#: flag -> (value that means "not used", ROADMAP item that ports it)
_LATER_FLAGS = {
    "artifact": (None, "Queue 1 item 11 (serving and scale)"),
    "spatial_shards": (1, "Queue 1 item 11 (serving and scale)"),
}


def _bool(v):
    return v.lower() in ("true", "1", "yes")


def build_parser():
    p = argparse.ArgumentParser(
        description="Test Multiframe Segmentation Model on Videos (PyTorch)"
    )
    p.add_argument("--videos_dir", type=str, required=True)
    p.add_argument("--depth_videos_dir", type=str, default=None)
    p.add_argument("--expt_savedir", type=str, required=True)
    p.add_argument("--expt_name", type=str, required=True)
    p.add_argument("--model_type", type=str, default=None, choices=_MODELS)
    p.add_argument("--num_input_frames", type=int, default=3)
    p.add_argument("--load_wts_model", type=str, default=None,
                   help="reference .pth checkpoint")
    p.add_argument("--artifact", type=str, default=None)
    p.add_argument("--use_ema", type=_bool, default=False)
    p.add_argument("--num_videos", type=int, default=-1)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--score_detection_threshold", type=float, default=0)
    p.add_argument("--area_threshold", type=int, default=10)
    p.add_argument("--dist_threshold", type=int, default=40)
    p.add_argument("--add_optflow_inputs", type=_bool, default=False)
    p.add_argument("--add_depth_inputs", type=_bool, default=False)
    p.add_argument("--load_wts_flow_model", type=str, default=None,
                   help="torchvision raft_large .pth (state_dict)")
    p.add_argument("--tracker_mode", type=str, default="incremental",
                   choices=["incremental", "full"])
    p.add_argument("--decode", type=str, default="host",
                   choices=["host", "device"],
                   help="host = exact OpenCV-parity decode; device = "
                        "decode on the GPU (CUDA kernels)")
    p.add_argument("--fetch_batch", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--model_scale", type=float, default=1.0)
    p.add_argument("--spatial_shards", type=int, default=1)
    p.add_argument("--parallel_videos", type=int, default=1,
                   help="track this many videos at once through one "
                        "batched engine; rows equal the sequential run's")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def list_video_files(directory):
    out = []
    for root, _, files in os.walk(directory):
        for f in files:
            if f.endswith((".mp4", ".avi", ".mov")):
                out.append(os.path.join(root, f))
    return sorted(out)


def load_reference_state_dict(path, use_ema: bool = False):
    """A reference ``.pth`` (or a checkpoint of the port's trainer, whose
    ``ema`` entry ``use_ema`` selects) -> state_dict (``module.`` prefixes
    off)."""
    from mfcnet_tpu_torch.utils.checkpoint import load_state_dict_file

    if str(path).endswith(".msgpack"):
        raise SystemExit(
            f"{path}: a flax checkpoint; convert its variables with "
            "mfcnet_tpu_torch/compat/from_jax.py (state_dict_from_jax) and "
            "torch.save the result as a .pth"
        )
    try:
        return load_state_dict_file(path, use_ema=use_ema)
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, (unused, item) in _LATER_FLAGS.items():
        if getattr(args, flag) != unused:
            raise SystemExit(f"--{flag} is not ported yet: ROADMAP.md {item}")
    if args.model_type is None or args.load_wts_model is None:
        raise SystemExit("--model_type and --load_wts_model are required")
    if args.add_depth_inputs and args.depth_videos_dir is None:
        raise SystemExit("--add_depth_inputs needs --depth_videos_dir")
    out_dir = Path(args.expt_savedir) / args.expt_name / (
        "video_tracking_results"
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger("video_tracking_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.addHandler(logging.FileHandler(out_dir / "log.log"))
    logger.addHandler(logging.StreamHandler(sys.stdout))

    num_classes = 5
    T, H, W = args.num_input_frames, args.input_height, args.input_width
    model = get_multiframe_segmentation_model(
        args.model_type, num_classes=num_classes, num_input_frames=T,
        add_optflow_inputs=args.add_optflow_inputs,
        add_depth_inputs=args.add_depth_inputs, scale=args.model_scale,
    )
    model.load_state_dict(load_reference_state_dict(args.load_wts_model,
                                                    args.use_ema))
    logger.info(f"Loaded model weights from {args.load_wts_model}"
                + (" (EMA)" if args.use_ema else ""))

    cfg = TrackerConfig(
        num_input_frames=T, num_classes=num_classes, input_height=H,
        input_width=W,
        score_detection_threshold=args.score_detection_threshold,
        area_threshold=args.area_threshold,
        dist_threshold=args.dist_threshold, mode=args.tracker_mode,
        decode=args.decode, dtype=args.compute_dtype,
        add_depth_inputs=args.add_depth_inputs,
        add_optflow_inputs=args.add_optflow_inputs,
        fetch_batch=args.fetch_batch,
    )
    if args.decode == "device":
        logger.warning(
            "--decode device: base centroids use the on-device polygon-"
            "moment approximation; any ambiguous decision falls back to "
            "the exact host decode for that side. Use --decode host for "
            "bit-exact reference parity."
        )
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")
    flow_model = None
    if args.add_optflow_inputs:
        # frozen RAFT provider (the reference loads torchvision raft_large);
        # the engine runs a bfloat16 provider through the fused update step
        from mfcnet_tpu_torch.models.raft import RAFT

        torch.manual_seed(1)
        flow_model = RAFT(iters=12, input_hw=(H // 2, W // 2))
        if args.load_wts_flow_model:
            flow_model.load_state_dict(
                load_reference_state_dict(args.load_wts_flow_model))
            logger.info(
                f"Loaded flow model weights from {args.load_wts_flow_model}")
    videos = list_video_files(args.videos_dir)
    if args.num_videos > 0:
        videos = videos[: args.num_videos]
    logger.info(f"Processing {len(videos)} video files from {args.videos_dir}")
    if args.add_depth_inputs:
        depth_videos = list_video_files(args.depth_videos_dir)
        if args.num_videos > 0:
            depth_videos = depth_videos[: args.num_videos]
        if len(depth_videos) != len(videos):
            raise SystemExit(
                f"{len(videos)} videos but {len(depth_videos)} depth videos")
    else:
        depth_videos = [None] * len(videos)
    engines = {}

    def engine_for(streams):
        if streams not in engines:
            engines[streams] = InferenceEngine(
                model, cfg, flow_model=flow_model, device=args.device,
                num_streams=streams)
        return engines[streams]

    fps_all = []
    P = max(1, args.parallel_videos)
    if P > 1:
        items = list(zip(videos, depth_videos))
        for i in range(0, len(items), P):
            group = items[i:i + P]
            streams = [read_all_frames(v, W, H) for v, _ in group]
            dstreams = None
            if args.add_depth_inputs:
                dstreams = [read_all_frames(d, W, H, gray=True)
                            for _, d in group]
                for (v, d), fs, ds in zip(group, streams, dstreams):
                    if len(fs) != len(ds):
                        raise ValueError(
                            f"RGB({len(fs)}) vs depth({len(ds)}) frame-count "
                            f"mismatch: {v} / {d}")
            names = [Path(v).stem for v, _ in group]
            logger.info(f"Tracking {len(group)} videos at once: {names}")
            _, fps = track_on_frame_streams(
                streams, None, cfg, out_dir, names=names,
                depth_streams=dstreams, logger=logger,
                engine=engine_for(len(group)))
            fps_all.append(fps)
    else:
        for video, depth_video in zip(videos, depth_videos):
            logger.info(f"Processing video: {video}")
            _, fps = track_on_video(video, None, cfg, out_dir,
                                    depth_video_path=depth_video,
                                    logger=logger, engine=engine_for(1))
            fps_all.append(fps)
    if fps_all:
        logger.info(f"mean throughput: {np.mean(fps_all):.1f} frames/s")
    return fps_all


def read_all_frames(path, W, H, gray=False):
    """A whole video as resized RGB (or grayscale) uint8 frames in
    memory."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    try:
        while True:
            ret, f = cap.read()
            if not ret:
                return out
            f = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY if gray
                             else cv2.COLOR_BGR2RGB)
            out.append(cv2.resize(f, (W, H)))
    finally:
        cap.release()


if __name__ == "__main__":
    main()
