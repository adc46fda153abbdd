"""Sample frames from a random video for annotation (counterpart of
``mfcnet_tpu/cli/get_frames_for_annotation_from_videos.py``; reference
scripts/get_frames_for_annotation_from_videos.py): 225 frames at a
5-frame stride from one video, chosen by ``random.seed(--seed)`` and
``randrange`` over the sorted video list (or ``--video_index``), written
as ``{output_dir}/{video}/images/frame_{i:04d}.jpg``. Needs OpenCV.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
    list_video_files,
)


def build_parser():
    p = argparse.ArgumentParser(description="Extract annotation frames")
    p.add_argument("--videos_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--num_frames", type=int, default=225)
    p.add_argument("--frame_stride", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--video_index", type=int, default=-1,
                   help="-1 picks a random video")
    return p


def main(argv=None):
    import cv2

    args = build_parser().parse_args(argv)
    videos = list_video_files(args.videos_dir)
    if not videos:
        raise FileNotFoundError(f"no videos under {args.videos_dir}")
    random.seed(args.seed)
    idx = (args.video_index if args.video_index >= 0
           else random.randrange(len(videos)))
    video = videos[idx]
    out = Path(args.output_dir) / Path(video).stem / "images"
    out.mkdir(parents=True, exist_ok=True)
    vid = cv2.VideoCapture(video)
    count = saved = 0
    try:
        while saved < args.num_frames:
            ret, frame = vid.read()
            if not ret:
                break
            if count % args.frame_stride == 0:
                cv2.imwrite(str(out / f"frame_{saved:04d}.jpg"), frame)
                saved += 1
            count += 1
    finally:
        vid.release()
    print(f"Saved {saved} frames from {video} to {out}")
    return saved


if __name__ == "__main__":
    main()
