"""Synthetic multi-frame dataset without OpenCV (counterpart of
``mfcnet_tpu/data/synthetic.py``).

The scene of the JAX generator: per video two instruments (left, right),
each a shaft line 5 px wide from its base to its centre and two tip
discs of radius 3, drifting by a random walk over noisy frames. Shapes
are rasterized with numpy (distance to the segment, to the disc centre),
not by OpenCV, so the frames are not pixel-equal to the JAX generator's.
The pose maps follow the reference's encoding (BGR; tips in the blue or
red channel, painted over the shaft's green), and the class mask is
composed from them by ``data/masks.py::compose_mask``; depth is a
vertical ramp with the instruments nearer.

:func:`make_synthetic_pack` writes packs (``data/packed.py``) directly --
the card has no OpenCV; :func:`make_synthetic_frames` gives the frames of
one video in memory (numpy only); :func:`make_jigsaws_like_dataset`
writes the JIGSAWS image tree and :func:`make_synthetic_video` an MP4,
both with OpenCV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mfcnet_tpu_torch.data.masks import compose_mask
from mfcnet_tpu_torch.data.packed import write_pack

SHAFT_RGB, TIP_RGB = (180, 180, 190), (220, 220, 80)


def _segment_dist(yy, xx, y0, x0, y1, x1):
    dy, dx = y1 - y0, x1 - x0
    n = dy * dy + dx * dx
    t = 0.0 if n == 0 else np.clip(((yy - y0) * dy + (xx - x0) * dx) / n,
                                   0.0, 1.0)
    return np.hypot(yy - (y0 + t * dy), xx - (x0 + t * dx))


def _keypoints(H, W, cx, cy, angle):
    """(base end (x, y), tip1 (x, y), tip2 (x, y)) of one instrument, in
    whole pixels inside a 5 px border."""

    def clip(v, hi):
        return int(np.clip(v, 5, hi - 6))

    base = (clip(cx - 30 * np.cos(angle), W), clip(cy - 30 * np.sin(angle), H))
    tips = tuple((clip(cx + 8 * np.cos(angle + da), W),
                  clip(cy + 8 * np.sin(angle + da), H)) for da in (0.4, -0.4))
    return (base,) + tips


def _instrument(H, W, cx, cy, angle):
    """Boolean (H, W) shaft, tip1 and tip2 masks of one instrument."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    (bx, by), *tips = _keypoints(H, W, cx, cy, angle)
    shaft = _segment_dist(yy, xx, by, bx, int(cy), int(cx)) <= 2.5
    tip1, tip2 = (np.hypot(yy - ty, xx - tx) <= 3.0 for tx, ty in tips)
    return shaft, tip1, tip2


def render_frame(rng, H, W, left, right):
    """One frame of the scene: instruments ``left``, ``right`` =
    (cx, cy, angle). Returns (image RGB (H, W, 3) uint8, left and right
    pose maps BGR uint8, the classes drawn (H, W) uint8 for the toolpose
    task: 1/2 right shaft/tips, 3/4 left shaft/tips, right over left,
    depth (H, W) uint8)."""
    img = np.full((H, W, 3), 40, np.uint8)
    img += rng.integers(0, 20, img.shape, dtype=np.uint8)
    depth = (60 + 100 * np.arange(H)[:, None] / max(H - 1, 1)
             + np.zeros((1, W))).astype(np.uint8)
    drawn = np.zeros((H, W), np.uint8)
    maps = []
    for (cx, cy, angle), (shaft_cls, tip_cls) in ((left, (3, 4)),
                                                   (right, (1, 2))):
        shaft, tip1, tip2 = _instrument(H, W, cx, cy, angle)
        pm = np.zeros((H, W, 3), np.uint8)
        pm[shaft] = (0, 255, 0)
        pm[tip1] = (0, 0, 255)  # red tip
        pm[tip2] = (255, 0, 0)  # blue tip
        tips = tip1 | tip2
        img[shaft] = SHAFT_RGB
        img[tips] = TIP_RGB
        depth[shaft | tips] = 220
        drawn[shaft] = shaft_cls
        drawn[tips] = tip_cls
        maps.append(pm)
    return img, maps[0], maps[1], drawn, depth


def _video(rng, H, W, n):
    """Frames of one video: yields render_frame's tuples."""
    left = [rng.uniform(0.25, 0.4) * W, rng.uniform(0.3, 0.7) * H,
            rng.uniform(0, 6.28)]
    right = [rng.uniform(0.6, 0.75) * W, rng.uniform(0.3, 0.7) * H,
             rng.uniform(0, 6.28)]
    for _ in range(n):
        yield render_frame(rng, H, W, tuple(left), tuple(right))
        for inst in (left, right):
            inst[0] += rng.uniform(-3, 3)
            inst[1] += rng.uniform(-3, 3)
            inst[2] += rng.uniform(-0.2, 0.2)


def make_synthetic_pack(out_dir, videos=(("train", 3, 8), ("val", 1, 4)),
                        height: int = 480, width: int = 640, seed: int = 0,
                        add_depth: bool = True,
                        prediction_task: str = "toolpose_segmentation",
                        dataset: str = "JIGSAWS",
                        mode: str = "training") -> Path:
    """Write one pack per split: ``videos`` = (split, number of videos,
    frames per video). The index carries the provenance the loaders check
    (``dataset``, ``mode``: ``training`` for ``train/`` and ``val/``,
    ``testing`` for the infer CLIs' ``test/``, ``fold_index`` -1).
    Returns ``out_dir``."""
    out_dir = Path(out_dir)
    rng = np.random.default_rng(seed)
    for split, nv, nf in videos:
        frames, masks, depths, vids = [], [], [], []
        for v in range(nv):
            for img, pml, pmr, _, depth in _video(rng, height, width, nf):
                frames.append(img)
                masks.append(compose_mask(pml, pmr, prediction_task))
                depths.append(depth)
                vids.append(v)
        write_pack(out_dir / split, frames, masks, vids, prediction_task,
                   depth=depths if add_depth else None,
                   extra={"dataset": dataset, "mode": mode,
                          "fold_index": -1})
    return out_dir


def make_jigsaws_like_dataset(root, num_videos: int = 2,
                              frames_per_video: int = 8, height: int = 96,
                              width: int = 128, seed: int = 0,
                              splits=("annotations_train", "annotations_val"),
                              add_depth: bool = False) -> Path:
    """Write the scene as a JIGSAWS image tree (``images/`` JPGs,
    ``pose_maps/`` PNG pairs, optional ``depth_maps_depthanythingv2/``);
    needs OpenCV."""
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split in splits:
        for v in range(1, num_videos + 1):
            vdir = root / split / f"video_{v}"
            dirs = ["images", "pose_maps"] + (
                ["depth_maps_depthanythingv2"] if add_depth else [])
            for d in dirs:
                (vdir / d).mkdir(parents=True, exist_ok=True)
            for f, (img, pml, pmr, _, depth) in enumerate(
                    _video(rng, height, width, frames_per_video)):
                name = f"frame_{f:04d}"
                cv2.imwrite(str(vdir / "images" / f"{name}.jpg"),
                            img[..., ::-1])
                cv2.imwrite(str(vdir / "pose_maps" / f"framel_{f:04d}.png"),
                            pml)
                cv2.imwrite(str(vdir / "pose_maps" / f"framer_{f:04d}.png"),
                            pmr)
                if add_depth:
                    cv2.imwrite(str(vdir / "depth_maps_depthanythingv2"
                                    / f"{name}.png"), depth)
    return root


def make_synthetic_frames(num_frames: int = 20, height: int = 96,
                          width: int = 128, seed: int = 0,
                          return_keypoints: bool = False):
    """RGB frames (N, H, W, 3) uint8 of one video of the scene, the JAX
    generator's walk: the left instrument from (0.3 W, 0.5 H) at angle
    0.5, the right one from (0.7 W, 0.5 H) at 3.5, each moved by
    uniform(-3, 3) px and uniform(-0.2, 0.2) rad a frame. With
    ``return_keypoints`` also the ground truth (N, 12) in the tracker
    CSV's column layout [ltip1, ltip2, rtip1, rtip2, lbase, rbase] (x, y
    each); a base is the midpoint of its shaft."""
    rng = np.random.default_rng(seed)
    H, W = height, width
    frames = np.zeros((num_frames, H, W, 3), np.uint8)
    gt = np.zeros((num_frames, 12), np.float64)
    left = [0.3 * W, 0.5 * H, 0.5]
    right = [0.7 * W, 0.5 * H, 3.5]
    for f in range(num_frames):
        frames[f] = render_frame(rng, H, W, tuple(left), tuple(right))[0]
        row = []
        for cx, cy, angle in (left, right):
            (bx, by), t1, t2 = _keypoints(H, W, cx, cy, angle)
            row.append((t1, t2, ((bx + int(cx)) / 2.0, (by + int(cy)) / 2.0)))
        (lt1, lt2, lb), (rt1, rt2, rb) = row
        gt[f] = [*lt1, *lt2, *rt1, *rt2, *lb, *rb]
        for inst in (left, right):
            inst[0] += rng.uniform(-3, 3)
            inst[1] += rng.uniform(-3, 3)
        for inst in (left, right):
            inst[2] += rng.uniform(-0.2, 0.2)
    if return_keypoints:
        return frames, gt
    return frames


def make_synthetic_video(path, num_frames: int = 20, height: int = 96,
                         width: int = 128, fps: int = 30, seed: int = 0,
                         return_keypoints: bool = False):
    """Write :func:`make_synthetic_frames`' video as an MP4 (mp4v) at
    ``path``; returns the path, and with ``return_keypoints`` also the
    ground-truth (N, 12) keypoints. Needs OpenCV."""
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames, gt = make_synthetic_frames(num_frames, height, width, seed,
                                       return_keypoints=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    try:
        for img in frames:
            writer.write(img[..., ::-1].copy())
    finally:
        writer.release()
    if return_keypoints:
        return path, gt
    return path
