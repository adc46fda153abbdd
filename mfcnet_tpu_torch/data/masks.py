"""Image, depth, mask and ``.flo`` file IO (counterpart of
``mfcnet_tpu/data/masks.py``; reference utils/dataloader_utils.py:8-85):
the port's own copy, numpy only. OpenCV is imported inside the functions
that decode files, so the pack path (and the card, which has no cv2)
never needs it. The JAX package's optional C++ mask composer
(``native/``) is not used: the numpy cascade is the reference tables.

Mask composition (left/right pose-map PNG colour channels -> class ids):
  tooltip:   L tips (B or R > 0) -> 255, R tips -> 127; /127 -> {0, 1, 2}
  toolpose:  L: B/R > 0 -> 255, G > 0 -> 191; R: B/R > 0 -> 127,
             G > 0 -> 63; /63 -> {0, 1, 2, 3, 4}
  endovis15: 5 joints x L/R by channel thresholds in steps of 25;
             /25 -> {0..10}
  binary:    binary_masks PNG / 255 -> {0, 1}
"""

from __future__ import annotations

import numpy as np


def _imread(path, flags=None):
    import cv2

    img = cv2.imread(str(path)) if flags is None else cv2.imread(
        str(path), flags)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_image(path) -> np.ndarray:
    """BGR file -> RGB uint8 (H, W, 3) (utils/dataloader_utils.py:24-28)."""
    return np.ascontiguousarray(_imread(path)[..., ::-1])


def load_depthmap(path, depth_dir: str = "depth_maps_depthanythingv2"):
    """DepthAnything-v2 PNG -> grayscale uint8 (H, W)
    (utils/dataloader_utils.py:30-34)."""
    import cv2

    p = str(path).replace("images", depth_dir).replace("jpg", "png")
    return cv2.cvtColor(_imread(p), cv2.COLOR_BGR2GRAY)


def _read_pose_maps(path, folder: str):
    pl = str(path).replace("images", folder).replace("frame", "framel")
    pr = str(path).replace("images", folder).replace("frame", "framer")
    return (_imread(pl.replace("jpg", "png")),
            _imread(pr.replace("jpg", "png")))


def compose_mask(maskl: np.ndarray, maskr: np.ndarray,
                 prediction_task: str) -> np.ndarray:
    """Pose-map pair (BGR uint8 (H, W, 3) each) -> class-id mask (H, W)
    uint8, by the reference's cascade (later rules overwrite earlier)."""
    mask = np.zeros(maskl.shape[:2], np.float64)
    if prediction_task == "tooltip_segmentation":
        if maskl.max():
            mask[maskl[:, :, 0] > 0] = 255
            mask[maskl[:, :, 2] > 0] = 255
        if maskr.max():
            mask[maskr[:, :, 0] > 0] = 127
            mask[maskr[:, :, 2] > 0] = 127
        return (mask / 127).astype(np.uint8)
    if prediction_task == "endovis15_segmentation":
        for m, vals in ((maskl, (250, 225, 200, 175, 150)),
                        (maskr, (125, 100, 75, 50, 25))):
            if m.max():
                mask[m[:, :, 0] > 0] = vals[0]
                mask[m[:, :, 2] > 0] = vals[1]
                mask[m[:, :, 1] == 255] = vals[2]
                mask[m[:, :, 1] == 127] = vals[3]
                mask[m[:, :, 1] == 63] = vals[4]
        return (mask / 25).astype(np.uint8)
    if prediction_task == "toolpose_segmentation":
        for m, tip, shaft in ((maskl, 255, 191), (maskr, 127, 63)):
            if m.max():
                mask[m[:, :, 0] > 0] = tip
                mask[m[:, :, 2] > 0] = tip
                mask[m[:, :, 1] > 0] = shaft
        return (mask / 63).astype(np.uint8)
    raise ValueError(f"Unknown prediction task: {prediction_task}")


def load_mask(path, prediction_task: str) -> np.ndarray:
    """The class-id mask of a frame, composed from its pose maps
    (utils/dataloader_utils.py:36-85); the ``frame`` -> ``framel`` /
    ``framer`` replacement applies to the whole path, as in the
    reference."""
    if prediction_task == "binary":
        p = str(path).replace("images", "binary_masks").replace("jpg", "png")
        return (_imread(p, 0) / 255).astype(np.uint8)
    folder = ("pose_maps_endovis"
              if prediction_task == "endovis15_segmentation" else "pose_maps")
    maskl, maskr = _read_pose_maps(path, folder)
    return compose_mask(maskl, maskr, prediction_task)


def read_flo(path) -> np.ndarray:
    """Standard Middlebury .flo reader (magic + W, H header) -> (H, W, 2)
    float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or abs(magic[0] - 202021.25) > 1e-3:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray):
    """Write Middlebury .flo ("PIEH" magic + W, H header; reference
    scripts/generate_opticalflow_unflow.py:114-115)."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([80, 73, 69, 72], np.uint8).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
