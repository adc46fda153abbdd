"""Shared test-set evaluation loop for the infer_* CLIs (counterpart of
``mfcnet_tpu/track/infer_eval.py``).

Implements the reference's evaluation protocol
(scripts/infer_multiframe_endovis15.py:43-233,
scripts/infer_toolpose_segmentation.py): per-sample IoU/Dice, centroid
errors with NaN filtering, detection-presence statistics (per-class
precision/recall/accuracy from presence confusion counts), and periodic
overlay dumps.

Each sample's work is split in two: :func:`device_half` runs the eval step
where the model lives (the card by default) and brings the float32
log-probabilities and the per-class IoU/Dice to the host;
:func:`host_half` scores them with the OpenCV/scipy centroid decode
(``track/errors.py``). The host half needs ``cv2``: where it is missing
the first sample raises ``ImportError`` naming it. Nothing here imports
``cv2`` at module level.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from mfcnet_tpu_torch.track.errors import centroid_error
from mfcnet_tpu_torch.utils.vis import draw_plus, mask_overlay

#: keypoints scored per task, by number of classes
N_KEYPOINTS = {3: 2, 5: 4, 11: 10}


class PresenceStats:
    """Presence confusion counts per keypoint class
    (reference: infer_multiframe_endovis15.py:163-197)."""

    def __init__(self, n: int):
        self.tp = np.zeros(n)
        self.fp = np.zeros(n)
        self.fn = np.zeros(n)
        self.tn = np.zeros(n)

    def update(self, present_gt, present):
        for i, (g, p) in enumerate(zip(present_gt, present)):
            if g and p:
                self.tp[i] += 1
            elif not g and p:
                self.fp[i] += 1
            elif g and not p:
                self.fn[i] += 1
            else:
                self.tn[i] += 1

    def summary(self):
        eps = 1e-12
        precision = self.tp / (self.tp + self.fp + eps)
        recall = self.tp / (self.tp + self.fn + eps)
        accuracy = (self.tp + self.tn) / (
            self.tp + self.tn + self.fp + self.fn + eps
        )
        return precision, recall, accuracy


def nanmean_std(values):
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0 or np.all(np.isnan(arr)):
        return float("nan"), float("nan")
    return float(np.nanmean(arr)), float(np.nanstd(arr))


def save_overlay(
    out_dir: Path, idx: int, image: np.ndarray, pred_classes: np.ndarray,
    c_pred=None, num_classes: int = 5,
):
    """Overlay PNG dump (reference: infer_multiframe_endovis15.py:110-151)."""
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    disp = (image * 0).astype(np.uint8) + image.astype(np.uint8)
    colors = [
        (255, 1, 0), (255, 255, 1), (0, 1, 255), (0, 255, 255),
        (1, 255, 0), (255, 0, 255), (128, 255, 1), (1, 128, 255),
        (255, 128, 1), (128, 1, 255),
    ]
    for cls in range(1, num_classes):
        disp = mask_overlay(
            disp, (pred_classes == cls).astype(np.uint8),
            colors[(cls - 1) % len(colors)],
        )
    if c_pred is not None:
        for k in range(0, len(c_pred) - 1, 2):
            xs, ys = c_pred[k], c_pred[k + 1]
            for x, y in zip(np.atleast_1d(xs), np.atleast_1d(ys)):
                if not (np.isnan(x) or np.isnan(y)):
                    disp = draw_plus(disp, (int(x), int(y)))
    cv2.imwrite(
        str(out_dir / f"output_{idx:05d}.png"),
        cv2.cvtColor(disp, cv2.COLOR_RGB2BGR),
    )


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def device_half(state, eval_step, batch):
    """The eval step on ``batch`` (where its tensors and the model live)
    -> (log-probabilities of the first sample, float32 (H, W, C) numpy;
    IoU and Dice per foreground class, averaged over the batch)."""
    log_probs, parts = eval_step(state, batch)
    lp = log_probs[0]
    if hasattr(lp, "float"):  # a tensor, perhaps bfloat16
        lp = lp.float()
    lp = _host(lp).astype(np.float32)
    iou = _host(parts["iou_per_class"]).mean(axis=0)
    dice = _host(parts["dice_per_class"]).mean(axis=0)
    return lp, iou, dice


def host_half(log_probs: np.ndarray, gt: np.ndarray, num_classes: int):
    """Centroid errors and presence of one sample: float32 (H, W, C)
    log-probabilities and the (H, W) class mask -> (probabilities,
    per-keypoint errors, presence in the ground truth, presence in the
    prediction, predicted centroids). Needs ``cv2``."""
    probs = np.exp(log_probs)
    res = centroid_error(probs, gt, num_classes)
    if num_classes == 5:
        err_rc, err_rb, err_lc, err_lb, p_gt, p, _, c_pred = res
        errs = [err_rc, err_rb, err_lc, err_lb]
    elif num_classes == 3:
        err_rc, err_lc, p_gt, p, _, c_pred = res
        errs = [err_rc, err_lc]
    else:
        errs, p_gt, p, _, c_pred = res
    return probs, errs, p_gt, p, c_pred


def evaluate_testset(
    loader,
    state,
    eval_step,
    prep_fn,
    num_classes: int,
    logger,
    out_dir: Optional[Path] = None,
    save_output_freq: int = 0,
    denorm_mean=(0.485, 0.456, 0.406),
    denorm_std=(0.229, 0.224, 0.225),
):
    """Run the full test loop; returns a results dict."""
    n_kp = N_KEYPOINTS[num_classes]
    errors = [[] for _ in range(n_kp)]
    presence = PresenceStats(n_kp)
    iou_sums = None
    dice_sums = None
    n = 0
    for idx, raw in enumerate(loader):
        batch = prep_fn(raw)
        log_probs, iou, dice = device_half(state, eval_step, batch)
        gt = _host(batch["mask"][0])
        probs, errs, p_gt, p, c_pred = host_half(log_probs, gt, num_classes)
        for i, e in enumerate(errs):
            errors[i].append(e)
        presence.update(p_gt, p)
        iou_sums = iou if iou_sums is None else iou_sums + iou
        dice_sums = dice if dice_sums is None else dice_sums + dice
        n += 1
        if (
            out_dir is not None
            and save_output_freq > 0
            and idx % save_output_freq == 0
        ):
            key = "frames" if "frames" in batch else "image"
            img = _host(batch[key])
            img = img[0, 0] if img.ndim == 5 else img[0]
            img = img[..., :3] * np.asarray(denorm_std) + np.asarray(
                denorm_mean
            )
            save_overlay(
                Path(out_dir), idx, np.clip(img * 255, 0, 255),
                probs.argmax(-1), c_pred, num_classes,
            )
        if idx % 50 == 0:
            logger.info(f"test [{idx}/{len(loader)}]")

    if n == 0:
        raise ValueError(
            "evaluate_testset: the loader yielded no samples -- check the "
            "dataset directory / fold / task configuration"
        )
    results = {"num_samples": n}
    for i in range(n_kp):
        mean, std = nanmean_std(errors[i])
        results[f"err_{i}_mean"] = mean
        results[f"err_{i}_std"] = std
        logger.info(f"keypoint {i}: centroid error {mean:.3f} ± {std:.3f} px")
    precision, recall, accuracy = presence.summary()
    for i in range(n_kp):
        logger.info(
            f"keypoint {i}: presence precision {precision[i]:.3f} "
            f"recall {recall[i]:.3f} accuracy {accuracy[i]:.3f}"
        )
    results["presence_precision"] = precision.tolist()
    results["presence_recall"] = recall.tolist()
    results["presence_accuracy"] = accuracy.tolist()
    results["iou_per_class"] = (iou_sums / max(1, n)).tolist()
    results["dice_per_class"] = (dice_sums / max(1, n)).tolist()
    logger.info(f"mean IoU per class: {results['iou_per_class']}")
    logger.info(f"mean Dice per class: {results['dice_per_class']}")
    return results
