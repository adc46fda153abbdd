"""Evaluation metrics (counterpart of ``mfcnet_tpu/train/metrics.py``;
reference src/metrics.py): per-image, per-foreground-class IoU and Dice
of the argmax prediction, on the device."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def confusion_matrix(pred, target, num_classes: int):
    """(C, C) counts, rows ground truth, columns prediction
    (src/metrics.py:50-56)."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes).to(torch.float32)


def per_class_iou_dice(pred, target, num_classes: int, eps: float = 1e-15):
    """pred, target (B, H, W) class maps -> (iou, dice), each
    (B, num_classes - 1) for classes 1..C-1 (src/metrics.py:41-48)."""
    ious, dices = [], []
    for cls in range(1, num_classes):
        t = (target == cls).to(torch.float32)
        p = (pred == cls).to(torch.float32)
        inter = (p * t).sum(dim=(-2, -1))
        union = t.sum(dim=(-2, -1)) + p.sum(dim=(-2, -1))
        ious.append((inter + eps) / (union - inter + eps))
        dices.append((2.0 * inter + eps) / (union + eps))
    return torch.stack(ious, dim=-1), torch.stack(dices, dim=-1)


def compute_metrics(log_probs, targets, metric_fns: Sequence[str],
                    num_classes: int) -> Dict[str, torch.Tensor]:
    """``{metric}_per_class`` (B, C-1) and the scalar means ``metric_{fn}``
    of the argmax of ``log_probs`` (B, H, W, C)."""
    iou, dice = per_class_iou_dice(log_probs.argmax(dim=-1), targets,
                                   num_classes)
    out: Dict[str, torch.Tensor] = {}
    for fn in metric_fns:
        if fn not in ("iou", "dice"):
            raise ValueError(f"Metric function {fn} not implemented")
        v = iou if fn == "iou" else dice
        out[f"{fn}_per_class"] = v
        out[f"metric_{fn}"] = v.mean()
    return out
