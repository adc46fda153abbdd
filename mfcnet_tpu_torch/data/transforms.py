"""Train augmentation and eval preprocessing on the batch (counterpart of
``mfcnet_tpu/data/transforms.py``; reference
src/dataloader_multiframe.py:209-223).

The stack, per sample: uint8 -> [0, 1] float; rotate frames, mask and
depth by one integer angle in [-15, 15) (nearest, zero fill); with
probability 1/2 a colour jitter with independent brightness, contrast and
saturation factors in [0.95, 1.05) per frame; resize (bilinear frames,
nearest mask and depth); vertical flip, then horizontal flip, each with
probability 1/2 and with the task's class remaps; ImageNet normalization.

The random draws are split from their application: :func:`draw_augmentation`
takes an explicit ``torch.Generator``, and :func:`apply_augmentation` is a
pure function of the batch and the draws. JAX's random streams cannot be
reproduced, so a test hands the JAX draws to :func:`apply_augmentation`.
The application runs wherever the batch lies (on the card in training).

Batches are dicts of uint8 arrays in the JAX layout: frames (B, T, H, W,
3), mask (B, H, W), optional depth (B, T, H, W). Outputs: frames
(B, T, h, w, 3) float32 normalized, mask (B, h, w) int64, depth
(B, T, h, w, 1) float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfcnet_tpu_torch.ops.color import (
    adjust_brightness,
    adjust_contrast,
    adjust_saturation,
)
from mfcnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from mfcnet_tpu_torch.ops.rotate import rotate_nearest
from mfcnet_tpu_torch.parallel.dist import rank_rows

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _hflip_table(task: str, num_classes: int) -> np.ndarray:
    """Class remap of a horizontal flip (left and right swap)."""
    t = np.arange(256, dtype=np.int32)
    if task == "tooltip_segmentation":
        t[1], t[2] = 2, 1
    elif task == "toolpose_segmentation":
        t[1], t[3] = 3, 1
        t[2], t[4] = 4, 2
    elif task == "endovis15_segmentation":
        for k in range(1, 6):
            t[k], t[k + 5] = k + 5, k
    return t


def _vflip_table(task: str) -> np.ndarray:
    """Class remap of a vertical flip (EndoVis15's joint pairs)."""
    t = np.arange(256, dtype=np.int32)
    if task == "endovis15_segmentation":
        t[4], t[5] = 5, 4
        t[9], t[10] = 10, 9
    return t


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    out_height: int = 480
    out_width: int = 640
    prediction_task: str = "toolpose_segmentation"
    jitter_p: float = 0.5
    flip_p: float = 0.5
    rotate_lo: int = -15
    rotate_hi: int = 15  # exclusive, as np.random.randint(-15, 15)


def draw_augmentation(generator: torch.Generator, B: int, T: int,
                      cfg: TransformConfig) -> dict:
    """The random draws of one batch, on the CPU: ``angle`` (B,) int64
    degrees, ``jitter`` (B,) bool, ``factors`` (B, T, 3) float32
    (brightness, contrast, saturation per frame), ``vflip`` and ``hflip``
    (B,) bool."""
    g = generator
    return {
        "angle": torch.randint(cfg.rotate_lo, cfg.rotate_hi, (B,),
                               generator=g),
        "jitter": torch.rand(B, generator=g) < cfg.jitter_p,
        "factors": 0.95 + 0.1 * torch.rand(B, T, 3, generator=g),
        "vflip": torch.rand(B, generator=g) < cfg.flip_p,
        "hflip": torch.rand(B, generator=g) < cfg.flip_p,
    }


def _to_tensors(batch, device):
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


def _normalize(frames):
    """(..., 3, H, W) in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=frames.device).view(3, 1, 1)
    return (frames - mean) / std


def _flip(x, do, dim):
    """x (B, ...) flipped along ``dim`` where ``do`` (B,) is set."""
    return torch.where(do.view(-1, *([1] * (x.dim() - 1))), x.flip(dim), x)


def _layout_out(frames, mask, depth):
    out = {"frames": frames.permute(0, 1, 3, 4, 2), "mask": mask}
    if depth is not None:
        out["depth"] = depth[..., None]
    return out


def apply_augmentation(batch, draws: dict, cfg: TransformConfig,
                       device=None) -> dict:
    """Augment a batch with given draws (see the module docstring); runs on
    ``device`` (default: where the batch lies)."""
    b = _to_tensors(batch, device)
    dev = b["frames"].device
    d = {k: v.to(dev) for k, v in draws.items()}
    B, T = b["frames"].shape[:2]
    H, W = b["frames"].shape[2:4]
    frames = b["frames"].permute(0, 1, 4, 2, 3).to(torch.float32) / 255.0
    mask = b["mask"].to(torch.int64)
    depth = b.get("depth")
    if depth is not None:
        depth = depth.to(torch.float32) / 255.0

    angle = d["angle"].to(torch.float32)
    frames = rotate_nearest(frames, angle)
    mask = rotate_nearest(mask, angle)
    if depth is not None:
        depth = rotate_nearest(depth, angle)

    f = d["factors"].to(torch.float32)
    jit = adjust_brightness(frames, f[..., 0, None, None, None])
    jit = adjust_contrast(jit, f[..., 1, None, None, None])
    jit = adjust_saturation(jit, f[..., 2, None, None, None])
    frames = torch.where(d["jitter"].view(B, 1, 1, 1, 1), jit, frames)

    h, w = cfg.out_height, cfg.out_width
    frames = resize_bilinear(frames.reshape(B * T, 3, H, W), h, w).reshape(
        B, T, 3, h, w)
    mask = resize_nearest(mask, h, w)
    if depth is not None:
        depth = resize_nearest(depth, h, w)

    vt = torch.from_numpy(_vflip_table(cfg.prediction_task)).to(dev)
    ht = torch.from_numpy(_hflip_table(cfg.prediction_task, 0)).to(dev)
    vf, hf = d["vflip"], d["hflip"]
    frames = _flip(frames, vf, -2)
    mask = torch.where(vf.view(B, 1, 1), vt.long()[mask].flip(-2), mask)
    if depth is not None:
        depth = _flip(depth, vf, -2)
    frames = _flip(frames, hf, -1)
    mask = torch.where(hf.view(B, 1, 1), ht.long()[mask].flip(-1), mask)
    if depth is not None:
        depth = _flip(depth, hf, -1)
    return _layout_out(_normalize(frames), mask, depth)


def augment_train_batch(batch, generator: torch.Generator,
                        cfg: TransformConfig, device=None,
                        rows=(0, 1)) -> dict:
    """Draw from ``generator`` and augment (see :func:`apply_augmentation`).
    ``rows`` (rank, world): the batch is rank's rows of a global batch of
    world times its size (data parallelism), and the draws are the global
    batch's, of which it takes its rows, as the JAX package augments the
    assembled global batch with one key."""
    B, T = np.shape(batch["frames"])[:2]
    rank, world = rows
    mine = rank_rows(B * world, rank, world)
    draws = draw_augmentation(generator, B * world, T, cfg)
    return apply_augmentation(batch, {k: v[mine] for k, v in draws.items()},
                              cfg, device)


def preprocess_eval_batch(batch, cfg: TransformConfig, device=None) -> dict:
    """Eval: to float, resize, normalize; no augmentation
    (src/dataloader_multiframe.py:215-220)."""
    b = _to_tensors(batch, device)
    B, T, H, W, _ = b["frames"].shape
    h, w = cfg.out_height, cfg.out_width
    frames = b["frames"].permute(0, 1, 4, 2, 3).to(torch.float32) / 255.0
    frames = resize_bilinear(frames.reshape(B * T, 3, H, W), h, w).reshape(
        B, T, 3, h, w)
    mask = resize_nearest(b["mask"].to(torch.int64), h, w)
    depth = b.get("depth")
    if depth is not None:
        depth = resize_nearest(depth.to(torch.float32) / 255.0, h, w)
    return _layout_out(_normalize(frames), mask, depth)
