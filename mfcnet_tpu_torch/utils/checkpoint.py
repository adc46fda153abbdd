"""Checkpoints (counterpart of ``mfcnet_tpu/utils/checkpoint.py``;
reference utils/model_utils.py).

``ckpts/model_{epoch:03d}.pth`` holds the reference's ``{model,
optimizer, epoch}`` dict (``mfcnet_tpu/compat/torch_convert.py`` reads
it) plus ``step``, ``updates``, ``micro`` and, with an EMA, ``ema`` (a
full ``state_dict`` with the EMA weights); an interrupt snapshot
(``model_999``) also holds ``batches_done``. Beside each file a
``.json`` sidecar holds the epoch (and ``batches_done``); it is written
after the checkpoint, atomically, so a sidecar marks a complete
checkpoint and :func:`latest_checkpoint` reads positions without loading
weights.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import torch


def _atomic_save(obj, path: Path):
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir, epoch: int, state,
                    extra: Optional[dict] = None) -> Path:
    """Write ``model_{epoch:03d}.pth`` from a :class:`TrainState` and its
    sidecar. ``extra`` (``{"epoch": e, "batches_done": k}`` for an
    interrupt snapshot) goes into both."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta = {"epoch": epoch, **(extra or {})}
    payload = {**state.state_dict(), **meta}
    path = ckpt_dir / f"model_{epoch:03d}.pth"
    _atomic_save(payload, path)
    side = path.with_suffix(".json")
    tmp = side.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, side)
    return path


def load_checkpoint(path) -> Tuple[dict, int]:
    """(payload, epoch) of a checkpoint written by :func:`save_checkpoint`
    or by the reference (``{model, optimizer, epoch}``)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return payload, int(payload.get("epoch", 0))


#: torchvision's auxiliary FCN head of a ``pretrained=True`` DeepLabV3 or
#: FCN, which the reference carries in its checkpoints and loads with
#: ``strict=False`` (reference utils/model_utils.py:14-39); no forward
#: reads it
AUX_PREFIXES = ("aux_classifier.", "base_model.aux_classifier.")


def load_state_dict_file(path, use_ema: bool = False) -> dict:
    """A model ``state_dict`` from a ``.pth``: a checkpoint dict (its
    ``model``, or its ``ema`` with ``use_ema``) or a bare state_dict;
    DataParallel ``module.`` prefixes removed, and the ``aux_classifier.*``
    keys of a reference DeepLab or FCN (alone or as a Multi wrapper's
    base), whose count is logged; every other key stays."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if use_ema:
        if not isinstance(blob, dict) or blob.get("ema") is None:
            raise ValueError(f"{path}: no EMA weights (train with "
                             "--ema_decay to write them)")
        sd = blob["ema"]
    else:
        sd = (blob["model"] if isinstance(blob, dict) and "model" in blob
              else blob)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    aux = {k for k in sd if k.startswith(AUX_PREFIXES)}
    if aux:
        logging.getLogger(__name__).info(
            f"{path}: dropped {len(aux)} aux_classifier keys (the "
            "reference's unused auxiliary head)")
    return {k: v for k, v in sd.items() if k not in aux}


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The checkpoint at the furthest training position: a complete epoch
    e is at (e + 1, before its first batch), an interrupt snapshot
    (``batches_done`` k in epoch e) at (e, k). The interrupt snapshot's
    fixed name ``model_999`` plays no part. Entries without a sidecar are
    incomplete and skipped."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None

    def position(p: Path):
        meta = json.loads(p.with_suffix(".json").read_text())
        epoch = int(meta["epoch"])
        if "batches_done" in meta:
            return (epoch, float(meta["batches_done"]), p.stem)
        return (epoch + 1, -1.0, p.stem)

    cands = [p for p in ckpt_dir.glob("model_*.pth")
             if p.with_suffix(".json").exists()]
    return max(cands, key=position) if cands else None
