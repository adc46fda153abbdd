"""Packed zero-decode dataset shards (counterpart of
``mfcnet_tpu/data/packed.py``): the same ``mfcnet_tpu.packed/1`` format,
so a pack written by either package (or ``tools/pack_dataset.py``) loads
in the other.

Layout of a pack directory::

    index.json   {"format": "mfcnet_tpu.packed/1", "n", "height",
                  "width", "prediction_task", "has_depth",
                  "video_ids": [per-frame video id],
                  "names": [source file names], ...provenance}
    frames.u8    (N, H, W, 3) raw uint8, C order
    masks.u8     (N, H, W)    raw uint8 class ids
    depth.u8     (N, H, W)    raw uint8 (only when has_depth)

A sample read is a memory-mapped slice: no decode, no OpenCV (the card
has none). ``video_ids`` keep the window clamp of the file tree
(``data/dataset.py::window_indices``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mfcnet_tpu_torch.data.dataset import window_indices

FORMAT = "mfcnet_tpu.packed/1"


def write_pack(out_dir, frames, masks, video_ids, prediction_task: str,
               depth=None, names=None, extra: Optional[dict] = None) -> dict:
    """Write arrays as a pack: frames (N, H, W, 3), masks (N, H, W) and
    optional depth (N, H, W), uint8, or iterables of per-frame arrays of
    those shapes (written one at a time) with ``n`` = len(video_ids).
    Returns the index."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    N = len(video_ids)
    frames_it, masks_it = iter(frames), iter(masks)
    depth_it = None if depth is None else iter(depth)
    first = np.asarray(next(frames_it), np.uint8)
    H, W = first.shape[:2]
    fmap = np.memmap(out_dir / "frames.u8", np.uint8, "w+", shape=(N, H, W, 3))
    mmap = np.memmap(out_dir / "masks.u8", np.uint8, "w+", shape=(N, H, W))
    dmap = (np.memmap(out_dir / "depth.u8", np.uint8, "w+", shape=(N, H, W))
            if depth_it is not None else None)
    for i in range(N):
        img = first if i == 0 else np.asarray(next(frames_it), np.uint8)
        if img.shape != (H, W, 3):
            raise ValueError(f"frame {i}: shape {img.shape} != {(H, W, 3)}")
        fmap[i] = img
        mmap[i] = next(masks_it)
        if dmap is not None:
            dmap[i] = next(depth_it)
    for m in (fmap, mmap, dmap):
        if m is not None:
            m.flush()
    index = {
        "format": FORMAT, "n": N, "height": H, "width": W,
        "prediction_task": prediction_task, "has_depth": dmap is not None,
        "video_ids": [int(v) for v in video_ids],
        "names": list(names) if names is not None else [
            f"frame_{i:06d}" for i in range(N)],
    }
    index.update(extra or {})
    (out_dir / "index.json").write_text(json.dumps(index))
    return index


def pack_files(file_names: Sequence[Path], prediction_task: str, out_dir,
               add_depth_inputs: bool = False,
               extra: Optional[dict] = None) -> dict:
    """Pack image files (+ masks composed from pose maps, + depth) with the
    live path's loaders (``data/masks.py``; needs OpenCV)."""
    from mfcnet_tpu_torch.data.masks import (
        load_depthmap,
        load_image,
        load_mask,
    )

    file_names = [Path(f) for f in file_names]
    if not file_names:
        raise ValueError("pack_files: empty file list")
    parents: dict = {}
    video_ids = [parents.setdefault(f.parent, len(parents))
                 for f in file_names]
    return write_pack(
        out_dir, (load_image(f) for f in file_names),
        (load_mask(f, prediction_task) for f in file_names), video_ids,
        prediction_task,
        depth=((load_depthmap(f) for f in file_names)
               if add_depth_inputs else None),
        names=[f.name for f in file_names], extra=extra)


class PackedMultiFrameDataset:
    """The samples of ``MultiFrameDataset`` read from a pack directory.
    ``expect``: {index key: required value}; a pack built for another
    task, dataset or fold raises."""

    def __init__(self, pack_dir, num_input_frames: int,
                 add_depth_inputs: bool = False,
                 expect: Optional[dict] = None):
        pack_dir = Path(pack_dir)
        index = json.loads((pack_dir / "index.json").read_text())
        if index.get("format") != FORMAT:
            raise ValueError(f"{pack_dir}: not a packed dataset "
                             f"(format {index.get('format')!r})")
        if add_depth_inputs and not index["has_depth"]:
            raise ValueError(f"{pack_dir}: packed without depth "
                             "(re-pack with --add_depth_inputs)")
        for key, want in (expect or {}).items():
            if key in index and index[key] != want:
                raise ValueError(
                    f"{pack_dir}: packed with {key}={index[key]!r} but this "
                    f"run needs {want!r} -- re-pack or fix the flags")
        self.index = index
        N, H, W = index["n"], index["height"], index["width"]
        self.N, self.T = N, num_input_frames
        self.video_ids = [int(v) for v in index["video_ids"]]
        self.frames = np.memmap(pack_dir / "frames.u8", np.uint8, "r",
                                shape=(N, H, W, 3))
        self.masks = np.memmap(pack_dir / "masks.u8", np.uint8, "r",
                               shape=(N, H, W))
        self.depth = (np.memmap(pack_dir / "depth.u8", np.uint8, "r",
                                shape=(N, H, W))
                      if add_depth_inputs else None)

    def __len__(self):
        return self.N

    def window_indices(self, idx: int):
        return window_indices(idx, self.T, self.video_ids)

    def __getitem__(self, idx: int):
        idxs = self.window_indices(idx)
        sample = {"frames": np.asarray(self.frames[idxs]),
                  "mask": np.asarray(self.masks[idx])}
        if self.depth is not None:
            sample["depth"] = np.asarray(self.depth[idxs])
        return sample


def pack_dataset_splits(dataset_name: str, data_dir, mode: str,
                        prediction_task: str, out_dir, fold_index: int = -1,
                        add_depth_inputs: bool = False) -> dict:
    """Pack a dataset the way ``get_data_loader`` reads it: training mode
    writes ``train/`` + ``val/``, testing mode ``test/``. Returns
    {split: index}."""
    from mfcnet_tpu_torch.data.files import get_dataset_filenames

    train_files, val_files = get_dataset_filenames(dataset_name, data_dir,
                                                   mode, fold_index)
    out_dir = Path(out_dir)
    extra = {"dataset": dataset_name, "mode": mode, "fold_index": fold_index}
    if mode == "training":
        return {split: pack_files(files, prediction_task, out_dir / split,
                                  add_depth_inputs, extra=extra)
                for split, files in (("train", train_files),
                                     ("val", val_files))}
    return {"test": pack_files(train_files, prediction_task, out_dir / "test",
                               add_depth_inputs, extra=extra)}
