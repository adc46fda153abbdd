"""Host-side datasets over the image tree (counterpart of
``mfcnet_tpu/data/dataset.py``): index -> raw sample dict.

:class:`MultiFrameDataset`: sample ``idx`` holds frames [idx, idx-1, ...,
idx-(T-1)] (newest first) wrapping mod N; where a candidate lies in
another video directory the last in-video frame is reused (reference
src/dataset_jigsaws.py:20-40). :class:`SingleFrameDataset`: one frame and
its mask, and for TAPNet the attention map. Augmentation runs later, on
the batch (``data/transforms.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from mfcnet_tpu_torch.data.masks import (
    load_attmap,
    load_depthmap,
    load_image,
    load_mask,
    load_optflow_map,
)


def window_indices(idx: int, T: int, video_of) -> List[int]:
    """Frame indices [newest, ..., oldest] of sample ``idx`` with the
    reference's video-boundary clamp; ``video_of(j)`` names frame j's
    video. The wrap ``(idx - i) % N`` clamps only because the wrapped
    index lands in another video, so in a one-video dataset sample 0's
    window wraps to the video's last frames -- the reference's quirk,
    kept."""
    n = len(video_of)
    out, last_valid, vid = [], -1, video_of[idx]
    for i in range(T):
        j = (idx - i) % n
        if video_of[j] != vid:
            j = last_valid % n
        else:
            last_valid = j
        out.append(j)
    return out


class MultiFrameDataset:
    """T-frame windows + current-frame mask (+ optional depth), decoded
    from files (OpenCV)."""

    def __init__(self, file_names: Sequence[Path], prediction_task: str,
                 num_input_frames: int, add_depth_inputs: bool = False):
        self.file_names = [Path(f) for f in file_names]
        self.prediction_task = prediction_task
        self.T = num_input_frames
        self.add_depth_inputs = add_depth_inputs
        self.parents = [f.parent for f in self.file_names]

    def __len__(self):
        return len(self.file_names)

    def window_indices(self, idx: int) -> List[int]:
        return window_indices(idx, self.T, self.parents)

    def __getitem__(self, idx: int):
        idxs = self.window_indices(idx)
        sample = {
            "frames": np.stack([load_image(self.file_names[j])
                                for j in idxs]),
            "mask": load_mask(self.file_names[idx], self.prediction_task),
        }
        if self.add_depth_inputs:
            sample["depth"] = np.stack([load_depthmap(self.file_names[j])
                                        for j in idxs])
        return sample


class SingleFrameDataset:
    """A frame (uint8 (H, W, 3)) and its mask (reference
    src/dataloader.py:78-96). ``with_attmap`` adds TAPNet's ``attmap``
    (float32 (h, w)): the previous frame's map (``load_attmap``; zeros at
    a video's first frame), and with ``optflow_dir`` that map carried
    along the frame's precomputed flow and dilated (``data/attmap.py::
    cal_attmap_np``; reference src/dataloader.py:20-76)."""

    def __init__(self, file_names: Sequence[Path], prediction_task: str,
                 with_attmap: bool = False, frames_per_video: int = 225,
                 optflow_dir: Optional[str] = None,
                 attmap_shape=(480, 640)):
        self.file_names = [Path(f) for f in file_names]
        self.prediction_task = prediction_task
        self.with_attmap = with_attmap
        self.frames_per_video = frames_per_video
        self.optflow_dir = optflow_dir
        self.attmap_shape = attmap_shape

    def __len__(self):
        return len(self.file_names)

    def __getitem__(self, idx: int):
        sample = {"image": load_image(self.file_names[idx]),
                  "mask": load_mask(self.file_names[idx],
                                    self.prediction_task)}
        if self.with_attmap:
            att = load_attmap(self.file_names, idx, self.frames_per_video,
                              shape=self.attmap_shape)
            if self.optflow_dir and idx % self.frames_per_video != 0:
                from mfcnet_tpu_torch.data.attmap import cal_attmap_np

                att = cal_attmap_np(att, load_optflow_map(
                    self.file_names[idx], self.optflow_dir,
                    shape=att.shape))
            sample["attmap"] = att
        return sample
