"""Host-side multi-frame dataset over the image tree (counterpart of
``mfcnet_tpu/data/dataset.py``): index -> raw uint8 sample dict.

Sample ``idx`` holds frames [idx, idx-1, ..., idx-(T-1)] (newest first)
wrapping mod N; where a candidate lies in another video directory the
last in-video frame is reused (reference src/dataset_jigsaws.py:20-40).
Augmentation runs later, on the batch (``data/transforms.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

from mfcnet_tpu_torch.data.masks import load_depthmap, load_image, load_mask


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
