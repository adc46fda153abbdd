"""Dataset filename globbing (counterpart of ``mfcnet_tpu/data/files.py``;
reference utils/dataloader_utils.py:87-158): the port's own copy, standard
library only.

Same directory contracts and fold tables as the reference, so existing
dataset layouts work unchanged. natsort is replaced by a numeric-aware key.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Tuple


def _natkey(p) -> tuple:
    """Natural sort key equivalent to natsorted(..., key=str)."""
    s = str(p)
    return tuple(
        int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", s)
    )


def _glob_sorted(d: Path) -> List[Path]:
    return sorted(d.glob("*"), key=_natkey)


def get_MICCAI2015_dataset_filenames(
    data_dir: Path, mode: str
) -> Tuple[List[Path], Optional[List[Path]]]:
    """reference: utils/dataloader_utils.py:87-105."""
    data_dir = Path(data_dir)
    if mode == "training":
        train_path = data_dir / "Tracking_Robotic_Training" / "Training"
        train, val = [], []
        for i in range(1, 5):
            train += _glob_sorted(train_path / f"Dataset{i}" / "images")
        val_path = data_dir / "Tracking_Robotic_Testing" / "Tracking"
        for i in range(1, 5):
            val += _glob_sorted(val_path / f"Dataset{i}" / "images")
        return train, val
    if mode == "testing":
        test_path = data_dir / "Tracking_Robotic_Testing" / "Tracking"
        test = []
        for i in range(1, 7):
            test += _glob_sorted(test_path / f"Dataset{i}" / "images")
        return test, None
    raise ValueError(mode)


def get_MICCAI2017_dataset_filenames(
    data_dir: Path, mode: str, fold_index: int = -1
) -> Tuple[List[Path], Optional[List[Path]]]:
    """reference: utils/dataloader_utils.py:107-125 (folds at :109)."""
    data_dir = Path(data_dir)
    if mode == "training":
        folds = {-1: [], 0: [1, 3], 1: [2, 5], 2: [4, 8], 3: [6, 7]}
        train_path = data_dir / "cropped_train"
        train, val = [], []
        for iid in range(1, 9):
            files = _glob_sorted(
                train_path / f"instrument_dataset_{iid}" / "images"
            )
            if iid in folds[fold_index]:
                val += files
            else:
                train += files
        return train, val
    if mode == "testing":
        test_path = data_dir / "cropped_test"
        test = []
        for iid in range(1, 11):
            test += _glob_sorted(
                test_path / f"instrument_dataset_{iid}" / "images"
            )
        return test, None
    raise ValueError(mode)


def get_JIGSAWS_dataset_filenames(
    data_dir: Path, mode: str
) -> Tuple[List[Path], Optional[List[Path]]]:
    """reference: utils/dataloader_utils.py:127-158."""
    data_dir = Path(data_dir)
    if mode == "training":
        train, val = [], []
        for i in range(1, 7):
            train += _glob_sorted(
                data_dir / "annotations_train" / f"video_{i}" / "images"
            )
            val += _glob_sorted(
                data_dir / "annotations_val" / f"video_{i}" / "images"
            )
        return train, val
    if mode == "testing":
        test = []
        for i in range(1, 7):
            test += _glob_sorted(
                data_dir / "annotations_val" / f"video_{i}" / "images"
            )
        return test, None
    raise ValueError(mode)


def get_dataset_filenames(
    dataset: str, data_dir: Path, mode: str, fold_index: int = -1
):
    if dataset == "MICCAI2015":
        return get_MICCAI2015_dataset_filenames(data_dir, mode)
    if dataset == "MICCAI2017":
        return get_MICCAI2017_dataset_filenames(data_dir, mode, fold_index)
    if dataset == "JIGSAWS":
        return get_JIGSAWS_dataset_filenames(data_dir, mode)
    raise NotImplementedError(dataset)
