"""Pack an image-tree dataset into zero-decode memmap shards (counterpart of
``tools/pack_dataset.py``, with its flags and output):

    python -m mfcnet_tpu_torch.cli.pack_dataset --dataset JIGSAWS \\
        --data_dir /data/jigsaws --mode training \\
        --prediction_task toolpose_segmentation --out /data/jigsaws_packed

then train with ``--packed_dir /data/jigsaws_packed``. Training mode
writes ``train/`` and ``val/``, testing mode ``test/``, in the
``mfcnet_tpu.packed/1`` format (``data/packed.py``): the shards are the JAX
tool's, byte for byte, and load in either package. Reading the tree needs
OpenCV, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import sys
import time

from mfcnet_tpu_torch.configs.parsers import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Pack a dataset into memmap shards (zero-decode reads)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--dataset", type=str, default="JIGSAWS",
                   choices=["MICCAI2015", "MICCAI2017", "JIGSAWS"])
    p.add_argument("--mode", type=str, default="training",
                   choices=["training", "testing"])
    p.add_argument("--prediction_task", type=str,
                   default="toolpose_segmentation")
    p.add_argument("--fold_index", type=int, default=-1)
    p.add_argument("--add_depth_inputs", type=str2bool, default=False)
    p.add_argument("--out", type=str, required=True)
    return p


def main(argv=None) -> int:
    from mfcnet_tpu_torch.data.packed import pack_dataset_splits

    args = build_parser().parse_args(argv)
    t0 = time.time()
    out = pack_dataset_splits(
        args.dataset, args.data_dir, args.mode, args.prediction_task,
        args.out, fold_index=args.fold_index,
        add_depth_inputs=args.add_depth_inputs)
    for split, index in out.items():
        print(f"{split}: {index['n']} frames "
              f"{index['height']}x{index['width']}"
              f"{' +depth' if index['has_depth'] else ''} -> "
              f"{args.out}/{split}")
    print(f"packed in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
