"""Single-frame EndoVis15 evaluation (counterpart of
``mfcnet_tpu/cli/infer_endovis15_segmentation.py``; reference
scripts/infer_endovis15_segmentation.py): ``infer_toolpose_segmentation``
with ``--prediction_task endovis15_segmentation --num_classes 11`` put
first (flags given later win)."""

from __future__ import annotations

import sys

from mfcnet_tpu_torch.cli.infer_toolpose_segmentation import main as _main

DEFAULTS = ["--prediction_task", "endovis15_segmentation",
            "--num_classes", "11"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return _main(DEFAULTS + argv)


if __name__ == "__main__":
    main()
