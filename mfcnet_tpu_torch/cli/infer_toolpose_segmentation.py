"""Single-frame test-set evaluation (counterpart of
``mfcnet_tpu/cli/infer_toolpose_segmentation.py``; reference
scripts/infer_toolpose_segmentation.py): IoU/Dice, centroid errors,
detection-presence statistics and overlay PNGs, written to
``{expt_savedir}/{expt_name}/outputs/results.json``. Also serves the
endovis15 single-frame variant (``infer_endovis15_segmentation``) via
``--prediction_task endovis15_segmentation --num_classes 11``.

    python -m mfcnet_tpu_torch.cli.infer_toolpose_segmentation \\
        --dataset JIGSAWS --data_dir DATA --model_type TernausNet16 \\
        --load_wts_model model.pth

Reads the test split of the image tree (``data/dataset.py::
SingleFrameDataset``, with TAPNet's attention maps for TAPNet), one
sample a batch. Without ``--load_wts_model`` the model keeps weights
drawn from ``--seed`` (``models.init_weights_lecun``); with it, a
reference ``.pth`` or a checkpoint of the port's trainer
(``--use_ema True``: its EMA weights). The evaluation runs in float32
whatever ``--compute_dtype`` says, as the JAX CLI's does. The eval step
runs on the card (``--device cpu`` asks for the CPU); the centroid
errors and overlays are host code that needs OpenCV.
"""

from __future__ import annotations

import json
import types

import numpy as np
import torch

from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
    load_reference_state_dict,
)
from mfcnet_tpu_torch.cli.train_multiframe_detection import resolve_device
from mfcnet_tpu_torch.cli.train_toolpose_segmentation import _frames, _single
from mfcnet_tpu_torch.configs.parsers import (
    check_ported,
    toolposeseg_test_parser,
)
from mfcnet_tpu_torch.data.dataset import SingleFrameDataset
from mfcnet_tpu_torch.data.files import get_dataset_filenames
from mfcnet_tpu_torch.data.loader import DataLoader
from mfcnet_tpu_torch.data.transforms import (
    TransformConfig,
    preprocess_eval_batch,
)
from mfcnet_tpu_torch.models import (
    OUTPUT_MODES,
    get_tooltip_segmentation_model,
    init_weights_lecun,
)
from mfcnet_tpu_torch.track.infer_eval import evaluate_testset
from mfcnet_tpu_torch.train.steps import make_singleframe_eval_step
from mfcnet_tpu_torch.utils.logging import init_logging


def load_eval_model(model, args, logger):
    """``model`` with weights drawn from ``args.seed``, or loaded from
    ``args.load_wts_model`` (its EMA weights with ``args.use_ema``)."""
    init_weights_lecun(model, torch.Generator().manual_seed(args.seed))
    if args.load_wts_model:
        model.load_state_dict(load_reference_state_dict(args.load_wts_model,
                                                        args.use_ema))
        logger.info(f"Loaded model weights from {args.load_wts_model}"
                    + (" (EMA)" if args.use_ema else ""))
    return model


def main(argv=None):
    args = toolposeseg_test_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    writer, logger, expt_dir = init_logging(args.expt_savedir,
                                            args.expt_name)
    logger.info(f"args: {vars(args)}")
    np.random.seed(args.seed)
    H, W = args.input_height, args.input_width

    test_files, _ = get_dataset_filenames(args.dataset, args.data_dir,
                                          "testing")
    output_mode = OUTPUT_MODES[args.model_type]
    test_ds = SingleFrameDataset(
        test_files, args.prediction_task,
        with_attmap=(output_mode == "tapnet"),
        frames_per_video=args.num_frames_per_video, attmap_shape=(H, W))
    test_loader = DataLoader(test_ds, 1, num_workers=args.num_workers)

    model = get_tooltip_segmentation_model(args.model_type, args.num_classes,
                                           scale=args.model_scale)
    model = load_eval_model(model, args, logger).to(device)
    eval_step = make_singleframe_eval_step(
        ["nll"], [1.0], args.metric_fns, args.num_classes,
        output_mode=output_mode)
    tcfg = TransformConfig(out_height=H, out_width=W,
                           prediction_task=args.prediction_task)

    def prep(batch):
        return _single(preprocess_eval_batch(_frames(batch), tcfg, device),
                       batch.get("attmap"))

    try:
        results = evaluate_testset(
            test_loader, types.SimpleNamespace(model=model), eval_step, prep,
            args.num_classes, logger, out_dir=expt_dir / "outputs",
            save_output_freq=args.save_output_freq)
        (expt_dir / "outputs" / "results.json").write_text(
            json.dumps(results, indent=2))
    finally:
        writer.close()
    return results


if __name__ == "__main__":
    main()
