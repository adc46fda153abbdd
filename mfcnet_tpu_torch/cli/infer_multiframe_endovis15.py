"""Multi-frame test-set evaluation (counterpart of
``mfcnet_tpu/cli/infer_multiframe_endovis15.py``; reference
scripts/infer_multiframe_endovis15.py, the reference's multi-frame infer
entry whatever the task): IoU/Dice, per-keypoint centroid errors
(NaN-filtered mean and std), presence precision/recall/accuracy and
overlay PNGs, written to ``{expt_savedir}/{expt_name}/outputs/
results.json``.

    python -m mfcnet_tpu_torch.cli.infer_multiframe_endovis15 \\
        --dataset JIGSAWS --packed_dir PACKS --model_type \\
        TernausNetMulti-Basic --load_wts_model model.pth \\
        --add_optflow_inputs True --load_wts_flow_model raft.pth

Reads the test split of the image tree, or a pack's ``test/``
(``--packed_dir``), one T-frame window a batch. Weights as in
``infer_toolpose_segmentation``. ``--add_optflow_inputs True`` puts the
frozen flow provider (``--optflow_model`` RAFT, UnFlow or
FlowFormerPlusPlus; ``--load_wts_flow_model`` its weights, else seeded
random ones) inside the eval step, as the multi-frame trainer does
(``cli/train_multiframe_detection.py::build_flow_fn``). The evaluation
runs in float32 whatever ``--compute_dtype`` says, as the JAX CLI's does:
RAFT then runs its plain update block and the Basic head warps through
``flow_warp``. The eval step runs on the card (``--device cpu`` asks for
the CPU); the centroid errors and overlays need OpenCV.
"""

from __future__ import annotations

import json
import types

import numpy as np

from mfcnet_tpu_torch.cli.infer_toolpose_segmentation import load_eval_model
from mfcnet_tpu_torch.cli.train_multiframe_detection import (
    build_flow_fn,
    resolve_device,
)
from mfcnet_tpu_torch.configs.parsers import (
    check_ported,
    multiframe_test_parser,
)
from mfcnet_tpu_torch.data.loader import get_data_loader
from mfcnet_tpu_torch.data.transforms import (
    TransformConfig,
    preprocess_eval_batch,
)
from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
from mfcnet_tpu_torch.track.infer_eval import evaluate_testset
from mfcnet_tpu_torch.train.steps import make_multiframe_eval_step
from mfcnet_tpu_torch.utils.logging import init_logging


def main(argv=None):
    args = multiframe_test_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    writer, logger, expt_dir = init_logging(args.expt_savedir,
                                            args.expt_name)
    logger.info(f"args: {vars(args)}")
    np.random.seed(args.seed)
    T, H, W = args.num_input_frames, args.input_height, args.input_width

    _, test_loader = get_data_loader(
        args.dataset, args.data_dir, "testing", args.prediction_task, T, 1,
        num_workers=args.num_workers, add_depth_inputs=args.add_depth_inputs,
        packed_dir=args.packed_dir)
    model = get_multiframe_segmentation_model(
        args.model_type, num_classes=args.num_classes, num_input_frames=T,
        add_optflow_inputs=args.add_optflow_inputs,
        add_depth_inputs=args.add_depth_inputs, scale=args.model_scale)
    model.multiframe_net.parity_grid = args.parity_grid
    model = load_eval_model(model, args, logger).to(device)

    flow_fn = None
    if args.add_optflow_inputs:
        flow_fn = build_flow_fn(args.optflow_model, (H, W),
                                args.load_wts_flow_model, device=device,
                                basic="Basic" in args.model_type)
        if not args.load_wts_flow_model:
            logger.warning("--add_optflow_inputs without "
                           "--load_wts_flow_model: the frozen flow provider "
                           "has RANDOM weights")
    eval_step = make_multiframe_eval_step(
        ["nll"], [1.0], args.metric_fns, args.num_classes, flow_fn=flow_fn)
    tcfg = TransformConfig(out_height=H, out_width=W,
                           prediction_task=args.prediction_task)

    try:
        results = evaluate_testset(
            test_loader, types.SimpleNamespace(model=model), eval_step,
            lambda b: preprocess_eval_batch(b, tcfg, device),
            args.num_classes, logger, out_dir=expt_dir / "outputs",
            save_output_freq=args.save_output_freq)
        (expt_dir / "outputs" / "results.json").write_text(
            json.dumps(results, indent=2))
    finally:
        writer.close()
    return results


if __name__ == "__main__":
    main()
