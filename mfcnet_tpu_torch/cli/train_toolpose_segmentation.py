"""Train a single-frame model (counterpart of
``mfcnet_tpu/cli/train_toolpose_segmentation.py``; reference
scripts/train_toolpose_segmentation.py): TernausNet16, DeepLab_v3, FCN,
HRNet or SegFormer, the first stage of the reference's recipe: its
checkpoint's ``model`` is what the multi-frame trainer's
``--load_wts_base_model`` loads into the Multi family of that base.

    python -m mfcnet_tpu_torch.cli.train_toolpose_segmentation \
        --dataset JIGSAWS --packed_dir PACKS ...

Samples are the multi-frame datasets' with one frame (a pack or the image
tree), through the same augmentation; plain Adam at ``--lr``, the same
schedule, accumulation, EMA, checkpoints and interrupt snapshot as the
multi-frame trainer. The step reads TernausNet16's and SegFormer's
output as log-probabilities and the others' as logits (``models.
OUTPUT_MODES``); FCN's dropout and SegFormer's drop-path draw from the
train state's generator. TernausNet11, TAPNet, UNet and ResUNet raise and
name ROADMAP item 10b.
"""

from __future__ import annotations

import numpy as np
import torch

from mfcnet_tpu_torch.cli.train_multiframe_detection import resolve_device
from mfcnet_tpu_torch.configs.parsers import (
    check_ported,
    toolposeseg_train_parser,
)
from mfcnet_tpu_torch.data.loader import get_data_loader
from mfcnet_tpu_torch.data.transforms import (
    TransformConfig,
    augment_train_batch,
    preprocess_eval_batch,
)
from mfcnet_tpu_torch.models import (
    OUTPUT_MODES,
    get_tooltip_segmentation_model,
    init_weights_lecun,
)
from mfcnet_tpu_torch.train.engine import fit, resume
from mfcnet_tpu_torch.train.schedule import make_schedule
from mfcnet_tpu_torch.train.state import TrainState
from mfcnet_tpu_torch.train.steps import (
    make_singleframe_eval_step,
    make_singleframe_train_step,
)
from mfcnet_tpu_torch.utils.logging import init_logging


def _single(out):
    """A one-frame multi-frame batch -> {'image' (B, H, W, 3), 'mask'}."""
    return {"image": out["frames"][:, 0], "mask": out["mask"]}


def main(argv=None):
    args = toolposeseg_train_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    writer, logger, expt_dir = init_logging(args.expt_savedir,
                                            args.expt_name, args.debug)
    logger.info(f"args: {vars(args)}")
    np.random.seed(args.seed)
    train_loader, val_loader = get_data_loader(
        args.dataset, args.data_dir, args.mode, args.prediction_task, 1,
        args.batch_size, num_workers=args.num_workers,
        fold_index=args.fold_index, seed=args.seed,
        packed_dir=args.packed_dir)
    try:
        model = get_tooltip_segmentation_model(
            args.model_type, args.num_classes, scale=args.model_scale)
    except NotImplementedError as e:
        raise SystemExit(str(e))
    init_weights_lecun(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    accum = max(1, args.grad_accum)
    sched = make_schedule(args.scheduler, args.lr, args.num_epochs,
                          max(1, len(train_loader) // accum))
    state = TrainState(model, sched, grad_accum=accum,
                       ema_decay=args.ema_decay, split_base=False)
    start_epoch, resume_skip = args.starting_epoch, 0
    if args.resume:
        start_epoch, resume_skip = resume(state, expt_dir / "ckpts",
                                          args.load_wts_model,
                                          args.starting_epoch, logger)
    mode = OUTPUT_MODES[args.model_type]
    train_step = make_singleframe_train_step(
        args.loss_fns, args.loss_wts, args.num_classes,
        class_weights=args.class_weights, compute_dtype=args.compute_dtype,
        output_mode=mode)
    eval_step = make_singleframe_eval_step(
        args.loss_fns, args.loss_wts, args.metric_fns, args.num_classes,
        class_weights=args.class_weights, compute_dtype=args.compute_dtype,
        output_mode=mode)
    tcfg = TransformConfig(out_height=args.input_height,
                           out_width=args.input_width,
                           prediction_task=args.prediction_task)

    def aug(batch, gen):
        return _single(augment_train_batch(batch, gen, tcfg, device))

    def prep(batch):
        return _single(preprocess_eval_batch(batch, tcfg, device))

    try:
        fit(args, state, (train_loader, val_loader), (train_step, eval_step),
            (aug, prep), logger, writer, expt_dir / "ckpts", start_epoch,
            resume_skip)
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    main()
