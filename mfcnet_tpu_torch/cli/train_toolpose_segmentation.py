"""Train a single-frame model (counterpart of
``mfcnet_tpu/cli/train_toolpose_segmentation.py``; reference
scripts/train_toolpose_segmentation.py): TernausNet11/16, DeepLab_v3, FCN,
HRNet, SegFormer, UNet, ResUNet, TAPNet11 or TAPNet16, the first stage of
the reference's recipe: its checkpoint's ``model`` is what the multi-frame
trainer's ``--load_wts_base_model`` loads into the Multi family of that
base.

    python -m mfcnet_tpu_torch.cli.train_toolpose_segmentation \
        --dataset JIGSAWS --packed_dir PACKS ...

Samples are the multi-frame datasets' with one frame (a pack or the image
tree), through the same augmentation; plain Adam at ``--lr``, the same
schedule, accumulation, EMA, checkpoints and interrupt snapshot as the
multi-frame trainer. The step reads TernausNet's and SegFormer's output as
log-probabilities and the others' as logits (``models.OUTPUT_MODES``);
FCN's dropout and SegFormer's drop-path draw from the train state's
generator.

TAPNet reads the image tree only (``data/dataset.py::SingleFrameDataset``
with its attention maps; packs hold none, and ``--packed_dir`` exits). As
in the JAX CLI, the attention map is resized bilinearly to the augmented
image's size and appended as a fourth channel without the geometric
augmentation, and after each epoch's validation ``attmaps/`` is rewritten
with the model's foreground probability, 1 - p(background), as uint8 PNGs
(``save_attention_maps``). A video's first frame reads zeros of the input
size; every other frame needs the previous frame's map on disk.
"""

from __future__ import annotations

from pathlib import Path

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
from mfcnet_tpu_torch.ops.resize import resize_bilinear
from mfcnet_tpu_torch.train.engine import fit, resume
from mfcnet_tpu_torch.train.schedule import make_schedule
from mfcnet_tpu_torch.train.state import TrainState
from mfcnet_tpu_torch.train.steps import (
    make_singleframe_eval_step,
    make_singleframe_train_step,
)
from mfcnet_tpu_torch.utils.logging import init_logging


def _single(out, attmap=None):
    """A one-frame multi-frame batch -> {'image' (B, H, W, 3), 'mask'};
    with TAPNet's ``attmap`` (B, h, w) the image gets it as a fourth
    channel, resized bilinearly to the image's size and not augmented
    (mfcnet_tpu/cli/train_toolpose_segmentation.py:58-75)."""
    img = out["frames"][:, 0]
    if attmap is not None:
        att = torch.as_tensor(np.asarray(attmap, np.float32)).to(img.device)
        att = resize_bilinear(att[:, None], img.shape[1], img.shape[2])
        img = torch.cat([img, att.permute(0, 2, 3, 1)], dim=-1)
    return {"image": img, "mask": out["mask"]}


def _frames(batch):
    """A single-frame batch as the transforms' one-frame batch."""
    return {"frames": np.asarray(batch["image"])[:, None],
            "mask": batch["mask"]}


def tapnet_loaders(args):
    """TAPNet's (train dataset, train loader, val loader) over the image
    tree, with attention maps of the input size at each video's first
    frame."""
    from mfcnet_tpu_torch.data.dataset import SingleFrameDataset
    from mfcnet_tpu_torch.data.files import get_dataset_filenames
    from mfcnet_tpu_torch.data.loader import DataLoader

    train_files, val_files = get_dataset_filenames(
        args.dataset, args.data_dir, args.mode, args.fold_index)

    def dataset(files):
        return SingleFrameDataset(
            files, args.prediction_task, with_attmap=True,
            frames_per_video=args.num_frames_per_video,
            attmap_shape=(args.input_height, args.input_width))

    train_ds = dataset(train_files)
    return (train_ds,
            DataLoader(train_ds, args.batch_size, shuffle=True,
                       num_workers=args.num_workers, seed=args.seed),
            DataLoader(dataset(val_files), 1, num_workers=args.num_workers))


@torch.no_grad()
def save_attention_maps(dataset, model, tcfg, device, logger):
    """Rewrite each training frame's ``attmaps/`` PNG with the model's
    foreground probability 1 - exp(log p(background)), eval mode, float32,
    as uint8 (reference scripts/train_toolpose_segmentation.py:47-77: the
    train loop rewrites the dataset on disk each epoch)."""
    import cv2

    model = model.eval()
    for idx in range(len(dataset)):
        sample = dataset[idx]
        batch = _single(preprocess_eval_batch(
            _frames({k: v[None] for k, v in sample.items()}), tcfg, device),
            sample["attmap"][None])
        x = batch["image"].permute(0, 3, 1, 2)
        fg = 1.0 - torch.exp(model(x[:, :3], x[:, 3:])[0, 0].float())
        path = Path(str(dataset.file_names[idx]).replace(
            "images", "attmaps").replace("jpg", "png"))
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), (fg.cpu().numpy() * 255).astype(np.uint8))
    logger.info(f"Re-wrote {len(dataset)} attention maps")


def main(argv=None):
    args = toolposeseg_train_parser().parse_args(argv)
    check_ported(args)
    mode = OUTPUT_MODES[args.model_type]
    if mode == "tapnet" and args.packed_dir is not None:
        raise SystemExit(f"--packed_dir with {args.model_type}: packs hold "
                         "no attention maps; TAPNet reads the image tree "
                         "(--data_dir), as the JAX CLI does")
    device = resolve_device(args.device)
    writer, logger, expt_dir = init_logging(args.expt_savedir,
                                            args.expt_name, args.debug)
    logger.info(f"args: {vars(args)}")
    np.random.seed(args.seed)
    if mode == "tapnet":
        train_ds, train_loader, val_loader = tapnet_loaders(args)
    else:
        train_loader, val_loader = get_data_loader(
            args.dataset, args.data_dir, args.mode, args.prediction_task, 1,
            args.batch_size, num_workers=args.num_workers,
            fold_index=args.fold_index, seed=args.seed,
            packed_dir=args.packed_dir)
    model = get_tooltip_segmentation_model(
        args.model_type, args.num_classes, scale=args.model_scale)
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

    def split(batch):
        """(the transforms' one-frame batch, TAPNet's attention maps)"""
        if mode != "tapnet":
            return batch, None
        return _frames(batch), batch["attmap"]

    def aug(batch, gen):
        frames, att = split(batch)
        return _single(augment_train_batch(frames, gen, tcfg, device), att)

    def prep(batch):
        frames, att = split(batch)
        return _single(preprocess_eval_batch(frames, tcfg, device), att)

    epoch_end = None
    if mode == "tapnet":
        def epoch_end(epoch):
            save_attention_maps(train_ds, model, tcfg, device, logger)

    try:
        fit(args, state, (train_loader, val_loader), (train_step, eval_step),
            (aug, prep), logger, writer, expt_dir / "ckpts", start_epoch,
            resume_skip, epoch_end=epoch_end)
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    main()
