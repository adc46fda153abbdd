"""Train a multi-frame model (counterpart of
``mfcnet_tpu/cli/train_multiframe_detection.py``; reference
scripts/train_multiframe_detection.py).

    python -m mfcnet_tpu_torch.cli.train_multiframe_detection \
        --dataset JIGSAWS --packed_dir PACKS --add_optflow_inputs True ...

``{TernausNet,DeepLab,FCN,HRNet,SegFormer,UNet,ResUNet}Multi-{Basic,
Large}`` (weights
drawn from ``--seed`` as the JAX trainer draws them,
``models.init_weights_lecun``; ``--load_wts_base_model`` loads the
family's base from a single-frame checkpoint by name), with the frozen flow
provider (RAFT, FlowFormer++ or UnFlow: ``--optflow_model``) inside the
step and depth inputs as the flags
say: Basic warps the earlier maps by flow(frame_i -> frame_0), Large
takes flow(frame_0 -> frame_i) raw into its head; the base frozen (the
default, in eval mode: running statistics, no dropout) or trained
(``--train_base_model True``); float32 or bfloat16
(``--compute_dtype``, by cast, see ``train/steps.py``); gradient
accumulation and EMA. Reads packs (``--packed_dir``: no OpenCV, the way
to train on the card) or the image tree, validates with IoU/Dice after
every epoch and writes ``ckpts/model_{epoch:03d}.pth`` every
``--save_freq`` epochs and at the last; an interrupt writes the snapshot
``model_999.pth`` that ``--resume True`` continues from at the batch it
stopped. Runs on the card; ``--device cpu`` asks for the CPU. Flags that
the port leaves out raise and name their ROADMAP item.

Data-parallel training runs one process per card under ``torchrun``::

    torchrun --nproc_per_node N -m \
        mfcnet_tpu_torch.cli.train_multiframe_detection --multihost true \
        --batch_size B ...

``--batch_size`` is then per process and the global batch is B x N (the
JAX CLI's ``--multihost``). Each rank reads its strided share of the
training samples (``data/loader.py``, ``shard``), augments its rows of the
global batch, and trains through ``DistributedDataParallel`` with the
global batch's batch-norm statistics and losses (``parallel/dist.py``);
rank 0 writes the checkpoints, every rank logs to its own files.
``--device cuda`` means ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import numpy as np
import torch

from mfcnet_tpu_torch.configs.parsers import (
    check_ported,
    multiframe_train_parser,
)
from mfcnet_tpu_torch.data.loader import get_data_loader
from mfcnet_tpu_torch.data.transforms import (
    TransformConfig,
    augment_train_batch,
    preprocess_eval_batch,
)
from mfcnet_tpu_torch.models import (
    get_multiframe_segmentation_model,
    init_weights_lecun,
)
from mfcnet_tpu_torch.parallel.dist import init_distributed, local_device
from mfcnet_tpu_torch.train.engine import fit, resume
from mfcnet_tpu_torch.train.schedule import make_schedule
from mfcnet_tpu_torch.train.state import TrainState
from mfcnet_tpu_torch.train.steps import (
    make_multiframe_eval_step,
    make_multiframe_train_step,
    resolve_dtype,
)
from mfcnet_tpu_torch.utils.checkpoint import load_state_dict_file
from mfcnet_tpu_torch.utils.logging import init_logging


def resolve_device(name: str) -> torch.device:
    dev = local_device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return dev


def build_flow_fn(optflow_model: str, input_hw, weights_path=None,
                  compute_dtype=None, device="cuda", seed: int = 1,
                  basic: bool = True):
    """The frozen provider of the train step: frames (B, T, H, W, 3)
    -> (B, T-1, H, W, 2) float32 flow at the input resolution
    (``track/outputs.py::flow_for_training``; ``basic`` False gives the
    Large variant's direction), under ``no_grad`` in the step. The
    provider runs in the step's compute dtype: a bfloat16 RAFT runs its
    update iterations through the fused update kernel, a bfloat16
    FlowFormer++ keeps float32 where the JAX package's does. FlowFormer++
    sees its frames scaled by 0.225/0.5 (``models/flowformerpp.py::
    make_ffpp_flow_fn``, the reference's input-range hack). Without
    ``weights_path`` the weights are random from ``seed``; with it, the
    reference checkpoint (torchvision ``raft_large``, UnFlow's, or
    FlowFormer++'s ``ffpp_things.pth``) loads by name."""
    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.track.outputs import flow_for_training

    gen = torch.Generator().manual_seed(seed)
    dt = resolve_dtype(compute_dtype) or torch.float32
    if optflow_model == "FlowFormerPlusPlus":
        from mfcnet_tpu_torch.models import flowformerpp as ffpp

        model = ffpp.init_ffpp_weights(ffpp.FlowFormerPP(iters=12), gen)
        if weights_path:
            ffpp.load_reference_state_dict(
                model, load_state_dict_file(weights_path))
        model = model.to(device, dt).eval().requires_grad_(False)
        return ffpp.make_ffpp_flow_fn(model, basic=basic)
    if optflow_model == "RAFT":
        from mfcnet_tpu_torch.models.raft import RAFT

        model = init_weights(RAFT(iters=12, input_hw=tuple(input_hw)), gen)
    elif optflow_model == "UnFlow":
        from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights

        model = he_init_weights(UnFlow(), gen)
    else:
        raise ValueError(f"unknown optflow model {optflow_model}")
    if weights_path:
        model.load_state_dict(load_state_dict_file(weights_path))
    model = model.to(device, dt).eval().requires_grad_(False)
    if hasattr(model, "fused_update"):
        model.fused_update = dt == torch.bfloat16

    def flow_fn(frames):
        return flow_for_training(frames.to(dt), model, basic=basic)

    flow_fn.model = model
    return flow_fn


def main(argv=None):
    args = multiframe_train_parser().parse_args(argv)
    if args.multihost and args.spatial_shards > 1:
        raise SystemExit("--spatial_shards > 1 with --multihost is not "
                         "supported: per-host batch assembly shards axis 0 "
                         "only")
    check_ported(args)
    # the process group first (a no-op for one process), so that each rank
    # logs to its own files
    rank, world = init_distributed(auto=args.multihost, device=args.device)
    device = resolve_device(args.device)
    writer, logger, expt_dir = init_logging(
        args.expt_savedir, args.expt_name, args.debug, rank=rank)
    logger.info(f"args: {vars(args)}")
    np.random.seed(args.seed)
    T, H, W = args.num_input_frames, args.input_height, args.input_width
    if world > 1:
        logger.info(f"data-parallel: process {rank} of {world} on {device}, "
                    f"global batch {args.batch_size * world} (--batch_size "
                    f"{args.batch_size} per process)")

    train_loader, val_loader = get_data_loader(
        args.dataset, args.data_dir, args.mode, args.prediction_task, T,
        args.batch_size, num_workers=args.num_workers,
        fold_index=args.fold_index, add_depth_inputs=args.add_depth_inputs,
        seed=args.seed, shard=(rank, world) if world > 1 else None,
        packed_dir=args.packed_dir)
    if world > 1:
        # every global batch whole: each rank's rows of it
        train_loader.drop_last = True
    model = get_multiframe_segmentation_model(
        args.model_type, num_classes=args.num_classes,
        num_input_frames=T, add_optflow_inputs=args.add_optflow_inputs,
        add_depth_inputs=args.add_depth_inputs, scale=args.model_scale,
        remat=args.remat)
    init_weights_lecun(model, torch.Generator().manual_seed(args.seed))
    model.multiframe_net.parity_grid = args.parity_grid
    base_loaded = False
    if args.load_wts_base_model:
        model.base_model.load_state_dict(
            load_state_dict_file(args.load_wts_base_model))
        base_loaded = True
        logger.info(f"Loaded base weights from {args.load_wts_base_model}")
    model.to(device)

    accum = max(1, args.grad_accum)
    steps_per_epoch = max(1, len(train_loader) // accum)
    sched = make_schedule(args.scheduler, args.lr, args.num_epochs,
                          steps_per_epoch)
    state = TrainState(model, sched, T,
                       train_base_model=args.train_base_model,
                       base_pretrained_loaded=base_loaded, grad_accum=accum,
                       ema_decay=args.ema_decay)
    if accum > 1:
        logger.info(f"gradient accumulation: {accum} micro-batches per "
                    f"update (effective batch {args.batch_size * accum})")

    start_epoch, resume_skip = args.starting_epoch, 0
    if args.resume:
        start_epoch, resume_skip = resume(state, expt_dir / "ckpts",
                                          args.load_wts_model,
                                          args.starting_epoch, logger)
    elif args.load_wts_model:
        model.load_state_dict(load_state_dict_file(args.load_wts_model))
        logger.info(f"Loaded model weights from {args.load_wts_model}")
    state.distribute()

    flow_fn = None
    if args.add_optflow_inputs:
        flow_fn = build_flow_fn(args.optflow_model, (H, W),
                                args.load_wts_flow_model, args.compute_dtype,
                                device, basic="Basic" in args.model_type)
        if not args.load_wts_flow_model:
            logger.warning("--add_optflow_inputs without "
                           "--load_wts_flow_model: the frozen flow provider "
                           "has RANDOM weights")
    train_step = make_multiframe_train_step(
        args.loss_fns, args.loss_wts, args.num_classes,
        class_weights=args.class_weights, flow_fn=flow_fn,
        compute_dtype=args.compute_dtype)
    eval_step = make_multiframe_eval_step(
        args.loss_fns, args.loss_wts, args.metric_fns, args.num_classes,
        class_weights=args.class_weights, flow_fn=flow_fn,
        compute_dtype=args.compute_dtype)
    tcfg = TransformConfig(out_height=H, out_width=W,
                           prediction_task=args.prediction_task)

    def aug(batch, gen):
        return augment_train_batch(batch, gen, tcfg, device,
                                   rows=(rank, world))

    def prep(batch):
        return preprocess_eval_batch(batch, tcfg, device)

    try:
        fit(args, state, (train_loader, val_loader), (train_step, eval_step),
            (aug, prep), logger, writer, expt_dir / "ckpts", start_epoch,
            resume_skip)
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
