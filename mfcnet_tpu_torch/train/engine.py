"""Epoch loops (counterpart of ``mfcnet_tpu/train/engine.py``; reference
src/engine.py).

Losses accumulate on the device and are read at print points and at the
end of an epoch. Each batch's augmentation draws come from a
``torch.Generator`` seeded by (seed, epoch, position of the batch in the
epoch), so a resumed epoch (``skip_batches``) replays the interrupted
run's draws. The loader's batches are augmented one step ahead on a
background thread (:class:`~mfcnet_tpu_torch.data.loader.Prefetcher`).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from mfcnet_tpu_torch.data.loader import Prefetcher
from mfcnet_tpu_torch.parallel.dist import group_rank
from mfcnet_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from mfcnet_tpu_torch.utils.logging import AverageMeter, ProgressMeter


class TrainInterrupted(KeyboardInterrupt):
    """A KeyboardInterrupt inside an epoch, carrying the number of batches
    whose steps completed (the state is the training state after them)."""

    def __init__(self, batches_done: int):
        super().__init__()
        self.batches_done = batches_done


def batch_generator(seed: int, epoch: int, position: int) -> torch.Generator:
    """The generator of the augmentation draws of batch ``position`` of
    ``epoch``: a function of the three numbers only."""
    key = np.random.SeedSequence([seed, epoch, position]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def train_one_epoch(loader, epoch: int, state, train_step: Callable,
                    aug_fn: Optional[Callable], seed: int, logger,
                    writer=None, print_freq: int = 10, loss_fns=(),
                    skip_batches: int = 0):
    """Train one epoch; returns the mean total loss. ``aug_fn(batch,
    generator)`` augments a host batch (on the device). Pair
    ``skip_batches`` with ``loader.set_epoch(epoch, skip_batches)``. An
    interrupt raises :class:`TrainInterrupted`."""
    batch_time = AverageMeter("Time", ":2.2f")
    data_time = AverageMeter("Data", ":2.2f")
    progress = ProgressMeter(len(loader), [batch_time, data_time],
                             prefix=f"Epoch: [{epoch}]")
    position = skip_batches

    def prepare(batch):
        nonlocal position
        if aug_fn is None:
            return batch
        gen = batch_generator(seed, epoch, position)
        position += 1
        return aug_fn(batch, gen)

    sums, n_steps = None, 0
    data_t0 = time.time()
    try:
        for step_idx, batch in enumerate(Prefetcher(loader, prepare)):
            data_time.update(time.time() - data_t0)
            t0 = time.time()
            parts = train_step(state, batch)
            n_steps += 1
            sums = (dict(parts) if sums is None
                    else {k: sums[k] + v for k, v in parts.items()})
            batch_time.update(time.time() - t0)
            if step_idx % print_freq == 0:
                cur = float(parts["loss_total"])
                if not math.isfinite(cur):
                    logger.error(f"Loss is {cur} at step {step_idx}; "
                                 "aborting.")
                    raise FloatingPointError(f"non-finite loss {cur}")
                progress.display(step_idx, logger=logger)
                logger.info(f"  loss_total {cur:.4f}")
            data_t0 = time.time()
    except KeyboardInterrupt:
        raise TrainInterrupted(skip_batches + n_steps)

    avg = float(sums["loss_total"]) / max(1, n_steps) if sums else 0.0
    if writer is not None:
        writer.add_scalar("Training/Loss", avg, epoch)
        for name in loss_fns:
            writer.add_scalar(f"Training/Loss_{name}",
                              float(sums[f"loss_{name}"]) / max(1, n_steps),
                              epoch)
    logger.info(f"Training loss: {avg}")
    return avg


def validate(loader, state, eval_step: Callable, prep_fn: Optional[Callable],
             logger, writer=None, epoch: Optional[int] = None,
             print_freq: int = 10, loss_fns=(), metric_fns=(),
             num_classes: int = 2):
    """Mean total loss over the loader; logs the per-class means of each
    metric (src/engine.py:89-171)."""
    loss_sum, metric_sums, n = 0.0, {}, 0
    for step_idx, batch in enumerate(Prefetcher(loader, prep_fn)):
        _, parts = eval_step(state, batch)
        loss_sum = loss_sum + parts["loss_total"]
        for mf in metric_fns:
            key = f"{mf}_per_class"
            acc = parts[key].mean(dim=0)
            metric_sums[key] = acc if key not in metric_sums else (
                metric_sums[key] + acc)
        n += 1
        if step_idx % print_freq == 0:
            logger.info(f"  val [{step_idx}/{len(loader)}] loss "
                        f"{float(parts['loss_total']):.4f}")
    avg = float(loss_sum) / max(1, n)
    logger.info(f"Validation loss: {avg}")
    if writer is not None and epoch is not None:
        writer.add_scalar("Validation/Loss", avg, epoch)
    for mf in metric_fns:
        vals = metric_sums[f"{mf}_per_class"].cpu().numpy() / max(1, n)
        for cls in range(1, num_classes):
            v = float(vals[cls - 1])
            logger.info(f"Validation metric {mf} {cls}: {v}")
            if writer is not None and epoch is not None:
                writer.add_scalar(f"Validation/{mf} {cls}", v, epoch)
    return avg


def resume(state, ckpt_dir, path, starting_epoch: int, logger):
    """``--resume``: restore ``state`` from ``path`` or the latest
    checkpoint in ``ckpt_dir``; returns (first epoch, batches to skip in
    it). An interrupt snapshot re-enters its epoch at the batch it stopped;
    a complete epoch resumes after it. Without a checkpoint: (starting
    epoch, 0)."""
    ck = path or latest_checkpoint(ckpt_dir)
    if not ck:
        return starting_epoch, 0
    payload, epoch = load_checkpoint(ck)
    state.load_state_dict(payload)
    mid_epoch = "batches_done" in payload
    skip = int(payload.get("batches_done", 0))
    logger.info(f"Resumed from {ck} at epoch {epoch}" + (
        f" (mid-epoch: skipping {skip} batches)" if mid_epoch else ""))
    return max(starting_epoch, epoch if mid_epoch else epoch + 1), skip


def fit(args, state, loaders, steps, transforms, logger, writer, ckpt_dir,
        start_epoch: int, resume_skip: int = 0,
        epoch_end: Optional[Callable[[int], None]] = None):
    """The CLIs' epoch loop (reference scripts/train_multiframe_detection.py
    :160-183): for each epoch up to ``args.num_epochs`` train (``loaders``,
    ``steps``, ``transforms`` = (train, val) pairs), validate, call
    ``epoch_end(epoch)`` if given, save every
    ``args.save_freq`` epochs and at the last; an interrupt saves the
    snapshot ``model_999`` with its position (inside an epoch: the batches
    done; elsewhere the last completed epoch) and re-raises. Under a
    process group only rank 0 writes checkpoints (the state is the same on
    every rank)."""
    (train_loader, val_loader), (train_step, eval_step) = loaders, steps
    aug, prep = transforms
    writes = group_rank() == 0
    epoch = completed = start_epoch - 1
    try:
        for epoch in range(start_epoch, args.num_epochs + 1):
            skip = resume_skip if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, skip_batches=skip)
            train_one_epoch(train_loader, epoch, state, train_step, aug,
                            args.seed, logger, writer, args.print_freq,
                            args.loss_fns, skip_batches=skip)
            completed = epoch
            validate(val_loader, state, eval_step, prep, logger, writer,
                     epoch, args.print_freq, args.loss_fns, args.metric_fns,
                     args.num_classes)
            if epoch_end is not None:
                epoch_end(epoch)
            if writes and (epoch % args.save_freq == 0
                           or epoch == args.num_epochs):
                p = save_checkpoint(ckpt_dir, epoch, state)
                logger.info(f"Saved checkpoint {p}")
    except KeyboardInterrupt as e:
        extra = ({"epoch": epoch, "batches_done": e.batches_done}
                 if isinstance(e, TrainInterrupted) else {"epoch": completed})
        if writes:
            p = save_checkpoint(ckpt_dir, 999, state, extra=extra)
            logger.info(f"Interrupted; snapshot saved to {p} ({extra})")
        raise
