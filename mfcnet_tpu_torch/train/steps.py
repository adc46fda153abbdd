"""Train and eval steps (counterpart of ``mfcnet_tpu/train/steps.py``;
reference src/engine.py:29-171).

A multi-frame train step: the frozen flow provider under ``no_grad`` (if
any), the model's forward in train mode, ``log_softmax`` and the losses
in float32, the backward, then :meth:`TrainState.apply_gradients`.

Mixed precision follows the JAX package, not ``torch.autocast``: the
parameters stay float32 (the master copy the optimizer updates); a
bfloat16 step runs the model on bfloat16 casts of them
(:func:`_cast_tensors`), with frames, depth and flow cast to bfloat16 too,
so that the gradients reach the float32 leaves through the casts. The
running statistics stay float32, in train and in eval steps, as the JAX
steps keep ``batch_stats``; batch statistics are taken in float32
(``models/common.py::BatchNorm2d``), and the logits are cast to float32
before ``log_softmax``. Autocast would pick its own set of operations to
cast.

A train step runs the base in train mode only when the base trains (the
JAX step's ``train_base``), and hands the micro-step's generator
(``TrainState.step_generator``) to the model's dropout and drop-path.

Under a process group each rank's batch is its rows of the global batch:
the train step runs the model through ``TrainState.runner`` (DDP), its
batch norms take the global batch's statistics (``models/common.py``), its
losses are the global batch's (``train/loss.py``, ``global_batch``) and
its dropout masks are its rows of the global batch's masks. The eval steps
see a batch that every rank holds whole and reduce nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.models.common import use_generator
from mfcnet_tpu_torch.parallel.dist import group_rank, group_world
from mfcnet_tpu_torch.train.loss import compute_losses
from mfcnet_tpu_torch.train.metrics import compute_metrics


def resolve_dtype(compute_dtype) -> Optional[torch.dtype]:
    """'bfloat16' -> torch.bfloat16; 'float32' or None -> None (no cast)."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype: {compute_dtype}")


def _cast(t, cdt):
    return t if t is None or cdt is None else t.to(cdt)


@contextlib.contextmanager
def _cast_tensors(model, cdt):
    """Within the block every module holds ``cdt`` casts of its floating
    parameters; the float32 tensors are put back after. Each module is
    visited once, so the TernausNet's ``conv1``..``conv5`` views of its
    encoder (``torch.func.functional_call`` restores such shared modules
    wrongly) see the same casts; the gradients flow through the casts to
    the float32 leaves. A train step holds the block through its backward,
    so that a rematerialized segment (``--remat``) recomputes on the same
    casts; nested, the inner block keeps the outer casts. No-op without
    ``cdt``."""
    if cdt is None:
        yield
        return
    saved = []
    for mod in model.modules():
        store = mod._parameters
        for name, t in store.items():
            if t is not None and t.is_floating_point():
                saved.append((store, name, t))
    try:
        for store, name, t in saved:
            store[name] = t.to(cdt)
        yield
    finally:
        for store, name, t in saved:
            store[name] = t


def _apply(model, cdt, *args, **kwargs):
    """model(*args, **kwargs), on bfloat16 casts of the parameters and
    floating inputs when ``cdt`` is set; the running statistics stay
    float32."""
    if cdt is None:
        return model(*args, **kwargs)
    args = tuple(_cast(a, cdt) for a in args)
    kwargs = {k: _cast(v, cdt) for k, v in kwargs.items()}
    with _cast_tensors(model, cdt):
        return model(*args, **kwargs)


def _train_mode(state):
    """The state's model in train mode, its base in eval mode unless the
    base trains; dropout and drop-path on the micro-step's generator, at
    this rank's rows."""
    model = state.model.train()
    if not state.train_base_model and hasattr(model, "base_model"):
        model.base_model.eval()
    use_generator(model, state.step_generator(),
                  rows=(group_rank(), group_world()))
    return model


def _losses(logits, batch, loss_fns, loss_wts, num_classes, class_weights,
            global_batch=False):
    log_probs = F.log_softmax(logits.float(), dim=-1)
    total, parts = compute_losses(log_probs, batch["mask"], loss_fns,
                                  loss_wts, num_classes, class_weights,
                                  global_batch=global_batch)
    return log_probs, total, parts


def make_multiframe_train_step(loss_fns: Sequence[str],
                               loss_wts: Sequence[float], num_classes: int,
                               class_weights=None,
                               flow_fn: Optional[Callable] = None,
                               compute_dtype=None):
    """``step(state, batch) -> parts`` (detached loss tensors). batch:
    'frames' (B, T, H, W, 3) float32 normalized, newest first, 'mask'
    (B, H, W) int, optional 'depth' (B, T, H, W, 1). ``flow_fn``: frames
    -> (B, T-1, H, W, 2) flow, a frozen provider
    (``track/outputs.py::flow_for_training``); the Basic variant warps by
    it (B1 in the backward when the base trains), the Large variant takes
    it raw into its head."""
    cdt = resolve_dtype(compute_dtype)

    def train_step(state, batch):
        model = _train_mode(state)
        frames = batch["frames"]
        optflow = None
        if flow_fn is not None:
            with torch.no_grad():
                optflow = flow_fn(frames)
        with state.micro_step():
            with _cast_tensors(model, cdt):
                logits = _apply(state.runner, cdt, frames, optflow=optflow,
                                depth=batch.get("depth"))
                _, total, parts = _losses(logits, batch, loss_fns, loss_wts,
                                          num_classes, class_weights,
                                          global_batch=True)
                total.backward()
            state.apply_gradients()
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_multiframe_eval_step(loss_fns: Sequence[str],
                              loss_wts: Sequence[float],
                              metric_fns: Sequence[str], num_classes: int,
                              class_weights=None,
                              flow_fn: Optional[Callable] = None,
                              compute_dtype=None):
    """``step(state, batch) -> (log_probs, parts)``: eval-mode forward
    (running statistics), losses and per-class IoU/Dice
    (src/engine.py:89-171)."""
    cdt = resolve_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(state, batch):
        model = state.model.eval()
        frames = batch["frames"]
        optflow = None if flow_fn is None else flow_fn(frames)
        logits = _apply(model, cdt, frames, optflow=optflow,
                        depth=batch.get("depth"))
        log_probs, _, parts = _losses(logits, batch, loss_fns, loss_wts,
                                      num_classes, class_weights)
        parts.update(compute_metrics(log_probs, batch["mask"], metric_fns,
                                     num_classes))
        return log_probs, parts

    return eval_step


def _singleframe_log_probs(model, cdt, image, output_mode):
    """(B, H, W, 3) -> (B, H, W, C) float32 log-probabilities: the model's
    NCHW output in float32, through ``log_softmax`` when it gives logits
    (``output_mode`` 'logits': HRNet, DeepLab, FCN, UNet, ResUNet;
    'log_probs': TernausNet11/16, SegFormer; ``models.OUTPUT_MODES``).
    'tapnet': the image is (B, H, W, 4), RGB and the attention map, which
    TAPNet takes as two inputs and answers with log-probabilities."""
    if output_mode not in ("log_probs", "logits", "tapnet"):
        raise ValueError(f"unknown output_mode: {output_mode!r}")
    x = image.permute(0, 3, 1, 2)
    args = (x[:, :3], x[:, 3:]) if output_mode == "tapnet" else (x,)
    out = _apply(model, cdt, *args).float()
    if output_mode == "logits":
        out = F.log_softmax(out, dim=1)
    return out.permute(0, 2, 3, 1)


def make_singleframe_train_step(loss_fns: Sequence[str],
                                loss_wts: Sequence[float], num_classes: int,
                                class_weights=None, compute_dtype=None,
                                output_mode: str = "log_probs"):
    """Single-frame step (reference
    scripts/train_toolpose_segmentation.py:142-192): batch 'image'
    (B, H, W, 3), or (B, H, W, 4) with TAPNet's attention map, 'mask'
    (B, H, W); ``output_mode`` as :func:`_singleframe_log_probs` reads
    it."""
    cdt = resolve_dtype(compute_dtype)

    def train_step(state, batch):
        model = _train_mode(state)
        with state.micro_step():
            with _cast_tensors(model, cdt):
                log_probs = _singleframe_log_probs(
                    state.runner, cdt, batch["image"], output_mode)
                total, parts = compute_losses(log_probs, batch["mask"],
                                              loss_fns, loss_wts, num_classes,
                                              class_weights,
                                              global_batch=True)
                total.backward()
            state.apply_gradients()
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_singleframe_eval_step(loss_fns: Sequence[str],
                               loss_wts: Sequence[float],
                               metric_fns: Sequence[str], num_classes: int,
                               class_weights=None, compute_dtype=None,
                               output_mode: str = "log_probs"):
    cdt = resolve_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(state, batch):
        model = state.model.eval()
        log_probs = _singleframe_log_probs(model, cdt, batch["image"],
                                           output_mode)
        _, parts = compute_losses(log_probs, batch["mask"], loss_fns,
                                  loss_wts, num_classes, class_weights)
        parts.update(compute_metrics(log_probs, batch["mask"], metric_fns,
                                     num_classes))
        return log_probs, parts

    return eval_step
