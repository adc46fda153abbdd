"""Losses (counterpart of ``mfcnet_tpu/train/loss.py``; reference
src/loss.py). Every loss takes log-probabilities ``(B, H, W, C)`` in the
JAX package's channel-last layout and integer targets ``(B, H, W)``, and
returns a float32 scalar tensor.

The training losses are ratios of sums over the whole batch, not means of
per-sample losses: the weighted NLL is sum(w * nll) / sum(w), the soft
Jaccard -log(I / U) of the batch's I and U. Each is therefore written as
its partial sums (``*_sums``) and a function of them (``*_from_sums``), and
:func:`compute_losses` with ``global_batch`` adds the partial sums of every
rank of a process group before it forms the losses
(``parallel/dist.py::all_sum``): each rank's loss is then the global
batch's, as in the JAX package's sharded step, and so is the gradient that
``DistributedDataParallel`` leaves on the parameters.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from mfcnet_tpu_torch.parallel.dist import all_sum


def nll_sums(log_probs, targets, class_weights=None):
    """(2,): sum(w[y] * -logp[y]) and sum(w[y]) (w = 1 without weights)."""
    picked = log_probs.gather(-1, targets.long().unsqueeze(-1))[..., 0]
    if class_weights is None:
        return torch.stack([-picked.sum(),
                            picked.new_tensor(float(picked.numel()))])
    w = torch.as_tensor(class_weights, dtype=log_probs.dtype,
                        device=log_probs.device)[targets.long()]
    return torch.stack([-(w * picked).sum(), w.sum()])


def nll_from_sums(sums):
    """A sum over its count: the NLL (and the MSE) from its partial sums."""
    return sums[0] / sums[1]


def nll_loss(log_probs, targets, class_weights=None):
    """Weighted NLL, ``nn.NLLLoss`` 'mean' semantics: sum(w[y] * -logp[y])
    / sum(w[y]) (src/loss.py:31-43); the plain mean without weights."""
    return nll_from_sums(nll_sums(log_probs, targets, class_weights))


def soft_jaccard_sums(log_probs, targets, num_classes: int):
    """(num_classes - 1, 3): per foreground class sum(p * t), sum(p) and
    sum(t)."""
    rows = []
    for cls in range(1, num_classes):
        t = (targets == cls).to(log_probs.dtype)
        p = torch.exp(log_probs[..., cls])
        rows.append(torch.stack([(p * t).sum(), p.sum(), t.sum()]))
    return torch.stack(rows)


def soft_jaccard_from_sums(sums, num_classes: int, eps: float = 1e-15):
    inter, union = sums[:, 0], sums[:, 1] + sums[:, 2] - sums[:, 0]
    return -torch.log((inter + eps) / (union + eps)).sum() / num_classes


def soft_jaccard_loss(log_probs, targets, num_classes: int,
                      eps: float = 1e-15):
    """Sum over the foreground classes of -log((I + eps) / (U + eps)),
    divided by ``num_classes`` (the background included, as in
    src/loss.py:45-63)."""
    return soft_jaccard_from_sums(
        soft_jaccard_sums(log_probs, targets, num_classes), num_classes, eps)


def mse_sums(outputs, targets):
    """(2,): the sum of squared differences and their count."""
    d = (outputs - targets.to(outputs.dtype)) ** 2
    return torch.stack([d.sum(), d.new_tensor(float(d.numel()))])


def mse_loss(outputs, targets):
    """Plain MSE (src/loss.py:23-29); targets broadcast against outputs."""
    return nll_from_sums(mse_sums(outputs, targets))


def wasserstein_loss(log_probs, targets, num_classes: int, cost_matrix,
                     eps: float = 1e-15):
    """Wasserstein-distance loss with a precomputed (H*W, H*W) pairwise
    pixel cost matrix (src/loss.py:65-119; no ``--loss_fns`` choice reaches
    it, in either package): per class, target and probability maps
    normalized to sum 1 per sample, |t - p| weighted by the row sums of
    ``cost_matrix`` (the reference's broadcast over both matrix axes),
    summed per sample and averaged over the batch; the classes' mean."""
    B = log_probs.shape[0]
    w = torch.as_tensor(cost_matrix, dtype=log_probs.dtype,
                        device=log_probs.device).sum(dim=1)
    loss = torch.zeros((), dtype=log_probs.dtype, device=log_probs.device)
    for cls in range(num_classes):
        t = (targets == cls).to(log_probs.dtype).reshape(B, -1)
        p = torch.exp(log_probs[..., cls]).reshape(B, -1)
        t = t / (t.sum(dim=1, keepdim=True) + eps)
        p = p / (p.sum(dim=1, keepdim=True) + eps)
        loss = loss + ((t - p).abs() * w[None, :]).sum(dim=1).mean()
    return loss / num_classes


def compute_losses(log_probs, targets, loss_fns: Sequence[str],
                   loss_wts: Sequence[float], num_classes: int,
                   class_weights=None, global_batch: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the named losses (src/loss.py:6-21): ``(total,
    parts)`` with parts ``loss_{fn}`` and ``loss_total``. One weight per
    loss, or a ValueError (the reference asserts the arity; a shorter
    ``loss_wts`` would drop losses silently). ``global_batch`` (the train
    steps): under a process group of world > 1, the losses of the global
    batch whose rows the ranks hold, every partial sum of this rank summed
    over the group in one collective (see the module docstring); a batch
    that every rank holds whole (validation) leaves it False."""
    if len(loss_fns) != len(loss_wts):
        raise ValueError(f"{len(loss_fns)} loss_fns but {len(loss_wts)} "
                         "loss_wts -- pass one weight per loss")
    sums = []
    for fn in loss_fns:
        if fn == "nll":
            sums.append(nll_sums(log_probs, targets, class_weights))
        elif fn == "soft_jaccard":
            sums.append(soft_jaccard_sums(log_probs, targets, num_classes))
        elif fn == "mse":
            sums.append(mse_sums(log_probs, targets))
        else:
            raise ValueError(f"Loss function {fn} not implemented")
    if global_batch:
        flat = all_sum(torch.cat([x.reshape(-1) for x in sums]))
        sums = [part.reshape(x.shape) for x, part in
                zip(sums, flat.split([x.numel() for x in sums]))]
    total = torch.zeros((), dtype=log_probs.dtype, device=log_probs.device)
    parts: Dict[str, torch.Tensor] = {}
    for fn, wt, part in zip(loss_fns, loss_wts, sums):
        val = (soft_jaccard_from_sums(part, num_classes)
               if fn == "soft_jaccard" else nll_from_sums(part))
        total = total + wt * val
        parts["loss_" + fn] = val
    parts["loss_total"] = total
    return total, parts
