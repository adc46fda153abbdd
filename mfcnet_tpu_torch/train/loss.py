"""Losses (counterpart of ``mfcnet_tpu/train/loss.py``; reference
src/loss.py). Every loss takes log-probabilities ``(B, H, W, C)`` in the
JAX package's channel-last layout and integer targets ``(B, H, W)``, and
returns a float32 scalar tensor.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def nll_loss(log_probs, targets, class_weights=None):
    """Weighted NLL, ``nn.NLLLoss`` 'mean' semantics: sum(w[y] * -logp[y])
    / sum(w[y]) (src/loss.py:31-43); the plain mean without weights."""
    picked = log_probs.gather(-1, targets.long().unsqueeze(-1))[..., 0]
    if class_weights is None:
        return -picked.mean()
    w = torch.as_tensor(class_weights, dtype=log_probs.dtype,
                        device=log_probs.device)[targets.long()]
    return -(w * picked).sum() / w.sum()


def soft_jaccard_loss(log_probs, targets, num_classes: int,
                      eps: float = 1e-15):
    """Sum over the foreground classes of -log((I + eps) / (U + eps)),
    divided by ``num_classes`` (the background included, as in
    src/loss.py:45-63)."""
    loss = torch.zeros((), dtype=log_probs.dtype, device=log_probs.device)
    for cls in range(1, num_classes):
        t = (targets == cls).to(log_probs.dtype)
        p = torch.exp(log_probs[..., cls])
        inter = (p * t).sum()
        union = p.sum() + t.sum() - inter
        loss = loss - torch.log((inter + eps) / (union + eps))
    return loss / num_classes


def mse_loss(outputs, targets):
    """Plain MSE (src/loss.py:23-29); targets broadcast against outputs."""
    return ((outputs - targets.to(outputs.dtype)) ** 2).mean()


def compute_losses(log_probs, targets, loss_fns: Sequence[str],
                   loss_wts: Sequence[float], num_classes: int,
                   class_weights=None) -> Tuple[torch.Tensor,
                                                Dict[str, torch.Tensor]]:
    """Weighted sum of the named losses (src/loss.py:6-21): ``(total,
    parts)`` with parts ``loss_{fn}`` and ``loss_total``. One weight per
    loss, or a ValueError (the reference asserts the arity; a shorter
    ``loss_wts`` would drop losses silently)."""
    if len(loss_fns) != len(loss_wts):
        raise ValueError(f"{len(loss_fns)} loss_fns but {len(loss_wts)} "
                         "loss_wts -- pass one weight per loss")
    total = torch.zeros((), dtype=log_probs.dtype, device=log_probs.device)
    parts: Dict[str, torch.Tensor] = {}
    for fn, wt in zip(loss_fns, loss_wts):
        if fn == "nll":
            val = nll_loss(log_probs, targets, class_weights)
        elif fn == "soft_jaccard":
            val = soft_jaccard_loss(log_probs, targets, num_classes)
        elif fn == "mse":
            val = mse_loss(log_probs, targets)
        else:
            raise ValueError(f"Loss function {fn} not implemented")
        total = total + wt * val
        parts["loss_" + fn] = val
    parts["loss_total"] = total
    return total, parts
