"""Activated batch normalization (counterpart of
``mfcnet_tpu/models/abn.py``; reference models/sync_bn/inplace_abn/bn.py).

The reference's ``ABN``, ``InPlaceABN`` and ``InPlaceABNSync`` are one
computation: batch norm followed by an activation, with in-place buffers
(a memory saving of its CUDA extension) and, for the Sync variant,
statistics over every GPU. Here they are one module, as in the JAX
package: its statistics go through ``models/common.py``'s batch norm, which
takes the global batch's under a process group of world > 1 -- the Sync
variant's statistics -- and PyTorch's autograd keeps what it needs.

Kept from the reference: eps 1e-5, momentum 0.1, the activations
``leaky_relu`` (slope 0.01), ``elu`` and ``none``, and the unbiased running
variance ``running_var += momentum * (var * count / (count - 1) -
running_var)`` (functions.py:98), with the count global under a group.
Normalization uses the biased variance. The key names are the reference's
(``weight``, ``bias``, ``running_mean``, ``running_var``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import batch_norm_train

ACTIVATIONS = ("leaky_relu", "elu", "none")


class ABN(nn.Module):
    """Batch norm + activation over the channel axis of NCHW (momentum
    0.1: ``models/common.py::BN_MOMENTUM``)."""

    def __init__(self, num_features: int, activation: str = "leaky_relu",
                 slope: float = 0.01, eps: float = 1e-5):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation}")
        self.activation, self.slope, self.eps = activation, slope, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            y = batch_norm_train(x, self, unbiased=True)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        if self.activation == "leaky_relu":
            return F.leaky_relu(y, self.slope)
        if self.activation == "elu":
            return F.elu(y)
        return y


#: the reference's three classes, one computation here (module docstring)
InPlaceABN = ABN
InPlaceABNSync = ABN
