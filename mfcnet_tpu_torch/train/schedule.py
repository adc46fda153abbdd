"""Learning-rate schedules (counterpart of ``mfcnet_tpu/train/schedule.py``;
reference: StepLR(step_size=num_epochs//2, gamma=0.1) or constant).

A schedule maps the number of optimizer updates done so far to the
learning rate. 'StepDecay' is a per-update staircase, optax's
``exponential_decay(lr, transition_steps=max(1, num_epochs // 2) *
steps_per_epoch, decay_rate=0.1, staircase=True)``: lr * 0.1 **
(updates // transition_steps) -- not ``StepLR`` stepped per epoch.
"""

from __future__ import annotations


class StepDecay:
    def __init__(self, lr: float, transition_steps: int,
                 decay_rate: float = 0.1):
        self.lr, self.transition_steps = lr, transition_steps
        self.decay_rate = decay_rate

    def __call__(self, updates: int) -> float:
        return self.lr * self.decay_rate ** (updates // self.transition_steps)


class Constant:
    def __init__(self, lr: float):
        self.lr = lr

    def __call__(self, updates: int) -> float:
        return self.lr


def make_schedule(name: str, lr: float, num_epochs: int,
                  steps_per_epoch: int):
    """'StepDecay': x0.1 every num_epochs // 2 epochs of updates;
    'Constant': flat."""
    if name == "Constant":
        return Constant(lr)
    if name == "StepDecay":
        return StepDecay(lr, max(1, num_epochs // 2) * max(1, steps_per_epoch))
    raise ValueError(f"unknown scheduler: {name}")
