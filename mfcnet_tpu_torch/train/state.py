"""Train state: the optimizer recipe, gradient accumulation and the EMA
(counterpart of ``mfcnet_tpu/train/state.py``).

The JAX package's recipe (``multiframe_optimizer``, reference
scripts/train_multiframe_detection.py:128-151):

* Adam (b1 0.9, b2 0.999, eps 1e-8) on the head at the schedule's lr;
* Adam on the base at lr / (100 * T) when base weights were loaded, else
  at lr / T;
* a frozen base (the default) is left out of the optimizer and its
  parameters get ``requires_grad=False``: they stay bit-identical, as
  under the JAX package's ``optax.set_to_zero``, and no gradient reaches
  the base's maps;
* ``grad_accum`` k > 1 (``optax.MultiSteps``): the gradients of k
  micro-batches are averaged and one update follows; the schedule counts
  updates, not micro-batches;
* the EMA of the parameters blends only on real updates: e = e * d + p *
  (1 - d);
* dropout and drop-path draw, in each micro-step, from a generator seeded
  by the micro-step (:meth:`TrainState.step_generator`), as the JAX step
  folds the step into its fixed key: a resumed run draws what the
  uninterrupted one drew, and a run repeats bit for bit.

The model's parameters are the float32 master copy; the step may compute
in bfloat16 from a cast of them (``train/steps.py``).

Under a process group (:meth:`TrainState.distribute`) the step runs the
model through ``DistributedDataParallel``: one gradient all-reduce per
update, after the last micro-batch of an accumulation (``no_sync`` on the
others, and the accumulated gradient of the earlier micro-batches put back
into ``.grad`` before the last backward, so that the all-reduce carries the
update's whole gradient). The model, its ``state_dict`` key names and the
EMA stay the plain module's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch


def _is_base(name: str) -> bool:
    return name.startswith("base_model.")


class TrainState:
    """Model + Adam + accumulation + EMA. ``step`` counts micro-batches
    (the JAX state's ``step``), ``updates`` optimizer updates."""

    def __init__(self, model: torch.nn.Module,
                 lr_schedule: Callable[[int], float], num_frames: int = 1,
                 train_base_model: bool = True,
                 base_pretrained_loaded: bool = False, grad_accum: int = 1,
                 ema_decay: float = 0.0, split_base: bool = True):
        """``split_base``: the multi-frame recipe (head and base groups);
        False puts every parameter in one Adam at lr (single-frame
        training). ``train_base_model`` False also keeps the base in eval
        mode in the step (running statistics, no dropout), as the JAX
        step runs it with ``train=False``."""
        self.model = model
        self.train_base_model = bool(train_base_model) or not split_base
        self._generator = None
        self.schedule = lr_schedule
        self.grad_accum = max(1, int(grad_accum))
        base_scale = (1.0 / (100.0 * num_frames) if base_pretrained_loaded
                      else 1.0 / num_frames)
        named = list(model.named_parameters())
        if split_base:
            head = [p for n, p in named if not _is_base(n)]
            base = [p for n, p in named if _is_base(n)]
            groups = [{"params": head, "scale": 1.0}]
            if train_base_model:
                groups.append({"params": base, "scale": base_scale})
            else:
                for p in base:
                    p.requires_grad_(False)
        else:
            groups = [{"params": [p for _, p in named], "scale": 1.0}]
        self.optimizer = torch.optim.Adam(groups, lr=lr_schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.trained = [p for g in groups for p in g["params"]]
        #: gradient sums of the completed micro-batches of the update in
        #: progress (grad_accum > 1)
        self.accum = None
        self.step = 0
        self.updates = 0
        self.micro = 0
        self.ema_decay = float(ema_decay)
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in named}
            if self.ema_decay > 0 else None)
        #: ``DistributedDataParallel`` around the model, under a group
        self.ddp = None

    def distribute(self):
        """Under a process group, run the model's train steps through
        ``DistributedDataParallel`` (its buffers are not broadcast: the
        batch norms' statistics are global and equal on every rank
        already). A no-op without a group."""
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel as DDP

        if not dist.is_initialized():
            return self
        dev = next(self.model.parameters()).device
        self.ddp = DDP(self.model,
                       device_ids=[dev] if dev.type == "cuda" else None,
                       broadcast_buffers=False)
        return self

    @property
    def runner(self) -> torch.nn.Module:
        """What a train step calls: the model, or its DDP wrapper."""
        return self.ddp if self.ddp is not None else self.model

    def step_generator(self) -> torch.Generator:
        """The generator of this micro-step's dropout and drop-path draws,
        on the model's device, seeded by ``step`` (the JAX step's key is
        ``fold_in(PRNGKey(17), step)``)."""
        dev = next(self.model.parameters()).device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev)
        return self._generator.manual_seed(17 * 1_000_003 + self.step)

    def apply_gradients(self) -> bool:
        """Call after the backward of one micro-batch: counts it and, with
        accumulation, moves its gradient into the float32 accumulator; on
        the k-th micro-batch updates on the mean gradient and blends the
        EMA. Returns whether an update ran. The accumulator holds only
        completed micro-batches, so a snapshot taken after an interrupt
        inside a step resumes consistently."""
        self.step += 1
        self.micro += 1
        if self.grad_accum > 1:
            last = self.micro == self.grad_accum
            if self.ddp is not None and last:
                # .grad holds the whole update's sum (see micro_step)
                for p, a in zip(self.trained, self.accum):
                    if p.grad is not None:
                        p.grad = p.grad / self.grad_accum
                    a.zero_()
            else:
                for p, a in zip(self.trained, self._accum()):
                    if p.grad is not None:
                        a.add_(p.grad)
                        p.grad = None
                if not last:
                    return False
                for p, a in zip(self.trained, self.accum):
                    p.grad = a / self.grad_accum
                    a.zero_()
        self.micro = 0
        lr = self.schedule(self.updates)
        for g in self.optimizer.param_groups:
            g["lr"] = lr * g["scale"]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    e = self.ema[n]
                    e.copy_(e * d + p.to(e.dtype) * (1.0 - d))
        return True

    @contextlib.contextmanager
    def micro_step(self):
        """A train step's forward, backward and :meth:`apply_gradients`
        run inside: if they raise (an interrupt), the running statistics
        that the forward updated in place are put back, so that the state
        is the one after the last completed micro-batch (the JAX step
        returns its statistics and commits them with the update). Under
        DDP with accumulation, a micro-batch before the last runs under
        ``no_sync`` and the last one starts from the earlier ones' sum in
        ``.grad``."""
        stats = [(b, b.detach().clone()) for b in self.model.buffers()
                 if b.is_floating_point()]
        sync = contextlib.nullcontext()
        if self.ddp is not None and self.grad_accum > 1:
            if self.micro + 1 < self.grad_accum:
                sync = self.ddp.no_sync()
            elif self.accum is not None:
                for p, a in zip(self.trained, self.accum):
                    p.grad = a.clone()
        try:
            with sync:
                yield
        except BaseException:
            with torch.no_grad():
                for b, old in stats:
                    b.copy_(old)
            for p in self.trained:
                p.grad = None
            raise

    def _accum(self):
        if self.accum is None:
            self.accum = [torch.zeros_like(p, dtype=torch.float32)
                          for p in self.trained]
        return self.accum

    def ema_state_dict(self) -> Optional[dict]:
        """The model's ``state_dict`` with the EMA in place of the
        parameters (buffers as they are), or None without an EMA."""
        if self.ema is None:
            return None
        # the conv1..conv5 stage views share the encoder's parameters:
        # match state_dict entries to parameters by storage
        by_ptr = {p.data_ptr(): n for n, p in self.model.named_parameters()}
        sd = {}
        for k, v in self.model.state_dict().items():
            n = by_ptr.get(v.data_ptr())
            sd[k] = (self.ema[n] if n is not None
                     and self.ema[n].shape == v.shape else v).clone()
        return sd

    def state_dict(self) -> dict:
        """Everything a resume needs, in the reference's ``.pth`` layout
        plus the counters and the EMA."""
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(),
               "step": self.step, "updates": self.updates,
               "micro": self.micro}
        if self.micro:
            out["accum"] = [a.clone() for a in self.accum]
        if self.ema is not None:
            out["ema"] = self.ema_state_dict()
        return out

    def load_state_dict(self, payload: dict):
        """Restore :meth:`state_dict`'s output (model, optimizer, counters,
        EMA; a payload without an EMA seeds it from the restored
        parameters)."""
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload.get("step", 0))
        self.updates = int(payload.get("updates", 0))
        self.micro = int(payload.get("micro", 0))
        if payload.get("accum") is not None:
            for a, g in zip(self._accum(), payload["accum"]):
                a.copy_(g)
        if self.ema is not None:
            ema = payload.get("ema")
            sd = ema if ema is not None else self.model.state_dict()
            for n in self.ema:
                self.ema[n].copy_(sd[n])
