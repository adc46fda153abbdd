"""Experiment logging (counterpart of ``mfcnet_tpu/utils/logging.py``;
reference utils/log_utils.py).

The experiment directory ``{expt_savedir}/{expt_name}/{logs,outputs,ckpts}``,
a file + stream logger (``logs/run.log``) and a JSONL scalar writer
(``logs/scalars.jsonl``, one ``{"tag", "value", "step", "ts"}`` object a
line) with the JAX package's tags (``Training/Loss``,
``Training/Loss_{fn}``, ``Validation/Loss``, ``Validation/{metric}
{class}``). Rank r > 0 of a data-parallel run writes ``run.rank{r}.log``
and ``scalars.rank{r}.jsonl`` beside rank 0's, into the experiment
directory that the ranks share.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path


class ScalarWriter:
    """JSONL scalar writer."""

    def __init__(self, logdir, suffix: str = ""):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.logdir / f"scalars{suffix}.jsonl", "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()})
                      + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def init_logging(expt_savedir, expt_name, debug: bool = False,
                 to_stdout: bool = True, rank=None):
    """Create the experiment directories, the logger and the scalar
    writer; returns (writer, logger, expt_dir) (utils/log_utils.py:16-60).
    ``rank``: a data-parallel run's process index; rank r > 0 logs to its
    own files (``run.rank{r}.log``, ``scalars.rank{r}.jsonl``), rank 0 and
    ``None`` to the reference's."""
    expt_dir = Path(expt_savedir) / expt_name
    for sub in ("logs", "outputs", "ckpts"):
        (expt_dir / sub).mkdir(parents=True, exist_ok=True)
    suffix = f".rank{rank}" if rank else ""
    logger = logging.getLogger(f"mfcnet_tpu_torch.{expt_name}")
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    fh = logging.FileHandler(expt_dir / "logs" / f"run{suffix}.log")
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(fh)
    if to_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    return ScalarWriter(expt_dir / "logs", suffix), logger, expt_dir


class AverageMeter:
    """Running average (utils/log_utils.py:63-81)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += self.val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """Batch progress line (utils/log_utils.py:84-103)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        digits = len(str(num_batches // 1))
        fmt = "{:" + str(digits) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int, logger=None):
        line = "\t".join([self.prefix + self.batch_fmtstr.format(batch)]
                         + [str(m) for m in self.meters])
        (logger.info if logger else print)(line)
