"""Host and device time of the bfloat16 UnFlow provider's forward at the
tracker's shape (2 pairs at 256x320: the UnFlow path's 512x640 frames at
half resolution), on seeded random weights (``he_init_weights``, as
``chip_smoke.py`` makes them) and seeded random bfloat16 inputs:

    python3 tools/unflow_times.py

Two forwards of one bfloat16-cast model, timed in turns (A B B A):
``module`` (A), the model's own call, whose parameters were rounded to
bfloat16 once, at the cast, and kept in float32; and ``per-call upcast``
(B), the same arithmetic on bfloat16 parameters cast to float32 on every
call (``torch.func.functional_call``), the form the port's bfloat16 UnFlow
had first. Prints the card's name and power limit, then one JSON line: for
each forward and turn, host ms per call (12 synchronized calls) and device
ms per call (CUDA-graph replay, ``chip_smoke.py::_graph_ms``), and the
largest difference between the two forwards' flows.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.func import functional_call

    from chip_smoke import SEED, _graph_ms, _host_ms
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights

    if not torch.cuda.is_available():
        raise SystemExit("unflow_times: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    gen = torch.Generator().manual_seed(SEED)
    model = copy.deepcopy(he_init_weights(UnFlow(), gen)).to(
        "cuda", torch.bfloat16).eval()
    bf16 = {k: v.detach().bfloat16() for k, v in model.named_parameters()}

    def upcast_forward(first, second):
        a, b = model._prep(first), model._prep(second)
        flow = None
        for i, net in enumerate(model.moduleFlownets):
            params = {k: bf16[f"moduleFlownets.{i}.{k}"].float()
                      for k, _ in net.named_parameters()}
            flow = functional_call(
                net, params, (a, b) if flow is None else (a, b, flow))
        return flow.permute(0, 2, 3, 1)

    first, second = (torch.randn(2, 256, 320, 3, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2))
    forwards = {"module": lambda: model(first, second),
                "per-call upcast": lambda: upcast_forward(first, second)}
    out = {"shape": "2 pairs at 256x320, bfloat16 input"}
    with torch.no_grad():
        out["max |flow diff|"] = (forwards["module"]() - forwards[
            "per-call upcast"]()).abs().max().item()
        for name in ("module", "per-call upcast", "per-call upcast",
                     "module"):
            fn = forwards[name]
            out.setdefault(f"{name} host ms", []).append(_host_ms(fn, 12))
            out.setdefault(f"{name} graph ms", []).append(
                _graph_ms(fn, reps=4, rounds=5))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
