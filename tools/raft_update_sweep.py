"""Sweep the bfloat16 RAFT update kernel of the PyTorch port over token
counts and over the block count its clusters aim for, on one NVIDIA GPU.

    python3 tools/raft_update_sweep.py [--targets 132,160,200,264]
        [--shapes 1x2x2,2x30x40,4x30x40,1x60x80,8x60x80]

For every shape B x H8 x W8 and every value of
``mfcnet_tpu_torch.ops.raft_update.TARGET_BLOCKS`` it builds a solve's
workspace, feeds the state back as the solve does and prints the tile
plan's cluster sizes and the step's device time (CUDA-graph replays of ten
chained steps, the better of two readings) beside the card's name and power
limit. It is where ``TARGET_BLOCKS`` was chosen. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout

from mfcnet_tpu_torch.models import init_weights  # noqa: E402
from mfcnet_tpu_torch.models.raft import UpdateBlock  # noqa: E402
from mfcnet_tpu_torch.ops import raft_update as ru  # noqa: E402


def graph_ms(fn, reps=10, rounds=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(rounds):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * rounds)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", default="132,160,200,264")
    ap.add_argument("--shapes",
                    default="1x2x2,2x30x40,4x30x40,1x60x80,8x60x80")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("raft_update_sweep: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    ub = init_weights(UpdateBlock(), gen).cuda().eval()
    packed = ru.pack_update_weights(ub, torch.bfloat16)
    for shape in args.shapes.split(","):
        B, H8, W8 = (int(v) for v in shape.split("x"))

        def t(cols, fn, dt=torch.float32):
            return fn(torch.randn(B, H8 * W8, cols, generator=gen)
                      ).cuda().to(dt)

        c1, f1, inp = (t(c, torch.relu, torch.bfloat16)
                       for c in (256, 128, 128))
        net, flow = t(128, torch.tanh), t(2, lambda v: v)
        for target in (int(v) for v in args.targets.split(",")):
            ru.TARGET_BLOCKS = target
            ws = ru.UpdateWorkspace(B, H8, W8, packed, "cuda")
            state = [net]

            def step():
                state[0], _ = ru.raft_update(c1, f1, inp, state[0], flow,
                                             packed, H8, W8, ws)

            ms = min(graph_ms(step), graph_ms(step))
            print(f"[{smi}] raft_update bf16 {shape} = {B * H8 * W8} tokens, "
                  f"TARGET_BLOCKS {target}: configuration '{ws.plan.config}', "
                  f"clusters {ws.plan.clusters}, {ms:.4f} ms per step",
                  flush=True)


if __name__ == "__main__":
    main()
