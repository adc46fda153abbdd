"""Device times of the two experimental conv kernels, ``conv3x3`` and
``vgg_stage1``, in float32 and bfloat16 at the shapes ``chip_smoke.py``
times, for the package of this checkout or of another tree, so that two
trees can be compared on one card in one call:

    python3 tools/conv_times.py [--tree DIR]

DIR holds another checkout (say ``git archive`` of a parent commit unpacked
under ``build/``); its kernels build into DIR/build. Run the two trees in
turns (A, B, B, A) and compare within the call. Prints the card's name and
power limit, then one JSON line: ms per call, device time of CUDA-graph
replays (``chip_smoke.py::_graph_ms``), bias + ReLU, seeded random inputs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (B, H, W, cin, cout) of conv3x3, and vgg_stage1's input with C1 = 64
CONV_SHAPES = ((1, 480, 640, 64, 64), (1, 240, 320, 64, 128))
STAGE1_SHAPE = (1, 480, 640, 3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose mfcnet_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _graph_ms  # this checkout's timer

    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1

    if not torch.cuda.is_available():
        raise SystemExit("conv_times: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    g = torch.Generator().manual_seed(0)
    out = {"tree": str(args.tree), "package": c3.__file__}
    for dt in (torch.float32, torch.bfloat16):
        times = out[str(dt).split(".")[1]] = {}
        for B, H, W, cin, cout in CONV_SHAPES:
            x = torch.randn(B, H, W, cin, generator=g).cuda().to(dt)
            w = (torch.randn(3, 3, cin, cout, generator=g)
                 * (2.0 / (9 * cin)) ** 0.5).cuda().to(dt)
            b = torch.randn(cout, generator=g).cuda() * 0.1
            times[f"conv3x3 {B}x{H}x{W}x{cin}->{cout}"] = _graph_ms(
                lambda: c3.conv3x3(x, w, b, True))
        x = torch.randn(STAGE1_SHAPE, generator=g).cuda().to(dt)
        k1 = (torch.randn(3, 3, 3, 64, generator=g) * 0.27).cuda().to(dt)
        k2 = (torch.randn(3, 3, 64, 64, generator=g) * 0.059).cuda().to(dt)
        b1 = torch.randn(64, generator=g).cuda() * 0.1
        b2 = torch.randn(64, generator=g).cuda() * 0.1
        times["vgg_stage1 1x480x640x3->64"] = _graph_ms(
            lambda: s1.vgg_stage1(x, k1, b1, k2, b2))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
