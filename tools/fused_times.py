"""The tracker's step with ``fused_dispatch`` (one CUDA graph replay a
frame) and without, on the card, for the package of this checkout, or of
this checkout and another tree in turns on one card in one call:

    python3 tools/fused_times.py [--tree DIR] [--out FILE]

At full width (480x640, T=3, C=5, bf16, random weights from the seed, device
decode, tie fallback off, as ``chip_smoke.py`` phase 12 builds them), for
the no-flow path and the RAFT x12 path, each way: frames/s on
device-resident frames (host clock), and over a profiled window of 4
steps the device's busy ms a step (the union of its kernels' spans), its
device operations a step and its idle share, with each hand kernel's
device kernels in the trace held to the launch counts
(``chip_smoke.py::_fused_timing``). Beside them the host ms of one
``PackedPyramid`` (RAFT's packed correlation pyramid, whose index constants
a solve makes) at the full-width 60x80 grid, 4 levels, radius 4.

For this checkout it also runs phase 12's checks of the step's pieces:
fused against unfused on 24 frames of each path (byte-equal, one replay a
frame, no host sync, the same tiers and launches), the IF nodes against
their host-read version and the decode captured alone on a class map of
each tier.

Prints the card's name and power limit, then one JSON line of readings.
With ``--tree DIR`` (another checkout unpacked under ``build/``; its
kernels build into DIR/build) the script measures DIR (A) and this
checkout (B) in turns, A B B A, each turn in a process of its own, prints
each turn's line and then one line with both trees' readings per key in
the order of the turns. ``--out`` writes the last line to a file too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 24
PYRAMID_REPS = 200


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _engines(cs):
    """The no-flow and RAFT x12 engines at full width (phase 3's models)."""
    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    def gen():
        return torch.Generator().manual_seed(cs.SEED)

    base = dict(dtype="bfloat16", decode="device", overlay=False,
                decode_tie_fallback=False)
    engine = InferenceEngine(get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", cs.C, cs.T, generator=gen()),
        TrackerConfig(**base))
    g = gen()
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", cs.C, cs.T, add_optflow_inputs=True,
        generator=g)
    flow_engine = InferenceEngine(
        model, TrackerConfig(add_optflow_inputs=True, **base),
        flow_model=init_weights(RAFT(iters=cs.FLOW_ITERS), g))
    return {"no_flow": engine, "raft": flow_engine}


def _pyramid_ms(cs):
    import torch

    from mfcnet_tpu_torch.models import raft

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    f1, f2 = (torch.randn(1, 60, 80, 256, device="cuda", generator=g)
              for _ in range(2))
    pyr = raft.build_corr_pyramid(f1, f2, 4)
    return cs._host_ms(lambda: raft.PackedPyramid(pyr, 4), PYRAMID_REPS)


def readings(checks: bool):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    smi = cs.phase_device()
    dev = torch.from_numpy(cs.synthetic_frames(FRAMES)).cuda()
    out = {"pyramid_host_ms": _pyramid_ms(cs)}
    for what, src in _engines(cs).items():
        pair = cs._fused_pair(src, "bfloat16")
        if checks:
            cs._fused_against_unfused(f"{what}, bf16", pair, dev, smi)
        try:
            out[what] = cs._fused_timing(f"{what}, bf16", pair, dev, smi)
        except AssertionError as e:  # the trace against the counts
            out[what] = {"error": str(e)}
        del pair
    if checks:
        cs._check_graph_if(smi)
        cs._check_decode_tiers(smi)
    return out


def in_turns(tree: Path):
    runs = []
    for t in (tree, ROOT, ROOT, tree):
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-tree",
             str(t)], capture_output=True, text=True)
        sys.stderr.write(r.stderr[-4000:])
        print(r.stdout, end="", flush=True)
        if r.returncode:
            raise SystemExit(f"turn on {t} failed: {r.returncode}")
        runs.append((t, json.loads(r.stdout.strip().splitlines()[-1])))
    keys = [("pyramid_host_ms",)] + [
        (p, w, k) for p in ("no_flow", "raft") for w in ("unfused", "fused")
        for k in ("frames_per_s", "busy_ms_per_step", "ops_per_step",
                  "idle_share")]

    def get(d, key):
        for k in key:
            d = d.get(k) if isinstance(d, dict) else None
        return d

    return {"A": str(tree), "B": str(ROOT), "turns": "A B B A",
            "readings": {"/".join(k): [get(r, k) for _, r in runs]
                         for k in keys}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="another checkout, measured in turns with this one")
    ap.add_argument("--time-tree", type=Path, default=None,
                    help=argparse.SUPPRESS)  # one turn of --tree
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the last line here")
    args = ap.parse_args()
    if args.tree is not None:
        print(card(), flush=True)
        line = json.dumps(in_turns(args.tree.resolve()))
    else:
        tree = (args.time_tree or ROOT).resolve()
        sys.path.insert(0, str(tree))
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("fused_times: needs an NVIDIA GPU")
        if args.time_tree is None:
            print(card(), flush=True)
        line = json.dumps(readings(checks=tree == ROOT))
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
