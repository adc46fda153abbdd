"""Device times of the decode's four ``cc.cu`` kernels at the decode's own
inputs, for the package of this checkout, or of this checkout and another
tree in turns on one card in one call:

    python3 tools/cc_times.py [--breakdown] [--tree DIR]

Two class maps, both 480x640: the crafted clean class map of
``chip_smoke.py`` (the union tier) and the class map of the random-weight
tracker model's window ending at frame 15 (``chip_smoke.py``'s seed and
synthetic frames; speckled, the per-blob tier). On each, the calls the
decode makes (``track/decode_device.py``): ``union_flood_cc_cid`` on the
union class image; ``flood_cc_cid`` on the four class masks;
``connected_components`` 4-connected on the masks' background
(``fill_holes``) and 8-connected on the hole-filled masks (the exact
tier); ``onehot_stats`` on the union tier's outputs (with ``cide``) and on
the per-blob tier's (``cid``, ``filled * 8``). For each call: ms per call
called eagerly (CUDA events around 50 calls) and by CUDA-graph replay
(``chip_smoke.py::_graph_ms``). ``--breakdown`` also lists the device
operations of one call with their device times (``torch.profiler``).
Every output is checked against its plain version first.

Prints the card's name and power limit, then one JSON line of readings.
With ``--tree DIR`` (another checkout, say the parent commit unpacked under
``build/`` with ``git archive``; its kernels build into DIR/build) the
script times DIR (A) and this checkout (B) in turns, A B B A, each turn in
a process of its own, prints each turn's line and then one line with the
best reading of each tree per key (``"best": {key: [A, B]}``), and the
ratio A / B.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: the window whose class map is the second input (as chip_smoke times the
#: decode on windows 15, 23 and 33)
WINDOW = 15


def model_class_map(frames, window=WINDOW):
    """(H, W) int class map (argmax) of the random-weight tracker model's
    window ending at ``window``, as ``chip_smoke.py`` builds that model."""
    import torch

    from chip_smoke import C, SEED, T, _window_probs
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T,
        generator=torch.Generator().manual_seed(SEED))
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False)
    engine = InferenceEngine(model, cfg)
    return torch.argmax(_window_probs(engine, frames, window), dim=-1)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def in_turns(tree: Path, breakdown: bool):
    """A (``tree``) B (this checkout) B A, a process each; the best reading
    of each tree per timed key."""
    turns = []
    for t in (tree, ROOT, ROOT, tree):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time-tree",
               str(t)] + (["--breakdown"] if breakdown else [])
        line = subprocess.run(cmd, capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    best = {k: [min(turns[0][k], turns[3][k]), min(turns[1][k], turns[2][k])]
            for k in turns[0] if " ms, " in k and k in turns[1]}
    return {"A": str(tree), "B": str(ROOT), "best": best,
            "A/B": {k: a / b for k, (a, b) in best.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--time-tree", type=Path, default=None,
                    help=argparse.SUPPRESS)  # one turn of --tree
    ap.add_argument("--breakdown", action="store_true",
                    help="list each call's device operations")
    args = ap.parse_args()
    if args.tree is not None:
        print(card(), flush=True)
        print(json.dumps(in_turns(args.tree.resolve(), args.breakdown)),
              flush=True)
        return
    tree = (args.time_tree or ROOT).resolve()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (_device_events, _event_ms, _graph_ms,
                            _replay_equals, crafted_class_maps, decode_calls,
                            decode_inputs, synthetic_frames)

    sys.path.insert(0, str(tree))
    import torch

    from mfcnet_tpu_torch.ops import cc

    if not torch.cuda.is_available():
        raise SystemExit("cc_times: needs an NVIDIA GPU")
    if args.time_tree is None:
        print(card(), flush=True)
    clean = np.choose(crafted_class_maps()["clean"], [0, 3, 1, 4, 2])
    maps = {"clean": torch.from_numpy(clean.astype(np.int64)).cuda(),
            f"model window {WINDOW}": model_class_map(
                synthetic_frames(WINDOW + 1))}
    out = {"tree": str(tree), "package": cc.__file__}
    calls = {}
    for what, pred in maps.items():
        calls[what] = decode_calls(*decode_inputs(pred))
    for what, fns in calls.items():
        for name, (kern, plain, _) in fns.items():
            if not all(torch.equal(a, b) for a, b in zip(kern(), plain())):
                raise AssertionError(f"{name} on {what}: kernel != plain")
    if args.breakdown:
        for what, fns in calls.items():
            for name, (kern, _, _) in fns.items():
                ops = _device_events(kern)
                out[f"{name} ops, {what}"] = {
                    "count": len(ops), "device_us": sum(t for _, t in ops),
                    "ops": [[n[:60], round(t, 3)] for n, t in ops]}
    for what, fns in calls.items():
        for name, (kern, _, _) in fns.items():
            out[f"{name} eager ms, {what}"] = _event_ms(kern, 50)
            out[f"{name} graph ms, {what}"] = _graph_ms(kern)
            out[f"{name} graph equals eager, {what}"] = _replay_equals(kern)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
