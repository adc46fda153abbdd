"""The training CLI's learning check at several seeds: the JAX package's
e2e recipe (``tests/test_e2e_learning.py``: TernausNetMulti-Basic at
``--model_scale 0.25``, 64x64, batch 4, lr 3e-3 constant, nll +
soft_jaccard 0.7 / 0.3, class weights 1 / 50, the base trained, 8 epochs)
on a pack of the port's synthetic generator (2 + 2 videos of 12 frames).

    python3 tools/learn_seeds.py [--device cuda|cpu] [--seeds 0 1 2]
                                 [--tf32 on off]

Prints, per run, the last epoch's training loss over the first's and the
loss by epoch; on the card once with cuDNN's TF32 on (PyTorch's default
for convolutions) and once off, unless ``--tf32`` says otherwise.
``chip_smoke.py`` holds the median over seeds 0-2 under 0.6.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    import torch

    from mfcnet_tpu_torch.cli.train_multiframe_detection import main as train
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--tf32", nargs="+", default=["on", "off"],
                   choices=["on", "off"])
    args = p.parse_args(argv)
    modes = args.tf32 if args.device == "cuda" else ["off"]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        pack = make_synthetic_pack(d / "pack", videos=(
            ("train", 2, 12), ("val", 2, 12)), height=64, width=64, seed=3,
            add_depth=False)
        for tf32 in modes:
            torch.backends.cudnn.allow_tf32 = tf32 == "on"
            for seed in args.seeds:
                name = f"learn_{tf32}_{seed}"
                with contextlib.redirect_stdout(io.StringIO()):
                    train([
                        "--dataset", "JIGSAWS", "--packed_dir", str(pack),
                        "--expt_savedir", str(d), "--expt_name", name,
                        "--batch_size", "4", "--num_workers", "2",
                        "--num_epochs", "8", "--save_freq", "100",
                        "--print_freq", "100", "--lr", "3e-3",
                        "--scheduler", "Constant",
                        "--loss_fns", "nll", "soft_jaccard",
                        "--loss_wts", "0.7", "0.3",
                        "--class_weights", "1", "50", "50", "50", "50",
                        "--input_height", "64", "--input_width", "64",
                        "--model_scale", "0.25", "--train_base_model",
                        "true", "--seed", str(seed),
                        "--device", args.device])
                losses = [s["value"] for s in map(json.loads, (
                    d / name / "logs" / "scalars.jsonl").read_text()
                    .splitlines()) if s["tag"] == "Training/Loss"]
                print(json.dumps({
                    "device": args.device, "tf32": tf32, "seed": seed,
                    "ratio": round(losses[-1] / losses[0], 4),
                    "losses": [round(v, 4) for v in losses]}), flush=True)


if __name__ == "__main__":
    main()
