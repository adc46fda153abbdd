"""Time one checkout's live paths on the card, to compare two checkouts.

    python tools/live_ab.py --root CHECKOUT [--calls 2] [--skip_train]
        [--out FILE]

Imports ``mfcnet_tpu_torch`` from CHECKOUT (its kernels build into
CHECKOUT/build at first use) and times, at 480x640 in bfloat16 with seeded
random weights:

- the live RAFT engine (``InferenceEngine``: TernausNetMulti-Basic with
  RAFT x12 through the fused update step, incremental mode, device decode,
  no tie fallback) in frames/s over 48 frames, one stream and four streams
  in lockstep (24 frames each), every one of ``--calls`` calls each (the
  first includes the warm-up);
- run A of the training CLI (``cli/train_multiframe_detection.py``: batch
  4, RAFT + depth in the step, base trained, bfloat16, grad_accum 2, EMA,
  six micro-steps on a synthetic pack): each micro-step's
  device-synchronized ms (not with ``--skip_train``).

Prints one JSON line (and appends it to ``--out``). Compare two checkouts
in one call on one card, each in a process of its own, in turns: parent,
change, change, parent.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

H, W, T, C = 480, 640, 3, 5
SEED = 0


def _train_args(pack, out):
    return ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
            "--expt_savedir", str(out), "--expt_name", "A",
            "--batch_size", "4", "--num_workers", "4", "--num_epochs", "0",
            "--print_freq", "100", "--input_height", str(H),
            "--input_width", str(W), "--add_optflow_inputs", "True",
            "--add_depth_inputs", "True", "--loss_fns", "nll",
            "soft_jaccard", "--loss_wts", "0.7", "0.3", "--seed", str(SEED),
            "--train_base_model", "True", "--compute_dtype", "bfloat16",
            "--grad_accum", "2", "--ema_decay", "0.999"]


def live_engine_fps(calls):
    """{streams: [frames/s of each call]} of the live RAFT engine."""
    import torch

    from mfcnet_tpu_torch.data.synthetic import make_synthetic_frames
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frame_streams,
        track_on_frames,
    )

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        generator=gen)
    raft = init_weights(RAFT(iters=12), gen)
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    frames = make_synthetic_frames(48, H, W, seed=SEED)
    streams = [make_synthetic_frames(24, H, W, seed=SEED + b)
               for b in range(4)]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        one = InferenceEngine(model, cfg, flow_model=raft)
        out["1"] = [track_on_frames(frames, None, cfg, d, name=f"f{i}",
                                    engine=one)[1] for i in range(calls)]
        del one
        four = InferenceEngine(model, cfg, flow_model=raft, num_streams=4)
        names = [f"s{b}" for b in range(4)]
        out["4"] = [track_on_frame_streams(streams, None, cfg, d,
                                           names=names, engine=four)[1]
                    for _ in range(calls)]
    torch.cuda.synchronize()
    return out


def train_run_a_ms():
    """Device-synchronized ms of each of run A's micro-steps."""
    import torch

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    times = []
    real = cli.make_multiframe_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    cli.make_multiframe_train_step = make
    try:
        with tempfile.TemporaryDirectory() as d:
            d = Path(d)
            pack = make_synthetic_pack(d / "pack", videos=(
                ("train", 3, 8), ("val", 1, 4)), height=H, width=W,
                seed=SEED)
            cli.main(_train_args(pack, d))
    finally:
        cli.make_multiframe_train_step = real
    return times


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True,
                   help="the checkout whose mfcnet_tpu_torch is timed")
    p.add_argument("--calls", type=int, default=2,
                   help="timed calls of each live engine")
    p.add_argument("--skip_train", action="store_true",
                   help="time the live engine only")
    p.add_argument("--out", default=None, help="a JSON-lines file to extend")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import mfcnet_tpu_torch

    if Path(mfcnet_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {mfcnet_tpu_torch.__file__}, not the "
                         f"package of {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    rec = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "live_raft_fps": live_engine_fps(args.calls),
           "train_run_a_ms": None if args.skip_train else train_run_a_ms()}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
