"""Offline optical-flow precompute (counterpart of
``mfcnet_tpu/cli/generate_opticalflow.py``; reference
scripts/generate_opticalflow_raft.py and generate_opticalflow_unflow.py,
one CLI with ``--optflow_model {RAFT,UnFlow}``).

Walks a dataset's ``images/`` directories in order, computes the flow
between each consecutive frame pair (the first frame of each video gets
zero flow -- reference generate_opticalflow_raft.py:67-68), and writes
``.flo`` files plus optional color visualizations into a sibling
directory.

Same flags as the JAX CLI, plus ``--device``: the provider runs on the
card; ``--device cpu`` asks for the CPU, and without a card the default is
an error. ``--load_wts_model`` takes a ``.pth`` state_dict (torchvision
``raft_large`` or the reference UnFlow checkpoint; both load by name);
without it the provider keeps seeded random weights. ``cv2`` is imported
only where images are read and written: :func:`flow_pairs`, the batched
provider forward, takes uint8 arrays.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from mfcnet_tpu_torch.data.files import get_dataset_filenames
from mfcnet_tpu_torch.data.masks import write_flo
from mfcnet_tpu_torch.utils.vis import flow_to_color


def build_parser():
    p = argparse.ArgumentParser(
        description="Offline optical-flow precompute (PyTorch)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--dataset", type=str, default="JIGSAWS",
                   choices=["MICCAI2015", "MICCAI2017", "JIGSAWS"])
    p.add_argument("--mode", type=str, default="training",
                   choices=["training", "testing"])
    p.add_argument("--optflow_model", type=str, default="RAFT",
                   choices=["RAFT", "UnFlow"])
    p.add_argument("--optflow_dir", type=str, default=None,
                   help="Output dir name replacing 'images' "
                        "(default optflow_<model>)")
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--load_wts_model", type=str, default=None,
                   help="Flow-model weights (.pth state_dict)")
    p.add_argument("--save_viz", type=lambda v: v.lower() in ("true", "1"),
                   default=True)
    p.add_argument("--raft_iters", type=int, default=12)
    p.add_argument("--batch", type=int, default=1,
                   help="frame pairs per provider forward (every op in "
                        "both providers is per-sample at eval, so results "
                        "are the same for any batch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def build_provider(name: str, height: int, width: int, raft_iters: int = 12,
                   weights=None, device="cuda"):
    """The frozen float32 flow provider of the CLI on ``device``: ``RAFT``
    (raft_large) or ``UnFlow``, seeded random weights unless ``weights``
    names a ``.pth`` state_dict."""
    from mfcnet_tpu_torch.models import init_weights

    if name == "RAFT":
        from mfcnet_tpu_torch.models.raft import RAFT

        if height % 8 or width % 8:
            raise SystemExit(
                f"--input_height/--input_width must be divisible by 8 for "
                f"RAFT (got {height}x{width}); torchvision raft_large has "
                f"the same requirement")
        model = RAFT(iters=raft_iters, input_hw=(height, width))
    elif name == "UnFlow":
        from mfcnet_tpu_torch.models.unflow import UnFlow

        try:
            UnFlow.check_size(height, width)
        except ValueError as e:
            raise SystemExit(str(e))
        model = UnFlow()
    else:
        raise ValueError(f"unknown flow provider {name!r}")
    init_weights(model, torch.Generator().manual_seed(0))
    if weights:
        from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
            load_reference_state_dict,
        )

        model.load_state_dict(load_reference_state_dict(weights))
    return model.to(device).eval()


@torch.no_grad()
def flow_pairs(model, prev_u8, curr_u8):
    """One batched provider forward: (N, H, W, 3) uint8 RGB frame pairs
    (numpy) -> (N, H, W, 2) float32 flow (numpy), on the model's device."""
    dev = next(model.parameters()).device
    a = torch.as_tensor(prev_u8).to(dev).float() / 255.0
    b = torch.as_tensor(curr_u8).to(dev).float() / 255.0
    return model(a, b).float().cpu().numpy()


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_name = args.optflow_dir or f"optflow_{args.optflow_model.lower()}"
    H, W = args.input_height, args.input_width
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")
    model = build_provider(args.optflow_model, H, W, args.raft_iters,
                           args.load_wts_model, args.device)
    import cv2

    BATCH = max(1, args.batch)
    n_written = 0
    files, _ = get_dataset_filenames(args.dataset, args.data_dir, args.mode)

    def emit(path, flow):
        nonlocal n_written
        out_flo = Path(
            str(path).replace("images", out_name)
        ).with_suffix(".flo")
        out_flo.parent.mkdir(parents=True, exist_ok=True)
        write_flo(out_flo, flow)
        if args.save_viz:
            cv2.imwrite(str(out_flo.with_suffix(".png")),
                        cv2.cvtColor(flow_to_color(flow), cv2.COLOR_RGB2BGR))
        n_written += 1
        if n_written % 100 == 0:
            print(f"[{n_written}/{len(files)}] {out_flo}")

    pending = []  # (path, prev_arr, curr_arr) pairs awaiting one forward

    def flush():
        if not pending:
            return
        n = len(pending)
        # pad the final partial chunk to the batch shape with its last pair
        prevs = np.stack([p for _, p, _ in pending]
                         + [pending[-1][1]] * (BATCH - n))
        currs = np.stack([c for _, _, c in pending]
                         + [pending[-1][2]] * (BATCH - n))
        flows = flow_pairs(model, prevs, currs)
        for i in range(n):
            emit(pending[i][0], flows[i])
        pending.clear()

    prev_path = None
    prev_arr = None
    for path in files:
        curr = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        curr = cv2.resize(curr, (W, H))
        if prev_path is None or path.parent != prev_path.parent:
            # per-video first frame: zero flow (emitted in file order)
            flush()
            emit(path, np.zeros((H, W, 2), np.float32))
        else:
            pending.append((path, prev_arr, curr))
            if len(pending) == BATCH:
                flush()
        prev_path, prev_arr = path, curr
    flush()
    print(f"Wrote {n_written} flow files under '{out_name}'")
    return n_written


if __name__ == "__main__":
    main()
