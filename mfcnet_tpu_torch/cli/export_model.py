"""Export a trained model as a serving artifact (counterpart of
``mfcnet_tpu/cli/export_model.py``): one ``torch.export`` file with the
weights in it, which ``mfcnet_tpu_torch.serve.load_exported`` loads and
runs without the model code or the checkpoint, and which the tracking
CLIs take as ``--artifact``.

    python -m mfcnet_tpu_torch.cli.export_model \\
        --model_type TernausNetMulti-Basic --num_input_frames 3 \\
        --input_height 480 --input_width 640 \\
        --load_wts_model expts/mfc/ckpts/model_020.pth \\
        --output expts/mfc/serve/mfcnet.pt2

``--load_wts_model`` takes a reference ``.pth`` or a checkpoint of the
port's trainers, read as the tracking CLI reads it (``--use_ema True``: its
EMA weights); ``--load_wts_flow_model`` RAFT's ``.pth`` (without it the
provider keeps its seeded random weights, as in the tracking CLI). A
bfloat16 artifact with ``--add_optflow_inputs`` carries the fused RAFT
update step and the flow warp as the registered operators whose CUDA
kernels are the port's. The artifact is built on ``--device`` (the card by
default; ``cpu`` asks for the CPU) and runs on that device type only.
``--validate`` reloads it and holds it within 1e-5 of the live serving
module on random frames.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
    check_device,
    load_reference_state_dict,
)


def _bool(v):
    return v.lower() in ("true", "1", "yes")


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a serving artifact (torch.export)")
    p.add_argument("--task", type=str, default="multiframe",
                   choices=["multiframe", "singleframe"],
                   help="'singleframe': a per-frame segmentation model "
                        "(TernausNet16, HRNet, ...); TAPNet is not "
                        "exportable (host attention-map pipeline)")
    p.add_argument("--model_type", type=str,
                   default="TernausNetMulti-Basic")
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--num_input_frames", type=int, default=3)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--model_scale", type=float, default=1.0)
    p.add_argument("--load_wts_model", type=str, required=True,
                   help="reference .pth checkpoint to export")
    p.add_argument("--use_ema", type=_bool, default=False,
                   help="export the checkpoint's EMA weights")
    p.add_argument("--add_depth_inputs", type=_bool, default=False)
    p.add_argument("--add_optflow_inputs", type=_bool, default=False,
                   help="put the frozen RAFT flow provider into the graph "
                        "(reference v3:264-271 semantics)")
    p.add_argument("--load_wts_flow_model", type=str, default=None,
                   help="torchvision raft_large .pth (state_dict)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--serving_mode", type=str, default="full",
                   choices=["full", "incremental"],
                   help="'full': the stateless window forward (T frames -> "
                        "probabilities); 'incremental': the tracking step "
                        "with explicit ring state, one base forward a frame "
                        "(start streams from serve.zero_state; not with "
                        "--add_optflow_inputs)")
    p.add_argument("--batch", type=str, default="dynamic",
                   help="'dynamic' (a symbolic batch of 1 to 64: one "
                        "artifact, any batch size up to 64) or an integer")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--validate", type=_bool, default=True,
                   help="reload the artifact and hold it to the live "
                        "serving module on random frames")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu: the "
                        "device type the artifact is built for")
    return p


def _models(args, log):
    """(model, output mode or None, flow provider or None) with the
    checkpoint's weights."""
    from mfcnet_tpu_torch.models import (
        OUTPUT_MODES,
        get_multiframe_segmentation_model,
        get_tooltip_segmentation_model,
    )

    T, H, W = args.num_input_frames, args.input_height, args.input_width
    output_mode = flow_model = None
    if args.task == "singleframe":
        output_mode = OUTPUT_MODES.get(args.model_type)
        if output_mode is None:
            raise SystemExit(f"--task singleframe: unknown model type "
                             f"{args.model_type}")
        if output_mode == "tapnet":
            raise SystemExit(
                "TAPNet is not exportable: its motion-prior attention-map "
                "input comes from the host warp pipeline (data/attmap.py)")
        model = get_tooltip_segmentation_model(
            args.model_type, args.num_classes, scale=args.model_scale)
    else:
        model = get_multiframe_segmentation_model(
            args.model_type, num_classes=args.num_classes,
            num_input_frames=T, add_optflow_inputs=args.add_optflow_inputs,
            add_depth_inputs=args.add_depth_inputs, scale=args.model_scale)
    model.load_state_dict(load_reference_state_dict(args.load_wts_model,
                                                    args.use_ema))
    log.info("Loaded %s%s", args.load_wts_model,
             " (EMA weights)" if args.use_ema else "")
    if args.add_optflow_inputs:
        from mfcnet_tpu_torch.models.raft import RAFT

        # the tracking CLI's provider: the same seed, the same weights
        torch.manual_seed(1)
        flow_model = RAFT(iters=12, input_hw=(H // 2, W // 2))
        if args.load_wts_flow_model:
            flow_model.load_state_dict(
                load_reference_state_dict(args.load_wts_flow_model))
    return model, output_mode, flow_model


def main(argv=None):
    from mfcnet_tpu_torch.serve import (
        export_incremental,
        export_serving,
        export_singleframe,
        load_exported,
        make_incremental_step,
        make_serving_fn,
        make_singleframe_serving_fn,
        save_exported,
        zero_state,
    )
    from mfcnet_tpu_torch.utils.checkpoint import load_checkpoint

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    log = logging.getLogger("export_model")
    T, H, W = args.num_input_frames, args.input_height, args.input_width
    if args.task == "singleframe":
        if args.add_depth_inputs or args.add_optflow_inputs:
            raise SystemExit("--task singleframe has no depth/flow inputs")
        if args.serving_mode != "full":
            raise SystemExit(
                "--task singleframe is stateless (--serving_mode full)")
    elif args.serving_mode == "incremental" and args.add_optflow_inputs:
        raise SystemExit(
            "--serving_mode incremental does not support in-graph flow "
            "(use --serving_mode full)")
    check_device(args.device)
    model, output_mode, flow_model = _models(args, log)

    batch = None if args.batch == "dynamic" else int(args.batch)
    dev = args.device
    dt = args.compute_dtype
    meta = {
        "task": args.task,
        "model_type": args.model_type,
        "num_classes": args.num_classes,
        "num_input_frames": 1 if args.task == "singleframe" else T,
        "input_height": H,
        "input_width": W,
        "compute_dtype": dt,
        "add_depth_inputs": args.add_depth_inputs,
        "add_optflow_inputs": args.add_optflow_inputs,
        "serving_mode": args.serving_mode,
        "checkpoint": str(args.load_wts_model),
        "epoch": load_checkpoint(args.load_wts_model)[1],
        "ema": bool(args.use_ema),
    }
    if args.task == "singleframe":
        exported = export_singleframe(
            model, height=H, width=W, output_mode=output_mode, dtype=dt,
            batch=batch, device=dev)
        meta["output_mode"] = output_mode
    elif args.serving_mode == "incremental":
        exported, state_spec = export_incremental(
            model, height=H, width=W, num_frames=T,
            num_classes=args.num_classes, dtype=dt,
            add_depth_inputs=args.add_depth_inputs, batch=batch, device=dev)
        meta["state"] = {k: [list(shape), d]
                         for k, (shape, d) in state_spec.items()}
    else:
        exported = export_serving(
            model, height=H, width=W, num_frames=T, dtype=dt,
            add_depth_inputs=args.add_depth_inputs, flow_model=flow_model,
            batch=batch, device=dev)
    header = save_exported(args.output, exported, meta=meta)
    size = Path(args.output).stat().st_size
    log.info("Wrote %s (%.1f MB, device %s, in %s)", args.output, size / 1e6,
             header["device"], header["in_specs"])

    if args.validate:
        loaded = load_exported(args.output, device=dev)
        rng = np.random.default_rng(0)
        B = 1 if batch is None else batch

        def u8(*shape):
            return torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

        with torch.no_grad():
            if args.task == "singleframe":
                frame = u8(B, H, W, 3)
                live = make_singleframe_serving_fn(model, output_mode,
                                                   dtype=dt, device=dev)
                diff = (loaded(frame) - live(frame)).abs().max().item()
            elif args.serving_mode == "incremental":
                live, _ = make_incremental_step(
                    model, height=H, width=W, num_frames=T,
                    num_classes=args.num_classes, dtype=dt,
                    add_depth_inputs=args.add_depth_inputs, device=dev)
                state_a = zero_state(loaded.meta, batch=B)
                state_l = list(state_a)
                diff = 0.0
                for _ in range(T + 1):  # past the warm-up
                    inp = [u8(B, H, W, 3)]
                    if args.add_depth_inputs:
                        inp.append(u8(B, H, W))
                    *state_a, got = loaded(*state_a, *inp)
                    *state_l, want = live(*state_l, *inp)
                    diff = max(diff, (got - want).abs().max().item())
            else:
                inputs = [u8(B, T, H, W, 3)]
                if args.add_depth_inputs:
                    inputs.append(u8(B, T, H, W))
                live = make_serving_fn(
                    model, dtype=dt, add_depth_inputs=args.add_depth_inputs,
                    flow_model=flow_model, device=dev)
                diff = (loaded(*inputs) - live(*inputs)).abs().max().item()
        log.info("validate: max |artifact - live| = %.3e", diff)
        if not diff <= 1e-5:
            raise SystemExit(f"validation failed: the artifact diverges "
                             f"from the live serving module by {diff:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
