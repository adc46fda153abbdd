"""Training and testing parsers (counterpart of
``mfcnet_tpu/configs/parsers.py``; reference configs/config_multiframe.py
and configs/config_toolposeseg.py): the JAX package's flag names and
defaults, plus ``--device``. Boolean flags take true/false/1/0/yes/no;
``-c FILE`` reads ``key = value`` lines (command-line flags win). The
testing parsers (the infer CLIs') default to mode ``testing`` and 75
frames a video and add ``--save_output_freq`` and ``--use_ema`` in place
of the training flags.

``--multihost true`` trains data-parallel over ``torch.distributed``
(``parallel/dist.py``; one process per card under ``torchrun``, with
``--batch_size`` per process). Flags that the port leaves out
(``--spatial_shards`` > 1, ``--ckpt_backend orbax``) are accepted and
raise in the CLI, naming ROADMAP item 12 and the reason. ``--remat True`` rematerializes a TernausNet
or TAPNet base's segments in training (``torch.utils.checkpoint``). ``--pretrained True`` logs
the JAX package's warning and runs on the model's own initialization:
neither package downloads weights.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

SINGLEFRAME_MODELS = ["TernausNet11", "TernausNet16", "TAPNet11", "TAPNet16",
                      "DeepLab_v3", "FCN", "HRNet", "SegFormer", "UNet",
                      "ResUNet"]
MULTIFRAME_MODELS = [
    f"{fam}Multi-{var}"
    for fam in ("TernausNet", "DeepLab", "FCN", "SegFormer", "HRNet", "UNet",
                "ResUNet")
    for var in ("Basic", "Large")
]


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


class _ConfigFileParser(argparse.ArgumentParser):
    """ArgumentParser with a ``-c FILE`` of ``key = value`` lines."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.add_argument("-c", "--config", type=str, default=None,
                          help="config file with 'key = value' lines")

    def parse_args(self, args=None, namespace=None):
        args = list(sys.argv[1:] if args is None else args)
        ns, _ = super().parse_known_args(args=args, namespace=namespace)
        if ns.config:
            file_args = []
            for line in Path(ns.config).read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                key, _, val = line.partition("=")
                file_args.append(f"--{key.strip()}")
                file_args.extend(val.split())
            args = file_args + args
        return super().parse_args(args=args, namespace=namespace)


def _add_flags(p, multiframe: bool, train: bool = True):
    g = p.add_argument_group("dataset")
    g.add_argument("--data_dir", type=str, default="./data")
    g.add_argument("--dataset", type=str, default="MICCAI2017",
                   choices=["MICCAI2015", "MICCAI2017", "JIGSAWS"])
    g.add_argument("--fold_index", type=int, default=-1,
                   choices=[-1, 0, 1, 2, 3])
    g.add_argument("--prediction_task", type=str,
                   default="toolpose_segmentation",
                   choices=["tooltip_segmentation", "toolpose_segmentation",
                            "endovis15_segmentation", "binary"])
    g.add_argument("--mode", type=str,
                   default="training" if train else "testing",
                   choices=["training", "testing"])
    g.add_argument("--num_frames_per_video", type=int,
                   default=225 if train else 75)
    if multiframe:
        g.add_argument("--num_input_frames", type=int, default=3)
    if train or multiframe:
        g.add_argument("--packed_dir", type=str, default=None,
                       help="read packs (data/packed.py: train/ and val/, "
                            "or test/) instead of decoding the --data_dir "
                            "image tree")

    g = p.add_argument_group("io")
    g.add_argument("--expt_savedir", type=str, default="./")
    g.add_argument("--expt_name", type=str, default="expt")
    g.add_argument("--print_freq", type=int, default=10)
    if train:
        g.add_argument("--save_freq", type=int, default=10)
        g.add_argument("--multihost", type=str2bool, default=False)
        g.add_argument("--ckpt_backend", type=str, default="msgpack",
                       choices=["msgpack", "orbax"],
                       help="the port writes .pth checkpoints whatever the "
                            "value; orbax raises")
        g.add_argument("--debug", type=str2bool, default=False)
    else:
        g.add_argument("--save_output_freq", type=int, default=10,
                       help="write an overlay PNG of every N-th sample "
                            "(0: none)")

    g = p.add_argument_group("optimizer")
    g.add_argument("--batch_size", type=int, default=8 if multiframe else 4)
    g.add_argument("--num_workers", type=int, default=4)
    g.add_argument("--num_classes", type=int, default=5)
    g.add_argument("--metric_fns", type=str, nargs="+",
                   default=["iou", "dice"], choices=["iou", "dice"])
    if train:
        g.add_argument("--loss_fns", type=str, nargs="+", default=["nll"],
                       choices=["mse", "nll", "soft_jaccard"])
        g.add_argument("--loss_wts", type=float, nargs="+", default=[1.0])
        g.add_argument("--lr", type=float,
                       default=1e-4 if multiframe else 3e-5)
        g.add_argument("--scheduler", type=str, default="StepDecay",
                       choices=["StepDecay", "Constant"])
        g.add_argument("--num_epochs", type=int, default=10)
        g.add_argument("--class_weights", type=float, nargs="+",
                       default=[1, 100, 100, 100, 100])
        g.add_argument("--grad_accum", type=int, default=1,
                       help="average the gradients of N micro-batches per "
                            "optimizer update; the schedule counts updates")
        g.add_argument("--ema_decay", type=float, default=0.0,
                       help="keep an EMA of the parameters (e.g. 0.999), "
                            "saved as the checkpoint's 'ema'; 0 disables")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--resume", type=str2bool, default=False)
    if train:
        g.add_argument("--starting_epoch", type=int, default=0)

    g = p.add_argument_group("model")
    if multiframe:
        g.add_argument("--model_type", type=str,
                       default="TernausNetMulti-Basic",
                       choices=MULTIFRAME_MODELS)
        g.add_argument("--train_base_model", type=str2bool, default=False)
        g.add_argument("--load_wts_base_model", type=str, default=None,
                       help="the base's single-frame .pth (state_dict or "
                            "{model: ...}), e.g. a checkpoint of "
                            "train_toolpose_segmentation")
    else:
        g.add_argument("--model_type", type=str, default="TernausNet16",
                       choices=SINGLEFRAME_MODELS)
    g.add_argument("--pretrained", type=str2bool, default=False,
                   help="accepted for the reference's command lines: logs "
                        "a warning and runs on the model's own "
                        "initialization (no download; load converted "
                        "weights with --load_wts_model)")
    g.add_argument("--load_wts_model", type=str, default=None)
    if not train:
        g.add_argument("--use_ema", type=str2bool, default=False,
                       help="evaluate the checkpoint's EMA weights "
                            "(written by training with --ema_decay)")
    g.add_argument("--input_height", type=int, default=480)
    g.add_argument("--input_width", type=int, default=640)
    if multiframe:
        g.add_argument("--add_optflow_inputs", type=str2bool, default=False)
        g.add_argument("--optflow_model", type=str, default="RAFT",
                       choices=["RAFT", "FlowFormerPlusPlus", "UnFlow"])
        g.add_argument("--load_wts_flow_model", type=str, default=None,
                       help="torchvision raft_large .pth (or the UnFlow "
                            "reference checkpoint); without it the frozen "
                            "provider keeps seeded random weights")
        g.add_argument("--add_depth_inputs", type=str2bool, default=False)
        g.add_argument("--parity_grid", type=str2bool, default=True)
    g.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    g.add_argument("--spatial_shards", type=int, default=1)
    g.add_argument("--model_scale", type=float, default=1.0,
                   help="uniform channel-width scale (< 1 for smoke tests)")
    if train:
        g.add_argument("--remat", type=str2bool, default=False)
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def multiframe_train_parser() -> argparse.ArgumentParser:
    return _add_flags(_ConfigFileParser(), multiframe=True)


def multiframe_test_parser() -> argparse.ArgumentParser:
    return _add_flags(_ConfigFileParser(), multiframe=True, train=False)


def toolposeseg_train_parser() -> argparse.ArgumentParser:
    return _add_flags(_ConfigFileParser(), multiframe=False)


def toolposeseg_test_parser() -> argparse.ArgumentParser:
    return _add_flags(_ConfigFileParser(), multiframe=False, train=False)


#: why ``--spatial_shards`` > 1 has no counterpart: the training, infer and
#: tracking CLIs raise with it
SPATIAL_SHARDS_LEFT_OUT = (
    "ROADMAP.md Queue 1 item 12: the JAX package's GSPMD split of the image "
    "height over several devices is left out of the port (one card runs a "
    "whole frame; data parallelism and the tracker's stream_shards scale "
    "over cards)")

#: flag -> (value that means "not used", why the port has no counterpart)
LEFT_OUT_FLAGS = {
    "spatial_shards": (1, SPATIAL_SHARDS_LEFT_OUT),
    "ckpt_backend": ("msgpack", "ROADMAP.md Queue 1 item 12 (orbax "
                                "checkpoints: the port writes the "
                                "reference's .pth)"),
}


def check_ported(args):
    """Raise SystemExit for a flag that the port leaves out, naming its
    ROADMAP item (a flag the parser does not have is not used); log the JAX
    package's warning for ``--pretrained``
    (``mfcnet_tpu/models/__init__.py:52-57``)."""
    for flag, (unused, why) in LEFT_OUT_FLAGS.items():
        value = getattr(args, flag, unused)
        if value != unused:
            raise SystemExit(f"--{flag} {value}: {why}")
    if args.pretrained:
        logging.getLogger(__name__).warning(
            "pretrained=True: supply converted weights via "
            "mfcnet_tpu_torch.compat or --load_wts_model (no network "
            "egress; the flag does not download torchvision/timm "
            "checkpoints)")
