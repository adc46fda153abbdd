"""Cells of the benchmark cut to a size a CPU test run holds: the same
configuration files, workloads and limits, with the frames at 256x256, the
base at a sixteenth of its widths, 2 RAFT iterations and short videos. The
tracking cells are held out of ``BENCHMARK.json`` (PERF.md, Open questions)
and are built here from their files."""

from __future__ import annotations

import copy

import torch

from portbench import manifest

#: the tracking cells held out of BENCHMARK.json, and their configurations
HELD = {"track.basic-raft.s1": "ternausnet16-multi-basic-raft",
        "track.basic.s1": "ternausnet16-multi-basic",
        "track.basic-raft.s4": "ternausnet16-multi-basic-raft"}


def held_cell(name):
    """A held tracking cell from its files, as ``manifest.cell`` builds a
    listed one."""
    here = manifest.HERE
    wl = manifest.load_json(here / "workloads" / f"{name}.json")
    entry = {"name": name, "config": HELD[name], "traffic": wl["traffic"],
             "chips": 1}
    return manifest.Cell(
        name, entry, wl, manifest.load_json(here / "limits" / f"{name}.json"),
        manifest.load_json(here / "configs" / f"{HELD[name]}.json"), [], [])


def tiny_cell(name="track.basic-raft.s1", streams=None, video_frames=12):
    cell = held_cell(name) if name in HELD else manifest.cell(name)
    conf = copy.deepcopy(cell.config)
    wl = dict(cell.workload, clip_frames=16, video_frames=video_frames)
    wl["scene"] = dict(wl["scene"], scale=1)
    lim = copy.deepcopy(cell.limits)
    if "model" in conf:
        m = conf["model"]
        m.update(height=256, width=256, model_scale=0.0625)
        conf["tracker"].update(input_height=256, input_width=256)
        lim["sample"] = {"below": 8, "decode_steps": 4, "maps_steps": 2}
    if conf.get("flow"):
        conf["flow"] = dict(conf["flow"], iters=2)
    if "model" not in conf:  # RAFT alone
        conf["flow"].update(height=128, width=128)
        lim["sample"] = {"below": 8, "pairs": 4}
    if streams:
        wl["streams"] = streams
    return manifest.Cell(cell.name, cell.entry, wl, lim, conf,
                         cell.end_to_end, cell.per_layer)


def dry_run(cell, seed=7, videos=1, pairs=8):
    """The cell's runner on the CPU (the plain paths of the port's kernels):
    set-up, ``videos`` whole videos (tracking) or ``pairs`` pairs (flow) as
    the window, the check."""
    import importlib

    runner = importlib.import_module(
        f"portbench.runners.{cell.workload['runner']}")
    ctx = {"cell": cell, "device": torch.device("cpu"), "seed": seed,
           "seconds": 0.0, "videos": videos, "pairs": pairs, "trace": False,
           "t0": 0.0}
    return runner.run(ctx)
