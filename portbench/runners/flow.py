"""The flow cells: the offline optical-flow precompute over recorded videos.

Set-up builds the provider as the flow CLI builds it
(``cli/generate_opticalflow.py::build_provider``), fills it with the seed's
float32 weights on the card, renders the seed's clip and runs the CLI's
batched forward twice on the cell's batch, so that every shape is warmed up.
The window then hands consecutive frame pairs of one video after another,
``batch`` pairs a call, to that forward (``flow_pairs``: uint8 frames in,
float32 flow on the host out), as the CLI does once it has read the frames,
until ``seconds`` have passed. The CLI's image reads and file writes are not
part of it.

After the window: the peak memory, the provider freed, the check
(``checks/flow.py``) of sampled pairs of the first video against the
reference.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np

from portbench.checks import flow as checks
from portbench.counts import flops as fc
from portbench.runners.track import _counters, _sample, float32_reference
from portbench.trace import read
from portbench.weights import seeded_weights


def inputs(cell, seed, dev):
    """The CLI's provider on the card holding the seed's weights, the
    weights by name (float32) and the seed's traffic."""
    import torch

    from mfcnet_tpu_torch.cli import generate_opticalflow as cli

    fl, wl = cell.config["flow"], cell.workload
    H, W = fl["height"], fl["width"]
    model = cli.build_provider("RAFT", H, W, fl["iters"], device=dev)
    weights = seeded_weights([("", model)], seed, dev, served=torch.float32)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            t.copy_(weights[name])
    gen = importlib.import_module(f"portbench.traffic.{wl['traffic']}")
    traffic = gen.make(dict(wl, streams=1), seed, H, W, dev)
    return model, weights, traffic


def sample_pairs(lim, seed):
    """The pairs of the first video (by the index of their second frame)
    whose flows the check keeps, drawn from the seed."""
    srng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x666C]))
    smp = lim["sample"]
    return _sample(srng, 1, smp["below"], smp["pairs"])


def run(ctx):
    """One run of a flow cell; returns the run's readings for the harness
    (``run.py``)."""
    import torch

    from mfcnet_tpu_torch.cli import generate_opticalflow as cli

    cell, dev, seed = ctx["cell"], ctx["device"], ctx["seed"]
    conf, lim = cell.config, cell.limits
    fl = conf["flow"]
    batch = int(fl["batch"])
    phases = {"imports": time.perf_counter() - ctx["t0"]}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    model, weights, traffic = inputs(cell, seed, dev)
    if dev.type == "cuda":  # the peak is the window's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    phase("weights_and_traffic")
    clip, index = traffic["clip"], traffic["index"]
    n_pairs = traffic["video_frames"] - 1

    def frames(ks):
        """(prev, curr) stacks of the pairs ending at frames ``ks``, padded
        to the batch with the last pair as the CLI pads its last chunk."""
        ks = list(ks) + [ks[-1]] * (batch - len(ks))
        return (np.stack([clip[index(0, k - 1)] for k in ks]),
                np.stack([clip[index(0, k)] for k in ks]))

    for _ in range(2):
        cli.flow_pairs(model, *frames(range(1, 1 + batch)))
    slices = []
    if ctx["trace"] and dev.type == "cuda":
        from portbench.trace import Slice, schedule

        # the profiler's first session starts slowly: not in the window
        s = Slice(_counters)
        s.start()
        cli.flow_pairs(model, *frames(range(1, 1 + batch)))
        s.stop()
    phase("warm_up")

    sampled = set(sample_pairs(lim, seed))
    kept = {}
    seconds = float(ctx["seconds"])
    t_start = time.perf_counter()
    t_end = t_start + seconds
    if ctx["trace"] and dev.type == "cuda":
        slices = schedule(_counters, t_start, seconds)

    def chunks():
        """(video, the pairs of one call) of one video after another."""
        v = 0
        while True:
            for k0 in range(1, n_pairs + 1, batch):
                yield v, list(range(k0, min(k0 + batch, n_pairs + 1)))
            v += 1

    todo, current = list(slices), None
    handed, t_last = 0, t_start
    fixed = ctx.get("pairs")  # tests: that many pairs, whatever the time
    for v, ks in chunks():
        now = time.perf_counter()
        if (handed >= fixed) if fixed else (now >= t_end):
            break
        if current is not None and now >= current.t1:
            current.stop()
            current = None
        if current is None and todo and now >= todo[0].t0:
            current = todo.pop(0)
            current.start()
        flows = cli.flow_pairs(model, *frames(ks))
        t_last = time.perf_counter()
        handed += len(ks)
        if current is not None:
            current.frames += len(ks)
        for i, k in enumerate(ks):
            if v == 0 and k in sampled:
                kept[k] = flows[i].copy()
    if current is not None:
        current.stop()
    if fixed:
        seconds = t_last - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {
        "setup_s": t_start - ctx["t0"],
        "window_s": seconds,
        # every pair handed in the window, over the time until the last of
        # their flows was on the host
        "flow_pairs_per_s": handed / max(t_last - t_start, 1e-9),
        "attempted": handed,
        "failed": 0,
        "memory_peak_bytes": int(peak),
        "flops_per_frame": fc.flow_pair_flops(fl["height"], fl["width"], fl),
        "setup_phases": phases,
    }
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["slices"], out["slice_notes"] = read(slices)
    with float32_reference():
        out["readings"] = checks.readings(weights, fl, traffic, kept,
                                          sorted(sampled), dev)
    return out


def control_readings(cell, seed, dev):
    """The control's readings of one seed: the reference one precision
    below the configuration's, in the program's place on the same sampled
    pairs, judged as the program is."""
    from portbench.reference.quant import BELOW

    fl = cell.config["flow"]
    model, weights, traffic = inputs(cell, seed, dev)
    del model
    pairs = sample_pairs(cell.limits, seed)
    q = BELOW[fl["dtype"]]
    with float32_reference():
        low = {k: checks.reference_flow(weights, fl, traffic, k, dev, q=q)
               for k in pairs}
        return checks.readings(weights, fl, traffic, low, pairs, dev)
