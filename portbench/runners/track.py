"""The tracking cells: recorded videos through the port's tracking loop.

Set-up builds the cell's models on the ``meta`` device, fills them with the
seed's weights on the card, renders the seed's clip, builds one
``InferenceEngine`` (``num_streams`` videos in lockstep, the configuration's
``TrackerConfig``) and tracks a few frames through the loop, so that every
shape is warmed up and the fused step is captured. The window then tracks
one video after another through ``track/tracker.py::_track_streams`` (via
``track_on_frames`` for one stream), each from an engine ``reset``, until
``seconds`` have passed: the frame source stops handing frames then, and
the loop drains what it has. The benchmark's own spans wrap the engine's
``step_async`` (a frame handed to the engine) and the tracker's
``update_device`` (its keypoint row on the host).

After the window: the peak memory, the engine freed, the check
(``checks/track.py``) on the same frames and weights.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import os
import shutil
import tempfile
import time

import numpy as np

from portbench.checks import track as checks
from portbench.counts import flops as fc
from portbench.trace import read
from portbench.weights import load_into, seeded_weights


class Recorder:
    """Spans of one window: when each step was handed to the engine, how
    long ``step_async`` held the host, when each frame's row reached the
    host; the keypoints of every frame and the sampled steps' outputs."""

    def __init__(self, streams, maps_steps, decode_steps):
        self.B = streams
        self.maps_steps, self.decode_steps = set(maps_steps), set(
            decode_steps)
        self.active = False
        self.video = -1
        self.k = 0
        self.pending = collections.deque()
        self.latency, self.arrival = [], []
        self.dispatch_s, self.dispatch_frames = 0.0, 0
        self.rows_expected = 0
        self.kps = []            # per video, per stream: [kps or None]
        self.samples = {}        # step -> kept outputs (video 0)
        self.slices, self.slice = [], None

    def new_video(self, v):
        self.video = v
        self.kps.append([[] for _ in range(self.B)])

    def on_reset(self):
        self.k = 0

    def tick(self, now):
        """Start or stop the profiler slices the trace run scheduled."""
        if self.slice is not None and now >= self.slice.t1:
            self.slice.stop()
            self.slice = None
        if self.slice is None and self.slices and now >= self.slices[0].t0:
            self.slice = self.slices.pop(0)
            self.slice.start()

    def on_step(self, t_in, t_out, out, engine):
        if not self.active:
            return
        if self.slice is not None:
            self.slice.frames += self.B
        else:  # the host's spans, away from the profiler's cost
            self.dispatch_s += t_out - t_in
            self.dispatch_frames += self.B
        k = self.k
        self.k += 1
        for b in range(self.B):
            self.kps[-1][b].append(None)
        if out is None:
            return
        self.rows_expected += self.B
        self.pending.append([t_in, 0, k])
        if self.video == 0 and k in self.decode_steps:
            keep = {"out": out}
            if k in self.maps_steps:
                flow = engine.flow_state
                keep["seg"] = engine.seg_buf.clone()
                keep["flow"] = (None if flow is None else
                                tuple(t.clone() for t in flow))
            self.samples[k] = keep

    def on_row(self, kps):
        if not self.active:
            return
        t = time.perf_counter()
        entry = self.pending[0]
        self.latency.append(t - entry[0])
        self.arrival.append(t)
        self.kps[-1][entry[1]][entry[2]] = np.array(kps, copy=True)
        entry[1] += 1
        if entry[1] == self.B:
            self.pending.popleft()


class TimedEngine:
    """The engine as the tracking loop sees it, with the recorder's spans
    around ``step_async``."""

    def __init__(self, engine, rec, record_function=None):
        self.engine, self.rec = engine, rec
        self.cfg, self.mode = engine.cfg, engine.mode
        self.device, self.num_streams = engine.device, engine.num_streams
        self._rf = record_function

    def reset(self):
        self.engine.reset()
        self.rec.on_reset()

    def step_async(self, frame_u8, depth_u8=None):
        self.rec.tick(time.perf_counter())
        t_in = time.perf_counter()
        if self._rf is not None:
            with self._rf("portbench.step_async"):
                out = self.engine.step_async(frame_u8, depth_u8)
        else:
            out = self.engine.step_async(frame_u8, depth_u8)
        self.rec.on_step(t_in, time.perf_counter(), out, self.engine)
        return out


class _Video:
    """One stream's video as the loop reads it: ``video_frames`` long, its
    frames handed until ``deadline``."""

    def __init__(self, traffic, deadline):
        self.t, self.deadline = traffic, deadline

    def __len__(self):
        return self.t["video_frames"]

    def __iter__(self):
        clip = self.t["clip"]
        for k in range(len(self)):
            if time.perf_counter() >= self.deadline:
                return
            yield clip[self.t["index"](0, k)]


def _sample(rng, lo, hi, n):
    return sorted(int(v) for v in rng.choice(np.arange(lo, hi), n,
                                             replace=False))


def _counters():
    from mfcnet_tpu_torch.ops._build import COUNTERS

    out = {}
    for c in COUNTERS:
        out.update(c)
    return out


def inputs(cell, seed, dev):
    """The cell's models on the card holding the seed's weights, the
    weights by name (float32, the served values) and the seed's traffic."""
    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.raft import RAFT

    conf, wl = cell.config, cell.workload
    m, fl = conf["model"], conf.get("flow")
    T, C, H, W = m["num_frames"], m["num_classes"], m["height"], m["width"]
    with torch.device("meta"):
        model = get_multiframe_segmentation_model(
            m["model_type"], C, T, add_optflow_inputs=bool(fl),
            scale=m.get("model_scale", 1.0))
        flow_model = (RAFT(iters=fl["iters"], corr_levels=fl["corr_levels"],
                           corr_radius=fl["corr_radius"],
                           input_hw=(H // 2, W // 2)) if fl else None)
    mods = [("", model)] + ([("", flow_model)] if fl else [])
    gen = importlib.import_module(f"portbench.traffic.{wl['traffic']}")
    traffic = gen.make(dict(wl, streams=int(wl.get("streams", 1))), seed, H,
                       W, dev)
    served = getattr(torch, conf["tracker"]["dtype"])
    weights = seeded_weights(mods, seed, dev, served=served)
    load_into(model, weights, "", dev)
    if fl:
        load_into(flow_model, weights, "", dev)
    return model, flow_model, weights, traffic


@contextlib.contextmanager
def float32_reference():
    """No gradients, and float32 products and convolutions in float32 (not
    TF32), for the reference; the program's settings after."""
    import torch

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def sample_steps(lim, seed, T):
    """The steps of the first video whose outputs the check keeps, drawn
    from the seed: (decode sample, its first ``maps_steps``)."""
    srng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x636B]))
    smp = lim["sample"]
    decode = _sample(srng, T - 1, smp["below"], smp["decode_steps"])
    return decode, decode[:smp["maps_steps"]]


def run(ctx):
    """One run of a tracking cell; returns the run's readings for the
    harness (``run.py``)."""
    import torch

    from mfcnet_tpu_torch.track import tracker as trk

    cell, dev, seed = ctx["cell"], ctx["device"], ctx["seed"]
    conf, wl, lim = cell.config, cell.workload, cell.limits
    m, fl = conf["model"], conf.get("flow")
    T, C, H, W = m["num_frames"], m["num_classes"], m["height"], m["width"]
    B = int(wl.get("streams", 1))
    phases = {"imports": time.perf_counter() - ctx["t0"]}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if dev.type == "cuda":
        from mfcnet_tpu_torch.ops._build import load

        load()  # the port's kernels: built into its build/ on a first run
    phase("kernels")
    model, flow_model, weights, traffic = inputs(cell, seed, dev)
    if dev.type == "cuda":  # the peak is the program's, not the draw's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    phase("weights_and_traffic")
    tcfg = trk.TrackerConfig(**conf["tracker"])
    engine = trk.InferenceEngine(model, tcfg, flow_model=flow_model,
                                 device=dev, num_streams=B)
    del model, flow_model
    phase("engine")
    decode_steps, maps_steps = sample_steps(lim, seed, T)
    rec = Recorder(B, maps_steps, decode_steps)
    rf = None
    if ctx["trace"]:
        from torch.profiler import record_function as rf
    timed = TimedEngine(engine, rec, rf)

    orig_update = trk.KeypointTracker.update_device

    def update_device(self, kps, *a, **kw):
        row = orig_update(self, kps, *a, **kw)
        rec.on_row(kps)
        return row

    trk.KeypointTracker.update_device = update_device
    outdir = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get(
        "TMPDIR"))
    clip = traffic["clip"]

    def video(v, deadline):
        """One video through the loop -> per-stream CSV rows."""
        if B == 1:
            rows, _ = trk.track_on_frames(_Video(traffic, deadline), None,
                                          tcfg, outdir, name=f"v{v}",
                                          engine=timed)
            return [rows]

        def steps():
            for k in range(traffic["video_frames"]):
                if time.perf_counter() >= deadline:
                    return
                yield (np.stack([clip[traffic["index"](b, k)]
                                 for b in range(B)]), None, list(range(B)))

        rows, _ = trk._track_streams(
            steps(), [traffic["video_frames"]] * B,
            [f"v{v}s{b}" for b in range(B)], timed, tcfg, outdir)
        return rows

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        _warm(trk, timed, T + 2, tcfg, outdir, B, clip)
        if ctx["trace"] and dev.type == "cuda":
            from portbench.trace import Slice

            # the profiler's first session starts slowly: not in the window
            s = Slice(_counters)
            s.start()
            timed.engine.step_async(clip[0] if B == 1 else np.stack(
                [clip[0]] * B))
            s.stop()
        sync()
        phase("warm_up")

        seconds = float(ctx["seconds"])
        t_start = time.perf_counter()
        t_end = t_start + seconds
        if ctx["trace"] and dev.type == "cuda":
            from portbench.trace import schedule

            rec.slices = schedule(_counters, t_start, seconds)
        done_slices = list(rec.slices)
        rec.active = True
        rows_by_video, v = [], 0
        # ``videos`` (tests): that many whole videos, whatever the time
        fixed = ctx.get("videos")
        while (v < fixed) if fixed else (time.perf_counter() < t_end):
            rec.new_video(v)
            rows_by_video.append(video(v, float("inf") if fixed else t_end))
            v += 1
        if fixed:
            t_end = time.perf_counter()
            seconds = t_end - t_start
        rec.active = False
        if rec.slice is not None:
            rec.slice.stop()
            rec.slice = None
        sync()
    finally:
        trk.KeypointTracker.update_device = orig_update
        shutil.rmtree(outdir, ignore_errors=True)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    # every frame handed in the window, over the time until the last of
    # their rows was on the host (the loop drains them after t_end)
    arrival = np.array(rec.arrival)
    t_last = float(arrival.max()) if len(arrival) else t_end
    lat_ms = np.array(rec.latency) * 1e3
    out = {
        "setup_s": t_start - ctx["t0"],
        "window_s": seconds,
        "frames_per_s": len(arrival) / max(t_last - t_start, 1e-9),
        "frame_latency_p95_ms": (float(np.percentile(lat_ms, 95))
                                 if len(lat_ms) else float("nan")),
        "attempted": rec.rows_expected,
        "failed": rec.rows_expected - len(rec.latency),
        "memory_peak_bytes": int(peak),
        "dispatch_s": rec.dispatch_s,
        "dispatch_frames": rec.dispatch_frames,
        "flops_per_frame": fc.track_frame_flops(fc.shapes_of(conf)),
        "raft_tokens": (B * (T - 1) * (H // 16) * (W // 16) if fl else 0),
        "videos": v,
        "setup_phases": phases,
    }

    # free the program before the reference runs
    samples, kps_by_video = rec.samples, rec.kps
    del timed, engine, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["slices"], out["slice_notes"] = read(done_slices)
    out["readings"] = readings(conf, weights, traffic, samples, kps_by_video,
                               rows_by_video, dev, decode_steps)
    return out


def _warm(trk, timed, n, tcfg, outdir, B, clip):
    """``n`` = T + 2 frames through the loop: the T - 1 eager frames, the
    first fused frame and its capture, two replays."""
    if B == 1:
        trk.track_on_frames([clip[i] for i in range(n)], None, tcfg, outdir,
                            name="warm", engine=timed)
        return
    trk._track_streams(((np.stack([clip[i]] * B), None, list(range(B)))
                        for i in range(n)), [n] * B,
                       [f"warm{b}" for b in range(B)], timed, tcfg, outdir)


def worst(a, b):
    """The larger reading; NaN if either is."""
    return a + b if np.isnan(a) or np.isnan(b) else max(a, b)


def readings(conf, weights, traffic, samples, kps_by_video, rows_by_video,
             dev, expected):
    """The numbers compared, from the kept outputs of the window; NaN where
    a sampled step (``expected``: the decode sample) never came."""
    T = conf["model"]["num_frames"]
    B = traffic["streams"]
    got = collections.defaultdict(float)
    bad = total = 0
    with float32_reference():
        ref = checks.Reference(weights, conf, traffic["clip"], dev)
        for k, keep in sorted(samples.items()):
            mask, kps, heats = keep["out"]
            if B == 1:
                mask, kps, heats = mask[None], kps[None], heats[None]
            for b in range(B):
                if "seg" in keep:
                    idx = [traffic["index"](b, k - t) for t in range(T)]
                    flow = keep["flow"]
                    fs = None if flow is None else tuple(t[b] for t in flow)
                    r = checks.window_readings(ref, idx, keep["seg"][b], fs,
                                               mask[b], heats[b])
                    for name, val in r.items():
                        got[name] = worst(got[name], val)
                nb, nt = checks.keypoint_mismatch(
                    mask[b], heats[b], kps[b],
                    conf["tracker"]["area_threshold"])
                bad, total = bad + nb, total + nt
    missing = len(set(expected) - set(samples))
    got["keypoints"] = bad / total if total and not missing else float("nan")
    if missing:
        for name in list(got):
            got[name] = float("nan")
    got["rows"] = float(sum(
        checks.rows_mismatch(kps_v[b], np.asarray(rows_v[b]),
                             conf["tracker"]["dist_threshold"])
        for kps_v, rows_v in zip(kps_by_video, rows_by_video)
        for b in range(B)))
    return dict(got)


def control_readings(cell, seed, dev):
    """The control's readings of one seed: for each sampled step of the
    first video and each stream, :func:`checks.track.window_readings` of
    the lower-precision reference's maps, encoder outputs and classes
    against the reference's."""
    from portbench.reference.quant import BELOW

    conf = cell.config
    m = conf["model"]
    T, C = m["num_frames"], m["num_classes"]
    model, flow_model, weights, traffic = inputs(cell, seed, dev)
    del model, flow_model
    _, maps_steps = sample_steps(cell.limits, seed, T)
    q = BELOW[conf["tracker"]["dtype"]]
    got = {}
    with float32_reference():
        ref = checks.Reference(weights, conf, traffic["clip"], dev)
        low = checks.Reference(weights, conf, traffic["clip"], dev, q=q)
        for k in maps_steps:
            for b in range(traffic["streams"]):
                idx = [traffic["index"](b, k - t) for t in range(T)]
                maps, enc, probs = low.window(idx)
                # what such a program keeps: its maps and encoder outputs
                # in its own precision
                maps = q(maps)
                fs = None
                if enc is not None:
                    f, n, i_ = (q(t) for t in enc)
                    fs = (f.permute(0, 2, 3, 1), n[0].permute(1, 2, 0),
                          i_[0].permute(1, 2, 0))
                r = checks.window_readings(
                    ref, idx, maps.reshape(T * C, *maps.shape[-2:]), fs,
                    probs.argmax(0),
                    probs[[2, 4]].permute(1, 2, 0).half())
                for name, v in r.items():
                    got[name] = worst(got.get(name, 0.0), v)
    return got
