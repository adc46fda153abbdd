"""Profiler slices of a measured window, bracketed by marker kernels.

The card's profiler has dropped device events at the start of a session and
after its opening markers. So a session settles before ``MARKS`` spin
kernels open a slice, and ``MARKS`` close it; a slice is whole when all of
them were recorded contiguously, and its device events are those between
the two groups (the method of the port's ``chip_smoke.py::_profiled``,
copied). A traced run schedules ``len(FRACS)`` slices through its window
(``schedule``) and reads the first whole one, so that a session that lost
events costs a slice and not the run's readings. From a whole slice: the
time in which at least one device operation ran (the union of their
intervals, since kernels may overlap), the length of the slice on the
device's clock, the device operations by total time, and the longest gaps
in which the device was idle, each named by what the host was doing then.
"""

from __future__ import annotations

import time
from collections import defaultdict

MARKS, MARK_CYCLES, MARK_NAME = 3, 1000, "spin_kernel"
#: seconds a new session is left to settle before its opening markers
SETTLE_S = 0.05
#: where the slices start, as shares of the window, and their longest length
FRACS, SLICE_S = (0.1, 0.28, 0.46, 0.64, 0.82), 1.0
#: the benchmark's own host spans (``record_function`` names)
SPAN_PREFIX = "portbench."


class Slice:
    """One profiler session around part of a window; started and stopped
    from the measured loop, read after the window."""

    def __init__(self, counters, t0=0.0, length=1.0):
        self.counters = counters  # () -> {name: launches so far}
        #: host clock at which the loop starts the slice, and the slice's
        #: length from the moment it has started (starting a profiler
        #: session takes a while of its own)
        self.t0, self.length, self.t1 = t0, length, None
        self.prof = None
        self.frames = 0
        self.launches0 = self.launches1 = None
        #: why the slice is not whole, once ``summary`` has found so
        self.why = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        for _ in range(MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        self.launches0 = self.counters()
        self.t1 = time.perf_counter() + self.length

    def stop(self):
        import torch

        self.launches1 = self.counters()
        for _ in range(MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.02)
        self.prof.stop()

    def summary(self):
        """The slice's readings, or None when the trace is not whole."""
        import torch

        if self.prof is None:
            self.why = "not started before the window closed"
            return None
        dev_t = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        # device operations: kernels, copies, fills; not the ranges that
        # record_function also draws on the device's timeline
        dev = sorted((e for e in events if e.device_type == dev_t
                      and not getattr(e, "is_user_annotation", False)
                      and not e.name.startswith(SPAN_PREFIX)),
                     key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(dev) if MARK_NAME in e.name]
        whole = (len(marks) == 2 * MARKS
                 and marks[MARKS - 1] - marks[0] == MARKS - 1
                 and marks[-1] - marks[MARKS] == MARKS - 1)
        if not whole:
            self.why = (f"{len(marks)} of {2 * MARKS} markers at positions "
                        f"{marks} of {len(dev)} device events")
            return None
        lo = dev[marks[MARKS - 1]].time_range.end
        hi = dev[marks[MARKS]].time_range.start
        inside = dev[marks[MARKS - 1] + 1:marks[MARKS]]
        busy, end, gaps = 0.0, lo, []
        for e in inside:
            a, b = e.time_range.start, e.time_range.end
            if a > end:
                gaps.append((a - end, end, a))
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        if hi > end:
            gaps.append((hi - end, end, hi))
        by_name = defaultdict(float)
        counts = defaultdict(int)
        for e in inside:
            by_name[e.name] += e.time_range.elapsed_us()
            counts[e.name] += 1
        host = [e for e in events if e.device_type != dev_t]
        gaps.sort(reverse=True)
        return {
            "busy_s": busy / 1e6,
            "window_s": (hi - lo) / 1e6,
            "kernels": dict(by_name),
            "kernel_counts": dict(counts),
            "events": [(e.name, e.time_range.start, e.time_range.end)
                       for e in inside],
            "launches": {k: self.launches1[k] - self.launches0.get(k, 0)
                         for k in self.launches1},
            "frames": self.frames,
            "device_ops": sorted(((k, v / 1e6) for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [(_host_activity(host, a, b), d / 1e6)
                          for d, a, b in gaps[:10]],
        }


def schedule(counters, t_start, seconds):
    """The slices of a window of ``seconds`` from ``t_start``: one at each
    of ``FRACS``, each ``SLICE_S`` long or a tenth of the window."""
    length = min(SLICE_S, 0.1 * seconds)
    return [Slice(counters, t_start + frac * seconds, length)
            for frac in FRACS]


def read(slices):
    """The slices' readings (None for one that is not whole) and a note on
    each: what it read, or why it is not whole."""
    summaries, notes = [], []
    for i, s in enumerate(slices):
        sm = s.summary()
        summaries.append(sm)
        notes.append(f"profiler slice {i + 1} of {len(slices)}: " + (
            f"not whole, {s.why}" if sm is None else
            f"busy {sm['busy_s']!r} s of {sm['window_s']!r} s, "
            f"{sm['frames']} frames or pairs"))
    return summaries, notes


def union_seconds(events, match):
    """Seconds in which at least one of the (name, start us, end us)
    ``events`` whose name ``match`` accepts ran."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted((e for e in events if match(e[0])),
                          key=lambda e: e[1]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6


def _host_activity(host, a, b):
    """The innermost host event open at the middle of the gap (a, b)."""
    mid = 0.5 * (a + b)
    best = None
    for e in host:
        s, t = e.time_range.start, e.time_range.end
        if s <= mid <= t and (best is None or t - s < best[0]):
            best = (t - s, e.name)
    return best[1] if best else "host idle"


def whole_slice(run, metric):
    """The run's first whole profiler slice; None, with a note, if none."""
    sl = next((s for s in run.get("slices", []) if s), None)
    if sl is None:
        run["note"](f"{metric}: no whole profiler slice")
    return sl


def idle_pct(run, metric):
    """Share of a whole slice in which no operation ran on the device: 100
    x (1 - the union of the device operations' intervals / the slice
    between its marker kernels)."""
    sl = whole_slice(run, metric)
    return None if sl is None else 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])


def share_of_peak(run, metric, peak):
    """Share of ``peak`` FLOP/s that the model's FLOPs a frame or pair
    (``run["flops_per_frame"]``) take at the rate of a whole slice: frames
    or pairs handed in the slice over its length on the device's clock (a
    sync closes it, so all of them ran)."""
    sl = whole_slice(run, metric)
    if sl is None or not sl["frames"]:
        return None
    return 100.0 * run["flops_per_frame"] * sl["frames"] / sl["window_s"] / peak
