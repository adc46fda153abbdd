"""Share of the card's bf16 peak that the model's FLOPs a frame
(``counts/flops.py::track_frame_flops``, from the configuration's layer
shapes) take at the frame rate of a whole profiler slice
(``trace.py::share_of_peak``)."""

from portbench.counts.peaks import PEAK_BF16_FLOPS
from portbench.trace import share_of_peak


def read(run):
    return share_of_peak(run, "mfu_pct.track", PEAK_BF16_FLOPS)
