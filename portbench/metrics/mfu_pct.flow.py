"""Share of the card's TF32 peak -- the fastest rate at which a float32
provider's convolutions can run -- that RAFT's FLOPs a frame pair
(``counts/flops.py::flow_pair_flops``, from the configuration's layer
shapes) take at the pair rate of a whole profiler slice
(``trace.py::share_of_peak``)."""

from portbench.counts.peaks import PEAK_TF32_FLOPS
from portbench.trace import share_of_peak


def read(run):
    return share_of_peak(run, "mfu_pct.flow", PEAK_TF32_FLOPS)
