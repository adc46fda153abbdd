"""The fused RAFT update step's share of its roofline in a whole profiler
slice: launches x the least time a launch can take at the step's token count
(``counts/raft_update.py``, bf16 operations or bytes, whichever bounds) over
the time in which the step's kernels ran (``tma_conv_kernel``, a chain of
eight a launch, and ``fill_hx_kernel``; their union, since programmatic
dependent launches overlap them). Missing when the trace holds fewer chained
kernels than the port's launch counter says ran."""

from portbench.counts import raft_update
from portbench.counts.peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from portbench.trace import union_seconds, whole_slice

KERNELS = ("tma_conv_kernel", "fill_hx_kernel")
CHAIN = 8


def read(run):
    sl = whole_slice(run, "raft_update_roofline_pct.track")
    if sl is None or not run.get("raft_tokens"):
        return None
    seen = sum(n for k, n in sl["kernel_counts"].items() if KERNELS[0] in k)
    launched = sl["launches"].get("raft_update", 0)
    if not launched or seen < CHAIN * launched:
        run["note"](f"raft_update_roofline_pct: the trace holds {seen} "
                    f"{KERNELS[0]}, the port launched {launched} x {CHAIN}")
        return None
    busy = union_seconds(sl["events"],
                         lambda name: any(k in name for k in KERNELS))
    bound = raft_update.bound_seconds(run["raft_tokens"], PEAK_BF16_FLOPS,
                                      PEAK_HBM_BYTES)
    return 100.0 * launched * bound / busy
