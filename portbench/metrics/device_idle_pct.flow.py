"""Share of a whole profiler slice of a flow window in which no operation
ran on the device (``trace.py::idle_pct``)."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run, "device_idle_pct.flow")
