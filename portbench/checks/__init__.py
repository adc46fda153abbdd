"""What decides ``correct``: each number a cell's check compares against
the limit its ``limits/<cell>.json`` sets. A limit not yet set from the
program's and the control's readings (null) fails every run."""

import math


def judge(readings, limits):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in
              readings.items()}
    ok = all(math.isfinite(v) and limits[k] is not None and v <= limits[k]
             for k, v in readings.items())
    return ok, checks
