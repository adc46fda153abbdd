"""Frame-pair batching for the flow providers (counterpart of
``mfcnet_tpu/ops/pairs.py``).

The newest frame of a window is paired with each of its T-1 earlier
frames, and every batched provider flattens those pairs to one
(B*(T-1), ...) forward: pair ``k*(T-1)+i`` is window ``k``, earlier frame
``i+1``. This module is the one definition of that order.
"""

from __future__ import annotations


def repeat_for_pairs(v, n: int):
    """(B, ...) -> (B*n, ...), row ``k*n+i`` = input row ``k``: lines up
    with the ``(B, n, ...) -> (B*n, ...)`` reshape of the earlier frames."""
    return v.repeat_interleave(n, dim=0)
