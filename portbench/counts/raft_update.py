"""Operations and bytes of one launch of the port's fused RAFT update step
(``mfc_raft_update*``): one update iteration after the motion encoder's
two 1x1-and-7x7 entry convolutions (``convcorr1``, ``convflow1``), i.e.
``convcorr2``, ``convflow2``, the 3x3 over their concatenation, the
SepConvGRU and the flow head, over ``tokens`` 1/8-resolution positions.

Operations: 2 x multiply-adds of those convolutions. Bytes: each input read
once and each output written once -- the entry convolutions' outputs
(256 and 128 channels) and the context feed (128) in the compute type, the
GRU state (128) and the flow (2) in float32 in and out, and the weights in
the compute type with their biases in float32.
"""

from __future__ import annotations

#: (cin, cout, taps) of the convolutions inside one launch
CONVS = ((256, 192, 9), (128, 64, 9), (256, 126, 9),
         (384, 128, 5), (384, 128, 5), (384, 128, 5),
         (384, 128, 5), (384, 128, 5), (384, 128, 5),
         (128, 256, 9), (256, 2, 9))


def macs_per_token() -> int:
    return sum(ci * co * k for ci, co, k in CONVS)


def operations(tokens: int) -> int:
    return 2 * macs_per_token() * tokens


def bytes_moved(tokens: int, compute_bytes: int = 2) -> int:
    weights = macs_per_token() * compute_bytes + 4 * sum(co for _, co, _ in
                                                         CONVS)
    inputs = tokens * ((256 + 128 + 128) * compute_bytes + (128 + 2) * 4)
    outputs = tokens * (128 + 2) * 4
    return weights + inputs + outputs


def bound_seconds(tokens: int, peak_flops: float, peak_bytes: float,
                  compute_bytes: int = 2) -> float:
    """The least time a launch can take: the larger of its operations over
    the peak rate and its bytes over the memory rate."""
    return max(operations(tokens) / peak_flops,
               bytes_moved(tokens, compute_bytes) / peak_bytes)
