"""The tiling of ``csrc/warp.cu::warp_abs_kernel`` (the sample behind
``ops/warp.py::grid_sample_bilinear``) on the CPU, without JAX: blocks of
64 x 8 output pixels of one image, 256 threads, a thread two adjacent x of
a row, the second only inside the output; every output pixel written by
exactly one thread, at even and odd widths."""

from pathlib import Path

import numpy as np
import pytest

from mfcnet_tpu_torch.ops import warp

WARP_CU = Path(warp.__file__).resolve().parents[1] / "csrc" / "warp.cu"


def test_warp_abs_tiling_is_the_c_sides():
    src = WARP_CU.read_text()
    assert "constexpr int FW_TW = 64, FW_TH = 8;" in src
    body = src[src.index("warp_abs_kernel(const T* __restrict__ img"):]
    body = body[:body.index("template <typename T>")]
    for line in ("const int lx = (tid % (FW_TW / 2)) * 2, "
                 "ly = tid / (FW_TW / 2);",
                 "const int x = blockIdx.x * FW_TW + lx, "
                 "y = blockIdx.y * FW_TH + ly;",
                 "if (x >= Wo || y >= Ho) return;",
                 "const bool two = x + 1 < Wo;"):
        assert line in body, line
    launch = src[src.index("int launch_warp_abs("):]
    assert ("const dim3 grid((Wo + FW_TW - 1) / FW_TW, (Ho + FW_TH - 1) / "
            "FW_TH, B);") in launch
    assert "warp_abs_kernel<T, true><<<grid, TPB, 0, s>>>" in launch
    assert "constexpr int TPB = 256;" in src


@pytest.mark.parametrize("B,Ho,Wo", [(2, 256, 320), (1, 37, 61), (1, 1, 1),
                                     (3, 8, 65), (1, 9, 64), (2, 17, 3),
                                     (1, 100, 121)])
def test_warp_abs_tiles_cover_every_output_pixel_once(B, Ho, Wo):
    gx, gy, gz = -(-Wo // 64), -(-Ho // 8), B  # launch_warp_abs's grid
    cover = np.zeros((B, Ho, Wo), np.int32)
    tid = np.arange(256)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                x = bx * 64 + (tid % 32) * 2
                y = by * 8 + tid // 32
                live = (x < Wo) & (y < Ho)
                np.add.at(cover[bz], (y[live], x[live]), 1)
                two = live & (x + 1 < Wo)
                np.add.at(cover[bz], (y[two], x[two] + 1), 1)
    assert (cover == 1).all()
