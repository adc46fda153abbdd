"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
limit): the yardstick of every share of a peak or a roofline."""

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
