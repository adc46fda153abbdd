"""Two experimental convolution kernels (counterpart of
``mfcnet_tpu/experimental``): a direct 3x3 convolution with a fused bias
and ReLU, and the fused first VGG stage. As in the JAX package, no model
calls them: the backbone's convolutions are cuDNN's. They are kept as
hand-written CUDA beside their plain versions and timed against cuDNN
(``chip_smoke.py``, ``PERF.md``).

What the port leaves out of the TPU formulation, because it answers the
TPU's matrix unit and compiler and not the function: ``tile_rows``,
``tile_cols`` and ``variant`` of ``vgg_stage1_pallas``, the padding of
channels to 8 sublanes or 128 lanes, the pairing of taps to fill the
contraction dimension, the row bands with explicit DMA, and the
requirement that H and W divide by the tile. Any H and W are taken.
"""
