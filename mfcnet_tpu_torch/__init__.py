"""mfcnet_tpu_torch — the PyTorch + CUDA port of ``mfcnet_tpu``.

A second package beside the JAX one, which stays the reference. Module
names mirror ``mfcnet_tpu`` (``models``, ``ops``, ``track``, ``compat``,
``cli``, ``data``, ``utils``, ``experimental``; CUDA sources in ``csrc``).
The ported slices are the video tracker's main path -- TernausNetMulti-Basic
with optional flow and depth inputs, the frozen RAFT and UnFlow flow
providers, the incremental and full engines, the device keypoint decode --
and the offline flow precompute. Its kernels are hand-written CUDA for
Hopper, one for every Pallas kernel of the JAX package: four
connected-component kernels (``csrc/cc.cu``), the bilinear flow warp
(``csrc/warp.cu``), the fused RAFT update step (``csrc/raft_update.cu``),
UnFlow's correlation cost volume (``csrc/correlation.cu``) and the two
experimental convolutions (``csrc/conv3x3.cu``, ``csrc/stage1.cu``).
Imports ``torch``, never ``jax``, ``flax`` or ``mfcnet_tpu``; the
device-decode path imports no ``cv2``.
"""

__version__ = "0.1.0"
