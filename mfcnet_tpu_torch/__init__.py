"""mfcnet_tpu_torch — the PyTorch + CUDA port of ``mfcnet_tpu``.

A second package beside the JAX one, which stays the reference. Module
names mirror ``mfcnet_tpu`` (``models``, ``ops``, ``track``, ``compat``,
``cli``, ``utils``; CUDA sources in ``csrc``). The ported slice is the
video tracker's main path: TernausNetMulti-Basic with optional flow and
depth inputs, the frozen RAFT flow provider, the incremental and full
engines, and the device keypoint decode. Its kernels are hand-written
CUDA for Hopper: four connected-component kernels (``csrc/cc.cu``), the
bilinear flow warp (``csrc/warp.cu``) and the fused RAFT update step
(``csrc/raft_update.cu``). Imports ``torch``, never ``jax``, ``flax`` or
``mfcnet_tpu``; the device-decode path imports no ``cv2``.
"""

__version__ = "0.1.0"
