"""The benchmark of the PyTorch and CUDA port ``mfcnet_tpu_torch`` on an
NVIDIA H100: one command runs one cell (``run.py``); ``README.md`` says how."""
