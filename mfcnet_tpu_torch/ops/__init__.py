"""Tensor ops: connected components and per-component sums, the flow
warp, the fused RAFT update step and the correlation cost volume (CUDA
kernels with plain PyTorch versions), resize, pair batching, heatmap
peaks."""
