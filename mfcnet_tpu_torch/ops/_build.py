"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` into a shared library of its own
with a plain C interface and bound with :mod:`ctypes` -- no PyTorch
headers, so a build takes seconds, and the sources compile in parallel
(one ``nvcc`` process each, all started together). The libraries go to
``build/`` at the repository root, keyed by a hash of the sources, and are
built at first use: nothing is compiled or loaded when a module is
imported, so the CPU-only test runs never touch ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points by source file: (argtypes, restype)
_SIGNATURES = {
    "cc.cu": {
        # mask, lab, B, H, W, conn, plan[6], stream
        "mfc_cc_labels": ((_P, _P, _I, _I, _I, _I, _P, _P), _I),
        # mask, cid, filled, ncomp, work, B, H, W, K, plan[6], stream
        "mfc_flood_cc_cid": (
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P), _I,
        ),
        # ucls, cid, he, cide, ncomp, conflict, work, B, H, W, K, plan[6],
        # stream
        "mfc_union_flood_cc_cid": (
            (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P), _I,
        ),
        # cid, he, cide, stats, ccls, acc, B, H, W, K, plan[6], stream
        "mfc_onehot_stats": (
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P), _I,
        ),
    },
    "warp.cu": {
        "mfc_flow_warp": (
            (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I,
        ),
        # img, gx, gy, out, B, C, H, W, Ho, Wo, align_corners, border,
        # dtype, stream
        "mfc_warp_abs": (
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I,
        ),
        # img, flow, out, strides[12], xs, ys, B, C, H, W, align_corners,
        # border, dtype, flow dtype, stream
        "mfc_backward_warp": (
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I,
        ),
        # g, flow, work, out, B, C, H, W, gh, gw, align_corners, dtype,
        # plan[9], stream
        "mfc_flow_warp_bwd_maps": (
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P), _I,
        ),
        # g, maps, flow, gflow, B, C, H, W, gh, gw, align_corners, dtype,
        # stream
        "mfc_flow_warp_bwd_flow": (
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I,
        ),
        # g, fx, fy, grad_img, strides[8], B, C, H, W, Ho, Wo, border,
        # dtype, stream
        "mfc_sample_bwd_img": (
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I,
        ),
        # g, img, fx, fy, grad_fx, grad_fy, strides[8], B, C, H, W, Ho, Wo,
        # border, dtype, stream
        "mfc_sample_bwd_coords": (
            (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
            _I,
        ),
    },
    "raft_update.cu": {
        "mfc_raft_plan_bytes": ((), _I),
        # plan, K-major weights[18] (bf16) or [27] (f32), scratch[5], B, H8,
        # W8, dtype, tile[18]
        "mfc_raft_plan_init": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
        # plan, inputs[5], net_out, delta, fill, stream
        "mfc_raft_update_tma": ((_P, _P, _P, _P, _I, _P), _I),
    },
    "correlation.cu": {
        # f1, f2, out, B, H, W, C, max_displacement, stride, dtype,
        # plan[9], stream
        "mfc_correlation": (
            (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P), _I,
        ),
        # g, f1, f2, grad_f1, grad_f2, B, H, W, C, max_displacement,
        # stride, dtype, plan[7], stream
        "mfc_correlation_bwd": (
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P), _I,
        ),
    },
    "conv3x3.cu": {
        # x, w, bias, out, B, H, W, cin, cout, relu, dtype, plan[11],
        # stream
        "mfc_conv3x3": (
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P), _I,
        ),
    },
    "stage1.cu": {
        # x, k1, b1, k2, b2, out, B, H, W, cin, C1, dtype, plan[11], stream
        "mfc_vgg_stage1": (
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P), _I,
        ),
    },
}


class KernelLibrary:
    """The compiled libraries plus what their build reported. ``lib``
    holds every C entry point as an attribute."""

    def __init__(self, lib, paths, seconds: float, log: str):
        self.lib = lib
        self.paths = paths
        self.build_seconds = seconds
        self.build_log = log


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from mfcnet_tpu_torch/csrc at first use"
    )


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel libraries; cached per
    process."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        jobs, paths = [], {}
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            digest = hashlib.sha256(src.read_bytes() + headers
                                    + " ".join(NVCC_FLAGS).encode())
            out = BUILD_DIR / f"libmfc_{src.stem}_{digest.hexdigest()[:16]}.so"
            paths[src.name] = out
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                jobs.append((cmd, tmp, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        logs = []
        for cmd, tmp, out, proc in jobs:  # all started; now wait for each
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                for other in jobs:
                    other[3].kill()
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
        seconds = time.perf_counter() - t0 if jobs else 0.0
        lib = types.SimpleNamespace()
        for name, path in paths.items():
            dll = ctypes.CDLL(str(path))
            for fname, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(dll, fname)
                fn.argtypes = argtypes
                fn.restype = restype
                setattr(lib, fname, fn)
        _loaded = KernelLibrary(lib, paths, seconds,
                                "".join(logs) or "(cached build)")
        return _loaded


def kernel_lib():
    """The C entry points (builds at first use)."""
    return load().lib


def route(*tensors) -> str:
    """'cpu' or 'cuda' for a wrapper's inputs; raises on anything else."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def traced(*tensors) -> bool:
    """Whether a wrapper is being traced (``torch.export``,
    ``torch.compile``) rather than run: a traced call goes through its
    registered operator, so that the graph names it; a call that runs
    launches its kernel (or its plain version) directly."""
    import torch

    return torch.compiler.is_compiling() or any(
        type(t) not in (torch.Tensor, torch.nn.Parameter) for t in tensors)


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C side takes it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of a CUDA device (cached: the wrappers ask on every call)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
