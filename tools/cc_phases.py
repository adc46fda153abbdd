"""Per-phase device times of the decode's two flood kernels
(``csrc/cc.cu``: ``k_flood_cc_cid``, ``k_union_flood_cc_cid``):

    python3 tools/cc_phases.py

Builds a copy of ``cc.cu`` under ``build/`` in which block 0 reads
``%globaltimer`` at the kernel's start and after every grid barrier, swaps
the copy's entry points in for the package's, and runs both kernels on the
two inputs of ``tools/cc_times.py`` (the crafted clean 480x640 class map
and the random model's window-15 map). A phase's time is then the gap
between two barriers: the slowest block's work plus one barrier. Prints
the card's name and power limit, then one JSON line per kernel and input:
the outputs' equality with the plain versions, the median phase times
(us) over 20 calls, their sum, and the CUDA-graph replay time of the
instrumented copy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long "
         "t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "g_t[g_base + g_n++] = t_; } }")
#: first slot of each kernel's stamps in the copy's timer array
BASES = {"k_flood_cc_cid": 0, "k_union_flood_cc_cid": 32}


def instrumented(src: str) -> str:
    """``cc.cu`` with the stamps and ``mfc_phase_times`` added."""
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ unsigned long long g_t[64];\n",
                      1)
    out, kern = [], None
    for line in src.splitlines():
        for name in BASES:
            if line.startswith("__global__") and f" {name}(" in line:
                kern = name
        if kern and line == "}":  # the kernel's closing brace
            out += ["  grid.sync();", "  " + STAMP]
            kern = None
        out.append(line)
        if kern and "cg::this_grid();" in line:
            out.append(f"  int g_n = 0; const int g_base = {BASES[kern]}; "
                       + STAMP)
        elif kern and line.strip() == "grid.sync();":
            out.append("  " + STAMP)
    return "\n".join(out) + (
        '\nextern "C" int mfc_phase_times(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_t, sizeof(g_t));\n}\n")


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import (K, _graph_ms, crafted_class_maps, decode_inputs,
                            synthetic_frames)
    from mfcnet_tpu_torch.ops import _build, cc
    from tools.cc_times import WINDOW, model_class_map

    if not torch.cuda.is_available():
        raise SystemExit("cc_phases: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    kl = _build.load()
    out_dir = _build.BUILD_DIR / "cc_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    copy = out_dir / "cc_phases.cu"
    copy.write_text(instrumented((_build.CSRC / "cc.cu").read_text()))
    lib = out_dir / "libcc_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(copy)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    for fname, (argtypes, restype) in _build._SIGNATURES["cc.cu"].items():
        fn = getattr(dll, fname)
        fn.argtypes, fn.restype = argtypes, restype
        setattr(kl.lib, fname, fn)
    dll.mfc_phase_times.argtypes = (ctypes.c_void_p,)
    clean = np.choose(crafted_class_maps()["clean"], [0, 3, 1, 4, 2])
    maps = {"clean": torch.from_numpy(clean.astype(np.int64)).cuda(),
            f"model window {WINDOW}": model_class_map(
                synthetic_frames(WINDOW + 1))}
    buf = (ctypes.c_ulonglong * 64)()
    for what, pred in maps.items():
        u, m4 = decode_inputs(pred)
        for name, base, kern, plain in (
                ("union_flood_cc_cid", BASES["k_union_flood_cc_cid"],
                 lambda: cc.union_flood_cc_cid(u, K),
                 lambda: cc.union_flood_cc_cid_plain(u, K)),
                ("flood_cc_cid", BASES["k_flood_cc_cid"],
                 lambda: cc.flood_cc_cid(m4, K),
                 lambda: cc.flood_cc_cid_plain(m4, K))):
            equal = all(torch.equal(a, b) for a, b in zip(kern(), plain()))
            runs = []
            for _ in range(20):
                kern()
                torch.cuda.synchronize()
                dll.mfc_phase_times(buf)
                t = np.array(buf[base:base + 32], dtype=np.float64)
                runs.append(np.diff(t[:int(np.argmin(t > 0))]) / 1e3)
            us = np.median(np.stack(runs), axis=0)
            print(json.dumps({
                "kernel": name, "input": what,
                "equal": equal, "phases_us": [round(x, 2) for x in us],
                "total_us": round(float(us.sum()), 2),
                "graph_ms": _graph_ms(kern)}), flush=True)


if __name__ == "__main__":
    main()
