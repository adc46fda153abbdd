"""Device times of the flow paths' two hand kernels -- UnFlow's correlation
cost volume and the head's flow warp -- and of the warp's absolute-coordinate
entry point alone, for the package of this checkout, or of this checkout and
another tree in turns on one card in one call:

    python3 tools/flowk_times.py [--breakdown] [--variants] [--tree DIR]

Inputs, seeded: the correlation at UnFlow's tracker shape (f32 and bf16
2x32x40x256: the conv3 features of 2 pairs at 256x320) and at the offline
CLI's (f32 4x64x80x256), md=20, s=2; ``flow_warp`` on bf16 maps 2x5x480x640
(the head's call, ``models/mfcnet.py``) on the 576x720 crop grid with a
smooth flow of up to ~17 px (the RAFT path's size) and with per-pixel
noise of 4 px; ``mfc_warp_abs`` called alone on ready absolute coordinates
(UnFlow's backward-warp grid, border clamp) of an f32 2x3x256x320 image.
Beside each, the library yardstick: ``torch.bmm`` of each residue
sub-grid's full Gram matrix in f32 with TF32 off (products only; the
correlation needs the banded part of it), and ``F.grid_sample`` on a ready
grid. Every output is checked against its plain version first. For each:
ms per call by CUDA-graph replay (``chip_smoke.py::_graph_ms``) and, for
the two kernels, called eagerly (CUDA events around 50 calls).
``--breakdown`` lists the device operations of one call with their device
times (``torch.profiler``). For the correlation the line also holds
``corr_plan``'s plan and the operand rows its blocks stage (MB). ``--variants`` also builds
``tools/flowk_variants.cu`` (stripped variants of the earlier flow warp:
coordinates only, taps without stores, 2D blocks, a copy of the same bytes)
and times each at the same inputs.

Prints the card's name and power limit, then one JSON line of readings.
With ``--tree DIR`` (another checkout, say the parent commit unpacked under
``build/`` with ``git archive``; its kernels build into DIR/build) the
script times DIR (A) and this checkout (B) in turns, A B B A, each turn in
a process of its own, prints each turn's line and then one line with the
best reading of each tree per key (``"best": {key: [A, B]}``) and the ratio
A / B.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MD, STRIDE = 20, 2
#: (label, shape, dtype name) of the correlation's timed calls
CORR_CALLS = (("tracker f32", (2, 32, 40, 256), "float32"),
              ("tracker bf16", (2, 32, 40, 256), "bfloat16"),
              ("offline f32", (4, 64, 80, 256), "float32"))
WARP_SHAPE, GRID_HW = (2, 5, 480, 640), (576, 720)
ABS_SHAPE = (2, 3, 256, 320)
VARIANTS = ("parent", "coordinates", "taps", "tile 32x8", "copy")
#: the variants that compute the warp itself (bit-equal to "parent")
EXACT = ("parent", "tile 32x8")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def smooth_flow(gen, B, H, W, amplitude):
    """(B, 2, H, W) float32 flow: a coarse random field, bilinearly
    upsampled and scaled so that its largest |value| is ``amplitude``."""
    import torch
    import torch.nn.functional as F

    coarse = torch.randn(B, 2, 6, 8, generator=gen)
    fine = F.interpolate(coarse, size=(H, W), mode="bilinear",
                         align_corners=True)
    return fine * (amplitude / fine.abs().max())


def build_variants():
    """tools/flowk_variants.cu -> build/, loaded with ctypes."""
    from mfcnet_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    src = Path(__file__).resolve().with_name("flowk_variants.cu")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libflowk_variants_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_flow_warp.argtypes = (I, P, P, P, I, I, I, I, I, I, I, P)
    lib.probe_flow_warp.restype = I
    return lib


def readings(breakdown: bool, variants: bool, tree: Path):
    import torch
    import torch.nn.functional as F

    from chip_smoke import CORR_TOL, WARP_ATOL, _abs_coords, _device_events, \
        _event_ms, _graph_ms, _residue_grams
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops._build import kernel_lib, stream_of

    gen = torch.Generator().manual_seed(0)
    out = {"tree": str(tree), "package": co.__file__}
    calls = {}  # label -> (kernel call, library call or None)
    atol, rtol = CORR_TOL
    for label, shape, dt in CORR_CALLS:
        f1 = torch.randn(shape, generator=gen).cuda().to(getattr(torch, dt))
        f2 = torch.randn(shape, generator=gen).cuda().to(getattr(torch, dt))
        got = co.correlation_cost_volume(f1, f2, MD, STRIDE)
        want = co.correlation_plain(f1, f2, MD, STRIDE)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"correlation {label}: kernel != plain "
                                 f"({(got - want).abs().max().item()})")
        if hasattr(co, "corr_plan"):
            plan = co.corr_plan(*shape, MD, STRIDE, dt)
            out[f"correlation plan, {label}"] = plan._asdict()
            if plan.route == "tc":  # rows of C channels, read out of L2
                out[f"correlation staged MB, {label}"] = co.staged_rows(
                    plan, *shape[:3], MD, STRIDE) * f1[0, 0, 0].nbytes / 1e6
        a, b = _residue_grams(f1.float(), f2.float(), STRIDE)
        calls[f"correlation {label}"] = (
            lambda f1=f1, f2=f2: co.correlation_cost_volume(f1, f2, MD,
                                                            STRIDE),
            lambda a=a, b=b: torch.bmm(a, b.transpose(1, 2)))
    maps = torch.rand(WARP_SHAPE, generator=gen).cuda().bfloat16()
    B, _, H, W = WARP_SHAPE
    flows = {"smooth 17 px": smooth_flow(gen, B, H, W, 17.0).cuda(),
             "noise 4 px": (torch.randn(B, 2, H, W, generator=gen) * 4.0
                            ).cuda()}
    for label, fl in flows.items():
        got = warp.flow_warp(maps, fl, GRID_HW)
        want = warp.flow_warp_plain(maps, fl, GRID_HW)
        err = (got.float() - want.float()).abs().max().item()
        if err > WARP_ATOL["bfloat16"]:
            raise AssertionError(f"flow_warp {label}: kernel != plain ({err})")
        gx, gy = warp._flow_grid(fl, GRID_HW)
        grid = torch.stack([gx, gy], -1).to(maps.dtype)
        calls[f"flow_warp {label}"] = (
            lambda fl=fl: warp.flow_warp(maps, fl, GRID_HW),
            lambda grid=grid: F.grid_sample(
                maps, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True))
    # mfc_warp_abs alone: the C entry point on ready coordinates
    Ba, Ca, Ha, Wa = ABS_SHAPE
    img = torch.randn(ABS_SHAPE, generator=gen).cuda()
    fx, fy, grid = _abs_coords(
        (torch.randn(Ba, 2, Ha, Wa, generator=gen) * 8.0).cuda(), Ha, Wa)
    res = torch.empty_like(img)
    lib = kernel_lib()

    def warp_abs():
        rc = lib.mfc_warp_abs(img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                              res.data_ptr(), Ba, Ca, Ha, Wa, Ha, Wa, 0,
                              stream_of(img))
        if rc != 0:
            raise RuntimeError(f"mfc_warp_abs: cudaError {rc}")
        return res

    err = (warp_abs() - warp._sample_abs_plain(img, fx, fy)).abs().max()
    if err.item() > WARP_ATOL["float32"]:
        raise AssertionError(f"warp_abs: kernel != plain ({err.item()})")
    calls["warp_abs alone f32 2x3x256x320"] = (
        warp_abs, lambda: F.grid_sample(img, grid, mode="bilinear",
                                        padding_mode="border",
                                        align_corners=False))
    if breakdown:
        for label, (kern, _) in calls.items():
            ops = _device_events(kern)
            out[f"{label} ops"] = {
                "count": len(ops), "device_us": sum(t for _, t in ops),
                "ops": [[n[:60], round(t, 3)] for n, t in ops]}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in f32
    try:
        for label, (kern, library) in calls.items():
            out[f"{label} graph ms, kernel"] = _graph_ms(kern)
            if not label.startswith("warp_abs"):
                out[f"{label} eager ms, kernel"] = _event_ms(kern, 50)
            out[f"{label} graph ms, library"] = _graph_ms(library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if variants:
        vlib = build_variants()
        for label, fl in flows.items():
            ref = None
            for v, name in enumerate(VARIANTS):
                vout = torch.empty_like(maps)

                def probe(v=v, vout=vout, fl=fl):
                    rc = vlib.probe_flow_warp(
                        v, maps.data_ptr(), fl.data_ptr(), vout.data_ptr(),
                        B, WARP_SHAPE[1], H, W, *GRID_HW, 1, stream_of(maps))
                    if rc != 0:
                        raise RuntimeError(f"variant {name}: cudaError {rc}")
                    return vout

                probe()
                if name in EXACT:
                    ref = vout.clone() if ref is None else ref
                    if not torch.equal(vout, ref):
                        raise AssertionError(f"variant {name} != parent")
                out[f"flow_warp variant {name} graph ms, {label}"] = \
                    _graph_ms(probe)
    return out


def in_turns(tree: Path, breakdown: bool):
    """A (``tree``) B (this checkout) B A, a process each; the best reading
    of each tree per timed key."""
    turns = []
    for t in (tree, ROOT, ROOT, tree):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time-tree",
               str(t)] + (["--breakdown"] if breakdown else [])
        line = subprocess.run(cmd, capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    best = {k: [min(turns[0][k], turns[3][k]), min(turns[1][k], turns[2][k])]
            for k in turns[0] if " ms, " in k and k in turns[1]}
    return {"A": str(tree), "B": str(ROOT), "best": best,
            "A/B": {k: a / b for k, (a, b) in best.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--time-tree", type=Path, default=None,
                    help=argparse.SUPPRESS)  # one turn of --tree
    ap.add_argument("--breakdown", action="store_true",
                    help="list each call's device operations")
    ap.add_argument("--variants", action="store_true",
                    help="time the stripped variants of the earlier warp")
    args = ap.parse_args()
    if args.tree is not None:
        print(card(), flush=True)
        print(json.dumps(in_turns(args.tree.resolve(), args.breakdown)),
              flush=True)
        if args.variants:
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--variants"], check=True)
        return
    tree = (args.time_tree or ROOT).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: F401  (this checkout's timers and limits)

    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flowk_times: needs an NVIDIA GPU")
    if args.time_tree is None:
        print(card(), flush=True)
    print(json.dumps(readings(args.breakdown, args.variants, tree)),
          flush=True)


if __name__ == "__main__":
    main()
