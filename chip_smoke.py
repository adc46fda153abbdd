"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths -- the video tracker with TernausNetMulti-Basic
at full width (T=3, 5 classes, 480x640, bf16) and ``decode="device"``,
without flow and with the frozen RAFT flow provider (raft_large widths,
12 iterations, fused update step) -- through its six hand-written CUDA
kernels (``mfcnet_tpu_torch/csrc``), in four phases; a failing phase
raises and the script exits non-zero:

1. device and build: requires a CUDA card, prints its name and power
   limit, builds the kernels into ``build/`` (one nvcc per source, in
   parallel);
2. kernels against their plain PyTorch versions: the connected-component
   kernels on crafted 480x640 class maps (integer outputs and the sums
   exactly equal), the flow warp at 2x480x640 and the RAFT update step at
   2x30x40 tokens within the tolerances stated beside them;
3. the slices: seeded random weights, synthetic frames, ``track_on_frames``
   in incremental and full mode, without and with flow (and once with
   depth); every kernel's launch count, set to 0 just before a main-path
   run and read just after, must have risen; f32 parity mode checks
   incremental against full and the path through the kernels against the
   path through the plain versions;
4. timings: tracker frames/s on both paths, decode ms/frame, RAFT's share
   of the frame, each kernel against its plain version, its bound and,
   where one PyTorch call computes the same function, that call.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, T, C, K = 480, 640, 3, 5, 256
SEED = 0
CSRC = "mfcnet_tpu_torch/csrc/"
#: (kernel name, source, file:line of the TPU kernel it replaces)
KERNELS = (
    ("connected_components", CSRC + "cc.cu",
     "mfcnet_tpu/ops/cc_pallas.py:183"),
    ("flood_cc_cid", CSRC + "cc.cu", "mfcnet_tpu/ops/cc_pallas.py:216"),
    ("union_flood_cc_cid", CSRC + "cc.cu",
     "mfcnet_tpu/ops/cc_pallas.py:262"),
    ("onehot_stats", CSRC + "cc.cu", "mfcnet_tpu/ops/cc_pallas.py:392"),
    ("flow_warp", CSRC + "warp.cu", "mfcnet_tpu/ops/warp_pallas.py:37"),
    ("raft_update", CSRC + "raft_update.cu",
     "mfcnet_tpu/ops/raft_update_pallas.py:151"),
)
CC_KERNELS = tuple(k[0] for k in KERNELS[:4])
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core and plain
# float32 operations/s (the bounds are stated against these peaks whatever
# the card's power limit, which is printed beside them)
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
FLOW_FRAMES, FLOW_ITERS = 24, 12
# kernel-vs-plain tolerances. flow_warp: the kernel forms its coordinates
# with the same float32 operations in the same order and blends without
# fused multiply-adds, so float32 outputs agree to 2e-6 (found: exactly) and
# bf16 outputs to one rounding of the largest map value. raft_update: the
# float32 instance to the tolerance of the JAX package's own kernel test
# (sums in another order); the bf16 instance also rounds c2, f2, y, net,
# r*net and the flow head's hidden layer to bf16, and a float32 sum taken in
# another order can flip such a rounding (one bf16 step, 2^-8 of an O(1)
# operand), which the following products carry on.
WARP_ATOL = {"float32": 2e-6, "bfloat16": 2.0 ** -8}
RAFT_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-3, 1e-2)}
#: bf16 engine through the kernels against through the plain versions: the
#: most a class probability may move, one step of the float16 heats the
#: tracker keeps at a probability near 1/C = 0.2
FLOW_PROB_TOL = 2.0 ** -13


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- maps
def _spiral(h, w, top, left, size, cls, img, gap=2):
    """1-px square spiral of ``cls`` (one long label chain)."""
    y0, x0, y1, x1 = top, left, top + size - 1, left + size - 1
    while y1 - y0 > 2 * gap and x1 - x0 > 2 * gap:
        img[y0, x0:x1 + 1] = cls
        img[y0:y1 + 1, x1] = cls
        img[y1, x0:x1 + 1] = cls
        img[y0 + gap:y1 + 1, x0] = cls
        y0, x0, y1, x1 = y0 + gap, x0 + gap, y1 - gap, x1 - gap
        img[y0, x0 - gap:x0 + 1] = cls
    return img


def crafted_class_maps(seed: int = SEED):
    """480x640 class maps in the decode's union encoding (0 background,
    1..4 = l-base, r-base, l-tip, r-tip) that take every branch of the
    union kernel: clean blobs, contained specks, nested rings (conflict),
    a diagonally porous straddle, long spirals, and a >256-component
    speckle map."""
    rng = np.random.default_rng(seed)
    maps = {}
    m = np.zeros((H, W), np.int8)
    m[40:120, 60:200] = 1
    m[70:90, 100:140] = 0            # a background hole
    m[200:300, 300:380] = 2
    m[330:420, 40:120] = 3
    m[100:130, 450:600] = 4
    m[400:404, 500:504] = 4          # a sub-threshold speck
    m[0:30, 0:50] = 2                # border blob
    maps["clean"] = m
    m = np.zeros((H, W), np.int8)
    m[50:200, 50:200] = 1
    m[80:170, 80:170] = 0
    m[110:140, 110:140] = 2          # contained speck in a hole
    m[250:420, 300:560] = 3
    m[300:340, 380:420] = 4          # contained speck in a solid blob
    m[60:100, 400:460] = 2
    maps["nested"] = m
    m = np.zeros((H, W), np.int8)
    m[100:300, 200:400] = 2
    m[130:270, 230:370] = 0
    m[150:250, 250:350] = 4
    m[180:220, 280:320] = 0          # rings of two classes: conflict
    m[350:400, 50:100] = 1
    maps["conflict"] = m
    m = np.zeros((H, W), np.int8)
    m[50, 50:58] = 2
    m[57, 50:58] = 2
    m[50:58, 50] = 2
    m[50:58, 57] = 2
    m[49, 51] = 2
    m[50, 51] = 3                    # straddles the porous corner
    m[49, 50] = 3
    m[45:49, 45:49] = 3
    m[200:260, 100:180] = 1
    m[300:340, 400:460] = 4
    maps["straddle"] = m
    m = np.zeros((H, W), np.int8)
    _spiral(H, W, 10, 10, 300, 1, m)
    _spiral(H, W, 20, 330, 280, 4, m, gap=3)
    m[330:470, 20:300] = 3
    m[340:460, 30:290] = 0
    _spiral(H, W, 345, 35, 110, 2, m)  # spiral inside a class-3 ring
    maps["spirals"] = m
    maps["speckle"] = rng.integers(0, 5, (H, W)).astype(np.int8) * (
        rng.random((H, W)) < 0.3
    ).astype(np.int8)
    return maps


def _segment_dist(yy, xx, y0, x0, y1, x1):
    """Distance of every pixel to the segment (y0, x0)-(y1, x1)."""
    dy, dx = y1 - y0, x1 - x0
    t = np.clip(((yy - y0) * dy + (xx - x0) * dx) / max(dy * dy + dx * dx,
                                                       1e-9), 0.0, 1.0)
    return np.hypot(yy - (y0 + t * dy), xx - (x0 + t * dx))


def synthetic_frames(n: int, seed: int = SEED):
    """(n, H, W, 3) uint8 frames of two moving instruments (a shaft and
    two tips each) on a noisy background, drawn with numpy. Every fourth
    frame is plain noise and frames 40..47 are blank (a cut to black), so
    a random-weight model's class maps range from fragmented (noise) to
    clean (blank windows) and the decode takes each of its tiers."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    frames = np.empty((n, H, W, 3), np.uint8)
    tools = [[0.3 * W, 0.5 * H, 0.5], [0.7 * W, 0.5 * H, 3.5]]
    for f in range(n):
        if 40 <= f < 48:
            frames[f] = 8
            continue
        if f % 4 == 3:
            frames[f] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            continue
        img = np.full((H, W, 3), 40, np.uint8)
        img += rng.integers(0, 20, img.shape, dtype=np.uint8)
        for tool in tools:
            cx, cy, a = tool
            bx, by = cx - 150 * np.cos(a), cy - 150 * np.sin(a)
            img[_segment_dist(yy, xx, by, bx, cy, cx) < 12] = (180, 180, 190)
            for s in (0.4, -0.4):
                tx, ty = cx + 40 * np.cos(a + s), cy + 40 * np.sin(a + s)
                img[np.hypot(yy - ty, xx - tx) < 14] = (220, 220, 80)
            tool[0] = float(np.clip(cx + rng.uniform(-6, 6), 60, W - 60))
            tool[1] = float(np.clip(cy + rng.uniform(-6, 6), 60, H - 60))
            tool[2] = a + rng.uniform(-0.1, 0.1)
        frames[f] = img
    return frames


# -------------------------------------------------------------- phases
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from mfcnet_tpu_torch.ops._build import load

    t0 = time.perf_counter()
    kl = load()
    log(f"kernels built from {CSRC}{{{','.join(sorted(kl.paths))}}} for "
        f"sm_90a into {sorted(str(p) for p in kl.paths.values())} (one nvcc "
        f"per source, in parallel: {kl.build_seconds:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s)")
    regs = [int(w.split()[1]) for line in kl.build_log.splitlines()
            for w in [line[line.find("Used "):]] if "Used " in line]
    spills = sum(" 0 bytes spill stores" not in line
                 for line in kl.build_log.splitlines()
                 if "spill stores" in line)
    if regs:
        log(f"ptxas: {len(regs)} kernels, max {max(regs)} registers/thread, "
            f"{spills} with spills")
    return smi


def _equal(name, got, want):
    """Require bit equality; return the max |difference| (0.0)."""
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() \
            if got.shape == want.shape else float("nan")
        raise AssertionError(f"{name}: kernel != plain (max |diff| {diff})")
    return 0.0


def phase_kernels():
    """Each kernel against its plain version on the crafted maps."""
    import torch

    from mfcnet_tpu_torch.ops import cc

    dev = torch.device("cuda")
    for name, m in crafted_class_maps().items():
        u = torch.from_numpy(m).to(dev)[None].contiguous()
        got = cc.union_flood_cc_cid(u, K)
        want = cc.union_flood_cc_cid_plain(u, K)
        for g, w, nm in zip(got, want,
                            ("cid", "he", "cide", "ncomp", "conflict")):
            _equal(f"union_flood_cc_cid[{name}].{nm}", g, w)
        cid, he, cide, ncomp, conflict = got
        st, cl = cc.onehot_stats(cid, he, cide, K)
        st_p, cl_p = cc.onehot_stats_plain(cid, he, cide, K)
        _equal(f"onehot_stats[{name}]", st, st_p)
        _equal(f"onehot_stats[{name}].ccls", cl, cl_p)
        # the per-blob tier's inputs: the four class masks of this frame
        masks4 = torch.stack([u[0] == c for c in (1, 2, 3, 4)]).contiguous()
        got = cc.flood_cc_cid(masks4, K)
        want = cc.flood_cc_cid_plain(masks4, K)
        for g, w, nm in zip(got, want, ("cid", "filled", "ncomp")):
            _equal(f"flood_cc_cid[{name}].{nm}", g, w)
        st, _ = cc.onehot_stats(got[0], got[1] * 8, None, K)
        st_p, _ = cc.onehot_stats_plain(got[0], got[1] * 8, None, K)
        _equal(f"onehot_stats_base[{name}]", st, st_p)
        for conn in (4, 8):
            for mm in (masks4, ~masks4):
                mm = mm.contiguous()
                _equal(f"connected_components[{name},{conn}]",
                       cc.connected_components(mm, conn),
                       cc.connected_components_plain(mm, conn))
        log(f"kernels == plain on '{name}': ncomp={int(ncomp[0])} "
            f"conflict={bool(conflict[0])}")
    torch.cuda.synchronize()
    # every comparison above demanded bit equality
    errs = {k: 0.0 for k in CC_KERNELS}
    errs["flow_warp"] = _check_warp_kernel()
    errs["raft_update"] = _check_raft_update_kernel()
    return errs


def _warp_flows(gen):
    """Flow fields (2, 2, H, W) for the warp checks: bounded, beyond the
    +-24 rows that the TPU tier handed to its fallback, leaving the image,
    and zero (a non-identity sample on the 576x720 grid)."""
    import torch

    def randn(scale):
        return torch.randn(2, 2, H, W, generator=gen) * scale

    big = randn(4.0)
    big[:, 1] += torch.where(torch.rand(2, H, W, generator=gen) < 0.05,
                             90.0, 0.0)
    return {"bounded": randn(4.0), "beyond the band": big,
            "leaves the image": randn(4.0) + 700.0,
            "zero": torch.zeros(2, 2, H, W)}


def _check_warp_kernel():
    import torch

    from mfcnet_tpu_torch.ops import warp

    gen = torch.Generator().manual_seed(SEED)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        atol = WARP_ATOL[str(dt).split(".")[1]]
        for ch in (C, C + 1):
            maps = torch.rand(2, ch, H, W, generator=gen).cuda().to(dt)
            for name, flow in _warp_flows(gen).items():
                flow = flow.cuda()
                got = warp.flow_warp(maps, flow, (576, 720))
                want = warp.flow_warp_plain(maps, flow, (576, 720))
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not (got.shape == want.shape and got.dtype == dt
                        and err <= atol):
                    raise AssertionError(
                        f"flow_warp[{dt}, C={ch}, {name}]: kernel != plain "
                        f"(max |diff| {err} > {atol})")
                if name == "leaves the image" and got.abs().max() != 0:
                    raise AssertionError("flow_warp: samples outside the "
                                         "image must be zero")
                if name == "zero" and (got.float() - maps.float()).abs(
                        ).max() < 0.01:
                    raise AssertionError("flow_warp: zero flow on the "
                                         "576x720 grid is not an identity")
                worst = max(worst, err)
    # the second entry point (absolute coordinates) through
    # grid_sample_bilinear, both align_corners and padding modes
    img = torch.randn(2, 3, 50, 70, generator=gen).cuda()
    gx = (torch.rand(2, 100, 120, generator=gen) * 2.4 - 1.2).cuda()
    gy = (torch.rand(2, 100, 120, generator=gen) * 2.4 - 1.2).cuda()
    for ac in (True, False):
        for pm in ("zeros", "border"):
            got = warp.grid_sample_bilinear(img, gx, gy, ac, pm)
            want = warp.grid_sample_bilinear_plain(img, gx, gy, ac, pm)
            err = (got - want).abs().max().item()
            if err > WARP_ATOL["float32"]:
                raise AssertionError(f"warp_abs[{ac}, {pm}]: {err}")
            worst = max(worst, err)
    log(f"flow_warp kernel vs plain: 2x{{{C},{C + 1}}}x{H}x{W}, f32 (atol "
        f"{WARP_ATOL['float32']}) and bf16 (atol {WARP_ATOL['bfloat16']}), "
        f"bounded / beyond the band / out of the image / zero flow on the "
        f"576x720 grid; warp_abs 4 modes: max |diff| {worst}")
    return worst


def _raft_update_inputs(ub, dt, B, H8, W8, gen):
    import torch

    from mfcnet_tpu_torch.ops import raft_update as ru

    n = H8 * W8

    def t(cols, fn):
        return fn(torch.randn(B, n, cols, generator=gen)).cuda()

    return (t(256, torch.relu).to(dt), t(128, torch.relu).to(dt),
            t(128, torch.relu).to(dt), t(128, torch.tanh),
            t(2, lambda v: v), ru.pack_update_weights(ub, dt), H8, W8)


def _check_raft_update_kernel():
    import torch

    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain version's float32 products must "
                             "not run in TF32")
    gen = torch.Generator().manual_seed(SEED)
    ub = init_weights(UpdateBlock(), gen).cuda().eval()
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        atol, rtol = RAFT_TOL[str(dt).split(".")[1]]
        for B, H8, W8 in ((2, H // 16, W // 16), (2, 9, 13)):
            args = _raft_update_inputs(ub, dt, B, H8, W8, gen)
            got = ru.raft_update(*args)
            torch.cuda.synchronize()
            want = ru.raft_update_plain(*args)
            for g, w, nm in zip(got, want, ("net", "delta")):
                err = (g - w).abs().max().item()
                if not torch.allclose(g, w, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"raft_update[{dt}, {B}x{H8}x{W8}].{nm}: kernel != "
                        f"plain (max |diff| {err}; atol {atol} rtol {rtol})")
                if dt == torch.bfloat16:
                    worst = max(worst, err)
            log(f"raft_update kernel vs plain [{dt}, {B}x{H8}x{W8} tokens]: "
                f"max |diff| net {(got[0] - want[0]).abs().max().item():.3g} "
                f"delta {(got[1] - want[1]).abs().max().item():.3g} "
                f"(atol {atol}, rtol {rtol})")
    return worst


def _plain_kernels():
    """Context in which the decode runs every kernel's plain version (on
    the same CUDA tensors), for the kernel-vs-plain decode check."""
    import contextlib
    from unittest import mock

    from mfcnet_tpu_torch.ops import cc
    from mfcnet_tpu_torch.track import decode_device as dd

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.multiple(
        cc, connected_components=cc.connected_components_plain,
        flood_cc_cid=cc.flood_cc_cid_plain,
        union_flood_cc_cid=cc.union_flood_cc_cid_plain,
        onehot_stats=cc.onehot_stats_plain,
    ))
    stack.enter_context(mock.patch.object(
        dd, "connected_components", cc.connected_components_plain))
    return stack


def _window_probs(engine, frames, i):
    """float32 (H, W, C) probabilities of the window ending at frame i."""
    import torch

    x = engine._normalize(np.stack(frames[i - T + 1:i + 1][::-1]))
    with torch.no_grad():
        y = engine.model.base_nchw(x)
        logits = engine.model.fuse_nchw(y.reshape(1, T * C, H, W))
    return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)[0]


def _check_rows(rows, n):
    if rows.shape != (n, 12):
        raise AssertionError(f"CSV shape {rows.shape} != {(n, 12)}")
    if not np.isnan(rows[:T - 1]).all():
        raise AssertionError("warmup rows must be NaN")
    vals = rows[~np.isnan(rows)]
    if vals.size == 0:
        raise AssertionError("no keypoint detected in any frame")
    xs, ys = rows[:, 0::2], rows[:, 1::2]
    ok = lambda a, hi: np.all(np.isnan(a) | ((a >= 0) & (a < hi)))  # noqa: E731
    if not (ok(xs, W) and ok(ys, H)):
        raise AssertionError("keypoints outside the frame")


def phase_slice(frames):
    """The tracker's main path at full width; returns (engine, model,
    launches of the main-path run, tier counts)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.ops import cc
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"TernausNetMulti-Basic full width: {n_params} parameters, "
        f"T={T} C={C} {H}x{W} bf16, seed {SEED}")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False)
    engine = InferenceEngine(model, cfg)
    with tempfile.TemporaryDirectory() as d:
        cc.reset_launches()
        dd.reset_tier_counts()
        rows, fps = track_on_frames(frames, None, cfg, d, name="smoke",
                                    engine=engine)
        launches = dict(cc.LAUNCHES)
        tiers = dict(dd.TIER_COUNTS)
        csv = np.loadtxt(Path(d) / "smoke_tracked.csv", delimiter=",")
    _check_rows(csv, len(frames))
    log(f"incremental: {len(frames)} frames -> CSV {csv.shape}, "
        f"{int(np.isfinite(csv[:, 10]).sum())} frames with a right base "
        f"(first run, includes warm-up: {fps:.2f} frames/s)")
    log(f"kernel launches on the main path: {json.dumps(launches)}")
    log(f"frames per decode tier: {json.dumps(tiers)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    full_cfg = dataclasses.replace(cfg, mode="full")
    with tempfile.TemporaryDirectory() as d:
        rows_full, _ = track_on_frames(frames[:8], model, full_cfg, d,
                                       name="full", device="cuda")
        _check_rows(np.loadtxt(Path(d) / "full_tracked.csv", delimiter=","),
                    8)
    log("full mode: 8 frames -> CSV (8, 12)")

    with parity_mode(), tempfile.TemporaryDirectory() as d:
        c32 = dataclasses.replace(cfg, dtype="float32")
        n = 48
        r_inc, _ = track_on_frames(frames[:n], model, c32, d, name="i",
                                   device="cuda")
        r_full, _ = track_on_frames(frames[:n], model,
                                    dataclasses.replace(c32, mode="full"),
                                    d, name="f", device="cuda")
        if not np.array_equal(r_inc, r_full, equal_nan=True):
            bad = np.nonzero(~((r_inc == r_full) |
                               (np.isnan(r_inc) & np.isnan(r_full))))
            raise AssertionError(f"f32 incremental != full at {bad}")
        log(f"f32 parity mode: incremental rows == full rows ({n} frames)")
        eng32 = InferenceEngine(model, c32, device="cuda")
        checked = 0
        for i in (4, 7, 15, 23, 33, 44, 47, 55):
            probs = _window_probs(eng32, frames, i)
            got = dd.decode_keypoints_device(probs, 100)
            with _plain_kernels():
                want = dd.decode_keypoints_device(probs, 100)
            _equal(f"decode rows, window ending at frame {i}", got, want)
            checked += 1
        for name, m in crafted_class_maps().items():
            pred = torch.from_numpy(
                np.choose(m, [0, 3, 1, 4, 2]).astype(np.int32)).cuda()
            probs = torch.rand(H, W, C, generator=gen).cuda()
            got = dd.decode_keypoints_device(probs, 100, pred=pred)
            with _plain_kernels():
                want = dd.decode_keypoints_device(probs, 100, pred=pred)
            _equal(f"decode rows, crafted map {name}", got, want)
            checked += 1
        log(f"decode rows through the kernels == through the plain versions "
            f"({checked} frames: model windows and crafted maps)")
    torch.cuda.synchronize()
    return engine, launches, tiers


def _plain_flow_kernels():
    """Context in which the flow path runs the plain versions of the warp
    and of the RAFT update step (on the same CUDA tensors)."""
    import contextlib
    from unittest import mock

    from mfcnet_tpu_torch.models import mfcnet
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.ops import warp

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ru, "raft_update",
                                          ru.raft_update_plain))
    stack.enter_context(mock.patch.object(mfcnet, "flow_warp",
                                          warp.flow_warp_plain))
    return stack


def _keep_probs(engine):
    """Make ``engine`` keep the (H, W, C) float32 probabilities of its
    newest window as ``engine.kept_probs``, beside what it returns."""
    import torch

    def outputs(logits):
        probs = torch.softmax(logits.float(), dim=1)
        engine.kept_probs = probs.permute(0, 2, 3, 1)[0]
        return type(engine)._outputs(engine, logits)

    engine._outputs = outputs


def _reset_all_launches():
    from mfcnet_tpu_torch.ops import cc, raft_update, warp

    for mod in (cc, raft_update, warp):
        mod.reset_launches()


def _all_launches():
    from mfcnet_tpu_torch.ops import cc, raft_update, warp

    return {**cc.LAUNCHES, "flow_warp": warp.LAUNCHES["flow_warp"],
            "raft_update": raft_update.LAUNCHES["raft_update"]}


def _depth_frames(frames):
    """(n, H, W) uint8 stand-in depth maps: the frames' red channel."""
    return np.ascontiguousarray(frames[..., 0])


def phase_flow_slice(frames):
    """The flow path at full width: TernausNetMulti-Basic with
    add_optflow_inputs, RAFT at raft_large's widths with 12 iterations,
    bf16, fused update step. Returns (engine, launches of the main-path
    run, number of fused frames)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, generator=gen)
    flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
    n_flow = sum(p.numel() for p in flow_model.parameters())
    log(f"flow path: TernausNetMulti-Basic + frozen RAFT (raft_large widths, "
        f"{n_flow} parameters, iters={FLOW_ITERS}, fused update step), "
        f"T={T} {H}x{W} bf16, seed {SEED}")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    # no device argument: the entry points run on the card by default
    engine = InferenceEngine(model, cfg, flow_model=flow_model)
    if engine.device.type != "cuda":
        raise AssertionError("the engine must default to the card")
    if not engine.flow_model.fused_update:
        raise AssertionError("a bf16 engine must run the fused update step")
    n = FLOW_FRAMES
    fused = n - (T - 1)
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        _, fps = track_on_frames(frames[:n], None, cfg, d, name="flow",
                                 engine=engine)
        launches = _all_launches()
        csv = np.loadtxt(Path(d) / "flow_tracked.csv", delimiter=",")
    _check_rows(csv, n)
    log(f"flow path, incremental: {n} frames -> CSV {csv.shape} (first run, "
        f"includes warm-up: {fps:.2f} frames/s)")
    log(f"kernel launches on the flow path: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the flow path: "
                             f"{missing}")
    if launches["raft_update"] != FLOW_ITERS * fused \
            or launches["flow_warp"] != fused:
        raise AssertionError(
            f"expected {FLOW_ITERS} update steps and 1 warp per fused frame "
            f"({fused} frames), got {launches}")

    with tempfile.TemporaryDirectory() as d:
        track_on_frames(frames[:8], model,
                        dataclasses.replace(cfg, mode="full"), d, name="full",
                        flow_model=flow_model, device="cuda")
        _check_rows(np.loadtxt(Path(d) / "full_tracked.csv", delimiter=","),
                    8)
    log("flow path, full mode: 8 frames -> CSV (8, 12)")

    # through the kernels against through the plain versions, bf16: the
    # same engine state, window by window, on the probabilities the
    # engines themselves decoded
    plain_engine = InferenceEngine(model, cfg, flow_model=flow_model)
    engine.reset()
    _keep_probs(engine)
    _keep_probs(plain_engine)
    worst_heat, worst_prob, worst_flow = 0.0, 0.0, 0.0
    flipped, unexplained, clear_share, windows = 0.0, 0, 1.0, 0
    fault = float("inf")
    from mfcnet_tpu_torch.track import outputs as out

    for i in range(6):
        got = engine.step_async(frames[i])
        with _plain_flow_kernels():
            want = plain_engine.step_async(frames[i])
        if got is None:
            continue
        with torch.no_grad():
            f_got = out.flow_from_feature_ring(*engine.flow_state, (H, W),
                                               engine.flow_model)
            with _plain_flow_kernels():
                f_want = out.flow_from_feature_ring(
                    *plain_engine.flow_state, (H, W), plain_engine.flow_model)
        worst_flow = max(worst_flow, (f_got - f_want).abs().max().item())
        worst_heat = max(worst_heat, (got[2].float() - want[2].float()
                                      ).abs().max().item())
        p_got, p_want = engine.kept_probs, plain_engine.kept_probs
        worst_prob = max(worst_prob, (p_got - p_want).abs().max().item())
        # what a faulty warp would do to the same window: the plain head on
        # the plain engine's maps with the flow taken away
        with torch.no_grad(), _plain_flow_kernels():
            p_zero = torch.softmax(plain_engine.model.fuse_nchw(
                plain_engine.seg_buf, optflow=torch.zeros_like(f_want),
                depth=None).float(), dim=1).permute(0, 2, 3, 1)[0]
        fault = min(fault, (p_zero - p_want).abs().max().item())
        top2 = p_got.topk(2, dim=-1).values
        differ = got[0] != want[0]
        clear = (top2[..., 0] - top2[..., 1]) > 2 * FLOW_PROB_TOL
        flipped = max(flipped, differ.float().mean().item())
        unexplained += int((differ & clear).sum().item())
        clear_share = min(clear_share, clear.float().mean().item())
        windows += 1
    log(f"flow engine through the kernels vs through the plain versions, "
        f"bf16, {windows} windows: max |flow diff| {worst_flow:.4g} px, max "
        f"|probability diff| {worst_prob:.4g} (limit {FLOW_PROB_TOL:.4g}; "
        f"a zeroed flow moves them by {fault:.4g} at least), "
        f"max |heat diff| {worst_heat:.4g}; class-mask pixels that differ: "
        f"{flipped:.4%} at most per window, of which {unexplained} where the "
        f"top-2 margin exceeds {2 * FLOW_PROB_TOL:.4g} (must be 0; "
        f"{clear_share:.4%} of a window's pixels at least have such a margin)")
    # bf16 rounding flips inside the 12 update steps move the flow by a few
    # hundredths of a pixel at most, and every class probability by no more
    # than FLOW_PROB_TOL (the float16 heats, rounded once more, by no more
    # than twice that). The random-weight model's probabilities are nearly
    # flat, so the limit is also held against what a lost warp does to the
    # same windows: it has to lie four times below that. Two probability
    # vectors within the limit can disagree on the argmax only where the
    # top two lie within twice the limit of each other, which is most of
    # this model's pixels: the share of mask pixels that differ is reported
    # and has no limit, a pixel that differs outside that band is a fault
    if (worst_flow > 0.1 or worst_prob > FLOW_PROB_TOL
            or worst_heat > 2 * FLOW_PROB_TOL or unexplained
            or fault < 4 * FLOW_PROB_TOL):
        raise AssertionError("flow path: kernels and plain versions disagree")
    for e in (engine, plain_engine):
        del e._outputs, e.kept_probs

    with parity_mode():
        c32 = dataclasses.replace(cfg, dtype="float32")
        engines = {
            m: InferenceEngine(model, dataclasses.replace(c32, mode=m),
                               flow_model=flow_model, device="cuda")
            for m in ("incremental", "full")
        }
        heat, mism, compared = 0.0, 0.0, 0
        for i in range(8):
            outs = {m: e.step_async(frames[i]) for m, e in engines.items()}
            if outs["full"] is None:
                continue
            heat = max(heat, (outs["incremental"][2].float()
                              - outs["full"][2].float()).abs().max().item())
            mism = max(mism, (outs["incremental"][0] != outs["full"][0]
                              ).float().mean().item())
            compared += 1
        with tempfile.TemporaryDirectory() as d:
            rows = {
                m: track_on_frames(frames[:12], None, e.cfg, d, name=m,
                                   engine=e)[0]
                for m, e in engines.items()
            }
        same_nan = np.isnan(rows["incremental"]) == np.isnan(rows["full"])
        both = ~np.isnan(rows["incremental"]) & ~np.isnan(rows["full"])
        row_diff = (np.abs(rows["incremental"][both] - rows["full"][both]).max()
                    if both.any() else 0.0)
        log(f"flow path, f32 parity mode, incremental vs full: {compared} "
            f"windows, max |heat diff| {heat:.4g}, class-mask mismatch "
            f"{mism:.4%}; 12-frame rows: NaN pattern equal "
            f"{bool(same_nan.all())}, max |row diff| {row_diff:.4g} px")
        # the feature ring reorders no arithmetic, but cuDNN sees the earlier
        # frames' encoder at batch 1 (ring) or batch 2 (window): float32
        # sums in another order, at most a float16 heat step or two; the
        # argmax of nearly tied probabilities may flip on it (reported)
        if heat > 1e-3 or mism > 0.01:
            raise AssertionError("flow path: f32 incremental != full")

    # one short run with depth inputs
    dmodel = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, generator=gen)
    dcfg = dataclasses.replace(cfg, add_depth_inputs=True)
    with tempfile.TemporaryDirectory() as d:
        rows, _ = track_on_frames(frames[:8], dmodel, dcfg, d, name="depth",
                                  depth_frames=_depth_frames(frames[:8]),
                                  flow_model=flow_model, device="cuda")
        _check_rows(np.loadtxt(Path(d) / "depth_tracked.csv", delimiter=","),
                    8)
    log("flow + depth path (6 warped channels per map): 8 frames -> CSV "
        "(8, 12)")
    torch.cuda.synchronize()
    return engine, launches, fused


def _event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_timings(engine, frames, smi):
    """Tracker frames/s, decode ms/frame, kernels against plain."""
    import torch

    from mfcnet_tpu_torch.ops import cc
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    out = {}
    with tempfile.TemporaryDirectory() as d:
        dd.reset_tier_counts()
        _, fps = track_on_frames(frames, None, engine.cfg, d, name="warm",
                                 engine=engine)
    out["tracker_fps"] = fps
    log(f"[{smi}] tracker, incremental bf16 device decode, warm, "
        f"{len(frames)} host frames: {fps:.2f} frames/s "
        f"(tiers {json.dumps(dict(dd.TIER_COUNTS))})")

    model_probs = [_window_probs(engine, frames, i) for i in (15, 23, 33)]
    clean = torch.from_numpy(np.choose(crafted_class_maps()["clean"],
                                       [0, 3, 1, 4, 2]).astype(np.int32)).cuda()
    rprobs = torch.rand(H, W, C, device="cuda")
    ms_model = np.mean([_host_ms(lambda p=p: dd.decode_keypoints_device(p, 100),
                                5) for p in model_probs])
    ms_clean = _host_ms(lambda: dd.decode_keypoints_device(rprobs, 100,
                                                          pred=clean), 20)
    out["decode_ms_model"] = float(ms_model)
    out["decode_ms_union"] = ms_clean
    log(f"[{smi}] decode ms/frame: {ms_model:.3f} on the random model's "
        f"class maps (tiers 2/3), {ms_clean:.3f} on a clean map (union tier)")

    # the per-frame tier-flag sync: union tier + flag read vs union tier
    # enqueued back to back
    u = torch.from_numpy(crafted_class_maps()["clean"]).cuda()[None]
    sync_ms = _host_ms(lambda: bool(cc.union_stats(u, K)[3].any()), 50)
    async_ms = _host_ms(lambda: cc.union_stats(u, K), 50)
    out["flag_sync_ms"] = sync_ms - async_ms
    log(f"[{smi}] union tier with the host flag read {sync_ms:.3f} ms, "
        f"without {async_ms:.3f} ms per frame")

    # each kernel against its plain version at the main path's shapes
    cid, he, cide, _, _ = cc.union_flood_cc_cid(u, K)
    m4 = torch.stack([u[0] == c for c in (1, 2, 3, 4)]).contiguous()
    filled = cc.flood_cc_cid(m4, K)[1].bool()
    calls = {
        "connected_components": (
            lambda: cc.connected_components(filled, 8),
            lambda: cc.connected_components_plain(filled, 8)),
        "flood_cc_cid": (lambda: cc.flood_cc_cid(m4, K),
                         lambda: cc.flood_cc_cid_plain(m4, K)),
        "union_flood_cc_cid": (lambda: cc.union_flood_cc_cid(u, K),
                               lambda: cc.union_flood_cc_cid_plain(u, K)),
        "onehot_stats": (lambda: cc.onehot_stats(cid, he, cide, K),
                         lambda: cc.onehot_stats_plain(cid, he, cide, K)),
    }
    # bounds: each input read once and each output written once over the
    # card's memory rate; the labelling's integer work depends on the data
    # and has no rate in the table, so bytes set the bound
    io = {
        "connected_components": (filled,),
        "flood_cc_cid": (m4,),
        "union_flood_cc_cid": (u,),
        "onehot_stats": (cid, he, cide),
    }
    times, bounds = {}, {}
    for name, (kern, plain) in calls.items():
        times[name] = _in_turns(name, kern, plain, smi, "clean 480x640 map")
        outs = kern()
        outs = outs if isinstance(outs, tuple) else (outs,)
        bounds[name] = (_nbytes(*io[name], *outs) / PEAK_BYTES * 1e3, "bytes")
        log(f"[{smi}] {name}: bound {bounds[name][0]:.5f} ms (bytes: "
            f"{_nbytes(*io[name], *outs)} B at {PEAK_BYTES / 1e12} TB/s)")
    return out, times, bounds


def _graph_ms(fn, reps=20, rounds=10):
    """Device ms per call of ``fn``: ``reps`` calls captured in a CUDA
    graph and replayed, so that the host's enqueue time (which exceeds a
    ~20 us kernel's own) stays out of the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(rounds):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * rounds)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _in_turns(name, kern, plain, smi, what, kreps=50, preps=3,
              timer=_event_ms):
    """ms per call, in turns (plain, kernel, kernel, plain); the better of
    each pair."""
    p1 = timer(plain, preps)
    k1 = timer(kern, kreps)
    k2 = timer(kern, kreps)
    p2 = timer(plain, preps)
    log(f"[{smi}] {name}: kernel {min(k1, k2):.4f} ms, plain "
        f"{min(p1, p2):.4f} ms ({what}; runs {k1:.4f}/{k2:.4f} vs "
        f"{p1:.4f}/{p2:.4f})")
    return min(k1, k2), min(p1, p2)


def _host_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_flow_timings(engine, frames, smi):
    """Flow path frames/s, RAFT's share of the frame, the two flow kernels
    against their plain versions, bounds and library yardsticks. Returns
    (times, bounds, library ms) by kernel name."""
    import torch
    import torch.nn.functional as F

    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    n = FLOW_FRAMES
    with tempfile.TemporaryDirectory() as d:
        _, fps = track_on_frames(frames[:n], None, engine.cfg, d, name="warm",
                                 engine=engine)
    log(f"[{smi}] tracker, flow path (RAFT x{FLOW_ITERS} fused, warp), "
        f"incremental bf16 device decode, warm, {n} host frames: "
        f"{fps:.2f} frames/s")

    # RAFT's share of the frame: the provider's per-frame work (encoders of
    # the new frame, the recurrent solve over T-1 pairs, the x2 rescale)
    # against the whole step, host clock around synchronized work
    fm = engine.flow_model
    x = engine._normalize(frames[n - 1][None])

    def flow_part():
        with torch.no_grad():
            f_new, net, inp = out.flow_ingest(x, fm)
            return out.flow_from_feature_ring(
                torch.cat([f_new[:, None], engine.flow_state[0][:, :T - 1]],
                          1), net, inp, (H, W), fm)

    it = iter(range(10 ** 9))
    step_ms = _host_ms(lambda: engine.step_async(frames[next(it) % n]), 16)
    flow_ms = _host_ms(flow_part, 16)
    log(f"[{smi}] flow path step {step_ms:.3f} ms/frame (synchronized), of "
        f"which the flow provider {flow_ms:.3f} ms = "
        f"{flow_ms / step_ms:.1%} of the frame")

    # one update iteration, piece by piece, at the main path's shapes
    ub = fm.update_block
    H8, W8 = H // 16, W // 16
    B, N = T - 1, H8 * W8
    gen = torch.Generator().manual_seed(SEED)
    args = _raft_update_inputs(ub, torch.bfloat16, B, H8, W8, gen)
    c1, f1, inp, net, flow, packed = args[:6]
    feats = engine.flow_state[0]
    from mfcnet_tpu_torch.models.raft import (
        PackedPyramid,
        build_corr_pyramid,
        coords_grid,
    )

    with torch.no_grad():
        pyramid = PackedPyramid(build_corr_pyramid(
            feats[0, :1].expand(B, H8, W8, 256), feats[0, 1:], 4), 4)
        coords = coords_grid(B, H8, W8, "cuda") + flow.view(B, H8, W8, 2)
        corr = pyramid.lookup(coords).view(B, N, -1)
        lookup_ms = _event_ms(lambda: pyramid.lookup(coords), 20)
        step_fused_ms = _event_ms(lambda: ru.fused_update_step(
            ub, packed, corr, inp, net, flow, H8, W8), 20)
        lookup_host = _host_ms(lambda: pyramid.lookup(coords), 20)
    log(f"[{smi}] one RAFT iteration at {B}x{H8}x{W8} tokens: lookup "
        f"{lookup_ms:.4f} ms device ({lookup_host:.4f} ms host-visible), "
        f"fused update step (convcorr1 + convflow1 + kernel) "
        f"{step_fused_ms:.4f} ms")

    times, bounds, library = {}, {}, {}
    times["raft_update"] = _in_turns(
        "raft_update", lambda: ru.raft_update(*args),
        lambda: ru.raft_update_plain(*args), smi,
        f"bf16, {B}x{H8}x{W8} tokens")
    macs = sum(
        packed[f"w_{k}"].shape[0] * packed[f"w_{k}"].shape[1] * cols
        for k, cols in (("c2", 192), ("f2", 64), ("cv", 126), ("zr_h", 256),
                        ("q_h", 128), ("zr_v", 256), ("q_v", 128),
                        ("fl1", 256), ("fl2", 2)))
    got = ru.raft_update(*args)
    b_ops = 2 * macs * B * N / PEAK_BF16 * 1e3
    b_bytes = _nbytes(c1, f1, inp, net, flow, *packed.values(),
                      *got) / PEAK_BYTES * 1e3
    bounds["raft_update"] = (max(b_ops, b_bytes),
                             "operations" if b_ops >= b_bytes else "bytes")
    # library yardstick: the provider's own unfused UpdateBlock (cuDNN,
    # bf16, channels_last, without the mask head; it includes convcorr1 and
    # convflow1, which the kernel leaves outside)
    def cl(t, ch):
        return t.view(B, H8, W8, ch).permute(0, 3, 1, 2)

    with torch.no_grad():
        lib_args = (cl(net.bfloat16(), 128), cl(inp, 128),
                    cl(corr.bfloat16(), corr.shape[-1]),
                    cl(flow.bfloat16(), 2))
        lib_eager = _event_ms(lambda: ub(*lib_args), 20)
        library["raft_update"] = _graph_ms(lambda: ub(*lib_args), 10, 5)
    log(f"[{smi}] raft_update: {macs} multiply-adds per token x {B * N} "
        f"tokens; bound {bounds['raft_update'][0]:.5f} ms "
        f"({bounds['raft_update'][1]}: operations {b_ops:.5f} ms at 989 "
        f"TFLOP/s bf16, bytes {b_bytes:.5f} ms); unfused UpdateBlock "
        f"(cuDNN, bf16, channels_last) {library['raft_update']:.4f} ms per "
        f"iteration of device time (CUDA-graph replay), {lib_eager:.4f} ms "
        f"called eagerly (host-bound)")

    # the update step against its token count: a near-empty call (the floor
    # of ten dependent launches), the tracker's size, and the frozen
    # provider's size inside a training step (8 pairs at 60x80)
    for sb, sh, sw in ((1, 2, 2), (B, H8, W8), (8, 60, 80)):
        sargs = _raft_update_inputs(ub, torch.bfloat16, sb, sh, sw, gen)
        k_ms = _event_ms(lambda: ru.raft_update(*sargs), 20)
        sc1, _, sinp, snet, sflow = sargs[:5]
        with torch.no_grad():
            def scl(t, ch):
                return t.view(sb, sh, sw, ch).permute(0, 3, 1, 2)

            scorr = torch.randn(sb, sh * sw, corr.shape[-1], generator=gen
                                ).cuda().bfloat16()
            l_args = (scl(snet.bfloat16(), 128), scl(sinp, 128),
                      scl(scorr, corr.shape[-1]), scl(sflow.bfloat16(), 2))
            l_ms = _graph_ms(lambda: ub(*l_args), 10, 5)
        tok = sb * sh * sw
        log(f"[{smi}] raft_update at {sb}x{sh}x{sw} = {tok} tokens: kernel "
            f"{k_ms:.4f} ms ({2 * macs * tok / k_ms / 1e9:.1f} TFLOP/s), "
            f"unfused UpdateBlock (cuDNN, bf16, graph replay) {l_ms:.4f} ms")

    # the warp at the main path's shapes and on its own last window
    Cw = C
    maps = engine.seg_buf[:, Cw:].reshape(B, Cw, H, W).contiguous()
    with torch.no_grad():
        fl = out.flow_from_feature_ring(*engine.flow_state, (H, W), fm)
    fl = fl.reshape(B, 2, H, W).contiguous()
    # a ~20 us kernel: eager launches are bound by the host's enqueue time,
    # so kernel, plain version and library call are timed as graph replays
    eager = _event_ms(lambda: warp.flow_warp(maps, fl, (576, 720)), 50)
    times["flow_warp"] = _in_turns(
        "flow_warp", lambda: warp.flow_warp(maps, fl, (576, 720)),
        lambda: warp.flow_warp_plain(maps, fl, (576, 720)), smi,
        f"device time in CUDA-graph replays; eager wrapper calls "
        f"{eager:.4f} ms, host-bound; bf16 maps {B}x{Cw}x{H}x{W}, the "
        f"engine's flow, max |flow| {fl.abs().max().item():.1f} px",
        kreps=20, preps=3, timer=_graph_ms)
    got = warp.flow_warp(maps, fl, (576, 720))
    w_bytes = _nbytes(maps, fl, got) / PEAK_BYTES * 1e3
    w_ops = B * H * W * (30 + 7 * Cw) / PEAK_F32 * 1e3
    bounds["flow_warp"] = (max(w_bytes, w_ops),
                           "bytes" if w_bytes >= w_ops else "operations")
    # library yardstick: F.grid_sample on a ready-made normalized grid (the
    # grid is formed outside the timing; maps and grid in bf16, the only
    # mixed-type-free call it offers for bf16 maps)
    from mfcnet_tpu_torch.ops.warp import _flow_grid

    gx, gy = _flow_grid(fl, (576, 720))
    grid = torch.stack([gx, gy], -1).to(maps.dtype)
    library["flow_warp"] = _graph_ms(lambda: F.grid_sample(
        maps, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 20)
    log(f"[{smi}] flow_warp: bound {bounds['flow_warp'][0]:.5f} ms "
        f"({bounds['flow_warp'][1]}: {_nbytes(maps, fl, got)} B at 3.35 "
        f"TB/s); F.grid_sample {library['flow_warp']:.4f} ms")
    return times, bounds, library


def main():
    # the port itself, from this checkout (fails in a bare directory)
    import mfcnet_tpu_torch  # noqa: F401

    smi = phase_device()
    errs = phase_kernels()
    frames = synthetic_frames(64)
    engine, launches_noflow, _ = phase_slice(frames)
    flow_engine, launches, fused = phase_flow_slice(frames)
    _, times, bounds = phase_timings(engine, frames, smi)
    ftimes, fbounds, library = phase_flow_timings(flow_engine, frames, smi)
    times.update(ftimes)
    bounds.update(fbounds)
    import torch

    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "launches_per_frame": launches[name] / fused,
         "launches_no_flow_path": launches_noflow.get(name),
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name, source, replaces in KERNELS
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
