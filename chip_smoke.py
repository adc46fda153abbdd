"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths -- the video tracker with TernausNetMulti-Basic
at full width (T=3, 5 classes, bf16) and ``decode="device"``: at 480x640
without flow and with the frozen RAFT flow provider (raft_large widths,
12 iterations, fused update step), at 512x640 with the frozen UnFlow
provider (its only widths), and the offline flow CLI's batched forward --
through its hand-written CUDA kernels (``mfcnet_tpu_torch/csrc``), in four
phases; a failing phase raises and the script exits non-zero:

1. device and build: requires a CUDA card, prints its name and power
   limit, builds the kernels into ``build/`` (one nvcc per source, in
   parallel);
2. kernels against their plain PyTorch versions: the connected-component
   kernels on crafted 480x640 class maps (integer outputs and the sums
   exactly equal), the flow warp at 2x480x640, the RAFT update step at
   2x30x40 tokens, the correlation at UnFlow's two shapes and the two
   experimental convolutions at the first VGG stage's shapes within the
   tolerances stated beside them;
3. the slices: seeded random weights, synthetic frames, ``track_on_frames``
   in incremental and full mode, without flow, with RAFT (and once with
   depth) and with UnFlow; every kernel's launch count, set to 0 just
   before a main-path run and read just after, must have risen on the
   paths that run it; f32 parity mode checks
   incremental against full and the path through the kernels against the
   path through the plain versions;
4. timings: tracker frames/s on the three paths, decode ms/frame, each
   provider's share of the frame, each kernel against its plain version,
   its bound and, where one PyTorch call computes the same function, that
   call.

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
    ("warp_abs", CSRC + "warp.cu", "mfcnet_tpu/ops/warp_pallas.py:218"),
    ("correlation", CSRC + "correlation.cu",
     "mfcnet_tpu/ops/correlation_pallas.py:29"),
    ("vgg_stage1", CSRC + "stage1.cu",
     "mfcnet_tpu/experimental/stage1_pallas.py:47"),
    ("conv3x3", CSRC + "conv3x3.cu",
     "mfcnet_tpu/experimental/conv3x3_pallas.py:54"),
)
CC_KERNELS = tuple(k[0] for k in KERNELS[:4])
#: the kernels each main path must launch (the two experimental convolutions
#: are on no path, in this package as in the JAX one)
PATH_KERNELS = {
    "no_flow": CC_KERNELS,
    "raft": CC_KERNELS + ("flow_warp", "raft_update"),
    "unflow": CC_KERNELS + ("flow_warp", "warp_abs", "correlation"),
}
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core and plain
# float32 operations/s (the bounds are stated against these peaks whatever
# the card's power limit, which is printed beside them)
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
FLOW_FRAMES, FLOW_ITERS = 24, 12
# the UnFlow path: frames whose half is a multiple of 64
UH, UW, UNFLOW_FRAMES = 512, 640, 18
# kernel-vs-plain tolerances. flow_warp: the kernel forms its coordinates
# with the same float32 operations in the same order and blends without
# fused multiply-adds, so float32 outputs agree to 2e-6 (found: exactly) and
# bf16 outputs to one rounding of the largest map value. raft_update: the
# float32 instance to the tolerance of the JAX package's own kernel test
# (sums in another order); the bf16 instance also rounds c2, f2, y, net,
# r*net and the flow head's hidden layer to bf16, and a float32 sum taken in
# another order can flip such a rounding (one bf16 step, 2^-8 of an O(1)
# operand), which the following products carry on.
# correlation: the JAX package's own limit for its kernel (float32 sums over C
# in another order). conv3x3 / vgg_stage1: float32 to the JAX tests' limits;
# bfloat16 results are rounded once from a float32 sum taken in another
# order, which can flip that rounding: one bf16 step, 2^-8 of a value's
# binade (rtol 2^-7), and in the fused stage a flipped intermediate is carried
# on by the second convolution (twice the atol).
WARP_ATOL = {"float32": 2e-6, "bfloat16": 2.0 ** -8}
CORR_TOL = (1e-5, 1e-5)
CONV_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2.0 ** -8, 2.0 ** -7)}
RAFT_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-3, 1e-2)}
#: bf16 engine through the kernels against through the plain versions: the
#: most a class probability may move, one step of the float16 heats the
#: tracker keeps at a probability near 1/C = 0.2
FLOW_PROB_TOL = 2.0 ** -13
#: the same for the UnFlow path, whose random provider gives flows of ~6 px
#: (RAFT's: ~17 px), so that a lost flow moves the probabilities less: half
#: the limit. Its flow may differ by more: three stacked bf16 networks of
#: ~25 layers each carry a flipped rounding of the cost volume further than
#: RAFT's update steps do (found: 0.06 px, 1 % of the largest flow).
UNFLOW_PROB_TOL, UNFLOW_FLOW_TOL = 2.0 ** -14, 0.25
#: the bf16 UnFlow provider against the float32 one: mean |difference| over
#: mean |flow|, and max |difference| over max |flow|
UNFLOW_BF16_MEAN, UNFLOW_BF16_MAX = 0.03, 0.05


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


def synthetic_frames(n: int, seed: int = SEED, hw=(H, W)):
    """(n, h, w, 3) uint8 frames of two moving instruments (a shaft and
    two tips each) on a noisy background, drawn with numpy. Every fourth
    frame is plain noise and frames 40..47 are blank (a cut to black), so
    a random-weight model's class maps range from fragmented (noise) to
    clean (blank windows) and the decode takes each of its tiers."""
    rng = np.random.default_rng(seed)
    H, W = hw
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
    errs["flow_warp"], errs["warp_abs"] = _check_warp_kernel()
    errs["raft_update"] = _check_raft_update_kernel()
    errs["correlation"] = _check_correlation_kernel()
    errs.update(_check_conv_kernels())
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
    worst_abs = 0.0
    for ac in (True, False):
        for pm in ("zeros", "border"):
            got = warp.grid_sample_bilinear(img, gx, gy, ac, pm)
            want = warp.grid_sample_bilinear_plain(img, gx, gy, ac, pm)
            err = (got - want).abs().max().item()
            if err > WARP_ATOL["float32"]:
                raise AssertionError(f"warp_abs[{ac}, {pm}]: {err}")
            worst_abs = max(worst_abs, err)
    # ... and as UnFlow calls it: 3-channel frames at half resolution, a
    # border-padded backward warp by a flow of a few pixels, both types
    from mfcnet_tpu_torch.models.unflow import backward_warp

    for dt in (torch.float32, torch.bfloat16):
        frame = torch.randn(2, 3, UH // 2, UW // 2, generator=gen).cuda().to(dt)
        fl = (torch.randn(2, 2, UH // 2, UW // 2, generator=gen) * 8.0).cuda()
        got = backward_warp(frame, fl)
        with _plain_unflow_kernels():
            want = backward_warp(frame, fl)
        err = (got.float() - want.float()).abs().max().item()
        if err > WARP_ATOL[str(dt).split(".")[1]] * 8:
            raise AssertionError(f"warp_abs[backward_warp, {dt}]: {err}")
        worst_abs = max(worst_abs, err)
    log(f"flow_warp kernel vs plain: 2x{{{C},{C + 1}}}x{H}x{W}, f32 (atol "
        f"{WARP_ATOL['float32']}) and bf16 (atol {WARP_ATOL['bfloat16']}), "
        f"bounded / beyond the band / out of the image / zero flow on the "
        f"576x720 grid: max |diff| {worst}; warp_abs 4 modes and UnFlow's "
        f"backward_warp at 2x3x{UH // 2}x{UW // 2} (f32, bf16 within one "
        f"rounding of values up to 4): max |diff| {worst_abs}")
    return worst, worst_abs


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


def _check_correlation_kernel():
    """The cost volume at the UnFlow path's two shapes (tracker: 2 pairs at
    256x320 -> 32x40 features; offline CLI: 4 pairs at 512x640 -> 64x80) and
    one odd small case, float32 and bfloat16 inputs."""
    import torch

    from mfcnet_tpu_torch.ops import correlation as co

    gen = torch.Generator().manual_seed(SEED)
    atol, rtol = CORR_TOL
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for shape, md, s in (((2, UH // 16, UW // 16, 256), 20, 2),
                             ((4, UH // 8, UW // 8, 256), 20, 2),
                             ((1, 9, 45, 7), 5, 3)):
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            got = co.correlation_cost_volume(f1, f2, md, s)
            torch.cuda.synchronize()
            want = co.correlation_plain(f1, f2, md, s)
            err = (got - want).abs().max().item()
            if not (got.shape == want.shape and got.dtype == torch.float32
                    and torch.allclose(got, want, rtol=rtol, atol=atol)):
                raise AssertionError(
                    f"correlation[{dt}, {shape}, md={md}, s={s}]: kernel != "
                    f"plain (max |diff| {err}; atol {atol} rtol {rtol})")
            worst = max(worst, err)
    log(f"correlation kernel vs plain: 2x{UH // 16}x{UW // 16}x256 and "
        f"4x{UH // 8}x{UW // 8}x256 (md=20, s=2, 441 channels) and 1x9x45x7 "
        f"(md=5, s=3), f32 and bf16 inputs: max |diff| {worst:.3g} (atol "
        f"{atol}, rtol {rtol})")
    return worst


def _first_stage_weights(dt):
    """The first two VGG convolutions of the tracker's own model (seeded
    as in the slices): (stage module, k1, b1, k2, b2), the kernels HWIO."""
    import copy

    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T,
        generator=torch.Generator().manual_seed(SEED))
    enc = model.base_model.encoder
    stage = copy.deepcopy(torch.nn.Sequential(enc[0], enc[1], enc[2], enc[3])
                          ).cuda().to(dt).to(memory_format=torch.channels_last)
    hwio = lambda conv: conv.weight.detach().permute(2, 3, 1, 0).contiguous()  # noqa: E731
    return (stage, hwio(stage[0]), stage[0].bias.detach().float(),
            hwio(stage[2]), stage[2].bias.detach().float())


def _check_conv_kernels():
    """conv3x3 at the first VGG stage's second convolution (1x480x640x64 ->
    64) and the second stage's first (1x240x320x64 -> 128), bias + ReLU, and
    one odd case; vgg_stage1 at 1x480x640x3, C1 = 64, with the model's own
    weights, also against what the model's first stage gives."""
    import torch

    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1

    gen = torch.Generator().manual_seed(SEED)
    worst = {"conv3x3": 0.0, "vgg_stage1": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        atol, rtol = CONV_TOL[name]
        stage, k1, b1, k2, b2 = _first_stage_weights(dt)
        for B, Hc, Wc, cin, cout in ((1, H, W, 64, 64),
                                     (1, H // 2, W // 2, 64, 128),
                                     (2, 17, 23, 5, 70)):
            x = torch.randn(B, Hc, Wc, cin, generator=gen).cuda().to(dt)
            w = k2 if (cin, cout) == (64, 64) else (
                torch.randn(3, 3, cin, cout, generator=gen)
                * (2.0 / (9 * cin)) ** 0.5).cuda().to(dt)
            b = torch.randn(cout, generator=gen).cuda() * 0.1
            for bias, relu in ((b, True), (None, False)):
                got = c3.conv3x3(x, w, bias, relu)
                torch.cuda.synchronize()
                want = c3.conv3x3_plain(x, w, bias, relu)
                err = (got.float() - want.float()).abs().max().item()
                if not (got.dtype == dt and torch.allclose(
                        got.float(), want.float(), rtol=rtol, atol=atol)):
                    raise AssertionError(
                        f"conv3x3[{name}, {B}x{Hc}x{Wc}x{cin}->{cout}, "
                        f"relu={relu}]: kernel != plain (max |diff| {err}; "
                        f"atol {atol} rtol {rtol})")
                if name == "bfloat16":
                    worst["conv3x3"] = max(worst["conv3x3"], err)
        for shape in ((1, H, W, 3), (2, 19, 23, 3)):
            x = torch.randn(shape, generator=gen).cuda().to(dt)
            got = s1.vgg_stage1(x, k1, b1, k2, b2)
            torch.cuda.synchronize()
            want = s1.vgg_stage1_plain(x, k1, b1, k2, b2)
            err = (got.float() - want.float()).abs().max().item()
            if not (got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=rtol, atol=2 * atol)):
                raise AssertionError(
                    f"vgg_stage1[{name}, {shape}]: kernel != plain (max "
                    f"|diff| {err}; atol {2 * atol} rtol {rtol})")
            if name == "bfloat16":
                worst["vgg_stage1"] = max(worst["vgg_stage1"], err)
            # the model's own first stage (cuDNN, the same type; float32
            # without TF32): another rounding of the bias and another order
            # of the sums, so bf16 steps apart at most
            with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
                ref = stage(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            merr = (got.float() - ref.float()).abs().max().item()
            lim = 1e-4 if name == "float32" else 2.0 ** -5
            if merr > lim * max(1.0, ref.float().abs().max().item()):
                raise AssertionError(
                    f"vgg_stage1[{name}, {shape}] vs the model's first stage: "
                    f"max |diff| {merr}")
            log(f"vgg_stage1 [{name}, {shape}]: max |diff| {err:.3g} vs plain, "
                f"{merr:.3g} vs the model's first stage (max value "
                f"{ref.float().abs().max().item():.3g})")
    log(f"conv3x3 kernel vs plain: 1x{H}x{W}x64->64, 1x{H // 2}x{W // 2}x64->"
        f"128, 2x17x23x5->70, with bias + ReLU and without, f32 (atol "
        f"{CONV_TOL['float32'][0]}, rtol {CONV_TOL['float32'][1]}) and bf16 "
        f"(atol {CONV_TOL['bfloat16'][0]}, rtol {CONV_TOL['bfloat16'][1]}): "
        f"max |diff| in bf16 {worst['conv3x3']:.3g}")
    return worst


def _plain_unflow_kernels():
    """Context in which the UnFlow path runs the plain versions of the
    correlation, of the backward warp and of the head's flow warp (on the
    same CUDA tensors)."""
    import contextlib
    from unittest import mock

    from mfcnet_tpu_torch.models import mfcnet, unflow
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(unflow, "correlation_cost_volume",
                                          co.correlation_plain))
    stack.enter_context(mock.patch.object(unflow, "grid_sample_bilinear",
                                          warp.grid_sample_bilinear_plain))
    stack.enter_context(mock.patch.object(mfcnet, "flow_warp",
                                          warp.flow_warp_plain))
    return stack


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


def _check_rows(rows, n, hw=(H, W)):
    H, W = hw
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
        _reset_all_launches()
        dd.reset_tier_counts()
        rows, fps = track_on_frames(frames, None, cfg, d, name="smoke",
                                    engine=engine)
        launches = _all_launches()
        tiers = dict(dd.TIER_COUNTS)
        csv = np.loadtxt(Path(d) / "smoke_tracked.csv", delimiter=",")
    _check_rows(csv, len(frames))
    log(f"incremental: {len(frames)} frames -> CSV {csv.shape}, "
        f"{int(np.isfinite(csv[:, 10]).sum())} frames with a right base "
        f"(first run, includes warm-up: {fps:.2f} frames/s)")
    log(f"kernel launches on the main path: {json.dumps(launches)}")
    log(f"frames per decode tier: {json.dumps(tiers)}")
    _require_launches("no_flow", launches)

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


def _launch_modules():
    from mfcnet_tpu_torch.experimental import conv3x3, stage1
    from mfcnet_tpu_torch.ops import cc, correlation, raft_update, warp

    return (cc, raft_update, warp, correlation, conv3x3, stage1)


def _reset_all_launches():
    for mod in _launch_modules():
        mod.reset_launches()


def _all_launches():
    """Launch count of every kernel in ``KERNELS``, by name."""
    counts = {}
    for mod in _launch_modules():
        counts.update(mod.LAUNCHES)
    return {name: counts[name] for name, _, _ in KERNELS}


def _require_launches(path, launches):
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(
            f"kernels not launched on the {path} path: {missing}")


def _compare_with_plain_kernels(what, engine, plain_engine, frames,
                                plain_kernels, window_flow, windows=6,
                                prob_tol=FLOW_PROB_TOL, flow_tol=0.1):
    """A bf16 engine through the kernels against an engine of the same
    weights through the plain versions (``plain_kernels()``: the context
    that swaps them in), window by window over the first frames, on the
    probabilities the engines themselves decoded. ``window_flow(engine)``
    gives the flow of an engine's newest window."""
    import torch

    engine.reset()
    _keep_probs(engine)
    _keep_probs(plain_engine)
    worst_heat, worst_prob, worst_flow, max_flow = 0.0, 0.0, 0.0, 0.0
    flipped, unexplained, clear_share, compared = 0.0, 0, 1.0, 0
    fault = float("inf")
    for i in range(windows):
        got = engine.step_async(frames[i])
        with plain_kernels():
            want = plain_engine.step_async(frames[i])
        if got is None:
            continue
        with torch.no_grad():
            f_got = window_flow(engine)
            with plain_kernels():
                f_want = window_flow(plain_engine)
        worst_flow = max(worst_flow, (f_got - f_want).abs().max().item())
        max_flow = max(max_flow, f_want.abs().max().item())
        worst_heat = max(worst_heat, (got[2].float() - want[2].float()
                                      ).abs().max().item())
        p_got, p_want = engine.kept_probs, plain_engine.kept_probs
        worst_prob = max(worst_prob, (p_got - p_want).abs().max().item())
        # what a faulty warp would do to the same window: the plain head on
        # the plain engine's maps with the flow taken away
        with torch.no_grad(), plain_kernels():
            p_zero = torch.softmax(plain_engine.model.fuse_nchw(
                plain_engine.seg_buf, optflow=torch.zeros_like(f_want),
                depth=None).float(), dim=1).permute(0, 2, 3, 1)[0]
        fault = min(fault, (p_zero - p_want).abs().max().item())
        top2 = p_got.topk(2, dim=-1).values
        differ = got[0] != want[0]
        clear = (top2[..., 0] - top2[..., 1]) > 2 * prob_tol
        flipped = max(flipped, differ.float().mean().item())
        unexplained += int((differ & clear).sum().item())
        clear_share = min(clear_share, clear.float().mean().item())
        compared += 1
    log(f"{what} engine through the kernels vs through the plain versions, "
        f"bf16, {compared} windows: max |flow| {max_flow:.4g} px, max |flow "
        f"diff| {worst_flow:.4g} px (limit {flow_tol:.4g}), max "
        f"|probability diff| {worst_prob:.4g} (limit {prob_tol:.4g}; "
        f"a zeroed flow moves them by {fault:.4g} at least), "
        f"max |heat diff| {worst_heat:.4g}; class-mask pixels that differ: "
        f"{flipped:.4%} at most per window, of which {unexplained} where the "
        f"top-2 margin exceeds {2 * prob_tol:.4g} (must be 0; "
        f"{clear_share:.4%} of a window's pixels at least have such a margin)")
    # bf16 rounding flips inside the provider move the flow by a few
    # hundredths of a pixel at most, and every class probability by no more
    # than prob_tol (the float16 heats, rounded once more, by no more
    # than that plus one float16 step of a value near 0.2, 2^-13). The random-weight model's probabilities are nearly
    # flat, so the limit is also held against what a lost warp does to the
    # same windows: it has to lie four times below that. Two probability
    # vectors within the limit can disagree on the argmax only where the
    # top two lie within twice the limit of each other, which is most of
    # this model's pixels: the share of mask pixels that differ is reported
    # and has no limit, a pixel that differs outside that band is a fault
    if (worst_flow > flow_tol or worst_prob > prob_tol
            or worst_heat > prob_tol + 2.0 ** -13 or unexplained
            or fault < 4 * prob_tol):
        raise AssertionError(f"{what} path: kernels and plain versions "
                             f"disagree")
    for e in (engine, plain_engine):
        del e._outputs, e.kept_probs


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
    _require_launches("raft", launches)
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

    from mfcnet_tpu_torch.track import outputs as out

    _compare_with_plain_kernels(
        "RAFT", engine, InferenceEngine(model, cfg, flow_model=flow_model),
        frames, _plain_flow_kernels,
        lambda e: out.flow_from_feature_ring(*e.flow_state, (H, W),
                                             e.flow_model))

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


def phase_unflow_slice(frames):
    """The UnFlow path at full width: TernausNetMulti-Basic with
    add_optflow_inputs at 512x640, bf16, incremental, device decode, the
    frozen UnFlow provider (2 pairs per frame at 256x320: one correlation,
    two backward warps, one head warp). Returns (engine, launches of the
    main-path run, number of fused frames)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, generator=gen)
    flow_model = he_init_weights(UnFlow(), gen)
    n_flow = sum(p.numel() for p in flow_model.parameters())
    log(f"UnFlow path: TernausNetMulti-Basic + frozen UnFlow (full widths, "
        f"{n_flow} parameters), T={T} {UH}x{UW} bf16, seed {SEED}")
    small = TrackerConfig(dtype="bfloat16", add_optflow_inputs=True)
    try:
        InferenceEngine(model, small, flow_model=flow_model)
    except ValueError as e:
        log(f"at the default {small.input_height}x{small.input_width}: "
            f"ValueError: {e}")
    else:
        raise AssertionError("UnFlow at 480x640 must raise a ValueError")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True,
                        input_height=UH, input_width=UW)
    # no device argument: the entry points run on the card by default
    engine = InferenceEngine(model, cfg, flow_model=flow_model)
    if engine.device.type != "cuda" or engine.flow_split:
        raise AssertionError("the engine must default to the card and keep "
                             "a frame ring for UnFlow")
    n = UNFLOW_FRAMES
    fused = n - (T - 1)
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        _, fps = track_on_frames(frames[:n], None, cfg, d, name="unflow",
                                 engine=engine)
        launches = _all_launches()
        csv = np.loadtxt(Path(d) / "unflow_tracked.csv", delimiter=",")
    _check_rows(csv, n, (UH, UW))
    log(f"UnFlow path, incremental: {n} frames -> CSV {csv.shape} (first "
        f"run, includes warm-up: {fps:.2f} frames/s)")
    log(f"kernel launches on the UnFlow path: {json.dumps(launches)}")
    _require_launches("unflow", launches)
    if (launches["correlation"] != fused or launches["warp_abs"] != 2 * fused
            or launches["flow_warp"] != fused or launches["raft_update"]):
        raise AssertionError(
            f"expected 1 correlation, 2 warp_abs and 1 flow_warp launch per "
            f"fused frame ({fused} frames) and no raft_update, got {launches}")

    with tempfile.TemporaryDirectory() as d:
        track_on_frames(frames[:5], model,
                        dataclasses.replace(cfg, mode="full"), d, name="full",
                        flow_model=flow_model, device="cuda")
        _check_rows(np.loadtxt(Path(d) / "full_tracked.csv", delimiter=","),
                    5, (UH, UW))
    log("UnFlow path, full mode: 5 frames -> CSV (5, 12)")

    _compare_with_plain_kernels(
        "UnFlow", engine, InferenceEngine(model, cfg, flow_model=flow_model),
        frames, _plain_unflow_kernels,
        lambda e: out.flow_for_window(e.flow_state, e.flow_model), windows=5,
        prob_tol=UNFLOW_PROB_TOL, flow_tol=UNFLOW_FLOW_TOL)

    with parity_mode():
        c32 = dataclasses.replace(cfg, dtype="float32")
        engines = {
            m: InferenceEngine(model, dataclasses.replace(c32, mode=m),
                               flow_model=flow_model, device="cuda")
            for m in ("incremental", "full")
        }
        heat, mism, compared = 0.0, 0.0, 0
        for i in range(5):
            outs = {m: e.step_async(frames[i]) for m, e in engines.items()}
            if outs["full"] is None:
                continue
            heat = max(heat, (outs["incremental"][2].float()
                              - outs["full"][2].float()).abs().max().item())
            mism = max(mism, (outs["incremental"][0] != outs["full"][0]
                              ).float().mean().item())
            compared += 1
        log(f"UnFlow path, f32 parity mode, incremental vs full: {compared} "
            f"windows, max |heat diff| {heat:.4g}, class-mask mismatch "
            f"{mism:.4%}")
        # the frame ring hands flow_for_window the very frames the full
        # mode normalizes again: the same arithmetic, but cuDNN sees the
        # base forward at batch 1 or batch 3
        if heat > 1e-3 or mism > 0.01:
            raise AssertionError("UnFlow path: f32 incremental != full")
        # the type decision (models/unflow.py): a bf16 provider casts the
        # cost volume and the flow down where the JAX package promotes the
        # rest of the network to float32. Held against the float32 provider
        # on the same window: bf16 keeps 8 bits, through ~75 layers
        window = np.stack(frames[2::-1])  # newest first
        with torch.no_grad():
            f32 = out.flow_for_window(
                engines["full"]._normalize(window)[None],
                engines["full"].flow_model)
            b16 = out.flow_for_window(engine._normalize(window)[None],
                                      engine.flow_model)
        d = (b16 - f32).abs()
        rel_mean = d.mean().item() / f32.abs().mean().item()
        log(f"UnFlow bf16 provider vs float32 provider, one window: max "
            f"|flow| {f32.abs().max().item():.4g} px, mean |flow| "
            f"{f32.abs().mean().item():.4g} px, mean |diff| "
            f"{d.mean().item():.4g} px = {rel_mean:.3%} of the mean, max "
            f"|diff| {d.max().item():.4g} px (limits: mean {UNFLOW_BF16_MEAN:.0%}"
            f" of the mean flow, max {UNFLOW_BF16_MAX:.0%} of the max flow)")
        if (rel_mean > UNFLOW_BF16_MEAN
                or d.max().item() > UNFLOW_BF16_MAX * f32.abs().max().item()
                or not f32.abs().max().item() > 1.0):
            raise AssertionError("UnFlow: the bf16 provider left the float32 "
                                 "provider's envelope")
    torch.cuda.synchronize()
    return engine, launches, fused


def phase_offline(frames, smi):
    """The offline flow CLI's path: its ``build_provider`` and its batched
    forward on uint8 frame pairs at 512x640, RAFT and UnFlow, float32 on
    the card by default; a batch of 4 against the same pairs one by one."""
    import torch

    from mfcnet_tpu_torch.cli.generate_opticalflow import (
        build_provider,
        flow_pairs,
    )
    from mfcnet_tpu_torch.models.unflow import he_init_weights

    prevs, currs = frames[:4], frames[1:5]
    for name in ("RAFT", "UnFlow"):
        model = build_provider(name, UH, UW)
        if next(model.parameters()).device.type != "cuda":
            raise AssertionError("the CLI's provider must default to the card")
        if name == "UnFlow":  # the generator lives on the CPU
            model = he_init_weights(
                model.cpu(), torch.Generator().manual_seed(SEED)).cuda()
        _reset_all_launches()
        flows = flow_pairs(model, prevs, currs)
        launches = _all_launches()
        if flows.shape != (4, UH, UW, 2) or not np.isfinite(flows).all():
            raise AssertionError(f"offline {name}: bad flow {flows.shape}")
        single = np.concatenate([flow_pairs(model, prevs[i:i + 1],
                                            currs[i:i + 1]) for i in range(4)])
        diff = np.abs(flows - single).max()
        # every op is per-sample, but cuDNN (TF32 by default, as a user runs
        # it) may choose another algorithm for another batch
        if diff > 0.1 * max(1.0, np.abs(single).max()):
            raise AssertionError(f"offline {name}: batch of 4 != per pair "
                                 f"({diff})")
        ms = _host_ms(lambda: flow_pairs(model, prevs, currs), 3)
        log(f"[{smi}] offline flow CLI forward, {name}, float32, 4 pairs at "
            f"{UH}x{UW}: {ms:.2f} ms per batch incl. upload and fetch, max "
            f"|flow| {np.abs(flows).max():.4g} px, batch vs per pair max "
            f"|diff| {diff:.3g} px; hand-kernel launches per batch: "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        if name == "UnFlow" and (launches["correlation"] != 1
                                 or launches["warp_abs"] != 2):
            raise AssertionError(f"offline UnFlow: launches {launches}")


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


def phase_unflow_timings(engine, frames, smi):
    """UnFlow path frames/s, the provider's share of the frame, and kernels
    6 to 8 against their plain versions, bounds and library yardsticks.
    Returns (times, bounds, library ms) by kernel name."""
    import torch
    import torch.nn.functional as F

    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1
    from mfcnet_tpu_torch.models.unflow import backward_warp
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    n = UNFLOW_FRAMES
    with tempfile.TemporaryDirectory() as d:
        _, fps = track_on_frames(frames[:n], None, engine.cfg, d, name="warm",
                                 engine=engine)
    log(f"[{smi}] tracker, UnFlow path (1 correlation, 2 backward warps, 1 "
        f"head warp per frame), {UH}x{UW}, incremental bf16 device decode, "
        f"warm, {n} host frames: {fps:.2f} frames/s")
    it = iter(range(10 ** 9))
    step_ms = _host_ms(lambda: engine.step_async(frames[next(it) % n]), 12)

    def provider():
        with torch.no_grad():
            return out.flow_for_window(engine.flow_state, engine.flow_model)

    flow_ms = _host_ms(provider, 12)
    log(f"[{smi}] UnFlow path step {step_ms:.3f} ms/frame (synchronized), of "
        f"which the flow provider {flow_ms:.3f} ms = {flow_ms / step_ms:.1%} "
        f"of the frame")

    times, bounds, library = {}, {}, {}
    gen = torch.Generator().manual_seed(SEED)
    # kernel 6 at the tracker's shape, with the dtype the bf16 engine feeds
    # it, and at the offline CLI's shape in float32
    for shape, dt, key in (((2, UH // 16, UW // 16, 256), torch.bfloat16,
                            "correlation"),
                           ((4, UH // 8, UW // 8, 256), torch.float32,
                            "correlation@offline")):
        f1 = torch.randn(shape, generator=gen).cuda().to(dt)
        f2 = torch.randn(shape, generator=gen).cuda().to(dt)
        t = _in_turns(key, lambda: co.correlation_cost_volume(f1, f2),
                      lambda: co.correlation_plain(f1, f2), smi,
                      f"{dt}, {'x'.join(map(str, shape))}, md=20, s=2",
                      kreps=20, preps=2)
        got = co.correlation_cost_volume(f1, f2)
        # an output whose window row lies outside the image is a stored
        # zero, not a product: count the products this shape needs
        B_, H_, W_, C_ = shape
        rows_in = sum(1 for y in range(H_) for dy in range(-20, 21, 2)
                      if 0 <= y + dy < H_)
        ops = 2.0 * B_ * rows_in * W_ * 21 * C_
        # the peak is that of the inputs' type: bfloat16 products with
        # float32 sums are what the tensor cores compute exactly, float32
        # products are FMAs. The kernel itself runs on FMAs for both.
        peak, unit = ((PEAK_BF16, "989 TFLOP/s bfloat16 tensor cores")
                      if dt == torch.bfloat16 else
                      (PEAK_F32, "67 TFLOP/s float32 FMA"))
        b_ops = ops / peak * 1e3
        b_bytes = _nbytes(f1, f2, got) / PEAK_BYTES * 1e3
        bound = (max(b_ops, b_bytes),
                 "operations" if b_ops >= b_bytes else "bytes")
        log(f"[{smi}] {key}: bound {bound[0]:.5f} ms ({bound[1]}: "
            f"{ops / 1e9:.3f} GFLOP at {unit} = {b_ops:.5f} "
            f"ms, {_nbytes(f1, f2, got)} B at 3.35 TB/s = {b_bytes:.5f} ms); "
            f"kernel (float32 FMAs) at {ops / t[0] / 1e9:.1f} TFLOP/s = "
            f"{ops / t[0] * 1e3 / PEAK_F32:.1%} of the FMA peak; no library "
            f"call computes it")
        if key == "correlation":
            times[key], bounds[key] = t, bound

    # UnFlow's backward warp (kernel 5's second entry point)
    frame = torch.randn(2, 3, UH // 2, UW // 2, generator=gen).cuda().bfloat16()
    fl = (torch.randn(2, 2, UH // 2, UW // 2, generator=gen) * 8.0).cuda()

    def plain_warp():
        with _plain_unflow_kernels():
            return backward_warp(frame, fl)

    times["warp_abs"] = _in_turns(
        "warp_abs", lambda: backward_warp(frame, fl), plain_warp, smi,
        f"UnFlow's backward_warp incl. its coordinate arithmetic, bf16 "
        f"2x3x{UH // 2}x{UW // 2}; device time in CUDA-graph replays",
        kreps=20, preps=3, timer=_graph_ms)
    got = backward_warp(frame, fl)
    wb = _nbytes(frame, fl, got) / PEAK_BYTES * 1e3
    bounds["warp_abs"] = (wb, "bytes")
    xs = torch.linspace(-1, 1, UW // 2, device="cuda").view(1, 1, -1)
    ys = torch.linspace(-1, 1, UH // 2, device="cuda").view(1, -1, 1)
    grid = torch.stack([xs + fl[:, 0] / ((UW // 2 - 1) / 2.0),
                        ys + fl[:, 1] / ((UH // 2 - 1) / 2.0)], -1
                       ).to(frame.dtype)
    library["warp_abs"] = _graph_ms(lambda: F.grid_sample(
        frame, grid, mode="bilinear", padding_mode="border",
        align_corners=False), 20)
    log(f"[{smi}] warp_abs: bound {wb:.5f} ms (bytes); F.grid_sample on a "
        f"ready-made grid {library['warp_abs']:.4f} ms")

    # kernels 7 and 8 at the first VGG stage's shapes, bf16, against cuDNN
    # (F.conv2d + ReLU, bf16, channels_last)
    stage, k1, b1, k2, b2 = _first_stage_weights(torch.bfloat16)
    for Hc, Wc, cin, cout, key in ((H, W, 64, 64, "conv3x3"),
                                   (H // 2, W // 2, 64, 128,
                                    "conv3x3@240x320x64->128")):
        x = torch.randn(1, Hc, Wc, cin, generator=gen).cuda().bfloat16()
        w = k2 if cout == 64 else (torch.randn(3, 3, cin, cout, generator=gen)
                                   * (2.0 / (9 * cin)) ** 0.5).cuda().bfloat16()
        b = torch.randn(cout, generator=gen).cuda() * 0.1
        t = _in_turns(key, lambda: c3.conv3x3(x, w, b, True),
                      lambda: c3.conv3x3_plain(x, w, b, True), smi,
                      f"bf16 1x{Hc}x{Wc}x{cin}->{cout}, bias + ReLU",
                      kreps=20, preps=5)
        got = c3.conv3x3(x, w, b, True)
        ops = 2.0 * Hc * Wc * 9 * cin * cout
        b_ops = ops / PEAK_BF16 * 1e3
        b_bytes = _nbytes(x, w, b, got) / PEAK_BYTES * 1e3
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.bfloat16()
        lib = _event_ms(lambda: F.relu(F.conv2d(xc, wc, bc, padding=1)), 20)
        log(f"[{smi}] {key}: bound {max(b_ops, b_bytes):.5f} ms (operations "
            f"{b_ops:.5f} ms at 989 TFLOP/s bf16, bytes {b_bytes:.5f} ms); "
            f"kernel at {ops / t[0] / 1e9:.1f} TFLOP/s; F.conv2d + ReLU "
            f"(cuDNN, bf16, channels_last) {lib:.4f} ms")
        if key == "conv3x3":
            times[key] = t
            bounds[key] = (max(b_ops, b_bytes),
                           "operations" if b_ops >= b_bytes else "bytes")
            library[key] = lib
    x = torch.randn(1, H, W, 3, generator=gen).cuda().bfloat16()
    times["vgg_stage1"] = _in_turns(
        "vgg_stage1", lambda: s1.vgg_stage1(x, k1, b1, k2, b2),
        lambda: s1.vgg_stage1_plain(x, k1, b1, k2, b2), smi,
        f"bf16 1x{H}x{W}x3, C1=64, the model's own weights", kreps=20,
        preps=5)
    got = s1.vgg_stage1(x, k1, b1, k2, b2)
    ops = 2.0 * H * W * 9 * (3 * 64 + 64 * 64)
    b_ops = ops / PEAK_BF16 * 1e3
    b_bytes = _nbytes(x, k1, b1, k2, b2, got) / PEAK_BYTES * 1e3
    bounds["vgg_stage1"] = (max(b_ops, b_bytes),
                            "operations" if b_ops >= b_bytes else "bytes")
    xc = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        library["vgg_stage1"] = _event_ms(lambda: stage(xc), 20)
    log(f"[{smi}] vgg_stage1: bound {bounds['vgg_stage1'][0]:.5f} ms "
        f"({bounds['vgg_stage1'][1]}: operations {b_ops:.5f} ms at 989 "
        f"TFLOP/s bf16, bytes {b_bytes:.5f} ms); kernel at "
        f"{ops / times['vgg_stage1'][0] / 1e9:.1f} TFLOP/s; the model's "
        f"first stage (cuDNN, two F.conv2d + ReLU, bf16, channels_last) "
        f"{library['vgg_stage1']:.4f} ms")
    return times, bounds, library


def main():
    # the port itself, from this checkout (fails in a bare directory)
    import mfcnet_tpu_torch  # noqa: F401

    smi = phase_device()
    errs = phase_kernels()
    frames = synthetic_frames(64)
    uframes = synthetic_frames(UNFLOW_FRAMES, hw=(UH, UW))
    engine, launches_noflow, _ = phase_slice(frames)
    flow_engine, launches_raft, fused_raft = phase_flow_slice(frames)
    unflow_engine, launches_unflow, fused_unflow = phase_unflow_slice(uframes)
    phase_offline(uframes, smi)
    _, times, bounds = phase_timings(engine, frames, smi)
    library = {}
    for t, b, lib in (phase_flow_timings(flow_engine, frames, smi),
                      phase_unflow_timings(unflow_engine, uframes, smi)):
        times.update(t)
        bounds.update(b)
        library.update(lib)
    import torch

    paths = {"no_flow": (launches_noflow, len(frames) - (T - 1)),
             "raft": (launches_raft, fused_raft),
             "unflow": (launches_unflow, fused_unflow)}
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         # over the three main-path runs, each counted from 0
         "launches": sum(c[name] for c, _ in paths.values()),
         "launches_by_path": {p: c[name] for p, (c, _) in paths.items()},
         "launches_per_frame": {p: c[name] / n for p, (c, n) in paths.items()},
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
