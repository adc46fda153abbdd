"""Device times of the flow paths' two hand kernels -- UnFlow's correlation
cost volume and the head's flow warp -- and of the warp's absolute-coordinate
entry point alone, for the package of this checkout, or of this checkout and
another tree in turns on one card in one call:

    python3 tools/flowk_times.py [--breakdown] [--variants] [--raft-f32]
        [--phases] [--backward] [--tree DIR]

Inputs, seeded: the correlation at UnFlow's tracker shape (f32 and bf16
2x32x40x256: the conv3 features of 2 pairs at 256x320) and at the offline
CLI's (f32 4x64x80x256), md=20, s=2; ``flow_warp`` on bf16 maps 2x5x480x640
(the head's call, ``models/mfcnet.py``) on the 576x720 crop grid with a
smooth flow of up to ~17 px (the RAFT path's size) and with per-pixel
noise of 4 px; ``mfc_warp_abs`` called alone on its ready inputs (UnFlow's
backward-warp grid, border clamp, of an f32 2x3x256x320 image: absolute
coordinates for the first design, the normalized grid for the 2D-tile one)
and the whole ``grid_sample_bilinear`` call from the normalized grid.
Beside each, the library yardstick: ``torch.bmm`` of each residue
sub-grid's full Gram matrix in f32 with TF32 off (products only; the
correlation needs the banded part of it), and ``F.grid_sample`` on a ready
grid. Every output is checked against its plain version first. For each:
ms per call by CUDA-graph replay (``chip_smoke.py::_graph_ms``) and, for
the two kernels, called eagerly (CUDA events around 50 calls).
B1, the flow warp's backward, at the trainer's shape (the maps gradient
and the flow gradient of 8x6x480x640 bf16 and f32 g on the 576x720 grid)
on the smooth flow, the noise flow and a convergent flow (every pixel
within 2 px of one point), each held to the plain backward and timed
beside ``grid_sampler_2d_backward`` (maps gradient only, grid gradient
only); its byte bound and, by design, the bytes each moves.
B2, the correlation's backward (both gradients in one call), at the
tracker's and the offline CLI's shapes in both types, beside the dense
``torch.bmm`` yardstick of ``chip_smoke.py`` (each residue sub-grid's (P, P)
gradient times both operands, f32, TF32 off), and B3's image entry (the
whole ``sample_backward`` call for the image gradient, its zeroed buffer
included) at UnFlow's training shape, 4x3x512x640 f32 ``channels_last``,
border, on ``chip_smoke.py::_b3_cases``'s smooth, edges and noise inputs,
beside ``aten::grid_sampler_2d_backward`` (image gradient only); each held
to its plain version first. ``--backward`` times B2 and B3 alone.
``--breakdown`` lists the device operations of one call with their device
times (``torch.profiler``). For the correlation the line also holds
``corr_plan``'s plan and the operand rows its blocks stage (MB). ``--variants`` also builds
``tools/flowk_variants.cu`` (stripped variants of the earlier flow warp:
coordinates only, taps without stores, 2D blocks, a copy of the same bytes)
and times each at the same inputs, and the stripped variants of B1's
first maps-gradient kernel (zero and cast only, plain stores in place of
its atomics, its scatter into shared memory only, and the whole) at the
trainer's shape, bf16, on the smooth and the noise flow.
``--raft-f32`` times the float32 route of ``raft_update`` (no path
launches it) at 2,400 and 38,400 tokens by graph replay, beside its bounds
and the float32 ``UpdateBlock`` (cuDNN, TF32 off and on), and prints how
far cuDNN's TF32 result lies from the plain version; with ``--tree`` in
turns with the other tree.
``--phases`` builds ``tools/warp_bwd_phases.cu`` (the maps kernel's own
device functions with ``%globaltimer`` stamps at its grid barriers and
around each block's items) and prints
where one call at the trainer's shape spends its time.

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
#: B1 at the trainer's shape (run A: batch 4 x 2 earlier frames, C = 6)
B1_SHAPE, B1_GRID = (8, 6, 480, 640), (576, 720)
B1_VARIANTS = ("first design", "zero and cast", "plain stores",
               "shared scatter")
#: (B, H8, W8) of the float32 update step's timed calls
RAFT_F32_CALLS = ((2, 30, 40), (8, 60, 80))


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
    lib.probe_bwd_maps.argtypes = (I, P, P, P, P, I, I, I, I, I, I, I, P)
    lib.probe_bwd_maps.restype = I
    return lib


def b1_calls(gen, out):
    """B1's two entries at the trainer's shape, f32 and bf16, on three
    flows, each checked against the plain backward first: {label: (kernel
    call, library call)}; bounds and bytes moved into ``out``. Returns the
    calls and the bf16 inputs (for the variants)."""
    import torch

    from chip_smoke import PEAK_BYTES, _hold_flow_warp_bwd, _nbytes, \
        b1_flows, b1_moved_bytes
    from mfcnet_tpu_torch.ops import warp

    B, C, H, W = B1_SHAPE
    flows = {"smooth 17 px": smooth_flow(gen, B, H, W, 17.0).cuda(),
             "noise 4 px": (torch.randn(B, 2, H, W, generator=gen) * 4.0
                            ).cuda(),
             "convergent": b1_flows(gen, B, H, W, B1_GRID)[
                 "convergent"].cuda()}
    calls, kept = {}, None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        g = torch.randn(B1_SHAPE, generator=gen).cuda().to(dt)
        maps = torch.rand(B1_SHAPE, generator=gen).cuda().to(dt)
        kept = kept or (g, flows)
        gflow = torch.empty(B, 2, H, W, device="cuda")
        out[f"B1 maps {name} bound ms"] = \
            _nbytes(g, flows["noise 4 px"], g) / PEAK_BYTES * 1e3
        out[f"B1 flow {name} bound ms"] = \
            _nbytes(g, maps, flows["noise 4 px"], gflow) / PEAK_BYTES * 1e3
        for label, fl in flows.items():
            _hold_flow_warp_bwd(g, maps, fl, f"B1 {name} {label}", B1_GRID,
                                converges=label == "convergent")
            if hasattr(warp, "tap_tiles"):  # entries and bytes by design
                first, this, entries = b1_moved_bytes(g, fl, B1_GRID)
                out[f"B1 maps {name} {label} MB moved"] = {
                    "first design": first / 1e6, "tiles": this / 1e6,
                    "list entries": entries}
            gx, gy = warp._flow_grid(fl, B1_GRID)
            grid = torch.stack([gx, gy], -1).to(dt).contiguous()
            for entry, mask in (("maps", [True, False]),
                                ("flow", [False, True])):
                kern = ((lambda g=g, fl=fl: warp.flow_warp_bwd_maps(
                    g, fl, B1_GRID)) if entry == "maps" else
                    (lambda g=g, maps=maps, fl=fl: warp.flow_warp_bwd_flow(
                        g, maps, fl, B1_GRID)))
                calls[f"B1 {entry} {name} {label}"] = (
                    kern, lambda g=g, maps=maps, grid=grid, mask=mask:
                    torch.ops.aten.grid_sampler_2d_backward(
                        g, maps, grid, 0, 0, True, mask))
    return calls, kept


def b2b3_calls(gen, out):
    """B2 at UnFlow's two shapes in both types and B3's image entry on the
    smooth, edges and noise inputs, each checked against its plain version
    first: {label: (kernel call, library call)}; bounds into ``out``."""
    import torch

    from chip_smoke import BWD_TOL, PEAK_BF16, PEAK_BYTES, PEAK_TF32, \
        _b3_cases, _nbytes, _rel, _residue_grams
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp

    calls = {}
    for where, shape in (("tracker", (2, 32, 40, 256)),
                         ("offline", (4, 64, 80, 256))):
        B, h, w, c = shape
        g = torch.randn(B, h, w, 441, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            got = co.correlation_backward(g, f1, f2, MD, STRIDE)
            want = co.correlation_backward_plain(g, f1, f2, MD, STRIDE)
            rels = [_rel(k, p) for k, p in zip(got, want)]
            if max(rels) > BWD_TOL[name]:
                raise AssertionError(f"B2 {where} {name}: {rels}")
            label = f"B2 {where} {name}"
            flop = 2 * 2 * B * h * w * 441 * c
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_TF32 / 3
            out[f"{label} bound ms"] = max(
                _nbytes(g, f1, f2, f1, f2) / PEAK_BYTES, flop / peak) * 1e3
            out[f"{label} max |diff| / max"] = max(rels)
            a1, a2 = _residue_grams(f1.float(), f2.float(), STRIDE)
            gram = torch.randn(a1.shape[0], a1.shape[1], a1.shape[1],
                               generator=gen).cuda()
            calls[label] = (
                lambda g=g, f1=f1, f2=f2: co.correlation_backward(
                    g, f1, f2, MD, STRIDE),
                lambda gram=gram, a1=a1, a2=a2: (
                    torch.bmm(gram, a2), torch.bmm(gram.transpose(1, 2), a1)))
    B, C, H, W = 4, 3, 512, 640
    cases = {case: (fx, fy) for case, fx, fy in _b3_cases(gen, B, C, H, W)}
    img = torch.rand(B, C, H, W, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(B, C, H, W, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    for case in ("smooth", "edges", "noise"):
        fx, fy = cases[case]
        got = warp.sample_backward(g, img, fx, fy, "border", (True, False))[0]
        want = warp.sample_backward_plain(g, img, fx, fy, "border",
                                          (True, False))[0]
        if _rel(got, want) > BWD_TOL["float32"]:
            raise AssertionError(f"B3 image {case}: {_rel(got, want)}")
        label = f"B3 image {case}"
        out[f"{label} bound ms"] = \
            _nbytes(g, fx, fy, got) / PEAK_BYTES * 1e3
        if hasattr(warp, "sample_bwd_tiles"):
            ext, local = warp.sample_bwd_tiles(fx, fy, H, W, C, "border")
            out[f"{label} tiles shared, direct"] = [
                int(local.sum()),
                int(((ext[..., 0] <= ext[..., 1]) & ~local).sum())]
        grid = torch.stack([fx * (2.0 / W) + (1.0 / W - 1.0),
                            fy * (2.0 / H) + (1.0 / H - 1.0)], -1)
        calls[label] = (
            lambda fx=fx, fy=fy: warp.sample_backward(
                g, img, fx, fy, "border", (True, False)),
            lambda grid=grid: torch.ops.aten.grid_sampler_2d_backward(
                g, img, grid, 0, 1, False, [True, False]))
    return calls


def b1_variants(vlib, g, flows, out):
    """The first maps-gradient kernel's stripped variants, graph replay."""
    import torch

    from chip_smoke import _graph_ms
    from mfcnet_tpu_torch.ops._build import stream_of
    from mfcnet_tpu_torch.ops.warp import flow_warp_backward_plain

    B, C, H, W = B1_SHAPE
    acc = torch.empty(B1_SHAPE, device="cuda")
    for label in ("smooth 17 px", "noise 4 px"):
        fl = flows[label]
        for v, name in enumerate(B1_VARIANTS):
            vout = torch.empty_like(g)

            def probe(v=v, vout=vout, fl=fl):
                rc = vlib.probe_bwd_maps(
                    v, g.data_ptr(), fl.data_ptr(), acc.data_ptr(),
                    vout.data_ptr(), B, C, H, W, *B1_GRID, 1, stream_of(g))
                if rc != 0:
                    raise RuntimeError(f"B1 variant {name}: cudaError {rc}")
                return vout

            probe()
            if v == 0:  # the whole kernel: one bf16 rounding of plain
                ref = flow_warp_backward_plain(g.float(), g.float(), fl,
                                               B1_GRID)[0]
                bad = (vout.float() - ref).abs() > 2.0 ** -8 * ref.abs() + 1e-5
                if bool(bad.any()):
                    raise AssertionError("B1 variant 'first design' != plain")
            out[f"B1 maps variant {name} graph ms, {label}"] = _graph_ms(probe)


def b1_phases():
    """Where one call of B1's maps kernel spends its time, phase by phase:
    ``tools/warp_bwd_phases.cu`` (the kernel's device functions with
    ``%globaltimer`` stamps) at the trainer's shape (bf16 and f32; smooth,
    noise, convergent flow), each call's result held to the package's
    kernel."""
    import numpy as np
    import torch

    from chip_smoke import b1_flows
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, \
        _nvcc, sm_count, stream_of

    src = Path(__file__).resolve().with_name("warp_bwd_phases.cu")
    digest = hashlib.sha256(src.read_bytes() + (CSRC / "warp.cu").read_bytes()
                            ).hexdigest()[:16]
    so = BUILD_DIR / f"libwarp_bwd_phases_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
                        str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.phases_bwd_maps.argtypes = (P, P, P, P, I, I, I, I, I, I, I, I, P)
    lib.phases_bwd_maps.restype = I
    lib.phases_read.argtypes = (P, P, P)
    lib.phases_read.restype = I
    gen = torch.Generator().manual_seed(0)
    B, C, H, W = B1_SHAPE
    flows = {"smooth 17 px": smooth_flow(gen, B, H, W, 17.0).cuda(),
             "noise 4 px": (torch.randn(B, 2, H, W, generator=gen) * 4.0
                            ).cuda(),
             "convergent": b1_flows(gen, B, H, W, B1_GRID)[
                 "convergent"].cuda()}
    plan = warp.warp_bwd_plan(B, C, H, W, sm_count(torch.device("cuda")))
    work = torch.empty(plan.work_ints, dtype=torch.int32, device="cuda")
    blocks, grid = 4096, plan.grid
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        g = torch.randn(B1_SHAPE, generator=gen).cuda().to(dt)
        res = torch.empty_like(g)
        for label, fl in flows.items():
            for _ in range(2):  # the second call is read
                rc = lib.phases_bwd_maps(
                    g.data_ptr(), fl.data_ptr(), work.data_ptr(),
                    res.data_ptr(), B, C, H, W, *B1_GRID, 1,
                    0 if dt == torch.float32 else 1, stream_of(g))
                if rc != 0:
                    raise RuntimeError(f"B1 phases: error {rc}")
                torch.cuda.synchronize()
            want = warp.flow_warp_bwd_maps(g, fl, B1_GRID)
            # the package's kernel, to an order of sums (bf16: a rounding)
            if not torch.equal(res, want) and not torch.allclose(
                    res.float(), want.float(), rtol=2.0 ** -7, atol=1e-3):
                raise AssertionError(f"B1 phases: {label} != the kernel")
            st = (ctypes.c_ulonglong * (6 * blocks))()
            lg = (ctypes.c_ulonglong * blocks)()
            ln = (ctypes.c_int * blocks)()
            if lib.phases_read(st, lg, ln) != 0:
                raise RuntimeError("B1 phases: reading the stamps failed")
            t = np.frombuffer(st, np.uint64).reshape(6, blocks)[
                :, :grid].astype(np.int64)
            lg = np.frombuffer(lg, np.uint64)[:grid].astype(np.int64)
            ln = np.frombuffer(ln, np.int32)[:grid]
            top = int(lg.argmax())
            call = (t[5].max() - t[0].min()) / 1e3
            out[f"B1 maps {str(dt).split('.')[1]} {label} phases us"] = {
                "call": call,
                "zero": (t[1].max() - t[0].min()) / 1e3,
                "count": (t[2].max() - t[1].max()) / 1e3,
                "scan": (t[3].max() - t[2].max()) / 1e3,
                "bin": (t[4].max() - t[3].max()) / 1e3,
                "accumulate, last block": (t[5].max() - t[4].max()) / 1e3,
                "accumulate, median block": float(np.median(t[5])
                                                  - t[4].max()) / 1e3,
                "longest item": lg[top] / 1e3,
                "longest item, list entries": int(ln[top]),
                "longest item, share of the call": lg[top] / 1e3 / call}
    return out


def raft_f32_readings(out):
    """The float32 update step (``raft_update`` on float32 operands: the
    tree's own design) by graph replay through a solve's workspace, held to
    the plain version first, at each of RAFT_F32_CALLS; beside it its two
    bounds (operations as three TF32 passes at 495 / 3 TFLOP/s, and at the
    67 TFLOP/s float32 FMA rate; bytes) and the float32 ``UpdateBlock``
    (cuDNN) with TF32 off and on, with the TF32-on call's largest
    difference from the plain version (the update step's part of it: net'
    and the flow delta, TF32 off in the plain version)."""
    import torch

    from chip_smoke import PEAK_BYTES, PEAK_F32, PEAK_TF32, RAFT_TOL, \
        _graph_ms, _nbytes, _raft_update_inputs
    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru

    gen = torch.Generator().manual_seed(0)
    ub = init_weights(UpdateBlock(), gen).cuda().eval()
    atol, rtol = RAFT_TOL["float32"]
    for B, H8, W8 in RAFT_F32_CALLS:
        tok = B * H8 * W8
        key = f"raft_update f32 {tok} tokens"
        args = _raft_update_inputs(ub, torch.float32, B, H8, W8, gen)
        c1, f1, inp, net, flow, packed = args[:6]
        want = ru.raft_update_plain(*args)
        for got, w in zip(ru.raft_update(*args), want):
            if not torch.allclose(got, w, rtol=rtol, atol=atol):
                raise AssertionError(f"raft_update f32 {B}x{H8}x{W8}: kernel "
                                     "!= plain")
        out[f"{key} share of the tolerance"] = max(
            ((g - w).abs() / (atol + rtol * w.abs())).max().item()
            for g, w in zip(ru.raft_update(*args), want))
        ws = ru.UpdateWorkspace(B, H8, W8, packed, "cuda")
        state = [net]

        def step():
            state[0], delta = ru.raft_update(c1, f1, inp, state[0], flow,
                                             packed, H8, W8, ws)
            return state[0], delta

        out[f"{key} graph ms, kernel"] = min(_graph_ms(step, 10, 5),
                                             _graph_ms(step, 10, 5))
        macs = sum(packed[f"w_{k}"].shape[0] * packed[f"w_{k}"].shape[1]
                   * cols for k, cols in (
                       ("c2", 192), ("f2", 64), ("cv", 126), ("zr_h", 256),
                       ("q_h", 128), ("zr_v", 256), ("q_v", 128),
                       ("fl1", 256), ("fl2", 2)))
        out[f"{key} bound ms (3xTF32)"] = \
            2 * macs * tok / (PEAK_TF32 / 3) * 1e3
        out[f"{key} bound ms (FMA)"] = 2 * macs * tok / PEAK_F32 * 1e3
        out[f"{key} bound ms (bytes)"] = _nbytes(
            *args[:5], *(packed[k] for k in ru._WEIGHT_NAMES),
            *step()) / PEAK_BYTES * 1e3
        # the UpdateBlock on the same state: its convcorr1 and convflow1
        # inputs (a correlation lookup and the flow) are random here, so its
        # error is read on the part the kernel computes: the same c1, f1
        # through the block's own convolutions
        corr = torch.randn(B, tok // B, 4 * 81, generator=gen).cuda()

        def cl(t, ch):
            return t.view(B, H8, W8, ch).permute(0, 3, 1, 2)

        lib_args = (cl(net, 128), cl(inp, 128), cl(corr, 4 * 81),
                    cl(flow, 2))
        tf32 = torch.backends.cudnn.allow_tf32
        try:
            for allow in (False, True):
                torch.backends.cudnn.allow_tf32 = allow
                with torch.no_grad():
                    out[f"{key} graph ms, library tf32 "
                        f"{'on' if allow else 'off'}"] = _graph_ms(
                        lambda: ub(*lib_args), 10, 5)
            with torch.no_grad():
                torch.backends.cudnn.allow_tf32 = True
                on = _update_block_tail(ub, c1, f1, inp, net, flow, B, H8, W8)
                torch.backends.cudnn.allow_tf32 = False
                off = _update_block_tail(ub, c1, f1, inp, net, flow, B, H8,
                                         W8)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        out[f"{key} library tf32 on, max |diff| from plain"] = max(
            (a - b).abs().max().item() for a, b in zip(on, want))
        out[f"{key} library tf32 on, share of the tolerance"] = max(
            ((a - b).abs() / (atol + rtol * b.abs())).max().item()
            for a, b in zip(on, want))
        out[f"{key} library tf32 off, max |diff| from plain"] = max(
            (a - b).abs().max().item() for a, b in zip(off, want))


def _update_block_tail(ub, c1, f1, inp, net, flow, B, H8, W8):
    """The UpdateBlock's own modules from convc2/convf2 on (what
    ``raft_update`` computes), on token-major c1, f1, inp, net, flow:
    (net', delta) token-major, in cuDNN's arithmetic of the moment."""
    import torch
    import torch.nn.functional as F

    def img(t):
        return t.view(B, H8, W8, -1).permute(0, 3, 1, 2)

    def tok(t):
        return t.permute(0, 2, 3, 1).reshape(B, H8 * W8, -1)

    enc, gru, head = ub.motion_encoder, ub.recurrent_block, ub.flow_head
    c2 = F.relu(enc.convcorr2[0](img(c1)))
    f2 = F.relu(enc.convflow2[0](img(f1)))
    y = F.relu(enc.conv[0](torch.cat([c2, f2], 1)))
    x = torch.cat([img(inp), y, img(flow)], 1)
    h = img(net)
    for g in (gru.convgru1, gru.convgru2):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(g.convz(hx))
        r = torch.sigmoid(g.convr(hx))
        q = torch.tanh(g.convq(torch.cat([r * h, x], 1)))
        h = (1 - z) * h + z * q
    delta = head.conv2(F.relu(head.conv1(h)))
    return tok(h), tok(delta)


def readings(breakdown: bool, variants: bool, tree: Path,
             raft_f32: bool = False, phases: bool = False,
             backward: bool = False):
    import torch
    import torch.nn.functional as F

    from chip_smoke import CORR_TOL, PEAK_BYTES, WARP_ATOL, _abs_coords, \
        _graph_ms, _nbytes, _residue_grams
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops._build import kernel_lib, stream_of

    gen = torch.Generator().manual_seed(0)
    out = {"tree": str(tree), "package": co.__file__}
    calls = {}  # label -> (kernel call, library call or None)
    if backward:  # B2 and B3 alone
        calls = b2b3_calls(gen, out)
        _time_calls(calls, out, breakdown)
        return out
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
    # mfc_warp_abs alone: the C entry point on its ready inputs (the first
    # design took absolute coordinates, formed in PyTorch; the 2D-tile one
    # takes the normalized grid and forms them itself), and the whole
    # grid_sample_bilinear call as a caller sees it, from the normalized grid
    Ba, Ca, Ha, Wa = ABS_SHAPE
    img = torch.randn(ABS_SHAPE, generator=gen).cuda()
    fx, fy, grid = _abs_coords(
        (torch.randn(Ba, 2, Ha, Wa, generator=gen) * 8.0).cuda(), Ha, Wa)
    gx, gy = grid[..., 0].contiguous(), grid[..., 1].contiguous()
    res = torch.empty_like(img)
    lib = kernel_lib()
    from mfcnet_tpu_torch.ops import _build

    first = len(_build._SIGNATURES["warp.cu"]["mfc_warp_abs"][0]) == 12

    def warp_abs():
        if first:
            rc = lib.mfc_warp_abs(img.data_ptr(), fx.data_ptr(),
                                  fy.data_ptr(), res.data_ptr(), Ba, Ca, Ha,
                                  Wa, Ha, Wa, 0, stream_of(img))
        else:
            rc = lib.mfc_warp_abs(img.data_ptr(), gx.data_ptr(),
                                  gy.data_ptr(), res.data_ptr(), Ba, Ca, Ha,
                                  Wa, Ha, Wa, 0, 1, 0, stream_of(img))
        if rc != 0:
            raise RuntimeError(f"mfc_warp_abs: cudaError {rc}")
        return res

    def whole():
        return warp.grid_sample_bilinear(img, gx, gy, False, "border")

    want = warp.grid_sample_bilinear_plain(img, gx, gy, False, "border")
    for label, fn in (("warp_abs", warp_abs), ("grid_sample_bilinear", whole)):
        err = (fn() - want).abs().max().item()
        if err > WARP_ATOL["float32"]:
            raise AssertionError(f"{label}: kernel != plain ({err})")

    def library():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    calls["warp_abs alone f32 2x3x256x320"] = (warp_abs, library)
    calls["grid_sample_bilinear f32 2x3x256x320"] = (whole, library)
    out["warp_abs bound ms"] = _nbytes(img, gx, gy, res) / PEAK_BYTES * 1e3
    b1, b1_inputs = b1_calls(gen, out)
    calls.update(b1)
    calls.update(b2b3_calls(gen, out))
    _time_calls(calls, out, breakdown)
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
        b1_variants(vlib, *b1_inputs, out)
    if raft_f32:
        raft_f32_readings(out)
    if phases:
        out.update(b1_phases())
    return out


def _time_calls(calls, out, breakdown):
    """Each call's device operations (with ``breakdown``) and its ms by
    graph replay (and eager), beside its library call's, into ``out``."""
    import torch

    from chip_smoke import _device_events, _event_ms, _graph_ms

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
            # a convergent flow takes milliseconds a call: fewer replays
            slow = "convergent" in label
            reps = (5, 2) if slow else (20, 10)
            out[f"{label} graph ms, kernel"] = _graph_ms(kern, *reps)
            if not label.startswith("warp_abs"):
                out[f"{label} eager ms, kernel"] = _event_ms(
                    kern, 5 if slow else 50)
            out[f"{label} graph ms, library"] = _graph_ms(library, *reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def in_turns(tree: Path, breakdown: bool, raft_f32: bool,
             backward: bool = False):
    """A (``tree``) B (this checkout) B A, a process each; the best reading
    of each tree per timed key."""
    turns = []
    for t in (tree, ROOT, ROOT, tree):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time-tree",
               str(t)] + (["--breakdown"] if breakdown else []) + (
                   ["--raft-f32"] if raft_f32 else []) + (
                   ["--backward"] if backward else [])
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
                    help="time the stripped variants of the earlier warp "
                         "and of B1's first maps kernel")
    ap.add_argument("--raft-f32", action="store_true",
                    help="time raft_update's float32 route")
    ap.add_argument("--phases", action="store_true",
                    help="split B1's maps kernel into its phases")
    ap.add_argument("--backward", action="store_true",
                    help="time B2 and B3's image entry alone")
    args = ap.parse_args()
    if args.tree is not None:
        print(card(), flush=True)
        print(json.dumps(in_turns(args.tree.resolve(), args.breakdown,
                                  args.raft_f32, args.backward)), flush=True)
        extra = [f for f, on in (("--variants", args.variants),
                                 ("--phases", args.phases)) if on]
        if extra:
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            *extra], check=True)
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
    print(json.dumps(readings(args.breakdown, args.variants, tree,
                              args.raft_f32, args.phases, args.backward)),
          flush=True)


if __name__ == "__main__":
    main()
