"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths -- the video tracker with TernausNetMulti-Basic
at full width (T=3, 5 classes, bf16) and ``decode="device"``: at 480x640
without flow and with the frozen RAFT flow provider (raft_large widths,
12 iterations, fused update step), TernausNetMulti-Large with RAFT and
depth, four streams at once (``num_streams=4``, ``track_on_frame_streams``),
at 512x640 with the frozen UnFlow provider (its only widths), at 480x640
with the frozen FlowFormer++ provider (default widths, 12 iterations), the
offline flow CLI's batched forward, and the training CLI (the same model
with frozen RAFT, and again with FlowFormer++, and depth in the step) --
the zoo's DeepLab, FCN, HRNet and SegFormer families on the RAFT path
and in training, and the rest of the zoo (UNet, ResUNet, TAPNet16) --
through its hand-written CUDA kernels (``mfcnet_tpu_torch/csrc``), the
evaluation layer (the single-frame video tracker and the infer CLIs'
device half), the serving layer (exported artifacts and the engine that
tracks from them), the backward slice (UnFlow's gradient through the
backward kernels, ``--remat``) and the data-parallel slice (run A on two
ranks through ``DistributedDataParallel``, the stream axis over two
engines, the legacy models) and each tracker path again with its step
captured as one CUDA graph (``fused_dispatch``), in twelve phases; a
failing phase raises and the script exits non-zero:

1. device and build: requires a CUDA card, prints its name and power
   limit, builds the kernels into ``build/`` (one nvcc per source, in
   parallel);
2. kernels against their plain PyTorch versions: the connected-component
   kernels on crafted 480x640 class maps (integer outputs and the sums
   exactly equal), all four also at ragged sizes, B = 1, 4, 8 and 60,000,
   on uniform frames, a serpentine and a checkerboard (and, in phase 4,
   on the random model's maps and in CUDA-graph replays; each one device
   operation a call, the union kernel's wrapper adding one), refusing any
   launch plan but ``ops/cc.py::cc_plan``'s, the flow warp at
   2x480x640 (one device operation a call), UnFlow's one-launch backward
   warp in its four modes, both memory formats and both types, the RAFT
   update step at 4 to 38,400 tokens, the correlation at UnFlow's two
   shapes on both routes of ``ops/correlation.py::corr_plan`` (printed,
   with the worst difference per route; one device operation a call; any
   other plan refused) and the two experimental convolutions at the first
   VGG stage's shapes within the tolerances stated beside them;
3. the slices: seeded random weights, synthetic frames, ``track_on_frames``
   in incremental and full mode, without flow, with RAFT (and once with
   depth) and with UnFlow; TernausNetMulti-Large (its 22-channel head:
   class maps, raw RAFT flows, depth) over 16 frames incremental and 6
   full, where ``flow_warp`` must stay at 0 launches; four streams of 24,
   24, 20 and 13 frames through one 4-stream RAFT engine, one solve, one
   warp and one decode a lockstep step; every kernel's launch count, set
   to 0 just before a main-path run and read just after, must have risen
   on the paths that run it; the path through the kernels is held
   against the path through the plain versions (on every RAFT path, the
   4-stream one included, the FFPP one, and the 4-stream decode); the
   FlowFormer++ path over 24 frames incremental and 6 full (one warp a
   fused frame, no other flow kernel: the provider is PyTorch operations),
   its f32 provider on the card held to the same model on the CPU at the
   engine's 2 pairs of 240x320 (``FFPP_F32_TOL``); f32 parity mode
   checks incremental against full and each of the four streams against
   a single-stream run (heats within 1e-3, tip RMSE within 0.5 px, rows
   byte-equal counted); the correlation is held to its plain
   version and to a float64 reference on the UnFlow provider's own conv3
   features, in the tracker and in the offline CLI (the share of the
   tolerance each difference uses printed beside it);
4. timings: tracker frames/s on the three paths, aggregate and
   per-stream frames/s at 1, 2, 4 and 8 streams without flow and with
   RAFT, the Large RAFT path's frames/s, the FFPP path's frames/s at 1
   and 4 streams, its provider's ms and share and its decode ms/frame, each
   provider's share of the frame, each kernel against its plain version,
   its bound and, where one PyTorch call computes the same function, that
   call (for the correlation ``torch.bmm`` of its residue sub-grids' Gram
   matrices, products only), also at the 4-stream engine's shapes (the
   update step at 9,600 tokens, the decode's kernels on 4 images and 16
   masks, the warp over 8 maps: ``calls`` of their kernels); the device
   operations of one flood-kernel call;
5. training (``phase_train``): the training CLI in process on packs of
   the port's generator -- run A at full width, 480x640, batch 4, frozen
   RAFT (bf16 fused update) and depth in the step, the base trained, bf16,
   grad_accum 2, EMA, one epoch of 6 micro-steps, validation, a
   checkpoint that the port's tracker loads (and its EMA), an interrupted
   copy resumed at its batch; run B with the base frozen in float32 for 2
   steps; run F, run A with ``--optflow_model FlowFormerPlusPlus``
   (8 pairs of 4,800 tokens through FFPP a micro-step); the JAX package's
   learning recipe at 64x64; the flow warp's
   backward (B1, both entry points) against its plain version on
   ``_warp_flows``' cases, integer coordinates and run A's own tensors,
   and its time, bound and ``grid_sampler_2d_backward`` yardstick; step
   times, samples/s and peak memory of runs A, B and F;
6. the zoo (``phase_zoo_slice``, run before phase 5):
   ``{DeepLab,FCN,HRNet,SegFormer}Multi-Basic`` at full width with RAFT
   x12 (seeded weights, each base's BN statistics calibrated on the frames
   and its last convolution scaled to logits of std 3), 12 frames
   incremental (their launches counted: the update step, the warp, the
   decode's union tier) and 5 full; HRNetMulti-Basic through the kernels
   against the plain versions, f32 incremental against full, and its f32
   forward on the card against the CPU (``ZOO_F32_TOL``);
   SegFormerMulti-Large with RAFT and depth (0 warps); frames/s without
   flow and each base's and the head's ms (CUDA-graph replay and eager,
   TernausNet16's too); run Z, DeepLabMulti-Basic through the training
   CLI (bf16, base trained, RAFT + depth, batch 4, 4 micro-steps), its
   checkpoint tracked, and the single-frame CLI training SegFormer for 2
   steps with drop-path on;
7. the rest of the zoo (``phase_zoo10b_slice``, after phase 6):
   ``UNetMulti-Basic`` and ``ResUNetMulti-Basic`` at full width with RAFT x12
   (calibrated as in phase 6), 12 frames incremental (12 update steps and 1
   warp a frame counted) and 5 full, each through the kernels against the
   plain versions and f32 incremental against full, frames/s without flow,
   base and head ms and parameter counts; ResUNetMulti-Large with RAFT and
   depth (0 warps); TAPNet's attention map on a 480x640 RAFT flow
   (``cal_attmap_scatter`` on the card equal to ``cal_attmap_np``, the
   batched form through ``flow_warp`` against its plain route); TAPNet16's
   ``tapnet`` train step at batch 4 and its f32 forward against the CPU's;
   run U, UNetMulti-Basic through the training CLI (bf16, base trained,
   RAFT + depth, batch 4, 2 micro-steps, B1 once a micro-step);
8. the evaluation slice (``phase_eval_slice``, after phase 7): the
   single-frame video CLI's tracker (``SingleFrameEngine``,
   ``track_singleframe_frames``) with TernausNet16 at full width over the
   64 frames, bf16, device decode (its ``cc.cu`` launches counted), its
   rows through the kernels equal to those through the plain versions,
   its float32 heats and rows on the card held to the CPU's (the north
   star's gates), frames/s; DeepLab_v3 calibrated as in phase 6 (logits
   through ``log_softmax``, the union tier) with its launches counted, and
   once with ``score_detection_threshold`` 0.5; and the infer CLIs' device
   half (``track/infer_eval.py::device_half``) on a 480x640 test pack:
   ``infer_multiframe_endovis15``'s float32 eval step with
   TernausNetMulti-Basic and RAFT x12 (``flow_warp`` counted, no fused
   update step) and ``infer_toolpose_segmentation``'s with TernausNet16,
   each held to the CPU's log-probabilities and IoU/Dice, ms/sample in
   parity mode and in PyTorch's default settings;
9. the serving slice (``phase_artifact_slice``, after phase 8): three
   ``torch.export`` artifacts exported on the card and saved under
   ``build/artifacts`` -- the no-flow model's incremental step (symbolic
   batch), the full window of a TernausNetMulti-Basic with RAFT x12 (the
   fused update step) and depth, whose graph must name 12
   ``mfcnet.raft_update`` and 1 ``mfcnet.flow_warp``, and the single-frame
   TernausNet16 -- each tracked through ``ArtifactEngine`` (or the
   single-frame CLI's artifact engine) with the rows of the live engine of
   the same weights and mode; the RAFT artifact's run is the path's
   main-path run (12 update steps, 1 warp and 1 fill of hx a frame, the
   live engine's ``cc.cu`` launches) and is held against the live engine
   through the plain versions (0 launches inside); four streams through
   the incremental artifact against single-stream runs; export, save and
   load seconds, artifact MB, frames/s of artifact and live, the
   operators' dispatch cost and the update step's hx fill;
10. the backward slice (``phase_unflow_grad_slice``, after phase 9): the
   correlation's backward (B2, ``mfc_correlation_bwd``) against its plain
   version at the tracker's and the offline CLI's conv3 shapes in both
   types, the sampler's backward (B3, ``mfc_sample_bwd_img`` and
   ``mfc_sample_bwd_coords``) at 4x3x512x640 on flows past every edge and at
   integer coordinates (both padding modes, both layouts, both types; the
   border clamp's limits at half the gradient), their times, bounds and
   library calls; UnFlow's loss gradient at 4 pairs of 512x640, float32 and
   bfloat16 models, through the kernels (the path's main-path run: 1
   correlation, 1 B2, 2 backward warps, 2 of each B3 entry) against the
   plain backward on the same forward and against the plain forward and
   backward (``UNFLOW_GRAD_TOL``, every parameter and both frames); run A's
   micro-step with and without ``--remat``: parameters equal bit for bit in
   parity mode, the peak memory lower, both ms/step;
11. the data-parallel slice (``phase_ddp_slice``, after phase 10): run A
   (480x640, RAFT x12 and depth in the step, the base trained, grad_accum
   2, EMA) through the training CLI with ``--multihost true`` on two ranks
   (``python3 chip_smoke.py --ddp-rank``, spawned; both on cuda:0 over
   ``gloo``), 2 samples a rank, global batch 4: in float32 parity mode its
   parameters, BN statistics and EMA after 3 updates equal across the
   ranks bit for bit, and against one process at batch 4 (the first
   update's gradients too) within rtol 1e-4 / atol 1e-5 or no further than
   the same one-process run with its rows reordered, float32's rounding
   floor (``DDP_TOL``), and two control runs with a fault planted
   (rank-local losses; rank-local BN statistics) must fail that gate; in
   bf16 its ms per optimizer step and peak
   memory a rank beside one process's, and per micro-step and rank 12
   ``raft_update``, 1 ``flow_warp`` and 1 B1 (the ``train_ddp`` path's
   main-path run); a failed rank fails the phase; a 1-rank ``nccl`` group's
   all-reduce and run A's micro-step through DDP there, equal to the
   groupless step bit for bit; ``stream_shards=2`` (both shards on cuda:0)
   against the one-device 4-stream engine (f32, RAFT x12); and the legacy
   models and ABN, f32 at 480x640, against the CPU (``LEGACY_TOL``);
12. the fused step (``phase_fused_slice``, after phase 4): each tracker
   path with ``fused_dispatch`` against the same path unfused, on
   device-resident frames, both built from the earlier phases' engines --
   no flow (64 frames) and RAFT x12 (24), bf16 and f32 (parity mode), four
   streams with RAFT (12 steps), TernausNetMulti-Large with RAFT and depth
   (8), two streams over two stream shards on the one card (a graph each,
   8 steps), UnFlow and FFPP (6 frames each): masks,
   keypoint rows and heats byte-equal, one graph replay a frame after the
   first fused frame, no host synchronization from the capture on (the
   card's sync debug mode set to raise), the same decode tiers (chosen on
   the card by the IF nodes of ``csrc/graph_cond.cu``) and the same kernel
   launches (the fused paths' launches in the kernels line), the memory of
   the graph's pools; frames/s, the device's busy ms a step and idle share
   both ways (no flow, RAFT, four streams), and each hand kernel's device
   kernels in the profiled replays' trace between what the replay
   accounting counts outside the IF bodies and all it counts (the trace
   loses kernels inside IF bodies; the shortfall is logged); the IF nodes (an if/else nested in an if/else)
   against their host-read version, a replay's time, and a capture that
   syncs raising; the decode captured alone, replayed on a 480x640 class
   map of each tier (the union tier too).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import re
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
    ("backward_warp", CSRC + "warp.cu", "mfcnet_tpu/ops/warp_pallas.py:218"),
    ("correlation", CSRC + "correlation.cu",
     "mfcnet_tpu/ops/correlation_pallas.py:29"),
    ("vgg_stage1", CSRC + "stage1.cu",
     "mfcnet_tpu/experimental/stage1_pallas.py:47"),
    ("conv3x3", CSRC + "conv3x3.cu",
     "mfcnet_tpu/experimental/conv3x3_pallas.py:54"),
    ("flow_warp_bwd", CSRC + "warp.cu", "mfcnet_tpu/ops/warp_pallas.py:147"),
    ("correlation_bwd", CSRC + "correlation.cu",
     "mfcnet_tpu/ops/correlation_pallas.py:100"),
    ("sample_bwd_img", CSRC + "warp.cu", "mfcnet_tpu/ops/warp.py:17"),
    ("sample_bwd_coords", CSRC + "warp.cu", "mfcnet_tpu/ops/warp.py:17"),
    # no TPU kernel: the IF node that keeps the decode's choice of tier on
    # the card in the fused step, the counterpart of its lax.cond
    ("graph_if", CSRC + "graph_cond.cu",
     "mfcnet_tpu/track/decode_device.py:434"),
)
CC_KERNELS = tuple(k[0] for k in KERNELS[:4])
#: the decode's union tier
ZOO_CC = ("union_flood_cc_cid", "onehot_stats")
#: the kernels each main path must launch (the two experimental convolutions
#: are on no path, in this package as in the JAX one; warp_abs, the warp by
#: absolute coordinates, has had no caller on a path since UnFlow's backward
#: warp became the one-launch backward_warp)
PATH_KERNELS = {
    "no_flow": CC_KERNELS,
    "raft": CC_KERNELS + ("flow_warp", "raft_update"),
    "unflow": CC_KERNELS + ("flow_warp", "backward_warp", "correlation"),
    # the Large head warps nothing: flow_warp must stay at 0 there
    "large": CC_KERNELS + ("raft_update",),
    "streams": CC_KERNELS + ("flow_warp", "raft_update"),
    "train": ("flow_warp", "raft_update", "flow_warp_bwd"),
    # FlowFormer++: no hand kernel in the provider; the head's warp
    "ffpp": CC_KERNELS + ("flow_warp",),
    "train_ffpp": ("flow_warp", "flow_warp_bwd"),
    # the zoo slice: each family's Basic model on the RAFT path, SegFormer's
    # Large (no warp) with RAFT and depth, run Z (DeepLabMulti-Basic
    # trained). Their calibrated bases give clean class maps, which the
    # decode's union tier takes (union_flood_cc_cid + onehot_stats): the
    # other two cc.cu kernels run on the tiers of speckled maps only
    **{f"zoo_{f.lower()}": ZOO_CC + ("flow_warp", "raft_update")
       for f in ("DeepLab", "FCN", "HRNet", "SegFormer")},
    "zoo_large": ZOO_CC + ("raft_update",),
    "train_zoo": ("flow_warp", "raft_update", "flow_warp_bwd"),
    # the rest of the zoo (ROADMAP item 10b): UNetMulti-Basic and
    # ResUNetMulti-Basic on the RAFT path, ResUNetMulti-Large (no warp),
    # run U (UNetMulti-Basic trained) and TAPNet's attention map
    "zoo_unet": ZOO_CC + ("flow_warp", "raft_update"),
    "zoo_resunet": ZOO_CC + ("flow_warp", "raft_update"),
    "zoo_resunet_large": ZOO_CC + ("raft_update",),
    "train_unet": ("flow_warp", "raft_update", "flow_warp_bwd"),
    "attmap": ("flow_warp",),
    # the evaluation slice (ROADMAP item 10c): the single-frame tracker with
    # TernausNet16 (random maps: every tier) and with a calibrated DeepLab_v3
    # (clean maps: the union tier), and the multi-frame evaluator's float32
    # eval step with RAFT (plain update block; the Basic head's warp)
    "singleframe": CC_KERNELS,
    "singleframe_zoo": ZOO_CC,
    "infer_raft": ("flow_warp",),
    # the serving slice (ROADMAP item 11c): a bf16 full-window artifact
    # with RAFT and depth, whose graph runs the update step and the warp as
    # registered operators; the decode after it
    "artifact": CC_KERNELS + ("flow_warp", "raft_update"),
    # the backward slice (ROADMAP items 8b-8d): UnFlow's loss gradient at 4
    # pairs of 512x640 through the correlation, the backward warp and their
    # backward kernels (B2; B3's two entry points)
    "unflow_grad": ("correlation", "backward_warp", "correlation_bwd",
                    "sample_bwd_img", "sample_bwd_coords"),
    # the data-parallel slice (ROADMAP item 11d): run A's bf16 micro-steps
    # on 2 ranks through DDP
    "train_ddp": ("flow_warp", "raft_update", "flow_warp_bwd"),
    # fused_dispatch (phase 12): the same paths as one CUDA graph replay a
    # frame, the decode's IF nodes in it (an if/else, an if/else nested in
    # its per-blob branch)
    "fused_no_flow": CC_KERNELS + ("graph_if",),
    "fused_raft": CC_KERNELS + ("flow_warp", "raft_update", "graph_if"),
    "fused_large": ZOO_CC + ("raft_update", "graph_if"),
    "fused_streams": ZOO_CC + ("flow_warp", "raft_update", "graph_if"),
    "fused_unflow": ZOO_CC + ("flow_warp", "backward_warp", "correlation",
                              "graph_if"),
    "fused_ffpp": ZOO_CC + ("flow_warp", "graph_if"),
}
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 and TF32 tensor-core
# and plain float32 operations/s (the bounds are stated against these peaks whatever
# the card's power limit, which is printed beside them)
PEAK_BYTES, PEAK_BF16, PEAK_TF32, PEAK_F32 = 3.35e12, 989e12, 495e12, 67e12
FLOW_FRAMES, FLOW_ITERS = 24, 12
#: the Large path's incremental run; the multi-stream path's four streams
#: (unequal: the padded steps' results are dropped); the streams timed at
#: each B of phase 4, and their length
LARGE_FRAMES = 16
STREAM_LENGTHS = (24, 24, 20, 13)
TIMED_STREAMS, TIMED_STREAM_FRAMES = (1, 2, 4, 8), 24
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
#: the same for the Large path, whose head reads the flow raw (the 11x11
#: conv's 4 x 121 flow taps): a flipped bf16 rounding in the update step
#: moves the flow by a few hundredths of a pixel, and at these random widths
#: a flow difference of d px moves a class probability by about 0.15 d;
#: 2^-8 holds 0.025 px of it. The Basic head only resamples maps by the
#: flow and moves far less
LARGE_PROB_TOL = 2.0 ** -8
#: the same for the UnFlow path, whose random provider gives flows of ~6 px
#: (RAFT's: ~17 px), so that a lost flow moves the probabilities less: half
#: the limit. Its flow may differ by more: three stacked bf16 networks of
#: ~25 layers each carry a flipped rounding of the cost volume further than
#: RAFT's update steps do (found: 0.06 px, 1 % of the largest flow).
UNFLOW_PROB_TOL, UNFLOW_FLOW_TOL = 2.0 ** -14, 0.25
#: the bf16 UnFlow provider against the float32 one: mean |difference| over
#: mean |flow|, and max |difference| over max |flow|
UNFLOW_BF16_MEAN, UNFLOW_BF16_MAX = 0.03, 0.05
#: the FFPP path: FlowFormer++ at its default widths, 12 iterations, its
#: random flow head's last convolution scaled by FFPP_FLOW_GAIN: unscaled
#: the flows reach 13.4 px at 240x320 on a shifted noise pair (CPU); scaled,
#: on the engine's frames, 9.2 px at 240x320 (mean 3.2) and 18.3 px at full
#: resolution. Its limit for the kernels-vs-plain probabilities is half the
#: RAFT path's, as UnFlow's is: a zeroed flow moves this random model's
#: probabilities by only ~5e-4, and the check needs four limits below that
FFPP_FRAMES, FFPP_FLOW_GAIN, FFPP_PROB_TOL = 24, 0.25, 2.0 ** -14
#: the card's float32 FFPP (TF32 off) against the same model on the CPU, 2
#: pairs at 240x320, 12 iterations: max |diff| - rtol * |flow| <= atol px.
#: float32 sums in other orders carried through the perceiver and 12
#: recurrent iterations: the default-width tolerance of the CPU tests
#: against the JAX package (tests/test_torch_ffpp.py, (atol, rtol))
FFPP_F32_TOL = (2e-3, 1e-3)
#: the bf16 experimental convolutions' times before their redesign (ms,
#: PERF.md rows 7 and 8: this script on an H100 80GB HBM3 at 700 W), printed
#: beside this run's
EARLIER_MS = {"conv3x3": 0.2359, "conv3x3@240x320x64->128": 0.1085,
              "vgg_stage1": 0.4764}


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


def flood_check_maps(seed: int = SEED):
    """(name, (B, h, w) int8 class images in the union encoding) on which
    the two flood kernels are held to their plain versions: speckle with
    blobs at ragged sizes and B = 1, 4 and 8, 60,000 small images,
    all-background and all-one-class frames, a one-pixel-wide serpentine
    (the longest parent chains, in the class and in the background between
    its turns) and a checkerboard (4- against 8-connectivity)."""
    rng = np.random.default_rng(seed)

    def speckled(B, h, w):
        u = rng.integers(0, 5, (B, h, w)) * (rng.random((B, h, w)) < 0.3)
        for b in range(B):
            for _ in range(4):
                y, x = rng.integers(0, h), rng.integers(0, w)
                u[b, y:y + rng.integers(1, h + 1),
                  x:x + rng.integers(1, w + 1)] = rng.integers(1, 5)
        return u.astype(np.int8)

    maps = [(f"speckle {B}x{h}x{w}", speckled(B, h, w))
            for B, h, w in ((1, 481, 643), (4, 481, 643), (8, 65, 129),
                            (4, 7, 5), (8, 1, 1), (1, 1, 640))]
    # more images than a block's shared memory could hold a chunk count of
    # each (the kernels keep the counts in global memory)
    B, h, w = 60000, 13, 21
    maps.append((f"speckle {B}x{h}x{w}", (
        rng.integers(0, 5, (B, h, w)) * (rng.random((B, h, w)) < 0.6)
    ).astype(np.int8)))
    maps.append(("all background", np.zeros((1, H, W), np.int8)))
    maps.append(("all one class", np.full((1, H, W), 3, np.int8)))
    serp = np.zeros((H, W), np.int8)
    serp[::2, :-1] = 2
    serp[1::4, -2] = 2
    serp[3::4, 0] = 2
    maps.append(("serpentine", serp[None]))
    maps.append(("checkerboard",
                 (np.indices((1, H, W)).sum(0) % 2 * 3).astype(np.int8)))
    return maps


def class_masks(u):
    """(B, h, w) union class image -> the (4B, h, w) bool class masks that
    the per-blob tier hands to ``flood_cc_cid``."""
    import torch

    return torch.stack([u == c for c in (1, 2, 3, 4)], 1).reshape(
        -1, *u.shape[1:]).contiguous()


def check_cc_kernels(u, what):
    """The four ``cc.cu`` kernels against their plain versions, bit for
    bit, on the union class image ``u`` (B, h, w) int8 and its class masks:
    the two flood kernels; ``connected_components`` 4- and 8-connected on
    the masks, their background and the hole-filled masks (the decode's
    two calls among them); ``onehot_stats`` on the union tier's outputs
    and on the per-blob tier's. Returns the union kernel's outputs."""
    from mfcnet_tpu_torch.ops import cc

    union = cc.union_flood_cc_cid(u, K)
    for g, w, nm in zip(union, cc.union_flood_cc_cid_plain(u, K),
                        ("cid", "he", "cide", "ncomp", "conflict")):
        _equal(f"union_flood_cc_cid[{what}].{nm}", g, w)
    for g, w, nm in zip(cc.onehot_stats(*union[:3], K),
                        cc.onehot_stats_plain(*union[:3], K),
                        ("stats", "ccls")):
        _equal(f"onehot_stats[{what}, union tier].{nm}", g, w)
    m = class_masks(u)
    got = cc.flood_cc_cid(m, K)
    for g, w, nm in zip(got, cc.flood_cc_cid_plain(m, K),
                        ("cid", "filled", "ncomp")):
        _equal(f"flood_cc_cid[{what}].{nm}", g, w)
    cid, filled = got[:2]
    for g, w, nm in zip(cc.onehot_stats(cid, filled * 8, None, K),
                        cc.onehot_stats_plain(cid, filled * 8, None, K),
                        ("stats", "ccls")):
        _equal(f"onehot_stats[{what}, per-blob tier].{nm}", g, w)
    for mm, nm in ((m, "masks"), ((~m).contiguous(), "background"),
                   (filled.bool(), "filled")):
        for conn in (4, 8):
            _equal(f"connected_components[{what}, {nm}, {conn}]",
                   cc.connected_components(mm, conn),
                   cc.connected_components_plain(mm, conn))
    return union


def check_plan_refusals(dev):
    """Every ``cc.cu`` kernel launches only with ``cc_plan``'s plan for
    its entry point and shape and a grid the card holds at once: another
    plan raises, and nothing is counted as launched."""
    from unittest import mock

    import torch

    from mfcnet_tpu_torch.ops import cc

    u = torch.zeros(2, 33, 70, dtype=torch.int8, device=dev)
    m = class_masks(u)
    i32 = torch.zeros(2, 33, 70, dtype=torch.int32, device=dev)
    right = cc.cc_plan

    def more_ints(*a, **kw):
        plan = right(*a, **kw)
        return dict(plan, work_ints=plan["work_ints"] + 1)

    def too_many_blocks(B, H, W, sms, **kw):
        return right(B, H, W, sms, 4 * cc.FLOOD_BLOCKS_PER_SM, **kw)

    def other_entry(*a, entry="flood", **kw):  # a plan of another kernel
        other = {"flood": "cc_labels", "cc_labels": "onehot_stats",
                 "onehot_stats": "cc_labels"}[entry]
        return right(*a, entry=other)

    for what, bad in (
            ("another shape's workspace", more_ints),
            ("another tile edge", lambda *a, **kw: dict(right(*a, **kw),
                                                        tile=32)),
            ("another entry point's plan", other_entry),
            ("more blocks than the card holds at once", too_many_blocks)):
        before = dict(cc.LAUNCHES)
        for call in (lambda: cc.union_flood_cc_cid(u, K),
                     lambda: cc.flood_cc_cid(m, K),
                     lambda: cc.connected_components(m, 4),
                     lambda: cc.connected_components(m, 8),
                     lambda: cc.onehot_stats(i32, i32, i32, K)):
            with mock.patch.object(cc, "cc_plan", bad):
                try:
                    call()
                except RuntimeError as e:
                    if "refused the plan" not in str(e):
                        raise
                else:
                    raise AssertionError(f"a cc.cu kernel took {what}")
        if cc.LAUNCHES != before:
            raise AssertionError("a refused launch was counted")


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
    # C7520: ptxas serialized a kernel's wgmma (a divergent path); ~30 % of
    # a core's time where it shows
    serial = [re.split(r"_cu_[0-9a-f]{8}\d+", line.rstrip("'"))[-1]
              .split("Ev")[0] for line in kl.build_log.splitlines()
              if "(C7520)" in line]
    if kl.build_seconds:
        log(f"ptxas C7520 (wgmma serialized) in {len(serial)} kernels of "
            f"the sources built now" + (f": {', '.join(serial)}" if serial
                                        else ""))
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
    from mfcnet_tpu_torch.ops._build import sm_count

    dev = torch.device("cuda")
    for name, m in crafted_class_maps().items():
        ncomp, conflict = check_cc_kernels(
            torch.from_numpy(m).to(dev)[None].contiguous(), name)[3:]
        log(f"kernels == plain on '{name}': ncomp={int(ncomp[0])} "
            f"conflict={bool(conflict[0])}")
    more = flood_check_maps()
    for name, m in more:
        check_cc_kernels(torch.from_numpy(m).to(dev), name)
    log(f"the four cc.cu kernels == plain on {len(more)} more inputs: "
        f"{', '.join(n for n, _ in more)}")
    check_plan_refusals(dev)
    for entry in cc.PLAN_ENTRIES:
        log(f"cc.cu plan of {entry}, B=4 {H}x{W}: "
            f"{json.dumps(cc.cc_plan(4, H, W, sm_count(dev), entry=entry))}")
    log("the C side refuses a plan of another shape or entry point and a "
        "grid the card cannot hold")
    torch.cuda.synchronize()
    # every comparison above demanded bit equality
    errs = {k: 0.0 for k in CC_KERNELS}
    (errs["flow_warp"], errs["warp_abs"],
     errs["backward_warp"]) = _check_warp_kernel()
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


def _warp_abs_backward_warp(img, flow):
    """UnFlow's backward warp as it ran before the one-launch kernel: the
    coordinates in ~20 elementwise PyTorch kernels, then ``warp_abs``
    through ``grid_sample_bilinear`` (which copies a ``channels_last`` frame
    to NCHW first). Kept as the yardstick the new entry point is read
    against, and as the caller that holds ``warp_abs`` to its plain
    version."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    _, _, h, w = img.shape
    dev = img.device

    def c(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=dev)
    flow = flow.float()
    gx = xs.view(1, 1, w) + flow[:, 0] / c((w - 1) / 2.0)
    gy = ys.view(1, h, 1) + flow[:, 1] / c((h - 1) / 2.0)
    return warp.grid_sample_bilinear(img, gx, gy, align_corners=False,
                                     padding_mode="border")


#: marker kernels (``torch.cuda._sleep``'s spin kernel of MARK_CYCLES clock
#: cycles, which no measured call runs: the decode's own bitwise nots made
#: every profiled tracker step look torn) on each side of a profiled call,
#: the seconds of host time after the opening and the closing ones, and the
#: sessions tried before the trace is given up
MARKS, SETTLE_S, SESSIONS = 3, 0.02, 8
MARK_CYCLES, MARK_NAME = 1000, "spin_kernel"


def _profiled(fn, spans=False, outside=False):
    """One ``torch.profiler`` session (CUDA activity) around one call of
    ``fn``: (its result, [(name, device us)] of the kernels and copies it
    ran -- with ``spans`` [(name, device us, start us, end us)] --, whether
    the trace is whole, wall ms of the call; with ``outside``, the names of
    the session's other device events that are not markers: nothing else
    runs in the session, so they are the call's too, recorded out of
    order). The card's trace
    has dropped device events of a session, at its start and after its
    opening markers, so MARKS markers open the call and MARKS close it; the
    trace is whole when all of them were recorded, and the call's events
    are then those between the two groups."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for _ in range(MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if MARK_NAME in e.name]
    whole = (len(marks) == 2 * MARKS
             and marks[MARKS - 1] - marks[0] == MARKS - 1
             and marks[-1] - marks[MARKS] == MARKS - 1)
    if whole:
        inside = events[marks[MARKS - 1] + 1:marks[MARKS]]
    else:  # what the trace kept of the call
        inside = [e for e in events if MARK_NAME not in e.name]
    kept = {id(e) for e in inside}
    rest = [e.name for e in events
            if MARK_NAME not in e.name and id(e) not in kept]
    return (out, [(e.name, e.time_range.elapsed_us())
                  + ((e.time_range.start, e.time_range.end) if spans else ())
                  for e in inside], whole, wall) + ((rest,) if outside else ())


def _busy_ms(events):
    """ms in which the device ran at least one of ``events`` (with spans):
    the union of their intervals, since kernels may overlap (the update
    step's programmatic dependent launches)."""
    busy, end = 0.0, float("-inf")
    for _, _, a, b in sorted(events, key=lambda e: e[2]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def _device_events(fn):
    """(name, device us) of every kernel and copy the device ran for one
    call of ``fn``, from the first whole trace of up to SESSIONS (see
    ``_profiled``); raises if none was whole."""
    fn()
    for i in range(SESSIONS):
        _, events, whole, _ = _profiled(fn)
        if whole:
            return events
        log(f"profiler session {i + 1} of {SESSIONS} lost device events "
            f"(kept {len(events)} of the call's); tried again")
    raise RuntimeError(f"the profiler lost device events in all {SESSIONS} "
                       "sessions; the call's device operations are unknown")


def _count_device_kernels(fn):
    """Names of the kernels and copies the device ran for one call of
    ``fn``."""
    return [name for name, _ in _device_events(fn)]


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
            ops = _count_device_kernels(
                lambda: warp.flow_warp(maps, flow, (576, 720)))
            if len(ops) != 1 or "flow_warp" not in ops[0]:
                raise AssertionError(f"flow_warp[{dt}, C={ch}]: one device "
                                     f"operation a call expected, got {ops}")
    # the second entry point (the sample at source coordinates, which it
    # forms from the normalized grid) through grid_sample_bilinear, both
    # align_corners and padding modes, an even and an odd output width (the
    # vector and the element path), float32 and bf16 images; one device
    # operation a call on a float32 grid
    worst_abs = 0.0
    for ho, wo in ((100, 120), (37, 61)):
        gx = (torch.rand(2, ho, wo, generator=gen) * 2.4 - 1.2).cuda()
        gy = (torch.rand(2, ho, wo, generator=gen) * 2.4 - 1.2).cuda()
        for dt in (torch.float32, torch.bfloat16):
            img = torch.randn(2, 3, 50, 70, generator=gen).cuda().to(dt)
            for ac in (True, False):
                for pm in ("zeros", "border"):
                    got = warp.grid_sample_bilinear(img, gx, gy, ac, pm)
                    want = warp.grid_sample_bilinear_plain(img, gx, gy, ac,
                                                           pm)
                    what = f"warp_abs[{dt}, {ho}x{wo}, {ac}, {pm}]"
                    if got.dtype != dt or got.shape != (2, 3, ho, wo):
                        raise AssertionError(f"{what}: type or shape")
                    if dt == torch.float32:
                        _equal(what, got, want)
                    err = (got.float() - want.float()).abs().max().item()
                    if err > WARP_ATOL[str(dt).split(".")[1]]:
                        raise AssertionError(f"{what}: {err}")
                    worst_abs = max(worst_abs, err)
        ops = _count_device_kernels(
            lambda: warp.grid_sample_bilinear(img, gx, gy, False, "border"))
        if len(ops) != 1 or "warp_abs" not in ops[0]:
            raise AssertionError(f"grid_sample_bilinear: one device "
                                 f"operation a call expected, got {ops}")
    # ... and in UnFlow's backward warp as it ran before the one-launch
    # kernel: 3-channel frames at half resolution, both types
    for dt in (torch.float32, torch.bfloat16):
        frame = torch.randn(2, 3, UH // 2, UW // 2, generator=gen).cuda().to(dt)
        fl = (torch.randn(2, 2, UH // 2, UW // 2, generator=gen) * 8.0).cuda()
        got = _warp_abs_backward_warp(frame, fl)
        want = warp.backward_warp_plain(frame, fl)
        err = (got.float() - want.float()).abs().max().item()
        if err > WARP_ATOL[str(dt).split(".")[1]] * 8:
            raise AssertionError(f"warp_abs[backward_warp, {dt}]: {err}")
        worst_abs = max(worst_abs, err)
    # the one-launch backward warp: UnFlow's shape, the four sampling modes,
    # NCHW and channels_last, float32 and bfloat16 frames and flows. The
    # kernel repeats the plain version's float32 operations one by one, so
    # float32 results are held to bit equality and bfloat16 ones to one
    # rounding of values up to 4 (found: equal too); the result keeps its
    # input's memory format
    worst_bw = 0.0
    for dt in (torch.float32, torch.bfloat16):
        frame = torch.randn(2, 3, UH // 2, UW // 2, generator=gen).cuda().to(dt)
        flow = (torch.randn(2, 2, UH // 2, UW // 2, generator=gen) * 8.0
                ).cuda()
        flow[0, :, :8] += 400.0  # rows that leave the image
        for fmt in (torch.contiguous_format, torch.channels_last):
            img = frame.contiguous(memory_format=fmt)
            for fdt in (torch.float32, torch.bfloat16):
                fl = flow.to(fdt).contiguous(memory_format=fmt)
                for ac in (False, True):
                    for pm in ("zeros", "border"):
                        got = warp.backward_warp(img, fl, ac, pm)
                        want = warp.backward_warp_plain(img, fl, ac, pm)
                        torch.cuda.synchronize()
                        what = (f"backward_warp[{dt}, {fmt}, flow {fdt}, "
                                f"align_corners={ac}, {pm}]")
                        if got.stride() != img.stride():
                            raise AssertionError(
                                f"{what}: result strides {got.stride()} are "
                                f"not the input's {img.stride()}")
                        if dt == torch.float32:
                            _equal(what, got, want)
                        err = (got.float() - want.float()).abs().max().item()
                        if err > WARP_ATOL["bfloat16"] * 8:
                            raise AssertionError(f"{what}: {err}")
                        worst_bw = max(worst_bw, err)
    log(f"flow_warp kernel vs plain: 2x{{{C},{C + 1}}}x{H}x{W}, f32 (atol "
        f"{WARP_ATOL['float32']}) and bf16 (atol {WARP_ATOL['bfloat16']}), "
        f"bounded / beyond the band / out of the image / zero flow on the "
        f"576x720 grid: max |diff| {worst}, one device operation a call; "
        f"warp_abs (grid_sample_bilinear, one device operation a call) 4 "
        f"modes at 2x3x100x120 and 2x3x37x61, f32 bit for bit, bf16 within "
        f"one rounding, and the earlier "
        f"backward warp at 2x3x{UH // 2}x{UW // 2} (f32, bf16 within one "
        f"rounding of values up to 4): max |diff| {worst_abs}; backward_warp "
        f"(one launch) at 2x3x{UH // 2}x{UW // 2}, 4 modes x NCHW / "
        f"channels_last x f32 / bf16 frames x f32 / bf16 flows, f32 bit for "
        f"bit, bf16 within one rounding: max |diff| {worst_bw}")
    return worst, worst_abs, worst_bw


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
        # a near-empty call, a ragged grid, the tracker's size and the
        # frozen provider's size inside a training step: in bfloat16 with
        # clusters that split the taps (the first three) and without
        for B, H8, W8 in ((1, 2, 2), (2, 9, 13), (2, H // 16, W // 16),
                          (8, 60, 80)):
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
            plan = ru.tile_plan(B, H8, W8)
            # the share of the tolerance used: |diff| / (atol + rtol |plain|)
            share = max(((g - w).abs() / (atol + rtol * w.abs())).max().item()
                        for g, w in zip(got, want))
            log(f"raft_update kernel vs plain [{dt}, {B}x{H8}x{W8} tokens]: "
                f"max |diff| net {(got[0] - want[0]).abs().max().item():.3g} "
                f"delta {(got[1] - want[1]).abs().max().item():.3g} "
                f"(atol {atol}, rtol {rtol}; {share:.3f} of the tolerance); "
                f"configuration '{plan.config}', {plan.rows}x{plan.cols}-"
                f"token tiles, clusters {plan.clusters}")
        # three iterations through one workspace (hx filled by the first
        # only), then three with [net | inp] written every call: the same
        # kernels on the same values, so bit for bit
        B, H8, W8 = 2, H // 16, W // 16
        c1, f1, inp, net, flow, packed = _raft_update_inputs(
            ub, dt, B, H8, W8, gen)[:6]
        ru.reset_launches()
        ws = ru.UpdateWorkspace(B, H8, W8, packed, "cuda")
        n_ws, kept, solve = net, net.clone(), []
        for i in range(3):
            n_ws, d_ws = ru.raft_update(c1, f1, inp, n_ws, flow, packed, H8,
                                        W8, ws)
            solve.append((n_ws, d_ws))
        fills = ru.COUNTS["hx_fills"]
        n_each = net
        for i, (n_ws, d_ws) in enumerate(solve):
            n_each, d_each = ru.raft_update(c1, f1, inp, n_each, flow, packed,
                                            H8, W8)
            torch.cuda.synchronize()
            _equal(f"raft_update[{dt}] through a workspace, call {i}: net",
                   n_ws, n_each)
            _equal(f"raft_update[{dt}] through a workspace, call {i}: delta",
                   d_ws, d_each)
        _equal("raft_update: the caller's net", net, kept)
        if fills != 1 or ru.COUNTS["hx_fills"] != 1 + 3 \
                or ru.LAUNCHES["raft_update"] != 6:
            raise AssertionError(
                f"raft_update: hx must be filled once per workspace "
                f"({ru.COUNTS}, {ru.LAUNCHES})")
    return worst


def _check_correlation_kernel():
    """The cost volume at the UnFlow path's two shapes (tracker: 2 pairs at
    256x320 -> 32x40 features; offline CLI: 4 pairs at 512x640 -> 64x80) and
    one odd small case, float32 and bfloat16 inputs; the route
    ``ops/correlation.py::corr_plan`` chose for each, and the worst
    |difference| per route."""
    import torch

    from mfcnet_tpu_torch.ops import correlation as co

    gen = torch.Generator().manual_seed(SEED)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape, md, s in (((2, UH // 16, UW // 16, 256), 20, 2),
                             ((4, UH // 8, UW // 8, 256), 20, 2),
                             ((1, 9, 45, 7), 5, 3)):
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            plan = co.corr_plan(*shape, md, s, str(dt).split(".")[1])
            r = _hold_correlation(f1, f2, md, s,
                                  f"{dt}, {shape}, md={md}, s={s}")
            log(f"correlation {str(dt).split('.')[1]} {'x'.join(map(str, shape))}"
                f" md={md} s={s}: route {plan.route} "
                f"{json.dumps(plan._asdict())}, {_corr_readings(r)}")
            worst[plan.route] = max(worst.get(plan.route, 0.0), r["err"])
    # the C side computes corr_plan's plan itself and refuses any other
    import ctypes

    from mfcnet_tpu_torch.ops._build import kernel_lib, stream_of

    shape = (2, UH // 16, UW // 16, 256)
    f = torch.zeros(shape, device="cuda")
    out = torch.empty(*shape[:3], 441, device="cuda")
    good = co.corr_plan(*shape, 20, 2, "float32").ints()
    for i in range(1, len(good)):
        bad = list(good)
        bad[i] += 1
        rc = kernel_lib().mfc_correlation(
            f.data_ptr(), f.data_ptr(), out.data_ptr(), *shape, 20, 2, 0,
            (ctypes.c_int * len(bad))(*bad), stream_of(f))
        if rc != 20003:
            raise AssertionError(f"correlation: plan {bad} not refused ({rc})")
    atol, rtol = CORR_TOL
    log("correlation: the C side refuses every plan that differs from "
        "corr_plan's in one field (20003)")
    log(f"correlation kernel vs plain: 2x{UH // 16}x{UW // 16}x256 and "
        f"4x{UH // 8}x{UW // 8}x256 (md=20, s=2, 441 channels) and 1x9x45x7 "
        f"(md=5, s=3), f32 and bf16 inputs: max |diff| by route "
        f"{json.dumps(worst)} (atol {atol}, rtol {rtol})")
    return max(worst.values())


def _residue_grams(f1, f2, s):
    """Each (image, y mod s, x mod s) sub-grid of f1 and f2 as a (P, C)
    matrix, stacked (B * s * s, P, C): the correlation's library yardstick
    multiplies them."""
    B, H, W, C = f1.shape

    def split(f):
        g = f.reshape(B, H // s, s, W // s, s, C).permute(0, 2, 4, 1, 3, 5)
        return g.reshape(B * s * s, (H // s) * (W // s), C).contiguous()

    return split(f1), split(f2)


def _abs_coords(flow, H, W):
    """UnFlow's backward-warp coordinates (linspace grid + flow, unnormalized
    with align_corners=False, border clamp) as absolute pixel positions
    (B, H, W) each, and the same grid normalized for ``F.grid_sample``."""
    import torch

    dev = flow.device
    xs = torch.linspace(-1, 1, W, device=dev).view(1, 1, W)
    ys = torch.linspace(-1, 1, H, device=dev).view(1, H, 1)
    gx = xs + flow[:, 0] / ((W - 1) / 2.0)
    gy = ys + flow[:, 1] / ((H - 1) / 2.0)
    fx = (((gx + 1.0) * W - 1.0) * 0.5).clamp(0, W - 1).contiguous()
    fy = (((gy + 1.0) * H - 1.0) * 0.5).clamp(0, H - 1).contiguous()
    return fx, fy, torch.stack([gx, gy], -1)


def _correlation_f64(f1, f2, md, s):
    """The correlation in float64 (the plain version's loop, exact mean):
    the yardstick that tells the kernel's rounding from the plain
    version's."""
    import torch
    import torch.nn.functional as F

    B, H, W, C = f1.shape
    r = md // s
    a = f1.double()
    b = F.pad(f2.double(), (0, 0, md, md, md, md))
    return torch.stack([(a * b[:, md + dy * s:md + dy * s + H,
                               md + dx * s:md + dx * s + W]).sum(-1) / C
                        for dy in range(-r, r + 1)
                        for dx in range(-r, r + 1)], dim=-1)


def _hold_correlation(f1, f2, md, s, what):
    """The kernel against its plain version and against a float64
    reference, within CORR_TOL of each; one launch and one device
    operation. Returns the max |difference| from the plain version
    (``err``), the share of the tolerance it uses, max(|diff| / (atol +
    rtol |want|)) (``margin``), and the same two against float64 for the
    kernel (``err_f64``, ``margin_f64``) and for the plain version
    (``plain_err_f64``, ``plain_margin_f64``)."""
    import torch

    from mfcnet_tpu_torch.ops import correlation as co

    co.reset_launches()
    got = co.correlation_cost_volume(f1, f2, md, s)
    launches = co.LAUNCHES["correlation"]
    torch.cuda.synchronize()
    want = co.correlation_plain(f1, f2, md, s)
    exact = _correlation_f64(f1, f2, md, s)
    atol, rtol = CORR_TOL

    def diff(x, ref):
        d = (x.double() - ref.double()).abs()
        return (d.max().item(),
                (d / (atol + rtol * ref.double().abs())).max().item())

    err, margin = diff(got, want)
    err64, margin64 = diff(got, exact)
    plain64, plain_margin64 = diff(want, exact)
    if not (got.shape == want.shape and got.dtype == torch.float32
            and margin <= 1.0 and margin64 <= 1.0):
        raise AssertionError(
            f"correlation[{what}]: kernel != plain or float64 (max |diff| "
            f"{err}, {margin:.3g} of the tolerance; from float64 {err64}, "
            f"{margin64:.3g}; atol {atol} rtol {rtol})")
    ops = _count_device_kernels(
        lambda: co.correlation_cost_volume(f1, f2, md, s))
    if launches != 1 or len(ops) != 1:
        raise AssertionError(f"correlation[{what}]: {launches} launches, "
                             f"device operations {ops}; expected one each")
    return {"err": err, "margin": margin, "err_f64": err64,
            "margin_f64": margin64, "plain_err_f64": plain64,
            "plain_margin_f64": plain_margin64}


def _corr_readings(r):
    """One line's worth of ``_hold_correlation``'s readings."""
    return (f"max |diff| from plain {r['err']:.3g} = {r['margin']:.3g} of "
            f"the tolerance; from float64: kernel {r['err_f64']:.3g} = "
            f"{r['margin_f64']:.3g}, plain {r['plain_err_f64']:.3g} = "
            f"{r['plain_margin_f64']:.3g}")


def _corr_route(f1, kw):
    from mfcnet_tpu_torch.ops import correlation as co

    return co.corr_plan(*f1.shape, kw["max_displacement"], kw["stride"],
                        str(f1.dtype).split(".")[1]).route


def _provider_correlation_inputs(model, run):
    """The (f1, f2) that ``model`` (a UnFlow) hands the correlation during
    ``run()``: its own conv3 features, recorded at the call."""
    from mfcnet_tpu_torch.models import unflow

    seen = []
    inner = unflow.correlation_cost_volume

    def recording(f1, f2, **kw):
        seen.append((f1, f2, kw))
        return inner(f1, f2, **kw)

    unflow.correlation_cost_volume = recording
    try:
        run()
    finally:
        unflow.correlation_cost_volume = inner
    if len(seen) != 1:
        raise AssertionError(f"UnFlow: {len(seen)} correlations per call")
    return seen[0]


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
    ragged shapes that take the persistent walk's edges, every tile width
    and both halo loaders of the bfloat16 core (1x37x131x64 -> 64, 3x8x64x16
    -> 8, 2x17x23x5 -> 70 and, at full size, 1x480x640x5 -> 64 by plain
    loads), several 64-channel chunks of cin a tile (cin 128, 100, 256, 512)
    and the tile kernel past the core's resident weights (cin 600);
    vgg_stage1 at 1x480x640x3, 2x19x23x3 and 1x37x131x3, C1 = 64, with the
    model's own weights, also against what the model's first stage gives,
    and with random first weights at cin 8 (the core, one row a tile) and
    16 (the tile kernel). Prints the plan of each bfloat16 shape."""
    import torch

    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1

    gen = torch.Generator().manual_seed(SEED)
    sms = c3.sm_count(torch.device("cuda"))
    worst = {"conv3x3": 0.0, "vgg_stage1": 0.0}
    conv_shapes = ((1, H, W, 64, 64), (1, H // 2, W // 2, 64, 128),
                   (1, 37, 131, 64, 64), (3, 8, 64, 16, 8), (2, 17, 23, 5, 70),
                   (1, H, W, 5, 64), (1, 37, 131, 128, 64),
                   (1, 20, 70, 100, 64), (1, 24, 70, 256, 40),
                   (1, 9, 70, 512, 16), (1, 9, 20, 600, 70))
    stage_shapes = ((1, H, W, 3), (2, 19, 23, 3), (1, 37, 131, 3),
                    (1, 21, 40, 8), (1, 13, 18, 16))
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        atol, rtol = CONV_TOL[name]
        stage, k1, b1, k2, b2 = _first_stage_weights(dt)
        for B, Hc, Wc, cin, cout in conv_shapes:
            if name == "bfloat16":
                log(f"conv3x3 {B}x{Hc}x{Wc}x{cin}->{cout}: "
                    f"{c3.conv_plan(B, Hc, Wc, cin, cout, sms)}")
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
        for shape in stage_shapes:
            if name == "bfloat16":
                log(f"vgg_stage1 {'x'.join(map(str, shape))}->64: "
                    f"{c3.stage1_plan(*shape, 64, sms)}")
            x = torch.randn(shape, generator=gen).cuda().to(dt)
            model_k1 = shape[-1] == 3
            k1x = k1 if model_k1 else (
                torch.randn(3, 3, shape[-1], 64, generator=gen)
                * (2.0 / (9 * shape[-1])) ** 0.5).cuda().to(dt)
            got = s1.vgg_stage1(x, k1x, b1, k2, b2)
            torch.cuda.synchronize()
            want = s1.vgg_stage1_plain(x, k1x, b1, k2, b2)
            err = (got.float() - want.float()).abs().max().item()
            if not (got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=rtol, atol=2 * atol)):
                raise AssertionError(
                    f"vgg_stage1[{name}, {shape}]: kernel != plain (max "
                    f"|diff| {err}; atol {2 * atol} rtol {rtol})")
            if name == "bfloat16":
                worst["vgg_stage1"] = max(worst["vgg_stage1"], err)
            if not model_k1:
                log(f"vgg_stage1 [{name}, {shape}]: max |diff| {err:.3g} vs "
                    f"plain")
                continue
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
    log(f"conv3x3 kernel vs plain: "
        f"{', '.join('x'.join(map(str, s[:4])) + f'->{s[4]}' for s in conv_shapes)}"
        f", with bias + ReLU and without, f32 (atol "
        f"{CONV_TOL['float32'][0]}, rtol {CONV_TOL['float32'][1]}) and bf16 "
        f"(atol {CONV_TOL['bfloat16'][0]}, rtol {CONV_TOL['bfloat16'][1]}): "
        f"max |diff| in bf16 {worst['conv3x3']:.3g}")
    return worst


def _plain_unflow_kernels():
    """Context in which the UnFlow path runs the plain versions of the
    correlation, of the backward warp, of their backward (B2, B3) and of
    the head's flow warp (on the same CUDA tensors): the wrappers and their
    autograd Functions stay, the routes inside them are swapped."""
    from unittest import mock

    from mfcnet_tpu_torch.models import mfcnet
    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp

    stack = _plain_backward_kernels()
    stack.enter_context(mock.patch.object(co, "_correlation_forward",
                                          co.correlation_plain))
    stack.enter_context(mock.patch.object(warp, "_backward_warp_forward",
                                          warp.backward_warp_plain))
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


def _check_rows(rows, n, hw=(H, W), detect=True, warmup=T - 1):
    """An N x 12 CSV of ``n`` frames: ``warmup`` NaN rows, keypoints inside
    the frame, and (``detect``) at least one detection."""
    H, W = hw
    if rows.shape != (n, 12):
        raise AssertionError(f"CSV shape {rows.shape} != {(n, 12)}")
    if not np.isnan(rows[:warmup]).all():
        raise AssertionError("warmup rows must be NaN")
    vals = rows[~np.isnan(rows)]
    if detect and vals.size == 0:
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


def _probs(engine, logits):
    """float32 probabilities of an engine's logits: (H, W, C) for one
    stream, (B, H, W, C) for B."""
    import torch

    probs = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
    return probs if engine.num_streams > 1 else probs[0]


def _keep_probs(engine):
    """Make ``engine`` keep the float32 probabilities of its newest window
    (``_probs``) as ``engine.kept_probs``, beside what it returns."""

    def outputs(logits):
        engine.kept_probs = _probs(engine, logits)
        return type(engine)._outputs(engine, logits)

    engine._outputs = outputs


def _launch_modules():
    from mfcnet_tpu_torch.experimental import conv3x3, stage1
    from mfcnet_tpu_torch.ops import (
        cc,
        correlation,
        graph_cond,
        raft_update,
        warp,
    )

    return (cc, raft_update, warp, correlation, conv3x3, stage1, graph_cond)


def _reset_all_launches():
    from mfcnet_tpu_torch.ops import graph_cond

    graph_cond.drain()  # a captured step's launches before the reset
    for mod in _launch_modules():
        mod.reset_launches()


def _all_launches():
    """Launch count of every kernel in ``KERNELS``, by name (B1,
    ``flow_warp_bwd``: its two entry points together)."""
    counts = {}
    for mod in _launch_modules():
        counts.update(mod.LAUNCHES)
    counts["flow_warp_bwd"] = (counts["flow_warp_bwd_maps"]
                               + counts["flow_warp_bwd_flow"])
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
    that swaps them in), window by window over the first frames (one
    frame, or a (B, H, W, 3) stack a step for B streams), on the
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
            p_zero = _probs(plain_engine, plain_engine.model.fuse_nchw(
                plain_engine.seg_buf, optflow=torch.zeros_like(f_want),
                depth=plain_engine.depth_buf))
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


def _parity_incremental_full(what, engines, frames, depth=None, n=8):
    """f32 parity mode: the incremental and the full engine step by step
    over ``n`` frames; returns (max |heat diff|, worst class-mask
    mismatch, windows compared)."""
    heat, mism, compared = 0.0, 0.0, 0
    for i in range(n):
        d = None if depth is None else depth[i]
        outs = {m: e.step_async(frames[i], d) for m, e in engines.items()}
        if outs["full"] is None:
            continue
        heat = max(heat, (outs["incremental"][-1].float()
                          - outs["full"][-1].float()).abs().max().item())
        mism = max(mism, (outs["incremental"][0] != outs["full"][0]
                          ).float().mean().item())
        compared += 1
    log(f"{what}, f32 parity mode, incremental vs full: {compared} windows, "
        f"max |heat diff| {heat:.4g}, class-mask mismatch {mism:.4%}")
    # the feature ring reorders no arithmetic, but cuDNN sees the earlier
    # frames' encoder at batch 1 (ring) or batch 2 (window): float32 sums in
    # another order, at most a float16 heat step or two; the argmax of
    # nearly tied probabilities may flip on it (reported)
    if heat > 1e-3 or mism > 0.01:
        raise AssertionError(f"{what}: f32 incremental != full")
    return heat, mism, compared


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
    from mfcnet_tpu_torch.ops import raft_update as ru

    log(f"raft_update on the flow path: {json.dumps(ru.COUNTS)}")
    if launches["raft_update"] != FLOW_ITERS * fused \
            or launches["flow_warp"] != fused:
        raise AssertionError(
            f"expected {FLOW_ITERS} update steps and 1 warp per fused frame "
            f"({fused} frames), got {launches}")
    # every step on wgmma + TMA, and [net | inp] written once per solve
    if ru.COUNTS["wgmma"] != FLOW_ITERS * fused \
            or ru.COUNTS["hx_fills"] != fused:
        raise AssertionError(
            f"expected {FLOW_ITERS} wgmma steps and 1 fill of hx per fused "
            f"frame ({fused} frames), got {ru.COUNTS}")

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
        _parity_incremental_full("flow path", engines, frames)
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
        log(f"flow path, f32 parity mode, incremental vs full, 12-frame "
            f"rows: NaN pattern equal {bool(same_nan.all())}, max |row diff| "
            f"{row_diff:.4g} px")

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


def phase_large_slice(frames):
    """TernausNetMulti-Large at full width: no warp, the T class maps, the
    T-1 raw RAFT flows and the T depth maps into a 22-channel head, bf16,
    RAFT x12 with the fused update step, depth, device decode. Returns
    (engine, depth frames, launches of the main-path run, fused frames)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Large", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, generator=gen)
    flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
    n_params = sum(p.numel() for p in model.parameters())
    in_ch = model.multiframe_net.multiframe_net[0].in_channels
    log(f"Large path: TernausNetMulti-Large full width (VGG16 encoder, "
        f"num_filters=64), {n_params} parameters, head input {in_ch} "
        f"channels ({T} x {C} class maps, {T - 1} x 2 raw flows, {T} depth "
        f"maps), + frozen RAFT x{FLOW_ITERS} (fused update step), T={T} "
        f"{H}x{W} bf16, device decode, seed {SEED}")
    if in_ch != T * C + 2 * (T - 1) + T:
        raise AssertionError(f"Large head: {in_ch} input channels")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True,
                        add_depth_inputs=True)
    engine = InferenceEngine(model, cfg, flow_model=flow_model)
    n = LARGE_FRAMES
    fused = n - (T - 1)
    depth = _depth_frames(frames[:n])
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        _, fps = track_on_frames(frames[:n], None, cfg, d, name="large",
                                 depth_frames=depth, engine=engine)
        launches = _all_launches()
        csv = np.loadtxt(Path(d) / "large_tracked.csv", delimiter=",")
    _check_rows(csv, n)
    log(f"Large path, incremental: {n} frames -> CSV {csv.shape} (first "
        f"run, includes warm-up: {fps:.2f} frames/s)")
    log(f"kernel launches on the Large path: {json.dumps(launches)}")
    _require_launches("large", launches)
    if launches["flow_warp"] != 0:
        raise AssertionError("the Large head warps nothing: flow_warp was "
                             f"launched {launches['flow_warp']} times")
    if launches["raft_update"] != FLOW_ITERS * fused \
            or ru.COUNTS["hx_fills"] != fused:
        raise AssertionError(
            f"expected {FLOW_ITERS} update steps and 1 fill of hx per fused "
            f"frame ({fused} frames), got {launches}, {ru.COUNTS}")
    with tempfile.TemporaryDirectory() as d:
        track_on_frames(frames[:6], model,
                        dataclasses.replace(cfg, mode="full"), d,
                        name="full", depth_frames=depth[:6],
                        flow_model=flow_model, device="cuda")
        _check_rows(np.loadtxt(Path(d) / "full_tracked.csv", delimiter=","),
                    6)
    log("Large path, full mode: 6 frames -> CSV (6, 12)")

    _compare_with_plain_kernels(
        "Large", engine, InferenceEngine(model, cfg, flow_model=flow_model),
        frames, _plain_flow_kernels,
        lambda e: out.flow_from_feature_ring(*e.flow_state, (H, W),
                                             e.flow_model),
        prob_tol=LARGE_PROB_TOL)
    with parity_mode():
        c32 = dataclasses.replace(cfg, dtype="float32")
        engines = {
            m: InferenceEngine(model, dataclasses.replace(c32, mode=m),
                               flow_model=flow_model, device="cuda")
            for m in ("incremental", "full")
        }
        _parity_incremental_full("Large path", engines, frames, depth)
    torch.cuda.synchronize()
    return engine, depth, launches, fused


def _stream_frames(lengths, seed=SEED):
    """One synthetic stream per length, each from its own seed."""
    return [synthetic_frames(n, seed=seed + b) for b, n in enumerate(lengths)]


def _tip_rmse(a, b):
    """(tip RMSE in px over the tip coordinates both runs detected, rows
    whose detections (NaN pattern) differ) of two N x 12 row arrays."""
    ta, tb = a[:, :8], b[:, :8]
    both = np.isfinite(ta) & np.isfinite(tb)
    rmse = (float(np.sqrt(np.mean((ta[both] - tb[both]) ** 2)))
            if both.any() else 0.0)
    return rmse, int((np.isnan(a) != np.isnan(b)).any(axis=1).sum())


def phase_streams_slice():
    """The multi-stream tracker at full width: TernausNetMulti-Basic with
    RAFT x12 (fused update step), bf16, device decode, num_streams=4, four
    synthetic streams of STREAM_LENGTHS frames from seeds 0..3 through
    ``track_on_frame_streams``. Returns (engine, launches of the main-path
    run, lockstep fused steps)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frame_streams,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    B = len(STREAM_LENGTHS)
    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, generator=gen)
    flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
    streams = _stream_frames(STREAM_LENGTHS)
    log(f"streams path: TernausNetMulti-Basic + frozen RAFT x{FLOW_ITERS}, "
        f"num_streams={B}, streams of {list(STREAM_LENGTHS)} frames (seeds "
        f"{SEED}..{SEED + B - 1}), {H}x{W} bf16, device decode")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    engine = InferenceEngine(model, cfg, flow_model=flow_model,
                             num_streams=B)
    steps = max(STREAM_LENGTHS) - (T - 1)
    names = [f"s{b}" for b in range(B)]
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        dd.reset_tier_counts()
        rows, fps = track_on_frame_streams(streams, None, cfg, d,
                                           names=names, engine=engine)
        launches = _all_launches()
        tiers = dict(dd.TIER_COUNTS)
        csvs = [np.loadtxt(Path(d) / f"{n}_tracked.csv", delimiter=",")
                for n in names]
    for csv, n in zip(csvs, STREAM_LENGTHS):
        if csv.shape != (n, 12) or not np.isnan(csv[:T - 1]).all():
            raise AssertionError(f"stream CSV {csv.shape}, {n} frames")
    if not any(np.isfinite(c).any() for c in csvs):
        raise AssertionError("no keypoint detected in any stream")
    log(f"streams path: {B} CSVs {[c.shape for c in csvs]} (first run, "
        f"includes warm-up: {fps:.2f} frames/s in all)")
    log(f"kernel launches on the streams path: {json.dumps(launches)}; "
        f"decode calls per tier (one a step): {json.dumps(tiers)}")
    _require_launches("streams", launches)
    # one solve, one warp and one decode a lockstep step, whatever B
    if launches["raft_update"] != FLOW_ITERS * steps \
            or launches["flow_warp"] != steps or sum(tiers.values()) != steps:
        raise AssertionError(
            f"expected {FLOW_ITERS} update steps, 1 warp and 1 decode per "
            f"lockstep step ({steps} steps), got {launches}, {tiers}")

    # the kernels at the batched shapes against their plain versions: the
    # flow path's two inside the engine, the decode's on its (B, ...) maps
    def window_flow(e):
        return out.flow_from_feature_ring(*e.flow_state, (H, W),
                                          e.flow_model)

    n_cmp = min(STREAM_LENGTHS)
    stacked = [np.stack([s[i] for s in streams]) for i in range(n_cmp)]
    _compare_with_plain_kernels(
        f"{B}-stream RAFT", engine,
        InferenceEngine(model, cfg, flow_model=flow_model, num_streams=B),
        stacked, _plain_flow_kernels, window_flow)
    _keep_probs(engine)
    engine.reset()
    for f in stacked[:6]:
        engine.step_async(f)
    probs = engine.kept_probs
    del engine._outputs, engine.kept_probs
    got = dd.decode_keypoints_device(probs, 100)
    with _plain_kernels():
        want = dd.decode_keypoints_device(probs, 100)
    _equal(f"decode rows of {B} streams", got, want)
    log(f"decode of {B} streams' windows through the kernels == through "
        f"the plain versions, one call")

    # f32 parity mode: each stream against a single-stream engine on the
    # same frames: heats within 1e-3, tip RMSE within 0.5 px (BASELINE.json)
    with parity_mode():
        c32 = dataclasses.replace(cfg, dtype="float32")
        multi = InferenceEngine(model, c32, flow_model=flow_model,
                                device="cuda", num_streams=B)
        singles = [InferenceEngine(model, c32, flow_model=flow_model,
                                   device="cuda") for _ in range(B)]
        heat = 0.0
        for f in stacked[:8]:
            got = multi.step_async(f)
            refs = [e.step_async(f[b]) for b, e in enumerate(singles)]
            if got is not None:
                ref = torch.stack([r[2] for r in refs])
                heat = max(heat, (got[2].float() - ref.float()
                                  ).abs().max().item())
        with tempfile.TemporaryDirectory() as d:
            multi_rows, _ = track_on_frame_streams(
                streams, None, c32, d, names=names, engine=multi)
            single_rows = [track_on_frames(s, None, c32, d, name=f"r{b}",
                                           engine=e)[0]
                           for b, (s, e) in enumerate(zip(streams, singles))]
        equal = sum(int(np.array_equal(x, y, equal_nan=True))
                    for a, b_ in zip(multi_rows, single_rows)
                    for x, y in zip(a, b_))
        stats = [_tip_rmse(a, b_) for a, b_ in zip(multi_rows, single_rows)]
    log(f"streams path, f32 parity mode, {B} streams against single-stream "
        f"runs: max |heat diff| {heat:.4g} (limit 1e-3); tip RMSE per stream "
        f"{[round(r, 6) for r, _ in stats]} px (limit 0.5), rows whose "
        f"detections differ {[m for _, m in stats]}; rows byte-equal: "
        f"{equal} of {sum(STREAM_LENGTHS)}")
    if heat > 1e-3 or max(r for r, _ in stats) > 0.5:
        raise AssertionError("streams path: a stream departs from its "
                             "single-stream run")
    torch.cuda.synchronize()
    return engine, launches, steps


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
    if (launches["correlation"] != fused
            or launches["backward_warp"] != 2 * fused
            or launches["flow_warp"] != fused or launches["raft_update"]
            or launches["warp_abs"]):
        raise AssertionError(
            f"expected 1 correlation, 2 backward_warp and 1 flow_warp launch "
            f"per fused frame ({fused} frames) and no raft_update or "
            f"warp_abs, got {launches}")
    _check_unflow_warp_is_one_kernel(engine)
    # the correlation on the provider's own conv3 features: the random He
    # model on the first window's two frame pairs (the provider halves the
    # 512x640 frames), as the bf16 engine passes them (float32)
    window = np.stack(frames[2::-1])  # newest first
    with torch.no_grad():
        f1, f2, kw = _provider_correlation_inputs(
            engine.flow_model, lambda: out.flow_for_window(
                engine._normalize(window)[None], engine.flow_model))
    r = _hold_correlation(f1, f2, kw["max_displacement"], kw["stride"],
                          "UnFlow provider's conv3 features")
    log(f"correlation on the UnFlow provider's own conv3 features "
        f"({tuple(f1.shape)} {f1.dtype}, strides {f1.stride()}, max |f| "
        f"{max(f1.abs().max().item(), f2.abs().max().item()):.4g}): route "
        f"{_corr_route(f1, kw)}, {_corr_readings(r)} (atol, rtol "
        f"{CORR_TOL}); one launch, one device operation")

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
        # the type decision (models/unflow.py): a bf16 provider rounds its
        # weights to bf16 and computes in float32, as the JAX package does.
        # Held against the float32 provider on the same window: the two
        # differ by the weights' and the frames' bf16 rounding, through ~75
        # layers
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


def _check_unflow_warp_is_one_kernel(engine):
    """UnFlow's forward must launch one device kernel per backward warp: no
    layout copy, no elementwise kernel for the coordinates. The tensors the
    provider hands the warp are recorded in one provider call, and a call
    on tensors of those strides and types is counted by the profiler."""
    import torch

    from mfcnet_tpu_torch.models import unflow
    from mfcnet_tpu_torch.track import outputs as out

    seen = []
    inner = unflow.warp_by_flow

    def recording(img, flow, **kw):
        seen.append((img, flow))
        return inner(img, flow, **kw)

    unflow.warp_by_flow = recording
    try:
        with torch.no_grad():
            out.flow_for_window(engine.flow_state, engine.flow_model)
    finally:
        unflow.warp_by_flow = inner
    if len(seen) != 2:
        raise AssertionError(f"UnFlow: {len(seen)} backward warps per call")
    for img, flow in seen:
        names = _count_device_kernels(
            lambda: unflow.backward_warp(img, flow))
        log(f"UnFlow's backward warp on a {tuple(img.shape)} {img.dtype} "
            f"frame (strides {img.stride()}) and a {flow.dtype} flow "
            f"(strides {flow.stride()}): device kernels per call: {names}")
        if len(names) != 1 or "backward_warp_kernel" not in names[0]:
            raise AssertionError(
                f"UnFlow's backward warp must be one kernel, got {names}")


def phase_ffpp_slice(frames):
    """The FlowFormer++ path at full width: TernausNetMulti-Basic with
    add_optflow_inputs at 480x640, bf16, incremental, device decode, the
    frozen FFPP provider at its default widths (12 iterations) on the
    half-resolution frames (2 pairs of 30x40 tokens a frame), a
    split-encoder provider: the engine's ring holds its features and the
    newest frame's context features. No hand kernel in the provider; the
    head's warp and the decode's kernels. Returns (engine, launches of the
    main-path run, number of fused frames)."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        init_ffpp_weights,
    )
    from mfcnet_tpu_torch.ops.resize import resize_nearest
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
    flow_model = init_ffpp_weights(FlowFormerPP(iters=FLOW_ITERS), gen,
                                   flow_gain=FFPP_FLOW_GAIN)
    n_flow = sum(p.numel() for p in flow_model.parameters())
    log(f"FFPP path: TernausNetMulti-Basic + frozen FlowFormer++ (default "
        f"'things' widths, {n_flow} parameters, iters={FLOW_ITERS}, flow "
        f"head x{FFPP_FLOW_GAIN}), T={T} {H}x{W} bf16, seed {SEED}")
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    # no device argument: the entry points run on the card by default
    engine = InferenceEngine(model, cfg, flow_model=flow_model)
    fm = engine.flow_model
    if engine.device.type != "cuda" or not engine.flow_split:
        raise AssertionError("the engine must default to the card and keep "
                             "a feature ring for FFPP")
    if (fm.compute_dtype != torch.bfloat16
            or fm.memory_decoder.update_block.gru.convz1.weight.dtype
            != torch.float32):
        raise AssertionError("a bf16 FFPP keeps float32 where JAX does")
    n = FFPP_FRAMES
    fused = n - (T - 1)
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        _, fps = track_on_frames(frames[:n], None, cfg, d, name="ffpp",
                                 engine=engine)
        launches = _all_launches()
        csv = np.loadtxt(Path(d) / "ffpp_tracked.csv", delimiter=",")
    _check_rows(csv, n)
    feat, ctx, ph = engine.flow_state
    log(f"FFPP path, incremental: {n} frames -> CSV {csv.shape} (first run, "
        f"includes warm-up: {fps:.2f} frames/s); ring: features "
        f"{tuple(feat.shape)} {feat.dtype}, context {tuple(ctx.shape)}, "
        f"placeholder {tuple(ph.shape)}")
    log(f"kernel launches on the FFPP path: {json.dumps(launches)}")
    _require_launches("ffpp", launches)
    others = [k for k in ("raft_update", "correlation", "backward_warp",
                          "warp_abs", "flow_warp_bwd") if launches[k]]
    if launches["flow_warp"] != fused or others:
        raise AssertionError(
            f"expected 1 flow_warp per fused frame ({fused} frames) and no "
            f"other flow kernel, got {launches}")

    with tempfile.TemporaryDirectory() as d:
        track_on_frames(frames[:6], model,
                        dataclasses.replace(cfg, mode="full"), d, name="full",
                        flow_model=flow_model, device="cuda")
        _check_rows(np.loadtxt(Path(d) / "full_tracked.csv", delimiter=","),
                    6)
    log("FFPP path, full mode: 6 frames -> CSV (6, 12)")

    _compare_with_plain_kernels(
        "FFPP", engine, InferenceEngine(model, cfg, flow_model=flow_model),
        frames, _plain_flow_kernels,
        lambda e: out.flow_from_feature_ring(*e.flow_state, (H, W),
                                             e.flow_model),
        prob_tol=FFPP_PROB_TOL)

    window = torch.from_numpy(np.stack(frames[2::-1]))  # newest first
    with parity_mode():
        c32 = dataclasses.replace(cfg, dtype="float32")
        engines = {
            m: InferenceEngine(model, dataclasses.replace(c32, mode=m),
                               flow_model=flow_model, device="cuda")
            for m in ("incremental", "full")
        }
        _parity_incremental_full("FFPP path", engines, frames)
        # the f32 provider on the card (TF32 off) against the same model on
        # the CPU at the engine's shape: the window's 2 pairs at 240x320
        x = engines["full"]._normalize(window)
        half = resize_nearest(x, H // 2, W // 2).permute(0, 2, 3, 1)
        a, b = half[:1].expand(T - 1, -1, -1, -1), half[1:]
        with torch.no_grad():
            got = engines["full"].flow_model(a, b).cpu()
            t0 = time.perf_counter()
            want = copy.deepcopy(flow_model).float().eval()(
                a.cpu().float(), b.cpu().float())
            cpu_s = time.perf_counter() - t0
            b16 = engine.flow_model(a.to(torch.bfloat16), b.to(torch.bfloat16))
    err = (got - want).abs()
    excess = (err - FFPP_F32_TOL[1] * want.abs()).max().item()
    d16 = (b16.cpu() - want).abs()
    log(f"FFPP f32 provider on the card (TF32 off) vs the CPU, {T - 1} pairs "
        f"at {H // 2}x{W // 2}, {FLOW_ITERS} iterations: max |flow| "
        f"{want.abs().max().item():.4g} px (mean {want.abs().mean().item():.4g}"
        f"), max |diff| {err.max().item():.4g} px, largest excess over "
        f"rtol {FFPP_F32_TOL[1]:g}: {excess:.4g} px (atol {FFPP_F32_TOL[0]:g};"
        f" CPU forward {cpu_s:.1f} s); the bf16 provider vs the CPU's f32: "
        f"max |diff| {d16.max().item():.4g} px, mean {d16.mean().item():.4g}")
    if excess > FFPP_F32_TOL[0] or not want.abs().max().item() > 0.5:
        raise AssertionError("FFPP: the card's f32 provider differs from the "
                             "CPU's")
    torch.cuda.synchronize()
    return engine, launches, fused


def phase_ffpp_timings(engine, frames, smi):
    """The FFPP path's tracker frames/s at 1 and 4 streams, the provider's
    ms and share of the step, and the decode's ms/frame on its windows."""
    import torch

    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    n = FFPP_FRAMES
    with tempfile.TemporaryDirectory() as d:
        _, fps = track_on_frames(frames[:n], None, engine.cfg, d, name="warm",
                                 engine=engine)
    log(f"[{smi}] tracker, FFPP path (x{FLOW_ITERS}, warp), incremental bf16 "
        f"device decode, warm, {n} host frames: {fps:.2f} frames/s")
    fm = engine.flow_model
    x = engine._normalize(frames[n - 1][None])

    def flow_part():
        with torch.no_grad():
            f_new, c, p = out.flow_ingest(x, fm)
            return out.flow_from_feature_ring(
                torch.cat([f_new[:, None], engine.flow_state[0][:, :T - 1]],
                          1), c, p, (H, W), fm)

    it = iter(range(10 ** 9))
    for run in range(3):
        step_ms = _host_ms(lambda: engine.step_async(frames[next(it) % n]),
                           16)
        flow_ms = _host_ms(flow_part, 16)
        log(f"[{smi}] FFPP path step {step_ms:.3f} ms/frame (synchronized), "
            f"of which the flow provider {flow_ms:.3f} ms = "
            f"{flow_ms / step_ms:.1%} of the frame (run {run + 1} of 3)")
    flow_dev = _event_ms(flow_part, 10)
    _, events, whole, wall = _profiled(flow_part)
    busy = sum(us for _, us in events) / 1e3
    top = {}
    for name, us in events:
        short = re.sub(r"<.*", "", name.replace("void ", ""))[:60]
        top[short] = top.get(short, 0.0) + us / 1e3
    log(f"[{smi}] FFPP provider a frame: {flow_dev:.3f} ms between CUDA "
        f"events; one profiled call: {len(events)} device operations, busy "
        f"{busy:.2f} ms of {wall:.2f} ms wall (idle share "
        f"{1 - busy / wall:.1%}, under the profiler{'' if whole else '; trace not whole'}); "
        f"largest: " + json.dumps({k: round(v, 3) for k, v in sorted(
            top.items(), key=lambda kv: -kv[1])[:6]}))
    _keep_probs(engine)
    engine.step_async(frames[n - 1])
    probs = engine.kept_probs
    del engine._outputs, engine.kept_probs
    dec = _host_ms(lambda: dd.decode_keypoints_device(probs, 100), 10)
    log(f"[{smi}] decode ms/frame on the FFPP engine's window: {dec:.3f}")
    streams = _stream_frames([TIMED_STREAM_FRAMES] * 4, seed=SEED + 10)
    by_b = _fps_by_streams("FFPP path", engine.model, engine.cfg, fm,
                           streams, smi, bs=(1, 4))
    log(json.dumps({"ffpp_frames_per_s_by_streams": by_b,
                    "ffpp_provider_share_of_step": flow_ms / step_ms}))


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
        if name == "UnFlow":  # the correlation on the CLI's own features
            f1, f2, kw = _provider_correlation_inputs(
                model, lambda: flow_pairs(model, prevs, currs))
            r = _hold_correlation(f1, f2, kw["max_displacement"],
                                  kw["stride"], "offline UnFlow features")
            log(f"correlation on the offline UnFlow's own conv3 features "
                f"({tuple(f1.shape)} {f1.dtype}, max |f| "
                f"{max(f1.abs().max().item(), f2.abs().max().item()):.4g}): "
                f"route {_corr_route(f1, kw)}, {_corr_readings(r)} (atol, "
                f"rtol {CORR_TOL})")
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
                                 or launches["backward_warp"] != 2):
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

    # the cc.cu kernels on the random model's class maps (the per-blob and
    # exact tiers' frames), and their device operations a call
    model_maps = {f"model window {i}": decode_inputs(p.argmax(-1))
                  for i, p in zip((15, 23, 33), model_probs)}
    for what, (mu, _) in model_maps.items():
        check_cc_kernels(mu, what)
    m4 = class_masks(u)
    inputs = {"clean 480x640 map": decode_calls(u, m4),
              "model window 15": decode_calls(*model_maps["model window 15"])}
    ops = {}
    for what, calls in inputs.items():
        for call, (kern, _, _) in calls.items():
            names = _count_device_kernels(kern)
            ops[call, what] = len(names)
            log(f"[{smi}] {call} on the {what}: {len(names)} device "
                f"operations a call: {names}")
    # one launch a call; the union wrapper adds its `conflict != 0`
    for (call, what), n in ops.items():
        if n > (2 if call == "union_flood_cc_cid" else 1):
            raise AssertionError(f"{call} on the {what}: {n} device "
                                 f"operations a call, more than its launch "
                                 f"and the wrapper's: {ops}")

    # each kernel against its plain version at the main path's shapes, on
    # the clean map: the first call of each kernel is the one its row of
    # the kernels line reports, the others stand beside it under
    # "kernel@call". Bounds: each input read once and each output written
    # once over the card's memory rate; the labelling's integer work
    # depends on the data and has no rate in the table, so bytes set the
    # bound. The library yardstick of onehot_stats: index_add_ of the six
    # prepared planes into (B*K, 6) int64 (the accumulation only).
    calls = inputs["clean 480x640 map"]
    timed = {"connected_components": "cc_labels filled 8-conn",
             "connected_components@background 4-conn":
                 "cc_labels background 4-conn",
             "flood_cc_cid": "flood_cc_cid",
             "union_flood_cc_cid": "union_flood_cc_cid",
             "onehot_stats": "onehot_stats union tier",
             "onehot_stats@per-blob tier": "onehot_stats per-blob tier"}
    times, bounds, library = {}, {}, {}
    for name, call in timed.items():
        kern, plain, ins = calls[call]
        eager = _event_ms(kern, 50)
        times[name] = _in_turns(
            name, kern, plain, smi, f"{call}, clean 480x640 map; device time "
            f"in CUDA-graph replays (eager calls {eager:.4f} ms), plain: eager",
            kreps=20, preps=3, timer=_graph_ms, ptimer=_event_ms)
        nbytes = _nbytes(*ins, *kern())
        bounds[name] = (nbytes / PEAK_BYTES * 1e3, "bytes")
        log(f"[{smi}] {name}: bound {bounds[name][0]:.5f} ms (bytes: "
            f"{nbytes} B at {PEAK_BYTES / 1e12} TB/s)")
        if name.startswith("onehot_stats"):
            idx, vals = stats_rows(*ins)
            acc = torch.zeros(ins[0].shape[0] * K, 6, dtype=torch.int64,
                              device="cuda")
            library[name] = _graph_ms(lambda: (acc.index_add_(0, idx, vals),))
            log(f"[{smi}] {name}: library index_add_ of {idx.numel()} "
                f"prepared rows of 6 int64 into ({acc.shape[0]}, 6), the "
                f"accumulation only: {library[name]:.4f} ms in graph replays")
    for what, calls in inputs.items():
        for call, (kern, _, _) in calls.items():
            if not _replay_equals(kern):
                raise AssertionError(f"{call} on the {what}: a CUDA-graph "
                                     f"replay differs from the eager call")
            log(f"[{smi}] {call} on the {what}: {_graph_ms(kern):.4f} ms in "
                f"graph replays (== the eager call's outputs), "
                f"{_event_ms(kern, 50):.4f} ms eager, {ops[call, what]} "
                f"device operations a call")
    return out, times, bounds, library


def decode_inputs(pred):
    """The decode's inputs of the two flood kernels for a (H, W) class map:
    the union class image (1, H, W) int8 and the four class masks (4, H, W)
    bool (``track/decode_device.py``)."""
    import torch

    ucls = torch.zeros_like(pred, dtype=torch.int8)
    for src, dst in ((3, 1), (1, 2), (4, 3), (2, 4)):
        ucls[pred == src] = dst
    return ucls[None].contiguous(), class_masks(ucls[None])


def decode_calls(u, m4):
    """{call: (kernel, plain, inputs)} of the decode's ``cc.cu`` calls on
    the union class image ``u`` (1, H, W) and its four class masks ``m4``
    (``track/decode_device.py``): ``union_flood_cc_cid`` (union tier),
    ``flood_cc_cid`` (per-blob tier), ``connected_components`` 4-connected
    on the masks' background (``fill_holes``) and 8-connected on the
    hole-filled masks (exact tier), ``onehot_stats`` on the union tier's
    and on the per-blob tier's outputs. Each function returns a tuple of
    tensors; ``inputs`` are the tensors the call reads."""
    from mfcnet_tpu_torch.ops import cc

    cid, he, cide = cc.union_flood_cc_cid(u, K)[:3]
    fcid, filled = cc.flood_cc_cid(m4, K)[:2]
    bg, fm, fhe = (~m4).contiguous(), filled.bool(), filled * 8
    return {
        "union_flood_cc_cid": (lambda: cc.union_flood_cc_cid(u, K),
                               lambda: cc.union_flood_cc_cid_plain(u, K),
                               (u,)),
        "flood_cc_cid": (lambda: cc.flood_cc_cid(m4, K),
                         lambda: cc.flood_cc_cid_plain(m4, K), (m4,)),
        "cc_labels background 4-conn": (
            lambda: (cc.connected_components(bg, 4),),
            lambda: (cc.connected_components_plain(bg, 4),), (bg,)),
        "cc_labels filled 8-conn": (
            lambda: (cc.connected_components(fm, 8),),
            lambda: (cc.connected_components_plain(fm, 8),), (fm,)),
        "onehot_stats union tier": (
            lambda: cc.onehot_stats(cid, he, cide, K),
            lambda: cc.onehot_stats_plain(cid, he, cide, K),
            (cid, he, cide)),
        "onehot_stats per-blob tier": (
            lambda: cc.onehot_stats(fcid, fhe, None, K),
            lambda: cc.onehot_stats_plain(fcid, fhe, None, K),
            (fcid, fhe)),
    }


def stats_rows(cid, he, cide=None):
    """(slot index b*K + id (N,) int64, values (N, 6) int64): the rows
    whose per-slot sums ``onehot_stats`` computes (``onehot_stats_plain``'s
    prepared planes), for the library yardstick ``index_add_``."""
    import torch
    import torch.nn.functional as F

    B, h_, w_ = cid.shape
    dev = cid.device
    h, e = he >> 3, he & 7
    hp = F.pad(h, (1, 1, 1, 1), value=-1)
    ep = F.pad(e, (1, 1, 1, 1), value=-1)
    inside = h > 0
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        hq = hp[:, 1 + dy:1 + dy + h_, 1 + dx:1 + dx + w_]
        eq = ep[:, 1 + dy:1 + dy + h_, 1 + dx:1 + dx + w_]
        inside &= (hq == h) | ((h <= 4) & (hq > 4) & (eq == h))
    y = torch.arange(h_, device=dev).view(1, h_, 1).expand(B, h_, w_)
    x = torch.arange(w_, device=dev).view(1, 1, w_).expand(B, h_, w_)
    one = torch.ones_like(y)
    base = (torch.arange(B, device=dev) * K).view(B, 1, 1)
    w2 = torch.where(inside, 2, 1)
    own = (cid >= 0) & (h > 0)
    idx = [(cid + base)[own]]
    vals = [torch.stack([one, (~inside).long(), w2, w2 * x, w2 * y,
                         torch.where(h > 4, h - 4, h).long()], -1)[own]]
    if cide is not None:
        cont = (h > 4) & (cide >= 0)
        idx.append((cide + base)[cont])
        vals.append(torch.stack([one, 0 * one, 2 * one, 2 * x, 2 * y,
                                 e.long()], -1)[cont])
    return torch.cat(idx).long(), torch.cat(vals)


def _replay_equals(fn):
    """Whether a CUDA-graph replay of ``fn`` gives the outputs of an eager
    call on the same inputs."""
    import torch

    want = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for t in got:
        t.fill_(-7)
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, want))


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
              timer=_event_ms, ptimer=None):
    """ms per call, in turns (plain, kernel, kernel, plain); the better of
    each pair. ``ptimer``: the plain version's timer where it differs."""
    ptimer = ptimer or timer
    p1 = ptimer(plain, preps)
    k1 = timer(kern, kreps)
    k2 = timer(kern, kreps)
    p2 = ptimer(plain, preps)
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
    for run in range(3):  # host-bound numbers: several runs, all printed
        step_ms = _host_ms(lambda: engine.step_async(frames[next(it) % n]),
                           16)
        flow_ms = _host_ms(flow_part, 16)
        log(f"[{smi}] flow path step {step_ms:.3f} ms/frame (synchronized), "
            f"of which the flow provider {flow_ms:.3f} ms = "
            f"{flow_ms / step_ms:.1%} of the frame (run {run + 1} of 3)")

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
        ws = ru.UpdateWorkspace(B, H8, W8, packed, "cuda")
        state = [net]

        def fused_step():  # as the solve calls it: one workspace, state fed back
            state[0], _ = ru.fused_update_step(ub, packed, corr, inp, state[0],
                                               flow, H8, W8, ws)

        step_fused_ms = _event_ms(fused_step, 20)
        lookup_host = _host_ms(lambda: pyramid.lookup(coords), 20)
    log(f"[{smi}] one RAFT iteration at {B}x{H8}x{W8} tokens: lookup "
        f"{lookup_ms:.4f} ms device ({lookup_host:.4f} ms host-visible), "
        f"fused update step (convcorr1 + convflow1 + kernel) "
        f"{step_fused_ms:.4f} ms")

    times, bounds, library = {}, {}, {}
    macs = sum(
        packed[f"w_{k}"].shape[0] * packed[f"w_{k}"].shape[1] * cols
        for k, cols in (("c2", 192), ("f2", 64), ("cv", 126), ("zr_h", 256),
                        ("q_h", 128), ("zr_v", 256), ("q_v", 128),
                        ("fl1", 256), ("fl2", 2)))

    def in_solve(sargs):
        """One update step as the solve runs it: through a workspace, the
        state fed back, hx already filled."""
        sc1, sf1, sinp, snet, sflow, spacked, sh, sw = sargs
        ws = ru.UpdateWorkspace(sc1.shape[0], sh, sw, spacked, "cuda")
        state = [snet]

        def step():
            state[0], delta = ru.raft_update(sc1, sf1, sinp, state[0], sflow,
                                             spacked, sh, sw, ws)
            return state[0], delta

        return step

    def bound_of(sargs, outs):
        """(ms, by what): each input and weight read once, each output
        written once over the memory rate, against the multiply-adds over
        the bf16 tensor-core peak."""
        tok = sargs[0].shape[0] * sargs[0].shape[1]
        b_ops = 2 * macs * tok / PEAK_BF16 * 1e3
        b_bytes = _nbytes(*sargs[:5], *(sargs[5][k] for k in ru._WEIGHT_NAMES),
                          *outs) / PEAK_BYTES * 1e3
        return (max(b_ops, b_bytes),
                "operations" if b_ops >= b_bytes else "bytes", b_ops, b_bytes)

    def library_args(sargs, scorr):
        sc1, _, sinp, snet, sflow = sargs[:5]
        sb, sh, sw = sc1.shape[0], sargs[6], sargs[7]

        def cl(t, ch):
            return t.view(sb, sh, sw, ch).permute(0, 3, 1, 2)

        return (cl(snet.bfloat16(), 128), cl(sinp, 128),
                cl(scorr, scorr.shape[-1]), cl(sflow.bfloat16(), 2))

    # the kernel's device time is that of CUDA-graph replays of the step in
    # a solve (its eight launches are chained on the device; called eagerly
    # the wrapper's host time shows instead, printed beside it)
    step = in_solve(args)
    eager = _event_ms(step, 50)
    times["raft_update"] = _in_turns(
        "raft_update", step, lambda: ru.raft_update_plain(*args), smi,
        f"bf16, {B}x{H8}x{W8} tokens, through a solve's workspace; kernel: "
        f"device time in CUDA-graph replays (eager wrapper calls {eager:.4f} "
        f"ms), plain: eager", kreps=20, preps=3, timer=_graph_ms,
        ptimer=_event_ms)
    bound = bound_of(args, step())
    bounds["raft_update"] = bound[:2]
    # library yardstick: the provider's own unfused UpdateBlock (cuDNN,
    # bf16, channels_last, without the mask head; it includes convcorr1 and
    # convflow1, which the kernel leaves outside)
    with torch.no_grad():
        lib_args = library_args(args, corr.bfloat16())
        lib_eager = _event_ms(lambda: ub(*lib_args), 20)
        library["raft_update"] = _graph_ms(lambda: ub(*lib_args), 10, 5)
    log(f"[{smi}] raft_update: {macs} multiply-adds per token x {B * N} "
        f"tokens; bound {bound[0]:.5f} ms ({bound[1]}: operations "
        f"{bound[2]:.5f} ms at 989 TFLOP/s bf16, bytes {bound[3]:.5f} ms); "
        f"unfused UpdateBlock (cuDNN, bf16, channels_last) "
        f"{library['raft_update']:.4f} ms per iteration of device time "
        f"(CUDA-graph replay), {lib_eager:.4f} ms called eagerly "
        f"(host-bound)")

    # the update step against its token count: a near-empty call (the floor
    # of eight dependent launches), the tracker's size, and the frozen
    # provider's size inside a training step (8 pairs at 60x80)
    by_tokens = []
    for sb, sh, sw in ((1, 2, 2), (B, H8, W8), (8, 60, 80)):
        sargs = _raft_update_inputs(ub, torch.bfloat16, sb, sh, sw, gen)
        step = in_solve(sargs)
        e_ms = _event_ms(step, 20)
        k_ms = min(_graph_ms(step, 10, 5), _graph_ms(step, 10, 5))
        sbound = bound_of(sargs, step())
        with torch.no_grad():
            scorr = torch.randn(sb, sh * sw, corr.shape[-1], generator=gen
                                ).cuda().bfloat16()
            l_args = library_args(sargs, scorr)
            l_ms = _graph_ms(lambda: ub(*l_args), 10, 5)
        tok = sb * sh * sw
        plan = ru.tile_plan(sb, sh, sw)
        by_tokens.append({
            "tokens": tok, "ms": k_ms, "eager_ms": e_ms,
            "bound_ms": sbound[0], "bound_by": sbound[1], "library_ms": l_ms,
            "tflops": 2 * macs * tok / k_ms / 1e9, "config": plan.config,
            "clusters": plan.clusters})
        log(f"[{smi}] raft_update at {sb}x{sh}x{sw} = {tok} tokens "
            f"(configuration '{plan.config}'): kernel {k_ms:.4f} ms of device "
            f"time in graph replays ({2 * macs * tok / k_ms / 1e9:.1f} "
            f"TFLOP/s; {e_ms:.4f} ms called eagerly), bound {sbound[0]:.5f} "
            f"ms ({sbound[1]}), unfused UpdateBlock (cuDNN, bf16, graph "
            f"replay) {l_ms:.4f} ms")
    log(json.dumps({"raft_update_by_tokens": by_tokens}))

    # the float32 route (three TF32 products on wgmma; no path launches it:
    # the tracker and the trainer fuse the update step in bf16 only) at the
    # tracker's tokens, in the kernel line's "calls": its bound counts the
    # products as three TF32 passes; library: the float32 UpdateBlock with
    # cuDNN's TF32 off (the same arithmetic as the plain version), and on
    key = f"raft_update@float32 route, {B}x{H8}x{W8} tokens, no path"
    fargs = _raft_update_inputs(ub, torch.float32, B, H8, W8, gen)
    fstep = in_solve(fargs)
    times[key] = _in_turns(
        key, fstep, lambda: ru.raft_update_plain(*fargs), smi,
        "f32, through a solve's workspace; kernel: device time in CUDA-graph "
        "replays, plain: eager", kreps=20, preps=3, timer=_graph_ms,
        ptimer=_event_ms)
    f_ops = 2 * macs * B * N / (PEAK_TF32 / 3) * 1e3
    f_bytes = _nbytes(*fargs[:5], *(fargs[5][k] for k in ru._WEIGHT_NAMES),
                      *fstep()) / PEAK_BYTES * 1e3
    bounds[key] = (max(f_ops, f_bytes),
                   "operations" if f_ops >= f_bytes else "bytes")
    f_lib = {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        with torch.no_grad():
            l_args = library_args(fargs, corr)
            l_args = tuple(t.float() for t in l_args)
            ubf = copy.deepcopy(ub).float()
            for allow in (False, True):
                torch.backends.cudnn.allow_tf32 = allow
                f_lib[allow] = _graph_ms(lambda: ubf(*l_args), 10, 5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    library[key] = f_lib[False]
    f_fma = 2 * macs * B * N / PEAK_F32 * 1e3
    log(f"[{smi}] raft_update float32 route at {B}x{H8}x{W8} tokens: bound "
        f"{bounds[key][0]:.5f} ms ({bounds[key][1]}: operations {f_ops:.5f} "
        f"ms as three TF32 passes at 495 TFLOP/s, {f_fma:.5f} ms at the 67 "
        f"TFLOP/s float32 FMA rate; bytes {f_bytes:.5f} ms); "
        f"float32 UpdateBlock (cuDNN, graph replay) {f_lib[False]:.4f} ms "
        f"with TF32 off, {f_lib[True]:.4f} ms with TF32 on (cuDNN's default)")

    # the update step at the 4-stream engine's solve: its streams' (T-1)
    # pairs each, one launch chain
    sb = len(STREAM_LENGTHS) * B
    key = f"raft_update@{sb * N} tokens"
    sargs = _raft_update_inputs(ub, torch.bfloat16, sb, H8, W8, gen)
    sstep = in_solve(sargs)
    times[key] = _in_turns(
        key, sstep, lambda: ru.raft_update_plain(*sargs), smi,
        f"bf16, {sb}x{H8}x{W8} tokens ({len(STREAM_LENGTHS)} streams' "
        f"solve), through a solve's workspace; kernel: device time in "
        f"CUDA-graph replays, plain: eager", kreps=20, preps=3,
        timer=_graph_ms, ptimer=_event_ms)
    bounds[key] = bound_of(sargs, sstep())[:2]
    with torch.no_grad():
        scorr = torch.randn(sb, N, corr.shape[-1], generator=gen
                            ).cuda().bfloat16()
        s_args = library_args(sargs, scorr)
        library[key] = _graph_ms(lambda: ub(*s_args), 10, 5)
    log(f"[{smi}] {key}: bound {bounds[key][0]:.5f} ms ({bounds[key][1]}); "
        f"unfused UpdateBlock (cuDNN, bf16, graph replay) "
        f"{library[key]:.4f} ms")

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


def _fps_by_streams(what, model, cfg, flow_model, streams_all, smi,
                    bs=TIMED_STREAMS):
    """Aggregate and per-stream frames/s of ``track_on_frame_streams`` at
    each B of ``bs`` (an engine each, a warm-up run, then the timed run on
    B host streams of TIMED_STREAM_FRAMES frames)."""
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        track_on_frame_streams,
    )

    by_b = {}
    for B in bs:
        engine = InferenceEngine(model, cfg, flow_model=flow_model,
                                 num_streams=B)
        streams = streams_all[:B]
        with tempfile.TemporaryDirectory() as d:
            track_on_frame_streams([s[:6] for s in streams], None, cfg, d,
                                   engine=engine)
            _, fps = track_on_frame_streams(streams, None, cfg, d,
                                            engine=engine)
        by_b[B] = fps
        log(f"[{smi}] {what}, {B} stream(s) x {len(streams[0])} host "
            f"frames: {fps:.2f} frames/s in all, {fps / B:.2f} per stream")
    return by_b


def phase_stream_timings(noflow_engine, flow_engine, large, streams_engine,
                         smi):
    """Phase 4 for the slices of this script's later part: frames/s
    against the number of streams on the no-flow and RAFT paths, the
    Large RAFT path's frames/s, and the decode's and the warp's kernels at
    the 4-stream engine's shapes against their plain versions, bounds and
    library calls. Returns (times, bounds, library) by ``kernel@call``."""
    import torch
    import torch.nn.functional as F

    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops.warp import _flow_grid
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    streams_all = _stream_frames([TIMED_STREAM_FRAMES] * max(TIMED_STREAMS),
                                 seed=SEED + 10)
    fps = {}
    for what, e in (("no-flow path", noflow_engine),
                    ("RAFT path", flow_engine)):
        fps[what] = _fps_by_streams(what, e.model, e.cfg, e.flow_model,
                                    streams_all, smi)
    large_engine, depth = large
    n = len(depth)
    with tempfile.TemporaryDirectory() as d:
        _, fl = track_on_frames(streams_all[0][:n], None, large_engine.cfg,
                                d, depth_frames=depth, engine=large_engine)
    fps["Large RAFT path"] = {1: fl}
    log(f"[{smi}] Large path (RAFT x{FLOW_ITERS}, depth, no warp), 1 "
        f"stream x {n} host frames: {fl:.2f} frames/s")
    log(json.dumps({"frames_per_s_by_streams": fps}))

    # the 4-stream engine's newest window: its class maps decode as B
    # images in the union tier and 4B masks in the per-blob tier, and its
    # B*(T-1) earlier maps warp in one call
    times, bounds, library = {}, {}, {}
    e = streams_engine
    B = e.num_streams
    _keep_probs(e)
    e.reset()
    streams = _stream_frames([T] * B, seed=SEED + 20)
    for i in range(T):
        e.step_async(np.stack([s[i] for s in streams]))
    pred = e.kept_probs.argmax(-1)
    del e._outputs, e.kept_probs
    ucls = torch.zeros_like(pred, dtype=torch.int8)
    for src, dst in ((3, 1), (1, 2), (4, 3), (2, 4)):
        ucls[pred == src] = dst
    u = ucls.contiguous()
    m = class_masks(u)
    calls = decode_calls(u, m)
    for name, call, label in (
            ("union_flood_cc_cid", "union_flood_cc_cid", f"{B} images"),
            ("onehot_stats", "onehot_stats union tier", f"{B} images"),
            ("flood_cc_cid", "flood_cc_cid", f"{4 * B} masks")):
        kern, plain, ins = calls[call]
        key = f"{name}@{label}"
        for k_out, p_out in zip(kern(), plain()):
            _equal(key, k_out, p_out)
        times[key] = _in_turns(
            key, kern, plain, smi, f"{call} on the {B}-stream engine's "
            f"window; kernel: device time in CUDA-graph replays, plain: "
            f"eager", kreps=20, preps=3, timer=_graph_ms, ptimer=_event_ms)
        nbytes = _nbytes(*ins, *kern())
        bounds[key] = (nbytes / PEAK_BYTES * 1e3, "bytes")
        if name == "onehot_stats":
            idx, vals = stats_rows(*ins)
            acc = torch.zeros(B * K, 6, dtype=torch.int64, device="cuda")
            library[key] = _graph_ms(lambda: (acc.index_add_(0, idx, vals),))
        log(f"[{smi}] {key}: bound {bounds[key][0]:.5f} ms (bytes: {nbytes} "
            f"B at {PEAK_BYTES / 1e12} TB/s)"
            + (f", library index_add_ {library[key]:.4f} ms"
               if key in library else ""))

    maps = e.seg_buf[:, C:].reshape(B * (T - 1), C, H, W).contiguous()
    with torch.no_grad():
        fl = out.flow_from_feature_ring(*e.flow_state, (H, W), e.flow_model)
    fl = fl.reshape(B * (T - 1), 2, H, W).contiguous()
    key = f"flow_warp@{B * (T - 1)} maps"
    got = warp.flow_warp(maps, fl, (576, 720))
    want = warp.flow_warp_plain(maps, fl, (576, 720))
    err = (got.float() - want.float()).abs().max().item()
    if err > WARP_ATOL["bfloat16"]:
        raise AssertionError(f"{key}: kernel != plain ({err})")
    times[key] = _in_turns(
        key, lambda: warp.flow_warp(maps, fl, (576, 720)),
        lambda: warp.flow_warp_plain(maps, fl, (576, 720)), smi,
        f"device time in CUDA-graph replays; bf16 maps {tuple(maps.shape)} "
        f"of the {B}-stream engine, its flow, max |flow| "
        f"{fl.abs().max().item():.1f} px; max |kernel - plain| {err:.3g}",
        kreps=20, preps=3, timer=_graph_ms)
    w_bytes = _nbytes(maps, fl, got) / PEAK_BYTES * 1e3
    w_ops = maps.shape[0] * H * W * (30 + 7 * C) / PEAK_F32 * 1e3
    bounds[key] = (max(w_bytes, w_ops),
                   "bytes" if w_bytes >= w_ops else "operations")
    gx, gy = _flow_grid(fl, (576, 720))
    grid = torch.stack([gx, gy], -1).to(maps.dtype)
    library[key] = _graph_ms(lambda: F.grid_sample(
        maps, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 20)
    log(f"[{smi}] {key}: bound {bounds[key][0]:.5f} ms ({bounds[key][1]}); "
        f"F.grid_sample {library[key]:.4f} ms")
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

    def provider():
        with torch.no_grad():
            return out.flow_for_window(engine.flow_state, engine.flow_model)

    for run in range(3):  # host-bound numbers: several runs, all printed
        step_ms = _host_ms(lambda: engine.step_async(frames[next(it) % n]),
                           12)
        flow_ms = _host_ms(provider, 12)
        log(f"[{smi}] UnFlow path step {step_ms:.3f} ms/frame "
            f"(synchronized), of which the flow provider {flow_ms:.3f} ms = "
            f"{flow_ms / step_ms:.1%} of the frame (run {run + 1} of 3)")

    times, bounds, library = {}, {}, {}
    gen = torch.Generator().manual_seed(SEED)
    # kernel 6 at the tracker's shape, with the dtype the bf16 engine's
    # provider feeds it (float32: its layers compute in float32), and at the
    # offline CLI's shape in float32
    for shape, dt, key in (((2, UH // 16, UW // 16, 256), torch.float32,
                            "correlation"),
                           ((4, UH // 8, UW // 8, 256), torch.float32,
                            "correlation@offline")):
        f1 = torch.randn(shape, generator=gen).cuda().to(dt)
        f2 = torch.randn(shape, generator=gen).cuda().to(dt)
        plan = co.corr_plan(*shape, 20, 2, str(dt).split(".")[1])
        t = _in_turns(key, lambda: co.correlation_cost_volume(f1, f2),
                      lambda: co.correlation_plain(f1, f2), smi,
                      f"{dt}, {'x'.join(map(str, shape))}, md=20, s=2, route "
                      f"{plan.route}; kernel in CUDA-graph replays",
                      kreps=20, preps=2, ptimer=_event_ms, timer=_graph_ms)
        eager = _event_ms(lambda: co.correlation_cost_volume(f1, f2), 20)
        got = co.correlation_cost_volume(f1, f2)
        # an output whose window pixel lies outside the image (its row or
        # its column) is a stored zero, not a product: count the products
        # this shape needs, the in-image (y, dy) and (x, dx) pairs
        B_, H_, W_, C_ = shape

        def pairs_in(n):
            return sum(1 for i in range(n) for d in range(-20, 21, 2)
                       if 0 <= i + d < n)

        ops = 2.0 * B_ * pairs_in(H_) * pairs_in(W_) * C_
        # the peak is that of the inputs' type on the tensor cores: bf16
        # products with float32 sums are exact at 989 TFLOP/s; float32-exact
        # products are three TF32 passes (split TF32), 495 / 3 TFLOP/s. The
        # float32 FMA rate (67 TFLOP/s) is printed beside it.
        peak, unit = ((PEAK_BF16, "989 TFLOP/s bfloat16 tensor cores")
                      if dt == torch.bfloat16 else
                      (PEAK_TF32 / 3, "495 / 3 TFLOP/s, float32 products as "
                       "three TF32 passes"))
        b_ops = ops / peak * 1e3
        b_bytes = _nbytes(f1, f2, got) / PEAK_BYTES * 1e3
        bound = (max(b_ops, b_bytes),
                 "operations" if b_ops >= b_bytes else "bytes")
        # library yardstick: torch.bmm of each residue sub-grid's Gram
        # matrix, f32, TF32 off, products only (the correlation needs the
        # window's band of it; the sub-grids are gathered outside the timing)
        a, b = _residue_grams(f1.float(), f2.float(), 2)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            lib = _graph_ms(lambda: torch.bmm(a, b.transpose(1, 2)), 20)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        gram_ops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1] * a.shape[2]
        staged = co.staged_rows(plan, B_, H_, W_, 20, 2) * C_ * 4 / 1e6
        log(f"[{smi}] {key}: bound {bound[0]:.5f} ms (by {bound[1]}; "
            f"operations {ops / 1e9:.3f} GFLOP at {unit} = {b_ops:.5f} ms, at the "
            f"67 TFLOP/s float32 FMA rate {ops / PEAK_F32 * 1e3:.5f} ms; "
            f"bytes {_nbytes(f1, f2, got)} B at 3.35 TB/s = {b_bytes:.5f} "
            f"ms); kernel {t[0]:.4f} ms in graph replays = "
            f"{ops / t[0] / 1e9:.1f} TFLOP/s ({eager:.4f} ms eager), "
            f"{bound[0] / t[0]:.1%} of its bound; its blocks stage "
            f"{staged:.1f} MB of f1 and f2 rows = "
            f"{staged / t[0] / 1e3:.2f} TB/s; library yardstick torch.bmm "
            f"of the {a.shape[0]} residue sub-grids' full {a.shape[1]}x"
            f"{b.shape[1]} Gram matrices (f32, TF32 off, products only: "
            f"{gram_ops / 1e9:.3f} GFLOP, no window, no zeros) {lib:.4f} ms")
        times[key], bounds[key], library[key] = t, bound, lib

    # UnFlow's backward warp. The provider passes channels_last float32
    # frames and an NCHW float32 flow (phase 3 printed their strides); NCHW
    # frames are what this script timed before the one-launch kernel, and
    # that reading is kept beside the new ones.
    hw = (UH // 2, UW // 2)
    frame = torch.randn(2, 3, *hw, generator=gen).cuda()
    fl = (torch.randn(2, 2, *hw, generator=gen) * 8.0).cuda()
    frame_cl = frame.contiguous(memory_format=torch.channels_last)
    fl_cl = fl  # the flow as the provider passes it
    what = (f"f32 2x3x{hw[0]}x{hw[1]}; device time in CUDA-graph replays")
    # kernel 5's second entry point alone, on ready absolute coordinates
    # (the backward warp's grid, border clamp) of the NCHW frame, and inside
    # the earlier composition (coordinates in PyTorch, layout copies), as
    # the engine paid for it before the one-launch backward warp
    from mfcnet_tpu_torch.ops._build import kernel_lib, stream_of

    ready = _abs_coords(fl, *hw)[2]
    gx, gy = ready[..., 0].contiguous(), ready[..., 1].contiguous()
    res = torch.empty_like(frame)

    def warp_abs_alone():
        rc = kernel_lib().mfc_warp_abs(
            frame.data_ptr(), gx.data_ptr(), gy.data_ptr(), res.data_ptr(),
            2, 3, *hw, *hw, 0, 1, 0, stream_of(frame))
        if rc != 0:
            raise RuntimeError(f"mfc_warp_abs: cudaError {rc}")
        return res

    _equal("warp_abs alone", warp_abs_alone(),
           warp.grid_sample_bilinear_plain(frame, gx, gy, False, "border"))
    times["warp_abs"] = _in_turns(
        "warp_abs", warp_abs_alone,
        lambda: warp.grid_sample_bilinear_plain(frame, gx, gy, False,
                                                "border"), smi,
        f"alone, NCHW frame, ready normalized grid, {what}",
        kreps=20, preps=3, timer=_graph_ms)
    whole_abs = _graph_ms(lambda: warp.grid_sample_bilinear(
        frame, gx, gy, False, "border"), 20)
    bounds["warp_abs"] = (
        _nbytes(frame, gx, gy, res) / PEAK_BYTES * 1e3, "bytes")
    library["warp_abs"] = _graph_ms(lambda: F.grid_sample(
        frame, ready, mode="bilinear", padding_mode="border",
        align_corners=False), 20)
    old_cl = _graph_ms(lambda: _warp_abs_backward_warp(frame_cl, fl_cl), 20)
    old_nchw = _graph_ms(lambda: _warp_abs_backward_warp(frame, fl), 20)
    # the one-launch kernel on the same tensors
    times["backward_warp"] = _in_turns(
        "backward_warp", lambda: backward_warp(frame_cl, fl_cl),
        lambda: warp.backward_warp_plain(frame_cl, fl_cl), smi,
        f"one launch, channels_last frame, {what}",
        kreps=20, preps=3, timer=_graph_ms)
    new_nchw = _graph_ms(lambda: backward_warp(frame, fl), 20)
    got = backward_warp(frame_cl, fl_cl)
    wb = _nbytes(frame_cl, fl_cl, got) / PEAK_BYTES * 1e3
    bounds["backward_warp"] = (wb, "bytes")
    old_names = _count_device_kernels(
        lambda: _warp_abs_backward_warp(frame_cl, fl_cl))
    # library yardstick, two readings: F.grid_sample on a grid made outside
    # the timing (the earlier reading: NCHW frame), and the whole function
    # from the flow, the grid built inside the timed call
    xs = torch.linspace(-1, 1, hw[1], device="cuda").view(1, 1, -1)
    ys = torch.linspace(-1, 1, hw[0], device="cuda").view(1, -1, 1)

    def grid_of(flow):
        flow = flow.float()
        return torch.stack([xs + flow[:, 0] / ((hw[1] - 1) / 2.0),
                            ys + flow[:, 1] / ((hw[0] - 1) / 2.0)], -1
                           ).to(frame.dtype)

    def sample(img, grid):
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    grid, grid_cl = grid_of(fl), grid_of(fl_cl)
    lib_ready_nchw = _graph_ms(lambda: sample(frame, grid), 20)
    lib_ready_cl = _graph_ms(lambda: sample(frame_cl, grid_cl), 20)
    lib_whole_cl = _graph_ms(lambda: sample(frame_cl, grid_of(fl_cl)), 20)
    lib_whole_nchw = _graph_ms(lambda: sample(frame, grid_of(fl)), 20)
    library["backward_warp"] = lib_whole_cl
    log(f"[{smi}] warp_abs alone: bound {bounds['warp_abs'][0]:.5f} ms "
        f"(bytes); the whole grid_sample_bilinear call {whole_abs:.4f} ms; "
        f"F.grid_sample on the same ready grid {library['warp_abs']:.4f} ms")
    log(f"[{smi}] backward_warp: bound {wb:.5f} ms (bytes: "
        f"{_nbytes(frame_cl, fl_cl, got)} B at 3.35 TB/s); one launch "
        f"{times['backward_warp'][0]:.4f} ms on the channels_last float32 "
        f"frame and float32 flow (one device kernel: counted by the profiler "
        f"in phase 3, on the provider's own tensors), {new_nchw:.4f} ms on an "
        f"NCHW frame; the earlier composition around "
        f"warp_abs {old_cl:.4f} ms ({len(old_names)} device "
        f"kernels and copies) on the same tensors, "
        f"{old_nchw:.4f} ms on the NCHW frame; F.grid_sample on a ready-made "
        f"grid {lib_ready_nchw:.4f} ms (NCHW frame) / {lib_ready_cl:.4f} ms "
        f"(channels_last), with the grid built from the flow inside the "
        f"timed call {lib_whole_nchw:.4f} ms (NCHW) / {lib_whole_cl:.4f} ms "
        f"(channels_last)")

    # kernels 7 and 8 at the first VGG stage's shapes, bf16, against cuDNN
    # (F.conv2d + ReLU, bf16, channels_last); beside each, the time of the
    # earlier mma.sync design (PERF.md rows 7 and 8, same card)
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
                      f"bf16 1x{Hc}x{Wc}x{cin}->{cout}, bias + ReLU; "
                      f"device time in CUDA-graph replays", kreps=20,
                      preps=5, timer=_graph_ms)
        eager = _event_ms(lambda: c3.conv3x3(x, w, b, True), 20)
        got = c3.conv3x3(x, w, b, True)
        ops = 2.0 * Hc * Wc * 9 * cin * cout
        b_ops = ops / PEAK_BF16 * 1e3
        b_bytes = _nbytes(x, w, b, got) / PEAK_BYTES * 1e3
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.bfloat16()
        lib = _graph_ms(lambda: F.relu(F.conv2d(xc, wc, bc, padding=1)))
        lib_eager = _event_ms(
            lambda: F.relu(F.conv2d(xc, wc, bc, padding=1)), 20)
        log(f"[{smi}] {key}: bound {max(b_ops, b_bytes):.5f} ms (operations "
            f"{b_ops:.5f} ms at 989 TFLOP/s bf16, bytes {b_bytes:.5f} ms); "
            f"kernel {t[0]:.4f} ms = {ops / t[0] / 1e9:.1f} TFLOP/s in graph "
            f"replays, {eager:.4f} ms eager (the earlier mma.sync design, "
            f"eager: {EARLIER_MS[key]} ms); F.conv2d + ReLU (cuDNN, bf16, "
            f"channels_last) {lib:.4f} ms = {ops / lib / 1e9:.1f} TFLOP/s in "
            f"graph replays, {lib_eager:.4f} ms eager")
        if key == "conv3x3":
            times[key] = t
            bounds[key] = (max(b_ops, b_bytes),
                           "operations" if b_ops >= b_bytes else "bytes")
            library[key] = lib
    x = torch.randn(1, H, W, 3, generator=gen).cuda().bfloat16()
    times["vgg_stage1"] = _in_turns(
        "vgg_stage1", lambda: s1.vgg_stage1(x, k1, b1, k2, b2),
        lambda: s1.vgg_stage1_plain(x, k1, b1, k2, b2), smi,
        f"bf16 1x{H}x{W}x3, C1=64, the model's own weights; device time in "
        f"CUDA-graph replays", kreps=20, preps=5, timer=_graph_ms)
    eager = _event_ms(lambda: s1.vgg_stage1(x, k1, b1, k2, b2), 20)
    got = s1.vgg_stage1(x, k1, b1, k2, b2)
    ops = 2.0 * H * W * 9 * (3 * 64 + 64 * 64)
    b_ops = ops / PEAK_BF16 * 1e3
    b_bytes = _nbytes(x, k1, b1, k2, b2, got) / PEAK_BYTES * 1e3
    bounds["vgg_stage1"] = (max(b_ops, b_bytes),
                            "operations" if b_ops >= b_bytes else "bytes")
    xc = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        library["vgg_stage1"] = _graph_ms(lambda: stage(xc))
        lib_eager = _event_ms(lambda: stage(xc), 20)
    log(f"[{smi}] vgg_stage1: bound {bounds['vgg_stage1'][0]:.5f} ms "
        f"({bounds['vgg_stage1'][1]}: operations {b_ops:.5f} ms at 989 "
        f"TFLOP/s bf16, bytes {b_bytes:.5f} ms); kernel "
        f"{times['vgg_stage1'][0]:.4f} ms = "
        f"{ops / times['vgg_stage1'][0] / 1e9:.1f} TFLOP/s in graph "
        f"replays, {eager:.4f} ms eager (the earlier design, eager: "
        f"{EARLIER_MS['vgg_stage1']} ms); the model's first stage (cuDNN, "
        f"two F.conv2d + ReLU, bf16, channels_last) "
        f"{library['vgg_stage1']:.4f} ms = "
        f"{ops / library['vgg_stage1'] / 1e9:.1f} TFLOP/s in graph replays, "
        f"{lib_eager:.4f} ms eager")
    return times, bounds, library


# ---------------------------------------------------------------------------
# phase 5: training (TernausNetMulti-Basic at full width with frozen RAFT in
# the step and depth inputs) and B1, the flow warp's backward
# ---------------------------------------------------------------------------
#: the training runs: batch, run A's micro-steps (24 train frames / 4),
#: the learning check (tests/test_e2e_learning.py's recipe). A single
#: seed's loss curve is chaotic on this tiny model (tools/learn_seeds.py):
#: seed 0 read 0.617 on an H100 and 0.35 on the CPU, seeds 1 and 2
#: 0.38-0.52 on the card from run to run (cuDNN's weight gradients add in
#: another order each run) and 0.38-0.39 on the CPU, while the card's
#: steps agree with the CPU's (``_check_step_on_card``); so the check
#: trains seeds 0 to 4 and holds the median ratio
TRAIN_B, TRAIN_ACCUM = 4, 2
LEARN_HW, LEARN_EPOCHS, LEARN_RATIO, LEARN_SEEDS = 64, 8, 0.6, (0, 1, 2, 3, 4)
#: the card's float32 train step against the CPU's on the same weights and
#: batch (parity mode: no TF32): loss parts to 1e-4 relative (convolutions
#: summed in other orders over ~10^4 terms); parameters after the updates
#: within 1e-5 of a tensor's largest value plus 1e-4 of the learning rate,
#: but for one element in a thousand, which may differ by what Adam can
#: move an element, the learning rate per update, on each side: an element
#: whose gradient is of the order of Adam's eps (1e-8) moves by lr * g /
#: (|g| + eps), which passes on the relative difference of that gradient
#: whole (cuDNN's sums against the CPU's: found 2.9 % of the learning rate
#: on one element, as tests/test_torch_train_steps.py finds against JAX)
STEP_LR, STEP_LOSS_RTOL = 1e-3, 1e-4
#: B1 against its plain version. Maps gradient: the kernel adds in
#: another order than index_add_, so float32 results agree
#: to float32 rounding of unit-scale sums (1e-5) and bf16 results to one
#: bf16 rounding of the float32 result plus that margin. Flow gradient: a per-pixel sum
#: over channels in another order, relative 1e-5 of values up to ~10^2.
B1_MAPS_ATOL, B1_FLOW_TOL = 1e-5, (1e-5, 1e-4)
#: ... except where a flow converges, so that a tap sums thousands of
#: terms: two float32 summation orders then differ by about one float32
#: rounding of the sum of the terms' magnitudes (at most 2 over 20 random
#: orders of 100 to 300,000 terms), more than 1e-5, so such a case adds 8
#: such roundings to each element's bound (for the other cases they are
#: ~1e-6 and the bound is not widened)
B1_ORDER_ROUNDINGS = 8
#: B1's odd shape: H * W odd, so channel planes of g alternate in parity;
#: on a grid 1.2 times the image, as 576x720 is to 480x640
B1_ODD_HW = (37, 61)


def b1_flows(gen, B, h, w, grid_hw=(576, 720)):
    """The two flows that stress B1's maps kernel, (B, 2, h, w) float32 on
    the CPU: "convergent", every pixel's flow pointing to within 2 px of
    one point (its taps' tiles hold every pixel's list entry), and "long",
    a smooth flow of up to ~100 px in x and y, beyond any tile and any
    band."""
    import torch

    gh, gw = grid_hw
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    sx, sy = (w - 1) / (gw - 1), (h - 1) / (gh - 1)
    point = torch.stack([0.6 * w + 0.3 - xx * sx, 0.4 * h + 0.7 - yy * sy])
    jitter = (torch.rand(B, 2, h, w, generator=gen) - 0.5) * 4.0
    long = torch.stack([100.0 * torch.sin(xx / 97.0 + yy / 61.0),
                        100.0 * torch.cos(xx / 83.0 - yy / 71.0)])
    return {"convergent": (point[None] + jitter).contiguous(),
            "long": long[None].expand(B, 2, h, w).contiguous()}


def _train_args(pack, out, name, *extra):
    return ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
            "--expt_savedir", str(out), "--expt_name", name,
            "--batch_size", str(TRAIN_B), "--num_workers", "4",
            "--num_epochs", "0", "--print_freq", "100",
            "--input_height", str(H), "--input_width", str(W),
            "--add_optflow_inputs", "True", "--add_depth_inputs", "True",
            "--loss_fns", "nll", "soft_jaccard", "--loss_wts", "0.7", "0.3",
            "--seed", str(SEED), *extra]


#: the micro-step of run A traced by the profiler (after two of warm-up)
TRAIN_TRACED = 3


def _traced(fn):
    """Run ``fn`` once under ``_profiled``; returns (its result, [(kernel
    name, device us)], wall ms of the call). A step is not run twice, so a
    trace that is not whole is used as it is, and said so."""
    out, events, whole, wall = _profiled(fn)
    if not whole:
        log("the profiler lost device events of the traced step; its "
            "breakdown below counts what was recorded")
    return out, events, wall


#: kernel-name patterns of the train step's device time, in order of test
#: (cuDNN's convolutions are implicit GEMMs: their names are tested before
#: the matrix products')
STEP_PARTS = (("B1 (flow_warp_bwd)", ("flow_warp_bwd",)),
              ("flow_warp", ("flow_warp_kernel",)),
              ("raft_update", ("fill_hx_kernel", "tma_conv_kernel")),
              ("convolutions (cuDNN)", (
                  "fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn",
                  "winograd")),
              ("matrix products", ("gemm", "gemv", "cutlass", "xmma")),
              ("Adam / EMA (multi-tensor)", ("multi_tensor", "foreach")),
              ("other: copies, casts, elementwise, reductions", ("",)))


def _step_breakdown(events, wall_ms, smi):
    """Device ms of one traced micro-step by part, the busy sum, the idle
    share of its wall time (under the profiler), and the largest kernels of
    the last part."""
    parts = {name: 0.0 for name, _ in STEP_PARTS}
    other = {}
    for name, us in events:
        low = name.lower()
        for part, keys in STEP_PARTS:
            if any(k in low for k in keys):
                parts[part] += us / 1e3
                if part == STEP_PARTS[-1][0]:
                    short = re.sub(r"<.*", "", name.replace("void ", ""))
                    other[short] = other.get(short, 0.0) + us / 1e3
                break
    busy = sum(parts.values())
    log(f"[{smi}] train run A, micro-step {TRAIN_TRACED + 1} traced: "
        f"{len(events)} device operations, busy {busy:.2f} ms of {wall_ms:.2f} "
        f"ms wall (idle share {1 - busy / wall_ms:.1%}, under the profiler): "
        + json.dumps({k: round(v, 3) for k, v in parts.items()}))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{smi}] the largest of the other part: "
        + json.dumps({k[:90]: round(v, 3) for k, v in top}))
    return parts, busy


def _probe_train_steps(cli, records, capture):
    """Wrap the training CLI's train step: per micro-step device-synchronized
    ms, kernel launches, loss parts, whether it updated, and whether a head
    parameter, a base parameter and the head parameter's EMA moved. The
    first micro-step also captures B1's inputs (the upstream gradient, the
    maps and the flow of the head's warp) into ``capture``; micro-step
    ``TRAIN_TRACED`` runs under the profiler (its events in the record,
    its ms not used for the median). Returns the unwrapped factory."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    real = cli.make_multiframe_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def probed(state, batch):
            named = dict(state.model.named_parameters())
            keys = ("multiframe_net.multiframe_net.0.weight",
                    "base_model.encoder.0.weight")
            before = [named[k].detach().clone() for k in keys]
            ema0 = None if state.ema is None else state.ema[keys[0]].clone()
            undo = []
            if "g" not in capture:
                fwd, bwd = warp._FlowWarp.forward, warp.flow_warp_bwd_maps

                def cap_fwd(ctx, maps, flow, grid_hw, ac):
                    capture.setdefault("maps", maps.detach().clone())
                    capture.setdefault("flow", flow.detach().clone())
                    return fwd(ctx, maps, flow, grid_hw, ac)

                def cap_bwd(g, flow, *rest):
                    capture.setdefault("g", g.detach().clone())
                    return bwd(g, flow, *rest)

                warp._FlowWarp.forward = staticmethod(cap_fwd)
                warp.flow_warp_bwd_maps = cap_bwd
                undo = [("forward", fwd), ("bwd", bwd)]
            counts0 = _all_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = wall = None
            try:
                if len(records) == TRAIN_TRACED and capture.get("trace"):
                    parts, events, wall = _traced(lambda: step(state, batch))
                else:
                    parts = step(state, batch)
                torch.cuda.synchronize()
            finally:
                for what, fn in undo:
                    if what == "forward":
                        warp._FlowWarp.forward = staticmethod(fn)
                    else:
                        warp.flow_warp_bwd_maps = fn
            ms = (time.perf_counter() - t0) * 1e3
            records.append({
                "ms": ms, "events": events, "traced_wall": wall,
                "launches": {k: v - counts0[k]
                             for k, v in _all_launches().items()},
                "parts": {k: float(v) for k, v in parts.items()},
                "update": state.micro == 0,
                "head_moved": not torch.equal(before[0], named[keys[0]]),
                "base_moved": not torch.equal(before[1], named[keys[1]]),
                "ema_moved": (ema0 is not None and not torch.equal(
                    ema0, state.ema[keys[0]])),
            })
            return parts

        return probed

    cli.make_multiframe_train_step = make
    return real


def b1_moved_bytes(g, flow, grid_hw):
    """Bytes B1's maps entry moves on these tensors, by design: (the first
    design's: g and the flow read, the gradient written, and a float32
    accumulator zeroed, hit by the atomics and, for bf16, read back for the
    cast; this design's: g read, the gradient written, the flow read, the
    float32 coordinates written and read back, and per list entry its two
    ints written and read and its pixel's coordinates read; the
    entries)."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    entries = int((warp.tap_tiles(flow, grid_hw) >= 0).sum())
    io = 2 * _nbytes(g) + _nbytes(flow)
    acc = 4 * g.numel()
    first = io + (3 * acc if g.dtype != torch.float32 else acc)
    return first, io + 2 * _nbytes(flow) + 24 * entries, entries


def _hold_flow_warp_bwd(g, maps, flow, what, grid_hw=(576, 720),
                        converges=False):
    """Both B1 entry points against the plain backward on these tensors;
    returns (max |diff| of the maps gradient, of the flow gradient).
    ``converges``: the maps bound grows by B1_ORDER_ROUNDINGS float32
    roundings of each element's sum of term magnitudes."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    warp.reset_launches()
    gm = warp.flow_warp_bwd_maps(g, flow, grid_hw)
    gf = warp.flow_warp_bwd_flow(g, maps, flow, grid_hw)
    if (warp.LAUNCHES["flow_warp_bwd_maps"],
            warp.LAUNCHES["flow_warp_bwd_flow"]) != (1, 1):
        raise AssertionError(f"{what}: one launch per entry point expected, "
                             f"got {warp.LAUNCHES}")
    pm, pf = warp.flow_warp_backward_plain(g, maps, flow, grid_hw)
    torch.cuda.synchronize()
    if gm.dtype != g.dtype or gm.shape != maps.shape or gf.shape != flow.shape:
        raise AssertionError(f"{what}: wrong result types or shapes")
    err_m = (gm.float() - pm.float()).abs().max().item()
    atol = B1_MAPS_ATOL
    if converges:
        terms = warp.flow_warp_backward_plain(g.float().abs(), maps.float(),
                                              flow, grid_hw)[0]
        atol = atol + B1_ORDER_ROUNDINGS * 2.0 ** -24 * terms
    if g.dtype == torch.float32:
        ok = bool(((gm - pm).abs() <= atol).all())
    else:  # one bf16 rounding of the float32 result, plus the f32 margin
        ref = warp.flow_warp_backward_plain(g.float(), maps.float(), flow,
                                            grid_hw)[0]
        ulp = 2.0 ** -8 * ref.abs()
        ok = bool(((gm.float() - ref).abs() <= ulp + atol).all())
    rtol, atol_f = B1_FLOW_TOL
    err_f = (gf - pf).abs().max().item()
    ok_f = bool(((gf - pf).abs() <= atol_f + rtol * pf.abs()).all())
    if not (ok and ok_f):
        raise AssertionError(f"{what}: B1 kernel != plain (maps max |diff| "
                             f"{err_m}, flow max |diff| {err_f})")
    return err_m, err_f


def _check_bwd_plan_refusals(g, flow):
    """The maps entry launches only on warp_bwd_plan's plan for its shape:
    another plan raises, and nothing is counted as launched."""
    from unittest import mock

    from mfcnet_tpu_torch.ops import warp

    right = warp.warp_bwd_plan
    for what, bad in (
            ("another tile",
             lambda *a: right(*a)._replace(tile_h=2 * right(*a).tile_h)),
            ("a smaller workspace",
             lambda *a: right(*a)._replace(work_ints=right(*a).work_ints - 1)),
            ("more blocks than the card holds at once",
             lambda *a: right(*a)._replace(grid=4 * right(*a).grid))):
        before = dict(warp.LAUNCHES)
        with mock.patch.object(warp, "warp_bwd_plan", bad):
            try:
                warp.flow_warp_bwd_maps(g, flow, (576, 720))
            except RuntimeError as e:
                if "refused the plan" not in str(e):
                    raise
            else:
                raise AssertionError(f"the B1 maps kernel took {what}")
        if warp.LAUNCHES != before:
            raise AssertionError("a refused launch was counted")


def _check_flow_warp_bwd(step_inputs):
    """B1 on _warp_flows' cases plus a smooth flow and integer coordinates
    (zero flow on the identity grid) at 480x640, on B1_ODD_HW (an odd H and
    W: g's channel planes start at odd element offsets) and on the train
    step's own tensors; float32 and bf16; one device operation per entry
    point per call. Returns the worst float32 maps-gradient difference."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 9)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    converged = {}
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    smooth = torch.stack([6 * torch.sin(xx / 37.0) * torch.cos(yy / 53.0),
                          4 * torch.cos(xx / 61.0 + yy / 29.0)])[None]
    cases = dict(_warp_flows(gen))
    cases["smooth"] = smooth.expand(2, 2, H, W).contiguous()
    cases.update(b1_flows(gen, 2, H, W))
    n_int = None
    for dt in (torch.float32, torch.bfloat16):
        maps = torch.rand(2, C + 1, H, W, generator=gen).cuda().to(dt)
        g = torch.randn(2, C + 1, H, W, generator=gen).cuda().to(dt)
        for name, flow in cases.items():
            flow = flow.cuda()
            em, _ = _hold_flow_warp_bwd(g, maps, flow, f"B1[{dt}, {name}]",
                                        converges=name == "convergent")
            if name == "convergent":  # on its own bound, reported apart
                converged[str(dt).split(".")[1]] = em
                continue
            worst[str(dt).split(".")[1]] = max(
                worst[str(dt).split(".")[1]], em)
        zero = torch.zeros(2, 2, H, W, device="cuda")
        em, _ = _hold_flow_warp_bwd(g, maps, zero, f"B1[{dt}, integer]",
                                    grid_hw=None)
        worst[str(dt).split(".")[1]] = max(worst[str(dt).split(".")[1]], em)
        if n_int is None:
            from mfcnet_tpu_torch.ops.warp import _abs_coords, _flow_grid

            fx, fy = _abs_coords(*_flow_grid(zero, None), H, W, True, "zeros")
            n_int = int(((fx == fx.floor()) & (fy == fy.floor())).sum())
            if n_int == 0:
                raise AssertionError("B1: the integer case has no integer "
                                     "coordinates")
    oh, ow = B1_ODD_HW
    odd_grid = (oh + oh // 5, ow + ow // 5)
    odd = {"bounded": torch.randn(2, 2, oh, ow, generator=gen) * 4.0,
           "leaves the image": torch.randn(2, 2, oh, ow, generator=gen) * 4.0
           + 700.0}
    odd.update(b1_flows(gen, 2, oh, ow, odd_grid))
    for dt in (torch.float32, torch.bfloat16):
        maps = torch.rand(2, C + 1, oh, ow, generator=gen).cuda().to(dt)
        g = torch.randn(2, C + 1, oh, ow, generator=gen).cuda().to(dt)
        d = str(dt).split(".")[1]
        for name, flow in odd.items():
            em, _ = _hold_flow_warp_bwd(g, maps, flow.cuda(),
                                        f"B1[{dt}, {oh}x{ow}, {name}]",
                                        grid_hw=odd_grid,
                                        converges=name == "convergent")
            if name == "convergent":
                converged[d] = max(converged[d], em)
            else:
                worst[d] = max(worst[d], em)
        em, _ = _hold_flow_warp_bwd(
            g, maps, torch.zeros(2, 2, oh, ow, device="cuda"),
            f"B1[{dt}, {oh}x{ow}, integer]", grid_hw=None)
        worst[d] = max(worst[d], em)
    g, maps, flow = (step_inputs[k] for k in ("g", "maps", "flow"))
    for dt in (torch.bfloat16, torch.float32):
        em, _ = _hold_flow_warp_bwd(g.to(dt), maps.to(dt), flow.float(),
                                     f"B1[{dt}, the train step's tensors]")
        worst[str(dt).split(".")[1]] = max(worst[str(dt).split(".")[1]], em)
    from mfcnet_tpu_torch.ops import warp

    # the kernels read a float32 flow; the bf16 step's flow (cast with the
    # inputs, as the JAX step casts it) costs the wrapper one conversion
    flow = flow.float().contiguous()
    _check_bwd_plan_refusals(g, flow)
    ops = {e: _count_device_kernels(fn) for e, fn in (
        ("maps", lambda: warp.flow_warp_bwd_maps(g, flow, (576, 720))),
        ("flow", lambda: warp.flow_warp_bwd_flow(g, maps, flow,
                                                 (576, 720))))}
    for e, names in ops.items():
        if len(names) != 1 or f"flow_warp_bwd_{e}" not in names[0]:
            raise AssertionError(f"B1 {e} entry: one device operation a "
                                 f"call expected, got {names}")
    log(f"flow_warp_bwd (B1) kernel vs plain: 2x{C + 1}x{H}x{W} on "
        f"{', '.join(cases)} flows and integer coordinates ({n_int} pixels "
        f"on both integer axes), 2x{C + 1}x{oh}x{ow} on {', '.join(odd)} "
        f"flows and integer coordinates, and the train step's {tuple(g.shape)} "
        f"tensors; maps gradient f32 atol {B1_MAPS_ATOL}, bf16 one rounding "
        f"+ {B1_MAPS_ATOL}, the convergent case + {B1_ORDER_ROUNDINGS} f32 "
        f"roundings of the summed magnitudes (max |diff| f32 "
        f"{worst['float32']}, bf16 {worst['bfloat16']}; convergent f32 "
        f"{converged['float32']}, bf16 {converged['bfloat16']}); flow "
        f"gradient rtol "
        f"{B1_FLOW_TOL[0]} atol {B1_FLOW_TOL[1]}; one device operation per "
        f"entry point per call on a float32 flow ({ops['maps'][0]}, "
        f"{ops['flow'][0]}); a plan other than warp_bwd_plan's refused")
    return worst["float32"]


def _time_flow_warp_bwd(step_inputs, smi):
    """B1's maps entry on the train step's tensors: kernel, plain version
    and grid_sampler_2d_backward (maps gradient only) in CUDA-graph
    replays; its bound. Returns (times, bounds, library)."""
    import torch

    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops.warp import _flow_grid

    g, maps, flow = (step_inputs[k] for k in ("g", "maps", "flow"))
    flow = flow.float().contiguous()
    Bn, Cw = g.shape[:2]
    t = _in_turns(
        "flow_warp_bwd", lambda: warp.flow_warp_bwd_maps(g, flow, (576, 720)),
        lambda: warp.flow_warp_backward_plain(g, maps, flow, (576, 720)),
        smi, f"maps gradient, device time in CUDA-graph replays; the train "
        f"step's {Bn}x{Cw}x{H}x{W} {g.dtype} gradient and its flow (max "
        f"|flow| {flow.abs().max().item():.1f} px)",
        kreps=10, preps=2, timer=_graph_ms, ptimer=_event_ms)
    out = warp.flow_warp_bwd_maps(g, flow, (576, 720))
    b_bytes = _nbytes(g, flow, out) / PEAK_BYTES * 1e3
    b_ops = Bn * H * W * (30 + 8 * Cw) / PEAK_F32 * 1e3
    bound = (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations")
    moved_pr9, moved, entries = b1_moved_bytes(g, flow, (576, 720))
    gx, gy = _flow_grid(flow, (576, 720))
    grid = torch.stack([gx, gy], -1).to(maps.dtype).contiguous()
    lib = _graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g, maps, grid, 0, 0, True, [True, False]), 10)
    # the flow entry (no path of the trainer runs it: the providers are
    # frozen), beside grid_sampler_2d_backward's grid gradient
    key = "flow_warp_bwd@flow entry"
    tf = _in_turns(
        key, lambda: warp.flow_warp_bwd_flow(g, maps, flow, (576, 720)),
        lambda: warp.flow_warp_backward_plain(g, maps, flow, (576, 720)),
        smi, "flow gradient, the same tensors", kreps=10, preps=2,
        timer=_graph_ms, ptimer=_event_ms)
    gf = warp.flow_warp_bwd_flow(g, maps, flow, (576, 720))
    f_bytes = _nbytes(g, maps, flow, gf) / PEAK_BYTES * 1e3
    f_ops = Bn * H * W * (40 + 16 * Cw) / PEAK_F32 * 1e3
    f_lib = _graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g, maps, grid, 0, 0, True, [False, True]), 10)
    log(f"[{smi}] {key}: bound {max(f_bytes, f_ops):.5f} ms (bytes "
        f"{f_bytes:.5f}, operations {f_ops:.5f}); grid_sampler_2d_backward "
        f"(grid gradient) {f_lib:.4f} ms")
    log(f"[{smi}] flow_warp_bwd: bound {bound[0]:.5f} ms ({bound[1]}: "
        f"{_nbytes(g, flow, out)} B read g + flow, write the gradient, at "
        f"3.35 TB/s); the kernel also writes and reads its coordinates and "
        f"{entries} list entries: ~{moved} B "
        f"({moved / PEAK_BYTES * 1e3:.5f} ms at the memory rate; the first "
        f"design's float32 accumulator made it ~{moved_pr9} B); "
        f"grid_sampler_2d_backward (maps gradient) {lib:.4f} ms")
    return ({"flow_warp_bwd": t, key: tf},
            {"flow_warp_bwd": bound,
             key: (max(f_bytes, f_ops),
                   "bytes" if f_bytes >= f_ops else "operations")},
            {"flow_warp_bwd": lib, key: f_lib})


def _check_step_on_card():
    """Two float32 train steps of a 64x64 TernausNetMulti-Basic at scale
    0.25 with frozen RAFT in the step, depth and the base trained, on the
    card (the kernels: flow_warp, B1's maps entry) and on the CPU (their
    plain versions; the CPU path is held to the JAX step by
    tests/test_torch_train_steps.py), from the same weights and batches."""
    import torch

    from mfcnet_tpu_torch.data.transforms import (
        TransformConfig,
        augment_train_batch,
    )
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
        init_weights_lecun,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.track.outputs import flow_for_training
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    hw = LEARN_HW
    model = init_weights_lecun(get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=0.25), torch.Generator().manual_seed(4))
    raft = init_weights(RAFT(iters=FLOW_ITERS, input_hw=(hw, hw)),
                        torch.Generator().manual_seed(5)).eval()
    rng = np.random.default_rng(6)
    cfg = TransformConfig(out_height=hw, out_width=hw)
    batches = [augment_train_batch({
        "frames": rng.integers(0, 256, (2, T, hw, hw, 3), dtype=np.uint8),
        "mask": rng.integers(0, C, (2, hw, hw), dtype=np.uint8),
        "depth": rng.integers(0, 256, (2, T, hw, hw), dtype=np.uint8)},
        torch.Generator().manual_seed(i), cfg) for i in range(2)]
    out = {}
    with parity_mode():
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            r = copy.deepcopy(raft).to(dev).requires_grad_(False)
            st = TrainState(m, make_schedule("Constant", STEP_LR, 1, 1), T)
            step = make_multiframe_train_step(
                ["nll", "soft_jaccard"], [0.7, 0.3], C,
                class_weights=[1, 50, 50, 50, 50],
                flow_fn=lambda f, r=r: flow_for_training(f, r))
            warp.reset_launches()
            parts = [step(st, {k: v.to(dev) for k, v in b.items()})
                     for b in batches]
            out[dev] = ([{k: float(v) for k, v in p.items()} for p in parts],
                        {k: v.float().cpu() for k, v in
                         m.state_dict().items()},
                        dict(warp.LAUNCHES))
    (pc, sdc, _), (pg, sdg, lg) = out["cpu"], out["cuda"]
    if lg["flow_warp_bwd_maps"] != 2 or lg["flow_warp"] != 2:
        raise AssertionError(f"card step: launches {lg}")
    worst_loss = max(abs(g[k] - c[k]) / abs(c[k])
                     for c, g in zip(pc, pg) for k in c)
    worst_par, n_loose = 0.0, 0
    for k, w in sdc.items():
        if not w.is_floating_point():
            continue
        err = (sdg[k] - w).abs()
        tight = 1e-5 * float(w.abs().max()) + 1e-4 * STEP_LR
        loose = int((err > tight).sum())
        if (float(err.max()) > 2 * len(batches) * STEP_LR
                or loose > max(1, err.numel() // 1000)):
            raise AssertionError(f"card step: {k} max |diff| "
                                 f"{float(err.max())}, {loose} loose")
        worst_par = max(worst_par, float(err.max()))
        n_loose += loose
    if worst_loss > STEP_LOSS_RTOL:
        raise AssertionError(f"card step: loss parts {pg} vs CPU {pc}")
    log(f"two f32 train steps on the card (flow_warp + B1 kernels, RAFT, "
        f"depth, base trained; parity mode) == on the CPU (plain "
        f"versions): loss parts within {worst_loss:.2e} relative (< "
        f"{STEP_LOSS_RTOL}), parameters within {worst_par:.2e} ({n_loose} "
        f"elements beyond 1e-5 of their tensor's scale + 1e-4 lr)")


def phase_train(smi):
    """The training slice: the training CLI in process on the card.

    Run A: full-width TernausNetMulti-Basic, batch 4, T=3, 480x640, frozen
    RAFT (random weights, 12 iterations, bf16 fused update) inside the
    step, depth inputs, the base trained, bf16, grad_accum 2, EMA 0.999,
    nll + soft_jaccard: one epoch of 6 micro-steps (3 updates), validation,
    a checkpoint; the checkpoint (and its EMA) tracks frames in the port's
    engine; an interrupted copy of run A resumes at the right batch. Run B:
    the base frozen, float32, 2 steps. The learning check: the JAX e2e
    recipe at 64x64. B1 is held to its plain version and timed on run A's
    own tensors. Returns (run A's launches, its micro-steps, times,
    bounds, library, B1's max |diff|)."""
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
        init_weights_lecun,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import TrackerConfig, track_on_frames
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.utils.checkpoint import load_state_dict_file

    capture, records = {"trace": True}, []
    real_factory = _probe_train_steps(cli, records, capture)
    summary = {}
    try:
        with tempfile.TemporaryDirectory() as d:
            d = Path(d)
            t0 = time.perf_counter()
            pack = make_synthetic_pack(d / "pack", videos=(
                ("train", 3, 8), ("val", 1, 4)), height=H, width=W, seed=SEED)
            packb = make_synthetic_pack(d / "packb", videos=(
                ("train", 2, 4), ("val", 1, 2)), height=H, width=W,
                seed=SEED + 1)
            log(f"training packs written by the port's generator: 24 + 4 and "
                f"8 + 2 frames at {H}x{W} with depth "
                f"({time.perf_counter() - t0:.1f} s)")

            # ---- run A: the slice --------------------------------------
            a_extra = ["--train_base_model", "True", "--compute_dtype",
                       "bfloat16", "--grad_accum", str(TRAIN_ACCUM),
                       "--ema_decay", "0.999"]
            a_args = _train_args(pack, d, "A", *a_extra)
            torch.cuda.reset_peak_memory_stats()
            _reset_all_launches()
            t0 = time.perf_counter()
            state_a = cli.main(a_args)
            torch.cuda.synchronize()
            launches = _all_launches()
            wall_a = time.perf_counter() - t0
            peak_a = torch.cuda.max_memory_allocated()
            recs_a = list(records)
            n_a = len(recs_a)
            capture.pop("trace")
            log(f"train run A (bf16, base trained, RAFT + depth, accum "
                f"{TRAIN_ACCUM}, EMA): {n_a} micro-steps, "
                f"{state_a.updates} updates, {wall_a:.1f} s with validation "
                f"and checkpoint; launches {json.dumps(launches)}")
            _require_launches("train", launches)
            if n_a != 6 or state_a.updates != 3:
                raise AssertionError(f"run A: 6 micro-steps and 3 updates "
                                     f"expected, got {n_a}, {state_a.updates}")
            for i, r in enumerate(recs_a):
                if not all(np.isfinite(v) for v in r["parts"].values()):
                    raise AssertionError(f"run A step {i}: {r['parts']}")
                upd = (i + 1) % TRAIN_ACCUM == 0
                moved = (r["head_moved"], r["base_moved"], r["ema_moved"])
                if r["update"] != upd or moved != (upd, upd, upd):
                    raise AssertionError(
                        f"run A micro-step {i}: update {r['update']}, "
                        f"head/base/EMA moved {moved}; expected {upd}")
                lc = r["launches"]
                if (lc["flow_warp_bwd"], lc["raft_update"],
                        lc["flow_warp"]) != (1, FLOW_ITERS, 1):
                    raise AssertionError(
                        f"run A micro-step {i}: 1 flow_warp_bwd, "
                        f"{FLOW_ITERS} raft_update and 1 flow_warp expected, "
                        f"got {lc}")
            log("run A: losses finite; head, base and EMA moved on the 3 "
                "updates only; per micro-step 1 flow_warp_bwd, "
                f"{FLOW_ITERS} raft_update, 1 flow_warp: "
                + json.dumps([{k: round(v, 4) for k, v in r["parts"].items()}
                              for r in recs_a]))
            summary["A"] = (recs_a, peak_a)

            # the checkpoint in the port's tracker, raw and EMA weights
            ck = d / "A" / "ckpts" / "model_000.pth"
            frames = synthetic_frames(6)
            gen = torch.Generator().manual_seed(SEED)
            flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
            cfg = TrackerConfig(dtype="bfloat16", decode="device",
                                overlay=False, decode_tie_fallback=False,
                                add_optflow_inputs=True,
                                add_depth_inputs=True)
            for use_ema in (False, True):
                model = get_multiframe_segmentation_model(
                    "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
                    add_depth_inputs=True)
                model.load_state_dict(load_state_dict_file(ck, use_ema))
                rows, _ = track_on_frames(
                    frames, model, cfg, d, name=f"ck{use_ema}",
                    depth_frames=_depth_frames(frames), flow_model=flow_model)
                _check_rows(np.loadtxt(d / f"ck{use_ema}_tracked.csv",
                                       delimiter=","), len(frames))
            log(f"run A's checkpoint ({ck.stat().st_size} B) tracks "
                f"{len(frames)} frames in the port's engine, with its raw and "
                "its EMA weights")

            # an interrupted copy of run A resumes at the right batch
            real_apply = TrainState.apply_gradients

            def interrupt(self):
                if self.step == 3:
                    raise KeyboardInterrupt
                return real_apply(self)

            TrainState.apply_gradients = interrupt
            try:
                cli.main(_train_args(pack, d, "Acut", *a_extra))
                raise AssertionError("the interrupted run did not raise")
            except KeyboardInterrupt:
                pass
            finally:
                TrainState.apply_gradients = real_apply
            meta = json.loads((d / "Acut" / "ckpts" / "model_999.json"
                               ).read_text())
            if meta != {"epoch": 0, "batches_done": 3}:
                raise AssertionError(f"interrupt snapshot: {meta}")
            resumed = cli.main(_train_args(pack, d, "Acut", *a_extra,
                                           "--resume", "True"))
            if (resumed.step, resumed.updates) != (6, 3):
                raise AssertionError(f"resume: step {resumed.step}, updates "
                                     f"{resumed.updates}; expected 6, 3")
            log("run A interrupted in micro-step 4 (mid-update): snapshot "
                "model_999 {epoch 0, batches_done 3} with the accumulated "
                "gradient; --resume True re-entered epoch 0 at batch 3 and "
                "ended at micro-step 6, update 3")

            # ---- run B: base frozen, float32, 2 steps -------------------
            records.clear()
            base0 = init_weights_lecun(get_multiframe_segmentation_model(
                "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
                add_depth_inputs=True), torch.Generator().manual_seed(SEED))
            torch.cuda.reset_peak_memory_stats()
            _reset_all_launches()
            state_b = cli.main(_train_args(packb, d, "B", "--compute_dtype",
                                           "float32"))
            launches_b = _all_launches()
            peak_b = torch.cuda.max_memory_allocated()
            recs_b = list(records)
            sd0, sd1 = base0.state_dict(), state_b.model.state_dict()
            changed = [k for k in sd0 if k.startswith("base_model.")
                       and not torch.equal(sd0[k], sd1[k].cpu())]
            if len(recs_b) != 2 or changed or launches_b["flow_warp_bwd"]:
                raise AssertionError(
                    f"run B: {len(recs_b)} steps, base changed {changed}, "
                    f"flow_warp_bwd launches {launches_b['flow_warp_bwd']}")
            if not all(r["head_moved"] for r in recs_b):
                raise AssertionError("run B: the head did not train")
            log(f"train run B (f32, base frozen, RAFT + depth): 2 steps, base "
                f"bit-identical, flow_warp_bwd never launched; launches "
                f"{json.dumps(launches_b)}")
            summary["B"] = (recs_b, peak_b)

            # ---- run F: run A with FlowFormer++ as the frozen provider --
            records.clear()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_launches()
            t0 = time.perf_counter()
            state_f = cli.main(_train_args(
                pack, d, "F", *a_extra, "--optflow_model",
                "FlowFormerPlusPlus"))
            torch.cuda.synchronize()
            launches_f = _all_launches()
            wall_f = time.perf_counter() - t0
            peak_f = torch.cuda.max_memory_allocated()
            recs_f = list(records)
            _require_launches("train_ffpp", launches_f)
            if len(recs_f) != 6 or state_f.updates != 3:
                raise AssertionError(f"run F: 6 micro-steps and 3 updates "
                                     f"expected, got {len(recs_f)}, "
                                     f"{state_f.updates}")
            for i, r in enumerate(recs_f):
                lc = r["launches"]
                if not all(np.isfinite(v) for v in r["parts"].values()) or (
                        lc["flow_warp_bwd"], lc["raft_update"],
                        lc["flow_warp"]) != (1, 0, 1):
                    raise AssertionError(
                        f"run F micro-step {i}: finite losses, 1 "
                        f"flow_warp_bwd, 0 raft_update and 1 flow_warp "
                        f"expected, got {r['parts']}, {lc}")
            log(f"train run F (run A with --optflow_model FlowFormerPlusPlus:"
                f" 8 pairs of 60x80 = 4,800 tokens a micro-step through "
                f"FFPP, bf16): {len(recs_f)} micro-steps, {state_f.updates} "
                f"updates, {wall_f:.1f} s with validation and checkpoint; "
                f"losses finite; per micro-step 1 flow_warp_bwd, 1 flow_warp, "
                f"0 raft_update; launches {json.dumps(launches_f)}")
            summary["F"] = (recs_f, peak_f)

            # ---- the learning check ------------------------------------
            lpack = make_synthetic_pack(d / "learn_pack", videos=(
                ("train", 2, 12), ("val", 2, 12)), height=LEARN_HW,
                width=LEARN_HW, seed=3, add_depth=False)
            ratios, curves = [], []
            for seed in LEARN_SEEDS:
                name = f"learn{seed}"
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main([
                        "--dataset", "JIGSAWS", "--packed_dir", str(lpack),
                        "--expt_savedir", str(d), "--expt_name", name,
                        "--batch_size", "4", "--num_workers", "2",
                        "--num_epochs", str(LEARN_EPOCHS), "--save_freq",
                        str(LEARN_EPOCHS), "--print_freq", "100",
                        "--lr", "3e-3", "--scheduler", "Constant",
                        "--loss_fns", "nll", "soft_jaccard",
                        "--loss_wts", "0.7", "0.3",
                        "--class_weights", "1", "50", "50", "50", "50",
                        "--input_height", str(LEARN_HW),
                        "--input_width", str(LEARN_HW),
                        "--model_scale", "0.25", "--train_base_model",
                        "true", "--seed", str(seed)])
                scalars = [json.loads(line) for line in (
                    d / name / "logs" / "scalars.jsonl").read_text().split(
                        "\n") if line]
                losses = [s["value"] for s in scalars
                          if s["tag"] == "Training/Loss"]
                ratios.append(losses[-1] / losses[0])
                curves.append([round(v, 3) for v in losses])
            med = float(np.median(ratios))
            log(f"learning check (tests/test_e2e_learning.py's recipe, "
                f"{LEARN_HW}x{LEARN_HW}, scale 0.25, {LEARN_EPOCHS + 1} "
                f"epochs, seeds {LEARN_SEEDS}): training loss by epoch "
                f"{curves}, last/first {[round(r, 3) for r in ratios]}, "
                f"median {med:.3f} (< {LEARN_RATIO})")
            if not med < LEARN_RATIO:
                raise AssertionError("the learning check failed")
    finally:
        cli.make_multiframe_train_step = real_factory

    _check_step_on_card()
    err = _check_flow_warp_bwd(capture)
    times, bounds, library = _time_flow_warp_bwd(capture, smi)
    traced = [r for r in summary["A"][0] if r["events"]]
    if len(traced) != 1:
        raise AssertionError("run A: one traced micro-step expected")
    _step_breakdown(traced[0]["events"], traced[0]["traced_wall"], smi)
    for run, dt in (("A", "bf16"), ("B", "f32"), ("F", "bf16, FFPP")):
        recs, peak = summary[run]
        warm = [(i + 1, r["ms"]) for i, r in enumerate(recs)
                if i >= min(2, len(recs) - 1) and not r["events"]]
        med = float(np.median([ms for _, ms in warm]))
        log(f"[{smi}] train run {run} ({dt}): step median {med:.2f} ms over "
            f"micro-steps {[i for i, _ in warm]} (all: "
            f"{[round(r['ms'], 1) for r in recs]}; the traced one under the "
            f"profiler), {TRAIN_B / med * 1e3:.2f} samples/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    return (launches, n_a, times, bounds, library, err,
            (launches_f, len(summary["F"][0])))


#: the zoo slice: the four families' Basic models at full width on the RAFT
#: path, incremental over ZOO_FRAMES and full over ZOO_FULL; SegFormer's
#: Large over ZOO_LARGE_FRAMES; frames/s without flow over
#: ZOO_TIMED_FRAMES, two calls; run Z's micro-steps
ZOO_FAMILIES = ("DeepLab", "FCN", "HRNet", "SegFormer")
ZOO_FRAMES, ZOO_FULL, ZOO_LARGE_FRAMES, ZOO_TIMED_FRAMES = 12, 5, 8, 24
ZOO_STEPS = 4
#: forwards that set a random base's running statistics near its batch
#: statistics on the synthetic frames (each moves them 0.1 of the way):
#: with the PyTorch defaults (mean 0, var 1) the random models' BN layers
#: would pass activations unnormalized and the class maps would carry
#: little of the frames
ZOO_BN_PASSES = 20
#: the std of a calibrated random base's logits on the synthetic frames,
#: set by scaling its last convolution (the gain is printed: unscaled, a
#: random base's logits spread over hundredths and its map is nearly one
#: class, which leaves the fusion head and the decode almost nothing; a
#: trained model's spread over several units)
ZOO_LOGIT_STD = 3.0
#: HRNetMulti-Basic's float32 forward on the card (TF32 off) against the
#: same model on the CPU, one window of three 480x640 frames: max |logit
#: difference| <= ZOO_F32_TOL * max |logit| (float32 sums in other orders
#: through ~300 BN'd convolutions; set before the first run)
ZOO_F32_TOL = 1e-4


def _calibrate_bn(base, x):
    """``ZOO_BN_PASSES`` forwards of ``base`` on the normalized NCHW frames
    ``x`` with only its BN layers in train mode, under ``no_grad``; eval
    mode after."""
    import torch

    base.eval()
    for m in base.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.train()
    with torch.no_grad():
        for _ in range(ZOO_BN_PASSES):
            base(x)
    base.eval()


def _zoo_model(model_type, gen, x, **kw):
    """A full-width zoo model from the registry (seeded PyTorch-default
    weights) on the card: its base's running statistics calibrated on the
    normalized frames ``x``, its last convolution scaled to give logits
    of std ``ZOO_LOGIT_STD`` there."""
    import torch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    model = get_multiframe_segmentation_model(model_type, C, T, generator=gen,
                                              **kw).cuda()
    _calibrate_logits(model_type, model.base_model, x)
    return model


def _calibrate_logits(name, base, x):
    """A random zoo base's running statistics calibrated on the normalized
    frames ``x`` (``_calibrate_bn``), its last convolution scaled to give
    logits of std ``ZOO_LOGIT_STD`` there."""
    import torch

    _calibrate_bn(base, x)
    last = [m for m in base.modules() if isinstance(m, torch.nn.Conv2d)
            and m.out_channels == C][-1]
    seen = []
    hook = last.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        base(x)
        hook.remove()
        gain = ZOO_LOGIT_STD / seen[0].std().item()
        last.weight.mul_(gain)
        if last.bias is not None:
            last.bias.mul_(gain)
    log(f"{name}: base BN statistics calibrated ({ZOO_BN_PASSES} "
        f"passes), logits scaled by {gain:.4g} to std {ZOO_LOGIT_STD}")


def _base_head_ms(name, engine, frames, smi):
    """ms of one bf16 base forward of a 480x640 frame and of one head call
    on the ring: device time (CUDA-graph replay) and eager (CUDA events
    around 10 calls: the host's enqueue time shows where it exceeds the
    device's)."""
    import torch

    x1 = engine._normalize(frames[:1])
    seg = torch.zeros(1, T * C, H, W, dtype=engine.dtype, device="cuda")

    def base():
        engine.model.base_nchw(x1)

    def head():
        engine.model.fuse_nchw(seg)

    with torch.no_grad():
        (bg, be), (hg, he) = [(_graph_ms(f, reps=2, rounds=5),
                               _event_ms(f, 10)) for f in (base, head)]
    log(f"[{smi}] {name}, bf16, one 480x640 frame: base forward {bg:.3f} "
        f"ms device (graph replay), {be:.3f} ms eager ({be / bg:.2f}x); "
        f"head {hg:.3f} ms device, {he:.3f} ms eager")


def _time_aspp(model, smi):
    """DeepLab's three ASPP convolutions at the base's shape (one frame:
    2048 x 60 x 80, bf16): cuDNN's dilated convolution on a channels-last
    input (the engine's layout: its frames are NHWC permuted to NCHW, and
    cuDNN keeps that layout) and on a contiguous one, against
    ``models/deeplab.py::atrous_conv2d`` (graph replay), and the largest
    difference between the two."""
    import torch
    import torch.nn.functional as F

    from mfcnet_tpu_torch.models.deeplab import atrous_conv2d

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(1, 2048, H // 8, W // 8, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    xl = x.contiguous(memory_format=torch.channels_last)
    for conv in model.base_model.classifier[0].convs[1:4]:
        w, r = conv[0].weight.detach().bfloat16(), conv[0].dilation[0]
        with torch.no_grad():
            diff = (F.conv2d(x, w, padding=r, dilation=r).float()
                    - atrous_conv2d(xl, w, r).float()).abs().max().item()
            ms = [_graph_ms(lambda f=f: f(), reps=2, rounds=2) for f in (
                lambda: F.conv2d(xl, w, padding=r, dilation=r),
                lambda: F.conv2d(x, w, padding=r, dilation=r),
                lambda: atrous_conv2d(xl, w, r))]
        log(f"[{smi}] DeepLab ASPP rate {r}, bf16 2048x60x80 -> 256: cuDNN "
            f"dilated {ms[0]:.3f} ms channels-last (the engine's layout), "
            f"{ms[1]:.3f} ms contiguous; phase sub-grids {ms[2]:.3f} ms "
            f"(device time); max |diff| {diff:.4g}")


@contextlib.contextmanager
def _timed_train_steps(cli):
    """Within the block the training CLI module ``cli`` builds train steps
    that record each micro-step's host ms (synchronized), loss parts and
    kernel launches into the list yielded."""
    import torch

    recs = []
    real = cli.make_multiframe_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def timed(state, batch):
            c0 = _all_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = step(state, batch)
            torch.cuda.synchronize()
            recs.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "parts": {k: float(v) for k, v in parts.items()},
                         "launches": {k: v - c0[k] for k, v in
                                      _all_launches().items()}})
            return parts

        return timed

    cli.make_multiframe_train_step = make
    try:
        yield recs
    finally:
        cli.make_multiframe_train_step = real


def _run_z(smi):
    """Run Z: DeepLabMulti-Basic through the training CLI at full width,
    480x640, batch 4, bf16, the base trained, frozen RAFT (bf16 fused
    update) and depth in the step, grad_accum 2, ``ZOO_STEPS``
    micro-steps; its checkpoint tracks frames through the tracker CLI's
    loader and the registry's ``--model_type DeepLabMulti-Basic`` (the
    card has no OpenCV for the CLI's video reader). Then the single-frame
    CLI trains SegFormer for 2 steps at batch 4, drop-path on. Returns
    (run Z's launches, its micro-steps)."""
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli import test_multiframe_segmentation_on_videos
    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.cli import train_toolpose_segmentation as sf_cli
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.common import DropPath
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import TrackerConfig, track_on_frames

    with _timed_train_steps(cli) as recs, \
            tempfile.TemporaryDirectory() as d:
        d = Path(d)
        pack = make_synthetic_pack(d / "pack", videos=(
            ("train", 2, 8), ("val", 1, 4)), height=H, width=W,
            seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        t0 = time.perf_counter()
        state = cli.main(_train_args(
            pack, d, "Z", "--model_type", "DeepLabMulti-Basic",
            "--train_base_model", "True", "--compute_dtype", "bfloat16",
            "--grad_accum", str(TRAIN_ACCUM)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_launches()
        peak = torch.cuda.max_memory_allocated()
        _require_launches("train_zoo", launches)
        if len(recs) != ZOO_STEPS or state.updates != ZOO_STEPS // 2:
            raise AssertionError(f"run Z: {ZOO_STEPS} micro-steps and "
                                 f"{ZOO_STEPS // 2} updates expected, got "
                                 f"{len(recs)}, {state.updates}")
        for i, r in enumerate(recs):
            lc = r["launches"]
            if not all(np.isfinite(v) for v in r["parts"].values()) or (
                    lc["flow_warp_bwd"], lc["raft_update"],
                    lc["flow_warp"]) != (1, FLOW_ITERS, 1):
                raise AssertionError(f"run Z micro-step {i}: {r}")
        warm = [r["ms"] for r in recs[1:]]
        log(f"[{smi}] train run Z (DeepLabMulti-Basic, bf16, base "
            f"trained, RAFT + depth, batch {TRAIN_B}, accum "
            f"{TRAIN_ACCUM}): {len(recs)} micro-steps "
            f"{[round(r['ms'], 2) for r in recs]} ms (median of 2-"
            f"{len(recs)}: {float(np.median(warm)):.2f} ms, "
            f"{TRAIN_B / float(np.median(warm)) * 1e3:.2f} samples/s), "
            f"peak memory {peak / 2 ** 30:.2f} GiB, {wall:.1f} s with "
            f"validation and checkpoint; per micro-step 1 flow_warp_bwd, "
            f"{FLOW_ITERS} raft_update, 1 flow_warp; losses "
            + json.dumps([{k: round(v, 4) for k, v in r["parts"].items()}
                          for r in recs]))

        ck = d / "Z" / "ckpts" / "model_000.pth"
        model = get_multiframe_segmentation_model(
            "DeepLabMulti-Basic", C, T, add_optflow_inputs=True,
            add_depth_inputs=True)
        model.load_state_dict(test_multiframe_segmentation_on_videos
                              .load_reference_state_dict(ck))
        frames = synthetic_frames(6)
        flow_model = init_weights(RAFT(iters=FLOW_ITERS),
                                  torch.Generator().manual_seed(SEED))
        cfg = TrackerConfig(dtype="bfloat16", decode="device",
                            overlay=False, decode_tie_fallback=False,
                            add_optflow_inputs=True,
                            add_depth_inputs=True)
        track_on_frames(frames, model, cfg, d, name="z",
                        depth_frames=_depth_frames(frames),
                        flow_model=flow_model)
        _check_rows(np.loadtxt(d / "z_tracked.csv", delimiter=","),
                    len(frames), detect=False)
        log(f"run Z's checkpoint ({ck.stat().st_size} B) tracks "
            f"{len(frames)} frames as DeepLabMulti-Basic")

        spack = make_synthetic_pack(d / "spack", videos=(
            ("train", 1, 8), ("val", 1, 4)), height=H, width=W,
            seed=SEED)
        sf = sf_cli.main([
            "--dataset", "JIGSAWS", "--packed_dir", str(spack),
            "--expt_savedir", str(d), "--expt_name", "S",
            "--model_type", "SegFormer", "--batch_size", str(TRAIN_B),
            "--num_workers", "4", "--num_epochs", "0", "--print_freq",
            "100", "--input_height", str(H), "--input_width", str(W),
            "--compute_dtype", "bfloat16", "--seed", str(SEED)])
        dp = [m for m in sf.model.modules() if isinstance(m, DropPath)]
        if sf.step != 2 or not any(m.rate > 0 for m in dp) or not all(
                torch.isfinite(p).all() for p in sf.model.parameters()):
            raise AssertionError(f"single-frame SegFormer: {sf.step} "
                                 "steps, finite weights and drop-path "
                                 "expected")
        log(f"single-frame CLI: SegFormer (MiT-B3, {len(dp)} blocks with "
            f"drop-path up to {max(m.rate for m in dp):.2f}) trained "
            f"{sf.step} steps at batch {TRAIN_B}, bf16, {H}x{W}")
    return launches, len(recs)


def phase_zoo_slice(noflow_engine, frames, smi):
    """The zoo slice at full width, 480x640, T=3, C=5, bf16, device decode,
    seeded weights (each base's running statistics calibrated on the
    frames, ``_calibrate_bn``), RAFT x12 with the fused update step: each
    family's Basic model incremental over ``ZOO_FRAMES`` (its launches
    counted) and full over ``ZOO_FULL``; for HRNetMulti-Basic the kernels
    against their plain versions, f32 incremental == full, and its f32
    forward on the card against the CPU; SegFormerMulti-Large with RAFT
    and depth (no warp); frames/s without flow; the base forward's and
    the head's device ms (and TernausNet16's, from ``noflow_engine``);
    run Z and the single-frame SegFormer run. Returns ({path: (launches,
    fused frames or micro-steps)})."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    ncfg = dataclasses.replace(cfg, add_optflow_inputs=False)
    xcal = noflow_engine._normalize(frames[:4]).float()
    paths = {}

    _base_head_ms("TernausNet16", noflow_engine, frames, smi)
    with tempfile.TemporaryDirectory() as d:
        for fam in ZOO_FAMILIES:
            mt = f"{fam}Multi-Basic"
            t0 = time.perf_counter()
            model = _zoo_model(mt, gen, xcal, add_optflow_inputs=True)
            n_params = sum(p.numel() for p in model.parameters())
            n_bn = sum(isinstance(m, torch.nn.BatchNorm2d)
                       for m in model.base_model.modules())
            engine = InferenceEngine(model, cfg, flow_model=flow_model)
            n, fused = ZOO_FRAMES, ZOO_FRAMES - (T - 1)
            dd.reset_tier_counts()
            _reset_all_launches()
            _, fps = track_on_frames(frames[:n], None, cfg, d, name=fam,
                                     engine=engine)
            launches = _all_launches()
            tiers = dict(dd.TIER_COUNTS)
            rows = np.loadtxt(Path(d) / f"{fam}_tracked.csv", delimiter=",")
            # random weights need not detect a tool: rows are checked for
            # shape, warm-up and range, and their detections counted
            _check_rows(rows, n, detect=False)
            path = f"zoo_{fam.lower()}"
            _require_launches(path, launches)
            if launches["raft_update"] != FLOW_ITERS * fused \
                    or launches["flow_warp"] != fused \
                    or ru.COUNTS["hx_fills"] != fused:
                raise AssertionError(
                    f"{mt}: expected {FLOW_ITERS} update steps, 1 fill of hx "
                    f"and 1 warp per fused frame ({fused} frames), got "
                    f"{launches}, {ru.COUNTS}")
            paths[path] = (launches, fused)
            track_on_frames(frames[:ZOO_FULL], model,
                            dataclasses.replace(cfg, mode="full"), d,
                            name=f"{fam}_full", flow_model=flow_model,
                            device="cuda")
            _check_rows(np.loadtxt(Path(d) / f"{fam}_full_tracked.csv",
                                   delimiter=","), ZOO_FULL, detect=False)
            detected = int(np.isfinite(rows).any(axis=1).sum())
            log(f"{mt}: full width, {n_params} parameters, {n_bn} BN layers "
                f"in the base, + RAFT x{FLOW_ITERS}: {n} frames incremental "
                f"(first run, with warm-up: {fps:.2f} frames/s), "
                f"{ZOO_FULL} full -> CSVs ({detected} rows with a "
                f"detection); decode tiers {json.dumps(tiers)}; "
                f"launches {json.dumps(launches)} "
                f"({time.perf_counter() - t0:.1f} s)")

            if fam == "HRNet":
                # the head resamples raw logits of std ZOO_LOGIT_STD by the
                # flow, not TernausNet's probabilities in [0, 1]: a flipped
                # bf16 rounding in the update step moves them as the Large
                # head's raw flow channels move its output
                _compare_with_plain_kernels(
                    mt, engine, InferenceEngine(model, cfg,
                                                flow_model=flow_model),
                    frames, _plain_flow_kernels,
                    lambda e: out.flow_from_feature_ring(
                        *e.flow_state, (H, W), e.flow_model),
                    prob_tol=LARGE_PROB_TOL)
                with parity_mode():
                    c32 = dataclasses.replace(cfg, dtype="float32")
                    engines = {m: InferenceEngine(
                        model, dataclasses.replace(c32, mode=m),
                        flow_model=flow_model, device="cuda")
                        for m in ("incremental", "full")}
                    _parity_incremental_full(mt, engines, frames)
                    rows = {m: track_on_frames(frames[:ZOO_FRAMES], None,
                                               e.cfg, d, name=f"p{m}",
                                               engine=e)[0]
                            for m, e in engines.items()}
                    rmse, nan_rows = _tip_rmse(rows["incremental"],
                                               rows["full"])
                    log(f"{mt}, f32 parity mode, incremental vs full, "
                        f"{ZOO_FRAMES}-frame rows: tip RMSE {rmse:.4g} px, "
                        f"{nan_rows} rows whose detections differ")
                    if rmse > 0.5:
                        raise AssertionError(f"{mt}: tip RMSE {rmse} px")
                    x = xcal[:T].permute(0, 2, 3, 1)[None].contiguous()
                    with torch.no_grad():
                        got = model(x).float().cpu()
                        n_threads = torch.get_num_threads()
                        torch.set_num_threads(8)
                        want = copy.deepcopy(model).cpu()(x.cpu())
                        torch.set_num_threads(n_threads)
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    log(f"{mt} f32 forward (TF32 off), card vs CPU, one "
                        f"window of {T} frames: max |logit diff| {err:.4g} "
                        f"of max |logit| {scale:.4g} (limit {ZOO_F32_TOL} "
                        "of it)")
                    if not err <= ZOO_F32_TOL * scale:
                        raise AssertionError(f"{mt}: card and CPU disagree")

            # frames/s at B=1 without flow, two calls; device ms alone
            nf = InferenceEngine(model, ncfg)
            rates = [track_on_frames(frames[:ZOO_TIMED_FRAMES], None, ncfg,
                                     d, name=f"{fam}_t{i}", engine=nf)[1]
                     for i in range(2)]
            log(f"[{smi}] {mt} without flow, incremental bf16, device "
                f"decode, B=1: {rates[0]:.2f}, {rates[1]:.2f} frames/s "
                f"({ZOO_TIMED_FRAMES} frames a call)")
            _base_head_ms(fam, nf, frames, smi)
            if fam == "DeepLab":
                _time_aspp(model, smi)
            del model, engine, nf
            torch.cuda.empty_cache()

        # SegFormerMulti-Large with RAFT and depth: no warp
        lcfg = dataclasses.replace(cfg, add_depth_inputs=True)
        model = _zoo_model("SegFormerMulti-Large", gen, xcal,
                           add_optflow_inputs=True, add_depth_inputs=True)
        n = ZOO_LARGE_FRAMES
        _reset_all_launches()
        track_on_frames(frames[:n], model, lcfg, d, name="segl",
                        depth_frames=_depth_frames(frames[:n]),
                        flow_model=flow_model, device="cuda")
        launches = _all_launches()
        _check_rows(np.loadtxt(Path(d) / "segl_tracked.csv", delimiter=","),
                    n, detect=False)
        _require_launches("zoo_large", launches)
        if launches["flow_warp"] != 0:
            raise AssertionError("SegFormerMulti-Large warps nothing: "
                                 f"{launches['flow_warp']} flow_warp")
        paths["zoo_large"] = (launches, n - (T - 1))
        log(f"SegFormerMulti-Large + RAFT + depth: {n} frames incremental, "
            f"0 flow_warp; launches {json.dumps(launches)}")
        del model
        torch.cuda.empty_cache()
    paths["train_zoo"] = _run_z(smi)
    return paths


#: the rest of the zoo (ROADMAP item 10b): UNetMulti-Basic and
#: ResUNetMulti-Basic at full width on the RAFT path (as ``phase_zoo_slice``
#: runs the families of item 10a), ResUNetMulti-Large over ZOO_LARGE_FRAMES,
#: TAPNet16's ``tapnet`` step TAP_STEPS times, run U's micro-steps; the
#: card's float32 TAPNet16 forward is held to the CPU's on one TAP_CPU_HW
#: frame (the CPU forward at 480x640 takes seconds; TAPNet's sizes are
#: multiples of 32)
ZOO10B_FAMILIES = ("UNet", "ResUNet")
TAP_STEPS, TAP_CPU_HW = 3, (256, 320)
#: cal_attmap_batched through the flow warp against its plain route: the
#: float32 warp is bit-equal (WARP_ATOL), the max filter exact
ATTMAP_TOL = WARP_ATOL["float32"]


def _attmap_checks(flow, att, smi):
    """TAPNet's attention map on the card at 480x640: ``cal_attmap_scatter``
    against the numpy reference ``cal_attmap_np`` bit for bit, and
    ``cal_attmap_batched`` (one ``flow_warp`` launch) against its plain
    route. ``flow`` (H, W, 2) float32 on the card (a RAFT flow), ``att``
    (H, W) float32 in [0, 1]. Returns the batched form's launches."""
    import torch

    from mfcnet_tpu_torch.data.attmap import (
        cal_attmap_batched,
        cal_attmap_np,
        cal_attmap_scatter,
        max_filter_10,
    )
    from mfcnet_tpu_torch.ops import warp

    a, f = torch.from_numpy(att)[None].cuda(), flow[None].float()
    got = cal_attmap_scatter(a, f)[0].cpu().numpy()
    want = cal_attmap_np(att, f[0].cpu().numpy())
    if not np.array_equal(got, want):
        raise AssertionError("cal_attmap_scatter on the card != cal_attmap_np "
                             f"at {int((got != want).sum())} pixels")
    _reset_all_launches()
    approx = cal_attmap_batched(a, f)
    launches = _all_launches()
    plain = max_filter_10(warp.flow_warp_plain(
        a[:, None], -f.permute(0, 3, 1, 2))[:, 0])
    err = (approx - plain).abs().max().item()
    gap = np.abs(approx[0].cpu().numpy() - want)
    scatter_ms = _event_ms(lambda: cal_attmap_scatter(a, f), 5)
    batched_ms = _event_ms(lambda: cal_attmap_batched(a, f), 5)
    log(f"[{smi}] attention map, {H}x{W}, a RAFT flow of max "
        f"{f.abs().max().item():.4g} px: cal_attmap_scatter on the card "
        f"equals cal_attmap_np bit for bit ({scatter_ms:.3f} ms eager); "
        f"cal_attmap_batched {batched_ms:.3f} ms eager ({launches['flow_warp']}"
        f" flow_warp), max |diff| to its plain route {err:.3g} (limit "
        f"{ATTMAP_TOL}); against the exact map max {gap.max():.4g}, mean "
        f"{gap.mean():.4g} (the approximation, as in the JAX package)")
    if launches["flow_warp"] != 1 or not err <= ATTMAP_TOL:
        raise AssertionError("cal_attmap_batched: kernel and plain route "
                             "disagree")
    return launches


def _tapnet_checks(frames, smi):
    """TAPNet16 at full width: ``TAP_STEPS`` bf16 ``tapnet`` train steps
    at batch ``TRAIN_B``, 480x640 (the image and an attention map; ms and
    peak memory), and its float32 forward on the card (TF32 off) against
    the CPU's on one ``TAP_CPU_HW`` frame, within ``ZOO_F32_TOL`` of the
    largest |log-probability|."""
    import torch

    from mfcnet_tpu_torch.models import (
        get_tooltip_segmentation_model,
        init_weights_lecun,
    )
    from mfcnet_tpu_torch.ops.resize import resize_bilinear
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_singleframe_train_step
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    model = init_weights_lecun(get_tooltip_segmentation_model("TAPNet16", C),
                               torch.Generator().manual_seed(SEED)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.from_numpy(frames[:TRAIN_B]).cuda().float() / 255.0
    att = x.mean(-1, keepdim=True)
    image = torch.cat([(x - 0.45) / 0.225, att], -1)
    mask = (x[..., 0] * (C - 1)).round().long()
    state = TrainState(model, lambda i: 1e-4, split_base=False)
    step = make_singleframe_train_step(
        ["nll", "soft_jaccard"], [0.7, 0.3], C, class_weights=[1] + [50] * 4,
        compute_dtype="bfloat16", output_mode="tapnet")
    torch.cuda.reset_peak_memory_stats()
    ms, parts = [], []
    for _ in range(TAP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, {"image": image, "mask": mask})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(float(out["loss_total"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(parts)) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"TAPNet16 train steps: {parts}")
    log(f"[{smi}] TAPNet16 ({n_params} parameters) tapnet train step, bf16, "
        f"batch {TRAIN_B}, {H}x{W}: {[round(m, 2) for m in ms]} ms "
        f"(first with warm-up), {TRAIN_B / ms[-1] * 1e3:.2f} samples/s, "
        f"peak memory {peak:.2f} GiB; losses {[round(v, 4) for v in parts]}")

    h, w = TAP_CPU_HW
    xi = resize_bilinear(image[:1].permute(0, 3, 1, 2), h, w)
    with parity_mode(), torch.no_grad():
        model.eval()
        got = model(xi[:, :3], xi[:, 3:]).float().cpu()
        n_threads = torch.get_num_threads()
        torch.set_num_threads(8)
        xc = xi.cpu()
        want = copy.deepcopy(model).cpu()(xc[:, :3], xc[:, 3:])
        torch.set_num_threads(n_threads)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"TAPNet16 f32 forward (TF32 off), card vs CPU, one {h}x{w} frame: "
        f"max |log-probability diff| {err:.4g} of max {scale:.4g} (limit "
        f"{ZOO_F32_TOL} of it)")
    if not err <= ZOO_F32_TOL * scale:
        raise AssertionError("TAPNet16: card and CPU disagree")
    return float(np.median(ms[1:])), peak


def _run_u(smi):
    """Run U: UNetMulti-Basic through the training CLI at full width,
    480x640, batch 4, bf16, the base trained, frozen RAFT (bf16 fused
    update) and depth in the step, grad_accum 2, 2 micro-steps (one
    update); B1 must launch once a micro-step. Returns (launches,
    micro-steps, median ms, peak GiB)."""
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    n = TRAIN_B * TRAIN_ACCUM
    with _timed_train_steps(cli) as recs, \
            tempfile.TemporaryDirectory() as d:
        d = Path(d)
        pack = make_synthetic_pack(d / "pack", videos=(
            ("train", 1, n), ("val", 1, 2)), height=H, width=W, seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        state = cli.main(_train_args(
            pack, d, "U", "--model_type", "UNetMulti-Basic",
            "--train_base_model", "True", "--compute_dtype", "bfloat16",
            "--grad_accum", str(TRAIN_ACCUM)))
        torch.cuda.synchronize()
        launches = _all_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _require_launches("train_unet", launches)
    if len(recs) != TRAIN_ACCUM or state.updates != 1:
        raise AssertionError(f"run U: {TRAIN_ACCUM} micro-steps and one "
                             f"update expected, got {len(recs)}, "
                             f"{state.updates}")
    for i, r in enumerate(recs):
        lc = r["launches"]
        if not all(np.isfinite(v) for v in r["parts"].values()) or (
                lc["flow_warp_bwd"], lc["raft_update"],
                lc["flow_warp"]) != (1, FLOW_ITERS, 1):
            raise AssertionError(f"run U micro-step {i}: {r}")
    ms = [r["ms"] for r in recs]
    log(f"[{smi}] train run U (UNetMulti-Basic, bf16, base trained, RAFT + "
        f"depth, batch {TRAIN_B}, accum {TRAIN_ACCUM}): micro-steps "
        f"{[round(m, 2) for m in ms]} ms (the first with warm-up), peak "
        f"memory {peak:.2f} GiB; per micro-step 1 flow_warp_bwd, "
        f"{FLOW_ITERS} raft_update, 1 flow_warp; losses "
        + json.dumps([{k: round(v, 4) for k, v in r["parts"].items()}
                      for r in recs]))
    return launches, len(recs), ms[-1], peak


def phase_zoo10b_slice(noflow_engine, frames, smi):
    """The rest of the zoo (ROADMAP item 10b) at full width, 480x640, T=3,
    C=5, bf16, device decode, seeded weights (BN statistics calibrated and
    the last convolution scaled, ``_zoo_model``), RAFT x12 with the fused
    update step: UNetMulti-Basic and ResUNetMulti-Basic incremental over
    ``ZOO_FRAMES`` (launches counted: 12 update steps, 1 warp a frame) and
    full over ``ZOO_FULL``, each through the kernels against the plain
    versions and f32 incremental against full; frames/s without flow at
    B=1; the base forward's and the head's device ms; ResUNetMulti-Large
    with RAFT and depth (no warp); TAPNet's attention map on a RAFT flow
    (``_attmap_checks``); TAPNet16's train step and f32 forward
    (``_tapnet_checks``); run U (``_run_u``). Returns ({path: (launches,
    fused frames or micro-steps)})."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track import outputs as out
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    flow_model = init_weights(RAFT(iters=FLOW_ITERS), gen)
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False, add_optflow_inputs=True)
    ncfg = dataclasses.replace(cfg, add_optflow_inputs=False)
    paths = {}

    def window_flow(e):
        return out.flow_from_feature_ring(*e.flow_state, (H, W),
                                          e.flow_model)

    xcal = noflow_engine._normalize(frames[:4]).float()
    with tempfile.TemporaryDirectory() as d:
        for fam in ZOO10B_FAMILIES:
            mt = f"{fam}Multi-Basic"
            t0 = time.perf_counter()
            model = _zoo_model(mt, gen, xcal, add_optflow_inputs=True)
            n_params = sum(p.numel() for p in model.parameters())
            engine = InferenceEngine(model, cfg, flow_model=flow_model)
            n, fused = ZOO_FRAMES, ZOO_FRAMES - (T - 1)
            dd.reset_tier_counts()
            _reset_all_launches()
            _, fps = track_on_frames(frames[:n], None, cfg, d, name=fam,
                                     engine=engine)
            launches = _all_launches()
            tiers = dict(dd.TIER_COUNTS)
            rows = np.loadtxt(Path(d) / f"{fam}_tracked.csv", delimiter=",")
            _check_rows(rows, n, detect=False)
            path = f"zoo_{fam.lower()}"
            _require_launches(path, launches)
            if launches["raft_update"] != FLOW_ITERS * fused \
                    or launches["flow_warp"] != fused \
                    or ru.COUNTS["hx_fills"] != fused:
                raise AssertionError(
                    f"{mt}: expected {FLOW_ITERS} update steps, 1 fill of hx "
                    f"and 1 warp per fused frame ({fused} frames), got "
                    f"{launches}, {ru.COUNTS}")
            paths[path] = (launches, fused)
            track_on_frames(frames[:ZOO_FULL], model,
                            dataclasses.replace(cfg, mode="full"), d,
                            name=f"{fam}_full", flow_model=flow_model,
                            device="cuda")
            _check_rows(np.loadtxt(Path(d) / f"{fam}_full_tracked.csv",
                                   delimiter=","), ZOO_FULL, detect=False)
            detected = int(np.isfinite(rows).any(axis=1).sum())
            log(f"{mt}: full width, {n_params} parameters, + RAFT "
                f"x{FLOW_ITERS}: {n} frames incremental (first run, with "
                f"warm-up: {fps:.2f} frames/s), {ZOO_FULL} full -> CSVs "
                f"({detected} rows with a detection); decode tiers "
                f"{json.dumps(tiers)}; launches {json.dumps(launches)} "
                f"({time.perf_counter() - t0:.1f} s)")
            # raw logits of std ZOO_LOGIT_STD resampled by the flow: the
            # limit of HRNet's and the Large head's (phase_zoo_slice)
            _compare_with_plain_kernels(
                mt, engine, InferenceEngine(model, cfg,
                                            flow_model=flow_model),
                frames, _plain_flow_kernels, window_flow,
                prob_tol=LARGE_PROB_TOL)
            if fam == "UNet":
                att = frames[T - 1].mean(-1).astype(np.float32) / 255.0
                with torch.no_grad():
                    flow = window_flow(engine)[0, 0].permute(1, 2, 0)
                paths["attmap"] = (_attmap_checks(
                    flow.float().contiguous(), att, smi), 1)
            with parity_mode():
                c32 = dataclasses.replace(cfg, dtype="float32")
                _parity_incremental_full(mt, {m: InferenceEngine(
                    model, dataclasses.replace(c32, mode=m),
                    flow_model=flow_model, device="cuda")
                    for m in ("incremental", "full")}, frames)
            nf = InferenceEngine(model, ncfg)
            rates = [track_on_frames(frames[:ZOO_TIMED_FRAMES], None, ncfg,
                                     d, name=f"{fam}_t{i}", engine=nf)[1]
                     for i in range(2)]
            log(f"[{smi}] {mt} without flow, incremental bf16, device "
                f"decode, B=1: {rates[0]:.2f}, {rates[1]:.2f} frames/s "
                f"({ZOO_TIMED_FRAMES} frames a call)")
            _base_head_ms(fam, nf, frames, smi)
            del model, engine, nf
            torch.cuda.empty_cache()

        # ResUNetMulti-Large with RAFT and depth: no warp
        lcfg = dataclasses.replace(cfg, add_depth_inputs=True)
        model = _zoo_model("ResUNetMulti-Large", gen, xcal,
                           add_optflow_inputs=True, add_depth_inputs=True)
        n = ZOO_LARGE_FRAMES
        _reset_all_launches()
        track_on_frames(frames[:n], model, lcfg, d, name="resl",
                        depth_frames=_depth_frames(frames[:n]),
                        flow_model=flow_model, device="cuda")
        launches = _all_launches()
        _check_rows(np.loadtxt(Path(d) / "resl_tracked.csv", delimiter=","),
                    n, detect=False)
        _require_launches("zoo_resunet_large", launches)
        if launches["flow_warp"] != 0:
            raise AssertionError("ResUNetMulti-Large warps nothing: "
                                 f"{launches['flow_warp']} flow_warp")
        paths["zoo_resunet_large"] = (launches, n - (T - 1))
        log(f"ResUNetMulti-Large + RAFT + depth: {n} frames incremental, "
            f"0 flow_warp; launches {json.dumps(launches)}")
        del model
        torch.cuda.empty_cache()
    _tapnet_checks(frames, smi)
    torch.cuda.empty_cache()
    launches, n_micro, _, _ = _run_u(smi)
    paths["train_unet"] = (launches, n_micro)
    log(f"phase_zoo10b_slice: {time.perf_counter() - t_phase:.1f} s")
    return paths


#: the evaluation slice (ROADMAP item 10c): DeepLab_v3's frames on the
#: single-frame tracker, the frames of each timed call, the frames held f32
#: card against CPU (a CPU forward of the full-width base takes ~1 s), the
#: evaluators' samples (one test video of a pack) and those held against
#: the CPU
SF_ZOO_FRAMES, SF_TIMED_FRAMES, SF_CPU_FRAMES = 16, 24, 6
EVAL_SAMPLES, EVAL_CPU_SAMPLES = 4, 1
#: the north star's gates (BASELINE.json): heats (max |diff|), tip RMSE (px)
HEAT_GATE, TIP_GATE = 1e-3, 0.5
#: the evaluators' device half in float32 (TF32 off) on the card against the
#: same half on the CPU: max |log-probability diff| (float32 sums in other
#: orders through the base, RAFT x12 and the head) and max |IoU or Dice
#: diff| (a near-tie pixel whose argmax flips moves a class's IoU by about
#: 1 / its pixel count); set before the first run
EVAL_LP_TOL, EVAL_IOU_TOL = 1e-3, 1e-3


def _normalized(frames):
    """(n, H, W, 3) uint8 frames -> (n, 3, H, W) float32 normalized, on
    the card."""
    import torch

    x = torch.as_tensor(frames).cuda().permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor([0.485, 0.456, 0.406], device="cuda").view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device="cuda").view(1, 3, 1, 1)
    return (x - mean) / std


def _sf_card_vs_cpu(model, cfg, frames, d):
    """The single-frame engine in float32 on the card (parity mode) against
    the same model on the CPU: (max |heat diff|, tip RMSE, rows whose
    detections differ) over ``frames``."""
    import dataclasses

    import torch

    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        SingleFrameEngine,
        track_singleframe_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    c32 = dataclasses.replace(cfg, dtype="float32")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(8)
    rows, heats = [], []
    try:
        with parity_mode():
            for dev in ("cuda", "cpu"):
                engine = SingleFrameEngine.from_model(model, c32, "log_probs",
                                           device=dev)
                kept = []
                step = engine.step_async

                def keep(frame, depth=None, step=step, kept=kept):
                    out = step(frame, depth)
                    kept.append(out[-1].cpu())  # the float32 tip heats
                    return out

                engine.step_async = keep
                rows.append(track_singleframe_frames(frames, engine, d,
                                                     name=dev)[0])
                heats.append(torch.stack(kept))
    finally:
        torch.set_num_threads(n_threads)
    heat = (heats[0] - heats[1]).abs().max().item()
    rmse, nan_rows = _tip_rmse(*rows)
    return heat, rmse, nan_rows


def _eval_halves(smi):
    """The infer CLIs' device half on the card: ``infer_multiframe_endovis15``'s
    eval step (TernausNetMulti-Basic at full width, RAFT x12 inside the
    step, float32 as that CLI evaluates) and ``infer_toolpose_segmentation``'s
    (TernausNet16) over a test pack of EVAL_SAMPLES 480x640 samples, through
    ``track/infer_eval.py::device_half``, in parity mode; each held to the
    same half on the CPU over EVAL_CPU_SAMPLES; ms/sample (``_eval_ms``).
    Returns {"infer_raft": (launches, samples)}."""
    import copy
    import types
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli.train_multiframe_detection import build_flow_fn
    from mfcnet_tpu_torch.data.loader import get_data_loader
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.data.transforms import (
        TransformConfig,
        preprocess_eval_batch,
    )
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        get_tooltip_segmentation_model,
    )
    from mfcnet_tpu_torch.track.infer_eval import device_half
    from mfcnet_tpu_torch.train.steps import (
        make_multiframe_eval_step,
        make_singleframe_eval_step,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    with tempfile.TemporaryDirectory() as d:
        pack = make_synthetic_pack(Path(d) / "pack",
                                   videos=(("test", 1, EVAL_SAMPLES),),
                                   add_depth=False, mode="testing")
        _, loader = get_data_loader("JIGSAWS", d, "testing",
                                    "toolpose_segmentation", T, 1,
                                    num_workers=2, packed_dir=pack)
        raw = list(loader)
    tcfg = TransformConfig(out_height=H, out_width=W)
    gen = torch.Generator().manual_seed(SEED)
    mf = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, generator=gen)
    sf = get_tooltip_segmentation_model("TernausNet16", C, generator=gen)

    def single(batch):
        return {"image": batch["frames"][:, 0], "mask": batch["mask"]}

    halves = {
        "infer_multiframe_endovis15 (TernausNetMulti-Basic + RAFT x12)": (
            mf, lambda dev: make_multiframe_eval_step(
                ["nll"], [1.0], ["iou", "dice"], C,
                flow_fn=build_flow_fn("RAFT", (H, W), device=dev)),
            lambda b: b),
        "infer_toolpose_segmentation (TernausNet16)": (
            sf, lambda dev: make_singleframe_eval_step(
                ["nll"], [1.0], ["iou", "dice"], C), single),
    }
    paths = {}
    n_threads = torch.get_num_threads()
    with parity_mode():
        for what, (model, make_step, adapt) in halves.items():
            state = types.SimpleNamespace(model=model.cuda())
            step = make_step("cuda")
            batches = [adapt(preprocess_eval_batch(b, tcfg, "cuda"))
                       for b in raw]
            _reset_all_launches()
            outs = [device_half(state, step, b) for b in batches]
            launches = _all_launches()
            ms = _eval_ms(state, step, batches)
            torch.set_num_threads(8)
            try:
                cpu_state = types.SimpleNamespace(
                    model=copy.deepcopy(model).cpu())
                cpu_step = make_step("cpu")
                lp_err = iou_err = 0.0
                for b, (lp, iou, dice) in zip(raw[:EVAL_CPU_SAMPLES], outs):
                    c_lp, c_iou, c_dice = device_half(
                        cpu_state, cpu_step,
                        adapt(preprocess_eval_batch(b, tcfg, "cpu")))
                    lp_err = max(lp_err, float(np.abs(lp - c_lp).max()))
                    iou_err = max(iou_err, float(np.abs(iou - c_iou).max()),
                                  float(np.abs(dice - c_dice).max()))
            finally:
                torch.set_num_threads(n_threads)
            log(f"[{smi}] {what}: device half (eval step, log-probabilities "
                f"and IoU/Dice to the host), f32, {len(batches)} samples of "
                f"{H}x{W}: {ms[0]:.3f} ms/sample in parity mode (TF32 off), "
                f"{ms[1]:.3f} in the CLI's settings (PyTorch's defaults; "
                f"second pass each); card "
                f"vs CPU over {EVAL_CPU_SAMPLES}: max |log-probability diff| "
                f"{lp_err:.4g} (limit {EVAL_LP_TOL}), max |IoU or Dice diff| "
                f"{iou_err:.4g} (limit {EVAL_IOU_TOL}); mean IoU per class "
                f"{np.round(np.mean([o[1] for o in outs], axis=0), 4)}; "
                f"launches {json.dumps(launches)}")
            if not (lp_err <= EVAL_LP_TOL and iou_err <= EVAL_IOU_TOL):
                raise AssertionError(f"{what}: card and CPU disagree")
            if model is mf:
                _require_launches("infer_raft", launches)
                if launches["raft_update"] != 0:
                    raise AssertionError("the f32 eval step ran the fused "
                                         "update step")
                paths["infer_raft"] = (launches, len(batches))
            del state, step
            model.cpu()
            torch.cuda.empty_cache()
    return paths


def _eval_ms(state, step, batches):
    """ms/sample of ``device_half`` over ``batches``, the second of two
    passes: (in parity mode, in PyTorch's default settings, which the
    infer CLIs run in). Called in parity mode."""
    import torch

    from mfcnet_tpu_torch.track.infer_eval import device_half

    def timed():
        for _ in range(2):
            t0 = time.perf_counter()
            for b in batches:
                device_half(state, step, b)
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    parity = timed()
    cudnn = torch.backends.cudnn
    prev = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = True, False, False
    try:
        return parity, timed()
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = prev


def phase_eval_slice(frames, smi):
    """The evaluation slice (ROADMAP item 10c) at full width: the
    single-frame video CLI's tracker (``cli/test_toolpose_segmentation_on_
    videos.py``: ``SingleFrameEngine`` and ``track_singleframe_frames``)
    with TernausNet16 (seeded weights) at 480x640, bf16, device decode, no
    tie fallback, over the 64 frames (its launches counted); again in
    parity mode through the kernels and through their plain versions
    (rows equal); in float32 on the card against the CPU (the north star's
    gates); frames/s; DeepLab_v3 calibrated as ``phase_zoo_slice``
    calibrates its bases (the logits branch; clean maps, the union tier)
    with its launches counted, and once with ``score_detection_threshold``
    0.5; and the evaluators' device half (``_eval_halves``). Returns {path:
    (launches, frames or samples)}."""
    import dataclasses

    import torch

    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        SingleFrameEngine,
        track_singleframe_frames,
    )
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model
    from mfcnet_tpu_torch.track import decode_device as dd
    from mfcnet_tpu_torch.track.tracker import TrackerConfig
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model = get_tooltip_segmentation_model("TernausNet16", C, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = TrackerConfig(num_input_frames=1, dtype="bfloat16", decode="device",
                        overlay=False, decode_tie_fallback=False)
    engine = SingleFrameEngine.from_model(model, cfg, "log_probs")
    paths = {}
    n = len(frames)
    with tempfile.TemporaryDirectory() as d:
        _reset_all_launches()
        dd.reset_tier_counts()
        rows, fps = track_singleframe_frames(frames, engine, d, name="sf")
        launches = _all_launches()
        tiers = dict(dd.TIER_COUNTS)
        _check_rows(rows, n, warmup=0)
        _require_launches("singleframe", launches)
        paths["singleframe"] = (launches, n)
        log(f"single-frame tracker, TernausNet16 full width ({n_params} "
            f"parameters), {H}x{W} bf16, device decode: {n} frames -> rows "
            f"{rows.shape}, {int(np.isfinite(rows[:, 10]).sum())} frames with "
            f"a right base (first run: {fps:.2f} frames/s); decode tiers "
            f"{json.dumps(tiers)}; launches {json.dumps(launches)}")

        with parity_mode():
            r_k, _ = track_singleframe_frames(frames, engine, d, name="k")
            with _plain_kernels():
                r_p, _ = track_singleframe_frames(frames, engine, d, name="p")
        if not np.array_equal(r_k, r_p, equal_nan=True):
            raise AssertionError("single-frame tracker: rows through the "
                                 "kernels != through the plain versions")
        log(f"single-frame tracker, bf16 in parity mode: rows through the "
            f"kernels == through the plain versions ({n} frames)")

        sub = frames[:SF_ZOO_FRAMES]
        heat, rmse, nan_rows = _sf_card_vs_cpu(model, cfg,
                                               frames[:SF_CPU_FRAMES], d)
        log(f"single-frame tracker, f32 on the card (parity mode) vs the "
            f"CPU, {SF_CPU_FRAMES} frames: max |heat diff| {heat:.4g} (gate "
            f"{HEAT_GATE}), tip RMSE {rmse:.4g} px (gate {TIP_GATE}), "
            f"{nan_rows} rows whose detections differ")
        if not (heat <= HEAT_GATE and rmse <= TIP_GATE):
            raise AssertionError("single-frame tracker: f32 card and CPU "
                                 "disagree")

        rates = [track_singleframe_frames(frames[:SF_TIMED_FRAMES], engine,
                                          d, name=f"t{i}")[1]
                 for i in range(2)]
        log(f"[{smi}] single-frame tracker TernausNet16, bf16, device "
            f"decode: {rates[0]:.2f}, {rates[1]:.2f} frames/s "
            f"({SF_TIMED_FRAMES} frames a call)")
        del engine

        dl = get_tooltip_segmentation_model("DeepLab_v3", C, generator=gen)
        dl = dl.cuda()
        _calibrate_logits("DeepLab_v3 (single-frame)", dl,
                          _normalized(frames[:4]))
        e_dl = SingleFrameEngine.from_model(dl, cfg, "logits")
        _reset_all_launches()
        dd.reset_tier_counts()
        r_dl, _ = track_singleframe_frames(sub, e_dl, d, name="dl")
        launches = _all_launches()
        tiers = dict(dd.TIER_COUNTS)
        _check_rows(r_dl, len(sub), warmup=0, detect=False)
        _require_launches("singleframe_zoo", launches)
        paths["singleframe_zoo"] = (launches, len(sub))
        rates = [track_singleframe_frames(frames[:SF_TIMED_FRAMES], e_dl, d,
                                          name=f"dt{i}")[1]
                 for i in range(2)]
        log(f"[{smi}] single-frame tracker DeepLab_v3 (calibrated, logits "
            f"through log_softmax), bf16, device decode: {len(sub)} "
            f"frames ({int(np.isfinite(r_dl).any(axis=1).sum())} with a "
            f"detection), decode tiers {json.dumps(tiers)}, launches "
            f"{json.dumps(launches)}; {rates[0]:.2f}, {rates[1]:.2f} frames/s "
            f"({SF_TIMED_FRAMES} frames a call)")
        # the threshold loop (a later class overwrites) on the calibrated
        # base, whose probabilities pass 0.5 (the random TernausNet16's
        # stay near 1/C)
        thr = SingleFrameEngine.from_model(dl, dataclasses.replace(
            cfg, score_detection_threshold=0.5), "logits")
        r_t, _ = track_singleframe_frames(sub, thr, d, name="thr")
        _check_rows(r_t, len(sub), warmup=0)
        log(f"single-frame tracker DeepLab_v3, --score_detection_threshold "
            f"0.5: {len(sub)} frames -> rows {r_t.shape}, "
            f"{int(np.isfinite(r_t).any(axis=1).sum())} with a detection")
        del e_dl, dl, thr
        torch.cuda.empty_cache()
    paths.update(_eval_halves(smi))
    log(f"evaluation slice: {time.perf_counter() - t0:.1f} s")
    return paths



# ------------------------------------------------------- serving artifacts
#: the artifact slice: frames tracked through each artifact and through its
#: live engine, windows held against the plain versions, the lockstep
#: streams and their length, frames a timed call
ART_FRAMES, ART_PLAIN_WINDOWS, ART_STREAMS, ART_STREAM_FRAMES = 12, 4, 4, 8
ART_TIMED_FRAMES = 12


@contextlib.contextmanager
def _kept_probs(art, live):
    """Within: an ``ArtifactEngine`` ``art`` keeps the float32
    probabilities of its newest call, (B, H, W, C), and a live engine
    ``live`` those of its newest window (``_keep_probs``), each as
    ``kept_probs``; both engines are reset first and restored after."""
    art.reset()
    live.reset()
    call = art._loaded

    def kept(*args):
        out = call(*args)
        art.kept_probs = out[-1] if isinstance(out, (tuple, list)) else out
        return out

    art._loaded = kept
    _keep_probs(live)
    try:
        yield
    finally:
        art._loaded = call
        del live._outputs
        for e in (art, live):
            e.__dict__.pop("kept_probs", None)


def _graph_targets(exported):
    """Operator names of an ExportedProgram's graph, with their counts."""
    counts = {}
    for n in exported.graph.nodes:
        if n.op == "call_function":
            counts[str(n.target)] = counts.get(str(n.target), 0) + 1
    return counts


def _same_rows(what, a, b):
    if not np.array_equal(a, b, equal_nan=True):
        rmse, differ = _tip_rmse(a, b)
        raise AssertionError(f"{what}: rows differ (tip RMSE {rmse:.4g} px, "
                             f"{differ} rows whose detections differ)")


def _artifact_vs_plain(art, live, frames, depth):
    """The flow artifact (its kernels) against the live engine of the same
    weights under ``_plain_flow_kernels()`` and ``_plain_kernels()``, window
    by window: (max |probability diff|, class-mask share that differs,
    pixels that differ outside the tie band, windows, kernel launches inside
    the plain context)."""
    import torch

    worst, flipped, unexplained, compared, inside = 0.0, 0.0, 0, 0, 0
    with _kept_probs(art, live):
        for i in range(T - 1 + ART_PLAIN_WINDOWS):
            got = art.step_async(frames[i], depth[i])
            _reset_all_launches()
            with _plain_flow_kernels(), _plain_kernels():
                want = live.step_async(frames[i], depth[i])
            inside += sum(_all_launches().values())
            if got is None:
                continue
            p_got, p_want = art.kept_probs[0], live.kept_probs
            worst = max(worst, (p_got - p_want).abs().max().item())
            top2 = p_got.topk(2, dim=-1).values
            differ = got[0] != want[0]
            clear = (top2[..., 0] - top2[..., 1]) > 2 * FLOW_PROB_TOL
            flipped = max(flipped, differ.float().mean().item())
            unexplained += int((differ & clear).sum().item())
            compared += 1
    torch.cuda.synchronize()
    return worst, flipped, unexplained, compared, inside


def _dispatch_us(smi):
    """Host µs a call of each registered operator against its CUDA kernel
    function called directly (the same launch without the dispatcher), at
    the tracker's shapes."""
    import torch

    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.ops import warp
    from mfcnet_tpu_torch.ops._build import kernel_lib, stream_of

    gen = torch.Generator().manual_seed(SEED)
    maps = torch.rand(2, C, H, W, generator=gen).cuda().bfloat16()
    flow = (4 * torch.randn(2, 2, H, W, generator=gen)).cuda()
    ub = init_weights(UpdateBlock(), gen).cuda().eval()
    c1, f1, inp, net, fl, packed, H8, W8 = _raft_update_inputs(
        ub, torch.bfloat16, 2, H // 16, W // 16, gen)
    weights = [packed[k] for k in ru._KMAJOR_NAMES[torch.bfloat16]]
    args = (c1, f1, inp, net, fl, weights, H8, W8, True)
    calls = {
        "flow_warp": (
            lambda: torch.ops.mfcnet.flow_warp(maps, flow, 576, 720, True),
            lambda: warp._flow_warp_cuda(maps, flow, 576, 720, True)),
        "raft_update": (lambda: torch.ops.mfcnet.raft_update(*args),
                        lambda: ru._raft_update_cuda(*args)),
    }
    def enqueue_us(fn, reps=40):
        """Host µs a call to enqueue ``fn``'s launches (the device catches
        up after the timed loop: a device-bound call does not hide the
        host's part)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e6 / reps

    out = {}
    for name, (op, direct) in calls.items():
        t = [enqueue_us(f) for f in (op, direct, direct, op)]
        out[name] = (min(t[0], t[3]), min(t[1], t[2]))
        log(f"[{smi}] mfcnet::{name} through the dispatcher: "
            f"{out[name][0]:.2f} µs a call to enqueue (host), its CUDA "
            f"function called directly {out[name][1]:.2f} µs: "
            f"{out[name][0] - out[name][1]:.2f} µs of dispatch (turns op, "
            f"direct, direct, op: {', '.join(f'{v:.2f}' for v in t)})")

    # what writing [net | inp] into hx costs a call: the kernel with and
    # without its fill launch, on one plan, in turns
    plan = ru._plan_in({}, c1, H8, W8, weights)
    n_out, d_out = torch.empty_like(net), torch.empty_like(fl)

    def launch(fill):
        rc = kernel_lib().mfc_raft_update_tma(
            plan.buf, ru._ptrs((c1, f1, inp, net, fl)), n_out.data_ptr(),
            d_out.data_ptr(), fill, stream_of(c1))
        if rc != 0:
            raise RuntimeError(f"raft_update failed: error {rc}")

    t = [_graph_ms(lambda f=f: launch(f)) for f in (1, 0, 0, 1)]
    plan.held = None  # hx no longer holds a returned state
    fill_ms = (min(t[0], t[3]), min(t[1], t[2]))
    log(f"[{smi}] raft_update at {2 * H8 * W8} tokens (the full window's "
        f"solve), device time in CUDA-graph replays: with the [net | inp] "
        f"fill {fill_ms[0]:.4f} ms, without {fill_ms[1]:.4f} ms (turns "
        f"{', '.join(f'{v:.4f}' for v in t)})")
    return out, fill_ms


def phase_artifact_slice(noflow_engine, flow_engine, frames, smi):
    """The serving slice (ROADMAP item 11c) at full width, 480x640, bf16,
    device decode, no tie fallback: three artifacts exported on the card
    and saved under build/artifacts (``serve.export_*``, ``save_exported``):
    (a) the incremental step of the no-flow engine's TernausNetMulti-Basic
    (symbolic batch), (b) the full window of a TernausNetMulti-Basic with
    RAFT x12 (fused update step: the provider of the flow path's engine) and
    depth, (c) the single-frame TernausNet16 (the no-flow model's base).
    Held: (b)'s graph names mfcnet.raft_update (12) and mfcnet.flow_warp (1);
    each ``ArtifactEngine`` gives the rows of the live engine of the same
    weights and mode (probabilities compared); the launches of (b)'s run
    (the main path's, counted from 0): 12 raft_update, 1 flow_warp and 1
    hx fill a fused frame and the cc.cu launches of the live engine's run;
    (b) against the live engine through the plain versions within
    FLOW_PROB_TOL, with 0 kernel launches inside that context; four
    streams in lockstep through (a), each against its own single-stream
    run. Prints export s, artifact MB, frames/s of artifact and live (two
    calls each) and the operators' dispatch µs. Returns {"artifact":
    (launches, fused frames)}."""
    import dataclasses
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli.test_toolpose_segmentation_on_videos import (
        SingleFrameEngine,
        track_singleframe_frames,
    )
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.ops import raft_update as ru
    from mfcnet_tpu_torch.serve import (
        ArtifactEngine,
        export_incremental,
        export_serving,
        export_singleframe,
        load_exported,
        save_exported,
    )
    from mfcnet_tpu_torch.track.tracker import (
        InferenceEngine,
        TrackerConfig,
        track_on_frame_streams,
        track_on_frames,
    )
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "artifacts"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = TrackerConfig(dtype="bfloat16", decode="device", overlay=False,
                        decode_tie_fallback=False)
    shape = dict(height=H, width=W)
    base_meta = {"num_classes": C, "num_input_frames": T, "input_height": H,
                 "input_width": W, "compute_dtype": "bfloat16",
                 "add_depth_inputs": False, "add_optflow_inputs": False}
    gen = torch.Generator().manual_seed(SEED)
    fmodel = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, generator=gen)
    raft = flow_engine.flow_model
    readings = {}

    def export(name, fn, meta):
        t0 = time.perf_counter()
        ep = fn()
        t1 = time.perf_counter()
        path = out_dir / f"{name}.pt2"
        save_exported(path, ep, meta)
        t2 = time.perf_counter()
        loaded = load_exported(path, device="cuda")
        readings[name] = (t1 - t0, t2 - t1, time.perf_counter() - t2,
                          path.stat().st_size / 1e6)
        log(f"artifact {name}: exported in {t1 - t0:.2f} s, saved in "
            f"{t2 - t1:.2f} s, loaded in {readings[name][2]:.2f} s, "
            f"{readings[name][3]:.2f} MB, {json.dumps(loaded.meta['in_specs'])}"
            f" -> {json.dumps(loaded.meta['out_specs'])}")
        return ep, loaded

    def make_inc():
        ep, spec = export_incremental(noflow_engine.model, num_frames=T,
                                      num_classes=C, dtype="bfloat16",
                                      **shape)
        base_meta_inc["state"] = {k: [list(s), d] for k, (s, d) in
                                  spec.items()}
        return ep

    base_meta_inc = {**base_meta, "serving_mode": "incremental"}
    _, art_inc = export("incremental", make_inc, base_meta_inc)
    ep_flow, art_flow = export(
        "raft_depth_full",
        lambda: export_serving(fmodel, num_frames=T, dtype="bfloat16",
                               add_depth_inputs=True, flow_model=raft,
                               **shape),
        {**base_meta, "serving_mode": "full", "add_depth_inputs": True,
         "add_optflow_inputs": True})
    _, art_sf = export(
        "singleframe",
        lambda: export_singleframe(noflow_engine.model.base_model,
                                   output_mode="log_probs",
                                   dtype="bfloat16", **shape),
        {**base_meta, "task": "singleframe", "num_input_frames": 1,
         "output_mode": "log_probs"})
    ops = {k: v for k, v in _graph_targets(ep_flow).items()
           if k.startswith("mfcnet.")}
    log(f"artifact raft_depth_full: operators of this package in its graph "
        f"{json.dumps(ops)}")
    if ops != {"mfcnet.raft_update.default": FLOW_ITERS,
               "mfcnet.flow_warp.default": 1}:
        raise AssertionError(f"the RAFT artifact's graph must name "
                             f"{FLOW_ITERS} raft_update and 1 flow_warp")
    del ep_flow

    n = ART_FRAMES
    fused = n - (T - 1)
    depth = _depth_frames(frames[:n])
    fcfg = dataclasses.replace(cfg, mode="full", add_depth_inputs=True,
                               add_optflow_inputs=True)
    art_engine = ArtifactEngine(art_flow, fcfg)
    live_flow = InferenceEngine(fmodel, fcfg, flow_model=raft)
    with tempfile.TemporaryDirectory() as d:
        # the main path: the flow artifact's run, every count from 0
        _reset_all_launches()
        rows_art, _ = track_on_frames(frames[:n], None, fcfg, d, name="a",
                                      depth_frames=depth, engine=art_engine)
        launches = _all_launches()
        counts = dict(ru.COUNTS)
        _reset_all_launches()
        rows_live, _ = track_on_frames(frames[:n], None, fcfg, d, name="l",
                                       depth_frames=depth, engine=live_flow)
        live_launches = _all_launches()
    _check_rows(rows_art, n)
    log(f"artifact path (RAFT x{FLOW_ITERS}, depth, full window): {n} frames "
        f"-> rows {rows_art.shape}; launches {json.dumps(launches)}, "
        f"raft_update counts {json.dumps(counts)}; the live engine's "
        f"launches {json.dumps(live_launches)}")
    _require_launches("artifact", launches)
    if launches["raft_update"] != FLOW_ITERS * fused \
            or launches["flow_warp"] != fused \
            or counts["hx_fills"] != fused:
        raise AssertionError(
            f"expected {FLOW_ITERS} update steps, 1 warp and 1 fill of hx "
            f"per fused frame ({fused} frames), got {launches}, {counts}")
    cc_art = {k: launches[k] for k in CC_KERNELS}
    if cc_art != {k: live_launches[k] for k in CC_KERNELS}:
        raise AssertionError("the artifact's decode launches differ from "
                             "the live engine's")
    _same_rows("artifact RAFT + depth vs live engine", rows_art, rows_live)

    # the same windows' probabilities, artifact against live
    def prob_diffs(art, live, inputs):
        worst = 0.0
        with _kept_probs(art, live):
            for x in inputs:
                got = art.step_async(*x)
                live.step_async(*x)
                if got is not None:
                    worst = max(worst, (art.kept_probs[0] - live.kept_probs)
                                .abs().max().item())
        return worst

    p_flow = prob_diffs(art_engine, live_flow,
                        [(frames[i], depth[i]) for i in range(T + 1)])
    inc_engine = ArtifactEngine(art_inc, cfg)
    p_inc = prob_diffs(inc_engine, noflow_engine,
                       [(frames[i],) for i in range(T + 1)])
    with tempfile.TemporaryDirectory() as d:
        noflow_engine.reset()
        r_art, _ = track_on_frames(frames[:n], None, cfg, d, name="a",
                                   engine=inc_engine)
        r_live, _ = track_on_frames(frames[:n], None, cfg, d, name="l",
                                    engine=noflow_engine)
        _same_rows("incremental artifact vs live engine", r_art, r_live)
        sf_cfg = dataclasses.replace(cfg, num_input_frames=1)
        sf_live = SingleFrameEngine.from_model(noflow_engine.model.base_model, sf_cfg,
                                    "log_probs")
        sf_art = SingleFrameEngine.from_artifact(art_sf, sf_cfg)
        s_art, _ = track_singleframe_frames(frames[:n], sf_art, d, name="sa")
        s_live, _ = track_singleframe_frames(frames[:n], sf_live, d,
                                             name="sl")
        _same_rows("single-frame artifact vs live engine", s_art, s_live)
        p_sf = max((sf_art.probs(frames[i]) - sf_live.probs(frames[i]))
                   .abs().max().item() for i in range(2))
    log(f"artifact rows == live engine rows over {n} frames: incremental "
        f"(no flow), full window with RAFT + depth, single-frame; max "
        f"|probability diff| {p_inc:.4g}, {p_flow:.4g}, {p_sf:.4g} (bound "
        f"{FLOW_PROB_TOL:.4g}, the bf16 engine comparisons')")
    if max(p_inc, p_flow, p_sf) > FLOW_PROB_TOL:
        raise AssertionError("an artifact departs from its live engine")

    worst, flipped, unexplained, compared, inside = _artifact_vs_plain(
        art_engine, live_flow, frames, depth)
    log(f"RAFT artifact (kernels) vs the live engine through the plain "
        f"versions, bf16, {compared} windows: max |probability diff| "
        f"{worst:.4g} (limit {FLOW_PROB_TOL:.4g}); class-mask pixels that "
        f"differ {flipped:.4%} at most per window, {unexplained} outside "
        f"the tie band (must be 0); kernel launches inside the plain "
        f"context: {inside} (must be 0)")
    if worst > FLOW_PROB_TOL or unexplained or inside:
        raise AssertionError("RAFT artifact: kernels and plain versions "
                             "disagree")

    # four streams in lockstep through the one incremental artifact: equal
    # to the live 4-stream engine's rows, and each against its own
    # single-stream run (parity mode: deterministic cuDNN; bf16 convolutions
    # at batch 4 and at batch 1 may round differently)
    streams = _stream_frames((ART_STREAM_FRAMES,) * ART_STREAMS)
    names = [f"s{b}" for b in range(ART_STREAMS)]
    with parity_mode(), tempfile.TemporaryDirectory() as d:
        multi = ArtifactEngine(art_inc, cfg, num_streams=ART_STREAMS)
        multi_rows, _ = track_on_frame_streams(streams, None, cfg, d,
                                               names=names, engine=multi)
        live_rows, _ = track_on_frame_streams(
            streams, None, cfg, d, names=names,
            engine=InferenceEngine(noflow_engine.model, cfg,
                                   num_streams=ART_STREAMS))
        single_rows = [track_on_frames(s, None, cfg, d, name=f"r{b}",
                                       engine=inc_engine)[0]
                       for b, s in enumerate(streams)]
    for b, (a, l_) in enumerate(zip(multi_rows, live_rows)):
        _same_rows(f"artifact stream {b} of {ART_STREAMS} vs the live "
                   f"{ART_STREAMS}-stream engine", a, l_)
    stats = [_tip_rmse(a, b) for a, b in zip(multi_rows, single_rows)]
    both = [np.isfinite(a) & np.isfinite(b)
            for a, b in zip(multi_rows, single_rows)]
    row_diff = max((np.abs(a[m] - b[m]).max() if m.any() else 0.0)
                   for a, b, m in zip(multi_rows, single_rows, both))
    equal = sum(int(np.array_equal(x, y, equal_nan=True))
                for a, b in zip(multi_rows, single_rows) for x, y in zip(a, b))
    log(f"artifact, {ART_STREAMS} streams through one artifact: rows == the "
        f"live {ART_STREAMS}-stream engine's; against single-stream runs "
        f"(bf16, parity mode): tip RMSE per stream "
        f"{[round(r, 6) for r, _ in stats]} px (limit {TIP_GATE}), rows "
        f"whose detections differ {[m for _, m in stats]}, max |row diff| "
        f"{row_diff:.4g} px; rows byte-equal: {equal} of "
        f"{ART_STREAMS * ART_STREAM_FRAMES}")
    if max(r for r, _ in stats) > TIP_GATE or any(m for _, m in stats):
        raise AssertionError("artifact streams: a stream departs from its "
                             "single-stream run")

    with tempfile.TemporaryDirectory() as d:
        rates = {}
        for what, engine, kw in (
                ("incremental artifact", inc_engine, {}),
                ("live incremental engine", noflow_engine, {}),
                ("RAFT + depth artifact", art_engine, {"depth_frames": depth}),
                ("live RAFT + depth engine (full)", live_flow,
                 {"depth_frames": depth})):
            rates[what] = [track_on_frames(frames[:ART_TIMED_FRAMES], None,
                                           engine.cfg, d, name=f"t{i}",
                                           engine=engine, **kw)[1]
                           for i in range(2)]
    log(f"[{smi}] frames/s, {ART_TIMED_FRAMES} frames a call, two calls "
        f"each: " + "; ".join(f"{k} {v[0]:.2f}, {v[1]:.2f}"
                              for k, v in rates.items()))
    _dispatch_us(smi)
    del art_engine, live_flow, inc_engine, multi, fmodel
    torch.cuda.empty_cache()
    log(f"artifact slice: {time.perf_counter() - t_phase:.1f} s")
    return {"artifact": (launches, fused)}


# ------------------------------------------------- phase 10: the backward
#: B2 (the correlation's backward) and B3 (the sampler's backward) against
#: their plain versions: max |diff| over the plain result's largest
#: magnitude. float32: B2 sums its products on the tensor cores in 3xTF32
#: (a few 2^-21 of each product; tests/test_torch_corr_bwd_plan.py models
#: it at 3e-7 of the largest) or, on the fma route, with fused
#: multiply-adds, in another order than the plain version's one
#: displacement at a time; bfloat16 inputs take g as three bfloat16 terms
#: (exactly), and an output whose float32 sum lies near a bf16 rounding
#: midpoint in the top binade is summed again in the plain version's order
#: (csrc/correlation.cu); B3's image gradient adds tile sums and
#: single contributions with float32 atomics in a run-dependent order (a
#: tap that n samples reach: ~sqrt(n) roundings of its partial sums), its
#: coordinate gradient sums the channels in another order than torch's sum:
#: a few float32 roundings of a sum, far below 1e-5 of the largest.
#: bfloat16 inputs: the float32 result rounded once to bfloat16, which
#: another summation order can flip by one step (2^-8 of a value's binade)
#: on top of that.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8 + 1e-5}
#: UnFlow's gradients (every parameter, both frames) through the kernels
#: against through the plain versions, per tensor max |diff| over its
#: largest magnitude, in parity mode. "held": both runs take the kernels'
#: forward, so only the backward kernels differ (the roundings above),
#: carried linearly through ~75 convolutions' backward: 1e-4. "whole": the
#: plain forward too. Its correlation is 1e-5 from the kernel's, so the
#: flows differ by ~1e-5 of their size, and a sample whose coordinate lies
#: that close to an integer takes the neighbouring pair of taps for its
#: coordinate gradient (the bilinear sample's derivative jumps there): a few
#: pixels' flow gradients differ by O(1) of their size, which the deep layers'
#: few-pixel sums carry to a few percent of a tensor's largest entry. The
#: limit is 0.1: it holds a wrong sign, a dropped term or a missing
#: gradient (each >= 0.5 of a tensor's largest), not those jumps. The
#: bfloat16 model's frames get their gradient through the rounding of the
#: input to bfloat16, which one float32 rounding apart can flip: one
#: bfloat16 step (2^-8) more for them.
UNFLOW_GRAD_TOL = {"held": 1e-4, "whole": 0.1}
#: the pairs of UnFlow's gradient run: the offline flow CLI's batch of 4 at
#: 512x640 (frames 3 and 7 of ``synthetic_frames`` are noise: left out)
UNFLOW_GRAD_PAIRS = ((0, 1), (1, 2), (4, 5), (5, 6))


def _rel(got, want):
    import torch

    w = want.float()
    return float((got.float() - w).abs().max()
                 / w.abs().max().clamp_min(torch.finfo(torch.float32).tiny))


def _plain_backward_kernels():
    """Context in which the correlation's and the sampler's backward run
    their plain versions (on the same CUDA tensors), the forward kernels
    still launching."""
    import contextlib
    from unittest import mock

    from mfcnet_tpu_torch.ops import correlation as co
    from mfcnet_tpu_torch.ops import warp

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(co, "correlation_backward",
                                          co.correlation_backward_plain))
    stack.enter_context(mock.patch.object(warp, "sample_backward",
                                          warp.sample_backward_plain))
    return stack


#: B2's checked shapes beyond the timed ones: (shape, md, s), a tensor-core
#: shape whose last channel chunk holds 8 channels and whose rows take
#: several tiles, and the fma route's (C % 8 != 0) at UnFlow's window
B2_MORE = (((1, 5, 70, 136), 6, 2), ((2, 32, 40, 60), 20, 2))


def _check_b2(co, g, f1, f2, md, s, what):
    """One B2 call against its plain version, both gradients together and
    each alone, one launch a call, two calls bit-equal (no atomics).
    Returns the relative errors and the max |diff|."""
    import torch

    name = str(f1.dtype).split(".")[1]
    co.reset_launches()
    k1, k2 = co.correlation_backward(g, f1, f2, md, s)
    torch.cuda.synchronize()
    if co.LAUNCHES["correlation_bwd"] != 1:
        raise AssertionError(f"B2 {what}: launches {co.LAUNCHES}")
    p1, p2 = co.correlation_backward_plain(g, f1, f2, md, s)
    rels = (_rel(k1, p1), _rel(k2, p2))
    if k1.dtype != f1.dtype or max(rels) > BWD_TOL[name]:
        raise AssertionError(f"B2 {what} {name}: {rels}, {k1.dtype}")
    again = co.correlation_backward(g, f1, f2, md, s)
    if not (torch.equal(again[0], k1) and torch.equal(again[1], k2)):
        raise AssertionError(f"B2 {what} {name}: two calls differ")
    one = co.correlation_backward(g, f1, f2, md, s, (True, False))
    two = co.correlation_backward(g, f1, f2, md, s, (False, True))
    if not (torch.equal(one[0], k1) and one[1] is None
            and torch.equal(two[1], k2) and two[0] is None):
        raise AssertionError(f"B2 {what} {name}: a gradient alone differs")
    if co.LAUNCHES["correlation_bwd"] != 4:
        raise AssertionError(f"B2 {what}: launches {co.LAUNCHES}")
    return rels, max(float((k1.float() - p1.float()).abs().max()),
                     float((k2.float() - p2.float()).abs().max()))


def _hold_b2(gen, smi, times, bounds, library):
    """B2 against its plain version on both routes: the tracker's and the
    offline CLI's conv3 shapes (tensor cores) and ``B2_MORE``, both types,
    both gradients together and each alone; one launch a call, two calls
    bit-equal; times (graph replay) at the two UnFlow shapes, the bound and
    the ``torch.bmm`` yardstick. Returns the worst max |diff|."""
    import torch

    from mfcnet_tpu_torch.ops import correlation as co

    worst = 0.0
    for shape, md, s in B2_MORE:
        D = co.displacements(md, s)
        g = torch.randn(*shape[:3], D * D, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            plan = co.corr_bwd_plan(*shape, md, s, name)
            rels, err = _check_b2(co, g, f1, f2, md, s, str(shape))
            worst = max(worst, err)
            log(f"[{smi}] B2 {shape} md={md} s={s} {name}, route "
                f"{plan.route}: max |diff| / max {rels[0]:.3g} (grad_f1), "
                f"{rels[1]:.3g} (grad_f2), limit {BWD_TOL[name]:.3g}; each "
                f"alone equal, two calls bit-equal, 1 launch a call")
    for shape, where in (((2, 32, 40, K), "tracker"),
                         ((4, 64, 80, K), "offline")):
        B, h, w, c = shape
        g = torch.randn(B, h, w, 441, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            f1 = torch.randn(shape, generator=gen).cuda().to(dt)
            f2 = torch.randn(shape, generator=gen).cuda().to(dt)
            plan = co.corr_bwd_plan(*shape, 20, 2, name)
            if plan.route != "tc":
                raise AssertionError(f"B2 {where}: plan {plan}")
            rels, err = _check_b2(co, g, f1, f2, 20, 2, where)
            worst = max(worst, err)
            key = "correlation_bwd" + ("" if (where, name) == (
                "tracker", "float32") else f"@{where} {name}")
            times[key] = _in_turns(
                key, lambda: co.correlation_backward(g, f1, f2, 20, 2),
                lambda: co.correlation_backward_plain(g, f1, f2, 20, 2), smi,
                f"{shape} {name}, both gradients", kreps=20, preps=1,
                timer=_graph_ms, ptimer=_event_ms)
            flop = 2 * 2 * B * h * w * 441 * c
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_TF32 / 3
            nb = _nbytes(g, f1, f2, f1, f2)  # the gradients: f1's, f2's
            b_ms, o_ms = nb / PEAK_BYTES * 1e3, flop / peak * 1e3
            bounds[key] = max((b_ms, "bytes"), (o_ms, "operations"))
            # the dense yardstick: per residue sub-grid, a (P, P) gradient
            # of the full Gram matrix times each operand (float32, TF32 off)
            a1, a2 = _residue_grams(f1.float(), f2.float(), 2)
            gram = torch.randn(a1.shape[0], a1.shape[1], a1.shape[1],
                               generator=gen).cuda()
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                library[key] = _graph_ms(lambda: (
                    torch.bmm(gram, a2), torch.bmm(gram.transpose(1, 2), a1)),
                    20)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            log(f"[{smi}] B2 {where} {shape} {name} (route tc, plan "
                f"{tuple(plan)}): max |diff| / max {rels[0]:.3g} (grad_f1), "
                f"{rels[1]:.3g} (grad_f2), limit {BWD_TOL[name]:.3g}; each "
                f"alone equal, two calls bit-equal, 1 launch a call; kernel "
                f"{times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms, bound "
                f"{bounds[key][0]:.5f} ms ({bounds[key][1]}: {nb} B at 3.35 "
                f"TB/s -> {b_ms:.5f}; {flop / 1e9:.3f} GFLOP at "
                f"{peak / 1e12:.0f} TFLOP/s -> {o_ms:.5f}), torch.bmm of "
                f"the residue sub-grids' dense (P, P) gradients with both "
                f"operands {library[key]:.4f} ms")
    return worst


def _b3_cases(gen, B, Ch, h, w):
    """(name, fx, fy) absolute coordinates of B3's standalone checks:
    backward_warp's own coordinates from a flow that pushes each image's
    samples past another edge (left, right, top, bottom) and beyond the
    corners ("edges", 6 px of noise a pixel), integer coordinates from -3
    to size + 2 with the clamp limits 0 and size - 1 among them
    ("integers"), a smooth flow of ~6 px, the random provider's size
    ("smooth"), and 40 px of noise a pixel ("noise", whose tiles' tap boxes
    exceed the image entry's shared-memory box: its direct route)."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    flow = torch.randn(B, 2, h, w, generator=gen) * 6
    push = 0.75
    flow[0, 0] -= push * w
    flow[1, 0] += push * w
    flow[2, 1] -= push * h
    flow[3, 1] += push * h
    flow[:, :, :8, :8] -= 2 * w  # past a corner
    gx, gy = warp._warp_grid(flow.cuda())
    fx, fy = warp._abs_coords(gx, gy, h, w, False, "zeros")
    ix = (xx + torch.randint(-4, 5, (B, h, w), generator=gen)).clamp(-3, w + 2)
    iy = (yy + torch.randint(-4, 5, (B, h, w), generator=gen)).clamp(-3, h + 2)
    smooth = torch.nn.functional.interpolate(
        torch.randn(B, 2, h // 32, w // 32, generator=gen) * 6, size=(h, w),
        mode="bilinear", align_corners=False).cuda()
    noise = (torch.randn(B, 2, h, w, generator=gen) * 40).cuda()
    return (("edges", fx, fy), ("integers", ix.cuda(), iy.cuda()),
            ("smooth", *warp._abs_coords(*warp._warp_grid(smooth), h, w,
                                         False, "zeros")),
            ("noise", *warp._abs_coords(*warp._warp_grid(noise), h, w,
                                        False, "zeros")))


def _hold_b3(gen, smi, times, bounds, library):
    """B3 (both entry points) against its plain version at 4x3x512x640 on
    the four ``_b3_cases``, border and zeros padding, NCHW and
    channels_last, float32 and bfloat16; the image entry's routes (tiles on
    the shared and the direct route, ``warp.sample_bwd_tiles``); times
    (graph replay) at the UnFlow training shape on the smooth, edges and
    noise cases, bounds and ``aten::grid_sampler_2d_backward``. Returns the
    worst max |diff|."""
    import torch

    from mfcnet_tpu_torch.ops import warp

    B, Ch, h, w = 4, 3, UH, UW
    worst = 0.0
    cases = _b3_cases(gen, B, Ch, h, w)
    for case, fx, fy in cases:
        for pm in ("border", "zeros"):
            ext, local = warp.sample_bwd_tiles(fx, fy, h, w, Ch, pm)
            direct = int(((ext[..., 0] <= ext[..., 1]) & ~local).sum())
            log(f"B3 {case} {pm}: image entry tiles {int(local.sum())} on "
                f"the shared route, {direct} direct, "
                f"{local.numel() - int(local.sum()) - direct} empty")
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for fmt in (torch.contiguous_format, torch.channels_last):
            img = torch.rand(B, Ch, h, w, generator=gen).cuda().to(
                dt).contiguous(memory_format=fmt)
            g = torch.randn(B, Ch, h, w, generator=gen).cuda().to(
                dt).contiguous(memory_format=fmt)
            for case, fx, fy in cases:
                for pm in ("border", "zeros"):
                    warp.reset_launches()
                    ki, kx, ky = warp.sample_backward(g, img, fx, fy, pm)
                    torch.cuda.synchronize()
                    if (warp.LAUNCHES["sample_bwd_img"],
                            warp.LAUNCHES["sample_bwd_coords"]) != (1, 1):
                        raise AssertionError(f"B3: launches {warp.LAUNCHES}")
                    pi, px, py = warp.sample_backward_plain(g, img, fx, fy,
                                                            pm)
                    rels = (_rel(ki, pi), _rel(kx, px), _rel(ky, py))
                    if (max(rels) > BWD_TOL[name] or ki.dtype != dt
                            or not ki.is_contiguous(memory_format=fmt)):
                        raise AssertionError(
                            f"B3 {case} {pm} {name} {fmt}: {rels}")
                    worst = max(worst, *(float((a.float() - b.float()).abs(
                    ).max()) for a, b in ((ki, pi), (kx, px), (ky, py))))
            log(f"B3 {name} {fmt}: edges, integers, smooth and noise, border "
                f"and zeros: max |diff| / max within {BWD_TOL[name]:.3g} "
                f"(worst max |diff| so far {worst:.3g}); the image gradient "
                "in the image's type and memory format; 1 launch each entry "
                "point")
    # at a clamp limit the coordinate gradient is half the inner one
    # (XLA's tie of maximum and minimum), 0 beyond it: one pixel each
    img = torch.rand(1, 1, 4, 5, generator=gen).cuda()
    g1 = torch.ones(1, 1, 1, 3, device="cuda")
    lim = torch.tensor([[[0.0, 4.0, -1.0]]], device="cuda")
    mid = torch.tensor([[[1.0, 1.0, 1.0]]], device="cuda")
    _, kx, _ = warp.sample_backward(g1, img, lim, mid, "border")
    row = img[0, 0, 1]
    want = torch.stack([0.5 * (row[1] - row[0]), 0.5 * (0 - row[4]),
                        torch.zeros((), device="cuda")])
    if not torch.allclose(kx[0, 0], want, rtol=0, atol=1e-7):
        raise AssertionError(f"B3 at the clamp limits: {kx} vs {want}")
    log("B3 at the clamp limits (border): the x gradient at x = 0 and x = W "
        "- 1 is half the one-sided difference, 0 beyond (jax.grad's)")
    # times at the UnFlow training shape, channels_last float32, border: on
    # a smooth flow of ~6 px (the random provider's size), on the edges
    # case, where most samples clamp onto an edge (the first design's
    # atomics of whole rows on its pixels), and on the 40 px noise (the
    # image entry's direct route)
    img = torch.rand(B, Ch, h, w, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(B, Ch, h, w, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    by_name = {case: (fx, fy) for case, fx, fy in cases}
    for where, case in (("", "smooth"), ("@edges", "edges"),
                        ("@noise", "noise")):
        fx, fy = by_name[case]
        grid = torch.stack([fx * (2.0 / w) + (1.0 / w - 1.0),
                            fy * (2.0 / h) + (1.0 / h - 1.0)], -1)
        outs = warp.sample_backward(g, img, fx, fy, "border")
        for name, needs, mask, out in (
                ("sample_bwd_img", (True, False), [True, False], outs[:1]),
                ("sample_bwd_coords", (False, True), [False, True],
                 outs[1:])):
            key = name + where
            times[key] = _in_turns(
                key, lambda: warp.sample_backward(g, img, fx, fy, "border",
                                                  needs),
                lambda: warp.sample_backward_plain(g, img, fx, fy, "border",
                                                   needs), smi,
                f"{B}x{Ch}x{h}x{w} float32 channels_last, border, {case}",
                kreps=20, preps=2, timer=_graph_ms, ptimer=_event_ms)
            reads = (g, fx, fy) if needs[0] else (g, img, fx, fy)
            nb = _nbytes(*reads, *out)
            bounds[key] = (nb / PEAK_BYTES * 1e3, "bytes")
            library[key] = _graph_ms(
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    g, img, grid, 0, 1, False, mask), 20)
            log(f"[{smi}] {key}: kernel {times[key][0]:.4f} ms (the wrapper "
                f"call{', zeroed float32 buffer included' if needs[0] else ''}"
                f"), plain {times[key][1]:.4f} ms, bound "
                f"{bounds[key][0]:.5f} ms (bytes: {nb} B at 3.35 TB/s), "
                f"aten::grid_sampler_2d_backward (output mask {mask}) "
                f"{library[key]:.4f} ms")
    return worst


def _unflow_grads(model, a, b, R):
    """Flow and the gradients of ``mean(flow * R)`` for every parameter and
    both frames, and the host ms of forward and backward (synchronized)."""
    import torch

    model.zero_grad(set_to_none=True)
    a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = model(a, b)
    (flow * R).mean().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    grads.update(first=a.grad, second=b.grad)
    return flow.detach(), grads, ms


def _remat_run_a(smi):
    """Run A's micro-step (full width, batch 4, bf16, base trained, frozen
    RAFT and depth in the step) with ``remat`` and without, from the same
    weights and batch, in parity mode: parameters after one step equal bit
    for bit, the remat peak lower; then ms/step (median of 3 more)."""
    import torch

    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    batch, step = _run_a_inputs()
    out = {}
    with parity_mode():
        for remat in (False, True):
            model = _run_a_model(remat=remat)
            st = TrainState(model, make_schedule("Constant", STEP_LR, 1, 1),
                            T)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(st, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(st, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[remat] = (sd, peak, float(np.median(ms)), ms)
            del model, st
            torch.cuda.empty_cache()
    (sd0, peak0, ms0, all0), (sd1, peak1, ms1, all1) = out[False], out[True]
    differ = [k for k in sd0 if not torch.equal(sd0[k], sd1[k])]
    if differ:
        raise AssertionError(f"--remat: parameters after one step differ: "
                             f"{differ[:5]} ({len(differ)} tensors)")
    if not peak1 < peak0:
        raise AssertionError(f"--remat: peak {peak1} not below {peak0}")
    log(f"[{smi}] run A's micro-step (TernausNetMulti-Basic {H}x{W}, batch "
        f"{TRAIN_B}, bf16, base trained, RAFT x{FLOW_ITERS} + depth; parity "
        f"mode): with --remat the {len(sd0)} parameter and buffer tensors "
        f"after one step equal those without, bit for bit; peak "
        f"max_memory_allocated {peak1 / 2 ** 30:.3f} GiB with --remat, "
        f"{peak0 / 2 ** 30:.3f} GiB without ({peak1 / peak0:.1%}); ms/step "
        f"{ms1:.2f} with, {ms0:.2f} without (medians of "
        f"{[round(x, 2) for x in all1]} / {[round(x, 2) for x in all0]})")


def phase_unflow_grad_slice(smi):
    """The backward slice: B2 and B3 against their plain versions, alone and
    through UnFlow's gradient at 4 pairs of 512x640 (float32 and bfloat16
    models; the main-path run is the float32 model's through the kernels);
    run A's micro-step with and without ``--remat``. Returns (the main-path
    run's launches, its backward passes, times, bounds, library, max
    |diff| by kernel)."""
    import torch

    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    times, bounds, library = {}, {}, {}
    errs = {"correlation_bwd": _hold_b2(gen, smi, times, bounds, library)}
    errs["sample_bwd_img"] = errs["sample_bwd_coords"] = _hold_b3(
        gen, smi, times, bounds, library)

    # frames in [0, 1] with one uint8 step of continuous noise: in a flat
    # region first - warp(second) is a few roundings of zero, and |.|'s kink
    # there would let the two runs' last-bit differences flip the frames'
    # gradients pixel by pixel
    frames = torch.from_numpy(synthetic_frames(8, hw=(UH, UW))).float()
    frames = (frames + torch.rand(frames.shape, generator=gen)) / 256.0
    a = frames[[p for p, _ in UNFLOW_GRAD_PAIRS]].cuda()
    b = frames[[q for _, q in UNFLOW_GRAD_PAIRS]].cuda()
    R = torch.randn(len(UNFLOW_GRAD_PAIRS), UH, UW, 2, generator=gen).cuda()
    launches = None
    with parity_mode():
        for dt in (torch.float32, torch.bfloat16):
            model = he_init_weights(UnFlow(), torch.Generator().manual_seed(
                SEED)).to("cuda", dt)
            _unflow_grads(model, a, b, R)  # warm-up
            _reset_all_launches()
            flow_k, gk, ms_k = _unflow_grads(model, a, b, R)
            run = _all_launches()
            if dt == torch.float32:
                launches = run
            want = {"correlation": 1, "correlation_bwd": 1,
                    "backward_warp": 2, "sample_bwd_img": 2,
                    "sample_bwd_coords": 2}
            if any(run[k] != n for k, n in want.items()):
                raise AssertionError(f"UnFlow gradient: launches {run}")
            _require_launches("unflow_grad", run)
            with _plain_backward_kernels():
                _, gh, ms_h = _unflow_grads(model, a, b, R)
            with _plain_unflow_kernels():
                _reset_all_launches()
                flow_p, gp, ms_p = _unflow_grads(model, a, b, R)
                if any(_all_launches().values()):
                    raise AssertionError("the plain run launched kernels")
            rel_h = {k: _rel(gk[k], gh[k]) for k in gk}
            rel_p = {k: _rel(gk[k], gp[k]) for k in gk}
            rounded = dt == torch.bfloat16
            for what, rel in (("held", rel_h), ("whole", rel_p)):
                bad = {k: v for k, v in rel.items()
                       if not v <= UNFLOW_GRAD_TOL[what] + (
                           2.0 ** -8 if rounded and k in ("first", "second")
                           else 0.0)}
                if bad:
                    raise AssertionError(f"UnFlow {dt} gradients ({what}): "
                                         f"{bad}")
            if not all(torch.isfinite(t).all() for t in gk.values()):
                raise AssertionError("UnFlow gradient: not finite")
            name = str(dt).split(".")[1]

            def worst(rel):
                return (max(v for k, v in rel.items()
                            if k not in ("first", "second")),
                        rel["first"], rel["second"])

            top = sorted(rel_p.items(), key=lambda kv: -kv[1])[:3]
            log(f"[{smi}] UnFlow gradient, {name} model (its convolutions "
                f"float32), {len(UNFLOW_GRAD_PAIRS)} pairs at {UH}x{UW}, loss "
                f"mean(flow * R), parity mode, {len(gk) - 2} parameters and "
                f"both frames, max |diff| / max (worst parameter; first, "
                f"second frame): kernels vs plain backward on the kernels' "
                f"forward {worst(rel_h)} (limit {UNFLOW_GRAD_TOL['held']}"
                f"{' + 2^-8 on the frames' if rounded else ''}); vs the "
                f"plain forward and backward {worst(rel_p)} (limit "
                f"{UNFLOW_GRAD_TOL['whole']}; largest {top}); flows "
                f"{_rel(flow_k, flow_p):.3g} apart (max |flow| "
                f"{float(flow_p.abs().max()):.4g} px); forward + backward "
                f"{ms_k:.1f} ms through the kernels, {ms_h:.1f} with the "
                f"plain backward, {ms_p:.1f} plain; launches "
                f"{json.dumps({k: v for k, v in run.items() if v})}")
            del model
    _remat_run_a(smi)
    return launches, 1, times, bounds, library, errs


# ---- phase 11: the data-parallel slice -------------------------------------

#: ranks of phase 11's data-parallel run (both on cuda:0 over gloo: NCCL
#: refuses two ranks on one card) and its global batch, at run A's lr.
#: Parity of the float32 2-rank run with one process at the global batch:
#: the JAX package's 2-process test holds it to rtol 1e-4 / atol 1e-5
#: (tests/test_multihost_spawn.py, at 32x32), and so does this package's
#: CPU test (tests/test_torch_ddp.py). At 480x640 float32 rounding alone
#: moves more than that: a gradient element sums 1.2 M positions of both
#: signs, and a sum in another order differs by up to ~3e-3 of a tensor's
#: largest gradient, which Adam, whose step is ~lr whatever a gradient's
#: size, carries into the parameters. So the card holds the 2-rank run to
#: the rounding floor of one process: the same one-process run with the
#: global batch's rows in another order (rank 1's first; the batch norms
#: and the losses are sums, the same function of the rows in any order).
#: Found on the card: 7,271,266 of 221.8 M elements (gradients,
#: parameters, statistics, EMA) beyond the tolerance for the 2-rank run,
#: 7,086,283 for the reordered one; the largest parameter difference
#: 1.893e-4 against 1.891e-4; per tensor at most 2.45 times the reordered
#: run's largest difference. Each tensor must lie within the tolerance or
#: within DDP_FLOOR times the reordered run's largest difference, and the
#: elements beyond the tolerance number at most DDP_FLOOR_COUNT times the
#: reordered run's. Two controls, 2-rank runs with a planted fault
#: (``DDP_CONTROLS``), must fail the same gate, so the gate is shown to
#: refuse a wrong data-parallel run.
DDP_RANKS, DDP_GLOBAL_B, DDP_LR = 2, 4, 1e-4
DDP_TOL, DDP_FLOOR, DDP_FLOOR_COUNT = (1e-4, 1e-5), 4.0, 1.5
#: streams of the stream_shards check; legacy models' card-vs-CPU limit,
#: a share of each output's largest value on the CPU
SHARD_STREAM_FRAMES, LEGACY_TOL = 8, 1e-4


#: the faults planted in phase 11's control runs: each makes one thing of
#: the global batch rank-local again (the losses' partial sums, or the
#: batch norms' statistics and their backward sums)
DDP_CONTROLS = ("rank-local losses", "rank-local BN statistics")


@contextlib.contextmanager
def _ddp_control(name):
    """Within the block the fault ``name`` of ``DDP_CONTROLS`` is planted
    in this process."""
    from mfcnet_tpu_torch.models import common
    from mfcnet_tpu_torch.train import loss

    module, attr, fake = {
        "rank-local losses": (loss, "all_sum", lambda x: x),
        "rank-local BN statistics": (common, "group_world", lambda: 1),
    }[name]
    real = getattr(module, attr)
    setattr(module, attr, fake)
    try:
        yield
    finally:
        setattr(module, attr, real)


def _ddp_args(pack, out, dtype, batch, *extra):
    """Run A's flags (the base trained, RAFT x12 + depth in the step,
    grad_accum 2, EMA) in ``dtype`` at ``batch`` a process."""
    args = _train_args(pack, out, "ddp", "--train_base_model", "True",
                       "--compute_dtype", dtype, "--grad_accum",
                       str(TRAIN_ACCUM), "--ema_decay", "0.999", "--lr",
                       str(DDP_LR), *extra)
    args[args.index("--batch_size") + 1] = str(batch)
    return args


def _final_state(state):
    return {"model": {k: v.cpu() for k, v in state.model.state_dict().items()},
            "ema": {k: v.cpu() for k, v in state.ema.items()},
            "step": state.step, "updates": state.updates}


def _timed_run(cli, args):
    """The CLI in this process; (state, its micro-steps' records, peak
    bytes, launches over the run)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    with _timed_train_steps(cli) as recs:
        state = cli.main(args)
    torch.cuda.synchronize()
    return state, list(recs), torch.cuda.max_memory_allocated(), \
        _all_launches()


def ddp_rank(out, pack):
    """One rank of phase 11's 2-rank run (``python3 chip_smoke.py
    --ddp-rank OUT PACK``; ``RANK``, ``WORLD_SIZE`` and the address from
    the parent): run A's configuration at 480x640, ``--multihost true`` at
    half the global batch a rank, on ``cuda:0`` over ``gloo``; first in
    float32 in parity mode (its final state), then so with each fault of
    ``DDP_CONTROLS`` planted, then in bf16 (its micro-steps' ms, peak
    memory and launches). Writes ``OUT/rank{r}.pt``."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.parallel import init_distributed
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    rank, world = init_distributed(auto=True, device="cuda:0",
                                   backend="gloo", timeout_s=300)
    out = Path(out)
    mine = ("--device", "cuda:0", "--multihost", "true")
    b = DDP_GLOBAL_B // world
    with parity_mode(), _first_update_grads() as grads:
        state = cli.main(_ddp_args(pack, out / f"f32_{rank}", "float32", b,
                                   *mine))
    res = {"f32": {**_final_state(state), "grads": grads}}
    del state
    for name in DDP_CONTROLS:
        with parity_mode(), _first_update_grads() as grads, \
                _ddp_control(name):
            state = cli.main(_ddp_args(pack, out / f"{name}_{rank}",
                                       "float32", b, *mine))
        res[name] = {**_final_state(state), "grads": grads}
        del state
    state, recs, peak, launches = _timed_run(
        cli, _ddp_args(pack, out / f"bf16_{rank}", "bfloat16", b, *mine))
    res["bf16"] = {"recs": recs, "peak": peak, "launches": launches,
                   "micro": state.step}
    torch.save(res, out / f"rank{rank}.pt")
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ddp_ranks(out, pack, timeout=600):
    """Run the ranks of ``ddp_rank``; a rank that fails, or a run longer
    than ``timeout`` s, kills the others and raises with the rank's
    output."""
    import os
    from pathlib import Path

    port = str(_free_port())
    root = str(Path(__file__).resolve().parent)
    procs, logs = [], []
    for r in range(DDP_RANKS):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(DDP_RANKS), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        logs.append(open(Path(out) / f"rank{r}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
             str(out), str(pack)], env=env, cwd=root, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                r = bad[0] if bad else 0
                logs[r].seek(0)
                raise AssertionError(
                    f"data-parallel rank {r} "
                    + ("failed" if bad else f"ran past {timeout} s")
                    + ":\n" + logs[r].read()[-4000:])
            time.sleep(0.5)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                raise AssertionError(f"data-parallel rank {r} failed:\n"
                                     + logs[r].read()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return time.perf_counter() - t0


@contextlib.contextmanager
def _global_batches(cli, world):
    """Within the block the CLI's loader yields the global batches of a
    ``world``-rank run: its ranks' batches, rank 0's rows first, as the
    ranks hold them."""
    real = cli.get_data_loader

    def loaders(*a, shard=None, **kw):
        a = list(a)
        a[5] //= world
        parts = [real(*a, shard=(r, world), **kw) for r in range(world)]
        ranks = [tr for tr, _ in parts]
        for tr in ranks:
            tr.drop_last = True

        class Global:
            def __len__(self):
                return len(ranks[0])

            def set_epoch(self, epoch, skip_batches=0):
                for tr in ranks:
                    tr.set_epoch(epoch, skip_batches)

            def __iter__(self):
                for bs in zip(*ranks):
                    yield {k: np.concatenate([b[k] for b in bs])
                           for k in bs[0]}

        return Global(), parts[0][1]

    cli.get_data_loader = loaders
    try:
        yield
    finally:
        cli.get_data_loader = real


def _per_update_ms(recs):
    """Host ms of each optimizer step: its micro-steps' synchronized ms."""
    return [sum(r["ms"] for r in recs[i:i + TRAIN_ACCUM])
            for i in range(0, len(recs), TRAIN_ACCUM)]


def _deviation(got, want, scale=None):
    """(max |diff|, elements beyond ``DDP_TOL``) of two tensors; ``scale``
    (a gradient's largest element) takes the place of each element's own
    size in the tolerance."""
    rtol, atol = DDP_TOL
    d = (got.double() - want.double()).abs()
    size = want.double().abs() if scale is None else scale
    return float(d.max()), int((d > atol * (1 if scale is None else scale)
                                + rtol * size).sum())


def _ddp_parity(ranks, ref, floor):
    """Rank 0 equal to rank 1 bit for bit; against the one-process run
    ``ref``, each gradient of the first update (in its tensor's scale) and
    each floating tensor of the parameters, BN statistics and EMA no further
    than the one-process run ``floor`` of the rows in another order is (see
    ``DDP_TOL``). Returns a summary of both deviations, with ``bad``, what
    failed the gate (empty when the run passes)."""
    import torch

    out = dict(tensors=0, elements=0, beyond=0, floor_beyond=0,
               worst=0.0, floor_worst=0.0, grad=0.0, floor_grad=0.0,
               ranks_differ=0)
    out["bad"] = bad = []

    def hold(what, got, want, alt, scale=None):
        err, n = _deviation(got, want, scale)
        ferr, fn = _deviation(alt, want, scale)
        out["tensors"] += 1
        out["elements"] += got.numel()
        out["beyond"] += n
        out["floor_beyond"] += fn
        key = ("grad", "floor_grad") if scale is not None else (
            "worst", "floor_worst")
        div = scale if scale else 1.0
        out[key[0]] = max(out[key[0]], err / div)
        out[key[1]] = max(out[key[1]], ferr / div)
        if n and err > DDP_FLOOR * ferr:
            bad.append(f"{what}: max |diff| {err:.3g} (reordered "
                       f"{ferr:.3g}), {n} elements beyond the tolerance "
                       f"({fn})")

    g0, g1 = ranks[0]["grads"], ranks[1]["grads"]
    if len(g0) != len(ref["grads"]) or len(g1) != len(g0):
        raise AssertionError("data-parallel: the first update holds "
                             "another number of gradients")
    if not all(torch.equal(a, b) for a, b in zip(g0, g1)):
        bad.append("the ranks' first-update gradients differ")
    for i, (a, b, c) in enumerate(zip(g0, ref["grads"], floor["grads"])):
        hold(f"gradient {i} {tuple(b.shape)}", a, b, c,
             scale=float(b.abs().max()))
    for part in ("model", "ema"):
        r0, r1, want = ranks[0][part], ranks[1][part], ref[part]
        if r0.keys() != want.keys() or any(k.startswith("module.")
                                           for k in r0):
            raise AssertionError(f"data-parallel {part}: keys differ from "
                                 "the one-process run's")
        for k, v in r0.items():
            if not torch.equal(v, r1[k]):
                out["ranks_differ"] += 1
                bad.append(f"ranks differ in {part} {k}")
            if v.is_floating_point():
                hold(f"{part} {k}", v, want[k], floor[part][k])
    if out["beyond"] > DDP_FLOOR_COUNT * out["floor_beyond"]:
        bad.append(f"{out['beyond']} elements beyond the tolerance, the "
                   f"reordered run {out['floor_beyond']}")
    return out


@contextlib.contextmanager
def _reordered_rows(cli, order):
    """Within the block the CLI's train batches come out of augmentation
    with their rows in ``order``."""
    import torch

    real = cli.augment_train_batch
    idx = torch.tensor(order)

    def aug(*a, **kw):
        out = real(*a, **kw)
        return {k: v[idx.to(v.device)] for k, v in out.items()}

    cli.augment_train_batch = aug
    try:
        yield
    finally:
        cli.augment_train_batch = real


@contextlib.contextmanager
def _first_update_grads():
    """Within the block the first Adam step records the gradients it is
    handed (float32, on the CPU, in its parameter groups' order) into the
    list yielded."""
    import torch

    grads, real = [], torch.optim.Adam.step

    def step(self, *a, **kw):
        if not grads:
            grads.extend(p.grad.detach().float().cpu().clone()
                         for g in self.param_groups for p in g["params"]
                         if p.grad is not None)
        return real(self, *a, **kw)

    torch.optim.Adam.step = step
    try:
        yield grads
    finally:
        torch.optim.Adam.step = real


def _run_a_inputs():
    """Run A's batch (4 samples, seeded) on the card and its bf16 train
    step with the frozen RAFT."""
    import torch

    from mfcnet_tpu_torch.cli.train_multiframe_detection import build_flow_fn
    from mfcnet_tpu_torch.data.transforms import (
        TransformConfig,
        augment_train_batch,
    )
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    rng = np.random.default_rng(SEED)
    batch = augment_train_batch({
        "frames": rng.integers(0, 256, (TRAIN_B, T, H, W, 3), dtype=np.uint8),
        "mask": rng.integers(0, C, (TRAIN_B, H, W), dtype=np.uint8),
        "depth": rng.integers(0, 256, (TRAIN_B, T, H, W), dtype=np.uint8)},
        torch.Generator().manual_seed(SEED), TransformConfig(
            out_height=H, out_width=W), "cuda")
    flow_fn = build_flow_fn("RAFT", (H, W), None, "bfloat16", "cuda")
    step = make_multiframe_train_step(
        ["nll", "soft_jaccard"], [0.7, 0.3], C, flow_fn=flow_fn,
        compute_dtype="bfloat16")
    return batch, step


def _run_a_model(**kw):
    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights_lecun,
    )

    return init_weights_lecun(get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, **kw),
        torch.Generator().manual_seed(SEED)).cuda()


def _nccl_one_rank_step():
    """Run A's bf16 micro-step in a 1-rank ``nccl`` group through DDP
    against the same step with no group (parity mode): parameters and
    statistics equal bit for bit; an all-reduce over the group sums."""
    import os

    import torch
    import torch.distributed as dist

    from mfcnet_tpu_torch.parallel import init_distributed
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    batch, step = _run_a_inputs()
    env = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    sds = []
    try:
        with parity_mode():
            for grouped in (False, True):
                st = TrainState(_run_a_model(),
                                make_schedule("Constant", STEP_LR, 1, 1), T)
                if grouped:
                    if init_distributed(auto=True, device="cuda:0") != (0, 1):
                        raise AssertionError("1-rank group: rank/world")
                    if dist.get_backend() != "nccl":
                        raise AssertionError(dist.get_backend())
                    t = torch.full((4,), 3.0, device="cuda")
                    dist.all_reduce(t)
                    if t.tolist() != [3.0] * 4:
                        raise AssertionError(f"nccl all-reduce: {t}")
                    st.distribute()
                    if st.ddp is None:
                        raise AssertionError("no DDP under the group")
                step(st, batch)
                torch.cuda.synchronize()
                sds.append({k: v.clone() for k, v in
                            st.model.state_dict().items()})
                del st
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    differ = [k for k in sds[0] if not torch.equal(sds[0][k], sds[1][k])]
    if differ:
        raise AssertionError(f"1-rank nccl step differs from the groupless "
                             f"step: {differ[:5]}")
    return len(sds[0])


def _stream_shards_check(smi):
    """``stream_shards=2`` with both shards on cuda:0: TernausNetMulti-Basic
    + RAFT x12 at full width, float32 in parity mode, device decode, 4
    streams of SHARD_STREAM_FRAMES frames against the one-device 4-stream
    engine: per step the heats within 1e-3 and the rows' tip RMSE within
    0.5 px (BASELINE.json's gates), byte-equal rows counted."""
    import torch

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track import tracker as tr
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, generator=gen)
    flow = init_weights(RAFT(iters=FLOW_ITERS), gen)
    cfg = tr.TrackerConfig(input_height=H, input_width=W, dtype="float32",
                           decode="device", overlay=False,
                           decode_tie_fallback=False, add_optflow_inputs=True)
    streams = _stream_frames((SHARD_STREAM_FRAMES,) * 4)
    stacked = [np.stack([s[i] for s in streams])
               for i in range(SHARD_STREAM_FRAMES)]
    names = [f"s{b}" for b in range(4)]
    rows, heat, outs = {}, 0.0, {}
    with parity_mode():
        for shards in (1, 2):
            eng = tr.InferenceEngine(model, cfg, flow_model=flow,
                                     device="cuda:0", num_streams=4,
                                     stream_shards=shards,
                                     devices=("cuda:0",) * shards)
            outs[shards] = [eng.step_async(f) for f in stacked]
            with tempfile.TemporaryDirectory() as d:
                rows[shards], _ = tr._track_streams(
                    ((f, None, range(4)) for f in stacked),
                    [SHARD_STREAM_FRAMES] * 4, names, eng, cfg, d)
            del eng
    for a, b in zip(outs[1], outs[2]):
        if (a is None) != (b is None):
            raise AssertionError("stream_shards: warm-up differs")
        if a is not None:
            heat = max(heat, (a[2].float() - b[2].float()).abs().max().item())
    stats = [_tip_rmse(a, b) for a, b in zip(rows[1], rows[2])]
    equal = sum(int(np.array_equal(x, y, equal_nan=True))
                for a, b in zip(rows[1], rows[2]) for x, y in zip(a, b))
    log(f"[{smi}] stream_shards=2 (both on cuda:0) against the one-device "
        f"4-stream engine, RAFT x{FLOW_ITERS}, f32 parity mode, "
        f"{SHARD_STREAM_FRAMES} frames a stream: max |heat diff| {heat:.4g} "
        f"(limit 1e-3); tip RMSE per stream {[round(r, 6) for r, _ in stats]}"
        f" px (limit 0.5), rows whose detections differ "
        f"{[m for _, m in stats]}; rows byte-equal: {equal} of "
        f"{4 * SHARD_STREAM_FRAMES}")
    if heat > 1e-3 or max(r for r, _ in stats) > 0.5:
        raise AssertionError("stream_shards: rows depart from the "
                             "unsharded engine's")


def _tie_fallback_check(smi):
    """The device decode's re-decode of a tied side, with the tracker's
    default ``decode_tie_fallback``, on this machine: four 480x640 frames of
    seeded class maps and f16 heats whose both sides are flagged as tied go
    through the host decode's scipy twin, which needs no OpenCV (the CPU
    test holds its rows equal to the OpenCV decode's). Every frame must find
    both bases."""
    import importlib.util

    from mfcnet_tpu_torch.track.tracker import KeypointTracker, TrackerConfig

    rng = np.random.default_rng(SEED)
    tracker = KeypointTracker(4, TrackerConfig(decode="device"))
    t0 = time.perf_counter()
    for _ in range(4):
        pred = np.zeros((H, W), np.int64)
        for cls in (1, 2, 3, 4):
            y, x = rng.integers(0, H - 80), rng.integers(0, W - 80)
            pred[y:y + rng.integers(20, 80), x:x + rng.integers(20, 80)] = cls
        heat = rng.random((H, W, 2)).astype(np.float16)
        kps = np.zeros((2, 3, 3))
        kps[:, 2] = (1.0, 1.0, 2.0)  # both bases flagged as tied
        tracker.update_device(kps, mask_provider=lambda p=pred: p,
                              heat_provider=lambda h=heat: h)
    ms = (time.perf_counter() - t0) * 1e3 / 8
    if np.isnan(tracker.rows[:, 8:]).any():
        raise AssertionError(f"tie re-decode lost a base: {tracker.rows}")
    log(f"[{smi}] tie re-decode (decode_tie_fallback on) at {H}x{W}: 8 "
        f"sides, {ms:.2f} ms a side on the host; OpenCV importable here: "
        f"{importlib.util.find_spec('cv2') is not None}")


def _legacy_checks(smi):
    """The legacy models and ABN at full width, seeded weights, f32 forwards
    at 480x640 on the card (parity mode) against the same modules on the
    CPU: every output within LEGACY_TOL of its largest value."""
    import copy as copy_mod

    import torch

    from mfcnet_tpu_torch.models import init_weights_lecun
    from mfcnet_tpu_torch.models import legacy
    from mfcnet_tpu_torch.models.abn import ABN
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(1, 3, H, W, generator=gen)
    models = {
        "PAFDetectionModel": legacy.PAFDetectionModel(5, 4),
        "ResNet50CSL": legacy.ResNet50CSL(5, 4),
        "KurmannEtAl2017Net": legacy.KurmannEtAl2017Net(5, 2,
                                                        input_hw=(H, W)),
    }
    worst = {}
    with parity_mode(), torch.no_grad():
        for name, m in models.items():
            m = init_weights_lecun(m, gen).eval()
            t0 = time.perf_counter()
            want = m(x)
            cpu_s = time.perf_counter() - t0
            got = copy_mod.deepcopy(m).cuda()(x.cuda())
            worst[name] = (max(
                float((g.cpu() - w).abs().max()) / float(w.abs().max())
                for g, w in zip(got, want)), round(cpu_s, 2))
        for act in ("leaky_relu", "elu", "none"):
            a = ABN(64, activation=act)
            y = torch.randn(2, 64, H // 4, W // 4, generator=gen) * 2 + 0.5
            for mode in ("train", "eval"):
                getattr(a, mode)()
                ac = copy_mod.deepcopy(a).cuda()
                want, got = a(y), ac(y.cuda()).cpu()
                if mode == "train":  # the running statistics updated too
                    stat = max(float((ac.running_var.cpu() - a.running_var
                                      ).abs().max()), float(
                        (ac.running_mean.cpu() - a.running_mean).abs().max()))
                    if stat > LEGACY_TOL:
                        raise AssertionError(f"ABN {act}: statistics {stat}")
                worst[f"ABN {act} {mode}"] = (float(
                    (got - want).abs().max()) / float(want.abs().max()), 0)
    log(f"[{smi}] legacy models and ABN, f32 at {H}x{W} on the card against "
        f"the CPU (max |diff| / max |CPU output|, CPU s): {json.dumps(worst)}")
    bad = {k: v for k, v in worst.items() if v[0] > LEGACY_TOL}
    if bad:
        raise AssertionError(f"legacy models: beyond {LEGACY_TOL}: {bad}")


def phase_ddp_slice(smi):
    """The data-parallel slice (ROADMAP items 11d and 10d). Returns (the
    2-rank bf16 run's launches summed over the ranks, micro-steps times
    ranks)."""
    from pathlib import Path

    import torch

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        pack = make_synthetic_pack(d / "pack", videos=(
            ("train", 3, 8), ("val", 1, 2)), height=H, width=W, seed=SEED)
        wall = _spawn_ddp_ranks(d, pack)
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(DDP_RANKS)]
        t0 = time.perf_counter()
        refs = []
        for order in (None, (2, 3, 0, 1)):
            with parity_mode(), _global_batches(cli, DDP_RANKS), \
                    _first_update_grads() as grads, (
                        _reordered_rows(cli, order) if order
                        else contextlib.nullcontext()):
                refs.append({**_final_state(cli.main(_ddp_args(
                    pack, d / f"one{len(refs)}", "float32",
                    DDP_GLOBAL_B))), "grads": grads})
        ref, floor = refs
        one, recs1, peak1, _ = _timed_run(cli, _ddp_args(
            pack, d / "one_bf16", "bfloat16", DDP_GLOBAL_B))
        del one
        wall1 = time.perf_counter() - t0
    if not (ranks[0]["f32"]["step"] == ref["step"] == 6
            and ranks[0]["f32"]["updates"] == ref["updates"] == 3):
        raise AssertionError(f"data-parallel: steps {ranks[0]['f32']['step']}"
                             f" / one process {ref['step']}")
    par = _ddp_parity([r["f32"] for r in ranks], ref, floor)
    if par["bad"]:
        raise AssertionError(f"data-parallel run further from one process "
                             f"than the rounding floor: {par['bad'][:8]} "
                             f"({len(par['bad'])} failures; {par})")
    log(f"[{smi}] data-parallel run A ({DDP_RANKS} ranks on cuda:0 over "
        f"gloo, {DDP_GLOBAL_B // DDP_RANKS} samples a rank, global batch "
        f"{DDP_GLOBAL_B}, f32 parity mode, lr {DDP_LR}, 3 updates of 2 "
        f"micro-steps): the first update's gradients, parameters, BN "
        f"statistics and EMA equal across ranks bit for bit; against one "
        f"process at batch {DDP_GLOBAL_B}, {par['tensors']} tensors of "
        f"{par['elements']} elements: gradients within {par['grad']:.3g} of "
        f"each tensor's largest (the same run with its rows reordered: "
        f"{par['floor_grad']:.3g}), parameters, statistics and EMA within "
        f"{par['worst']:.3g} ({par['floor_worst']:.3g}); elements beyond "
        f"rtol {DDP_TOL[0]} / atol {DDP_TOL[1]}: {par['beyond']} "
        f"({par['floor_beyond']}; limit {DDP_FLOOR_COUNT}x), every tensor "
        f"within {DDP_FLOOR}x the reordered run's largest difference; the "
        f"ranks' runs took {wall:.1f} s, the one-process runs {wall1:.1f} s")
    for name in DDP_CONTROLS:
        ctl = _ddp_parity([r[name] for r in ranks], ref, floor)
        if not ctl["bad"]:
            raise AssertionError(f"the parity gate passed a 2-rank run with "
                                 f"{name}: {ctl}")
        log(f"[{smi}] control, the 2-rank run with {name} (it must fail "
            f"the gate, and does): gradients within {ctl['grad']:.3g} of "
            f"each tensor's largest, parameters, statistics and EMA within "
            f"{ctl['worst']:.3g}; elements beyond the tolerance "
            f"{ctl['beyond']}; tensors that differ between the ranks "
            f"{ctl['ranks_differ']}; {len(ctl['bad'])} failures, the first "
            f"{ctl['bad'][:3]}")
    # the micro-steps' launches (the run's total adds validation's)
    recs = [rec for rk in ranks for rec in rk["bf16"]["recs"]]
    launches = {k: sum(rec["launches"][k] for rec in recs)
                for k in recs[0]["launches"]}
    n_micro = len(recs)
    total = {k: sum(rk["bf16"]["launches"][k] for rk in ranks)
             for k in ("raft_update", "flow_warp", "flow_warp_bwd")}
    _require_launches("train_ddp", launches)
    for r, rk in enumerate(ranks):
        for i, rec in enumerate(rk["bf16"]["recs"]):
            lc = rec["launches"]
            if (lc["flow_warp_bwd"], lc["raft_update"],
                    lc["flow_warp"]) != (1, FLOW_ITERS, 1):
                raise AssertionError(f"rank {r} micro-step {i}: {lc}")
    upd = [_per_update_ms(rk["bf16"]["recs"]) for rk in ranks]
    upd1 = _per_update_ms(recs1)
    log(f"[{smi}] data-parallel run A, bf16, ms per optimizer step (2 "
        f"micro-steps; the first includes warm-up): rank 0 "
        f"{[round(x, 2) for x in upd[0]]}, rank 1 "
        f"{[round(x, 2) for x in upd[1]]}; one process at batch "
        f"{DDP_GLOBAL_B}: {[round(x, 2) for x in upd1]}; peak "
        f"max_memory_allocated "
        f"{[round(rk['bf16']['peak'] / 2 ** 30, 3) for rk in ranks]} GiB a "
        f"rank, {peak1 / 2 ** 30:.3f} GiB one process; per micro-step and "
        f"rank 1 flow_warp_bwd, {FLOW_ITERS} raft_update, 1 flow_warp "
        f"({n_micro} rank micro-steps; with validation the runs launched "
        f"{json.dumps(total)})")
    t0 = time.perf_counter()
    n_sd = _nccl_one_rank_step()
    log(f"[{smi}] 1-rank nccl group: an all-reduce sums, and run A's bf16 "
        f"micro-step through DDP equals the groupless step bit for bit "
        f"({n_sd} tensors; {time.perf_counter() - t0:.1f} s)")
    for check in (_stream_shards_check, _tie_fallback_check,
                  _legacy_checks):
        t0 = time.perf_counter()
        check(smi)
        log(f"{check.__name__}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return launches, n_micro


#: phase 12's runs: frames of each (lockstep steps of the streams run), and
#: the frames timed each way
FUSED_FRAMES = {"no_flow": 64, "raft": FLOW_FRAMES, "streams": 12,
                "large": 8, "shards": 8, "unflow": 6, "ffpp": 6}
FUSED_TIMED = 24
#: steps in the profiled window of each way
FUSED_PROFILED = 4
#: the device kernels a launch of each hand kernel runs, as the profiler's
#: trace names them, and how many (the RAFT update step is a chain of 8
#: launches, ``csrc/raft_update.cu``: N_STAGES); the correlation's routes
TRACE_KERNELS = {
    "connected_components": (r"\bk_cc_labels\b", 1),
    "flood_cc_cid": (r"\bk_flood_cc_cid\b", 1),
    "union_flood_cc_cid": (r"\bk_union_flood_cc_cid\b", 1),
    "onehot_stats": (r"\bk_onehot_stats\b", 1),
    "flow_warp": (r"\bflow_warp_kernel<", 1),
    "backward_warp": (r"\bbackward_warp_kernel<", 1),
    "correlation": (r"\b(fma|tc)_kernel<", 1),
    "raft_update": (r"\btma_conv_kernel<", 8),
    "graph_if": (r"\bset_condition_kernel\b", 1),
}


def _fused_pair(src, dtype, **kw):
    """(unfused, fused) engines on the card with the weights of the engine
    ``src`` (its copies of the model and provider) in ``dtype``; ``kw``
    goes to ``InferenceEngine`` (``num_streams`` by default ``src``'s)."""
    import dataclasses

    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    cfg = dataclasses.replace(src.cfg, dtype=dtype, overlay=False,
                              decode="device", decode_tie_fallback=False)
    kw.setdefault("num_streams", src.num_streams)
    return tuple(InferenceEngine(
        src.model, dataclasses.replace(cfg, fused_dispatch=f),
        flow_model=src.flow_model, **kw)
        for f in (False, True))


def _step_graphs(engine):
    """The captured steps of an engine: one, or one per stream shard."""
    return [e.step_graph for e in getattr(engine, "engines", [engine])]


def _graph_pool_mib(engine):
    """MiB of the card's memory that the captured steps' pools (each
    graph's and its IF bodies') hold."""
    import torch

    pools = {tuple(p) for g in _step_graphs(engine)
             for p in (g.graph.pool(), *g.pools)}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools) / 2 ** 20


def _fused_against_unfused(what, pair, frames_dev, smi, depth_dev=None):
    """Both engines over ``frames_dev`` (device-resident frames, or
    (B, H, W, 3) stacks; ``depth_dev`` their depth maps): every output
    byte-equal, one replay a frame after the first fused one (in each
    shard), no host synchronization from the capture on (the card's sync
    debug mode set to raise), the same tiers and the same launches. Returns
    the fused run's launches and fused frames."""
    import torch

    from mfcnet_tpu_torch.ops import graph_cond
    from mfcnet_tpu_torch.track import decode_device as dd

    n = len(frames_dev)
    outs, tiers, launches = {}, {}, {}
    for name, e in zip(("unfused", "fused"), pair):
        e.reset()
        _reset_all_launches()
        dd.reset_tier_counts()
        got = []
        try:
            for i, f in enumerate(frames_dev):
                if name == "fused" and i == T:  # captured at frame T-1
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                got.append(e.step_async(
                    f, None if depth_dev is None else depth_dev[i]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        graph_cond.drain()  # the replays' tiers and IF-body launches
        tiers[name] = dict(dd.TIER_COUNTS)
        launches[name] = _all_launches()
        outs[name] = got
    fused = pair[1]
    replays = [g.replays for g in _step_graphs(fused)]
    differ = {}
    for a, b in zip(outs["unfused"], outs["fused"]):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: fused and unfused warm up apart")
        for k, x, y in zip(("mask", "kps", "heats"), a or (), b or ()):
            if not torch.equal(x, y):
                differ[k] = max(differ.get(k, 0.0), (
                    x.double() - y.double()).abs().max().item())
    same_launches = {k: v for k, v in launches["fused"].items()
                     if k != "graph_if"} == {
        k: v for k, v in launches["unfused"].items() if k != "graph_if"}
    log(f"[{smi}] fused step, {what}: {n} frames, {replays} replays (one a "
        f"frame after the first fused frame, per graph), no host sync in "
        f"them; masks, "
        f"kps, heats byte-equal to the unfused engine's: "
        f"{'yes' if not differ else json.dumps(differ)}; tiers fused "
        f"{json.dumps(tiers['fused'])} unfused {json.dumps(tiers['unfused'])}; "
        f"launches equal: {same_launches} (graph_if "
        f"{launches['fused']['graph_if']}); graph pools "
        f"{_graph_pool_mib(fused):.1f} MiB")
    if differ:
        raise AssertionError(f"{what}: fused != unfused {differ}")
    if set(replays) != {n - T} or tiers["fused"] != tiers["unfused"] \
            or not same_launches:
        raise AssertionError(f"{what}: {replays} replays for {n} frames, "
                             f"tiers {tiers}, launches {launches}")
    return launches["fused"], n - (T - 1)


def _fused_path(paths, key, *args):
    """One path of phase 12 into ``paths``, its kernels required."""
    paths[key] = _fused_against_unfused(*args)
    _require_launches(key, paths[key][0])


def _trace_kernel_counts(names, launches, outside_ifs):
    """{hand kernel: (device kernels of it among the trace's event
    ``names``, the number its counted ``launches`` make, the number the
    launches outside IF bodies make)}, for every kernel of
    :data:`TRACE_KERNELS` that either names."""
    out = {}
    for key, (pattern, per) in TRACE_KERNELS.items():
        found = sum(1 for n in names if re.search(pattern, n))
        if found or launches[key]:
            out[key] = (found, launches[key] * per,
                        outside_ifs.get(key, 0) * per)
    return out


def _outside_ifs(engine, replays):
    """Launches by kernel name that ``replays`` replays of each captured
    step of ``engine`` make outside their IF bodies (the replay
    accounting's own record, ``StepGraph._main``)."""
    out = {}
    for g in _step_graphs(engine):
        for (_, k), v in g._main.items():
            out[k] = out.get(k, 0) + v * replays
    return out


def _fused_timing(what, pair, frames_dev, smi):
    """Frames/s of both engines on device-resident frames (host clock, after
    a warm-up that captures the fused step), and a profiled window of
    FUSED_PROFILED steps each way (the first of up to 3 sessions whose
    trace is whole and whose hand kernels agree with the launch counts):
    the device's busy ms a step (the union of its kernels' spans), its idle
    share (1 - busy over the window's wall time), and each hand kernel's
    device kernels in the session's trace against what the launch counts
    of the same steps make (the fused way's counts are the replay
    accounting's, ``ops/graph_cond.py``). The fused way must give a whole
    trace, in which each hand kernel must appear at least as often as the
    launches outside the IF bodies make and at most as often as all counted
    launches make: the card's trace loses kernels inside IF bodies (the
    cooperative launches of ``cc.cu`` most, all of them at 4 streams; the
    tiers and outputs that need them are checked elsewhere), which is
    logged as each way's shortfall. Returns {way: {frames_per_s,
    busy_ms_per_step, ops_per_step, idle_share, trace_short}}."""
    import torch

    from mfcnet_tpu_torch.ops import graph_cond

    out = {}
    for name, e in zip(("unfused", "fused"), pair):
        e.reset()
        it = iter(range(10 ** 9))

        def one():
            return e.step_async(frames_dev[next(it) % len(frames_dev)])

        for _ in range(T + 1):
            one()
        ms = _host_ms(one, FUSED_TIMED)
        sessions = []
        for _ in range(3):
            _reset_all_launches()
            _, events, whole, wall, rest = _profiled(
                lambda: [one() for _ in range(FUSED_PROFILED)], spans=True,
                outside=True)
            graph_cond.drain()
            launches = _all_launches()
            counts = _trace_kernel_counts(
                [ev[0] for ev in events] + rest, launches,
                _outside_ifs(e, FUSED_PROFILED) if name == "fused"
                else launches)
            short = {k: v[:2] for k, v in counts.items() if v[0] != v[1]}
            sessions.append("agree" if whole and not short
                            else json.dumps(short) if whole else "not whole")
            if whole and not short:
                break
        busy = _busy_ms(events)
        out[name] = {"frames_per_s": e.num_streams * 1e3 / ms,
                     "busy_ms_per_step": busy / FUSED_PROFILED,
                     "ops_per_step": len(events) / FUSED_PROFILED,
                     "idle_share": 1 - busy / wall if whole else None,
                     "trace_short": short if whole else None}
        log(f"[{smi}] {what}, {name}: {out[name]['frames_per_s']:.2f} "
            f"frames/s in all ({ms:.3f} ms a step of {e.num_streams} "
            f"frame(s), {FUSED_TIMED} device-resident steps after the "
            f"warm-up); {FUSED_PROFILED} steps under the profiler: "
            f"{len(events)} device operations, busy {busy:.2f} of "
            f"{wall:.2f} ms wall"
            + (f" (idle share {1 - busy / wall:.1%})" if whole
               else " (trace not whole: no idle share)")
            + f"; hand kernels in the trace against the launch counts: "
            f"{json.dumps(counts)} ({len(rest)} events out of order); "
            f"sessions {sessions}")
        if name == "fused" and not whole:
            raise AssertionError(f"{what}: no whole trace of the fused "
                                 "steps in 3 sessions")
        wrong = {k: v for k, v in counts.items() if not v[2] <= v[0] <= v[1]}
        if whole and wrong:
            raise AssertionError(
                f"{what}, {name}: hand kernels in the trace outside [the "
                f"launches outside IF bodies, all launches]: {wrong}")
    torch.cuda.synchronize()
    return out


def _check_graph_if(smi):
    """The IF nodes against their plain version (the flags read on the
    host): a graph whose step is ``run_if(a, body, orelse)`` with a
    ``run_if(b, ...)`` nested in ``body`` (the decode's shape), replayed
    with every pair of flags and counted on the card; a graph of one IF
    node, its replay time beside the host read's; and no fallback: a step
    that reads the card from the host fails its capture, and the card works
    on after it. Returns (max |difference|, (ms, plain ms))."""
    import torch

    from mfcnet_tpu_torch.ops import graph_cond

    x = torch.zeros(1, device="cuda")
    a, b = (torch.zeros((), dtype=torch.bool, device="cuda")
            for _ in range(2))

    def nested(t):
        def body():
            t.add_(1.0)
            graph_cond.run_if(b, lambda: t.add_(10.0),
                              lambda: t.add_(100.0))

        graph_cond.run_if(a, body, lambda: t.add_(1000.0))
        return (t,)

    g = graph_cond.StepGraph("cuda")
    g.capture(lambda: nested(x))
    graph_cond.reset_launches()
    err = 0.0
    for fa, fb in ((False, False), (True, False), (True, True),
                   (False, True), (True, True)):
        a.fill_(fa)
        b.fill_(fb)
        want = x.clone()
        nested(want)
        g.replay()
        err = max(err, (x - want).abs().max().item())
    g.drain()
    # 2 top-level condition kernels a replay, 2 nested in each of the 3
    # replays with a set
    if_launches = graph_cond.LAUNCHES["graph_if"]
    if if_launches != 2 * 5 + 2 * 3:
        raise AssertionError(f"graph_if: {if_launches} condition kernels "
                             "counted for 16 run")
    one = torch.zeros(1, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    g1 = graph_cond.StepGraph("cuda")
    g1.capture(lambda: graph_cond.run_if(flag, lambda: one.add_(1.0)))
    ms = _event_ms(g1.replay, 200)
    plain = _host_ms(lambda: graph_cond.run_if(flag, lambda: one.add_(1.0)),
                     200)
    g1.drain()

    def syncing():
        return (x + float(x.sum().item()),)

    try:
        graph_cond.StepGraph("cuda").capture(syncing)
    except RuntimeError as e:
        refused = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("a host read inside a captured step did not "
                             "raise")
    torch.cuda.synchronize()
    if (torch.ones(4, device="cuda") * 2).sum().item() != 8.0:
        raise AssertionError("the card is not usable after a failed capture")
    log(f"[{smi}] graph_if: an IF node with its else and an if/else nested "
        f"in it, 5 replays over the four pairs of flags, equal to the "
        f"host-read version (max |diff| {err}), {if_launches} condition "
        f"kernels counted; a graph of one IF node (flag off) "
        f"{ms * 1e3:.2f} us a replay between CUDA events, the host read and "
        f"skip {plain * 1e3:.2f} us; a syncing step's capture raised: "
        f"{refused}")
    if err:
        raise AssertionError("graph_if != its plain version")
    return err, (ms, plain)


def _tier_class_maps():
    """(tier, (H, W) class map) at 480x640 for each of the decode's tiers:
    separate boxes of the four classes (union); a tip blob inside a hole of
    a base blob's ring inside a hole of another, which the union image
    cannot hold (per-blob); more than K specks of one class (exact)."""
    clean = np.zeros((H, W), np.int32)
    for cls, (y, x) in zip((1, 2, 3, 4), ((40, 60), (40, 400), (300, 60),
                                          (300, 400))):
        clean[y:y + 80, x:x + 120] = cls
    conflict = np.zeros((H, W), np.int32)
    conflict[80:320, 300:540] = 2
    conflict[120:280, 340:500] = 0
    conflict[140:260, 360:480] = 4
    conflict[180:220, 400:440] = 0
    conflict[360:460, 40:200] = 1
    specks = np.zeros((H, W), np.int32)
    specks[::3, ::3] = 4
    specks[200:300, 100:400] = 3
    specks[50:150, 450:600] = 1
    return (("union", clean), ("per_blob", conflict), ("exact", specks))


def _check_decode_tiers(smi):
    """The device decode captured alone at 480x640, replayed on a class map
    of each tier: rows equal to the decode run eagerly (its choices read on
    the host), and ``TIER_COUNTS`` from the card's runs of the branches
    naming the tier -- the union tier too, which the random models' maps
    never take. Returns the replays' tiers."""
    import torch

    from mfcnet_tpu_torch.ops import graph_cond
    from mfcnet_tpu_torch.track import decode_device as dd

    maps = _tier_class_maps()
    rng = np.random.default_rng(SEED)
    probs = torch.from_numpy(rng.random((H, W, 5), np.float32)).cuda()
    pred = torch.zeros((H, W), dtype=torch.int32, device="cuda")
    pred.copy_(torch.from_numpy(maps[0][1]))
    dd.decode_keypoints_device(probs, 100, pred=pred)  # eager first
    g = graph_cond.StepGraph("cuda")
    rows = g.capture(lambda: dd.decode_keypoints_device(probs, 100,
                                                        pred=pred))
    got = {}
    for tier, m in maps:
        pred.copy_(torch.from_numpy(m))
        dd.reset_tier_counts()
        want = dd.decode_keypoints_device(probs, 100, pred=pred)
        eager = dict(dd.TIER_COUNTS)
        dd.reset_tier_counts()
        g.replay()
        same = torch.equal(rows, want)
        graph_cond.drain()
        got[tier] = dict(dd.TIER_COUNTS)
        if not same or got[tier] != eager or got[tier][tier] != 1:
            raise AssertionError(
                f"decode tier {tier}: replayed rows equal the eager ones: "
                f"{same}; tiers replayed {got[tier]}, eager {eager}")
    dd.reset_tier_counts()
    log(f"[{smi}] the decode captured alone at {H}x{W}: one replay on a "
        f"class map of each tier, rows equal to the eager decode's, tiers "
        f"counted from the card: {json.dumps(got)}")
    return got


def phase_fused_slice(engine, flow_engine, large, streams_engine,
                      unflow_engine, ffpp_engine, frames, uframes, smi):
    """Phase 12, ``fused_dispatch``: each main tracker path with its step
    captured as one CUDA graph against the same path unfused. Returns
    ({path: (launches, fused frames)}, graph_if's error, its times)."""
    import torch

    from mfcnet_tpu_torch.utils.profiling import parity_mode

    paths, timings = {}, {}
    dev = torch.from_numpy(frames).cuda()
    for what, src in (("no_flow", engine), ("raft", flow_engine)):
        n = FUSED_FRAMES[what]
        pair = _fused_pair(src, "bfloat16")
        _fused_path(paths, f"fused_{what}", f"{what}, bf16", pair, dev[:n],
                    smi)
        timings[what] = _fused_timing(f"{what}, bf16", pair, dev[:n], smi)
        del pair
        with parity_mode():
            _fused_against_unfused(f"{what}, f32 (parity mode)",
                                   _fused_pair(src, "float32"), dev[:n], smi)
    n = FUSED_FRAMES["streams"]
    stacks = torch.stack([dev[(torch.arange(n) + 7 * b) % len(dev)]
                          for b in range(streams_engine.num_streams)], 1)
    what = f"{streams_engine.num_streams} streams, RAFT, bf16"
    pair = _fused_pair(streams_engine, "bfloat16")
    _fused_path(paths, "fused_streams", what, pair, stacks, smi)
    timings["streams"] = _fused_timing(what, pair, stacks, smi)
    del pair
    n = FUSED_FRAMES["large"]
    _fused_path(paths, "fused_large", "Large, RAFT and depth, bf16",
                _fused_pair(large[0], "bfloat16"), dev[:n], smi,
                torch.from_numpy(large[1][:n]).cuda())
    # two stream shards on this one card: a graph each
    n = FUSED_FRAMES["shards"]
    _fused_against_unfused(
        "2 streams over 2 stream shards (both on cuda:0), no flow, bf16",
        _fused_pair(engine, "bfloat16", num_streams=2, stream_shards=2,
                    devices=["cuda:0", "cuda:0"]),
        torch.stack([dev[:n], dev[n:2 * n]], 1), smi)
    udev = torch.from_numpy(uframes[:FUSED_FRAMES["unflow"]]).cuda()
    _fused_path(paths, "fused_unflow", "UnFlow, bf16",
                _fused_pair(unflow_engine, "bfloat16"), udev, smi)
    _fused_path(paths, "fused_ffpp", "FFPP, bf16",
                _fused_pair(ffpp_engine, "bfloat16"),
                dev[:FUSED_FRAMES["ffpp"]], smi)
    err, times = _check_graph_if(smi)
    _check_decode_tiers(smi)
    log(json.dumps({"fused_step_timings": timings}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return paths, err, times


def main():
    # the port itself, from this checkout (fails in a bare directory)
    import mfcnet_tpu_torch  # noqa: F401

    t_start = time.perf_counter()

    def done(what):
        """When each phase ended: where the script's time limit goes."""
        log(f"chip_smoke: {what} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    errs = phase_kernels()
    done("phases 1-2")
    frames = synthetic_frames(64)
    uframes = synthetic_frames(UNFLOW_FRAMES, hw=(UH, UW))
    engine, launches_noflow, _ = phase_slice(frames)
    flow_engine, launches_raft, fused_raft = phase_flow_slice(frames)
    large_engine, large_depth, launches_large, fused_large = \
        phase_large_slice(frames)
    streams_engine, launches_streams, steps_streams = phase_streams_slice()
    done("phase 3: no flow, RAFT, Large, streams")
    unflow_engine, launches_unflow, fused_unflow = phase_unflow_slice(uframes)
    ffpp_engine, launches_ffpp, fused_ffpp = phase_ffpp_slice(frames)
    phase_offline(uframes, smi)
    done("phase 3: UnFlow, FFPP, offline")
    _, times, bounds, library = phase_timings(engine, frames, smi)
    for t, b, lib in (phase_flow_timings(flow_engine, frames, smi),
                      phase_unflow_timings(unflow_engine, uframes, smi),
                      phase_stream_timings(engine, flow_engine,
                                           (large_engine, large_depth),
                                           streams_engine, smi)):
        times.update(t)
        bounds.update(b)
        library.update(lib)
    phase_ffpp_timings(ffpp_engine, frames, smi)
    done("phase 4")
    fused_paths, errs["graph_if"], times["graph_if"] = phase_fused_slice(
        engine, flow_engine, (large_engine, large_depth), streams_engine,
        unflow_engine, ffpp_engine, frames, uframes, smi)
    # one byte of flag read, the 8-byte run counter read and written
    bounds["graph_if"] = (17 / PEAK_BYTES * 1e3, "bytes")
    library["graph_if"] = None
    done("phase 12")
    zoo_paths = phase_zoo_slice(engine, frames, smi)
    done("phase 6")
    zoo_paths.update(phase_zoo10b_slice(engine, frames, smi))
    done("phase 7")
    zoo_paths.update(phase_eval_slice(frames, smi))
    done("phase 8")
    zoo_paths.update(phase_artifact_slice(engine, flow_engine, frames, smi))
    done("phase 9")
    launches_grad, n_grad, t, b, lib, e = phase_unflow_grad_slice(smi)
    done("phase 10")
    launches_ddp, n_ddp = phase_ddp_slice(smi)
    done("phase 11")
    for d, new in ((times, t), (bounds, b), (library, lib), (errs, e)):
        d.update(new)
    (launches_train, n_micro, t, b, lib, errs["flow_warp_bwd"],
     (launches_train_ffpp, n_micro_ffpp)) = phase_train(smi)
    done("phase 5")
    times.update(t)
    bounds.update(b)
    library.update(lib)
    import torch

    # per frame on the tracker paths (a lockstep step of the streams path
    # fuses one frame of each stream, padding included), per micro-step on
    # the training path
    paths = {"no_flow": (launches_noflow, len(frames) - (T - 1)),
             "raft": (launches_raft, fused_raft),
             "large": (launches_large, fused_large),
             "streams": (launches_streams,
                         steps_streams * len(STREAM_LENGTHS)),
             "unflow": (launches_unflow, fused_unflow),
             "ffpp": (launches_ffpp, fused_ffpp),
             "train": (launches_train, n_micro),
             "train_ffpp": (launches_train_ffpp, n_micro_ffpp),
             "unflow_grad": (launches_grad, n_grad),
             # per micro-step and rank
             "train_ddp": (launches_ddp, n_ddp),
             **fused_paths,
             **zoo_paths}
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         # over the main-path runs, each counted from 0
         "launches": sum(c[name] for c, _ in paths.values()),
         "launches_by_path": {p: c[name] for p, (c, _) in paths.items()},
         "launches_per_frame": {p: c[name] / n for p, (c, n) in paths.items()},
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name),
         # the kernel's other calls on the main path
         "calls": {k.split("@")[1]: {
             "ms": times[k][0], "plain_ms": times[k][1],
             "bound_ms": bounds[k][0], "library_ms": library.get(k)}
             for k in times if k.startswith(name + "@")}}
        for name, source, replaces in KERNELS
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank(*sys.argv[2:4])
    else:
        main()
