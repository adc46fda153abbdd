"""End-to-end video tracking (counterpart of
``mfcnet_tpu/track/tracker.py``): the rolling T-frame window, the
per-frame model forward, class decode, per-side tip/base keypoints with
area/distance gating and 2-tip temporal assignment, the N x 12 CSV and
the optional overlay MP4.

Incremental mode (default) runs one base forward per new frame and keeps
the previous frames' class maps in a ring buffer on the device; full mode
recomputes all T base forwards per frame (the reference's pattern). Both
give the same rows. With ``add_optflow_inputs`` a frozen flow provider
(RAFT, FlowFormer++, UnFlow) gives the flow from the newest frame to each
earlier one, by which the fusion head warps the earlier maps; incremental
mode keeps a ring of the provider's per-frame features where the provider
has split encoders (RAFT, FlowFormer++) and a ring of normalized frames
where it has none (UnFlow). With ``add_depth_inputs`` a depth map per
frame joins the head's input. The Large variant's head takes the same
flow raw.

``InferenceEngine(num_streams=B)`` and :func:`track_on_frame_streams`
track B videos in lockstep, one batched step per frame; each stream's
rows are those of its own run.

No module-level ``cv2``: OpenCV is imported only to read video, to draw
the overlay and for the exact host decode (``decode='host'`` or a
tie-flagged side), none of which the device-decode path without overlay
touches.

CSV layout (N x 12, NaN = missing):
  [ltip1 x, ltip1 y, ltip2 x, ltip2 y, rtip1 x, rtip1 y, rtip2 x, rtip2 y,
   lbase x, lbase y, rbase x, rbase y]
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from mfcnet_tpu_torch.configs.parsers import SPATIAL_SHARDS_LEFT_OUT

_ROADMAP = {
    "spatial_shards": SPATIAL_SHARDS_LEFT_OUT,
    "fused_dispatch": "ROADMAP.md Queue 1 item 11a (the step as a CUDA graph)",
}


@dataclasses.dataclass
class TrackerConfig:
    """The JAX package's TrackerConfig fields; options of later slices
    must stay at their defaults (:meth:`check_ported`)."""

    num_input_frames: int = 3
    num_classes: int = 5
    input_height: int = 480
    input_width: int = 640
    score_detection_threshold: float = 0.0
    area_threshold: float = 10.0
    dist_threshold: float = 40.0
    mode: str = "incremental"  # 'incremental' | 'full'
    decode: str = "host"  # 'host' (exact parity) | 'device'
    #: device decode: re-decode a tie-flagged side with the exact host
    #: decode on scipy (fetches that frame's mask and heats; no OpenCV)
    decode_tie_fallback: bool = True
    #: frames per device->host result fetch; rows are identical for any
    fetch_batch: int = 8
    dtype: str = "bfloat16"
    add_depth_inputs: bool = False
    add_optflow_inputs: bool = False
    replicate_left_prev_bug: bool = True
    output_fps: int = 30
    overlay: bool = True
    spatial_shards: int = 1
    fused_dispatch: bool = False

    def check_ported(self):
        """Raise for options whose slice is not ported yet."""
        defaults = TrackerConfig()
        for name, item in _ROADMAP.items():
            if getattr(self, name) != getattr(defaults, name):
                raise NotImplementedError(f"TrackerConfig.{name}: {item}")
        if self.mode not in ("incremental", "full"):
            raise ValueError(f"unknown tracker mode {self.mode!r}")
        if self.decode not in ("host", "device"):
            raise ValueError(f"unknown decode {self.decode!r}")


@dataclasses.dataclass
class _SideState:
    detected_tips: int = 0
    cx_prev: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    cy_prev: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )


# per-side class IDs and CSV column offsets
_SIDE = {
    "left": dict(base_cls=3, tip_cls=4, tcol=0, bcol=8, color=(255, 255, 255)),
    "right": dict(base_cls=1, tip_cls=2, tcol=4, bcol=10, color=(0, 0, 0)),
}


def compute_distance(x1, y1, x2, y2) -> float:
    return float(np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2))


def decode_side_keypoints(side, mask_array, tip_heatmap, state, cfg, row,
                          disp_image=None, opencv=True):
    """Exact host decode of one instrument's base + up to 2 tips into
    ``row`` (reference compute_centroids_and_store,
    test_multiframe_segmentation_on_videos_v3.py:95-194), on the OpenCV
    decode of ``track/decode.py`` or, with ``opencv=False``, its scipy
    twin. Returns the updated side state."""
    from mfcnet_tpu_torch.track.decode import (
        calc_base_centroid,
        create_circular_mask,
        determine_local_maxima_and_estimate_centroids,
        refine_tip_segmentation,
    )

    def dot(x, y, r):
        if disp_image is not None:
            import cv2

            cv2.circle(disp_image, (int(x), int(y)), r, info["color"], -1)

    info = _SIDE[side]
    tcol, bcol = info["tcol"], info["bcol"]
    base_mask = 255 * (mask_array == info["base_cls"]).astype(np.uint8)
    tip_mask = 255 * (mask_array == info["tip_cls"]).astype(np.uint8)
    heat = tip_heatmap.copy()
    heat[tip_mask == 0] = 0

    fmask = create_circular_mask(10, 10).astype(np.float64)
    bx, by = calc_base_centroid(base_mask, cfg.area_threshold, opencv)
    if len(bx) == 0:
        state.detected_tips = 0
        return state
    row[bcol] = bx[0]
    row[bcol + 1] = by[0]
    tip_mask = refine_tip_segmentation(tip_mask, cfg.area_threshold, opencv)
    cx, cy = determine_local_maxima_and_estimate_centroids(
        heat, tip_mask > 0, fmask, opencv
    )
    if len(cx) == 0:
        state.detected_tips = 0
    elif len(cx) == 1:
        d = compute_distance(bx[0], by[0], cx[0], cy[0])
        if d < cfg.dist_threshold:
            state.detected_tips = 1
            row[tcol:tcol + 4] = [cx[0], cy[0], cx[0], cy[0]]
            dot(cx[0], cy[0], 4)
        else:
            state.detected_tips = 0
    elif len(cx) == 2:
        d01 = compute_distance(bx[0], by[0], cx[0], cy[0])
        d02 = compute_distance(bx[0], by[0], cx[1], cy[1])
        if d01 < cfg.dist_threshold and d02 < cfg.dist_threshold:
            state.detected_tips = 2
            d11 = compute_distance(cx[0], cy[0], state.cx_prev[0], state.cy_prev[0])
            d12 = compute_distance(cx[0], cy[0], state.cx_prev[1], state.cy_prev[1])
            d21 = compute_distance(cx[1], cy[1], state.cx_prev[0], state.cy_prev[0])
            d22 = compute_distance(cx[1], cy[1], state.cx_prev[1], state.cy_prev[1])
            if d11 + d22 < d12 + d21:
                row[tcol:tcol + 4] = [cx[0], cy[0], cx[1], cy[1]]
            else:
                row[tcol:tcol + 4] = [cx[1], cy[1], cx[0], cy[0]]
            dot(cx[0], cy[0], 4)
            dot(cx[1], cy[1], 4)
        elif d01 < cfg.dist_threshold:
            state.detected_tips = 1
            row[tcol:tcol + 4] = [cx[0], cy[0], cx[0], cy[0]]
            dot(cx[0], cy[0], 4)
        elif d02 < cfg.dist_threshold:
            state.detected_tips = 1
            row[tcol:tcol + 4] = [cx[1], cy[1], cx[1], cy[1]]
            dot(cx[1], cy[1], 4)
        else:
            state.detected_tips = 0
    else:
        raise ValueError(f"Unexpected number of detected tips: {len(cx)}")

    new_cx = row[tcol:tcol + 4:2].copy()
    new_cy = row[tcol + 1:tcol + 4:2].copy()
    if side == "left" and cfg.replicate_left_prev_bug:
        # reference :299 stores cy into cx_prev and never updates cy_prev
        state.cx_prev = new_cy
    else:
        state.cx_prev = new_cx
        state.cy_prev = new_cy
    dot(bx[0], by[0], 2)
    return state


class KeypointTracker:
    """Stateful per-video keypoint tracker over decoded model outputs."""

    def __init__(self, num_frames_total: int, cfg: TrackerConfig):
        self.cfg = cfg
        # a hint: storage grows if more frames arrive, and `rows` spans
        # max(hint, frames seen) (the reference's NaN-padded N rows)
        self._hint = max(0, int(num_frames_total))
        self._rows = np.full((max(1, self._hint), 12), np.nan)
        self.left = _SideState()
        self.right = _SideState()
        self.count = 0

    @property
    def rows(self):
        return self._rows[: max(self.count, self._hint)]

    def _next_row(self):
        if self.count >= len(self._rows):
            grow = np.full((max(64, len(self._rows) // 2), 12), np.nan)
            self._rows = np.vstack([self._rows, grow])
        return self._rows[self.count]

    def update(self, mask_array, left_tip_heat, right_tip_heat,
               disp_image=None):
        """Exact host decode of one frame (class mask + tip heats)."""
        row = self._next_row()
        self.left = decode_side_keypoints(
            "left", mask_array, left_tip_heat, self.left, self.cfg, row,
            disp_image,
        )
        self.right = decode_side_keypoints(
            "right", mask_array, right_tip_heat, self.right, self.cfg, row,
            disp_image,
        )
        self.count += 1
        return row

    def update_device(self, kps, mask_array=None, disp_image=None,
                      mask_provider=None, heat_provider=None):
        """Update from device-decoded keypoints (2, 3, 3): [side l/r]
        [tip1, tip2, base][x, y, valid], with the host path's distance
        gate and 2-tip assignment. A base valid of 2 flags an
        approximation-sensitive side, which is re-decoded exactly on the
        host from the class mask (``mask_array`` or ``mask_provider()``)
        and the f16 tip heats (``heat_provider()``); without heats only
        the base is recomputed. The re-decode is the host decode's scipy
        twin, so the device decode needs no OpenCV."""
        row = self._next_row()
        for side, state, arr in (
            ("left", self.left, kps[0]),
            ("right", self.right, kps[1]),
        ):
            info = _SIDE[side]
            tcol, bcol = info["tcol"], info["bcol"]
            bx, by, bvalid = arr[2]
            if bvalid <= 0:
                state.detected_tips = 0
                continue
            if bvalid >= 2:  # ambiguous -> exact host re-decode
                m = mask_array
                if m is None and mask_provider is not None:
                    m = np.asarray(mask_provider())
                h = (np.asarray(heat_provider())
                     if heat_provider is not None else None)
                if m is not None and h is not None:
                    heat = (h[..., 1] if side == "left"
                            else h[..., 0]).astype(np.float32)
                    decode_side_keypoints(side, m, heat, state, self.cfg,
                                          row, disp_image, opencv=False)
                    continue
                if m is not None:
                    from mfcnet_tpu_torch.track.decode import calc_base_centroid

                    hx, hy = calc_base_centroid(
                        255 * (m == info["base_cls"]).astype(np.uint8),
                        self.cfg.area_threshold, opencv=False,
                    )
                    if not hx:
                        state.detected_tips = 0
                        continue
                    bx, by = float(hx[0]), float(hy[0])
            row[bcol], row[bcol + 1] = bx, by
            tips = [
                (x, y) for x, y, v in arr[:2]
                if v > 0
                and compute_distance(bx, by, x, y) < self.cfg.dist_threshold
            ]
            if not tips:
                state.detected_tips = 0
            elif len(tips) == 1:
                state.detected_tips = 1
                (x, y) = tips[0]
                row[tcol:tcol + 4] = [x, y, x, y]
            else:
                state.detected_tips = 2
                (x1, y1), (x2, y2) = tips[:2]
                d11 = compute_distance(x1, y1, state.cx_prev[0], state.cy_prev[0])
                d12 = compute_distance(x1, y1, state.cx_prev[1], state.cy_prev[1])
                d21 = compute_distance(x2, y2, state.cx_prev[0], state.cy_prev[0])
                d22 = compute_distance(x2, y2, state.cx_prev[1], state.cy_prev[1])
                if d11 + d22 < d12 + d21:
                    row[tcol:tcol + 4] = [x1, y1, x2, y2]
                else:
                    row[tcol:tcol + 4] = [x2, y2, x1, y1]
            if side == "left" and self.cfg.replicate_left_prev_bug:
                state.cx_prev = row[tcol + 1:tcol + 4:2].copy()
            else:
                state.cx_prev = row[tcol:tcol + 4:2].copy()
                state.cy_prev = row[tcol + 1:tcol + 4:2].copy()
            if disp_image is not None:
                import cv2

                for x, y in tips:
                    cv2.circle(disp_image, (int(x), int(y)), 4,
                               info["color"], -1)
                cv2.circle(disp_image, (int(bx), int(by)), 2,
                           info["color"], -1)
        self.count += 1
        return row

    def skip(self):
        """Frame consumed without a model output (warmup window)."""
        self._next_row()
        self.count += 1

    @property
    def missing_rates(self):
        n = max(1, len(self.rows))
        return (
            np.count_nonzero(np.isnan(self.rows[:, 0])) / n,
            np.count_nonzero(np.isnan(self.rows[:, 4])) / n,
        )


def render_overlay(frame_rgb, mask_array):
    """4-class mask overlay (reference :292-296)."""
    from mfcnet_tpu_torch.utils.vis import mask_overlay

    disp = frame_rgb
    disp = mask_overlay(disp, (mask_array == 1).astype(np.uint8), (255, 1, 0))
    disp = mask_overlay(disp, (mask_array == 2).astype(np.uint8), (255, 255, 1))
    disp = mask_overlay(disp, (mask_array == 3).astype(np.uint8), (0, 1, 255))
    disp = mask_overlay(disp, (mask_array == 4).astype(np.uint8), (0, 255, 255))
    return disp


class TrackingEngine:
    """The frame loop that :class:`InferenceEngine` and the serving
    artifacts' ``serve/engine.py::ArtifactEngine`` share: frames (and depth
    maps) onto the device with the stream axis, the warm-up, the
    newest-first window of full mode, and the decode of what the step gives
    (``track/outputs.py::outputs_from_probs``), (B, ...) for B streams and
    unbatched for one.

    A subclass sets ``cfg``, ``device``, ``num_streams`` and ``mode``
    ('incremental' or 'full') and defines ``_reset_state()``,
    ``_incremental(frame, depth, ready)`` -- one (B, H, W, 3) uint8 frame
    and (B, H, W) uint8 depth or None into its rings; what ``_outputs``
    takes, or None before the T-th frame (``ready`` False) -- and
    ``_window(frames, depth)`` -- the (B, T, H, W, 3) window, newest first,
    and its (B, T, H, W) depth or None -> what ``_outputs`` takes."""

    def reset(self):
        """Fresh stream(s): empty window and warm-up, zero rings."""
        self._count = 0
        self._frame_q = []
        self._depth_q = []
        self._reset_state()

    def _streams(self, x):
        """A step's input on the device with the stream axis: (B, ...) as
        given when B > 1, with a new leading axis when B == 1."""
        x = torch.as_tensor(x).to(self.device)
        return x if self.num_streams > 1 else x[None]

    def _depth_u8(self, depth_u8):
        """(B, H, W) uint8 depth of a step (None: zeros) on the device."""
        if depth_u8 is not None:
            return self._streams(depth_u8)
        return torch.zeros(self.num_streams, self.cfg.input_height,
                           self.cfg.input_width, dtype=torch.uint8,
                           device=self.device)

    def _outputs(self, probs):
        """(B, H, W, C) float32 probabilities -> the decode's outputs."""
        from mfcnet_tpu_torch.track.outputs import outputs_from_probs

        out = outputs_from_probs(probs, self.cfg)
        return out if self.num_streams > 1 else tuple(v[0] for v in out)

    @torch.no_grad()
    def step_async(self, frame_u8, depth_u8=None):
        """Dispatch one step: an (H, W, 3) uint8 frame (and its (H, W)
        uint8 depth map with ``cfg.add_depth_inputs``), or with B streams
        a (B, H, W, 3) stack (and (B, H, W) depth). Returns device tensors
        (mask, aux...), (B, ...) with B streams, or None during warmup."""
        cfg = self.cfg
        T = cfg.num_input_frames
        frame = self._streams(frame_u8)
        depth = self._depth_u8(depth_u8) if cfg.add_depth_inputs else None
        self._count += 1
        if self.mode == "incremental":
            scores = self._incremental(frame, depth, self._count >= T)
        else:
            # full mode: newest-first window of raw frames (reference :251)
            self._frame_q.append(frame)
            self._depth_q.append(depth)
            if len(self._frame_q) > T:
                self._frame_q.pop(0)
                self._depth_q.pop(0)
            if len(self._frame_q) < T:
                return None
            scores = self._window(
                torch.stack(self._frame_q[::-1], dim=1),
                None if depth is None else torch.stack(self._depth_q[::-1],
                                                       dim=1))
        return None if scores is None else self._outputs(scores)

    def step(self, frame_u8, depth_u8=None):
        """Synchronous step: numpy outputs, or None in warmup."""
        out = self.step_async(frame_u8, depth_u8)
        if out is None:
            return None
        return tuple(v.cpu().numpy() for v in out)


class InferenceEngine(TrackingEngine):
    """Per-frame inference on one device, for one stream or for B streams
    in lockstep (``num_streams``).

    'incremental': one base forward per frame into a ring buffer of the T
    newest class maps (NCHW, channel order (t, c), newest first); the
    fusion head runs on the buffer. 'full': all T base forwards per frame.
    Both ingest from the first frame, so they agree during warmup too.

    ``flow_model``: the frozen flow provider used with
    ``cfg.add_optflow_inputs``, a module that maps two (B, h, w, 3) frames
    to a (B, h, w, 2) flow (``models.raft.RAFT``,
    ``models.flowformerpp.FlowFormerPP``, ``models.unflow.UnFlow``).
    For a provider with split encoders (``flow_from_features``: RAFT,
    FlowFormer++), incremental mode keeps a newest-first ring of its
    per-frame features and the newest frame's context state (RAFT's GRU
    state (net, inp); FlowFormer++'s (B, h, w, 256) context features and a
    placeholder), so the encoders run once per new frame; for any other
    provider (UnFlow) it keeps a newest-first ring of normalized frames
    and runs the stateless
    ``outputs.flow_for_window`` per frame. Full mode recomputes everything
    per window (``track/outputs.py``). A provider that names a
    ``size_multiple`` (UnFlow: 64) needs half-resolution frames of such a
    size; other sizes raise a ``ValueError`` (there is no resize). With
    ``cfg.add_depth_inputs`` a ring (or queue) of depth maps, uint8 scaled
    to [0, 1], feeds the head. The Basic head warps the earlier maps by
    the flow; the Large head takes the same flow raw.

    ``num_streams`` B > 1 tracks B videos at once: every ring carries a
    leading stream axis (seg (B, T*C, H, W), depth (B, T, H, W), the
    provider's feature ring (B, T, h, w, 256) with its (B, ...) context
    state, or its frame ring (B, T, 3, H, W)), ``step_async`` takes a
    lockstep (B, H, W, 3) uint8 stack (and (B, H, W) depth) and returns
    (B, ...) outputs from one base forward over B frames (B*T in full
    mode), one head call, one provider solve over the B*(T-1) pairs and
    one decode with one host read. Each stream's outputs are those of its
    own single-stream engine. With B == 1 the engine takes one (H, W, 3)
    frame and returns unbatched outputs.

    ``stream_shards`` S > 1 builds a :class:`ShardedEngine` in its place,
    the B streams over S devices (``devices``).

    The engine runs copies of ``model`` and ``flow_model`` cast to
    ``cfg.dtype`` on ``device``: the card by default, wherever the caller
    built the models, and the CPU only when asked (``device="cpu"``);
    without a card the default raises. A bfloat16 engine runs a RAFT
    provider's update iterations through the fused update step, a float32
    engine through its plain convolutions; a bfloat16 FlowFormer++ keeps
    float32 where the JAX package's bfloat16 one does (its cost volume,
    perceiver and decoder: ``models/flowformerpp.py``).

    What a frame goes through is the serving modules' (``serve/export.py``:
    ``IncrementalStep``'s ingest and fusion in incremental mode,
    ``WindowServing`` in full mode), run here on the engine's own copies;
    only the flow provider's ring of incremental mode is the engine's
    own."""

    def __new__(cls, model, cfg, flow_model=None, device="cuda",
                num_streams=1, stream_shards=1, devices=None):
        if int(stream_shards) > 1:
            return ShardedEngine(model, cfg, flow_model, device, num_streams,
                                 stream_shards, devices)
        return super().__new__(cls)

    def __init__(self, model, cfg: TrackerConfig, flow_model=None,
                 device="cuda", num_streams: int = 1,
                 stream_shards: int = 1, devices=None):
        from mfcnet_tpu_torch.serve.export import (
            IncrementalStep,
            WindowServing,
        )

        cfg.check_ported()
        self.cfg = cfg
        self.mode = cfg.mode
        self.num_streams = max(1, int(num_streams))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"InferenceEngine(device={device!r}): no CUDA device is "
                'available; pass device="cpu" to run on the CPU')
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        if not cfg.add_optflow_inputs:
            flow_model = None
        elif flow_model is None:
            raise ValueError(
                "cfg.add_optflow_inputs needs a flow_model: a flow "
                "provider such as mfcnet_tpu_torch.models.raft.RAFT, "
                "mfcnet_tpu_torch.models.flowformerpp.FlowFormerPP or "
                "mfcnet_tpu_torch.models.unflow.UnFlow")
        else:
            mult = getattr(flow_model, "size_multiple", 1)
            h2, w2 = cfg.input_height // 2, cfg.input_width // 2
            if h2 % mult or w2 % mult:
                raise ValueError(
                    f"{type(flow_model).__name__} runs at half resolution "
                    f"and needs {h2}x{w2} to be multiples of {mult}: frames "
                    f"of {cfg.input_height}x{cfg.input_width} cannot use it "
                    f"(multiples of {2 * mult} can, e.g. 512x640)")
        if self.mode == "incremental":
            self.serving = IncrementalStep(
                model, cfg.dtype, cfg.num_input_frames, cfg.num_classes,
                self.device, flow_model)
        else:
            self.serving = WindowServing(model, cfg.dtype,
                                         cfg.add_depth_inputs, flow_model,
                                         self.device)
        self.model = self.serving.model
        self.flow_model = self.serving.flow_model
        #: split encoders: keep a feature ring; otherwise a frame ring
        self.flow_split = hasattr(self.flow_model, "flow_from_features")
        self.reset()

    def _reset_state(self):
        """Zero the ring buffers (start of a video, or of a group of B
        videos)."""
        cfg = self.cfg
        B, T, C = self.num_streams, cfg.num_input_frames, cfg.num_classes
        H, W = cfg.input_height, cfg.input_width
        self.seg_buf = torch.zeros(B, T * C, H, W, dtype=self.dtype,
                                   device=self.device)
        self.depth_buf = (
            torch.zeros(B, T, H, W, dtype=self.dtype, device=self.device)
            if cfg.add_depth_inputs else None
        )
        # split encoders: (feat_buf (B, T, h, w, 256), net, inp) (for
        # FlowFormer++ its context features and a placeholder); otherwise
        # the (B, T, 3, H, W) ring of normalized frames. Filled by the
        # first T ingests, before the first fuse reads it
        self.flow_state = None

    def _normalize(self, frames_u8):
        """(N, H, W, 3) uint8 -> (N, 3, H, W) normalized, engine dtype."""
        return self.serving.normalize(torch.as_tensor(frames_u8)
                                      .to(self.device))

    def _outputs(self, logits):
        """(B, C, H, W) logits -> the decode's outputs."""
        from mfcnet_tpu_torch.track.outputs import probs_nhwc

        return super()._outputs(probs_nhwc(logits))

    def _window(self, frames, depth):
        return self.serving.logits(frames, depth)

    def _incremental(self, frame, depth, ready):
        from mfcnet_tpu_torch.track import outputs as out

        cfg = self.cfg
        T = cfg.num_input_frames
        x, self.seg_buf, self.depth_buf = self.serving.ingest(
            self.seg_buf, self.depth_buf, frame, depth)
        if cfg.add_optflow_inputs and self.flow_split:
            f_new, net, inp = out.flow_ingest(x, self.flow_model)
            if self.flow_state is None:
                feat_buf = f_new[:, None].repeat(1, T, 1, 1, 1)
            else:
                feat_buf = torch.cat(
                    [f_new[:, None], self.flow_state[0][:, : T - 1]], dim=1)
            self.flow_state = (feat_buf, net, inp)
        elif cfg.add_optflow_inputs:
            if self.flow_state is None:
                self.flow_state = x[:, None].repeat(1, T, 1, 1, 1)
            else:
                self.flow_state = torch.cat(
                    [x[:, None], self.flow_state[:, : T - 1]], dim=1)
        if not ready:
            return None
        optflow = None
        if cfg.add_optflow_inputs and self.flow_split:
            optflow = out.flow_from_feature_ring(
                *self.flow_state, (cfg.input_height, cfg.input_width),
                self.flow_model)
        elif cfg.add_optflow_inputs:
            optflow = out.flow_for_window(self.flow_state, self.flow_model)
        return self.serving.fuse(self.seg_buf, self.depth_buf, optflow)


def _staged_fetch_loop(dispatch_seq, on_skip, consume, need_mask, K):
    """Device->host fetch pipeline: outputs are stacked on the device in
    chunks of K frames and leave it in one ``.cpu()`` per chunk (one more
    for the masks when the host needs them); the previous chunk is
    fetched before the current one is staged, so the fetch overlaps the
    device's work. Per-frame mask and extra handles stay on the device,
    unfetched, for the rare tie fallback.

    ``consume(payload, mask_np|None, aux_np, mask_handle, extras)`` runs
    per frame; ``on_skip(payload)`` handles warmup frames."""
    cur = []
    staged = None

    def stage():
        nonlocal staged, cur
        if not cur:
            return
        payloads = [p for p, _ in cur]
        mask_handles = [h[0] for _, h in cur]
        masks = torch.stack(mask_handles) if need_mask else None
        auxs = torch.stack([h[1] for _, h in cur])
        extras = [h[2:] for _, h in cur]
        cur = []
        staged = (payloads, masks, auxs, mask_handles, extras)

    def fetch_staged():
        nonlocal staged
        if staged is None:
            return
        payloads, masks, auxs, mask_handles, extras = staged
        staged = None
        masks_np = masks.cpu().numpy() if masks is not None else None
        auxs_np = auxs.cpu().numpy()
        for k, payload in enumerate(payloads):
            consume(payload,
                    masks_np[k] if masks_np is not None else None,
                    auxs_np[k], mask_handles[k], extras[k])

    for payload, handles in dispatch_seq:
        if handles is None:  # warmup frame: keep row order
            fetch_staged()
            stage()
            fetch_staged()
            on_skip(payload)
            continue
        cur.append((payload, handles))
        if len(cur) >= K:
            fetch_staged()
            stage()
    fetch_staged()
    stage()
    fetch_staged()


def _host_array(x):
    """A frame or a stack of frames as a host numpy array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ShardedEngine:
    """B streams over S devices, the JAX package's stream axis over its
    mesh (``InferenceEngine(..., stream_shards=S)`` builds one): stream
    group g, streams g*B/S .. (g+1)*B/S - 1, runs on an
    :class:`InferenceEngine` of its own on ``devices[g]`` (by default
    ``cuda:0`` .. ``cuda:S-1``), and a step's outputs come back in stream
    order on the first device, equal to the one-device engine's. It has
    what the tracking loop uses: ``cfg``, ``mode``, ``device``,
    ``num_streams``, ``reset``, ``step_async`` and ``step``."""

    def __init__(self, model, cfg: TrackerConfig, flow_model=None,
                 device="cuda", num_streams: int = 1, stream_shards: int = 2,
                 devices=None):
        S, B = int(stream_shards), max(1, int(num_streams))
        if B % S:
            raise ValueError(f"num_streams {B} must be divisible by "
                             f"stream_shards {S}")
        if devices is None:
            if torch.device(device).type != "cuda":
                devices = [device] * S
            elif torch.cuda.device_count() < S:
                raise RuntimeError(
                    f"InferenceEngine(stream_shards={S}): "
                    f"{torch.cuda.device_count()} CUDA devices; pass "
                    "devices= to place the groups")
            else:
                devices = [f"cuda:{g}" for g in range(S)]
        if len(devices) != S:
            raise ValueError(f"stream_shards {S} needs {S} devices, got "
                             f"{list(devices)}")
        self.engines = [InferenceEngine(model, cfg, flow_model, device=d,
                                        num_streams=B // S)
                        for d in devices]
        self.cfg, self.mode, self.num_streams = cfg, cfg.mode, B
        self.device = self.engines[0].device

    def reset(self):
        for eng in self.engines:
            eng.reset()

    @torch.no_grad()
    def step_async(self, frame_u8, depth_u8=None):
        g = self.num_streams // len(self.engines)
        outs = []
        for i, eng in enumerate(self.engines):
            rows = slice(i * g, (i + 1) * g)
            depth = None if depth_u8 is None else depth_u8[rows]
            if g == 1:  # a one-stream engine takes and gives no stream axis
                out = eng.step_async(frame_u8[rows][0],
                                     None if depth is None else depth[0])
                out = None if out is None else tuple(v[None] for v in out)
            else:
                out = eng.step_async(frame_u8[rows], depth)
            outs.append(out)
        if outs[0] is None:  # every group warms up on the same frames
            return None
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(len(outs[0])))

    step = TrackingEngine.step


def _track_streams(steps, lengths, names, engine, cfg: TrackerConfig,
                   output_dir, logger=None):
    """Lockstep steps -> engine -> keypoint decode -> one tracker per
    stream -> a CSV (+ MP4) each. ``steps`` yields (frames, depth, active):
    the engine's input for one step (an (H, W, 3) frame and (H, W) depth
    or None for a one-stream engine, (B, H, W, 3) and (B, H, W) for B
    streams) and the streams whose own frame it is; the other streams'
    results (padding) are dropped. ``lengths``: each stream's frame count,
    the row hint of its :class:`KeypointTracker`. The host decode of the B
    > 1 streams of a step runs on a pool of up to 8 threads. Returns (per-
    stream rows, aggregate frames/s)."""
    B = len(names)
    H, W = cfg.input_height, cfg.input_width
    engine.reset()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    writers = None
    if cfg.overlay:
        import cv2

        writers = [cv2.VideoWriter(str(output_dir / f"{name}_tracked.mp4"),
                                   cv2.VideoWriter_fourcc(*"mp4v"),
                                   cfg.output_fps, (W, H))
                   for name in names]
    trackers = [KeypointTracker(n, cfg) for n in lengths]
    t_start = time.perf_counter()
    frames_done = 0
    need_mask = cfg.overlay or cfg.decode != "device"
    fallback = cfg.decode_tie_fallback
    # the host decode of the streams of one step is independent (a tracker
    # each) and runs in OpenCV's and scipy's C cores, which drop the GIL
    pool = None
    if cfg.decode != "device" and B > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=min(B, 8))

    def consume_one(b, frames, masks_np, aux_np, mask_handle, heat_handle):
        disp = (render_overlay(_host_array(frames[b]), masks_np[b])
                if cfg.overlay else None)
        if cfg.decode == "device":
            trackers[b].update_device(
                aux_np[b], None if masks_np is None else masks_np[b], disp,
                mask_provider=((lambda h=mask_handle, bb=b:
                                h[bb].cpu().numpy()) if fallback else None),
                heat_provider=((lambda h=heat_handle, bb=b:
                                h[bb].cpu().numpy())
                               if fallback and heat_handle is not None
                               else None),
            )
        else:
            heats = aux_np[b].astype(np.float32)
            trackers[b].update(masks_np[b], heats[..., 1], heats[..., 0],
                               disp)
        if writers is not None:
            import cv2

            writers[b].write(cv2.cvtColor(disp, cv2.COLOR_RGB2BGR))

    def consume(payload, masks_np, aux_np, mask_handle, extras):
        """One lockstep step, for every stream still running at it."""
        nonlocal frames_done
        frames, active = payload

        def one(b):
            consume_one(b, frames, masks_np, aux_np, mask_handle,
                        extras[0] if extras else None)

        if pool is not None:
            list(pool.map(one, active))
        else:
            for b in active:
                one(b)
        frames_done += len(active)

    def on_skip(payload):
        for b in payload[1]:
            trackers[b].skip()

    def dispatch():
        for frames, depth, active in steps:
            handles = engine.step_async(frames, depth)
            if engine.num_streams == 1:  # give one stream its axis back
                frames = (frames,)
                if handles is not None:
                    handles = tuple(h[None] for h in handles)
            yield (frames, active), handles

    try:
        _staged_fetch_loop(dispatch(), on_skip=on_skip, consume=consume,
                           need_mask=need_mask, K=max(1, cfg.fetch_batch))
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if writers is not None:
            for w in writers:
                w.release()
    elapsed = time.perf_counter() - t_start
    fps = frames_done / max(elapsed, 1e-9)
    for name, tracker in zip(names, trackers):
        csv_path = output_dir / f"{name}_tracked.csv"
        np.savetxt(csv_path, tracker.rows, delimiter=",")
        if logger:
            lmiss, rmiss = tracker.missing_rates
            logger.info(f"Saved tracked results to {csv_path}")
            logger.info(f"Missing centroids — left: {lmiss:.3f}, right: "
                        f"{rmiss:.3f}")
    if logger:
        logger.info(f"{fps:.1f} frames/s" if B == 1 else
                    f"Tracked {B} streams at once: {fps:.1f} frames/s in "
                    f"all ({fps / B:.1f} per stream)")
    return [t.rows for t in trackers], fps


def track_on_frames(frames, model, cfg: TrackerConfig, output_dir,
                    name: str = "frames", depth_frames=None, logger=None,
                    flow_model=None,
                    engine=None, device="cuda"):
    """Track a sequence of decoded (H, W, 3) uint8 RGB frames (numpy
    arrays or tensors, host or device) at (cfg.input_height,
    cfg.input_width); writes ``{name}_tracked.csv``. ``depth_frames``:
    (H, W) uint8 depth maps, one per frame, with ``cfg.add_depth_inputs``.
    ``device``: where the engine is built, the card unless the caller
    passes ``"cpu"``. ``engine``: reuse a built engine
    (``model``/``flow_model``/``device`` are then ignored): an
    :class:`InferenceEngine`, or one with its contract such as
    ``serve.ArtifactEngine`` (a serving artifact in place of the model)."""
    if engine is None:
        engine = InferenceEngine(model, cfg, flow_model=flow_model,
                                 device=device)

    def steps():
        for i, frame in enumerate(frames):
            yield frame, (depth_frames[i] if depth_frames is not None
                          else None), (0,)

    rows, fps = _track_streams(steps(), [len(frames)], [name], engine, cfg,
                               output_dir, logger)
    return rows[0], fps


def track_on_frame_streams(streams, model, cfg: TrackerConfig, output_dir,
                           names=None, depth_streams=None, logger=None,
                           flow_model=None,
                           engine=None, prestacked: bool = False,
                           device="cuda"):
    """Track B videos at once through one engine with ``num_streams=B``
    (counterpart of the JAX package's ``track_on_frame_streams``): all B
    streams advance in lockstep, one batched step per frame, and each
    keeps its own :class:`KeypointTracker` and writes its own
    ``{name}_tracked.csv`` (and overlay MP4 with ``cfg.overlay``). Each
    stream's rows are those of its own :func:`track_on_frames` run.

    ``streams``: B sequences of (H, W, 3) uint8 frames; their lengths may
    differ: a shorter stream is padded by repeating its last frame and
    the padded steps' results are dropped. With ``prestacked``: N
    lockstep (B, H, W, 3) batches (host arrays or tensors) instead, of
    one length. ``depth_streams`` follows the same layout ((H, W) items,
    or (B, H, W) batches). B == 1 runs :func:`track_on_frames`.
    ``engine``: a built engine with ``num_streams=B`` (an
    :class:`InferenceEngine` or a ``serve.ArtifactEngine``; ``model``,
    ``flow_model`` and ``device`` are then ignored); otherwise one is built
    on ``device``, the card unless the caller passes ``"cpu"``. The host
    decode (``cfg.decode='host'``) of the B streams of a step runs on a
    pool of up to 8 threads.

    Returns (B per-stream row arrays, aggregate frames/s)."""
    if prestacked:
        N = len(streams)
        B = int(streams[0].shape[0]) if N else 0
        Ns = [N] * B

        def get_batch(i):
            return streams[i]

        def get_depth(i):
            return None if depth_streams is None else depth_streams[i]
    else:
        B = len(streams)
        Ns = [len(s) for s in streams]
        N = max(Ns) if B else 0
        # stand-in for an empty stream, whose results are never consumed
        zf = np.zeros((cfg.input_height, cfg.input_width, 3), np.uint8)

        def pad_get(seqs, i, zero):
            return np.stack([_host_array(s[min(i, len(s) - 1)]) if len(s)
                             else zero for s in seqs])

        def get_batch(i):
            return pad_get(streams, i, zf)

        def get_depth(i):
            return (None if depth_streams is None
                    else pad_get(depth_streams, i, zf[..., 0]))

    names = (list(names) if names is not None
             else [f"stream{b}" for b in range(B)])
    if len(names) != B:
        raise ValueError(f"{len(names)} names for {B} streams")
    if B == 1:
        frames = [x[0] for x in streams] if prestacked else streams[0]
        dframes = None
        if depth_streams is not None:
            dframes = ([x[0] for x in depth_streams] if prestacked
                       else depth_streams[0])
        rows, fps = track_on_frames(frames, model, cfg, output_dir,
                                    name=names[0], depth_frames=dframes,
                                    logger=logger, flow_model=flow_model,
                                    engine=engine, device=device)
        return [rows], fps
    if engine is None:
        engine = InferenceEngine(model, cfg, flow_model=flow_model,
                                 device=device, num_streams=B)
    if engine.num_streams != B:
        raise ValueError(f"the engine has num_streams={engine.num_streams}, "
                         f"the call {B} streams")

    def steps():
        for i in range(N):
            yield get_batch(i), get_depth(i), [b for b in range(B)
                                               if i < Ns[b]]

    return _track_streams(steps(), Ns, names, engine, cfg, output_dir,
                          logger)


def track_on_video(video_path, model, cfg: TrackerConfig, output_dir,
                   depth_video_path=None, logger=None, flow_model=None,
                   engine=None, device="cuda"):
    """Track one video file end to end; writes ``{name}_tracked.csv``
    (and the overlay MP4 with ``cfg.overlay``). ``depth_video_path``: the
    depth video read frame by frame beside it with
    ``cfg.add_depth_inputs``. ``device`` and ``engine`` as in
    :func:`track_on_frames`."""
    import cv2

    H, W = cfg.input_height, cfg.input_width
    if engine is None:
        engine = InferenceEngine(model, cfg, flow_model=flow_model,
                                 device=device)
    vid = cv2.VideoCapture(str(video_path))
    depth_vid = None
    try:
        n = int(vid.get(cv2.CAP_PROP_FRAME_COUNT))
        if cfg.add_depth_inputs:
            depth_vid = cv2.VideoCapture(str(depth_video_path))
            nd = int(depth_vid.get(cv2.CAP_PROP_FRAME_COUNT))
            if n != nd:
                raise ValueError(
                    f"RGB({n}) vs depth({nd}) frame-count mismatch")

        def frames():
            while True:
                ret, frame = vid.read()
                if not ret:
                    return
                frame = cv2.resize(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB),
                                   (W, H))
                dframe = None
                if depth_vid is not None:
                    retd, d = depth_vid.read()
                    if not retd:
                        return
                    dframe = cv2.resize(
                        cv2.cvtColor(d, cv2.COLOR_BGR2GRAY), (W, H))
                yield frame, dframe, (0,)

        rows, fps = _track_streams(frames(), [n], [Path(video_path).stem],
                                   engine, cfg, output_dir, logger)
        return rows[0], fps
    finally:
        vid.release()
        if depth_vid is not None:
            depth_vid.release()
