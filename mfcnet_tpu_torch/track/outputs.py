"""Per-frame output block and the window's flow channels (counterpart of
``mfcnet_tpu/track/outputs.py``).

Output semantics of the reference: per-class score threshold with higher
classes overwriting (test_multiframe_segmentation_on_videos_v3.py:282-289),
argmax otherwise. Flow semantics (:264-271): the provider runs on 0.5x
nearest-resized frames, pairing the newest frame with each earlier one;
the flow is divided by the 0.5 resize factor and rescaled x2 (bilinear,
``align_corners=True``).

Frames and flows are NCHW here, the layout of the engine's ring buffers:
frames (B, T, 3, H, W), flow (B, T-1, 2, H, W). The provider's own
methods take and return NHWC. B is the engine's stream axis (1 for one
video): every helper runs all B*(T-1) pairs of a window in one provider
solve, stream-major (pair b*(T-1) + i is stream b's newest frame with its
frame i + 1), and reshapes the result back per stream.
"""

from __future__ import annotations

import torch


def outputs_from_probs(probs, cfg):
    """(..., H, W, C) float32 class probabilities -> ``(mask, aux...)``.

    ``mask``: (..., H, W) uint8 class ids. With ``cfg.decode == 'device'``
    returns ``(mask, kps, heats)`` -- kps (..., 2, 3, 3) keypoint rows of
    :func:`~mfcnet_tpu_torch.track.decode_device.decode_keypoints_device`
    and the f16 tip heats the tracker fetches only for a flagged side;
    otherwise ``(mask, heats)`` with heats (..., H, W, 2) f16 (classes 2
    and 4)."""
    thr = float(cfg.score_detection_threshold)
    if thr > 0:
        mask = torch.zeros(probs.shape[:-1], dtype=torch.uint8,
                           device=probs.device)
        for cls in range(1, probs.shape[-1]):
            mask = torch.where(probs[..., cls] > thr,
                               torch.full_like(mask, cls), mask)
    else:
        mask = torch.argmax(probs, dim=-1).to(torch.uint8)
    heats = torch.stack([probs[..., 2], probs[..., 4]], dim=-1).half()
    if cfg.decode == "device":
        from mfcnet_tpu_torch.track.decode_device import (
            decode_keypoints_device,
        )

        kps = decode_keypoints_device(
            probs, int(cfg.area_threshold * 10), pred=mask.to(torch.int32)
        )
        return mask, kps, heats
    return mask, heats


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def flow_for_window(frames_norm, flow_model):
    """(B, T, 3, H, W) normalized frames, newest first -> (B, T-1, 2, H, W)
    float32 flow. All B*(T-1) pairs (newest, earlier) run as one batched
    solve. A provider with split encoders (``flow_from_features``: RAFT)
    runs the newest frame's encoders once per window, not once per pair;
    any other provider (UnFlow) is called on the pairs as they are."""
    from mfcnet_tpu_torch.ops.pairs import repeat_for_pairs
    from mfcnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest

    B, T, _, H, W = frames_norm.shape
    H2, W2 = H // 2, W // 2
    half = resize_nearest(frames_norm, H2, W2)
    newest = _nhwc(half[:, 0])
    earlier = _nhwc(half[:, 1:].reshape(B * (T - 1), 3, H2, W2))
    if hasattr(flow_model, "flow_from_features"):
        f1 = flow_model.features(newest)
        net, inp = flow_model.context(newest)
        f2 = flow_model.features(earlier)
        return _flow_from_feature_pairs(f1, f2, net, inp, T, (H, W),
                                        flow_model)
    fl = flow_model(repeat_for_pairs(newest, T - 1), earlier)
    fl = resize_bilinear(fl.permute(0, 3, 1, 2) / 0.5, H, W,
                         align_corners=True)
    return fl.reshape(B, T - 1, 2, H, W)


def flow_for_training(frames_norm, flow_model, basic: bool = True):
    """The train step's frozen provider (``mfcnet_tpu/models/raft.py:568-
    633``, ``unflow.py:218-247``; reference src/engine.py:39-53): (B, T, H,
    W, 3) normalized frames, newest first, in the provider's dtype ->
    (B, T-1, H, W, 2) float32 flow at the input resolution (the tracker
    instead runs at half resolution and rescales). ``basic``: the Basic
    variant's flow(frame_i -> frame_0) (image1 = frame_i, image2 =
    frame_0); otherwise the Large variant's flow(frame_0 -> frame_i)
    (image1 = frame_0, its context encoder once). All T-1 pairs are one
    batched solve; with split encoders (RAFT) the newest frame's features
    are computed once."""
    from mfcnet_tpu_torch.ops.pairs import repeat_for_pairs

    B, T, H, W, _ = frames_norm.shape
    f0 = frames_norm[:, 0]
    rest = frames_norm[:, 1:].reshape(B * (T - 1), H, W, 3)

    def rep(t):
        return repeat_for_pairs(t, T - 1)

    if hasattr(flow_model, "flow_from_features"):
        f_rest = flow_model.features(rest)
        f_0 = rep(flow_model.features(f0))
        if basic:
            net, inp = flow_model.context(rest)
            fl = flow_model.flow_from_features(f_rest, f_0, net, inp)
        else:
            net, inp = flow_model.context(f0)
            fl = flow_model.flow_from_features(f_0, f_rest, rep(net),
                                               rep(inp))
    elif basic:
        fl = flow_model(rest, rep(f0))
    else:
        fl = flow_model(rep(f0), rest)
    return fl.float().reshape(B, T - 1, H, W, 2)


def flow_ingest(frame_norm, flow_model):
    """One frame's cacheable provider state: (B, 3, H, W) normalized
    frame -> ``(features, net, inp)``, the 0.5x-resolution feature
    encoder output (B, h, w, 256) and the context encoder's GRU initial
    state and feed (B, h, w, 128) each. The flows pair the newest frame
    with each earlier one and cannot be kept, but the per-image encoders
    can: the incremental engine calls this once per new frame."""
    from mfcnet_tpu_torch.ops.resize import resize_nearest

    H, W = frame_norm.shape[-2:]
    half = _nhwc(resize_nearest(frame_norm, H // 2, W // 2))
    net, inp = flow_model.context(half)
    return flow_model.features(half), net, inp


def flow_from_feature_ring(feat_buf, net, inp, out_hw, flow_model):
    """The window's flow from kept features: feat_buf (B, T, h, w, 256)
    newest-first ring of :func:`flow_ingest` features, (net, inp) the
    newest frame's context state, out_hw the full-resolution (H, W).
    Returns (B, T-1, 2, H, W), the quantity :func:`flow_for_window`
    computes (the same operations on the same inputs)."""
    B, T = feat_buf.shape[:2]
    f2 = feat_buf[:, 1:].reshape((B * (T - 1),) + feat_buf.shape[2:])
    return _flow_from_feature_pairs(feat_buf[:, 0], f2, net, inp, T, out_hw,
                                    flow_model)


def _flow_from_feature_pairs(f1, f2, net, inp, T, out_hw, flow_model):
    """Shared tail: one batched recurrent solve over the T-1 (newest,
    earlier) feature pairs, then the 0.5x rescale. f1, net, inp: (B, ...)
    of the newest frame; f2: (B*(T-1), h, w, C) in pair order."""
    from mfcnet_tpu_torch.ops.pairs import repeat_for_pairs
    from mfcnet_tpu_torch.ops.resize import resize_bilinear

    B = f1.shape[0]
    H, W = out_hw
    fl = flow_model.flow_from_features(
        repeat_for_pairs(f1, T - 1), f2,
        repeat_for_pairs(net, T - 1), repeat_for_pairs(inp, T - 1),
    )
    fl = resize_bilinear(fl.permute(0, 3, 1, 2) / 0.5, H, W,
                         align_corners=True)
    return fl.reshape(B, T - 1, 2, H, W)
