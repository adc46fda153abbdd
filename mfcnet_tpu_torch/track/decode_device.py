"""On-device keypoint decode (counterpart of
``mfcnet_tpu/track/decode_device.py``).

Per frame, from the class map and the two tip heatmaps:

  * tips: component-area gate (top-2 tip components with outer-contour
    area >= threshold) -> gaussian(sigma=4) smoothing -> circular-footprint
    local maxima on kept components -> top-2 peaks;
  * base: largest-component centroid by Pick's-theorem area
    (pixels - boundary/2 - 1), gated by area >= threshold.

Component stats come from three tiers, each exact:

  1. the union tier (:func:`mfcnet_tpu_torch.ops.cc.union_stats`): one
     class-aware pass over the disjoint 4-class image;
  2. the per-blob tier (:func:`mfcnet_tpu_torch.ops.cc.base_stats`) when
     the union image cannot represent the frame (``conflict``) or holds
     more than K components;
  3. the exact tier (:func:`_decode_keypoints_exact`) when a blob holds
     more than K components.

The JAX package picks the tier on the device with ``lax.cond``, a
``lax.cond`` for the exact tier inside the per-blob branch. Here the same
two choices are :func:`mfcnet_tpu_torch.ops.graph_cond.run_if`: where
nothing is captured each reads its flag on the host (one small sync a
call, two when the per-blob tier runs) and runs its branch eagerly; inside
the tracker's captured step (``fused_dispatch``) they are IF nodes of the
CUDA graph, whose flags the card reads, and each call runs the tail of
its one tier. A call with leading dimensions (the
engine's B streams) decodes in lockstep, as the JAX package does: one
choice of tier for all of them, and any stream's conflict or overflow
sends every stream to the per-blob tier. Every tier is exact, so no row
depends on the tier. :data:`TIER_COUNTS` counts the calls (the engine's
steps, not frames) each tier decoded; a captured step's tiers are counted
from the card's runs of its branches when the tracker fetches results
(:func:`mfcnet_tpu_torch.ops.graph_cond.drain`).

Ties in every top-k resolve to the lowest index, as ``jax.lax.top_k``
does: a stable descending sort, first k.

Output layout per side: [tip1, tip2, base] x [x, y, valid]; the base's
valid is 0 (none), 1, or 2 (an approximation-sensitive decision: the
tracker re-decodes that side on the host).
"""

from __future__ import annotations

import torch

from mfcnet_tpu_torch.ops import graph_cond
from mfcnet_tpu_torch.ops._build import counted
from mfcnet_tpu_torch.ops.cc import base_stats, connected_components, union_stats
from mfcnet_tpu_torch.ops.peaks import gaussian_blur, local_maxima

#: decode calls (engine steps) of each tier since the last reset
TIER_COUNTS = counted({"union": 0, "per_blob": 0, "exact": 0})
#: component slots of the union and per-blob tiers
K_SLOTS = 256


def reset_tier_counts():
    graph_cond.drain()  # a captured step's calls before the reset
    for k in TIER_COUNTS:
        TIER_COUNTS[k] = 0


def topk_lowest_index(v, k: int):
    """Top ``k`` along the last axis, ties to the lowest index (the
    ``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_tips_device(heatmap, blob, max_peaks: int = 2, refined=None):
    """Top-``max_peaks`` local maxima of the masked smoothed heatmap.

    heatmap, blob: (..., H, W) float32 / bool -> (..., max_peaks, 3) rows
    (x, y, valid). The heat is zeroed outside ``blob`` before smoothing;
    maxima are restricted to ``refined`` (the area-gated mask) or, when
    None, to ``blob``."""
    W = heatmap.shape[-1]
    masked = torch.where(blob, heatmap, torch.zeros_like(heatmap))
    sm = gaussian_blur(masked, 4.0)
    lm = local_maxima(sm) & (blob if refined is None else refined)
    vals = torch.where(lm, sm, torch.full_like(sm, float("-inf")))
    top_vals, top_idx = topk_lowest_index(
        vals.reshape(heatmap.shape[:-2] + (-1,)), max_peaks
    )
    xs = (top_idx % W).float()
    ys = torch.div(top_idx, W, rounding_mode="floor").float()
    valid = torch.isfinite(top_vals).float()
    return torch.stack([xs, ys, valid], dim=-1)


def _base_rows_from_stats(counts, bndc, sw, swx, swy, area_threshold,
                          tie_rel, tie_abs):
    """Per-component sums (any trailing component axis) -> (..., 4) rows
    (x, y, valid, tie) of the largest component."""
    area = counts - 0.5 * bndc - 1.0
    top2, top2_idx = topk_lowest_index(area, 2)
    s1, s2 = top2[..., 0], top2[..., 1]
    tie = (s2 > 0) & (s1 - s2 <= tie_abs + tie_rel * s1)
    sel = top2_idx[..., :1]
    wsum = torch.clamp(torch.gather(sw, -1, sel)[..., 0], min=1.0)
    cx = torch.gather(swx, -1, sel)[..., 0] / wsum
    cy = torch.gather(swy, -1, sel)[..., 0] / wsum
    valid = ((s1 >= area_threshold) & (s1 > 0)).float()
    return torch.stack([cx, cy, valid, tie.float() * valid], dim=-1)


def refine_keep_from_areas(areas, ids, area_threshold,
                           tie_rel: float = 0.02, tie_abs: float = 2.0):
    """Host refine_tip_segmentation semantics: keep the top-2 components
    by area, each only if its area >= threshold.

    areas: (..., K) per-slot areas; ids: (..., H, W) per-pixel slot key.
    Returns ``(keep (..., H, W) bool, tie (...,) bool)``; ``tie`` flags a
    near-tie at the #2/#3 boundary or an area within ``tie_abs`` of the
    threshold."""
    top3, top3_idx = topk_lowest_index(areas, 3)
    a1, a2, a3 = top3[..., 0], top3[..., 1], top3[..., 2]
    i1 = top3_idx[..., 0][..., None, None]
    i2 = top3_idx[..., 1][..., None, None]
    keep = (
        ((ids == i1) & (a1 >= area_threshold)[..., None, None])
        | ((ids == i2) & (a2 >= area_threshold)[..., None, None])
    )

    def near(v):
        return (v >= 0) & (torch.abs(v - area_threshold) <= tie_abs)

    tie = (
        ((a2 > 0) & (a3 >= area_threshold - tie_abs)
         & (a2 - a3 <= tie_abs + tie_rel * torch.clamp(a2, min=0.0)))
        | near(a1) | near(a2) | near(a3)
    )
    return keep, tie


def _keypoints_from_stats(masks4, heats, counts, bndc, sw, swx, swy, ids,
                          area_threshold, tie_rel: float = 0.02,
                          tie_abs: float = 2.0):
    """Shared tail: sums over the [l-base, r-base, l-tip, r-tip] stack
    (+ per-pixel slot keys ``ids``) -> (..., 2, 3, 3) keypoint rows."""
    base = _base_rows_from_stats(
        counts[..., :2, :], bndc[..., :2, :], sw[..., :2, :],
        swx[..., :2, :], swy[..., :2, :], area_threshold, tie_rel, tie_abs,
    )
    tip_areas = counts[..., 2:, :] - 0.5 * bndc[..., 2:, :] - 1.0
    keep, tip_tie = refine_keep_from_areas(
        tip_areas, ids[..., 2:, :, :], area_threshold, tie_rel, tie_abs
    )
    blobs = masks4[..., 2:, :, :]
    tips = decode_tips_device(heats, blobs, refined=blobs & keep)
    side_tie = torch.clamp(base[..., 3] + tip_tie.float() * base[..., 2],
                           max=1.0)
    base_rows = torch.stack(
        [base[..., 0], base[..., 1], base[..., 2] + side_tie], dim=-1
    )
    return torch.cat([tips, base_rows[..., None, :]], dim=-2)


def fill_holes(mask):
    """Background pixels (4-connected) not reachable from the border
    become foreground (cv2 RETR_EXTERNAL outer-contour semantics).
    mask: (..., H, W) bool."""
    H, W = mask.shape[-2:]
    n = H * W
    bg = ~mask.reshape(-1, H, W)
    B = bg.shape[0]
    lab = connected_components(bg.contiguous(), 4)
    border = torch.cat(
        [lab[:, 0, :], lab[:, -1, :], lab[:, :, 0], lab[:, :, -1]], dim=-1
    ).long()
    reach = torch.zeros(B, n + 1, dtype=torch.bool, device=mask.device)
    reach.scatter_(1, border, True)
    holes = bg & ~torch.gather(reach, 1, lab.reshape(B, n).long()).view(
        B, H, W)
    return mask | holes.reshape(mask.shape)


def _component_stats(m):
    """(B, H, W) bool -> per-label sums (B, n+1) x5 of the hole-filled
    components + labels (B, n); the background bucket n is zeroed. Sums
    run in float64 (exact for these magnitudes) and round once to
    float32."""
    B, H, W = m.shape
    n = H * W
    filled = fill_holes(m)
    lab = connected_components(filled.contiguous(), 8).reshape(B, n).long()
    fp = torch.nn.functional.pad(filled, (1, 1, 1, 1))
    interior = (fp[:, :-2, 1:-1] & fp[:, 2:, 1:-1] & fp[:, 1:-1, :-2]
                & fp[:, 1:-1, 2:]) & filled
    ones = filled.reshape(B, n).double()

    def seg(v):
        out = torch.zeros(B, n + 1, dtype=torch.float64, device=m.device)
        return out.scatter_add_(1, lab, v).float()

    counts = seg(ones)
    bnd = seg((filled & ~interior).reshape(B, n).double())
    counts[:, n] = 0.0
    bnd[:, n] = 0.0
    w = torch.where(interior.reshape(B, n), 1.0, 0.5).double() * ones
    pix = torch.arange(n, device=m.device, dtype=torch.float64)
    xs = pix % W
    ys = torch.floor(pix / W)
    return counts, bnd, seg(w), seg(w * xs), seg(w * ys), lab


def _decode_keypoints_exact(masks4, heats, area_threshold,
                            tie_rel: float = 0.02, tie_abs: float = 2.0):
    """Exact tier (``_decode_keypoints_xla``): explicit labels + segment
    sums keyed by each component's root pixel (n+1 buckets)."""
    H, W = masks4.shape[-2:]
    lead4 = masks4.shape[:-2]
    n = H * W
    counts, bndc, sw, swx, swy, lab = _component_stats(
        masks4.reshape(-1, H, W))
    shp = lead4 + (n + 1,)
    return _keypoints_from_stats(
        masks4, heats, counts.reshape(shp), bndc.reshape(shp),
        sw.reshape(shp), swx.reshape(shp), swy.reshape(shp),
        lab.reshape(lead4 + (H, W)), area_threshold, tie_rel, tie_abs,
    )


def _union_class_image(pred):
    """The four disjoint class blobs as one class image in the masks4 order
    (1=l-base, 2=r-base, 3=l-tip, 4=r-tip), int8."""
    zero = torch.zeros_like(pred)
    return torch.where(
        pred == 3, 1,
        torch.where(pred == 1, 2,
                    torch.where(pred == 4, 3, torch.where(pred == 2, 4, zero))),
    ).to(torch.int8)


def _union_rows(masks4, heats, stats, ccls, cid, area_threshold):
    """The union tier's rows from :func:`union_stats`' outputs."""
    lead4 = masks4.shape[:-2]
    H, W = masks4.shape[-2:]
    classes = torch.arange(1, 5, dtype=ccls.dtype, device=ccls.device)
    clsmask = ccls[..., None, :] == classes[:, None]  # (..., 4, K)

    def per_cls(r):
        return torch.where(clsmask, stats[..., r, :][..., None, :], 0.0)

    ids4 = cid[..., None, :, :].expand(lead4 + (H, W))
    return _keypoints_from_stats(
        masks4, heats, per_cls(0), per_cls(1), per_cls(2), per_cls(3),
        per_cls(4), ids4, area_threshold,
    )


def _decode_keypoints(pred, masks4, heats, area_threshold):
    """Three-tier decode (``_decode_keypoints_union`` of the JAX package).
    The four class blobs are disjoint, so one union pass labels them all
    (:func:`_union_class_image`); slot order stays raster within each
    class, so every top-k tie-break matches the per-blob path. The union
    tier's rows when its image holds the frame, else the per-blob tier's
    stats and, when no blob overflows its K slots, their rows, else the
    exact tier's rows: each choice a
    :func:`~mfcnet_tpu_torch.ops.graph_cond.run_if`."""
    stats, ccls, ncomp, conflict, cid = union_stats(
        _union_class_image(pred), K=K_SLOTS)
    rows = torch.empty(masks4.shape[:-3] + (2, 3, 3), dtype=torch.float32,
                       device=masks4.device)

    def union():
        TIER_COUNTS["union"] += 1
        rows.copy_(_union_rows(masks4, heats, stats, ccls, cid,
                               area_threshold))

    def per_blob():
        stats4, ncomp4, cid4 = base_stats(masks4, K=K_SLOTS, return_cid=True)

        def blob_rows():
            TIER_COUNTS["per_blob"] += 1
            rows.copy_(_keypoints_from_stats(
                masks4, heats, stats4[..., 0, :], stats4[..., 1, :],
                stats4[..., 2, :], stats4[..., 3, :], stats4[..., 4, :],
                cid4, area_threshold,
            ))

        def exact():
            TIER_COUNTS["exact"] += 1
            rows.copy_(_decode_keypoints_exact(masks4, heats,
                                               area_threshold))

        graph_cond.run_if((ncomp4 > K_SLOTS).any(), exact, blob_rows)

    graph_cond.run_if((conflict | (ncomp > K_SLOTS)).any(), per_blob, union)
    return rows


def decode_keypoints_device(probs, area_threshold_x10: int = 100,
                            pred=None):
    """Full per-frame decode.

    probs: (..., H, W, C>=5) float32 class probabilities (1=r-base,
    2=r-tip, 3=l-base, 4=l-tip); leading dims decode in one pass.
    ``pred``: optional (..., H, W) class map to decode instead of
    argmax(probs) (the score-thresholded mask). Returns (..., 2, 3, 3):
    [side (left, right)][tip1, tip2, base][x, y, valid]."""
    area_threshold = area_threshold_x10 / 10.0
    if pred is None:
        pred = torch.argmax(probs, dim=-1)
    masks4 = torch.stack([pred == 3, pred == 1, pred == 4, pred == 2],
                         dim=-3)
    heats = torch.stack([probs[..., 4], probs[..., 2]], dim=-3)
    return _decode_keypoints(pred, masks4, heats, area_threshold)
