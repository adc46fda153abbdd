"""Recorded surgical videos for the tracking cells.

The scene of the port's ``data/synthetic.py::make_synthetic_frames``, copied
here so that the yardstick stays put, and drawn on the device for a whole
clip at once: two instruments (a shaft from its base to its centre and two
tip discs) drifting by a random walk over a noisy background, the right
instrument drawn over the left, tips over shafts. ``scene.scale`` multiplies
every length of the generator's 96x128 scene (shaft, width, tips, steps), so
that at 480x640 the instruments are as large in the frame as there.

A clip of ``clip_frames`` frames is made from the seed and played forward
and back, so that motion stays continuous; a video is ``video_frames``
frames of it, each stream starting at its own offset drawn from the seed.
The frames are uint8 RGB in host memory, as a video decoder hands them.
"""

from __future__ import annotations

import numpy as np
import torch


def _walk(rng, n, H, W, sc):
    """(n, 2, 3) per frame and instrument: centre x, y and angle."""
    start = np.array([[sc["start"][i][0] * W, sc["start"][i][1] * H,
                       sc["start"][i][2]] for i in range(2)])
    s = sc["scale"]
    step = np.concatenate([
        rng.uniform(-sc["step_px"] * s, sc["step_px"] * s, (n, 2, 2)),
        rng.uniform(-sc["step_rad"], sc["step_rad"], (n, 2, 1))], axis=-1)
    pos = start[None] + np.concatenate([np.zeros((1, 2, 3)),
                                        np.cumsum(step[:-1], axis=0)])
    return pos


def _keypoints(pos, H, W, sc):
    """(n, 2, 3, 2) integer base and tip points (x, y) inside a 5 px
    border, and (n, 2, 2) integer centres."""
    s = sc["scale"]
    cx, cy, a = pos[..., 0], pos[..., 1], pos[..., 2]

    def clip(v, hi):
        return np.clip(v, 5, hi - 6).astype(np.int64)

    pts = [np.stack([clip(cx - sc["shaft_len"] * s * np.cos(a), W),
                     clip(cy - sc["shaft_len"] * s * np.sin(a), H)], -1)]
    for da in (sc["tip_spread"], -sc["tip_spread"]):
        pts.append(np.stack(
            [clip(cx + sc["tip_offset"] * s * np.cos(a + da), W),
             clip(cy + sc["tip_offset"] * s * np.sin(a + da), H)], -1))
    centre = np.stack([cx.astype(np.int64), cy.astype(np.int64)], -1)
    return np.stack(pts, axis=2), centre


def render_clip(params, seed: int, H: int, W: int, device, chunk: int = 32):
    """(clip_frames, H, W, 3) uint8 numpy frames of the seed's clip."""
    sc = params["scene"]
    n = int(params["clip_frames"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7669]))
    pos = _walk(rng, n, H, W, sc)
    pts, centre = _keypoints(pos, H, W, sc)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    s = sc["scale"]
    yy = torch.arange(H, device=device, dtype=torch.float32).view(1, H, 1)
    xx = torch.arange(W, device=device, dtype=torch.float32).view(1, 1, W)
    shaft_rgb = torch.tensor(sc["shaft_rgb"], dtype=torch.uint8, device=device)
    tip_rgb = torch.tensor(sc["tip_rgb"], dtype=torch.uint8, device=device)
    out = np.empty((n, H, W, 3), np.uint8)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        m = c1 - c0
        img = (sc["background"] + torch.randint(
            0, sc["noise"], (m, H, W, 3), generator=gen, device=device,
            dtype=torch.int16)).to(torch.uint8)
        for inst in range(2):  # left, then right over it
            p = torch.as_tensor(pts[c0:c1, inst], device=device,
                                dtype=torch.float32)
            cen = torch.as_tensor(centre[c0:c1, inst], device=device,
                                  dtype=torch.float32)
            bx, by = p[:, 0, 0].view(m, 1, 1), p[:, 0, 1].view(m, 1, 1)
            ex, ey = cen[:, 0].view(m, 1, 1), cen[:, 1].view(m, 1, 1)
            dx, dy = ex - bx, ey - by
            nn_ = dx * dx + dy * dy
            t = torch.where(nn_ > 0, ((xx - bx) * dx + (yy - by) * dy)
                            / nn_.clamp(min=1e-9), torch.zeros_like(nn_))
            t = t.clamp(0.0, 1.0)
            dist = torch.hypot(yy - (by + t * dy), xx - (bx + t * dx))
            shaft = dist <= sc["shaft_halfwidth"] * s
            tips = torch.zeros_like(shaft)
            for k in (1, 2):
                tx = p[:, k, 0].view(m, 1, 1)
                ty = p[:, k, 1].view(m, 1, 1)
                tips |= torch.hypot(yy - ty, xx - tx) <= sc["tip_radius"] * s
            img[shaft] = shaft_rgb
            img[tips] = tip_rgb
        out[c0:c1] = img.cpu().numpy()
    return out


def clip_index(k, n):
    """Frame k of a clip of n frames played forward and back."""
    period = 2 * (n - 1)
    k = k % period
    return k if k < n else period - k


def stream_offsets(params, seed: int, streams: int):
    """Each stream's start in the forward-and-back clip."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x0FF5]))
    n = int(params["clip_frames"])
    return [int(v) for v in rng.integers(0, 2 * (n - 1), streams)]


def make(params, seed: int, H: int, W: int, device):
    """The cell's traffic: the clip, the length of a video, and ``index``,
    the clip index of frame k of a stream's video."""
    streams = int(params.get("streams", 1))
    clip = render_clip(params, seed, H, W, device)
    offsets = stream_offsets(params, seed, streams)
    return {"clip": clip, "video_frames": int(params["video_frames"]),
            "streams": streams,
            "index": lambda b, k: clip_index(offsets[b] + k, len(clip))}
