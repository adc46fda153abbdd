"""What decides ``correct`` in a tracking cell: the timed path's outputs
against the plain reference (``reference/``), run after the window on the
same frames and weights.

Per sampled step of the first video (``limits.sample``), for each stream:

- ``base_maps``: the program's ring of the T newest per-frame class maps
  against TernausNet16's on those frames;
- ``flow_features`` (cells with flow): the provider's ring of per-frame
  features and the newest frame's context state against RAFT's encoders;
- ``head_gap``: the widest gap, over the pixels, by which the reference
  window's probability of the class in the mask the step returned (the
  argmax of the fused head's output) lies below its best class's: the
  reference window has its base maps, its RAFT flow of the newest frame to
  each earlier one, the warp and the head. The flow and the warp live only
  inside the captured step, so they are judged through the head, their one
  consumer. A random model's classes tie over much of a frame, so the share
  of pixels whose class differs says little; the gap is 0 at a tie;
- ``tip_heats``: the step's float16 tip heats against the reference head's
  probabilities of classes 2 and 4, which the decode below reads (its
  limit is unset: on random weights the float8 control reads only about
  twice the program);

``base_maps``, ``flow_features`` and ``tip_heats`` as ||program -
reference|| / ||reference||; each the largest over the sampled steps. Per
sampled step of the decode sample:

- ``keypoints``: the share of keypoints (2 sides x tip1, tip2, base) the
  step returned that the reference decode of the step's own class mask and
  tip heats does not give (:func:`keypoint_mismatch`);

and over every video of the window:

- ``rows``: rows of the tracker's CSV that differ from the reference
  tracker's over the keypoints the program decoded.

The control (``control.py``) puts :meth:`Reference.window` computed in a
lower precision in the program's place for the first three numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import decode as rdec
from portbench.reference import models as rm


def _rel(pairs):
    num = sum(float(((p.float() - r.float()) ** 2).sum()) for p, r in pairs)
    den = sum(float((r.float() ** 2).sum()) for _, r in pairs)
    return (num / max(den, 1e-30)) ** 0.5


class Reference:
    """The reference's per-frame work, cached by clip index."""

    def __init__(self, weights, config, clip, device, q=None):
        self.p = weights
        self.cfg = config
        self.clip = clip
        self.dev = device
        self.q = q
        self._maps, self._enc = {}, {}

    def _frames(self, idx):
        return torch.from_numpy(np.stack([self.clip[i] for i in idx])).to(
            self.dev)

    def maps(self, idx):
        """(len(idx), C, H, W) class probabilities of clip frames ``idx``."""
        todo = [i for i in dict.fromkeys(idx) if i not in self._maps]
        if todo:
            m = self.cfg["model"]
            out = rm.ternausnet16_maps(self.p, rm.normalize(self._frames(todo)),
                                       m["vgg_stages"], q=self.q)
            self._maps.update(zip(todo, out))
        return torch.stack([self._maps[i] for i in idx])

    def encoders(self, idx):
        """RAFT's (features, net, inp) of each clip frame, at half
        resolution."""
        todo = [i for i in dict.fromkeys(idx) if i not in self._enc]
        if todo:
            x = rm.normalize(self._frames(todo))[..., ::2, ::2]
            f, n, i_ = rm.raft_encode(self.p, x, q=self.q)
            self._enc.update(zip(todo, zip(f, n, i_)))
        enc = [self._enc[i] for i in idx]
        return tuple(torch.stack(v) for v in zip(*enc))

    def window(self, idx):
        """The window of clip frames ``idx`` (newest first): its maps, its
        encoders' outputs (None without flow) and the head's (C, H, W)
        class probabilities."""
        m, fl = self.cfg["model"], self.cfg.get("flow")
        T, C = m["num_frames"], m["num_classes"]
        maps = self.maps(idx)
        enc, flow = None, None
        if fl:
            enc = self.encoders(idx)
            f, n, i_ = enc
            flow = rm.window_flow(
                self.p, (f[:1], n[:1], i_[:1]), f[1:],
                (m["height"], m["width"]), fl["iters"], fl["corr_levels"],
                fl["corr_radius"], q=self.q)[None]
        logits = rm.mfc_head(self.p, maps.reshape(1, T * C, *maps.shape[-2:]),
                             flow, T, C, tuple(m["warp_grid"]), q=self.q)
        return maps, enc, torch.softmax(logits[0], dim=0)


def window_readings(ref, idx, seg, flow_state, mask, heats):
    """The numbers of one stream's sampled step: ``seg`` (T*C, H, W) its
    maps ring, ``flow_state`` (features (T, h, w, D), net (h, w, 128), inp
    (h, w, 128)) or None, ``mask`` (H, W) the class ids and ``heats`` (H,
    W, 2) the tip heats (classes 2 and 4) it returned."""
    maps, enc, probs = ref.window(idx)
    T, C = maps.shape[:2]
    out = {"base_maps": _rel([(seg.reshape(T, C, *seg.shape[-2:]), maps)])}
    if enc is not None:
        ring, net, inp = flow_state
        f, n, i_ = enc
        out["flow_features"] = _rel([(ring.permute(0, 3, 1, 2), f),
                                     (net.permute(2, 0, 1), n[0]),
                                     (inp.permute(2, 0, 1), i_[0])])
    chosen = probs.gather(0, mask.long()[None])[0]
    out["head_gap"] = float((probs.max(0).values - chosen).max())
    out["tip_heats"] = _rel([(heats.permute(2, 0, 1), probs[[2, 4]])])
    return out


#: the heats leave the step rounded to float16, while its decode read them
#: in float32: the reference's search runs on the float16 heats, each moved
#: by up to that rounding (2^-11 of the largest heat, twice for a
#: difference)
TIP_TOL = 2.0 ** -9


def keypoint_mismatch(mask, heats, kps, area_threshold):
    """Keypoints of one stream's step that disagree with the reference
    decode of its class mask and heats: (bad, total). A base comes from the
    mask alone and must match to float32 rounding. A valid tip must lie
    where the search could return one -- in a kept component, at a local
    maximum of the smoothed heat within the heats' rounding
    (``Tips.accepts``); a tip only the reference finds must be one whose
    being a local maximum rests on that rounding (``Tips.tied``). Which of
    the near-equal peaks of a random model's flat heats ranks first is not
    compared: the heats' rounding alone reorders them."""
    dev = heats.device
    hl, hr = heats[..., 1].float().to(dev), heats[..., 0].float().to(dev)
    ref, tips = rdec.decode_frame(mask.cpu().numpy(), hl, hr,
                                  area_threshold)
    got = kps.cpu().numpy()
    bad = 0
    for s, heat in enumerate((hl, hr)):
        g, r = got[s, 2], ref[s, 2]
        bad += int(g[2] != r[2] or (r[2] > 0 and np.abs(g[:2] - r[:2]).max()
                                    > 1e-3))
        tol = TIP_TOL * float(heat.max())
        for j in range(2):
            g, r = got[s, j], ref[s, j]
            if g[2] > 0:
                bad += int(not tips[s].accepts(g[0], g[1], tol))
            elif r[2] > 0:
                bad += int(not tips[s].tied(r[0], r[1], tol))
    return bad, int(got[..., 2].size)


def rows_mismatch(kps_seq, rows, dist_threshold):
    """Rows of the program's CSV that differ from the reference tracker's
    over the keypoints it decoded (NaN equal to NaN)."""
    want = rdec.tracker_rows(kps_seq, len(rows), dist_threshold)
    same = (rows == want) | (np.isnan(rows) & np.isnan(want))
    return int((~same.all(axis=1)).sum())
