"""What decides ``correct`` in a flow cell: the flows the window returned for
sampled pairs of the first video against the plain reference's RAFT
(``reference/models.py::pair_flow``, float32, TF32 off), run after the
window on the same frames and weights.

- ``flow``: the largest over the sampled pairs of
  ||program - reference|| / ||reference|| of the (H, W, 2) flow; NaN where a
  sampled pair never came.

The control (``runners/flow.py::control_readings``) puts the reference
computed one precision below the configuration's in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models as rm


def reference_flow(weights, fl, traffic, k, dev, q=None):
    """(H, W, 2) float32 flow of the pair ending at frame ``k`` of the first
    video, as the CLI feeds it (RGB / 255)."""
    clip, index = traffic["clip"], traffic["index"]

    def image(i):
        x = torch.from_numpy(clip[index(0, i)]).to(dev)
        return (x.permute(2, 0, 1)[None].float() / 255.0)

    f = rm.pair_flow(weights, image(k - 1), image(k), fl["iters"],
                     fl["corr_levels"], fl["corr_radius"], q=q)
    return f[0].permute(1, 2, 0).cpu().numpy()


def readings(weights, fl, traffic, flows, expected, dev):
    """The numbers compared, from ``flows`` {pair: (H, W, 2) flow}."""
    if any(k not in flows for k in expected):
        return {"flow": float("nan")}
    rel = []
    for k in expected:
        ref = reference_flow(weights, fl, traffic, k, dev).astype(np.float64)
        got = np.asarray(flows[k], np.float64)
        rel.append(np.linalg.norm(got - ref)
                   / max(np.linalg.norm(ref), 1e-30))
    return {"flow": float(np.max(rel))}
