"""The counts the per-layer metrics divide by: the model's FLOPs held to
``FlopCounterMode`` on the plain reference, the RAFT update kernel's
operations and bytes held to a count by hand."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import manifest
from portbench.counts import flops as fc
from portbench.counts import raft_update
from portbench.reference import models as rm
from portbench.tests.tiny import held_cell
from portbench.weights import seeded_weights

VGG16 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
         (512, 512, 512))


def _weights(conf, device):
    """The configuration's modules on ``device`` ("meta": shapes only),
    their weights by name."""
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.models.raft import RAFT

    m, fl = conf["model"], conf.get("flow")
    with torch.device("meta"):
        model = get_multiframe_segmentation_model(
            m["model_type"], m["num_classes"], m["num_frames"],
            add_optflow_inputs=bool(fl), scale=m.get("model_scale", 1.0))
        mods = [("", model)]
        if fl:
            mods.append(("", RAFT(iters=fl["iters"],
                                  input_hw=(m["height"] // 2,
                                            m["width"] // 2))))
    if device == "meta":
        return {n: t for _, mod in mods for n, t in
                list(mod.named_parameters()) + list(mod.named_buffers())}
    return seeded_weights(mods, 3, torch.device(device))


def _counted(fn):
    with FlopCounterMode(display=False) as fcm:
        fn()
    return fcm.get_total_flops()


def _small(name, hw=64, scale=0.125):
    conf = held_cell(name).config
    conf = dict(conf, model=dict(conf["model"], height=hw, width=hw,
                                 model_scale=scale))
    if conf.get("flow"):
        conf["flow"] = dict(conf["flow"], iters=2)
    return conf


@pytest.mark.parametrize("name", ["track.basic.s1", "track.basic-raft.s1"])
def test_frame_flops_equal_the_reference_under_flop_counter(name):
    """One tracked frame's FLOPs at a small size: the base on the new
    frame, the head on the window, with flow both encoders on the new frame
    and one solve over its T - 1 pairs."""
    conf = _small(name, hw=128)
    m, fl = conf["model"], conf.get("flow")
    T, C, H, W = m["num_frames"], m["num_classes"], m["height"], m["width"]
    p = _weights(conf, "cpu")
    x = torch.randn(1, 3, H, W)

    def frame():
        rm.ternausnet16_maps(p, x, m["vgg_stages"])
        flow = None
        if fl:
            half = x[..., ::2, ::2]
            f, n, i = rm.raft_encode(p, half)
            flow = rm.window_flow(p, (f, n, i), f.expand(T - 1, -1, -1, -1),
                                  (H, W), fl["iters"], fl["corr_levels"],
                                  fl["corr_radius"])[None]
        rm.mfc_head(p, torch.rand(1, T * C, H, W), flow, T, C,
                    tuple(m["warp_grid"]))

    assert fc.track_frame_flops(fc.shapes_of(conf)) == _counted(frame)


def test_flow_pair_flops_equal_the_reference_under_flop_counter():
    """One frame pair through RAFT at a small size: both images' features,
    image 1's context, one solve on the 1/8 grid."""
    fl = dict(manifest.cell("flow.raft-large.b8").config["flow"], iters=2)
    H, W = 64, 96
    with torch.device("meta"):
        from mfcnet_tpu_torch.models.raft import RAFT

        raft = RAFT(iters=2, input_hw=(H, W))
    p = seeded_weights([("", raft)], 3, torch.device("cpu"))
    a, b = torch.rand(1, 3, H, W), torch.rand(1, 3, H, W)
    got = _counted(lambda: rm.pair_flow(p, a, b, 2, fl["corr_levels"],
                                        fl["corr_radius"]))
    assert fc.flow_pair_flops(H, W, fl) == got


def test_full_width_counts():
    """At the published widths (on the meta device): the base 762.2 GFLOP a
    480x640 frame, the head without flow 19.3 GFLOP, as counted on the
    reference."""
    conf = held_cell("track.basic.s1").config
    m = conf["model"]
    s = fc.shapes_of(conf)
    p = _weights(conf, "meta")
    x = torch.empty(1, 3, m["height"], m["width"], device="meta")
    seg = torch.empty(1, 15, m["height"], m["width"], device="meta")
    base = _counted(lambda: rm.ternausnet16_maps(p, x, VGG16))
    head = _counted(lambda: rm.mfc_head(p, seg, None, 3, 5, (576, 720)))
    assert base == fc.base_flops(s) and round(base / 1e9, 1) == 762.2
    assert head == fc.head_flops(s) and round(head / 1e9, 1) == 19.3
    assert round(fc.track_frame_flops(s) / 1e9, 1) == 781.5


def test_raft_update_operations_and_bytes_by_hand():
    """One launch after convcorr1 and convflow1: convcorr2 3x3 256->192,
    convflow2 3x3 128->64, the 3x3 over their concatenation 256->126, the
    GRU's six 1x5 / 5x1 convolutions 384->128, the flow head's 3x3
    128->256 and 256->2."""
    macs = (9 * 256 * 192 + 9 * 128 * 64 + 9 * 256 * 126
            + 6 * 5 * 384 * 128 + 9 * 128 * 256 + 9 * 256 * 2)
    assert raft_update.macs_per_token() == macs == 2_580_480
    assert raft_update.operations(2400) == 2 * macs * 2400
    weights = 2 * macs + 4 * (192 + 64 + 126 + 6 * 128 + 256 + 2)
    per_token = 2 * (256 + 128 + 128) + 4 * (128 + 2) + 4 * (128 + 2)
    assert raft_update.bytes_moved(2400) == weights + 2400 * per_token
    # operations bound it at the cells' token counts: 0.01252 ms at 2,400
    # tokens, 0.05010 at 9,600 (989 TFLOP/s)
    for tokens, ms in ((2400, 0.01252), (9600, 0.05010)):
        got = raft_update.bound_seconds(tokens, 989e12, 3.35e12) * 1e3
        assert math.isclose(got, ms, rel_tol=1e-3)
