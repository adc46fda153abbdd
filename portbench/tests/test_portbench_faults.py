"""``correct`` comes out false when the timed path is broken underneath, and
the control -- the reference one precision below the configuration's --
reads far above the program: a tracking cell's run at a tiny size on the
CPU, through the harness's runner and judge, with the cell's own limits.

The faults a tracking cell can have: a step that returns its state
unchanged (the maps ring not written), half of the batch left out (the
second half of the streams' outputs never computed), an answer altered
where it is produced (the decoded keypoints). It has no exchange between
chips. A flow cell's step holds no state: its faults are a flow altered
where it is produced and half of a call's pairs left out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.checks import judge
from portbench.runners import flow, track
from portbench.tests.tiny import dry_run, tiny_cell

#: a tip heats limit between the program's and the control's readings at
#: the tiny size (the held tracking cells' own waits for the card's)
TIP_HEATS = 1e-3


def _limits(cell):
    lim = dict(cell.limits["limits"])
    if lim.get("tip_heats", 0) is None:
        lim["tip_heats"] = TIP_HEATS
    return lim


def _outputs_fault(monkeypatch, alter):
    from mfcnet_tpu_torch.track import outputs

    orig = outputs.outputs_from_probs

    def broken(probs, cfg, *a, **kw):
        return alter(*orig(probs, cfg, *a, **kw))

    monkeypatch.setattr(outputs, "outputs_from_probs", broken)


def state_unchanged(monkeypatch):
    from mfcnet_tpu_torch.serve.export import IncrementalStep

    orig = IncrementalStep.ingest

    def ingest(self, seg_buf, depth_buf, frame_u8, depth_u8):
        x, _, depth = orig(self, seg_buf, depth_buf, frame_u8, depth_u8)
        return x, seg_buf, depth

    monkeypatch.setattr(IncrementalStep, "ingest", ingest)


def half_the_batch(monkeypatch):
    def alter(mask, kps, heats):
        h = mask.shape[0] // 2
        return (torch.cat([mask[:h], torch.zeros_like(mask[h:])]),
                torch.cat([kps[:h], torch.zeros_like(kps[h:])]),
                torch.cat([heats[:h], torch.zeros_like(heats[h:])]))

    _outputs_fault(monkeypatch, alter)


def answer_altered(monkeypatch):
    def alter(mask, kps, heats):
        kps = kps.clone()
        kps[..., 0] += 7.0
        return mask, kps, heats

    _outputs_fault(monkeypatch, alter)


@pytest.mark.parametrize("fault, streams", [
    (state_unchanged, None), (answer_altered, None),
    (half_the_batch, 4)])
def test_a_broken_step_is_not_correct(monkeypatch, fault, streams):
    cell = tiny_cell("track.basic-raft.s4" if streams else
                     "track.basic-raft.s1", streams=streams)
    sound = dry_run(cell, seed=2147483901)
    ok, _ = judge(sound["readings"], _limits(cell))
    fault(monkeypatch)
    broken = dry_run(cell, seed=2147483901)
    bad, checks = judge(broken["readings"], _limits(cell))
    assert ok and not bad, checks


def tip_heats_swapped(monkeypatch):
    def alter(mask, kps, heats):
        return mask, kps, heats.flip(-1)

    _outputs_fault(monkeypatch, alter)


def test_swapped_tip_heats_are_not_correct(monkeypatch):
    """A fault in the heats the decode reads, which keypoints decoded from
    those same heats would not show."""
    cell = tiny_cell()
    ok, _ = judge(dry_run(cell, seed=2147483901)["readings"], _limits(cell))
    tip_heats_swapped(monkeypatch)
    r = dry_run(cell, seed=2147483901)["readings"]
    bad, checks = judge(r, _limits(cell))
    assert ok and not bad and r["tip_heats"] > TIP_HEATS, checks


def flow_altered(orig):
    return lambda model, prev, curr: orig(model, prev, curr) + np.float32(0.5)


def flow_half_the_batch(orig):
    """The second half of a call's pairs never computed (zeros)."""
    def half(model, prev, curr):
        h = len(prev) // 2
        out = orig(model, prev[:h], curr[:h])
        return np.concatenate([out, np.zeros_like(out)])

    return half


@pytest.mark.parametrize("fault", [flow_altered, flow_half_the_batch])
def test_a_broken_flow_step_is_not_correct(monkeypatch, fault):
    from mfcnet_tpu_torch.cli import generate_opticalflow as cli

    cell = tiny_cell("flow.raft-large.b8")
    # this seed samples pairs in both halves of the call
    assert {k > 4 for k in flow.sample_pairs(cell.limits,
                                             2147483901)} == {False, True}
    lim = {"flow": 1e-3}
    ok, _ = judge(dry_run(cell, seed=2147483901)["readings"], lim)
    monkeypatch.setattr(cli, "flow_pairs", fault(cli.flow_pairs))
    bad, checks = judge(dry_run(cell, seed=2147483901)["readings"], lim)
    assert ok and not bad, checks


@pytest.mark.parametrize("name", ["track.basic-raft.s1", "track.basic.s1",
                                  "flow.raft-large.b8"])
def test_the_control_reads_far_above_the_program(name):
    """The control (float8 for the bfloat16 tracker, bfloat16 for the
    float32 flow provider) against the program on the same seed: at least
    one number the check compares reads three times higher."""
    cell = tiny_cell(name)
    runner = flow if name.startswith("flow") else track
    prog = dry_run(cell, seed=2147483903)["readings"]
    ctl = runner.control_readings(cell, 2147483903, torch.device("cpu"))
    assert max(ctl[k] / max(prog[k], 1e-12) for k in ctl) >= 3.0, (prog,
                                                                    ctl)
