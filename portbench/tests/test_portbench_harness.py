"""The benchmark's harness on the CPU: the manifest and the files each name
leads to, the refusal to measure without a card, the traffic's seeding, the
process's modules, and dry runs of a cell at a tiny size through the port's
plain paths up to the reference comparison."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import manifest
from portbench.tests.tiny import HELD, dry_run, held_cell, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                             "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(manifest.NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(manifest.UNIT.match(u) for u in units), units
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    cell = manifest.cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.workload["traffic"] == cell.entry["traffic"]
    assert (ROOT / "portbench" / "runners"
            / f"{cell.workload['runner']}.py").exists()
    assert cell.limits["limits"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.metric_reader(m["name"]))
    conf_file = next(c["file"] for c in BENCH["configs"]
                     if c["name"] == cell.entry["config"])
    assert conf_file.startswith("portbench/") and (ROOT / conf_file).exists()


def test_refuses_to_measure_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "2147483999", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert run.forbidden_modules(["mfcnet_tpu_torch.track", "numpy"]) == []
    assert run.forbidden_modules(["mfcnet_tpu.track", "jaxlib.xla"]) == [
        "jaxlib", "mfcnet_tpu"]


def test_traffic_is_the_seeds():
    from portbench.traffic import track_videos

    cell = tiny_cell()
    wl = dict(cell.workload, streams=4)
    a = track_videos.make(wl, 2147483901, 64, 96, torch.device("cpu"))
    b = track_videos.make(wl, 2147483901, 64, 96, torch.device("cpu"))
    c = track_videos.make(wl, 2147483902, 64, 96, torch.device("cpu"))
    assert np.array_equal(a["clip"], b["clip"])
    assert [a["index"](s, 5) for s in range(4)] == [b["index"](s, 5)
                                                    for s in range(4)]
    assert not np.array_equal(a["clip"], c["clip"])
    assert a["clip"].shape == (wl["clip_frames"], 64, 96, 3)
    # forward and back: continuous, every clip frame reached
    n = wl["clip_frames"]
    seq = [track_videos.clip_index(k, n) for k in range(3 * n)]
    assert max(abs(x - y) for x, y in zip(seq, seq[1:])) == 1
    assert set(seq) == set(range(n))


def test_dry_run_reaches_the_reference_comparison():
    cell = tiny_cell()
    res = dry_run(cell, seed=2147483901)
    r = res["readings"]
    assert set(r) == {"base_maps", "flow_features", "head_gap",
                      "tip_heats", "keypoints", "rows"} == set(
                          cell.limits["limits"])
    assert all(np.isfinite(v) for v in r.values())
    assert r["rows"] == 0 and r["keypoints"] == 0
    assert max(r["base_maps"], r["head_gap"], r["flow_features"],
               r["tip_heats"]) < 0.05
    assert res["failed"] == 0 and res["attempted"] == 10
    assert res["frames_per_s"] > 0


def test_flow_dry_run_reaches_the_reference_comparison():
    cell = tiny_cell("flow.raft-large.b8")
    res = dry_run(cell, seed=2147483901, pairs=8)
    assert set(res["readings"]) == set(cell.limits["limits"]) == {"flow"}
    assert res["readings"]["flow"] < 1e-4
    assert res["attempted"] == 8 and res["failed"] == 0
    assert res["flow_pairs_per_s"] > 0


def test_a_held_cell_cannot_read_correct_until_its_limits_are_set():
    """The tracking cells wait out of BENCHMARK.json with a limit unset."""
    from portbench.checks import judge

    for name in HELD:
        cell = held_cell(name)
        assert name not in CELLS and cell.config["name"] == HELD[name]
        lim = cell.limits["limits"]
        assert lim["tip_heats"] is None
        assert not judge({k: 0.0 for k in lim}, lim)[0]


def test_dry_runs_load_no_jax():
    """A --trace 0 and a --trace 1 dry run, in a fresh interpreter, load
    none of jax, jaxlib, flax or the JAX package (top-level names whole)."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench')!r})\n"
        "import run\n"
        "from portbench.runners import flow, track\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "for runner, cell in ((track, tiny_cell()),\n"
        "                     (flow, tiny_cell('flow.raft-large.b8'))):\n"
        "    for trace in (0, 1):\n"
        "        res = runner.run({'cell': cell,\n"
        "                          'device': torch.device('cpu'), 'seed': 5,\n"
        "                          'seconds': 0.0, 'videos': 1, 'pairs': 2,\n"
        "                          'trace': bool(trace), 't0': 0.0})\n"
        "        res['correct'], res['checks'] = True, {}\n"
        "        run.result_line(res, cell, trace, {})\n"
        "print(run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_limits_files_hold_every_number_compared():
    for name in CELLS:
        lim = manifest.cell(name).limits
        assert all(isinstance(v, (int, float)) for v in lim["limits"].values())
        assert re.match(r"^\d+$", str(lim["sample"]["below"]))
    for name in HELD:
        assert held_cell(name).limits["limits"]["rows"] == 0


def test_traced_run_reads_the_first_whole_of_its_slices():
    """A window gets one slice at each of trace.FRACS, all inside it and
    none overlapping the next; a slice never started reads nothing, and
    ``read`` notes each slice with what it read or why it is not whole."""
    from portbench import trace

    slices = trace.schedule(lambda: {}, 100.0, 20.0)
    assert len(slices) == len(trace.FRACS) >= 4
    starts = [s.t0 for s in slices]
    assert starts == sorted(starts) and 100.0 < starts[0]
    assert all(b - a > 2 * s.length
               for a, b, s in zip(starts, starts[1:], slices))
    assert starts[-1] + slices[-1].length < 120.0

    class Whole(trace.Slice):
        def summary(self):
            return {"busy_s": 0.9, "window_s": 1.0, "frames": 8}

    lost, whole = trace.Slice(lambda: {}), Whole(lambda: {})
    summaries, notes = trace.read([lost, whole])
    assert summaries[0] is None and summaries[1]["busy_s"] == 0.9
    assert "not whole, not started" in notes[0]
    assert notes[1].startswith("profiler slice 2 of 2: busy 0.9 s")
    assert next(s for s in summaries if s) is summaries[1]
