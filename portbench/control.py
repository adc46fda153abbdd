"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 portbench/control.py --workload <cell> --seconds 6 \
        --seeds 11 12 ... --control-seeds 21 22 23

For each of ``--seeds`` one run of the cell (set-up, a window of
``--seconds``, the check) prints the program's readings; for each of
``--control-seeds`` the control -- the reference computed one precision
below the configuration's (``reference/quant.py``) put in the program's
place on the same sampled steps or pairs (the runner's
``control_readings``) -- prints its readings of the numbers it produces.
Each line is JSON: ``{"who": "program"|"control", "seed": n, "readings":
{...}}``. The benchmark's own runs do not run this.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        sys.exit("portbench.control: no CUDA device")
    cell = manifest.cell(args.workload)
    runner = importlib.import_module(
        f"portbench.runners.{cell.workload['runner']}")
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        res = runner.run({"cell": cell, "device": dev, "seed": seed,
                          "seconds": args.seconds, "trace": False,
                          "t0": time.perf_counter()})
        rate = next(res[m["name"]] for m in cell.end_to_end
                    if m["name"] != "setup_s")
        print(json.dumps({"who": "program", "seed": seed,
                          "readings": res["readings"], "rate": rate,
                          "setup": res["setup_phases"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        print(json.dumps({"who": "control", "seed": seed,
                          "readings": runner.control_readings(cell, seed,
                                                              dev)}),
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
