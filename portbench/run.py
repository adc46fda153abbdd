"""Run one cell of the benchmark once, on the card this process is started
on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error. Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 2; if JAX, flax or the JAX
package is loaded when the window has closed, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in the process that prints a result, by
#: top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "mfcnet_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN (whole:
    ``mfcnet_tpu_torch`` is not ``mfcnet_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _cache_dirs():
    """Every build and kernel cache of the run inside the checkout, at fixed
    paths: the port's nvcc builds go to its own ``build/``; these are the
    libraries' others."""
    base = ROOT / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg, code):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(res, cell, trace, device_info):
    """The contract's JSON object from a runner's readings."""
    from portbench import manifest

    metrics, notes = {}, []
    if trace:
        run = dict(res, note=notes.append, cell=cell.name,
                   config=cell.config)
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": device_info}
    sl = next((s for s in res.get("slices", []) if s), None)
    if trace and sl:
        out["device"] = dict(device_info, busy_s=sl["busy_s"],
                             window_s=sl["window_s"])
        out["breakdown"] = {"device_ops": [list(x) for x in sl["device_ops"]],
                            "idle_gaps": [list(x) for x in sl["idle_gaps"]]}
    out["checks"] = res["checks"]
    return out, notes


def main(argv=None):
    args = parse(argv)
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False): the "
             "benchmark measures the card and has no CPU mode", 2)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, this machine has "
             f"{torch.cuda.device_count()}", 2)
    import mfcnet_tpu_torch

    if ROOT not in Path(mfcnet_tpu_torch.__file__).resolve().parents:
        fail(f"mfcnet_tpu_torch was imported from {mfcnet_tpu_torch.__file__}, "
             f"not from this checkout ({ROOT})", 4)
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    runner = importlib.import_module(
        f"portbench.runners.{cell.workload['runner']}")
    res = runner.run({"cell": cell, "device": dev, "seed": args.seed,
                      "seconds": args.seconds, "trace": bool(args.trace),
                      "t0": T0})
    bad = forbidden_modules()
    if bad:
        fail(f"the process has loaded {', '.join(bad)} (by top-level module "
             "name): the port must run without JAX", 3)
    from portbench.checks import judge

    res["correct"], res["checks"] = judge(res["readings"],
                                          cell.limits["limits"])
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line, notes = result_line(res, cell, args.trace, info)
    print("portbench: set-up s " + json.dumps(res["setup_phases"]),
          file=sys.stderr)
    for n in res.get("slice_notes", []) + notes:
        print(f"portbench: {n}", file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
