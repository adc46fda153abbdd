"""Where the float32 update step (``csrc/raft_update.cu``, the 3xTF32
instance of ``tma_conv_kernel``) spends its time: stripped variants of it,
each built from a copy of this checkout's ``mfcnet_tpu_torch`` under
``build/raftv/<variant>/`` with one part of the float32 instance taken out,
timed one after another on one card:

    python3 tools/raft_f32_variants.py [--tree DIR ...]

Variants (each computes a wrong result, on purpose, but for "whole"):
  whole             the kernel as it is (held to the plain version first)
  no split          the consumers do not split their A fragments (big and
                    small both the raw value)
  one product       one TF32 product a k step (big.big) instead of three
  no small weights  the weights' small part is not loaded, and its product
                    not taken (two products a k step)
  plain TF32        all three: no split, one product, big weights only --
                    the cost of this pipeline at one TF32 pass

``--tree DIR`` (repeatable) also times the whole kernel of another
checkout (say an earlier design of the float32 instance, unpacked under
``build/``), held to the plain version first, in a process of its own
after this checkout's variants.

At 2 x 30 x 40 and 8 x 60 x 80 tokens (the tracker's and the trainer's
provider), ms per call of one update step through a solve's workspace by
CUDA-graph replay (``chip_smoke.py::_graph_ms``, best of two), each variant
in a process of its own. Prints the card's name and power limit first and
one JSON line last.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "raftv"
CALLS = ((2, 30, 40), (8, 60, 80))
SPLIT = (r"split_tf32\(x, big\[kk\]\[i\], small\[kk\]\[i\]\);",
         "big[kk][i] = small[kk][i] = __float_as_uint(x);")
ONE = (r"    WgmmaTf32Rs<BN>::mma\(acc, small\[kk\], smem_desc\(w_addr \+ kk \* 32\)\);\n"
       r"    WgmmaTf32Rs<BN>::mma\(acc, big\[kk\], smem_desc\(ws_addr \+ kk \* 32\)\);\n",
       "")
SMALL_W = ((r"if constexpr \(TT::SPLIT\)\n          tma_load_2d\(dst \+ TT::WS_OFF",
            "if constexpr (false)\n          tma_load_2d(dst + TT::WS_OFF"),
           (r"static constexpr int TX_W_BYTES = \(SPLIT \? 2 : 1\) \* B_BYTES;",
            "static constexpr int TX_W_BYTES = B_BYTES;"),
           (r"    WgmmaTf32Rs<BN>::mma\(acc, big\[kk\], smem_desc\(ws_addr \+ kk \* 32\)\);\n",
            ""))
VARIANTS = {
    "whole": (),
    "no split": (SPLIT,),
    "one product": (ONE,),
    "no small weights": SMALL_W,
    "plain TF32": (SPLIT, ONE) + SMALL_W[:2],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def make(name, edits, src=ROOT) -> Path:
    d = OUT / re.sub(r"[^a-z0-9]+", "_", name.lower())
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    pkg = d / "mfcnet_tpu_torch"
    shutil.copytree(src / "mfcnet_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cu in (pkg / "csrc").glob("*.cu"):
        if cu.name != "raft_update.cu":  # only the update step is built
            cu.unlink()
    cu = pkg / "csrc" / "raft_update.cu"
    text = cu.read_text()
    for pat, rep in edits:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"{name}: {pat!r} matched {n} times")
    cu.write_text(text)
    return d


def child(tree: Path, check: bool):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(tree))
    import torch

    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.raft import UpdateBlock
    from mfcnet_tpu_torch.ops import raft_update as ru

    if not torch.cuda.is_available():
        raise SystemExit("raft_f32_variants: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ub = init_weights(UpdateBlock(), gen).cuda().eval()
    out = {}
    for B, H8, W8 in CALLS:
        args = cs._raft_update_inputs(ub, torch.float32, B, H8, W8, gen)
        c1, f1, inp, net, flow, packed = args[:6]
        if check:
            atol, rtol = cs.RAFT_TOL["float32"]
            for g, w in zip(ru.raft_update(*args), ru.raft_update_plain(*args)):
                if not torch.allclose(g, w, rtol=rtol, atol=atol):
                    raise AssertionError("the whole kernel != plain")
        ws = ru.UpdateWorkspace(B, H8, W8, packed, "cuda")
        state = [net]

        def step():
            state[0], delta = ru.raft_update(c1, f1, inp, state[0], flow,
                                             packed, H8, W8, ws)
            return state[0], delta

        out[f"{B * H8 * W8} tokens"] = min(cs._graph_ms(step, 10, 5),
                                           cs._graph_ms(step, 10, 5))
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]), sys.argv[3] == "1")
        return
    print(card(), flush=True)
    dirs = {name: make(name, edits) for name, edits in VARIANTS.items()}
    for i, arg in enumerate(sys.argv[1:-1], 1):
        if arg == "--tree":
            other = Path(sys.argv[i + 1]).resolve()
            dirs[f"whole ({other.name})"] = make(f"tree {other.name}", (),
                                                  other)
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from mfcnet_tpu_torch.ops import _build; _build.load()", str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, d in dirs.items()}
    res = {}
    for name, p in builds.items():
        log, _ = p.communicate()
        if p.returncode:
            res[name] = {"build failed": log[-3000:]}
    for name, d in dirs.items():
        if name in res:
            continue
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--child", str(d), "1" if name.startswith(
                                "whole") else "0"],
                           capture_output=True, text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        res[name] = json.loads(lines[-1]) if lines else {
            "rc": r.returncode, "stderr": r.stderr[-2000:]}
        print(json.dumps({name: res[name]}), flush=True)
    print(json.dumps({"raft_update f32 variants, graph ms": res}), flush=True)


if __name__ == "__main__":
    main()
