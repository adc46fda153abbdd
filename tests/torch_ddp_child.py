"""One rank of a data-parallel run of the port, for
``tests/test_torch_ddp.py`` (a helper: pytest collects no test from it).
The parent sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; the rank joins the group over
``gloo`` (two ranks may then share one card), then:

* runs the batch norm and the three ABNs on its rows of one global batch,
  forward and backward (``norms_rank{r}.pt``);
* with ``--pack``, trains the multi-frame CLI with ``--multihost true`` at
  ``--batch_size`` 2 a rank (``state_rank{r}.pt``: parameters, statistics,
  EMA, counters), each rank in an experiment directory of its own;
* with ``--fail``, rank 1 raises after joining the group, and rank 0
  waits at a collective: it must fail, not hang.

    python tests/torch_ddp_child.py --out DIR [--pack PACK] [--device D]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NORM_KINDS = ("bn", "abn_leaky_relu", "abn_elu", "abn_none")


def norm_inputs():
    """A global batch (4, 3, 6, 5) and the weights of the summed loss."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 6, 5)).astype(np.float32) * 2 + 0.3
    return x, rng.standard_normal(x.shape).astype(np.float32)


def norm_run(kind, x, g, device):
    """Train-mode forward of ``kind`` on ``x`` and the backward of
    sum(y * g): outputs, gradients and running statistics on the CPU."""
    from mfcnet_tpu_torch.models.abn import ABN
    from mfcnet_tpu_torch.models.common import BatchNorm2d

    m = BatchNorm2d(3) if kind == "bn" else ABN(3, activation=kind[4:])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        m.weight.copy_(torch.rand(3, generator=gen) + 0.5)
        m.bias.copy_(torch.randn(3, generator=gen) * 0.1)
    m = m.to(device).train()
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    y = m(xt)
    (y * torch.from_numpy(g).to(device)).sum().backward()
    out = {"y": y, "gx": xt.grad, "gw": m.weight.grad, "gb": m.bias.grad,
           "mean": m.running_mean, "var": m.running_var}
    return {k: v.detach().cpu() for k, v in out.items()}


def train_args(pack, savedir, device, batch, *extra):
    """The CLI's flags: TernausNetMulti-Basic at 32x32 and scale 0.1, base
    trained, depth inputs, weighted NLL + soft Jaccard (class weights 1 and
    1000), grad_accum 2, EMA; 2 epochs of the pack."""
    return ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
            "--expt_savedir", str(savedir), "--expt_name", "mh",
            "--batch_size", str(batch), "--num_workers", "1",
            "--num_classes", "5", "--loss_fns", "nll", "soft_jaccard",
            "--loss_wts", "0.7", "0.3",
            "--class_weights", "1", "1000", "1000", "1000", "1000",
            "--lr", "1e-3", "--num_epochs", "1", "--save_freq", "1",
            "--print_freq", "10", "--input_height", "32",
            "--input_width", "32", "--model_type", "TernausNetMulti-Basic",
            "--model_scale", "0.1", "--train_base_model", "true",
            "--add_depth_inputs", "true", "--grad_accum", "2",
            "--ema_decay", "0.9", "--seed", "42", "--device", device,
            *extra]


def final_state(state):
    return {"model": state.model.state_dict(), "ema": state.ema,
            "step": state.step, "updates": state.updates}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--pack", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--fail", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(2)
    import torch.distributed as dist

    from mfcnet_tpu_torch.parallel import init_distributed, rank_rows

    rank, world = init_distributed(auto=True, device=a.device,
                                   backend="gloo", timeout_s=120)
    out = Path(a.out)
    if a.fail:
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        dist.all_reduce(torch.ones(1))
        return
    x, g = norm_inputs()
    rows = rank_rows(len(x), rank, world)
    torch.save({k: norm_run(k, x[rows], g[rows], a.device)
                for k in NORM_KINDS}, out / f"norms_rank{rank}.pt")
    if a.pack:
        from mfcnet_tpu_torch.cli import train_multiframe_detection as cli

        state = cli.main(train_args(a.pack, out / f"runs{rank}", a.device, 2,
                                    "--multihost", "true"))
        torch.save(final_state(state), out / f"state_rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
