"""Data-parallel training of the port over ``torch.distributed`` on the
CPU (``gloo``), the counterpart of ``tests/test_multihost_spawn.py``: two
spawned ranks (``tests/torch_ddp_child.py``, two threads each, every
process under a timeout) against one process at the global batch.

* The batch norm and the ABNs over 2 ranks equal one process on the whole
  batch: outputs and input gradients row for row, parameter gradients
  summed over the ranks, running statistics on each rank (1e-5 of the
  largest value: float32 sums in another order).
* The training CLI with ``--multihost true`` at 2 samples a rank against
  one process at 4 over the same global batches (rank 0's rows, then rank
  1's), after 6 micro-steps with accumulation 2: parameters, batch-norm
  statistics and EMA within rtol 1e-4 / atol 1e-5 (the JAX test's
  tolerance), equal across ranks bit for bit; a checkpoint from rank 0
  only; a log of its own for each rank.
* A rank that fails brings the other down.

The CUDA-marked case runs the norm checks with both ranks on ``cuda:0``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_ddp_child import (
    NORM_KINDS,
    final_state,
    norm_inputs,
    norm_run,
    train_args,
)

from torch_threads import _two_torch_threads  # noqa: F401

CHILD = Path(__file__).resolve().parent / "torch_ddp_child.py"
REPO = CHILD.parent.parent
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(out, *args, world=2):
    """Run ``world`` ranks of the child; returns their (exit code, output)
    pairs. Every rank is killed once one takes longer than ``TIMEOUT``."""
    out.mkdir(parents=True, exist_ok=True)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=port, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, str(CHILD), "--out", str(out), *args], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results = []
    try:
        for p in procs:
            results.append((p.wait(timeout=TIMEOUT), p.stdout.read()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran longer than {TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.stdout.close()
    return results


def _ok(results):
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r} failed:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two CPU ranks: the norm checks, then the training CLI on a pack of
    3 videos x 5 frames (15 samples: 7 a rank, 3 steps an epoch)."""
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    root = tmp_path_factory.mktemp("ddp")
    pack = make_synthetic_pack(root / "pack",
                               videos=(("train", 3, 5), ("val", 1, 3)),
                               height=32, width=32)
    _ok(spawn_ranks(root / "out", "--pack", str(pack)))
    return root, pack


def _assert_close(got, want, what, rtol=0.0, atol=0.0):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)


def _check_norms(out, kind, world=2):
    x, g = norm_inputs()
    ref = norm_run(kind, x, g, "cpu")
    ranks = [torch.load(out / f"norms_rank{r}.pt")[kind] for r in range(world)]
    b = len(x) // world
    for key in ("y", "gx"):
        got = torch.cat([rk[key] for rk in ranks])
        tol = 1e-5 * float(ref[key].abs().max())
        _assert_close(got, ref[key], f"{kind} {key}", atol=tol)
        assert got.shape[0] == world * b
    for key in ("gw", "gb"):
        tol = 1e-5 * float(ref[key].abs().max())
        _assert_close(sum(rk[key] for rk in ranks), ref[key],
                      f"{kind} {key}", atol=tol)
    for rk in ranks:
        for key in ("mean", "var"):
            _assert_close(rk[key], ref[key], f"{kind} {key}", atol=1e-5)
            assert torch.equal(rk[key], ranks[0][key])


@pytest.mark.parametrize("kind", NORM_KINDS)
def test_global_norms_match_one_process(two_ranks, kind):
    _check_norms(two_ranks[0] / "out", kind)


def _one_process_run(pack, out):
    """The CLI in this process at batch 4, its loader yielding the
    2-rank run's global batches: rank 0's batch of 2, then rank 1's."""
    from unittest import mock

    from mfcnet_tpu_torch.cli import train_multiframe_detection as cli

    real = cli.get_data_loader

    def interleaved(*a, shard=None, **kw):
        a = list(a)
        a[5] //= 2
        tr0, va = real(*a, shard=(0, 2), **kw)
        tr1, _ = real(*a, shard=(1, 2), **kw)
        tr0.drop_last = tr1.drop_last = True

        class Both:
            def __len__(self):
                return len(tr0)

            def set_epoch(self, epoch, skip_batches=0):
                tr0.set_epoch(epoch, skip_batches)
                tr1.set_epoch(epoch, skip_batches)

            def __iter__(self):
                for b0, b1 in zip(tr0, tr1):
                    yield {k: np.concatenate([b0[k], b1[k]]) for k in b0}

        return Both(), va

    assert "WORLD_SIZE" not in os.environ
    with mock.patch.object(cli, "get_data_loader", interleaved):
        return final_state(cli.main(train_args(pack, out, "cpu", 4)))


def test_two_ranks_train_like_one_process(two_ranks):
    root, pack = two_ranks
    out = root / "out"
    r0, r1 = (torch.load(out / f"state_rank{r}.pt") for r in (0, 1))
    ref = _one_process_run(pack, root / "ref")
    # 15 samples: 7 a rank, 3 global batches of 4 an epoch, 2 epochs
    assert r0["step"] == r1["step"] == ref["step"] == 6
    assert r0["updates"] == ref["updates"] == 3
    for name in ("model", "ema"):
        assert r0[name].keys() == ref[name].keys()
        assert not any(k.startswith("module.") for k in r0[name])
        for k, v in r0[name].items():
            assert torch.equal(v, r1[name][k]), f"ranks differ: {name} {k}"
            if v.is_floating_point():
                _assert_close(v, ref[name][k], f"{name} {k}", rtol=1e-4,
                              atol=1e-5)


def test_rank0_writes_checkpoints_and_each_rank_logs(two_ranks):
    out = two_ranks[0] / "out"
    ck0, ck1 = (out / f"runs{r}" / "mh" / "ckpts" for r in (0, 1))
    assert (ck0 / "model_001.pth").exists() and (ck0 / "model_001.json").exists()
    assert not list(ck1.glob("*.pth"))
    logs0, logs1 = (out / f"runs{r}" / "mh" / "logs" for r in (0, 1))
    assert (logs0 / "run.log").exists() and (logs0 / "scalars.jsonl").exists()
    assert (logs1 / "run.rank1.log").exists()
    assert (logs1 / "scalars.rank1.jsonl").exists()
    assert "process 1 of 2" in (logs1 / "run.rank1.log").read_text()


def test_a_failed_rank_fails_the_run(tmp_path):
    results = spawn_ranks(tmp_path, "--fail")
    assert all(rc != 0 for rc, _ in results), results
    assert "fails on purpose" in results[1][1]


def test_no_group_at_world_one():
    """Without ``--multihost`` or ``WORLD_SIZE`` > 1: no group, and the
    helpers are the single-process identities."""
    import torch.distributed as dist

    from mfcnet_tpu_torch.parallel import (
        all_sum,
        group_world,
        init_distributed,
        local_device,
        rank_rows,
    )

    assert init_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized() and group_world() == 1
    x = torch.arange(3.0)
    assert all_sum(x) is x
    assert rank_rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(5, 0, 2)
    assert local_device("cpu").type == "cpu"
    assert local_device("cuda:0") == torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_global_norms_match_one_process(tmp_path):
    """Both ranks on ``cuda:0`` over ``gloo`` (NCCL refuses two ranks on one
    card): the norm checks against one process on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _ok(spawn_ranks(tmp_path, "--device", "cuda:0"))
    for kind in NORM_KINDS:
        _check_norms(tmp_path, kind)
