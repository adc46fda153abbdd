"""The port's last modules against the JAX package on the CPU: the legacy
models (``models/legacy.py``: PAFDetectionModel, ResNet50CSL,
KurmannEtAl2017Net at ``tests/test_legacy_models.py``'s shapes), ABN
(train and eval, each activation), ``wasserstein_loss``, the training
losses formed from the partial sums of two halves of a batch (what a
2-rank group adds), and the sharded loader's sample order.

The weights are drawn in numpy over the JAX modules' ``eval_shape`` trees
(``test_torch_zoo_models.py::fill_like``) and converted with
``compat/from_jax.py``. Tolerances: forwards within 1e-5 of the largest
output in float32 (sums in another order); losses within 1e-5 relative;
the loader's order and step counts exactly."""

import numpy as np
import pytest
import torch

from tests.test_torch_zoo_models import fill_like
from torch_threads import _two_torch_threads  # noqa: F401

TOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), f"{what}: {err}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _legacy(kind):
    """(JAX module, port module, NHWC input) of ``kind`` at the JAX
    tests' shapes."""
    from mfcnet_tpu.models import legacy as jl

    from mfcnet_tpu_torch.models import legacy as tl

    if kind == "paf":
        return (jl.PAFDetectionModel(num_joints=5, num_joint_associations=4,
                                     width=8),
                tl.PAFDetectionModel(5, 4, width=8), (1, 32, 32, 3))
    if kind == "csl":
        return (jl.ResNet50CSL(num_classes=5, num_joints=4,
                               layers=(1, 1, 1, 1), width=8),
                tl.ResNet50CSL(5, 4, layers=(1, 1, 1, 1), width=8),
                (1, 64, 64, 3))
    dims = (4, 8, 8, 8, 8, 8)
    return (jl.KurmannEtAl2017Net(num_classes=3, num_joints=2, dims=dims),
            tl.KurmannEtAl2017Net(3, 2, dims=dims, input_hw=(32, 32)),
            (2, 32, 32, 3))


@pytest.mark.parametrize("kind", ["paf", "csl", "kurmann"])
def test_legacy_models_match_jax(kind):
    """Eval forwards (running statistics) on the same weights: every
    output of the two-headed models within 1e-5 of its largest value."""
    import jax

    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables

    jm, tm, shape = _legacy(kind)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    v = fill_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 3)
    want = jax.jit(jm.apply)(v, x)
    load_jax_variables(tm, v).eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    for name, g, w in zip(("first", "second"), got, want):
        w = np.asarray(w)
        _close(_nhwc(g) if w.ndim == 4 else g.numpy(), w, f"{kind} {name}")


@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "none"])
def test_abn_matches_jax(activation):
    """ABN in train mode (output, unbiased running variance, input
    gradient of a weighted sum) and then in eval mode on the updated
    statistics, against the JAX module."""
    import jax
    import jax.numpy as jnp
    from mfcnet_tpu.models.abn import ABN as JABN

    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models.abn import ABN, InPlaceABN, InPlaceABNSync

    assert InPlaceABN is ABN and InPlaceABNSync is ABN
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = JABN(activation=activation)
    v = fill_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 5)

    def loss(xx):
        y, upd = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), gx = jax.value_and_grad(loss, has_aux=True)(x)
    y_eval = jm.apply({"params": v["params"], **upd}, x, train=False)
    tm = load_jax_variables(ABN(4, activation=activation), v).train()
    xt = _nchw(x).requires_grad_(True)
    yt = tm(xt)
    (yt * _nchw(g)).sum().backward()
    _close(_nhwc(yt), y, "train output")
    _close(_nhwc(xt.grad), gx, "input gradient")
    _close(tm.running_mean, upd["batch_stats"]["mean"], "running mean")
    _close(tm.running_var, upd["batch_stats"]["var"], "running var")
    with torch.no_grad():
        _close(_nhwc(tm.eval()(_nchw(x))), y_eval, "eval output")


def _log_probs(B=4, H=8, W=6, C=5, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, H, W, C)).astype(np.float32) * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return lp.astype(np.float32), rng.integers(0, C, (B, H, W))


def test_wasserstein_loss_matches_jax():
    from mfcnet_tpu.train.loss import wasserstein_loss as jw

    from mfcnet_tpu_torch.train.loss import wasserstein_loss

    lp, t = _log_probs()
    yy, xx = np.mgrid[0:8, 0:6]
    pts = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float32)
    cost = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    want = float(jw(lp, t, 5, cost))
    got = float(wasserstein_loss(torch.from_numpy(lp), torch.from_numpy(t),
                                 5, cost))
    assert abs(got - want) <= TOL * abs(want), (got, want)


@pytest.mark.parametrize("weights", [None, (1, 1000, 1000, 1000, 1000)])
def test_global_losses_from_two_halves_match_jax(weights):
    """The weighted NLL and the soft Jaccard formed from the partial sums of
    rows 0-1 plus those of rows 2-3 (what a 2-rank group's all-reduce adds)
    equal the JAX package's ``compute_losses`` on the whole batch; the
    per-half losses averaged (DDP's mean of rank-local losses) do not, with
    class weights 1 and 1000."""
    from mfcnet_tpu.train.loss import compute_losses as jcl

    from mfcnet_tpu_torch.train import loss as L

    lp, t = _log_probs()
    _, want = jcl(lp, t, ["nll", "soft_jaccard"], [0.7, 0.3], 5, weights)
    halves = [(torch.from_numpy(lp[r]), torch.from_numpy(t[r]))
              for r in (slice(0, 2), slice(2, 4))]
    nll = L.nll_from_sums(sum(L.nll_sums(a, b, weights) for a, b in halves))
    jac = L.soft_jaccard_from_sums(
        sum(L.soft_jaccard_sums(a, b, 5) for a, b in halves), 5)
    for got, key in ((nll, "loss_nll"), (jac, "loss_soft_jaccard")):
        w = float(want[key])
        assert abs(float(got) - w) <= TOL * abs(w), (key, float(got), w)
    if weights is not None:
        mean = np.mean([float(L.nll_loss(a, b, weights)) for a, b in halves])
        assert abs(mean - float(want["loss_nll"])) > 1e-3


@pytest.mark.parametrize("n,batch,count,epoch,skip", [
    (15, 2, 2, 0, 0), (15, 2, 2, 1, 1), (16, 3, 4, 2, 0), (17, 1, 3, 0, 2),
    (9, 4, 2, 5, 0),
])
def test_sharded_loader_order_matches_jax(n, batch, count, epoch, skip):
    """``DataLoader(shard=(rank, count))``: every rank's batches are the JAX
    loader's, with and without ``drop_last``, after ``set_epoch`` and
    ``skip_batches``; every rank runs as many steps as the others."""
    from mfcnet_tpu.data.loader import DataLoader as JLoader

    from mfcnet_tpu_torch.data.loader import DataLoader

    class Ids:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.array(i)}

    for drop_last in (False, True):
        steps = set()
        for rank in range(count):
            got, want = (
                L(Ids(), batch, shuffle=True, num_workers=1, seed=7,
                  drop_last=drop_last, shard=(rank, count))
                for L in (DataLoader, JLoader))
            for loader in (got, want):
                loader.set_epoch(epoch, skip_batches=skip)
            g = [b["i"].tolist() for b in got]
            assert g == [b["i"].tolist() for b in want]
            assert len(got) == len(want)
            steps.add(len(g))
        assert len(steps) == 1
