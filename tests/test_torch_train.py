"""The port's training numerics against the JAX package's on the same
seeded numpy inputs, on the CPU: the head's train mode (batch statistics
and the running-statistics update), the losses, the metrics and the
learning-rate schedule.

Tolerances: 1e-5 absolute (float32) for the head's output and running
statistics and for the losses (sums taken in another order), exact for
the metrics (counts), 1e-6 relative for the schedule (float32 in optax,
float64 here)."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


T, C, IN_CH = 3, 5, 18


def test_head_train_mode_matches_jax_batch_statistics():
    """Two forward passes in train mode: the output and the running
    statistics after each follow the JAX head (biased variance, running =
    0.9 old + 0.1 batch); eval mode then uses those statistics."""
    import jax

    from mfcnet_tpu.models.mfcnet import MultiFrameHead as JHead
    from mfcnet_tpu_torch.models.mfcnet import MultiFrameHead

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 24, 16, IN_CH)).astype(np.float32) * s
          for s in (1.0, 3.0)]
    jh = JHead(C, T)
    v = jh.init(jax.random.PRNGKey(0), xs[0])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    for i in range(3):  # non-trivial scale and bias
        n = params[f"BatchNorm_{i}"]["scale"].shape[0]
        params[f"BatchNorm_{i}"]["scale"] = rng.uniform(0.5, 1.5, n).astype(
            np.float32)
        params[f"BatchNorm_{i}"]["bias"] = rng.normal(0, 0.2, n).astype(
            np.float32)
    stats = v["batch_stats"]
    ph = MultiFrameHead(IN_CH, C, T)
    sd = {}
    for i, tidx in enumerate((0, 3, 6, 9)):
        sd[f"{tidx}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)))
    for i, tidx in enumerate((1, 4, 7)):
        bn = params[f"BatchNorm_{i}"]
        sd[f"{tidx}.weight"] = torch.from_numpy(bn["scale"])
        sd[f"{tidx}.bias"] = torch.from_numpy(bn["bias"])
        sd[f"{tidx}.running_mean"] = torch.zeros(len(bn["scale"]))
        sd[f"{tidx}.running_var"] = torch.ones(len(bn["scale"]))
        sd[f"{tidx}.num_batches_tracked"] = torch.tensor(0)
    ph.load_state_dict(sd)
    ph.train()
    for x in xs:
        want, mut = jh.apply({"params": params, "batch_stats": stats}, x,
                             train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = ph(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
        for i, tidx in enumerate((1, 4, 7)):
            bn = ph[tidx]
            np.testing.assert_allclose(
                bn.running_mean.numpy(),
                np.asarray(stats[f"BatchNorm_{i}"]["mean"]), rtol=0,
                atol=1e-5)
            np.testing.assert_allclose(
                bn.running_var.numpy(),
                np.asarray(stats[f"BatchNorm_{i}"]["var"]), rtol=0,
                atol=1e-5)
    ph.eval()
    want = jh.apply({"params": params, "batch_stats": stats}, xs[0])
    with torch.no_grad():
        got = ph(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)


def _log_probs(seed=1, shape=(2, 12, 10, C)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return lp.astype(np.float32), rng.integers(0, C, shape[:-1]).astype(
        np.int32)


@pytest.mark.parametrize("loss_fns,loss_wts,class_weights", [
    (["nll"], [1.0], None),
    (["nll"], [1.0], [1, 100, 100, 100, 100]),
    (["nll", "soft_jaccard"], [0.7, 0.3], [1, 50, 50, 50, 50]),
    (["soft_jaccard"], [0.5], None),
])
def test_losses_match_jax(loss_fns, loss_wts, class_weights):
    from mfcnet_tpu.train.loss import compute_losses as jloss
    from mfcnet_tpu_torch.train.loss import compute_losses

    lp, t = _log_probs()
    jt, jp = jloss(lp, t, loss_fns, loss_wts, C, class_weights)
    pt, pp = compute_losses(torch.from_numpy(lp), torch.from_numpy(t),
                            loss_fns, loss_wts, C, class_weights)
    assert set(jp) == set(pp)
    for k in jp:
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="one weight per loss"):
        compute_losses(torch.from_numpy(lp), torch.from_numpy(t),
                       ["nll", "soft_jaccard"], [1.0], C)


def test_mse_matches_jax():
    from mfcnet_tpu.train.loss import mse_loss as jmse
    from mfcnet_tpu_torch.train.loss import mse_loss

    lp, t = _log_probs(seed=3)
    tt = t[..., None]  # broadcasts against the class axis on both sides
    np.testing.assert_allclose(
        float(mse_loss(torch.from_numpy(lp), torch.from_numpy(tt))),
        float(jmse(lp, tt)), rtol=1e-6)


def test_metrics_match_jax():
    from mfcnet_tpu.train.metrics import compute_metrics as jmetrics
    from mfcnet_tpu.train.metrics import confusion_matrix as jcm
    from mfcnet_tpu_torch.train.metrics import (
        compute_metrics,
        confusion_matrix,
    )

    lp, t = _log_probs(seed=2)
    want = jmetrics(lp, t, ["iou", "dice"], C)
    got = compute_metrics(torch.from_numpy(lp), torch.from_numpy(t),
                          ["iou", "dice"], C)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    pred = lp.argmax(-1)
    np.testing.assert_array_equal(
        confusion_matrix(torch.from_numpy(pred), torch.from_numpy(t),
                         C).numpy(), np.asarray(jcm(pred, t, C)))


@pytest.mark.parametrize("name,num_epochs,steps_per_epoch", [
    ("StepDecay", 10, 7), ("StepDecay", 3, 1), ("Constant", 4, 5)])
def test_schedule_matches_optax_per_step(name, num_epochs, steps_per_epoch):
    """A per-update staircase, as optax's exponential_decay(staircase)."""
    from mfcnet_tpu.train.schedule import make_schedule as jsched
    from mfcnet_tpu_torch.train.schedule import make_schedule

    js = jsched(name, 3e-4, num_epochs, steps_per_epoch)
    ps = make_schedule(name, 3e-4, num_epochs, steps_per_epoch)
    for step in range(num_epochs * steps_per_epoch + 3):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6)
