"""The zoo's shared layers in the port, on the CPU: batch norm against
flax's ``BatchNorm`` (train mode in float32 and bfloat16, its gradient,
eval mode on float32 statistics, a batch of one position), dropout and
drop-path (rate, 1/keep scale, per-sample mask, the train state's seeded
generator), the seeded initialization of linear, depthwise and LayerNorm
layers, and the loader's drop of a reference DeepLab/FCN checkpoint's
``aux_classifier.*`` keys.

Tolerances. Train-mode BN, bfloat16: the port rounds once from float32,
as flax does; the two may differ by one bf16 step on at most 1 % of the
elements (sums in another order move a value across a rounding
boundary), or, near 0 where a bf16 step is finer, by the float32
bound below (1e-5). Float32: flax's own result is 7.6e-6 from the
float64 one on the stated case (mean 5, std 3) and 2.1e-6 on a centred one
(XLA's CPU reductions sum in order; E[y^2] - E[y]^2 loses ~3 digits at
mean 5), so the port is held within 1e-5 of flax and no further from
float64 than flax is, plus 1e-6, and on the centred input within 1e-6 of
float64 (read: 1.1e-6 and 5.5e-7 from float64). Gradients: 1e-5 of the
largest."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

CASE = (4, 16, 16, 8)


def _case(mean=5.0, std=3.0, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(CASE) * std + mean).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, CASE[-1]).astype(np.float32)
    bias = rng.normal(0, 1, CASE[-1]).astype(np.float32)
    return x, scale, bias


def _flax_train(x, scale, bias, dtype):
    """flax BatchNorm(momentum 0.9, eps 1e-5) in train mode: (output as
    float32 NHWC, new mean, new var)."""
    import jax.numpy as jnp
    from flax import linen as nn

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    v = {"params": {"scale": jnp.asarray(scale, dtype),
                    "bias": jnp.asarray(bias, dtype)},
         "batch_stats": {"mean": jnp.zeros(x.shape[-1]),
                         "var": jnp.ones(x.shape[-1])}}
    y, st = bn.apply(v, jnp.asarray(x, dtype), mutable=["batch_stats"])
    st = st["batch_stats"]
    return (np.asarray(y.astype(jnp.float32)), np.asarray(st["mean"]),
            np.asarray(st["var"]))


def _port_bn(scale, bias, dtype):
    from mfcnet_tpu_torch.models.common import BatchNorm2d

    bn = BatchNorm2d(len(scale))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn.to(dtype)


def _port_train(x, scale, bias, dtype):
    bn = _port_bn(scale, bias, dtype).train()
    bn.running_mean.data = bn.running_mean.float()
    bn.running_var.data = bn.running_var.float()
    y = bn(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    assert y.dtype == dtype
    return (y.detach().float().permute(0, 2, 3, 1).numpy(),
            bn.running_mean.numpy(), bn.running_var.numpy())


def test_train_bn_bfloat16_rounds_once_as_flax():
    """F3: the port's bf16 train-mode BN equals flax's on at least 99 % of
    the elements, the rest one bf16 step apart (it differed on 48 % when
    it normalized in bf16)."""
    import jax.numpy as jnp

    x, scale, bias = _case()
    got, gm, gv = _port_train(x, scale, bias, torch.bfloat16)
    want, wm, wv = _flax_train(x, scale, bias, jnp.bfloat16)
    diff = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert np.all(diff <= np.maximum(step * 1.0001, 1e-5))
    # statistics from the bf16 values, in float32, on both sides
    np.testing.assert_allclose(gm, wm, rtol=1e-5)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)


@pytest.mark.parametrize("mean,std", [(5.0, 3.0), (0.0, 1.0)],
                         ids=["stated", "centred"])
def test_train_bn_float32_matches_flax(mean, std):
    x, scale, bias = _case(mean, std)
    got, gm, gv = _port_train(x, scale, bias, torch.float32)
    want, wm, wv = _flax_train(x, scale, bias, np.float32)
    x64 = x.astype(np.float64)
    m, v = x64.mean((0, 1, 2)), x64.var((0, 1, 2))
    exact = (x64 - m) / np.sqrt(v + 1e-5) * scale + bias
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max() + 1e-6
    if mean == 0.0:
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    # running statistics: 0.9 * (0, 1) + 0.1 * (mean, biased var)
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gv, wv, rtol=1e-5)
    np.testing.assert_allclose(gv, 0.9 + 0.1 * v, rtol=1e-5)


def test_train_bn_gradient_matches_flax():
    """The backward (PyTorch's batch-norm backward on the saved input and
    float32 statistics) against JAX's autodiff of flax's BatchNorm."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    x, scale, bias = _case(1.0, 2.0)
    g = np.random.default_rng(3).standard_normal(CASE).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def loss(x, s, b):
        v = {"params": {"scale": s, "bias": b},
             "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
        y, _ = bn.apply(v, x, mutable=["batch_stats"])
        return (y * g).sum()

    wx, ws, wb = jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)
    pbn = _port_bn(scale, bias, torch.float32).train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (pbn(tx) * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    for got, want in ((tx.grad.permute(0, 2, 3, 1), wx),
                      (pbn.weight.grad, ws), (pbn.bias.grad, wb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_train_bn_one_position_per_channel():
    """DeepLab's image-pooling branch at batch 1 sees one position per
    channel: variance 0, the output is the bias, and the backward runs
    (``nn.BatchNorm2d`` raises on it)."""
    from mfcnet_tpu_torch.models.common import BatchNorm2d

    bn = BatchNorm2d(6).train()
    with torch.no_grad():
        bn.bias.copy_(torch.arange(6.0))
    x = torch.randn(1, 6, 1, 1, requires_grad=True)
    y = bn(x)
    torch.testing.assert_close(y.detach().flatten(), torch.arange(6.0))
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(bn.running_var, torch.full((6,), 0.9))
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(6).train()(x)


def test_eval_bn_on_float32_statistics_matches_flax():
    """A bf16 step with the base frozen: bf16 input and parameters, float32
    running statistics; flax normalizes in float32 and rounds once."""
    import jax.numpy as jnp
    from flax import linen as nn

    x, scale, bias = _case(2.0, 3.0)
    mean = np.linspace(1, 3, 8).astype(np.float32)
    var = np.linspace(4, 12, 8).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want = np.asarray(bn.apply(
        {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                    "bias": jnp.asarray(bias, jnp.bfloat16)},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    pbn = _port_bn(scale, bias, torch.bfloat16).eval()
    pbn.running_mean.data = torch.from_numpy(mean)
    pbn.running_var.data = torch.from_numpy(var)
    with torch.no_grad():
        got = pbn(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step * 1.0001)


def test_drop_path_rate_scale_and_per_sample_mask():
    from mfcnet_tpu_torch.models.common import DropPath, Dropout
    from mfcnet_tpu_torch.models.segformer import MixVisionTransformer

    n, rate = 4000, 0.3
    dp = DropPath(rate).train()
    dp.generator = torch.Generator().manual_seed(0)
    y = dp(torch.ones(n, 5, 3))
    per_sample = y.reshape(n, -1)
    # each sample is dropped whole or kept whole, and kept ones are scaled
    assert torch.all(per_sample.min(1).values == per_sample.max(1).values)
    assert set(per_sample[:, 0].unique().tolist()) == {
        0.0, float(np.float32(1.0 / 0.7))}
    dropped = (per_sample[:, 0] == 0).float().mean().item()
    assert abs(dropped - rate) < 3 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(dp.eval()(torch.ones(3, 2)), torch.ones(3, 2))
    do = Dropout(0.1).train()
    do.generator = torch.Generator().manual_seed(1)
    z = do(torch.ones(200, 100))
    assert set(z.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.9))}
    assert abs((z == 0).float().mean().item() - 0.1) < 0.01
    # MiT-B3's blocks: 0.1 * i / (n - 1) over its 28 blocks
    enc = MixVisionTransformer((8, 8, 8, 8), (3, 4, 18, 3), (1, 1, 1, 1),
                               (8, 4, 2, 1))
    rates = [b.drop_path.rate for s in range(1, 5)
             for b in getattr(enc, f"block{s}")]
    np.testing.assert_allclose(rates, 0.1 * np.arange(28) / 27)


def _segformer_step(drop_path=True):
    """Two single-frame SegFormer train steps from seeded weights, with
    drop-path on (or every rate set to 0): the losses and the parameters
    after them."""
    from mfcnet_tpu_torch.models import (
        get_tooltip_segmentation_model,
        init_weights_lecun,
    )
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_singleframe_train_step

    from mfcnet_tpu_torch.models.common import DropPath

    model = init_weights_lecun(
        get_tooltip_segmentation_model("SegFormer", 5, scale=0.0625),
        torch.Generator().manual_seed(0))
    if not drop_path:
        for m in model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
    state = TrainState(model, make_schedule("Constant", 1e-3, 1, 1),
                       split_base=False)
    step = make_singleframe_train_step(["nll"], [1.0], 5)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(
                 rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
             "mask": torch.from_numpy(rng.integers(0, 5, (2, 32, 32)))}
    parts = [step(state, batch)["loss_total"].item() for _ in range(2)]
    return parts, {k: v.clone() for k, v in model.state_dict().items()}


def test_seeded_generator_repeats_a_step_bit_for_bit():
    """The single-frame SegFormer's drop-path draws from the train state's
    generator, seeded by the micro-step: a run repeats two steps bit for
    bit, and the draws matter (without drop-path the run ends elsewhere)."""
    p1, a = _segformer_step()
    p2, b = _segformer_step()
    p3, c = _segformer_step(drop_path=False)
    assert p1 == p2
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert p3 != p1
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].is_floating_point())


@pytest.mark.parametrize("lecun", [False, True], ids=["default", "lecun"])
def test_seeded_init_fixes_linear_depthwise_and_layernorm(lecun):
    """A SegFormer's linear layers, its depthwise convolutions and its
    LayerNorms come from the seed too; lecun-normal scales each by its
    fan-in (input channels per group x taps)."""
    from mfcnet_tpu_torch.models import (
        get_tooltip_segmentation_model,
        init_weights,
        init_weights_lecun,
    )

    init = init_weights_lecun if lecun else init_weights

    def build(seed):
        m = get_tooltip_segmentation_model("SegFormer", 5, scale=0.25)
        with torch.no_grad():
            for p in m.parameters():
                p.uniform_(-3, 3)  # whatever the global RNG left
        return init(m, torch.Generator().manual_seed(seed))

    a, b = build(0), build(0)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    blk = a.encoder.block1[0]
    assert torch.equal(blk.norm1.weight, torch.ones_like(blk.norm1.weight))
    assert torch.equal(blk.norm1.bias, torch.zeros_like(blk.norm1.bias))
    if lecun:
        fc = a.encoder.block3[0].mlp.fc1
        dw = a.encoder.block3[0].mlp.dwconv.dwconv
        for w, fan in ((fc.weight, fc.in_features), (dw.weight, 9)):
            assert abs(w.std().item() * np.sqrt(fan) - 1) < 0.15
        assert torch.equal(fc.bias, torch.zeros_like(fc.bias))


def test_aux_classifier_keys_are_dropped_and_the_rest_loads_strictly(
        tmp_path, caplog):
    """A reference DeepLab built with ``pretrained=True`` carries
    ``aux_classifier.*`` (torchvision's auxiliary FCN head), alone or under
    ``base_model.``: the loader drops exactly those and logs their count;
    any other unknown key still fails a strict load."""
    import logging

    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        get_tooltip_segmentation_model,
    )
    from mfcnet_tpu_torch.utils.checkpoint import load_state_dict_file

    base = get_tooltip_segmentation_model("DeepLab_v3", 5, scale=0.0625)
    aux = {"aux_classifier.0.weight": torch.zeros(4, 64, 3, 3),
           "aux_classifier.4.bias": torch.zeros(5)}
    path = tmp_path / "deeplab.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          {**base.state_dict(), **aux}.items()}}, path)
    with caplog.at_level(logging.INFO):
        sd = load_state_dict_file(path)
    assert "dropped 2 aux_classifier keys" in caplog.text
    assert set(sd) == set(base.state_dict())
    base.load_state_dict(sd, strict=True)

    multi = get_multiframe_segmentation_model("DeepLabMulti-Basic", 5, 3,
                                              scale=0.0625)
    mpath = tmp_path / "multi.pth"
    torch.save({**multi.state_dict(),
                **{f"base_model.{k}": v for k, v in aux.items()}}, mpath)
    multi.load_state_dict(load_state_dict_file(mpath), strict=True)
    torch.save({**base.state_dict(), "classifier.9.weight": torch.zeros(1)},
               path)
    with pytest.raises(RuntimeError, match="classifier.9.weight"):
        base.load_state_dict(load_state_dict_file(path), strict=True)
