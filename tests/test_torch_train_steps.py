"""The port's multi-frame train step against the JAX package's on the
same weights (JAX init -> ``compat.from_jax.load_jax_train_state``), the
same seeded numpy batches and one fixed flow (``flow_fn`` returns it on
both sides; RAFT's parity is held by ``test_torch_flow_tracker.py``), on
the CPU, with depth inputs: the warp then differentiates through the
port's plain backward where the base trains.

Tolerances (float32): loss parts 1e-5 relative (sums in another order);
parameters and running statistics after each update within 1e-5 of each
tensor's largest magnitude plus 1e-4 of the learning rate (Adam moves
every element by about the learning rate whatever its gradient's size,
so float32 differences of small gradients show at that scale; the
biases start at 0), except for at most one element in a thousand (one
in a smaller tensor), which may be off by 2 % of the learning rate: where a gradient is of the order
of Adam's eps (1e-8), the update lr * m / (sqrt(v) + eps) passes the
relative float32 difference of that gradient on whole (found: 4 elements
of the head's first kernel, 0.9 % of the learning rate, under gradient
accumulation); a frozen base bit-identical. bf16: the
port's bf16 step within the JAX bf16 step's own distance from the JAX
float32 step plus the float32 margin, per tensor, as
``test_torch_unflow_bf16.py`` holds the bf16 UnFlow."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


B, T, H, W, C = 2, 3, 64, 32, 5
STAGES = ((4,), (8,), (8, 8), (16, 16), (16, 16))
LOSSES = (["nll", "soft_jaccard"], [0.7, 0.3])
CLASS_WEIGHTS = [1, 50, 50, 50, 50]
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    """JAX module, its variables, the fixed flow and three batches."""
    import jax

    from mfcnet_tpu.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu.utils.jitinit import jit_init

    jm = MultiFrameSegmenter(
        base=TernausNet16(num_classes=C, num_filters=4, stage_convs=STAGES),
        num_classes=C, num_frames=T, variant="basic", base_output="exp")
    v = jit_init(jm, jax.random.PRNGKey(0),
                 np.zeros((1, T, H, W, 3), np.float32),
                 optflow=np.zeros((1, T - 1, H, W, 2), np.float32),
                 depth=np.zeros((1, T, H, W, 1), np.float32))
    rng = np.random.default_rng(0)
    flow = rng.uniform(-4, 4, (B, T - 1, H, W, 2)).astype(np.float32)
    batches = [{
        "frames": rng.standard_normal((B, T, H, W, 3)).astype(np.float32),
        "mask": rng.integers(0, C, (B, H, W)).astype(np.int32),
        "depth": rng.random((B, T, H, W, 1)).astype(np.float32),
    } for _ in range(4)]
    return jm, jax.tree_util.tree_map(np.asarray, v), flow, batches


_JAX_RUNS = {}


def _jax_run(setup, n, train_base, accum=1, ema=0.0, dtype=None):
    """The JAX states after each of n micro-steps and their loss parts
    (each configuration compiled and run once per module)."""
    key = (id(setup), train_base, accum, ema, dtype)
    if key not in _JAX_RUNS or len(_JAX_RUNS[key]) < n:
        _JAX_RUNS[key] = _jax_steps(setup, n, train_base, accum, ema, dtype)
    return _JAX_RUNS[key][:n]


def _jax_steps(setup, n, train_base, accum, ema, dtype):
    import jax.numpy as jnp

    from mfcnet_tpu.train.schedule import make_schedule
    from mfcnet_tpu.train.state import TrainState, multiframe_optimizer
    from mfcnet_tpu.train.steps import make_multiframe_train_step

    jm, v, flow, batches = setup
    tx = multiframe_optimizer(make_schedule("StepDecay", LR, 2, 1), T,
                              train_base, False, grad_accum=accum)
    st = TrainState.create(jm.apply, v["params"], tx, v["batch_stats"],
                           ema_decay=ema)
    step = make_multiframe_train_step(
        jm, *LOSSES, C, class_weights=CLASS_WEIGHTS,
        train_base_model=train_base, flow_fn=lambda f: jnp.asarray(flow),
        donate=False, compute_dtype=dtype)
    out = []
    for b in batches[:n]:
        st, parts = step(st, b)
        out.append((st, {k: float(x) for k, x in parts.items()}))
    return out


def _port_run(setup, n, train_base, accum=1, ema=0.0, dtype=None):
    from mfcnet_tpu_torch.compat.from_jax import load_jax_train_state
    from mfcnet_tpu_torch.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu_torch.train.schedule import make_schedule
    from mfcnet_tpu_torch.train.state import TrainState
    from mfcnet_tpu_torch.train.steps import make_multiframe_train_step

    _, v, flow, batches = setup
    model = load_jax_train_state(
        MultiFrameSegmenter(TernausNet16(C, 4, STAGES), C, T,
                            add_depth_inputs=True),
        v["params"], v["batch_stats"])
    st = TrainState(model, make_schedule("StepDecay", LR, 2, 1), T,
                    train_base_model=train_base, grad_accum=accum,
                    ema_decay=ema)
    step = make_multiframe_train_step(
        *LOSSES, C, class_weights=CLASS_WEIGHTS,
        flow_fn=lambda f: torch.from_numpy(flow), compute_dtype=dtype)
    out = []
    for b in batches[:n]:
        tb = {k: torch.from_numpy(x) for k, x in b.items()}
        tb["mask"] = tb["mask"].long()
        parts = step(st, tb)
        out.append(({k: x.clone() for k, x in model.state_dict().items()},
                    None if st.ema is None else st.ema_state_dict(),
                    {k: float(x) for k, x in parts.items()}))
    return model, st, out


def _jax_sd(state, model, ema=False):
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax

    params = state.ema_params if ema else state.params
    return state_dict_from_jax(
        {"params": params, "batch_stats": state.batch_stats}, model)


def _assert_sd_close(got, want):
    """Per tensor: every element within 1e-5 of the tensor's largest
    magnitude plus 1e-4 of the learning rate, but for at most one in a
    thousand (one in a smaller tensor), which may be off by up to 2 % of
    the learning rate (see the module docstring)."""
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        err = (got[k].float() - w).abs()
        tight = 1e-5 * float(w.abs().max())
        assert float(err.max()) <= tight + 2e-2 * LR, (k, float(err.max()))
        n_loose = int((err > tight + 1e-4 * LR).sum())
        assert n_loose <= max(1, err.numel() // 1000), (k, n_loose)


@pytest.mark.parametrize("train_base", [True, False],
                         ids=["base_trained", "base_frozen"])
def test_three_train_steps_match_jax(setup, train_base):
    """Steps 1 to 3 (the StepDecay staircase decays after each update):
    loss parts, every parameter and the head's running statistics after
    each; a frozen base stays bit-identical, a trained one moves."""
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax

    jout = _jax_run(setup, 3, train_base)
    model, _, pout = _port_run(setup, 3, train_base)
    for (js, jparts), (psd, _, pparts) in zip(jout, pout):
        for k in jparts:
            np.testing.assert_allclose(pparts[k], jparts[k], rtol=1e-5)
        _assert_sd_close(psd, _jax_sd(js, model))
    v0 = state_dict_from_jax(setup[1], model)
    base = [k for k in v0 if k.startswith("base_model.")]
    moved = [k for k in base if not torch.equal(pout[-1][0][k], v0[k])]
    assert moved == ([] if not train_base else base)


def test_grad_accum_and_ema_match_jax(setup):
    """grad_accum=2 (optax.MultiSteps on the JAX side): micro-steps 1 and
    3 move nothing but the running statistics; 2 and 4 update on the
    mean gradient of the pair. The EMA (decay 0.5) follows the JAX
    recurrence and blends only on updates."""
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax

    jout = _jax_run(setup, 4, True, accum=2, ema=0.5)
    model, st, pout = _port_run(setup, 4, True, accum=2, ema=0.5)
    assert st.updates == 2 and st.step == 4
    prev = prev_ema = state_dict_from_jax(setup[1], model)
    for i, ((js, jparts), (psd, pema, pparts)) in enumerate(zip(jout, pout)):
        for k in jparts:
            np.testing.assert_allclose(pparts[k], jparts[k], rtol=1e-5)
        _assert_sd_close(psd, _jax_sd(js, model))
        _assert_sd_close(pema, _jax_sd(js, model, ema=True))
        if i % 2 == 0:  # no update: parameters and EMA as before
            for k, val in psd.items():
                if val.is_floating_point() and "running" not in k:
                    assert torch.equal(val, prev[k]), k
                    assert torch.equal(pema[k], prev_ema[k]), k
        prev, prev_ema = psd, pema


def test_bf16_step_within_the_jax_bf16_envelope(setup):
    """One bf16 step (parameters, frames, depth and flow cast; f32 batch
    statistics, log_softmax and losses): per tensor, the port's bf16
    result is within the JAX bf16 step's distance from the JAX float32
    step, plus the float32 margin."""
    j32 = _jax_run(setup, 1, True)[0]
    j16 = _jax_run(setup, 1, True, dtype="bfloat16")[0]
    model, _, p16 = _port_run(setup, 1, True, dtype="bfloat16")
    for k in j32[1]:
        env = abs(j16[1][k] - j32[1][k]) + 1e-5 * abs(j32[1][k])
        assert abs(p16[0][2][k] - j16[1][k]) <= 2 * env + 1e-6, k
    w32, w16 = _jax_sd(j32[0], model), _jax_sd(j16[0], model)
    for k, w in w32.items():
        if not w.dtype.is_floating_point:
            continue
        env = float((w16[k] - w).abs().max()) + 1e-5 * float(w.abs().max())
        err = float((p16[0][0][k] - w16[k]).abs().max())
        assert err <= 2 * env + 1e-12, (k, err, env)
