"""The PyTorch port's models against the JAX package's, on the same
weights (JAX init -> ``compat.from_jax``) and the same numpy inputs, at
float32 on the CPU. Tolerance: 1e-4 absolute on probabilities (float32
convolutions summed in another order)."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H, W, T, C = 64, 32, 3, 5
STAGES = ((4,), (8,), (8, 8), (16, 16), (16, 16))
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX module, JAX variables with non-trivial BN stats, port model)."""
    import jax

    from mfcnet_tpu.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import MultiFrameSegmenter as PortSeg
    from mfcnet_tpu_torch.models import TernausNet16 as PortTN

    jm = MultiFrameSegmenter(
        base=TernausNet16(num_classes=C, num_filters=4, stage_convs=STAGES),
        num_classes=C, num_frames=T, variant="basic", base_output="exp",
    )
    v = jit_init(jm, jax.random.PRNGKey(42),
                 np.zeros((1, T, H, W, 3), np.float32))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    head, stats = v["params"]["multiframe_net"]["head"], \
        v["batch_stats"]["multiframe_net"]["head"]
    for i in range(3):
        n = head[f"BatchNorm_{i}"]["scale"].shape[0]
        head[f"BatchNorm_{i}"]["scale"] = rng.uniform(0.5, 1.5, n).astype(
            np.float32)
        head[f"BatchNorm_{i}"]["bias"] = rng.normal(0, 0.1, n).astype(
            np.float32)
        stats[f"BatchNorm_{i}"]["mean"] = rng.normal(0, 0.1, n).astype(
            np.float32)
        stats[f"BatchNorm_{i}"]["var"] = rng.uniform(0.5, 2.0, n).astype(
            np.float32)
    pm = load_jax_variables(PortSeg(PortTN(C, 4, STAGES), C, T).eval(), v)
    return jm, v, pm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_ternausnet16_matches_jax(pair):
    from mfcnet_tpu.models import TernausNet16

    jm, v, pm = pair
    x = _x((2, H, W, 3))
    want = np.exp(np.asarray(TernausNet16(
        num_classes=C, num_filters=4, stage_convs=STAGES
    ).apply({"params": v["params"]["base"]}, x)))
    with torch.no_grad():
        got = torch.exp(pm.base_model(
            torch.from_numpy(x).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_multiframe_head_eval_matches_jax(pair):
    from mfcnet_tpu.models import MultiFrameHead

    jm, v, pm = pair
    x = np.abs(_x((2, H, W, T * C), seed=2))
    hv = {"params": v["params"]["multiframe_net"]["head"],
          "batch_stats": v["batch_stats"]["multiframe_net"]["head"]}
    want = np.asarray(MultiFrameHead(C, T).apply(hv, x, train=False))
    with torch.no_grad():
        got = pm.multiframe_net(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(),
                               torch.softmax(torch.tensor(want), -1).numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["__call__", "base_forward",
                                    "fuse_precomputed"])
def test_segmenter_methods_match_jax(pair, method):
    jm, v, pm = pair
    if method == "__call__":
        x = _x((2, T, H, W, 3), seed=3)
        want = np.asarray(jm.apply(v, x))
        fn = pm
    elif method == "base_forward":
        x = _x((2, H, W, 3), seed=4)
        want = np.asarray(jm.apply(v, x, method="base_forward"))
        fn = pm.base_forward
    else:
        x = np.abs(_x((2, T, H, W, C), seed=5))
        want = np.asarray(jm.apply(v, x, method="fuse_precomputed"))
        fn = pm.fuse_precomputed
    with torch.no_grad():
        got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if method != "base_forward":  # logits -> probabilities
        got = torch.softmax(torch.tensor(got), -1).numpy()
        want = torch.softmax(torch.tensor(want), -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_from_jax_round_trip_is_exact():
    """JAX params -> from_jax -> torch_convert -> JAX params, bit-exact
    (VGG16-shaped stages: torch_convert reads torchvision's indices)."""
    import jax

    from mfcnet_tpu.compat.torch_convert import convert_multiframe_ternausnet
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    scale = 1 / 16
    v = jit_init(jget("TernausNetMulti-Basic", C, T, scale=scale),
                 jax.random.PRNGKey(7), np.zeros((1, T, 32, 32, 3),
                                                 np.float32))
    pm = get_multiframe_segmentation_model("TernausNetMulti-Basic", C, T,
                                           scale=scale)
    sd = {k: t.numpy() for k, t in state_dict_from_jax(v, pm).items()}
    back = convert_multiframe_ternausnet(sd)
    leaves_a = jax.tree_util.tree_leaves_with_path(v)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves_a) == len(leaves_b)
    for path, a in leaves_a:
        np.testing.assert_array_equal(np.asarray(leaves_b[path]),
                                      np.asarray(a), err_msg=str(path))


def test_reference_state_dict_keys_load(pair):
    """The port's module tree is the reference's: the torch oracle's
    state_dict (tests/torch_ref.py) loads strictly."""
    from tests.torch_ref import TernausNetMultiBasicTorch

    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    ref = TernausNetMultiBasicTorch(C, T, width_mult=0.125)
    port = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=0.125)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(_x((1, T, H, W, 3), seed=6))
    with torch.no_grad():
        want = ref.eval()([x[:, t].permute(0, 3, 1, 2) for t in range(T)])
        got = port(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("model_type,err", [
    ("UNetMulti-Large", None),
    ("ResUNetMulti-Basic", None),
    ("NoSuchNet-Basic", "not recognized"),
])
def test_registry_names_roadmap_item(model_type, err):
    """The Multi families the registry once refused (ROADMAP item 10b)
    build and fuse one 64x64 window; an unknown type raises."""
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    if err is not None:
        with pytest.raises(ValueError, match=err):
            get_multiframe_segmentation_model(model_type, C, T)
        return
    model = get_multiframe_segmentation_model(
        model_type, C, T, scale=0.0625,
        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(torch.randn(1, T, 64, 64, 3))
    assert out.shape == (1, 64, 64, C) and torch.isfinite(out).all()


def test_registry_seeded_init_is_reproducible():
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    def build(seed):
        return get_multiframe_segmentation_model(
            "TernausNetMulti-Basic", C, T, scale=0.0625,
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_parity_mode_sets_and_restores_flags():
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
              cudnn.deterministic, cudnn.benchmark)
    with parity_mode():
        assert not cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            cudnn.deterministic, cudnn.benchmark) == before
