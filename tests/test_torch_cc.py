"""The port's connected-component ops (``mfcnet_tpu_torch.ops.cc``)
against the JAX package's Pallas kernels, run in interpret mode on the
CPU as tests/test_decode_device.py runs them. Integer outputs must be
equal; the float sums within 1e-5 relative (the port sums exactly in
int64, the Pallas kernel in float32 matmuls). A CUDA-marked case holds
each CUDA kernel against its plain version on the card."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H, W, K = 48, 64, 64


def _geometries():
    """(H, W) class maps in the union encoding (1 l-base, 2 r-base,
    3 l-tip, 4 r-tip): the crafted cases of tests/test_decode_device.py."""
    maps = []
    pred = np.zeros((H, W), np.int32)   # contained specks
    pred[10:26, 10:26] = 3
    pred[14:22, 14:22] = 0
    pred[16:20, 16:20] = 1
    pred[8:30, 34:58] = 4
    pred[14:20, 40:46] = 2
    pred[34:44, 6:18] = 1
    pred[34:42, 26:34] = 2
    pred[36:45, 40:50] = 3
    pred[2:6, 38:44] = 4
    maps.append(pred)
    pred = np.zeros((H, W), np.int32)   # nested rings: conflict
    pred[8:32, 30:54] = 2
    pred[12:28, 34:50] = 0
    pred[14:26, 36:48] = 4
    pred[18:22, 40:44] = 0
    maps.append(pred)
    pred = np.zeros((H, W), np.int32)   # straddle through a porous corner
    pred[5, 5:13] = 2
    pred[12, 5:13] = 2
    pred[5:13, 5] = 2
    pred[5:13, 12] = 2
    pred[4, 6] = 2
    pred[5, 6] = 3
    pred[4, 5] = 3
    pred[2:5, 2:5] = 3
    pred[20:28, 4:12] = 1
    pred[20:26, 20:26] = 4
    maps.append(pred)
    pred = np.zeros((H, W), np.int32)   # adjacency torture
    pred[10:20, 10:20] = 1
    pred[10:20, 20:30] = 3
    pred[20:26, 30:36] = 2
    pred[30:40, 10:20] = 4
    pred[30:40, 20:21] = 2
    pred[41:45, 21:25] = 4
    pred[0:5, 0:5] = 1
    pred[44, 60] = 4
    pred[5:12, 40:47] = 4
    pred[7:10, 42:45] = 0
    maps.append(pred)
    rng = np.random.default_rng(21)     # speckle: > K components
    maps.append(rng.integers(0, 5, (H, W)) * (rng.random((H, W)) < 0.4))
    ucls = np.choose(np.stack(maps), [0, 2, 4, 1, 3]).astype(np.int8)
    return ucls


@pytest.fixture(scope="module")
def ucls():
    return _geometries()


def _stats_close(got, want):
    np.testing.assert_array_equal(got[..., :2, :], want[..., :2, :])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_union_stats_matches_pallas(ucls):
    import jax.numpy as jnp

    from mfcnet_tpu.ops.cc_pallas import union_stats_pallas
    from mfcnet_tpu_torch.ops import cc

    want = [np.asarray(a) for a in
            union_stats_pallas(jnp.asarray(ucls), K=K, interpret=True)]
    got = [t.numpy() for t in cc.union_stats(torch.from_numpy(ucls), K=K)]
    stats, ccls, ncomp, conflict, cid = got
    _stats_close(stats, want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    # the geometries take every branch: clean, conflict, straddle, > K
    assert conflict.tolist()[:4] == [False, True, True, False]
    assert ncomp[4] > K


def test_base_stats_matches_pallas(ucls):
    import jax.numpy as jnp

    from mfcnet_tpu.ops.cc_pallas import base_stats_pallas
    from mfcnet_tpu_torch.ops import cc

    masks = np.stack([ucls == c for c in (1, 2, 3, 4)], axis=1)  # (5,4,H,W)
    want = [np.asarray(a) for a in base_stats_pallas(
        jnp.asarray(masks), K=K, interpret=True, return_cid=True)]
    got = [t.numpy() for t in cc.base_stats(torch.from_numpy(masks), K=K,
                                            return_cid=True)]
    _stats_close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("conn", [4, 8])
def test_connected_components_matches_pallas(ucls, conn):
    import jax.numpy as jnp

    from mfcnet_tpu.ops.cc_pallas import connected_components_pallas
    from mfcnet_tpu_torch.ops import cc

    masks = np.concatenate([ucls > 0, ucls == 0, ucls == 2])
    want = np.asarray(connected_components_pallas(
        jnp.asarray(masks), connectivity=conn, interpret=True))
    got = cc.connected_components(torch.from_numpy(masks), conn).numpy()
    np.testing.assert_array_equal(got, want)


def test_exact_sums_are_integer_planes(ucls):
    """Rows 2..4 are sums of multiples of 1/2 and row 5 is class x count:
    with int64 accumulation they are exact."""
    from mfcnet_tpu_torch.ops import cc

    stats, ccls, ncomp, _, _ = cc.union_stats(torch.from_numpy(ucls[:1]), K)
    s = stats[0].double()
    assert torch.equal(s[2:5] * 2, torch.round(s[2:5] * 2))
    n = int(ncomp[0])
    assert torch.equal(s[5, :n], s[0, :n] * ccls[0, :n].double())


def test_wrappers_route_cpu_to_plain_and_check_inputs(ucls):
    from mfcnet_tpu_torch.ops import cc

    cc.reset_launches()
    u = torch.from_numpy(ucls)
    got = cc.union_flood_cc_cid(u, K)
    want = cc.union_flood_cc_cid_plain(u, K)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(v == 0 for v in cc.LAUNCHES.values())  # no kernel on CPU
    with pytest.raises(TypeError):
        cc.union_flood_cc_cid(u.to(torch.int32), K)
    with pytest.raises(ValueError):
        cc.connected_components(u[0] > 0, 8)  # 2-D
    with pytest.raises(ValueError):
        cc.connected_components((u > 0).to("meta"), 8)
    with pytest.raises(ValueError):
        cc.onehot_stats(*got[:3], K=cc.MAX_K + 1)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(ucls):
    """Each CUDA kernel against its plain version on the card (run by
    ``python -m pytest tests/test_torch_cc.py -m cuda`` on a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.ops import cc

    u = torch.from_numpy(ucls).cuda()
    cc.reset_launches()
    got = cc.union_flood_cc_cid(u, K)
    want = cc.union_flood_cc_cid_plain(u, K)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cid, he, cide = got[:3]
    assert all(torch.equal(g, w) for g, w in zip(
        cc.onehot_stats(cid, he, cide, K),
        cc.onehot_stats_plain(cid, he, cide, K)))
    masks = torch.stack([u == c for c in (1, 2, 3, 4)], 1).reshape(-1, H, W)
    masks = masks.contiguous()
    assert all(torch.equal(g, w) for g, w in zip(
        cc.flood_cc_cid(masks, K), cc.flood_cc_cid_plain(masks, K)))
    for conn in (4, 8):
        assert torch.equal(cc.connected_components(masks, conn),
                           cc.connected_components_plain(masks, conn))
    torch.cuda.synchronize()
    assert all(v > 0 for v in cc.LAUNCHES.values())
    # every cc.cu kernel (one cooperative launch each) on ragged sizes,
    # B = 1, 4, 8 and 60,000, uniform frames, a serpentine and a
    # checkerboard (cc_labels 4- and 8-connected, onehot_stats on both
    # tiers' inputs); in CUDA-graph replays; no launch with another plan
    from chip_smoke import (_replay_equals, check_cc_kernels,
                            check_plan_refusals, flood_check_maps)

    for name, m in flood_check_maps():
        check_cc_kernels(torch.from_numpy(m).cuda(), name)
    cid, filled = cc.flood_cc_cid(masks, K)[:2]
    for fn in (lambda: cc.union_flood_cc_cid(u, K),
               lambda: cc.flood_cc_cid(masks, K),
               lambda: (cc.connected_components((~masks).contiguous(), 4),),
               lambda: (cc.connected_components(filled.bool(), 8),),
               lambda: cc.onehot_stats(*got[:3], K),
               lambda: cc.onehot_stats(cid, filled * 8, None, K)):
        assert _replay_equals(fn)
    check_plan_refusals(torch.device("cuda"))
