"""The port's device keypoint decode on the CPU (its kernels' plain
versions) against the JAX package's decode: the union path with the
Pallas kernels in interpret mode (``_decode_keypoints_union(...,
interpret=True)``) and the XLA path (``_decode_keypoints_xla``). Rows
must be equal."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H, W = 48, 64


def _frames():
    """(name, pred) class maps in the model's class ids (1 r-base,
    2 r-tip, 3 l-base, 4 l-tip)."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(2):
        pred = np.zeros((H, W), np.int32)
        for cls in (1, 2, 3, 4):
            for _ in range(rng.integers(1, 4)):
                cy, cx = rng.integers(4, H - 10), rng.integers(4, W - 10)
                h, w = rng.integers(2, 10), rng.integers(2, 10)
                pred[cy:cy + h, cx:cx + w] = cls
        out.append((f"random{i}", pred))
    pred = np.zeros((H, W), np.int32)
    pred[10:26, 10:26] = 3
    pred[14:22, 14:22] = 0
    pred[16:20, 16:20] = 1
    pred[8:30, 34:58] = 4
    pred[14:20, 40:46] = 2
    pred[34:44, 6:18] = 1
    out.append(("contained", pred))
    pred = np.zeros((H, W), np.int32)
    pred[8:32, 30:54] = 2
    pred[12:28, 34:50] = 0
    pred[14:26, 36:48] = 4
    pred[18:22, 40:44] = 0
    pred[36:46, 4:20] = 1
    out.append(("conflict", pred))
    return out


def _jax_inputs(pred, probs):
    import jax.numpy as jnp

    predj = jnp.asarray(pred)
    masks4 = jnp.stack([predj == 3, predj == 1, predj == 4, predj == 2],
                       axis=-3)
    heats = jnp.stack([probs[..., 4], probs[..., 2]], axis=-3)
    return predj, masks4, heats


@pytest.mark.parametrize("idx", range(4))
def test_decode_matches_jax_union_and_xla(idx):
    from mfcnet_tpu.track.decode_device import (
        _decode_keypoints_union,
        _decode_keypoints_xla,
    )
    from mfcnet_tpu_torch.track import decode_device as dd

    name, pred = _frames()[idx]
    probs = np.random.default_rng(idx).random((H, W, 5)).astype(np.float32)
    predj, masks4, heats = _jax_inputs(pred, probs)
    want_union = np.asarray(_decode_keypoints_union(
        predj, masks4, heats, 10.0, interpret=True))
    want_xla = np.asarray(_decode_keypoints_xla(masks4, heats, 10.0))
    dd.reset_tier_counts()
    got = dd.decode_keypoints_device(
        torch.from_numpy(probs), 100, pred=torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(got, want_union)
    np.testing.assert_array_equal(got, want_xla)
    tier = "per_blob" if name == "conflict" else "union"
    assert dd.TIER_COUNTS[tier] == 1, (name, dd.TIER_COUNTS)


def test_overflow_takes_exact_tier_and_matches_xla():
    """> K components in one blob: union -> per-blob -> exact tier."""
    from mfcnet_tpu.track.decode_device import _decode_keypoints_xla
    from mfcnet_tpu_torch.track import decode_device as dd

    h, w = 80, 96
    pred = np.zeros((h, w), np.int32)
    pred[::3, ::3] = 4                 # 864 isolated l-tip specks
    pred[40:60, 10:40] = 3
    pred[5:20, 60:90] = 1
    rng = np.random.default_rng(3)
    probs = rng.random((h, w, 5)).astype(np.float32)
    _, masks4, heats = _jax_inputs(pred, probs)
    dd.reset_tier_counts()
    got = dd.decode_keypoints_device(
        torch.from_numpy(probs), 100, pred=torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_decode_keypoints_xla(masks4, heats, 10.0)))
    assert dd.TIER_COUNTS == {"union": 0, "per_blob": 0, "exact": 1}


def test_argmax_and_batched_decode_match_xla():
    """pred=None decodes argmax(probs); leading dims decode together."""
    import jax.numpy as jnp

    from mfcnet_tpu.track.decode_device import decode_keypoints_device
    from mfcnet_tpu_torch.track import decode_device as dd

    rng = np.random.default_rng(7)
    probs = np.zeros((3, H, W, 5), np.float32)
    probs[..., 0] = 0.4
    for b in range(3):
        probs[b, 10 + b:22 + b, 8:30, 2] = 0.9
        probs[b, 30:44, 30 - b:50, 3] = 0.9
        probs[b, 5:15, 40:55 + b, 4] = 0.8
    probs += rng.uniform(0, 0.05, probs.shape).astype(np.float32)
    want = np.asarray(decode_keypoints_device(jnp.asarray(probs), 100))
    got = dd.decode_keypoints_device(torch.from_numpy(probs), 100).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_ties_resolve_to_lowest_index():
    import jax

    from mfcnet_tpu_torch.track.decode_device import topk_lowest_index

    v = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, 0.0],
                  [-np.inf] * 7], np.float32)
    for k in (2, 3, 5):
        wv, wi = jax.lax.top_k(v, k)
        gv, gi = topk_lowest_index(torch.from_numpy(v), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_peaks_match_jax():
    import jax.numpy as jnp

    from mfcnet_tpu.ops import peaks as jp
    from mfcnet_tpu_torch.ops import peaks as tp

    x = np.random.default_rng(0).random((2, H, W)).astype(np.float32)
    sm_j = np.asarray(jp.gaussian_blur(jnp.asarray(x)))
    sm_t = tp.gaussian_blur(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(sm_t, sm_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tp.local_maxima(torch.tensor(sm_j)).numpy(),
        np.asarray(jp.local_maxima(jnp.asarray(sm_j))))


def _contour_masks(rng, n):
    """0/255 masks of 1..40 pixels a side: noise, smooth blobs, rings,
    discs with holes and things in them, grids of thin lines."""
    from scipy import ndimage

    for _ in range(n):
        h, w = rng.integers(1, 41, 2)
        kind = rng.integers(0, 5)
        if kind == 0:
            m = rng.random((h, w)) < rng.random()
        elif kind == 1:
            m = ndimage.gaussian_filter(rng.random((h, w)),
                                        rng.uniform(0.5, 3)) > 0.5
        elif kind == 2:
            m = ndimage.binary_dilation(rng.random((h, w)) < 0.05,
                                        iterations=int(rng.integers(1, 4)))
            m ^= rng.random((h, w)) < 0.1
        elif kind == 3:
            m = np.zeros((h, w), bool)
            yy, xx = np.ogrid[:h, :w]
            for _ in range(rng.integers(1, 5)):
                d = (yy - rng.integers(0, h)) ** 2 + (xx - rng.integers(0, w)) ** 2
                r = int(rng.integers(1, 8))
                m ^= d <= r * r
        else:
            m = np.zeros((h, w), bool)
            m[rng.integers(0, h, 3), :] = True
            m[:, rng.integers(0, w, 2)] = True
            m ^= rng.random((h, w)) < 0.2
        yield (255 * m).astype(np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_scipy_contours_equal_opencv_and_jax(seed):
    """The host decode's contour functions, on OpenCV and on their scipy
    twin (``opencv=False``, the tie re-decode's), against the JAX
    package's on the same masks: equal centroids, first vertices of
    degenerate contours, area gates and refined masks, ties in area
    included."""
    from mfcnet_tpu.track import decode as jd
    from mfcnet_tpu_torch.track import decode as pd

    rng = np.random.default_rng(seed)
    for mask in _contour_masks(rng, 300):
        thr = float(rng.choice([0.0, 0.5, 1.0, 3.0, 10.0]))
        want = ([[int(v) for v in c] for c in jd.calc_centroids(mask)],
                jd.calc_base_centroid(mask, thr),
                jd.refine_tip_segmentation(mask.copy(), thr))
        for opencv in (True, False):
            got = ([[int(v) for v in c]
                    for c in pd.calc_centroids(mask, opencv)],
                   pd.calc_base_centroid(mask, thr, opencv),
                   pd.refine_tip_segmentation(mask, thr, opencv))
            assert got[:2] == want[:2], (opencv, mask.shape)
            np.testing.assert_array_equal(got[2], want[2])
