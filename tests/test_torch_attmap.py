"""TAPNet's attention-map pipeline in the port against the JAX package's,
on the CPU: ``data/attmap.py``'s three forms (the numpy reference, the
exact torch scatter, the warp-and-dilate approximation) against
``mfcnet_tpu/data/attmap.py``; the loaders (``load_attmap``,
``load_optflow_map``) and ``SingleFrameDataset(with_attmap=True)``, with
and without precomputed flow, against the JAX package's on one image tree
written with OpenCV; and, on a card, the scatter and the approximation
through the flow-warp kernel.

Tolerances: the scatter and the numpy form bit for bit (the reference's
assignment, collisions and flow off the border included);
``cal_attmap_batched`` within 1e-6 of JAX's (float32 bilinear weights of
the same coordinates, formed in another order); the datasets' samples
equal."""

import numpy as np
import pytest
import torch

H, W = 48, 56


def _cases():
    """(attmap, flow) pairs: random values under small and large random
    flows (collisions, targets clipped to the border), flows at exact
    halves (round half to even), and flows whose float32 sum with the
    grid rounds up a half where the float64 sum does not."""
    rng = np.random.default_rng(3)
    out = []
    for amp in (3.0, 25.0):
        for _ in range(2):
            att = rng.random((H, W)).astype(np.float32)
            flow = ((rng.random((H, W, 2)) * 2 - 1) * amp).astype(np.float32)
            out.append((att, flow))
    att = rng.random((H, W)).astype(np.float32)
    halves = rng.integers(-6, 7, (H, W, 2)).astype(np.float32) + 0.5
    out.append((att, halves))
    near = np.full((H, W, 2), np.float32(0.49999997))
    near[..., 0] *= -1
    out.append((att, near))
    return out


def test_scatter_equals_the_jax_numpy_reference_bit_for_bit():
    from mfcnet_tpu.data.attmap import cal_attmap_np as jax_np
    from mfcnet_tpu_torch.data.attmap import cal_attmap_np, cal_attmap_scatter

    cases = _cases()
    atts = torch.from_numpy(np.stack([a for a, _ in cases]))
    flows = torch.from_numpy(np.stack([f for _, f in cases]))
    got = cal_attmap_scatter(atts, flows).numpy()
    assert got.dtype == np.float32
    for i, (att, flow) in enumerate(cases):
        want = jax_np(att, flow)
        np.testing.assert_array_equal(got[i], want, err_msg=str(i))
        np.testing.assert_array_equal(cal_attmap_np(att, flow), want)
    # the last case: a float32 sum with the grid rounds odd rows the other
    # way; the float64 targets keep the reference's
    ys = np.arange(H)[:, None]
    flow = cases[-1][1][..., 1]
    assert (np.rint(ys.astype(np.float32) + flow)
            != np.rint(ys + flow.astype(np.float64))).any()


def test_scatter_keeps_the_last_writer_and_clips_to_the_border():
    """Two sources on one target: the later one in row-major order wins;
    a source pushed past the edge lands on the edge."""
    from mfcnet_tpu_torch.data.attmap import cal_attmap_scatter

    att = torch.zeros(1, 20, 20)
    att[0, 5, 5], att[0, 5, 7] = 0.25, 0.75
    flow = torch.zeros(1, 20, 20, 2)
    flow[0, 5, 5, 0] = 2.0   # (5, 5) -> (5, 7), before (5, 7) itself
    flow[0, 9, 3, 0] = -40.0
    att[0, 9, 3] = 0.5       # -> (9, 0)
    out = cal_attmap_scatter(att, flow)
    # the window of output (i, j) is rows i-4..i+5, columns j-4..j+5
    assert out[0, 5, 7] == 0.75  # the first writer's 0.25 lost
    assert out[0, 9, 0] == 0.5   # clipped, not dropped
    assert out[0, 19, 19] == 0.0


def test_batched_matches_jax():
    import jax.numpy as jnp

    from mfcnet_tpu.data.attmap import cal_attmap_batched as jax_batched
    from mfcnet_tpu_torch.data.attmap import cal_attmap_batched

    y, x = np.mgrid[:H, :W]
    atts, flows = [], []
    for cy, cx, s, fx, fy in ((20, 25, 5.0, 3.0, -2.0),
                              (40, 50, 8.0, -5.5, 4.2),
                              (30, 40, 6.0, 0.0, 0.0)):
        atts.append(np.exp(-((x - cx) ** 2 + (y - cy) ** 2)
                           / (2 * s ** 2)).astype(np.float32))
        flows.append(np.stack([fx + 1.5 * np.sin(y / 15.0),
                               fy + 1.5 * np.cos(x / 20.0)],
                              axis=-1).astype(np.float32))
    atts, flows = np.stack(atts), np.stack(flows)
    want = np.asarray(jax_batched(jnp.asarray(atts), jnp.asarray(flows)))
    got = cal_attmap_batched(torch.from_numpy(atts),
                             torch.from_numpy(flows)).numpy()
    assert got.shape == want.shape == (3, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _tree(root, with_flow):
    """(The path must not hold 'frame', 'images' or 'jpg': the loaders
    replace them in the whole path, as the reference does.) A JIGSAWS-like
    tree of 2 videos x 3 frames at 32x40, each frame's
    ``attmaps/`` PNG and, ``with_flow``, its raw float32 ``.flo`` (two
    header floats, as the reference reads them)."""
    import cv2

    from mfcnet_tpu_torch.data.files import get_dataset_filenames
    from mfcnet_tpu_torch.data.synthetic import make_jigsaws_like_dataset

    make_jigsaws_like_dataset(root, num_videos=2, frames_per_video=3,
                              height=32, width=40, seed=1,
                              splits=("annotations_train",))
    files, _ = get_dataset_filenames("JIGSAWS", root, "training")
    rng = np.random.default_rng(2)
    for f in files:
        p = str(f).replace("images", "attmaps").replace("jpg", "png")
        (f.parent.parent / "attmaps").mkdir(exist_ok=True)
        cv2.imwrite(p, rng.integers(0, 256, (32, 40), dtype=np.uint8))
        if with_flow:
            (f.parent.parent / "flows").mkdir(exist_ok=True)
            flo = np.concatenate([[np.float32(202021.25), np.float32(0)],
                                  rng.normal(0, 3, 32 * 40 * 2)])
            flo.astype(np.float32).tofile(
                str(f).replace("images", "flows").replace("jpg", "flo"))
    return files


@pytest.mark.parametrize("with_flow", [False, True])
def test_single_frame_dataset_matches_jax(tmp_path_factory, with_flow):
    """Every sample of ``SingleFrameDataset(with_attmap=True)`` equals the
    JAX dataset's: the image, the mask and the attention map (zeros at a
    video's first frame, the previous frame's PNG / 255 else, carried
    along the frame's flow and dilated with ``optflow_dir``)."""
    from mfcnet_tpu.data.dataset import SingleFrameDataset as JDataset
    from mfcnet_tpu_torch.data.dataset import SingleFrameDataset

    files = _tree(tmp_path_factory.mktemp("tree"), with_flow)
    kw = dict(with_attmap=True, frames_per_video=3,
              optflow_dir="flows" if with_flow else None,
              attmap_shape=(32, 40))
    want = JDataset(files, "toolpose_segmentation", **kw)
    got = SingleFrameDataset(files, "toolpose_segmentation", **kw)
    assert len(got) == len(want) == 6
    for i in range(6):
        a, b = got[i], want[i]
        assert set(a) == set(b) == {"image", "mask", "attmap"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    assert not got[0]["attmap"].any() and got[4]["attmap"].any()


def test_loaders_match_jax_and_name_a_missing_map(tmp_path_factory):
    from mfcnet_tpu.data.masks import load_attmap as jax_attmap
    from mfcnet_tpu.data.masks import load_optflow_map as jax_flow
    from mfcnet_tpu_torch.data.masks import load_attmap, load_optflow_map

    files = _tree(tmp_path_factory.mktemp("tree"), True)
    for i in range(6):
        np.testing.assert_array_equal(load_attmap(files, i, 3, (32, 40)),
                                      jax_attmap(files, i, 3, (32, 40)))
        np.testing.assert_array_equal(
            load_optflow_map(files[i], "flows", (32, 40)),
            jax_flow(files[i], "flows", (32, 40)))
    missing = str(files[3]).replace("images", "attmaps").replace("jpg", "png")
    import os

    os.remove(missing)
    with pytest.raises(FileNotFoundError, match="frame_0000.png"):
        load_attmap(files, 4, 3, (32, 40))


@pytest.mark.cuda
def test_cuda_attmaps_through_the_kernel():
    """On the card: the scatter equals the numpy reference bit for bit at
    480x640, and the approximation through ``mfc_flow_warp`` is within
    2e-6 of its plain route (float32 warp: bit-equal, ``chip_smoke.py``'s
    WARP_ATOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.data.attmap import (
        cal_attmap_batched,
        cal_attmap_np,
        cal_attmap_scatter,
        max_filter_10,
    )
    from mfcnet_tpu_torch.ops import warp

    rng = np.random.default_rng(0)
    att = rng.random((2, 480, 640)).astype(np.float32)
    flow = (rng.standard_normal((2, 480, 640, 2)) * 8).astype(np.float32)
    ta, tf = torch.from_numpy(att).cuda(), torch.from_numpy(flow).cuda()
    got = cal_attmap_scatter(ta, tf).cpu().numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], cal_attmap_np(att[i], flow[i]))
    warp.reset_launches()
    kern = cal_attmap_batched(ta, tf)
    assert warp.LAUNCHES["flow_warp"] == 1
    plain = max_filter_10(warp.flow_warp_plain(
        ta[:, None], -tf.permute(0, 3, 1, 2))[:, 0])
    torch.testing.assert_close(kern, plain, rtol=0, atol=2e-6)
