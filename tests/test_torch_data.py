"""The port's data layer against the JAX package's on the CPU: the
augmentation ops and the whole per-sample augmentation with the JAX
draws handed over (the two random streams differ by nature), the eval
preprocessing, the file loaders and packs in both directions, the
loader's sample order and the synthetic generator.

Tolerances: rotation, flips, nearest resizes, masks and packed bytes
exact; depth maps one float32 rounding (XLA takes u8 / 255 as a product
with the reciprocal); colour ops 1e-6 (float32 sums in another order); frames
after bilinear resize and normalization 1e-5 (the resize's 1e-6 over
the ImageNet std of ~0.22)."""

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


T = 3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), -3, -1)


@pytest.mark.parametrize("angle", [-15, -8, 0, 7, 14])
def test_rotate_nearest_matches_jax(angle):
    from mfcnet_tpu.ops.rotate import rotate_nearest as jrot
    from mfcnet_tpu_torch.ops.rotate import rotate_nearest

    img = np.random.default_rng(angle + 20).random((37, 52, 3), np.float32)
    want = np.asarray(jrot(img, float(angle)))
    got = rotate_nearest(_nchw(img)[None], torch.tensor([float(angle)]))[0]
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast",
                                "adjust_saturation"])
def test_color_ops_match_jax(op):
    from mfcnet_tpu.ops import color as jcolor
    from mfcnet_tpu_torch.ops import color

    rng = np.random.default_rng(4)
    img = rng.random((4, 20, 24, 3), np.float32)
    f = rng.uniform(0.9, 1.1, (4, 1, 1, 1)).astype(np.float32)
    want = np.asarray(getattr(jcolor, op)(img, f))
    got = getattr(color, op)(_nchw(img), torch.from_numpy(f))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


def test_flip_tables_are_byte_equal():
    from mfcnet_tpu.data import transforms as jt
    from mfcnet_tpu_torch.data import transforms as pt

    for task in ("tooltip_segmentation", "toolpose_segmentation",
                 "endovis15_segmentation", "binary"):
        assert jt._hflip_table(task, 5).tobytes() == \
            pt._hflip_table(task, 5).tobytes()
        assert jt._vflip_table(task).tobytes() == pt._vflip_table(task).tobytes()


def _raw_batch(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.integers(0, 256, (B, T, H, W, 3), dtype=np.uint8),
            "mask": rng.integers(0, 5, (B, H, W), dtype=np.uint8),
            "depth": rng.integers(0, 256, (B, T, H, W), dtype=np.uint8)}


def _jax_draws(key, B, cfg):
    """The draws of mfcnet_tpu/data/transforms.py::_augment_one, from the
    same key splits."""
    import jax

    out = {k: [] for k in ("angle", "jitter", "factors", "vflip", "hflip")}
    for k in jax.random.split(key, B):
        k_rot, k_jit, k_jitf, k_vf, k_hf = jax.random.split(k, 5)
        out["angle"].append(int(jax.random.randint(
            k_rot, (), cfg.rotate_lo, cfg.rotate_hi)))
        out["jitter"].append(bool(jax.random.bernoulli(k_jit, cfg.jitter_p)))
        out["factors"].append(np.asarray(jax.random.uniform(
            k_jitf, (T, 3), minval=0.95, maxval=1.05)))
        out["vflip"].append(bool(jax.random.bernoulli(k_vf, cfg.flip_p)))
        out["hflip"].append(bool(jax.random.bernoulli(k_hf, cfg.flip_p)))
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("task", ["toolpose_segmentation",
                                  "endovis15_segmentation"])
def test_augmentation_matches_jax_with_its_draws(task):
    """augment_train_batch (JAX) == apply_augmentation (port) given the
    JAX draws, on a batch whose draws take every branch (jitter and both
    flips on and off), with a resize."""
    import jax

    from mfcnet_tpu.data.transforms import TransformConfig as JCfg
    from mfcnet_tpu.data.transforms import augment_train_batch as jaug
    from mfcnet_tpu_torch.data.transforms import (
        TransformConfig,
        apply_augmentation,
    )

    B = 6
    batch = _raw_batch(B, 40, 44)
    key = jax.random.PRNGKey(3)
    want = jaug(batch, key, JCfg(out_height=32, out_width=48,
                                 prediction_task=task))
    cfg = TransformConfig(out_height=32, out_width=48, prediction_task=task)
    draws = _jax_draws(key, B, cfg)
    for k in ("jitter", "vflip", "hflip"):
        assert 0 < int(draws[k].sum()) < B, f"{k} takes one branch only"
    got = apply_augmentation(batch, draws, cfg)
    np.testing.assert_allclose(got["frames"].numpy(),
                               np.asarray(want["frames"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), rtol=1e-7, atol=0)


def test_eval_preprocessing_and_generator_draws():
    from mfcnet_tpu.data.transforms import TransformConfig as JCfg
    from mfcnet_tpu.data.transforms import preprocess_eval_batch as jprep
    from mfcnet_tpu_torch.data.transforms import (
        TransformConfig,
        augment_train_batch,
        draw_augmentation,
        preprocess_eval_batch,
    )

    batch = _raw_batch(2, 40, 44, seed=1)
    want = jprep(batch, JCfg(out_height=32, out_width=48))
    cfg = TransformConfig(out_height=32, out_width=48)
    got = preprocess_eval_batch(batch, cfg)
    np.testing.assert_allclose(got["frames"].numpy(),
                               np.asarray(want["frames"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), rtol=1e-7, atol=0)
    # the draws are a function of the generator's seed alone
    d1 = draw_augmentation(torch.Generator().manual_seed(5), 4, T, cfg)
    d2 = draw_augmentation(torch.Generator().manual_seed(5), 4, T, cfg)
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert ((d1["angle"] >= -15) & (d1["angle"] < 15)).all()
    assert ((d1["factors"] >= 0.95) & (d1["factors"] < 1.05)).all()
    a = augment_train_batch(batch, torch.Generator().manual_seed(5), cfg)
    assert a["frames"].shape == (2, T, 32, 48, 3)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """The JAX generator's JIGSAWS tree (OpenCV), with depth maps."""
    import cv2

    from mfcnet_tpu.data.synthetic import make_jigsaws_like_dataset

    root = make_jigsaws_like_dataset(
        tmp_path_factory.mktemp("tree"), num_videos=2, frames_per_video=4,
        height=32, width=48, seed=2)
    for img in root.rglob("images/*.jpg"):
        d = img.parent.parent / "depth_maps_depthanythingv2"
        d.mkdir(exist_ok=True)
        cv2.imwrite(str(d / img.name.replace("jpg", "png")),
                    cv2.imread(str(img)))
    return root


def _assert_same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("task", ["toolpose_segmentation",
                                  "tooltip_segmentation"])
def test_file_dataset_and_packs_match_jax_both_ways(image_tree, tmp_path,
                                                    task):
    """The port's file dataset == the JAX one; a pack written by either
    package reads the same samples in the other."""
    from mfcnet_tpu.data.dataset import MultiFrameDataset as JDS
    from mfcnet_tpu.data.files import get_dataset_filenames
    from mfcnet_tpu.data.packed import PackedMultiFrameDataset as JPacked
    from mfcnet_tpu.data.packed import pack_files as jpack
    from mfcnet_tpu_torch.data.dataset import MultiFrameDataset
    from mfcnet_tpu_torch.data.packed import (
        PackedMultiFrameDataset,
        pack_files,
    )

    files, _ = get_dataset_filenames("JIGSAWS", image_tree, "training")
    jds = JDS(files, task, T, add_depth_inputs=True)
    _assert_same_samples(MultiFrameDataset(files, task, T, True), jds)
    jpack(files, task, tmp_path / "j", add_depth_inputs=True)
    pack_files(files, task, tmp_path / "p", add_depth_inputs=True)
    assert (json_of(tmp_path / "j") == json_of(tmp_path / "p"))
    _assert_same_samples(PackedMultiFrameDataset(tmp_path / "j", T, True), jds)
    _assert_same_samples(JPacked(tmp_path / "p", T, True), jds)


def json_of(d):
    import json

    return json.loads((d / "index.json").read_text())


class _Index:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("n,batch,drop_last,epoch,skip", [
    (23, 4, False, 0, 0), (23, 4, True, 3, 2), (10, 3, False, 7, 1),
    (10, 3, False, None, 0)])
def test_loader_order_matches_jax(n, batch, drop_last, epoch, skip):
    from mfcnet_tpu.data.loader import DataLoader as JLoader
    from mfcnet_tpu_torch.data.loader import DataLoader

    def order(cls):
        dl = cls(_Index(n), batch, shuffle=True, num_workers=2, seed=11,
                 drop_last=drop_last)
        if epoch is not None:
            dl.set_epoch(epoch, skip)
        return [b["i"].tolist() for b in dl] + [b["i"].tolist() for b in dl]

    assert order(DataLoader) == order(JLoader)


def test_synthetic_pack_masks_compose_to_the_drawn_classes(tmp_path):
    """The generator's pose maps compose (data/masks.py) to the classes it
    drew; its pack reads in the JAX reader."""
    from mfcnet_tpu.data.packed import PackedMultiFrameDataset as JPacked
    from mfcnet_tpu_torch.data.masks import compose_mask
    from mfcnet_tpu_torch.data.synthetic import _video, make_synthetic_pack

    rng = np.random.default_rng(0)
    for img, pml, pmr, drawn, depth in _video(rng, 48, 64, 4):
        assert img.shape == (48, 64, 3) and depth.shape == (48, 64)
        np.testing.assert_array_equal(
            compose_mask(pml, pmr, "toolpose_segmentation"), drawn)
        assert set(np.unique(drawn)) == {0, 1, 2, 3, 4}
    root = make_synthetic_pack(tmp_path, videos=(("train", 2, 3),),
                               height=32, width=32, seed=1)
    ds = JPacked(root / "train", T, True,
                 expect={"dataset": "JIGSAWS", "fold_index": -1,
                         "prediction_task": "toolpose_segmentation"})
    s = ds[3]
    assert s["frames"].shape == (T, 32, 32, 3) and s["depth"].shape == (
        T, 32, 32)
    assert ds.window_indices(3) == [3, 3, 3]  # first frame of video 2
