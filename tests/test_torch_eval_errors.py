"""The port's evaluation layer against the JAX package's, numpy in and out
(no model): ``track/errors.py``'s centroid errors for 3, 5 and 11
classes, ``track/errors_v1.py``'s legacy decode, ``track/infer_eval.py``'s
presence statistics, ``nanmean_std``, overlays and the whole
``evaluate_testset`` on a fake loader and a fixed eval step, and
``utils/vis.py::draw_plus``.

The inputs: crafted class maps (an empty map, one blob a class, three and
more blobs a class of different sizes, two tip discs whose heats tie,
one-pixel blobs whose contours are degenerate, ground truth with nothing
predicted) and seeded random probabilities, all from numpy seeds. Both
packages run the same OpenCV and scipy calls on the same arrays, so
every result is equal, NaN in the same places, and the PNGs byte for
byte."""

import logging

import numpy as np
import pytest

from torch_threads import _two_torch_threads  # noqa: F401

H, W = 48, 56
CLASSES = (3, 5, 11)
CASES = ("empty", "missed", "one_blob", "many_blobs", "tip_tie", "one_pixel",
         "random")


def _blob(m, y, x, h, w, cls):
    m[y:y + h, x:x + w] = cls


def _disc(m, cy, cx, r, cls):
    yy, xx = np.ogrid[:m.shape[0], :m.shape[1]]
    m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = cls


def class_maps(case, n_classes, seed=0):
    """(pred, gt) (H, W) int class maps of a crafted case."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((H, W), np.int64)
    gt = np.zeros((H, W), np.int64)
    fg = range(1, n_classes)
    if case == "empty":
        return pred, gt
    if case in ("missed", "one_blob"):
        for i, cls in enumerate(fg):
            y, x = 2 + (i % 5) * 9, 2 + (i // 5) * 26
            _blob(gt, y, x, 6, 7 + i % 3, cls)
            if case == "one_blob":
                _blob(pred, y + 1, x + 1, 6, 6 + i % 4, cls)
        return pred, gt
    if case == "many_blobs":
        for m, off in ((pred, 0), (gt, 1)):
            for i, cls in enumerate(fg):
                for j, (h, w) in enumerate(((5, 4), (3, 3), (2, 6), (4, 2))):
                    y = 1 + ((i * 4 + j) * 7) % (H - 7)
                    x = 1 + ((i * 11 + j * 13 + off) % (W - 8))
                    _blob(m, y, x, h, w, cls)
        return pred, gt
    if case == "tip_tie":
        # two equal discs a class, side by side: equal smoothed peaks
        for i, cls in enumerate(fg):
            cy = 4 + (i % 5) * 9
            cx = 6 + (i // 5) * 26
            for m in (pred, gt):
                _disc(m, cy, cx, 2, cls)
                _disc(m, cy, cx + 12, 2, cls)
        return pred, gt
    if case == "one_pixel":
        for i, cls in enumerate(fg):
            pred[3 + 4 * i, 5 + 3 * i] = cls
            gt[3 + 4 * i, 6 + 3 * i] = cls
            gt[20 + 2 * i, 40] = cls
        return pred, gt
    assert case == "random"
    gt = rng.integers(0, n_classes, (H // 4, W // 4)).repeat(4, 0).repeat(4, 1)
    return None, gt


def probabilities(case, n_classes, seed=0):
    """float32 (H, W, C) probabilities of a case and its ground truth: a
    softmax of one-hot logits of the predicted map (no noise for the tie
    case, whose heats must tie), or of seeded random logits."""
    rng = np.random.default_rng(seed + 17)
    pred, gt = class_maps(case, n_classes, seed)
    if pred is None:
        logits = rng.normal(0.0, 3.0, (H, W, n_classes))
    else:
        logits = 4.0 * np.eye(n_classes)[pred]
        if case != "tip_tie":
            logits = logits + rng.normal(0.0, 0.5, logits.shape)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32), gt


def assert_same(got, want, where="result"):
    """Nested tuples and lists of numbers: the same structure, every
    number equal or both NaN."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), where
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
        return
    g, w = float(got), float(want)
    assert (np.isnan(g) and np.isnan(w)) or g == w, f"{where}: {g} != {w}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_centroid_error_matches_jax(n_classes, case):
    from mfcnet_tpu.track.errors import centroid_error as jerr
    from mfcnet_tpu_torch.track.errors import centroid_error

    probs, gt = probabilities(case, n_classes)
    want = jerr(probs, gt, n_classes)
    assert_same(centroid_error(probs, gt, n_classes), want)
    if case == "one_blob":  # the crafted blobs are found
        flags = want[-3] if n_classes == 11 else want[-4]
        assert all(flags)


def test_centroid_error_refuses_other_class_counts():
    from mfcnet_tpu_torch.track.errors import centroid_error

    probs, gt = probabilities("one_blob", 4)
    with pytest.raises(ValueError, match="3, 5, or 11"):
        centroid_error(probs, gt, 4)


@pytest.mark.parametrize("case", CASES)
def test_centroid_error_v1_matches_jax(case):
    from mfcnet_tpu.track.errors_v1 import centroid_error_v1 as jerr
    from mfcnet_tpu_torch.track.errors_v1 import centroid_error_v1

    probs, gt = probabilities(case, 5, seed=1)
    assert_same(centroid_error_v1(probs, gt), jerr(probs, gt))


def test_centroid_error_v1_weighted_decode_case():
    """The JAX package's own v1 case (``tests/test_legacy_models.py``)."""
    from mfcnet_tpu.track.errors_v1 import centroid_error_v1 as jerr
    from mfcnet_tpu_torch.track.errors_v1 import centroid_error_v1

    probs = np.zeros((64, 64, 5), np.float32)
    probs[..., 0] = 0.9
    probs[10:16, 10:16, 2] = 0.95
    probs[30:40, 10:20, 1] = 0.95
    gt = np.zeros((64, 64), np.int64)
    gt[10:16, 10:16] = 2
    gt[30:40, 10:20] = 1
    got = centroid_error_v1(probs, gt)
    assert_same(got, jerr(probs, gt))
    assert got[0] < 2.0 and got[1] < 2.0 and np.isnan(got[2])


def test_presence_stats_and_nanmean_std_match_jax():
    from mfcnet_tpu.track import infer_eval as jev
    from mfcnet_tpu_torch.track import infer_eval as pev

    rng = np.random.default_rng(5)
    stats = {m: m.PresenceStats(10) for m in (jev, pev)}
    for _ in range(40):
        g, p = rng.random(10) < 0.6, rng.random(10) < 0.5
        for s in stats.values():
            s.update(list(g), list(p))
    for a, b in zip(stats[pev].summary(), stats[jev].summary()):
        np.testing.assert_array_equal(a, b)
    for values in ([], [np.nan, np.nan], [1.0, np.nan, 3.5],
                   list(rng.normal(size=9)), [2.0]):
        assert_same(pev.nanmean_std(values), jev.nanmean_std(values))


def test_draw_plus_and_save_overlay_write_equal_pngs(tmp_path):
    import cv2

    from mfcnet_tpu.track.infer_eval import save_overlay as jsave
    from mfcnet_tpu.utils.vis import draw_plus as jplus
    from mfcnet_tpu_torch.track.infer_eval import save_overlay
    from mfcnet_tpu_torch.utils.vis import draw_plus

    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    for center in ((10, 12), (0.5, 47.9), (np.nan, 3), (55, 2)):
        a = draw_plus(img.copy(), center, color=(9, 200, 30), size=4)
        b = jplus(img.copy(), center, color=(9, 200, 30), size=4)
        np.testing.assert_array_equal(a, b)
        cv2.imwrite(str(tmp_path / "p.png"), a)
        cv2.imwrite(str(tmp_path / "j.png"), b)
        assert ((tmp_path / "p.png").read_bytes()
                == (tmp_path / "j.png").read_bytes())
    for n_classes in CLASSES:
        probs, gt = probabilities("many_blobs", n_classes)
        c_pred = [[3.0, np.nan], [40.0, 7.0], [np.nan], [np.nan],
                  [20.0], [30.0]]
        image = rng.uniform(0, 255, (H, W, 3))
        save_overlay(tmp_path / "port", n_classes, image, probs.argmax(-1),
                     c_pred, n_classes)
        jsave(tmp_path / "jax", n_classes, image, probs.argmax(-1), c_pred,
              n_classes)
        name = f"output_{n_classes:05d}.png"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def _fake_samples(n_classes, n=5):
    """Raw loader items and a fixed eval step over them: the step returns
    each sample's log-probabilities and per-class IoU/Dice as numpy, as
    a device step's outputs would be fetched."""
    rng = np.random.default_rng(n_classes)
    cases = ("one_blob", "many_blobs", "empty", "random", "tip_tie",
             "one_pixel", "missed")
    raw, out = [], {}
    for i in range(n):
        probs, gt = probabilities(cases[i % len(cases)], n_classes, seed=i)
        image = rng.standard_normal((1, H, W, 3)).astype(np.float32)
        raw.append({"image": image, "mask": gt[None], "i": i})
        iou = rng.random((1, n_classes - 1)).astype(np.float32)
        dice = rng.random((1, n_classes - 1)).astype(np.float32)
        out[i] = (np.log(probs)[None], {"iou_per_class": iou,
                                        "dice_per_class": dice})

    def eval_step(state, batch):
        return out[batch["i"]]

    return raw, eval_step


@pytest.mark.parametrize("n_classes", CLASSES)
def test_evaluate_testset_matches_jax(tmp_path, n_classes):
    """The same fake loader and eval step through both evaluators: the same
    results dict (keys in the same order) and the same overlays."""
    from mfcnet_tpu.track.infer_eval import evaluate_testset as jeval
    from mfcnet_tpu_torch.track.infer_eval import evaluate_testset

    raw, step = _fake_samples(n_classes)
    logger = logging.getLogger("test_torch_eval_errors")
    res = {}
    for name, fn in (("port", evaluate_testset), ("jax", jeval)):
        res[name] = fn(raw, None, step, lambda b: b, n_classes, logger,
                       out_dir=tmp_path / name, save_output_freq=2)
    assert list(res["port"]) == list(res["jax"])
    for k, v in res["jax"].items():
        assert_same(res["port"][k], v, k)
    pngs = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert pngs == ["output_00000.png", "output_00002.png",
                    "output_00004.png"]
    for name in pngs:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_evaluate_testset_refuses_an_empty_loader():
    from mfcnet_tpu_torch.track.infer_eval import evaluate_testset

    with pytest.raises(ValueError, match="no samples"):
        evaluate_testset([], None, None, lambda b: b, 5,
                         logging.getLogger("test_torch_eval_errors"))


def test_host_half_needs_cv2_and_names_it(monkeypatch):
    """Without OpenCV the host half raises an ImportError naming cv2; it
    does not skip the centroid errors."""
    import sys

    from mfcnet_tpu_torch.track.infer_eval import host_half

    probs, gt = probabilities("one_blob", 5)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        host_half(np.log(probs), gt, 5)
