"""The port's three infer CLIs against the JAX package's on the CPU, with
the flags of ``tests/test_cli_more.py``'s infer tests: a one-video,
four-frame JIGSAWS tree of 64x64 frames read at 32x32, ``--model_scale
0.1``. Both sides load the same weights: JAX variables filled from numpy
(``tests/test_torch_zoo_models.py::fill_like``) written as a flax
msgpack for the JAX CLI and carried through ``compat.from_jax`` into a
``.pth`` for the port's.

Tolerances: IoU and Dice per class within 1e-5 (both evaluate in float32;
the models' sums run in other orders); the presence lists equal; the
centroid errors equal, except where the two float32 argmaxes of a pixel
differ (a top-2 margin below 1e-5 of the log-probabilities), which moves
a contour's centroid: the test then holds the error within 1e-3 px and
says so. Also: the multi-frame CLI with the frozen RAFT provider in the
step (``--add_optflow_inputs True``, the same RAFT weights on both sides),
the overlays of ``--save_output_freq``, ``--pretrained True`` (a warning,
and the run goes on), the endovis15 wrapper's flags, and ``--device``
defaulting to the card.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

C, HW, SCALE = 5, 32, 0.1
IOU_TOL = 1e-5
ARGMAX_TIE = 1e-5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from mfcnet_tpu.data.synthetic import make_jigsaws_like_dataset

    return make_jigsaws_like_dataset(
        tmp_path_factory.mktemp("ds"), num_videos=1, frames_per_video=4,
        height=64, width=64)


def write_weights(out_dir, jax_model, init_args, port_model, seed,
                  **init_kwargs):
    """JAX variables of ``jax_model`` filled from numpy with ``seed``,
    written as a flax msgpack and, converted, as the port's ``.pth``;
    returns (msgpack path, .pth path)."""
    from flax import serialization

    from tests.test_torch_zoo_models import fill_like

    from mfcnet_tpu_torch.compat.from_jax import state_dict_from_jax

    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), *init_args, **init_kwargs))
    v = fill_like(shapes, seed)
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    msgpack = out_dir / f"w{seed}.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize(v))
    pth = out_dir / f"w{seed}.pth"
    torch.save({"model": state_dict_from_jax(v, port_model)}, pth)
    return msgpack, pth


def _common(dataset, out, name):
    return ["--data_dir", str(dataset), "--dataset", "JIGSAWS",
            "--expt_savedir", str(out), "--expt_name", name,
            "--num_workers", "1", "--input_height", str(HW),
            "--input_width", str(HW), "--model_scale", str(SCALE)]


def assert_results_match(got, want, n_kp, argmax_flips):
    """The port's results dict against the JAX CLI's (see the module
    docstring); ``argmax_flips``: whether the two float32 argmaxes
    differed on some pixel (then the centroid errors may move, within
    1e-3 px)."""
    assert list(got) == list(want)
    assert got["num_samples"] == want["num_samples"]
    for k in ("iou_per_class", "dice_per_class"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=IOU_TOL)
    for k in ("presence_precision", "presence_recall", "presence_accuracy"):
        assert got[k] == want[k], k
    errs = [f"err_{i}_{s}" for i in range(n_kp) for s in ("mean", "std")]
    g = np.array([got[k] for k in errs])
    w = np.array([want[k] for k in errs])
    if argmax_flips:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def recorded(monkeypatch):
    """Record the probabilities each package's evaluator hands its
    centroid decode: {"jax": [...], "port": [...]}."""
    from mfcnet_tpu.track import infer_eval as jev
    from mfcnet_tpu_torch.track import infer_eval as pev

    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jev), ("port", pev)):
        def rec(probs, gt, num_classes, _k=key, _f=mod.centroid_error):
            seen[_k].append(np.array(probs))
            return _f(probs, gt, num_classes)

        monkeypatch.setattr(mod, "centroid_error", rec)
    return seen


def argmax_flips(seen):
    """Whether the two packages' argmaxes differ on any pixel of any
    sample; a flip outside a near-tie (top-2 margin > ARGMAX_TIE of the
    probabilities) is a fault."""
    assert len(seen["jax"]) == len(seen["port"]) > 0
    flips = False
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
        diff = a.argmax(-1) != b.argmax(-1)
        top2 = np.sort(a, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > ARGMAX_TIE
        assert not (diff & clear).any(), "argmax differs outside a near-tie"
        flips |= bool(diff.any())
    return flips


def test_infer_toolpose_cli_matches_jax(dataset, tmp_path, caplog,
                                        recorded):
    """TernausNet16: results.json of both CLIs, overlays every 2nd sample,
    ``--pretrained True`` warns and runs."""
    from mfcnet_tpu.cli.infer_toolpose_segmentation import main as jmain
    from mfcnet_tpu.models import get_tooltip_segmentation_model as jget
    from mfcnet_tpu_torch.cli.infer_toolpose_segmentation import main
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    jm = jget("TernausNet16", C, scale=SCALE)
    pm = get_tooltip_segmentation_model("TernausNet16", C, scale=SCALE)
    x0 = np.zeros((1, HW, HW, 3), np.float32)
    msgpack, pth = write_weights(tmp_path, jm, (x0,), pm, seed=3)
    args = _common(dataset, tmp_path, "inf") + [
        "--model_type", "TernausNet16", "--save_output_freq", "2"]
    want = jmain(args + ["--load_wts_model", str(msgpack)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            main(args + ["--expt_name", "pinf", "--load_wts_model", str(pth)])
    with caplog.at_level(logging.WARNING):
        got = main(args + ["--expt_name", "pinf", "--load_wts_model",
                           str(pth), "--device", "cpu",
                           "--pretrained", "True"])
    assert "pretrained=True" in caplog.text
    saved = json.loads((tmp_path / "pinf" / "outputs" / "results.json")
                       .read_text())
    assert json.dumps(saved) == json.dumps(got)
    assert got["num_samples"] == 4 and len(got["presence_precision"]) == 4
    pngs = sorted(p.name for p in (tmp_path / "pinf" / "outputs").glob(
        "output_*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "inf" / "outputs")
                          .glob("output_*.png"))
    assert pngs == ["output_00000.png", "output_00002.png"]
    assert_results_match(got, want, 4, argmax_flips(recorded))


def test_infer_multiframe_cli_matches_jax(dataset, tmp_path, recorded):
    """TernausNetMulti-Basic without flow: results.json of both CLIs; no
    overlay with ``--save_output_freq 0``."""
    from mfcnet_tpu.cli.infer_multiframe_endovis15 import main as jmain
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu_torch.cli.infer_multiframe_endovis15 import main
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    jm = jget("TernausNetMulti-Basic", C, 3, scale=SCALE)
    pm = get_multiframe_segmentation_model("TernausNetMulti-Basic", C, 3,
                                           scale=SCALE)
    msgpack, pth = write_weights(
        tmp_path, jm, (np.zeros((1, 3, HW, HW, 3), np.float32),), pm, seed=4)
    args = _common(dataset, tmp_path, "mf") + [
        "--model_type", "TernausNetMulti-Basic", "--num_input_frames", "3",
        "--save_output_freq", "0"]
    want = jmain(args + ["--load_wts_model", str(msgpack)])
    got = main(args + ["--expt_name", "pmf", "--load_wts_model", str(pth),
                       "--device", "cpu"])
    assert got["num_samples"] == 4
    assert not list((tmp_path / "pmf" / "outputs").glob("*.png"))
    assert_results_match(got, want, 4, argmax_flips(recorded))


def test_infer_multiframe_cli_with_raft_matches_jax(dataset, tmp_path,
                                                    recorded):
    """``--add_optflow_inputs True``: RAFT x12 inside the eval step of both
    CLIs, on the same RAFT weights (a JAX init at the input size, as the
    JAX CLI's template; the port's torchvision-named ``.pth`` converted
    from it)."""
    from flax import serialization

    from mfcnet_tpu.cli.infer_multiframe_endovis15 import main as jmain
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu.models.raft import RAFT as JRAFT
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.cli.infer_multiframe_endovis15 import main
    from mfcnet_tpu_torch.compat.from_jax import raft_state_dict_from_jax
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    jm = jget("TernausNetMulti-Basic", C, 3, add_optflow_inputs=True,
              scale=SCALE)
    pm = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, 3, add_optflow_inputs=True, scale=SCALE)
    msgpack, pth = write_weights(
        tmp_path, jm, (np.zeros((1, 3, HW, HW, 3), np.float32),), pm, seed=5,
        optflow=np.zeros((1, 2, HW, HW, 2), np.float32))
    pair = np.zeros((1, HW, HW, 3), np.float32)
    fv = jax.tree_util.tree_map(np.asarray, jit_init(
        JRAFT(iters=12), jax.random.PRNGKey(7), pair, pair))
    raft_msgpack = tmp_path / "raft.msgpack"
    raft_msgpack.write_bytes(serialization.msgpack_serialize(fv))
    raft_pth = tmp_path / "raft.pth"
    torch.save(raft_state_dict_from_jax(fv), raft_pth)
    args = _common(dataset, tmp_path, "mfr") + [
        "--model_type", "TernausNetMulti-Basic", "--num_input_frames", "3",
        "--save_output_freq", "0", "--add_optflow_inputs", "True"]
    want = jmain(args + ["--load_wts_model", str(msgpack),
                         "--load_wts_flow_model", str(raft_msgpack)])
    got = main(args + ["--expt_name", "pmfr", "--load_wts_model", str(pth),
                       "--load_wts_flow_model", str(raft_pth),
                       "--device", "cpu"])
    assert got["num_samples"] == 4
    assert_results_match(got, want, 4, argmax_flips(recorded))


def test_endovis15_wrapper_puts_its_task_first(monkeypatch):
    """The wrapper runs the single-frame CLI with the endovis15 task and 11
    classes first, so that flags given later win."""
    from mfcnet_tpu_torch.cli import infer_endovis15_segmentation as ev

    seen = []
    monkeypatch.setattr(ev, "_main", lambda argv: seen.append(argv) or 7)
    assert ev.main(["--data_dir", "d"]) == 7
    assert seen == [["--prediction_task", "endovis15_segmentation",
                     "--num_classes", "11", "--data_dir", "d"]]
    from mfcnet_tpu_torch.configs.parsers import toolposeseg_test_parser

    args = toolposeseg_test_parser().parse_args(seen[0])
    assert (args.prediction_task, args.num_classes) == (
        "endovis15_segmentation", 11)


def test_test_parsers_follow_the_jax_package():
    """The testing parsers' flags and defaults against the JAX package's
    (``--device`` is the port's own)."""
    from mfcnet_tpu.configs import parsers as jp
    from mfcnet_tpu_torch.configs import parsers as pp

    for name in ("multiframe_test_parser", "toolposeseg_test_parser"):
        want = vars(getattr(jp, name)().parse_args([]))
        got = vars(getattr(pp, name)().parse_args([]))
        assert got.pop("device") == "cuda"
        assert (got["mode"], got["num_frames_per_video"],
                got["save_output_freq"], got["use_ema"]) == (
                    "testing", 75, 10, False)
        for k, v in got.items():
            assert want[k] == v, (name, k)


def test_infer_multiframe_cli_reads_a_test_pack(tmp_path):
    """``--packed_dir`` with a pack's ``test/`` split (the way to evaluate
    where OpenCV cannot decode the image tree), depth in the step: every
    sample scored, an overlay each with ``--save_output_freq 1``; a pack
    written for training is refused."""
    from mfcnet_tpu_torch.cli.infer_multiframe_endovis15 import main
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    args = ["--dataset", "JIGSAWS", "--expt_savedir", str(tmp_path),
            "--expt_name", "pk", "--num_workers", "1",
            "--input_height", str(HW), "--input_width", str(HW),
            "--model_scale", str(SCALE), "--add_depth_inputs", "True",
            "--save_output_freq", "1", "--device", "cpu"]
    pack = make_synthetic_pack(tmp_path / "pack", videos=(("test", 1, 3),),
                               height=HW, width=HW, mode="testing")
    got = main(args + ["--packed_dir", str(pack)])
    assert got["num_samples"] == 3
    assert len(got["iou_per_class"]) == C - 1
    assert len(list((tmp_path / "pk" / "outputs").glob("output_*.png"))) == 3
    train_pack = make_synthetic_pack(tmp_path / "tpack",
                                     videos=(("test", 1, 2),), height=HW,
                                     width=HW)
    with pytest.raises(ValueError, match="mode"):
        main(args + ["--packed_dir", str(train_pack)])
