"""The port's pack writer CLI (``python -m mfcnet_tpu_torch.cli.pack_dataset``)
against the JAX package's ``tools/pack_dataset.py`` on one tiny synthetic
image tree (the JAX package's generator, with depth maps): the same flags,
the same summary lines, and shards equal byte for byte (``index.json``,
frames, masks, depth), in training mode (``train/``, ``val/``) with depth and
in testing mode (``test/``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import _two_torch_threads  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import cv2

    from mfcnet_tpu.data.synthetic import make_jigsaws_like_dataset

    root = make_jigsaws_like_dataset(
        tmp_path_factory.mktemp("tree"), num_videos=2, frames_per_video=3,
        height=32, width=48, seed=4)
    rng = np.random.default_rng(5)
    for img in root.rglob("images/*.jpg"):
        d = img.parent.parent / "depth_maps_depthanythingv2"
        d.mkdir(exist_ok=True)
        cv2.imwrite(str(d / (img.stem + ".png")),
                    rng.integers(0, 256, (32, 48), dtype=np.uint8))
    return root


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode,depth", [("training", "True"),
                                        ("testing", "False")])
def test_pack_cli_writes_the_jax_tools_shards(tree, tmp_path, capsys, mode,
                                              depth):
    from pack_dataset import main as jax_main

    from mfcnet_tpu_torch.cli.pack_dataset import main

    outs = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        out = tmp_path / name
        assert fn(["--data_dir", str(tree), "--dataset", "JIGSAWS",
                   "--mode", mode, "--prediction_task",
                   "toolpose_segmentation", "--add_depth_inputs", depth,
                   "--out", str(out)]) == 0
        lines = capsys.readouterr().out.replace(str(out), "OUT").splitlines()
        assert lines[-1].startswith("packed in ")
        outs[name] = (_files(out), lines[:-1])
    (jfiles, jlines), (pfiles, plines) = outs["jax"], outs["port"]
    assert plines == jlines
    splits = {"training": {"train", "val"}, "testing": {"test"}}[mode]
    assert {k.split("/")[0] for k in jfiles} == splits
    assert any(k.endswith("depth.u8") for k in jfiles) == (depth == "True")
    assert list(pfiles) == list(jfiles)
    for k in jfiles:
        assert pfiles[k] == jfiles[k], k
