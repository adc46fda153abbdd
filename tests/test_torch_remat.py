"""``--remat`` (the JAX package's ``nn.remat``): the port's TernausNet16,
TernausNet11 and TAPNet16 built with ``remat=True`` against
``remat=False`` from the same seeded weights, on the CPU: the same
``state_dict`` keys, a bit-equal forward, gradients within 1e-6 (the JAX
package's own limit for its remat test, ``tests/test_models.py``), the
segments really recomputed in the backward pass (and not without a
gradient); the training CLI with ``--remat True`` equal to one without, and
the remat flag reaching the model of both training CLIs."""

import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401


C, HW = 5, 32


def _pair(kind, scale):
    from mfcnet_tpu_torch.models import get_tooltip_segmentation_model

    return [get_tooltip_segmentation_model(
        kind, C, scale=scale, generator=torch.Generator().manual_seed(1),
        remat=remat).train() for remat in (False, True)]


def _inputs(kind):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, HW, HW, generator=gen)
    return ((x, torch.rand(2, 1, HW, HW, generator=gen))
            if kind.startswith("TAPNet") else (x,))


@pytest.mark.parametrize("kind,scale", [("TernausNet16", 0.125),
                                        ("TernausNet11", 0.125),
                                        ("TAPNet16", 0.125)])
def test_remat_is_transparent(kind, scale):
    plain, rem = _pair(kind, scale)
    assert rem.remat and not plain.remat
    assert list(plain.state_dict()) == list(rem.state_dict())
    for k, v in plain.state_dict().items():
        assert torch.equal(v, rem.state_dict()[k]), k
    calls = {"n": 0}

    def count(*_):
        calls["n"] += 1

    rem.dec2.register_forward_pre_hook(count)
    args = _inputs(kind)
    ya, yb = plain(*args), rem(*args)
    assert calls["n"] == 1
    assert torch.equal(ya, yb)
    (ya ** 2).mean().backward()
    (yb ** 2).mean().backward()
    assert calls["n"] == 2  # dec2's segment ran again in the backward pass
    for (k, pa), (_, pb) in zip(plain.named_parameters(),
                                rem.named_parameters()):
        torch.testing.assert_close(pb.grad, pa.grad, rtol=1e-6, atol=1e-6,
                                   msg=k)
    with torch.no_grad():
        assert torch.equal(rem(*args), ya.detach())
    assert calls["n"] == 3  # no segment without a gradient


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    from mfcnet_tpu_torch.data.synthetic import make_synthetic_pack

    return make_synthetic_pack(tmp_path_factory.mktemp("pack"),
                               videos=(("train", 2, 4), ("val", 1, 2)),
                               height=64, width=64, seed=0)


def test_train_cli_with_remat_equals_without(pack, tmp_path, monkeypatch):
    """One epoch of the multi-frame training CLI (TernausNetMulti-Basic, the
    base trained, bfloat16: the segments recompute on the step's bfloat16
    casts of the parameters) with ``--remat True`` ends with the parameters
    of the run without, bit for bit; the flag reaches the model of both
    training CLIs."""
    import mfcnet_tpu_torch.cli.train_multiframe_detection as mf
    import mfcnet_tpu_torch.cli.train_toolpose_segmentation as sf

    def args(name, remat):
        return ["--dataset", "JIGSAWS", "--packed_dir", str(pack),
                "--expt_savedir", str(tmp_path), "--expt_name", name,
                "--batch_size", "2", "--num_workers", "0", "--num_epochs",
                "0", "--print_freq", "100", "--input_height", "64",
                "--input_width", "64", "--model_scale", "0.0625",
                "--train_base_model", "true", "--compute_dtype",
                "bfloat16", "--loss_fns", "nll", "soft_jaccard",
                "--loss_wts", "0.7", "0.3", "--device", "cpu", "--remat",
                remat]

    plain = mf.main(args("plain", "False"))
    rem = mf.main(args("rem", "True"))
    assert rem.model.base_model.remat and not plain.model.base_model.remat
    assert rem.step == plain.step > 0
    sa, sb = plain.model.state_dict(), rem.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k

    built = []

    def spy(*a, **kw):
        built.append(kw.get("remat"))
        raise SystemExit("built")

    monkeypatch.setattr(sf, "get_tooltip_segmentation_model", spy)
    with pytest.raises(SystemExit, match="built"):
        sf.main(["--dataset", "JIGSAWS", "--packed_dir", str(pack),
                 "--expt_savedir", str(tmp_path), "--expt_name", "sf",
                 "--model_type", "TernausNet16", "--model_scale", "0.0625",
                 "--input_height", "64", "--input_width", "64", "--device",
                 "cpu", "--remat", "True"])
    assert built == [True]
