"""JAX package parameters -> the port's ``state_dict``.

The inverse of ``mfcnet_tpu/compat/torch_convert.py::
convert_multiframe_ternausnet``: a nested dict of numpy arrays
(``params`` + ``batch_stats``, as the JAX package's flax modules hold
them) becomes a ``state_dict`` for
:class:`mfcnet_tpu_torch.models.MultiFrameSegmenter`. Every step is an
exact layout change:

  * conv kernel HWIO -> OIHW;
  * deconv kernel, stored as the equivalent dense-conv kernel
    (kh, kw, in, out), -> ConvTranspose2d (in, out, kh, kw) with the
    spatial flip undone;
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

A flax ``.msgpack`` checkpoint is read with the JAX package (flax's
``serialization``); convert its variables here and save the result with
``torch.save`` to get a ``.pth`` the port loads.

:func:`raft_state_dict_from_jax` does the same for the flow provider: the
inverse of ``torch_convert.convert_raft``, into torchvision ``raft_large``
key names; :func:`unflow_state_dict_from_jax` for UnFlow: the inverse of
``torch_convert.convert_unflow``, into the reference checkpoint's key
names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _deconv(sd, key, p):
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)  # (in, out, kh, kw)
    sd[f"{key}.weight"] = _t(np.flip(w, axis=(2, 3)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, st):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(st["mean"])
    sd[f"{key}.running_var"] = _t(st["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def state_dict_from_jax(variables: Dict, model: torch.nn.Module):
    """JAX ``{'params', 'batch_stats'}`` of a TernausNetMulti-Basic or
    -Large MultiFrameSegmenter -> a complete ``state_dict`` for ``model``
    (the port's module of the same widths and variant; it fixes the
    encoder's layer indices and the ``conv1``..``conv5`` aliases). Both
    variants keep the head under ``multiframe_net.multiframe_net``, as
    ``torch_convert.convert_multiframe_ternausnet`` reads it; the head's
    first conv takes as many input channels as the JAX kernel has (T more
    with depth inputs, and for Large 2(T-1) more with flow inputs)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    base = params["base"]
    sd = {}
    enc_idx = [i for i, m in enumerate(model.base_model.encoder)
               if isinstance(m, torch.nn.Conv2d)]
    enc = base["encoder"]
    if len(enc) != len(enc_idx):
        raise ValueError(
            f"encoder has {len(enc)} convs in the JAX params, "
            f"{len(enc_idx)} in the model"
        )
    for j, idx in enumerate(enc_idx):
        _conv(sd, f"base_model.encoder.{idx}", enc[f"Conv_{j}"])
    for name in ("center", "dec5", "dec4", "dec3", "dec2"):
        blk = base[name]
        _conv(sd, f"base_model.{name}.block.0.conv",
              blk["ConvReLU_0"]["Conv_0"])
        _deconv(sd, f"base_model.{name}.block.1",
                blk["TorchConvTranspose_0"])
    _conv(sd, "base_model.dec1.conv", base["dec1"]["Conv_0"])
    _conv(sd, "base_model.final", base["final"])

    head = params["multiframe_net"]["head"]
    head_stats = stats["multiframe_net"]["head"]
    pre = "multiframe_net.multiframe_net"
    for i, tidx in enumerate((0, 3, 6, 9)):
        _conv(sd, f"{pre}.{tidx}", head[f"Conv_{i}"])
    for i, tidx in enumerate((1, 4, 7)):
        _bn(sd, f"{pre}.{tidx}", head[f"BatchNorm_{i}"],
            head_stats[f"BatchNorm_{i}"])

    # the conv1..conv5 stage views share the encoder's modules: fill
    # their keys from the canonical ones
    live = model.state_dict(keep_vars=True)
    canon = {id(v): k for k, v in live.items() if k in sd}
    for k, v in live.items():
        if k not in sd:
            if id(v) not in canon:
                raise KeyError(f"no JAX parameter for {k}")
            sd[k] = sd[canon[id(v)]]
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Dict):
    """Load JAX variables into ``model`` (strict); returns the model."""
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    return model


def load_jax_train_state(model: torch.nn.Module, params: Dict,
                         batch_stats: Dict):
    """Load a JAX ``TrainState``'s ``params`` and ``batch_stats`` (nested
    dicts of arrays) into ``model``, so that a training run of the port
    starts from the JAX run's numbers. Optimizer moments are not carried:
    both sides start a fresh Adam. Returns the model."""
    return load_jax_variables(
        model, {"params": params, "batch_stats": batch_stats})


def _raft_encoder(sd, prefix, params, stats):
    """flax RAFTEncoder subtree -> torchvision FeatureEncoder keys (conv
    at Sequential index 0, batch norm at index 1)."""
    _conv(sd, f"{prefix}.convnormrelu.0", params["Conv_0"])
    if "BatchNorm_0" in params:
        _bn(sd, f"{prefix}.convnormrelu.1", params["BatchNorm_0"],
            stats["BatchNorm_0"])
    for rb in range(6):
        tp = f"{prefix}.layer{rb // 2 + 1}.{rb % 2}"
        bp = params[f"ResidualBlock_{rb}"]
        bs = stats.get(f"ResidualBlock_{rb}", {})
        for j, name in enumerate(("convnormrelu1", "convnormrelu2",
                                  "downsample")):
            if f"Conv_{j}" not in bp:
                continue
            _conv(sd, f"{tp}.{name}.0", bp[f"Conv_{j}"])
            if f"BatchNorm_{j}" in bp:
                _bn(sd, f"{tp}.{name}.1", bp[f"BatchNorm_{j}"],
                    bs[f"BatchNorm_{j}"])
    _conv(sd, f"{prefix}.conv", params["Conv_1"])


def raft_state_dict_from_jax(variables: Dict):
    """JAX ``{'params', 'batch_stats'}`` of ``mfcnet_tpu.models.raft.RAFT``
    -> a ``state_dict`` for :class:`mfcnet_tpu_torch.models.raft.RAFT`
    (torchvision ``raft_large`` key names), the context encoder's
    batch-norm statistics included."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    _raft_encoder(sd, "feature_encoder", params["fnet"], {})
    _raft_encoder(sd, "context_encoder", params["cnet"], stats["cnet"])
    ub = params["update_block"]
    me, rb = "update_block.motion_encoder", "update_block.recurrent_block"
    for jname, tname in (("convc1", "convcorr1"), ("convc2", "convcorr2"),
                         ("convf1", "convflow1"), ("convf2", "convflow2"),
                         ("conv", "conv")):
        _conv(sd, f"{me}.{tname}.0", ub["encoder"][jname])
    for d, gru in (("h", "convgru1"), ("v", "convgru2")):
        for g in "zrq":
            _conv(sd, f"{rb}.{gru}.conv{g}", ub["gru"][f"conv{g}_{d}"])
    _conv(sd, "update_block.flow_head.conv1", ub["flow1"])
    _conv(sd, "update_block.flow_head.conv2", ub["flow2"])
    _conv(sd, "mask_predictor.convrelu.0", ub["mask1"])
    _conv(sd, "mask_predictor.conv", ub["mask2"])
    return sd


_UNFLOW_UPCONV = (
    ("six_out", "moduleSixOut", _conv), ("six_up", "moduleSixUp", _deconv),
    ("fiv_next", "moduleFivNext.0", _deconv),
    ("fiv_out", "moduleFivOut", _conv), ("fiv_up", "moduleFivUp", _deconv),
    ("fou_next", "moduleFouNext.0", _deconv),
    ("fou_out", "moduleFouOut", _conv), ("fou_up", "moduleFouUp", _deconv),
    ("thr_next", "moduleThrNext.0", _deconv),
    ("thr_out", "moduleThrOut", _conv), ("thr_up", "moduleThrUp", _deconv),
    ("two_next", "moduleTwoNext.0", _deconv),
    ("two_out", "moduleTwoOut", _conv),
    ("upscale", "moduleUpscale.0", _deconv),
)
_UNFLOW_TAIL = (("fou_a", "moduleFou.1"), ("fou_b", "moduleFou.3"),
                ("fiv_a", "moduleFiv.1"), ("fiv_b", "moduleFiv.3"),
                ("six_a", "moduleSix.1"), ("six_b", "moduleSix.3"))
_UNFLOW_COMPLEX = (("one", "moduleOne.1"), ("two", "moduleTwo.1"),
                   ("thr", "moduleThr.1"), ("redir", "moduleRedir.0"),
                   ("combined", "moduleCombined.0")) + _UNFLOW_TAIL
_UNFLOW_SIMPLE = (("one", "moduleOne.1"), ("two", "moduleTwo.1"),
                  ("thr_a", "moduleThr.1"), ("thr_b", "moduleThr.3")
                  ) + _UNFLOW_TAIL


def unflow_state_dict_from_jax(variables: Dict):
    """JAX ``{'params'}`` of ``mfcnet_tpu.models.unflow.UnFlow`` -> a
    ``state_dict`` for :class:`mfcnet_tpu_torch.models.unflow.UnFlow` (the
    reference checkpoint's ``moduleFlownets.{0,1,2}.module*`` key
    names)."""
    params = variables["params"]
    sd = {}
    for i, convs in enumerate((_UNFLOW_COMPLEX, _UNFLOW_SIMPLE,
                               _UNFLOW_SIMPLE)):
        net, pre = params[f"flownet{i}"], f"moduleFlownets.{i}"
        for jname, tname in convs:
            _conv(sd, f"{pre}.{tname}", net[jname])
        for jname, tname, put in _UNFLOW_UPCONV:
            put(sd, f"{pre}.moduleUpconv.{tname}", net["upconv"][jname])
    return sd
