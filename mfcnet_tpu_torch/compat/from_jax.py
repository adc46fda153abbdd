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

:func:`state_dict_from_jax` takes every base the port builds, alone or
inside a Multi wrapper: TernausNet11/16, DeepLabV3 and FCN (the inverses of
``torch_convert.convert_{deeplabv3,fcn}_resnet101``, torchvision's key
names), HRNet (of ``convert_hrnet``, the reference's names, flax's
auto-named ``Conv_i`` / ``BatchNorm_i`` inside its blocks), SegFormer
(of ``convert_segformer``, smp's names; dense kernel (in, out) -> linear
weight (out, in), LayerNorm scale -> weight), ResUNet (of
``convert_resunet``: flax's auto-named ``ResBlock_i`` / ``Conv_i`` in
creation order; GroupNorm scale -> weight), TAPNet11/16 (of
``convert_tapnet``, under the JAX module's ``body`` scope), the generic
TAPNet (flax's auto names in creation order) and UNet (whose port
carries the JAX module tree's names).

:func:`raft_state_dict_from_jax` does the same for the flow provider: the
inverse of ``torch_convert.convert_raft``, into torchvision ``raft_large``
key names; :func:`unflow_state_dict_from_jax` for UnFlow: the inverse of
``torch_convert.convert_unflow``, into the reference checkpoint's key
names; :func:`ffpp_state_dict_from_jax` for FlowFormer++: the inverse of
``torch_convert.convert_flowformerpp``, into the reference checkpoint's
key names (dense kernel (in, out) -> linear weight (out, in); LayerNorm
scale -> weight).
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


def _ternausnet_pairs(base, params):
    """TernausNet11/16: the encoder's flax ``Conv_j`` at the torchvision
    layer indices ``base`` fixes, then the decoder blocks."""
    enc_idx = [i for i, m in enumerate(base.encoder)
               if isinstance(m, torch.nn.Conv2d)]
    if len(params["encoder"]) != len(enc_idx):
        raise ValueError(
            f"encoder has {len(params['encoder'])} convs in the JAX params, "
            f"{len(enc_idx)} in the model")
    out = [(f"encoder.{idx}", ("encoder", f"Conv_{j}"), _conv)
           for j, idx in enumerate(enc_idx)]
    for name in ("center", "dec5", "dec4", "dec3", "dec2"):
        out += [(f"{name}.block.0.conv", (name, "ConvReLU_0", "Conv_0"),
                 _conv),
                (f"{name}.block.1", (name, "TorchConvTranspose_0"),
                 _deconv)]
    return out + [("dec1.conv", ("dec1", "Conv_0"), _conv),
                  ("final", ("final",), _conv)]


def _tree_pairs(base, params):
    """A module whose torch names are the JAX tree's (the UNet): every
    conv and batch norm at its own dotted path."""
    out = []
    for name, mod in base.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            out.append((name, tuple(name.split(".")), _conv))
        elif isinstance(mod, torch.nn.BatchNorm2d):
            out.append((name, tuple(name.split(".")), _bn))
    return out


def _resblock_pairs(tp, jp, blk):
    out = []
    for i in (1, 2):
        out += [(f"{tp}.block{i}.proj", jp + (f"WSConv_{i - 1}",), _conv),
                (f"{tp}.block{i}.norm", jp + (f"GroupNorm_{i - 1}",), _ln)]
    if isinstance(blk.res_conv, torch.nn.Conv2d):
        out.append((f"{tp}.res_conv", jp + ("Conv_0",), _conv))
    return out


def _resunet_pairs(base, params):
    """The inverse of ``convert_resunet``: down stage i is ``ResBlock_i``
    and ``Conv_i``, the middle ``ResBlock_n``, up stage i
    ``ResBlock_{n+1+i}`` and ``Conv_{n+i}``, the last ``ResBlock_{2n+1}``
    (flax's creation order)."""
    n = len(base.downs)
    out = [("init_conv", ("init_conv",), _conv),
           ("output_layer", ("output_layer",), _conv)]
    for i, (blk, down) in enumerate(base.downs):
        out += _resblock_pairs(f"downs.{i}.0", (f"ResBlock_{i}",), blk)
        key = f"downs.{i}.1" + (".1" if i < n - 1 else "")
        out.append((key, (f"Conv_{i}",), _conv))
    out += _resblock_pairs("mid_block", (f"ResBlock_{n}",), base.mid_block)
    for i, (blk, up) in enumerate(base.ups):
        out += _resblock_pairs(f"ups.{i}.0", (f"ResBlock_{n + 1 + i}",), blk)
        key = f"ups.{i}.1" + (".1" if i < n - 1 else "")
        out.append((key, (f"Conv_{n + i}",), _conv))
    return out + _resblock_pairs("final_res_block", (f"ResBlock_{2 * n + 1}",),
                                 base.final_res_block)


def _tapnet_pairs(base, params):
    """The inverse of ``convert_tapnet``: the VGG encoder's ``Conv_j`` at
    torchvision's layer indices, decoders, attention modules, ``dec1`` and
    ``final``, all under ``body``."""
    enc = getattr(base, base.vgg_key)
    b = ("body",)
    out = [(f"{base.vgg_key}.{idx}", b + ("encoder", f"Conv_{j}"), _conv)
           for j, idx in enumerate(i for i, m in enumerate(enc)
                                   if isinstance(m, torch.nn.Conv2d))]
    for name in ("center", "dec5", "dec4", "dec3", "dec2"):
        if hasattr(getattr(base, name).l, "deconv"):
            out += [(f"{name}.l.conv.l.conv",
                     b + (name, "ConvReLU_0", "Conv_0"), _conv),
                    (f"{name}.l.deconv",
                     b + (name, "TorchConvTranspose_0"), _deconv)]
        else:
            out += [(f"{name}.l.conv{i + 1}.l.conv",
                     b + (name, f"ConvReLU_{i}", "Conv_0"), _conv)
                    for i in range(2)]
    for name in ("att5", "att4", "att3", "att2", "att1"):
        out += _attention_pairs(name, b + (name,))
    return out + [("dec1.l.conv", b + ("dec1", "Conv_0"), _conv),
                  ("final", b + ("final",), _conv)]


def _attention_pairs(tp, jp):
    return [(f"{tp}.firstconv.l.conv", jp + ("ConvReLU_0", "Conv_0"), _conv),
            (f"{tp}.learnable_attmap.0.l.conv", jp + ("att_conv",), _conv)]


def _generic_tapnet_pairs(base, params):
    """The generic TAPNet: its ``UNetModule``s are flax's ``UNetModule_i``
    in creation order (conv1..conv4, center, up4..up1)."""
    out = []
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "center",
                              "up4", "up3", "up2", "up1")):
        out += [(f"{name}.l.conv{j + 1}.l.conv",
                 (f"UNetModule_{i}", f"ConvReLU_{j}", "Conv_0"), _conv)
                for j in range(2)]
    for name in ("att4", "att3", "att2", "att1"):
        out += _attention_pairs(name, (name,))
    return out + [("final", ("final",), _conv)]


def _resnet_pairs(backbone):
    out = [("backbone.conv1", ("backbone", "conv1"), _conv),
           ("backbone.bn1", ("backbone", "bn1"), _bn)]
    for li in range(1, 5):
        for bi, blk in enumerate(getattr(backbone, f"layer{li}")):
            tp, jp = f"backbone.layer{li}.{bi}", ("backbone",
                                                  f"layer{li}_block{bi}")
            for i in (1, 2, 3):
                out += [(f"{tp}.conv{i}", jp + (f"conv{i}",), _conv),
                        (f"{tp}.bn{i}", jp + (f"bn{i}",), _bn)]
            if blk.downsample is not None:
                out += [(f"{tp}.downsample.0", jp + ("down_conv",), _conv),
                        (f"{tp}.downsample.1", jp + ("down_bn",), _bn)]
    return out


def _deeplab_pairs(base, params):
    a, ja = "classifier.0", ("classifier", "aspp")
    out = _resnet_pairs(base.backbone) + [
        (f"{a}.convs.0.0", ja + ("conv1x1",), _conv),
        (f"{a}.convs.0.1", ja + ("bn1x1",), _bn)]
    for i in range(3):
        out += [(f"{a}.convs.{i + 1}.0", ja + (f"aspp_conv{i}", "conv"),
                 _conv),
                (f"{a}.convs.{i + 1}.1", ja + (f"aspp_conv{i}", "bn"), _bn)]
    return out + [
        (f"{a}.convs.4.1", ja + ("pool_conv",), _conv),
        (f"{a}.convs.4.2", ja + ("pool_bn",), _bn),
        (f"{a}.project.0", ja + ("project",), _conv),
        (f"{a}.project.1", ja + ("project_bn",), _bn),
        ("classifier.1", ("classifier", "conv"), _conv),
        ("classifier.2", ("classifier", "bn"), _bn),
        ("classifier.4", ("classifier", "final"), _conv)]


def _fcn_pairs(base, params):
    return _resnet_pairs(base.backbone) + [
        ("classifier.0", ("classifier", "conv"), _conv),
        ("classifier.1", ("classifier", "bn"), _bn),
        ("classifier.4", ("classifier", "final"), _conv)]


def _auto_named(tp, jp, n_convs):
    """A block whose flax convs and batch norms are auto-named: torch
    ``conv{i}`` / ``bn{i}`` -> ``Conv_{i-1}`` / ``BatchNorm_{i-1}``."""
    out = []
    for i in range(n_convs):
        out += [(f"{tp}.conv{i + 1}", jp + (f"Conv_{i}",), _conv),
                (f"{tp}.bn{i + 1}", jp + (f"BatchNorm_{i}",), _bn)]
    return out


def _hrnet_pairs(base, params):
    out = [("conv1", ("stem1",), _conv), ("bn1", ("stem1_bn",), _bn),
           ("conv2", ("stem2",), _conv), ("bn2", ("stem2_bn",), _bn)]
    for b, blk in enumerate(base.layer1):
        out += _auto_named(f"layer1.{b}", (f"layer1_{b}",), 3)
        if blk.downsample is not None:
            out += [(f"layer1.{b}.downsample.0", (f"layer1_{b}", "Conv_3"),
                     _conv),
                    (f"layer1.{b}.downsample.1",
                     (f"layer1_{b}", "BatchNorm_3"), _bn)]
    out += [("transition1.0.0", ("t1_0",), _conv),
            ("transition1.0.1", ("t1_0_bn",), _bn),
            ("transition1.1.0.0", ("t1_1",), _conv),
            ("transition1.1.0.1", ("t1_1_bn",), _bn),
            ("transition2.2.0.0", ("t2",), _conv),
            ("transition2.2.0.1", ("t2_bn",), _bn),
            ("transition3.3.0.0", ("t3",), _conv),
            ("transition3.3.0.1", ("t3_bn",), _bn)]
    for s in (2, 3, 4):
        for m, mod in enumerate(getattr(base, f"stage{s}")):
            tp, jp = f"stage{s}.{m}", (f"stage{s}_m{m}",)
            for br, seq in enumerate(mod.branches):
                for b in range(len(seq)):
                    out += _auto_named(f"{tp}.branches.{br}.{b}",
                                       jp + (f"branch{br}_block{b}",), 2)
            for i, row in enumerate(mod.fuse_layers):
                for j, path in enumerate(row):
                    fp = f"{tp}.fuse_layers.{i}.{j}"
                    if j > i:
                        out += [(f"{fp}.0", jp + (f"fuse{i}_{j}_conv",),
                                 _conv),
                                (f"{fp}.1", jp + (f"fuse{i}_{j}_bn",), _bn)]
                    for k in range(i - j):
                        d = f"fuse{i}_{j}_down{k}"
                        out += [(f"{fp}.{k}.0", jp + (d,), _conv),
                                (f"{fp}.{k}.1", jp + (f"{d}_bn",), _bn)]
    return out + [("last_layer.0", ("head1",), _conv),
                  ("last_layer.1", ("head_bn",), _bn),
                  ("last_layer.3", ("head2",), _conv)]


def _segformer_pairs(base, params):
    out = []
    for s in range(1, 5):
        e = ("encoder", f"embed{s}")
        out += [(f"encoder.patch_embed{s}.proj", e + ("Conv_0",), _conv),
                (f"encoder.patch_embed{s}.norm", e + ("LayerNorm_0",), _ln)]
        for b, blk in enumerate(getattr(base.encoder, f"block{s}")):
            tp, jp = f"encoder.block{s}.{b}", ("encoder", f"stage{s}_block{b}")
            at = jp + ("EfficientAttention_0",)
            out += [(f"{tp}.norm1", jp + ("LayerNorm_0",), _ln),
                    (f"{tp}.attn.q", at + ("q",), _linear),
                    (f"{tp}.attn.kv", at + ("kv",), _linear),
                    (f"{tp}.attn.proj", at + ("proj",), _linear),
                    (f"{tp}.norm2", jp + ("LayerNorm_1",), _ln),
                    (f"{tp}.mlp.fc1", jp + ("MixFFN_0", "fc1"), _linear),
                    (f"{tp}.mlp.dwconv.dwconv", jp + ("MixFFN_0", "dwconv"),
                     _conv),
                    (f"{tp}.mlp.fc2", jp + ("MixFFN_0", "fc2"), _linear)]
            if blk.attn.sr_ratio > 1:
                out += [(f"{tp}.attn.sr", at + ("sr",), _conv),
                        (f"{tp}.attn.norm", at + ("sr_norm",), _ln)]
        out.append((f"encoder.norm{s}", ("encoder", f"norm{s}"), _ln))
    return out + [(f"decoder.mlp_stage.{i}.linear", (f"linear_c{4 - i}",),
                   _linear) for i in range(4)] + [
        ("decoder.fuse_stage.0", ("fuse",), _conv),
        ("decoder.fuse_stage.1", ("fuse_bn",), _bn),
        ("segmentation_head.0", ("pred",), _conv)]


def _base_pairs(base, params):
    """(torch key prefix, flax path, layout change) of every parameterized
    module of a base model."""
    from mfcnet_tpu_torch.models.deeplab import DeepLabV3ResNet101
    from mfcnet_tpu_torch.models.fcn import FCNResNet101
    from mfcnet_tpu_torch.models.hrnet import HRNetW48
    from mfcnet_tpu_torch.models.resunet import ResUNetVB
    from mfcnet_tpu_torch.models.segformer import SegFormerMiTB3
    from mfcnet_tpu_torch.models.tapnet import TAPNet, _TAPNetVGG
    from mfcnet_tpu_torch.models.ternausnet import _TernausNet
    from mfcnet_tpu_torch.models.unet import UNet

    for cls, pairs in ((_TernausNet, _ternausnet_pairs),
                       (DeepLabV3ResNet101, _deeplab_pairs),
                       (FCNResNet101, _fcn_pairs), (HRNetW48, _hrnet_pairs),
                       (SegFormerMiTB3, _segformer_pairs),
                       (UNet, _tree_pairs), (ResUNetVB, _resunet_pairs),
                       (_TAPNetVGG, _tapnet_pairs),
                       (TAPNet, _generic_tapnet_pairs)):
        if isinstance(base, cls):
            return pairs(base, params)
    raise TypeError(f"no JAX layout for {type(base).__name__}")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _fill(sd, prefix, pairs, params, stats):
    for key, path, put in pairs:
        if put is _bn:
            put(sd, prefix + key, _at(params, path), _at(stats, path))
        else:
            put(sd, prefix + key, _at(params, path))


def state_dict_from_jax(variables: Dict, model: torch.nn.Module):
    """JAX ``{'params', 'batch_stats'}`` -> a complete ``state_dict`` for
    ``model``: a Multi wrapper (:class:`MultiFrameSegmenter`, Basic or
    Large, of any base the port builds) or a single-frame base alone.
    ``model`` is the port's module of the same widths; it fixes the
    TernausNet encoder's layer indices and its ``conv1``..``conv5``
    aliases. Both variants keep the head under
    ``multiframe_net.multiframe_net``, as ``torch_convert`` reads it; the
    head's first conv takes as many input channels as the JAX kernel has
    (T more with depth inputs, and for Large 2(T-1) more with flow
    inputs). A key of ``model`` with no JAX counterpart raises."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    multi = hasattr(model, "base_model")
    if multi:
        base = model.base_model
        _fill(sd, "base_model.", _base_pairs(base, params["base"]),
              params["base"], stats.get("base", {}))
        head = params["multiframe_net"]["head"]
        head_stats = stats["multiframe_net"]["head"]
        pre = "multiframe_net.multiframe_net"
        for i, tidx in enumerate((0, 3, 6, 9)):
            _conv(sd, f"{pre}.{tidx}", head[f"Conv_{i}"])
        for i, tidx in enumerate((1, 4, 7)):
            _bn(sd, f"{pre}.{tidx}", head[f"BatchNorm_{i}"],
                head_stats[f"BatchNorm_{i}"])
    else:
        _fill(sd, "", _base_pairs(model, params), params, stats)

    # the VGG encoders' views (TernausNet16's and TAPNet's conv1..conv5
    # stages, TernausNet11's conv1..conv5 aliases) share the encoder's
    # modules: fill their keys from the canonical ones
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


def _linear(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _ffpp_twins(sd, prefix, p):
    """flax TwinsSVTEncoder -> timm twins keys under ``prefix`` (…svt)."""
    si = 0
    while f"embed{si}" in p:
        _conv(sd, f"{prefix}.patch_embeds.{si}.proj", p[f"embed{si}"])
        _ln(sd, f"{prefix}.patch_embeds.{si}.norm", p[f"embed_norm{si}"])
        _conv(sd, f"{prefix}.pos_block.{si}.proj.0", p[f"pos{si}"]["conv"])
        bi = 0
        while f"s{si}_b{bi}" in p:
            bp, tp = p[f"s{si}_b{bi}"], f"{prefix}.blocks.{si}.{bi}"
            _ln(sd, f"{tp}.norm1", bp["norm1"])
            _ln(sd, f"{tp}.norm2", bp["norm2"])
            for name in ("fc1", "fc2"):
                _linear(sd, f"{tp}.mlp.{name}", bp["mlp"][name])
            for name, q in bp["attn"].items():
                if name == "sr":
                    _conv(sd, f"{tp}.attn.sr", q)
                elif name == "norm":
                    _ln(sd, f"{tp}.attn.norm", q)
                else:
                    _linear(sd, f"{tp}.attn.{name}", q)
            bi += 1
        si += 1


def _ffpp_attn_layer(sd, prefix, p):
    """norm1/norm2, q/k/v/proj, ffn0/ffn1 -> the reference's ``ffn.0`` and
    ``ffn.3``."""
    for name in ("norm1", "norm2"):
        _ln(sd, f"{prefix}.{name}", p[name])
    for name in ("q", "k", "v", "proj"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.ffn.0", p["ffn0"])
    _linear(sd, f"{prefix}.ffn.3", p["ffn1"])


def ffpp_state_dict_from_jax(variables: Dict):
    """JAX ``{'params'}`` of ``mfcnet_tpu.models.flowformerpp.FlowFormerPP``
    -> a ``state_dict`` for :class:`mfcnet_tpu_torch.models.flowformerpp.
    FlowFormerPP` (the reference checkpoint's key names, without the GMA
    ``pos_emb`` tables that neither forward reads)."""
    params = variables["params"]
    sd = {}
    _ffpp_twins(sd, "memory_encoder.feat_encoder.svt", params["feat_encoder"])
    _ffpp_twins(sd, "context_encoder.svt", params["context_encoder"])
    cpe = "memory_encoder.cost_perceiver_encoder"
    per = params["cost_perceiver"]
    pe = per["patch_embed"]
    for jname, tname in (("proj0", "proj.0"), ("proj1", "proj.2"),
                         ("proj2", "proj.4"), ("ffn0", "ffn_with_coord.0"),
                         ("ffn1", "ffn_with_coord.2")):
        _conv(sd, f"{cpe}.patch_embed.{tname}", pe[jname])
    _ln(sd, f"{cpe}.patch_embed.norm", pe["norm"])
    sd[f"{cpe}.latent_tokens"] = _t(per["latent_tokens"])
    _ffpp_attn_layer(sd, f"{cpe}.input_layer", per["input_layer"])
    i = 0
    while f"self{i}" in per:
        _ffpp_attn_layer(sd, f"{cpe}.encoder_layers.{i}", per[f"self{i}"])
        for kind in ("local", "global"):
            bp = per[f"vert{i}_{kind}"]
            tp = f"{cpe}.vertical_encoder_layers.{i}.{kind}_block"
            _ln(sd, f"{tp}.norm1", bp["norm1"])
            _ln(sd, f"{tp}.norm2", bp["norm2"])
            for name in ("fc1", "fc2"):
                _linear(sd, f"{tp}.mlp.{name}", bp["mlp"][name])
            for name, q in bp["attn"].items():
                if name in ("sr_key", "sr_value"):
                    _conv(sd, f"{tp}.attn.{name}", q)
                elif name == "norm":
                    _ln(sd, f"{tp}.attn.norm", q)
                else:
                    _linear(sd, f"{tp}.attn.{name}", q)
        i += 1

    dec = "memory_decoder"
    _conv(sd, f"{dec}.proj", params["proj"])
    _conv(sd, f"{dec}.flow_token_encoder.0", params["ft_enc0"])
    _conv(sd, f"{dec}.flow_token_encoder.2", params["ft_enc1"])
    _ffpp_attn_layer(sd, f"{dec}.decoder_layer.cross_attend",
                     params["decoder_cross"])
    _conv(sd, f"{dec}.att.to_qk", params["att"]["to_qk"])
    ub, tb = params["update_block"], f"{dec}.update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(sd, f"{tb}.encoder.{name}", ub[name])
    _conv(sd, f"{tb}.aggregator.to_v", ub["to_v"])
    sd[f"{tb}.aggregator.gamma"] = _t(ub["gamma"])
    for d, i in (("h", 1), ("v", 2)):
        for g in "zrq":
            _conv(sd, f"{tb}.gru.conv{g}{i}", ub["gru"][f"conv{g}_{d}"])
    _conv(sd, f"{tb}.flow_head.conv1", ub["flow1"])
    _conv(sd, f"{tb}.flow_head.conv2", ub["flow2"])
    _conv(sd, f"{tb}.mask.0", ub["mask1"])
    _conv(sd, f"{tb}.mask.2", ub["mask2"])
    return sd
