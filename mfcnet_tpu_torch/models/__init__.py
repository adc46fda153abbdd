"""Model registry (counterpart of ``mfcnet_tpu/models/__init__.py``).

Builds every model type of the JAX package's two registries, at their
widths for any ``scale``: the multi-frame ``{TernausNet,DeepLab,FCN,HRNet,
SegFormer,UNet,ResUNet}Multi-{Basic,Large}`` (with or without flow and
depth inputs) and the single-frame ``TernausNet11``, ``TernausNet16``,
``DeepLab_v3`` (alias ``DeepLab``), ``FCN``, ``HRNet``, ``SegFormer``,
``UNet``, ``ResUNet``, ``TAPNet11`` and ``TAPNet16`` (which take the
image and an attention map).
"""

from __future__ import annotations

import torch

from mfcnet_tpu_torch.models.common import VGG11_STAGES, VGG16_STAGES
from mfcnet_tpu_torch.models.mfcnet import (
    MultiFrameHead,
    MultiFrameNet,
    MultiFrameSegmenter,
)
from mfcnet_tpu_torch.models.ternausnet import TernausNet11, TernausNet16

#: multi-frame family -> its base's single-frame model type
_MULTI_BASES = {
    "TernausNetMulti": "TernausNet16",
    "DeepLabMulti": "DeepLab_v3",
    "FCNMulti": "FCN",
    "HRNetMulti": "HRNet",
    "SegFormerMulti": "SegFormer",
    "UNetMulti": "UNet",
    "ResUNetMulti": "ResUNet",
}
#: the single-frame types, with how the single-frame step reads the
#: model's output (``train/steps.py``): log-probabilities as they are,
#: logits through a float32 log-softmax, or TAPNet's log-probabilities of
#: the image and the attention map (mfcnet_tpu/cli/
#: train_toolpose_segmentation.py:43-55)
OUTPUT_MODES = {
    "TernausNet11": "log_probs",
    "TernausNet16": "log_probs",
    "SegFormer": "log_probs",
    "HRNet": "logits",
    "DeepLab_v3": "logits",
    "DeepLab": "logits",
    "FCN": "logits",
    "UNet": "logits",
    "ResUNet": "logits",
    "TAPNet11": "tapnet",
    "TAPNet16": "tapnet",
}


def _scaled_vgg(stages, scale: float):
    return tuple(
        tuple(max(4, int(c * scale)) for c in stage) for stage in stages
    )


def _build_base(kind: str, num_classes: int, scale: float = 1.0):
    """(single-frame model, base_output) by model type, with the JAX
    registry's rules for ``scale`` < 1 (``mfcnet_tpu/models/__init__.py::
    _build_base``)."""
    if kind in ("TernausNet11", "TernausNet16"):
        cls, stages = ((TernausNet11, VGG11_STAGES) if kind == "TernausNet11"
                       else (TernausNet16, VGG16_STAGES))
        return cls(num_classes=num_classes,
                   num_filters=max(4, int(64 * scale)),
                   stage_convs=_scaled_vgg(stages, scale)), "exp"
    if kind in ("TAPNet11", "TAPNet16"):
        from mfcnet_tpu_torch.models.tapnet import TAPNet11, TAPNet16

        cls, stages = ((TAPNet11, VGG11_STAGES) if kind == "TAPNet11"
                       else (TAPNet16, VGG16_STAGES))
        return cls(num_classes,
                   stage_convs=_scaled_vgg(stages, scale)), "exp"
    if kind == "UNet":
        from mfcnet_tpu_torch.models.unet import UNET_DIMS, UNet

        return UNet(num_classes, dims=tuple(
            max(4, int(d * scale)) for d in UNET_DIMS)), "identity"
    if kind == "ResUNet":
        from mfcnet_tpu_torch.models.resunet import ResUNetVB

        return ResUNetVB(num_classes, dim=max(8, int(16 * scale)),
                         groups=8 if scale >= 0.5 else 4), "identity"
    if kind in ("DeepLab_v3", "DeepLab", "FCN"):
        from mfcnet_tpu_torch.models.deeplab import DeepLabV3ResNet101
        from mfcnet_tpu_torch.models.fcn import FCNResNet101

        cls = FCNResNet101 if kind == "FCN" else DeepLabV3ResNet101
        layers = (3, 4, 23, 3) if scale >= 1.0 else (1, 1, 1, 1)
        return cls(num_classes, layers=layers,
                   width=max(4, int(64 * scale))), "identity"
    if kind == "HRNet":
        from mfcnet_tpu_torch.models.hrnet import HRNET_W48, HRNetW48

        if scale >= 1.0:
            return HRNetW48(num_classes), "identity"
        return HRNetW48(
            num_classes,
            channels=tuple(max(4, int(c * scale)) for c in HRNET_W48),
            stage_modules=(1, 1, 1), num_blocks=1,
            stage1_width=max(4, int(64 * scale))), "identity"
    if kind == "SegFormer":
        from mfcnet_tpu_torch.models.segformer import MIT_B3, SegFormerMiTB3

        if scale >= 1.0:
            return SegFormerMiTB3(num_classes), "identity"
        return SegFormerMiTB3(
            num_classes, decoder_dim=max(8, int(256 * scale)),
            dims=tuple(max(8, int(d * scale)) for d in MIT_B3["dims"]),
            depths=(1, 1, 1, 1), heads=(1, 1, 1, 1)), "identity"
    raise ValueError(f"Model type {kind} not recognized")


def get_multiframe_segmentation_model(
    model_type: str,
    num_classes: int,
    num_input_frames: int,
    add_optflow_inputs: bool = False,
    add_depth_inputs: bool = False,
    scale: float = 1.0,
    generator: torch.Generator | None = None,
) -> MultiFrameSegmenter:
    """Build a multi-frame model by the reference's model-type string.

    ``add_optflow_inputs`` changes no parameter of the Basic variant
    (the flow only warps) and widens the Large head's first conv by
    2(T-1) channels (the raw flows); ``add_depth_inputs`` widens the
    head's first conv by T channels. ``scale`` < 1 shrinks the base as
    the JAX registry does; ``generator`` seeds the random initialization
    (PyTorch's default init schemes, drawn from this generator)."""
    family, _, variant = model_type.rpartition("-")
    variant = variant.lower()
    if family not in _MULTI_BASES or variant not in ("basic", "large"):
        raise ValueError(f"Model type {model_type} not recognized")
    base, base_output = _build_base(_MULTI_BASES[family], num_classes,
                                    scale)
    model = MultiFrameSegmenter(base, num_classes, num_input_frames,
                                variant=variant,
                                base_output=base_output,
                                add_depth_inputs=add_depth_inputs,
                                add_optflow_inputs=add_optflow_inputs)
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


def get_tooltip_segmentation_model(model_type: str, num_classes: int,
                                   scale: float = 1.0,
                                   generator: torch.Generator | None = None
                                   ) -> torch.nn.Module:
    """A single-frame model by the reference's model-type string: the
    bases of the multi-frame families (trained first and loaded with
    ``--load_wts_base_model``), TernausNet11 and TAPNet11/16."""
    model, _ = _build_base(model_type, num_classes, scale)
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


def _norm_defaults(mod):
    if isinstance(mod, (torch.nn.LayerNorm, torch.nn.BatchNorm2d,
                        torch.nn.GroupNorm)):
        torch.nn.init.ones_(mod.weight)
        torch.nn.init.zeros_(mod.bias)


def init_weights(model: torch.nn.Module, generator: torch.Generator):
    """Re-draw every conv, deconv and linear weight and bias from
    ``generator`` with PyTorch's default schemes (kaiming-uniform(a=sqrt(5))
    weights, fan-in uniform biases; fan-in = input channels per group x
    kernel taps; a ``WSConv2d`` is a conv); LayerNorm, BatchNorm and
    GroupNorm get weight 1, bias 0. A seed fixes the whole model."""
    import math

    with torch.no_grad():
        for mod in model.modules():
            _norm_defaults(mod)
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                torch.nn.Linear)):
                torch.nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5),
                                               generator=generator)
                if mod.bias is not None:
                    fan_in = torch.nn.init._calculate_correct_fan(
                        mod.weight, "fan_in")
                    b = 1.0 / math.sqrt(fan_in)
                    torch.nn.init.uniform_(mod.bias, -b, b,
                                           generator=generator)
    return model


#: std correction of a normal truncated at 2 sigma (jax.nn.initializers'
#: variance_scaling with "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def init_weights_lecun(model: torch.nn.Module, generator: torch.Generator):
    """Re-draw every conv, deconv and linear weight as the JAX package's
    flax ``Conv`` and ``Dense`` initialize theirs (``lecun_normal``: a
    normal truncated at two standard deviations with variance 1 / fan-in,
    fan-in = input channels per group x kernel taps; ``WSConv2d`` too, as
    flax's ``WSConv`` draws its raw kernel) and zero every bias;
    LayerNorm, BatchNorm and GroupNorm get weight 1, bias 0.
    The training CLIs start from it, as the JAX trainer does: under
    PyTorch's default scheme (a third of the variance per layer) the
    randomly initialized VGG16 encoder passes a much weaker signal and
    learns more slowly (the learning check of ``chip_smoke.py``)."""
    import math

    with torch.no_grad():
        for mod in model.modules():
            _norm_defaults(mod)
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                torch.nn.Linear)):
                w = mod.weight
                cin = w.shape[0] if isinstance(
                    mod, torch.nn.ConvTranspose2d) else w.shape[1]
                taps = w[0, 0].numel()
                std = math.sqrt(1.0 / (cin * taps)) / _TRUNC_STD
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


__all__ = [
    "TernausNet11",
    "TernausNet16",
    "MultiFrameHead",
    "MultiFrameNet",
    "MultiFrameSegmenter",
    "OUTPUT_MODES",
    "get_multiframe_segmentation_model",
    "get_tooltip_segmentation_model",
    "init_weights",
    "init_weights_lecun",
]
