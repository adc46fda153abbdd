"""Model registry (counterpart of ``mfcnet_tpu/models/__init__.py``).

Builds ``TernausNetMulti-Basic`` and ``TernausNetMulti-Large`` (with or
without flow and depth inputs) and the single-frame ``TernausNet16``;
every other model type the JAX package knows raises an error that names
its ROADMAP item.
"""

from __future__ import annotations

import torch

from mfcnet_tpu_torch.models.common import VGG16_STAGES
from mfcnet_tpu_torch.models.mfcnet import (
    MultiFrameHead,
    MultiFrameNet,
    MultiFrameSegmenter,
)
from mfcnet_tpu_torch.models.ternausnet import TernausNet16

_VARIANTS = {"TernausNetMulti-Basic": "basic",
             "TernausNetMulti-Large": "large"}
_ZOO = "ROADMAP.md Queue 1 item 10 (rest of the model zoo)"
_KNOWN_FAMILIES = ("TernausNetMulti", "DeepLabMulti", "FCNMulti",
                   "SegFormerMulti", "HRNetMulti", "UNetMulti",
                   "ResUNetMulti")


def _scaled_vgg(stages, scale: float):
    return tuple(
        tuple(max(4, int(c * scale)) for c in stage) for stage in stages
    )


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
    head's first conv by T channels. ``scale`` < 1 shrinks the channel widths as in the JAX registry;
    ``generator`` seeds the random initialization (PyTorch's default
    init schemes, drawn from this generator)."""
    if model_type not in _VARIANTS:
        family = model_type.rsplit("-", 1)[0]
        if family in _KNOWN_FAMILIES:
            raise NotImplementedError(f"{model_type}: {_ZOO}")
        raise ValueError(f"Model type {model_type} not recognized")
    base = TernausNet16(
        num_classes=num_classes,
        num_filters=max(4, int(64 * scale)),
        stage_convs=_scaled_vgg(VGG16_STAGES, scale),
    )
    model = MultiFrameSegmenter(base, num_classes, num_input_frames,
                                variant=_VARIANTS[model_type],
                                add_depth_inputs=add_depth_inputs,
                                add_optflow_inputs=add_optflow_inputs)
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


def get_tooltip_segmentation_model(model_type: str, num_classes: int,
                                   scale: float = 1.0,
                                   generator: torch.Generator | None = None
                                   ) -> TernausNet16:
    """A single-frame model by the reference's model-type string:
    TernausNet16 (the base of TernausNetMulti, trained first and loaded
    with ``--load_wts_base_model``); every other type raises."""
    if model_type != "TernausNet16":
        raise NotImplementedError(f"{model_type}: {_ZOO}")
    model = TernausNet16(num_classes=num_classes,
                         num_filters=max(4, int(64 * scale)),
                         stage_convs=_scaled_vgg(VGG16_STAGES, scale))
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


def init_weights(model: torch.nn.Module, generator: torch.Generator):
    """Re-draw every conv weight and bias from ``generator`` with
    PyTorch's default schemes (kaiming-uniform(a=sqrt(5)) weights,
    fan-in uniform biases; BatchNorm keeps weight 1, bias 0), so a seed
    fixes the whole model."""
    import math

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
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
    """Re-draw every conv and deconv weight as the JAX package's flax
    modules initialize theirs (``lecun_normal``: a normal truncated at two
    standard deviations with variance 1 / fan-in, fan-in = input channels
    x kernel taps) and zero every bias; BatchNorm keeps weight 1, bias 0.
    The training CLIs start from it, as the JAX trainer does: under
    PyTorch's default scheme (a third of the variance per layer) the
    randomly initialized VGG16 encoder passes a much weaker signal and
    learns more slowly (the learning check of ``chip_smoke.py``)."""
    import math

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = mod.weight
                cin = w.shape[1] if isinstance(mod, torch.nn.Conv2d) \
                    else w.shape[0]
                std = math.sqrt(1.0 / (cin * w[0, 0].numel())) / _TRUNC_STD
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


__all__ = [
    "TernausNet16",
    "MultiFrameHead",
    "MultiFrameNet",
    "MultiFrameSegmenter",
    "get_multiframe_segmentation_model",
    "get_tooltip_segmentation_model",
    "init_weights",
    "init_weights_lecun",
]
