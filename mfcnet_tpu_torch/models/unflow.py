"""UnFlow (FlowNet-CSS) optical flow (counterpart of
``mfcnet_tpu/models/unflow.py``; reference models/unflow_model.py): a flow
provider without per-image encoders that an engine could keep.

One ``ComplexNet`` (siamese conv encoder + the 441-channel correlation
cost volume) followed by two ``SimpleNet`` refinements that consume
[first, second, flow, warp(second, flow), |first - warp|]. All quirks of
the reference are kept: asymmetric ``ZeroPad2d`` paddings before VALID
convolutions, LeakyReLU(0.1), the border-padded backward warp with
``align_corners=False``, one bias-free stride-2 deconvolution applied
twice with replicate padding on the right and bottom, the x20 flow
scaling, and the BGR flip and mean subtraction on whatever the caller
passes (the tracker passes ImageNet-normalized frames).

Module names are the reference checkpoint's
(``moduleFlownets.{0,1,2}.module{One,Two,Thr,...}``, convolutions at the
reference's ``Sequential`` indices), so the reference ``.pth`` loads with
``load_state_dict`` directly.

Public methods take and return the JAX package's NHWC layout. Inside, the
convolutions run NCHW in ``channels_last`` memory format, so the
(B, H, W, C) views that the correlation kernel reads and writes are views
without a copy. The cost volume is the hand-written kernel of
``ops/correlation.py`` and the backward warp that of ``ops/warp.py``
(``backward_warp``: one launch that reads the ``channels_last`` frame and
flow in place and writes a ``channels_last`` result) on CUDA tensors.

Sizes: the pyramid halves the image six times and the decoder
concatenates each level with the one above doubled, so H and W must be
multiples of 64 (the tracker runs the provider at half resolution: 128 at
full resolution). Other sizes raise a ``ValueError``; the JAX package
fails on them in its decoder's concatenation.

Types: the network computes in float32 whatever type it is cast to, as
the JAX package's does: there a bfloat16 model's float32 channel means
promote its bfloat16 input to float32 before the first convolution, and
float32 activations then promote every bfloat16 kernel. So a cast to
bfloat16 (or float16), as a bfloat16 engine makes of its provider, rounds
the parameters to that type once and keeps them in float32, and the input
is rounded to that type before the float32 means are subtracted; the cost
volume, the flows and the backward warp are float32. Cast after loading
weights: a later load stores them unrounded. The result is float32.
"""

from __future__ import annotations

import torch
from torch import nn

from mfcnet_tpu_torch.ops.correlation import correlation_cost_volume
from mfcnet_tpu_torch.ops.warp import backward_warp as warp_by_flow

# UnFlow BGR channel means / 255 (reference models/unflow_model.py:253-259)
_MEANS_BGR = (104.920005 / 255.0, 110.175300 / 255.0, 114.785955 / 255.0)

#: H and W must be multiples of this (six halvings)
SIZE_MULTIPLE = 64


def _lrelu():
    return nn.LeakyReLU(0.1)


def _pad_conv(cin, cout, kernel, stride, pad_lrtb):
    """ZeroPad2d([l, r, t, b]) + Conv2d(kernel, stride, VALID) +
    LeakyReLU: the conv sits at index 1, as in the reference."""
    return nn.Sequential(nn.ZeroPad2d(list(pad_lrtb)),
                         nn.Conv2d(cin, cout, kernel, stride), _lrelu())


def _down_pair(cin, cout):
    """Stride-2 then stride-1 3x3 conv (indices 1 and 3)."""
    return nn.Sequential(
        nn.ZeroPad2d([0, 2, 0, 2]), nn.Conv2d(cin, cout, 3, 2), _lrelu(),
        nn.Conv2d(cout, cout, 3, 1, 1), _lrelu())


def backward_warp(img, flow):
    """Border-padded bilinear warp (reference models/unflow_model.py:6-17;
    ``grid_sample``'s default ``align_corners=False`` on a
    ``linspace(-1, 1)`` base grid). img (B, C, H, W); flow (B, 2, H, W) in
    pixels, channel 0 = x. Returns (B, C, H, W) in ``img``'s type and
    memory format."""
    return warp_by_flow(img, flow, align_corners=False,
                        padding_mode="border")


def _deconv(cin, cout):
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1)


class Upconv(nn.Module):
    """Flow-pyramid decoder (reference models/unflow_model.py:25-88)."""

    def __init__(self):
        super().__init__()
        self.moduleSixOut = nn.Conv2d(1024, 2, 3, 1, 1)
        self.moduleSixUp = _deconv(2, 2)
        self.moduleFivNext = nn.Sequential(_deconv(1024, 512), _lrelu())
        self.moduleFivOut = nn.Conv2d(1026, 2, 3, 1, 1)
        self.moduleFivUp = _deconv(2, 2)
        self.moduleFouNext = nn.Sequential(_deconv(1026, 256), _lrelu())
        self.moduleFouOut = nn.Conv2d(770, 2, 3, 1, 1)
        self.moduleFouUp = _deconv(2, 2)
        self.moduleThrNext = nn.Sequential(_deconv(770, 128), _lrelu())
        self.moduleThrOut = nn.Conv2d(386, 2, 3, 1, 1)
        self.moduleThrUp = _deconv(2, 2)
        self.moduleTwoNext = nn.Sequential(_deconv(386, 64), _lrelu())
        self.moduleTwoOut = nn.Conv2d(194, 2, 3, 1, 1)
        # one module applied twice: the deconvolution's weights are shared
        self.moduleUpscale = nn.Sequential(
            nn.ConvTranspose2d(2, 2, 3, 2, 1, bias=False),
            nn.ReplicationPad2d([0, 1, 0, 1]))

    def forward(self, conv2, conv3, conv4, conv5, conv6):
        x = conv6
        for skip, out, up, nxt in (
            (conv5, self.moduleSixOut, self.moduleSixUp, self.moduleFivNext),
            (conv4, self.moduleFivOut, self.moduleFivUp, self.moduleFouNext),
            (conv3, self.moduleFouOut, self.moduleFouUp, self.moduleThrNext),
            (conv2, self.moduleThrOut, self.moduleThrUp, self.moduleTwoNext),
        ):
            x = torch.cat([skip, nxt(x), up(out(x))], dim=1)
        flow2 = self.moduleTwoOut(x)
        return self.moduleUpscale(self.moduleUpscale(flow2)) * 20.0


class ComplexNet(nn.Module):
    """Correlation flow net (reference models/unflow_model.py:91-171)."""

    def __init__(self):
        super().__init__()
        self.moduleOne = _pad_conv(3, 64, 7, 2, (2, 4, 2, 4))
        self.moduleTwo = _pad_conv(64, 128, 5, 2, (1, 3, 1, 3))
        self.moduleThr = _pad_conv(128, 256, 5, 2, (1, 3, 1, 3))
        self.moduleRedir = nn.Sequential(nn.Conv2d(256, 32, 1), _lrelu())
        self.moduleCombined = nn.Sequential(nn.Conv2d(473, 256, 3, 1, 1),
                                            _lrelu())
        self.moduleFou = _down_pair(256, 512)
        self.moduleFiv = _down_pair(512, 512)
        self.moduleSix = _down_pair(512, 1024)
        self.moduleUpconv = Upconv()

    def forward(self, first, second):
        # siamese encoder: one set of modules, applied to both images
        n = first.shape[0]
        conv1 = self.moduleOne(torch.cat([first, second]))
        conv2 = self.moduleTwo(conv1)
        conv3 = self.moduleThr(conv2)
        conv2, conv3_first, conv3_second = conv2[:n], conv3[:n], conv3[n:]
        redir = self.moduleRedir(conv3_first)
        # (B, H, W, C) views of the channels_last feature maps; the
        # (B, H, W, 441) cost volume is a channels_last (B, 441, H, W)
        corr = correlation_cost_volume(
            conv3_first.permute(0, 2, 3, 1), conv3_second.permute(0, 2, 3, 1),
            max_displacement=20, stride=2)
        corr = corr.permute(0, 3, 1, 2)
        conv3 = self.moduleCombined(torch.cat([redir, corr], dim=1))
        conv4 = self.moduleFou(conv3)
        conv5 = self.moduleFiv(conv4)
        conv6 = self.moduleSix(conv5)
        return self.moduleUpconv(conv2, conv3, conv4, conv5, conv6)


class SimpleNet(nn.Module):
    """Refinement flow net (reference models/unflow_model.py:174-238)."""

    def __init__(self):
        super().__init__()
        self.moduleOne = _pad_conv(14, 64, 7, 2, (2, 4, 2, 4))
        self.moduleTwo = _pad_conv(64, 128, 5, 2, (1, 3, 1, 3))
        self.moduleThr = nn.Sequential(
            nn.ZeroPad2d([1, 3, 1, 3]), nn.Conv2d(128, 256, 5, 2), _lrelu(),
            nn.Conv2d(256, 256, 3, 1, 1), _lrelu())
        self.moduleFou = _down_pair(256, 512)
        self.moduleFiv = _down_pair(512, 512)
        self.moduleSix = _down_pair(512, 1024)
        self.moduleUpconv = Upconv()

    def forward(self, first, second, flow):
        warp = backward_warp(second, flow)
        x = torch.cat([first, second, flow, warp,
                       (first - warp).abs()], dim=1)
        conv2 = self.moduleTwo(self.moduleOne(x))
        conv3 = self.moduleThr(conv2)
        conv4 = self.moduleFou(conv3)
        conv5 = self.moduleFiv(conv4)
        conv6 = self.moduleSix(conv5)
        return self.moduleUpconv(conv2, conv3, conv4, conv5, conv6)


class UnFlow(nn.Module):
    """CSS stack (reference models/unflow_model.py:241-268).
    ``forward(first, second)``: (B, H, W, 3) RGB images -> (B, H, W, 2)
    float32 flow in pixels; H and W multiples of 64. The BGR flip and the
    mean subtraction are internal."""

    #: the engine checks its half-resolution frame size against this
    size_multiple = SIZE_MULTIPLE

    def __init__(self):
        super().__init__()
        self.moduleFlownets = nn.ModuleList(
            [ComplexNet(), SimpleNet(), SimpleNet()])
        self.register_buffer(
            "means_bgr", torch.tensor(_MEANS_BGR).view(1, 3, 1, 1),
            persistent=False)
        #: the type the input is rounded to (that of the last cast)
        self.input_dtype = torch.float32
        self.to(memory_format=torch.channels_last)

    @staticmethod
    def check_size(h: int, w: int):
        if h % SIZE_MULTIPLE or w % SIZE_MULTIPLE:
            raise ValueError(
                f"UnFlow needs a height and a width that are multiples of "
                f"{SIZE_MULTIPLE} (six halvings, then a decoder that joins "
                f"each level with the one above doubled), got {h}x{w}; the "
                f"tracker runs it at half resolution, so its frames must be "
                f"multiples of {2 * SIZE_MULTIPLE}")

    def _apply(self, fn, recurse=True):
        # a cast to a 16-bit float type rounds the parameters to it and
        # stores them back in float32 (see the module's note on types); the
        # means stay float32 constants (the JAX package's are numpy
        # float32), only their device follows the module
        means = self.means_bgr
        super()._apply(fn, recurse)
        self.means_bgr = means.to(self.means_bgr.device)
        dtype = self.moduleFlownets[0].moduleOne[1].weight.dtype
        if dtype in (torch.bfloat16, torch.float16):
            self.input_dtype = dtype
            super()._apply(
                lambda t: t.float() if t.is_floating_point() else t, recurse)
        return self

    def _prep(self, image):
        """(B, H, W, 3) RGB -> NCHW BGR minus the means, channels_last,
        float32, from the input rounded to :attr:`input_dtype`."""
        x = image.permute(0, 3, 1, 2).flip(1).to(self.input_dtype).float()
        return (x - self.means_bgr).contiguous(
            memory_format=torch.channels_last)

    def forward(self, first, second):
        self.check_size(*first.shape[1:3])
        first, second = self._prep(first), self._prep(second)
        flow = self.moduleFlownets[0](first, second)
        flow = self.moduleFlownets[1](first, second, flow)
        flow = self.moduleFlownets[2](first, second, flow)
        return flow.permute(0, 2, 3, 1)


def he_init_weights(model: UnFlow, generator: torch.Generator,
                    flow_gain: float = 1.0 / 200.0):
    """Seeded weights under which a random UnFlow gives flows of a few
    pixels that depend on the frames: normal, variance 2 / fan-in (a
    stride-2 deconvolution counting the taps that reach one output), zero
    biases, which keeps activations O(1) through the ~75 LeakyReLU layers;
    each network's last flow convolution is scaled by ``flow_gain`` against
    the x20 at its end, so that the flow does not grow from one network of
    the stack to the next. The flow grows with the frame: 1/200 gives ~6 px
    on 512x640 frames (1/20 gave chaotic flows of over a hundred pixels
    there), 1/20 gives ~1 px on 64x64 noise.
    PyTorch's default initialization shrinks every layer, and the flow is
    then the last biases' constant, whatever the frames show: weights for
    a smoke run or a test have to come from here."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.ConvTranspose2d):
                taps = (mod.kernel_size[0] / mod.stride[0]) ** 2
                fan_in = mod.in_channels * taps
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] ** 2
            else:
                continue
            mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                               generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        for net in model.moduleFlownets:
            net.moduleUpconv.moduleTwoOut.weight.mul_(flow_gain)
    return model


def make_unflow_flow_fn(basic: bool = True, model: UnFlow | None = None):
    """Frozen UnFlow provider with the engine's frame-pair convention:
    ``flow_fn(frames)`` maps (B, T, H, W, 3) frames, newest first, to
    (B, T-1, H, W, 2) flow, all T-1 pairs in one batched forward. With
    ``basic`` the pair is (earlier, newest), otherwise (newest, earlier).
    ``model``: an :class:`UnFlow` (default: a new one with PyTorch's
    initialization)."""
    from mfcnet_tpu_torch.ops.pairs import repeat_for_pairs

    model = (UnFlow() if model is None else model).eval()

    @torch.no_grad()
    def flow_fn(frames):
        B, T, H, W, _ = frames.shape
        rest = frames[:, 1:].reshape(B * (T - 1), H, W, 3)
        f0 = repeat_for_pairs(frames[:, 0], T - 1)
        a, b = (rest, f0) if basic else (f0, rest)
        return model(a, b).reshape(B, T - 1, H, W, 2)

    return flow_fn
