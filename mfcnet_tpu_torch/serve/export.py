"""Serving artifacts (counterpart of ``mfcnet_tpu/serve/export.py``):
``torch.export`` programs of the inference functions with the weights in
them, saved to one file that a process loads and runs without the model
code or a checkpoint.

Three serving functions, each an ``nn.Module`` that holds copies of the
models cast to the compute dtype. They are the one definition of what a
frame goes through: the live engines run the same modules
(``track/tracker.py::InferenceEngine`` the window's and the incremental
step's, the single-frame video CLI's engine the single-frame one), so live
and artifact serving cannot drift:

- :func:`make_serving_fn`, the full window: (B, T, H, W, 3) uint8 frames,
  newest first (and (B, T, H, W) uint8 depth), -> (B, H, W, C) float32
  softmax, with the flow provider in the graph when one is given;
- :func:`make_incremental_step`, one frame of the incremental tracker: the
  ring state in the live engine's own layout (seg_buf (B, T*C, H, W),
  depth_buf (B, T, H, W), ``track/tracker.py``), one base forward a frame;
- :func:`make_singleframe_serving_fn`, a single-frame model: (B, H, W, 3)
  uint8 -> (B, H, W, C) float32 probabilities, as the single-frame video CLI
  computes them.

A bfloat16 RAFT provider runs its update iterations through the fused
update step, as the live engine does, with its packed weights held as
buffers: the graph then names the registered operators
``mfcnet::raft_update`` and ``mfcnet::flow_warp`` (``ops/raft_update.py``,
``ops/warp.py``), whose CUDA kernels are the hand-written ones. A float32
provider runs the plain update block.

The batch dimension is exported symbolic by default, bounded by
:data:`MAX_BATCH` (``torch.export.Dim("b", min=1, max=MAX_BATCH)``): the
flow path's shape checks need the bound. An integer ``batch`` pins it.
Tensors that the traced code makes on a device are frozen into the graph,
so an artifact runs on the device type it was exported for: on the card
for the card.

Artifact = one file: an 8-byte magic, a JSON header (format, input and
output specs, torch version, device type, and the caller's meta), then the
bytes of ``torch.export.save``. :func:`load_exported` needs only the two
operator registrations of ``mfcnet_tpu_torch.ops``, no model code.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from mfcnet_tpu_torch.track.outputs import flow_for_window, probs_nhwc

_MAGIC = b"MFCNETT1"
#: the JAX package's artifacts (``mfcnet_tpu/serve/export.py``)
_JAX_MAGIC = b"MFCNETX1"
FORMAT = "mfcnet_tpu_torch.serve/1"
#: the largest batch of a symbolic-batch artifact
MAX_BATCH = 64


#: ImageNet normalization of the frames (reference v3's transform)
_MEAN, _STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _depth_unit(depth_u8, dtype):
    """uint8 depth maps -> ``dtype`` in [0, 1]."""
    return depth_u8.to(dtype) / 255.0


def _flow_copy(flow_model, dtype, device):
    """The copy of a flow provider that an engine runs: cast to ``dtype`` on
    ``device``, in eval mode. A RAFT runs its update iterations through the
    fused update step (the CUDA kernel on the card) in bfloat16, with its
    packed update weights held as buffers (``PackedUpdateWeights``), and
    through its plain update block in float32."""
    from mfcnet_tpu_torch.ops.raft_update import PackedUpdateWeights

    flow_model = copy.deepcopy(flow_model).to(device, dtype).eval()
    if hasattr(flow_model, "fused_update"):
        flow_model.fused_update = dtype == torch.bfloat16
        flow_model.fused_dtype = "bfloat16"
        if flow_model.fused_update:
            flow_model.packed_update = PackedUpdateWeights(
                flow_model.update_block, torch.bfloat16)
    return flow_model


def _cdtype(dtype: str):
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute dtype must be bfloat16 or float32, got "
                         f"{dtype!r}")
    return getattr(torch, dtype)


class _Serving(nn.Module):
    """A model copy cast to the compute dtype on ``device``, the
    normalization constants and, when given, the flow provider's copy
    (:func:`_flow_copy`)."""

    def __init__(self, model, dtype: str, device, flow_model=None):
        super().__init__()
        self.cdt = _cdtype(dtype)
        self.model = copy.deepcopy(model).to(device, self.cdt).eval()
        for name, v in (("mean", _MEAN), ("std", _STD)):
            self.register_buffer(name, torch.tensor(
                v, dtype=self.cdt, device=device).view(1, 3, 1, 1))
        self.flow_model = (None if flow_model is None
                           else _flow_copy(flow_model, self.cdt, device))

    def normalize(self, frames_u8):
        """(N, H, W, 3) uint8 -> (N, 3, H, W) in the compute dtype: /255,
        then ImageNet mean and std."""
        x = frames_u8.permute(0, 3, 1, 2).to(self.cdt) / 255.0
        return (x - self.mean) / self.std


class WindowServing(_Serving):
    """The full window's forward (:func:`make_serving_fn`); the live
    engine's full mode runs :meth:`logits` too."""

    def __init__(self, model, dtype, add_depth_inputs, flow_model, device):
        super().__init__(model, dtype, device, flow_model)
        self.add_depth_inputs = bool(add_depth_inputs)

    def logits(self, frames_u8, depth_u8=None):
        """(B, T, H, W, 3) uint8 frames, newest first (and (B, T, H, W)
        uint8 depth) -> (B, C, H, W) logits of the fusion head."""
        B, T, H, W, _ = frames_u8.shape
        x = self.normalize(frames_u8.reshape(B * T, H, W, 3))
        y = self.model.base_nchw(x)
        depth = (_depth_unit(depth_u8, self.cdt) if self.add_depth_inputs
                 else None)
        optflow = (flow_for_window(x.reshape(B, T, 3, H, W),
                                   self.flow_model)
                   if self.flow_model is not None else None)
        return self.model.fuse_nchw(y.reshape(B, T * y.shape[1], H, W),
                                    optflow=optflow, depth=depth)

    def forward(self, frames_u8, depth_u8=None):
        return probs_nhwc(self.logits(frames_u8, depth_u8))


class IncrementalStep(_Serving):
    """One incremental tracking step without depth:
    ``(seg_buf, frame_u8) -> (seg_buf', probs)``. The live engine's
    incremental mode runs :meth:`ingest` and :meth:`fuse` too, with its
    flow provider's ring between them."""

    def __init__(self, model, dtype, num_frames, num_classes, device,
                 flow_model=None):
        super().__init__(model, dtype, device, flow_model)
        self.T, self.C = int(num_frames), int(num_classes)

    def ingest(self, seg_buf, depth_buf, frame_u8, depth_u8):
        """One (B, H, W, 3) uint8 frame into the rings: its base forward
        into seg_buf, its (B, H, W) uint8 depth into depth_buf (None: no
        depth), both newest first. Returns (the normalized frame, seg_buf',
        depth_buf')."""
        T, C = self.T, self.C
        x = self.normalize(frame_u8)
        seg_buf = torch.cat([self.model.base_nchw(x),
                             seg_buf[:, : (T - 1) * C]], dim=1)
        if depth_buf is not None:
            depth_buf = torch.cat([_depth_unit(depth_u8, self.cdt)[:, None],
                                   depth_buf[:, : T - 1]], dim=1)
        return x, seg_buf, depth_buf

    def fuse(self, seg_buf, depth_buf, optflow=None):
        """The fusion head on the rings: (B, C, H, W) logits."""
        return self.model.fuse_nchw(seg_buf, optflow=optflow,
                                    depth=depth_buf)

    def forward(self, seg_buf, frame_u8):
        _, seg_buf, _ = self.ingest(seg_buf, None, frame_u8, None)
        return seg_buf, probs_nhwc(self.fuse(seg_buf, None))


class IncrementalDepthStep(IncrementalStep):
    """One incremental tracking step with depth: ``(seg_buf, depth_buf,
    frame_u8, depth_u8) -> (seg_buf', depth_buf', probs)``."""

    def forward(self, seg_buf, depth_buf, frame_u8, depth_u8):
        _, seg_buf, depth_buf = self.ingest(seg_buf, depth_buf, frame_u8,
                                            depth_u8)
        return seg_buf, depth_buf, probs_nhwc(self.fuse(seg_buf, depth_buf))


class SingleFrameServing(_Serving):
    """A single-frame model's probabilities
    (:func:`make_singleframe_serving_fn`)."""

    def __init__(self, model, output_mode, dtype, device):
        super().__init__(model, dtype, device)
        self.output_mode = output_mode

    def forward(self, frames_u8):
        """(B, H, W, 3) uint8 -> (B, H, W, C) float32: a log-softmax in
        the compute dtype for a base that gives logits, then exp in
        float32."""
        out = self.model(self.normalize(frames_u8))
        if self.output_mode == "logits":
            out = torch.nn.functional.log_softmax(out, dim=1)
        return torch.exp(out.float()).permute(0, 2, 3, 1)


def make_serving_fn(model, *, dtype: str = "bfloat16",
                    add_depth_inputs: bool = False, flow_model=None,
                    device="cuda") -> WindowServing:
    """The full window's serving function ``fn(frames_u8[, depth_u8]) ->
    probs``: frames (B, T, H, W, 3) uint8 RGB, newest first (the reference
    stacks its window newest first, test_multiframe_segmentation_on_videos_
    v3.py:251-259), depth (B, T, H, W) uint8 with ``add_depth_inputs``;
    returns (B, H, W, C) float32 softmax probabilities. ``flow_model``: a
    flow provider computed in the graph from the window (the live engine's
    full mode, ``track/outputs.py::flow_for_window``). On ``device``, the
    card unless the caller passes ``"cpu"``."""
    return WindowServing(model, dtype, add_depth_inputs, flow_model,
                         device).eval()


def make_singleframe_serving_fn(model, output_mode: str,
                                dtype: str = "bfloat16",
                                device="cuda") -> SingleFrameServing:
    """A single-frame model's serving function: (B, H, W, 3) uint8 ->
    (B, H, W, C) float32 probabilities, by ``output_mode``
    (``models.OUTPUT_MODES``): 'log_probs' (TernausNet, SegFormer) or
    'logits' (log-softmax in the compute dtype first), then exp in
    float32. TAPNet is not exportable: its attention-map input comes from
    the host pipeline (``data/attmap.py``), not from the graph."""
    if output_mode not in ("log_probs", "logits"):
        raise ValueError(
            f"output_mode {output_mode!r} not exportable (TAPNet needs the "
            "host attmap pipeline)")
    return SingleFrameServing(model, output_mode, dtype, device).eval()


def make_incremental_step(model, *, height: int, width: int,
                          num_frames: int, num_classes: int,
                          dtype: str = "bfloat16",
                          add_depth_inputs: bool = False, device="cuda"):
    """The incremental tracking step: one base forward per frame into the
    ring of the T newest class maps, then the fusion head (the live
    engine's incremental mode). Returns ``(step, state_spec)``:

    - without depth: ``step(seg_buf, frame_u8) -> (seg_buf', probs)``;
    - with depth: ``step(seg_buf, depth_buf, frame_u8, depth_u8) ->
      (seg_buf', depth_buf', probs)``;

    seg_buf (B, T*C, H, W) (channel order (t, c), newest first), depth_buf
    (B, T, H, W), both in the compute dtype; frames (B, H, W, 3) and depth
    (B, H, W) uint8. ``state_spec`` maps each buffer to (shape with a None
    batch, dtype name). Start a stream from zeros (:func:`zero_state`) and
    ignore the probabilities of its first T-1 frames."""
    cls = IncrementalDepthStep if add_depth_inputs else IncrementalStep
    step = cls(model, dtype, num_frames, num_classes, device).eval()
    T, C, H, W = num_frames, num_classes, height, width
    state_spec = {"seg_buf": ((None, T * C, H, W), dtype)}
    if add_depth_inputs:
        state_spec["depth_buf"] = ((None, T, H, W), dtype)
    return step, state_spec


def _export(fn, args, batch):
    """``torch.export`` of ``fn`` on ``args`` under ``no_grad``: their
    first dimension symbolic in [1, MAX_BATCH] (``batch`` None) or as
    given."""
    dyn = None
    if batch is None:
        b = torch.export.Dim("b", min=1, max=MAX_BATCH)
        dyn = tuple({0: b} for _ in args)
    with torch.no_grad():
        ep = torch.export.export(fn, tuple(args), dynamic_shapes=dyn)
    # the zero examples would be saved with the program
    ep.example_inputs = None
    return ep


def _example_batch(batch):
    # a symbolic dimension needs an example other than 0 or 1, which
    # torch.export would specialize
    return 2 if batch is None else int(batch)


def _device_of(fn):
    return next(fn.buffers()).device


def export_serving(model, *, height: int, width: int, num_frames: int,
                   dtype: str = "bfloat16", add_depth_inputs: bool = False,
                   flow_model=None, batch: Optional[int] = None,
                   device="cuda"):
    """Export the full window's serving function (:func:`make_serving_fn`).
    Returns the ``torch.export.ExportedProgram``."""
    fn = make_serving_fn(model, dtype=dtype,
                         add_depth_inputs=add_depth_inputs,
                         flow_model=flow_model, device=device)
    B, dev = _example_batch(batch), _device_of(fn)
    args = [torch.zeros(B, num_frames, height, width, 3, dtype=torch.uint8,
                        device=dev)]
    if add_depth_inputs:
        args.append(torch.zeros(B, num_frames, height, width,
                                dtype=torch.uint8, device=dev))
    return _export(fn, args, batch)


def export_singleframe(model, *, height: int, width: int, output_mode: str,
                       dtype: str = "bfloat16", batch: Optional[int] = None,
                       device="cuda"):
    """Export a single-frame model (:func:`make_singleframe_serving_fn`).
    Returns the ``ExportedProgram``."""
    fn = make_singleframe_serving_fn(model, output_mode, dtype=dtype,
                                     device=device)
    args = [torch.zeros(_example_batch(batch), height, width, 3,
                        dtype=torch.uint8, device=_device_of(fn))]
    return _export(fn, args, batch)


def export_incremental(model, *, height: int, width: int, num_frames: int,
                       num_classes: int, dtype: str = "bfloat16",
                       add_depth_inputs: bool = False,
                       batch: Optional[int] = None, device="cuda"):
    """Export the incremental step (:func:`make_incremental_step`).
    Returns ``(ExportedProgram, state_spec)``."""
    step, state_spec = make_incremental_step(
        model, height=height, width=width, num_frames=num_frames,
        num_classes=num_classes, dtype=dtype,
        add_depth_inputs=add_depth_inputs, device=device)
    B, dev = _example_batch(batch), _device_of(step)
    args = [torch.zeros((B,) + tuple(shape[1:]), dtype=_cdtype(dt),
                        device=dev) for shape, dt in state_spec.values()]
    args.append(torch.zeros(B, height, width, 3, dtype=torch.uint8,
                            device=dev))
    if add_depth_inputs:
        args.append(torch.zeros(B, height, width, dtype=torch.uint8,
                                device=dev))
    return _export(step, args, batch), state_spec


def _spec(val):
    """[shape, dtype] of a traced tensor; a symbolic dimension is "b"."""
    return [[d if isinstance(d, int) else "b" for d in val.shape],
            str(val.dtype).removeprefix("torch.")]


def _program_device(exported) -> str:
    """The device type of the program's parameters and buffers (a host
    constant that the graph copies to the device, such as a resize's
    index, does not count)."""
    types = {t.device.type for t in exported.state_dict.values()}
    if len(types) != 1:
        raise ValueError(f"the program's weights lie on {types or 'no'} "
                         "device type(s); an artifact is for one")
    return types.pop()


def save_exported(path, exported, meta: Optional[dict] = None) -> dict:
    """Write the artifact file; returns the full header written."""
    nodes = {n.name: n for n in exported.graph.nodes}
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    n_user = len(exported.graph_signature.user_outputs)
    header = {
        "format": FORMAT,
        "in_specs": [_spec(nodes[name].meta["val"])
                     for name in exported.graph_signature.user_inputs],
        "out_specs": [_spec(n.meta["val"])
                      for n in out_node.args[0][-n_user:]],
        "torch_version": torch.__version__,
        "device": _program_device(exported),
    }
    header.update(meta or {})
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    data = buf.getvalue()
    hdr = json.dumps(header).encode("utf-8")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        f.write(struct.pack("<Q", len(data)))
        f.write(data)
    tmp.replace(path)
    return header


class LoadedServing:
    """A loaded artifact: ``loaded(*inputs) -> outputs``. ``meta`` is the
    JSON header, ``exported`` the ``ExportedProgram``; its module is built
    once. Inputs (host arrays or tensors) go to the header's device
    first."""

    def __init__(self, meta: dict, exported):
        self.meta = meta
        self.exported = exported
        self.device = torch.device(meta["device"])
        self.module = exported.module()

    @torch.no_grad()
    def __call__(self, *args):
        return self.module(*(torch.as_tensor(a).to(self.device)
                             for a in args))


def zero_state(meta: dict, batch: int = 1):
    """Zero ring buffers for an incremental artifact, from its header (the
    start of a stream, as ``InferenceEngine.reset``), on its device."""
    spec = meta.get("state")
    if not spec:
        raise ValueError("not an incremental artifact (no 'state' header)")
    return [torch.zeros(tuple(batch if s is None else s for s in shape),
                        dtype=_cdtype(dt), device=meta["device"])
            for shape, dt in spec.values()]


def load_exported(path, device=None) -> LoadedServing:
    """Load an artifact of :func:`save_exported`. It imports the operator
    registrations of ``mfcnet_tpu_torch.ops`` and nothing of the models.
    ``device``: where the caller means to run it; a device type other than
    the header's is refused, as is a CUDA artifact without a card."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path}: an artifact of the JAX package (jax.export "
                "StableHLO, magic MFCNETX1): load it with "
                "mfcnet_tpu.serve.load_exported")
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an mfcnet_tpu_torch serving "
                             f"artifact (magic {magic!r})")
        try:
            (hlen,) = struct.unpack("<Q", f.read(8))
            meta = json.loads(f.read(hlen).decode("utf-8"))
            (dlen,) = struct.unpack("<Q", f.read(8))
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"{path}: a damaged artifact header ({e})")
        data = f.read(dlen)
    if meta.get("format") != FORMAT or len(data) != dlen:
        raise ValueError(f"{path}: format {meta.get('format')!r} with "
                         f"{len(data)} of {dlen} bytes; this loader reads "
                         f"complete {FORMAT} files")
    where = meta["device"]
    if device is not None and torch.device(device).type != where:
        raise ValueError(
            f"{path} was exported for {where}: an artifact runs on the "
            f"device type it was exported for, not on {device}")
    if where == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for the card and no CUDA "
                           "device is available")
    # the two operators an exported graph may name
    import mfcnet_tpu_torch.ops.raft_update  # noqa: F401
    import mfcnet_tpu_torch.ops.warp  # noqa: F401

    return LoadedServing(meta, torch.export.load(io.BytesIO(data)))
