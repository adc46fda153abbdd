"""``ArtifactEngine``: the video tracker driven by a serving artifact
(counterpart of ``mfcnet_tpu/serve/engine.py``).

It is the live ``InferenceEngine``'s frame loop
(``track/tracker.py::TrackingEngine``: ``reset``, ``step_async``,
``step``, ``num_streams``) with the exported program in place of the model
code and the checkpoint, so ``track_on_frames``, ``track_on_video`` and
``track_on_frame_streams`` take it as their ``engine``. Both artifact kinds
work: the incremental step (the ring state is kept here, between calls)
and the full window (the T newest frames are stacked here, newest first).
The probabilities go through ``track/outputs.py::outputs_from_probs``, the
live engine's own output block, so both decodes work: the host decode, and
the device decode on the ``cc.cu`` kernels. ``num_streams=B`` tracks B
videos in lockstep through one symbolic-batch artifact.
"""

from __future__ import annotations

from mfcnet_tpu_torch.serve.export import (
    LoadedServing,
    load_exported,
    zero_state,
)
from mfcnet_tpu_torch.track.tracker import TrackingEngine

#: header keys that must equal the tracker configuration's fields
_CHECKED = ("input_height", "input_width", "num_input_frames", "num_classes",
            "add_depth_inputs", "add_optflow_inputs")


class ArtifactEngine(TrackingEngine):
    """``artifact``: a path or a :class:`LoadedServing`; ``cfg``: the
    ``TrackerConfig``, whose shapes and input flags must match the
    artifact's header. The artifact runs on the device it was exported
    for; frames and outputs are moved there and stay there. With
    ``num_streams`` B > 1, ``step_async`` takes (B, H, W, 3) stacks (and
    (B, H, W) depth) and returns (B, ...) outputs; with one stream it takes
    one (H, W, 3) frame and returns unbatched outputs. The first T-1 frames
    of a stream return None, as in the live engine."""

    def __init__(self, artifact, cfg, num_streams: int = 1):
        cfg.check_ported()
        loaded = (artifact if isinstance(artifact, LoadedServing)
                  else load_exported(artifact))
        meta = loaded.meta
        for key in _CHECKED:
            want = getattr(cfg, key)
            if key in meta and meta[key] != want:
                raise ValueError(f"artifact {key}={meta[key]} != config "
                                 f"{want}")
        if meta.get("task", "multiframe") != "multiframe":
            raise ValueError(f"a {meta['task']} artifact: the multi-frame "
                             "tracker serves multi-frame artifacts")
        self.mode = meta.get("serving_mode", "full")
        if meta.get("add_optflow_inputs") and self.mode != "full":
            # a full artifact computes the flow in its graph from its own
            # window; there is no incremental artifact with flow
            raise ValueError("flow-in-graph artifacts are 'full'-forward "
                             "only")
        self.cfg = cfg
        self._loaded = loaded
        self.device = loaded.device
        self.num_streams = max(1, int(num_streams))
        self.reset()

    def _reset_state(self):
        self._state = (zero_state(self._loaded.meta, self.num_streams)
                       if self.mode == "incremental" else None)

    def _incremental(self, frame, depth, ready):
        inputs = [frame] if depth is None else [frame, depth]
        *self._state, probs = self._loaded(*self._state, *inputs)
        return probs if ready else None

    def _window(self, frames, depth):
        return self._loaded(*([frames] if depth is None else [frames, depth]))
