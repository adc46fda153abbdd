"""Serving: ``torch.export`` inference artifacts and the engine that
tracks from them (counterpart of ``mfcnet_tpu/serve``)."""

from mfcnet_tpu_torch.serve.engine import ArtifactEngine
from mfcnet_tpu_torch.serve.export import (
    LoadedServing,
    export_incremental,
    export_serving,
    export_singleframe,
    load_exported,
    make_incremental_step,
    make_serving_fn,
    make_singleframe_serving_fn,
    save_exported,
    zero_state,
)

__all__ = [
    "ArtifactEngine",
    "LoadedServing",
    "export_incremental",
    "export_serving",
    "export_singleframe",
    "load_exported",
    "make_incremental_step",
    "make_serving_fn",
    "make_singleframe_serving_fn",
    "save_exported",
    "zero_state",
]
