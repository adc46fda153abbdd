"""The port's multi-stream tracker (``InferenceEngine(num_streams=B)``,
``track_on_frame_streams``, the CLI's ``--parallel_videos``) on the CPU:
each stream's rows equal its own single-stream run and the JAX package's
``track_on_frame_streams`` on the same weights (converted with
``compat.torch_convert``), in both engine modes and both decodes, with
streams of unequal length, with the RAFT provider and through the CLI.

Tolerances: CSV rows exactly equal (float32, the same operations on each
stream's rows); per-step outputs of the RAFT engine: class masks equal,
float16 heats within 1e-3 (the heatmap gate of BASELINE.json). The
CUDA-marked cases (a 4-stream engine, and a Large engine) hold the
engine through the kernels against the engine through the plain versions
on the card, each with its tolerance stated beside it. ``stream_shards``
(the stream axis over devices): a 4-stream engine split over two devices
gives the unsharded engine's outputs bit for bit on two CPU devices, and
on ``cuda:0`` twice (the CUDA-marked case, float32 with TF32 off) within
the north star's gates."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H, W, T, C = 64, 32, 3, 5
SCALE = 1 / 16


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the tracker's paths swapped for its plain version
    (on the same CUDA tensors): the decode's ``cc.cu`` kernels, the flow
    warp and the RAFT update step."""
    from unittest import mock

    from mfcnet_tpu_torch.models import mfcnet
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track import decode_device as dd

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.multiple(
            cc, connected_components=cc.connected_components_plain,
            flood_cc_cid=cc.flood_cc_cid_plain,
            union_flood_cc_cid=cc.union_flood_cc_cid_plain,
            onehot_stats=cc.onehot_stats_plain))
        stack.enter_context(mock.patch.object(
            dd, "connected_components", cc.connected_components_plain))
        stack.enter_context(mock.patch.object(
            raft_update, "raft_update", raft_update.raft_update_plain))
        stack.enter_context(mock.patch.object(mfcnet, "flow_warp",
                                              warp.flow_warp_plain))
        yield


@pytest.fixture(scope="module")
def model():
    """Lecun-normal weights (the JAX package's init) from a seed whose
    class maps hold bases and tips on these frames: the rows compared are
    not all NaN."""
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights_lecun,
    )

    m = get_multiframe_segmentation_model("TernausNetMulti-Basic", C, T,
                                          scale=SCALE)
    return init_weights_lecun(m, torch.Generator().manual_seed(2))


def _cfg(**kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    return TrackerConfig(num_input_frames=T, num_classes=C, input_height=H,
                         input_width=W, dtype="float32", overlay=False, **kw)


def _streams(lengths, seed):
    from mfcnet_tpu.data.synthetic import make_synthetic_frames

    return [make_synthetic_frames(num_frames=n, height=H, width=W,
                                  seed=seed + b)
            for b, n in enumerate(lengths)]


def _singles(streams, model, cfg, out):
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    return [track_on_frames(s, model, cfg, out / f"r{b}", name=f"s{b}",
                            device="cpu")[0]
            for b, s in enumerate(streams)]


@pytest.mark.parametrize("mode,decode", [
    ("incremental", "host"), ("incremental", "device"),
    ("full", "host"), ("full", "device"),
])
def test_streams_equal_single_stream_runs(tmp_path, model, mode, decode):
    """B = 2 streams through one engine, as lists and as prestacked
    (B, H, W, 3) batches: each stream's rows and CSV are its own run's."""
    from mfcnet_tpu_torch.track.tracker import track_on_frame_streams

    cfg = _cfg(mode=mode, decode=decode, fetch_batch=3)
    streams = _streams((7, 7), seed=9)
    refs = _singles(streams, model, cfg, tmp_path)
    names = ["s0", "s1"]
    got, fps = track_on_frame_streams(streams, model, cfg, tmp_path / "m",
                                      names=names, device="cpu")
    assert fps > 0
    stacked = [np.stack([s[i] for s in streams]) for i in range(7)]
    got2, _ = track_on_frame_streams(stacked, model, cfg, tmp_path / "p",
                                     names=names, prestacked=True,
                                     device="cpu")
    for b, ref in enumerate(refs):
        assert np.isfinite(ref).any()
        np.testing.assert_array_equal(got[b], ref, err_msg=f"stream {b}")
        np.testing.assert_array_equal(got2[b], ref, err_msg=f"stream {b}")
        assert ((tmp_path / "m" / f"s{b}_tracked.csv").read_bytes()
                == (tmp_path / f"r{b}" / f"s{b}_tracked.csv").read_bytes())


def test_streams_unequal_lengths_and_delegation(tmp_path, model):
    """Lengths 7, 4 and 2 (one shorter than the warmup window): the short
    streams are padded by their last frame and the padded steps dropped,
    so each stream's rows are its own run's; one stream (both layouts)
    runs through track_on_frames."""
    from mfcnet_tpu_torch.track.tracker import track_on_frame_streams

    cfg = _cfg(decode="device")
    streams = _streams((7, 4, 2), seed=13)
    refs = _singles(streams, model, cfg, tmp_path)
    got, _ = track_on_frame_streams(streams, model, cfg, tmp_path / "m",
                                    device="cpu")
    for b, (s, ref) in enumerate(zip(streams, refs)):
        assert got[b].shape == (len(s), 12)
        np.testing.assert_array_equal(got[b], ref, err_msg=f"stream {b}")
    one, _ = track_on_frame_streams(streams[:1], model, cfg, tmp_path / "a",
                                    names=["s0"], device="cpu")
    one2, _ = track_on_frame_streams([f[None] for f in streams[0]], model,
                                     cfg, tmp_path / "b", names=["s0"],
                                     prestacked=True, device="cpu")
    np.testing.assert_array_equal(one[0], refs[0])
    np.testing.assert_array_equal(one2[0], refs[0])


def test_streams_match_jax_track_on_frame_streams(tmp_path, model):
    """The port's rows against the JAX package's multi-stream tracker on
    the same weights and frames (unequal lengths, host decode)."""
    from mfcnet_tpu.compat.torch_convert import convert_multiframe_ternausnet
    from mfcnet_tpu.models import get_multiframe_segmentation_model as jget
    from mfcnet_tpu.track.tracker import TrackerConfig as JCfg
    from mfcnet_tpu.track.tracker import track_on_frame_streams as jstreams
    from mfcnet_tpu_torch.track.tracker import track_on_frame_streams

    v = convert_multiframe_ternausnet(
        {k: t.numpy() for k, t in model.state_dict().items()})
    kw = dict(num_input_frames=T, num_classes=C, input_height=H,
              input_width=W, dtype="float32", overlay=False)
    streams = _streams((6, 5), seed=21)
    want, _ = jstreams(streams, jget("TernausNetMulti-Basic", C, T,
                                     scale=SCALE), v, JCfg(**kw),
                       tmp_path / "j")
    got, _ = track_on_frame_streams(streams, model, _cfg(), tmp_path / "p",
                                    device="cpu")
    for b in range(2):
        assert np.isfinite(want[b]).any()
        np.testing.assert_array_equal(got[b], want[b], err_msg=f"stream {b}")


def test_streams_with_raft_equal_single_engines():
    """The RAFT path with B = 2: the feature ring (2, T, h, w, 256), all
    B*(T-1) pairs in one solve, stream-major; each stream's outputs are
    its own engine's, step by step."""
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    S, B = 64, 2
    pm = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, scale=SCALE,
        generator=torch.Generator().manual_seed(3))
    flow = init_weights(RAFT(iters=1, input_hw=(S // 2, S // 2)),
                        torch.Generator().manual_seed(4))
    cfg = TrackerConfig(num_input_frames=T, num_classes=C, input_height=S,
                        input_width=S, dtype="float32",
                        add_optflow_inputs=True)
    frames = np.random.default_rng(6).integers(0, 255, (5, B, S, S, 3),
                                               dtype=np.uint8)
    singles = [InferenceEngine(pm, cfg, flow_model=flow, device="cpu")
               for _ in range(B)]
    multi = InferenceEngine(pm, cfg, flow_model=flow, device="cpu",
                            num_streams=B)
    for t in range(5):
        refs = [singles[b].step(frames[t, b]) for b in range(B)]
        got = multi.step(frames[t])
        assert (got is None) == (refs[0] is None) == (t < T - 1)
        if got is None:
            continue
        assert multi.flow_state[0].shape[:2] == (B, T)
        for b in range(B):
            np.testing.assert_array_equal(got[0][b], refs[b][0])
            np.testing.assert_allclose(got[1][b].astype(np.float32),
                                       refs[b][1].astype(np.float32),
                                       rtol=0, atol=1e-3)


def test_stream_shards_refused(model):
    """What ``stream_shards`` still refuses: streams that do not split
    evenly over the shards (the JAX package's error), a device list of
    another length, and the card's default devices where there are fewer
    cards than shards."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    with pytest.raises(ValueError, match="divisible by stream_shards"):
        InferenceEngine(model, _cfg(), device="cpu", num_streams=3,
                        stream_shards=2)
    with pytest.raises(ValueError, match="needs 2 devices"):
        InferenceEngine(model, _cfg(), device="cpu", num_streams=2,
                        stream_shards=2, devices=("cpu",))
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            InferenceEngine(model, _cfg(), num_streams=2, stream_shards=2)


def _sharded_against_unsharded(model, cfg, devices, frames, heat_tol=0.0):
    """Each step of a 4-stream engine split into 2 shards on ``devices``
    against the one-device 4-stream engine: the same outputs, in stream
    order, bit for bit (``heat_tol`` 0) or with the heats within
    ``heat_tol``. Returns (the one-device engine, the sharded one)."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    whole = InferenceEngine(model, cfg, device=devices[0], num_streams=4)
    split = InferenceEngine(model, cfg, device=devices[0], num_streams=4,
                            stream_shards=2, devices=devices)
    assert [e.num_streams for e in split.engines] == [2, 2]
    for t, f in enumerate(frames):
        want, got = whole.step(f), split.step(f)
        assert (got is None) == (want is None) == (t < T - 1)
        if want is None:
            continue
        if heat_tol:
            np.testing.assert_allclose(got[-1].astype(np.float32),
                                       want[-1].astype(np.float32), rtol=0,
                                       atol=heat_tol)
        else:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    return whole, split


def _rows(engine, cfg, frames, out):
    from mfcnet_tpu_torch.track import tracker

    return tracker._track_streams(
        ((f, None, range(4)) for f in frames), [len(frames)] * 4,
        [f"s{b}" for b in range(4)], engine, cfg, out)[0]


@pytest.mark.parametrize("mode,decode", [("incremental", "device"),
                                         ("full", "host")])
def test_stream_shards_rows_equal_unsharded(tmp_path, model, mode, decode):
    """``stream_shards=2`` over two CPU devices: each step's outputs equal
    the unsharded 4-stream engine's, and the tracker's rows through it
    equal each stream's own run."""
    cfg = _cfg(mode=mode, decode=decode)
    streams = _streams((5, 5, 5, 5), seed=3)
    frames = [np.stack([s[i] for s in streams]) for i in range(5)]
    _, split = _sharded_against_unsharded(model, cfg, ("cpu", "cpu"),
                                          frames)
    rows = _rows(split, cfg, frames, tmp_path / "m")
    for b, ref in enumerate(_singles(streams, model, cfg, tmp_path)):
        np.testing.assert_array_equal(rows[b], ref, err_msg=f"stream {b}")


@pytest.mark.cuda
def test_cuda_stream_shards_equal_unsharded(model, tmp_path):
    """The same on the card, both shards on ``cuda:0`` (one card), float32
    with TF32 off and device decode: the kernels run on each shard's 2
    streams. cuDNN may sum a batch of 2 in another order than a batch of
    4, so the outputs are held to the north star's gates (BASELINE.json):
    heats within 1e-3, and the tracker's rows the same detections within
    0.5 px tip RMSE."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.utils.profiling import parity_mode

    cfg = _cfg(decode="device", decode_tie_fallback=False)
    frames = np.random.default_rng(0).integers(0, 255, (5, 4, H, W, 3),
                                               dtype=np.uint8)
    with parity_mode():
        engines = _sharded_against_unsharded(
            model, cfg, ("cuda:0", "cuda:0"), frames, heat_tol=1e-3)
        whole, split = (_rows(e, cfg, frames, tmp_path / str(i))
                        for i, e in enumerate(engines))
    for a, b in zip(whole, split):
        assert (np.isnan(a) == np.isnan(b)).all()
        both = np.isfinite(a[:, :8])
        if both.any():
            assert np.sqrt(np.mean((a[:, :8][both] - b[:, :8][both]) ** 2)
                           ) <= 0.5


def test_cli_parallel_videos_writes_the_sequential_csvs(tmp_path):
    """--parallel_videos 2 over three videos (a group of 2, then one of 1,
    unequal lengths) writes the sequential run's CSVs byte for byte."""
    from mfcnet_tpu.data.synthetic import make_synthetic_video
    from mfcnet_tpu_torch.cli.test_multiframe_segmentation_on_videos import (
        main,
    )
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    for i, n in enumerate((6, 5, 4)):
        make_synthetic_video(tmp_path / "vids" / f"v{i}.mp4", num_frames=n,
                             height=32, width=32, seed=3 + i)
    m = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=0.1,
        generator=torch.Generator().manual_seed(0))
    ck = tmp_path / "model.pth"
    torch.save({"model": m.state_dict(), "epoch": 1}, ck)
    common = ["--videos_dir", str(tmp_path / "vids"),
              "--expt_savedir", str(tmp_path),
              "--model_type", "TernausNetMulti-Basic",
              "--load_wts_model", str(ck), "--input_height", "32",
              "--input_width", "32", "--model_scale", "0.1",
              "--compute_dtype", "float32", "--device", "cpu"]
    main(common + ["--expt_name", "seq"])
    fps = main(common + ["--expt_name", "par", "--parallel_videos", "2"])
    assert len(fps) == 2
    for i in range(3):
        rel = Path("video_tracking_results") / f"v{i}_tracked.csv"
        seq = (tmp_path / "seq" / rel).read_bytes()
        assert seq == (tmp_path / "par" / rel).read_bytes(), f"v{i}"
        assert (tmp_path / "par" / rel.with_suffix(".mp4")).exists()


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_four_streams_through_kernels_match_plain_versions():
    """A bf16 engine with RAFT, num_streams=4 and device decode on the
    card against the same engine with every kernel swapped for its plain
    version: the kernels run at the batched shapes (the update step over
    4*(T-1) pairs, the decode over 4 images and 16 masks), and the
    keypoint rows of the decode and the heats agree (heats within 2^-10:
    bf16 roundings flipped by sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    B = 4
    gen = torch.Generator().manual_seed(0)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, add_optflow_inputs=True, scale=0.25,
        generator=gen)
    cfg = TrackerConfig(input_height=128, input_width=160, decode="device",
                        decode_tie_fallback=False, overlay=False,
                        add_optflow_inputs=True)
    flow = init_weights(RAFT(iters=4), gen)
    frames = np.random.default_rng(0).integers(0, 255, (5, B, 128, 160, 3),
                                               dtype=np.uint8)
    engine = InferenceEngine(model, cfg, flow_model=flow, num_streams=B)
    plain = InferenceEngine(model, cfg, flow_model=flow, num_streams=B)
    for mod in (cc, raft_update, warp):
        mod.reset_launches()
    outs = [engine.step_async(f) for f in frames]
    fused = len(frames) - (T - 1)
    assert raft_update.LAUNCHES["raft_update"] == 4 * fused
    assert warp.LAUNCHES["flow_warp"] == fused
    assert cc.LAUNCHES["onehot_stats"] > 0
    with plain_kernels():
        want = [plain.step_async(f) for f in frames]
    for got, ref in zip(outs[T - 1:], want[T - 1:]):
        assert got[1].shape == (B, 2, 3, 3)
        torch.testing.assert_close(got[2].float(), ref[2].float(), rtol=0,
                                   atol=2.0 ** -10)


@pytest.mark.cuda
def test_cuda_large_engine_through_kernels_matches_plain_versions():
    """A bf16 Large engine with RAFT (fused update step) and device decode
    on the card against the same engine with every kernel swapped for its
    plain version: no flow warp is launched, the update step and the
    decode's kernels are; the flow the head reads agrees within 0.1 px (a
    flipped bf16 rounding in the update step moves it by a few hundredths)
    and the heats within 2^-8 and one float16 step near 0.2, 2^-13: the
    head reads the flow raw, about 0.15 of a probability per px
    (``chip_smoke.py``'s LARGE_PROB_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.models import (
        get_multiframe_segmentation_model,
        init_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.ops import cc, raft_update, warp
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, TrackerConfig

    gen = torch.Generator().manual_seed(0)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Large", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=0.25, generator=gen)
    cfg = TrackerConfig(input_height=128, input_width=160, decode="device",
                        decode_tie_fallback=False, overlay=False,
                        add_optflow_inputs=True, add_depth_inputs=True)
    flow = init_weights(RAFT(iters=4), gen)
    frames = np.random.default_rng(0).integers(0, 255, (5, 128, 160, 3),
                                               dtype=np.uint8)
    engine = InferenceEngine(model, cfg, flow_model=flow)
    plain = InferenceEngine(model, cfg, flow_model=flow)
    flows = {id(engine): [], id(plain): []}
    for e in (engine, plain):
        def fuse(seg, optflow=None, depth=None, _e=e,
                 _fuse=e.model.fuse_nchw):
            flows[id(_e)].append(optflow.float())
            return _fuse(seg, optflow=optflow, depth=depth)

        e.model.fuse_nchw = fuse
    for mod in (cc, raft_update, warp):
        mod.reset_launches()
    outs = [engine.step_async(f, f[..., 0]) for f in frames]
    assert warp.LAUNCHES["flow_warp"] == 0
    assert raft_update.LAUNCHES["raft_update"] == 4 * len(frames[T - 1:])
    assert cc.LAUNCHES["onehot_stats"] > 0
    with plain_kernels():
        want = [plain.step_async(f, f[..., 0]) for f in frames]
    assert len(flows[id(engine)]) == len(flows[id(plain)]) == len(
        frames) - (T - 1)
    for got, ref in zip(flows[id(engine)], flows[id(plain)]):
        # a flow field, not one that no limit of 0.1 px could tell apart
        assert ref.abs().max().item() > 5 * 0.1
        torch.testing.assert_close(got, ref, rtol=0, atol=0.1)
    for got, ref in zip(outs[T - 1:], want[T - 1:]):
        torch.testing.assert_close(got[2].float(), ref[2].float(), rtol=0,
                                   atol=2.0 ** -8 + 2.0 ** -13)
