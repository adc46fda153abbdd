"""``TrackerConfig.fused_dispatch`` on the port: each frame after the warm-up
runs ingest, fusion and outputs as one step, captured as one CUDA graph on
the card and run eagerly on the CPU, with the device decode's tier chosen
by ``ops/graph_cond.py::run_if``.

On the CPU, at 64x64 (UnFlow: 128x128), ``num_filters=4``, float32: the
fused engine's masks, keypoint rows and heats equal the unfused engine's
bit for bit (host and device decode, depth, two streams, two stream
shards, RAFT, TernausNetMulti-Large with RAFT and depth, UnFlow and
FlowFormer++ at small widths); its rows equal the
JAX package's fused engine's and its float16 heats are within 1e-3 of
them (the heatmap gate of BASELINE.json: float32 convolutions in another
order); a reset engine's second video equals a fresh engine's; full mode
ignores the flag; ``track_on_frames``' CSVs are byte-equal; the resize and
RAFT constants that the step needs on the device are bit-equal to the
host-made ones and copy nothing from the host; each decode tier equals the
exact decode and is counted in ``TIER_COUNTS``, its choice one host read
where nothing is captured; and the replay accounting adds the captured
launches and tiers as the card counts them. The CUDA-marked cases run the
captured step on the card."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from torch_threads import _two_torch_threads  # noqa: F401

H = W = 64
UH = UW = 128
T, C = 3, 5
N_FRAMES = 6
STAGES = ((4,), (8,), (8, 8), (16, 16), (16, 16))


def _cfg(**kw):
    from mfcnet_tpu_torch.track.tracker import TrackerConfig

    base = dict(num_input_frames=T, num_classes=C, input_height=H,
                input_width=W, dtype="float32", overlay=False,
                decode="device")
    base.update(kw)
    return TrackerConfig(**base)


@pytest.fixture(scope="module")
def jax_model():
    """(JAX MultiFrameSegmenter, its seeded variables, the port's copy by
    ``compat.from_jax``): the golden tests' narrow TernausNetMulti-Basic."""
    import jax

    from mfcnet_tpu.models import MultiFrameSegmenter, TernausNet16
    from mfcnet_tpu.utils.jitinit import jit_init
    from mfcnet_tpu_torch.compat.from_jax import load_jax_variables
    from mfcnet_tpu_torch.models import MultiFrameSegmenter as PortSeg
    from mfcnet_tpu_torch.models import TernausNet16 as PortTN

    jm = MultiFrameSegmenter(
        base=TernausNet16(num_classes=C, num_filters=4, stage_convs=STAGES),
        num_classes=C, num_frames=T, variant="basic", base_output="exp",
    )
    v = jit_init(jm, jax.random.PRNGKey(42),
                 np.zeros((1, T, H, W, 3), np.float32))
    pm = load_jax_variables(PortSeg(PortTN(C, 4, STAGES), C, T).eval(), v)
    return jm, v, pm


@pytest.fixture(scope="module")
def depth_model():
    from mfcnet_tpu_torch.models import (
        MultiFrameSegmenter,
        TernausNet16,
        init_weights,
    )

    return init_weights(
        MultiFrameSegmenter(TernausNet16(C, 4, STAGES), C, T,
                            add_depth_inputs=True),
        torch.Generator().manual_seed(3)).eval()


@pytest.fixture(scope="module")
def large_model():
    """A narrow TernausNetMulti-Large with flow and depth inputs (its head
    takes the class maps, the raw flows and the depth maps)."""
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model

    return get_multiframe_segmentation_model(
        "TernausNetMulti-Large", C, T, add_optflow_inputs=True,
        add_depth_inputs=True, scale=1 / 16,
        generator=torch.Generator().manual_seed(5)).eval()


@pytest.fixture(scope="module")
def frames():
    from mfcnet_tpu.data.synthetic import make_synthetic_frames

    return make_synthetic_frames(num_frames=N_FRAMES, height=H, width=W,
                                 seed=13)


def _providers():
    """Seeded port flow providers at small widths: RAFT (2 iterations),
    UnFlow (its only widths; frames of 128x128) and FlowFormer++ (narrow,
    1 iteration)."""
    from mfcnet_tpu_torch.models import init_weights
    from mfcnet_tpu_torch.models.flowformerpp import (
        FlowFormerPP,
        init_ffpp_weights,
    )
    from mfcnet_tpu_torch.models.raft import RAFT
    from mfcnet_tpu_torch.models.unflow import UnFlow, he_init_weights

    gen = torch.Generator().manual_seed(4)
    return {
        "raft": init_weights(RAFT(iters=2, input_hw=(H // 2, W // 2)),
                             gen).eval(),
        "unflow": he_init_weights(UnFlow(), gen, flow_gain=1.0 / 20.0).eval(),
        "ffpp": init_ffpp_weights(
            FlowFormerPP(iters=1, enc_dims=(16, 32), latent_dim=16,
                         query_dim=8), gen, flow_gain=0.4).eval(),
    }


@pytest.fixture(scope="module")
def providers():
    return _providers()


def _steps(engine, frames, depth=None):
    return [engine.step(f, None if depth is None else depth[i])
            for i, f in enumerate(frames)]


def _assert_same_outputs(got, want):
    assert [g is None for g in got] == [w is None for w in want]
    compared = 0
    for g, w in zip(got, want):
        if w is None:
            continue
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        compared += 1
    assert compared == len(want) - (T - 1)


CASES = {
    "host": dict(decode="host"),
    "device": {},
    "depth": dict(add_depth_inputs=True),
    "streams": {},
    "shards": {},
    "raft": dict(add_optflow_inputs=True),
    "large": dict(add_optflow_inputs=True, add_depth_inputs=True),
    "unflow": dict(add_optflow_inputs=True, input_height=UH,
                   input_width=UW),
    "ffpp": dict(add_optflow_inputs=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_engine_equals_unfused(case, jax_model, depth_model,
                                     large_model, frames, providers):
    """Masks, keypoint rows and heats of every step equal, bit for bit."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    model = {"depth": depth_model, "large": large_model}.get(case,
                                                             jax_model[2])
    flow = providers.get("raft" if case == "large" else case)
    kw = dict(flow_model=flow, device="cpu")
    if case in ("streams", "shards"):
        kw["num_streams"] = 2
    if case == "shards":
        kw.update(stream_shards=2, devices=["cpu", "cpu"])
    if case in ("streams", "shards"):
        seq = np.stack([frames, frames[::-1]], axis=1)
    elif case == "unflow":  # 128x128: the frames 2x2 tiled
        seq = np.tile(frames[:4], (1, 2, 2, 1))
    else:
        seq = frames
    depth = (np.ascontiguousarray(frames[..., 1])
             if case in ("depth", "large") else None)
    outs = {}
    for fused in (False, True):
        engine = InferenceEngine(
            model, _cfg(fused_dispatch=fused, **CASES[case]), **kw)
        outs[fused] = _steps(engine, seq, depth)
    _assert_same_outputs(outs[True], outs[False])


def test_fused_engine_matches_jax_fused_engine(tmp_path, jax_model, frames):
    """The port's fused engine against the JAX package's (``fused_dispatch``
    in both, device decode): rows equal, heats within 1e-3."""
    from mfcnet_tpu.track.tracker import InferenceEngine as JEngine
    from mfcnet_tpu.track.tracker import TrackerConfig as JConfig
    from mfcnet_tpu.track.tracker import track_on_frames as jtrack
    from mfcnet_tpu_torch.track.tracker import InferenceEngine, track_on_frames

    jm, v, pm = jax_model
    cfg = _cfg(fused_dispatch=True)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})
    jeng = JEngine(jm, v, jcfg)
    peng = InferenceEngine(pm, cfg, device="cpu")
    for i, f in enumerate(frames):
        want, got = jeng.step_async(f), peng.step(f)
        if i < T - 1:
            assert want is None and got is None
            continue
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   np.asarray(want[2], np.float32),
                                   rtol=0, atol=1e-3)
    rows_j, _ = jtrack(frames, jm, v, jcfg, tmp_path / "j", name="j",
                       engine=jeng)
    rows_p, _ = track_on_frames(frames, None, cfg, tmp_path / "p", name="p",
                                engine=peng)
    np.testing.assert_array_equal(rows_p, rows_j)


def test_reset_then_second_video_equals_fresh_engine(jax_model, frames,
                                                     providers):
    """One fused engine (RAFT, device decode) over two videos with a reset
    between them gives the second video's outputs of a fresh engine."""
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    cfg = _cfg(fused_dispatch=True, add_optflow_inputs=True)
    kw = dict(flow_model=providers["raft"], device="cpu")
    second = np.ascontiguousarray(frames[::-1])
    engine = InferenceEngine(jax_model[2], cfg, **kw)
    _steps(engine, frames)
    engine.reset()
    assert not engine.seg_buf.any() and not engine.flow_state[0].any()
    got = _steps(engine, second)
    want = _steps(InferenceEngine(jax_model[2], cfg, **kw), second)
    _assert_same_outputs(got, want)


def test_full_mode_ignores_the_flag(jax_model, frames):
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    engines = {f: InferenceEngine(jax_model[2],
                                  _cfg(mode="full", fused_dispatch=f),
                                  device="cpu")
               for f in (False, True)}
    assert not engines[True]._fused
    _assert_same_outputs(_steps(engines[True], frames),
                         _steps(engines[False], frames))
    assert engines[True].step_graph is None


@pytest.mark.parametrize("decode", ["host", "device"])
def test_track_on_frames_csv_byte_equal(tmp_path, jax_model, frames, decode):
    from mfcnet_tpu_torch.track.tracker import track_on_frames

    csv = {}
    for fused in (False, True):
        track_on_frames(frames, jax_model[2],
                        _cfg(decode=decode, fused_dispatch=fused),
                        tmp_path, name=f"f{int(fused)}", device="cpu")
        csv[fused] = (tmp_path / f"f{int(fused)}_tracked.csv").read_bytes()
    assert csv[True] == csv[False]


def test_resize_index_on_device_is_bit_equal_and_copies_nothing(monkeypatch):
    from mfcnet_tpu_torch.ops import resize

    for n_in, n_out in ((480, 240), (640, 320), (512, 256), (37, 11),
                        (11, 37), (100, 3)):
        np.testing.assert_array_equal(
            resize._nearest_index_on(n_in, n_out, torch.device("cpu")).numpy(),
            resize._nearest_index(n_in, n_out))
    img = torch.rand(2, 3, 48, 64)
    want = img.index_select(
        -2, torch.from_numpy(resize._nearest_index(48, 24))).index_select(
        -1, torch.from_numpy(resize._nearest_index(64, 20)))

    def refuse(*a, **k):
        raise AssertionError("a host copy")

    monkeypatch.setattr(torch, "from_numpy", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    assert torch.equal(resize.resize_nearest(img, 24, 20), want)


def test_raft_constants_on_device_are_bit_equal_and_copy_nothing(
        monkeypatch):
    """The correlation's sqrt(C) and the packed pyramid's index constants
    are made on the device, nothing copied from the host, and equal the
    host-made values bit for bit."""
    from mfcnet_tpu_torch.models import raft

    g = torch.Generator().manual_seed(0)
    f1 = torch.randn(2, 5, 6, 96, generator=g)
    f2 = torch.randn(2, 5, 6, 96, generator=g)
    old = torch.bmm(f1.reshape(2, 30, 96), f2.reshape(2, 30, 96).transpose(
        1, 2)) / torch.sqrt(torch.tensor(96.0))
    coords = torch.rand(2, 5, 6, 2, generator=g) * 6

    def refuse(*a, **k):
        raise AssertionError("a host copy")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    assert torch.equal(raft.all_pairs_correlation(f1, f2).reshape(2, 30, 30),
                       old)
    K1 = 6
    for H_, W_, L in ((5, 6, 3), (60, 80, 4), (7, 9, 3), (1, 1, 1)):
        sizes = [(H_ >> lv, W_ >> lv) for lv in range(L)]
        scale, base, wp, hi, offs = raft._pyramid_index(sizes, K1, "cpu")
        pads = [(h + 2 * K1, w + 2 * K1) for h, w in sizes]
        assert scale.dtype == torch.float32 and scale.flatten().tolist() == [
            0.5 ** lv for lv in range(L)]
        assert base.dtype == torch.int64 and base.tolist() == [
            np.cumsum([0] + [h * w for h, w in pads])[:-1].tolist()]
        assert wp.dtype == torch.int64 and wp.tolist() == [
            [w for _, w in pads]]
        assert hi.dtype == torch.float32 and hi.tolist() == [
            [[w + K1, h + K1] for h, w in sizes]]
        assert offs.dtype == torch.int64 and offs.tolist() == [
            [[y * w + x for y in range(K1) for x in range(K1)]
             for _, w in pads]]
    packed = raft.PackedPyramid(raft.build_corr_pyramid(f1, f2, 3), 2)
    assert packed.levels == 3
    assert packed.lookup(coords).shape == (2, 5, 6, 3 * 25)


def _tier_maps():
    """(expected tier, pred) maps: the decode tests' four maps (union and
    per-blob) and their overflow map (exact)."""
    from test_torch_decode import _frames

    out = [("per_blob" if name == "conflict" else "union", pred)
           for name, pred in _frames()]
    pred = np.zeros((80, 96), np.int32)
    pred[::3, ::3] = 4
    pred[40:60, 10:40] = 3
    pred[5:20, 60:90] = 1
    out.append(("exact", pred))
    return out


@pytest.mark.parametrize("idx", range(5))
def test_each_tier_equals_the_exact_decode_one_read_a_choice(idx,
                                                             monkeypatch):
    """Each tier's rows equal the exact tier's and the JAX package's exact
    decode; ``TIER_COUNTS`` names the tier; uncaptured, the choice of tier
    reads one flag on the host, two when the per-blob tier's stats run (the
    parent engine's reads)."""
    from mfcnet_tpu.track.decode_device import _decode_keypoints_xla
    from mfcnet_tpu_torch.ops import graph_cond
    from mfcnet_tpu_torch.track import decode_device as dd

    tier, pred = _tier_maps()[idx]
    probs = np.random.default_rng(idx).random(pred.shape + (5,)).astype(
        np.float32)
    predt = torch.from_numpy(pred)
    reads = []
    run_if = graph_cond.run_if

    def counting(flag, body, orelse=None):
        reads.append(bool(flag))
        run_if(flag, body, orelse)

    monkeypatch.setattr(graph_cond, "run_if", counting)
    dd.reset_tier_counts()
    got = dd.decode_keypoints_device(torch.from_numpy(probs), 100,
                                     pred=predt)
    assert dd.TIER_COUNTS == {t: int(t == tier) for t in dd.TIER_COUNTS}
    assert reads == {"union": [False], "per_blob": [True, False],
                     "exact": [True, True]}[tier]
    masks4 = torch.stack([predt == 3, predt == 1, predt == 4, predt == 2],
                         dim=-3)
    heats = torch.stack([torch.from_numpy(probs[..., 4]),
                         torch.from_numpy(probs[..., 2])], dim=-3)
    assert torch.equal(got, dd._decode_keypoints_exact(masks4, heats, 10.0))
    import jax.numpy as jnp

    np.testing.assert_array_equal(got.numpy(), np.asarray(
        _decode_keypoints_xla(jnp.asarray(masks4.numpy()),
                              jnp.asarray(heats.numpy()), 10.0)))


def test_run_if_reads_the_flag_outside_a_capture():
    from mfcnet_tpu_torch.ops import graph_cond

    ran = []
    for v in (True, False):
        flag = torch.tensor(v)
        graph_cond.run_if(flag, lambda: ran.append("body"),
                          lambda: ran.append("else"))
        graph_cond.run_if(flag, lambda: ran.append("only"))
    assert ran == ["body", "only", "else"]
    with pytest.raises(ValueError, match="card only"):
        graph_cond.StepGraph("cpu").capture(lambda: None)


def test_replay_accounting_adds_captured_launches_and_tiers(monkeypatch):
    """The arithmetic of ``StepGraph.replay`` and ``drain`` on the records
    of a capture of the decode's choices, counted by hand (a capture needs
    the card): the per-blob branch and its else, the union rows, at the
    top; the exact and per-blob rows nested in the per-blob branch. Each
    replay adds the counts outside the branches, each drain adds each
    branch's own counts times its runs on the card."""
    from mfcnet_tpu_torch.ops import cc, graph_cond
    from mfcnet_tpu_torch.track import decode_device as dd

    class _Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    def bump(**kw):  # the counts a captured call would make
        for k, v in kw.items():
            for d in (cc.LAUNCHES, dd.TIER_COUNTS, graph_cond.LAUNCHES):
                if k in d:
                    d[k] += v

    dd.reset_tier_counts()
    cc.reset_launches()
    graph_cond.reset_launches()
    before = graph_cond._snapshot()
    bump(union_flood_cc_cid=1, onehot_stats=1, graph_if=2)
    node = graph_cond._snapshot()
    bump(flood_cc_cid=1, onehot_stats=1, graph_if=2)      # per-blob stats
    inner = graph_cond._snapshot()
    bump(connected_components=2, exact=1)                 # exact rows
    exact = graph_cond._delta(inner)
    inner = graph_cond._snapshot()
    bump(per_blob=1)                                      # per-blob rows
    blob_rows = graph_cond._delta(inner)
    per_blob = graph_cond._delta(node)
    node = graph_cond._snapshot()
    bump(union=1)                                         # union rows
    union = graph_cond._delta(node)
    total = graph_cond._delta(before)
    graph_cond._add(total, -1)
    assert not any(cc.LAUNCHES.values()) and not any(dd.TIER_COUNTS.values())

    g = graph_cond.StepGraph("cpu")
    g.graph = _Graph()
    g._main, g._own = graph_cond._split(
        total, [per_blob, exact, blob_rows, union], [None, 0, 0, None])
    # 5 replays: per-blob stats 3 times (exact once, its rows twice),
    # union rows twice
    g._runs = torch.tensor([3, 1, 2, 2] + [0] * (graph_cond.MAX_NODES - 4))
    graph_cond._LIVE.add(g)
    try:
        for _ in range(5):
            g.replay()
        graph_cond.drain()
    finally:
        graph_cond._LIVE.discard(g)
    assert dd.TIER_COUNTS == {"union": 2, "per_blob": 2, "exact": 1}
    assert cc.LAUNCHES == {"union_flood_cc_cid": 5, "onehot_stats": 8,
                           "flood_cc_cid": 3, "connected_components": 2}
    assert graph_cond.LAUNCHES["graph_if"] == 16
    assert g._runs.tolist() == [0] * graph_cond.MAX_NODES
    graph_cond.drain()  # nothing pending: counts nothing more
    assert dd.TIER_COUNTS["union"] == 2
    cc.reset_launches()
    graph_cond.reset_launches()
    dd.reset_tier_counts()


# ------------------------------------------------------------------ the card
def _cuda_engines(fused_flags=(False, True), **kw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernels have no "
                    "CPU mode")
    from mfcnet_tpu_torch.models import get_multiframe_segmentation_model
    from mfcnet_tpu_torch.track.tracker import InferenceEngine

    gen = torch.Generator().manual_seed(0)
    model = get_multiframe_segmentation_model(
        "TernausNetMulti-Basic", C, T, scale=0.25, generator=gen)
    return {f: InferenceEngine(model, _cfg(input_height=128, input_width=160,
                                           fused_dispatch=f, **kw))
            for f in fused_flags}


@pytest.mark.cuda
def test_cuda_fused_equals_unfused():
    """On the card: one replay a frame after the first fused one, masks,
    rows and heats equal to the unfused engine's, the same tiers."""
    from mfcnet_tpu_torch.track import decode_device as dd

    engines = _cuda_engines()
    frames = np.random.default_rng(0).integers(0, 255, (8, 128, 160, 3),
                                               dtype=np.uint8)
    outs, tiers = {}, {}
    for f, e in engines.items():
        dd.reset_tier_counts()
        outs[f] = _steps(e, frames)
        tiers[f] = dict(dd.TIER_COUNTS)
    _assert_same_outputs(outs[True], outs[False])
    assert tiers[True] == tiers[False]
    assert engines[True].step_graph.replays == len(frames) - T


@pytest.mark.cuda
def test_cuda_fused_steps_make_no_host_sync():
    engine = _cuda_engines((True,))[True]
    frames = torch.randint(0, 255, (8, 128, 160, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)).cuda()
    for f in frames[:T]:  # the warm-up, the eager frame and the capture
        engine.step_async(f)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [engine.step_async(f) for f in frames[T:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert engine.step_graph.replays == len(frames) - T
    assert all(o[0].shape == (128, 160) for o in outs)


@pytest.mark.cuda
def test_cuda_sync_inside_the_step_raises():
    """No fallback: a host read inside the step fails its capture."""
    engine = _cuda_engines((True,))[True]
    step = engine._fused_step

    def syncing():
        out = step()
        out[0].sum().item()
        return out

    engine._fused_step = syncing
    frames = np.zeros((T, 128, 160, 3), np.uint8)
    for f in frames[:T - 1]:
        engine.step_async(f)
    with pytest.raises(RuntimeError):
        engine.step_async(frames[-1])
    assert engine.step_graph is None
