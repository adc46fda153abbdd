"""The port's two experimental convolutions against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs, at float32 on the CPU
(where the wrappers run their plain versions), at the shapes of
``tests/test_ops.py``'s own parity tests.

Tolerance: atol 2e-5, rtol 1e-5, the JAX tests' own (float32 sums in
another order)."""

import numpy as np
import pytest
import torch

ATOL, RTOL = 2e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,H,W,cin,cout,relu", [
    (1, 24, 30, 64, 32, False),
    (2, 16, 17, 8, 8, True),
])
def test_conv3x3_matches_pallas_kernel(B, H, W, cin, cout, relu):
    from mfcnet_tpu.experimental.conv3x3_pallas import conv3x3_pallas
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3

    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.05
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(conv3x3_pallas(x, w, bias=b, relu=relu, interpret=True))
    got = conv3x3(_t(x), _t(w), _t(b), relu).numpy()
    assert got.shape == want.shape == (B, H, W, cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    want0 = np.asarray(conv3x3_pallas(x, w, relu=relu, interpret=True))
    np.testing.assert_allclose(conv3x3(_t(x), _t(w), None, relu).numpy(),
                               want0, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,W,C1,R", [(32, 48, 16, 8), (16, 24, 16, 4),
                                      (64, 40, 8, 16)])
def test_vgg_stage1_matches_pallas_kernel(H, W, C1, R):
    """Incl. the zero ring between the two convolutions: the Pallas kernel
    masks it, the plain version pads the rounded intermediate with zeros."""
    from mfcnet_tpu.experimental.stage1_pallas import vgg_stage1_pallas
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    k1 = rng.standard_normal((3, 3, 3, C1)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(C1).astype(np.float32) * 0.1
    k2 = rng.standard_normal((3, 3, C1, C1)).astype(np.float32) * 0.05
    b2 = rng.standard_normal(C1).astype(np.float32) * 0.1
    want = np.asarray(vgg_stage1_pallas(x, k1, b1, k2, b2, tile_rows=R))
    got = vgg_stage1(*map(_t, (x, k1, b1, k2, b2))).numpy()
    assert got.shape == want.shape == (2, H, W, C1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the ring matters: conv1's bias makes its value outside the image
    # nonzero, and a version that convolved it would differ at the border
    assert np.abs(got[:, 0]).max() > 0


def test_vgg_stage1_takes_any_size_and_equals_two_conv3x3():
    """No divisibility constraint; the fused stage is conv3x3 twice."""
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 13, 19, 3, generator=g)
    k1, b1 = torch.randn(3, 3, 3, 6, generator=g) * 0.2, torch.randn(6, generator=g)
    k2, b2 = torch.randn(3, 3, 6, 6, generator=g) * 0.1, torch.randn(6, generator=g)
    torch.testing.assert_close(
        vgg_stage1(x, k1, b1, k2, b2),
        conv3x3(conv3x3(x, k1, b1, True), k2, b2, True), rtol=0, atol=1e-6)


def test_bfloat16_rounding_points():
    """bf16: weights and the intermediate are rounded to bf16, sums and
    biases are float32, the result is rounded once."""
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, 9, 3, generator=g).bfloat16()
    k1, b1 = torch.randn(3, 3, 3, 4, generator=g), torch.randn(4, generator=g)
    k2, b2 = torch.randn(3, 3, 4, 4, generator=g), torch.randn(4, generator=g)
    y = conv3x3(x, k1, b1, True)
    assert y.dtype == torch.bfloat16
    want = conv3x3(x.float(), k1.bfloat16().float(), b1, True).bfloat16()
    assert torch.equal(y, want)
    out = vgg_stage1(x, k1, b1, k2, b2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, conv3x3(y, k2, b2, True))


def test_experimental_kernels_reject_bad_inputs():
    from mfcnet_tpu_torch.experimental.conv3x3 import conv3x3
    from mfcnet_tpu_torch.experimental.stage1 import vgg_stage1

    x, w = torch.rand(1, 4, 4, 3), torch.rand(3, 3, 3, 5)
    with pytest.raises(NotImplementedError, match="forward only"):
        conv3x3(x, w.clone().requires_grad_())
    with pytest.raises(ValueError, match=r"\(3, 3, 3, cout\)"):
        conv3x3(x, torch.rand(3, 3, 4, 5))
    with pytest.raises(ValueError, match="bias"):
        conv3x3(x, w, torch.rand(4))
    with pytest.raises(TypeError, match="float32 or"):
        conv3x3(x.half(), w)
    with pytest.raises(ValueError, match="k2"):
        vgg_stage1(x, w, torch.rand(5), torch.rand(3, 3, 5, 6), torch.rand(6))


# the shapes the card checks the bfloat16 core at, ragged ones that take
# both loaders and every tile width, several 64-channel chunks of cin a tile
# (cin 100, 128, 256, 512) and the tile kernel past the core's weights (600)
PLAN_SHAPES = [(1, 480, 640, 64, 64), (1, 240, 320, 64, 128),
               (2, 17, 23, 5, 70), (1, 9, 21, 3, 70), (2, 16, 17, 8, 8),
               (1, 20, 70, 128, 64), (1, 12, 40, 256, 40),
               (1, 9, 30, 512, 16), (1, 11, 70, 100, 64), (1, 9, 20, 600, 70)]
STAGE1_SHAPES = [(1, 480, 640, 3, 64), (1, 19, 23, 3, 70),
                 (1, 21, 40, 8, 64), (1, 13, 18, 16, 64)]


def _covered_once(plan, B, H, W, cout):
    """Every output pixel and channel is written by exactly one tile of the
    plan's persistent walk."""
    seg = plan.width
    tiles_x, tiles_y = -(-W // seg), -(-H // plan.rows)
    assert plan.tiles == B * tiles_y * tiles_x
    count = np.zeros((B, H, W, plan.col_tiles * plan.n), np.int8)
    # block blk of column tile ct takes tiles blk, blk + blocks, ... (the
    # kernels' persistent walk)
    walk = [(ct, blk, t) for ct in range(plan.col_tiles)
            for blk in range(plan.blocks)
            for t in range(blk, plan.tiles, plan.blocks)]
    for ct, blk, t in walk:
        b, ty, tx = t // (tiles_y * tiles_x), t // tiles_x % tiles_y, t % tiles_x
        count[b, ty * plan.rows:(ty + 1) * plan.rows,
              tx * seg:(tx + 1) * seg, ct * plan.n:(ct + 1) * plan.n] += 1
    assert (count[..., :cout] == 1).all()
    assert len(walk) == plan.tiles * plan.col_tiles
    assert len({(ct, t) for ct, _, t in walk}) == len(walk)


@pytest.mark.parametrize("B,H,W,cin,cout", PLAN_SHAPES)
def test_conv_plan_covers_each_output_once(B, H, W, cin, cout):
    from mfcnet_tpu_torch.experimental.conv3x3 import (
        SMEM_LIMIT,
        STATIC_SMEM,
        TILE_SMEM,
        conv_plan,
    )

    plan = conv_plan(B, H, W, cin, cout)
    _covered_once(plan, B, H, W, cout)
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT == 232_448
    assert plan.n * plan.col_tiles >= cout > plan.n * (plan.col_tiles - 1)
    assert plan.kpad == -(-cin // 16) * 16 and plan.k1pad == 0
    # the core exactly where its resident weights (N >= 16) and two stages
    # fit; the tile kernel (one block a tile, plain loads) past that
    assert plan.kernel == ("core" if cin <= 512 else "tiles")
    if plan.kernel == "core":
        assert plan.loader == ("tma" if cin * 2 % 16 == 0 else "plain")
        # a ring of one or two stages for each consumer warpgroup
        assert plan.stages in (2, 4)
        assert plan.blocks * plan.col_tiles <= 132 or plan.blocks == 1
        assert plan.smem_bytes == (9 * plan.kpad * plan.n * 2 + plan.stages
                                   * 8 * -(-(plan.rows + 2) * 66 * 16 // 128)
                                   * 128 + 128)
    else:
        assert (plan.rows, plan.n, plan.loader) == (8, 64, "plain")
        assert plan.blocks == plan.tiles and plan.smem_bytes == TILE_SMEM
    # the C side's order of the ints
    assert list(plan.ints()) == [
        plan.rows, plan.n, plan.col_tiles, int(plan.loader == "tma"),
        plan.stages, plan.tiles, plan.blocks, plan.smem_bytes, plan.kpad, 0,
        int(plan.kernel == "core")]


@pytest.mark.parametrize("B,H,W,cin,C1", STAGE1_SHAPES)
def test_stage1_plan_covers_each_output_once(B, H, W, cin, C1):
    from mfcnet_tpu_torch.experimental.conv3x3 import (
        SMEM_LIMIT,
        STATIC_SMEM,
        stage1_plan,
    )

    plan = stage1_plan(B, H, W, cin, C1)
    _covered_once(plan, B, H, W, C1)
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT
    assert plan.loader == "plain"  # 6-byte pixels are no TMA stride
    assert plan.kpad == -(-C1 // 16) * 16
    assert plan.k1pad == -(-9 * cin // 16) * 16
    # the core takes cin <= 8 (the JAX kernel's limit), cin 8 at one row
    assert plan.kernel == ("core" if cin <= 8 else "tiles")
    if plan.kernel == "core":
        assert plan.n == 64 and plan.col_tiles == -(-C1 // 64)
        assert plan.rows == (1 if cin == 8 else 2) and plan.stages in (2, 4)
    else:  # all C1 in one block
        assert plan.n == -(-C1 // 64) * 64 and plan.col_tiles == 1
    assert plan.ints()[10] == int(plan.kernel == "core")


def test_plans_raise_on_what_the_kernels_do_not_take():
    from mfcnet_tpu_torch.experimental.conv3x3 import conv_plan, stage1_plan

    with pytest.raises(ValueError, match="32 bits"):
        conv_plan(1, 2 ** 14, 2 ** 11, 64, 64)
    with pytest.raises(ValueError, match="32 bits"):
        stage1_plan(4, 2 ** 13, 2 ** 13, 3, 16)
    with pytest.raises(ValueError, match="shared memory"):
        # neither the core (9 cin = 576 im2col columns) nor the tile kernel
        # (its float32 patch and first weights) fit
        stage1_plan(1, 8, 8, 64, 64)
    with pytest.raises(ValueError, match="empty"):
        conv_plan(1, 0, 8, 8, 8)
    # the widest tile that fits is taken; cin 128 still fits at N = 64
    assert conv_plan(1, 64, 64, 128, 64).n == 64
    assert conv_plan(1, 64, 64, 512, 64).n == 16
    # past the core's resident weights, the tile kernel, not an error
    assert conv_plan(1, 8, 8, 1024, 64).kernel == "tiles"
    assert stage1_plan(1, 8, 8, 8, 64).kernel == "core"
    assert stage1_plan(1, 8, 8, 60, 64).kernel == "tiles"


def _ring_fills(items, nchunks, stages, per_warpgroup):
    """The producer's fills in order, each (consumer warpgroup, stage, k:
    the stage's k-th fill): tile j goes to warpgroup j % 2, chunk c of it is
    fill s = j * nchunks + c. The bf16 cores give each warpgroup a ring of
    its own (``per_warpgroup``); else one ring shared by both."""
    half = stages // 2
    fills = []
    for s in range(items * nchunks):
        j, c = divmod(s, nchunks)
        if per_warpgroup:
            lf = (j // 2) * nchunks + c
            fills.append((j % 2, (j % 2) * half + lf % half, lf // half))
        else:
            fills.append((j % 2, s % stages, s // stages))
    return fills


def _simulate_ring(fills, seed):
    """One random interleaving of the producer, the copies' landing and the
    two consumer warpgroups, with mbarrier parity waits (a wait for parity
    p passes while the number of completed phases is odd for p = 0, even
    for p = 1). Returns (faults, whether every fill was consumed)."""
    import collections
    import random

    rng = random.Random(seed)
    full, empty = collections.Counter(), collections.Counter()
    queues = {wg: [f for f in fills if f[0] == wg] for wg in (0, 1)}
    pos, prod, in_flight, faults = {0: 0, 1: 0}, 0, [], []
    while True:
        acts = []
        if prod < len(fills):
            _, st, k = fills[prod]
            if k == 0 or empty[st] % 2 != (k & 1) ^ 1:
                acts.append("produce")
        if in_flight:
            acts.append("land")
        for wg in (0, 1):
            if pos[wg] < len(queues[wg]):
                _, st, k = queues[wg][pos[wg]]
                if full[st] % 2 != k & 1:
                    acts.append(wg)
        if not acts:
            break
        act = rng.choice(acts)
        if act == "produce":
            _, st, k = fills[prod]
            if empty[st] != k:  # overwrites a stage not yet consumed
                faults.append(("overwrite", st, k))
            in_flight.append((st, k))
            prod += 1
        elif act == "land":
            st, _ = in_flight.pop(rng.randrange(len(in_flight)))
            full[st] += 1
        else:
            _, st, k = queues[act][pos[act]]
            if full[st] != k + 1:  # passed before its own fill landed
                faults.append(("early", st, k))
            empty[st] += 1
            pos[act] += 1
    done = prod == len(fills) and all(
        pos[wg] == len(queues[wg]) for wg in (0, 1))
    return faults, done


@pytest.mark.parametrize("nchunks,stages", [
    (1, 2), (1, 4), (2, 2), (2, 4), (3, 4), (8, 2), (8, 4)])
def test_stage_rings_never_pass_a_wait_early(nchunks, stages):
    """The bf16 cores' stage handshakes, modelled: under random interleavings
    (TMA copies to different stages land in any order) no consumer passes
    its wait before its own fill has landed, no fill overwrites a stage
    still in use, and nothing deadlocks. nchunks: fills a tile (conv3x3:
    cin / 64 rounded up; vgg_stage1: 1); 2 or 4 stages."""
    fills = _ring_fills(7, nchunks, stages, per_warpgroup=True)
    for seed in range(300):
        assert _simulate_ring(fills, seed) == ([], True), seed


def test_a_shared_ring_fails_once_a_tile_takes_two_chunks():
    """The model sees the fault of one ring shared by both warpgroups once a
    tile takes several fills (or copies land out of order): a warpgroup
    that skips the other's fills can wait two phases ahead of a stage's
    barrier, and the parity reads as done."""
    for nchunks, stages in ((2, 2), (1, 3)):
        fills = _ring_fills(7, nchunks, stages, per_warpgroup=False)
        assert any(_simulate_ring(fills, seed)[0] for seed in range(300))


@pytest.mark.cuda
def test_cuda_conv_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions (run with ``python -m
    pytest tests/test_torch_experimental.py -m cuda --noconftest`` on a
    GPU). float32: the JAX tests' limits; bfloat16: one bf16 step of the
    result (a float32 sum in another order can flip the final rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mfcnet_tpu_torch.experimental import conv3x3 as c3
    from mfcnet_tpu_torch.experimental import stage1 as s1

    g = torch.Generator().manual_seed(0)
    for dt, atol, rtol in ((torch.float32, ATOL, RTOL),
                           (torch.bfloat16, 2.0 ** -8, 2.0 ** -7)):
        # the last five: several 64-channel chunks of cin a tile (TMA and
        # plain loads, N = 64 and 16) and the tile kernel past cin 512
        for B, H, W, cin, cout in ((1, 24, 30, 64, 32), (2, 16, 17, 8, 8),
                                   (1, 9, 21, 3, 70), (1, 37, 131, 64, 64),
                                   (3, 8, 64, 16, 8), (1, 40, 70, 64, 128),
                                   (1, 20, 70, 128, 64), (1, 11, 70, 100, 64),
                                   (1, 12, 40, 256, 40), (1, 9, 30, 512, 16),
                                   (1, 9, 20, 600, 70)):
            x = torch.randn(B, H, W, cin, generator=g).cuda().to(dt)
            scale = 0.05 if cin <= 64 else (2.0 / (9 * cin)) ** 0.5
            w = (torch.randn(3, 3, cin, cout, generator=g) * scale).cuda()
            b = torch.randn(cout, generator=g).cuda()
            c3.reset_launches()
            got = c3.conv3x3(x, w, b, True)
            assert c3.LAUNCHES["conv3x3"] == 1
            torch.testing.assert_close(
                got.float(), c3.conv3x3_plain(x, w, b, True).float(),
                rtol=rtol, atol=atol)
        # cin 8 on the core at one row a tile, cin 16 on the tile kernel
        for shape, C1 in (((2, 19, 23, 3), 70), ((1, 37, 131, 3), 64),
                          ((1, 21, 40, 8), 64), ((1, 13, 18, 16), 64)):
            x = torch.randn(shape, generator=g).cuda().to(dt)
            k1 = (torch.randn(3, 3, shape[-1], C1, generator=g) * 0.2).cuda()
            k2 = (torch.randn(3, 3, C1, C1, generator=g) * 0.05).cuda()
            b1 = (torch.randn(C1, generator=g) * 0.1).cuda()
            b2 = (torch.randn(C1, generator=g) * 0.1).cuda()
            s1.reset_launches()
            got = s1.vgg_stage1(x, k1, b1, k2, b2)
            assert s1.LAUNCHES["vgg_stage1"] == 1
            torch.testing.assert_close(
                got.float(), s1.vgg_stage1_plain(x, k1, b1, k2, b2).float(),
                rtol=rtol, atol=2 * atol)
    torch.cuda.synchronize()
