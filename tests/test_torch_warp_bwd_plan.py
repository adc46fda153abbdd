"""The launch plan of the flow warp's maps gradient
(``ops/warp.py::warp_bwd_plan``), a numpy model of the kernel's phases
(``csrc/warp.cu::flow_warp_bwd_maps_kernel``: count, scan, bin, per-tile
accumulate) against the plain backward, and the flow gradient's 2D tile
mapping, on the CPU, without JAX.

The model runs the phases one after another as the grid barriers order
them: each pixel's distinct destination tiles (``warp.tap_tiles``, the
kernel's binning); the counts; their exclusive prefix; the bin pass in
warps of 32 pixels that come in a random order, each warp writing its
pixels of one tile as one run in lane order; then the (tile, channel
group) items in a random order, each taking its list in chunks, sorting a
chunk's entries by the corner of their tap boxes (ranks within a corner
in a random order, as the kernel's shared counters hand them out) and
summing, per pixel in float64, the float32 products of the boxes that
reach it in the kernel's order, rounded once to float32; bf16 g is read
through the kernel's staging, a 32-bit word an element. The sum must be
the plain
version's within 1e-5 (float32); for a convergent flow, whose taps each
receive hundreds of terms, that bound grows by 8 float32 roundings of the
sum of the terms' magnitudes (two summation orders differ by about one
such rounding; measured at most 2 over 20 random orders of 100 to 300,000
terms)."""

import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcnet_tpu_torch.ops import warp

from torch_threads import _two_torch_threads  # noqa: F401

WARP_CU = Path(warp.__file__).resolve().parents[1] / "csrc" / "warp.cu"
MAPS_ATOL = 1e-5
ORDER_ROUNDINGS = 8
DENSE = 32  # a chunk with a corner of more entries: a warp a corner


# ------------------------------------------------------------------- plan
def test_plan_constants_are_the_c_sides():
    """The C side refuses a plan built on other constants; this finds such
    a difference without a card."""
    src = WARP_CU.read_text()
    m = re.search(r"constexpr int BW_TH = (\d+), BW_TW = (\d+);", src)
    assert (int(m.group(1)), int(m.group(2))) == (warp.BWD_TILE_H,
                                                  warp.BWD_TILE_W)
    for name, value in (("BW_MAX_GC", warp.BWD_MAX_GROUP_C),
                        ("BW_BPS", warp.BWD_BLOCKS_PER_SM),
                        ("BW_CAP", warp.BWD_CAP),
                        ("BW_PLAN_INTS", len(warp.BwdPlan._fields)),
                        ("ERR_PLAN", warp.PLAN_REFUSED),
                        ("TPB", warp.BWD_THREADS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value), name
    # the same fields in the same order, the same shared memory and
    # workspace, and the refusals: another plan, or a grid the card cannot
    # hold at once
    fields = re.search(r"struct BwdPlan \{\s*int ([^;]*);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == list(
        warp.BwdPlan._fields)
    assert "constexpr int BW_CORNERS = (BW_TH + 1) * (BW_TW + 1);" in src
    assert ("const int shared =\n      4 * (BW_CAP * (3 + gc) + BW_CORNERS + 1)"
            " + 8 * gc * BW_TH * BW_TW;") in src
    assert "constexpr int BW_STAGE = BW_CAP / TPB;" in src
    assert "const long long work = 10LL * B * H * W + 2 * nt + 2;" in src
    assert re.search(r"constexpr int BW_DENSE = (\d+);", src).group(1) == \
        str(DENSE)
    assert "if (plan[k] != want[k]) return ERR_PLAN;" in src
    assert "if (per_sm < BW_BPS) return ERR_PLAN;" in src
    assert "if (p.shared_bytes > limit) return ERR_PLAN;" in src
    # the pixel pairs a block's threads own cover its tile: a warp a row
    assert warp.BWD_THREADS // 32 == warp.BWD_TILE_H
    assert warp.BWD_TILE_W == 64


@pytest.mark.parametrize("B,C,H,W", [(8, 6, 480, 640), (1, 1, 1, 1),
                                     (3, 7, 37, 65), (2, 13, 33, 64),
                                     (1, 64, 512, 640)])
@pytest.mark.parametrize("sms", [132, 8])
def test_plan_tiles_groups_grid_and_workspace(B, C, H, W, sms):
    p = warp.warp_bwd_plan(B, C, H, W, sms)
    assert (p.tile_h, p.tile_w) == (warp.BWD_TILE_H, warp.BWD_TILE_W)
    assert p.tiles == -(-H // p.tile_h) * -(-W // p.tile_w)
    # the channel groups cover C, none empty
    assert p.groups * p.group_c >= C > (p.groups - 1) * p.group_c
    assert p.group_c <= warp.BWD_MAX_GROUP_C
    # the shared memory grows with the channel group, not with B, H or W;
    # the blocks of an SM fit its 228 KB (1 KB reserved a block, and the
    # kernel's static ints)
    assert p.shared_bytes == 4 * (
        warp.BWD_CAP * (3 + p.group_c) + warp.BWD_CORNERS + 1) \
        + 8 * p.group_c * p.tile_h * p.tile_w
    assert p.shared_bytes + 4 * (1 + warp.BWD_THREADS // 32) <= 227 * 1024
    assert warp.BWD_BLOCKS_PER_SM * (p.shared_bytes + 1024 + 64) \
        <= 228 * 1024
    # a staged entry's number, its bf16 word's half and its corner share
    # 32 bits: 15, 1 and 16
    assert warp.BWD_CAP <= 2 ** 15 and warp.BWD_CORNERS <= 2 ** 16
    nt = B * p.tiles
    assert p.work_ints == 10 * B * H * W + 2 * nt + 2
    assert (p.grid, p.threads) == (sms * warp.BWD_BLOCKS_PER_SM,
                                   warp.BWD_THREADS)


def test_plan_refuses_empty_shapes_and_beyond_32_bit_indices():
    with pytest.raises(ValueError, match="32-bit"):
        warp.warp_bwd_plan(8, 6, 8192, 8192, 132)
    with pytest.raises(ValueError, match="empty"):
        warp.warp_bwd_plan(0, 6, 480, 640, 132)


def test_list_workspace_holds_the_worst_flow():
    """Every pixel at a tile corner: four list entries each, which the
    plan's workspace holds exactly."""
    B, H, W = 2, 64, 128
    th, tw = warp.BWD_TILE_H, warp.BWD_TILE_W
    # identity grid; every pixel sampled between the corner taps of tiles
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    flow = torch.stack([tw - 0.5 - xx, th - 0.5 - yy])[None].expand(
        B, 2, H, W)
    keys = warp.tap_tiles(flow, None)
    assert int((keys >= 0).sum()) == 4 * B * H * W
    p = warp.warp_bwd_plan(B, 6, H, W, 132)
    assert p.work_ints - (2 * B * H * W + 2 * B * p.tiles + 2) \
        == 2 * 4 * B * H * W


# ------------------------------------------------------------------ model
def model_maps_grad(g, flow, grid_hw, tile, cap, rng, group_c=6):
    """The kernel's phases in numpy (float64 sums of float32 products,
    rounded once). Returns the gradient,
    the lists and their offsets, and how many chunks took a warp a
    corner."""
    B, C, H, W = g.shape
    th, tw = tile
    ntx = -(-W // tw)
    tiles = ntx * -(-H // th)
    hw = H * W
    keys = warp.tap_tiles(flow, grid_hw, True, tile).numpy()
    keys = np.where(keys >= 0, keys + (np.arange(B) * tiles)[:, None, None,
                                                             None], -1)
    flat = keys.transpose(0, 2, 3, 1).reshape(B * hw, 4)
    # distinct tiles a pixel, as the kernel bins them
    for row in flat[(flat >= 0).sum(1) > 1]:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    # 1: count
    nt = B * tiles
    counts = np.bincount(flat[flat >= 0], minlength=nt)
    # 2: scan
    offs = np.concatenate([[0], np.cumsum(counts)])
    # 3: bin, warps of 32 pixels in a random order
    cursor = offs[:-1].copy()
    lists = np.full(offs[-1], -1, np.int64)
    for w0 in rng.permutation(np.arange(0, B * hw, 32)):
        lanes = np.arange(w0, min(w0 + 32, B * hw))
        for k in range(4):
            key = flat[lanes, k]
            for kk in np.unique(key[key >= 0]):
                run = lanes[key == kk]  # lane order
                at = cursor[kk]
                lists[at:at + len(run)] = run % hw
                cursor[kk] += len(run)
    assert (cursor == offs[1:]).all() and (lists >= 0).all()
    # 4: accumulate. (tile, group) items in a random order; a tile's list in
    # chunks of `cap` entries, each sorted by the corner (top-left tap) of
    # its entries' tap boxes, ranks within a corner in a random order
    fx, fy = warp._abs_coords(*warp._flow_grid(flow, grid_hw), H, W, True,
                              "zeros")
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0).numpy(), (fy - y0).numpy()
    ux, uy = 1.0 - tx, 1.0 - ty
    x0, y0 = x0.numpy(), y0.numpy()
    if g.dtype == torch.bfloat16:
        # staged a 32-bit word an element: the word at the element's index
        # in g rounded down to even, its half the parity of that index, the
        # pixel's xor its channel plane's offset
        bits = g.contiguous().view(torch.int16).numpy().view(np.uint16)
        bits = bits.reshape(-1)
        words = np.concatenate([bits, np.zeros(len(bits) % 2, np.uint16)]
                               ).view("<u4")

        def g_at(b, c, pix):
            plane = (b * C + c) * hw
            at = ((plane + pix) & ~1) * 2  # the word's byte offset in g
            assert (at % 4 == 0).all()  # cp.async copies aligned words
            half = (pix & 1) ^ (plane & 1)
            v = (words[at // 4] >> (16 * half).astype(np.uint32)) & 0xFFFF
            return (v.astype(np.uint32) << 16).view(np.float32)
    else:
        gn = g.numpy().astype(np.float32)

        def g_at(b, c, pix):
            return gn[b, c].reshape(-1)[pix]
    out = np.zeros((B, C, H, W), np.float32)
    dense_chunks = 0
    groups = -(-C // group_c)
    gc = -(-C // groups)
    for item in rng.permutation(nt * groups):
        key, grp = divmod(int(item), groups)
        b, t = divmod(key, tiles)
        ty0, tx0 = t // ntx * th, t % ntx * tw
        c0 = grp * gc
        cn = min(gc, C - c0)
        acc = np.zeros((cn, th, tw), np.float64)
        ent = lists[offs[key]:offs[key + 1]]
        for lo in range(0, len(ent), cap):
            e = ent[lo:lo + cap]
            cy = y0[b].reshape(-1)[e].astype(np.int64) - ty0 + 1
            cx = x0[b].reshape(-1)[e].astype(np.int64) - tx0 + 1
            # the kernel's shared counts hold exactly these corners
            assert (cy >= 0).all() and (cy <= th).all()
            assert (cx >= 0).all() and (cx <= tw).all()
            corner = cy * (tw + 1) + cx
            shuffled = rng.permutation(len(e))
            order = shuffled[np.argsort(corner[shuffled], kind="stable")]
            e, cy, cx, corner = e[order], cy[order], cx[order], corner[order]

            def terms(i, j, sel, c):
                """float32 products of g and the forward's weight (column
                part times row part) of box pixel (i, j)"""
                w = ((tx if j else ux)[b].reshape(-1)[e[sel]]
                     * (ty if i else uy)[b].reshape(-1)[e[sel]])
                return g_at(b, c0 + c, e[sel]) * w

            if np.bincount(corner).max() <= DENSE:
                # a thread a pixel pair: the corners of its lower box row,
                # then of its upper, in sorted order; then the tile
                part = np.zeros_like(acc)
                for i, jj in ((1, 1), (1, 0), (0, 1), (0, 0)):
                    py, px = cy - 1 + i, cx - 1 + jj
                    inside = (py >= 0) & (py < th) & (px >= 0) & (px < tw)
                    for c in range(cn):
                        np.add.at(part[c], (py[inside], px[inside]),
                                  terms(i, jj, inside, c))
                acc += part
            else:
                # a warp a corner, in any order: its entries' sums for its
                # four pixels, added to the tile
                dense_chunks += 1
                useg, first, inv = np.unique(corner, return_index=True,
                                             return_inverse=True)
                ky, kx = np.divmod(useg, tw + 1)
                every = np.ones(len(e), bool)
                in_order = rng.permutation(len(e))
                adds = rng.permutation(len(useg))
                for i, jj in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    py, px = (ky - 1 + i)[adds], (kx - 1 + jj)[adds]
                    inside = (py >= 0) & (py < th) & (px >= 0) & (px < tw)
                    for c in range(cn):
                        sums = np.zeros(len(useg), np.float64)
                        np.add.at(sums, inv[in_order],
                                  terms(i, jj, every, c)[in_order])
                        np.add.at(acc[c], (py[inside], px[inside]),
                                  sums[adds][inside])
        h, w_ = min(th, H - ty0), min(tw, W - tx0)
        out[b, c0:c0 + cn, ty0:ty0 + h, tx0:tx0 + w_] = acc[:, :h, :w_]
    # the tile's sums rounded once (assigning casts to float32)
    return torch.from_numpy(out), lists, offs, dense_chunks


def _flows(case, B, H, W, grid_hw, rng):
    """(B, 2, H, W) float32 flows of the named case."""
    gh, gw = (H, W) if grid_hw is None else grid_hw
    yy, xx = np.mgrid[:H, :W].astype(np.float32)

    def smooth(amp):
        f = np.stack([np.sin(xx / 9.0 + yy / 13.0), np.cos(xx / 11.0 - yy / 7.0)])
        return np.broadcast_to(f * amp, (B, 2, H, W))

    if case == "smooth":
        f = smooth(6.0)
    elif case == "noise":
        f = rng.standard_normal((B, 2, H, W)) * 4.0
    elif case == "beyond the band":
        f = rng.standard_normal((B, 2, H, W)) * 4.0
        f[:, 1] += np.where(rng.random((B, H, W)) < 0.05, 90.0, 0.0)
    elif case == "leaves the image":
        f = rng.standard_normal((B, 2, H, W)) * 4.0 + 700.0
    elif case == "zero":
        f = np.zeros((B, 2, H, W))
    elif case == "convergent":
        # every pixel onto a few pixels around one point
        sx, sy = (W - 1) / (gw - 1), (H - 1) / (gh - 1)
        px, py = 0.6 * W + 0.3, 0.4 * H + 0.7
        f = np.stack([px - xx * sx, py - yy * sy])[None] \
            + rng.uniform(-2.0, 2.0, (B, 2, H, W))
    else:  # long: beyond any tile and any band
        f = smooth(0.2 * max(H, W)) + np.array(
            [0.5 * W, -0.4 * H])[None, :, None, None]
    return torch.from_numpy(np.array(f, np.float32))


CASES = ("smooth", "noise", "beyond the band", "leaves the image", "zero",
         "convergent", "long")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape,tile,cap", [
    ((1, 1, 37, 45), (4, 16), 16), ((3, 6, 70, 131), (8, 64), 1024),
    ((1, 6, 33, 65), (8, 64), 64), ((3, 1, 21, 70), (4, 16), 1024)])
def test_model_of_the_maps_kernel_matches_the_plain_backward(case, shape,
                                                             tile, cap):
    B, C, H, W = shape
    rng = np.random.default_rng(zlib.crc32(f"{case} {shape}".encode()))
    grid_hw = None if case == "zero" else (H + H // 5, W + W // 5)
    flow = _flows(case, B, H, W, grid_hw, rng)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    maps = torch.zeros(shape)
    got, lists, offs, dense = model_maps_grad(g, flow, grid_hw, tile, cap,
                                              rng, group_c=4)
    # a flow that converges piles a chunk's entries onto a few corners
    assert dense > 0 or case != "convergent" or cap < 1024
    want = warp.flow_warp_backward_plain(g, maps, flow, grid_hw)[0]
    atol = MAPS_ATOL
    if case == "convergent":
        terms = warp.flow_warp_backward_plain(g.abs(), maps, flow,
                                              grid_hw)[0]
        atol = MAPS_ATOL + ORDER_ROUNDINGS * 2.0 ** -24 * terms
        assert float(terms.max()) > 50.0  # the case does converge
    assert bool(((got - want).abs() <= atol).all()), \
        float((got - want).abs().max())
    # each list holds each of its pixels once
    for key in range(len(offs) - 1):
        ent = lists[offs[key]:offs[key + 1]]
        assert len(np.unique(ent)) == len(ent)


@pytest.mark.parametrize("case", ("smooth", "noise", "convergent"))
@pytest.mark.parametrize("shape", [(2, 6, 37, 61), (1, 6, 33, 65)])
def test_model_stages_bf16_g_a_word_an_element(case, shape):
    """bf16 g through the kernel's word staging: with H * W odd, g's
    channel planes start at odd element offsets, and each element must
    still come from an aligned word and the right half of it. The model's
    float32 sums of those values are the plain backward's on the same
    (bf16-exact) values within 1e-5."""
    B, C, H, W = shape
    rng = np.random.default_rng(zlib.crc32(f"bf16 {case} {shape}".encode()))
    grid_hw = (H + H // 5, W + W // 5)
    flow = _flows(case, B, H, W, grid_hw, rng)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    maps = torch.zeros(shape)
    got = model_maps_grad(g, flow, grid_hw, (8, 64), 1024, rng)[0]
    want = warp.flow_warp_backward_plain(g.float(), maps, flow, grid_hw)[0]
    atol = MAPS_ATOL
    if case == "convergent":
        atol = MAPS_ATOL + ORDER_ROUNDINGS * 2.0 ** -24 * \
            warp.flow_warp_backward_plain(g.float().abs(), maps, flow,
                                          grid_hw)[0]
    assert bool(((got - want).abs() <= atol).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("B,H,W", [(2, 480, 640), (1, 37, 61), (1, 1, 1),
                                   (3, 8, 65), (1, 9, 64), (2, 17, 3)])
def test_flow_entry_tiles_cover_every_pixel_once(B, H, W):
    """``flow_warp_bwd_flow_kernel``'s mapping: blocks of FW_TW x FW_TH =
    64 x 8 pixels of one image (grid ceil(W / 64) x ceil(H / 8) x B), 256
    threads, a thread the pixels x and x + 1 (the second only inside the
    image) of row y, x = 64 bx + 2 (tid % 32), y = 8 by + tid // 32."""
    src = WARP_CU.read_text()
    assert "constexpr int FW_TW = 64, FW_TH = 8;" in src
    assert "const int lx = (tid % (FW_TW / 2)) * 2, ly = tid / (FW_TW / 2);" \
        in src
    cover = np.zeros((B, H, W), np.int32)
    tid = np.arange(256)
    for bz in range(B):
        for by in range(-(-H // 8)):
            for bx in range(-(-W // 64)):
                x = bx * 64 + (tid % 32) * 2
                y = by * 8 + tid // 32
                live = (x < W) & (y < H)
                np.add.at(cover[bz], (y[live], x[live]), 1)
                two = live & (x + 1 < W)
                np.add.at(cover[bz], (y[two], x[two] + 1), 1)
    assert (cover == 1).all()
