"""The tiling of B3's image entry (``csrc/warp.cu::mfc_sample_bwd_img``) on
the CPU, pure torch (the kernel runs only on the card).

A block owns a tile of SAMPLE_BWD_TILE_H x SAMPLE_BWD_TILE_W output
samples and reduces their tap box; where the box times C fits
SAMPLE_BWD_CAP floats it sums the tile's contributions in a shared-memory
image of the box and adds the box to the global float32 buffer, else it
adds them to the buffer directly. The model here does the same with
``ops/warp.py::sample_bwd_tiles``'s boxes: every contribution (the forward's
float32 weight times g, per tap and channel, zeros skipped) of a shared-route
tile must fall inside its box; the tile's sums in float32, then the boxes'
sums and the direct contributions added into the buffer in float32, must
equal ``sample_backward_plain`` to float32 roundings (1e-6 of the largest,
a tenth of chip_smoke.py's BWD_TOL). Cases: the card's smooth ~6 px flow
and its edges case (samples pushed past each edge, with 6 px of noise, and
past a corner), integer coordinates, and a 40 px noise flow, in both
padding modes. At the card's shape (4 x 3 x 512 x 640) the edges case's
tiles fit the cap but for the few whose samples go past a corner, the
smooth case's all do, and the noise case's none. Before any atomic a
thread merges its two samples' shared taps and takes the next lane's left
column where it falls on its own right column: a model of those rules adds
every contribution once, at its pixel, and halves the adds on a smooth
flow.
"""

import pytest
import torch

from mfcnet_tpu_torch.ops import warp

from torch_threads import _two_torch_threads  # noqa: F401


def _coords(case, B, H, W, seed):
    """(fx, fy) absolute coordinates of chip_smoke.py's B3 cases at (B, H,
    W): 'smooth' (a 6 px field interpolated from a grid of 32 px cells),
    'edges' (6 px noise, each image pushed 0.75 of its size past another
    edge, an 8 x 8 corner far past the top-left), 'integers' (the pixel
    grid moved by -4..4 px, clamped to -3..size + 2) and 'noise' (40 px)."""
    gen = torch.Generator().manual_seed(seed)
    if case == "integers":
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                                torch.arange(W, dtype=torch.float32),
                                indexing="ij")
        ix = (xx + torch.randint(-4, 5, (B, H, W), generator=gen)).clamp(
            -3, W + 2)
        iy = (yy + torch.randint(-4, 5, (B, H, W), generator=gen)).clamp(
            -3, H + 2)
        return ix, iy
    if case == "smooth":
        flow = torch.nn.functional.interpolate(
            torch.randn(B, 2, H // 32, W // 32, generator=gen) * 6,
            size=(H, W), mode="bilinear", align_corners=False)
    elif case == "noise":
        flow = torch.randn(B, 2, H, W, generator=gen) * 40
    else:
        flow = torch.randn(B, 2, H, W, generator=gen) * 6
        flow[0, 0] -= 0.75 * W
        flow[1, 0] += 0.75 * W
        flow[2, 1] -= 0.75 * H
        flow[3, 1] += 0.75 * H
        flow[:, :, :8, :8] -= 2 * W
    return warp._abs_coords(*warp._warp_grid(flow), H, W, False, "zeros")


def _model_img(g, H, W, fx, fy, padding_mode):
    """The image gradient as the kernel's two routes sum it, float32
    (B, C, H, W); asserts that each shared-route contribution lies in its
    tile's box."""
    B, C, Ho, Wo = g.shape
    ext, local = warp.sample_bwd_tiles(fx, fy, H, W, C, padding_mode)
    if padding_mode == "border":
        fx, fy = fx.clamp(0.0, W - 1), fy.clamp(0.0, H - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    ux, uy = 1.0 - tx, 1.0 - ty
    th, tw = warp.SAMPLE_BWD_TILE_H, warp.SAMPLE_BWD_TILE_W
    bi = torch.arange(B).view(B, 1, 1).expand(B, Ho, Wo)
    ti = (torch.arange(Ho) // th).view(1, Ho, 1).expand(B, Ho, Wo)
    tj = (torch.arange(Wo) // tw).view(1, 1, Wo).expand(B, Ho, Wo)
    tile = (bi * ext.shape[1] + ti) * ext.shape[2] + tj
    box = ext.view(-1, 4)[tile]          # (B, Ho, Wo, 4)
    on_shared = local.view(-1)[tile]     # (B, Ho, Wo)
    pix, val, chan, til, shared = [], [], [], [], []
    for dy, dx, w in ((0, 0, ux * uy), (0, 1, tx * uy), (1, 0, ux * ty),
                      (1, 1, tx * ty)):
        yf, xf = y0 + dy, x0 + dx
        ok = (yf >= 0) & (yf <= H - 1) & (xf >= 0) & (xf <= W - 1)
        v = g * w.unsqueeze(1)           # the forward's float32 products
        keep = ok.unsqueeze(1) & (v != 0)
        b_, c_, y_, x_ = torch.nonzero(keep, as_tuple=True)
        ty_, tx_ = yf[b_, y_, x_].long(), xf[b_, y_, x_].long()
        sh = on_shared[b_, y_, x_]
        bx = box[b_, y_, x_]
        inside = ((tx_ >= bx[:, 0]) & (tx_ <= bx[:, 1])
                  & (ty_ >= bx[:, 2]) & (ty_ <= bx[:, 3]))
        assert bool(inside[sh].all()), "a contribution outside its box"
        pix.append((b_ * H + ty_) * W + tx_)
        chan.append(c_)
        val.append(v[b_, c_, y_, x_])
        til.append(tile[b_, y_, x_])
        shared.append(sh)
    pix, chan, val, til, shared = (torch.cat(t) for t in (
        pix, chan, val, til, shared))
    out = torch.zeros(B * H * W * C)
    dest = pix * C + chan
    # shared route: the tile's sums first (a box image of each tile)
    key = til[shared] * (B * H * W * C) + dest[shared]
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros(len(uniq)).index_add_(0, inv, val[shared])
    out.index_add_(0, uniq % (B * H * W * C), sums)
    out.index_add_(0, dest[~shared], val[~shared])   # direct route
    return out.view(B, H, W, C).permute(0, 3, 1, 2), local, ext


@pytest.mark.parametrize("case", ["smooth", "edges", "integers", "noise"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_tile_model_equals_the_plain_version(case, padding_mode):
    B, C, H, W = 4, 3, 64, 128
    fx, fy = _coords(case, B, H, W, 5)
    gen = torch.Generator().manual_seed(6)
    g = torch.randn(B, C, H, W, generator=gen)
    img = torch.rand(B, C, H, W, generator=gen)
    got, local, ext = _model_img(g, H, W, fx, fy, padding_mode)
    want = warp.sample_backward_plain(g, img, fx, fy, padding_mode,
                                      (True, False))[0]
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())
    nonempty = ext[..., 0] <= ext[..., 1]
    routes = {"shared": int(local.sum()),
              "direct": int((nonempty & ~local).sum())}
    if case == "noise":
        assert routes["shared"] == 0 and routes["direct"] > 0
    elif case in ("smooth", "integers"):
        assert routes["direct"] == 0 and routes["shared"] > 0


def test_card_shape_routes():
    """At chip_smoke.py's 4 x 3 x 512 x 640: the smooth flow's tiles all
    take the shared route; the edges case's too (border padding), but for
    the tiles holding the corner's samples where these do not clamp onto
    the same edge as the rest of the tile (their box then reaches from the
    corner to the tile's other samples); the 40 px
    noise flow's none."""
    B, C, H, W = 4, 3, 512, 640
    th, tw = warp.SAMPLE_BWD_TILE_H, warp.SAMPLE_BWD_TILE_W
    for case, pm in (("smooth", "border"), ("edges", "border"),
                     ("noise", "border"), ("noise", "zeros")):
        fx, fy = _coords(case, B, H, W, 7)
        ext, local = warp.sample_bwd_tiles(fx, fy, H, W, C, pm)
        assert ext.shape == (B, H // th, W // tw, 4)
        direct = (ext[..., 0] <= ext[..., 1]) & ~local
        if case == "smooth":
            assert not bool(direct.any())
        elif case == "edges":
            # the corner's 8 x 8 samples lie in tile (0, 0) of each image;
            # where the image is pushed left or up they clamp onto the same
            # edge as the rest of its tile, elsewhere they stretch its box
            assert direct[:, 0, 0].tolist() == [False, True, False, True]
            direct[:, 0, 0] = False
            assert not bool(direct.any())
            size = ((ext[..., 1] - ext[..., 0] + 1)
                    * (ext[..., 3] - ext[..., 2] + 1) * C)
            assert int(size[local].max()) <= warp.SAMPLE_BWD_CAP
        else:
            assert not bool(local.any())


def test_tile_constants_are_the_c_sides():
    from pathlib import Path
    import re

    src = (Path(warp.__file__).resolve().parents[1] / "csrc"
           / "warp.cu").read_text()
    assert re.search(r"constexpr int SB_CAP = (\d+);", src).group(1) == str(
        warp.SAMPLE_BWD_CAP)
    assert "constexpr int SB_TW = FW_TW, SB_TH = FW_TH;" in src
    assert "constexpr int FW_TW = 64, FW_TH = 8;" in src
    assert (warp.SAMPLE_BWD_TILE_W, warp.SAMPLE_BWD_TILE_H) == (64, 8)


def _merged_adds(x0, y0, vals):
    """The image entry's merges on one warp's row of 64 samples (lane l
    holds samples 2l, 2l + 1): x0, y0 (64,) int tap corners, vals (64, 4)
    float64 contributions of taps (0, 0), (0, 1), (1, 0), (1, 1). Returns
    the (pixel, value) adds left after the kernel's rules: a sample's tap on
    a pixel of the lane's first sample goes into that one's, and the next
    lane's first-sample left column on this lane's second-sample right
    column goes into it (the giver drops it)."""
    v = vals.copy().reshape(32, 2, 4)
    X0, Y0 = x0.reshape(32, 2), y0.reshape(32, 2)
    for ln in range(32):  # own merge
        dyo, dxo = Y0[ln, 1] - Y0[ln, 0], X0[ln, 1] - X0[ln, 0]
        for e1 in range(4):
            for e0 in range(4):
                if e0 // 2 == e1 // 2 + dyo and e0 % 2 == e1 % 2 + dxo:
                    v[ln, 0, e0] += v[ln, 1, e1]
                    v[ln, 1, e1] = 0.0
    given = v[:, 0, [0, 2]].copy()  # shuffled before anything is dropped
    for ln in range(32):
        if ln < 31 and X0[ln + 1, 0] == X0[ln, 1] + 1:  # take
            tdy = Y0[ln + 1, 0] - Y0[ln, 1]
            for dy in range(2):
                if dy + tdy in (0, 1):
                    v[ln, 1, 1 + 2 * (dy + tdy)] += given[ln + 1, dy]
        if ln > 0 and X0[ln, 0] == X0[ln - 1, 1] + 1:  # give
            gdy = Y0[ln, 0] - Y0[ln - 1, 1]
            for dy in range(2):
                if dy + gdy in (0, 1):
                    v[ln, 0, 2 * dy] = 0.0
    adds = []
    for ln in range(32):
        for k in range(2):
            for e in range(4):
                if v[ln, k, e] != 0.0:
                    adds.append(((Y0[ln, k] + e // 2, X0[ln, k] + e % 2),
                                 v[ln, k, e]))
    return adds


@pytest.mark.parametrize("case", ["smooth", "edges", "integers", "noise"])
def test_merges_add_each_contribution_once_at_its_pixel(case):
    """Per pixel, the merged adds sum to the contributions before merging
    (float64, so that only a lost or doubled value could differ); every
    add lands inside the image; on the smooth flow the rules leave about
    half the adds."""
    B, H, W = 4, 64, 128
    fx, fy = _coords(case, B, H, W, 8)
    fx, fy = fx.clamp(0.0, W - 1), fy.clamp(0.0, H - 1)  # border padding
    gen = torch.Generator().manual_seed(9)
    before = after = 0
    for b in range(B):
        for y in range(0, H, 16):
            for x in range(0, W, 64):
                fxr, fyr = fx[b, y, x:x + 64], fy[b, y, x:x + 64]
                x0f, y0f = torch.floor(fxr), torch.floor(fyr)
                tx, ty = fxr - x0f, fyr - y0f
                w = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                                 (1 - tx) * ty, tx * ty], -1)
                ok = torch.stack([
                    (y0f + dy >= 0) & (y0f + dy <= H - 1) & (x0f + dx >= 0)
                    & (x0f + dx <= W - 1)
                    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))], -1)
                g = torch.randn(64, 1, generator=gen, dtype=torch.float64)
                vals = (g * w.double() * ok).numpy()
                x0 = x0f.clamp(-1, W - 1).long().numpy()
                y0 = y0f.clamp(-1, H - 1).long().numpy()
                want = {}
                for i in range(64):
                    for e in range(4):
                        if vals[i, e] != 0.0:
                            p = (y0[i] + e // 2, x0[i] + e % 2)
                            want[p] = want.get(p, 0.0) + vals[i, e]
                got = {}
                adds = _merged_adds(x0, y0, vals)
                for p, val in adds:
                    assert 0 <= p[0] < H and 0 <= p[1] < W
                    got[p] = got.get(p, 0.0) + val
                assert got.keys() <= want.keys()
                for p, val in want.items():
                    assert abs(got.get(p, 0.0) - val) <= 1e-12 * (
                        1 + abs(val)), (case, p)
                before += int((vals != 0).sum())
                after += len(adds)
    if case == "smooth":
        assert after <= 0.6 * before
