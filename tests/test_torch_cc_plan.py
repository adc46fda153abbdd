"""The launch plans of the ``cc.cu`` kernels (``ops/cc.py::cc_plan``) and
numpy models of their schedules (``csrc/cc.cu``: ``k_flood_cc_cid``,
``k_union_flood_cc_cid``, ``k_cc_labels``, ``k_onehot_stats``), on the
CPU, without JAX.

The model runs the kernels' phases one after another as the grid barriers
order them, with the kernels' data: union-find inside tiles (the four flood
domains at once), the global planes' tile-label encoding (a pixel that is
not its tile part's root stores -(tile root + 1)), links across tile
borders with the kernels' skip rule, applied in random orders, compression
of the tile roots, the image border's pixels marking their roots reached,
he / conflict / straddle, the
class-aware and relaxed planes, ranks per chunk and the chunk prefix, the
per-root maxima of the outer pixels' roots and cide. The labels kernel
runs the same tile core and then writes every pixel's root in place over
the tile labels. The sums kernel's model takes the pixels in 32-lane warps
within the blocks' chunks, sums each warp's lanes by key and commits the
blocks' sums in random orders. Each model must give the plain versions'
outputs exactly, whatever order the links and the commits take."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcnet_tpu_torch.ops import cc
from tests.test_torch_cc import _geometries
from torch_threads import _two_torch_threads  # noqa: F401

K = 64
CC_CU = Path(cc.__file__).resolve().parents[1] / "csrc" / "cc.cu"


# ------------------------------------------------------------------- plan
def test_plan_constants_are_the_c_sides():
    """The C side refuses a plan built on other constants; this finds such
    a difference without a card."""
    src = CC_CU.read_text()
    for name, value in (("FTILE", cc.FLOOD_TILE), ("FT", cc.FLOOD_THREADS),
                        ("NPLANES", cc.FLOOD_PLANES),
                        ("FBPS", cc.FLOOD_BLOCKS_PER_SM)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value), name
    assert "constexpr int CHUNK = 4 * FT;" in src
    assert cc.FLOOD_CHUNK == 4 * cc.FLOOD_THREADS
    assert cc.FLOOD_TILE == 1 << int(re.search(
        r"constexpr int FTS = (\d+);", src).group(1))
    for name, value in (("MAX_K", cc.MAX_K), ("NROWS", cc.STATS_ROWS),
                        ("ERR_PLAN", cc.PLAN_REFUSED)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value), name
    # the shared bytes and work ints each entry point's plan must carry
    assert "constexpr int CC_SHARED =\n    4 * FTILE * FTILE + 2 * 3 * FTILE " \
           "* FTILE + FTILE * FTILE;" in src
    assert "plan_is(plan, FTILE, CC_SHARED, 0, 0)" in src
    assert "plan_is(plan, 0, 8 * NROWS * K, 2 * NROWS * K, CHUNK)" in src


@pytest.mark.parametrize("B,H,W", [(1, 480, 640), (4, 480, 640),
                                   (8, 481, 643), (1, 7, 5), (1, 1, 1),
                                   (3, 1, 640), (2, 130, 65)])
@pytest.mark.parametrize("sm,bps", [(132, 2), (132, 1), (8, 3)])
def test_plan_covers_every_tile_and_pixel_once(B, H, W, sm, bps):
    plan = cc.cc_plan(B, H, W, sm, bps)
    n, T = H * W, plan["tile"]
    assert plan["shared_bytes"] <= cc.MAX_SHARED_BYTES
    assert set(cc.PLAN_KEYS) <= set(plan)
    assert plan["work_ints"] == cc.FLOOD_PLANES * n + plan["chunks"]
    assert plan["grid"] == sm * bps
    ntx, nty = -(-W // T), -(-H // T)
    assert plan["tiles"] == ntx * nty
    # every block's grid-stride share of the (image, tile) items and of
    # the (image, chunk) items
    cover = np.zeros((B, H, W), np.int32)
    ranked = np.zeros(B * n, np.int32)
    for blk in range(plan["grid"]):
        for it in range(blk, B * plan["tiles"], plan["grid"]):
            b, t = divmod(it, plan["tiles"])
            y0, x0 = t // ntx * T, t % ntx * T
            cover[b, y0:y0 + T, x0:x0 + T] += 1
        for it in range(blk, B * plan["chunks"], plan["grid"]):
            b, ch = divmod(it, plan["chunks"])
            lo = ch * plan["chunk"]
            ranked[b * n + lo:b * n + min(n, lo + plan["chunk"])] += 1
    assert (cover == 1).all() and (ranked == 1).all()


@pytest.mark.parametrize("B,H,W", [(64, 1024, 2048), (16, 2160, 3840),
                                   (60000, 13, 21), (1, 16384, 16384)])
def test_plan_shared_memory_does_not_grow_with_the_batch(B, H, W):
    """The chunk counts live in global memory: a block's shared memory is
    the tile phases' whatever B, H and W, and two blocks fit an SM (228 KB,
    1 KB of it reserved a block)."""
    plan = cc.cc_plan(B, H, W, 132)
    assert plan["shared_bytes"] == cc.cc_plan(1, 1, 1, 132)["shared_bytes"]
    assert cc.FLOOD_BLOCKS_PER_SM * (plan["shared_bytes"] + 1024 + 256) \
        <= 228 * 1024
    assert plan["grid"] == 132 * cc.FLOOD_BLOCKS_PER_SM


def test_plan_refuses_images_beyond_32_bit_indices():
    with pytest.raises(ValueError, match="32-bit"):
        cc.cc_plan(1, 20000, 20000, 132)


@pytest.mark.parametrize("B,H,W", [(1, 480, 640), (4, 481, 643),
                                   (60000, 13, 21), (1, 1, 1)])
@pytest.mark.parametrize("sm,bps", [(132, 2), (8, 3)])
def test_plan_of_the_labels_and_sums_kernels(B, H, W, sm, bps):
    """One cooperative launch each: grid = SMs x blocks per SM; the labels
    kernel has the flood kernels' tiles, a mask tile's shared memory and
    no workspace; the sums kernel FLOOD_CHUNK-pixel items, 6 x K uint64 of
    shared memory and a (6, K) uint64 accumulator per image."""
    T, tt = cc.FLOOD_TILE, cc.FLOOD_TILE ** 2
    lab = cc.cc_plan(B, H, W, sm, bps, entry="cc_labels")
    assert set(cc.PLAN_KEYS) <= set(lab)
    assert (lab["grid"], lab["threads"]) == (sm * bps, cc.FLOOD_THREADS)
    assert (lab["tile"], lab["work_ints"], lab["chunk"]) == (T, 0, 0)
    assert lab["shared_bytes"] == 4 * tt + 2 * 3 * tt + tt
    assert lab["tiles"] == -(-H // T) * -(-W // T)
    for K_ in (1, 64, 256, cc.MAX_K):
        st = cc.cc_plan(B, H, W, sm, bps, entry="onehot_stats", K=K_)
        assert set(cc.PLAN_KEYS) <= set(st)
        assert (st["grid"], st["threads"]) == (sm * bps, cc.FLOOD_THREADS)
        assert (st["tile"], st["chunk"]) == (0, cc.FLOOD_CHUNK)
        assert st["shared_bytes"] == 8 * cc.STATS_ROWS * K_
        assert st["work_ints"] == 2 * cc.STATS_ROWS * K_
        assert st["chunks"] == -(-H * W // cc.FLOOD_CHUNK)


@pytest.mark.parametrize("entry", ["cc_labels", "onehot_stats"])
def test_labels_and_sums_shared_memory_is_the_same_for_every_shape(entry):
    """No block's shared memory grows with B, H or W; two blocks fit an SM
    (228 KB, 1 KB of it reserved a block), the sums kernel's at K =
    MAX_K too (48 KB of sums)."""
    K_ = cc.MAX_K
    plans = [cc.cc_plan(B, H, W, 132, entry=entry, K=K_)
             for B, H, W in ((1, 1, 1), (64, 1024, 2048), (16, 2160, 3840),
                             (60000, 13, 21), (1, 16384, 16384))]
    assert len({p["shared_bytes"] for p in plans}) == 1
    assert cc.FLOOD_BLOCKS_PER_SM * (plans[0]["shared_bytes"] + 1024 + 256) \
        <= 228 * 1024
    assert plans[0]["shared_bytes"] <= cc.MAX_SHARED_BYTES


def test_labels_and_sums_plans_refuse_what_32_bits_cannot_index():
    for entry in ("cc_labels", "onehot_stats"):
        with pytest.raises(ValueError, match="32-bit"):
            cc.cc_plan(1, 1 << 16, 1 << 15, 132, entry=entry)  # 2^31 pixels
    # a warp's sum of 32 lanes' 2 * x must stay below 2^32
    cc.cc_plan(1, 1, (1 << 26) - 1, 132, entry="onehot_stats")
    with pytest.raises(ValueError, match="32-bit"):
        cc.cc_plan(1, 1, 1 << 26, 132, entry="onehot_stats")
    with pytest.raises(ValueError, match="32-bit"):
        cc.cc_plan(1 << 20, 64, 64 * 2048, 132, entry="cc_labels")
    for K_ in (0, cc.MAX_K + 1):
        with pytest.raises(ValueError, match="K must be"):
            cc.cc_plan(1, 480, 640, 132, entry="onehot_stats", K=K_)
    with pytest.raises(ValueError, match="entry"):
        cc.cc_plan(1, 480, 640, 132, entry="stats")


# ------------------------------------------------------- schedule model
def _find(L, p):
    while L[p] != p:
        p = L[p]
    return p


def _unite(L, a, b):
    """The kernels' atomicMin union, one link at a time: the larger root
    takes the smaller as parent."""
    a, b = _find(L, a), _find(L, b)
    if a != b:
        L[max(a, b)] = min(a, b)


def _tile_root(L, p):
    v = L[p]
    return -v - 1 if v < 0 else p


_BACK = ((-1, 0), (0, -1), (-1, -1), (1, -1))  # left, up, up-left, up-right


def _tiles(H, W, T):
    for y0 in range(0, H, T):
        for x0 in range(0, W, T):
            yield y0, x0


def _tile_phase(reg, H, W, T, conn, rng):
    """Tile labels of one image's plane (``tile_union_find``): every
    pixel starts in its row run; runs of neighbouring rows join by the
    kernels' rules (links in a random order)."""
    L = np.arange(H * W, dtype=np.int64)
    for y0, x0 in _tiles(H, W, T):
        h, w = min(T, H - y0), min(T, W - x0)
        val = np.full((T, T), -1, np.int64)  # -1 off the image
        val[:h, :w] = reg[y0:y0 + h, x0:x0 + w]
        s = list(range(T * T))
        links = []
        for ly in range(T):
            for x in range(T):
                v = val[ly, x]
                start = x == 0 or val[ly, x - 1] != v
                if not start:
                    s[ly * T + x] = s[ly * T + x - 1]
                if ly == 0 or v <= 0:
                    continue
                li = ly * T + x
                up = val[ly - 1, x] == v
                if up and (start or x == 0 or val[ly - 1, x - 1] != v):
                    links.append((li, li - T))
                if conn == 8 and not up:
                    if start and x > 0 and val[ly - 1, x - 1] == v:
                        links.append((li, li - T - 1))
                    if x < T - 1 and val[ly - 1, x + 1] == v:
                        links.append((li, li - T + 1))
        for i in rng.permutation(len(links)):
            _unite(s, *links[i])
        for ly in range(h):
            for lx in range(w):
                if val[ly, lx] > 0:
                    p = (y0 + ly) * W + x0 + lx
                    r = _find(s, ly * T + lx)
                    rp = (y0 + r // T) * W + x0 + r % T
                    L[p] = p if rp == p else -rp - 1
    return L


def _border_pixels(T, conn):
    k_all = 2 * T - 1 if conn == 4 else 3 * T - 2
    for k in range(k_all):
        if k < T:
            yield k, 0
        elif k < 2 * T - 1:
            yield 0, k - T + 1
        else:
            yield T - 1, k - 2 * T + 2


def _border_links(reg, L, H, W, T, conn):
    """The links the kernels make across tile borders (tile roots), with
    their skip rule."""
    links = []
    for y0, x0 in _tiles(H, W, T):
        for lx, ly in _border_pixels(T, conn):
            x, y = x0 + lx, y0 + ly
            if x >= W or y >= H or not reg[y, x]:
                continue
            r = reg[y, x]
            row = ly == 0
            has_prev = not row or lx > 0
            px, py = (x - 1, y) if row else (x, y - 1)
            for k, (dx, dy) in enumerate(_BACK[:2 if conn == 4 else 4]):
                cross = (lx == 0, ly == 0, lx == 0 or ly == 0,
                         lx == T - 1 or ly == 0)[k]
                qx, qy = x + dx, y + dy
                if not cross or not (0 <= qx < W) or qy < 0:
                    continue
                if reg[qy, qx] != r:
                    continue
                tp, tq = _tile_root(L, y * W + x), _tile_root(L, qy * W + qx)
                rx, ry = px + dx, py + dy
                if (has_prev and 0 <= rx < W and ry >= 0
                        and _tile_root(L, py * W + px) == tp
                        and _tile_root(L, ry * W + rx) == tq):
                    continue
                links.append((tp, tq))
    return links


def _labels(reg, H, W, T, conn, rng, reach_seed=None):
    """Tile phase, cross-tile links in a random order, tile roots
    compressed: the plane from which root(p) = L[tile_root(L, p)]. With
    ``reach_seed`` (the image border), also the reach flag of every root:
    each seed pixel of the region marks its root."""
    L = _tile_phase(reg, H, W, T, conn, rng)
    G = L.copy()  # the parents the global links see (tile roots only)
    links = _border_links(reg, L, H, W, T, conn)
    for i in rng.permutation(len(links)):
        _unite(G, *links[i])
    for p in range(H * W):
        if L[p] >= 0 and G[p] != p:  # a linked tile root
            L[p] = _find(G, p)
    reach = np.zeros(H * W, bool)
    if reach_seed is not None:
        for p in np.flatnonzero(reach_seed & (reg.ravel() != 0)):
            reach[_root(L, p)] = True
    return L, reach


def _root(L, p):
    return L[_tile_root(L, p)]


def _dense_ids(reg, L, H, W, K_):
    """Per-chunk root ranks, the chunk prefix, clamped ids (-1 outside);
    returns (cid, ncomp, the id of each root)."""
    n, C = H * W, cc.FLOOD_CHUNK
    is_root = np.array([reg.flat[p] > 0 and L[p] == p for p in range(n)])
    chunks = -(-n // C)
    counts = [int(is_root[c * C:(c + 1) * C].sum()) for c in range(chunks)]
    pre = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    rank = {p: pre[p // C] + int(is_root[p // C * C:p].sum())
            for p in np.flatnonzero(is_root)}
    ids = {r: min(v, K_ - 1) for r, v in rank.items()}
    cid = np.array([ids[_root(L, p)] if reg.flat[p] > 0 else -1
                    for p in range(n)], np.int32)
    return cid, int(sum(counts)), ids


def _on_border(H, W):
    """The image border (the reach seeds)."""
    b = np.zeros((H, W), bool)
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = True
    return b.ravel()


def model_flood_cc_cid(mask, K_, T, rng):
    cids, filleds, ncomps = [], [], []
    for m in mask:
        H, W = m.shape
        bg = (~m).astype(np.int32)
        Lbg, reach = _labels(bg, H, W, T, 4, rng, _on_border(H, W))
        filled = np.array([m.flat[p] or not reach[_root(Lbg, p)]
                           for p in range(H * W)]).reshape(H, W)
        f = filled.astype(np.int32)
        Lf, _ = _labels(f, H, W, T, 8, rng)
        cid, nc, _ = _dense_ids(f, Lf, H, W, K_)
        cids.append(cid.reshape(H, W))
        filleds.append(f)
        ncomps.append(nc)
    return (np.stack(cids), np.stack(filleds), np.array(ncomps, np.int32))


def model_union_flood_cc_cid(ucls, K_, T, rng):
    outs = []
    for u in ucls.astype(np.int32):
        H, W = u.shape
        n = H * W
        border = _on_border(H, W)
        un = np.zeros(n, np.int32)
        for c in range(1, 5):  # the four floods (a kernel runs them at once)
            dom = (u != c).astype(np.int32)
            L, reach = _labels(dom, H, W, T, 4, rng, border)
            for p in range(n):
                if dom.flat[p] and not reach[_root(L, p)]:
                    un[p] |= 1 << (c - 1)
        e = np.select([un & 1 > 0, un & 2 > 0, un & 4 > 0, un & 8 > 0],
                      [1, 2, 3, 4], 0)
        uc = u.ravel()
        h = np.where(uc > 0, np.where(e > 0, uc + 4, uc), e).reshape(H, W)
        e = e.reshape(H, W)
        conflict = bool(((un & (un - 1)) != 0).any())
        for y, x in zip(*np.nonzero(h > 4)):  # the straddle check
            nb = h[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
            conflict |= bool((nb == h[y, x] - 4).any())
        h2 = np.where(h > 4, e, h)
        Lh, _ = _labels(h, H, W, T, 8, rng)
        Lh2, _ = _labels(h2, H, W, T, 8, rng)
        cid, nc, ids = _dense_ids(h, Lh, H, W, K_)
        cmax = np.full(n, -1)  # the largest h root of the outer pixels
        for p in range(n):
            if 1 <= h.flat[p] <= 4:
                r = _root(Lh2, p)
                cmax[r] = max(cmax[r], _root(Lh, p))
        cide = np.array([ids[cmax[_root(Lh2, p)]]
                         if h.flat[p] > 4 and cmax[_root(Lh2, p)] >= 0
                         else -1 for p in range(n)], np.int32)
        outs.append((cid.reshape(H, W), (h * 8 + e).astype(np.int32),
                     cide.reshape(H, W), nc, conflict))
    cid, he, cide, ncomp, conflict = zip(*outs)
    return (np.stack(cid), np.stack(he), np.stack(cide),
            np.array(ncomp, np.int32), np.array(conflict))


def model_connected_components(mask, conn, T, rng):
    """``k_cc_labels``: phases A-C on the labels themselves (tile
    union-find, cross-tile links, tile roots compressed), then D: every
    pixel, in a random order, writes its root (or H*W outside the mask)
    over its own slot. No pixel may read a value that D changes."""
    out = []
    for m in mask:
        H, W = m.shape
        n = H * W
        L, _ = _labels(m.astype(np.int32), H, W, T, conn, rng)
        after_c = L.copy()
        for p in rng.permutation(n):
            if not m.flat[p]:
                L[p] = n
                continue
            t = _tile_root(L, p)  # p's own slot: only p writes it
            assert L[t] == after_c[t] and after_c[after_c[t]] == after_c[t]
            L[p] = L[t]
        out.append(L.reshape(H, W))
    return np.stack(out)


def _interior(he):
    """Per pixel of (B, H, W) he: all four neighbours in its own
    hole-filled component (the kernel's ``own_inside``)."""
    h, e = he >> 3, he & 7
    hp = np.pad(h, ((0, 0), (1, 1), (1, 1)), constant_values=-1)
    ep = np.pad(e, ((0, 0), (1, 1), (1, 1)), constant_values=-1)
    H, W = h.shape[1:]
    inside = np.ones(h.shape, bool)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        hq = hp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        eq = ep[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        inside &= (hq == h) | ((h <= 4) & (hq > 4) & (eq == h))
    return inside


def model_onehot_stats(cid, he, cide, K_, grid, rng):
    """``k_onehot_stats`` with ``grid`` blocks: the zeroed accumulator;
    per block its grid-stride share of the (image, chunk) items, each
    chunk in FLOOD_THREADS-pixel trips of 32-lane warps
    (in a random order within a trip); the lanes of a warp that share a
    key sum their six values in 32 bits and one adds the sums to the
    block's; the block commits its sums when its next item lies in
    another image, and at the end; the commits land in a random order;
    then stats and ccls."""
    B, H, W = cid.shape
    n, C, FT = H * W, cc.FLOOD_CHUNK, cc.FLOOD_THREADS
    h, e = he >> 3, he & 7
    inside = _interior(he)
    own = (cid >= 0) & (h > 0)
    interior = own & inside
    y, x = np.indices((H, W))
    w2 = np.where(interior, 2, 1)
    keys = [np.where(own, cid, -1).reshape(B, n)]
    vals = [np.stack([np.ones_like(w2), (~interior).astype(np.int64), w2,
                      w2 * x, w2 * y, np.where(h > 4, h - 4, h)],
                     -1).reshape(B, n, 6)]
    if cide is not None:
        keys.append(np.where(h > 4, cide, -1).reshape(B, n))
        one = np.ones_like(w2)
        vals.append(np.stack([one, 0 * one, 2 * one, 2 * x + 0 * one,
                              2 * y + 0 * one, e], -1).reshape(B, n, 6))
    nchunks = -(-n // C)
    items = B * nchunks
    commits, covered = [], np.zeros(items, int)
    for blk in range(grid):
        cur, s = -1, np.zeros((6, K_), np.uint64)
        for it in range(blk, items, grid):
            covered[it] += 1
            b, ch = divmod(it, nchunks)
            if b != cur:
                if cur >= 0:
                    commits.append((cur, s))
                    s = np.zeros((6, K_), np.uint64)
                cur = b
            for o in range(0, C, FT):
                for w in rng.permutation(FT // 32):
                    p = ch * C + o + 32 * w + np.arange(32)
                    p = p[p < n]
                    for key, val in zip(keys, vals):
                        k = key[b, p]
                        groups = np.unique(k[k >= 0])
                        for g in rng.permutation(groups):
                            sums = val[b, p[k == g]].sum(0)
                            assert sums.max() < 2 ** 32  # 32-bit sums
                            s[:, g] += sums.astype(np.uint64)
        if cur >= 0:
            commits.append((cur, s))
    assert (covered == 1).all()  # every item taken once
    acc = np.zeros((B, 6, K_), np.uint64)
    for i in rng.permutation(len(commits)):
        b, s = commits[i]
        acc[b] += s
    a = acc.astype(np.float64)
    stats = np.zeros((B, 8, K_), np.float32)
    stats[:, 0:2] = a[:, 0:2]
    stats[:, 2:5] = a[:, 2:5] * 0.5
    stats[:, 5] = a[:, 5]
    cnt = a[:, 0]
    ccls = np.where(cnt > 0, np.rint(a[:, 5] / np.maximum(cnt, 1)), 0)
    return stats, ccls.astype(np.int32)


def _random_maps(seed, H, W, B=2):
    """Class maps with blobs, rings and speckle, ragged against any tile."""
    rng = np.random.default_rng(seed)
    u = np.zeros((B, H, W), np.int8)
    for b in range(B):
        for _ in range(6):
            c = rng.integers(1, 5)
            y, x = rng.integers(0, H), rng.integers(0, W)
            hh, ww = rng.integers(1, H + 1), rng.integers(1, W + 1)
            u[b, y:y + hh, x:x + ww] = c
            if hh > 4 and ww > 4:  # a ring: a hole to flood
                u[b, y + 2:y + hh - 2, x + 2:x + ww - 2] = rng.integers(0, 5)
        speck = rng.random((H, W)) < 0.05
        u[b][speck] = rng.integers(0, 5, int(speck.sum()))
    return u


def _cases():
    """(name, (B, H, W) int8 class maps, tile edges for the model)."""
    yield "geometries", _geometries(), (8, 16)
    yield "ragged 37x53", _random_maps(1, 37, 53), (8, 16)
    yield "ragged 67x70", _random_maps(2, 67, 70, B=1), (64,)
    yield "1x1", _random_maps(3, 1, 1), (8,)
    yield "7x5", _random_maps(4, 7, 5), (8,)
    yield "1x40", _random_maps(5, 1, 40), (8,)
    serp = np.zeros((1, 20, 24), np.int8)  # a one-pixel serpentine
    serp[0, ::2, :-1] = 2
    serp[0, 1::4, -2] = 2
    serp[0, 3::4, 0] = 2
    yield "serpentine", serp, (8,)
    yield "checkerboard", ((np.indices((1, 17, 19)).sum(0) % 2) * 3).astype(
        np.int8), (8,)


@pytest.mark.parametrize("name,ucls,tiles", list(_cases()),
                         ids=[c[0] for c in _cases()])
def test_schedule_model_gives_the_plain_outputs(name, ucls, tiles):
    u = torch.from_numpy(ucls)
    want_u = [t.numpy() for t in cc.union_flood_cc_cid_plain(u, K)]
    masks = torch.stack([u == c for c in (1, 2, 3, 4)], 1).reshape(
        -1, *ucls.shape[1:])
    want_f = [t.numpy() for t in cc.flood_cc_cid_plain(masks, K)]
    want_cc = {conn: cc.connected_components_plain(masks, conn).numpy()
               for conn in (4, 8)}
    m = masks.numpy()
    for T in tiles:
        for order in range(2):  # two random orders of every link
            rng = np.random.default_rng(100 * T + order)
            got = model_union_flood_cc_cid(ucls, K, T, rng)
            for g, w, what in zip(got, want_u, ("cid", "he", "cide", "ncomp",
                                                "conflict")):
                np.testing.assert_array_equal(g, w, err_msg=f"{what} T={T}")
            got = model_flood_cc_cid(m, K, T, rng)
            for g, w, what in zip(got, want_f, ("cid", "filled", "ncomp")):
                np.testing.assert_array_equal(g, w, err_msg=f"{what} T={T}")
            for conn in (4, 8):
                np.testing.assert_array_equal(
                    model_connected_components(m, conn, T, rng),
                    want_cc[conn], err_msg=f"labels conn={conn} T={T}")


@pytest.mark.parametrize("name,ucls,tiles", list(_cases()),
                         ids=[c[0] for c in _cases()])
def test_sums_model_gives_the_plain_sums(name, ucls, tiles):
    """The warp-aggregated sums on the union tier's outputs (with cide) and
    on the per-blob tier's (cid, filled * 8), with few blocks (each walks
    several images) and with more blocks than items."""
    u = torch.from_numpy(ucls)
    cid, he, cide = cc.union_flood_cc_cid_plain(u, K)[:3]
    masks = torch.stack([u == c for c in (1, 2, 3, 4)], 1).reshape(
        -1, *ucls.shape[1:])
    fcid, filled = cc.flood_cc_cid_plain(masks, K)[:2]
    for args in ((cid, he, cide), (fcid, filled * 8, None)):
        want = [t.numpy() for t in cc.onehot_stats_plain(*args, K)]
        arrays = [None if t is None else t.numpy() for t in args]
        for grid in (3, 7, 264):
            rng = np.random.default_rng(grid)
            got = model_onehot_stats(*arrays, K, grid, rng)
            for g, w, what in zip(got, want, ("stats", "ccls")):
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{what}, cide={args[2] is not None}, "
                    f"grid={grid}")
