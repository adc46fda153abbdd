"""Connected components, hole filling and per-component sums for the
on-device keypoint decode.

Counterpart of :mod:`mfcnet_tpu.ops.cc_pallas`. Four functions, one per
TPU kernel, each a wrapper over a hand-written CUDA kernel
(``csrc/cc.cu``) with a plain PyTorch version of the same contract beside
it:

=======================  ==================================  ==========================
wrapper                  TPU kernel it replaces              plain version
=======================  ==================================  ==========================
connected_components     ``_cc_kernel``                      connected_components_plain
flood_cc_cid             ``_flood_cc_cid_kernel``            flood_cc_cid_plain
union_flood_cc_cid       ``_union_flood_cc_cid_kernel``      union_flood_cc_cid_plain
onehot_stats             ``_onehot_stats_kernel``            onehot_stats_plain
=======================  ==================================  ==========================

A wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; there is no fallback between the two. Each kernel
launch adds one to :data:`LAUNCHES`. Every kernel is one cooperative
launch (one device operation a call), configured by :func:`cc_plan`,
which the C side checks. :func:`base_stats` and :func:`union_stats`
compose them exactly as ``base_stats_pallas`` and ``union_stats_pallas``
do.

The plain versions transcribe the Pallas bodies' array math (static
shifts, segmented scans, fixpoint loops), which is what defines the
meaning. Per-component sums accumulate in int64 on planes scaled by 2
(w is 1 or 0.5, so count, boundary, 2w, 2w*x, 2w*y and the class sum
are integers): the sums are exact and independent of the order of
accumulation, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

import ctypes

from mfcnet_tpu_torch.ops._build import (
    counted,
    kernel_lib as _lib,
    route as _route,
    sm_count as _sm_count,
    stream_of as _stream,
)

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = counted({
    "connected_components": 0,
    "flood_cc_cid": 0,
    "union_flood_cc_cid": 0,
    "onehot_stats": 0,
})

#: largest slot count the stats kernel's shared-memory sums hold (48 KB)
MAX_K = 1024
#: summed planes of the stats kernel (``csrc/cc.cu``: NROWS)
STATS_ROWS = 6
#: the kernels' tile edge, threads per block, pixels per rank chunk (and
#: per item of the stats kernel), int32 planes of the flood kernels'
#: workspace and blocks an SM holds at once (``csrc/cc.cu``: FTILE, FT,
#: CHUNK, NPLANES, FBPS; the C side refuses a plan that differs)
FLOOD_TILE, FLOOD_THREADS, FLOOD_CHUNK, FLOOD_PLANES = 64, 512, 2048, 7
FLOOD_BLOCKS_PER_SM = 2
#: shared memory a block of an H100 may use (the opt-in limit)
MAX_SHARED_BYTES = 232448
#: the order in which the C entry points take a plan's ints
PLAN_KEYS = ("tile", "threads", "grid", "shared_bytes", "work_ints", "chunk")
#: what a C entry point returns for a plan that is not its shape's, or whose
#: blocks the card cannot hold at once (``csrc/cc.cu``: ERR_PLAN)
PLAN_REFUSED = 20001
#: the C entry points a plan is for: the two flood kernels, the labels and
#: the sums
PLAN_ENTRIES = ("flood", "cc_labels", "onehot_stats")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions: transcriptions of the Pallas bodies
# ---------------------------------------------------------------------------
def _shift(v, s: int, dim: int, fill):
    """Static shift by ``s`` along ``dim`` (positive = toward higher
    indices), vacated positions set to ``fill``."""
    if s == 0:
        return v
    size = v.shape[dim]
    if abs(s) >= size:
        return torch.full_like(v, fill)
    shape = list(v.shape)
    shape[dim] = abs(s)
    filler = torch.full(shape, fill, dtype=v.dtype, device=v.device)
    if s > 0:
        return torch.cat([filler, v.narrow(dim, 0, size - s)], dim=dim)
    return torch.cat([v.narrow(dim, -s, size + s), filler], dim=dim)


def _seg_scan(v, reset, dim: int, reverse: bool, identity, op):
    """Inclusive segmented scan (op = min or max) by shift doubling;
    ``reset`` (bool) truncates a run at that position."""
    size = v.shape[dim]
    f = reset
    s = 1
    sign = -1 if reverse else 1
    while s < size:
        vs = _shift(v, sign * s, dim, identity)
        fs = _shift(f, sign * s, dim, True)
        v = torch.where(f, v, op(v, vs))
        f = f | fs
        s <<= 1
    return v


def _propagate_cls(val0, fcls, inside, conn: int, op, identity):
    """Fixpoint propagation of ``val0`` (B, H, W) under ``op`` between
    neighbours of equal ``fcls`` inside ``inside`` (cc_pallas
    ``_propagate_cls``): a diagonal hand-off for 8-connectivity, then
    segmented scans along rows and columns, until nothing changes."""

    def edge_reset(dim, sign):
        nb = _shift(fcls, sign, dim, -1)
        return (fcls != nb) | ~inside

    resets = {(d, s): edge_reset(d, s) for d in (-1, -2) for s in (1, -1)}
    idv = torch.full_like(val0, identity)
    val0 = torch.where(inside, val0, idv)

    def seg(lab, dim):
        fwd = _seg_scan(lab, resets[(dim, 1)], dim, False, identity, op)
        bwd = _seg_scan(lab, resets[(dim, -1)], dim, True, identity, op)
        return torch.where(inside, op(fwd, bwd), idv)

    def diag(lab):
        def tap(dy, dx):
            lv = _shift(_shift(lab, dy, -2, identity), dx, -1, identity)
            cv = _shift(_shift(fcls, dy, -2, -1), dx, -1, -1)
            return torch.where(cv == fcls, lv, idv)

        d = op(op(tap(1, 1), tap(1, -1)), op(tap(-1, 1), tap(-1, -1)))
        return torch.where(inside, op(lab, d), idv)

    lab = val0
    while True:
        nxt = lab if conn == 4 else diag(lab)
        nxt = seg(seg(nxt, -1), -2)
        if torch.equal(nxt, lab):
            return nxt
        lab = nxt


def _propagate(val0, inside, conn: int, op, identity):
    """Single-region case of :func:`_propagate_cls`."""
    return _propagate_cls(val0, inside.to(torch.int32), inside, conn, op,
                          identity)


def _propagate_bits(seed, blk):
    """4-connected fixpoint of the bit-parallel flood: bit c of ``seed``
    spreads through pixels whose ``blk`` lacks bit c (cc_pallas
    ``_propagate_bits``)."""

    def scan(v, dim, reverse):
        size = v.shape[dim]
        f = blk
        s = 1
        sign = -1 if reverse else 1
        while s < size:
            vs = _shift(v, sign * s, dim, 0)
            fs = _shift(f, sign * s, dim, 0xF)
            v = v | (vs & ~f)
            f = f | fs
            s <<= 1
        return v

    def sweep(v, dim):
        return (scan(v, dim, False) | scan(v, dim, True)) & ~blk

    v = seed & ~blk
    while True:
        nxt = sweep(sweep(v, -1), -2)
        if torch.equal(nxt, v):
            return nxt
        v = nxt


def _iota(H, W, device):
    return torch.arange(H * W, dtype=torch.int32, device=device).view(H, W)


def _on_border(H, W, device):
    b = torch.zeros(H, W, dtype=torch.bool, device=device)
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = True
    return b


def _dense_ids(lab, inside, cls, K: int):
    """Component roots -> dense ids in raster order of the roots, spread
    to every member and clamped to K-1 (-1 outside); returns (cid, n)."""
    B, H, W = lab.shape
    is_root = inside & (lab == _iota(H, W, lab.device))
    flat = is_root.reshape(B, -1).to(torch.int32)
    rank = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).view(B, H, W)
    nroots = flat.sum(dim=1, dtype=torch.int32)
    cid0 = torch.where(is_root, rank, torch.full_like(rank, -1))
    cid = _propagate_cls(cid0, cls, inside, 8, torch.maximum, -1)
    return torch.clamp(cid, max=K - 1), nroots


def connected_components_plain(mask, connectivity: int = 8):
    """(B, H, W) bool -> int32 labels: each foreground pixel gets its
    component's minimum flat index, background H*W (``_cc_kernel``)."""
    B, H, W = mask.shape
    lab0 = torch.where(mask, _iota(H, W, mask.device), H * W)
    return _propagate(lab0, mask, connectivity, torch.minimum, H * W)


def flood_cc_cid_plain(mask, K: int = 256):
    """(B, H, W) bool -> (cid, filled, ncomp) (``_flood_cc_cid_kernel``):
    border flood of the background (4-connected) fills the holes; dense
    component ids of the filled mask (8-connected) in raster order of the
    roots, clamped to K-1, -1 outside; ``filled`` int32 0/1; ``ncomp``
    (B,) int32 component count."""
    B, H, W = mask.shape
    dev = mask.device
    n = H * W
    bg = ~mask
    seed = (bg & _on_border(H, W, dev)).to(torch.int32)
    reach = _propagate(seed, bg, 4, torch.maximum, 0)
    filled = mask | (bg & (reach == 0))
    lab0 = torch.where(filled, _iota(H, W, dev), n)
    lab = _propagate(lab0, filled, 8, torch.minimum, n)
    cid, ncomp = _dense_ids(lab, filled, filled.to(torch.int32), K)
    return cid, filled.to(torch.int32), ncomp


def union_flood_cc_cid_plain(ucls, K: int = 256):
    """(B, H, W) int8 class image in {0..4} -> (cid, he, cide, ncomp,
    conflict) (``_union_flood_cc_cid_kernel``): the four per-class border
    floods, the containment encoding he = h*8 + e, the conflict flag,
    class-aware 8-connected dense ids and the enclosing component's id at
    contained pixels. See ``cc_pallas._union_flood_cc_cid_kernel``."""
    B, H, W = ucls.shape
    dev = ucls.device
    n = H * W
    uc = ucls.to(torch.int32)
    zero = torch.zeros_like(uc)
    # bit c-1 of blk: the pixel is class c and blocks that class's flood
    blk = torch.where(
        uc == 1, 1,
        torch.where(uc == 2, 2,
                    torch.where(uc == 3, 4, torch.where(uc == 4, 8, 0))),
    ).to(torch.int32)
    seed = torch.where(_on_border(H, W, dev), 0xF & ~blk, zero)
    reach = _propagate_bits(seed, blk)
    unreached = (0xF & ~blk) & ~reach
    conflict = ((unreached & (unreached - 1)) != 0).flatten(1).any(dim=1)
    e = torch.where(
        (unreached & 1) != 0, 1,
        torch.where((unreached & 2) != 0, 2,
                    torch.where((unreached & 4) != 0, 3,
                                torch.where((unreached & 8) != 0, 4, 0))),
    ).to(torch.int32)
    h = torch.where(uc > 0, torch.where(e > 0, uc + 4, uc), e)
    # a same-class component straddling a containment boundary
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                hq = _shift(_shift(h, dy, -2, 9), dx, -1, 9)
                conflict |= ((h > 4) & (hq == h - 4)).flatten(1).any(dim=1)
    inside = h > 0
    lab0 = torch.where(inside, _iota(H, W, dev), n)
    lab = _propagate_cls(lab0, h, inside, 8, torch.minimum, n)
    cid, ncomp = _dense_ids(lab, inside, h, K)
    h2 = torch.where(h > 4, e, h)
    neg = torch.full_like(cid, -1)
    cide = _propagate_cls(
        torch.where(h <= 4, cid, neg), h2, h2 > 0, 8, torch.maximum, -1
    )
    return (cid, h * 8 + e, torch.where(h > 4, cide, neg), ncomp,
            conflict)


def _stats_from_sums(acc):
    """int64 (B, 6, K) sums of the x2-scaled planes -> (stats f32
    (B, 8, K), ccls int32 (B, K))."""
    B, _, K = acc.shape
    a = acc.to(torch.float64)
    stats = torch.zeros(B, 8, K, dtype=torch.float32, device=acc.device)
    stats[:, 0:2] = a[:, 0:2].float()
    stats[:, 2:5] = (a[:, 2:5] * 0.5).float()
    stats[:, 5] = a[:, 5].float()
    cnt = a[:, 0]
    ccls = torch.where(
        cnt > 0, torch.round(a[:, 5] / cnt.clamp(min=1.0)),
        torch.zeros_like(cnt),
    ).to(torch.int32)
    return stats, ccls


def onehot_stats_plain(cid, he, cide=None, K: int = 256):
    """Per-slot sums (``_onehot_stats_kernel`` plus the value planes the
    Pallas wrappers build around it).

    cid, he (and optional cide): (B, H, W) int32. ``he = h*8 + e`` as
    :func:`union_flood_cc_cid` returns it; a plain filled mask is
    ``filled * 8``. Rows of the returned (B, 8, K) f32 stats: [count,
    boundary count, sum w, sum w*x, sum w*y, class sum, 0, 0] per slot of
    ``cid`` (w = 1 interior, 0.5 boundary; a pixel is interior when all
    four neighbours lie in its own hole-filled component). Pixels with
    ``cide >= 0`` (contained, h > 4) also add [1, 0, 1, x, y, e] to slot
    ``cide``. ``ccls`` (B, K) int32 = class sum / count (0 if empty)."""
    B, H, W = cid.shape
    dev = cid.device
    h = he >> 3
    e = he & 7

    def nb(img, dy, dx):
        return _shift(_shift(img, dy, -2, -1), dx, -1, -1)

    def inside_for_own(dy, dx):
        hq, eq = nb(h, dy, dx), nb(e, dy, dx)
        return (hq == h) | ((h <= 4) & (hq > 4) & (eq == h))

    fb = h > 0
    interior = (fb & inside_for_own(1, 0) & inside_for_own(-1, 0)
                & inside_for_own(0, 1) & inside_for_own(0, -1))
    y = torch.arange(H, device=dev, dtype=torch.int64).view(H, 1)
    x = torch.arange(W, device=dev, dtype=torch.int64).view(1, W)
    cnt = fb.to(torch.int64)
    w2 = torch.where(interior, 2, 1) * cnt
    owncls = torch.where(h > 4, h - 4, h).to(torch.int64) * cnt
    planes = [cnt, (fb & ~interior).to(torch.int64), w2, w2 * x, w2 * y,
              owncls]
    acc = torch.zeros(B * K, 6, dtype=torch.int64, device=dev)
    base = (torch.arange(B, device=dev, dtype=torch.int64) * K).view(B, 1, 1)

    def add(keys, vals):
        sel = keys >= 0
        idx = (keys.to(torch.int64) + base)[sel]
        acc.index_add_(0, idx, torch.stack(
            [v.expand(B, H, W)[sel] for v in vals], dim=1))

    add(cid, planes)
    if cide is not None:
        cont = (h > 4).to(torch.int64)
        add(torch.where(h > 4, cide, -1),
            [cont, torch.zeros_like(cont), 2 * cont, 2 * cont * x,
             2 * cont * y, cont * e.to(torch.int64)])
    return _stats_from_sums(acc.view(B, K, 6).transpose(1, 2))


# ---------------------------------------------------------------------------
# the kernels' launch plans
# ---------------------------------------------------------------------------
def cc_plan(B: int, H: int, W: int, sm_count: int,
            blocks_per_sm: int = FLOOD_BLOCKS_PER_SM, entry: str = "flood",
            K: int = 256):
    """Launch plan of a ``cc.cu`` entry point for B images of H x W on a
    card of ``sm_count`` SMs. Every entry point is one cooperative launch
    of as many FLOOD_THREADS-thread blocks as the card holds at once
    (``sm_count * blocks_per_sm``), which grid-stride over work items; no
    block's shared memory depends on B, H or W. The C side refuses a plan
    that is not this one or whose blocks the card cannot hold at once.
    ``entry``:

    * ``"flood"``: ``mfc_flood_cc_cid`` and ``mfc_union_flood_cc_cid``.
      FLOOD_TILE-edge tiles and FLOOD_CHUNK-pixel rank chunks per image;
      the dynamic shared memory of the largest tile phase (the union
      kernel's halo tile of ``he``, a parent plane and the link and
      run-start lists, or a parent plane, the lists and a class tile); the
      int32 workspace per image (the planes and the chunk counts).
    * ``"cc_labels"``: ``mfc_cc_labels``. The same tiles and the shared
      memory of a mask tile's phase; no workspace (the labels are the
      working plane) and no chunks.
    * ``"onehot_stats"``: ``mfc_onehot_stats`` with K slots. No tiles;
      FLOOD_CHUNK-pixel items; the STATS_ROWS x K uint64 sums in shared
      memory; the (STATS_ROWS, K) uint64 accumulator per image, counted
      in int32s.

    Raises ``ValueError`` for images that the kernels' 32-bit indices
    cannot address, and for K outside 1..MAX_K."""
    if entry not in PLAN_ENTRIES:
        raise ValueError(f"cc_plan: entry must be one of {PLAN_ENTRIES}, "
                         f"got {entry!r}")
    n = H * W
    tile = FLOOD_TILE
    tiles = -(-H // tile) * -(-W // tile)
    chunks = -(-n // FLOOD_CHUNK)
    tt, ht = tile * tile, (tile + 2) ** 2
    mask_tile_bytes = 4 * tt + 2 * 3 * tt + tt
    beyond = n >= 2 ** 31
    if entry == "flood":
        beyond |= FLOOD_PLANES * n + chunks >= 2 ** 31
        plan = {"tile": tile,
                "shared_bytes": max(4 * (ht + tt) + 2 * 3 * tt,
                                    mask_tile_bytes),
                "work_ints": FLOOD_PLANES * n + chunks, "chunk": FLOOD_CHUNK,
                "tiles": tiles, "chunks": chunks}
    elif entry == "cc_labels":
        beyond |= B * tiles >= 2 ** 31
        plan = {"tile": tile, "shared_bytes": mask_tile_bytes,
                "work_ints": 0, "chunk": 0, "tiles": tiles, "chunks": 0}
    else:
        if not 0 < K <= MAX_K:
            raise ValueError(f"onehot_stats: K must be in 1..{MAX_K}, "
                             f"got {K}")
        # a warp's sum of a plane (32 lanes of up to 2 * coordinate) must
        # stay below 2^32
        beyond |= 64 * max(H, W) >= 2 ** 32 or B * chunks >= 2 ** 31
        plan = {"tile": 0, "shared_bytes": 8 * STATS_ROWS * K,
                "work_ints": 2 * STATS_ROWS * K, "chunk": FLOOD_CHUNK,
                "tiles": 0, "chunks": chunks}
    if beyond:
        raise ValueError(f"{entry}: {B} images of {H}x{W} are beyond the "
                         "kernels' 32-bit indices")
    return dict(plan, threads=FLOOD_THREADS, grid=sm_count * blocks_per_sm)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------
def _check(t, name, dtype, ndim=3):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _plan_ints(B, H, W, device, entry="flood", K=256):
    """(plan, its ints for the C side) of one call."""
    plan = cc_plan(B, H, W, _sm_count(device), entry=entry, K=K)
    return plan, (ctypes.c_int * len(PLAN_KEYS))(*(plan[k] for k in PLAN_KEYS))


def _launch_planned(name, rc, plan):
    if rc == PLAN_REFUSED:
        raise RuntimeError(f"CUDA kernel {name} refused the plan {plan}: "
                           "not this shape's, or more blocks than the card "
                           "holds at once")
    _launch(name, rc)


def connected_components(mask, connectivity: int = 8):
    """(B, H, W) bool -> int32 labels (see
    :func:`connected_components_plain`)."""
    _check(mask, "mask", torch.bool)
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if _route(mask) == "cpu":
        return connected_components_plain(mask, connectivity)
    B, H, W = mask.shape
    lab = torch.empty(B, H, W, dtype=torch.int32, device=mask.device)
    plan, ints = _plan_ints(B, H, W, mask.device, "cc_labels")
    rc = _lib().mfc_cc_labels(mask.data_ptr(), lab.data_ptr(), B, H, W,
                              connectivity, ints, _stream(mask))
    _launch_planned("connected_components", rc, plan)
    return lab


def _flood_plan(B, H, W, device):
    """(plan, its ints for the C side, the workspace) of one flood call."""
    plan, ints = _plan_ints(B, H, W, device)
    work = torch.empty(B * plan["work_ints"], dtype=torch.int32,
                       device=device)
    return plan, ints, work


def flood_cc_cid(mask, K: int = 256):
    """(B, H, W) bool -> (cid, filled, ncomp) (see
    :func:`flood_cc_cid_plain`)."""
    _check(mask, "mask", torch.bool)
    if _route(mask) == "cpu":
        return flood_cc_cid_plain(mask, K)
    B, H, W = mask.shape
    dev = mask.device
    lib = _lib()
    cid = torch.empty(B, H, W, dtype=torch.int32, device=dev)
    filled = torch.empty_like(cid)
    ncomp = torch.empty(B, dtype=torch.int32, device=dev)
    plan, ints, work = _flood_plan(B, H, W, dev)
    rc = lib.mfc_flood_cc_cid(
        mask.data_ptr(), cid.data_ptr(), filled.data_ptr(),
        ncomp.data_ptr(), work.data_ptr(), B, H, W, K, ints, _stream(mask),
    )
    _launch_planned("flood_cc_cid", rc, plan)
    return cid, filled, ncomp


def union_flood_cc_cid(ucls, K: int = 256):
    """(B, H, W) int8 in {0..4} -> (cid, he, cide, ncomp, conflict) (see
    :func:`union_flood_cc_cid_plain`)."""
    _check(ucls, "ucls", torch.int8)
    if _route(ucls) == "cpu":
        return union_flood_cc_cid_plain(ucls, K)
    B, H, W = ucls.shape
    dev = ucls.device
    lib = _lib()
    cid = torch.empty(B, H, W, dtype=torch.int32, device=dev)
    he = torch.empty_like(cid)
    cide = torch.empty_like(cid)
    ncomp = torch.empty(B, dtype=torch.int32, device=dev)
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    plan, ints, work = _flood_plan(B, H, W, dev)
    rc = lib.mfc_union_flood_cc_cid(
        ucls.data_ptr(), cid.data_ptr(), he.data_ptr(), cide.data_ptr(),
        ncomp.data_ptr(), conflict.data_ptr(), work.data_ptr(),
        B, H, W, K, ints, _stream(ucls),
    )
    _launch_planned("union_flood_cc_cid", rc, plan)
    return cid, he, cide, ncomp, conflict != 0


def onehot_stats(cid, he, cide=None, K: int = 256):
    """Per-slot sums -> (stats (B, 8, K) f32, ccls (B, K) int32) (see
    :func:`onehot_stats_plain`)."""
    _check(cid, "cid", torch.int32)
    _check(he, "he", torch.int32)
    if cide is not None:
        _check(cide, "cide", torch.int32)
    if cid.shape != he.shape or (cide is not None and cide.shape != cid.shape):
        raise ValueError("cid, he and cide must have one shape")
    if not 0 < K <= MAX_K:
        raise ValueError(f"K must be in 1..{MAX_K}, got {K}")
    if _route(cid, he, cide) == "cpu":
        return onehot_stats_plain(cid, he, cide, K)
    B, H, W = cid.shape
    dev = cid.device
    stats = torch.empty(B, 8, K, dtype=torch.float32, device=dev)
    ccls = torch.empty(B, K, dtype=torch.int32, device=dev)
    plan, ints = _plan_ints(B, H, W, dev, "onehot_stats", K)
    acc = torch.empty(B * plan["work_ints"], dtype=torch.int32, device=dev)
    rc = _lib().mfc_onehot_stats(
        cid.data_ptr(), he.data_ptr(),
        None if cide is None else cide.data_ptr(),
        stats.data_ptr(), ccls.data_ptr(), acc.data_ptr(),
        B, H, W, K, ints, _stream(cid),
    )
    _launch_planned("onehot_stats", rc, plan)
    return stats, ccls


# ---------------------------------------------------------------------------
# composites (base_stats_pallas / union_stats_pallas)
# ---------------------------------------------------------------------------
def base_stats(mask, K: int = 256, return_cid: bool = False):
    """(..., H, W) bool class masks -> (stats (..., 8, K) f32, ncomp
    (...,) int32[, cid (..., H, W) int32]) of each HOLE-FILLED mask:
    rows [count, boundary count, sum w, sum w*x, sum w*y], row 5 column 0
    the component count (> K means slot aliasing)."""
    H, W = mask.shape[-2:]
    lead = mask.shape[:-2]
    cid, filled, ncomp = flood_cc_cid(mask.reshape(-1, H, W).contiguous(), K)
    stats, _ = onehot_stats(cid, filled * 8, None, K)
    stats[:, 5] = 0.0
    stats[:, 5, 0] = ncomp.float()
    out = (stats.reshape(lead + (8, K)), ncomp.reshape(lead))
    if return_cid:
        out = out + (cid.reshape(lead + (H, W)),)
    return out


def union_stats(ucls, K: int = 256):
    """(..., H, W) int8 disjoint class image {0..4} -> (stats (..., 8, K),
    ccls (..., K), ncomp (...,), conflict (...,) bool, cid (..., H, W)),
    the contract of ``cc_pallas.union_stats_pallas``."""
    H, W = ucls.shape[-2:]
    lead = ucls.shape[:-2]
    cid, he, cide, ncomp, conflict = union_flood_cc_cid(
        ucls.reshape(-1, H, W).contiguous(), K
    )
    stats, ccls = onehot_stats(cid, he, cide, K)
    return (
        stats.reshape(lead + (8, K)),
        ccls.reshape(lead + (K,)),
        ncomp.reshape(lead),
        conflict.reshape(lead),
        cid.reshape(lead + (H, W)),
    )
