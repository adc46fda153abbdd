"""Fused RAFT update iteration (counterpart of
``mfcnet_tpu/ops/raft_update_pallas.py``).

:func:`raft_update` is one RAFT update iteration after convc1/convf1 and
without the mask head: convc2, convf2, the 3x3 over their concatenation,
the SepConvGRU (1x5 then 5x1, gates z/r/q) and the flow head, over
token-major (B, N = H8*W8, C) tensors. On CUDA tensors it launches the
hand-written kernel of ``csrc/raft_update.cu``; on CPU tensors it runs
:func:`raft_update_plain`, the same function with the same rounding
points in plain PyTorch. There is no fallback between the two. Each
launch adds one to :data:`LAUNCHES`. Both routes are the registered
operator ``mfcnet::raft_update`` (``torch.library.custom_op``: CPU kernel
the plain version, CUDA kernel the launch), which takes the packed
weights as tensor inputs and returns new tensors, so that a
``torch.export`` graph (``serve/export.py``) names it and launches the
kernel on the card; a call that is not traced calls the two directly.
The kernel's tile plan, TMA tensor maps and scratch (:class:`_Plan`)
belong to a solve's :class:`UpdateWorkspace` in a live solve, and to the
packed weights' tensor in a traced graph (:data:`_PLANS`): either way they
live as long as their owner.

Every convolution is a sum over its taps of ``shifted(x, dy, dx) @
w[tap]`` with a 2-D bounds mask and float32 accumulation; the operands
(weights, ``c1``, ``f1``, ``inp``, and the intermediates ``c2``, ``f2``,
``y``, the cast of ``net``, ``r*net``, the flow head's hidden layer and
the flow) are rounded to the compute dtype, and the GRU state math is
float32 throughout. The compute dtype is float32 or bfloat16.

The GRU weights' 384 input rows keep torchvision's order:
``[net 0:128 | inp 128:256 | y 256:382 | flow 382:384]``. Channels are
padded only where the kernel's 16-wide fragments need it (y 126 -> 128
output columns, the flow head's 2 -> 16); the TPU kernel's 128-lane
padding and its VMEM-driven batch chunking are not carried over.
Forward only: the provider is frozen.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from mfcnet_tpu_torch.ops._build import (
    counted,
    kernel_lib,
    route,
    stream_of,
    traced,
)

#: kernel launches since the last :func:`reset_launches` (one per call of
#: :func:`raft_update` on CUDA tensors)
LAUNCHES = counted({"raft_update": 0})
#: how many of those calls also wrote ``hx[:, 0:256] = [net | inp]`` (once
#: per solve with an :class:`UpdateWorkspace`), and how many ran the kernel
#: on wgmma and TMA (every one: bfloat16 products, or float32 ones as three
#: TF32 passes)
COUNTS = counted({"hx_fills": 0, "wgmma": 0})

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_T3 = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_T1x5 = tuple((0, dx) for dx in range(-2, 3))
_T5x1 = tuple((dy, 0) for dy in range(-2, 3))
#: the nine convolutions of the step, in the kernel's order
_CONVS = ("c2", "f2", "cv", "zr_h", "q_h", "zr_v", "q_v", "fl1", "fl2")
#: order of the packed tensors handed to the kernel
_WEIGHT_NAMES = tuple(f"{p}_{c}" for c in _CONVS for p in ("w", "b"))
#: the tensors the kernel reads, K-major weights (taps, columns, rows):
#: bfloat16 the weight itself, float32 its split into a TF32 part and the
#: rest (:func:`split_tf32`), each beside its bias
_KMAJOR_NAMES = {
    torch.bfloat16: tuple(f"{p}_{c}" for c in _CONVS for p in ("wt", "b")),
    torch.float32: tuple(f"{p}_{c}" for c in _CONVS
                         for p in ("wtb", "wts", "b")),
}
#: output columns of each convolution as packed (126 -> 128, 2 -> 16)
_CONV_COLS = (192, 64, 128, 256, 128, 256, 128, 256, 16)
#: the launch each convolution belongs to: c2 and f2 share the first grid
_CONV_STAGE = (0, 0, 1, 2, 3, 4, 5, 6, 7)
#: the kernel indexes its widest buffer (384 columns) with 32 bits
MAX_TOKENS = (2 ** 31 - 1) // 384
_TRAINING = ("the fused update step has no backward, as the JAX kernel "
             "has no VJP either (raft_update_pallas is a bare pallas_call: "
             "mfcnet_tpu/ops/raft_update_pallas.py:295); a differentiated "
             "RAFT runs the plain UpdateBlock (fused_update=False)")


def reset_launches():
    for d in (LAUNCHES, COUNTS):
        for k in d:
            d[k] = 0


def _taps(conv):
    """Conv2d weight (O, I, kh, kw) -> (kh*kw, I, O) per-tap matrices."""
    w = conv.weight.detach()
    o, i, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, i, o)


def _pad_cols(w, n):
    return F.pad(w, (0, n - w.shape[-1])) if w.shape[-1] < n else w


def split_tf32(w):
    """float32 ``w`` -> (big, small): big = w rounded to TF32 (10 explicit
    mantissa bits, to nearest, ties away from zero: its low 13 bits zero)
    by integer arithmetic on the bits, as the kernel splits its
    activations, and small = w - big, exact in float32, so that big +
    small == w."""
    if w.dtype != torch.float32:
        raise TypeError(f"split_tf32: expected float32, got {w.dtype}")
    bits = w.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return big, w - big


def pack_update_weights(update_block, compute_dtype=torch.bfloat16):
    """``models.raft.UpdateBlock`` -> dict of product-ready tensors:
    weights (taps, rows, columns) in ``compute_dtype``, biases float32, and
    the weights K-major (taps, columns, rows) as the kernel reads them:
    bfloat16 ``wt_*``; float32 ``wtb_*`` and ``wts_*``, the split
    (:func:`split_tf32`) of its three TF32 products. convcorr1/convflow1
    run outside the kernel (:func:`fused_update_step`) and are not packed.
    z and r of each GRU direction share one weight (columns ``[z | r]``)
    because they share every shifted input tap."""
    if compute_dtype not in _DTYPES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, "
                        f"got {compute_dtype}")
    enc, gru = update_block.motion_encoder, update_block.recurrent_block
    head = update_block.flow_head

    def w(t, n=None):
        t = _pad_cols(t, n) if n else t
        return t.to(compute_dtype).contiguous()

    def b(conv, n=None):
        t = conv.bias.detach().float()
        return (_pad_cols(t, n) if n else t).contiguous()

    out = {
        "w_c2": w(_taps(enc.convcorr2[0])), "b_c2": b(enc.convcorr2[0]),
        "w_f2": w(_taps(enc.convflow2[0])), "b_f2": b(enc.convflow2[0]),
        # rows 0:192 act on c2, 192:256 on f2; 126 real columns
        "w_cv": w(_taps(enc.conv[0]), 128), "b_cv": b(enc.conv[0], 128),
        "w_fl1": w(_taps(head.conv1)), "b_fl1": b(head.conv1),
        "w_fl2": w(_taps(head.conv2), 16), "b_fl2": b(head.conv2, 16),
    }
    for d, g in (("h", gru.convgru1), ("v", gru.convgru2)):
        out[f"w_zr_{d}"] = w(torch.cat([_taps(g.convz), _taps(g.convr)], -1))
        out[f"b_zr_{d}"] = torch.cat([b(g.convz), b(g.convr)]).contiguous()
        out[f"w_q_{d}"] = w(_taps(g.convq))
        out[f"b_q_{d}"] = b(g.convq)
    # the kernel reads both operands K-major: (taps, columns, rows)
    for c in _CONVS:
        wt = out[f"w_{c}"].transpose(1, 2).contiguous()
        if compute_dtype == torch.bfloat16:
            out[f"wt_{c}"] = wt
        else:
            out[f"wtb_{c}"], out[f"wts_{c}"] = split_tf32(wt)
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _tap_conv(x, w, bias, taps, H8, W8):
    """Sum over taps of shifted(x) @ w[tap] + bias, float32. x: (B, N, K)
    already rounded to the compute dtype; w: (taps, K, O)."""
    B, N, K = x.shape
    pad = max(max(abs(dy), abs(dx)) for dy, dx in taps)
    img = F.pad(x.float().view(B, H8, W8, K), (0, 0, pad, pad, pad, pad))
    acc = bias.view(1, 1, -1).expand(B, N, -1)
    for t, (dy, dx) in enumerate(taps):
        xt = img[:, pad + dy:pad + dy + H8, pad + dx:pad + dx + W8]
        acc = acc + xt.reshape(B, N, K) @ w[t].float()
    return acc


def compute_dtype_of(packed):
    """The compute dtype of packed update weights (:func:`pack_update_weights`
    or only their K-major part, :data:`_KMAJOR_NAMES`)."""
    for k in ("w_c2", "wt_c2", "wtb_c2"):
        if k in packed:
            return packed[k].dtype
    raise KeyError("not packed update weights: no w_c2, wt_c2 or wtb_c2")


def _row_major(packed):
    """``packed`` with its (taps, rows, columns) weights ``w_*``, rebuilt
    from the K-major ones where only those are held (float32: big + small
    is the weight exactly)."""
    if "w_c2" in packed:
        return packed
    out = dict(packed)
    for c in _CONVS:
        wt = (packed[f"wt_{c}"] if f"wt_{c}" in packed
              else packed[f"wtb_{c}"] + packed[f"wts_{c}"])
        out[f"w_{c}"] = wt.transpose(1, 2)
    return out


def raft_update_plain(c1, f1, inp, net, flow, packed, H8: int, W8: int,
                      workspace=None):
    """Plain version of :func:`raft_update` (same contract, any device; it
    keeps nothing between calls, so a ``workspace`` is not used)."""
    packed = _row_major(packed)
    cdt = packed["w_c2"].dtype
    c1, f1, inp = c1.to(cdt), f1.to(cdt), inp.to(cdt)
    net = net.float()
    fl = flow.to(cdt)

    def conv(x, name, taps):
        return _tap_conv(x, packed[f"w_{name}"], packed[f"b_{name}"], taps,
                         H8, W8)

    c2 = torch.relu(conv(c1, "c2", _T3)).to(cdt)
    f2 = torch.relu(conv(f1, "f2", _T3)).to(cdt)
    y = torch.relu(conv(torch.cat([c2, f2], -1), "cv", _T3))[..., :126]
    y = y.to(cdt)
    for d, taps in (("h", _T1x5), ("v", _T5x1)):
        hx = torch.cat([net.to(cdt), inp, y, fl], -1)      # (B, N, 384)
        zr = conv(hx, f"zr_{d}", taps)
        z = torch.sigmoid(zr[..., :128])
        r = torch.sigmoid(zr[..., 128:])
        rhx = torch.cat([(r * net).to(cdt), inp, y, fl], -1)
        q = torch.tanh(conv(rhx, f"q_{d}", taps))
        net = (1.0 - z) * net + z * q
    fh = torch.relu(conv(net.to(cdt), "fl1", _T3)).to(cdt)
    delta = conv(fh, "fl2", _T3)[..., :2]
    return net, delta


# ---------------------------------------------------------------------------
# the kernel's tile plan (host side, pure)
# ---------------------------------------------------------------------------
#: tokens per block of the wgmma design: two consumer warpgroups of 64
TILE_TOKENS = 128
#: column-tile width of each of the eight launches (c2 || f2, cv, zr_h, q_h,
#: zr_v, q_v, fl1, fl2)
_COLUMN_WIDTHS = (64, 128, 128, 128, 128, 128, 128, 16)
#: a launch's clusters grow while it has no more blocks than this, up to
#: the portable cluster size: about one and a half per SM of an H100's 132
#: (tools/raft_update_sweep.py at 1,200 to 4,800 tokens, bf16: 160 to 230
#: level, 132 and 264 slower; the float32 route, timed at 132 and 200 by
#: tools/raft_f32_variants.py, is faster at 200 too)
TARGET_BLOCKS = 200
MAX_CLUSTER = 8
#: a TMA box holds at most this many elements along any dimension
_MAX_BOX = 256


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the wgmma design cuts one solve: a token tile is ``rows`` image
    rows x ``cols`` columns (``rows * cols`` <= :data:`TILE_TOKENS`),
    ``tiles_y * tiles_x`` tiles per image; launch ``i`` has
    ``B * tiles_y * tiles_x * clusters[i]`` x ``column_tiles[i]`` blocks of
    ``column_widths[i]`` output columns, the ``clusters[i]`` blocks of a
    cluster each summing a subset of the tile's taps. ``config``:
    "clusters" while some launch splits its taps so that every SM pulls a
    share of the weights, "tiles" once the token tiles alone fill the card
    (from about 13,000 tokens on)."""
    config: str
    rows: int
    cols: int
    tiles_y: int
    tiles_x: int
    column_widths: tuple
    column_tiles: tuple
    clusters: tuple

    def tiles(self):
        """((y0, y1), (x0, x1)) of every token tile of one image."""
        return [((ty * self.rows, (ty + 1) * self.rows),
                 (tx * self.cols, (tx + 1) * self.cols))
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]


def tile_plan(B: int, H8: int, W8: int) -> TilePlan:
    """The tile plan of a solve at B x H8 x W8 tokens, for both compute
    types: the token tile of whole or x-segmented image rows that covers an
    image with the fewest tiles (fewest x segments among equals: 3 x 40 at
    30x40 and at 60x80), and each launch's cluster size from its block
    count (:data:`TARGET_BLOCKS`), which is where the token count picks the
    kernel's configuration. The C side (``mfc_raft_plan_init``) computes
    the same plan for the float32 route and refuses any other; for the
    bfloat16 route it refuses a plan outside the kernel's limits (error
    20002)."""
    M = B * H8 * W8
    if min(B, H8, W8) < 1:
        raise ValueError(f"raft_update: empty grid {B}x{H8}x{W8}")
    if M > MAX_TOKENS:
        raise ValueError(
            f"raft_update: {M} tokens exceed the kernel's 32-bit index "
            f"limit of {MAX_TOKENS} tokens per call; split the batch")
    best = None
    for nx in range(1, W8 + 1):
        cols = -(-W8 // nx)
        if cols > min(TILE_TOKENS, _MAX_BOX):
            continue
        rows = min(TILE_TOKENS // cols, H8, _MAX_BOX)
        key = (-(-H8 // rows) * -(-W8 // cols), nx)
        if best is None or key < best[0]:
            best = (key, rows, cols)
        if cols == 1:
            break
    _, rows, cols = best
    tiles_y, tiles_x = -(-H8 // rows), -(-W8 // cols)
    column_tiles = [0] * 8
    for n, stage in zip(_CONV_COLS, _CONV_STAGE):
        column_tiles[stage] += n // _COLUMN_WIDTHS[stage]
    clusters = tuple(
        max(1, min(MAX_CLUSTER,
                   TARGET_BLOCKS // (B * tiles_y * tiles_x * ct)))
        for ct in column_tiles)
    config = "clusters" if max(clusters) > 1 else "tiles"
    return TilePlan(config, rows, cols, tiles_y, tiles_x, _COLUMN_WIDTHS,
                    tuple(column_tiles), clusters)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------
def _check(t, name, shape, dtype):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


class _Plan:
    """One solve shape's kernel state on the card: the C plan (the tile
    plan and the TMA tensor maps of the weights and of the scratch), the
    scratch tensors, and what the last call left in ``hx``. The scratch
    holds B*H8*W8 tokens x 2,560 bytes in bfloat16 (4,608 in float32):
    6.1 MB at the tracker's 2,400 tokens, 98 MB at the trainer's 38,400."""

    def __init__(self, B, H8, W8, cdt, weights, device):
        M = B * H8 * W8

        def buf(*shape, dtype=cdt):
            return torch.empty(*shape, dtype=dtype, device=device)

        # cf = [c2 | f2], hx = [net | inp | y | flow], r*net, the flow
        # head's hidden layer, z
        self.scratch = [buf(M, 256), buf(M, 384), buf(M, 128), buf(M, 256),
                        buf(M, 128, dtype=torch.float32)]
        lib = kernel_lib()
        self.buf = ctypes.create_string_buffer(lib.mfc_raft_plan_bytes())
        p = tile_plan(B, H8, W8)
        tile = (ctypes.c_int * 18)(p.rows, p.cols, *p.column_widths,
                                   *p.clusters)
        rc = lib.mfc_raft_plan_init(self.buf, _ptrs(weights),
                                    _ptrs(self.scratch), B, H8, W8,
                                    _DTYPES[cdt], tile)
        if rc != 0:
            raise RuntimeError(f"raft_update: the tile plan {p} was refused "
                               f"(error {rc}: 10000 + CUresult of a tensor "
                               f"map, 20001 cuTensorMapEncodeTiled not found "
                               f"in libcuda, 20002 a plan other than "
                               f"tile_plan's)")
        #: (net', inp) data pointers of the last call: hx holds [net' | inp]
        self.held = None


def _plan_in(plans: dict, c1, H8, W8, weights):
    """The plan of a call from its owner's ``plans``, made on first use.
    Its key is the solve shape, the dtype, the device, the stream and the
    weights' addresses, which its tensor maps hold: a plan runs only the
    weights at those addresses, on one stream."""
    key = (tuple(c1.shape[:1]) + (H8, W8), weights[0].dtype, c1.device,
           stream_of(c1), tuple(w.data_ptr() for w in weights))
    plan = plans.get(key)
    if plan is None:
        plan = plans[key] = _Plan(c1.shape[0], H8, W8, weights[0].dtype,
                                  weights, c1.device)
    return plan


class UpdateWorkspace:
    """What one recurrent solve keeps between its calls of
    :func:`raft_update`: which state it returned last and, on the card, the
    kernel's plans (:class:`_Plan`: scratch, tile plan and TMA tensor maps),
    made by its first call and freed with it. ``hx = [net | inp | y |
    flow]`` lives across the calls in the plan's scratch: the kernel leaves
    ``net'`` in ``hx[:, 0:128]`` and ``inp`` does not change during a
    solve, so ``[net | inp]`` is written on the first call only
    (:meth:`holds` decides, by identity of the tensors, which also holds
    while ``torch.export`` traces a solve: the graph then asks for the fill
    on its first call only). Each call returns new tensors; ``net`` is
    never written.

    ``plan`` is the kernel's tile plan of the solve (:func:`tile_plan`),
    computed when asked for: a traced solve with a symbolic batch never
    asks."""

    def __init__(self, B: int, H8: int, W8: int, packed, device):
        self.shape = (B, H8, W8)
        self.cdt = compute_dtype_of(packed)
        self.device = torch.device(device)
        self.design = _DESIGNS[self.cdt]
        self.plans = {}
        self._held = None

    @functools.cached_property
    def plan(self) -> "TilePlan":
        return tile_plan(*self.shape)

    def holds(self, net, inp) -> bool:
        """Whether ``hx[:, 0:256]`` already is ``[net | inp]``: ``net`` is
        the state this workspace returned last and ``inp`` the tensor it
        was filled from, both unchanged since."""
        if self._held is None:
            return False
        h_net, v_net, h_inp, v_inp = self._held
        return (net is h_net and net._version == v_net
                and inp is h_inp and inp._version == v_inp)

    def returned(self, net_out, inp):
        self._held = (net_out, net_out._version, inp, inp._version)


#: the kernel's products by compute dtype, both on wgmma fed by TMA:
#: bfloat16 operands, or float32 ones split into three TF32 products
_DESIGNS = {torch.float32: "3xtf32", torch.bfloat16: "wgmma"}


def raft_update(c1, f1, inp, net, flow, packed, H8: int, W8: int,
                workspace: UpdateWorkspace | None = None):
    """One fused RAFT update iteration.

    c1 (B, N, 256) = relu(convcorr1(correlation lookup)), f1 (B, N, 128) =
    relu(convflow1(flow)) and inp (B, N, 128) in the compute dtype of
    ``packed`` (:func:`pack_update_weights`, or its K-major part alone);
    net (B, N, 128) and flow (B, N, 2) float32; N = H8*W8 tokens in raster
    order. Returns new tensors (net', delta flow), float32, shaped like
    (net, flow); ``net`` is never written.

    ``workspace``: the :class:`UpdateWorkspace` of a recurrent solve, which
    lets every call but the first skip writing ``[net | inp]`` into the
    kernel's scratch and keeps the kernel's plan across the calls; without
    one, each call writes it, on a plan of its own. A traced call (see
    ``ops/_build.py::traced``) goes through the registered operator
    ``mfcnet::raft_update``, with the K-major weights as its tensor
    inputs."""
    cdt = compute_dtype_of(packed)
    B, N = c1.shape[:2]
    if N != H8 * W8:
        raise ValueError(f"{N} tokens for an {H8}x{W8} grid")
    _check(c1, "c1", (B, N, 256), cdt)
    _check(f1, "f1", (B, N, 128), cdt)
    _check(inp, "inp", (B, N, 128), cdt)
    _check(net, "net", (B, N, 128), torch.float32)
    _check(flow, "flow", (B, N, 2), torch.float32)
    tensors = (c1, f1, inp, net, flow)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"an input requires a gradient, but {_TRAINING}")
    weights = [packed[k] for k in _KMAJOR_NAMES[cdt]]
    where = route(*tensors, *weights)
    ws = workspace
    if ws is not None and (
            ws.shape != (B, H8, W8) or ws.cdt != cdt
            or ws.device.type != c1.device.type
            or ws.device.index not in (None, c1.device.index)):
        raise ValueError(
            f"workspace for {ws.shape} {ws.cdt} on {ws.device}, call at "
            f"{(B, H8, W8)} {cdt} on {c1.device}")
    fill = ws is None or not ws.holds(net, inp)
    if traced(*tensors):
        net_out, delta = torch.ops.mfcnet.raft_update(
            *tensors, weights, H8, W8, fill)
    elif where == "cpu":
        net_out, delta = _raft_update_cpu(*tensors, weights, H8, W8, fill)
    else:
        plan = _plan_in({} if ws is None else ws.plans, c1, H8, W8, weights)
        net_out, delta = _launch(plan, *tensors, fill)
    if ws is not None:
        ws.returned(net_out, inp)
    return net_out, delta


def _raft_update_cpu(c1: torch.Tensor, f1: torch.Tensor, inp: torch.Tensor,
                     net: torch.Tensor, flow: torch.Tensor,
                     weights: List[torch.Tensor], H8: int, W8: int,
                     fill: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    packed = dict(zip(_KMAJOR_NAMES[weights[0].dtype], weights))
    net_out, delta = raft_update_plain(c1, f1, inp, net, flow, packed, H8,
                                       W8)
    COUNTS["hx_fills"] += int(fill)
    return net_out.contiguous(), delta.contiguous()


# ``mfcnet::raft_update``: the update iteration as a registered operator, so
# that an exported graph names it and launches the kernel on the card. Its
# CPU kernel is the plain version, its CUDA kernel the launch; no other
# device has one. ``weights`` are the K-major tensors of
# ``_KMAJOR_NAMES[dtype]``; ``fill`` asks for ``[net | inp]`` to be written
# into the scratch first (the CUDA kernel writes it anyway unless ``net`` is
# what the same plan returned last and ``inp`` what it was filled from).
_raft_update_op = torch.library.custom_op(
    "mfcnet::raft_update", _raft_update_cpu, mutates_args=(),
    device_types="cpu")


@_raft_update_op.register_fake
def _raft_update_fake(c1, f1, inp, net, flow, weights, H8, W8, fill):
    return (torch.empty_like(net, memory_format=torch.contiguous_format),
            torch.empty_like(flow, memory_format=torch.contiguous_format))


#: the operator's kernel plans (:class:`_Plan`), by the tensor that holds
#: the first packed weight: an exported program's constant, or a serving
#: module's buffer. The plans of a set of weights live as long as it does,
#: so a CUDA graph that captured a call replays into live scratch while its
#: weights live; each stream has plans of its own
_PLANS = WeakIdKeyDictionary()


@_raft_update_op.register_kernel("cuda")
def _raft_update_cuda(c1, f1, inp, net, flow, weights, H8, W8, fill):
    for t, name in ((c1, "c1"), (f1, "f1"), (inp, "inp"), (net, "net"),
                    (flow, "flow")):
        if not t.is_contiguous():
            raise ValueError(f"raft_update: {name} must be contiguous")
    plans = _PLANS.get(weights[0])
    if plans is None:
        plans = _PLANS[weights[0]] = {}
    return _launch(_plan_in(plans, c1, H8, W8, weights), c1, f1, inp, net,
                   flow, fill)


def _launch(plan, c1, f1, inp, net, flow, fill):
    """One launch of the kernel on ``plan``: new (net', delta)."""
    B, N = c1.shape[:2]
    fill = fill or plan.held != (net.data_ptr(), inp.data_ptr())
    net_out = torch.empty(B, N, 128, dtype=torch.float32, device=c1.device)
    delta = torch.empty(B, N, 2, dtype=torch.float32, device=c1.device)
    plan.held = None
    rc = kernel_lib().mfc_raft_update_tma(
        plan.buf, _ptrs((c1, f1, inp, net, flow)), net_out.data_ptr(),
        delta.data_ptr(), int(fill), stream_of(c1))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel raft_update "
                           f"({_DESIGNS[c1.dtype]}) failed: error {rc}")
    plan.held = (net_out.data_ptr(), inp.data_ptr())
    LAUNCHES["raft_update"] += 1
    COUNTS["wgmma"] += 1
    COUNTS["hx_fills"] += int(fill)
    return net_out, delta


# ---------------------------------------------------------------------------
# the update step and the recurrent solve around the kernel
# ---------------------------------------------------------------------------
def fused_update_step(update_block, packed, corr, inp, net, flow, H8: int,
                      W8: int, workspace: UpdateWorkspace | None = None):
    """One full update step == ``UpdateBlock`` without the mask head, on
    token-major tensors: convcorr1 (a 1x1 product on the lookup) and
    convflow1 (a 7x7 conv on the 2-channel flow) in PyTorch, then
    :func:`raft_update` for everything else.

    corr (B, N, L*81) float32, inp (B, N, 128) in the compute dtype, net
    (B, N, 128) and flow (B, N, 2) float32 -> (net', delta flow).
    ``workspace``: as for :func:`raft_update`."""
    cdt = compute_dtype_of(packed)
    enc = update_block.motion_encoder
    B, N, _ = corr.shape
    wc1 = enc.convcorr1[0]
    c1 = torch.relu(F.linear(corr.to(cdt), wc1.weight.flatten(1).to(cdt),
                             wc1.bias.to(cdt)))
    wf1 = enc.convflow1[0]
    fl_img = flow.to(cdt).view(B, H8, W8, 2).permute(0, 3, 1, 2)
    f1 = torch.relu(F.conv2d(fl_img, wf1.weight.to(cdt), wf1.bias.to(cdt),
                             padding=3))
    f1 = f1.permute(0, 2, 3, 1).reshape(B, N, 128)
    return raft_update(c1.contiguous(), f1.contiguous(), inp, net, flow,
                       packed, H8, W8, workspace)


class PackedUpdateWeights(torch.nn.Module):
    """The K-major packed weights of an update block
    (:func:`pack_update_weights`, :data:`_KMAJOR_NAMES`) as buffers. A
    serving module holds them as its RAFT's ``packed_update``, packed once
    when it is built: the weights' addresses, by which the live solve keeps
    its pack (:func:`_packed_for`), do not exist while ``torch.export``
    traces, and an exported graph reads buffers as its constants."""

    def __init__(self, update_block, compute_dtype=torch.bfloat16):
        super().__init__()
        packed = pack_update_weights(update_block, compute_dtype)
        self.names = _KMAJOR_NAMES[compute_dtype]
        for k in self.names:
            self.register_buffer(k, packed[k])

    def packed(self) -> dict:
        return {k: getattr(self, k) for k in self.names}


def _packed_for(model, compute_dtype):
    """Packed weights of ``model.update_block``: those ``model`` holds as
    ``packed_update`` (:class:`PackedUpdateWeights`) in that dtype, or else
    a pack kept on the model until its parameters move or change."""
    held = getattr(model, "packed_update", None)
    if held is not None and compute_dtype_of(held.packed()) == compute_dtype:
        return held.packed()
    params = list(model.update_block.parameters())
    key = (compute_dtype, params[0].device, params[0].dtype,
           tuple((p.data_ptr(), p._version) for p in params))
    cached = getattr(model, "_packed_update", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_update_weights(model.update_block, compute_dtype))
        model._packed_update = cached
    return cached[1]


def fused_flow_from_features(model, f1, f2, net, inp, iters: int = 12,
                             corr_levels: int = 4, corr_radius: int = 4,
                             compute_dtype=torch.bfloat16):
    """``RAFT.flow_from_features`` with the fused update step: the same
    pyramid and lookup, ``iters`` x (lookup, :func:`fused_update_step`),
    then the mask head and the convex upsampling once.

    f1, f2 (B, H8, W8, 256), net, inp (B, H8, W8, 128), NHWC, from
    ``model``'s encoders -> (B, 8*H8, 8*W8, 2) float32 flow in pixels."""
    from mfcnet_tpu_torch.models.raft import (
        PackedPyramid,
        build_corr_pyramid,
        convex_upsample,
        coords_grid,
    )

    pyramid = PackedPyramid(build_corr_pyramid(f1, f2, corr_levels),
                            corr_radius)
    B, H8, W8, _ = f1.shape
    N = H8 * W8
    coords0 = coords_grid(B, H8, W8, f1.device)
    packed = _packed_for(model, compute_dtype)
    net = net.float().reshape(B, N, 128).contiguous()
    inp = inp.to(compute_dtype).reshape(B, N, 128).contiguous()
    flow = torch.zeros(B, N, 2, dtype=torch.float32, device=f1.device)
    # one workspace for the solve: [net | inp] is written into hx by the
    # first call only
    workspace = UpdateWorkspace(B, H8, W8, packed, f1.device)
    for _ in range(iters):
        corr = pyramid.lookup(coords0 + flow.view(B, H8, W8, 2))
        net, delta = fused_update_step(
            model.update_block, packed, corr.view(B, N, -1), inp, net, flow,
            H8, W8, workspace)
        flow = flow + delta
    # the mask head runs once, in float32 on the float32 state
    mp = model.mask_predictor
    x = net.view(B, H8, W8, 128).permute(0, 3, 1, 2)
    m = torch.relu(F.conv2d(x, mp.convrelu[0].weight.float(),
                            mp.convrelu[0].bias.float(), padding=1))
    mask = 0.25 * F.conv2d(m, mp.conv.weight.float(), mp.conv.bias.float())
    return convex_upsample(flow.view(B, H8, W8, 2),
                           mask.permute(0, 2, 3, 1))
