"""Model FLOPs from a configuration's layer shapes, counted as
``torch.utils.flop_counter.FlopCounterMode`` counts the reference
(``reference/models.py``): 2 x multiply-adds of every convolution and matrix
product; a transposed convolution by its input's positions; nothing for
elementwise work, pooling, sampling or norms. The count is of the work the
model needs, whatever implements it, so a change that leaves work out does
not shrink it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Shapes:
    """The sizes the counts depend on, from a configuration file."""

    height: int
    width: int
    num_classes: int
    num_frames: int
    stages: tuple  # VGG16 stage widths, as scaled
    num_filters: int
    raft: dict | None  # widths of the flow provider, None without flow


def shapes_of(config) -> Shapes:
    m = config["model"]
    scale = float(m.get("model_scale", 1.0))
    stages = tuple(tuple(max(4, int(c * scale)) if scale < 1 else c
                         for c in st) for st in m["vgg_stages"])
    nf = max(4, int(m["num_filters"] * scale)) if scale < 1 else \
        m["num_filters"]
    return Shapes(m["height"], m["width"], m["num_classes"], m["num_frames"],
                  stages, nf, config.get("flow"))


def conv(cin, cout, k, h_out, w_out, n=1):
    kh, kw = (k, k) if isinstance(k, int) else k
    return 2 * n * cout * cin * kh * kw * h_out * w_out


def deconv(cin, cout, k, h_in, w_in, n=1):
    return 2 * n * cin * cout * k * k * h_in * w_in


def base_flops(s: Shapes) -> int:
    """TernausNet16, one frame."""
    H, W, nf = s.height, s.width, s.num_filters
    total, cin, skips = 0, 3, []
    for si, stage in enumerate(s.stages):
        h, w = H >> si, W >> si
        for ch in stage:
            total += conv(cin, ch, 3, h, w)
            cin = ch
        skips.append((ch, h, w))
    s1, s2, s3, s4, s5 = (c for c, _, _ in skips)

    def block(cin_, mid, out, h_in, w_in):
        return conv(cin_, mid, 3, h_in, w_in) + deconv(mid, out, 4, h_in,
                                                        w_in)

    h5, w5 = H >> 5, W >> 5
    total += block(s5, nf * 16, nf * 8, h5, w5)                   # center
    total += block(s5 + nf * 8, nf * 16, nf * 8, h5 * 2, w5 * 2)   # dec5
    total += block(s4 + nf * 8, nf * 16, nf * 8, h5 * 4, w5 * 4)   # dec4
    total += block(s3 + nf * 8, nf * 8, nf * 2, h5 * 8, w5 * 8)    # dec3
    total += block(s2 + nf * 2, nf * 4, nf, h5 * 16, w5 * 16)      # dec2
    total += conv(s1 + nf, nf, 3, H, W)                            # dec1
    total += conv(nf, s.num_classes, 1, H, W)                      # final
    return total


def head_flops(s: Shapes) -> int:
    """The fusion head, one window (the warp is sampling: no FLOPs)."""
    tc = s.num_frames * s.num_classes
    H, W = s.height, s.width
    return (conv(tc, tc, 11, H, W) + 2 * conv(tc, tc, 3, H, W)
            + conv(tc, s.num_classes, 1, H, W))


def raft_encoder_flops(h, w, out=256, widths=(64, 96, 128)):
    """RAFT's feature or context encoder on one (h, w) image."""
    h, w = (h + 1) // 2, (w + 1) // 2
    total = conv(3, widths[0], 7, h, w)
    cin = widths[0]
    for i, ch in enumerate(widths):
        if i:
            h, w = (h + 1) // 2, (w + 1) // 2
        total += conv(cin, ch, 3, h, w) + conv(ch, ch, 3, h, w)
        if i:  # a strided first block projects its skip
            total += conv(cin, ch, 1, h, w)
        total += 2 * conv(ch, ch, 3, h, w)
        cin = ch
    return total + conv(cin, out, 1, h, w)


def update_flops_per_token(levels=4, radius=4, hidden=128, context=128):
    """One update iteration per 1/8-resolution position: the motion encoder,
    the SepConvGRU and the flow head."""
    corr = levels * (2 * radius + 1) ** 2
    motion = (conv(corr, 256, 1, 1, 1) + conv(256, 192, 3, 1, 1)
              + conv(2, 128, 7, 1, 1) + conv(128, 64, 3, 1, 1)
              + conv(256, 126, 3, 1, 1))
    gin = hidden + context + 128
    gru = 2 * 3 * conv(gin, hidden, (1, 5), 1, 1)
    head = conv(hidden, 256, 3, 1, 1) + conv(256, 2, 3, 1, 1)
    return motion + gru + head


def raft_solve_flops(pairs, h8, w8, iters, levels=4, radius=4, dim=256):
    """The recurrent solve of ``pairs`` feature pairs on an (h8, w8) grid:
    the all-pairs correlation, ``iters`` updates and the mask head."""
    n = h8 * w8
    corr = 2 * pairs * n * n * dim
    upd = iters * pairs * n * update_flops_per_token(levels, radius)
    mask = pairs * (conv(128, 256, 3, h8, w8) + conv(256, 576, 1, h8, w8))
    return corr + upd + mask


def track_frame_flops(s: Shapes) -> int:
    """Model FLOPs of one tracked frame in the incremental engine: the base
    on the new frame, the head on the window and, with flow, both encoders
    on the new frame at half resolution and one solve over its T-1 pairs."""
    total = base_flops(s) + head_flops(s)
    if s.raft:
        h, w = s.height // 2, s.width // 2
        total += 2 * raft_encoder_flops(h, w)
        total += raft_solve_flops(s.num_frames - 1, h // 8, w // 8,
                                  s.raft["iters"], s.raft["corr_levels"],
                                  s.raft["corr_radius"])
    return total


def flow_pair_flops(height, width, raft) -> int:
    """Model FLOPs of one frame pair through RAFT at full resolution (the
    offline flow CLI): both images' features, image 1's context and one
    solve on the 1/8 grid."""
    return (3 * raft_encoder_flops(height, width)
            + raft_solve_flops(1, height // 8, width // 8, raft["iters"],
                               raft["corr_levels"], raft["corr_radius"]))
