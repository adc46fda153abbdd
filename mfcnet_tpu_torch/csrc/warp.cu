// Bilinear backward warp for the MFCNet Basic head's flow alignment
// (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/ops/warp.py, which holds the plain PyTorch version.
//
// Replaces mfcnet_tpu/ops/warp_pallas.py::banded_warp_pallas
// (_warp_band_kernel) and the tiers around it in mfcnet_tpu/ops/warp.py:
//   mfc_flow_warp  <- flow_warp (base grid + flow -> absolute coordinates ->
//                     the warp), in one pass
//   mfc_warp_abs   <- banded_warp_pallas's own contract (bilinear samples at
//                     source coordinates, zeros padding) behind
//                     grid_sample_bilinear: the normalized grid unnormalized
//                     (either align_corners, zeros or border padding) and
//                     sampled in one pass
//   mfc_backward_warp <- UnFlow's backward warp (linspace base grid + flow
//                     in pixels -> grid_sample, either align_corners, zeros
//                     or border padding) in one pass, any strides
//   mfc_flow_warp_bwd_maps, mfc_flow_warp_bwd_flow <- the VJP that
//                     banded_warp_pallas attaches with jax.custom_vjp
//                     (_banded_warp_bwd, XLA autodiff of
//                     _banded_warp_reference): the gradients of flow_warp
//                     for its maps and for its flow
//
// What bounds them on this card: bytes, and the gather. flow_warp reads two
// flow values and four taps of each of C channels per output pixel and
// writes C values: at 2 x 480 x 640 with C = 5 bf16 maps, ~17 MB moved once,
// 5.1 us at the card's memory rate. The first design (one thread per pixel
// over the flattened B * H * W) took 12.4 us (NVIDIA H100 80GB HBM3, 700 W,
// tools/flowk_times.py). Stripped variants of it (tools/flowk_variants.cu)
// located the time: without the taps it ran at 7.2 us, the time of a plain
// copy of the same bytes (6.8 us); with the taps and no stores at all it
// took the whole 12.3 us. The taps cost not bytes but requests: per pixel
// 20 two-byte loads of rows y0 and y0 + 1, each warp request touching a few
// sectors, and in the flattened layout the next image row, whose upper taps
// are this row's lower ones, lies in another block on another SM.
//
// Design of flow_warp: 2D blocks of 64 x 8 pixels of one image, a thread two
// adjacent x of a row, a warp one 64-pixel row of the tile. The tile's rows
// share their tap rows in the SM's L1; a warp's tap request covers two
// 32-pixel spans; the flow is read as one float2 from each plane and each
// channel's pair is stored as one 4-byte (bf16) or 8-byte (float32) vector;
// the base grid's divisions run once per column and once per row of the
// tile, into shared memory, not per pixel (the same operations on the same
// values: the bits do not change). Of the candidates timed side by side
// (runs of 2 or 4 x on flattened or 2D blocks, 1 pixel a thread on 2D
// blocks, the tap box staged in shared memory, taps read in aligned 8-byte
// pairs) this one was the fastest on smooth and on noisy flow. Odd W or
// misaligned tensors take the same kernel element by element.
//
// UnFlow's backward warp moves 3.3 MB (2 x 3 x 256 x 320 frames and a
// two-channel flow): 1 us at the memory rate, less than a launch costs. What
// bounded it was not the gather but the ~20 elementwise PyTorch kernels that
// formed its coordinates and the layout copies around it, each a launch of
// a few microseconds over one plane; mfc_backward_warp forms the coordinates
// in the kernel and reads and writes any layout in place by its strides
// (channels_last frames and flow, float32 or bfloat16 flow converted on
// load), so the whole warp is one launch and no copy. mfc_warp_abs, timed
// alone on ready coordinates, is faster than F.grid_sample on a ready grid.
//
// The TPU kernel turned the gather into banded one-hot matrix products
// because the TPU has no fast gather, and needed slabs, a band bound and a
// fallback for flow that left the band. A GPU thread gathers directly: no
// band, no slab, no guard: any flow is exact, and taps that leave the image
// read zero.
//
// The coordinates are formed in float32 in the JAX code's order
// (ops/warp.py:198-203 then :36-38) with the round-to-nearest intrinsics, so
// that the compiler fuses no multiply-add and the result equals the plain
// version's bit for bit; the taps blend with float32 weights whatever the
// maps' type.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "shared_memory.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TPB = 256;

inline unsigned blocks_for(size_t n) { return (unsigned)((n + TPB - 1) / TPB); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// normalized grid value -> absolute pixel coordinate
__device__ __forceinline__ float unnormalize(float g, int size,
                                             int align_corners) {
  if (align_corners)
    return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), (float)(size - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f),
                   0.5f);
}

// One pixel's bilinear sample at (fx, fy): the tap row and column, which of
// the four taps lie in the image (the others contribute zero) and the blend
// weights. Validity is tested in float first: a coordinate may be far
// outside int range.
struct Taps {
  float tx, ty, ux, uy;
  int x0, y0;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Taps taps_of(float fx, float fy, int H, int W) {
  Taps q;
  const float x0f = floorf(fx), y0f = floorf(fy);
  q.tx = __fsub_rn(fx, x0f);
  q.ty = __fsub_rn(fy, y0f);
  q.ux = __fsub_rn(1.0f, q.tx);
  q.uy = __fsub_rn(1.0f, q.ty);
  const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
  q.x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)(W - 1));
  q.y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)(H - 1));
  q.v00 = vy0 && vx0;
  q.v01 = vy0 && vx1;
  q.v10 = vy1 && vx0;
  q.v11 = vy1 && vx1;
  return q;
}

// the sample of one channel plane p (element strides sh, sw)
template <typename T>
__device__ __forceinline__ float sample(const Taps& q, const T* p,
                                        ptrdiff_t sh, ptrdiff_t sw) {
  p += (ptrdiff_t)q.y0 * sh + (ptrdiff_t)q.x0 * sw;
  const float a = q.v00 ? to_f32(p[0]) : 0.0f;
  const float b = q.v01 ? to_f32(p[sw]) : 0.0f;
  const float d = q.v10 ? to_f32(p[sh]) : 0.0f;
  const float e = q.v11 ? to_f32(p[sh + sw]) : 0.0f;
  const float top = __fadd_rn(__fmul_rn(a, q.ux), __fmul_rn(b, q.tx));
  const float bot = __fadd_rn(__fmul_rn(d, q.ux), __fmul_rn(e, q.tx));
  return __fadd_rn(__fmul_rn(top, q.uy), __fmul_rn(bot, q.ty));
}

// Four taps of every channel of one image at (fx, fy). img: this batch
// item, element strides sc (channel), sh (row), sw (column); out: this pixel
// of channel 0, channel stride ostride.
template <typename T>
__device__ __forceinline__ void sample_pixel(const T* img, int C, int H, int W,
                                             ptrdiff_t sc, ptrdiff_t sh,
                                             ptrdiff_t sw, float fx, float fy,
                                             T* out, ptrdiff_t ostride) {
  const Taps q = taps_of(fx, fy, H, W);
  for (int c = 0; c < C; ++c)
    from_f32(sample(q, img + c * sc, sh, sw), out + c * ostride);
}

// base grid value 2 * j / (g - 1) - 1 of pixel j on a grid of g
__device__ __forceinline__ float base_grid(int j, int g) {
  return __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, (float)j), (float)(g - 1)),
                   1.0f);
}

// two adjacent values of one channel row, stored as one vector
__device__ __forceinline__ void store_pair(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(float a, float b,
                                           __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// flow_warp: a block owns FW_TW x FW_TH pixels of one image, a thread two
// adjacent x of a row, a warp one row of the tile. VEC (W even, 8-byte
// aligned tensors): the flow read as a float2 from each plane and each
// channel's pair stored as one vector; else element by element.
constexpr int FW_TW = 64, FW_TH = 8;

template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB)
flow_warp_kernel(const T* __restrict__ maps, const float* __restrict__ flow,
                 T* __restrict__ out, int C, int H, int W, int gh, int gw,
                 int align_corners) {
  __shared__ float bxs[FW_TW], bys[FW_TH];
  const int xb = blockIdx.x * FW_TW, yb = blockIdx.y * FW_TH, b = blockIdx.z;
  const int tid = threadIdx.x;
  // the base grid once per column and once per row of the tile
  if (tid < FW_TW)
    bxs[tid] = base_grid(xb + tid, gw);
  else if (tid < FW_TW + FW_TH)
    bys[tid - FW_TW] = base_grid(yb + tid - FW_TW, gh);
  __syncthreads();
  const int lx = (tid % (FW_TW / 2)) * 2, ly = tid / (FW_TW / 2);
  const int x = xb + lx, y = yb + ly;
  if (x >= W || y >= H) return;
  const bool two = x + 1 < W;
  const size_t hw = (size_t)H * W;
  const size_t r = (size_t)y * W + x;
  const float* fl = flow + (size_t)b * 2 * hw + r;
  float flx[2], fly[2];
  if (VEC) {
    const float2 u = *reinterpret_cast<const float2*>(fl);
    const float2 v = *reinterpret_cast<const float2*>(fl + hw);
    flx[0] = u.x;
    flx[1] = u.y;
    fly[0] = v.x;
    fly[1] = v.y;
  } else {
    flx[0] = fl[0];
    fly[0] = fl[hw];
    flx[1] = two ? fl[1] : 0.0f;
    fly[1] = two ? fl[hw + 1] : 0.0f;
  }
  // base grid + flow / ((size - 1) / 2), unnormalized: the JAX code's order
  // (ops/warp.py:198-203 then :36-38)
  Taps q[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float gx =
        __fadd_rn(bxs[lx + k], __fdiv_rn(flx[k], (float)(W - 1) / 2.0f));
    const float gy =
        __fadd_rn(bys[ly], __fdiv_rn(fly[k], (float)(H - 1) / 2.0f));
    q[k] = taps_of(unnormalize(gx, W, align_corners),
                   unnormalize(gy, H, align_corners), H, W);
  }
  const T* img = maps + (size_t)b * C * hw;
  T* o = out + (size_t)b * C * hw + r;
  for (int c = 0; c < C; ++c) {
    const T* p = img + c * hw;
    const float v0 = sample(q[0], p, W, 1);
    if (VEC) {
      store_pair(v0, sample(q[1], p, W, 1), o + c * hw);
    } else {
      from_f32(v0, o + c * hw);
      if (two) from_f32(sample(q[1], p, W, 1), o + c * hw + 1);
    }
  }
}

// mfc_warp_abs: the sample from the normalized grid, as grid_sample takes
// it. Each output pixel's (gx, gy) is unnormalized (either align_corners)
// and, for border padding, clamped to the image in the kernel, in the plain
// version's float32 operations, so that the whole call is one launch. The
// layout is flow_warp's: a block owns FW_TW x FW_TH output pixels of one
// image, a thread two adjacent x of a row. VEC (Wo even, 8-byte aligned
// tensors): the grid pair read as one float2 from each plane and each
// channel's pair stored as one vector; else element by element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB)
warp_abs_kernel(const T* __restrict__ img, const float* __restrict__ gxs,
                const float* __restrict__ gys, T* __restrict__ out, int C,
                int H, int W, int Ho, int Wo, int align_corners, int border) {
  const int tid = threadIdx.x;
  const int lx = (tid % (FW_TW / 2)) * 2, ly = tid / (FW_TW / 2);
  const int x = blockIdx.x * FW_TW + lx, y = blockIdx.y * FW_TH + ly;
  const int b = blockIdx.z;
  if (x >= Wo || y >= Ho) return;
  const bool two = x + 1 < Wo;
  const size_t n = (size_t)Ho * Wo;
  const size_t r = (size_t)y * Wo + x;
  const size_t at = (size_t)b * n + r;
  float gx[2], gy[2];
  if (VEC) {
    const float2 u = *reinterpret_cast<const float2*>(gxs + at);
    const float2 v = *reinterpret_cast<const float2*>(gys + at);
    gx[0] = u.x;
    gx[1] = u.y;
    gy[0] = v.x;
    gy[1] = v.y;
  } else {
    gx[0] = gxs[at];
    gy[0] = gys[at];
    gx[1] = two ? gxs[at + 1] : 0.0f;
    gy[1] = two ? gys[at + 1] : 0.0f;
  }
  Taps q[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float fx = unnormalize(gx[k], W, align_corners);
    float fy = unnormalize(gy[k], H, align_corners);
    if (border) {  // the clamped coordinate also sets the blend weights
      fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
      fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
    }
    q[k] = taps_of(fx, fy, H, W);
  }
  const size_t hw = (size_t)H * W;
  const T* im = img + (size_t)b * C * hw;
  T* o = out + (size_t)b * C * n + r;
  for (int c = 0; c < C; ++c) {
    const T* p = im + c * hw;
    const float v0 = sample(q[0], p, W, 1);
    if (VEC) {
      store_pair(v0, sample(q[1], p, W, 1), o + c * n);
    } else {
      from_f32(v0, o + c * n);
      if (two) from_f32(sample(q[1], p, W, 1), o + c * n + 1);
    }
  }
}

template <typename T>
int launch_warp_abs(const void* img, const void* gx, const void* gy,
                    void* out, int B, int C, int H, int W, int Ho, int Wo,
                    int align_corners, int border, cudaStream_t s) {
  if (B > 65535 || (Ho + FW_TH - 1) / FW_TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Wo + FW_TW - 1) / FW_TW, (Ho + FW_TH - 1) / FW_TH, B);
  const bool vec = Wo % 2 == 0 && ((uintptr_t)gx | (uintptr_t)gy |
                                   (uintptr_t)out) % 8 == 0;
  if (vec)
    warp_abs_kernel<T, true><<<grid, TPB, 0, s>>>(
        (const T*)img, (const float*)gx, (const float*)gy, (T*)out, C, H, W,
        Ho, Wo, align_corners, border);
  else
    warp_abs_kernel<T, false><<<grid, TPB, 0, s>>>(
        (const T*)img, (const float*)gx, (const float*)gy, (T*)out, C, H, W,
        Ho, Wo, align_corners, border);
  return (int)cudaGetLastError();
}

// element strides of a 4-D tensor: batch, channel, row, column
struct Strides {
  int b, c, h, w;
};

// UnFlow's backward warp in one pass: base grid (xs, ys: the W and H values
// of linspace(-1, 1), handed in because linspace steps from both ends and is
// not 2j/(W-1) - 1 bit for bit) + flow / ((size-1)/2) -> unnormalize ->
// clamp (border padding) -> four taps. One thread per output pixel, every
// channel; image, flow and output are read and written in place by their
// strides, the flow converted on load.
template <typename T, typename F>
__global__ void __launch_bounds__(TPB)
backward_warp_kernel(const T* __restrict__ img, Strides si,
                     const F* __restrict__ flow, Strides sf,
                     T* __restrict__ out, Strides so,
                     const float* __restrict__ xs,
                     const float* __restrict__ ys, int B, int C, int H, int W,
                     int align_corners, int border) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * TPB + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const int b = (int)(i / hw);
  const int r = (int)(i - (size_t)b * hw);
  const int y = r / W, x = r - y * W;
  const F* fl = flow + (ptrdiff_t)b * sf.b + (ptrdiff_t)y * sf.h +
                (ptrdiff_t)x * sf.w;
  const float gx = __fadd_rn(
      xs[x], __fdiv_rn(to_f32(fl[0]), (float)(W - 1) / 2.0f));
  const float gy = __fadd_rn(
      ys[y], __fdiv_rn(to_f32(fl[sf.c]), (float)(H - 1) / 2.0f));
  float fx = unnormalize(gx, W, align_corners);
  float fy = unnormalize(gy, H, align_corners);
  if (border) {  // the clamped coordinate also sets the blend weights
    fx = fminf(fmaxf(fx, 0.0f), (float)(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), (float)(H - 1));
  }
  sample_pixel(img + (ptrdiff_t)b * si.b, C, H, W, si.c, si.h, si.w, fx, fy,
               out + (ptrdiff_t)b * so.b + (ptrdiff_t)y * so.h +
                   (ptrdiff_t)x * so.w,
               so.c);
}

template <typename T, typename F>
int launch_backward_warp(const void* img, const void* flow, void* out,
                         const int* st, const float* xs, const float* ys,
                         int B, int C, int H, int W, int align_corners,
                         int border, cudaStream_t s) {
  const Strides si = {st[0], st[1], st[2], st[3]};
  const Strides sf = {st[4], st[5], st[6], st[7]};
  const Strides so = {st[8], st[9], st[10], st[11]};
  backward_warp_kernel<T, F><<<blocks_for((size_t)B * H * W), TPB, 0, s>>>(
      (const T*)img, si, (const F*)flow, sf, (T*)out, so, xs, ys, B, C, H, W,
      align_corners, border);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flow_warp(const void* maps, const void* flow, void* out, int B,
                     int C, int H, int W, int gh, int gw, int align_corners,
                     cudaStream_t s) {
  if (B > 65535 || (H + FW_TH - 1) / FW_TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + FW_TW - 1) / FW_TW, (H + FW_TH - 1) / FW_TH, B);
  const bool vec = W % 2 == 0 && ((uintptr_t)maps | (uintptr_t)flow |
                                  (uintptr_t)out) % 8 == 0;
  if (vec)
    flow_warp_kernel<T, true><<<grid, TPB, 0, s>>>(
        (const T*)maps, (const float*)flow, (T*)out, C, H, W, gh, gw,
        align_corners);
  else
    flow_warp_kernel<T, false><<<grid, TPB, 0, s>>>(
        (const T*)maps, (const float*)flow, (T*)out, C, H, W, gh, gw,
        align_corners);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B1: the backward of flow_warp
//
// The maps gradient sends each output pixel's upstream gradient g to its
// four source taps with the forward's float32 weights: a scatter whose
// targets the flow decides, so many pixels may hit one tap. Its bound is
// bytes: g (B, C, H, W) and the flow read once, the gradient written once;
// at the trainer's shapes (8 x 6 x 480 x 640, bf16 g) 29.5 + 19.7 + 29.5 MB,
// 0.0235 ms at the card's memory rate. The first design scattered with
// float32 atomicAdd (four a pixel and channel, ~59 M at that shape) into a
// (B, C, H, W) float32 accumulator in global memory, zeroed before and cast
// after, in one cooperative launch: 255.6 MB moved, 0.2716 ms (NVIDIA H100
// 80GB HBM3, 700 W). Its stripped variants (tools/flowk_variants.cu) split
// that time: on a smooth flow the atomics took half (0.29 ms against 0.14
// with plain stores), the accumulator's zero and cast passes 0.066; on a
// noisy flow the scattered writes into the 59 MB accumulator took 0.73 ms
// atomic or not. Shared-memory float atomics are no way out on this card:
// they compile to compare-and-swap loops, and a tile design built on them
// was no faster.
//
// Design: destination-owned tiles. The gradient of each image is cut into
// BW_TH x BW_TW pixel tiles; one block sums a tile in shared memory and
// writes it once, so there is no global accumulator and no global float
// atomic. One cooperative launch, its phases split by grid barriers
// (ops/warp.py::warp_bwd_plan fixes tiles, channel groups, grid, shared
// memory and workspace; the C side refuses any other plan):
//   0 zero the per-tile counts and the tile counter;
//   1 count: a warp takes 128 pixels of a row, forms their coordinates
//     (kept for the next phases) and taps and adds each pixel to the count
//     of every distinct tile its in-image taps reach (one; up to four at
//     tile corners), one integer atomic per warp and tile
//     (__match_any_sync);
//   2 scan: block 0 turns the counts into list offsets;
//   3 bin: the same pass on the kept coordinates writes each pixel, with
//     the corner (top-left tap) of its tap box in that tile, into its
//     tiles' lists, a warp's pixels of one tile as one run;
//   4 accumulate: the blocks take (tile, channel group) items from a
//     counter and a tile's list in chunks of BW_CAP entries. A chunk is
//     staged in shared memory (coordinates and g by asynchronous copies)
//     and sorted by corner (a counting sort on shared integer counters);
//     each thread owns a pixel pair and sums, in registers, the entries of
//     the six corners whose boxes reach it, then adds that to the tile's
//     float64 sums, which the block writes once, in g's type. Only where a
//     corner holds more than BW_DENSE entries of a chunk (a flow that
//     converges) does a warp take each corner and add its sums with shared
//     float64 atomics.
// The weights are the forward's float32 operations. It reads the flow
// once, the coordinates twice (the second time through the lists), g once
// and the lists twice (two ints an entry; ~1.14 entries a pixel on a
// smooth flow, at most four), and writes the gradient once: ~185 MB at the
// trainer's shape in bf16. It is bound by the latency of its dependent
// loads and its barriers, not by those bytes (0.15 ms against 0.055 at the
// memory rate): the coordinates are kept so they are formed once, the
// lists carry each entry's corner so staging waits on one load, g arrives
// by cp.async, and the next tile is asked for while one is summed. The workspace
// is sized for the worst case, four entries a pixel, so no flow overflows
// it. The float32 products are summed in float64 and rounded once: the
// counters hand out ranks, and so list and chunk orders, in any order from
// run to run, and float32 sums taken in those orders differed from run to
// run by a few roundings, enough to move a train step's Adam update of
// near-zero gradients. In float64 the order shows only where a sum's
// float64 rounding decides its float32 one. bf16 is the float32 result
// rounded once. A flow that converges puts most
// of an image in one tile's list: one block takes it, chunk by chunk (a
// warp a corner where a corner holds more than BW_DENSE entries), which
// is slower than the first design (tools/flowk_times.py times that case).
//
// The flow gradient is a gather and runs only when the flow requires a
// gradient (no path of the trainer: its providers are frozen): per pixel,
// sum over channels of g times the derivative of the bilinear sample along
// x and y, then the coordinate chain back to the flow in the JAX code's
// float32 order. The derivative follows the TPU kernel's hat weights
// max(1 - |xs - fx|, 0) as XLA differentiates them: between taps it is the
// difference of the two taps; at an exactly integer coordinate k it is
// v[k] + (v[k+1] - v[k-1]) / 2 (XLA takes |.|'s derivative at 0 as +1 and
// splits maximum's tie at |xs - fx| = 1 as 0.5 / 0.5), so those pixels read
// a third tap column or row. Like flow_warp, the taps' requests and not
// the bytes set its time, so it runs on the forward's layout: 2D tiles of
// FW_TW x FW_TH pixels, two adjacent x a thread, the flow and each
// channel's pair of g read as vectors and the two gradient planes stored
// as vectors, the base grid once per tile column and row.
// ---------------------------------------------------------------------------

// absolute source coordinates of a pixel of flow_warp from its base grid
// values bx, by: base + flow / ((size - 1) / 2), unnormalized, in the
// forward kernel's operations
__device__ __forceinline__ void coords_from(float bx, float by, float flx,
                                            float fly, int H, int W,
                                            int align_corners, float* fx,
                                            float* fy) {
  const float gx = __fadd_rn(bx, __fdiv_rn(flx, (float)(W - 1) / 2.0f));
  const float gy = __fadd_rn(by, __fdiv_rn(fly, (float)(H - 1) / 2.0f));
  *fx = unnormalize(gx, W, align_corners);
  *fy = unnormalize(gy, H, align_corners);
}

constexpr int BW_TH = 8, BW_TW = 64;  // a destination tile: rows, columns
constexpr int BW_MAX_GC = 6;  // channels a tile pass sums
constexpr int BW_BPS = 3;     // blocks an SM
constexpr int BW_CAP = 1024;  // list entries a block stages at once
constexpr int BW_SEGS = 4;    // 32-pixel segments of a row a warp loads at once
constexpr int BW_STAGE = BW_CAP / TPB;  // staged entries a thread loads
constexpr int BW_DENSE = 32;  // a chunk with a corner of more entries:
                              // a warp a corner
// the tap-box corners (top-left taps) whose boxes reach a tile: its pixels
// and the row above and column left of it
constexpr int BW_CORNERS = (BW_TH + 1) * (BW_TW + 1);
// the tile's float64 sums follow the staging and the counts 8-byte aligned
static_assert(BW_CAP % 2 == 0 && (BW_CORNERS + 1) % 2 == 0, "alignment");
constexpr int BW_PLAN_INTS = 9;
constexpr int ERR_PLAN = 20004;  // the plan is not warp_bwd_plan's

// ops/warp.py::warp_bwd_plan, field for field
struct BwdPlan {
  int tile_h, tile_w, group_c, groups, shared_bytes, tiles, work_ints, grid,
      threads;
};

// the plan of B images of C x H x W on a card of `sms` SMs; false where the
// workspace is beyond 32-bit indices
bool bwd_plan_of(int B, int C, int H, int W, int sms, BwdPlan* p) {
  const long long tiles =
      (long long)((H + BW_TH - 1) / BW_TH) * ((W + BW_TW - 1) / BW_TW);
  const int groups = (C + BW_MAX_GC - 1) / BW_MAX_GC;
  const int gc = (C + groups - 1) / groups;
  const long long nt = (long long)B * tiles;
  const long long work = 10LL * B * H * W + 2 * nt + 2;
  if (work >= (1LL << 31) || nt * groups >= (1LL << 31)) return false;
  // per staged entry its coordinates, gc words of g and its place in
  // corner order; a count (then a start) per corner and the total; the
  // tile's float64 sums
  const int shared =
      4 * (BW_CAP * (3 + gc) + BW_CORNERS + 1) + 8 * gc * BW_TH * BW_TW;
  *p = {BW_TH, BW_TW, gc, groups, shared, (int)tiles, (int)work,
        sms * BW_BPS, TPB};
  return true;
}

// the distinct destination tiles (numbers within the image, ntx a tile
// row; -1 for none) that the in-image taps of q reach, and the corner
// (top-left tap) of q's tap box relative to each: its index among a
// tile's BW_CORNERS
__device__ __forceinline__ void tap_tiles(const Taps& q, int ntx, int* key,
                                          int* corner) {
  int ra = q.v00 || q.v01 ? q.y0 / BW_TH : -1;
  int rb = q.v10 || q.v11 ? (q.y0 + 1) / BW_TH : -1;
  int ca = q.v00 || q.v10 ? q.x0 / BW_TW : -1;
  int cb = q.v01 || q.v11 ? (q.x0 + 1) / BW_TW : -1;
  if (rb == ra) rb = -1;
  if (cb == ca) cb = -1;
  const int rows[2] = {ra, rb}, cols[2] = {ca, cb};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = rows[k >> 1], c = cols[k & 1];
    key[k] = r >= 0 && c >= 0 ? r * ntx + c : -1;
    corner[k] = (q.y0 - r * BW_TH + 1) * (BW_TW + 1) + q.x0 - c * BW_TW + 1;
  }
}

// exclusive prefix of a[0, n) in place, a[n] = the total, by one block;
// returns the largest a[i]. ws: 2 * TPB / 32 ints of shared memory
__device__ int block_exclusive_scan(int* a, int n, int* ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + TPB - 1) / TPB;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0, mx = 0;
  for (int j = lo; j < hi; ++j) {
    s += a[j];
    mx = max(mx, a[j]);
  }
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 31) ws[warp] = x;
  if (lane == 0) ws[TPB / 32 + warp] = mx;
  __syncthreads();
  if (warp == 0) {
    int v = lane < TPB / 32 ? ws[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane < TPB / 32) ws[lane] = v;
  }
  __syncthreads();
  int run = x - s + (warp ? ws[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int t = a[j];
    a[j] = run;
    run += t;
  }
  if (tid == TPB - 1) a[n] = run;
  mx = 0;
#pragma unroll
  for (int w = 0; w < TPB / 32; ++w) mx = max(mx, ws[TPB / 32 + w]);
  __syncthreads();
  return mx;
}

// the count (BIN false: coordinates formed from the flow and kept, tiles
// counted) or the bin pass (BIN true: coordinates read back; each pixel's
// index and tap-box corner written into its tiles' lists) over the source
// pixels. A warp takes 32 x BW_SEGS pixels of one row at a time and loads
// them first; a pixel's tiles are counted once a warp and tile
// (__match_any_sync); the bin pass asks for the slots of all its
// segments' first tiles before it waits for any.
template <bool BIN>
__device__ __forceinline__ void bin_pass(const float* __restrict__ flow,
                                         float2* __restrict__ coords,
                                         int* __restrict__ at,
                                         int2* __restrict__ list, int B,
                                         int H, int W, int gh, int gw,
                                         int align_corners, int tiles,
                                         int ntx) {
  constexpr int SPAN = 32 * BW_SEGS;
  const int lane = threadIdx.x & 31;
  const size_t hw = (size_t)H * W;
  const int spans = (W + SPAN - 1) / SPAN;
  const int warps = gridDim.x * (TPB / 32);
  for (int task = blockIdx.x * (TPB / 32) + (threadIdx.x >> 5);
       task < B * H * spans; task += warps) {
    const int row = task / spans, xs = (task - row * spans) * SPAN;
    const int b = row / H, y = row - b * H;
    const size_t rb = (size_t)b * hw + (size_t)y * W;  // the row in coords
    float2 c[BW_SEGS];
#pragma unroll
    for (int j = 0; j < BW_SEGS; ++j) {
      const int x = xs + 32 * j + lane;
      if (x >= W) continue;
      if (BIN) {
        c[j] = coords[rb + x];
      } else {
        const float* fl = flow + rb + (size_t)b * hw + x;
        c[j] = make_float2(fl[0], fl[hw]);
      }
    }
    const float by = BIN ? 0.0f : base_grid(y, gh);
    int first[BW_SEGS], corner0[BW_SEGS], slot[BW_SEGS];
    unsigned peers[BW_SEGS];
#pragma unroll
    for (int j = 0; j < BW_SEGS; ++j) {
      const int x = xs + 32 * j + lane;
      first[j] = -1;
      if (xs + 32 * j >= W) continue;  // the same for the whole warp
      int key[4] = {-1, -1, -1, -1}, corner[4];
      if (x < W) {
        float fx = c[j].x, fy = c[j].y;
        if (!BIN) {
          coords_from(base_grid(x, gw), by, c[j].x, c[j].y, H, W,
                      align_corners, &fx, &fy);
          coords[rb + x] = make_float2(fx, fy);
        }
        tap_tiles(taps_of(fx, fy, H, W), ntx, key, corner);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (key[k] >= 0) key[k] += b * tiles;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!__any_sync(0xffffffffu, key[k] >= 0)) continue;
        const unsigned pk = __match_any_sync(0xffffffffu, key[k]);
        const int leader = __ffs(pk) - 1;
        int s = 0;
        if (key[k] >= 0 && lane == leader)
          s = atomicAdd(at + key[k], __popc(pk));
        if (!BIN) continue;
        if (k == 0) {  // the slot is read after the other segments ask
          first[j] = key[0];
          corner0[j] = corner[0];
          slot[j] = s;
          peers[j] = pk;
        } else {
          s = __shfl_sync(0xffffffffu, s, leader);
          if (key[k] >= 0)
            list[s + __popc(pk & ((1u << lane) - 1u))] =
                make_int2(y * W + x, corner[k]);
        }
      }
    }
    if (!BIN) continue;
#pragma unroll
    for (int j = 0; j < BW_SEGS; ++j) {
      if (xs + 32 * j >= W || !__any_sync(0xffffffffu, first[j] >= 0))
        continue;
      const int leader = __ffs(peers[j]) - 1;
      const int s = __shfl_sync(0xffffffffu, slot[j], leader);
      if (first[j] >= 0)
        list[s + __popc(peers[j] & ((1u << lane) - 1u))] =
            make_int2(y * W + xs + 32 * j + lane, corner0[j]);
    }
  }
}

// 4 and 8 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// the value of g a staged word holds: float32, or the bf16 half `hi`
__device__ __forceinline__ float staged(unsigned w, int hi, const float*) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float staged(unsigned w, int hi,
                                        const __nv_bfloat16*) {
  return __uint_as_float((hi ? w >> 16 : w & 0xffffu) << 16);
}

// the parts of the maps kernel's workspace (the plan's work_ints int32)
struct BwWork {
  float2* coords;  // each pixel's source coordinates, B * H * W
  int* offs;       // per tile its count, then its list's offset; the total
  int* cursor;     // per tile the bin pass's next slot
  int* next;       // the accumulate phase's item counter
  int2* list;      // per entry its pixel and tap-box corner; 8-byte aligned
};

__device__ __forceinline__ BwWork bw_work(int* work, size_t n, int nt) {
  BwWork w;
  w.coords = reinterpret_cast<float2*>(work);
  w.offs = work + 2 * n;
  w.cursor = w.offs + nt + 1;
  w.next = w.cursor + nt;
  w.list = reinterpret_cast<int2*>(w.next + 1);
  return w;
}

// phase 2, by one block: the nt tile counts become list offsets (in offs
// and cursor) and offs[nt] their total, through `cap` ints of shared
// memory in coalesced pieces
__device__ void bw_scan(const BwWork& w, int nt, int cap, int* smem,
                        int* ws) {
  const int tid = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < nt; base += cap) {
    const int len = min(cap, nt - base);
    for (int i = tid; i < len; i += TPB) smem[i] = w.offs[base + i];
    __syncthreads();
    block_exclusive_scan(smem, len, ws);
    for (int i = tid; i < len; i += TPB)
      w.offs[base + i] = w.cursor[base + i] = smem[i] + carry;
    carry += smem[len];
    __syncthreads();
  }
  if (tid == 0) w.offs[nt] = carry;
}

// phase 4 for one (tile, channel group) item: the tile's list in chunks of
// BW_CAP entries. A chunk is staged (coordinates and g by asynchronous
// copies) and sorted by the corner of its entries' tap boxes (a counting
// sort: ranks from shared integer counters). Then each thread sums, for
// the pixel pair it owns, the entries of the six corners whose boxes reach
// it (two runs of three corners in sorted order) in registers and adds
// that to the tile's float64 sums, which no other thread writes. Where a
// corner holds more than BW_DENSE entries (a flow that converges), a warp
// takes each corner instead, a channel at a time, its lanes splitting the
// entries, and adds its four pixels' sums with shared float64 atomics. The
// tile is written once, in g's type. VEC: W even and out 8-byte aligned, pairs stored as
// vectors. g: 4-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void bw_item(int item, const T* __restrict__ g,
                                        const BwWork& w, T* __restrict__ out,
                                        int C, int H, int W,
                                        const BwdPlan& p, int* smem,
                                        int* s_ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t hw = (size_t)H * W;
  const int ntx = (W + BW_TW - 1) / BW_TW;
  float2* s_xy = reinterpret_cast<float2*>(smem);
  unsigned* s_g = reinterpret_cast<unsigned*>(s_xy + BW_CAP);  // gc x CAP
  int* s_cnt = reinterpret_cast<int*>(s_g + p.group_c * BW_CAP);
  double* s_acc = reinterpret_cast<double*>(s_cnt + BW_CORNERS + 1);
  unsigned* s_perm =
      reinterpret_cast<unsigned*>(s_acc + p.group_c * BW_TH * BW_TW);
  constexpr int TS = BW_TH * BW_TW;
  const int ly = warp, lx = 2 * lane;  // the pixel pair a thread owns
  const int key = item / p.groups;
  const int c0 = (item - key * p.groups) * p.group_c;
  const int cn = min(p.group_c, C - c0);
  const int b = key / p.tiles, t = key - b * p.tiles;
  const int ty0 = t / ntx * BW_TH, tx0 = (t - t / ntx * ntx) * BW_TW;
  const float2* cb = w.coords + (size_t)b * hw;
  const size_t plane0 = ((size_t)b * C + c0) * hw;  // g's first plane here
  for (int c = 0; c < cn; ++c) {
    s_acc[c * TS + ly * BW_TW + lx] = 0.0;
    s_acc[c * TS + ly * BW_TW + lx + 1] = 0.0;
  }
  // bf16 g is staged a 32-bit word an element: the word at the element's
  // index in g rounded down to even (an aligned word never crosses the end
  // of g's pages), its half that index's parity: the pixel's and that of
  // its channel plane's offset
  int plane_odd[BW_MAX_GC];
#pragma unroll
  for (int c = 0; c < BW_MAX_GC; ++c)
    plane_odd[c] = sizeof(T) == 2 && ((plane0 + (size_t)c * hw) & 1) != 0;
  const int end = w.offs[key + 1];
  for (int cbeg = w.offs[key]; cbeg < end; cbeg += BW_CAP) {
    const int m = min(BW_CAP, end - cbeg);
    for (int j = tid; j <= BW_CORNERS; j += TPB) s_cnt[j] = 0;
    __syncthreads();
    // each thread's entries tid + u * TPB: source pixel, corner, rank
    int2 en[BW_STAGE];
    int rank[BW_STAGE];
#pragma unroll
    for (int u = 0; u < BW_STAGE; ++u)
      en[u] = tid + u * TPB < m ? w.list[cbeg + tid + u * TPB]
                                : make_int2(-1, 0);
#pragma unroll
    for (int u = 0; u < BW_STAGE; ++u) {
      if (en[u].x < 0) continue;
      const int e = tid + u * TPB;
      cp_async8(s_xy + e, cb + en[u].x);
      for (int c = 0; c < cn; ++c)  // the aligned word holding g
        cp_async4(s_g + c * BW_CAP + e,
                  g + ((plane0 + (size_t)c * hw + en[u].x) &
                       ~(size_t)(4 / sizeof(T) - 1)));
      rank[u] = atomicAdd(s_cnt + en[u].y, 1);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    __syncthreads();
    const bool dense =
        block_exclusive_scan(s_cnt, BW_CORNERS, s_ws) > BW_DENSE;
#pragma unroll
    for (int u = 0; u < BW_STAGE; ++u)
      if (en[u].x >= 0)  // the entry, its pixel's parity, its corner
        s_perm[s_cnt[en[u].y] + rank[u]] =
            (unsigned)(tid + u * TPB) | (unsigned)(en[u].x & 1) << 15 |
            (unsigned)en[u].y << 16;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (!dense) {
      double acc[2][BW_MAX_GC];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int c = 0; c < BW_MAX_GC; ++c) acc[k][c] = 0.0;
      // corners (ly, lx .. lx + 2), then (ly + 1, lx .. lx + 2): boxes
      // with this pair in their lower, then upper row; in one loop
      const int ca = ly * (BW_TW + 1) + lx, cb2 = ca + BW_TW + 1;
      const int a0 = s_cnt[ca], a1 = s_cnt[ca + 1], a2 = s_cnt[ca + 2];
      const int a3 = s_cnt[ca + 3];
      const int b0 = s_cnt[cb2], b1 = s_cnt[cb2 + 1], b2 = s_cnt[cb2 + 2];
      const int b3 = s_cnt[cb2 + 3];
      const int na = a3 - a0, total = na + b3 - b0;
      for (int i = 0; i < total; ++i) {
        const bool upper = i >= na;  // box row 0 holds the pair
        const int j = upper ? b0 + i - na : a0 + i;
        const int cxi = upper ? (j >= b1) + (j >= b2) : (j >= a1) + (j >= a2);
        const unsigned pe = s_perm[j];
        const int e = pe & 0x7fff;
        const float2 q = s_xy[e];
        const float tx = __fsub_rn(q.x, floorf(q.x));
        const float ty = __fsub_rn(q.y, floorf(q.y));
        const float rowp = upper ? __fsub_rn(1.0f, ty) : ty;
        const float ux = __fsub_rn(1.0f, tx);
        // the forward's weights: column part times row part; the pair's
        // left pixel is box column 1 (cxi 0) or 0 (cxi 1), the right
        // one box column 1 (cxi 1) or 0 (cxi 2)
        const float w0 = cxi < 2 ? __fmul_rn(cxi ? ux : tx, rowp) : 0.0f;
        const float w1 = cxi > 0 ? __fmul_rn(cxi == 1 ? tx : ux, rowp) : 0.0f;
#pragma unroll
        for (int c = 0; c < BW_MAX_GC; ++c) {
          if (c >= cn) break;
          const float v = staged(s_g[c * BW_CAP + e],
                                 (pe >> 15 & 1) ^ plane_odd[c], g);
          if (cxi < 2) acc[0][c] = __dadd_rn(acc[0][c], __fmul_rn(v, w0));
          if (cxi > 0) acc[1][c] = __dadd_rn(acc[1][c], __fmul_rn(v, w1));
        }
      }
#pragma unroll
      for (int c = 0; c < BW_MAX_GC; ++c) {
        if (c >= cn) break;
        double* a = s_acc + c * TS + ly * BW_TW + lx;
        a[0] = __dadd_rn(a[0], acc[0][c]);
        a[1] = __dadd_rn(a[1], acc[1][c]);
      }
    } else {
      for (int ci = warp; ci < BW_CORNERS; ci += TPB / 32) {
        const int jbeg = s_cnt[ci], jend = s_cnt[ci + 1];
        if (jbeg == jend) continue;
        const int cy = ci / (BW_TW + 1), cx = ci - cy * (BW_TW + 1);
        for (int c = 0; c < cn; ++c) {
          const int odd =
              sizeof(T) == 2 && ((plane0 + (size_t)c * hw) & 1) != 0;
          double sum[4] = {0.0, 0.0, 0.0, 0.0};  // box pixels (0,0) .. (1,1)
          for (int j = jbeg + lane; j < jend; j += 32) {
            const unsigned pe = s_perm[j];
            const int e = pe & 0x7fff;
            const float2 q = s_xy[e];
            const float tx = __fsub_rn(q.x, floorf(q.x));
            const float ty = __fsub_rn(q.y, floorf(q.y));
            const float ux = __fsub_rn(1.0f, tx), uy = __fsub_rn(1.0f, ty);
            const float wk[4] = {__fmul_rn(ux, uy), __fmul_rn(tx, uy),
                                 __fmul_rn(ux, ty), __fmul_rn(tx, ty)};
            const float v = staged(s_g[c * BW_CAP + e],
                                   (pe >> 15 & 1) ^ odd, g);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              sum[k] = __dadd_rn(sum[k], __fmul_rn(v, wk[k]));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              sum[k] = __dadd_rn(sum[k],
                                 __shfl_xor_sync(0xffffffffu, sum[k], off));
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int py = cy - 1 + (k >> 1), px = cx - 1 + (k & 1);
              if ((unsigned)py < BW_TH && (unsigned)px < BW_TW)
                atomicAdd(s_acc + c * TS + py * BW_TW + px, sum[k]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staging
  }
  const int th = min(BW_TH, H - ty0), tw = min(BW_TW, W - tx0);
  if (ly < th && lx < tw) {  // this thread's own pair: no barrier needed
    T* o = out + plane0 + (size_t)(ty0 + ly) * W + tx0 + lx;
    for (int c = 0; c < cn; ++c) {
      const double* a = s_acc + c * TS + ly * BW_TW + lx;
      const float a0 = __double2float_rn(a[0]), a1 = __double2float_rn(a[1]);
      if (VEC) {  // lx + 1 < tw: W is even, and so are tx0 and lx
        store_pair(a0, a1, o + (size_t)c * hw);
      } else {
        from_f32(a0, o + (size_t)c * hw);
        if (lx + 1 < tw) from_f32(a1, o + (size_t)c * hw + 1);
      }
    }
  }
}

// the maps gradient (phases above); work: the plan's work_ints int32
template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB, BW_BPS)
flow_warp_bwd_maps_kernel(const T* __restrict__ g,
                          const float* __restrict__ flow,
                          int* __restrict__ work, T* __restrict__ out, int B,
                          int C, int H, int W, int gh, int gw,
                          int align_corners, BwdPlan p) {
  extern __shared__ int smem[];
  __shared__ int s_next[2], s_ws[2 * TPB / 32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int ntx = (W + BW_TW - 1) / BW_TW, nt = B * p.tiles;
  const BwWork w = bw_work(work, (size_t)B * H * W, nt);
  for (int i = blockIdx.x * TPB + tid; i < nt; i += gridDim.x * TPB)
    w.offs[i] = 0;
  if (blockIdx.x == 0 && tid == 0) *w.next = 0;
  grid.sync();
  bin_pass<false>(flow, w.coords, w.offs, w.list, B, H, W, gh, gw,
                  align_corners, p.tiles, ntx);
  grid.sync();
  if (blockIdx.x == 0) bw_scan(w, nt, p.shared_bytes / 4 - 1, smem, s_ws);
  grid.sync();
  bin_pass<true>(flow, w.coords, w.cursor, w.list, B, H, W, gh, gw,
                 align_corners, p.tiles, ntx);
  grid.sync();
  // accumulate: the blocks take items from the counter; the next item is
  // asked for while one is summed, and written to the other slot at the
  // end (a slow thread may still read this one)
  const int items = nt * p.groups;
  if (tid == 0) s_next[0] = atomicAdd(w.next, 1);
  __syncthreads();
  for (int k = 0;; k ^= 1) {
    const int item = s_next[k];
    if (item >= items) break;
    const int ask = tid == 0 ? atomicAdd(w.next, 1) : 0;
    bw_item<T, VEC>(item, g, w, out, C, H, W, p, smem, s_ws);
    if (tid == 0) s_next[k ^ 1] = ask;
    __syncthreads();  // every thread has read its sums; the slot is written
  }
}

// the derivative of a bilinear sample along one axis, from the taps below
// (lo = floor), at and above it: between taps hi - lo; at an integer
// coordinate (frac == 0) XLA's hat derivative lo + (hi - below) / 2
__device__ __forceinline__ float hat_diff(float below, float lo, float hi,
                                          bool integer) {
  return integer ? __fadd_rn(lo, __fmul_rn(0.5f, __fsub_rn(hi, below)))
                 : __fsub_rn(hi, lo);
}

// one pixel's sample position for the flow gradient: the weights, whether
// the coordinate is integer along x and y, the tap box's offset in a
// channel plane and which of its taps lie in the image: columns x0 - 1
// (m), x0, x0 + 1 and rows y0 - 1, y0, y0 + 1 (tested in float: a
// coordinate may be far outside int range)
struct Deriv {
  float tx, ty, ux, uy;
  ptrdiff_t at;
  bool ix, iy, xm, x0, x1, ym, y0, y1;
};

__device__ __forceinline__ Deriv deriv_of(float fx, float fy, int H, int W) {
  Deriv d;
  const float x0f = floorf(fx), y0f = floorf(fy);
  d.tx = __fsub_rn(fx, x0f);
  d.ty = __fsub_rn(fy, y0f);
  d.ux = __fsub_rn(1.0f, d.tx);
  d.uy = __fsub_rn(1.0f, d.ty);
  d.ix = d.tx == 0.0f;
  d.iy = d.ty == 0.0f;
  d.xm = x0f >= 1.0f && x0f <= (float)W;
  d.x0 = x0f >= 0.0f && x0f <= (float)(W - 1);
  d.x1 = x0f >= -1.0f && x0f <= (float)(W - 2);
  d.ym = y0f >= 1.0f && y0f <= (float)H;
  d.y0 = y0f >= 0.0f && y0f <= (float)(H - 1);
  d.y1 = y0f >= -1.0f && y0f <= (float)(H - 2);
  // clamped where no tap of the row or column lies in the image
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)H);
  d.at = (ptrdiff_t)y0 * W + x0;
  return d;
}

// the derivatives along x and y of one channel plane's sample at d; the
// taps outside the image read zero
template <typename T>
__device__ __forceinline__ void sample_deriv(const Deriv& d, const T* plane,
                                             int W, float* dx, float* dy) {
  const T* p = plane + d.at;
  const float v00 = d.y0 && d.x0 ? to_f32(p[0]) : 0.0f;
  const float v01 = d.y0 && d.x1 ? to_f32(p[1]) : 0.0f;
  const float v10 = d.y1 && d.x0 ? to_f32(p[W]) : 0.0f;
  const float v11 = d.y1 && d.x1 ? to_f32(p[W + 1]) : 0.0f;
  const float v0m = d.ix && d.y0 && d.xm ? to_f32(p[-1]) : 0.0f;
  const float v1m = d.ix && d.y1 && d.xm ? to_f32(p[W - 1]) : 0.0f;
  const float vm0 = d.iy && d.ym && d.x0 ? to_f32(p[-W]) : 0.0f;
  const float vm1 = d.iy && d.ym && d.x1 ? to_f32(p[1 - W]) : 0.0f;
  *dx = __fadd_rn(__fmul_rn(d.uy, hat_diff(v0m, v00, v01, d.ix)),
                  __fmul_rn(d.ty, hat_diff(v1m, v10, v11, d.ix)));
  *dy = __fadd_rn(__fmul_rn(d.ux, hat_diff(vm0, v00, v10, d.iy)),
                  __fmul_rn(d.tx, hat_diff(vm1, v01, v11, d.iy)));
}

// two adjacent values of one channel row of g, read as one vector
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the flow gradient on flow_warp's layout: a block owns FW_TW x FW_TH
// pixels of one image, a thread two adjacent x of a row. VEC (W even,
// 8-byte aligned tensors): the flow and g read as pairs and the two
// gradient planes stored as pairs; else element by element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB)
flow_warp_bwd_flow_kernel(const T* __restrict__ g, const T* __restrict__ maps,
                          const float* __restrict__ flow,
                          float* __restrict__ gflow, int C, int H, int W,
                          int gh, int gw, int align_corners) {
  __shared__ float bxs[FW_TW], bys[FW_TH];
  const int xb = blockIdx.x * FW_TW, yb = blockIdx.y * FW_TH, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid < FW_TW)
    bxs[tid] = base_grid(xb + tid, gw);
  else if (tid < FW_TW + FW_TH)
    bys[tid - FW_TW] = base_grid(yb + tid - FW_TW, gh);
  __syncthreads();
  const int lx = (tid % (FW_TW / 2)) * 2, ly = tid / (FW_TW / 2);
  const int x = xb + lx, y = yb + ly;
  if (x >= W || y >= H) return;
  const bool two = VEC || x + 1 < W;
  const size_t hw = (size_t)H * W;
  const size_t r = (size_t)y * W + x;
  const float* fl = flow + (size_t)b * 2 * hw + r;
  float flx[2], fly[2];
  if (VEC) {
    const float2 u = *reinterpret_cast<const float2*>(fl);
    const float2 v = *reinterpret_cast<const float2*>(fl + hw);
    flx[0] = u.x;
    flx[1] = u.y;
    fly[0] = v.x;
    fly[1] = v.y;
  } else {
    flx[0] = fl[0];
    fly[0] = fl[hw];
    flx[1] = two ? fl[1] : 0.0f;
    fly[1] = two ? fl[hw + 1] : 0.0f;
  }
  Deriv d[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float fx, fy;
    coords_from(bxs[lx + k], bys[ly], flx[k], fly[k], H, W, align_corners,
                &fx, &fy);
    d[k] = deriv_of(fx, fy, H, W);
  }
  float sx[2] = {0.0f, 0.0f}, sy[2] = {0.0f, 0.0f};
  const T* gp = g + (size_t)b * C * hw + r;
  const T* img = maps + (size_t)b * C * hw;
  // two channels' loads in flight at once
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    float gv[2];
    if (VEC) {
      const float2 u = load_pair(gp + c * hw);
      gv[0] = u.x;
      gv[1] = u.y;
    } else {
      gv[0] = to_f32(gp[c * hw]);
      gv[1] = two ? to_f32(gp[c * hw + 1]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
      float dx, dy;
      sample_deriv(d[k], img + c * hw, W, &dx, &dy);
      sx[k] = __fadd_rn(sx[k], __fmul_rn(gv[k], dx));
      sy[k] = __fadd_rn(sy[k], __fmul_rn(gv[k], dy));
    }
  }
  // d fx / d flow_x, transposed in the JAX code's order: fx = ((gx + 1) *
  // 0.5) * (W - 1) [align_corners] or ((gx + 1) * W - 1) * 0.5, and
  // gx = base + flow_x / ((W - 1) / 2)
  float ox[2], oy[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float cx = align_corners
                         ? __fmul_rn(__fmul_rn(sx[k], (float)(W - 1)), 0.5f)
                         : __fmul_rn(__fmul_rn(sx[k], 0.5f), (float)W);
    const float cy = align_corners
                         ? __fmul_rn(__fmul_rn(sy[k], (float)(H - 1)), 0.5f)
                         : __fmul_rn(__fmul_rn(sy[k], 0.5f), (float)H);
    ox[k] = __fdiv_rn(cx, (float)(W - 1) / 2.0f);
    oy[k] = __fdiv_rn(cy, (float)(H - 1) / 2.0f);
  }
  float* o = gflow + (size_t)b * 2 * hw + r;
  if (VEC) {
    store_pair(ox[0], ox[1], o);
    store_pair(oy[0], oy[1], o + hw);
  } else {
    o[0] = ox[0];
    o[hw] = oy[0];
    if (two) {
      o[1] = ox[1];
      o[hw + 1] = oy[1];
    }
  }
}

template <typename T, bool VEC>
int launch_bwd_maps(const void* g, const void* flow, void* work, void* out,
                    int B, int C, int H, int W, int gh, int gw,
                    int align_corners, const int* plan, cudaStream_t s) {
  constexpr auto kernel = flow_warp_bwd_maps_kernel<T, VEC>;
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  BwdPlan p;
  if (!bwd_plan_of(B, C, H, W, sms, &p)) return ERR_PLAN;
  const int want[BW_PLAN_INTS] = {p.tile_h, p.tile_w, p.group_c,
                                  p.groups, p.shared_bytes, p.tiles,
                                  p.work_ints, p.grid, p.threads};
  for (int k = 0; k < BW_PLAN_INTS; ++k)
    if (plan[k] != want[k]) return ERR_PLAN;
  int rc = mfc::allow_shared_memory<kernel>(&limit);
  if (rc != 0) return rc;
  if (p.shared_bytes > limit) return ERR_PLAN;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TPB,
                                                    p.shared_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < BW_BPS) return ERR_PLAN;  // the grid must be resident at once
  const T* gp = (const T*)g;
  const float* fp = (const float*)flow;
  int* wp = (int*)work;
  T* op = (T*)out;
  void* args[] = {(void*)&gp, (void*)&fp, (void*)&wp, (void*)&op,
                  (void*)&B,  (void*)&C,  (void*)&H,  (void*)&W,
                  (void*)&gh, (void*)&gw, (void*)&align_corners, (void*)&p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.grid),
                                  dim3(TPB), args, p.shared_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flow_warp_bwd_maps(const void* g, const void* flow, void* work,
                              void* out, int B, int C, int H, int W, int gh,
                              int gw, int align_corners, const int* plan,
                              cudaStream_t s) {
  if (W % 2 == 0 && (uintptr_t)out % 8 == 0)
    return launch_bwd_maps<T, true>(g, flow, work, out, B, C, H, W, gh, gw,
                                    align_corners, plan, s);
  return launch_bwd_maps<T, false>(g, flow, work, out, B, C, H, W, gh, gw,
                                   align_corners, plan, s);
}

template <typename T>
int launch_flow_warp_bwd_flow(const void* g, const void* maps,
                              const void* flow, void* gflow, int B, int C,
                              int H, int W, int gh, int gw, int align_corners,
                              cudaStream_t s) {
  if (B > 65535 || (H + FW_TH - 1) / FW_TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + FW_TW - 1) / FW_TW, (H + FW_TH - 1) / FW_TH, B);
  const bool vec = W % 2 == 0 && ((uintptr_t)g | (uintptr_t)maps |
                                  (uintptr_t)flow | (uintptr_t)gflow) % 8 == 0;
  if (vec)
    flow_warp_bwd_flow_kernel<T, true><<<grid, TPB, 0, s>>>(
        (const T*)g, (const T*)maps, (const float*)flow, (float*)gflow, C, H,
        W, gh, gw, align_corners);
  else
    flow_warp_bwd_flow_kernel<T, false><<<grid, TPB, 0, s>>>(
        (const T*)g, (const T*)maps, (const float*)flow, (float*)gflow, C, H,
        W, gh, gw, align_corners);
  return (int)cudaGetLastError();
}

}  // namespace

// maps (B, C, H, W) float32 (dtype 0) or bfloat16 (dtype 1); flow
// (B, 2, H, W) float32 in pixels; out like maps. Returns cudaGetLastError().
extern "C" int mfc_flow_warp(const void* maps, const void* flow, void* out,
                             int B, int C, int H, int W, int gh, int gw,
                             int align_corners, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * H * W == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch_flow_warp<float>(maps, flow, out, B, C, H, W, gh, gw,
                                   align_corners, s);
  if (dtype == 1)
    return launch_flow_warp<__nv_bfloat16>(maps, flow, out, B, C, H, W, gh,
                                           gw, align_corners, s);
  return (int)cudaErrorInvalidValue;
}

// img (B, C, H, W) float32 (dtype 0) or bfloat16 (dtype 1); gx, gy
// (B, Ho, Wo) float32, the normalized grid (x indexes width); out
// (B, C, Ho, Wo). align_corners: 0 or 1; border: 0 zeros padding, 1 border
// padding.
extern "C" int mfc_warp_abs(const void* img, const void* gx, const void* gy,
                            void* out, int B, int C, int H, int W, int Ho,
                            int Wo, int align_corners, int border, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * Ho * Wo == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch_warp_abs<float>(img, gx, gy, out, B, C, H, W, Ho, Wo,
                                  align_corners, border, s);
  if (dtype == 1)
    return launch_warp_abs<__nv_bfloat16>(img, gx, gy, out, B, C, H, W, Ho,
                                          Wo, align_corners, border, s);
  return (int)cudaErrorInvalidValue;
}

// img, out (B, C, H, W) float32 (dtype 0) or bfloat16 (dtype 1); flow
// (B, 2, H, W) in pixels, float32 (flow_dtype 0) or bfloat16 (1); strides:
// 12 ints on the host, the element strides (batch, channel, row, column) of
// img, flow and out; xs (W), ys (H) float32: the base grid. border: 0 zeros
// padding, 1 border padding.
extern "C" int mfc_backward_warp(const void* img, const void* flow, void* out,
                                 const int* strides, const void* xs,
                                 const void* ys, int B, int C, int H, int W,
                                 int align_corners, int border, int dtype,
                                 int flow_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * H * W == 0 || C == 0) return 0;
  const float* x = (const float*)xs;
  const float* y = (const float*)ys;
  if (dtype == 0 && flow_dtype == 0)
    return launch_backward_warp<float, float>(
        img, flow, out, strides, x, y, B, C, H, W, align_corners, border, s);
  if (dtype == 0 && flow_dtype == 1)
    return launch_backward_warp<float, __nv_bfloat16>(
        img, flow, out, strides, x, y, B, C, H, W, align_corners, border, s);
  if (dtype == 1 && flow_dtype == 0)
    return launch_backward_warp<__nv_bfloat16, float>(
        img, flow, out, strides, x, y, B, C, H, W, align_corners, border, s);
  if (dtype == 1 && flow_dtype == 1)
    return launch_backward_warp<__nv_bfloat16, __nv_bfloat16>(
        img, flow, out, strides, x, y, B, C, H, W, align_corners, border, s);
  return (int)cudaErrorInvalidValue;
}

// the gradient of flow_warp for its maps: g (B, C, H, W) float32 (dtype 0)
// or bfloat16 (1), the upstream gradient; flow (B, 2, H, W) float32; work:
// the plan's work_ints int32 of scratch (no state crosses calls); out
// (B, C, H, W) in g's type; plan: the 9 ints of ops/warp.py::warp_bwd_plan
// for this shape and card (ERR_PLAN for any other, or when the card cannot
// hold the grid at once). One cooperative launch.
extern "C" int mfc_flow_warp_bwd_maps(const void* g, const void* flow,
                                      void* work, void* out, int B, int C,
                                      int H, int W, int gh, int gw,
                                      int align_corners, int dtype,
                                      const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * H * W == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch_flow_warp_bwd_maps<float>(g, flow, work, out, B, C, H, W,
                                            gh, gw, align_corners, plan, s);
  if (dtype == 1)
    return launch_flow_warp_bwd_maps<__nv_bfloat16>(
        g, flow, work, out, B, C, H, W, gh, gw, align_corners, plan, s);
  return (int)cudaErrorInvalidValue;
}

// the gradient of flow_warp for its flow: g and maps (B, C, H, W) float32
// (dtype 0) or bfloat16 (1); flow (B, 2, H, W) float32; gflow (B, 2, H, W)
// float32.
extern "C" int mfc_flow_warp_bwd_flow(const void* g, const void* maps,
                                      const void* flow, void* gflow, int B,
                                      int C, int H, int W, int gh, int gw,
                                      int align_corners, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * H * W == 0) return 0;
  if (dtype == 0)
    return launch_flow_warp_bwd_flow<float>(g, maps, flow, gflow, B, C, H, W,
                                            gh, gw, align_corners, s);
  if (dtype == 1)
    return launch_flow_warp_bwd_flow<__nv_bfloat16>(
        g, maps, flow, gflow, B, C, H, W, gh, gw, align_corners, s);
  return (int)cudaErrorInvalidValue;
}
