// Bilinear backward warp for the MFCNet Basic head's flow alignment
// (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/ops/warp.py, which holds the plain PyTorch version.
//
// Replaces mfcnet_tpu/ops/warp_pallas.py::banded_warp_pallas
// (_warp_band_kernel) and the tiers around it in mfcnet_tpu/ops/warp.py:
//   mfc_flow_warp  <- flow_warp (base grid + flow -> absolute coordinates ->
//                     the warp), in one pass
//   mfc_warp_abs   <- banded_warp_pallas's own contract: absolute source
//                     coordinates fx, fy, zeros padding
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

template <typename T>
__global__ void __launch_bounds__(TPB)
warp_abs_kernel(const T* __restrict__ img, const float* __restrict__ fx,
                const float* __restrict__ fy, T* __restrict__ out, int B,
                int C, int H, int W, int Ho, int Wo) {
  const size_t n = (size_t)Ho * Wo;
  const size_t i = (size_t)blockIdx.x * TPB + threadIdx.x;
  if (i >= (size_t)B * n) return;
  const int b = (int)(i / n);
  const size_t r = i - (size_t)b * n;
  sample_pixel(img + (size_t)b * C * H * W, C, H, W, (ptrdiff_t)H * W, W, 1,
               fx[i], fy[i], out + (size_t)b * C * n + r, (ptrdiff_t)n);
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
// What bounds it: bytes, and for the maps gradient the scatter. The maps
// gradient sends each output pixel's upstream gradient to its four source
// taps: a scatter whose targets the flow decides, so two pixels may hit one
// tap. It reads g (B, C, H, W) and the flow once and writes the gradient
// once; at the trainer's shapes (8 x 6 x 480 x 640, bf16 g) that is
// 29.5 + 19.7 + 29.5 MB, 0.023 ms at the card's memory rate. This first
// design accumulates in a float32 buffer with atomicAdd (four per pixel and
// channel) and casts at the end, so it also zeroes and reads back that
// buffer: 59 MB more in bf16. It is one cooperative launch: the blocks zero
// the buffer, meet at a grid barrier, scatter, meet again and (bf16) cast.
// Atomics add in another order from run to run: float32 results agree with
// the plain version to a few float32 rounding steps, not bit for bit.
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
// a third tap column or row.
// ---------------------------------------------------------------------------

// absolute source coordinates of pixel (x, y) of flow_warp: base grid +
// flow / ((size - 1) / 2), unnormalized, in the forward kernel's operations
__device__ __forceinline__ void flow_coords(float flx, float fly, int x, int y,
                                            int H, int W, int gh, int gw,
                                            int align_corners, float* fx,
                                            float* fy) {
  const float gx =
      __fadd_rn(base_grid(x, gw), __fdiv_rn(flx, (float)(W - 1) / 2.0f));
  const float gy =
      __fadd_rn(base_grid(y, gh), __fdiv_rn(fly, (float)(H - 1) / 2.0f));
  *fx = unnormalize(gx, W, align_corners);
  *fy = unnormalize(gy, H, align_corners);
}

// the maps gradient: zero acc, scatter g into acc, cast acc into out (out is
// null when acc is the float32 result). A cooperative launch: every block is
// resident, and the phases are split by grid barriers.
template <typename T>
__global__ void __launch_bounds__(TPB)
flow_warp_bwd_maps_kernel(const T* __restrict__ g,
                          const float* __restrict__ flow,
                          float* __restrict__ acc, T* __restrict__ out, int B,
                          int C, int H, int W, int gh, int gw,
                          int align_corners) {
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)H * W, n = (size_t)B * C * hw;
  const size_t stride = (size_t)gridDim.x * TPB;
  const size_t t0 = (size_t)blockIdx.x * TPB + threadIdx.x;
  for (size_t i = t0; i < n; i += stride) acc[i] = 0.0f;
  grid.sync();
  for (size_t i = t0; i < (size_t)B * hw; i += stride) {
    const int b = (int)(i / hw);
    const size_t r = i - (size_t)b * hw;
    const int y = (int)(r / W), x = (int)(r - (size_t)y * W);
    const float* fl = flow + (size_t)b * 2 * hw + r;
    float fx, fy;
    flow_coords(fl[0], fl[hw], x, y, H, W, gh, gw, align_corners, &fx, &fy);
    const Taps q = taps_of(fx, fy, H, W);
    const float w00 = __fmul_rn(q.ux, q.uy), w01 = __fmul_rn(q.tx, q.uy);
    const float w10 = __fmul_rn(q.ux, q.ty), w11 = __fmul_rn(q.tx, q.ty);
    const T* gp = g + (size_t)b * C * hw + r;
    float* a = acc + (size_t)b * C * hw + (ptrdiff_t)q.y0 * W + q.x0;
    for (int c = 0; c < C; ++c, gp += hw, a += hw) {
      const float v = to_f32(*gp);
      if (v == 0.0f) continue;
      if (q.v00) atomicAdd(a, __fmul_rn(v, w00));
      if (q.v01) atomicAdd(a + 1, __fmul_rn(v, w01));
      if (q.v10) atomicAdd(a + W, __fmul_rn(v, w10));
      if (q.v11) atomicAdd(a + W + 1, __fmul_rn(v, w11));
    }
  }
  if (out == nullptr) return;
  grid.sync();
  for (size_t i = t0; i < n; i += stride) from_f32(acc[i], out + i);
}

// one tap of plane p, zero outside the image (row yi, column xi as floats:
// a coordinate may be far outside int range)
template <typename T>
__device__ __forceinline__ float tap(const T* p, float yi, float xi, int H,
                                     int W) {
  if (xi < 0.0f || xi > (float)(W - 1) || yi < 0.0f || yi > (float)(H - 1))
    return 0.0f;
  return to_f32(p[(ptrdiff_t)yi * W + (ptrdiff_t)xi]);
}

// the derivative of a bilinear sample along one axis, from the taps below
// (lo = floor), at and above it: between taps hi - lo; at an integer
// coordinate (frac == 0) XLA's hat derivative lo + (hi - below) / 2
__device__ __forceinline__ float hat_diff(float below, float lo, float hi,
                                          bool integer) {
  return integer ? __fadd_rn(lo, __fmul_rn(0.5f, __fsub_rn(hi, below)))
                 : __fsub_rn(hi, lo);
}

// the flow gradient: a thread per pixel, every channel
template <typename T>
__global__ void __launch_bounds__(TPB)
flow_warp_bwd_flow_kernel(const T* __restrict__ g, const T* __restrict__ maps,
                          const float* __restrict__ flow,
                          float* __restrict__ gflow, int B, int C, int H,
                          int W, int gh, int gw, int align_corners) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * TPB + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const int b = (int)(i / hw);
  const size_t r = i - (size_t)b * hw;
  const int y = (int)(r / W), x = (int)(r - (size_t)y * W);
  const float* fl = flow + (size_t)b * 2 * hw + r;
  float fx, fy;
  flow_coords(fl[0], fl[hw], x, y, H, W, gh, gw, align_corners, &fx, &fy);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = __fsub_rn(fx, x0), ty = __fsub_rn(fy, y0);
  const float ux = __fsub_rn(1.0f, tx), uy = __fsub_rn(1.0f, ty);
  const bool ix = tx == 0.0f, iy = ty == 0.0f;
  float sx = 0.0f, sy = 0.0f;
  for (int c = 0; c < C; ++c) {
    const T* p = maps + ((size_t)b * C + c) * hw;
    const float v00 = tap(p, y0, x0, H, W), v01 = tap(p, y0, x0 + 1.0f, H, W);
    const float v10 = tap(p, y0 + 1.0f, x0, H, W);
    const float v11 = tap(p, y0 + 1.0f, x0 + 1.0f, H, W);
    const float v0m = ix ? tap(p, y0, x0 - 1.0f, H, W) : 0.0f;
    const float v1m = ix ? tap(p, y0 + 1.0f, x0 - 1.0f, H, W) : 0.0f;
    const float vm0 = iy ? tap(p, y0 - 1.0f, x0, H, W) : 0.0f;
    const float vm1 = iy ? tap(p, y0 - 1.0f, x0 + 1.0f, H, W) : 0.0f;
    const float dx = __fadd_rn(__fmul_rn(uy, hat_diff(v0m, v00, v01, ix)),
                               __fmul_rn(ty, hat_diff(v1m, v10, v11, ix)));
    const float dy = __fadd_rn(__fmul_rn(ux, hat_diff(vm0, v00, v10, iy)),
                               __fmul_rn(tx, hat_diff(vm1, v01, v11, iy)));
    const float gv = to_f32(g[((size_t)b * C + c) * hw + r]);
    sx = __fadd_rn(sx, __fmul_rn(gv, dx));
    sy = __fadd_rn(sy, __fmul_rn(gv, dy));
  }
  // d fx / d flow_x, transposed in the JAX code's order: fx = ((gx + 1) *
  // 0.5) * (W - 1) [align_corners] or ((gx + 1) * W - 1) * 0.5, and
  // gx = base + flow_x / ((W - 1) / 2)
  const float cx = align_corners
                       ? __fmul_rn(__fmul_rn(sx, (float)(W - 1)), 0.5f)
                       : __fmul_rn(__fmul_rn(sx, 0.5f), (float)W);
  const float cy = align_corners
                       ? __fmul_rn(__fmul_rn(sy, (float)(H - 1)), 0.5f)
                       : __fmul_rn(__fmul_rn(sy, 0.5f), (float)H);
  gflow[(size_t)b * 2 * hw + r] = __fdiv_rn(cx, (float)(W - 1) / 2.0f);
  gflow[(size_t)b * 2 * hw + hw + r] = __fdiv_rn(cy, (float)(H - 1) / 2.0f);
}

template <typename T>
int launch_flow_warp_bwd_maps(const void* g, const void* flow, float* acc,
                              void* out, int B, int C, int H, int W, int gh,
                              int gw, int align_corners, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flow_warp_bwd_maps_kernel<T>, TPB, 0);
  if (e != cudaSuccess) return (int)e;
  const size_t need = blocks_for((size_t)B * C * H * W);
  const unsigned grid =
      (unsigned)(need < (size_t)sms * per_sm ? need : (size_t)sms * per_sm);
  const T* gp = (const T*)g;
  const float* fp = (const float*)flow;
  T* op = (T*)out;
  void* args[] = {(void*)&gp, (void*)&fp, (void*)&acc, (void*)&op,
                  (void*)&B,  (void*)&C,  (void*)&H,   (void*)&W,
                  (void*)&gh, (void*)&gw, (void*)&align_corners};
  e = cudaLaunchCooperativeKernel((const void*)flow_warp_bwd_maps_kernel<T>,
                                  dim3(grid), dim3(TPB), args, 0, s);
  if (e != cudaSuccess) return (int)e;
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

// img (B, C, H, W); fx, fy (B, Ho, Wo) float32 absolute source coordinates;
// out (B, C, Ho, Wo). Zeros padding.
extern "C" int mfc_warp_abs(const void* img, const void* fx, const void* fy,
                            void* out, int B, int C, int H, int W, int Ho,
                            int Wo, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)B * Ho * Wo;
  if (n == 0 || C == 0) return 0;
  if (dtype == 0)
    warp_abs_kernel<float><<<blocks_for(n), TPB, 0, s>>>(
        (const float*)img, (const float*)fx, (const float*)fy, (float*)out, B,
        C, H, W, Ho, Wo);
  else if (dtype == 1)
    warp_abs_kernel<__nv_bfloat16><<<blocks_for(n), TPB, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)fx, (const float*)fy,
        (__nv_bfloat16*)out, B, C, H, W, Ho, Wo);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
// or bfloat16 (1), the upstream gradient; flow (B, 2, H, W) float32; acc
// (B, C, H, W) float32 scratch, or the float32 result; out (B, C, H, W) in
// g's type, or null when acc is the result. One cooperative launch.
extern "C" int mfc_flow_warp_bwd_maps(const void* g, const void* flow,
                                      void* acc, void* out, int B, int C,
                                      int H, int W, int gh, int gw,
                                      int align_corners, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)B * H * W == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch_flow_warp_bwd_maps<float>(g, flow, (float*)acc, out, B, C,
                                            H, W, gh, gw, align_corners, s);
  if (dtype == 1)
    return launch_flow_warp_bwd_maps<__nv_bfloat16>(
        g, flow, (float*)acc, out, B, C, H, W, gh, gw, align_corners, s);
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
  const size_t n = (size_t)B * H * W;
  if (n == 0) return 0;
  if (dtype == 0)
    flow_warp_bwd_flow_kernel<float><<<blocks_for(n), TPB, 0, s>>>(
        (const float*)g, (const float*)maps, (const float*)flow,
        (float*)gflow, B, C, H, W, gh, gw, align_corners);
  else if (dtype == 1)
    flow_warp_bwd_flow_kernel<__nv_bfloat16><<<blocks_for(n), TPB, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)maps,
        (const float*)flow, (float*)gflow, B, C, H, W, gh, gw,
        align_corners);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
