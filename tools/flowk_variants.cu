// Stripped variants of the head's flow warp (bf16 maps, float32 flow), to
// show where its time goes: tools/flowk_times.py --variants builds this file
// with nvcc into build/ and times each variant by CUDA-graph replay at the
// path's shape. Not part of the package; no model calls it.
//
//   0 "parent"      the first design's one-thread-per-pixel kernel
//                   (mfcnet_tpu_torch/csrc/warp.cu before its redesign):
//                   flattened B*H*W, 256 threads a block
//   1 "coordinates" flow loads, base grid and coordinates as in 0, then C
//                   stores of a value made from the coordinates: no taps
//   2 "taps"        0 without its stores: the four taps of every channel
//                   are read and blended, and stored only when the blend
//                   equals a value it never takes
//   3 "tile 32x8"   0's body on 2D blocks of 32 x 8 pixels
//   4 "copy"        the same bytes without a gather: the flow read, each
//                   channel read at the pixel itself and written out
//
// and of the first design of B1's maps gradient (bf16 g, float32 flow;
// probe_bwd_maps), one cooperative launch each, to split its time:
//
//   0 "first design"   zero a float32 (B, C, H, W) accumulator, scatter
//                      with global float32 atomicAdd, cast to bf16
//   1 "zero and cast"  the accumulator's two passes, no scatter
//   2 "plain stores"   0 with a plain store in place of each atomic (wrong
//                      where taps are shared: for timing only)
//   3 "shared scatter" the scatter's reads and weights, its atomics into a
//                      block's 16 KB of shared memory (the tap's address
//                      folded into it); no accumulator, no zero, no cast

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TPB = 256;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float unnormalize(float g, int size, int ac) {
  if (ac)
    return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), (float)(size - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f),
                   0.5f);
}

struct Coords {
  float fx, fy;
};

__device__ __forceinline__ Coords coords(const float* fl, size_t hw, int x,
                                         int y, int H, int W, int gh, int gw,
                                         int ac) {
  const float bx = __fsub_rn(
      __fdiv_rn(__fmul_rn(2.0f, (float)x), (float)(gw - 1)), 1.0f);
  const float by = __fsub_rn(
      __fdiv_rn(__fmul_rn(2.0f, (float)y), (float)(gh - 1)), 1.0f);
  const float gx = __fadd_rn(bx, __fdiv_rn(fl[0], (float)(W - 1) / 2.0f));
  const float gy = __fadd_rn(by, __fdiv_rn(fl[hw], (float)(H - 1) / 2.0f));
  return {unnormalize(gx, W, ac), unnormalize(gy, H, ac)};
}

// the parent's sample_pixel; `store` false keeps the blends in a sum that
// is stored only if it takes an impossible value
template <bool store>
__device__ __forceinline__ void sample(const bf16* img, int C, int H, int W,
                                       size_t hw, float fx, float fy,
                                       bf16* out) {
  const float x0f = floorf(fx), y0f = floorf(fy);
  const float tx = __fsub_rn(fx, x0f), ty = __fsub_rn(fy, y0f);
  const float ux = __fsub_rn(1.0f, tx), uy = __fsub_rn(1.0f, ty);
  const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
  const int x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)(W - 1));
  const int y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)(H - 1));
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  const ptrdiff_t base = (ptrdiff_t)y0 * W + x0;
  float sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    const bf16* p = img + c * hw + base;
    const float a = v00 ? __bfloat162float(p[0]) : 0.0f;
    const float b = v01 ? __bfloat162float(p[1]) : 0.0f;
    const float d = v10 ? __bfloat162float(p[W]) : 0.0f;
    const float e = v11 ? __bfloat162float(p[W + 1]) : 0.0f;
    const float top = __fadd_rn(__fmul_rn(a, ux), __fmul_rn(b, tx));
    const float bot = __fadd_rn(__fmul_rn(d, ux), __fmul_rn(e, tx));
    const float v = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, ty));
    if (store)
      out[c * hw] = __float2bfloat16_rn(v);
    else
      sum += v;
  }
  if (!store && sum == -1234.5f) out[0] = __float2bfloat16_rn(sum);
}

template <int variant>
__device__ __forceinline__ void pixel(const bf16* maps, const float* flow,
                                      bf16* out, int b, int x, int y, int C,
                                      int H, int W, int gh, int gw, int ac) {
  const size_t hw = (size_t)H * W;
  const size_t r = (size_t)y * W + x;
  const float* fl = flow + (size_t)b * 2 * hw + r;
  const bf16* img = maps + (size_t)b * C * hw;
  bf16* o = out + (size_t)b * C * hw + r;
  if (variant == 4) {
    const float f = fl[0] + fl[hw];
    for (int c = 0; c < C; ++c)
      o[c * hw] = __float2bfloat16_rn(__bfloat162float(img[c * hw + r]) + f);
    return;
  }
  const Coords q = coords(fl, hw, x, y, H, W, gh, gw, ac);
  if (variant == 1) {
    const bf16 v = __float2bfloat16_rn(q.fx + q.fy);
    for (int c = 0; c < C; ++c) o[c * hw] = v;
    return;
  }
  if (variant == 2) {
    sample<false>(img, C, H, W, hw, q.fx, q.fy, o);
    return;
  }
  sample<true>(img, C, H, W, hw, q.fx, q.fy, o);
}

template <int variant>
__global__ void __launch_bounds__(TPB)
flat_kernel(const bf16* __restrict__ maps, const float* __restrict__ flow,
            bf16* __restrict__ out, int B, int C, int H, int W, int gh, int gw,
            int ac) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * TPB + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const int b = (int)(i / hw);
  const int r = (int)(i - (size_t)b * hw);
  pixel<variant>(maps, flow, out, b, r % W, r / W, C, H, W, gh, gw, ac);
}

__global__ void __launch_bounds__(TPB)
tile_kernel(const bf16* __restrict__ maps, const float* __restrict__ flow,
            bf16* __restrict__ out, int B, int C, int H, int W, int gh, int gw,
            int ac) {
  const int x = blockIdx.x * 32 + threadIdx.x % 32;
  const int y = blockIdx.y * 8 + threadIdx.x / 32;
  if (x >= W || y >= H) return;
  pixel<0>(maps, flow, out, blockIdx.z, x, y, C, H, W, gh, gw, ac);
}

// B1's first maps-gradient kernel and its stripped variants
constexpr int SH = 4096;  // floats of variant 3's shared buffer

template <int V>
__global__ void __launch_bounds__(TPB)
bwd_maps_probe(const bf16* __restrict__ g, const float* __restrict__ flow,
               float* __restrict__ acc, bf16* __restrict__ out, int B, int C,
               int H, int W, int gh, int gw, int ac) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[V == 3 ? SH : 1];
  const size_t hw = (size_t)H * W, n = (size_t)B * C * hw;
  const size_t stride = (size_t)gridDim.x * TPB;
  const size_t t0 = (size_t)blockIdx.x * TPB + threadIdx.x;
  if (V == 3) {
    for (int j = threadIdx.x; j < SH; j += TPB) sh[j] = 0.0f;
    __syncthreads();
  } else {
    for (size_t i = t0; i < n; i += stride) acc[i] = 0.0f;
    grid.sync();
  }
  if (V != 1) {
    for (size_t i = t0; i < (size_t)B * hw; i += stride) {
      const int b = (int)(i / hw);
      const size_t r = i - (size_t)b * hw;
      const int y = (int)(r / W), x = (int)(r - (size_t)y * W);
      const Coords q = coords(flow + (size_t)b * 2 * hw + r, hw, x, y, H, W,
                              gh, gw, ac);
      const float x0f = floorf(q.fx), y0f = floorf(q.fy);
      const float tx = __fsub_rn(q.fx, x0f), ty = __fsub_rn(q.fy, y0f);
      const float ux = __fsub_rn(1.0f, tx), uy = __fsub_rn(1.0f, ty);
      const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
      const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
      const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
      const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
      const int x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)(W - 1));
      const int y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)(H - 1));
      const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
      const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
      const float w00 = __fmul_rn(ux, uy), w01 = __fmul_rn(tx, uy);
      const float w10 = __fmul_rn(ux, ty), w11 = __fmul_rn(tx, ty);
      const bf16* gp = g + (size_t)b * C * hw + r;
      const ptrdiff_t o = (ptrdiff_t)y0 * W + x0;
      float* a = acc + (size_t)b * C * hw + o;
      for (int c = 0; c < C; ++c, gp += hw, a += hw) {
        const float v = __bfloat162float(*gp);
        if (v == 0.0f) continue;
        if (V == 0) {
          if (v00) atomicAdd(a, __fmul_rn(v, w00));
          if (v01) atomicAdd(a + 1, __fmul_rn(v, w01));
          if (v10) atomicAdd(a + W, __fmul_rn(v, w10));
          if (v11) atomicAdd(a + W + 1, __fmul_rn(v, w11));
        } else if (V == 2) {
          if (v00) a[0] = __fmul_rn(v, w00);
          if (v01) a[1] = __fmul_rn(v, w01);
          if (v10) a[W] = __fmul_rn(v, w10);
          if (v11) a[W + 1] = __fmul_rn(v, w11);
        } else {
          const int s = (int)((o + c * 61) & (SH - 1));
          if (v00) atomicAdd(sh + s, __fmul_rn(v, w00));
          if (v01) atomicAdd(sh + ((s + 1) & (SH - 1)), __fmul_rn(v, w01));
          if (v10) atomicAdd(sh + ((s + W) & (SH - 1)), __fmul_rn(v, w10));
          if (v11)
            atomicAdd(sh + ((s + W + 1) & (SH - 1)), __fmul_rn(v, w11));
        }
      }
    }
  }
  if (V == 3) {  // a block's sums leave in one small store
    __syncthreads();
    float sum = 0.0f;
    for (int j = threadIdx.x; j < SH; j += TPB) sum += sh[j];
    out[t0 % n] = __float2bfloat16_rn(sum);
    return;
  }
  grid.sync();
  for (size_t i = t0; i < n; i += stride) out[i] = __float2bfloat16_rn(acc[i]);
}

template <int V>
int launch_bwd_probe(const void* g, const void* flow, float* acc, void* out,
                     int B, int C, int H, int W, int gh, int gw, int ac,
                     cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bwd_maps_probe<V>, TPB, 0);
  if (e != cudaSuccess) return (int)e;
  const size_t need = ((size_t)B * C * H * W + TPB - 1) / TPB;
  const unsigned grid =
      (unsigned)(need < (size_t)sms * per_sm ? need : (size_t)sms * per_sm);
  const bf16* gp = (const bf16*)g;
  const float* fp = (const float*)flow;
  bf16* op = (bf16*)out;
  void* args[] = {(void*)&gp, (void*)&fp, (void*)&acc, (void*)&op,
                  (void*)&B,  (void*)&C,  (void*)&H,   (void*)&W,
                  (void*)&gh, (void*)&gw, (void*)&ac};
  e = cudaLaunchCooperativeKernel((const void*)bwd_maps_probe<V>, dim3(grid),
                                  dim3(TPB), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// g, out (B, C, H, W) bf16; flow (B, 2, H, W) float32; acc (B, C, H, W)
// float32 scratch. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// an unknown variant.
extern "C" int probe_bwd_maps(int variant, const void* g, const void* flow,
                              void* acc, void* out, int B, int C, int H,
                              int W, int gh, int gw, int ac, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)acc;
  switch (variant) {
    case 0:
      return launch_bwd_probe<0>(g, flow, a, out, B, C, H, W, gh, gw, ac, s);
    case 1:
      return launch_bwd_probe<1>(g, flow, a, out, B, C, H, W, gh, gw, ac, s);
    case 2:
      return launch_bwd_probe<2>(g, flow, a, out, B, C, H, W, gh, gw, ac, s);
    case 3:
      return launch_bwd_probe<3>(g, flow, a, out, B, C, H, W, gh, gw, ac, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// maps, out (B, C, H, W) bf16; flow (B, 2, H, W) float32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown variant.
extern "C" int probe_flow_warp(int variant, const void* maps, const void* flow,
                               void* out, int B, int C, int H, int W, int gh,
                               int gw, int ac, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(((size_t)B * H * W + TPB - 1) / TPB);
  const bf16* m = (const bf16*)maps;
  const float* f = (const float*)flow;
  bf16* o = (bf16*)out;
  switch (variant) {
    case 0:
      flat_kernel<0><<<blocks, TPB, 0, s>>>(m, f, o, B, C, H, W, gh, gw, ac);
      break;
    case 1:
      flat_kernel<1><<<blocks, TPB, 0, s>>>(m, f, o, B, C, H, W, gh, gw, ac);
      break;
    case 2:
      flat_kernel<2><<<blocks, TPB, 0, s>>>(m, f, o, B, C, H, W, gh, gw, ac);
      break;
    case 3:
      tile_kernel<<<dim3((W + 31) / 32, (H + 7) / 8, B), TPB, 0, s>>>(
          m, f, o, B, C, H, W, gh, gw, ac);
      break;
    case 4:
      flat_kernel<4><<<blocks, TPB, 0, s>>>(m, f, o, B, C, H, W, gh, gw, ac);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
