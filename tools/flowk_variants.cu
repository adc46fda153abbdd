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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

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
