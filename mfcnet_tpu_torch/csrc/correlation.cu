// UnFlow's correlation cost volume (Hopper, sm_90a). Plain C interface, bound
// with ctypes by mfcnet_tpu_torch/ops/correlation.py, which holds the plain
// PyTorch version.
//
// Replaces mfcnet_tpu/ops/correlation_pallas.py::correlation_pallas
// (_corr_row_kernel):
//   out[b, y, x, dy_i * D + dx_i] =
//       (1 / C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]
// with f2 read as zero outside the image, D = 2 * (md / s) + 1 displacements
// per axis, (dx, dy) = ((dx_i - D / 2) * s, (dy_i - D / 2) * s). f1, f2:
// (B, H, W, C) float32 or bfloat16; out: (B, H, W, D * D) float32, the
// channels_last storage of the (B, D * D, H, W) tensor that UnFlow's next
// convolution reads.
//
// What bounds it on this card. At UnFlow's shapes (C = 256, D * D = 441)
// every output is a 256-long dot product: 2 * 441 * 256 = 225,792 operations
// per pixel against 2 * 256 input and 441 output values, ~60 operations per
// byte in float32. With float32 inputs the operations bound it: the products
// are float32 multiply-adds (the result is held to 1e-5 of the float32
// reference, which rules out the tensor cores' TF32). With bfloat16 inputs
// the tensor cores would compute the same sums exactly (bfloat16 products,
// float32 accumulation), and at their rate the bytes bound it; this kernel
// runs both types on the same float32 multiply-adds by choice, one simple
// body for both, and a tensor-core form for bfloat16 is later work.
//
// Design. The TPU kernel ran one program per (b, row, dy) on a zero-padded
// copy of f2 and kept two rows in VMEM. Here a block owns (b, y, a tile of TX
// pixels along x): it keeps its f1 tile in shared memory as float32, and
// streams the D rows y + dy of f2 past it, one segment of TX + 2 * (D / 2) * s
// pixels at a time, which serves all D values of dx. Zero padding is a bounds
// test while a segment is loaded (or, for a row outside the image, D * TX
// zeros written without any product): there is no padded copy of f2.
//
// The products are bound by shared-memory reads, not by FMAs, so a thread
// keeps a 4 x 8 tile of outputs in registers: 4 pixels x, x + s, x + 2s,
// x + 3s and 8 consecutive dx_i. Pixel x + i*s at displacement index j reads
// f2 pixel x + (i + j) * s, so the 32 outputs share 11 f2 pixels: 15 float4
// reads feed 128 multiply-adds. Such tiles are few (24 per f2 row at TX = 32,
// D = 21), so eight lanes share one tile and split C between them (lane q
// takes the float4 chunks q, q + 8, ...: a quarter warp reads 128 consecutive
// bytes, all 32 banks) and add their partial sums with shuffles. Rows are
// padded by 4 floats. bfloat16 inputs are widened when they are stored to
// shared memory. Sums and the product with 1 / C are float32.
//

#include "shared_memory.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int XT = 4;    // pixels per register tile, s apart
constexpr int DT = 8;    // consecutive dx_i per register tile
constexpr int KL = 8;    // lanes that share a tile and split C
constexpr int PAD = 4;   // floats of padding per shared-memory row
constexpr int MAX_TX = 32;

struct bf16_raw { unsigned short bits; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bfloat16 (8 bytes, little endian) widened exactly: a bfloat16 is the
// upper half of a float32
__device__ __forceinline__ float4 load4(const bf16_raw* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16_raw* p) {
  return __uint_as_float((unsigned)p->bits << 16);
}

// nrows pixels x = xfirst .. of one image row (row0 points at its pixel 0)
// into dst as float32 rows of ld floats; pixels outside [0, W) and the
// channels from C up to the next multiple of 4 become zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* row0,
                                          int xfirst, int nrows, int W, int C,
                                          int tid) {
  const int C4 = (C + 3) / 4;
  const bool vec = (C % 4) == 0;
  for (int idx = tid; idx < nrows * C4; idx += THREADS) {
    const int r = idx / C4, c4 = idx - r * C4;
    const int x = xfirst + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (x >= 0 && x < W) {
      const T* p = row0 + (size_t)x * C + 4 * c4;
      if (vec) {
        v = load4(p);
      } else {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int e = 0; e < 4; ++e)
          if (4 * c4 + e < C) t[e] = load1(p + e);
        v = make_float4(t[0], t[1], t[2], t[3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c4) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C, int s, int D,
                   int TX, float inv_c) {
  extern __shared__ __align__(16) float smem[];
  const int C4 = (C + 3) / 4;
  const int ld = 4 * C4 + PAD;
  const int R = (D / 2) * s;       // the largest |dx|
  const int SEG = TX + 2 * R;      // f2 pixels that serve one tile
  float* f1s = smem;               // TX rows
  float* f2s = smem + TX * ld;     // SEG rows

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, y = blockIdx.y, b = blockIdx.z;
  const int DD = D * D;
  const int DG = (D + DT - 1) / DT;
  const int NXG = (TX + XT * s - 1) / (XT * s) * s;  // x-groups of a tile
  const int q = tid % KL;                            // this lane's share of C
  const unsigned gmask = 0xffu << ((tid % 32) & ~(KL - 1));
  const size_t row_pixels = ((size_t)b * H + y) * W;

  load_rows(f1s, ld, f1 + row_pixels * C, x0, TX, W, C, tid);

  for (int dyi = 0; dyi < D; ++dyi) {
    const int y2 = y + (dyi - D / 2) * s;
    float* orow = out + row_pixels * DD + dyi * D;
    if (y2 < 0 || y2 >= H) {  // the same for the whole block
      for (int idx = tid; idx < TX * D; idx += THREADS) {
        const int xi = idx / D, dxi = idx - xi * D;
        if (x0 + xi < W) orow[(size_t)(x0 + xi) * DD + dxi] = 0.0f;
      }
      continue;
    }
    __syncthreads();  // the previous row's products have read f2s
    load_rows(f2s, ld, f2 + ((size_t)b * H + y2) * W * C, x0 - R, SEG, W, C,
              tid);
    __syncthreads();
    // tiles: x-group g covers pixels base + i * s, i < XT, with
    // base = (g / s) * XT * s + g % s; d-group dg covers dx_i dg * DT + j
    for (int item = tid / KL; item < NXG * DG; item += THREADS / KL) {
      const int dg = item / NXG, g = item - dg * NXG;
      const int base = (g / s) * XT * s + g % s;
      const float4* a[XT];
#pragma unroll
      for (int i = 0; i < XT; ++i)
        a[i] = reinterpret_cast<const float4*>(
            f1s + min(base + i * s, TX - 1) * ld);
      // f2 pixel of (i, j) is segment row base + (dg * DT + i + j) * s; rows
      // past the segment belong to outputs that are not stored
      const float4* bp[XT + DT - 1];
#pragma unroll
      for (int k = 0; k < XT + DT - 1; ++k)
        bp[k] = reinterpret_cast<const float4*>(
            f2s + min(base + (dg * DT + k) * s, SEG - 1) * ld);
      float acc[XT][DT];
#pragma unroll
      for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = 0.0f;
      for (int c4 = q; c4 < C4; c4 += KL) {
        float4 av[XT];
#pragma unroll
        for (int i = 0; i < XT; ++i) av[i] = a[i][c4];
#pragma unroll
        for (int k = 0; k < XT + DT - 1; ++k) {
          const float4 bv = bp[k][c4];
#pragma unroll
          for (int i = 0; i < XT; ++i) {
            const int j = k - i;  // known when the loops are unrolled
            if (j >= 0 && j < DT) {
              acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
              acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
              acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
              acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
            }
          }
        }
      }
      // add the KL lanes' partial sums; lane q then stores outputs
      // 4q .. 4q + 3 of the 32
#pragma unroll
      for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          float v = acc[i][j];
          v += __shfl_xor_sync(gmask, v, 1);
          v += __shfl_xor_sync(gmask, v, 2);
          v += __shfl_xor_sync(gmask, v, 4);
          const int xi = base + i * s, dxi = dg * DT + j;
          if (q == (i * DT + j) / 4 && xi < TX && x0 + xi < W && dxi < D)
            orow[(size_t)(x0 + xi) * DD + dxi] = v * inv_c;
        }
    }
  }
}

template <typename T>
int run(const void* f1, const void* f2, float* out, int B, int H, int W, int C,
        int md, int s, cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<correlation_kernel<T>>(&limit);
  if (rc != 0) return rc;
  const int D = 2 * (md / s) + 1;
  const int R = (D / 2) * s;
  const int ld = 4 * ((C + 3) / 4) + PAD;
  // tiles of nearly equal width, a multiple of 8 and at most MAX_TX; narrower
  // ones if a tile and its f2 segment do not fit in shared memory
  const int ntiles = (W + MAX_TX - 1) / MAX_TX;
  int TX = (((W + ntiles - 1) / ntiles) + 7) / 8 * 8;
  auto bytes = [&](int tx) { return (size_t)(2 * tx + 2 * R) * ld * 4; };
  while (TX > 8 && bytes(TX) > (size_t)limit) TX -= 8;
  if (bytes(TX) > (size_t)limit) return -1;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, H, B);
  correlation_kernel<T><<<grid, THREADS, bytes(TX), stream>>>(
      (const T*)f1, (const T*)f2, out, H, W, C, s, D, TX, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2 (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous;
// out (B, H, W, D * D) float32. Returns cudaGetLastError(), or -1 when C and
// md need more shared memory than a block may have.
extern "C" int mfc_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int md, int s,
                               int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (dtype == 0)
    return run<float>(f1, f2, (float*)out, B, H, W, C, md, s, st);
  if (dtype == 1)
    return run<bf16_raw>(f1, f2, (float*)out, B, H, W, C, md, s, st);
  return (int)cudaErrorInvalidValue;
}
