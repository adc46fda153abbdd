// Shared pieces of the two direct 3x3 convolution kernels (conv3x3.cu,
// stage1.cu): the tile shapes, the copy of a weight chunk into shared memory,
// the product of one output tile over the nine taps, and the fused epilogue
// (bias, ReLU, rounding to the tensors' type).
//
// A block of four warps owns a tile of TH x TW = 8 x 16 output pixels and, at
// a time, BN = 64 output channels. The input it needs -- the tile with a
// one-pixel ring, (TH + 2) x (TW + 2) pixels, KC channels at a time -- lies in
// shared memory, pixel-major, and so does the matching chunk of the weights,
// [tap][k][n]. Every tap is then the same small product, A (pixels x k,
// shifted by the tap inside the ring tile) times W (k x n): the convolution
// is computed directly, without an im2col copy.
//
//   * bfloat16: on the tensor cores (ldmatrix + mma.sync m16n8k16, float32
//     accumulation). Warp w owns tile rows 2w and 2w + 1: one 16-pixel row is
//     one m16 fragment, so two A fragments meet four transposed weight
//     fragments (eight n8 blocks) in sixteen products per 16 of k.
//   * float32: on plain FMAs, so that the kernel can be held to a float32
//     tolerance. Thread t owns tile row t / 16 (16 pixels) and the four
//     channels t % 16 + 16 j.
//
// Rows are padded by 16 bytes: ldmatrix rows and float4 reads of consecutive
// pixels then fall into different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mfc_conv {

constexpr int TH = 8, TW = 16;           // output pixels of a block
constexpr int HR = TH + 2, HC = TW + 2;  // ... with the 3x3 ring
constexpr int BN = 64;                   // output channels per pass
constexpr int THREADS = 128;             // four warps

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int KC = 32, VEC = 4;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int KC = 64, VEC = 8;
};
// leading dimensions (elements) of a KC-wide pixel row and a BN-wide weight row
template <typename T> __host__ __device__ constexpr int lda_of(int k) {
  return k + Elem<T>::VEC;
}
template <typename T> __host__ __device__ constexpr int ldb() {
  return BN + Elem<T>::VEC;
}
// elements of one staged weight chunk
template <typename T> __host__ __device__ constexpr int w_elems() {
  return 9 * Elem<T>::KC * ldb<T>();
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC elements src[0 .. VEC) -> dst (16 bytes, aligned); elements at or past
// `valid` become zero. `vec`: src is 16-byte aligned and all VEC are valid.
template <typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, int valid,
                                         bool vec) {
  constexpr int VEC = Elem<T>::VEC;
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  __align__(16) T tmp[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    tmp[e] = e < valid ? src[e] : from_f32<T>(0.0f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
}

// Weight chunk w[tap][k0 .. k0 + KC)[n0 .. n0 + BN) of a (9, cin, cout)
// tensor -> Ws[(tap * KC + kk) * ldb + n], zeros past cin and cout.
template <typename T>
__device__ __forceinline__ void load_weights(T* Ws, const T* w, int cin,
                                             int cout, int k0, int n0,
                                             int tid) {
  constexpr int KC = Elem<T>::KC, VEC = Elem<T>::VEC, NV = BN / VEC;
  const bool aligned = (cout % VEC) == 0;
  for (int idx = tid; idx < 9 * KC * NV; idx += THREADS) {
    const int row = idx / NV, v = idx - row * NV;
    const int tap = row / KC, kk = row - tap * KC;
    const int k = k0 + kk, n = n0 + v * VEC;
    const int valid = k < cin ? min(max(cout - n, 0), VEC) : 0;
    // an out-of-range source is never dereferenced: valid == 0 copies zeros
    const T* src = w + ((size_t)tap * cin + min(k, cin - 1)) * cout +
                   min(n, cout - 1);
    copy_vec(Ws + row * ldb<T>() + v * VEC, src, valid,
             aligned && valid == VEC);
  }
}

// ---- warp-level tensor-core primitives (sm_80+ PTX)
// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators of one thread for the block's TH x TW x BN tile.
template <typename T> struct Acc;

template <> struct Acc<__nv_bfloat16> {
  float c[2][8][4];
  int warp, lane;

  __device__ void init(int tid) {
    warp = tid / 32;
    lane = tid % 32;
    zero();
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
  }
  // += over the nine taps and KC of k. A: the ring tile, pixel-major, `lda`
  // elements per pixel, already offset to this chunk's first channel.
  __device__ void product(const __nv_bfloat16* A, int lda,
                          const __nv_bfloat16* Ws) {
    constexpr int KC = Elem<__nv_bfloat16>::KC, LDB = ldb<__nv_bfloat16>();
    // lane l addresses row l % 16, column block l / 16 of a 16x16 tile
    const int lrow = lane % 16, lcol = (lane / 16) * 8;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        unsigned fa[2][4], fb[4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pix = (2 * warp + i + dy) * HC + lrow + dx;
          ldmatrix_x4(fa[i], A + pix * lda + kk + lcol);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldmatrix_x4_trans(
              fb[j], Ws + (tap * KC + kk + lrow) * LDB + 16 * j + lcol);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma_16816(c[i][j], fa[i], fb[j / 2][2 * (j % 2)],
                      fb[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
  // fn(tile row, tile column, even channel within BN, value, value of the
  // next channel) for every pair of accumulators: a lane holds rows g and
  // g + 8 (here: pixels of one tile row), columns 2t and 2t + 1 of each
  // 16x8 block
  template <typename F>
  __device__ void for_each_pair(F fn) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fn(2 * warp + i, g + 8 * h, 8 * j + 2 * t, c[i][j][2 * h],
             c[i][j][2 * h + 1]);
  }
};

template <> struct Acc<float> {
  float c[TW][4];
  int r, c0;

  __device__ void init(int tid) {
    r = tid / 16;
    c0 = tid % 16;
    zero();
  }
  __device__ void zero() {
#pragma unroll
    for (int p = 0; p < TW; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[p][j] = 0.0f;
  }
  __device__ void product(const float* A, int lda, const float* Ws) {
    constexpr int KC = Elem<float>::KC, LDB = ldb<float>();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const float* arow = A + ((r + dy) * HC + dx) * lda;
      const float* wtap = Ws + tap * KC * LDB + c0;
#pragma unroll 1
      for (int k = 0; k < KC; k += 4) {
        float bv[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[q][j] = wtap[(k + q) * LDB + 16 * j];
#pragma unroll
        for (int p = 0; p < TW; ++p) {
          const float4 av = *reinterpret_cast<const float4*>(arow + p * lda + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            c[p][j] = fmaf(av.x, bv[0][j], c[p][j]);
            c[p][j] = fmaf(av.y, bv[1][j], c[p][j]);
            c[p][j] = fmaf(av.z, bv[2][j], c[p][j]);
            c[p][j] = fmaf(av.w, bv[3][j], c[p][j]);
          }
        }
      }
    }
  }
  template <typename F>
  __device__ void for_each(F fn) const {
#pragma unroll
    for (int p = 0; p < TW; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) fn(r, p, c0 + 16 * j, c[p][j]);
  }
};

// Fused epilogue: + bias (may be null), ReLU if asked, rounding to the
// tensors' type, stores of the pixels inside the image and the channels below
// cout. out: NHWC.
__device__ __forceinline__ void store_tile(const Acc<float>& acc, float* out,
                                           const float* bias, bool relu,
                                           int b, int ty0, int tx0, int n0,
                                           int H, int W, int cout) {
  acc.for_each([&](int row, int col, int ch, float v) {
    const int y = ty0 + row, x = tx0 + col, n = n0 + ch;
    if (y < H && x < W && n < cout) {
      if (bias != nullptr) v += bias[n];
      if (relu) v = fmaxf(v, 0.0f);
      out[(((size_t)b * H + y) * W + x) * cout + n] = v;
    }
  });
}

// bfloat16: two neighbouring channels leave in one 4-byte store where cout
// is even
__device__ __forceinline__ void store_tile(const Acc<__nv_bfloat16>& acc,
                                           __nv_bfloat16* out,
                                           const float* bias, bool relu,
                                           int b, int ty0, int tx0, int n0,
                                           int H, int W, int cout) {
  const bool pairs = (cout % 2) == 0;
  acc.for_each_pair([&](int row, int col, int ch, float v0, float v1) {
    const int y = ty0 + row, x = tx0 + col, n = n0 + ch;
    if (y >= H || x >= W || n >= cout) return;
    const bool second = n + 1 < cout;
    if (bias != nullptr) {
      v0 += bias[n];
      if (second) v1 += bias[n + 1];
    }
    if (relu) {
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
    }
    __nv_bfloat16* p = out + (((size_t)b * H + y) * W + x) * cout + n;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      p[0] = __float2bfloat16_rn(v0);
      if (second) p[1] = __float2bfloat16_rn(v1);
    }
  });
}

}  // namespace mfc_conv
