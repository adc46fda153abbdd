// Shared pieces of the two direct 3x3 convolution kernels (conv3x3.cu,
// stage1.cu), both stride 1, SAME padding, NHWC, HWIO weights, float32 sums.
//
// bfloat16: one Hopper core (second half of this file). At the first VGG
// stage's shapes the tensor cores bound the work: 22.6 GFLOP for 480 x 640 x
// 64 -> 64 take 23 us at 989 TFLOP/s, its 79 MB of input and output 23 us at
// 3.35 TB/s. What kept the tile kernels below (mma.sync) at 10 % of that peak
// was moving the operands, not the products: every 8 x 16-pixel block copied
// the nine taps' 74 KB of weights out of L2 (177 MB at 480 x 640, 4.5x the
// input), with thread copies, synchronously, two blocks an SM. The core
// answers each: persistent blocks copy their column tile's weights once and
// keep them; the input's ring tile arrives by TMA into rings of stages that
// a producer warp keeps full while two consumer warpgroups take turns with
// wgmma; and the tap shift costs nothing, because the ring tile lies in
// 8-channel planes in which every tap's operand is the same plane at
// another start address. Its resident weights bound what it takes (conv3x3:
// 9 cin N bf16 with N >= 16; vgg_stage1: both convolutions' weights and an
// im2col of 9 cin columns): experimental/conv3x3.py::conv_plan and
// ::stage1_plan give the shapes past that to the tile kernels.
//
// The tile kernels (first half): a block of four warps owns a tile of TH x TW
// = 8 x 16 output pixels and, at a time, BN = 64 output channels. The input
// it needs -- the tile with a one-pixel ring, (TH + 2) x (TW + 2) pixels, KC
// channels at a time -- lies in shared memory, pixel-major, and so does the
// matching chunk of the weights, [tap][k][n], so that they take any cin.
//
//   * float32: on plain FMAs, so that the kernel can be held to a float32
//     tolerance (wgmma has no exact float32 product). Thread t owns tile row
//     t / 16 (16 pixels) and the four channels t % 16 + 16 j.
//   * bfloat16, for the shapes the core does not take: ldmatrix + mma.sync
//     m16n8k16, float32 accumulation. Warp w owns tile rows 2w and 2w + 1:
//     one 16-pixel row is one m16 fragment, so two A fragments meet four
//     transposed weight fragments (eight n8 blocks) in sixteen products per
//     16 of k.
//
// Rows are padded by 16 bytes: ldmatrix rows and float4 reads of consecutive
// pixels then fall into different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ===================================================================
// The bfloat16 core of both kernels (Hopper: wgmma, TMA, persistent blocks)
// ===================================================================
//
// A block is two consumer warpgroups and a producer (one warp in conv3x3,
// a warpgroup in vgg_stage1, whose 6-byte pixels take plain loads). It owns one
// column tile of N output channels: its nine-tap weight slice is copied into
// shared memory once, and the block then walks the output tiles blk, blk +
// G, blk + 2 G, ... (G blocks per column tile), the warpgroups taking turns
// (ping-pong), so that one warpgroup's epilogue overlaps the other's
// products. A warpgroup's tile is R image rows x 64 pixels: every row
// segment is one m64nNk16 accumulator.
//
// The input a tile needs -- its (R + 2) x 66-pixel ring, 64 channels at a
// time -- lies in shared memory channel-group-major: eight planes of 8
// channels (16 bytes a pixel), each plane the ring tile's pixels in raster
// order. That is wgmma's no-swizzle K-major layout for every tap: a core
// matrix is 8 consecutive pixels x 16 bytes, so the operand of tap (dy, dx)
// starts 16 (66 dy + dx) bytes into the plane, 128 bytes between 8-pixel
// groups, one plane between the two channel groups of a k step. No im2col
// copy, and no tap reads the input again from L2. The weights use the same
// layout with output channels for pixels: element (n, k) of tap t lies at
// ((t KG + k / 8) N + n) * 16 + (k % 8) * 2 bytes.
//
// The producer fills the stages: with one TMA request per channel group (a
// box of 8 channels x 66 x (R + 2) of the (cin, W, H, B) input; the
// hardware's zero fill outside the tensor is the SAME padding and the
// channels past cin) where cin is a multiple of 8, else with plain loads
// (pixels of 2 cin bytes are no legal TMA stride).
namespace mfc_conv {

using namespace mfc;
using bf16 = __nv_bfloat16;

constexpr int SEG = 64;          // output pixels of a row segment (wgmma M)
constexpr int RING_W = SEG + 2;  // ... with the 3x3 ring
constexpr int CONSUMER_WGS = 2;
constexpr int CORE_THREADS = CONSUMER_WGS * 128 + 32;  // + the producer warp
constexpr int MAX_STAGES = 4;
constexpr int ERR_PLAN = 20002;  // a plan the kernel cannot run

// one channel-group plane of a ring tile of `rows` rows, padded to 128 bytes
__host__ __device__ constexpr int plane_bytes(int rows) {
  return (rows * RING_W * 16 + 127) / 128 * 128;
}
__host__ __device__ constexpr int round_up_c(int v, int m) {
  return (v + m - 1) / m * m;
}

// The configuration of one launch, from experimental/conv3x3.py::conv_plan
// (conv3x3) or ::stage1_plan (vgg_stage1), in this order. For the tile
// kernels (core == 0) it describes their fixed tiles: TH rows, BN (conv3x3)
// or all C1 (vgg_stage1) columns, one block a tile.
struct Plan {
  int rows;        // R: image rows of a warpgroup's tile
  int n;           // N: output channels of a column tile
  int col_tiles;
  int tma;         // 1: TMA loader, 0: plain loads
  int stages;
  int tiles;       // tiles of R rows x 64 pixels over B, H, W
  int blocks;      // persistent blocks per column tile (G)
  int smem_bytes;  // dynamic shared memory of a block
  int kpad;        // conv3x3: cin, vgg_stage1: C1, rounded up to 16
  int k1pad;       // vgg_stage1: 9 cin rounded up to 16
  int core;        // 1: the core, 0: the mma.sync tile kernel
};
constexpr int PLAN_INTS = 11;
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "the wrappers' order");

// named barrier `id` of `threads` threads (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// tile t -> image b, first row y0, first column x0
__device__ __forceinline__ void tile_origin(int t, int tiles_x, int tiles_y,
                                            int rows, int& b, int& y0,
                                            int& x0) {
  const int tx = t % tiles_x;
  t /= tiles_x;
  y0 = (t % tiles_y) * rows;
  b = t / tiles_y;
  x0 = tx * SEG;
}

// Rows [0, rows) of a (taps, rows, cols) bfloat16 tensor, output columns
// [n0, n0 + ncols) -> shared memory in the no-swizzle K-major layout
// (element (n, k) of tap t at ((t * kpad / 8 + k / 8) * ncols + n) * 16 +
// (k % 8) * 2 bytes), zeros past `rows` (up to kpad) and past `cols`. A
// thread gathers one 16-byte run (8 k of one n): neighbouring threads read
// neighbouring n (coalesced) and write neighbouring runs (no bank conflict).
__device__ void load_kmajor(unsigned char* dst, const bf16* w, int taps,
                            int rows, int cols, int kpad, int n0, int ncols,
                            int tid, int nthreads) {
  const int kg = kpad / 8;
  for (int idx = tid; idx < taps * kg * ncols; idx += nthreads) {
    const int n = idx % ncols, tg = idx / ncols;  // tg = tap * kg + k / 8
    const int tap = tg / kg, k0 = 8 * (tg - tap * kg);
    const bool col = n0 + n < cols;
    const bf16* src = w + ((size_t)tap * rows + k0) * cols + n0 + n;
    __align__(16) bf16 e8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      e8[e] = col && k0 + e < rows ? src[(size_t)e * cols]
                                   : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<uint4*>(dst + (size_t)idx * 16) =
        *reinterpret_cast<const uint4*>(e8);
  }
}

// the warp's index, in a register the compiler knows to be warp-uniform (a
// role or a loop bound taken from threadIdx would make ptxas serialize the
// warpgroup's wgmma as on a divergent path)
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
}

// acc[r] += the nine taps' products of row segment r of a warpgroup's tile:
// ring = the first channel-group plane of the (R + 2) x 66 ring tile,
// `plane` bytes apart, `ksteps` k steps of 16 channels; the weights of
// channel group g0 + 2 ks of tap t at w_s + (t * kg + g0 + 2 ks) * N * 16.
// Returns when the products are done.
template <int N, int R>
__device__ __forceinline__ void ring_product(float (&acc)[R][N / 2],
                                             unsigned ring, int plane,
                                             int ksteps, unsigned w_s, int kg,
                                             int g0) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint64_t db = smem_desc_plain(
          w_s + (unsigned)((tap * kg + g0 + 2 * ks) * N * 16), N * 16, 128);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint64_t da = smem_desc_plain(
            ring + (unsigned)(2 * ks * plane + ((r + dy) * RING_W + dx) * 16),
            plane, 128);
        Wgmma<N>::mma(acc[r], da, db);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// w[i]: this lane's pair of channels 2q, 2q + 1 of 8-channel block i (q =
// lane % 4). Returns the four pairs of block q, gathered from the quad.
__device__ __forceinline__ uint4 quad_transpose(const unsigned (&w)[4],
                                                int lane) {
  const int q = lane & 3;
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = (q - r) & 3, d = (q + r) & 3;
    const unsigned send = s == 0 ? w[0] : s == 1 ? w[1] : s == 2 ? w[2] : w[3];
    const unsigned got = __shfl_sync(0xffffffffu, send, (lane & ~3) | d);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = d == i ? got : v[i];
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Epilogue of a warpgroup's tile: + bias (float32, may be null), ReLU if
// asked, one rounding to bfloat16, pixels inside the image and channels
// below cout. A lane holds pixels 16 w + lane / 4 (+ 8) of each row segment
// and channels 8 j + 2 (lane % 4) (+ 1): where cout is a multiple of 8, the
// quad trades its pairs so that each lane stores one 16-byte run of 8
// channels, and a warp's store covers whole 32-byte sectors. Every lane
// reads every accumulator on the same path (only the stores are masked):
// an accumulator read under a branch makes ptxas serialize the next tile's
// wgmma.
template <int N, int R>
__device__ __forceinline__ void store_core(const float (&acc)[R][N / 2],
                                           bf16* out, const float* bias,
                                           bool relu, int b, int y0, int x0,
                                           int n0, int H, int W, int cout,
                                           int wtid) {
  const int wi = wtid / 32, lane = wtid % 32, q = lane % 4;
  float bv[N / 4];  // bias of channels n0 + 8 j + 2 q + e at 2 j + e
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int n = n0 + 8 * (i / 2) + 2 * q + i % 2;
    const float v = bias != nullptr ? bias[min(n, cout - 1)] : 0.0f;
    bv[i] = n < cout ? v : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned wd[N / 8];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        float v0 = acc[r][4 * j + 2 * h] + bv[2 * j];
        float v1 = acc[r][4 * j + 2 * h + 1] + bv[2 * j + 1];
        v0 = relu ? fmaxf(v0, 0.0f) : v0;
        v1 = relu ? fmaxf(v1, 0.0f) : v1;
        wd[j] = pack_bf16x2(v0, v1);
      }
      const int y = y0 + r, x = x0 + wi * 16 + lane / 4 + 8 * h;
      const bool inside = y < H && x < W;
      bf16* px = out + (((size_t)b * H + (inside ? y : 0)) * W +
                        (inside ? x : 0)) * cout;
      if (N >= 32 && cout % 8 == 0) {
#pragma unroll
        for (int g = 0; g < N / 32; ++g) {
          const unsigned w4[4] = {wd[4 * g], wd[4 * g + 1], wd[4 * g + 2],
                                  wd[4 * g + 3]};
          const uint4 v = quad_transpose(w4, lane);
          const int n = n0 + 8 * (4 * g + q);
          if (inside && n < cout) *reinterpret_cast<uint4*>(px + n) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (!inside || n >= cout) continue;
          if (n + 1 < cout && cout % 2 == 0) {
            *reinterpret_cast<unsigned*>(px + n) = wd[j];
          } else {
            const __nv_bfloat162 v2 =
                *reinterpret_cast<const __nv_bfloat162*>(&wd[j]);
            px[n] = v2.x;
            if (n + 1 < cout) px[n + 1] = v2.y;
          }
        }
      }
    }
  }
}

template <int N, int R>
__device__ __forceinline__ void zero_acc(float (&acc)[R][N / 2]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.0f;
}

}  // namespace mfc_conv
