// UnFlow's correlation cost volume (Hopper, sm_90a). Plain C interface, bound
// with ctypes by mfcnet_tpu_torch/ops/correlation.py, which holds the plain
// PyTorch version and the launch plan (corr_plan).
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
// What bounds it. At UnFlow's shapes (C = 256, D * D = 441) every output is a
// 256-long dot product: ~60 operations per byte moved in float32. On float32
// multiply-adds (the first design, kept below as the "fma" route) the
// products bound it: 3.3 TFLOP/s at the tracker's shape, 20x its bound at the
// card's 67 TFLOP/s FMA rate. On the tensor cores (the "tc" route) they no
// longer do: the tiles below stage every f1 and f2 row that a block's
// windows reach, 25.6 MB of rows out of L2 at the tracker's shape and 347 MB
// at the offline CLI's (each pixel's 1 KB row is read by every tile whose
// window reaches it), and that operand traffic, with each block's fixed
// epilogue (its outputs staged and stored as contiguous runs), is what the
// kernel's time follows. A wgmma form of the same tiling (B split once per
// block into shared memory, A split in registers) measured no faster, and
// neither did TMA box loads, larger tiles (P of 128 pixels), a row-wise
// epilogue or unpadded swizzled rows (three four-stage blocks an SM); they
// were not kept (PERF.md, section 6).
//
// The "tc" route. With stride s, output (y, x) pairs f1 at (y, x) with f2 at
// (y + dy, x + dx), dy and dx multiples of s: the problem is s * s
// independent residue sub-grids (y mod s, x mod s) of Hs x Ws pixels, in
// each a window of radius R = D / 2 at stride 1, and every output is an
// entry of the sub-grid's Gram matrix f1 f2^T. A block owns (b, residue, a
// tile P of TY x L f1 pixels of the sub-grid, a run of TZ f2 rows): the f2
// pixels Q of those rows whose columns the tile's windows reach (NQ a row).
// Its eight warps take one m16 tile of P and one half of Q (NH n8 tiles)
// each, and run mma.sync over C: K-major f1 and f2 rows are the A and B
// operands as they lie in memory. A warp loads all its fragments of an
// 8-word k step first and then issues the products pass by pass across its
// tiles, so that consecutive products use other accumulators. cp.async
// brings 32-word (32 float32 or 64 bfloat16 channels) slices of P and Q
// into a ring, padded by 4 words a row so that the fragment loads hit 32
// banks: four stages where the grid is small (its blocks then have the SMs
// nearly to themselves and a deeper ring hides more of each block's load
// latency), three where it is large (three blocks an SM). The P tiles' f2
// rows are tiled from y0 - R, so that every (pixel, dy_i) has one owner
// block; an owner whose f2 row lies outside the image writes its zeros, and
// one whose rows all do computes nothing. The epilogue scatters the products
// into a zeroed shared-memory image of each pixel's TZ x D outputs (zeros
// where dx leaves the image) and stores each pixel's run of TZ * D
// contiguous floats with a warp: coalesced, and no output is written twice.
// ops/correlation.py::corr_plan picks TY, L, TZ and the stages (at most 64
// pixels in P and 96 in Q, so that the accumulators stay in registers), and
// this file refuses (ERR_PLAN) any plan but that one. Shapes with C % 8 != 0
// or a window wider than 96 pixels take the fma route.
//
// Numerics. bfloat16 inputs: one m16n8k16 bf16 product per 16 channels;
// bf16 x bf16 products are exact in float32 and the sums are float32, as in
// the plain version. float32 inputs: "3xTF32" (CUTLASS's name). Each operand
// is split, a = big + small with big = tf32(a) rounded to nearest (10
// explicit mantissa bits, |a - big| <= 2^-11 |a|) and small = a - big (exact
// in float32), which the tensor core truncates to tf32 (<= 2^-10 of small,
// 2^-21 |a|). The products small.big + big.small + big.big (small terms
// first, float32 accumulation in one register) miss a.b by small.small and
// the truncations of small, a few 2^-21 |a||b| a product; each tf32 product
// is exact in float32. Over C = 256 products of unit-scale features that is
// ~1e-6 of the sum before 1 / C, against the 1e-5 (atol and rtol) that the
// result is held to: tests/test_torch_corr_plan.py models the split on the
// CPU, and chip_smoke.py holds the card to the tolerance. Plain TF32 (big.big
// alone, 2^-11 a product) does not meet it.
//
// The fma route (the first design). A block owns (b, y, a tile of TX pixels
// along x): it keeps its f1 tile in shared memory as float32 and streams the
// D rows y + dy of f2 past it, one segment of TX + 2 * (D / 2) * s pixels at
// a time, which serves all D values of dx. A thread keeps a 4 x 8 tile of
// outputs in registers (4 pixels s apart, 8 consecutive dx_i: 15 float4
// reads feed 128 multiply-adds); eight lanes share one tile and split C
// between them, and add their partial sums with shuffles.
//
// The backward (B2, mfc_correlation_bwd). Replaces the VJP that
// correlation_pallas attaches with jax.custom_vjp (_bwd: jax.vjp of
// correlation_shifts). With g the (B, H, W, D * D) float32 upstream
// gradient:
//   grad_f1[p, c] = (1 / C) sum_d g[p, d] f2[p + off(d), c]
//   grad_f2[q, c] = (1 / C) sum_d g[q - off(d), d] f1[q - off(d), c]
// over in-image pixels only. On a residue sub-grid both have the forward's
// shape, a windowed product of radius R at stride 1: grad_f1 of the window
// of f2 with weights g[p, d], grad_f2 of the window of f1 with weights
// g[q + off(d'), d'^] read from the neighbour at the mirrored displacement
// (d' = (i', j') -> d'^ = (2R - i', 2R - j')). What bounds it: operations.
// Each gradient is the forward's 2 B H W D^2 C operations (1.16 GFLOP both
// at the tracker's 2 x 32 x 40 x 256), against ~15 MB of operands,
// gradients and g moved: 7.0 us at the 3xTF32 tensor-core rate, 17 us at
// the 67 TFLOP/s float32 FMA rate.
//
// The "tc" route (C % 8 == 0). Over a tile, each gradient is a dense
// product: grad[P, c] += G[P, Q] X[Q, c], with P a tile of TY x L output
// pixels of one sub-grid (the forward's tile), Q the in-image operand
// pixels that P's windows reach (rows y0 - R .. y0 + TY + R, columns x0 - R
// .. x0 + L + R, clipped), X the operand (f2 for grad_f1, f1 for grad_f2)
// and G the weights scattered into a P x Q matrix, zero outside each
// pixel's window. A block owns P and BTC_CC channels of one gradient and
// walks Q in chunks of BKC pixels, in order: cp.async brings the chunk's
// operand rows (K x N with N, the channels, contiguous) into a ring of
// BSTAGES, and with them, for float32 inputs, the chunk's weights, 4 bytes
// each (zeros outside the windows). grad_f1's weights lie as [m][k]
// (consecutive lanes read a pixel's g row along dx_i), grad_f2's as [k][m]
// (consecutive lanes, consecutive output pixels, read one source pixel's g
// row along dx_i, mirrored); the offsets are walked incrementally. Sixteen
// warps each take an m16 tile of P and a quarter of the block's channels
// (one 512-thread block an SM: against two 256-thread blocks of 64
// channels, the gather of the weights is shared by twice the channels;
// 10 % faster offline in bf16, within 3 % elsewhere) and run mma.sync. float32 inputs: 3xTF32 as in the forward (both operands split
// in registers; the operand's rows padded to 8 mod 32 words and the
// weights' to 4 or 8 mod 32, so that the tf32 fragment loads hit 32 banks).
// bfloat16 inputs: the operand exactly in bf16 (ldmatrix.trans on its
// [k][n] rows) and g split into three bf16 terms hi + mid + lo (float32's
// 24 bits, exactly), gathered into registers before a chunk's products and
// stored as terms after them, three m16n8k16 products (the weights by
// ldmatrix, transposed for grad_f2's [k][m]). The tensor core truncates its
// float32 sums: over a walk of a few hundred products their drift reached
// 5e-6 of the largest result, so each chunk's products are summed there
// from zero and added to the running sums with float32 adds that round to
// nearest (1e-6 of the largest on the card). The epilogue stores each
// output once: every output has one owner block, so there are no atomics
// and the result is the same from run to run, and a launch carries the
// blocks of both gradients (or of the one asked for).
//
// bfloat16 outputs and the plain version's roundings. Two bf16 terms of g
// (2^-16 of it left out) put the float32 sums ~3e-6 of the largest from
// the plain version's; three put them at the float32 level. Still, any
// order of summation other than the plain version's (one product and one
// sum a displacement) leaves outputs whose float32 value lies a few float32
// steps from a bf16 rounding midpoint rounded to the other neighbour (1,400
// of 5.2 M a gradient at the offline shape), and one such step of an
// output in the binade of the gradient's largest exceeds chip_smoke.py's
// bound of 2^-8 of the largest (seen: 0.0047). So the bf16 epilogue finds
// the outputs in the block's top binade (which bounds the gradient's from
// below) within BF16_NEAR float32 steps of a midpoint (a few hundred of
// the 10.5 M outputs at the offline shape) and has the warp sum each again
// in the plain version's order and arithmetic (plain_sum), overwriting the
// stored value.
// ops/correlation.py::corr_bwd_plan picks the route and the tile, and this
// file refuses (ERR_PLAN) any plan but that one.
//
// The "fma" route (C % 8 != 0; the first design). A block owns a tile of
// BTY x BTX sub-grid pixels and BCC channels of one gradient and walks the
// operand rows z that its windows reach: it stages row z (BTX + 2R pixels
// of BCC channels, widened to float32) and the weights of the tile's pixels
// for the displacement row z selects, then a thread (one tile row, 4
// adjacent pixels, 4 channels) sums D products a pixel and channel with
// float32 multiply-adds, sliding a window of 4 operand columns along dx.
// float32 sums (in dy-major order for grad_f1, the plain version's);
// bfloat16 inputs read widened. Both routes return each gradient in its
// input's type.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>

#include "shared_memory.cuh"

namespace {

// ------------------------------------------------------------ fma route
constexpr int FMA_THREADS = 256;
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
  for (int idx = tid; idx < nrows * C4; idx += FMA_THREADS) {
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
__global__ void __launch_bounds__(FMA_THREADS)
fma_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
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
      for (int idx = tid; idx < TX * D; idx += FMA_THREADS) {
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
    for (int item = tid / KL; item < NXG * DG; item += FMA_THREADS / KL) {
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
int run_fma(const void* f1, const void* f2, float* out, int B, int H, int W,
            int C, int md, int s, cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<fma_kernel<T>>(&limit);
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
  fma_kernel<T><<<grid, FMA_THREADS, bytes(TX), stream>>>(
      (const T*)f1, (const T*)f2, out, H, W, C, s, D, TX, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- tc route
constexpr int TC_THREADS = 256;  // eight warps: an m16 tile of P, half of Q
constexpr int MROWS = 64;        // f1 pixels of a block (P, padded)
constexpr int NT_MAX = 12;       // n8 tiles of f2 pixels (Q: 96 pixels)
constexpr int KW = 32;           // 32-bit words of a pixel's channels a stage
constexpr int LDW = KW + 4;      // words a shared-memory row
// ring stages: four where the grid is small (at most SMALL_GRID blocks: its
// blocks have the SMs nearly to themselves, and a deeper ring hides more of
// each block's load latency), three where it is large (three blocks an SM).
// Measured both ways on the H100 (PERF.md, section 6): four stages are 20 %
// faster at the tracker's 288 blocks, three 9 % faster at the offline 2,816.
constexpr int SMALL_GRID = 1024;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may have
constexpr int PLAN_INTS = 9;
constexpr int ERR_PLAN = 20003;   // the plan is not corr_plan's for the shape

// corr_plan's ints: route (0 fma, 1 tc), TY, L, TZ, NQ, NT, stages, grid,
// shared bytes; ops/correlation.py::corr_plan computes the same, step for
// step
struct Plan {
  int v[PLAN_INTS];
};

// the most f2 columns one of the x tiles of width L reaches, radius R
int needed_cols(int Ws, int L, int R) {
  int best = 0;
  for (int x0 = 0; x0 < Ws; x0 += L)
    best = std::max(best, std::min(Ws, x0 + L + R) - std::max(0, x0 - R));
  return best;
}

Plan make_plan(int B, int H, int W, int C, int md, int s) {
  Plan p = {};  // the fma route: all zeros
  const int R = md / s, D = 2 * R + 1;
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s;
  if (C % 8 != 0 || needed_cols(Ws, 1, R) > 8 * NT_MAX) return p;
  const int xt = (Ws + 23) / 24;
  int L = (Ws + xt - 1) / xt;
  while (needed_cols(Ws, L, R) > 8 * NT_MAX) --L;
  const int TY = std::min(std::max(1, MROWS / L), Hs);
  const int NQ = needed_cols(Ws, L, R);
  int TZ = std::max(1, std::min(8 * NT_MAX / NQ, TY + 2 * R));
  while (TZ > 1 && (long long)MROWS * TZ * D * 4 > SMEM_MAX) --TZ;
  if ((long long)MROWS * TZ * D * 4 > SMEM_MAX) return p;
  const int NT = 2 * ((TZ * NQ + 15) / 16);  // even: two halves of Q
  const long long grid = (long long)B * s * s * ((Hs + TY - 1) / TY) *
                         ((Ws + L - 1) / L) * ((TY + 2 * R + TZ - 1) / TZ);
  if (grid > INT_MAX) return p;
  const int stages = grid <= SMALL_GRID ? 4 : 3;
  const int ring = stages * (MROWS + 8 * NT) * LDW * 4;
  const int staging = MROWS * TZ * D * 4;
  p = {{1, TY, L, TZ, NQ, NT, stages, (int)grid, std::max(ring, staging)}};
  return p;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared through L1; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// big = tf32(x) rounded to nearest, ties away from zero (cvt.rna.tf32.f32's
// rounding) by integer arithmetic on the bits; small = x - big, exact in
// float32, which the tensor core reads as tf32 by dropping its low 13 bits
// (CUTLASS's 3xTF32 split): three full-rate operations an element
__device__ __forceinline__ void split(uint32_t w, uint32_t& big,
                                      uint32_t& small) {
  big = (w + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(w) - __uint_as_float(big));
}

// d (16 x 8 float32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d (16 x 8 float32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct TcArgs {
  const void* f1;
  const void* f2;
  float* out;
  int H, W, C, s, R;
  int TY, L, TZ, NQ;  // the plan's tile
  int NTY, NTX, NZ;   // tiles of P along y and x, f2 row runs per P tile
  float inv_c;
};

// One block: (b, ry, rx, P tile (ty, tx), f2 row run iz), iz fastest so
// that the blocks of one P tile run side by side and share its rows in L2.
// T: float (split tf32, three products) or bf16_raw (one product).
template <typename T, int NH, int STAGES>
__global__ void __launch_bounds__(TC_THREADS)
tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int NT = 2 * NH;                      // n8 tiles of Q
  constexpr int NP = 8 * NT;                      // Q rows a stage
  constexpr int STAGE_WORDS = (MROWS + NP) * LDW;
  constexpr bool F32 = sizeof(T) == 4;
  const int s = a.s, R = a.R, D = 2 * R + 1, DD = D * D;
  const int TY = a.TY, L = a.L, TZ = a.TZ, NQ = a.NQ;
  const int M = TY * L, N = TZ * NQ;
  int id = blockIdx.x;
  const int iz = id % a.NZ;
  id /= a.NZ;
  const int tx = id % a.NTX;
  id /= a.NTX;
  const int ty = id % a.NTY;
  id /= a.NTY;
  const int rx = id % s;
  id /= s;
  const int ry = id % s;
  const int b = id / s;
  const int Hs = (a.H - ry + s - 1) / s, Ws = (a.W - rx + s - 1) / s;
  const int y0 = ty * TY, x0 = tx * L;
  if (y0 >= Hs || x0 >= Ws) return;  // no pixel of P in the sub-grid
  const int z0 = y0 - R + iz * TZ;   // first f2 row of the run
  const int qx0 = max(0, x0 - R);    // first f2 column of Q
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // warp w: m16 tile w % 4 of P, n8 tiles [j0, j0 + NH) of Q
  const int mt = warp % 4, j0 = (warp / 4) * NH;
  const int Cw = a.C * (int)sizeof(T) / 4;  // 32-bit words a pixel
  // image pixel index of sub-grid pixel (ys, xs)
  auto pixel = [&](int ys, int xs) {
    return ((size_t)b * a.H + (size_t)(s * ys + ry)) * a.W + s * xs + rx;
  };
  const bool work = z0 + TZ > 0 && z0 < Hs;  // some f2 row in the image

  float acc[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  if (work) {
    // thread tid copies the 16-byte piece q of rows r0, r0 + RSTEP, ... of
    // each stage; rows of no pixel in the image (padding, f2 rows outside)
    // are filled with zeros
    constexpr int RSTEP = TC_THREADS / 8;
    const int q = tid % 8, r0 = tid / 8;
    const char* asrc[MROWS / RSTEP];
#pragma unroll
    for (int i = 0; i < MROWS / RSTEP; ++i) {
      const int m = r0 + RSTEP * i, ys = y0 + m / L, xs = x0 + m % L;
      asrc[i] = (m < M && ys < Hs && xs < Ws)
                    ? (const char*)a.f1 + pixel(ys, xs) * Cw * 4
                    : nullptr;
    }
    const char* bsrc[(NP + RSTEP - 1) / RSTEP];
#pragma unroll
    for (int i = 0; i < (NP + RSTEP - 1) / RSTEP; ++i) {
      const int n = r0 + RSTEP * i, zs = z0 + n / NQ, xq = qx0 + n % NQ;
      bsrc[i] = (n < N && zs >= 0 && zs < Hs && xq < Ws)
                    ? (const char*)a.f2 + pixel(zs, xq) * Cw * 4
                    : nullptr;
    }
    auto load = [&](int kc, int slot) {
      uint32_t* As = sm + slot * STAGE_WORDS;
      uint32_t* Bs = As + MROWS * LDW;
      const int w = kc * KW + 4 * q;
      const int off = w < Cw ? w * 4 : 0;
#pragma unroll
      for (int i = 0; i < MROWS / RSTEP; ++i) {
        const bool ok = asrc[i] != nullptr && w < Cw;
        cp_async16(smem_addr(As + (r0 + RSTEP * i) * LDW + 4 * q),
                   ok ? asrc[i] + off : (const char*)a.f1, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < (NP + RSTEP - 1) / RSTEP; ++i) {
        if (r0 + RSTEP * i >= NP) break;
        const bool ok = bsrc[i] != nullptr && w < Cw;
        cp_async16(smem_addr(Bs + (r0 + RSTEP * i) * LDW + 4 * q),
                   ok ? bsrc[i] + off : (const char*)a.f2, ok ? 16 : 0);
      }
    };
    const int nk = (Cw + KW - 1) / KW;
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st, st);
      cp_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // stage kc landed; stage kc - 1 is read by all
      if (kc + STAGES - 1 < nk) load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
      cp_commit();
      if (mt * 16 < M) {  // the same for the whole warp
        const uint32_t* As =
            sm + (kc % STAGES) * STAGE_WORDS + (mt * 16 + g) * LDW + t;
        const uint32_t* Bs = sm + (kc % STAGES) * STAGE_WORDS +
                             MROWS * LDW + (j0 * 8 + g) * LDW + t;
#pragma unroll
        for (int kk = 0; kk < KW; kk += 8) {
          // all fragments first, then the products tile by tile in
          // passes, so that consecutive products use other accumulators
          const uint32_t fa[4] = {As[kk], As[8 * LDW + kk], As[kk + 4],
                                  As[8 * LDW + kk + 4]};
          uint32_t fb[NH][2];
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            fb[j][0] = Bs[j * 8 * LDW + kk];
            fb[j][1] = Bs[j * 8 * LDW + kk + 4];
          }
          if constexpr (F32) {
            uint32_t ab[4], as[4], bb[NH][2], bs[NH][2];
#pragma unroll
            for (int e = 0; e < 4; ++e) split(fa[e], ab[e], as[e]);
#pragma unroll
            for (int j = 0; j < NH; ++j) {
              split(fb[j][0], bb[j][0], bs[j][0]);
              split(fb[j][1], bb[j][1], bs[j][1]);
            }
            // small terms first: small.big, big.small, then big.big
#pragma unroll
            for (int j = 0; j < NH; ++j) mma_tf32(acc[j], as, bb[j]);
#pragma unroll
            for (int j = 0; j < NH; ++j) mma_tf32(acc[j], ab, bs[j]);
#pragma unroll
            for (int j = 0; j < NH; ++j) mma_tf32(acc[j], ab, bb[j]);
          } else {
#pragma unroll
            for (int j = 0; j < NH; ++j) mma_bf16(acc[j], fa, fb[j]);
          }
        }
      }
    }
    cp_wait<0>();
  }
  __syncthreads();  // the ring is read: it becomes the staging image

  // staging: per P pixel m, TZ rows of D floats (dy_i = z0 + iz - ys + R)
  float* stg = reinterpret_cast<float*>(sm);
  const int SROW = TZ * D;
  for (int i = tid; i < MROWS * SROW; i += TC_THREADS) stg[i] = 0.0f;
  __syncthreads();
  if (work && mt * 16 < M) {
    // this lane's two P pixels (rows g, g + 8 of the warp's m16 tile) and
    // its Q columns n = 8 (j0 + j) + 2 t + e1 as (row iz, column jx),
    // stepped by 8
    int ms[2], xs[2];
    bool mok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ms[h] = mt * 16 + g + 8 * h;
      const int ys = y0 + ms[h] / L;
      xs[h] = x0 + ms[h] % L;
      mok[h] = ms[h] < M && ys < Hs && xs[h] < Ws;
    }
    int iz[2], jx[2];
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      iz[e1] = (8 * j0 + 2 * t + e1) / NQ;
      jx[e1] = (8 * j0 + 2 * t + e1) % NQ;
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int zs = z0 + iz[e1], xq = qx0 + jx[e1];
        const bool nok = iz[e1] < TZ && zs >= 0 && zs < Hs && xq < Ws;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dxi = xq - xs[h] + R;
          if (nok && mok[h] && dxi >= 0 && dxi < D)
            stg[ms[h] * SROW + iz[e1] * D + dxi] = acc[j][2 * h + e1] * a.inv_c;
        }
        jx[e1] += 8;
        while (jx[e1] >= NQ) {
          jx[e1] -= NQ;
          ++iz[e1];
        }
      }
    }
  }
  __syncthreads();
  // each P pixel's run of owned dy rows, TZ * D floats at most, contiguous
  // in the output: one warp a pixel
  for (int m = warp; m < M; m += TC_THREADS / 32) {
    const int ys = y0 + m / L, xs = x0 + m % L;
    if (ys >= Hs || xs >= Ws) continue;
    const int dy0 = z0 - ys + R;  // dy_i of the run's first row
    const int lo = max(0, -dy0), hi = min(TZ, D - dy0);
    if (lo >= hi) continue;
    float* o = a.out + pixel(ys, xs) * DD + (size_t)(dy0 + lo) * D;
    const float* src = stg + m * SROW + lo * D;
    for (int i = lane; i < (hi - lo) * D; i += 32) o[i] = src[i];
  }
}

template <typename T, int NH, int STAGES>
int launch_tc(const TcArgs& a, const Plan& p, cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<tc_kernel<T, NH, STAGES>>(&limit);
  if (rc != 0) return rc;
  if (p.v[8] > limit) return ERR_PLAN;
  tc_kernel<T, NH, STAGES><<<p.v[7], TC_THREADS, p.v[8], stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int STAGES>
int run_tc(const TcArgs& a, const Plan& p, cudaStream_t st) {
  switch (p.v[5] / 2) {
    case 1: return launch_tc<T, 1, STAGES>(a, p, st);
    case 2: return launch_tc<T, 2, STAGES>(a, p, st);
    case 3: return launch_tc<T, 3, STAGES>(a, p, st);
    case 4: return launch_tc<T, 4, STAGES>(a, p, st);
    case 5: return launch_tc<T, 5, STAGES>(a, p, st);
    case 6: return launch_tc<T, 6, STAGES>(a, p, st);
  }
  return ERR_PLAN;
}


// ------------------------------------------------------ backward, fma route
constexpr int BW_THREADS = 256;
constexpr int BTY = 8, BTX = 8;  // a block's tile of sub-grid pixels
constexpr int BCC = 64;          // ... and of channels
static_assert(BTY * (BTX / 4) * (BCC / 4) == BW_THREADS, "one thread a "
              "tile row, 4 pixels and 4 channels");

__device__ __forceinline__ void store1(float v, float* p) { *p = v; }
__device__ __forceinline__ void store1(float v, bf16_raw* p) {
  p->bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

struct BwdArgs {
  const float* g;  // (B, H, W, D * D)
  const void* f1;
  const void* f2;
  void* gf1;  // (B, H, W, C) or null
  void* gf2;
  int H, W, C, s, R;
  int NTY, NTX, NCC;  // tiles along sub-grid rows and columns, channels
  int blocks1;        // blocks of grad_f1 (0 when it is not wanted)
  float inv_c;
};

// One block: (b, ry, rx, tile (ty, tx), channel chunk cc) of grad_f1 (the
// first blocks1 blocks) or grad_f2 (the rest).
template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
corr_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float bsm[];
  const int s = a.s, R = a.R, D = 2 * R + 1, DD = D * D, XW = BTX + 2 * R;
  float* xs = bsm;             // operand row z: XW pixels x BCC channels
  float* gz = bsm + XW * BCC;  // weights [tile row][dx_i][tile column]
  int id = blockIdx.x;
  const bool second = id >= a.blocks1;
  if (second) id -= a.blocks1;
  const int cc = id % a.NCC;
  id /= a.NCC;
  const int tx = id % a.NTX;
  id /= a.NTX;
  const int ty = id % a.NTY;
  id /= a.NTY;
  const int rx = id % s;
  id /= s;
  const int ry = id % s;
  const int b = id / s;
  const int Hs = (a.H - ry + s - 1) / s, Ws = (a.W - rx + s - 1) / s;
  const int y0 = ty * BTY, x0 = tx * BTX, c0 = cc * BCC;
  if (y0 >= Hs || x0 >= Ws) return;
  const T* X = (const T*)(second ? a.f1 : a.f2);
  T* out = (T*)(second ? a.gf2 : a.gf1);
  auto pixel = [&](int ys, int xsub) {
    return ((size_t)b * a.H + (size_t)(s * ys + ry)) * a.W + s * xsub + rx;
  };
  const int tid = threadIdx.x, cq = tid % 16, xq = (tid / 16) % 2,
            r = tid / 32;
  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.0f;

  const int zlo = max(0, y0 - R), zhi = min(Hs, y0 + BTY + R);
  for (int z = zlo; z < zhi; ++z) {
    __syncthreads();  // the previous row's products have read xs and gz
    for (int idx = tid; idx < XW * BCC; idx += BW_THREADS) {
      const int col = idx / BCC, c = idx - col * BCC, xsub = x0 - R + col;
      xs[idx] = xsub >= 0 && xsub < Ws && c0 + c < a.C
                    ? load1(X + pixel(z, xsub) * a.C + c0 + c)
                    : 0.0f;
    }
    // the weights of displacement row i = z - ys + R of tile row r2;
    // dx_i fastest, so that grad_f1's reads run along a pixel's g
    for (int idx = tid; idx < BTY * BTX * D; idx += BW_THREADS) {
      const int j = idx % D, x = (idx / D) % BTX, r2 = idx / (D * BTX);
      const int ys = y0 + r2, xsub = x0 + x, i = z - ys + R;
      float v = 0.0f;
      if (ys < Hs && xsub < Ws && i >= 0 && i < D) {
        if (!second) {
          v = a.g[pixel(ys, xsub) * DD + i * D + j];
        } else {  // from the source pixel (z, xsub + j - R), mirrored
          const int xsrc = xsub + j - R;
          if (xsrc >= 0 && xsrc < Ws)
            v = a.g[pixel(z, xsrc) * DD + (2 * R - i) * D + (2 * R - j)];
        }
      }
      gz[(r2 * D + j) * BTX + x] = v;
    }
    __syncthreads();
    const int i = z - (y0 + r) + R;
    if (i < 0 || i >= D) continue;  // no displacement row of this tile row
    // pixel k of the thread reads operand column 4 xq + k + j at dx_i j
    const float* xr = xs + 4 * xq * BCC + 4 * cq;
    const float* gr = gz + r * D * BTX + 4 * xq;
    float4 w0 = *reinterpret_cast<const float4*>(xr);
    float4 w1 = *reinterpret_cast<const float4*>(xr + BCC);
    float4 w2 = *reinterpret_cast<const float4*>(xr + 2 * BCC);
    for (int j = 0; j < D; ++j) {
      const float4 w3 = *reinterpret_cast<const float4*>(xr + (j + 3) * BCC);
      const float4 gv = *reinterpret_cast<const float4*>(gr + j * BTX);
      const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
      const float4 wk[4] = {w0, w1, w2, w3};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k][0] = fmaf(gk[k], wk[k].x, acc[k][0]);
        acc[k][1] = fmaf(gk[k], wk[k].y, acc[k][1]);
        acc[k][2] = fmaf(gk[k], wk[k].z, acc[k][2]);
        acc[k][3] = fmaf(gk[k], wk[k].w, acc[k][3]);
      }
      w0 = w1;
      w1 = w2;
      w2 = w3;
    }
  }
  const int ys = y0 + r;
  if (ys >= Hs) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xsub = x0 + 4 * xq + k;
    if (xsub >= Ws) break;
    T* o = out + pixel(ys, xsub) * a.C + c0 + 4 * cq;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + 4 * cq + e < a.C) store1(acc[k][e] * a.inv_c, o + e);
  }
}

template <typename T>
int run_bwd_fma(const BwdArgs& a, int blocks, cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<corr_bwd_kernel<T>>(&limit);
  if (rc != 0) return rc;
  const int D = 2 * a.R + 1;
  // a staged row: XW pixels (the last tile column reads its last one at
  // dx_i = D - 1); the weights of the tile's rows for one dy row
  const size_t bytes = ((size_t)(BTX + 2 * a.R) * BCC + BTY * D * BTX) * 4;
  if (bytes > (size_t)limit) return -1;
  corr_bwd_kernel<T><<<blocks, BW_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- backward, tc route
constexpr int BT_THREADS = 512;  // 16 warps: an m16 tile of P, a quarter of CC
constexpr int BMROWS = 64;       // output pixels of a block (P, padded)
constexpr int BKC = 32;          // operand pixels (K) a chunk
constexpr int BTC_CC = 128;      // channels of a block
constexpr int BSTAGES = 3;       // cp.async ring of operand chunks
// an operand row: BTC_CC values and 8 of padding (float32: 72 words, 8 mod
// 32, so that the tf32 B fragments' loads hit 32 banks; bfloat16: 144
// bytes, 16 mod 128, so that ldmatrix's eight rows hit 32 banks)
constexpr int BLDX = BTC_CC + 8;
// the weights: grad_f1's as [m][k] (rows of BKC + 4 words, or BKC + 8
// bfloat16), grad_f2's as [k][m] (rows of BMROWS + 8), so that both are
// built with consecutive lanes on consecutive g values and read as
// fragments without bank conflicts
constexpr int GLD1 = BKC + 4, GLD2 = BMROWS + 8;
constexpr int GLH1 = BKC + 8, GLH2 = BMROWS + 8;
constexpr int BWD_TERMS = 3;  // bfloat16 terms of g: float32's 24 bits
// bf16 outputs within this many float32 steps of a rounding midpoint, in
// the top binade, are summed again in the plain version's order (the
// largest gap between the two float32 sums seen at such an output: 7
// steps), BF16_PRODS products a lane at a time
constexpr int BF16_NEAR = 64, BF16_PRODS = 16;
constexpr int BWD_PLAN_INTS = 7;
static_assert(BMROWS * GLD1 == BKC * GLD2, "one weights buffer, two layouts");

// corr_bwd_plan's ints: route (0 fma, 1 tc), TY, L, CC, stages, blocks of
// one gradient, shared bytes; ops/correlation.py::corr_bwd_plan computes
// the same, step for step
struct BwdPlan {
  int v[BWD_PLAN_INTS];
};

// shared words of one weights buffer: float32, or the bfloat16 terms
template <bool F32>
__host__ __device__ constexpr int bwd_gwords() {
  return F32 ? BMROWS * GLD1
             : BWD_TERMS * ((BMROWS * GLH1 > BKC * GLH2 ? BMROWS * GLH1
                                                        : BKC * GLH2) / 2);
}

// weights buffers: float32 a ring of BSTAGES (cp.async), bfloat16 two
constexpr int bwd_gbufs(bool f32) { return f32 ? BSTAGES : 2; }

BwdPlan make_bwd_plan(int B, int H, int W, int C, int md, int s, int dtype) {
  BwdPlan p = {};  // the fma route: all zeros
  if (C % 8 != 0) return p;
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s;
  const int xt = (Ws + 23) / 24;
  const int L = (Ws + xt - 1) / xt;
  const int TY = std::min(std::max(1, BMROWS / L), Hs);
  const long long grid = (long long)B * s * s * ((Hs + TY - 1) / TY) *
                         ((Ws + L - 1) / L) * ((C + BTC_CC - 1) / BTC_CC);
  if (2 * grid > INT_MAX) return p;
  const int esize = dtype == 0 ? 4 : 2;
  const int gwords = dtype == 0 ? bwd_gwords<true>() : bwd_gwords<false>();
  const int shared =
      BSTAGES * BKC * BLDX * esize + bwd_gbufs(dtype == 0) * gwords * 4;
  (void)md;
  p = {{1, TY, L, BTC_CC, BSTAGES, (int)grid, shared}};
  return p;
}

// d (16 x 8 float32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col):
// mma_bf16 above. ldmatrix: four 8 x 8 b16 matrices, lane l giving the
// address of row l % 8 of matrix l / 8; .trans hands each lane the
// transposed elements
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

struct BwdTcArgs {
  const float* g;  // (B, H, W, D * D)
  const void* f1;
  const void* f2;
  void* gf1;  // (B, H, W, C) or null
  void* gf2;
  int H, W, C, s, R;
  int TY, L;          // the plan's tile of output pixels
  int NTY, NTX, NCC;  // tiles along sub-grid rows and columns, channels
  int blocks1;        // blocks of grad_f1 (0 when it is not wanted)
  float inv_c;
};

// The plain version's sum for one output of the backward's bf16 route
// (output pixel (ys, xs) of a sub-grid, channel c), by the whole warp: one
// float32 product a displacement (the lanes fetch and multiply
// 32 BF16_PRODS at a time), summed one at a time in the plain version's
// order (dy-major) with float32 adds, the sources outside the image skipped
// (their terms are zeros), times 1/C. gpix: grad_f1's own pixel (its g
// row), -1 for grad_f2 (the source pixel's g row).
__device__ __noinline__ float plain_sum(const float* g, const bf16_raw* X,
                                        int gpix, int pix0, int PZ, int PX,
                                        int ys, int xs, int c, int C, int Hs,
                                        int Ws, int R, bool second,
                                        float inv_c) {
  const int lane = threadIdx.x % 32, D = 2 * R + 1, DD = D * D;
  float sum = 0.0f;
  for (int d0 = 0; d0 < DD; d0 += 32 * BF16_PRODS) {
    float pr[BF16_PRODS];
#pragma unroll
    for (int i = 0; i < BF16_PRODS; ++i) {
      const int d = d0 + 32 * i + lane, di = d / D, dj = d % D;
      const int zs = second ? ys - di + R : ys + di - R;
      const int xq = second ? xs - dj + R : xs + dj - R;
      pr[i] = 0.0f;
      if (d < DD && zs >= 0 && zs < Hs && xq >= 0 && xq < Ws) {
        const int src = pix0 + zs * PZ + xq * PX;
        pr[i] = __fmul_rn(g[(size_t)(second ? src : gpix) * DD + d],
                          load1(X + (size_t)src * C + c));
      }
    }
#pragma unroll
    for (int i = 0; i < BF16_PRODS; ++i)
#pragma unroll 4
      for (int l = 0; l < 32; ++l)
        sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, pr[i], l));
  }
  return __fmul_rn(sum, inv_c);
}
// (row, column) of operand pixel k of a tile's Q walk, advanced by a fixed
// step (adv: step / ncols rows and step % ncols columns) in constant time
struct QPos {
  int z, x;
  __device__ __forceinline__ void advance(int2 adv, int ncols) {
    x += adv.y;
    z += adv.x;
    if (x >= ncols) {
      x -= ncols;
      ++z;
    }
  }
};

// One block: (b, ry, rx, P tile (ty, tx), channel chunk cc) of grad_f1 (the
// first blocks1 blocks) or grad_f2 (the rest), cc fastest, so that the
// blocks of one tile run side by side and share its rows of g and of the
// operand in L2. T: float (3xTF32) or bf16_raw (g in three bf16 terms).
template <typename T>
__global__ void __launch_bounds__(BT_THREADS, 1)
corr_bwd_tc_kernel(const BwdTcArgs a) {
  extern __shared__ __align__(16) uint32_t tsm[];
  __shared__ int4 mdesc[BMROWS];  // grad_f1: (ys, xs, g offset base, valid)
  __shared__ unsigned bmax[BT_THREADS / 32];  // bf16: the warps' largest
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int XWORDS = BKC * BLDX * (int)sizeof(T) / 4;  // a ring stage
  constexpr int GWORDS = bwd_gwords<F32>();                // a weights buffer
  constexpr int GTERM = GWORDS / BWD_TERMS;  // bfloat16: words of a term
  constexpr int NGRP = BT_THREADS / 128;     // channel groups (warps / 4)
  constexpr int CPG = BTC_CC / NGRP;         // channels of a group
  constexpr int NH = CPG / 8;                // n8 tiles of a warp
  constexpr int PIECES = BKC * BTC_CC * (int)sizeof(T) / 16;
  constexpr int PPR = BTC_CC * (int)sizeof(T) / 16;  // 16-byte pieces a row
  constexpr int EPC = 16 / (int)sizeof(T);           // channels a piece
  constexpr int NPC = (PIECES + BT_THREADS - 1) / BT_THREADS;  // a thread's
  constexpr int NE = BMROWS * BKC / BT_THREADS;  // weights a thread a chunk
  constexpr int MSTEP = BT_THREADS / BKC;     // grad_f1: m step of entries
  constexpr int ESTEP = BT_THREADS / BMROWS;  // grad_f2: k step of entries
  uint32_t* xring = tsm;
  uint32_t* gbuf = tsm + BSTAGES * XWORDS;

  int id = blockIdx.x;
  const bool second = id >= a.blocks1;
  if (second) id -= a.blocks1;
  const int cc = id % a.NCC;
  id /= a.NCC;
  const int tx = id % a.NTX;
  id /= a.NTX;
  const int ty = id % a.NTY;
  id /= a.NTY;
  const int s = a.s;
  const int rx = id % s;
  id /= s;
  const int ry = id % s;
  const int b = id / s;
  const int R = a.R, D = 2 * R + 1, DD = D * D, L = a.L;
  const int Hs = (a.H - ry + s - 1) / s, Ws = (a.W - rx + s - 1) / s;
  const int y0 = ty * a.TY, x0 = tx * L, c0 = cc * BTC_CC;
  if (y0 >= Hs || x0 >= Ws) return;  // no pixel of P in the sub-grid
  const int M = a.TY * L;
  const T* X = (const T*)(second ? a.f1 : a.f2);
  T* out = (T*)(second ? a.gf2 : a.gf1);
  // image pixel of sub-grid pixel (ys, xs): pix0 + ys * PZ + xs * PX
  const int pix0 = (b * a.H + ry) * a.W + rx, PZ = s * a.W, PX = s;
  // the operand pixels (K): rows [zlo, zhi) and columns [qx0, qx0 + ncols)
  // of the sub-grid, the in-image pixels that the tile's windows reach, row
  // by row, in chunks of BKC
  const int zlo = max(0, y0 - R), zhi = min(Hs, y0 + a.TY + R);
  const int qx0 = max(0, x0 - R), ncols = min(Ws, x0 + L + R) - qx0;
  const int K = (zhi - zlo) * ncols;
  const int nk = (K + BKC - 1) / BKC;
  const int2 chunk_adv = make_int2(BKC / ncols, BKC % ncols);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int mt = warp % 4, nh = warp / 4;  // m16 tile, channel group

  // operand chunk kc -> ring slot: thread tid copies pieces tid +
  // BT_THREADS i, rows (tid + BT_THREADS i) / PPR at chunk 0, each walked
  // chunk by chunk
  QPos xpos[NPC];
#pragma unroll
  for (int i = 0; i < NPC; ++i) {
    const int r = (tid + BT_THREADS * i) / PPR;
    xpos[i] = {r / ncols, r % ncols};
  }
  const int xcol = (tid % PPR) * EPC;  // the pieces' first channel
  auto stage_x = [&](int kc, int slot) {
    uint32_t* dst = xring + slot * XWORDS;
#pragma unroll
    for (int i = 0; i < NPC; ++i) {
      const int piece = tid + BT_THREADS * i;
      if (piece < PIECES) {
        const int r = piece / PPR, k = kc * BKC + r, c = c0 + xcol;
        const bool ok = k < K && c < a.C;
        const T* src = X;
        if (ok)
          src = X + (size_t)(pix0 + (zlo + xpos[i].z) * PZ +
                             (qx0 + xpos[i].x) * PX) * a.C + c;
        cp_async16(smem_addr(dst + r * (BLDX * (int)sizeof(T) / 4) +
                             4 * (tid % PPR)),
                   src, ok ? 16 : 0);
      }
      xpos[i].advance(chunk_adv, ncols);
    }
  };

  // the weights of chunk kc: entry e = tid + BT_THREADS i of the BMROWS x BKC
  // matrix. grad_f1, k-fastest (k = lane: consecutive lanes read a pixel's
  // g row along dx_i): g[pixel m, (zs - ys + R) D + xq - xs + R], the
  // offset mdesc[m].z + zs D + xq. grad_f2, m-fastest (m = tid % 64:
  // consecutive lanes, consecutive output pixels, read one source pixel's
  // g row along dx_i): g[pixel (zs, xq), (ys - zs + R) D + xs - xq + R], the
  // offset pix(zs, xq) DD - zs D - xq + (ys + R) D + xs + R.
  if (!second && tid < BMROWS) {
    const int ys = y0 + tid / L, xs = x0 + tid % L;
    const bool ok = tid < M && ys < Hs && xs < Ws;
    mdesc[tid] = make_int4(ys, xs,
                           ok ? (pix0 + ys * PZ + xs * PX) * DD +
                                    (R - ys) * D + R - xs
                              : 0,
                           ok ? 1 : 0);
  }
  __syncthreads();
  const int my_m = tid % BMROWS;
  const int mys = y0 + my_m / L, mxs = x0 + my_m % L;
  const bool mok = my_m < M && mys < Hs && mxs < Ws;
  const int mbase = mok ? (mys + R) * D + mxs + R : 0;
  // grad_f2: the offset part of source pixel (zlo + z, qx0 + x), linear in
  // z and x, walked along with its position
  const int AZ = PZ * DD - D, AX = PX * DD - 1;
  const int A0 = pix0 * DD + zlo * AZ + qx0 * AX;
  QPos gpos = second ? QPos{(tid / BMROWS) / ncols, (tid / BMROWS) % ncols}
                     : QPos{lane / ncols, lane % ncols};
  const int2 entry_adv = make_int2(ESTEP / ncols, ESTEP % ncols);
  // calls f(i, ok, offset) for this thread's NE entries of chunk kc (in
  // chunk order, once each): ok where the weight is g[offset], else 0
  auto visit_g = [&](int kc, auto f) {
    if (!second) {
      const int k = kc * BKC + lane;
      const int zs = zlo + gpos.z, xq = qx0 + gpos.x;
      const int kz = zs * D + xq;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int4 md = mdesc[tid / BKC + MSTEP * i];
        f(i, md.w && k < K && (unsigned)(zs - md.x + R) < (unsigned)D &&
                 (unsigned)(xq - md.y + R) < (unsigned)D,
          md.z + kz);
      }
    } else {
      int k = kc * BKC + tid / BMROWS;
      QPos q = gpos;
      int off = A0 + q.z * AZ + q.x * AX + mbase;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        f(i, mok && k < K && (unsigned)(mys - zlo - q.z + R) < (unsigned)D &&
                 (unsigned)(mxs - qx0 - q.x + R) < (unsigned)D,
          off);
        k += ESTEP;
        off += entry_adv.x * AZ + entry_adv.y * AX;
        q.x += entry_adv.y;
        q.z += entry_adv.x;
        if (q.x >= ncols) {
          q.x -= ncols;
          ++q.z;
          off += AZ - ncols * AX;
        }
      }
    }
    gpos.advance(chunk_adv, ncols);
  };
  // where entry i of this thread lies in a weights buffer (words, or
  // bfloat16 values of a term)
  auto g_at = [&](int i) {
    const int m = second ? my_m : tid / BKC + MSTEP * i;
    const int k = second ? tid / BMROWS + ESTEP * i : lane;
    return F32 ? (second ? k * GLD2 + m : m * GLD1 + k)
               : (second ? k * GLH2 + m : m * GLH1 + k);
  };
  // float32: the weights go by 4-byte cp.async (zeros where not ok) into a
  // ring slot beside the operand chunk's
  auto stage_g = [&](int kc, int slot) {
    const uint32_t* gb = gbuf + slot * GWORDS;
    visit_g(kc, [&](int i, bool ok, int off) {
      cp_async4(smem_addr(gb + g_at(i)), ok ? a.g + off : a.g, ok ? 4 : 0);
    });
  };
  // bfloat16: loaded into registers before a chunk's products, split into
  // the bf16 terms and stored into the other of two buffers after them
  float wv[NE];
  auto load_g = [&](int kc) {
    visit_g(kc, [&](int i, bool ok, int off) {
      wv[i] = ok ? a.g[off] : 0.0f;
    });
  };
  auto store_g = [&](int buf) {
    unsigned short* term = reinterpret_cast<unsigned short*>(gbuf +
                                                             buf * GWORDS);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      // w = hi + mid + lo, each the rounded rest: float32 exactly
      float rest = wv[i];
#pragma unroll
      for (int t = 0; t < BWD_TERMS; ++t) {
        const __nv_bfloat16 h = __float2bfloat16_rn(rest);
        term[2 * GTERM * t + g_at(i)] = __bfloat16_as_ushort(h);
        rest -= __bfloat162float(h);
      }
    }
  };

  float acc[NH][4], tot[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[j][e] = 0.0f;

  // A = the weights (m16 tile mt), B = the operand rows (NH n8 tiles from
  // channel nh * CPG)
  auto mma_chunk = [&](int slot, int buf) {
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    const uint32_t* gb = gbuf + buf * GWORDS;
    const uint32_t* xs = xring + slot * XWORDS;
    const int n0 = nh * CPG;
    if constexpr (F32) {
      // A(m, k) at m * sm + k * sk
      const int sm = second ? 1 : GLD1, sk = second ? GLD2 : 1;
      const uint32_t* Ap = gb + (mt * 16 + g8) * sm + t4 * sk;
      const uint32_t* Bp = xs + t4 * BLDX + n0 + g8;
#pragma unroll
      for (int kk = 0; kk < BKC; kk += 8) {
        const uint32_t fa[4] = {Ap[kk * sk], Ap[8 * sm + kk * sk],
                                Ap[(kk + 4) * sk],
                                Ap[8 * sm + (kk + 4) * sk]};
        uint32_t fb[NH][2];
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          fb[j][0] = Bp[kk * BLDX + 8 * j];
          fb[j][1] = Bp[(kk + 4) * BLDX + 8 * j];
        }
        uint32_t ab[4], as[4], bb[NH][2], bs[NH][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(fa[e], ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          split(fb[j][0], bb[j][0], bs[j][0]);
          split(fb[j][1], bb[j][1], bs[j][1]);
        }
        // small terms first: small.big, big.small, then big.big
#pragma unroll
        for (int j = 0; j < NH; ++j) mma_tf32(acc[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < NH; ++j) mma_tf32(acc[j], ab, bs[j]);
#pragma unroll
        for (int j = 0; j < NH; ++j) mma_tf32(acc[j], ab, bb[j]);
      }
    } else {
      const unsigned tb = smem_addr(gb);
      const int mi = lane / 8, r8 = lane % 8;
      // A by ldmatrix: grad_f1's [m][k] rows as they are, grad_f2's [k][m]
      // rows transposed; this lane's row address at k step kk = 0
      const unsigned aoff =
          second ? (unsigned)(((r8 + (mi >> 1) * 8) * GLH2 + mt * 16 +
                               (mi & 1) * 8) * 2)
                 : (unsigned)(((mt * 16 + r8 + (mi & 1) * 8) * GLH1 +
                               (mi >> 1) * 8) * 2);
      const unsigned astep = second ? 16 * GLH2 * 2 : 16 * 2;
      // B by ldmatrix.trans: [k][n] rows; matrices (k, n), (k + 8, n),
      // (k, n + 8), (k + 8, n + 8) give b0, b1 of two n8 tiles
      const unsigned boff =
          smem_addr(xs) +
          (unsigned)(((r8 + (mi & 1) * 8) * BLDX + n0 + (mi >> 1) * 8) * 2);
#pragma unroll
      for (int kk = 0; kk < BKC; kk += 16) {
        uint32_t fb[NH][2];
#pragma unroll
        for (int j = 0; j < NH; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, boff + (unsigned)((kk * BLDX + 8 * j) * 2));
          fb[j][0] = r[0];
          fb[j][1] = r[1];
          fb[j + 1][0] = r[2];
          fb[j + 1][1] = r[3];
        }
        // the terms of g, smallest first
#pragma unroll
        for (int t = BWD_TERMS - 1; t >= 0; --t) {
          uint32_t af[4];
          const unsigned at = tb + t * GTERM * 4 + aoff + (kk / 16) * astep;
          if (second)
            ldsm_x4_t(af, at);
          else
            ldsm_x4(af, at);
#pragma unroll
          for (int j = 0; j < NH; ++j) mma_bf16(acc[j], af, fb[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[j][e] += acc[j][e];
  };

  // the pipeline: operand chunks (and float32 weights) BSTAGES - 1 ahead
  // by cp.async; bfloat16 weights of chunk kc + 1 loaded into registers
  // before chunk kc's products and stored after them
  for (int st = 0; st < BSTAGES - 1; ++st) {
    if (st < nk) {
      stage_x(st, st);
      if constexpr (F32) stage_g(st, st);
    }
    cp_commit();
  }
  if constexpr (!F32) {
    load_g(0);
    store_g(0);
  }
  const bool busy = mt * 16 < M;  // the warp's m16 tile holds pixels
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<BSTAGES - 2>();
    __syncthreads();  // chunk kc and its weights are in; chunk kc - 1 is done
    if (kc + BSTAGES - 1 < nk) {
      stage_x(kc + BSTAGES - 1, (kc + BSTAGES - 1) % BSTAGES);
      if constexpr (F32)
        stage_g(kc + BSTAGES - 1, (kc + BSTAGES - 1) % BSTAGES);
    }
    cp_commit();
    if constexpr (F32) {
      if (busy) mma_chunk(kc % BSTAGES, kc % BSTAGES);
    } else {
      if (kc + 1 < nk) load_g(kc + 1);
      if (busy) mma_chunk(kc % BSTAGES, kc % 2);
      if (kc + 1 < nk) store_g((kc + 1) % 2);
    }
  }
  cp_wait<0>();

  // epilogue: rows g8 and g8 + 8 of the warp's m16 tile, channels
  // c0 + n0 + 8 j + 2 t4 (+1) of its n8 tiles, straight to memory
  auto valid_at = [&](int h, int j) {
    const int m = mt * 16 + g8 + 8 * h;
    return busy && m < M && y0 + m / L < Hs && x0 + m % L < Ws &&
           c0 + nh * CPG + 8 * j < a.C;
  };
  float thr = 0.0f;
  if constexpr (!F32) {
    // bfloat16 outputs: where the float32 sum lies within BF16_NEAR
    // float32 steps of a bf16 rounding midpoint, the plain version's own
    // float32 roundings (one a product and one a sum, per displacement)
    // may round it to the other neighbour. One such step of an output in
    // the binade of the gradient's largest is more than chip_smoke.py's
    // bound (2^-8 of the largest), so those outputs are summed again here
    // in the plain version's order and arithmetic. The block's largest
    // bounds that binade from below.
    unsigned top = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NH; ++j)
        if (valid_at(h, j))
#pragma unroll
          for (int e = 0; e < 2; ++e)
            top = max(top, __float_as_uint(
                               fabsf(tot[j][2 * h + e] * a.inv_c)));
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) bmax[warp] = top;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < BT_THREADS / 32; ++w) top = max(top, bmax[w]);
    thr = __uint_as_float(top & 0x7f800000u);  // 2^floor(log2 largest)
  }
  if (!busy) return;
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[j][e] *= a.inv_c;  // the outputs
  // the outputs near a midpoint (bfloat16): bit (h NH + j) 2 + e of near
  unsigned near = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + g8 + 8 * h;
    const int ys = y0 + m / L, xs = x0 + m % L;
    if (m >= M || ys >= Hs || xs >= Ws) continue;
    T* o = out + (size_t)(pix0 + ys * PZ + xs * PX) * a.C;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int c = c0 + nh * CPG + 8 * j + 2 * t4;
      if (c >= a.C) continue;  // C % 8 == 0: an n8 tile is in or out
      if constexpr (F32) {
        *reinterpret_cast<float2*>(o + c) =
            make_float2(tot[j][2 * h], tot[j][2 * h + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(tot[j][2 * h], tot[j][2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = tot[j][2 * h + e];
          const int low = (int)(__float_as_uint(v) & 0xffffu) - 0x8000;
          if (fabsf(v) >= thr && abs(low) <= BF16_NEAR)
            near |= 1u << ((h * NH + j) * 2 + e);
        }
      }
    }
  }
  if constexpr (!F32) {
    // the warp sums them again one at a time, lane by lane, and the lane
    // that stored one stores it again
    for (;;) {
      const unsigned who = __ballot_sync(0xffffffffu, near != 0u);
      if (who == 0u) break;
      const int src = __ffs(who) - 1;
      const int slot = __shfl_sync(0xffffffffu, __ffs(near) - 1, src);
      if (lane == src) near &= near - 1u;
      const int h = slot / (2 * NH), j = slot / 2 % NH, e = slot % 2;
      const int m = mt * 16 + src / 4 + 8 * h;
      const int ys = y0 + m / L, xs = x0 + m % L;
      const int c = c0 + nh * CPG + 8 * j + 2 * (src % 4) + e;
      const int pix = pix0 + ys * PZ + xs * PX;
      const float r = plain_sum(a.g, X, second ? -1 : pix, pix0, PZ, PX, ys,
                                xs, c, a.C, Hs, Ws, R, second, a.inv_c);
      if (lane == src) store1(r, out + (size_t)pix * a.C + c);
    }
  }
}

template <typename T>
int run_bwd_tc(const BwdTcArgs& a, const BwdPlan& p, int blocks,
               cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<corr_bwd_tc_kernel<T>>(&limit);
  if (rc != 0) return rc;
  if (p.v[6] > limit) return ERR_PLAN;
  corr_bwd_tc_kernel<T><<<blocks, BT_THREADS, p.v[6], stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2 (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous,
// 16-byte aligned; out (B, H, W, D * D) float32. plan: the 9 ints of
// ops/correlation.py::corr_plan for this shape. Returns cudaGetLastError(),
// ERR_PLAN (20003) for any other plan, or -1 when the fma route needs more
// shared memory than a block may have.
extern "C" int mfc_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int md, int s,
                               int dtype, const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || md < 0 || s < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, md, s);
  for (int i = 0; i < PLAN_INTS; ++i)
    if (plan == nullptr || plan[i] != p.v[i]) return ERR_PLAN;
  if (p.v[0] == 0) {
    if (dtype == 0)
      return run_fma<float>(f1, f2, (float*)out, B, H, W, C, md, s, st);
    return run_fma<bf16_raw>(f1, f2, (float*)out, B, H, W, C, md, s, st);
  }
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s, R = md / s;
  const int TY = p.v[1], L = p.v[2], TZ = p.v[3];
  const TcArgs a = {f1, f2, (float*)out, H, W, C, s, R, TY, L, TZ, p.v[4],
                    (Hs + TY - 1) / TY, (Ws + L - 1) / L,
                    (TY + 2 * R + TZ - 1) / TZ, 1.0f / (float)C};
  if (dtype == 0)
    return p.v[6] == 4 ? run_tc<float, 4>(a, p, st) : run_tc<float, 3>(a, p, st);
  return p.v[6] == 4 ? run_tc<bf16_raw, 4>(a, p, st)
                     : run_tc<bf16_raw, 3>(a, p, st);
}


// The correlation's backward: g (B, H, W, D * D) float32, contiguous; f1,
// f2 (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous,
// 16-byte aligned; gf1, gf2 (B, H, W, C) in the inputs' type, each null
// where that gradient is not wanted (both null: nothing is launched). plan:
// the 7 ints of ops/correlation.py::corr_bwd_plan for this shape. One
// launch. Returns cudaGetLastError(), ERR_PLAN (20003) for any other plan,
// or -1 when the fma route's window needs more shared memory than a block
// may have.
extern "C" int mfc_correlation_bwd(const void* g, const void* f1,
                                   const void* f2, void* gf1, void* gf2,
                                   int B, int H, int W, int C, int md, int s,
                                   int dtype, const int* plan,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || md < 0 || s < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = make_bwd_plan(B, H, W, C, md, s, dtype);
  for (int i = 0; i < BWD_PLAN_INTS; ++i)
    if (plan == nullptr || plan[i] != p.v[i]) return ERR_PLAN;
  if (gf1 == nullptr && gf2 == nullptr) return 0;
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s, R = md / s;
  const int wanted = (gf1 != nullptr) + (gf2 != nullptr);
  if (p.v[0] == 1) {
    const int TY = p.v[1], L = p.v[2];
    const BwdTcArgs a = {(const float*)g, f1, f2, gf1, gf2, H, W, C, s, R,
                         TY, L, (Hs + TY - 1) / TY, (Ws + L - 1) / L,
                         (C + BTC_CC - 1) / BTC_CC,
                         gf1 != nullptr ? p.v[5] : 0, 1.0f / (float)C};
    if (dtype == 0) return run_bwd_tc<float>(a, p, wanted * p.v[5], st);
    return run_bwd_tc<bf16_raw>(a, p, wanted * p.v[5], st);
  }
  const int NTY = (Hs + BTY - 1) / BTY, NTX = (Ws + BTX - 1) / BTX,
            NCC = (C + BCC - 1) / BCC;
  const long long per = (long long)B * s * s * NTY * NTX * NCC;
  if (per * wanted > INT_MAX) return (int)cudaErrorInvalidValue;
  const BwdArgs a = {(const float*)g, f1, f2, gf1, gf2, H, W, C, s, R,
                     NTY, NTX, NCC, gf1 != nullptr ? (int)per : 0,
                     1.0f / (float)C};
  if (dtype == 0) return run_bwd_fma<float>(a, (int)(per * wanted), st);
  return run_bwd_fma<bf16_raw>(a, (int)(per * wanted), st);
}
