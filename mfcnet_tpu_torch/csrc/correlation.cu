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

#include <algorithm>
#include <climits>
#include <cstdint>

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
