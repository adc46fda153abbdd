// Fused RAFT update iteration (Hopper, sm_90a). Plain C interface, bound with
// ctypes by mfcnet_tpu_torch/ops/raft_update.py, which holds the plain
// PyTorch version.
//
// Replaces mfcnet_tpu/ops/raft_update_pallas.py::raft_update_pallas
// (_update_kernel / _update_one_image): one RAFT update iteration after
// convc1/convf1 and without the mask head -- convc2, convf2, the 3x3 over
// their concatenation, the SepConvGRU (1x5 then 5x1, gates z/r/q) and the
// flow head -- on token-major (B*N, C) tensors, N = H8*W8.
//
// What bounds it on this card: by the count, operations (2,580,480
// multiply-adds per token: 12.4 GFLOP at the tracker's 2 x 30 x 40 tokens
// against ~10 MB of weights and activations). In practice (NVIDIA H100 80GB
// HBM3, 700 W) the step is a chain of eight dependent stages (c2 || f2 -> cv
// -> z,r -> q -> z,r -> q -> flow1 -> flow2), and two other limits come
// first. With few tokens, the chain: each stage costs a launch, a first tile
// out of L2 and an epilogue (~5 us), and a block that walks all of a tile's
// taps pulls its whole weight slab (300 KB to 1 MB) through one SM's port.
// With many tokens, the tile traffic out of L2: every staged byte is used for
// 64 to 128 multiply-adds, so that the copies, not the tensor cores, set the
// pace (~230 TFLOP/s at 38,400 tokens).
//
// Design (the bfloat16 instance; the float32 one follows below):
//   * Every convolution is the same implicit product: out[token, n] =
//     sum over taps, k of x[token shifted by (dy, dx), k] * w[tap][k, n],
//     where a shifted token outside its H8 x W8 image reads zero. A token
//     tile is a block of whole (or x-segmented) image rows, at most 128
//     tokens, so that one TMA request on a (B, H8, W8, C) view fetches a
//     tap's shifted 64-channel slice and the hardware's zero fill outside
//     the tensor is the convolution's padding: no address arithmetic, no
//     masks. The weights are K-major (taps * N, K) matrices behind 2-D maps.
//   * Both operands land in the 128-byte swizzle that wgmma reads, in a ring
//     of stages guarded by mbarrier pairs; one producer warp keeps the
//     requests in flight, two consumer warpgroups multiply 64 tokens x BN
//     columns each with wgmma.mma_async m64nBNk16, the float32 sum in
//     registers from the first tap to the epilogue (bias, ReLU / sigmoid /
//     tanh, the GRU blend, the rounding to bfloat16), which reads the
//     accumulator fragments directly.
//   * Few tokens: a cluster of up to 8 blocks shares one output tile, each
//     block sums every cluster-th pipeline step (a tap's 64-channel slice),
//     so that every SM pulls a share of the weights; the partial sums meet
//     through distributed shared memory, and the blocks split the epilogue.
//     The cluster size of each launch comes from its block count
//     (ops/raft_update.py::tile_plan, the one place where the shape picks
//     the configuration). Many tokens: no cluster, the token tiles alone
//     fill the card, two blocks to an SM.
//   * The chain: eight launches (c2 and f2 are one grid that writes one
//     buffer cf = [c2 | f2]) joined by programmatic dependent launch: the
//     next stage's blocks start early, set up their barriers, request their
//     first weight tiles and wait with griddepcontrol.wait before they touch
//     an activation. hx = [net | inp | y | flow] lives in the caller's
//     workspace across the iterations of a solve: the q epilogue leaves net'
//     in hx[:, 0:128], so [net | inp] is written by the first call only.
//   * A concatenated input is never copied: the q gate reads [r*net | inp,
//     y, flow] as two tensor maps, the second inside hx. z and r share one
//     product with columns [z | r]. The intermediates (the largest, hx, is
//     2400 x 384 x 2 B = 1.8 MB) stay in the 50 MB L2. Channels are padded
//     only to what a fragment needs (126 -> 128, 2 -> 16). The TPU kernel's
//     single program, its 128-lane padding and its VMEM-driven batch
//     chunking are not carried over.
//
// The float32 instance keeps the earlier design, because wgmma has no exact
// float32 product and this instance is what holds the arithmetic to a
// float32 tolerance: 32-token x BN-column tiles, the shifted, masked 32 x 32
// input tile and the 32 x BN weight tile through a three-stage cp.async
// pipeline (zero-filled where the mask fails), plain FMAs, the same fused
// epilogues, nine launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <new>

#include "hopper.cuh"

namespace {

using namespace mfc;

inline void* align64(void* p) {
  return (void*)(((uintptr_t)p + 63) & ~(uintptr_t)63);
}

constexpr int BM = 32;        // tokens per block
constexpr int THREADS = 128;  // four warps
constexpr int NSTAGE = 3;     // shared-memory pipeline depth
constexpr int HID = 128;      // GRU state width
constexpr int HX = 384;       // hx row: net 128 | inp 128 | y 126 | flow 2
constexpr int CF = 256;       // cf row: c2 192 | f2 64

enum Epilogue { EPI_RELU = 0, EPI_Y = 1, EPI_ZR = 2, EPI_Q = 3, EPI_DELTA = 4 };
enum TapSet { TAPS_3X3 = 0, TAPS_1X5 = 1, TAPS_5X1 = 2 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct ConvArgs {
  const float* x0; int ld0; int k0;  // first input segment: rows of ld0, k0 used
  const float* x1; int ld1; int k1;  // second segment (k1 = 0: none)
  const float* w;                    // (taps, k0 + k1, npad)
  const float* bias;             // (npad)
  int npad, tapset, ntaps;
  int M, H8, W8;                 // M = B * H8 * W8 tokens
  int epi;
  float* out; int ldo; int nreal;    // EPI_RELU, EPI_Y: out[g * ldo + n], n < nreal
  const float* flow;             // EPI_Y: (M, 2), written beside y
  float* z;                      // EPI_ZR writes, EPI_Q reads: (M, 128)
  const float* net_in;           // EPI_ZR, EPI_Q: (M, 128)
  float* rnet;                       // EPI_ZR: (M, 128) = r * net
  float* net_out;                // EPI_Q: (M, 128)
  float* hx;                         // EPI_Q: hx[g * 384 + n] = net'
  float* delta;                  // EPI_DELTA: (M, 2)
};

__device__ __forceinline__ void tap_offset(int tapset, int t, int& dy,
                                           int& dx) {
  if (tapset == TAPS_3X3) { dy = t / 3 - 1; dx = t % 3 - 1; }
  else if (tapset == TAPS_1X5) { dy = 0; dx = t - 2; }
  else { dy = t - 2; dx = 0; }
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---- tile shapes: BM tokens x BN columns x BK of K per pipeline stage
template <int BN>
struct Tile {
  static constexpr int BK = 32;  // 128 bytes of K per row
  static constexpr int VEC = 4;  // elements per 16 bytes
  static constexpr int LDA = BK + VEC, LDB = BN + VEC, LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 4;
  static_assert(STAGE_BYTES % 16 == 0 && (A_ELEMS * 4) % 16 == 0,
                "16-byte copies need 16-byte alignment");
  // the accumulator staging (one BM x LDC float tile) reuses the
  // pipeline's memory
  static constexpr int PART_BYTES = BM * LDC * 4;
};

// 16-byte asynchronous copy global -> shared; !pred writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The product of one staged tile pair, accumulated in registers, on plain
// FMAs: thread (tid / 16) owns BM / 8 rows, columns tid % 16 + 16 j
template <int BN>
struct Mma {
  using TL = Tile<BN>;
  static constexpr int TM = BM / 8, TN = BN / 16;
  float acc[TM][TN];
  int r0, c0;

  __device__ void init(int tid) {
    r0 = (tid / 16) * TM;
    c0 = tid % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  __device__ void step(const float* As, const float* Bs) {
#pragma unroll 4
    for (int k = 0; k < TL::BK; ++k) {
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * TL::LDB + c0 + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = As[(r0 + i) * TL::LDA + k];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
  __device__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Cs[(r0 + i) * TL::LDC + c0 + 16 * j] = acc[i][j];
  }
};

// One BM-token x BN-column tile of a tap convolution with its epilogue.
template <int BN>
__global__ void __launch_bounds__(THREADS) tap_conv_kernel(ConvArgs a) {
  using TL = Tile<BN>;
  constexpr int BK = TL::BK, VEC = TL::VEC;
  constexpr int KV = BK / VEC;               // = 8 vectors per A row
  constexpr int A_PER = BM * KV / THREADS;   // vectors per thread
  constexpr int NV = BN / VEC;               // vectors per B row
  constexpr int B_PER = BK * NV / THREADS;
  static_assert(BM * KV % THREADS == 0 && BK * NV % THREADS == 0,
                "tiles must split over the block");

  extern __shared__ __align__(128) unsigned char smem[];  // smem_bytes()
  auto As = [&](int s) {
    return reinterpret_cast<float*>(smem + s * TL::STAGE_BYTES);
  };
  auto Bs = [&](int s) { return As(s) + TL::A_ELEMS; };
  float* Cs = reinterpret_cast<float*>(smem);  // after the last product

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktot = a.k0 + a.k1;
  const int nkc = ktot / BK;
  const int niter = a.ntaps * nkc;
  const int npix = a.H8 * a.W8;

  // this thread's copies: A rows m0 + arow + 16 i at vector column akv (as
  // pointers into both input segments), B vectors tid + 128 i
  const int arow = tid / KV, akv = tid % KV;
  int ty_[A_PER], tx_[A_PER];
  const float* pa0[A_PER];
  const float* pa1[A_PER];
  float* sa[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int row = arow + (THREADS / KV) * i;
    const int g = m0 + row;
    if (g < a.M) {
      const int n = g % npix;
      ty_[i] = n / a.W8;
      tx_[i] = n % a.W8;
    } else {
      ty_[i] = -(1 << 20);  // fails every bounds test
      tx_[i] = 0;
    }
    pa0[i] = a.x0 + (size_t)g * a.ld0 + akv * VEC;
    pa1[i] = a.x1 + (size_t)g * a.ld1 + akv * VEC;
    sa[i] = reinterpret_cast<float*>(smem) + row * TL::LDA + akv * VEC;
  }
  const float* pb[B_PER];
  float* sb[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int v = tid + THREADS * i;
    const int brow = v / NV, bv = v % NV;
    pb[i] = a.w + (size_t)brow * a.npad + n0 + bv * VEC;
    sb[i] = reinterpret_cast<float*>(smem) + TL::A_ELEMS + brow * TL::LDB +
            bv * VEC;
  }

  // Start the copies of the next iteration (one tap, one BK chunk) into
  // stage s. Iterations are started in order, so the tap, the K offset and
  // the weight pointer advance incrementally: weight row tap*ktot + kofs is
  // BK times the iteration number.
  int itap = 0, ikofs = 0, ishift = 0;
  bool iok[A_PER];
  auto set_tap = [&]() {
    int dy, dx;
    tap_offset(a.tapset, itap, dy, dx);
    ishift = dy * a.W8 + dx;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int y = ty_[i] + dy, x = tx_[i] + dx;
      iok[i] = y >= 0 && y < a.H8 && x >= 0 && x < a.W8;
    }
  };
  set_tap();
  const size_t wstep = (size_t)BK * a.npad;
  auto start_copies = [&](int s) {
    const int sofs = s * (TL::STAGE_BYTES / 4);
    const bool seg0 = ikofs < a.k0;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const float* src =
          seg0 ? pa0[i] + (ptrdiff_t)ishift * a.ld0 + ikofs
               : pa1[i] + (ptrdiff_t)ishift * a.ld1 + (ikofs - a.k0);
      cp_async16(sa[i] + sofs, iok[i] ? src : a.x0, iok[i]);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      cp_async16(sb[i] + sofs, pb[i], true);
      pb[i] += wstep;
    }
    ikofs += BK;
    if (ikofs == ktot) {
      ikofs = 0;
      ++itap;
      set_tap();
    }
  };

  Mma<BN> mma;
  mma.init(tid);
  // NSTAGE - 1 tiles in flight ahead of the one being multiplied; a group
  // is committed every step (empty at the tail) so that the count holds
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < niter) start_copies(s);
    cp_async_commit();
  }
  for (int it = 0; it < niter; ++it) {
    cp_async_wait<NSTAGE - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();              // ... everyone's; and tile it-1 is consumed
    const int nxt = it + NSTAGE - 1;
    if (nxt < niter) start_copies(nxt % NSTAGE);
    cp_async_commit();
    mma.step(As(it % NSTAGE), Bs(it % NSTAGE));
  }
  cp_async_wait<0>();
  __syncthreads();
  mma.store(Cs);
  __syncthreads();

  // fused epilogue: consecutive threads take consecutive columns
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int g = m0 + r;
    if (g >= a.M) continue;
    const int n = n0 + c;
    float v = a.bias[n] + Cs[r * TL::LDC + c];
    switch (a.epi) {
      case EPI_RELU:
        if (n < a.nreal)
          a.out[(size_t)g * a.ldo + n] = float(fmaxf(v, 0.0f));
        break;
      case EPI_Y:  // 126 motion channels, then the flow itself
        a.out[(size_t)g * a.ldo + n] = float(
            n < a.nreal ? fmaxf(v, 0.0f) : a.flow[(size_t)g * 2 + n - a.nreal]);
        break;
      case EPI_ZR:
        if (n < HID) {
          a.z[(size_t)g * HID + n] = sigmoidf_(v);
        } else {
          const size_t o = (size_t)g * HID + n - HID;
          a.rnet[o] = float(sigmoidf_(v) * a.net_in[o]);
        }
        break;
      case EPI_Q: {
        const size_t o = (size_t)g * HID + n;
        const float z = a.z[o];
        const float h = (1.0f - z) * a.net_in[o] + z * tanhf(v);
        a.net_out[o] = h;
        a.hx[(size_t)g * HX + n] = float(h);
        break;
      }
      default:  // EPI_DELTA
        if (n < 2) a.delta[(size_t)g * 2 + n] = v;
        break;
    }
  }
}

// hx[:, 0:128] = net rounded to T, hx[:, 128:256] = inp
template <typename T>
__global__ void fill_hx_kernel(const float* __restrict__ net,
                               const T* __restrict__ inp, T* __restrict__ hx,
                               int M) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * 2 * HID) return;
  const size_t g = i / (2 * HID);
  const int c = (int)(i % (2 * HID));
  hx[g * HX + c] = c < HID ? from_f32<T>(net[g * HID + c])
                           : inp[g * HID + c - HID];
}

#define LAUNCH_CHECK()                         \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T>
int launch_fill_hx(const float* net, const T* inp, T* hx, int M,
                   cudaStream_t s) {
  const size_t n = (size_t)M * 2 * HID;
  fill_hx_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(net, inp, hx,
                                                                M);
  LAUNCH_CHECK();
  return 0;
}

// dynamic shared memory of one block: the pipeline's stages, reused for the
// partial sums
template <int BN>
constexpr int smem_bytes() {
  using TL = Tile<BN>;
  constexpr int pipe = NSTAGE * TL::STAGE_BYTES;
  constexpr int sums = TL::PART_BYTES;
  return pipe > sums ? pipe : sums;
}

template <int BN>
int launch_conv(const ConvArgs& a, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BN>();
  if constexpr (bytes > 48 * 1024) {
    // above 48 KB a kernel has to opt in, once on each device
    constexpr int MAX_DEV = 64;
    static bool allowed[MAX_DEV] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEV || !allowed[dev]) {
      err = cudaFuncSetAttribute(
          tap_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEV) allowed[dev] = true;
    }
  }
  dim3 grid((a.M + BM - 1) / BM, a.npad / BN);
  tap_conv_kernel<BN><<<grid, THREADS, bytes, s>>>(a);
  LAUNCH_CHECK();
  return 0;
}

int run_update(void* const* in, void* const* wt, void* const* sc,
               float* net_out, float* delta, int B, int H8, int W8, int fill,
               cudaStream_t s) {
  const int M = B * H8 * W8;
  if (M == 0) return 0;
  const float* c1 = (const float*)in[0];
  const float* f1 = (const float*)in[1];
  const float* inp = (const float*)in[2];
  const float* net = (const float*)in[3];
  const float* flow = (const float*)in[4];
  float* cf = (float*)sc[0];
  float* hx = (float*)sc[1];
  float* rnet = (float*)sc[2];
  float* fh = (float*)sc[3];
  float* z = (float*)sc[4];
  auto W = [&](int i) { return (const float*)wt[2 * i]; };
  auto Bi = [&](int i) { return (const float*)wt[2 * i + 1]; };

  auto conv = [&](const float* x0, int ld0, int k0, const float* x1, int ld1, int k1,
                  int wi, int npad, int tapset, int epi) {
    ConvArgs a = {};
    a.x0 = x0; a.ld0 = ld0; a.k0 = k0;
    a.x1 = x1; a.ld1 = ld1; a.k1 = k1;
    a.w = W(wi); a.bias = Bi(wi);
    a.npad = npad; a.tapset = tapset;
    a.ntaps = tapset == TAPS_3X3 ? 9 : 5;
    a.M = M; a.H8 = H8; a.W8 = W8; a.epi = epi;
    return a;
  };
  int rc;

  if (fill) {
    if ((rc = launch_fill_hx<float>(net, inp, hx, M, s))) return rc;
  }
  // motion encoder tail: c2 || f2 into one buffer cf = [c2 | f2], then the
  // 3x3 over it -> y, flow
  {
    ConvArgs a = conv(c1, 256, 256, nullptr, 0, 0, 0, 192, TAPS_3X3,
                         EPI_RELU);
    a.out = cf; a.ldo = CF; a.nreal = 192;
    if ((rc = launch_conv<64>(a, s))) return rc;
  }
  {
    ConvArgs a = conv(f1, 128, 128, nullptr, 0, 0, 1, 64, TAPS_3X3,
                         EPI_RELU);
    a.out = cf + 192; a.ldo = CF; a.nreal = 64;
    if ((rc = launch_conv<64>(a, s))) return rc;
  }
  {
    ConvArgs a = conv(cf, CF, CF, nullptr, 0, 0, 2, 128, TAPS_3X3, EPI_Y);
    a.out = hx + 2 * HID; a.ldo = HX; a.nreal = 126; a.flow = flow;
    if ((rc = launch_conv<64>(a, s))) return rc;
  }
  // SepConvGRU: horizontal (1x5) then vertical (5x1)
  for (int d = 0; d < 2; ++d) {
    const int tapset = d == 0 ? TAPS_1X5 : TAPS_5X1;
    const float* net_in = d == 0 ? net : net_out;
    {
      ConvArgs a = conv(hx, HX, HX, nullptr, 0, 0, 3 + 2 * d, 2 * HID,
                           tapset, EPI_ZR);
      a.z = z; a.net_in = net_in; a.rnet = rnet;
      if ((rc = launch_conv<64>(a, s))) return rc;
    }
    {
      ConvArgs a = conv(rnet, HID, HID, hx + HID, HX, HX - HID, 4 + 2 * d,
                           HID, tapset, EPI_Q);
      a.z = z; a.net_in = net_in; a.net_out = net_out; a.hx = hx;
      if ((rc = launch_conv<64>(a, s))) return rc;
    }
  }
  // flow head
  {
    ConvArgs a = conv(hx, HX, HID, nullptr, 0, 0, 7, 256, TAPS_3X3,
                         EPI_RELU);
    a.out = fh; a.ldo = 256; a.nreal = 256;
    if ((rc = launch_conv<64>(a, s))) return rc;
  }
  {
    ConvArgs a = conv(fh, 256, 256, nullptr, 0, 0, 8, 16, TAPS_3X3,
                         EPI_DELTA);
    a.delta = delta;
    if ((rc = launch_conv<16>(a, s))) return rc;
  }
  return 0;
}


// ===========================================================================
// The bfloat16 instance on Hopper's own units: wgmma fed by TMA.
//
// The same implicit product, tiled for the card. A token tile is R whole
// (or x-segmented) image rows: R x XS tokens, at most 64 per consumer
// warpgroup. One TMA request brings the 64-channel slice of the tile shifted
// by a tap's (dy, dx) from a 4-D view (B, H8, W8, C) of the activations; what
// lies outside the image arrives as zeros, which is the convolution's
// padding, so no thread computes an address or a mask. A second request
// brings the tap's 64 x BN weight slice from the K-major weight matrix. Both
// land in the 128-byte swizzle that wgmma reads, in a ring of stages guarded
// by mbarrier pairs (full / empty). One producer warp keeps the requests in
// flight; each consumer warpgroup multiplies its 64 tokens x BN columns with
// wgmma.mma_async m64nBNk16, the float32 sum in registers from the first tap
// to the epilogue, one product group in flight behind the one just started.
// The epilogue (bias, activation, GRU blend, rounding) reads the accumulator
// fragments directly.
// ===========================================================================

struct SubProblem {
  CUtensorMap a0, a1;  // activations: channels [0, k0) from a0, then a1
  CUtensorMap w;       // (ntaps * npad, k0 + k1) K-major weights
  const float* bias;
  int k0, k1;          // channels taken from each, multiples of 64
  int c0, c1;          // first channel inside each tensor
  int ntaps, tapset;
  int npad;            // weight rows per tap = output columns
  int ncols;           // column tiles: npad / BN
  int epi;
  __nv_bfloat16* out; int ldo; int nreal;  // EPI_RELU, EPI_Y
  const float* flow;                       // EPI_Y
  float* z;                                // EPI_ZR writes, EPI_Q reads
  const float* net_in;                     // EPI_ZR, EPI_Q
  __nv_bfloat16* rnet;                     // EPI_ZR
  float* net_out;                          // EPI_Q
  __nv_bfloat16* hx;                       // EPI_Q
  float* delta;                            // EPI_DELTA
};

struct StageParams {
  SubProblem sub[2];  // blockIdx.y walks sub[0]'s column tiles, then sub[1]'s
  int B, H8, W8;
  int R, XS;          // token tile: R image rows x XS columns
  int tiles_y, tiles_x;
  int cluster;        // blocks that share one tile, each a subset of the steps
};

constexpr int TMA_BK = 64;                 // channels per pipeline step
constexpr int ROW_BYTES = TMA_BK * 2;      // one token's slice: 128 bytes
constexpr int MAX_STAGES = 8;
constexpr int NWG = 2;            // consumer warpgroups of a block
constexpr int MT = 64 * NWG;      // tokens per block
constexpr int CONSUMERS = NWG * 128;
constexpr int TMA_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = MT * ROW_BYTES;
constexpr int MAX_CLUSTER = 8;
// shared memory of the ring: it leaves room for a second block on the SM
// (228 KB an SM), so that one block's epilogue runs beside another's products
constexpr int RING_BYTES = 96 * 1024;

template <int BN>
struct TmaTile {
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static constexpr int NST = RING_BYTES / STAGE_BYTES < MAX_STAGES
                                 ? RING_BYTES / STAGE_BYTES
                                 : MAX_STAGES;
  // a cluster's partial sums: the MT x BN float32 tile, rows padded by 8
  // floats so that a warp's fragment stores spread over all banks; it
  // reuses the ring
  static constexpr int LDP = BN + 8;
  static_assert(MT * LDP * 4 <= NST * STAGE_BYTES, "partial sums fit the ring");
  // + 1024: the dynamic segment is aligned by hand
  static constexpr int SMEM_BYTES = NST * STAGE_BYTES + 1024;
};

// two neighbouring output columns (n, n + 1) of token g, bias added
__device__ __forceinline__ void tma_epilogue(const SubProblem& s, size_t g,
                                             int n, float v0, float v1) {
  switch (s.epi) {
    case EPI_RELU:
      if (n < s.nreal)
        *reinterpret_cast<__nv_bfloat162*>(s.out + g * s.ldo + n) =
            __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      break;
    case EPI_Y:  // 126 motion channels, then the flow itself
      if (n < s.nreal) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      } else {
        v0 = s.flow[g * 2];
        v1 = s.flow[g * 2 + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(s.out + g * s.ldo + n) =
          __floats2bfloat162_rn(v0, v1);
      break;
    case EPI_ZR:
      if (n < HID) {
        *reinterpret_cast<float2*>(s.z + g * HID + n) =
            make_float2(sigmoidf_(v0), sigmoidf_(v1));
      } else {
        const size_t o = g * HID + n - HID;
        const float2 h = *reinterpret_cast<const float2*>(s.net_in + o);
        *reinterpret_cast<__nv_bfloat162*>(s.rnet + o) = __floats2bfloat162_rn(
            sigmoidf_(v0) * h.x, sigmoidf_(v1) * h.y);
      }
      break;
    case EPI_Q: {
      const size_t o = g * HID + n;
      const float2 z = *reinterpret_cast<const float2*>(s.z + o);
      const float2 h = *reinterpret_cast<const float2*>(s.net_in + o);
      const float h0 = (1.0f - z.x) * h.x + z.x * tanhf(v0);
      const float h1 = (1.0f - z.y) * h.y + z.y * tanhf(v1);
      *reinterpret_cast<float2*>(s.net_out + o) = make_float2(h0, h1);
      *reinterpret_cast<__nv_bfloat162*>(s.hx + g * HX + n) =
          __floats2bfloat162_rn(h0, h1);
      break;
    }
    default:  // EPI_DELTA
      if (n == 0)
        *reinterpret_cast<float2*>(s.delta + g * 2) = make_float2(v0, v1);
      break;
  }
}

__device__ __forceinline__ void cluster_sync() {
  __syncwarp();  // the aligned forms want the whole warp
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// two floats at shared-memory address `addr` of block `rank` of the cluster
__device__ __forceinline__ float2 ld_cluster_f2(unsigned addr, int rank) {
  unsigned remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// One MT-token x BN-column tile. A cluster of p.cluster blocks shares the
// tile: block `rank` sums pipeline steps rank, rank + cluster, ... (a step is
// one tap's 64-channel slice), and the partial sums meet through distributed
// shared memory before the epilogue, which the blocks split by elements.
template <int BN>
__global__ void __launch_bounds__(TMA_THREADS)
tma_conv_kernel(const __grid_constant__ StageParams p) {
  using TT = TmaTile<BN>;
  constexpr int NST = TT::NST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[NST];
  __shared__ __align__(8) uint64_t empty_bar[NST];
  const unsigned smem = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_i = (int)blockIdx.y >= p.sub[0].ncols ? 1 : 0;
  const SubProblem& s = p.sub[sub_i];
  const int n0 = ((int)blockIdx.y - (sub_i ? p.sub[0].ncols : 0)) * BN;
  const int cs = p.cluster;
  const int rank = blockIdx.x % cs;  // consecutive blocks form a cluster
  int t = blockIdx.x / cs;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int b = t / p.tiles_y;
  const int x0 = tx * p.XS, y0 = ty * p.R;
  const int kch = (s.k0 + s.k1) / TMA_BK;
  const int nsteps = s.ntaps * kch;
  const int niter = (nsteps - rank + cs - 1) / cs;  // this block's steps

  // the launches of a step are chained by programmatic dependent launch:
  // the next stage's blocks may start now, set up their barriers and fetch
  // their first weight tiles (which depend on no earlier stage) while this
  // stage still runs, and wait below before they touch an activation
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full_bar[i], 1);         // the producer's expect_tx arrival
      mbar_init(&empty_bar[i], NWG * 4);  // one lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: one lane keeps the ring full
    if (lane == 0) {
      const unsigned bytes = (unsigned)(p.R * p.XS * ROW_BYTES + TT::B_BYTES);
      auto load_w = [&](int it) {
        const int st = it % NST, step = rank + it * cs;
        mbar_expect_tx(&full_bar[st], bytes);
        tma_load_2d(smem + st * TT::STAGE_BYTES + A_BYTES, &s.w,
                    &full_bar[st], (step % kch) * TMA_BK,
                    (step / kch) * s.npad + n0);
      };
      const int ahead = niter < NST ? niter : NST;
      for (int it = 0; it < ahead; ++it) load_w(it);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int it = 0; it < niter; ++it) {
        const int st = it % NST, step = rank + it * cs;
        if (it >= NST) {
          mbar_wait(&empty_bar[st], ((it / NST) & 1) ^ 1);
          load_w(it);
        }
        int dy, dx;
        tap_offset(s.tapset, step / kch, dy, dx);
        const unsigned dst = smem + st * TT::STAGE_BYTES;
        const int k = (step % kch) * TMA_BK;
        if (k < s.k0)
          tma_load_4d(dst, &s.a0, &full_bar[st], s.c0 + k, x0 + dx, y0 + dy,
                      b);
        else
          tma_load_4d(dst, &s.a1, &full_bar[st], s.c1 + k - s.k0, x0 + dx,
                      y0 + dy, b);
      }
    }
    // the producer warp takes part in the cluster's two barriers
    if (cs > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // ---- consumers: warpgroup wg multiplies tokens [64 wg, 64 wg + 64)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < niter; ++it) {
    const int st = it % NST;
    mbar_wait(&full_bar[st], (it / NST) & 1);
    const unsigned a_addr = smem + st * TT::STAGE_BYTES + wg * 64 * ROW_BYTES;
    const unsigned b_addr = smem + st * TT::STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TMA_BK / 16; ++kk)
      Wgmma<BN>::mma(acc, smem_desc(a_addr + kk * 32),
                     smem_desc(b_addr + kk * 32));
    wgmma_commit();
    if (it > 0) {  // the step before this one has been multiplied
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % NST]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // a lane holds rows q and q + 8 of its warp's 16, columns 8 j + 2 c and
  // 8 j + 2 c + 1 (q = lane / 4, c = lane % 4)
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int tokens = p.R * p.XS;
  if (cs == 1) {
    // the epilogue reads the accumulator fragments directly
    const int col = n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const int y = y0 + r / p.XS, x = x0 + r % p.XS;
      if (r >= tokens || y >= p.H8 || x >= p.W8) continue;
      const size_t g = ((size_t)b * p.H8 + y) * p.W8 + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = col + 8 * j;
        const float2 bias = *reinterpret_cast<const float2*>(s.bias + n);
        tma_epilogue(s, g, n, acc[4 * j + 2 * h] + bias.x,
                     acc[4 * j + 2 * h + 1] + bias.y);
      }
    }
    return;
  }

  // ---- the cluster's partial sums meet: every block lays its fragments
  // out as a row-major tile over its ring (all of its products are done:
  // the named barrier holds the consumers of both warpgroups) ...
  constexpr int LDP = TT::LDP;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float* part = reinterpret_cast<float*>(
      smem_raw + (smem - smem_u32(smem_raw)));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(part + (row + 8 * h) * LDP + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster_sync();
  // ... and block `rank` finishes every cs-th run of 256 column pairs: the
  // sum over the blocks in rank order, then the epilogue
  const int tid = threadIdx.x;  // < CONSUMERS
  for (int e = rank * CONSUMERS + tid; e < MT * (BN / 2);
       e += cs * CONSUMERS) {
    const int r = e / (BN / 2), cp = e % (BN / 2);
    const int y = y0 + r / p.XS, x = x0 + r % p.XS;
    if (r >= tokens || y >= p.H8 || x >= p.W8) continue;
    const unsigned addr = smem + (unsigned)(r * LDP + 2 * cp) * 4u;
    float2 v = ld_cluster_f2(addr, 0);
    for (int q = 1; q < cs; ++q) {
      const float2 u = ld_cluster_f2(addr, q);
      v.x += u.x;
      v.y += u.y;
    }
    const int n = n0 + 2 * cp;
    const float2 bias = *reinterpret_cast<const float2*>(s.bias + n);
    tma_epilogue(s, ((size_t)b * p.H8 + y) * p.W8 + x, n, v.x + bias.x,
                 v.y + bias.y);
  }
  cluster_sync();  // no block leaves while another reads its sums
}

template <int BN>
int launch_tma_conv(const StageParams& p, cudaStream_t s) {
  using TT = TmaTile<BN>;
  constexpr int MAX_DEV = 64;
  static bool allowed[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEV || !allowed[dev]) {
    err = cudaFuncSetAttribute(tma_conv_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TT::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEV) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.tiles_y * p.tiles_x * p.cluster,
                     p.sub[0].ncols + p.sub[1].ncols);
  cfg.blockDim = dim3(TMA_THREADS);
  cfg.dynamicSmemBytes = TT::SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[2] = {};
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = p.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, tma_conv_kernel<BN>, p);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_CHECK();
  return 0;
}

int launch_tma_conv(int bn, const StageParams& p, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_tma_conv<16>(p, s);
    case 64: return launch_tma_conv<64>(p, s);
    case 128: return launch_tma_conv<128>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the plan of one solve: tile shape, tensor maps, scratch pointers. It
// lives in host memory that the caller owns (mfc_raft_plan_bytes() bytes).
enum Act { ACT_C1 = 0, ACT_F1, ACT_CF, ACT_HX, ACT_RNET, ACT_FH, N_ACT };
constexpr int ACT_CH[N_ACT] = {256, 128, CF, HX, HID, 256};
constexpr int N_CONV = 9;  // c2 f2 cv zr_h q_h zr_v q_v fl1 fl2
constexpr int N_STAGES = 8;  // launches: c2 || f2 is one
// per convolution: input channels, output columns (padded), taps
constexpr int CONV_K[N_CONV] = {256, 128, 256, 384, 384, 384, 384, 128, 256};
constexpr int CONV_N[N_CONV] = {192, 64, 128, 256, 128, 256, 128, 256, 16};
constexpr int CONV_TAPS[N_CONV] = {9, 9, 9, 5, 5, 5, 5, 9, 9};
constexpr int CONV_STAGE[N_CONV] = {0, 0, 1, 2, 3, 4, 5, 6, 7};

struct Plan {
  int B, H8, W8, M;
  int R, XS, tiles_y, tiles_x;
  int bn[N_STAGES], cluster[N_STAGES];
  CUtensorMap act[N_ACT];
  const void* act_ptr[N_ACT];
  CUtensorMap w[N_CONV];
  const float* bias[N_CONV];
  __nv_bfloat16 *cf, *hx, *rnet, *fh;
  float* z;
};

constexpr int ERR_PLAN = 20002;  // a tile plan the kernel cannot run

// (B, H8, W8, ch) bf16 activations, token-major: a box is the 64-channel
// slice of R rows x XS columns of one image
int encode_act(Plan& pl, int i, const void* ptr) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_LIBCUDA;
  const cuuint64_t ld = (cuuint64_t)ACT_CH[i] * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)ACT_CH[i], (cuuint64_t)pl.W8,
                              (cuuint64_t)pl.H8, (cuuint64_t)pl.B};
  const cuuint64_t strides[3] = {ld, ld * pl.W8, ld * pl.W8 * pl.H8};
  const cuuint32_t box[4] = {TMA_BK, (cuuint32_t)pl.XS, (cuuint32_t)pl.R, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(
      &pl.act[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return ERR_ENCODE + (int)rc;
  pl.act_ptr[i] = ptr;
  return 0;
}

// (taps * npad, k) bf16 K-major weights: a box is 64 of k x bn rows
int encode_weight(Plan& pl, int i, const void* ptr, int bn) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_LIBCUDA;
  const cuuint64_t dims[2] = {(cuuint64_t)CONV_K[i],
                              (cuuint64_t)CONV_TAPS[i] * CONV_N[i]};
  const cuuint64_t strides[1] = {(cuuint64_t)CONV_K[i] * 2};
  const cuuint32_t box[2] = {TMA_BK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = enc(
      &pl.w[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)rc;
}

int run_update_tma(Plan& pl, void* const* in, float* net_out, float* delta,
                   int fill, cudaStream_t s) {
  if (pl.M == 0) return 0;
  const __nv_bfloat16* inp = (const __nv_bfloat16*)in[2];
  const float* net = (const float*)in[3];
  const float* flow = (const float*)in[4];
  int rc;
  // c1 and f1 are new tensors in every iteration: their maps follow them
  for (int i = ACT_C1; i <= ACT_F1; ++i)
    if (pl.act_ptr[i] != in[i] && (rc = encode_act(pl, i, in[i]))) return rc;
  if (fill && (rc = launch_fill_hx<__nv_bfloat16>(net, inp, pl.hx, pl.M, s)))
    return rc;

  StageParams p = {};
  p.B = pl.B; p.H8 = pl.H8; p.W8 = pl.W8;
  p.R = pl.R; p.XS = pl.XS; p.tiles_y = pl.tiles_y; p.tiles_x = pl.tiles_x;
  // sub-problem `si` of the next launch: convolution `ci` over channels
  // [c0, c0 + k0) of activation a0, then [c1, c1 + k1) of a1
  auto sub = [&](int si, int ci, int a0, int c0, int k0, int a1, int c1,
                 int k1, int tapset, int epi) -> SubProblem& {
    SubProblem& q = p.sub[si];
    q = SubProblem{};
    q.a0 = pl.act[a0]; q.c0 = c0; q.k0 = k0;
    q.a1 = pl.act[a1]; q.c1 = c1; q.k1 = k1;
    q.w = pl.w[ci]; q.bias = pl.bias[ci];
    q.ntaps = CONV_TAPS[ci]; q.tapset = tapset;
    q.npad = CONV_N[ci];
    q.ncols = CONV_N[ci] / pl.bn[CONV_STAGE[ci]];
    q.epi = epi;
    return q;
  };
  auto launch = [&](int stage) {
    p.cluster = pl.cluster[stage];
    const int r = launch_tma_conv(pl.bn[stage], p, s);
    p.sub[1] = SubProblem{};
    return r;
  };

  // motion encoder tail: c2 || f2 in one grid -> cf = [c2 | f2]
  {
    SubProblem& a = sub(0, 0, ACT_C1, 0, 256, ACT_C1, 0, 0, TAPS_3X3, EPI_RELU);
    a.out = pl.cf; a.ldo = CF; a.nreal = 192;
    SubProblem& f = sub(1, 1, ACT_F1, 0, 128, ACT_F1, 0, 0, TAPS_3X3, EPI_RELU);
    f.out = pl.cf + 192; f.ldo = CF; f.nreal = 64;
    if ((rc = launch(0))) return rc;
  }
  {
    SubProblem& a = sub(0, 2, ACT_CF, 0, CF, ACT_CF, 0, 0, TAPS_3X3, EPI_Y);
    a.out = pl.hx + 2 * HID; a.ldo = HX; a.nreal = 126; a.flow = flow;
    if ((rc = launch(1))) return rc;
  }
  // SepConvGRU: horizontal (1x5) then vertical (5x1)
  for (int d = 0; d < 2; ++d) {
    const int tapset = d == 0 ? TAPS_1X5 : TAPS_5X1;
    const float* net_in = d == 0 ? net : net_out;
    {
      SubProblem& a = sub(0, 3 + 2 * d, ACT_HX, 0, HX, ACT_HX, 0, 0, tapset,
                          EPI_ZR);
      a.z = pl.z; a.net_in = net_in; a.rnet = pl.rnet;
      if ((rc = launch(2 + 2 * d))) return rc;
    }
    {  // [r * net | inp, y, flow]: the second segment inside hx
      SubProblem& a = sub(0, 4 + 2 * d, ACT_RNET, 0, HID, ACT_HX, HID,
                          HX - HID, tapset, EPI_Q);
      a.z = pl.z; a.net_in = net_in; a.net_out = net_out; a.hx = pl.hx;
      if ((rc = launch(3 + 2 * d))) return rc;
    }
  }
  // flow head
  {
    SubProblem& a = sub(0, 7, ACT_HX, 0, HID, ACT_HX, 0, 0, TAPS_3X3, EPI_RELU);
    a.out = pl.fh; a.ldo = 256; a.nreal = 256;
    if ((rc = launch(6))) return rc;
  }
  {
    SubProblem& a = sub(0, 8, ACT_FH, 0, 256, ACT_FH, 0, 0, TAPS_3X3, EPI_DELTA);
    a.delta = delta;
    if ((rc = launch(7))) return rc;
  }
  return 0;
}

}  // namespace

// The float32 instance (plain FMAs).
// inputs: {c1 (M,256), f1 (M,128), inp (M,128)} in the operand type, {net
// (M,128), flow (M,2)} float32; weights: the 18 packed tensors in the order
// of ops/raft_update.py::_WEIGHT_NAMES (weight (taps, K, N), bias, ...);
// scratch: {cf = [c2 | f2] (M,256), hx (M,384), r*net (M,128), flow-head
// hidden (M,256)} in the operand type and z (M,128) float32. The three
// arrays are host arrays of device pointers. dtype: 0 float32 (bfloat16 runs
// mfc_raft_update_tma).
// fill: 1 writes hx[:, 0:256] = [net | inp] first; 0 when hx already holds
// them (the step before left net' there). net_out must not be net. M =
// B*H8*W8 tokens in raster order. Returns the first launch error.
extern "C" int mfc_raft_update(void* const* inputs, void* const* weights,
                               void* const* scratch, void* net_out,
                               void* delta, int B, int H8, int W8, int dtype,
                               int fill, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run_update(inputs, weights, scratch, (float*)net_out,
                      (float*)delta, B, H8, W8, fill, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the wgmma + TMA instance (bfloat16)
extern "C" int mfc_raft_plan_bytes(void) { return (int)sizeof(Plan) + 64; }

// Fill `plan` (mfc_raft_plan_bytes() bytes of host memory) for solves at
// B x H8 x W8. weights: per convolution (c2 f2 cv zr_h q_h zr_v q_v fl1 fl2)
// the K-major bf16 weight (taps, N, K) and the float32 bias; scratch as for
// mfc_raft_update (bf16). tile: {R, XS, the column-tile width of each of the
// 8 launches, the cluster size of each} from ops/raft_update.py::tile_plan.
extern "C" int mfc_raft_plan_init(void* plan, void* const* weights,
                                  void* const* scratch, int B, int H8, int W8,
                                  const int* tile) {
  Plan& pl = *new (align64(plan)) Plan{};
  pl.B = B; pl.H8 = H8; pl.W8 = W8; pl.M = B * H8 * W8;
  pl.R = tile[0]; pl.XS = tile[1];
  if (pl.M == 0) return 0;
  if (pl.R < 1 || pl.XS < 1 || pl.R > 256 || pl.XS > 256 || pl.R > H8 ||
      pl.XS > W8 || pl.R * pl.XS > MT)
    return ERR_PLAN;
  pl.tiles_y = (H8 + pl.R - 1) / pl.R;
  pl.tiles_x = (W8 + pl.XS - 1) / pl.XS;
  for (int i = 0; i < N_STAGES; ++i) {
    pl.bn[i] = tile[2 + i];
    pl.cluster[i] = tile[2 + N_STAGES + i];
    if (pl.cluster[i] < 1 || pl.cluster[i] > MAX_CLUSTER) return ERR_PLAN;
  }
  for (int i = 0; i < N_CONV; ++i)
    if (CONV_N[i] % pl.bn[CONV_STAGE[i]] ||
        pl.cluster[CONV_STAGE[i]] > CONV_TAPS[i] * CONV_K[i] / TMA_BK)
      return ERR_PLAN;
  pl.cf = (__nv_bfloat16*)scratch[0];
  pl.hx = (__nv_bfloat16*)scratch[1];
  pl.rnet = (__nv_bfloat16*)scratch[2];
  pl.fh = (__nv_bfloat16*)scratch[3];
  pl.z = (float*)scratch[4];
  int rc;
  const void* acts[N_ACT] = {nullptr, nullptr, pl.cf, pl.hx, pl.rnet, pl.fh};
  for (int i = ACT_CF; i < N_ACT; ++i)
    if ((rc = encode_act(pl, i, acts[i]))) return rc;
  for (int i = 0; i < N_CONV; ++i) {
    if ((rc = encode_weight(pl, i, weights[2 * i], pl.bn[CONV_STAGE[i]])))
      return rc;
    pl.bias[i] = (const float*)weights[2 * i + 1];
  }
  return 0;
}

// One update iteration on the planned shape. inputs as for mfc_raft_update
// (bf16); net_out (M,128), delta (M,2) float32; net_out must not be net.
extern "C" int mfc_raft_update_tma(void* plan, void* const* inputs,
                                   void* net_out, void* delta, int fill,
                                   void* stream) {
  return run_update_tma(*(Plan*)align64(plan), inputs, (float*)net_out,
                        (float*)delta, fill, (cudaStream_t)stream);
}
