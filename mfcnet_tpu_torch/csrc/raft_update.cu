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
// pace (~230 TFLOP/s at 38,400 tokens in bfloat16).
//
// Design (one core for both operand types):
//   * Every convolution is the same implicit product: out[token, n] =
//     sum over taps, k of x[token shifted by (dy, dx), k] * w[tap][k, n],
//     where a shifted token outside its H8 x W8 image reads zero. A token
//     tile is a block of whole (or x-segmented) image rows, at most 128
//     tokens, so that one TMA request on a (B, H8, W8, C) view fetches a
//     tap's shifted 128-byte channel slice and the hardware's zero fill
//     outside the tensor is the convolution's padding: no address
//     arithmetic, no masks. The weights are K-major (taps * N, K) matrices
//     behind 2-D maps.
//   * Both operands land in the 128-byte swizzle that wgmma reads, in a ring
//     of stages guarded by mbarrier pairs; one producer warp keeps the
//     requests in flight, two consumer warpgroups multiply 64 tokens x BN
//     columns each with wgmma.mma_async, the float32 sum in registers from
//     the first tap to the epilogue (bias, ReLU / sigmoid / tanh, the GRU
//     blend, the rounding to the operand type), which reads the accumulator
//     fragments directly.
//   * Few tokens: a cluster of up to 8 blocks shares one output tile, each
//     block sums every cluster-th pipeline step (a tap's channel slice), so
//     that every SM pulls a share of the weights; the partial sums meet
//     through distributed shared memory, and the blocks split the epilogue.
//     The cluster size of each launch comes from its block count
//     (ops/raft_update.py::tile_plan, the one place where the shape picks
//     the configuration; for float32 the C side computes the same plan and
//     refuses any other). Many tokens: no cluster, the token tiles alone
//     fill the card.
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
//     2400 x 384 x 4 B = 3.7 MB in float32) stay in the 50 MB L2. Channels
//     are padded only to what a fragment needs (126 -> 128, 2 -> 16). The TPU
//     kernel's single program, its 128-lane padding and its VMEM-driven
//     batch chunking are not carried over.
//
// The two instances:
//   * bfloat16: a pipeline step is 64 channels; wgmma m64nBNk16 on bf16
//     operands, two blocks to an SM (a 96 KB ring each), so that one
//     block's epilogue runs beside another's products.
//   * float32 ("3xTF32", as csrc/correlation.cu): a pipeline step is 32
//     channels (the same 128-byte rows, swizzle and descriptors), wgmma
//     m64nBNk8 on tf32 operands, three products a k step. Each operand is
//     split, a = big + small with big = tf32(a) rounded to nearest (10
//     explicit mantissa bits, |a - big| <= 2^-11 |a|) and small = a - big,
//     exact in float32, which the tensor core reads as tf32 (its top 19
//     bits, <= 2^-10 of small). The weights are split once, when
//     pack_update_weights packs them (big and small K-major tensors, both
//     staged); the activations are split in registers: wgmma takes its A
//     operand from registers too, so each consumer thread reads its A
//     fragments of a stage through the swizzle, splits them and issues the
//     three products with the weights from shared memory (tf32 operands in
//     shared memory must be K-major, as both weight parts are). The
//     products small.big + big.small + big.big miss a.b by small.small and
//     the truncations of small, a few 2^-21 |a||b| each, against the float32
//     tolerance (2e-5, rtol 1e-4) the step is held to. A stage holds the
//     activation slice and both weight parts (16 KB + 2 x BN x 128 B): two
//     stages in the 96 KB ring at BN = 128, three at 64. A step's products
//     end before the next step's fragments are read into the same
//     registers (overlapping them gave wrong results: wgmma reads its A
//     registers while it runs), so a warpgroup's products do not overlap
//     its next loads; the other warpgroup's do. The tile plan is the
//     bfloat16 instance's. Compared with the first float32 design (plain FMAs on
//     32-token tiles, nine launches), it moves the products to the tensor
//     cores at three passes: 165 TFLOP/s of the card's 495 TF32 against 67
//     for float32 FMAs.

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

constexpr int HID = 128;  // GRU state width
constexpr int HX = 384;   // hx row: net 128 | inp 128 | y 126 | flow 2
constexpr int CF = 256;   // cf row: c2 192 | f2 64

enum Epilogue { EPI_RELU = 0, EPI_Y = 1, EPI_ZR = 2, EPI_Q = 3, EPI_DELTA = 4 };
enum TapSet { TAPS_3X3 = 0, TAPS_1X5 = 1, TAPS_5X1 = 2 };
enum Dtype { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void tap_offset(int tapset, int t, int& dy,
                                           int& dx) {
  if (tapset == TAPS_3X3) { dy = t / 3 - 1; dx = t % 3 - 1; }
  else if (tapset == TAPS_1X5) { dy = 0; dx = t - 2; }
  else { dy = t - 2; dx = 0; }
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
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

// ===========================================================================
// The core: wgmma fed by TMA.
//
// A token tile is R whole (or x-segmented) image rows: R x XS tokens, at
// most 64 per consumer warpgroup. One TMA request brings the 128-byte channel
// slice of the tile shifted by a tap's (dy, dx) from a 4-D view (B, H8, W8,
// C) of the activations; what lies outside the image arrives as zeros, which
// is the convolution's padding, so no thread computes an address or a mask.
// A second request (for float32, a second pair) brings the tap's slice of BN
// weight rows from the K-major weight matrix. All land in the 128-byte
// swizzle that wgmma reads, in a ring of stages guarded by mbarrier pairs
// (full / empty). One producer warp keeps the requests in flight; each
// consumer warpgroup multiplies its 64 tokens x BN columns, the float32 sum in
// registers from the first tap to the epilogue, one product group in flight
// behind the one just started. The epilogue (bias, activation, GRU blend,
// rounding) reads the accumulator fragments directly.
// ===========================================================================

// per operand type: channels a pipeline step (128 bytes of a token's row),
// the tensor maps' element type, whether the operands are split (3xTF32)
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct Elem<float> {
  static constexpr int BK = 32;
  static constexpr bool SPLIT = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

struct SubProblem {
  CUtensorMap a0, a1;  // activations: channels [0, k0) from a0, then a1
  CUtensorMap w;       // (ntaps * npad, k0 + k1) K-major weights (float32:
  CUtensorMap ws;      // their big part) and, float32 only, the small part
  const float* bias;
  int k0, k1;          // channels taken from each, multiples of the step
  int c0, c1;          // first channel inside each tensor
  int ntaps, tapset;
  int npad;            // weight rows per tap = output columns
  int ncols;           // column tiles: npad / BN
  int epi;
  void* out; int ldo; int nreal;  // EPI_RELU, EPI_Y (operand type)
  const float* flow;              // EPI_Y
  float* z;                       // EPI_ZR writes, EPI_Q reads
  const float* net_in;            // EPI_ZR, EPI_Q
  void* rnet;                     // EPI_ZR (operand type)
  float* net_out;                 // EPI_Q
  void* hx;                       // EPI_Q (operand type)
  float* delta;                   // EPI_DELTA
};

struct StageParams {
  SubProblem sub[2];  // blockIdx.y walks sub[0]'s column tiles, then sub[1]'s
  int B, H8, W8;
  int R, XS;          // token tile: R image rows x XS columns
  int tiles_y, tiles_x;
  int cluster;        // blocks that share one tile, each a subset of the steps
};

constexpr int ROW_BYTES = 128;    // one token's slice of a pipeline step
constexpr int MAX_STAGES = 8;
constexpr int NWG = 2;            // consumer warpgroups of a block
constexpr int MT = 64 * NWG;      // tokens per block
constexpr int CONSUMERS = NWG * 128;
constexpr int TMA_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = MT * ROW_BYTES;
constexpr int MAX_CLUSTER = 8;
// shared memory of the ring: it leaves room for a second block on the SM
// (228 KB an SM), so that one block's epilogue runs beside another's
// products where the registers allow it (float32 at BN = 128 takes 125
// registers a thread: one block an SM). For float32 a 192 KB ring (four
// stages at BN = 128, one block an SM in every launch) was 1.6 % slower at
// 38,400 tokens and level at 2,400 (tools/raft_f32_variants.py)
constexpr int RING_BYTES = 96 * 1024;

template <int BN, typename T>
struct TmaTile {
  static constexpr bool SPLIT = Elem<T>::SPLIT;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  // stage: activations | weights | (float32: the weights' small part)
  static constexpr int W_OFF = A_BYTES;
  static constexpr int WS_OFF = W_OFF + B_BYTES;
  static constexpr int TX_W_BYTES = (SPLIT ? 2 : 1) * B_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + TX_W_BYTES;
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static constexpr int NST = RING_BYTES / STAGE_BYTES < MAX_STAGES
                                 ? RING_BYTES / STAGE_BYTES
                                 : MAX_STAGES;
  static_assert(NST >= 2, "a ring of at least two stages");
  // a cluster's partial sums: the MT x BN float32 tile, rows padded by 8
  // floats so that a warp's fragment stores spread over all banks; it
  // reuses the ring
  static constexpr int LDP = BN + 8;
  static_assert(MT * LDP * 4 <= NST * STAGE_BYTES, "partial sums fit the ring");
  // + 1024: the dynamic segment is aligned by hand
  static constexpr int SMEM_BYTES = NST * STAGE_BYTES + 1024;
};

// two neighbouring values of one row, stored as one vector
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// two neighbouring output columns (n, n + 1) of token g, bias added
template <typename T>
__device__ __forceinline__ void tma_epilogue(const SubProblem& s, size_t g,
                                             int n, float v0, float v1) {
  switch (s.epi) {
    case EPI_RELU:
      if (n < s.nreal)
        store2((T*)s.out + g * s.ldo + n, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      break;
    case EPI_Y:  // 126 motion channels, then the flow itself
      if (n < s.nreal) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      } else {
        v0 = s.flow[g * 2];
        v1 = s.flow[g * 2 + 1];
      }
      store2((T*)s.out + g * s.ldo + n, v0, v1);
      break;
    case EPI_ZR:
      if (n < HID) {
        *reinterpret_cast<float2*>(s.z + g * HID + n) =
            make_float2(sigmoidf_(v0), sigmoidf_(v1));
      } else {
        const size_t o = g * HID + n - HID;
        const float2 h = *reinterpret_cast<const float2*>(s.net_in + o);
        store2((T*)s.rnet + o, sigmoidf_(v0) * h.x, sigmoidf_(v1) * h.y);
      }
      break;
    case EPI_Q: {
      const size_t o = g * HID + n;
      const float2 z = *reinterpret_cast<const float2*>(s.z + o);
      const float2 h = *reinterpret_cast<const float2*>(s.net_in + o);
      const float h0 = (1.0f - z.x) * h.x + z.x * tanhf(v0);
      const float h1 = (1.0f - z.y) * h.y + z.y * tanhf(v1);
      *reinterpret_cast<float2*>(s.net_out + o) = make_float2(h0, h1);
      store2((T*)s.hx + g * HX + n, h0, h1);
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

// big = tf32(x) rounded to nearest, ties away from zero (cvt.rna's rounding)
// by integer arithmetic on the bits; small = x - big, exact in float32, whose
// top 19 bits the tensor core reads
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// float32: one pipeline step's products of a warpgroup. Each thread reads
// its A fragments of the four 8-deep k steps from the stage's activation
// slice (rows r and r + 8 of its warp's 16 at columns 8 kk + c and
// 8 kk + c + 4, through the 128-byte swizzle: the 16-byte chunk index of a
// row is XORed with the row's index mod 8), splits them in registers and
// multiplies small.big, big.small, big.big with the weight slices at w_addr
// (big) and ws_addr (small). Returns when the products are done (their
// register operands are then free).
template <int BN>
__device__ __forceinline__ void step_products_f32(float (&acc)[BN / 2],
                                                  const unsigned char* a,
                                                  int r, int c,
                                                  unsigned w_addr,
                                                  unsigned ws_addr) {
  uint32_t big[4][4], small[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1), chunk = (2 * kk + (i >> 1)) ^ (r & 7);
      const float x = *reinterpret_cast<const float*>(
          a + row * ROW_BYTES + chunk * 16 + 4 * c);
      split_tf32(x, big[kk][i], small[kk][i]);
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // small terms first
    WgmmaTf32Rs<BN>::mma(acc, small[kk], smem_desc(w_addr + kk * 32));
    WgmmaTf32Rs<BN>::mma(acc, big[kk], smem_desc(ws_addr + kk * 32));
    WgmmaTf32Rs<BN>::mma(acc, big[kk], smem_desc(w_addr + kk * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// One MT-token x BN-column tile. A cluster of p.cluster blocks shares the
// tile: block `rank` sums pipeline steps rank, rank + cluster, ... (a step is
// one tap's 128-byte channel slice), and the partial sums meet through
// distributed shared memory before the epilogue, which the blocks split by
// elements.
template <int BN, typename T>
__global__ void __launch_bounds__(TMA_THREADS)
tma_conv_kernel(const __grid_constant__ StageParams p) {
  using TT = TmaTile<BN, T>;
  constexpr int NST = TT::NST, BK = Elem<T>::BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[NST];
  __shared__ __align__(8) uint64_t empty_bar[NST];
  const unsigned smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem_gen = smem_raw + (smem - smem_u32(smem_raw));

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
  const int kch = (s.k0 + s.k1) / BK;
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
      const unsigned bytes =
          (unsigned)(p.R * p.XS * ROW_BYTES + TT::TX_W_BYTES);
      auto load_w = [&](int it) {
        const int st = it % NST, step = rank + it * cs;
        const unsigned dst = smem + st * TT::STAGE_BYTES;
        const int k = (step % kch) * BK, row = (step / kch) * s.npad + n0;
        mbar_expect_tx(&full_bar[st], bytes);
        tma_load_2d(dst + TT::W_OFF, &s.w, &full_bar[st], k, row);
        if constexpr (TT::SPLIT)
          tma_load_2d(dst + TT::WS_OFF, &s.ws, &full_bar[st], k, row);
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
        const int k = (step % kch) * BK;
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

  // ---- consumers: warpgroup wg multiplies tokens [64 wg, 64 wg + 64). A
  // lane's rows of the tile, in its A fragments and in the accumulator:
  // q and q + 8 of its warp's 16 (q = lane / 4); accumulator columns 8 j +
  // 2 c and 8 j + 2 c + 1 (c = lane % 4)
  const int wg = warp / 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < niter; ++it) {
    const int st = it % NST;
    mbar_wait(&full_bar[st], (it / NST) & 1);
    const unsigned stage = smem + st * TT::STAGE_BYTES;
    if constexpr (TT::SPLIT) {
      // the A fragments come from registers: the products of this step end
      // before the next step's fragments are read into them
      step_products_f32<BN>(acc, smem_gen + st * TT::STAGE_BYTES, row,
                            lane % 4, stage + TT::W_OFF, stage + TT::WS_OFF);
      if (lane == 0) mbar_arrive(&empty_bar[st]);
    } else {
      const unsigned a_addr = stage + wg * 64 * ROW_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32-byte k steps of 128-byte rows
        Wgmma<BN>::mma(acc, smem_desc(a_addr + kk * 32),
                       smem_desc(stage + TT::W_OFF + kk * 32));
      wgmma_commit();
      if (it > 0) {  // the step before this one has been multiplied
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % NST]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

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
        tma_epilogue<T>(s, g, n, acc[4 * j + 2 * h] + bias.x,
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
  float* part = reinterpret_cast<float*>(smem_gen);
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
    tma_epilogue<T>(s, ((size_t)b * p.H8 + y) * p.W8 + x, n, v.x + bias.x,
                    v.y + bias.y);
  }
  cluster_sync();  // no block leaves while another reads its sums
}

template <int BN, typename T>
int launch_tma_conv(const StageParams& p, cudaStream_t s) {
  using TT = TmaTile<BN, T>;
  constexpr int MAX_DEV = 64;
  static bool allowed[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEV || !allowed[dev]) {
    err = cudaFuncSetAttribute(tma_conv_kernel<BN, T>,
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
  err = cudaLaunchKernelEx(&cfg, tma_conv_kernel<BN, T>, p);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_CHECK();
  return 0;
}

// one launch of the chain: the kernel instance of its column-tile width
template <typename T>
int launch_stage(int bn, const StageParams& p, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_tma_conv<16, T>(p, s);
    case 64: return launch_tma_conv<64, T>(p, s);
    case 128: return launch_tma_conv<128, T>(p, s);
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

// ops/raft_update.py::tile_plan, constant for constant: the float32 route
// is held to it (the bfloat16 route to the kernel's limits only: its
// TARGET_BLOCKS is what tools/raft_update_sweep.py varies)
constexpr int COLUMN_WIDTHS[N_STAGES] = {64, 128, 128, 128, 128, 128, 128, 16};
constexpr int TARGET_BLOCKS = 200;
constexpr int MAX_BOX = 256;  // elements along a TMA box's side
constexpr long long MAX_TOKENS = 2147483647LL / HX;
constexpr int TILE_INTS = 2 + 2 * N_STAGES;

struct Plan {
  int dtype, B, H8, W8, M;
  int R, XS, tiles_y, tiles_x;
  int bn[N_STAGES], cluster[N_STAGES];
  CUtensorMap act[N_ACT];
  const void* act_ptr[N_ACT];
  CUtensorMap w[N_CONV], ws[N_CONV];
  const float* bias[N_CONV];
  void *cf, *hx, *rnet, *fh;
  float* z;
};

constexpr int ERR_PLAN = 20002;  // a tile plan other than tile_plan's

// the tile plan of a solve at B x H8 x W8 (tile_plan's 18 ints: R, XS, the
// column width and the cluster of each launch); false for an empty grid or
// one beyond the kernel's 32-bit indices
bool tile_plan_of(int B, int H8, int W8, int* t) {
  if (B < 1 || H8 < 1 || W8 < 1 || (long long)B * H8 * W8 > MAX_TOKENS)
    return false;
  long long best = -1;
  int rows = 0, cols = 0;
  const int widest = MT < MAX_BOX ? MT : MAX_BOX;
  for (int nx = 1; nx <= W8; ++nx) {
    const int c = (W8 + nx - 1) / nx;
    if (c > widest) continue;
    int r = MT / c;
    r = r < H8 ? r : H8;
    r = r < MAX_BOX ? r : MAX_BOX;
    const long long n = (long long)((H8 + r - 1) / r) * ((W8 + c - 1) / c);
    if (best < 0 || n < best) {  // fewest tiles, then fewest x segments
      best = n;
      rows = r;
      cols = c;
    }
    if (c == 1) break;
  }
  const long long tiles = (long long)B * ((H8 + rows - 1) / rows) *
                          ((W8 + cols - 1) / cols);
  int ct[N_STAGES] = {};
  for (int i = 0; i < N_CONV; ++i)
    ct[CONV_STAGE[i]] += CONV_N[i] / COLUMN_WIDTHS[CONV_STAGE[i]];
  t[0] = rows;
  t[1] = cols;
  for (int i = 0; i < N_STAGES; ++i) {
    const long long c = TARGET_BLOCKS / (tiles * ct[i]);
    t[2 + i] = COLUMN_WIDTHS[i];
    t[2 + N_STAGES + i] = c < 1 ? 1 : (c > MAX_CLUSTER ? MAX_CLUSTER : (int)c);
  }
  return true;
}

// (B, H8, W8, ch) activations of the operand type, token-major: a box is the
// 128-byte channel slice of R rows x XS columns of one image
template <typename T>
int encode_act(Plan& pl, int i, const void* ptr) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_LIBCUDA;
  const cuuint64_t ld = (cuuint64_t)ACT_CH[i] * sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)ACT_CH[i], (cuuint64_t)pl.W8,
                              (cuuint64_t)pl.H8, (cuuint64_t)pl.B};
  const cuuint64_t strides[3] = {ld, ld * pl.W8, ld * pl.W8 * pl.H8};
  const cuuint32_t box[4] = {Elem<T>::BK, (cuuint32_t)pl.XS, (cuuint32_t)pl.R,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(
      &pl.act[i], Elem<T>::MAP, 4, const_cast<void*>(ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return ERR_ENCODE + (int)rc;
  pl.act_ptr[i] = ptr;
  return 0;
}

// (taps * npad, k) K-major weights of the operand type: a box is a 128-byte
// slice of k x bn rows
template <typename T>
int encode_weight(CUtensorMap* m, int i, const void* ptr, int bn) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_LIBCUDA;
  const cuuint64_t dims[2] = {(cuuint64_t)CONV_K[i],
                              (cuuint64_t)CONV_TAPS[i] * CONV_N[i]};
  const cuuint64_t strides[1] = {(cuuint64_t)CONV_K[i] * sizeof(T)};
  const cuuint32_t box[2] = {Elem<T>::BK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = enc(
      m, Elem<T>::MAP, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)rc;
}

template <typename T>
int run_update_tma(Plan& pl, void* const* in, float* net_out, float* delta,
                   int fill, cudaStream_t s) {
  if (pl.M == 0) return 0;
  const T* inp = (const T*)in[2];
  const float* net = (const float*)in[3];
  const float* flow = (const float*)in[4];
  int rc;
  // c1 and f1 are new tensors in every iteration: their maps follow them
  for (int i = ACT_C1; i <= ACT_F1; ++i)
    if (pl.act_ptr[i] != in[i] && (rc = encode_act<T>(pl, i, in[i])))
      return rc;
  if (fill && (rc = launch_fill_hx<T>(net, inp, (T*)pl.hx, pl.M, s)))
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
    q.w = pl.w[ci]; q.ws = pl.ws[ci]; q.bias = pl.bias[ci];
    q.ntaps = CONV_TAPS[ci]; q.tapset = tapset;
    q.npad = CONV_N[ci];
    q.ncols = CONV_N[ci] / pl.bn[CONV_STAGE[ci]];
    q.epi = epi;
    return q;
  };
  auto launch = [&](int stage) {
    p.cluster = pl.cluster[stage];
    const int r = launch_stage<T>(pl.bn[stage], p, s);
    p.sub[1] = SubProblem{};
    return r;
  };
  T* cf = (T*)pl.cf;
  T* hx = (T*)pl.hx;

  // motion encoder tail: c2 || f2 in one grid -> cf = [c2 | f2]
  {
    SubProblem& a = sub(0, 0, ACT_C1, 0, 256, ACT_C1, 0, 0, TAPS_3X3, EPI_RELU);
    a.out = cf; a.ldo = CF; a.nreal = 192;
    SubProblem& f = sub(1, 1, ACT_F1, 0, 128, ACT_F1, 0, 0, TAPS_3X3, EPI_RELU);
    f.out = cf + 192; f.ldo = CF; f.nreal = 64;
    if ((rc = launch(0))) return rc;
  }
  {
    SubProblem& a = sub(0, 2, ACT_CF, 0, CF, ACT_CF, 0, 0, TAPS_3X3, EPI_Y);
    a.out = hx + 2 * HID; a.ldo = HX; a.nreal = 126; a.flow = flow;
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
      a.z = pl.z; a.net_in = net_in; a.net_out = net_out; a.hx = hx;
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

template <typename T>
int plan_init(Plan& pl, void* const* weights, const int* tile) {
  int rc;
  const void* acts[N_ACT] = {nullptr, nullptr, pl.cf, pl.hx, pl.rnet, pl.fh};
  for (int i = ACT_CF; i < N_ACT; ++i)
    if ((rc = encode_act<T>(pl, i, acts[i]))) return rc;
  // per convolution: bfloat16 {weight, bias}; float32 {big, small, bias}
  constexpr int per = Elem<T>::SPLIT ? 3 : 2;
  for (int i = 0; i < N_CONV; ++i) {
    const int bn = tile[2 + CONV_STAGE[i]];
    if ((rc = encode_weight<T>(&pl.w[i], i, weights[per * i], bn))) return rc;
    if (Elem<T>::SPLIT &&
        (rc = encode_weight<T>(&pl.ws[i], i, weights[per * i + 1], bn)))
      return rc;
    pl.bias[i] = (const float*)weights[per * i + per - 1];
  }
  return 0;
}

}  // namespace

extern "C" int mfc_raft_plan_bytes(void) { return (int)sizeof(Plan) + 64; }

// Fill `plan` (mfc_raft_plan_bytes() bytes of host memory) for solves at
// B x H8 x W8 in dtype 0 (float32, 3xTF32) or 1 (bfloat16). weights: per
// convolution (c2 f2 cv zr_h q_h zr_v q_v fl1 fl2) the K-major weight
// (taps, N, K) -- float32: its big and its small part -- and the float32
// bias; scratch: {cf = [c2 | f2] (M,256), hx (M,384), r*net (M,128), flow-head
// hidden (M,256)} in the operand type and z (M,128) float32. tile: {R, XS,
// the column-tile width of each of the 8 launches, the cluster size of
// each} from ops/raft_update.py::tile_plan; ERR_PLAN for any other
// (bfloat16: for a plan outside the kernel's limits).
extern "C" int mfc_raft_plan_init(void* plan, void* const* weights,
                                  void* const* scratch, int B, int H8, int W8,
                                  int dtype, const int* tile) {
  Plan& pl = *new (align64(plan)) Plan{};
  pl.dtype = dtype;
  pl.B = B; pl.H8 = H8; pl.W8 = W8; pl.M = B * H8 * W8;
  if (pl.M == 0) return 0;
  if (dtype != DT_F32 && dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    int want[TILE_INTS];
    if (!tile_plan_of(B, H8, W8, want)) return ERR_PLAN;
    for (int i = 0; i < TILE_INTS; ++i)
      if (tile[i] != want[i]) return ERR_PLAN;
  }
  pl.R = tile[0]; pl.XS = tile[1];
  if (pl.R < 1 || pl.XS < 1 || pl.R > MAX_BOX || pl.XS > MAX_BOX ||
      pl.R > H8 || pl.XS > W8 || pl.R * pl.XS > MT)
    return ERR_PLAN;
  pl.tiles_y = (H8 + pl.R - 1) / pl.R;
  pl.tiles_x = (W8 + pl.XS - 1) / pl.XS;
  for (int i = 0; i < N_STAGES; ++i) {
    pl.bn[i] = tile[2 + i];
    pl.cluster[i] = tile[2 + N_STAGES + i];
    if (pl.cluster[i] < 1 || pl.cluster[i] > MAX_CLUSTER ||
        pl.bn[i] != COLUMN_WIDTHS[i])
      return ERR_PLAN;
  }
  // a cluster splits a tile's pipeline steps: never more blocks than steps
  for (int i = 0; i < N_CONV; ++i)
    if (CONV_N[i] % pl.bn[CONV_STAGE[i]] ||
        pl.cluster[CONV_STAGE[i]] >
            CONV_TAPS[i] * CONV_K[i] / (dtype == DT_F32 ? 32 : 64))
      return ERR_PLAN;
  pl.cf = scratch[0];
  pl.hx = scratch[1];
  pl.rnet = scratch[2];
  pl.fh = scratch[3];
  pl.z = (float*)scratch[4];
  return dtype == DT_F32 ? plan_init<float>(pl, weights, tile)
                         : plan_init<__nv_bfloat16>(pl, weights, tile);
}

// One update iteration on the planned shape. inputs: {c1 (M,256), f1
// (M,128), inp (M,128)} in the operand type, {net (M,128), flow (M,2)}
// float32; net_out (M,128), delta (M,2) float32; net_out must not be net.
// fill: 1 writes hx[:, 0:256] = [net | inp] first; 0 when hx already holds
// them (the step before left net' there). M = B*H8*W8 tokens in raster
// order. Returns the first launch error.
extern "C" int mfc_raft_update_tma(void* plan, void* const* inputs,
                                   void* net_out, void* delta, int fill,
                                   void* stream) {
  Plan& pl = *(Plan*)align64(plan);
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.dtype == DT_F32)
    return run_update_tma<float>(pl, inputs, (float*)net_out, (float*)delta,
                                 fill, s);
  return run_update_tma<__nv_bfloat16>(pl, inputs, (float*)net_out,
                                       (float*)delta, fill, s);
}
