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
// What bounds it on this card: operations. One call at 2 x 30 x 40 tokens is
// 2,580,480 multiply-adds per token x 2400 tokens = 12.4 GFLOP against ~10 MB
// of weights and activations, so the tensor cores set the floor, and the
// eight dependent stages (c2 || f2 -> cv -> z,r -> q -> z,r -> q -> flow1 ->
// flow2) make the step a chain of small products rather than one large one.
// In practice (NVIDIA H100 80GB HBM3, 700 W) two other limits come first: a
// call of four tokens already takes ~0.1 ms, the length of the chain of
// dependent tile steps and launches, and at 38,400 tokens the kernel runs at
// ~90 TFLOP/s, where the tile copies out of L2 (about 19 operations per byte
// staged with 32-token tiles) are the limit. Larger tiles fed by TMA into
// wgmma would lift the second; a single persistent launch the first.
//
// Design:
//   * Every convolution is the same implicit product: out[token, n] =
//     sum over taps, k of x[token shifted by (dy, dx), k] * w[tap][k, n],
//     where a shifted token outside its H8 x W8 image reads zero. One
//     templated kernel computes a 32-token x BN-column tile of it: the
//     shifted, masked 32 x BK input tile and the BK x BN weight tile go
//     through a three-stage shared-memory pipeline (16-byte cp.async copies,
//     zero-filled where the mask fails, two tiles in flight while one is
//     multiplied), are accumulated in float32, and finished by a fused
//     epilogue (bias, ReLU / sigmoid / tanh, the GRU blend, the rounding to
//     the operand type). A stage lasts as long as one block's chain of 18
//     to 36 dependent tile steps, however few tokens there are, so the
//     design shortens the step, not the product: copies in flight ahead of
//     the multiply, copy addresses advanced incrementally, and in the
//     bfloat16 instance the four warps splitting K so that a step is one
//     round of independent fragment products.
//   * The operand type is a template parameter: the bfloat16 instance
//     multiplies on the tensor cores (ldmatrix + mma.sync m16n8k16, no
//     Hopper-only feature), the float32 instance on plain FMAs, so that the
//     kernel can be held to a float32 tolerance.
//   * A concatenated input is read as two segments, never copied: [c2 | f2]
//     for the 3x3, and for the q gate [r*net | inp, y, flow] with the second
//     segment inside the hx buffer. hx = [net | inp | y | flow] keeps the GRU
//     weights' own 384 rows; z and r share one product with columns [z | r]
//     because they share every shifted hx tap.
//   * The stages are ten launches on one stream behind the one C entry point;
//     the intermediates (the largest, hx, is 2400 x 384 x 2 B = 1.8 MB) stay
//     in the 50 MB L2. Channels are padded only to what a fragment needs
//     (126 -> 128, 2 -> 16). The TPU kernel's single program, its 128-lane
//     padding and its VMEM-driven batch chunking are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // tokens per block
constexpr int THREADS = 128;  // four warps
constexpr int NSTAGE = 3;     // shared-memory pipeline depth
constexpr int HID = 128;      // GRU state width
constexpr int HX = 384;       // hx row: net 128 | inp 128 | y 126 | flow 2

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

template <typename T>
struct ConvArgs {
  const T* x0; int ld0; int k0;  // first input segment: rows of ld0, k0 used
  const T* x1; int ld1; int k1;  // second segment (k1 = 0: none)
  const T* w;                    // (taps, k0 + k1, npad)
  const float* bias;             // (npad)
  int npad, tapset, ntaps;
  int M, H8, W8;                 // M = B * H8 * W8 tokens
  int epi;
  T* out; int ldo; int nreal;    // EPI_RELU, EPI_Y: out[g * ldo + n], n < nreal
  const float* flow;             // EPI_Y: (M, 2), written beside y
  float* z;                      // EPI_ZR writes, EPI_Q reads: (M, 128)
  const float* net_in;           // EPI_ZR, EPI_Q: (M, 128)
  T* rnet;                       // EPI_ZR: (M, 128) = r * net
  float* net_out;                // EPI_Q: (M, 128)
  T* hx;                         // EPI_Q: hx[g * 384 + n] = net'
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
template <typename T, int BN>
struct Tile {
  static constexpr int BK = 128 / (int)sizeof(T);  // 128 bytes of K per row
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int LDA = BK + VEC, LDB = BN + VEC, LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static_assert(STAGE_BYTES % 16 == 0 && (A_ELEMS * sizeof(T)) % 16 == 0,
                "16-byte copies and ldmatrix rows need 16-byte alignment");
  // the accumulator staging (one BM x LDC float tile per partial sum)
  // reuses the pipeline's memory
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

// The product of one staged tile pair, accumulated in registers.
template <typename T, int BN>
struct Mma;

// ---- warp-level tensor-core primitives (sm_80+ PTX, nothing Hopper-only)
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

// bfloat16 on the tensor cores. The four warps split K, not the tile: of
// each staged BK = 64 chunk warp w multiplies the 16-wide slice w for the
// whole BM x BN tile, so a step is one round of BM/16 x BN/8 independent
// m16n8k16 products per warp instead of four dependent rounds, and the
// warps' partial sums are added in the epilogue. Operands come from shared
// memory by ldmatrix (transposed for the row-major weight tile).
template <int BN>
struct Mma<__nv_bfloat16, BN> {
  using TL = Tile<__nv_bfloat16, BN>;
  static constexpr int PARTS = THREADS / 32;
  static_assert(TL::BK == 16 * PARTS, "one 16-wide K slice per warp");
  static constexpr int FM = BM / 16, FN = BN / 8;
  float acc[FM][FN][4];
  int warp, lane;

  __device__ void init(int tid) {
    warp = tid / 32;
    lane = tid % 32;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }
  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    const int kk = 16 * warp;
    // lane l addresses row l % 16, column block l / 16 of a 16x16 tile
    const int lrow = lane % 16, lcol = (lane / 16) * 8;
    unsigned fa[FM][4], fb[FN / 2][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      ldmatrix_x4(fa[i], As + (16 * i + lrow) * TL::LDA + kk + lcol);
#pragma unroll
    for (int j = 0; j < FN / 2; ++j)
      ldmatrix_x4_trans(fb[j], Bs + (kk + lrow) * TL::LDB + 16 * j + lcol);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        mma_16816(acc[i][j], fa[i], fb[j / 2][2 * (j % 2)],
                  fb[j / 2][2 * (j % 2) + 1]);
  }
  // partial sums of warp w at Cs + w * BM * LDC; a lane holds rows g and
  // g + 8, columns 2t and 2t + 1 of each 16x8 block (g = lane / 4,
  // t = lane % 4)
  __device__ void store(float* Cs) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        float* p = Cs + (warp * BM + 16 * i + g) * TL::LDC + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * TL::LDC) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
};

// float32 on plain FMAs: thread (tid / 16) owns BM / 8 rows, columns
// tid % 16 + 16 j
template <int BN>
struct Mma<float, BN> {
  using TL = Tile<float, BN>;
  static constexpr int PARTS = 1;
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
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) tap_conv_kernel(ConvArgs<T> a) {
  using TL = Tile<T, BN>;
  constexpr int BK = TL::BK, VEC = TL::VEC;
  constexpr int KV = BK / VEC;               // = 8 vectors per A row
  constexpr int A_PER = BM * KV / THREADS;   // vectors per thread
  constexpr int NV = BN / VEC;               // vectors per B row
  constexpr int B_PER = BK * NV / THREADS;
  static_assert(BM * KV % THREADS == 0 && BK * NV % THREADS == 0,
                "tiles must split over the block");

  extern __shared__ __align__(128) unsigned char smem[];  // smem_bytes()
  auto As = [&](int s) {
    return reinterpret_cast<T*>(smem + s * TL::STAGE_BYTES);
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
  const T* pa0[A_PER];
  const T* pa1[A_PER];
  T* sa[A_PER];
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
    sa[i] = reinterpret_cast<T*>(smem) + row * TL::LDA + akv * VEC;
  }
  const T* pb[B_PER];
  T* sb[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int v = tid + THREADS * i;
    const int brow = v / NV, bv = v % NV;
    pb[i] = a.w + (size_t)brow * a.npad + n0 + bv * VEC;
    sb[i] = reinterpret_cast<T*>(smem) + TL::A_ELEMS + brow * TL::LDB +
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
    const int sofs = s * (TL::STAGE_BYTES / (int)sizeof(T));
    const bool seg0 = ikofs < a.k0;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const T* src =
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

  Mma<T, BN> mma;
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
    float v = a.bias[n];
#pragma unroll
    for (int w = 0; w < Mma<T, BN>::PARTS; ++w)
      v += Cs[(w * BM + r) * TL::LDC + c];
    switch (a.epi) {
      case EPI_RELU:
        if (n < a.nreal)
          a.out[(size_t)g * a.ldo + n] = from_f32<T>(fmaxf(v, 0.0f));
        break;
      case EPI_Y:  // 126 motion channels, then the flow itself
        a.out[(size_t)g * a.ldo + n] = from_f32<T>(
            n < a.nreal ? fmaxf(v, 0.0f) : a.flow[(size_t)g * 2 + n - a.nreal]);
        break;
      case EPI_ZR:
        if (n < HID) {
          a.z[(size_t)g * HID + n] = sigmoidf_(v);
        } else {
          const size_t o = (size_t)g * HID + n - HID;
          a.rnet[o] = from_f32<T>(sigmoidf_(v) * a.net_in[o]);
        }
        break;
      case EPI_Q: {
        const size_t o = (size_t)g * HID + n;
        const float z = a.z[o];
        const float h = (1.0f - z) * a.net_in[o] + z * tanhf(v);
        a.net_out[o] = h;
        a.hx[(size_t)g * HX + n] = from_f32<T>(h);
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

// dynamic shared memory of one block: the pipeline's stages, reused for the
// partial sums
template <typename T, int BN>
constexpr int smem_bytes() {
  using TL = Tile<T, BN>;
  constexpr int pipe = NSTAGE * TL::STAGE_BYTES;
  constexpr int sums = Mma<T, BN>::PARTS * TL::PART_BYTES;
  return pipe > sums ? pipe : sums;
}

template <typename T, int BN>
int launch_conv(const ConvArgs<T>& a, cudaStream_t s) {
  constexpr int bytes = smem_bytes<T, BN>();
  if constexpr (bytes > 48 * 1024) {
    // above 48 KB a kernel has to opt in, once on each device
    constexpr int MAX_DEV = 64;
    static bool allowed[MAX_DEV] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEV || !allowed[dev]) {
      err = cudaFuncSetAttribute(
          tap_conv_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEV) allowed[dev] = true;
    }
  }
  dim3 grid((a.M + BM - 1) / BM, a.npad / BN);
  tap_conv_kernel<T, BN><<<grid, THREADS, bytes, s>>>(a);
  LAUNCH_CHECK();
  return 0;
}

template <typename T>
int run_update(void* const* in, void* const* wt, void* const* sc,
               float* net_out, float* delta, int B, int H8, int W8,
               cudaStream_t s) {
  const int M = B * H8 * W8;
  if (M == 0) return 0;
  const T* c1 = (const T*)in[0];
  const T* f1 = (const T*)in[1];
  const T* inp = (const T*)in[2];
  const float* net = (const float*)in[3];
  const float* flow = (const float*)in[4];
  T* c2 = (T*)sc[0];
  T* f2 = (T*)sc[1];
  T* hx = (T*)sc[2];
  T* rnet = (T*)sc[3];
  T* fh = (T*)sc[4];
  float* z = (float*)sc[5];
  auto W = [&](int i) { return (const T*)wt[2 * i]; };
  auto Bi = [&](int i) { return (const float*)wt[2 * i + 1]; };

  auto conv = [&](const T* x0, int ld0, int k0, const T* x1, int ld1, int k1,
                  int wi, int npad, int tapset, int epi) {
    ConvArgs<T> a = {};
    a.x0 = x0; a.ld0 = ld0; a.k0 = k0;
    a.x1 = x1; a.ld1 = ld1; a.k1 = k1;
    a.w = W(wi); a.bias = Bi(wi);
    a.npad = npad; a.tapset = tapset;
    a.ntaps = tapset == TAPS_3X3 ? 9 : 5;
    a.M = M; a.H8 = H8; a.W8 = W8; a.epi = epi;
    return a;
  };
  int rc;

  {
    const size_t n = (size_t)M * 2 * HID;
    fill_hx_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(net, inp,
                                                                  hx, M);
    LAUNCH_CHECK();
  }
  // motion encoder tail: c2 || f2, then the 3x3 over [c2 | f2] -> y, flow
  {
    ConvArgs<T> a = conv(c1, 256, 256, nullptr, 0, 0, 0, 192, TAPS_3X3,
                         EPI_RELU);
    a.out = c2; a.ldo = 192; a.nreal = 192;
    if ((rc = launch_conv<T, 64>(a, s))) return rc;
  }
  {
    ConvArgs<T> a = conv(f1, 128, 128, nullptr, 0, 0, 1, 64, TAPS_3X3,
                         EPI_RELU);
    a.out = f2; a.ldo = 64; a.nreal = 64;
    if ((rc = launch_conv<T, 64>(a, s))) return rc;
  }
  {
    ConvArgs<T> a = conv(c2, 192, 192, f2, 64, 64, 2, 128, TAPS_3X3, EPI_Y);
    a.out = hx + 2 * HID; a.ldo = HX; a.nreal = 126; a.flow = flow;
    if ((rc = launch_conv<T, 64>(a, s))) return rc;
  }
  // SepConvGRU: horizontal (1x5) then vertical (5x1)
  for (int d = 0; d < 2; ++d) {
    const int tapset = d == 0 ? TAPS_1X5 : TAPS_5X1;
    const float* net_in = d == 0 ? net : net_out;
    {
      ConvArgs<T> a = conv(hx, HX, HX, nullptr, 0, 0, 3 + 2 * d, 2 * HID,
                           tapset, EPI_ZR);
      a.z = z; a.net_in = net_in; a.rnet = rnet;
      if ((rc = launch_conv<T, 64>(a, s))) return rc;
    }
    {
      ConvArgs<T> a = conv(rnet, HID, HID, hx + HID, HX, HX - HID, 4 + 2 * d,
                           HID, tapset, EPI_Q);
      a.z = z; a.net_in = net_in; a.net_out = net_out; a.hx = hx;
      if ((rc = launch_conv<T, 64>(a, s))) return rc;
    }
  }
  // flow head
  {
    ConvArgs<T> a = conv(hx, HX, HID, nullptr, 0, 0, 7, 256, TAPS_3X3,
                         EPI_RELU);
    a.out = fh; a.ldo = 256; a.nreal = 256;
    if ((rc = launch_conv<T, 64>(a, s))) return rc;
  }
  {
    ConvArgs<T> a = conv(fh, 256, 256, nullptr, 0, 0, 8, 16, TAPS_3X3,
                         EPI_DELTA);
    a.delta = delta;
    if ((rc = launch_conv<T, 16>(a, s))) return rc;
  }
  return 0;
}

}  // namespace

// inputs: {c1 (M,256), f1 (M,128), inp (M,128)} in the operand type, {net
// (M,128), flow (M,2)} float32; weights: the 18 packed tensors in the order
// of ops/raft_update.py::_WEIGHT_NAMES (weight, bias, ...); scratch: {c2
// (M,192), f2 (M,64), hx (M,384), r*net (M,128), flow-head hidden (M,256)} in
// the operand type and z (M,128) float32. The three arrays are host arrays of
// device pointers. dtype: 0 float32, 1 bfloat16. M = B*H8*W8 tokens in raster
// order. Returns the first launch error.
extern "C" int mfc_raft_update(void* const* inputs, void* const* weights,
                               void* const* scratch, void* net_out,
                               void* delta, int B, int H8, int W8, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run_update<float>(inputs, weights, scratch, (float*)net_out,
                             (float*)delta, B, H8, W8, s);
  if (dtype == 1)
    return run_update<__nv_bfloat16>(inputs, weights, scratch,
                                     (float*)net_out, (float*)delta, B, H8,
                                     W8, s);
  return (int)cudaErrorInvalidValue;
}
