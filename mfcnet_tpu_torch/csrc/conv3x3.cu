// Direct 3x3 convolution, stride 1, SAME padding, NHWC, with a fused bias and
// ReLU (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/experimental/conv3x3.py, which holds the plain PyTorch
// version and conv_plan, the one place where the shape picks the
// configuration of the bfloat16 kernel.
//
// Replaces mfcnet_tpu/experimental/conv3x3_pallas.py::conv3x3_pallas
// (_conv3x3_kernel): x (B, H, W, cin), w (3, 3, cin, cout) in x's type,
// bias (cout) float32 or none; out (B, H, W, cout) in x's type; float32
// accumulation. Like the TPU kernel it is an experiment that no model calls.
//
// What bounds it on this card: at 480 x 640 x 64 -> 64 in bfloat16 the 22.6
// GFLOP take 23 us on the tensor cores and the 79 MB of input and output 23
// us of memory time, so both bounds are close; in float32 (plain FMAs) the
// operations bound it.
//
// Design, bfloat16 (conv3x3_core on the core of conv_common.cuh): persistent
// blocks, one column tile of N = 16, 64 or 128 output channels each, whose
// nine-tap weight slice is copied into shared memory once (the tile kernel
// copies it for every 8 x 16-pixel block: 4.5x the input's bytes out of
// L2); the ring tile of a warpgroup's R x 64-pixel tile arrives by TMA, one
// request per 8-channel plane, into that warpgroup's ring of one or two
// stages, with the hardware's zero fill as the padding, or by plain loads
// where 2 cin bytes are no multiple of 16; two consumer warpgroups take
// turns with wgmma over the nine taps, so that one's epilogue (bias, ReLU,
// one rounding, 16-byte stores) overlaps the other's products. Where the
// weights do not fit (cin > 512), conv_plan picks the tile kernel below:
// 8 x 16-pixel blocks on mma.sync, 64 channels of cin at a time.
//
// Design, float32 (conv3x3_kernel, plain FMAs, so that the kernel can be held
// to a float32 tolerance): a block owns 8 x 16 output pixels and 64 output
// channels and walks over cin 32 channels at a time (the bfloat16 tile
// kernel: 64), the ring tile and the nine taps' weight chunk copied into
// shared memory with 16-byte copies (element-wise where cin or cout are not
// multiples of a vector, zeros outside the image and past cin and cout).
//
// The TPU kernel's tap pairing (two taps per product to fill 128 contraction
// lanes), its lane padding and its row bands with explicit DMA answer the
// TPU's matrix unit and are not carried over; any H and W are taken.

#include <cstring>

#include "conv_common.cuh"
#include "shared_memory.cuh"

namespace {

using namespace mfc_conv;

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return (HR * HC * lda_of<T>(Elem<T>::KC) + w_elems<T>()) * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int H,
               int W, int cin, int cout, int relu, int ntn) {
  constexpr int KC = Elem<T>::KC, VEC = Elem<T>::VEC, KV = KC / VEC;
  constexpr int LDA = lda_of<T>(KC);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // HR * HC pixels x LDA
  T* Ws = As + HR * HC * LDA;              // 9 * KC rows x ldb

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int b = blockIdx.z / ntn, n0 = (blockIdx.z % ntn) * BN;
  const bool aligned = (cin % VEC) == 0;

  Acc<T> acc;
  acc.init(tid);
  for (int k0 = 0; k0 < cin; k0 += KC) {
    __syncthreads();  // the previous chunk's products are done
    for (int idx = tid; idx < HR * HC * KV; idx += THREADS) {
      const int pix = idx / KV, v = idx - pix * KV;
      const int hy = pix / HC, hx = pix - hy * HC;
      const int y = ty0 - 1 + hy, xx = tx0 - 1 + hx, k = k0 + v * VEC;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
      const int valid = inside ? min(max(cin - k, 0), VEC) : 0;
      const T* src = x + (((size_t)b * H + min(max(y, 0), H - 1)) * W +
                          min(max(xx, 0), W - 1)) * cin + min(k, cin - 1);
      copy_vec(As + pix * LDA + v * VEC, src, valid, aligned && valid == VEC);
    }
    load_weights(Ws, w, cin, cout, k0, n0, tid);
    __syncthreads();
    acc.product(As, LDA, Ws);
  }
  store_tile(acc, out, bias, relu != 0, b, ty0, tx0, n0, H, W, cout);
}

template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int B,
        int H, int W, int cin, int cout, int relu, cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<conv3x3_kernel<T>>(&limit);
  if (rc != 0) return rc;
  if (smem_bytes<T>() > limit) return -1;
  const int ntn = (cout + BN - 1) / BN;
  const long long gz = (long long)B * ntn;
  if (gz > 65535 || (H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (unsigned)gz);
  conv3x3_kernel<T><<<grid, THREADS, smem_bytes<T>(), stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (T*)out, H, W, cin, cout,
      relu, ntn);
  return (int)cudaGetLastError();
}


// ---- the bfloat16 instance: the Hopper core of conv_common.cuh

struct CoreArgs {
  CUtensorMap xmap;  // TMA loader: x as (cin, W, H, B), box 8 x 66 x (R+2) x 1
  const bf16* x;
  const bf16* w;
  const float* bias;
  bf16* out;
  int H, W, cin, cout, relu;
  int tiles_x, tiles_y;
  Plan plan;
};

// the ring tile's channel groups [k0, k0 + 8 groups) with plain loads, zeros
// outside the image and past cin (the loader where 2 cin bytes are no legal
// TMA stride); a lane issues the loads of four 16-byte runs before it
// stores them
template <int R>
__device__ void fill_ring_plain(unsigned char* dst, const bf16* x, int H,
                                int W, int cin, int groups, int k0, int b,
                                int y0, int x0, int lane) {
  constexpr int PIX = (R + 2) * RING_W, PLANE = plane_bytes(R + 2), U = 4;
  for (int first = lane; first < groups * PIX; first += 32 * U) {
    __align__(16) bf16 e8[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = first + 32 * u, g = idx / PIX, pix = idx - g * PIX;
      const int hy = pix / RING_W, hx = pix - hy * RING_W;
      const int y = y0 - 1 + hy, xx = x0 - 1 + hx, k = k0 + 8 * g;
      const bool inside = idx < groups * PIX && y >= 0 && y < H && xx >= 0 &&
                          xx < W;
      const bf16* src = x + (((size_t)b * H + (inside ? y : 0)) * W +
                             (inside ? xx : 0)) * cin + k;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        e8[u][e] =
            inside && k + e < cin ? src[e] : __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = first + 32 * u, g = idx / PIX, pix = idx - g * PIX;
      if (idx < groups * PIX)
        *reinterpret_cast<uint4*>(dst + g * PLANE + pix * 16) =
            *reinterpret_cast<const uint4*>(e8[u]);
    }
  }
}

template <int N, int R, bool TMA>
__global__ void __launch_bounds__(CORE_THREADS, 1)
conv3x3_core(const __grid_constant__ CoreArgs a) {
  constexpr int PLANE = plane_bytes(R + 2), STAGE = 8 * PLANE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  const Plan& p = a.plan;
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 127u) & ~127u;  // the weights, then the ring
  unsigned char* base_ptr = smem_raw + (base - raw);
  const int kg = p.kpad / 8;
  const unsigned stages = base + (unsigned)(9 * kg * N * 16);
  const int G = p.blocks, blk = blockIdx.x, ct = blockIdx.y;
  const int nchunks = (p.kpad + 63) / 64;  // 64 channels a stage
  // Consumer warpgroup wg owns stages [wg * half, wg * half + half) and
  // takes its fills in the order they are made, so its wait for fill l of
  // a stage finds the barrier at most one phase behind. (With one ring for
  // both, a warpgroup skips the other's fills: once a tile takes two chunks
  // it could wait for a stage two fills ahead of the barrier, whose parity
  // then reads as done.)
  const int half = p.stages / CONSUMER_WGS;
  const int items = (p.tiles - blk + G - 1) / G;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full_bar[i], TMA ? 1 : 32);  // expect_tx, or every lane
      mbar_init(&empty_bar[i], 4);  // one lane of each consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WGS * 4) {
    // ---- producer: fill s is chunk c of the block's tile j, fill l of
    // warpgroup j % 2's ring
    if (TMA && lane != 0) return;
    for (int s = 0; s < items * nchunks; ++s) {
      const int j = s / nchunks, c = s - j * nchunks;
      const int l = (j / CONSUMER_WGS) * nchunks + c;
      const int st = (j % CONSUMER_WGS) * half + l % half;
      if (l >= half) mbar_wait(&empty_bar[st], ((l / half) & 1) ^ 1);
      int b, y0, x0;
      tile_origin(blk + j * G, a.tiles_x, a.tiles_y, R, b, y0, x0);
      const int groups = min(8, (p.kpad - 64 * c) / 8);
      const unsigned dst = stages + (unsigned)(st * STAGE);
      if constexpr (TMA) {
        mbar_expect_tx(&full_bar[st],
                       (unsigned)(groups * (R + 2) * RING_W * 16));
        for (int g = 0; g < groups; ++g)
          tma_load_4d(dst + (unsigned)(g * PLANE), &a.xmap, &full_bar[st],
                      64 * c + 8 * g, x0 - 1, y0 - 1, b);
      } else {
        fill_ring_plain<R>(base_ptr + (dst - base), a.x, a.H, a.W, a.cin,
                           groups, 64 * c, b, y0, x0, lane);
        fence_proxy_async();
        mbar_arrive(&full_bar[st]);
      }
    }
    return;
  }

  // ---- consumers: the column tile's weights once, then warpgroup wg takes
  // every other tile of the block's walk
  const int wg = warp / 4;
  load_kmajor(base_ptr, a.w, 9, a.cin, a.cout, p.kpad, ct * N, N,
              threadIdx.x, CONSUMER_WGS * 128);
  fence_proxy_async();
  named_sync(1, CONSUMER_WGS * 128);
  for (int j = wg; j < items; j += CONSUMER_WGS) {
    int b, y0, x0;
    tile_origin(blk + j * G, a.tiles_x, a.tiles_y, R, b, y0, x0);
    float acc[R][N / 2];
    zero_acc<N, R>(acc);
    for (int c = 0; c < nchunks; ++c) {
      const int l = (j / CONSUMER_WGS) * nchunks + c;
      const int st = wg * half + l % half;
      mbar_wait(&full_bar[st], (l / half) & 1);
      ring_product<N, R>(acc, stages + (unsigned)(st * STAGE), PLANE,
                         min(4, (p.kpad - 64 * c) / 16), base, kg, 8 * c);
      if (lane == 0) mbar_arrive(&empty_bar[st]);
    }
    store_core<N, R>(acc, a.out, a.bias, a.relu != 0, b, y0, x0, ct * N, a.H,
                     a.W, a.cout, threadIdx.x % 128);
  }
}

// x (B, H, W, cin) bf16 as a TMA map: a box is 8 channels x the 66 x (R + 2)
// ring tile of one image, landing as one channel-group plane
int encode_input(CUtensorMap* m, const void* x, int B, int H, int W, int cin,
                 int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_LIBCUDA;
  const cuuint64_t ld = (cuuint64_t)cin * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {ld, ld * W, ld * W * H};
  const cuuint32_t box[4] = {8, (cuuint32_t)RING_W, (cuuint32_t)(rows + 2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)rc;
}

template <int N, int R, bool TMA>
int launch_core(const CoreArgs& a, cudaStream_t st) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<conv3x3_core<N, R, TMA>>(&limit);
  if (rc != 0) return rc;
  if (a.plan.smem_bytes > limit) return -1;
  conv3x3_core<N, R, TMA>
      <<<dim3(a.plan.blocks, a.plan.col_tiles), CORE_THREADS,
         a.plan.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

int run_core(const void* x, const void* w, const void* bias, void* out, int B,
             int H, int W, int cin, int cout, int relu, const int* plan,
             cudaStream_t st) {
  CoreArgs a = {};
  Plan& p = a.plan;
  std::memcpy(&p, plan, sizeof(Plan));
  a.x = (const bf16*)x;
  a.w = (const bf16*)w;
  a.bias = (const float*)bias;
  a.out = (bf16*)out;
  a.H = H; a.W = W; a.cin = cin; a.cout = cout; a.relu = relu;
  // the plan must be the one conv_plan gives this shape: stages, a ring of
  // one or two for each consumer warpgroup
  if (p.rows < 1 || p.n < 16 || p.stages < CONSUMER_WGS ||
      p.stages > MAX_STAGES || p.stages % CONSUMER_WGS != 0)
    return ERR_PLAN;
  a.tiles_x = (W + SEG - 1) / SEG;
  a.tiles_y = (H + p.rows - 1) / p.rows;
  const int kpad = round_up_c(cin, 16);
  const long long smem = 9LL * kpad * p.n * 2 +
                         (long long)p.stages * 8 * plane_bytes(p.rows + 2) +
                         128;
  if (p.kpad != kpad || p.k1pad != 0 ||
      (long long)p.tiles != (long long)B * a.tiles_x * a.tiles_y ||
      p.col_tiles != (cout + p.n - 1) / p.n || p.col_tiles > 65535 ||
      p.blocks < 1 || p.blocks > p.tiles || smem != p.smem_bytes ||
      (p.tma && cin % 8 != 0))
    return ERR_PLAN;
  if (p.tma) {
    const int rc = encode_input(&a.xmap, x, B, H, W, cin, p.rows);
    if (rc != 0) return rc;
  }
  if (p.n == 128 && p.rows == 1)
    return p.tma ? launch_core<128, 1, true>(a, st)
                 : launch_core<128, 1, false>(a, st);
  if (p.n == 64 && p.rows == 2)
    return p.tma ? launch_core<64, 2, true>(a, st)
                 : launch_core<64, 2, false>(a, st);
  if (p.n == 16 && p.rows == 2)
    return p.tma ? launch_core<16, 2, true>(a, st)
                 : launch_core<16, 2, false>(a, st);
  return ERR_PLAN;
}

// the tile kernel in bfloat16, where conv_plan gives it the shape (its plan
// only describes the fixed tiles)
int run_tiles(const void* x, const void* w, const void* bias, void* out,
              int B, int H, int W, int cin, int cout, int relu,
              const int* plan, cudaStream_t st) {
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (p.rows != TH || p.n != BN || p.col_tiles != (cout + BN - 1) / BN ||
      p.tma != 0 || p.tiles != tiles || p.blocks != p.tiles ||
      p.smem_bytes != smem_bytes<bf16>())
    return ERR_PLAN;
  return run<bf16>(x, w, bias, out, B, H, W, cin, cout, relu, st);
}

}  // namespace

// x (B, H, W, cin), w (3, 3, cin, cout), out (B, H, W, cout): float32
// (dtype 0) or bfloat16 (dtype 1), contiguous; bias (cout) float32 or null.
// plan: bfloat16 only, the PLAN_INTS ints of experimental/conv3x3.py::
// conv_plan for this shape (the core, or the tile kernel). Returns
// cudaGetLastError(), -1 when a block may not have the shared memory the
// tiles need, 20002 for a plan that does not fit the shape, 20001 / 10000 +
// CUresult when the TMA map cannot be made.
extern "C" int mfc_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int cin, int cout,
                           int relu, int dtype, const int* plan,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0 || cin == 0 || cout == 0) return 0;
  if (dtype == 0)
    return run<float>(x, w, bias, out, B, H, W, cin, cout, relu, st);
  if (dtype == 1 && plan != nullptr)
    return plan[PLAN_INTS - 1]
               ? run_core(x, w, bias, out, B, H, W, cin, cout, relu, plan, st)
               : run_tiles(x, w, bias, out, B, H, W, cin, cout, relu, plan,
                           st);
  return (int)cudaErrorInvalidValue;
}
