// Fused first VGG stage: relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2),
// SAME padding, NHWC (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/experimental/stage1.py, which holds the plain PyTorch
// version; experimental/conv3x3.py::stage1_plan picks the configuration of
// the bfloat16 kernel.
//
// Replaces mfcnet_tpu/experimental/stage1_pallas.py::vgg_stage1_pallas
// (_kernel, _kernel_taps): x (B, H, W, cin) with a small cin (3 for images),
// k1 (3, 3, cin, C1), k2 (3, 3, C1, C1) in x's type, b1, b2 (C1) float32;
// out (B, H, W, C1) in x's type. Both convolutions accumulate in float32; the
// intermediate is rounded to x's type; the second convolution's padding ring
// outside the image is zero, not the first convolution's value there. Like the
// TPU kernel it is an experiment that no model calls.
//
// What bounds it on this card: operations, those of the second convolution
// (2 * 9 * C1 * C1 per pixel against 27 * C1 for the first). The intermediate
// (39 MB at 480 x 640 x 64 in bfloat16) never reaches device memory, which
// halves the bytes of the two convolutions run one after the other.
//
// Design, bfloat16 (stage1_core, on the core of conv_common.cuh): a producer
// warpgroup loads each tile's (R + 4) x 68 x cin input patch with plain loads
// (6-byte pixels are no legal TMA stride) into a ring of stages; a consumer
// warpgroup forms the im2col rows of its tile's (R + 2) x 66 ring (K = 9 cin
// padded to 16) and runs the first convolution on wgmma against the resident
// k1, two 64-pixel m-tiles in flight so that one's epilogue (bias, ReLU,
// zeros outside the image, one rounding) overlaps the next one's products;
// the result lands in shared memory in exactly the 8-channel planes that the
// second convolution, conv3x3's core with the resident k2 column tile, reads
// as its A operand. The ring costs 2.06x the first convolution's output rows
// at R = 2, and its padded K of 32 is 1/18 of the second's 576. Both
// weights, the im2col rows and the ring tiles stay in shared memory, which
// takes cin <= 8 and C1 <= 96 (at cin 3); stage1_plan gives the shapes past
// that to the tile kernel below.
//
// Design, tile kernel (stage1_kernel; float32 on plain FMAs, bfloat16 where
// the core does not take the shape): a block owns 8 x 16 output pixels,
// computes the first convolution on its 10 x 18 ring tile in float32 with six
// pixels per thread into shared memory, and runs the second as conv3x3.cu's
// tile kernel does (bfloat16: mma.sync).
//
// The TPU kernel's im2col patches in VMEM, its channel padding 3 -> 8, its
// pre-overlapped input tiles, its row chunks and its two variants answer the
// TPU's matrix unit and compiler and are not carried over; any H and W are
// taken.

#include <cstring>

#include "conv_common.cuh"
#include "shared_memory.cuh"

namespace {

using namespace mfc_conv;

constexpr int PR = HR + 2, PC = HC + 2;  // input patch of the ring tile

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

constexpr int P1 = 6;  // ring-tile pixels per thread in the first convolution
static_assert((HR * HC) % P1 == 0, "pixel groups must tile the ring tile");

// shared memory: the intermediate ring tile in T, then one region that holds
// first the input patch and the first weights as float32 and afterwards one
// chunk of the second weights in T
template <typename T>
__host__ __device__ inline size_t smem_bytes(int cin, int C1) {
  const size_t first =
      ((size_t)round_up(PR * PC * cin, 4) + round_up(9 * cin * C1, 4)) * 4;
  const size_t second = (size_t)w_elems<T>() * sizeof(T);
  const size_t ys = (size_t)HR * HC * lda_of<T>(round_up(C1, Elem<T>::KC)) *
                    sizeof(T);
  return ys + (first > second ? first : second);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stage1_kernel(const T* __restrict__ x, const T* __restrict__ k1,
              const float* __restrict__ b1, const T* __restrict__ k2,
              const float* __restrict__ b2, T* __restrict__ out, int H, int W,
              int cin, int C1) {
  constexpr int KC = Elem<T>::KC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C1p = round_up(C1, KC);
  const int LDY = lda_of<T>(C1p);
  T* ys = reinterpret_cast<T*>(smem_raw);           // HR * HC pixels x LDY
  T* Ws = ys + HR * HC * LDY;                       // after the first conv
  float* xs = reinterpret_cast<float*>(Ws);         // PR * PC * cin
  float* k1s = xs + round_up(PR * PC * cin, 4);     // 9 * cin * C1

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH, b = blockIdx.z;

  // the input patch (two pixels of ring: one per convolution), zeros outside
  // the image; the first weights
  for (int idx = tid; idx < PR * PC * cin; idx += THREADS) {
    const int pix = idx / cin, c = idx - pix * cin;
    const int py = pix / PC, px = pix - py * PC;
    const int y = ty0 - 2 + py, xx = tx0 - 2 + px;
    xs[idx] = (y >= 0 && y < H && xx >= 0 && xx < W)
                  ? to_f32(x[(((size_t)b * H + y) * W + xx) * cin + c])
                  : 0.0f;
  }
  for (int idx = tid; idx < 9 * cin * C1; idx += THREADS)
    k1s[idx] = to_f32(k1[idx]);
  __syncthreads();

  // first convolution on the ring tile: consecutive threads take consecutive
  // channels, and a thread takes P1 consecutive pixels of one channel, so
  // that a weight is read once for P1 independent sums
  for (int idx = tid; idx < (HR * HC / P1) * C1p; idx += THREADS) {
    const int grp = idx / C1p, c = idx - grp * C1p;
    int off[P1];
    bool in[P1];
    float v[P1];
#pragma unroll
    for (int p = 0; p < P1; ++p) {
      const int pix = grp * P1 + p;
      const int hy = pix / HC, hx = pix - hy * HC;
      const int y = ty0 - 1 + hy, xx = tx0 - 1 + hx;
      off[p] = (hy * PC + hx) * cin;
      in[p] = c < C1 && y >= 0 && y < H && xx >= 0 && xx < W;
      v[p] = 0.0f;
    }
    if (c < C1) {
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          const float* xp = xs + (dy * PC + dx) * cin;
          const float* wp = k1s + (dy * 3 + dx) * cin * C1 + c;
          for (int ci = 0; ci < cin; ++ci) {
            const float wv = wp[ci * C1];
#pragma unroll
            for (int p = 0; p < P1; ++p)
              v[p] = fmaf(xp[off[p] + ci], wv, v[p]);
          }
        }
    }
    const float bias = c < C1 ? b1[c] : 0.0f;
#pragma unroll
    for (int p = 0; p < P1; ++p)
      ys[(grp * P1 + p) * LDY + c] =
          from_f32<T>(in[p] ? fmaxf(v[p] + bias, 0.0f) : 0.0f);
  }

  // second convolution from shared memory
  Acc<T> acc;
  acc.init(tid);
  for (int n0 = 0; n0 < C1; n0 += BN) {
    acc.zero();
    for (int k0 = 0; k0 < C1p; k0 += KC) {
      // ys is complete and the first convolution has read its inputs,
      // whose place Ws takes; the previous products are done
      __syncthreads();
      load_weights(Ws, k2, C1, C1, k0, n0, tid);
      __syncthreads();
      acc.product(ys + k0, LDY, Ws);
    }
    store_tile(acc, out, b2, true, b, ty0, tx0, n0, H, W, C1);
  }
}

template <typename T>
int run(const void* x, const void* k1, const void* b1, const void* k2,
        const void* b2, void* out, int B, int H, int W, int cin, int C1,
        cudaStream_t stream) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<stage1_kernel<T>>(&limit);
  if (rc != 0) return rc;
  const size_t bytes = smem_bytes<T>(cin, C1);
  if (bytes > (size_t)limit) return -1;
  if (B > 65535 || (H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  stage1_kernel<T><<<grid, THREADS, bytes, stream>>>(
      (const T*)x, (const T*)k1, (const float*)b1, (const T*)k2,
      (const float*)b2, (T*)out, H, W, cin, C1);
  return (int)cudaGetLastError();
}


// ---- the bfloat16 instance: the Hopper core of conv_common.cuh

constexpr int PATCH_W = SEG + 4;  // input columns of a tile: two rings
constexpr int MAX_K1 = 80;        // the im2col columns a plan may have
// two consumer warpgroups and one producer warpgroup, whose 128 lanes load a
// tile's input patch in one round of loads
constexpr int PRODUCERS = 128;
constexpr int STAGE1_THREADS = CONSUMER_WGS * 128 + PRODUCERS;

struct Stage1Args {
  const bf16* x;
  const bf16* k1;
  const float* b1;
  const bf16* k2;
  const float* b2;
  bf16* out;
  int H, W, cin, C1;
  int tiles_x, tiles_y;
  Plan plan;
};

// Shared memory of a block, in bytes from its 128-byte aligned base: k2's
// column tile (nine taps, c1pad x 64), all of k1 ((k1pad, c1pad): the first
// convolution as one product), per warpgroup the im2col rows of its ring
// tile and the ring tile of the intermediate, then the stages of input
// patches. experimental/conv3x3.py::stage1_plan computes the same.
struct Stage1Layout {
  int w2, w1, a1, y, patch, total;
  __host__ __device__ Stage1Layout(int rows, int cin, int c1pad, int k1pad,
                                   int stages) {
    w2 = 9 * c1pad * SEG * 2;
    w1 = round_up_c(k1pad * c1pad * 2, 128);
    a1 = (k1pad / 8) * round_up_c((rows + 2) * RING_W, 64) * 16;
    y = (c1pad / 8) * plane_bytes(rows + 2);
    patch = round_up_c((rows + 4) * PATCH_W * cin * 2, 128);
    total = w2 + w1 + CONSUMER_WGS * (a1 + y) + stages * patch + 128;
  }
};

// Products of the first convolution for ring pixels [64 mt, 64 mt + 64) and
// intermediate channels [nc, nc + NC): the im2col rows (a1_s, planes of
// a1_plane bytes) times k1 (w1_s, planes of c1pad rows), issued and
// committed, not waited for.
template <int NC>
__device__ __forceinline__ void conv1_issue(float (&acc)[NC / 2], int mt,
                                            unsigned a1_s, int a1_plane,
                                            unsigned w1_s, int c1pad, int nc,
                                            int ksteps) {
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  wgmma_fence();
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t da = smem_desc_plain(
        a1_s + (unsigned)(2 * ks * a1_plane + mt * 64 * 16), a1_plane, 128);
    const uint64_t db = smem_desc_plain(
        w1_s + (unsigned)((2 * ks * c1pad + nc) * 16), c1pad * 16, 128);
    Wgmma<NC>::mma(acc, da, db);
  }
  wgmma_commit();
}

// The first convolution for intermediate channels [nc, nc + NC) over the
// whole ring tile, two m-tiles of 64 ring pixels in flight, so that one's
// epilogue overlaps the next one's products. Epilogue: + b1, ReLU, zero
// where the ring lies outside the image, one rounding, into the ring tile
// ys in the layout the second convolution reads. Every lane reads every
// accumulator on the same path (see store_core).
template <int NC, int R>
__device__ __forceinline__ void conv1_cols(unsigned a1_s, int a1_plane,
                                           unsigned w1_s, int c1pad, int nc,
                                           int ksteps, unsigned char* ys,
                                           const float* b1, int C1, int y0,
                                           int x0, int H, int W, int wtid) {
  constexpr int M1 = (R + 2) * RING_W, PLANE = plane_bytes(R + 2);
  constexpr int MTILES = (M1 + 63) / 64;
  const int wi = wtid / 32, lane = wtid % 32, q = lane % 4;
  float bv[NC / 4];  // b1 of channels nc + 8 j + 2 q + e at 2 j + e
#pragma unroll
  for (int i = 0; i < NC / 4; ++i)
    bv[i] = b1[min(nc + 8 * (i / 2) + 2 * q + i % 2, C1 - 1)];
  float acc[2][NC / 2];
  conv1_issue<NC>(acc[0], 0, a1_s, a1_plane, w1_s, c1pad, nc, ksteps);
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt) {
    if (mt + 1 < MTILES) {
      conv1_issue<NC>(acc[(mt + 1) & 1], mt + 1, a1_s, a1_plane, w1_s, c1pad,
                      nc, ksteps);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    const float(&d)[NC / 2] = acc[mt & 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 64 + wi * 16 + lane / 4 + 8 * h;
      const int hy = m / RING_W, hx = m - hy * RING_W;
      const int y = y0 - 1 + hy, x = x0 - 1 + hx;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int n = nc + 8 * j + 2 * q;
        const float v0 = fmaxf(d[4 * j + 2 * h] + bv[2 * j], 0.0f);
        const float v1 = fmaxf(d[4 * j + 2 * h + 1] + bv[2 * j + 1], 0.0f);
        const unsigned word =
            pack_bf16x2(inside && n < C1 ? v0 : 0.0f,
                        inside && n + 1 < C1 ? v1 : 0.0f);
        if (m < M1)
          *reinterpret_cast<unsigned*>(ys + (n / 8) * PLANE + m * 16 +
                                       (n % 8) * 2) = word;
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(STAGE1_THREADS, 1)
stage1_core(const __grid_constant__ Stage1Args a) {
  constexpr int PLANE = plane_bytes(R + 2), M1 = (R + 2) * RING_W;
  constexpr int M1P = (M1 + 63) / 64 * 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ int koff[MAX_K1];  // im2col column k -> offset in the patch
  const Plan& p = a.plan;
  const int c1pad = p.kpad, k1pad = p.k1pad, cin = a.cin;
  const Stage1Layout L(R, cin, c1pad, k1pad, p.stages);
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 127u) & ~127u;
  unsigned char* bp = smem_raw + (base - raw);
  const int patches = L.w2 + L.w1 + CONSUMER_WGS * (L.a1 + L.y);
  const int G = p.blocks, blk = blockIdx.x, ct = blockIdx.y;
  const int items = (p.tiles - blk + G - 1) / G;
  const int warp = warp_index();
  // consumer warpgroup wg owns stages [wg * half, wg * half + half), one
  // tile a fill (see conv3x3_core)
  const int half = p.stages / CONSUMER_WGS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full_bar[i], PRODUCERS);  // every producer thread
      mbar_init(&empty_bar[i], 1);  // the consuming warpgroup, once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = threadIdx.x; k < k1pad; k += blockDim.x) {
    const int tap = k / cin, ci = k - tap * cin;
    koff[k] = k < 9 * cin ? ((tap / 3) * PATCH_W + tap % 3) * cin + ci : -1;
  }
  __syncthreads();

  if (warp >= CONSUMER_WGS * 4) {
    // ---- producer: the (R + 4) x 68 x cin input patch of tile j, zeros
    // outside the image, with plain loads (6-byte pixels are no TMA stride)
    const int ptid = threadIdx.x - CONSUMER_WGS * 128;
    for (int j = 0; j < items; ++j) {
      const int l = j / CONSUMER_WGS;
      const int st = (j % CONSUMER_WGS) * half + l % half;
      if (l >= half) mbar_wait(&empty_bar[st], ((l / half) & 1) ^ 1);
      int b, y0, x0;
      tile_origin(blk + j * G, a.tiles_x, a.tiles_y, R, b, y0, x0);
      bf16* patch = reinterpret_cast<bf16*>(bp + patches + st * L.patch);
      // a lane issues the loads of U elements before it stores them
      constexpr int U = 16;
      const int n = (R + 4) * PATCH_W * cin;
      for (int first = ptid; first < n; first += PRODUCERS * U) {
        bf16 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = first + PRODUCERS * u;
          const int pix = idx / cin, ci = idx - pix * cin;
          const int py = pix / PATCH_W, px = pix - py * PATCH_W;
          const int y = y0 - 2 + py, xx = x0 - 2 + px;
          v[u] = idx < n && y >= 0 && y < a.H && xx >= 0 && xx < a.W
                     ? a.x[(((size_t)b * a.H + y) * a.W + xx) * cin + ci]
                     : __float2bfloat16_rn(0.0f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (first + PRODUCERS * u < n) patch[first + PRODUCERS * u] = v[u];
      }
      mbar_arrive(&full_bar[st]);
    }
    return;
  }

  // ---- consumers
  const int wg = warp / 4, wtid = threadIdx.x % 128;
  unsigned char* a1 = bp + L.w2 + L.w1 + wg * (L.a1 + L.y);
  unsigned char* ys = a1 + L.a1;
  const unsigned a1_s = base + (unsigned)(a1 - bp);
  const unsigned y_s = base + (unsigned)(ys - bp);
  const int a1_plane = M1P * 16;
  // k2's column tile (intermediate channels as k) and all of k1 (the 9 cin
  // im2col columns as k), once
  load_kmajor(bp, a.k2, 9, a.C1, a.C1, c1pad, ct * SEG, SEG, threadIdx.x,
              CONSUMER_WGS * 128);
  load_kmajor(bp + L.w2, a.k1, 1, 9 * cin, a.C1, k1pad, 0, c1pad,
              threadIdx.x, CONSUMER_WGS * 128);
  fence_proxy_async();
  named_sync(1, CONSUMER_WGS * 128);

  for (int j = wg; j < items; j += CONSUMER_WGS) {
    int b, y0, x0;
    tile_origin(blk + j * G, a.tiles_x, a.tiles_y, R, b, y0, x0);
    const int l = j / CONSUMER_WGS, st = wg * half + l % half;
    mbar_wait(&full_bar[st], (l / half) & 1);
    named_sync(2 + wg, 128);  // the previous tile is done with a1 and ys
    // im2col rows: row m is ring pixel (m / 66, m % 66), column k = (3 dy +
    // dx) cin + ci its input at tap (dy, dx), at koff[k] past the pixel's
    // own place in the patch; zeros past the ring and past 9 cin. The trip
    // count, (k1pad / 8) * M1P / 128, is the same for every thread.
    const bf16* patch =
        reinterpret_cast<const bf16*>(bp + patches + st * L.patch);
    for (int it = 0; it < (k1pad / 8) * M1P / 128; ++it) {
      const int idx = it * 128 + wtid, g = idx / M1P, m = idx - g * M1P;
      const int hy = m / RING_W, hx = m - hy * RING_W;
      const int at = (hy * PATCH_W + hx) * cin;
      __align__(16) bf16 e8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // loads on every lane, then selects
        const int off = koff[8 * g + e];
        const bool ok = m < M1 && off >= 0;
        const bf16 v = patch[ok ? at + off : 0];
        e8[e] = ok ? v : __float2bfloat16_rn(0.0f);
      }
      *reinterpret_cast<uint4*>(a1 + (size_t)g * a1_plane + m * 16) =
          *reinterpret_cast<const uint4*>(e8);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (wtid == 0) mbar_arrive(&empty_bar[st]);  // the patch has been read
    // the first convolution on the tensor cores, 64 ring pixels at a time
    {
      int nc = 0;
      for (; nc + 64 <= c1pad; nc += 64)
        conv1_cols<64, R>(a1_s, a1_plane, base + L.w2, c1pad, nc, k1pad / 16,
                          ys, a.b1, a.C1, y0, x0, a.H, a.W, wtid);
      for (; nc < c1pad; nc += 16)
        conv1_cols<16, R>(a1_s, a1_plane, base + L.w2, c1pad, nc, k1pad / 16,
                          ys, a.b1, a.C1, y0, x0, a.H, a.W, wtid);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    // the second convolution from the ring tile, as conv3x3's core
    float acc[R][SEG / 2];
    zero_acc<SEG, R>(acc);
    ring_product<SEG, R>(acc, y_s, PLANE, c1pad / 16, base, c1pad / 8, 0);
    store_core<SEG, R>(acc, a.out, a.b2, true, b, y0, x0, ct * SEG, a.H, a.W,
                       a.C1, wtid);
  }
}

template <int R>
int launch_core(const Stage1Args& a, cudaStream_t st) {
  int limit = 0;
  const int rc = mfc::allow_shared_memory<stage1_core<R>>(&limit);
  if (rc != 0) return rc;
  if (a.plan.smem_bytes > limit) return -1;
  stage1_core<R><<<dim3(a.plan.blocks, a.plan.col_tiles), STAGE1_THREADS,
                   a.plan.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

int run_core(const void* x, const void* k1, const void* b1, const void* k2,
             const void* b2, void* out, int B, int H, int W, int cin, int C1,
             const int* plan, cudaStream_t st) {
  Stage1Args a = {};
  Plan& p = a.plan;
  std::memcpy(&p, plan, sizeof(Plan));
  a.x = (const bf16*)x;
  a.k1 = (const bf16*)k1;
  a.b1 = (const float*)b1;
  a.k2 = (const bf16*)k2;
  a.b2 = (const float*)b2;
  a.out = (bf16*)out;
  a.H = H; a.W = W; a.cin = cin; a.C1 = C1;
  // the plan must be the one stage1_plan gives this shape: stages, a ring
  // of one or two for each consumer warpgroup
  if (p.rows < 1 || p.rows > 2 || p.stages < CONSUMER_WGS ||
      p.stages > MAX_STAGES || p.stages % CONSUMER_WGS != 0)
    return ERR_PLAN;
  a.tiles_x = (W + SEG - 1) / SEG;
  a.tiles_y = (H + p.rows - 1) / p.rows;
  const Stage1Layout L(p.rows, cin, round_up_c(C1, 16),
                       round_up_c(9 * cin, 16), p.stages);
  if (p.n != SEG || p.tma != 0 || p.kpad != round_up_c(C1, 16) ||
      p.k1pad != round_up_c(9 * cin, 16) ||
      (long long)p.tiles != (long long)B * a.tiles_x * a.tiles_y ||
      p.col_tiles != (C1 + SEG - 1) / SEG || p.col_tiles > 65535 ||
      p.blocks < 1 || p.blocks > p.tiles || L.total != p.smem_bytes ||
      p.k1pad > MAX_K1)
    return ERR_PLAN;
  return p.rows == 2 ? launch_core<2>(a, st) : launch_core<1>(a, st);
}

// the tile kernel in bfloat16, where stage1_plan gives it the shape (its
// plan only describes the fixed tiles)
int run_tiles(const void* x, const void* k1, const void* b1, const void* k2,
              const void* b2, void* out, int B, int H, int W, int cin, int C1,
              const int* plan, cudaStream_t st) {
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  const long long tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (p.rows != TH || p.n != round_up(C1, BN) || p.col_tiles != 1 ||
      p.tma != 0 || p.tiles != tiles || p.blocks != p.tiles ||
      (size_t)p.smem_bytes != smem_bytes<bf16>(cin, C1))
    return ERR_PLAN;
  return run<bf16>(x, k1, b1, k2, b2, out, B, H, W, cin, C1, st);
}

}  // namespace

// x (B, H, W, cin), k1 (3, 3, cin, C1), k2 (3, 3, C1, C1), out (B, H, W, C1):
// float32 (dtype 0) or bfloat16 (dtype 1), contiguous; b1, b2 (C1) float32.
// plan: bfloat16 only, the PLAN_INTS ints of experimental/conv3x3.py::
// stage1_plan for this shape (the core, or the tile kernel). Returns
// cudaGetLastError(), -1 when cin and C1 need more shared memory than a block
// may have, 20002 for a plan that does not fit the shape.
extern "C" int mfc_vgg_stage1(const void* x, const void* k1, const void* b1,
                              const void* k2, const void* b2, void* out, int B,
                              int H, int W, int cin, int C1, int dtype,
                              const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0 || cin == 0 || C1 == 0) return 0;
  if (dtype == 0)
    return run<float>(x, k1, b1, k2, b2, out, B, H, W, cin, C1, st);
  if (dtype == 1 && plan != nullptr)
    return plan[PLAN_INTS - 1]
               ? run_core(x, k1, b1, k2, b2, out, B, H, W, cin, C1, plan, st)
               : run_tiles(x, k1, b1, k2, b2, out, B, H, W, cin, C1, plan,
                           st);
  return (int)cudaErrorInvalidValue;
}
