// Fused first VGG stage: relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2),
// SAME padding, NHWC (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/experimental/stage1.py, which holds the plain PyTorch
// version.
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
// Design: a block owns 8 x 16 output pixels. It loads the 12 x 20 x cin input
// patch, computes the first convolution on the 10 x 18 ring tile with plain
// FMAs (K = 9 * cin = 27 is too short for a tensor-core fragment to pay; six
// pixels per thread, so that the sums do not wait on one another) into
// shared memory in x's type, zeros where the ring lies outside the image, and
// runs the second convolution from there exactly as conv3x3.cu does, with the
// nine taps' weights staged 64 (bfloat16) or 32 (float32) input channels at a
// time, for 64 output channels at a time. The TPU kernel's im2col patches in
// VMEM, its channel padding 3 -> 8, its pre-overlapped input tiles, its row
// chunks and its two variants answer the TPU's matrix unit and compiler and
// are not carried over; any H and W are taken.

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

}  // namespace

// x (B, H, W, cin), k1 (3, 3, cin, C1), k2 (3, 3, C1, C1), out (B, H, W, C1):
// float32 (dtype 0) or bfloat16 (dtype 1), contiguous; b1, b2 (C1) float32.
// Returns cudaGetLastError(), or -1 when cin and C1 need more shared memory
// than a block may have.
extern "C" int mfc_vgg_stage1(const void* x, const void* k1, const void* b1,
                              const void* k2, const void* b2, void* out, int B,
                              int H, int W, int cin, int C1, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0 || cin == 0 || C1 == 0) return 0;
  if (dtype == 0)
    return run<float>(x, k1, b1, k2, b2, out, B, H, W, cin, C1, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, k1, b1, k2, b2, out, B, H, W, cin, C1, st);
  return (int)cudaErrorInvalidValue;
}
