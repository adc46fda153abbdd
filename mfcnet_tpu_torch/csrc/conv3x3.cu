// Direct 3x3 convolution, stride 1, SAME padding, NHWC, with a fused bias and
// ReLU (Hopper, sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/experimental/conv3x3.py, which holds the plain PyTorch
// version.
//
// Replaces mfcnet_tpu/experimental/conv3x3_pallas.py::conv3x3_pallas
// (_conv3x3_kernel): x (B, H, W, cin), w (3, 3, cin, cout) in x's type,
// bias (cout) float32 or none; out (B, H, W, cout) in x's type; float32
// accumulation. Like the TPU kernel it is an experiment that no model calls.
//
// What bounds it on this card: at 480 x 640 x 64 -> 64 in bfloat16 the 22.6
// GFLOP take 23 us on the tensor cores and the 79 MB of input and output 23 us
// of memory time, so both bounds are close; in float32 (plain FMAs) the
// operations bound it.
//
// Design: see conv_common.cuh. A block owns 8 x 16 output pixels and 64
// output channels, and walks over cin in chunks of 64 (bfloat16) or 32
// (float32) channels: the ring tile of the input and the nine taps' weights
// of that chunk go to shared memory with 16-byte copies (element-wise where
// cin or cout are not multiples of a vector, zeros outside the image and past
// cin and cout), then the nine tap products run from there. The TPU kernel's
// tap pairing (two taps per product to fill 128 contraction lanes), its lane
// padding and its row bands with explicit DMA answer the TPU's matrix unit and
// are not carried over; any H and W are taken.

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

}  // namespace

// x (B, H, W, cin), w (3, 3, cin, cout), out (B, H, W, cout): float32
// (dtype 0) or bfloat16 (dtype 1), contiguous; bias (cout) float32 or null.
// Returns cudaGetLastError(), or -1 when a block may not have the shared
// memory the tiles need.
extern "C" int mfc_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int cin, int cout,
                           int relu, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0 || cin == 0 || cout == 0) return 0;
  if (dtype == 0)
    return run<float>(x, w, bias, out, B, H, W, cin, cout, relu, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w, bias, out, B, H, W, cin, cout, relu, st);
  return (int)cudaErrorInvalidValue;
}
