// The flow warp's maps gradient
// (mfcnet_tpu_torch/csrc/warp.cu::flow_warp_bwd_maps_kernel) with
// %globaltimer stamps, to split one call's time by phase:
// tools/flowk_times.py --phases builds this file with nvcc into build/
// (-I mfcnet_tpu_torch/csrc) and calls it at the trainer's shape. Not part
// of the package; no model calls it.
//
// It includes warp.cu and runs the kernel's own device functions in the
// kernel's order on the same plan; only the stamps are added, by thread 0
// of each of the first STAMP_BLOCKS blocks:
//   stamps[k][block]  ns: at the start (0), after each of the four grid
//                     barriers (1-4: zero, count, scan, bin done) and at
//                     the end (5)
//   longest[block]    ns of the block's longest (tile, channel group)
//                     item, and longest_len[block] that tile's list length

#include "warp.cu"

namespace {

constexpr int STAMP_BLOCKS = 4096;
__device__ unsigned long long stamps[6][STAMP_BLOCKS];
__device__ unsigned long long longest[STAMP_BLOCKS];
__device__ int longest_len[STAMP_BLOCKS];

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool stamper() {
  return threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS;
}

__device__ __forceinline__ void stamp(int k) {
  if (stamper()) stamps[k][blockIdx.x] = now_ns();
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB, BW_BPS)
stamped_maps_kernel(const T* __restrict__ g, const float* __restrict__ flow,
                    int* __restrict__ work, T* __restrict__ out, int B, int C,
                    int H, int W, int gh, int gw, int align_corners,
                    BwdPlan p) {
  extern __shared__ int smem[];
  __shared__ int s_next[2], s_ws[2 * TPB / 32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int ntx = (W + BW_TW - 1) / BW_TW, nt = B * p.tiles;
  const BwWork w = bw_work(work, (size_t)B * H * W, nt);
  stamp(0);
  if (stamper()) longest[blockIdx.x] = longest_len[blockIdx.x] = 0;
  for (int i = blockIdx.x * TPB + tid; i < nt; i += gridDim.x * TPB)
    w.offs[i] = 0;
  if (blockIdx.x == 0 && tid == 0) *w.next = 0;
  grid.sync();
  stamp(1);
  bin_pass<false>(flow, w.coords, w.offs, w.list, B, H, W, gh, gw,
                  align_corners, p.tiles, ntx);
  grid.sync();
  stamp(2);
  if (blockIdx.x == 0) bw_scan(w, nt, p.shared_bytes / 4 - 1, smem, s_ws);
  grid.sync();
  stamp(3);
  bin_pass<true>(flow, w.coords, w.cursor, w.list, B, H, W, gh, gw,
                 align_corners, p.tiles, ntx);
  grid.sync();
  stamp(4);
  const int items = nt * p.groups;
  if (tid == 0) s_next[0] = atomicAdd(w.next, 1);
  __syncthreads();
  for (int k = 0;; k ^= 1) {
    const int item = s_next[k];
    if (item >= items) break;
    const int ask = tid == 0 ? atomicAdd(w.next, 1) : 0;
    const unsigned long long t0 = now_ns();
    bw_item<T, VEC>(item, g, w, out, C, H, W, p, smem, s_ws);
    if (stamper()) {
      const unsigned long long dt = now_ns() - t0;
      if (dt > longest[blockIdx.x]) {
        const int key = item / p.groups;
        longest[blockIdx.x] = dt;
        longest_len[blockIdx.x] = w.offs[key + 1] - w.offs[key];
      }
    }
    if (tid == 0) s_next[k ^ 1] = ask;
    __syncthreads();
  }
  stamp(5);
}

template <typename T, bool VEC>
int launch_stamped(const void* g, const void* flow, void* work, void* out,
                   int B, int C, int H, int W, int gh, int gw,
                   int align_corners, cudaStream_t s) {
  constexpr auto kernel = stamped_maps_kernel<T, VEC>;
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  BwdPlan p;
  if (!bwd_plan_of(B, C, H, W, sms, &p) || p.grid > STAMP_BLOCKS)
    return ERR_PLAN;
  int rc = mfc::allow_shared_memory<kernel>(&limit);
  if (rc != 0) return rc;
  if (p.shared_bytes > limit) return ERR_PLAN;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TPB,
                                                    p.shared_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < BW_BPS) return ERR_PLAN;
  const T* gp = (const T*)g;
  const float* fp = (const float*)flow;
  int* wp = (int*)work;
  T* op = (T*)out;
  void* args[] = {(void*)&gp, (void*)&fp, (void*)&wp, (void*)&op,
                  (void*)&B,  (void*)&C,  (void*)&H,  (void*)&W,
                  (void*)&gh, (void*)&gw, (void*)&align_corners, (void*)&p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.grid),
                                  dim3(TPB), args, p.shared_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stamped_any(const void* g, const void* flow, void* work,
                       void* out, int B, int C, int H, int W, int gh, int gw,
                       int align_corners, cudaStream_t s) {
  if (W % 2 == 0 && (uintptr_t)out % 8 == 0)
    return launch_stamped<T, true>(g, flow, work, out, B, C, H, W, gh, gw,
                                   align_corners, s);
  return launch_stamped<T, false>(g, flow, work, out, B, C, H, W, gh, gw,
                                  align_corners, s);
}

}  // namespace

// mfc_flow_warp_bwd_maps's arguments without the plan (this card's
// warp_bwd_plan is taken); the stamps of the call are read with
// phases_read.
extern "C" int phases_bwd_maps(const void* g, const void* flow, void* work,
                               void* out, int B, int C, int H, int W, int gh,
                               int gw, int align_corners, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_stamped_any<float>(g, flow, work, out, B, C, H, W, gh, gw,
                                     align_corners, s);
  if (dtype == 1)
    return launch_stamped_any<__nv_bfloat16>(g, flow, work, out, B, C, H, W,
                                             gh, gw, align_corners, s);
  return (int)cudaErrorInvalidValue;
}

// the last call's stamps (6 x STAMP_BLOCKS uint64), longest items
// (STAMP_BLOCKS uint64) and their list lengths (STAMP_BLOCKS int32)
extern "C" int phases_read(void* st, void* lg, void* len) {
  cudaError_t e = cudaMemcpyFromSymbol(st, stamps, sizeof(stamps));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(lg, longest, sizeof(longest));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(len, longest_len, sizeof(longest_len));
  return (int)e;
}
