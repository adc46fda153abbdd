// Connected components, hole filling and per-component sums for the
// on-device keypoint decode (Hopper, sm_90a). Plain C interface, bound
// with ctypes by mfcnet_tpu_torch/ops/cc.py, which holds a plain PyTorch
// version of every entry point.
//
// Replaces mfcnet_tpu/ops/cc_pallas.py:
//   mfc_cc_labels           <- _cc_kernel                  (connected_components_pallas)
//   mfc_flood_cc_cid        <- _flood_cc_cid_kernel        (base_stats_pallas)
//   mfc_union_flood_cc_cid  <- _union_flood_cc_cid_kernel  (union_stats_pallas)
//   mfc_onehot_stats        <- _onehot_stats_kernel + the value planes built
//                              around it in base_stats_pallas/union_stats_pallas
//
// What bounds them on this card: not bytes (a 480x640 frame is 0.3 MB of
// int8 in and ~3.7 MB of int32 out) and not arithmetic, but latency:
// union-find walks parent chains one dependent load at a time, and each
// pass over the frame has to end everywhere before the next starts. As
// chains of launches, one pass a launch, the two flood entry points took
// 41 and 13 stream operations and mfc_cc_labels 4; 70-76 % of their time
// went to a per-pixel union-find inside 32x32 tiles in which a tile-wide
// region serialized on its root. The TPU kernels needed log2(W)
// shift-doubling steps per fixpoint iteration because the TPU has no
// gathers; here a pixel reads any neighbour or parent directly. The sums
// of mfc_onehot_stats are bound by contended shared-memory atomics: inside
// one large component every thread of a block adds to the same six slots.
//
// Design:
//   * One CC core, union-find: pixels of the same region join with
//     atomicMin on parents, so a parent index never exceeds its child and
//     every root is its component's minimum flat index -- the TPU labels
//     exactly. A region is a per-pixel int (0 = outside); neighbours join
//     when their values are equal, which covers plain masks, "not class c"
//     flood domains and the class-aware union image. Three steps:
//     union-find inside tiles in shared memory, links across tile borders
//     on the global parents (between tile roots only), then the tile roots
//     compressed to their roots.
//   * Every entry point is one cooperative launch: as many 512-thread
//     blocks as the card holds at once grid-stride over work items, and
//     phases are separated by grid-wide barriers (mfc_flood_cc_cid 8,
//     mfc_union_flood_cc_cid 8, mfc_cc_labels 3, mfc_onehot_stats 2), so
//     a call is one device operation with no memset. The launch plan comes
//     from the caller (ops/cc.py::cc_plan) and is refused unless it is the
//     shape's and the entry point's and the card holds its blocks at once.
//     A tile phase takes one (plane, image,
//     FTILE x FTILE tile) item a block: the union kernel's four flood
//     domains, and its class-aware (h) and relaxed (h2) planes, are
//     separate items, so the floods run side by side on different SMs.
//     A tile's union-find works on row runs: warp ballots find each row's
//     runs, one link joins each pair of touching runs, and the links and
//     run starts are listed and taken one a thread; a tile that is one
//     region, or none, is done at once. In the global planes a pixel that
//     is not its tile part's root stores -(tile root + 1), so later phases
//     find tile roots by sign, only tile roots take part in global links
//     (with path splitting by atomicMin) and compression, and a pixel's
//     root is two loads. Along a tile edge a link is skipped when the
//     previous edge pixel joins the same two tile parts.
//   * Reach: after compression every region pixel on the image border
//     marks its root reached (one atomicOr per root and warp); then one
//     pass, a pixel a thread, gives the unreached bits, he = h*8+e and the
//     conflict flag (or the filled mask), before the next tile phase
//     stages he with a one-pixel halo for the straddle check.
//   * Dense ids = rank of each root in raster order: per 2048-pixel chunk
//     a count of the roots and each root's rank inside its chunk; after a
//     barrier one block an image turns the image's counts into their
//     prefix, in place in global memory (so no block's shared memory
//     grows with B or H*W); after another every pixel gets its root's
//     rank. The enclosing id cide is the id of the largest h root among
//     the outer pixels of each relaxed component (ids follow the roots'
//     raster order): an atomicMax, one per run of equal keys in a warp,
//     beside the prefix, read after the last barrier.
//   * mfc_cc_labels runs the flood kernels' tile core on the mask: tile
//     union-find, links across tile borders, tile roots compressed, then
//     every pixel's root (or H*W) written in place over its tile label.
//   * Per-slot sums: the zeroed (B,6,K) accumulator, then per chunk of
//     pixels the lanes of a warp that share a key (__match_any_sync) sum
//     their six values (__reduce_add_sync) and one of them adds the sums
//     to the block's 6 x K uint64 in shared memory; the block commits each
//     non-zero slot with one global atomic, and the last phase turns the
//     sums into stats and ccls. Ids are dense in raster order, so a warp
//     holds few keys. Every summed value is an integer once w (1 or 0.5)
//     is scaled by 2, so the sums are exact and do not depend on the order
//     of the atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shared_memory.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NROWS = 6;         // summed planes
constexpr int MAX_K = 1024;      // most slots: 6 x K uint64 = 48 KB a block

constexpr int FTILE = 64;        // tile edge of the tile phases
constexpr int FTS = 6;           // log2(FTILE): a tile row is two warps
constexpr int FT = 512;          // threads per block of every kernel
constexpr int FBPS = 2;          // their blocks per SM (__launch_bounds__)
constexpr int CHUNK = 4 * FT;    // pixels per rank chunk and per sums item
constexpr int NPLANES = 7;       // int32 B*H*W planes of the workspace
constexpr int ERR_PLAN = 20001;  // the plan is not this shape's, or the card
                                 // cannot hold its blocks at once

#define LAUNCH_CHECK()                                 \
  do {                                                 \
    cudaError_t err_ = cudaGetLastError();             \
    if (err_ != cudaSuccess) return (int)err_;         \
  } while (0)
#define CUDA_CHECK(call)                               \
  do {                                                 \
    cudaError_t err_ = (call);                         \
    if (err_ != cudaSuccess) return (int)err_;         \
  } while (0)

// ---------------------------------------------------------------- regions
struct MaskRegion {  // foreground of a bool mask
  const uint8_t* m;
  __device__ int operator()(size_t i) const { return m[i] != 0; }
};
struct NotMaskRegion {  // background of a bool mask
  const uint8_t* m;
  __device__ int operator()(size_t i) const { return m[i] == 0; }
};
struct NotClassRegion {  // flood domain of class c in the union image
  const int8_t* u;
  int c;
  __device__ int operator()(size_t i) const { return u[i] != c; }
};
struct IntRegion {  // int32 0/1 mask
  const int* r;
  __device__ int operator()(size_t i) const { return r[i]; }
};
__device__ __forceinline__ int h2_of(int he) {  // contained pixels relaxed
  int h = he >> 3;                              // to their enclosing class
  return h > 4 ? (he & 7) : h;
}
struct HRegion {  // class-aware union image h = he >> 3
  const int* he;
  __device__ int operator()(size_t i) const { return he[i] >> 3; }
};
struct H2Region {
  const int* he;
  __device__ int operator()(size_t i) const { return h2_of(he[i]); }
};

// ------------------------------------------------------------- union-find
__device__ __forceinline__ int find_root(const int* L, int p) {
  const volatile int* V = L;  // parents change under concurrent links
  int q = V[p];
  while (q != p) {
    p = q;
    q = V[p];
  }
  return p;
}

// find with path splitting: each node on the walk is pointed at its
// grandparent by atomicMin, which never raises a parent, so it can undo
// neither a concurrent link nor a compression to the root
__device__ __forceinline__ int find_split(int* L, int p) {
  const volatile int* V = L;
  int q = V[p];
  while (q != p) {
    int g = V[q];
    if (g != q) atomicMin(L + p, g);
    p = q;
    q = g;
  }
  return p;
}

template <bool SPLIT = false>
__device__ void unite(int* L, int a, int b) {
  while (true) {
    a = SPLIT ? find_split(L, a) : find_root(L, a);
    b = SPLIT ? find_split(L, b) : find_root(L, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(L + b, a);
    if (old == b) return;  // b was still a root: linked
    b = old;               // b was linked meanwhile: join a with its parent
  }
}

// ------------------------------------------------------- the flood kernels
// mfc_flood_cc_cid and mfc_union_flood_cc_cid: one cooperative launch each
// (see the design note). Workspace: NPLANES planes of B*H*W ints, then the
// B*nchunks chunk counts.
struct FloodArgs {
  const uint8_t* mask;  // flood: (B,H,W) bool
  const int8_t* ucls;   // union: (B,H,W) int8 in 0..4
  int* cid;
  int* filled;          // flood
  int* he;              // union
  int* cide;            // union
  int* ncomp;
  int* conflict;        // union
  int* work;
  int B, H, W, K, ntx, nty, nchunks;
};

// The tile root of pixel p in a plane written by a tile phase: a pixel
// that is not its tile part's root stores -(tile root + 1); a tile root
// (and a pixel outside the region) stores its parent, >= 0.
__device__ __forceinline__ int tile_root(const int* L, int p) {
  int v = L[p];
  return v < 0 ? -v - 1 : p;
}

// p's root once the tile roots are compressed
__device__ __forceinline__ int root_of(const int* L, int p) {
  return L[tile_root(L, p)];
}

// A tile phase's label of local pixel li (flat index p) from the roots s
// (tile_union_find) of the tile at (x0, y0).
__device__ __forceinline__ int tile_label(const int* s, int li, int p, int x0,
                                          int y0, int W) {
  int r = s[li];
  if (r == li) return p;
  return -((y0 + (r >> FTS)) * W + x0 + (r & (FTILE - 1))) - 1;
}

// Stages N values of a tile into shared memory: get(i) loads value i,
// put(i, v) stores it. A thread issues all its loads before its stores,
// which would otherwise wait for each other (to the compiler a shared
// store may alias a global load).
template <int N, class Get, class Put>
__device__ __forceinline__ void stage(Get get, Put put) {
  constexpr int PER = (N + FT - 1) / FT;
  int v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    int i = threadIdx.x + k * FT;
    v[k] = i < N ? get(i) : 0;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    int i = threadIdx.x + k * FT;
    if (i < N) put(i, v[k]);
  }
}

// Appends v to the warp's segment of a list (*n: the entries so far, the
// same in every lane) for every lane that wants to.
__device__ __forceinline__ void push(uint16_t* seg, int* n, bool want, int v) {
  unsigned m = __ballot_sync(0xffffffffu, want);
  if (want) seg[*n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = v;
  *n += __popc(m);
}

// Union-find of one tile's region in shared memory, by row runs. val(li)
// is the region value of local pixel li (raster order, FTILE a row; 0 or
// less: outside the region, below 0: off the image); s holds FTILE*FTILE
// parents, list 3*FTILE^2
// uint16 of scratch. A pixel starts in its row run (parent: the run's
// first pixel, found by warp ballots, one warp a row); runs of
// neighbouring rows join where they touch, one link per pair of touching
// runs (at the first column of their overlap for 4-connectivity;
// 8-connectivity adds the diagonal touch at either end); then the run
// starts are compressed to their roots. The links and
// the run starts are listed first (each warp in its own segment) and then
// taken one a thread: in a uniform region they all lie in column 0, which
// a pixel-to-thread mapping would give to a few threads in turn. On
// return s[li] is the root of every region pixel, its component's first
// pixel in raster order.
template <class V>
__device__ void tile_union_find(V val, int* s, uint16_t* list, int conn) {
  constexpr int T = FTILE, TT = T * T, NW = FT / 32;
  constexpr int LSEG = 2 * TT / NW, SSEG = TT / NW;  // a warp's segments
  __shared__ int nlink[NW], nstart[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a tile whose pixels on the image (val >= 0) all hold one positive value
  // is one component, rooted at its first pixel; one without a region
  // pixel has nothing to join
  int v0 = val(0);
  bool same = true, any = false;
  for (int li = threadIdx.x; li < TT; li += FT) {
    int v = val(li);
    same = same && (v == v0 || v < 0);
    any = any || v > 0;
  }
  if (__syncthreads_and(same) && v0 > 0) {
    for (int li = threadIdx.x; li < TT; li += FT) s[li] = 0;
    __syncthreads();
    return;
  }
  if (!__syncthreads_or(any)) return;
  for (int ly = warp; ly < T; ly += NW) {
    unsigned long long starts = 0;  // bit x: pixel x of the row starts a run
    for (int j = 0; j < T / 32; ++j) {
      int li = ly * T + j * 32 + lane;
      bool st = j * 32 + lane == 0 || val(li - 1) != val(li);
      starts |= (unsigned long long)__ballot_sync(0xffffffffu, st)
                << (32 * j);
    }
    for (int j = 0; j < T / 32; ++j) {
      int x = j * 32 + lane;
      s[ly * T + x] = ly * T + 63 - __clzll(starts & ((2ull << x) - 1));
    }
  }
  __syncthreads();
  int nl = 0, ns = 0;
  uint16_t* lseg = list + warp * LSEG;
  uint16_t* sseg = list + 2 * TT + warp * SSEG;
  for (int ly = warp; ly < T; ly += NW) {
    for (int j = 0; j < T / 32; ++j) {
      int x = j * 32 + lane, li = ly * T + x, v = val(li);
      bool start = v > 0 && s[li] == li;
      int up = -1, diag = -1;  // li*4 + kind: 0 up, 1 up-left, 2 up-right
      if (v > 0 && ly > 0) {
        bool u = val(li - T) == v;
        if (u && (start || x == 0 || val(li - T - 1) != v)) up = li * 4;
        if (conn == 8 && !u) {  // diagonal touches where up is not in it
          if (start && x > 0 && val(li - T - 1) == v) up = li * 4 + 1;
          if (x < T - 1 && val(li - T + 1) == v) diag = li * 4 + 2;
        }
      }
      push(lseg, &nl, up >= 0, up);
      push(lseg, &nl, diag >= 0, diag);
      push(sseg, &ns, start, li);
    }
  }
  if (lane == 0) {
    nlink[warp] = nl;
    nstart[warp] = ns;
  }
  __syncthreads();
  int links = 0, runs = 0;
  for (int w = 0; w < NW; ++w) {
    links += nlink[w];
    runs += nstart[w];
  }
  for (int k = threadIdx.x; k < links; k += FT) {  // the links, one a thread
    int w = 0, i = k;
    while (i >= nlink[w]) i -= nlink[w++];
    int c = list[w * LSEG + i], li = c >> 2, kind = c & 3;
    unite(s, li, li - T + (kind == 0 ? 0 : kind == 1 ? -1 : 1));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < runs; k += FT) {  // run starts to roots
    int w = 0, i = k;
    while (i >= nstart[w]) i -= nstart[w++];
    int li = list[2 * TT + w * SSEG + i];
    s[li] = find_root(s, li);
  }
  __syncthreads();
  for (int li = threadIdx.x; li < TT; li += FT)
    if (val(li) > 0) s[li] = s[s[li]];
  __syncthreads();
}

// Local pixel of the k-th pixel of a tile's border: the top row, then the
// left column below it, then the right column below it (3*FTILE-2 in
// all; 4-connectivity needs the first 2*FTILE-1 only).
__device__ __forceinline__ void border_pixel(int k, int* lx, int* ly) {
  if (k < FTILE) {
    *lx = k;
    *ly = 0;
  } else if (k < 2 * FTILE - 1) {
    *lx = 0;
    *ly = k - FTILE + 1;
  } else {
    *lx = FTILE - 1;
    *ly = k - 2 * FTILE + 2;
  }
}

// Links of border pixel (lx, ly) of the tile at (x0, y0) into the
// neighbouring tiles, on the global plane Lb (tile labels): left, up and,
// for 8-connectivity, up-left and up-right, where they cross the tile's
// border. A link is skipped when the previous pixel along the edge (the
// one before in the top row, the one above in a column), which makes the
// same kind of link, joins the same two tile parts.
template <class R>
__device__ void border_links(R reg, int* Lb, size_t base, int x0, int y0,
                             int lx, int ly, int H, int W, int conn) {
  int x = x0 + lx, y = y0 + ly;
  if (x >= W || y >= H) return;
  int p = y * W + x;
  int r = reg(base + p);
  if (!r) return;
  bool row = ly == 0;
  bool has_prev = !row || lx > 0;
  int px = row ? x - 1 : x, py = row ? y : y - 1;
  for (int k = 0; k < (conn == 8 ? 4 : 2); ++k) {
    int dx = k == 1 ? 0 : (k == 3 ? 1 : -1);
    int dy = k == 0 ? 0 : -1;
    bool cross = k == 0   ? lx == 0
                 : k == 1 ? ly == 0
                 : k == 2 ? (lx == 0 || ly == 0)
                          : (lx == FTILE - 1 || ly == 0);
    int qx = x + dx, qy = y + dy;
    if (!cross || qx < 0 || qx >= W || qy < 0) continue;
    int q = qy * W + qx;
    if (reg(base + q) != r) continue;
    int tp = tile_root(Lb, p), tq = tile_root(Lb, q);
    int rx = px + dx, ry = py + dy;
    if (has_prev && rx >= 0 && rx < W && ry >= 0 &&
        tile_root(Lb, py * W + px) == tp && tile_root(Lb, ry * W + rx) == tq)
      continue;
    unite<true>(Lb, tp, tq);
  }
}

// Points tile root p of plane Lb (one image) at its root.
__device__ __forceinline__ void compress_tile_root(int* Lb, int p) {
  int v = Lb[p];
  if (v >= 0 && v != p) Lb[p] = find_split(Lb, v);
}

// Sets bit `bit` of reach_b at the root of pixel p of plane Lb (one image,
// tile labels) if `on` (p lies on the image border and in the region);
// one atomicOr per root and warp, whose lanes must all call it.
__device__ __forceinline__ void mark_reached(int* Lb, int p, bool on,
                                             unsigned long long image,
                                             int* reach_b, int bit) {
  int r = on ? find_split(Lb, tile_root(Lb, p)) : -1;
  unsigned same = __match_any_sync(
      0xffffffffu, on ? (image << 32 | (unsigned)r) : ~0ull);
  if (on && (threadIdx.x & 31) == __ffs(same) - 1) atomicOr(reach_b + r, bit);
}

// Exclusive scan of `count` ints of `in` into `out` by the whole block;
// returns the total. warp_tot: FT/32 ints of shared memory.
__device__ int block_exclusive_scan(const int* in, int* out, int count,
                                    int* warp_tot) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int carry = 0;
  for (int s = 0; s < count; s += FT) {
    int i = s + threadIdx.x;
    int v = i < count ? in[i] : 0, incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < FT / 32; ++w) {
      before += w < wid ? warp_tot[w] : 0;
      total += warp_tot[w];
    }
    if (i < count) out[i] = carry + before + incl - v;
    carry += total;
    __syncthreads();
  }
  return carry;
}

// Dense ids, first half (one phase): compresses the tile roots of the
// labelled plane L and of plane L2 (if given), counts the roots (region
// value > 0 and L[p] == p) of every CHUNK-pixel chunk (four consecutive
// pixels a thread, their loads issued together) and stores each root's
// rank inside its chunk in `rank`; resets plane `reset` to -1 (if given).
template <class R>
__device__ void chunk_ranks(R reg, const FloodArgs& a, int* L, int* L2,
                            int* rank, int* counts, int* reset) {
  __shared__ int wtot[FT / 32];
  const int n = a.H * a.W;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int it = blockIdx.x; it < a.B * a.nchunks; it += gridDim.x) {
    int b = it / a.nchunks, ch = it - b * a.nchunks;
    size_t base = (size_t)b * n;
    int* Lb = L + base;
    int p0 = ch * CHUNK + 4 * threadIdx.x, v[4], g[4], cnt = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = p0 + k < n ? Lb[p0 + k] : -1;
      g[k] = p0 + k < n ? reg(base + p0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int p = p0 + k;
      if (p >= n) continue;
      if (v[k] >= 0 && v[k] != p) Lb[p] = find_split(Lb, v[k]);
      if (L2 != nullptr) compress_tile_root(L2 + base, p);
      if (reset != nullptr) reset[base + p] = -1;
      cnt += v[k] == p && g[k] > 0;
    }
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wtot[wid] = incl;
    __syncthreads();
    int r = incl - cnt, total = 0;
    for (int w = 0; w < FT / 32; ++w) {
      r += w < wid ? wtot[w] : 0;
      total += wtot[w];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p0 + k < n && v[k] == p0 + k && g[k] > 0) rank[base + p0 + k] = r++;
    if (threadIdx.x == 0) counts[it] = total;
    __syncthreads();
  }
}

// Dense ids, second half: one block an image turns the image's chunk
// counts into their exclusive prefix, in place, and writes ncomp.
__device__ void chunk_prefix(const FloodArgs& a, int* counts) {
  __shared__ int warp_tot[FT / 32];
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    int* cb = counts + (size_t)b * a.nchunks;
    int total = block_exclusive_scan(cb, cb, a.nchunks, warp_tot);
    if (threadIdx.x == 0) a.ncomp[b] = total;
  }
}

// the dense id of root r of image b (pre_b, rank_b: the image's chunk
// prefix and ranks)
__device__ __forceinline__ int dense_id(const FloodArgs& a, const int* pre_b,
                                        const int* rank_b, int r) {
  return min(pre_b[r / CHUNK] + rank_b[r], a.K - 1);
}

// ---- mfc_flood_cc_cid: planes 0 = background labels (then chunk ranks),
// 1 = reach, 2 = labels of the filled mask
__global__ void __launch_bounds__(FT, FBPS) k_flood_cc_cid(FloodArgs a) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  constexpr int T = FTILE, TT = T * T;
  const int H = a.H, W = a.W, n = H * W, ntile = a.ntx * a.nty;
  const int items = a.B * ntile;
  const size_t Bn = (size_t)a.B * n;
  int* Lbg = a.work;
  int* reach = a.work + Bn;
  int* Lf = a.work + 2 * Bn;
  int* rank = a.work;
  int* counts = a.work + NPLANES * Bn;
  uint16_t* list = (uint16_t*)(sm + TT);  // A, F: the tile's parents first
  uint8_t* sr = (uint8_t*)(list + 3 * TT);
  auto region = [&](int li) { return sr[li] == 0xff ? -1 : (int)sr[li]; };

  // A: union-find of the background (4-connected) inside each tile
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    int y0 = t / a.ntx * T, x0 = t % a.ntx * T;
    size_t base = (size_t)b * n;
    stage<TT>(
        [&](int li) {
          int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
          return y < H && x < W ? (int)!a.mask[base + (size_t)y * W + x]
                                : 0xff;
        },
        [&](int li, int v) { sr[li] = v; });
    __syncthreads();
    tile_union_find(region, sm, list, 4);
    for (int li = threadIdx.x; li < TT; li += FT) {
      int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
      if (y >= H || x >= W) continue;
      int p = y * W + x;
      Lbg[base + p] = sr[li] == 1 ? tile_label(sm, li, p, x0, y0, W) : p;
      reach[base + p] = 0;
    }
    __syncthreads();
  }
  grid.sync();

  // B: background links across tile borders
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    size_t base = (size_t)b * n;
    for (int k = threadIdx.x; k < 2 * T - 1; k += FT) {
      int lx, ly;
      border_pixel(k, &lx, &ly);
      border_links(NotMaskRegion{a.mask}, Lbg + base, base, t % a.ntx * T,
                   t / a.ntx * T, lx, ly, H, W, 4);
    }
  }
  grid.sync();

  // C: tile roots to their roots; background pixels on the image border
  // mark their roots reached
  for (size_t i0 = (size_t)blockIdx.x * FT; i0 < Bn;
       i0 += (size_t)gridDim.x * FT) {
    size_t i = i0 + threadIdx.x;
    bool ok = i < Bn;
    int b = ok ? (int)(i / n) : 0;
    size_t base = (size_t)b * n;
    int p = (int)(i - base), y = p / W, x = p - y * W;
    if (ok) compress_tile_root(Lbg + base, p);
    mark_reached(Lbg + base, p,
                 ok && !a.mask[i] &&
                     (y == 0 || y == H - 1 || x == 0 || x == W - 1),
                 b, reach + base, 1);
  }
  grid.sync();

  // E: filled = mask or an unreached background pixel, one pixel a thread
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    size_t base = i / n * n;
    a.filled[i] = a.mask[i] ||
                  !(reach[base + root_of(Lbg + base, (int)(i - base))] & 1);
  }
  grid.sync();

  // F: union-find of the filled mask (8-connected) inside each tile
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    int y0 = t / a.ntx * T, x0 = t % a.ntx * T;
    size_t base = (size_t)b * n;
    stage<TT>(
        [&](int li) {
          int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
          return y < H && x < W ? a.filled[base + (size_t)y * W + x] : 0xff;
        },
        [&](int li, int v) { sr[li] = v; });
    __syncthreads();
    tile_union_find(region, sm, list, 8);
    for (int li = threadIdx.x; li < TT; li += FT) {
      int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
      if (y >= H || x >= W) continue;
      int p = y * W + x;
      Lf[base + p] = sr[li] == 1 ? tile_label(sm, li, p, x0, y0, W) : p;
    }
    __syncthreads();
  }
  grid.sync();

  // G: filled-mask links across tile borders
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    size_t base = (size_t)b * n;
    for (int k = threadIdx.x; k < 3 * T - 2; k += FT) {
      int lx, ly;
      border_pixel(k, &lx, &ly);
      border_links(IntRegion{a.filled}, Lf + base, base, t % a.ntx * T,
                   t / a.ntx * T, lx, ly, H, W, 8);
    }
  }
  grid.sync();

  // H: compression, roots counted and ranked per chunk
  chunk_ranks(IntRegion{a.filled}, a, Lf, nullptr, rank, counts, nullptr);
  grid.sync();

  // I: the chunk prefix
  chunk_prefix(a, counts);
  grid.sync();

  // J: dense ids
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    int b = (int)(i / n);
    size_t base = (size_t)b * n;
    a.cid[i] = a.filled[i]
                   ? dense_id(a, counts + (size_t)b * a.nchunks, rank + base,
                              root_of(Lf + base, (int)(i - base)))
                   : -1;
  }
}

// ---- mfc_union_flood_cc_cid: planes 0-3 = the labels of the four flood
// domains (then 0 = chunk ranks, 1 = per-root max of the outer roots),
// 4 = reach bits, 5 = class-aware labels (h), 6 = relaxed labels (h2)
__global__ void __launch_bounds__(FT, FBPS) k_union_flood_cc_cid(FloodArgs a) {
  extern __shared__ int sm[];
  __shared__ int flag;
  cg::grid_group grid = cg::this_grid();
  constexpr int T = FTILE, TT = T * T, HT = T + 2;
  const int H = a.H, W = a.W, n = H * W, ntile = a.ntx * a.nty;
  const int items = a.B * ntile;
  const size_t Bn = (size_t)a.B * n;
  int* reach = a.work + 4 * Bn;
  int* Lh = a.work + 5 * Bn;
  int* Lh2 = a.work + 6 * Bn;
  int* rank = a.work;
  int* cmax = a.work + Bn;
  int* counts = a.work + NPLANES * Bn;

  // A: the four floods' union-finds (4-connected, domain u != c) inside
  // the tiles, one (domain, image, tile) item a block
  uint16_t* list = (uint16_t*)(sm + TT);
  int8_t* su = (int8_t*)(list + 3 * TT);
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < a.B; b += FT) a.conflict[b] = 0;
  for (int it = blockIdx.x; it < 4 * items; it += gridDim.x) {
    int c = it / items + 1, b = (it % items) / ntile, t = it % ntile;
    int y0 = t / a.ntx * T, x0 = t % a.ntx * T;
    size_t base = (size_t)b * n;
    stage<TT>(
        [&](int li) {
          int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
          return y < H && x < W ? (int)a.ucls[base + (size_t)y * W + x] : -1;
        },
        [&](int li, int v) { su[li] = (int8_t)v; });
    __syncthreads();
    tile_union_find(
        [&](int li) { return su[li] < 0 ? -1 : (int)(su[li] != c); }, sm,
        list, 4);
    int* Lc = a.work + (c - 1) * Bn + base;
    for (int li = threadIdx.x; li < TT; li += FT) {
      int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
      if (y >= H || x >= W) continue;
      int p = y * W + x;
      Lc[p] = su[li] != c ? tile_label(sm, li, p, x0, y0, W) : p;
      if (c == 1) reach[base + p] = 0;
    }
    __syncthreads();
  }
  grid.sync();

  // B: the four domains' links across tile borders
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    size_t base = (size_t)b * n;
    for (int k = threadIdx.x; k < 4 * (2 * T - 1); k += FT) {
      int c = k / (2 * T - 1), lx, ly;
      border_pixel(k - c * (2 * T - 1), &lx, &ly);
      border_links(NotClassRegion{a.ucls, c + 1}, a.work + c * Bn + base,
                   base, t % a.ntx * T, t / a.ntx * T, lx, ly, H, W, 4);
    }
  }
  grid.sync();

  // C: the four planes' tile roots to their roots; pixels on the image
  // border mark their roots reached in each domain they lie in
  for (size_t i0 = (size_t)blockIdx.x * FT; i0 < Bn;
       i0 += (size_t)gridDim.x * FT) {
    size_t i = i0 + threadIdx.x;
    bool ok = i < Bn;
    int b = ok ? (int)(i / n) : 0;
    size_t base = (size_t)b * n;
    int p = (int)(i - base), y = p / W, x = p - y * W;
    bool border = ok && (y == 0 || y == H - 1 || x == 0 || x == W - 1);
    int uc = ok ? a.ucls[i] : 0;
    for (int c = 0; c < 4; ++c) {
      int* Lb = a.work + c * Bn + base;
      if (ok) compress_tile_root(Lb, p);
      mark_reached(Lb, p, border && uc != c + 1, b, reach + base, 1 << c);
    }
  }
  grid.sync();

  // E: per pixel the unreached bits, he = h*8+e and the conflict of two or
  // more floods missing it (the four domains' loads issued together)
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    int b = (int)(i / n);
    size_t base = (size_t)b * n;
    int p = (int)(i - base), uc = a.ucls[i], tr[4], un = 0;
    for (int c = 0; c < 4; ++c) tr[c] = tile_root(a.work + c * Bn + base, p);
    for (int c = 0; c < 4; ++c) tr[c] = a.work[c * Bn + base + tr[c]];
    for (int c = 0; c < 4; ++c)
      if (uc != c + 1 && !(reach[base + tr[c]] & (1 << c))) un |= 1 << c;
    int e = (un & 1) ? 1 : (un & 2) ? 2 : (un & 4) ? 3 : (un & 8) ? 4 : 0;
    int h = uc > 0 ? (e > 0 ? uc + 4 : uc) : e;
    a.he[i] = h * 8 + e;
    if ((un & (un - 1)) && !a.conflict[b]) atomicOr(a.conflict + b, 1);
  }
  grid.sync();

  // F: the union-finds of h and h2 (8-connected, class-aware) inside the
  // tiles, one (plane, image, tile) item a block, on the tile's he with
  // its halo; the h items check the straddle there
  int* she = sm;            // HT x HT, -1 outside the image
  int* sp = sm + HT * HT;   // TT parents
  list = (uint16_t*)(sp + TT);
  if (threadIdx.x == 0) flag = 0;
  __syncthreads();
  for (int it = blockIdx.x; it < 2 * items; it += gridDim.x) {
    int relaxed = it >= items, b = (it % items) / ntile, t = it % ntile;
    int y0 = t / a.ntx * T, x0 = t % a.ntx * T;
    size_t base = (size_t)b * n;
    stage<HT * HT>(
        [&](int hi) {
          int y = y0 + hi / HT - 1, x = x0 + hi % HT - 1;
          return y >= 0 && y < H && x >= 0 && x < W
                     ? a.he[base + (size_t)y * W + x]
                     : -1;
        },
        [&](int hi, int v) { she[hi] = v; });
    __syncthreads();
    auto halo = [&](int li) {
      return she[((li >> FTS) + 1) * HT + (li & (T - 1)) + 1];
    };
    if (!relaxed) {
      for (int li = threadIdx.x; li < TT; li += FT) {
        int hi = ((li >> FTS) + 1) * HT + (li & (T - 1)) + 1;
        int h = she[hi] >> 3;
        if (h > 4)  // a contained pixel beside an outer pixel of its class
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx)
              if ((dy || dx) && (she[hi + dy * HT + dx] >> 3) == h - 4)
                flag = 1;
      }
      tile_union_find([&](int li) { return halo(li) >> 3; }, sp, list, 8);
    } else {
      tile_union_find(
          [&](int li) {
            int v = halo(li);
            return v < 0 ? -1 : h2_of(v);
          },
          sp, list, 8);
    }
    int* Lp = (relaxed ? Lh2 : Lh) + base;
    for (int li = threadIdx.x; li < TT; li += FT) {
      int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
      if (y >= H || x >= W) continue;
      int v = halo(li), p = y * W + x;
      Lp[p] = (relaxed ? h2_of(v) : v >> 3) > 0
                  ? tile_label(sp, li, p, x0, y0, W)
                  : p;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (flag) atomicOr(a.conflict + b, 1);
      flag = 0;
    }
    __syncthreads();
  }
  grid.sync();

  // G: h and h2 links across tile borders
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    size_t base = (size_t)b * n;
    for (int k = threadIdx.x; k < 2 * (3 * T - 2); k += FT) {
      int which = k >= 3 * T - 2, lx, ly;
      border_pixel(k - which * (3 * T - 2), &lx, &ly);
      int x0 = t % a.ntx * T, y0 = t / a.ntx * T;
      if (which)
        border_links(H2Region{a.he}, Lh2 + base, base, x0, y0, lx, ly, H, W,
                     8);
      else
        border_links(HRegion{a.he}, Lh + base, base, x0, y0, lx, ly, H, W,
                     8);
    }
  }
  grid.sync();

  // H: compression of both planes, h roots counted and ranked per chunk,
  // the per-root maxima reset
  chunk_ranks(HRegion{a.he}, a, Lh, Lh2, rank, counts, cmax);
  grid.sync();

  // I: the chunk prefix; every relaxed root's maximum of the h roots of
  // its outer pixels. Dense ids follow the roots' raster order, so the
  // largest root has the largest id: the maximum needs no id yet.
  chunk_prefix(a, counts);
  for (size_t i0 = (size_t)blockIdx.x * FT; i0 < Bn;
       i0 += (size_t)gridDim.x * FT) {
    size_t i = i0 + threadIdx.x;
    int c = -1, r2 = -1;
    unsigned long long base = 0;
    if (i < Bn) {
      int b = (int)(i / n);
      base = (size_t)b * n;
      int p = (int)(i - base), h = a.he[i] >> 3;
      if (h >= 1 && h <= 4) {
        c = root_of(Lh + base, p);
        r2 = root_of(Lh2 + base, p);
      }
    }
    // the previous pixel in the warp already raised this maximum
    int pr = __shfl_up_sync(0xffffffffu, r2, 1);
    int pc = __shfl_up_sync(0xffffffffu, c, 1);
    unsigned long long pb = __shfl_up_sync(0xffffffffu, base, 1);
    bool same = (threadIdx.x & 31) > 0 && pr == r2 && pc == c && pb == base;
    if (r2 >= 0 && !same && cmax[base + r2] < c)
      atomicMax(cmax + base + r2, c);
  }
  grid.sync();

  // J: dense ids, and the enclosing id of every contained pixel
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    int b = (int)(i / n);
    size_t base = (size_t)b * n;
    const int* pre = counts + (size_t)b * a.nchunks;
    int p = (int)(i - base), h = a.he[i] >> 3, m = -1;
    if (h > 4) m = cmax[base + root_of(Lh2 + base, p)];
    a.cid[i] = h > 0 ? dense_id(a, pre, rank + base, root_of(Lh + base, p))
                     : -1;
    a.cide[i] = m >= 0 ? dense_id(a, pre, rank + base, m) : -1;
  }
}

// ---- mfc_cc_labels: the tile core on a bool mask; lab itself is the
// working plane (tile labels, then roots), so no workspace is needed
struct CcArgs {
  const uint8_t* mask;
  int* lab;
  int B, H, W, conn, ntx, nty;
};

__global__ void __launch_bounds__(FT, FBPS) k_cc_labels(CcArgs a) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  constexpr int T = FTILE, TT = T * T;
  const int H = a.H, W = a.W, n = H * W, ntile = a.ntx * a.nty;
  const int items = a.B * ntile;
  const size_t Bn = (size_t)a.B * n;
  uint16_t* list = (uint16_t*)(sm + TT);
  uint8_t* sr = (uint8_t*)(list + 3 * TT);
  auto region = [&](int li) { return sr[li] == 0xff ? -1 : (int)sr[li]; };

  // A: union-find of the mask inside each tile, one (image, tile) item a
  // block; tile labels into lab
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    int y0 = t / a.ntx * T, x0 = t % a.ntx * T;
    size_t base = (size_t)b * n;
    stage<TT>(
        [&](int li) {
          int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
          return y < H && x < W
                     ? (int)(a.mask[base + (size_t)y * W + x] != 0)
                     : 0xff;
        },
        [&](int li, int v) { sr[li] = v; });
    __syncthreads();
    tile_union_find(region, sm, list, a.conn);
    for (int li = threadIdx.x; li < TT; li += FT) {
      int y = y0 + (li >> FTS), x = x0 + (li & (T - 1));
      if (y >= H || x >= W) continue;
      int p = y * W + x;
      a.lab[base + p] = sr[li] == 1 ? tile_label(sm, li, p, x0, y0, W) : p;
    }
    __syncthreads();
  }
  grid.sync();

  // B: links across tile borders
  const int nborder = a.conn == 8 ? 3 * T - 2 : 2 * T - 1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int b = it / ntile, t = it - b * ntile;
    size_t base = (size_t)b * n;
    for (int k = threadIdx.x; k < nborder; k += FT) {
      int lx, ly;
      border_pixel(k, &lx, &ly);
      border_links(MaskRegion{a.mask}, a.lab + base, base, t % a.ntx * T,
                   t / a.ntx * T, lx, ly, H, W, a.conn);
    }
  }
  grid.sync();

  // C: tile roots to their roots
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    size_t base = i / n * n;
    compress_tile_root(a.lab + base, (int)(i - base));
  }
  grid.sync();

  // D: every pixel its root, or n outside the mask, in place. A pixel reads
  // its own slot, which only it writes, and its tile root's, which after C
  // holds the root and is written back with that same value.
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < Bn;
       i += (size_t)gridDim.x * FT) {
    size_t base = i / n * n;
    a.lab[i] = a.mask[i] ? root_of(a.lab + base, (int)(i - base)) : n;
  }
}

// ------------------------------------------------------------------ stats
struct StatsArgs {
  const int* cid;
  const int* he;
  const int* cide;  // nullptr: no contained pixels
  float* stats;
  int* ccls;
  unsigned long long* acc;  // (B, NROWS, K)
  int B, H, W, K, nchunks;
};

// Adds the NROWS values v of every lane whose key is >= 0 to slot `key` of
// s (NROWS x K): the lanes that share a key sum their values and the first
// of them adds the non-zero sums. Every lane of the warp calls it. A sum
// of 32 lanes stays below 2^32 (see mfc_onehot_stats).
__device__ __forceinline__ void warp_add(unsigned long long* s, int K, int key,
                                         const unsigned (&v)[NROWS]) {
  if (!__any_sync(0xffffffffu, key >= 0)) return;
  unsigned same = __match_any_sync(0xffffffffu, key);
  if (key < 0) return;
  bool first = (threadIdx.x & 31) == __ffs(same) - 1;
#pragma unroll
  for (int r = 0; r < NROWS; ++r) {
    unsigned sum = __reduce_add_sync(same, v[r]);
    if (first && sum) atomicAdd(s + r * K + key, (unsigned long long)sum);
  }
}

// Three phases: the accumulator zeroed; per (image, CHUNK pixels) item the
// warp-aggregated sums into shared memory, committed to the accumulator
// when a block's next item lies in another image and at the end; the sums
// turned into stats and ccls. The blocks grid-stride over the items, which
// spreads a component's chunks over blocks (runs of consecutive items a
// block were slower). A thread takes pixels FT apart, so that a warp holds
// 32 consecutive pixels, and issues the loads of its CHUNK/FT pixels (each
// with its four neighbours' he) before it sums any.
__global__ void __launch_bounds__(FT, FBPS) k_onehot_stats(StatsArgs a) {
  extern __shared__ unsigned long long s[];  // NROWS x K
  cg::grid_group grid = cg::this_grid();
  constexpr int TRIPS = CHUNK / FT;
  const int H = a.H, W = a.W, K = a.K, n = H * W, SK = NROWS * K;
  const size_t BK = (size_t)a.B * K;
  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < BK * NROWS;
       i += (size_t)gridDim.x * FT)
    a.acc[i] = 0ull;
  for (int i = threadIdx.x; i < SK; i += FT) s[i] = 0ull;
  grid.sync();

  int cur = -1;  // the image whose sums shared memory holds
  auto commit = [&]() {
    __syncthreads();
    unsigned long long* g = a.acc + (size_t)cur * SK;
    for (int i = threadIdx.x; i < SK; i += FT) {
      unsigned long long v = s[i];
      if (v) {
        atomicAdd(g + i, v);
        s[i] = 0ull;
      }
    }
    __syncthreads();
  };
  for (int it = blockIdx.x; it < a.B * a.nchunks; it += gridDim.x) {
    int b = it / a.nchunks, ch = it - b * a.nchunks;
    if (b != cur) {
      if (cur >= 0) commit();
      cur = b;
    }
    const size_t base = (size_t)b * n;
    const int* heb = a.he + base;
    const int left = n - ch * CHUNK;  // pixels of the image from the chunk on
    int hv[TRIPS], k1[TRIPS], k2[TRIPS], nb[TRIPS][4];
#pragma unroll
    for (int j = 0; j < TRIPS; ++j) {  // -1: off the image or not counted
      int o = threadIdx.x + j * FT;
      bool on = o < left;
      int p = on ? ch * CHUNK + o : 0;
      int y = p / W, x = p - y * W;
      hv[j] = on ? heb[p] : 0;
      k1[j] = on ? a.cid[base + p] : -1;
      k2[j] = on && a.cide != nullptr ? a.cide[base + p] : -1;
      nb[j][0] = on && y > 0 ? heb[p - W] : -1;
      nb[j][1] = on && y + 1 < H ? heb[p + W] : -1;
      nb[j][2] = on && x > 0 ? heb[p - 1] : -1;
      nb[j][3] = on && x + 1 < W ? heb[p + 1] : -1;
    }
#pragma unroll
    for (int j = 0; j < TRIPS; ++j) {  // the same trips in every lane
      int o = threadIdx.x + j * FT;
      int p = o < left ? ch * CHUNK + o : 0;
      int y = p / W, x = p - y * W;
      int h = hv[j] >> 3;
      bool own = k1[j] >= 0 && h > 0, interior = own;
#pragma unroll
      for (int d = 0; d < 4; ++d) {  // each neighbour in its own component
        int hq = nb[j][d] >> 3, eq = nb[j][d] & 7;
        interior = interior && (hq == h || (h <= 4 && hq > 4 && eq == h));
      }
      unsigned w2 = interior ? 2u : 1u;
      unsigned v[NROWS] = {1u, interior ? 0u : 1u, w2, w2 * x, w2 * y,
                           (unsigned)(h > 4 ? h - 4 : h)};
      warp_add(s, K, own ? k1[j] : -1, v);
      if (a.cide != nullptr) {  // contained: interior of its encloser
        unsigned c[NROWS] = {1u, 0u, 2u, 2u * x, 2u * y,
                             (unsigned)(hv[j] & 7)};
        warp_add(s, K, h > 4 ? k2[j] : -1, c);
      }
    }
  }
  if (cur >= 0) commit();
  grid.sync();

  for (size_t i = (size_t)blockIdx.x * FT + threadIdx.x; i < BK;
       i += (size_t)gridDim.x * FT) {
    size_t b = i / K;
    int k = (int)(i - b * K);
    const unsigned long long* g = a.acc + b * SK;
    float* st = a.stats + b * 8 * K;
    double cnt = (double)g[k];
    st[k] = (float)cnt;
    st[K + k] = (float)(double)g[K + k];
    for (int r = 2; r < 5; ++r)
      st[r * K + k] = (float)((double)g[r * K + k] * 0.5);
    double cls = (double)g[5 * K + k];
    st[5 * K + k] = (float)cls;
    st[6 * K + k] = 0.f;
    st[7 * K + k] = 0.f;
    a.ccls[i] = cnt > 0 ? (int)rint(cls / cnt) : 0;
  }
}

// ------------------------------------------------------------ launch plans
// Dynamic shared memory of a block: the flood kernels' is the larger of the
// union kernel's phase F (he with its halo, the parents, the link and
// run-start lists, 3*FTILE^2 uint16) and the A phases (the parents, the
// lists and the class or mask tile), k_cc_labels' that of an A phase,
// k_onehot_stats' the NROWS x K sums.
constexpr int FLOOD_SHARED_F =
    4 * ((FTILE + 2) * (FTILE + 2) + FTILE * FTILE) + 2 * 3 * FTILE * FTILE;
constexpr int CC_SHARED =
    4 * FTILE * FTILE + 2 * 3 * FTILE * FTILE + FTILE * FTILE;
constexpr int FLOOD_SHARED =
    FLOOD_SHARED_F > CC_SHARED ? FLOOD_SHARED_F : CC_SHARED;

// Whether plan (the 6 ints of ops/cc.py::cc_plan: tile edge, threads, grid,
// dynamic shared bytes, work ints per image, chunk pixels) is the one with
// these tile edge, shared bytes, work ints and chunk.
bool plan_is(const int* plan, int tile, int shared, long long work,
             int chunk) {
  return plan != nullptr && plan[0] == tile && plan[1] == FT &&
         plan[3] == shared && plan[4] == work && plan[5] == chunk;
}

// Launches Kernel(a) cooperatively on plan's grid of FT-thread blocks with
// its dynamic shared bytes: ERR_PLAN unless the card holds all the blocks
// at once, as the grid barriers need.
template <auto Kernel, class Args>
int launch_cooperative(const Args& a, const int* plan, cudaStream_t s) {
  const int grid = plan[2], shared = plan[3];
  int limit = 0, dev = 0, sms = 0, per_sm = 0;
  int rc = mfc::allow_shared_memory<Kernel>(&limit);
  if (rc) return rc;
  if (grid < 1 || shared > limit) return ERR_PLAN;
  CUDA_CHECK(cudaGetDevice(&dev));
  CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, FT,
                                                           shared));
  if (grid > sms * per_sm) return ERR_PLAN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(FT);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // all blocks co-resident
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUDA_CHECK(cudaLaunchKernelEx(&cfg, Kernel, a));
  LAUNCH_CHECK();
  return 0;
}

template <auto Kernel>
int launch_flood(FloodArgs a, const int* plan, cudaStream_t s) {
  if ((size_t)a.B * a.H * a.W == 0) return 0;
  const long long n = (long long)a.H * a.W;
  const long long work = NPLANES * n + (n + CHUNK - 1) / CHUNK;
  if (work >= (1ll << 31) || !plan_is(plan, FTILE, FLOOD_SHARED, work, CHUNK))
    return ERR_PLAN;
  a.nchunks = (int)((n + CHUNK - 1) / CHUNK);
  a.ntx = (a.W + FTILE - 1) / FTILE;
  a.nty = (a.H + FTILE - 1) / FTILE;
  return launch_cooperative<Kernel>(a, plan, s);
}

}  // namespace

// =================================================================== C API
extern "C" {

// mask (B,H,W) bool -> lab (B,H,W) int32: component minimum flat index,
// background H*W; conn 4 or 8; one launch. plan: the 6 ints of
// ops/cc.py::cc_plan(..., entry="cc_labels") for this shape (20001 if it
// is not).
int mfc_cc_labels(const uint8_t* mask, int* lab, int B, int H, int W,
                  int conn, const int* plan, void* stream) {
  if ((size_t)B * H * W == 0) return 0;
  if (conn != 4 && conn != 8) return (int)cudaErrorInvalidValue;
  CcArgs a = {mask, lab, B, H, W, conn, (W + FTILE - 1) / FTILE,
              (H + FTILE - 1) / FTILE};
  if ((long long)H * W >= (1ll << 31) ||
      (long long)B * a.ntx * a.nty >= (1ll << 31) ||
      !plan_is(plan, FTILE, CC_SHARED, 0, 0))
    return ERR_PLAN;
  return launch_cooperative<k_cc_labels>(a, plan, (cudaStream_t)stream);
}

// mask (B,H,W) bool -> cid (-1 outside the filled mask, ids clamped to
// K-1), filled 0/1, ncomp (B,); one launch. work: B * plan[4] ints; plan:
// the 6 ints of ops/cc.py::cc_plan for this shape (20001 if it is not).
int mfc_flood_cc_cid(const uint8_t* mask, int* cid, int* filled, int* ncomp,
                     int* work, int B, int H, int W, int K, const int* plan,
                     void* stream) {
  FloodArgs a = {};
  a.mask = mask;
  a.cid = cid;
  a.filled = filled;
  a.ncomp = ncomp;
  a.work = work;
  a.B = B;
  a.H = H;
  a.W = W;
  a.K = K;
  return launch_flood<k_flood_cc_cid>(a, plan, (cudaStream_t)stream);
}

// ucls (B,H,W) int8 in 0..4 -> cid, he = h*8+e, cide, ncomp (B,),
// conflict (B,) (nonzero = the union image cannot represent the frame);
// one launch. work and plan as for mfc_flood_cc_cid.
int mfc_union_flood_cc_cid(const int8_t* ucls, int* cid, int* he, int* cide,
                           int* ncomp, int* conflict, int* work, int B, int H,
                           int W, int K, const int* plan, void* stream) {
  FloodArgs a = {};
  a.ucls = ucls;
  a.cid = cid;
  a.he = he;
  a.cide = cide;
  a.ncomp = ncomp;
  a.conflict = conflict;
  a.work = work;
  a.B = B;
  a.H = H;
  a.W = W;
  a.K = K;
  return launch_flood<k_union_flood_cc_cid>(a, plan,
                                               (cudaStream_t)stream);
}

// cid, he (B,H,W) int32, cide (B,H,W) int32 or NULL -> stats (B,8,K) f32,
// ccls (B,K) int32; acc: B * plan[4] ints of scratch, the (B,6,K) uint64
// sums; one launch. plan: the 6 ints of ops/cc.py::cc_plan(...,
// entry="onehot_stats", K=K) (20001 if it is not, or K is not in
// 1..MAX_K). 32-bit intermediates: p < H*W < 2^31; a warp's sum of a
// plane is at most 32 lanes x 2*(max(H,W)-1) < 64*max(H,W) < 2^32, which
// the plan requires (at W, H <= 16,384: 2^20).
int mfc_onehot_stats(const int* cid, const int* he, const int* cide,
                     float* stats, int* ccls, unsigned long long* acc, int B,
                     int H, int W, int K, const int* plan, void* stream) {
  if (B == 0) return 0;
  const long long n = (long long)H * W;
  StatsArgs a = {cid, he, cide, stats, ccls, acc, B, H, W, K,
                 (int)((n + CHUNK - 1) / CHUNK)};
  if (K < 1 || K > MAX_K || n >= (1ll << 31) ||
      64ll * (H > W ? H : W) >= (1ll << 32) ||
      (long long)B * a.nchunks >= (1ll << 31) ||
      !plan_is(plan, 0, 8 * NROWS * K, 2 * NROWS * K, CHUNK))
    return ERR_PLAN;
  return launch_cooperative<k_onehot_stats>(a, plan, (cudaStream_t)stream);
}

}  // extern "C"
