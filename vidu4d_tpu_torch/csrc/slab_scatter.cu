// Entry -> surfel reduction of the property slab's gradient, hand-written
// for Hopper (sm_90a): out[p, c] = the sum over the live slab rows r with
// ids[r] == p of g[r, c], for c < n_used, in ascending row order; every
// other output element is 0.
//
// Replaces no TPU kernel: the JAX package's reduction is the XLA scatter-add
// of `props[ids]`'s VJP. It is the backward of the slab's row gather
// (ops/rasterize/tile_forward.py: _RowGather), which before this kernel was
// PyTorch's index_add_ over every slab row. The slab holds each tile's
// entries in [tile_start, tile_start + tile_count) and, around them, the
// binning's chunk pads and its sentinel emissions, all with id 0: at 8M
// surfels and 1237 x 822 pixels 40.5M rows, of them ~6.7M live. index_add_
// added every pad's zero gradient row into surfel 0 with float atomics that
// serialise on its 21 addresses, and summed in an order that changes from
// run to run. Here only the live rows are visited, and no float atomic is
// used, so two runs give the same bits, and the CPU's index_add_ (a
// sequential loop over the rows) gives them too.
//
// What bounds it on this card: bytes (a few operations a byte). Each live
// row's id is read twice and its n_used gradient columns once, the surfels'
// segment table about twice, and the (P, 32) output is written once: at the
// static cell's shape ~1.9 GB, ~0.55 ms at 3.35 TB/s.
//
// Design: a segment sum over the surfel-sorted entries, four passes.
//   count (ss_rows<false>): one block per tile over its live rows,
//     cnt[id] += 1 by integer atomics (their order does not change the
//     counts).
//   scan: seg_end = the inclusive cumsum of cnt, surfel p's rows are
//     seg[seg_end[p - 1], seg_end[p]) (plain tensor code in the wrapper).
//   place (ss_rows<true>): the same walk; each row takes a slot of its
//     surfel's segment by an atomic decrement of cnt (which ends at 0), so
//     the rows of a segment lie in any order.
//   sum (ss_sum): kLanes threads a surfel, each owning 8 of the 32 columns
//     (two float4: a row's columns are one 128-byte line, read whole by the
//     surfel's threads). A segment of at most kShort rows is put in
//     ascending order by rank (each row's rank is the count of smaller
//     rows) into shared memory; a longer one (none under the binning, which
//     gives a surfel at most 4 + 16 entries; tests and direct callers may
//     pass any) is sorted in place by the whole block, a bitonic sort over
//     its next power of two. Then the rows are added in that order with
//     plain float32 adds (__fadd_rn, from 0.0f as index_add_ starts from a
//     zero output), and the full 32-column row is written once.
#include <cuda_runtime.h>

namespace vidu4d {

constexpr int kSSThreads = 256;
constexpr int kSSWidth = 32;                 // slab and output row width (floats)
constexpr int kLanes = 4;                    // threads a surfel in ss_sum
constexpr int kLaneCols = kSSWidth / kLanes; // columns a thread: two float4
constexpr int kGroups = kSSThreads / kLanes; // surfels a block in ss_sum
constexpr int kShort = 32;                   // longest segment sorted by rank
constexpr int kAhead = 4;                    // rows read ahead of the adds

// one block per tile: the rows [tile_start, tile_start + tile_count) that lie
// in the slab; ids outside [0, n_props) are skipped (the forward's gather
// has rejected them already)
template <bool kPlace>
__global__ void __launch_bounds__(kSSThreads)
ss_rows(const long long* __restrict__ ids, const int* __restrict__ tile_start,
        const int* __restrict__ tile_count, int n_rows, int n_props, int* __restrict__ cnt,
        const int* __restrict__ seg_end, int* __restrict__ seg) {
  const long long start = tile_start[blockIdx.x];
  const long long r0 = max(start, 0LL);
  const long long r1 = min(start + max(tile_count[blockIdx.x], 0), (long long)n_rows);
  for (long long r = r0 + threadIdx.x; r < r1; r += kSSThreads) {
    const long long id = ids[r];
    if (id < 0 || id >= n_props) continue;
    const int p = (int)id;
    if (kPlace) {
      const int slot = atomicSub(&cnt[p], 1) - 1;
      seg[(p ? seg_end[p - 1] : 0) + slot] = (int)r;
    } else {
      atomicAdd(&cnt[p], 1);
    }
  }
}

// acc += the columns [c0, c0 + 8) of g's row `row` that are below n_used,
// in that order
__device__ __forceinline__ void add_cols(float acc[kLaneCols], const float4 v[2], int c0,
                                         int n_used) {
  const float x[kLaneCols] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
  for (int i = 0; i < kLaneCols; ++i)
    if (c0 + i < n_used) acc[i] = __fadd_rn(acc[i], x[i]);
}

__device__ __forceinline__ void load_cols(float4 v[2], const float* __restrict__ g, int row,
                                          int lane) {
  const float4* src = reinterpret_cast<const float4*>(g + (size_t)row * kSSWidth) + 2 * lane;
  v[0] = src[0];
  v[1] = src[1];
}

__device__ __forceinline__ void store_cols(float* __restrict__ out, int p, int lane,
                                           const float acc[kLaneCols]) {
  float4* dst = reinterpret_cast<float4*>(out + (size_t)p * kSSWidth) + 2 * lane;
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// the sum over rows[0, n) in that order, read kAhead rows ahead
__device__ __forceinline__ void sum_rows(float acc[kLaneCols], const float* __restrict__ g,
                                         const int* rows, int n, int lane, int n_used) {
  if (kLaneCols * lane >= n_used) return;
  int t = 0;
  for (; t + kAhead <= n; t += kAhead) {
    float4 v[kAhead][2];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) load_cols(v[j], g, rows[t + j], lane);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) add_cols(acc, v[j], kLaneCols * lane, n_used);
  }
  for (; t < n; ++t) {
    float4 v[2];
    load_cols(v, g, rows[t], lane);
    add_cols(acc, v, kLaneCols * lane, n_used);
  }
}

// at least 4 blocks an SM: registers for 1024 threads, ~256 surfels in flight
__global__ void __launch_bounds__(kSSThreads, 4)
ss_sum(const float* __restrict__ g, const int* __restrict__ seg_end, int* seg,
       float* __restrict__ out, int n_props, int n_used) {
  __shared__ int sorted[kGroups][kShort];
  __shared__ int long_p[kGroups];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int grp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int p = blockIdx.x * kGroups + grp;
  int b = 0, n = 0;
  if (p < n_props) {
    b = p ? seg_end[p - 1] : 0;
    n = seg_end[p] - b;
  }
  if (n > kShort) {
    if (lane == 0) long_p[atomicAdd(&n_long, 1)] = p;
  } else {
    // rank = the rows before it in ascending order (the tiles' segments
    // are disjoint, so a row comes once; ties would keep slot order)
    for (int u = lane; u < n; u += kLanes) {
      const int v = seg[b + u];
      int rank = 0;
      for (int w = 0; w < n; ++w) {
        const int x = seg[b + w];
        rank += x < v || (x == v && w < u);
      }
      sorted[grp][rank] = v;
    }
  }
  __syncwarp();
  if (p < n_props && n <= kShort) {
    float acc[kLaneCols] = {};
    sum_rows(acc, g, sorted[grp], n, lane, n_used);
    store_cols(out, p, lane, acc);
  }
  __syncthreads();
  // long segments: the block sorts each in place, then one surfel's threads
  // sum it
  for (int i = 0; i < n_long; ++i) {
    const int q = long_p[i];
    const int qb = q ? seg_end[q - 1] : 0;
    const long long qn = seg_end[q] - qb;
    int* s = seg + qb;
    long long np2 = 1;
    while (np2 < qn) np2 <<= 1;
    // bitonic with every exchange ascending: the first step of each merge
    // pairs k-blocks' mirror positions; slots past qn read as +infinity
    for (long long k = 2; k <= np2; k <<= 1) {
      for (long long j = k >> 1; j > 0; j >>= 1) {
        const long long m = j == (k >> 1) ? k - 1 : j;
        for (long long x = threadIdx.x; x < np2; x += kSSThreads) {
          const long long y = x ^ m;
          if (y > x && y < qn) {
            const int a = s[x], c = s[y];
            if (a > c) {
              s[x] = c;
              s[y] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    if (threadIdx.x < kLanes) {
      float acc[kLaneCols] = {};
      sum_rows(acc, g, s, (int)qn, threadIdx.x, n_used);
      store_cols(out, q, threadIdx.x, acc);
    }
    __syncthreads();
  }
}

}  // namespace vidu4d

// The count pass over n_tiles tiles on `stream`: cnt (n_props,) int32,
// zero-filled by the caller, gets each surfel's live rows. ids (n_rows,)
// int64; tile_start / tile_count (n_tiles,) int32. Returns the launch
// error.
extern "C" int vidu4d_slab_count(const long long* ids, const int* tile_start,
                                 const int* tile_count, int* cnt, int n_tiles, int n_rows,
                                 int n_props, void* stream) {
  if (n_tiles <= 0) return 0;
  vidu4d::ss_rows<false><<<n_tiles, vidu4d::kSSThreads, 0, (cudaStream_t)stream>>>(
      ids, tile_start, tile_count, n_rows, n_props, cnt, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The place and sum passes on `stream`, after the count: seg_end (n_props,)
// int32 the inclusive cumsum of cnt; seg scratch of at least seg_end's last
// value ints (n_rows, for tiles whose segments are disjoint); g (n_rows, 32) float32 and out (n_props, 32) float32, 16-byte
// aligned; n_used in [0, 32]. out is written whole; cnt ends at 0. Returns
// the first launch error, or cudaErrorInvalidValue for an n_used out of
// range.
extern "C" int vidu4d_slab_place_sum(const float* g, const long long* ids,
                                     const int* tile_start, const int* tile_count, int* cnt,
                                     const int* seg_end, int* seg, float* out, int n_tiles,
                                     int n_rows, int n_props, int n_used, void* stream) {
  using namespace vidu4d;
  if (n_used < 0 || n_used > kSSWidth) return (int)cudaErrorInvalidValue;
  if (n_props <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tiles > 0) {
    ss_rows<true><<<n_tiles, kSSThreads, 0, s>>>(ids, tile_start, tile_count, n_rows, n_props,
                                                 cnt, seg_end, seg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ss_sum<<<(n_props + kGroups - 1) / kGroups, kSSThreads, 0, s>>>(g, seg_end, seg, out,
                                                                   n_props, n_used);
  return (int)cudaGetLastError();
}
