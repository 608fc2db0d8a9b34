// Split-point reduction out[k] = A[k]^T B[k] for A (batch, n, p) and
// B (batch, n, q), row-major, float32 or float64: a contraction over the
// point axis n into a small p x q output, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. It serves the warp stack's backward: the gradients
// of the bone quaternions (25 x 4, twice a blend) and of the bones'
// rotation matrices (75 x 3), each a sum over 10^4-10^6 points. cuBLAS runs
// these products on a 32 x 32 tile, so the grid is 2-14 blocks of the
// card's 132 SMs and each block walks its 10^5 rows alone.
//
// What bounds it on this card: a row brings (p + q) elements for p * q
// FMAs, far below the ridge, so bytes bound it (3.35 TB/s); the design's
// work is to keep enough of them in flight on every SM.
//
// Design: two passes, no float atomics, so two runs give the same bits.
//   pr_partial: the point axis is cut into `chunks` (the wrapper picks
//     them from the shape: about one wave of resident blocks over the
//     batch), one block per (batch entry, chunk) computing the whole p x q
//     output: at most kPRThreads 4 x 4 thread tiles. The block stages
//     `slab` rows of A and B at a time into shared memory with cp.async of
//     one element, double-buffered: the next slab is in flight while this
//     one is summed. Each thread holds a 4 x 4 register tile of the output
//     and accumulates with an explicit fused multiply-add (__fmaf_rn /
//     __fma_rn: the build's -fmad=false forbids contraction only; the
//     explicit FMA keeps one rounding a term, as a GEMM's FFMA does). The
//     threads beyond one cover of the output form `groups` that take every
//     groups-th row of a slab; their tiles are summed in group order at the
//     end. A block writes its p x q partial (or the output, with one chunk).
//   pr_combine: out = the sum of the chunks' partials in a fixed order: 8
//     lanes an output element each sum every 8th chunk in order, then the
//     8 sums in lane order.

#include <cuda_runtime.h>

namespace vidu4d {

constexpr int kPRThreads = 256;
constexpr int kPRTile = 4;           // a thread's outputs: kPRTile x kPRTile
constexpr int kCombineLanes = 8;     // chunk lanes an output element
constexpr int kCombineCols = kPRThreads / kCombineLanes;

__device__ __forceinline__ float fma_rn(float x, float y, float z) { return __fmaf_rn(x, y, z); }
__device__ __forceinline__ double fma_rn(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// four consecutive elements of shared memory, 16-byte aligned
__device__ __forceinline__ void load4(const float* s, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* s, double v[4]) {
  const double2 x = *reinterpret_cast<const double2*>(s);
  const double2 y = *reinterpret_cast<const double2*>(s + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of rows [r, r + rows) of a row-major matrix of row
// length w into dst (rows x pitch). Element i of the slab is (i / w, i % w);
// a thread steps its (row, column) by kPRThreads = step_rows * w + step_cols
// without a division.
template <typename T>
__device__ __forceinline__ void issue_slab(T* dst, const T* src, int w, int pitch, int r,
                                           int rows, int step_rows, int step_cols) {
  const int total = rows * w;
  int k = threadIdx.x / w, c = threadIdx.x - k * w;
  for (int i = threadIdx.x; i < total; i += kPRThreads) {
    cp_async(dst + k * pitch + c, src + (size_t)(r + k) * w + c);
    k += step_rows;
    c += step_cols;
    if (c >= w) {
      c -= w;
      ++k;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPRThreads)
pr_partial(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ part, int batch,
           int n, int p, int q, int chunks, int rows_per_chunk, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int k = blockIdx.x / chunks, chunk = blockIdx.x - k * chunks;
  // the output's thread tiles, and the row groups
  const int tp_n = (p + kPRTile - 1) / kPRTile, tq_n = (q + kPRTile - 1) / kPRTile;
  const int p_pad = tp_n * kPRTile, q_pad = tq_n * kPRTile;
  const int t_out = tp_n * tq_n;
  const int groups = kPRThreads / t_out;
  const int g = threadIdx.x / t_out, o = threadIdx.x - g * t_out;
  const int tpi = o / tq_n, tqi = o - tpi * tq_n;
  // a slab: rows of A (pitch p_pad) then rows of B (pitch q_pad)
  const int stage = slab * (p_pad + q_pad);

  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const T* ak = a + (size_t)k * n * p;
  const T* bk = b + (size_t)k * n * q;
  const int sa_rows = kPRThreads / p, sa_cols = kPRThreads - sa_rows * p;
  const int sb_rows = kPRThreads / q, sb_cols = kPRThreads - sb_rows * q;
  auto issue = [&](T* dst, int r, int rows) {
    issue_slab(dst, ak, p, p_pad, r, rows, sa_rows, sa_cols);
    issue_slab(dst + slab * p_pad, bk, q, q_pad, r, rows, sb_rows, sb_cols);
    cp_async_commit();
  };

  T acc[kPRTile][kPRTile] = {};
  const int n_slabs = r_end > r_begin ? (r_end - r_begin + slab - 1) / slab : 0;
  if (n_slabs > 0) issue(smem, r_begin, min(slab, r_end - r_begin));
  for (int s = 0; s < n_slabs; ++s) {
    const int r = r_begin + s * slab;
    const int rows = min(slab, r_end - r);
    if (s + 1 < n_slabs) {
      issue(smem + ((s + 1) & 1) * stage, r + slab, min(slab, r_end - r - slab));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (g < groups) {
      const T* as = smem + (s & 1) * stage + kPRTile * tpi;
      const T* bs = smem + (s & 1) * stage + slab * p_pad + kPRTile * tqi;
      for (int row = g; row < rows; row += groups) {
        T ai[kPRTile], bj[kPRTile];
        load4(as + row * p_pad, ai);
        load4(bs + row * q_pad, bj);
#pragma unroll
        for (int i = 0; i < kPRTile; ++i)
#pragma unroll
          for (int j = 0; j < kPRTile; ++j) acc[i][j] = fma_rn(ai[i], bj[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // the groups' tiles, summed into group 0's in group order
  for (int gg = 1; gg < groups; ++gg) {
    if (g == gg) {
#pragma unroll
      for (int i = 0; i < kPRTile; ++i)
#pragma unroll
        for (int j = 0; j < kPRTile; ++j) smem[(i * kPRTile + j) * t_out + o] = acc[i][j];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < kPRTile; ++i)
#pragma unroll
        for (int j = 0; j < kPRTile; ++j) acc[i][j] += smem[(i * kPRTile + j) * t_out + o];
    }
    __syncthreads();
  }
  if (g != 0) return;
  T* dst = part + ((size_t)chunk * batch + k) * p * q;
#pragma unroll
  for (int i = 0; i < kPRTile; ++i) {
    const int pi = kPRTile * tpi + i;
#pragma unroll
    for (int j = 0; j < kPRTile; ++j) {
      const int qj = kPRTile * tqi + j;
      if (pi < p && qj < q) dst[(size_t)pi * q + qj] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPRThreads)
pr_combine(const T* __restrict__ part, T* __restrict__ out, int chunks, int total) {
  __shared__ T sums[kCombineLanes][kCombineCols];
  const int col = threadIdx.x % kCombineCols, lane = threadIdx.x / kCombineCols;
  const int e = blockIdx.x * kCombineCols + col;
  T s = 0;
  if (e < total)
    for (int c = lane; c < chunks; c += kCombineLanes) s += part[(size_t)c * total + e];
  sums[lane][col] = s;
  __syncthreads();
  if (lane == 0 && e < total) {
    T v = sums[0][col];
#pragma unroll
    for (int l = 1; l < kCombineLanes; ++l) v += sums[l][col];
    out[e] = v;
  }
}

template <typename T>
int point_reduce(const T* a, const T* b, T* out, T* part, int batch, int n, int p, int q,
                 int chunks, int slab, int smem, void* stream) {
  if (batch <= 0 || p <= 0 || q <= 0) return 0;
  const int tp_n = (p + kPRTile - 1) / kPRTile, tq_n = (q + kPRTile - 1) / kPRTile;
  const int t_out = tp_n * tq_n;
  const long long stages = 2LL * slab * (tp_n + tq_n) * kPRTile * (long long)sizeof(T);
  const long long tiles =
      kPRThreads / t_out > 1 ? (long long)t_out * kPRTile * kPRTile * sizeof(T) : 0;
  if (chunks < 1 || slab < 1 || t_out > kPRThreads || smem > 48 * 1024 || smem < stages ||
      smem < tiles || (long long)batch * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_chunk = (n + chunks - 1) / chunks;
  pr_partial<T><<<batch * chunks, kPRThreads, smem, s>>>(
      a, b, chunks == 1 ? out : part, batch, n, p, q, chunks, rows_per_chunk, slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int total = batch * p * q;
  pr_combine<T><<<(total + kCombineCols - 1) / kCombineCols, kPRThreads, 0, s>>>(
      part, out, chunks, total);
  return (int)cudaGetLastError();
}

}  // namespace vidu4d

// out (batch, p, q) = the sum over n of a (batch, n, p)^T b (batch, n, q),
// all contiguous, on `stream`; float32 and float64 entry points. The plan
// (chunks, slab rows, dynamic shared bytes) comes from the wrapper
// (ops/point_reduce.plan); part holds chunks x batch x p x q elements when
// chunks > 1. Returns the first launch error, or cudaErrorInvalidValue for
// an output of more than 256 thread tiles or a plan the kernel does not
// take.
extern "C" int vidu4d_point_reduce(const float* a, const float* b, float* out, float* part,
                                   int batch, int n, int p, int q, int chunks, int slab,
                                   int smem, void* stream) {
  return vidu4d::point_reduce(a, b, out, part, batch, n, p, q, chunks, slab, smem, stream);
}

extern "C" int vidu4d_point_reduce_f64(const double* a, const double* b, double* out,
                                       double* part, int batch, int n, int p, int q,
                                       int chunks, int slab, int smem, void* stream) {
  return vidu4d::point_reduce(a, b, out, part, batch, n, p, q, chunks, slab, smem, stream);
}

// resident blocks of pr_partial an SM at `smem` dynamic shared bytes, for
// float32 (f64 = 0) or float64 elements
extern "C" int vidu4d_point_reduce_occupancy(int smem, int f64) {
  int blocks = 0;
  const cudaError_t err =
      f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, vidu4d::pr_partial<double>, vidu4d::kPRThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, vidu4d::pr_partial<float>, vidu4d::kPRThreads, smem);
  return err == cudaSuccess ? blocks : 0;
}
