// Analytic backward of the tile compositor (tile_forward.cu), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel vidu4d_tpu/ops/rasterize/pallas_backward.py:
// _make_bwd_kernel (launched by backward_pallas, :380-441): per-entry
// gradients of the 21 + n_extra used slab columns, with T-before rebuilt by
// division from T_fin, suffix sums for the alpha gradient, and the totals
// form of the distortion (S1, S2, A = 1 - T_fin are forward residuals).
//
// What bounds it on this card: instruction issue. Per (entry, pixel) ~130
// FLOPs of gradient chain, and per (entry, warp) a reduce-scatter of the
// 21 + n_extra column values over the warp's 32 pixels (32 shuffles, 32
// adds, ~60 selects); bytes are a small share. As in the forward, one block
// per tile made the launch a single wave timed by the densest tile on one
// SM.
//
// Design: the forward's work list over count_eff = min(count, the tile's
// largest n_contrib) (tile_common.cuh), one block per item, two passes.
// Everything is restricted to rank < n_contrib per pixel, which reproduces
// the forward's stop with no further logic.
//   B1 tile_bwd_transmit: per item that is not its tile's first and per
//      pixel, P = product of (1 - alpha) over the included entries and
//      L = sum gw_j * alpha_j * prod_{i<j in item} (1 - alpha_i), so that
//      the item's share of the suffix sum is T_start * L.
//   B2 tile_bwd_grad: per item, walking the tile's later items back to
//      front, T_start = T_after / P (division, as the reference rebuilds
//      T) and S += T_start * L, which gives T and S at the item's end; then
//      the reference's back-to-front walk over the item's entries, 32 slab
//      rows per step, staged by TMA into a two-stage ring. Each entry's
//      column sums are a two-half warp reduce-scatter (16 columns each, so
//      only 16 values are live at once) of the sums over each thread's
//      pixels, and a shared-memory pass over the warp partials, written as
//      the entry's grad row. Every entry belongs
//      to exactly one item, so there are no atomics; the entry -> splat
//      reduction over the live rows is slab_scatter.cu's segment sum.
//
// cot  (T, tile^2, 10 + n_extra): gC(3) gD gA gN(3) gBGdot gDist gX(n_extra)
// resid(T, tile^2, 4):            T_fin, n_contrib, S1, S2
// grad (E, 32): rows of the entries below count_eff are overwritten; the
//               caller zero-fills it.
#include "tile_common.cuh"

namespace vidu4d {

constexpr int kGroup = 32;  // slab rows per staged step of the gradient walk

// dynamic shared memory of B2: the row ring, the warp partials, gX
template <int TILE>
struct GradSmem {
  static constexpr int kWarps = TileShape<TILE>::kThreads / 32;
  static constexpr int kFloats = 2 * kGroup * kF + kWarps * kGroup * kF;
  static constexpr int kMaxBytes =
      (kFloats + kMaxExtra * TileShape<TILE>::kPix) * (int)sizeof(float);
};

// sum over a thread's N pixels of f(j), in pixel order (f(0) alone at N = 1)
template <int N, class F>
__device__ __forceinline__ float pix_sum(F f) {
  float s = f(0);
#pragma unroll
  for (int j = 1; j < N; ++j) s += f(j);
  return s;
}

// One step of the warp reduce-scatter: lanes l and l ^ OFF each keep one
// half of their 2*OFF values and add the partner's copy of that half.
template <int OFF>
__device__ __forceinline__ void butterfly_step(float* v, int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Warp sums of 16 columns: lanes l and l ^ 16 end with column l & 15.
__device__ __forceinline__ float reduce16(float* v, int lane) {
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}

// the per-pixel cotangents and forward residuals
struct PixelCot {
  float gC0, gC1, gC2, gD, gN0, gN1, gN2, gDist, g_tfin;
  float t_fin, n_contrib, s1, s2, a_tot;
};

template <int TILE>
__device__ __forceinline__ PixelCot load_cot(const float* cot, const float* resid,
                                             int tile, int lin, int n_extra) {
  constexpr int kPix = TileShape<TILE>::kPix;
  const float* cp = cot + ((size_t)tile * kPix + lin) * (10 + n_extra);
  const float* rp = resid + ((size_t)tile * kPix + lin) * 4;
  PixelCot q;
  q.gC0 = cp[0]; q.gC1 = cp[1]; q.gC2 = cp[2];
  q.gD = cp[3];
  q.gN0 = cp[5]; q.gN1 = cp[6]; q.gN2 = cp[7];
  q.gDist = cp[9];
  q.g_tfin = -cp[4] + cp[8];  // alpha = 1 - T_fin, color += T_fin * bg
  q.t_fin = rp[0]; q.n_contrib = rp[1]; q.s1 = rp[2]; q.s2 = rp[3];
  q.a_tot = 1.0f - q.t_fin;
  return q;
}

// B1: P and L of one item (items that are not their tile's first);
// pl[item][0][pixel] = P, pl[item][1][pixel] = L
template <int TILE>
__global__ void __launch_bounds__(TileShape<TILE>::kThreads)
tile_bwd_transmit(const float* __restrict__ slab, const int* __restrict__ tile_start,
                  const int* __restrict__ count_eff, const int* __restrict__ item_off,
                  int n_tiles, const float* __restrict__ cot,
                  const float* __restrict__ resid, float* __restrict__ pl,
                  int tiles_x, int tiles_per_frame, int n_extra) {
  using S = TileShape<TILE>;
  constexpr int kPix = S::kPix;
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it) || it.seg == 0) return;
  const int rank0 = it.seg * kSeg;
  Pixel px[S::kPPT];
  PixelCot q[S::kPPT];
  float gX[S::kPPT][kMaxExtra];
  float P[S::kPPT], L[S::kPPT];
  bool active[S::kPPT];
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j) {
    const int lin = threadIdx.x + j * S::kThreads;
    px[j] = pixel_of<TILE>(it.tile, lin, tiles_x, tiles_per_frame);
    q[j] = load_cot<TILE>(cot, resid, it.tile, lin, n_extra);
    const float* cpx = cot + ((size_t)it.tile * kPix + lin) * (10 + n_extra) + 10;
#pragma unroll
    for (int e = 0; e < kMaxExtra; ++e) gX[j][e] = (e < n_extra) ? cpx[e] : 0.f;
    P[j] = 1.0f;
    L[j] = 0.0f;
    active[j] = (float)rank0 < q[j].n_contrib;
  }

  const float* src = slab + (size_t)(tile_start[it.tile] + rank0) * kF;
  const int n = min(kSeg, count_eff[it.tile] - rank0);
  const int nc = (n + kChunk - 1) / kChunk;
  const RowRing<kChunk> ring{rows, bar};
  ring.init();
  if (threadIdx.x == 0) {
    ring.load(0, src, min(kChunk, n));
    if (nc > 1) ring.load(1, src + kChunk * kF, min(kChunk, n - kChunk));
  }

  int c = 0;
  for (; c < nc; ++c) {
    ring.wait(c);
    const float* st = ring.stage(c);
    const int m = min(kChunk, n - c * kChunk);
    bool any_active = false;
#pragma unroll
    for (int j = 0; j < S::kPPT; ++j) {
      const PixelCot& qj = q[j];
      if (active[j]) {
        for (int k = 0; k < m; ++k) {
          if ((float)(rank0 + c * kChunk + k) >= qj.n_contrib) {
            active[j] = false;
            break;
          }
          const float* row = st + k * kF;
          const Response r = splat_response(row, px[j].x, px[j].y);
          const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
          if (!is_candidate(r, alpha)) continue;
          const float mdepth = ndc_depth(fmaxf(r.depth, 1e-6f));
          float gw = row[kRGB] * qj.gC0 + row[kRGB + 1] * qj.gC1 + row[kRGB + 2] * qj.gC2 +
                     r.depth * qj.gD + row[kNRM] * qj.gN0 + row[kNRM + 1] * qj.gN1 +
                     row[kNRM + 2] * qj.gN2 +
                     qj.gDist * (mdepth * mdepth * qj.a_tot + qj.s2 - 2.0f * mdepth * qj.s1);
#pragma unroll
          for (int e = 0; e < kMaxExtra; ++e)
            if (e < n_extra) gw += row[kEXTRA + e] * gX[j][e];
          L[j] += gw * alpha * P[j];
          P[j] *= 1.0f - alpha;
        }
      }
      any_active |= active[j];
    }
    if (!__syncthreads_or(any_active)) break;
    if (threadIdx.x == 0 && c + 2 < nc)
      ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF, min(kChunk, n - (c + 2) * kChunk));
  }
  if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j) {
    float* o = pl + (size_t)blockIdx.x * 2 * kPix + threadIdx.x + j * S::kThreads;
    o[0] = P[j];
    o[kPix] = L[j];
  }
}

// B2: the gradient rows of one item. At one pixel per thread it keeps 3
// blocks per SM (78 registers at TILE 16); at 4 it holds four pixels' state
// and takes one.
template <int TILE>
__global__ void __launch_bounds__(TileShape<TILE>::kThreads,
                                  TileShape<TILE>::kPPT == 1 ? 3 : 1)
tile_bwd_grad(const float* __restrict__ slab, const int* __restrict__ tile_start,
              const int* __restrict__ count_eff, const int* __restrict__ item_off,
              int n_tiles, const float* __restrict__ cot,
              const float* __restrict__ resid, const float* __restrict__ pl,
              float* __restrict__ grad, int tiles_x, int tiles_per_frame,
              int n_extra) {
  using S = TileShape<TILE>;
  using G = GradSmem<TILE>;
  constexpr int kPix = S::kPix;
  constexpr int kPPT = S::kPPT;
  extern __shared__ __align__(128) float smem[];
  float* rows = smem;                                         // [2][kGroup][kF]
  float (*part)[kGroup][kF] =
      reinterpret_cast<float (*)[kGroup][kF]>(smem + 2 * kGroup * kF);  // [kWarps]
  float* s_gx = smem + G::kFloats;                            // [n_extra][kPix]
  __shared__ __align__(8) uint64_t bar[2];

  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pixel px[kPPT];
  PixelCot q[kPPT];
  float T[kPPT];  // T after the current entry
  float S_[kPPT];  // sum over later entries of gw * w
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int lin = threadIdx.x + j * S::kThreads;
    px[j] = pixel_of<TILE>(it.tile, lin, tiles_x, tiles_per_frame);
    q[j] = load_cot<TILE>(cot, resid, it.tile, lin, n_extra);
    const float* cpx = cot + ((size_t)it.tile * kPix + lin) * (10 + n_extra) + 10;
    for (int e = 0; e < n_extra; ++e) s_gx[e * kPix + lin] = cpx[e];
    // T and S at the item's end, from the later items' P and L
    T[j] = q[j].t_fin;
    S_[j] = 0.0f;
    for (int i = it.n_items - 1; i > it.seg; --i) {
      const float* o = pl + (size_t)(it.first_item + i) * 2 * kPix + lin;
      const float t_start = T[j] / o[0];
      S_[j] += t_start * o[kPix];
      T[j] = t_start;
    }
  }

  const int rank0 = it.seg * kSeg;
  const int start = tile_start[it.tile] + rank0;
  const float* src = slab + (size_t)start * kF;
  const int n = min(kSeg, count_eff[it.tile] - rank0);
  const int ng = (n + kGroup - 1) / kGroup;
  const RowRing<kGroup> ring{rows, bar};
  ring.init();  // its __syncthreads also publishes s_gx
  if (threadIdx.x == 0) {  // step c walks group ng - 1 - c
    ring.load(0, src + (size_t)(ng - 1) * kGroup * kF, n - (ng - 1) * kGroup);
    if (ng > 1) ring.load(1, src + (size_t)(ng - 2) * kGroup * kF, kGroup);
  }

  for (int c = 0; c < ng; ++c) {
    const int gbase = (ng - 1 - c) * kGroup;
    const int m = min(kGroup, n - gbase);
    ring.wait(c);
    const float* st = ring.stage(c);

    for (int k = m - 1; k >= 0; --k) {
      const float* row = st + k * kF;
      float g_px[kPPT], g_py[kPPT], g_pz[kPPT], g_q[kPPT], g_d2[kPPT];
      float g_cx[kPPT], g_cy[kPPT], g_opac[kPPT], w[kPPT];
      bool any_ok = false;
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const PixelCot& qj = q[j];
        const int lin = threadIdx.x + j * S::kThreads;
        const Response r = splat_response(row, px[j].x, px[j].y);
        const bool clamped = r.alpha_raw > kAlphaClamp;
        const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
        const bool ok = is_candidate(r, alpha) && (float)(rank0 + gbase + k) < qj.n_contrib;
        g_px[j] = g_py[j] = g_pz[j] = g_q[j] = g_d2[j] = g_cx[j] = g_cy[j] = 0.f;
        g_opac[j] = w[j] = 0.f;
        if (ok) {
          const float om = 1.0f - alpha;
          const float t_before = T[j] / om;
          w[j] = alpha * t_before;
          const float depth_pos = fmaxf(r.depth, 1e-6f);
          const float mdepth = ndc_depth(depth_pos);

          float gw = row[kRGB] * qj.gC0 + row[kRGB + 1] * qj.gC1 + row[kRGB + 2] * qj.gC2 +
                     r.depth * qj.gD + row[kNRM] * qj.gN0 + row[kNRM + 1] * qj.gN1 +
                     row[kNRM + 2] * qj.gN2 +
                     qj.gDist * (mdepth * mdepth * qj.a_tot + qj.s2 - 2.0f * mdepth * qj.s1);
          for (int e = 0; e < n_extra; ++e) gw += row[kEXTRA + e] * s_gx[e * kPix + lin];

          float g_alpha = gw * t_before - (S_[j] + qj.g_tfin * qj.t_fin) / fmaxf(om, 1e-3f);
          if (clamped) g_alpha = 0.0f;
          S_[j] += gw * w[j];
          T[j] = t_before;

          g_opac[j] = g_alpha * r.g;
          const float g_rho = g_alpha * row[kOPAC] * r.g * (-0.5f);
          // expected-depth term + distortion's m-chain, dm/dd gated at 1e-6
          const float g_m = qj.gDist * 2.0f * w[j] * (mdepth * qj.a_tot - qj.s1);
          const float dmdd = r.depth > 1e-6f
              ? (kFar * kNear) / ((kFar - kNear) * depth_pos * depth_pos) : 0.0f;
          const float g_depth = w[j] * qj.gD + g_m * dmdd;
          const float g_rho3 = r.use3d ? g_rho : 0.0f;
          // the centre's gradient, 2 FIS dx g_rho2, per pixel: summing
          // cx * g - px * g instead would bring the cancellation back
          const float g_c2 = r.use3d ? 0.0f : 2.0f * kFilterInvSquare * g_rho;
          g_cx[j] = r.dx * g_c2;
          g_cy[j] = r.dy * g_c2;
          const float g_d3 = r.use3d ? g_depth : 0.0f;
          g_d2[j] = r.use3d ? 0.0f : g_depth;
          const float ipz2 = r.ipz * r.ipz;
          g_px[j] = 2.0f * r.px * ipz2 * g_rho3;
          g_py[j] = 2.0f * r.py * ipz2 * g_rho3;
          g_pz[j] = -(2.0f * r.rho3d * g_rho3 + r.depth * g_d3) * r.ipz;
          g_q[j] = r.ipz * g_d3;
        }
        any_ok |= ok;
      }

      // skipped when no pixel of the warp touches this entry
      float out = 0.0f;
      if (__any_sync(0xffffffffu, any_ok)) {
        float v[16];
        v[kPA] = pix_sum<kPPT>([&](int j) { return g_px[j]; });
        v[kPA + 1] = pix_sum<kPPT>([&](int j) { return g_py[j]; });
        v[kPA + 2] = pix_sum<kPPT>([&](int j) { return g_pz[j]; });
        v[kPB] = pix_sum<kPPT>([&](int j) { return px[j].x * g_px[j]; });
        v[kPB + 1] = pix_sum<kPPT>([&](int j) { return px[j].x * g_py[j]; });
        v[kPB + 2] = pix_sum<kPPT>([&](int j) { return px[j].x * g_pz[j]; });
        v[kPC] = pix_sum<kPPT>([&](int j) { return px[j].y * g_px[j]; });
        v[kPC + 1] = pix_sum<kPPT>([&](int j) { return px[j].y * g_py[j]; });
        v[kPC + 2] = pix_sum<kPPT>([&](int j) { return px[j].y * g_pz[j]; });
        v[kQD] = pix_sum<kPPT>([&](int j) { return g_q[j]; });
        v[kTW2] = pix_sum<kPPT>([&](int j) { return g_d2[j]; });
        v[kCX] = pix_sum<kPPT>([&](int j) { return g_cx[j]; });
        v[kCY] = pix_sum<kPPT>([&](int j) { return g_cy[j]; });
        v[kCY + 1] = 0.0f;  // the spare column
        v[kOPAC] = pix_sum<kPPT>([&](int j) { return g_opac[j]; });
        v[kRGB] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gC0; });
        const float lo = reduce16(v, lane);  // columns 0-15
        v[kRGB + 1 - 16] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gC1; });
        v[kRGB + 2 - 16] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gC2; });
        v[kNRM - 16] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gN0; });
        v[kNRM + 1 - 16] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gN1; });
        v[kNRM + 2 - 16] = pix_sum<kPPT>([&](int j) { return w[j] * q[j].gN2; });
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e) {
          v[kEXTRA - 16 + e] = 0.0f;
          if (e < n_extra)
            v[kEXTRA - 16 + e] = pix_sum<kPPT>([&](int j) {
              return w[j] * s_gx[e * kPix + threadIdx.x + j * S::kThreads];
            });
        }
        const float hi = reduce16(v, lane);  // columns 16-31
        out = lane < 16 ? lo : hi;  // lane l holds column l
      }
      part[warp][k][lane] = out;
    }
    __syncthreads();  // the partials are complete; the stage is consumed
    if (threadIdx.x == 0 && c + 2 < ng)
      ring.load(c + 2, src + (size_t)(ng - 3 - c) * kGroup * kF, kGroup);
    // add the warp partials and write the group's grad rows (coalesced)
    for (int i = threadIdx.x; i < m * kF; i += S::kThreads) {
      const int k = i / kF, col = i % kF;
      float s = 0.0f;
#pragma unroll
      for (int wp = 0; wp < G::kWarps; ++wp) s += part[wp][k][col];
      grad[(size_t)(start + gbase + k) * kF + col] = s;
    }
    __syncthreads();  // the partials are consumed
  }
}

template <int TILE>
int launch_backward(const float* slab, const int* tile_start, const int* count_eff,
                    const int* item_off, const float* cot, const float* resid, float* pl,
                    float* grad, int n_tiles, int n_blocks, int tiles_x,
                    int tiles_per_frame, int n_extra, cudaStream_t s) {
  using S = TileShape<TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      tile_bwd_grad<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GradSmem<TILE>::kMaxBytes);
  if (err != cudaSuccess) return (int)err;
  tile_bwd_transmit<TILE><<<n_blocks, S::kThreads, 0, s>>>(
      slab, tile_start, count_eff, item_off, n_tiles, cot, resid, pl, tiles_x,
      tiles_per_frame, n_extra);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(GradSmem<TILE>::kFloats + n_extra * S::kPix) * sizeof(float);
  tile_bwd_grad<TILE><<<n_blocks, S::kThreads, smem, s>>>(
      slab, tile_start, count_eff, item_off, n_tiles, cot, resid, pl, grad, tiles_x,
      tiles_per_frame, n_extra);
  return (int)cudaGetLastError();
}

}  // namespace vidu4d

// Launches B1 and B2 at tile side `tile` (one of kTileSides, else
// cudaErrorInvalidValue before any launch) on `stream`. count_eff (T,)
// bounds each tile's walk; pl (n_blocks, 2, tile^2) is scratch; n_blocks
// bounds the item count (tile_forward.py:work_list). Returns the first
// launch error.
extern "C" int vidu4d_tile_backward(const float* slab, const int* tile_start,
                                    const int* count_eff, const int* item_off,
                                    const float* cot, const float* resid, float* pl,
                                    float* grad, int n_tiles, int n_blocks, int tiles_x,
                                    int tiles_per_frame, int tile, int n_extra,
                                    void* stream) {
  using namespace vidu4d;
  if (tile != 8 && tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0 || n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto* launch = tile == 8 ? launch_backward<8> : tile == 16 ? launch_backward<16>
                                                             : launch_backward<32>;
  return launch(slab, tile_start, count_eff, item_off, cot, resid, pl, grad, n_tiles,
                n_blocks, tiles_x, tiles_per_frame, n_extra, s);
}
