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
//      only 16 values are live at once) and a shared-memory pass over the
//      8 warp partials, written as the entry's grad row. Every entry belongs
//      to exactly one item, so there are no atomics; the entry -> splat
//      reduction is an index_add_ in PyTorch.
//
// cot  (T, 256, 10 + n_extra): gC(3) gD gA gN(3) gBGdot gDist gX(n_extra)
// resid(T, 256, 4):            T_fin, n_contrib, S1, S2
// grad (E, 32): rows of the entries below count_eff are overwritten; the
//               caller zero-fills it.
#include "tile_common.cuh"

namespace vidu4d {

constexpr int kGroup = 32;  // slab rows per staged step of the gradient walk
constexpr int kWarps = kPix / 32;
// dynamic shared memory of B2: the row ring, the warp partials, gX
constexpr int kGradSmemFloats = 2 * kGroup * kF + kWarps * kGroup * kF;
constexpr int kGradSmemMax = (kGradSmemFloats + kMaxExtra * kPix) * (int)sizeof(float);

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

__device__ __forceinline__ PixelCot load_cot(const float* cot, const float* resid,
                                             int tile, int n_extra) {
  const int lin = threadIdx.x;
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
__global__ void __launch_bounds__(kPix)
tile_bwd_transmit(const float* __restrict__ slab, const int* __restrict__ tile_start,
                  const int* __restrict__ count_eff, const int* __restrict__ item_off,
                  int n_tiles, const float* __restrict__ cot,
                  const float* __restrict__ resid, float* __restrict__ pl,
                  int tiles_x, int tiles_per_frame, int n_extra) {
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it) || it.seg == 0) return;
  const Pixel px = pixel_of(it.tile, tiles_x, tiles_per_frame);
  const PixelCot q = load_cot(cot, resid, it.tile, n_extra);
  float gX[kMaxExtra];
  const float* cpx = cot + ((size_t)it.tile * kPix + threadIdx.x) * (10 + n_extra) + 10;
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e) gX[e] = (e < n_extra) ? cpx[e] : 0.f;

  const int rank0 = it.seg * kSeg;
  const float* src = slab + (size_t)(tile_start[it.tile] + rank0) * kF;
  const int n = min(kSeg, count_eff[it.tile] - rank0);
  const int nc = (n + kChunk - 1) / kChunk;
  const RowRing<kChunk> ring{rows, bar};
  ring.init();
  if (threadIdx.x == 0) {
    ring.load(0, src, min(kChunk, n));
    if (nc > 1) ring.load(1, src + kChunk * kF, min(kChunk, n - kChunk));
  }

  float P = 1.0f, L = 0.0f;
  bool active = (float)rank0 < q.n_contrib;
  int c = 0;
  for (; c < nc; ++c) {
    ring.wait(c);
    const float* st = ring.stage(c);
    const int m = min(kChunk, n - c * kChunk);
    if (active) {
      for (int k = 0; k < m; ++k) {
        if ((float)(rank0 + c * kChunk + k) >= q.n_contrib) {
          active = false;
          break;
        }
        const float* row = st + k * kF;
        const Response r = splat_response(row, px.x, px.y, px.q);
        const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
        if (!is_candidate(r, alpha)) continue;
        const float mdepth = ndc_depth(fmaxf(r.depth, 1e-6f));
        float gw = row[kRGB] * q.gC0 + row[kRGB + 1] * q.gC1 + row[kRGB + 2] * q.gC2 +
                   r.depth * q.gD + row[kNRM] * q.gN0 + row[kNRM + 1] * q.gN1 +
                   row[kNRM + 2] * q.gN2 +
                   q.gDist * (mdepth * mdepth * q.a_tot + q.s2 - 2.0f * mdepth * q.s1);
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e)
          if (e < n_extra) gw += row[kEXTRA + e] * gX[e];
        L += gw * alpha * P;
        P *= 1.0f - alpha;
      }
    }
    if (!__syncthreads_or(active)) break;
    if (threadIdx.x == 0 && c + 2 < nc)
      ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF, min(kChunk, n - (c + 2) * kChunk));
  }
  if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
  float* o = pl + (size_t)blockIdx.x * 2 * kPix + threadIdx.x;
  o[0] = P;
  o[kPix] = L;
}

// B2: the gradient rows of one item
__global__ void __launch_bounds__(kPix, 3)
tile_bwd_grad(const float* __restrict__ slab, const int* __restrict__ tile_start,
              const int* __restrict__ count_eff, const int* __restrict__ item_off,
              int n_tiles, const float* __restrict__ cot,
              const float* __restrict__ resid, const float* __restrict__ pl,
              float* __restrict__ grad, int tiles_x, int tiles_per_frame,
              int n_extra) {
  extern __shared__ __align__(128) float smem[];
  float* rows = smem;                                         // [2][kGroup][kF]
  float (*part)[kGroup][kF] =
      reinterpret_cast<float (*)[kGroup][kF]>(smem + 2 * kGroup * kF);  // [kWarps]
  float* s_gx = smem + kGradSmemFloats;                       // [n_extra][kPix]
  __shared__ __align__(8) uint64_t bar[2];

  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it)) return;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const Pixel px = pixel_of(it.tile, tiles_x, tiles_per_frame);
  const PixelCot q = load_cot(cot, resid, it.tile, n_extra);
  const float* cpx = cot + ((size_t)it.tile * kPix + lin) * (10 + n_extra) + 10;
  for (int e = 0; e < n_extra; ++e) s_gx[e * kPix + lin] = cpx[e];

  // T and S at the item's end, from the later items' P and L
  float T = q.t_fin;  // T after the current entry
  float S = 0.0f;     // sum over later entries of gw * w
  for (int j = it.n_items - 1; j > it.seg; --j) {
    const float* o = pl + (size_t)(it.first_item + j) * 2 * kPix + lin;
    const float t_start = T / o[0];
    S += t_start * o[kPix];
    T = t_start;
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
      const Response r = splat_response(row, px.x, px.y, px.q);
      const bool clamped = r.alpha_raw > kAlphaClamp;
      const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
      const bool ok = is_candidate(r, alpha) && (float)(rank0 + gbase + k) < q.n_contrib;
      float g_px = 0.f, g_py = 0.f, g_pz = 0.f, g_q = 0.f, g_d2 = 0.f, g_rho2 = 0.f;
      float g_opac = 0.f, w = 0.f;
      if (ok) {
        const float om = 1.0f - alpha;
        const float t_before = T / om;
        w = alpha * t_before;
        const float depth_pos = fmaxf(r.depth, 1e-6f);
        const float mdepth = ndc_depth(depth_pos);

        float gw = row[kRGB] * q.gC0 + row[kRGB + 1] * q.gC1 + row[kRGB + 2] * q.gC2 +
                   r.depth * q.gD + row[kNRM] * q.gN0 + row[kNRM + 1] * q.gN1 +
                   row[kNRM + 2] * q.gN2 +
                   q.gDist * (mdepth * mdepth * q.a_tot + q.s2 - 2.0f * mdepth * q.s1);
        for (int e = 0; e < n_extra; ++e) gw += row[kEXTRA + e] * s_gx[e * kPix + lin];

        float g_alpha = gw * t_before - (S + q.g_tfin * q.t_fin) / fmaxf(om, 1e-3f);
        if (clamped) g_alpha = 0.0f;
        S += gw * w;
        T = t_before;

        g_opac = g_alpha * r.g;
        const float g_rho = g_alpha * row[kOPAC] * r.g * (-0.5f);
        // expected-depth term + distortion's m-chain, dm/dd gated at 1e-6
        const float g_m = q.gDist * 2.0f * w * (mdepth * q.a_tot - q.s1);
        const float dmdd = r.depth > 1e-6f
            ? (kFar * kNear) / ((kFar - kNear) * depth_pos * depth_pos) : 0.0f;
        const float g_depth = w * q.gD + g_m * dmdd;
        const float g_rho3 = r.use3d ? g_rho : 0.0f;
        g_rho2 = r.use3d ? 0.0f : g_rho;
        const float g_d3 = r.use3d ? g_depth : 0.0f;
        g_d2 = r.use3d ? 0.0f : g_depth;
        const float ipz2 = r.ipz * r.ipz;
        g_px = 2.0f * r.px * ipz2 * g_rho3;
        g_py = 2.0f * r.py * ipz2 * g_rho3;
        g_pz = -(2.0f * r.rho3d * g_rho3 + r.depth * g_d3) * r.ipz;
        g_q = r.ipz * g_d3;
      }

      // skipped when no pixel of the warp touches this entry
      float out = 0.0f;
      if (__any_sync(0xffffffffu, ok)) {
        float v[16];
        v[kPA] = g_px;             v[kPA + 1] = g_py;        v[kPA + 2] = g_pz;
        v[kPB] = px.x * g_px;      v[kPB + 1] = px.x * g_py; v[kPB + 2] = px.x * g_pz;
        v[kPC] = px.y * g_px;      v[kPC + 1] = px.y * g_py; v[kPC + 2] = px.y * g_pz;
        v[kQD] = g_q;
        v[kTW2] = g_d2;
        v[kE0] = g_rho2;
        v[kE1] = px.x * g_rho2;
        v[kE2] = px.y * g_rho2;
        v[kOPAC] = g_opac;
        v[kRGB] = w * q.gC0;
        const float lo = reduce16(v, lane);  // columns 0-15
        v[kRGB + 1 - 16] = w * q.gC1;
        v[kRGB + 2 - 16] = w * q.gC2;
        v[kNRM - 16] = w * q.gN0;
        v[kNRM + 1 - 16] = w * q.gN1;
        v[kNRM + 2 - 16] = w * q.gN2;
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e) {
          v[kEXTRA - 16 + e] = 0.0f;
          if (e < n_extra) v[kEXTRA - 16 + e] = w * s_gx[e * kPix + lin];
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
    for (int i = lin; i < m * kF; i += kPix) {
      const int k = i / kF, col = i % kF;
      float s = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += part[wp][k][col];
      grad[(size_t)(start + gbase + k) * kF + col] = s;
    }
    __syncthreads();  // the partials are consumed
  }
}

}  // namespace vidu4d

// Launches B1 and B2 on `stream`. count_eff (T,) bounds each tile's walk;
// pl (n_blocks, 2, 256) is scratch; n_blocks bounds the item count
// (tile_forward.py:work_list). Returns the first launch error.
extern "C" int vidu4d_tile_backward(const float* slab, const int* tile_start,
                                    const int* count_eff, const int* item_off,
                                    const float* cot, const float* resid, float* pl,
                                    float* grad, int n_tiles, int n_blocks, int tiles_x,
                                    int tiles_per_frame, int n_extra, void* stream) {
  using namespace vidu4d;
  if (n_tiles <= 0 || n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      tile_bwd_grad, cudaFuncAttributeMaxDynamicSharedMemorySize, kGradSmemMax);
  if (err != cudaSuccess) return (int)err;
  tile_bwd_transmit<<<n_blocks, kPix, 0, s>>>(slab, tile_start, count_eff, item_off,
                                              n_tiles, cot, resid, pl, tiles_x,
                                              tiles_per_frame, n_extra);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(kGradSmemFloats + n_extra * kPix) * sizeof(float);
  tile_bwd_grad<<<n_blocks, kPix, smem, s>>>(slab, tile_start, count_eff, item_off,
                                             n_tiles, cot, resid, pl, grad, tiles_x,
                                             tiles_per_frame, n_extra);
  return (int)cudaGetLastError();
}
