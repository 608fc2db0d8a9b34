// Analytic backward of the tile compositor (tile_forward.cu), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel vidu4d_tpu/ops/rasterize/pallas_backward.py:
// _make_bwd_kernel (launched by backward_pallas, :380-441).
//
// Work split: the forward's grid, one 256-thread block per (frame, tile) and
// one thread per pixel. The block walks the tile's entries back to front,
// from the tile's largest n_contrib down to 0, staging 32 slab rows at a
// time through shared memory. Each thread rebuilds T-before by division,
// T_before = T_after / (1 - alpha) (the Pallas kernel's reconstruction), and
// keeps the suffix sum S = sum_{j > i} gw_j * w_j for the alpha gradient.
// The distortion gradient uses the totals form (S1, S2, A = 1 - T_fin are
// forward residuals), so no further suffix scan is needed.
//
// Per entry the 21 + n_extra slab-row gradients are summed over the tile's
// 256 pixels: a 31-shuffle butterfly reduce-scatter inside each warp (lane
// l ends with column l's warp sum), then the 8 warp partials are added from
// shared memory once per 32-entry group and written as that entry's row of
// the (E, 32) grad slab. Every entry belongs to exactly one tile segment
// (bin_splats_aligned), so no global atomics are needed; the entry -> splat
// reduction is an index_add_ in PyTorch.
//
// What bounds it: the per-entry block reduction (31 shuffles per warp per
// entry) and the sequential entry loop; warps whose pixels all miss an entry
// skip the shuffles. Moving the reduction to tensor cores or warp-specialised
// blocks is later work.
//
// cot  (T, 256, 10 + n_extra): gC(3) gD gA gN(3) gBGdot gDist gX(n_extra)
// resid(T, 256, 4):            T_fin, n_contrib, S1, S2
// grad (E, 32): rows of the entries the walk reaches are overwritten; the
//               caller zero-fills it.
#include "tile_common.cuh"

namespace vidu4d {

constexpr int kGroup = 32;            // slab rows staged per step
constexpr int kWarps = kPix / 32;

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

__global__ void __launch_bounds__(kPix)
tile_backward_kernel(const float* __restrict__ slab,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ cot,
                     const float* __restrict__ resid,
                     float* __restrict__ grad,
                     int tiles_x, int tiles_per_frame, int n_extra) {
  __shared__ __align__(16) float rows[kGroup * kF];
  __shared__ float part[kWarps][kGroup][kF];
  __shared__ int s_max_contrib;

  const int t = blockIdx.x;
  const int tl = t % tiles_per_frame;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const float pxf = (float)((tl % tiles_x) * kTile + lin % kTile) + 0.5f;
  const float pyf = (float)((tl / tiles_x) * kTile + lin / kTile) + 0.5f;
  const float pq = kFilterInvSquare * (pxf * pxf + pyf * pyf);
  const int start = tile_start[t];
  const int count = tile_count[t];

  const int nc = 10 + n_extra;
  const float* cp = cot + ((size_t)t * kPix + lin) * nc;
  const float gC0 = cp[0], gC1 = cp[1], gC2 = cp[2];
  const float gD = cp[3], gA = cp[4];
  const float gN0 = cp[5], gN1 = cp[6], gN2 = cp[7];
  const float gBG = cp[8], gDist = cp[9];
  float gX[kMaxExtra];
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e) gX[e] = (e < n_extra) ? cp[10 + e] : 0.f;
  const float* rp = resid + ((size_t)t * kPix + lin) * 4;
  const float t_fin = rp[0], n_contrib = rp[1], s1_tot = rp[2], s2_tot = rp[3];
  const float a_tot = 1.0f - t_fin;
  const float g_tfin = -gA + gBG;  // alpha = 1 - T_fin, color += T_fin * bg

  // entries past the tile's largest contributor rank have zero gradient
  if (lin == 0) s_max_contrib = 0;
  __syncthreads();
  atomicMax(&s_max_contrib, (int)ceilf(n_contrib));
  __syncthreads();
  const int count_eff = min(count, s_max_contrib);

  float T = t_fin;   // T after the current entry
  float S = 0.0f;    // sum over later entries of gw * w
  const int n_groups = (count_eff + kGroup - 1) / kGroup;

  for (int gi = n_groups - 1; gi >= 0; --gi) {
    const int gbase = gi * kGroup;
    const int n = min(kGroup, count_eff - gbase);
    __syncthreads();  // previous group's rows / partials are consumed
    stage_rows(rows, slab + (size_t)(start + gbase) * kF, n);
    __syncthreads();

    for (int k = n - 1; k >= 0; --k) {
      const float* row = rows + k * kF;
      float v[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) v[c] = 0.f;

      const Response r = splat_response(row, pxf, pyf, pq);
      const bool clamped = r.alpha_raw > kAlphaClamp;
      const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
      const bool ok = r.pz_ok && r.depth >= kNear && alpha >= kAlphaEps &&
                      (float)(gbase + k) < n_contrib;
      if (ok) {
        const float om = 1.0f - alpha;
        const float t_before = T / om;
        const float w = alpha * t_before;
        const float depth_pos = fmaxf(r.depth, 1e-6f);
        const float m = ndc_depth(depth_pos);

        float gw = row[kRGB] * gC0 + row[kRGB + 1] * gC1 + row[kRGB + 2] * gC2 +
                   r.depth * gD + row[kNRM] * gN0 + row[kNRM + 1] * gN1 +
                   row[kNRM + 2] * gN2 +
                   gDist * (m * m * a_tot + s2_tot - 2.0f * m * s1_tot);
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e)
          if (e < n_extra) gw += row[kEXTRA + e] * gX[e];

        float g_alpha = gw * t_before - (S + g_tfin * t_fin) / fmaxf(om, 1e-3f);
        if (clamped) g_alpha = 0.0f;
        S += gw * w;
        T = t_before;

        const float g_opac = g_alpha * r.g;
        const float g_rho = g_alpha * row[kOPAC] * r.g * (-0.5f);
        // expected-depth term + distortion's m-chain, dm/dd gated at 1e-6
        const float g_m = gDist * 2.0f * w * (m * a_tot - s1_tot);
        const float dmdd = r.depth > 1e-6f
            ? (kFar * kNear) / ((kFar - kNear) * depth_pos * depth_pos) : 0.0f;
        const float g_depth = w * gD + g_m * dmdd;
        const float g_rho3 = r.use3d ? g_rho : 0.0f;
        const float g_rho2 = r.use3d ? 0.0f : g_rho;
        const float g_d3 = r.use3d ? g_depth : 0.0f;
        const float g_d2 = r.use3d ? 0.0f : g_depth;
        const float ipz2 = r.ipz * r.ipz;
        const float g_px = 2.0f * r.px * ipz2 * g_rho3;
        const float g_py = 2.0f * r.py * ipz2 * g_rho3;
        const float g_pz = -(2.0f * r.rho3d * g_rho3 + r.depth * g_d3) * r.ipz;

        v[kPA] = g_px;             v[kPA + 1] = g_py;        v[kPA + 2] = g_pz;
        v[kPB] = pxf * g_px;       v[kPB + 1] = pxf * g_py;  v[kPB + 2] = pxf * g_pz;
        v[kPC] = pyf * g_px;       v[kPC + 1] = pyf * g_py;  v[kPC + 2] = pyf * g_pz;
        v[kQD] = r.ipz * g_d3;
        v[kTW2] = g_d2;
        v[kE0] = g_rho2;
        v[kE1] = pxf * g_rho2;
        v[kE2] = pyf * g_rho2;
        v[kOPAC] = g_opac;
        v[kRGB] = w * gC0;         v[kRGB + 1] = w * gC1;    v[kRGB + 2] = w * gC2;
        v[kNRM] = w * gN0;         v[kNRM + 1] = w * gN1;    v[kNRM + 2] = w * gN2;
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e)
          if (e < n_extra) v[kEXTRA + e] = w * gX[e];
      }

      // warp butterfly reduce-scatter of v[0..31]: lane l ends with the
      // warp sum of column l (31 shuffles); skipped when no pixel of the
      // warp touches this entry
      if (__any_sync(0xffffffffu, ok)) {
        butterfly_step<16>(v, lane);
        butterfly_step<8>(v, lane);
        butterfly_step<4>(v, lane);
        butterfly_step<2>(v, lane);
        butterfly_step<1>(v, lane);
        part[warp][k][lane] = v[0];
      } else {
        part[warp][k][lane] = 0.0f;
      }
    }
    __syncthreads();
    // add the warp partials and write the group's grad rows (coalesced)
    for (int i = lin; i < n * kF; i += kPix) {
      const int k = i / kF, c = i % kF;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][k][c];
      grad[(size_t)(start + gbase + k) * kF + c] = s;
    }
  }
}

}  // namespace vidu4d

extern "C" int vidu4d_tile_backward(const float* slab, const int* tile_start,
                                    const int* tile_count, const float* cot,
                                    const float* resid, float* grad,
                                    int num_blocks, int tiles_x,
                                    int tiles_per_frame, int n_extra,
                                    void* stream) {
  if (num_blocks > 0) {
    vidu4d::tile_backward_kernel<<<num_blocks, vidu4d::kPix, 0,
                                   (cudaStream_t)stream>>>(
        slab, tile_start, tile_count, cot, resid, grad, tiles_x,
        tiles_per_frame, n_extra);
  }
  return (int)cudaGetLastError();
}
