// Forward tile compositor for the 2DGS surfel rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel vidu4d_tpu/ops/rasterize/pallas_kernel.py:
// _make_kernel (launched by forward_tiles_pallas, :470-521): front-to-back
// alpha compositing of each 16x16 tile's depth-sorted entries, with the
// cull (pz != 0, depth >= near, alpha >= 1/255), the 0.99 alpha clamp and
// the early stop (the first entry that would take T below 1e-4 ends the
// pixel).
//
// What bounds it on this card: per (entry, pixel) ~60 FLOPs, two IEEE
// divisions and one expf against one 128-byte slab row shared by 256
// pixels, so it is bound by issue and latency, not by bytes. A tile is a
// sequential chain, and tile depths are skewed (the densest tile of the
// main path holds ~19x the mean): with one block per tile the launch is a
// single wave whose time is the densest tile's walk on one SM.
//
// Design: the tile is split into work items of at most kSeg entries
// (tile_common.cuh), one block per item, in three passes.
//   F1 tile_fwd_transmit: per item that is not its tile's last and per
//      pixel, P = product of (1 - alpha) over the item's candidates. The
//      walk stops once P < 1e-4: every later item is then dead anyway.
//   F2 tile_fwd_composite: per item, T_start = product of P over the tile's
//      earlier items. T never increases, so the pixel stopped in an earlier
//      item exactly when T_start < 1e-4 (the item is dead for it); else the
//      item composites from T_start with the reference's rules and writes
//      per-pixel partials (colour + extras, depth, normal, S1, S2, median
//      candidate, contributor rank, T at its end, flags live / stopped /
//      median found). A tile of one item writes its outputs directly.
//   F3 tile_fwd_combine: per tile of several items, a deterministic sum of
//      the partials in item order up to the first dead or stopped item; the
//      median comes from the last item that has one, n_contrib is the last
//      rank, T_fin the last live item's T; then the background and the
//      totals-form distortion S2 * (1 - T_fin) - S1^2. No float atomics.
// Slab rows are staged by TMA 1D bulk copies into a two-stage shared-memory
// ring (RowRing): the copy of step c + 2 is in flight while step c + 1 is
// walked, and no thread spends instructions on it. A 128-row step costs two
// __syncthreads: the hand-off of its rows, and the block-level early-out
// (no live pixel left).
//
// Per pixel it writes color (3 + n_extra channels, background composited
// with the final T) and 12 aux channels:
//   0 depth, 1 alpha, 2-4 normal, 5 median depth, 6 distortion,
//   7 median weight, 8 T after the last included entry, 9 n_contrib,
//   10 S1 = sum w*m, 11 S2 = sum w*m^2   (8-11 are the backward's residuals)
#include "tile_common.cuh"

namespace vidu4d {

// per-(item, pixel) partials, channel-major [item][channel][pixel]; the
// colour + extra channels follow the fixed ones
constexpr int kPDepth = 0, kPNrm = 1, kPS1 = 4, kPS2 = 5, kPMedD = 6, kPMedW = 7;
constexpr int kPNcon = 8, kPTEnd = 9, kPFlags = 10, kPColor = 11;
constexpr int kLive = 1, kStopped = 2, kHasMedian = 4;

struct Accum {
  float c[3], ex[kMaxExtra], d, n[3], s1, s2, med_d, med_w, ncon, T;
};

__device__ __forceinline__ void accum_init(Accum& a, float T) {
#pragma unroll
  for (int i = 0; i < 3; ++i) a.c[i] = a.n[i] = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e) a.ex[e] = 0.f;
  a.d = a.s1 = a.s2 = a.med_d = a.med_w = a.ncon = 0.f;
  a.T = T;
}

// the pixel's outputs from its totals (background composited with T_fin)
__device__ __forceinline__ void write_pixel(const Accum& a, int tile, const float* bg,
                                            float* color, float* aux, int n_extra) {
  const int lin = threadIdx.x;
  const int nchan = 3 + n_extra;
  float* c = color + ((size_t)tile * kPix + lin) * nchan;
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = a.c[i] + a.T * bg[i];
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e)  // static indices keep ex[] in registers
    if (e < n_extra) c[3 + e] = a.ex[e] + a.T * bg[3 + e];
  float* o = aux + ((size_t)tile * kPix + lin) * 12;
  o[0] = a.d;
  o[1] = 1.0f - a.T;
  o[2] = a.n[0];
  o[3] = a.n[1];
  o[4] = a.n[2];
  o[5] = a.med_d;
  o[6] = a.s2 * (1.0f - a.T) - a.s1 * a.s1;  // totals-form distortion
  o[7] = a.med_w;
  o[8] = a.T;
  o[9] = a.ncon;
  o[10] = a.s1;
  o[11] = a.s2;
}

// F1: per-pixel transmittance product of one item (items that are not
// their tile's last); trans[item][pixel]
__global__ void __launch_bounds__(kPix)
tile_fwd_transmit(const float* __restrict__ slab, const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, const int* __restrict__ item_off,
                  int n_tiles, float* __restrict__ trans, int tiles_x,
                  int tiles_per_frame) {
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it) || it.seg == it.n_items - 1) return;
  const Pixel px = pixel_of(it.tile, tiles_x, tiles_per_frame);
  const int rank0 = it.seg * kSeg;
  const float* src = slab + (size_t)(tile_start[it.tile] + rank0) * kF;
  const int n = min(kSeg, tile_count[it.tile] - rank0);
  const int nc = (n + kChunk - 1) / kChunk;
  const RowRing<kChunk> ring{rows, bar};
  ring.init();
  if (threadIdx.x == 0) {
    ring.load(0, src, min(kChunk, n));
    if (nc > 1) ring.load(1, src + kChunk * kF, min(kChunk, n - kChunk));
  }

  float P = 1.0f;
  bool live = true;
  int c = 0;
  for (; c < nc; ++c) {
    ring.wait(c);
    const float* st = ring.stage(c);
    const int m = min(kChunk, n - c * kChunk);
    if (live) {
      for (int k = 0; k < m; ++k) {
        const Response r = splat_response(st + k * kF, px.x, px.y, px.q);
        const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
        if (!is_candidate(r, alpha)) continue;
        P *= 1.0f - alpha;
        if (P < kTEarlyStop) {  // every later item is dead for this pixel
          live = false;
          break;
        }
      }
    }
    if (!__syncthreads_or(live)) break;
    if (threadIdx.x == 0 && c + 2 < nc)
      ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF, min(kChunk, n - (c + 2) * kChunk));
  }
  if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
  trans[(size_t)blockIdx.x * kPix + threadIdx.x] = P;
}

// F2: composite one item from T_start; partials (or, for a tile of one
// item, the outputs)
__global__ void __launch_bounds__(kPix)
tile_fwd_composite(const float* __restrict__ slab, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count, const int* __restrict__ item_off,
                   int n_tiles, const float* __restrict__ trans,
                   float* __restrict__ part, const float* __restrict__ bg,
                   float* __restrict__ color, float* __restrict__ aux, int tiles_x,
                   int tiles_per_frame, int n_extra) {
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it)) return;
  const int lin = threadIdx.x;
  const Pixel px = pixel_of(it.tile, tiles_x, tiles_per_frame);
  float t_start = 1.0f;
  for (int j = 0; j < it.seg; ++j)
    t_start *= trans[(size_t)(it.first_item + j) * kPix + lin];
  const bool item_live = t_start >= kTEarlyStop;

  Accum a;
  accum_init(a, t_start);
  bool live = item_live, stopped = false, has_med = false;
  const int rank0 = it.seg * kSeg;
  const float* src = slab + (size_t)(tile_start[it.tile] + rank0) * kF;
  const int n = min(kSeg, tile_count[it.tile] - rank0);
  const int nc = (n + kChunk - 1) / kChunk;
  const RowRing<kChunk> ring{rows, bar};
  ring.init();

  if (__syncthreads_or(item_live)) {
    if (threadIdx.x == 0) {
      ring.load(0, src, min(kChunk, n));
      if (nc > 1) ring.load(1, src + kChunk * kF, min(kChunk, n - kChunk));
    }
    int c = 0;
    for (; c < nc; ++c) {
      ring.wait(c);
      const float* st = ring.stage(c);
      const int m = min(kChunk, n - c * kChunk);
      if (live) {
        for (int k = 0; k < m; ++k) {
          const float* row = st + k * kF;
          const Response r = splat_response(row, px.x, px.y, px.q);
          const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
          if (!is_candidate(r, alpha)) continue;
          const float t_next = a.T * (1.0f - alpha);
          if (t_next < kTEarlyStop) {  // first entry not included: done
            live = false;
            stopped = true;
            break;
          }
          const float w = alpha * a.T;
          a.c[0] += w * row[kRGB];
          a.c[1] += w * row[kRGB + 1];
          a.c[2] += w * row[kRGB + 2];
#pragma unroll
          for (int e = 0; e < kMaxExtra; ++e)
            if (e < n_extra) a.ex[e] += w * row[kEXTRA + e];
          a.d += w * r.depth;
          a.n[0] += w * row[kNRM];
          a.n[1] += w * row[kNRM + 1];
          a.n[2] += w * row[kNRM + 2];
          const float mdepth = ndc_depth(fmaxf(r.depth, 1e-6f));
          a.s1 += w * mdepth;
          a.s2 += w * mdepth * mdepth;
          if (a.T > 0.5f) {  // median: last composited entry with T(before) > 0.5
            a.med_d = r.depth;
            a.med_w = w;
            has_med = true;
          }
          a.ncon = (float)(rank0 + c * kChunk + k + 1);
          a.T = t_next;
        }
      }
      if (!__syncthreads_or(live)) break;
      if (threadIdx.x == 0 && c + 2 < nc)
        ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF,
                  min(kChunk, n - (c + 2) * kChunk));
    }
    if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
  }

  if (it.n_items == 1) {
    write_pixel(a, it.tile, bg, color, aux, n_extra);
    return;
  }
  const int nchan = 3 + n_extra;
  float* p = part + (size_t)blockIdx.x * (kPColor + nchan) * kPix + lin;
  p[kPFlags * kPix] = (float)((item_live ? kLive : 0) | (stopped ? kStopped : 0) |
                              (has_med ? kHasMedian : 0));
  if (!item_live) return;
  p[kPDepth * kPix] = a.d;
  p[kPNrm * kPix] = a.n[0];
  p[(kPNrm + 1) * kPix] = a.n[1];
  p[(kPNrm + 2) * kPix] = a.n[2];
  p[kPS1 * kPix] = a.s1;
  p[kPS2 * kPix] = a.s2;
  p[kPMedD * kPix] = a.med_d;
  p[kPMedW * kPix] = a.med_w;
  p[kPNcon * kPix] = a.ncon;
  p[kPTEnd * kPix] = a.T;
#pragma unroll
  for (int i = 0; i < 3; ++i) p[(kPColor + i) * kPix] = a.c[i];
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e)
    if (e < n_extra) p[(kPColor + 3 + e) * kPix] = a.ex[e];
}

// F3: combine the partials of each tile of several items (and write the
// background of empty tiles)
__global__ void __launch_bounds__(kPix)
tile_fwd_combine(const int* __restrict__ item_off, const float* __restrict__ part,
                 const float* __restrict__ bg, float* __restrict__ color,
                 float* __restrict__ aux, int n_extra) {
  const int t = blockIdx.x;
  const int first = item_off[t];
  const int ni = item_off[t + 1] - first;
  if (ni == 1) return;  // written by F2
  const int nchan = 3 + n_extra;
  Accum a;
  accum_init(a, 1.0f);
  for (int j = 0; j < ni; ++j) {
    const float* p = part + (size_t)(first + j) * (kPColor + nchan) * kPix + threadIdx.x;
    const int flags = (int)p[kPFlags * kPix];
    if (!(flags & kLive)) break;
    a.d += p[kPDepth * kPix];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.n[i] += p[(kPNrm + i) * kPix];
      a.c[i] += p[(kPColor + i) * kPix];
    }
#pragma unroll
    for (int e = 0; e < kMaxExtra; ++e)
      if (e < n_extra) a.ex[e] += p[(kPColor + 3 + e) * kPix];
    a.s1 += p[kPS1 * kPix];
    a.s2 += p[kPS2 * kPix];
    if (flags & kHasMedian) {
      a.med_d = p[kPMedD * kPix];
      a.med_w = p[kPMedW * kPix];
    }
    const float ncon = p[kPNcon * kPix];
    if (ncon > 0.0f) a.ncon = ncon;  // ranks grow with the item index
    a.T = p[kPTEnd * kPix];
    if (flags & kStopped) break;
  }
  write_pixel(a, t, bg, color, aux, n_extra);
}

}  // namespace vidu4d

// Launches F1, F2, F3 on `stream`. trans (n_blocks, 256) and part
// (n_blocks, 11 + 3 + n_extra, 256) are scratch; n_blocks bounds the item
// count (tile_forward.py:work_list). Returns the first launch error.
extern "C" int vidu4d_tile_forward(const float* slab, const int* tile_start,
                                   const int* tile_count, const int* item_off,
                                   const float* bg, float* trans, float* part,
                                   float* color, float* aux, int n_tiles,
                                   int n_blocks, int tiles_x, int tiles_per_frame,
                                   int n_extra, void* stream) {
  using namespace vidu4d;
  if (n_tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n_blocks > 0) {
    tile_fwd_transmit<<<n_blocks, kPix, 0, s>>>(slab, tile_start, tile_count, item_off,
                                                n_tiles, trans, tiles_x, tiles_per_frame);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_fwd_composite<<<n_blocks, kPix, 0, s>>>(slab, tile_start, tile_count, item_off,
                                                 n_tiles, trans, part, bg, color, aux,
                                                 tiles_x, tiles_per_frame, n_extra);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  tile_fwd_combine<<<n_tiles, kPix, 0, s>>>(item_off, part, bg, color, aux, n_extra);
  return (int)cudaGetLastError();
}

// the item size and the fixed partial channels, for the wrappers' check of
// the work list and the partials buffer they allocate
extern "C" int vidu4d_tile_seg() { return vidu4d::kSeg; }
extern "C" int vidu4d_tile_part_fixed() { return vidu4d::kPColor; }

extern "C" const char* vidu4d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
