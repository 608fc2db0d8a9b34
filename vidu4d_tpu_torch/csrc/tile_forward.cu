// Forward tile compositor for the 2DGS surfel rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel vidu4d_tpu/ops/rasterize/pallas_kernel.py:
// _make_kernel (launched by forward_tiles_pallas, :470-521): front-to-back
// alpha compositing of each tile's depth-sorted entries (TILE x TILE pixels,
// TILE in kTileSides; JAX's tile argument), with the
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

// pixel lin's outputs from its totals (background composited with T_fin)
template <int TILE>
__device__ __forceinline__ void write_pixel(const Accum& a, int tile, int lin, const float* bg,
                                            float* color, float* aux, int n_extra) {
  constexpr int kPix = TileShape<TILE>::kPix;
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
template <int TILE>
__global__ void __launch_bounds__(TileShape<TILE>::kThreads)
tile_fwd_transmit(const float* __restrict__ slab, const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, const int* __restrict__ item_off,
                  int n_tiles, float* __restrict__ trans, int tiles_x,
                  int tiles_per_frame) {
  using S = TileShape<TILE>;
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it) || it.seg == it.n_items - 1) return;
  Pixel px[S::kPPT];
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j)
    px[j] = pixel_of<TILE>(it.tile, threadIdx.x + j * S::kThreads, tiles_x, tiles_per_frame);
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

  float P[S::kPPT];
  bool live[S::kPPT];
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j) {
    P[j] = 1.0f;
    live[j] = true;
  }
  int c = 0;
  for (; c < nc; ++c) {
    ring.wait(c);
    const float* st = ring.stage(c);
    const int m = min(kChunk, n - c * kChunk);
    bool any_live = false;
#pragma unroll
    for (int j = 0; j < S::kPPT; ++j) {
      if (live[j]) {
        for (int k = 0; k < m; ++k) {
          const Response r = splat_response(st + k * kF, px[j].x, px[j].y);
          const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
          if (!is_candidate(r, alpha)) continue;
          P[j] *= 1.0f - alpha;
          if (P[j] < kTEarlyStop) {  // every later item is dead for this pixel
            live[j] = false;
            break;
          }
        }
      }
      any_live |= live[j];
    }
    if (!__syncthreads_or(any_live)) break;
    if (threadIdx.x == 0 && c + 2 < nc)
      ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF, min(kChunk, n - (c + 2) * kChunk));
  }
  if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j)
    trans[(size_t)blockIdx.x * S::kPix + threadIdx.x + j * S::kThreads] = P[j];
}

// F2: composite one item from T_start; partials (or, for a tile of one
// item, the outputs)
template <int TILE>
__global__ void __launch_bounds__(TileShape<TILE>::kThreads)
tile_fwd_composite(const float* __restrict__ slab, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count, const int* __restrict__ item_off,
                   int n_tiles, const float* __restrict__ trans,
                   float* __restrict__ part, const float* __restrict__ bg,
                   float* __restrict__ color, float* __restrict__ aux, int tiles_x,
                   int tiles_per_frame, int n_extra) {
  using S = TileShape<TILE>;
  constexpr int kPix = S::kPix;
  __shared__ __align__(128) float rows[2 * kChunk * kF];
  __shared__ __align__(8) uint64_t bar[2];
  Item it;
  if (!find_item(item_off, n_tiles, blockIdx.x, &it)) return;
  Pixel px[S::kPPT];
  Accum a[S::kPPT];
  bool item_live[S::kPPT], live[S::kPPT], stopped[S::kPPT], has_med[S::kPPT];
  bool any_item_live = false;
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j) {
    const int lin = threadIdx.x + j * S::kThreads;
    px[j] = pixel_of<TILE>(it.tile, lin, tiles_x, tiles_per_frame);
    float t_start = 1.0f;
    for (int i = 0; i < it.seg; ++i)
      t_start *= trans[(size_t)(it.first_item + i) * kPix + lin];
    item_live[j] = t_start >= kTEarlyStop;
    accum_init(a[j], t_start);
    live[j] = item_live[j];
    stopped[j] = has_med[j] = false;
    any_item_live |= item_live[j];
  }

  const int rank0 = it.seg * kSeg;
  const float* src = slab + (size_t)(tile_start[it.tile] + rank0) * kF;
  const int n = min(kSeg, tile_count[it.tile] - rank0);
  const int nc = (n + kChunk - 1) / kChunk;
  const RowRing<kChunk> ring{rows, bar};
  ring.init();

  if (__syncthreads_or(any_item_live)) {
    if (threadIdx.x == 0) {
      ring.load(0, src, min(kChunk, n));
      if (nc > 1) ring.load(1, src + kChunk * kF, min(kChunk, n - kChunk));
    }
    int c = 0;
    for (; c < nc; ++c) {
      ring.wait(c);
      const float* st = ring.stage(c);
      const int m = min(kChunk, n - c * kChunk);
      bool any_live = false;
#pragma unroll
      for (int j = 0; j < S::kPPT; ++j) {
        Accum& aj = a[j];
        if (live[j]) {
          for (int k = 0; k < m; ++k) {
            const float* row = st + k * kF;
            const Response r = splat_response(row, px[j].x, px[j].y);
            const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
            if (!is_candidate(r, alpha)) continue;
            const float t_next = aj.T * (1.0f - alpha);
            if (t_next < kTEarlyStop) {  // first entry not included: done
              live[j] = false;
              stopped[j] = true;
              break;
            }
            const float w = alpha * aj.T;
            aj.c[0] += w * row[kRGB];
            aj.c[1] += w * row[kRGB + 1];
            aj.c[2] += w * row[kRGB + 2];
#pragma unroll
            for (int e = 0; e < kMaxExtra; ++e)
              if (e < n_extra) aj.ex[e] += w * row[kEXTRA + e];
            aj.d += w * r.depth;
            aj.n[0] += w * row[kNRM];
            aj.n[1] += w * row[kNRM + 1];
            aj.n[2] += w * row[kNRM + 2];
            const float mdepth = ndc_depth(fmaxf(r.depth, 1e-6f));
            aj.s1 += w * mdepth;
            aj.s2 += w * mdepth * mdepth;
            if (aj.T > 0.5f) {  // median: last composited entry with T(before) > 0.5
              aj.med_d = r.depth;
              aj.med_w = w;
              has_med[j] = true;
            }
            aj.ncon = (float)(rank0 + c * kChunk + k + 1);
            aj.T = t_next;
          }
        }
        any_live |= live[j];
      }
      if (!__syncthreads_or(any_live)) break;
      if (threadIdx.x == 0 && c + 2 < nc)
        ring.load(c + 2, src + (size_t)(c + 2) * kChunk * kF,
                  min(kChunk, n - (c + 2) * kChunk));
    }
    if (threadIdx.x == 0 && c + 1 < nc) ring.settle(c + 1);  // a copy still in flight
  }

  const int nchan = 3 + n_extra;
#pragma unroll
  for (int j = 0; j < S::kPPT; ++j) {
    const int lin = threadIdx.x + j * S::kThreads;
    const Accum& aj = a[j];
    if (it.n_items == 1) {
      write_pixel<TILE>(aj, it.tile, lin, bg, color, aux, n_extra);
      continue;
    }
    float* p = part + (size_t)blockIdx.x * (kPColor + nchan) * kPix + lin;
    p[kPFlags * kPix] = (float)((item_live[j] ? kLive : 0) | (stopped[j] ? kStopped : 0) |
                                (has_med[j] ? kHasMedian : 0));
    if (!item_live[j]) continue;
    p[kPDepth * kPix] = aj.d;
    p[kPNrm * kPix] = aj.n[0];
    p[(kPNrm + 1) * kPix] = aj.n[1];
    p[(kPNrm + 2) * kPix] = aj.n[2];
    p[kPS1 * kPix] = aj.s1;
    p[kPS2 * kPix] = aj.s2;
    p[kPMedD * kPix] = aj.med_d;
    p[kPMedW * kPix] = aj.med_w;
    p[kPNcon * kPix] = aj.ncon;
    p[kPTEnd * kPix] = aj.T;
#pragma unroll
    for (int i = 0; i < 3; ++i) p[(kPColor + i) * kPix] = aj.c[i];
#pragma unroll
    for (int e = 0; e < kMaxExtra; ++e)
      if (e < n_extra) p[(kPColor + 3 + e) * kPix] = aj.ex[e];
  }
}

// F3: combine the partials of each tile of several items (and write the
// background of empty tiles)
template <int TILE>
__global__ void __launch_bounds__(TileShape<TILE>::kThreads)
tile_fwd_combine(const int* __restrict__ item_off, const float* __restrict__ part,
                 const float* __restrict__ bg, float* __restrict__ color,
                 float* __restrict__ aux, int n_extra) {
  using S = TileShape<TILE>;
  constexpr int kPix = S::kPix;
  const int t = blockIdx.x;
  const int first = item_off[t];
  const int ni = item_off[t + 1] - first;
  if (ni == 1) return;  // written by F2
  const int nchan = 3 + n_extra;
#pragma unroll
  for (int jp = 0; jp < S::kPPT; ++jp) {
    const int lin = threadIdx.x + jp * S::kThreads;
    Accum a;
    accum_init(a, 1.0f);
    for (int j = 0; j < ni; ++j) {
      const float* p = part + (size_t)(first + j) * (kPColor + nchan) * kPix + lin;
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
    write_pixel<TILE>(a, t, lin, bg, color, aux, n_extra);
  }
}

template <int TILE>
int launch_forward(const float* slab, const int* tile_start, const int* tile_count,
                   const int* item_off, const float* bg, float* trans, float* part,
                   float* color, float* aux, int n_tiles, int n_blocks, int tiles_x,
                   int tiles_per_frame, int n_extra, cudaStream_t s) {
  constexpr int kThreads = TileShape<TILE>::kThreads;
  cudaError_t err;
  if (n_blocks > 0) {
    tile_fwd_transmit<TILE><<<n_blocks, kThreads, 0, s>>>(
        slab, tile_start, tile_count, item_off, n_tiles, trans, tiles_x, tiles_per_frame);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_fwd_composite<TILE><<<n_blocks, kThreads, 0, s>>>(
        slab, tile_start, tile_count, item_off, n_tiles, trans, part, bg, color, aux,
        tiles_x, tiles_per_frame, n_extra);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  tile_fwd_combine<TILE><<<n_tiles, kThreads, 0, s>>>(item_off, part, bg, color, aux, n_extra);
  return (int)cudaGetLastError();
}

}  // namespace vidu4d

// Launches F1, F2, F3 at tile side `tile` (one of kTileSides, else
// cudaErrorInvalidValue before any launch) on `stream`. trans (n_blocks,
// tile^2) and part (n_blocks, 11 + 3 + n_extra, tile^2) are scratch;
// n_blocks bounds the item count (tile_forward.py:work_list). Returns the
// first launch error.
extern "C" int vidu4d_tile_forward(const float* slab, const int* tile_start,
                                   const int* tile_count, const int* item_off,
                                   const float* bg, float* trans, float* part,
                                   float* color, float* aux, int n_tiles,
                                   int n_blocks, int tiles_x, int tiles_per_frame,
                                   int tile, int n_extra, void* stream) {
  using namespace vidu4d;
  if (tile != 8 && tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto* launch = tile == 8 ? launch_forward<8> : tile == 16 ? launch_forward<16>
                                                            : launch_forward<32>;
  return launch(slab, tile_start, tile_count, item_off, bg, trans, part, color, aux,
                n_tiles, n_blocks, tiles_x, tiles_per_frame, n_extra, s);
}

// the item size, the fixed partial channels and the tile sides, for the
// wrappers' check of the work list, the partials buffer they allocate and
// the sides they take
extern "C" int vidu4d_tile_seg() { return vidu4d::kSeg; }
extern "C" int vidu4d_tile_part_fixed() { return vidu4d::kPColor; }
extern "C" int vidu4d_tile_side_count() { return vidu4d::kNumTileSides; }
extern "C" int vidu4d_tile_side(int i) {
  return 0 <= i && i < vidu4d::kNumTileSides ? vidu4d::kTileSides[i] : 0;
}

extern "C" const char* vidu4d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
