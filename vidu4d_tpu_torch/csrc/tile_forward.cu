// Forward tile compositor for the 2DGS surfel rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel vidu4d_tpu/ops/rasterize/pallas_kernel.py:
// _make_kernel (launched by forward_tiles_pallas, :470-521).
//
// Work split: one 256-thread block per (frame, 16x16 tile), one thread per
// pixel. The tile's depth-sorted slab rows [start, start + count) are staged
// through shared memory 128 rows (16 KB) at a time; each thread composites
// them front to back with the Pallas kernel's cull and include rules and
// leaves the loop at its first entry that is not included (T would fall
// below 1e-4). The block stops staging once no thread is live
// (__syncthreads_or), the tile-level early-out of the Pallas kernel.
//
// What bounds it: per (entry, pixel) ~40 FLOPs and one expf against one
// 128-byte slab row per entry shared by 256 pixels, so it is compute- and
// latency-bound, not bandwidth-bound; deep tiles serialise on the per-thread
// entry loop. The simple design keeps entries in shared memory (broadcast
// reads) and lets warps that finish early idle; TMA staging and persistent
// blocks are later work.
//
// Per pixel it writes color (3 + n_extra channels, background composited
// with the final T) and 12 aux channels:
//   0 depth, 1 alpha, 2-4 normal, 5 median depth, 6 distortion,
//   7 median weight, 8 T after the last included entry, 9 n_contrib,
//   10 S1 = sum w*m, 11 S2 = sum w*m^2   (8-11 are the backward's residuals)
#include "tile_common.cuh"

namespace vidu4d {

constexpr int kChunk = 128;  // slab rows staged per step

__global__ void __launch_bounds__(kPix)
tile_forward_kernel(const float* __restrict__ slab,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count,
                    const float* __restrict__ bg,
                    float* __restrict__ color,
                    float* __restrict__ aux,
                    int tiles_x, int tiles_per_frame, int n_extra) {
  __shared__ __align__(16) float rows[kChunk * kF];

  const int t = blockIdx.x;
  const int tl = t % tiles_per_frame;
  const int lin = threadIdx.x;
  const float pxf = (float)((tl % tiles_x) * kTile + lin % kTile) + 0.5f;
  const float pyf = (float)((tl / tiles_x) * kTile + lin / kTile) + 0.5f;
  const float pq = kFilterInvSquare * (pxf * pxf + pyf * pyf);
  const int start = tile_start[t];
  const int count = tile_count[t];

  float T = 1.0f;  // transmittance before the next entry
  float cr = 0.f, cg = 0.f, cb = 0.f, d_acc = 0.f;
  float nx = 0.f, ny = 0.f, nz = 0.f, s1 = 0.f, s2 = 0.f;
  float med_d = 0.f, med_w = 0.f;
  int ncon = 0;
  float ex[kMaxExtra];
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e) ex[e] = 0.f;
  bool live = true;

  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();
    stage_rows(rows, slab + (size_t)(start + base) * kF, n);
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float* row = rows + k * kF;
        const Response r = splat_response(row, pxf, pyf, pq);
        const float alpha = min_nan(r.alpha_raw, kAlphaClamp);
        if (!(r.pz_ok && r.depth >= kNear && alpha >= kAlphaEps)) continue;
        const float t_next = T * (1.0f - alpha);
        if (t_next < kTEarlyStop) {  // first entry not included: done
          live = false;
          break;
        }
        const float w = alpha * T;
        cr += w * row[kRGB];
        cg += w * row[kRGB + 1];
        cb += w * row[kRGB + 2];
#pragma unroll
        for (int e = 0; e < kMaxExtra; ++e)
          if (e < n_extra) ex[e] += w * row[kEXTRA + e];
        d_acc += w * r.depth;
        nx += w * row[kNRM];
        ny += w * row[kNRM + 1];
        nz += w * row[kNRM + 2];
        const float m = ndc_depth(fmaxf(r.depth, 1e-6f));
        s1 += w * m;
        s2 += w * m * m;
        if (T > 0.5f) {  // median: last composited entry with T(before) > 0.5
          med_d = r.depth;
          med_w = w;
        }
        ncon = base + k + 1;
        T = t_next;
      }
    }
    if (!__syncthreads_or(live)) break;
  }

  const int nchan = 3 + n_extra;
  float* c = color + ((size_t)t * kPix + lin) * nchan;
  c[0] = cr + T * bg[0];
  c[1] = cg + T * bg[1];
  c[2] = cb + T * bg[2];
#pragma unroll
  for (int e = 0; e < kMaxExtra; ++e)  // static indices keep ex[] in registers
    if (e < n_extra) c[3 + e] = ex[e] + T * bg[3 + e];
  float* a = aux + ((size_t)t * kPix + lin) * 12;
  a[0] = d_acc;
  a[1] = 1.0f - T;
  a[2] = nx;
  a[3] = ny;
  a[4] = nz;
  a[5] = med_d;
  a[6] = s2 * (1.0f - T) - s1 * s1;  // totals-form distortion
  a[7] = med_w;
  a[8] = T;
  a[9] = (float)ncon;
  a[10] = s1;
  a[11] = s2;
}

}  // namespace vidu4d

extern "C" int vidu4d_tile_forward(const float* slab, const int* tile_start,
                                   const int* tile_count, const float* bg,
                                   float* color, float* aux, int num_blocks,
                                   int tiles_x, int tiles_per_frame,
                                   int n_extra, void* stream) {
  if (num_blocks > 0) {
    vidu4d::tile_forward_kernel<<<num_blocks, vidu4d::kPix, 0,
                                  (cudaStream_t)stream>>>(
        slab, tile_start, tile_count, bg, color, aux, tiles_x,
        tiles_per_frame, n_extra);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vidu4d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
