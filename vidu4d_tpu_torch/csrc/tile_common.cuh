// Shared definitions of the two tile-compositing kernels (tile_forward.cu,
// tile_backward.cu): the entry-major property slab layout, the rasterizer
// constants, and the per (entry, pixel) splat response.
//
// The slab holds one 32-float row per depth-sorted tile entry, written by
// vidu4d_tpu_torch/ops/rasterize/tile_forward.py:pack_props. Its columns are
// the JAX package's (vidu4d_tpu/ops/rasterize/pallas_kernel.py:60-73): the
// two-plane intersection in affine form p = A + px*B + py*C, the 3D-branch
// depth numerator q = det(Tu, Tv, Tw), Tw.z, the rho2d polynomial
// coefficients, opacity, RGB, normal, then the extra channels.
#pragma once

#include <cuda_runtime.h>

namespace vidu4d {

constexpr int kTile = 16;               // tile side in pixels
constexpr int kPix = kTile * kTile;     // threads per block: one per pixel
constexpr int kF = 32;                  // slab row width (floats)
constexpr int kPA = 0, kPB = 3, kPC = 6, kQD = 9, kTW2 = 10;
constexpr int kE0 = 11, kE1 = 12, kE2 = 13, kOPAC = 14, kRGB = 15, kNRM = 18;
constexpr int kEXTRA = 21;
constexpr int kMaxExtra = kF - kEXTRA;  // 11

// constants pinned by the reference (common.py:31-37), rounded to f32
constexpr float kFilterInvSquare = (float)(1.0 / (0.7071067811865476 * 0.7071067811865476));
constexpr float kNear = 0.2f;
constexpr float kFar = 100.0f;
constexpr float kAlphaEps = (float)(1.0 / 255.0);
constexpr float kTEarlyStop = 1e-4f;
constexpr float kAlphaClamp = 0.99f;

struct Response {
  float px, py, pz;   // homogeneous intersection p = A + px*B + py*C
  float ipz;          // 1 / pz (1 where pz == 0)
  float rho3d, rho2d, rho;
  float depth;        // q / pz on the 3D branch, Tw.z on the 2D branch
  float g;            // exp(-rho / 2)
  float alpha_raw;    // opacity * g, before the 0.99 clamp
  bool pz_ok, use3d;
};

// NaN-propagating min, as jnp.minimum / torch.minimum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a <= b) ? a : b;
}

__device__ __forceinline__ Response splat_response(const float* row, float pxf,
                                                   float pyf, float pq) {
  Response r;
  r.px = row[kPA] + pxf * row[kPB] + pyf * row[kPC];
  r.py = row[kPA + 1] + pxf * row[kPB + 1] + pyf * row[kPC + 1];
  r.pz = row[kPA + 2] + pxf * row[kPB + 2] + pyf * row[kPC + 2];
  r.pz_ok = r.pz != 0.0f;
  r.ipz = 1.0f / (r.pz_ok ? r.pz : 1.0f);
  r.rho3d = (r.px * r.px + r.py * r.py) * (r.ipz * r.ipz);
  r.rho2d = pq + row[kE0] + pxf * row[kE1] + pyf * row[kE2];
  r.use3d = r.rho3d <= r.rho2d;
  r.rho = min_nan(r.rho3d, r.rho2d);
  r.depth = r.use3d ? row[kQD] * r.ipz : row[kTW2];
  r.g = expf(-0.5f * r.rho);
  r.alpha_raw = row[kOPAC] * r.g;
  return r;
}

// distortion's NDC-mapped depth (forward.cu:410-416)
__device__ __forceinline__ float ndc_depth(float depth_pos) {
  return (kFar * depth_pos - kFar * kNear) / ((kFar - kNear) * depth_pos);
}

// Copy n slab rows (n * 32 floats, 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n * (kF / 4); i += blockDim.x) d[i] = s[i];
}

}  // namespace vidu4d
