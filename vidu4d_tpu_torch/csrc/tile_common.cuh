// Shared definitions of the tile-compositing kernels (tile_forward.cu,
// tile_backward.cu): the entry-major property slab layout, the rasterizer
// constants, the per (entry, pixel) splat response, the work list of tile
// segments, and the TMA staging ring.
//
// The slab holds one 32-float row per depth-sorted tile entry, written by
// vidu4d_tpu_torch/ops/rasterize/tile_forward.py:pack_props. Its columns are
// the JAX package's (vidu4d_tpu/ops/rasterize/pallas_kernel.py:60-73): the
// two-plane intersection in affine form p = A + px*B + py*C, the 3D-branch
// depth numerator q = det(Tu, Tv, Tw), Tw.z, opacity, RGB, normal, then the
// extra channels; but where the Pallas kernel stores the 2D low-pass term
// as a polynomial in absolute pixel coordinates (whose float32 terms reach
// kFilterInvSquare * (px^2 + py^2) and cancel), the slab holds the splat's
// projected centre and the response evaluates the term in splat-centred
// coordinates, as the reference does (compositing.py).
//
// Tile side. Every kernel is a template over the side TILE, instantiated
// for kTileSides (8, 16, 32); the C entry points pick one by value. A block
// runs TileShape<TILE>::kThreads = min(TILE^2, 256) threads, each owning
// kPPT = TILE^2 / kThreads pixels (1 at 8 and 16, 4 at 32: 1024 threads of
// the backward's gradient walk would need more registers than an SM has).
// Pixel j of thread t is tile pixel t + j * kThreads; each pixel keeps its
// own early stop, and a block ends when all of its pixels have stopped.
//
// Work list. A tile's entry list is cut into items of at most kSeg
// consecutive entries, and every pass runs one block per item, so no block
// walks more than kSeg entries however deep the tile is. Tile t owns items [item_off[t], item_off[t+1]); item s of
// a tile covers its entries [s * kSeg, min((s + 1) * kSeg, count)). item_off
// is an exclusive cumsum of ceil(count / kSeg), built on the device by the
// wrapper (tile_forward.py:work_list); the grid is a host-known bound
// (tiles + ceil(slab rows / kSeg)) and surplus blocks exit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vidu4d {

// the tile sides the kernels are instantiated for (the wrappers' TILE_SIDES)
constexpr int kNumTileSides = 3;
constexpr int kTileSides[kNumTileSides] = {8, 16, 32};
constexpr int kMaxThreads = 256;        // threads per block at most

template <int TILE>
struct TileShape {
  static constexpr int kPix = TILE * TILE;  // pixels per tile
  static constexpr int kThreads = kPix < kMaxThreads ? kPix : kMaxThreads;
  static constexpr int kPPT = kPix / kThreads;  // pixels per thread
  static_assert(kPix % kThreads == 0 && kThreads % 32 == 0, "whole warps, whole pixels");
};

constexpr int kF = 32;                  // slab row width (floats)
constexpr int kPA = 0, kPB = 3, kPC = 6, kQD = 9, kTW2 = 10;
constexpr int kCX = 11, kCY = 12;      // projected centre (pixels); column 13 is spare
constexpr int kOPAC = 14, kRGB = 15, kNRM = 18;
constexpr int kEXTRA = 21;
constexpr int kMaxExtra = kF - kEXTRA;  // 11
constexpr int kChunk = 128;             // slab rows per staged step (16 KB)
constexpr int kSeg = 256;               // entries per work item (measured: 128-2048)
static_assert(kSeg % kChunk == 0, "items start on staging-step boundaries");

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
  float dx, dy;       // splat-centred offsets cx - px, cy - py of the 2D branch
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
                                                   float pyf) {
  Response r;
  r.px = row[kPA] + pxf * row[kPB] + pyf * row[kPC];
  r.py = row[kPA + 1] + pxf * row[kPB + 1] + pyf * row[kPC + 1];
  r.pz = row[kPA + 2] + pxf * row[kPB + 2] + pyf * row[kPC + 2];
  r.pz_ok = r.pz != 0.0f;
  r.ipz = 1.0f / (r.pz_ok ? r.pz : 1.0f);
  r.rho3d = (r.px * r.px + r.py * r.py) * (r.ipz * r.ipz);
  r.dx = row[kCX] - pxf;
  r.dy = row[kCY] - pyf;
  r.rho2d = kFilterInvSquare * (r.dx * r.dx + r.dy * r.dy);
  r.use3d = r.rho3d <= r.rho2d;
  r.rho = min_nan(r.rho3d, r.rho2d);
  r.depth = r.use3d ? row[kQD] * r.ipz : row[kTW2];
  r.g = expf(-0.5f * r.rho);
  r.alpha_raw = row[kOPAC] * r.g;
  return r;
}

// the cull of both kernels: in front of the near plane, alpha >= 1/255
__device__ __forceinline__ bool is_candidate(const Response& r, float alpha) {
  return r.pz_ok && r.depth >= kNear && alpha >= kAlphaEps;
}

// distortion's NDC-mapped depth (forward.cu:410-416)
__device__ __forceinline__ float ndc_depth(float depth_pos) {
  return (kFar * depth_pos - kFar * kNear) / ((kFar - kNear) * depth_pos);
}

// Absolute centre of pixel `lin` (row-major in the tile) of a (frame, tile)
// block.
struct Pixel {
  float x, y;
};

template <int TILE>
__device__ __forceinline__ Pixel pixel_of(int tile, int lin, int tiles_x,
                                          int tiles_per_frame) {
  const int tl = tile % tiles_per_frame;
  Pixel p;
  p.x = (float)((tl % tiles_x) * TILE + lin % TILE) + 0.5f;
  p.y = (float)((tl / tiles_x) * TILE + lin / TILE) + 0.5f;
  return p;
}

struct Item {
  int tile;        // (frame, tile) block the item belongs to
  int seg;         // its index among the tile's items
  int n_items;     // the tile's item count
  int first_item;  // the tile's first item
};

// Item `item` of the work list; false for a surplus block. Binary search for
// the largest t with item_off[t] <= item (empty tiles own no item).
__device__ __forceinline__ bool find_item(const int* __restrict__ item_off,
                                          int n_tiles, int item, Item* it) {
  if (item >= item_off[n_tiles]) return false;
  int lo = 0, hi = n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (item_off[mid] <= item) lo = mid; else hi = mid - 1;
  }
  it->tile = lo;
  it->first_item = item_off[lo];
  it->seg = item - it->first_item;
  it->n_items = item_off[lo + 1] - it->first_item;
  return true;
}

// ---- TMA staging: 1D bulk copies into shared memory, one mbarrier per stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Two-stage ring of R-row slab stages. Thread 0 issues each stage's copy
// (cp.async.bulk, completion counted in bytes on the stage's mbarrier) and
// waits on the barrier's phase; a __syncthreads then hands the rows to the
// block. (With all of a 256-thread block polling the mbarrier, the walk that
// followed ran several times slower on the H100.) Step c of a walk uses
// stage c & 1, filled for the (c >> 1)-th time. The caller re-fills a stage
// only after a __syncthreads that follows the last read of it.
template <int R>
struct RowRing {
  float* buf;     // 2 * R * kF floats, 16-byte aligned
  uint64_t* bar;  // 2 mbarriers

  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ const float* stage(int c) const {
    return buf + (c & 1) * R * kF;
  }

  // thread 0: start copying n (<= R) rows from src into step c's stage
  __device__ __forceinline__ void load(int c, const float* src, int n) const {
    const uint32_t b = smem_u32(&bar[c & 1]);
    const uint32_t bytes = (uint32_t)n * kF * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(stage(c))), "l"(src), "r"(bytes), "r"(b) : "memory");
  }

  // thread 0: wait until step c's copy has landed
  __device__ __forceinline__ void settle(int c) const {
    const uint32_t b = smem_u32(&bar[c & 1]);
    const uint32_t parity = (uint32_t)(c >> 1) & 1u;
    uint32_t done;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(b), "r"(parity) : "memory");
    } while (!done);
  }

  // all threads: step c's rows are in shared memory after this
  __device__ __forceinline__ void wait(int c) const {
    if (threadIdx.x == 0) settle(c);
    __syncthreads();
  }
};

}  // namespace vidu4d
