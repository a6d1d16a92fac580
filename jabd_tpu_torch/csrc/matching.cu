// Front half of anchor <-> ground-truth matching, without the [B, G, P]
// overlap tensor, in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of jabd_tpu/ops/matching_pallas.py
// (launched by `_match_front`, grid (B, P / 4096)) and the cross-tile argmax
// that follows it. Same results as the plain version `match_front_plain` in
// jabd_tpu_torch/ops/matching.py, bit for bit:
//   overlaps[g, p] = inter / ((area_t + area_p) - inter), -1 on padded rows;
//   per prior p: the best overlap over g and its index (the lowest g on ties);
//   per GT g:    the best prior over all priors (the lowest p on ties), 0 for
//                a padded row.
//
// Layout: grid (ceil(P / 1024) tiles, B); a block of 256 threads owns a tile
// of 1024 priors, 4 per thread at stride 256 (warps read and write
// neighbouring priors), with their corners, areas and running best
// (overlap, g) in registers. The image's GT rows (<= 256, one per thread)
// sit in shared memory.
//
// 1. Tile culling. The block reduces its priors' corners to the tile's
//    bounding box (PX1, PY1, PX2, PY2), from the same corner arithmetic as
//    the IoU. A valid GT with fminf(tx2, PX2) - fmaxf(tx1, PX1) <= 0 (or the
//    same in y) has iw or ih = 0 on every prior of the tile, since min, max
//    and rounded subtraction are monotone, so its IoU there is +0 exactly
//    (union > 0). Such a GT costs O(1): its tile maximum is (+0, the tile's
//    first prior), and per prior it only matters as the image's first valid
//    row j0, the argmax when every overlap is 0. So each prior's running
//    best starts at (+0, j0) when the image has a valid row, else (-1, 0),
//    and only the unculled valid rows are visited, in ascending order, with
//    a strict '>': the first of tied maxima stays, as torch.argmax keeps it.
// 2. Per-GT best prior in a warp. Valid rows give IoU >= +0, whose float
//    bits order as uint32: __reduce_max_sync on the bits, then
//    __reduce_min_sync on the prior index of the lanes holding the maximum
//    (within a thread the lower k is the lower p). A pair with inter == 0
//    skips the IEEE division: its IoU is +0.
// 3. Cross-tile combine in the launch. Per valid GT each block writes the
//    key (IoU bits << 32 | ~p) of its tile maximum to scratch, fences and
//    counts itself on a per-image counter; the last block of the image takes
//    the largest key over the tiles (the largest IoU, then the lowest p,
//    which is the first tile on ties), writes best_prior_idx as int64 and
//    resets the counter to 0 for the next launch. The wrapper allocates the
//    counters zeroed once per device and stream.
//
// Bit-exactness: prior corners from cxcywh as the plain version computes them
// (cx - w / 2, ...), areas and the IoU in its operation order with IEEE
// division; the build uses -fmad=false and no fast math, so no multiply-add
// is contracted. Inputs are assumed finite with union > 0 on valid rows and
// no coordinate equal to -0.0 (fmaxf/fminf, '>' and the +0 shortcuts differ
// from torch only on NaN and on negative zero).
//
// What bounds it on an H100: it reads B*G*17 + P*16 bytes and writes B*P*12
// + B*G*8 (plus B*T*G*8 of scratch), and does ~13 float operations per
// (valid GT, prior) pair in the dense count; culling leaves only the pairs
// whose GT meets the tile's box, a few horizontal strips per pyramid level
// for a small face, and all of them on the coarsest level's tiles. What
// remains is latency per visited row: the IoU of 4 priors, two warp
// reductions and a shared-memory store, serial over the block's visited
// rows (up to G on the last tiles), then the image's last block. At 64
// registers 4 blocks fit an SM, so the 986 blocks of B 34 at 840x840 run in
// two waves. Tried and slower: starting the last (heaviest) tiles first,
// unrolling the row loop, capping registers for more blocks per SM (spills),
// and culling again per warp with 4 consecutive priors per thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = kThreads;  // one GT row per thread in the set-up
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Orders (IoU, p) by IoU, then by the lower p. IoU >= +0.
__device__ __forceinline__ u64 make_key(unsigned iou_bits, unsigned p) {
  return (static_cast<u64>(iou_bits) << 32) | static_cast<unsigned>(~p);
}

__device__ __forceinline__ u64 max_key(u64 a, u64 b) { return b > a ? b : a; }

__global__ void __launch_bounds__(kThreads)
match_front_kernel(const float4* __restrict__ truths,  // [B, G] of (x1, y1, x2, y2)
                   const uint8_t* __restrict__ valid,  // [B, G] 0/1
                   const float4* __restrict__ priors,  // [P] of (cx, cy, w, h)
                   float* __restrict__ bt_ov,          // [B, P]
                   int64_t* __restrict__ bt_ix,        // [B, P]
                   int64_t* __restrict__ bp_ix,        // [B, G]
                   u64* tile_key,                      // [B, T, G] scratch
                   unsigned* counters,                 // [B], zero between launches
                   int g, int p) {
  __shared__ float s_x1[kMaxG], s_y1[kMaxG], s_x2[kMaxG], s_y2[kMaxG];
  __shared__ float s_area[kMaxG];
  __shared__ int s_rows[kMaxG];  // unculled valid rows, ascending
  __shared__ u64 s_key[kMaxG][kWarps];
  __shared__ float s_box[kWarps][4];
  __shared__ int s_hits[kWarps];
  __shared__ int s_first[kWarps];
  __shared__ bool s_last;

  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = tile * kTile;

  // This tile's priors and their bounding box.
  float px1[kPerThread], py1[kPerThread], px2[kPerThread], py2[kPerThread];
  float parea[kPerThread];
  bool in[kPerThread];
  float bx1 = INFINITY, by1 = INFINITY, bx2 = -INFINITY, by2 = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int pk = base + k * kThreads + tid;
    in[k] = pk < p;
    px1[k] = py1[k] = px2[k] = py2[k] = parea[k] = 0.0f;
    if (in[k]) {
      const float4 pr = priors[pk];
      px1[k] = pr.x - pr.z / 2.0f;
      py1[k] = pr.y - pr.w / 2.0f;
      px2[k] = pr.x + pr.z / 2.0f;
      py2[k] = pr.y + pr.w / 2.0f;
      parea[k] = (px2[k] - px1[k]) * (py2[k] - py1[k]);
      bx1 = fminf(bx1, px1[k]);
      by1 = fminf(by1, py1[k]);
      bx2 = fmaxf(bx2, px2[k]);
      by2 = fmaxf(by2, py2[k]);
    }
  }
  bx1 = warp_min(bx1);
  by1 = warp_min(by1);
  bx2 = warp_max(bx2);
  by2 = warp_max(by2);
  if (lane == 0) {
    s_box[warp][0] = bx1;
    s_box[warp][1] = by1;
    s_box[warp][2] = bx2;
    s_box[warp][3] = by2;
  }

  // This thread's GT row.
  const int j = tid;
  bool v = false;
  float tx1 = 0.0f, ty1 = 0.0f, tx2 = 0.0f, ty2 = 0.0f;
  if (j < g) {
    const float4 t = truths[static_cast<size_t>(b) * g + j];
    tx1 = t.x;
    ty1 = t.y;
    tx2 = t.z;
    ty2 = t.w;
    s_x1[j] = tx1;
    s_y1[j] = ty1;
    s_x2[j] = tx2;
    s_y2[j] = ty2;
    s_area[j] = (tx2 - tx1) * (ty2 - ty1);
    v = valid[static_cast<size_t>(b) * g + j] != 0;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bx1 = fminf(bx1, s_box[w][0]);
    by1 = fminf(by1, s_box[w][1]);
    bx2 = fmaxf(bx2, s_box[w][2]);
    by2 = fmaxf(by2, s_box[w][3]);
  }
  const bool hit = v && fminf(tx2, bx2) - fmaxf(tx1, bx1) > 0.0f &&
                   fminf(ty2, by2) - fmaxf(ty1, by1) > 0.0f;
  const unsigned hits = __ballot_sync(kFull, hit);
  const unsigned valids = __ballot_sync(kFull, v);
  if (lane == 0) {
    s_hits[warp] = __popc(hits);
    s_first[warp] = valids ? warp * 32 + __ffs(valids) - 1 : INT32_MAX;
  }
  __syncthreads();
  int offset = 0, n_hit = 0, j0 = INT32_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    offset += w < warp ? s_hits[w] : 0;
    n_hit += s_hits[w];
    j0 = min(j0, s_first[w]);
  }
  if (hit) s_rows[offset + __popc(hits & ((1u << lane) - 1u))] = j;
  __syncthreads();

  float best[kPerThread];
  int bidx[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    best[k] = j0 == INT32_MAX ? -1.0f : 0.0f;
    bidx[k] = j0 == INT32_MAX ? 0 : j0;
  }

  for (int q = 0; q < n_hit; ++q) {
    const int r = s_rows[q];
    const float rx1 = s_x1[r], ry1 = s_y1[r], rx2 = s_x2[r], ry2 = s_y2[r];
    const float area_t = s_area[r];
    unsigned gv = 0u, gi = kFull;  // (IoU bits, prior) of this thread's first maximum
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!in[k]) continue;
      const float iw = fmaxf(fminf(rx2, px2[k]) - fmaxf(rx1, px1[k]), 0.0f);
      const float ih = fmaxf(fminf(ry2, py2[k]) - fmaxf(ry1, py1[k]), 0.0f);
      const float inter = iw * ih;
      float iou = 0.0f;
      if (inter != 0.0f) iou = inter / ((area_t + parea[k]) - inter);
      if (iou > best[k]) {
        best[k] = iou;
        bidx[k] = r;
      }
      const unsigned bits = __float_as_uint(iou);
      if (bits > gv || gi == kFull) {  // k ascending is p ascending: the first p stays
        gv = bits;
        gi = base + k * kThreads + tid;
      }
    }
    const unsigned wmax = __reduce_max_sync(kFull, gv);
    const unsigned wmin = __reduce_min_sync(kFull, gv == wmax ? gi : kFull);
    if (lane == 0) s_key[r][warp] = make_key(wmax, wmin);
  }
  __syncthreads();

  // Per valid GT, this tile's maximum; a culled row scores +0 on every
  // prior of the tile, so its first maximum is the tile's first prior.
  u64* keys = tile_key + (static_cast<size_t>(b) * ntiles + tile) * g;
  if (v) {
    u64 key = make_key(0u, base);
    if (hit) {
      key = s_key[j][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) key = max_key(key, s_key[j][w]);
    }
    keys[j] = key;
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (in[k]) {
      const size_t o = static_cast<size_t>(b) * p + base + k * kThreads + tid;
      bt_ov[o] = best[k];
      bt_ix[o] = bidx[k];
    }
  }

  // The image's last block combines its tiles.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[b], 1u) == static_cast<unsigned>(ntiles - 1);
  __syncthreads();
  if (!s_last) return;
  if (j < g) {
    int64_t out = 0;  // a padded row scores -1 everywhere: argmax 0
    if (v) {
      u64 key = 0ull;
#pragma unroll 8
      for (int t = 0; t < ntiles; ++t) {
        key = max_key(key, __ldcg(tile_key + (static_cast<size_t>(b) * ntiles + t) * g + j));
      }
      out = static_cast<unsigned>(~static_cast<unsigned>(key));
    }
    bp_ix[static_cast<size_t>(b) * g + j] = out;
  }
  if (tid == 0) counters[b] = 0u;
}

}  // namespace

extern "C" int jabd_match_max_g() { return kMaxG; }

extern "C" int jabd_match_tile() { return kTile; }

// Returns a cudaError_t (0 on success). tile_key holds batch * ceil(p /
// kTile) * g words of scratch; counters holds batch zeros, and is left
// zeroed.
extern "C" int jabd_match_front(const void* truths, const void* valid, const void* priors,
                                void* bt_ov, void* bt_ix, void* bp_ix, void* tile_key,
                                void* counters, int batch, int g, int p, void* stream) {
  if (batch <= 0 || batch > 65535 || g <= 0 || g > kMaxG || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p + kTile - 1) / kTile, batch);
  match_front_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(truths), static_cast<const uint8_t*>(valid),
      static_cast<const float4*>(priors), static_cast<float*>(bt_ov),
      static_cast<int64_t*>(bt_ix), static_cast<int64_t*>(bp_ix),
      static_cast<u64*>(tile_key), static_cast<unsigned*>(counters), g, p);
  return static_cast<int>(cudaGetLastError());
}
