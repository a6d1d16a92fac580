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
// (overlap, g) in registers. The image's GT rows are walked in chunks of
// 256 (one row per thread), in ascending order; a chunk's rows sit in
// shared memory while it is in use. Any G: G <= 256 is one chunk.
//
// 1. Tile culling, per chunk. The block reduces its priors' corners to the
//    tile's bounding box (PX1, PY1, PX2, PY2), from the same corner
//    arithmetic as the IoU. A valid GT with fminf(tx2, PX2) - fmaxf(tx1,
//    PX1) <= 0 (or the same in y) has iw or ih = 0 on every prior of the
//    tile, since min, max and rounded subtraction are monotone, so its IoU
//    there is +0 exactly (union > 0). Such a GT costs O(1): its tile maximum
//    is (+0, the tile's first prior), and per prior it only matters as the
//    image's first valid row j0, the argmax when every overlap is 0. So j0
//    is found over all G before the first chunk (at the barrier that also
//    joins the tile's box), each prior's running best starts at (+0, j0), or
//    (-1, 0) when the image has no valid row, and only the unculled valid
//    rows are visited, chunk after chunk in ascending order, with a strict
//    '>' (the first of tied maxima stays, as torch.argmax keeps it, across
//    chunks too).
// 2. Per-GT best prior in a warp. Valid rows give IoU >= +0, whose float
//    bits order as uint32: __reduce_max_sync on the bits, then
//    __reduce_min_sync on the prior index of the lanes holding the maximum
//    (within a thread the lower k is the lower p). A pair with inter == 0
//    skips the IEEE division: its IoU is +0.
// 3. Cross-tile combine in the launch. Per valid GT each block writes the
//    key (IoU bits << 32 | ~p) of its tile maximum to scratch, fences and
//    counts itself on a per-image counter; the last block of the image takes
//    the largest key over the tiles (the largest IoU, then the lowest p,
//    which is the first tile on ties) for every GT, 256 at a time, writes
//    best_prior_idx as int64 and resets the counter to 0 for the next
//    launch. The wrapper allocates the counters zeroed once per device and
//    stream.
//
// Bit-exactness: prior corners from cxcywh as the plain version computes them
// (cx - w / 2, ...), areas and the IoU in its operation order with IEEE
// division; the build uses -fmad=false and no fast math, so no multiply-add
// is contracted. Inputs are assumed finite with union > 0 on valid rows and
// no coordinate equal to -0.0 (fmaxf/fminf, '>' and the +0 shortcuts differ
// from torch only on NaN and on negative zero).
//
// What bounds it on an H100: it reads B*G*17 + P*16 bytes and writes B*P*12
// + B*G*8 (plus B*T*G*8 of scratch: 16 MB at B 34, G 2,048, P 29,126), and
// does ~13 float operations per
// (valid GT, prior) pair in the dense count; culling leaves only the pairs
// whose GT meets the tile's box, a few horizontal strips per pyramid level
// for a small face, and all of them on the coarsest level's tiles. What
// remains is latency per visited row: the IoU of 4 priors, two warp
// reductions and a shared-memory store, serial over the block's visited
// rows (up to G on the last tiles; three barriers a chunk), then the
// image's last block. At 64
// registers 4 blocks fit an SM, so the 986 blocks of B 34 at 840x840 run in
// two waves. The row loop tests no prior against P: with the chunk loop
// around it the compiler kept no predicate registers for that test and
// rebuilt it from tid on every row (5-7% slower at G 128). Tried and
// slower: starting the last (heaviest) tiles first, unrolling the row loop,
// capping registers for more blocks per SM (spills), and culling again per
// warp with 4 consecutive priors per thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // GT rows a chunk: one per thread
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
  __shared__ float s_x1[kChunk], s_y1[kChunk], s_x2[kChunk], s_y2[kChunk];
  __shared__ float s_area[kChunk];
  __shared__ int s_rows[kChunk];  // the chunk's unculled valid rows, ascending
  __shared__ u64 s_key[kChunk][kWarps];
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
  const float4* trow = truths + static_cast<size_t>(b) * g;
  const uint8_t* vrow = valid + static_cast<size_t>(b) * g;

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

  // This thread's GT row of the first chunk, and its first valid row of any
  // chunk, for j0: the image's first valid row.
  int j = tid;
  float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool v = false;
  if (j < g) {
    t = trow[j];
    v = vrow[j] != 0;
  }
  int first = v ? j : INT32_MAX;
  for (int jj = j + kChunk; first == INT32_MAX && jj < g; jj += kChunk) {
    if (vrow[jj] != 0) first = jj;
  }
  first = static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(first)));
  if (lane == 0) s_first[warp] = first;
  __syncthreads();
  int j0 = INT32_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bx1 = fminf(bx1, s_box[w][0]);
    by1 = fminf(by1, s_box[w][1]);
    bx2 = fmaxf(bx2, s_box[w][2]);
    by2 = fmaxf(by2, s_box[w][3]);
    j0 = min(j0, s_first[w]);
  }

  // Running best per prior: (+0, j0), or (-1, 0) when the image has no
  // valid row; only a visited row with a larger overlap replaces it.
  float best[kPerThread];
  int bidx[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    best[k] = j0 == INT32_MAX ? -1.0f : 0.0f;
    bidx[k] = j0 == INT32_MAX ? 0 : j0;
  }
  u64* keys = tile_key + (static_cast<size_t>(b) * ntiles + tile) * g;

  // Chunk after chunk. A chunk's shared rows, keys and counts are rewritten
  // only after every thread has passed the barriers that end their last
  // reads in the chunk before, so a chunk needs no barrier of its own first.
  for (int c0 = 0; c0 < g; c0 += kChunk, j += kChunk) {
    if (c0 > 0) {  // the first chunk's row is already loaded
      t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v = false;
      if (j < g) {
        t = trow[j];
        v = vrow[j] != 0;
      }
    }
    if (j < g) {
      s_x1[tid] = t.x;
      s_y1[tid] = t.y;
      s_x2[tid] = t.z;
      s_y2[tid] = t.w;
      s_area[tid] = (t.z - t.x) * (t.w - t.y);
    }
    const bool hit = v && fminf(t.z, bx2) - fmaxf(t.x, bx1) > 0.0f &&
                     fminf(t.w, by2) - fmaxf(t.y, by1) > 0.0f;
    const unsigned hits = __ballot_sync(kFull, hit);
    if (lane == 0) s_hits[warp] = __popc(hits);
    __syncthreads();
    int offset = 0, n_hit = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? s_hits[w] : 0;
      n_hit += s_hits[w];
    }
    if (hit) s_rows[offset + __popc(hits & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    for (int q = 0; q < n_hit; ++q) {
      const int r = s_rows[q];
      const float rx1 = s_x1[r], ry1 = s_y1[r], rx2 = s_x2[r], ry2 = s_y2[r];
      const float area_t = s_area[r];
      unsigned gv = 0u, gi = kFull;  // (IoU bits, prior) of this thread's first maximum
      // Every k, in range or not: a prior past P has zero corners, so its
      // IoU is +0 and it never beats an in-range prior of the tile, whose p
      // is lower (no test of in[k] in this loop, which the compiler would
      // otherwise rebuild from tid on every row).
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float iw = fmaxf(fminf(rx2, px2[k]) - fmaxf(rx1, px1[k]), 0.0f);
        const float ih = fmaxf(fminf(ry2, py2[k]) - fmaxf(ry1, py1[k]), 0.0f);
        const float inter = iw * ih;
        float iou = 0.0f;
        if (inter != 0.0f) iou = inter / ((area_t + parea[k]) - inter);
        if (iou > best[k]) {
          best[k] = iou;
          bidx[k] = c0 + r;
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
    if (v) {
      u64 key = make_key(0u, base);
      if (hit) {
        key = s_key[tid][0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) key = max_key(key, s_key[tid][w]);
      }
      keys[j] = key;
    }
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
  for (int jj = tid; jj < g; jj += kThreads) {
    int64_t out = 0;  // a padded row scores -1 everywhere: argmax 0
    if (vrow[jj] != 0) {
      u64 key = 0ull;
#pragma unroll 8
      for (int q = 0; q < ntiles; ++q) {
        key = max_key(key, __ldcg(tile_key + (static_cast<size_t>(b) * ntiles + q) * g + jj));
      }
      out = static_cast<unsigned>(~static_cast<unsigned>(key));
    }
    bp_ix[static_cast<size_t>(b) * g + jj] = out;
  }
  if (tid == 0) counters[b] = 0u;
}

}  // namespace

extern "C" int jabd_match_tile() { return kTile; }

// Returns a cudaError_t (0 on success). tile_key holds batch * ceil(p /
// kTile) * g words of scratch; counters holds batch zeros, and is left
// zeroed.
extern "C" int jabd_match_front(const void* truths, const void* valid, const void* priors,
                                void* bt_ov, void* bt_ix, void* bp_ix, void* tile_key,
                                void* counters, int batch, int g, int p, void* stream) {
  if (batch <= 0 || batch > 65535 || g <= 0 || p <= 0) {
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
