// Front half of anchor <-> ground-truth matching, without the [B, G, P]
// overlap tensor.
//
// Replaces the Pallas TPU kernel `_kernel` of jabd_tpu/ops/matching_pallas.py
// (launched by `_match_front`, grid (B, P / 4096)). Same results as the plain
// version `match_front_plain` in jabd_tpu_torch/ops/matching.py, bit for bit:
//   overlaps[g, p] = inter / ((area_t + area_p) - inter), -1 on padded rows;
//   per prior p: the best overlap over g and its index (the lowest g on ties);
//   per GT g:    the best overlap over the priors of this block's tile and its
//                prior index (the lowest p on ties).
// The wrapper (ops/matching_cuda.py) takes, per GT, the first tile holding
// the maximum (torch.argmax over the tile axis), which gives the lowest p
// over all priors, as torch.argmax over the dense row does.
//
// Bit-exactness: the prior corners are computed from cxcywh as the plain
// version does (cx - w / 2, ...), areas and the IoU in its operation order
// with IEEE division; the build uses -fmad=false and no fast math, so no
// multiply-add is contracted. Per prior, GTs are visited in ascending order
// with a strict '>' from the initial (-1, 0): padded rows (-1) never win,
// and the first of tied maxima stays. The per-GT reductions break ties
// towards the lower prior index explicitly. Inputs are assumed finite with
// union > 0 on valid rows (fmaxf/fminf and '>' differ from torch only on
// NaN).
//
// Layout: a block of 256 threads owns a tile of 1024 priors, 4 per thread
// at stride 256 (so that warps read and write neighbouring priors), their
// corners, areas and running best (overlap, g) in registers. The image's
// GT rows (<= 256) sit in shared memory. Rows after the last valid one are
// skipped and padded rows inside that range cost nothing: the per-image
// loop runs over valid rows only, as the TPU kernel stops at the last
// valid row. Per GT, each warp reduces its 128 overlaps with shuffles and
// lane 0 leaves (max, first p) in shared memory; one barrier after the GT
// loop, then one thread per GT combines the 8 warps in order.
//
// What bounds it on an H100: neither bytes nor arithmetic at these sizes.
// It reads B*G*17 + P*16 bytes and writes B*P*12 + B*T*G*8 (T tiles), and
// does ~13 float operations per (valid GT, prior) pair, but each pair
// also costs a share of the 10 warp shuffles per (GT, warp) of the per-GT
// reduction and one IEEE division (a multi-instruction sequence without
// fast math). Grid (ceil(P / 1024), B): 29 x 34 = 986 blocks at 840x840,
// batch 34, several waves over the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 256;

// (v, i) <- (ov, oi) if ov is larger, or equal with a lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
match_front_kernel(const float4* __restrict__ truths,  // [B, G] of (x1, y1, x2, y2)
                   const uint8_t* __restrict__ valid,  // [B, G] 0/1
                   const float4* __restrict__ priors,  // [P] of (cx, cy, w, h)
                   float* __restrict__ bt_ov,          // [B, P]
                   int64_t* __restrict__ bt_ix,        // [B, P]
                   float* __restrict__ tile_max,       // [B, T, G]
                   int32_t* __restrict__ tile_arg,     // [B, T, G] prior index
                   int g, int p) {
  __shared__ float s_x1[kMaxG], s_y1[kMaxG], s_x2[kMaxG], s_y2[kMaxG];
  __shared__ float s_area[kMaxG];
  __shared__ uint8_t s_valid[kMaxG];
  __shared__ float s_wmax[kMaxG][kWarps];
  __shared__ int32_t s_warg[kMaxG][kWarps];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = tile * kTile;

  if (tid == 0) s_last = 0;
  __syncthreads();
  for (int j = tid; j < g; j += kThreads) {
    const float4 t = truths[static_cast<size_t>(b) * g + j];
    s_x1[j] = t.x;
    s_y1[j] = t.y;
    s_x2[j] = t.z;
    s_y2[j] = t.w;
    s_area[j] = (t.z - t.x) * (t.w - t.y);
    const uint8_t v = valid[static_cast<size_t>(b) * g + j];
    s_valid[j] = v;
    if (v) atomicMax(&s_last, j + 1);
  }
  __syncthreads();
  const int last = s_last;

  float px1[kPerThread], py1[kPerThread], px2[kPerThread], py2[kPerThread];
  float parea[kPerThread], best[kPerThread];
  int bidx[kPerThread];
  bool in[kPerThread];
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
    }
    best[k] = -1.0f;
    bidx[k] = 0;
  }

  for (int j = 0; j < last; ++j) {
    if (!s_valid[j]) continue;  // the same byte for every thread: uniform
    const float tx1 = s_x1[j], ty1 = s_y1[j], tx2 = s_x2[j], ty2 = s_y2[j];
    const float area_t = s_area[j];
    float gv = -INFINITY;
    int gi = INT32_MAX;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!in[k]) continue;
      const float iw = fmaxf(fminf(tx2, px2[k]) - fmaxf(tx1, px1[k]), 0.0f);
      const float ih = fmaxf(fminf(ty2, py2[k]) - fmaxf(ty1, py1[k]), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / ((area_t + parea[k]) - inter);
      if (iou > best[k]) {
        best[k] = iou;
        bidx[k] = j;
      }
      if (iou > gv) {  // k ascending is p ascending: the first p stays
        gv = iou;
        gi = base + k * kThreads + tid;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, gv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, gi, off);
      take_better(gv, gi, ov, oi);
    }
    if (lane == 0) {
      s_wmax[j][warp] = gv;
      s_warg[j][warp] = gi;
    }
  }
  __syncthreads();

  const int ntiles = gridDim.x;
  for (int j = tid; j < g; j += kThreads) {
    // A padded row scores -1 on every prior: its first maximum is the
    // tile's first prior.
    float v = -1.0f;
    int i = base;
    if (j < last && s_valid[j]) {
      v = s_wmax[j][0];
      i = s_warg[j][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) take_better(v, i, s_wmax[j][w], s_warg[j][w]);
    }
    const size_t o = (static_cast<size_t>(b) * ntiles + tile) * g + j;
    tile_max[o] = v;
    tile_arg[o] = i;
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (in[k]) {
      const size_t o = static_cast<size_t>(b) * p + base + k * kThreads + tid;
      bt_ov[o] = best[k];
      bt_ix[o] = bidx[k];
    }
  }
}

}  // namespace

extern "C" int jabd_match_max_g() { return kMaxG; }

extern "C" int jabd_match_tile() { return kTile; }

// Returns a cudaError_t (0 on success). tile_max / tile_arg hold
// batch * ceil(p / kTile) * g entries.
extern "C" int jabd_match_front(const void* truths, const void* valid, const void* priors,
                                void* bt_ov, void* bt_ix, void* tile_max, void* tile_arg,
                                int batch, int g, int p, void* stream) {
  if (batch <= 0 || batch > 65535 || g <= 0 || g > kMaxG || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p + kTile - 1) / kTile, batch);
  match_front_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(truths), static_cast<const uint8_t*>(valid),
      static_cast<const float4*>(priors), static_cast<float*>(bt_ov),
      static_cast<int64_t*>(bt_ix), static_cast<float*>(tile_max),
      static_cast<int32_t*>(tile_arg), g, p);
  return static_cast<int>(cudaGetLastError());
}
