// Exact greedy NMS keep mask over score-sorted candidates, one block per image.
//
// Replaces the Pallas TPU kernel `_nms_kernel` of jabd_tpu/ops/nms_pallas.py
// (launched batched by `nms_keep_sorted_pallas_batched`, one grid step per
// image). Same semantics as the plain version `nms_keep_sorted` in
// jabd_tpu_torch/ops/nms.py: keep starts as `valid`; for i in [0, n_valid),
// where n_valid = sum(valid), box i, if still kept, clears keep[j] for every
// j > i whose metric exceeds the threshold. Metric: IoU, or DIoU =
// IoU - (d^2/c^2)^beta1, with the guards union > 0 and c > 0.
//
// Bit-exactness: the metric uses the operation order of the plain version
// (inter = max(xx2-xx1,0) * max(yy2-yy1,0); union = (area_j + area_i) - inter;
// IEEE division). Build with -fmad=false and without --use_fast_math so no
// multiply-add is contracted; pow(u, 1) is taken as u, as the plain version
// does. Inputs are assumed finite (fmaxf/fminf differ from torch.maximum only
// on NaN).
//
// Layout: 1024 threads; thread t owns candidates t, t+1024, ... (at most 5,
// K <= 5120) and keeps their coordinates, areas and keep bits in registers.
// The four coordinate columns also sit in dynamic shared memory (16 bytes per
// candidate, 80 KB at K = 5120, above the 48 KB default so the launcher opts
// in) because every step broadcasts box i to the whole block; reading it from
// shared memory costs one barrier per step, where passing it from its owning
// thread through a slot would cost two. The keep mask is a byte array in
// shared memory: only the owner of j writes keep[j], and only in steps i < j,
// so one barrier at the end of a step that wrote anything orders it before
// the read of keep[i+1] (a step whose box is already suppressed writes
// nothing and skips the barrier).
//
// What bounds it on an H100: neither bytes nor arithmetic. It reads B*K*17
// bytes and writes B*K, and does O(K) metric evaluations per kept box, but
// the steps are serial: n_valid steps, each a shared-memory broadcast plus a
// block-wide barrier, so the time is about (kept boxes) x (barrier latency),
// on B of the 132 SMs. Making it fast (bitmask matrix over warps, several
// blocks per image) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 5;
constexpr int kMaxK = kThreads * kPerThread;

template <bool kDiou>
__device__ __forceinline__ float suppression_metric(
    float x1, float y1, float x2, float y2, float area_j,
    float xi1, float yi1, float xi2, float yi2, float area_i, float beta1) {
  const float xx1 = fmaxf(x1, xi1);
  const float yy1 = fmaxf(y1, yi1);
  const float xx2 = fminf(x2, xi2);
  const float yy2 = fminf(y2, yi2);
  const float inter = fmaxf(xx2 - xx1, 0.0f) * fmaxf(yy2 - yy1, 0.0f);
  const float uni = (area_j + area_i) - inter;
  float metric = inter / (uni > 0.0f ? uni : 1.0f);
  if (kDiou) {
    const float dx = (xi1 + xi2) * 0.5f - (x1 + x2) * 0.5f;
    const float dy = (yi1 + yi2) * 0.5f - (y1 + y2) * 0.5f;
    const float d = dx * dx + dy * dy;
    const float ew = fmaxf(x2, xi2) - fminf(x1, xi1);
    const float eh = fmaxf(y2, yi2) - fminf(y1, yi1);
    const float c = ew * ew + eh * eh;
    const float u = d / (c > 0.0f ? c : 1.0f);
    metric = metric - (beta1 == 1.0f ? u : powf(u, beta1));
  }
  return metric;
}

template <bool kDiou>
__global__ void __launch_bounds__(kThreads, 1)
nms_keep_sorted_kernel(const float4* __restrict__ boxes,  // [B, K] of (x1, y1, x2, y2)
                       const uint8_t* __restrict__ valid,  // [B, K] 0/1
                       uint8_t* __restrict__ keep,         // [B, K] 0/1
                       int k, float thr, float beta1) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sy2 + k);
  __shared__ int s_nvalid;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  if (tid == 0) s_nvalid = 0;
  __syncthreads();

  float x1[kPerThread], y1[kPerThread], x2[kPerThread], y2[kPerThread];
  float area[kPerThread];
  bool kp[kPerThread];
  int count = 0;
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int j = tid + t * kThreads;
    kp[t] = false;
    x1[t] = y1[t] = x2[t] = y2[t] = area[t] = 0.0f;
    if (j < k) {
      const float4 b = boxes[base + j];
      x1[t] = b.x; y1[t] = b.y; x2[t] = b.z; y2[t] = b.w;
      area[t] = (b.z - b.x) * (b.w - b.y);
      kp[t] = valid[base + j] != 0;
      sx1[j] = b.x; sy1[j] = b.y; sx2[j] = b.z; sy2[j] = b.w;
      skeep[j] = kp[t];
      count += kp[t];
    }
  }
  if (count) atomicAdd(&s_nvalid, count);
  __syncthreads();
  const int n_valid = s_nvalid;

  for (int i = 0; i < n_valid; ++i) {
    if (!skeep[i]) continue;  // the same byte for every thread: uniform
    const float xi1 = sx1[i], yi1 = sy1[i], xi2 = sx2[i], yi2 = sy2[i];
    const float area_i = (xi2 - xi1) * (yi2 - yi1);
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int j = tid + t * kThreads;
      if (kp[t] && j > i) {
        const float m = suppression_metric<kDiou>(
            x1[t], y1[t], x2[t], y2[t], area[t], xi1, yi1, xi2, yi2, area_i, beta1);
        if (m > thr) {
          kp[t] = false;
          skeep[j] = 0;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int j = tid + t * kThreads;
    if (j < k) keep[base + j] = kp[t];
  }
}

}  // namespace

extern "C" int jabd_nms_max_k() { return kMaxK; }

// kind: 0 = IoU, 1 = DIoU. Returns a cudaError_t (0 on success).
extern "C" int jabd_nms_keep_sorted(const void* boxes, const void* valid, void* keep,
                                    int batch, int k, float thr, int kind, float beta1,
                                    void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK || (kind != 0 && kind != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(k) * (4 * sizeof(float) + 1);
  auto kernel = kind == 1 ? nms_keep_sorted_kernel<true> : nms_keep_sorted_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr, beta1);
  return static_cast<int>(cudaGetLastError());
}
