// Exact greedy NMS keep mask over score-sorted candidates: a group of
// co-resident blocks per image walks the candidates in chunks and tests each
// chunk only against the rows already kept.
//
// Replaces the Pallas TPU kernel `_nms_kernel` of jabd_tpu/ops/nms_pallas.py
// (launched batched by `nms_keep_sorted_pallas_batched`, one grid step per
// image). Same semantics as the plain version `nms_keep_sorted` in
// jabd_tpu_torch/ops/nms.py: keep starts as `valid`; for i in [0, n_valid),
// where n_valid = sum(valid), box i, if still kept, clears keep[j] for every
// j > i whose metric exceeds the threshold. Metric: IoU, or DIoU =
// IoU - (d^2/c^2)^beta1, with the guards union > 0 and c > 0.
//
// nms_scan_kernel, `width` blocks of 1024 threads per image (block
// b * width + rank), one block an SM, the whole grid co-resident (a
// cooperative launch where width > 1); the wrapper (ops/nms_cuda.py::plan)
// picks width from B, K and the card's SMs (16 at B 8 on 132 SMs, 132 at
// B 1) and the chunk C (512, or the next power of two >= K for small K).
// With width > 1 block 0 resolves and the other `testers` blocks test; with
// width 1 the one block does both in turn. Every block counts n_valid and
// end (the last valid index + 1) itself; the walk covers the chunks below
// end, two chunk buffers in shared memory. The image's kept rows are dealt
// round-robin by rank g (their order among the kept rows) to the testers:
// rank g goes to tester g % testers, into its shared memory (the box, 16
// bytes) at slot g / testers while that is below `cap`, and past that into
// the wrapper's scratch as the candidate's index (`overflow`, int32,
// position g - testers * cap), which L2 holds and the tester stages into
// shared memory 256 boxes at a time. Per chunk n with a valid candidate
// (every block loads the chunk; block 0 writes zeros to keep for a chunk
// without one):
//   1. each tester tests the chunk's valid candidates against every kept row
//      it holds (the survivors of all chunks before n - 1) while block 0
//      resolves chunk n - 1; then waits for block 0 to publish chunk n - 1's
//      survivors, appends the ones of its ranks and tests the chunk against
//      them. The tests are work items of 64 candidates x 32 kept rows that
//      the tester's warps take in turn (a warp whose pairs overlap more
//      takes fewer), two candidates a lane; where thr >= 0 a pair whose
//      boxes do not overlap stops at four max/min and two compares, four
//      pairs without a branch and the metric only where some lane of the
//      warp needs it. The suppressed bits are ORed into the image's exchange
//      words in device memory (atomics in L2);
//   2. each tester builds the chunk's own upper-triangle words for its rows
//      (row r with r % testers == its rank, valid and below n_valid; bit c of
//      word q: 64 q + c > r, that column valid, metric > thr) into the
//      exchange words, and arrives (adds 1 to the image's arrival count);
//   3. block 0 waits for the testers' arrivals, stages the suppressed bits
//      and triangle words into its shared memory and resolves the chunk 64
//      rows at a time in one warp: the survivors of the chunk's earlier
//      64-row blocks remove rows of this one (their words pulled in, one
//      reduction); rows alive (valid, below n_valid, not removed) survive
//      as the fixed point of "survivors = alive minus what the survivors
//      suppress" over the diagonal words (one lane per two rows). It writes
//      keep = valid and not removed for the chunk, and publishes the
//      survivors (release at the device's scope).
// The exchange words are read past L1; the waits are acquire loads at the
// device's scope. No pair mask goes through device memory: keep is written
// once, as bytes. Every (kept i, later valid j) pair is evaluated once, in
// step 1 or (i, j in one chunk) step 2, with no stop before the last
// candidate; rows i >= n_valid never suppress, valid need not be a prefix,
// and a valid j >= n_valid can still be suppressed.
//
// Work counters: with a non-null `work` (two uint64 slots the wrapper
// passes while a profiler records) each block adds its metric evaluations
// (a valid candidate's pairs of step 1, the triangle words' pairs) to
// work[0], and block 0 adds the pairs greedy NMS needs, n_valid - 1 - i a
// kept row i < n_valid, to work[1]: an atomic add a block at the kernel's
// end.
//
// Bit-exactness: the metric uses the operation order of the plain version,
// with the same operand roles (j is the `boxes` side, i the `bi` side:
// inter = max(xx2-xx1,0) * max(yy2-yy1,0); union = (area_j + area_i) - inter;
// DIoU's dx = cx_i - cx_j; IEEE division). Build with -fmad=false and
// without --use_fast_math so no multiply-add is contracted; pow(u, 1) is
// taken as u, as the plain version does. When thr >= 0 a pair with
// inter == 0 is skipped without the division: its metric is exactly +0
// (IoU) or <= 0 (DIoU), never > thr. Inputs are assumed finite
// (fmaxf/fminf differ from torch.maximum only on NaN). The walk applies the
// greedy rule in the plain version's order, so the keep mask is the plain
// version's bit for bit.
//
// Scratch: the exchange words, B * (64 + C * C / 64) uint64, which the
// launcher zeroes on the stream before the kernel; and the overflow list,
// B * max(0, K - testers * cap) int32 (none up to ~160,000 kept rows an
// image at B 8). The wrapper raises where the two would pass 1 GiB, and
// past K 1,589,248 (the domain of the kernels this one replaced).
//
// What bounds it on an H100: instruction issue over the kept x later-valid
// pairs on the testers, (width - 1) x B SMs (120 at B 8); ~70% of a tester's
// time goes to the tests against the rows kept before the last chunk, the
// rest to the tests against the last chunk's survivors, the triangle words
// and the arrival, in series with block 0's resolve only where those tests
// take less than the resolve (small K). On the flagship's all-prior batch
// (B 8, K 67,200, 5.08 G evaluations, 99% of them needed) it takes 6.4 ms,
// ~8 G evaluations a second an SM. It replaces a mask kernel that evaluated
// every pair of the upper triangle (n_valid^2 / 2 an image, ~4x the pairs
// greedy NMS needs there) and wrote them to device memory as 64-bit words,
// and a block-serial scan per image that streamed them back on B SMs (27
// ms). Tried and not kept: one thread-block cluster per image, the
// exchange in distributed shared memory (an H100 holds only 7 clusters of
// 10 to 16 blocks, 9 of 9, so B 8 ran on 72 SMs: 10.8 ms); two barriers a
// chunk in place of the testers' look-ahead (7.4 ms); one candidate a lane
// and a fixed share of the slice a warp (7.5 ms, warps waiting for the
// slowest); an overlap test per pair with its own branch (slower where most
// warps have some overlapping lane); the triangle words with the overlap
// test (no gain: the arrival's fence and barrier dominate there).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;         // rows per resolve block = bits per triangle word
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 512;
constexpr int kStage = 256;       // overflow entries staged in shared memory at once
// Exchange words of an image, each group on its own 128 bytes: the
// arrivals (word 0), the resolved steps (word 16), the suppressed bits
// (words 32..39), the survivors (48..55), then the triangle words
// [C][C / 64] from word 64.
constexpr int kArrived = 0, kResolved = 16, kSup = 32, kKept = 48, kTri = 64;
// Dynamic shared memory a block may take: the 227 KB a block can have on
// sm_90, less 1 KB for its static variables. ops/nms_cuda.py sizes the
// slice (`cap`) within it.
constexpr int kSmem = 227 * 1024 - 1024;
constexpr int kMaxK = 1589248;    // the wrapper's MAX_K
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;   // devices with cached launch settings

template <bool kDiou>
__device__ __forceinline__ bool suppresses(
    float x1, float y1, float x2, float y2, float area_j,
    float xi1, float yi1, float xi2, float yi2, float area_i,
    float thr, float beta1, bool skip_disjoint) {
  const float xx1 = fmaxf(x1, xi1);
  const float yy1 = fmaxf(y1, yi1);
  const float xx2 = fminf(x2, xi2);
  const float yy2 = fminf(y2, yi2);
  const float inter = fmaxf(xx2 - xx1, 0.0f) * fmaxf(yy2 - yy1, 0.0f);
  if (skip_disjoint && inter == 0.0f) return false;
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
  return metric > thr;
}

__device__ __forceinline__ float box_area(float4 a) { return (a.z - a.x) * (a.w - a.y); }

// Whether boxes a and b overlap: xx2 > xx1 and yy2 > yy1, so that inter is
// not 0 unless the product underflows.
__device__ __forceinline__ bool overlaps(float4 a, float4 b) {
  return (fminf(a.z, b.z) > fmaxf(a.x, b.x)) & (fminf(a.w, b.w) > fmaxf(a.y, b.y));
}

constexpr int kPer = 2;     // candidates a lane tests: c and c + 32 of its warp's group
constexpr int kGroup = 32 * kPer;  // candidates a work item covers
constexpr int kRange = 32;  // kept rows a work item covers

// Whether any kept row kb[from, to) suppresses each of the thread's
// candidates a[p] (area area_j[p]), ORed into sup[p]: every
// entry evaluated, no early exit. Called by whole warps (the bounds the
// same in every lane). Where thr >= 0 a pair whose boxes do not overlap
// (inter exactly 0) stops at `overlaps`: a few entries are tested without
// a branch, and `suppresses` (the same operations in the same order as the
// plain version; the entry's area recomputed as it was stored) runs only
// for the pairs some lane of the warp needs.
template <bool kDiou>
__device__ __forceinline__ void any_suppresses(const float4 (&a)[kPer], const float (&area_j)[kPer],
                                               const float4* kb, int from, int to, float thr, float beta1,
                                               bool skip_disjoint, bool (&sup)[kPer]) {
  constexpr int kUnroll = 4 / kPer;
  int e = from;
  if (skip_disjoint) {
    for (; e + kUnroll <= to; e += kUnroll) {
      float4 b[kUnroll];
      bool o[kUnroll][kPer];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        b[u] = kb[e + u];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          o[u][p] = overlaps(a[p], b[u]);
          any |= o[u][p];
        }
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float area_i = box_area(b[u]);
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            if (o[u][p]) {
              sup[p] |= suppresses<kDiou>(a[p].x, a[p].y, a[p].z, a[p].w, area_j[p], b[u].x, b[u].y, b[u].z,
                                          b[u].w, area_i, thr, beta1, true);
            }
          }
        }
      }
    }
  }
  for (; e < to; ++e) {
    const float4 bu = kb[e];
    const float area_i = box_area(bu);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (!skip_disjoint || overlaps(a[p], bu)) {
        sup[p] |= suppresses<kDiou>(a[p].x, a[p].y, a[p].z, a[p].w, area_j[p], bu.x, bu.y, bu.z, bu.w, area_i,
                                    thr, beta1, skip_disjoint);
      }
    }
  }
}

// Tests the chunk's valid candidates against kept rows kb[0, count): work
// items (a group of kGroup candidates, a range of kRange kept rows) taken in
// turn by the block's warps from *next (zero on entry); the suppressed
// candidates are ORed into hit. Returns this thread's metric evaluations (a
// valid candidate's pairs). Every thread of the block calls it.
template <bool kDiou>
__device__ __forceinline__ u64 test_items(const float4* kb, int count, int chunk, const float4* cbox,
                                          const float* carea, const unsigned* cvalid, unsigned* hit, int* next,
                                          float thr, float beta1, bool skip_disjoint) {
  const int lane = threadIdx.x & 31;
  const int n_groups = chunk / kGroup;
  const int n_items = n_groups * ((count + kRange - 1) / kRange);
  u64 pairs = 0;
  while (true) {
    int item = 0;
    if (lane == 0) item = atomicAdd(next, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_items) break;
    const int c0 = (item % n_groups) * kGroup;
    const int e0 = (item / n_groups) * kRange;
    const int e1 = min(count, e0 + kRange);
    float4 a[kPer];
    float area_j[kPer];
    bool cand[kPer], sup[kPer];
    int n_cand = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = c0 + p * 32 + lane;
      a[p] = cbox[c];
      area_j[p] = carea[c];
      cand[p] = (cvalid[c >> 5] >> lane) & 1u;
      sup[p] = false;
      n_cand += cand[p];
    }
    if (!__any_sync(kFull, n_cand)) continue;  // no valid candidate: nothing to evaluate
    any_suppresses<kDiou>(a, area_j, kb, e0, e1, thr, beta1, skip_disjoint, sup);
    pairs += static_cast<u64>(n_cand) * (e1 - e0);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const unsigned bits = __ballot_sync(kFull, cand[p] && sup[p]);
      if (lane == 0 && bits) atomicOr(&hit[(c0 >> 5) + p], bits);
    }
  }
  return pairs;
}

// The highest byte index of x (little-endian) holding a set bit, or -1.
__device__ __forceinline__ int last_set_byte(unsigned x) { return x ? (31 - __clz(x)) / 8 : -1; }

// Reads an exchange word, which other blocks write, from L2 (past this
// SM's L1).
template <typename T>
__device__ __forceinline__ T load_l2(const T* p) {
  return __ldcg(p);
}

// Waits until *word reaches `target` (acquire at the device's scope), by
// one thread; traps (a launch failure the wrapper reports) rather than
// spin for ever.
__device__ __forceinline__ void wait_for(const unsigned* word, unsigned target) {
  for (int spins = 0;; ++spins) {
    unsigned seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(word) : "memory");
    if (seen >= target) return;
    if (spins == (1 << 24)) __trap();
  }
}

// What this block wrote (every thread) is released to the device, and
// *word is raised by one (arrive) or set to `value` (publish), by one thread.
__device__ __forceinline__ void arrive(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(word, 1u);
  }
}

__device__ __forceinline__ void publish(unsigned* word, unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(word), "r"(value) : "memory");
  }
}

// n_valid = sum(v[0:k]) and end = 1 + the last valid index (0 without one),
// by the whole block; 16-byte loads in the aligned middle, bytes at the ends.
__device__ void count_valid(const uint8_t* __restrict__ v, int k, int* s_part, int* s_last,
                            int* n_valid, int* end) {
  const int tid = threadIdx.x;
  const int head = min(k, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(v) & 15)) & 15));
  const int nvec = (k - head) / 16;
  const int tail = head + 16 * nvec;
  const uint4* vec = reinterpret_cast<const uint4*>(v + head);
  int n = 0, last = -1;
  for (int q = tid; q < nvec; q += kThreads) {
    const uint4 x = vec[q];  // 16 bytes of 0/1: one set bit per valid box
    n += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    const int at = head + 16 * q;
    if (x.w) last = at + 12 + last_set_byte(x.w);
    else if (x.z) last = at + 8 + last_set_byte(x.z);
    else if (x.y) last = at + 4 + last_set_byte(x.y);
    else if (x.x) last = at + last_set_byte(x.x);
  }
  if (tid < head && v[tid]) {
    ++n;
    last = max(last, tid);
  }
  if (tail + tid < k && v[tail + tid]) {
    ++n;
    last = max(last, tail + tid);
  }
  n = __reduce_add_sync(kFull, n);
  last = __reduce_max_sync(kFull, last);
  if ((tid & 31) == 0) {
    s_part[tid >> 5] = n;
    s_last[tid >> 5] = last;
  }
  __syncthreads();
  int total = 0, high = -1;
  for (int w = 0; w < kWarps; ++w) {
    total += s_part[w];
    high = max(high, s_last[w]);
  }
  *n_valid = total;
  *end = high + 1;
}

template <bool kDiou>
__global__ void __launch_bounds__(kThreads, 1)
nms_scan_kernel(const float4* __restrict__ boxes,  // [B, K] of (x1, y1, x2, y2)
                const uint8_t* __restrict__ valid,  // [B, K] 0/1
                uint8_t* __restrict__ keep,         // [B, K] 0/1
                int* __restrict__ overflow,         // [B, ov_cap] kept indices past the slices
                u64* __restrict__ xchg,             // [B, 64 + chunk * chunk / 64] exchange words, zeroed
                u64* work,                          // null, or [2] work counters
                int k, int width, int chunk, int cap, int ov_cap, float thr, float beta1) {
  // The chunk's triangle words [chunk][chunk / 64] (block 0 stages them);
  // boxes of the slice [cap] and of the overflow stage [kStage]; the two
  // chunk buffers' boxes [2][chunk] and areas [2][chunk].
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ unsigned s_cvalid[2][kMaxChunk / 32];  // the chunk buffers' valid bits
  __shared__ unsigned s_sup[kMaxChunk / 32];    // block 0: the suppressed bits, staged
  __shared__ unsigned s_hit[kMaxChunk / 32];    // candidates this block's kept rows suppress
  __shared__ int s_next;                        // the next work item of the tests
  __shared__ u64 s_rem[kMaxChunk / kWord];      // block 0: the chunk's removed bits
  __shared__ u64 s_mine[kMaxChunk / kWord];     // the survivors of the chunk resolved last
  __shared__ int s_part[kWarps], s_last[kWarps];
  __shared__ u64 s_work[kWarps];

  const int b = blockIdx.x / width;
  const int rank = blockIdx.x % width;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = chunk / kWord;  // triangle words a row
  // Block 0 resolves; the others test (with width 1 the one block does both).
  const bool resolver = rank == 0;
  const bool tester = width == 1 || rank > 0;
  const int testers = width == 1 ? 1 : width - 1;
  const int trank = width == 1 ? 0 : rank - 1;

  u64* s_tri = reinterpret_cast<u64*>(s_dyn);
  float4* s_kbox = reinterpret_cast<float4*>(s_tri + chunk * nw);
  float4* s_sbox = s_kbox + cap;
  float4* s_cbox = s_sbox + kStage;
  float* s_carea = reinterpret_cast<float*>(s_cbox + 2 * chunk);

  const float4* bb = boxes + static_cast<size_t>(b) * k;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  uint8_t* out = keep + static_cast<size_t>(b) * k;
  int* ov = overflow + static_cast<size_t>(b) * ov_cap;
  u64* ex = xchg + static_cast<size_t>(b) * (kTri + chunk * nw);
  unsigned* arrived = reinterpret_cast<unsigned*>(ex + kArrived);    // testers done with a step, all steps
  unsigned* resolved = reinterpret_cast<unsigned*>(ex + kResolved);  // steps block 0 has resolved
  unsigned* sup = reinterpret_cast<unsigned*>(ex + kSup);  // candidates the kept list suppresses
  u64* kept_x = ex + kKept;                                // the survivors of the step resolved last
  u64* tri = ex + kTri;                                    // [chunk][nw]

  int n_valid, end;
  count_valid(v, k, s_part, s_last, &n_valid, &end);
  const bool skip_disjoint = thr >= 0.0f;
  const int walk_end = end == 0 ? 0 : min(k, (end + chunk - 1) / chunk * chunk);
  unsigned steps = 0;  // chunks with a valid candidate so far: the same in every block of the image
  int total = 0;       // kept rows appended so far: the same in every tester
  int prev = -1;       // the previous step's chunk, in the other buffer
  int buf = 0;         // this step's chunk buffer
  u64 pairs = 0;       // this thread's metric evaluations
  u64 useful = 0;      // block 0, warp 0: the pairs greedy NMS needs

  // The work items of kb[0, count) against the chunk in buffer `buf`.
  auto run_items = [&](const float4* kb, int count) {
    if (count <= 0) return;  // the same in the whole block
    __syncthreads();         // the queue's last users are done
    if (tid == 0) s_next = 0;
    __syncthreads();
    pairs += test_items<kDiou>(kb, count, chunk, s_cbox + buf * chunk, s_carea + buf * chunk, s_cvalid[buf],
                               s_hit, &s_next, thr, beta1, skip_disjoint);
  };
  // This tester's kept rows of ranks [lo, hi): rank g lies in tester
  // g % testers, in its shared memory at slot g / testers while that is
  // below cap, else at overflow position g - testers * cap.
  auto test_ranks = [&](int lo, int hi) {
    const int n_lo = lo > trank ? (lo - trank + testers - 1) / testers : 0;
    const int n_hi = hi > trank ? (hi - trank + testers - 1) / testers : 0;
    run_items(s_kbox + min(n_lo, cap), min(n_hi, cap) - min(n_lo, cap));
    for (int n0 = max(n_lo, cap); n0 < n_hi; n0 += kStage) {  // the overflow, staged
      const int n = min(kStage, n_hi - n0);
      __syncthreads();  // the stage's readers are done
      if (tid < n) s_sbox[tid] = bb[ov[trank + static_cast<size_t>(n0 - cap + tid) * testers]];
      run_items(s_sbox, n);
    }
  };

  for (int s = 0; s < walk_end; s += chunk) {
    const int len = min(chunk, k - s);
    __syncthreads();  // the readers of buffer `buf` (two steps back) and of s_hit are done
    if (tid < kMaxChunk / 32) s_hit[tid] = 0u;
    if (tid < chunk) {
      const bool in = tid < len;
      const float4 a = in ? bb[s + tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s_cbox[buf * chunk + tid] = a;
      s_carea[buf * chunk + tid] = box_area(a);
      const unsigned bits = __ballot_sync(kFull, in && v[s + tid]);
      if (lane == 0) s_cvalid[buf][tid >> 5] = bits;
    }
    __syncthreads();
    const unsigned* cv = s_cvalid[buf];
    bool any = false;
    for (int q = 0; q < chunk / 32; ++q) any |= cv[q] != 0u;
    if (!any) {  // the same in every block: nothing to test, resolve or keep
      if (resolver && tid < len) out[s + tid] = 0;
      continue;
    }
    ++steps;

    if (tester) {
      // 1. The chunk's valid candidates against every kept row appended so
      // far (the survivors of all chunks but the last), while block 0
      // resolves the last one; then against the last one's survivors, once
      // block 0 publishes them, after appending them.
      test_ranks(0, total);
      if (prev >= 0) {
        if (width > 1) {
          if (tid == 0) wait_for(resolved, steps - 1);
          __syncthreads();
          if (tid < nw) s_mine[tid] = load_l2(&kept_x[tid]);
        }
        __syncthreads();
        const float4* pbox = s_cbox + (buf ^ 1) * chunk;
        if (tid < chunk && ((s_mine[tid / kWord] >> (tid % kWord)) & 1ull)) {
          int before = total;
          for (int q = 0; q < tid / kWord; ++q) before += __popcll(s_mine[q]);
          const int gr = before + __popcll(s_mine[tid / kWord] & ((1ull << (tid % kWord)) - 1ull));
          if (gr % testers == trank) {
            if (gr / testers < cap) {
              s_kbox[gr / testers] = pbox[tid];
            } else {
              ov[gr - testers * cap] = prev + tid;
            }
          }
        }
        int after = total;
        for (int q = 0; q < nw; ++q) after += __popcll(s_mine[q]);
        test_ranks(total, after);  // its own syncs make the appended rows visible
        total = after;
      }
      __syncthreads();
      if (tid < chunk / 32 && s_hit[tid]) atomicOr(&sup[tid], s_hit[tid]);

      // 2. The triangle words of this tester's rows, one warp per (row, word).
      const float4* cb = s_cbox + buf * chunk;
      const float* ca = s_carea + buf * chunk;
      const int rows = len > trank ? (len - trank + testers - 1) / testers : 0;
      for (int item = warp; item < rows * nw; item += kWarps) {
        const int r = trank + (item / nw) * testers;
        const int q = item % nw;
        if (q < r / kWord || s + r >= n_valid || !((cv[r >> 5] >> (r & 31)) & 1u)) continue;
        const float4 bi = cb[r];
        const float area_i = ca[r];
        unsigned half[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = q * kWord + h * 32 + lane;
          const bool live = col > r && ((cv[col >> 5] >> (col & 31)) & 1u);
          bool bit = false;
          if (live) {
            const float4 z = cb[col];
            bit = suppresses<kDiou>(z.x, z.y, z.z, z.w, ca[col], bi.x, bi.y, bi.z, bi.w, area_i, thr, beta1,
                                    skip_disjoint);
            ++pairs;
          }
          half[h] = __ballot_sync(kFull, bit);
        }
        if (lane == 0) __stcg(&tri[r * nw + q], (static_cast<u64>(half[1]) << 32) | half[0]);
      }
      if (width > 1) arrive(arrived);
    }

    if (resolver) {
      // 3. Block 0 gathers the chunk's suppressed bits and triangle words
      // once every tester has arrived, and resolves it.
      if (width > 1 && tid == 0) wait_for(arrived, steps * static_cast<unsigned>(testers));
      __syncthreads();
      for (int w = tid; w < chunk * nw; w += kThreads) s_tri[w] = load_l2(&tri[w]);
      if (tid < chunk / 32) {
        s_sup[tid] = load_l2(&sup[tid]);
        __stcg(&sup[tid], 0u);  // for the next step: the testers OR into it once this one is published
      }
      __syncthreads();
      if (warp == 0) {
        // Removed so far: invalid, past K, or suppressed by the kept list.
        if (lane < nw) {
          const u64 vbits = (static_cast<u64>(cv[2 * lane + 1]) << 32) | cv[2 * lane];
          s_rem[lane] = ~vbits | (static_cast<u64>(s_sup[2 * lane + 1]) << 32) | s_sup[2 * lane];
        }
        __syncwarp();
        for (int q = 0; q < nw; ++q) {
          // The survivors of the earlier 64-row blocks remove rows of this
          // one (a valid row >= n_valid too); then rows i < n_valid that
          // nothing removed are alive.
          const int live = min(kWord, max(0, n_valid - (s + q * kWord)));
          const u64 live_mask = live == kWord ? ~0ull : (1ull << live) - 1ull;
          u64 removed = s_rem[q], kept = 0ull, suppressed = 0ull;
          if (~removed) {  // some row not removed yet: the same in every lane
            u64 y = 0ull;
            for (int q1 = 0; q1 < q; ++q1) {
              const u64 k1 = s_mine[q1];
              if ((k1 >> lane) & 1ull) y |= s_tri[(q1 * kWord + lane) * nw + q];
              if ((k1 >> (lane + 32)) & 1ull) y |= s_tri[(q1 * kWord + lane + 32) * nw + q];
            }
            removed |= (static_cast<u64>(__reduce_or_sync(kFull, static_cast<unsigned>(y >> 32))) << 32) |
                       __reduce_or_sync(kFull, static_cast<unsigned>(y));
            const u64 alive = ~removed & live_mask;
            const int r0 = q * kWord + lane, r1 = r0 + 32;
            const u64 d0 = (alive >> lane) & 1ull ? s_tri[r0 * nw + q] : 0ull;
            const u64 d1 = (alive >> (lane + 32)) & 1ull ? s_tri[r1 * nw + q] : 0ull;
            // The survivors are the unique K with K = A \ OR_{s in K} d[s]
            // (d[s] has bits only above s, so K is fixed position by
            // position); iterating from K = A fixes at least one more
            // position a round and stops at K itself.
            kept = alive;
            while (true) {
              const u64 z = ((kept >> lane) & 1ull ? d0 : 0ull) | ((kept >> (lane + 32)) & 1ull ? d1 : 0ull);
              const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(z));
              const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(z >> 32));
              suppressed = (static_cast<u64>(hi) << 32) | lo;
              const u64 next = alive & ~suppressed;
              if (next == kept) break;  // the same in every lane
              kept = next;
            }
            if ((kept >> lane) & 1ull) useful += n_valid - 1 - (s + r0);
            if ((kept >> (lane + 32)) & 1ull) useful += n_valid - 1 - (s + r1);
          }
          if (lane == 0) {
            s_rem[q] = removed | suppressed;
            s_mine[q] = kept;
            __stcg(&kept_x[q], kept);
          }
          __syncwarp();
        }
      }
      __syncthreads();
      if (tid < len) out[s + tid] = !((s_rem[tid / kWord] >> (tid % kWord)) & 1ull);
      if (width > 1) publish(resolved, steps);
    }
    prev = s;
    buf ^= 1;
  }

  // Past the last chunk with a valid candidate nothing is kept.
  for (int j = walk_end + rank * kThreads + tid; j < k; j += width * kThreads) out[j] = 0;
  if (work != nullptr) {
    u64 n = pairs;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
    if (lane == 0) s_work[warp] = n;
    __syncthreads();
    if (tid == 0) {
      u64 sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_work[w];
      if (sum) atomicAdd(work, sum);
    }
    if (rank == 0 && warp == 0) {
      for (int o = 16; o > 0; o >>= 1) useful += __shfl_down_sync(kFull, useful, o);
      if (lane == 0 && useful) atomicAdd(work + 1, useful);
    }
  }
}

long long smem_bytes(int chunk, int cap) {
  return static_cast<long long>(chunk) * (chunk / kWord) * 8 + 16LL * (cap + kStage) + 40LL * chunk;
}

// Opts both instances into kSmem of dynamic shared memory, once per device
// (the current one); past kMaxDevices every call does.
cudaError_t prepare() {
  static bool ready[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && ready[device]) return cudaSuccess;
  for (auto kernel : {nms_scan_kernel<false>, nms_scan_kernel<true>}) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  if (cached) ready[device] = true;
  return cudaSuccess;
}

}  // namespace

// The keep masks of `batch` images of k candidates, on `stream`. kind:
// 0 = IoU, 1 = DIoU. width: blocks per image, batch * width of them no
// more than the card holds at once (one an SM) where width > 1; chunk:
// candidates a step (64, 128, 256 or 512); cap: kept rows a block holds in
// shared memory; `xchg`: batch * (64 + chunk * chunk / 64) uint64, which
// this call zeroes on the stream before the launch;
// `overflow` (null when ov_cap is 0): batch * ov_cap int32, ov_cap >=
// k - testers * cap where that is positive (testers = max(1, width - 1)).
// `work`: null, or two uint64
// counters the kernel adds its work to (see the header). Returns a
// cudaError_t (0 on success).
extern "C" int jabd_nms_keep(const void* boxes, const void* valid, void* keep, void* overflow, void* xchg,
                             int batch, int k, int width, int chunk, int cap, int ov_cap, float thr, int kind,
                             float beta1, void* stream, void* work) {
  const long long smem = smem_bytes(chunk, cap);
  if (batch <= 0 || k <= 0 || k > kMaxK || (kind != 0 && kind != 1) || width <= 0 ||
      (chunk != 64 && chunk != 128 && chunk != 256 && chunk != kMaxChunk) || cap <= 0 || smem > kSmem || ov_cap < 0 ||
      static_cast<long long>(ov_cap) < static_cast<long long>(k) - static_cast<long long>(max(1, width - 1)) * cap ||
      (ov_cap > 0 && overflow == nullptr) || xchg == nullptr ||
      static_cast<long long>(batch) * width > INT_MAX || reinterpret_cast<uintptr_t>(boxes) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare();
  if (err == cudaSuccess) {
    const size_t words = static_cast<size_t>(batch) * (kTri + static_cast<size_t>(chunk) * (chunk / kWord));
    err = cudaMemsetAsync(xchg, 0, words * sizeof(u64), static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * width));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;  // the image's blocks wait for each other: all must be resident
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = width > 1 ? 1 : 0;
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  int* ov = static_cast<int*>(overflow);
  u64* x = static_cast<u64*>(xchg);
  u64* w = static_cast<u64*>(work);
  err = kind == 1
      ? cudaLaunchKernelEx(&cfg, nms_scan_kernel<true>, b, v, kp, ov, x, w, k, width, chunk, cap, ov_cap, thr, beta1)
      : cudaLaunchKernelEx(&cfg, nms_scan_kernel<false>, b, v, kp, ov, x, w, k, width, chunk, cap, ov_cap, thr,
                           beta1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
