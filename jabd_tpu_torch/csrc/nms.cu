// Exact greedy NMS keep mask over score-sorted candidates: a suppression
// bitmask built in parallel, then a block-serial scan per image.
//
// Replaces the Pallas TPU kernel `_nms_kernel` of jabd_tpu/ops/nms_pallas.py
// (launched batched by `nms_keep_sorted_pallas_batched`, one grid step per
// image). Same semantics as the plain version `nms_keep_sorted` in
// jabd_tpu_torch/ops/nms.py: keep starts as `valid`; for i in [0, n_valid),
// where n_valid = sum(valid), box i, if still kept, clears keep[j] for every
// j > i whose metric exceeds the threshold. Metric: IoU, or DIoU =
// IoU - (d^2/c^2)^beta1, with the guards union > 0 and c > 0.
//
// Bands. The mask's row blocks (64 rows each, nb = ceil(K / 64) of them)
// are cut into bands [r0, r1) that jabd_nms_band runs in turn on one
// stream, each band two kernels back to back; the wrapper plans the bands
// from B and K alone (ops/nms_cuda.py::plan), so that each band's mask fits
// a fixed scratch budget and nothing waits on the card for n_valid. Up to
// K 12,288 at B 32 (and far beyond at smaller B) there is one band.
//
// 1. nms_mask_kernel: word (i, cb) has bit c set when j = 64 cb + c > i and
//    metric(i, j) > thr. Tiles of 64 x 64 pairs, upper triangle only
//    (column block cb >= row block rb), stored row-block-major per band:
//    image b's word (64 rb + t, cb) of band [r0, r1) lies at
//    mask[((b * (r1 - r0) + rb - r0) * (nb - r0) + cb - r0) * 64 + t]. So a
//    tile is 512 contiguous bytes, and any run of a row block's columns is
//    one contiguous span for the scan. The grid is as many 64-thread blocks
//    as the card holds at once, split over the images; in the first band
//    each block counts its image's n_valid (one block stores it for the
//    later bands), and every block walks the band's tiles of row blocks
//    below ceil(n_valid / 64), so the cost follows n_valid^2, not K^2. In a
//    tile the block stages the 64 column boxes in shared memory and thread
//    t builds row 64 rb + t's word. Rows i >= n_valid are never computed
//    (the plain version never lets them suppress) and invalid rows write 0;
//    a column block with no valid box writes zeros without evaluating a
//    metric. Columns are not cut at n_valid: valid need not be a prefix, and
//    a valid j >= n_valid can still be suppressed.
// 2. nms_scan_kernel, one block of 256 threads per image. `removed` is a
//    bitset over K, starting as ~valid with the bits past K set, in dynamic
//    shared memory beside the copy buffers (nb words: 34 KB at K 272,000;
//    the plan refuses K past 1,589,248, where it would leave no room for
//    32-word chunks); the first band builds it, the later ones take it over
//    from the one before through device memory. For each row block r of the
//    band below ceil(n_valid / 64): its words r .. nb-1 arrive in column
//    chunks of up to 192 words (96 KB) by TMA bulk copies, double-buffered
//    on two mbarriers so that the next chunk lands while this one is used.
//    On r's first chunk one warp resolves the 64 boxes with the diagonal
//    words (box i < n_valid survives if its bit is clear and no earlier
//    survivor of the block suppresses it), as the fixed point of
//    "survivors = candidates minus what the survivors suppress", one lane
//    per two rows; on every chunk one warp per later word ORs the surviving
//    rows' words into `removed`; one or two barriers a chunk. The band that
//    reaches ceil(n_valid / 64) writes keep = ~removed as bytes; a band
//    wholly past it exits at once. With nb <= 192 a row block is one chunk.
//
// Work counters: with a non-null `work` (two uint64 slots the wrapper
// passes while a profiler records) the mask kernel adds its metric
// evaluations, 64 a word it builds, to work[0], and the band that writes
// keep adds the pairs greedy NMS needs, n_valid - 1 - i a kept row
// i < n_valid, to work[1]: an atomic add a warp at each kernel's end.
//
// Bit-exactness: the metric uses the operation order of the plain version,
// with the same operand roles (j is the `boxes` side, i the `bi` side:
// inter = max(xx2-xx1,0) * max(yy2-yy1,0); union = (area_j + area_i) - inter;
// DIoU's dx = cx_i - cx_j; IEEE division). Build with -fmad=false and
// without --use_fast_math so no multiply-add is contracted; pow(u, 1) is
// taken as u, as the plain version does. When thr >= 0 a pair with
// inter == 0 is skipped without the division: its metric is exactly +0
// (IoU) or <= 0 (DIoU), never > thr. Inputs are assumed finite
// (fmaxf/fminf differ from torch.maximum only on NaN). The scan applies the
// same greedy rule in the same order, band after band, so the keep mask is
// the plain version's bit for bit.
//
// Scratch, allocated by the wrapper in one piece: the largest band's mask,
// B * (r1 - r0) * (nb - r0) * 64 words of 8 bytes (the whole upper square,
// B * nb * nb * 64 words, when there is one band: 25.6 MB at B 8, K 5000),
// plus `removed` (B * nb words) and n_valid (B ints). The plan keeps the
// sum within SCRATCH_BYTES = 1 GiB whatever K; it raises where one row
// block of the batch, B * nb * 512 bytes, does not fit beside the bits
// (B * K above ~132 M), and past K 1,589,248, where `removed` no longer
// fits the scan's shared memory. Words the scan never uses (rows >= n_valid, the lower triangle) are
// left unwritten; the scan masks them.
//
// What bounds it on an H100 (B 8, K 5000 on the serving path's candidates,
// chip_smoke.py's [phase3] split): the mask kernel is instruction issue over
// ~100 M metric pairs, most warps taking the division path because some
// lane's pair intersects; the banded path does the same per pair, ~n_valid^2
// / 2 pairs of valid rows an image (2.3 G at n_valid 67,200). The scan is
// latency, on B of the 132 SMs: per row block its bulk copies of up to
// (nb - r) * 512 bytes, a few rounds of two warp reductions, a barrier a
// chunk; with many columns it becomes the OR of (nb - r) words a row block,
// eight warps wide. A chain of boxes each suppressing only the next can
// take 64 rounds in a block, slower than a 64-step serial pass. Tried and
// not kept: 16-byte cp.async loads in place of the bulk copy (slower); a
// serial 64-step chain in one thread (slower once the loads were bulk
// copies); overlapping the OR with the chain by warp specialisation (no real
// gain).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;  // boxes per mask word = rows per row block
constexpr int kMaskThreads = kWord;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
// Dynamic shared memory the scan may take: the 227 KB a block can have on
// sm_90, less 1 KB for its static variables. The wrapper sizes the copy
// chunks (and places `removed`) within it.
constexpr int kScanSmem = 227 * 1024 - 1024;
// K such that no index 64 nb + c overflows an int.
constexpr int kMaxK = INT_MAX - kWord;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;  // devices with cached launch settings

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

// sum(v[0:k]) over 0/1 bytes, by the whole block (blockDim.x a multiple of
// 32, at least 16); 16-byte loads in the aligned middle, bytes at the ends.
__device__ int block_count_valid(const uint8_t* __restrict__ v, int k, int* s_part) {
  const int tid = threadIdx.x;
  const int head = min(k, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(v) & 15)) & 15));
  const int nvec = (k - head) / 16;
  const int tail = head + 16 * nvec;
  const uint4* vec = reinterpret_cast<const uint4*>(v + head);
  int n = 0;
  for (int q = tid; q < nvec; q += blockDim.x) {
    const uint4 x = vec[q];  // 16 bytes of 0/1: one set bit per valid box
    n += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
  if (tid < head) n += v[tid];
  if (tail + tid < k) n += v[tail + tid];
  n = __reduce_add_sync(kFull, n);
  if ((tid & 31) == 0) s_part[tid >> 5] = n;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_part[w];
  return total;
}

// Tiles (row block, column block >= it) of row blocks [r0, end), nb column
// blocks.
__host__ __device__ __forceinline__ long long band_tiles(int r0, int end, int nb) {
  return end > r0 ? static_cast<long long>(end - r0) * (2LL * nb - r0 - end + 1) / 2 : 0;
}

// Block x of image b walks the band's tiles (row block rb in [r0, min(r1,
// ceil(n_valid / 64))), column block cb >= rb, row-major) from tile x in
// steps of the per-image grid.
template <bool kDiou>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,  // [B, K] of (x1, y1, x2, y2)
                const uint8_t* __restrict__ valid,  // [B, K] 0/1
                u64* __restrict__ mask,              // band [B, r1 - r0, nb - r0, 64]
                int* __restrict__ counts,            // [B] n_valid, set by the first band
                u64* work,                           // null, or [2] work counters
                int k, int nb, int r0, int r1, int per_image, float thr, float beta1) {
  __shared__ float4 s_box[kWord];
  __shared__ float s_area[kWord];
  __shared__ int s_part[kMaskThreads / 32];

  const int b = blockIdx.x / per_image;
  const int x = blockIdx.x % per_image;
  const int t = threadIdx.x;
  const int width = nb - r0;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  const float4* bb = boxes + static_cast<size_t>(b) * k;
  u64* m = mask + static_cast<size_t>(b) * (r1 - r0) * width * kWord;
  int n_valid;
  if (r0 == 0) {
    n_valid = block_count_valid(v, k, s_part);
    if (x == 0 && t == 0) counts[b] = n_valid;
  } else {
    n_valid = counts[b];
  }
  const int end = min(r1, (n_valid + kWord - 1) / kWord);
  const int tiles = static_cast<int>(band_tiles(r0, end, nb));  // the launcher bounds it
  const bool skip_disjoint = thr >= 0.0f;
  unsigned words = 0;  // suppression words this thread built

  int rb = r0, row_start = 0;  // the first tile of row block rb
  for (int q = x; q < tiles; q += per_image) {
    while (q >= row_start + nb - rb) {
      row_start += nb - rb;
      ++rb;
    }
    const int cb = rb + q - row_start;
    const int i = rb * kWord + t;
    const int j = cb * kWord + t;
    u64* out = m + (static_cast<size_t>(rb - r0) * width + (cb - r0)) * kWord + t;
    // The barrier also keeps the previous tile's readers of s_box.
    if (!__syncthreads_or(j < k && v[j])) {  // no valid column: nothing to suppress
      if (i < n_valid) *out = 0ull;
      continue;
    }
    // Columns past K stage as zero boxes; their bits are cut below.
    const float4 col = j < k ? bb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_box[t] = col;
    s_area[t] = (col.z - col.x) * (col.w - col.y);
    __syncthreads();
    if (i >= n_valid) continue;
    u64 word = 0ull;
    if (v[i]) {  // an invalid row is removed from the start and suppresses nothing
      ++words;
      const float4 bi = bb[i];
      const float area_i = (bi.z - bi.x) * (bi.w - bi.y);
      // Every column, c and c + 32 side by side into 32-bit halves.
      unsigned lo = 0u, hi = 0u, bit = 1u;
#pragma unroll 8
      for (int c = 0; c < kWord / 2; ++c, bit <<= 1) {
        const float4 a = s_box[c];
        if (suppresses<kDiou>(a.x, a.y, a.z, a.w, s_area[c], bi.x, bi.y, bi.z, bi.w,
                              area_i, thr, beta1, skip_disjoint)) {
          lo |= bit;
        }
        const float4 z = s_box[c + kWord / 2];
        if (suppresses<kDiou>(z.x, z.y, z.z, z.w, s_area[c + kWord / 2], bi.x, bi.y, bi.z,
                              bi.w, area_i, thr, beta1, skip_disjoint)) {
          hi |= bit;
        }
      }
      word = (static_cast<u64>(hi) << 32) | lo;
      if (cb == rb) word &= ~0ull << t << 1;  // only j > i
      if (k - cb * kWord < kWord) word &= (1ull << (k - cb * kWord)) - 1ull;  // only j < K
    }
    *out = word;
  }
  if (work != nullptr) {  // the loop's trip count is the block's: whole warps get here
    const unsigned n = __reduce_add_sync(kFull, words);
    if ((t & 31) == 0 && n) atomicAdd(work, static_cast<u64>(n) * kWord);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One TMA bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Waits for phase `parity` of `bar`; traps (a launch failure the wrapper
// reports) rather than spin for ever if the copy never lands.
__device__ __forceinline__ void wait_parity(u64* bar, unsigned parity) {
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1 << 24)) __trap();
  }
}

__global__ void __launch_bounds__(kScanThreads, 1)
nms_scan_kernel(const u64* __restrict__ mask,       // band [B, r1 - r0, nb - r0, 64]
                const uint8_t* __restrict__ valid,  // [B, K] 0/1
                uint8_t* __restrict__ keep,         // [B, K] 0/1
                u64* g_removed,                     // [B, nb]: carried between bands
                const int* __restrict__ counts,     // [B] n_valid, from the first band
                u64* work,                          // null, or [2] work counters
                int k, int nb, int r0, int r1, int chunk) {
  // [2][chunk][64] words of the chunks in flight, by parity; then `removed`
  // ([nb]).
  extern __shared__ __align__(16) u64 s_dyn[];
  __shared__ __align__(8) u64 s_bar[2];  // "chunk landed", by parity
  __shared__ u64 s_kept;
  __shared__ int s_part[kScanWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  const size_t plane = static_cast<size_t>(nb - r0) * kWord;  // words per row block of the band
  const u64* m = mask + static_cast<size_t>(b) * (r1 - r0) * plane;
  u64* removed = s_dyn + 2 * static_cast<size_t>(chunk) * kWord;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&s_bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&s_bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int n_valid = 0;
  if (r0 == 0) {
    // removed = ~valid, bits past K set; one warp per word.
    int count = 0;
    for (int w = warp; w < nb; w += kScanWarps) {
      const int j = w * kWord + lane;
      const unsigned lo = __ballot_sync(kFull, j < k && v[j]);
      const unsigned hi = __ballot_sync(kFull, j + 32 < k && v[j + 32]);
      if (lane == 0) {
        removed[w] = ~((static_cast<u64>(hi) << 32) | lo);
        count += __popc(lo) + __popc(hi);
      }
    }
    if (lane == 0) s_part[warp] = count;
    __syncthreads();
    for (int w = 0; w < kScanWarps; ++w) n_valid += s_part[w];
  } else {
    n_valid = counts[b];
    if (r0 >= (n_valid + kWord - 1) / kWord) return;  // an earlier band finished this image
    for (int w = tid; w < nb; w += kScanThreads) removed[w] = g_removed[static_cast<size_t>(b) * nb + w];
    __syncthreads();
  }
  const int steps = (n_valid + kWord - 1) / kWord;
  const int end = min(r1, steps);

  // The band's chunks in order: row blocks r in [r0, end), each cut into
  // columns [c, min(nb, c + chunk)) for c = r, r + chunk, ... Row block r's
  // columns are contiguous in the mask, so a chunk is one bulk copy; thread
  // 0 keeps two in flight (load_r, load_c: the next one to load).
  int load_r = r0, load_c = r0;
  auto load = [&](int slot) {
    const int len = min(chunk, nb - load_c);
    bulk_load(s_dyn + static_cast<size_t>(slot) * chunk * kWord,
              m + (load_r - r0) * plane + static_cast<size_t>(load_c - r0) * kWord,
              static_cast<unsigned>(len * kWord * sizeof(u64)), &s_bar[slot]);
    load_c += chunk;
    if (load_c >= nb) load_c = ++load_r;
  };
  if (tid == 0 && load_r < end) load(0);
  if (tid == 0 && load_r < end) load(1);

  int seq = 0;  // chunks used so far
  for (int r = r0; r < end; ++r) {
    for (int c = r; c < nb; c += chunk, ++seq) {
      const int slot = seq & 1;
      wait_parity(&s_bar[slot], (seq >> 1) & 1);
      const u64* rows = s_dyn + static_cast<size_t>(slot) * chunk * kWord;  // [len][64]
      const int len = min(chunk, nb - c);
      if (c == r) {
        if (warp == 0) {
          // Resolve the block: lane l holds rows l and l + 32's diagonal
          // words (the chunk's first word). The survivors are the unique K
          // with K = A \ OR_{s in K} d[s] (A: the rows < n_valid not yet
          // removed; d[s] has bits only above s, so K is fixed position by
          // position). Iterating from K = A fixes at least one more position
          // per round and stops at K itself: exact, in at most 65 rounds, a
          // few on the data measured.
          const int live = min(kWord, n_valid - r * kWord);  // rows i < n_valid
          const u64 live_mask = live == kWord ? ~0ull : (1ull << live) - 1ull;
          const u64 was = removed[r];
          const u64 alive = ~was & live_mask;
          const u64 d0 = rows[lane], d1 = rows[lane + 32];
          u64 kept = alive, suppressed;
          while (true) {
            const u64 x = ((kept >> lane) & 1ull ? d0 : 0ull) | ((kept >> (lane + 32)) & 1ull ? d1 : 0ull);
            const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(x));
            const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(x >> 32));
            suppressed = (static_cast<u64>(hi) << 32) | lo;
            const u64 next = alive & ~suppressed;
            if (next == kept) break;  // the same in every lane
            kept = next;
          }
          if (lane == 0) {
            removed[r] = was | suppressed;
            s_kept = kept;
          }
        }
        __syncthreads();
      }
      const u64 kept = s_kept;
      if (kept) {
        for (int w = (c == r) + warp; w < len; w += kScanWarps) {
          const u64 a = (kept >> lane) & 1ull ? rows[w * kWord + lane] : 0ull;
          const u64 x = (kept >> (lane + 32)) & 1ull ? rows[w * kWord + lane + 32] : 0ull;
          const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(a | x));
          const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>((a | x) >> 32));
          if (lane == 0) removed[c + w] |= (static_cast<u64>(hi) << 32) | lo;
        }
      }
      __syncthreads();  // this buffer is free again
      if (tid == 0 && load_r < end) load(slot);
    }
  }

  if (end < steps) {  // the next band goes on from r1
    for (int w = tid; w < nb; w += kScanThreads) g_removed[static_cast<size_t>(b) * nb + w] = removed[w];
    return;
  }
  uint8_t* out = keep + static_cast<size_t>(b) * k;
  for (int i = tid; i < k; i += kScanThreads) {
    out[i] = !((removed[i / kWord] >> (i % kWord)) & 1ull);
  }
  if (work != nullptr) {
    u64 useful = 0;
    for (int i = tid; i < n_valid; i += kScanThreads) {
      if (!((removed[i / kWord] >> (i % kWord)) & 1ull)) useful += n_valid - 1 - i;
    }
    for (int o = 16; o > 0; o >>= 1) useful += __shfl_down_sync(kFull, useful, o);
    if (lane == 0 && useful) atomicAdd(work + 1, useful);
  }
}

}  // namespace

// One band [r0, r1) of row blocks; the wrapper runs the bands in order on
// one stream. kind: 0 = IoU, 1 = DIoU. `mask` (16-byte aligned) holds the
// band's batch * (r1 - r0) * (nb - r0) * 64 uint64 words, nb = ceil(k / 64);
// `removed` batch * nb words and `counts` batch ints, both kept from one
// band to the next. `chunk`: mask words per bulk copy of the scan, which
// takes 2 * chunk * 512 + nb * 8 bytes of shared memory (the copy buffers,
// then `removed`). `work`: null, or two uint64 counters the kernels add
// their work to (see the header). Returns a cudaError_t (0 on success).
extern "C" int jabd_nms_band(const void* boxes, const void* valid, void* mask, void* removed,
                             void* counts, void* keep, int batch, int k, int r0, int r1,
                             int chunk, float thr, int kind, float beta1,
                             void* stream, void* work) {
  if (batch <= 0 || k <= 0 || k > kMaxK || (kind != 0 && kind != 1) ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = (k + kWord - 1) / kWord;
  const long long smem = 2LL * chunk * kWord * sizeof(u64) + nb * 8LL;
  if (r0 < 0 || r1 <= r0 || r1 > nb || chunk <= 0 || chunk > nb || smem > kScanSmem ||
      band_tiles(r0, r1, nb) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto mask_kernel = kind == 1 ? nms_mask_kernel<true> : nms_mask_kernel<false>;
  // Kernel attributes and occupancy hold per device, so both caches are
  // kept per device (the current one); past kMaxDevices nothing is cached.
  static int cached_per_sm[kMaxDevices][2];  // resident mask blocks per SM, by kind; 0: not yet
  static bool scan_ready[kMaxDevices];       // the scan's opt-in to kScanSmem is made
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  const bool cached = device >= 0 && device < kMaxDevices;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cached) per_sm = cached_per_sm[device][kind];
  if (err == cudaSuccess && per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mask_kernel, kMaskThreads, 0);
    if (err == cudaSuccess && cached) cached_per_sm[device][kind] = per_sm;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many blocks as the card holds at once, split evenly over the images
  // (and no more than the band has tiles).
  const int per_image = static_cast<int>(
      std::max(1LL, std::min(band_tiles(r0, r1, nb), static_cast<long long>(sms * per_sm / batch))));
  if (static_cast<long long>(batch) * per_image > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mask_kernel<<<batch * per_image, kMaskThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<u64*>(mask), static_cast<int*>(counts), static_cast<u64*>(work), k, nb, r0, r1,
      per_image, thr, beta1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cached || !scan_ready[device]) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cached) scan_ready[device] = true;
  }
  nms_scan_kernel<<<batch, kScanThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<u64*>(removed), static_cast<const int*>(counts),
      static_cast<u64*>(work), k, nb, r0, r1, chunk);
  return static_cast<int>(cudaGetLastError());
}
