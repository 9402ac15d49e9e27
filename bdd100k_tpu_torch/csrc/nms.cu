// Exact greedy class-wise NMS suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel bdd100k_tpu/ops/pallas_nms.py::pallas_greedy_suppress
// (body _suppress_kernel). For each (image, class) row of K score-sorted
// candidates: candidate i survives iff it is valid and no surviving j < i
// has IoU(i, j) > thr, with IoU = inter / max((a_i + a_j) - inter, 1e-8)
// in f32. The keep mask must be bit-equal to ops/nms.py::greedy_keep_mask,
// so every IoU step uses the round-to-nearest intrinsics in the reference's
// operation order (and the file is built with -fmad=false besides): no
// contraction into FMA ever re-rounds the union. IoU(i, j) and IoU(j, i)
// are the same bits (fmaxf, fminf and + commute exactly), so each pair is
// computed once.
//
// Bound: the K(K-1)/2 IoUs of a row are ~14 f32 operations each and a
// candidate is 18 bytes, ~0.1 us of work for B=8, C=10, K=100. What costs
// time is latency: the greedy chain is sequential, and at serving sizes
// (10 rows at b1, 80 at b8) there are fewer rows than SMs. So one block
// of 32 warps takes one row -- the most SMs a call can use, each row's
// latency its own -- and the design shortens each row's critical path:
//   * one launch, K as it is (1 <= K <= 256): the ragged last 32-candidate
//     word is masked here, so the wrapper pads nothing;
//   * coalesced I/O: one thread a candidate reads its box (16 bytes) and
//     valid byte; a ballot packs valid into 32-bit words; keep is written
//     one byte a thread from the kept words;
//   * the "later overlaps" matrix in parallel and in balance: a warp takes
//     a (row i, word w) pair, each lane one candidate j = 32w + lane > i,
//     and __ballot_sync forms the word. Word by word, each lane keeps its
//     box j in registers and the warps deal the rows i < 32w + 31 among
//     themselves, two a pass, so only the upper triangle is computed and
//     no thread owns a long serial loop (K=100: 9-10 pairs a warp). Rows
//     and columns of invalid candidates are skipped;
//   * the divide inline and branch-free where that is exact
//     (exact_div.cuh), so a pass's two IoUs overlap;
//   * the greedy walk in registers, one warp, word by word. Inside word
//     w, its 32 candidates in order, each with its row's word w (its
//     later overlaps within the word) in a register: a live candidate is
//     kept and clears those bits -- a compare and a predicated AND a
//     candidate, no memory access on the chain. Then each lane takes one
//     kept candidate's row, and __reduce_or_sync over the warp clears its
//     later words from live. A suppressed candidate is never applied, so
//     it suppresses nothing: the greedy semantics of pallas_nms.py:11-13.
//     On an H100 this beat a walk stepping from one kept candidate to
//     the next through shared memory (a load on every step's chain), and
//     one with a word a lane (a ballot, __ffs and __shfl_sync a step);
//     overlapping the walk with the matrix, band by band of 32 rows,
//     gained nothing there: the walk's chain queued behind the IoUs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

constexpr int MAX_K = 256;
constexpr int MAX_WORDS = MAX_K / 32;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// area = max(x2 - x1, 0) * max(y2 - y1, 0)
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// the oracle's IoU, inter / max((area_a + area_b) - inter, 1e-8), through
// exact_div.cuh's ratio (`exact` and `odd` as there)
__device__ __forceinline__ float iou(float4 a, float aa, float4 b, float ab,
                                     bool exact, bool& odd) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.f));
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aa, ab), inter), 1e-8f);
  return ratio(inter, uni, exact, odd);
}

// the "later overlaps" matrix, row i's words w >= i / 32: word by word,
// each lane keeps its candidate j = 32w + lane in registers and the warps
// deal the rows i < 32w + 31 among themselves, two a pass; rows and
// columns of invalid candidates are never read, so never computed
__device__ __forceinline__ void build_later(
    uint32_t (*later)[MAX_WORDS], const float4* sbox, const float* sarea,
    const uint32_t* svalid, int K, int words, float thr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int w = 0; w < words; ++w) {
    const int j = 32 * w + lane;
    const bool in = j < K;
    const float4 bj = in ? sbox[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float aj = in ? sarea[j] : 0.f;
    const bool vj = (svalid[w] >> lane) & 1u;
    const int rows = min(32 * w + 31, K);
    // two rows a pass, their IoUs interleaved
    for (int i = warp; i < rows; i += 2 * WARPS) {
      const int i2 = i + WARPS;
      const bool vi = (svalid[i >> 5] >> (i & 31)) & 1u;
      const bool vi2 = i2 < rows && ((svalid[i2 >> 5] >> (i2 & 31)) & 1u);
      if (!vi && !vi2) continue;  // warp-uniform
      const int r2 = vi2 ? i2 : i;
      bool odd, odd2;
      float q = iou(sbox[i], sarea[i], bj, aj, false, odd);
      float q2 = iou(sbox[r2], sarea[r2], bj, aj, false, odd2);
      if (__any_sync(FULL, odd || odd2)) {  // rare: out of the fast range
        q = iou(sbox[i], sarea[i], bj, aj, true, odd);
        q2 = iou(sbox[r2], sarea[r2], bj, aj, true, odd2);
      }
      const uint32_t bits = __ballot_sync(FULL, j > i && vj && q > thr);
      const uint32_t bits2 = __ballot_sync(FULL, j > i2 && vj && q2 > thr);
      if (lane == 0) {
        if (vi) later[i][w] = bits;
        if (vi2) later[i2][w] = bits2;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
greedy_suppress_kernel(const float4* __restrict__ boxes,
                       const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep, int K, float thr) {
  __shared__ float4 sbox[MAX_K];
  __shared__ float sarea[MAX_K];
  // later[i][w] bit b: candidate j = 32w + b is later than i (j > i) and
  // IoU(i, j) > thr; only the words w >= i / 32 of a valid row are written
  __shared__ __align__(16) uint32_t later[MAX_K][MAX_WORDS];
  __shared__ uint32_t svalid[MAX_WORDS];
  __shared__ uint32_t skeep[MAX_WORDS];
  const size_t base = (size_t)blockIdx.x * K;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int words = (K + 31) >> 5;

  // stage the row; whole warps enter, so the ballot sees all 32 lanes
  if (t < 32 * words) {
    bool v = false;
    if (t < K) {
      const float4 b = boxes[base + t];
      sbox[t] = b;
      sarea[t] = box_area(b);
      v = valid[base + t] != 0;
    }
    const uint32_t w = __ballot_sync(FULL, v);
    if (lane == 0) svalid[warp] = w;
  }
  __syncthreads();

  build_later(later, sbox, sarea, svalid, K, words, thr);
  __syncthreads();

  // the greedy walk, one warp (its lanes in step), word by word: inside a
  // word, over its 32 candidates in order with their overlaps within the
  // word in registers (a live candidate is kept and clears its later
  // overlaps); then the kept candidates' overlaps with the later words,
  // one row a lane, are ORed across the warp and cleared from live
  if (warp == 0) {
    uint32_t live[MAX_WORDS], kept[MAX_WORDS];
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
      live[w] = w < words ? svalid[w] : 0u;
      kept[w] = 0u;
    }
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
      uint32_t cur = live[w];
      if (cur == 0u) continue;  // uniform
#pragma unroll
      for (int h = 0; h < 32; h += 16) {
        // a valid candidate's overlaps later in the word; the mask keeps
        // the bits after it, as the last of a word has none and its word
        // is never written (nor is any row of an invalid candidate, which
        // is never live)
        uint32_t m[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          m[q] = later[32 * w + h + q][w] & (0xfffffffeu << (h + q));
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (cur & (1u << (h + q))) cur &= ~m[q];
        }
      }
      kept[w] = cur;
      if (w + 1 < MAX_WORDS) {
        const uint4* row = reinterpret_cast<const uint4*>(later[32 * w + lane]);
        const bool mine = (cur >> lane) & 1u;
        const uint4 lo = mine ? row[0] : make_uint4(0u, 0u, 0u, 0u);
        const uint4 hi = mine ? row[1] : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t r[MAX_WORDS] = {lo.x, lo.y, lo.z, lo.w,
                                       hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int v = w + 1; v < MAX_WORDS; ++v) {
          if (v < words) live[v] &= ~__reduce_or_sync(FULL, r[v]);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < MAX_WORDS; ++w) skeep[w] = kept[w];
    }
  }
  __syncthreads();
  if (t < K) keep[base + t] = (uint8_t)((skeep[t >> 5] >> (t & 31)) & 1u);
}

}  // namespace

extern "C" {

// boxes (rows, K, 4) f32 corner boxes, score-sorted within each row, 16-byte
// aligned; valid (rows, K) uint8 0/1; keep (rows, K) uint8 0/1 written
// here. 1 <= K <= 256. One launch; returns cudaGetLastError().
int greedy_suppress(const void* boxes, const void* valid, void* keep,
                    int rows, int K, float thr, void* stream) {
  if (K < 1 || K > MAX_K || rows <= 0) return (int)cudaErrorInvalidValue;
  greedy_suppress_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep, K, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
