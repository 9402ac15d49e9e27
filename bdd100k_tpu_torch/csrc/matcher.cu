// Fused anchor<->GT matching and SSD target encoding for Hopper (sm_90a).
//
// Replaces the TPU kernel bdd100k_tpu/ops/pallas_matcher.py::
// pallas_encode_targets (body _matcher_kernel). Per image, against M
// padded GT boxes and A center anchors:
//   * IoU of every real GT with every anchor, the anchor's corners taken
//     as cx -/+ 0.5*w and its area from those corners (not w*h): the
//     oracle rounds it so, and one ulp flips ties;
//   * per anchor, the best GT (the lowest GT index takes a tie; padded
//     rows score -1 and never win over a real one);
//   * per GT, the best anchor (the lowest anchor id takes a tie);
//   * forced claims: each real GT's best anchor is positive and goes to
//     the highest claiming GT; every other anchor is positive when its
//     best IoU > threshold;
//   * class targets (0 = background) and the SSD (tx, ty, tw, th) encode
//     with variances vc / vs, zeros for negatives.
// matched_gt, positive and cls_targets equal ops/matching.py's oracle bit
// for bit: the file is built with -fmad=false and the IoU takes the
// oracle's operations in its order. loc_targets agree to logf's ulp.
//
// Bound: B*M_real*A IoUs of ~16 f32 operations with the divide (3.7 us at
// B=32, 1783 real GT rows, A=8732 on an H100), against 33 bytes written
// an anchor (2.8 us). The time goes to the (warp, GT) passes a GT cannot
// skip, each a chain of dependent operations around an IEEE divide and a
// warp reduction; so the design skips every IoU it can prove to be 0,
// overlaps the rest, keeps the SMs evenly loaded and keeps everything
// between the match and the encode on chip. One launch, one thread-block
// cluster an image:
//   * the image's anchors are dealt to the cluster's blocks (at most 8,
//     the portable size) in chunks of 32*APT consecutive anchors, chunk c
//     to block c % 8 and, there, to warp c / 8; lane l of a warp holds
//     anchors 32k + l of its chunk, so each thread keeps APT anchors'
//     corners, best IoU and best GT in registers from the match to the
//     encode, and every store is coalesced. Dealing the chunks round the
//     blocks mixes the feature maps in every block: the large anchors of
//     the coarse maps, which few GTs miss, load no block more than another;
//   * exact culling per warp: a warp takes, 32 GTs at a time by a ballot,
//     only the valid GTs that overlap the bounding box of its anchors'
//     corners (not gx2 <= ux1 || gx1 >= ux2 || gy2 <= uy1 || gy1 >= uy2).
//     For a GT outside it ix2 - ix1 <= 0 or iy2 - iy1 <= 0 for every
//     anchor of the warp, so the IoU is exactly 0, which no update below
//     can take. Anchors are location-major, so a chunk covers a few cells
//     of one feature map (a block's box, over chunks from every map, would
//     cull almost nothing);
//   * two GTs a pass, and the divide inline and branch-free where that is
//     exact (exact_div.cuh), so a thread's 2*APT IoUs overlap;
//   * initial values that keep the oracle's bits: an anchor starts at IoU
//     0 at the image's first valid GT (-1 at GT 0 when it has none), a GT
//     at "IoU 0 at anchor 0"; updates are strict >, in ascending GT id
//     and, inside a thread, ascending anchor id;
//   * the per-GT best anchor is a max over a packed key -- the IoU's bits
//     above the complement of the anchor id -- taken in a warp by two
//     __reduce_max_sync, and only when a lane beats the best key another
//     warp of the block has already left for that GT (a key at or below
//     it cannot win), then over the block's warps in shared memory, and
//     across the cluster by reading every block's result through
//     distributed shared memory after cluster.sync(). Integer max is exact
//     in any order, so two calls give the same bits, and no scratch in
//     device memory is zeroed or read back;
//   * forced claims by scatter: each block takes, for every valid GT whose
//     best anchor is one of its own, a shared atomicMax of the GT index
//     into that anchor's slot (the highest GT wins); an anchor then reads
//     one slot;
//   * SSD300's plan (APT 2, 576 threads) is held to 56 registers, so two
//     blocks share an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT = 231424;  // 226 KB dynamic, beside the static few
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;
// "IoU 0 at anchor 0": the oracle's best anchor of a GT that overlaps none
constexpr u64 KEY0 = 0xffffffffull;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return fmaxf(x2 - x1, 0.f) * fmaxf(y2 - y1, 0.f);
}

// the IoU's intersection and union in the oracle's order: the IoU is
// inter / max((area_gt + area_anchor) - inter, 1e-8)
__device__ __forceinline__ void inter_union(float gx1, float gy1, float gx2,
                                            float gy2, float garea, float ax1,
                                            float ay1, float ax2, float ay2,
                                            float aarea, float& inter,
                                            float& uni) {
  const float ix1 = fmaxf(gx1, ax1);
  const float iy1 = fmaxf(gy1, ay1);
  const float ix2 = fminf(gx2, ax2);
  const float iy2 = fminf(gy2, ay2);
  inter = fmaxf(ix2 - ix1, 0.f) * fmaxf(iy2 - iy1, 0.f);
  uni = fmaxf((garea + aarea) - inter, 1e-8f);
}

// true when the GT box misses [x1, x2] x [y1, y2] with no positive overlap
__device__ __forceinline__ bool misses(float gx1, float gy1, float gx2,
                                       float gy2, float x1, float y1,
                                       float x2, float y2) {
  return gx2 <= x1 || gx1 >= x2 || gy2 <= y1 || gy1 >= y2;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// the IoUs of GT m with this thread's APT anchors into v, through
// exact_div.cuh's ratio; returns whether a lane needs exact = true
template <int APT>
__device__ __forceinline__ bool gt_ious(
    const float* gx1, const float* gy1, const float* gx2, const float* gy2,
    const float* garea, int m, const float (&ax1)[APT],
    const float (&ay1)[APT], const float (&ax2)[APT], const float (&ay2)[APT],
    const float (&aar)[APT], bool exact, float (&v)[APT]) {
  const float x1 = gx1[m], y1 = gy1[m], x2 = gx2[m], y2 = gy2[m];
  const float ar = garea[m];
  bool odd = false;
#pragma unroll
  for (int k = 0; k < APT; ++k) {
    float inter, uni;
    inter_union(x1, y1, x2, y2, ar, ax1[k], ay1[k], ax2[k], ay2[k], aar[k],
                inter, uni);
    bool o;
    v[k] = ratio(inter, uni, exact, o);
    odd |= o;
  }
  return odd;
}

// offers this warp's best anchor for GT m (each lane's best IoU tv > 0 at
// anchor ta, the lowest first) as the packed key: the IoU's bits above the
// complement of the anchor id. The warp reduces only when a lane beats the
// best key another warp has left for m so far (`key`, a hint: read and
// written without atomics, it only ever holds some warp's key, so a lane
// below it cannot win), and writes its row of `warp_key`
__device__ __forceinline__ void offer_key(u64* key, u64* warp_key, int m,
                                          float tv, int ta, int lane) {
  const unsigned bits = tv > 0.f ? __float_as_uint(tv) : 0u;
  const unsigned low = 0xffffffffu - (unsigned)ta;
  const u64 mine = tv > 0.f ? ((u64)bits << 32) | (u64)low : 0ull;
  if (__any_sync(FULL, mine > *(volatile u64*)&key[m])) {
    const unsigned hi = __reduce_max_sync(FULL, bits);
    const unsigned lo = __reduce_max_sync(FULL, bits == hi ? low : 0u);
    if (lane == 0) {
      const u64 k = ((u64)hi << 32) | (u64)lo;
      warp_key[m] = k;
      if (k > *(volatile u64*)&key[m]) *(volatile u64*)&key[m] = k;
    }
  }
}

// threads a block for APT anchors a thread, and blocks an SM: the launch
// bound that leaves each instantiation the registers it needs. Two blocks
// of SSD300's plan (APT 2, 576 threads) share an SM: 56 registers
__host__ __device__ constexpr int max_threads(int apt) {
  return apt == 1 ? 1024 : apt == 2 ? 576 : apt == 4 ? 768 : 512;
}
__host__ __device__ constexpr int min_blocks(int apt) {
  return apt == 2 ? 2 : 1;
}

// grid (cluster blocks, B), cluster (cluster blocks, 1, 1). Chunk c of an
// image's anchors, [32 * APT * c, 32 * APT * (c + 1)), belongs to block
// c % blocks and to warp c / blocks there; lane l takes its anchors
// 32k + l. Shared: u64 key[M] | u64 warp_key[warps][M] | float x1, y1,
// x2, y2, area[M] (area -1 for a padded row) | int slot[threads * APT],
// one claim slot an anchor of the block.
template <int APT>
__global__ void __launch_bounds__(max_threads(APT), min_blocks(APT))
match_encode(const float4* __restrict__ gt_boxes,
             const int32_t* __restrict__ gt_labels,
             const uint8_t* __restrict__ gt_mask,
             const float4* __restrict__ anchors, int64_t* __restrict__ matched,
             uint8_t* __restrict__ positive, int64_t* __restrict__ cls,
             float4* __restrict__ loc, int M, int A, float threshold,
             float vc, float vs) {
  constexpr int CHUNK = 32 * APT;
  extern __shared__ __align__(16) unsigned char sm[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  u64* key = reinterpret_cast<u64*>(sm);
  u64* warp_key = key + M;
  float* gx1 = reinterpret_cast<float*>(warp_key + (size_t)nwarps * M);
  float* gy1 = gx1 + M;
  float* gx2 = gy1 + M;
  float* gy2 = gx2 + M;
  float* garea = gy2 + M;
  int* slot = reinterpret_cast<int*>(garea + M);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblocks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int wbase = (rank + nblocks * warp) * CHUNK;  // this warp's chunk

  for (int s = t; s < nwarps * CHUNK; s += blockDim.x) slot[s] = -1;
  for (int s = t; s < nwarps * M; s += blockDim.x) warp_key[s] = KEY0;
  for (int m = t; m < M; m += blockDim.x) {
    const float4 g = gt_boxes[(size_t)b * M + m];
    gx1[m] = g.x;
    gy1[m] = g.y;
    gx2[m] = g.z;
    gy2[m] = g.w;
    garea[m] = gt_mask[(size_t)b * M + m] ? box_area(g.x, g.y, g.z, g.w) : -1.f;
    key[m] = KEY0;
  }

  // this thread's anchors, in corner form as the oracle rounds them, and
  // the box of the warp's anchors (every lane holds it); a slot past A
  // holds the empty box at 0, whose IoU is always 0, and a warp with no
  // anchor an empty box, which every GT misses
  float ax1[APT], ay1[APT], ax2[APT], ay2[APT], aar[APT];
  float lo_x = CUDART_INF_F, lo_y = CUDART_INF_F;
  float hi_x = -CUDART_INF_F, hi_y = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < APT; ++k) {
    const int a = wbase + 32 * k + lane;
    ax1[k] = ay1[k] = ax2[k] = ay2[k] = aar[k] = 0.f;
    if (a < A) {
      const float4 c = anchors[a];
      const float hw = 0.5f * c.z;
      const float hh = 0.5f * c.w;
      ax1[k] = c.x - hw;
      ay1[k] = c.y - hh;
      ax2[k] = c.x + hw;
      ay2[k] = c.y + hh;
      aar[k] = box_area(ax1[k], ay1[k], ax2[k], ay2[k]);
      lo_x = fminf(lo_x, ax1[k]);
      lo_y = fminf(lo_y, ay1[k]);
      hi_x = fmaxf(hi_x, ax2[k]);
      hi_y = fmaxf(hi_y, ay2[k]);
    }
  }
  lo_x = warp_min(lo_x);
  lo_y = warp_min(lo_y);
  hi_x = warp_max(hi_x);
  hi_y = warp_max(hi_y);
  __syncthreads();

  // the match, each warp over the valid GTs its anchors' box does not cull
  // (a ballot of 32 GTs at a time, taken in ascending order): per anchor
  // the best GT, per GT the warp's best anchor
  float best[APT];
  int best_gt[APT];
#pragma unroll
  for (int k = 0; k < APT; ++k) {  // an image with no valid GT keeps these
    best[k] = -1.f;
    best_gt[k] = 0;
  }
  bool any_valid = false;
  for (int base = 0; base < M; base += 32) {
    const int mm = base + lane;
    const bool real = mm < M && garea[mm] >= 0.f;
    const unsigned vb = __ballot_sync(FULL, real);
    if (!any_valid && vb) {  // IoU 0 at the first valid GT
      any_valid = true;
#pragma unroll
      for (int k = 0; k < APT; ++k) {
        best[k] = 0.f;
        best_gt[k] = base + __ffs(vb) - 1;
      }
    }
    unsigned hits = __ballot_sync(
        FULL, real && !misses(gx1[mm], gy1[mm], gx2[mm], gy2[mm], lo_x, lo_y,
                              hi_x, hi_y));
    while (hits) {
      // two GTs a pass, in ascending order, their IoUs interleaved
      const int m = base + __ffs(hits) - 1;
      hits &= hits - 1u;
      const bool two = hits != 0u;  // warp-uniform
      const int m2 = two ? base + __ffs(hits) - 1 : m;
      if (two) hits &= hits - 1u;
      float v[APT], v2[APT];
      const bool odd = gt_ious<APT>(gx1, gy1, gx2, gy2, garea, m, ax1, ay1,
                                    ax2, ay2, aar, false, v) |
                       gt_ious<APT>(gx1, gy1, gx2, gy2, garea, m2, ax1, ay1,
                                    ax2, ay2, aar, false, v2);
      if (__any_sync(FULL, odd)) {  // rare: an IEEE divide out of range
        gt_ious<APT>(gx1, gy1, gx2, gy2, garea, m, ax1, ay1, ax2, ay2, aar,
                     true, v);
        gt_ious<APT>(gx1, gy1, gx2, gy2, garea, m2, ax1, ay1, ax2, ay2, aar,
                     true, v2);
      }
      float tv = 0.f, tv2 = 0.f;  // each GT's best IoU > 0 in this thread
      int ta = 0, ta2 = 0;        // and its anchor, the lowest first
#pragma unroll
      for (int k = 0; k < APT; ++k) {
        // strict: the lowest GT index keeps a tie
        if (v[k] > best[k]) {
          best[k] = v[k];
          best_gt[k] = m;
        }
        if (two && v2[k] > best[k]) {
          best[k] = v2[k];
          best_gt[k] = m2;
        }
        if (v[k] > tv) {
          tv = v[k];
          ta = wbase + 32 * k + lane;
        }
        if (v2[k] > tv2) {
          tv2 = v2[k];
          ta2 = wbase + 32 * k + lane;
        }
      }
      offer_key(key, warp_key + warp * M, m, tv, ta, lane);
      if (two) offer_key(key, warp_key + warp * M, m2, tv2, ta2, lane);
    }
  }
  __syncthreads();
  for (int m = t; m < M; m += blockDim.x) {  // the block's best, warps in order
    u64 k = KEY0;
    for (int w = 0; w < nwarps; ++w) {
      const u64 o = warp_key[w * M + m];
      k = o > k ? o : k;
    }
    key[m] = k;
  }
  cluster.sync();

  // forced claims: every block reads each valid GT's key from every block
  // of the cluster and scatters the claims that land on its own anchors
  for (int m = t; m < M; m += blockDim.x) {
    if (!(garea[m] >= 0.f)) continue;
    u64 k = 0ull;
    for (int r = 0; r < nblocks; ++r) {
      const u64 o = *cluster.map_shared_rank(&key[m], r);
      k = o > k ? o : k;
    }
    const int a = (int)(0xffffffffu - (unsigned)(k & 0xffffffffull));
    const int c = a / CHUNK;
    if (c % nblocks == rank) atomicMax(&slot[c / nblocks * CHUNK + a % CHUNK], m);
  }
  // no block leaves while another may still read its keys
  cluster.sync();

  // the encode
#pragma unroll
  for (int k = 0; k < APT; ++k) {
    const int a = wbase + 32 * k + lane;
    if (a >= A) continue;
    const int s = slot[warp * CHUNK + 32 * k + lane];
    const bool forced = s >= 0;
    const bool pos = forced || best[k] > threshold;
    const int mg = forced ? s : best_gt[k];
    const size_t i = (size_t)b * A + a;
    matched[i] = mg;
    positive[i] = pos;
    cls[i] = pos ? gt_labels[(size_t)b * M + mg] : 0;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos) {
      // corner_to_center then encode_boxes, in the oracle's order
      const float w = gx2[mg] - gx1[mg];
      const float h = gy2[mg] - gy1[mg];
      const float cx = gx1[mg] + 0.5f * w;
      const float cy = gy1[mg] + 0.5f * h;
      const float4 c = anchors[a];
      out.x = (cx - c.x) / (c.z * vc);
      out.y = (cy - c.y) / (c.w * vc);
      out.z = logf(fmaxf(w, 1e-8f) / c.z) / vs;
      out.w = logf(fmaxf(h, 1e-8f) / c.w) / vs;
    }
    loc[i] = out;
  }
}

template <int APT>
int launch(const void* gt_boxes, const void* gt_labels, const void* gt_mask,
           const void* anchors, void* matched, void* positive, void* cls,
           void* loc, int B, int M, int A, int blocks, int threads, int smem,
           float threshold, float vc, float vs, cudaStream_t stream) {
  if (threads > max_threads(APT) ||
      (long long)blocks * threads * APT < (long long)A) {
    return -2;
  }
  // the opt-in above 48 KB is made once per size, so a launch under
  // CUDA-graph capture makes no runtime call beside the launch
  static int opted = 48 * 1024;
  if (smem > opted) {
    const int err = (int)cudaFuncSetAttribute(
        match_encode<APT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(
      &cfg, match_encode<APT>, (const float4*)gt_boxes,
      (const int32_t*)gt_labels, (const uint8_t*)gt_mask,
      (const float4*)anchors, (int64_t*)matched, (uint8_t*)positive,
      (int64_t*)cls, (float4*)loc, M, A, threshold, vc, vs);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gt_boxes (B, M, 4) f32 corner, gt_labels (B, M) int32, gt_mask (B, M)
// bool, anchors (A, 4) f32 center; outputs matched_gt (B, A) int64,
// positive (B, A) bool, cls_targets (B, A) int64, loc (B, A, 4) f32. All
// contiguous, boxes, anchors and loc 16-byte aligned. The plan (from
// ops/matcher._plan): `blocks` a cluster, `apt` anchors a thread,
// `threads` a block, `smem` dynamic shared bytes. One launch; returns -2
// for a plan it cannot take, else the first non-zero CUDA error.
int encode_targets(const void* gt_boxes, const void* gt_labels,
                   const void* gt_mask, const void* anchors, void* matched,
                   void* positive, void* cls, void* loc, int B, int M, int A,
                   int blocks, int apt, int threads, int smem,
                   float threshold, float vc, float vs, void* stream) {
  const bool ok = B >= 1 && M >= 1 && A >= 1 && blocks >= 1 &&
                  blocks <= MAX_CLUSTER && threads >= 32 &&
                  threads % 32 == 0 &&
                  smem >= (long long)M * (28 + 8 * (threads / 32)) +
                              4LL * threads * apt &&
                  smem <= SMEM_LIMIT;
  if (!ok) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  switch (apt) {
    case 1:
      return launch<1>(gt_boxes, gt_labels, gt_mask, anchors, matched,
                       positive, cls, loc, B, M, A, blocks, threads, smem,
                       threshold, vc, vs, st);
    case 2:
      return launch<2>(gt_boxes, gt_labels, gt_mask, anchors, matched,
                       positive, cls, loc, B, M, A, blocks, threads, smem,
                       threshold, vc, vs, st);
    case 4:
      return launch<4>(gt_boxes, gt_labels, gt_mask, anchors, matched,
                       positive, cls, loc, B, M, A, blocks, threads, smem,
                       threshold, vc, vs, st);
    case 8:
      return launch<8>(gt_boxes, gt_labels, gt_mask, anchors, matched,
                       positive, cls, loc, B, M, A, blocks, threads, smem,
                       threshold, vc, vs, st);
    default:
      return -2;
  }
}

}  // extern "C"
