// 3x3 stride-1 SAME depthwise convolution, NHWC, and its filter gradient,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of bdd100k_tpu/ops/pallas_depthwise.py:
//   _fwd_pallas   o[b,i,j,c]  = sum_{dh,dw} xpad[b,i+dh,j+dw,c] * k[dh,dw,c]
//                 (f32 accumulation, output in the input's type; the input
//                 gradient is the same kernel on g with the filter flipped,
//                 _dw3x3_s1_bwd -- the wrapper flips the filter);
//   _fgrad_pallas dk[dh,dw,c] = sum_{b,i,j} g[b,i,j,c] * xpad[b,i+dh,j+dw,c]
//                 ((3, 3, C) f32).
// Both take bf16 or f32.
//
// Bound: bytes. Each does 18 flops per element against 2-4 bytes moved
// (x in and y out, or x and g in), far below the card's ~295 flop/byte
// ridge, so the least time is the bytes over 3.35 TB/s and tensor cores
// have no part here: the work is FMAs on CUDA cores, and the design is
// about moving each byte once and keeping the SMs busy while it moves.
//
// What held the first design back, and what this one does about it:
//   * a fixed 8x16 tile left half the threads idle on 19x19 and 10x10
//     maps -> the tiling is a launch plan computed per shape in Python
//     (ops/depthwise.py::_plan, the one place it is defined): full-width
//     tiles where W <= 40, tile rows that pad H least, channel chunks,
//     ~2x132 work items wherever the shape has that many, and the count of
//     persistent blocks;
//   * load, sync, compute with nothing overlapping, the halo staged in
//     f32 with integer div/mod and an edge test per element -> the halo
//     is one TMA box of a 4D tensor map over (C, W, H, B), in the input's
//     own type; TMA fills out-of-bounds elements with zeros, which is
//     SAME's zero pad, so staging costs no thread instructions and has no
//     edge tests; persistent blocks walk a balanced range of work items
//     through a ring of 2-4 buffers with one mbarrier each, so the next
//     items' halos load while one computes;
//   * scalar shared-memory reads with 2-way bank conflicts and no reuse
//     between neighbouring outputs -> each thread owns one 16-byte vector
//     of channels, one output column and a strip of `rows` output rows,
//     reads each input row of its 3-column window once (rows + 2 reads of
//     3 vectors for `rows` outputs, instead of 9 a output), and rolls
//     three f32 accumulators (forward) or three g vectors (filter
//     gradient) down the strip; consecutive threads read consecutive
//     vectors, so there are no bank conflicts; outputs are stored as
//     16-byte vectors;
//   * the filter gradient's second pass was one serial chain per (tap,
//     channel) over a fixed 1024 partials -> the filter gradient takes the
//     forward's tiling and vectors, g comes through the same TMA ring as
//     x, the partials are one per persistent block (the plan's `parts`),
//     each block sums its threads in a fixed pairwise tree in shared
//     memory, and the second pass is one warp per (tap, 8 channels):
//     lanes sum strided partials in order, then a fixed xor tree. No
//     float atomics, so dk is the same bits on every run.
//
// Host side: the tensor maps are encoded in the C entry points with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library does not link libcuda, and passed as __grid_constant__ kernel
// parameters (so a CUDA graph capture keeps them). An encode failure is
// returned as a non-zero code.

#include <cuda.h>  // CUtensorMap and its enums; only the header
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // ops/depthwise.py::MAX_THREADS
constexpr int MIN_BLOCKS = 2;     // a block's registers <= 65536 / (256 * 2)
constexpr int MAX_STAGES = 4;     // ops/depthwise.py::MAX_STAGES
constexpr int RING = 128;         // the mbarriers, ahead of the ring buffers
constexpr int ERR_TENSOR_MAP = -1;
constexpr int ERR_PLAN = -2;

__host__ __device__ constexpr int round128(int n) { return (n + 127) / 128 * 128; }

// ------------------------------------------------------------ TMA, mbarrier

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// box of `map` at (c, j, i, b) -> dst, completion counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int j, int i,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c), "r"(j),
      "r"(i), "r"(b)
      : "memory");
}

// ----------------------------------------------------------- vectors of N

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[N]) {
  static_assert(N == 4, "f32 vectors are 4 channels");
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void unpack2(uint32_t u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[N]) {
  static_assert(N == 8 || N == 4, "bf16 vectors are 8 or 4 channels");
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, f); unpack2(u.y, f + 2); unpack2(u.z, f + 4); unpack2(u.w, f + 6);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, f); unpack2(u.y, f + 2);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// ------------------------------------------------------------- work items

// Everything a block needs from the plan (ops/depthwise.py::_plan):
// tiles of th x tw outputs and cb channels, `rows` output rows a thread;
// block (p, chunk) of a (parts, chunks) grid takes the spatial items
// [p*n/parts, (p+1)*n/parts) of channel chunk `chunk`. A spatial item s is
// (image, row band, column tile), column tile fastest
// (ops/depthwise.py::_work_items mirrors this).
struct Tiling {
  int B, H, W, C, tw, th, rows, cb, stages;
  __device__ int coltiles() const { return (W + tw - 1) / tw; }
  __device__ int n_spatial() const {
    return B * ((H + th - 1) / th) * coltiles();
  }
  __device__ void item(int s, int& b, int& i0, int& j0) const {
    const int ct = coltiles();
    const int per_image = ((H + th - 1) / th) * ct;
    b = s / per_image;
    const int r = s - b * per_image;
    i0 = (r / ct) * th;
    j0 = (r - (r / ct) * ct) * tw;
  }
};

// The ring: `stages` mbarriers in the first RING bytes, then `stages`
// buffers of `stage_bytes`; item n of a block goes through buffer
// n % stages. Thread 0 initialises the barriers and issues the first
// loads.
template <typename Issue>
__device__ __forceinline__ uint64_t* ring_start(unsigned char* smem, int stages,
                                                int first, int last,
                                                Issue issue) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < stages && first + s < last; ++s) issue(first + s, s);
  return bars;
}

// wait for item n's buffer
__device__ __forceinline__ void ring_wait(uint64_t* bars, int n, int stages) {
  mbar_wait(&bars[n % stages], (n / stages) & 1);
}

// after item n's reads: its buffer takes item n + stages
template <typename Issue>
__device__ __forceinline__ void ring_next(int n, int stages, int first,
                                          int last, Issue issue) {
  __syncthreads();
  if (threadIdx.x == 0 && first + n + stages < last) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    issue(first + n + stages, n % stages);
  }
}

// ---------------------------------------------------------------- forward

// grid (parts, chunks); block cg * tw * (th / rows) threads, cg = cb / V:
// thread t owns channel group t % cg, column (t / cg) % tw and output rows
// [strip * rows, strip * rows + rows) of the tile, strip = t / (cg * tw).
template <typename T, int ROWS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
dw3x3_s1_kernel(const __grid_constant__ CUtensorMap xmap,
                const T* __restrict__ k, T* __restrict__ y, Tiling tl) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int hc = tl.tw + 2;
  const int box = (tl.th + 2) * hc * tl.cb * sizeof(T);
  const int stage_bytes = round128(box);
  const int cg = tl.cb / V;
  const int gi = threadIdx.x % cg;
  const int col = (threadIdx.x / cg) % tl.tw;
  const int r0 = threadIdx.x / (cg * tl.tw) * ROWS;
  const int c0 = blockIdx.y * tl.cb;
  const int c = c0 + gi * V;
  const int n = tl.n_spatial();
  const int first = (int)((long long)blockIdx.x * n / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);

  auto issue = [&](int s, int stage) {
    int b, i0, j0;
    tl.item(s, b, i0, j0);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    mbar_expect(&bars[stage], box);
    tma_load(smem + RING + stage * stage_bytes, &xmap, &bars[stage], c0,
             j0 - 1, i0 - 1, b);
  };
  uint64_t* bars = ring_start(smem, tl.stages, first, last, issue);

  float w[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (c < tl.C) {
      load_vec(k + (size_t)t * tl.C + c, w[t]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) w[t][v] = 0.f;
    }
  }

  for (int it = 0; first + it < last; ++it) {
    int b, i0, j0;
    tl.item(first + it, b, i0, j0);
    ring_wait(bars, it, tl.stages);
    const T* tile =
        reinterpret_cast<const T*>(smem + RING + (it % tl.stages) * stage_bytes);
    const int j = j0 + col;
    const bool live = j < tl.W && c < tl.C;
    T* out = y + (((size_t)b * tl.H + i0 + r0) * tl.W + j) * tl.C + c;
    // prev: output row s-2 (taps dh 0, 1 done; takes dh 2 from row s);
    // cur: row s-1; next: row s. Taps land in the order dh, then dw.
    float prev[V], cur[V], nxt[V];
#pragma unroll
    for (int v = 0; v < V; ++v) prev[v] = cur[v] = 0.f;
#pragma unroll
    for (int s = 0; s < ROWS + 2; ++s) {
      const T* px = tile + ((r0 + s) * hc + col) * tl.cb + gi * V;
      float x0[V], x1[V], x2[V];
      load_vec(px, x0);
      load_vec(px + tl.cb, x1);
      load_vec(px + 2 * tl.cb, x2);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        nxt[v] = fmaf(x2[v], w[2][v], fmaf(x1[v], w[1][v], x0[v] * w[0][v]));
        cur[v] = fmaf(x2[v], w[5][v], fmaf(x1[v], w[4][v], fmaf(x0[v], w[3][v], cur[v])));
        prev[v] = fmaf(x2[v], w[8][v], fmaf(x1[v], w[7][v], fmaf(x0[v], w[6][v], prev[v])));
      }
      if (s >= 2 && live && i0 + r0 + s - 2 < tl.H)
        store_vec(out + (size_t)(s - 2) * tl.W * tl.C, prev);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        prev[v] = cur[v];
        cur[v] = nxt[v];
      }
    }
    ring_next(it, tl.stages, first, last, issue);
  }
}

// -------------------------------------------------------- filter gradient

// grid (parts, chunks); block cg * tw * (th / rows) threads, cg = cb / V,
// laid out as the forward's. A stage holds the x halo box (th+2, tw+2,
// cb) and then the g box (th, tw, cb). Each thread keeps 9 taps x V
// channels of f32 sums over its items; the block's threads are then summed
// in a fixed pairwise tree in shared memory (over the idle ring), and
// block (p, chunk) writes part[p, :, chunk*cb : chunk*cb + cb].
template <typename T, int ROWS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
dw3x3_s1_fgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap,
                      float* __restrict__ part, Tiling tl) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int hc = tl.tw + 2;
  const int xbox = (tl.th + 2) * hc * tl.cb * sizeof(T);
  const int gbox = tl.th * tl.tw * tl.cb * sizeof(T);
  const int goff = round128(xbox);
  const int stage_bytes = goff + round128(gbox);
  const int cg = tl.cb / V;
  const int gi = threadIdx.x % cg;
  const int pix = threadIdx.x / cg;
  const int col = pix % tl.tw;
  const int r0 = pix / tl.tw * ROWS;
  const int c0 = blockIdx.y * tl.cb;
  const int n = tl.n_spatial();
  const int first = (int)((long long)blockIdx.x * n / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);

  auto issue = [&](int s, int stage) {
    int b, i0, j0;
    tl.item(s, b, i0, j0);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    unsigned char* buf = smem + RING + stage * stage_bytes;
    mbar_expect(&bars[stage], xbox + gbox);
    tma_load(buf, &xmap, &bars[stage], c0, j0 - 1, i0 - 1, b);
    tma_load(buf + goff, &gmap, &bars[stage], c0, j0, i0, b);
  };
  uint64_t* bars = ring_start(smem, tl.stages, first, last, issue);

  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  for (int it = 0; first + it < last; ++it) {
    ring_wait(bars, it, tl.stages);
    const unsigned char* buf = smem + RING + (it % tl.stages) * stage_bytes;
    const T* xt = reinterpret_cast<const T*>(buf) + gi * V;
    const T* gt = reinterpret_cast<const T*>(buf + goff) + gi * V;
    // halo row s feeds outputs s (dh 0), s-1 (dh 1), s-2 (dh 2) of the
    // strip; g rows outside the map are zero (TMA fill), those outside the
    // strip are not read
    float g0[V], g1[V], g2[V];  // g of output rows s, s-1, s-2
#pragma unroll
    for (int v = 0; v < V; ++v) g1[v] = g2[v] = 0.f;
#pragma unroll
    for (int s = 0; s < ROWS + 2; ++s) {
      if (s < ROWS) {
        load_vec(gt + ((r0 + s) * tl.tw + col) * tl.cb, g0);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) g0[v] = 0.f;
      }
      const T* px = xt + ((r0 + s) * hc + col) * tl.cb;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        float x[V];
        load_vec(px + dw * tl.cb, x);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[dw][v] = fmaf(g0[v], x[v], acc[dw][v]);
          acc[3 + dw][v] = fmaf(g1[v], x[v], acc[3 + dw][v]);
          acc[6 + dw][v] = fmaf(g2[v], x[v], acc[6 + dw][v]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        g2[v] = g1[v];
        g1[v] = g0[v];
      }
    }
    ring_next(it, tl.stages, first, last, issue);
  }

  // the block's threads: red[pix][9][cb] over the ring (every load has
  // been waited for, and ring_next's sync ended the last reads; a block
  // has at least one item), summed
  // pairwise (pix p takes p + half) in a fixed order until one row is left
  float* red = reinterpret_cast<float*>(smem + RING);
  const int row = 9 * tl.cb;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) red[pix * row + t * tl.cb + gi * V + v] = acc[t][v];
  __syncthreads();
  for (int m = blockDim.x / cg; m > 1;) {
    const int half = (m + 1) / 2;
    for (int e = threadIdx.x; e < (m - half) * row; e += blockDim.x)
      red[e] += red[e + half * row];
    __syncthreads();
    m = half;
  }
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    const int t = e / tl.cb, cc = e - t * tl.cb;
    if (c0 + cc < tl.C)
      part[((size_t)blockIdx.x * 9 + t) * tl.C + c0 + cc] = red[e];
  }
}

// dk[i .. i+8) = sum over p of part[p, i .. i+8), i = 8 * (global warp);
// lane l sums p = l, l + 32, ... in order, then a fixed xor tree (a + b
// and b + a are the same float, so every lane ends with the same bits)
__global__ void __launch_bounds__(MAX_THREADS)
dw3x3_s1_fgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dk,
                          int parts, int n) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q * 8 >= n) return;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = lane; p < parts; p += 32) {
    const float4* src = reinterpret_cast<const float4*>(part + (size_t)p * n + q * 8);
    const float4 a = src[0], b = src[1];
    s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
    s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < 8; ++v) s[v] += __shfl_xor_sync(0xffffffffu, s[v], off);
  if (lane == 0) {
    float4* dst = reinterpret_cast<float4*>(dk + q * 8);
    dst[0] = make_float4(s[0], s[1], s[2], s[3]);
    dst[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (C, W, H, B) map over NHWC `base` with box (cb, bw, bh, 1); elements
// outside the tensor read as zero
template <typename T>
bool encode(CUtensorMap* map, const void* base, const Tiling& tl, int bw, int bh) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)tl.C, (cuuint64_t)tl.W,
                              (cuuint64_t)tl.H, (cuuint64_t)tl.B};
  const cuuint64_t strides[3] = {es * tl.C, es * tl.C * tl.W,
                                 es * tl.C * tl.W * tl.H};
  const cuuint32_t box[4] = {(cuuint32_t)tl.cb, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, dt, 4, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tiling_ok(const Tiling& tl, int vec, int parts) {
  const int cg = tl.cb / vec;
  return tl.cb % vec == 0 && tl.rows > 0 && tl.th % tl.rows == 0 && parts > 0 &&
         tl.stages >= 1 && tl.stages <= MAX_STAGES &&
         cg * tl.tw * (tl.th / tl.rows) <= MAX_THREADS;
}

// the kernels instantiated for the plan's rows a thread (1, 2, 4 or 8),
// so the strip's loop unrolls; null for any other count
template <typename T>
auto fwd_kernel(int rows) -> decltype(&dw3x3_s1_kernel<T, 1>) {
  switch (rows) {
    case 1: return dw3x3_s1_kernel<T, 1>;
    case 2: return dw3x3_s1_kernel<T, 2>;
    case 4: return dw3x3_s1_kernel<T, 4>;
    case 8: return dw3x3_s1_kernel<T, 8>;
    default: return nullptr;
  }
}

template <typename T>
auto fgrad_kernel(int rows) -> decltype(&dw3x3_s1_fgrad_kernel<T, 1>) {
  switch (rows) {
    case 1: return dw3x3_s1_fgrad_kernel<T, 1>;
    case 2: return dw3x3_s1_fgrad_kernel<T, 2>;
    case 4: return dw3x3_s1_fgrad_kernel<T, 4>;
    case 8: return dw3x3_s1_fgrad_kernel<T, 8>;
    default: return nullptr;
  }
}

// opt `kernel` in to `smem` bytes of dynamic shared memory where that is
// above the 48 KB default and above what it was given before (remembered,
// so a launch inside a CUDA graph capture makes no runtime call)
int allow_smem(const void* kernel, int smem) {
  static const void* seen[32];
  static int granted[32];
  static int n = 0;
  int i = 0;
  while (i < n && seen[i] != kernel) ++i;
  if (i == n) {
    if (n == 32) return ERR_PLAN;
    seen[n] = kernel;
    granted[n++] = 48 * 1024;
  }
  if (smem <= granted[i]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0) granted[i] = smem;
  return err;
}

template <typename T>
int launch(const void* x, const void* k, void* y, Tiling tl, int parts,
           int smem, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int need =
      RING + tl.stages * round128((tl.th + 2) * (tl.tw + 2) * tl.cb * (int)sizeof(T));
  auto kernel = fwd_kernel<T>(tl.rows);
  if (kernel == nullptr || !tiling_ok(tl, V, parts) || smem < need) return ERR_PLAN;
  CUtensorMap xmap;
  if (!encode<T>(&xmap, x, tl, tl.tw + 2, tl.th + 2)) return ERR_TENSOR_MAP;
  int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  const int threads = tl.cb / V * tl.tw * (tl.th / tl.rows);
  dim3 grid(parts, (tl.C + tl.cb - 1) / tl.cb);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(xmap, (const T*)k,
                                                        (T*)y, tl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fgrad(const void* x, const void* g, void* part, Tiling tl,
                 int parts, int smem, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = tl.cb / V * tl.tw * (tl.th / tl.rows);
  const int stage = round128((tl.th + 2) * (tl.tw + 2) * tl.cb * (int)sizeof(T)) +
                    round128(tl.th * tl.tw * tl.cb * (int)sizeof(T));
  const int red = threads * 9 * V * 4;
  const int need = RING + (tl.stages * stage > red ? tl.stages * stage : red);
  auto kernel = fgrad_kernel<T>(tl.rows);
  if (kernel == nullptr || !tiling_ok(tl, V, parts) || smem < need) return ERR_PLAN;
  CUtensorMap xmap, gmap;
  if (!encode<T>(&xmap, x, tl, tl.tw + 2, tl.th + 2) ||
      !encode<T>(&gmap, g, tl, tl.tw, tl.th))
    return ERR_TENSOR_MAP;
  int err = allow_smem((const void*)kernel, smem);
  if (err) return err;
  dim3 grid(parts, (tl.C + tl.cb - 1) / tl.cb);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(xmap, gmap,
                                                        (float*)part, tl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, C), k (3, 3, C), y (B, H, W, C), one type; contiguous, 16-byte
// aligned, C % 8 == 0. (tw, th, rows, cb, stages, parts, smem) is the launch plan
// of ops/depthwise.py::_plan. Returns 0, a cudaError_t after the launch,
// ERR_TENSOR_MAP (-1) if the tensor map could not be encoded, or ERR_PLAN
// (-2) for a plan the kernel cannot take.
int dw3x3_s1_f32(const void* x, const void* k, void* y, int B, int H, int W,
                 int C, int tw, int th, int rows, int cb, int stages, int parts,
                 int smem, void* stream) {
  return launch<float>(x, k, y, Tiling{B, H, W, C, tw, th, rows, cb, stages},
                       parts, smem, stream);
}

int dw3x3_s1_bf16(const void* x, const void* k, void* y, int B, int H, int W,
                  int C, int tw, int th, int rows, int cb, int stages, int parts,
                  int smem, void* stream) {
  return launch<__nv_bfloat16>(
      x, k, y, Tiling{B, H, W, C, tw, th, rows, cb, stages}, parts, smem, stream);
}

// Pass 1 of dk: x, g (B, H, W, C) of one type -> part (parts, 9, C) f32,
// with the same requirements and returns as above.
int dw3x3_s1_fgrad_f32(const void* x, const void* g, void* part, int B, int H,
                       int W, int C, int tw, int th, int rows, int cb,
                       int stages, int parts, int smem, void* stream) {
  return launch_fgrad<float>(
      x, g, part, Tiling{B, H, W, C, tw, th, rows, cb, stages}, parts, smem, stream);
}

int dw3x3_s1_fgrad_bf16(const void* x, const void* g, void* part, int B,
                        int H, int W, int C, int tw, int th, int rows, int cb,
                        int stages, int parts, int smem, void* stream) {
  return launch_fgrad<__nv_bfloat16>(
      x, g, part, Tiling{B, H, W, C, tw, th, rows, cb, stages}, parts, smem, stream);
}

// Pass 2 of dk: part (parts, 9, C) f32 -> dk (3, 3, C) f32, C % 8 == 0.
int dw3x3_s1_fgrad_sum(const void* part, void* dk, int parts, int C,
                       void* stream) {
  const int n = 9 * C;
  const int warps = n / 8;
  const int blocks = (warps * 32 + MAX_THREADS - 1) / MAX_THREADS;
  dw3x3_s1_fgrad_sum_kernel<<<blocks, MAX_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)dk, parts, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
