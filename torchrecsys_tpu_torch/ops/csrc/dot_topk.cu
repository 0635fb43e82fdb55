// Full-catalog score + top-k for Hopper (sm_90a): two kernels and their
// split merge, behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/dot_topk.py, built by ops/_build.py).
//
// Both kernels compute, for every user u, the k best items of
//     score[u, g] = users[u] . items[g] + bias[g]
// (products widened to f32 before accumulation, as preferred_element_type
// does on the TPU), with a masked item scoring kNegInf, in ONE total order:
// (value desc, item index asc). That order is jax.lax.top_k's lowest-index
// tie rule, and every comparison below -- insertion, compaction, merge --
// uses it, so no merge can reorder ties (the CUDA twin of the Mosaic argmax
// trap at torchrecsys_tpu/ops/dot_topk.py:98-109).
//
// The TPU kernels walk the catalog as a sequential grid carrying a running
// top-k in VMEM (ops/dot_topk.py:151-198, 399-441). Blocks here run in
// parallel and carry nothing, so the catalog is cut into S splits: a block
// owns (user tile x split) and writes one sorted partial list per
// (user, split) to scratch that the wrapper allocates; a second launch,
// dot_topk_merge_kernel, sorts each user's S lists and keeps the first k.
//
// Bound at the main-path shape (U=256, N=1,000,000, D=80):
//   f32:  2*U*N*D = 40.96 GFLOP over 67 TFLOP/s (f32 FMA, no tensor cores)
//         = 0.61 ms, against 324 MB (items + bias) over 3.35 TB/s = 0.10 ms:
//         compute-bound.
//   bf16: the same 0.61 ms of f32 FMAs; the item stream halves to 164 MB
//         (0.05 ms). Still compute-bound, because the products run as f32
//         FMAs (bf16 is widened on the way into shared memory).
// What the design does about it: item tiles come into shared memory with
// 16-byte loads and are widened to f32 once per block, not per thread; the
// FMAs run in independent chains from registers (K1: the user vector in
// registers, one broadcast shared load per 4 FMAs; K2: a 4-user x 4-item
// register tile, one shared load per 8 FMAs); and the top-k bookkeeping is
// a compare against a register threshold for all but a few percent of the
// scores. Tensor cores (wgmma) and TMA-fed tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// np.finfo(np.float32).min: the masked/padded score of ops/dot_topk.py:36.
// Masked items still compete with this value and their index, so a user with
// fewer unseen items than k gets the masked tail in index order, as in JAX.
constexpr float kNegInf = -3.40282346638528859811704183484516925e+38f;
constexpr int kIntMax = 0x7fffffff;
constexpr int kMaskTile = 4096;               // ops/dot_topk.py:59
constexpr int kMaskWords = kMaskTile / 32;    // 128 words per mask tile

__device__ __forceinline__ float sentinel_value() {
  return __int_as_float(0xff800000);  // -inf: loses to every real score
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (va, ia) strictly precedes (vb, ib) in (value desc, index asc) order.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Packed seen-mask bit of item g: ops/dot_topk.py:62-87 layout, where item
// j of a 4096-item tile lives in word (j % 128), bit (j / 128).
__device__ __forceinline__ bool is_masked(const int* __restrict__ mrow, int g) {
  const int lg = g & (kMaskTile - 1);
  const int word = (g / kMaskTile) * kMaskWords + (lg & (kMaskWords - 1));
  const int bit = lg / kMaskWords;
  return (__ldg(mrow + word) >> bit) & 1;
}

// One user's vector, zero-padded to 4*D4, into registers.
template <typename T, int D4>
__device__ __forceinline__ void load_user(float4 (&uv)[D4],
                                          const T* __restrict__ users, int u,
                                          int U, int D) {
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      x[e] = (u < U && d < D) ? to_f32(users[(size_t)u * D + d]) : 0.f;
    }
    uv[c] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// 4 bf16 (two 32-bit words, low half first) -> 4 f32, exactly.
__device__ __forceinline__ float4 bf16x4_lo(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// The 16-byte unit a thread loads: 4 f32 or 8 bf16 values.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  using type = float4;
  static constexpr int floats = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  using type = uint4;
  static constexpr int floats = 8;
};

// Chunk c of a tile row, widened to f32.
__device__ __forceinline__ void put_chunk(float4* row, int c, int, float4 v) {
  row[c] = v;
}
__device__ __forceinline__ void put_chunk(float4* row, int c, int d4, uint4 v) {
  row[2 * c] = bf16x4_lo(make_uint2(v.x, v.y));
  if (2 * c + 1 < d4) row[2 * c + 1] = bf16x4_lo(make_uint2(v.z, v.w));
}

// 16-byte chunks each of NT threads moves for one TILE-row tile.
template <typename T, int D4, int TILE, int NT>
__host__ __device__ constexpr int chunks_per_thread() {
  return (TILE * ((4 * D4 + Chunk<T>::floats - 1) / Chunk<T>::floats) + NT - 1) / NT;
}

// Tile rows in 16-byte chunks, read from the first `cnt` rows at `rows` of
// an item matrix with 16-byte aligned rows (D a multiple of
// Chunk<T>::floats). `fetch` loads into registers and `store` writes the
// shared tile, so a caller can keep the next tile's loads in flight while
// it scores the current one.
template <typename T, int D4, int DS4, int TILE, int NT, int ITERS>
struct TileChunks {
  using C = typename Chunk<T>::type;
  static constexpr int CH = (4 * D4 + Chunk<T>::floats - 1) / Chunk<T>::floats;
  static constexpr int TOTAL = TILE * CH;
  C r[ITERS];

  // chunks first, first + NT, ..., first + (ITERS - 1) * NT of the tile
  __device__ __forceinline__ void fetch(const T* __restrict__ rows, int cnt,
                                        int D, int first) {
    const int dq = D / Chunk<T>::floats;
    const C* src = reinterpret_cast<const C*>(rows);
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int e = first + i * NT;
      const int row = e / CH;
      const int c = e - row * CH;
      r[i] = (e < TOTAL && row < cnt && c < dq) ? __ldg(src + (size_t)row * dq + c) : C{};
    }
  }

  __device__ __forceinline__ void store(float4* __restrict__ dst, int first) const {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int e = first + i * NT;
      if (e < TOTAL) {
        const int row = e / CH;
        put_chunk(dst + row * DS4, e - row * CH, D4, r[i]);
      }
    }
  }
};

// A whole tile, G chunks per thread at a time: a tile costs about
// ceil(chunks per thread / G) memory latencies, not one per load.
template <typename T, int D4, int DS4, int TILE, int NT, int G>
__device__ __forceinline__ void load_rows_vec(float4* __restrict__ dst,
                                              const T* __restrict__ rows,
                                              int cnt, int D, int tid) {
  using Chunks = TileChunks<T, D4, DS4, TILE, NT, G>;
  constexpr int ITERS = chunks_per_thread<T, D4, TILE, NT>();
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += G) {
    Chunks part;
    part.fetch(rows, cnt, D, tid + i0 * NT);
    part.store(dst, tid + i0 * NT);
  }
}

// Items [t0, t0 + cnt) into a shared f32 tile of TILE rows, D4 float4
// columns (zero-padded past D and past cnt) and a row stride of DS4 float4,
// plus their biases. Row-major items make the tile one contiguous stretch
// of device memory. With `vec` (D a multiple of 4 for f32 or of 8 for bf16,
// 16-byte aligned rows) every thread moves 16 bytes per load.
template <typename T, int D4, int DS4, int TILE, int NT, int G>
__device__ __forceinline__ void load_tile(float4* __restrict__ dst,
                                          float* __restrict__ tb,
                                          const T* __restrict__ items,
                                          const float* __restrict__ bias,
                                          int t0, int cnt, int D, bool vec,
                                          int tid) {
  const T* src = items + (size_t)t0 * D;
  if (vec) {
    load_rows_vec<T, D4, DS4, TILE, NT, G>(dst, src, cnt, D, tid);
  } else {
    float* df = reinterpret_cast<float*>(dst);
    for (int e = tid; e < TILE * 4 * D4; e += NT) {
      const int r = e / (4 * D4);
      const int c = e - r * (4 * D4);
      df[r * 4 * DS4 + c] =
          (r < cnt && c < D) ? to_f32(src[(size_t)r * D + c]) : 0.f;
    }
  }
  for (int e = tid; e < TILE; e += NT) {
    tb[e] = e < cnt ? bias[t0 + e] : 0.f;
  }
}

// f32 dot of a register user vector with one shared-memory item row: four
// independent FMA chains, so an FMA never waits on the previous one.
template <int D4>
__device__ __forceinline__ float dot_row(const float4 (&uv)[D4],
                                         const float4* row) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    const float4 w = row[c];
    a0 = fmaf(uv[c].x, w.x, a0);
    a1 = fmaf(uv[c].y, w.y, a1);
    a2 = fmaf(uv[c].z, w.z, a2);
    a3 = fmaf(uv[c].w, w.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// ---------------------------------------------------------------------------
// K1: dot_topk_small (k <= 16). Replaces _dot_topk_kernel,
// torchrecsys_tpu/ops/dot_topk.py:136-198 (called by dot_topk_pallas
// :202-306). Bound: see the file header (0.61 ms f32 at the main path).
//
// One thread per (user, split): the thread streams its split's items in
// index order and keeps a sorted top-16 in registers. A new score enters
// only if it beats the 16th value: its index is the largest seen so far,
// so an equal value loses the tie and the gate is a single compare. The
// thread's list IS the (user, split) partial top-16, so no block merge is
// needed; the split merge runs in dot_topk_merge_kernel. Splits are as long
// as one full wave of resident blocks allows (dot_topk_plan), because the
// insertion rate falls with the length of a thread's stream.
// ---------------------------------------------------------------------------

constexpr int kSmallThreads = 64;   // users per block
constexpr int kSmallTile = 64;      // items per shared-memory tile
constexpr int kSmallList = 16;      // entries kept per (user, split)

template <typename T, int D4>
__global__ void __launch_bounds__(kSmallThreads)
dot_topk_small_kernel(const T* __restrict__ users, const T* __restrict__ items,
                      const float* __restrict__ bias,
                      const int* __restrict__ mask, int mask_words, int U,
                      int N, int D, int split_len, int vec,
                      float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int K = kSmallList;
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  float* tbias = reinterpret_cast<float*>(smem4 + kSmallTile * D4);

  const int tid = threadIdx.x;
  const int u = blockIdx.x * kSmallThreads + tid;
  const int s = blockIdx.y;
  const bool active = u < U;
  const int g_begin = s * split_len;
  const int g_end = min(N, g_begin + split_len);

  float4 uv[D4];
  load_user<T, D4>(uv, users, u, U, D);
  const int* mrow =
      (mask != nullptr && active) ? mask + (size_t)u * mask_words : nullptr;

  float kv[K];
  int ki[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    kv[t] = sentinel_value();
    ki[t] = kIntMax;
  }

  for (int t0 = g_begin; t0 < g_end; t0 += kSmallTile) {
    const int cnt = min(kSmallTile, g_end - t0);
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D4, D4, kSmallTile, kSmallThreads, 4>(
        tile, tbias, items, bias, t0, cnt, D, vec != 0, tid);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const int g = t0 + j;
      float sc = dot_row<D4>(uv, tile + j * D4) + tbias[j];
      if (mrow != nullptr && is_masked(mrow, g)) sc = kNegInf;
      if (sc > kv[K - 1]) {
        // sorted insertion: carry the displaced entry down the list
        float cv = sc;
        int ci = g;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const float tv = kv[t];
          const int ti = ki[t];
          const bool take = better(cv, ci, tv, ti);
          kv[t] = take ? cv : tv;
          ki[t] = take ? ci : ti;
          cv = take ? tv : cv;
          ci = take ? ti : ci;
        }
      }
    }
  }
  if (active) {
    const size_t base = ((size_t)u * gridDim.y + s) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      part_v[base + t] = kv[t];
      part_i[base + t] = ki[t];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dot_topk_large (16 < k <= 1024). Replaces _dot_topk_threshold_kernel,
// torchrecsys_tpu/ops/dot_topk.py:362-441 (called by dot_topk_pallas_thresh
// :445-536). Bound: the same 0.61 ms of f32 FMAs at the main path.
//
// A block holds 8 warps and 8 * UPW users (UPW = 4 for k <= 128, else 1)
// and walks one split in 128-item shared tiles; the next tile's loads are
// in flight in registers while the current one is scored. Each warp
// computes a (UPW users x 128 items) score tile: lane l owns items l, l+32,
// l+64, l+96, the users' vectors are broadcast from shared memory, so every
// shared load feeds UPW*4 (or 4) FMAs, and the scores stay in registers.
//
// Selection keeps, per user, a candidate pool of `cap` entries (pool_cap:
// a power of two with room for at least 64 appends past k) in shared
// memory: the first k slots hold the running top-k, the rest is an append
// buffer. The threshold idea of :373-393: a score is appended only if it
// beats the pool's current k-th entry. One warp vote per tile finds the
// common case where no score does; otherwise one ballot per 32 scores
// appends (the warp owns its users' pools, so no block sync). When the
// buffer would overflow, the warp compacts the pool with a bitonic sort by
// (value desc, index asc), keeps the first k and raises the threshold to
// the new k-th entry. Expected appends over a split of n items are about
// k * (1 + ln(n / k)), so a few compactions per split. The list written out
// is fully sorted, so the wrapper needs no lexsort, and it is exact under
// ties at the k-th value too (stricter than the TPU kernel,
// whose strict `>` admits the first-seen tied candidates).
// ---------------------------------------------------------------------------

constexpr int kLargeWarps = 8;
constexpr int kLargeThreads = kLargeWarps * 32;
constexpr int kLargeTile = 128;                 // items per shared tile
constexpr int kLargeWideMaxK = 128;             // k up to which UPW = 4

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Bitonic sort of n (a power of two) entries into (value desc, index asc)
// order, by one warp. Not inlined: it runs a few times per split.
__device__ __noinline__ void warp_sort(float* v, int* id, int n, int lane) {
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < (n >> 1); q += 32) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int p = i + stride;
        const bool first_run = (i & size) == 0;
        const float vi = v[i], vp = v[p];
        const int ii = id[i], ip = id[p];
        if (better(vp, ip, vi, ii) == first_run) {
          v[i] = vp;
          v[p] = vi;
          id[i] = ip;
          id[p] = ii;
        }
      }
      __syncwarp();
    }
  }
}

// The same sort by a whole block.
__device__ void block_sort(float* v, int* id, int n) {
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int p = i + stride;
        const bool first_run = (i & size) == 0;
        const float vi = v[i], vp = v[p];
        const int ii = id[i], ip = id[p];
        if (better(vp, ip, vi, ii) == first_run) {
          v[i] = vp;
          v[p] = vi;
          id[i] = ip;
          id[p] = ii;
        }
      }
      __syncthreads();
    }
  }
}

template <int D4, int UPW>
struct LargeLayout {
  static constexpr int UB = kLargeWarps * UPW;  // users per block
  // odd float4 row stride: the 8 lanes of a 128-bit shared load phase hit
  // 8 distinct bank groups when they read 8 different item rows
  static constexpr int DS4 = D4 | 1;
  static size_t smem_bytes(int cap) {
    return (size_t)kLargeTile * DS4 * sizeof(float4) +
           (size_t)UB * D4 * sizeof(float4) + (size_t)kLargeTile * sizeof(float) +
           (size_t)UB * cap * (sizeof(float) + sizeof(int));
  }
};

template <typename T, int D4, int UPW>
__global__ void __launch_bounds__(kLargeThreads)
dot_topk_large_kernel(const T* __restrict__ users, const T* __restrict__ items,
                      const float* __restrict__ bias,
                      const int* __restrict__ mask, int mask_words, int U,
                      int N, int D, int split_len, int k, int cap, int vec,
                      float* __restrict__ part_v, int* __restrict__ part_i) {
  using L = LargeLayout<D4, UPW>;
  constexpr int DS4 = L::DS4;
  constexpr int UB = L::UB;
  constexpr int M = kLargeTile / 32;  // items per lane per tile
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  float4* ushared = tile + kLargeTile * DS4;
  float* tbias = reinterpret_cast<float*>(ushared + UB * D4);
  float* pool_v_all = tbias + kLargeTile;
  int* pool_i_all = reinterpret_cast<int*>(pool_v_all + UB * cap);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.y;
  const int u_base = blockIdx.x * UB + warp * UPW;  // this warp's users
  const int g_begin = s * split_len;
  const int g_end = min(N, g_begin + split_len);

  {  // the block's users into shared memory, zero-padded
    float* uf = reinterpret_cast<float*>(ushared);
    for (int e = tid; e < UB * 4 * D4; e += kLargeThreads) {
      const int r = e / (4 * D4);
      const int c = e - r * (4 * D4);
      const int u = blockIdx.x * UB + r;
      uf[e] = (u < U && c < D) ? to_f32(users[(size_t)u * D + c]) : 0.f;
    }
  }
  for (int i = tid; i < UB * cap; i += kLargeThreads) {
    pool_v_all[i] = sentinel_value();
    pool_i_all[i] = kIntMax;
  }

  // per-user selection state; warp-uniform
  float thr_v[UPW];
  int thr_i[UPW];
  int fill[UPW];
  const int* mrow[UPW];
#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {
    thr_v[uu] = sentinel_value();
    thr_i[uu] = kIntMax;
    fill[uu] = 0;
    const int u = u_base + uu;
    mrow[uu] = (mask != nullptr && u < U) ? mask + (size_t)u * mask_words : nullptr;
  }
  const unsigned lanes_below = (1u << lane) - 1u;

  // Software pipeline (vector path): the next tile's rows and biases wait
  // in registers while the current tile is scored, so their load latency
  // hides behind the FMAs instead of stalling the block at the barrier.
  using Chunks = TileChunks<T, D4, DS4, kLargeTile, kLargeThreads,
                            chunks_per_thread<T, D4, kLargeTile, kLargeThreads>()>;
  static_assert(kLargeThreads >= kLargeTile, "one bias per thread");
  Chunks next;
  float next_bias = 0.f;
  auto fetch = [&](int t1) {
    const int c1 = min(kLargeTile, g_end - t1);
    next.fetch(items + (size_t)t1 * D, c1, D, tid);
    next_bias = tid < c1 ? __ldg(bias + t1 + tid) : 0.f;
  };
  if (vec && g_begin < g_end) fetch(g_begin);

  for (int t0 = g_begin; t0 < g_end; t0 += kLargeTile) {
    const int cnt = min(kLargeTile, g_end - t0);
    __syncthreads();  // the previous tile is no longer read
    if (vec) {
      next.store(tile, tid);
      if (tid < kLargeTile) tbias[tid] = next_bias;
      if (t0 + kLargeTile < g_end) fetch(t0 + kLargeTile);
    } else {
      load_tile<T, D4, DS4, kLargeTile, kLargeThreads, 16>(
          tile, tbias, items, bias, t0, cnt, D, false, tid);
    }
    __syncthreads();
    if (u_base >= U) continue;  // warp-uniform

    float acc[UPW][M];
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[uu][m] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D4; ++c) {
      float4 it[M];
#pragma unroll
      for (int m = 0; m < M; ++m) it[m] = tile[(lane + 32 * m) * DS4 + c];
#pragma unroll
      for (int uu = 0; uu < UPW; ++uu) {
        const float4 w = ushared[(warp * UPW + uu) * D4 + c];  // broadcast
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[uu][m] = fmaf(w.x, it[m].x, acc[uu][m]);
          acc[uu][m] = fmaf(w.y, it[m].y, acc[uu][m]);
          acc[uu][m] = fmaf(w.z, it[m].z, acc[uu][m]);
          acc[uu][m] = fmaf(w.w, it[m].w, acc[uu][m]);
        }
      }
    }

    // scores, and one vote on whether any of them beats its user's
    // threshold: the common answer is no, and then the tile costs nothing
    // more
    bool any = false;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = lane + 32 * m;
      const float b = tbias[j];
#pragma unroll
      for (int uu = 0; uu < UPW; ++uu) {
        float sc = acc[uu][m] + b;
        if (j < cnt && mrow[uu] != nullptr && is_masked(mrow[uu], t0 + j)) sc = kNegInf;
        acc[uu][m] = sc;
        any |= j < cnt && u_base + uu < U && better(sc, t0 + j, thr_v[uu], thr_i[uu]);
      }
    }
    if (!__any_sync(0xffffffffu, any)) continue;

#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      if (u_base + uu >= U) break;  // warp-uniform
      float* pv = pool_v_all + (warp * UPW + uu) * cap;
      int* pi = pool_i_all + (warp * UPW + uu) * cap;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = lane + 32 * m;
        const int g = t0 + j;
        const bool valid = j < cnt;
        const float sc = acc[uu][m];
        bool admit = valid && better(sc, g, thr_v[uu], thr_i[uu]);
        unsigned ballot = __ballot_sync(0xffffffffu, admit);
        if (ballot == 0u) continue;
        if (fill[uu] + __popc(ballot) > cap) {
          warp_sort(pv, pi, cap, lane);
          for (int i = k + lane; i < cap; i += 32) {
            pv[i] = sentinel_value();
            pi[i] = kIntMax;
          }
          thr_v[uu] = pv[k - 1];
          thr_i[uu] = pi[k - 1];
          fill[uu] = k;
          __syncwarp();
          admit = valid && better(sc, g, thr_v[uu], thr_i[uu]);
          ballot = __ballot_sync(0xffffffffu, admit);
        }
        if (admit) {
          const int pos = fill[uu] + __popc(ballot & lanes_below);
          pv[pos] = sc;
          pi[pos] = g;
        }
        fill[uu] += __popc(ballot);
      }
    }
  }
#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {
    const int u = u_base + uu;
    if (u >= U) break;
    float* pv = pool_v_all + (warp * UPW + uu) * cap;
    int* pi = pool_i_all + (warp * UPW + uu) * cap;
    // entries past `fill` are sentinels: sorting the first next_pow2 of
    // max(fill, k) entries orders every real one
    warp_sort(pv, pi, next_pow2(max(fill[uu], k)), lane);
    const size_t base = ((size_t)u * gridDim.y + s) * k;
    for (int t = lane; t < k; t += 32) {
      part_v[base + t] = pv[t];
      part_i[base + t] = pi[t];
    }
  }
}

// ---------------------------------------------------------------------------
// Split merge, shared by K1 and K2: one block per user sorts that user's
// S sorted partial lists (C = S * list_len candidates, padded to n_pow2 with
// sentinels) in shared memory and writes the first k.
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 512;
constexpr int kMergeMaxCandidates = 16384;  // 128 KB of shared memory

__global__ void __launch_bounds__(kMergeThreads)
dot_topk_merge_kernel(const float* __restrict__ part_v,
                      const int* __restrict__ part_i, int C, int n_pow2, int k,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float msm[];
  float* v = msm;
  int* id = reinterpret_cast<int*>(msm + n_pow2);
  const size_t u = blockIdx.x;
  const float* src_v = part_v + u * C;
  const int* src_i = part_i + u * C;
  for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
    v[i] = i < C ? src_v[i] : sentinel_value();
    id[i] = i < C ? src_i[i] : kIntMax;
  }
  block_sort(v, id, n_pow2);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_v[u * k + t] = v[t];
    out_i[u * k + t] = id[t];
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

cudaError_t launch_merge(const float* part_v, const int* part_i, int U, int C,
                         int k, float* out_v, int* out_i, cudaStream_t stream) {
  if (C > kMergeMaxCandidates || k > C) return cudaErrorInvalidValue;
  const int n_pow2 = next_pow2(C < 2 ? 2 : C);
  const size_t smem = (size_t)n_pow2 * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      dot_topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dot_topk_merge_kernel<<<U, kMergeThreads, smem, stream>>>(
      part_v, part_i, C, n_pow2, k, out_v, out_i);
  return cudaGetLastError();
}

// Register tiles exist for D up to 32, 64, 80 and 128 (n_factors=80 is the
// reference default); vectors and tile rows are zero-padded to it.
int pick_d4(int D) {
  if (D <= 32) return 8;
  if (D <= 64) return 16;
  if (D <= 80) return 20;
  if (D <= 128) return 32;
  return 0;
}

// One launch geometry: the kernel function, its block and shared memory.
struct Geometry {
  const void* fn;
  int threads;
  int users_per_block;
  int tile;
  size_t smem;
};

template <typename T, int D4>
Geometry small_geometry() {
  return {reinterpret_cast<const void*>(dot_topk_small_kernel<T, D4>),
          kSmallThreads, kSmallThreads, kSmallTile,
          (size_t)kSmallTile * D4 * sizeof(float4) + kSmallTile * sizeof(float)};
}

template <typename T, int D4>
Geometry large_geometry(int k, int cap) {
  if (k <= kLargeWideMaxK)
    return {reinterpret_cast<const void*>(dot_topk_large_kernel<T, D4, 4>),
            kLargeThreads, LargeLayout<D4, 4>::UB, kLargeTile,
            LargeLayout<D4, 4>::smem_bytes(cap)};
  return {reinterpret_cast<const void*>(dot_topk_large_kernel<T, D4, 1>),
          kLargeThreads, LargeLayout<D4, 1>::UB, kLargeTile,
          LargeLayout<D4, 1>::smem_bytes(cap)};
}

template <typename T>
Geometry geometry(int large, int D, int k, int cap) {
  switch (pick_d4(D)) {
#define TRS_GEOM(D4V) \
  case D4V:          \
    return large ? large_geometry<T, D4V>(k, cap) : small_geometry<T, D4V>();
    TRS_GEOM(8)
    TRS_GEOM(16)
    TRS_GEOM(20)
    TRS_GEOM(32)
#undef TRS_GEOM
    default:
      return {nullptr, 0, 0, 0, 0};
  }
}

// Pool entries per user: a power of two with room to append at least 64
// candidates (one to two tiles' worth) after the k kept ones. Small k gets a
// small pool, so its compactions sort few entries; 32 users' pools of 512
// fit beside the tiles in shared memory.
int pool_cap(int k) {
  return next_pow2(k <= kLargeWideMaxK ? 2 * k + 64 : k + 512);
}

template <typename T, int D4>
cudaError_t small_t(const void* users, const void* items, const float* bias,
                    const int* mask, int mask_words, int U, int N, int D,
                    int vec, int S, float* part_v, int* part_i,
                    cudaStream_t stream) {
  const Geometry g = small_geometry<T, D4>();
  const dim3 grid(cdiv(U, g.users_per_block), S);
  dot_topk_small_kernel<T, D4><<<grid, g.threads, g.smem, stream>>>(
      static_cast<const T*>(users), static_cast<const T*>(items), bias, mask,
      mask_words, U, N, D, cdiv(N, S), vec, part_v, part_i);
  return cudaGetLastError();
}

template <typename T, int D4, int UPW>
cudaError_t large_t(const void* users, const void* items, const float* bias,
                    const int* mask, int mask_words, int U, int N, int D,
                    int vec, int k, int cap, int S, float* part_v, int* part_i,
                    cudaStream_t stream) {
  const size_t smem = LargeLayout<D4, UPW>::smem_bytes(cap);
  cudaError_t e = cudaFuncSetAttribute(
      dot_topk_large_kernel<T, D4, UPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(U, LargeLayout<D4, UPW>::UB), S);
  dot_topk_large_kernel<T, D4, UPW><<<grid, kLargeThreads, smem, stream>>>(
      static_cast<const T*>(users), static_cast<const T*>(items), bias, mask,
      mask_words, U, N, D, cdiv(N, S), k, cap, vec, part_v, part_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int large, const void* users, const void* items,
                   const float* bias, const int* mask, int mask_words, int U,
                   int N, int D, int vec, int k, int cap, int S,
                   float* part_v, int* part_i, cudaStream_t stream) {
#define TRS_CASE(D4V)                                                         \
  case D4V:                                                                   \
    if (!large)                                                               \
      return small_t<T, D4V>(users, items, bias, mask, mask_words, U, N, D,   \
                             vec, S, part_v, part_i, stream);                 \
    if (k <= kLargeWideMaxK)                                                  \
      return large_t<T, D4V, 4>(users, items, bias, mask, mask_words, U, N,   \
                                D, vec, k, cap, S, part_v, part_i, stream);   \
    return large_t<T, D4V, 1>(users, items, bias, mask, mask_words, U, N, D,  \
                              vec, k, cap, S, part_v, part_i, stream);
  switch (pick_d4(D)) {
    TRS_CASE(8)
    TRS_CASE(16)
    TRS_CASE(20)
    TRS_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef TRS_CASE
}

}  // namespace

extern "C" {

// Widest D with a register tile.
int trs_dot_topk_max_dim() { return 128; }

// Launch plan for (U, N, D, dtype, k): the number of catalog splits S, the
// per-(user, split) list length that the scratch must hold (the wrapper
// allocates U * S * list_len entries), for K2 the pool size, and the
// kernel's dynamic shared memory per block. S is as many splits as one wave
// of resident blocks holds: longer splits mean fewer insertions (K1) and
// fewer pool sorts (K2) per item. S * list_len stays within the merge's
// limit. Returns a cudaError_t.
int trs_dot_topk_plan(int large, int U, int N, int D, int bf16, int k,
                      int* S, int* list_len, int* cap, int* smem_bytes) {
  if (pick_d4(D) == 0 || U < 1 || N < 1 || k < 1 || k > N ||
      (!large && k > kSmallList) || (large && k > 1024))
    return cudaErrorInvalidValue;
  *cap = large ? pool_cap(k) : 0;
  *list_len = large ? k : kSmallList;
  const Geometry g = bf16 ? geometry<__nv_bfloat16>(large, D, k, *cap)
                          : geometry<float>(large, D, k, *cap);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(g.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)g.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, g.fn, g.threads,
                                                      g.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *smem_bytes = (int)g.smem;
  int s = sms * per_sm / cdiv(U, g.users_per_block);
  s = std::min(s, cdiv(N, g.tile));
  s = std::min(s, kMergeMaxCandidates / *list_len);
  s = std::max(s, 1);
  *S = cdiv(N, cdiv(N, s));  // no empty split
  return cudaSuccess;
}

// users (U, D), items (N, D): f32, or bf16 when bf16 != 0. bias (N,) f32.
// mask: (U, mask_words) int32 packed seen bits, or null. vec: rows may be
// read 16 bytes at a time (see load_tile). S, cap and the scratch part_*
// (U * S * list_len entries) as trs_dot_topk_plan gave them. out_*: (U, k).
// large = 0 launches K1 (k <= 16), 1 launches K2; then the split merge.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
int trs_dot_topk(int large, const void* users, const void* items,
                 const float* bias, const int* mask, int mask_words, int U,
                 int N, int D, int bf16, int vec, int k, int S, int cap,
                 float* part_v, int* part_i, float* out_v, int* out_i,
                 void* stream) {
  if (pick_d4(D) == 0 || U < 1 || N < 1 || k < 1 || k > N || S < 1 ||
      (!large && k > kSmallList) ||
      (large && (cap < k + 32 || (cap & (cap - 1)) != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(large, users, items, bias, mask, mask_words,
                                   U, N, D, vec, k, cap, S, part_v, part_i, st)
           : launch<float>(large, users, items, bias, mask, mask_words, U, N,
                           D, vec, k, cap, S, part_v, part_i, st);
  if (e != cudaSuccess) return e;
  return launch_merge(part_v, part_i, U, S * (large ? k : kSmallList), k,
                      out_v, out_i, st);
}

}  // extern "C"
