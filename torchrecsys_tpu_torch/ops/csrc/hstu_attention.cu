// HSTU's pointwise attention for Hopper (sm_90a), forward and backward,
// behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/hstu_attention.py, built by ops/_build.py).
//
// Replaces no TPU kernel: HSTU exists only in the port (models/hstu.py). For
// one history b and one head h, with q, k, v (L, dh) slices of the (B, L,
// H * dh) projections, w the block's relative-position weights and valid the
// (B, L) mask of real positions:
//
//   S[i][j] = q_i . k_j + w[j - i + L - 1]
//   M[i][j] = [j <= i] and valid[b][j]
//   A[i][j] = SiLU(S[i][j]) * inv_l * M[i][j]     (inv_l = f32(1 / L))
//   o_i     = sum_j A[i][j] v_j
//
// and, for a cotangent dO (B, L, H * dh),
//
//   dA = dO v^T,  dS = dA * inv_l * SiLU'(S) * M,  dv = A^T dO,
//   dq = dS k,    dk = dS^T q,  dw[j - i + L - 1] += dS[i][j] (over b, h).
//
// Only j <= i is ever unmasked, so only w[0 .. L-1] is read and dw past L - 1
// is 0. Every query row is computed, padding included, so o and dq match the
// plain version in every row; a row with no valid key gets 0.
//
// What bounds it. The plain chain writes and reads (B, h, L, L) f32 tensors
// five times forward and again in the backward (2.62 GB a pass at the HSTU
// cell's 8192 x 2 x 200 x 200). Here nothing (B, h, L, L) reaches device
// memory: a block stages one (b, h) problem whole in shared memory (q, k, v,
// and dO in the backward: 208 x 32 floats each at L = 200, dh = 25 padded
// with zeros) and forms S, A and dS on chip tile by tile. What is left is
// the products, at f32 accuracy: over the full square a block's forward and
// backward are 65.5 and 164 GFLOP (0.40 and 0.99 ms at the 3xTF32 rate)
// against 1.3 and 2.3 GB of q, k, v, dO and outputs (0.39 and 0.68 ms), so
// the kernels are bound by operations, less what the skipping below removes.
//
// Design.
// - Products: mma.sync m16n8k8 tf32 with f32 accumulators, as 3xTF32 (each
//   operand split into a TF32 big part and a TF32 remainder; a.b = a_big.b_big
//   + a_big.b_small + a_small.b_big, the small terms first): f32-accurate to
//   ~2^-22. The big part is rounded to nearest (cvt.rna), not truncated, so
//   that the remainder takes either sign: a truncated split errs the same
//   way in every product, and the error then grows with the sums over 200
//   keys. For the same reason every running sum is kept in f32 registers
//   and each 16-key block's products are added into it from a fresh
//   accumulator (the tensor cores add into an accumulator with truncation).
//   Both operands of every product are split, A and dS included, which are
//   formed on chip (a plain TF32 product is a different result).
//   mma.sync and not wgmma: wgmma takes 64-row tiles (L = 200 would pad to
//   256, and the causal skipping below would lose most of its gain at that
//   grain), its tf32 form reads only K-major shared operands (dv = A^T dO
//   and dk = dS^T q contract over rows), and an operand formed on chip would
//   have to go through shared memory; mma.sync's 16 x 8 fragments are loaded
//   by hand in either direction, and the accumulator fragment of S is the A
//   fragment of the next product once the 8 keys are taken in the order
//   (0, 2, 4, 6, 1, 3, 5, 7) (B's rows are loaded in that same order), so A
//   and dS never leave registers.
// - Tiles of 16 query rows against blocks of 16 keys (two 16 x 8 products
//   each, issued together so that a warp has 8 independent product chains
//   in flight). A (query tile, key block) pair is skipped when every pair in
//   it is masked: the block lies above the tile's diagonal, or it holds no
//   valid key for that history (staged: a 16-bit mask of blocks; streamed: a
//   ballot a block). At the
//   cell's windows (~131 valid keys of 200, left-aligned) about half the
//   square is left. A pair with no masked pair in it (most of them) skips
//   the per-pair mask and reads its weights at fixed offsets.
// - A block walks the B * H problems (grid: the occupancy times the SM
//   count, problems in turn). Forward: 8 warps, 3 staged operands, 2 blocks
//   an SM (at 128 registers); each warp takes query tiles in a snake order
//   over the tiles sorted by size. Backward: 12 warps (8 hid less latency,
//   16 spilled), 4 staged operands, 1 block an SM, in two kinds of
//   work unit taken in one snake order: a key tile of 16 (dk, dv: S^T and
//   dA^T recomputed from k, v against blocks of 16 queries) and a query tile
//   of 16 (dq and dw: S and dA recomputed against blocks of 16 keys). Each
//   unit owns its rows of dq, dk or dv outright, so no accumulation crosses
//   warps or blocks and no atomics are needed.
// - The heads sit at 4 * dh-byte offsets inside the (B, L, 4d) projection
//   output (100 bytes at dh = 25), so rows are read by their strides with
//   4-byte cp.async copies (all of a problem's in flight at once, coalesced
//   across a row, zero-filled past L and dh) and no contiguous copy is made.
// - dw: each query-tile unit writes its 16 x 16 block of dS to a scratch
//   tile, 31 lanes sum its diagonals (fixed order) and add them into the
//   warp's own compensated (Kahan) f32 sums in shared memory. At the end the block adds
//   its warps in order into one row of (blocks, L) partials, and a second
//   launch adds the rows column by column in a fixed order (as
//   layer_norm.cu's ln_colsum). No float atomics: two runs give the same
//   bits for o, dq, dk, dv and dw.
// - Two plans. The staged kernels above take a problem that fits shared
//   memory whole (L <= 256, dh <= 32; the benchmark's 200 x 25). Every other
//   shape the model builds (RecSys's one head of 80 at the default
//   n_factors, windows past 256) takes the streamed kernels: the same
//   tiles, products, skipping and elementwise steps, but one warp an item
//   (a query or key tile and up to 128 columns of the output), every
//   operand read by fragment from device memory (a head's rows stay in L1
//   across a block's items; staging each 16-row tile through shared memory
//   first took twice as long), S and dA taken over dh in chunks of 32 once
//   a block pair and multiplied into each 32 output columns, whose running
//   sums the warp keeps in shared memory (wider heads recompute S and dA
//   for each 128 columns), and each warp's dw sums in its own two rows of
//   device memory (the column sum then adds the warps' rows in order).
//   Neither plan accumulates across warps or blocks, so both repeat bit for
//   bit.
// - f32 or bf16 in and out (bf16 widened on staging); all arithmetic f32;
//   expf and the correctly rounded reciprocal, no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 256;           // a problem's rows: 16 key blocks of 16, one bit each
constexpr int kDp = 32;              // head width padded with zeros: 4 k steps of 8
constexpr int kS = 36;               // shared row stride (floats): fragment loads free of bank conflicts
constexpr int kWarps = 8;             // forward block
constexpr int kThreads = 32 * kWarps;
constexpr int kBwdWarps = 12;         // backward block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kScratch = 16 * 17;    // a warp's 16 x 16 dS block at row stride 17 (diagonals conflict-free)
constexpr int kSumWarps = 32;        // warps of a dw column-sum block
constexpr int kFwdBlocksPerSm = 2;
constexpr int kStreamWarps = 4;       // a streamed kernel's block
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kStreamBwdBlocksPerSm = 8;  // bounds the streamed backward's dw rows (2L floats a warp)
constexpr int kNoCap = 1 << 20;
constexpr int kGroup = 4;  // chunks of 32 columns a streamed item sums at once (128 columns)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The big part is x rounded to the nearest tf32; the small part is the
// remainder x - big, exact in f32, which the tensor cores read to its top 19
// bits (within 2^-23 of x, and either way, since the remainder of a rounding
// takes either sign).
__device__ __forceinline__ Split split(float x) {
  const uint32_t big = tf32_rna(x);
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// mma.sync m16n8k8 fragments, lane = 4 g + t: A holds (row g, k t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g), (k t + 4, n g); the
// accumulator holds (row g, n 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  Split v[4];
};
struct FragB {
  Split v[2];
};

// d[n] += a[n] . b[n] for the 4 pairs, 3xTF32, each pass over all 4 so
// that consecutive products on one accumulator are 4 instructions apart.
__device__ __forceinline__ void mma3_pairs(float (&d)[4][4], const FragA (&a)[4], const FragB (&b)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a[n].v[0].small, a[n].v[1].small, a[n].v[2].small, a[n].v[3].small, b[n].v[0].big, b[n].v[1].big);
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a[n].v[0].big, a[n].v[1].big, a[n].v[2].big, a[n].v[3].big, b[n].v[0].small, b[n].v[1].small);
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a[n].v[0].big, a[n].v[1].big, a[n].v[2].big, a[n].v[3].big, b[n].v[0].big, b[n].v[1].big);
}

// d[n] += a . b[n] for the 4 column groups of 8, 3xTF32.
__device__ __forceinline__ void mma3_cols(float (&d)[4][4], const FragA& a, const FragB (&b)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a.v[0].small, a.v[1].small, a.v[2].small, a.v[3].small, b[n].v[0].big, b[n].v[1].big);
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a.v[0].big, a.v[1].big, a.v[2].big, a.v[3].big, b[n].v[0].small, b[n].v[1].small);
#pragma unroll
  for (int n = 0; n < 4; ++n)
    mma_tf32(d[n], a.v[0].big, a.v[1].big, a.v[2].big, a.v[3].big, b[n].v[0].big, b[n].v[1].big);
}

// The A fragments of 16 staged rows (row 0 at ``rows``) over the 4 k steps.
__device__ __forceinline__ void load_rows_a(FragA (&fa)[4], const float* rows, int g, int t) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* r0 = rows + g * kS + s * 8 + t;
    const float* r1 = r0 + 8 * kS;
    fa[s] = {{split(r0[0]), split(r1[0]), split(r0[4]), split(r1[4])}};
  }
}

// The 16 x 8 tile of products between the 16 rows of ``fa`` and 8 staged
// rows (row 0 at ``rows``): the 8 rows are B's columns, their 32 values its
// k. Each k step keeps its own accumulator from zero (4 independent chains),
// added at the end with f32 adds.
__device__ __forceinline__ void tile_dots(float (&out)[4], const FragA (&fa)[4], const float* rows, int g, int t) {
  FragB fb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* r = rows + g * kS + s * 8 + t;
    fb[s] = {{split(r[0]), split(r[4])}};
  }
  float p[4][4] = {};
  mma3_pairs(p, fa, fb);
#pragma unroll
  for (int x = 0; x < 4; ++x) out[x] = (p[0][x] + p[1][x]) + (p[2][x] + p[3][x]);
}

// acc (16 x 32) += E (16 x 8, an accumulator fragment) . 8 staged rows (row 0
// at ``rows``; 32 columns). E's accumulator fragment is taken as an A
// fragment with k t standing for row 2t and k t + 4 for row 2t + 1, and B's
// rows are loaded in that order.
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][4], const float (&e)[4], const float* rows, int g,
                                                int t) {
  const FragA a = {{split(e[0]), split(e[2]), split(e[1]), split(e[3])}};
  const float* r0 = rows + 2 * t * kS + g;
  const float* r1 = r0 + kS;
  FragB fb[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) fb[n] = {{split(r0[n * 8]), split(r1[n * 8])}};
  mma3_cols(acc, a, fb);
}

// The 16 x 16 block E (two accumulator fragments: e0 for the first 8 of 16
// staged rows, e1 for the next 8) . those rows, from zero: a block's
// products are added into a running sum with f32 adds, since the tensor
// cores add into an accumulator with truncation, which errs towards zero in
// every step of a long running sum (relative error ~1e-6 after the 200 keys
// of a row), while a block's partial errs either way.
__device__ __forceinline__ void block_products(float (&p)[4][4], const float (&e0)[4], const float (&e1)[4],
                                               const float* rows, int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) p[n][x] = 0.f;
  tile_accumulate(p, e0, rows, g, t);
  tile_accumulate(p, e1, rows + 8 * kS, g, t);
}

// acc (16 x 32) += E . rows, in registers (the staged kernels).
__device__ __forceinline__ void block_accumulate(float (&acc)[4][4], const float (&e0)[4], const float (&e1)[4],
                                                 const float* rows, int g, int t) {
  float p[4][4];
  block_products(p, e0, e1, rows, g, t);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] += p[n][x];
}

// The streamed kernels' running sums: a warp's 16 x 32 tiles (one a chunk
// of 32 columns) in shared memory, fragment-major (element x of column group
// n of lane l at (n * 4 + x) * 32 + l), so each lane reads and writes only
// its own words.
constexpr int kTileFloats = 16 * 32;

__device__ __forceinline__ void add_to_shared(float* acc, const float (&p)[4][4], int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[(n * 4 + x) * 32 + lane] += p[n][x];
}

__device__ __forceinline__ void zero_shared_tiles(float* acc, int tiles, int lane) {
  for (int i = 0; i < tiles * 16; ++i) acc[i * 32 + lane] = 0.f;
}

__device__ __forceinline__ void load_shared_tile(float (&out)[4][4], const float* acc, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) out[n][x] = acc[(n * 4 + x) * 32 + lane];
}

// Writes a 16 x 32 accumulator tile (rows r0 .. r0 + 15, columns c0 .. c0 +
// 31 of the problem) to ``out`` (row stride ``ld_out``), rows below L and
// columns below dh.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, long long ld_out, const float (&acc)[4][4], int r0, int c0, int L,
                                           int dh, int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = r0 + g + ((x & 2) ? 8 : 0), col = c0 + n * 8 + 2 * t + (x & 1);
      if (row < L && col < dh) st(out + row * ld_out + col, acc[n][x]);
    }
}

__device__ __forceinline__ void zero_tile_rows(float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Stages rows 0 .. L - 1, columns 0 .. dh - 1 of one head (element (i, c) at
// src[i * row_stride + c]) as f32 rows of kS floats, zero past L (to Lp) and
// past dh (to kDp). f32: 4-byte cp.async copies, every one in flight (the
// caller waits with cp_async_wait_all); bf16: widened by the threads, four
// loads in flight each.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src, long long row_stride, int L,
                                      int Lp, int dh) {
  const int n = Lp * kDp;
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e >> 5, c = e & 31;
      const bool in = i < L && c < dh;
      cp_async4(dst + i * kS + c, in ? src + i * row_stride + c : src, in);
    }
  } else {
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x, i = e >> 5, c = e & 31;
        v[u] = (e < n && i < L && c < dh) ? ld(src + i * row_stride + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < n) dst[(e >> 5) * kS + (e & 31)] = v[u];
      }
    }
  }
}

__device__ __forceinline__ void stage_valid(unsigned char* valid, const unsigned char* mask, int L, int Lp) {
  for (int j = threadIdx.x; j < Lp; j += blockDim.x) valid[j] = (j < L && mask[j]) ? 1 : 0;
}

// Bit c of ``any``: key block c (keys 16c .. 16c + 15) holds a valid key;
// of ``full``: all 16 keys are valid (so the block lies below L).
__device__ __forceinline__ void block_bits(const unsigned char* valid, int Lp, int lane, uint32_t& any,
                                           uint32_t& full) {
  bool a = false, f = false;
  if (lane < (Lp >> 4)) {
    const uint4 x = *reinterpret_cast<const uint4*>(valid + 16 * lane);
    a = (x.x | x.y | x.z | x.w) != 0u;
    f = (x.x & x.y & x.z & x.w) == 0x01010101u;
  }
  any = __ballot_sync(0xffffffffu, a);
  full = __ballot_sync(0xffffffffu, f);
}

// The snake order: warp w of nw takes positions w, 2 nw - 1 - w, 2 nw + w,
// ... of a list sorted by size, so each warp gets big and small units alike.
template <int NW>
__device__ __forceinline__ int snake(int r, int warp) { return r * NW + ((r & 1) ? NW - 1 - warp : warp); }

// Whether pair (i, j) is unmasked: M[i][j] = [j <= i] and valid[j], for
// query rows below L (the padding rows of the last tile are not the
// problem's). A masked pair reads weight 0, so the read stays in range.
__device__ __forceinline__ bool unmasked(int i, int j, int L, const unsigned char* valid) {
  return i < L && j <= i && valid[j];
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* w;
  const unsigned char* mask;  // (B, L) bool
  const void* dout;
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* part;  // dw partials: a row of L a staged block, two a streamed warp
  long long sqb, sqi, skb, ski, svb, svi, sdb, sdi;  // batch and row strides of q, k, v, dO (elements)
  int B, H, L, dh;
  float inv_l;
};

__host__ __device__ __forceinline__ int padded(int L) { return (L + 15) & ~15; }

__host__ __device__ __forceinline__ size_t fwd_smem(int Lp) {
  return 3 * static_cast<size_t>(Lp) * kS * 4 + static_cast<size_t>(Lp) * 4 + Lp;
}

__host__ __device__ __forceinline__ size_t bwd_smem(int Lp) {
  return 4 * static_cast<size_t>(Lp) * kS * 4 + static_cast<size_t>(Lp) * 4 + Lp +
         2 * static_cast<size_t>(kBwdWarps) * Lp * 4 + static_cast<size_t>(kBwdWarps) * kScratch * 4 + 32 * 4;
}

// ---------------------------------------------------------------------------
// the elementwise steps, shared by the staged and the streamed kernels
// ---------------------------------------------------------------------------

// Bit l (l < 16) of the result: key j0 + l is below L and valid (the
// streamed kernels' per-block form of block_bits).
__device__ __forceinline__ uint32_t key_bits(const unsigned char* valid, int j0, int L, int lane) {
  return __ballot_sync(0xffffffffu, lane < 16 && j0 + lane < L && valid[j0 + lane]);
}

// The forward's elementwise step for an unmasked pair: A = SiLU(S + w) *
// inv_l, with SiLU(z) = z sigmoid(z) and sigmoid(z) = 1 / (1 + e^-z) (expf,
// and the correctly rounded reciprocal).
__device__ __forceinline__ float act_open(float s, float wv, float inv_l) {
  const float z = s + wv;
  const float sg = __frcp_rn(1.0f + expf(-z));
  return z * sg * inv_l;
}

// The same for any pair: 0 where masked (whose weight read is ws[0], in range).
template <typename W>
__device__ __forceinline__ float act(float s, int i, int j, int L, const unsigned char* valid, const W* ws,
                                     float inv_l) {
  const bool m = unmasked(i, j, L, valid);
  const float e = act_open(s, ld(ws + (m ? j - i + L - 1 : 0)), inv_l);
  return m ? e : 0.f;
}

// A (query tile i0, key block j0) pair of tiles is open when no pair in it is
// masked: every key valid (``full``), every key at or before every query (j0
// + 15 <= i0), every query row below L. Most computed blocks are; they skip
// the per-pair mask, and a lane reads its weights at fixed offsets.
__device__ __forceinline__ bool open_block(bool full, int i0, int j0, int L) {
  return full && j0 + 15 <= i0 && i0 + 15 < L;
}

// The forward's 16 x 16 block of A for query tile i0 and key block j0 from
// its dot products (s0, e0: keys j0 .. j0 + 7; s1, e1: the next 8).
template <typename W>
__device__ __forceinline__ void fwd_block(float (&e0)[4], float (&e1)[4], const float (&s0)[4], const float (&s1)[4],
                                          bool open, int i0, int j0, int L, const unsigned char* valid, const W* ws,
                                          float inv_l, int g, int t) {
  if (open) {
    const W* wd = ws + (j0 - i0 + L - 1) + 2 * t - g;  // w[j - i + L - 1] of element 0
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int off = (x & 1) - ((x & 2) ? 8 : 0);
      e0[x] = act_open(s0[x], ld(wd + off), inv_l);
      e1[x] = act_open(s1[x], ld(wd + off + 8), inv_l);
    }
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + g + ((x & 2) ? 8 : 0), j = j0 + 2 * t + (x & 1);
      e0[x] = act(s0[x], i, j, L, valid, ws, inv_l);
      e1[x] = act(s1[x], i, j + 8, L, valid, ws, inv_l);
    }
  }
}

// The backward's elementwise step for an unmasked pair: the activation e
// (for dv) and dS = dA * inv_l * SiLU'(z), SiLU'(z) = sigmoid(z) (1 + z (1 -
// sigmoid(z))), from S (the dot product), dA and the weight.
__device__ __forceinline__ void grad_open(float s, float da, float wv, float inv_l, float& e, float& ds) {
  const float z = s + wv;
  const float sg = __frcp_rn(1.0f + expf(-z));
  e = z * sg * inv_l;
  ds = (da * inv_l) * (sg * (1.0f + z * (1.0f - sg)));
}

// The same for any pair: 0 and 0 where masked.
template <typename W>
__device__ __forceinline__ void grad_pair(float s, float da, int i, int j, int L, const unsigned char* valid,
                                          const W* ws, float inv_l, float& e, float& ds) {
  const bool m = unmasked(i, j, L, valid);
  grad_open(s, da, ld(ws + (m ? j - i + L - 1 : 0)), inv_l, e, ds);
  if (!m) e = ds = 0.f;
}

// The backward's dS block for query tile i0 and key block j0 (ds0: keys j0
// .. j0 + 7, ds1: the next 8) from S and dA.
template <typename W>
__device__ __forceinline__ void dq_block(float (&ds0)[4], float (&ds1)[4], const float (&s0)[4],
                                         const float (&s1)[4], const float (&da0)[4], const float (&da1)[4],
                                         bool open, int i0, int j0, int L, const unsigned char* valid, const W* ws,
                                         float inv_l, int g, int t) {
  float e;
  if (open) {
    const W* wd = ws + (j0 - i0 + L - 1) + 2 * t - g;  // w[j - i + L - 1] of element 0
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int off = (x & 1) - ((x & 2) ? 8 : 0);
      grad_open(s0[x], da0[x], ld(wd + off), inv_l, e, ds0[x]);
      grad_open(s1[x], da1[x], ld(wd + off + 8), inv_l, e, ds1[x]);
    }
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + g + ((x & 2) ? 8 : 0), j = j0 + 2 * t + (x & 1);
      grad_pair(s0[x], da0[x], i, j, L, valid, ws, inv_l, e, ds0[x]);
      grad_pair(s1[x], da1[x], i, j + 8, L, valid, ws, inv_l, e, ds1[x]);
    }
  }
}

// The same transposed, for key tile j0 against query block i0 (S^T and dA^T
// in; e0, ds0: queries i0 .. i0 + 7, e1, ds1: the next 8), with A^T for dv.
template <typename W>
__device__ __forceinline__ void dkv_block(float (&e0)[4], float (&e1)[4], float (&ds0)[4], float (&ds1)[4],
                                          const float (&s0)[4], const float (&s1)[4], const float (&da0)[4],
                                          const float (&da1)[4], bool open, int i0, int j0, int L,
                                          const unsigned char* valid, const W* ws, float inv_l, int g, int t) {
  if (open) {
    const W* wd = ws + (j0 - i0 + L - 1) + g - 2 * t;  // w[j - i + L - 1] of element 0
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int off = ((x & 2) ? 8 : 0) - (x & 1);
      grad_open(s0[x], da0[x], ld(wd + off), inv_l, e0[x], ds0[x]);
      grad_open(s1[x], da1[x], ld(wd + off - 8), inv_l, e1[x], ds1[x]);
    }
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = j0 + g + ((x & 2) ? 8 : 0), i = i0 + 2 * t + (x & 1);
      grad_pair(s0[x], da0[x], i, j, L, valid, ws, inv_l, e0[x], ds0[x]);
      grad_pair(s1[x], da1[x], i + 8, j, L, valid, ws, inv_l, e1[x], ds1[x]);
    }
  }
}

// dw: the 16 x 16 dS block of query tile i0 and key block j0, written to the
// warp's scratch tile, is summed along its diagonals (key - query = j0 - i0
// + lane - 15), each in column order by one lane, into the warp's own
// compensated (Kahan) f32 sums ``sum`` and ``cmp`` (L each, in shared or
// device memory).
__device__ __forceinline__ void add_diagonals(float* scr, float* sum, float* cmp, const float (&ds0)[4],
                                              const float (&ds1)[4], int i0, int j0, int L, int lane, int g, int t) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = g + ((x & 2) ? 8 : 0), col = 2 * t + (x & 1);
    scr[row * 17 + col] = ds0[x];
    scr[row * 17 + col + 8] = ds1[x];
  }
  __syncwarp();
  if (lane < 31) {
    const int delta = lane - 15;
    const int d = j0 - i0 + delta + L - 1;
    if (d >= 0 && d < L) {
      float acc = 0.f;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int row = cc - delta;
        if (row >= 0 && row < 16) acc += scr[row * 17 + cc];
      }
      const float y = acc - cmp[d];
      const float tt = sum[d] + y;
      cmp[d] = (tt - sum[d]) - y;
      sum[d] = tt;
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the staged kernels (L <= 256, dh <= 32)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm) hstu_attn_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, Lp = padded(L), nqt = Lp >> 4, dh = a.dh;
  float* qs = sm;
  float* ks = qs + Lp * kS;
  float* vs = ks + Lp * kS;
  float* ws = vs + Lp * kS;
  unsigned char* valid = reinterpret_cast<unsigned char*>(ws + Lp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_l = a.inv_l;
  const long long ld_out = static_cast<long long>(a.H) * dh;
  for (int j = threadIdx.x; j < Lp; j += kThreads) ws[j] = j < L ? ld(static_cast<const T*>(a.w) + j) : 0.f;
  const long long problems = static_cast<long long>(a.B) * a.H;
  for (long long p = blockIdx.x; p < problems; p += gridDim.x) {
    const int b = static_cast<int>(p / a.H), h = static_cast<int>(p - static_cast<long long>(b) * a.H);
    __syncthreads();  // the last problem's readers are done
    stage(qs, static_cast<const T*>(a.q) + b * a.sqb + h * dh, a.sqi, L, Lp, dh);
    stage(ks, static_cast<const T*>(a.k) + b * a.skb + h * dh, a.ski, L, Lp, dh);
    stage(vs, static_cast<const T*>(a.v) + b * a.svb + h * dh, a.svi, L, Lp, dh);
    stage_valid(valid, a.mask + static_cast<long long>(b) * L, L, Lp);
    cp_async_wait_all();
    __syncthreads();
    uint32_t blocks16, full16;
    block_bits(valid, Lp, lane, blocks16, full16);
    T* o = static_cast<T*>(a.o) + static_cast<long long>(b) * L * ld_out + h * dh;
    for (int r = 0;; ++r) {
      const int pos = snake<kWarps>(r, warp);
      if (pos >= nqt) break;
      const int i0 = (nqt - 1 - pos) * 16;  // tiles by size: the last first
      FragA qa[4];
      load_rows_a(qa, qs + i0 * kS, g, t);
      float acc[4][4];
      zero_tile_rows(acc);
      const int last = min(i0 + 15, L - 1) >> 4;
      for (int c = 0; c <= last; ++c) {
        if (!((blocks16 >> c) & 1u)) continue;
        const int j0 = c * 16;
        float s0[4], s1[4], e0[4], e1[4];
        tile_dots(s0, qa, ks + j0 * kS, g, t);
        tile_dots(s1, qa, ks + (j0 + 8) * kS, g, t);
        fwd_block(e0, e1, s0, s1, open_block((full16 >> c) & 1u, i0, j0, L), i0, j0, L, valid, ws, inv_l, g, t);
        block_accumulate(acc, e0, e1, vs + j0 * kS, g, t);
      }
      store_tile(o, ld_out, acc, i0, 0, L, dh, g, t);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) hstu_attn_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, Lp = padded(L), nqt = Lp >> 4, dh = a.dh;
  float* qs = sm;
  float* ks = qs + Lp * kS;
  float* vs = ks + Lp * kS;
  float* os = vs + Lp * kS;  // dO
  float* ws = os + Lp * kS;
  unsigned char* valid = reinterpret_cast<unsigned char*>(ws + Lp);
  float* dw_sum = reinterpret_cast<float*>(valid + Lp);  // [kBwdWarps][Lp]
  float* dw_cmp = dw_sum + kBwdWarps * Lp;                 // [kBwdWarps][Lp]: Kahan compensations
  float* scratch = dw_cmp + kBwdWarps * Lp;                // [kBwdWarps][kScratch]
  int* order = reinterpret_cast<int*>(scratch + kBwdWarps * kScratch);  // 2 nqt units by size
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_l = a.inv_l;
  const long long ld_out = static_cast<long long>(a.H) * dh;
  for (int j = threadIdx.x; j < Lp; j += kBwdThreads) ws[j] = j < L ? ld(static_cast<const T*>(a.w) + j) : 0.f;
  for (int j = threadIdx.x; j < 2 * kBwdWarps * Lp; j += kBwdThreads) dw_sum[j] = 0.f;  // sums and compensations
  if (threadIdx.x == 0) {
    // Units: u < nqt the key tile u (dk, dv: nqt - u query blocks of 4
    // products each), u >= nqt the query tile u - nqt (dq, dw: up to u - nqt
    // + 1 key blocks of 3); sorted by that cost, largest first.
    const int units = 2 * nqt;
    for (int u = 0; u < units; ++u) {
      const int cost = u < nqt ? 4 * (nqt - u) : 3 * (u - nqt + 1);
      int x = u;
      while (x > 0) {
        const int prev = order[x - 1];
        const int pc = prev < nqt ? 4 * (nqt - prev) : 3 * (prev - nqt + 1);
        if (pc >= cost) break;
        order[x] = prev;
        --x;
      }
      order[x] = u;
    }
  }
  float* scr = scratch + warp * kScratch;
  float* my_sum = dw_sum + warp * Lp;
  float* my_cmp = dw_cmp + warp * Lp;
  const long long problems = static_cast<long long>(a.B) * a.H;
  for (long long p = blockIdx.x; p < problems; p += gridDim.x) {
    const int b = static_cast<int>(p / a.H), h = static_cast<int>(p - static_cast<long long>(b) * a.H);
    __syncthreads();
    stage(qs, static_cast<const T*>(a.q) + b * a.sqb + h * dh, a.sqi, L, Lp, dh);
    stage(ks, static_cast<const T*>(a.k) + b * a.skb + h * dh, a.ski, L, Lp, dh);
    stage(vs, static_cast<const T*>(a.v) + b * a.svb + h * dh, a.svi, L, Lp, dh);
    stage(os, static_cast<const T*>(a.dout) + b * a.sdb + h * dh, a.sdi, L, Lp, dh);
    stage_valid(valid, a.mask + static_cast<long long>(b) * L, L, Lp);
    cp_async_wait_all();
    __syncthreads();
    uint32_t blocks16, full16;
    block_bits(valid, Lp, lane, blocks16, full16);
    const long long base = static_cast<long long>(b) * L * ld_out + h * dh;
    for (int r = 0;; ++r) {
      const int pos = snake<kBwdWarps>(r, warp);
      if (pos >= 2 * nqt) break;
      const int u = order[pos];
      float acc0[4][4], acc1[4][4];
      zero_tile_rows(acc0);
      zero_tile_rows(acc1);
      if (u < nqt) {
        // key tile: dk (acc0) and dv (acc1) of keys j0 .. j0 + 15
        const int j0 = u * 16;
        if ((blocks16 >> u) & 1u) {
          FragA ka[4], va[4];
          load_rows_a(ka, ks + j0 * kS, g, t);
          load_rows_a(va, vs + j0 * kS, g, t);
          const int last = (L - 1) >> 4;
          for (int c = u; c <= last; ++c) {
            const int i0 = c * 16;
            float s0[4], s1[4], da0[4], da1[4], e0[4], e1[4], ds0[4], ds1[4];
            tile_dots(s0, ka, qs + i0 * kS, g, t);  // S^T: keys x queries
            tile_dots(s1, ka, qs + (i0 + 8) * kS, g, t);
            tile_dots(da0, va, os + i0 * kS, g, t);  // dA^T = v dO^T
            tile_dots(da1, va, os + (i0 + 8) * kS, g, t);
            dkv_block(e0, e1, ds0, ds1, s0, s1, da0, da1, open_block((full16 >> u) & 1u, i0, j0, L), i0, j0, L,
                      valid, ws, inv_l, g, t);
            block_accumulate(acc1, e0, e1, os + i0 * kS, g, t);  // dv += A^T dO
            block_accumulate(acc0, ds0, ds1, qs + i0 * kS, g, t);  // dk += dS^T q
          }
        }
        store_tile(static_cast<T*>(a.dk) + base, ld_out, acc0, j0, 0, L, dh, g, t);
        store_tile(static_cast<T*>(a.dv) + base, ld_out, acc1, j0, 0, L, dh, g, t);
      } else {
        // query tile: dq (acc0) of queries i0 .. i0 + 15, and dw
        const int i0 = (u - nqt) * 16;
        FragA qa[4], oa[4];
        load_rows_a(qa, qs + i0 * kS, g, t);
        load_rows_a(oa, os + i0 * kS, g, t);
        const int last = min(i0 + 15, L - 1) >> 4;
        for (int c = 0; c <= last; ++c) {
          if (!((blocks16 >> c) & 1u)) continue;
          const int j0 = c * 16;
          float s0[4], s1[4], da0[4], da1[4], ds0[4], ds1[4];
          tile_dots(s0, qa, ks + j0 * kS, g, t);  // S: queries x keys
          tile_dots(s1, qa, ks + (j0 + 8) * kS, g, t);
          tile_dots(da0, oa, vs + j0 * kS, g, t);  // dA = dO v^T
          tile_dots(da1, oa, vs + (j0 + 8) * kS, g, t);
          dq_block(ds0, ds1, s0, s1, da0, da1, open_block((full16 >> c) & 1u, i0, j0, L), i0, j0, L, valid, ws,
                   inv_l, g, t);
          block_accumulate(acc0, ds0, ds1, ks + j0 * kS, g, t);  // dq += dS k
          add_diagonals(scr, my_sum, my_cmp, ds0, ds1, i0, j0, L, lane, g, t);
        }
        store_tile(static_cast<T*>(a.dq) + base, ld_out, acc0, i0, 0, L, dh, g, t);
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < L; d += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += dw_sum[w * Lp + d] - dw_cmp[w * Lp + d];
    a.part[static_cast<long long>(blockIdx.x) * L + d] = s;
  }
}

// ---------------------------------------------------------------------------
// the streamed kernels (every other L and dh)
// ---------------------------------------------------------------------------

// One head's (L, dh) rows of a (B, L, H * dh) tensor in device memory, read
// by their stride, 0 past L and dh.
template <typename T>
struct Strided {
  const T* p;
  long long stride;
  int L, dh;
  __device__ __forceinline__ float operator()(int i, int c) const {
    return (i < L && c < dh) ? ld(p + i * stride + c) : 0.f;
  }
};

template <typename T>
__device__ __forceinline__ Strided<T> head(const void* base, long long batch_stride, long long row_stride, int b,
                                           int h, const Args& a) {
  return {static_cast<const T*>(base) + b * batch_stride + static_cast<long long>(h) * a.dh, row_stride, a.L, a.dh};
}

// The streamed kernels' fragment loads: load_rows_a, tile_dots and
// tile_accumulate reading a head's rows r0 .. in device memory, columns c0 ..
// c0 + 31 (each load through L1, 0 past L and dh).
template <typename T>
__device__ __forceinline__ void strided_rows_a(FragA (&fa)[4], const Strided<T>& rows, int r0, int c0, int g, int t) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = c0 + s * 8 + t;
    fa[s] = {{split(rows(r0 + g, c)), split(rows(r0 + g + 8, c)), split(rows(r0 + g, c + 4)),
              split(rows(r0 + g + 8, c + 4))}};
  }
}

template <typename T>
__device__ __forceinline__ void strided_dots(float (&out)[4], const FragA (&fa)[4], const Strided<T>& rows, int r0,
                                             int c0, int g, int t) {
  FragB fb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = c0 + s * 8 + t;
    fb[s] = {{split(rows(r0 + g, c)), split(rows(r0 + g, c + 4))}};
  }
  float p[4][4] = {};
  mma3_pairs(p, fa, fb);
#pragma unroll
  for (int x = 0; x < 4; ++x) out[x] = (p[0][x] + p[1][x]) + (p[2][x] + p[3][x]);
}

// block_products of rows r0 .. r0 + 15 of ``rows``.
template <typename T>
__device__ __forceinline__ void strided_products(float (&p)[4][4], const float (&e0)[4], const float (&e1)[4],
                                                 const Strided<T>& rows, int r0, int c0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) p[n][x] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float(&e)[4] = half ? e1 : e0;
    const int r = r0 + 8 * half + 2 * t;
    const FragA fa = {{split(e[0]), split(e[2]), split(e[1]), split(e[3])}};
    FragB fb[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) fb[n] = {{split(rows(r, c0 + n * 8 + g)), split(rows(r + 1, c0 + n * 8 + g))}};
    mma3_cols(p, fa, fb);
  }
}

// The two 16 x 8 tiles of dot products over every column between rows a0 ..
// a0 + 15 of ``a`` and rows b0 .. b0 + 7 (d0) and b0 + 8 .. b0 + 15 (d1) of
// ``b``: chunks of 32 columns, each chunk's products from fresh accumulators
// added in f32.
template <typename T>
__device__ __forceinline__ void block_dots(float (&d0)[4], float (&d1)[4], const Strided<T>& a, int a0,
                                           const Strided<T>& b, int b0, int nc, int g, int t) {
#pragma unroll
  for (int x = 0; x < 4; ++x) d0[x] = d1[x] = 0.f;
  for (int ch = 0; ch < nc; ++ch) {
    FragA fa[4];
    strided_rows_a(fa, a, a0, ch * kDp, g, t);
    float p0[4], p1[4];
    strided_dots(p0, fa, b, b0, ch * kDp, g, t);
    strided_dots(p1, fa, b, b0 + 8, ch * kDp, g, t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      d0[x] += p0[x];
      d1[x] += p1[x];
    }
  }
}

// acc (a warp's shared tile) += E . rows r0 .. r0 + 15, columns c0 .. c0 + 31.
template <typename T>
__device__ __forceinline__ void accumulate_rows(float* acc, const float (&e0)[4], const float (&e1)[4],
                                                const Strided<T>& rows, int r0, int c0, int lane, int g, int t) {
  float p[4][4];
  strided_products(p, e0, e1, rows, r0, c0, g, t);
  add_to_shared(acc, p, lane);
}

// A streamed warp's shared memory (floats): the group's accumulator tiles
// (``sets`` of them, gmax each) and, backward, the dS scratch tile.
__host__ __device__ __forceinline__ int streamed_warp_floats(int gmax, int sets, bool scratch) {
  return sets * gmax * kTileFloats + (scratch ? kScratch : 0);
}

// Forward: one warp an item (history, head, query tile of 16, a group of up
// to kGroup chunks of 32 columns of o), items in turn over every warp of the
// grid. q, k, v and w are read by fragment from device memory (a head's
// rows stay in L1 across the items of one block); S over every column is
// formed once a key block and multiplied into each chunk of the group, whose
// running sums the warp keeps in shared memory.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads) hstu_attn_fwd_streamed(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, nqt = padded(L) >> 4, dh = a.dh, nc = (dh + kDp - 1) / kDp;
  const int groups = (nc + kGroup - 1) / kGroup, gmax = nc < kGroup ? nc : kGroup;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* acc = sm + warp * streamed_warp_floats(gmax, 1, false);
  const float inv_l = a.inv_l;
  const long long ld_out = static_cast<long long>(a.H) * dh;
  const T* ws = static_cast<const T*>(a.w);
  const long long items = static_cast<long long>(a.B) * a.H * nqt * groups;
  for (long long it = static_cast<long long>(blockIdx.x) * kStreamWarps + warp; it < items;
       it += static_cast<long long>(gridDim.x) * kStreamWarps) {
    const int ch0 = static_cast<int>(it % groups) * kGroup, gn = nc - ch0 < kGroup ? nc - ch0 : kGroup;
    const long long pt = it / groups;
    const int i0 = static_cast<int>(pt % nqt) * 16;
    const long long p = pt / nqt;
    const int b = static_cast<int>(p / a.H), h = static_cast<int>(p % a.H);
    const Strided<T> q = head<T>(a.q, a.sqb, a.sqi, b, h, a), k = head<T>(a.k, a.skb, a.ski, b, h, a),
                     v = head<T>(a.v, a.svb, a.svi, b, h, a);
    const unsigned char* valid = a.mask + static_cast<long long>(b) * L;
    zero_shared_tiles(acc, gn, lane);
    const int last = min(i0 + 15, L - 1) >> 4;
    for (int c = 0; c <= last; ++c) {
      const int j0 = c * 16;
      const uint32_t keys = key_bits(valid, j0, L, lane);
      if (!keys) continue;
      float s0[4], s1[4], e0[4], e1[4];
      block_dots(s0, s1, q, i0, k, j0, nc, g, t);
      fwd_block(e0, e1, s0, s1, open_block(keys == 0xffffu, i0, j0, L), i0, j0, L, valid, ws, inv_l, g, t);
      for (int ch = 0; ch < gn; ++ch)
        accumulate_rows(acc + ch * kTileFloats, e0, e1, v, j0, (ch0 + ch) * kDp, lane, g, t);
    }
    T* o = static_cast<T*>(a.o) + static_cast<long long>(b) * L * ld_out + h * dh;
    for (int ch = 0; ch < gn; ++ch) {
      float tile[4][4];
      load_shared_tile(tile, acc + ch * kTileFloats, lane);
      store_tile(o, ld_out, tile, i0, (ch0 + ch) * kDp, L, dh, g, t);
    }
  }
}

// Backward: one warp an item (history, head, unit, a group of up to kGroup
// chunks of 32 columns), the units as the staged kernel's (a key tile: dk,
// dv; a query tile: dq, and dw from the items of the first group), operands
// read as the forward's. S and dA over every column are formed once a
// block and multiplied into each chunk of the group, whose running sums the
// warp keeps in shared memory. Each warp keeps its dw sums and
// compensations in its own two rows of ``part`` (2L floats), and leaves the
// compensated sum in the first.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads) hstu_attn_bwd_streamed(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, nqt = padded(L) >> 4, dh = a.dh, nc = (dh + kDp - 1) / kDp;
  const int groups = (nc + kGroup - 1) / kGroup, gmax = nc < kGroup ? nc : kGroup;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* acc0 = sm + warp * streamed_warp_floats(gmax, 2, true);  // dk or dq
  float* acc1 = acc0 + gmax * kTileFloats;  // dv
  float* scr = acc1 + gmax * kTileFloats;
  const float inv_l = a.inv_l;
  const long long ld_out = static_cast<long long>(a.H) * dh;
  const T* ws = static_cast<const T*>(a.w);
  const long long gw = static_cast<long long>(blockIdx.x) * kStreamWarps + warp;
  const long long nw = static_cast<long long>(gridDim.x) * kStreamWarps;
  float* my_sum = a.part + gw * 2 * L;
  float* my_cmp = my_sum + L;
  for (int d = lane; d < 2 * L; d += 32) my_sum[d] = 0.f;
  __syncwarp();
  const long long items = static_cast<long long>(a.B) * a.H * 2 * nqt * groups;
  for (long long it = gw; it < items; it += nw) {
    const int ch0 = static_cast<int>(it % groups) * kGroup, gn = nc - ch0 < kGroup ? nc - ch0 : kGroup;
    const long long pu = it / groups;
    const int u = static_cast<int>(pu % (2 * nqt));
    const long long p = pu / (2 * nqt);
    const int b = static_cast<int>(p / a.H), h = static_cast<int>(p % a.H);
    const Strided<T> q = head<T>(a.q, a.sqb, a.sqi, b, h, a), k = head<T>(a.k, a.skb, a.ski, b, h, a),
                     v = head<T>(a.v, a.svb, a.svi, b, h, a), dout = head<T>(a.dout, a.sdb, a.sdi, b, h, a);
    const unsigned char* valid = a.mask + static_cast<long long>(b) * L;
    const long long base = static_cast<long long>(b) * L * ld_out + h * dh;
    zero_shared_tiles(acc0, 2 * gmax, lane);
    if (u < nqt) {
      // key tile: dk (acc0) and dv (acc1) of keys j0 .. j0 + 15
      const int j0 = u * 16;
      const uint32_t keys = key_bits(valid, j0, L, lane);
      if (keys) {
        const int last = (L - 1) >> 4;
        for (int c = u; c <= last; ++c) {
          const int i0 = c * 16;
          float s0[4], s1[4], da0[4], da1[4], e0[4], e1[4], ds0[4], ds1[4];
          block_dots(s0, s1, k, j0, q, i0, nc, g, t);      // S^T
          block_dots(da0, da1, v, j0, dout, i0, nc, g, t);  // dA^T
          dkv_block(e0, e1, ds0, ds1, s0, s1, da0, da1, open_block(keys == 0xffffu, i0, j0, L), i0, j0, L, valid,
                    ws, inv_l, g, t);
          for (int ch = 0; ch < gn; ++ch) {
            const int c0 = (ch0 + ch) * kDp;
            accumulate_rows(acc1 + ch * kTileFloats, e0, e1, dout, i0, c0, lane, g, t);  // dv += A^T dO
            accumulate_rows(acc0 + ch * kTileFloats, ds0, ds1, q, i0, c0, lane, g, t);   // dk += dS^T q
          }
        }
      }
      for (int ch = 0; ch < gn; ++ch) {
        float tile[4][4];
        load_shared_tile(tile, acc0 + ch * kTileFloats, lane);
        store_tile(static_cast<T*>(a.dk) + base, ld_out, tile, j0, (ch0 + ch) * kDp, L, dh, g, t);
        load_shared_tile(tile, acc1 + ch * kTileFloats, lane);
        store_tile(static_cast<T*>(a.dv) + base, ld_out, tile, j0, (ch0 + ch) * kDp, L, dh, g, t);
      }
    } else {
      // query tile: dq (acc0) of queries i0 .. i0 + 15, and dw
      const int i0 = (u - nqt) * 16;
      const int last = min(i0 + 15, L - 1) >> 4;
      for (int c = 0; c <= last; ++c) {
        const int j0 = c * 16;
        const uint32_t keys = key_bits(valid, j0, L, lane);
        if (!keys) continue;
        float s0[4], s1[4], da0[4], da1[4], ds0[4], ds1[4];
        block_dots(s0, s1, q, i0, k, j0, nc, g, t);      // S
        block_dots(da0, da1, dout, i0, v, j0, nc, g, t);  // dA
        dq_block(ds0, ds1, s0, s1, da0, da1, open_block(keys == 0xffffu, i0, j0, L), i0, j0, L, valid, ws, inv_l,
                 g, t);
        for (int ch = 0; ch < gn; ++ch)
          accumulate_rows(acc0 + ch * kTileFloats, ds0, ds1, k, j0, (ch0 + ch) * kDp, lane, g, t);  // dq
        if (ch0 == 0) add_diagonals(scr, my_sum, my_cmp, ds0, ds1, i0, j0, L, lane, g, t);
      }
      for (int ch = 0; ch < gn; ++ch) {
        float tile[4][4];
        load_shared_tile(tile, acc0 + ch * kTileFloats, lane);
        store_tile(static_cast<T*>(a.dq) + base, ld_out, tile, i0, (ch0 + ch) * kDp, L, dh, g, t);
      }
    }
  }
  __syncwarp();
  for (int d = lane; d < L; d += 32) my_sum[d] -= my_cmp[d];
}

// Kahan's compensated sum in f32: c carries what the last add lost.
struct Sum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
  __device__ __forceinline__ float value() const { return s - c; }
};

// dw[col] for col < n_w: the sum over ``parts`` rows of dw partials (row p
// at part + p * row_stride, L floats) for col < L (warp w adds rows w, w +
// 32, ..., compensated; then the 32 warps as a tree), 0 for L <= col < n_w.
// Block x: columns 32x ...
template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps) hstu_dw_sum_kernel(const float* __restrict__ part, int parts,
                                                                     long long row_stride, int L, int n_w,
                                                                     T* __restrict__ dw) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  Sum acc;
  if (col < L)
    for (int p = warp; p < parts; p += kSumWarps) acc.add(part[p * row_stride + col]);
  red[warp][lane] = acc.value();
  __syncthreads();
  for (int hh = kSumWarps / 2; hh > 0; hh >>= 1) {
    if (warp < hh) red[warp][lane] += red[warp + hh][lane];
    __syncthreads();
  }
  if (warp == 0 && col < n_w) st(dw + col, col < L ? red[0][lane] : 0.f);
}

// ---------------------------------------------------------------------------
// launch plans
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  return sms;
}

// Whether a problem fits the staged kernels: a whole (b, h) problem in
// shared memory, its key blocks in one 16-bit mask.
bool staged(int L, int dh) { return L <= kMaxL && dh <= kDp; }

// Blocks of a launch: as many as the card holds at once (the kernel's
// occupancy at ``smem`` bytes of dynamic shared memory, at most ``per_sm_cap``
// an SM, times the SM count), and no more than ``work`` (at least 1). The
// shared-memory attribute is set on every call, on the current device. -1 if
// the kernel cannot be given its shared memory.
int blocks(const void* fn, int threads, size_t smem, long long work, int per_sm_cap) {
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem) != cudaSuccess || per_sm < 1)
    return -1;
  const long long cap = static_cast<long long>(sm_count()) * (per_sm < per_sm_cap ? per_sm : per_sm_cap);
  const long long g = work < cap ? work : cap;
  return g < 1 ? 1 : static_cast<int>(g);
}

// A streamed item's groups of chunks, and the dynamic shared memory of a
// streamed block (streamed_warp_floats a warp).
long long groups(int dh) { return ((dh + kDp - 1) / kDp + kGroup - 1) / kGroup; }

size_t streamed_smem(int dh, bool bwd) {
  const int nc = (dh + kDp - 1) / kDp, gmax = nc < kGroup ? nc : kGroup;
  return static_cast<size_t>(kStreamWarps) * streamed_warp_floats(gmax, bwd ? 2 : 1, bwd) * 4;
}

// The backward's plan: the grid, the rows of dw partials (L floats each) it
// writes, and the stride between the rows the column sum adds (a row a
// block for the staged kernel; two rows a warp for the streamed one, the
// sums in the first).
struct BwdPlan {
  int grid, rows, sum_rows;
  long long row_stride;
};

template <typename T>
BwdPlan bwd_plan(int B, int H, int L, int dh) {
  const long long problems = static_cast<long long>(B) * H;
  if (staged(L, dh)) {
    const int g = blocks(reinterpret_cast<const void*>(&hstu_attn_bwd_kernel<T>), kBwdThreads, bwd_smem(padded(L)),
                         problems, kNoCap);
    return {g, g, g, L};
  }
  const long long items = problems * 2 * (padded(L) >> 4) * groups(dh);
  const int g = blocks(reinterpret_cast<const void*>(&hstu_attn_bwd_streamed<T>), kStreamThreads,
                       streamed_smem(dh, true), (items + kStreamWarps - 1) / kStreamWarps, kStreamBwdBlocksPerSm);
  return {g, g < 0 ? -1 : 2 * kStreamWarps * g, kStreamWarps * g, 2LL * L};
}

bool bad_shape(int B, int H, int L, int dh) { return B < 0 || H < 1 || L < 1 || dh < 1; }

template <typename T>
int fwd(const Args& a, cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  const long long problems = static_cast<long long>(a.B) * a.H;
  if (staged(a.L, a.dh)) {
    const size_t smem = fwd_smem(padded(a.L));
    const int g = blocks(reinterpret_cast<const void*>(&hstu_attn_fwd_kernel<T>), kThreads, smem, problems, kNoCap);
    if (g < 0) return cudaErrorInvalidConfiguration;
    hstu_attn_fwd_kernel<T><<<g, kThreads, smem, stream>>>(a);
  } else {
    const long long items = problems * (padded(a.L) >> 4) * groups(a.dh);
    const size_t smem = streamed_smem(a.dh, false);
    const int g = blocks(reinterpret_cast<const void*>(&hstu_attn_fwd_streamed<T>), kStreamThreads, smem,
                         (items + kStreamWarps - 1) / kStreamWarps, kNoCap);
    if (g < 0) return cudaErrorInvalidConfiguration;
    hstu_attn_fwd_streamed<T><<<g, kStreamThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Args& a, int parts, int n_w, T* dw, cudaStream_t stream) {
  const BwdPlan pl = bwd_plan<T>(a.B, a.H, a.L, a.dh);
  if (pl.grid < 0 || pl.rows != parts) return cudaErrorInvalidValue;
  if (a.B > 0) {
    if (staged(a.L, a.dh))
      hstu_attn_bwd_kernel<T><<<pl.grid, kBwdThreads, bwd_smem(padded(a.L)), stream>>>(a);
    else
      hstu_attn_bwd_streamed<T><<<pl.grid, kStreamThreads, streamed_smem(a.dh, true), stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hstu_dw_sum_kernel<T><<<(n_w + 31) / 32, 32 * kSumWarps, 0, stream>>>(a.part, a.B > 0 ? pl.sum_rows : 0,
                                                                        pl.row_stride, a.L, n_w, dw);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* w, const unsigned char* mask,
               const long long* strides, int B, int H, int L, int dh, float inv_l) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.w = w;
  a.mask = mask;
  a.sqb = strides[0];
  a.sqi = strides[1];
  a.skb = strides[2];
  a.ski = strides[3];
  a.svb = strides[4];
  a.svi = strides[5];
  a.sdb = strides[6];
  a.sdi = strides[7];
  a.B = B;
  a.H = H;
  a.L = L;
  a.dh = dh;
  a.inv_l = inv_l;
  return a;
}

}  // namespace

extern "C" {

// Rows of dw partials (each of L floats) the backward writes for B x H
// problems of L rows and width dh: its scratch. -1 on a bad shape or when
// the kernel cannot be given its shared memory.
int trs_hstu_attention_parts(int B, int H, int L, int dh, int is_bf16) {
  if (bad_shape(B, H, L, dh)) return -1;
  return is_bf16 ? bwd_plan<bf16>(B, H, L, dh).rows : bwd_plan<float>(B, H, L, dh).rows;
}

// Forward on ``stream``: o (B, L, H * dh), contiguous, from q, k, v (B, L, H *
// dh) read by their batch and row strides (strides[0..5]: q, k, v; the last
// dim contiguous), w (at least 2L - 1; w[0 .. L-1] read) and mask (B, L)
// bool, contiguous. f32, or bf16 where is_bf16 (q, k, v, w, o alike).
// inv_l: f32(1 / L). Returns a cudaError_t (cudaGetLastError after the launch).
int trs_hstu_attention_fwd(const void* q, const void* k, const void* v, const void* w, const unsigned char* mask,
                           void* o, const long long* strides, int B, int H, int L, int dh, float inv_l, int is_bf16,
                           cudaStream_t stream) {
  if (bad_shape(B, H, L, dh)) return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, w, mask, strides, B, H, L, dh, inv_l);
  a.o = o;
  return is_bf16 ? fwd<bf16>(a, stream) : fwd<float>(a, stream);
}

// Backward on ``stream``: dq, dk, dv (B, L, H * dh), contiguous, and dw (n_w,)
// from the forward's inputs and dout (B, L, H * dh) read by its strides
// (strides[6..7]). part: trs_hstu_attention_parts(...) x L floats of scratch.
// Two launches (the problems, then dw's column sums). Returns a cudaError_t.
int trs_hstu_attention_bwd(const void* q, const void* k, const void* v, const void* w, const unsigned char* mask,
                           const void* dout, void* dq, void* dk, void* dv, float* part, void* dw, int parts, int n_w,
                           const long long* strides, int B, int H, int L, int dh, float inv_l, int is_bf16,
                           cudaStream_t stream) {
  if (bad_shape(B, H, L, dh) || n_w < 2 * L - 1) return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, w, mask, strides, B, H, L, dh, inv_l);
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.part = part;
  return is_bf16 ? bwd<bf16>(a, parts, n_w, static_cast<bf16*>(dw), stream)
                 : bwd<float>(a, parts, n_w, static_cast<float*>(dw), stream);
}

}  // extern "C"
