// In-batch sampled-softmax cross-entropy for Hopper (sm_90a), forward and
// backward, behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/softmax_ce.py, built by ops/_build.py).
//
// Replaces torchrecsys_tpu/ops/softmax_ce.py::_fwd_kernel (:67) and
// ::_bwd_kernel (:92). For a batch of B rows -- user-side vectors h (B, D),
// item-side vectors v (B, D), column biases vbq = item bias - logQ(pos)
// (B,), positive ids pos (B,) --
//     s[r][c] = h[r] . v[c] + vbq[c], dropped where pos[c] == pos[r], c != r
//     lse[r]  = log sum_c exp(s[r][c]),   loss[r] = lse[r] - s[r][r]
// and, for a per-row cotangent g (B,), with dlog[r][c] = g[r] * (softmax
// - onehot)[r][c] (a dropped logit has probability exactly 0):
//     dh = dlog . v,  dv = dlog^T . h,  dvb = column sums of dlog.
// The diagonal is never dropped, so every row has a finite LSE. Any
// B >= 1 and 1 <= D <= 128 are taken as they are: tiles are zero-filled
// past B and past D, and the ragged edges are masked.
//
// Forward. The TPU kernel holds a (TR, B) logit row block in VMEM and takes
// the row max, then the sum. A 64-row block over B = 4096 columns would
// need 1 MB here, so the forward streams 64-column tiles and keeps a running
// (max, sum) per row and thread, flash-style; the 16 threads that share a
// row merge theirs at the end (a few f32 ulps of the LSE from the two-pass
// form). Each (row tile, column range) block writes a partial that a small
// launch merges in a fixed order. 4 x 4 f32 register tiles on the CUDA
// cores, fed by float4 reads of k-major shared copies of h and v.
//
// Backward. Like the TPU kernel (which forms s, p and dlog once per row
// tile and feeds dh and dv from it), it computes every logit once and
// feeds both products from it: 6.B^2.D operations. What bounds it on this
// card is the products at f32 accuracy. The parity contract keeps f32
// products (a plain TF32 or bf16 product misses the check's rtol 1e-4),
// and the CUDA cores give 67 TFLOP/s of f32 FMA. So the three products
// run on the tensor cores as 3xTF32: each operand is split into a TF32
// big part (its top 19 bits) and a TF32 remainder, and a.b = a_big.b_big +
// a_big.b_small + a_small.b_big, the small terms accumulated first
// (mma.sync m16n8k8 tf32, f32 accumulators). That keeps ~22 bits of each
// operand at a third of the 495 TFLOP/s TF32 rate. bf16x6 is as accurate
// and as fast but needs twice the products and the splits; bf16x3 keeps
// ~16 bits and would miss the check.
// - Layout: a block owns a 128-column group (v staged once) and a range of
//   64-row tiles (h and the rows' lse, g, pos staged by cp.async one tile
//   ahead). Per (row tile, column tile): S = h.v^T, P = dlog into shared
//   memory, dvb += column sums of P; then 8 warps run dh += P.v (registers)
//   while the other 8 run dv += P^T.h (shared accumulators that live for
//   the whole row range). 16 warps at <= 128 registers, the accumulators'
//   width a template argument, hide more latency than 8 with twice the
//   tile. mma.sync rather than wgmma: dv contracts over rows, and wgmma's
//   tf32 form takes only K-major shared operands, while mma.sync's
//   fragments are loaded by hand in either direction; a row-XOR swizzle
//   keeps both directions free of bank conflicts.
// - Blocks run in no order, so dh leaves each block as a partial over its
//   column group and dv, dvb as partials over its row range; one launch
//   adds the slabs in slab order. No atomics: repeated runs give the same
//   bits.
// - A D that is not a multiple of 4 (or an unaligned row) has no 16-byte
//   copies; those tiles are staged by plain loads into the same layout.
//
// Bound at the main path's B = 4096, D = 80. Forward: 2.B^2.D = 2.68 GFLOP.
// Backward: 6.B^2.D = 8.05 GFLOP of f32 products, 24.2 GFLOP of TF32 as
// 3xTF32, ~49 us at 495 TFLOP/s (120 us at the CUDA cores' 67). Its inputs
// and outputs are ~5.3 MB (~1.6 us at 3.35 TB/s): bound by operations.
// What this design spends beyond that: the split and address arithmetic
// and shared loads around each mma.sync, which keep it issue-bound near a
// sixth of the 3xTF32 rate; 128 blocks (32 column groups x 4 row ranges)
// that re-read h for their rows from L2 (42 MB in all); and 32 dh slabs and
// 4 dv/dvb slabs (47 MB, mostly L2-resident) that the sum launch reads
// back once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kTile + 4;  // row stride of the k-major tiles, in floats
constexpr int kMaxDim = 128;
constexpr int kHeader = 256;    // floats of per-tile ids and scalars
constexpr int kTargetBlocks = 512;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* h;
  const float* v;
  const float* vbq;
  const long long* pos;
  const float* lse;  // backward only
  const float* g;    // backward only
  int B;
  int D;
  int DP;         // D rounded up to a multiple of 4
  int tiles;      // ceil(B / 64)
  int per_split;  // inner tiles per block
  float* p0;      // partial outputs, split-major
  float* p1;
  float* p2;
};

int tiles_of(int B) { return (B + kTile - 1) / kTile; }

int per_split_of(int tiles) {
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  return (tiles + splits - 1) / splits;
}

int splits_of(int B) {
  const int t = tiles_of(B);
  const int per = per_split_of(t);
  return (t + per - 1) / per;
}

// Rows [x0, x0 + 64) of X (B, D) into XT[k * kLd + i] (k-major) and, with
// ROW, into XR[i * DP + k]; zero past B and, in XR, in columns D..DP-1.
template <bool ROW>
__device__ void load_tile(const float* __restrict__ X, int x0, const Args& a, float* XT,
                          float* XR) {
  const float* base = X + (size_t)x0 * a.D;
  const int rows = min(kTile, a.B - x0);
  const int n = kTile * a.D, valid = rows * a.D;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / a.D, k = e - i * a.D;
    const float val = e < valid ? base[e] : 0.0f;
    XT[k * kLd + i] = val;
    if constexpr (ROW) XR[i * a.DP + k] = val;
  }
  if constexpr (ROW) {
    const int pad = a.DP - a.D;
    for (int e = threadIdx.x; e < kTile * pad; e += kThreads)
      XR[(e / pad) * a.DP + a.D + e % pad] = 0.0f;
  }
}

// acc[i][j] = sum_k AT[k][ty*4 + i] * BT[k][tx*4 + j]
__device__ __forceinline__ void logit_tile(const float* AT, const float* BT, int D, int ty,
                                           int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(AT + k * kLd + ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(BT + k * kLd + tx * 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One logit into a running (max m, sum s of exp(x - m)).
__device__ __forceinline__ void lse_push(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// Merge (m2, s2) into (m, s); a part with m == -inf holds no logit. The
// merge is symmetric, so both lanes of a shuffle pair agree bit for bit.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = (m == -INFINITY ? 0.0f : s * expf(m - mx)) + (m2 == -INFINITY ? 0.0f : s2 * expf(m2 - mx));
  m = mx;
}

// Forward: block (row tile, column range) -> per-row partial (max, sum,
// label) over its columns.
__global__ void __launch_bounds__(kThreads) softmax_ce_fwd_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long* pos_c = reinterpret_cast<long long*>(smem);
  float* vbq_c = smem + 2 * kTile;
  float* HT = smem + kHeader;
  float* VT = HT + a.D * kLd;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r0 = blockIdx.x * kTile;
  load_tile<false>(a.h, r0, a, HT, nullptr);
  int rr[4];
  long long prow[4];
  float m[4], s[4], lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = r0 + ty * 4 + i;
    prow[i] = rr[i] < a.B ? a.pos[rr[i]] : 0;
    m[i] = -INFINITY;
    s[i] = 0.0f;
    lab[i] = 0.0f;
  }
  const int t0 = blockIdx.y * a.per_split, t1 = min(t0 + a.per_split, a.tiles);
  for (int t = t0; t < t1; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    load_tile<false>(a.v, c0, a, VT, nullptr);
    if (threadIdx.x < kTile) {
      const int c = c0 + threadIdx.x;
      pos_c[threadIdx.x] = c < a.B ? a.pos[c] : 0;
      vbq_c[threadIdx.x] = c < a.B ? a.vbq[c] : 0.0f;
    }
    __syncthreads();
    float acc[4][4];
    logit_tile(HT, VT, a.D, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx * 4 + j, c = c0 + cl;
        if (rr[i] >= a.B || c >= a.B) continue;
        const bool diag = c == rr[i];
        if (!diag && pos_c[cl] == prow[i]) continue;  // accidental hit
        const float x = acc[i][j] + vbq_c[cl];
        if (diag) lab[i] = x;
        lse_push(x, m[i], s[i]);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m2 = __shfl_xor_sync(kFull, m[i], off);
      const float s2 = __shfl_xor_sync(kFull, s[i], off);
      lab[i] += __shfl_xor_sync(kFull, lab[i], off);  // one lane holds the label
      lse_merge(m[i], s[i], m2, s2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rr[i] >= a.B) continue;
      const size_t o = (size_t)blockIdx.y * a.B + rr[i];
      a.p0[o] = m[i];
      a.p1[o] = s[i];
      a.p2[o] = lab[i];
    }
  }
}

// Forward: the column ranges' partials, merged in order, -> loss and lse.
__global__ void softmax_ce_fwd_combine_kernel(const Args a, int splits, float* __restrict__ loss,
                                              float* __restrict__ lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.B) return;
  float m = -INFINITY, s = 0.0f, lab = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = (size_t)sp * a.B + r;
    lse_merge(m, s, a.p0[o], a.p1[o]);
    lab += a.p2[o];
  }
  const float l = m + logf(s);
  lse[r] = l;
  loss[r] = l - lab;
}

// ---------------------------------------------------------------------------
// Backward: one pass on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kBT = 64;     // backward tile: 64 rows x 64 columns
constexpr int kCG = 128;    // columns a backward block owns (two tiles)
constexpr int kWave = 132;  // blocks in one wave: one per SM
constexpr int kBwdThreads = 512;  // 16 warps: 4 along rows x 4 along columns or d

struct BwdArgs {
  const float* h;
  const float* v;
  const float* vbq;
  const long long* pos;
  const float* lse;
  const float* g;
  int B, D;
  int DP;     // D rounded up to a multiple of 8: the k extent of h . v^T
  int LD;     // shared row stride in floats: D rounded up to a multiple of 32
  int tiles;  // row tiles per block
  int vec;    // 1: 16-byte cp.async staging (D % 4 == 0, aligned rows)
  float* part_dh;   // (column groups, B, D)
  float* part_dv;   // (row groups, B, D)
  float* part_dvb;  // (row groups, B)
};

// Shared tiles are row-major with a stride that is a multiple of 32 floats;
// column c of local row r sits at c ^ swz(r). The XOR moves only bits 2-4,
// so groups of 4 columns stay whole (16-byte staging) and pairs stay
// adjacent (float2 accumulator stores). With it, both fragment patterns
// of m16n8k8 hit 32 distinct banks: (row g, column t) for g < 8, t < 4,
// as A and a B read along its k columns use it, and (row t, column g), as
// a B read along its k rows and the transposed A of dv use it.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (((r >> 2) & 1) << 2); }

__device__ __forceinline__ int at(int r, int c, int ld) { return r * ld + (c ^ swz(r)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

// 4 or 8 bytes (the row scalars), zero-filled where ``in`` is false.
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N), "r"(in ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Rows [x0, x0 + rows) of X (B, D) into dst (rows x LD, swizzled), zero
// past B and past D. 16-byte cp.async where rows allow it, else plain loads
// (any D, any alignment): the same layout either way.
__device__ void stage_rows(float* dst, const float* __restrict__ X, int x0, int rows, const BwdArgs& a) {
  if (a.vec) {
    const int groups = a.LD >> 2;
    for (int e = threadIdx.x; e < rows * groups; e += kBwdThreads) {
      const int i = e / groups, c = (e - i * groups) << 2, r = x0 + i;
      const bool in = r < a.B && c < a.D;
      cp_async16(dst + at(i, c, a.LD), in ? X + (size_t)r * a.D + c : X, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * a.LD; e += kBwdThreads) {
      const int i = e / a.LD, c = e - i * a.LD, r = x0 + i;
      dst[at(i, c, a.LD)] = (r < a.B && c < a.D) ? X[(size_t)r * a.D + c] : 0.0f;
    }
  }
}

// 3xTF32: x = big + small, both TF32, so that a.b ~= a_big.b_big +
// a_big.b_small + a_small.b_big keeps ~21 bits of each operand, near f32's
// 24; the dropped a_small.b_small is ~2^-21 relative. The tensor cores read
// only the top 19 bits of a TF32 operand, so big is x itself (read as x
// with its low 13 bits cleared) and small the exact remainder x - big: one
// integer op and a subtraction, no conversion instruction.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  return {__float_as_uint(x), __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u))};
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four A fragment values (rows g, g+8 x k t, t+4), split once per k
// step and reused across the warp's n fragments.
struct FragA {
  Split v[4];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}

// d[j] += a . b[j] for the first ``active`` of NJ fragments in 3xTF32, the
// small terms first. b[j]: the two B values (k t, t+4), split. Each pass
// runs over every fragment before the next, so consecutive products on one
// accumulator are NJ instructions apart.
template <int NJ>
__device__ __forceinline__ void mma3(float (&d)[NJ][4], const FragA& a, const Split (&b)[NJ][2], int active) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < active)
      mma_tf32(d[j], a.v[0].small, a.v[1].small, a.v[2].small, a.v[3].small, b[j][0].big, b[j][1].big);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < active)
      mma_tf32(d[j], a.v[0].big, a.v[1].big, a.v[2].big, a.v[3].big, b[j][0].small, b[j][1].small);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < active)
      mma_tf32(d[j], a.v[0].big, a.v[1].big, a.v[2].big, a.v[3].big, b[j][0].big, b[j][1].big);
}

// Block (column group of 128, range of row tiles). For each of its row
// tiles r (h staged by cp.async one tile ahead) and each of its two column
// tiles c (v of the group staged once):
//   S = h_r . v_c^T (3xTF32, once), P = dlog of S (masked, 0 outside the
//   batch) into shared memory, dvb_c += column sums of P,
//   dh_r += P . v_c (registers), dv_c += P^T . h_r (shared accumulators).
// dh_r, complete over the group's columns, goes to the group's partial
// slab; dv and dvb, complete over the block's rows, to the row range's.
// Warp w: S rows 16 (w >> 2) .. +16 and columns 16 (w & 3) .. +16; then
// warps 0-7 take dh and warps 8-15 dv at the same time, each 16 output rows
// by NF = ceil(DP / 16) d fragments (a template argument, so that the
// accumulators of the main path's D = 80 take 20 registers, not 32).
// Sixteen warps at <= 128 registers each hide the latency of the loads and
// products better than eight with twice the tile.
template <int NF>
__global__ void __launch_bounds__(kBwdThreads, 1) softmax_ce_bwd_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* Vs = reinterpret_cast<float*>(smem4);  // kCG x LD
  float* dVs = Vs + kCG * a.LD;                  // kCG x LD
  float* Hs = dVs + kCG * a.LD;                  // 2 x kBT x LD
  float* Ps = Hs + 2 * kBT * a.LD;               // kBT x kBT
  float* colv = Ps + kBT * kBT;                  // kCG: vbq of the group's columns
  float* dvbs = colv + kCG;                      // kCG: dvb accumulators
  float* red = dvbs + kCG;                       // 4 x kBT: per-warp-row column sums
  float* rlse = red + 4 * kBT;                   // 2 x kBT (by h buffer)
  float* rgs = rlse + 2 * kBT;                   // 2 x kBT
  long long* cpos = reinterpret_cast<long long*>(rgs + 2 * kBT);  // kCG
  long long* rpos = cpos + kCG;                                   // 2 x kBT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int LD = a.LD, nfd = a.DP >> 3;
  // dh (warps 0-7) and dv (warps 8-15): output rows pa, pa + 8 of a tile,
  // d fragments nf0 .. nf0 + pact - 1 (NF = ceil(nfd / 2) per warp)
  const int pa = 16 * ((warp >> 1) & 3) + g, nf0 = (warp & 1) * NF;
  const int pact = max(0, min(NF, nfd - nf0));
  const int c0 = blockIdx.x * kCG;
  const int row_tiles = (a.B + kBT - 1) / kBT;
  const int t_begin = blockIdx.y * a.tiles, t_end = min(t_begin + a.tiles, row_tiles);

  // lse, g and pos of the 64 rows from r0 into row-scalar slot ``slot``
  auto stage_row_scalars = [&](int r0, int slot) {
    if (tid < kBT) {
      const int r = r0 + tid;
      const bool in = r < a.B;
      cp_async_small<4>(rlse + slot * kBT + tid, a.lse + (in ? r : 0), in);
      cp_async_small<4>(rgs + slot * kBT + tid, a.g + (in ? r : 0), in);
      cp_async_small<8>(rpos + slot * kBT + tid, a.pos + (in ? r : 0), in);
    }
  };
  stage_rows(Vs, a.v, c0, kCG, a);
  stage_rows(Hs, a.h, t_begin * kBT, kBT, a);
  stage_row_scalars(t_begin * kBT, 0);
  cp_async_commit();
  for (int e = tid; e < kCG * LD; e += kBwdThreads) dVs[e] = 0.0f;
  if (tid < kCG) {
    const int c = c0 + tid;
    cpos[tid] = c < a.B ? a.pos[c] : 0;
    colv[tid] = c < a.B ? a.vbq[c] : 0.0f;
    dvbs[tid] = 0.0f;
  }

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int buf = (tt - t_begin) & 1, r0 = tt * kBT;
    const float* H = Hs + buf * kBT * LD;
    const float* lse_r = rlse + buf * kBT;
    const float* g_r = rgs + buf * kBT;
    const long long* pos_r = rpos + buf * kBT;
    if (tt + 1 < t_end) {  // the next row tile's h and scalars, one tile ahead
      stage_rows(Hs + (buf ^ 1) * kBT * LD, a.h, r0 + kBT, kBT, a);
      stage_row_scalars(r0 + kBT, buf ^ 1);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    float dh[NF][4];  // warps 0-7
#pragma unroll
    for (int jj = 0; jj < NF; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) dh[jj][q] = 0.0f;

    for (int ct = 0; ct < kCG / kBT; ++ct) {
      const int cc0 = c0 + ct * kBT;
      if (cc0 >= a.B) break;  // uniform across the block
      const float* V = Vs + ct * kBT * LD;

      // S = h_r . v_c^T over k = d
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] = 0.0f;
      const int ra = 16 * wm + g;
#pragma unroll 1
      for (int k0 = 0; k0 < a.DP; k0 += 8) {
        const FragA af = frag_a(H[at(ra, k0 + t, LD)], H[at(ra + 8, k0 + t, LD)], H[at(ra, k0 + t + 4, LD)],
                                H[at(ra + 8, k0 + t + 4, LD)]);
        Split bf[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 16 * wn + 8 * j + g;
          bf[j][0] = split(V[at(n, k0 + t, LD)]);
          bf[j][1] = split(V[at(n, k0 + t + 4, LD)]);
        }
        mma3<2>(s, af, bf, 2);
      }

      // P = dlog, its column sums
      float csum[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        csum[j][0] = csum[j][1] = 0.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = ra + 8 * hh, r = r0 + rl;
          float p[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int cl = 16 * wn + 8 * j + 2 * t + q, c = cc0 + cl;
            const bool diag = c == r;
            const bool keep = r < a.B && c < a.B && (diag || cpos[ct * kBT + cl] != pos_r[rl]);
            p[q] = keep ? g_r[rl] * (expf(s[j][2 * hh + q] + colv[ct * kBT + cl] - lse_r[rl]) -
                                     (diag ? 1.0f : 0.0f))
                        : 0.0f;
            csum[j][q] += p[q];
          }
          *reinterpret_cast<float2*>(Ps + at(rl, 16 * wn + 8 * j + 2 * t, kBT)) = make_float2(p[0], p[1]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = csum[j][q];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (g == 0) red[wm * kBT + 16 * wn + 8 * j + 2 * t + q] = v;
        }
      }
      __syncthreads();
      if (tid < kBT)
        dvbs[ct * kBT + tid] += ((red[tid] + red[kBT + tid]) + red[2 * kBT + tid]) + red[3 * kBT + tid];

      if (warp < 8) {
        // warps 0-7: dh_r += P . v_c over k = the tile's columns
#pragma unroll 1
        for (int k0 = 0; k0 < kBT; k0 += 8) {
          const FragA af = frag_a(Ps[at(pa, k0 + t, kBT)], Ps[at(pa + 8, k0 + t, kBT)],
                                  Ps[at(pa, k0 + t + 4, kBT)], Ps[at(pa + 8, k0 + t + 4, kBT)]);
          Split bf[NF][2];
#pragma unroll
          for (int jj = 0; jj < NF; ++jj) {
            const int n = 8 * (nf0 + jj) + g;
            if (jj < pact) {
              bf[jj][0] = split(V[at(k0 + t, n, LD)]);
              bf[jj][1] = split(V[at(k0 + t + 4, n, LD)]);
            }
          }
          mma3<NF>(dh, af, bf, pact);
        }
      } else {
        // warps 8-15, at the same time: dv_c += P^T . h_r over k = the
        // tile's rows (pa: a column of the tile = a row of dv)
        float dv[NF][4];
        float* D0 = dVs + ct * kBT * LD;
#pragma unroll
        for (int jj = 0; jj < NF; ++jj) {
          if (jj < pact) {
            const float2 lo = *reinterpret_cast<const float2*>(D0 + at(pa, 8 * (nf0 + jj) + 2 * t, LD));
            const float2 hi = *reinterpret_cast<const float2*>(D0 + at(pa + 8, 8 * (nf0 + jj) + 2 * t, LD));
            dv[jj][0] = lo.x;
            dv[jj][1] = lo.y;
            dv[jj][2] = hi.x;
            dv[jj][3] = hi.y;
          }
        }
#pragma unroll 1
        for (int k0 = 0; k0 < kBT; k0 += 8) {
          const FragA af = frag_a(Ps[at(k0 + t, pa, kBT)], Ps[at(k0 + t, pa + 8, kBT)],
                                  Ps[at(k0 + t + 4, pa, kBT)], Ps[at(k0 + t + 4, pa + 8, kBT)]);
          Split bf[NF][2];
#pragma unroll
          for (int jj = 0; jj < NF; ++jj) {
            const int n = 8 * (nf0 + jj) + g;
            if (jj < pact) {
              bf[jj][0] = split(H[at(k0 + t, n, LD)]);
              bf[jj][1] = split(H[at(k0 + t + 4, n, LD)]);
            }
          }
          mma3<NF>(dv, af, bf, pact);
        }
#pragma unroll
        for (int jj = 0; jj < NF; ++jj) {
          if (jj < pact) {
            const int c = 8 * (nf0 + jj) + 2 * t;
            *reinterpret_cast<float2*>(D0 + at(pa, c, LD)) = make_float2(dv[jj][0], dv[jj][1]);
            *reinterpret_cast<float2*>(D0 + at(pa + 8, c, LD)) = make_float2(dv[jj][2], dv[jj][3]);
          }
        }
      }
      __syncthreads();
    }

    // dh of this row tile over the group's columns -> the group's slab
    if (warp < 8) {
      float* out = a.part_dh + (size_t)blockIdx.x * a.B * a.D;
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        if (jj >= pact) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + pa + 8 * hh, d = 8 * (nf0 + jj) + 2 * t;
          if (r >= a.B || d >= a.D) continue;
          float* o = out + (size_t)r * a.D + d;
          if ((a.D & 1) == 0) {  // d even, D even: 8-byte aligned
            *reinterpret_cast<float2*>(o) = make_float2(dh[jj][2 * hh], dh[jj][2 * hh + 1]);
          } else {
            o[0] = dh[jj][2 * hh];
            if (d + 1 < a.D) o[1] = dh[jj][2 * hh + 1];
          }
        }
      }
    }
  }

  // dv and dvb of the group's columns over the block's rows -> its slab
  float* pdv = a.part_dv + (size_t)blockIdx.y * a.B * a.D;
  for (int e = tid; e < kCG * a.D; e += kBwdThreads) {
    const int i = e / a.D, d = e - i * a.D, c = c0 + i;
    if (c < a.B) pdv[(size_t)c * a.D + d] = dVs[at(i, d, LD)];
  }
  if (tid < kCG && c0 + tid < a.B) a.part_dvb[(size_t)blockIdx.y * a.B + c0 + tid] = dvbs[tid];
}

// dh = sum of the column groups' slabs, dv and dvb = sums of the row
// ranges' slabs, each in slab order.
__global__ void softmax_ce_bwd_sum_kernel(const BwdArgs a, int groups, int ranges, float* __restrict__ dh,
                                          float* __restrict__ dv, float* __restrict__ dvb) {
  const size_t n = (size_t)a.B * a.D, total = 2 * n + a.B;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (e < n) {
#pragma unroll 8
      for (int k = 0; k < groups; ++k) s += a.part_dh[(size_t)k * n + e];
      dh[e] = s;
    } else if (e < 2 * n) {
#pragma unroll 8
      for (int k = 0; k < ranges; ++k) s += a.part_dv[(size_t)k * n + e - n];
      dv[e - n] = s;
    } else {
#pragma unroll 8
      for (int k = 0; k < ranges; ++k) s += a.part_dvb[(size_t)k * a.B + e - 2 * n];
      dvb[e - 2 * n] = s;
    }
  }
}

// The backward's block grid: column groups x row ranges, about one wave.
struct BwdPlan {
  int groups, ranges, tiles;
};

BwdPlan bwd_plan(int B) {
  const int groups = (B + kCG - 1) / kCG, row_tiles = (B + kBT - 1) / kBT;
  int ranges = kWave / groups;
  if (ranges < 1) ranges = 1;
  if (ranges > row_tiles) ranges = row_tiles;
  const int tiles = (row_tiles + ranges - 1) / ranges;
  return {groups, (row_tiles + tiles - 1) / tiles, tiles};
}

int ld_of(int D) { return (D + 31) / 32 * 32; }

size_t bwd_smem(int D) {
  const size_t LD = ld_of(D);
  return sizeof(float) * (2 * kCG * LD + 2 * kBT * LD + kBT * kBT + 2 * kCG + 8 * kBT) +
         sizeof(long long) * (kCG + 2 * kBT);
}

size_t bwd_scratch(int B, int D) {
  const BwdPlan p = bwd_plan(B);
  return ((size_t)p.groups + p.ranges) * B * D + (size_t)p.ranges * B;
}

size_t fwd_smem(int D) { return sizeof(float) * (kHeader + 2 * (size_t)D * kLd); }

Args make_args(const float* h, const float* v, const float* vbq, const long long* pos,
               const float* lse, const float* g, int B, int D) {
  Args a{};
  a.h = h;
  a.v = v;
  a.vbq = vbq;
  a.pos = pos;
  a.lse = lse;
  a.g = g;
  a.B = B;
  a.D = D;
  a.DP = (D + 3) / 4 * 4;
  a.tiles = tiles_of(B);
  a.per_split = per_split_of(a.tiles);
  return a;
}

// Above 48 KB a kernel's dynamic shared memory must be opted into.
cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NF>
cudaError_t launch_bwd(const BwdArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = bwd_smem(a.D);
  cudaError_t e = allow_smem((const void*)softmax_ce_bwd_kernel<NF>, smem);
  if (e != cudaSuccess) return e;
  softmax_ce_bwd_kernel<NF><<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int trs_softmax_ce_max_dim() { return kMaxDim; }

// Column ranges per row tile of the forward for a batch of B: its partial
// buffers are this many (B,) slabs.
int trs_softmax_ce_splits(int B) { return B < 1 ? 0 : splits_of(B); }

// Floats of scratch the backward needs for a batch of B at width D: the
// column groups' dh slabs, the row ranges' dv and dvb slabs.
long long trs_softmax_ce_bwd_scratch(int B, int D) {
  if (B < 1 || D < 1 || D > kMaxDim) return -1;
  return (long long)bwd_scratch(B, D);
}

// Forward on ``stream``. h, v: (B, D) f32; vbq: (B,) f32; pos: (B,) int64,
// all contiguous; part: 3 * splits * B floats of scratch; loss, lse: (B,)
// f32. Returns a cudaError_t (cudaGetLastError after the launches).
int trs_softmax_ce_fwd(const float* h, const float* v, const float* vbq, const long long* pos,
                       int B, int D, float* part, float* loss, float* lse, cudaStream_t stream) {
  if (B < 1 || D < 1 || D > kMaxDim) return cudaErrorInvalidValue;
  Args a = make_args(h, v, vbq, pos, nullptr, nullptr, B, D);
  const int splits = splits_of(B);
  a.p0 = part;
  a.p1 = part + (size_t)splits * B;
  a.p2 = part + 2 * (size_t)splits * B;
  const size_t smem = fwd_smem(D);
  cudaError_t e = allow_smem((const void*)softmax_ce_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  softmax_ce_fwd_kernel<<<dim3(a.tiles, splits), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  softmax_ce_fwd_combine_kernel<<<(B + 255) / 256, 256, 0, stream>>>(a, splits, loss, lse);
  return cudaGetLastError();
}

// Backward on ``stream``: the forward's inputs, its lse and the per-row
// cotangent g (B,) f32; part: trs_softmax_ce_bwd_scratch(B, D) floats;
// dh, dv: (B, D) f32; dvb: (B,) f32. One pass, then one fixed-order sum of
// its slabs. Returns a cudaError_t.
int trs_softmax_ce_bwd(const float* h, const float* v, const float* vbq, const long long* pos,
                       const float* lse, const float* g, int B, int D, float* part, float* dh,
                       float* dv, float* dvb, cudaStream_t stream) {
  if (B < 1 || D < 1 || D > kMaxDim) return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(B);
  BwdArgs a{};
  a.h = h;
  a.v = v;
  a.vbq = vbq;
  a.pos = pos;
  a.lse = lse;
  a.g = g;
  a.B = B;
  a.D = D;
  a.DP = (D + 7) / 8 * 8;
  a.LD = ld_of(D);
  a.tiles = p.tiles;
  a.vec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  a.part_dh = part;
  a.part_dv = part + (size_t)p.groups * B * D;
  a.part_dvb = a.part_dv + (size_t)p.ranges * B * D;
  const dim3 grid(p.groups, p.ranges);
  cudaError_t e;
  switch ((a.DP / 8 + 1) / 2) {
    case 1: e = launch_bwd<1>(a, grid, stream); break;
    case 2: e = launch_bwd<2>(a, grid, stream); break;
    case 3: e = launch_bwd<3>(a, grid, stream); break;
    case 4: e = launch_bwd<4>(a, grid, stream); break;
    case 5: e = launch_bwd<5>(a, grid, stream); break;
    case 6: e = launch_bwd<6>(a, grid, stream); break;
    case 7: e = launch_bwd<7>(a, grid, stream); break;
    default: e = launch_bwd<8>(a, grid, stream); break;
  }
  if (e != cudaSuccess) return e;
  const size_t total = 2 * (size_t)B * D + B;
  size_t blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  softmax_ce_bwd_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a, p.groups, p.ranges, dh, dv, dvb);
  return cudaGetLastError();
}

}  // extern "C"
