// In-batch sampled-softmax cross-entropy for Hopper (sm_90a), forward and
// backward, behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/softmax_ce.py, built by ops/_build.py).
//
// Replaces torchrecsys_tpu/ops/softmax_ce.py::_fwd_kernel (:67) and
// ::_bwd_kernel (:92), with their rectangular contract. For Br rows --
// user-side vectors h (Br, D), positive ids pos_row (Br,) -- against Bc
// columns -- item-side vectors v (Bc, D), column biases vbq = item bias -
// logQ(pos) (Bc,), positive ids pos_col (Bc,) -- and a row offset off (the
// positive of row r sits in column r + off; 0 <= off, off + Br <= Bc):
//     s[r][c] = h[r] . v[c] + vbq[c], dropped where pos_col[c] == pos_row[r], c != r + off
//     lse[r]  = log sum_c exp(s[r][c]),   loss[r] = lse[r] - s[r][r + off]
// and, for a per-row cotangent g (Br,), with dlog[r][c] = g[r] * (softmax
// - onehot)[r][c] (a dropped logit has probability exactly 0):
//     dh = dlog . v (Br, D),  dv = dlog^T . h (Bc, D),  dvb = column sums of dlog (Bc,).
// The single-device call is the square case: Br = Bc = B, off = 0, pos_row =
// pos_col. A data-parallel shard is Br = B / n local rows against the Bc = B
// all-gathered columns, off = its rank x Br. The diagonal is never dropped,
// so every row has a finite LSE. Any Br, Bc >= 1 and 1 <= D <= 128 are taken
// as they are: tiles are zero-filled past Br, Bc and D, the ragged edges are
// masked, and the diagonal may start anywhere in a column tile.
//
// Forward. The TPU kernel holds a (TR, B) logit row block in VMEM and takes
// the row max, then the sum. Here a block owns 128 rows and a range of
// 64-column tiles and keeps a running (max, sum) per row, flash-style, on
// the accumulators of the products (FlashAttention-3's online softmax).
// - S = h . v^T is the one product, with both operands K-major as stored,
//   so it runs on wgmma (m64n64k8 tf32, f32 accumulators) as 3xTF32 (the
//   split below, small terms first): f32-accurate to ~2^-21.
// - A split pass writes each 64-column tile of v once per call as the image
//   its shared-memory slot takes: v_big and v_small in 128-byte-swizzled
//   [row][32 floats] chunks (D padded with zeros to a multiple of 16, then
//   to 32), vbq (-inf past Bc, so padded columns drop out) and the ids. A
//   producer warp copies each image whole (one bulk copy on the copy
//   engine) into a 3-slot ring, its arrival counted on an mbarrier. Each
//   warpgroup's h (64 rows, split once) lives in registers as wgmma's A
//   operand for the whole walk, which leaves the shared memory to the ring.
// - A warpgroup multiplies a tile, waits for its products and folds them
//   into its rows' (max, sum): the duplicate mask from the tile's ids in
//   shared memory, the tile's row max by two quad shuffles, one exp2 per
//   logit, no branch per logit; the label is taken in the one tile that
//   holds the diagonal. Then it releases the slot on the slot's "empty"
//   mbarrier. The two warpgroups take turns to issue (named barriers), so
//   one's fold runs under the other's products. (Folding tile i under tile i + 1's
//   products within one warpgroup reads accumulators while a wgmma is in
//   flight, which ptxas answers by serialising every wgmma.)
// - Column ranges split the 4096 columns of the main path so that 32 row
//   tiles x 4 ranges make about one wave of 132 SMs; each (row tile, range)
//   block writes a (max, sum, label) partial per row, and a third launch
//   merges them in range order. No atomics: repeated runs give the same
//   bits. Three launches per call: split, products, combine.
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
// A data-parallel shard's call (Br = 1024 rows of a 4096-row batch over 4
// ranks) does Br / B of the square call's work on the same plan: a quarter
// of the row tiles, each over every column tile.
//
// Bound at the main path's B = 4096, D = 80. Forward: 2.B^2.D = 2.68 GFLOP
// of f32 products, 8.05 GFLOP of TF32 as 3xTF32, 16.3 us at 495 TFLOP/s
// (40 us at the CUDA cores' 67); its inputs and outputs are ~2.7 MB (~0.8
// us at 3.35 TB/s): bound by operations. What this design spends beyond
// that: the split pass (1.3 MB read, 3.2 MB of images written; each image
// is read back from L2 by the 32 row tiles' blocks, 103 MB in all), the
// fold's ~10 instructions per logit where they do not hide under the other
// warpgroup's products, 4 of 132 SMs idle, and the combine launch.
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

constexpr int kMaxDim = 128;
constexpr unsigned kFull = 0xffffffffu;

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
  const long long* pos_row;
  const long long* pos_col;
  const float* lse;
  const float* g;
  int Br, Bc, off, D;
  int DP;     // D rounded up to a multiple of 8: the k extent of h . v^T
  int LD;     // shared row stride in floats: D rounded up to a multiple of 32
  int tiles;  // row tiles per block
  int vec;    // 1: 16-byte cp.async staging (D % 4 == 0, aligned rows)
  float* part_dh;   // (column groups, Br, D)
  float* part_dv;   // (row groups, Bc, D)
  float* part_dvb;  // (row groups, Bc)
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

// Rows [x0, x0 + rows) of X (n, D) into dst (rows x LD, swizzled), zero
// past n and past D. 16-byte cp.async where rows allow it, else plain loads
// (any D, any alignment): the same layout either way.
__device__ void stage_rows(float* dst, const float* __restrict__ X, int x0, int rows, int n, const BwdArgs& a) {
  if (a.vec) {
    const int groups = a.LD >> 2;
    for (int e = threadIdx.x; e < rows * groups; e += kBwdThreads) {
      const int i = e / groups, c = (e - i * groups) << 2, r = x0 + i;
      const bool in = r < n && c < a.D;
      cp_async16(dst + at(i, c, a.LD), in ? X + (size_t)r * a.D + c : X, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * a.LD; e += kBwdThreads) {
      const int i = e / a.LD, c = e - i * a.LD, r = x0 + i;
      dst[at(i, c, a.LD)] = (r < n && c < a.D) ? X[(size_t)r * a.D + c] : 0.0f;
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
  const int row_tiles = (a.Br + kBT - 1) / kBT;
  const int t_begin = blockIdx.y * a.tiles, t_end = min(t_begin + a.tiles, row_tiles);

  // lse, g and pos_row of the 64 rows from r0 into row-scalar slot ``slot``
  auto stage_row_scalars = [&](int r0, int slot) {
    if (tid < kBT) {
      const int r = r0 + tid;
      const bool in = r < a.Br;
      cp_async_small<4>(rlse + slot * kBT + tid, a.lse + (in ? r : 0), in);
      cp_async_small<4>(rgs + slot * kBT + tid, a.g + (in ? r : 0), in);
      cp_async_small<8>(rpos + slot * kBT + tid, a.pos_row + (in ? r : 0), in);
    }
  };
  stage_rows(Vs, a.v, c0, kCG, a.Bc, a);
  stage_rows(Hs, a.h, t_begin * kBT, kBT, a.Br, a);
  stage_row_scalars(t_begin * kBT, 0);
  cp_async_commit();
  for (int e = tid; e < kCG * LD; e += kBwdThreads) dVs[e] = 0.0f;
  if (tid < kCG) {
    const int c = c0 + tid;
    cpos[tid] = c < a.Bc ? a.pos_col[c] : 0;
    colv[tid] = c < a.Bc ? a.vbq[c] : 0.0f;
    dvbs[tid] = 0.0f;
  }

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int buf = (tt - t_begin) & 1, r0 = tt * kBT;
    const float* H = Hs + buf * kBT * LD;
    const float* lse_r = rlse + buf * kBT;
    const float* g_r = rgs + buf * kBT;
    const long long* pos_r = rpos + buf * kBT;
    if (tt + 1 < t_end) {  // the next row tile's h and scalars, one tile ahead
      stage_rows(Hs + (buf ^ 1) * kBT * LD, a.h, r0 + kBT, kBT, a.Br, a);
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
      if (cc0 >= a.Bc) break;  // uniform across the block
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
            const bool diag = c == r + a.off;
            const bool keep = r < a.Br && c < a.Bc && (diag || cpos[ct * kBT + cl] != pos_r[rl]);
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
      float* out = a.part_dh + (size_t)blockIdx.x * a.Br * a.D;
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        if (jj >= pact) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + pa + 8 * hh, d = 8 * (nf0 + jj) + 2 * t;
          if (r >= a.Br || d >= a.D) continue;
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
  float* pdv = a.part_dv + (size_t)blockIdx.y * a.Bc * a.D;
  for (int e = tid; e < kCG * a.D; e += kBwdThreads) {
    const int i = e / a.D, d = e - i * a.D, c = c0 + i;
    if (c < a.Bc) pdv[(size_t)c * a.D + d] = dVs[at(i, d, LD)];
  }
  if (tid < kCG && c0 + tid < a.Bc) a.part_dvb[(size_t)blockIdx.y * a.Bc + c0 + tid] = dvbs[tid];
}

// dh = sum of the column groups' slabs, dv and dvb = sums of the row
// ranges' slabs, each in slab order.
__global__ void softmax_ce_bwd_sum_kernel(const BwdArgs a, int groups, int ranges, float* __restrict__ dh,
                                          float* __restrict__ dv, float* __restrict__ dvb) {
  const size_t nh = (size_t)a.Br * a.D, nv = (size_t)a.Bc * a.D, total = nh + nv + a.Bc;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (e < nh) {
#pragma unroll 8
      for (int k = 0; k < groups; ++k) s += a.part_dh[(size_t)k * nh + e];
      dh[e] = s;
    } else if (e < nh + nv) {
#pragma unroll 8
      for (int k = 0; k < ranges; ++k) s += a.part_dv[(size_t)k * nv + e - nh];
      dv[e - nh] = s;
    } else {
#pragma unroll 8
      for (int k = 0; k < ranges; ++k) s += a.part_dvb[(size_t)k * a.Bc + e - nh - nv];
      dvb[e - nh - nv] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: 3xTF32 wgmma products with a running (max, sum) per row.
// ---------------------------------------------------------------------------

constexpr int kFM = 128;      // rows of a forward block: two warpgroups of 64
constexpr int kFN = 64;       // columns per step: wgmma m64n64k8
constexpr int kFThreads = 256;
constexpr int kFStages = 3;   // column tile images in flight
constexpr float kLog2e = 1.4426950408889634f;

struct FwdArgs {
  const float* h;
  const float* v;
  const float* vbq;
  const long long* pos_row;
  const long long* pos_col;
  int Br, Bc, off, D;
  int KP;         // floats per staged row: D rounded up to 16, then to 32 (128-byte chunks)
  int SB;         // bytes of one column tile's image (a multiple of 1024)
  int col_tiles;  // ceil(Bc / 64)
  int per_split;  // column tiles per block
  uint8_t* img;   // col_tiles images, each as the stage it is copied into
  float* p0;      // per-split partials (splits, Br): running max, sum, label
  float* p1;
  float* p2;
};

// The big part of a 3xTF32 split: x with its low 13 bits cleared (a TF32
// value); the small part is tf32(x - big).
__device__ __forceinline__ float tf32_big(float x) { return __uint_as_float(__float_as_uint(x) & 0xffffe000u); }

// One column tile's image, as it sits in shared memory: v_big and v_small
// (64 rows x KP floats each, KP / 32 chunks of [row][128 bytes] in the
// 128-byte swizzle, zero past Bc and past D), then vbq (-inf past Bc, so a
// padded column drops out of every sum) and pos_col of the 64 columns.
__device__ __forceinline__ int img_small(int KP) { return kFN * KP * 4; }
__device__ __forceinline__ int img_cols(int KP) { return 2 * kFN * KP * 4; }

__global__ void softmax_ce_fwd_split_kernel(const FwdArgs a) {
  const int q4 = a.KP / 4;  // 16-byte units per row
  const long long units = (long long)a.col_tiles * kFN * q4;
  const long long total = units + (long long)a.col_tiles * kFN;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < units) {
      const int tile = (int)(e / (kFN * q4)), rem = (int)(e - (long long)tile * kFN * q4);
      const int n = rem / q4, u = rem - n * q4, c = tile * kFN + n;
      float big[4], small[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * u + j;
        const float x = (c < a.Bc && k < a.D) ? a.v[(size_t)c * a.D + k] : 0.0f;
        big[j] = tf32_big(x);
        small[j] = tf32_big(x - big[j]);
      }
      uint8_t* p = a.img + (size_t)tile * a.SB + (u >> 3) * (kFN * 128) + n * 128 + (((u & 7) ^ (n & 7)) << 4);
      *reinterpret_cast<float4*>(p) = make_float4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<float4*>(p + img_small(a.KP)) = make_float4(small[0], small[1], small[2], small[3]);
    } else {
      const int c = (int)(e - units), tile = c / kFN, n = c - tile * kFN;
      uint8_t* p = a.img + (size_t)tile * a.SB + img_cols(a.KP);
      reinterpret_cast<float*>(p)[n] = c < a.Bc ? a.vbq[c] : -INFINITY;
      reinterpret_cast<long long*>(p + kFN * 4)[n] = c < a.Bc ? a.pos_col[c] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major shared-memory matrix descriptor in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset (unused for K-major swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B on one warpgroup, m64n64k8 tf32: A (64 x 8) from registers
// (rows 16 w + g (+8), k t (+4) of warp w, as mma.sync's m16n8k8), B (64
// columns x 8, K-major) from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of ``bar`` with parity ``phase`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}

// Named barriers 1 and 2 order the two warpgroups' products: a warpgroup
// waits for its turn (bar.sync, its own 128 threads and the other's 128
// arrivals), issues, then hands the turn over (bar.arrive).
__device__ __forceinline__ void turn_wait(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void turn_pass(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// One contiguous copy of ``bytes`` (a multiple of 16) from global to shared
// memory by the copy engine, counted on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Block (row tile of 128, range of column tiles): two consumer warpgroups
// and one producer warp. Warpgroup wg owns rows 64 wg .. +64 of the tile;
// their h (big and small parts) sits in registers for the whole walk, as
// wgmma's A operand. The producer copies each column tile's image whole
// into a 3-slot ring (one bulk copy, completion counted on the slot's
// "full" barrier); a warpgroup multiplies a tile, waits for its products,
// folds the logits into its rows' running (max, sum) and releases the slot
// on its "empty" barrier. The two warpgroups take turns to issue their
// products (two named barriers), so that one's fold runs under the other's
// products. NK2: D rounded up to 16, in 16s.
template <int NK2>
__global__ void __launch_bounds__(kFThreads + 32, 1) softmax_ce_fwd_kernel(const FwdArgs a) {
  constexpr int NK = 2 * NK2;  // k8 steps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFStages * a.SB);
  uint64_t* empty = full + kFStages;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.y * a.per_split, nt = min(a.per_split, a.col_tiles - t0);
  const int bytes = img_cols(a.KP) + kFN * 12;  // a multiple of 16
  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kFThreads) {  // the producer warp
    if (tid == kFThreads) {
      for (int i = 0; i < nt; ++i) {
        const int slot = i % kFStages;
        if (i >= kFStages) mbar_wait(empty + slot, (i / kFStages - 1) & 1);
        mbar_expect_tx(full + slot, bytes);
        bulk_load(ring + slot * a.SB, a.img + (size_t)(t0 + i) * a.SB, bytes, full + slot);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw0 = blockIdx.x * kFM + 64 * wg;  // the warpgroup's first row
  const int row[2] = {rw0 + 16 * warp + g, rw0 + 16 * warp + g + 8};
  uint32_t hb[NK][4], hs[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1], k = 8 * kk + t + 4 * (i >> 1);
      const float x = (r < a.Br && k < a.D) ? a.h[(size_t)r * a.D + k] : 0.0f;
      const float big = tf32_big(x);
      hb[kk][i] = __float_as_uint(big);
      hs[kk][i] = __float_as_uint(tf32_big(x - big));
    }
  long long prow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) prow[hh] = row[hh] < a.Br ? a.pos_row[row[hh]] : 0;

  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.0f, 0.0f}, lab[2] = {0.0f, 0.0f};
  float acc[32];
  if (wg == 1) turn_pass(1);  // warpgroup 0 issues first
  for (int i = 0; i < nt; ++i) {
    const int slot = i % kFStages;
    const uint8_t* vb = ring + slot * a.SB;
    const uint8_t* vs = vb + img_small(a.KP);
    mbar_wait(full + slot, (i / kFStages) & 1);
    turn_wait(1 + wg);
    // S = h . v^T of the tile: the small terms first
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_tf32(acc, hs[kk], kmajor_desc(vb + (kk >> 2) * (kFN * 128) + (kk & 3) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) wgmma_tf32(acc, hb[kk], kmajor_desc(vs + (kk >> 2) * (kFN * 128) + (kk & 3) * 32), 1);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) wgmma_tf32(acc, hb[kk], kmajor_desc(vb + (kk >> 2) * (kFN * 128) + (kk & 3) * 32), 1);
    wg_commit();
    if (wg == 0 || i + 1 < nt) turn_pass(2 - wg);  // the other's products queue behind these
    wg_wait<0>();
    fence_acc(acc);

    // the logits into the running (max, sum): acc[4 j + 2 hh + q] is
    // row[hh], column 8 j + 2 t + q of the tile
    const int c0 = (t0 + i) * kFN;
    const uint8_t* cs = vb + img_cols(a.KP);
    const float* cv = reinterpret_cast<const float*>(cs);
    const long long* cp = reinterpret_cast<const long long*>(cs + kFN * 4);
    // a tile that holds some of the warpgroup's labels (columns rw0 + off ..
    // + 64, which may straddle two tiles)
    const int dlo = rw0 + a.off;
    const bool diag = c0 < dlo + 64 && dlo < c0 + kFN;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x[16];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * t;
        const float2 vq = *reinterpret_cast<const float2*>(cv + cl);
        const longlong2 pc = *reinterpret_cast<const longlong2*>(cp + cl);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float val = acc[4 * j + 2 * hh + q] + (q ? vq.y : vq.x);
          bool keep = (q ? pc.y : pc.x) != prow[hh];
          if (diag && c0 + cl + q == row[hh] + a.off) {
            keep = true;
            lab[hh] = val;
          }
          x[2 * j + q] = keep ? val : -INFINITY;
          mx = fmaxf(mx, x[2 * j + q]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(m[hh], mx);
      const float mu = mn == -INFINITY ? 0.0f : mn;  // no logit yet: every term is 0
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) sum += ex2((x[e] - mu) * kLog2e);
      s[hh] = s[hh] * ex2((m[hh] - mu) * kLog2e) + sum;
      m[hh] = mn;
    }
    mbar_arrive(empty + slot);  // this thread is done with the slot
  }

  // the four lanes of a row share its max: add their sums (and the one
  // label) in a symmetric order, so all four hold the same bits
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s[hh] += __shfl_xor_sync(kFull, s[hh], 1);
    s[hh] += __shfl_xor_sync(kFull, s[hh], 2);
    lab[hh] += __shfl_xor_sync(kFull, lab[hh], 1);
    lab[hh] += __shfl_xor_sync(kFull, lab[hh], 2);
    if (t == 0 && row[hh] < a.Br) {
      const size_t o = (size_t)blockIdx.y * a.Br + row[hh];
      a.p0[o] = m[hh];
      a.p1[o] = s[hh];
      a.p2[o] = lab[hh];
    }
  }
}

// One logit part (m2, s2) into (m, s); a part with m == -inf holds no
// logit.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = (m == -INFINITY ? 0.0f : s * expf(m - mx)) + (m2 == -INFINITY ? 0.0f : s2 * expf(m2 - mx));
  m = mx;
}

// The column ranges' partials, merged in range order, -> loss and lse.
__global__ void softmax_ce_fwd_combine_kernel(const FwdArgs a, int splits, float* __restrict__ loss,
                                              float* __restrict__ lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.Br) return;
  float m = -INFINITY, s = 0.0f, lab = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = (size_t)sp * a.Br + r;
    lse_merge(m, s, a.p0[o], a.p1[o]);
    lab += a.p2[o];
  }
  const float l = m + logf(s);
  lse[r] = l;
  loss[r] = l - lab;
}

// The backward's block grid: column groups x row ranges, about one wave.
struct BwdPlan {
  int groups, ranges, tiles;
};

BwdPlan bwd_plan(int Br, int Bc) {
  const int groups = (Bc + kCG - 1) / kCG, row_tiles = (Br + kBT - 1) / kBT;
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

size_t bwd_scratch(int Br, int Bc, int D) {
  const BwdPlan p = bwd_plan(Br, Bc);
  return (size_t)p.groups * Br * D + (size_t)p.ranges * Bc * (D + 1);
}

// The forward's layout and grid: row tiles of 128 x column ranges, about
// one wave of 132 SMs; the column tiles' images sit in the scratch first,
// the (m, s, label) partials after them.
struct FwdPlan {
  int KP, SB, col_tiles, row_tiles, splits, per_split;
};

FwdPlan fwd_plan(int Br, int Bc, int D) {
  FwdPlan p;
  p.KP = ((D + 15) / 16 * 16 + 31) / 32 * 32;
  p.SB = (2 * kFN * p.KP * 4 + kFN * 12 + 1023) / 1024 * 1024;
  p.col_tiles = (Bc + kFN - 1) / kFN;
  p.row_tiles = (Br + kFM - 1) / kFM;
  int splits = kWave / p.row_tiles;
  if (splits > p.col_tiles) splits = p.col_tiles;
  if (splits < 1) splits = 1;
  p.per_split = (p.col_tiles + splits - 1) / splits;
  p.splits = (p.col_tiles + p.per_split - 1) / p.per_split;
  return p;
}

size_t fwd_scratch(int Br, int Bc, int D) {
  const FwdPlan p = fwd_plan(Br, Bc, D);
  return (size_t)p.col_tiles * p.SB / 4 + 3 * (size_t)p.splits * Br;
}

bool bad_shape(int Br, int Bc, int off, int D) {
  return Br < 1 || Bc < 1 || off < 0 || (long long)off + Br > Bc || D < 1 || D > kMaxDim;
}

// Above 48 KB a kernel's dynamic shared memory must be opted into.
cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NK2>
cudaError_t launch_fwd(const FwdArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)kFStages * a.SB + 2 * kFStages * sizeof(uint64_t);
  cudaError_t e = allow_smem((const void*)softmax_ce_fwd_kernel<NK2>, smem);
  if (e != cudaSuccess) return e;
  softmax_ce_fwd_kernel<NK2><<<grid, kFThreads + 32, smem, stream>>>(a);
  return cudaGetLastError();
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

// Floats of scratch the forward needs for Br rows against Bc columns at
// width D: the column tiles' split images, then the column ranges' (max,
// sum, label) partials.
long long trs_softmax_ce_fwd_scratch(int Br, int Bc, int D) {
  if (bad_shape(Br, Bc, 0, D)) return -1;
  return (long long)fwd_scratch(Br, Bc, D);
}

// Floats of scratch the backward needs for Br rows against Bc columns at
// width D: the column groups' dh slabs, the row ranges' dv and dvb slabs.
long long trs_softmax_ce_bwd_scratch(int Br, int Bc, int D) {
  if (bad_shape(Br, Bc, 0, D)) return -1;
  return (long long)bwd_scratch(Br, Bc, D);
}

// Forward on ``stream``. h: (Br, D) f32; v: (Bc, D) f32; vbq: (Bc,) f32;
// pos_row: (Br,) and pos_col: (Bc,) int64, all contiguous; 0 <= off,
// off + Br <= Bc; part: trs_softmax_ce_fwd_scratch(Br, Bc, D) floats
// (16-byte aligned); loss, lse: (Br,) f32. Three launches: the split of v
// into its column tiles' images, the products with the running (max, sum),
// the combine. Returns a cudaError_t (cudaGetLastError after the launches).
int trs_softmax_ce_fwd(const float* h, const float* v, const float* vbq, const long long* pos_row,
                       const long long* pos_col, int Br, int Bc, int off, int D, float* part, float* loss,
                       float* lse, cudaStream_t stream) {
  if (bad_shape(Br, Bc, off, D)) return cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(Br, Bc, D);
  FwdArgs a{};
  a.h = h;
  a.v = v;
  a.vbq = vbq;
  a.pos_row = pos_row;
  a.pos_col = pos_col;
  a.Br = Br;
  a.Bc = Bc;
  a.off = off;
  a.D = D;
  a.KP = p.KP;
  a.SB = p.SB;
  a.col_tiles = p.col_tiles;
  a.per_split = p.per_split;
  a.img = reinterpret_cast<uint8_t*>(part);
  float* partials = part + (size_t)p.col_tiles * p.SB / 4;
  a.p0 = partials;
  a.p1 = partials + (size_t)p.splits * Br;
  a.p2 = partials + 2 * (size_t)p.splits * Br;
  const long long units = (long long)p.col_tiles * kFN * (p.KP / 4 + 1);
  long long blocks = (units + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  softmax_ce_fwd_split_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(p.row_tiles, p.splits);
  switch ((D + 15) / 16) {
    case 1: e = launch_fwd<1>(a, grid, stream); break;
    case 2: e = launch_fwd<2>(a, grid, stream); break;
    case 3: e = launch_fwd<3>(a, grid, stream); break;
    case 4: e = launch_fwd<4>(a, grid, stream); break;
    case 5: e = launch_fwd<5>(a, grid, stream); break;
    case 6: e = launch_fwd<6>(a, grid, stream); break;
    case 7: e = launch_fwd<7>(a, grid, stream); break;
    default: e = launch_fwd<8>(a, grid, stream); break;
  }
  if (e != cudaSuccess) return e;
  softmax_ce_fwd_combine_kernel<<<(Br + 255) / 256, 256, 0, stream>>>(a, p.splits, loss, lse);
  return cudaGetLastError();
}

// Backward on ``stream``: the forward's inputs, its lse and the per-row
// cotangent g (Br,) f32; part: trs_softmax_ce_bwd_scratch(Br, Bc, D)
// floats; dh: (Br, D), dv: (Bc, D) f32; dvb: (Bc,) f32. One pass, then one
// fixed-order sum of its slabs. Returns a cudaError_t.
int trs_softmax_ce_bwd(const float* h, const float* v, const float* vbq, const long long* pos_row,
                       const long long* pos_col, const float* lse, const float* g, int Br, int Bc, int off,
                       int D, float* part, float* dh, float* dv, float* dvb, cudaStream_t stream) {
  if (bad_shape(Br, Bc, off, D)) return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(Br, Bc);
  BwdArgs a{};
  a.h = h;
  a.v = v;
  a.vbq = vbq;
  a.pos_row = pos_row;
  a.pos_col = pos_col;
  a.lse = lse;
  a.g = g;
  a.Br = Br;
  a.Bc = Bc;
  a.off = off;
  a.D = D;
  a.DP = (D + 7) / 8 * 8;
  a.LD = ld_of(D);
  a.tiles = p.tiles;
  a.vec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  a.part_dh = part;
  a.part_dv = part + (size_t)p.groups * Br * D;
  a.part_dvb = a.part_dv + (size_t)p.ranges * Bc * D;
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
  const size_t total = ((size_t)Br + Bc) * D + Bc;
  size_t blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  softmax_ce_bwd_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a, p.groups, p.ranges, dh, dv, dvb);
  return cudaGetLastError();
}

}  // extern "C"
