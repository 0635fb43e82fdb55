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
// The diagonal is never dropped, so every row has a finite LSE.
//
// What differs from the TPU design:
// - The TPU kernel holds a (TR, B) logit row block in VMEM and takes the
//   row max, then the sum. A 64-row block over B = 4096 columns would need
//   1 MB here, so the forward streams 64-column tiles and keeps a running
//   (max, sum) per row and thread, flash-style; the 16 threads that share
//   a row merge theirs at the end. Rounding differs from the two-pass form
//   by a few f32 ulps of the LSE.
// - The TPU backward accumulates dv and dvb across its sequential grid.
//   Blocks here run in no order, so the backward is two passes that each
//   recompute the logits from h, v and lse: one over row tiles writes dh,
//   one over column tiles writes dv and dvb. Neither uses atomics.
// - To give the card enough blocks, each pass also splits its inner loop
//   (columns for the forward and dh, rows for dv) into a few ranges; each
//   (tile, range) block writes a partial, and a small launch adds the
//   partials in a fixed order. Repeated runs give identical bits.
// - The TPU pads D to 128 lanes and needs B divisible by its row tile.
//   Here any B >= 1 and 1 <= D <= 128 are taken as they are: tiles are
//   zero-filled past B and past D, and the ragged edges are masked.
//
// Tiles: 64 rows x 64 columns, 256 threads, each a 4 x 4 register sub-tile
// of the logits fed by float4 reads of k-major shared-memory copies of h
// and v. f32 on the CUDA cores throughout (no TF32): expf/logf, FMA.
//
// Bound at the main path's B = 4096, D = 80: the forward's matmul is
// 2.B^2.D = 2.68 GFLOP, ~40 us at 67 TFLOP/s f32; the backward's
// recompute, dh and dv are 6.B^2.D = 8.05 GFLOP, ~120 us (this design
// recomputes the logits twice: 8.B^2.D). Inputs are ~1.3 MB each, so both
// are bound by operations, not bytes.

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

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
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

// dlog of one logit (0 where dropped or outside the batch).
__device__ __forceinline__ float dlogit(float x, bool keep, bool diag, float lse_r, float g_r) {
  if (!keep) return 0.0f;
  return g_r * (expf(x - lse_r) - (diag ? 1.0f : 0.0f));
}

// Backward, dh: block (row tile, column range) -> partial dh of its rows.
__global__ void __launch_bounds__(kThreads) softmax_ce_dh_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long* pos_c = reinterpret_cast<long long*>(smem);
  float* vbq_c = smem + 2 * kTile;
  float* HT = smem + kHeader;
  float* VT = HT + a.D * kLd;
  float* VR = VT + a.D * kLd;
  float* DT = VR + kTile * a.DP;  // dlog, k-major over columns: DT[c][r]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r0 = blockIdx.x * kTile;
  load_tile<false>(a.h, r0, a, HT, nullptr);
  int rr[4];
  long long prow[4];
  float lse_r[4], g_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = r0 + ty * 4 + i;
    const bool in = rr[i] < a.B;
    prow[i] = in ? a.pos[rr[i]] : 0;
    lse_r[i] = in ? a.lse[rr[i]] : 0.0f;
    g_r[i] = in ? a.g[rr[i]] : 0.0f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  const int t0 = blockIdx.y * a.per_split, t1 = min(t0 + a.per_split, a.tiles);
  for (int t = t0; t < t1; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    load_tile<true>(a.v, c0, a, VT, VR);
    if (threadIdx.x < kTile) {
      const int c = c0 + threadIdx.x;
      pos_c[threadIdx.x] = c < a.B ? a.pos[c] : 0;
      vbq_c[threadIdx.x] = c < a.B ? a.vbq[c] : 0.0f;
    }
    __syncthreads();
    float sc[4][4];
    logit_tile(HT, VT, a.D, ty, tx, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx * 4 + j, c = c0 + cl;
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool diag = c == rr[i];
        const bool keep = rr[i] < a.B && c < a.B && (diag || pos_c[cl] != prow[i]);
        dl[i] = dlogit(sc[i][j] + vbq_c[cl], keep, diag, lse_r[i], g_r[i]);
      }
      *reinterpret_cast<float4*>(DT + cl * kLd + ty * 4) = make_float4(dl[0], dl[1], dl[2], dl[3]);
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(DT + c * kLd + ty * 4);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d0 = tx * 4 + 64 * jj;
        if (d0 >= a.DP) continue;
        const float4 b4 = *reinterpret_cast<const float4*>(VR + c * a.DP + d0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][jj * 4 + q] = fmaf(comp(d4, i), comp(b4, q), acc[i][jj * 4 + q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rr[i] >= a.B) continue;
    float* out = a.p0 + ((size_t)blockIdx.y * a.B + rr[i]) * a.D;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = tx * 4 + 64 * jj + q;
        if (d < a.D) out[d] = acc[i][jj * 4 + q];
      }
  }
}

// Backward, dv and dvb: block (column tile, row range) -> partial dv and
// dvb of its columns.
__global__ void __launch_bounds__(kThreads) softmax_ce_dv_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long* pos_r = reinterpret_cast<long long*>(smem);
  float* lse_s = smem + 2 * kTile;
  float* g_s = lse_s + kTile;
  float* HT = smem + kHeader;
  float* VT = HT + a.D * kLd;
  float* HR = VT + a.D * kLd;
  float* D2 = HR + kTile * a.DP;  // dlog, k-major over rows: D2[r][c]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int c0 = blockIdx.x * kTile;
  load_tile<false>(a.v, c0, a, VT, nullptr);
  int cc[4];
  long long pcol[4];
  float vb_c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cc[j] = c0 + tx * 4 + j;
    const bool in = cc[j] < a.B;
    pcol[j] = in ? a.pos[cc[j]] : 0;
    vb_c[j] = in ? a.vbq[cc[j]] : 0.0f;
  }
  float acc[4][8], dvb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dvb[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  }
  const int t0 = blockIdx.y * a.per_split, t1 = min(t0 + a.per_split, a.tiles);
  for (int t = t0; t < t1; ++t) {
    const int r0 = t * kTile;
    __syncthreads();
    load_tile<true>(a.h, r0, a, HT, HR);
    if (threadIdx.x < kTile) {
      const int r = r0 + threadIdx.x;
      const bool in = r < a.B;
      pos_r[threadIdx.x] = in ? a.pos[r] : 0;
      lse_s[threadIdx.x] = in ? a.lse[r] : 0.0f;
      g_s[threadIdx.x] = in ? a.g[r] : 0.0f;
    }
    __syncthreads();
    float sc[4][4];
    logit_tile(HT, VT, a.D, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = r0 + rl;
      float dl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool diag = cc[j] == r;
        const bool keep = r < a.B && cc[j] < a.B && (diag || pcol[j] != pos_r[rl]);
        dl[j] = dlogit(sc[i][j] + vb_c[j], keep, diag, lse_s[rl], g_s[rl]);
      }
      *reinterpret_cast<float4*>(D2 + rl * kLd + tx * 4) = make_float4(dl[0], dl[1], dl[2], dl[3]);
    }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(D2 + r * kLd + ty * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) dvb[i] += comp(d4, i);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d0 = tx * 4 + 64 * jj;
        if (d0 >= a.DP) continue;
        const float4 b4 = *reinterpret_cast<const float4*>(HR + r * a.DP + d0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][jj * 4 + q] = fmaf(comp(d4, i), comp(b4, q), acc[i][jj * 4 + q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= a.B) continue;
    float* out = a.p0 + ((size_t)blockIdx.y * a.B + c) * a.D;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = tx * 4 + 64 * jj + q;
        if (d < a.D) out[d] = acc[i][jj * 4 + q];
      }
    if (tx == 0) a.p1[(size_t)blockIdx.y * a.B + c] = dvb[i];
  }
}

// out[e] = sum over splits of part[split][e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, size_t n,
                                  float* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * n + e];
    out[e] = s;
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (kHeader + 2 * (size_t)D * kLd); }

size_t bwd_smem(int D) {
  const int DP = (D + 3) / 4 * 4;
  return sizeof(float) * (kHeader + 2 * (size_t)D * kLd + (size_t)kTile * DP + kTile * kLd);
}

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

void launch_sum(const float* part, int splits, size_t n, float* out, cudaStream_t stream) {
  size_t blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, splits, n, out);
}

}  // namespace

extern "C" {

int trs_softmax_ce_max_dim() { return kMaxDim; }

// Column (forward, dh) or row (dv) ranges per tile for a batch of B: the
// partial buffers the wrapper allocates are this many (B,) or (B, D) slabs.
int trs_softmax_ce_splits(int B) { return B < 1 ? 0 : splits_of(B); }

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
// cotangent g (B,) f32; part: splits * B * (2 * D + 1) floats of scratch;
// dh, dv: (B, D) f32; dvb: (B,) f32. Returns a cudaError_t.
int trs_softmax_ce_bwd(const float* h, const float* v, const float* vbq, const long long* pos,
                       const float* lse, const float* g, int B, int D, float* part, float* dh,
                       float* dv, float* dvb, cudaStream_t stream) {
  if (B < 1 || D < 1 || D > kMaxDim) return cudaErrorInvalidValue;
  Args a = make_args(h, v, vbq, pos, lse, g, B, D);
  const int splits = splits_of(B);
  const size_t bd = (size_t)B * D;
  float* part_dh = part;
  float* part_dv = part + (size_t)splits * bd;
  float* part_dvb = part + 2 * (size_t)splits * bd;
  const size_t smem = bwd_smem(D);
  cudaError_t e = allow_smem((const void*)softmax_ce_dh_kernel, smem);
  if (e == cudaSuccess) e = allow_smem((const void*)softmax_ce_dv_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.tiles, splits);
  a.p0 = part_dh;
  softmax_ce_dh_kernel<<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.p0 = part_dv;
  a.p1 = part_dvb;
  softmax_ce_dv_kernel<<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  launch_sum(part_dh, splits, bd, dh, stream);
  launch_sum(part_dv, splits, bd, dv, stream);
  launch_sum(part_dvb, splits, (size_t)B, dvb, stream);
  return cudaGetLastError();
}

}  // extern "C"
