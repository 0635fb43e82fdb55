// One MLP tower layer for Hopper (sm_90a), forward and backward, behind a
// plain C interface (bound with ctypes in torchrecsys_tpu_torch/ops/
// fused_tower.py, built by ops/_build.py).
//
// Replaces torchrecsys_tpu/ops/fused_tower.py::_fwd_kernel (:75, called by
// _fwd_call :101) and ::_bwd_kernel (:139, called by _bwd_call :197). For R
// rows of input x (R, Din) bf16, weights W (Din, Dout) bf16, bias b (Dout,)
// bf16 and, for a layer after the first, the bf16 rows bn = (mean, inv,
// scale, bias) of the input's batch norm (4, Din):
//
//   h  = relu(bf16(bf16(bf16(bf16(x - mean) * inv) * scale) + bias))  (BN)
//      = x                                                      (no BN)
//   z  = bf16(bf16(h . W, f32 sums) + b)
//   s  = sum_r f32(z),  ss = sum_r f32(bf16(z * z))          (f32 sums)
//
// and, for cotangents dz (R, Dout) bf16 and dstat = (ds, dss) (2, Dout) f32,
//
//   dz' = bf16(dz + ds + 2 z dss)            (f32 arithmetic, then bf16)
//   dW  = h^T . dz' (f32),  db = sum_r dz' (f32),  dh = bf16(dz' . W^T)
//   BN: y = the pre-ReLU value above, dy = (y > 0) ? dh : 0,
//       din = bf16(dy * scale * inv), and the f32 column sums
//       dscale = sum dy xhat, dbias = sum dy, dmean = sum -dy scale inv,
//       dinv = sum dy scale (x - mean)
//   no BN: din = dh
//
// with every bf16 rounding where the TPU kernel rounds, so the two agree up
// to the order of f32 sums.
//
// What differs from the TPU design:
// - The TPU grid walks its row tiles in order and carries s, ss, dW, db and
//   the BN sums across them in VMEM. Blocks here run in no order, so every
//   block writes its partial sums (a row tile's column sums; a row range's
//   dW and db) and a launch adds the partials in a fixed order. No atomics:
//   two runs give the same bits.
// - The products run on the tensor cores: mma.sync m16n8k16, bf16 inputs
//   and f32 accumulators, a 128 x 128 block tile (8 warps of 32 x 64) over
//   32-deep k steps staged in shared memory. h and dz' are formed while a
//   tile is staged (BN and ReLU on x; dz' from dz, z, ds and dss) and are
//   never written to device memory: the backward recomputes h from x, as
//   the TPU kernel does.
// - The backward is two product launches over the same tiles: dh (rows x
//   Din, over Dout) with the BN epilogue, and dW (Din x Dout, over a range
//   of rows) with db, the rows split into ranges so the card has enough
//   blocks. The TPU kernel does both in one pass.
// - The TPU needs R divisible by its row tile; here any R >= 1, Din >= 1,
//   Dout >= 1 run: tiles are zero-filled past each edge, the edges masked.
//
// Bound at the main path (R = 16,384 paired rows; layer 0 160 -> 1024,
// layer 1 1024 -> 128, bf16): the forward does 2.R.Din.Dout operations
// (5.4 / 4.3 GFLOP, ~5 us at 989 TFLOP/s) and moves its inputs and z once
// (39 / 38 MB, ~12 us at 3.35 TB/s); the backward does twice the operations
// and moves x, z, dz, din and f32 dW (~79 / 76 MB, ~23 us). Every launch is
// bound by bytes. This first design re-reads tiles from L2 (x once per 128
// output columns) and writes dW partials per row range, so it moves more
// than the bound counts; PERF.md has its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;  // block tile rows (M)
constexpr int kBN = 128;  // block tile columns (N)
constexpr int kBK = 32;   // k step staged in shared memory
constexpr int kLds = kBK + 8;  // shared row stride in bf16: 80 bytes, conflict-free fragments
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 64 each
constexpr int kTargetBlocks = 264;  // two waves of 132 SMs for the dW launch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float bfv(const bf16* p) { return __bfloat162float(*p); }

// The two bf16 of a 32-bit word (low half first) as floats, and back.
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// v[j] = m[r][c + j] (row-major rows x cols), 0 outside; c is a multiple of 8.
__device__ __forceinline__ void load8(const bf16* __restrict__ m, int rows, int cols, int r, int c,
                                      float (&v)[8]) {
  const bool vec = (cols & 7) == 0 && (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  if (vec && r < rows && c < cols) {
    const uint4 u = *reinterpret_cast<const uint4*>(m + (size_t)r * cols + c);
    unpack2(u.x, v[0], v[1]);
    unpack2(u.y, v[2], v[3]);
    unpack2(u.z, v[4], v[5]);
    unpack2(u.w, v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (r < rows && c + j < cols) ? __bfloat162float(m[(size_t)r * cols + c + j]) : 0.0f;
}

// Eight values (exact bf16) into one 16-byte shared store.
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

struct BnCol {
  float mean, inv, scale, bias;
};

__device__ __forceinline__ BnCol bn_col(const bf16* __restrict__ bn, int din, int col) {
  return {bfv(bn + col), bfv(bn + din + col), bfv(bn + 2 * din + col), bfv(bn + 3 * din + col)};
}

// The pre-ReLU value y and xhat of one input, each step rounded to bf16.
__device__ __forceinline__ float bn_y(float x, const BnCol& p, float& xhat) {
  xhat = rbf(__fmul_rn(rbf(__fsub_rn(x, p.mean)), p.inv));
  return rbf(__fadd_rn(rbf(__fmul_rn(xhat, p.scale)), p.bias));
}

// h of eight inputs of one row in place (row and columns inside the matrix
// only: padding stays 0).
__device__ __forceinline__ void bn_relu8(const bf16* __restrict__ bn, int din, int c, bool row_in,
                                         float (&v)[8]) {
  if (!row_in) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c + j >= din) break;
    float xhat;
    const float y = bn_y(v[j], bn_col(bn, din, c + j), xhat);
    v[j] = y > 0.0f ? y : 0.0f;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += As (128 x 32, [m][k]) . Bs^T (Bs is 128 x 32, [n][k]) for this
// warp's 32 x 64 sub-tile. Fragment of lane (g = lane / 4, t = lane % 4):
// acc[mi][ni] = rows wm*32 + mi*16 + g (+8), columns wn*64 + ni*8 + 2t (+1).
__device__ __forceinline__ void mma_tile(const bf16 (*As)[kLds], const bf16 (*Bs)[kLds], int wm, int wn,
                                         int lane, float (&acc)[2][8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t a[2][4], b[8][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      a[mi][0] = ld32(&As[r][ks + 2 * t]);
      a[mi][1] = ld32(&As[r + 8][ks + 2 * t]);
      a[mi][2] = ld32(&As[r][ks + 2 * t + 8]);
      a[mi][3] = ld32(&As[r + 8][ks + 2 * t + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = wn * 64 + ni * 8 + g;
      b[ni][0] = ld32(&Bs[n][ks + 2 * t]);
      b[ni][1] = ld32(&Bs[n][ks + 2 * t + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
}

// Sum over the 8 lanes of a fragment column (same t): a butterfly, so every
// lane holds the same bits.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

struct Args {
  const bf16* x;
  const bf16* w;
  const bf16* b;   // forward
  const bf16* bn;
  const bf16* z;   // backward
  const bf16* dz;  // backward
  const float* dstat;  // backward: ds (Dout,), then dss (Dout,)
  int R, Din, Dout, has_bn;
  int rows_per_split;  // backward dW
  bf16* out;      // z (forward) or din (backward)
  float* part;    // forward (row tile, 2, Dout); backward BN (row tile, 4, Din)
  float* part_dw;  // (split, Din, Dout)
  float* part_db;  // (split, Dout)
};

// dz' of eight columns of one row (0 outside the matrix).
__device__ __forceinline__ void load_dzp8(const Args& a, int rows, int r, int c, float (&v)[8]) {
  float dz[8], z[8];
  load8(a.dz, rows, a.Dout, r, c, dz);
  load8(a.z, rows, a.Dout, r, c, z);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c + j;
    v[j] = 0.0f;
    if (r < rows && col < a.Dout) {
      const float ds = a.dstat[col], dss = a.dstat[a.Dout + col];
      v[j] = rbf(__fadd_rn(__fadd_rn(dz[j], ds), __fmul_rn(__fmul_rn(2.0f, z[j]), dss)));
    }
  }
}

// Forward: block (column tile, row tile) -> z of its tile and the tile's
// partial column sums of z and bf16(z * z).
__global__ void __launch_bounds__(kThreads) fused_tower_fwd_kernel(const Args a) {
  __shared__ __align__(16) bf16 As[kBM][kLds];
  __shared__ __align__(16) bf16 Bs[kBN][kLds];
  __shared__ float red[2][4][kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  float acc[2][8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < a.Din; k0 += kBK) {
    __syncthreads();
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {  // A = h, [row][k]
      const int i = c >> 2, kc = (c & 3) * 8;
      float v[8];
      load8(a.x, a.R, a.Din, r0 + i, k0 + kc, v);
      if (a.has_bn) bn_relu8(a.bn, a.Din, k0 + kc, r0 + i < a.R, v);
      store8(&As[i][kc], v);
    }
    for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {  // B = W^T, [n][k]
      const int kk = c & 31, nc = (c >> 5) * 8;
      float v[8];
      load8(a.w, a.Din, a.Dout, k0 + kk, n0 + nc, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[nc + j][kk] = __float2bfloat16_rn(v[j]);
    }
    __syncthreads();
    mma_tile(As, Bs, wm, wn, lane, acc);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cl = wn * 64 + ni * 8 + 2 * t + q, col = n0 + cl;
      const bool col_in = col < a.Dout;
      const float bias = col_in ? bfv(a.b + col) : 0.0f;
      float s = 0.0f, ss = 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + wm * 32 + mi * 16 + g + 8 * half;
          const float zf = rbf(__fadd_rn(rbf(acc[mi][ni][2 * half + q]), bias));
          if (col_in && r < a.R) {
            a.out[(size_t)r * a.Dout + col] = __float2bfloat16_rn(zf);
            s += zf;
            ss += rbf(__fmul_rn(zf, zf));
          }
        }
      }
      s = col_sum(s);
      ss = col_sum(ss);
      if (g == 0) {
        red[0][wm][cl] = s;
        red[1][wm][cl] = ss;
      }
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < a.Dout) {
    float* out = a.part + (size_t)blockIdx.y * 2 * a.Dout + n0 + tid;
    out[0] = ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) + red[0][3][tid];
    out[a.Dout] = ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) + red[1][3][tid];
  }
}

// Backward, dh and the BN epilogue: block (Din tile, row tile) -> din of its
// tile and, with BN, the tile's partial column sums (dscale, dbias, dmean,
// dinv).
__global__ void __launch_bounds__(kThreads) fused_tower_dh_kernel(const Args a) {
  __shared__ __align__(16) bf16 As[kBM][kLds];
  __shared__ __align__(16) bf16 Bs[kBN][kLds];
  __shared__ float red[4][4][kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  float acc[2][8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < a.Dout; k0 += kBK) {
    __syncthreads();
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int i = c >> 2, kc = (c & 3) * 8;
      float v[8];
      load_dzp8(a, a.R, r0 + i, k0 + kc, v);  // A = dz', [row][k = Dout]
      store8(&As[i][kc], v);
      load8(a.w, a.Din, a.Dout, n0 + i, k0 + kc, v);  // B = W, [n = Din][k = Dout]
      store8(&Bs[i][kc], v);
    }
    __syncthreads();
    mma_tile(As, Bs, wm, wn, lane, acc);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cl = wn * 64 + ni * 8 + 2 * t + q, col = n0 + cl;
      const bool col_in = col < a.Din;
      BnCol p{0.0f, 0.0f, 0.0f, 0.0f};
      if (a.has_bn && col_in) p = bn_col(a.bn, a.Din, col);
      float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + wm * 32 + mi * 16 + g + 8 * half;
          if (!col_in || r >= a.R) continue;
          const float dh = rbf(acc[mi][ni][2 * half + q]);
          float d = dh;
          if (a.has_bn) {
            const float x = bfv(a.x + (size_t)r * a.Din + col);
            float xhat;
            const float y = bn_y(x, p, xhat);
            const float dy = y > 0.0f ? dh : 0.0f;
            const float dys = __fmul_rn(dy, p.scale);
            d = __fmul_rn(dys, p.inv);
            sums[0] += __fmul_rn(dy, xhat);
            sums[1] += dy;
            sums[2] += __fmul_rn(__fmul_rn(-dy, p.scale), p.inv);
            sums[3] += __fmul_rn(dys, __fsub_rn(x, p.mean));
          }
          a.out[(size_t)r * a.Din + col] = __float2bfloat16_rn(d);
        }
      }
      if (a.has_bn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = col_sum(sums[e]);
          if (g == 0) red[e][wm][cl] = v;
        }
      }
    }
  }
  if (!a.has_bn) return;
  __syncthreads();
  if (tid < kBN && n0 + tid < a.Din) {
    float* out = a.part + (size_t)blockIdx.y * 4 * a.Din + n0 + tid;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)e * a.Din] = ((red[e][0][tid] + red[e][1][tid]) + red[e][2][tid]) + red[e][3][tid];
  }
}

// Backward, dW and db: block (Dout tile, Din tile, row range) -> the range's
// partial dW of its tile and, for the first Din tile, partial db.
__global__ void __launch_bounds__(kThreads) fused_tower_dw_kernel(const Args a) {
  __shared__ __align__(16) bf16 As[kBM][kLds];
  __shared__ __align__(16) bf16 Bs[kBN][kLds];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * a.rows_per_split;
  const int ke = min(kb + a.rows_per_split, a.R);
  float acc[2][8][4];
  zero_acc(acc);
  float dbacc[2][8];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int j = 0; j < 8; ++j) dbacc[jj][j] = 0.0f;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = tid + jj * kThreads;
      const int kk = c & 31, oc = (c >> 5) * 8;
      float v[8];
      load8(a.x, ke, a.Din, k0 + kk, m0 + oc, v);  // A = h^T, [m = Din][k = row]
      if (a.has_bn) bn_relu8(a.bn, a.Din, m0 + oc, k0 + kk < ke, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) As[oc + j][kk] = __float2bfloat16_rn(v[j]);
      load_dzp8(a, ke, k0 + kk, n0 + oc, v);  // B = dz'^T, [n = Dout][k = row]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Bs[oc + j][kk] = __float2bfloat16_rn(v[j]);
        dbacc[jj][j] += v[j];
      }
    }
    __syncthreads();
    mma_tile(As, Bs, wm, wn, lane, acc);
  }
  const size_t split = blockIdx.z;
  if (blockIdx.y == 0) {
    // the 32 lanes of a warp hold the 32 rows of one 8-column chunk
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int oc = ((tid + jj * kThreads) >> 5) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = dbacc[jj][j];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
        const int col = n0 + oc + j;
        if (lane == 0 && col < a.Dout) a.part_db[split * a.Dout + col] = v;
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
  float* out = a.part_dw + split * a.Din * a.Dout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + 8 * half;
      if (m >= a.Din) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn * 64 + ni * 8 + 2 * t + q;
          if (n < a.Dout) out[(size_t)m * a.Dout + n] = acc[mi][ni][2 * half + q];
        }
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

void launch_sum(const float* part, int splits, size_t n, float* out, cudaStream_t stream) {
  size_t blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, splits, n, out);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

int row_tiles(int R) { return cdiv(R, kBM); }

// Rows per dW range: a multiple of the k step, about kTargetBlocks blocks.
int rows_per_split(int R, int Din, int Dout) {
  const int tiles = cdiv(Din, kBM) * cdiv(Dout, kBN);
  const int ksteps = cdiv(R, kBK);
  int splits = cdiv(kTargetBlocks, tiles);
  if (splits > ksteps) splits = ksteps;
  if (splits < 1) splits = 1;
  return cdiv(ksteps, splits) * kBK;
}

bool bad_shape(int R, int Din, int Dout) {
  return R < 1 || Din < 1 || Dout < 1 || row_tiles(R) > 65535;
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs: (row tiles, 2, Dout) partial sums.
long long trs_fused_tower_fwd_scratch(int R, int Din, int Dout) {
  if (bad_shape(R, Din, Dout)) return -1;
  return (long long)row_tiles(R) * 2 * Dout;
}

// Floats of scratch the backward needs: the BN partials (row tiles, 4, Din)
// when has_bn, then (splits, Din, Dout) dW and (splits, Dout) db partials.
long long trs_fused_tower_bwd_scratch(int R, int Din, int Dout, int has_bn) {
  if (bad_shape(R, Din, Dout)) return -1;
  const long long splits = cdiv(R, rows_per_split(R, Din, Dout));
  return (has_bn ? (long long)row_tiles(R) * 4 * Din : 0) + splits * Din * Dout + splits * Dout;
}

// Forward on ``stream``. x (R, Din), w (Din, Dout), b (Dout,), bn (4, Din):
// bf16, contiguous (bn is read only when has_bn); part: the forward's
// scratch; z (R, Dout) bf16; stats (2, Dout) f32 = (s, ss). Returns a
// cudaError_t (cudaGetLastError after the launches).
int trs_fused_tower_fwd(const void* x, const void* w, const void* b, const void* bn, int R, int Din,
                        int Dout, int has_bn, float* part, void* z, float* stats, cudaStream_t stream) {
  if (bad_shape(R, Din, Dout)) return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.bn = static_cast<const bf16*>(bn);
  a.R = R;
  a.Din = Din;
  a.Dout = Dout;
  a.has_bn = has_bn;
  a.out = static_cast<bf16*>(z);
  a.part = part;
  fused_tower_fwd_kernel<<<dim3(cdiv(Dout, kBN), row_tiles(R)), kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  launch_sum(part, row_tiles(R), (size_t)2 * Dout, stats, stream);
  return cudaGetLastError();
}

// Backward on ``stream``. x, z, dz, w, bn as the forward's (z its output,
// dz (R, Dout) bf16 its cotangent), dstat (2, Dout) f32 = (ds, dss); part:
// the backward's scratch; din (R, Din) bf16; dw (Din, Dout), db (Dout,) and,
// when has_bn, dbn (4, Din) = (dscale, dbias, dmean, dinv) f32. Returns a
// cudaError_t.
int trs_fused_tower_bwd(const void* x, const void* z, const void* dz, const void* w, const void* bn,
                        const float* dstat, int R, int Din, int Dout, int has_bn, float* part, void* din,
                        float* dw, float* db, float* dbn, cudaStream_t stream) {
  if (bad_shape(R, Din, Dout)) return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.z = static_cast<const bf16*>(z);
  a.dz = static_cast<const bf16*>(dz);
  a.w = static_cast<const bf16*>(w);
  a.bn = static_cast<const bf16*>(bn);
  a.dstat = dstat;
  a.R = R;
  a.Din = Din;
  a.Dout = Dout;
  a.has_bn = has_bn;
  a.rows_per_split = rows_per_split(R, Din, Dout);
  const int splits = cdiv(R, a.rows_per_split);
  a.out = static_cast<bf16*>(din);
  float* p = part;
  if (has_bn) {
    a.part = p;
    p += (size_t)row_tiles(R) * 4 * Din;
  }
  a.part_dw = p;
  a.part_db = p + (size_t)splits * Din * Dout;
  fused_tower_dh_kernel<<<dim3(cdiv(Din, kBN), row_tiles(R)), kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_tower_dw_kernel<<<dim3(cdiv(Dout, kBN), cdiv(Din, kBM), splits), kThreads, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (has_bn) launch_sum(a.part, row_tiles(R), (size_t)4 * Din, dbn, stream);
  launch_sum(a.part_dw, splits, (size_t)Din * Dout, dw, stream);
  launch_sum(a.part_db, splits, (size_t)Dout, db, stream);
  return cudaGetLastError();
}

}  // extern "C"
