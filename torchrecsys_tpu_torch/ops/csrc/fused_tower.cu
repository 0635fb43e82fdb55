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
// to the order of f32 sums. Any R, Din, Dout >= 1 run: tiles are zero-filled
// past each edge and the edges masked; a padded row's h is 0, not bn(0).
//
// The TPU grid walks its row tiles in order and carries s, ss, dW, db and
// the BN sums across them in VMEM. Blocks here run in no order, so every
// block writes its partial sums (a row tile's column sums; a row range's dW
// and db) and one launch adds the partials in a fixed order. No atomics:
// two runs give the same bits.
//
// Forward. Bound at the main path (R = 16,384 rows; layer 0 160 -> 1024, layer
// 1 1024 -> 128 with BN): 2.R.Din.Dout operations (5.4 / 4.3 GFLOP, ~5.4 /
// 4.3 us at 989 TFLOP/s bf16) against x, W, z and the sums moved once
// (39.2 / 38.0 MB, ~11.7 / 11.3 us at 3.35 TB/s): bound by bytes, and at
// layer 0 by z (33.5 MB). One product launch and one sum launch:
// - A block owns a 128-row tile (two warpgroups of 64 rows) and walks the
//   output column tiles of 128 in order; wgmma m64n64k16 (two per k16
//   step, f32 accumulators) reads h K-major and W MN-major (the transpose
//   16-bit types allow), so W is staged as stored, from 128-byte-swizzled
//   tiles fed by cp.async rings.
// - Din <= 192 (layer 0): the row tile's x (128 x 160 bf16 = 40 KB, padded
//   to 48) is staged once and serves every column tile; W's slab for one
//   column tile (Din x 128, L2-resident) streams through a 2-slot ring,
//   loaded under the previous tile's epilogue. Wider inputs (layer 1)
//   stream x with W in 64-deep steps through a 5-slot ring, one block per
//   row tile: 128 blocks of 16 steps, loads four steps ahead.
// - With BN, h = relu(bn(x)) is formed in place in shared memory, once per
//   element (the resident tile once; a streamed step one step ahead, under
//   the products), in bf16x2 arithmetic that rounds where bn_y does; padded
//   rows and columns stay 0. The step's BN rows arrive with its x. The f32
//   form of that chain spends four conversions per element, which the card
//   runs at a quarter of its f32 rate.
// - The epilogue forms z = bf16(bf16(acc) + b) (one packed conversion and
//   one bf16x2 add per pair) into a staged tile whose rows are padded to
//   272 bytes (conflict-free), sends each row out as one bulk copy on the
//   copy engine (asynchronous: it runs under the next tile's loads and
//   products), and sums z and bf16(z * z) per column from the staged tile
//   in a fixed order; each row tile's sums go to its slab, added in
//   row-tile order by the sum launch. Where the rows fill less than a wave
//   (R < 16,384), the column tiles are split across blocks.
//
// Backward. Bound at the main path (R = 16,384 paired rows; layer 0
// 160 -> 1024, layer 1 1024 -> 128 with BN): 4.R.Din.Dout operations (10.7 /
// 8.6 GFLOP, ~11 / 9 us at 989 TFLOP/s bf16) against x, z, dz, din and f32
// dW moved once (79 / 76 MB, ~23.5 / 22.8 us at 3.35 TB/s): bound by bytes.
// Two product launches and one sum launch:
// - dh (din and the BN sums): a block tile of 128 rows x 128 input columns,
//   k over Dout in 64-deep steps. dz, z, W and the step's (ds, dss) arrive
//   by cp.async in a 2-stage ring (~100 KB: two blocks per SM, so one
//   block's loads and BN epilogue overlap the other's products); dz' is
//   formed in place, once per element, while the previous step's products
//   run, and both operands are K-major as stored, so wgmma m64n128k16 reads
//   them through 128-byte-swizzled descriptors. The block's x tile is
//   staged by 16-byte copies under the last step's products, and the BN
//   rows come from shared memory.
// - dW and db: a block tile of 128 input x 128 output columns, k over a
//   range of rows (8 / 16 ranges: about one wave of 132 SMs), in a 4-stage
//   ring (loads three steps ahead) where the range is long. x, dz and z are
//   staged row-major as stored; h (BN, ReLU) and dz' are formed in place
//   with the thread's column scalars held in registers, and wgmma
//   m64n64k16 reads both transposed (MN-major), so nothing is transposed by
//   scalar stores.
// - The wgmma accumulators stay in registers; each row range writes one f32
//   dW slab (8 x 0.66 MB / 16 x 0.52 MB) that the sum launch adds in range
//   order with db and the BN row-tile sums.
// - Bytes: the products do not share their staging (fusing them would hold
//   a 128-row tile of dz' for all of Dout = 1024, 256 KB, past one block's
//   227 KB), so dz and z are read by both launches, and by each 128-column
//   tile of the other side from L2: ~150 / ~135 MB from device memory at
//   the main path, about twice the bound. Rows of other widths than a
//   multiple of 8 (e.g. 26-byte rows) have no 16-byte copies; they are
//   staged by plain loads into the same layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

// Eight values (exact bf16) into one 16-byte shared store.
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

struct BnCol {
  float mean, inv, scale, bias;
};

// The pre-ReLU value y and xhat of one input, each step rounded to bf16.
__device__ __forceinline__ float bn_y(float x, const BnCol& p, float& xhat) {
  xhat = rbf(__fmul_rn(rbf(__fsub_rn(x, p.mean)), p.inv));
  return rbf(__fadd_rn(rbf(__fmul_rn(xhat, p.scale)), p.bias));
}

// Sum over the 8 lanes of a fragment column (same t): a butterfly, so every
// lane holds the same bits.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

// ---------------------------------------------------------------------------
// Backward: both products on wgmma, fed by a 4-stage cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kWK = 64;          // k step: 64 bf16 = one 128-byte swizzle row
constexpr int kWThreads = 256;   // two warpgroups, 64 rows of the block tile each
constexpr int kTile = 128;       // block tile: 128 x 128 outputs
constexpr int kWave = 132;       // one block per SM
constexpr int kDhStage = 50176;  // dz/dz' 16 KB, z 16 KB, W 16 KB, (ds, dss) of 64 columns; 1024-aligned
constexpr int kDwStage = 49152;  // x/h 16 KB, dz/dz' 16 KB, z 16 KB

struct BwdArgs {
  const bf16* x;
  const bf16* z;
  const bf16* dz;
  const bf16* w;
  const bf16* bn;
  const float* dstat;  // ds (Dout,), then dss (Dout,)
  int R, Din, Dout, has_bn;
  int vec;             // rows 16-byte aligned: cp.async; else plain loads
  int rows_per_split;  // dW: a multiple of kWK
  bf16* din;
  float* part_bn;  // (row tiles, 4, Din)
  float* part_dw;  // (splits, Din, Dout)
  float* part_db;  // (splits, Dout)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c8 (0..7) of 128-byte row ``row`` in the
// 128-byte swizzle that wgmma's SWIZZLE_128B descriptors read: chunk index
// XOR (row mod 8), in 1024-byte atoms of 8 rows.
__device__ __forceinline__ int sw128(int row, int c8) { return row * 128 + ((c8 ^ (row & 7)) << 4); }

// A shared-memory matrix descriptor, 128-byte swizzle. lbo: bytes between
// 64-element blocks along MN (MN-major; unused for K-major); sbo: bytes
// between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B on one warpgroup: m64n128k16, both operands K-major.
__device__ __forceinline__ void wgmma_128_kk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
       "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
       "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B on one warpgroup: m64n64k16, both operands MN-major
// (the transposed form 16-bit types allow).
__device__ __forceinline__ void wgmma_64_mn(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Row r, columns c..c+7 of a row-major (rows x cols) bf16 matrix into the 16
// shared bytes at dst, zero outside: one 16-byte cp.async where rows are
// 16-byte aligned (then cols % 8 == 0 and a chunk is all in or all out),
// else eight plain loads (any shape, e.g. 26-byte rows).
__device__ __forceinline__ void load_chunk(uint8_t* dst, const bf16* __restrict__ m, int rows, int cols, int r,
                                           int c, bool vec) {
  if (vec) {
    const bool in = r < rows && c < cols;
    cp16(dst, in ? m + (size_t)r * cols + c : m, in);
    return;
  }
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (r < rows && c + j < cols) ? __bfloat162float(m[(size_t)r * cols + c + j]) : 0.0f;
  store8(reinterpret_cast<bf16*>(dst), v);
}

// Four floats f[c..c+3] (n of them) into dst, zero past n.
__device__ __forceinline__ void load_f4(float* dst, const float* __restrict__ f, int n, int c, bool vec) {
  if (vec) {
    cp16(dst, c < n ? f + c : f, c < n);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = c + j < n ? f[c + j] : 0.0f;
}

__device__ __forceinline__ void read8(const uint8_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack2(u.x, v[0], v[1]);
  unpack2(u.y, v[2], v[3]);
  unpack2(u.z, v[4], v[5]);
  unpack2(u.w, v[6], v[7]);
}

// Eight floats from 32-byte-aligned shared memory: two 16-byte loads.
__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p), hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// dz' = bf16(dz + ds + 2 z dss) of one chunk in place (f32 arithmetic,
// no FMA contraction, one rounding); 0 outside the matrix. ds, dss: the
// chunk's eight columns, in registers.
__device__ __forceinline__ void dzp_chunk(uint8_t* pdz, const uint8_t* pz, const float (&ds)[8],
                                          const float (&dss)[8], bool row_in, int col, int cols, float (&v)[8]) {
  float dz[8], z[8];
  read8(pdz, dz);
  read8(pz, z);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (row_in && col + j < cols)
               ? rbf(__fadd_rn(__fadd_rn(dz[j], ds[j]), __fmul_rn(__fmul_rn(2.0f, z[j]), dss[j])))
               : 0.0f;
  store8(reinterpret_cast<bf16*>(pdz), v);
}

// The layer's BN rows (mean, inv, scale, bias) of columns c0..c0+127 as
// floats, zero past Din.
__device__ __forceinline__ void load_bn(float* bnp, const BwdArgs& a, int c0) {
  for (int e = threadIdx.x; e < 4 * kTile; e += kWThreads) {
    const int k = e / kTile, c = c0 + e % kTile;
    bnp[e] = c < a.Din ? __bfloat162float(a.bn[(size_t)k * a.Din + c]) : 0.0f;
  }
}

// Product 1: din over a block tile of 128 rows x 128 input columns, K =
// Dout. A = dz' (rows x Dout, K-major) formed in place in the ring from
// dz, z and the step's (ds, dss); B = W's rows (Din x Dout: K-major as
// stored). Epilogue: bf16(dh), the BN backward against the x tile staged
// in shared memory, and the tile's four column sums.
template <int S>
__global__ void __launch_bounds__(kWThreads, 2) fused_tower_bwd_dh_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* bnp = reinterpret_cast<float*>(ring + S * kDhStage);  // 4 x 128
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int ksteps = (a.Dout + kWK - 1) / kWK;
  const bool vec = a.vec;

  auto load_step = [&](int ks) {
    uint8_t* st = ring + (ks % S) * kDhStage;
    const int k0 = ks * kWK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * kWThreads, row = e >> 3, c8 = e & 7, off = sw128(row, c8);
      load_chunk(st + off, a.dz, a.R, a.Dout, r0 + row, k0 + 8 * c8, vec);
      load_chunk(st + 16384 + off, a.z, a.R, a.Dout, r0 + row, k0 + 8 * c8, vec);
      load_chunk(st + 32768 + off, a.w, a.Din, a.Dout, n0 + row, k0 + 8 * c8, vec);
    }
    if (tid < 32) {
      float* f = reinterpret_cast<float*>(st + 49152);
      const int half = tid >> 4, c = 4 * (tid & 15);
      load_f4(f + 64 * half + c, a.dstat + (size_t)half * a.Dout, a.Dout, k0 + c, vec);
    }
  };

  // the block's x tile (128 rows x 128 columns, 256-byte rows, chunks XOR
  // row mod 8) into stage ``s`` of the ring, for the BN epilogue
  auto load_x = [&](int s) {
    uint8_t* xs = ring + s * kDhStage;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + j * kWThreads, row = e >> 4, c16 = e & 15;
      load_chunk(xs + row * 256 + ((c16 ^ (row & 7)) << 4), a.x, a.R, a.Din, r0 + row, n0 + 8 * c16, vec);
    }
  };
  auto transform = [&](int ks) {  // dz' in place, once per element
    uint8_t* st = ring + (ks % S) * kDhStage;
    const float* dsf = reinterpret_cast<const float*>(st + 49152);
    const int c8 = tid & 7;  // the same 8 columns in each of this thread's chunks
    float ds[8], dss[8];
    load8f(dsf + 8 * c8, ds);
    load8f(dsf + 64 + 8 * c8, dss);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid + j * kWThreads) >> 3, off = sw128(row, c8);
      float v[8];
      dzp_chunk(st + off, st + 16384 + off, ds, dss, r0 + row < a.R, ks * kWK + 8 * c8, a.Dout, v);
    }
  };

  if (a.has_bn) load_bn(bnp, a, n0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ksteps) load_step(s);
    cp_commit();
  }
  cp_wait<S - 2>();
  __syncthreads();
  transform(0);
  fence_async();
  __syncthreads();
  fence_acc(acc);
  for (int ks = 0; ks < ksteps; ++ks) {
    uint8_t* st = ring + (ks % S) * kDhStage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)
      wgmma_128_kk(acc, make_desc(st + wg * 8192 + kk * 32, 16, 1024), make_desc(st + 32768 + kk * 32, 16, 1024), 1);
    wg_commit();
    wg_wait<1>();  // this warpgroup's products of step ks - 1 are done
    if (ks + 1 == ksteps && a.has_bn) {
      // the last step multiplies: stage the epilogue's x tile into the
      // stage after it (free once every product of step ks - 1 is done)
      __syncthreads();
      load_x((ks + 1) % S);
      cp_commit();
    }
    if (ks + 1 < ksteps) {
      // while step ks multiplies: refill the stage of step ks - 1, then
      // form dz' of step ks + 1
      __syncthreads();
      if (ks + S - 1 < ksteps) load_step(ks + S - 1);
      cp_commit();
      cp_wait<S - 2>();
      __syncthreads();
      transform(ks + 1);
      fence_async();
      __syncthreads();
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  cp_wait<0>();
  __syncthreads();  // the x tile is in; the rest of the ring is free

  const uint8_t* xs = ring + (ksteps % S) * kDhStage;
  float* red = reinterpret_cast<float*>(ring + ((ksteps + 1) % S) * kDhStage);  // 4 sums x 8 warps x 128
  const bool pair_store = vec;  // Din even and rows 4-byte aligned
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float sums[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[q][e] = 0.0f;
    const int cl = 8 * j + 2 * tq, col = n0 + cl;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 64 * wg + 16 * (warp & 3) + g + 8 * hh, r = r0 + rl;
      float d[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float dh = rbf(acc[4 * j + 2 * hh + q]);
        d[q] = dh;
        if (a.has_bn && r < a.R && col + q < a.Din) {
          const BnCol p{bnp[cl + q], bnp[kTile + cl + q], bnp[2 * kTile + cl + q], bnp[3 * kTile + cl + q]};
          const bf16* xp = reinterpret_cast<const bf16*>(xs + rl * 256 + (((cl >> 3) ^ (rl & 7)) << 4)) + (cl & 7);
          const float x = __bfloat162float(xp[q]);
          float xhat;
          const float y = bn_y(x, p, xhat);
          const float dy = y > 0.0f ? dh : 0.0f;
          const float dys = __fmul_rn(dy, p.scale);
          d[q] = __fmul_rn(dys, p.inv);
          sums[q][0] += __fmul_rn(dy, xhat);
          sums[q][1] += dy;
          sums[q][2] += __fmul_rn(__fmul_rn(-dy, p.scale), p.inv);
          sums[q][3] += __fmul_rn(dys, __fsub_rn(x, p.mean));
        }
      }
      if (r < a.R) {
        bf16* out = a.din + (size_t)r * a.Din + col;
        if (pair_store && col + 1 < a.Din) {
          *reinterpret_cast<uint32_t*>(out) = pack2(d[0], d[1]);
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (col + q < a.Din) out[q] = __float2bfloat16_rn(d[q]);
        }
      }
    }
    if (a.has_bn) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = col_sum(sums[q][e]);
          if (g == 0) red[(e * 8 + warp) * kTile + cl + q] = v;
        }
    }
  }
  if (!a.has_bn) return;
  __syncthreads();
  if (tid < kTile && n0 + tid < a.Din) {
    float* out = a.part_bn + (size_t)blockIdx.y * 4 * a.Din + n0 + tid;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[(e * 8 + w) * kTile + tid];
      out[(size_t)e * a.Din] = s;
    }
  }
}

// Product 2: dW over a block tile of 128 input x 128 output columns, K = a
// range of rows, and db. A = h^T, B = dz', both MN-major: the x, dz and z
// row tiles are staged as stored (64 rows of 2 x 64 columns) and wgmma
// reads them transposed. h (BN and ReLU; 0 on rows outside the range) and
// dz' are formed in place, once per element.
template <int S>
__global__ void __launch_bounds__(kWThreads, S == 2 ? 2 : 1) fused_tower_bwd_dw_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* bnp = reinterpret_cast<float*>(ring + S * kDwStage);  // 4 x 128 (input columns)
  float* dsp = bnp + 4 * kTile;                                       // 2 x 128 (output columns)
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int o0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * a.rows_per_split, ke = min(kb + a.rows_per_split, a.R);
  const int ksteps = (ke - kb + kWK - 1) / kWK;
  const bool vec = a.vec;
  const int c16 = tid & 15;  // this thread's 8-column chunk in every step
  // this chunk's (ds, dss) and BN rows, in registers for the whole k loop
  float db[8], ds[8], dss[8], bnr[4][8];

  auto load_step = [&](int ks) {
    uint8_t* st = ring + (ks % S) * kDwStage;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * kWThreads, row = e >> 4, r = kb + ks * kWK + row;
      const int off = (c16 >> 3) * 8192 + sw128(row, c16 & 7);
      load_chunk(st + off, a.x, ke, a.Din, r, i0 + 8 * c16, vec);
      load_chunk(st + 16384 + off, a.dz, ke, a.Dout, r, o0 + 8 * c16, vec);
      load_chunk(st + 32768 + off, a.z, ke, a.Dout, r, o0 + 8 * c16, vec);
    }
  };

  if (a.has_bn) load_bn(bnp, a, i0);
  for (int e = tid; e < 2 * kTile; e += kWThreads) {
    const int k = e / kTile, c = o0 + e % kTile;
    dsp[e] = c < a.Dout ? a.dstat[(size_t)k * a.Dout + c] : 0.0f;
  }
  auto transform = [&](int ks) {  // h and dz' in place, once per element; db
    uint8_t* st = ring + (ks % S) * kDwStage;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * kWThreads, row = e >> 4, r = kb + ks * kWK + row;
      const int off = (c16 >> 3) * 8192 + sw128(row, c16 & 7);
      float v[8];
      dzp_chunk(st + 16384 + off, st + 32768 + off, ds, dss, r < ke, o0 + 8 * c16, a.Dout, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) db[q] += v[q];
      if (a.has_bn && r < ke) {
        read8(st + off, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int cl = 8 * c16 + q;
          if (i0 + cl >= a.Din) break;
          const BnCol p{bnr[0][q], bnr[1][q], bnr[2][q], bnr[3][q]};
          float xhat;
          const float y = bn_y(v[q], p, xhat);
          v[q] = y > 0.0f ? y : 0.0f;
        }
        store8(reinterpret_cast<bf16*>(st + off), v);
      }
    }
  };
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) db[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ksteps) load_step(s);
    cp_commit();
  }
  cp_wait<S - 2>();
  __syncthreads();  // bnp, dsp and step 0
  load8f(dsp + 8 * c16, ds);
  load8f(dsp + kTile + 8 * c16, dss);
#pragma unroll
  for (int k = 0; k < 4; ++k) load8f(bnp + k * kTile + 8 * c16, bnr[k]);
  transform(0);
  fence_async();
  __syncthreads();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  for (int ks = 0; ks < ksteps; ++ks) {
    uint8_t* st = ring + (ks % S) * kDwStage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      const uint64_t da = make_desc(st + wg * 8192 + kk * 2048, 8192, 1024);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        wgmma_64_mn(acc[nb], da, make_desc(st + 16384 + nb * 8192 + kk * 2048, 8192, 1024), 1);
    }
    wg_commit();
    wg_wait<1>();
    if (ks + 1 < ksteps) {
      __syncthreads();
      if (ks + S - 1 < ksteps) load_step(ks + S - 1);
      cp_commit();
      cp_wait<S - 2>();
      __syncthreads();
      transform(ks + 1);
      fence_async();
      __syncthreads();
    }
  }
  wg_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  __syncthreads();  // the ring is free for the db reduction

  const size_t split = blockIdx.z;
  float* out = a.part_dw + split * a.Din * a.Dout;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = i0 + 64 * wg + 16 * (warp & 3) + g + 8 * hh;
        const int n = o0 + 64 * nb + 8 * j + 2 * tq;
        if (m >= a.Din) continue;
        const float v0 = acc[nb][4 * j + 2 * hh], v1 = acc[nb][4 * j + 2 * hh + 1];
        float* p = out + (size_t)m * a.Dout + n;
        if (vec && n + 1 < a.Dout) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (n < a.Dout) p[0] = v0;
          if (n + 1 < a.Dout) p[1] = v1;
        }
      }
  if (blockIdx.y != 0) return;
  float* red = reinterpret_cast<float*>(ring);  // 16 row groups x 128 columns
#pragma unroll
  for (int q = 0; q < 8; ++q) red[(tid >> 4) * kTile + 8 * c16 + q] = db[q];
  __syncthreads();
  if (tid < kTile && o0 + tid < a.Dout) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) s += red[k * kTile + tid];
    a.part_db[split * a.Dout + o0 + tid] = s;
  }
}

// ---------------------------------------------------------------------------
// Forward: wgmma over a row tile that walks its output column tiles.
// ---------------------------------------------------------------------------

constexpr int kFwdResident = 192;       // widest Din whose x tile stays in shared memory
constexpr int kFwdStreamStages = 5;     // streamed steps in flight
constexpr int kFwdStreamStage = 33792;  // x 16 KB, W 16 KB, BN rows of 64 columns; 1024-aligned
constexpr int kOutRow = 272;            // bytes per staged z row: 128 bf16 and 16 of padding
constexpr int kFwdOut = kTile * kOutRow;
constexpr int kFwdRed = (8 * 2 + 1) * kTile * 4;  // the column sums' row-quarter partials; the bias

struct FwdArgs {
  const bf16* x;
  const bf16* w;
  const bf16* b;
  const bf16* bn;
  int R, Din, Dout, has_bn;
  int vec;        // rows 16-byte aligned: cp.async and 16-byte z stores; else plain
  int col_tiles;  // output column tiles per block
  bf16* out;      // z
  float* part;    // (row tile, 2, Dout)
};

// d (+)= A . B on one warpgroup: m64n64k16, A K-major (rows of x), B
// MN-major (rows of W as stored).
__device__ __forceinline__ void wgmma_64_kmn(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// bf16x2 arithmetic with an explicit .rn: each op rounds its exact result
// to bf16 once (without the modifier ptxas may fuse a mul and an add into
// one fma, which rounds once for both).
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16x2 of (lo, hi), each rounded to nearest even.
__device__ __forceinline__ uint32_t cvt2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// relu(bn(x)) of two columns in bf16x2 arithmetic. Each op rounds once, as
// bn_y's f32 op and bf16 rounding do (the f32 op on bf16 operands is exact,
// or its rounding cannot reach a bf16 tie), so h has the same bits; the
// f32 form costs a conversion per rounding, which the card runs at a
// quarter of its f32 rate.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t x, uint32_t mean, uint32_t inv, uint32_t scale, uint32_t bias) {
  return bmax2(badd2(bmul2(bmul2(bsub2(x, mean), inv), scale), bias), 0u);
}

// One row of z (``bytes``, a multiple of 16) from shared to global memory
// by the copy engine, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// This thread's bulk copies have read their source / are complete.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// h = relu(bn(x)) of one 16-byte chunk (8 columns) in place; prm: the
// columns' (mean, inv, scale, bias) rows, zero past Din, so padded columns
// stay 0.
__device__ __forceinline__ void bn_chunk(uint8_t* p, const uint4 (&prm)[4]) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  v.x = bn_relu2(v.x, prm[0].x, prm[1].x, prm[2].x, prm[3].x);
  v.y = bn_relu2(v.y, prm[0].y, prm[1].y, prm[2].y, prm[3].y);
  v.z = bn_relu2(v.z, prm[0].z, prm[1].z, prm[2].z, prm[3].z);
  v.w = bn_relu2(v.w, prm[0].w, prm[1].w, prm[2].w, prm[3].w);
  *reinterpret_cast<uint4*>(p) = v;
}

// Block (row tile of 128, group of output column tiles of 128): z of the
// tiles and each tile's partial column sums of z and bf16(z * z). Two
// warpgroups, 64 rows each; wgmma reads h K-major and W MN-major (as
// stored), both from 128-byte-swizzled tiles. RES (Din <= 192): the row
// tile's x is staged once and h formed in place once; a step is a whole
// column tile, whose W slab (Din x 128) streams through a 2-slot ring. Else
// a step is a (column tile, 64-deep k) pair: x, W and the step's BN rows
// stream through a 5-slot ring and h is formed in place one step ahead of
// the products. After a column tile's products its z goes through shared
// memory and leaves as one asynchronous bulk copy per row, which runs
// under the next tile's loads and products.
template <int KQ>
__global__ void __launch_bounds__(kWThreads, 1) fused_tower_fwd_kernel(const FwdArgs a) {
  constexpr bool RES = KQ > 0;  // KQ: the resident x tile's 64-deep chunks, 0 when streamed
  constexpr int S = RES ? 2 : kFwdStreamStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ksteps = RES ? KQ : (a.Din + kWK - 1) / kWK;
  const int kStage = RES ? KQ * 16384 : kFwdStreamStage;
  uint8_t* xres = base;  // RES: ksteps chunks of [128 rows][128 bytes]
  uint8_t* ring = base + (RES ? ksteps * 16384 : 0);
  uint8_t* outs = ring + S * kStage;  // the z tile, [128 rows][256 bytes + 16 of padding]
  float* red = reinterpret_cast<float*>(outs + kFwdOut);  // [4 row quarters][4][64 column pairs]
  bf16* bsm = reinterpret_cast<bf16*>(red + 8 * 2 * kTile);  // the column tile's bias
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * kTile;
  const int n_first = blockIdx.y * a.col_tiles;
  const int ntiles = min(a.col_tiles, (a.Dout + kTile - 1) / kTile - n_first);
  const int inner = RES ? 1 : ksteps;  // steps per column tile
  const int T = ntiles * inner;
  const bool vec = a.vec;

  auto load_step = [&](int s) {
    if (s < T) {
      uint8_t* st = ring + (s % S) * kStage;
      const int n0 = (n_first + s / inner) * kTile;
#pragma unroll
      for (int q = 0; q < (RES ? KQ : 1); ++q) {
        uint8_t* sw = RES ? st + q * 16384 : st + 16384;
        const int k0 = (RES ? q : s % inner) * kWK;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // W rows k0.., columns n0.. as two [64 k][64 n] blocks
          const int e = tid + j * kWThreads, row = e >> 4, c16 = e & 15;
          load_chunk(sw + (c16 >> 3) * 8192 + sw128(row, c16 & 7), a.w, a.Din, a.Dout, k0 + row, n0 + 8 * c16, vec);
        }
      }
      if (!RES) {
        const int k0 = (s % inner) * kWK;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // x rows r0.., columns k0..
          const int e = tid + j * kWThreads, row = e >> 3, c8 = e & 7;
          load_chunk(st + sw128(row, c8), a.x, a.R, a.Din, r0 + row, k0 + 8 * c8, vec);
        }
        if (a.has_bn && tid < 32)  // the BN rows of columns k0..k0+63
          load_chunk(st + 32768 + (tid >> 3) * 128 + (tid & 7) * 16, a.bn, 4, a.Din, tid >> 3, k0 + 8 * (tid & 7),
                     vec);
      }
    }
    cp_commit();
  };
  // STREAM: h of step s in place; this thread's 8 columns in each chunk
  auto transform = [&](int s) {
    uint8_t* st = ring + (s % S) * kStage;
    const int c8 = tid & 7;
    uint4 prm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) prm[k] = *reinterpret_cast<const uint4*>(st + 32768 + k * 128 + c8 * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid + j * kWThreads) >> 3;
      if (r0 + row < a.R) bn_chunk(st + sw128(row, c8), prm);
    }
  };
  // the column tile's z = bf16(bf16(acc) + b) (bf16x2: one rounding each,
  // as the f32 add of bf16 values and its rounding), staged in shared
  // memory (rows padded to 272 bytes: conflict-free fragment stores, and
  // each row's 256 bytes contiguous for its bulk copy), stored as whole
  // rows; then its column sums of z and bf16(z * z) from the staged tile,
  // 4 row quarters in order
  auto epilogue = [&](float (&acc)[2][32], int n) {
    const int n0 = n * kTile;
    if (tid < kTile) bulk_wait_read();  // the last tile's row copies have read the tile
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 64 * nb + 8 * j + 2 * tq;
        const uint32_t bias = *reinterpret_cast<const uint32_t*>(bsm + cl);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = 64 * wg + 16 * (warp & 3) + g + 8 * hh;
          *reinterpret_cast<uint32_t*>(outs + rl * kOutRow + cl * 2) =
              badd2(cvt2(acc[nb][4 * j + 2 * hh], acc[nb][4 * j + 2 * hh + 1]), bias);
        }
      }
    fence_async();  // the bulk copies read the tile through the async proxy
    __syncthreads();
    if (vec) {  // rows of 16-byte multiples: one bulk copy per row
      if (tid < kTile && r0 + tid < a.R) {
        bulk_store(a.out + (size_t)(r0 + tid) * a.Dout + n0, outs + tid * kOutRow, 2 * min(kTile, a.Dout - n0));
        bulk_commit();
      }
    } else {
      for (int e = tid; e < kTile * kTile; e += kWThreads) {
        const int row = e >> 7, c = e & 127;
        if (r0 + row < a.R && n0 + c < a.Dout)
          a.out[(size_t)(r0 + row) * a.Dout + n0 + c] = *reinterpret_cast<const bf16*>(outs + row * kOutRow + c * 2);
      }
    }
    {  // columns 2 cp, 2 cp + 1 over rows 32 rq .. +32 (inside R)
      const int cp = tid & 63, rq = tid >> 6;
      const int rows = min(32, a.R - r0 - 32 * rq);
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // z, z, bf16(z^2), bf16(z^2) of the two columns
      for (int i = 0; i < rows; ++i) {
        const uint32_t z = *reinterpret_cast<const uint32_t*>(outs + (32 * rq + i) * kOutRow + cp * 4);
        const uint32_t zz = bmul2(z, z);
        sum[0] += __uint_as_float(z << 16);
        sum[1] += __uint_as_float(z & 0xffff0000u);
        sum[2] += __uint_as_float(zz << 16);
        sum[3] += __uint_as_float(zz & 0xffff0000u);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) red[(rq * 4 + k) * 64 + cp] = sum[k];
    }
    __syncthreads();
    if (tid < kTile && n0 + tid < a.Dout) {
      const int cp = tid >> 1, q = tid & 1;
      float s = 0.0f, ss = 0.0f;
#pragma unroll
      for (int rq = 0; rq < 4; ++rq) {
        s += red[(rq * 4 + q) * 64 + cp];
        ss += red[(rq * 4 + 2 + q) * 64 + cp];
      }
      float* out = a.part + (size_t)blockIdx.x * 2 * a.Dout + n0 + tid;
      out[0] = s;
      out[a.Dout] = ss;
    }
  };

  if (RES) {  // the row tile's x, in the first commit group
    for (int e = tid; e < ksteps * 1024; e += kWThreads) {
      const int q = e >> 10, row = (e >> 3) & 127, c8 = e & 7;
      load_chunk(xres + q * 16384 + sw128(row, c8), a.x, a.R, a.Din, r0 + row, q * kWK + 8 * c8, vec);
    }
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load_step(s);
  cp_wait<S - 2>();
  fence_async();
  __syncthreads();
  if (a.has_bn) {
    if (RES) {
      for (int e = tid; e < ksteps * 1024; e += kWThreads) {
        const int q = e >> 10, row = (e >> 3) & 127, c8 = e & 7, col = q * kWK + 8 * c8;
        if (r0 + row >= a.R) continue;  // padded rows stay 0
        uint4 prm[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = col + 2 * i;
            const uint32_t lo = c < a.Din ? __bfloat16_as_ushort(a.bn[(size_t)k * a.Din + c]) : 0u;
            const uint32_t hi = c + 1 < a.Din ? __bfloat16_as_ushort(a.bn[(size_t)k * a.Din + c + 1]) : 0u;
            w[i] = lo | (hi << 16);
          }
          prm[k] = make_uint4(w[0], w[1], w[2], w[3]);
        }
        bn_chunk(xres + q * 16384 + sw128(row, c8), prm);
      }
    } else {
      transform(0);
    }
    fence_async();
    __syncthreads();
  }

  float acc[2][32];
  for (int n = 0, s = 0; n < ntiles; ++n) {
    if (tid < kTile) {  // read by the epilogue, after the step's barriers
      const int col = (n_first + n) * kTile + tid;
      bsm[tid] = col < a.Dout ? a.b[col] : __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.0f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    for (int kq = 0; kq < inner; ++kq, ++s) {
      if (RES) {  // this tile's W slab has landed (loaded under the last tile's epilogue)
        cp_wait<S - 2>();
        fence_async();
        __syncthreads();
      }
      const uint8_t* st = ring + (s % S) * kStage;
      wg_fence();
#pragma unroll
      for (int q = 0; q < (RES ? KQ : 1); ++q) {
        const uint8_t* xa = RES ? xres + q * 16384 : st;
        const uint8_t* wb = RES ? st + q * 16384 : st + 16384;
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk) {
          const uint64_t da = make_desc(xa + wg * 8192 + kk * 32, 16, 1024);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            wgmma_64_kmn(acc[nb], da, make_desc(wb + nb * 8192 + kk * 2048, 8192, 1024), 1);
        }
      }
      wg_commit();
      wg_wait<1>();     // this warpgroup's products of step s - 1 are done
      __syncthreads();  // everyone's: the slot of step s - 1 is free
      load_step(s + S - 1);
      if (!RES && s + 1 < T) {
        cp_wait<S - 2>();
        fence_async();
        __syncthreads();  // step s + 1 has landed
        if (a.has_bn) {
          transform(s + 1);
          fence_async();
          __syncthreads();
        }
      }
    }
    wg_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    epilogue(acc, n_first + n);
  }
  if (tid < kTile) bulk_wait_all();  // the tile stays until its row copies are done
}

// The backward's partials, each summed in slab order: the BN sums over row
// tiles (zeros without BN), dW and db over row ranges.
__global__ void fused_tower_bwd_sum_kernel(const BwdArgs a, int tiles, int splits, float* __restrict__ dbn,
                                           float* __restrict__ dw, float* __restrict__ db) {
  const size_t nbn = (size_t)4 * a.Din, nw = (size_t)a.Din * a.Dout;
  const size_t total = nbn + nw + a.Dout;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (e < nbn) {
      if (a.has_bn) {
#pragma unroll 8
        for (int k = 0; k < tiles; ++k) s += a.part_bn[(size_t)k * nbn + e];
      }
      dbn[e] = s;
    } else if (e < nbn + nw) {
#pragma unroll 8
      for (int k = 0; k < splits; ++k) s += a.part_dw[(size_t)k * nw + e - nbn];
      dw[e - nbn] = s;
    } else {
#pragma unroll 8
      for (int k = 0; k < splits; ++k) s += a.part_db[(size_t)k * a.Dout + e - nbn - nw];
      db[e - nbn - nw] = s;
    }
  }
}

// out[e] = sum over splits of part[split][e] in a fixed order: one warp
// per output, lane l adding splits l, l + 32, ... in order, then the lanes
// by a butterfly (every lane holds the same bits). A thread per output
// walking 128 row-tile slabs in turn was latency-bound.
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, size_t n,
                                  float* __restrict__ out) {
  const size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= n) return;  // uniform across the warp
  float s = 0.0f;
  for (int sp = lane; sp < splits; sp += 32) s += part[(size_t)sp * n + e];
  s = col_sum(s);  // lanes 4, 8, 16 apart
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  if (lane == 0) out[e] = s;
}

void launch_sum(const float* part, int splits, size_t n, float* out, cudaStream_t stream) {
  sum_splits_kernel<<<(unsigned)((n * 32 + 255) / 256), 256, 0, stream>>>(part, splits, n, out);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

int row_tiles(int R) { return cdiv(R, kTile); }

// Rows per dW range: a multiple of the k step, about one wave of blocks.
int rows_per_split(int R, int Din, int Dout) {
  const int tiles = cdiv(Din, kTile) * cdiv(Dout, kTile);
  const int ksteps = cdiv(R, kWK);
  int splits = kWave / tiles;
  if (splits > ksteps) splits = ksteps;
  if (splits < 1) splits = 1;
  return cdiv(ksteps, splits) * kWK;
}

// Above 48 KB a kernel's dynamic shared memory must be opted into.
cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Ring depth: two stages (~100 KB: two blocks per SM, each block's loads
// and epilogue overlapping the other's products) for dh; for dW, whose
// blocks walk long k loops with little epilogue, four (one block per SM,
// loads three steps ahead) where its k loop is long.
int dw_stages(int ksteps) { return ksteps <= 4 ? 2 : 4; }

size_t dh_smem(int S) { return 1024 + (size_t)S * kDhStage + 4 * kTile * sizeof(float); }

size_t dw_smem(int S) { return 1024 + (size_t)S * kDwStage + 6 * kTile * sizeof(float); }

template <int S>
cudaError_t launch_dh(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t e = allow_smem((const void*)fused_tower_bwd_dh_kernel<S>, dh_smem(S));
  if (e != cudaSuccess) return e;
  fused_tower_bwd_dh_kernel<S><<<dim3(cdiv(a.Din, kTile), row_tiles(a.R)), kWThreads, dh_smem(S), stream>>>(a);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_dw(const BwdArgs& a, int splits, cudaStream_t stream) {
  cudaError_t e = allow_smem((const void*)fused_tower_bwd_dw_kernel<S>, dw_smem(S));
  if (e != cudaSuccess) return e;
  fused_tower_bwd_dw_kernel<S>
      <<<dim3(cdiv(a.Dout, kTile), cdiv(a.Din, kTile), splits), kWThreads, dw_smem(S), stream>>>(a);
  return cudaGetLastError();
}

size_t fwd_smem(bool res, int Din) {
  const size_t ring = res ? 3 * (size_t)((Din + kWK - 1) / kWK) * 16384  // x and two W slabs
                          : (size_t)kFwdStreamStages * kFwdStreamStage;
  return 1024 + ring + kFwdOut + kFwdRed;
}

// Output column tiles per block: all of them when the row tiles fill a
// wave, else split so that about one wave of blocks runs.
int fwd_col_tiles(int R, int Dout) {
  const int tiles = (Dout + kTile - 1) / kTile, rows = (R + kTile - 1) / kTile;
  int groups = kWave / rows;
  if (groups < 1) groups = 1;
  if (groups > tiles) groups = tiles;
  return (tiles + groups - 1) / groups;
}

template <int KQ>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem(KQ > 0, a.Din);
  cudaError_t e = allow_smem((const void*)fused_tower_fwd_kernel<KQ>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (a.Dout + kTile - 1) / kTile;
  const dim3 grid((a.R + kTile - 1) / kTile, (tiles + a.col_tiles - 1) / a.col_tiles);
  fused_tower_fwd_kernel<KQ><<<grid, kWThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  FwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.bn = static_cast<const bf16*>(bn);
  a.R = R;
  a.Din = Din;
  a.Dout = Dout;
  a.has_bn = has_bn;
  a.vec = Din % 8 == 0 && Dout % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(z) &&
          (!has_bn || aligned16(bn));
  a.col_tiles = fwd_col_tiles(R, Dout);
  a.out = static_cast<bf16*>(z);
  a.part = part;
  cudaError_t e;
  switch (Din <= kFwdResident ? (Din + kWK - 1) / kWK : 0) {
    case 1: e = launch_fwd<1>(a, stream); break;
    case 2: e = launch_fwd<2>(a, stream); break;
    case 3: e = launch_fwd<3>(a, stream); break;
    default: e = launch_fwd<0>(a, stream); break;
  }
  if (e != cudaSuccess) return e;
  launch_sum(part, row_tiles(R), (size_t)2 * Dout, stats, stream);
  return cudaGetLastError();
}

// Backward on ``stream``. x, z, dz, w, bn as the forward's (z its output,
// dz (R, Dout) bf16 its cotangent), dstat (2, Dout) f32 = (ds, dss); part:
// the backward's scratch; din (R, Din) bf16; dw (Din, Dout), db (Dout,) and,
// when has_bn, dbn (4, Din) = (dscale, dbias, dmean, dinv) f32. Three
// launches: dh, dW, the sums. Returns a cudaError_t.
int trs_fused_tower_bwd(const void* x, const void* z, const void* dz, const void* w, const void* bn,
                        const float* dstat, int R, int Din, int Dout, int has_bn, float* part, void* din,
                        float* dw, float* db, float* dbn, cudaStream_t stream) {
  if (bad_shape(R, Din, Dout)) return cudaErrorInvalidValue;
  BwdArgs a{};
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
  a.vec = Din % 8 == 0 && Dout % 8 == 0 && aligned16(x) && aligned16(z) && aligned16(dz) && aligned16(w) &&
          aligned16(dstat) && aligned16(din);
  a.rows_per_split = rows_per_split(R, Din, Dout);
  const int splits = cdiv(R, a.rows_per_split);
  a.din = static_cast<bf16*>(din);
  float* p = part;
  if (has_bn) {
    a.part_bn = p;
    p += (size_t)row_tiles(R) * 4 * Din;
  }
  a.part_dw = p;
  a.part_db = p + (size_t)splits * Din * Dout;
  cudaError_t e = launch_dh<2>(a, stream);
  if (e != cudaSuccess) return e;
  e = dw_stages(a.rows_per_split / kWK) == 2 ? launch_dw<2>(a, splits, stream) : launch_dw<4>(a, splits, stream);
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)4 * Din + (size_t)Din * Dout + Dout;
  size_t blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  fused_tower_bwd_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a, row_tiles(R), splits, dbn, dw, db);
  return cudaGetLastError();
}

}  // extern "C"
