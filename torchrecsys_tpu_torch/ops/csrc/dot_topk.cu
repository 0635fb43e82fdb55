// Full-catalog score + top-k for Hopper (sm_90a): one tensor-core kernel
// and a split merge, behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/dot_topk.py, built by ops/_build.py).
//
// Replaces the two TPU kernels of torchrecsys_tpu/ops/dot_topk.py:
//   #1 _dot_topk_kernel (:136, called by dot_topk_pallas :202), k <= 16;
//   #2 _dot_topk_threshold_kernel (:362, called by dot_topk_pallas_thresh
//      :445), 16 < k <= 1024.
// Both compute, for every user u, the k best items of
//     score[u, g] = users[u] . items[g] + bias[g]
// (f32 results, int32 rows), with a masked item scoring kNegInf, in ONE
// total order: (value desc, item index asc). That order is jax.lax.top_k's
// lowest-index tie rule, and every comparison below -- gate, compaction,
// block merge, split merge -- uses it, so no merge can reorder ties (the
// CUDA twin of the Mosaic argmax trap at torchrecsys_tpu/ops/dot_topk.py:
// 98-109). Both TPU kernels become one kernel here, dot_topk_tc_kernel,
// whose per-user list length is 16 for #1 and k for #2.
//
// Any D (a multiple of 4 for f32, 8 for bf16: the wrapper zero-pads). A
// row wider than 128 lanes (the slab path) is cut into 128-byte columns
// (32 f32 or 64 bf16 lanes): a tile's column is one TMA box of 64 rows x
// 128 bytes, loaded in the 128-byte swizzle with rows past N and lanes past
// D zero-filled. Two boxes make a ring unit (8 k steps), and an odd last
// box is a narrow tail unit (4 k steps), so D = 160 f32 computes 160 lanes.
// The users' images of every unit stay resident, each in its own
// permuted-k layout; the user tile is the largest that fits (plan_slabs).
//
// Bound at the main path (U=256, N=1,000,000, D=80): 2.U.N.D = 40.96 GFLOP
// of f32-accurate products. As 3xTF32 on the tensor cores (three TF32
// products per f32 product at 495 TFLOP/s) that is 0.2482 ms; on the CUDA
// cores' f32 FMA (67 TFLOP/s) 0.6113 ms. The item stream (items + bias,
// 324 MB) takes 0.097 ms at 3.35 TB/s: bound by operations. bf16 vectors
// take one exact bf16 product per pair (989 TFLOP/s, 0.041 ms) and stream
// 164 MB (0.049 ms): bound by bytes. At D = 160 (NeuCF's item table at
// n_factors = 80): 81.92 GFLOP, 0.4965 ms of 3xTF32; the stream 0.191 ms.
//
// What the design does about it:
// - Scores run on wgmma. Items are the M operand (64-item tiles), the
//   block's users the N operand (UT = 64, 32 or 8 users). f32 runs as
//   3xTF32: x = big + small with big = x (the tensor cores read its top 19
//   bits) and small = x - tf32(x); big.big + big.small + small.big, small
//   terms first, in two accumulator chains (even and odd k steps) so that
//   two products of a warpgroup are in flight (as softmax_ce.cu's forward
//   splits). bf16 runs one m64nNk16 bf16 product per k step: exact
//   products, f32 sums.
// - Items stream from device memory once per user tile: one thread of a
//   producer warpgroup bulk-copies each tile's rows (one contiguous
//   cp.async.bulk, counted on an mbarrier) into a ring of 2 or 4 slots.
//   Each consumer warpgroup loads its tile's A fragments into registers,
//   splits them there, and frees the slot at once (after a proxy fence:
//   the next bulk copy into the slot is another proxy's write). The
//   fragments are read with 16-byte (f32) or 8-byte (bf16) shared loads
//   because the k axis is permuted: wgmma's logical k position
//   8kk + t + 4h (tf32) is physical dim t*C + 2kk + h, so lane t's dims are
//   one contiguous run of C. The users' image (formed once per block in
//   the 128-byte swizzle, big and small parts for f32) carries the same
//   permutation, so the dot products are unchanged. The producer
//   warpgroup gives its registers to the two consumer warpgroups
//   (setmaxnreg).
// - The slab path (D > 128) keeps that shape. The producer's thread loads
//   each unit of a tile with one cp.async.bulk.tensor per 128-byte box
//   from a TMA map (a __grid_constant__ parameter, encoded once per table
//   by the wrapper), which zero-fills rows past N and lanes past D and
//   lays each box row out in the 128-byte swizzle: a warp's 16-byte loads
//   (chunk c of row r at (c ^ (r & 7)) * 16) then fall on 8 distinct bank
//   groups, where plain rows of 256 or 512 bytes would put them on 1 or 2.
//   A 16 KB unit is two boxes (8 k steps, one pass); an odd last box is a
//   tail unit (4 k steps), so a row computes its width rounded up to 32
//   f32 or 64 bf16 lanes, not to 128. Each unit's products start from zero
//   and are added into registers after its pass. Every unit's user images
//   stay resident: the plan keeps the D <= 128 tiles (64 users for k <=
//   16, 32 for k <= 128) while they fit beside two ring slots, then halves
//   them, then takes the 8-user tile of one warpgroup.
// - Two warpgroups take alternate item tiles, so one's selection runs
//   under the other's products; each keeps its own per-user state and the
//   two lists are merged at the end of the block.
// - Selection is gated: a score is compared with its user's threshold
//   value (registers, one compare, no branch); only a score that ties or
//   passes takes the exact (value, index) compare against the threshold's
//   64-bit key (tiles do not arrive in index order) and is appended to the
//   user's shared buffer (position from a shared atomic: the buffer is
//   later sorted in the total order, so append order decides no result).
//   A buffer that overflows is compacted by one warp in registers (a
//   bitonic sort of 64 or 256 entries; k > 128 sorts in shared memory),
//   cut to the list length L, and the rejected entries gated again. The
//   seen mask is read only there, for the buffered entries: a seen item's
//   entry sorts as kNegInf (so masked items still fill the tail in index
//   order), and since kNegInf is below its score, gating the score as it
//   is drops nothing that belongs.
// - Thresholds are shared across blocks: each compaction publishes the
//   list's best P keys per user; after a warpgroup's 16th, 32nd, 64th, ...
//   tile it takes the L-th best of all published keys (distinct items, so
//   at least L items, and the user's k-th best, are at or above it) as a
//   lower bound. Appends then fall from ~L (1 + ln(n / L)) per (user,
//   split) to a few.
// - The catalog is cut into S tile-aligned splits, one wave of blocks
//   (user tile x split); each block writes one sorted list of L per
//   (user, split), and dot_topk_merge_kernel sorts each user's S lists
//   and keeps the first k. A memset of the published keys, the kernel and
//   the merge: three launches per call, and no atomic decides a result
//   (the published bounds only prune items that cannot be in the top k):
//   repeated calls give the same bits.
// What still holds it back (PERF.md): a call of #1 runs at about 28% of
// the 3xTF32 bound, at D = 80 and 160 alike (a 64 x 64 x 8 wgmma with A
// from registers does little work per instruction, and each warpgroup
// waits for its products before its selection and, on the slab path,
// after every unit); the selection's slow path, the compactions and the
// sorts of published keys run on the CUDA cores beside them; the 32-user
// tiles of 16 < k <= 128 do half the work per A fragment, and on the slab
// path their 256-entry buffers leave room for only two ring slots (fewer
// entries or fewer users, for four slots, measured slower). A D <= 128
// row is read unswizzled (rows of 512 bytes at D = 128 put a warp's loads
// on one bank group).

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

// np.finfo(np.float32).min: the masked/padded score of ops/dot_topk.py:36.
// Masked items still compete with this value and their index, so a user with
// fewer unseen items than k gets the masked tail in index order, as in JAX.
constexpr float kNegInf = -3.40282346638528859811704183484516925e+38f;
constexpr int kIntMax = 0x7fffffff;
constexpr int kMaskTile = 4096;             // ops/dot_topk.py:59
constexpr int kMaskWords = kMaskTile / 32;  // 128 words per mask tile
constexpr int kSlab = 128;                  // lanes up to which a row is one ring unit; wider rows take the slab path
constexpr int kTile = 64;                   // items per tile: wgmma's M
constexpr int kBoxBytes = 128;              // slab path: bytes of a TMA box's row (the 128-byte swizzle's span)
constexpr int kBoxTile = kTile * kBoxBytes; // bytes of one box: 64 rows
constexpr int kUnitK = 8;                   // slab path: k steps of a two-box ring unit (a tail unit takes 4)
constexpr int kSlabStages = 2;              // ring slots a slab-path user tile needs before a smaller tile is tried
constexpr int kConsumers = 128;             // threads of one warpgroup
constexpr int kSmemLimit = 232448;          // a block's shared memory on sm_90
constexpr int kSmallList = 16;              // entries kept per (user, split) for k <= 16
constexpr int kWideMaxK = 128;              // k up to which two warpgroups share a 32-user tile
constexpr int kRefresh = 16;                // a warpgroup's tiles before its first read of the published keys
constexpr int kMaxShared = 512;             // published keys per user that a refresh reads at most

__device__ __forceinline__ float sentinel_value() {
  return __int_as_float(0xff800000);  // -inf: loses to every real score
}

// (va, ia) strictly precedes (vb, ib) in (value desc, index asc) order.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// (value, index) as one unsigned 64-bit key that orders as the total
// order: a larger key is better. A threshold kept as one key is read and
// written whole, so a reader never sees a value with another index.
__device__ __forceinline__ unsigned long long order_key(float v, int i) {
  uint32_t b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (uint32_t)~i;
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  const uint32_t b = (uint32_t)(k >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// Packed seen-mask bit of item g: ops/dot_topk.py:62-87 layout, where item
// j of a 4096-item tile lives in word (j % 128), bit (j / 128).
__device__ __forceinline__ bool is_masked(const int* __restrict__ mrow, int g) {
  const int lg = g & (kMaskTile - 1);
  const int word = (g / kMaskTile) * kMaskWords + (lg & (kMaskWords - 1));
  const int bit = lg / kMaskWords;
  return (__ldg(mrow + word) >> bit) & 1;
}

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

// Sorts the n = 32 E entries of (v, id) that one warp holds, E per lane,
// into (value desc, index asc) order in registers (a bitonic network:
// strides below E within a lane, the others across lanes by shuffles), and
// writes back the first ``keep``. Entries at ``fill`` and past read as
// sentinels; with a mask row, a seen item's entry reads as kNegInf.
template <int E>
__device__ __forceinline__ void sort_regs(float* v, int* id, int fill, int keep, const int* mrow, int lane) {
  float x[E];
  int y[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {  // any placement: the network sorts what it holds
    const int e = 32 * r + lane;
    x[r] = e < fill ? v[e] : sentinel_value();
    y[r] = e < fill ? id[e] : kIntMax;
    if (mrow != nullptr && e < fill && is_masked(mrow, y[r])) x[r] = kNegInf;
  }
  __syncwarp();
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int e = lane * E + r;  // sorted position of x[r]
        const bool first = (e & size) == 0;  // this run is sorted better-first
        if (stride >= E) {
          const int ls = stride / E;
          const float pv = __shfl_xor_sync(0xffffffffu, x[r], ls);
          const int pi = __shfl_xor_sync(0xffffffffu, y[r], ls);
          const bool keep_better = ((lane & ls) == 0) == first;
          if (better(pv, pi, x[r], y[r]) == keep_better) {
            x[r] = pv;
            y[r] = pi;
          }
        } else if ((r & stride) == 0) {
          const int p = r | stride;
          if (better(x[p], y[p], x[r], y[r]) == first) {
            const float tv = x[r];
            const int ti = y[r];
            x[r] = x[p];
            y[r] = y[p];
            x[p] = tv;
            y[p] = ti;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = lane * E + r;
    if (e < keep) {
      v[e] = x[r];
      id[e] = y[r];
    }
  }
  __syncwarp();
}

// Sorts a candidate buffer of ``cap`` entries by one warp, those at
// ``fill`` and past read as sentinels and, with a mask row, seen items as
// kNegInf; the first ``keep`` are then in (value desc, index asc) order.
// CAP: the buffer size of the variant, held in registers (E = CAP / 32 per
// lane); 0: a runtime size (k > 128), sorted in shared memory.
template <int CAP>
__device__ __forceinline__ void sort_list(float* v, int* id, int fill, int keep, int cap, const int* mrow,
                                          int lane) {
  if constexpr (CAP > 0) {
    sort_regs<CAP / 32>(v, id, fill, keep, mrow, lane);
  } else {
    for (int e = lane; e < cap; e += 32) {
      if (e >= fill) {
        v[e] = sentinel_value();
        id[e] = kIntMax;
      } else if (mrow != nullptr && is_masked(mrow, id[e])) {
        v[e] = kNegInf;
      }
    }
    warp_sort(v, id, cap, lane);
  }
}

// The key of rank ``rank`` (0 = best) among the m keys at ``src`` (global
// memory, read past L1: other blocks write them), by one warp: a bitonic
// sort of E keys per lane in registers, descending, padded with zeros.
// Returns it in every lane.
template <int E>
__device__ __forceinline__ unsigned long long select_key_regs(const unsigned long long* src, int m, int rank,
                                                             int lane) {
  unsigned long long x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = 32 * r + lane;
    x[r] = e < m ? __ldcg(src + e) : 0ull;
  }
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int e = lane * E + r;
        const bool first = (e & size) == 0;  // this run is sorted larger-first
        if (stride >= E) {
          const int ls = stride / E;
          const unsigned long long p = __shfl_xor_sync(0xffffffffu, x[r], ls);
          const bool keep_larger = ((lane & ls) == 0) == first;
          if ((p > x[r]) == keep_larger) x[r] = p;
        } else if ((r & stride) == 0) {
          const int q = r | stride;
          if ((x[q] > x[r]) == first) {
            const unsigned long long tq = x[r];
            x[r] = x[q];
            x[q] = tq;
          }
        }
      }
    }
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (lane * E + r == rank) mine = x[r];
  return __shfl_sync(0xffffffffu, mine, rank / E);
}

__device__ __noinline__ unsigned long long select_key(const unsigned long long* src, int m, int rank, int lane) {
  const int n = next_pow2(m < 32 ? 32 : m);
  switch (n) {
    case 32: return select_key_regs<1>(src, m, rank, lane);
    case 64: return select_key_regs<2>(src, m, rank, lane);
    case 128: return select_key_regs<4>(src, m, rank, lane);
    case 256: return select_key_regs<8>(src, m, rank, lane);
    default: return select_key_regs<16>(src, m, rank, lane);
  }
}

// ---------------------------------------------------------------------------
// Hopper primitives: shared-memory descriptors, wgmma, mbarriers, bulk
// copies, named barriers.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int NR>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A . B on one warpgroup, m64nNk8 tf32 (N = 2 NA): A (64 items x 8)
// from registers (rows 16 w + g (+8), k t (+4) of warp w), B (N users x 8,
// K-major) from shared memory.
#define TRS_WGMMA_TF32_TAIL "p, 1, 1;\n}\n"
#define TRS_WGMMA_BF16_TAIL "p, 1, 1, 0;\n}\n"

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc, float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, " TRS_WGMMA_TF32_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc, float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, " TRS_WGMMA_TF32_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc, float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, " TRS_WGMMA_TF32_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int acc, float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, " TRS_WGMMA_TF32_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The same, m64nNk16 bf16 (A: 4 registers of two bf16 each, rows g (+8), k
// 2t, 2t+1 (+8)).
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc,
                                      __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, " TRS_WGMMA_BF16_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc,
                                      __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, " TRS_WGMMA_BF16_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc,
                                      __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, " TRS_WGMMA_BF16_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int acc,
                                      __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, " TRS_WGMMA_BF16_TAIL
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef TRS_WGMMA_TF32_TAIL
#undef TRS_WGMMA_BF16_TAIL

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

// One contiguous copy of ``bytes`` (a multiple of 16) from global to shared
// memory by the copy engine, counted on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// One TMA box of ``map`` (a __grid_constant__ parameter: the copy engine
// reads the map there) at element column x, row y, into shared memory at
// ``dst``, counted on ``bar``. Lanes and rows outside the tensor arrive as
// zeros and count as bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Named barriers: 3 + wg synchronises one warpgroup, 5 the two consumer
// warpgroups.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A barrier of one warpgroup (id, 128 threads) that also returns whether
// any of its threads passed ``v``.
__device__ __forceinline__ bool wg_any(int id, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(id)
      : "memory");
  return r != 0;
}

// Shared stores that wgmma (the async proxy) reads afterwards.
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// The score + selection kernel.
// ---------------------------------------------------------------------------

// Per element type: logical k per wgmma step, user images (f32: big and
// small; bf16: one), the 4-element vector a lane loads.
template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int step = 8;
  static constexpr int imgs = 2;
  using Vec = float4;
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int step = 16;
  static constexpr int imgs = 1;
  using Vec = uint2;
};

// k steps of each variant: D up to 32, 64, 80 (the reference default
// n_factors) and 128, zero-padded past D (a wider D takes the slab path).
template <typename T>
int pick_nk(int D) {
  const int s = Elt<T>::step;
  for (int dmax : {32, 64, 80})
    if (D <= dmax) return dmax / s;
  return kSlab / s;
}

// Slab path: lanes of one 128-byte box, and the boxes of a row of D (the
// last one zero-filled past D by the copy engine).
template <typename T>
__host__ __device__ constexpr int box_lanes() {
  return kBoxBytes / (int)sizeof(T);
}
template <typename T>
int boxes_of(int D) {
  return (D + box_lanes<T>() - 1) / box_lanes<T>();
}

// Bytes of one user's image row: the logical k extent rounded up to whole
// 128-byte swizzle rows.
template <typename T, int NK>
__host__ __device__ constexpr int image_row_bytes() {
  return (Elt<T>::step * NK * (int)sizeof(T) + 127) / 128 * 128;
}

// Physical dim of logical k position l (the permutation that gives lane t
// one contiguous run of C = step * NK / 4 dims).
template <typename T, int NK>
__device__ __forceinline__ int perm_k(int l) {
  constexpr int C = Elt<T>::step * NK / 4;
  if (Elt<T>::step == 8) {  // tf32: l = 8 kk + t + 4 h -> t C + 2 kk + h
    const int kk = l >> 3, r = l & 7;
    return (r & 3) * C + 2 * kk + (r >> 2);
  }
  // bf16: l = 16 kk + 2 t + 8 h + e -> t C + 4 kk + 2 h + e
  const int kk = l >> 4, r = l & 15;
  return ((r & 7) >> 1) * C + 4 * kk + 2 * (r >> 3) + (r & 1);
}

// Shared-memory layout of a block, in bytes from its 1024-aligned base:
// the users' images, the ring of item tiles, the candidate buffers
// (values, then indices), the per-user state (threshold value, threshold
// index, fill) and the ring's mbarriers.
struct Layout {
  int ring, buf, state, bars, total;
};

__host__ __device__ inline Layout layout(int img_total, int slot_bytes, int stages, int users, int cap) {
  Layout l;
  l.ring = img_total;
  l.buf = l.ring + stages * slot_bytes;
  l.state = l.buf + users * cap * 8;
  l.bars = (l.state + users * 12 + 7) / 8 * 8;
  l.total = l.bars + 2 * stages * 8;
  return l;
}

struct Args {
  const void* users;     // (U, D)
  const void* items;     // (N, D), 16-byte aligned rows
  const float* bias;     // (N,)
  const int* mask;       // (U, mask_words) packed seen bits, or null
  int mask_words;
  unsigned long long* gtop;  // (U, S, NWG, P), zeroed: each list's P best keys, as last published
  int top_p;                 // P; 0: no sharing
  int U, N, D;
  int L;                 // entries kept per (user, split)
  int cap;               // candidate buffer entries per user (a power of two)
  int tiles_per_split;
  int stages;            // ring slots, stages / NWG per consumer warpgroup
  int slot_bytes;
  int units;             // slab path: two-box units of a row
  int tail;              // slab path: 1 where an odd last box makes a tail unit of NK / 2 k steps
  float* part_v;         // (U, S, L)
  int* part_i;
};

// Words [w0, w0 + NW) of a lane's run of one item row (C dims from t C,
// zero past D), as 32-bit words: f32 values, or bf16 pairs. w0: a multiple
// of the words of a vector.
template <typename T, int NK, int NW>
__device__ __forceinline__ void load_run(const T* row, int t, int D, int w0, uint32_t (&w)[NW]) {
  using V = typename Elt<T>::Vec;
  constexpr int C = Elt<T>::step * NK / 4;
  constexpr int WV = sizeof(V) / 4;  // words per vector
  constexpr int EW = 4 / WV;         // elements per word
  static_assert(NW % WV == 0, "whole vectors");
#pragma unroll
  for (int v = 0; v < NW / WV; ++v) {
    const int p = t * C + (w0 + WV * v) * EW;
    V x{};
    if (p < D) x = *reinterpret_cast<const V*>(row + p);
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < WV; ++e) w[WV * v + e] = xw[e];
  }
}

__device__ __forceinline__ float tf32_big(float x) { return __uint_as_float(__float_as_uint(x) & 0xffffe000u); }

// The users' image of one unit of NK k steps (a D <= 128 row, or one
// slab-path unit starting at dim d0), written by ``nthreads`` threads in
// the 128-byte swizzle, 16 bytes at a time: unit q of user n's row sits at
// (q / 8) * UT * 128 + n * 128 + ((q ^ n) & 7) * 16 from ``img``; f32
// keeps the big parts there and the small parts UT * KB bytes on.
template <typename T, int NK, int UT>
__device__ __forceinline__ void fill_image(uint8_t* img, const T* users, int u0, int U, int D, int d0, int tid,
                                           int nthreads) {
  constexpr int KB = image_row_bytes<T, NK>();
  constexpr int EPU = 16 / sizeof(T);  // elements per 16-byte unit
  constexpr int QU = KB / 16;          // units of one user's row
  for (int e = tid; e < UT * QU; e += nthreads) {
    const int n = e / QU, q = e - n * QU, u = u0 + n;
    uint8_t* dst = img + (q >> 3) * (UT * 128) + n * 128 + (((q & 7) ^ (n & 7)) << 4);
    alignas(16) T x[EPU];
#pragma unroll
    for (int i = 0; i < EPU; ++i) {
      const int l = q * EPU + i;
      const int d = l < Elt<T>::step * NK ? d0 + perm_k<T, NK>(l) : D;
      x[i] = (u < U && d < D) ? users[(size_t)u * D + d] : T(0.0f);
    }
    if constexpr (Elt<T>::step == 8) {
      float4 big, small;
      float* bp = reinterpret_cast<float*>(&big);
      float* sp = reinterpret_cast<float*>(&small);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bp[i] = tf32_big(x[i]);
        sp[i] = tf32_big(x[i] - bp[i]);
      }
      *reinterpret_cast<float4*>(dst) = big;
      *reinterpret_cast<float4*>(dst + UT * KB) = small;
    } else {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

// Slab path: the 2 NK words of lane t's run (C = step NK / 4 elements from
// t C, as load_run gives them) of row r of a ring unit, whose boxes lie
// kBoxTile bytes apart, each row's 16-byte chunks placed by the copy
// engine's 128-byte swizzle (chunk c at (c ^ (r & 7)) * 16). Rows r and
// r + 8 share that pattern, and a warp's 32 loads of one step fall on 8
// distinct chunks of 4 banks: no bank conflicts.
template <typename T, int NK>
__device__ __forceinline__ void load_box_run(const uint8_t* unit, int r, int t, uint32_t (&w)[2 * NK]) {
  constexpr int RB = Elt<T>::step * NK / 4 * (int)sizeof(T);  // bytes of a lane's run: 64 or 32
  const uint8_t* row = unit + (t * RB / kBoxBytes) * kBoxTile + r * kBoxBytes;
  const int c0 = (t * RB % kBoxBytes) / 16;
#pragma unroll
  for (int v = 0; v < RB / 16; ++v) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + (((c0 + v) ^ (r & 7)) << 4));
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

// acc0 (even k steps) and acc1 (odd) (+)= A . image for the KC k steps
// from k0; ``first`` starts each chain from zero at k steps 0 and 1.
template <typename T, int UT, int KC, int NA>
__device__ __forceinline__ void mma_chain(float (&acc0)[NA], float (&acc1)[NA], const uint32_t (&A)[KC][4],
                                          const uint8_t* img, int k0, bool first) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int kk = k0 + kc;
    const uint64_t db = kmajor_desc(img + (kk >> 2) * (UT * 128) + (kk & 3) * 32);
    if (kk & 1)
      wgmma(acc1, A[kc], db, first ? kk > 1 : 1, T{});
    else
      wgmma(acc0, A[kc], db, first ? kk > 1 : 1, T{});
  }
}

// One pass of KC k steps from k0: the A fragments (rows 16 warp + g and
// + 8) from the words w0 / w1 of load_run or load_box_run, split for f32
// into big and small parts in registers, times the users' image (big at
// img_big; f32: small at img_small), into acc0 + acc1; returns once the
// products are done.
template <typename T, int UT, int KC, int NA>
__device__ __forceinline__ void pass_products(float (&acc0)[NA], float (&acc1)[NA], const uint32_t (&w0)[2 * KC],
                                              const uint32_t (&w1)[2 * KC], const uint8_t* img_big,
                                              const uint8_t* img_small, int k0) {
  constexpr bool F32 = Elt<T>::step == 8;
  uint32_t ab[KC][4];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    ab[kk][0] = w0[2 * kk];
    ab[kk][1] = w1[2 * kk];
    ab[kk][2] = w0[2 * kk + 1];
    ab[kk][3] = w1[2 * kk + 1];
  }
  uint32_t as[F32 ? KC : 1][4];  // f32: the items' small parts
  if constexpr (F32) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = __uint_as_float(ab[kk][r]);
        as[kk][r] = __float_as_uint(x - tf32_big(x));
      }
  }
  wg_fence();
  if constexpr (F32) {  // items . users: the small terms first
    mma_chain<T, UT>(acc0, acc1, as, img_big, k0, true);
    mma_chain<T, UT>(acc0, acc1, ab, img_small, k0, false);
    mma_chain<T, UT>(acc0, acc1, ab, img_big, k0, false);
  } else {
    mma_chain<T, UT>(acc0, acc1, ab, img_big, k0, true);
  }
  wg_commit();
  wg_wait0();
  // the tensor cores read A from these registers until the wait: keep the
  // compiler from reusing them before it
  fence_regs(ab);
  if constexpr (F32) fence_regs(as);
}

// Slab path: the products of one ring unit of NK k steps with the users'
// image at ``img``, into acc0 + acc1 from zero, as one pass. The slot is
// freed as soon as the A fragments are in registers (after a proxy fence:
// the next TMA write into it is another proxy's).
template <typename T, int NK, int UT, int NA>
__device__ __forceinline__ void unit_products(float (&acc0)[NA], float (&acc1)[NA], const uint8_t* unit,
                                              const uint8_t* img, uint64_t* empty_bar, int warp, int g, int t) {
  uint32_t w0[2 * NK], w1[2 * NK];
  load_box_run<T, NK>(unit, 16 * warp + g, t, w0);
  load_box_run<T, NK>(unit, 16 * warp + g + 8, t, w1);
  fence_async();
  mbar_arrive(empty_bar);
  pass_products<T, UT, NK>(acc0, acc1, w0, w1, img, img + UT * image_row_bytes<T, NK>(), 0);
}

// Block (user tile of UT, catalog split): NWG consumer warpgroups and one
// producer warpgroup. See the file header for the design. SLABS: rows
// wider than 128 lanes, scored in two-box units of NK = kUnitK k steps,
// then, with a.tail, one tail unit of NK / 2 (one box).
template <typename T, int NK, int UT, int NWG, int CAP, bool SLABS>
__global__ void __launch_bounds__((NWG + 1) * kConsumers, 1)
    dot_topk_tc_kernel(const Args a, const __grid_constant__ CUtensorMap items_map) {
  constexpr int NA = UT / 2;  // accumulators per thread
  constexpr int NJ = UT / 8;  // 8-user column groups
  constexpr int IMG = UT * image_row_bytes<T, NK>();  // bytes of one user image of one unit
  constexpr int IMGS = Elt<T>::imgs * IMG;            // bytes of a unit's images
  constexpr int IMGS_TAIL = Elt<T>::imgs * UT * image_row_bytes<T, NK / 2>();
  constexpr int NC = NWG * kConsumers;
  constexpr int KC = NK > 10 ? NK / 2 : NK;  // k steps per pass (D <= 128)
  static_assert(!SLABS || NK == kUnitK, "the slab path's units take kUnitK k steps");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the slab path's two-box units and tail unit; ring slots of a warpgroup
  const int nu = SLABS ? a.units : 1, tail = SLABS ? a.tail : 0, R = a.stages / NWG;
  const Layout lay = layout(nu * IMGS + tail * IMGS_TAIL, a.slot_bytes, a.stages, NWG * UT, a.cap);
  uint8_t* ring = base + lay.ring;
  float* buf_v = reinterpret_cast<float*>(base + lay.buf);
  int* buf_i = reinterpret_cast<int*>(buf_v + NWG * UT * a.cap);
  unsigned long long* tkeys = reinterpret_cast<unsigned long long*>(base + lay.state);
  int* fills = reinterpret_cast<int*>(tkeys + NWG * UT);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + a.stages;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * UT, ucnt = min(UT, a.U - u0);
  const int tile0 = blockIdx.y * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, (a.N + kTile - 1) / kTile - tile0);
  const int cap = CAP > 0 ? CAP : a.cap, L = a.L, D = a.D;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < NC) {
    // the users' images: unit j (dims from j * 2 box_lanes) at j * IMGS,
    // the tail after the last
    const T* users = static_cast<const T*>(a.users);
    for (int j = 0; j < nu; ++j)
      fill_image<T, NK, UT>(base + j * IMGS, users, u0, a.U, D, j * 2 * box_lanes<T>(), tid, NC);
    if (SLABS && tail)
      fill_image<T, NK / 2, UT>(base + nu * IMGS, users, u0, a.U, D, nu * 2 * box_lanes<T>(), tid, NC);
    for (int i = tid; i < NWG * UT * cap; i += NC) {
      buf_v[i] = sentinel_value();
      buf_i[i] = kIntMax;
    }
    for (int i = tid; i < NWG * UT; i += NC) {
      tkeys[i] = order_key(sentinel_value(), kIntMax);
      fills[i] = 0;
    }
    fence_async();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warpgroup: one thread fills the ring
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NC) {
      // Tile i goes to warpgroup i % NWG, whose ring is slots w, w + NWG,
      // ...: its jj-th (tile, unit) lands in slot w + NWG (jj % R), so each
      // warpgroup waits on its own slots in order and no wait can see a
      // phase a lap ahead. A row of D <= 128 arrives as one contiguous
      // bulk copy of the tile; a slab-path unit as one TMA box per 128-byte
      // column (two, or one for the tail).
      const T* items = static_cast<const T*>(a.items);
      const int units = nu + tail;
      for (int i = 0; i < nt; ++i) {
        const int g0 = (tile0 + i) * kTile;
        for (int j = 0; j < units; ++j) {
          const int jj = (i / NWG) * units + j, slot = i % NWG + NWG * (jj % R);
          if (jj >= R) mbar_wait(empty + slot, (jj / R - 1) & 1);
          uint8_t* dst = ring + slot * a.slot_bytes;
          if constexpr (SLABS) {
            const int boxes = j < nu ? 2 : 1;
            mbar_expect_tx(full + slot, boxes * kBoxTile);
            for (int b = 0; b < boxes; ++b)
              tma_load(dst + b * kBoxTile, &items_map, (2 * j + b) * box_lanes<T>(), g0, full + slot);
          } else {
            const int bytes = min(kTile, a.N - g0) * D * (int)sizeof(T);
            mbar_expect_tx(full + slot, bytes);
            bulk_load(dst, items + (size_t)g0 * D, bytes, full + slot);
          }
        }
      }
    }
    return;
  }

  // two consumer warpgroups take the producer's registers: 2 x 128 x 232 +
  // 128 x 40 <= 65536
  if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // warpgroup and warp from a shuffle: provably warp-uniform to the
  // compiler, which otherwise serialises the wgmmas of a "divergent" path
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* bv = buf_v + wg * UT * cap;
  int* bi = buf_i + wg * UT * cap;
  unsigned long long* tkey = tkeys + wg * UT;  // the users' thresholds
  int* fill = fills + wg * UT;

  // threshold values of the thread's users (columns 8 j + 2 t + q), in
  // registers for the gate's first compare (+inf past the user tile: no
  // score passes); the exact compare reads the key in shared memory. A
  // user's threshold is the better of this list's L-th entry and the best
  // bound the published lists give (refreshed after the kRefresh-th tile,
  // then at each doubling).
  float thr_v[2 * NJ];
  auto load_thresholds = [&]() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 8 * j + 2 * t + q;
        thr_v[2 * j + q] = c < ucnt ? key_value(tkey[c]) : INFINITY;
      }
  };
  load_thresholds();

  // Seen items are masked where a buffer is sorted, not at the gate: a
  // score is compared with the threshold as it is (a seen item's true
  // score, kNegInf, is lower, so nothing that passes is wrongly dropped),
  // and the sort reads a seen item's entry as kNegInf before any
  // threshold is taken from it.
  auto mask_row = [&](int c) -> const int* {
    return a.mask != nullptr ? a.mask + (size_t)(u0 + c) * a.mask_words : nullptr;
  };

  // Compacts every user of this warpgroup whose buffer overflowed: sorted,
  // cut to L, threshold raised to the L-th entry.
  auto compact = [&]() {
    for (int c = warp; c < ucnt; c += 4) {
      if (fill[c] > cap) {  // warp-uniform
        sort_list<CAP>(bv + c * cap, bi + c * cap, cap, L, cap, mask_row(c), lane);
        if (lane == 0) {
          // this list holds L entries at or above its L-th: no item below
          // it is in the user's top k
          const unsigned long long lk = order_key(bv[c * cap + L - 1], bi[c * cap + L - 1]);
          if (lk > tkey[c]) tkey[c] = lk;
          fill[c] = L;
        }
        if (lane < a.top_p)  // publish the list's best P keys
          a.gtop[((size_t)(u0 + c) * gridDim.y + blockIdx.y) * (NWG * a.top_p) + wg * a.top_p + lane] =
              order_key(bv[c * cap + lane], bi[c * cap + lane]);
      }
    }
    bar_sync(3 + wg, kConsumers);
    load_thresholds();
  };

  // One candidate (s, gg) of user column c: appended if it beats the
  // user's threshold; false if the buffer was full (the caller compacts
  // and tries again).
  auto offer = [&](float s, int gg, int c) {
    if (order_key(s, gg) <= tkey[c]) return true;
    const int pos = atomicAdd(fill + c, 1);
    if (pos >= cap) return false;
    bv[c * cap + pos] = s;
    bi[c * cap + pos] = gg;
    return true;
  };

  // the biases of the thread's two items (rows 16 warp + g (+8) of a
  // tile), loaded one tile ahead
  auto load_bias = [&](int i, float (&b)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gg = (tile0 + i) * kTile + 16 * warp + g + 8 * hh;
      b[hh] = (i < nt && gg < a.N) ? __ldg(a.bias + gg) : 0.0f;
    }
  };
  float next_bias[2];
  load_bias(wg, next_bias);

  // two accumulator chains (even and odd k steps), so that two products
  // of a warpgroup are in flight at a time. On the slab path the scores
  // carry over from unit to unit in sc, outside the accumulators: each
  // unit's products start from zero, so no accumulator lives across the
  // runtime unit loop (ptxas would serialise the wgmmas of such a loop)
  float acc0[NA], acc1[NA];
  float sc[SLABS ? NA : 1];
  int jj = 0;  // this warpgroup's (tile, unit) count: its ring position
  for (int i = wg; i < nt; i += NWG) {
    const float bias[2] = {next_bias[0], next_bias[1]};
    load_bias(i + NWG, next_bias);
    if constexpr (SLABS) {
      auto add_unit = [&](bool first) {
        fence_acc(acc0);
        fence_acc(acc1);
#pragma unroll
        for (int x = 0; x < NA; ++x) sc[x] = (first ? 0.0f : sc[x]) + (acc0[x] + acc1[x]);
      };
      for (int j = 0; j < nu; ++j, ++jj) {
        const int slot = wg + NWG * (jj % R);
        mbar_wait(full + slot, (jj / R) & 1);
        unit_products<T, NK, UT>(acc0, acc1, ring + slot * a.slot_bytes, base + j * IMGS, empty + slot, warp, g, t);
        add_unit(j == 0);
      }
      if (tail) {  // a kernel parameter: uniform, so its wgmmas stay asynchronous
        const int slot = wg + NWG * (jj % R);
        mbar_wait(full + slot, (jj / R) & 1);
        ++jj;
        unit_products<T, NK / 2, UT>(acc0, acc1, ring + slot * a.slot_bytes, base + nu * IMGS, empty + slot, warp,
                                     g, t);
        add_unit(false);
      }
#pragma unroll
      for (int x = 0; x < NA; ++x) {  // the gate reads the scores from acc0 + acc1
        acc0[x] = sc[x];
        acc1[x] = 0.0f;
      }
    } else {
      const int slot = wg + NWG * (jj % R);
      mbar_wait(full + slot, (jj / R) & 1);
      ++jj;
      const T* tile = reinterpret_cast<const T*>(ring + slot * a.slot_bytes);
      const uint8_t* img_big = base;
      const uint8_t* img_small = img_big + IMG;
      // the products in passes of KC k steps: each pass's A fragments (rows
      // 16 warp + g, +8) come from the slot into registers, and a pass waits
      // for the one before it, so that D = 128 keeps its registers
#pragma unroll
      for (int k0 = 0; k0 < NK; k0 += KC) {
        uint32_t w0[2 * KC], w1[2 * KC];
        load_run<T, NK, 2 * KC>(tile + (16 * warp + g) * D, t, D, 2 * k0, w0);
        load_run<T, NK, 2 * KC>(tile + (16 * warp + g + 8) * D, t, D, 2 * k0, w1);
        if (k0 + KC >= NK) {
          // the tile now lives in registers: order these reads before the
          // producer's next bulk copy (another proxy) into the slot
          fence_async();
          mbar_arrive(empty + slot);
        }
        pass_products<T, UT, KC>(acc0, acc1, w0, w1, img_big, img_small, k0);
      }
    }
    const int gi[2] = {(tile0 + i) * kTile + 16 * warp + g, (tile0 + i) * kTile + 16 * warp + g + 8};
    // refreshes after this warpgroup's kRefresh-th tile and then at each
    // doubling: the published bounds rise fastest early, and a refresh
    // costs a sort of the keys per user
    const int done = i / NWG + 1;
    const bool refresh = a.top_p > 0 && done >= kRefresh && (done & (done - 1)) == 0;
    fence_acc(acc0);
    fence_acc(acc1);

    // the gate: acc[4 j + 2 hh + q] is item gi[hh], user column 8 j + 2 t
    // + q. One compare per score, no branch: a score that ties or beats
    // its threshold value sets a bit. Only those (rarely any) take the
    // exact compare and are appended.
    uint32_t hot = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int x = 4 * j + 2 * hh + q;
          const float s = (acc0[x] + acc1[x]) + bias[hh];
          acc0[x] = s;
          hot |= (s >= thr_v[2 * j + q] ? 1u : 0u) << x;
        }
    hot &= (gi[0] < a.N ? 0x33333333u : 0u) | (gi[1] < a.N ? 0xccccccccu : 0u);
    uint32_t pend = 0;
    if (hot != 0) {
      // in batches, so that the loads and atomics of several candidates
      // are in flight at once: the exact compare against the threshold
      // keys, then the appends
      unsigned long long tk[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) tk[2 * j + q] = tkey[8 * j + 2 * t + q];
      uint32_t go = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int x = 4 * j + 2 * hh + q;
            go |= (((hot >> x) & 1u) && order_key(acc0[x], gi[hh]) > tk[2 * j + q] ? 1u : 0u) << x;
          }
      int pos[NA];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int x = 4 * j + 2 * hh + q;
            pos[x] = ((go >> x) & 1u) ? atomicAdd(fill + 8 * j + 2 * t + q, 1) : 0;
          }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int x = 4 * j + 2 * hh + q, c = 8 * j + 2 * t + q;
            if (!((go >> x) & 1u)) continue;
            if (pos[x] < cap) {
              bv[c * cap + pos[x]] = acc0[x];
              bi[c * cap + pos[x]] = gi[hh];
            } else {
              pend |= 1u << x;
            }
          }
    }
    if (refresh) {
      // The published keys are distinct items' scores: if L of them are at
      // or above key T, so is the user's k-th best item, in any split, and
      // no item below T can be in its top k. T: the L-th best published.
      const int m = gridDim.y * NWG * a.top_p;
      for (int c = warp; c < ucnt; c += 4) {
        const unsigned long long T = select_key(a.gtop + (size_t)(u0 + c) * m, m, L - 1, lane);
        if (lane == 0 && T != 0 && T - 1 > tkey[c]) tkey[c] = T - 1;  // keep keys >= T
      }
    }
    // overflowed buffers: compact, gate the rejected entries again, retry
    while (wg_any(3 + wg, pend != 0)) {
      compact();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int x = 4 * j + 2 * hh + q;
            if (((pend >> x) & 1u) && offer(acc0[x], gi[hh], 8 * j + 2 * t + q)) pend &= ~(1u << x);
          }
    }
    if (refresh) load_thresholds();  // the last wg_any ordered the new keys before these reads
  }

  // each warpgroup's lists, sorted
  for (int c = warp; c < ucnt; c += 4)
    sort_list<CAP>(bv + c * cap, bi + c * cap, fill[c], L, cap, mask_row(c), lane);
  bar_sync(NWG == 2 ? 5 : 3, NC);  // every list sorted before any is read
  const int S = gridDim.y;
  for (int c = tid; c < ucnt; c += NC) {
    const size_t o = ((size_t)(u0 + c) * S + blockIdx.y) * L;
    const float* av = buf_v + c * cap;
    const int* ai = buf_i + c * cap;
    if (NWG == 1) {
      for (int r = 0; r < L; ++r) {
        a.part_v[o + r] = av[r];
        a.part_i[o + r] = ai[r];
      }
      continue;
    }
    // the two warpgroups' lists merged, the first L kept
    const float* cv = buf_v + (UT + c) * cap;
    const int* ci = buf_i + (UT + c) * cap;
    int x = 0, y = 0;
    for (int r = 0; r < L; ++r) {
      const bool from_a = better(av[x], ai[x], cv[y], ci[y]);
      a.part_v[o + r] = from_a ? av[x] : cv[y];
      a.part_i[o + r] = from_a ? ai[x] : ci[y];
      x += from_a;
      y += !from_a;
    }
  }
}

// ---------------------------------------------------------------------------
// Split merge: one block per user sorts that user's S sorted partial lists
// (C = S * L candidates, padded to n_pow2 with sentinels) in shared memory
// and writes the first k.
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

// One call's plan: the kernel variant, its shared memory and grid.
struct Plan {
  const void* fn;
  int ut, nwg, L, cap, stages, slot_bytes, smem, user_tiles, total_tiles, units, tail;
};

template <typename T, int NK, int UT, int NWG, int CAP, bool SLABS = false>
Plan plan_t(int N, int D, int L, int cap) {
  Plan p;
  p.fn = reinterpret_cast<const void*>(dot_topk_tc_kernel<T, NK, UT, NWG, CAP, SLABS>);
  p.ut = UT;
  p.nwg = NWG;
  p.L = L;
  p.cap = cap;
  p.total_tiles = cdiv(N, kTile);
  int img;
  if (SLABS) {  // two-box units of 16 KB, and an odd last box's tail unit
    p.units = boxes_of<T>(D) / 2;
    p.tail = boxes_of<T>(D) % 2;
    p.slot_bytes = 2 * kBoxTile;
    img = Elt<T>::imgs * UT * (p.units * image_row_bytes<T, NK>() + p.tail * image_row_bytes<T, NK / 2>());
  } else {
    p.units = 1;
    p.tail = 0;
    p.slot_bytes = (kTile * D * (int)sizeof(T) + 127) / 128 * 128;
    img = Elt<T>::imgs * UT * image_row_bytes<T, NK>();
  }
  const int fixed = 1024 + layout(img, p.slot_bytes, 0, NWG * UT, cap).total;
  p.stages = std::min(4, (kSmemLimit - fixed) / (p.slot_bytes + 16));
  // two warpgroups take alternate tiles: an even ring gives each slot to
  // one warpgroup, so no warpgroup can wait on a slot's phase a lap ahead
  if (NWG == 2) p.stages &= ~1;
  p.smem = 1024 + layout(img, p.slot_bytes, p.stages, NWG * UT, cap).total;
  return p;
}

// The variant for (large, k) at D <= 128: k <= 16 keeps 16 per (user,
// split) over 64-user tiles in 64-entry buffers; k <= 128 keeps k over
// 32-user tiles in 256-entry buffers (both warpgroups' buffers fit); k >
// 128 keeps k over 8-user tiles with one warpgroup, in buffers of the next
// power of two of k + 64. The first two sort their buffers in registers.
template <typename T, int NK>
Plan plan_nk(int large, int N, int D, int k) {
  if (!large) return plan_t<T, NK, 64, 2, 64>(N, D, kSmallList, 64);
  if (k <= kWideMaxK) return plan_t<T, NK, 32, 2, 256>(N, D, k, 256);
  return plan_t<T, NK, 8, 1, 0>(N, D, k, next_pow2(k + 64));
}

// The slab path (D > 128): the same tiles and buffers while every unit's
// user images fit beside kSlabStages ring slots, then half the users (32
// for k <= 16, 16 for k <= 128), then the 8-user tile of one warpgroup
// (shared memory bounds D at about 2,800 lanes of f32 for k <= 128 and
// 1,000 for k = 1024; bf16 at 4 times that).
template <typename T>
Plan plan_slabs(int large, int N, int D, int k) {
  const int L = large ? k : kSmallList;
  Plan p{};
  if (!large) {
    p = plan_t<T, kUnitK, 64, 2, 64, true>(N, D, L, 64);
    if (p.stages < kSlabStages) p = plan_t<T, kUnitK, 32, 2, 64, true>(N, D, L, 64);
  } else if (k <= kWideMaxK) {
    p = plan_t<T, kUnitK, 32, 2, 256, true>(N, D, L, 256);
    if (p.stages < kSlabStages) p = plan_t<T, kUnitK, 16, 2, 256, true>(N, D, L, 256);
  }
  if (p.fn == nullptr || p.stages < 2) p = plan_t<T, kUnitK, 8, 1, 0, true>(N, D, L, next_pow2(L + 64));
  return p;
}

template <typename T>
Plan plan_of(int large, int N, int D, int k) {
  constexpr int s = Elt<T>::step;
  if (D > kSlab) return plan_slabs<T>(large, N, D, k);
  switch (pick_nk<T>(D)) {
    case 32 / s: return plan_nk<T, 32 / s>(large, N, D, k);
    case 64 / s: return plan_nk<T, 64 / s>(large, N, D, k);
    case 80 / s: return plan_nk<T, 80 / s>(large, N, D, k);
    default: return plan_nk<T, kSlab / s>(large, N, D, k);
  }
}

// Keys each (split, warpgroup) list publishes per user: enough that all
// lists together publish at least 2 L, at most kMaxShared in all. 0 (no
// sharing) for one warpgroup (k > 128) or where that does not fit.
int top_p(int S, int nwg, int L) {
  if (nwg < 2) return 0;
  int p = 1;
  while (p * S * nwg < 2 * L) p <<= 1;
  return (p > L || p * S * nwg > kMaxShared) ? 0 : p;
}

Plan make_plan(int large, int U, int N, int D, int bf16, int k) {
  Plan p = bf16 ? plan_of<__nv_bfloat16>(large, N, D, k) : plan_of<float>(large, N, D, k);
  if (p.fn != nullptr) p.user_tiles = cdiv(U, p.ut);
  return p;
}

bool bad_args(int large, int U, int N, int D, int bf16, int k) {
  return D < 1 || D % (bf16 ? 8 : 4) != 0 || U < 1 || N < 1 || k < 1 || k > N ||
         (!large && k > kSmallList) || (large && k > 1024);
}

cudaError_t launch_merge(const float* part_v, const int* part_i, int U, int C,
                         int k, float* out_v, int* out_i, cudaStream_t stream) {
  if (C > kMergeMaxCandidates || k > C) return cudaErrorInvalidValue;
  const int n_pow2 = next_pow2(C < 2 ? 2 : C);
  const size_t smem = (size_t)n_pow2 * (sizeof(float) + sizeof(int));
  dot_topk_merge_kernel<<<U, kMergeThreads, smem, stream>>>(
      part_v, part_i, C, n_pow2, k, out_v, out_i);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda
// link).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

}  // namespace

extern "C" {

// The slab path's TMA map of an (N, D) item table (f32, or bf16 when
// bf16 != 0; 16-byte aligned; D a multiple of 4 or 8): boxes of 64 rows x
// 128 bytes in the 128-byte swizzle, out-of-range lanes and rows read as
// zeros. Writes the 128-byte CUtensorMap to ``map``; the wrapper keeps it
// per (table, N, D, dtype) and passes it to trs_dot_topk. Returns 0, the
// encoder's CUresult, or -1 where the lookup finds no encoder.
int trs_dot_topk_tensor_map(const void* items, int N, int D, int bf16, void* map) {
  if (N < 1 || D < 1 || D % (bf16 ? 8 : 4) != 0 || (reinterpret_cast<uintptr_t>(items) & 15) != 0)
    return CUDA_ERROR_INVALID_VALUE;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t esz = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)N};  // innermost first
  const cuuint64_t strides[1] = {(cuuint64_t)D * esz};        // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)(kBoxBytes / esz), (cuuint32_t)kTile};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = encode(&m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            const_cast<void*>(items), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(map, &m, sizeof(m));
  return (int)r;
}

// Launch plan for (U, N, D, dtype, k) on the current device, made once per
// shape by the wrapper: the number of catalog splits S (tile-aligned, one
// wave of resident blocks), the per-(user, split) list length L (the
// wrapper allocates U * S * L entries of scratch), the candidate buffer
// per user, the kernel's dynamic shared memory per block and its ring
// slots, the keys per user its lists publish, its users per block and
// the bytes of a ring slot. Also opts both kernels into the most shared
// memory a block may have. D must be a multiple of 4 (f32) or 8 (bf16): whole 16-byte rows.
// Returns a cudaError_t (cudaErrorInvalidValue where no user tile's images
// fit).
int trs_dot_topk_plan(int large, int U, int N, int D, int bf16, int k,
                      int* S, int* list_len, int* cap, int* smem_bytes, int* stages,
                      int* keys_per_user, int* user_tile, int* slot_bytes) {
  if (bad_args(large, U, N, D, bf16, k)) return cudaErrorInvalidValue;
  const Plan p = make_plan(large, U, N, D, bf16, k);
  if (p.fn == nullptr || p.stages < 2) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the variant is opted into the whole limit, not p.smem: the wrapper
  // keeps plans per shape, and a later plan of a smaller shape of the same
  // variant must not lower what an earlier, cached plan launches with
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(dot_topk_merge_kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMergeMaxCandidates * (sizeof(float) + sizeof(int))));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, (p.nwg + 1) * kConsumers, p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int s = sms * per_sm / p.user_tiles;
  s = std::min(s, p.total_tiles);
  s = std::min(s, kMergeMaxCandidates / p.L);
  s = std::max(s, 1);
  const int per_split = cdiv(p.total_tiles, s);
  *S = cdiv(p.total_tiles, per_split);  // no empty split
  *list_len = p.L;
  *cap = p.cap;
  *smem_bytes = p.smem;
  *stages = p.stages;
  *keys_per_user = *S * p.nwg * top_p(*S, p.nwg, p.L);
  *user_tile = p.ut;
  *slot_bytes = p.slot_bytes;
  return cudaSuccess;
}

// users (U, D), items (N, D): f32, or bf16 when bf16 != 0; items 16-byte
// aligned. bias (N,) f32. mask: (U, mask_words) int32 packed seen bits, or
// null. S as trs_dot_topk_plan gave it (which also opted the kernels into
// their shared memory on this device); part_*: U * S * L entries of
// scratch; gtop: U * keys_per_user 8-byte words of scratch (zeroed here,
// keys_per_user as the plan gave it); out_*: (U, k); items_map: for D >
// 128, trs_dot_topk_tensor_map's map of ``items`` (else null).
// large = 0 runs #1's list of 16, 1 #2's list of k; then the split merge:
// a memset and two launches. Returns the cudaError_t of the launches (0 =
// cudaSuccess).
int trs_dot_topk(int large, const void* users, const void* items,
                 const float* bias, const int* mask, int mask_words, int U,
                 int N, int D, int bf16, int k, int S, float* part_v,
                 int* part_i, void* gtop, float* out_v, int* out_i, const void* items_map, void* stream) {
  if (bad_args(large, U, N, D, bf16, k) || S < 1 || (reinterpret_cast<uintptr_t>(items) & 15) != 0 ||
      (D > kSlab && items_map == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map;  // unread for D <= 128
  if (D > kSlab)
    memcpy(&map, items_map, sizeof(map));
  else
    memset(&map, 0, sizeof(map));
  const Plan p = make_plan(large, U, N, D, bf16, k);
  if (p.fn == nullptr || p.stages < 2) return cudaErrorInvalidValue;
  Args a;
  a.users = users;
  a.items = items;
  a.bias = bias;
  a.mask = mask;
  a.mask_words = mask_words;
  a.U = U;
  a.N = N;
  a.D = D;
  a.L = p.L;
  a.cap = p.cap;
  a.tiles_per_split = cdiv(p.total_tiles, S);
  a.stages = p.stages;
  a.slot_bytes = p.slot_bytes;
  a.units = p.units;
  a.tail = p.tail;
  a.part_v = part_v;
  a.part_i = part_i;
  a.gtop = static_cast<unsigned long long*>(gtop);
  a.top_p = top_p(S, p.nwg, p.L);
  if (cdiv(p.total_tiles, a.tiles_per_split) != S) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(gtop, 0, (size_t)U * S * p.nwg * a.top_p * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return e;
  void* args[] = {&a, &map};
  e = cudaLaunchKernel(p.fn, dim3(p.user_tiles, S), dim3((p.nwg + 1) * kConsumers), args,
                                   (size_t)p.smem, st);
  if (e != cudaSuccess) return e;
  return launch_merge(part_v, part_i, U, S * p.L, k, out_v, out_i, st);
}

}  // extern "C"
