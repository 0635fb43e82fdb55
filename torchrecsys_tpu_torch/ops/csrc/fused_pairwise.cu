// The fused pairwise train step for Hopper (sm_90a), behind a plain C
// interface (bound with ctypes in torchrecsys_tpu_torch/ops/fused_pairwise.py,
// built by ops/_build.py).
//
// Replaces torchrecsys_tpu/ops/fused_pairwise.py::_pairwise_kernel (:100-243),
// called through _pairwise_updates_rows (:279-357). For every row r of three
// packed (B, 128) f32 blocks -- user u, positive item p, negative item n, in
// the packed layout of that module's docstring (:13-22):
//     lanes 0..d-1 factor vector, d its rowwise-adagrad accumulator,
//     d+1 bias, d+2 the bias accumulator, the rest zero padding
// it computes the raw scores <u, p> + b_u + b_p and <u, n> + b_u + b_n
// (optionally squashed by a sigmoid), the hinge / bpr / logistic loss and
// its derivatives, scaled by w[r] * inv, and forms update rows:
// -lr * rowwise-adagrad deltas in the vector and bias lanes, accumulator
// increments in lanes d and d+2. The user row is ONE occurrence with the
// combined gradient gp*p + gn*n; the positive and negative item rows are
// separate occurrences. With emit_g the per-row d loss / d raw scalars gp,
// gn go to lanes d+4, d+5 of the user update row. `row_math` holds this
// arithmetic once; two entry points use it.
//
// 1. The row-level contract (trs_fused_pairwise, `fused_pairwise_kernel`,
//    all 96 flag variants): rows in, update rows and the loss sum out, no
//    scatter -- what the FM step and the mesh wrappers need (JAX
//    _pairwise_updates, :246-276).
// 2. The single-device step (trs_fused_pairwise_step) of
//    fused_pairwise_step (:367-412) and fused_pairwise_step_meta (:811-864,
//    fm=False): one call reads each batch row's packed rows from the tables
//    by id, forms the metadata composite, runs the row math, forms the
//    metadata deltas, adds every update into its table in place and writes
//    the step's mean loss. On the TPU the row gather and the scatter-add
//    belong to XLA around the kernel; here a warp reads a 512-byte row by
//    its id as cheaply as a pre-gathered one, so they move inside, and one
//    call replaces 8 (no metadata) to ~25 (metadata) device ops.
//
//    JAX gathers every row from the PRE-step tables and then scatter-adds:
//    a user twice in a batch, or an item that is both a positive and a
//    negative, gets two deltas, each formed from the old row. So the step
//    is two launches, and no launch writes a row another warp of the same
//    step may still read:
//    (a) fused_pairwise_step_kernel: one warp per batch row reads its ids
//        (each checked against its table's row count: an id out of range
//        traps, as index_select would assert), the three rows and, with
//        metadata, the item's meta_ids / meta_mask and the (d+1)-float
//        metadata rows of its unmasked slots (scalar loads: the rows have a
//        (d+1)-float stride); adds their masked sum into the item's vector
//        lanes (the composite); runs row_math; and writes the update rows,
//        per unmasked metadata slot 1/sqrt(acc + msq + eps), and a per-block
//        loss sum to a scratch buffer that stays in L2 (~2 MB at B = 1024).
//    (b) fused_pairwise_apply_kernel: adds the scratch rows into the tables
//        with 16-byte vector atomics (sm_90's atomicAdd on a float4: one
//        REDG.E.ADD.F32x4 each, which like every f32 global atomic and so
//        index_add_ flushes denormals), the
//        metadata deltas (-lr * g) * r and msq with scalar atomics; one
//        extra block folds the loss sums in a fixed order and stores
//        loss_sum * inv.
//    Duplicate ids add in no fixed order, as index_add_ on the card does.
//    Only the lanes that carry data are read and added (d+3 columns, d+6
//    with the g lanes): adding the update row's zero padding is x + 0 = x.
//
// Metadata (Linear): d score / d item_vec = d score / d meta slot = g * u,
// so each unmasked slot's delta is the item update's vector gradient
// against the slot's own accumulator: delta = [(-lr * g) * 1/sqrt(acc + msq
// + eps), msq], with the item side's msq. A masked slot's delta is exactly
// +-0 in every lane (g = g * 0, msq = +0) and x + (+-0) = x, so skipping
// masked slots is exact whenever acc + eps > 0 (eps defaults to 1e-10).
//
// Bound: the step moves each distinct touched row once each way, and only
// the lanes that carry data: d+3 floats (the metadata user row d+6, its g
// lanes added too), in whole 32-byte sectors since a row starts on one
// (352 bytes at d = 80, not the row's 512); the ids and the weights; and
// with metadata each distinct unmasked (d+1)-float row read and written
// plus the items' meta_ids / meta_mask: at B = 1024 about 2.2 MB (~0.65 us
// at 3.35 TB/s) without metadata. ~10 flops per lane are far below the
// f32 rate. At this size the two launches' fixed cost, not the bytes, is
// the limit; the design keeps every batch row's chain of loads in flight
// at once (one warp per row, ~8 warps per SM) and moves each byte once.
//
// Numerics follow the TPU kernel: 1/sqrtf (IEEE, no rsqrtf approximation;
// build without --use_fast_math), msq = sum(g^2) * (1/d) with 1/d rounded
// to f32 on the host, and the hinge subgradient (diff > 0) + 0.5*(diff == 0).
// The flags are template parameters: loss, sigmoid, use_w, emit_g, item_upd
// and bf16 (score-path values rounded to bf16, the accumulators and the
// loss kept in f32); the step instantiates loss x sigmoid x use_w x bf16 x
// metadata (emit_g = metadata, item_upd = true).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kSumThreads = 256;
constexpr int kMaxFeatures = 16;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == kSumThreads, "the apply kernel's last block folds the loss with its own threads");

enum Loss { kHinge = 0, kBpr = 1, kLogistic = 2 };

// The step's scalars.
struct Hyper {
  int d;
  float inv_d;   // f32(1/d)
  float inv;     // 1 / max(sum of weights, 1), or 1/B
  float lr;
  float margin;
  float eps;
};

struct Args {
  const float* u;
  const float* p;
  const float* n;
  const float* w;  // (B,) weights, read only with USE_W
  int B;
  Hyper h;
  float* uo;
  float* po;  // written only with ITEM_UPD
  float* no;
  float* partial;  // (gridDim.x,) per-block loss sums
};

struct StepArgs {
  float* user;  // (n_user, 128) packed tables, updated in place
  float* item;  // (n_item, 128)
  long long n_user;
  long long n_item;
  const long long* uid;  // (B,) each
  const long long* pid;
  const long long* nid;
  const float* w;  // (B,) weights, read only with USE_W
  int B;
  Hyper h;
  // metadata: F features of W slots per item (0 without)
  int F;
  int W;
  const long long* meta_ids;       // (n_meta_items, F, W)
  const unsigned char* meta_mask;  // (n_meta_items, F, W) bool
  long long n_meta_items;
  float* meta[kMaxFeatures];  // F augmented (meta_rows[f], d+1) tables, updated in place
  long long meta_rows[kMaxFeatures];
  // scratch, written by (a) and read by (b)
  float* rows;     // (B, 3 or 4, 128): update rows u, p, n (+ u's vector, msq_p, msq_n)
  float* rmeta;    // (B, 2, F, W): 1/sqrt(acc + msq + eps) per unmasked slot
  float* partial;  // (blocks,) per-block loss sums
  float* loss_out;  // one float: loss_sum * inv
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_comp(float4& v, int j, float x) {
  (j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w) = x;
}

// column c of the row held as one float4 per thread
__device__ __forceinline__ float column(const float4& v, int c) {
  return __shfl_sync(kFull, comp(v, c & 3), c >> 2);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }

// One 16-byte vector reduction (sm_90: REDG.E.ADD.F32x4).
__device__ __forceinline__ void add4(float* p, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// log(1 + e^x), as jax.nn.softplus (logaddexp(x, 0))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// An id read from ids[i], checked against its table's row count.
__device__ __forceinline__ long long checked_id(const long long* ids, long long i, long long rows) {
  const long long v = ids[i];
  if ((unsigned long long)v >= (unsigned long long)rows) __trap();
  return v;
}

// Rowwise-adagrad update row of one occurrence: vector lanes
// -lr * g / sqrt(acc + msq + eps), lane d the accumulator increment msq,
// lane d+1 the bias delta, lane d+2 the bias accumulator increment.
__device__ __forceinline__ float4 update_row(const float4& g, float acc, float gb, float bacc,
                                             int col0, const Hyper& h, float& msq) {
  msq = warp_sum(g.x * g.x + g.y * g.y + g.z * g.z + g.w * g.w) * h.inv_d;
  const float r = 1.0f / sqrtf(acc + msq + h.eps);
  const float dbias = -h.lr * (gb * (1.0f / sqrtf(bacc + gb * gb + h.eps)));
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + j;
    float v = c < h.d ? -h.lr * (comp(g, j) * r) : 0.0f;
    if (c == h.d) v = msq;
    if (c == h.d + 1) v = dbias;
    if (c == h.d + 2) v = gb * gb;
    o[j] = v;
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

struct RowOut {
  float4 uo, po, no;
  float loss;          // the row's loss, times w with USE_W
  float uv[4];         // the user's vector lanes as the score saw them (bf16-rounded with BF16)
  float msq_p, msq_n;  // the item occurrences' mean squares
};

// The TPU kernel's math for one row held as one float4 per lane.
template <int LOSS, bool SIGMOID, bool USE_W, bool EMIT_G, bool ITEM_UPD, bool BF16>
__device__ __forceinline__ void row_math(const float4& u, const float4& p, const float4& n, float w,
                                         int col0, const Hyper& h, RowOut& o) {
  float pv[4], nv[4];
  float dp_ = 0.0f, dn_ = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool vec = col0 + j < h.d;
    o.uv[j] = vec ? rnd<BF16>(comp(u, j)) : 0.0f;
    pv[j] = vec ? rnd<BF16>(comp(p, j)) : 0.0f;
    nv[j] = vec ? rnd<BF16>(comp(n, j)) : 0.0f;
    dp_ += o.uv[j] * pv[j];
    dn_ += o.uv[j] * nv[j];
  }
  const float dot_p = warp_sum(dp_);
  const float dot_n = warp_sum(dn_);
  const float acc_u = column(u, h.d), bacc_u = column(u, h.d + 2);
  const float acc_p = column(p, h.d), bacc_p = column(p, h.d + 2);
  const float acc_n = column(n, h.d), bacc_n = column(n, h.d + 2);
  const float b_u = rnd<BF16>(column(u, h.d + 1));
  const float b_p = rnd<BF16>(column(p, h.d + 1));
  const float b_n = rnd<BF16>(column(n, h.d + 1));

  const float raw_p = dot_p + b_u + b_p;
  const float raw_n = dot_n + b_u + b_n;
  const float s_p = SIGMOID ? sigmoid(raw_p) : raw_p;
  const float s_n = SIGMOID ? sigmoid(raw_n) : raw_n;
  float l, dp, dn;
  if constexpr (LOSS == kHinge) {
    const float diff = s_n - s_p + h.margin;
    l = fmaxf(diff, 0.0f);
    // jnp.maximum's subgradient: half to each side at the kink
    const float act = (diff > 0.0f ? 1.0f : 0.0f) + 0.5f * (diff == 0.0f ? 1.0f : 0.0f);
    dp = -act;
    dn = act;
  } else if constexpr (LOSS == kBpr) {
    const float diff = s_n - s_p;
    l = softplus(diff);
    const float sig = sigmoid(diff);
    dp = -sig;
    dn = sig;
  } else {
    l = -0.5f * (-softplus(-s_p) + -softplus(s_n));
    dp = -0.5f * sigmoid(-s_p);
    dn = 0.5f * sigmoid(s_n);
  }
  if constexpr (SIGMOID) {
    dp = dp * s_p * (1.0f - s_p);
    dn = dn * s_n * (1.0f - s_n);
  }
  const float gp = dp * (w * h.inv);
  const float gn = dn * (w * h.inv);
  o.loss = USE_W ? l * w : l;

  const float4 gu = make_float4(gp * pv[0] + gn * nv[0], gp * pv[1] + gn * nv[1],
                                gp * pv[2] + gn * nv[2], gp * pv[3] + gn * nv[3]);
  float msq_u;
  o.uo = update_row(gu, acc_u, gp + gn, bacc_u, col0, h, msq_u);
  if constexpr (EMIT_G) {
    if (h.d + 4 >= col0 && h.d + 4 < col0 + 4) set_comp(o.uo, h.d + 4 - col0, gp);
    if (h.d + 5 >= col0 && h.d + 5 < col0 + 4) set_comp(o.uo, h.d + 5 - col0, gn);
  }
  if constexpr (ITEM_UPD) {
    const float4 gpv = make_float4(gp * o.uv[0], gp * o.uv[1], gp * o.uv[2], gp * o.uv[3]);
    const float4 gnv = make_float4(gn * o.uv[0], gn * o.uv[1], gn * o.uv[2], gn * o.uv[3]);
    o.po = update_row(gpv, acc_p, gp, bacc_p, col0, h, o.msq_p);
    o.no = update_row(gnv, acc_n, gn, bacc_n, col0, h, o.msq_n);
  }
}

// Each thread's share of the block's loss: one value per warp, summed in
// warp order by thread 0 into out.
__device__ __forceinline__ void block_loss(float l, float* out) {
  __shared__ float row_loss[kWarps];
  if ((threadIdx.x & 31) == 0) row_loss[threadIdx.x >> 5] = l;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += row_loss[i];
    *out = s;
  }
}

// The per-block loss sums added in a fixed order by one block of
// kSumThreads threads (strided per thread, a butterfly per warp, the warp
// sums in warp order); every thread gets the total.
__device__ __forceinline__ float fold(const float* __restrict__ partial, int count) {
  __shared__ float warp_part[kSumThreads / 32];
  float v = 0.0f;
  for (int i = threadIdx.x; i < count; i += kSumThreads) v += partial[i];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kSumThreads / 32; ++i) s += warp_part[i];
  return s;
}

template <int LOSS, bool SIGMOID, bool USE_W, bool EMIT_G, bool ITEM_UPD, bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_pairwise_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float l = 0.0f;
  if (row < a.B) {  // warp-uniform
    const size_t off = (size_t)row * kLanes + lane * 4;
    RowOut o;
    row_math<LOSS, SIGMOID, USE_W, EMIT_G, ITEM_UPD, BF16>(
        ld4(a.u + off), ld4(a.p + off), ld4(a.n + off), USE_W ? a.w[row] : 1.0f, lane * 4, a.h, o);
    l = o.loss;
    st4(a.uo + off, o.uo);
    if constexpr (ITEM_UPD) {
      st4(a.po + off, o.po);
      st4(a.no + off, o.no);
    }
  }
  block_loss(l, a.partial + blockIdx.x);
}

// One block: the per-block loss sums added in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
fused_pairwise_loss_sum_kernel(const float* __restrict__ partial, int count,
                               float* __restrict__ out) {
  const float s = fold(partial, count);
  if (threadIdx.x == 0) out[0] = s;
}

// Scratch rows per batch row: the three update rows, and with metadata a
// fourth holding the user's vector lanes with msq_p, msq_n in lanes d, d+1.
template <bool META>
constexpr int kScratchRows = META ? 4 : 3;

// Adds the masked sum of item `it`'s metadata rows into the vector lanes of
// its row (the composite: item_vec + sum_f masked_sum(meta_f)).
__device__ __forceinline__ void composite(const StepArgs& a, long long it, int col0, float4& row) {
  const int d = a.h.d;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long base = it * a.F * a.W;
  for (int f = 0; f < a.F; ++f) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* table = a.meta[f];
    const long long rows = a.meta_rows[f];
    for (int w = 0; w < a.W; ++w) {
      const long long slot = base + (long long)f * a.W + w;
      const long long mid = checked_id(a.meta_ids, slot, rows);
      if (a.meta_mask[slot]) {  // a masked slot adds +-0: skipped
        const float* r = table + mid * (d + 1) + col0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + j < d) c[j] += r[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += c[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col0 + j < d) set_comp(row, j, comp(row, j) + s[j]);
}

// 1/sqrt(acc + msq + eps) of each unmasked metadata slot of item `it`, from
// the slot's pre-step accumulator (lane 0 stores).
__device__ __forceinline__ void meta_scales(const StepArgs& a, long long it, float msq, float* out,
                                            int lane) {
  const int d = a.h.d;
  const long long base = it * a.F * a.W;
  for (int k = lane; k < a.F * a.W; k += 32) {
    if (a.meta_mask[base + k]) {
      const int f = k / a.W;
      const float acc = a.meta[f][a.meta_ids[base + k] * (d + 1) + d];
      out[k] = 1.0f / sqrtf(acc + msq + a.h.eps);
    }
  }
}

// (a) read by id, composite, row math, scratch.
template <int LOSS, bool SIGMOID, bool USE_W, bool BF16, bool META>
__global__ void __launch_bounds__(kThreads)
fused_pairwise_step_kernel(const StepArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int col0 = lane * 4;
  const int d = a.h.d;
  float l = 0.0f;
  if (row < a.B) {  // warp-uniform
    const long long ui = checked_id(a.uid, row, a.n_user);
    const long long pi = checked_id(a.pid, row, a.n_item);
    const long long ni = checked_id(a.nid, row, a.n_item);
    if (META && (pi >= a.n_meta_items || ni >= a.n_meta_items)) __trap();
    // the math reads columns 0..d+2 only
    const bool in = col0 < d + 3;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 u = in ? ld4(a.user + ui * kLanes + col0) : z;
    float4 p = in ? ld4(a.item + pi * kLanes + col0) : z;
    float4 n = in ? ld4(a.item + ni * kLanes + col0) : z;
    if constexpr (META) {
      composite(a, pi, col0, p);
      composite(a, ni, col0, n);
    }
    RowOut o;
    row_math<LOSS, SIGMOID, USE_W, META, true, BF16>(u, p, n, USE_W ? a.w[row] : 1.0f, col0, a.h, o);
    l = o.loss;
    float* s = a.rows + (size_t)row * kScratchRows<META> * kLanes + col0;
    if (col0 < d + (META ? 6 : 3)) {  // the lanes that carry data
      st4(s, o.uo);
      st4(s + kLanes, o.po);
      st4(s + 2 * kLanes, o.no);
    }
    if constexpr (META) {
      float4 x = make_float4(o.uv[0], o.uv[1], o.uv[2], o.uv[3]);
      if (d >= col0 && d < col0 + 4) set_comp(x, d - col0, o.msq_p);
      if (d + 1 >= col0 && d + 1 < col0 + 4) set_comp(x, d + 1 - col0, o.msq_n);
      if (col0 < d + 2) st4(s + 3 * kLanes, x);
      const int fw = a.F * a.W;
      meta_scales(a, pi, o.msq_p, a.rmeta + (size_t)row * 2 * fw, lane);
      meta_scales(a, ni, o.msq_n, a.rmeta + ((size_t)row * 2 + 1) * fw, lane);
    }
  }
  block_loss(l, a.partial + blockIdx.x);
}

// (b) add the scratch rows into the tables; one extra block (the last)
// folds the loss sums and stores the loss, beside the rows' blocks.
template <bool META>
__global__ void __launch_bounds__(kThreads)
fused_pairwise_apply_kernel(const StepArgs a, int partials) {
  if (blockIdx.x == gridDim.x - 1) {
    const float s = fold(a.partial, partials);
    if (threadIdx.x == 0) *a.loss_out = s * a.h.inv;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int col0 = lane * 4;
  const int d = a.h.d;
  if (row >= a.B) return;  // warp-uniform
  const long long ui = a.uid[row], pi = a.pid[row], ni = a.nid[row];
  const float* s = a.rows + (size_t)row * kScratchRows<META> * kLanes + col0;
  const bool live = col0 < d + (META ? 6 : 3);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 uo = live ? ld4(s) : z;
  if (live) {
    add4(a.user + ui * kLanes + col0, uo);
    add4(a.item + pi * kLanes + col0, ld4(s + kLanes));
    add4(a.item + ni * kLanes + col0, ld4(s + 2 * kLanes));
  }
  if constexpr (META) {
    const float4 x = col0 < d + 2 ? ld4(s + 3 * kLanes) : z;
    const float gs[2] = {column(uo, d + 4), column(uo, d + 5)};
    const float msq[2] = {column(x, d), column(x, d + 1)};
    const int fw = a.F * a.W;
    for (int side = 0; side < 2; ++side) {
      const long long base = (side ? ni : pi) * fw;
      const float* r = a.rmeta + ((size_t)row * 2 + side) * fw;
      float dl[4];  // -lr * g, g = d score / d meta slot = g_side * u
#pragma unroll
      for (int j = 0; j < 4; ++j) dl[j] = -a.h.lr * (gs[side] * comp(x, j));
      for (int k = 0; k < fw; ++k) {
        if (!a.meta_mask[base + k]) continue;  // warp-uniform; its delta is +-0
        const int f = k / a.W;
        float* dst = a.meta[f] + a.meta_ids[base + k] * (d + 1) + col0;
        const float rk = r[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col0 + j < d) atomicAdd(dst + j, dl[j] * rk);
          else if (col0 + j == d) atomicAdd(dst + j, msq[side]);
        }
      }
    }
  }
}

__global__ void fused_pairwise_empty_kernel() {}

using LaunchFn = void (*)(const Args&, int, cudaStream_t);

// variant index: loss * 32 + sigmoid * 16 + use_w * 8 + emit_g * 4 +
// item_upd * 2 + bf16
template <int I>
void launch_variant(const Args& a, int blocks, cudaStream_t stream) {
  fused_pairwise_kernel<I / 32, (I & 16) != 0, (I & 8) != 0, (I & 4) != 0, (I & 2) != 0,
                        (I & 1) != 0><<<blocks, kThreads, 0, stream>>>(a);
}

template <int... Is>
constexpr std::array<LaunchFn, sizeof...(Is)> make_table(std::integer_sequence<int, Is...>) {
  return {&launch_variant<Is>...};
}

const std::array<LaunchFn, 96> kVariants = make_table(std::make_integer_sequence<int, 96>{});

using StepFn = void (*)(const StepArgs&, int, cudaStream_t);

// step variant index: loss * 16 + sigmoid * 8 + use_w * 4 + bf16 * 2 + meta
template <int I>
void launch_step_variant(const StepArgs& a, int blocks, cudaStream_t stream) {
  fused_pairwise_step_kernel<I / 16, (I & 8) != 0, (I & 4) != 0, (I & 2) != 0, (I & 1) != 0>
      <<<blocks, kThreads, 0, stream>>>(a);
}

template <int... Is>
constexpr std::array<StepFn, sizeof...(Is)> make_step_table(std::integer_sequence<int, Is...>) {
  return {&launch_step_variant<Is>...};
}

const std::array<StepFn, 48> kStepVariants = make_step_table(std::make_integer_sequence<int, 48>{});

int blocks_for(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int trs_fused_pairwise_lanes() { return kLanes; }

// Blocks of the main launch for B rows: the length of the per-block loss
// scratch the wrapper allocates.
int trs_fused_pairwise_blocks(int B) { return blocks_for(B); }

// Launch the row-level kernel and the loss sum on ``stream``. u, p, n, uo,
// po, no: (B, 128) f32, contiguous, 16-byte aligned; w: (B,) f32 or null;
// partial: trs_fused_pairwise_blocks(B) floats; loss_sum: one float.
// Returns a cudaError_t (cudaGetLastError after the launches).
int trs_fused_pairwise(int loss, int sigmoid, int use_w, int emit_g, int item_upd, int bf16,
                       const float* u, const float* p, const float* n, const float* w, int B,
                       int d, float inv_d, float inv, float lr, float margin, float eps,
                       float* uo, float* po, float* no, float* partial, float* loss_sum,
                       cudaStream_t stream) {
  if (loss < 0 || loss > 2 || B < 1 || d < 1 || d + 3 > kLanes ||
      (emit_g && d + 6 > kLanes) || (use_w && w == nullptr) ||
      (item_upd && (po == nullptr || no == nullptr)))
    return cudaErrorInvalidValue;
  Args a{u, p, n, w, B, Hyper{d, inv_d, inv, lr, margin, eps}, uo, po, no, partial};
  const int idx = loss * 32 + (sigmoid ? 16 : 0) + (use_w ? 8 : 0) + (emit_g ? 4 : 0) +
                  (item_upd ? 2 : 0) + (bf16 ? 1 : 0);
  const int blocks = blocks_for(B);
  kVariants[idx](a, blocks, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_pairwise_loss_sum_kernel<<<1, kSumThreads, 0, stream>>>(partial, blocks, loss_sum);
  return cudaGetLastError();
}

// Floats of scratch one step needs (update rows, metadata scales, loss
// sums), for B rows and, with metadata, F features of W slots.
long long trs_fused_pairwise_step_scratch(int meta, int B, int F, int W) {
  return (long long)B * (meta ? kScratchRows<true> : kScratchRows<false>) * kLanes +
         (meta ? (long long)B * 2 * F * W : 0) + blocks_for(B);
}

// One fused step on ``stream``: two launches, (a) then (b). user/item: the
// packed (n_user, 128) / (n_item, 128) f32 tables, contiguous, 16-byte
// aligned, updated in place; uid/pid/nid: (B,) int64; w: (B,) f32 or null.
// With meta: meta_ids (n_meta_items, F, W) int64, meta_mask the same shape
// as bool bytes, meta_vec / meta_rows host arrays of F device pointers to
// the augmented (meta_rows[f], d+1) f32 tables and their row counts.
// scratch: trs_fused_pairwise_step_scratch(B, F, W) floats, 16-byte aligned;
// loss_out: one float. Returns a cudaError_t.
int trs_fused_pairwise_step(int loss, int sigmoid, int use_w, int bf16, int meta, float* user,
                            long long n_user, float* item, long long n_item,
                            const long long* uid, const long long* pid, const long long* nid,
                            const float* w, int B, int d, float inv_d, float inv, float lr,
                            float margin, float eps, int F, int W, const long long* meta_ids,
                            const unsigned char* meta_mask, long long n_meta_items,
                            float* const* meta_vec, const long long* meta_rows, float* scratch,
                            float* loss_out, cudaStream_t stream) {
  if (!meta) F = W = 0;
  if (loss < 0 || loss > 2 || B < 1 || d < 1 || d + (meta ? 6 : 3) > kLanes || F < 0 || W < 0 ||
      F > kMaxFeatures || (meta && F * W > 0 && (meta_ids == nullptr || meta_mask == nullptr)) ||
      (use_w && w == nullptr))
    return cudaErrorInvalidValue;
  StepArgs a{};
  a.user = user;
  a.item = item;
  a.n_user = n_user;
  a.n_item = n_item;
  a.uid = uid;
  a.pid = pid;
  a.nid = nid;
  a.w = w;
  a.B = B;
  a.h = Hyper{d, inv_d, inv, lr, margin, eps};
  a.F = F;
  a.W = W;
  a.meta_ids = meta_ids;
  a.meta_mask = meta_mask;
  a.n_meta_items = n_meta_items;
  for (int f = 0; f < F; ++f) {
    a.meta[f] = meta_vec[f];
    a.meta_rows[f] = meta_rows[f];
  }
  const int blocks = blocks_for(B);
  a.rows = scratch;
  a.rmeta = scratch + (size_t)B * (meta ? kScratchRows<true> : kScratchRows<false>) * kLanes;
  a.partial = a.rmeta + (meta ? (size_t)B * 2 * F * W : 0);
  a.loss_out = loss_out;
  const int idx = loss * 16 + (sigmoid ? 8 : 0) + (use_w ? 4 : 0) + (bf16 ? 2 : 0) + (meta ? 1 : 0);
  kStepVariants[idx](a, blocks, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (meta)
    fused_pairwise_apply_kernel<true><<<blocks + 1, kThreads, 0, stream>>>(a, blocks);
  else
    fused_pairwise_apply_kernel<false><<<blocks + 1, kThreads, 0, stream>>>(a, blocks);
  return cudaGetLastError();
}

// An empty kernel on the step's grid: the launch floor a step is measured
// against.
int trs_fused_pairwise_empty(int B, cudaStream_t stream) {
  fused_pairwise_empty_kernel<<<blocks_for(B), kThreads, 0, stream>>>();
  return cudaGetLastError();
}

}  // extern "C"
