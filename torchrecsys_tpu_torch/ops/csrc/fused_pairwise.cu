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
// its derivatives, scaled by w[r] * inv, and writes update rows that the
// caller scatter-adds into the packed tables: -lr * rowwise-adagrad deltas
// in the vector and bias lanes, accumulator increments in lanes d and d+2.
// The user row is ONE occurrence with the combined gradient gp*p + gn*n;
// the positive and negative item rows are separate occurrences. With
// emit_g the per-row d loss / d raw scalars gp, gn go to lanes d+4, d+5 of
// the user update row (the metadata step forms its metadata gradients from
// them). The weighted loss sum comes out as one scalar.
//
// The TPU kernel walks 1024-row VMEM tiles in a sequential grid carrying a
// running loss in SMEM. Rows are independent, so here one warp owns one
// row: 128 lanes = 32 threads x one float4, coalesced 512-byte row loads
// and stores, warp-shuffle sums for the dots and the mean squares. Each
// block writes the loss sum of its rows; a second one-block launch adds
// the block sums in a fixed order, so repeated runs give the same loss.
//
// Bound: 3 input and up to 3 output rows of 512 bytes per row (the bytes
// the TPU kernel's cost_estimate counts, :346-350) plus the weights: at
// B = 1024 about 3.1 MB, ~0.94 us at 3.35 TB/s; ~10 flops per lane are far
// below the f32 rate. Memory-bound; the design moves each byte once, with
// 16-byte accesses and no shared-memory staging.
//
// Numerics follow the TPU kernel: 1/sqrtf (IEEE, no rsqrtf approximation;
// build without --use_fast_math), msq = sum(g^2) * (1/d) with 1/d rounded
// to f32 on the host, and the hinge subgradient (diff > 0) + 0.5*(diff == 0).
// Every flag of the TPU kernel is a template parameter: loss, sigmoid,
// use_w, emit_g, item_upd and bf16 (score-path values rounded to bf16, the
// accumulators and the loss kept in f32).

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
constexpr unsigned kFull = 0xffffffffu;

enum Loss { kHinge = 0, kBpr = 1, kLogistic = 2 };

struct Args {
  const float* u;
  const float* p;
  const float* n;
  const float* w;  // (B,) weights, read only with USE_W
  int B;
  int d;
  float inv_d;   // f32(1/d)
  float inv;     // 1 / max(sum of weights, 1), or 1/B
  float lr;
  float margin;
  float eps;
  float* uo;
  float* po;  // written only with ITEM_UPD
  float* no;
  float* partial;  // (gridDim.x,) per-block loss sums
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// column c of the row held as one float4 per thread
__device__ __forceinline__ float column(const float4& v, int c) {
  return __shfl_sync(kFull, comp(v, c & 3), c >> 2);
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

// Rowwise-adagrad update row of one occurrence: vector lanes
// -lr * g / sqrt(acc + msq + eps), lane d the accumulator increment msq,
// lane d+1 the bias delta, lane d+2 the bias accumulator increment.
__device__ __forceinline__ float4 update_row(const float4& g, float acc, float gb, float bacc,
                                             int col0, const Args& a) {
  const float msq = warp_sum(g.x * g.x + g.y * g.y + g.z * g.z + g.w * g.w) * a.inv_d;
  const float r = 1.0f / sqrtf(acc + msq + a.eps);
  const float dbias = -a.lr * (gb * (1.0f / sqrtf(bacc + gb * gb + a.eps)));
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + j;
    float v = c < a.d ? -a.lr * (comp(g, j) * r) : 0.0f;
    if (c == a.d) v = msq;
    if (c == a.d + 1) v = dbias;
    if (c == a.d + 2) v = gb * gb;
    o[j] = v;
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

template <int LOSS, bool SIGMOID, bool USE_W, bool EMIT_G, bool ITEM_UPD, bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_pairwise_kernel(const Args a) {
  __shared__ float row_loss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  float l = 0.0f;
  if (row < a.B) {  // warp-uniform
    const size_t off = (size_t)row * kLanes + lane * 4;
    const float4 u = *reinterpret_cast<const float4*>(a.u + off);
    const float4 p = *reinterpret_cast<const float4*>(a.p + off);
    const float4 n = *reinterpret_cast<const float4*>(a.n + off);
    const int col0 = lane * 4;
    float uv[4], pv[4], nv[4];
    float dp_ = 0.0f, dn_ = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool vec = col0 + j < a.d;
      uv[j] = vec ? rnd<BF16>(comp(u, j)) : 0.0f;
      pv[j] = vec ? rnd<BF16>(comp(p, j)) : 0.0f;
      nv[j] = vec ? rnd<BF16>(comp(n, j)) : 0.0f;
      dp_ += uv[j] * pv[j];
      dn_ += uv[j] * nv[j];
    }
    const float dot_p = warp_sum(dp_);
    const float dot_n = warp_sum(dn_);
    const float acc_u = column(u, a.d), bacc_u = column(u, a.d + 2);
    const float acc_p = column(p, a.d), bacc_p = column(p, a.d + 2);
    const float acc_n = column(n, a.d), bacc_n = column(n, a.d + 2);
    const float b_u = rnd<BF16>(column(u, a.d + 1));
    const float b_p = rnd<BF16>(column(p, a.d + 1));
    const float b_n = rnd<BF16>(column(n, a.d + 1));

    const float raw_p = dot_p + b_u + b_p;
    const float raw_n = dot_n + b_u + b_n;
    const float s_p = SIGMOID ? sigmoid(raw_p) : raw_p;
    const float s_n = SIGMOID ? sigmoid(raw_n) : raw_n;
    float dp, dn;
    if constexpr (LOSS == kHinge) {
      const float diff = s_n - s_p + a.margin;
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
    const float w = USE_W ? a.w[row] : 1.0f;
    const float gp = dp * (w * a.inv);
    const float gn = dn * (w * a.inv);
    if constexpr (USE_W) l = l * w;

    const float4 gu = make_float4(gp * pv[0] + gn * nv[0], gp * pv[1] + gn * nv[1],
                                  gp * pv[2] + gn * nv[2], gp * pv[3] + gn * nv[3]);
    float4 uo = update_row(gu, acc_u, gp + gn, bacc_u, col0, a);
    if constexpr (EMIT_G) {
      if (a.d + 4 >= col0 && a.d + 4 < col0 + 4) {
        const int j = a.d + 4 - col0;
        (j == 0 ? uo.x : j == 1 ? uo.y : j == 2 ? uo.z : uo.w) = gp;
      }
      if (a.d + 5 >= col0 && a.d + 5 < col0 + 4) {
        const int j = a.d + 5 - col0;
        (j == 0 ? uo.x : j == 1 ? uo.y : j == 2 ? uo.z : uo.w) = gn;
      }
    }
    *reinterpret_cast<float4*>(a.uo + off) = uo;
    if constexpr (ITEM_UPD) {
      const float4 gpv = make_float4(gp * uv[0], gp * uv[1], gp * uv[2], gp * uv[3]);
      const float4 gnv = make_float4(gn * uv[0], gn * uv[1], gn * uv[2], gn * uv[3]);
      *reinterpret_cast<float4*>(a.po + off) = update_row(gpv, acc_p, gp, bacc_p, col0, a);
      *reinterpret_cast<float4*>(a.no + off) = update_row(gnv, acc_n, gn, bacc_n, col0, a);
    }
  }
  if (lane == 0) row_loss[warp] = l;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += row_loss[i];
    a.partial[blockIdx.x] = s;
  }
}

// One block: the per-block loss sums added in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
fused_pairwise_loss_sum_kernel(const float* __restrict__ partial, int count,
                               float* __restrict__ out) {
  __shared__ float s[kSumThreads];
  float v = 0.0f;
  for (int i = threadIdx.x; i < count; i += kSumThreads) v += partial[i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

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

}  // namespace

extern "C" {

int trs_fused_pairwise_lanes() { return kLanes; }

// Blocks of the main launch for B rows: the length of the per-block loss
// scratch the wrapper allocates.
int trs_fused_pairwise_blocks(int B) { return (B + kWarps - 1) / kWarps; }

// Launch the step kernel and the loss sum on ``stream``. u, p, n, uo, po,
// no: (B, 128) f32, contiguous, 16-byte aligned; w: (B,) f32 or null;
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
  Args a{u, p, n, w, B, d, inv_d, inv, lr, margin, eps, uo, po, no, partial};
  const int idx = loss * 32 + (sigmoid ? 16 : 0) + (use_w ? 8 : 0) + (emit_g ? 4 : 0) +
                  (item_upd ? 2 : 0) + (bf16 ? 1 : 0);
  const int blocks = trs_fused_pairwise_blocks(B);
  kVariants[idx](a, blocks, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_pairwise_loss_sum_kernel<<<1, kSumThreads, 0, stream>>>(partial, blocks, loss_sum);
  return cudaGetLastError();
}

}  // extern "C"
