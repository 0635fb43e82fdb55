// The layer norm of the SASRec encoder for Hopper (sm_90a), forward and
// backward, behind a plain C interface (bound with ctypes in
// torchrecsys_tpu_torch/ops/layer_norm.py, built by ops/_build.py).
//
// Replaces no TPU kernel. The JAX package writes the norm as jnp ops
// (torchrecsys_tpu/models/sasrec.py) and leaves them to XLA's fusion; eager
// PyTorch has no such fusion and runs the same formula as ~15 separate ops
// forward and ~40 backward, each a pass over the activations. For rows of x
// (rows, d), scale and bias (d,):
//
//   mean = sum(x) / d,  var = sum((x - mean)^2) / d,  rstd = rsqrtf(var + eps)
//   y    = (x - mean) * rstd * scale + bias
//
// and, for a cotangent dy (rows, d), with xhat = (x - mean) * rstd and
// g = dy * scale,
//
//   dx     = rstd * (g - mean_row(g) - xhat * mean_row(g * xhat))
//   dscale = sum_rows dy * xhat,  dbias = sum_rows dy
//
// x, dy, y, dx, scale, bias, dscale and dbias are f32 or bf16 (one type a
// call); every operation is f32 (no fast-math intrinsic but rsqrtf, which
// the plain version's torch.rsqrt also runs); mean and rstd are kept per row
// in f32 for the backward, which recomputes xhat from them. The variance is
// the mean of (x - mean)^2 taken in a second pass over the registers, never
// E[x^2] - mean^2. A padded row (x = 0) gives mean 0, rstd = 1/sqrt(eps),
// y = bias exactly and, where its dy is 0, dx = 0 exactly.
//
// Bound by bytes: two passes forward (read x, write y), three backward (read
// x and dy, write dx); the per-row mean and rstd add 8 bytes a row. At the
// SASRec cell's shape (409,600 rows x 50, f32) that is 167 / 249 MB, 50 / 74
// us at 3.35 TB/s. The design:
// - One row per warp, held in registers: lane l holds columns l, l + 32, ...,
//   so each load of a warp reads 32 neighbouring elements, coalesced for any
//   d (d = 50 gives 200-byte rows, not 16-byte aligned, so no vector loads).
//   The row sums are butterfly shuffles: every lane gets the same bits.
// - A grid-stride loop over rows, with as many 8-warp blocks as the card
//   holds at once (the occupancy of the instance times the SM count), so
//   132 SMs stay full and no block waits for a second wave.
// - Rows wider than 512 columns take the looped path: one warp a block, the
//   row read from memory (L1) once per pass.
// - Backward: each warp adds dy * xhat and dy per column over its rows in
//   compensated f32 sums (the cell sums 409,600 rows into each column); the
//   block adds its warps in a fixed order and writes one row of partials to
//   scratch (blocks, d) for each; a second launch adds each column's
//   partials in a fixed order into dscale and dbias in x's type. No float
//   atomics anywhere: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // warps of a register-path block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVpl = 16;  // register path: d <= 32 * kMaxVpl
constexpr int kSumWarps = 32;  // warps of a column-sum block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// ---------------------------------------------------------------------------
// register path: one row per warp, 8 warps a block
// ---------------------------------------------------------------------------

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads) ln_fwd_regs(const T* __restrict__ x, const T* __restrict__ scale,
                                                        const T* __restrict__ bias, T* __restrict__ y,
                                                        float* __restrict__ mean, float* __restrict__ rstd,
                                                        long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.0f / static_cast<float>(d);
  float sc[VPL], bi[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + 32 * k;
    sc[k] = c < d ? ld(scale + c) : 0.f;
    bi[k] = c < d ? ld(bias + c) : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < rows; r += step) {
    const T* xr = x + r * d;
    float v[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < d ? ld(xr + c) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) s += v[k];
    const float m = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < d) {
        const float t = v[k] - m;
        q += t * t;
      }
    }
    const float rs = rsqrtf(warp_sum(q) * inv_d + eps);
    T* yr = y + r * d;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      if (c < d) st(yr + c, (v[k] - m) * rs * sc[k] + bi[k]);
    }
    if (lane == 0) {
      mean[r] = m;
      rstd[r] = rs;
    }
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads) ln_bwd_regs(const T* __restrict__ x, const T* __restrict__ dy,
                                                        const T* __restrict__ scale, const float* __restrict__ mean,
                                                        const float* __restrict__ rstd, T* __restrict__ dx,
                                                        float* __restrict__ dscale_part,
                                                        float* __restrict__ dbias_part, long long rows, int d) {
  __shared__ float red[2][kWarps][32 * VPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / static_cast<float>(d);
  float sc[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + 32 * k;
    sc[k] = c < d ? ld(scale + c) : 0.f;
  }
  Sum ds[VPL], db[VPL];
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < rows; r += step) {
    const T* xr = x + r * d;
    const T* dyr = dy + r * d;
    float xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      xv[k] = c < d ? ld(xr + c) : 0.f;
      dv[k] = c < d ? ld(dyr + c) : 0.f;
    }
    const float m = mean[r], rs = rstd[r];
    float xh[VPL], g[VPL];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      xh[k] = (xv[k] - m) * rs;
      g[k] = dv[k] * sc[k];
      if (lane + 32 * k < d) {
        sg += g[k];
        sgx += g[k] * xh[k];
        ds[k].add(dv[k] * xh[k]);
        db[k].add(dv[k]);
      }
    }
    const float mg = warp_sum(sg) * inv_d;
    const float mgx = warp_sum(sgx) * inv_d;
    T* dxr = dx + r * d;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      if (c < d) st(dxr + c, rs * (g[k] - mg - xh[k] * mgx));
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    red[0][warp][lane + 32 * k] = ds[k].value();
    red[1][warp][lane + 32 * k] = db[k].value();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d; i += kThreads) {
    const int which = i >= d, c = i - which * d;
    float w[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) w[j] = red[which][j][c];
#pragma unroll
    for (int h = kWarps / 2; h > 0; h >>= 1)
#pragma unroll
      for (int j = 0; j < h; ++j) w[j] += w[j + h];
    (which ? dbias_part : dscale_part)[static_cast<long long>(blockIdx.x) * d + c] = w[0];
  }
}

// ---------------------------------------------------------------------------
// looped path (d > 32 * kMaxVpl): one row per one-warp block
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32) ln_fwd_loop(const T* __restrict__ x, const T* __restrict__ scale,
                                                  const T* __restrict__ bias, T* __restrict__ y,
                                                  float* __restrict__ mean, float* __restrict__ rstd,
                                                  long long rows, int d, float eps) {
  const int lane = threadIdx.x;
  const float inv_d = 1.0f / static_cast<float>(d);
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += ld(xr + c);
    const float m = warp_sum(s) * inv_d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = ld(xr + c) - m;
      q += t * t;
    }
    const float rs = rsqrtf(warp_sum(q) * inv_d + eps);
    T* yr = y + r * d;
    for (int c = lane; c < d; c += 32) st(yr + c, (ld(xr + c) - m) * rs * ld(scale + c) + ld(bias + c));
    if (lane == 0) {
      mean[r] = m;
      rstd[r] = rs;
    }
  }
}

// The block's row of partials is its own: lane l adds into columns l, l + 32,
// ... of it, row after row, in plain f32 (rows / blocks rows each).
template <typename T>
__global__ void __launch_bounds__(32) ln_bwd_loop(const T* __restrict__ x, const T* __restrict__ dy,
                                                  const T* __restrict__ scale, const float* __restrict__ mean,
                                                  const float* __restrict__ rstd, T* __restrict__ dx,
                                                  float* __restrict__ dscale_part, float* __restrict__ dbias_part,
                                                  long long rows, int d) {
  const int lane = threadIdx.x;
  const float inv_d = 1.0f / static_cast<float>(d);
  float* ps = dscale_part + static_cast<long long>(blockIdx.x) * d;
  float* pb = dbias_part + static_cast<long long>(blockIdx.x) * d;
  for (int c = lane; c < d; c += 32) ps[c] = pb[c] = 0.f;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    const T* dyr = dy + r * d;
    const float m = mean[r], rs = rstd[r];
    float sg = 0.f, sgx = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float g = ld(dyr + c) * ld(scale + c);
      sg += g;
      sgx += g * ((ld(xr + c) - m) * rs);
    }
    const float mg = warp_sum(sg) * inv_d;
    const float mgx = warp_sum(sgx) * inv_d;
    T* dxr = dx + r * d;
    for (int c = lane; c < d; c += 32) {
      const float xh = (ld(xr + c) - m) * rs;
      const float dv = ld(dyr + c);
      const float g = dv * ld(scale + c);
      st(dxr + c, rs * (g - mg - xh * mgx));
      ps[c] += dv * xh;
      pb[c] += dv;
    }
  }
}

// ---------------------------------------------------------------------------
// the column sums of the partials, in a fixed order
// ---------------------------------------------------------------------------

// Block (column group of 32, which): warp w adds partial rows w, w + 32, ...
// of its 32 columns (compensated), then the 32 warps are added as a tree.
template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps) ln_colsum(const float* __restrict__ dscale_part,
                                                            const float* __restrict__ dbias_part, int parts, int d,
                                                            T* __restrict__ dscale, T* __restrict__ dbias) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* part = blockIdx.y ? dbias_part : dscale_part;
  Sum acc;
  if (c < d) {
    constexpr int kAhead = 8;  // loads in flight per lane
    int p = warp;
    for (; p + (kAhead - 1) * kSumWarps < parts; p += kAhead * kSumWarps) {
      float v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) v[j] = part[static_cast<long long>(p + j * kSumWarps) * d + c];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) acc.add(v[j]);
    }
    for (; p < parts; p += kSumWarps) acc.add(part[static_cast<long long>(p) * d + c]);
  }
  red[warp][lane] = acc.value();
  __syncthreads();
  for (int h = kSumWarps / 2; h > 0; h >>= 1) {
    if (warp < h) red[warp][lane] += red[warp + h][lane];
    __syncthreads();
  }
  if (warp == 0 && c < d) st((blockIdx.y ? dbias : dscale) + c, red[0][lane]);
}

// ---------------------------------------------------------------------------
// launch plans
// ---------------------------------------------------------------------------

// f(std::integral_constant<int, V>()) with V the columns a lane holds on the
// register path (d <= 32 V), or V = 0 for the looped path.
template <typename F>
int by_width(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 1>());
  if (d <= 64) return f(std::integral_constant<int, 2>());
  if (d <= 128) return f(std::integral_constant<int, 4>());
  if (d <= 256) return f(std::integral_constant<int, 8>());
  if (d <= 32 * kMaxVpl) return f(std::integral_constant<int, 16>());
  return f(std::integral_constant<int, 0>());
}

// Blocks of a launch of the forward or backward kernel at width V: as many
// as the card holds at once (the kernel's occupancy, asked once, times the
// SM count), and no more than the rows need.
template <typename T, int V, bool Bwd>
int blocks(long long rows) {
  static const int per_sm = [] {
    const void* fn;
    if constexpr (V > 0)
      fn = Bwd ? reinterpret_cast<const void*>(&ln_bwd_regs<T, V>) : reinterpret_cast<const void*>(&ln_fwd_regs<T, V>);
    else
      fn = Bwd ? reinterpret_cast<const void*>(&ln_bwd_loop<T>) : reinterpret_cast<const void*>(&ln_fwd_loop<T>);
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, V > 0 ? kThreads : 32, 0) == cudaSuccess && n > 0
               ? n
               : 1;
  }();
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  const int rows_per_block = V > 0 ? kWarps : 1;
  const long long want = (rows + rows_per_block - 1) / rows_per_block;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long g = want < cap ? want : cap;
  return g < 1 ? 1 : static_cast<int>(g);
}

template <typename T>
int fwd(const T* x, const T* scale, const T* bias, T* y, float* mean, float* rstd, long long rows, int d, float eps,
        cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  return by_width(d, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const int g = blocks<T, V, false>(rows);
    if constexpr (V > 0)
      ln_fwd_regs<T, V><<<g, kThreads, 0, stream>>>(x, scale, bias, y, mean, rstd, rows, d, eps);
    else
      ln_fwd_loop<T><<<g, 32, 0, stream>>>(x, scale, bias, y, mean, rstd, rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int bwd(const T* x, const T* dy, const T* scale, const float* mean, const float* rstd, T* dx, float* dscale_part,
        float* dbias_part, T* dscale, T* dbias, long long rows, int d, cudaStream_t stream) {
  return by_width(d, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const int g = blocks<T, V, true>(rows);
    if constexpr (V > 0)
      ln_bwd_regs<T, V><<<g, kThreads, 0, stream>>>(x, dy, scale, mean, rstd, dx, dscale_part, dbias_part, rows, d);
    else
      ln_bwd_loop<T><<<g, 32, 0, stream>>>(x, dy, scale, mean, rstd, dx, dscale_part, dbias_part, rows, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ln_colsum<T><<<dim3((d + 31) / 32, 2), 32 * kSumWarps, 0, stream>>>(dscale_part, dbias_part, g, d, dscale, dbias);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int parts(long long rows, int d) {
  return by_width(d, [&](auto v) { return blocks<T, decltype(v)::value, true>(rows); });
}

bool bad_shape(long long rows, int d) { return rows < 0 || d < 1; }

}  // namespace

extern "C" {

// Rows of partials (each of d floats, one array for dscale and one for
// dbias) the backward writes for ``rows`` rows of ``d``: its block count.
// -1 on a bad shape.
int trs_layer_norm_parts(long long rows, int d, int is_bf16) {
  if (bad_shape(rows, d)) return -1;
  return is_bf16 ? parts<bf16>(rows, d) : parts<float>(rows, d);
}

// Forward on ``stream``. x (rows, d), scale, bias (d,), y (rows, d): f32, or
// bf16 where is_bf16; mean, rstd (rows,) f32. Returns a cudaError_t
// (cudaGetLastError after the launch).
int trs_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y, float* mean, float* rstd,
                       long long rows, int d, float eps, int is_bf16, cudaStream_t stream) {
  if (bad_shape(rows, d)) return cudaErrorInvalidValue;
  if (is_bf16)
    return fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
               static_cast<bf16*>(y), mean, rstd, rows, d, eps, stream);
  return fwd(static_cast<const float*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
             static_cast<float*>(y), mean, rstd, rows, d, eps, stream);
}

// Backward on ``stream``: dx (rows, d), and dscale, dbias (d,) in x's type,
// from x, dy (rows, d), scale (d,) and the forward's mean, rstd. dscale_part
// and dbias_part: trs_layer_norm_parts(rows, d) x d floats each. Two
// launches (the rows, then the column sums). Returns a cudaError_t.
int trs_layer_norm_bwd(const void* x, const void* dy, const void* scale, const float* mean, const float* rstd,
                       void* dx, float* dscale_part, float* dbias_part, void* dscale, void* dbias, long long rows,
                       int d, int is_bf16, cudaStream_t stream) {
  if (bad_shape(rows, d)) return cudaErrorInvalidValue;
  if (is_bf16)
    return bwd(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(scale), mean,
               rstd, static_cast<bf16*>(dx), dscale_part, dbias_part, static_cast<bf16*>(dscale),
               static_cast<bf16*>(dbias), rows, d, stream);
  return bwd(static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(scale), mean,
             rstd, static_cast<float*>(dx), dscale_part, dbias_part, static_cast<float*>(dscale),
             static_cast<float*>(dbias), rows, d, stream);
}

}  // extern "C"
