// HLEM-VMP host scoring (paper Eqs. 3-11) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/hlem_score.py: both
// entries, hlem_score_pallas (one VM) and hlem_score_pallas_batch (B VMs
// against shared host state), share its body `_kernel`, so here they share
// one kernel with a batch dimension; the single-VM entry is B = 1.
//
// What bounds it on this card: bytes and launch latency, not arithmetic.
// Each batch row reads every host's free capacity and spot fraction
// (2 x D x 4 B) and its mask byte once and writes one float: about 37 B per
// host at D = 4.  At n = 12,583 hosts that is ~0.47 MB, under 1 us of HBM
// time at 3.35 TB/s, against several microseconds to launch a kernel and to
// synchronise on its result.  The design therefore keeps everything in ONE
// launch and makes no attempt to fill the card at B = 1:
//
// * The TPU kernel carries its lo/hi/col/plogp/m scratch across a
//   *sequential* (4 stages, n/512) grid.  CUDA blocks run in no order, so
//   one block (CTA) owns one batch row and runs the four stages as a loop;
//   each stage is a strided pass over the n hosts with per-thread partials.
//   Passes 2-4 re-read the row's inputs, which then come from L2 (50 MB).
// * Each stage reduces its partials in a fixed order: warp shuffles, then
//   one value per warp in shared memory, summed warp by warp by one thread.
//   No float atomics, so two launches on the same inputs give bit-equal
//   scores (the simulator's contract is bit-identical replays).
// * One thread derives the D entropy weights after stage 3 and broadcasts
//   them through shared memory; stage 4 writes the scores.
// * At D = 4 (the simulator's only width) each thread loads one float4 per
//   host: 16-byte loads, neighbouring threads on neighbouring hosts.
//
// Semantics kept from the TPU kernel: min/max start at +-3.4e38; a column
// whose span is <= 1e-12 standardises to 1; p falls back to mask/m where a
// column sum is <= 1e-12; k = 1/ln(m) only when m > 1; the weights are 1/D
// when sum(g) <= 1e-12; masked hosts score -3.4e38.  D comes from the shape
// (the TPU kernel fixed d_real = 4, which only differs when D < 4).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3.4e38f;

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduce K per-thread values over the block in a fixed order.  Every thread
// reads the K results from `result` (shared memory) after the call.
template <int K, typename Op>
__device__ __forceinline__ void block_reduce(const float (&x)[K],
                                             float (*scratch)[kMaxDims],
                                             float* result, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = x[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = scratch[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = op(v, scratch[w][threadIdx.x]);
    result[threadIdx.x] = v;
  }
  __syncthreads();
}

template <int D, bool kVec4>
__device__ __forceinline__ void load_host(const float* __restrict__ base,
                                          int i, float (&v)[D]) {
  if constexpr (kVec4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(base) + i);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = __ldg(base + (size_t)i * D + k);
  }
}

template <int D, bool kVec4>
__global__ void __launch_bounds__(kThreads)
hlem_score_kernel(const float* __restrict__ free_cap,
                  const uint8_t* __restrict__ masks,
                  const float* __restrict__ spot,
                  const float* __restrict__ alphas, float alpha_all,
                  float* __restrict__ out, int n) {
  __shared__ float scratch[kWarps][kMaxDims];
  __shared__ float s_lo[kMaxDims], s_hi[kMaxDims], s_col[kMaxDims];
  __shared__ float s_plp[kMaxDims], s_w[kMaxDims], s_m[1];

  const int row = blockIdx.x;
  const uint8_t* __restrict__ mask = masks + (size_t)row * n;
  float* __restrict__ o = out + (size_t)row * n;
  float f[D];

  // stage 1 - masked per-dim min/max and candidate count (Eq. 3)
  float lo[D], hi[D], cnt[1] = {0.f};
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = kBig;
    hi[k] = -kBig;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) continue;
    load_host<D, kVec4>(free_cap, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      lo[k] = fminf(lo[k], f[k]);
      hi[k] = fmaxf(hi[k], f[k]);
    }
    cnt[0] += 1.f;
  }
  block_reduce<D>(lo, scratch, s_lo, Min());
  block_reduce<D>(hi, scratch, s_hi, Max());
  block_reduce<1>(cnt, scratch, s_m, Sum());

  float span[D];
  bool degen[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = s_lo[k];
    span[k] = s_hi[k] - lo[k];
    degen[k] = span[k] <= kEps;
  }

  // stage 2 - column sums of the standardised capacity (Eq. 4 denominator)
  float col[D];
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) continue;
    load_host<D, kVec4>(free_cap, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k)
      col[k] += degen[k] ? 1.f : (f[k] - lo[k]) / span[k];
  }
  block_reduce<D>(col, scratch, s_col, Sum());
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = s_col[k];

  // stage 3 - sum of p ln p per dim (Eq. 5)
  const float m = s_m[0];
  const float p_even = 1.f / fmaxf(m, 1.f);
  float plp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) plp[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) continue;
    load_host<D, kVec4>(free_cap, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float c = degen[k] ? 1.f : (f[k] - lo[k]) / span[k];
      const float p = col[k] > kEps ? c / col[k] : p_even;
      plp[k] += p > kEps ? p * logf(fmaxf(p, kEps)) : 0.f;
    }
  }
  block_reduce<D>(plp, scratch, s_plp, Sum());

  // entropy weights (Eqs. 6-8), derived once and broadcast
  if (threadIdx.x == 0) {
    const float kk = m > 1.f ? 1.f / logf(fmaxf(m, 2.f)) : 0.f;
    float g[D], gsum = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      g[k] = 1.f - (-kk * s_plp[k]);
      gsum += g[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      s_w[k] = gsum > kEps ? g[k] / gsum : 1.f / D;
  }
  __syncthreads();
  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = s_w[k];

  // stage 4 - HS (Eq. 9), SL (Eq. 10), AHS = HS * (1 + alpha * SL) (Eq. 11)
  const float alpha = alphas != nullptr ? alphas[row] : alpha_all;
  float sf[D];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!mask[i]) {
      o[i] = -kBig;
      continue;
    }
    load_host<D, kVec4>(free_cap, i, f);
    load_host<D, kVec4>(spot, i, sf);
    float hs = 0.f, sl = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      hs += (degen[k] ? 1.f : (f[k] - lo[k]) / span[k]) * w[k];
      sl += sf[k] * w[k];
    }
    o[i] = hs * (1.f + alpha * sl);
  }
}

template <int D>
void launch_d(bool vec4, const float* free_cap, const uint8_t* masks,
              const float* spot, const float* alphas, float alpha_all,
              float* out, int n, int b, cudaStream_t stream) {
  if constexpr (D == 4) {
    if (vec4) {
      hlem_score_kernel<4, true><<<b, kThreads, 0, stream>>>(
          free_cap, masks, spot, alphas, alpha_all, out, n);
      return;
    }
  }
  hlem_score_kernel<D, false><<<b, kThreads, 0, stream>>>(
      free_cap, masks, spot, alphas, alpha_all, out, n);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// free_cap (n, d) f32, masks (b, n) u8, spot (n, d) f32, all row-major and
// contiguous on one device; alphas (b,) f32 on the device, or null to use
// alpha_all for every row; out (b, n) f32.  1 <= d <= 8.
extern "C" int hlem_score_launch(const float* free_cap, const uint8_t* masks,
                                 const float* spot, const float* alphas,
                                 float alpha_all, float* out, int n, int d,
                                 int b, void* stream) {
  if (n <= 0 || b <= 0 || d < 1 || d > kMaxDims)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = aligned16(free_cap) && aligned16(spot);
  switch (d) {
    case 1: launch_d<1>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 2: launch_d<2>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 3: launch_d<3>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 4: launch_d<4>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 5: launch_d<5>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 6: launch_d<6>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    case 7: launch_d<7>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
    default: launch_d<8>(vec4, free_cap, masks, spot, alphas, alpha_all, out, n, b, s); break;
  }
  return (int)cudaGetLastError();
}
