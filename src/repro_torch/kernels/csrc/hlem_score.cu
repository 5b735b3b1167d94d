// HLEM-VMP host scoring (paper Eqs. 3-11) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/hlem_score.py: both
// entries, hlem_score_pallas (one VM) and hlem_score_pallas_batch (B VMs
// against shared host state), share its body `_kernel`, so here they share
// one kernel with a batch dimension; the single-VM entry is B = 1.
//
// What bounds it on this card: latency, not bytes or arithmetic.  Each batch
// row reads every host's free capacity and spot fraction (2 x D x 4 B) and
// its mask byte once and writes one float: about 37 B per host at D = 4, so
// ~0.47 MB at n = 12,583 hosts, well under 1 us of HBM time.  The four
// stages depend on each other through three reductions over all n hosts,
// so what a call costs is the launch, the round trips to device memory and
// the reductions' barriers.  The design:
//
// * One thread-block cluster of C CTAs per batch row, on neighbouring SMs
//   (cudaLaunchKernelEx with a cluster dimension).  C depends on n alone
//   (cluster_size: the smallest power of two with C * 1024 >= n, at most
//   16), so a batch row and the single-VM launch on the same mask decompose
//   identically and give the same bits.  CTA c owns hosts [c*s, (c+1)*s),
//   s = ceil(n / C).
// * Each CTA reads its slice from device memory once, with asynchronous
//   copies (cp.async, 16 B where aligned) of free and spot straight into
//   shared memory and the mask bytes batched through registers: every load
//   is issued before any is waited on, and the four stages then read the
//   slice from shared memory.  A slice too large for kResidentBytes (n above
//   ~47,000 at D = 4) is read from device memory in each stage instead.
// * The three reductions (min/max/count, column sums, sum p ln p) are fixed
//   order: warp shuffles, then warps in order, give each CTA's partials in
//   its own shared memory; after a cluster barrier every CTA loads all C
//   partials through distributed shared memory (all loads issued first) and
//   combines them in rank order 0..C-1, so every CTA holds the same bits
//   without a broadcast.  No atomics: two launches on the same inputs give
//   bit-equal scores (the simulator's contract is bit-identical replays).
// * 128 threads a CTA keep registers and shared memory per CTA small
//   enough for eight CTAs on an SM, so 64 rows of 16 CTAs fit the card in
//   one wave.
// * Every CTA derives the D entropy weights itself from those identical
//   sums and writes the scores of its own slice.  A CTA arrives on the
//   cluster barrier after its last remote read and waits on it before it
//   exits, so no CTA's shared memory goes away while another reads it.
// * B = 64 rows at n = 12,583 give 64 clusters of 16 CTAs, which fill the
//   card; the 60-machine quick trace gives C = 1.
//
// Semantics kept from the TPU kernel: min/max start at +-3.4e38; a column
// whose span is <= 1e-12 standardises to 1; p falls back to mask/m where a
// column sum is <= 1e-12; k = 1/ln(m) only when m > 1; the weights are 1/D
// when sum(g) <= 1e-12; masked hosts score -3.4e38.  D comes from the shape
// (the TPU kernel fixed d_real = 4, which only differs when D < 4).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;
constexpr int kMaxParts = 2 * kMaxDims + 1;   // lo, hi and the count
constexpr int kHostsPerCta = 1024;     // the cluster rule's unit
constexpr int kMaxCluster = 16;        // above 8: a non-portable cluster size
constexpr int kMaskUnroll = 8;         // mask loads in flight per thread
constexpr size_t kResidentBytes = 96 * 1024;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3.4e38f;

// The cluster rule: the smallest power of two C with C * 1024 >= n, at most
// 16.  n <= 1024 -> 1; <= 2048 -> 2; <= 4096 -> 4; <= 8192 -> 8; else 16.
int cluster_size(int n) {
  int c = 1;
  while (c < kMaxCluster && static_cast<long long>(c) * kHostsPerCta < n) c *= 2;
  return c;
}

// Reduction operators, by the index k of the value they combine.
struct Sum {
  __device__ float operator()(int, float a, float b) const { return a + b; }
};
template <int D>   // [0, D) min of lo, [D, 2D) max of hi, 2D the count
struct MinMaxCount {
  __device__ float operator()(int k, float a, float b) const {
    return k < D ? fminf(a, b) : k < 2 * D ? fmaxf(a, b) : a + b;
  }
};

// Reduce K per-thread values over the block in a fixed order into
// `result[0..K)` (shared memory); visible to every thread after the call.
template <int K, typename Op>
__device__ __forceinline__ void block_reduce(const float (&x)[K],
                                             float (*scratch)[kMaxParts],
                                             float* result, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = x[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = op(k, v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = scratch[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = op(threadIdx.x, v, scratch[w][threadIdx.x]);
    result[threadIdx.x] = v;
  }
  __syncthreads();
}

// Combine the K partials at `part` of every CTA of the cluster, in rank
// order 0..C-1, into `result[0..K)` of this CTA; every remote load is
// issued before the first is used.  Call after a cluster barrier.
template <int K, typename Op>
__device__ __forceinline__ void cluster_combine(cg::cluster_group& cluster,
                                                float* part, float* result,
                                                Op op) {
  if (threadIdx.x < K) {
    const int csize = static_cast<int>(cluster.num_blocks());
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < csize ? *cluster.map_shared_rank(part + threadIdx.x, r) : 0.f;
    float acc = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < csize) acc = op(threadIdx.x, acc, v[r]);
    result[threadIdx.x] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes16) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

template <int D, bool kResident>
__device__ __forceinline__ void load_host(const float* __restrict__ base,
                                          int i, float (&v)[D]) {
  if constexpr (D == 4 && kResident) {   // 16-byte shared-memory loads
    const float4 q = reinterpret_cast<const float4*>(base)[i];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = base[static_cast<size_t>(i) * D + k];
  }
}

template <int D, bool kResident>
__global__ void __launch_bounds__(kThreads)
hlem_score_kernel(const float* __restrict__ free_cap,
                  const uint8_t* __restrict__ masks,
                  const float* __restrict__ spot,
                  const float* __restrict__ alphas, float alpha_all,
                  float* __restrict__ out, int n, int slice) {
  extern __shared__ float4 dyn[];   // the resident slice: free, spot, mask
  __shared__ float scratch[kWarps][kMaxParts];
  // this CTA's partials, one array per reduction (read remotely)
  __shared__ float p_1[kMaxParts], p_col[kMaxDims], p_plp[kMaxDims];
  // the cluster's combined values: s_1 = lo[D], hi[D], count
  __shared__ float s_1[kMaxParts], s_col[kMaxDims], s_plp[kMaxDims];
  __shared__ float s_w[kMaxDims];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / csize;
  const int start = rank * slice;
  const int cnt = max(0, min(n, start + slice) - start);

  const uint8_t* __restrict__ mask_g = masks + static_cast<size_t>(row) * n + start;
  const float* __restrict__ free_g = free_cap + static_cast<size_t>(start) * D;
  const float* __restrict__ spot_g = spot + static_cast<size_t>(start) * D;
  float* __restrict__ o = out + static_cast<size_t>(row) * n + start;

  float* s_free = reinterpret_cast<float*>(dyn);
  float* s_spot = s_free + slice * D;
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_spot + slice * D);
  if constexpr (kResident) {
    // free and spot by asynchronous copies, 16 B each where both sides are
    // aligned; the mask bytes kMaskUnroll at a time through registers
    const int nf = cnt * D;
    const bool vec16 =
        nf % 4 == 0 && (slice * D) % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(free_g) |
          reinterpret_cast<uintptr_t>(spot_g)) & 15) == 0;
    const int step = vec16 ? 4 : 1;
    for (int i = threadIdx.x * step; i < nf; i += kThreads * step) {
      cp_async(s_free + i, free_g + i, vec16);
      cp_async(s_spot + i, spot_g + i, vec16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i0 = threadIdx.x; i0 < cnt; i0 += kThreads * kMaskUnroll) {
      uint8_t mk[kMaskUnroll];
#pragma unroll
      for (int u = 0; u < kMaskUnroll; ++u) {
        const int i = i0 + u * kThreads;
        mk[u] = i < cnt ? __ldg(mask_g + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kMaskUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < cnt) s_mask[i] = mk[u];
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const float* __restrict__ fsrc = kResident ? s_free : free_g;
  const float* __restrict__ ssrc = kResident ? s_spot : spot_g;
  const uint8_t* __restrict__ msrc = kResident ? s_mask : mask_g;
  float f[D];

  // stage 1 - masked per-dim min/max and candidate count (Eq. 3)
  float v1[2 * D + 1];   // lo[D], hi[D], count
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v1[k] = kBig;
    v1[D + k] = -kBig;
  }
  v1[2 * D] = 0.f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      v1[k] = fminf(v1[k], f[k]);
      v1[D + k] = fmaxf(v1[D + k], f[k]);
    }
    v1[2 * D] += 1.f;
  }
  block_reduce<2 * D + 1>(v1, scratch, p_1, MinMaxCount<D>());
  cluster.sync();
  cluster_combine<2 * D + 1>(cluster, p_1, s_1, MinMaxCount<D>());

  float lo[D], span[D];
  bool degen[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = s_1[k];
    span[k] = s_1[D + k] - lo[k];
    degen[k] = span[k] <= kEps;
  }

  // stage 2 - column sums of the standardised capacity (Eq. 4 denominator)
  float col[D];
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = 0.f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k)
      col[k] += degen[k] ? 1.f : (f[k] - lo[k]) / span[k];
  }
  block_reduce<D>(col, scratch, p_col, Sum());
  cluster.sync();
  cluster_combine<D>(cluster, p_col, s_col, Sum());
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = s_col[k];

  // stage 3 - sum of p ln p per dim (Eq. 5)
  const float m = s_1[2 * D];
  const float p_even = 1.f / fmaxf(m, 1.f);
  float plp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) plp[k] = 0.f;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float c = degen[k] ? 1.f : (f[k] - lo[k]) / span[k];
      const float p = col[k] > kEps ? c / col[k] : p_even;
      plp[k] += p > kEps ? p * logf(fmaxf(p, kEps)) : 0.f;
    }
  }
  block_reduce<D>(plp, scratch, p_plp, Sum());
  cluster.sync();
  cluster_combine<D>(cluster, p_plp, s_plp, Sum());
  // the last remote read is done: release the other CTAs' wait at exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // entropy weights (Eqs. 6-8), the same bits in every CTA of the cluster
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
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) {
      o[i] = -kBig;
      continue;
    }
    load_host<D, kResident>(fsrc, i, f);
    load_host<D, kResident>(ssrc, i, sf);
    float hs = 0.f, sl = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      hs += (degen[k] ? 1.f : (f[k] - lo[k]) / span[k]) * w[k];
      sl += sf[k] * w[k];
    }
    o[i] = hs * (1.f + alpha * sl);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int D, bool kResident>
int launch_kernel(const float* free_cap, const uint8_t* masks,
                  const float* spot, const float* alphas, float alpha_all,
                  float* out, int n, int b, cudaStream_t stream) {
  const int c = cluster_size(n);
  const int slice = (n + c - 1) / c;
  const size_t smem =
      kResident ? (static_cast<size_t>(slice) * (8 * D + 1) + 15) / 16 * 16 : 0;
  auto kernel = hlem_score_kernel<D, kResident>;
  cudaError_t err = cudaSuccess;
  if (c > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, free_cap, masks, spot, alphas,
                           alpha_all, out, n, slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* free_cap, const uint8_t* masks, const float* spot,
             const float* alphas, float alpha_all, float* out, int n, int b,
             cudaStream_t stream) {
  const int c = cluster_size(n);
  const size_t slice = (static_cast<size_t>(n) + c - 1) / c;
  if (slice * (8 * D + 1) <= kResidentBytes)
    return launch_kernel<D, true>(free_cap, masks, spot, alphas, alpha_all,
                                  out, n, b, stream);
  return launch_kernel<D, false>(free_cap, masks, spot, alphas, alpha_all,
                                 out, n, b, stream);
}

}  // namespace

// The number of CTAs in the cluster that scores one row of n hosts.
extern "C" int hlem_score_cluster_size(int n) {
  return n > 0 ? cluster_size(n) : 0;
}

// free_cap (n, d) f32, masks (b, n) u8, spot (n, d) f32, all row-major and
// contiguous on one device; alphas (b,) f32 on the device, or null to use
// alpha_all for every row; out (b, n) f32.  1 <= d <= 8, n < 2^24.
extern "C" int hlem_score_launch(const float* free_cap, const uint8_t* masks,
                                 const float* spot, const float* alphas,
                                 float alpha_all, float* out, int n, int d,
                                 int b, void* stream) {
  if (n <= 0 || n >= (1 << 24) || b <= 0 || d < 1 || d > kMaxDims ||
      static_cast<long long>(b) * cluster_size(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_d<1>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 2: return launch_d<2>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 3: return launch_d<3>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 4: return launch_d<4>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 5: return launch_d<5>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 6: return launch_d<6>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    case 7: return launch_d<7>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
    default: return launch_d<8>(free_cap, masks, spot, alphas, alpha_all, out, n, b, s);
  }
}
