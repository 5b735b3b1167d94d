// HLEM-VMP host scoring (paper Eqs. 3-11) for Hopper (sm_90a), in float64.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/hlem_score.py: both
// entries, hlem_score_pallas (one VM) and hlem_score_pallas_batch (B VMs
// against shared host state), share its body `_kernel`, so here they share
// one kernel with a batch dimension; the single-VM entry is B = 1.  The
// arithmetic is float64, as the reference's default scorer (the numpy
// oracle, repro.core.hlem.hlem_pick_candidates_np) computes it: float32
// cannot tell apart two hosts whose scores differ by less than ~6e-8
// relative, and its ties then pick another host than the oracle does.
//
// What bounds it on this card: latency, not bytes or arithmetic.  Each batch
// row reads every host's free capacity and spot fraction (2 x D x 8 B) and
// its mask byte once and writes one double: about 73 B per host at D = 4, so
// ~0.92 MB at n = 12,583 hosts, well under 1 us of HBM time, and ~120 FP64
// operations a host, further under the card's FP64 rate.  The four stages
// depend on each other through three reductions over all n hosts, so what a
// call costs is the launch, the round trips to device memory and the
// reductions' barriers.  The design:
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
//   ~24,000 at D = 4) is read from device memory in each stage instead.
// * The three reductions (min/max/count, column sums, sum p ln p) are fixed
//   order: warp shuffles, then warps in order, give each CTA's partials in
//   its own shared memory; after a cluster barrier every CTA loads all C
//   partials through distributed shared memory (all loads issued first) and
//   combines them in rank order 0..C-1, so every CTA holds the same bits
//   without a broadcast.  No atomics: two launches on the same inputs give
//   bit-equal scores (the simulator's contract is bit-identical replays).
// * Each host's two dot products (Eqs. 9 and 10) are compensated, Ogita,
//   Rump and Oishi's Dot2 over k = 0..D-1 as the plain version computes it:
//   every product's rounding error (one fused multiply-add) and every sum's
//   (two-sum) are carried and added once at the end, so each is its exact
//   value rounded once, up to ~D^2 u^2.  Hosts whose scores are equal in
//   exact arithmetic then score bit-equal whatever the order of their terms
//   or where they sit, and the lowest index wins the tie, as the oracle's
//   argmax does.  About 12 D more operations a host than a plain sum.
// * 128 threads a CTA.  A slice of 787 hosts (n = 12,583, C = 16) takes
//   ~50 KB of shared memory, so about four CTAs share an SM and B = 64 rows
//   of 16 CTAs take two waves of the card.
// * Every CTA derives the D entropy weights itself from those identical
//   sums and writes the scores of its own slice.  A CTA arrives on the
//   cluster barrier after its last remote read and waits on it before it
//   exits, so no CTA's shared memory goes away while another reads it.
//
// Semantics kept from the TPU kernel: min/max start at +-3.4e38; a column
// whose span is <= 1e-12 standardises to 1; p falls back to mask/m where a
// column sum is <= 1e-12; k = 1/ln(m) only when m > 1; the weights are 1/D
// when sum(g) <= 1e-12; masked hosts score -3.4e38.  D comes from the shape
// (the TPU kernel fixed d_real = 4, which only differs when D < 4).
//
// The library also carries each scoring call's upload (hlem_mirror_upload,
// at the end): one copy of the call's pinned inputs and the gather and
// scatter of the changed rows of a pool's device mirror.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
constexpr double kEps = 1e-12;
constexpr double kBig = 3.4e38;

// The cluster rule: the smallest power of two C with C * 1024 >= n, at most
// 16.  n <= 1024 -> 1; <= 2048 -> 2; <= 4096 -> 4; <= 8192 -> 8; else 16.
int cluster_size(int n) {
  int c = 1;
  while (c < kMaxCluster && static_cast<long long>(c) * kHostsPerCta < n) c *= 2;
  return c;
}

// Reduction operators, by the index k of the value they combine.
struct Sum {
  __device__ double operator()(int, double a, double b) const { return a + b; }
};
template <int D>   // [0, D) min of lo, [D, 2D) max of hi, 2D the count
struct MinMaxCount {
  __device__ double operator()(int k, double a, double b) const {
    return k < D ? fmin(a, b) : k < 2 * D ? fmax(a, b) : a + b;
  }
};

// Reduce K per-thread values over the block in a fixed order into
// `result[0..K)` (shared memory); visible to every thread after the call.
template <int K, typename Op>
__device__ __forceinline__ void block_reduce(const double (&x)[K],
                                             double (*scratch)[kMaxParts],
                                             double* result, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double v = x[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = op(k, v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double v = scratch[0][threadIdx.x];
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
                                                double* part, double* result,
                                                Op op) {
  if (threadIdx.x < K) {
    const int csize = static_cast<int>(cluster.num_blocks());
    double v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < csize ? *cluster.map_shared_rank(part + threadIdx.x, r) : 0.0;
    double acc = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < csize) acc = op(threadIdx.x, acc, v[r]);
    result[threadIdx.x] = acc;
  }
  __syncthreads();
}

// One asynchronous copy into shared memory: 16 B (two doubles) or 8 B.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes16) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

template <int D, bool kResident>
__device__ __forceinline__ void load_host(const double* __restrict__ base,
                                          int i, double (&v)[D]) {
  if constexpr (D % 2 == 0 && kResident) {   // 16-byte shared-memory loads
    const double2* q = reinterpret_cast<const double2*>(base) + i * (D / 2);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      const double2 h = q[k];
      v[2 * k] = h.x;
      v[2 * k + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = base[static_cast<size_t>(i) * D + k];
  }
}

// One term of Dot2: p += x * y, and the rounding errors of the product and
// of the sum added to s.  Every operation is rounded on its own (the
// intrinsics are never contracted), as the plain version's tensor ops are.
__device__ __forceinline__ void dot2_step(double x, double y, double& p,
                                          double& s) {
  const double h = __dmul_rn(x, y);
  const double r = __fma_rn(x, y, -h);
  const double t = __dadd_rn(p, h);
  const double z = __dsub_rn(t, p);
  const double q = __dadd_rn(__dsub_rn(p, __dsub_rn(t, z)), __dsub_rn(h, z));
  s = __dadd_rn(s, __dadd_rn(q, r));
  p = t;
}

// Eq. 3 for one value: (f - lo) / span, or 1 on a degenerate column.
__device__ __forceinline__ double standardise(double f, double lo, double span,
                                              bool degen) {
  return degen ? 1.0 : (f - lo) / span;
}

template <int D, bool kResident>
__global__ void __launch_bounds__(kThreads)
hlem_score_kernel(const double* __restrict__ free_cap,
                  const uint8_t* __restrict__ masks,
                  const double* __restrict__ spot,
                  const double* __restrict__ alphas, double alpha_all,
                  double* __restrict__ out, int n, int slice) {
  extern __shared__ double2 dyn[];   // the resident slice: free, spot, mask
  __shared__ double scratch[kWarps][kMaxParts];
  // this CTA's partials, one array per reduction (read remotely)
  __shared__ double p_1[kMaxParts], p_col[kMaxDims], p_plp[kMaxDims];
  // the cluster's combined values: s_1 = lo[D], hi[D], count
  __shared__ double s_1[kMaxParts], s_col[kMaxDims], s_plp[kMaxDims];
  __shared__ double s_w[kMaxDims];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / csize;
  const int start = rank * slice;
  const int cnt = max(0, min(n, start + slice) - start);

  const uint8_t* __restrict__ mask_g = masks + static_cast<size_t>(row) * n + start;
  const double* __restrict__ free_g = free_cap + static_cast<size_t>(start) * D;
  const double* __restrict__ spot_g = spot + static_cast<size_t>(start) * D;
  double* __restrict__ o = out + static_cast<size_t>(row) * n + start;

  double* s_free = reinterpret_cast<double*>(dyn);
  double* s_spot = s_free + static_cast<size_t>(slice) * D;
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_spot + static_cast<size_t>(slice) * D);
  if constexpr (kResident) {
    // free and spot by asynchronous copies, 16 B each where both sides are
    // aligned; the mask bytes kMaskUnroll at a time through registers
    const int nf = cnt * D;
    const bool vec16 =
        nf % 2 == 0 && (slice * D) % 2 == 0 &&
        ((reinterpret_cast<uintptr_t>(free_g) |
          reinterpret_cast<uintptr_t>(spot_g)) & 15) == 0;
    const int step = vec16 ? 2 : 1;
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
  const double* __restrict__ fsrc = kResident ? s_free : free_g;
  const double* __restrict__ ssrc = kResident ? s_spot : spot_g;
  const uint8_t* __restrict__ msrc = kResident ? s_mask : mask_g;
  double f[D];

  // stage 1 - masked per-dim min/max and candidate count (Eq. 3)
  double v1[2 * D + 1];   // lo[D], hi[D], count
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v1[k] = kBig;
    v1[D + k] = -kBig;
  }
  v1[2 * D] = 0.0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      v1[k] = fmin(v1[k], f[k]);
      v1[D + k] = fmax(v1[D + k], f[k]);
    }
    v1[2 * D] += 1.0;
  }
  block_reduce<2 * D + 1>(v1, scratch, p_1, MinMaxCount<D>());
  cluster.sync();
  cluster_combine<2 * D + 1>(cluster, p_1, s_1, MinMaxCount<D>());

  double lo[D], span[D];
  bool degen[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = s_1[k];
    span[k] = s_1[D + k] - lo[k];
    degen[k] = span[k] <= kEps;
  }

  // stage 2 - column sums of the standardised capacity (Eq. 4 denominator)
  double col[D];
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = 0.0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k)
      col[k] += standardise(f[k], lo[k], span[k], degen[k]);
  }
  block_reduce<D>(col, scratch, p_col, Sum());
  cluster.sync();
  cluster_combine<D>(cluster, p_col, s_col, Sum());
#pragma unroll
  for (int k = 0; k < D; ++k) col[k] = s_col[k];

  // stage 3 - sum of p ln p per dim (Eq. 5), the double-precision log
  const double m = s_1[2 * D];
  const double p_even = 1.0 / fmax(m, 1.0);
  double plp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) plp[k] = 0.0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) continue;
    load_host<D, kResident>(fsrc, i, f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const double c = standardise(f[k], lo[k], span[k], degen[k]);
      const double p = col[k] > kEps ? c / col[k] : p_even;
      plp[k] += p > kEps ? __dmul_rn(p, log(fmax(p, kEps))) : 0.0;
    }
  }
  block_reduce<D>(plp, scratch, p_plp, Sum());
  cluster.sync();
  cluster_combine<D>(cluster, p_plp, s_plp, Sum());
  // the last remote read is done: release the other CTAs' wait at exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // entropy weights (Eqs. 6-8), the same bits in every CTA of the cluster
  if (threadIdx.x == 0) {
    const double kk = m > 1.0 ? 1.0 / log(fmax(m, 2.0)) : 0.0;
    double g[D], gsum = 0.0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      g[k] = 1.0 - __dmul_rn(-kk, s_plp[k]);
      gsum += g[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      s_w[k] = gsum > kEps ? g[k] / gsum : 1.0 / D;
  }
  __syncthreads();
  double w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = s_w[k];

  // stage 4 - HS (Eq. 9), SL (Eq. 10), AHS = HS * (1 + alpha * SL) (Eq. 11),
  // HS and SL by Dot2 in the order k = 0..D-1
  const double alpha = alphas != nullptr ? alphas[row] : alpha_all;
  double sf[D];
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    if (!msrc[i]) {
      o[i] = -kBig;
      continue;
    }
    load_host<D, kResident>(fsrc, i, f);
    load_host<D, kResident>(ssrc, i, sf);
    double hp = 0.0, he = 0.0, sp = 0.0, se = 0.0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      dot2_step(standardise(f[k], lo[k], span[k], degen[k]), w[k], hp, he);
      dot2_step(sf[k], w[k], sp, se);
    }
    const double hs = __dadd_rn(hp, he);
    const double sl = __dadd_rn(sp, se);
    o[i] = __dmul_rn(hs, __dadd_rn(1.0, __dmul_rn(alpha, sl)));
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Dynamic shared memory for a resident slice: free and spot (2 x D doubles
// a host) and the mask byte, rounded up to 16 B.
template <int D>
size_t resident_bytes(size_t slice) {
  return (slice * (16 * D + 1) + 15) / 16 * 16;
}

template <int D, bool kResident>
int launch_kernel(const double* free_cap, const uint8_t* masks,
                  const double* spot, const double* alphas, double alpha_all,
                  double* out, int n, int b, cudaStream_t stream) {
  const int c = cluster_size(n);
  const int slice = (n + c - 1) / c;
  const size_t smem = kResident ? resident_bytes<D>(slice) : 0;
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
int launch_d(const double* free_cap, const uint8_t* masks, const double* spot,
             const double* alphas, double alpha_all, double* out, int n, int b,
             cudaStream_t stream) {
  const int c = cluster_size(n);
  const size_t slice = (static_cast<size_t>(n) + c - 1) / c;
  if (resident_bytes<D>(slice) <= kResidentBytes)
    return launch_kernel<D, true>(free_cap, masks, spot, alphas, alpha_all,
                                  out, n, b, stream);
  return launch_kernel<D, false>(free_cap, masks, spot, alphas, alpha_all,
                                 out, n, b, stream);
}

// The last step of each scoring call's upload (hlem_mirror_upload, below).
// The device mirror of a host pool (core/hlem.py, _FleetMirror) keeps the
// pool's free capacity and spot fraction on the card between scoring calls;
// a call brings over only the rows the host wrote since the last one.  This
// kernel writes them in: planes (2, rows, d) f64, free then spot; src
// (2, k, d) f64, the changed rows of each plane in the order of ids (k,)
// i32 (k may be 0).  Then it stores `ticket` to `done`, a word of pinned
// host memory: the upload's copy, which ran before it on the stream, has
// read the pinned bytes, so the host may write them again without a CUDA
// call to ask.  It replaces no TPU kernel (the TPU path staged the whole
// fleet).  It copies bits and computes nothing: a few hundred bytes a call,
// so its launch is its cost.  One thread an element.
__global__ void fleet_mirror_scatter(double* __restrict__ planes,
                                     long long rows,
                                     const double* __restrict__ src,
                                     const int* __restrict__ ids, int k,
                                     int d, volatile long long* done,
                                     long long ticket) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) *done = ticket;
  const int kd = k * d;
  if (e >= 2 * kd) return;
  const int p = e / kd;
  const int r = (e - p * kd) / d;
  const int j = e - p * kd - r * d;
  planes[(p * rows + ids[r]) * d + j] = src[e];
}

}  // namespace

// The number of CTAs in the cluster that scores one row of n hosts.
extern "C" int hlem_score_cluster_size(int n) {
  return n > 0 ? cluster_size(n) : 0;
}

// free_cap (n, d) f64, masks (b, n) u8, spot (n, d) f64, all row-major and
// contiguous on one device; alphas (b,) f64 on the device, or null to use
// alpha_all for every row; out (b, n) f64.  1 <= d <= 8, 1 <= n (an int:
// the count is a double, exact far beyond it).
extern "C" int hlem_score_launch(const double* free_cap, const uint8_t* masks,
                                 const double* spot, const double* alphas,
                                 double alpha_all, double* out, int n, int d,
                                 int b, void* stream) {
  if (n <= 0 || b <= 0 || d < 1 || d > kMaxDims ||
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

// One scoring call's upload on `stream`, at byte offsets into the device
// buffer `dev` and the pinned host buffer `host`, which share one layout:
// when k > 0, first the gather on the host of the k changed rows of the
// pool's planes `pool` (2, rows, d) f64 whose ids (i32) are at host[o_ids]
// into host[o_src] as (2, k, d), copied bits; then the bytes [lo, hi) to
// the card in one asynchronous copy; then one launch of
// fleet_mirror_scatter, which writes the k rows into the mirror's planes
// (2, rows, d) at dev[0] and stores `ticket` to `done` (pinned).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue (nothing done) for a range
// or an id out of bounds.
extern "C" int hlem_mirror_upload(uint8_t* dev, uint8_t* host, long long lo,
                                  long long hi, long long rows, int d,
                                  long long o_src, long long o_ids, int k,
                                  const double* pool, long long* done,
                                  long long ticket, void* stream) {
  if (lo < 0 || hi < lo || k < 0 || done == nullptr ||
      (k > 0 && (d < 1 || rows < 1 || pool == nullptr || o_src < lo ||
                 o_ids != o_src + 16LL * k * d || o_ids + 4LL * k > hi ||
                 2LL * k * d > 0x7fffffffLL)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = reinterpret_cast<const int*>(host + o_ids);
  double* src = reinterpret_cast<double*>(host + o_src);
  for (int r = 0; r < k; ++r) {
    if (ids[r] < 0 || ids[r] >= rows)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int p = 0; p < 2; ++p)
      memcpy(src + (static_cast<long long>(p) * k + r) * d,
             pool + (p * rows + ids[r]) * d, sizeof(double) * d);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemcpyAsync(dev + lo, host + lo,
                                          static_cast<size_t>(hi - lo),
                                          cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kScatterThreads = 256;
  const int blocks =
      k > 0 ? (2 * k * d + kScatterThreads - 1) / kScatterThreads : 1;
  fleet_mirror_scatter<<<blocks, kScatterThreads, 0, s>>>(
      reinterpret_cast<double*>(dev), rows,
      reinterpret_cast<const double*>(dev + o_src),
      reinterpret_cast<const int*>(dev + o_ids), k, d, done, ticket);
  return static_cast<int>(cudaGetLastError());
}
