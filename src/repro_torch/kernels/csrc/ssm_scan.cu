// Mamba-1 selective state-space scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssm_scan` (body `_ssm_kernel`) in
// src/repro/kernels/ssm_scan.py.  Same semantics, per batch row b and
// channel d, over t = 0 .. T-1:
//     h_t = exp(dt_t * a) * h_{t-1} + (dt_t * b_t) * x_t      (N states)
//     y_t = sum_n h_t * c_t + d * x_t
// with h_{-1} = h0 (zeros when absent).  x, dt, b, c are f32 or bf16 and
// read as f32; a (Dm, N), d (Dm,) and h0 are f32; y is written in x's type
// and the final state hT in f32.
//
// What bounds it on this card: bytes at best.  At the model's prefill shape
// (B=8, T=2048, Dm=3200, N=16, bf16) the scan must read x and dt and write
// y once (~315 MB, ~94 us at 3.35 TB/s), against ~8.4e8 exps and ~3.4e9
// other f32 operations (~51 us at 67 TFLOP/s if exps cost one slot).  The
// recurrence is sequential in t, so what actually limits this first kernel
// is latency: each thread walks all T steps.  The design keeps the state
// out of device memory, as the TPU kernel keeps it in VMEM:
//
// * One thread per (batch row, channel): it holds its N states and its row
//   of `a` in registers (N <= 64, templated on the power of two >= N) and
//   walks all T steps, so the state never goes to device memory.  This
//   takes the place of the TPU kernel's sequential time-block grid axis and
//   its VMEM scratch.  Blocks of 64 channels of one batch row.
// * b_t and c_t are shared by every channel of a batch row: the block
//   stages them in shared memory 32 time steps at a time, together with the
//   chunk's x and dt (read coalesced across d, all loads of a chunk in
//   flight at once).  y is written coalesced across d.
// * exp, the multiply-adds and the N-reduction are f32 (expf, no fast-math
//   intrinsics).  The same kernel serves prefill (T = prompt) and decode
//   (T = 1).  No atomics: reruns are bit-equal.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 32;     // time steps staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T, int MAXN>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int t_len, int dm, int n) {
  __shared__ float xs[kChunk][kThreads];
  __shared__ float dts[kChunk][kThreads];
  __shared__ float bs[kChunk][MAXN];
  __shared__ float cs[kChunk][MAXN];

  const int bb = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < dm;

  float h[MAXN], av[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    const long long idx = (static_cast<long long>(bb) * dm + d) * n + i;
    av[i] = live && i < n ? a[static_cast<long long>(d) * n + i] : 0.f;
    h[i] = live && i < n && h0 != nullptr ? h0[idx] : 0.f;
  }
  const float dd = live ? dskip[d] : 0.f;

  const long long row = static_cast<long long>(bb) * t_len;
  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int steps = min(kChunk, t_len - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int s = 0; s < steps; ++s) {
      const long long g = (row + t0 + s) * dm + d;
      xs[s][threadIdx.x] = live ? to_f32(x[g]) : 0.f;
      dts[s][threadIdx.x] = live ? to_f32(dt[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < steps * n; i += kThreads) {
      const int s = i / n, k = i % n;
      const long long g = (row + t0 + s) * n + k;
      bs[s][k] = to_f32(bm[g]);
      cs[s][k] = to_f32(cm[g]);
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const float xt = xs[s][threadIdx.x];
      const float dtt = dts[s][threadIdx.x];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < n) {
          h[i] = expf(dtt * av[i]) * h[i] + (dtt * bs[s][i]) * xt;
          acc = fmaf(h[i], cs[s][i], acc);
        }
      }
      if (live)
        y[(row + t0 + s) * dm + d] = from_f32<T>(acc + xt * dd);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      if (i < n) hT[(static_cast<long long>(bb) * dm + d) * n + i] = h[i];
  }
}

template <typename T, int MAXN>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const float* d, const float* h0, void* y, float* hT,
           int bsz, int t_len, int dm, int n, cudaStream_t stream) {
  const dim3 grid((dm + kThreads - 1) / kThreads, bsz);
  ssm_scan_kernel<T, MAXN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d, h0,
      static_cast<T*>(y), hT, t_len, dm, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* dt, const float* a, const void* b,
             const void* c, const float* d, const float* h0, void* y,
             float* hT, int bsz, int t_len, int dm, int n, cudaStream_t s) {
  if (n <= 8) return launch<T, 8>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (n <= 16) return launch<T, 16>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (n <= 32) return launch<T, 32>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  return launch<T, 64>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
}

}  // namespace

// x, dt (bsz, t_len, dm) and b, c (bsz, t_len, n), all f32 (dtype 0) or all
// bf16 (dtype 1); a (dm, n), d (dm,), h0 (bsz, dm, n) or null, hT
// (bsz, dm, n): f32.  y (bsz, t_len, dm) in the inputs' type.  All
// contiguous on one device; 1 <= n <= 64.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const float* a,
                               const void* b, const void* c, const float* d,
                               const float* h0, void* y, float* hT, int bsz,
                               int t_len, int dm, int n, int dtype,
                               void* stream) {
  if (bsz <= 0 || bsz > 65535 || t_len <= 0 || dm <= 0 || n < 1 || n > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
