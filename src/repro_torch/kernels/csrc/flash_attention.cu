// Blocked online-softmax attention (flash attention) for Hopper (sm_90a),
// with GQA, an optional causal mask and an optional sliding window.
//
// Replaces the Pallas TPU kernel `flash_attention` (body `_fa_kernel`) in
// src/repro/kernels/flash_attention.py.  Same semantics: q (B,H,Tq,dh),
// k/v (B,Hkv,Tk,dh); query head h reads kv head h / (H/Hkv) of the same
// batch row (the TPU kernel's `bh // group` on the flattened B*H axis);
// positions are end-aligned, offs = Tk - Tq, so query row i sits at
// position i + offs; key j is seen when j < Tk, j <= qpos (causal) and
// j > qpos - W (window).  Masked scores are -1e30, rows whose normaliser is
// 0 give 0, accumulation is in f32 and the output is written in q's type.
// The wrapper refuses Tq > Tk: rows that see no key would then differ by
// convention (this kernel gives 0, the plain version NaN), and the model
// never calls it so.
//
// What bounds it on this card: operations.  At the model's prefill shape
// (B=8, S=2048, H=25, Hkv=5, dh=64, W=1024, causal) each (b, h) has ~1.57M
// unmasked (q, k) pairs, 4*dh flops each: ~8e10 flops against ~126 MB of
// q, k, v and o.  That is ~81 us at the tensor cores' bf16 rate and ~38 us
// of HBM time.  This first kernel does not reach the tensor cores: it is
// plain f32 FMA arithmetic (67 TFLOP/s peak), so its floor is ~1.2 ms.
// The design keeps what the TPU kernel keeps out of device memory, and
// leaves wgmma, TMA and pipelining to later work:
//
// * One block per (b*h, tile of 64 query rows).  The Pallas kernel carries
//   acc, m and l in VMEM scratch across a *sequential* kv grid axis; CUDA
//   blocks run in no order, so the block loops over the key/value tiles
//   itself and keeps m and l in registers and acc in registers (dh/4
//   values per thread).  Nothing but the output goes back to HBM.
// * Four threads per query row (256 threads).  The Q tile and each K/V
//   tile are staged in shared memory as f32 (converted on load, rows padded
//   by one float against bank conflicts); each thread scores 16 of the
//   tile's 64 keys, the row's max and sum are reduced over its four lanes
//   with xor-shuffles (every lane ends with the same bits), the
//   probabilities go through shared memory, and each thread accumulates
//   its dh/4 output columns.
// * Tiles that the causal mask or the window leave fully masked for the
//   whole query tile are skipped, as the TPU kernel's `_needed` does.
// * No atomics: two launches on the same inputs give bit-equal outputs.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;          // query rows per block
constexpr int kBlockK = 64;          // keys per tile
constexpr int kLanes = 4;            // threads per query row
constexpr int kThreads = kBlockQ * kLanes;
constexpr int kKeysPerLane = kBlockK / kLanes;
constexpr float kNeg = -1e30f;

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

// Copy rows [row0, row0 + 64) of a (rows, DH) matrix into shared memory as
// f32 with a row stride of DH + 1; rows at or past `rows` are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int row0, int rows,
                                           float* __restrict__ dst) {
  for (int i = threadIdx.x; i < kBlockK * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const int g = row0 + r;
    dst[r * (DH + 1) + c] =
        g < rows ? to_f32(src[static_cast<long long>(g) * DH + c]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h,
                       int group, int tq, int tk, float scale, int causal,
                       int window) {
  constexpr int kStride = DH + 1;
  constexpr int kCols = DH / kLanes;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                            // (64, DH+1)
  float* ks = qs + kBlockQ * kStride;          // (64, DH+1)
  float* vs = ks + kBlockK * kStride;          // (64, DH+1)
  float* ps = vs + kBlockK * kStride;          // (64, 65)

  const int bh = blockIdx.x;
  const int bkv = (bh / h) * (h / group) + (bh % h) / group;
  const int q0 = blockIdx.y * kBlockQ;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int offs = tk - tq;
  const int qpos = q0 + row + offs;

  const T* qb = q + static_cast<long long>(bh) * tq * DH;
  const T* kb = k + static_cast<long long>(bkv) * tk * DH;
  const T* vb = v + static_cast<long long>(bkv) * tk * DH;

  stage_tile<T, DH>(qb, q0, tq, qs);

  float m = kNeg, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;

  const int n_tiles = (tk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    // skip tiles masked for every row of the query tile (block-uniform)
    if (causal && k0 > q0 + kBlockQ - 1 + offs) break;
    if (window > 0 && k0 + kBlockK - 1 <= q0 + offs - window) continue;

    __syncthreads();   // the previous tile's K, V and P are consumed
    stage_tile<T, DH>(kb, k0, tk, ks);
    stage_tile<T, DH>(vb, k0, tk, vs);
    __syncthreads();

    // scores for keys j = lane + 4*i of this tile
    float s[kKeysPerLane];
    float tile_max = kNeg;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + kLanes * i;
      const float* qr = qs + row * kStride;
      const float* kr = ks + j * kStride;
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < DH; ++c) dot = fmaf(qr[c], kr[c], dot);
      const int kpos = k0 + j;
      bool ok = kpos < tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[i] = ok ? dot * scale : kNeg;
      tile_max = fmaxf(tile_max, s[i]);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + kLanes * i;
      // a masked score is exactly kNeg; a live one never is
      const float p = s[i] == kNeg ? 0.f : expf(s[i] - m_new);
      ps[row * (kBlockK + 1) + j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();      // the row's four lanes share one warp

    const float* pr = ps + row * (kBlockK + 1);
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] *= corr;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * kStride + lane;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] = fmaf(p, vr[kLanes * e], acc[e]);
    }
  }

  if (q0 + row < tq) {
    const float inv = l > 0.f ? 1.f / l : 1.f;
    T* orow = o + (static_cast<long long>(bh) * tq + q0 + row) * DH + lane;
#pragma unroll
    for (int e = 0; e < kCols; ++e) orow[kLanes * e] = from_f32<T>(acc[e] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int tq, int tk, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (3 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1));
  // above 48 KB only with an opt-in (set per call: it is per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, h / hkv, tq, tk, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int b, int h, int hkv, int tq, int tk, float scale, int causal,
              int window, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, h, tq, dh), k and v (b, hkv, tk, dh), o (b, h, tq, dh): contiguous,
// one device, all f32 (dtype 0) or all bf16 (dtype 1).  dh in {16, 32, 64,
// 128}; h % hkv == 0; 1 <= tq <= tk; window <= 0 means no window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int hkv, int tq, int tk, int dh,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || tq <= 0 || tk < tq ||
      tq > 65535 * kBlockQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
