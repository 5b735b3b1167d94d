// Blocked online-softmax attention (flash attention) for Hopper (sm_90a),
// with GQA, an optional causal mask and an optional sliding window.
//
// Replaces the Pallas TPU kernel `flash_attention` (body `_fa_kernel`) in
// src/repro/kernels/flash_attention.py.  Same semantics: q (B,H,Tq,dh),
// k/v (B,Hkv,Tk,dh); query head h reads kv head h / (H/Hkv) of the same
// batch row (the TPU kernel's `bh // group` on the flattened B*H axis);
// positions are end-aligned, offs = Tk - Tq, so query row i sits at
// position i + offs; key j is seen when j < Tk, j <= qpos (causal) and
// j > qpos - W (window).  Rows that see no key give 0, accumulation is in
// f32 and the output is written in q's type.  The wrapper refuses Tq > Tk:
// rows that see no key would then differ by convention (these kernels give
// 0, the plain version NaN), and the model never calls it so.  No atomics:
// two launches on the same inputs give bit-equal outputs.
//
// Two hand-written kernels; the wrapper picks one by dtype.
//
// bf16 (every prefill of the served models): tensor cores.  What bounds it
// on this card is operations: at the serve shape (B=8, S=2048, H=25,
// Hkv=5, dh=64, W=1024, causal) each (b, h) has ~1.57M unmasked (q, k)
// pairs, 4*dh flops each, ~8e10 flops, ~81 us at the bf16 tensor-core rate,
// against ~126 MB of q, k, v and o (~38 us of HBM time).  The design:
// * One CTA owns (b*h, a tile of 128 query rows): two consumer warpgroups of
//   64 rows each, and one producer warp.  Grid (B*H, ceil(Tq/128)).
// * The producer loads Q once, then keeps a ring of kStages K/V tiles of
//   64 keys full with TMA (3-D tensor maps (dh, T, B*heads), so rows past
//   Tq or Tk read 0), each stage guarded by a full and an empty mbarrier.
//   Tiles are 128B-swizzled (64B / 32B for dh = 32 / 16; dh = 128 is two
//   64-column panels).
// * S = Q K^T is wgmma m64n64k16 with both operands in shared memory (K is
//   K-major, no transpose), accumulated in f32 registers.  The online
//   softmax runs on that fragment: scores pre-scaled by scale*log2(e),
//   exp2f, the row max over the four threads that share a row.  P is
//   rounded to bf16 in registers and feeds O += P V as the register operand
//   of wgmma m64n{dh}k16, with V from shared memory (MN-major: the
//   transpose bit for B).  The S accumulator's layout is the RS A operand's
//   layout, so P never touches shared memory.
// * Tiles fully masked for the whole query tile are never loaded (the TPU
//   kernel's `_needed`); a warpgroup skips the arithmetic of tiles fully
//   masked for its 64 rows, and only tiles that straddle the causal
//   diagonal, the window edge or Tk apply the per-element mask.
// * Numerics: rounding P to bf16 before P V is the one departure from the
//   JAX kernel, which multiplies f32 P by f32 V.  It moves the output by
//   about one bf16 ulp, well inside the bf16 tolerance of 3e-2.
//
// f32 (tests and f32 smoke configs only): plain f32 FMA arithmetic (67
// TFLOP/s peak).  One block per (b*h, tile of 64 query rows), four threads
// per query row, Q/K/V tiles staged in shared memory, m and l in registers,
// the row's max and sum reduced over its four lanes with xor-shuffles (every
// lane ends with the same bits), masked tiles skipped as above.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (or an error code >= 1000
// when a TMA descriptor cannot be built, see kTensorMapError).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 64;          // query rows per block
constexpr int kBlockK = 64;          // keys per tile
constexpr int kLanes = 4;            // threads per query row
constexpr int kThreads = kBlockQ * kLanes;
constexpr int kKeysPerLane = kBlockK / kLanes;
constexpr float kNeg = -1e30f;

// Copy rows [row0, row0 + 64) of a (rows, DH) matrix into shared memory
// with a row stride of DH + 1; rows at or past `rows` are zero.
template <int DH>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int row0, int rows,
                                           float* __restrict__ dst) {
  for (int i = threadIdx.x; i < kBlockK * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const int g = row0 + r;
    dst[r * (DH + 1) + c] = g < rows ? src[static_cast<long long>(g) * DH + c] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int h, int group, int tq, int tk, float scale,
                           int causal, int window) {
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

  const float* qb = q + static_cast<long long>(bh) * tq * DH;
  const float* kb = k + static_cast<long long>(bkv) * tk * DH;
  const float* vb = v + static_cast<long long>(bkv) * tk * DH;

  stage_tile<DH>(qb, q0, tq, qs);

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
    stage_tile<DH>(kb, k0, tk, ks);
    stage_tile<DH>(vb, k0, tk, vs);
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
    float* orow = o + (static_cast<long long>(bh) * tq + q0 + row) * DH + lane;
#pragma unroll
    for (int e = 0; e < kCols; ++e) orow[kLanes * e] = acc[e] * inv;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int h, int hkv, int tq, int tk, float scale, int causal,
               int window, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (3 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1));
  // above 48 KB only with an opt-in (set per call: it is per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_f32_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), h, h / hkv, tq,
      tk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA kernel
// ---------------------------------------------------------------------------
constexpr int kTileM = 128;          // query rows per CTA
constexpr int kTileN = 64;           // keys per K/V tile
constexpr int kStages = 3;           // K/V ring depth
constexpr int kConsumerWarps = 8;    // two warpgroups of 64 query rows
constexpr int kBf16Threads = (kConsumerWarps + 1) * 32;   // + the producer
constexpr int kTensorMapError = 1000;   // + the CUresult of the encode call

template <int DH>
struct Tiles {
  static constexpr int kPanel = DH < 64 ? DH : 64;   // columns per panel
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kRowBytes = 2 * kPanel;       // = the swizzle width
  static constexpr uint32_t kLayout = kRowBytes == 128 ? hopper::kSwizzle128B
                                      : kRowBytes == 64 ? hopper::kSwizzle64B
                                                        : hopper::kSwizzle32B;
  static constexpr uint32_t kQBytes = kTileM * DH * 2;
  static constexpr uint32_t kKVBytes = kTileN * DH * 2;   // one K or V tile
  // 1 KB of slack to align the tiles to 1024 B, then Q, the K ring, the V
  // ring and the 2 * kStages + 1 barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
};

template <int DH>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ o, int h, int group,
                            int tq, int tk, float scale_log2, int causal,
                            int window) {
  using T = Tiles<DH>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + T::kQBytes;
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int bh = blockIdx.x;
  const int bkv = (bh / h) * (h / group) + (bh % h) / group;
  const int q0 = blockIdx.y * kTileM;
  const int offs = tk - tq;
  // the key tiles some row of this CTA sees: [t_lo, t_lo + n_tiles)
  const int first_q = q0 + offs;
  const int last_q = min(q0 + kTileM, tq) - 1 + offs;   // <= tk - 1
  const int t_lo = window > 0 ? max(0, first_q - window + 1) / kTileN : 0;
  const int n_tiles = (causal ? last_q : tk - 1) / kTileN + 1 - t_lo;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: Q once, then the K/V ring
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        tma_load_3d(q_s + p * kTileM * T::kRowBytes, &q_map, q_bar,
                    p * T::kPanel, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::kKVBytes);
        const int k0 = (t_lo + it) * kTileN;
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = s * T::kKVBytes + p * kTileN * T::kRowBytes;
          tma_load_3d(k_s + off, &k_map, &full[s], p * T::kPanel, k0, bkv);
          tma_load_3d(v_s + off, &v_map, &full[s], p * T::kPanel, k0, bkv);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wq0, wq0 + 64) of the tile
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;        // thread within the warpgroup
  const int wq0 = q0 + wg * 64;
  const bool wg_live = wq0 < tq;
  const int wg_first = wq0 + offs;
  const int wg_last = min(wq0 + 64, tq) - 1 + offs;
  const int qpos0 = wg_first + acc_row(t, 0);   // this thread's rows: +0, +8
  const uint32_t q_base = smem_u32(q_s) + wg * 64 * T::kRowBytes;
  constexpr uint32_t kSbo = 8 * T::kRowBytes;   // 8-row groups

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int k0 = (t_lo + it) * kTileN;
    const bool skip = !wg_live || (causal && k0 > wg_last) ||
                      (window > 0 && k0 + kTileN - 1 <= wg_first - window);
    if (!skip) {
      const uint32_t k_base = smem_u32(k_s + s * T::kKVBytes);
      const uint32_t v_base = smem_u32(v_s + s * T::kKVBytes);

      // S = Q K^T over dh / 16 k-steps
      float sc[kTileN / 2];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t col = (kk * 16 % T::kPanel) * 2;
        const uint32_t panel = kk * 16 / T::kPanel;
        wgmma_ss_m64n64k16(
            sc,
            smem_desc(q_base + panel * kTileM * T::kRowBytes + col, 16, kSbo,
                      T::kLayout),
            smem_desc(k_base + panel * kTileN * T::kRowBytes + col, 16, kSbo,
                      T::kLayout),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale into the log2 domain; mask only tiles on an edge
      const bool edge = (causal && k0 + kTileN - 1 > wg_first) ||
                        (window > 0 && k0 <= wg_last - window) ||
                        k0 + kTileN > tk;
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int kpos = k0 + acc_col(t, i);
          const int qpos = qpos0 + 8 * ((i / 2) % 2);
          bool ok = kpos < tk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : -INFINITY;
        }
        sc[i] = x;
      }

      // online softmax on the fragment: rows (i / 2) % 2 of each thread
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float ref[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ref[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // a row with no key yet
        corr[r] = exp2f(m[r] - ref[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) {
        sc[i] = exp2f(sc[i] - ref[(i / 2) % 2]);
        rsum[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      // P in bf16 as the register operand, 16 keys per k-step
      uint32_t pa[kTileN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      // O += P V
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk)
        wgmma_rs_tb<DH>(acc, pa[kk],
                        smem_desc(v_base + kk * 16 * T::kRowBytes,
                                  kTileN * T::kRowBytes, kSbo, T::kLayout));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) fence_regs(pa[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with stage s
  }

  // O / l in bf16; the four threads of a row sum l in the same order
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[r] = x > 0.f ? 1.f / x : 0.f;
  }
  __nv_bfloat16* ob = o + static_cast<long long>(bh) * tq * DH;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = wq0 + acc_row(t, i);
    if (row < tq) {
      const float x = inv[(i / 2) % 2];
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row) * DH +
                                   acc_col(t, i)) =
          pack_bf16(acc[i] * x, acc[i + 1] * x);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the library does not link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (heads, rows, dh) bf16 tensor as a 3-D tensor map whose box is
// (panel columns, box_rows, 1), swizzled at the panel's width.
template <int DH>
int encode_map(CUtensorMap* map, const void* ptr, int heads, int rows,
               int box_rows) {
  using T = Tiles<DH>;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(rows) * DH * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kPanel),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int h, int hkv, int tq, int tk, float scale, int causal,
                int window, cudaStream_t stream) {
  using T = Tiles<DH>;
  CUtensorMap q_map, k_map, v_map;
  int err = encode_map<DH>(&q_map, q, b * h, tq, kTileM);
  if (err == 0) err = encode_map<DH>(&k_map, k, b * hkv, tk, kTileN);
  if (err == 0) err = encode_map<DH>(&v_map, v, b * hkv, tk, kTileN);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * h, (tq + kTileM - 1) / kTileM);
  flash_attention_bf16_kernel<DH><<<grid, kBf16Threads, T::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), h, h / hkv, tq,
      tk, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int b, int h, int hkv, int tq, int tk) {
  return b > 0 && h > 0 && hkv > 0 && h % hkv == 0 && tq > 0 && tk >= tq;
}

}  // namespace

// q (b, h, tq, dh), k and v (b, hkv, tk, dh), o (b, h, tq, dh): contiguous
// on one device.  dh in {16, 32, 64, 128}; h % hkv == 0; 1 <= tq <= tk;
// window <= 0 means no window.  All f32:
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int h, int hkv, int tq, int tk,
                                          int dh, float scale, int causal,
                                          int window, void* stream) {
  if (!valid(b, h, hkv, tq, tk) || tq > 65535 * kBlockQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_f32<16>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 32: return launch_f32<32>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 64: return launch_f32<64>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 128: return launch_f32<128>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ... or all bf16, with q, k and v 16-byte aligned (TMA).
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int h, int hkv, int tq, int tk,
                                           int dh, float scale, int causal,
                                           int window, void* stream) {
  if (!valid(b, h, hkv, tq, tk) || tq > 65535 * kTileM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_bf16<16>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 32: return launch_bf16<32>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 64: return launch_bf16<64>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    case 128: return launch_bf16<128>(q, k, v, o, b, h, hkv, tq, tk, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
