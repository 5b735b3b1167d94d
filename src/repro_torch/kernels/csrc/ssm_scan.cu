// Mamba-1 selective state-space scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssm_scan` (body `_ssm_kernel`) in
// src/repro/kernels/ssm_scan.py.  Same semantics, per batch row b and
// channel d, over t = 0 .. T-1:
//     h_t = exp(dt_t * a) * h_{t-1} + (dt_t * b_t) * x_t      (N states)
//     y_t = sum_n h_t * c_t + d * x_t
// with h_{-1} = h0 (zeros when absent).  x, dt, b, c are f32 or bf16 and
// read as f32; a (Dm, N), d (Dm,) and h0 are f32; y is written in x's type
// and the final state hT in f32.  1 <= N <= 64.
//
// What bounds it on this card.  At the model's prefill shape (B=8, T=2048,
// Dm=3200, N=16, bf16) the scan must read x and dt and write y once
// (~315 MB, ~94 us at 3.35 TB/s).  Counting every f32 operation as one
// slot at 67 TFLOP/s (8 per (b, t, d, n), 2 per (b, t, d): 6.8e9) gives
// 0.1017 ms.  But the 8.39e8 exponentials (B*T*Dm*N) each need one op of
// the special function unit (MUFU `ex2`), which issues 16 per SM per
// clock, 1/8 of the FMA rate: 8.39e8 / (132 SMs * 16 * 1.98 GHz) =
// ~0.20 ms.  With libm `expf` (see below) each (b, t, d, n) also takes
// about 12 issue slots, ~0.30 ms of the card's 528 schedulers.  The
// recurrence is sequential in t, so the remaining limits are the work in
// flight (B*Dm*S lanes, no more) and the latency around each step.  The
// design:
//
// * States across lanes.  Each lane owns G = 4 states (a quad) of one
//   (b, d); a channel's N states take S = pow2(ceil(N / 4)) neighbouring
//   lanes of a warp (S = 4 at N = 16, so B*Dm*S = 102,400 lanes at the
//   serve shape, about one wave of the card instead of a tenth).  Per step
//   a lane does 4 independent chains of one FMUL (dt * a), one `expf`, one
//   FMUL and one FMA, plus one FMA into its partial output.  The exp of a
//   step does not depend on the state, so the unrolled steps of a tile
//   keep several MUFU ops in flight.
// * The exponential is libm `expf` (a MUFU ex2 on a range-reduced
//   argument plus ~6 FP-pipe instructions), the function the plain
//   version's torch.exp computes.  `ex2.approx` on a pre-scaled a * log2 e
//   (one MUFU op and one FMUL) ran faster, but it disagreed with the plain
//   version in more bf16 outputs, and one of them, a whole bf16 ulp
//   (0.0625 at |y| >= 8), failed the 5e-2 tolerance of chip_smoke.py's
//   serve-shape case, so expf stays.
// * The output dot product over n is reduced across the S lanes in
//   transposed form, once per group of S steps: each lane keeps its S
//   partials, and log2(S) rounds of butterfly exchanges (each lane keeps
//   half its values and sends the other half) leave lane j with y of step
//   j of the group: S - 1 shuffles and adds per S steps, instead of a
//   log2(S)-round butterfly per step.  The order is fixed and there are no
//   atomics, so reruns are bit-equal.
// * Staging.  A block covers C = 32 channels of one batch row (16 when
//   N > 32) with C * S threads: 800 blocks at the serve shape, at most 7
//   on an SM against a mean of 6.06.  (64 channels, 128-byte bf16 rows,
//   gave 400 blocks, 4 on some SMs against a mean of 3.03, and ran
//   slower.)  It stages a tile of kTile = 32 steps of x and dt (rows
//   coalesced across d, 16-byte copies) and of b and c (one copy per step
//   and quad: b and c are shared by every channel of the row) into shared
//   memory with cp.async, double-buffered: the next tile's copies are in
//   flight while the current one computes.  One pass per tile converts
//   (dt, dt * x) to f32 once for the block; b and c stay in the input
//   type.  A lane then reads its quad of b and of c and its channel's
//   (dt, dt * x) two steps per 16-byte load (a quad's and a channel's
//   steps are contiguous, rows padded across banks).  Each thread copies
//   and converts fixed columns, so there is no per-element `/` or `%`.  y goes back
//   through shared memory as coalesced 16-byte stores.  Rows that are not
//   16-byte aligned (Dm or N off the vector width, or an unaligned
//   pointer) are staged with plain loads instead.
// * Coalesced state I/O.  h0, hT and a are (.., Dm, N) row-major, and lane
//   j of a channel owns states 4j .. 4j+3, so a warp reads and writes one
//   contiguous run (16-byte vectors when N % 4 == 0): the decode shape
//   (T = 1) is one coalesced pass over the 1.6 MB state.  The same kernel
//   serves T = 1 and T = prompt.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream,
// allocates nothing and returns the CUDA error of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kG = 4;        // states per lane
constexpr int kTile = 32;    // time steps per staged tile
constexpr int kStages = 2;   // raw input tiles: one computing, one in flight

// S lanes per channel (S quads of states) -> channels per block (C) and
// threads per block
template <int S> struct Shape {
  static constexpr int kChannels = S <= 8 ? 32 : 16;
  static constexpr int kThreads = kChannels * S;
};

template <typename T, int S> struct Smem {
  static constexpr int C = Shape<S>::kChannels;
  alignas(16) T x[kStages][kTile][C];  // raw tiles, a ring of kStages
  alignas(16) T dt[kStages][kTile][C];
  // quad q (4 states) of step s; a quad's steps are contiguous, 2 extra
  // steps put the S quads of a step on other banks
  alignas(16) T b[kStages][S][kTile + 2][kG];
  alignas(16) T c[kStages][S][kTile + 2][kG];
  // (dt, dt * x) in f32, a channel's steps contiguous; the 2 extra steps
  // move each channel's row to other banks
  alignas(16) float2 u[C][kTile + 2];
  alignas(16) T y[kTile][C];           // output tile
};

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

// one quad (4 states) of `steps` consecutive steps from shared memory, as
// f32: a single 8- or 16-byte load for one bf16 step or two, 16 bytes a
// step in f32
__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
template <int kSteps>
__device__ __forceinline__ void load_quads(const __nv_bfloat16* p,
                                           float (&v)[kSteps][kG]) {
  if constexpr (kSteps == 2) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    unpack(q.x, v[0][0], v[0][1]); unpack(q.y, v[0][2], v[0][3]);
    unpack(q.z, v[1][0], v[1][1]); unpack(q.w, v[1][2], v[1][3]);
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    unpack(q.x, v[0][0], v[0][1]); unpack(q.y, v[0][2], v[0][3]);
  }
}
template <int kSteps>
__device__ __forceinline__ void load_quads(const float* p,
                                           float (&v)[kSteps][kG]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// one quad of states: 8 bytes of bf16 or 16 bytes of f32
__device__ __forceinline__ void cp_async_quad(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// p[k] holds this lane's partial of step k; afterwards p[0] holds the sum
// over the S lanes of the group for step j (the lane's index in the group).
// Round w pairs lanes j and j ^ w: the lane with bit w clear keeps the
// lower half of its values, the other the upper half, each adding what its
// partner sends.
template <int S>
__device__ __forceinline__ void reduce_transposed(float (&p)[S], int j) {
#pragma unroll
  for (int w = S / 2; w >= 1; w >>= 1) {
    const bool upper = j & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? p[i] : p[i + w];
      const float keep = upper ? p[i + w] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
}

// One step of the lane's four states; returns its partial output.
__device__ __forceinline__ float scan_step(float dtv, float dxv,
                                           const float (&bs)[kG],
                                           const float (&cs)[kG],
                                           const float (&av)[kG],
                                           float (&h)[kG]) {
  float acc = 0.f;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    h[g] = fmaf(expf(dtv * av[g]), h[g], dxv * bs[g]);
    acc = fmaf(h[g], cs[g], acc);
  }
  return acc;
}

// One group of S steps from shared memory: advances the lane's four states,
// reduces the outputs across the channel's S lanes and writes y of step
// s0 + j (the lane's index in the group) into the output tile.  Each
// shared-memory load serves two steps (u, b and c are laid out with a
// lane's steps contiguous): 1.5 loads per step of four states.
template <int S, bool kFull, typename T, typename Sm>
__device__ __forceinline__ void scan_group(Sm& sm, int st, int s0, int steps,
                                           int ch, int j, float dd,
                                           float (&h)[kG],
                                           const float (&av)[kG]) {
  constexpr int kPair = S >= 2 ? 2 : 1;   // steps per load
  float part[S];
#pragma unroll
  for (int k = 0; k < S; k += kPair) {
    const int s = s0 + k;
#pragma unroll
    for (int i = 0; i < kPair; ++i) part[k + i] = 0.f;
    if (kFull || s < steps) {
      float bs[kPair][kG], cs[kPair][kG];
      load_quads<kPair>(&sm.b[st][j][s][0], bs);
      load_quads<kPair>(&sm.c[st][j][s][0], cs);
      if constexpr (kPair == 2) {
        const float4 u = *reinterpret_cast<const float4*>(&sm.u[ch][s]);
        part[k] = scan_step(u.x, u.y, bs[0], cs[0], av, h);
        if (kFull || s + 1 < steps)
          part[k + 1] = scan_step(u.z, u.w, bs[1], cs[1], av, h);
      } else {
        const float2 u = sm.u[ch][s];
        part[k] = scan_step(u.x, u.y, bs[0], cs[0], av, h);
      }
    }
  }
  reduce_transposed<S>(part, j);
  const int s = s0 + j;
  if (kFull || s < steps)
    sm.y[s][ch] = from_f32<T>(fmaf(dd, to_f32(sm.x[st][s][ch]), part[0]));
}

template <typename T, int S>
__global__ void __launch_bounds__(Shape<S>::kThreads,
                                  1024 / Shape<S>::kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int t_len, int dm, int n, int vec_d,
                int vec_n, int vec_h) {
  constexpr int C = Shape<S>::kChannels;
  constexpr int NT = Shape<S>::kThreads;   // a multiple of C and of S
  constexpr int E = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int CPR = C / E;             // 16-byte copies per row of C
  constexpr int CP = C / 2;              // channel pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, S>& sm = *reinterpret_cast<Smem<T, S>*>(smem_raw);

  const int tid = threadIdx.x;
  const int j = tid % S;                 // lane within the channel's group
  const int ch = tid / S;                // channel within the block
  const int bb = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int d = d0 + ch;
  const bool live = d < dm;
  const int n0 = j * kG;                 // the lane's first state

  float h[kG], av[kG];
  const long long hbase = (static_cast<long long>(bb) * dm + d) * n + n0;
  const long long abase = static_cast<long long>(d) * n + n0;
  if (vec_h && live && n0 < n) {         // n % 4 == 0: four whole states
    const float4 a4 = *reinterpret_cast<const float4*>(a + abase);
    const float4 hv = h0 != nullptr
        ? *reinterpret_cast<const float4*>(h0 + hbase)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
    h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const bool valid = live && n0 + g < n;
      av[g] = valid ? a[abase + g] : 0.f;
      h[g] = valid && h0 != nullptr ? h0[hbase + g] : 0.f;
    }
  }
  const float dd = live ? dskip[d] : 0.f;

  // Each thread copies and converts fixed columns (NT is a multiple of C,
  // CPR, CP and S), so its rows advance by a constant: no per-element
  // division.  Quad q of b and c past N is zero: padded by the plain
  // copies, or once here for the asynchronous ones, which never write it.
  const int q = tid % S;
  const T zero = from_f32<T>(0.f);
  if (vec_n && 4 * q >= n)
    for (int st = 0; st < kStages; ++st)
      for (int s = tid / S; s < kTile; s += NT / S)
#pragma unroll
        for (int g = 0; g < kG; ++g) sm.b[st][q][s][g] = sm.c[st][q][s][g] = zero;

  const int n_tiles = (t_len + kTile - 1) / kTile;
  auto stage = [&](int tile) {   // tile's x, dt, b, c into its ring slot
    if (tile < n_tiles) {
      const int st = tile % kStages;
      const int t0 = tile * kTile;
      const int steps = min(kTile, t_len - t0);
      const long long row0 = static_cast<long long>(bb) * t_len + t0;
      if (vec_d) {
        const int k = (tid % CPR) * E;
        if (d0 + k < dm)   // dm % E == 0: a copy is all in or all out
          for (int s = tid / CPR; s < steps; s += NT / CPR) {
            const long long g = (row0 + s) * dm + d0 + k;
            cp_async16(&sm.x[st][s][k], x + g);
            cp_async16(&sm.dt[st][s][k], dt + g);
          }
      } else {
        const int k = tid % C;
        if (d0 + k < dm)
          for (int s = tid / C; s < steps; s += NT / C) {
            const long long g = (row0 + s) * dm + d0 + k;
            sm.x[st][s][k] = x[g];
            sm.dt[st][s][k] = dt[g];
          }
      }
      if (vec_n) {   // n % 4 == 0: one copy per step and quad
        if (4 * q < n)
          for (int s = tid / S; s < steps; s += NT / S) {
            const long long g = (row0 + s) * n + 4 * q;
            cp_async_quad(&sm.b[st][q][s][0], bm + g);
            cp_async_quad(&sm.c[st][q][s][0], cm + g);
          }
      } else {
        for (int s = tid / S; s < steps; s += NT / S) {
          const long long g = (row0 + s) * n + 4 * q;
#pragma unroll
          for (int i = 0; i < kG; ++i) {
            const bool v = 4 * q + i < n;
            sm.b[st][q][s][i] = v ? bm[g + i] : zero;
            sm.c[st][q][s][i] = v ? cm[g + i] : zero;
          }
        }
      }
    }
    cp_async_commit();   // one group per tile, empty past the last
  };

  for (int i = 0; i < kStages - 1; ++i) stage(i);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages;
    const int steps = min(kTile, t_len - tile * kTile);
    stage(tile + kStages - 1);   // into the slot the previous tile used
    cp_async_wait<kStages - 1>();
    __syncthreads();   // tile landed; the previous tile's work buffers are free

    // convert once for the block: (dt, dt * x) in f32, two channels by two
    // steps a thread
    {
      const int k = (tid % CP) * 2;
      const bool l0 = d0 + k < dm, l1 = d0 + k + 1 < dm;
      for (int s = (tid / CP) * 2; s < steps; s += 2 * (NT / CP)) {
        const bool s1 = s + 1 < steps;
        const float x00 = l0 ? to_f32(sm.x[st][s][k]) : 0.f;
        const float x01 = l1 ? to_f32(sm.x[st][s][k + 1]) : 0.f;
        const float t00 = l0 ? to_f32(sm.dt[st][s][k]) : 0.f;
        const float t01 = l1 ? to_f32(sm.dt[st][s][k + 1]) : 0.f;
        const float x10 = l0 && s1 ? to_f32(sm.x[st][s + 1][k]) : 0.f;
        const float x11 = l1 && s1 ? to_f32(sm.x[st][s + 1][k + 1]) : 0.f;
        const float t10 = l0 && s1 ? to_f32(sm.dt[st][s + 1][k]) : 0.f;
        const float t11 = l1 && s1 ? to_f32(sm.dt[st][s + 1][k + 1]) : 0.f;
        *reinterpret_cast<float4*>(&sm.u[k][s]) =
            make_float4(t00, t00 * x00, t10, t10 * x10);
        *reinterpret_cast<float4*>(&sm.u[k + 1][s]) =
            make_float4(t01, t01 * x01, t11, t11 * x11);
      }
    }
    __syncthreads();

    if (steps == kTile) {
#pragma unroll
      for (int s0 = 0; s0 < kTile; s0 += S)
        scan_group<S, true, T>(sm, st, s0, steps, ch, j, dd, h, av);
    } else {
      for (int s0 = 0; s0 < steps; s0 += S)
        scan_group<S, false, T>(sm, st, s0, steps, ch, j, dd, h, av);
    }
    __syncthreads();   // the y tile is complete

    const long long row0 = static_cast<long long>(bb) * t_len + tile * kTile;
    if (vec_d) {
      const int k = (tid % CPR) * E;
      if (d0 + k < dm)
        for (int s = tid / CPR; s < steps; s += NT / CPR)
          *reinterpret_cast<uint4*>(y + (row0 + s) * dm + d0 + k) =
              *reinterpret_cast<const uint4*>(&sm.y[s][k]);
    } else {
      const int k = tid % C;
      if (d0 + k < dm)
        for (int s = tid / C; s < steps; s += NT / C)
          y[(row0 + s) * dm + d0 + k] = sm.y[s][k];
    }
  }

  if (live) {
    if (vec_h && n0 < n) {
      *reinterpret_cast<float4*>(hT + hbase) = make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (n0 + g < n) hT[hbase + g] = h[g];
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int S>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const float* d, const float* h0, void* y, float* hT,
           int bsz, int t_len, int dm, int n, cudaStream_t stream) {
  constexpr int C = Shape<S>::kChannels;
  constexpr int E = 16 / sizeof(T);
  const size_t smem = sizeof(Smem<T, S>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec_d = dm % E == 0 && aligned(x, 16) && aligned(dt, 16) &&
                    aligned(y, 16);
  const int vec_n = n % kG == 0 && aligned(b, kG * sizeof(T)) &&
                    aligned(c, kG * sizeof(T));
  const int vec_h = n % kG == 0 && aligned(a, 16) && aligned(h0, 16) &&
                    aligned(hT, 16);
  const dim3 grid((dm + C - 1) / C, bsz);
  ssm_scan_kernel<T, S><<<grid, Shape<S>::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d, h0,
      static_cast<T*>(y), hT, t_len, dm, n, vec_d, vec_n, vec_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* dt, const float* a, const void* b,
             const void* c, const float* d, const float* h0, void* y,
             float* hT, int bsz, int t_len, int dm, int n, cudaStream_t s) {
  if (n <= 4) return launch<T, 1>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (n <= 8) return launch<T, 2>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (n <= 16) return launch<T, 4>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  if (n <= 32) return launch<T, 8>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
  return launch<T, 16>(x, dt, a, b, c, d, h0, y, hT, bsz, t_len, dm, n, s);
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
