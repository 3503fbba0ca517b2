// rwkv6's LayerNorm, token shift and static mixes in one pass, for NVIDIA
// Hopper (sm_90a), with a plain C interface so that it can be built by nvcc
// alone and loaded with ctypes.
//
// No TPU kernel stands behind it: the reference (src/repro/models/rwkv.py,
// transformer.py) runs these steps as jnp operations that XLA fuses.  The
// port's eager composition of the same steps (ref.py) issues 61 elementwise
// operations a layer; this is one launch a site.
//
// What it computes, row by row of one sequence b, for t = 0 .. S-1:
//   h_t      = T(LN(x_t))  float32 statistics, (x - mu) * rsqrt(var + eps)
//                          * scale + bias, each step rounded as the eager
//                          float32 operations round it;
//   h_{-1}   = T(shift_b)  the previous chunk's last normalised row;
//   out_{i,t} = T(h_{t-1} + (h_t - h_{t-1}) * T(m_i))  in float32, rounded
//                          once to T (the eager mix rounds three times);
//   new_shift_b = float(h_{S-1}).
// T is x's type (bfloat16 or float32); scale, bias, the mixes and the
// shifts are float32.
//
// Design.  Bound by bytes: it reads x once (2 bytes an element) and writes
// K mixed rows (2K bytes), about 4 operations per byte written at most.
// * One warp walks a run of `rows` consecutive rows of one sequence.  Its
//   lanes own 16-byte packs of the row (lane l owns packs l, l + 32, ...),
//   so each load and store of the warp is 512 contiguous bytes.  The warp
//   keeps h_{t-1} from one row to the next in a row of shared memory of
//   its own (each lane touching only its packs, so no barrier): the token
//   shift costs one halo row per run (the row before it, normalised
//   again), and the previous chunk's shift where the run starts the
//   sequence.
// * The statistics are two passes over the registers (mean, then the mean
//   square of x - mu), each a warp shuffle tree, so no atomics: the same
//   result on every run.
// * scale, bias and the mixes (cast to T, as the eager `m.to(dtype)`) sit
//   in shared memory, filled once a block.  The mixes go out pack by pack,
//   all K of a pack at once, so only that pack's h_{t-1} and h_t - h_{t-1}
//   are live in float32.  With h_{t-1} out of the registers too, a thread
//   fits in 128 registers up to d = 2048 in bf16: two blocks of 8 warps an
//   SM, the grid's 16 warps an SM resident at once.  (Mix by mix, with
//   h_{t-1} and the next row in registers, the compiler kept a whole row's
//   float32 h and h_{t-1} live: 235 registers, one block an SM, 53% of the
//   bytes' bound at the time-mix site on an H100; capped at 128 it
//   spilled.)
// * The run length comes from the row count and the SM count: long enough
//   that halo rows stay a small share, short enough that the grid holds
//   about 16 warps for each SM (B 4 x S 2048 = 8192 rows: runs of 4, 2048
//   warps; 32768 rows: runs of 16).
// * No scratch, the caller's stream, cudaGetLastError checked after the
//   launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxMixes = 5;
constexpr int kWarps = 8;            // warps a block
constexpr int kWarpsPerSm = 16;      // the grid's target, for the run length
constexpr int kMaxRows = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Params {
  const void* x;                  // (B, S, d) in T, d contiguous
  const float* shift;             // (B, d)
  const float* scale;             // (d)
  const float* bias;              // (d)
  const float* mix[kMaxMixes];    // K of (d)
  void* out;                      // (K, B, S, d) in T, contiguous
  float* new_shift;               // (B, d)
  long long B, S;
  long long x_bs, x_ss;           // x's batch and sequence strides
  long long mix_stride;           // B * S * d: out's step from mix to mix
  int d, K;
  int rows;                       // rows a warp
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int NV>
struct Row {
  static constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  P v[NV];

  __device__ __forceinline__ void load(const T* row, int lane, int npack) {
    const P* r = reinterpret_cast<const P*>(row);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = n * 32 + lane;
      if (idx < npack) v[n] = r[idx];
    }
  }

  // x -> T(LN(x)) in place.  Idle packs (idx >= npack) add nothing.
  __device__ __forceinline__ void normalize(const float* s_scale,
                                            const float* s_bias, int lane,
                                            int npack, int d, float eps) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      if (n * 32 + lane < npack)
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += to_f32(v[n].v[e]);
    const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(d));
    float ss = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      if (n * 32 + lane < npack)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = __fsub_rn(to_f32(v[n].v[e]), mu);
          ss = fmaf(c, c, ss);
        }
    const float var = __fdiv_rn(warp_sum(ss), static_cast<float>(d));
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = n * 32 + lane;
      if (idx < npack) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int c = idx * VEC + e;
          float y = __fmul_rn(__fsub_rn(to_f32(v[n].v[e]), mu), rstd);
          y = __fadd_rn(__fmul_rn(y, s_scale[c]), s_bias[c]);
          v[n].v[e] = from_f32<T>(y);
        }
      }
    }
  }
};

// Two blocks an SM (at most 128 registers a thread) up to 64 bf16 or 16
// float32 elements of a row a lane, one past that (float32 at 32 a lane
// spills a little in 128 registers).
template <typename T, int NV>
__global__ void __launch_bounds__(
    kWarps * 32, (sizeof(T) == 2 ? NV <= 8 : NV <= 4) ? 2 : 1)
norm_shift_mix_kernel(const Params p) {
  using R = Row<T, NV>;
  constexpr int VEC = R::VEC;
  using P = typename R::P;

  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_bias = s_scale + d;
  T* s_mix = reinterpret_cast<T*>(s_bias + d);   // K x d, in T
  // this warp's h_{t-1}; each lane reads and writes only its own packs
  P* s_hp = reinterpret_cast<P*>(s_mix + (p.K + warp) * d);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    s_scale[i] = p.scale[i];
    s_bias[i] = p.bias[i];
#pragma unroll
    for (int k = 0; k < kMaxMixes; ++k)
      if (k < p.K) s_mix[k * d + i] = from_f32<T>(p.mix[k][i]);
  }
  __syncthreads();

  const long long run = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long runs_per_seq = (p.S + p.rows - 1) / p.rows;
  if (run >= p.B * runs_per_seq) return;
  const long long b = run / runs_per_seq;
  const long long t0 = (run % runs_per_seq) * p.rows;
  const long long t1 = t0 + p.rows < p.S ? t0 + p.rows : p.S;
  const int npack = d / VEC;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_bs;

  R cur;
  if (t0 == 0) {
    const float* sh = p.shift + b * d;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = n * 32 + lane;
      if (idx < npack) {
        P q;
#pragma unroll
        for (int e = 0; e < VEC; ++e) q.v[e] = from_f32<T>(sh[idx * VEC + e]);
        s_hp[idx] = q;
      }
    }
  } else {
    cur.load(xb + (t0 - 1) * p.x_ss, lane, npack);
    cur.normalize(s_scale, s_bias, lane, npack, d, p.eps);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      if (n * 32 + lane < npack) s_hp[n * 32 + lane] = cur.v[n];
  }

  for (long long t = t0; t < t1; ++t) {
    cur.load(xb + t * p.x_ss, lane, npack);
    cur.normalize(s_scale, s_bias, lane, npack, d, p.eps);
    // Pack by pack, every mix of the pack: only a pack's h_{t-1} and
    // h_t - h_{t-1} are live in float32 across the mixes.  Then h_t takes
    // h_{t-1}'s place.
    T* orow = static_cast<T*>(p.out) + (b * p.S + t) * d;   // mix 0's row
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = n * 32 + lane;
      if (idx < npack) {
        const P hp = s_hp[idx];
        float pf[VEC], df[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          pf[e] = to_f32(hp.v[e]);
          df[e] = __fsub_rn(to_f32(cur.v[n].v[e]), pf[e]);
        }
        for (int k = 0; k < p.K; ++k) {
          const P mk = reinterpret_cast<const P*>(s_mix + k * d)[idx];
          P q;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            q.v[e] = from_f32<T>(fmaf(df[e], to_f32(mk.v[e]), pf[e]));
          reinterpret_cast<P*>(orow + k * p.mix_stride)[idx] = q;
        }
        s_hp[idx] = cur.v[n];
      }
    }
    if (t == p.S - 1) {
      float* ns = p.new_shift + b * d;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int idx = n * 32 + lane;
        if (idx < npack)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            ns[idx * VEC + e] = to_f32(cur.v[n].v[e]);
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

// Rows a warp: about kWarpsPerSm warps a streaming multiprocessor over the
// whole grid, each run at least one row and at most kMaxRows.
int pick_rows(long long n_rows) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long target = static_cast<long long>(sms) * kWarpsPerSm;
  long long rows = (n_rows + target - 1) / target;
  if (rows < 1) rows = 1;
  if (rows > kMaxRows) rows = kMaxRows;
  return static_cast<int>(rows);
}

template <typename T, int NV>
int launch(Params p, cudaStream_t stream) {
  const long long runs = p.B * ((p.S + p.rows - 1) / p.rows);
  const long long blocks = (runs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return -1;
  const size_t smem =
      2 * sizeof(float) * p.d + sizeof(T) * (p.K + kWarps) * p.d;
  auto kernel = norm_shift_mix_kernel<T, NV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<unsigned(blocks), kWarps * 32, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(Params p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (p.d % V != 0) return -1;
  // (a stride of a dim of size 1 is never stepped)
  if (!aligned16(p.x) || (p.B > 1 && (p.x_bs * sizeof(T)) % 16 != 0) ||
      (p.S > 1 && (p.x_ss * sizeof(T)) % 16 != 0))
    return -2;
  const int npack = p.d / V;
  const int per_lane = (npack + 31) / 32;
  switch (per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4
          : per_lane <= 8 ? 8 : per_lane <= 16 ? 16 : 0) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out); shift, scale, bias, the
// mixes and new_shift are float32.  mix0 .. mix4: the first K used.
// The rows a warp come from the row count (pick_rows).  Returns 0, a
// cudaError_t, -1 for an unsupported type, K or row length (bf16 up to
// d = 4096, float32 up to 2048, d a multiple of 8 or 4), -2 for an x whose
// base or strides are not 16-byte multiples.  Launches on `stream`, does
// not synchronize; nothing for an empty batch or sequence.
int norm_shift_mix_fwd(const void* x, const void* shift, const void* scale,
                       const void* bias, const void* mix0, const void* mix1,
                       const void* mix2, const void* mix3, const void* mix4,
                       void* out, void* new_shift, int dtype, long long B,
                       long long S, int d, int K, long long x_bs,
                       long long x_ss, float eps, void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  if (K < 1 || K > kMaxMixes || d < 1) return -1;
  if (B == 0 || S == 0) return 0;
  Params p{};
  p.x = x;
  p.shift = static_cast<const float*>(shift);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  const void* mixes[kMaxMixes] = {mix0, mix1, mix2, mix3, mix4};
  for (int k = 0; k < kMaxMixes; ++k)
    p.mix[k] = static_cast<const float*>(mixes[k]);
  p.out = out;
  p.new_shift = static_cast<float*>(new_shift);
  p.B = B;
  p.S = S;
  p.x_bs = x_bs;
  p.x_ss = x_ss;
  p.mix_stride = B * S * d;
  p.d = d;
  p.K = K;
  p.rows = pick_rows(B * S);
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return -1;
}

// The rows a warp that norm_shift_mix_fwd picks for B * S rows on the
// current device.
int norm_shift_mix_rows(long long n_rows) { return pick_rows(n_rows); }

const char* norm_shift_mix_error_string(int code) {
  if (code == -1) return "unsupported dtype, mix count or row length";
  if (code == -2) return "x's base or strides are not 16-byte multiples";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
