// RWKV6 WKV recurrence (forward) for NVIDIA Hopper (sm_90a), with a plain C
// interface so that it can be built by nvcc alone and loaded with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py::_wkv_kernel
//   (launched by wkv6_bh, wrapped by ops.py::wkv6).
//
// What it computes, as the TPU kernel does: for each (batch, head), with an
// hd x hd float32 state S carried in (s0) and out (sT),
//   y_t = r_t^T (S + diag(u) k_t v_t^T)
//   S  <- diag(w_t) S + k_t v_t^T
// for t = 0 .. T-1, every product in float32; y is written in r's dtype.
//
// Design.  The TPU kernel gives each (b, h) one grid row and walks time as
// the sequential minor grid dimension, keeping S in VMEM scratch between
// grid steps.  Here one block owns one (b, h) and walks T in order itself,
// so no state crosses blocks.  Column j of S evolves on its own: it needs
// only v_t[j] and the shared r_t, k_t, w_t.  Four threads share a column,
// each holding hd / 4 of its rows in registers (16 floats at hd = 64), so a
// block has 4 * hd threads; the four partial sums of y_t[j] meet through two
// warp shuffles.  Chunks of 16 timesteps of r, k, v, w are staged through
// shared memory (r, k, w laid out so each thread reads its rows with 16-byte
// loads free of bank conflicts); y is staged there too and written out with
// coalesced stores.  The (B, T, H, hd) layout is read through strides, so
// the wrapper makes no head-major copy.  r, k, v share one type (bf16 or
// f32); w is always f32: the decay sits near 1 and the model builds it in
// f32, so it is never rounded to bf16.  Any T works, 1 included.
//
// What bounds it: at the prefill shape of rwkv6_1_6b (B=2, T=1024, H=32,
// hd=64) the kernel moves about 52 MB, and the function needs 5 hd^2
// float32 operations per token and head (1.3 GFLOP: r^T S, then w S + k v^T;
// the u term is O(hd)), so the float32 rate outside the tensor cores bounds
// it just above the memory rate.  This kernel does 7 hd^2 (it forms
// r (S + u k v^T) per element, as the TPU kernel does).  The walk
// over T is sequential within a block and there are only B * H = 64 blocks
// for 132 SMs, so it runs far from either bound: the card is under-filled
// and each step waits on a chain of dependent FMAs and two shuffles.
// Splitting S's columns across blocks, or a chunked form on the tensor
// cores, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCT = 16;   // timesteps staged per chunk

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
  return __float2bfloat16(x);
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;    // (H, hd), contiguous
  const float* s0;   // (B, H, hd, hd), contiguous
  void* y;           // (B, T, H, hd), in r's type
  float* sT;         // (B, H, hd, hd), contiguous
  int B, T, H;
  long long r_sb, r_st, r_sh;   // element strides of (B, T, H, hd); d is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long y_sb, y_st, y_sh;
};

// Thread tid owns column j = tid / 4 of S and its rows q * RPT + m
// (q = tid % 4, m < RPT).  In shared memory one timestep of r, k or w is
// four row groups of RPT floats, each padded to RS = RPT + 4 floats, so the
// four groups a warp reads at once start in different banks.
template <typename TR, int HD>
__global__ void __launch_bounds__(4 * HD) wkv6_kernel(const Params p) {
  constexpr int NT = 4 * HD;
  constexpr int RPT = HD / 4;
  constexpr int RS = RPT + 4;
  constexpr int TS = 4 * RS;
  __shared__ __align__(16) float r_s[kCT * TS];
  __shared__ __align__(16) float k_s[kCT * TS];
  __shared__ __align__(16) float w_s[kCT * TS];
  __shared__ float v_s[kCT * HD];
  __shared__ float y_s[kCT * HD];

  const int tid = threadIdx.x;
  const int j = tid >> 2;
  const int q = tid & 3;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;

  const TR* rp = static_cast<const TR*>(p.r) + b * p.r_sb + h * p.r_sh;
  const TR* kp = static_cast<const TR*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TR* vp = static_cast<const TR*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wp = p.w + b * p.w_sb + h * p.w_sh;
  TR* yp = static_cast<TR*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long sbase = static_cast<long long>(blockIdx.x) * HD * HD;

  float S[RPT], u[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = q * RPT + m;
    S[m] = p.s0[sbase + i * HD + j];
    u[m] = p.u[h * HD + i];
  }

  for (int t0 = 0; t0 < p.T; t0 += kCT) {
    const int n = min(kCT, p.T - t0);
    __syncthreads();   // the last chunk's readers of the staging are done
    for (int e = tid; e < n * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      const int si = t * TS + (i / RPT) * RS + i % RPT;
      const long long tt = t0 + t;
      r_s[si] = to_f32(rp[tt * p.r_st + i]);
      k_s[si] = to_f32(kp[tt * p.k_st + i]);
      w_s[si] = wp[tt * p.w_st + i];
      v_s[e] = to_f32(vp[tt * p.v_st + i]);
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t * HD + j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s + t * TS + q * RS);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + t * TS + q * RS);
      const float4* w4 = reinterpret_cast<const float4*>(w_s + t * TS + q * RS);
      float y = 0.f;
#pragma unroll
      for (int m4 = 0; m4 < RPT / 4; ++m4) {
        const float4 rr = r4[m4], kk = k4[m4], ww = w4[m4];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = 4 * m4 + c;
          const float a = kv[c] * vj;                   // (k_t v_t^T)[i, j]
          y = fmaf(rv[c], fmaf(u[m], a, S[m]), y);     // r_i (S + u_i a)
          S[m] = fmaf(wv[c], S[m], a);                 // w_i S + a
        }
      }
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if (q == 0) y_s[t * HD + j] = y;
    }
    __syncthreads();
    for (int e = tid; e < n * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      yp[static_cast<long long>(t0 + t) * p.y_st + i] = from_f32<TR>(y_s[e]);
    }
  }

#pragma unroll
  for (int m = 0; m < RPT; ++m) p.sT[sbase + (q * RPT + m) * HD + j] = S[m];
}

template <typename TR, int HD>
int launch(const Params& p, cudaStream_t stream) {
  wkv6_kernel<TR, HD><<<p.B * p.H, 4 * HD, 0, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TR>
int dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<TR, 16>(p, stream);
    case 64: return launch<TR, 64>(p, stream);
    case 128: return launch<TR, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Type code rkv_dtype for r, k, v and y: 0 = float32, 1 = bfloat16.  w, u,
// s0 and sT are float32; u, s0 and sT are contiguous.  Returns 0, a
// cudaError_t, or -1 for an unsupported head dim or type.  Launches on
// `stream`, does not synchronize.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT, int rkv_dtype,
             int B, int T, int H, int hd, long long r_sb,
             long long r_st, long long r_sh, long long k_sb, long long k_st,
             long long k_sh, long long v_sb, long long v_st, long long v_sh,
             long long w_sb, long long w_st, long long w_sh, long long y_sb,
             long long y_st, long long y_sh, void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  const Params p{r, k, v, static_cast<const float*>(w),
                 static_cast<const float*>(u),
                 static_cast<const float*>(s0), y, static_cast<float*>(sT),
                 B, T, H, r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st,
                 v_sh, w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == 0) return dispatch<float>(p, hd, s);
  if (rkv_dtype == 1) return dispatch<__nv_bfloat16>(p, hd, s);
  return -1;
}

const char* wkv6_error_string(int code) {
  return code < 0 ? "unsupported head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
