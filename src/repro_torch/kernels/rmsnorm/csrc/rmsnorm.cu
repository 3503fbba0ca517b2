// RMSNorm over the last dimension for NVIDIA Hopper (sm_90a), with a plain C
// interface so that it can be built by nvcc alone and loaded with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel
//   (launched by rmsnorm_2d, wrapped by ops.py::rmsnorm).
//
// What it computes, as the TPU kernel does: for each row of x (N, d),
//   y = x * rsqrt(mean(x^2) + eps) * scale
// in float32, written in x's type.  scale is float32 (the model's
// parameters are).
//
// Design.  The TPU kernel normalizes a (block_rows x d) VMEM tile per grid
// step, with d padded by its caller.  Here a group of threads owns one row:
// one warp per row (eight rows to a block) for narrow rows such as the
// qk-norm's hd = 128, up to 1024 threads for wide rows such as d = 5120.
// Each thread loads its share of the row once, with 16-byte loads when the
// row's length, base and stride allow and element loads otherwise, keeps
// it in registers, accumulates its sum of squares in float32, and the
// group reduces through warp shuffles (and shared memory across warps).
// Then each thread scales the values it holds and stores them with the same
// width.  So x is read once and y written once, any d is masked, and the
// fixed reduction tree gives the same result on every run (no atomics).
//
// What bounds it: bytes.  About 4 operations per element against 4 bytes
// (bf16 in and out) leave it far below the card's 295 operations per byte;
// the least time is the row traffic over the memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Params {
  const void* x;
  void* y;
  const float* scale;
  long long N;
  int d;
  long long x_rs, y_rs;   // row strides, in elements; d is 1
  float eps;
};

// blockDim.x threads per row, blockDim.y rows per block (> 1 only when
// blockDim.x is one warp).  Thread tx holds packs tx + n * blockDim.x of
// its row, n < NV.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(1024) rmsnorm_kernel(const Params p) {
  using P = Pack<T, VEC>;
  __shared__ float red[33];
  const int tx = threadIdx.x;
  const int tpr = blockDim.x;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < p.N;
  const int npack = p.d / VEC;
  const P* xr = reinterpret_cast<const P*>(static_cast<const T*>(p.x) +
                                           (live ? row : 0) * p.x_rs);

  P buf[NV];
  float ss = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int idx = n * tpr + tx;
    if (live && idx < npack) {
      buf[n] = xr[idx];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(buf[n].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {   // one row per block: combine the warps
    const int warp = tx >> 5, lane = tx & 31;
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < (tpr >> 5) ? red[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) red[32] = t;
    }
    __syncthreads();
    ss = red[32];
  }
  if (!live) return;

  const float inv = rsqrtf(ss / static_cast<float>(p.d) + p.eps);
  P* yr = reinterpret_cast<P*>(static_cast<T*>(p.y) + row * p.y_rs);
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int idx = n * tpr + tx;
    if (idx < npack) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(buf[n].v[e]) * inv;
        o.v[e] = from_f32<T>(f * __ldg(p.scale + idx * VEC + e));
      }
      yr[idx] = o;
    }
  }
}

template <typename T, int VEC, int NV>
int launch(const Params& p, int tpr, cudaStream_t stream) {
  const int rows = tpr == 32 ? 8 : 1;
  const long long blocks = (p.N + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return -1;
  rmsnorm_kernel<T, VEC, NV>
      <<<unsigned(blocks), dim3(tpr, rows), 0, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, int VEC>
int pick_nv(const Params& p, int tpr, int nv, cudaStream_t stream) {
  switch (nv) {
    case 1: return launch<T, VEC, 1>(p, tpr, stream);
    case 2: return launch<T, VEC, 2>(p, tpr, stream);
    case 4: return launch<T, VEC, 4>(p, tpr, stream);
    case 8: return launch<T, VEC, 8>(p, tpr, stream);
    case 16: return launch<T, VEC, 16>(p, tpr, stream);
    default: return -1;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = p.d % V == 0 && aligned16(p.x) && aligned16(p.y) &&
                   (p.x_rs * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   (p.y_rs * static_cast<long long>(sizeof(T))) % 16 == 0;
  const int width = vec ? V : 1;
  const int npack = p.d / width;
  // Threads per row: the smallest power of two from 32 to 1024 that leaves
  // at most two packs a thread, then the packs a thread needs (at most 16).
  int tpr = 32;
  while (tpr < 1024 && 2 * tpr < npack) tpr *= 2;
  int nv = 1;
  while (nv * tpr < npack) nv *= 2;
  if (nv > 16) return -1;
  return vec ? pick_nv<T, V>(p, tpr, nv, stream)
             : pick_nv<T, 1>(p, tpr, nv, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); scale is float32.  Returns 0,
// a cudaError_t, or -1 for an unsupported type or a row too long (more
// than 16 packs per thread at 1024 threads).  Launches on `stream`, does
// not synchronize.
int rmsnorm_fwd(const void* x, void* y, const void* scale, int dtype,
                long long N, int d, long long x_rs, long long y_rs,
                float eps, void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  const Params p{x, y, static_cast<const float*>(scale), N, d, x_rs, y_rs,
                 eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return -1;
}

const char* rmsnorm_error_string(int code) {
  return code < 0 ? "unsupported dtype or row length"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
