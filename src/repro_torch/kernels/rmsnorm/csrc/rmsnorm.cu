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
// step, with d padded by its caller.  Here a group of threads owns one row.
// Each thread loads its share of the row once, with 16-byte loads when the
// row's length, base and stride (and the scale's base) allow and element
// loads otherwise, keeps it in registers, accumulates its sum of squares in
// float32, and the group reduces through warp shuffles (and, past one warp,
// one shared-memory step that every thread sums in the same order).  Then
// each thread scales the values it holds, reading the scale in 16-byte
// packs, and stores them with the same width.  So x is read once and y
// written once, any d is masked, and the fixed reduction tree gives the
// same result on every run (no atomics).
//
// * Narrow rows (at most 64 packs, such as the qk-norm's hd = 128): a group
//   of 4 to 32 lanes per row, the smallest power of two that leaves each
//   lane at most two packs, and 256 threads, so 8 to 64 rows, per block.
// * Wide rows (such as d = 5120, 640 packs of 8 bf16): 4 packs per thread
//   while the row needs at most 256 threads (8 or 16 past that), so that
//   several 16-byte loads per thread are in flight at once, and a thread
//   count that is a multiple of 32 but not a power of two (160 threads for
//   640 packs): small blocks, many rows resident per SM to cover HBM's
//   latency, and no thread without a pack.
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

// blockDim.x threads per row (a power of two up to 32, or a multiple of 32),
// blockDim.y rows per block (> 1 only when blockDim.x is at most a warp).
// Thread tx holds packs tx + n * blockDim.x of its row, n < NV.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(NV <= 8 ? 256 : 1024, 1)
rmsnorm_kernel(const Params p) {
  using P = Pack<T, VEC>;
  __shared__ float red[32];
  const int tx = threadIdx.x;
  const int tpr = blockDim.x;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < p.N;
  const int npack = p.d / VEC;
  const P* xr = reinterpret_cast<const P*>(static_cast<const T*>(p.x) +
                                           (live ? row : 0) * p.x_rs);

  P buf[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int idx = n * tpr + tx;
    if (live && idx < npack) buf[n] = xr[idx];
  }
  float ss = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    if (live && n * tpr + tx < npack) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(buf[n].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  // Within the row's lanes (xor offsets below the group size stay in it).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {   // one row per block: combine the warps
    if ((tx & 31) == 0) red[tx >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < (tpr >> 5); ++w) ss += red[w];
  }
  if (!live) return;

  const float inv = rsqrtf(ss / static_cast<float>(p.d) + p.eps);
  P* yr = reinterpret_cast<P*>(static_cast<T*>(p.y) + row * p.y_rs);
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int idx = n * tpr + tx;
    if (idx < npack) {
      float sc[VEC];
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f4 =
              __ldg(reinterpret_cast<const float4*>(p.scale + idx * VEC) + q);
          sc[4 * q] = f4.x;
          sc[4 * q + 1] = f4.y;
          sc[4 * q + 2] = f4.z;
          sc[4 * q + 3] = f4.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sc[e] = __ldg(p.scale + idx * VEC + e);
      }
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f32<T>(to_f32(buf[n].v[e]) * inv * sc[e]);
      yr[idx] = o;
    }
  }
}

template <typename T, int VEC, int NV>
int launch(const Params& p, int tpr, cudaStream_t stream) {
  const int rows = tpr <= 32 ? 256 / tpr : 1;
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
                   aligned16(p.scale) &&
                   (p.x_rs * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   (p.y_rs * static_cast<long long>(sizeof(T))) % 16 == 0;
  const int npack = p.d / (vec ? V : 1);
  int tpr, nv;
  if (npack <= 64) {
    // Narrow: the smallest group of 4 to 32 lanes with at most two packs
    // a lane.
    tpr = 4;
    while (tpr < 32 && tpr < npack) tpr *= 2;
    nv = (npack + tpr - 1) / tpr;
  } else {
    // Wide: 4 packs a thread up to 256 threads, then 8, then 16; the
    // threads rounded up to whole warps.
    nv = npack <= 4 * 256 ? 4 : npack <= 8 * 256 ? 8 : 16;
    tpr = ((npack + nv - 1) / nv + 31) / 32 * 32;
    if (tpr > 1024) return -1;
  }
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
