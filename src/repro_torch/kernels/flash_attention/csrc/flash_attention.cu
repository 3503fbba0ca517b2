// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C
// interface so that it can be built by nvcc alone and loaded with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel
//   (launched by flash_attention_bhsd, wrapped by ops.py::flash_attention).
//
// What it computes, as the TPU kernel does: GQA attention forward with an
// online softmax.  Query head h reads kv head h / (H / Hkv).  q is scaled by
// hd^-0.5 in f32 before the dot, then an optional tanh softcap, then the
// causal and / or sliding-window mask with the finite NEG_INF = -1e30, and
// f32 online-softmax statistics and accumulators; the output is written in
// q's dtype after dividing by max(l, 1e-30).
//
// Design.  The TPU kernel walks k blocks as the sequential minor grid
// dimension and keeps (m, l, acc) in VMEM scratch across grid steps.  Here
// one CTA owns one (b, h, 64-query tile) and loops over the k tiles itself,
// holding m, l and acc in registers.  The (B, S, H, hd) layout is read
// through strides, so no head-major copy is made.  The ragged edge of any S
// is masked: out-of-range queries are not stored and out-of-range keys get
// probability exactly 0.  k tiles wholly past the causal frontier or wholly
// before the window are skipped; in the TPU kernel their contribution is
// multiplied by exactly 0 by the correction factor.  The heaviest causal
// query tiles are launched first.
//
// What bounds it: at the serving shapes attention is compute bound on the
// tensor cores (about 34 GFLOP against 75 MB at B=2, S=1024, H=64, hd=128).
// This first kernel does its products with scalar f32 FMAs from shared
// memory (tiles staged as f32, K transposed and padded against bank
// conflicts), so it runs at the CUDA-core f32 rate and far from that bound.
// It keeps the TPU kernel's f32 arithmetic exactly, for bf16 and f32 inputs
// alike; moving the two products onto mma / wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;         // query rows per CTA
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

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
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;   // element strides of (B, S, H, hd); d is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;
  float softcap;
};

template <int HD, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBM) * HD + size_t(HD) * (BN + 1) + size_t(BN) * HD +
          size_t(kBM) * BN);
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < BN / 16) and output columns tx + 16 j (j < HD / 16).
template <typename T, int HD, int BN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int RM = kBM / 16;
  constexpr int CN = BN / 16;
  constexpr int DN = HD / 16;
  constexpr int KT = BN + 1;    // padded row of the transposed K tile

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBM][HD], pre-scaled
  float* kT_s = q_s + kBM * HD;       // [HD][KT]
  float* v_s = kT_s + HD * KT;        // [BN][HD]
  float* p_s = v_s + BN * HD;         // [kBM][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * kBM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBM * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    q_s[i] = s < p.Sq ? to_f32(qp[s * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // k tiles that can hold a visible key for some query of this tile.
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + kBM);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BN * BN;

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();   // the last tile's readers are done (and q_s is in)
    for (int i = tid; i < BN * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, s = k0 + c;
      const bool ok = s < p.Sk;
      kT_s[d * KT + c] = ok ? to_f32(kp[s * p.k_ss + d]) : 0.f;
      v_s[c * HD + d] = ok ? to_f32(vp[s * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = kT_s[d * KT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j];
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool visible = true;
        if (p.causal) visible = kpos <= qpos;
        if (p.window > 0) visible = visible && (qpos - kpos) < p.window;
        x = visible ? x : kNegInf;
        sc[i][j] = x;
        if (kpos < p.Sk) rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float pj = kpos < p.Sk ? expf(sc[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * BN + tx + 16 * j] = pj;
        rsum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * BN + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      op[s * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD, int BN>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BN>();
  static_assert(smem <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.B * p.H);
  flash_fwd_kernel<T, HD, BN><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64, 64>(p, stream);
    case 128: return launch<T, 128, 64>(p, stream);
    case 256: return launch<T, 256, 32>(p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1 for an
// unsupported head dim / dtype.  Launches on `stream`, does not synchronize.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Hkv, int Sq, int Sk,
                        int hd, long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int causal, int window, float softcap,
                        void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  const Params p{q, k, v, o, B, H, Hkv, Sq, Sk,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 o_sb, o_ss, o_sh, scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, hd, s);
  return -1;
}

const char* flash_attention_error_string(int code) {
  return code < 0 ? "unsupported head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
