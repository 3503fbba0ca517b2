// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C
// interface so that it can be built by nvcc alone and loaded with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel
//   (launched by flash_attention_bhsd, wrapped by ops.py::flash_attention).
//
// What it computes, as the TPU kernel does: GQA attention forward with an
// online softmax.  Query head h reads kv head h / (H / Hkv).  Scores are
// q . k times the given scale (hd^-0.5), then an optional tanh softcap,
// then the causal and / or sliding-window mask with the finite NEG_INF =
// -1e30; keys past Sk get probability exactly 0.  Softmax statistics and
// accumulators are f32; the output is written in q's dtype after dividing
// by max(l, 1e-30).
// The TPU kernel walks k blocks as its sequential minor grid dimension with
// (m, l, acc) in VMEM scratch; here one CTA owns a query tile and loops
// over the k tiles itself with (m, l, acc) in registers.  k tiles wholly
// past the causal frontier or wholly before the window are skipped (the TPU
// kernel multiplies them by exactly 0), and the heaviest causal query tiles
// are launched first.  The (B, S, H, hd) layout is read through strides.
// Both kernels take hd 64, 128, 192 and 256; the wrapper (ops.py) zero-pads
// any other hd up to 256 to the next of these and passes the scale of the
// unpadded hd (zero columns add nothing to q . k and give zero columns of
// the output, which it slices off).
//
// Two kernels, chosen by the input type (flash_attention_fwd's dtype code),
// not as a fallback:
//
// * bfloat16: flash_fwd_wgmma_kernel, on the tensor cores.  What bounds
//   attention at the serving shapes is operations (34 GFLOP against 75 MB
//   at B=2, S=1024, H=64, hd=128), and only wgmma reaches the card's bf16
//   rate.  A CTA is three warpgroups and owns (b, h, 128-query-row) items,
//   heaviest causal tiles first; up to hd 192 it is persistent (one CTA
//   per SM walks its items, so one item's epilogue overlaps the next one's
//   loads).  Warpgroup 0 is the producer: one thread loads each item's
//   query rows and then K and V tiles (128 keys up to hd 128, 64 above)
//   into a ring of shared-memory stages with TMA (128-byte swizzle, the
//   layout wgmma reads), each stage guarded by mbarriers (K full, V full,
//   empty).  Warpgroups 1 and 2 each own 64 query rows; setmaxnreg moves
//   registers from the producer to them.  Up to hd 192 a consumer takes
//   its Q rows into registers once (ldmatrix) and frees Q's stage for the
//   next item.  Per k tile it computes S = Q K^T with wgmma (Q from
//   registers or shared memory, K from shared memory) into f32 registers;
//   scales S in f32 (log2 e folded into the scale, exp2 in place of exp),
//   applies the softcap and, only on tiles that cross the diagonal, the
//   window edge or Sk, the masks; updates the row max and sum across the
//   four lanes of a row by shuffles and rescales O's fragments; rounds P to
//   bf16 in registers (the one rounding point the TPU kernel, which keeps P
//   in f32, does not have) and computes O += P V with wgmma, P as the
//   register A operand and V, stored with hd contiguous, as the MN-major B
//   operand.  S of tile i is issued before P V of tile i - 1, so the
//   softmax of one tile runs while the tensor cores work on the other.
//   Inputs must have 16-byte-aligned bases and strides (the TMA's rule);
//   flash_attention_fwd returns an error otherwise.
//
// * float32: flash_fwd_simt_kernel, scalar f32 FMAs from shared memory.
//   The tensor cores take f32 only as TF32 (10 mantissa bits), which would
//   not hold the f32 tolerance of 2e-5; this kernel keeps the TPU kernel's
//   f32 arithmetic exactly and runs at the CUDA-core f32 rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ===================================================== float32: SIMT kernel

namespace simt {

constexpr int kBM = 64;         // query rows per CTA
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

template <int HD, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBM) * HD + size_t(HD) * (BN + 1) + size_t(BN) * HD +
          size_t(kBM) * BN);
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < BN / 16) and output columns tx + 16 j (j < HD / 16).
template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const Params p) {
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

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBM * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    q_s[i] = s < p.Sq ? qp[s * p.q_ss + d] * p.scale : 0.f;
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
      kT_s[d * KT + c] = ok ? kp[s * p.k_ss + d] : 0.f;
      v_s[c * HD + d] = ok ? vp[s * p.v_ss + d] : 0.f;
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
    for (int j = 0; j < DN; ++j) op[s * p.o_ss + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int HD, int BN>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BN>();
  static_assert(smem <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<HD, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.B * p.H);
  flash_fwd_simt_kernel<HD, BN><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

int dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64, 64>(p, stream);
    case 128: return launch<128, 64>(p, stream);
    case 192: return launch<192, 64>(p, stream);
    case 256: return launch<256, 32>(p, stream);
    default: return -1;
  }
}

}  // namespace simt

// ================================================ bfloat16: wgmma kernel

namespace tc {

constexpr int kBM = 64;                  // query rows per consumer warpgroup
constexpr int kConsumers = 2;            // consumer warpgroups per CTA
constexpr int kRows = kBM * kConsumers;  // query rows per CTA
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;        // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;       //   = 384 x 168 = the launch's pool

// Tile sizes and shared memory, in 1024-byte-aligned pieces (the 128-byte
// swizzle repeats every 1024 bytes).  Every tile is stored as hd / 64 boxes
// of [rows][64] bf16, 128 bytes a row, as TMA writes them with the 128-byte
// swizzle.  Per consumer thread, O takes hd / 2 floats, Q in registers
// hd / 4, S kBN / 2 floats and P kBN / 8 registers, of 240.  Up to hd 128:
// 128 keys per k tile, Q in registers.  At hd 192: 64 keys, Q in registers
// (96 + 48 + 32 + 16 = 192), so Q's stage is freed at once and the CTA
// stays persistent (0.19 ms against 0.23 with Q read from shared memory,
// at nemotron's prefill shape on an H100); 48 KB of Q and three stages of
// K and V (48 KB each), 192 KB.  At hd 256: 64 keys, Q read by wgmma from
// shared memory (Q in registers would leave 240 - 224 for the rest); 64 KB
// of Q and two stages of 64 KB.
template <int HD>
struct Layout {
  static_assert(HD % 64 == 0 && HD <= 256, "hd 64, 128, 192 or 256");
  static constexpr int kBN = HD <= 128 ? 128 : 64;
  static constexpr bool kQReg = HD <= 192;   // Q as the register A operand
  static constexpr int kStages = HD == 64 ? 4 : HD <= 192 ? 3 : 2;
  static constexpr uint32_t kQBox = kRows * 128;          // one 64-wide box
  static constexpr uint32_t kKVBox = kBN * 128;
  static constexpr uint32_t kTileBytes = kKVBox * (HD / 64);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBox * (HD / 64);  // K stages
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // mbarriers: q full and empty, then full_k, full_v and empty per stage
  static constexpr uint32_t kBytes = kBars + 8 * (2 + 3 * kStages);
};

struct TcParams {
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long o_sb, o_ss, o_sh;
  float scale_log2;     // hd^-0.5 * log2 e (no softcap)
  float scale;          // hd^-0.5 (softcap)
  float inv_softcap;
  float softcap_log2;   // softcap * log2 e
  int causal;
  int window;
};

// S = Q K^T for one k tile: hd / 16 wgmma steps, both operands K-major, Q
// and K from their 64-wide boxes (a step advances 16 bf16 = 32 bytes
// within a box's 128-byte rows; the swizzle is on the address bits).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Layout<HD>::kBN / 2],
                                         uint32_t q, uint32_t k) {
  using L = Layout<HD>;
  // Q's hd / 16 descriptors are the same at every k tile; computed anew
  // each time, they hold no registers through the tile loop.
  q = hopper::opaque(q);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32u;
    const uint64_t da = hopper::desc_sw128(q + (kk / 4) * L::kQBox + off, 16,
                                           1024);
    const uint64_t db = hopper::desc_sw128(k + (kk / 4) * L::kKVBox + off, 16,
                                           1024);
    hopper::wgmma_ss_m64n64(sc, da, db, kk > 0);
  }
}

// The same with Q's A fragments in registers (loaded once by ldmatrix).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Layout<HD>::kBN / 2],
                                         const uint32_t (&qa)[HD / 16][4],
                                         uint32_t k) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(
        k + (kk / 4) * L::kKVBox + (kk % 4) * 32u, 16, 1024);
    if constexpr (L::kBN == 128)
      hopper::wgmma_rs_m64n128_kmajor(sc, qa[kk], db, kk > 0);
    else
      hopper::wgmma_rs_m64n64_kmajor(sc, qa[kk], db, kk > 0);
  }
}

// O += P V for one k tile in steps of 16 keys: P from registers, V
// MN-major (hd contiguous): its 64-wide hd boxes lie kKVBox bytes apart
// (LBO), groups of 8 keys 1024 bytes apart (SBO).
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[Layout<HD>::kBN / 16][4],
    uint32_t v) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < L::kBN / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(v + kk * 16 * 128, L::kKVBox, 1024);
    if constexpr (HD == 64) hopper::wgmma_rs_m64n64(o, pa[kk], db, 1);
    if constexpr (HD == 128) hopper::wgmma_rs_m64n128(o, pa[kk], db, 1);
    if constexpr (HD == 192) hopper::wgmma_rs_m64n192(o, pa[kk], db, 1);
    if constexpr (HD == 256) hopper::wgmma_rs_m64n256(o, pa[kk], db, 1);
  }
}

// A thread's two rows (a = row_a, b = row_a + 8) of the online softmax.
struct Rows {
  float m_a = kNegInf, m_b = kNegInf;   // running maxima, log2 units
  float l_a = 0.f, l_b = 0.f;           // this thread's partial sums
  float corr_a = 1.f, corr_b = 1.f;     // rescale of the earlier sums
};

// Max or sum over one row's values of an S fragment: elements 4 j + first
// and 4 j + first + 1 for every n8 block j, in four independent chains.
template <bool MAX, int NB>
__device__ __forceinline__ float row_reduce(const float (&x)[4 * NB],
                                            int first) {
  static_assert(NB % 4 == 0, "four chains");
  auto op = [](float u, float v) { return MAX ? fmaxf(u, v) : u + v; };
  float m0 = op(x[first], x[first + 1]);
  float m1 = op(x[4 + first], x[5 + first]);
  float m2 = op(x[8 + first], x[9 + first]);
  float m3 = op(x[12 + first], x[13 + first]);
#pragma unroll
  for (int j = 4; j < NB; j += 4) {
    m0 = op(m0, op(x[4 * j + first], x[4 * j + first + 1]));
    m1 = op(m1, op(x[4 * j + 4 + first], x[4 * j + 5 + first]));
    m2 = op(m2, op(x[4 * j + 8 + first], x[4 * j + 9 + first]));
    m3 = op(m3, op(x[4 * j + 12 + first], x[4 * j + 13 + first]));
  }
  return op(op(m0, m1), op(m2, m3));
}

// One online-softmax step on a tile of raw scores q . k; m is kept in log2
// units (scale * log2 e folded in, exp2 in place of exp).  With the softcap,
// or on a tile that crosses the diagonal, the window edge or Sk (MASKED),
// the scores are scaled first and then masked: -1e30 where a key is hidden,
// -inf where there is no key.  On other tiles every score is finite and the
// scale is folded into one FFMA with the row maximum.  The scores are
// replaced by their probabilities.
template <int BN, bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             const TcParams& p, int k0,
                                             int row_a, int t, Rows& r) {
  constexpr bool kPrescale = SOFTCAP || MASKED;
  if constexpr (kPrescale) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if constexpr (SOFTCAP)
          x = tanhf(x * p.scale * p.inv_softcap) * p.softcap_log2;
        else
          x *= p.scale_log2;
        if constexpr (MASKED) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_a + 8;
          bool visible = true;
          if (p.causal) visible = col <= row;
          if (p.window > 0) visible = visible && row - col < p.window;
          x = visible ? x : kNegInf;
          if (col >= p.Sk) x = -INFINITY;   // no key: probability 0
        }
        sc[4 * j + e] = x;
      }
    }
  }
  // sc[4j], sc[4j+1] are row a's; sc[4j+2], sc[4j+3] row b's.
  float mx_a = row_reduce<true, BN / 8>(sc, 0);
  float mx_b = row_reduce<true, BN / 8>(sc, 2);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  if constexpr (!kPrescale) {
    mx_a *= p.scale_log2;
    mx_b *= p.scale_log2;
  }
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  r.corr_a = hopper::exp2_approx(r.m_a - mn_a);
  r.corr_b = hopper::exp2_approx(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  const float c = kPrescale ? 1.f : p.scale_log2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = hopper::exp2_approx(fmaf(sc[4 * j], c, -mn_a));
    sc[4 * j + 1] = hopper::exp2_approx(fmaf(sc[4 * j + 1], c, -mn_a));
    sc[4 * j + 2] = hopper::exp2_approx(fmaf(sc[4 * j + 2], c, -mn_b));
    sc[4 * j + 3] = hopper::exp2_approx(fmaf(sc[4 * j + 3], c, -mn_b));
  }
  r.l_a = r.l_a * r.corr_a + row_reduce<false, BN / 8>(sc, 0);
  r.l_b = r.l_b * r.corr_b + row_reduce<false, BN / 8>(sc, 2);
}

// P in bf16 as the A operand: the accumulator fragment of keys
// 16 kk .. 16 kk + 15 is the register A fragment of the k16 step kk.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// The work of a CTA: (b, h, query tile) items, the heaviest causal query
// tiles first, item w = blockIdx.x + k gridDim.x (a persistent CTA per SM).
struct Item {
  int b, h, hk, q0, k_begin, n_tiles;
};

template <int BN>
__device__ __forceinline__ Item item(const TcParams& p, int w, int n_qt) {
  Item it;
  const int bh = w % (p.B * p.H);
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.hk = it.h / (p.H / p.Hkv);
  it.q0 = (n_qt - 1 - w / (p.B * p.H)) * kRows;
  // k tiles that can hold a visible key for some query of the item.
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, it.q0 + kRows);
  it.k_begin = 0;
  if (p.window > 0) it.k_begin = max(0, it.q0 - p.window + 1) / BN * BN;
  it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + BN - 1) / BN : 0;
  return it;
}

template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const TcParams p) {
  using L = Layout<HD>;
  constexpr int S = L::kStages;
  constexpr int BN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  auto full_k = [&](int s) { return q_full + 8u * (2 + s); };
  auto full_v = [&](int s) { return q_full + 8u * (2 + S + s); };
  auto empty = [&](int s) { return q_full + 8u * (2 + 2 * S + s); };
  const int n_qt = (p.Sq + kRows - 1) / kRows;
  const int n_items = p.B * p.H * n_qt;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * kConsumers);     // one per consumer warp
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty(s), 4 * kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // K and V tiles of all the CTA's items pass through one ring of S stages;
  // g counts them, so stage g % S is in its (g / S)-th use.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0, n = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item it = item<BN>(p, w, n_qt);
        hopper::mbar_wait(q_empty, (n & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, kRows * HD * 2);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          hopper::tma_load_4d(sQ + c * L::kQBox, &tm_q, q_full, c * 64, it.q0,
                              it.h, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++g) {
          const int s = g % S;
          const int k0 = it.k_begin + i * BN;
          hopper::mbar_wait(empty(s), ((g / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full_k(s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            hopper::tma_load_4d(sK + s * L::kTileBytes + c * L::kKVBox, &tm_k,
                                full_k(s), c * 64, k0, it.hk, it.b);
          hopper::mbar_expect_tx(full_v(s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            hopper::tma_load_4d(sV + s * L::kTileBytes + c * L::kKVBox, &tm_v,
                                full_v(s), c * 64, k0, it.hk, it.b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;                     // consumer 0 or 1
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const uint32_t sQw = sQ + cw * kBM * 128;  // its rows of each Q box
    auto wait_k = [&](int g) { hopper::mbar_wait(full_k(g % S), (g / S) & 1); };
    auto wait_v = [&](int g) { hopper::mbar_wait(full_v(g % S), (g / S) & 1); };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    auto release = [&](int g) { arrive(empty(g % S)); };

    int g0 = 0, n = 0;   // the ring count at the item's first tile
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const Item it = item<BN>(p, w, n_qt);
      const int r0 = it.q0 + cw * kBM;             // the warpgroup's rows
      const int row_a = r0 + warp * 16 + lane / 4;   // a thread's two rows
      const int row_b = row_a + 8;
      // Tiles [lo, hi) hold a visible key for some row of this warpgroup;
      // the others (wholly past the causal frontier, wholly before the
      // window, or every row past Sq) are waited for and released
      // untouched.
      int lo = it.n_tiles, hi = it.n_tiles;
      for (int i = 0; i < it.n_tiles; ++i) {
        const int k0 = it.k_begin + i * BN;
        const bool skip = r0 >= p.Sq || (p.causal && k0 > r0 + kBM - 1) ||
                          (p.window > 0 && k0 + BN - 1 < r0 - p.window + 1);
        if (!skip) {
          if (lo == it.n_tiles) lo = i;
          hi = i + 1;
        }
      }
      auto masked = [&](int k0) {
        return (p.causal && k0 + BN - 1 > r0) ||
               (p.window > 0 && r0 + kBM - 1 - k0 >= p.window) ||
               k0 + BN > p.Sk;
      };

      // Q: up to hd 192 its A fragments go to registers by ldmatrix (the
      // warp's 16 rows, hd in steps of 16; lane l addresses row l % 8, + 8
      // for odd l / 8, and the step's 16-byte chunk l / 16, swizzled by the
      // row), which frees Q's shared memory for the next item at once.
      hopper::mbar_wait(q_full, n & 1);
      uint32_t qa[L::kQReg ? HD / 16 : 1][4];
      if constexpr (L::kQReg) {
        const int row = cw * kBM + warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int chunk = (kk % 4) * 2 + lane / 16;
          hopper::ldmatrix_x4(qa[kk], sQ + (kk / 4) * L::kQBox + row * 128 +
                                          ((chunk ^ (row % 8)) * 16));
        }
        arrive(q_empty);
      }
      auto qk = [&](float (&sc)[BN / 2], int g) {
        if constexpr (L::kQReg)
          issue_qk<HD>(sc, qa, sK + (g % S) * L::kTileBytes);
        else
          issue_qk<HD>(sc, sQw, sK + (g % S) * L::kTileBytes);
      };
      Rows rows;
      auto softmax = [&](float (&sc)[BN / 2], int i) {
        const int k0 = it.k_begin + i * BN;
        if (masked(k0))
          softmax_tile<BN, SOFTCAP, true>(sc, p, k0, row_a, t, rows);
        else
          softmax_tile<BN, SOFTCAP, false>(sc, p, k0, row_a, t, rows);
      };

      for (int i = 0; i < lo; ++i) {
        wait_k(g0 + i);
        wait_v(g0 + i);
        release(g0 + i);
      }
      float o[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
      if (lo < hi) {
        float sc[BN / 2];
        uint32_t pa[BN / 16][4];
        wait_k(g0 + lo);
        hopper::wgmma_fence();
        qk(sc, g0 + lo);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(sc);
        softmax(sc, lo);
        pack_p<BN>(sc, pa);
        // Each step issues S for tile i and then O += P V for tile i - 1;
        // the softmax of tile i runs while the tensor cores work on P V.
        for (int i = lo + 1; i < hi; ++i) {
          wait_k(g0 + i);
          wait_v(g0 + i - 1);
          hopper::wgmma_fence();
          qk(sc, g0 + i);
          hopper::wgmma_commit();
          issue_pv<HD>(o, pa, sV + ((g0 + i - 1) % S) * L::kTileBytes);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_operands(sc);
          softmax(sc, i);
          hopper::wgmma_wait<0>();
          hopper::fence_operands(o);
          hopper::fence_operands(pa);
          release(g0 + i - 1);
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            o[4 * j] *= rows.corr_a;
            o[4 * j + 1] *= rows.corr_a;
            o[4 * j + 2] *= rows.corr_b;
            o[4 * j + 3] *= rows.corr_b;
          }
          pack_p<BN>(sc, pa);
        }
        wait_v(g0 + hi - 1);
        hopper::wgmma_fence();
        issue_pv<HD>(o, pa, sV + ((g0 + hi - 1) % S) * L::kTileBytes);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(o);
        release(g0 + hi - 1);
      }
      if constexpr (!L::kQReg) arrive(q_empty);
      for (int i = hi; i < it.n_tiles; ++i) {
        wait_k(g0 + i);
        wait_v(g0 + i);
        release(g0 + i);
      }
      g0 += it.n_tiles;

      // Epilogue: the row sums across the four lanes of a row, then O / l,
      // written while the producer loads the next item.
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rows.l_a += __shfl_xor_sync(0xffffffffu, rows.l_a, off);
        rows.l_b += __shfl_xor_sync(0xffffffffu, rows.l_b, off);
      }
      const float inv_a = 1.f / fmaxf(rows.l_a, 1e-30f);
      const float inv_b = 1.f / fmaxf(rows.l_b, 1e-30f);
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + it.b * p.o_sb +
                          it.h * p.o_sh;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (row_a < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + row_a * p.o_ss + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (row_b < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + row_b * p.o_ss + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                    o[4 * j + 3] * inv_b);
      }
    }
  }
}

// ---------------------------------------------------------------- the host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (hd, S, heads, B), innermost first, in boxes of
// 64 x box_rows x 1 x 1 with the 128-byte swizzle.  Strides in elements.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int seq, int heads,
              int batch, long long ss, long long sh, long long sb,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(seq),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrTensorMap = -2;

template <int HD, bool SOFTCAP>
int launch(const Params& p, cudaStream_t stream) {
  using L = Layout<HD>;
  constexpr uint32_t smem = L::kBytes + 1024;   // + alignment slack
  static_assert(smem <= 232448, "tiles do not fit in shared memory");
  CUtensorMap tq, tk, tv;
  constexpr int BN = L::kBN;
  if (!make_map(&tq, p.q, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kRows) ||
      !make_map(&tk, p.k, HD, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb, BN) ||
      !make_map(&tv, p.v, HD, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb, BN))
    return kErrTensorMap;
  TcParams tp;
  tp.o = p.o;
  tp.B = p.B;
  tp.H = p.H;
  tp.Hkv = p.Hkv;
  tp.Sq = p.Sq;
  tp.Sk = p.Sk;
  tp.o_sb = p.o_sb;
  tp.o_ss = p.o_ss;
  tp.o_sh = p.o_sh;
  tp.scale_log2 = p.scale * kLog2e;
  tp.scale = p.scale;
  tp.inv_softcap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  tp.softcap_log2 = p.softcap * kLog2e;
  tp.causal = p.causal;
  tp.window = p.window;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // One persistent CTA per SM (or one per item when there are fewer).  At
  // hd 256 Q stays in shared memory until an item's last S, so the next
  // item's Q load cannot overlap the item: one CTA per item there.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long long items =
      static_cast<long long>(p.B) * p.H * ((p.Sq + kRows - 1) / kRows);
  const int grid = int(items < sms || !L::kQReg ? items : sms);
  if (grid == 0) return 0;
  flash_fwd_wgmma_kernel<HD, SOFTCAP>
      <<<grid, kThreads, smem, stream>>>(tq, tk, tv, tp);
  return int(cudaGetLastError());
}

template <bool SOFTCAP>
int dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64, SOFTCAP>(p, stream);
    case 128: return launch<128, SOFTCAP>(p, stream);
    case 192: return launch<192, SOFTCAP>(p, stream);
    case 256: return launch<256, SOFTCAP>(p, stream);
    default: return -1;
  }
}

int dispatch(const Params& p, int hd, cudaStream_t stream) {
  return p.softcap > 0.f ? dispatch_hd<true>(p, hd, stream)
                         : dispatch_hd<false>(p, hd, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel).  Returns
// 0, a cudaError_t, -1 for an unsupported head dim / dtype, or -2 when a
// bf16 tensor's base or strides do not make a TMA tensor map (16-byte
// alignment).  Launches on `stream`, does not synchronize.
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
  if (dtype == 0) return simt::dispatch(p, hd, s);
  if (dtype == 1) return tc::dispatch(p, hd, s);
  return -1;
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head dim or dtype";
  if (code == tc::kErrTensorMap)
    return "no TMA tensor map for these bf16 tensors (bases and strides "
           "must be 16-byte aligned)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
