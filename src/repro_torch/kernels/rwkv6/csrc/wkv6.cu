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
// the sequential minor grid dimension, keeping S in VMEM scratch.  Here the
// time walk is a loop inside a block, and the state is spread over several
// blocks: column j of S evolves on its own (it needs v_t[j] and the shared
// r_t, k_t, w_t), so a block owns NC = 32 columns of one head (16 at hd 16
// and 128), and there are B * H * hd / NC blocks: 128 at the prefill shape
// of rwkv6_1_6b (B=2, H=32, hd=64), one per SM.
//
// The step is factored:
//   y_t[j] = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i)
//   S_ij  <- w_i S_ij + k_i v_j
// three float32 instructions per state element (an FMA into y, a multiply
// k_i v_j, an FMA into S) instead of four, plus one length-hd dot ru_t =
// sum_i r_i u_i k_i per (b, h, t).
//
// Warp roles.  Four consumer warps hold the state in registers: a consumer
// thread holds 8 rows of two adjacent columns (16 state elements; 262,144
// at the prefill shape, one consumer warp per SM scheduler).  Each step it
// loads 8 rows of r, k, w and two v values (shared by the two columns: half
// the shared-memory traffic per element of one column a thread, which
// bounded the kernel), updates its 16 elements, and stores two partial sums
// of y; step t + 1's operands are loaded while step t computes, and two
// accumulators a column break the y chain.  Eight producer warps, in two
// groups that take alternate chunks, do the rest in parallel: they stage the
// input, convert bf16 r and k to f32, convert v, form ru_t, add up the
// consumers' partial sums of each column in a fixed tree order, and store y
// coalesced.  Time moves in chunks of kCT = 16 steps through kBufs = 4
// chunk buffers in shared memory, handed over by mbarriers: landed (the
// chunk's copies are in), full (producers -> consumers) and empty
// (consumers -> producers).
//
// Staging.  A producer group copies its next chunk's raw rows (r, k, v in
// their own type, w f32) with cp.async, 16 bytes at a time, while it
// finishes the current one; each thread's copies arrive on the buffer's
// landed barrier when they complete (cp.async.mbarrier.arrive.noinc), so
// loads run one group turn (two chunks) ahead.  Inputs cp.async cannot
// take (bases or strides not 16-byte aligned) and T = 1 (decode) go to the
// same kernel without the asynchronous copies (ASYNC = false): the
// producers copy the rows with plain loads and stores.  Both
// instantiations run the same arithmetic, every sum in float32 in a fixed
// order with no atomics, so results are bitwise the same from run to run
// and do not depend on where a caller splits T (the state is carried
// exactly).
//
// What bounds it: at the prefill shape the function needs 5 hd^2 float32
// operations per token and head (r^T S, then w S + k v^T: 1.34 GFLOP,
// 0.0200 ms at 67 TFLOP/s) and moves about 52 MB (0.0156 ms at 3.35 TB/s),
// so the float32 rate bounds it.  This kernel is bound by shared memory
// instead: the consumers load about 7 bytes per state element and step
// (12 bytes of r, k, w shared by two columns, 4 of v shared by 8 rows, and
// store 4 of partial sum per 8 rows), about 1.9 GB in a call, which at 128
// bytes a clock an SM (33 TB/s on 132 SMs at 1.98 GHz) is about 0.056 ms;
// the producers' staging and sums share that bandwidth.  On an NVIDIA
// H100 80GB HBM3 at 700.00 W it takes about 0.068 ms at the prefill shape
// (chip_smoke.py prints the time; PERF.md keeps it), against 0.43 ms for
// the one-block-per-head kernel it replaced.  ptxas: 85 to 138 registers a
// thread, no spill, in the 12 instantiations (chip_smoke.py's build phase
// prints them and fails on a spill).
//
// Saved states.  Given a `states` buffer (B, H, ceil(T / kCT), hd, hd) in
// float32, the consumers also store S at the start of every chunk: state c
// is S before step c * kCT (state 0 is s0).  The backward (wkv6_bwd.cu)
// starts each chunk from it.  The stores touch no value the arithmetic
// reads, so y and sT are bitwise those of a launch without the buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCT = 16;       // timesteps per chunk
constexpr int kBufs = 4;      // chunk buffers: chunks in flight
constexpr int kBarBytes = 128;

// Block shape for head dim HD.  Consumer thread ct (ct < NCT) owns
// columns 2 jp and 2 jp + 1 (jp = ct % (NC / 2)) of the block's NC columns
// and rows q * RPT .. q * RPT + RPT - 1 of both (q = ct / (NC / 2)): each
// r, k, w value it loads serves two columns.  NCT is 128 where hd allows.
template <int HD>
struct Shape {
  static constexpr int RPT = HD < 32 ? 4 : 8;      // rows a consumer holds
  static constexpr int G = HD / RPT;               // row groups
  static constexpr int NC = HD < 256 / G ? HD : 256 / G;   // block's columns
  static constexpr int NCT = NC / 2 * G;           // consumer threads
  static constexpr int NCW = NCT / 32;             // consumer warps
  static constexpr int NPG = 32 * (NCW < 4 ? NCW : 4);   // producer threads
                                                   // of each of 2 groups
  static constexpr int NT = NCT + 2 * NPG;
  static constexpr int RB = HD / 8;                // 8-row blocks of a step
  static_assert(NCT % 32 == 0 && RPT % 4 == 0 && RB <= 32 &&
                (32 % RB) == 0 && (kCT * RB) % 32 == 0 && kBufs % 2 == 0,
                "block shape");
};

// One chunk buffer: the raw chunk as copied (r, k [kCT][HD] and v's
// columns [kCT][NC] in TR, w [kCT][HD] f32), then v in f32 [kCT][NC],
// ru [kCT], the consumers' partial sums P [kCT][G][NC], and for bf16 r and
// k in f32 [kCT][HD] (RF, KF; float r and k are read where they landed).
template <typename TR, int HD>
struct Buf {
  using C = Shape<HD>;
  static constexpr int kRow = HD * sizeof(TR);   // bytes of an r or k row
  static constexpr int R = 0;
  static constexpr int K = R + kCT * kRow;
  static constexpr int W = K + kCT * kRow;
  static constexpr int V = W + kCT * HD * 4;
  static constexpr int VF = V + kCT * C::NC * int(sizeof(TR));
  static constexpr int U = VF + kCT * C::NC * 4;
  static constexpr int P = U + kCT * 4;
  static constexpr bool CONV = !std::is_same<TR, float>::value;
  static constexpr int RF = P + kCT * C::G * C::NC * 4;
  static constexpr int KF = RF + (CONV ? kCT * HD * 4 : 0);
  static constexpr int BYTES = KF + (CONV ? kCT * HD * 4 : 0);
  static constexpr int RS = CONV ? RF : R;   // f32 r and k for consumers
  static constexpr int KS = CONV ? KF : K;
  static_assert(V % 16 == 0 && VF % 16 == 0 && P % 16 == 0 &&
                BYTES % 16 == 0, "buffer layout");
};

template <typename TR, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return kBarBytes + HD * 4 + kBufs * Buf<TR, HD>::BYTES;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive elements (16-byte aligned) from shared memory as
// floats, in two float4s.
__device__ __forceinline__ void load8(float4 (&d)[2], const float* src) {
  d[0] = reinterpret_cast<const float4*>(src)[0];
  d[1] = reinterpret_cast<const float4*>(src)[1];
}

__device__ __forceinline__ void load8(float4 (&d)[2],
                                      const __nv_bfloat16* src) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  float f[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {   // bf16 -> f32 is exact: the high half
    f[2 * m] = __uint_as_float(w[m] << 16);
    f[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
  d[0] = make_float4(f[0], f[1], f[2], f[3]);
  d[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// One arrival (release: the thread's earlier writes are visible to a
// thread that then sees the phase complete).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 16 bytes from global to shared memory, both 16-byte aligned, without
// passing through registers.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far
// has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The barrier of one producer group's N threads (named barrier id).
template <int N>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(N) : "memory");
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
  float* states;     // (B, H, ceil(T / kCT), hd, hd), contiguous, or null
  int B, T, H;
  long long r_sb, r_st, r_sh;   // element strides of (B, T, H, hd); d is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long y_sb, y_st, y_sh;
};

// ------------------------------------------------------------- producers

// Copies n <= kCT rows of ROW bytes, `st_bytes` apart from `src`, into
// shared memory at `dst` (rows packed), 16 bytes per cp.async, spread over
// the NP threads of a group.
template <int ROW, int NP>
__device__ __forceinline__ void copy_rows(uint32_t dst, const void* src,
                                          long long st_bytes, int n,
                                          int pt) {
  constexpr int kP = ROW / 16;   // pieces a row
#pragma unroll
  for (int i = 0; i < (kCT * kP + NP - 1) / NP; ++i) {
    const int e = pt + i * NP, t = e / kP, o = e % kP;
    if (e >= kCT * kP || t >= n) break;
    cp_async16(dst + t * ROW + o * 16,
               static_cast<const char*>(src) + t * st_bytes + o * 16);
  }
}

// The same with plain loads and stores, element by element: any
// alignment.
template <typename T, int ROW, int NP>
__device__ __forceinline__ void copy_rows_sync(T* dst, const T* src,
                                               long long st, int n, int pt) {
  constexpr int kE = ROW / int(sizeof(T));   // elements a row
  for (int e = pt; e < n * kE; e += NP) dst[e] = src[(e / kE) * st + e % kE];
}

// Completes a chunk of n steps in buffer `bf` once its raw rows are in:
// r, k (bf16) and v to f32, and ru_t = sum_i r_i u_i k_i.  Producer thread
// pt takes 8-row blocks (t, rb); ru_t sums each block's rows in order,
// then a butterfly over the RB adjacent lanes that share t: a fixed order.
template <typename TR, int HD, int NP>
__device__ __forceinline__ void finish_chunk(unsigned char* bf,
                                             const float* u_s, int n,
                                             int pt) {
  using C = Shape<HD>;
  using L = Buf<TR, HD>;
  const TR* r = reinterpret_cast<const TR*>(bf + L::R);
  const TR* k = reinterpret_cast<const TR*>(bf + L::K);
  const TR* v = reinterpret_cast<const TR*>(bf + L::V);
  float* Fv = reinterpret_cast<float*>(bf + L::VF);
  float* Fu = reinterpret_cast<float*>(bf + L::U);
#pragma unroll
  for (int e0 = 0; e0 < kCT * C::RB; e0 += NP) {
    const int e = e0 + pt, t = e / C::RB, rb = e % C::RB;
    const bool valid = e < kCT * C::RB && t < n;
    float part = 0.f;
    if (valid) {
      float4 r4[2], k4[2], u4[2];
      load8(r4, r + t * HD + rb * 8);
      load8(k4, k + t * HD + rb * 8);
      load8(u4, u_s + rb * 8);
      if constexpr (L::CONV) {
        const int at = (t * HD + rb * 8) / 4;
        float4* rf = reinterpret_cast<float4*>(bf + L::RF) + at;
        float4* kf = reinterpret_cast<float4*>(bf + L::KF) + at;
        rf[0] = r4[0];
        rf[1] = r4[1];
        kf[0] = k4[0];
        kf[1] = k4[1];
      }
      const float rv[8] = {r4[0].x, r4[0].y, r4[0].z, r4[0].w,
                           r4[1].x, r4[1].y, r4[1].z, r4[1].w};
      const float kv[8] = {k4[0].x, k4[0].y, k4[0].z, k4[0].w,
                           k4[1].x, k4[1].y, k4[1].z, k4[1].w};
      const float uv[8] = {u4[0].x, u4[0].y, u4[0].z, u4[0].w,
                           u4[1].x, u4[1].y, u4[1].z, u4[1].w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
        part = fmaf(rv[m], __fmul_rn(uv[m], kv[m]), part);
    }
#pragma unroll
    for (int o = 1; o < C::RB; o <<= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (valid && rb == 0) Fu[t] = part;
  }
#pragma unroll
  for (int i = 0; i < (kCT * C::NC + NP - 1) / NP; ++i) {
    const int e = pt + i * NP;
    if (e >= n * C::NC) break;
    Fv[e] = to_f32(v[e]);
  }
}

// Four y values (16-byte or 8-byte aligned) stored at once.
__device__ __forceinline__ void store4(float* y, const float (&v)[4]) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(y) = u;
}

// y of one chunk of n steps from buffer `bf`: each column's G partial sums
// added in a fixed tree ((p0 + p1) + (p2 + p3)) ..., then v_j ru_t; four
// adjacent columns a thread, coalesced stores.
template <typename TR, int HD, int NP>
__device__ __forceinline__ void emit_y(TR* y, long long y_st,
                                       const unsigned char* bf, int n,
                                       int pt) {
  using C = Shape<HD>;
  using L = Buf<TR, HD>;
  constexpr int NQ = C::NC / 4;   // column quads
  const float4* Fv = reinterpret_cast<const float4*>(bf + L::VF);
  const float* Fu = reinterpret_cast<const float*>(bf + L::U);
  const float4* P = reinterpret_cast<const float4*>(bf + L::P);
#pragma unroll
  for (int i = 0; i < (kCT * NQ + NP - 1) / NP; ++i) {
    const int e = pt + i * NP, t = e / NQ, jq = e % NQ;
    if (e >= kCT * NQ || t >= n) break;
    float s[C::G][4];
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      const float4 a = P[(t * C::G + g) * NQ + jq];
      s[g][0] = a.x; s[g][1] = a.y; s[g][2] = a.z; s[g][3] = a.w;
    }
#pragma unroll
    for (int o = 1; o < C::G; o <<= 1)
#pragma unroll
      for (int g = 0; g < C::G; g += 2 * o)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[g][c] = __fadd_rn(s[g][c], s[g + o][c]);
    const float4 v4 = Fv[e];
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = fmaf(vv[c], Fu[t], s[0][c]);
    store4(y + t * y_st + 4 * jq, out);
  }
}

// ------------------------------------------------------------- consumers

// One step's operands for a consumer: its RPT rows of r, k, w and its
// two columns' v, all f32.
template <int HD>
struct StepIn {
  float4 r[Shape<HD>::RPT / 4], k[Shape<HD>::RPT / 4], w[Shape<HD>::RPT / 4];
  float2 v;
};

// Loads step t's operands from buffer `bf`.
template <typename TR, int HD>
__device__ __forceinline__ void load_step(StepIn<HD>& in,
                                          const unsigned char* bf, int t,
                                          int jp, int q) {
  using C = Shape<HD>;
  using L = Buf<TR, HD>;
  const int row4 = (t * HD + q * C::RPT) / 4;
  const float4* r4 = reinterpret_cast<const float4*>(bf + L::RS) + row4;
  const float4* k4 = reinterpret_cast<const float4*>(bf + L::KS) + row4;
  const float4* w4 = reinterpret_cast<const float4*>(bf + L::W) + row4;
#pragma unroll
  for (int m4 = 0; m4 < C::RPT / 4; ++m4) {
    in.r[m4] = r4[m4];
    in.k[m4] = k4[m4];
    in.w[m4] = w4[m4];
  }
  in.v = reinterpret_cast<const float2*>(bf + L::VF)[t * C::NC / 2 + jp];
}

// One step for the consumer's RPT x 2 block of S: updates it and returns
// its partial sums of r^T S for the two columns, each over its rows in a
// fixed order (two accumulators a column).
template <int HD>
__device__ __forceinline__ float2 update(float (&S)[Shape<HD>::RPT][2],
                                         const StepIn<HD>& in) {
  using C = Shape<HD>;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const float vv[2] = {in.v.x, in.v.y};
#pragma unroll
  for (int m4 = 0; m4 < C::RPT / 4; ++m4) {
    const float rv[4] = {in.r[m4].x, in.r[m4].y, in.r[m4].z, in.r[m4].w};
    const float kv[4] = {in.k[m4].x, in.k[m4].y, in.k[m4].z, in.k[m4].w};
    const float wv[4] = {in.w[m4].x, in.w[m4].y, in.w[m4].z, in.w[m4].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = 4 * m4 + c;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[j][c & 1] = fmaf(rv[c], S[m][j], acc[j][c & 1]);   // r_i S_ij
        S[m][j] = fmaf(wv[c], S[m][j], __fmul_rn(kv[c], vv[j]));
      }
    }
  }
  return make_float2(__fadd_rn(acc[0][0], acc[0][1]),
                     __fadd_rn(acc[1][0], acc[1][1]));
}

// The chunk's n steps; step t's partial sums go to P[t][q][2 jp ..].  Step
// t + 1's operands are loaded while step t computes.  FULL (n == kCT)
// drops the bounds tests.
template <typename TR, int HD, bool FULL>
__device__ __forceinline__ void run_chunk(float (&S)[Shape<HD>::RPT][2],
                                          unsigned char* bf, int n, int jp,
                                          int q) {
  using C = Shape<HD>;
  float2* P2 = reinterpret_cast<float2*>(bf + Buf<TR, HD>::P);
  StepIn<HD> cur, nxt;
  load_step<TR, HD>(cur, bf, 0, jp, q);
#pragma unroll
  for (int t = 0; t < kCT; ++t) {
    if (!FULL && t >= n) break;
    const bool more = t + 1 < kCT && (FULL || t + 1 < n);
    if (more) load_step<TR, HD>(nxt, bf, t + 1, jp, q);
    P2[(t * C::G + q) * (C::NC / 2) + jp] = update<HD>(S, cur);
    if (more) cur = nxt;
  }
}

// ---------------------------------------------------------------- kernel

// Block: NC columns j0 .. j0 + NC - 1 of head (b, h).  Warps 0 .. NCW - 1
// are consumers (the state, in registers); the 2 NPG / 32 warps after
// them are producers, in two groups: group g stages the chunks c with
// c % 2 == g.  Chunk c lives in buffer c % kBufs, handed over by mbarriers
// landed (its copies are in), full (producers -> consumers: v and ru are
// ready) and empty (consumers -> producers: the partial sums are in P and
// the buffer may be reused once y is out).
template <typename TR, int HD, bool ASYNC>
__global__ void __launch_bounds__(Shape<HD>::NT) wkv6_kernel(const Params p) {
  using C = Shape<HD>;
  using L = Buf<TR, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kBufs;
  uint64_t* landed = empty + kBufs;
  float* u_s = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned char* buf0 = smem + kBarBytes + HD * 4;

  const int tid = threadIdx.x;
  constexpr int kSlices = HD / C::NC;
  const int bh = blockIdx.x / kSlices;
  const int j0 = (blockIdx.x % kSlices) * C::NC;
  const int b = bh / p.H, h = bh % p.H;
  const int nchunks = (p.T + kCT - 1) / kCT;

  for (int i = tid; i < HD; i += C::NT) u_s[i] = p.u[h * HD + i];
  if (tid == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(smem_u32(&full[i]), C::NPG);
      mbar_init(smem_u32(&empty[i]), C::NCT);
      mbar_init(smem_u32(&landed[i]), C::NPG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < C::NCT) {
    // Consumer: rows q * RPT .. of columns j0 + 2 jp, j0 + 2 jp + 1 of S,
    // in registers.
    const int jp = tid % (C::NC / 2), q = tid / (C::NC / 2);
    const long long sbase =
        static_cast<long long>(bh) * HD * HD + j0 + 2 * jp;
    float S[C::RPT][2];
#pragma unroll
    for (int m = 0; m < C::RPT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        S[m][j] = p.s0[sbase + (q * C::RPT + m) * HD + j];
    for (int c = 0; c < nchunks; ++c) {
      const int n = min(kCT, p.T - c * kCT), buf = c % kBufs;
      unsigned char* bf = buf0 + buf * L::BYTES;
      if (p.states) {   // S before step c * kCT, for the backward
        float* st = p.states +
                    (static_cast<long long>(bh) * nchunks + c) * HD * HD +
                    j0 + 2 * jp;
#pragma unroll
        for (int m = 0; m < C::RPT; ++m)
          *reinterpret_cast<float2*>(st + (q * C::RPT + m) * HD) =
              make_float2(S[m][0], S[m][1]);
      }
      mbar_wait(smem_u32(&full[buf]), (c / kBufs) & 1);
      if (n == kCT) {
        run_chunk<TR, HD, true>(S, bf, n, jp, q);
      } else {
        run_chunk<TR, HD, false>(S, bf, n, jp, q);
      }
      mbar_arrive(smem_u32(&empty[buf]));
    }
#pragma unroll
    for (int m = 0; m < C::RPT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        p.sT[sbase + (q * C::RPT + m) * HD + j] = S[m][j];
    return;
  }

  // Producer thread pt of group g.
  constexpr int NP = C::NPG;
  const int g = (tid - C::NCT) / NP, pt = (tid - C::NCT) % NP;
  const TR* rp = static_cast<const TR*>(p.r) + b * p.r_sb + h * p.r_sh;
  const TR* kp = static_cast<const TR*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TR* vp = static_cast<const TR*>(p.v) + b * p.v_sb + h * p.v_sh + j0;
  const float* wp = p.w + b * p.w_sb + h * p.w_sh;
  TR* yp = static_cast<TR*>(p.y) + b * p.y_sb + h * p.y_sh + j0;

  // Copies chunk c's raw rows into its buffer: cp.async arriving on the
  // buffer's landed barrier, or plain copies.
  auto stage = [&](int c) {
    const int t0 = c * kCT, n = min(kCT, p.T - t0), buf = c % kBufs;
    unsigned char* bf = buf0 + buf * L::BYTES;
    if constexpr (ASYNC) {
      const uint32_t st = smem_u32(bf);
      copy_rows<L::kRow, NP>(st + L::R, rp + t0 * p.r_st,
                             p.r_st * sizeof(TR), n, pt);
      copy_rows<L::kRow, NP>(st + L::K, kp + t0 * p.k_st,
                             p.k_st * sizeof(TR), n, pt);
      copy_rows<HD * 4, NP>(st + L::W, wp + t0 * p.w_st, p.w_st * 4, n, pt);
      copy_rows<C::NC * int(sizeof(TR)), NP>(st + L::V, vp + t0 * p.v_st,
                                             p.v_st * sizeof(TR), n, pt);
      cp_async_arrive(smem_u32(&landed[buf]));
    } else {
      copy_rows_sync<TR, L::kRow, NP>(reinterpret_cast<TR*>(bf + L::R),
                                      rp + t0 * p.r_st, p.r_st, n, pt);
      copy_rows_sync<TR, L::kRow, NP>(reinterpret_cast<TR*>(bf + L::K),
                                      kp + t0 * p.k_st, p.k_st, n, pt);
      copy_rows_sync<float, HD * 4, NP>(reinterpret_cast<float*>(bf + L::W),
                                        wp + t0 * p.w_st, p.w_st, n, pt);
      copy_rows_sync<TR, C::NC * int(sizeof(TR)), NP>(
          reinterpret_cast<TR*>(bf + L::V), vp + t0 * p.v_st, p.v_st, n, pt);
      mbar_arrive(smem_u32(&landed[buf]));
    }
  };

  // The group's chunk c: stage chunk c + 2 (the group's next) once chunk
  // c + 2 - kBufs has left its buffer (emit its y first), then finish
  // chunk c, staged one turn earlier.
  if (g < nchunks) stage(g);
  for (int c = g; c < nchunks + kBufs - 2; c += 2) {
    const int c2 = c + 2, old = c2 - kBufs;
    if (old >= 0 && old < nchunks) {
      const int buf = old % kBufs, t0 = old * kCT;
      mbar_wait(smem_u32(&empty[buf]), (old / kBufs) & 1);
      emit_y<TR, HD, NP>(yp + t0 * p.y_st, p.y_st, buf0 + buf * L::BYTES,
                         min(kCT, p.T - t0), pt);
    }
    // Every thread of the group is done with chunk `old`'s buffer.
    group_sync<NP>(1 + g);
    if (c2 < nchunks) stage(c2);
    if (c < nchunks) {
      const int buf = c % kBufs;
      mbar_wait(smem_u32(&landed[buf]), (c / kBufs) & 1);
      finish_chunk<TR, HD, NP>(buf0 + buf * L::BYTES, u_s,
                               min(kCT, p.T - c * kCT), pt);
      mbar_arrive(smem_u32(&full[buf]));
    }
  }
}

template <typename TR, int HD, bool ASYNC>
int launch(const Params& p, cudaStream_t stream) {
  using C = Shape<HD>;
  constexpr size_t smem = smem_bytes<TR, HD>();
  auto* kernel = wkv6_kernel<TR, HD, ASYNC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<p.B * p.H * (HD / C::NC), C::NT, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// cp.async needs 16-byte aligned sources: the base and the stride of
// every dimension longer than 1.
bool aligned16(const void* ptr, int esz, const Params& p, long long sb,
               long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (p.B == 1 || sb * esz % 16 == 0) &&
         (p.T == 1 || st * esz % 16 == 0) && (p.H == 1 || sh * esz % 16 == 0);
}

// The asynchronous copies take T > 1 with every input aligned; the rest
// goes to the same kernel with plain copies.
bool uses_ring(const Params& p, int esz) {
  return p.T > 1 && aligned16(p.r, esz, p, p.r_sb, p.r_st, p.r_sh) &&
         aligned16(p.k, esz, p, p.k_sb, p.k_st, p.k_sh) &&
         aligned16(p.v, esz, p, p.v_sb, p.v_st, p.v_sh) &&
         aligned16(p.w, 4, p, p.w_sb, p.w_st, p.w_sh);
}

template <typename TR, int HD>
int launch_hd(const Params& p, cudaStream_t stream) {
  return uses_ring(p, sizeof(TR)) ? launch<TR, HD, true>(p, stream)
                                  : launch<TR, HD, false>(p, stream);
}

template <typename TR>
int dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<TR, 16>(p, stream);
    case 64: return launch_hd<TR, 64>(p, stream);
    case 128: return launch_hd<TR, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

#define WKV6_ARGS                                                         \
  const void *r, const void *k, const void *v, const void *w, const void *u, \
      const void *s0, void *y, void *sT, void *states, int rkv_dtype, int B,  \
      int T, int H, int hd, long long r_sb, long long r_st, long long r_sh,   \
      long long k_sb, long long k_st, long long k_sh, long long v_sb,         \
      long long v_st, long long v_sh, long long w_sb, long long w_st,         \
      long long w_sh, long long y_sb, long long y_st, long long y_sh,         \
      void *stream

#define WKV6_PARAMS                                                         \
  Params {                                                                  \
    r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),    \
        static_cast<const float*>(s0), y, static_cast<float*>(sT),          \
        static_cast<float*>(states), B, T, H,                               \
        r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st,   \
        w_sh, y_sb, y_st, y_sh                                              \
  }

extern "C" {

// Type code rkv_dtype for r, k, v and y: 0 = float32, 1 = bfloat16.  w, u,
// s0 and sT are float32; u, s0 and sT are contiguous.  `states` is null
// or the (B, H, ceil(T / 16), hd, hd) float32 buffer of saved states.
// Returns 0, a cudaError_t, or -1 for an unsupported head dim or type.
// Launches on `stream`, does not synchronize.
int wkv6_fwd(WKV6_ARGS) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  const Params p = WKV6_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == 0) return dispatch<float>(p, hd, s);
  if (rkv_dtype == 1) return dispatch<__nv_bfloat16>(p, hd, s);
  return -1;
}

// With wkv6_fwd's arguments: 1 if that call stages time by cp.async,
// 0 if it takes the kernel without it (T <= 1 or an unaligned input).
// Launches nothing.
int wkv6_uses_ring(WKV6_ARGS) {
  return uses_ring(WKV6_PARAMS, rkv_dtype == 1 ? 2 : 4);
}

const char* wkv6_error_string(int code) {
  return code < 0 ? "unsupported head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
