// RWKV6 WKV recurrence, backward, for NVIDIA Hopper (sm_90a), with a plain
// C interface so that it can be built by nvcc alone and loaded with ctypes.
//
// Replaces no TPU kernel: the reference differentiates the recurrence as a
// lax.scan (src/repro/models/rwkv.py), and its Pallas kernel
// (src/repro/kernels/rwkv6/kernel.py::_wkv_kernel) has no VJP.  It is the
// backward of the port's forward kernel (wkv6.cu), so that rwkv6 trains
// through that kernel.
//
// What it computes: per (batch, head), with S_{t-1} the state before step
// t, G_T = dsT (zero when absent) and t walking T .. 1,
//   dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
//   dk_t = u ⊙ r_t (v_t · dy_t) + G_t v_t
//   dv_t = (Σ_i r_t[i] u_i k_t[i]) dy_t + G_tᵀ k_t
//   dw_t[i] = Σ_j G_t[i, j] S_{t-1}[i, j]
//   du += r_t ⊙ k_t (v_t · dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ
// and ds0 = G_0; every product in float32.  dr, dk and dv come out in r's
// type, dw, du and ds0 in float32.
//
// Design.  Column j of S and of G evolves on its own, so the columns of a
// head are cut into slices of kNC = 16, and the blocks of a head form one
// thread block cluster that sums the slices' row sums in shared memory.
// At hd 64 a block holds two slices (32 columns) and a cluster two blocks:
// 256 blocks at rwkv6_1_6b's training shape (B 4, H 32, hd 64), one an SM,
// two waves (66 clusters fit at once); at hd 128 eight blocks of one slice,
// at hd 16 one.  Time goes in chunks of kCT = 16 steps, the forward's chunk,
// last chunk first.  A block has four roles:
//
// - Consumer warps (hd / 16 a slice) hold G: a thread owns one row i and
//   kCPT = 8 adjacent columns, the 2 threads of a row are adjacent lanes.
//   For each chunk a thread recomputes S_{t-1} from the forward's kept state
//   with the forward's own instructions (so bitwise its states), 8 steps at
//   a time into registers (the second half of the chunk first, from the
//   state after 8 steps, then the first half again from the kept state),
//   and walks back through them.  Each step's row sums (the S dy, G v and
//   G ⊙ S parts of dr, dk and dw) are reduced over the row's 2 lanes and its
//   column sums (dv's G k part) over the warp's 16 rows by reduce-scatter
//   rounds, in which each round halves the values a lane carries: 2 + 8 = 10
//   shuffles a step for 8 elements.  The row sums are pushed with st.async
//   into the partial-sum buffer of the block that writes the row (in the
//   same cluster, through distributed shared memory), whose barrier counts
//   their bytes; the column sums go to the block's own buffer.
// - A loader warp stages each chunk (r, k, w, the head's whole v and dy
//   rows, the block's columns of the kept state) into a ring of input
//   buffers with cp.async, three chunks ahead for bf16 at hd 64 (two
//   otherwise), then forms v and dy of the block's columns in float32, and
//   ru_t = Σ r u k and v_t · dy_t over the head for all 16 steps at once (a
//   reduce-scatter over the warp).  Inputs cp.async cannot take (a base or
//   stride not 16-byte aligned) go to the same kernel with plain copies
//   (ASYNC = false), as in the forward.
// - An epilogue warp, once every slice of the head has pushed a chunk's row
//   sums, adds them in the order of their columns, adds the u terms, writes
//   dr, dk and dw of the block's rows, and keeps du's sums in registers
//   across the walk (a scratch of B * H * hd floats, which a second kernel
//   adds over batch).
// - A dv warp adds the consumer warps' column sums in order, adds ru_t dy_t
//   and writes dv of the block's columns.
//
// mbarriers hand buffers over: landed (a chunk's copies are in), full
// (loader -> consumers), empty (epilogue and dv warps -> loader), ready
// (the pushed row sums' bytes are in), qready (consumers -> dv warp) and
// pfree (every block's epilogue has read this block's pushes, and the dv
// warp its column sums).  The consumers issue no release at the cluster's
// scope (it compiles to a fence over the whole device): their sums travel by
// st.async.  A wait that never completes traps rather than hanging the card.
// No atomics: every sum has a fixed order, so two runs are bitwise equal.
//
// What bounds it: about 13 float32 operations per state element, token and
// head (the recompute's w S + k v, then S dy, G v, G ⊙ S, G k and w G + r
// dy), 6.98 GFLOP at the training shape, 0.104 ms at 67 TFLOP/s, against
// about 320 MB of operands and kept states (0.096 ms at 3.35 TB/s).  This
// kernel issues about 16 instructions a state element and step (a consumer
// thread's 8 elements: 51 float32 ones of the walk, 22 of the recompute's
// 22 updates a chunk, 10 shuffles, 10 adds and 18 selects of the
// reductions, 12 shared-memory loads), with two consumer warps a scheduler
// (their 124 to 153 registers allow no more), so issue and the latency of
// the reductions' shuffles bound it.  chip_smoke.py prints its time beside
// the bound and, timed alone, its walk's and epilogue's parts; PERF.md
// keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCT = 16;          // steps a chunk; the forward keeps S each
constexpr int kHalf = 8;         // steps whose states a thread holds at once
constexpr int kCPT = 8;          // columns a consumer thread
constexpr int kCG = 2;           // consumer threads a row
constexpr int kNC = kCPT * kCG;  // columns a slice
constexpr int kPart = 3;         // partial-sum buffers
constexpr int kBarBytes = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr long long kWaitCycles = 1LL << 35;   // a wait's limit, > 10 s

// Parts of the kernel left out by a timing launch (wkv6_bwd_skipping).
constexpr int kSkipWalk = 1;       // the consumers' walk and the dv warp's sums
constexpr int kSkipExchange = 2;   // the epilogue's sums and stores

template <typename TR, int HD>
struct Shape {
  // slices a block: two at hd 64, so that the 128 clusters of the training
  // shape take two waves of 66 (one a wave more than 62 clusters of 4)
  static constexpr int SPB = HD == 64 ? 2 : 1;
  static constexpr int BC = kNC * SPB;                // columns a block
  static constexpr int NCL = HD / BC;                 // blocks a cluster
  static constexpr int WPS = HD / 16;                 // warps a slice
  static constexpr int NCT = SPB * HD * kCG;          // consumer threads
  static constexpr int NCW = NCT / 32;                // consumer warps
  static constexpr int NT = NCT + 96;                 // + 3 producer warps
  static constexpr int MINB = 1;                      // blocks an SM
  static constexpr int NIN = sizeof(TR) == 2 && HD <= 64 ? 3 : 2;  // inputs
  static constexpr int ROWS = HD / NCL;               // rows a block writes
  static constexpr int NSRC = NCL * SPB;             // slices of a head
  static_assert(NCT % 32 == 0 && HD % BC == 0 && ROWS % 16 == 0 &&
                NCL <= 8 && NT <= 1024, "block shape");
};

// One input buffer: the chunk's rows as copied (r, k, v, dy in their own
// type, w f32, each [kCT][HD]), the block's columns of the kept state
// [HD][BC] f32, then v and dy of the block's columns in f32 [kCT][BC],
// ru [kCT] and v · dy [kCT].
template <typename TR, int HD>
struct InBuf {
  static constexpr int BC = Shape<TR, HD>::BC;
  static constexpr int kRow = HD * int(sizeof(TR));   // bytes of a TR row
  static constexpr int R = 0;
  static constexpr int K = R + kCT * kRow;
  static constexpr int V = K + kCT * kRow;
  static constexpr int DY = V + kCT * kRow;
  static constexpr int W = DY + kCT * kRow;
  static constexpr int ST = W + kCT * HD * 4;
  static constexpr int VF = ST + HD * BC * 4;
  static constexpr int DF = VF + kCT * BC * 4;
  static constexpr int RU = DF + kCT * BC * 4;
  static constexpr int VDY = RU + kCT * 4;
  static constexpr int BYTES = VDY + kCT * 4;
  static_assert(W % 16 == 0 && ST % 16 == 0 && VF % 16 == 0 &&
                BYTES % 16 == 0, "input buffer layout");
};

// A block's shared memory: barriers, u, NIN input buffers, and kPart
// buffers each of partial sums P [kCT][NSRC][3][ROWS] (each slice of the
// head's sums over its columns of S dy, G v and G ⊙ S for the block's
// rows, pushed there by the slice's block) and Q [kCT][NCW][kNC] (each
// consumer warp's sum of G k over its 16 rows).
template <typename TR, int HD>
struct Lay {
  using C = Shape<TR, HD>;
  static constexpr int LANDED = 0, FULL = C::NIN, EMPTY = 2 * C::NIN,
                       READY = 3 * C::NIN, QREADY = READY + kPart,
                       PFREE = QREADY + kPart;
  static constexpr int PB = kCT * C::NSRC * 3 * C::ROWS * 4;  // bytes of a P
  static constexpr int QB = kCT * C::NCW * kNC * 4;         // bytes of a Q
  static constexpr int U = kBarBytes;
  static constexpr int IN = U + HD * 4;
  static constexpr int P = IN + C::NIN * InBuf<TR, HD>::BYTES;
  static constexpr int Q = P + kPart * PB;
  static constexpr int BYTES = Q + kPart * QB;
  static_assert((PFREE + kPart) * 8 <= kBarBytes && IN % 16 == 0 &&
                P % 16 == 0 && Q % 16 == 0, "shared memory layout");
};

struct BwdParams {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;        // (H, hd), contiguous
  const float* states;   // (B, H, ceil(T / kCT), hd, hd), contiguous
  const void* dy;
  const float* dsT;      // (B, H, hd, hd), contiguous, or null
  void* dr;              // (B, T, H, hd), contiguous, in r's type
  void* dk;
  void* dv;
  float* dw;             // (B, T, H, hd), contiguous
  float* du;             // (H, hd)
  float* ds0;            // (B, H, hd, hd)
  float* scratch;        // du's sums (B, H, hd)
  int B, T, H;
  long long r_sb, r_st, r_sh;   // element strides of (B, T, H, hd); d is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long dy_sb, dy_st, dy_sh;
  int skip;              // kSkipWalk | kSkipExchange: timing launches only
};

// A block's place: head bh = (b, h), rank its place in the head's cluster
// (its columns are rank * BC ..), and the chunks of time.
struct Blk {
  int bh, b, h, rank, nch;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TR>
__device__ __forceinline__ TR from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eight values stored at once (16-byte aligned).
__device__ __forceinline__ void store8(float* y, const float (&v)[8]) {
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* y, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(v[2 * m], v[2 * m + 1]);
    w[m] = *reinterpret_cast<const uint32_t*>(&x);
  }
  *reinterpret_cast<uint4*>(y) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ------------------------------------------------ barriers and the cluster

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (release, then acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The address of this shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Stores x at `addr` of a block of the cluster (mapa'd) and counts its 4
// bytes on that block's barrier `bar` (mapa'd) when it lands.
__device__ __forceinline__ void st_async(uint32_t addr, float x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "f"(x), "r"(bar) : "memory");
}

// One arrival on `bar` that also expects `bytes` more of asynchronous
// stores before its phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival on a barrier of this block (release at the block's scope).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival on the same barrier of block `rank` (release at the
// cluster's scope).
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(mapa(smem_u32(bar), rank)) : "memory");
}

// Returns once the phase of parity `parity` has completed; CLUSTER waits
// with acquire at the cluster's scope (for arrivals from other blocks).
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  for (;;) {
    if constexpr (CLUSTER) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
    if (done) return;
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// 16 bytes from global to shared memory, both 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far
// has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Copies n rows of ROW bytes, `st_bytes` apart from `src`, into shared
// memory at `dst` (rows packed), 16 bytes per cp.async, over a warp.
template <int ROW>
__device__ __forceinline__ void copy_rows(uint32_t dst, const void* src,
                                          long long st_bytes, int n,
                                          int lane) {
  constexpr int kP = ROW / 16;   // pieces a row
#pragma unroll 1
  for (int e = lane; e < n * kP; e += 32) {
    const int t = e / kP, o = e % kP;
    cp_async16(dst + t * ROW + o * 16,
               static_cast<const char*>(src) + t * st_bytes + o * 16);
  }
}

// Plain copies, element by element: any alignment.
template <typename T, int ROW>
__device__ __forceinline__ void copy_rows_sync(T* dst, const T* src,
                                               long long st, int n, int lane) {
  constexpr int kE = ROW / int(sizeof(T));   // elements a row
  for (int e = lane; e < n * kE; e += 32) dst[e] = src[(e / kE) * st + e % kE];
}

// Two adjacent elements (8-byte or 4-byte aligned) as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// One round of a reduce-scatter over lane bit O: the lanes with the bit set
// keep v[CNT .. 2 CNT), the others v[0 .. CNT), each adding its partner's
// copy; the kept values end in v[0 .. CNT).
template <int O, int CNT, int N>
__device__ __forceinline__ void rs_round(float (&v)[N], int lane) {
  static_assert(2 * CNT <= N, "reduce-scatter round");
  const bool hi = lane & O;
#pragma unroll
  for (int j = 0; j < CNT; ++j) {
    const float keep = hi ? v[CNT + j] : v[j], send = hi ? v[j] : v[CNT + j];
    v[j] = __fadd_rn(keep, __shfl_xor_sync(kAll, send, O));
  }
}

// ------------------------------------------------------------- consumers

// What a consumer thread is: its slice sl, row i and columns c0 .. c0 + 7
// of the block's, its lane and warp, and where its row sums go: the
// partial-sum buffer of the block that writes row i.
struct Me {
  int sl, i, cg, c0, lane, warp;
  uint32_t at;    // where this thread's first row sum of step 0 goes (mapa'd)
  uint32_t bar;   // the barrier that counts them there (mapa'd)
  float* q;       // where its warp's column sum of step 0 goes, in Q
};

// The 8 floats at p (16-byte aligned) of shared memory.
__device__ __forceinline__ void load8s(float (&d)[8], const unsigned char* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// Eight consecutive elements (16-byte aligned) of shared memory as floats.
__device__ __forceinline__ void load8(float (&d)[8], const float* src) {
  load8s(d, reinterpret_cast<const unsigned char*>(src));
}
__device__ __forceinline__ void load8(float (&d)[8],
                                      const __nv_bfloat16* src) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {   // bf16 -> f32 is exact: the high half
    d[2 * m] = __uint_as_float(w[m] << 16);
    d[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}

// S <- w_t S + k_t v_t for the thread's row and columns, as the forward
// computes it.
template <typename TR, int HD>
__device__ __forceinline__ void update(float (&S)[kCPT],
                                       const unsigned char* in, int t,
                                       const Me& me) {
  using L = InBuf<TR, HD>;
  const float wt = reinterpret_cast<const float*>(in + L::W)[t * HD + me.i];
  const float kt =
      to_f32(reinterpret_cast<const TR*>(in + L::K)[t * HD + me.i]);
  float vv[kCPT];
  load8s(vv, in + L::VF + (t * L::BC + me.c0) * 4);
#pragma unroll
  for (int x = 0; x < kCPT; ++x) S[x] = fmaf(wt, S[x], __fmul_rn(kt, vv[x]));
}

// Step t back: the thread's terms from G_t and S_{t-1} (Hs), G <- G_{t-1},
// the step's row sums pushed to the block that writes the row and its
// column sums into Q.
template <typename TR, int HD>
__device__ __forceinline__ void step(float (&G)[kCPT], const float (&Hs)[kCPT],
                                     const unsigned char* in, int t, Me& me) {
  using C = Shape<TR, HD>;
  using L = InBuf<TR, HD>;
  const int i = me.i, lane = me.lane;
  const float rt = to_f32(reinterpret_cast<const TR*>(in + L::R)[t * HD + i]);
  const float kt = to_f32(reinterpret_cast<const TR*>(in + L::K)[t * HD + i]);
  const float wt = reinterpret_cast<const float*>(in + L::W)[t * HD + i];
  float vv[kCPT], dd[kCPT], q[kCPT];
  load8s(vv, in + L::VF + (t * L::BC + me.c0) * 4);
  load8s(dd, in + L::DF + (t * L::BC + me.c0) * 4);
  // S_{t-1} dy_t, G_t v_t and G_t ⊙ S_{t-1} over the thread's columns, each
  // in two sums (even and odd columns) to halve the chain; G_tᵀ k_t's
  // terms; then G_{t-1}
  float a2[2] = {0.f, 0.f}, b2[2] = {0.f, 0.f}, d2[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < kCPT; ++x) {
    a2[x & 1] = fmaf(Hs[x], dd[x], a2[x & 1]);
    b2[x & 1] = fmaf(G[x], vv[x], b2[x & 1]);
    d2[x & 1] = fmaf(G[x], Hs[x], d2[x & 1]);
    q[x] = __fmul_rn(G[x], kt);
    G[x] = fmaf(wt, G[x], __fmul_rn(rt, dd[x]));
  }
  const float a = __fadd_rn(a2[0], a2[1]), bq = __fadd_rn(b2[0], b2[1]),
              d = __fadd_rn(d2[0], d2[1]);
  // a, b, d (and a zero) over the row's 2 lanes: lane 0 ends with a and b,
  // lane 1 with d.
  float r[4] = {a, bq, d, 0.f};
  rs_round<1, 2>(r, lane);
  const uint32_t at = me.at + t * C::NSRC * 3 * C::ROWS * 4;
  st_async(at, r[0], me.bar);
  if (me.cg == 0) st_async(at + C::ROWS * 4, r[1], me.bar);
  // dv's 8 column terms over the warp's 16 rows (lane bits 4 to 1): a
  // reduce-scatter over bits 4, 3, 2, then a sum across bit 1.
  rs_round<16, 4>(q, lane);
  rs_round<8, 2>(q, lane);
  rs_round<4, 1>(q, lane);
  const float qq = __fadd_rn(q[0], __shfl_xor_sync(kAll, q[0], 2));
  if (!(lane & 2)) me.q[t * C::NCW * kNC] = qq;
}

// The nh <= kHalf steps tb .. tb + nh - 1 of a chunk, from S, the state
// before step tb: their states into registers, then the walk back.  FULL
// (nh == kHalf) drops the bounds tests.
template <typename TR, int HD, bool FULL>
__device__ __forceinline__ void walk_half(float (&G)[kCPT], float (&S)[kCPT],
                                          const unsigned char* in, int tb,
                                          int nh, Me& me) {
  float Hs[kHalf][kCPT];
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
#pragma unroll
    for (int x = 0; x < kCPT; ++x) Hs[t][x] = S[x];
    if (t + 1 < kHalf && (FULL || t + 1 < nh))
      update<TR, HD>(S, in, tb + t, me);
  }
#pragma unroll
  for (int t = kHalf - 1; t >= 0; --t)
    if (FULL || t < nh) step<TR, HD>(G, Hs[t], in, tb + t, me);
}

// A chunk of n steps from its kept state at s0.  FULL (n == kCT) drops the
// bounds tests.
template <typename TR, int HD, bool FULL>
__device__ __forceinline__ void walk_chunk(float (&G)[kCPT],
                                           const unsigned char* s0,
                                           const unsigned char* in, int n,
                                           Me& me) {
  float S[kCPT];
  if (FULL || n > kHalf) {   // the second half first, from S after 8 steps
    load8s(S, s0);
#pragma unroll
    for (int t = 0; t < kHalf; ++t) update<TR, HD>(S, in, t, me);
    walk_half<TR, HD, FULL>(G, S, in, kHalf, n - kHalf, me);
  }
  load8s(S, s0);
  walk_half<TR, HD, FULL>(G, S, in, 0, min(n, kHalf), me);
}

template <typename TR, int HD>
__device__ __forceinline__ void run_consumer(const BwdParams& p,
                                             unsigned char* smem,
                                             const Blk& bk, int tid) {
  using C = Shape<TR, HD>;
  using L = InBuf<TR, HD>;
  using Y = Lay<TR, HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int ts = tid % (HD * kCG);   // thread within the slice
  Me me;
  me.sl = tid / (HD * kCG);
  me.i = ts / kCG;
  me.cg = ts % kCG;
  me.c0 = me.sl * kNC + kCPT * me.cg;
  me.lane = tid & 31;
  me.warp = tid >> 5;
  const long long g_off = (static_cast<long long>(bk.bh) * HD + me.i) * HD +
                          bk.rank * C::BC + me.c0;
  float G[kCPT];
#pragma unroll
  for (int x = 0; x < kCPT; ++x) G[x] = p.dsT ? p.dsT[g_off + x] : 0.f;
  const bool walk = !(p.skip & kSkipWalk);
  for (int m = 0; m < bk.nch; ++m) {
    const int t0 = (bk.nch - 1 - m) * kCT, n = min(kCT, p.T - t0);
    const int ib = m % C::NIN, pb = m % kPart;
    const unsigned char* in = smem + Y::IN + ib * L::BYTES;
    me.q = reinterpret_cast<float*>(smem + Y::Q + pb * Y::QB) +
           me.warp * kNC + kCPT * me.cg + (me.lane & 16 ? 4 : 0) +
           (me.lane & 8 ? 2 : 0) + (me.lane & 4 ? 1 : 0);
    const uint32_t owner = me.i / C::ROWS;
    // lane 0 of a row pushes a and b (slots 0, 1), lane 1 d (slot 2)
    me.at = mapa(smem_u32(smem + Y::P + pb * Y::PB) +
                     ((bk.rank * C::SPB + me.sl) * 3 + 2 * me.cg) * C::ROWS *
                         4 +
                     (me.i % C::ROWS) * 4,
                 owner);
    me.bar = mapa(smem_u32(&bars[Y::READY + pb]), owner);
    mbar_wait<false>(&bars[Y::FULL + ib], (m / C::NIN) & 1);
    // every block has read what this block pushed kPart chunks ago, and the
    // dv warp the column sums
    if (m >= kPart) mbar_wait<true>(&bars[Y::PFREE + pb], (m / kPart - 1) & 1);
    if (walk) {
      // the kept state S before the chunk's first step
      const unsigned char* s0 = in + L::ST + (me.i * C::BC + me.c0) * 4;
      if (n == kCT) {
        walk_chunk<TR, HD, true>(G, s0, in, n, me);
      } else {
        walk_chunk<TR, HD, false>(G, s0, in, n, me);
      }
    } else {   // the sums the epilogue counts on, as zeros
      for (int t = 0; t < n; ++t) {
        const uint32_t at = me.at + t * C::NSRC * 3 * C::ROWS * 4;
        st_async(at, 0.f, me.bar);
        if (me.cg == 0) st_async(at + C::ROWS * 4, 0.f, me.bar);
      }
    }
    // This warp's column sums of the chunk are in Q.
    __syncwarp();
    if (me.lane == 0) mbar_arrive(&bars[Y::QREADY + pb]);
  }
#pragma unroll
  for (int x = 0; x < kCPT; ++x) p.ds0[g_off + x] = G[x];
}

// ---------------------------------------------------------------- loader

// Completes a chunk of n steps once its rows are in: v and dy of the
// block's columns j0 .. in f32, and ru_t = Σ_i r_i u_i k_i and v_t · dy_t
// over the head.  Lane l sums elements 2 l, 2 l + 1, 2 l + 64, .. of all
// 16 steps, then a reduce-scatter over lane bits 4 to 1 (each round halves
// the steps a lane carries) and a sum across bit 0 leave step l / 2's sums
// in lane l.
template <typename TR, int HD>
__device__ __forceinline__ void finish(unsigned char* in, const float* u_s,
                                       int n, int j0, int lane) {
  using L = InBuf<TR, HD>;
  const TR* r = reinterpret_cast<const TR*>(in + L::R);
  const TR* k = reinterpret_cast<const TR*>(in + L::K);
  const TR* v = reinterpret_cast<const TR*>(in + L::V);
  const TR* dy = reinterpret_cast<const TR*>(in + L::DY);
  float* vf = reinterpret_cast<float*>(in + L::VF);
  float* df = reinterpret_cast<float*>(in + L::DF);
  for (int e = lane; e < n * L::BC / 2; e += 32) {
    const int t = e / (L::BC / 2), c = 2 * (e % (L::BC / 2));
    const float2 vv = load2(v + t * HD + j0 + c);
    const float2 dd = load2(dy + t * HD + j0 + c);
    *reinterpret_cast<float2*>(vf + t * L::BC + c) = vv;
    *reinterpret_cast<float2*>(df + t * L::BC + c) = dd;
  }
  float a[kCT], s[kCT];
#pragma unroll
  for (int t = 0; t < kCT; ++t) a[t] = s[t] = 0.f;
#pragma unroll
  for (int x0 = 0; x0 < HD; x0 += 64) {
    const int x = x0 + 2 * lane;
    if (x < HD) {
      const float2 ux = load2(u_s + x);
#pragma unroll
      for (int t = 0; t < kCT; ++t) {
        if (t < n) {
          const int o = t * HD + x;
          const float2 rr = load2(r + o), kk = load2(k + o);
          const float2 vv = load2(v + o), dd = load2(dy + o);
          a[t] = fmaf(rr.x, __fmul_rn(ux.x, kk.x), a[t]);
          a[t] = fmaf(rr.y, __fmul_rn(ux.y, kk.y), a[t]);
          s[t] = fmaf(vv.x, dd.x, s[t]);
          s[t] = fmaf(vv.y, dd.y, s[t]);
        }
      }
    }
  }
  rs_round<16, 8>(a, lane);
  rs_round<16, 8>(s, lane);
  rs_round<8, 4>(a, lane);
  rs_round<8, 4>(s, lane);
  rs_round<4, 2>(a, lane);
  rs_round<4, 2>(s, lane);
  rs_round<2, 1>(a, lane);
  rs_round<2, 1>(s, lane);
  a[0] = __fadd_rn(a[0], __shfl_xor_sync(kAll, a[0], 1));
  s[0] = __fadd_rn(s[0], __shfl_xor_sync(kAll, s[0], 1));
  if (!(lane & 1)) {
    reinterpret_cast<float*>(in + L::RU)[lane >> 1] = a[0];
    reinterpret_cast<float*>(in + L::VDY)[lane >> 1] = s[0];
  }
}

template <typename TR, int HD, bool ASYNC>
__device__ __forceinline__ void run_loader(const BwdParams& p,
                                           unsigned char* smem,
                                           const Blk& bk, int lane) {
  using C = Shape<TR, HD>;
  using L = InBuf<TR, HD>;
  using Y = Lay<TR, HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const float* u_s = reinterpret_cast<const float*>(smem + Y::U);
  const TR* rp = static_cast<const TR*>(p.r) + bk.b * p.r_sb + bk.h * p.r_sh;
  const TR* kp = static_cast<const TR*>(p.k) + bk.b * p.k_sb + bk.h * p.k_sh;
  const TR* vp = static_cast<const TR*>(p.v) + bk.b * p.v_sb + bk.h * p.v_sh;
  const TR* dyp = static_cast<const TR*>(p.dy) + bk.b * p.dy_sb +
                  bk.h * p.dy_sh;
  const float* wp = p.w + bk.b * p.w_sb + bk.h * p.w_sh;
  const float* sp = p.states +
                    static_cast<long long>(bk.bh) * bk.nch * HD * HD +
                    bk.rank * C::BC;

  // Copies chunk m's rows into its input buffer: cp.async arriving on the
  // buffer's landed barrier, or plain copies.
  auto stage = [&](int m) {
    const int c = bk.nch - 1 - m, t0 = c * kCT, n = min(kCT, p.T - t0);
    const int ib = m % C::NIN;
    unsigned char* in = smem + Y::IN + ib * L::BYTES;
    uint64_t* landed = &bars[Y::LANDED + ib];
    const float* st = sp + static_cast<long long>(c) * HD * HD;
    if constexpr (ASYNC) {
      const uint32_t d = smem_u32(in);
      copy_rows<L::kRow>(d + L::R, rp + t0 * p.r_st, p.r_st * sizeof(TR), n,
                         lane);
      copy_rows<L::kRow>(d + L::K, kp + t0 * p.k_st, p.k_st * sizeof(TR), n,
                         lane);
      copy_rows<L::kRow>(d + L::V, vp + t0 * p.v_st, p.v_st * sizeof(TR), n,
                         lane);
      copy_rows<L::kRow>(d + L::DY, dyp + t0 * p.dy_st,
                         p.dy_st * sizeof(TR), n, lane);
      copy_rows<HD * 4>(d + L::W, wp + t0 * p.w_st, p.w_st * 4, n, lane);
      copy_rows<C::BC * 4>(d + L::ST, st, HD * 4, HD, lane);
      cp_async_arrive(landed);
    } else {
      copy_rows_sync<TR, L::kRow>(reinterpret_cast<TR*>(in + L::R),
                                  rp + t0 * p.r_st, p.r_st, n, lane);
      copy_rows_sync<TR, L::kRow>(reinterpret_cast<TR*>(in + L::K),
                                  kp + t0 * p.k_st, p.k_st, n, lane);
      copy_rows_sync<TR, L::kRow>(reinterpret_cast<TR*>(in + L::V),
                                  vp + t0 * p.v_st, p.v_st, n, lane);
      copy_rows_sync<TR, L::kRow>(reinterpret_cast<TR*>(in + L::DY),
                                  dyp + t0 * p.dy_st, p.dy_st, n, lane);
      copy_rows_sync<float, HD * 4>(reinterpret_cast<float*>(in + L::W),
                                    wp + t0 * p.w_st, p.w_st, n, lane);
      copy_rows_sync<float, C::BC * 4>(reinterpret_cast<float*>(in + L::ST),
                                       st, HD, HD, lane);
      mbar_arrive(landed);
    }
  };

  for (int m = 0; m < min(C::NIN, bk.nch); ++m) stage(m);
  for (int m = 0; m < bk.nch; ++m) {
    const int ib = m % C::NIN;
    mbar_wait<false>(&bars[Y::LANDED + ib], (m / C::NIN) & 1);
    finish<TR, HD>(smem + Y::IN + ib * L::BYTES, u_s,
                   min(kCT, p.T - (bk.nch - 1 - m) * kCT), bk.rank * C::BC,
                   lane);
    mbar_arrive(&bars[Y::FULL + ib]);
    // restage chunk m - 1's buffer once the epilogue and dv warps are done
    // with it (the consumers are: those warps wait on them)
    const int old = m - 1;
    if (old >= 0 && old + C::NIN < bk.nch) {
      mbar_wait<false>(&bars[Y::EMPTY + old % C::NIN], (old / C::NIN) & 1);
      stage(old + C::NIN);
    }
  }
}

// -------------------------------------------------------------- epilogue

// dv of the block's columns, once every warp's column sums of a chunk are
// in: each slice's warps' sums in order, then ru_t dy_t.  Then the chunk's
// Q is free, and its input buffer as far as dv goes.
template <typename TR, int HD>
__device__ __forceinline__ void run_dv(const BwdParams& p, unsigned char* smem,
                                       const Blk& bk, int lane) {
  using C = Shape<TR, HD>;
  using L = InBuf<TR, HD>;
  using Y = Lay<TR, HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const long long o_st = static_cast<long long>(p.H) * HD;   // a step
  TR* dv0 = static_cast<TR*>(p.dv) +
            (static_cast<long long>(bk.b) * p.T * p.H + bk.h) * HD +
            bk.rank * C::BC;
  const bool walk = !(p.skip & kSkipWalk);
  for (int m = 0; m < bk.nch; ++m) {
    const int t0 = (bk.nch - 1 - m) * kCT, n = min(kCT, p.T - t0);
    const int ib = m % C::NIN, pb = m % kPart;
    const unsigned char* in = smem + Y::IN + ib * L::BYTES;
    const float* Q = reinterpret_cast<const float*>(smem + Y::Q + pb * Y::QB);
    const float* df = reinterpret_cast<const float*>(in + L::DF);
    const float* ru = reinterpret_cast<const float*>(in + L::RU);
    mbar_wait<false>(&bars[Y::QREADY + pb], (m / kPart) & 1);
    if (walk) {
      for (int e = lane; e < n * C::BC; e += 32) {
        const int t = e / C::BC, c = e % C::BC;
        const float* q =
            Q + (t * C::NCW + (c / kNC) * C::WPS) * kNC + c % kNC;
        float acc = q[0];
#pragma unroll
        for (int w = 1; w < C::WPS; ++w) acc = __fadd_rn(acc, q[w * kNC]);
        dv0[(t0 + t) * o_st + c] = from_f32<TR>(fmaf(ru[t], df[e], acc));
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&bars[Y::PFREE + pb]);
      mbar_arrive(&bars[Y::EMPTY + ib]);
    }
  }
}

// dr, dk and dw of the block's ROWS rows, once every slice of the head has
// pushed its sums of a chunk: lane (t, half) takes step t of each chunk and
// rows 8 half .. 8 half + 7 of each 16, adds the slices' sums in the order
// of their columns, then the u terms; du's sums stay in its registers
// across the walk and go to the scratch at the end.
template <typename TR, int HD>
__device__ __forceinline__ void run_epilogue(const BwdParams& p,
                                             unsigned char* smem,
                                             const Blk& bk, int lane) {
  using C = Shape<TR, HD>;
  using L = InBuf<TR, HD>;
  using Y = Lay<TR, HD>;
  constexpr int NR = C::ROWS / 2;   // rows a lane
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const float* u_s = reinterpret_cast<const float*>(smem + Y::U);
  const int tt = lane / 2, i0 = bk.rank * C::ROWS + 8 * (lane % 2);
  const long long o_st = static_cast<long long>(p.H) * HD;   // a step
  const long long o_b = (static_cast<long long>(bk.b) * p.T * p.H + bk.h) *
                        HD + i0;
  const bool exchange = !(p.skip & kSkipExchange);
  float du[NR];
#pragma unroll
  for (int z = 0; z < NR; ++z) du[z] = 0.f;
  for (int m = 0; m < bk.nch; ++m) {
    const int t0 = (bk.nch - 1 - m) * kCT, n = min(kCT, p.T - t0);
    const int ib = m % C::NIN, pb = m % kPart;
    const unsigned char* in = smem + Y::IN + ib * L::BYTES;
    if (lane == 0)
      mbar_expect_tx(&bars[Y::READY + pb], n * C::NSRC * 3 * C::ROWS * 4);
    mbar_wait<false>(&bars[Y::READY + pb], (m / kPart) & 1);
    if (exchange && tt < n) {
      const float* P =
          reinterpret_cast<const float*>(smem + Y::P + pb * Y::PB) +
          tt * C::NSRC * 3 * C::ROWS + (i0 - bk.rank * C::ROWS);
      const float vdy = reinterpret_cast<const float*>(in + L::VDY)[tt];
#pragma unroll
      for (int g = 0; g < C::ROWS / 16; ++g) {
        float a[8], bb[8], d[8];
#pragma unroll
        for (int src = 0; src < C::NSRC; ++src) {
          float f[3][8];
#pragma unroll
          for (int y = 0; y < 3; ++y)
            load8s(f[y], reinterpret_cast<const unsigned char*>(
                             P + (src * 3 + y) * C::ROWS + 16 * g));
#pragma unroll
          for (int z = 0; z < 8; ++z) {
            a[z] = src ? __fadd_rn(a[z], f[0][z]) : f[0][z];
            bb[z] = src ? __fadd_rn(bb[z], f[1][z]) : f[1][z];
            d[z] = src ? __fadd_rn(d[z], f[2][z]) : f[2][z];
          }
        }
        // the u terms: dr += u ⊙ k (v · dy), dk += u ⊙ r (v · dy)
        float rr[8], kk[8], uu[8];
        load8(rr, reinterpret_cast<const TR*>(in + L::R) + tt * HD + i0 +
                      16 * g);
        load8(kk, reinterpret_cast<const TR*>(in + L::K) + tt * HD + i0 +
                      16 * g);
        load8s(uu, reinterpret_cast<const unsigned char*>(u_s + i0 + 16 * g));
#pragma unroll
        for (int z = 0; z < 8; ++z) {
          a[z] = fmaf(__fmul_rn(uu[z], kk[z]), vdy, a[z]);
          bb[z] = fmaf(__fmul_rn(uu[z], rr[z]), vdy, bb[z]);
          du[8 * g + z] = fmaf(__fmul_rn(rr[z], kk[z]), vdy, du[8 * g + z]);
        }
        const long long o = o_b + (t0 + tt) * o_st + 16 * g;
        store8(static_cast<TR*>(p.dr) + o, a);
        store8(static_cast<TR*>(p.dk) + o, bb);
        store8(p.dw + o, d);
      }
    }
    // Done with this chunk's sums and its input buffer: every block may push
    // the next ones.  (The arrival waits for the stores above, which this
    // warp has time for: the consumers need it kPart - 1 chunks later.)
    __syncwarp();
    if (lane < C::NCL) mbar_arrive_at(&bars[Y::PFREE + pb], lane);
    if (lane == 0) mbar_arrive(&bars[Y::EMPTY + ib]);
  }
  // du of the lane's rows over the 16 lanes that hold them, in a fixed order
#pragma unroll
  for (int z = 0; z < NR; ++z)
#pragma unroll
    for (int o = 2; o < 32; o <<= 1)
      du[z] = __fadd_rn(du[z], __shfl_xor_sync(kAll, du[z], o));
  if (lane < 2) {
#pragma unroll
    for (int g = 0; g < C::ROWS / 16; ++g)
#pragma unroll
      for (int z = 0; z < 8; ++z)
        p.scratch[static_cast<long long>(bk.bh) * HD + i0 + 16 * g + z] =
            du[8 * g + z];
  }
}

// ---------------------------------------------------------------- kernel

// Block: columns BC rank .. of head (b, h), rank its place in the head's
// cluster.  Warps 0 .. NCW - 1 consume, warp NCW loads, warp NCW + 1 writes
// dr, dk and dw, warp NCW + 2 dv.
template <typename TR, int HD, bool ASYNC>
__global__ void __launch_bounds__(Shape<TR, HD>::NT, Shape<TR, HD>::MINB)
    wkv6_bwd_kernel(const BwdParams p) {
  using C = Shape<TR, HD>;
  using Y = Lay<TR, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* u_s = reinterpret_cast<float*>(smem + Y::U);
  Blk bk;
  bk.rank = int(cluster_rank());
  bk.bh = blockIdx.x / C::NCL;
  bk.b = bk.bh / p.H;
  bk.h = bk.bh % p.H;
  bk.nch = (p.T + kCT - 1) / kCT;

  const int tid = threadIdx.x, warp = tid >> 5;
  for (int e = tid; e < HD; e += C::NT) u_s[e] = p.u[bk.h * HD + e];
  if (tid == 0) {
    for (int x = 0; x < C::NIN; ++x) {
      mbar_init(&bars[Y::LANDED + x], 32);
      mbar_init(&bars[Y::FULL + x], 32);
      mbar_init(&bars[Y::EMPTY + x], 2);
    }
    for (int x = 0; x < kPart; ++x) {
      mbar_init(&bars[Y::READY + x], 1);
      mbar_init(&bars[Y::QREADY + x], C::NCW);
      mbar_init(&bars[Y::PFREE + x], C::NCL + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every block's barriers are set up, u is in

  if (warp < C::NCW) {
    run_consumer<TR, HD>(p, smem, bk, tid);
  } else if (warp == C::NCW) {
    run_loader<TR, HD, ASYNC>(p, smem, bk, tid & 31);
  } else if (warp == C::NCW + 1) {
    run_epilogue<TR, HD>(p, smem, bk, tid & 31);
  } else {
    run_dv<TR, HD>(p, smem, bk, tid & 31);
  }
  cluster_sync();   // no block leaves while another may read its memory
}

// du (H, hd): the blocks' sums over batch, in order.
__global__ void wkv6_bwd_du_kernel(const BwdParams p, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // h hd + i
  if (e >= p.H * hd) return;
  const long long bstride = static_cast<long long>(p.H) * hd;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    acc = __fadd_rn(acc, p.scratch[b * bstride + e]);
  p.du[e] = acc;
}

template <typename TR, int HD, bool ASYNC>
int launch(const BwdParams& p, cudaStream_t stream) {
  using C = Shape<TR, HD>;
  constexpr size_t smem = Lay<TR, HD>::BYTES;
  auto* kernel = wkv6_bwd_kernel<TR, HD, ASYNC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.H * C::NCL);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::NCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return int(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  wkv6_bwd_du_kernel<<<(p.H * HD + 255) / 256, 256, 0, stream>>>(p, HD);
  return int(cudaGetLastError());
}

// cp.async needs 16-byte aligned sources: the base and the stride of every
// dimension longer than 1.
bool aligned16(const void* ptr, int esz, const BwdParams& p, long long sb,
               long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (p.B == 1 || sb * esz % 16 == 0) &&
         (p.T == 1 || st * esz % 16 == 0) && (p.H == 1 || sh * esz % 16 == 0);
}

bool uses_ring(const BwdParams& p, int esz) {
  return aligned16(p.r, esz, p, p.r_sb, p.r_st, p.r_sh) &&
         aligned16(p.k, esz, p, p.k_sb, p.k_st, p.k_sh) &&
         aligned16(p.v, esz, p, p.v_sb, p.v_st, p.v_sh) &&
         aligned16(p.dy, esz, p, p.dy_sb, p.dy_st, p.dy_sh) &&
         aligned16(p.w, 4, p, p.w_sb, p.w_st, p.w_sh) &&
         reinterpret_cast<uintptr_t>(p.states) % 16 == 0;
}

template <typename TR, int HD>
int launch_hd(const BwdParams& p, cudaStream_t stream) {
  return uses_ring(p, sizeof(TR)) ? launch<TR, HD, true>(p, stream)
                                  : launch<TR, HD, false>(p, stream);
}

template <typename TR>
int dispatch(const BwdParams& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<TR, 16>(p, stream);
    case 64: return launch_hd<TR, 64>(p, stream);
    case 128: return launch_hd<TR, 128>(p, stream);
    default: return -1;
  }
}

int run(const BwdParams& p, int rkv_dtype, int hd, void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == 0) return dispatch<float>(p, hd, s);
  if (rkv_dtype == 1) return dispatch<__nv_bfloat16>(p, hd, s);
  return -1;
}

}  // namespace

#define WKV6_BWD_ARGS                                                        \
  const void *r, const void *k, const void *v, const void *w, const void *u, \
      const void *states, const void *dy, const void *dsT, void *dr,         \
      void *dk, void *dv, void *dw, void *du, void *ds0, void *scratch,      \
      int rkv_dtype, int B, int T, int H, int hd, long long r_sb,            \
      long long r_st, long long r_sh, long long k_sb, long long k_st,        \
      long long k_sh, long long v_sb, long long v_st, long long v_sh,        \
      long long w_sb, long long w_st, long long w_sh, long long dy_sb,       \
      long long dy_st, long long dy_sh, void *stream

#define WKV6_BWD_PARAMS(skip)                                                \
  BwdParams {                                                                \
    r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),     \
        static_cast<const float*>(states), dy,                               \
        static_cast<const float*>(dsT), dr, dk, dv, static_cast<float*>(dw), \
        static_cast<float*>(du), static_cast<float*>(ds0),                   \
        static_cast<float*>(scratch), B, T, H, r_sb, r_st, r_sh, k_sb, k_st, \
        k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh, dy_sb, dy_st, dy_sh, skip  \
  }

extern "C" {

// Floats of scratch wkv6_bwd needs at these sizes: du's sums, B H hd.
long long wkv6_bwd_scratch_floats(int B, int T, int H, int hd) {
  (void)T;
  return static_cast<long long>(B) * H * hd;
}

// Type code rkv_dtype for r, k, v, dy, dr, dk and dv: 0 = float32, 1 =
// bfloat16.  r, k, v, w and dy are (B, T, H, hd) with the strides given
// (the last one 1); w is float32; u (H, hd), states (B, H, ceil(T / 16),
// hd, hd) from wkv6_fwd, dsT (B, H, hd, hd) or null, and the outputs dr,
// dk, dv, dw (B, T, H, hd), du (H, hd) and ds0 (B, H, hd, hd) are
// contiguous, dw, du and ds0 float32; scratch holds
// wkv6_bwd_scratch_floats floats.  Two launches on `stream` (the first a
// cluster launch), no synchronization.  Returns 0, a cudaError_t, or -1 for
// an unsupported head dim or type.
int wkv6_bwd(WKV6_BWD_ARGS) {
  return run(WKV6_BWD_PARAMS(0), rkv_dtype, hd, stream);
}

// wkv6_bwd with parts of its first kernel left out, to time the others:
// skip 1 leaves out the consumers' recompute and walk, 2 the epilogue's sums
// and stores (every barrier is still passed).  The outputs are not the
// gradients.
int wkv6_bwd_skipping(WKV6_BWD_ARGS, int skip) {
  return run(WKV6_BWD_PARAMS(skip), rkv_dtype, hd, stream);
}

// With wkv6_bwd's arguments: 1 if that call stages time by cp.async, 0 if
// it takes the kernel with plain copies (an input not 16-byte aligned).
// Launches nothing.
int wkv6_bwd_uses_ring(WKV6_BWD_ARGS) {
  return uses_ring(WKV6_BWD_PARAMS(0), rkv_dtype == 1 ? 2 : 4);
}

const char* wkv6_bwd_error_string(int code) {
  return code < 0 ? "unsupported head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
