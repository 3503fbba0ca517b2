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
// Design.  Column j of S and of G evolves on its own, as in the forward, so
// a block owns kNC = 16 columns of one head and there are B * H * hd / 16
// blocks (512 at rwkv6_1_6b's training shape, B=4, H=32, hd=64).  A thread
// owns one row i and kCPT = 4 adjacent columns: its 4 elements of G stay in
// registers for the whole walk.  Time goes in chunks of kCT = 16 steps,
// the forward's chunk, last chunk first.  For each chunk the block stages
// r, k, w (hd wide) and its columns of v and dy in shared memory as
// float32, reloads the chunk's first state from the forward's saved states
// and recomputes S_{t-1} for the chunk's 16 steps into registers (64 a
// thread; the forward's own arithmetic, so bitwise its states), then walks
// back through the chunk.  Sums over the block's columns (the parts of dr,
// dk and dw that need S or G) go over the 4 threads of a row by shuffles;
// dv's sum over rows goes over the 8 rows of a warp by shuffles and over
// the warps in shared memory.  dv is complete within the block and is
// written by it; dr, dk and dw are partial sums over its 16 columns, and go
// with each column slice's v · dy to a float32 scratch.  A second kernel
// adds the hd / 16 slices' partial sums in slice order and the u terms,
// and writes dr, dk and dw and partial sums of du over 64 steps; a third
// adds those over batch and steps.  No atomics: every sum has a fixed
// order, so two runs are bitwise equal.
//
// What bounds it: about 13 float32 operations per state element, token and
// head (the recompute's w S + k v, then S dy, G v, G ⊙ S, G k and w G + r
// dy), 6.98 GFLOP at the training shape, 0.104 ms at 67 TFLOP/s, against
// about 320 MB of operands and saved states (0.096 ms at 3.35 TB/s).  This
// kernel is simple rather than fast: a step costs a thread 18 shuffles for
// 4 elements, and the 3 x (hd / 16) partial planes of dr, dk and dw make
// about 0.8 GB of scratch traffic at that shape.  chip_smoke.py prints its
// time beside the bound; PERF.md keeps it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCT = 16;          // steps a chunk; the forward saves S each
constexpr int kCPT = 4;          // columns a thread
constexpr int kCG = 4;           // threads a row
constexpr int kNC = kCPT * kCG;  // columns a block
constexpr int kRowsT = 64;       // steps a block of the row kernel
constexpr int kRowsNT = 256;     // threads a block of the row kernel

template <int HD>
struct BShape {
  static constexpr int NT = HD * kCG;    // threads
  static constexpr int NW = NT / 32;     // warps, 32 / kCG rows each
  static constexpr int SLICES = HD / kNC;
  static_assert(NT % 32 == 0 && HD % kNC == 0 && kCPT == 4, "block shape");
};

// A block's shared memory: the chunk's inputs in float32, u, ru_t, and the
// chunk's sums by row (a, b, d: the S dy, G v and G ⊙ S parts of dr, dk and
// dw over the block's columns) and by warp (q: dv's G k part over the
// warp's rows).
template <int HD>
struct BSmem {
  float r[kCT][HD], k[kCT][HD], w[kCT][HD];
  float u[HD];
  float v[kCT][kNC], dy[kCT][kNC];
  float ru[kCT];
  float a[kCT][HD], b[kCT][HD], d[kCT][HD];
  float q[kCT][BShape<HD>::NW][kNC];
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
  float* scratch;        // scratch_floats(B, T, H, hd)
  int B, T, H;
  long long r_sb, r_st, r_sh;   // element strides of (B, T, H, hd); d is 1
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long dy_sb, dy_st, dy_sh;
};

// The float32 scratch: the partial planes A, B, D of dr, dk and dw, each
// [slice][b h][t][i] (a slice's plane is B H T hd), then E, v · dy over a
// slice's columns, [slice][b h][t], then du's partial sums [b h][64-step
// tile][i].
inline long long scratch_floats(int B, int T, int H, int hd) {
  const long long BH = static_cast<long long>(B) * H;
  const int slices = hd / kNC, ntiles = (T + kRowsT - 1) / kRowsT;
  return slices * BH * T * (3LL * hd + 1) + BH * ntiles * hd;
}

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

__device__ __forceinline__ void unpack(float (&d)[4], float4 x) {
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

// Block: columns j0 .. j0 + kNC - 1 of head (b, h).  Thread tid owns row
// i = tid / kCG and columns j0 + kCPT * cg .. (cg = tid % kCG): the kCG
// threads of a row are adjacent lanes, a warp holds 32 / kCG rows.
template <typename TR, int HD>
__global__ void __launch_bounds__(BShape<HD>::NT)
    wkv6_bwd_state_kernel(const BwdParams p) {
  using C = BShape<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BSmem<HD>& sm = *reinterpret_cast<BSmem<HD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kCG, cg = tid % kCG;
  const int bh = blockIdx.x / C::SLICES, slice = blockIdx.x % C::SLICES;
  const int j0 = slice * kNC;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T, nchunks = (T + kCT - 1) / kCT;
  const long long BH = static_cast<long long>(p.B) * p.H;

  const TR* r = static_cast<const TR*>(p.r) + b * p.r_sb + h * p.r_sh;
  const TR* k = static_cast<const TR*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TR* v = static_cast<const TR*>(p.v) + b * p.v_sb + h * p.v_sh + j0;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const TR* dy = static_cast<const TR*>(p.dy) + b * p.dy_sb + h * p.dy_sh
                 + j0;
  TR* dv = static_cast<TR*>(p.dv) +
           (static_cast<long long>(b) * T * p.H + h) * HD + j0;
  const long long dv_st = static_cast<long long>(p.H) * HD;
  const long long plane = BH * T * HD;
  float* Ag = p.scratch + (slice * BH + bh) * T * HD;
  float* Bg = Ag + C::SLICES * plane;
  float* Dg = Bg + C::SLICES * plane;
  float* Eg = p.scratch + 3 * C::SLICES * plane + (slice * BH + bh) * T;

  for (int e = tid; e < HD; e += C::NT) sm.u[e] = p.u[h * HD + e];

  // G_T for this thread's row and columns.
  const long long g_off =
      (static_cast<long long>(bh) * HD + i) * HD + j0 + kCPT * cg;
  float G[kCPT];
#pragma unroll
  for (int x = 0; x < kCPT; ++x) G[x] = p.dsT ? p.dsT[g_off + x] : 0.f;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kCT, n = min(kCT, T - t0);
    __syncthreads();   // the previous chunk is done with shared memory
    for (int e = tid; e < n * HD; e += C::NT) {
      const long long t = t0 + e / HD;
      const int x = e % HD;
      sm.r[e / HD][x] = to_f32(r[t * p.r_st + x]);
      sm.k[e / HD][x] = to_f32(k[t * p.k_st + x]);
      sm.w[e / HD][x] = w[t * p.w_st + x];
    }
    for (int e = tid; e < n * kNC; e += C::NT) {
      const long long t = t0 + e / kNC;
      const int x = e % kNC;
      sm.v[e / kNC][x] = to_f32(v[t * p.v_st + x]);
      sm.dy[e / kNC][x] = to_f32(dy[t * p.dy_st + x]);
    }
    __syncthreads();
    if (tid < n) {   // ru_t = Σ_i r_i u_i k_i, in row order
      float acc = 0.f;
      for (int x = 0; x < HD; ++x)
        acc = fmaf(sm.r[tid][x], __fmul_rn(sm.u[x], sm.k[tid][x]), acc);
      sm.ru[tid] = acc;
    }

    // S_{t-1} for the chunk's steps, from its saved first state, as the
    // forward computes it: S <- w S + k v.
    float Hs[kCT][kCPT];
    {
      const float4 s4 = *reinterpret_cast<const float4*>(
          p.states + (static_cast<long long>(bh) * nchunks + c) * HD * HD +
          i * HD + j0 + kCPT * cg);
      float S[kCPT];
      unpack(S, s4);
#pragma unroll
      for (int t = 0; t < kCT; ++t) {
#pragma unroll
        for (int x = 0; x < kCPT; ++x) Hs[t][x] = S[x];
        if (t + 1 < n) {
          const float wt = sm.w[t][i], kt = sm.k[t][i];
          float vv[kCPT];
          unpack(vv, *reinterpret_cast<const float4*>(&sm.v[t][kCPT * cg]));
#pragma unroll
          for (int x = 0; x < kCPT; ++x)
            S[x] = fmaf(wt, S[x], __fmul_rn(kt, vv[x]));
        }
      }
    }

    // Back through the chunk.
#pragma unroll
    for (int t = kCT - 1; t >= 0; --t) {
      if (t < n) {
        const float rt = sm.r[t][i], kt = sm.k[t][i], wt = sm.w[t][i];
        float vv[kCPT], dd[kCPT], q[kCPT];
        unpack(vv, *reinterpret_cast<const float4*>(&sm.v[t][kCPT * cg]));
        unpack(dd, *reinterpret_cast<const float4*>(&sm.dy[t][kCPT * cg]));
        float a = 0.f, bq = 0.f, d = 0.f;
#pragma unroll
        for (int x = 0; x < kCPT; ++x) {
          a = fmaf(Hs[t][x], dd[x], a);      // S_{t-1} dy_t
          bq = fmaf(G[x], vv[x], bq);        // G_t v_t
          d = fmaf(G[x], Hs[t][x], d);       // G_t ⊙ S_{t-1}
          q[x] = __fmul_rn(G[x], kt);        // G_tᵀ k_t, this row's term
          G[x] = fmaf(wt, G[x], __fmul_rn(rt, dd[x]));   // G_{t-1}
        }
#pragma unroll
        for (int o = 1; o < kCG; o <<= 1) {
          a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
          bq = __fadd_rn(bq, __shfl_xor_sync(0xffffffffu, bq, o));
          d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, o));
        }
        if (cg == 0) {
          sm.a[t][i] = a;
          sm.b[t][i] = bq;
          sm.d[t][i] = d;
        }
#pragma unroll
        for (int o = kCG; o < 32; o <<= 1)
#pragma unroll
          for (int x = 0; x < kCPT; ++x)
            q[x] = __fadd_rn(q[x], __shfl_xor_sync(0xffffffffu, q[x], o));
        if (lane < kCG)
          *reinterpret_cast<float4*>(&sm.q[t][warp][kCPT * lane]) =
              make_float4(q[0], q[1], q[2], q[3]);
      }
    }
    __syncthreads();

    // The chunk's sums out: row partials to the scratch, dv whole.
    for (int e = tid; e < n * HD; e += C::NT) {
      const long long o = static_cast<long long>(t0) * HD + e;
      Ag[o] = sm.a[e / HD][e % HD];
      Bg[o] = sm.b[e / HD][e % HD];
      Dg[o] = sm.d[e / HD][e % HD];
    }
    for (int e = tid; e < n * kNC; e += C::NT) {
      const int t = e / kNC, x = e % kNC;
      float acc = sm.q[t][0][x];
      for (int wi = 1; wi < C::NW; ++wi) acc = __fadd_rn(acc, sm.q[t][wi][x]);
      dv[(t0 + t) * dv_st + x] = from_f32<TR>(fmaf(sm.ru[t], sm.dy[t][x], acc));
    }
    if (tid < n) {
      float acc = 0.f;
      for (int x = 0; x < kNC; ++x) acc = fmaf(sm.v[tid][x], sm.dy[tid][x], acc);
      Eg[t0 + tid] = acc;
    }
  }
#pragma unroll
  for (int x = 0; x < kCPT; ++x) p.ds0[g_off + x] = G[x];
}

// dr, dk and dw of kRowsT steps of one head: the slices' partial sums in
// slice order, then the u terms; and the tile's partial sums of du.  Block
// (b h, tile); thread (i, ty) takes steps ty, ty + kRowsNT / hd, ...
template <typename TR>
__global__ void __launch_bounds__(kRowsNT, 1)
    wkv6_bwd_rows_kernel(const BwdParams p, int hd) {
  const int T = p.T, ntiles = (T + kRowsT - 1) / kRowsT;
  const int bh = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const int b = bh / p.H, h = bh % p.H;
  const int i = threadIdx.x % hd, ty = threadIdx.x / hd;
  const int TY = kRowsNT / hd, slices = hd / kNC;
  const long long BH = static_cast<long long>(p.B) * p.H;
  const long long plane = BH * T * hd;   // a slice's partial plane
  // slice 0's partial sums of this head and row; slice sl at + sl plane
  const float* A = p.scratch + static_cast<long long>(bh) * T * hd + i;
  const float* Bp = A + slices * plane;
  const float* D = Bp + slices * plane;
  const float* E = p.scratch + 3 * slices * plane +
                   static_cast<long long>(bh) * T;   // slice sl at + sl BH T
  float* duP = p.scratch + 3 * slices * plane + slices * BH * T;
  const float ui = p.u[h * hd + i];
  const TR* r = static_cast<const TR*>(p.r) + b * p.r_sb + h * p.r_sh + i;
  const TR* k = static_cast<const TR*>(p.k) + b * p.k_sb + h * p.k_sh + i;
  const long long o0 = (static_cast<long long>(b) * T * p.H + h) * hd + i;
  const long long o_st = static_cast<long long>(p.H) * hd;
  float du = 0.f;
  const int t_end = min(T, (tile + 1) * kRowsT);
  for (int t = tile * kRowsT + ty; t < t_end; t += TY) {
    float vdy = 0.f, a = 0.f, bb = 0.f, d = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const long long at = sl * plane + static_cast<long long>(t) * hd;
      vdy = __fadd_rn(vdy, E[sl * BH * T + t]);
      a = __fadd_rn(a, A[at]);
      bb = __fadd_rn(bb, Bp[at]);
      d = __fadd_rn(d, D[at]);
    }
    const float rr = to_f32(r[t * p.r_st]), kk = to_f32(k[t * p.k_st]);
    const long long o = o0 + t * o_st;
    static_cast<TR*>(p.dr)[o] = from_f32<TR>(fmaf(__fmul_rn(ui, kk), vdy, a));
    static_cast<TR*>(p.dk)[o] = from_f32<TR>(fmaf(__fmul_rn(ui, rr), vdy, bb));
    p.dw[o] = d;
    du = fmaf(__fmul_rn(rr, kk), vdy, du);
  }
  __shared__ float red[kRowsNT];
  red[threadIdx.x] = du;
  __syncthreads();
  if (ty == 0) {
    float acc = red[i];
    for (int y = 1; y < TY; ++y) acc = __fadd_rn(acc, red[y * hd + i]);
    duP[(static_cast<long long>(bh) * ntiles + tile) * hd + i] = acc;
  }
}

// du (H, hd): the row kernel's partial sums over batch and tiles, in order.
__global__ void wkv6_bwd_du_kernel(const BwdParams p, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // h hd + i
  if (e >= p.H * hd) return;
  const int h = e / hd, i = e % hd, T = p.T;
  const int slices = hd / kNC, ntiles = (T + kRowsT - 1) / kRowsT;
  const long long BH = static_cast<long long>(p.B) * p.H;
  const float* duP = p.scratch + slices * BH * T * (3LL * hd + 1);
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int tile = 0; tile < ntiles; ++tile)
      acc = __fadd_rn(acc, duP[((static_cast<long long>(b) * p.H + h) *
                                ntiles + tile) * hd + i]);
  p.du[e] = acc;
}

template <typename TR, int HD>
int launch(const BwdParams& p, cudaStream_t stream) {
  using C = BShape<HD>;
  constexpr size_t smem = sizeof(BSmem<HD>);
  auto* kernel = wkv6_bwd_state_kernel<TR, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<p.B * p.H * C::SLICES, C::NT, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int ntiles = (p.T + kRowsT - 1) / kRowsT;
  if (ntiles > 0) {
    wkv6_bwd_rows_kernel<TR><<<p.B * p.H * ntiles, kRowsNT, 0, stream>>>(
        p, HD);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  wkv6_bwd_du_kernel<<<(p.H * HD + 255) / 256, 256, 0, stream>>>(p, HD);
  return int(cudaGetLastError());
}

template <typename TR>
int dispatch(const BwdParams& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<TR, 16>(p, stream);
    case 64: return launch<TR, 64>(p, stream);
    case 128: return launch<TR, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Floats of scratch wkv6_bwd needs at these sizes.
long long wkv6_bwd_scratch_floats(int B, int T, int H, int hd) {
  return scratch_floats(B, T, H, hd);
}

// Type code rkv_dtype for r, k, v, dy, dr, dk and dv: 0 = float32, 1 =
// bfloat16.  r, k, v, w and dy are (B, T, H, hd) with the strides given
// (the last one 1); w is float32; u (H, hd), states (B, H, ceil(T / 16),
// hd, hd) from wkv6_fwd, dsT (B, H, hd, hd) or null, and the outputs dr,
// dk, dv, dw (B, T, H, hd), du (H, hd) and ds0 (B, H, hd, hd) are
// contiguous, dw, du and ds0 float32; scratch holds
// wkv6_bwd_scratch_floats floats.  Three launches on `stream`, no
// synchronization.  Returns 0, a cudaError_t, or -1 for an unsupported
// head dim or type.
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* states, const void* dy,
             const void* dsT, void* dr, void* dk, void* dv, void* dw,
             void* du, void* ds0, void* scratch, int rkv_dtype, int B, int T,
             int H, int hd, long long r_sb, long long r_st, long long r_sh,
             long long k_sb, long long k_st, long long k_sh, long long v_sb,
             long long v_st, long long v_sh, long long w_sb, long long w_st,
             long long w_sh, long long dy_sb, long long dy_st,
             long long dy_sh, void* stream) {
  cudaGetLastError();   // clear an unrelated earlier error of this thread
  const BwdParams p{
      r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(states), dy, static_cast<const float*>(dsT),
      dr, dk, dv, static_cast<float*>(dw), static_cast<float*>(du),
      static_cast<float*>(ds0), static_cast<float*>(scratch), B, T, H,
      r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh,
      dy_sb, dy_st, dy_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == 0) return dispatch<float>(p, hd, s);
  if (rkv_dtype == 1) return dispatch<__nv_bfloat16>(p, hd, s);
  return -1;
}

const char* wkv6_bwd_error_string(int code) {
  return code < 0 ? "unsupported head dim or dtype"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
