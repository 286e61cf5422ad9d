// RWKV-6 WKV for Hopper (sm_90a): the time-mix recurrence with data-dependent
// per-channel decay, chunk-parallel, returning the output and the final state.
//
// Per (batch, head), with the (hs, hs) f32 state S (k-major) from zero:
//     o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(exp(w_log_t)) S + k_t v_t^T.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_kernel.py:_rwkv6_kernel
// (reached through rwkv6_wkv).
//
// Chunked form, chunk C = 64, as the TPU kernel.  With e_t = exp(w_log_t)
// (per channel) and S_c the state entering chunk c,
//     o_t     = (r_t * prod_{tau<t} e_tau) S_c                          [inter-chunk]
//             + sum_{s<t} (sum_c r_tc k_sc prod_{s<tau<t} e_tau,c) v_s  [intra, pairwise]
//             + (r_t . (u * k_t)) v_t                                  [bonus diagonal]
//     S_{c+1} = diag(DT_c) S_c + dS_c,  DT_c = prod_{tau<n} e_tau,
//     dS_c    = (k * prod_{s<tau<n} e_tau)^T v,
// n = rows in the chunk.  Every decay factor is a running product of
// per-step decays, as the sequential recurrence applies them: each factor is
// in (0, 1], so nothing overflows however strong the decay, and there is no
// cancellation.  The TPU kernel takes the pairwise decays as
// exp(lp_prev[t] - lp[s]) from chunk-local prefix sums of w_log, which loses
// digits once a strong decay has made the sums large: at per-step decays of
// exp(-exp(N(0, 3))), as strong as the random-weight models', it is 2.4e-4
// off the exact recurrence (tests/test_torch_recurrent_kernels.py), this
// kernel ~3e-7 (chip_smoke.py); the centred two-factor form of the JAX
// package's wkv_chunked overflows instead.
//
// The pairwise decays are split at 8-row sub-chunks.  For t in sub-chunk i
// and s in an earlier sub-chunk j, prod_{s<tau<t} = PE[s] * G_ji * PB[t]:
// the decay from s to the end of its sub-chunk, over the whole sub-chunks in
// between, and from the start of t's sub-chunk to t, each a running product
// in (0, 1].  So those entries of A are sums over c of (r PB)[t] (k PE)[s]
// G_ji, products of bounded factors, and only the pairs inside one sub-chunk
// walk their decays step by step (at most 7 steps).
//
// What bounds it on the H100: at rwkv6-7b's prefill (B=1, H=64, S=3000,
// hs=64) the inputs and outputs are ~173 MB, ~0.05 ms at 3.35 TB/s, while the
// ~4 GFLOP of f32 arithmetic run on the CUDA cores in full f32 (the
// reference's tolerance is relative 1e-5, which TF32 tensor cores would not
// meet).  A walk over the chunks in order per (batch, head) leaves the card
// idle (B*H = 64 blocks for 132 SMs, a serial chain of 47 chunks), so the
// chunks are computed in parallel, in three launches:
//
//   1. wkv_chunk_state, one block per (b, h, chunk): DT_c and dS_c, written
//      to f32 scratch (B,H,nc,hs,hs) and (B,H,nc,hs) that the wrapper
//      allocates.
//   2. wkv_state_scan, one thread per entry of a (b, h) state: the chain
//      S_{c+1} = DT_c S_c + dS_c over the chunks, overwriting dS_c with S_c
//      in place, and the last state to `state`.  Memory-bound: the scratch
//      is read once and written once.
//   3. wkv_chunk_out, one block per (b, h, chunk): the chunk's pairwise
//      matrix A and o = RD S_c + A V, written through the strides.
//
// No atomics: every sum has a fixed order, so two runs give the same bits.
// The products (dS_c, the cross-sub-chunk blocks of A, [RD A] [S_c; V])
// give each thread a 4 x 4 register tile fed by 16-byte loads of
// shared-memory rows (Q, RD and A are stored transposed for that), a warp
// covering 4 x 8 tiles so that each operand row is one shared-memory
// wavefront; the walks batch their loads ahead of their stores.  What is
// left bounds the design: shared-memory bandwidth in pass 3, and ~460 MB of
// device-memory traffic over the three passes (w, k and v are read twice,
// the scratch written, read, rewritten and read), ~0.14 ms at 3.35 TB/s.
// Shared memory of pass 3 is ~111 KB at hs = 64 (S_c and V take the place
// of r, k and the decays once the walks are done), so two blocks share an
// SM and one block's serial decay walks overlap the other's products.  The
// ragged last chunk is handled by bounds (its missing rows read as
// k = v = r = 0, w_log = 0, which leave the state as it was), not by a
// padded copy.
//
// Layouts: r, k, v (bf16 or f32) and w_log (f32) addressed as (B,H,S,hs) by
// (batch, head, row) strides in elements with hs contiguous, so the model's
// (B,S,H,hs) activations are read in place; u (H,hs) f32 contiguous; o
// (B,H,S,hs) f32 by strides; state (B,H,hs,hs) f32 contiguous.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // chunk length
constexpr int SC = 8;          // sub-chunk length
constexpr int NSC = C / SC;    // sub-chunks per chunk
constexpr int NP = NSC * (NSC - 1) / 2;   // sub-chunk pairs (i, j), j < i
static_assert(SC == 8, "the decay walks take one sub-chunk as a batch of 8 rows");
constexpr int NT = 256;        // threads of a chunk block

struct Args {
  const void* r; const void* k; const void* v; const float* w; const float* u;
  float* o; float* state;
  float* ds;   // (B,H,nc,hs,hs) scratch: dS_c from pass 1, S_c after pass 2
  float* dt;   // (B,H,nc,hs) scratch: DT_c
  int B, H, S, nc;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, w_sb, w_sh, w_ss,
      o_sb, o_sh, o_ss;
};

// 16-byte vectors of one chunk of an (S, HS) operand that each thread loads
// (at hs = 16 in bf16 a chunk is 128 vectors: half the threads load one)
template <typename T, int HS>
struct Vec {
  static constexpr int PER_ROW = HS * (int)sizeof(T) / 16;
  static constexpr int VECS = C * PER_ROW;
  static constexpr int PER_THREAD = (VECS + NT - 1) / NT;
  static constexpr int ELEMS = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The rows [c0, c0 + n) of one (S, HS) operand (row stride ss elements) as
// 16-byte vectors in registers, zeros past row n.
template <typename T, int HS>
__device__ __forceinline__ void fetch_chunk(uint4 (&x)[Vec<T, HS>::PER_THREAD], const T* p,
                                            long long ss, int c0, int n, int tid) {
  using VT = Vec<T, HS>;
#pragma unroll
  for (int u = 0; u < VT::PER_THREAD; ++u) {
    const int i = tid + NT * u, t = i / VT::PER_ROW, c = (i % VT::PER_ROW) * VT::ELEMS;
    x[u] = t < n && i < VT::VECS ? *reinterpret_cast<const uint4*>(p + (c0 + t) * ss + c)
                                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Those vectors into the [C][LD] f32 array D, through f.
template <typename T, int HS, int LD, typename F>
__device__ __forceinline__ void put_chunk(float* D, const uint4 (&x)[Vec<T, HS>::PER_THREAD],
                                          int tid, F f) {
  using VT = Vec<T, HS>;
#pragma unroll
  for (int u = 0; u < VT::PER_THREAD; ++u) {
    const int i = tid + NT * u, t = i / VT::PER_ROW, c = (i % VT::PER_ROW) * VT::ELEMS;
    if (i >= VT::VECS) break;
    float y[VT::ELEMS];
    unpack(x[u], y, T());
    if constexpr (LD % 4 == 0) {             // 16-byte stores: fewer bank conflicts
#pragma unroll
      for (int e = 0; e < VT::ELEMS; e += 4)
        *reinterpret_cast<float4*>(D + t * LD + c + e) =
            make_float4(f(y[e]), f(y[e + 1]), f(y[e + 2]), f(y[e + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < VT::ELEMS; ++e) D[t * LD + c + e] = f(y[e]);
    }
  }
}

struct Ident { __device__ float operator()(float x) const { return x; } };
struct Exp { __device__ float operator()(float x) const { return expf(x); } };

// N (1, 2 or 4) neighbouring floats from or to an address aligned to 4N bytes
template <int N>
__device__ __forceinline__ void ld_vec(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (N == 1) {
    x[0] = *p;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (N == 1) *p = x[0];
  else *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// The 16 x 16 grid of register tiles of a product: a warp takes 4 rows by 8
// columns of it, so that each step's operand rows are read in one
// shared-memory wavefront each.
__device__ __forceinline__ int tile_col(int tid) { return (tid & 7) | ((tid >> 5 & 1) << 3); }
__device__ __forceinline__ int tile_row(int tid) { return (tid >> 3 & 3) | ((tid >> 6) << 2); }

// ------------------------------------------------ pass 1: DT_c and dS_c

// Threads as a 16 x 16 grid (tile_row, tile_col), each owning a W x W tile
// of dS (W = HS/16), fed by vector loads of KH and V rows.
template <typename T, int HS>
__global__ void __launch_bounds__(NT) wkv_chunk_state(Args a) {
  constexpr int LD = HS + 4, W = HS / 16;   // rows 16-byte aligned
  extern __shared__ __align__(16) float sm[];
  float* K = sm;                 // k, then KH = k * decay to the chunk end
  float* V = K + C * LD;
  float* EW = V + C * LD;        // exp(w_log)

  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = ch * C, n = min(C, a.S - c0);
  const long long bhc = ((long long)b * a.H + h) * a.nc + ch;
  {                              // every load in flight before the first store
    uint4 kr[Vec<T, HS>::PER_THREAD], vr[Vec<T, HS>::PER_THREAD], wr[Vec<float, HS>::PER_THREAD];
    fetch_chunk<T, HS>(kr, static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_ss, c0, n, tid);
    fetch_chunk<T, HS>(vr, static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_ss, c0, n, tid);
    fetch_chunk<float, HS>(wr, a.w + b * a.w_sb + h * a.w_sh, a.w_ss, c0, n, tid);
    put_chunk<T, HS, LD>(K, kr, tid, Ident());
    put_chunk<T, HS, LD>(V, vr, tid, Ident());
    put_chunk<float, HS, LD>(EW, wr, tid, Exp());
  }
  __syncthreads();

  if (tid < HS) {                // per channel, back from the chunk end, 8 rows a
    float d = 1.f;               // batch (its loads issued before its stores)
#pragma unroll
    for (int tb = C - SC; tb >= 0; tb -= SC) {
      float kk[SC], ee[SC];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        kk[u] = K[(tb + u) * LD + tid];
        ee[u] = EW[(tb + u) * LD + tid];
      }
#pragma unroll
      for (int u = SC - 1; u >= 0; --u) {
        K[(tb + u) * LD + tid] = kk[u] * d;
        d *= ee[u];
      }
    }
    a.dt[bhc * HS + tid] = d;
  }
  __syncthreads();

  const int gx = tile_col(tid), gy = tile_row(tid);
  float acc[W][W];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    float x[W], y[W];
    ld_vec<W>(x, K + s * LD + W * gy);
    ld_vec<W>(y, V + s * LD + W * gx);
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
  float* dsp = a.ds + bhc * HS * HS;
#pragma unroll
  for (int i = 0; i < W; ++i) st_vec<W>(dsp + (W * gy + i) * HS + W * gx, acc[i]);
}

// ------------------------------------------- pass 2: the states entering each chunk

// Thread: one entry (row c) of one (b, h) state.  Each chunk's dS_c is read
// and replaced by S_c, U chunks at a time, the next U chunks' loads issued
// before this batch's stores (loads queued behind the stores leave the
// chain latency-bound at a quarter of the bandwidth).
template <int HS>
__global__ void __launch_bounds__(128) wkv_state_scan(Args a) {
  constexpr int N = HS * HS;       // entries a state
  constexpr int U = 4;
  const long long i = (long long)blockIdx.x * 128 + threadIdx.x;
  if (i >= (long long)a.B * a.H * N) return;
  const long long bh = i / N;
  const int e = (int)(i % N);
  float* X = a.ds + bh * a.nc * N + e;
  const float* Dt = a.dt + bh * a.nc * HS + e / HS;
  float s = 0.f, d[U], g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < a.nc) {
      d[u] = X[(long long)u * N];
      g[u] = Dt[(long long)u * HS];
    }
  }
  for (int c = 0; c < a.nc; c += U) {
    float dn[U], gn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + U + u < a.nc) {
        dn[u] = X[(long long)(c + U + u) * N];
        gn[u] = Dt[(long long)(c + U + u) * HS];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u < a.nc) {
        X[(long long)(c + u) * N] = s;
        s = fmaf(g[u], s, d[u]);
      }
      d[u] = dn[u];
      g[u] = gn[u];
    }
  }
  a.state[bh * N + e] = s;
}

// ---------------------------------------------------------- pass 3: the output

template <int HS>
struct OutSmem {
  static constexpr int LD = HS + 1;   // R, K, EW: walked by rows and by columns
  static constexpr int LT = C + 4;    // Qt, At, KQt: [channel or key][t], rows 16-byte aligned
  static constexpr int LV = HS + 4;   // St, V: rows 16-byte aligned
  // R, K, EW [C][LD] each, and after the walks St [HS][LV] and V [C][LV]
  // in their place
  static constexpr int REGION = 3 * C * LD > (C + HS) * LV ? 3 * C * LD : (C + HS) * LV;
  // Qt [HS][LT], At [C][LT], KQt [HS][LT]; SD, PP [NSC][HS]; GG [NP][HS]; U [HS]
  static constexpr size_t bytes = 4 * (REGION + (2 * HS + C) * LT + (2 * NSC + NP + 1) * HS);
};

// Threads: the walk inside the sub-chunks gives row t = tid / 4 to four
// neighbouring threads, each summing a quarter of the channels; the output
// product gives each thread rows 4 tile_row .. + 3 (in one sub-chunk) and
// columns W tile_col .. + W-1 (W = HS/16), fed by vector loads of transposed Q,
// A and of rows of S_c and V.
template <typename T, int HS>
__global__ void __launch_bounds__(NT, 2) wkv_chunk_out(Args a) {
  using L = OutSmem<HS>;
  constexpr int LD = L::LD, LT = L::LT, LV = L::LV, W = HS / 16, QC = HS / 4;
  constexpr int SQ4 = HS * HS / 4, SQ = (SQ4 + NT - 1) / NT;   // float4 of S_c a thread
  extern __shared__ __align__(16) float sm[];
  float* R = sm;
  float* K = R + C * LD;
  float* EW = K + C * LD;                            // exp(w_log)
  float* St = sm;                                    // S_c, over R, K, EW after the walks,
  float* V = St + HS * LV;                           // then V: one stack [S_c; V]
  float* Qt = sm + L::REGION;                        // Qt[c][t] = r * decay from t's sub-chunk start,
                                                     // then RD[t][c] = r * decay from the chunk start
  float* At = Qt + HS * LT;                          // At[s][t] = A[t][s]: one stack [RD^T; A^T]
  float* KQt = At + C * LT;                          // KQt[c][s] = k * decay to s's sub-chunk end
  float* SD = KQt + HS * LT;                         // decay over each sub-chunk
  float* PP = SD + NSC * HS;                         // decay over the sub-chunks before
  float* GG = PP + NSC * HS;                         // decay between the sub-chunks of each pair
  float* U = GG + NP * HS;

  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = ch * C, n = min(C, a.S - c0);
  const long long bhc = ((long long)b * a.H + h) * a.nc + ch;
  // every load in flight before the first store; V and S_c are needed only
  // after the walks, so they are stored then
  uint4 vr[Vec<T, HS>::PER_THREAD];
  {
    uint4 rr[Vec<T, HS>::PER_THREAD], kr[Vec<T, HS>::PER_THREAD], wr[Vec<float, HS>::PER_THREAD];
    fetch_chunk<T, HS>(rr, static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh, a.r_ss, c0, n, tid);
    fetch_chunk<T, HS>(kr, static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_ss, c0, n, tid);
    fetch_chunk<float, HS>(wr, a.w + b * a.w_sb + h * a.w_sh, a.w_ss, c0, n, tid);
    fetch_chunk<T, HS>(vr, static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_ss, c0, n,
                       tid);
    put_chunk<T, HS, LD>(R, rr, tid, Ident());
    put_chunk<T, HS, LD>(K, kr, tid, Ident());
    put_chunk<float, HS, LD>(EW, wr, tid, Exp());
  }
  float4 sr[SQ];
#pragma unroll
  for (int u = 0; u < SQ; ++u)
    if (tid + NT * u < SQ4) sr[u] = reinterpret_cast<const float4*>(a.ds + bhc * HS * HS)[tid + NT * u];
  if (tid < HS) U[tid] = a.u[h * HS + tid];
  __syncthreads();

  // decays per channel, one sub-chunk (8 rows) a batch: its loads issued
  // before its stores, the transposed rows written 16 bytes at a time
  if (tid < HS) {                            // forward from the sub-chunk starts:
    const int c = tid;                       // Qt, SD, PP, GG
    float d = 1.f;
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      float rr[SC], ee[SC];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        rr[u] = R[(SC * i + u) * LD + c];
        ee[u] = EW[(SC * i + u) * LD + c];
      }
      float p = 1.f;
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        rr[u] *= p;
        p *= ee[u];
      }
      st_vec<4>(Qt + c * LT + SC * i, {rr[0], rr[1], rr[2], rr[3]});
      st_vec<4>(Qt + c * LT + SC * i + 4, {rr[4], rr[5], rr[6], rr[7]});
      PP[i * HS + c] = d;
      SD[i * HS + c] = p;
      d *= p;
    }
    // pair (i, j), index i (i - 1) / 2 + j: the decay of the whole
    // sub-chunks strictly between j and i
#pragma unroll
    for (int j = 0; j < NSC - 1; ++j) {
      float g = 1.f;
#pragma unroll
      for (int i = j + 1; i < NSC; ++i) {
        GG[(i * (i - 1) / 2 + j) * HS + c] = g;
        g *= SD[i * HS + c];
      }
    }
  } else if (tid < 2 * HS) {                 // back to the sub-chunk ends: KQt
    const int c = tid - HS;
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      float kk[SC], ee[SC];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        kk[u] = K[(SC * i + u) * LD + c];
        ee[u] = EW[(SC * i + u) * LD + c];
      }
      float p = 1.f;
#pragma unroll
      for (int u = SC - 1; u >= 0; --u) {
        kk[u] *= p;
        p *= ee[u];
      }
      st_vec<4>(KQt + c * LT + SC * i, {kk[0], kk[1], kk[2], kk[3]});
      st_vec<4>(KQt + c * LT + SC * i + 4, {kk[4], kk[5], kk[6], kk[7]});
    }
  }
  // A inside each sub-chunk: thread (t, q) walks s = t-1 down to the
  // sub-chunk's first row over the channels c = q*QC ... q*QC + QC-1,
  // carrying prod_{s<tau<t} e_tau,c; the four quarters are summed across
  // neighbouring lanes.  Every row takes SC - 1 steps (steps past the
  // sub-chunk's first row are computed and dropped), unrolled, with the
  // sums kept in registers and stored after the last step, so that the
  // loads of later steps need not wait for earlier stores.  At hs = 64
  // quarters 2 and 3 take their channels in an order rotated by 8, so that
  // the four quarters of a row read four distinct banks.
  {
    const int t = tid >> 2, q = tid & 3, t0 = t & ~(SC - 1);
    const int rot = QC == 16 ? 8 * (q >> 1) : 0;
    float rv[QC], e[QC], pj[SC - 1];
#pragma unroll
    for (int cc = 0; cc < QC; ++cc) {
      rv[cc] = R[t * LD + q * QC + (cc + rot) % QC];
      e[cc] = 1.f;
    }
#pragma unroll
    for (int j = 0; j < SC - 1; ++j) {
      const int s = max(t - 1 - j, t0);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < QC; ++cc)
        p[cc % 4] = fmaf(rv[cc] * K[s * LD + q * QC + (cc + rot) % QC], e[cc], p[cc % 4]);
      pj[j] = (p[0] + p[1]) + (p[2] + p[3]);
#pragma unroll
      for (int cc = 0; cc < QC; ++cc) e[cc] *= EW[s * LD + q * QC + (cc + rot) % QC];
    }
    float bonus = 0.f;                         // the diagonal, this quarter's channels
#pragma unroll
    for (int cc = 0; cc < QC; ++cc) {
      const int c = q * QC + (cc + rot) % QC;
      bonus = fmaf(rv[cc] * U[c], K[t * LD + c], bonus);
    }
    bonus += __shfl_xor_sync(0xffffffff, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffff, bonus, 2);
#pragma unroll
    for (int j = 0; j < SC - 1; ++j) {
      pj[j] += __shfl_xor_sync(0xffffffff, pj[j], 1);
      pj[j] += __shfl_xor_sync(0xffffffff, pj[j], 2);
    }
    if (q == 0) {
#pragma unroll
      for (int j = 0; j < SC - 1; ++j)
        if (t - 1 - j >= t0) At[(t - 1 - j) * LT + t] = pj[j];
      At[t * LT + t] = bonus;
    }
    // the zeros above the diagonal in the sub-chunk
    for (int s = t + 1 + q; s < t0 + SC; s += 4) At[s * LT + t] = 0.f;
  }
  __syncthreads();                           // R, K and EW are read for the last time

  // A across sub-chunks j < i: sum_c Q[t] KQ[s] G_ij, in 4 x 4 tiles of the
  // NP blocks (i, j), one a thread of the first NP * TB
  constexpr int TS = SC / 4, TB = TS * TS;           // tiles a side, a block
  if (tid < NP * TB) {
    const int tile = tid;
    const int pr = tile / TB;
    int i = 1;
    while ((i + 1) * i / 2 <= pr) ++i;
    const int j = pr - i * (i - 1) / 2;
    const int t0 = SC * i + 4 * ((tile % TB) / TS), s0 = SC * j + 4 * (tile % TS);
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HS; ++c) {
      float x[4], y[4];
      ld_vec<4>(x, Qt + c * LT + t0);
      ld_vec<4>(y, KQt + c * LT + s0);
      const float g = GG[pr * HS + c];
#pragma unroll
      for (int xi = 0; xi < 4; ++xi) {
        const float xg = x[xi] * g;
#pragma unroll
        for (int yi = 0; yi < 4; ++yi) acc[xi][yi] = fmaf(xg, y[yi], acc[xi][yi]);
      }
    }
#pragma unroll
    for (int yi = 0; yi < 4; ++yi)
      st_vec<4>(At + (s0 + yi) * LT + t0, {acc[0][yi], acc[1][yi], acc[2][yi], acc[3][yi]});
  }
  put_chunk<T, HS, LV>(V, vr, tid, Ident());
#pragma unroll
  for (int u = 0; u < SQ; ++u) {
    if (tid + NT * u >= SQ4) break;
    const int idx = 4 * (tid + NT * u);
    *reinterpret_cast<float4*>(St + (idx / HS) * LV + idx % HS) = sr[u];
  }
  __syncthreads();

  // RD = Q PP (r times the decay from the chunk start), in place of Qt
  constexpr int RQ = HS * C / 4 / NT;                // float4 of Qt a thread
#pragma unroll
  for (int u = 0; u < RQ; ++u) {
    const int i4 = tid + NT * u, c = i4 / (C / 4), t = 4 * (i4 % (C / 4));
    float x[4];
    ld_vec<4>(x, Qt + c * LT + t);
    const float pp = PP[(t / SC) * HS + c];
    st_vec<4>(Qt + c * LT + t, {x[0] * pp, x[1] * pp, x[2] * pp, x[3] * pp});
  }
  __syncthreads();

  // o = [RD A] [S_c; V]: rows 4 gy .. + 3, columns W gx .. + W-1; A is zero
  // above the diagonal, so the keys stop at the thread's last row
  const int gx = tile_col(tid), t0 = 4 * tile_row(tid);
  float o[4][W];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) o[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HS + t0 + 4; ++kk) {
    float x[4], y[W];
    ld_vec<4>(x, Qt + kk * LT + t0);
    ld_vec<W>(y, St + kk * LV + W * gx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) o[i][j] = fmaf(x[i], y[j], o[i][j]);
  }
  float* op = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t0 + i < n) st_vec<W>(op + (c0 + t0 + i) * a.o_ss + W * gx, o[i]);
}

template <typename T, int HS>
cudaError_t run(const Args& a, cudaStream_t st) {
  const size_t s1 = (size_t)4 * 3 * C * (HS + 4), s3 = OutSmem<HS>::bytes;
  cudaError_t e = cudaFuncSetAttribute(wkv_chunk_state<T, HS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv_chunk_out<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nc, a.H, a.B);
  wkv_chunk_state<T, HS><<<grid, NT, s1, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long entries = (long long)a.B * a.H * HS * HS;
  wkv_state_scan<HS><<<(unsigned)((entries + 127) / 128), 128, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv_chunk_out<T, HS><<<grid, NT, s3, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 = f32, 1 = bf16.  `scratch` is f32 of
// B * H * nc * (hs * hs + hs) elements, nc = ceil(S / 64).  Returns the
// cudaError_t of the launches (0 = ok); 1000 for a shape or dtype this kernel
// does not take.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v, const float* w,
                         const float* u, float* o, float* state, float* scratch,
                         int B, int H, int S, int hs,
                         long long r_sb, long long r_sh, long long r_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long w_sb, long long w_sh, long long w_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 || scratch == nullptr) return 1000;
  const int nc = (S + C - 1) / C;
  float* dt = scratch + (long long)B * H * nc * hs * hs;
  Args a{r, k, v, w, u, o, state, scratch, dt, B, H, S, nc,
         r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, w_sb, w_sh, w_ss,
         o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hs == 16) return run<__nv_bfloat16, 16>(a, st);
    if (hs == 32) return run<__nv_bfloat16, 32>(a, st);
    if (hs == 64) return run<__nv_bfloat16, 64>(a, st);
  } else if (dtype == 0) {
    if (hs == 16) return run<float, 16>(a, st);
    if (hs == 32) return run<float, 32>(a, st);
    if (hs == 64) return run<float, 64>(a, st);
  }
  return 1000;
}
