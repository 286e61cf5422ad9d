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
// (per channel) and S0 the state entering the chunk,
//     o_t  = (r_t * prod_{tau<t} e_tau) S0                             [inter-chunk]
//          + sum_{s<t} (sum_c r_tc k_sc prod_{s<tau<t} e_tau,c) v_s     [intra, pairwise]
//          + (r_t . (u * k_t)) v_t                                     [bonus diagonal]
//     S1   = diag(prod_{tau<n} e_tau) S0 + (k * prod_{s<tau<n} e_tau)^T v,
// n = rows in the chunk.  Every decay factor is a running product of
// per-step decays, as the sequential recurrence applies them: each factor is
// in (0, 1], so nothing overflows however strong the decay, and there is no
// cancellation.  The TPU kernel takes the pairwise decays as
// exp(lp_prev[t] - lp[s]) from chunk-local prefix sums of w_log, which loses
// digits once a strong decay has made the sums large: at per-step decays of
// exp(-exp(N(0, 3))), as strong as the random-weight models', it is 2.4e-4
// off the exact recurrence (tests/test_torch_recurrent_kernels.py), this
// kernel 3e-7 (chip_smoke.py); the centred two-factor form of the JAX
// package's wkv_chunked overflows instead.
//
// The pairwise decays are split at 16-row sub-chunks.  For t in sub-chunk i
// and s in an earlier sub-chunk j, prod_{s<tau<t} = PE[s] * G_ji * PB[t]:
// the decay from s to the end of its sub-chunk, over the whole sub-chunks in
// between, and from the start of t's sub-chunk to t, each a running product
// in (0, 1].  So those entries of A are sums over c of (r PB)[t] (k PE)[s]
// G_ji, products of bounded factors, and only the pairs inside one sub-chunk
// walk their decays step by step (at most 15 steps).
//
// What bounds it on the H100: at rwkv6-7b's prefill (B=1, H=64, S=3000,
// hs=64) the inputs and outputs are ~173 MB, ~0.05 ms at 3.35 TB/s, while the
// f32 arithmetic is done on the CUDA cores in full f32 (the reference's
// tolerance is relative 1e-5, which TF32 tensor cores would not meet).  The
// design keeps the state and the whole chunk in shared memory: one block of
// 256 threads per (batch, head) walks the chunks in order, so the state never
// goes to device memory until the end.  The next chunk's r, k, v and w_log
// are loaded with 16-byte loads into registers while the current chunk is
// computed, so the loads' latency is hidden behind the arithmetic.  The
// ragged last chunk is handled by bounds (its missing rows read as k = v = r
// = 0, w_log = 0, which leave the state as it was), not by a padded copy.
// With B*H blocks (64 at batch 1) for 132 SMs, splitting the value columns
// of a head across blocks is the next step.
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
constexpr int SC = 16;         // sub-chunk length
constexpr int NSC = C / SC;    // sub-chunks per chunk
constexpr int NT = 256;        // threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* r; const void* k; const void* v; const float* w; const float* u;
  float* o; float* state;
  int B, H, S;
  long long r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, w_sb, w_sh, w_ss,
      o_sb, o_sh, o_ss;
};

template <int HS>
struct Smem {
  static constexpr int LD = HS + 1;   // padded rows: column walks hit distinct banks
  // R, K, V, EW (exp(w_log)), RD (r * decay from the chunk start), KH (k *
  // decay to the chunk end), Q (r * decay from its sub-chunk's start), KQ
  // (k * decay to its sub-chunk's end): [C][LD] each; A: [C][C + 1];
  // St: [HS][LD]; SD (decay over each sub-chunk): [NSC][HS]; U (u), DT
  // (decay over the whole chunk): [HS] each
  static constexpr size_t bytes =
      4 * (8 * C * LD + C * (C + 1) + HS * LD + (NSC + 2) * HS);
};

// 16-byte vectors of one chunk of an (S, HS) operand that each thread loads
template <typename T, int HS>
struct Vec {
  static constexpr int PER_ROW = HS * (int)sizeof(T) / 16;
  static constexpr int PER_THREAD = C * PER_ROW / NT;
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
// 16-byte vectors, zeros past row n.
template <typename T, int HS>
__device__ __forceinline__ void load_chunk(uint4* dst, const T* p, long long ss, int c0, int n,
                                           int tid) {
  using VT = Vec<T, HS>;
#pragma unroll
  for (int u = 0; u < VT::PER_THREAD; ++u) {
    const int i = tid + NT * u, t = i / VT::PER_ROW, c = (i % VT::PER_ROW) * VT::ELEMS;
    dst[u] = t < n ? *reinterpret_cast<const uint4*>(p + (c0 + t) * ss + c)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The vectors of load_chunk into the [C][LD] f32 array D, through f.
template <typename T, int HS, typename F>
__device__ __forceinline__ void store_chunk(float* D, const uint4* src, int tid, F f) {
  using VT = Vec<T, HS>;
  constexpr int LD = Smem<HS>::LD;
#pragma unroll
  for (int u = 0; u < VT::PER_THREAD; ++u) {
    const int i = tid + NT * u, t = i / VT::PER_ROW, c = (i % VT::PER_ROW) * VT::ELEMS;
    float x[VT::ELEMS];
    unpack(src[u], x, T());
#pragma unroll
    for (int e = 0; e < VT::ELEMS; ++e) D[t * LD + c + e] = f(x[e]);
  }
}

// Threads: the block as a 16 x 16 grid (ty, tx) for the products: A rows
// t = ty + 16i (in sub-chunk i), columns s = tx + 16j (in sub-chunk j);
// o rows t = ty + 16i, columns tx + 16jj (jj < HS/16); state rows
// c = ty + 16i, columns tx + 16jj (i, jj < HS/16).  The walk inside the
// sub-chunks gives row t = tid / 4 to four neighbouring threads, each summing
// a quarter of the channels.
template <typename T, int HS>
__global__ void __launch_bounds__(NT) wkv_kernel(Args a) {
  constexpr int LD = Smem<HS>::LD, NJ = HS / 16, QC = HS / 4;
  using VT = Vec<T, HS>;
  using VW = Vec<float, HS>;
  extern __shared__ __align__(16) float sm[];
  float* R = sm;
  float* K = R + C * LD;
  float* V = K + C * LD;
  float* EW = V + C * LD;
  float* RD = EW + C * LD;
  float* KH = RD + C * LD;
  float* Q = KH + C * LD;
  float* KQ = Q + C * LD;
  float* A = KQ + C * LD;
  float* St = A + C * (C + 1);
  float* SD = St + HS * LD;
  float* U = SD + NSC * HS;
  float* DT = U + HS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5;
  const T* rp = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* wp = a.w + b * a.w_sb + h * a.w_sh;
  float* op = a.o + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < HS * LD; i += NT) St[i] = 0.f;
  if (tid < HS) U[tid] = a.u[h * HS + tid];

  uint4 rr[VT::PER_THREAD], kr[VT::PER_THREAD], vr[VT::PER_THREAD], wr[VW::PER_THREAD];
  {
    const int n = min(C, a.S);
    load_chunk<T, HS>(rr, rp, a.r_ss, 0, n, tid);
    load_chunk<T, HS>(kr, kp, a.k_ss, 0, n, tid);
    load_chunk<T, HS>(vr, vp, a.v_ss, 0, n, tid);
    load_chunk<float, HS>(wr, wp, a.w_ss, 0, n, tid);
  }

  for (int c0 = 0; c0 < a.S; c0 += C) {
    const int n = min(C, a.S - c0);
    __syncthreads();                         // the previous chunk is consumed
    store_chunk<T, HS>(R, rr, tid, [](float x) { return x; });
    store_chunk<T, HS>(K, kr, tid, [](float x) { return x; });
    store_chunk<T, HS>(V, vr, tid, [](float x) { return x; });
    store_chunk<float, HS>(EW, wr, tid, [](float x) { return expf(x); });
    __syncthreads();
    if (c0 + C < a.S) {                      // the next chunk's loads fly meanwhile
      const int nn = min(C, a.S - c0 - C);
      load_chunk<T, HS>(rr, rp, a.r_ss, c0 + C, nn, tid);
      load_chunk<T, HS>(kr, kp, a.k_ss, c0 + C, nn, tid);
      load_chunk<T, HS>(vr, vp, a.v_ss, c0 + C, nn, tid);
      load_chunk<float, HS>(wr, wp, a.w_ss, c0 + C, nn, tid);
    }

    if (tid < HS) {                          // decays forward from the chunk and
      const int c = tid;                     // sub-chunk starts, per channel
      float d = 1.f, p = 1.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float r = R[t * LD + c], e = EW[t * LD + c];
        RD[t * LD + c] = r * d;
        Q[t * LD + c] = r * p;
        d *= e;
        p *= e;
        if (t % SC == SC - 1) {
          SD[(t / SC) * HS + c] = p;
          p = 1.f;
        }
      }
      DT[c] = d;
    } else if (tid < 2 * HS) {               // decays back to the chunk and
      const int c = tid - HS;                // sub-chunk ends (past row n: none)
      float d = 1.f, p = 1.f;
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        if (t % SC == SC - 1) p = 1.f;
        const float k = K[t * LD + c];
        KH[t * LD + c] = k * d;
        KQ[t * LD + c] = k * p;
        if (t < n) {
          const float e = EW[t * LD + c];
          d *= e;
          p *= e;
        }
      }
    }
    // A inside each sub-chunk: thread (t, q) walks s = t-1 down to the
    // sub-chunk's first row over the channels c = q*QC ... q*QC + QC-1,
    // carrying prod_{s<tau<t} e_tau,c; the four quarters are summed across
    // neighbouring lanes.  The walk runs to the longest row of the warp, so
    // the lanes stay converged for the shuffles.
    {
      const int t = tid >> 2, q = tid & 3, t0 = t & ~(SC - 1);
      const int steps = (warp * 8 + 7) % SC;     // the warp's largest t - t0
      float rv[QC], e[QC];
#pragma unroll
      for (int cc = 0; cc < QC; ++cc) {
        rv[cc] = R[t * LD + q * QC + cc];
        e[cc] = 1.f;
      }
      for (int j = 0; j < steps; ++j) {
        const int s = t - 1 - j;
        const bool act = s >= t0;
        const int sr = act ? s : t0;
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int cc = 0; cc < QC; cc += 2) {
          p0 = fmaf(rv[cc] * K[sr * LD + q * QC + cc], e[cc], p0);
          p1 = fmaf(rv[cc + 1] * K[sr * LD + q * QC + cc + 1], e[cc + 1], p1);
        }
        float p = p0 + p1;
        p += __shfl_xor_sync(0xffffffff, p, 1);
        p += __shfl_xor_sync(0xffffffff, p, 2);
        if (act) {
          if (q == 0) A[t * (C + 1) + s] = p;
#pragma unroll
          for (int cc = 0; cc < QC; ++cc) e[cc] *= EW[s * LD + q * QC + cc];
        }
      }
      // the diagonal (bonus) and the zeros above it in the sub-chunk
      if (q == 0) {
        float bonus = 0.f;
#pragma unroll 8
        for (int c = 0; c < HS; ++c) bonus = fmaf(R[t * LD + c] * U[c], K[t * LD + c], bonus);
        A[t * (C + 1) + t] = bonus;
      }
      for (int s = t + 1 + q; s < t0 + SC; s += 4) A[t * (C + 1) + s] = 0.f;
    }
    __syncthreads();
    // A across sub-chunks j < i: sum_c Q[t] KQ[s] G_ji, G_ji the decay over
    // the whole sub-chunks strictly between (1 for neighbours)
    {
      float acc[NSC][NSC];
#pragma unroll
      for (int i = 1; i < NSC; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HS; ++c) {
        float x[NSC], y[NSC], g[NSC];
#pragma unroll
        for (int i = 0; i < NSC; ++i) {
          x[i] = Q[(ty + SC * i) * LD + c];
          y[i] = KQ[(tx + SC * i) * LD + c];
          g[i] = SD[i * HS + c];
        }
#pragma unroll
        for (int i = 1; i < NSC; ++i) {
          float xg = x[i];                   // Q[t] times the decay of the
#pragma unroll                               // sub-chunks between, growing as j falls
          for (int j = i - 1; j >= 0; --j) {
            acc[i][j] = fmaf(xg, y[j], acc[i][j]);
            xg *= g[j];
          }
        }
      }
#pragma unroll
      for (int i = 1; i < NSC; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j) A[(ty + SC * i) * (C + 1) + tx + SC * j] = acc[i][j];
    }
    __syncthreads();

    // o = RD S0 + A V (A is zero above the diagonal: sub-chunk j > i is skipped)
    float o[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) o[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HS; ++c) {
      float x[4], y[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = RD[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) y[jj] = St[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) o[i][jj] = fmaf(x[i], y[jj], o[i][jj]);
    }
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
#pragma unroll 4
      for (int sl = 0; sl < SC; ++sl) {
        const int s = SC * j + sl;
        float y[NJ];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) y[jj] = V[s * LD + tx + 16 * jj];
#pragma unroll
        for (int i = j; i < NSC; ++i) {
          const float x = A[(ty + SC * i) * (C + 1) + s];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) o[i][jj] = fmaf(x, y[jj], o[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t < n) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) op[(c0 + t) * a.o_ss + tx + 16 * jj] = o[i][jj];
      }
    }
    __syncthreads();                         // every read of S0 is done

    // S1 = diag(DT) S0 + KH^T V, each thread on the entries it owns
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int c = ty + 16 * i;
      const float dec = DT[c];
      float acc[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[jj] = dec * St[c * LD + tx + 16 * jj];
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float kh = KH[s * LD + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[jj] = fmaf(kh, V[s * LD + tx + 16 * jj], acc[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) St[c * LD + tx + 16 * jj] = acc[jj];
    }
  }

  __syncthreads();
  float* sp = a.state + ((long long)b * a.H + h) * HS * HS;
  for (int i = tid; i < HS * HS; i += NT) sp[i] = St[(i / HS) * LD + i % HS];
}

template <typename T, int HS>
cudaError_t run(const Args& a, cudaStream_t st) {
  const size_t smem = Smem<HS>::bytes;
  cudaError_t e = cudaFuncSetAttribute(wkv_kernel<T, HS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  wkv_kernel<T, HS><<<dim3(a.H, a.B), NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 = f32, 1 = bf16.  Returns the cudaError_t of the
// launch (0 = ok); 1000 for a shape or dtype this kernel does not take.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v, const float* w,
                         const float* u, float* o, float* state,
                         int B, int H, int S, int hs,
                         long long r_sb, long long r_sh, long long r_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long w_sb, long long w_sh, long long w_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return 1000;
  Args a{r, k, v, w, u, o, state, B, H, S,
         r_sb, r_sh, r_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, w_sb, w_sh, w_ss,
         o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hs == 32) return run<__nv_bfloat16, 32>(a, st);
    if (hs == 64) return run<__nv_bfloat16, 64>(a, st);
  } else if (dtype == 0) {
    if (hs == 32) return run<float, 32>(a, st);
    if (hs == 64) return run<float, 64>(a, st);
  }
  return 1000;
}
