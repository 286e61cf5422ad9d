// Flash-attention forward for Hopper (sm_90a): causal GQA attention with an
// optional sliding window and a causal shift.  Returns o and the f32 lse.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (reached through flash_attention_fwd).
//
// What bounds it on the H100: operations.  At the serving prefill shape
// (H=12, KVH=2, S=3000, D=128, causal) one layer needs ~27.6 GFLOP of QK^T
// and PV products against ~9 MB of q/k/v/o traffic, far above the card's
// ~295 FLOP/byte ridge.  The design therefore keeps the whole online-softmax
// state (m, l, acc) in registers, stages K and V tiles in shared memory once
// per block, and skips KV tiles that the causal or window mask hides entirely
// through the loop bounds (never computed and then masked).  The bf16 path
// runs the products on the tensor cores with mma.sync m16n8k16 (f32
// accumulate, P rounded to bf16 for the PV product), feeds them with
// ldmatrix, and double-buffers K/V tiles with cp.async so that the next
// tile's copy overlaps this tile's math; the f32 path uses plain FMAs so that
// it keeps full f32 accuracy (the tensor cores would give TF32).  wgmma, TMA
// and warp specialisation are later work.
//
// Head dims 64, 128 and 256 (recurrentgemma's local attention).  At D = 256 a
// warp's 16 x D f32 accumulator alone takes 128 registers a thread, so the Q
// fragments (another 64) no longer fit beside it: the Q tile is staged in
// shared memory with the first K/V tile and read back with ldmatrix at each
// k step (shared memory then holds Q and two K/V buffers, 169 KB).
//
// Layouts: q (B,H,Sq,D), k/v (B,KVH,Skv,D), o (B,H,Sq,D), each addressed by
// (batch, head, row) strides in elements with D contiguous; lse (B,H,Sq)
// contiguous.  Query head h reads KV head h / G.  Query row i sits at
// absolute position i + causal_shift.
#include "attention_common.cuh"

namespace {

struct Args {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int B, H, KVH, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int window;        // <= 0: no window
  int causal_shift;
  float scale;       // 1/sqrt(D)
};

// 4 warps; warp w owns query rows q0 + 16w .. q0 + 16w + 15.  Within a warp,
// lane = 4*g + t holds rows g and g+8 of every m16n8 accumulator tile.  K and
// V tiles are double-buffered in shared memory: the copy of tile kb+1 runs
// (cp.async) while tile kb is computed.  B fragments come from ldmatrix (K
// as stored, V transposed).  Tiles wholly inside the causal/window band skip
// the per-element mask.
template <int D>
__global__ void __launch_bounds__(128) fwd_bf16(Args a) {
  constexpr int LD = D + 8;                      // padded smem row (bf16): 16-byte
                                                 // aligned, conflict-free ldmatrix
  constexpr int TILE = BK * LD;                  // elements per K or V tile
  constexpr bool Q_SMEM = D > 128;               // Q read from shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                                 // [2][BK][LD]
  __nv_bfloat16* Qs = Vs + 2 * TILE;             // [BQ][LD], Q_SMEM only

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;            // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH, kh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kh * a.v_sh;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // Q fragments for all D/16 k-steps, loaded once (up to D = 128).
  uint32_t qa[Q_SMEM ? 1 : D / 16][4];
  if constexpr (!Q_SMEM) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      int c = kk * 16 + 2 * t;
      const uint32_t z = 0;
      qa[kk][0] = r0 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * a.q_ss + c) : z;
      qa[kk][1] = r1 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * a.q_ss + c) : z;
      qa[kk][2] = r0 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * a.q_ss + c + 8) : z;
      qa[kk][3] = r1 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * a.q_ss + c + 8) : z;
    }
  }
  // D > 128: the Q tile joins the first K/V tile's copy group; rows beyond
  // Sq are zero-filled
  auto load_q = [&]() {
    constexpr int CH = D / 8;
    for (int i = tid; i < BQ * CH; i += 128) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = q0 + r < a.Sq;
      const long long row = in ? q0 + r : 0;
      cp_async16(Qs + r * LD + c, qp + row * a.q_ss + c, in ? 16 : 0);
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 units
  const float sl2 = a.scale * LOG2E;

  // rows beyond Skv are zero-filled; their keys are masked below
  auto load_tile = [&](int kb, int buf) {
    constexpr int CH = D / 8;                    // 16-byte chunks per row
    const int k0 = kb * BK;
    for (int i = tid; i < BK * CH; i += 128) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < a.Skv;
      const long long row = in ? k0 + r : 0;
      cp_async16(Ks + buf * TILE + r * LD + c, kp + row * a.k_ss + c, in ? 16 : 0);
      cp_async16(Vs + buf * TILE + r * LD + c, vp + row * a.v_ss + c, in ? 16 : 0);
    }
    cp_async_commit();
  };

  int lo, hi;
  kv_tile_range(a, q0, lo, hi);
  if (lo < hi) {
    if constexpr (Q_SMEM) load_q();
    load_tile(lo, 0);
  }
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK, buf = (kb - lo) & 1;
    if (kb + 1 < hi) {
      load_tile(kb + 1, buf ^ 1);                // buffer freed by the sync that
      cp_async_wait<1>();                        // ended the previous iteration
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;

    // S = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix.x4 gives the
    // B fragments of two key n-tiles for one k16 step.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const int mi = lane >> 3, mr = lane & 7;     // ldmatrix: matrix, row
    if constexpr (Q_SMEM) {
      // one ldmatrix.x4 gives this warp's A fragment of one k16 step
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[4];
        ldmatrix_x4(qf, Qs + (warp * 16 + (mi & 1) * 8 + mr) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int j = 0; j < BK / 8; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
          mma_bf16(s[j], qf, bk[0], bk[1]);
          mma_bf16(s[j + 1], qf, bk[2], bk[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bk[4];                        // (n-tile j: b0, b1), (j+1: b0, b1)
          ldmatrix_x4(bk, Kt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
          mma_bf16(s[j], qa[kk], bk[0], bk[1]);
          mma_bf16(s[j + 1], qa[kk], bk[2], bk[3]);
        }
      }
    }
    // scale, mask, row max
    const bool interior = k0 + BK - 1 <= q0 + a.causal_shift && k0 + BK <= a.Skv &&
                          (a.window <= 0 || k0 > q0 + BQ - 1 + a.causal_shift - a.window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float x = (interior || visible(a, row, col)) ? s[j][e] * sl2 : NEG_INF;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0); s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1); s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffff, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffff, sum1, off);
    }
    l0 = l0 * c0 + sum0; l1 = l1 * c1 + sum1;
    m0 = mn0; m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= c0; acc[n][1] *= c0; acc[n][2] *= c1; acc[n][3] *= c1;
    }
    // O += P V: the S accumulator layout of two adjacent n-tiles is the A
    // fragment layout of one k16 step; one ldmatrix.x4.trans gives the B
    // fragments of two d n-tiles.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];                          // (n-tile n: b0, b1), (n+1: b0, b1)
        ldmatrix_x4_trans(bv, Vt + (16 * kk + (mi & 1) * 8 + mr) * LD + 8 * n + (mi >> 1) * 8);
        mma_bf16(acc[n], pa, bv[0], bv[1]);
        mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                             // tile consumed: its buffer is free
  }

  const float il0 = 1.f / fmaxf(l0, 1e-30f), il1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    int c = 8 * n + 2 * t;
    if (r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * a.o_ss + c) = pack_bf16(acc[n][0] * il0, acc[n][1] * il0);
    if (r1 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + r1 * a.o_ss + c) = pack_bf16(acc[n][2] * il1, acc[n][3] * il1);
  }
  if (t == 0) {
    float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    // m is in log2 units; a row that saw no visible key keeps NEG_INF as is
    if (r0 < a.Sq) lp[r0] = (m0 == NEG_INF ? NEG_INF : m0 * LN2) + logf(fmaxf(l0, 1e-30f));
    if (r1 < a.Sq) lp[r1] = (m1 == NEG_INF ? NEG_INF : m1 * LN2) + logf(fmaxf(l1, 1e-30f));
  }
}

// --------------------------------------------------------------- f32: FMAs

// 256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows ty + 16i
// (i < 4) and, for S, keys tx + 16j (j < 4), for O, columns tx + 16j
// (j < D/16).
template <int D>
__global__ void __launch_bounds__(256) fwd_f32(Args a) {
  constexpr int LQ = D + 1, LK = BK + 1, LP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][LQ]
  float* Kt = Qs + BQ * LQ;                         // [D][LK] (transposed)
  float* Vs = Kt + D * LK;                          // [BK][D]
  float* Ps = Vs + BK * D;                          // [BQ][LP]

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH, kh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;

  for (int i = tid; i < BQ * D; i += 256) {
    int r = i / D, c = i % D;
    Qs[r * LQ + c] = q0 + r < a.Sq ? qp[(long long)(q0 + r) * a.q_ss + c] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = NEG_INF; l[i] = 0.f; }

  int lo, hi;
  kv_tile_range(a, q0, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += 256) {
      int r = i / D, c = i % D;
      bool in = k0 + r < a.Skv;
      Kt[c * LK + r] = in ? kp[(long long)(k0 + r) * a.k_ss + c] : 0.f;
      Vs[r * D + c] = in ? vp[(long long)(k0 + r) * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * LK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = visible(a, row, k0 + tx + 16 * j) ? s[i][j] * a.scale : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float mn = fmaxf(m[i], mx), corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - mn);
        sum += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffff, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) op[(long long)row * a.o_ss + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m[i] + logf(lc);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns the cudaError_t of the launch (0 = ok);
// 1000 for a shape or dtype this kernel does not take.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int H, int KVH, int Sq, int Skv, int D,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_ss,
                      int window, int causal_shift, int dtype, void* stream) {
  Args a{q, k, v, o, lse, B, H, KVH, Sq, Skv,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         window, causal_shift, 1.0f / sqrtf((float)D)};
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || Sq <= 0 || Skv <= 0) return 1000;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // two buffers each of a K and a V tile (and, at D = 256, the Q tile)
    if (D == 64) return launch(fwd_bf16<64>, grid, 128, 4 * BK * (64 + 8) * 2, st, a);
    if (D == 128) return launch(fwd_bf16<128>, grid, 128, 4 * BK * (128 + 8) * 2, st, a);
    if (D == 256) return launch(fwd_bf16<256>, grid, 128, (4 * BK + BQ) * (256 + 8) * 2, st, a);
  } else if (dtype == 0) {
    auto smem = [](int d) { return (size_t)(BQ * (d + 1) + d * (BK + 1) + BK * d + BQ * (BK + 1)) * 4; };
    if (D == 64) return launch(fwd_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(fwd_f32<128>, grid, 256, smem(128), st, a);
    if (D == 256) return launch(fwd_f32<256>, grid, 256, smem(256), st, a);
  }
  return 1000;
}
