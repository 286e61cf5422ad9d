// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, of causal GQA
// attention with an optional sliding window and a causal shift.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (reached through flash_attention_bwd, the backward of
// the custom_vjp flash_attention).
//
// What bounds them on the H100: operations.  At the training shape (H=12,
// KVH=2, S=4096, D=128, causal) dq does three products per visible (query,
// key) pair and head (S = Q K^T, dP = dO V^T, dQ = dS K: 77 GFLOP) and dk/dv
// four (S^T, dP^T, dV = P^T dO, dK = dS^T Q: 103 GFLOP), against ~10 MB of
// tensors.  So the designs follow the forward kernel: 64 x 64 tiles, 4 warps
// of 16 rows, products on the tensor cores with mma.sync m16n8k16 (bf16
// operands, f32 accumulation; P and dS are rounded to bf16 where they feed a
// product, as the forward rounds P), operand fragments from ldmatrix,
// cp.async double buffering, and dead tiles cut by the loop bounds.  The f32
// path uses FMAs so that it keeps full f32 accuracy (the tensor cores would
// give TF32).  wgmma, TMA and warp specialisation are later work.
//
// dq    one block per (b, h, 64-row q tile), walking the live KV tiles.  It
//       first computes delta = rowsum(dO * O) for its rows (the reference
//       does this outside its Pallas kernels) and writes it for dk/dv.
// dk/dv one block per (b, kv-head, 64-row k tile), walking the G query heads
//       x live q tiles with dk and dv in registers: no atomics, as the Pallas
//       kernel's sequential (G * nQ) grid axis.  It reads the delta that dq
//       wrote, so it is launched after dq on the same stream.
//
// Layouts: q, o, do, dq (B,H,Sq,D); k, v, dk, dv (B,KVH,Skv,D), each
// addressed by (batch, head, row) strides in elements with D contiguous; lse
// and delta (B,H,Sq) f32 contiguous.  Query head h reads KV head h / G.
// Query row i sits at absolute position i + causal_shift.
#include "attention_common.cuh"

namespace {

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse; float* delta;
  void* dq; void* dk; void* dv;
  int B, H, KVH, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int window;        // <= 0: no window
  int causal_shift;
  float scale;       // 1/sqrt(D)
};

// Range of q tiles [lo, hi) holding at least one query that sees a key of
// the tile starting at k0.
__device__ __forceinline__ void q_tile_range(const BwdArgs& a, int k0, int& lo, int& hi) {
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int first = k0 - a.causal_shift;                     // smallest query
  lo = first <= 0 ? 0 : min(nq, first / BQ);
  hi = nq;
  if (a.window > 0) {
    const int last = min(k0 + BK, a.Skv) - 1 + a.window - 1 - a.causal_shift;
    hi = last < 0 ? 0 : min(nq, last / BQ + 1);
  }
  if (hi < lo) hi = lo;
}

// Every (query, key) pair of the tiles at q0 and k0 is visible and in range.
__device__ __forceinline__ bool interior(const BwdArgs& a, int q0, int k0) {
  return k0 + BK - 1 <= q0 + a.causal_shift && k0 + BK <= a.Skv && q0 + BQ <= a.Sq &&
         (a.window <= 0 || k0 > q0 + BQ - 1 + a.causal_shift - a.window);
}

__device__ __forceinline__ bool visible_q(const BwdArgs& a, int row, int col) {
  return row < a.Sq && visible(a, row, col);
}

// ------------------------------------------------------------ bf16: mma.sync

// 4 warps; warp w owns query rows q0 + 16w .. +15; lane = 4*g + t holds rows
// g and g+8 of each m16n8 accumulator tile.  Q stays in registers (A
// fragments); dO is staged once in shared memory; K and V tiles are
// double-buffered with cp.async.
template <int D>
__global__ void __launch_bounds__(128) dq_bf16(BwdArgs a) {
  constexpr int LD = D + 8;                      // padded smem row, as the forward
  constexpr int TILE = BK * LD;
  constexpr int CH = D / 8;                      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                                // [2][BK][LD]
  __nv_bfloat16* dOs = Vs + 2 * TILE;                               // [BQ][LD]
  float* dls = reinterpret_cast<float*>(dOs + BQ * LD);              // [BQ] delta

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;            // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH, kh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix: matrix, row

  using bf16 = __nv_bfloat16;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const bf16* op = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;

  for (int i = tid; i < BQ * CH; i += 128) {     // dO tile; rows past Sq are zeros
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < a.Sq;
    cp_async16(dOs + r * LD + c, dop + (in ? q0 + r : 0) * a.do_ss + c, in ? 16 : 0);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) in f32; the CH threads of a row are adjacent lanes
  const long long row_base = ((long long)b * a.H + h) * a.Sq;
  for (int i = tid; i < BQ * CH; i += 128) {     // BQ * CH is a multiple of 128
    const int r = i / CH, c = (i % CH) * 8;
    float acc = 0.f;
    if (q0 + r < a.Sq) {
      const uint4 ov = *reinterpret_cast<const uint4*>(op + (q0 + r) * a.o_ss + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dop + (q0 + r) * a.do_ss + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
#pragma unroll
    for (int off = 1; off < CH; off <<= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
    if (i % CH == 0) {
      dls[r] = acc;
      if (q0 + r < a.Sq) a.delta[row_base + q0 + r] = acc;
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[D / 16][4];                        // Q A-fragments, as the forward
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t z = 0;
    qa[kk][0] = r0 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * a.q_ss + c) : z;
    qa[kk][1] = r1 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * a.q_ss + c) : z;
    qa[kk][2] = r0 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r0 * a.q_ss + c + 8) : z;
    qa[kk][3] = r1 < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + r1 * a.q_ss + c + 8) : z;
  }
  // rows past Sq: lse 0 and zero Q and dO give finite P and zero dS
  const float ls0 = r0 < a.Sq ? a.lse[row_base + r0] * LOG2E : 0.f;
  const float ls1 = r1 < a.Sq ? a.lse[row_base + r1] * LOG2E : 0.f;
  __syncthreads();                               // dls complete
  const float dl0 = dls[warp * 16 + g], dl1 = dls[warp * 16 + g + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float sl2 = a.scale * LOG2E;

  auto load_tile = [&](int kb, int buf) {        // rows past Skv are zeros
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
  if (lo < hi) load_tile(lo, 0);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK, buf = (kb - lo) & 1;
    if (kb + 1 < hi) {
      load_tile(kb + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t da[4];                            // dO A-fragment
      ldmatrix_x4(da, dOs + (warp * 16 + (mi & 1) * 8 + mr) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Kt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[j], qa[kk], bk[0], bk[1]);    // S = Q K^T
        mma_bf16(s[j + 1], qa[kk], bk[2], bk[3]);
        ldmatrix_x4(bv, Vt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(dp[j], da, bv[0], bv[1]);       // dP = dO V^T
        mma_bf16(dp[j + 1], da, bv[2], bv[3]);
      }
    }
    // P = exp(S scale - lse) on visible pairs; dS = P (dP - delta) scale, in s
    const bool inner = interior(a, q0, k0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p = (inner || visible(a, row, col))
                            ? exp2f(s[j][e] * sl2 - (e < 2 ? ls0 : ls1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * a.scale;
      }
    }
    // dQ += dS K: dS's accumulator layout is the A layout; K^T B-fragments
    // come from ldmatrix.trans, as V's in the forward's P V.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Kt + (16 * kk + (mi & 1) * 8 + mr) * LD + 8 * n + (mi >> 1) * 8);
        mma_bf16(acc[n], pa, bk[0], bk[1]);
        mma_bf16(acc[n + 1], pa, bk[2], bk[3]);
      }
    }
    __syncthreads();                             // tile consumed: its buffer is free
  }
  cp_async_wait<0>();                            // the dO copy, when no tile was live

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < a.Sq) *reinterpret_cast<uint32_t*>(dqp + r0 * a.dq_ss + c) = pack_bf16(acc[n][0], acc[n][1]);
    if (r1 < a.Sq) *reinterpret_cast<uint32_t*>(dqp + r1 * a.dq_ss + c) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// 4 warps; warp w owns keys k0 + 16w .. +15 and works on transposed tiles
// (rows = keys, columns = queries): S^T = K Q^T, P^T, dV += P^T dO,
// dP^T = V dO^T, dS^T, dK += dS^T Q.  K and V stay in shared memory for the
// whole walk; Q, dO, lse and delta of the next (head, q tile) are copied
// while this one is computed.
template <int D>
__global__ void __launch_bounds__(128) dkv_bf16(BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int TILE = BQ * LD;                  // BQ == BK
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LD]
  __nv_bfloat16* Vs = Ks + TILE;                                    // [BK][LD]
  __nv_bfloat16* Qs = Vs + TILE;                                    // [2][BQ][LD]
  __nv_bfloat16* dOs = Qs + 2 * TILE;                               // [2][BQ][LD]
  float* lss = reinterpret_cast<float*>(dOs + 2 * TILE);             // [2][BQ] lse*log2e
  float* dls = lss + 2 * BQ;                                          // [2][BQ] delta

  const int kt = blockIdx.x;                     // tile 0 has the most live q tiles
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  using bf16 = __nv_bfloat16;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  for (int i = tid; i < BK * CH; i += 128) {     // rows past Skv are zeros
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = k0 + r < a.Skv;
    const long long row = in ? k0 + r : 0;
    cp_async16(Ks + r * LD + c, kp + row * a.k_ss + c, in ? 16 : 0);
    cp_async16(Vs + r * LD + c, vp + row * a.v_ss + c, in ? 16 : 0);
  }
  cp_async_commit();

  int lo, hi;
  q_tile_range(a, k0, lo, hi);
  const int nt = hi - lo, total = G * nt;

  auto load_q = [&](int it, int buf) {           // rows past Sq are zeros
    const int h = kh * G + it / nt, q0 = (lo + it % nt) * BQ;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int i = tid; i < BQ * CH; i += 128) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = q0 + r < a.Sq;
      const long long row = in ? q0 + r : 0;
      cp_async16(Qs + buf * TILE + r * LD + c, qp + row * a.q_ss + c, in ? 16 : 0);
      cp_async16(dOs + buf * TILE + r * LD + c, dop + row * a.do_ss + c, in ? 16 : 0);
    }
    if (tid < BQ) {
      const long long base = ((long long)b * a.H + h) * a.Sq;
      const bool in = q0 + tid < a.Sq;
      lss[buf * BQ + tid] = in ? a.lse[base + q0 + tid] * LOG2E : 0.f;
      dls[buf * BQ + tid] = in ? a.delta[base + q0 + tid] : 0.f;
    }
    cp_async_commit();
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const float sl2 = a.scale * LOG2E;
  const bf16* Kw = Ks + (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;  // A-fragment rows
  const bf16* Vw = Vs + (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;

  if (total > 0) load_q(0, 0);
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int q0 = (lo + it % nt) * BQ;
    if (it + 1 < total) {
      load_q(it + 1, buf ^ 1);                   // buffer freed by the sync that
      cp_async_wait<1>();                        // ended the previous iteration
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * TILE;
    const bf16* dOt = dOs + buf * TILE;
    const float* ls = lss + buf * BQ;
    const float* dl = dls + buf * BQ;

    // S^T = K Q^T: 16 keys x 64 queries per warp
    float s[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, Kw + kk * 16);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t bq[4];
        ldmatrix_x4(bq, Qt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[j], ka, bq[0], bq[1]);
        mma_bf16(s[j + 1], ka, bq[2], bq[3]);
      }
    }
    // P^T = exp(S^T scale - lse) on visible pairs
    const bool inner = interior(a, q0, k0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? kr0 : kr1;
        const int qc = 8 * j + 2 * t + (e & 1);
        s[j][e] = (inner || visible_q(a, q0 + qc, key)) ? exp2f(s[j][e] * sl2 - ls[qc]) : 0.f;
      }
    }
    // dV += P^T dO: P^T's accumulator layout is the A layout; dO B-fragments
    // from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bd[4];
        ldmatrix_x4_trans(bd, dOt + (16 * kk + (mi & 1) * 8 + mr) * LD + 8 * n + (mi >> 1) * 8);
        mma_bf16(dv[n], pa, bd[0], bd[1]);
        mma_bf16(dv[n + 1], pa, bd[2], bd[3]);
      }
    }
    // dP^T = V dO^T
    float dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t va[4];
      ldmatrix_x4(va, Vw + kk * 16);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t bd[4];
        ldmatrix_x4(bd, dOt + (8 * j + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(dp[j], va, bd[0], bd[1]);
        mma_bf16(dp[j + 1], va, bd[2], bd[3]);
      }
    }
    // dS^T = P^T (dP^T - delta) scale, in dp
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        dp[j][e] = s[j][e] * (dp[j][e] - dl[qc]) * a.scale;
      }
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                        pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                        pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                        pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, Qt + (16 * kk + (mi & 1) * 8 + mr) * LD + 8 * n + (mi >> 1) * 8);
        mma_bf16(dk[n], pa, bq[0], bq[1]);
        mma_bf16(dk[n + 1], pa, bq[2], bq[3]);
      }
    }
    __syncthreads();                             // tiles consumed: buffer is free
  }
  cp_async_wait<0>();                            // the K/V copy, when no q tile was live

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dk_sb + kh * a.dk_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dv_sb + kh * a.dv_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (kr0 < a.Skv) {
      *reinterpret_cast<uint32_t*>(dkp + kr0 * a.dk_ss + c) = pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvp + kr0 * a.dv_ss + c) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (kr1 < a.Skv) {
      *reinterpret_cast<uint32_t*>(dkp + kr1 * a.dk_ss + c) = pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvp + kr1 * a.dv_ss + c) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// --------------------------------------------------------------- f32: FMAs

// 256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows ty + 16i
// (i < 4) and, for S and dP, keys tx + 16j (j < 4), for dQ, columns tx + 16j
// (j < D/16).  K and V are stored transposed; K^T also serves dQ = dS K.
template <int D>
__global__ void __launch_bounds__(256) dq_f32(BwdArgs a) {
  constexpr int LQ = D + 1, LK = BK + 1, LS = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][LQ]
  float* dOs = Qs + BQ * LQ;                        // [BQ][LQ]
  float* Kt = dOs + BQ * LQ;                        // [D][LK]
  float* Vt = Kt + D * LK;                          // [D][LK]
  float* dSs = Vt + D * LK;                         // [BQ][LS]

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH, kh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const float* op = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dop = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;

  for (int i = tid; i < BQ * D; i += 256) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < a.Sq;
    Qs[r * LQ + c] = in ? qp[(long long)(q0 + r) * a.q_ss + c] : 0.f;
    dOs[r * LQ + c] = in ? dop[(long long)(q0 + r) * a.do_ss + c] : 0.f;
  }
  __syncthreads();

  // delta = rowsum(dO * O) over the 16 threads (a half-warp) of a row
  const long long row_base = ((long long)b * a.H + h) * a.Sq;
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < a.Sq)
      for (int c = tx; c < D; c += 16) acc = fmaf(dOs[(ty + 16 * i) * LQ + c], op[(long long)row * a.o_ss + c], acc);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
    dl[i] = acc;
    if (tx == 0 && row < a.Sq) a.delta[row_base + row] = acc;
    ls[i] = row < a.Sq ? a.lse[row_base + row] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  int lo, hi;
  kv_tile_range(a, q0, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += 256) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < a.Skv;
      Kt[c * LK + r] = in ? kp[(long long)(k0 + r) * a.k_ss + c] : 0.f;
      Vt[c * LK + r] = in ? vp[(long long)(k0 + r) * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LQ + d];
        dv[i] = dOs[(ty + 16 * i) * LQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Kt[d * LK + tx + 16 * j];
        vv[j] = Vt[d * LK + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(a, row, k0 + tx + 16 * j) ? expf(s[i][j] * a.scale - ls[i]) : 0.f;
        dSs[(ty + 16 * i) * LS + tx + 16 * j] = p * (dp[i][j] - dl[i]) * a.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kv[j] = Kt[(tx + 16 * j) * LK + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* dqp = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqp[(long long)row * a.dq_ss + tx + 16 * j] = acc[i][j];
  }
}

// 256 threads as a 16 x 16 grid; thread (ty, tx) owns keys ty + 16i (i < 4)
// and, for S^T and dP^T, queries tx + 16j (j < 4), for dK and dV, columns
// tx + 16j (j < D/16).  Q and dO tiles are stored transposed.
template <int D>
__global__ void __launch_bounds__(256) dkv_f32(BwdArgs a) {
  constexpr int LK = D + 1, LQ = BQ + 1, LP = BQ + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BK][LK]
  float* Vs = Ks + BK * LK;                         // [BK][LK]
  float* Qt = Vs + BK * LK;                         // [D][LQ]
  float* dOt = Qt + D * LQ;                         // [D][LQ]
  float* Ps = dOt + D * LQ;                         // [BK][LP]
  float* dSs = Ps + BK * LP;                        // [BK][LP]
  float* lss = dSs + BK * LP;                       // [BQ]
  float* dls = lss + BQ;                            // [BQ]

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  for (int i = tid; i < BK * D; i += 256) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < a.Skv;
    Ks[r * LK + c] = in ? kp[(long long)(k0 + r) * a.k_ss + c] : 0.f;
    Vs[r * LK + c] = in ? vp[(long long)(k0 + r) * a.v_ss + c] : 0.f;
  }

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  int lo, hi;
  q_tile_range(a, k0, lo, hi);
  const int nt = hi - lo;
  for (int it = 0; it < G * nt; ++it) {
    const int h = kh * G + it / nt, q0 = (lo + it % nt) * BQ;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dop = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    __syncthreads();
    for (int i = tid; i < BQ * D; i += 256) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < a.Sq;
      Qt[c * LQ + r] = in ? qp[(long long)(q0 + r) * a.q_ss + c] : 0.f;
      dOt[c * LQ + r] = in ? dop[(long long)(q0 + r) * a.do_ss + c] : 0.f;
    }
    if (tid < BQ) {
      const long long base = ((long long)b * a.H + h) * a.Sq;
      const bool in = q0 + tid < a.Sq;
      lss[tid] = in ? a.lse[base + q0 + tid] : 0.f;
      dls[tid] = in ? a.delta[base + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LK + d];
        vv[i] = Vs[(ty + 16 * i) * LK + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qt[d * LQ + tx + 16 * j];
        dov[j] = dOt[d * LQ + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float p = visible_q(a, q0 + qc, key) ? expf(s[i][j] * a.scale - lss[qc]) : 0.f;
        Ps[(ty + 16 * i) * LP + qc] = p;
        dSs[(ty + 16 * i) * LP + qc] = p * (dp[i][j] - dls[qc]) * a.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4], dov[D / 16], qv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty + 16 * i) * LP + qq];
        dsv[i] = dSs[(ty + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        dov[j] = dOt[(tx + 16 * j) * LQ + qq];
        qv[j] = Qt[(tx + 16 * j) * LQ + qq];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.dk_sb + kh * a.dk_sh;
  float* dvp = static_cast<float*>(a.dv) + b * a.dv_sb + kh * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dkp[(long long)key * a.dk_ss + tx + 16 * j] = dk[i][j];
      dvp[(long long)key * a.dv_ss + tx + 16 * j] = dv[i][j];
    }
  }
}

bool valid(int B, int H, int KVH, int Sq, int Skv) {
  return B > 0 && H > 0 && KVH > 0 && H % KVH == 0 && Sq > 0 && Skv > 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Each returns the cudaError_t of its launch
// (0 = ok); 1000 for a shape or dtype the kernel does not take.

// dq (written through its strides) and delta (B,H,Sq) f32.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq,
                         int B, int H, int KVH, int Sq, int Skv, int D,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         long long do_sb, long long do_sh, long long do_ss,
                         long long dq_sb, long long dq_sh, long long dq_ss,
                         int window, int causal_shift, int dtype, void* stream) {
  if (!valid(B, H, KVH, Sq, Skv)) return 1000;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, B, H, KVH, Sq, Skv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, 0, 0, 0, 0, 0, 0,
            window, causal_shift, 1.0f / sqrtf((float)D)};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // K and V tiles double-buffered, one dO tile, delta
    auto smem = [](int d) { return (size_t)(5 * BK * (d + 8)) * 2 + BQ * 4; };
    if (D == 64) return launch(dq_bf16<64>, grid, 128, smem(64), st, a);
    if (D == 128) return launch(dq_bf16<128>, grid, 128, smem(128), st, a);
  } else if (dtype == 0) {
    auto smem = [](int d) { return (size_t)(2 * BQ * (d + 1) + 2 * d * (BK + 1) + BQ * (BK + 1)) * 4; };
    if (D == 64) return launch(dq_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(dq_f32<128>, grid, 256, smem(128), st, a);
  }
  return 1000;
}

// dk, dv (written through their strides); reads the delta that fa_bwd_dq wrote.
extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv,
                          int B, int H, int KVH, int Sq, int Skv, int D,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long do_sb, long long do_sh, long long do_ss,
                          long long dk_sb, long long dk_sh, long long dk_ss,
                          long long dv_sb, long long dv_sh, long long dv_ss,
                          int window, int causal_shift, int dtype, void* stream) {
  if (!valid(B, H, KVH, Sq, Skv)) return 1000;
  BwdArgs a{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
            B, H, KVH, Sq, Skv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, 0, 0, 0,
            do_sb, do_sh, do_ss, 0, 0, 0, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
            window, causal_shift, 1.0f / sqrtf((float)D)};
  dim3 grid((Skv + BK - 1) / BK, KVH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // K and V tiles, Q and dO tiles double-buffered, lse and delta double-buffered
    auto smem = [](int d) { return (size_t)(6 * BK * (d + 8)) * 2 + 4 * BQ * 4; };
    if (D == 64) return launch(dkv_bf16<64>, grid, 128, smem(64), st, a);
    if (D == 128) return launch(dkv_bf16<128>, grid, 128, smem(128), st, a);
  } else if (dtype == 0) {
    auto smem = [](int d) {
      return (size_t)(2 * BK * (d + 1) + 2 * d * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ) * 4;
    };
    if (D == 64) return launch(dkv_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(dkv_f32<128>, grid, 256, smem(128), st, a);
  }
  return 1000;
}
