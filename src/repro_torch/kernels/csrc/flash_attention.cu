// Flash-attention forward for Hopper (sm_90a): causal GQA attention with an
// optional sliding window and a causal shift.  Returns o and the f32 lse.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (reached through flash_attention_fwd).
//
// What bounds it on the H100: operations.  At the serving prefill shape
// (H=12, KVH=2, S=3000, D=128, causal) one layer needs ~27.6 GFLOP of QK^T
// and PV products against ~9 MB of q/k/v/o traffic, far above the card's
// ~295 FLOP/byte ridge, so the kernel is as fast as its tensor cores are
// kept busy.  Only wgmma reaches their full rate, and only if the tiles
// arrive without the math warps spending issue slots on copies.
//
// The bf16 design (fwd_bf16): one block of 384 threads per (b, h, 128 query
// rows), heaviest query tiles first.  Warpgroup 0 is the producer: after
// setmaxnreg drops it to 24 registers, one thread loads the block's Q tile
// once and then K and V tiles with TMA into a ring of three slots (two at
// D = 256), each guarded by a full and an empty mbarrier.  Warpgroups 1 and
// 2 are the consumers, 64 query rows each (240 registers).  Per K/V tile:
// S = Q K^T with wgmma m64nBKk16 (A = Q, B = K, both K-major from shared
// memory); the online softmax in registers, the scale folded into one FFMA
// of the exponent (2^(s sl2 - m sl2), m the running raw maximum); then
// O += P V with P packed in registers into the bf16 A fragment and V read
// MN-major through the transpose flag.  Each consumer pipelines as FA3 does:
// S_i is issued ahead of P_{i-1} V_{i-1}, so the softmax of tile i runs
// while the tensor cores finish tile i-1; the two consumers also interleave.
// A KV tile is BK = 128 keys at D <= 128; at D = 256, BK = 64, so that Q
// (64 KB) and two slots of K and V (128 KB) fit in shared memory and the
// 64 x 256 f32 accumulator (128 registers) leaves room for S and P.  Only
// tiles on the diagonal or the window's edge are masked; tiles that the mask
// hides entirely are skipped by the loop bounds.  P is rounded to bf16 for
// the PV product, as before; everything else is f32.  The f32 path (fwd_f32)
// uses plain FMAs so that it keeps full f32 accuracy (the tensor cores would
// give TF32).  Helpers, and the places where such kernels go wrong (and how
// ptxas must see the code to keep wgmma asynchronous): hopper_common.cuh.
//
// Layouts: q (B,H,Sq,D), k/v (B,KVH,Skv,D), o (B,H,Sq,D), each addressed by
// (batch, head, row) strides in elements with D contiguous; lse (B,H,Sq)
// contiguous.  Query head h reads KV head h / G.  Query row i sits at
// absolute position i + causal_shift.
#include "hopper_common.cuh"

namespace {

struct Args {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int B, H, KVH, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int window;        // <= 0: no window
  int causal_shift;
  float scale;       // 1/sqrt(D)
};

// ------------------------------------------------- bf16: TMA, wgmma, warp-specialised

constexpr int FWD_BQ = 128;        // query rows per block: two consumer warpgroups of 64

template <int D>
struct FwdTile {
  static constexpr int BK = D == 256 ? 64 : 128;          // keys per K/V tile
  static constexpr int PANELS = D / 64;                   // 128-byte panels per row
  static constexpr int STAGES = D == 256 ? 2 : 3;         // what shared memory holds
  static constexpr int Q_BYTES = FWD_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;             // one K or one V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 64;
};

struct FwdParams {
  CUtensorMap tq, tk, tv;          // boxes of 64 columns by FWD_BQ (q) or BK rows
  Args a;
};

// D is the tile's head dim (64, 128, 256); DH the tensors' (D, or 32 in a
// 64-column tile: TMA fills the columns past 32 with zeros, so they add
// nothing to Q K^T and give zero columns of O, which are not stored).
template <int D, int DH = D>
__global__ void __launch_bounds__(384, 1) fwd_bf16(const __grid_constant__ FwdParams p) {
  using T = FwdTile<D>;
  constexpr int BK = T::BK;
  using bf16 = __nv_bfloat16;
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);          // [PANELS][FWD_BQ][64], swizzled
  bf16* Ks = Qs + FWD_BQ * D;                        // [STAGES][PANELS][BK][64]
  bf16* Vs = Ks + T::STAGES * BK * D;                // [STAGES][PANELS][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + T::STAGES * BK * D);
  uint64_t* q_full = bars;                           // Q arrived
  uint64_t* full = bars + 1;                         // [STAGES] K and V arrived
  uint64_t* empty = bars + 1 + T::STAGES;            // [STAGES] both consumers done

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BQ;   // heaviest tiles first
  const int kh = h / (a.H / a.KVH);
  int lo, hi;
  kv_tile_range(a, q0, lo, hi, FWD_BQ, BK);
  const int n = max(0, hi - lo);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);             // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // warpgroup 0 produces, 1 and 2 consume; the role must be provably
  // warp-uniform and the two paths must not rejoin, or ptxas ignores
  // setmaxnreg and holds the consumers to the launch's 168 registers
  const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    hopper::setmaxnreg_dec<hopper::PRODUCER_REGS>();
    if (threadIdx.x == 0 && n > 0) {
      hopper::mbar_arrive_expect(q_full, T::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn)
        hopper::tma_load(Qs + pn * FWD_BQ * 64, &p.tq, q_full, pn * 64, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        hopper::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect(&full[s], 2 * T::KV_BYTES);
        const int k0 = (lo + i) * BK;
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          hopper::tma_load(Ks + (s * T::PANELS + pn) * BK * 64, &p.tk, &full[s], pn * 64, k0, kh, b);
          hopper::tma_load(Vs + (s * T::PANELS + pn) * BK * 64, &p.tv, &full[s], pn * 64, k0, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
    hopper::setmaxnreg_inc<hopper::CONSUMER_REGS>();
    const int cw = role - 1;                           // warp-uniform, as ptxas must see it
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int qw = q0 + 64 * cw;                       // this warpgroup's first row
    const int r0 = qw + 16 * warp + g, r1 = r0 + 8;
    int wlo, whi;                                      // the tiles this warpgroup needs
    kv_tile_range(a, qw, wlo, whi, 64, BK);
    if (qw >= a.Sq) whi = wlo;                         // rows past Sq: nothing to compute
    const float sl2 = a.scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // m raw scores; l per thread

    // Software pipeline (per warpgroup), FA3's order: S_i = Q K_i^T is
    // issued, then O += P_{i-1} V_{i-1}; the softmax of S_i runs while the
    // tensor cores still work on P_{i-1} V_{i-1}, and P_i is packed into the
    // A fragments only after that product has finished reading them.  The
    // tiles this warpgroup needs, [jlo, jhi), are walked as a first tile, a
    // steady loop and a last PV product, so that at every point of the code
    // the same products are in flight (where ptxas cannot tell, or where a
    // register of an unfinished product is written, it serialises wgmma).
    const uint32_t q_addr = smem_addr(Qs) + 64 * cw * 128;
    const int jlo = max(lo, wlo), jhi = max(jlo, min(hi, whi));
    uint32_t pa[BK / 16][4];                           // P as bf16 A fragments
    float c0, c1;                                      // this tile's rescaling of O

    auto issue_s = [&](float (&sc)[BK / 2], int st) {  // S = Q K^T, D/16 k16 steps
      const uint32_t k_addr = smem_addr(Ks + st * T::PANELS * BK * 64);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(q_addr + (kk / 4) * FWD_BQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
        if constexpr (BK == 128) hopper::wgmma_ss_n128<0>(sc, da, db, kk);
        else hopper::wgmma_ss_n64<0>(sc, da, db, kk);
      }
      hopper::wgmma_commit();
    };
    auto issue_pv = [&](int st) {                      // O += P V; V MN-major, panels LBO apart
      const uint32_t v_addr = smem_addr(Vs + st * T::PANELS * BK * 64);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
        if constexpr (D == 64) hopper::wgmma_rs_n64<1>(o, pa[kk], db, 1);
        else if constexpr (D == 128) hopper::wgmma_rs_n128<1>(o, pa[kk], db, 1);
        else hopper::wgmma_rs_n256<1>(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
    };
    // Online softmax of S (raw scores, masked on edge tiles only) into p,
    // c0, c1: p = 2^(s sl2 - m sl2) with m the running raw maximum, so the
    // scale costs one FFMA.  A masked score counts as NEG_INF.
    // (masked is a literal at each call: the inlined copies fold it away)
    auto softmax_as = [&](bool masked, const float (&sc)[BK / 2], float (&p)[BK / 2], int k0) {
      auto score = [&](int j, int e) {
        return !masked || visible(a, e < 2 ? r0 : r1, k0 + 8 * j + 2 * c + (e & 1)) ? sc[4 * j + e]
                                                                                   : NEG_INF;
      };
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(score(j, 0), score(j, 1)));
        mx1 = fmaxf(mx1, fmaxf(score(j, 2), score(j, 3)));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
      }
      c0 = hopper::ex2((m0 - mx0) * sl2);
      c1 = hopper::ex2((m1 - mx1) * sl2);
      m0 = mx0; m1 = mx1;
      // a row with no visible key yet: offset 0, so that its masked scores
      // give 2^(NEG_INF sl2) = 0 (fmaf would leave the product's rounding
      // error of NEG_INF sl2 - NEG_INF sl2, which may overflow 2^x)
      const float b0 = mx0 == NEG_INF ? 0.f : -mx0 * sl2;
      const float b1 = mx1 == NEG_INF ? 0.f : -mx1 * sl2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        p[4 * j] = hopper::ex2(fmaf(score(j, 0), sl2, b0));
        p[4 * j + 1] = hopper::ex2(fmaf(score(j, 1), sl2, b0));
        p[4 * j + 2] = hopper::ex2(fmaf(score(j, 2), sl2, b1));
        p[4 * j + 3] = hopper::ex2(fmaf(score(j, 3), sl2, b1));
        sum0 += p[4 * j] + p[4 * j + 1];
        sum1 += p[4 * j + 2] + p[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
    };
    auto softmax = [&](const float (&sc)[BK / 2], float (&p)[BK / 2], int k0) {
      const bool interior = k0 + BK - 1 <= qw + a.causal_shift && k0 + BK <= a.Skv &&
                            (a.window <= 0 || k0 > qw + 63 + a.causal_shift - a.window);
      if (interior) softmax_as(false, sc, p, k0);
      else softmax_as(true, sc, p, k0);
    };
    auto pack_p = [&](const float (&p)[BK / 2]) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
      }
    };

    if (n > 0) hopper::mbar_wait(q_full, 0);
    int i = 0;
    for (; lo + i < jlo; ++i) {                        // tiles with no key visible here
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }
    if (jlo < jhi) {
      int prev = i % T::STAGES;                        // first tile: S and softmax alone
      hopper::mbar_wait(&full[prev], (i / T::STAGES) & 1);
      {
        float sc[BK / 2], p[BK / 2];
        hopper::wgmma_fence();
        issue_s(sc, prev);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        softmax(sc, p, (lo + i) * BK);                 // O is still 0: nothing to rescale
        pack_p(p);
      }
      for (++i; lo + i < jhi; ++i) {
        const int s = i % T::STAGES;
        hopper::mbar_wait(&full[s], (i / T::STAGES) & 1);
        float sc[BK / 2], p[BK / 2];
        hopper::wgmma_fence();
        issue_s(sc, s);
        issue_pv(prev);
        hopper::wgmma_wait<1>();                       // S done; P_{i-1} V_{i-1} may run on
        hopper::fence_regs(sc);
        softmax(sc, p, (lo + i) * BK);
        hopper::wgmma_wait<0>();                       // O holds P_{i-1} V_{i-1}
        hopper::fence_regs(o);
        hopper::mbar_arrive(&empty[prev]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= c0; o[4 * j + 1] *= c0; o[4 * j + 2] *= c1; o[4 * j + 3] *= c1;
        }
        pack_p(p);
        prev = s;
      }
      hopper::wgmma_fence();                           // the last PV product
      issue_pv(prev);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[prev]);
    }
    for (; i < n; ++i) {                               // tiles past the last visible key
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }

    // the row sums are per thread: add the four threads of a row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffff, l0, off);
      l1 += __shfl_xor_sync(0xffffffff, l1, off);
    }
    const float il0 = 1.f / fmaxf(l0, 1e-30f), il1 = 1.f / fmaxf(l1, 1e-30f);
    bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + r0 * a.o_ss + col) = pack_bf16(o[4 * j] * il0, o[4 * j + 1] * il0);
      if (r1 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + r1 * a.o_ss + col) = pack_bf16(o[4 * j + 2] * il1, o[4 * j + 3] * il1);
    }
    if (c == 0) {
      float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
      // m is a raw score; a row that saw no visible key keeps NEG_INF as is
      if (r0 < a.Sq) lp[r0] = (m0 == NEG_INF ? NEG_INF : m0 * a.scale) + logf(fmaxf(l0, 1e-30f));
      if (r1 < a.Sq) lp[r1] = (m1 == NEG_INF ? NEG_INF : m1 * a.scale) + logf(fmaxf(l1, 1e-30f));
    }
  }
}

template <int D, int DH = D>
int launch_fwd_bf16(const Args& a, cudaStream_t st) {
  using T = FwdTile<D>;
  FwdParams p;
  p.a = a;
  if (!hopper::make_map(&p.tq, a.q, a.B, a.H, a.Sq, DH, a.q_sb, a.q_sh, a.q_ss, FWD_BQ) ||
      !hopper::make_map(&p.tk, a.k, a.B, a.KVH, a.Skv, DH, a.k_sb, a.k_sh, a.k_ss, T::BK) ||
      !hopper::make_map(&p.tv, a.v, a.B, a.KVH, a.Skv, DH, a.v_sb, a.v_sh, a.v_ss, T::BK))
    return 1001;
  dim3 grid(a.H, (a.Sq + FWD_BQ - 1) / FWD_BQ, a.B);
  return launch(fwd_bf16<D, DH>, grid, 384, T::SMEM, st, p);
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
// 1000 for a shape or dtype this kernel does not take, 1001 if
// cuTensorMapEncodeTiled refuses a tensor map.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 32) return launch_fwd_bf16<64, 32>(a, st);
    if (D == 64) return launch_fwd_bf16<64>(a, st);
    if (D == 128) return launch_fwd_bf16<128>(a, st);
    if (D == 256) return launch_fwd_bf16<256>(a, st);
  } else if (dtype == 0) {
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    auto smem = [](int d) { return (size_t)(BQ * (d + 1) + d * (BK + 1) + BK * d + BQ * (BK + 1)) * 4; };
    if (D == 32) return launch(fwd_f32<32>, grid, 256, smem(32), st, a);
    if (D == 64) return launch(fwd_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(fwd_f32<128>, grid, 256, smem(128), st, a);
    if (D == 256) return launch(fwd_f32<256>, grid, 256, smem(256), st, a);
  }
  return 1000;
}
