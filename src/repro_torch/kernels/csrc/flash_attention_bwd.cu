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
// tensors.  In the bf16 kernels P and dS are rounded to bf16 where they feed
// a product (as the forward rounds P); every sum is f32.  The f32 paths
// (dq_f32, dkv_f32) use FMAs so that they keep full f32 accuracy (the tensor
// cores would give TF32).
//
// dq    (dq_bf16) one block of 384 threads per (b, query head h, 128-row q
//       tile), heaviest q tiles first, as the forward: 384 blocks at the
//       training shape.  Warpgroup 0 is the producer (24 registers): one
//       thread loads the block's Q and dO tiles once and then the live
//       64-key K and V tiles with TMA into a ring of four slots, guarded by
//       full and empty mbarriers.  Warpgroups 1 and 2 (240 registers) own
//       64 query rows each.  Each first computes delta = rowsum(dO * O) for
//       its rows (the reference does this outside its Pallas kernels),
//       writes it for dk/dv and keeps it in registers; then, per KV tile,
//       S = Q K^T and dP = dO V^T with wgmma m64n64k16 (A = Q or dO, B = K
//       or V, all K-major from shared memory), P = 2^(S scale log2e - lse
//       log2e) (masked on the diagonal and window-edge tiles only) and
//       dS = P (dP - delta) scale in registers, and dQ += dS K with dS as
//       the register A fragment and K read MN-major through the transpose
//       flag.  S and dP of a tile are issued ahead of the previous tile's dQ
//       product, so dS is formed while the tensor cores still work.  64-key
//       tiles keep dQ (64 x D f32), S, dP and the dS fragment within the
//       consumers' registers.  dQ stays in registers for the whole walk and
//       is written once: no atomics, so two runs give the same bits.
// dk/dv (dkv_bf16, then dkv_reduce) reads the delta that dq wrote, so it is
//       launched after dq on the same stream.  The Pallas kernel walks the G
//       query heads of a KV head and its q tiles along a sequential grid axis,
//       summing dk and dv in scratch.  Blocks of a GPU run in no order, and
//       one block per (b, kv head, k tile) is too few to fill 132 SMs (128 at
//       the training shape) and badly balanced under the causal mask.  So:
//       one block of 384 threads per (b, query head h, 128-row k tile),
//       heaviest k tiles first: 384 blocks at the training shape, none
//       walking more than twice the mean number of q tiles.  Warpgroup 0 is
//       the producer (24 registers): one thread loads the block's K and V
//       tiles once and then, for each live 64-row q tile, Q and dO with TMA
//       into a ring of three slots, while the warp's lanes copy that tile's
//       lse (times log2 e) and delta beside them; full and empty mbarriers
//       guard each slot.  Warpgroups 1 and 2 (240 registers) own 64 keys
//       each and, per q tile, run S^T = K Q^T and dP^T = V dO^T with wgmma
//       m64n64k16 (A = K or V, B = Q or dO, all K-major from shared memory),
//       form P^T = 2^(S^T scale log2e - lse log2e) (masked on the diagonal
//       and window-edge tiles only) and dS^T = P^T (dP^T - delta) scale in
//       registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//       register A fragments and dO, Q read MN-major through the transpose
//       flag.  The products are staggered: S^T is queued behind the previous
//       tile's dV and dK, and dP^T runs while P^T is formed.  dK and dV
//       (64 x D f32 each) stay in registers for the whole walk and are
//       written once, as the f32 partial of query head h, into scratch
//       (2, B, H, Skv, D) that the wrapper allocates.  dkv_reduce then adds
//       the G partials of each KV head in a fixed order (g = 0 .. G-1) and
//       writes bf16 dk and dv through their strides: no atomics, so two runs
//       give the same bits.  Both launches are one call of fa_bwd_dkv.
//       Helpers, and the places where such kernels go wrong (and how ptxas
//       must see the code to keep wgmma asynchronous): hopper_common.cuh.
//
// Layouts: q, o, do, dq (B,H,Sq,D); k, v, dk, dv (B,KVH,Skv,D), each
// addressed by (batch, head, row) strides in elements with D contiguous; lse
// and delta (B,H,Sq) f32 contiguous.  Query head h reads KV head h / G.
// Query row i sits at absolute position i + causal_shift.
#include "hopper_common.cuh"

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
// [k0, k0 + keys).
__device__ __forceinline__ void q_tile_range(const BwdArgs& a, int k0, int& lo, int& hi,
                                             int keys = BK) {
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int first = k0 - a.causal_shift;                     // smallest query
  lo = first <= 0 ? 0 : min(nq, first / BQ);
  hi = nq;
  if (a.window > 0) {
    const int last = min(k0 + keys, a.Skv) - 1 + a.window - 1 - a.causal_shift;
    hi = last < 0 ? 0 : min(nq, last / BQ + 1);
  }
  if (hi < lo) hi = lo;
}

__device__ __forceinline__ bool visible_q(const BwdArgs& a, int row, int col) {
  return row < a.Sq && visible(a, row, col);
}

// ------------------------------------------ dq bf16: TMA, wgmma, warp-specialised

constexpr int DQ_BQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int DQ_BK = 64;          // keys per K/V tile

template <int D>
struct DqTile {
  static constexpr int PANELS = D / 64;                   // 128-byte panels per row
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = DQ_BQ * D * 2;           // the Q or the dO tile
  static constexpr int KV_BYTES = DQ_BK * D * 2;          // one K or one V tile
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 128;
};

struct DqParams {
  CUtensorMap tq, tdo;             // boxes of 64 columns by DQ_BQ rows
  CUtensorMap tk, tv;              // boxes of 64 columns by DQ_BK rows
  BwdArgs a;
};

// D is the tile's head dim (64, 128); DH the tensors' (D, or 32 in a
// 64-column tile, whose columns past 32 TMA fills with zeros).
template <int D, int DH = D>
__global__ void __launch_bounds__(384, 1) dq_bf16(const __grid_constant__ DqParams p) {
  using T = DqTile<D>;
  using bf16 = __nv_bfloat16;
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);          // [PANELS][DQ_BQ][64], swizzled
  bf16* dOs = Qs + DQ_BQ * D;                        // [PANELS][DQ_BQ][64]
  bf16* Ks = dOs + DQ_BQ * D;                        // [STAGES][PANELS][DQ_BK][64]
  bf16* Vs = Ks + T::STAGES * DQ_BK * D;             // [STAGES][PANELS][DQ_BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + T::STAGES * DQ_BK * D);
  uint64_t* q_full = bars;                           // Q and dO arrived
  uint64_t* full = bars + 1;                         // [STAGES] K and V arrived
  uint64_t* empty = bars + 1 + T::STAGES;            // [STAGES] both consumers done

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;   // heaviest tiles first
  const int kh = h / (a.H / a.KVH);
  int lo, hi;
  kv_tile_range(a, q0, lo, hi, DQ_BQ, DQ_BK);
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
      hopper::mbar_arrive_expect(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        hopper::tma_load(Qs + pn * DQ_BQ * 64, &p.tq, q_full, pn * 64, q0, h, b);
        hopper::tma_load(dOs + pn * DQ_BQ * 64, &p.tdo, q_full, pn * 64, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        hopper::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect(&full[s], 2 * T::KV_BYTES);
        const int k0 = (lo + i) * DQ_BK;
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          hopper::tma_load(Ks + (s * T::PANELS + pn) * DQ_BK * 64, &p.tk, &full[s], pn * 64, k0, kh, b);
          hopper::tma_load(Vs + (s * T::PANELS + pn) * DQ_BK * 64, &p.tv, &full[s], pn * 64, k0, kh, b);
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
    kv_tile_range(a, qw, wlo, whi, 64, DQ_BK);
    if (qw >= a.Sq) whi = wlo;                         // rows past Sq: nothing to compute
    const float sl2 = a.scale * LOG2E;

    // delta = rowsum(dO * O) of rows r0 and r1 in f32, from device memory
    // (the block's dO tile is still in flight): the four threads of a row
    // read its 16-byte chunks c, c + 4, ... and add across the quad.  It is
    // written for dk/dv and kept in registers.
    const long long base = ((long long)b * a.H + h) * a.Sq;
    const bf16* op = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
    const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    auto rowdot = [&](int row) {
      float acc = 0.f;
      if (row < a.Sq) {
#pragma unroll
        for (int m = 0; m < DH / 32; ++m) {
          const int col = (c + 4 * m) * 8;
          const uint4 ov = *reinterpret_cast<const uint4*>(op + row * a.o_ss + col);
          const uint4 dv = *reinterpret_cast<const uint4*>(dop + row * a.do_ss + col);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
            acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffff, acc, 1);
      acc += __shfl_xor_sync(0xffffffff, acc, 2);
      return acc;
    };
    const float dl0 = rowdot(r0), dl1 = rowdot(r1);
    if (c == 0) {
      if (r0 < a.Sq) a.delta[base + r0] = dl0;
      if (r1 < a.Sq) a.delta[base + r1] = dl1;
    }
    // rows past Sq: lse 0 and zero Q and dO give finite P and zero dS
    const float nls0 = r0 < a.Sq ? -a.lse[base + r0] * LOG2E : 0.f;
    const float nls1 = r1 < a.Sq ? -a.lse[base + r1] * LOG2E : 0.f;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // Per KV tile: S = Q K^T and dP = dO V^T (A = Q or dO, B = K or V, all
    // K-major from shared memory); dS = P (dP - delta) scale in registers;
    // dQ += dS K with dS as the register A fragment and K read MN-major
    // through the transpose flag, so one K tile serves both of its products.
    // Staggered as the forward's S and P V: S and dP of tile j are issued
    // ahead of dQ += dS_{j-1} K_{j-1}, dS_j is formed while that product
    // runs, and packed into the A fragments only after it has finished
    // reading them.  The tiles [jlo, jhi) are walked as a first tile, a
    // steady loop and a last dQ product, so that the same products are in
    // flight at every point of the code (hopper_common.cuh).
    const uint32_t q_addr = smem_addr(Qs) + 64 * cw * 128;
    const uint32_t do_addr = smem_addr(dOs) + 64 * cw * 128;
    const int jlo = max(lo, wlo), jhi = max(jlo, min(hi, whi));
    uint32_t da[4][4];                                 // dS as bf16 A fragments

    auto issue_sdp = [&](float (&st)[32], float (&dpt)[32], int s) {
      const uint32_t k_addr = smem_addr(Ks + s * T::PANELS * DQ_BK * 64);
      const uint32_t v_addr = smem_addr(Vs + s * T::PANELS * DQ_BK * 64);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32;
        const uint32_t ka = (kk / 4) * DQ_BK * 128 + (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(st, hopper::desc_sw128(q_addr + qa, 16, 1024),
                                hopper::desc_sw128(k_addr + ka, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32;
        const uint32_t ka = (kk / 4) * DQ_BK * 128 + (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(dpt, hopper::desc_sw128(do_addr + qa, 16, 1024),
                                hopper::desc_sw128(v_addr + ka, 16, 1024), kk);
      }
      hopper::wgmma_commit();
    };
    auto issue_dq = [&](int s) {                       // K MN-major, panels DQ_BK rows apart
      const uint32_t k_addr = smem_addr(Ks + s * T::PANELS * DQ_BK * 64);
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(k_addr + kk * 16 * 128, DQ_BK * 128, 1024);
        if constexpr (D == 64) hopper::wgmma_rs_n64<1>(dq, da[kk], db, 1);
        else hopper::wgmma_rs_n128<1>(dq, da[kk], db, 1);
      }
      hopper::wgmma_commit();
    };
    // dS = P (dP - delta) scale into st, P = 2^(S sl2 - lse log2e) on
    // visible pairs (register 4j + e: row r0 or r1, key 8j + 2c + (e & 1)),
    // masked on edge tiles only (masked is a literal at each call: the
    // inlined copies fold it away)
    auto ds_as = [&](bool masked, float (&st)[32], const float (&dpt)[32], int k0) {
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = hopper::ex2(fmaf(st[4 * j + e], sl2, e < 2 ? nls0 : nls1));
          if (masked && !visible(a, e < 2 ? r0 : r1, k0 + 8 * j + 2 * c + (e & 1))) pv = 0.f;
          st[4 * j + e] = pv * (dpt[4 * j + e] - (e < 2 ? dl0 : dl1)) * a.scale;
        }
      }
    };
    auto ds = [&](float (&st)[32], const float (&dpt)[32], int k0) {
      const bool interior = k0 + DQ_BK - 1 <= qw + a.causal_shift && k0 + DQ_BK <= a.Skv &&
                            (a.window <= 0 || k0 > qw + 63 + a.causal_shift - a.window);
      if (interior) ds_as(false, st, dpt, k0);
      else ds_as(true, st, dpt, k0);
    };
    auto pack_ds = [&](const float (&st)[32]) {
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j) {
        da[j / 2][(j & 1) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
        da[j / 2][(j & 1) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      }
    };

    if (n > 0) hopper::mbar_wait(q_full, 0);
    int i = 0;
    for (; lo + i < jlo; ++i) {                        // tiles with no key visible here
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }
    if (jlo < jhi) {
      int prev = i % T::STAGES;                        // first tile: S, dP and dS alone
      hopper::mbar_wait(&full[prev], (i / T::STAGES) & 1);
      {
        float st[32], dpt[32];
        hopper::wgmma_fence();
        issue_sdp(st, dpt, prev);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        ds(st, dpt, (lo + i) * DQ_BK);
        pack_ds(st);
      }
      for (++i; lo + i < jhi; ++i) {
        const int s = i % T::STAGES;
        hopper::mbar_wait(&full[s], (i / T::STAGES) & 1);
        float st[32], dpt[32];
        hopper::wgmma_fence();
        issue_sdp(st, dpt, s);
        issue_dq(prev);
        hopper::wgmma_wait<1>();                       // S, dP done; dQ += dS K may run on
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        ds(st, dpt, (lo + i) * DQ_BK);
        hopper::wgmma_wait<0>();                       // dQ holds the previous tile
        hopper::fence_regs(dq);
        hopper::mbar_arrive(&empty[prev]);
        pack_ds(st);
        prev = s;
      }
      hopper::wgmma_fence();                           // the last dQ product
      issue_dq(prev);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      hopper::mbar_arrive(&empty[prev]);
    }
    for (; i < n; ++i) {                               // tiles past the last visible key
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }

    bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(dqp + r0 * a.dq_ss + col) = pack_bf16(dq[4 * j], dq[4 * j + 1]);
      if (r1 < a.Sq)
        *reinterpret_cast<uint32_t*>(dqp + r1 * a.dq_ss + col) = pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

template <int D, int DH = D>
int launch_dq_bf16(const BwdArgs& a, cudaStream_t st) {
  DqParams p;
  p.a = a;
  if (!hopper::make_map(&p.tq, a.q, a.B, a.H, a.Sq, DH, a.q_sb, a.q_sh, a.q_ss, DQ_BQ) ||
      !hopper::make_map(&p.tdo, a.dout, a.B, a.H, a.Sq, DH, a.do_sb, a.do_sh, a.do_ss, DQ_BQ) ||
      !hopper::make_map(&p.tk, a.k, a.B, a.KVH, a.Skv, DH, a.k_sb, a.k_sh, a.k_ss, DQ_BK) ||
      !hopper::make_map(&p.tv, a.v, a.B, a.KVH, a.Skv, DH, a.v_sb, a.v_sh, a.v_ss, DQ_BK))
    return 1001;
  dim3 grid(a.H, (a.Sq + DQ_BQ - 1) / DQ_BQ, a.B);
  return launch(dq_bf16<D, DH>, grid, 384, DqTile<D>::SMEM, st, p);
}

// ------------------------------------------ dk/dv bf16: TMA, wgmma, warp-specialised

constexpr int DKV_BK = 128;        // keys per block: two consumer warpgroups of 64
constexpr int DKV_BQ = BQ;         // queries per tile of the walk (64, as q_tile_range)

template <int D>
struct DkvTile {
  static constexpr int PANELS = D / 64;                   // 128-byte panels per row
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = DKV_BK * D * 2;         // the K or the V tile
  static constexpr int QT_BYTES = DKV_BQ * D * 2;         // one Q or one dO tile
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * 2 * QT_BYTES +
                              STAGES * 2 * DKV_BQ * 4 + 1024 + 64;
};

struct DkvParams {
  CUtensorMap tq, tdo;             // boxes of 64 columns by DKV_BQ rows
  CUtensorMap tk, tv;              // boxes of 64 columns by DKV_BK rows
  BwdArgs a;
  float* part;                     // (2, B, H, Skv, D): dk, then dv, per query head
};

// D is the tile's head dim (64, 128); DH the tensors' and the partials' (D,
// or 32 in a 64-column tile, whose columns past 32 TMA fills with zeros).
template <int D, int DH = D>
__global__ void __launch_bounds__(384, 1) dkv_bf16(const __grid_constant__ DkvParams p) {
  using T = DkvTile<D>;
  using bf16 = __nv_bfloat16;
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);          // [PANELS][DKV_BK][64], swizzled
  bf16* Vs = Ks + DKV_BK * D;                        // [PANELS][DKV_BK][64]
  bf16* Qs = Vs + DKV_BK * D;                        // [STAGES][PANELS][DKV_BQ][64]
  bf16* dOs = Qs + T::STAGES * DKV_BQ * D;           // [STAGES][PANELS][DKV_BQ][64]
  float* lss = reinterpret_cast<float*>(dOs + T::STAGES * DKV_BQ * D);   // [STAGES][DKV_BQ]
  float* dls = lss + T::STAGES * DKV_BQ;                                  // [STAGES][DKV_BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + T::STAGES * DKV_BQ);
  uint64_t* kv_full = bars;                          // K and V arrived
  uint64_t* full = bars + 1;                         // [STAGES] Q, dO, lse, delta arrived
  uint64_t* empty = bars + 1 + T::STAGES;            // [STAGES] both consumers done

  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * DKV_BK;                // tile 0 has the most live q tiles
  const int kh = h / (a.H / a.KVH);
  int lo, hi;
  q_tile_range(a, k0, lo, hi, DKV_BK);
  const int n = hi - lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 33);               // the TMA thread twice, 32 lanes once
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
    // ---- producer: warp 0 keeps the ring full
    hopper::setmaxnreg_dec<hopper::PRODUCER_REGS>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && n > 0) {
      if (lane == 0) {
        hopper::mbar_arrive_expect(kv_full, 2 * T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          hopper::tma_load(Ks + pn * DKV_BK * 64, &p.tk, kv_full, pn * 64, k0, kh, b);
          hopper::tma_load(Vs + pn * DKV_BK * 64, &p.tv, kv_full, pn * 64, k0, kh, b);
        }
      }
      const long long base = ((long long)b * a.H + h) * a.Sq;
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        const int q0 = (lo + i) * DKV_BQ;
        // this tile's lse (times log2 e) and delta, read before the slot is
        // free.  Rows past Sq: lse 0 and delta 0 with the zero rows of Q and
        // dO give P = 1 but dV and dK contributions of exactly 0.
        float lsv[DKV_BQ / 32], dlv[DKV_BQ / 32];
#pragma unroll
        for (int r = 0; r < DKV_BQ / 32; ++r) {
          const int row = q0 + lane + 32 * r;
          lsv[r] = row < a.Sq ? a.lse[base + row] * LOG2E : 0.f;
          dlv[r] = row < a.Sq ? a.delta[base + row] : 0.f;
        }
        hopper::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect(&full[s], 2 * T::QT_BYTES);
#pragma unroll
          for (int pn = 0; pn < T::PANELS; ++pn) {
            hopper::tma_load(Qs + (s * T::PANELS + pn) * DKV_BQ * 64, &p.tq, &full[s], pn * 64, q0, h, b);
            hopper::tma_load(dOs + (s * T::PANELS + pn) * DKV_BQ * 64, &p.tdo, &full[s], pn * 64, q0, h, b);
          }
        }
#pragma unroll
        for (int r = 0; r < DKV_BQ / 32; ++r) {
          lss[s * DKV_BQ + lane + 32 * r] = lsv[r];
          dls[s * DKV_BQ + lane + 32 * r] = dlv[r];
        }
        hopper::mbar_arrive(&full[s]);               // releases this lane's stores
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63
    hopper::setmaxnreg_inc<hopper::CONSUMER_REGS>();
    const int cw = role - 1;                           // warp-uniform, as ptxas must see it
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int kw = k0 + 64 * cw;                       // this warpgroup's first key
    const int kr0 = kw + 16 * warp + g, kr1 = kr0 + 8;
    int wlo, whi;                                      // the q tiles this warpgroup needs
    q_tile_range(a, kw, wlo, whi, 64);
    if (kw >= a.Skv) whi = wlo;                        // keys past Skv: nothing to compute
    const float sl2 = a.scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    // A operands: this warpgroup's 64 rows of K and V, panels DKV_BK rows apart
    const uint32_t k_addr = smem_addr(Ks) + 64 * cw * 128;
    const uint32_t v_addr = smem_addr(Vs) + 64 * cw * 128;
    // Per q tile, staggered so that the tensor cores have work queued while
    // the registers allow it (dK, dV and the in-flight operands take ~208):
    // S^T is issued behind the previous tile's dV and dK products; then dP^T
    // runs while P^T is formed; then dS^T, and dV, dK are issued and left
    // running.  The live tiles [jlo, jhi) are walked in one loop with no
    // branch around a wgmma, so that ptxas sees the same products in flight
    // at every point (where it cannot, it serialises wgmma).
    const int jlo = max(lo, wlo), jhi = max(jlo, min(hi, whi));
    uint32_t pa[4][4], da[4][4];                       // dV/dK A operands: live until the wait
    auto issue_t = [&](float (&acc)[32], uint32_t rows, uint32_t cols) {  // rows cols^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ra = (kk / 4) * DKV_BK * 128 + (kk % 4) * 32;
        const uint32_t ca = (kk / 4) * DKV_BQ * 128 + (kk % 4) * 32;
        hopper::wgmma_ss_n64<0>(acc, hopper::desc_sw128(rows + ra, 16, 1024),
                                hopper::desc_sw128(cols + ca, 16, 1024), kk);
      }
      hopper::wgmma_commit();
    };
    // P^T = 2^(S^T sl2 - lse log2e) on visible pairs (register 4j + e: key
    // kr0 or kr1, query 8j + 2c + (e & 1)), masked on edge tiles only
    // (masked is a literal at each call: the inlined copies fold it away)
    auto p_as = [&](bool masked, const float (&st)[32], float (&p)[32], const float* ls, int q0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[4 * j + e] = hopper::ex2(fmaf(st[4 * j + e], sl2, (e & 1) ? -lv.y : -lv.x));
          if (masked && !visible_q(a, q0 + 8 * j + 2 * c + (e & 1), e < 2 ? kr0 : kr1)) p[4 * j + e] = 0.f;
        }
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
      }
    };

    if (n > 0) hopper::mbar_wait(kv_full, 0);
    int i = 0;
    for (; lo + i < jlo; ++i) {                        // tiles with no query that sees these keys
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }
    for (; lo + i < jhi; ++i) {
      const int s = i % T::STAGES;
      const int q0 = (lo + i) * DKV_BQ;
      hopper::mbar_wait(&full[s], (i / T::STAGES) & 1);
      const uint32_t q_addr = smem_addr(Qs + s * T::PANELS * DKV_BQ * 64);
      const uint32_t do_addr = smem_addr(dOs + s * T::PANELS * DKV_BQ * 64);
      float st[32], dpt[32], p[32];
      hopper::wgmma_fence();
      issue_t(st, k_addr, q_addr);                     // S^T = K Q^T (64 keys x 64 queries)
      hopper::wgmma_wait<0>();                         // and the previous tile's dV, dK
      hopper::fence_regs(st);
      if (i > jlo - lo) hopper::mbar_arrive(&empty[(i - 1) % T::STAGES]);
      hopper::wgmma_fence();
      issue_t(dpt, v_addr, do_addr);                   // dP^T = V dO^T, while P^T is formed
      const bool inner = kw + 63 <= q0 + a.causal_shift && kw + 64 <= a.Skv &&
                         q0 + DKV_BQ <= a.Sq &&
                         (a.window <= 0 || kw > q0 + DKV_BQ - 1 + a.causal_shift - a.window);
      if (inner) p_as(false, st, p, lss + s * DKV_BQ, q0);
      else p_as(true, st, p, lss + s * DKV_BQ, q0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
      // dS^T = P^T (dP^T - delta) scale
      const float* dl = dls + s * DKV_BQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * c);
        const float ds0 = p[4 * j] * (dpt[4 * j] - dv2.x) * a.scale;
        const float ds1 = p[4 * j + 1] * (dpt[4 * j + 1] - dv2.y) * a.scale;
        const float ds2 = p[4 * j + 2] * (dpt[4 * j + 2] - dv2.x) * a.scale;
        const float ds3 = p[4 * j + 3] * (dpt[4 * j + 3] - dv2.y) * a.scale;
        da[j / 2][(j & 1) * 2] = pack_bf16(ds0, ds1);
        da[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds2, ds3);
      }

      // dV += P^T dO and dK += dS^T Q: 4 k16 steps over the queries; dO and
      // Q are MN-major, their panels DKV_BQ rows apart
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hopper::desc_sw128(do_addr + kk * 16 * 128, DKV_BQ * 128, 1024);
        if constexpr (D == 64) hopper::wgmma_rs_n64<1>(dv, pa[kk], db, 1);
        else hopper::wgmma_rs_n128<1>(dv, pa[kk], db, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hopper::desc_sw128(q_addr + kk * 16 * 128, DKV_BQ * 128, 1024);
        if constexpr (D == 64) hopper::wgmma_rs_n64<1>(dk, da[kk], db, 1);
        else hopper::wgmma_rs_n128<1>(dk, da[kk], db, 1);
      }
      hopper::wgmma_commit();                          // left running
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    if (jlo < jhi) hopper::mbar_arrive(&empty[(i - 1) % T::STAGES]);
    for (; i < n; ++i) {                               // tiles past the last query that sees them
      hopper::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      hopper::mbar_arrive(&empty[i % T::STAGES]);
    }

    // this query head's partial dk and dv, f32 (zeros when no q tile was live)
    const long long plane = (long long)a.B * a.H * a.Skv * DH;
    float* pk = p.part + (((long long)b * a.H + h) * a.Skv) * DH;
    float* pv = pk + plane;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (kr0 < a.Skv) {
        *reinterpret_cast<float2*>(pk + (long long)kr0 * DH + col) = make_float2(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<float2*>(pv + (long long)kr0 * DH + col) = make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (kr1 < a.Skv) {
        *reinterpret_cast<float2*>(pk + (long long)kr1 * DH + col) = make_float2(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<float2*>(pv + (long long)kr1 * DH + col) = make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// dk, dv = the sums of the G partials of each KV head, g = 0 .. G-1 in order,
// in bf16 through their strides.  Thread: 4 columns of one (b, kv head, key)
// row; blockIdx.y: 0 = dk, 1 = dv.
__global__ void __launch_bounds__(256) dkv_reduce(const float* part, BwdArgs a, int D) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const int cq = D / 4;
  const long long rows = (long long)a.B * a.KVH * a.Skv;
  if (i >= rows * cq) return;
  const int col = (int)(i % cq) * 4;
  const long long r = i / cq;
  const int key = (int)(r % a.Skv), kh = (int)((r / a.Skv) % a.KVH), b = (int)(r / ((long long)a.Skv * a.KVH));
  const int G = a.H / a.KVH;
  const float* src = part + (long long)blockIdx.y * a.B * a.H * a.Skv * D +
                     (((long long)b * a.H + kh * G) * a.Skv + key) * D + col;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + (long long)g * a.Skv * D);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(blockIdx.y == 0 ? a.dk : a.dv);
  const long long sb = blockIdx.y == 0 ? a.dk_sb : a.dv_sb;
  const long long sh = blockIdx.y == 0 ? a.dk_sh : a.dv_sh;
  const long long ss = blockIdx.y == 0 ? a.dk_ss : a.dv_ss;
  uint2 out;
  out.x = pack_bf16(acc.x, acc.y);
  out.y = pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>(dst + b * sb + kh * sh + key * ss + col) = out;
}

template <int D, int DH = D>
int launch_dkv_bf16(const BwdArgs& a, float* part, cudaStream_t st) {
  DkvParams p;
  p.a = a;
  p.part = part;
  if (!hopper::make_map(&p.tq, a.q, a.B, a.H, a.Sq, DH, a.q_sb, a.q_sh, a.q_ss, DKV_BQ) ||
      !hopper::make_map(&p.tdo, a.dout, a.B, a.H, a.Sq, DH, a.do_sb, a.do_sh, a.do_ss, DKV_BQ) ||
      !hopper::make_map(&p.tk, a.k, a.B, a.KVH, a.Skv, DH, a.k_sb, a.k_sh, a.k_ss, DKV_BK) ||
      !hopper::make_map(&p.tv, a.v, a.B, a.KVH, a.Skv, DH, a.v_sb, a.v_sh, a.v_ss, DKV_BK))
    return 1001;
  dim3 grid(a.H, (a.Skv + DKV_BK - 1) / DKV_BK, a.B);
  int e = launch(dkv_bf16<D, DH>, grid, 384, DkvTile<D>::SMEM, st, p);
  if (e) return e;
  const long long n = (long long)a.B * a.KVH * a.Skv * (DH / 4);
  dkv_reduce<<<dim3((unsigned)((n + 255) / 256), 2), 256, 0, st>>>(part, a, DH);
  return cudaGetLastError();
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

// dq (written through its strides) and delta (B,H,Sq) f32.  1001 if
// cuTensorMapEncodeTiled refuses a map.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 32) return launch_dq_bf16<64, 32>(a, st);
    if (D == 64) return launch_dq_bf16<64>(a, st);
    if (D == 128) return launch_dq_bf16<128>(a, st);
  } else if (dtype == 0) {
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    auto smem = [](int d) { return (size_t)(2 * BQ * (d + 1) + 2 * d * (BK + 1) + BQ * (BK + 1)) * 4; };
    if (D == 32) return launch(dq_f32<32>, grid, 256, smem(32), st, a);
    if (D == 64) return launch(dq_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(dq_f32<128>, grid, 256, smem(128), st, a);
  }
  return 1000;
}

// dk, dv (written through their strides); reads the delta that fa_bwd_dq wrote.
// bf16: `part` is f32 scratch of 2 * B * H * Skv * D elements (the per-query-
// head partials); f32: unused.  1001 if cuTensorMapEncodeTiled refuses a map.
extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, float* part,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (part == nullptr) return 1000;
    if (D == 32) return launch_dkv_bf16<64, 32>(a, part, st);
    if (D == 64) return launch_dkv_bf16<64>(a, part, st);
    if (D == 128) return launch_dkv_bf16<128>(a, part, st);
  } else if (dtype == 0) {
    dim3 grid((Skv + BK - 1) / BK, KVH, B);
    auto smem = [](int d) {
      return (size_t)(2 * BK * (d + 1) + 2 * d * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ) * 4;
    };
    if (D == 32) return launch(dkv_f32<32>, grid, 256, smem(32), st, a);
    if (D == 64) return launch(dkv_f32<64>, grid, 256, smem(64), st, a);
    if (D == 128) return launch(dkv_f32<128>, grid, 256, smem(128), st, a);
  }
  return 1000;
}
