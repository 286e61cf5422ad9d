// Flash-decode for Hopper (sm_90a): one query token per (batch, head) against
// a linear or ring-buffered KV cache, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_decode_kernel
// (reached through flash_decode).
//
// What bounds it on the H100: bytes, and only the visible ones.  Each cache
// row is used for G multiply-adds per query head group, ~2 FLOP per byte,
// far below the card's ~295 FLOP/byte ridge.  At the serving shape (B=4,
// KVH=2, T=4096, D=128, bf16, lanes filled 4096/3000/1000/64) the cache holds
// 16.8 MB but only 8.4 MB of it is visible; the rest never needs to leave
// device memory.  At that size the call lasts a few microseconds, so what
// also counts is the latency of the first bytes and of the merge, and the
// host's work per call (a decode step is host-bound).
//
// The design: per (b, KV head) one cluster of C blocks (C <= 16, chosen by
// the wrapper so that B * KVH * C covers the SMs while the card holds all
// B * KVH clusters at once; at 76-87 KB of shared memory a block, two fit
// on an SM, which is what lets B * KVH = 8 clusters of 16 be co-resident);
// block `rank` owns a contiguous range of `slots` cache slots:
//
// - Visibility first.  Warp 0, the producer, reads the range's positions 256
//   at a time (one round trip), turns them into a bit mask per tile of TILE
//   slots (ballots), and skips a tile with no visible slot without reading
//   a byte of its K or V.
// - Asynchronous copies.  For a visible tile the producer copies the K and V
//   rows into a ring of 4 or 8 stages with 16-byte cp.async, each lane
//   walking its rows by pointer increments, and signals the stage's mbarrier
//   with cp.async.mbarrier.arrive.  Each shared-memory row is padded by 16
//   bytes, which keeps ldmatrix and 16-byte loads free of bank conflicts and
//   lets every head dim (16-256) and both dtypes share one layout.  Rows
//   past the cache repeat its last row; their slots are masked.  The TMA
//   unit was tried first, with one bulk copy per row: it takes each small
//   copy as a request of its own and fed a block far slower than cp.async
//   does; and a tensor map would have to be encoded on the host at every
//   call of a host-bound decode step.
// - Four consumer warps.  Stage s always goes to warp s % 4 (the ring has a
//   multiple of 4 stages), so a warp waits on its own stages in order, and
//   each warp keeps its own online softmax (m, l, O) in base 2 over the
//   tiles it takes.  bf16: S = Q K^T and O += P V with mma.sync m16n8k16
//   (the G <= 16 query heads padded to 16 rows; ldmatrix from the padded
//   rows, V transposed by ldmatrix.trans; P packed to bf16 straight from the
//   S accumulator, as the forward does) and the approximate exp2.  f32:
//   CUDA-core FMAs and the exact exp2f, no TF32 (its bound is 2e-5): a lane
//   per slot for the scores, a lane per head-dim column for P V.  The mask
//   is exact: pos >= 0, pos <= qpos and, with a window, pos > qpos - window.
//   The consumers load q before the producer starts its copies, so that q
//   does not queue behind them.
// - Merge in the cluster, with no global scratch and no second kernel (the
//   wrapper allocates only o).  Block `rank` owns a slice of the G x D
//   outputs.  Each block adds its warps' O (rescaled to the block's max, in
//   warp order) and pushes its share of every slice into the owner's shared
//   memory, with its (m, l) and visible count (remote stores: no round trip
//   on the critical path); after one cluster barrier the owner weighs the C
//   shares (e^(m_j - M) / L) and adds them in rank order.  Every sum has a
//   fixed order, so a rerun gives the same bits.
// - A lane with no visible slot anywhere: the plain version's softmax over
//   all-masked scores is uniform, so o is the mean of V over all T slots.
//   The owners see a visible count of 0, every block sums V over its range
//   densely, and a second round of shares and a barrier merge those sums.
//
// Layouts: q (B,H,D) with D contiguous; k/v addressed as (B,KVH,T,D) by
// (batch, head, slot) strides in elements with D contiguous, so the model's
// (B,T,KVH,D) cache is read in place (16-byte aligned rows); pos (B,T) i32
// (-1 = empty slot), row stride pos_sb; qpos (B,) i32; o (B,H,D) contiguous.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXG = 16;          // query heads per KV head: the rows of an mma tile
constexpr int NC = 4;             // consumer warps
constexpr int THREADS = 32 * (1 + NC);
constexpr int MAX_CLUSTER = 16;
constexpr int POS_CHUNK = 256;    // positions the producer reads per round trip
constexpr int SMALL_BYTES = 2048; // barriers and row statistics, then 16-byte aligned again

struct Args {
  const void* q; const void* k; const void* v; const int* pos; const int* qpos; void* o;
  int B, H, KVH, T, window, slots;   // window <= 0: none; slots per block
  long long q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, pos_sb;
  float scale_log2;   // log2(e) / sqrt(D): scores are kept in base 2
};

// The small shared-memory area after the ring and q (SMALL_BYTES).
struct Small {
  uint64_t full[8], empty[8], mask[8];
  int tile[8];
  float wm[NC][MAXG], wl[NC][MAXG];   // each warp's max and sum
  float ww[NC][MAXG];                 // each warp's weight in the block's sum
  float cm[MAXG], cl[MAXG];           // the block's, read by the cluster
  int nvis;                           // visible slots in the block's range
};
static_assert(sizeof(Small) <= SMALL_BYTES, "small area");

// What the cluster's blocks write into a block's shared memory (after the
// small area): each rank's (m, l) of every row and visible count, and each
// rank's share of this block's slice of the outputs, [rank][per].
template <int D>
struct Merge {
  float m[MAX_CLUSTER][MAXG], l[MAX_CLUSTER][MAXG];
  int nv[MAX_CLUSTER];
  float share[MAXG * D + 4 * MAX_CLUSTER];
};

// The shape of one instantiation (kernels/decode_attention.py mirrors it).
template <typename T, int D>
struct Cfg {
  static constexpr int ES = sizeof(T);
  static constexpr bool MMA = ES == 2;
  static constexpr int TILE = MMA ? (D <= 64 ? 64 : 32) : (D <= 64 ? 32 : 16);
  static constexpr int PITCH = D * ES + 16;           // bytes per row in shared memory
  static constexpr int STAGE = 2 * TILE * PITCH;      // K rows, then V rows
  static constexpr int STAGES = STAGE <= 12288 ? 8 : 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int QPITCH = MMA ? 2 * D + 16 : 4 * D;
  static constexpr int QBYTES = MAXG * QPITCH;
  static constexpr int SMEM = RING + QBYTES + SMALL_BYTES + sizeof(Merge<D>);
  // after the walk the ring holds the merges' scratch (see the kernel)
  static_assert(RING >= (NC * MAXG * D + D) * 4,
                "merge scratch must fit in the ring");
  static_assert(STAGES % NC == 0, "each stage must belong to one consumer warp");
  static_assert(POS_CHUNK % TILE == 0 && TILE % 16 == 0 && TILE <= 64, "tile");
};

// Cluster barriers: arrive (relaxed) and wait separately, or both with
// release and acquire semantics.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void consumer_sync() {   // the four consumer warps only
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * NC) : "memory");
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

// ------------------------------------------------------------ consumer walks
// Each walks the stages of warp cw until the producer's end marker, keeping
// the warp's online softmax in base 2 (scores times log2(e) / sqrt(D)), then
// leaves (m, l) in sm.wm/wl and its O in registers; store writes that O to
// the warp's [MAXG][D] f32 tile for the block's sum.

// bf16: the lane holds rows g0 = lane / 4 and g0 + 8 of the 16 x D output
// as mma accumulator fragments o[D/8][4].
template <int D>
struct Bf16Walk {
  using C = Cfg<__nv_bfloat16, D>;
  float o[D / 8][4];
  float m[2], l[2];

  __device__ void run(unsigned char* ring, unsigned char* qs, Small& sm, int cw, int lane,
                      float scale_log2, int) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
    const uint32_t q_addr = smem_addr(qs) + (lane % 16) * C::QPITCH + (lane / 16) * 16;
    for (int i = cw;; i += NC) {
      const int s = i % C::STAGES;
      hopper::mbar_wait(&sm.full[s], (i / C::STAGES) & 1);
      if (sm.tile[s] < 0) break;
      const uint64_t mask = sm.mask[s];
      const uint32_t kb = smem_addr(ring + s * C::STAGE);
      const uint32_t vb = kb + C::TILE * C::PITCH;

      // S = Q K^T: 16 x TILE
      float sc[C::TILE / 8][4];
#pragma unroll
      for (int j = 0; j < C::TILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const uint32_t k_addr = kb + ((lane % 8) + 8 * (lane / 16)) * C::PITCH + ((lane / 8) % 2) * 16;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, q_addr + kk * 32);
#pragma unroll
        for (int nb = 0; nb < C::TILE / 8; nb += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, k_addr + nb * 8 * C::PITCH + kk * 32);
          mma_bf16(sc[nb], qa, kf[0], kf[1]);
          mma_bf16(sc[nb + 1], qa, kf[2], kf[3]);
        }
      }
      // mask, scale, and the online softmax of rows g0 and g0 + 8
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < C::TILE / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = (mask >> (nb * 8 + 2 * (lane % 4) + e)) & 1;
          sc[nb][e] = vis ? sc[nb][e] * scale_log2 : NEG_INF;
          sc[nb][2 + e] = vis ? sc[nb][2 + e] * scale_log2 : NEG_INF;
          mx[0] = fmaxf(mx[0], sc[nb][e]);
          mx[1] = fmaxf(mx[1], sc[nb][2 + e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = hopper::ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nb = 0; nb < C::TILE / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nb][e] = hopper::ex2(sc[nb][e] - m[e / 2]);
          l[e / 2] += sc[nb][e];
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }
      // O += P V: P from the S fragments, V (slots x D) through ldmatrix.trans
      const uint32_t v_addr = vb + ((lane % 8) + 8 * ((lane / 8) % 2)) * C::PITCH + (lane / 16) * 16;
#pragma unroll
      for (int kk = 0; kk < C::TILE / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int nb = 0; nb < D / 8; nb += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, v_addr + kk * 16 * C::PITCH + nb * 16);
          mma_bf16(o[nb], pa, vf[0], vf[1]);
          mma_bf16(o[nb + 1], pa, vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
    }
    if (lane % 4 == 0) {
      sm.wm[cw][lane / 4] = m[0]; sm.wm[cw][lane / 4 + 8] = m[1];
      sm.wl[cw][lane / 4] = l[0]; sm.wl[cw][lane / 4 + 8] = l[1];
    }
  }

  // this warp's O, all 16 rows, to ow [MAXG][D]
  __device__ void store(float* ow, int lane, int) {
    const int g0 = lane / 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(ow + g0 * D + d) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(ow + (g0 + 8) * D + d) = make_float2(o[j][2], o[j][3]);
    }
  }
};


// f32: scores with a lane per slot (TILE = 16: two lane groups, one for each
// parity of g); P V with a lane per column d = lane % DL + DL j (D = 16:
// lanes 16-31 repeat lanes 0-15).
template <int D>
struct F32Walk {
  using C = Cfg<float, D>;
  static constexpr int NGRP = 32 / C::TILE;      // lane groups of the scores
  static constexpr int DL = D < 32 ? D : 32;     // lanes that own distinct columns
  static constexpr int RW = C::PITCH / 4;        // row pitch in floats
  float o[MAXG][D / DL];
  float m[MAXG / NGRP], l[MAXG / NGRP];          // of g = grp + NGRP i

  __device__ void run(unsigned char* ring, unsigned char* qs, Small& sm, int cw, int lane,
                      float scale_log2, int G) {
    const float* q = reinterpret_cast<const float*>(qs);
    const int slot = lane % C::TILE, grp = lane / C::TILE;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int j = 0; j < D / DL; ++j) o[g][j] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXG / NGRP; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
    for (int it = cw;; it += NC) {
      const int s = it % C::STAGES;
      hopper::mbar_wait(&sm.full[s], (it / C::STAGES) & 1);
      if (sm.tile[s] < 0) break;
      const uint64_t mask = sm.mask[s];
      const float* ks = reinterpret_cast<const float*>(ring + s * C::STAGE);
      const float* vs = ks + C::TILE * RW;

      float sc[MAXG / NGRP];
#pragma unroll
      for (int i = 0; i < MAXG / NGRP; ++i) sc[i] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(ks + slot * RW);
#pragma unroll 4
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int i = 0; i < MAXG / NGRP; ++i) {
          if (grp + NGRP * i < G) {
            const float4 qv = reinterpret_cast<const float4*>(q + (grp + NGRP * i) * D)[d4];
            sc[i] = fmaf(qv.x, kv.x, sc[i]);
            sc[i] = fmaf(qv.y, kv.y, sc[i]);
            sc[i] = fmaf(qv.z, kv.z, sc[i]);
            sc[i] = fmaf(qv.w, kv.w, sc[i]);
          }
        }
      }
      const bool vis = (mask >> slot) & 1;
      float alpha[MAXG / NGRP];
#pragma unroll
      for (int i = 0; i < MAXG / NGRP; ++i) {
        sc[i] = vis ? sc[i] * scale_log2 : NEG_INF;
        float mx = sc[i];
#pragma unroll
        for (int off = C::TILE / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
        const float mn = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - mn);
        m[i] = mn;
        sc[i] = exp2f(sc[i] - mn);
        l[i] = l[i] * alpha[i] + sc[i];
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float al = __shfl_sync(0xffffffff, alpha[g / NGRP], C::TILE * (g % NGRP));
#pragma unroll
          for (int j = 0; j < D / DL; ++j) o[g][j] *= al;
        }
      }
      for (int t = 0; t < C::TILE; ++t) {
        float vv[D / DL];
#pragma unroll
        for (int j = 0; j < D / DL; ++j) vv[j] = vs[t * RW + lane % DL + DL * j];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float p = __shfl_sync(0xffffffff, sc[g / NGRP], t + C::TILE * (g % NGRP));
#pragma unroll
            for (int j = 0; j < D / DL; ++j) o[g][j] = fmaf(p, vv[j], o[g][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }
#pragma unroll
    for (int i = 0; i < MAXG / NGRP; ++i) {
#pragma unroll
      for (int off = C::TILE / 2; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffff, l[i], off);
      if (slot == 0) { sm.wm[cw][grp + NGRP * i] = m[i]; sm.wl[cw][grp + NGRP * i] = l[i]; }
    }
  }

  // this warp's O, rows g < G, to ow [MAXG][D]
  __device__ void store(float* ow, int lane, int G) {
    if (lane >= DL) return;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < D / DL; ++j) ow[g * D + lane + DL * j] = o[g][j];
      }
    }
  }
};

template <typename T, int D>
using Walk = typename std::conditional<sizeof(T) == 2, Bf16Walk<D>, F32Walk<D>>::type;

// ------------------------------------------------------------------- kernel

// Grid (C, KVH, B), clusters of (C, 1, 1); 32 x (1 + NC) threads: warp 0 the
// producer, warps 1..NC the consumers.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_decode_kernel(const Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* qs = smem + C::RING;
  Small& sm = *reinterpret_cast<Small*>(qs + C::QBYTES);
  Merge<D>& mg = *reinterpret_cast<Merge<D>*>(qs + C::QBYTES + SMALL_BYTES);
  // after the walk the ring holds the merges' scratch:
  float* ow = reinterpret_cast<float*>(ring);   // each warp's O [NC][MAXG][D]
  float* vsum = ow + NC * MAXG * D;             // with nothing visible: V over the range / T [D]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nrank = (int)cluster.num_blocks();
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t_lo = rank * a.slots, t_hi = min(a.T, t_lo + a.slots);
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 33);     // 32 cp.async arrivals and lane 0's
      hopper::mbar_init(&sm.empty[s], 1);
    }
    hopper::mbar_fence_init();
  }
  // the consumers' q loads go out before the producer's first K/V copies
  constexpr int QPER = MAXG * D / (32 * NC);
  const int ct = threadIdx.x - 32;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + kh * G * a.q_sh;
  T x[QPER];
  if (warp > 0) {
#pragma unroll
    for (int u = 0; u < QPER; ++u) {
      const int i = ct + u * 32 * NC, g = i / D;
      x[u] = qp[min(g, G - 1) * a.q_sh + i % D];
    }
  }
  cluster_arrive();   // this block has started: the others may write its shared memory
  __syncthreads();

  if (warp == 0) {
    // ---- producer: visibility of the range, then the visible tiles' rows
    const int qpos = a.qpos[b];
    const int* pp = a.pos + b * a.pos_sb;
    const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
    constexpr int PER = POS_CHUNK / 32;
    // TILE rows of K (or V) from slot t0 on, by 16-byte cp.async: LPR lanes
    // a row, RPI rows a warp instruction; a lane walks its rows by pointer
    // increments.  Rows past the cache repeat its last row (masked slots).
    constexpr int VPR = D * sizeof(T) / 16, EPV = 16 / sizeof(T);
    constexpr int LPR = VPR < 32 ? VPR : 32, RPI = 32 / LPR;
    const int r0 = lane / LPR, cv = lane % LPR;
    auto copy_rows = [&](const T* base, long long st, unsigned char* d, int t0) {
      if (t0 + C::TILE <= a.T) {
        const T* src = base + (t0 + r0) * st + cv * EPV;
        d += r0 * C::PITCH + cv * 16;
#pragma unroll
        for (int i = 0; i < C::TILE / RPI; ++i) {
#pragma unroll
          for (int u = 0; u < VPR / LPR; ++u) hopper::cp_async_16(d + u * 512, src + u * 32 * EPV);
          src += RPI * st;
          d += RPI * C::PITCH;
        }
      } else {
        for (int i = 0; i < C::TILE / RPI; ++i) {
          const int r = r0 + i * RPI;
          const T* src = base + min(t0 + r, a.T - 1) * st + cv * EPV;
          for (int u = 0; u < VPR / LPR; ++u)
            hopper::cp_async_16(d + r * C::PITCH + cv * 16 + u * 512, src + u * 32 * EPV);
        }
      }
    };
    int seq = 0, nvis = 0;
    for (int c0 = t_lo; c0 < t_hi; c0 += POS_CHUNK) {
      int p[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int t = c0 + 32 * j + lane;
        p[j] = t < t_hi ? pp[t] : -1;
      }
      uint32_t vis = 0;       // bit j: slot c0 + 32 j + lane is visible
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        bool v = p[j] >= 0 && p[j] <= qpos;
        if (a.window > 0) v = v && p[j] > qpos - a.window;
        vis |= (uint32_t)v << j;
      }
#pragma unroll 1
      for (int tt = 0; tt < POS_CHUNK / C::TILE; ++tt) {
        const int t0 = c0 + tt * C::TILE;
        if (t0 >= t_hi) break;
        uint64_t mask;        // bit i: slot t0 + i is visible
        const int j0 = tt * C::TILE / 32;
        if constexpr (C::TILE == 64)
          mask = __ballot_sync(0xffffffff, (vis >> j0) & 1) |
                 ((uint64_t)__ballot_sync(0xffffffff, (vis >> (j0 + 1)) & 1) << 32);
        else if constexpr (C::TILE == 32)
          mask = __ballot_sync(0xffffffff, (vis >> j0) & 1);
        else
          mask = (__ballot_sync(0xffffffff, (vis >> j0) & 1) >> ((tt * C::TILE) % 32)) &
                 ((1u << C::TILE) - 1);
        if (mask == 0) continue;
        nvis += __popcll(mask);
        const int s = seq % C::STAGES;
        hopper::mbar_wait(&sm.empty[s], ((seq / C::STAGES) & 1) ^ 1);
        unsigned char* dst = ring + s * C::STAGE;
        {
          copy_rows(kbase, a.k_st, dst, t0);
          copy_rows(vbase, a.v_st, dst + C::TILE * C::PITCH, t0);
          hopper::cp_async_arrive(&sm.full[s]);
          if (lane == 0) {
            sm.tile[s] = t0;
            sm.mask[s] = mask;
            hopper::mbar_arrive(&sm.full[s]);
          }
        }
        ++seq;
      }
    }
    for (int i = 0; i < NC; ++i, ++seq) {   // one end marker for each consumer
      const int s = seq % C::STAGES;
      hopper::mbar_wait(&sm.empty[s], ((seq / C::STAGES) & 1) ^ 1);
      hopper::cp_async_arrive(&sm.full[s]);
      if (lane == 0) {
        sm.tile[s] = -1;
        hopper::mbar_arrive(&sm.full[s]);
      }
      __syncwarp();
    }
    if (lane == 0) sm.nvis = nvis;
  } else {
    // ---- consumers: q of the G heads (zero-padded to 16 rows) to shared
    // memory, the walk, then the block's (m, l, O) in a fixed order
    const int cw = warp - 1;
    {
#pragma unroll
      for (int u = 0; u < QPER; ++u) {
        const int i = ct + u * 32 * NC, g = i / D;
        const T xv = g < G ? x[u] : T(0.f);
        if constexpr (C::MMA)
          reinterpret_cast<__nv_bfloat16*>(qs + g * C::QPITCH)[i % D] = xv;
        else
          reinterpret_cast<float*>(qs)[i] = xv;
      }
    }
    consumer_sync();
    Walk<T, D> w;
    w.run(ring, qs, sm, cw, lane, a.scale_log2, G);
    consumer_sync();                 // every walk is done: the ring is free
    w.store(ow + cw * MAXG * D, lane, G);
    if (ct < MAXG) {
      const int g = ct;
      float mx = NEG_INF;
      for (int j = 0; j < NC; ++j) mx = fmaxf(mx, sm.wm[j][g]);
      float lsum = 0.f;
      for (int j = 0; j < NC; ++j) {
        const float wt = exp2f(sm.wm[j][g] - mx);
        sm.ww[j][g] = wt;
        lsum += sm.wl[j][g] * wt;
      }
      sm.cm[g] = mx;
      sm.cl[g] = lsum;
    }
  }

  // ---- merge across the cluster.  Block `rank` owns the slice [rank per,
  // (rank + 1) per) of the G x D outputs.  Every block pushes its (m, l) and
  // visible count to every rank and its O slice to the slice's owner (remote
  // stores, no round trip); after one cluster barrier the owner weighs the
  // C shares and adds them in rank order.
  __syncthreads();                  // the block's (m, l, O) and count are ready
  cluster_wait();                   // every block of the cluster has started
  const int n_out = G * D, per = ((n_out + nrank - 1) / nrank + 3) & ~3;
  for (int i = threadIdx.x; i < nrank * MAXG; i += THREADS) {
    const int j = i / MAXG, g = i % MAXG;
    *cluster.map_shared_rank(&mg.m[rank][g], j) = sm.cm[g];
    *cluster.map_shared_rank(&mg.l[rank][g], j) = sm.cl[g];
  }
  if (threadIdx.x < nrank) *cluster.map_shared_rank(&mg.nv[rank], threadIdx.x) = sm.nvis;
  for (int e4 = threadIdx.x; e4 < n_out / 4; e4 += THREADS) {
    // the block's O: the warps' O added in warp order, rescaled to the block's max
    const int e = 4 * e4, g = e / D, r = e / per;   // 4 neighbours share g and the owner
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(ow + j * MAXG * D + e);
      const float wt = sm.ww[j][g];
      v.x = fmaf(x.x, wt, v.x); v.y = fmaf(x.y, wt, v.y);
      v.z = fmaf(x.z, wt, v.z); v.w = fmaf(x.w, wt, v.w);
    }
    *reinterpret_cast<float4*>(cluster.map_shared_rank(mg.share + rank * per + e - r * per, r)) = v;
  }
  cluster_sync();                   // every share has landed
  int nvis = 0;
  for (int j = 0; j < nrank; ++j) nvis += mg.nv[j];
  T* op = static_cast<T*>(a.o) + ((long long)b * a.H + kh * G) * D + rank * per;
  const int n = min(n_out, (rank + 1) * per) - rank * per;
  if (nvis > 0) {
    // o = sum_j share_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the rows' max
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int g = (rank * per + i) / D;
      float M = NEG_INF;
#pragma unroll
      for (int j = 0; j < MAX_CLUSTER; ++j)
        if (j < nrank) M = fmaxf(M, mg.m[j][g]);
      float L = 0.f, acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CLUSTER; ++j) {
        if (j < nrank) {
          const float w = exp2f(mg.m[j][g] - M);
          L = fmaf(mg.l[j][g], w, L);
          acc = fmaf(mg.share[j * per + i], w, acc);
        }
      }
      from_f(op[i], acc / L);
    }
  } else {
    // no slot of this lane is visible: o is the mean of V over all T slots;
    // every block pushes its range's sum of V / T for each owner's slice
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float sum = 0.f;
      for (int t = t_lo; t < t_hi; ++t) sum += to_f(vbase[t * a.v_st + d]);
      vsum[d] = sum / (float)a.T;
    }
    __syncthreads();
    for (int e4 = threadIdx.x; e4 < n_out / 4; e4 += THREADS) {
      const int e = 4 * e4, r = e / per;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(mg.share + rank * per + e - r * per, r)) =
          *reinterpret_cast<const float4*>(vsum + e % D);
    }
    cluster_sync();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float acc = 0.f;
      for (int j = 0; j < nrank; ++j) acc += mg.share[j * per + i];
      from_f(op[i], acc);
    }
  }
}

// ---------------------------------------------------------------------- host

// Raise the dynamic shared-memory limit and allow clusters of 16, once per
// instantiation and device.
template <typename T, int D>
cudaError_t prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ready[dev])) return e;
  e = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T, D>::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

template <typename T, int D>
cudaLaunchConfig_t launch_config(dim3 grid, cudaStream_t st, cudaLaunchAttribute* attr,
                                 int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<T, D>::SMEM;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int D>
int run(const Args& a, int tile, int cluster, cudaStream_t st) {
  if (tile != Cfg<T, D>::TILE) return 1000;
  cudaError_t e = prepare<T, D>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<T, D>(dim3(cluster, a.KVH, a.B), st, attr, cluster);
  e = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, D>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D>
int max_clusters(int cluster) {
  if (prepare<T, D>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<T, D>(dim3(cluster, 1, 1), 0, attr, cluster);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, flash_decode_kernel<T, D>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

template <class F>
int by_head_dim(int D, F&& f, int bad) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
  }
  return bad;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  tile and slots (per block) come from the
// wrapper's plan: tile must equal the instantiation's TILE, slots be a
// multiple of it, and cluster blocks of `slots` cover T.  Returns the
// cudaError_t of the launch (0 = ok); 1000 for a shape or plan this kernel
// does not take.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const int* pos,
                            const int* qpos, void* o, int B, int H, int KVH, int T, int D,
                            int tile, int cluster, int slots,
                            long long q_sb, long long q_sh,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long pos_sb, int window, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || KVH <= 0 || KVH > 65535 || H % KVH || H / KVH > MAXG || T <= 0)
    return 1000;
  if (cluster < 1 || cluster > MAX_CLUSTER || tile <= 0 || slots <= 0 || slots % tile ||
      (long long)slots * cluster < T)
    return 1000;
  const Args a{q, k, v, pos, qpos, o, B, H, KVH, T, window, slots,
               q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, pos_sb,
               1.4426950408889634f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return by_head_dim(D, [&](auto d) {
      return run<__nv_bfloat16, decltype(d)::value>(a, tile, cluster, st); }, 1000);
  if (dtype == 0)
    return by_head_dim(D, [&](auto d) {
      return run<float, decltype(d)::value>(a, tile, cluster, st); }, 1000);
  return 1000;
}

// How many clusters of `cluster` blocks of the (D, dtype) kernel the card can
// hold at once (cudaOccupancyMaxActiveClusters); -1 if it cannot say.
extern "C" int flash_decode_max_clusters(int D, int dtype, int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -1;
  if (dtype == 1)
    return by_head_dim(D, [&](auto d) {
      return max_clusters<__nv_bfloat16, decltype(d)::value>(cluster); }, -1);
  if (dtype == 0)
    return by_head_dim(D, [&](auto d) {
      return max_clusters<float, decltype(d)::value>(cluster); }, -1);
  return -1;
}
