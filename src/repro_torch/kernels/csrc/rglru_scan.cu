// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from h_{-1} = 0, over (B,S,W) f32, returning every h_t.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:_rglru_kernel
// (reached through rglru_scan).
//
// What bounds it on the H100: bytes.  Each element is read twice (a, b) and
// written once, with one multiply and one add in between, so at the hybrid's
// prefill (B=1, S=2000, W=2560) the work is 61.4 MB of traffic (18 us at
// 3.35 TB/s) and 10 MFLOP.  The chain itself need not be the limit: 2000
// dependent multiply-then-add steps take ~16k cycles, ~9 us, if nothing else
// sits on it.  So this design keeps one sequential chain per channel (a
// sequence split would add traffic to fix a problem the chain does not
// have), and takes everything else off the chain:
//
// - A block owns 16 channels of one batch row (64-byte rows), so W = 2560
//   gives 160 blocks for 132 SMs.
// - Warp 0 is the producer: it streams tiles of 64 steps x 16 channels of a
//   and b into a ring of 6 stages (48 KB in flight per block), each guarded
//   by a full and an empty mbarrier.
// - Warp 1's lanes 0..15 walk the chains, one channel each.  The next 16
//   steps of a and b are read from shared memory into registers ahead of the
//   chain (volatile loads, which the compiler may not sink to their use),
//   and each h_t goes to a shared-memory tile; a stage's 64 x 16 h tile then
//   leaves for device memory in one piece.  A store per step to device
//   memory (64 bytes from the 16 lanes), the first design, held the chain
//   to several times its latency a step; so did loads that the compiler
//   sank to their use.
// - With a tensor map (W a multiple of 4, 16-byte aligned data: rows of a
//   multiple of 16 bytes), one thread loads each tile with TMA and stores
//   each h tile with a TMA store (maps over (W, S, B): nothing past a batch
//   row's last step is read or written).  Otherwise the producer copies with
//   4-byte cp.async and signals the stage with cp.async.mbarrier.arrive, and
//   the chain lanes write their h column out after each stage; the chain and
//   the ring are the same.
//
// Each step rounds the product and then the sum (__fmul_rn, __fadd_rn)
// rather than fusing them into one multiply-add, as the plain version (and
// the TPU kernel) do, so the two agree bit for bit.
//
// Layouts: a, b, h (B,S,W) contiguous f32.
#include "hopper_common.cuh"

namespace {

constexpr int CW = 16;       // channels per block: one chain each
constexpr int STEPS = 64;    // steps per ring stage
constexpr int STAGES = 6;
constexpr int TILE = STEPS * CW;                 // floats of a (and of b, and of h) per stage
constexpr int AHEAD = 16;    // steps read into registers ahead of the chain
// ring [STAGES][a, b][STEPS][CW] | h tiles [2][STEPS][CW] | full, empty [STAGES]
constexpr int SMEM = 1024 + (2 * STAGES + 2) * TILE * 4 + 2 * STAGES * 8;

struct Args {
  const float* a; const float* b; float* h;
  int B, S, W;
};

__device__ __forceinline__ float lds(const float* p) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(smem_addr(p)));
  return x;
}

// Grid (ceil(W / 16), B); 64 threads: warp 0 the producer, lanes 0..15 of
// warp 1 the chains.
template <bool TMA>
__global__ void __launch_bounds__(64)
rglru_chain(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
            const __grid_constant__ CUtensorMap mh, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(hopper::align1024(smem_raw));
  float* hs = ring + 2 * STAGES * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * TILE);
  uint64_t* empty = full + STAGES;
  const int c0 = blockIdx.x * CW, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (p.S + STEPS - 1) / STEPS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], TMA ? 1 : 32);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, t0 = i * STEPS;
      float* as = ring + 2 * s * TILE;
      float* bs = as + TILE;
      hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      if constexpr (TMA) {
        if (lane == 0) {
          hopper::mbar_arrive_expect(&full[s], 2 * TILE * 4);
          hopper::tma_load_3d(as, &ma, &full[s], c0, t0, bi);
          hopper::tma_load_3d(bs, &mb, &full[s], c0, t0, bi);
        }
      } else {
        const int n = min(STEPS, p.S - t0);
        for (int e = lane; e < TILE; e += 32) {
          const int r = e / CW, c = c0 + e % CW;
          if (r < n && c < p.W) {
            const long long off = ((long long)bi * p.S + t0 + r) * p.W + c;
            hopper::cp_async_4(as + e, p.a + off);
            hopper::cp_async_4(bs + e, p.b + off);
          }
        }
        hopper::cp_async_arrive(&full[s]);
      }
    }
    if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (lane >= CW) return;

  // ---- lanes 0..15 of warp 1: one chain each
  const int c = c0 + lane;
  float hv = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, t0 = i * STEPS;
    const float* as = ring + 2 * s * TILE + lane;
    const float* bs = as + TILE;
    float* ht = hs + (i % 2) * TILE + lane;
    if constexpr (TMA) {
      // the store of tile i - 2, from the same buffer, must have read it
      if (lane == 0) hopper::bulk_wait_read<1>();
      __syncwarp(0xffff);
    }
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const int n = min(STEPS, p.S - t0);
    if (n == STEPS) {
      float av[AHEAD], bv[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) { av[u] = lds(as + u * CW); bv[u] = lds(bs + u * CW); }
#pragma unroll
      for (int j = 0; j < STEPS; j += AHEAD) {
        float an[AHEAD], bn[AHEAD];
        if (j + AHEAD < STEPS) {
#pragma unroll
          for (int u = 0; u < AHEAD; ++u) {
            an[u] = lds(as + (j + AHEAD + u) * CW);
            bn[u] = lds(bs + (j + AHEAD + u) * CW);
          }
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
          ht[(j + u) * CW] = hv;
        }
        if (j + AHEAD < STEPS) {
#pragma unroll
          for (int u = 0; u < AHEAD; ++u) { av[u] = an[u]; bv[u] = bn[u]; }
        }
      }
    } else {
      for (int r = 0; r < n; ++r) {
        hv = __fadd_rn(__fmul_rn(as[r * CW], hv), bs[r * CW]);
        ht[r * CW] = hv;
      }
    }
    __syncwarp(0xffff);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);     // the a, b stage is free
    if constexpr (TMA) {
      hopper::fence_async_shared();
      __syncwarp(0xffff);
      if (lane == 0) hopper::tma_store_3d(&mh, hs + (i % 2) * TILE, c0, t0, bi);
    } else if (c < p.W) {
      float* hp = p.h + ((long long)bi * p.S + t0) * p.W + c;
      for (int r = 0; r < n; ++r) hp[(long long)r * p.W] = ht[r * CW];
    }
  }
  if constexpr (TMA) {
    if (lane == 0) hopper::bulk_wait_all();
  }
}

template <bool TMA>
cudaError_t run(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mh,
                const Args& p, cudaStream_t st) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(rglru_chain<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready[dev] = true;
  }
  rglru_chain<TMA><<<dim3((p.W + CW - 1) / CW, p.B), 64, SMEM, st>>>(ma, mb, mh, p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = ok); 1000 for a shape this
// kernel does not take, 1001 if the TMA encoder refuses the maps.
extern "C" int rglru_scan(const float* a, const float* b, float* h, int B, int S, int W,
                          void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return 1000;
  const Args p{a, b, h, B, S, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ma{}, mb{}, mh{};
  const bool tma = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0;
  if (!tma) return run<false>(ma, mb, mh, p, st);
  if (!hopper::make_map_f32_3d(&ma, a, B, S, W, CW, STEPS) ||
      !hopper::make_map_f32_3d(&mb, b, B, S, W, CW, STEPS) ||
      !hopper::make_map_f32_3d(&mh, h, B, S, W, CW, STEPS))
    return 1001;
  return run<true>(ma, mb, mh, p, st);
}
