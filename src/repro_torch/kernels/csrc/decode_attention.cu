// Flash-decode for Hopper (sm_90a): one query token per (batch, head) against
// a linear or ring-buffered KV cache, split over the cache length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_decode_kernel
// (reached through flash_decode).
//
// What bounds it on the H100: bytes.  Each cache entry is used for G
// multiply-adds per query head group, so the work is ~2 FLOP per byte of K/V
// read, far below the card's ~295 FLOP/byte ridge; at the serving shape
// (B=4, KVH=2, T=4096, D=128, bf16) one layer reads 16.8 MB of cache.  The
// design therefore reads every cache byte exactly once: a block serves all G
// query heads of its KV head (not one head per block, which would read the
// cache G times), and the cache length is split across blocks so that the
// B*KVH (batch, KV head) pairs fill the card's 132 SMs.  Pass 1 writes each
// split's partial softmax state (m, l, unnormalised acc) in f32; pass 2, a
// small kernel, combines the splits.  The TPU kernel walks the cache in order
// inside one core and keeps that state in VMEM; blocks on the GPU run in no
// order, hence the second pass.
//
// Head dims 64, 128 and 256.  At D = 256 a split's K and V rows take twice
// the shared memory: bf16 keeps splits of up to 128 slots (156 KB at MG 16),
// f32 up to 64 (152 KB); the wrapper plans the split accordingly.
//
// Layouts: q (B,H,D); k/v addressed as (B,KVH,T,D) by (batch, head, slot)
// strides in elements with D contiguous, so the model's (B,T,KVH,D) cache is
// read in place; pos (B,T) i32 (-1 = empty slot), row stride pos_sb; qpos (B,)
// i32; o (B,H,D) contiguous.  A slot is visible when pos >= 0, pos <= qpos
// and, with a window, pos > qpos - window.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int MAXG = 16;      // query heads per KV head served by one block
constexpr int CHUNK = 128;    // most cache slots per split
constexpr int BATCH = 8;      // 16-byte loads each thread keeps in flight

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }
// the two bf16 elements of one 32-bit word of K
__device__ __forceinline__ void unpack(uint32_t w, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

struct Args {
  const void* q; const void* k; const void* v; const int* pos; const int* qpos;
  float* m_part; float* l_part; float* acc_part; void* o;
  int B, H, KVH, T, chunk, nsplit, window;
  long long q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, pos_sb;
  float scale;
};

template <typename T, int D, int MG>
struct Smem {                                  // dynamic shared memory layout
  static constexpr int EW = 4 / sizeof(T);     // elements per 32-bit word
  static constexpr int KW = D / EW + 1;        // padded K row: odd word stride
  static constexpr int VPR = D * sizeof(T) / 16;   // 16-byte vectors per row
  // Vs [chunk][D] T | qs [MG][D] f32 | sc [chunk][MG] f32 | mg, lg [MG] | Ks [chunk][KW] words
  static size_t bytes(int chunk) {
    return (size_t)chunk * D * sizeof(T) + (size_t)MG * D * 4 + (size_t)chunk * MG * 4 +
           2 * MG * 4 + (size_t)chunk * KW * 4;
  }
};

// Grid (nsplit, KVH, B); D threads; MG >= G query heads per block (8 or 16,
// so that the per-head loops are unrolled over a bound close to G).  The
// block first stages its split's K and V rows in shared memory with 16-byte
// loads, BATCH in flight per thread (the cache is read from device memory
// exactly once, with enough loads in flight to keep the memory system busy).
// Then: scores for all G heads with one thread per slot (q read as float4
// broadcasts); per-head max and exp-sum with one warp per head; and
// acc[g][d] = sum_t p[t][g] v[t][d] with one thread per d.
template <typename T, int D, int MG>
__global__ void __launch_bounds__(D) decode_partial(Args a) {
  using L = Smem<T, D, MG>;
  constexpr int NT = D, NW = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Vs = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(Vs + (size_t)a.chunk * D);
  float* sc = qs + MG * D;
  float* mg = sc + (size_t)a.chunk * MG;
  float* lg = mg + MG;
  uint32_t* Ks = reinterpret_cast<uint32_t*>(lg + MG);

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = sp * a.chunk, n = min(a.T, t0 + a.chunk) - t0;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh + (long long)t0 * a.k_st;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh + (long long)t0 * a.v_st;
  const int total = n * L::VPR;
  for (int base = 0; base < total; base += NT * BATCH) {
    uint4 kr[BATCH], vr[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT + tid;
      if (i < total) {
        const int r = i / L::VPR, c = i % L::VPR;
        kr[u] = *reinterpret_cast<const uint4*>(kp + r * a.k_st + c * (16 / sizeof(T)));
        vr[u] = *reinterpret_cast<const uint4*>(vp + r * a.v_st + c * (16 / sizeof(T)));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * NT + tid;
      if (i < total) {
        const int r = i / L::VPR, c = i % L::VPR;
        uint32_t* kd = Ks + r * L::KW + c * 4;
        kd[0] = kr[u].x; kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
        reinterpret_cast<uint4*>(Vs)[r * L::VPR + c] = vr[u];
      }
    }
  }
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int gi = 0; gi < G; ++gi) qs[gi * D + tid] = to_f(qp[(kh * G + gi) * a.q_sh + tid]);
  __syncthreads();

  const int* pp = a.pos + b * a.pos_sb + t0;
  const int qpos = a.qpos[b];
  for (int t = tid; t < n; t += NT) {
    float s[MG];
#pragma unroll
    for (int gi = 0; gi < MG; ++gi) s[gi] = 0.f;
    const uint32_t* kr = Ks + t * L::KW;
#pragma unroll 4
    for (int j = 0; j < D / 4; ++j) {             // 4 elements of the K row
      float kf[4];
      if constexpr (L::EW == 2) {
        unpack(kr[2 * j], kf, T());
        unpack(kr[2 * j + 1], kf + 2, T());
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[e] = __uint_as_float(kr[4 * j + e]);
      }
#pragma unroll
      for (int gi = 0; gi < MG; ++gi) {
        if (gi < G) {
          const float4 qv = reinterpret_cast<const float4*>(qs + gi * D)[j];
          s[gi] = fmaf(qv.x, kf[0], s[gi]);
          s[gi] = fmaf(qv.y, kf[1], s[gi]);
          s[gi] = fmaf(qv.z, kf[2], s[gi]);
          s[gi] = fmaf(qv.w, kf[3], s[gi]);
        }
      }
    }
    const int p = pp[t];
    bool ok = p >= 0 && p <= qpos;
    if (a.window > 0) ok = ok && p > qpos - a.window;
#pragma unroll
    for (int gi = 0; gi < MG; ++gi)
      sc[t * MG + gi] = gi < G ? (ok ? s[gi] * a.scale : NEG_INF) : 0.f;
  }
  __syncthreads();

  // per-head softmax statistics over this split; p overwrites the scores
  for (int gi = warp; gi < G; gi += NW) {
    float mx = NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[i * MG + gi]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      float p = expf(sc[i * MG + gi] - mx);
      sc[i * MG + gi] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffff, sum, off);
    if (lane == 0) { mg[gi] = mx; lg[gi] = sum; }
  }
  __syncthreads();

  float acc[MG];
#pragma unroll
  for (int gi = 0; gi < MG; ++gi) acc[gi] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float vv = to_f(Vs[i * D + tid]);
    const float4* pr = reinterpret_cast<const float4*>(sc + i * MG);
#pragma unroll
    for (int g4 = 0; g4 < MG / 4; ++g4) {
      if (4 * g4 < G) {
        const float4 p = pr[g4];
        acc[4 * g4 + 0] = fmaf(p.x, vv, acc[4 * g4 + 0]);
        acc[4 * g4 + 1] = fmaf(p.y, vv, acc[4 * g4 + 1]);
        acc[4 * g4 + 2] = fmaf(p.z, vv, acc[4 * g4 + 2]);
        acc[4 * g4 + 3] = fmaf(p.w, vv, acc[4 * g4 + 3]);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < MG; ++gi) {
    if (gi >= G) break;
    const long long row = ((long long)b * a.H + kh * G + gi) * a.nsplit + sp;
    a.acc_part[row * D + tid] = acc[gi];
    if (tid == 0) { a.m_part[row] = mg[gi]; a.l_part[row] = lg[gi]; }
  }
}

// Grid (B*H); D threads.  o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine(Args a) {
  const long long bh = blockIdx.x;
  const float* mp = a.m_part + bh * a.nsplit;
  const float* lp = a.l_part + bh * a.nsplit;
  const float* ap = a.acc_part + bh * a.nsplit * D;
  float M = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, mp[s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = expf(mp[s] - M);
    L = fmaf(lp[s], w, L);
    acc = fmaf(ap[s * D + threadIdx.x], w, acc);
  }
  from_f(static_cast<T*>(a.o)[bh * D + threadIdx.x], acc / fmaxf(L, 1e-30f));
}

template <typename T, int D, int MG>
cudaError_t run(const Args& a, cudaStream_t st) {
  const size_t smem = Smem<T, D, MG>::bytes(a.chunk);
  cudaError_t e = cudaFuncSetAttribute(decode_partial<T, D, MG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  decode_partial<T, D, MG><<<dim3(a.nsplit, a.KVH, a.B), D, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine<T, D><<<a.B * a.H, D, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  m_part/l_part (B*H*nsplit) and acc_part
// (B*H*nsplit*D) are f32 scratch from the caller.  Returns the cudaError_t of
// the launches (0 = ok); 1000 for a shape or dtype this kernel does not take.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* pos, const int* qpos,
                            float* m_part, float* l_part, float* acc_part, void* o,
                            int B, int H, int KVH, int T, int D, int chunk, int nsplit,
                            long long q_sb, long long q_sh,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long pos_sb, int window, int dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH || H / KVH > MAXG || T <= 0) return 1000;
  if (chunk <= 0 || chunk > CHUNK || nsplit != (T + chunk - 1) / chunk) return 1000;
  Args a{q, k, v, pos, qpos, m_part, l_part, acc_part, o, B, H, KVH, T, chunk, nsplit,
         window, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, pos_sb,
         1.0f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = H / KVH <= 8;
  if (dtype == 1) {
    if (D == 64) return small ? run<__nv_bfloat16, 64, 8>(a, st) : run<__nv_bfloat16, 64, MAXG>(a, st);
    if (D == 128) return small ? run<__nv_bfloat16, 128, 8>(a, st) : run<__nv_bfloat16, 128, MAXG>(a, st);
    if (D == 256) return small ? run<__nv_bfloat16, 256, 8>(a, st) : run<__nv_bfloat16, 256, MAXG>(a, st);
  } else if (dtype == 0) {
    if (D == 64) return small ? run<float, 64, 8>(a, st) : run<float, 64, MAXG>(a, st);
    if (D == 128) return small ? run<float, 128, 8>(a, st) : run<float, 128, MAXG>(a, st);
    if (D == 256) {
      if (chunk > CHUNK / 2) return 1000;
      return small ? run<float, 256, 8>(a, st) : run<float, 256, MAXG>(a, st);
    }
  }
  return 1000;
}
