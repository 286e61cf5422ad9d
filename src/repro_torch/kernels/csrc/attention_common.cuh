// Helpers shared by the flash-attention kernels for Hopper (sm_90a): tile
// sizes, the causal/window visibility of a (query, key) pair and of a range
// of tiles, bf16 packing, shared-memory addresses, and a launch that raises
// the dynamic shared-memory limit first.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile

// The functions below take any argument struct with the fields Sq, Skv,
// window (<= 0: none) and causal_shift.

// Range of KV tiles [lo, hi) of bk keys that hold at least one key visible
// to some query row of [q0, q0 + rows).
template <class A>
__device__ __forceinline__ void kv_tile_range(const A& a, int q0, int& lo, int& hi,
                                              int rows = BQ, int bk = BK) {
  int nk = (a.Skv + bk - 1) / bk;
  int q_last = min(q0 + rows - 1, a.Sq - 1) + a.causal_shift;  // largest visible key
  hi = q_last < 0 ? 0 : min(nk, q_last / bk + 1);
  lo = 0;
  if (a.window > 0) {
    int first = q0 + a.causal_shift - a.window + 1;          // smallest visible key
    lo = first <= 0 ? 0 : first / bk;
  }
}

// Query row `row` (absolute position row + causal_shift) sees key `col`.
template <class A>
__device__ __forceinline__ bool visible(const A& a, int row, int col) {
  int qabs = row + a.causal_shift;
  bool ok = col <= qabs && col < a.Skv;
  if (a.window > 0) ok = ok && col > qabs - a.window;
  return ok;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename K, typename A>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st, const A& a) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}


}  // namespace
