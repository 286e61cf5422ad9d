// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// from h_{-1} = 0, over (B,S,W) f32, returning every h_t.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:_rglru_kernel
// (reached through rglru_scan).
//
// What bounds it on the H100: bytes.  Each element is read twice (a, b) and
// written once, with one multiply and one add in between, so at the hybrid's prefill
// (B=1, S=2000, W=2560) the work is 61.4 MB of traffic and 10 MFLOP.  The
// recurrence is sequential in t and independent across (b, w), so one thread
// owns one channel and walks the sequence: neighbouring threads read
// neighbouring w, so every load and store of a warp is one 128-byte line.
// a_t and b_t do not depend on h, so each thread keeps the next AHEAD steps'
// loads in flight (double-buffered in registers) while it computes the
// current AHEAD steps.  The TPU kernel tiles the sequence into blocks whose
// carry persists in VMEM across a sequential grid axis; here the loop over the
// sequence stays inside the thread, so nothing has to carry between blocks.
// With B*W channels and 32 threads a block there are only B*W/32 blocks (80 at
// the hybrid's prefill) for 132 SMs: splitting the sequence across blocks (a
// local pass and a carry pass) is the next step.  Each step rounds the product
// and then the sum, as the plain version (and the TPU kernel) do, rather than
// fusing them into one multiply-add, so the two agree bit for bit.
//
// Layouts: a, b, h (B,S,W) contiguous f32.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;   // channels per block
constexpr int AHEAD = 32;     // steps whose a and b are loaded ahead

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.f;
  float av[AHEAD], bv[AHEAD];
  const int full = S / AHEAD * AHEAD;
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      av[i] = __ldg(ap + (long long)i * W);
      bv[i] = __ldg(bp + (long long)i * W);
    }
  }
  for (int t = 0; t < full; t += AHEAD) {
    float an[AHEAD], bn[AHEAD];
    const bool more = t + AHEAD < full;
    if (more) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        an[i] = __ldg(ap + (long long)(t + AHEAD + i) * W);
        bn[i] = __ldg(bp + (long long)(t + AHEAD + i) * W);
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      hp[(long long)(t + i) * W] = hv;
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) { av[i] = an[i]; bv[i] = bn[i]; }
    }
  }
  for (int t = full; t < S; ++t) {
    hv = __fadd_rn(__fmul_rn(__ldg(ap + (long long)t * W), hv), __ldg(bp + (long long)t * W));
    hp[(long long)t * W] = hv;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = ok); 1000 for a shape this
// kernel does not take.
extern "C" int rglru_scan(const float* a, const float* b, float* h, int B, int S, int W,
                          void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return 1000;
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h, S, W);
  return cudaGetLastError();
}
