// Hopper (sm_90a) building blocks of the kernels: TMA tensor maps, loads and
// stores, cp.async with mbarrier completion, mbarriers, wgmma shared-memory
// descriptors and products, and setmaxnreg.  Raw PTX, no CUTLASS.
// smem_addr, pack_bf16 and launch come from attention_common.cuh.
//
// Where trouble hides, and what these helpers fix:
//
// - cuTensorMapEncodeTiled lives in libcuda, not the runtime.  The runtime
//   has already loaded libcuda.so.1 when a kernel is launched, so make_map
//   takes the function from it with dlsym: the libraries need no -lcuda.  The maps are
//   encoded in each C entry point at every call, over (D, S, heads, B) with
//   the view's byte strides (the model's transposed views of (B,S,H,D) memory
//   have a head stride below the row stride, which TMA takes), and reach the
//   kernel as __grid_constant__ parameters.  Rows of a box past S read as
//   zeros, so a ragged last tile needs no load mask.
// - Every tile is stored as the 128-byte swizzle of TMA writes it: panels of
//   64 bf16 columns (128 bytes) by the tile's rows, each panel 1024-byte
//   aligned, so a D = 128 row is two panels and D = 256 four.  A wgmma
//   descriptor must describe exactly that layout (desc_sw128); a wrong
//   offset gives wrong numbers, not a fault.  K-major operand (the reduced
//   dim contiguous): SBO = 1024 bytes between 8-row groups, LBO unused, and a
//   k16 step advances the start address by 32 bytes inside the panel.
//   MN-major operand (V in P V, dO and Q in dk/dv; the transpose flag of the
//   instruction): SBO = 1024 bytes between groups of 8 reduced rows, LBO =
//   the byte distance between the 64-column panels, and a k16 step advances
//   16 rows (2048 bytes).
// - The f32 accumulator of an m64nN wgmma holds, in thread t of the
//   warpgroup, rows 16 (t / 32) + (t % 32) / 4 (+8) and columns
//   8j + 2 (t % 4) (+1): register 4j + {0, 1} the first row, 4j + {2, 3} the
//   second.  Two neighbouring 8-column blocks of it, packed to bf16 pairs,
//   are exactly the register A fragment of one k16 step of the next wgmma
//   (a0 = block 2k first row, a1 = block 2k second row, a2, a3 = block 2k+1),
//   which is how P and dS feed their products without a trip through
//   shared memory.
// - wgmma runs asynchronously: wgmma_fence() before a batch whose
//   accumulator or A registers ordinary code has touched, wgmma_commit() and
//   wgmma_wait<0>() before reading them, and fence_regs() after the wait so
//   that the compiler cannot hoist a read of the accumulator above it.
// - An mbarrier phase completes when its arrival count and its expected
//   bytes are both met; a ring tracks the parity of each slot's phase
//   (round r of slot s: consumers wait parity r & 1 on "full", the producer
//   (r & 1) ^ 1 on "empty", which passes at once on round 0).
// - setmaxnreg moves registers from the producer warpgroup to the consumer
//   warpgroups.  It is executed by whole warpgroups, under
//   __launch_bounds__(384, 1) (168 registers a thread at launch); the counts
//   must balance: 128 x (168 - 24) = 256 x (240 - 168).  ptxas honours it
//   only if the role is provably warp-uniform (__shfl_sync), the producer
//   and consumer paths never rejoin, and no trap sits on either path.
// - ptxas keeps wgmma asynchronous only where it can prove that no register
//   of an unfinished product is read or written by other instructions, and
//   serialises the products (a "Potential Performance Loss" note in
//   -Xptxas -v) where it cannot: a branch after which different products
//   are in flight, a register copy that it coalesces into an in-flight A
//   fragment, or more live registers than the warpgroup has.  The kernels
//   therefore peel their loops so that one set of products is in flight at
//   each point, and pack P only after the product that reads the previous P
//   has finished.
#pragma once
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <dlfcn.h>

#include "attention_common.cuh"   // smem_addr, pack_bf16, launch

namespace hopper {

// registers a thread of the producer and of a consumer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// ---------------------------------------------------------------- host: TMA

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 (B, heads, S, D) tensor, D contiguous, (batch, head, row) strides in
// elements, as a 4-D map over (D, S, heads, B) whose box is one 128-byte
// swizzled panel: 64 columns by `rows` rows.  A stride of a dim of size 1 is
// never stepped; it is replaced by a valid one.  False if the encoder refuses.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S, int D,
                     long long sb, long long sh, long long ss, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const long long sizes[3] = {S, heads, B};
  long long st[3] = {ss, sh, sb};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)((sizes[i] == 1 ? 8 : st[i]) * 2);
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous f32 (B, S, W) tensor as a 3-D map over (W, S, B) whose box is
// box_cols channels by box_rows steps of one batch row, with no swizzle (the
// box lands in shared memory densely, row after row).  A load reads zeros
// past the tensor's edges and a store writes nothing there, so a box never
// crosses into the next batch row.  W must be a multiple of 4 (rows a
// multiple of 16 bytes).  False if the encoder refuses.
inline bool make_map_f32_3d(CUtensorMap* map, const void* ptr, int B, int S, int W,
                            int box_cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------- device: shared memory

// The dynamic shared memory, rounded up to 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes; a tile must start on that boundary).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A pure PTX loop:
// a trap or a clock-based timeout here makes ptxas drop the setmaxnreg
// regions (the consumers then spill at the launch's 168 registers).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------- TMA loads

// The box of `map` at (c0 = first column, c1 = first row, c2 = head, c3 =
// batch) into shared memory at dst; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box of a 3-D map at (c0 = first column, c1 = first row, c2 = batch).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared memory at src to the box of a 3-D map at (c0, c1, c2), as one bulk
// group of the issuing thread.  The threads that wrote src must first make
// their writes visible to the TMA unit (fence_async_shared); before src is
// written again the issuing thread waits for the read (bulk_wait_read<N>).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory
// (and, for bulk_wait_all, until all have completed).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One 4-byte asynchronous copy (cp.async, any 4-byte aligned address), and
// an arrival on `bar` once every earlier cp.async of this thread has landed
// (.noinc: the barrier's count includes these arrivals).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(static_cast<uint64_t>(__cvta_generic_to_global(src)))
               : "memory");
}
// The same for 16 bytes (both addresses 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(static_cast<uint64_t>(__cvta_generic_to_global(src)))
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`; lbo and sbo in bytes (see the note at the top).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of r across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x on the special-function unit (flushes denormals; 0 for x < -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x N f32, N/2 registers a thread) = D * (acc != 0) + A * B over one
// k16 step.  _ss: A (64 x 16) from shared memory, K-major; _rs: A from
// registers (the accumulator-shaped fragment above).  B (16 x N) from shared
// memory, K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TRANS_B));
}

}  // namespace hopper
