// Hopper (sm_90a) building blocks shared by the port's kernels: tensor maps
// for the Tensor Memory Accelerator (TMA), mbarriers, warpgroup matrix
// products (wgmma) on swizzled shared-memory tiles (rows of 32, 64 or 128
// bytes), and register rebalancing between warpgroups. Plain inline PTX; no
// library kernel.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pn {

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the loaded libcuda through the runtime.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

constexpr int MAX_RANK = 4;

// A tensor map of bf16 or fp32 elements (`type`) with zero fill outside the
// tensor, swizzled by the width of its box's rows: the innermost box dim
// times the element size, 32, 64 or 128 bytes, is the swizzle (a row of a
// swizzled box may not be wider). `spec` holds rank dims, rank byte strides
// (the first is the element size and is implied) and rank box sizes,
// innermost dimension first. Returns a cudaError_t value.
inline int encode_map(CUtensorMap* map, const void* base, int rank, const long long* spec,
                      CUtensorMapDataType type) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  if (rank < 2 || rank > MAX_RANK) return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t dims[MAX_RANK], strides[MAX_RANK];
  cuuint32_t box[MAX_RANK], elem[MAX_RANK];
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(spec[i]);
    strides[i] = static_cast<cuuint64_t>(spec[rank + i]);
    box[i] = static_cast<cuuint32_t>(spec[2 * rank + i]);
    elem[i] = 1;
  }
  CUtensorMapSwizzle swizzle;
  switch (box[0] * static_cast<cuuint32_t>(spec[rank])) {  // row bytes of the box
    case 32: swizzle = CU_TENSOR_MAP_SWIZZLE_32B; break;
    case 64: swizzle = CU_TENSOR_MAP_SWIZZLE_64B; break;
    case 128: swizzle = CU_TENSOR_MAP_SWIZZLE_128B; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides + 1, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue);
}

// -------------------------------------------------------------- device side

constexpr int SWIZZLE_BYTES = 128;   // one swizzled row: 64 bf16 or 32 fp32
constexpr int SWIZZLE_ATOM = 1024;   // 8 rows; tiles are aligned to it

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, moved up to the next 1024-byte boundary.
__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  return raw + ((SWIZZLE_ATOM - (smem_u32(raw) & (SWIZZLE_ATOM - 1))) & (SWIZZLE_ATOM - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

constexpr unsigned long long STALL_NS = 2000000000ull;  // a wait this long is a fault

// Returns once the barrier has left the phase of the given parity. A wait
// that lasts STALL_NS traps, so a broken pipeline ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  unsigned long long start = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (++spins & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > STALL_NS) __trap();
    }
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// TMA store of a shared-memory box to the tensor; the part outside the
// tensor is not written. Completion is tracked per thread in bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Returns once this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Returns once this thread's TMA stores are complete.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 16 bytes from device memory to shared memory without registers
// (cp.async); with `bytes` 0 the 16 bytes are zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// 4 bytes the same way (cp.async.ca: the only form that copies fewer than
// 16), for a source that need not be 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed; the barrier counts it among the arrivals it was initialised with
// (.noinc), and its completion makes the copies visible to the threads that
// wait on it.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Barrier over every thread of the cluster; the shared-memory writes before
// it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// The address in block `rank` of this cluster of this block's shared-memory
// address `addr`, and a float read from such an address.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Makes this thread's shared-memory writes visible to the async proxy: to TMA
// stores and to wgmma's shared-memory operands.
__device__ __forceinline__ void tma_store_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the 128 threads of consumer warpgroup `group` (named barrier
// group + 1; barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most PENDING committed groups of this warpgroup are in flight.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void pin(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}

// The same for register A operands (bf16 pairs) that an asynchronous wgmma
// reads: pinned after its wait, they stay live (and unchanged) until then.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory matrix descriptor of a tile whose rows are SW bytes (32, 64
// or 128), laid down by TMA with the swizzle of that width, aligned to 1024
// bytes. Groups of 8 rows are 8 SW bytes apart (the stride offset). The same
// descriptor serves a K-major operand (a row is SW bytes of K; a k16 step of
// bf16 and a k8 step of TF32 are both 32 bytes on) and an MN-major one of
// width SW / 2 bf16 (a row is one k; 16 more of K are 16 rows on); the
// leading offset, unused for both, is set to the same 8 SW bytes. Layout
// type (bits 62-63): 1 the 128-byte swizzle, 2 the 64-byte, 3 the 32-byte.
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  static_assert(SW == 32 || SW == 64 || SW == 128, "a swizzle of 32, 64 or 128 bytes");
  constexpr uint64_t OFFSET = (8 * SW) >> 4;
  constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (OFFSET << 16) | (OFFSET << 32) |
         (LAYOUT << 62);
}

// The descriptor of a tile of 128-byte rows, the layout of every kernel but
// the bf16 flash kernels at head dims 16 and 32.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) { return smem_desc<128>(addr); }

// Descriptor moved on by `bytes` (a multiple of 16) inside its tile.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}

// The keys batch row b of a flash kernel attends to. A row with kv_lens[b]
// <= 0 is the reference's empty row: every one of its scores is masked alike,
// so it attends to all Skv keys with equal weight (its output the mean of V,
// its dq and dk 0). The kernels give it that answer by attending to all Skv
// keys with the score scale set to 0 (row_scale).
__device__ __forceinline__ bool empty_row(const int* kv_lens, int b) {
  return kv_lens && kv_lens[b] <= 0;
}

__device__ __forceinline__ int row_keys(const int* kv_lens, int b, int skv) {
  return kv_lens && kv_lens[b] > 0 ? min(kv_lens[b], skv) : skv;
}

// `scale`, or 0 for an empty row (see row_keys)
__device__ __forceinline__ float row_scale(const int* kv_lens, int b, float scale) {
  return empty_row(kv_lens, b) ? 0.f : scale;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of every wgmma below, for thread `lane` of warp `w` of
// the warpgroup: d[i] is row 16 w + lane / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2. The register A operand of a k16 step has
// the same rows; a[0], a[1] hold k = 2 (lane % 4) + {0, 1} of the two rows,
// a[2], a[3] the same 8 further on.

// d (64 x 64, fp32) = or += A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = or += A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 256, fp32) = or += A (64 x 16, shared, K-major) * B (256 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64, shared,
// MN-major: each shared-memory row is one k, its 64 values contiguous)
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 32, fp32) = or += A (64 x 16, shared, K-major) * B (32 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n16k16_rs_mn(float (&d)[8], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs_mn(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The products above by their width N: d (64 x N) = or += A (shared, K-major)
// * B (N x 16, shared, K-major), N 32, 64 or 128 ...
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_m64n32k16_ss(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_m64n64k16_ss(d, desc_a, desc_b, accumulate);
  else {
    static_assert(N == 128, "wgmma_ss: N 32, 64 or 128");
    wgmma_m64n128k16_ss(d, desc_a, desc_b, accumulate);
  }
}

// ... and d (64 x N) += A (registers) * B (16 x N, shared, MN-major), N 16, 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 16) wgmma_m64n16k16_rs_mn(d, a, desc_b);
  else if constexpr (N == 32) wgmma_m64n32k16_rs_mn(d, a, desc_b);
  else {
    static_assert(N == 64, "wgmma_rs_mn: N 16, 32 or 64");
    wgmma_m64n64k16_rs_mn(d, a, desc_b);
  }
}

// Columns [32 i, 32 i + 32) of a wider accumulator, as the 32 registers of a
// 64 x 64 product: the accumulator of m64n128 is two of m64n64 side by side
// (d[i] is column 8 (i / 4) + ..., see above), so a 64 x 128 output is two
// m64n64 products on its halves.
template <int M>
__device__ __forceinline__ float (&acc_half(float (&d)[M], int i))[32] {
  return *reinterpret_cast<float(*)[32]>(d + 32 * i);
}

// 2^x on the FMA units, for a share of a softmax's exponentials beside
// ex2.approx (the special-function unit's 16 a clock on an SM): a
// Cody-Waite split x = j + f, j = floor(x), 2^f by a degree-3 polynomial on
// [0, 1) with p(0) = 1 exactly, and j added to the exponent bits by an
// integer shift and add. The floor is a round-down add of 1.5 * 2^23, which
// leaves j in the low mantissa bits of t (|x| < 2^22). Arguments at or below
// -127 (masked scores give -inf) are clamped to -127, where f = 0, p = 1 and
// the result's bits are exactly 0, as ex2.approx.ftz gives 0 there. The
// relative error, at most 8.8e-5 over [-126, 0] (the coefficients are a
// minimax fit; tests/test_torch_kernels.py emulates the function in numpy),
// is far below the 2^-8 that rounding P and dS to bf16 costs.
constexpr float EX2_POLY_C1 = 0.695146143436431884765625f;
constexpr float EX2_POLY_C2 = 0.227564394474029541015625f;
constexpr float EX2_POLY_C3 = 0.077119089663028717041015625f;

__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float t = __fadd_rd(x, 12582912.f);
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(EX2_POLY_C3, f, EX2_POLY_C2), f, EX2_POLY_C1), f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

// ---------------------------------------------------------------- TF32
//
// The 3xTF32 product keeps fp32 accuracy on the TF32 tensor cores: each fp32
// operand a is split as a = big + small, both TF32 (8 exponent bits, 10
// mantissa bits), and A B = Ab Bb + Ab Bs + As Bb + As Bs, of which the last
// term (about 2^-22 of the product) is dropped. big is a rounded to nearest
// TF32; a - big is exact in fp32 and rounded to TF32 again, so the split
// loses about 2^-22 of a where fp32 keeps 2^-24.

// a rounded to the nearest TF32 value (ties away from zero), its low 13 bits
// 0: the magnitude's bits rounded at bit 13 with two integer operations. They
// give the bits of cvt.rna.tf32.f32 (every fp32 kernel's results were
// bit-equal both ways on an H100), and issue faster: with the conversion
// instruction the fp32 flash forward, which splits 16 K and V values and 16
// probabilities a thread a key tile, took 14 % longer
__device__ __forceinline__ float tf32_round(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void tf32_split(float a, float& big, float& small) {
  big = tf32_round(a);
  small = tf32_round(a - big);
}

// d (64 x 128, fp32) = or += A (64 x 8, shared, K-major) * B (128 x 8, shared,
// K-major), TF32 operands (fp32 words whose low 13 bits are ignored). TF32
// takes both operands K-major and has no transpose flags.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64], uint64_t desc_a,
                                                        uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32, fp32) = or += A (64 x 8, shared, K-major) * B (32 x 8, shared,
// K-major), TF32 operands
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32, fp32) = or += A (64 x 8, TF32 in registers, the fragment of
// wgmma_m64n64k8_tf32_rs below) * B (32 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 8, TF32 in registers) * B (64 x 8, shared,
// K-major). The A fragment of thread `lane` of warp `w`: a[0] is row
// 16 w + lane / 4, k = lane % 4; a[1] the row 8 further on; a[2], a[3] the
// same two rows at k = lane % 4 + 4.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace pn
