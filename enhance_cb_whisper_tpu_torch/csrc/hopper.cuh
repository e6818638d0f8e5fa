// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile
// copies, wgmma with both operands in shared memory, and thread-block
// cluster barriers and distributed shared memory; on the host, the tensor
// map encoder and the dynamic shared memory a kernel may take.
// Header-only, no dependencies beyond the CUDA toolkit.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and the cluster
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// blocks until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------

// 2-D tile global -> shared; completes `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D tile shared -> global; rows and columns outside the tensor are not written
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// brings a tensor map (a __grid_constant__ kernel parameter) into the TMA unit's cache
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// closes the group of TMA stores this thread has issued since the last commit
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed store groups are still
// reading their shared-memory source
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy shared-memory accesses with later
// async-proxy ones (TMA store, wgmma) and earlier async-proxy writes (TMA load)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `threads` threads (a multiple of 32), id 1..15
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand tile whose rows are
// 128 bytes long and stored with the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes: 8-row groups 1024 bytes apart (SBO),
// the leading offset unused for this layout, layout type 1 (128B swizzle).
// The tile must start on a 1024-byte boundary; a step of 32 bytes along K
// adds 2 to the descriptor (its address field counts 16-byte units).
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 128] (s32) += A[64 x 32] (s8, K-major, shared) * B[128 x 32]^T (s8, K-major, shared)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the 64 accumulator operands of an m64n128 wgmma, %0 .. %63
#define HOPPER_WGMMA_D64(T)                                                                                      \
  T(d[0]), T(d[1]), T(d[2]), T(d[3]), T(d[4]), T(d[5]), T(d[6]), T(d[7]), T(d[8]), T(d[9]), T(d[10]), T(d[11]),  \
      T(d[12]), T(d[13]), T(d[14]), T(d[15]), T(d[16]), T(d[17]), T(d[18]), T(d[19]), T(d[20]), T(d[21]),        \
      T(d[22]), T(d[23]), T(d[24]), T(d[25]), T(d[26]), T(d[27]), T(d[28]), T(d[29]), T(d[30]), T(d[31]),        \
      T(d[32]), T(d[33]), T(d[34]), T(d[35]), T(d[36]), T(d[37]), T(d[38]), T(d[39]), T(d[40]), T(d[41]),        \
      T(d[42]), T(d[43]), T(d[44]), T(d[45]), T(d[46]), T(d[47]), T(d[48]), T(d[49]), T(d[50]), T(d[51]),        \
      T(d[52]), T(d[53]), T(d[54]), T(d[55]), T(d[56]), T(d[57]), T(d[58]), T(d[59]), T(d[60]), T(d[61]),        \
      T(d[62]), T(d[63])
#define HOPPER_WGMMA_REGS64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x 128] (f32) (+)= A[64 x 16] * B[128 x 16]^T, both 16-bit (bf16, or
// f16 with kHalf) and K-major in shared memory; accumulate = 0 overwrites D
template <bool kHalf>
__device__ __forceinline__ void wgmma_m64n128k16_f32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                     int accumulate) {
  if constexpr (kHalf) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HOPPER_WGMMA_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : HOPPER_WGMMA_D64("+f")
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_WGMMA_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : HOPPER_WGMMA_D64("+f")
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
}

// ---- clusters -----------------------------------------------------------

// every thread of every block of the cluster arrives, then waits; shared
// memory written before it is visible to the cluster's blocks after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of this block's shared-memory location `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int kMaxDevices = 64;

// lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device; `allowed` (kMaxDevices entries, one array per kernel) keeps what
// each device already allows, since the attribute is set per device
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int smem, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace hopper
