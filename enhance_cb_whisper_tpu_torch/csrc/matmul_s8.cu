// Fused s8 x s8 -> s32 matmul with a requantizing epilogue:
//
//   out[m, n] = clip(round(relu(acc * scale[n] + bias[n] [+ r[m, n] * rs[n]])), -127, 127)
//   acc[m, n] = sum_k x[m, k] * w[n, k]          (exact, int32)
//
// Replaces the TPU kernel enhance_cb_whisper_tpu/ops/matmul_s8.py:
// matmul_s8_requant (bodies _kernel_plain and _kernel_residual): the 1x1
// convolutions of the int8 ResNet catalog scorer, as matmuls over
// [B*H*W, C].
//
// Bound: device-memory bytes.  At the scorer's shapes (K, N in 128..2048,
// M in 960..57152) the work is 2*M*N*K int8 ops against M*K + N*K + M*N
// (+ M*N residual) bytes, below the H100's int8 ridge of ~590 op/B
// (1,979 TOP/s over 3.35 TB/s), so the least time is the bytes'.  What the
// design does about it:
//   * the epilogue runs on the int32 accumulators in registers; per output
//     element 1 byte is written (and 1 byte of residual read), nothing
//     wider ever reaches device memory;
//   * each 128 x 128 output tile stages 128 x 64-byte slices of x and of w
//     (w kept [N, K], K contiguous: the "col" operand) in shared memory with
//     16-byte cp.async copies, double buffered, and feeds the int8 tensor
//     cores (mma.sync m16n8k32); x is read from device memory once per
//     128-column tile of the output, which is once for N = 128;
//   * the ragged edge of M is masked (zero-filled rows, stores skipped), so
//     any M launches; N must be a multiple of 128 and K of 64.
// First version: no wgmma, no TMA, no persistent schedule.
//
// Bit-exactness with the plain version (separate f32 multiply, add, add,
// max, round-half-even, clip): the epilogue uses __fmul_rn / __fadd_rn, which
// nvcc never contracts into an fma, and __float2int_rn (half to even).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLds = kBK + 16;  // 80-byte smem rows: conflict-free fragment loads
constexpr int kThreads = 256;   // 8 warps: 4 along M x 2 along N, 32 x 64 each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t requant(int acc, float s, float b, bool has_res, int8_t r,
                                          float rs, bool relu) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (has_res) y = __fadd_rn(y, __fmul_rn(static_cast<float>(r), rs));
  if (relu) y = fmaxf(y, 0.0f);
  int q = __float2int_rn(y);
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return static_cast<int8_t>(q);
}

template <bool kHasRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
matmul_s8_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w_nk,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         const int8_t* __restrict__ residual, const float* __restrict__ res_scale,
                         int8_t* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t as[2][kBM * kLds];
  __shared__ __align__(16) int8_t bs[2][kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 0..3
  const int warp_n = warp & 1;   // 0..1
  const int g = lane >> 2;       // fragment group
  const int t4 = lane & 3;       // thread in group
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // each tile is 128 rows x 4 chunks of 16 bytes; a thread copies 2 of each
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2;
      const int col = (c & 3) * 16;
      const bool valid = m0 + row < M;
      const int8_t* src = valid ? x + static_cast<int64_t>(m0 + row) * K + k0 + col : x;
      cp_async16(&as[buf][row * kLds + col], src, valid);
      cp_async16(&bs[buf][row * kLds + col], w_nk + static_cast<int64_t>(n0 + row) * K + k0 + col,
                 true);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_count = K / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* a_s = as[kt & 1];
    const int8_t* b_s = bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const unsigned*>(&a_s[r * kLds + ks + t4 * 4]);
        af[mt][1] = *reinterpret_cast<const unsigned*>(&a_s[(r + 8) * kLds + ks + t4 * 4]);
        af[mt][2] = *reinterpret_cast<const unsigned*>(&a_s[r * kLds + ks + 16 + t4 * 4]);
        af[mt][3] = *reinterpret_cast<const unsigned*>(&a_s[(r + 8) * kLds + ks + 16 + t4 * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = warp_n * 64 + nt * 8 + g;
        unsigned bf[2];
        bf[0] = *reinterpret_cast<const unsigned*>(&b_s[c * kLds + ks + t4 * 4]);
        bf[1] = *reinterpret_cast<const unsigned*>(&b_s[c * kLds + ks + 16 + t4 * 4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], bf);
      }
    }
    __syncthreads();
  }

  // epilogue: accumulator element e sits at row g (+8 for e >= 2) and
  // column 2*t4 + (e & 1) of its 16 x 8 tile
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + warp_n * 64 + nt * 8 + t4 * 2;
    const float s0 = scale[col], s1 = scale[col + 1];
    const float b0 = bias[col], b1 = bias[col + 1];
    float rs0 = 0.0f, rs1 = 0.0f;
    if (kHasRes) {
      rs0 = res_scale[col];
      rs1 = res_scale[col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 32 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const int64_t off = static_cast<int64_t>(row) * N + col;
        int8_t r0 = 0, r1 = 0;
        if (kHasRes) {
          r0 = residual[off];
          r1 = residual[off + 1];
        }
        char2 q;
        q.x = requant(acc[mt][nt][half * 2], s0, b0, kHasRes, r0, rs0, kRelu);
        q.y = requant(acc[mt][nt][half * 2 + 1], s1, b1, kHasRes, r1, rs1, kRelu);
        *reinterpret_cast<char2*>(out + off) = q;
      }
    }
  }
}

template <bool kHasRes, bool kRelu>
void launch(const int8_t* x, const int8_t* w_nk, const float* scale, const float* bias,
            const int8_t* residual, const float* res_scale, int8_t* out, int M, int N, int K,
            cudaStream_t stream) {
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  matmul_s8_requant_kernel<kHasRes, kRelu><<<grid, kThreads, 0, stream>>>(
      x, w_nk, scale, bias, residual, res_scale, out, M, N, K);
}

}  // namespace

extern "C" {

// Shape rules the kernel needs (the wrapper checks them first): N % 128 == 0,
// K % 64 == 0, M >= 1, every pointer 16-byte aligned.  residual and
// res_scale are null for the plain epilogue.  Returns cudaGetLastError().
int ecw_matmul_s8_requant(const void* x, const void* w_nk, const void* scale, const void* bias,
                          const void* residual, const void* res_scale, void* out, int M, int N,
                          int K, int relu, void* stream) {
  if (M < 1 || N % kBN != 0 || K % kBK != 0 || N < kBN || K < kBK) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w_nk);
  auto sp = static_cast<const float*>(scale);
  auto bp = static_cast<const float*>(bias);
  auto rp = static_cast<const int8_t*>(residual);
  auto rsp = static_cast<const float*>(res_scale);
  auto op = static_cast<int8_t*>(out);
  if (residual != nullptr) {
    if (relu) launch<true, true>(xp, wp, sp, bp, rp, rsp, op, M, N, K, s);
    else launch<true, false>(xp, wp, sp, bp, rp, rsp, op, M, N, K, s);
  } else {
    if (relu) launch<false, true>(xp, wp, sp, bp, rp, rsp, op, M, N, K, s);
    else launch<false, false>(xp, wp, sp, bp, rp, rsp, op, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
