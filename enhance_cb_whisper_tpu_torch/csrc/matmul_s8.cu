// Fused s8 x s8 -> s32 matmul with a requantizing epilogue, for Hopper (sm_90a):
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
// (1,979 TOP/s over 3.35 TB/s), so the least time is the bytes'.  Each
// launch moves only a few MB, so fixed costs per block (pipeline fill,
// epilogue, store drain) weigh as much as the streaming rate.  The four
// design points and what each does about it:
//   1. TMA ring + wgmma (done).  One producer warp issues TMA loads of
//      [BM x 128 B] tiles of x and [128 x 128 B] tiles of w (kept [N, K],
//      K contiguous) into a ring of up to 4 stages with full/empty
//      mbarriers; one or two consumer warpgroups run
//      wgmma.m64n128k32.s32.s8.s8 on them straight from shared memory
//      (128-byte swizzle, both operands K-major).  TMA zero-fills rows
//      past M, so the main loop has no masking.  The ring has only as many
//      stages as the block has k-tiles, which leaves room for two or more
//      blocks per SM: one block's epilogue overlaps another's loads.
//   2. Epilogue through shared memory (done).  The residual tile is
//      TMA-loaded at block start into the buffer the output is staged in,
//      so it arrives during the main loop.  The requant runs on the int32
//      accumulators in registers without a branch (the kernel is built
//      with and without a residual; ReLU is a clip bound), so the compiler
//      interleaves all of a thread's elements; its column parameters are
//      staged in shared memory first, and all its loads come before its
//      stores.  The int8 tile is written in place of the residual and
//      TMA-stored (rows past M clipped): full 128-byte lines instead of
//      2-byte stores at row stride N.
//   3. Planned tiles with exact split-K (done).  The wrapper's launch_plan
//      picks BM in {64, 128} and a split of K per shape.  The split blocks
//      of one output tile form a thread-block cluster; each hands its int32
//      partial sums to the first block through distributed shared memory,
//      and only that block runs the epilogue.  Integer sums are exact in any
//      order (|acc| <= 127^2 * 2048 < 2^31), so a split changes no code and
//      the result is deterministic, inside one launch, with no workspace.
//   4. Persistent schedule (tried, not kept): one block per SM walking its
//      tiles, with the ring running across tiles and triple-buffered
//      staging, was slower at every main-path shape than blocks that each
//      take one tile, two or more to an SM.
//
// Bit-exactness with the plain version (separate f32 multiply, add, add,
// max, round-half-even, clip): the epilogue uses __fmul_rn / __fadd_rn, which
// nvcc never contracts into an fma, and rounds half to even (see requant).

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;       // bytes of K per stage: one 128-byte swizzle row
constexpr int kBN = 128;       // output columns per tile: one m64n128k32 wgmma per 32 bytes of K
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;   // the portable cluster size
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90

struct Params {
  const float* scale;
  const float* bias;
  const float* res_scale;  // [N] (rs_stride 1) or one value (rs_stride 0); null: no residual
  int rs_stride;
  int M;
  int k_tiles;  // K / 128
  int split;    // blocks per output tile along K, one cluster
  int stages;
  int relu;
};

// 1.5 * 2^23: between 2^23 and 2^24 a float's unit in the last place is 1,
// so adding it to a float in [-2^22, 2^22] rounds to an integer (half to
// even) and leaves that integer in the low bits of the result; and the
// float with bits kMagicBits + r, less kMagic, is the integer r.  The
// epilogue rounds and converts the residual with float adds alone.
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// the int8 code of one output element, in the low byte of the result:
// clip(round(relu(acc * s + b [+ r * rs])), -127, 127), every step rounded
// to f32 as the plain version does (no fma contraction).  Clipping before
// rounding gives the same code (round is monotonic and fixes the integers
// +-127), and ReLU is the clip's lower end moved to 0 (lo = 0, else -127):
// no branch, so the compiler interleaves all of a thread's elements.
template <bool kRes>
__device__ __forceinline__ int requant(int acc, float s, float b, int r, float rs, float lo) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if constexpr (kRes) {
    const float rf = __int_as_float(kMagicBits + r) - kMagic;  // exact for |r| < 2^22
    y = __fadd_rn(y, __fmul_rn(rf, rs));
  }
  y = fminf(fmaxf(y, lo), 127.0f);
  return __float_as_int(__fadd_rn(y, kMagic));  // low byte: round-half-even(y)
}

template <int BM>
constexpr int kThreads = BM / 64 * 128 + 32;  // consumer warpgroups, then the producer warp

template <int BM, bool kRes>
__global__ void __launch_bounds__(kThreads<BM>)
matmul_s8_requant_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_res,
                         const __grid_constant__ CUtensorMap map_out, const Params p) {
  constexpr int kConsumers = BM / 64 * 128;
  constexpr int kR = kBN / 2;  // int32 accumulators per consumer thread
  constexpr int kA = BM * kBK, kB = kBN * kBK;

  // shared memory, from a 1024-byte boundary (the swizzle atom):
  //   ring     stages x [BM][128 B] of x, then stages x [128][128 B] of w;
  //            after the main loop of a split block, its int32 partials
  //   tile     [BM][128 B], 128-byte swizzled: residual in, codes out
  //   columns  scale, bias and res_scale of the tile's 128 columns, f32
  //   barriers full[kMaxStages], empty[kMaxStages], residual
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = p.stages;
  const int ring = stages * (kA + kB);
  const int part = p.split > 1 ? BM * kBN * 4 : 0;
  uint8_t* tile = smem + (ring > part ? ring : part);
  const uint32_t a_ring = smem_addr(smem), b_ring = a_ring + stages * kA;
  float* cols = reinterpret_cast<float*>(tile + kA);
  const uint32_t bars = smem_addr(cols + 3 * kBN);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const uint32_t res_bar = bars + 8 * 2 * kMaxStages;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * BM;
  const int kt0 = blockIdx.x * p.k_tiles / p.split;
  const int nk = (blockIdx.x + 1) * p.k_tiles / p.split - kt0;
  const bool leader = blockIdx.x == 0;  // cluster (split, 1, 1): rank == blockIdx.x

  // start-up: the producer thread sets up the barriers and issues the
  // residual and the first ring of loads at once, while the consumers bring
  // the epilogue's column parameters into shared memory (read from global
  // memory inside the epilogue, each load would wait for the code stores
  // before it); the block barrier then publishes both
  const int first = nk < stages ? nk : stages;
  if (tid == kConsumers) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_init(res_bar, 1);
    fence_barrier_init();
    prefetch_tensormap(&map_x);
    prefetch_tensormap(&map_w);
    if (kRes && leader) {
      mbar_arrive_expect_tx(res_bar, kA);
      tma_load_2d(smem_addr(tile), &map_res, res_bar, n0, m0);
    }
    for (int i = 0; i < first; ++i) {
      mbar_arrive_expect_tx(full(i), kA + kB);
      tma_load_2d(a_ring + i * kA, &map_x, full(i), (kt0 + i) * kBK, m0);
      tma_load_2d(b_ring + i * kB, &map_w, full(i), (kt0 + i) * kBK, n0);
    }
  } else if (tid < kConsumers) {
    for (int c = tid; c < kBN; c += kConsumers) {
      cols[c] = p.scale[n0 + c];
      cols[kBN + c] = p.bias[n0 + c];
      if (kRes) cols[2 * kBN + c] = p.res_scale[p.rs_stride * (n0 + c)];
    }
  }
  __syncthreads();

  int acc[kR];
  if (tid >= kConsumers) {
    // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int i = first; i < nk; ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) - 1) & 1);
        mbar_arrive_expect_tx(full(s), kA + kB);
        tma_load_2d(a_ring + s * kA, &map_x, full(s), (kt0 + i) * kBK, m0);
        tma_load_2d(b_ring + s * kB, &map_w, full(s), (kt0 + i) * kBK, n0);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile
    const int wg = tid / 128;
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0;
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      __syncwarp();
      const uint64_t da = desc_k_sw128(a_ring + s * kA + wg * 64 * kBK);
      const uint64_t db = desc_k_sw128(b_ring + s * kB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i2 = 0; i2 < kR; ++i2) asm volatile("" : "+r"(acc[i2])::"memory");
      if ((tid & 31) == 0) mbar_arrive(empty(s));
    }
  }

  if (p.split > 1) {
    // exact split-K: the other blocks of the cluster hand their partial
    // sums to the leader through distributed shared memory; each thread
    // reads exactly the values its counterpart wrote
    int4* part4 = reinterpret_cast<int4*>(smem);
    if (tid < kConsumers && !leader) {
      // the partials overwrite the ring: every warpgroup's wgmma must be done with it
      named_barrier_sync(1, kConsumers);
      fence_proxy_async_shared();  // the ring was last written by TMA
#pragma unroll
      for (int q = 0; q < kR / 4; ++q)
        part4[q * kConsumers + tid] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    cluster_sync();
    if (tid < kConsumers && leader) {
      for (int r = 1; r < p.split; ++r) {
        const uint32_t peer = map_to_rank(smem_addr(part4 + tid), r);
#pragma unroll
        for (int q = 0; q < kR / 4; ++q) {
          const int4 v = ld_cluster_v4(peer + q * kConsumers * 16);
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
    }
    cluster_sync();  // a block's shared memory must outlive its peers' reads
    if (!leader) return;
  }
  if (tid >= kConsumers) return;

  // epilogue.  wgmma's accumulator layout: register 4j + 2h + e of thread
  // (warp w, lane l) of warpgroup wg holds row 64 wg + 16 w + l / 4 + 8 h,
  // column 8 j + 2 (l % 4) + e.  First every load and the requant, each
  // code pair kept in place of its accumulators, then every store, so no
  // load waits behind a store.
  if (kRes) mbar_wait(res_bar, 0);
  const int lane = tid & 31;
  const float lo = p.relu ? 0.0f : -127.0f;
  const int row0 = tid / 128 * 64 + (tid / 32 % 4) * 16 + (lane >> 2);
  auto cell = [&](int j, int h) {  // the 128B-swizzled address of (row, col)
    const int row = row0 + 8 * h, col = j * 8 + (lane & 3) * 2;
    return reinterpret_cast<uint16_t*>(tile + row * 128 + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15)));
  };
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const float2 sc = *reinterpret_cast<const float2*>(cols + col);
    const float2 bi = *reinterpret_cast<const float2*>(cols + kBN + col);
    const float2 rs = kRes ? *reinterpret_cast<const float2*>(cols + 2 * kBN + col) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r0 = 0, r1 = 0;
      if (kRes) {
        const char2 r = *reinterpret_cast<const char2*>(cell(j, h));
        r0 = r.x;
        r1 = r.y;
      }
      const int q0 = requant<kRes>(acc[4 * j + 2 * h], sc.x, bi.x, r0, rs.x, lo);
      const int q1 = requant<kRes>(acc[4 * j + 2 * h + 1], sc.y, bi.y, r1, rs.y, lo);
      acc[4 * j + 2 * h] = __byte_perm(q0, q1, 0x0040);  // low bytes of q0 and q1
    }
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) *cell(j, h) = static_cast<uint16_t>(acc[4 * j + 2 * h]);
  fence_proxy_async_shared();
  named_barrier_sync(1, kConsumers);
  if (tid == 0) {
    tma_store_2d(&map_out, smem_addr(tile), n0, m0);
    tma_store_commit();
    tma_store_wait_read<0>();
  }
}

// a row-major [rows, cols] int8 matrix read or written in [box_rows, 128 B] tiles, 128B-swizzled
bool tile_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory of a block, laid out as the kernel's comment says
int smem_bytes(int bm, int stages, int split) {
  const int ring = stages * (bm + kBN) * kBK;
  const int part = split > 1 ? bm * kBN * 4 : 0;
  return 1024 + (ring > part ? ring : part) + bm * kBK + 3 * kBN * 4 + 8 * (2 * kMaxStages + 1);
}

template <int BM, bool kRes>
cudaError_t launch(const void* x, const void* w_nk, const void* residual, void* out, int N, int K,
                   const Params& p, cudaStream_t stream) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_x, map_w, map_res, map_out;
  if (!tile_map(encode, &map_x, x, p.M, K, BM) || !tile_map(encode, &map_w, w_nk, N, K, kBN) ||
      !tile_map(encode, &map_out, out, p.M, N, BM) ||
      !tile_map(encode, &map_res, residual != nullptr ? residual : out, p.M, N, BM))
    return cudaErrorInvalidValue;

  auto kernel = matmul_s8_requant_kernel<BM, kRes>;
  const int smem = smem_bytes(BM, p.stages, p.split);
  static int allowed[kMaxDevices] = {};  // dynamic shared memory this kernel may take, per device
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, N / kBN, (p.M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads<BM>);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, map_res, map_out, p);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x [M, K], w_nk [N, K], out [M, N] and residual [M, N] int8, scale and bias
// [N] f32, res_scale [N] (rs_stride 1) or a single f32 (rs_stride 0);
// residual and res_scale both null for the plain epilogue.  (bm, split) is
// the wrapper's launch plan: output tiles of bm x 128 with bm in {64, 128},
// K cut into 1 <= split <= min(8, K / 128) slices.  N % 128 == 0, K % 128
// == 0, every pointer 16-byte aligned.  A bad shape or plan returns
// cudaErrorInvalidValue and launches nothing; otherwise returns the
// launch's error code.
int ecw_matmul_s8_requant(const void* x, const void* w_nk, const void* scale, const void* bias,
                          const void* residual, const void* res_scale, int rs_stride, void* out, int M,
                          int N, int K, int relu, int bm, int split, void* stream) {
  const int k_tiles = K / kBK;
  const bool plan_ok = (bm == 64 || bm == 128) && split >= 1 && split <= kMaxSplit && split <= k_tiles;
  const bool shape_ok = M >= 1 && N >= kBN && N % kBN == 0 && K >= kBK && K % kBK == 0 &&
                        (M + bm - 1) / bm <= 65535;
  const bool args_ok = (residual == nullptr) == (res_scale == nullptr) && (rs_stride == 0 || rs_stride == 1) &&
                       aligned16(x) && aligned16(w_nk) && aligned16(scale) && aligned16(bias) &&
                       aligned16(residual) && aligned16(out) && (rs_stride == 0 || aligned16(res_scale));
  if (!plan_ok || !shape_ok || !args_ok) return cudaErrorInvalidValue;
  // as many stages as the block has k-tiles, up to 4 and to what fits
  const int per_split = (k_tiles + split - 1) / split;
  int stages = per_split < kMaxStages ? per_split : kMaxStages;
  while (stages > 1 && smem_bytes(bm, stages, split) > kSmemLimit) --stages;
  Params p{static_cast<const float*>(scale), static_cast<const float*>(bias),
           static_cast<const float*>(res_scale), rs_stride, M, k_tiles, split, stages, relu};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (residual != nullptr) {
    err = bm == 64 ? launch<64, true>(x, w_nk, residual, out, N, K, p, s)
                   : launch<128, true>(x, w_nk, residual, out, N, K, p, s);
  } else {
    err = bm == 64 ? launch<64, false>(x, w_nk, residual, out, N, K, p, s)
                   : launch<128, false>(x, w_nk, residual, out, N, K, p, s);
  }
  cudaGetLastError();  // clear it: the returned code reports this launch
  return static_cast<int>(err);
}

}  // extern "C"
