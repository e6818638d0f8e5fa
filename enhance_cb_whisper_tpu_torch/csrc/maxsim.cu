// The MaxSim proxy of a pre-projected keyword catalog against one utterance,
// for Hopper (sm_90a): stage 1 of the cascade scorer
// (efficient_kws/catalog.py: maxsim_proxy_fast), in two launches.
//
//   k[n, l, t]  = x / sqrt(max(sum x^2, 1e-12))   per keyword frame x = kwd[n, l, t, :],
//                 every step rounded to the catalog's dtype, then to the operand dtype
//   best[n, l, t] = max_j where(umask[l, j] > 0, k[n, l, t] . u[l, j], -1e30)
//   proxy[n]    = mean_l( sum_t where(kmask[n, l, t] > 0, best, 0) / max(sum_t kmask[n, l, t], 1) )
//
// u = the utterance frames, normalized by the caller and given in the operand
// dtype (bf16 or f16); the products are summed in f32.
//
// Replaces no TPU kernel: the JAX package computes this proxy with XLA
// (enhance_cb_whisper_tpu/efficient_kws/catalog.py: maxsim_proxy_fast).  It
// was added because the port's chunked torch version made stage 1 host-paced:
// ~10 launches per chunk of 128 keywords, and [L, 128 T_k, T_u] f32
// similarity maps written, masked and reread in device memory.
//
// Bound: operations.  At the 100k-keyword LEF catalog (N 100,352, L 3, T_k 75,
// T_u 750, U 64) the products are 2.17 TFLOP of bf16 against 2.9 GB of
// catalog read once, ~740 FLOP/B, above the H100's bf16 ridge of ~295: the
// least time is 2.2 ms at 989 TFLOP/s.  The design:
//   1. The similarity maps never leave the chip.  A block takes BM
//      consecutive keyword frames of one layer (the flat rows n * T_k + t,
//      so a tile may cross keywords) in groups of 64, and runs one
//      m64n128k16 wgmma per 16 elements of U against tiles of 128 utterance
//      frames.  After each tile the f32 accumulators fold into a running row
//      max held in registers; only the [N, L, T_k] row maxima are written
//      (90 MB at the cell against 2.9 GB read).
//   2. The keyword frames are normalized on the way in.  The consumer
//      warpgroup loads its rows from device memory (16 bytes a thread, eight
//      threads a row), rounds as torch does in the catalog's dtype, and
//      writes the operand tile, 128-byte swizzled, to shared memory, where
//      wgmma reads it.  The whole [BM, U] operand stays there for every
//      utterance tile.  The division is the correctly rounded one, from a
//      correctly rounded reciprocal per row and one fma correction.
//   3. The utterance tiles [128 frames x 64 elements of U] stream through a
//      TMA ring of up to 4 stages filled by one producer warp; they are read
//      from L2 (the utterance is 0.3 MB at the cell), and the ring is filled
//      while the consumers normalize.  Where U = 64 (LE, LEF), BM = 256:
//      each utterance tile meets four groups of 64 rows, which quarters the
//      L2 traffic of a 128-row block's, and the products of group r + 1 run
//      while group r is folded (two sets of accumulators).  Where U > 64
//      (L: U = 1024), BM = 64, and a tile's chunks of U accumulate in turn.
//      A U that is not a multiple of 64 (a multiple of 8) is zero-padded to
//      the next one: the utterance by the caller, the keyword frames here.
//   4. Masked and out-of-range utterance frames add -1e30 to their column,
//      only in the tiles that have such a column (a flag per tile), which is
//      exactly the reference's where(mask, sims, -1e30) (|sim| << ulp(1e30)).
//      The max propagates NaN, as torch.amax does.
//   5. A second launch reduces [N, L, T_k] to [N]: one warp a keyword, the
//      keyword mask read in its own dtype, its sum rounded to that dtype.
// Two blocks fit an SM at the LE and LEF shapes (~100 KB of shared memory
// each), so one block's normalization overlaps the other's products.
// Tried, not kept: 128-row blocks that folded each tile after waiting for
// its products, with an IEEE division per element and a fold tree the
// compiler left in local memory, took 2.4x this design's time at the LEF
// cell (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;        // utterance frames per tile
constexpr int kBK = 64;         // elements of U per chunk: one 128-byte swizzle row of a 16-bit type
constexpr int kMaxStages = 4;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMasked = -1e30f;  // the reference's sentinel
constexpr int kReduceThreads = 256;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Params {
  const void* kwd;       // [N, L, T_k, U], in_type
  const void* umask;     // [L, T_u], umask_type; null: every frame valid
  float* best;           // [N, L, T_k]
  int in_type;
  int umask_type;
  int L, Tk, Tu, U;
  int rows;     // N * T_k, the rows of one layer
  int kc;       // ceil(U / 64): chunks of the operand, zero past U
  int n_tiles;  // ceil(T_u / 128)
  int stages;
};

// propagates NaN, as torch.amax and torch.clamp_min do
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (T == kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  if constexpr (T == kF16) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float load_as_float(const void* base, int64_t i, int type) {
  if (type == kF32) return static_cast<const float*>(base)[i];
  const unsigned short h = static_cast<const unsigned short*>(base)[i];
  if (type == kBF16) return __uint_as_float(static_cast<uint32_t>(h) << 16);
  return __half2float(__ushort_as_half(h));
}

// one unit of 8 elements as 32-bit words: 8 of f32, the first 4 of a 16-bit type
template <int T>
__device__ __forceinline__ void load_unit(uint32_t (&w)[8], const void* kwd, int64_t elem, bool ok) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0;
    return;
  }
  if constexpr (T == kF32) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const float*>(kwd) + elem);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(kwd) + elem));
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  }
}

template <int T>
__device__ __forceinline__ void decode(const uint32_t (&w)[8], float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (T == kF32) {
      x[i] = __uint_as_float(w[i]);
    } else {
      const uint32_t h = (i & 1) ? (w[i >> 1] >> 16) : (w[i >> 1] & 0xFFFFu);
      if constexpr (T == kBF16) {
        x[i] = __uint_as_float(h << 16);
      } else {
        x[i] = __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
      }
    }
  }
}

template <bool kHalf>
__device__ __forceinline__ uint32_t operand_bits(float y) {
  if constexpr (kHalf) return __half_as_ushort(__float2half_rn(y));
  return __bfloat16_as_ushort(__float2bfloat16_rn(y));
}

// The consumer warpgroup normalizes rows [r0 + base, r0 + base + 16 P) of
// layer l into the operand tile: kc chunks of [BM rows x 128 B], 128-byte
// swizzled.  Thread (rr = tid / 8, sub = tid % 8) takes 8-element unit `sub`
// of each 64-element chunk of rows base + rr, base + rr + 16, ...; the eight
// threads of a row sum their squares with shuffles.  Every step is rounded
// to the catalog's dtype T as torch's _safe_normalize rounds it (x * x, the
// sum, the clamp, the square root, the quotient), then the quotient to the
// operand dtype.  The quotient is the correctly rounded one, from the
// correctly rounded reciprocal and one fma correction (Markstein).
template <int T, bool kHalf, int P, int BM>
__device__ __forceinline__ void normalize_rows(uint8_t* a_tile, const Params& p, int r0, int base, int l,
                                               int tid) {
  const int sub = tid & 7, rr = tid >> 3;
  int64_t off[P];
  bool ok[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int r = r0 + base + q * 16 + rr;
    ok[q] = r < p.rows;
    const int n = ok[q] ? r / p.Tk : 0;
    const int t = ok[q] ? r - n * p.Tk : 0;
    off[q] = ((static_cast<int64_t>(n) * p.L + l) * p.Tk + t) * p.U + sub * 8;
  }
  uint32_t raw[P][8];
  float ss[P];
#pragma unroll
  for (int q = 0; q < P; ++q) ss[q] = 0.0f;
  for (int c = 0; c < p.kc; ++c) {
    const bool in_row = c * kBK + sub * 8 < p.U;  // units past U are zero in the operand
#pragma unroll
    for (int q = 0; q < P; ++q) load_unit<T>(raw[q], p.kwd, off[q] + c * kBK, ok[q] && in_row);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float x[8];
      decode<T>(raw[q], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss[q] = __fadd_rn(ss[q], round_to<T>(__fmul_rn(x[e], x[e])));
    }
  }
  float norm[P], inv[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float s = ss[q];
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
    s = round_to<T>(max_nan(round_to<T>(s), 1e-12f));
    norm[q] = round_to<T>(__fsqrt_rn(s));
    inv[q] = __frcp_rn(norm[q]);
  }
  for (int c = 0; c < p.kc; ++c) {
    const bool in_row = c * kBK + sub * 8 < p.U;
    if (p.kc > 1) {
#pragma unroll
      for (int q = 0; q < P; ++q) load_unit<T>(raw[q], p.kwd, off[q] + c * kBK, ok[q] && in_row);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float x[8];
      decode<T>(raw[q], x);
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float q0 = __fmul_rn(x[e], inv[q]);
        const float y = __fmaf_rn(__fmaf_rn(-norm[q], q0, x[e]), inv[q], q0);
        const uint32_t bits = in_row ? operand_bits<kHalf>(round_to<T>(y)) : 0u;
        packed[e / 2] = (e & 1) ? (packed[e / 2] | (bits << 16)) : bits;
      }
      const int row = base + q * 16 + rr;
      *reinterpret_cast<uint4*>(a_tile + c * BM * 128 + row * 128 + ((sub ^ (row & 7)) << 4)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

template <int T, bool kHalf, int BM>
__device__ __forceinline__ void normalize_tile(uint8_t* a_tile, const Params& p, int r0, int l, int tid) {
  constexpr int kRows = BM < 128 ? BM : 128;  // rows a pass of the warpgroup takes: 16 a step
#pragma unroll 1
  for (int base = 0; base < BM; base += kRows) normalize_rows<T, kHalf, kRows / 16, BM>(a_tile, p, r0, base, l, tid);
}

// fold one m64n128 accumulator into its two rows' running maxima (a tree
// over each thread's 32 values of a row); a tile with a masked or missing
// frame first adds its column bias
__device__ __forceinline__ void fold_max(float (&acc)[64], float (&rmax)[2], const float* bias, bool plain,
                                         int lane) {
  if (!plain) {
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const float2 b = *reinterpret_cast<const float2*>(bias + jj * 8 + (lane & 3) * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * jj + 2 * h] += b.x;
        acc[4 * jj + 2 * h + 1] += b.y;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) m[jj] = max_nan(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) m[jj] = max_nan(m[jj], m[jj + 8]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) m[jj] = max_nan(m[jj], m[jj + 4]);
    m[0] = max_nan(max_nan(m[0], m[2]), max_nan(m[1], m[3]));
    rmax[h] = max_nan(rmax[h], m[0]);
  }
}

__device__ __forceinline__ void settle(float (&acc)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(acc[q])::"memory");
}

// one block: rows [blockIdx.x * BM, + BM) of layer blockIdx.y, BM = 64 * R.
// R > 1 needs U <= 64 (one chunk): each utterance tile then meets the R
// groups of 64 rows in turn, the products of group r + 1 running while
// group r is folded (two accumulators).  R == 1 takes any U.
template <bool kHalf, int R>
__global__ void __launch_bounds__(kThreads, 2)
maxsim_rows_kernel(const __grid_constant__ CUtensorMap map_u, const Params p) {
  constexpr int BM = 64 * R;
  constexpr int kA = BM * 128;    // bytes of one operand chunk [BM][64]
  constexpr int kB = kBN * 128;   // bytes of one utterance stage [128][64]

  // shared memory, from a 1024-byte boundary (the swizzle atom):
  //   operand  kc x [BM][128 B] of normalized keyword frames
  //   ring     stages x [128][128 B] of utterance frames
  //   bias     n_tiles x 128 f32: 0, or -1e30 for a masked or missing frame
  //   flags    n_tiles int: the tile has no such frame
  //   barriers full[kMaxStages], empty[kMaxStages]
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int kc = p.kc, stages = p.stages, nt = p.n_tiles;
  const uint32_t a_base = smem_addr(smem);
  const uint32_t b_ring = a_base + kc * kA;
  float* bias = reinterpret_cast<float*>(smem + kc * kA + stages * kB);
  int* whole = reinterpret_cast<int*>(bias + nt * kBN);
  const uint32_t bars = (smem_addr(whole + nt) + 7) & ~7u;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };

  const int tid = threadIdx.x;
  const int l = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  const int total = nt * kc;  // utterance chunks, tile-major
  const int first = total < stages ? total : stages;
  const int u_row0 = l * p.Tu;

  if (tid == kConsumers) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    fence_barrier_init();
    prefetch_tensormap(&map_u);
    for (int i = 0; i < first; ++i) {
      mbar_arrive_expect_tx(full(i), kB);
      tma_load_2d(b_ring + i * kB, &map_u, full(i), (i % kc) * kBK, u_row0 + (i / kc) * kBN);
    }
  } else if (tid < kConsumers) {
    const int warp = tid / 32, lane = tid & 31;
    auto valid = [&](int col) {
      return col < p.Tu && (p.umask == nullptr || load_as_float(p.umask, static_cast<int64_t>(u_row0) + col,
                                                                 p.umask_type) > 0.0f);
    };
    for (int col = tid; col < nt * kBN; col += kConsumers) bias[col] = valid(col) ? 0.0f : kMasked;
    for (int j = warp; j < nt; j += kConsumers / 32) {
      bool ok = true;
      for (int q = lane; q < kBN; q += 32) ok = ok && valid(j * kBN + q);
      ok = __all_sync(0xffffffffu, ok);
      if (lane == 0) whole[j] = ok;
    }
    switch (p.in_type) {
      case kF32: normalize_tile<kF32, kHalf, BM>(smem, p, r0, l, tid); break;
      case kBF16: normalize_tile<kBF16, kHalf, BM>(smem, p, r0, l, tid); break;
      default: normalize_tile<kF16, kHalf, BM>(smem, p, r0, l, tid); break;
    }
    fence_proxy_async_shared();  // the operand tile is read by wgmma (the async proxy)
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int i = first; i < total; ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) - 1) & 1);
        mbar_arrive_expect_tx(full(s), kB);
        tma_load_2d(b_ring + s * kB, &map_u, full(s), (i % kc) * kBK, u_row0 + (i / kc) * kBN);
      }
    }
    return;
  }

  // consumer warpgroup.  wgmma's accumulator layout: register 4j + 2h + e of
  // thread (warp w, lane ln) holds row 16 w + ln / 4 + 8 h of the group,
  // column 8 j + 2 (ln % 4) + e of the tile
  const int warp = tid / 32, lane = tid & 31;
  float acc[2][64];
  float rmax[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) rmax[r][0] = rmax[r][1] = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[0][q] = acc[1][q] = 0.0f;
  // the products of group r (rows 64 r ..) and chunk c against ring stage s
  auto issue = [&](float (&d)[64], int r, int c, int s) {
    const uint64_t da = desc_k_sw128(a_base + c * kA + r * 64 * 128);
    const uint64_t db = desc_k_sw128(b_ring + s * kB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_m64n128k16_f32<kHalf>(d, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
    wgmma_commit();
  };
  int i = 0;
  for (int j = 0; j < nt; ++j) {
    const bool plain = whole[j] != 0;
    const float* tile_bias = bias + j * kBN;
    if constexpr (R > 1) {
      const int s = j % stages;
      mbar_wait(full(s), (j / stages) & 1);
      issue(acc[0], 0, 0, s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r + 1 < R) {
          issue(acc[(r + 1) & 1], r + 1, 0, s);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(s));
        }
        settle(acc[r & 1]);
        fold_max(acc[r & 1], rmax[r], tile_bias, plain, lane);
      }
    } else {
      for (int c = 0; c < kc; ++c, ++i) {
        const int s = i % stages;
        mbar_wait(full(s), (i / stages) & 1);
        issue(acc[0], 0, c, s);
        wgmma_wait<0>();
        settle(acc[0]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      fold_max(acc[0], rmax[0], tile_bias, plain, lane);
    }
  }

  // the four threads of a row hold its columns 2 (ln % 4) + {0, 1} of each 8
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[r][h];
      v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int row = r0 + r * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if ((lane & 3) == 0 && row < p.rows) {
        const int n = row / p.Tk, t = row - n * p.Tk;
        p.best[(static_cast<int64_t>(n) * p.L + l) * p.Tk + t] = v;
      }
    }
}

// one warp a keyword: the kmask-weighted mean over its frames, then the mean
// over layers, in the reference's order of roundings
__global__ void __launch_bounds__(kReduceThreads)
maxsim_reduce_kernel(const float* best, const void* kmask, int kmask_type, float* out, int N, int L, int Tk) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kReduceThreads / 32) + threadIdx.x / 32;
  if (n >= N) return;
  float total = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int64_t base = (static_cast<int64_t>(n) * L + l) * Tk;
    float s = 0.0f, d = 0.0f;
    for (int t = lane; t < Tk; t += 32) {
      const float b = best[base + t];
      if (kmask != nullptr) {
        const float m = load_as_float(kmask, base + t, kmask_type);
        s += m > 0.0f ? b : 0.0f;
        d += m;
      } else {
        s += b;
      }
    }
#pragma unroll
    for (int w = 16; w >= 1; w /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, w);
      d += __shfl_xor_sync(0xffffffffu, d, w);
    }
    if (kmask != nullptr) {
      // torch.sum of the mask in its own dtype, then clamp_min(., 1)
      d = kmask_type == kBF16 ? round_to<kBF16>(d) : kmask_type == kF16 ? round_to<kF16>(d) : d;
      total += __fdiv_rn(s, max_nan(d, 1.0f));
    } else {
      total += __fdiv_rn(s, static_cast<float>(Tk));
    }
  }
  if (lane == 0) out[n] = __fdiv_rn(total, static_cast<float>(L));
}

// dynamic shared memory of a block, laid out as the kernel's comment says
int smem_bytes(int bm, int kc, int stages, int n_tiles) {
  const int flags = (n_tiles * 4 + 7) & ~7;
  return 1024 + bm * kc * kBK * 2 + stages * kBN * 128 + n_tiles * kBN * 4 + flags + 8 * 2 * kMaxStages;
}

template <bool kHalf, int R>
cudaError_t launch_rows(const CUtensorMap& map_u, const Params& p, int smem, cudaStream_t stream) {
  auto kernel = maxsim_rows_kernel<kHalf, R>;
  static int allowed[kMaxDevices] = {};  // dynamic shared memory this kernel may take, per device
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.rows + 64 * R - 1) / (64 * R), p.L);
  kernel<<<grid, kThreads, smem, stream>>>(map_u, p);
  return cudaGetLastError();
}

bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

}  // namespace

extern "C" {

// kwd [N, L, T_k, U] (kwd_type: 0 f32, 1 bf16, 2 f16) with U % 8 == 0, utt
// [L, T_u, U_pad] in the operand dtype (op_type 1 bf16 or 2 f16), U_pad = U
// rounded up to a multiple of 64 and zero past U, umask [L, T_u] and kmask
// [N, L, T_k] (any of the three dtypes; null: all valid), best [N, L, T_k]
// f32 scratch, out [N] f32; every tensor contiguous, kwd and utt 16-byte
// aligned.  (bm, stages) is the wrapper's launch plan: bm 256 where U <= 64,
// else 64; stages as many as fit, at most 4.  A bad shape or plan
// returns cudaErrorInvalidValue and launches nothing; otherwise the first
// launch error (cudaGetLastError after each of the two launches).
int ecw_maxsim_proxy(const void* kwd, int kwd_type, const void* utt, int op_type, const void* umask,
                     int umask_type, const void* kmask, int kmask_type, float* best, float* out, int N, int L,
                     int Tk, int Tu, int U, int bm, int stages, void* stream) {
  const bool types_ok = kwd_type >= kF32 && kwd_type <= kF16 && (op_type == kBF16 || op_type == kF16) &&
                        umask_type >= kF32 && umask_type <= kF16 && kmask_type >= kF32 && kmask_type <= kF16;
  const int64_t rows = static_cast<int64_t>(N) * Tk;
  const bool shape_ok = N >= 1 && L >= 1 && L <= 65535 && Tk >= 1 && Tu >= 1 && U >= 8 && U % 8 == 0 &&
                        rows <= 0x7FFFFFFF && static_cast<int64_t>(L) * Tu <= 0x7FFFFFFF &&
                        static_cast<int64_t>(N) * 32 <= 0x7FFFFFFF;
  const int n_tiles = (Tu + kBN - 1) / kBN;
  const int kc = (U + kBK - 1) / kBK;
  const bool plan_ok = (bm == (kc == 1 ? 4 * 64 : 64)) && stages >= 1 && stages <= kMaxStages &&
                       smem_bytes(bm, kc, stages, n_tiles) <= kSmemLimit;
  if (!types_ok || !shape_ok || !plan_ok || !aligned16(kwd) || !aligned16(utt)) return cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the utterance as [L * T_u rows, U_pad] 16-bit, read in [128 rows, 64
  // elements] tiles, 128B-swizzled; a tile past the layer's end reads the
  // next layer's frames or zeros, both masked by the bias
  CUtensorMap map_u;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kc) * kBK, static_cast<cuuint64_t>(L) * Tu};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kc) * kBK * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(kBN)};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&map_u, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, const_cast<void*>(utt), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Params p{kwd, umask, best, kwd_type, umask_type, L, Tk, Tu, U, static_cast<int>(rows), kc, n_tiles, stages};
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(bm, kc, stages, n_tiles);
  const bool half = op_type == kF16;
  cudaError_t err = half ? (bm == 256 ? launch_rows<true, 4>(map_u, p, smem, s) : launch_rows<true, 1>(map_u, p, smem, s))
                         : (bm == 256 ? launch_rows<false, 4>(map_u, p, smem, s) : launch_rows<false, 1>(map_u, p, smem, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kReduceThreads / 32;
  maxsim_reduce_kernel<<<(N + per_block - 1) / per_block, kReduceThreads, 0, s>>>(best, kmask, kmask_type, out, N,
                                                                                  L, Tk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
