// Beam-search self-attention of one decode step over an UNPERMUTED cache, read
// through an ancestry map, for Hopper (sm_90a): kernel K4 of the port.
//
//   row(b, k, t) = b * K + anc[b, k, t]       the physical row that holds logical
//                                             beam k's token at position t
//   s[b, k, h, t] = q[b K + k, h] . K[row(b, k, t), t, h]          (f32 sums)
//                   or NEG_INF where mask[b K + k, t] == 0
//   p = softmax_t(s)                          (f32; rounded to bf16 for bf16 values)
//   out[b K + k, h] = sum_{t < length} p[b, k, h, t] V[row(b, k, t), t, h]   (f32 sums)
//
// q, K, V and out in f32 or bf16, Dh <= 64 (every Whisper's is 64), K <=
// 32767 beams, length <= 448.  It is
// models/whisper.py's _attention over the rows gathered by the map, which is
// the plain version (ops/beam_attention.py: ancestry_attention_plain).
//
// Replaces no TPU kernel: the JAX package's _ancestry_attention
// (enhance_cb_whisper_tpu/models/whisper.py) is left to XLA, as one-hot
// einsums over the whole beam.  The port had reordered the cache instead:
// every beam step copied the written prefix of every self-attention slab by
// the selected parents (index_select, then a strided write back), and the
// f32 einsum copied the cache view into a bmm layout in every layer.  Those
// copies were the largest device cost of a serve launch.  With the map the
// rows stay where each logical beam appended them; the beam step only
// re-parents the map (decoding/beam.py).
//
// Bound: bytes.  A call reads the written prefix of K and V for its item's
// rows once (at most; rows no logical beam points at are skipped) and does 2
// FLOP per 4 bytes read: full HBM bandwidth needs ~0.84 TFLOP/s of f32 FMAs
// against the card's 67, so the CUDA cores idle and TF32 is never used.  At
// whisper-medium serving (80 rows, 184 positions, 16 heads) that is 120 MB a
// layer, 36 us at 3.35 TB/s.  The design:
//   1. One block per (item, head) covers all K beams, so a physical (row,
//      position, head) vector is loaded once and dotted with every logical
//      beam whose map points at it.  The item's map slice and its mask sit in
//      shared memory (every thread's loads of them issued before any store)
//      with, per position, the bit set of rows referenced.
//   2. The beam count (5, the serving default) or its most (8) is a
//      template argument, so the rows' vectors, the queries and the outputs
//      live in registers (<= 80 a thread): three blocks fit an SM, and
//      whisper-large-v3's 320 blocks run in one wave.
//   3. A warp takes a position at a time, four per iteration at K <= 5: its
//      lanes load the referenced rows' vectors, two elements a lane at Dh
//      64 (one at Dh <= 32), all loads of an iteration issued before any is
//      used (~40 KB a block in flight).  Each logical beam picks its row's
//      vector by a select over registers (the map is data, the register
//      index must not be) and the 32 lanes' partial dots reduce by shuffles.
//   4. Two passes over the positions instead of an online softmax: the
//      scores [K, length] stay in shared memory, one warp per beam takes
//      their max and sum, then the V pass weights each vector by its
//      probability.  Each pass streams its slab once; nothing is rescaled,
//      and a bf16 probability is rounded as the plain version rounds it.
//   5. Each warp keeps its own f32 output for all K beams in registers over
//      its positions; the eight partial outputs are summed in shared memory
//      and written once, [B K, 1, H, Dh] in the value dtype.
// At the serve cells' mean prefix (184 positions) with every row referenced,
// it runs at 1.17-1.27x the bound (PERF.md); with two blocks an SM and two
// positions a warp iteration it took 1.7-2.3x: the passes were a chain of
// load latencies, not a stream.
// More than 8 beams (no cell decodes with more than 5): a block per (item,
// head, group of 8 logical beams), the same two passes, but each logical
// beam loads the vector its own map entry names, so a row two beams of a
// group point at is loaded twice (the second load served by L1 or L2), and
// each group's block reads the rows again.  The map entries are 16 bits
// wide there, so the row index reaches 32766.
// Masked positions score NEG_INF exactly as the plain version's masked_fill,
// so exp gives 0 and a row whose every position is masked comes out uniform.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxDh = 64;       // head size: every Whisper's is 64
constexpr int kMaxBeams = 32767;  // a 16-bit map entry, its top bit the mask's
constexpr int kGroup = 8;         // beams a block takes: the most in registers
constexpr int kMaxLen = 448;     // Whisper's max_target_positions
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -3.40282347e38f;  // float32 min: the plain version's NEG_INF

enum Dtype { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;      // [B K, 1, H, dh]
  const void* k;      // [B K, max_len, H, dh]
  const void* v;
  const int* anc;     // [B, K, anc_len] int32, values in [0, K)
  const void* mask;   // [B K, >= length] with row stride mask_stride, nonzero = keep; null: keep all
  void* out;          // [B K, 1, H, dh]
  int64_t mask_stride;
  int mask_bytes;     // 1, 4 or 8
  int K, H, dh, max_len, anc_len, length;
};

// A lane's E consecutive elements of a row (E = 2 where dh > 32, else 1)
// as f32, in .x (and .y); a lane past the row's end holds zeros.
template <int T>
struct Pair;
template <>
struct Pair<kF32> {
  template <int E>
  static __device__ __forceinline__ float2 load(const void* base, int64_t i, bool active) {
    const float* p = static_cast<const float*>(base) + i;
    if (!active) return make_float2(0.f, 0.f);
    return E == 2 ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(__ldg(p), 0.f);
  }
  template <int E>
  static __device__ __forceinline__ void store(void* base, int64_t i, float2 x) {
    float* p = static_cast<float*>(base) + i;
    if (E == 2)
      *reinterpret_cast<float2*>(p) = x;
    else
      *p = x.x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct Pair<kBF16> {
  template <int E>
  static __device__ __forceinline__ float2 load(const void* base, int64_t i, bool active) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + i;
    if (!active) return make_float2(0.f, 0.f);
    return E == 2 ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)))
                  : make_float2(__bfloat162float(__ldg(p)), 0.f);
  }
  template <int E>
  static __device__ __forceinline__ void store(void* base, int64_t i, float2 x) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + i;
    if (E == 2)
      *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(x);
    else
      *p = __float2bfloat16_rn(x.x);
  }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w >= 1; w /= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int w = 16; w >= 1; w /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

// at most K beams (a template argument: the map's rows, the queries and
// the outputs live in registers); positions per warp iteration kUnroll(K)
template <int K>
struct Shape {
  static constexpr int kUnroll = K <= 5 ? 4 : 2;
  // map and mask entries per thread in the preamble
  static constexpr int kPre = (K * kMaxLen + kThreads - 1) / kThreads;
};

// a map entry in shared memory: the physical row, its top bit set where
// the position is masked; 8 bits where the block covers every row of its
// item (K <= 8), 16 where it takes a group of the logical beams
template <bool kGather>
struct Slot {
  using type = uint8_t;
  static constexpr unsigned kMasked = 0x80;
};
template <>
struct Slot<true> {
  using type = uint16_t;
  static constexpr unsigned kMasked = 0x8000;
};

// the vector of row `a` among the loaded ones (a select chain: `a` is data)
template <int K>
__device__ __forceinline__ float2 pick(const float2 (&rows)[K], int a) {
  float2 x = rows[0];
#pragma unroll
  for (int p = 1; p < K; ++p)
    if (a == p) x = rows[p];
  return x;
}

// one pass over the positions: each warp loads the referenced rows' vectors
// of kUnroll positions at once from `slab`, then hands each (position, row
// vectors) to `use`.  kGather: vector p is the one logical beam p of the
// group reads (`anc_s`, G of them), else physical row p's (`used`).
template <int T, int K, int E, bool kGather, typename S, typename Use>
__device__ __forceinline__ void stream_positions(const void* slab, int64_t item_base, int64_t row_stride,
                                                 int64_t pos_stride, const uint8_t* used,
                                                 const S (*anc_s)[kMaxLen], int G, int L, int warp,
                                                 bool active, Use use) {
  constexpr int U = Shape<K>::kUnroll;
  for (int t0 = warp; t0 < L; t0 += kWarps * U) {
    float2 rows[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kWarps;
      if constexpr (kGather) {
#pragma unroll
        for (int p = 0; p < K; ++p) {
          const bool on = t < L && p < G;
          const int64_t row = on ? anc_s[p][t] & (Slot<true>::kMasked - 1) : 0;
          rows[u][p] = Pair<T>::template load<E>(slab, item_base + row * row_stride + t * pos_stride,
                                                 active && on);
        }
      } else {
        const unsigned bits = t < L ? used[t] : 0u;
#pragma unroll
        for (int p = 0; p < K; ++p)
          rows[u][p] = Pair<T>::template load<E>(slab, item_base + p * row_stride + t * pos_stride,
                                                 active && ((bits >> p) & 1u));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kWarps;
      if (t < L) use(t, rows[u]);
    }
  }
}

// KM: the most beams a block takes; the beam count K is KM itself where
// kExact (the serving default of 5), else read at run time.  kGather: the
// block takes the G <= KM logical beams k0.. of group blockIdx.z of its
// item, else all K.
template <int T, int KM, int E, bool kExact, bool kGather>
__global__ void __launch_bounds__(kThreads, 3) beam_attention_kernel(const Params prm) {
  using S = typename Slot<kGather>::type;
  constexpr unsigned kMasked = Slot<kGather>::kMasked;
  __shared__ float score[KM][kMaxLen];  // scores, then probabilities
  __shared__ S anc_s[KM][kMaxLen];
  __shared__ uint8_t used[kMaxLen];      // bit p: some beam reads row p here
  __shared__ float2 partial[kWarps][KM][32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int K = kExact ? KM : prm.K, H = prm.H, L = prm.length, dh = prm.dh;
  const int k0 = kGather ? blockIdx.z * KM : 0, G = kGather ? min(KM, K - k0) : K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = E * lane < dh;  // this lane holds elements of the row

  // the item's map and mask, every load of a thread issued before any
  // store; masked positions are marked in the entry's top bit
  {
    constexpr int N = Shape<KM>::kPre;
    int a[N];
    bool keep[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      a[j] = 0;
      keep[j] = true;
      if (i < G * L) {
        const int k = i / L, t = i - k * L;
        a[j] = prm.anc[(static_cast<int64_t>(b) * K + k0 + k) * prm.anc_len + t];
        if (prm.mask != nullptr) {
          const int64_t m = (static_cast<int64_t>(b) * K + k0 + k) * prm.mask_stride + t;
          keep[j] = prm.mask_bytes == 8   ? static_cast<const int64_t*>(prm.mask)[m] != 0
                    : prm.mask_bytes == 4 ? static_cast<const int32_t*>(prm.mask)[m] != 0
                                          : static_cast<const uint8_t*>(prm.mask)[m] != 0;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < G * L) {
        const int k = i / L, t = i - k * L;
        // a map out of range is a caller's fault; stay inside the item
        anc_s[k][t] = static_cast<S>(min(max(a[j], 0), K - 1) | (keep[j] ? 0u : kMasked));
      }
    }
  }
  __syncthreads();
  if constexpr (!kGather) {
    for (int t = threadIdx.x; t < L; t += kThreads) {
      unsigned bits = 0;
      for (int k = 0; k < K; ++k) bits |= 1u << (anc_s[k][t] & 0x7f);
      used[t] = static_cast<uint8_t>(bits);
    }
  }

  // this lane's elements of every beam's query
  const int64_t row_stride = static_cast<int64_t>(prm.max_len) * H * dh;
  const int64_t pos_stride = static_cast<int64_t>(H) * dh;
  const int64_t item_base = static_cast<int64_t>(b) * K * row_stride + static_cast<int64_t>(h) * dh + E * lane;
  float2 q[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k)
    q[k] = Pair<T>::template load<E>(prm.q, ((static_cast<int64_t>(b) * K + k0 + k) * H + h) * dh + E * lane,
                                     active && k < G);
  __syncthreads();

  // pass 1: scores
  stream_positions<T, KM, E, kGather>(prm.k, item_base, row_stride, pos_stride, used, anc_s, G, L, warp, active,
                                      [&](int t, const float2 (&rows)[KM]) {
#pragma unroll
                                        for (int k = 0; k < KM; ++k) {
                                          if (k >= G) break;
                                          const unsigned a = anc_s[k][t];
                                          const float2 x = kGather ? rows[k] : pick<KM>(rows, a & 0x7f);
                                          const float s = warp_sum(fmaf(q[k].x, x.x, q[k].y * x.y));
                                          if (lane == 0) score[k][t] = a & kMasked ? kNegInf : s;
                                        }
                                      });
  __syncthreads();

  // softmax over the positions, one warp per beam (torch's: exp(s - max) / sum)
  for (int k = warp; k < G; k += kWarps) {
    float m = kNegInf;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, score[k][t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < L; t += 32) {
      const float e = expf(score[k][t] - m);
      score[k][t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < L; t += 32) score[k][t] = Pair<T>::round(__fdiv_rn(score[k][t], sum));
  }
  __syncthreads();

  // pass 2: the probabilities' weighted sum of the value vectors
  float2 acc[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) acc[k] = make_float2(0.f, 0.f);
  stream_positions<T, KM, E, kGather>(prm.v, item_base, row_stride, pos_stride, used, anc_s, G, L, warp, active,
                                      [&](int t, const float2 (&rows)[KM]) {
#pragma unroll
                                        for (int k = 0; k < KM; ++k) {
                                          if (k >= G) break;
                                          const float pk = score[k][t];
                                          const float2 x = kGather ? rows[k] : pick<KM>(rows, anc_s[k][t] & 0x7f);
                                          acc[k].x = fmaf(pk, x.x, acc[k].x);
                                          acc[k].y = fmaf(pk, x.y, acc[k].y);
                                        }
                                      });
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < G) partial[warp][k][lane] = acc[k];
  __syncthreads();

  // the warps' partial outputs summed, one warp per beam, written once
  for (int k = warp; k < G; k += kWarps) {
    float2 o = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o.x += partial[w][k][lane].x;
      o.y += partial[w][k][lane].y;
    }
    if (active)
      Pair<T>::template store<E>(prm.out, ((static_cast<int64_t>(b) * K + k0 + k) * H + h) * dh + E * lane, o);
  }
}

// five instantiations in each dtype, to keep the build short: Dh 64 at
// exactly 5 beams (the cells' shape) and at up to 8, Dh <= 32 (the tests'
// tiny models) at up to 8, and groups of 8 of more beams at either
template <int T>
void launch_beams(const Params& p, int B, cudaStream_t s) {
  if (p.K > kGroup) {
    const dim3 grid(p.H, B, (p.K + kGroup - 1) / kGroup);
    if (p.dh <= 32)
      beam_attention_kernel<T, kGroup, 1, false, true><<<grid, kThreads, 0, s>>>(p);
    else
      beam_attention_kernel<T, kGroup, 2, false, true><<<grid, kThreads, 0, s>>>(p);
    return;
  }
  const dim3 grid(p.H, B);
  if (p.dh <= 32)
    beam_attention_kernel<T, kGroup, 1, false, false><<<grid, kThreads, 0, s>>>(p);
  else if (p.K == 5)
    beam_attention_kernel<T, 5, 2, true, false><<<grid, kThreads, 0, s>>>(p);
  else
    beam_attention_kernel<T, kGroup, 2, false, false><<<grid, kThreads, 0, s>>>(p);
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

}  // namespace

extern "C" {

// q, out [B K, 1, H, dh]; k, v [B K, max_len, H, dh]; all contiguous and in
// dtype (0 f32, 1 bf16); dh <= 32, or even and <= 64, and then aligned to two
// elements.  anc [B, K, anc_len] int32 contiguous.  mask: null, or [B K, >=
// length] integers of mask_bytes (1, 4 or 8) bytes with row stride
// mask_stride elements.  Attends positions [0, length).  A bad argument
// returns cudaErrorInvalidValue and launches nothing; otherwise
// cudaGetLastError after the launch.
int ecw_beam_attention(const void* q, const void* k, const void* v, const int* anc, const void* mask,
                       int mask_bytes, long long mask_stride, void* out, int dtype, int B, int K, int H, int dh,
                       int max_len, int anc_len, int length, void* stream) {
  const int align = (dh > 32 ? 2 : 1) * (dtype == kF32 ? 4 : 2);
  const bool ok = (dtype == kF32 || dtype == kBF16) && B >= 1 && B <= 65535 && K >= 1 && K <= kMaxBeams &&
                  H >= 1 && dh >= 1 && dh <= kMaxDh && (dh <= 32 || dh % 2 == 0) && length >= 1 &&
                  length <= max_len && length <= anc_len && length <= kMaxLen &&
                  (mask == nullptr || ((mask_bytes == 1 || mask_bytes == 4 || mask_bytes == 8) &&
                                       mask_stride >= length)) &&
                  aligned(q, align) && aligned(k, align) && aligned(v, align) && aligned(out, align);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, anc, mask, out, static_cast<int64_t>(mask_stride), mask_bytes, K, H, dh, max_len,
                 anc_len, length};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    launch_beams<kF32>(p, B, s);
  else
    launch_beams<kBF16>(p, B, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
