// Causal GQA attention with an online softmax for Hopper (sm_90a): three
// kernels, chosen by the wrapper from the input's shape and type.
//
// Replaces: the Pallas TPU kernel of the JAX package,
//   src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention_batched (body _attn_kernel).
//
// Computes o = softmax(scale q k^T + mask) v for q [B, Hq, Tq, Dh] and
// k, v [B, Hkv, Tk, Dh]; query head h reads key/value head h / (Hq / Hkv)
// (GQA, no copy of k or v). Queries are right-aligned to the keys (query i
// sits at position Tk - Tq + i); a causal row masks later keys with -1e30,
// as the TPU kernel does. Keys past Tk do not exist here (no padding
// copies: loads are bounds-checked or zero-filled and such keys get weight
// exactly 0), so a row that sees no key (causal, Tq > Tk) averages v over
// the Tk real keys, as the oracle attention_ref does; the TPU kernel also
// averages its zero padding there. m, l and the accumulator are float32
// whatever the input type; the output is rounded to the input type once.
//
// Sliding window (window > 0, causal only; 0 = none): a query at position
// p also masks (with -1e30) the keys k <= p - window, so it sees the keys
// p - window < k <= p, the mask of the reference model's
// blockwise_causal_attention. The prefill kernels (1 and 3) start a Q
// tile's key loop at the tile that holds its first row's first visible
// key, so tiles wholly below the window are never loaded (the reference's
// lo = qi - ceil(window / chunk) skip); the decode kernel (2) masks by key
// (its splits below the window weigh 0 in the merge). A tile whose first
// row sees no key (Tq > Tk) visits every key, as without a window.
//
// Logit softcap (softcap > 0; 0 = none; grok-1's attention): each scaled
// score s = scale q.k becomes softcap tanh(s / softcap) before the causal,
// window and length masks, as the reference model's attention applies it
// (src/repro/models/attention.py, _softcap before the masks); masked
// scores stay at -1e30. tanhf (full precision, ~2 ulp; no fast math). The
// decode and wgmma kernels fold log2(e) into the scale for exp2, so they
// cap in units of the raw product q.k (cap_raw = softcap / scale:
// cap_raw tanh(q.k / cap_raw) times scale is the natural-unit cap) and
// then apply scale log2(e). Both are compiled twice, with and without the
// cap (template flag CAP), so an uncapped call runs the code it ran before
// the cap existed; the FMA kernel tests the cap at run time.
//
// What bounds it: a prefill (Tq = Tk = T) does 4 B Hq Dh T (T + 1) / 2
// operations on 4 B H T Dh values: far above the card's ridge point, so the
// floor is the tensor cores' rate. A decode step (Tq = 1) reads the whole
// key/value cache once for 4 Dh Tk operations per query row: bound by
// memory.
//
// 1. fa::flash_attention_kernel (FMA; float32, and bfloat16 at head dims
//    the other two do not take). One CTA of 256 threads per (q tile of BQ
//    rows, q head, batch). The Q tile is staged once in shared memory as
//    float32; then for each tile of kBK keys (only up to the causal limit
//    of the Q tile), K and V are staged as float32 and
//      a. each thread computes RQ x CK scores with plain FMAs (its RQ rows
//         ty*RQ.., its CK columns tx + 16 j; K rows are padded to Dh + 1
//         floats so the 16 columns fall in 16 banks);
//      b. the row max and row sum of the online softmax are reduced over
//         the 16 threads of a half-warp that share those rows (shuffles),
//         the running max m, denominator l and the accumulator are
//         rescaled, and the probabilities go to shared memory;
//      c. each thread adds P V into its RQ x Dh/16 accumulator (columns
//         tx + 16 j), in registers.
//    Warps whose rows all lie past Tq skip the multiply-adds.
//
// 2. dec::decode_kernel + dec::merge_kernel (split-K decode; both types,
//    every head dim; group * Tq <= kMaxRows query rows per kv head). One
//    CTA of 128 threads per (split of split_keys keys, kv head, batch)
//    takes all the GQA group's query rows at once, so each K/V byte is
//    read once, not group times, and the splits fill the card even at
//    batch 1. K then V tiles of <= 16 KB stream through a double buffer of
//    16-byte cp.async loads (keys past Tk zero-filled). Scores: 128 / KT
//    threads per key, each over interleaved 16-byte chunks of the row,
//    against every row (Q read as float4 broadcasts; partial sums meet by
//    shuffles); a warp per row takes the split's max and sum; P V: each
//    thread owns two columns and a group of 4-key blocks (weights read as
//    float4). The row count is compiled (1, 2, 3, 4, 8 or 16, zero rows
//    padding the rest), so no loop over rows carries a runtime guard (a
//    first version with runtime row counts spent most of its time on
//    those guards and on one shared-memory load per FMA). f32 FMAs
//    throughout. Each CTA writes its (m, l, acc[Dh])
//    partials in float32 to scratch the wrapper allocates; the merge
//    kernel weighs split s by exp2(m_s - max_s m_s) and writes o. A split
//    whose keys are all causally masked for a row has m_s = -1e30: weight
//    0 when another split has a real key, and when none has, every key
//    has weight 1 (the Tk-average of the oracle).
//    The same kernels decode against a KV cache in place (fa_decode_cache):
//    k and v are [B, Hkv, S, Dh] buffers whose first min(length, S) rows
//    are keys, S is the row stride, and length is an int32 the kernel
//    reads from device memory, so a decode step never waits on the host.
//    The split grid covers the capacity S; a split that starts past the
//    keys writes m = -inf, l = 0 and weighs 0 in the merge (no keys at
//    all, length 0, gives o = 0). This is the reference's decode mask
//    arange(S) < length (models/attention.py decode_attention), a full
//    ring buffer included; the rows past the keys are never read.
//    Under tensor parallelism a rank serves its own q heads against its
//    own cache block, whose kv heads need not be those of h / group (the
//    reference pads the q heads and maps a padded or uneven tail to the
//    last kv head). So fa_decode_cache also takes an explicit map: for
//    each kv head the q heads it serves (a CTA's rows are then that kv
//    head's heads, e.g. 6 and 2; the partials keep the map's width as
//    their stride, and a kv head that serves no head reads nothing), and
//    the merge can write each row's log-sum-exp, with which rows whose
//    keys lie in several ranks' blocks of a cache split along its
//    sequence are merged across the ranks. The cache is still read in
//    place: no copy, no expansion.
//
// 3. wg::wgmma_kernel (bfloat16 prefill, Dh 64 and 128). Warp-specialised:
//    384 threads in three warpgroups. Warpgroup 0 is the producer: it gives
//    up registers (setmaxnreg) and one thread issues TMA loads of the Q
//    tile (128 rows) once and of K and V tiles of 128 keys into a ring of
//    2 stages, with mbarrier full/empty pairs, 128-byte swizzled (161 KB
//    of shared memory at Dh=128). The two consumer warpgroups own 64 query
//    rows each and work independently (the card interleaves one's softmax
//    with the other's products):
//      S = Q K^T    wgmma m64n128k16, Q and K from shared memory (K-major);
//      softmax      on the accumulator layout: each row lives in 4 threads
//                   (2 shuffles), exp2 with log2(e) folded into the scale;
//      O += P V     P rounded to bfloat16 in registers as the A operand, V
//                   from shared memory as an MN-major B ([key][d], no
//                   transpose copy).
//    Only the tiles that cross the causal diagonal, the window's lower edge
//    or Tk are masked; tiles past the causal limit or wholly below the
//    window are not loaded. The grid runs the heaviest Q
//    tiles first. The 3-D tensor maps over [B*H, T, Dh] zero-fill rows past
//    T inside one head. Rounding departure from the TPU kernel: P is
//    rounded to bfloat16 before the second product (the TPU kernel keeps
//    it in float32); l sums the unrounded P.
//
// C interface (loaded with ctypes; densely packed arrays; dtype 0 =
// float32, 2 = bfloat16; each launches on `stream` and returns
// cudaGetLastError() or the first failure):
//   fa_attention(dtype, head_dim, B, Hq, Hkv, Tq, Tk, causal, window, scale,
//                softcap, q, k, v, o, stream)                kernel 1
//   fa_decode(dtype, head_dim, B, Hq, Hkv, Tq, Tk, causal, window, scale,
//             softcap, split_keys, q, k, v, o, part_ml, part_acc, stream)
//                                                             kernel 2
//   fa_decode_cache(dtype, head_dim, B, Hq, Hkv, Tq, S, scale, softcap,
//                   split_keys, map_width, heads_map, q, k, v, length, o,
//                   lse, part_ml, part_acc, stream)
//                                        kernel 2 on a cache, not causal
//   fa_wgmma(head_dim, B, Hq, Hkv, Tq, Tk, causal, window, scale, softcap,
//            q, k, v, o, stream)                              kernel 3
// with head_dim one of 16, 32, 64, 128, 256 (64 and 128 for fa_wgmma).
//
// The file compiles as several parts (one nvcc -c each, in parallel): the
// part built with -DFA_HEAD_DIM=<d> holds the instances of that head_dim,
// the part built with -DFA_ENTRY_POINTS the C entry points.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FA_HEAD_DIM
#define FA_HEAD_DIM 0
#endif

namespace fa {

constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx columns
constexpr int kBK = 32;        // keys per tile
constexpr float kMasked = -1e30f;

template <int D>
struct Cfg {
  static constexpr int BQ = D <= 128 ? 64 : 32;  // query rows per CTA
  static constexpr int RQ = BQ / 16;             // rows per thread
  static constexpr int CK = kBK / 16;            // score columns per thread
  static constexpr int CD = D / 16;              // output columns per thread
  static constexpr int QS = D + 1;               // padded Q/K row stride
  static constexpr int PS = kBK + 1;             // padded P row stride
  static constexpr int kFloats = BQ * QS + kBK * QS + kBK * D + BQ * PS;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Max / sum over the 16 lanes of a half-warp (the threads sharing a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    int Hq, int group, int64_t Tq, int64_t Tk, int causal, int window,
    float scale, float softcap, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, RQ = C::RQ, CK = C::CK, CD = C::CD;
  constexpr int QS = C::QS, PS = C::PS;
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][QS]
  float* k_s = q_s + BQ * QS;    // [kBK][QS]
  float* v_s = k_s + kBK * QS;   // [kBK][D]
  float* p_s = v_s + kBK * D;    // [BQ][PS]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t Hkv = Hq / group;
  const int64_t kvh = h / group;
  const T* qg = q + ((bi * Hq + h) * Tq + q0) * D;
  T* og = o + ((bi * Hq + h) * Tq + q0) * D;
  const T* kg = k + (bi * Hkv + kvh) * Tk * D;
  const T* vg = v + (bi * Hkv + kvh) * Tk * D;
  const int64_t q_offset = Tk - Tq;
  const int64_t rows = Tq - q0 < BQ ? Tq - q0 : BQ;  // real queries here
  const bool active = ty * RQ < rows;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    q_s[r * QS + c] = r < rows ? widen(qg[static_cast<int64_t>(r) * D + c])
                               : 0.f;
  }
  // Causal rows see keys up to their position, and windowed rows none
  // before their window. A tile whose first row sees no key (Tq > Tk)
  // visits every key: such rows average them all.
  int64_t k_begin = 0, k_end = Tk;
  if (causal && q_offset + q0 >= 0) {
    if (q_offset + q0 + BQ < Tk) k_end = q_offset + q0 + BQ;
    if (window > 0 && q_offset + q0 - window + 1 > 0)
      k_begin = (q_offset + q0 - window + 1) / kBK * kBK;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Tk;
      const int64_t g = (k0 + r) * D + c;
      k_s[r * QS + c] = in ? widen(kg[g]) : 0.f;
      v_s[r * D + c] = in ? widen(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    if (active) {
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[RQ], kv[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty * RQ + i) * QS + d];
#pragma unroll
        for (int j = 0; j < CK; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int64_t qpos = q_offset + q0 + ty * RQ + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (kpos >= Tk)
          x = -INFINITY;  // no such key: weight exactly 0
        else if (causal && (qpos < kpos || (window > 0 && qpos - kpos >= window)))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty * RQ + i) * PS + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float pv[RQ], vv[CD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pv[i] = p_s[(ty * RQ + i) * PS + c];
#pragma unroll
        for (int j = 0; j < CD; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    if (r >= rows) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      narrow(og + static_cast<int64_t>(r) * D + tx + 16 * j, acc[i][j] * inv);
  }
}

#define FA_LAUNCH_PARAMS                                                     \
  int64_t B, int Hq, int Hkv, int64_t Tq, int64_t Tk, int causal,            \
      int window, float scale, float softcap, const void *q, const void *k,  \
      const void *v, void *o, cudaStream_t s

template <typename T, int D>
int launch(FA_LAUNCH_PARAMS) {
  using C = Cfg<D>;
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Tq + C::BQ - 1) / C::BQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, C::kSmemBytes, s>>>(
      Hq, Hq / Hkv, Tq, Tk, causal, window, scale, softcap,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa

// ---------------------------------------------------------------------------
// 2. Split-K decode
// ---------------------------------------------------------------------------

namespace dec {

using fa::kMasked;
using fa::narrow;
using fa::widen;

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;     // group * Tq rows per kv head
constexpr int kMaxSplit = 512;   // keys per split
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr int ES = sizeof(T);
  static constexpr int VEC = 16 / ES;         // values per 16-byte chunk
  static constexpr int CH = D * ES / 16;      // chunks per row
  // Keys per tile: at most 16 KB of them, between 16 and 128.
  static constexpr int KT_RAW = 16384 / (D * ES);
  static constexpr int KT = KT_RAW > 128 ? 128 : (KT_RAW < 16 ? 16 : KT_RAW);
  static constexpr int DS = kThreads / KT;    // threads per key (scores)
  // Row stride: 16 bytes of padding per scoring thread of a key, so the
  // 8 threads of a quarter-warp (DS per key, interleaved chunks) read 8
  // different 4-bank groups.
  static constexpr int RS = D * ES + 16 * DS;
  static constexpr int TILE_BYTES = KT * RS;
  static constexpr int CG = D / 2;            // column-pair threads (P V)
  static constexpr int KG = kThreads / CG;    // key groups (P V)
};

// Stride of a row of weights: whole 4-key blocks (float4 loads).
inline __host__ __device__ int padded_split(int split_keys) {
  return (split_keys + 3) & ~3;
}

template <typename T, int D, int RB>
size_t smem_bytes(int split_keys) {
  using C = Cfg<T, D>;
  const size_t floats = static_cast<size_t>(RB) * D                   // q
                        + static_cast<size_t>(RB) * padded_split(split_keys)
                        + (C::KG > 1 ? static_cast<size_t>(C::KG) * RB * D : 0)
                        + 2 * RB;                                     // m, l
  return 2 * C::TILE_BYTES + sizeof(float) * floats;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A 16-byte chunk of a shared-memory row as floats.
__device__ __forceinline__ void load_chunk(const unsigned char* p, float* out,
                                           float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float* out,
                                           __nv_bfloat16) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// Two adjacent values of a shared-memory row as floats.
__device__ __forceinline__ float2 load_pair(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p,
                                            __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The q heads a kv head serves: with no map, heads kvh * group + g for g
// < group = Hq / Hkv; with a map (heads: [Hkv][group] q head indices, -1
// past the kv head's own, which come first), heads[kvh * group + g]. The
// kv head's rows are its heads' queries; a kv head with none reads nothing.
__device__ __forceinline__ int kv_heads_rows(const int* heads, int kvh,
                                             int group) {
  if (heads == nullptr) return group;
  int n = 0;
  while (n < group && heads[kvh * group + n] >= 0) ++n;
  return n;
}
__device__ __forceinline__ int64_t q_head(const int* heads, int kvh,
                                          int group, int64_t g) {
  return heads == nullptr ? kvh * group + g : heads[kvh * group + g];
}

// Rows of one CTA: r = g * Tq + i is query i of the kv head's g-th q head
// (kv_heads_rows, q_head); rows R..RB-1 are zero padding up to the
// compiled row count RB. The partials of a kv head take group * Tq rows,
// R of them written. CAP: the softcap cap_raw (> 0) is applied.
template <typename T, int D, int RB, bool CAP>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    int Hq, int Hkv, int group, const int* __restrict__ heads, int64_t Tq,
    int64_t S, const int* __restrict__ len, int causal, int window,
    float scale_log2, float cap_raw, int split_keys, int n_splits,
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ part_ml,
    float* __restrict__ part_acc) {
  using C = Cfg<T, D>;
  constexpr int KT = C::KT, RS = C::RS, DS = C::DS, CH = C::CH;
  constexpr int VEC = C::VEC, CG = C::CG, KG = C::KG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y;
  const int R = kv_heads_rows(heads, kvh, group) * static_cast<int>(Tq);
  const int RP = group * static_cast<int>(Tq);  // partial rows per kv head
  if (R == 0) return;  // a kv head no q head reads: nothing to merge
  const int SKP = padded_split(split_keys);
  float* q_s = reinterpret_cast<float*>(smem + 2 * C::TILE_BYTES);  // [RB][D]
  float* s_s = q_s + RB * D;                      // [RB][SKP]
  float* red = s_s + RB * SKP;                    // [KG][RB][D]
  float* ml_s = red + (KG > 1 ? KG * RB * D : 0);  // [RB][2]

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int64_t b = blockIdx.z;
  // Rows of the buffers: S apart; the first Tk of them are keys.
  int64_t Tk = S;
  if (len != nullptr) {
    const int64_t n = *len;
    Tk = n < 0 ? 0 : (n < S ? n : S);
  }
  const int64_t s0 = static_cast<int64_t>(split) * split_keys;
  const int64_t part = (b * Hkv + kvh) * n_splits + split;  // [.., RP] rows
  if (s0 >= Tk) {
    // A split past the keys (a cache not yet full): weight 0 in the merge.
    for (int e = tid; e < R; e += kThreads) {
      part_ml[(part * RP + e) * 2] = -INFINITY;
      part_ml[(part * RP + e) * 2 + 1] = 0.f;
    }
    for (int e = tid; e < R * D; e += kThreads)
      part_acc[part * RP * D + e] = 0.f;
    return;
  }
  const int nk = static_cast<int>(Tk - s0 < split_keys ? Tk - s0 : split_keys);
  const int nk4 = (nk + 3) & ~3;  // weights past nk are 0
  const int n_tiles = (nk + KT - 1) / KT;
  const T* kg = k + ((b * Hkv + kvh) * S + s0) * D;
  const T* vg = v + ((b * Hkv + kvh) * S + s0) * D;

  // Tile t < n_tiles is K tile t, then V tile t - n_tiles; buffer t & 1.
  // Keys past the split read as zeros.
  auto load = [&](int t) {
    const T* src = t < n_tiles ? kg : vg;
    const int key0 = (t < n_tiles ? t : t - n_tiles) * KT;
    unsigned char* dst = smem + (t & 1) * C::TILE_BYTES;
    for (int c = tid; c < KT * CH; c += kThreads) {
      const int row = c / CH, ch = c % CH;
      const bool in = key0 + row < nk;
      const unsigned char* g = reinterpret_cast<const unsigned char*>(
          src + static_cast<int64_t>(in ? key0 + row : 0) * D) + ch * 16;
      cp_async16(dst + row * RS + ch * 16, g, in ? 16 : 0);
    }
    cp_async_commit();
  };

  load(0);
  for (int e = tid; e < RB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t g = r / Tq, i = r % Tq;
    q_s[e] = r < R ? widen(q[((b * Hq + q_head(heads, kvh, group, g)) * Tq +
                              i) * D + c])
                   : 0.f;
  }

  float acc[RB][2];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.f;
  const int cp = tid % CG, kgi = tid / CG;  // P V: column pair, key group

  for (int t = 0; t < 2 * n_tiles; ++t) {
    if (t + 1 < 2 * n_tiles) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and on t = 0 the Q rows) visible to all
    const unsigned char* tile = smem + (t & 1) * C::TILE_BYTES;
    if (t < n_tiles) {
      // Scores: DS threads per key, each over every DS-th chunk of the
      // row, against all RB rows; partial sums meet by shuffles.
      const int j = tid / DS, h = tid % DS;
      const unsigned char* krow = tile + j * RS;
      float sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r] = 0.f;
#pragma unroll 2
      for (int c = h; c < CH; c += DS) {
        float kv[VEC];
        load_chunk(krow + c * 16, kv, T());
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D + c * VEC);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qq = q4[e];
            sc[r] = fmaf(qq.x, kv[4 * e], sc[r]);
            sc[r] = fmaf(qq.y, kv[4 * e + 1], sc[r]);
            sc[r] = fmaf(qq.z, kv[4 * e + 2], sc[r]);
            sc[r] = fmaf(qq.w, kv[4 * e + 3], sc[r]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < DS; off <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      const int kk = t * KT + j;
      if (h == 0 && kk < nk) {
        const int64_t kpos = s0 + kk;
        if constexpr (CAP) {
          // The softcap in units of the raw product (see the note above).
          const float inv_cap = 1.f / cap_raw;
#pragma unroll
          for (int r = 0; r < RB; ++r)
            sc[r] = cap_raw * tanhf(sc[r] * inv_cap);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float x = sc[r] * scale_log2;
          const int64_t qpos = Tk - Tq + r % Tq;
          if (causal && (kpos > qpos || (window > 0 && qpos - kpos >= window)))
            x = kMasked;
          s_s[r * SKP + kk] = x;
        }
      }
    } else {
      if (t == n_tiles) {
        // The split's max and sum per row (one warp per row); the scores
        // become weights in place, and 0 up to the next 4-key block.
        for (int r = tid / 32; r < R; r += kThreads / 32) {
          float* sr = s_s + r * SKP;
          float mx = -INFINITY;
          for (int kk = tid % 32; kk < nk; kk += 32) mx = fmaxf(mx, sr[kk]);
          mx = warp_max(mx);
          float sum = 0.f;
          for (int kk = tid % 32; kk < nk4; kk += 32) {
            const float p = kk < nk ? exp2f(sr[kk] - mx) : 0.f;
            sr[kk] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (tid % 32 == 0) {
            ml_s[2 * r] = mx;
            ml_s[2 * r + 1] = sum;
          }
        }
        __syncthreads();
      }
      // P V: 4 keys at a time per key group, two columns per thread.
      const int key0 = (t - n_tiles) * KT;
      const int blocks = (nk4 - key0 < KT ? nk4 - key0 : KT) / 4;
      for (int bi = kgi; bi < blocks; bi += KG) {
        float2 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = load_pair(tile + (4 * bi + e) * RS + cp * 2 * C::ES, T());
        // Padding rows (R..RB-1) accumulate too and are never written.
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(
              s_s + r * SKP + key0 + 4 * bi);
          acc[r][0] = fmaf(p.x, vv[0].x, acc[r][0]);
          acc[r][1] = fmaf(p.x, vv[0].y, acc[r][1]);
          acc[r][0] = fmaf(p.y, vv[1].x, acc[r][0]);
          acc[r][1] = fmaf(p.y, vv[1].y, acc[r][1]);
          acc[r][0] = fmaf(p.z, vv[2].x, acc[r][0]);
          acc[r][1] = fmaf(p.z, vv[2].y, acc[r][1]);
          acc[r][0] = fmaf(p.w, vv[3].x, acc[r][0]);
          acc[r][1] = fmaf(p.w, vv[3].y, acc[r][1]);
        }
      }
    }
    __syncthreads();  // tile t read by all before load(t + 2) overwrites it
  }

  if (KG > 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        red[(kgi * RB + r) * D + 2 * cp] = acc[r][0];
        red[(kgi * RB + r) * D + 2 * cp + 1] = acc[r][1];
      }
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) s += red[g * RB * D + e];
      part_acc[part * RP * D + e] = s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        part_acc[(part * RP + r) * D + 2 * cp] = acc[r][0];
        part_acc[(part * RP + r) * D + 2 * cp + 1] = acc[r][1];
      }
    }
  }
  for (int e = tid; e < 2 * R; e += kThreads) part_ml[part * 2 * RP + e] = ml_s[e];
}

// One CTA per (row, kv head, batch): weigh the splits and write o, and
// with lse the row's log-sum-exp of its scaled scores (natural log; -inf
// where it has no key), so that a caller can merge rows whose keys lie
// on several ranks.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    int Hq, int Hkv, int group, const int* __restrict__ heads, int64_t Tq,
    int n_splits, const float* __restrict__ part_ml,
    const float* __restrict__ part_acc, T* __restrict__ o,
    float* __restrict__ lse) {
  const int r = blockIdx.x, kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int RP = group * static_cast<int>(Tq);
  if (r >= kv_heads_rows(heads, kvh, group) * static_cast<int>(Tq)) return;
  const int64_t first = (b * Hkv + kvh) * n_splits * RP + r;  // split 0's row
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    m = fmaxf(m, part_ml[2 * (first + static_cast<int64_t>(s) * RP)]);
  if (m == -INFINITY) m = 0.f;  // no key in any split (length 0): o = 0
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const int64_t i = first + static_cast<int64_t>(s) * RP;
    l += exp2f(part_ml[2 * i] - m) * part_ml[2 * i + 1];
  }
  const float inv = 1.f / (l > 0.f ? l : 1.f);
  const int64_t g = r / Tq, qi = r % Tq;
  const int64_t row = (b * Hq + q_head(heads, kvh, group, g)) * Tq + qi;
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
  T* orow = o + row * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const int64_t i = first + static_cast<int64_t>(s) * RP;
      a = fmaf(exp2f(part_ml[2 * i] - m), part_acc[i * D + c], a);
    }
    narrow(orow + c, a * inv);
  }
}

// group: q heads per kv head (Hq / Hkv without a map; with one, the map's
// width); heads: the map or nullptr; lse: nullptr or [B, Hq, Tq] floats.
#define DEC_LAUNCH_PARAMS                                                    \
  int64_t B, int Hq, int Hkv, int group, const int *heads, int64_t Tq,       \
      int64_t Tk, const int *len, int causal, int window, float scale,       \
      float softcap, int split_keys, const void *q, const void *k,           \
      const void *v, void *o, float *lse, float *part_ml, float *part_acc,   \
      cudaStream_t s

template <typename T, int D, int RB>
int launch_rows(DEC_LAUNCH_PARAMS) {
  const int64_t rows = group * Tq;
  const int64_t n_splits = (Tk + split_keys - 1) / split_keys;
  if (n_splits > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, D, RB>(split_keys);
  auto kernel = softcap > 0.f ? decode_kernel<T, D, RB, true>
                              : decode_kernel<T, D, RB, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(n_splits), static_cast<unsigned>(Hkv),
                static_cast<unsigned>(B)),
           kThreads, smem, s>>>(Hq, Hkv, group, heads, Tq, Tk, len, causal,
                                window,
                                scale * kLog2e,
                                softcap > 0.f ? softcap / scale : 0.f,
                                split_keys,
                                static_cast<int>(n_splits),
                                static_cast<const T*>(q),
                                static_cast<const T*>(k),
                                static_cast<const T*>(v), part_ml, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<T, D><<<dim3(static_cast<unsigned>(rows),
                            static_cast<unsigned>(Hkv),
                            static_cast<unsigned>(B)),
                       kThreads, 0, s>>>(Hq, Hkv, group, heads, Tq,
                                         static_cast<int>(n_splits), part_ml,
                                         part_acc, static_cast<T*>(o), lse);
  return static_cast<int>(cudaGetLastError());
}

// Row counts compiled: the GQA groups of the repo's configs at Tq = 1
// (1, 2, 3, 4, 8, 16) and padding up to 8 or 16 for the rest.
template <typename T, int D>
int launch(DEC_LAUNCH_PARAMS) {
  const int64_t rows = group * Tq;
  if (group < 1 || rows > kMaxRows || split_keys < 1 ||
      split_keys > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
#define DEC_ROWS(RB) \
  launch_rows<T, D, RB>(B, Hq, Hkv, group, heads, Tq, Tk, len, causal,       \
                        window, scale, softcap, split_keys, q, k, v, o, lse, \
                        part_ml, part_acc, s)
  if (rows <= 1) return DEC_ROWS(1);
  if (rows == 2) return DEC_ROWS(2);
  if (rows == 3) return DEC_ROWS(3);
  if (rows == 4) return DEC_ROWS(4);
  if (rows <= 8) return DEC_ROWS(8);
  return DEC_ROWS(16);
#undef DEC_ROWS
}

}  // namespace dec

// ---------------------------------------------------------------------------
// 3. bfloat16 prefill on the tensor cores (wgmma, TMA, warp-specialised)
// ---------------------------------------------------------------------------

namespace wg {

using fa::kMasked;

constexpr int kBQ = 128;        // query rows per CTA (two consumer warpgroups)
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int NH = D / 64;          // 128-byte column blocks
  static constexpr int HALF_Q = kBQ * 128;   // bytes of one block of Q
  static constexpr int HALF_KV = kBK * 128;  // bytes of one block of K or V
  static constexpr int Q_BYTES = NH * HALF_Q;
  static constexpr int KV_BYTES = NH * HALF_KV;
  // 1024 bytes of slack for the 1024-byte alignment that the 128-byte
  // swizzle needs, then Q, the K ring, the V ring and 7 barriers.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 64;
};

static_assert(Cfg<128>::SMEM <= 232448, "over the 227 KB a CTA may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait of more
// than ~2^34 cycles (seconds) traps: a pipeline fault ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > (1ll << 34)) asm volatile("trap;");
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29,
// stride byte offset >> 4 in 32-45. Rows are 128 bytes and 8-row groups
// 1024 bytes apart (SBO). K-major operands never cross a 128-byte row
// within one k16 step, so their LBO is unused (1); for the MN-major V the
// LBO is the distance between 64-column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product (after wgmma_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs), B
// from shared memory, MN-major (stored [k][n], transposed by the unit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (bf16 pairs), B
// from shared memory, MN-major (stored [k][n], transposed by the unit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, int Hq, int group, int Tq,
    int Tk, int causal, int window, float scale_log2, float cap_raw,
    int n_qt, __nv_bfloat16* __restrict__ o) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* k_s = q_s + C::Q_BYTES;            // [stage][NH][kBK][64]
  unsigned char* v_s = k_s + kStages * C::KV_BYTES;  // [stage][NH][kBK][64]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(v_s + kStages * C::KV_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int bh = blockIdx.x;  // b * Hq + h
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;  // heaviest first
  const int kv_bh = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int q_offset = Tk - Tq;
  // Causal rows see keys up to their position, and windowed rows none
  // before their window: key tiles t_begin .. t_begin + n_tiles - 1. A tile
  // whose first row sees no key (Tq > Tk) visits every key: such rows
  // average them all.
  int k_end = Tk, t_begin = 0;
  if (causal && q_offset + q0 >= 0) {
    if (q_offset + q0 + kBQ < Tk) k_end = q_offset + q0 + kBQ;
    if (window > 0 && q_offset + q0 - window + 1 > 0)
      t_begin = (q_offset + q0 - window + 1) / kBK;
  }
  const int n_tiles = (k_end + kBK - 1) / kBK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int h = 0; h < C::NH; ++h)
        tma_load_3d(q_s + h * C::HALF_Q, &map_q, bar_q, 64 * h, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(empty + st, ph ^ 1);  // passes at once on the first lap
        mbar_expect_tx(full_k + st, C::KV_BYTES);
        for (int h = 0; h < C::NH; ++h)
          tma_load_3d(k_s + st * C::KV_BYTES + h * C::HALF_KV, &map_k,
                      full_k + st, 64 * h, (t_begin + it) * kBK, kv_bh);
        mbar_expect_tx(full_v + st, C::KV_BYTES);
        for (int h = 0; h < C::NH; ++h)
          tma_load_3d(v_s + st * C::KV_BYTES + h * C::HALF_KV, &map_v,
                      full_v + st, 64 * h, (t_begin + it) * kBK, kv_bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128 - 1;  // consumer warpgroup: 64 rows
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // This thread's accumulator rows (r0, r0 + 8) and their positions.
    const int r0 = q0 + 64 * wgi + 16 * warp + lane / 4;
    const int qpos0 = q_offset + r0, qpos1 = qpos0 + 8;
    // Keys at or below lo0 / lo1 lie outside the rows' windows (-1: none).
    const int lo0 = window > 0 ? qpos0 - window : -1;
    const int lo1 = window > 0 ? qpos1 - window : -1;
    const int wg_first = q_offset + q0 + 64 * wgi;
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float s_acc[kBK / 2];
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
    const uint32_t q_addr = smem_u32(q_s) + wgi * 64 * 128;
    mbar_wait(bar_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      mbar_wait(full_k + st, ph);
      const uint32_t k_addr = smem_u32(k_s + st * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(
            s_acc,
            desc_sw128(q_addr + (kk / 4) * C::HALF_Q + (kk % 4) * 32, 16),
            desc_sw128(k_addr + (kk / 4) * C::HALF_KV + (kk % 4) * 32, 16),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);
      if constexpr (CAP) {
        // The softcap in units of the raw product (see the note above).
        const float inv_cap = 1.f / cap_raw;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          s_acc[i] = cap_raw * tanhf(s_acc[i] * inv_cap);
      }

      // Accumulator element (j, e): column 8 j + 2 (lane % 4) + e, row r0
      // in s_acc[4 j + e] and r0 + 8 in s_acc[4 j + 2 + e].
      const int k0 = (t_begin + it) * kBK;
      const bool masked =
          k0 + kBK > Tk ||
          (causal && (k0 + kBK - 1 > wg_first ||
                      (window > 0 && k0 <= wg_first + 63 - window)));
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s_acc[4 * j + e] * scale_log2;
          float x1 = s_acc[4 * j + 2 + e] * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
            if (kpos >= Tk) {
              x0 = -INFINITY;  // no such key: weight exactly 0
              x1 = -INFINITY;
            } else if (causal) {
              if (kpos > qpos0 || kpos <= lo0) x0 = kMasked;
              if (kpos > qpos1 || kpos <= lo1) x1 = kMasked;
            }
          }
          s_acc[4 * j + e] = x0;
          s_acc[4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2f(s_acc[4 * j + e] - m0);
          const float p1 = exp2f(s_acc[4 * j + 2 + e] - m1);
          s_acc[4 * j + e] = p0;
          s_acc[4 * j + 2 + e] = p1;
          rs0 += p0;
          rs1 += p1;
        }
      }
      l0 = l0 * a0 + rs0;  // this thread's columns; summed over 4 at the end
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= a0;
        o_acc[4 * j + 1] *= a0;
        o_acc[4 * j + 2] *= a1;
        o_acc[4 * j + 3] *= a1;
      }
      // P as the A operand of k16 step kk: the accumulator's own layout,
      // two columns per register.
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(s_acc[8 * kk + 2 * r], s_acc[8 * kk + 2 * r + 1]);

      mbar_wait(full_v + st, ph);
      const uint32_t v_addr = smem_u32(v_s + st * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv(o_acc, pf[kk], desc_sw128(v_addr + kk * 16 * 128, C::HALF_KV));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
      mbar_arrive(empty + st);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 > 0.f ? l0 : 1.f);
    const float inv1 = 1.f / (l1 > 0.f ? l1 : 1.f);
    __nv_bfloat16* ob = o + static_cast<int64_t>(bh) * Tq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (r0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r0) * D +
                                           col) =
            __floats2bfloat162_rn(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
      if (r0 + 8 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<int64_t>(r0 + 8) * D + col) =
            __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1,
                                  o_acc[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a bfloat16 [heads, rows, D] array with boxes of
// 64 columns x box_rows rows x 1 head, 128-byte swizzled; rows past `rows`
// read as zeros and never from the next head.
inline bool make_map(CUtensorMap* map, const void* ptr, int D, int64_t rows,
                     int64_t heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#define WG_LAUNCH_PARAMS FA_LAUNCH_PARAMS

template <int D>
int launch(WG_LAUNCH_PARAMS) {
  using C = Cfg<D>;
  const int64_t n_qt = (Tq + kBQ - 1) / kBQ;
  if (n_qt > 65535 || Tk > (1ll << 30) || B * Hq > (1ll << 30) ||
      window < 0 || window > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, Tq, B * Hq, kBQ) ||
      !make_map(&mk, k, D, Tk, B * Hkv, kBK) ||
      !make_map(&mv, v, D, Tk, B * Hkv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = softcap > 0.f ? wgmma_kernel<D, true> : wgmma_kernel<D, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(B * Hq), static_cast<unsigned>(n_qt)),
           kThreads, C::SMEM, s>>>(
      mq, mk, mv, Hq, Hq / Hkv, static_cast<int>(Tq), static_cast<int>(Tk),
      causal, window, scale * kLog2e, softcap > 0.f ? softcap / scale : 0.f,
      static_cast<int>(n_qt), static_cast<__nv_bfloat16*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Instances and C entry points
// ---------------------------------------------------------------------------

// Explicit instances in the part that owns a head_dim; declarations only
// (resolved at link time) everywhere else.
#define FA_INSTANCES(PREFIX, DIM)                                         \
  PREFIX template int fa::launch<float, DIM>(FA_LAUNCH_PARAMS);           \
  PREFIX template int fa::launch<__nv_bfloat16, DIM>(FA_LAUNCH_PARAMS);   \
  PREFIX template int dec::launch<float, DIM>(DEC_LAUNCH_PARAMS);         \
  PREFIX template int dec::launch<__nv_bfloat16, DIM>(DEC_LAUNCH_PARAMS);
#define WG_INSTANCES(PREFIX, DIM) \
  PREFIX template int wg::launch<DIM>(WG_LAUNCH_PARAMS);

#if FA_HEAD_DIM == 16
FA_INSTANCES(, 16)
#else
FA_INSTANCES(extern, 16)
#endif
#if FA_HEAD_DIM == 32
FA_INSTANCES(, 32)
#else
FA_INSTANCES(extern, 32)
#endif
#if FA_HEAD_DIM == 64
FA_INSTANCES(, 64)
WG_INSTANCES(, 64)
#else
FA_INSTANCES(extern, 64)
WG_INSTANCES(extern, 64)
#endif
#if FA_HEAD_DIM == 128
FA_INSTANCES(, 128)
WG_INSTANCES(, 128)
#else
FA_INSTANCES(extern, 128)
WG_INSTANCES(extern, 128)
#endif
#if FA_HEAD_DIM == 256
FA_INSTANCES(, 256)
#else
FA_INSTANCES(extern, 256)
#endif

#ifdef FA_ENTRY_POINTS
namespace {

#define FA_ARGS \
  B, Hq, Hkv, Tq, Tk, causal, window, scale, softcap, q, k, v, o, s
#define DEC_ARGS                                                        \
  B, Hq, Hkv, group, heads, Tq, Tk, len, causal, window, scale, softcap,  \
      split_keys, q, k, v, o, lse, part_ml, part_acc, s

template <typename T>
int fma_dispatch(int head_dim, FA_LAUNCH_PARAMS) {
  switch (head_dim) {
    case 16: return fa::launch<T, 16>(FA_ARGS);
    case 32: return fa::launch<T, 32>(FA_ARGS);
    case 64: return fa::launch<T, 64>(FA_ARGS);
    case 128: return fa::launch<T, 128>(FA_ARGS);
    case 256: return fa::launch<T, 256>(FA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dec_dispatch(int head_dim, DEC_LAUNCH_PARAMS) {
  switch (head_dim) {
    case 16: return dec::launch<T, 16>(DEC_ARGS);
    case 32: return dec::launch<T, 32>(DEC_ARGS);
    case 64: return dec::launch<T, 64>(DEC_ARGS);
    case 128: return dec::launch<T, 128>(DEC_ARGS);
    case 256: return dec::launch<T, 256>(DEC_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
long long dec_smem(int rows, int split_keys) {
  if (rows <= 1) return dec::smem_bytes<T, D, 1>(split_keys);
  if (rows == 2) return dec::smem_bytes<T, D, 2>(split_keys);
  if (rows == 3) return dec::smem_bytes<T, D, 3>(split_keys);
  if (rows == 4) return dec::smem_bytes<T, D, 4>(split_keys);
  if (rows <= 8) return dec::smem_bytes<T, D, 8>(split_keys);
  return dec::smem_bytes<T, D, 16>(split_keys);
}

template <typename T>
long long smem_of(int kernel, int head_dim, int rows, int split_keys) {
  switch (head_dim) {
#define FA_SMEM_CASE(D)                                                   \
  case D:                                                                 \
    return kernel == 0 ? static_cast<long long>(fa::Cfg<D>::kSmemBytes)   \
                       : dec_smem<T, D>(rows, split_keys);
    FA_SMEM_CASE(16)
    FA_SMEM_CASE(32)
    FA_SMEM_CASE(64)
    FA_SMEM_CASE(128)
    FA_SMEM_CASE(256)
#undef FA_SMEM_CASE
    default: return -1;
  }
}

// Shapes every kernel takes: 0 = launch, -1 = nothing to do, else a CUDA
// error code. A window is causal and not negative.
int check(long long B, int Hq, int Hkv, long long Tq, long long Tk,
          int causal, int window) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return -1;
  if (Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || Hkv > 65535 ||
      B > 65535 || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int fa_attention(int dtype, int head_dim, long long B, int Hq,
                            int Hkv, long long Tq, long long Tk, int causal,
                            int window, float scale, float softcap,
                            const void* q, const void* k, const void* v,
                            void* o, void* stream) {
  const int c = check(B, Hq, Hkv, Tq, Tk, causal, window);
  if (c) return c < 0 ? static_cast<int>(cudaSuccess) : c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fma_dispatch<float>(head_dim, FA_ARGS);
  if (dtype == 2) return fma_dispatch<__nv_bfloat16>(head_dim, FA_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fa_decode(int dtype, int head_dim, long long B, int Hq, int Hkv,
                         long long Tq, long long Tk, int causal, int window,
                         float scale, float softcap, int split_keys,
                         const void* q, const void* k, const void* v, void* o,
                         void* part_ml_v, void* part_acc_v, void* stream) {
  const int c = check(B, Hq, Hkv, Tq, Tk, causal, window);
  if (c) return c < 0 ? static_cast<int>(cudaSuccess) : c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = nullptr;  // all Tk rows are keys
  const int group = Hq / Hkv;
  const int* heads = nullptr;
  float* lse = nullptr;
  float* part_ml = static_cast<float*>(part_ml_v);
  float* part_acc = static_cast<float*>(part_acc_v);
  if (dtype == 0) return dec_dispatch<float>(head_dim, DEC_ARGS);
  if (dtype == 2) return dec_dispatch<__nv_bfloat16>(head_dim, DEC_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Decode against a KV cache read in place: k, v [B, Hkv, S, Dh] with the
// first min(*length, S) rows valid (length: an int32 on the device, read by
// the kernel, so the host never waits for it). Not causal: every valid row
// is a key of every query row. The split grid covers the capacity S.
// map_width 0 and heads_map null: q head h reads kv head h / (Hq / Hkv);
// else heads_map [Hkv][map_width] lists each kv head's q heads (-1 past
// them), any of the Hq heads to any kv head. lse_out: null, or [B, Hq, Tq]
// floats for each row's log-sum-exp.
extern "C" int fa_decode_cache(int dtype, int head_dim, long long B, int Hq,
                               int Hkv, long long Tq, long long S, float scale,
                               float softcap, int split_keys, int map_width,
                               const void* heads_map, const void* q,
                               const void* k, const void* v,
                               const void* length, void* o, void* lse_out,
                               void* part_ml_v, void* part_acc_v,
                               void* stream) {
  const long long Tk = S;
  const int causal = 0, window = 0;  // a ring holds only in-window keys
  const bool mapped = heads_map != nullptr;
  // A map needs no divisibility: check the shapes as one head per kv head.
  const int c = check(B, Hq, mapped ? 1 : Hkv, Tq, Tk, causal, window);
  if (c) return c < 0 ? static_cast<int>(cudaSuccess) : c;
  if (length == nullptr || Hkv <= 0 || Hkv > 65535 ||
      (mapped && map_width < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  const int group = mapped ? map_width : Hq / Hkv;
  const int* heads = static_cast<const int*>(heads_map);
  float* lse = static_cast<float*>(lse_out);
  float* part_ml = static_cast<float*>(part_ml_v);
  float* part_acc = static_cast<float*>(part_acc_v);
  if (dtype == 0) return dec_dispatch<float>(head_dim, DEC_ARGS);
  if (dtype == 2) return dec_dispatch<__nv_bfloat16>(head_dim, DEC_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one CTA: kernel 0 = FMA, 1 = decode (rows per
// kv head, split_keys), 2 = wgmma; -1 for a head_dim without an instance.
extern "C" long long fa_smem_bytes(int kernel, int dtype, int head_dim,
                                   int rows, int split_keys) {
  if (kernel == 2)
    return head_dim == 64 ? wg::Cfg<64>::SMEM
                          : head_dim == 128 ? wg::Cfg<128>::SMEM : -1;
  return dtype == 2 ? smem_of<__nv_bfloat16>(kernel, head_dim, rows, split_keys)
                    : smem_of<float>(kernel, head_dim, rows, split_keys);
}

extern "C" int fa_wgmma(int head_dim, long long B, int Hq, int Hkv,
                        long long Tq, long long Tk, int causal, int window,
                        float scale, float softcap, const void* q,
                        const void* k, const void* v, void* o, void* stream) {
  const int c = check(B, Hq, Hkv, Tq, Tk, causal, window);
  if (c) return c < 0 ? static_cast<int>(cudaSuccess) : c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return wg::launch<64>(FA_ARGS);
  if (head_dim == 128) return wg::launch<128>(FA_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
