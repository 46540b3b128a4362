// Blocked causal GQA attention with an online softmax for Hopper (sm_90a).
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
// copies: every load is bounds-checked), so a row that sees no key
// (causal, Tq > Tk) averages v over the Tk real keys, as the oracle
// attention_ref does; the TPU kernel also averages its zero padding there.
//
// What bounds it: a prefill (Tq = Tk = T) does 4 B Hq Dh T (T + 1) / 2
// operations on 4 B H T Dh values: far above the card's ridge point, so the
// floor is the tensor cores' rate. A decode step (Tq = 1) reads the whole
// key/value cache once for 4 Dh Tk operations per head: bound by memory.
//
// Design (simple and right first; tensor cores, wgmma and TMA come when
// this kernel is made fast): one CTA of 256 threads per (q tile of BQ
// rows, q head, batch). The Q tile is staged once in shared memory as
// float32; then for each tile of kBK keys (only up to the causal limit
// of the Q tile), K and V are staged as float32 and
//   1. each thread computes RQ x CK scores with plain FMAs (its RQ rows
//      ty*RQ.., its CK columns tx + 16 j; K rows are padded to Dh + 1
//      floats so the 16 columns fall in 16 banks);
//   2. the row max and row sum of the online softmax are reduced over the
//      16 threads of a half-warp that share those rows (shuffles), the
//      running max m, denominator l and the accumulator are rescaled, and
//      the probabilities go to shared memory;
//   3. each thread adds P V into its RQ x Dh/16 accumulator (columns
//      tx + 16 j), in registers.
// m, l and the accumulator are float32 whatever the input type; the
// output is rounded to the input type once. Warps whose rows all lie past
// Tq (decode: Tq = 1) skip the multiply-adds.
//
// C interface (loaded with ctypes): fa_attention(dtype, head_dim, B, Hq,
// Hkv, Tq, Tk, causal, scale, q, k, v, o, stream) with dtype 0 = float32,
// 2 = bfloat16 and head_dim one of 16, 32, 64, 128, 256; densely packed
// arrays. It launches on that stream and returns cudaGetLastError().
//
// The file compiles as several parts (one nvcc -c each, in parallel): the
// part built with -DFA_HEAD_DIM=<d> holds the instances of that head_dim,
// the part built with -DFA_ENTRY_POINTS the C entry point.

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
    int Hq, int group, int64_t Tq, int64_t Tk, int causal, float scale,
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o) {
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
  // Causal rows see keys up to their position. A tile whose first row
  // sees no key (Tq > Tk) visits every key: such rows average them all.
  int64_t k_end = Tk;
  if (causal && q_offset + q0 >= 0 && q_offset + q0 + BQ < Tk)
    k_end = q_offset + q0 + BQ;

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = 0; k0 < k_end; k0 += kBK) {
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
        if (kpos >= Tk)
          x = -INFINITY;  // no such key: weight exactly 0
        else if (causal && qpos < kpos)
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
      float scale, const void *q, const void *k, const void *v, void *o,     \
      cudaStream_t s

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
      Hq, Hq / Hkv, Tq, Tk, causal, scale, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o));
  return static_cast<int>(cudaGetLastError());
}

// Explicit instances in the part that owns a head_dim; declarations only
// (resolved at link time) everywhere else.
#define FA_INSTANCES(PREFIX, DIM)                                  \
  PREFIX template int launch<float, DIM>(FA_LAUNCH_PARAMS);        \
  PREFIX template int launch<__nv_bfloat16, DIM>(FA_LAUNCH_PARAMS);

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
#else
FA_INSTANCES(extern, 64)
#endif
#if FA_HEAD_DIM == 128
FA_INSTANCES(, 128)
#else
FA_INSTANCES(extern, 128)
#endif
#if FA_HEAD_DIM == 256
FA_INSTANCES(, 256)
#else
FA_INSTANCES(extern, 256)
#endif

#ifdef FA_ENTRY_POINTS
template <typename T>
int dispatch(int head_dim, FA_LAUNCH_PARAMS) {
  switch (head_dim) {
    case 16: return launch<T, 16>(B, Hq, Hkv, Tq, Tk, causal, scale, q, k, v, o, s);
    case 32: return launch<T, 32>(B, Hq, Hkv, Tq, Tk, causal, scale, q, k, v, o, s);
    case 64: return launch<T, 64>(B, Hq, Hkv, Tq, Tk, causal, scale, q, k, v, o, s);
    case 128: return launch<T, 128>(B, Hq, Hkv, Tq, Tk, causal, scale, q, k, v, o, s);
    case 256: return launch<T, 256>(B, Hq, Hkv, Tq, Tk, causal, scale, q, k, v, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

}  // namespace fa

#ifdef FA_ENTRY_POINTS
extern "C" int fa_attention(int dtype, int head_dim, long long B, int Hq,
                            int Hkv, long long Tq, long long Tk, int causal,
                            float scale, const void* q, const void* k,
                            const void* v, void* o, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return static_cast<int>(cudaSuccess);
  if (Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa::dispatch<float>(head_dim, B, Hq, Hkv, Tq, Tk, causal, scale,
                               q, k, v, o, s);
  if (dtype == 2)
    return fa::dispatch<__nv_bfloat16>(head_dim, B, Hq, Hkv, Tq, Tk, causal,
                                       scale, q, k, v, o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
