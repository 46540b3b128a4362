// Batched Kalman combine kernels for Hopper (sm_90a): paper Eq. 15 and
// Eq. 19, one Blelloch scan level per launch.
//
// Replaces: the Pallas TPU kernels of the JAX package,
//   src/repro/kernels/kalman_combine/kalman_combine.py
//   filtering_combine_batched (body _filtering_kernel -> filtering_combine_math)
//   smoothing_combine_batched (body _smoothing_kernel -> smoothing_combine_math)
// and their Pallas GPU lowering in kalman_combine/triton.py.
//
// What bounds it: every element pair is read once and its result written
// once, and the nx x nx algebra in between is a few thousand flops per pair
// (about 3k for the filtering combine at nx = 5). At the main path's shapes
// (B = 16,384 pairs, nx = 5, float64) that is 33 MB moved against 50 MFLOP,
// so the combine is bound by memory bandwidth by a wide margin: the floor
// is the HBM time of 2 element reads + 1 element write per pair.
//
// Design: one thread per element pair. The thread loads both elements
// into local arrays once, runs the whole combine over the static NX
// (template parameter, 1..16; loops fully unrolled up to NX = 8), and
// stores each output value once, so no intermediate is written to device
// memory. The four solves of Eq. 15 share
// one no-pivot Gauss-Jordan inverse of W = I + J_j C_i (the spectrum of
// I + PSD @ PSD lies right of 1), eliminated in exactly the order of the
// JAX package's gauss_jordan_inverse; (I + C_i J_j)^{-1} is its transpose.
// C, J (Eq. 15) and L (Eq. 19) are symmetrized before the store. At NX = 5
// in float64 the pair's ~170 inputs plus the [NX, 2 NX] elimination array
// exceed the 255-register budget, so the compiler spills to local memory
// (L1-cached); staging a block's elements in shared memory is the next
// step when this kernel is made fast.
//
// C interface (loaded with ctypes): each entry point takes the dtype code
// (0 = float32, 1 = float64), nx, the pair count B, the input pointers of
// element i then element j, the output pointers, and the CUDA stream; it
// launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace kc {

constexpr int kThreads = 128;

// Loops are fully unrolled (all indices static, the pair's algebra in
// registers) up to this nx; larger instances keep their loops rolled and
// their arrays in local memory: fully unrolled instances up to nx = 16 did
// not finish building in 20 minutes. The main path runs nx = 5. (Pragma
// arguments are not macro-expanded, hence a constant, not a macro.)
constexpr int kMaxUnrolledNX = 8;

template <typename T, int N>
__device__ __forceinline__ void load_mat(T (&m)[N][N], const T* __restrict__ p) {
#pragma unroll (N <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < N; ++r)
#pragma unroll (N <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < N; ++c) m[r][c] = p[r * N + c];
}

template <typename T, int N>
__device__ __forceinline__ void load_vec(T (&v)[N], const T* __restrict__ p) {
#pragma unroll (N <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < N; ++r) v[r] = p[r];
}

// out = 0.5 * (M + M^T), stored row-major.
template <typename T, int N>
__device__ __forceinline__ void store_sym(T* __restrict__ p, const T (&m)[N][N]) {
#pragma unroll (N <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < N; ++r)
#pragma unroll (N <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < N; ++c) p[r * N + c] = T(0.5) * (m[r][c] + m[c][r]);
}

template <typename T, int NX>
__global__ void __launch_bounds__(kThreads) filtering_combine_kernel(
    int64_t B,
    const T* __restrict__ gAi, const T* __restrict__ gbi,
    const T* __restrict__ gCi, const T* __restrict__ gei,
    const T* __restrict__ gJi,
    const T* __restrict__ gAj, const T* __restrict__ gbj,
    const T* __restrict__ gCj, const T* __restrict__ gej,
    const T* __restrict__ gJj,
    T* __restrict__ oA, T* __restrict__ ob, T* __restrict__ oC,
    T* __restrict__ oe, T* __restrict__ oJ) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int64_t mo = p * NX * NX;
  const int64_t vo = p * NX;

  T Ai[NX][NX], Ci[NX][NX], Ji[NX][NX], Aj[NX][NX], Cj[NX][NX], Jj[NX][NX];
  T bi[NX], ei[NX], bj[NX], ej[NX];
  load_mat(Ai, gAi + mo); load_vec(bi, gbi + vo); load_mat(Ci, gCi + mo);
  load_vec(ei, gei + vo); load_mat(Ji, gJi + mo);
  load_mat(Aj, gAj + mo); load_vec(bj, gbj + vo); load_mat(Cj, gCj + mo);
  load_vec(ej, gej + vo); load_mat(Jj, gJj + mo);

  // aug = [W | I] with W = I + J_j C_i.
  T aug[NX][2 * NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r) {
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += Jj[r][k] * Ci[k][c];
      aug[r][c] = (r == c ? T(1) : T(0)) + s;
      aug[r][NX + c] = (r == c ? T(1) : T(0));
    }
  }
  // No-pivot Gauss-Jordan, same order as repro.core.types.gauss_jordan_inverse.
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int k = 0; k < NX; ++k) {
    T piv[2 * NX];
    const T d = aug[k][k];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < 2 * NX; ++c) piv[c] = aug[k][c] / d;
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r) {
      if (r == k) continue;
      const T f = aug[r][k];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < 2 * NX; ++c) aug[r][c] = aug[r][c] - f * piv[c];
    }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < 2 * NX; ++c) aug[k][c] = piv[c];
  }
  // Winv = aug[:, NX:];  X = A_j Winv^T = A_j (I + C_i J_j)^{-1}.
  T X[NX][NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += Aj[r][k] * aug[c][NX + k];
      X[r][c] = s;
    }

  // A = X A_i
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += X[r][k] * Ai[k][c];
      oA[mo + r * NX + c] = s;
    }

  // b = X (b_i + C_i eta_j) + b_j
  T t[NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int k = 0; k < NX; ++k) {
    T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int l = 0; l < NX; ++l) s += Ci[k][l] * ej[l];
    t[k] = bi[k] + s;
  }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r) {
    T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int k = 0; k < NX; ++k) s += X[r][k] * t[k];
    ob[vo + r] = s + bj[r];
  }

  // C = sym(X C_i A_j^T + C_j)
  {
    T XC[NX][NX], Cn[NX][NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < NX; ++c) {
        T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
        for (int k = 0; k < NX; ++k) s += X[r][k] * Ci[k][c];
        XC[r][c] = s;
      }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < NX; ++c) {
        T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
        for (int k = 0; k < NX; ++k) s += XC[r][k] * Aj[c][k];
        Cn[r][c] = s + Cj[r][c];
      }
    store_sym(oC + mo, Cn);
  }

  // eta = A_i^T Winv (eta_j - J_j b_i) + eta_i
  {
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int k = 0; k < NX; ++k) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int l = 0; l < NX; ++l) s += Jj[k][l] * bi[l];
      t[k] = ej[k] - s;
    }
    T z[NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += aug[r][NX + k] * t[k];
      z[r] = s;
    }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += Ai[k][r] * z[k];
      oe[vo + r] = s + ei[r];
    }
  }

  // J = sym(A_i^T Winv (J_j A_i) + J_i)
  {
    T JA[NX][NX], ZJ[NX][NX], Jn[NX][NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < NX; ++c) {
        T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
        for (int k = 0; k < NX; ++k) s += Jj[r][k] * Ai[k][c];
        JA[r][c] = s;
      }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < NX; ++c) {
        T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
        for (int k = 0; k < NX; ++k) s += aug[r][NX + k] * JA[k][c];
        ZJ[r][c] = s;
      }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int c = 0; c < NX; ++c) {
        T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
        for (int k = 0; k < NX; ++k) s += Ai[k][r] * ZJ[k][c];
        Jn[r][c] = s + Ji[r][c];
      }
    store_sym(oJ + mo, Jn);
  }
}

template <typename T, int NX>
__global__ void __launch_bounds__(kThreads) smoothing_combine_kernel(
    int64_t B,
    const T* __restrict__ gEi, const T* __restrict__ ggi,
    const T* __restrict__ gLi,
    const T* __restrict__ gEj, const T* __restrict__ ggj,
    const T* __restrict__ gLj,
    T* __restrict__ oE, T* __restrict__ og, T* __restrict__ oL) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int64_t mo = p * NX * NX;
  const int64_t vo = p * NX;

  T Ei[NX][NX], Li[NX][NX], Ej[NX][NX], Lj[NX][NX];
  T gi[NX], gj[NX];
  load_mat(Ei, gEi + mo); load_vec(gi, ggi + vo); load_mat(Li, gLi + mo);
  load_mat(Ej, gEj + mo); load_vec(gj, ggj + vo); load_mat(Lj, gLj + mo);

  // E = E_i E_j
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += Ei[r][k] * Ej[k][c];
      oE[mo + r * NX + c] = s;
    }
  // g = E_i g_j + g_i
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r) {
    T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int k = 0; k < NX; ++k) s += Ei[r][k] * gj[k];
    og[vo + r] = s + gi[r];
  }
  // L = sym(E_i L_j E_i^T + L_i)
  T EL[NX][NX], Ln[NX][NX];
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += Ei[r][k] * Lj[k][c];
      EL[r][c] = s;
    }
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
  for (int r = 0; r < NX; ++r)
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
    for (int c = 0; c < NX; ++c) {
      T s = T(0);
#pragma unroll (NX <= kMaxUnrolledNX ? 32 : 1)
      for (int k = 0; k < NX; ++k) s += EL[r][k] * Ei[c][k];
      Ln[r][c] = s + Li[r][c];
    }
  store_sym(oL + mo, Ln);
}

inline unsigned int blocks_for(int64_t B) {
  return static_cast<unsigned int>((B + kThreads - 1) / kThreads);
}

}  // namespace kc

// One launcher per (kernel, dtype, NX). The build compiles this file once
// per part, all parts at the same time: a part built with
// -DKC_NX_FIRST=a -DKC_NX_LAST=b instantiates the launchers of nx in
// [a, b] (and only their kernels), and the part built with
// -DKC_ENTRY_POINTS holds the C interface, which dispatches to all of them.
// Without these flags one translation unit holds everything.
template <typename T, int NX>
int kc_launch_filtering(int64_t B, const void* const* in, void* const* out,
                        cudaStream_t s) {
  const T* const* i = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  kc::filtering_combine_kernel<T, NX><<<kc::blocks_for(B), kc::kThreads, 0, s>>>(
      B, i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9], o[0],
      o[1], o[2], o[3], o[4]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NX>
int kc_launch_smoothing(int64_t B, const void* const* in, void* const* out,
                        cudaStream_t s) {
  const T* const* i = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  kc::smoothing_combine_kernel<T, NX><<<kc::blocks_for(B), kc::kThreads, 0, s>>>(
      B, i[0], i[1], i[2], i[3], i[4], i[5], o[0], o[1], o[2]);
  return static_cast<int>(cudaGetLastError());
}

#ifndef KC_NX_FIRST
#define KC_NX_FIRST 1
#define KC_NX_LAST 16
#define KC_ENTRY_POINTS
#endif
#define KC_OWNS(N) (KC_NX_FIRST <= (N) && (N) <= KC_NX_LAST)

#define KC_SIG int64_t, const void* const*, void* const*, cudaStream_t
#define KC_INSTANTIATE(N)                                                     \
  template int kc_launch_filtering<float, N>(KC_SIG);                         \
  template int kc_launch_filtering<double, N>(KC_SIG);                        \
  template int kc_launch_smoothing<float, N>(KC_SIG);                         \
  template int kc_launch_smoothing<double, N>(KC_SIG);
#define KC_EXTERN(N)                                                          \
  extern template int kc_launch_filtering<float, N>(KC_SIG);                  \
  extern template int kc_launch_filtering<double, N>(KC_SIG);                 \
  extern template int kc_launch_smoothing<float, N>(KC_SIG);                  \
  extern template int kc_launch_smoothing<double, N>(KC_SIG);

#if KC_OWNS(1)
KC_INSTANTIATE(1)
#else
KC_EXTERN(1)
#endif
#if KC_OWNS(2)
KC_INSTANTIATE(2)
#else
KC_EXTERN(2)
#endif
#if KC_OWNS(3)
KC_INSTANTIATE(3)
#else
KC_EXTERN(3)
#endif
#if KC_OWNS(4)
KC_INSTANTIATE(4)
#else
KC_EXTERN(4)
#endif
#if KC_OWNS(5)
KC_INSTANTIATE(5)
#else
KC_EXTERN(5)
#endif
#if KC_OWNS(6)
KC_INSTANTIATE(6)
#else
KC_EXTERN(6)
#endif
#if KC_OWNS(7)
KC_INSTANTIATE(7)
#else
KC_EXTERN(7)
#endif
#if KC_OWNS(8)
KC_INSTANTIATE(8)
#else
KC_EXTERN(8)
#endif
#if KC_OWNS(9)
KC_INSTANTIATE(9)
#else
KC_EXTERN(9)
#endif
#if KC_OWNS(10)
KC_INSTANTIATE(10)
#else
KC_EXTERN(10)
#endif
#if KC_OWNS(11)
KC_INSTANTIATE(11)
#else
KC_EXTERN(11)
#endif
#if KC_OWNS(12)
KC_INSTANTIATE(12)
#else
KC_EXTERN(12)
#endif
#if KC_OWNS(13)
KC_INSTANTIATE(13)
#else
KC_EXTERN(13)
#endif
#if KC_OWNS(14)
KC_INSTANTIATE(14)
#else
KC_EXTERN(14)
#endif
#if KC_OWNS(15)
KC_INSTANTIATE(15)
#else
KC_EXTERN(15)
#endif
#if KC_OWNS(16)
KC_INSTANTIATE(16)
#else
KC_EXTERN(16)
#endif

#ifdef KC_ENTRY_POINTS
namespace {

#define KC_CASES(LAUNCH)                                                      \
  KC_CASE(LAUNCH, 1) KC_CASE(LAUNCH, 2) KC_CASE(LAUNCH, 3)                    \
  KC_CASE(LAUNCH, 4) KC_CASE(LAUNCH, 5) KC_CASE(LAUNCH, 6)                    \
  KC_CASE(LAUNCH, 7) KC_CASE(LAUNCH, 8) KC_CASE(LAUNCH, 9)                    \
  KC_CASE(LAUNCH, 10) KC_CASE(LAUNCH, 11) KC_CASE(LAUNCH, 12)                 \
  KC_CASE(LAUNCH, 13) KC_CASE(LAUNCH, 14) KC_CASE(LAUNCH, 15)                 \
  KC_CASE(LAUNCH, 16)
#define KC_CASE(LAUNCH, N) \
  case N:                  \
    return LAUNCH<T, N>(B, in, out, s);

template <typename T>
int dispatch_filtering(int nx, int64_t B, const void* const* in,
                       void* const* out, cudaStream_t s) {
  switch (nx) {
    KC_CASES(kc_launch_filtering)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_smoothing(int nx, int64_t B, const void* const* in,
                       void* const* out, cudaStream_t s) {
  switch (nx) {
    KC_CASES(kc_launch_smoothing)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef KC_CASE
#undef KC_CASES

}  // namespace

extern "C" {

int kc_filtering_combine(int dtype, int nx, long long B,
                         const void* Ai, const void* bi, const void* Ci,
                         const void* ei, const void* Ji,
                         const void* Aj, const void* bj, const void* Cj,
                         const void* ej, const void* Jj,
                         void* Ao, void* bo, void* Co, void* eo, void* Jo,
                         void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const void* in[10] = {Ai, bi, Ci, ei, Ji, Aj, bj, Cj, ej, Jj};
  void* out[5] = {Ao, bo, Co, eo, Jo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_filtering<float>(nx, B, in, out, s);
  if (dtype == 1) return dispatch_filtering<double>(nx, B, in, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int kc_smoothing_combine(int dtype, int nx, long long B,
                         const void* Ei, const void* gi, const void* Li,
                         const void* Ej, const void* gj, const void* Lj,
                         void* Eo, void* go, void* Lo, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const void* in[6] = {Ei, gi, Li, Ej, gj, Lj};
  void* out[3] = {Eo, go, Lo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_smoothing<float>(nx, B, in, out, s);
  if (dtype == 1) return dispatch_smoothing<double>(nx, B, in, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
#endif  // KC_ENTRY_POINTS
