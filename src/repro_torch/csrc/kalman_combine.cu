// Batched Kalman combine kernels for Hopper (sm_90a): paper Eq. 15 and
// Eq. 19, one Blelloch scan level per launch, read in place.
//
// Replaces: the Pallas TPU kernels of the JAX package,
//   src/repro/kernels/kalman_combine/kalman_combine.py
//   filtering_combine_batched (body _filtering_kernel -> filtering_combine_math)
//   smoothing_combine_batched (body _smoothing_kernel -> smoothing_combine_math)
// and their Pallas GPU lowering in kalman_combine/triton.py.
//
// What bounds it: every element pair is read once and its result written
// once, and the nx x nx algebra in between is a few thousand flops per pair
// (about 3k for the filtering combine at nx = 5). At the smoother's top
// scan level (64 x 256 pairs, nx = 5, float64) that is 33 MB moved against
// 50 MFLOP, so the combine is bound by memory bandwidth by a wide margin:
// the floor is the HBM time of 2 element reads + 1 element write per pair
// (9.98 us filtering, 6.46 us smoothing at 3.35 TB/s). The small levels
// (64 to 2,048 pairs) are bound by latency: launch, one round trip to
// memory and one pair's chain of dependent products.
//
// Design:
// * Pairs on a [L, P] grid, read in place. Each input field is described
//   by a pointer, a lead stride and a pair stride (in elements); only the
//   trailing nx or nx x nx block must be dense. A scan level's strided
//   slices (x[:, 0:-1:2], x[:, 1::2], odd[:, :-1], ...) are read as they
//   lie, so the scan makes no packing copies. Outputs are fresh contiguous
//   [L, P, ...] tensors.
// * One CTA per tile of pairs within one row l. The tile's inputs are
//   staged field by field into shared memory with cp.async, indexed
//   linearly over (pair, value) so that neighbouring threads read
//   neighbouring addresses, and every load of the tile is in flight before
//   the first wait. Slices are only element-aligned (x[:, 1::2] at
//   float64, nx = 5 starts 200 B apart), so each copy is one element. A
//   ragged tile zeroes its empty slots. Outputs go back the same way: each
//   team writes its results over its own element-i slots, then the CTA
//   stores the tile field by field, coalesced.
// * A team of nx lanes per pair (six pairs per warp at nx = 5), lane r
//   owning row r; lanes past a warp's last team shadow its last row and
//   write nothing. A matrix product keeps the lane's own row in registers
//   and reads the other operand from shared memory, where the whole team
//   reads one address (a broadcast). Per-thread state is O(nx) values, so
//   nothing spills.
// * The four solves of Eq. 15 share one no-pivot Gauss-Jordan inverse of
//   W = I + J_j C_i ((I + C_i J_j)^{-1} is its transpose), eliminated in
//   the order of the JAX package's gauss_jordan_inverse: the pivot row is
//   broadcast within the team through __shfl_sync. Each step touches only
//   the nx columns that can be nonzero in the pivot row and divides
//   through one reciprocal with a Markstein correction, which gives the
//   bits of the division (see `quotient`). Symmetrizing C, J and L
//   transposes through shared memory.
// * The tile size per (dtype, nx) instance comes from a 48 KB static
//   shared-memory budget (two elements plus scratch per pair), up to four
//   warps: three warps (18 pairs, 37,440 B) for the filtering combine at
//   float64, nx = 5.
//
// C interface (loaded with ctypes): each entry point takes the dtype code
// (0 = float32, 1 = float64), nx, L, P, the input pointers (element i's
// fields, then element j's), their lead and pair strides, the output
// pointers and the CUDA stream; it launches on that stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace kc {

constexpr int kMaxWarps = 4;
constexpr int kSmemBudget = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// Shared-memory regions of a tile, each [pairs][size] values. Filtering:
// element i (A, b, C, eta, J: regions 0-4), element j (5-9), then scratch:
// W^{-1} then ZJ (10), JA then Jn (11), Cn (12) and three nx-vectors.
__host__ __device__ constexpr int filtering_size(int region, int nx) {
  return (region == 1 || region == 3 || region == 6 || region == 8 ||
          region >= 13) ? nx : nx * nx;
}
constexpr int kFilteringRegions = 16;

// Smoothing: element i (E, g, L: 0-2), element j (3-5), then scratch Ln.
__host__ __device__ constexpr int smoothing_size(int region, int nx) {
  return (region == 1 || region == 4) ? nx : nx * nx;
}
constexpr int kSmoothingRegions = 7;

template <bool FILTERING>
__host__ __device__ constexpr int region_size(int region, int nx) {
  return FILTERING ? filtering_size(region, nx) : smoothing_size(region, nx);
}

template <bool FILTERING>
__host__ __device__ constexpr int region_offset(int region, int nx) {
  int off = 0;
  for (int i = 0; i < region; ++i) off += region_size<FILTERING>(i, nx);
  return off;
}

template <typename T, int NX, bool FILTERING>
struct Tile {
  // A team of NX lanes per pair, as many teams as fit in a warp (lanes past
  // the last team idle).
  static constexpr int kTeamsPerWarp = 32 / NX;
  static constexpr int kValuesPerPair = region_offset<FILTERING>(
      FILTERING ? kFilteringRegions : kSmoothingRegions, NX);
  static constexpr int kWarpBytes =
      kTeamsPerWarp * kValuesPerPair * static_cast<int>(sizeof(T));
  static constexpr int kWarpsBySmem = kSmemBudget / kWarpBytes;
  static constexpr int kWarps =
      kWarpsBySmem < kMaxWarps ? kWarpsBySmem : kMaxWarps;
  static constexpr int kPairs = kWarps * kTeamsPerWarp;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kSmemValues = kPairs * kValuesPerPair;
  static_assert(kWarps >= 1, "a warp of pairs must fit");

  template <int REGION>
  static constexpr int kSize = region_size<FILTERING>(REGION, NX);

  // This team's slot of a region.
  template <int REGION>
  static __device__ __forceinline__ T* slot(T* smem, int team) {
    return smem + region_offset<FILTERING>(REGION, NX) * kPairs +
           team * kSize<REGION>;
  }
};

// Where a thread sits: its pair (team) in the tile, its row r, the lane of
// its team's row 0 in the warp, and whether it owns row r (lanes past the
// warp's last team shadow that team's last row and write nothing).
template <int NX, int TEAMS_PER_WARP>
struct Lane {
  int team, r, base;
  bool owner;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32;
    const int t = lane / NX;
    owner = t < TEAMS_PER_WARP;
    const int tw = owner ? t : TEAMS_PER_WARP - 1;
    team = static_cast<int>(threadIdx.x / 32) * TEAMS_PER_WARP + tw;
    base = tw * NX;
    r = owner ? lane - base : NX - 1;
  }
};

// Pointers and strides (in elements) of the fields of one launch.
template <int NIN, int NOUT>
struct Fields {
  const void* in[NIN];
  long long lead[NIN];
  long long pair[NIN];
  void* out[NOUT];
  long long P;      // pairs per row
  long long tiles;  // CTAs per row
};

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy region REGION of the tile's np pairs (field REGION of the launch,
// a dense block per pair at stride `pair`) into shared memory, linearly over
// (pair, value); zero the slots of pairs past np.
template <typename T, typename TILE, int REGION, typename F>
__device__ __forceinline__ void stage_in(T* smem, const F& f, long long l,
                                         long long p0, int np) {
  constexpr int SIZE = TILE::template kSize<REGION>;
  T* dst = TILE::template slot<REGION>(smem, 0);
  const T* src = static_cast<const T*>(f.in[REGION]) + l * f.lead[REGION] +
                 p0 * f.pair[REGION];
  const long long pair = f.pair[REGION];
  for (int i = threadIdx.x; i < TILE::kPairs * SIZE; i += TILE::kThreads) {
    const int q = i / SIZE;
    if (q < np)
      cp_async(dst + i, src + q * pair + (i - q * SIZE));
    else
      dst[i] = T(0);  // a ragged tile's empty slots: benign inputs
  }
}

// Store region REGION (element i's slots, now holding the results) to
// output REGION, a contiguous [L, P, size] tensor.
template <typename T, typename TILE, int REGION, typename F>
__device__ __forceinline__ void store_out(T* smem, const F& f, long long l,
                                          long long p0, int np) {
  constexpr int SIZE = TILE::template kSize<REGION>;
  const T* src = TILE::template slot<REGION>(smem, 0);
  T* dst = static_cast<T*>(f.out[REGION]) + (l * f.P + p0) * SIZE;
  for (int i = threadIdx.x; i < np * SIZE; i += TILE::kThreads)
    dst[i] = src[i];
}

// x / d from rd = 1 / d (correctly rounded): one Markstein correction of
// x * rd gives the correctly rounded quotient, the same bits as x / d, for
// finite x and nonzero d, with a multiply and two FMAs instead of a
// division (a long sequence with a slow-path branch) per column.
__device__ __forceinline__ double quotient(double x, double d, double rd) {
  const double q = __dmul_rn(x, rd);
  return __fma_rn(__fma_rn(-q, d, x), rd, q);
}

__device__ __forceinline__ float quotient(float x, float d, float rd) {
  const float q = __fmul_rn(x, rd);
  return __fmaf_rn(__fmaf_rn(-q, d, x), rd, q);
}

// out[c] = sum_k row[k] * N[k * NX + c]: row r of a product whose left
// operand's row is in registers and whose right operand is in shared memory
// (read by the whole team at one address).
template <typename T, int NX>
__device__ __forceinline__ void row_times(T (&out)[NX], const T (&row)[NX],
                                          const T* N) {
#pragma unroll
  for (int c = 0; c < NX; ++c) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += row[k] * N[k * NX + c];
    out[c] = s;
  }
}

// out[c] = sum_k row[k] * N[c * NX + k]: the same against N^T.
template <typename T, int NX>
__device__ __forceinline__ void row_times_t(T (&out)[NX], const T (&row)[NX],
                                            const T* N) {
#pragma unroll
  for (int c = 0; c < NX; ++c) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < NX; ++k) s += row[k] * N[c * NX + k];
    out[c] = s;
  }
}

template <typename T, int NX>
__device__ __forceinline__ void load_row(T (&out)[NX], const T* M, int r) {
#pragma unroll
  for (int c = 0; c < NX; ++c) out[c] = M[r * NX + c];
}

// Column r of M (row r of M^T).
template <typename T, int NX>
__device__ __forceinline__ void load_col(T (&out)[NX], const T* M, int r) {
#pragma unroll
  for (int k = 0; k < NX; ++k) out[k] = M[k * NX + r];
}

template <typename T, int NX>
__device__ __forceinline__ void store_row(T* M, int r, const T (&row)[NX],
                                          bool owner) {
  if (owner) {
#pragma unroll
    for (int c = 0; c < NX; ++c) M[r * NX + c] = row[c];
  }
}

template <typename T, int NX>
__device__ __forceinline__ T dot(const T (&a)[NX], const T* v) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < NX; ++k) s += a[k] * v[k];
  return s;
}

// ---------------------------------------------------------------------------
// Eq. 15
// ---------------------------------------------------------------------------

template <typename T, int NX>
__global__ void __launch_bounds__((Tile<T, NX, true>::kThreads))
filtering_combine_kernel(const Fields<10, 5> f) {
  using TL = Tile<T, NX, true>;
  __shared__ __align__(16) T smem[TL::kSmemValues];

  const long long l = blockIdx.x / f.tiles;
  const long long p0 = (blockIdx.x - l * f.tiles) * TL::kPairs;
  const int np = static_cast<int>(
      f.P - p0 < TL::kPairs ? f.P - p0 : TL::kPairs);

  stage_in<T, TL, 0>(smem, f, l, p0, np);
  stage_in<T, TL, 1>(smem, f, l, p0, np);
  stage_in<T, TL, 2>(smem, f, l, p0, np);
  stage_in<T, TL, 3>(smem, f, l, p0, np);
  stage_in<T, TL, 4>(smem, f, l, p0, np);
  stage_in<T, TL, 5>(smem, f, l, p0, np);
  stage_in<T, TL, 6>(smem, f, l, p0, np);
  stage_in<T, TL, 7>(smem, f, l, p0, np);
  stage_in<T, TL, 8>(smem, f, l, p0, np);
  stage_in<T, TL, 9>(smem, f, l, p0, np);
  cp_async_wait_all();
  __syncthreads();

  // Warps that hold no pair of a ragged tile skip the algebra (a
  // warp-uniform branch: the team syncs below stay whole).
  if (static_cast<int>(threadIdx.x / 32) * TL::kTeamsPerWarp < np) {
    const Lane<NX, TL::kTeamsPerWarp> ln;
    const int r = ln.r;
    const bool owner = ln.owner;
    T* Ai = TL::template slot<0>(smem, ln.team);
    T* bi = TL::template slot<1>(smem, ln.team);
    T* Ci = TL::template slot<2>(smem, ln.team);
    T* ei = TL::template slot<3>(smem, ln.team);
    T* Ji = TL::template slot<4>(smem, ln.team);
    const T* Aj = TL::template slot<5>(smem, ln.team);
    const T* bj = TL::template slot<6>(smem, ln.team);
    const T* Cj = TL::template slot<7>(smem, ln.team);
    const T* ej = TL::template slot<8>(smem, ln.team);
    const T* Jj = TL::template slot<9>(smem, ln.team);
    T* sW = TL::template slot<10>(smem, ln.team);  // W^{-1}, then ZJ
    T* sM = TL::template slot<11>(smem, ln.team);  // JA, then Jn
    T* sCn = TL::template slot<12>(smem, ln.team);
    T* v1 = TL::template slot<13>(smem, ln.team);
    T* v2 = TL::template slot<14>(smem, ln.team);
    T* v3 = TL::template slot<15>(smem, ln.team);

    // Row r of W = I + J_j C_i: the left half of [W | I].
    T jj[NX], wl[NX], wr[NX];
    load_row(jj, Jj, r);
    row_times(wl, jj, Ci);
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      wl[c] += (r == c ? T(1) : T(0));
      wr[c] = (r == c ? T(1) : T(0));
    }
    // No-pivot Gauss-Jordan in the order of
    // repro.core.types.gauss_jordan_inverse: at step k lane k's row,
    // divided by its pivot, is broadcast within the team. Only the columns
    // that can be nonzero in the pivot row are touched: left columns past
    // k (those up to k are already e_0..e_k) and right columns up to k (the
    // rest of the pivot row is still exactly zero), so W^{-1} is the same
    // as with all 2 NX columns.
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const T d = __shfl_sync(kFullMask, wl[k], ln.base + k);
      const T rd = T(1) / d;
      const T fk = wl[k];
#pragma unroll
      for (int c = k + 1; c < NX; ++c) {
        const T piv =
            quotient(__shfl_sync(kFullMask, wl[c], ln.base + k), d, rd);
        wl[c] = r == k ? piv : wl[c] - fk * piv;
      }
#pragma unroll
      for (int c = 0; c <= k; ++c) {
        const T piv =
            quotient(__shfl_sync(kFullMask, wr[c], ln.base + k), d, rd);
        wr[c] = r == k ? piv : wr[c] - fk * piv;
      }
    }
    // wr is row r of W^{-1}.
    store_row(sW, r, wr, owner);
    __syncwarp();

    // X = A_j W^{-T} = A_j (I + C_i J_j)^{-1}, row r.
    T aj[NX], x[NX];
    load_row(aj, Aj, r);
    row_times_t(x, aj, sW);
    // A = X A_i, row r (kept in registers until the end).
    T oA[NX];
    row_times(oA, x, Ai);
    // b = X (b_i + C_i eta_j) + b_j
    T tmp[NX];
    load_row(tmp, Ci, r);
    const T t1 = bi[r] + dot(tmp, ej);
    // eta_j - J_j b_i
    const T t2 = ej[r] - dot(jj, bi);
    if (owner) {
      v1[r] = t1;
      v2[r] = t2;
    }
    // Cn = (X C_i) A_j^T + C_j, row r.
    T xc[NX], cn[NX];
    row_times(xc, x, Ci);
    row_times_t(cn, xc, Aj);
#pragma unroll
    for (int c = 0; c < NX; ++c) cn[c] += Cj[r * NX + c];
    store_row(sCn, r, cn, owner);
    // JA = J_j A_i, row r.
    T ja[NX];
    row_times(ja, jj, Ai);
    store_row(sM, r, ja, owner);
    __syncwarp();
    const T ob = dot(x, v1) + bj[r];
    // z = W^{-1} (eta_j - J_j b_i), then eta = A_i^T z + eta_i.
    const T z = dot(wr, v2);
    // ZJ = W^{-1} (J_j A_i), row r.
    T zj[NX];
    row_times(zj, wr, sM);
    __syncwarp();
    if (owner) v3[r] = z;
    store_row(sW, r, zj, owner);
    __syncwarp();
    T ai[NX];
    load_col(ai, Ai, r);
    const T oe = dot(ai, v3) + ei[r];
    // Jn = A_i^T ZJ + J_i, row r.
    T jn[NX];
    row_times(jn, ai, sW);
#pragma unroll
    for (int c = 0; c < NX; ++c) jn[c] += Ji[r * NX + c];
    store_row(sM, r, jn, owner);
    __syncwarp();

    // Every read of element i's slots is done: write the results over
    // them, C and J symmetrized through the transposes in shared memory.
    if (owner) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        Ai[r * NX + c] = oA[c];
        Ci[r * NX + c] = T(0.5) * (sCn[r * NX + c] + sCn[c * NX + r]);
        Ji[r * NX + c] = T(0.5) * (sM[r * NX + c] + sM[c * NX + r]);
      }
      bi[r] = ob;
      ei[r] = oe;
    }
  }
  __syncthreads();
  store_out<T, TL, 0>(smem, f, l, p0, np);
  store_out<T, TL, 1>(smem, f, l, p0, np);
  store_out<T, TL, 2>(smem, f, l, p0, np);
  store_out<T, TL, 3>(smem, f, l, p0, np);
  store_out<T, TL, 4>(smem, f, l, p0, np);
}

// ---------------------------------------------------------------------------
// Eq. 19
// ---------------------------------------------------------------------------

template <typename T, int NX>
__global__ void __launch_bounds__((Tile<T, NX, false>::kThreads))
smoothing_combine_kernel(const Fields<6, 3> f) {
  using TL = Tile<T, NX, false>;
  __shared__ __align__(16) T smem[TL::kSmemValues];

  const long long l = blockIdx.x / f.tiles;
  const long long p0 = (blockIdx.x - l * f.tiles) * TL::kPairs;
  const int np = static_cast<int>(
      f.P - p0 < TL::kPairs ? f.P - p0 : TL::kPairs);

  stage_in<T, TL, 0>(smem, f, l, p0, np);
  stage_in<T, TL, 1>(smem, f, l, p0, np);
  stage_in<T, TL, 2>(smem, f, l, p0, np);
  stage_in<T, TL, 3>(smem, f, l, p0, np);
  stage_in<T, TL, 4>(smem, f, l, p0, np);
  stage_in<T, TL, 5>(smem, f, l, p0, np);
  cp_async_wait_all();
  __syncthreads();

  if (static_cast<int>(threadIdx.x / 32) * TL::kTeamsPerWarp < np) {
    const Lane<NX, TL::kTeamsPerWarp> ln;
    const int r = ln.r;
    const bool owner = ln.owner;
    T* Ei = TL::template slot<0>(smem, ln.team);
    T* gi = TL::template slot<1>(smem, ln.team);
    T* Li = TL::template slot<2>(smem, ln.team);
    const T* Ej = TL::template slot<3>(smem, ln.team);
    const T* gj = TL::template slot<4>(smem, ln.team);
    const T* Lj = TL::template slot<5>(smem, ln.team);
    T* sL = TL::template slot<6>(smem, ln.team);

    // E = E_i E_j, g = E_i g_j + g_i, row r.
    T ei[NX], oE[NX];
    load_row(ei, Ei, r);
    row_times(oE, ei, Ej);
    const T og = dot(ei, gj) + gi[r];
    // Ln = (E_i L_j) E_i^T + L_i, row r.
    T el[NX], lnew[NX];
    row_times(el, ei, Lj);
    row_times_t(lnew, el, Ei);
#pragma unroll
    for (int c = 0; c < NX; ++c) lnew[c] += Li[r * NX + c];
    store_row(sL, r, lnew, owner);
    __syncwarp();

    if (owner) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        Ei[r * NX + c] = oE[c];
        Li[r * NX + c] = T(0.5) * (sL[r * NX + c] + sL[c * NX + r]);
      }
      gi[r] = og;
    }
  }
  __syncthreads();
  store_out<T, TL, 0>(smem, f, l, p0, np);
  store_out<T, TL, 1>(smem, f, l, p0, np);
  store_out<T, TL, 2>(smem, f, l, p0, np);
}

}  // namespace kc

// One launcher per (kernel, dtype, NX). The build compiles this file once
// per part, all parts at the same time: a part built with
// -DKC_NX_FIRST=a -DKC_NX_LAST=b instantiates the launchers of nx in
// [a, b] (and only their kernels), and the part built with
// -DKC_ENTRY_POINTS holds the C interface, which dispatches to all of them.
// Without these flags one translation unit holds everything.
template <typename T, int NX, bool FILTERING, int NIN, int NOUT>
int kc_launch(void (*kernel)(const kc::Fields<NIN, NOUT>), long long L,
              long long P, const void* const* in, const long long* lead,
              const long long* pair, void* const* out, cudaStream_t s) {
  using TL = kc::Tile<T, NX, FILTERING>;
  kc::Fields<NIN, NOUT> f;
  for (int i = 0; i < NIN; ++i) {
    f.in[i] = in[i];
    f.lead[i] = lead[i];
    f.pair[i] = pair[i];
  }
  for (int o = 0; o < NOUT; ++o) f.out[o] = out[o];
  f.P = P;
  f.tiles = (P + TL::kPairs - 1) / TL::kPairs;
  const long long blocks = L * f.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), TL::kThreads, 0, s>>>(f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NX>
int kc_launch_filtering(long long L, long long P, const void* const* in,
                        const long long* lead, const long long* pair,
                        void* const* out, cudaStream_t s) {
  return kc_launch<T, NX, true>(kc::filtering_combine_kernel<T, NX>, L, P,
                                in, lead, pair, out, s);
}

template <typename T, int NX>
int kc_launch_smoothing(long long L, long long P, const void* const* in,
                        const long long* lead, const long long* pair,
                        void* const* out, cudaStream_t s) {
  return kc_launch<T, NX, false>(kc::smoothing_combine_kernel<T, NX>, L, P,
                                 in, lead, pair, out, s);
}

#ifndef KC_NX_FIRST
#define KC_NX_FIRST 1
#define KC_NX_LAST 16
#define KC_ENTRY_POINTS
#endif
#define KC_OWNS(N) (KC_NX_FIRST <= (N) && (N) <= KC_NX_LAST)

#define KC_SIG                                                                \
  long long, long long, const void* const*, const long long*,                 \
      const long long*, void* const*, cudaStream_t
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
    return LAUNCH<T, N>(L, P, in, lead, pair, out, s);

template <typename T>
int dispatch_filtering(int nx, long long L, long long P, const void* const* in,
                       const long long* lead, const long long* pair,
                       void* const* out, cudaStream_t s) {
  switch (nx) {
    KC_CASES(kc_launch_filtering)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_smoothing(int nx, long long L, long long P, const void* const* in,
                       const long long* lead, const long long* pair,
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

// in: A_i, b_i, C_i, eta_i, J_i, A_j, b_j, C_j, eta_j, J_j; out: A, b, C,
// eta, J. lead[f] / pair[f]: strides of field f over the [L, P] grid.
int kc_filtering_combine(int dtype, int nx, long long L, long long P,
                         const void* const* in, const long long* lead,
                         const long long* pair, void* const* out,
                         void* stream) {
  if (L <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_filtering<float>(nx, L, P, in, lead, pair, out, s);
  if (dtype == 1)
    return dispatch_filtering<double>(nx, L, P, in, lead, pair, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// in: E_i, g_i, L_i, E_j, g_j, L_j; out: E, g, L.
int kc_smoothing_combine(int dtype, int nx, long long L, long long P,
                         const void* const* in, const long long* lead,
                         const long long* pair, void* const* out,
                         void* stream) {
  if (L <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_smoothing<float>(nx, L, P, in, lead, pair, out, s);
  if (dtype == 1)
    return dispatch_smoothing<double>(nx, L, P, in, lead, pair, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
#endif  // KC_ENTRY_POINTS
