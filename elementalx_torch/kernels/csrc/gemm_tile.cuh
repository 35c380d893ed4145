// Tiled, register-blocked FMA GEMM shared by the port's kernels.
//
//   C[z] = alpha * A[z] * B[z] + beta * C[z]      for z in [0, batch)
//
// Every operand is addressed through its own row and column strides (in
// elements), so transposed views, slices of a larger buffer and
// diagonal-block batches need no copy. The edges of ragged shapes are
// masked here. With ``lower_only`` the kernel writes only entries with
// column <= row and skips tiles that lie wholly above the diagonal (the
// rank-k update of a Cholesky trailing block).
//
// Arithmetic is plain FMA in the accumulator type: float for float and
// bfloat16 inputs, double for double. No tensor cores, so float keeps full
// FP32 accuracy (no TF32).
//
// Design: one CTA computes a BM x BN tile of C with 256 threads, each
// owning a TM x TN register block split into two halves BM/2 apart (so the
// warp's shared-memory reads are 16-byte vectors on consecutive
// addresses). K advances BK at a time through two shared-memory stages:
// the next stage is fetched into registers while the current one feeds the
// FMAs. Global loads pick the thread-to-element mapping whose fast index is
// the operand's unit stride, so row- and column-major operands both load
// in full 32-byte sectors.
//
// The tile core (tile_product) and the epilogue (tile_store) are device
// functions, so that kernels which walk their own list of tiles (the
// masked rank-k update of trrk.cu, the persistent panel tail of
// potrf_tail.cu) run the same arithmetic as gemm_kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace elx {
namespace {

struct GemmArgs {
  int M, N, K;
  const void* A;
  long long sam, sak, sab;  // row, column and batch strides of A (M x K)
  const void* B;
  long long sbk, sbn, sbb;  // row, column and batch strides of B (K x N)
  void* C;
  long long scm, scn, scb;  // row, column and batch strides of C (M x N)
  double alpha, beta;
  int lower_only;
};

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
};
template <>
struct Cvt<double> {
  __device__ static double in(double x) { return x; }
  __device__ static double out(double x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// Tile shape per accumulator type; both give 256 threads and ~17 KB of
// shared memory.
template <typename Acc>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
};
template <>
struct Tile<double> {
  static constexpr int BM = 64, BN = 64, BK = 8, TM = 4, TN = 4;
};
constexpr int kGemmThreads = 256;

// The two shared-memory stages of one tile.
template <typename Acc>
struct TileSmem {
  static constexpr int PAD = 16 / sizeof(Acc);  // keeps rows 16-byte aligned
  __align__(16) Acc As[2][Tile<Acc>::BK][Tile<Acc>::BM + PAD];
  __align__(16) Acc Bs[2][Tile<Acc>::BK][Tile<Acc>::BN + PAD];
};

// One 16-byte shared-memory load into registers (TM/2 values).
__device__ __forceinline__ void lds16(float* r, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}
__device__ __forceinline__ void lds16(double* r, const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}

// A global load; kL2Only reads through L2 only (ld.global.cg), for data
// that other blocks of a persistent kernel wrote in an earlier phase.
template <bool kL2Only, typename T>
__device__ __forceinline__ T ldg(const T* p) {
  if constexpr (kL2Only) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Row and column, within the tile, of entry (i, j) of this thread's
// register block. kBM: the tile's height (gemm_f32_pipe.cuh also runs
// 64-row tiles), with the same thread rows, so kTileTM<Acc, kBM> rows a
// thread.
template <typename Acc, int kBM = Tile<Acc>::BM>
constexpr int kTileTM = kBM * Tile<Acc>::TM / Tile<Acc>::BM;
template <typename Acc, int kBM = Tile<Acc>::BM>
__device__ __forceinline__ int tile_row(int i) {
  constexpr int TH = kTileTM<Acc, kBM> / 2;
  const int ty = threadIdx.x / (Tile<Acc>::BN / Tile<Acc>::TN);
  return i < TH ? ty * TH + i : kBM / 2 + ty * TH + (i - TH);
}
template <typename Acc>
__device__ __forceinline__ int tile_col(int j) {
  constexpr int TW = Tile<Acc>::TN / 2;
  const int tx = threadIdx.x % (Tile<Acc>::BN / Tile<Acc>::TN);
  return j < TW ? tx * TW + j : Tile<Acc>::BN / 2 + tx * TW + (j - TW);
}

// acc = A[m0:m0+BM, 0:K] * B[0:K, n0:n0+BN] (entries outside the operands
// count as zero). A and B point at this batch entry's operands; g gives
// M, N, K and the strides. kRoundBF16 rounds every operand to bfloat16
// (nearest even) as it is loaded, so the FMAs multiply bfloat16 values and
// sum in the accumulator type. kAccumulate adds the product to acc instead
// of overwriting it (a k-loop split over several operand pairs, as K8's
// ring walks its holders). Block-uniform: every thread of the block must
// call it. On return the shared memory is free for reuse.
template <typename TIn, typename Acc, bool kRoundBF16 = false,
          bool kL2Only = false, bool kAccumulate = false>
__device__ __forceinline__ void tile_product(
    const GemmArgs& g, const TIn* A, const TIn* B, int m0, int n0,
    TileSmem<Acc>& sm, Acc (&acc)[Tile<Acc>::TM][Tile<Acc>::TN]) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN, BK = Tile<Acc>::BK;
  constexpr int TM = Tile<Acc>::TM, TN = Tile<Acc>::TN;
  constexpr int TH = TM / 2, TW = TN / 2;
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(NT == kGemmThreads, "tile shape must give 256 threads");
  static_assert(TH * sizeof(Acc) == 16 && TW * sizeof(Acc) == 16,
                "register half-blocks are one 16-byte vector");
  constexpr int LA = BM * BK / NT, LB = BK * BN / NT;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const bool a_kfast = g.sak <= g.sam;  // consecutive threads walk k
  const bool b_nfast = g.sbn <= g.sbk;  // consecutive threads walk n

  auto load = [](const TIn* p) -> Acc {
    Acc x = Cvt<TIn>::in(ldg<kL2Only>(p));
    if constexpr (kRoundBF16) x = __bfloat162float(__float2bfloat16_rn(x));
    return x;
  };

  Acc ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT;
      const int mm = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < g.M && gk < g.K) ? load(A + gm * g.sam + gk * g.sak)
                                     : Acc(0);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      const int gn = n0 + nn, gk = k0 + kk;
      rb[i] = (gn < g.N && gk < g.K) ? load(B + gk * g.sbk + gn * g.sbn)
                                     : Acc(0);
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT;
      const int mm = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      sm.As[s][kk][mm] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      sm.Bs[s][kk][nn] = rb[i];
    }
  };

  if constexpr (!kAccumulate) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  }

  const int nk = (g.K + BK - 1) / BK;
  if (nk > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    if (t + 1 < nk) fetch((t + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      Acc a[TM], b[TN];
      lds16(a, &sm.As[s][k][ty * TH]);
      lds16(a + TH, &sm.As[s][k][BM / 2 + ty * TH]);
      lds16(b, &sm.Bs[s][k][tx * TW]);
      lds16(b + TW, &sm.Bs[s][k][BN / 2 + tx * TW]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    // The other stage was last read before the previous barrier.
    if (t + 1 < nk) stash(s ^ 1);
    __syncthreads();
  }
}

// C[m0:, n0:] = alpha * acc + beta * C on the tile (C read only when beta
// is not 0), within M x N and, with g.lower_only, on column <= row; kBM
// as in tile_row.
template <typename TOut, typename Acc, bool kL2Only = false,
          int kBM = Tile<Acc>::BM>
__device__ __forceinline__ void tile_store(
    const GemmArgs& g, TOut* C, int m0, int n0,
    const Acc (&acc)[kTileTM<Acc, kBM>][Tile<Acc>::TN]) {
  const Acc alpha = static_cast<Acc>(g.alpha), beta = static_cast<Acc>(g.beta);
#pragma unroll
  for (int i = 0; i < kTileTM<Acc, kBM>; ++i) {
    const int r = m0 + tile_row<Acc, kBM>(i);
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < Tile<Acc>::TN; ++j) {
      const int c = n0 + tile_col<Acc>(j);
      if (c >= g.N || (g.lower_only && c > r)) continue;
      TOut* p = C + r * g.scm + c * g.scn;
      Acc v = alpha * acc[i][j];
      if (beta != Acc(0)) v += beta * Cvt<TOut>::in(ldg<kL2Only>(p));
      *p = Cvt<TOut>::out(v);
    }
  }
}

template <typename TIn, typename TOut, typename Acc, bool kRoundBF16 = false>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN;
  __shared__ TileSmem<Acc> sm;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (g.lower_only && n0 > m0 + BM - 1) return;  // tile wholly above diagonal
  const long long z = blockIdx.z;
  const TIn* A = static_cast<const TIn*>(g.A) + z * g.sab;
  const TIn* B = static_cast<const TIn*>(g.B) + z * g.sbb;
  TOut* C = static_cast<TOut*>(g.C) + z * g.scb;

  Acc acc[Tile<Acc>::TM][Tile<Acc>::TN];
  tile_product<TIn, Acc, kRoundBF16>(g, A, B, m0, n0, sm, acc);
  tile_store<TOut, Acc>(g, C, m0, n0, acc);
}

// kRoundBF16 as in tile_product.
template <typename TIn, typename TOut, typename Acc, bool kRoundBF16 = false>
cudaError_t launch_gemm(const GemmArgs& g, int batch, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0 || batch <= 0) return cudaSuccess;
  const dim3 grid((g.M + Tile<Acc>::BM - 1) / Tile<Acc>::BM,
                  (g.N + Tile<Acc>::BN - 1) / Tile<Acc>::BN, batch);
  gemm_kernel<TIn, TOut, Acc, kRoundBF16>
      <<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace elx
