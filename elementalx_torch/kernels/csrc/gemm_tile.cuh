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
// static shared memory.
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

template <typename TIn, typename TOut, typename Acc>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN, BK = Tile<Acc>::BK;
  constexpr int TM = Tile<Acc>::TM, TN = Tile<Acc>::TN;
  constexpr int TH = TM / 2, TW = TN / 2;
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(NT == kGemmThreads, "tile shape must give 256 threads");
  static_assert(TH * sizeof(Acc) == 16 && TW * sizeof(Acc) == 16,
                "register half-blocks are one 16-byte vector");
  constexpr int PAD = 16 / sizeof(Acc);  // keeps every row 16-byte aligned
  constexpr int LA = BM * BK / NT, LB = BK * BN / NT;
  __shared__ __align__(16) Acc As[2][BK][BM + PAD];
  __shared__ __align__(16) Acc Bs[2][BK][BN + PAD];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (g.lower_only && n0 > m0 + BM - 1) return;  // tile wholly above diagonal
  const long long z = blockIdx.z;
  const TIn* A = static_cast<const TIn*>(g.A) + z * g.sab;
  const TIn* B = static_cast<const TIn*>(g.B) + z * g.sbb;
  TOut* C = static_cast<TOut*>(g.C) + z * g.scb;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const bool a_kfast = g.sak <= g.sam;  // consecutive threads walk k
  const bool b_nfast = g.sbn <= g.sbk;  // consecutive threads walk n

  Acc ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT;
      const int mm = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < g.M && gk < g.K) ? Cvt<TIn>::in(A[gm * g.sam + gk * g.sak])
                                     : Acc(0);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      const int gn = n0 + nn, gk = k0 + kk;
      rb[i] = (gn < g.N && gk < g.K) ? Cvt<TIn>::in(B[gk * g.sbk + gn * g.sbn])
                                     : Acc(0);
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + i * NT;
      const int mm = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      As[s][kk][mm] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      Bs[s][kk][nn] = rb[i];
    }
  };

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

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
      lds16(a, &As[s][k][ty * TH]);
      lds16(a + TH, &As[s][k][BM / 2 + ty * TH]);
      lds16(b, &Bs[s][k][tx * TW]);
      lds16(b + TW, &Bs[s][k][BN / 2 + tx * TW]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    // The other stage was last read before the previous barrier.
    if (t + 1 < nk) stash(s ^ 1);
    __syncthreads();
  }

  const Acc alpha = static_cast<Acc>(g.alpha), beta = static_cast<Acc>(g.beta);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i < TH ? ty * TH + i : BM / 2 + ty * TH + (i - TH));
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + (j < TW ? tx * TW + j : BN / 2 + tx * TW + (j - TW));
      if (c >= g.N || (g.lower_only && c > r)) continue;
      TOut* p = C + r * g.scm + c * g.scn;
      Acc v = alpha * acc[i][j];
      if (beta != Acc(0)) v += beta * Cvt<TOut>::in(*p);
      *p = Cvt<TOut>::out(v);
    }
  }
}

template <typename TIn, typename TOut, typename Acc>
cudaError_t launch_gemm(const GemmArgs& g, int batch, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0 || batch <= 0) return cudaSuccess;
  const dim3 grid((g.M + Tile<Acc>::BM - 1) / Tile<Acc>::BM,
                  (g.N + Tile<Acc>::BN - 1) / Tile<Acc>::BN, batch);
  gemm_kernel<TIn, TOut, Acc><<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace elx
