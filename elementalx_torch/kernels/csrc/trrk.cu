// K2: the masked rank-k update.
//
//   C := alpha * A * B + beta * C   on one triangle of C (lower: column <=
//                                   row; upper: column >= row), in place;
//                                   the rest of C is not touched.
//
// A is M x K, B is K x N and C is M x N, each through its own strides, so
// Herk's op(A) and op(A)^H views are read in place. C may be rectangular:
// the triangle is the set of entries with column <= row (or >= row) of
// the M x N array, as in the JAX kernel.
//
// Replaces the TPU kernel elementalx/kernels/trrk.py:masked_rank_k (body
// _trrk_kernel). That kernel computes every (bm, bn) tile of the full
// product on the MXU and selects the triangle in its epilogue: on the MXU
// a full tile at full rate beats a ragged one. Here the product runs on
// FP32 (or FP64) FMA pipes, where a skipped tile is time saved, so the
// grid enumerates only the tiles that meet the triangle: for a square C
// that is about half of them, M*N*K FLOPs instead of 2*M*N*K. The tiles
// on the diagonal are computed whole and masked in the epilogue.
//
// Arithmetic, as the JAX kernel's epilogue (trrk.py:40-42): the product
// accumulates in float (double for double), is rounded to C's type, and
// the entry becomes alpha * prod + beta * c. C is always read on the
// triangle, so beta = 0 with a NaN in C gives NaN there, as in JAX.
//
// What bounds it: FP32 FMA throughput (the update at the Cholesky trailing
// shape, 15872^2 x 512, is about 1.3e11 FLOPs, 1.9 ms at 67 TFLOP/s). What
// it gives up: tensor cores, TMA, and a persistent schedule; it runs on the
// tile core of gemm_tile.cuh, so it has K1's rate.
#include "gemm_tile.cuh"

namespace {

enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };

// The tile columns [lo, hi] of tile row ti that meet the triangle.
template <typename Acc>
__host__ __device__ inline void tile_span(int ti, int lower, int ntn, int* lo,
                                          int* hi) {
  constexpr int BM = elx::Tile<Acc>::BM, BN = elx::Tile<Acc>::BN;
  const int m0 = ti * BM;
  if (lower) {
    *lo = 0;
    const int h = (m0 + BM - 1) / BN;
    *hi = h < ntn - 1 ? h : ntn - 1;
  } else {
    *lo = m0 / BN;
    *hi = ntn - 1;
  }
}

template <typename TIn, typename TOut, typename Acc>
__global__ void __launch_bounds__(elx::kGemmThreads)
    trrk_kernel(elx::GemmArgs g, int lower, int ntm, int ntn) {
  constexpr int BM = elx::Tile<Acc>::BM, BN = elx::Tile<Acc>::BN;
  __shared__ elx::TileSmem<Acc> sm;

  // this block's tile: the blockIdx.x-th of the triangle's tiles, row by row
  int t = blockIdx.x, ti = 0, lo = 0, hi = -1;
  for (; ti < ntm; ++ti) {
    tile_span<Acc>(ti, lower, ntn, &lo, &hi);
    const int cnt = hi >= lo ? hi - lo + 1 : 0;
    if (t < cnt) break;
    t -= cnt;
  }
  if (ti >= ntm) return;
  const int m0 = ti * BM, n0 = (lo + t) * BN;

  Acc acc[elx::Tile<Acc>::TM][elx::Tile<Acc>::TN];
  elx::tile_product<TIn, Acc>(g, static_cast<const TIn*>(g.A),
                              static_cast<const TIn*>(g.B), m0, n0, sm, acc);

  TOut* C = static_cast<TOut*>(g.C);
  const Acc alpha = static_cast<Acc>(g.alpha), beta = static_cast<Acc>(g.beta);
#pragma unroll
  for (int i = 0; i < elx::Tile<Acc>::TM; ++i) {
    const int r = m0 + elx::tile_row<Acc>(i);
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < elx::Tile<Acc>::TN; ++j) {
      const int c = n0 + elx::tile_col<Acc>(j);
      if (c >= g.N || (lower ? c > r : c < r)) continue;
      TOut* p = C + r * g.scm + c * g.scn;
      const Acc prod =
          elx::Cvt<TOut>::in(elx::Cvt<TOut>::out(acc[i][j]));  // in C's type
      *p = elx::Cvt<TOut>::out(alpha * prod + beta * elx::Cvt<TOut>::in(*p));
    }
  }
}

template <typename TIn, typename TOut, typename Acc>
cudaError_t launch(const elx::GemmArgs& g, int lower, cudaStream_t st) {
  if (g.M <= 0 || g.N <= 0) return cudaSuccess;
  const int ntm = (g.M + elx::Tile<Acc>::BM - 1) / elx::Tile<Acc>::BM;
  const int ntn = (g.N + elx::Tile<Acc>::BN - 1) / elx::Tile<Acc>::BN;
  long long tiles = 0;
  for (int ti = 0; ti < ntm; ++ti) {
    int lo = 0, hi = -1;
    tile_span<Acc>(ti, lower, ntn, &lo, &hi);
    if (hi >= lo) tiles += hi - lo + 1;
  }
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  trrk_kernel<TIn, TOut, Acc><<<static_cast<unsigned>(tiles),
                                elx::kGemmThreads, 0, st>>>(g, lower, ntm,
                                                            ntn);
  return cudaGetLastError();
}

}  // namespace

// C := alpha A B + beta C on the lower (lower != 0) or upper triangle of
// C, in place. dtype_in: 0 float, 1 double, 2 bfloat16 (A and B);
// dtype_out: C's type (bfloat16 inputs take a bfloat16 or float C).
extern "C" int elx_masked_rank_k(int dtype_in, int dtype_out, int lower,
                                 int M, int N, int K, const void* A,
                                 long long sam, long long sak, const void* B,
                                 long long sbk, long long sbn, void* C,
                                 long long scm, long long scn, double alpha,
                                 double beta, void* stream) {
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  const elx::GemmArgs g{M, N, K, A, sam, sak, 0, B, sbk, sbn, 0, C,
                        scm, scn, 0, alpha, beta, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_in == kF32 && dtype_out == kF32)
    return launch<float, float, float>(g, lower, s);
  if (dtype_in == kF64 && dtype_out == kF64)
    return launch<double, double, double>(g, lower, s);
  if (dtype_in == kBF16 && dtype_out == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(g, lower, s);
  if (dtype_in == kBF16 && dtype_out == kF32)
    return launch<__nv_bfloat16, float, float>(g, lower, s);
  return cudaErrorInvalidValue;
}
