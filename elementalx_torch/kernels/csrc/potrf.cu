// K3a: Cholesky factor and transposed inverse of one diagonal block.
//
//   (l11, invlh) = (chol(S), inv(chol(S))^T)   for a symmetric (w, w) S
//
// Only the lower triangle of S is read. l11 has exact zeros above its
// diagonal and invlh exact zeros below. A block that is not numerically
// positive definite (a pivot that is not > 0, or a NaN) poisons both
// outputs with NaN, so the driver's NaN check reports it.
//
// Replaces the TPU kernel elementalx/kernels/potrf.py:potrf_block_inv
// (body _potrf_diag_kernel, using _factor_block and
// getrf._inv_unit_upper). That design keeps the whole block in VMEM (up to
// 32 MB) in a transposed "columns as sublanes" layout with 8/128 group
// blocking. A Hopper SM has 227 KB of shared memory: a 512^2 float block is
// 1 MB and the 2048^2 default panel 16 MB, so the block stays in global
// memory (it lives in the 50 MB L2 while it is worked on).
//
// What bounds it: the chain of dependent steps, not FLOPs or bytes. The
// factorization is blocked right-looking with 32-wide steps; each step is
// three launches in stream order:
//   potf2      one CTA factors the 32x32 diagonal block in shared memory
//              and inverts it (the only place a column-by-column chain runs);
//   trsm_rows  L21 = A21 * inv(L11)^T, one warp per row, in place;
//   gemm       A22 -= L21 * L21^T on lower tiles only (gemm_tile.cuh).
// The inverse of the whole factor then doubles the block size each level:
//   inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]
// as two batched GEMMs per level over all pairs of a level at once. The
// order is padded to W = 32 * 2^p with an identity on the padding
// diagonal, so every level is uniform; a finishing kernel writes the
// (w, w) corner, transposing the inverse through shared memory.
//
// What it gives up: w/32 * 3 launches of small, sequential work (about 50
// at w = 512) whose latency dominates; the padding to a power of two (up
// to 4x the work for an awkward w); no fusion of the steps into one
// persistent kernel.
#include <cstdint>

#include "gemm_tile.cuh"

namespace {

constexpr int kNB = 32;  // width of one factorization step: one warp

template <typename T>
__device__ __forceinline__ T qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fffffff);
}
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// work <- lower(S) on [0, w)^2, identity on the padding diagonal, zeros
// elsewhere; xinv <- 0; flag <- 0.
template <typename T>
__global__ void init_kernel(const T* sym, long long lds, T* work, T* xinv,
                            int* flag, int w, int W) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
  const long long total = static_cast<long long>(W) * W;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e / W), j = static_cast<int>(e % W);
    T v = T(0);
    if (i < w && j < w) {
      if (j <= i) v = sym[i * lds + j];
    } else if (i == j) {
      v = T(1);
    }
    work[e] = v;
    xinv[e] = T(0);
  }
}

// Factor the 32x32 diagonal block at (k, k) of work in shared memory,
// write L_kk (zeros above its diagonal) back, and write inv(L_kk) into the
// same block of xinv. One thread per entry.
template <typename T>
__global__ void __launch_bounds__(kNB* kNB)
    potf2_kernel(T* work, T* xinv, int W, int k, int* flag) {
  __shared__ T s[kNB][kNB + 1];
  __shared__ T x[kNB][kNB + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // column, row
  T* blk = work + static_cast<long long>(k) * W + k;
  s[ty][tx] = tx <= ty ? blk[static_cast<long long>(ty) * W + tx] : T(0);
  __syncthreads();
  for (int j = 0; j < kNB; ++j) {
    const T d = s[j][j];
    __syncthreads();  // every thread holds the pivot before it is replaced
    if (tx == 0 && ty == 0 && !(d > T(0))) *flag = 1;
    const T r = sqrt(d);
    if (tx == j && ty >= j) s[ty][j] = ty == j ? r : s[ty][j] / r;
    __syncthreads();
    if (tx > j && ty >= tx) s[ty][tx] -= s[ty][j] * s[tx][j];
    __syncthreads();
  }
  // inv(L_kk) by forward substitution, lane c of warp 0 owning column c.
  if (ty == 0) {
    const int c = tx;
    for (int i = 0; i < kNB; ++i) {
      T v = T(0);
      if (i >= c) {
        T sum = i == c ? T(1) : T(0);
        for (int q = c; q < i; ++q) sum -= s[i][q] * x[q][c];
        v = sum / s[i][i];
      }
      x[i][c] = v;
    }
  }
  __syncthreads();
  blk[static_cast<long long>(ty) * W + tx] = tx <= ty ? s[ty][tx] : T(0);
  xinv[static_cast<long long>(k + ty) * W + k + tx] = x[ty][tx];
}

// Rows below the diagonal block: A21 <- A21 * inv(L_kk)^T, in place. Each
// warp loads one row (one element per lane) before it writes it back.
template <typename T>
__global__ void trsm_rows_kernel(T* work, const T* xinv, int W, int k) {
  __shared__ T D[kNB][kNB + 1];
  for (int e = threadIdx.x; e < kNB * kNB; e += blockDim.x)
    D[e / kNB][e % kNB] =
        xinv[static_cast<long long>(k + e / kNB) * W + k + e % kNB];
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int r = k + kNB + blockIdx.x * nwarps + warp; r < W;
       r += gridDim.x * nwarps) {
    T* row = work + static_cast<long long>(r) * W + k;
    const T a = row[lane];
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
      acc += __shfl_sync(0xffffffffu, a, j) * D[lane][j];
    row[lane] = acc;
  }
}

// l11 <- work[:w, :w]; invlh <- xinv[:w, :w]^T through a shared-memory
// tile; both NaN when flag is set.
template <typename T>
__global__ void finalize_kernel(const T* work, const T* xinv, T* l11,
                                T* invlh, const int* flag, int w, int W) {
  __shared__ T tile[32][33];
  const bool bad = *flag != 0;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int yy = threadIdx.y; yy < 32; yy += blockDim.y) {
    const int i = r0 + yy, j = c0 + threadIdx.x;
    if (i < w && j < w)
      l11[static_cast<long long>(i) * w + j] =
          bad ? qnan<T>() : work[static_cast<long long>(i) * W + j];
    const int xi = c0 + yy, xj = r0 + threadIdx.x;  // transposed read
    tile[yy][threadIdx.x] =
        xi < W && xj < W ? xinv[static_cast<long long>(xi) * W + xj] : T(0);
  }
  __syncthreads();
  for (int yy = threadIdx.y; yy < 32; yy += blockDim.y) {
    const int i = r0 + yy, j = c0 + threadIdx.x;
    if (i < w && j < w)
      invlh[static_cast<long long>(i) * w + j] =
          bad ? qnan<T>() : tile[threadIdx.x][yy];
  }
}

#define ELX_RETURN_IF_ERROR(expr)            \
  do {                                       \
    const cudaError_t e_ = (expr);           \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

template <typename T>
cudaError_t potrf_block_inv(int w, int W, const T* sym, long long lds, T* l11,
                            T* invlh, T* work, T* xinv, T* tmp, int* flag,
                            cudaStream_t st) {
  const long long total = static_cast<long long>(W) * W;
  const int init_blocks = static_cast<int>(
      total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  init_kernel<T><<<init_blocks, 256, 0, st>>>(sym, lds, work, xinv, flag, w, W);
  ELX_RETURN_IF_ERROR(cudaGetLastError());

  for (int k = 0; k < W; k += kNB) {
    potf2_kernel<T><<<1, dim3(kNB, kNB), 0, st>>>(work, xinv, W, k, flag);
    ELX_RETURN_IF_ERROR(cudaGetLastError());
    const int rows = W - k - kNB;
    if (rows <= 0) continue;
    const int tb = (rows + 7) / 8 < 1024 ? (rows + 7) / 8 : 1024;
    trsm_rows_kernel<T><<<tb, 256, 0, st>>>(work, xinv, W, k);
    ELX_RETURN_IF_ERROR(cudaGetLastError());
    T* l21 = work + static_cast<long long>(k + kNB) * W + k;
    const elx::GemmArgs syrk{rows, rows, kNB, l21, W, 1, 0, l21, 1, W, 0,
                             l21 + kNB, W, 1, 0, -1.0, 1.0, 1};
    ELX_RETURN_IF_ERROR((elx::launch_gemm<T, T, T>(syrk, 1, st)));
  }

  // Doubling inverse: for each pair (A at a0 = 2ts, C at c0 = a0 + s),
  //   tmp_t = L[c0, a0] * X[a0, a0];   X[c0, a0] = -X[c0, c0] * tmp_t.
  for (long long s = kNB; s < W; s *= 2) {
    const int npair = static_cast<int>(W / (2 * s));
    const long long diag = 2 * s * (W + 1);  // from one pair to the next
    const elx::GemmArgs left{static_cast<int>(s), static_cast<int>(s),
                             static_cast<int>(s), work + s * W, W, 1, diag,
                             xinv, W, 1, diag, tmp, s, 1, s * s,
                             1.0, 0.0, 0};
    ELX_RETURN_IF_ERROR((elx::launch_gemm<T, T, T>(left, npair, st)));
    const elx::GemmArgs right{static_cast<int>(s), static_cast<int>(s),
                              static_cast<int>(s), xinv + s * W + s, W, 1,
                              diag, tmp, s, 1, s * s, xinv + s * W, W, 1,
                              diag, -1.0, 0.0, 0};
    ELX_RETURN_IF_ERROR((elx::launch_gemm<T, T, T>(right, npair, st)));
  }

  const dim3 fgrid((w + 31) / 32, (w + 31) / 32);
  finalize_kernel<T><<<fgrid, dim3(32, 8), 0, st>>>(work, xinv, l11, invlh,
                                                    flag, w, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float, 1 double. work and xinv hold W*W elements, tmp W*W/4,
// flag one int; sym is read with row stride lds and unit column stride.
extern "C" int elx_potrf_block_inv(int dtype, int w, int W, const void* sym,
                                   long long lds, void* l11, void* invlh,
                                   void* work, void* xinv, void* tmp,
                                   void* flag, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(flag);
  if (w <= 0 || W < w || W % kNB != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return potrf_block_inv<float>(
        w, W, static_cast<const float*>(sym), lds, static_cast<float*>(l11),
        static_cast<float*>(invlh), static_cast<float*>(work),
        static_cast<float*>(xinv), static_cast<float*>(tmp), f, st);
  if (dtype == 1)
    return potrf_block_inv<double>(
        w, W, static_cast<const double*>(sym), lds, static_cast<double*>(l11),
        static_cast<double*>(invlh), static_cast<double*>(work),
        static_cast<double*>(xinv), static_cast<double*>(tmp), f, st);
  return cudaErrorInvalidValue;
}
