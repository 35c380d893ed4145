// The Cholesky block on one thread-block cluster, shared by K3a
// (potrf.cu, which holds its device code and host launches) and K3b/K3c
// (potrf_tail.cu, which calls them). One instantiation serves both, so
// K3b's L11 is K3a's bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace elx {
namespace chol {

// Widest diagonal block the cluster route holds on chip: one CTA a
// 32-row block, at most 16 CTAs, each holding its row of the factor, its
// column of the inverse and a copy of the step's column panel in shared
// memory (float64 from 416 on needs more than an SM's 227 KB).
template <typename T>
constexpr int kClusterMaxW = sizeof(T) == 4 ? 512 : 384;

// One call of the cluster kernel: the factor of the symmetric (w, w)
// block S (lower triangle read) and, below it, L21 = pan21 inv(L11)^T.
//
//   out[(r0 + i) * ldo + j]  = L11[i][j]        i, j < w (zeros above)
//   invlh[i * ldx + j]       = inv(L11)^T[i][j]  (zeros below)
//   out[(r0 + w + i) * ldo + j] = sum_m pan[r0 + w + i][m] invlh[m][j]
//   out rows [0, r0)         = 0
//
// pan is read from row r0 + w on, through strides sp0, sp1. low rounds
// both operands of the L21 product to bfloat16. sync: five ints, zero
// before the first call (ticket, published steps, finished CTAs, the
// not-positive-definite flag, the next apply strip); the kernel leaves
// them zero, the flag only unless sticky.
template <typename T>
struct Call {
  int w, rows, r0, low, sticky;
  const T* sym;
  long long lds;
  const T* pan;
  long long sp0, sp1;
  T* out;
  long long ldo;
  T* invlh;
  long long ldx;
  int* sync;
  T* xch;  // kExchange elements, 16-byte aligned: the factor CTAs' tiles
};

// Elements of the exchange scratch: 17 contiguous 32 x 32 tiles (the
// step's column panel and X_kk^T), first in every workspace of the
// cluster and blocked routes.
constexpr int kExchange = 17 * 32 * 32;

// One launch of the cluster kernel (w <= kClusterMaxW<T>).
template <typename T>
cudaError_t cluster_call(const Call<T>& c, cudaStream_t st);

// K3a's blocked route: (l11, invlh) of any w, left-looking over diagonal
// blocks of kClusterMaxW<T>. ws holds kExchange + 2 w kClusterMaxW<T>
// elements (16-byte aligned); sync as above.
template <typename T>
cudaError_t blocked_call(int w, const T* sym, long long lds, T* l11,
                         long long ldl, T* invlh, long long ldx, T* ws,
                         int* sync, cudaStream_t st);

}  // namespace chol
}  // namespace elx
