// K3b and K3c: the fused Cholesky panel tail, in one launch.
//
//   out[r0 : r0 + w]      = L11 = chol(S)               (zeros above its
//                                                        diagonal)
//   out[r0 + w : rows]    = pan[r0 + w : rows] inv(L11)^T
//   out[0 : r0]           = 0
//
// for the symmetric (w, w) block S (lower triangle read) and a (rows, w)
// panel read through its strides. K3b is r0 = 0; K3c (the full-height
// column of the JAX package) passes the diagonal block's row offset r0 =
// kidx * w. Rows [r0, r0 + w) of the panel are never read: the symmetrized
// block is what the factor consumes. With low_apply, both operands of the
// L21 product are rounded to bfloat16 (nearest even) and the products are
// summed in float, as the JAX kernel's DEFAULT-precision dot does. A block
// that is not numerically positive definite (a pivot that is not > 0, or
// a NaN) poisons every row from r0 on with NaN; rows above r0 stay zero.
//
// Replaces the TPU kernels elementalx/kernels/potrf.py:potrf_panel_tail
// (body _potrf_kernel) and potrf_panel_tail_full (body _potrf_kernel_full),
// which share _factor_block and _apply_dot. The TPU kernel factors the
// whole block in VMEM in a transposed layout on grid step 0 and streams
// one (w, w) tile of the panel per later step through one MXU product.
// Hopper runs blocks in parallel, not in order, so the apply cannot simply
// follow the factor in grid order; what can follow it is each column
// block of L21, which needs only the matching row-block of inv(L11).
//
// Two routes, picked by kernels/potrf.py:route from w and the dtype:
//
// Route "cluster" (w <= 512 float32, w <= 384 float64; this design): one
// launch of clusters of nt = ceil(w / 32) CTAs (potrf.cu's chol_kernel,
// one instantiation shared with K3a, so L11 is K3a's bit for bit). The
// first cluster to start (an atomic ticket) runs K3a's factor on chip and
// stores row-block j of X = inv(L11) (as invlh = X^T) after step j,
// publishing j + 1 steps with a release store; it never waits for another
// cluster. Every CTA of the other clusters, and the factor's CTAs once
// the factor is done, takes strips of 64 rows (32 in float64) of pan21
// from an atomic counter, holds a strip transposed in shared memory
// (cp.async), and forms column block j of L21 = sum_{m <= j} pan21[:, m]
// X[j, m]^T as soon as step j is published (an acquire spin that traps
// after about 10 s), a thread a 4 x 2 block (2 x 2 in float64), one FMA
// chain over ascending k a value. The grid holds no more clusters than
// the card runs at once. So the product, 8.3 GFLOP at (16384, 512) as a
// dense one and half of it on X's triangle, follows the factor's chain
// instead of waiting for it: the route is bounded by the larger of the
// chain (K3a's) and the product on the card's FP32 FMAs (about 0.06 ms
// at 67 TFLOP/s; the 64 x 32 blocks run at about half of it, bound by
// shared-memory reads, and the strips a CTA takes during the chain wait
// for its steps).
//
// Route "blocked" (wider blocks: GenDefEig's (8192, 2048)): K3a's blocked
// route for (L11, invlh) (potrf.cu), then L21 = pan21 invlh as one product
// on K1's cp.async pipeline (float32 operands with a unit stride each) or
// its FMA core (float64, low_apply, other strides).
#include <type_traits>

#include "gemm_f32_pipe.cuh"
#include "gemm_tile.cuh"
#include "potrf_cluster.cuh"

namespace {

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
cudaError_t panel_tail(int route, int rows, int w, int r0, int low_apply,
                       const T* sym, long long lds, const T* pan,
                       long long sp0, long long sp1, T* out, T* ws,
                       int* flags, cudaStream_t st) {
  if (route == 1) {
    T* invlh = ws + elx::chol::kExchange;  // (w, w)
    const elx::chol::Call<T> c{w,   rows, r0,  low_apply, 0,     sym,
                               lds, pan,  sp0, sp1,       out,   w,
                               invlh, w,  flags, ws};
    return elx::chol::cluster_call(c, st);
  }
  if (route != 2) return cudaErrorInvalidValue;
  // the blocked route's own scratch, then inv(L11)^T
  T* invlh = ws + elx::chol::kExchange +
             2LL * w * elx::chol::kClusterMaxW<T>;
  ELX_RETURN_IF_ERROR(elx::chol::blocked_call(
      w, sym, lds, out + static_cast<long long>(r0) * w, w, invlh, w, ws,
      flags, st));
  if (r0 > 0)
    ELX_RETURN_IF_ERROR(cudaMemsetAsync(
        out, 0, static_cast<size_t>(r0) * w * sizeof(T), st));
  const int below = rows - r0 - w;
  if (below <= 0) return cudaSuccess;
  const long long first = static_cast<long long>(r0) + w;
  const elx::GemmArgs apply{below, w, w, pan + first * sp0, sp0, sp1, 0,
                            invlh, w, 1, 0, out + first * w, w, 1, 0,
                            1.0, 0.0, 0};
  if constexpr (std::is_same<T, float>::value) {
    if (low_apply) return elx::launch_gemm<T, T, T, true>(apply, 1, st);
    if (elx::pipe::unit_strides(apply))
      return elx::pipe::launch_any<3>(apply, st);
  }
  return elx::launch_gemm<T, T, T>(apply, 1, st);
}

}  // namespace

// route: 1 "cluster", 2 "blocked" (0, the retired first design, and any
// other code return cudaErrorInvalidValue); dtype: 0 float, 1 double
// (low_apply only with float). sym: (w, w), row stride lds, unit column
// stride; pan: (rows, w) with strides sp0, sp1; out: (rows, w) contiguous.
// ws and flags as kernels/potrf.py:workspace sizes them for the route
// (zeroed flags before the first call of the cluster and blocked routes;
// they are left zero). Needs r0 + w <= rows.
extern "C" int elx_potrf_panel_tail(int route, int dtype, int rows, int w,
                                    int r0, int low_apply, const void* sym,
                                    long long lds, const void* pan,
                                    long long sp0, long long sp1, void* out,
                                    void* ws, void* flags, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(flags);
  if (w <= 0 || r0 < 0 || r0 + w > rows || (low_apply && dtype != 0))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return panel_tail<float>(route, rows, w, r0, low_apply,
                             static_cast<const float*>(sym), lds,
                             static_cast<const float*>(pan), sp0, sp1,
                             static_cast<float*>(out),
                             static_cast<float*>(ws), f, st);
  if (dtype == 1)
    return panel_tail<double>(route, rows, w, r0, 0,
                              static_cast<const double*>(sym), lds,
                              static_cast<const double*>(pan), sp0, sp1,
                              static_cast<double*>(out),
                              static_cast<double*>(ws), f, st);
  return cudaErrorInvalidValue;
}
