// The symv unit shared by K5 (latrd.cu) and K7 (symv.cu).
//
// A unit is rows [rs, re) x columns [cb, cb + kSymvUW) of the lower
// triangle of a symmetric matrix A (row stride lda, unit column stride).
// It adds the unit's share of y = H v, H = tril(A) + tril(A, -1)^T, into a
// block's partial y: A[r, c] v[c] into yp[r] for c <= r (row sums) and
// A[r, c] v[r] into yp[c] for c < r (column sums). Entries with c > r are
// never read.
//
// Each of the kSymvThreads threads owns kSymvCPT columns of the unit, 1 KB
// apart in a row. Column sums stay in registers; row sums are reduced
// across a warp by a butterfly reduce-scatter and across the block through
// shared memory. Every sum has a fixed order, so the same inputs give the
// same bits.
//
// v is read through an accessor, v(r) for 0 <= r < n: K7 reads a vector,
// K5 forms its Householder vector on the fly.
#pragma once

#include <cuda_runtime.h>

namespace elx {
namespace {

constexpr int kSymvThreads = 256;                  // threads of a block
constexpr int kSymvWarps = kSymvThreads / 32;
constexpr int kSymvR = 32;                         // rows of a unit
constexpr int kSymvCPT = 4;                        // columns per thread
constexpr int kSymvUW = kSymvThreads * kSymvCPT;   // columns of a unit

// Needs blockDim.x == kSymvThreads, re - rs <= kSymvR, re <= n, and shared
// svr[kSymvR], srow[kSymvWarps][kSymvR] (reused from unit to unit).
template <typename T, typename VecAt>
__device__ void symv_unit(const T* a, long long lda, int n, const VecAt& v,
                          int rs, int re, int cb, T* yp, T* svr,
                          T (*srow)[kSymvR]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  __syncthreads();  // svr / srow reuse
  if (tid < kSymvR) svr[tid] = rs + tid < re ? v(rs + tid) : T(0);
  __syncthreads();
  T vc[kSymvCPT], colacc[kSymvCPT], rowacc[kSymvR];
#pragma unroll
  for (int k = 0; k < kSymvCPT; ++k) {
    const int c = cb + k * kSymvThreads + tid;
    vc[k] = c < n ? v(c) : T(0);
    colacc[k] = T(0);
  }
#pragma unroll
  for (int i = 0; i < kSymvR; ++i) {
    rowacc[i] = T(0);
    const int r = rs + i;
    if (r < re) {
      const T* arow = a + static_cast<long long>(r) * lda;
      const T vr = svr[i];
#pragma unroll
      for (int k = 0; k < kSymvCPT; ++k) {
        const int c = cb + k * kSymvThreads + tid;
        if (c <= r) {
          const T x = arow[c];
          rowacc[i] += x * vc[k];
          if (c < r) colacc[k] += x * vr;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSymvCPT; ++k) {
    const int c = cb + k * kSymvThreads + tid;
    if (c < re) yp[c] += colacc[k];
  }
  // butterfly reduce-scatter over the warp: lane i ends with row i's sum
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const T send = upper ? rowacc[i] : rowacc[i + o];
      const T keep = upper ? rowacc[i + o] : rowacc[i];
      rowacc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  srow[warp][lane] = rowacc[0];
  __syncthreads();  // also orders the column writes before the row writes
  if (tid < kSymvR && rs + tid < re) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < kSymvWarps; ++k) s += srow[k][tid];
    yp[rs + tid] += s;
  }
}

}  // namespace
}  // namespace elx
