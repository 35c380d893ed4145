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
// 1 MB, but a thread-block cluster of 16 SMs holds it with room to spare.
//
// What bounds it: the chain of dependent 32-wide steps, not FLOPs or
// bytes (w^3 / 3 FMAs: 0.0013 ms at w = 512 on 67 TFLOP/s). Two routes,
// picked by kernels/potrf.py:route from w and the dtype alone:
//
// Route "cluster" (w <= 512 float32, w <= 384 float64; this design): one
// launch of one cluster of nt = ceil(w / 32) CTAs. CTA q owns row-block q
// of L (its q + 1 tiles, kept transposed) and column-block q of
// X = inv(L) (its nt - q tiles, row-major), both in shared memory, plus
// room for the step's column panel and X_kk^T: 2 nt + 2 tiles of 32 x 36
// floats (153 KB) a CTA at w = 512. Step k:
//   A (look-ahead, in the previous step's phase C): the owner of row-block
//      k has updated its diagonal tile first; one warp factors it in
//      registers (lane i row i, shuffles, a reciprocal square root a
//      column) and inverts it (lane c column c of X_kk), and the CTA
//      writes X_kk^T to a tile of the exchange in global memory (L2);
//   cluster barrier 1;
//   B  every CTA but the owner reads X_kk^T back; every CTA q > k forms
//      L_qk = A_qk X_kk^T and writes L_qk^T to exchange tile q; every CTA
//      q < k forms X_kq = X_kk B_kq (B_kq = -sum_{m<k} L_km X_mq,
//      accumulated by the updates below);
//   cluster barrier 2;
//   C  the step's finished tiles go to global memory (L_qk, X_kq), each
//      CTA reads the panel tiles it needs from the exchange, then every
//      CTA q > k updates its trailing tiles A_qj -= L_qk L_jk^T, j in
//      (k, q] (the owner of row-block k + 1 has only its diagonal tile
//      and goes on to factor it: phase A of step k + 1), and every CTA
//      q <= k updates its column of B: B_iq -= L_ik X_kq, i > k.
// Every product is a warp's rows of a 32 x 32 tile, lane c column c, the
// right operand's column in registers, the left's rows as 16-byte
// broadcasts from shared memory, one FMA chain over k per entry. The
// exchange goes through L2 (cp.async back into shared memory): pushing
// each tile into every CTA over DSMEM ran at about 36 GB/s from an SM,
// 1.8 us for X_kk^T alone (probes/k3.py). S is read once (cp.async), l11
// and invlh written once; nothing is padded beyond the last 32-row block
// (the padding diagonal is 1). What bounds the route is the chain: 16
// steps at w = 512 of two cluster barriers (about 0.7 us each, more with
// the exchange's stores before them), the warp's 32-column factor and
// inverse (about 3.3 us: 32 dependent columns of shuffles) and the
// exchange's round trips through L2, about 8 us a step in all
// (probes/k3.py).
// Route "blocked" (wider blocks; the driver's nb = 2048 below n = 12288):
// left-looking over diagonal blocks of 512 (float32) or 384 (float64).
// For each block, the history product P = S[b0:, b] - L[b0:, :b0]
// L[b, :b0]^T (one launch), the cluster kernel on P with its rows below
// formed as P[bs:] X_bb^T by the same launch's apply (K3b's), and the
// inverse's off-diagonal blocks invlh[:b0, b] = -invlh[:b0, :b0]
// L[b, :b0]^T invlh[b, b] (two launches): the products on K1's cp.async
// pipeline (gemm_f32_pipe.cuh) in float32, on its FMA core (gemm_tile.cuh)
// in float64. A copy and four launches a block, 14 launches at w = 2048,
// plus one that writes the zeros right of L's diagonal blocks (or NaN).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "cluster.cuh"
#include "gemm_f32_pipe.cuh"
#include "gemm_tile.cuh"
#include "potrf_cluster.cuh"

namespace cg = cooperative_groups;

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

namespace {

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

}  // namespace

// ===== the routes "cluster" and "blocked" (shared with K3b/K3c) ===========

namespace elx {
namespace chol {
namespace {

constexpr int kB = 32;  // tile edge: a warp's lanes, one factor step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// LD: a tile's row stride (rows 16-byte aligned and four banks apart);
// BM: rows of an apply strip; LDA: the row stride of the strip's
// transposed copy; TR: rows of a thread's apply block (16 row groups of
// TR rows by 16 column pairs: a warp's two row groups read their P rows
// as two 16-byte broadcasts, its column pairs one 128- or 256-byte row of
// the column block).
template <typename T>
struct Geo;
template <>
struct Geo<float> {
  static constexpr int LD = 36, BM = 64, LDA = 68, TR = 4;
};
template <>
struct Geo<double> {
  static constexpr int LD = 34, BM = 32, LDA = 34, TR = 2;
};
template <typename T>
constexpr int kTile = kB * Geo<T>::LD;

__host__ __device__ inline int tiles_of(int w) { return (w + kB - 1) / kB; }

// Dynamic shared memory of the factor role (a CTA's nt + 1 own tiles, the
// nt-tile panel copy and X_kk^T) and of the apply role (the strip's
// transposed copy and one column block of invlh).
template <typename T>
size_t factor_smem(int nt) {
  return static_cast<size_t>(2 * nt + 2) * kTile<T> * sizeof(T);
}
template <typename T>
size_t apply_smem(int nt) {
  return static_cast<size_t>(kB) * nt * (Geo<T>::LDA + kB) * sizeof(T);
}

template <bool kLow>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kLow) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}
template <bool kLow>
__device__ __forceinline__ double rnd(double x) {
  return x;
}

// N consecutive values from 16-byte aligned shared memory.
template <int N>
__device__ __forceinline__ void ldv(float (&r)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    r[i] = v.x;
    r[i + 1] = v.y;
    r[i + 2] = v.z;
    r[i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void ldv(double (&r)[N], const double* p) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + i);
    r[i] = v.x;
    r[i + 1] = v.y;
  }
}

// An asynchronous copy of one value (4 or 8 bytes) into shared memory,
// through L1: only for data that no CTA of the launch writes.
template <typename T>
__device__ __forceinline__ void cp_async1(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T)))
               : "memory");
}
// 16 bytes, of which `bytes` are read and the rest zero-filled, through L2
// only (data the launch's other CTAs wrote).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two consecutive values from 8- (float) or 16-byte (double) aligned
// shared memory.
__device__ __forceinline__ void ld2(float (&r)[2], const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}
__device__ __forceinline__ void ld2(double (&r)[2], const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}

// This lane's column of a tile: v[m] = Q[m][lane].
template <typename T>
__device__ __forceinline__ void column(T (&v)[kB], const T* Q, int lane) {
#pragma unroll
  for (int m = 0; m < kB; ++m) v[m] = Q[m * Geo<T>::LD + lane];
}

// Rows [i0, i0 + RW) of the tile O, column lane:
//   O[i][lane] = (kSub ? O[i][lane] - : ) sum_m P[m][i] q[m]
// with q this lane's column of the right operand: one FMA chain over m
// a value, the left operand's rows read as 16-byte broadcasts.
template <typename T, int RW, bool kSub>
__device__ __forceinline__ void rows_op(T* O, const T* P, const T (&q)[kB],
                                        int i0, int lane) {
  constexpr int LD = Geo<T>::LD;
  T acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = T(0);
#pragma unroll
  for (int m = 0; m < kB; ++m) {
    T p[RW];
    ldv(p, P + m * LD + i0);
#pragma unroll
    for (int r = 0; r < RW; ++r) acc[r] = fma(p[r], q[m], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    T* o = O + (i0 + r) * LD + lane;
    *o = kSub ? *o - acc[r] : acc[r];
  }
}

// The exchange between the factor CTAs goes through L2: a tile of this
// CTA's shared memory (kB rows, LD apart) to a contiguous 32 x 32 tile of
// global memory, 16 bytes a thread; and back by cp.async through L2 (the
// caller waits). Pushing each tile into every CTA over DSMEM took longer:
// about 36 GB/s from one SM (probes/k3.py).
template <typename T>
__device__ void tile_out(T* g, const T* tile) {
  constexpr int kChunks = kB * static_cast<int>(sizeof(T)) / 16;
  for (int e = threadIdx.x; e < kB * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    reinterpret_cast<float4*>(g + r * kB)[ch] =
        reinterpret_cast<const float4*>(tile + r * Geo<T>::LD)[ch];
  }
}
template <typename T>
__device__ void tile_in(T* tile, const T* g) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  for (int e = threadIdx.x; e < kB * (kB / kV); e += kThreads) {
    const int r = e / (kB / kV), ch = e % (kB / kV) * kV;
    cp_async16(tile + r * Geo<T>::LD + ch, g + r * kB + ch, 16);
  }
}

// dst[a * ld + b] = tile[b][a] for a < na, b < nb.
template <typename T>
__device__ void store_t(T* dst, long long ld, const T* tile, int na, int nb) {
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int a = e / kB, b = e % kB;
    if (a < na && b < nb) dst[a * ld + b] = tile[b * Geo<T>::LD + a];
  }
}

// dst[a * ld + b] = v for a < na, b in [b0, b1).
template <typename T>
__device__ void fill(T* dst, long long ld, long long na, int b0, int b1,
                     T v) {
  const int n = b1 - b0;
  if (n <= 0) return;
  for (long long e = threadIdx.x; e < na * n; e += kThreads)
    dst[e / n * ld + b0 + e % n] = v;
}

// Phase timestamps for probes/k3.py (elx_potrf_stamps sets the buffer;
// null, the default, records nothing): thread 0 of factor CTA q writes
// %globaltimer at event e of step k to stamps[16 + (q * 16 + k) * 8 + e];
// the apply's first strip (whichever CTA takes it) writes column block j at
// stamps[2064 + 3 j + e]; stamps[0] is the grid's CTAs.
__device__ long long* g_stamps = nullptr;

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(int q, int k, int e) {
  if (g_stamps != nullptr && threadIdx.x == 0)
    g_stamps[16 + (q * 16 + k) * 8 + e] = now_ns();
}

// 1 / sqrt(d): MUFU.RSQ in float (within 2 ulp), sqrt and a division in
// double.
__device__ __forceinline__ float rsqrt_of(float d) { return rsqrtf(d); }
__device__ __forceinline__ double rsqrt_of(double d) { return 1.0 / sqrt(d); }

// Phase A for the CTA that owns row-block p. Warp 0 factors the updated
// diagonal tile own[p] (symmetric) in registers, lane i holding row i,
// and inverts it in the same loop, lane c holding column c of
// X_pp = inv(L_pp) (forward substitution, right-looking: column j of L,
// shuffled out for the factor's update, updates X's rows below j too);
// it writes L_pp back (transposed, zeros above the diagonal), X_pp into
// own[p + 1] (row-major) and X_pp^T into xkk; then the CTA writes xkk to
// the exchange tile gxkk. A pivot that is not > 0 (or a NaN) raises
// sync[3].
template <typename T>
__device__ void diag_step(const Call<T>& c, T* own, T* xkk, T* gxkk, int p) {
  constexpr int LD = Geo<T>::LD, TS = kTile<T>;
  const int lane = threadIdx.x % 32;
  T* D = own + p * TS;
  T* X = own + (p + 1) * TS;
  stamp(p, p, 5);
  if (threadIdx.x < 32) {
    // lane i: a[c] = A[i][c], becoming L[i][c]; x[i] = X[i][lane], which
    // gathers sum_{m < i} L[i][m] X[m][lane] until row i is formed. Column
    // j's shuffled L[c][j] serve both the factor's update and X's.
    T a[kB], x[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      a[j] = D[j * LD + lane];
      x[j] = T(0);
    }
    bool bad = false;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const T d = __shfl_sync(0xffffffffu, a[j], j);
      bad = bad || !(d > T(0));
      const T inv = rsqrt_of(d);  // 1 / sqrt(d)
      a[j] = lane == j ? d * inv : a[j] * inv;  // lanes above j: unused
      const T xj = lane < j ? -x[j] * inv : (lane == j ? inv : T(0));
      x[j] = xj;
#pragma unroll
      for (int cc = j + 1; cc < kB; ++cc) {
        const T lcj = __shfl_sync(0xffffffffu, a[j], cc);  // L[cc][j]
        a[cc] = fma(-a[j], lcj, a[cc]);
        x[cc] = fma(lcj, xj, x[cc]);
      }
    }
    if (bad && lane == 0) atomicExch(c.sync + 3, 1);
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      D[j * LD + lane] = j <= lane ? a[j] : T(0);
      X[j * LD + lane] = x[j];
      xkk[lane * LD + j] = x[j];
    }
  }
  stamp(p, p, 6);
  __syncthreads();
  tile_out(gxkk, xkk);
  stamp(p, p, 7);
}

// The factor role: CTA q of the first cluster to start (see the header).
template <typename T>
__device__ void factor_role(const Call<T>& c, cg::cluster_group& cl,
                            unsigned char* smem, int q) {
  constexpr int LD = Geo<T>::LD, TS = kTile<T>;
  constexpr int GT = kB * kB;  // a contiguous tile of the exchange
  const int w = c.w, nt = tiles_of(w);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool pub = static_cast<int>(gridDim.x) > nt;  // apply clusters wait
  // own[j], j <= q: L_qj^T (A_qj^T until formed); own[i + 1], i >= q:
  // X_iq row-major (B_iq until formed); slot[j]: L_jk^T of step k; the
  // exchange: tile j L_jk^T, tile 16 X_kk^T
  T* own = reinterpret_cast<T*>(smem);
  T* slot = own + (nt + 1) * TS;
  T* xkk = slot + nt * TS;
  T* gxkk = c.xch + 16 * GT;
  const int rq = min(kB, w - kB * q);
  T* outq = c.out + static_cast<long long>(c.r0 + kB * q) * c.ldo;
  T* xq = c.invlh + static_cast<long long>(kB * q) * c.ldx;

  // Row-block q of S, each tile transposed: the diagonal tile mirrored
  // from the lower triangle, the identity past w.
  for (int e = tid; e < (q + 1) * kB * kB; e += kThreads) {
    const int j = e / (kB * kB), i = e / kB % kB, cc = e % kB;
    const int r = kB * q + i, col = kB * j + cc;
    T* dst = own + j * TS + cc * LD + i;
    if (r < w && col < w)
      cp_async1(dst, col <= r ? c.sym + r * c.lds + col
                              : c.sym + static_cast<long long>(col) * c.lds + r);
    else
      *dst = r == col ? T(1) : T(0);
  }
  for (int e = tid; e < (nt - q) * TS; e += kThreads)
    own[(q + 1) * TS + e] = T(0);
  cp_async_wait_all();
  fill(outq, c.ldo, rq, kB * (q + 1), w, T(0));  // right of L11's diagonal
  fill(xq, c.ldx, rq, 0, kB * q, T(0));          // left of invlh's
  if (q == 0) diag_step(c, own, xkk, gxkk, 0);

  for (int k = 0; k < nt; ++k) {
    cl.sync();  // barrier 1: X_kk^T in every CTA
    stamp(q, k, 0);
    if (k > 0 && q == 0 && tid == 0) cluster::st_release(c.sync + 1, k);
    // phase B: L_qk^T = (A_qk X_kk^T)^T (q > k), X_kq = X_kk B_kq (q < k)
    if (q != k) {
      T* O = own + (q > k ? k : k + 1) * TS;
      tile_in(xkk, gxkk);
      T v[kB];
      column(v, O, lane);
      cp_async_wait_all();
      __syncthreads();
      rows_op<T, 4, false>(O, xkk, v, 4 * warp, lane);
      __syncthreads();
      if (q > k) tile_out(c.xch + q * GT, O);
    }
    stamp(q, k, 1);
    cl.sync();  // barrier 2: every L_jk^T in the exchange
    stamp(q, k, 2);
    // phase C: the step's finished tiles to global memory (they drain
    // while the updates run), then the updates
    const int ck = min(kB, w - kB * k);
    if (q >= k) store_t(outq + kB * k, c.ldo, own + k * TS, rq, ck);
    if (q <= k) store_t(xq + kB * k, c.ldx, own + (k + 1) * TS, rq, ck);
    // the panel tiles this CTA reads: L_jk^T for j in (k, q) (its own,
    // j = q, is own[k]), or for every j > k
    for (int j = k + 1; j < (q > k ? q : nt); ++j)
      tile_in(slot + j * TS, c.xch + j * GT);
    T v[kB];
    column(v, own + (q > k ? k : k + 1) * TS, lane);
    cp_async_wait_all();
    __syncthreads();
    if (q > k) {
      // A_qj -= L_qk L_jk^T, j in (k, q]: the diagonal tile comes last,
      // so for q = k + 1 it is the only one
      for (int t = warp; t < (q - k) * 4; t += kWarps) {
        const int j = k + 1 + t / 4;
        rows_op<T, 8, true>(own + j * TS, j == q ? own + k * TS : slot + j * TS,
                            v, 8 * (t % 4), lane);
      }
      if (q == k + 1) {
        __syncthreads();
        diag_step(c, own, xkk, gxkk, q);
      }
    } else {
      // B_iq -= L_ik X_kq, i in (k, nt)
      for (int t = warp; t < (nt - 1 - k) * 4; t += kWarps) {
        const int i = k + 1 + t / 4;
        rows_op<T, 8, true>(own + (i + 1) * TS, slot + i * TS, v,
                            8 * (t % 4), lane);
      }
    }
    stamp(q, k, 3);
    // X's row-block k, before it is published to the apply clusters
    if (pub && q <= k) asm volatile("fence.acq_rel.gpu;" ::: "memory");
    stamp(q, k, 4);
  }
  cl.sync();
  if (q == 0 && tid == 0) cluster::st_release(c.sync + 1, nt);
  if (cluster::ld_acquire(c.sync + 3) != 0) {
    fill(outq, c.ldo, rq, 0, w, qnan<T>());
    fill(xq, c.ldx, rq, 0, w, qnan<T>());
  }
}

// Qs[m][c] = src[m * ld + col0 + c] for m < K, c < 32 (zero where m or
// col0 + c >= w), src written by the factor cluster during the launch:
// read through L2 only, in 16-byte cp.async copies where src and ld
// allow, else in batches of scalar loads eight deep. Waits for its own
// copies; the caller synchronises the block.
template <typename T>
__device__ void stage_block(T* Qs, const T* src, long long ld, int K,
                            int col0, int w) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));  // values a copy
  const int tid = threadIdx.x;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (ld * static_cast<long long>(sizeof(T))) % 16 == 0;
  if (vec) {
    for (int e = tid; e < K * (kB / kV); e += kThreads) {
      const int m = e / (kB / kV), c = e % (kB / kV) * kV;
      const int n = m < w ? max(0, min(kV, w - col0 - c)) : 0;
      cp_async16(Qs + m * kB + c, n ? src + m * ld + col0 + c : src,
                 n * static_cast<int>(sizeof(T)));
    }
    cp_async_wait_all();
    return;
  }
  for (int e0 = tid; e0 < K * kB; e0 += 8 * kThreads) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads, m = e / kB, col = col0 + e % kB;
      v[u] = e < K * kB && m < w && col < w ? __ldcg(src + m * ld + col)
                                            : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * kThreads < K * kB) Qs[e0 + u * kThreads] = v[u];
  }
}

// The apply role: the CTA takes strips of BM rows of L21 = pan21 invlh
// from the counter sync[4] until none is left, and forms column block j
// of a strip as soon as row-block j of X = invlh^T is published:
// out[row][32 j + c] = sum_{m < 32 (j + 1)} pan[row][m] invlh[m][32 j + c],
// one FMA chain over m a value. The factor cluster's CTAs join when the
// factor is done. A strip of a block that is not positive definite is
// NaN (the flag is final once the last row-block is published).
template <typename T, bool kLow>
__device__ void apply_role(const Call<T>& c, unsigned char* smem,
                           int* strip) {
  constexpr int BM = Geo<T>::BM, LDA = Geo<T>::LDA, TR = Geo<T>::TR;
  static_assert(BM == 16 * TR, "16 row groups of TR rows");
  const int w = c.w, nt = tiles_of(w), K0 = kB * nt;
  const int tid = threadIdx.x;
  const int i0 = tid / 16 * TR, c0 = tid % 16 * 2;  // this thread's block
  T* panT = reinterpret_cast<T*>(smem);  // [K0][LDA]: the strip, transposed
  T* Qs = panT + K0 * LDA;               // [K0][32]: invlh's column block
  const long long first = static_cast<long long>(c.r0) + w;
  const long long below = c.rows - first;
  if (below <= 0) return;
  const int nstrip = static_cast<int>((below + BM - 1) / BM);
  for (;;) {
    __syncthreads();  // the previous strip's reads are done
    if (tid == 0) *strip = atomicAdd(c.sync + 4, 1);
    __syncthreads();
    const int s = *strip;
    if (s >= nstrip) break;
    const long long row0 = first + static_cast<long long>(s) * BM;
    const int nr = static_cast<int>(min(static_cast<long long>(BM),
                                        c.rows - row0));
    for (int e = tid; e < K0 * BM; e += kThreads) {
      const int r = e / K0, m = e % K0;
      if (r < nr && m < w)
        cp_async1(panT + m * LDA + r, c.pan + (row0 + r) * c.sp0 + m * c.sp1);
      else
        panT[m * LDA + r] = T(0);
    }
    cp_async_wait_all();
    if constexpr (kLow)  // each thread rounds the values it copied
      for (int e = tid; e < K0 * BM; e += kThreads)
        panT[e % K0 * LDA + e / K0] = rnd<kLow>(panT[e % K0 * LDA + e / K0]);
    for (int j = 0; j < nt; ++j) {
      if (tid == 0) cluster::wait_at_least(c.sync + 1, j + 1);
      const bool probe = g_stamps != nullptr && tid == 0 && s == 0;
      if (probe) g_stamps[2064 + 3 * j] = now_ns();
      __syncthreads();
      const int K = kB * (j + 1), col0 = kB * j;
      stage_block(Qs, c.invlh, c.ldx, K, col0, w);
      if constexpr (kLow) {
        __syncthreads();
        for (int e = tid; e < K * kB; e += kThreads) Qs[e] = rnd<kLow>(Qs[e]);
      }
      __syncthreads();
      if (probe) g_stamps[2064 + 3 * j + 1] = now_ns();
      T acc[TR][2];
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[r][0] = acc[r][1] = T(0);
#pragma unroll 8
      for (int m = 0; m < K; ++m) {
        T p[TR], qv[2];
        ldv(p, panT + m * LDA + i0);
        ld2(qv, Qs + m * kB + c0);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          acc[r][0] = fma(p[r], qv[0], acc[r][0]);
          acc[r][1] = fma(p[r], qv[1], acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (i0 + r < nr && col0 + c0 + cc < w)
            c.out[(row0 + i0 + r) * c.ldo + col0 + c0 + cc] = acc[r][cc];
      __syncthreads();  // Qs is read before the next column block lands
      if (probe) g_stamps[2064 + 3 * j + 2] = now_ns();
    }
    if (cluster::ld_acquire(c.sync + 3) != 0)
      fill(c.out + row0 * c.ldo, c.ldo, nr, 0, w, qnan<T>());
  }
}

// One launch: clusters of nt CTAs; the first cluster to start (ticket 0)
// factors, then every CTA applies. The last CTA to finish zeroes the
// counters.
template <typename T, bool kLow>
__global__ void __launch_bounds__(kThreads, 1) chol_kernel(const Call<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket, strip;
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int q = static_cast<int>(cl.block_rank());
  if (g_stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    g_stamps[0] = gridDim.x;
  // the rows above the diagonal block (K3c)
  const long long zeros = static_cast<long long>(c.r0) * c.w;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < zeros; e += static_cast<long long>(gridDim.x) * kThreads)
    c.out[e / c.w * c.ldo + e % c.w] = T(0);
  if (q == 0 && threadIdx.x == 0) ticket = atomicAdd(c.sync, 1);
  cl.sync();
  const int t = *cl.map_shared_rank(&ticket, 0);
  if (t == 0) factor_role<T>(c, cl, smem, q);
  apply_role<T, kLow>(c, smem, &strip);
  cl.sync();  // no CTA leaves while a peer may read its shared memory
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(c.sync + 2, 1) == static_cast<int>(gridDim.x) - 1) {
      c.sync[0] = c.sync[1] = c.sync[2] = c.sync[4] = 0;
      if (!c.sticky) c.sync[3] = 0;
    }
  }
}

template <typename T, bool kLow>
cudaError_t launch_kernel(const Call<T>& c, cudaStream_t st) {
  const int nt = tiles_of(c.w);
  const long long below = static_cast<long long>(c.rows) - c.r0 - c.w;
  const size_t smem = below > 0
                           ? std::max(factor_smem<T>(nt), apply_smem<T>(nt))
                           : factor_smem<T>(nt);
  const auto kernel = chol_kernel<T, kLow>;
  int dev = 0, optin = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  // per device: the shared-memory and cluster-size attributes once, and
  // the clusters of each (nt, apply or not) shape the card holds at once
  static int ready[8];
  static int most_of[8][17][2];
  if (dev >= 8) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    ELX_RETURN_IF_ERROR(cluster::smem_optin(&optin));
    cudaFuncAttributes fa{};
    ELX_RETURN_IF_ERROR(cudaFuncGetAttributes(&fa, kernel));
    ready[dev] = optin - static_cast<int>(fa.sharedSizeBytes);
    ELX_RETURN_IF_ERROR(cluster::prepare(kernel, 16, ready[dev]));
  }
  if (smem > static_cast<size_t>(ready[dev])) return cudaErrorInvalidValue;
  int& most = most_of[dev][nt][below > 0];
  if (!most) {
    ELX_RETURN_IF_ERROR(cluster::max_active(kernel, nt, kThreads, smem, &most));
    if (most < 1) return cudaErrorInvalidConfiguration;
  }
  int G = 1;
  if (below > 0) {
    const long long strips = (below + Geo<T>::BM - 1) / Geo<T>::BM;
    G = 1 + static_cast<int>(std::min(static_cast<long long>(most - 1),
                                      (strips + nt - 1) / nt));
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster::config(attr, G, nt, kThreads, smem, st);
  ELX_RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, kernel, c));
  return cudaGetLastError();
}

// A product of the blocked route: K1's cp.async pipeline for float32
// (tagged 3), its FMA core for float64.
template <typename T>
cudaError_t gemm(const GemmArgs& g, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (pipe::unit_strides(g)) return pipe::launch_any<3>(g, st);
  }
  return launch_gemm<T, T, T>(g, 1, st);
}

// After the blocked route: zeros right of L's diagonal blocks (no block
// writes them), or NaN in both outputs if a block was not positive
// definite.
template <typename T>
__global__ void finish_blocked(int w, int bs, T* l11, long long ldl,
                               T* invlh, long long ldx, const int* bad) {
  const bool poison = *bad != 0;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < static_cast<long long>(w) * w;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e / w), j = static_cast<int>(e % w);
    if (poison) {
      l11[i * ldl + j] = qnan<T>();
      invlh[i * ldx + j] = qnan<T>();
    } else if (j / bs > i / bs) {
      l11[i * ldl + j] = T(0);
    }
  }
}

}  // namespace

template <typename T>
cudaError_t cluster_call(const Call<T>& c, cudaStream_t st) {
  if (c.w <= 0 || c.w > kClusterMaxW<T> || c.r0 < 0 || c.rows < c.r0 + c.w)
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (c.low) return launch_kernel<T, true>(c, st);
  } else {
    if (c.low) return cudaErrorInvalidValue;
  }
  return launch_kernel<T, false>(c, st);
}

template <typename T>
cudaError_t blocked_call(int w, const T* sym, long long lds, T* l11,
                         long long ldl, T* invlh, long long ldx, T* ws,
                         int* sync, cudaStream_t st) {
  constexpr int bs = kClusterMaxW<T>;
  T* P = ws + kExchange;                    // (w, bs): the panel
  T* T1 = P + static_cast<size_t>(w) * bs;  // (w, bs)
  ELX_RETURN_IF_ERROR(cudaMemsetAsync(sync + 3, 0, sizeof(int), st));
  // invlh's blocks below the diagonal are zero, and the off-diagonal
  // products read the whole leading square
  ELX_RETURN_IF_ERROR(cudaMemset2DAsync(invlh, ldx * sizeof(T), 0,
                                        w * sizeof(T), w, st));
  for (int b0 = 0; b0 < w; b0 += bs) {
    const int wb = std::min(bs, w - b0), mrows = w - b0;
    const T* src = sym + b0 * lds + b0;
    long long ld = lds;
    T* lb = l11 + b0 * ldl;  // rows b0.. of L
    if (b0 > 0) {
      // P = S[b0:, b] - L[b0:, :b0] L[b, :b0]^T
      ELX_RETURN_IF_ERROR(cudaMemcpy2DAsync(
          P, bs * sizeof(T), src, lds * sizeof(T), wb * sizeof(T), mrows,
          cudaMemcpyDeviceToDevice, st));
      const GemmArgs hist{mrows, wb, b0, lb, ldl, 1, 0, lb, 1, ldl, 0,
                          P, bs, 1, 0, -1.0, 1.0, 0};
      ELX_RETURN_IF_ERROR(gemm<T>(hist, st));
      src = P;
      ld = bs;
    }
    const Call<T> c{wb,     mrows, 0,   0,  1,   src, ld, src,
                    ld,     1,     lb + b0, ldl, invlh + b0 * ldx + b0,
                    ldx,    sync,  ws};
    ELX_RETURN_IF_ERROR(cluster_call(c, st));
    if (b0 > 0) {
      // invlh[:b0, b] = -invlh[:b0, :b0] L[b, :b0]^T invlh[b, b]
      const GemmArgs t1{b0, wb, b0, invlh, ldx, 1, 0, lb, 1, ldl, 0,
                        T1, bs, 1, 0, 1.0, 0.0, 0};
      ELX_RETURN_IF_ERROR(gemm<T>(t1, st));
      const GemmArgs x{b0, wb, wb, T1, bs, 1, 0, invlh + b0 * ldx + b0, ldx,
                       1, 0, invlh + b0, ldx, 1, 0, -1.0, 0.0, 0};
      ELX_RETURN_IF_ERROR(gemm<T>(x, st));
    }
  }
  const long long total = static_cast<long long>(w) * w;
  const int blocks = static_cast<int>(std::min(total / 256 + 1, 1024LL));
  finish_blocked<T><<<blocks, 256, 0, st>>>(w, bs, l11, ldl, invlh, ldx,
                                            sync + 3);
  ELX_RETURN_IF_ERROR(cudaGetLastError());
  return cudaMemsetAsync(sync + 3, 0, sizeof(int), st);
}

template cudaError_t cluster_call<float>(const Call<float>&, cudaStream_t);
template cudaError_t cluster_call<double>(const Call<double>&, cudaStream_t);
template cudaError_t blocked_call<float>(int, const float*, long long, float*,
                                         long long, float*, long long, float*,
                                         int*, cudaStream_t);
template cudaError_t blocked_call<double>(int, const double*, long long,
                                          double*, long long, double*,
                                          long long, double*, int*,
                                          cudaStream_t);

}  // namespace chol
}  // namespace elx

namespace {

template <typename T>
cudaError_t block_inv(int route, int w, const T* sym, long long lds, T* l11,
                      T* invlh, T* ws, int* flags, cudaStream_t st) {
  if (route == 1) {
    const elx::chol::Call<T> c{w,   w, 0,     0, 0,     sym, lds, sym,
                               lds, 1, l11,   w, invlh, w,   flags, ws};
    return elx::chol::cluster_call(c, st);
  }
  if (route == 2)
    return elx::chol::blocked_call(w, sym, lds, l11, w, invlh, w, ws, flags,
                                   st);
  return cudaErrorInvalidValue;
}

}  // namespace

// probes/k3.py: the device buffer (2200 int64) the cluster kernel writes
// its phase timestamps to, or null (the default) for none.
extern "C" int elx_potrf_stamps(void* buffer) {
  long long* p = static_cast<long long*>(buffer);
  return cudaMemcpyToSymbol(elx::chol::g_stamps, &p, sizeof(p));
}

// route: 1 "cluster", 2 "blocked" (0, the retired first design, and any
// other code return cudaErrorInvalidValue); dtype: 0 float, 1 double.
// sym: (w, w), row stride lds, unit column stride; l11, invlh: (w, w)
// contiguous. ws and flags as kernels/potrf.py:workspace sizes them for
// the route (zeroed flags before the first call of the cluster and
// blocked routes; they are left zero).
extern "C" int elx_potrf_block_inv(int route, int dtype, int w,
                                   const void* sym, long long lds, void* l11,
                                   void* invlh, void* ws, void* flags,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(flags);
  if (w <= 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return block_inv<float>(route, w, static_cast<const float*>(sym), lds,
                            static_cast<float*>(l11),
                            static_cast<float*>(invlh),
                            static_cast<float*>(ws), f, st);
  if (dtype == 1)
    return block_inv<double>(route, w, static_cast<const double*>(sym), lds,
                             static_cast<double*>(l11),
                             static_cast<double*>(invlh),
                             static_cast<double*>(ws), f, st);
  return cudaErrorInvalidValue;
}
