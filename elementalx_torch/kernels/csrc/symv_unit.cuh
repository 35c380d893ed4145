// The symv units of K7 (symv.cu); K5 (latrd.cu) runs SymvTiles' ring and
// tile geometry with a walk of its own.
//
// Both add a share of y = H v, H = tril(A) + tril(A, -1)^T, into a block's
// partial y (yp): A[r, c] v[c] into yp[r] for c <= r (row sums) and
// A[r, c] v[r] into yp[c] for c < r (column sums), reading only entries
// with c <= r of a symmetric A (unit column stride). v is read through an
// accessor. Every sum has a fixed order and no float atomics are used, so
// the same inputs give the same bits.
//
// SymvTiles, the unit K7 runs on the H100: square kSymvT x kSymvT
// tiles of the lower triangle stream into a ring of shared-memory stages,
// each filled by one TMA box and guarded by an mbarrier; one thread keeps
// kStages - 1 boxes in flight while the block works on the current one
// (64 KB of ring a block, two blocks an SM: enough bytes in flight to
// cover HBM latency). Each tile is used twice from shared memory:
// A_IJ v_J into row block I and A_IJ^T v_I into row block J. Thread (c,
// g) of 256 owns tile column c and rows 16 g .. 16 g + 15: a warp reads 32
// consecutive words of a tile row, so the reads hit 32 distinct banks.
// A block walks a contiguous range of tiles in strip order (strip I, J =
// 0 .. I): row sums stay in registers for the whole strip and are reduced
// once when the strip ends; column sums are reduced across the four row
// groups through shared memory after every tile. Diagonal tiles select
// (never multiply by 0) the entries with c <= r, so NaN above the
// diagonal does not reach y. Out-of-range rows and columns arrive as TMA
// zeros and v is 0 there.
//
// symv_unit, the first design (K7's core for a row stride TMA cannot
// read): rows [rs, re) x columns [cb, cb + kSymvUW) with scalar loads 1
// KB apart, 15% of HBM bandwidth on the H100.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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


// ---- SymvTiles -------------------------------------------------------------

constexpr int kSymvT = 64;                       // tile order
constexpr int kSymvGroups = kSymvThreads / kSymvT;  // row groups of a tile
constexpr int kSymvGR = kSymvT / kSymvGroups;    // rows of a group (16)
#ifndef ELX_SYMV_RING
#define ELX_SYMV_RING 65536
#endif
constexpr int kSymvRing = ELX_SYMV_RING;         // ring bytes of a block

// One step of the butterfly reduce-scatter: lanes with bit O set keep
// the upper O of the first 2 O values, the others the lower O, each
// added to its partner's. A template, so that every index is a constant
// and the values stay in registers.
template <int O, typename U>
__device__ __forceinline__ void scatter_step(U (&acc)[kSymvGR], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const U send = upper ? acc[i] : acc[i + O];
    const U keep = upper ? acc[i + O] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// A tile's row sums, kSymvGR rows a thread, summed over the warp's 32
// columns in a fixed pattern: lane l ends with row l % 16 in acc[0]. U is
// the sum's type (K5 sums float32 tiles in float64).
template <typename U>
__device__ __forceinline__ void warp_row_sums(U (&acc)[kSymvGR], int lane) {
#pragma unroll
  for (int i = 0; i < kSymvGR; ++i)
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  static_assert(kSymvGR == 16, "the steps below reduce 16 rows");
  scatter_step<8>(acc, lane);
  scatter_step<4>(acc, lane);
  scatter_step<2>(acc, lane);
  scatter_step<1>(acc, lane);
}

template <typename T>
struct SymvTiles {
  static constexpr int kTileBytes = kSymvT * kSymvT * sizeof(T);
  static constexpr int kStages = kSymvRing / kTileBytes;  // 4 float, 2 double
  // dynamic shared memory the caller provides: the ring (128-byte
  // aligned), the full barriers, the column partials (two buffers of
  // kSymvGroups x kSymvT) and the row partials (kSymvWarps x kSymvGR)
  static constexpr int kSmemBytes =
      128 + kSymvRing + 8 * kStages +
      (2 * kSymvGroups * kSymvT + kSymvWarps * kSymvGR) *
          static_cast<int>(sizeof(T));

  const CUtensorMap* map;
  // Tile (I, J) holds local rows kSymvT I - d .. + kSymvT - 1 and local
  // columns kSymvT J - d .. (map row row0 + local row, map column col0 +
  // local column). d = col0 mod (16 / sizeof(T)) puts every box's first
  // column on a 16-byte boundary, as TMA needs; local rows and columns
  // below 0 are masked.
  int row0, col0, n, d;
  long long ntiles;  // tiles of the triangle
  const T* ring;
  uint32_t ring_s, full_s;
  T* scol;
  T* srow;
  unsigned used;     // tiles this block has consumed (every thread agrees)

  // Carves smem; thread 0 initialises the barriers. The caller
  // synchronises the block before the first walk.
  __device__ __forceinline__ SymvTiles(uint8_t* smem, const CUtensorMap* map_,
                                       int row0_, int col0_, int n_)
      : map(map_), row0(row0_), col0(col0_), n(n_),
        d(col0_ % static_cast<int>(16 / sizeof(T))), used(0) {
    const long long nt = strips();
    ntiles = nt * (nt + 1) / 2;
    const uint32_t raw = tma::smem_addr(smem);
    uint8_t* p = smem + (((raw + 127u) & ~127u) - raw);
    ring = reinterpret_cast<const T*>(p);
    ring_s = tma::smem_addr(p);
    full_s = ring_s + kSymvRing;
    scol = reinterpret_cast<T*>(p + kSymvRing + 8 * kStages);
    srow = scol + 2 * kSymvGroups * kSymvT;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) tma::mbar_init(full_s + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ int strips() const {
    return (n + d + kSymvT - 1) / kSymvT;
  }
  // the strip that holds local row r
  __device__ __forceinline__ int strip_of(int r) const {
    return (r + d) / kSymvT;
  }
  __device__ __forceinline__ static long long strip_start(long long I) {
    return I * (I + 1) / 2;
  }

  // (I, J) of tile t of the lower triangle in strip order: t = I (I + 1)
  // / 2 + J, J <= I.
  __device__ __forceinline__ static void tile_of(long long t, int& I,
                                                 int& J) {
    long long i = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > t) --i;
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    I = static_cast<int>(i);
    J = static_cast<int>(t - i * (i + 1) / 2);
  }

  // Block b's share [lo, hi) of the tiles, dealt in contiguous ranges
  // over G blocks.
  __device__ __forceinline__ void range(int b, int G, long long& lo,
                                        long long& hi) const {
    lo = ntiles * b / G;
    hi = ntiles * (b + 1) / G;
  }
  // The block whose share (range()) holds tile t.
  __device__ __forceinline__ int owner(long long t, int G) const {
    return static_cast<int>(((t + 1) * G - 1) / ntiles);
  }
  // Local rows [0, extent) of yp that the share [lo, hi) touches (row
  // sums of its strips, column sums of the columns left of them).
  __device__ __forceinline__ int extent(long long lo, long long hi) const {
    if (lo >= hi) return 0;
    int I, J;
    tile_of(hi - 1, I, J);
    return min(n, kSymvT * (I + 1) - d);
  }

  // Thread 0: tile t into stage s.
  __device__ __forceinline__ void issue(long long t, unsigned s) const {
    int I, J;
    tile_of(t, I, J);
    tma::mbar_expect_tx(full_s + 8 * s, kTileBytes);
    tma::tma_load(ring_s + s * kTileBytes, map, full_s + 8 * s,
                  col0 - d + J * kSymvT, row0 - d + I * kSymvT);
  }

  // Start the first kStages loads of [lo, hi) (the next walk's range): a
  // caller may prefetch before other work to hide the first loads.
  __device__ __forceinline__ void prefetch(long long lo, long long hi) const {
    if (threadIdx.x != 0) return;
    for (long long k = 0; k < kStages && lo + k < hi; ++k)
      issue(lo + k, (used + static_cast<unsigned>(k)) % kStages);
  }

  // Row sums of strip I (rowacc of the thread's 16 rows over its column)
  // reduced over the tile's 64 columns, added into yp.
  __device__ __forceinline__ void flush_rows(T (&rowacc)[kSymvGR], int I,
                                             T* yp) const {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    warp_row_sums(rowacc, lane);
    if (lane < kSymvGR) srow[warp * kSymvGR + lane] = rowacc[0];
    __syncthreads();
    if (tid < kSymvT) {
      const int g = tid / kSymvGR, l = tid % kSymvGR;
      const int r = I * kSymvT - d + tid;
      if (r >= 0 && r < n)
        yp[r] += srow[2 * g * kSymvGR + l] + srow[(2 * g + 1) * kSymvGR + l];
    }
  }

  // After a grid barrier: y[r] for the local rows r, kSymvT rows a block
  // at a time, the sum of the G partials (ypart, lda apart, indexed like
  // yp) in block order. The blocks before the owner of the first tile of
  // r's strip touched no row of the strip (their partials there are zero
  // and are skipped). Each quarter of the blocks is summed by one thread
  // with eight loads in flight, the quarters in a fixed order. Uses the
  // column-partial buffer.
  __device__ __forceinline__ void sum_partials(const T* ypart, long long lda,
                                               T* y) const {
    constexpr int kQ = kSymvThreads / kSymvT;
    static_assert(kQ == 4, "four quarters");
    const int tid = threadIdx.x, G = gridDim.x, q = tid / kSymvT;
    T* red = scol;
    for (int r0 = blockIdx.x * kSymvT; r0 < n; r0 += G * kSymvT) {
      const int r = r0 + tid % kSymvT;
      T s = T(0);
      if (r < n) {
        const int I = strip_of(r);
        const int bf = owner(strip_start(I), G);
        const int cnt = G - bf;
        const int b1 = bf + cnt * (q + 1) / kQ;
        int bb = bf + cnt * q / kQ;
        const T* col = ypart + r;
        T acc[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
        for (; bb + 8 <= b1; bb += 8) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[k] += __ldcg(col + static_cast<long long>(bb + k) * lda);
        }
        for (; bb < b1; ++bb)
          acc[0] += __ldcg(col + static_cast<long long>(bb) * lda);
        s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
            ((acc[4] + acc[5]) + (acc[6] + acc[7]));
      }
      red[q * kSymvT + tid % kSymvT] = s;
      __syncthreads();
      if (tid < kSymvT && r < n)
        y[r] = (red[tid] + red[kSymvT + tid]) +
               (red[2 * kSymvT + tid] + red[3 * kSymvT + tid]);
      __syncthreads();
    }
  }

  // Add the tiles [lo, hi) into yp, their first min(kStages, hi - lo)
  // loads started by prefetch(lo, hi). Every thread of the block calls
  // it.
  template <typename VecAt>
  __device__ __forceinline__ void walk(const VecAt& v, long long lo,
                                       long long hi, T* yp) {
    if (lo >= hi) return;
    const int tid = threadIdx.x, c = tid % kSymvT, g = tid / kSymvT;
    int I, J;
    tile_of(lo, I, J);
    int cur = -1;
    T rowacc[kSymvGR], vi[kSymvGR];
    for (long long t = lo; t < hi; ++t) {
      if (I != cur) {
        if (cur >= 0) flush_rows(rowacc, cur, yp);
        cur = I;
#pragma unroll
        for (int i = 0; i < kSymvGR; ++i) {
          const int r = I * kSymvT - d + g * kSymvGR + i;
          vi[i] = r >= 0 && r < n ? v(r) : T(0);
          rowacc[i] = T(0);
        }
      }
      const int cj = J * kSymvT - d + c;
      const bool col_in = cj >= 0 && cj < n;
      const T vj = col_in ? v(cj) : T(0);
      T old = T(0);
      if (g == 0 && col_in) old = __ldcg(yp + cj);
      const unsigned s = used % kStages;
      tma::mbar_wait(full_s + 8 * s, (used / kStages) & 1u);
      const T* tile = ring + s * (kSymvT * kSymvT) + g * kSymvGR * kSymvT + c;
      T colp = T(0);
      if (I != J && !(d && J == 0)) {
#pragma unroll
        for (int i = 0; i < kSymvGR; ++i) {
          const T x = tile[i * kSymvT];
          rowacc[i] += x * vj;
          colp += x * vi[i];
        }
      } else {
        // the diagonal (c <= r for row sums, c < r for column sums) and
        // the local rows and columns below 0 (strip 0, column block 0),
        // selected, never multiplied by 0
        const bool diag = I == J;
        const int rlo = I == 0 ? d : 0;
        const bool cok = !(J == 0 && c < d);
#pragma unroll
        for (int i = 0; i < kSymvGR; ++i) {
          const int r = g * kSymvGR + i;
          const T x = tile[i * kSymvT];
          const bool in = cok && r >= rlo;
          rowacc[i] += (in && (!diag || c <= r) ? x : T(0)) * vj;
          colp += (in && (!diag || c < r) ? x : T(0)) * vi[i];
        }
      }
      T* sc = scol + (used & 1u) * (kSymvGroups * kSymvT);
      sc[g * kSymvT + c] = colp;
      __syncthreads();  // stage s read by all; column partials written
      if (tid == 0 && t + kStages < hi) issue(t + kStages, s);
      if (g == 0 && col_in)
        yp[cj] = old + ((sc[c] + sc[kSymvT + c]) +
                        (sc[2 * kSymvT + c] + sc[3 * kSymvT + c]));
      ++used;
      if (++J > I) {
        ++I;
        J = 0;
      }
    }
    flush_rows(rowacc, cur, yp);
  }
};

}  // namespace
}  // namespace elx
