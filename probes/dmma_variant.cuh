// A copy of K1's float64 core (elementalx_torch/kernels/csrc/gemm_dmma.cuh)
// with build knobs, for probes/dmma_variant.cu alone: probes/dmma_rate.py
// --variants times each variant in turns with the library's build. The
// library's header fixes BK = 32, 3 stages and C^T = B^T A^T for a
// row-major A times a row-major B; here they are ELX_DMMA_BK,
// ELX_DMMA_STAGES and ELX_DMMA_SWAP, and ELX_DMMA_PROBE = 1 or 2 leaves
// out the copies or the mma (the result is then wrong). The design and
// its numbers are in the library's header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace elx {
namespace dmma {
namespace {

#ifndef ELX_DMMA_BK
#define ELX_DMMA_BK 32
#endif
#ifndef ELX_DMMA_STAGES
#define ELX_DMMA_STAGES 3
#endif
// ELX_DMMA_PROBE (probes/dmma_rate.py only; the result is wrong): 1 skips
// the copies after the first stages (shared reads and mma alone), 2 the
// mma (copies and shared reads alone)
#ifndef ELX_DMMA_PROBE
#define ELX_DMMA_PROBE 0
#endif
// ELX_DMMA_SWAP = 1: a K-major A times an N-major B (both row-major) runs
// as C^T = B^T A^T, whose A (B^T, M-major) and B (A^T, K-major) give
// their fragments in the mma's register order
#ifndef ELX_DMMA_SWAP
#define ELX_DMMA_SWAP 1
#endif
constexpr int BN = 128, BK = ELX_DMMA_BK;
constexpr int kStages = ELX_DMMA_STAGES;
constexpr int kThreads = 256;
constexpr int kWN = 32;  // warp tile's columns: 4 n8 atoms, 2 pairs
static_assert(BK % 8 == 0, "k-steps of 8");

// A kBM x BN tile: stage sizes (doubles) and the warp tile.
template <int kBM>
struct Shape {
  static constexpr int WM = kBM / 2;   // warp tile's rows
  static constexpr int MA = WM / 16;   // m16 atoms a warp
  static constexpr int kOpA = kBM * BK;
  static constexpr int kOpB = BN * BK;
  static constexpr int kSmemBytes = kStages * (kOpA + kOpB) * 8;
};

__device__ __forceinline__ void cp_async16(double* dst, const double* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A B + D on one m16n8k8 atom: a[2 j + i] holds (m = g + 8 i, k = t +
// 4 j), b[j] (k = t + 4 j, n = g), d[2 i + e] (m = g + 8 i, n = 2 t + e),
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Double offset of 16-byte chunk c of row x in a K-major stage (rows of BK
// k): rows 2 apart differ in the chunk's bit 2, so the eight threads of a
// quarter warp (rows 2 g + i, g in {0, 1}; chunks 4 ks + t) read eight
// distinct chunks.
__device__ __forceinline__ int kmajor_at(int x, int c) {
  return x * BK + 2 * (c ^ (((x >> 1) & 1) << 2));
}
// Double offset of chunk c of k-row k in an MN-major stage (rows of kX
// doubles): the chunk's bits 1-2 take (k / 2) mod 4, so a quarter warp
// (k-rows 2 t + j, chunks g in {0, 1}) reads eight distinct chunks.
template <int kX>
__device__ __forceinline__ int mnmajor_at(int k, int c) {
  return k * kX + 2 * (c ^ (((k >> 1) & 3) << 1));
}

// This thread's copies of one operand's k-tiles into the stages: kX rows
// (m or n) of the tile, unit stride along k (kK) or along m/n, ld the
// other stride; kE doubles a copy (2: 16-byte copies, which need a
// 16-byte aligned base and an even ld; 1: 8-byte ones). Copy i of the
// thread is element e = tid + 256 i of the stage in the operand's own
// order (consecutive threads on the unit stride), so each thread keeps
// one position along the unit stride and its copies lie kStep rows
// apart: the sources are p + i step, and only the k-tile moves them.
template <bool kK, int kX, int kE>
struct Loader {
  static constexpr int kPer = (kK ? BK : kX) / kE;  // copies a row
  static constexpr int kStep = kThreads / kPer;     // rows between copies
  static constexpr int kC = kX * BK / kE / kThreads;
  const double* base;  // the operand's first entry (a source that reads
                       // nothing)
  const double* p;     // copy 0's source at the current k-tile
  long long step;      // between copies
  long long kadv;      // from one k-tile to the next
  int row0;            // copy 0's row (x, or k), at the unit position u
  int u;               // the thread's position along the unit stride
  unsigned rows_in;    // kK: bit i for copy i's row below extent
  int ubytes;          // MN: the bytes of a copy in range along m/n

  __device__ __forceinline__ Loader(const double* a, long long ld,
                                    int extent) {
    row0 = threadIdx.x / kPer;
    u = threadIdx.x % kPer * kE;
    base = a;
    p = a + row0 * ld + u;
    step = kStep * ld;
    kadv = kK ? BK : BK * ld;
    rows_in = 0;
    if constexpr (kK) {
#pragma unroll
      for (int i = 0; i < kC; ++i)
        rows_in |= static_cast<unsigned>(row0 + kStep * i < extent) << i;
    }
    ubytes = kK ? 0 : 8 * min(max(extent - u, 0), kE);
  }

  // The k-tile with kvalid of its BK k in range into stage st; then the
  // sources move to the next k-tile.
  __device__ __forceinline__ void fill(double* st, int kvalid) {
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int row = row0 + kStep * i;
      int bytes;
      double* dst;
      if constexpr (kK) {
        bytes = (rows_in >> i & 1u) ? 8 * min(max(kvalid - u, 0), kE) : 0;
        dst = st + kmajor_at(row, u >> 1) + (u & 1);
      } else {
        bytes = row < kvalid ? ubytes : 0;
        dst = st + mnmajor_at<kX>(row, u >> 1) + (u & 1);
      }
      const double* src = bytes ? p + i * step : base;
      if constexpr (kE == 2)
        cp_async16(dst, src, bytes);
      else
        cp_async8(dst, src, bytes);
    }
    p += kadv;
  }
};

// This thread's fragment offset (doubles) in a stage for k-step ks and the
// warp tile's first row or column x0 (a multiple of 16); the atoms'
// offsets from it are constants. A (m16 atoms): a[2 j + i] at (m = g + 8
// i, k = t + 4 j), the atom's rows g and g + 8 being the tile's rows 2 g
// and 2 g + 1. B (n8 atoms in pairs): b[j] at (k = t + 4 j, n = g), pair
// p's atom q having its column g at the tile's column 16 p + 2 g + q.
// Physical k 2 t and 2 t + 1 hold the atom's k t and t + 4, for A and B
// alike. K-major (rows x of BK k): row x0 + 2 g (+ i or q), chunk 4 ks +
// t, swizzled by (x / 2) mod 2 = g mod 2. MN-major (rows of k): k-row 8
// ks + 2 t (+ j), chunk x0 / 2 + g, swizzled by 2 t.
template <bool kK, int kX>
__device__ __forceinline__ int frag_base(int ks, int x0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (kK)
    return (x0 + 2 * g) * BK + 2 * t + 8 * (ks ^ (g & 1));
  else
    return (8 * ks + 2 * t) * kX + x0 + 2 * (g ^ (2 * t));
}

// A's fragments of kMA atoms from the stage offset `at` (frag_base). A
// K-major load gives a thread one row's k t and t + 4 (a[i], a[2 + i]),
// an M-major one its rows g and g + 8 at one k (a[2 j], a[2 j + 1]).
template <bool kK, int kBM, int kMA>
__device__ __forceinline__ void frag_a(double (&f)[kMA][4], const double* at) {
#pragma unroll
  for (int ma = 0; ma < kMA; ++ma) {
    if constexpr (kK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double2 v =
            *reinterpret_cast<const double2*>(at + (16 * ma + i) * BK);
        f[ma][i] = v.x;      // k = t
        f[ma][2 + i] = v.y;  // k = t + 4
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2 v =
            *reinterpret_cast<const double2*>(at + j * kBM + 16 * ma);
        f[ma][2 * j] = v.x;      // m = g
        f[ma][2 * j + 1] = v.y;  // m = g + 8
      }
    }
  }
}

// B's fragments of the warp's 4 atoms from the stage offset `bt`. A
// K-major load gives an atom's b[0], b[1]; an N-major one k t + 4 j of
// both atoms of a pair.
template <bool kK>
__device__ __forceinline__ void frag_b(double (&f)[4][2], const double* bt) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if constexpr (kK) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const double2 v =
            *reinterpret_cast<const double2*>(bt + (16 * p + q) * BK);
        f[2 * p + q][0] = v.x;  // k = t
        f[2 * p + q][1] = v.y;  // k = t + 4
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2 v =
            *reinterpret_cast<const double2*>(bt + j * BN + 16 * p);
        f[2 * p][j] = v.x;      // atom 0 of the pair
        f[2 * p + 1][j] = v.y;  // atom 1
      }
    }
  }
}

// C = alpha A B + beta C (g; lower_only not taken) on kBM x BN tiles. kAK:
// A is K-major (sak = 1), else M-major; kBK: B is K-major (sbk = 1), else
// N-major; kE: 2 for 16-byte copies, 1 for 8-byte ones.
template <bool kAK, bool kBK, int kBM, int kE>
__global__ void __launch_bounds__(kThreads, 1) gemm(const GemmArgs g) {
  using S = Shape<kBM>;
  constexpr int MA = S::MA;
  extern __shared__ uint8_t smem[];
  double* sa = reinterpret_cast<double*>(smem);
  double* sb = sa + kStages * S::kOpA;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const double* A = static_cast<const double*>(g.A);
  const double* B = static_cast<const double*>(g.B);
  // the tile's first row of A (m0) and column of B (n0)
  Loader<kAK, kBM, kE> la(A + m0 * (kAK ? g.sam : 1), kAK ? g.sam : g.sak,
                          g.M - m0);
  Loader<kBK, BN, kE> lb(B + n0 * (kBK ? g.sbn : 1), kBK ? g.sbn : g.sbk,
                         g.N - n0);
  const int K = g.K, nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp / 4) * S::WM, wn0 = (warp % 4) * kWN;
  int fa[BK / 8], fb[BK / 8];
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    fa[ks] = frag_base<kAK, kBM>(ks, wm0);
    fb[ks] = frag_base<kBK, BN>(ks, wn0);
  }

  double acc[MA][4][4];
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  // k-tile t goes to stage t mod kStages
  int fetched = 0;
  double* fa_st = sa;
  double* fb_st = sb;
  auto fetch = [&]() {
    if (fetched < nk) {
      const int kvalid = min(BK, K - fetched * BK);
      la.fill(fa_st, kvalid);
      lb.fill(fb_st, kvalid);
      ++fetched;
      fa_st += S::kOpA;
      fb_st += S::kOpB;
      if (fa_st == sa + kStages * S::kOpA) {
        fa_st = sa;
        fb_st = sb;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch();
  const double* ta = sa;
  const double* tb = sb;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    // stage t has landed for every thread, and every thread is done with
    // stage t - 1, which the next fetch overwrites
    __syncthreads();
    if (ELX_DMMA_PROBE != 1 || t == 0) fetch();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      double a[MA][4], b[4][2];
      frag_a<kAK, kBM, MA>(a, ta + fa[ks]);
      frag_b<kBK>(b, tb + fb[ks]);
#pragma unroll
      for (int i = 0; i < MA; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ELX_DMMA_PROBE == 2) {
            // keep the loads without the mma
            asm volatile("" ::"d"(a[i][0]), "d"(a[i][1]), "d"(a[i][2]),
                         "d"(a[i][3]), "d"(b[j][0]), "d"(b[j][1]));
          } else {
            mma(acc[i][j], a[i], b[j]);
          }
        }
    }
    ta += S::kOpA;
    tb += S::kOpB;
    if (ta == sa + kStages * S::kOpA) {
      ta = sa;
      tb = sb;
    }
  }
  cp_async_wait<0>();

  // atom (i, j)'s d[2 r + e] is C's row wm0 + 16 i + 2 g + r and column
  // wn0 + 16 (j / 2) + 4 t + 2 e + j % 2 of the tile
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  double* C = static_cast<double*>(g.C);
  const double alpha = g.alpha, beta = g.beta;
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm0 + 16 * i + 2 * gq + r;
      if (row >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn0 + 16 * (j / 2) + 4 * tq + 2 * e + j % 2;
          if (col >= g.N) continue;
          double* p = C + row * g.scm + col * g.scn;
          double v = alpha * acc[i][j][2 * r + e];
          if (beta != 0.0) v += beta * *p;
          *p = v;
        }
    }
}

template <bool kAK, bool kBK, int kBM, int kE>
cudaError_t launch_tile(const GemmArgs& g, cudaStream_t s) {
  const auto kernel = gemm<kAK, kBK, kBM, kE>;
  constexpr int bytes = Shape<kBM>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + BN - 1) / BN);
  kernel<<<grid, kThreads, bytes, s>>>(g);
  return cudaGetLastError();
}

// The launch: 128 x 128 tiles, or 64 x 128 where those give fewer blocks
// than the card has SMs. narrow: an operand cannot be read in 16-byte
// pieces (its base is not 16-byte aligned, or its other stride is odd).
template <bool kAK, bool kBK>
cudaError_t launch(const GemmArgs& g, cudaStream_t s, bool narrow) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((g.M + 127) / 128) *
                          ((g.N + BN - 1) / BN);
  if (tiles < sms)
    return narrow ? launch_tile<kAK, kBK, 64, 1>(g, s)
                  : launch_tile<kAK, kBK, 64, 2>(g, s);
  return narrow ? launch_tile<kAK, kBK, 128, 1>(g, s)
                : launch_tile<kAK, kBK, 128, 2>(g, s);
}

// C = A B on g's own layouts (a_m_major: A's unit stride is sam, else
// sak; b_n_major: B's is sbn, else sbk). A K-major A times an N-major B
// runs as C^T = B^T A^T: the same products and sums over k for every
// entry, in the layouts whose fragment loads need no register moves.
inline cudaError_t launch_any(const GemmArgs& g, cudaStream_t s, bool narrow,
                              bool a_m_major, bool b_n_major) {
  if (ELX_DMMA_SWAP && !a_m_major && b_n_major) {
    const GemmArgs t{g.N, g.M, g.K, g.B, g.sbn, g.sbk, 0, g.A, g.sak, g.sam,
                     0, g.C, g.scn, g.scm, 0, g.alpha, g.beta, 0};
    return launch<false, true>(t, s, narrow);
  }
  if (a_m_major)
    return b_n_major ? launch<false, false>(g, s, narrow)
                     : launch<false, true>(g, s, narrow);
  return b_n_major ? launch<true, false>(g, s, narrow)
                   : launch<true, true>(g, s, narrow);
}

}  // namespace
}  // namespace dmma
}  // namespace elx
