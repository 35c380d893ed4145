// The float32 FMA core on an asynchronous pipeline: the register blocking
// and the arithmetic of gemm_tile.cuh's float core, fed by cp.async
// through a ring of shared-memory stages instead of through registers.
//
// Bound on the H100: FP32 FMA outside the tensor cores, 67 TFLOP/s (TF32
// is off by the library's policy). gemm_tile.cuh's core reaches about half
// of it: it stages every operand through registers into two shared-memory
// stages of BK = 8, so each k-tile of 512 FMAs a thread carries a
// __syncthreads, eight scalar transposing stores and eight bounds-checked
// 64-bit address computations, and the next k-tile's loads have one
// k-tile to arrive. Here:
//
//   - cp.async copies 16-byte chunks straight into shared memory
//     (zero-filling past the ragged M, N and K edges), kStages = 4 stages
//     of BK = 32 deep, so loads run three k-tiles ahead and one
//     __syncthreads covers 2048 FMAs a thread;
//   - each operand keeps its own layout in shared memory: an MN-major one
//     as rows of k (read as in gemm_tile.cuh, two 16-byte vectors a
//     k-step), a K-major one as rows of m or n with 32 k each, its 16-byte
//     chunks XOR-swizzled by row so that the reads are free of bank
//     conflicts, read as one 16-byte vector of 4 k per row;
//   - every C entry is one fma chain over k in order, from zero, as in
//     gemm_tile.cuh, with the same thread-to-entry map and epilogue
//     (tile_store): the result equals that core's bit for bit.
//
// 256 threads, 64 accumulators and 64 operand registers a thread: one
// block per SM (kStages x 34 KB of shared memory).
//
// Two things widen what it takes (K1, elx::pipe::launch):
//
//   - operands with a unit stride that cannot be read in 16-byte pieces
//     (rows of 777 floats, an odd base) are copied with 4-byte cp.async
//     (cp.async.ca, zero-filled past the edges) into the same stage
//     layouts, so they keep the pipeline and its bits; gemm_tile.cuh's
//     core staged them through registers at half the FFMA share;
//   - the tile follows the grid: where 128 x 128 tiles give fewer blocks
//     than the card has SMs (a (1000 x 777) (777 x 1001) product gives 64
//     on 132), the launch takes 64 x 128 tiles (4 x 8 accumulators a
//     thread, same thread map). Every C entry is the same fma chain over
//     k either way, so the tile changes no bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace elx {
namespace pipe {
namespace {

constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8;
constexpr int kStages = 4;
constexpr int kThreads = 256;

// The stage sizes of a kBM x BN tile (kBM = 128 or 64; 16 x 16 threads,
// each with a (kBM / 16) x 8 register block). An MN-major stage holds BK
// rows of extent + 4 floats; a K-major one extent rows of BK floats.
template <int kBM>
struct Shape {
  static constexpr int TM = kBM / 16;
  static constexpr int kOpA = BK * (kBM + 4);
  static constexpr int kOpB = BK * (BN + 4);
  static constexpr int kSmemBytes = kStages * (kOpA + kOpB) * 4;
};
constexpr int kSmemBytes = Shape<BM>::kSmemBytes;
static_assert(Shape<BM>::TM == TM, "the 128 x 128 tile is K8's");

// One k-step's operands: A (M x K) and B (K x N) at the step's first k,
// with kvalid of its BK k in range.
struct Step {
  const float* a;
  const float* b;
  int kvalid;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
// One float, or a zero where bytes is 0 (cp.async of 4 bytes goes through
// L1: .cg takes only 16).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
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

// Float offset of 16-byte chunk c (4 k) of row x in a K-major stage: rows
// of 32 k, chunks XOR-swizzled by (x / 4) % 8.
__device__ __forceinline__ int kmajor_at(int x, int c) {
  return x * BK + ((c ^ ((x >> 2) & 7)) << 2);
}

// Copy one operand's k-step into a stage. The operand has kX rows (m or
// n) a tile from x0, `extent` in all, unit stride along k (kK) or along
// m/n, `ld` the other stride; kvalid k in range. Past an edge the stage
// is zero-filled. narrow: 4-byte copies (any base, any ld), else 16-byte
// chunks (16-byte aligned base, ld a multiple of 4).
template <bool kK, int kX>
__device__ __forceinline__ void load_stage(float* st, const float* p,
                                           long long ld, int x0, int extent,
                                           int kvalid, bool narrow) {
  if (narrow) {
    constexpr int kCopies = kX * BK / kThreads;  // 16 or 8 a thread
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = threadIdx.x + i * kThreads;
      // consecutive threads on the unit stride
      const int x = kK ? e / BK : e % kX, k = kK ? e % BK : e / kX;
      const bool in = x0 + x < extent && k < kvalid;
      const float* src =
          in ? p + (kK ? (x0 + x) * ld + k : k * ld + x0 + x) : p;
      float* dst = kK ? st + kmajor_at(x, k >> 2) + (k & 3)
                      : st + k * (kX + 4) + x;
      cp_async4(dst, src, in ? 4 : 0);
    }
    return;
  }
  constexpr int kChunks = kX * BK / 4 / kThreads;  // 4 or 2 a thread
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if constexpr (kK) {
      const int x = e / (BK / 4), c = e % (BK / 4);
      const int n = x0 + x < extent ? min(max(kvalid - 4 * c, 0), 4) : 0;
      const float* src = n ? p + (x0 + x) * ld + 4 * c : p;
      cp_async16(st + kmajor_at(x, c), src, 4 * n);
    } else {
      const int k = e / (kX / 4), c = e % (kX / 4);
      const int n = k < kvalid ? min(max(extent - x0 - 4 * c, 0), 4) : 0;
      const float* src = n ? p + k * ld + x0 + 4 * c : p;
      cp_async16(st + k * (kX + 4) + 4 * c, src, 4 * n);
    }
  }
}

// The kR values of this thread's rows first .. first + kR / 2 - 1 and
// kX / 2 + first .. (its tile rows or columns, first a multiple of kR / 2)
// at k = 4 kc .. 4 kc + 3: v[i][kk]. All kR rows of a K-major stage share
// one swizzle, (first / 4) % 8, so the reads are one base and offsets.
template <bool kK, int kX, int kR>
__device__ __forceinline__ void load_frag(float (&v)[kR][4], const float* st,
                                          int kc, int first) {
  constexpr int kH = kR / 2;
  if constexpr (kK) {
    const float* base = st + first * BK + ((kc ^ ((first >> 2) & 7)) << 2);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int x = i < kH ? i : kX / 2 + i - kH;
      const float4 q = *reinterpret_cast<const float4*>(base + x * BK);
      v[i][0] = q.x;
      v[i][1] = q.y;
      v[i][2] = q.z;
      v[i][3] = q.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* row = st + (4 * kc + kk) * (kX + 4);
      if constexpr (kH == 4) {
        const float4 q0 = *reinterpret_cast<const float4*>(row + first);
        const float4 q1 =
            *reinterpret_cast<const float4*>(row + kX / 2 + first);
        v[0][kk] = q0.x;
        v[1][kk] = q0.y;
        v[2][kk] = q0.z;
        v[3][kk] = q0.w;
        v[4][kk] = q1.x;
        v[5][kk] = q1.y;
        v[6][kk] = q1.z;
        v[7][kk] = q1.w;
      } else {
        static_assert(kH == 2, "4 or 8 rows a thread");
        const float2 q0 = *reinterpret_cast<const float2*>(row + first);
        const float2 q1 =
            *reinterpret_cast<const float2*>(row + kX / 2 + first);
        v[0][kk] = q0.x;
        v[1][kk] = q0.y;
        v[2][kk] = q1.x;
        v[3][kk] = q1.y;
      }
    }
  }
}

// acc += the product over nk k-steps of a kBM x BN tile; step(t) gives
// k-step t's operands. kAK: A is K-major (sak = 1, lda = sam), else
// M-major (sam = 1, lda = sak); kBK: B is K-major (sbk = 1, ldb = sbn),
// else N-major (ldb = sbk). Block-uniform; acc must start at zero for
// gemm_tile.cuh's result.
template <bool kAK, bool kBK, int kBM = BM, typename StepFn>
__device__ __forceinline__ void tile_product(
    uint8_t* smem, int nk, int M, int N, long long lda, long long ldb,
    int m0, int n0, StepFn step, float (&acc)[kBM / 16][TN],
    bool narrow = false) {
  using S = Shape<kBM>;
  constexpr int kTM = S::TM;
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + kStages * S::kOpA;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  auto fetch = [&](int t) {
    if (t < nk) {
      const Step s = step(t);
      load_stage<kAK, kBM>(sa + t % kStages * S::kOpA, s.a, lda, m0, M,
                           s.kvalid, narrow);
      load_stage<kBK, BN>(sb + t % kStages * S::kOpB, s.b, ldb, n0, N,
                          s.kvalid, narrow);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    // stage t has landed for every thread, and every thread is done with
    // stage t - 1, which the next fetch overwrites
    __syncthreads();
    fetch(t + kStages - 1);
    const float* ta = sa + t % kStages * S::kOpA;
    const float* tb = sb + t % kStages * S::kOpB;
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      float a[kTM][4], b[TN][4];
      load_frag<kAK, kBM, kTM>(a, ta, kc, ty * kTM / 2);
      load_frag<kBK, BN, TN>(b, tb, kc, tx * TN / 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fma(a[i][kk], b[j][kk], acc[i][j]);
    }
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes = kSmemBytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// C = alpha A B + beta C (g) on this pipeline, as elx::launch_gemm runs it
// on the FMA core, on kBM x BN tiles. kAK: A is K-major (sak = 1), else
// M-major; kBK: B is K-major (sbk = 1), else N-major; narrow: 4-byte
// copies. kTag only names the instance, so that a profile tells the
// callers apart (0: K1, 4: K4's rank-32 update).
template <bool kAK, bool kBK, int kBM, int kTag>
__global__ void __launch_bounds__(kThreads, 1)
    gemm(const GemmArgs g, const int narrow) {
  extern __shared__ uint8_t smem[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const float* A = static_cast<const float*>(g.A);
  const float* B = static_cast<const float*>(g.B);
  const long long ka = kAK ? 1 : g.sak, kb = kBK ? 1 : g.sbk;
  const int K = g.K;
  float acc[kBM / 16][TN];
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_product<kAK, kBK, kBM>(
      smem, (K + BK - 1) / BK, g.M, g.N, kAK ? g.sam : g.sak,
      kBK ? g.sbn : g.sbk, m0, n0,
      [=](int t) {
        const long long k0 = static_cast<long long>(t) * BK;
        return Step{A + k0 * ka, B + k0 * kb,
                    min(BK, K - static_cast<int>(k0))};
      },
      acc, narrow != 0);
  elx::tile_store<float, float, false, kBM>(g, static_cast<float*>(g.C), m0,
                                            n0, acc);
}

template <bool kAK, bool kBK, int kBM, int kTag>
cudaError_t launch_tile(const GemmArgs& g, bool narrow, cudaStream_t s) {
  const auto kernel = gemm<kAK, kBK, kBM, kTag>;
  const cudaError_t err = prepare(kernel, Shape<kBM>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + BN - 1) / BN);
  kernel<<<grid, kThreads, Shape<kBM>::kSmemBytes, s>>>(g, narrow);
  return cudaGetLastError();
}

// The launch: 128 x 128 tiles, or 64 x 128 where those give fewer blocks
// than the card has SMs. narrow: an operand cannot be read in 16-byte
// pieces (its base, or its other stride, is not a multiple of 16 bytes).
template <bool kAK, bool kBK, int kTag = 0>
cudaError_t launch(const GemmArgs& g, cudaStream_t s, bool narrow = false) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((g.M + BM - 1) / BM) *
                          ((g.N + BN - 1) / BN);
  if (tiles < sms) return launch_tile<kAK, kBK, 64, kTag>(g, narrow, s);
  return launch_tile<kAK, kBK, BM, kTag>(g, narrow, s);
}

}  // namespace
}  // namespace pipe
}  // namespace elx
