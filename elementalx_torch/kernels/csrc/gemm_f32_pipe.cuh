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
constexpr int kPitch = BM + 4;  // an MN-major stage row: 128 + 4 floats
constexpr int kOperand = BK * kPitch;  // floats, either layout (>= 128 * 32)
constexpr int kSmemBytes = kStages * 2 * kOperand * 4;
static_assert(BM == BN && BM * BK <= kOperand, "stage sizes");

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

// Copy one operand's k-step into a stage. The operand has `extent` rows
// (m or n) from x0, unit stride along k (kK) or along m/n, `ld` the other
// stride; kvalid k in range. Chunks past an edge are zero-filled.
template <bool kK>
__device__ __forceinline__ void load_stage(float* st, const float* p,
                                           long long ld, int x0, int extent,
                                           int kvalid) {
  constexpr int kChunks = BM * BK / 4 / kThreads;  // 4 a thread
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if constexpr (kK) {
      const int x = e / (BK / 4), c = e % (BK / 4);
      const int n = x0 + x < extent ? min(max(kvalid - 4 * c, 0), 4) : 0;
      const float* src = n ? p + (x0 + x) * ld + 4 * c : p;
      cp_async16(st + kmajor_at(x, c), src, 4 * n);
    } else {
      const int k = e / (BM / 4), c = e % (BM / 4);
      const int n = k < kvalid ? min(max(extent - x0 - 4 * c, 0), 4) : 0;
      const float* src = n ? p + k * ld + x0 + 4 * c : p;
      cp_async16(st + k * kPitch + 4 * c, src, 4 * n);
    }
  }
}

// The 8 values of this thread's rows first .. first + 3 and BM / 2 + first
// .. BM / 2 + first + 3 (its tile_row / tile_col, first a multiple of 4)
// at k = 4 kc .. 4 kc + 3: v[i][kk]. All 8 rows of a K-major stage share
// one swizzle, (first / 4) % 8, so the reads are one base and offsets.
template <bool kK>
__device__ __forceinline__ void load_frag(float (&v)[8][4], const float* st,
                                          int kc, int first) {
  if constexpr (kK) {
    const float* base = st + first * BK + ((kc ^ ((first >> 2) & 7)) << 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = i < 4 ? i : BM / 2 + i - 4;
      const float4 q = *reinterpret_cast<const float4*>(base + x * BK);
      v[i][0] = q.x;
      v[i][1] = q.y;
      v[i][2] = q.z;
      v[i][3] = q.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* row = st + (4 * kc + kk) * kPitch;
      const float4 q0 = *reinterpret_cast<const float4*>(row + first);
      const float4 q1 = *reinterpret_cast<const float4*>(row + BM / 2 + first);
      v[0][kk] = q0.x;
      v[1][kk] = q0.y;
      v[2][kk] = q0.z;
      v[3][kk] = q0.w;
      v[4][kk] = q1.x;
      v[5][kk] = q1.y;
      v[6][kk] = q1.z;
      v[7][kk] = q1.w;
    }
  }
}

// acc += the product over nk k-steps; step(t) gives k-step t's operands.
// kAK: A is K-major (sak = 1, lda = sam), else M-major (sam = 1, lda =
// sak); kBK: B is K-major (sbk = 1, ldb = sbn), else N-major (ldb = sbk).
// Block-uniform; acc must start at zero for gemm_tile.cuh's result.
template <bool kAK, bool kBK, typename StepFn>
__device__ __forceinline__ void tile_product(uint8_t* smem, int nk, int M,
                                             int N, long long lda,
                                             long long ldb, int m0, int n0,
                                             StepFn step,
                                             float (&acc)[TM][TN]) {
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + kStages * kOperand;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  auto fetch = [&](int t) {
    if (t < nk) {
      const Step s = step(t);
      load_stage<kAK>(sa + t % kStages * kOperand, s.a, lda, m0, M, s.kvalid);
      load_stage<kBK>(sb + t % kStages * kOperand, s.b, ldb, n0, N, s.kvalid);
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
    const float* ta = sa + t % kStages * kOperand;
    const float* tb = sb + t % kStages * kOperand;
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      float a[8][4], b[8][4];
      load_frag<kAK>(a, ta, kc, ty * TM / 2);
      load_frag<kBK>(b, tb, kc, tx * TN / 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fma(a[i][kk], b[j][kk], acc[i][j]);
    }
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

// C = alpha A B + beta C (g) on this pipeline, as elx::launch_gemm runs it
// on the FMA core. kAK: A is K-major (sak = 1), else M-major; kBK: B is
// K-major (sbk = 1), else N-major. kTag only names the instance, so that
// a profile tells the callers apart (0: K1, 4: K4's rank-32 update).
template <bool kAK, bool kBK, int kTag>
__global__ void __launch_bounds__(kThreads, 1) gemm(const GemmArgs g) {
  extern __shared__ uint8_t smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* A = static_cast<const float*>(g.A);
  const float* B = static_cast<const float*>(g.B);
  const long long ka = kAK ? 1 : g.sak, kb = kBK ? 1 : g.sbk;
  const int K = g.K;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_product<kAK, kBK>(
      smem, (K + BK - 1) / BK, g.M, g.N, kAK ? g.sam : g.sak,
      kBK ? g.sbn : g.sbk, m0, n0,
      [=](int t) {
        const long long k0 = static_cast<long long>(t) * BK;
        return Step{A + k0 * ka, B + k0 * kb,
                    min(BK, K - static_cast<int>(k0))};
      },
      acc);
  tile_store<float, float>(g, static_cast<float*>(g.C), m0, n0, acc);
}

template <bool kAK, bool kBK, int kTag = 0>
cudaError_t launch(const GemmArgs& g, cudaStream_t s) {
  const auto kernel = gemm<kAK, kBK, kTag>;
  const cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pipe
}  // namespace elx
