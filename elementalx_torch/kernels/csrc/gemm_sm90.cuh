// The Hopper GEMM core for bfloat16 operands: TMA loads into a ring of
// shared-memory stages, wgmma on the tensor cores, the f32 accumulator in
// registers. K1 (matmul.cu) and K8 (ring_summa.cu) run their bfloat16
// instances on it.
//
// Bound on the H100: a large product is bound by operations, at 989
// TFLOP/s dense bf16 on the tensor cores (16384^3: 8.89 ms); its bytes
// (each operand read once) take a few percent of that. The FMA core of
// gemm_tile.cuh reaches at most the 67 TFLOP/s of FP32 FMA, so bf16 needs
// the tensor cores, and they need their operands in shared memory in the
// layout wgmma reads, delivered without spending the consumers'
// instruction slots. The design:
//
//   - a CTA computes a BM x BN = 128 x 256 tile of C with three
//     warpgroups: warpgroup 0 is the producer (one thread starts the
//     TMA loads), warpgroups 1 and 2 the consumers, each owning 64 rows and
//     running wgmma.mma_async m64n256k16 (128 f32 accumulators a thread);
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232);
//   - K advances BK = 64 at a time through kStages = 4 stages (48 KB
//     each: the A tile 128 x 64, the B tile 64 x 256), each with a "full"
//     mbarrier (the TMA's transaction bytes) and an "empty" one (one
//     arrival from each consumer warp once its wgmmas on the stage are
//     done); the consumers keep one wgmma group in flight and release a
//     stage one k-step late;
//   - TMA reads each operand in place, over its own unit-stride dimension,
//     with the 128-byte swizzle: a K-major operand (A row-major, B a
//     transposed view such as row.mH) in boxes of 64 k x rows, an
//     MN-major one (A a .mT view, B row-major) in boxes of 64 m or n x 64
//     k, which wgmma reads with its transpose bit set. Out-of-range rows,
//     columns and k are filled with zeros by the TMA, so ragged M, N and
//     K need no masking in the main loop;
//   - the epilogue applies alpha and beta, masks the ragged M and N
//     edges and writes bfloat16 or float32 from the registers;
//   - tiles are rastered in groups of 16 row tiles, so that the CTAs in
//     flight share A and B tiles in L2.
//
// What TMA needs of an operand (the caller routes anything else to the
// FMA core): a 16-byte aligned base, one unit stride, and the other
// stride a multiple of 16 bytes. A persistent scheduler, clusters and TMA
// multicast are not used.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace elx {
namespace sm90 {
namespace {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileA = BM * BK * 2, kTileB = BN * BK * 2;  // bytes
constexpr int kChunk = 64 * BK * 2;  // one 64-wide box of an MN-major tile
constexpr int kSmemBytes = kStages * (kTileA + kTileB) + 2 * kStages * 8 + 1024;
constexpr int kGroupM = 16;

// ---- host side: tensor maps -------------------------------------------

using namespace elx::tma;

// A bfloat16 operand whose unit-stride extent is `inner` and whose `outer`
// lines lie `stride` elements apart, read in boxes of box_inner x
// box_outer with the 128-byte swizzle (box_inner * 2 bytes = 128).
inline cudaError_t make_map(CUtensorMap* map, const void* base,
                            long long inner, long long outer,
                            long long stride, int box_inner, int box_outer) {
  return tma::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, inner,
                       outer, stride, box_inner, box_outer,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map of A (M x K): K-major (sak = 1) in boxes of 64 k x 128 rows,
// M-major (sam = 1) in boxes of 64 rows x 64 k.
inline cudaError_t map_a(CUtensorMap* map, const void* A, int M, int K,
                         long long sam, long long sak, bool m_major) {
  return m_major ? make_map(map, A, M, K, sak, 64, BK)
                 : make_map(map, A, K, M, sam, BK, BM);
}
// The map of B (K x N): K-major (sbk = 1) in boxes of 64 k x 256 columns,
// N-major (sbn = 1) in boxes of 64 columns x 64 k.
inline cudaError_t map_b(CUtensorMap* map, const void* B, int K, int N,
                         long long sbk, long long sbn, bool n_major) {
  return n_major ? make_map(map, B, N, K, sbk, 64, BK)
                 : make_map(map, B, K, N, sbn, BK, BN);
}

// ---- device side: TMA boxes, wgmma -------------------------------------

// A's stage: K-major one box of 64 k x 128 rows, M-major two boxes of 64
// rows. Either way consumer c's 64 rows start kChunk * c bytes in.
template <bool kMN>
__device__ __forceinline__ void load_a(const CUtensorMap* map, uint32_t dst,
                                       uint32_t bar, int k0, int m0) {
  if constexpr (kMN) {
#pragma unroll
    for (int c = 0; c < BM / 64; ++c)
      tma_load(dst + c * kChunk, map, bar, m0 + 64 * c, k0);
  } else {
    tma_load(dst, map, bar, k0, m0);
  }
}

// B's stage: K-major one box of 64 k x 256 columns, N-major four boxes of
// 64 columns, kChunk bytes apart.
template <bool kMN>
__device__ __forceinline__ void load_b(const CUtensorMap* map, uint32_t dst,
                                       uint32_t bar, int k0, int n0) {
  if constexpr (kMN) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load(dst + c * kChunk, map, bar, n0 + 64 * c, k0);
  } else {
    tma_load(dst, map, bar, k0, n0);
  }
}

// The wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// addr: LBO and SBO in bytes, swizzle mode 1 (128 B) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of the j-th 16-deep k-slice of a 64-wide stage tile. K-
// major: rows of 128 bytes (64 k), 8-row groups 1024 bytes apart (SBO),
// the slice 32 bytes further along the row. MN-major: rows of 128 bytes
// (64 m or n) one per k, 8-k groups 1024 bytes apart (SBO), 64-wide boxes
// kChunk apart (LBO), the slice 16 rows (2048 bytes) further down.
template <bool kMN>
__device__ __forceinline__ uint64_t slice_desc(uint32_t tile, int j) {
  return kMN ? smem_desc(tile + j * 2048, kChunk, 1024)
             : smem_desc(tile + j * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmmas (whose results it cannot see).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 256, f32) += A(64 x 16) * B(16 x 256), bf16 operands in shared
// memory through the descriptors da and db; kTA / kTB set the transpose
// bits (1: the operand is MN-major).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// ---- the tile ------------------------------------------------------------

// Where C's tile goes and how: C = alpha * acc + beta * C on M x N.
struct Epilogue {
  int M, N;
  void* C;
  long long scm, scn;
  float alpha, beta;
};

// Tile `id` of an M x N product, rastered in groups of kGroupM row tiles.
__device__ __forceinline__ void tile_origin(int M, int N, int id, int& m0,
                                            int& n0) {
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int first = id / (kGroupM * tn) * kGroupM;
  const int rows = min(tm - first, kGroupM);
  const int in = id % (kGroupM * tn);
  m0 = (first + in % rows) * BM;
  n0 = in / rows * BN;
}

__device__ __forceinline__ float load_out(const float* p) { return *p; }
__device__ __forceinline__ float load_out(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Consumer c's 64 x 256 accumulators into C. Thread (warp w, lane l)
// holds, for each 8-column group j, rows 16 w + l / 4 (+ 8) and columns
// 8 j + 2 (l % 4) (+ 1) at d[4 j .. 4 j + 3].
template <typename TOut>
__device__ __forceinline__ void store_tile(const Epilogue& e, int m0, int n0,
                                           int c, const float (&d)[128]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int r0 = m0 + 64 * c + 16 * warp + lane / 4;
  TOut* C = static_cast<TOut*>(e.C);
  const bool pairs = e.scn == 1 && e.scm % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % (2 * sizeof(TOut)) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= e.M || col >= e.N) continue;
      TOut* p = C + row * e.scm + col * e.scn;
      float v0 = e.alpha * d[4 * j + 2 * h];
      float v1 = e.alpha * d[4 * j + 2 * h + 1];
      const bool two = col + 1 < e.N;
      if (e.beta != 0.f) {
        v0 += e.beta * load_out(p);
        if (two) v1 += e.beta * load_out(p + e.scn);
      }
      if (two && pairs) {
        store_pair(p, v0, v1);
      } else {
        store_out(p, v0);
        if (two) store_out(p + e.scn, v1);
      }
    }
  }
}

// One CTA's tile: nk k-steps through the stage ring, then the epilogue.
// load(t, a_dst, b_dst, bar) starts k-step t's TMA boxes (kTileA + kTileB
// bytes in all) into the stage at a_dst / b_dst, completing on bar.
// kAMN / kBMN: A is M-major / B is N-major. Every thread of the block calls
// it; smem is the block's dynamic shared memory.
template <bool kAMN, bool kBMN, typename TOut, typename Load>
__device__ __forceinline__ void gemm_tile(uint8_t* smem, int nk, int m0,
                                          int n0, const Epilogue& e,
                                          Load load) {
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t a_stage = base, b_stage = base + kStages * kTileA;
  const uint32_t full = b_stage + kStages * kTileB, empty = full + 8 * kStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        // the stage's previous use (k-step t - kStages) has been released
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kTileA + kTileB);
        load(t, a_stage + s * kTileA, b_stage + s * kTileB, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    const uint32_t ta = a_stage + s * kTileA + c * kChunk;
    const uint32_t tb = b_stage + s * kTileB;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_m64n256k16<kAMN, kBMN>(acc, slice_desc<kAMN>(ta, j),
                                   slice_desc<kBMN>(tb, j));
    wgmma_commit();
    fence_acc(acc);
    // k-step t - 1's wgmmas are done: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (t > 0 && threadIdx.x % 32 == 0)
      mbar_arrive(empty + 8 * ((t - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_tile<TOut>(e, m0, n0, c, acc);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace
}  // namespace sm90
}  // namespace elx
