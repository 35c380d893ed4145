// K1: the port's local GEMM, C = A * B, on four cores chosen by the
// wrapper (kernels/matmul.py:route) from dtype, shape and alignment alone;
// products of at most 16 columns in float32 and float64 take a fifth,
// the skinny route of gemm_skinny.cu.
//
// Replaces the TPU kernel elementalx/kernels/matmul.py:matmul_pallas
// (line 39; body _matmul_kernel, pallas_call at line 58): a (M/bm, N/bn,
// K/bk) grid with K innermost, an f32 VMEM accumulator and
// tile-divisible shapes only.
//
// On Hopper the main-path shapes (history products (M-k0) x k0 x nb and
// L21 products (M-k0) x nb x nb of the Cholesky, the Trsm updates, the
// 16384^3 headline) are bound by operations: their arithmetic intensity is
// hundreds of FLOP per byte. The bound depends on the type:
//
//   - bfloat16 (elx_matmul_wgmma): 989 TFLOP/s dense on the tensor cores.
//     The core of gemm_sm90.cuh: TMA loads of A and B into a 4-stage ring
//     of 128-byte-swizzled shared-memory tiles, a producer warpgroup and
//     two consumer warpgroups running wgmma m64n256k16 with the f32
//     accumulator in registers, an epilogue writing bf16 or f32. TMA reads
//     each operand over its own unit-stride dimension (row-major, .mT and
//     .mH views alike) and fills the ragged edges with zeros.
//   - float32 (elx_matmul_fma_async): 67 TFLOP/s of FP32 FMA (TF32 is off
//     by the library's policy, so float keeps full FP32 accuracy). The
//     core of gemm_f32_pipe.cuh: the FMA core's 8x8 register blocking and
//     arithmetic, fed by cp.async through four 32-deep shared-memory
//     stages, so FFMAs fill five of six instruction slots of the main
//     loop where the FMA core's staging through registers left one in
//     two; the result is the FMA core's bit for bit. Each operand needs
//     one unit stride: 16-byte copies where its base and other stride
//     allow, else 4-byte ones; 64 x 128 tiles where 128 x 128 ones would
//     leave SMs idle.
//   - float64 (elx_matmul_dmma): 67 TFLOP/s of FP64 on the tensor cores.
//     The core of gemm_dmma.cuh: mma.sync m16n8k8 f64 on 128 x 128 tiles
//     (64 x 128 where those would leave SMs idle), fed by cp.async
//     through three stages of BK = 32 in 16-byte copies, or 8-byte ones
//     for rows of an odd number of doubles or an odd base. Each operand
//     needs one unit stride.
//   - float64 operands with no unit stride, bfloat16 operands that cannot
//     be read in 16-byte pieces and other operands with no unit stride
//     (elx_matmul): the FMA core of
//     gemm_tile.cuh, register blocking 8x8 per thread fed from two
//     shared-memory stages through registers; it takes any strides and
//     masks ragged edges.
//
// The tensor-core core needs each operand's base 16-byte aligned, one unit
// stride and the other a multiple of 16 bytes.
#include "gemm_dmma.cuh"
#include "gemm_f32_pipe.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <bool kAMN, bool kBMN, typename TOut>
__global__ void __launch_bounds__(elx::sm90::kThreads, 1)
    matmul_sm90(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const int K,
                const elx::sm90::Epilogue e) {
  using namespace elx::sm90;
  extern __shared__ uint8_t smem[];
  int m0, n0;
  tile_origin(e.M, e.N, blockIdx.x, m0, n0);
  const CUtensorMap* pa = &ta;
  const CUtensorMap* pb = &tb;
  gemm_tile<kAMN, kBMN, TOut>(
      smem, (K + BK - 1) / BK, m0, n0, e,
      [=](int t, uint32_t a, uint32_t b, uint32_t bar) {
        load_a<kAMN>(pa, a, bar, t * BK, m0);
        load_b<kBMN>(pb, b, bar, t * BK, n0);
      });
}

template <bool kAMN, bool kBMN, typename TOut>
cudaError_t launch_sm90(const CUtensorMap& ta, const CUtensorMap& tb, int K,
                        const elx::sm90::Epilogue& e, cudaStream_t s) {
  using namespace elx::sm90;
  const auto kernel = matmul_sm90<kAMN, kBMN, TOut>;
  const cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return err;
  const int tiles = ((e.M + BM - 1) / BM) * ((e.N + BN - 1) / BN);
  kernel<<<tiles, kThreads, kSmemBytes, s>>>(ta, tb, K, e);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_sm90(bool a_m_major, bool b_n_major, const CUtensorMap& ta,
                        const CUtensorMap& tb, int K,
                        const elx::sm90::Epilogue& e, cudaStream_t s) {
  if (a_m_major)
    return b_n_major ? launch_sm90<true, true, TOut>(ta, tb, K, e, s)
                     : launch_sm90<true, false, TOut>(ta, tb, K, e, s);
  return b_n_major ? launch_sm90<false, true, TOut>(ta, tb, K, e, s)
                   : launch_sm90<false, false, TOut>(ta, tb, K, e, s);
}

}  // namespace

// The FMA core: any strides, float32 / float64 / bfloat16 inputs.
extern "C" int elx_matmul(int dtype_in, int dtype_out, int M, int N, int K,
                          const void* A, long long sam, long long sak,
                          const void* B, long long sbk, long long sbn, void* C,
                          long long scm, long long scn, void* stream) {
  const elx::GemmArgs g{M, N, K, A, sam, sak, 0, B, sbk, sbn, 0, C,
                        scm, scn, 0, 1.0, 0.0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_in == kF32 && dtype_out == kF32)
    return elx::launch_gemm<float, float, float>(g, 1, s);
  if (dtype_in == kF64 && dtype_out == kF64)
    return elx::launch_gemm<double, double, double>(g, 1, s);
  if (dtype_in == kBF16 && dtype_out == kBF16)
    return elx::launch_gemm<__nv_bfloat16, __nv_bfloat16, float>(g, 1, s);
  if (dtype_in == kBF16 && dtype_out == kF32)
    return elx::launch_gemm<__nv_bfloat16, float, float>(g, 1, s);
  return cudaErrorInvalidValue;
}

// The tensor-core core: bfloat16 A and B that TMA can read (a_m_major: A's
// unit stride is sam, else sak; b_n_major: B's is sbn, else sbk), bfloat16
// or float32 C. K = 0 writes zeros and reads nothing.
extern "C" int elx_matmul_wgmma(int dtype_out, int M, int N, int K,
                                const void* A, long long sam, long long sak,
                                int a_m_major, const void* B, long long sbk,
                                long long sbn, int b_n_major, void* C,
                                long long scm, long long scn, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  CUtensorMap ta{}, tb{};
  if (K > 0) {
    cudaError_t err = elx::sm90::map_a(&ta, A, M, K, sam, sak, a_m_major);
    if (err == cudaSuccess)
      err = elx::sm90::map_b(&tb, B, K, N, sbk, sbn, b_n_major);
    if (err != cudaSuccess) return err;
  }
  const elx::sm90::Epilogue e{M, N, C, scm, scn, 1.f, 0.f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_out == kBF16)
    return launch_sm90<__nv_bfloat16>(a_m_major, b_n_major, ta, tb, K, e, s);
  if (dtype_out == kF32)
    return launch_sm90<float>(a_m_major, b_n_major, ta, tb, K, e, s);
  return cudaErrorInvalidValue;
}

// The float32 FMA core on the cp.async pipeline: float32 A, B and C, each
// operand with one unit stride (a_m_major: sam, else sak; b_n_major: sbn,
// else sbk). narrow = 0: both bases 16-byte aligned and the other strides
// multiples of 4 (16-byte copies); narrow = 1: any base and stride (4-byte
// copies). The result equals elx_matmul's bit for bit either way.
extern "C" int elx_matmul_fma_async(int M, int N, int K, const void* A,
                                    long long sam, long long sak,
                                    int a_m_major, const void* B,
                                    long long sbk, long long sbn,
                                    int b_n_major, void* C, long long scm,
                                    long long scn, int narrow, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const elx::GemmArgs g{M, N, K, A, sam, sak, 0, B, sbk, sbn, 0, C,
                        scm, scn, 0, 1.0, 0.0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool n = narrow != 0;
  if (a_m_major)
    return b_n_major ? elx::pipe::launch<false, false>(g, s, n)
                     : elx::pipe::launch<false, true>(g, s, n);
  return b_n_major ? elx::pipe::launch<true, false>(g, s, n)
                   : elx::pipe::launch<true, true>(g, s, n);
}

// The float64 core on the FP64 tensor cores: float64 A, B and C, each
// operand with one unit stride (a_m_major: sam, else sak; b_n_major: sbn,
// else sbk). narrow = 0: both bases 16-byte aligned and the other strides
// even (16-byte copies); narrow = 1: any base and stride (8-byte copies).
// K = 0 writes zeros and reads nothing.
extern "C" int elx_matmul_dmma(int M, int N, int K, const void* A,
                               long long sam, long long sak, int a_m_major,
                               const void* B, long long sbk, long long sbn,
                               int b_n_major, void* C, long long scm,
                               long long scn, int narrow, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const elx::GemmArgs g{M, N, K, A, sam, sak, 0, B, sbk, sbn, 0, C,
                        scm, scn, 0, 1.0, 0.0, 0};
  return elx::dmma::launch_any(g, static_cast<cudaStream_t>(stream),
                               narrow != 0, a_m_major != 0, b_n_major != 0);
}
