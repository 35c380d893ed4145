// K1: the port's local GEMM, C = A * B (see gemm_tile.cuh for the kernel).
//
// Replaces the TPU kernel elementalx/kernels/matmul.py:matmul_pallas
// (body _matmul_kernel): a (M/bm, N/bn, K/bk) grid with K innermost, an
// f32 VMEM accumulator and tile-divisible shapes only.
//
// On Hopper the main-path shapes (history products (M-k0) x k0 x nb and
// L21 products (M-k0) x nb x nb of the Cholesky, the Trsm updates) are
// compute-bound: their arithmetic intensity is hundreds of FLOP per byte.
// This first version feeds the FP32 FMA pipes from shared memory (register
// blocking 8x8 per thread gives 16 FMAs per shared-memory word read), so
// its ceiling is the card's 67 TFLOP/s of non-tensor FP32. It gives up the
// tensor cores (wgmma), TMA and a deeper pipeline; for float that is also
// what keeps full FP32 accuracy, and bfloat16 runs through the same FP32
// FMA path. Operands are taken through their strides, so no transposed
// copy is made; ragged edges are masked in the kernel.
#include "gemm_tile.cuh"

namespace {
enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };
}

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
