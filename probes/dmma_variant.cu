// K1's float64 core ("dmma") built on its own from probes/dmma_variant.cuh
// with the variant's macros (ELX_DMMA_*), so that probes/dmma_rate.py can
// time variants in turns with the library's build. The entry takes
// elx_matmul_dmma's arguments.
#include "dmma_variant.cuh"

extern "C" int dmma_variant(int M, int N, int K, const void* A, long long sam,
                            long long sak, int a_m_major, const void* B,
                            long long sbk, long long sbn, int b_n_major,
                            void* C, long long scm, long long scn, int narrow,
                            void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const elx::GemmArgs g{M, N, K, A, sam, sak, 0, B, sbk, sbn, 0, C,
                        scm, scn, 0, 1.0, 0.0, 0};
  return elx::dmma::launch_any(g, static_cast<cudaStream_t>(stream),
                               narrow != 0, a_m_major != 0, b_n_major != 0);
}
