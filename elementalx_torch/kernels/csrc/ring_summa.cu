// K8: the ring SUMMA, C = A * B over a 1-D ring of the grid's p positions.
//
// Replaces the TPU kernel elementalx/kernels/ring_summa.py:ring_summa
// (line 93; pallas_call at line 117, body _ring_kernel): each device keeps
// its row block of A (M/p x K) and pushes B's row blocks (K/p x N) round
// the ICI ring by remote DMA into a 3-slot VMEM buffer, overlapping step
// s+1's transfer with step s's matmul. At step s rank `my` multiplies
// A_my's column block of `holder = (my - s) mod p` by B_holder,
// accumulating in f32.
//
// Here the kernel pulls instead of pushing. It is given a table of the p
// B blocks and reads B_holder where it lies, so no block is forwarded, no
// host collective runs and nothing is staged per step: the ring
// forwarding exists because ICI reaches only a torus neighbour, while an
// H100 host's NVSwitch reaches every card directly. Each rank's slice of
// the launch walks the holders in the ring order, so at every step the
// ranks read a permutation of the blocks. On a virtual grid (several
// positions on one card) every block is local; a peer block of another
// card can go in the same table unchanged, which is K8 across cards (the
// wrapper refuses it until a machine with several cards can test it).
//
// One launch covers every rank on the card: blockIdx.z is the rank's slot,
// blockIdx.x a tile of its C block. The tile's k-loop runs over the p
// holder blocks, and the f32 (f64 for double) accumulator lives in
// registers across all p holders, so C is rounded once to A's type. On
// the H100 the full-width call (16384^3) is bound by operations, like K1,
// and the bound depends on the type:
//
//   - bfloat16 (elx_ring_summa_wgmma): 989 TFLOP/s on the tensor cores.
//     The k-loop is the TMA / wgmma pipeline of gemm_sm90.cuh, fed k-step
//     by k-step from the holder's blocks: one tensor map per launched
//     slot's A block and one per ring rank's B block, 2 x 64 CUtensorMaps
//     (16 KB) in a __grid_constant__ kernel parameter, within CUDA 12's
//     32 KB parameter limit and read by the TMA where they lie (no copy to
//     global memory, so no fence.proxy.tensormap is needed). It takes
//     kb = K/p a multiple of 64, so that no k-step crosses two holders,
//     and blocks that TMA can read; other bf16 calls take the FMA core.
//   - float32 (elx_ring_summa_fma_async): at most 67 TFLOP/s of FP32 FMA
//     (TF32 is off by the library's policy). K1's pipelined FMA core
//     (gemm_f32_pipe.cuh), fed k-step by k-step from the holder's blocks
//     by cp.async, with the same kb condition; the FMA core's result bit
//     for bit.
//   - float64, and rings the fast cores do not take (elx_ring_summa):
//     K1's FMA core (gemm_tile.cuh): the next k-tile is loaded into
//     registers while the current one feeds the FMAs.
#include "gemm_f32_pipe.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };

constexpr int kMaxRanks = 64;

struct RingArgs {
  int p, Mloc, N, K, kb;       // K is padded to a multiple of p; kb = K / p
  const void* a[kMaxRanks];    // each launched rank's A block, Mloc x K
  void* c[kMaxRanks];          // each launched rank's C block, Mloc x N
  int rank[kMaxRanks];         // the ring rank of each launched slot
  const void* b[kMaxRanks];    // every rank's B block, kb x N, by ring rank
};

// At most 128 registers a thread, so that two blocks fit on an SM. The
// bfloat16 instance takes 129 without the bound and then runs one block
// per SM, 1.47x slower at 16384^3 on the H100. A minimum of one block
// per SM is no neutral choice: it gave the float instance 139 registers.
template <typename T, typename Acc>
__global__ void __launch_bounds__(elx::kGemmThreads, 2)
    ring_kernel(const RingArgs args) {
  using elx::Tile;
  __shared__ elx::TileSmem<Acc> sm;
  const int slot = blockIdx.z;
  const int my = args.rank[slot];
  const int m0 = blockIdx.x * Tile<Acc>::BM, n0 = blockIdx.y * Tile<Acc>::BN;
  const T* A = static_cast<const T*>(args.a[slot]);

  // A_my[:, holder*kb : (holder+1)*kb] (row stride K) times B_holder
  const elx::GemmArgs g{args.Mloc, args.N, args.kb, nullptr, args.K, 1, 0,
                        nullptr, args.N, 1, 0, args.c[slot], args.N, 1, 0,
                        1.0, 0.0, 0};
  Acc acc[Tile<Acc>::TM][Tile<Acc>::TN];
#pragma unroll
  for (int i = 0; i < Tile<Acc>::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tile<Acc>::TN; ++j) acc[i][j] = Acc(0);
  for (int s = 0; s < args.p; ++s) {
    const int holder = (my - s + args.p) % args.p;
    elx::tile_product<T, Acc, false, false, true>(
        g, A + static_cast<long long>(holder) * args.kb,
        static_cast<const T*>(args.b[holder]), m0, n0, sm, acc);
  }
  elx::tile_store<T, Acc>(g, static_cast<T*>(args.c[slot]), m0, n0, acc);
}

template <typename T, typename Acc>
cudaError_t launch(const RingArgs& args, int nslots, cudaStream_t stream) {
  const dim3 grid((args.Mloc + elx::Tile<Acc>::BM - 1) / elx::Tile<Acc>::BM,
                  (args.N + elx::Tile<Acc>::BN - 1) / elx::Tile<Acc>::BN,
                  nslots);
  ring_kernel<T, Acc><<<grid, elx::kGemmThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

// The float32 ring on the cp.async pipeline (gemm_f32_pipe.cuh): the same
// arithmetic as ring_kernel<float, float>, so the same bits.
__global__ void __launch_bounds__(elx::pipe::kThreads, 1)
    ring_kernel_pipe(const __grid_constant__ RingArgs args) {
  using namespace elx::pipe;
  extern __shared__ uint8_t smem[];
  const int slot = blockIdx.z, my = args.rank[slot], p = args.p;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps = args.kb / BK, kb = args.kb, N = args.N;
  const float* A = static_cast<const float*>(args.a[slot]);
  const void* const* Bs = args.b;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_product<true, false>(
      smem, p * steps, args.Mloc, N, args.K, N, m0, n0,
      [=](int t) {
        const int holder = (my - t / steps + p) % p;
        const int kk = t % steps * BK;
        return Step{A + holder * kb + kk,
                    static_cast<const float*>(Bs[holder]) +
                        static_cast<long long>(kk) * N,
                    BK};
      },
      acc);
  const elx::GemmArgs g{args.Mloc, N, args.kb, nullptr, args.K, 1, 0,
                        nullptr, N, 1, 0, args.c[slot], N, 1, 0,
                        1.0, 0.0, 0};
  elx::tile_store<float, float>(g, static_cast<float*>(args.c[slot]), m0,
                                n0, acc);
}

// The bfloat16 ring on the tensor cores: the tensor maps of the launched
// slots' A blocks (Mloc x K, K-major) and of every rank's B block (kb x N,
// N-major), by ring rank.
struct RingMaps {
  CUtensorMap a[kMaxRanks];
  CUtensorMap b[kMaxRanks];
  void* c[kMaxRanks];
  int rank[kMaxRanks];
  int p, Mloc, N, kb;
};

__global__ void __launch_bounds__(elx::sm90::kThreads, 1)
    ring_kernel_sm90(const __grid_constant__ RingMaps maps) {
  using namespace elx::sm90;
  extern __shared__ uint8_t smem[];
  const int slot = blockIdx.z, my = maps.rank[slot], p = maps.p;
  int m0, n0;
  tile_origin(maps.Mloc, maps.N, blockIdx.x, m0, n0);
  const int steps = maps.kb / BK;  // k-steps per holder
  const int kb = maps.kb;
  const CUtensorMap* pa = &maps.a[slot];
  const CUtensorMap* pb = maps.b;
  const Epilogue e{maps.Mloc, maps.N, maps.c[slot], maps.N, 1, 1.f, 0.f};
  gemm_tile<false, true, __nv_bfloat16>(
      smem, p * steps, m0, n0, e,
      [=](int t, uint32_t a, uint32_t b, uint32_t bar) {
        const int holder = (my - t / steps + p) % p;
        const int kk = t % steps * BK;
        load_a<false>(pa, a, bar, holder * kb + kk, m0);
        load_b<true>(pb + holder, b, bar, kk, n0);
      });
}

// The ring's tables from the wrapper's: false on a bad argument.
bool ring_args(RingArgs& args, int p, int nslots, int Mloc, int N, int K,
               const long long* ranks, const long long* a, const long long* b,
               const long long* c) {
  if (p < 1 || p > kMaxRanks || nslots < 1 || nslots > p || K % p != 0 ||
      Mloc < 0 || N < 0)
    return false;
  args.p = p;
  args.Mloc = Mloc;
  args.N = N;
  args.K = K;
  args.kb = K / p;
  for (int i = 0; i < p; ++i)
    args.b[i] = reinterpret_cast<const void*>(b[i]);
  for (int i = 0; i < nslots; ++i) {
    if (ranks[i] < 0 || ranks[i] >= p) return false;
    args.rank[i] = static_cast<int>(ranks[i]);
    args.a[i] = reinterpret_cast<const void*>(a[i]);
    args.c[i] = reinterpret_cast<void*>(c[i]);
  }
  return true;
}

}  // namespace

// C_r = sum over s of A_r[:, blk(h)] * B_h, h = (rank_r - s) mod p, for the
// nslots ranks launched here (ranks[i], a[i], c[i]); b holds all p B blocks
// by ring rank. Every block is contiguous and row-major. The FMA core.
extern "C" int elx_ring_summa(int dtype, int p, int nslots, int Mloc, int N,
                              int K, const long long* ranks,
                              const long long* a, const long long* b,
                              const long long* c, void* stream) {
  RingArgs args{};
  if (!ring_args(args, p, nslots, Mloc, N, K, ranks, a, b, c))
    return cudaErrorInvalidValue;
  if (Mloc == 0 || N == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float, float>(args, nslots, s);
  if (dtype == kF64) return launch<double, double>(args, nslots, s);
  if (dtype == kBF16) return launch<__nv_bfloat16, float>(args, nslots, s);
  return cudaErrorInvalidValue;
}

// The same ring for float32 on the cp.async pipeline: every block with a
// 16-byte aligned base, N and K multiples of 4, kb = K / p a multiple of
// 32. Equal to elx_ring_summa's float32 result bit for bit.
extern "C" int elx_ring_summa_fma_async(int p, int nslots, int Mloc, int N,
                                        int K, const long long* ranks,
                                        const long long* a,
                                        const long long* b,
                                        const long long* c, void* stream) {
  using namespace elx::pipe;
  RingArgs args{};
  if (!ring_args(args, p, nslots, Mloc, N, K, ranks, a, b, c) ||
      args.kb % BK != 0)
    return cudaErrorInvalidValue;
  if (Mloc == 0 || N == 0) return cudaSuccess;
  const cudaError_t err = prepare(ring_kernel_pipe);
  if (err != cudaSuccess) return err;
  const dim3 grid((Mloc + BM - 1) / BM, (N + BN - 1) / BN, nslots);
  ring_kernel_pipe<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(args);
  return cudaGetLastError();
}

// The same ring for bfloat16 on the tensor cores (gemm_sm90.cuh). Every A
// block is Mloc x K and every B block kb x N, contiguous, row-major, with
// a 16-byte aligned base; kb = K / p a multiple of 64 and N, K multiples
// of 8 (16-byte rows).
extern "C" int elx_ring_summa_wgmma(int p, int nslots, int Mloc, int N, int K,
                                    const long long* ranks, const long long* a,
                                    const long long* b, const long long* c,
                                    void* stream) {
  using namespace elx::sm90;
  RingArgs args{};
  if (!ring_args(args, p, nslots, Mloc, N, K, ranks, a, b, c) ||
      args.kb % BK != 0)
    return cudaErrorInvalidValue;
  if (Mloc == 0 || N == 0) return cudaSuccess;
  RingMaps maps{};
  maps.p = p;
  maps.Mloc = Mloc;
  maps.N = N;
  maps.kb = args.kb;
  for (int i = 0; i < p; ++i) {
    const cudaError_t err = map_b(&maps.b[i], args.b[i], args.kb, N, N, 1, true);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < nslots; ++i) {
    maps.rank[i] = args.rank[i];
    maps.c[i] = args.c[i];
    const cudaError_t err = map_a(&maps.a[i], args.a[i], Mloc, K, K, 1, false);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = prepare(ring_kernel_sm90);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Mloc + BM - 1) / BM) * ((N + BN - 1) / BN), 1, nslots);
  ring_kernel_sm90<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(maps);
  return cudaGetLastError();
}
