// K8: the ring SUMMA, C = A * B over a 1-D ring of the grid's p positions.
//
// Replaces the TPU kernel elementalx/kernels/ring_summa.py:ring_summa
// (pallas_call body _ring_kernel): each device keeps its row block of A
// (M/p x K) and pushes B's row blocks (K/p x N) round the ICI ring by
// remote DMA into a 3-slot VMEM buffer, overlapping step s+1's transfer
// with step s's matmul. At step s rank `my` multiplies A_my's column block
// of `holder = (my - s) mod p` by B_holder, accumulating in f32.
//
// Here the kernel pulls instead of pushing. It is given a table of the p
// B-block pointers and reads B_holder where it lies, so no block is
// forwarded, no host collective runs and nothing is staged per step: the
// ring forwarding exists because ICI reaches only a torus neighbour, while
// an H100 host's NVSwitch reaches every card directly. Each rank's slice of
// the launch walks the holders in the ring order, so at every step the
// ranks read a permutation of the blocks. On a virtual grid (several
// positions on one card) every pointer is local; a peer pointer of another
// card can go in the same table unchanged, which is K8 across cards (the
// wrapper refuses it until a machine with several cards can test it).
//
// One launch covers every rank on the card: blockIdx.z is the rank's slot,
// (blockIdx.x, blockIdx.y) a BM x BN tile of its C block. The tile's
// k-loop runs over the p holder blocks on K1's tile core (gemm_tile.cuh):
// the next k-tile is loaded into registers while the current one feeds the
// FMAs, and the f32 (f64 for double) accumulator lives in registers across
// all p holders, so C is rounded once to A's type. On the H100 the
// full-width call (16384^3) is bound by operations, like K1: FP32 FMA,
// no tensor cores (TF32 is off by the library's policy), so bfloat16 runs
// at the float rate too.
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

}  // namespace

// C_r = sum over s of A_r[:, blk(h)] * B_h, h = (rank_r - s) mod p, for the
// nslots ranks launched here (ranks[i], a[i], c[i]); b holds all p B blocks
// by ring rank. Every block is contiguous and row-major.
extern "C" int elx_ring_summa(int dtype, int p, int nslots, int Mloc, int N,
                              int K, const long long* ranks,
                              const long long* a, const long long* b,
                              const long long* c, void* stream) {
  if (p < 1 || p > kMaxRanks || nslots < 1 || nslots > p || K % p != 0 ||
      Mloc < 0 || N < 0)
    return cudaErrorInvalidValue;
  if (Mloc == 0 || N == 0) return cudaSuccess;
  RingArgs args{};
  args.p = p;
  args.Mloc = Mloc;
  args.N = N;
  args.K = K;
  args.kb = K / p;
  for (int i = 0; i < p; ++i)
    args.b[i] = reinterpret_cast<const void*>(b[i]);
  for (int i = 0; i < nslots; ++i) {
    if (ranks[i] < 0 || ranks[i] >= p) return cudaErrorInvalidValue;
    args.rank[i] = static_cast<int>(ranks[i]);
    args.a[i] = reinterpret_cast<const void*>(a[i]);
    args.c[i] = reinterpret_cast<void*>(c[i]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float, float>(args, nslots, s);
  if (dtype == kF64) return launch<double, double>(args, nslots, s);
  if (dtype == kBF16) return launch<__nv_bfloat16, float>(args, nslots, s);
  return cudaErrorInvalidValue;
}
