// K5: one latrd panel of the Householder tridiagonalization.
//
//   (P, W, tau) for columns [k0, k0 + w) of a real symmetric (M, M)
//   row-major matrix A whose lower triangle is read (rows and columns
//   >= k0), w <= nb <= 128, any M.
//
// Column jl (global column gj = k0 + jl, pivot row gp = gj + 1), as in
// elementalx/lapack/condense.py:_tridiag_panel:
//   acur = A[:, gj] - V[:, :jl] W[gj, :jl]^T - W[:, :jl] V[gj, :jl]^T
//   (v, tau, beta) = householder(acur, gp)
//   y = A_lower-symmetric[k0:, k0:] v
//   p = tau (y - V (W^T v) - W (V^T v));  w = p - (tau/2 v^T p) v
// P's column holds acur on rows <= gj, beta on row gp and v below; W's
// column holds w. P and W are written transposed, (nb, M), so that a
// column is contiguous; rows < k0 and columns >= w stay as the caller
// zeroed them.
//
// Replaces the TPU kernel elementalx/kernels/latrd.py:latrd_panel (body
// _latrd_kernel). That design holds V and W transposed in VMEM, (S, nb,
// TS) each, 8 MB at M=8192, and streams (TS, TS) lower tiles through a
// two-slot buffer. An SM has 227 KB of shared memory, so V, W and every
// length-M vector live in global memory (and L2) here.
//
// What bounds it: the symv's lower-triangle traffic. Column j+1's symv
// needs column j's reflector, so each column streams the trailing
// triangle again: w (m0^2/2) words a panel of order m0 = M - k0 (16.9 GB,
// 5.05 ms at (8192, 0, 128) on the H100's 3.35 TB/s). Everything else in a
// column is latency: grid barriers, row dots, sums of partials. The
// design keeps those short and off the symv's way.
//
// One cooperative launch per panel, all blocks resident. Block b owns the
// R = ceil(m0 / G) trailing rows from k0 + b R; its warps work on a row
// with their 32 lanes, kBatch rows' loads in flight at once. Three grid
// barriers a column, one per data dependency:
//   1. (after the previous column's barrier 3) w of the previous column
//      on the own rows (p - coef v, coef from the G partials of v^T p,
//      summed by every block in the same order; W's row gj, the previous
//      pivot row, from p(gj) - coef, which its owner stored before the
//      barrier); acur on the own rows: the row's 2 jl panel values come
//      from row-major copies of V and W (Vr, Wr: (M, 128)), four a lane in
//      one 16-byte load, and meet in a fixed xor butterfly; the block's
//      partials of sigma^2 and of W^T acur, V^T acur over its rows below
//      gp (the panel dots, divided by the reflector's denominator once it
//      is known);
//   2. every block reduces the sigma^2 partials in the same order and
//      forms the reflector; block e < 2 jl reduces panel dot e over the G
//      partials; the symv: the trailing triangle's 64 x 64 tiles stream
//      through SymvTiles' TMA ring (symv_unit.cuh), each used for both
//      A_IJ v_J and A_IJ^T v_I, in units of up to kUnitTiles tiles of one
//      strip handed out by an atomic counter, largest strips first, so
//      that a block the memory system serves slowly takes fewer units and
//      the blocks finish together. A unit's results go to slots of the
//      unit, not of the block: each tile's column sums to colpart(I, J),
//      the unit's row sums to rowpart(I, chunk); which block ran a unit
//      changes no bit, and no partial y is read back, zeroed or summed
//      over blocks. Then the next column's first tiles are started (its
//      first unit is the block's own), to load across the barrier;
//   3. y on the own rows, summed from the slots in a fixed order (eight
//      phases over the strips, one warp each, coalesced over 32 rows); V,
//      P and p on the own rows (a warp a row, the same row dots against
//      the reduced panel dots) and the block's partial v^T p.
// Every sum is taken in float64 (Acc), for float32 input too: the
// symv's tiles, the slots, the row and panel dots, sigma^2 and v^T p;
// acur, v, p and w are rounded to the input type where they are stored,
// as the plain version stores them. No float atomics anywhere and every
// sum has a fixed order: the result does not change from run to run.
#include <cooperative_groups.h>

#include "symv_unit.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

using Acc = double;                          // every sum's type
constexpr int kThreads = elx::kSymvThreads;  // threads of a block
constexpr int kWarps = elx::kSymvWarps;
constexpr int kMaxNB = 128;                  // widest panel
constexpr int kLane = kMaxNB / 32;           // panel columns a lane holds
constexpr int kBlocksPerSM = 2;              // most blocks per SM
constexpr int kT = elx::kSymvT;              // tile order
constexpr int kGR = elx::kSymvGR;            // rows of a thread in a tile
constexpr int kGroups = elx::kSymvGroups;    // row groups of a tile
constexpr int kUnitTiles = 4;                // tiles of a symv unit
constexpr int kPhases = kWarps;              // phases of a y sum
constexpr int kQueue = 8;                    // units a producer holds
constexpr int kBatch = 4;                    // rows a warp loads at once
static_assert(2 * kMaxNB == kThreads, "a thread a panel dot");

// A phase boundary, ELX_PHASE(k): a block barrier. The barriers made K5
// faster: in one probes/k5.py run at (8192, 0, 128) on an NVIDIA H100
// 80GB HBM3 at 700 W, in turns, 10.34 ms with ELX_PHASE(k) expanding to
// nothing and 9.66 ms with them (the probe's build). Under the phase
// probe (probes/k5.py builds this file with -DELX_LATRD_PROBE) thread 0
// of every block then stamps clock64() into elx_latrd_stamps[(block,
// column, k)], so a stamp marks the whole block's arrival. kProbeLabels
// names the segment between stamp k and k + 1.
#ifdef ELX_LATRD_PROBE
constexpr int kProbeStamps = 10;
constexpr const char* kProbeLabels =
    "w, acur, sigma^2 and panel-dot partials (rows)|barrier 1|"
    "reflector, panel-dot reduction|symv walk (units), next column's "
    "first tiles|barrier 2|panel dots to shared|V, P, y and p (rows)|"
    "v^T p partial|barrier 3";
__device__ long long* elx_latrd_stamps;
#define ELX_PHASE(k)                                                     \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0)                                                \
      elx_latrd_stamps[(static_cast<long long>(blockIdx.x) * g.w + jl) * \
                           kProbeStamps +                                \
                       (k)] = clock64();                                 \
  } while (0)
#else
#define ELX_PHASE(k) __syncthreads()
#endif

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
struct LatrdArgs {
  const T* a;     // (M, M), row stride lda, lower triangle read
  long long lda;
  int M, k0, w, nb;
  T* Pt;          // (nb, M) output P, transposed
  T* Wt;          // (nb, M) output W, transposed
  T* Vr;          // (M, kMaxNB) V, row-major
  T* Wr;          // (M, kMaxNB) W, row-major
  T* tau;         // (nb,)
  T* acur;        // (M,) corrected current column
  T* pbuf;        // (M,) p of each block's own rows
  Acc* colpart;   // (S (S + 1) / 2, kT): tile (I, J)'s column sums
  Acc* rowpart;   // (S, ceil(S / kUnitTiles), kT): a unit's row sums
  Acc* pnorm;     // (G,) partial sigma^2
  Acc* pdots;     // (G, 2 kMaxNB) partial W^T acur | V^T acur
  Acc* dots;      // (2 kMaxNB) W^T v | V^T v
  Acc* pvp;       // (G,) partial v^T p
  int* counters;  // (w,) units handed out past the blocks' own, zero first
};

__device__ __forceinline__ Acc warp_sum(Acc s) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum of G per-block partials, in the same order in every block: each
// thread brings the sum of partials tid, tid + kThreads, ... (its part);
// every thread gets the same total.
__device__ Acc partials_sum(Acc part, Acc* red) {
  part = warp_sum(part);
  __syncthreads();  // red may still be read from the previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  __syncthreads();
  Acc s = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

// Panel columns kLane l .. kLane l + kLane - 1 of row r of a row-major
// (M, kMaxNB) array.
__device__ __forceinline__ void load_row(float (&v)[kLane], const float* x,
                                         int r, int lane) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(
      x + static_cast<long long>(r) * kMaxNB + kLane * lane));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_row(double (&v)[kLane], const double* x,
                                         int r, int lane) {
  const double2* p = reinterpret_cast<const double2*>(
      x + static_cast<long long>(r) * kMaxNB + kLane * lane);
  const double2 q0 = __ldcg(p), q1 = __ldcg(p + 1);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// sum over c < jl of V[r, c] x[c] + W[r, c] y[c], from the lane's columns
// of the row (vr, wr) in order, then the xor butterfly: every lane gets
// the same total.
template <typename T, typename X>
__device__ __forceinline__ Acc row_dot(const T (&vr)[kLane],
                                       const T (&wr)[kLane], const X* x,
                                       const X* y, int lane, int jl) {
  Acc s = 0;
#pragma unroll
  for (int i = 0; i < kLane; ++i) {
    const int c = kLane * lane + i;
    if (c < jl) {
      s = fma(Acc(vr[i]), Acc(x[c]), s);
      s = fma(Acc(wr[i]), Acc(y[c]), s);
    }
  }
  return warp_sum(s);
}

template <typename T>
struct Reflector {
  int gp;
  Acc denom, tau;
  T beta;
  const T* acur;
  // v[r], rounded to T as V stores it: zero above gp, 1 at gp, acur /
  // denom below
  __device__ __forceinline__ T v(int r) const {
    return r > gp ? T(Acc(__ldcg(acur + r)) / denom)
                  : (r == gp ? T(1) : T(0));
  }
};

// The trailing triangle's tile and unit geometry of the panel (strips of
// SymvTiles from the panel's first column).
struct Geometry {
  int S;     // strips of the trailing block
  int maxc;  // units of the widest strip
  int d;     // SymvTiles::d
  // units of strips 0 .. n - 1
  __device__ __forceinline__ static int units_below(int n) {
    const int q = n / kUnitTiles;
    return n + kUnitTiles * q * (q - 1) / 2 + q * (n - q * kUnitTiles);
  }
  __device__ __forceinline__ static long long tile(int I, int J) {
    return static_cast<long long>(I) * (I + 1) / 2 + J;
  }
  // Unit k of a column whose walk starts at strip I0, in the order handed
  // out (strips from the last down to I0): its strip I and chunk c.
  __device__ __forceinline__ void unit(int k, int I0, int& I, int& c) const {
    const int x = units_below(S) - k;
    int lo = I0, hi = S - 1;
    while (lo < hi) {  // the I with units_below(I) < x <= units_below(I + 1)
      const int mid = (lo + hi + 1) / 2;
      if (units_below(mid) < x)
        lo = mid;
      else
        hi = mid - 1;
    }
    I = lo;
    c = units_below(I + 1) - x;
  }
};

// Phase q of y at local row lr: the row sums of the units of lr's strip J
// (chunks c = q, q + kPhases, ...) and the column sums of the tiles
// (I, J), I = max(J, I0) + q, + kPhases, ..., added in that order, the
// loads eight at a time.
template <typename T>
__device__ __forceinline__ Acc y_phase(const LatrdArgs<T>& g,
                                       const Geometry& geo, int lr, int I0,
                                       int q) {
  const int J = (lr + geo.d) / kT, t = lr + geo.d - J * kT;
  Acc s = 0;
  if (J >= I0) {
    const int nch = (J + kUnitTiles) / kUnitTiles;
    for (int c = q; c < nch; c += 4 * kPhases) {
      Acc v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k * kPhases;
        v[k] = ck < nch ? __ldcg(g.rowpart +
                                 (static_cast<long long>(J) * geo.maxc + ck) *
                                     kT + t)
                        : Acc(0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s += v[k];
    }
  }
  for (int I = max(J, I0) + q; I < geo.S; I += 8 * kPhases) {
    Acc v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int Ik = I + k * kPhases;
      v[k] = Ik < geo.S ? __ldcg(g.colpart + Geometry::tile(Ik, J) * kT + t)
                        : Acc(0);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
  }
  return s;
}

// The symv of one column in units of a strip's tiles, handed out by an
// atomic counter; thread 0 is the producer, which grabs units and keeps
// the TMA ring kStages tiles ahead, and queues the units for the block.
// A block's first unit is its own (b: no atomic on the column's start);
// the producer asks for its next unit as it takes the current one, so
// the counter's round trip is hidden behind a unit's tiles; with three
// stages or more, the consumer loads the next unit's v rows during the
// current unit's last tile (the queue holds the next unit by then). A
// tile's products are summed in float64.
template <typename T>
struct UnitWalk {
  using S = elx::SymvTiles<T>;
  static constexpr bool kPrefetchV = S::kStages >= 3;
  S& tiles;
  const Geometry& geo;
  int* qI;     // shared queue of units: strip, chunk (-1: the column ends)
  int* qc;
  T* sv;       // shared: the next unit's 64 v rows
  Acc* scol;   // shared: two buffers of kGroups x kT column partials
  Acc* srow;   // shared: kWarps x kGR row partials
  // producer state (thread 0)
  int pcol, pI, pJ, pJend, pushed, knext;
  unsigned issued;
  bool pdone;
  // consumer state (every thread)
  int popped;

  __device__ __forceinline__ UnitWalk(S& t, const Geometry& g, int* qi,
                                      int* qcn, T* svn, Acc* sc, Acc* sr)
      : tiles(t), geo(g), qI(qi), qc(qcn), sv(svn), scol(sc), srow(sr),
        pcol(-1), pI(0), pJ(0), pJend(0), pushed(0), knext(0), issued(0),
        pdone(true), popped(0) {}

  // Thread 0: unit k of column pcol becomes the one to issue (queued), or
  // the column ends (false).
  __device__ __forceinline__ bool take(int k) {
    const int I0 = tiles.strip_of(pcol + 1);
    if (k >= Geometry::units_below(geo.S) - Geometry::units_below(I0)) {
      qI[pushed % kQueue] = -1;
      ++pushed;
      pdone = true;
      return false;
    }
    int c;
    geo.unit(k, I0, pI, c);
    qI[pushed % kQueue] = pI;
    qc[pushed % kQueue] = c;
    ++pushed;
    pJ = c * kUnitTiles;
    pJend = min(pJ + kUnitTiles, pI + 1);
    return true;
  }

  // Thread 0: the next tile of column pcol into the ring, taking the next
  // unit when the current one is done (nothing once the column's are).
  // Unit b is block b's; the counter hands out the rest.
  __device__ __forceinline__ void issue_one(const LatrdArgs<T>& g) {
    if (pdone) return;
    if (pJ >= pJend) {
      if (!take(knext)) return;
      knext = static_cast<int>(gridDim.x) + atomicAdd(g.counters + pcol, 1);
    }
    const unsigned s = issued % S::kStages;
    elx::tma::mbar_expect_tx(tiles.full_s + 8 * s, S::kTileBytes);
    elx::tma::tma_load(tiles.ring_s + s * S::kTileBytes, tiles.map,
                       tiles.full_s + 8 * s, tiles.col0 - tiles.d + pJ * kT,
                       tiles.row0 - tiles.d + pI * kT);
    ++issued;
    ++pJ;
  }

  // Thread 0: the walk goes on with column col (its first unit is the
  // block's own).
  __device__ __forceinline__ void reserve(int col) {
    if (threadIdx.x != 0) return;
    pcol = col;
    pdone = false;
    pJ = pJend = 0;
    knext = blockIdx.x;
  }

  // Thread 0: start the reserved column's walk, kStages tiles ahead.
  __device__ __forceinline__ void start(const LatrdArgs<T>& g) {
    if (threadIdx.x != 0) return;
    for (int k = 0; k < S::kStages; ++k) issue_one(g);
  }

  // Row sums of strip I over the unit's tiles (rowacc of the thread's 16
  // rows over its column) reduced over the 64 columns, into rowpart.
  __device__ __forceinline__ void flush(Acc (&rowacc)[kGR], int I, int c,
                                        const LatrdArgs<T>& g) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    elx::warp_row_sums(rowacc, lane);
    if (lane < kGR) srow[warp * kGR + lane] = rowacc[0];
    __syncthreads();
    if (tid < kT) {
      const int gg = tid / kGR, l = tid % kGR;
      g.rowpart[(static_cast<long long>(I) * geo.maxc + c) * kT + tid] =
          srow[2 * gg * kGR + l] + srow[(2 * gg + 1) * kGR + l];
    }
  }

  // Every thread: the units of the started column through the ring; v(r)
  // gives the reflector at global row r.
  template <typename VecAt>
  __device__ __forceinline__ void run(const LatrdArgs<T>& g, const VecAt& v) {
    const int tid = threadIdx.x, c = tid % kT, gi = tid / kT;
    const int n = tiles.n, d = tiles.d, vec0 = tiles.row0;
    bool pre = false;  // sv holds this unit's v rows
    for (;;) {
      const int I = qI[popped % kQueue];
      if (I < 0) {
        ++popped;
        return;
      }
      const int cu = qc[popped % kQueue];
      ++popped;
      Acc rowacc[kGR];
      T vi[kGR];
#pragma unroll
      for (int i = 0; i < kGR; ++i) {
        const int r = I * kT - d + gi * kGR + i;
        vi[i] = pre ? sv[gi * kGR + i]
                    : (r >= 0 && r < n ? v(vec0 + r) : T(0));
        rowacc[i] = 0;
      }
      const int J1 = min((cu + 1) * kUnitTiles, I + 1);
      int In = -1;  // the next unit's strip
      T vnext = T(0);
      for (int J = cu * kUnitTiles; J < J1; ++J) {
        if (kPrefetchV && J == J1 - 1) {
          In = qI[popped % kQueue];
          const int r = In * kT - d + tid;
          if (In >= 0 && tid < kT && r >= 0 && r < n) vnext = v(vec0 + r);
        }
        const int cj = J * kT - d + c;
        const bool col_in = cj >= 0 && cj < n;
        const Acc vj = col_in ? Acc(v(vec0 + cj)) : Acc(0);
        const unsigned s = tiles.used % S::kStages;
        elx::tma::mbar_wait(tiles.full_s + 8 * s,
                            (tiles.used / S::kStages) & 1u);
        const T* tile = tiles.ring + s * (kT * kT) + gi * kGR * kT + c;
        Acc colp = 0;
        if (I != J && !(d && J == 0)) {
#pragma unroll
          for (int i = 0; i < kGR; ++i) {
            const Acc x = tile[i * kT];
            rowacc[i] = fma(x, vj, rowacc[i]);
            colp = fma(x, Acc(vi[i]), colp);
          }
        } else {
          // the diagonal (c <= r for row sums, c < r for column sums) and
          // the local rows and columns below 0 (strip 0, column block 0),
          // selected, never multiplied by 0
          const bool diag = I == J;
          const int rlo = I == 0 ? d : 0;
          const bool cok = !(J == 0 && c < d);
#pragma unroll
          for (int i = 0; i < kGR; ++i) {
            const int r = gi * kGR + i;
            const Acc x = tile[i * kT];
            const bool in = cok && r >= rlo;
            rowacc[i] = fma(in && (!diag || c <= r) ? x : Acc(0), vj,
                            rowacc[i]);
            colp = fma(in && (!diag || c < r) ? x : Acc(0), Acc(vi[i]), colp);
          }
        }
        Acc* sc = scol + (tiles.used & 1u) * (kGroups * kT);
        sc[gi * kT + c] = colp;
        __syncthreads();  // stage s read by all; column partials written
        if (tid == 0) issue_one(g);
        if (gi == 0)
          g.colpart[Geometry::tile(I, J) * kT + c] =
              (sc[c] + sc[kT + c]) + (sc[2 * kT + c] + sc[3 * kT + c]);
        ++tiles.used;
      }
      if (kPrefetchV && tid < kT) sv[tid] = vnext;
      pre = kPrefetchV && In >= 0;
      flush(rowacc, I, cu, g);  // its barrier also publishes sv
    }
  }
};

// Two blocks an SM in float32 (128 registers a thread); float64 takes one.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kBlocksPerSM : 1)
    latrd_kernel(const __grid_constant__ CUtensorMap map, LatrdArgs<T> g) {
  extern __shared__ uint8_t smem[];
  __shared__ Acc red[kWarps];
  __shared__ T sVg[kMaxNB], sWg[kMaxNB];
  __shared__ Acc sdots[2 * kMaxNB];
  __shared__ Acc spart[kWarps][2 * kMaxNB];
  __shared__ Acc sy[kPhases][32];
  __shared__ Acc ys[32];
  __shared__ Acc wscol[2 * kGroups * kT], wsrow[kWarps * kGR];
  __shared__ int qI[kQueue], qc[kQueue];
  __shared__ T sv[kT];
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x, b = blockIdx.x;
  const int M = g.M, k0 = g.k0, m0 = M - k0;
  // the own rows [rb, re)
  const int R = (m0 + G - 1) / G;
  const int rb = min(M, k0 + b * R), re = min(M, rb + R);
  elx::SymvTiles<T> tiles(smem, &map, k0, k0, m0);
  Geometry geo;
  geo.S = tiles.strips();
  geo.maxc = (geo.S + kUnitTiles - 1) / kUnitTiles;
  geo.d = tiles.d;
  UnitWalk<T> walker(tiles, geo, qI, qc, sv, wscol, wsrow);
  __syncthreads();  // the ring's barriers
  walker.reserve(0);
  walker.start(g);
  Acc coef = 0;  // the previous column's tau/2 v^T p
  Reflector<T> h{};

  for (int jl = 0; jl < g.w; ++jl) {
    const int gj = k0 + jl, gp = gj + 1;
    ELX_PHASE(0);

    // ---- 1. the previous column's w; acur on the own rows; partials.
    // Every load of the phase is issued first: the v^T p partials, W's and
    // V's row gj, each warp's rows.
    Acc pvp_part = 0;
    T vg = T(0), pgj = T(0), wg = T(0);
    if (jl > 0) {
      for (int bb = tid; bb < G; bb += kThreads) pvp_part += __ldcg(g.pvp + bb);
      if (tid < jl) {
        const long long off = static_cast<long long>(gj) * kMaxNB + tid;
        vg = __ldcg(g.Vr + off);
        // row gj is the previous column's pivot row: its w is p(gj) -
        // coef v(gj), v(gj) = 1, as its owner forms it below
        if (tid == jl - 1)
          pgj = __ldcg(g.pbuf + gj);
        else
          wg = __ldcg(g.Wr + off);
      }
    }
    Acc sig = 0;
    Acc pw[kLane], pv[kLane];
#pragma unroll
    for (int i = 0; i < kLane; ++i) pw[i] = pv[i] = 0;
    // the same number of batches in every warp of the block (at least one,
    // whose loads go out before coef is formed)
    const int batches =
        max(1, (re - rb + kBatch * kWarps - 1) / (kBatch * kWarps));
    for (int it = 0; it < batches; ++it) {
      const int r0 = rb + warp + it * kBatch * kWarps;
      T vr[kBatch][kLane], wr[kBatch][kLane], x[kBatch], pr[kBatch];
      T vprev[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = min(r0 + k * kWarps, re - 1);
        load_row(vr[k], g.Vr, r, lane);
        load_row(wr[k], g.Wr, r, lane);
        x[k] = r >= gj ? g.a[static_cast<long long>(r) * g.lda + gj]
                       : g.a[static_cast<long long>(gj) * g.lda + r];
        pr[k] = jl > 0 ? __ldcg(g.pbuf + r) : T(0);
        vprev[k] = jl > 0 ? h.v(r) : T(0);
      }
      if (it == 0) {
        // coef and the rows gj, once the block's loads are out
        if (jl > 0) coef = h.tau * 0.5 * partials_sum(pvp_part, red);
        if (tid < jl) {
          sVg[tid] = vg;
          sWg[tid] = tid == jl - 1 ? T(fma(-coef, Acc(1), Acc(pgj))) : wg;
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = r0 + k * kWarps;
        if (r >= re) break;
        if (jl > 0) {
          // w of column jl - 1 at row r
          const T wprev = T(fma(-coef, Acc(vprev[k]), Acc(pr[k])));
#pragma unroll
          for (int i = 0; i < kLane; ++i)
            if (kLane * lane + i == jl - 1) wr[k][i] = wprev;
          if (lane == 0) {
            g.Wt[static_cast<long long>(jl - 1) * M + r] = wprev;
            g.Wr[static_cast<long long>(r) * kMaxNB + jl - 1] = wprev;
          }
        }
        const T ac = T(Acc(x[k]) - row_dot(vr[k], wr[k], sWg, sVg, lane, jl));
        if (lane == 0) g.acur[r] = ac;
        if (r > gp) {
          sig = fma(Acc(ac), Acc(ac), sig);
#pragma unroll
          for (int i = 0; i < kLane; ++i) {
            pw[i] = fma(Acc(wr[k][i]), Acc(ac), pw[i]);
            pv[i] = fma(Acc(vr[k][i]), Acc(ac), pv[i]);
          }
        }
      }
    }
    // the block's partials, summed over its warps in order
#pragma unroll
    for (int i = 0; i < kLane; ++i) {
      spart[warp][kLane * lane + i] = pw[i];
      spart[warp][kMaxNB + kLane * lane + i] = pv[i];
    }
    __syncthreads();  // red (coef) read by all; spart written
    if (lane == 0) red[warp] = sig;
    __syncthreads();
    {
      Acc s = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += spart[k][tid];
      g.pdots[static_cast<long long>(b) * 2 * kMaxNB + tid] = s;
      if (tid == 0) {
        Acc t = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) t += red[k];
        g.pnorm[b] = t;
      }
    }
    ELX_PHASE(1);
    grid.sync();
    ELX_PHASE(2);

    // ---- 2. reflector; panel dots; the symv
    {
      Acc part = 0;
      for (int bb = tid; bb < G; bb += kThreads) part += __ldcg(g.pnorm + bb);
      const Acc alpha = __ldcg(g.acur + gp);
      const Acc sigma2 = partials_sum(part, red);
      const Acc norm = sqrt(alpha * alpha + sigma2);
      const Acc beta0 = alpha < 0 ? norm : -norm;
      const bool trivial = sigma2 == 0;
      h.gp = gp;
      h.acur = g.acur;
      h.denom = trivial ? Acc(1) : alpha - beta0;
      h.tau = trivial ? Acc(0) : (beta0 - alpha) / (beta0 == 0 ? Acc(1) : beta0);
      h.beta = T(trivial ? alpha : beta0);
    }
    if (b == 0 && tid == 0) g.tau[jl] = T(h.tau);
    // panel dot e (W^T v for e < jl, V^T v above): the G partials of
    // X^T acur below gp in block order, over the denominator, plus X's row
    // gp (v is 1 there)
    if (warp == 0) {
      for (int e = b; e < 2 * jl; e += G) {
        const int slot = e < jl ? e : kMaxNB + e - jl;
        const T* X = e < jl ? g.Wr : g.Vr;
        const Acc xgp =
            __ldcg(X + static_cast<long long>(gp) * kMaxNB + slot % kMaxNB);
        Acc s = 0;
        for (int bb = lane; bb < G; bb += 32)
          s += __ldcg(g.pdots + static_cast<long long>(bb) * 2 * kMaxNB +
                      slot);
        s = warp_sum(s);
        if (lane == 0) g.dots[slot] = s / h.denom + xgp;
      }
    }
    ELX_PHASE(3);
    walker.run(g, [&h](int r) { return h.v(r); });
    if (jl + 1 < g.w) {
      // the next column's first tiles load across the barrier
      walker.reserve(jl + 1);
      walker.start(g);
    }
    ELX_PHASE(4);
    grid.sync();
    ELX_PHASE(5);

    // ---- 3. V and P, y and p on the own rows, 32 rows at a time: warp
    // q sums phase q of the group's y, then p of rows g0 + q + 8 k
    const int I0 = tiles.strip_of(jl + 1);
    if (tid < jl) {
      sdots[tid] = __ldcg(g.dots + tid);
      sdots[kMaxNB + tid] = __ldcg(g.dots + kMaxNB + tid);
    }
    ELX_PHASE(6);
    Acc part = 0;
    for (int g0 = rb; g0 < re; g0 += 32) {
      T vr[kBatch][kLane], wr[kBatch][kLane], ac[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = min(g0 + warp + k * kWarps, re - 1);
        load_row(vr[k], g.Vr, r, lane);
        load_row(wr[k], g.Wr, r, lane);
        ac[k] = __ldcg(g.acur + r);
      }
      const int ry = g0 + lane;
      sy[warp][lane] = ry < re ? y_phase(g, geo, ry - k0, I0, warp) : Acc(0);
      __syncthreads();
      if (tid < 32) {
        Acc y = sy[0][tid];
#pragma unroll
        for (int q = 1; q < kPhases; ++q) y += sy[q][tid];
        ys[tid] = y;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = g0 + warp + k * kWarps;
        if (r >= re) break;
        const T v = r > gp ? T(Acc(ac[k]) / h.denom) : (r == gp ? T(1) : T(0));
        const T p = T(h.tau * (ys[r - g0] - row_dot(vr[k], wr[k], sdots,
                                                    sdots + kMaxNB, lane,
                                                    jl)));
        if (lane == 0) {
          g.pbuf[r] = p;
          g.Vr[static_cast<long long>(r) * kMaxNB + jl] = v;
          g.Pt[static_cast<long long>(jl) * M + r] =
              r > gp ? v : (r == gp ? h.beta : ac[k]);
        }
        part = fma(Acc(v), Acc(p), part);
      }
      __syncthreads();  // ys and sy reused by the next group
    }
    ELX_PHASE(7);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      Acc t = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) t += red[k];
      g.pvp[b] = t;
    }
    ELX_PHASE(8);
    grid.sync();
    ELX_PHASE(9);
  }

  // ---- the last column's w on the own rows
  Acc pvp_part = 0;
  for (int bb = tid; bb < G; bb += kThreads) pvp_part += __ldcg(g.pvp + bb);
  const Acc c_last = h.tau * 0.5 * partials_sum(pvp_part, red);
  for (int r = rb + tid; r < re; r += kThreads)
    g.Wt[static_cast<long long>(g.w - 1) * M + r] =
        T(fma(-c_last, Acc(h.v(r)), Acc(__ldcg(g.pbuf + r))));
}

template <typename T>
cudaError_t grid_size(int* out) {
  constexpr int smem = elx::SymvTiles<T>::kSmemBytes;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      latrd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, latrd_kernel<T>, kThreads, smem));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(LatrdArgs<T> g, int grid, cudaStream_t st) {
  constexpr int elem = sizeof(T);
  if (reinterpret_cast<uintptr_t>(g.a) % 16 || (g.lda * elem) % 16 ||
      g.lda < g.M)
    return cudaErrorInvalidValue;
  int want = 0;
  ELX_RETURN_IF_ERROR(grid_size<T>(&want));
  if (grid != want) return cudaErrorInvalidValue;
  CUtensorMap map;
  ELX_RETURN_IF_ERROR(elx::tma::make_map(
      &map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      elem, g.a, g.M, g.M, g.lda, elx::kSymvT, elx::kSymvT,
      CU_TENSOR_MAP_SWIZZLE_NONE));
  void* args[] = {&map, &g};
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(latrd_kernel<T>), dim3(grid), dim3(kThreads),
      args, elx::SymvTiles<T>::kSmemBytes, st));
  return cudaGetLastError();
}

}  // namespace

#ifdef ELX_LATRD_PROBE
// The probe's stamp buffer, (grid, w, kProbeStamps) long longs, and the
// segment labels.
extern "C" int elx_latrd_probe_set(void* stamps) {
  return cudaMemcpyToSymbol(elx_latrd_stamps, &stamps, sizeof(stamps));
}
extern "C" int elx_latrd_probe_stamps() { return kProbeStamps; }
extern "C" const char* elx_latrd_probe_labels() { return kProbeLabels; }
#endif

// Blocks of the cooperative launch; the caller sizes the scratch with it.
extern "C" int elx_latrd_grid(int dtype, int* grid) {
  if (dtype == 0) return grid_size<float>(grid);
  if (dtype == 1) return grid_size<double>(grid);
  return cudaErrorInvalidValue;
}

// dtype: 0 float, 1 double. a: (M, M), row stride lda (a multiple of 16
// bytes, a 16-byte aligned base: the TMA reads it). Pt, Wt: (nb, M),
// zeroed by the caller; Vr, Wr: (M, 128), 16-byte aligned; tau: (nb,)
// zeroed; acur, pbuf: (M); float64 sums: colpart S (S + 1) / 2 x 64 and
// rowpart S x ceil(S / 4) x 64, S = ceil((M - k0 + d) / 64), d = k0 mod
// (16 / element size); pnorm, pvp: (grid); pdots: (grid, 256); dots:
// (256); counters: (w) ints, zeroed. Needs 0 <= k0, w <= nb <= 128,
// k0 + w <= M - 2.
extern "C" int elx_latrd_panel(int dtype, int M, int k0, int w, int nb,
                               const void* a, long long lda, void* Pt,
                               void* Wt, void* Vr, void* Wr, void* tau,
                               void* acur, void* pbuf,
                               void* colpart, void* rowpart, void* pnorm,
                               void* pdots, void* dots, void* pvp,
                               void* counters, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || k0 < 0 || w < 0 || nb <= 0 || nb > kMaxNB || w > nb ||
      k0 + w > M - 2 || grid <= 0)
    return cudaErrorInvalidValue;
  if (w == 0) return cudaSuccess;
#define ELX_LATRD_ARGS(T)                                                \
  LatrdArgs<T> {                                                         \
    static_cast<const T*>(a), lda, M, k0, w, nb, static_cast<T*>(Pt),    \
        static_cast<T*>(Wt), static_cast<T*>(Vr), static_cast<T*>(Wr),   \
        static_cast<T*>(tau), static_cast<T*>(acur), static_cast<T*>(pbuf), \
        static_cast<Acc*>(colpart), static_cast<Acc*>(rowpart),          \
        static_cast<Acc*>(pnorm), static_cast<Acc*>(pdots),              \
        static_cast<Acc*>(dots), static_cast<Acc*>(pvp),                 \
        static_cast<int*>(counters)                                      \
  }
  if (dtype == 0) return launch<float>(ELX_LATRD_ARGS(float), grid, st);
  if (dtype == 1) return launch<double>(ELX_LATRD_ARGS(double), grid, st);
#undef ELX_LATRD_ARGS
  return cudaErrorInvalidValue;
}
