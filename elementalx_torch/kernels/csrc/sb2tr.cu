// K6: band -> tridiagonal bulge chase (stage 2 of the SBR reduction).
//
//   A: (n, n) row-major, symmetric with bandwidth b, lower triangle read
//   and updated in place; vout: (n, smax, b), vout[j, s] = [tau | v[1:]]
//
// The chase runs the ops of elementalx/lapack/sbr.py:_sb2tr_dense in its
// windows (each op is _chase_house then _chase_apply there). Sweep j, op
// s (s < n_j, n_j = min(max(1, ceil((n-2-j)/b) + 1), smax)) works on the
// window W = [r0, r0 + b), r0 = j + 1 + s b, eliminating column ce (j at
// s = 0, r0 - b after):
//   x = A[W, ce]; (v, tau, beta) = householder(x)       (zero tail: tau = 0)
//   L1 = A[W, r0-b : r0]    := (I - tau v v^T) L1; column ce := [beta, 0..]
//   S  = A[W, W]            := H S H = S - v w^T - w v^T,
//                              w = tau (S v - (tau/2) (v^T S v) v)
//   B  = A[r0+b : r0+2b, W] := B (I - tau v v^T)
// Everything else of the window's rows and columns is zero at op time.
// Rows at or past n read as zero and are never written (the dense
// reference's zero padding).
//
// Replaces the TPU kernel elementalx/kernels/sb2tr.py:sb2tr (body
// _sb2tr_kernel). That design keeps the whole band in VMEM (~41 MB at
// n=8192, b=256) in a pre-shifted store and chases an 8x8 ring of b x b
// blocks in one core's sequential grid. On the H100 the matrix stays in
// global memory in its plain dense layout (the band, n x 3b, fits in the
// 50 MB L2) and the sweeps run side by side on the SMs.
//
// Which op waits for which. Op (j, s) touches the entries with one index
// in W and the other in [r0-b, r0+2b). Against sweep j-1 that region
// meets op (j-1, s+1) in many entries, op (j-1, s+2) in one entry and its
// mirror, A[r0+2b-1, r0+b-1] (B's last row and column here, the head of
// the eliminated column there, where it becomes beta), and no later op.
// So op (j, s) starts once sweep j-1 has finished ops 0..s+1 (a lag of
// two ops; tests/test_torch_eig.py replays the chase in that order and
// gets _sb2tr_dense's bits), and only B's corner waits for op (j-1, s+2)
// to publish its beta. Sweep j-k then runs at least 2k ops behind sweep j.
// The critical path is about 2n ops (3n at the lag of three of the first
// design).
//
// Route "cluster" (this design). One cluster of C CTAs per sweep in
// flight (C = 8 at b = 256, 4 at b = 128: kernels/sb2tr.py:cluster_size).
// CTA q owns rows [q R, q R + R) of the window, R = ceil(b / C), and keeps
// its rows of L1, S and B in shared memory (3 R b words: 96 KB at b = 256
// in float32, 192 KB in float64). An op:
//   1. loads its rows of S and B from L2 (L1 too at s = 0: after that,
//      op (j, s+1)'s L1 is op (j, s)'s B, which stays on chip), many
//      loads in flight a thread;
//   2. cluster barrier; one thread of every CTA reads the partial sums of
//      |x[1:]|^2 from its peers' shared memory (DSMEM) in rank order, every
//      thread one entry of x, and every CTA forms the same (v, tau, beta); CTA 0 writes beta to the head of
//      column ce and publishes it (heads[j] = s + 1, a release store);
//   3. from shared memory: column partials v^T L1 and strictly-lower(S)^T
//      v over its rows, row sums lower(S) v and z = B v; B's corner row
//      first waits for op (j-1, s+2)'s beta and reads it from L2;
//   4. cluster barrier; every CTA sums the partials of all CTAs in rank
//      order (DSMEM), so every CTA holds the same y1 = v^T L1, u = S v,
//      w; the three blocks are updated in shared memory;
//   5. L1 and S go back to global memory (sweep j+1 reads them), vout's
//      record is written, and each CTA adds one to progress[j] (after a
//      CTA barrier, one thread's fence and release add): op s is done
//      when all C have.
// Sweeps are handed out in order by an atomic counter, so a cluster only
// ever waits for a sweep that a running cluster took: no spin can wait
// for a cluster that is not resident. The grid holds at most the clusters
// cudaOccupancyMaxActiveClusters reports. No float atomics: every sum has
// a fixed order (rank order across the cluster), so a run repeats bit for
// bit and every CTA computes the same scalars.
//
// What bounds it: the chain of about 2n dependent ops, each a few
// microseconds of loads from L2, three barriers and two DSMEM exchanges;
// the FMA work of an op (8 b^2 operations) is a fraction of a microsecond
// on C SMs. At b = 256 about 16 sweeps of 8 CTAs are in flight: the
// card's 132 SMs.
//
// Route "l2" (the first design), kept for bands whose 3 R b words do not
// fit in shared memory even with 16 CTAs a cluster (float64 from b of
// about 400): one 1024-thread block per sweep in a cooperative launch,
// every pass over the three blocks a dependent load from L2, a lag of
// three ops.
#include <cuda_runtime.h>

#include "cluster.cuh"

#ifndef ELX_SB2TR_LAG
#define ELX_SB2TR_LAG 2  // 3: the first design's lag, for the probe
#endif

namespace {

namespace cg = cooperative_groups;
using elx::cluster::add_release;
using elx::cluster::ld_acquire;
using elx::cluster::st_release;
using elx::cluster::wait_at_least;

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// Ops in sweep j.
__device__ __forceinline__ int sweep_ops(int n, int b, int smax, int j) {
  const int s = max(1, (n - 2 - j + b - 1) / b + 1);
  return min(s, smax);
}

// Sum over a block of kW warps; every thread gets the same value (fixed
// order).
template <int kW, typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = T(0);
  for (int k = 0; k < kW; ++k) s += red[k];
  return s;
}

// ===== route "cluster" =====================================================

constexpr int kCT = 512;  // threads of a cluster CTA
constexpr int kCW = kCT / 32;

template <typename T>
struct ClusterArgs {
  T* A;           // (n, n) row-major
  int n, b, smax;
  T* vout;        // (n, smax, b), zeroed by the caller
  int* progress;  // (n,) CTAs x finished ops per sweep, zeroed
  int* heads;     // (n,) ops per sweep whose beta is published, zeroed
  int* next;      // (1,) the next sweep to hand out, zeroed
  int rows;       // R: window rows per CTA
};

// Dynamic shared memory of a cluster CTA: 16 bytes for the sweep index,
// then three R x b blocks, six b-vectors, two R-vectors and the scalars.
template <typename T>
size_t cluster_smem(int b, int rows) {
  return 16 + sizeof(T) * (3ull * rows * b + 6ull * b + 2ull * rows + 3 +
                           kCW);
}

// Sum over the cluster's CTAs of the value at p in each one's shared
// memory, in rank order; the loads go out kG at a time (DSMEM latency is
// paid once a group, not once a CTA).
template <typename T>
__device__ __forceinline__ T rank_sum(cg::cluster_group& cl, T* p, int C) {
  constexpr int kG = 8;
  T sum = T(0);
  for (int r0 = 0; r0 < C; r0 += kG) {
    T x[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i)
      x[i] = r0 + i < C ? *cl.map_shared_rank(p, r0 + i) : T(0);
#pragma unroll
    for (int i = 0; i < kG; ++i)
      if (r0 + i < C) sum += x[i];
  }
  return sum;
}

// A thread's share of an nr x b block of a CTA: the rows li0, li0 + dr,
// ... below nr, each at the columns c0, c0 + dc, ... below b. Consecutive
// threads take consecutive columns (coalesced rows in global memory,
// conflict-free rows in shared memory), and no loop divides by b.
struct Share {
  int li0, dr, c0, dc;
  __device__ Share(int b) {
    const int t = threadIdx.x;
    dr = b <= kCT ? kCT / b : 1;
    li0 = b <= kCT ? t / b : 0;
    c0 = b <= kCT ? t % b : t;
    dc = b <= kCT ? b : kCT;
  }
  // fn(li, c) over the share; li0 >= dr for the threads left over when b
  // does not divide kCT
  template <typename Fn>
  __device__ __forceinline__ void each(int nr, int b, Fn fn) const {
    if (li0 >= dr) return;
    for (int li = li0; li < nr; li += dr)
      for (int c = c0; c < b; c += dc) fn(li, c);
  }
};

// Rows [row0, row0 + nr) x columns [col0, col0 + b) of A into dst (row
// stride b), entry (li, c) where ok(li, c) and the row is below n, else
// zero. kU rows in flight a thread before any store.
template <typename T, typename Ok>
__device__ __forceinline__ void load_rows(const Share& sh, T* dst,
                                          const T* A, int n, int row0,
                                          int nr, int col0, int b, Ok ok) {
  constexpr int kU = 16;
  if (sh.li0 >= sh.dr) return;
  for (int c = sh.c0; c < b; c += sh.dc) {
    for (int li0 = sh.li0; li0 < nr; li0 += kU * sh.dr) {
      T t[kU];
#pragma unroll
      for (int x = 0; x < kU; ++x) {
        const int li = li0 + x * sh.dr;
        t[x] = (li < nr && row0 + li < n && ok(li, c))
                   ? __ldcg(A + static_cast<long long>(row0 + li) * n +
                            col0 + c)
                   : T(0);
      }
#pragma unroll
      for (int x = 0; x < kU; ++x) {
        const int li = li0 + x * sh.dr;
        if (li < nr) dst[li * b + c] = t[x];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCT) chase_cluster(ClusterArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int q = static_cast<int>(cl.block_rank());
  const int n = g.n, b = g.b, R = g.rows, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int* slot = reinterpret_cast<int*>(smem_raw);
  T* buf = reinterpret_cast<T*>(smem_raw + 16);  // three R x b blocks
  T* v = buf + 3 * R * b;  // reflector, v[0] = 1 (every CTA, all b)
  T* y1 = v + b;           // v^T L1
  T* u = y1 + b;           // S v
  T* w = u + b;            // rank-2 vector of S
  T* ypart = w + b;        // this CTA's rows' share of v^T L1 (DSMEM)
  T* lpart = ypart + b;    // its share of strictly-lower(S)^T v (DSMEM)
  T* rsum = lpart + b;     // lower(S) v of its rows (DSMEM)
  T* z = rsum + R;         // B v of its rows
  T* sig = z + R;          // its share of |x[1:]|^2 (DSMEM); then the
                           // cluster's sigma^2 and alpha
  T* red = sig + 3;
  const int g0 = q * R;                   // its first window row
  const int nr = max(0, min(R, b - g0));  // rows it owns
  const Share sh(b);
  T* A = g.A;

  for (;;) {
    if (q == 0 && tid == 0) *slot = atomicAdd(g.next, 1);
    cl.sync();
    const int j = *cl.map_shared_rank(slot, 0);
    if (j >= n - 2) break;
    const int nops = sweep_ops(n, b, g.smax, j);
    const int prev_ops = j > 0 ? sweep_ops(n, b, g.smax, j - 1) : 0;
    int k = 0;  // rotation of the three blocks: B becomes the next L1
    for (int s = 0; s < nops; ++s, k += 2) {
      T* L1 = buf + (k % 3) * R * b;
      T* S = buf + ((k + 1) % 3) * R * b;
      T* B = buf + ((k + 2) % 3) * R * b;
      const int r0 = j + 1 + s * b;
      const int l0 = r0 - b;
      const int ce = s == 0 ? j : l0;
      const int cx = ce - l0;  // x's column in L1
      if (j > 0) {
        if (tid == 0)
          wait_at_least(g.progress + j - 1,
                        C * min(s + ELX_SB2TR_LAG, prev_ops));
        __syncthreads();
      }

      // ---- 1. this CTA's rows of the window
      if (s == 0)
        load_rows(sh, L1, A, n, r0 + g0, nr, l0, b,
                  [&](int, int c) { return l0 + c >= 0; });
      load_rows(sh, S, A, n, r0 + g0, nr, r0, b,
                [&](int li, int c) { return c <= g0 + li; });
      load_rows(sh, B, A, n, r0 + b + g0, nr, r0, b,
                [&](int, int) { return true; });
      __syncthreads();

      // ---- 2. Householder of x = L1[:, cx] across the cluster
      T part = T(0);
      for (int li = tid; li < nr; li += kCT)
        if (g0 + li > 0) part += L1[li * b + cx] * L1[li * b + cx];
      part = block_sum<kCW>(part, red);
      if (tid == 0) sig[0] = part;
      cl.sync();
      if (tid == 0) {  // the cluster's sum in rank order, read once
        sig[1] = rank_sum(cl, sig, C);
        sig[2] = *cl.map_shared_rank(L1 + cx, 0);
      }
      __syncthreads();
      const T sigma2 = sig[1], alpha = sig[2];
      const T norm = sqrt(alpha * alpha + sigma2);
      const T beta0 = alpha < T(0) ? norm : -norm;
      const bool trivial = sigma2 == T(0);
      const T denom = trivial ? T(1) : alpha - beta0;
      const T tau =
          trivial ? T(0) : (beta0 - alpha) / (beta0 == T(0) ? T(1) : beta0);
      const T beta = trivial ? alpha : beta0;
      for (int i = tid; i < b; i += kCT) {
        const int r = i / R;
        const T x = *cl.map_shared_rank(L1 + (i - r * R) * b + cx, r);
        v[i] = i == 0 ? T(1) : (trivial ? T(0) : x / denom);
      }
      if (q == 0 && tid == 0) {
        if (r0 < n) A[static_cast<long long>(r0) * n + ce] = beta;
        st_release(g.heads + j, s + 1);
      }
      __syncthreads();

      // ---- 3. partial sums over this CTA's rows
      for (int c = tid; c < b; c += kCT) {
        T sy = T(0), sl = T(0);
        const bool lcol = l0 + c >= 0;
        for (int li = 0; li < nr; ++li) {
          const T vi = v[g0 + li];
          if (lcol) sy += vi * L1[li * b + c];
          if (g0 + li > c) sl += vi * S[li * b + c];
        }
        ypart[c] = sy;
        lpart[c] = sl;
      }
      // B's corner A[r0+2b-1, r0+b-1] is op (j-1, s+2)'s beta
      const bool corner = ELX_SB2TR_LAG == 2 && j > 0 && s + 2 < prev_ops &&
                          r0 + 2 * b - 1 < n;
      for (int t = warp; t < 2 * nr; t += kCW) {
        const bool srow = t < nr;
        const int li = srow ? t : t - nr;
        const int gi = g0 + li;
        T* row = (srow ? S : B) + li * b;
        if (!srow && gi == b - 1 && corner) {
          if (lane == 0) {
            wait_at_least(g.heads + j - 1, s + 3);
            row[b - 1] = __ldcg(
                A + static_cast<long long>(r0 + 2 * b - 1) * n + r0 + b - 1);
          }
          __syncwarp();
        }
        const int kend = srow ? gi + 1 : b;
        T acc = T(0);
        for (int kk = lane; kk < kend; kk += 32) acc += row[kk] * v[kk];
        for (int o = 16; o > 0; o /= 2)
          acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) (srow ? rsum : z)[li] = acc;
      }
      __syncthreads();
      cl.sync();

      // ---- 4. the cluster's sums in rank order, then the updates
      for (int c = tid; c < b; c += kCT) {
        const int owner = c / R;
        const T ru = cl.map_shared_rank(rsum, owner)[c - owner * R];
        y1[c] = rank_sum(cl, ypart + c, C);
        u[c] = ru + rank_sum(cl, lpart + c, C);
      }
      __syncthreads();
      part = T(0);
      for (int i = tid; i < b; i += kCT) part += v[i] * u[i];
      const T coef = tau * T(0.5) * block_sum<kCW>(part, red);
      for (int i = tid; i < b; i += kCT) w[i] = tau * (u[i] - coef * v[i]);
      __syncthreads();
      sh.each(nr, b, [&](int li, int c) {
        const int e = li * b + c, gi = g0 + li;
        if (l0 + c >= 0)
          L1[e] = c == cx ? (gi == 0 ? beta : T(0))
                          : L1[e] - tau * v[gi] * y1[c];
        if (c <= gi) S[e] = S[e] - (v[gi] * w[c] + w[gi] * v[c]);
        B[e] = B[e] - tau * z[li] * v[c];
      });
      __syncthreads();

      // ---- 5. L1 and S back to global memory (B too after the last op)
      const bool last = s + 1 == nops;
      sh.each(nr, b, [&](int li, int c) {
        const int e = li * b + c;
        const long long row = r0 + g0 + li;
        if (row < n) {
          if (l0 + c >= 0) A[row * n + l0 + c] = L1[e];
          if (c <= g0 + li) A[row * n + r0 + c] = S[e];
        }
        if (last && row + b < n) A[(row + b) * n + r0 + c] = B[e];
      });
      T* rec = g.vout + (static_cast<long long>(j) * g.smax + s) * b;
      for (int li = tid; li < nr; li += kCT)
        rec[g0 + li] = g0 + li == 0 ? tau : v[g0 + li];
      // the CTA's writes, then one release at gpu scope (the barrier
      // orders them before thread 0's fence and add)
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        add_release(g.progress + j, 1);
      }
    }
  }
  cl.sync();  // no CTA leaves while a peer may read its shared memory
}

template <typename T>
cudaError_t launch_cluster(ClusterArgs<T> g, int csize, cudaStream_t st) {
  if (g.n <= 2) return cudaSuccess;
  const size_t smem = cluster_smem<T>(g.b, g.rows);
  int optin = 0;
  ELX_RETURN_IF_ERROR(elx::cluster::smem_optin(&optin));
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  ELX_RETURN_IF_ERROR(elx::cluster::prepare(chase_cluster<T>, csize, smem));
  int most = 0;
  ELX_RETURN_IF_ERROR(
      elx::cluster::max_active(chase_cluster<T>, csize, kCT, smem, &most));
  if (most < 1) return cudaErrorInvalidConfiguration;
  const int clusters = most < g.n - 2 ? most : g.n - 2;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      elx::cluster::config(attr, clusters, csize, kCT, smem, st);
  ELX_RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, chase_cluster<T>, g));
  return cudaGetLastError();
}

// ===== route "l2" (the first design) ======================================

constexpr int kL2Threads = 1024;
constexpr int kL2Warps = kL2Threads / 32;

template <typename T>
struct ChaseArgs {
  T* A;           // (n, n) row-major
  int n, b, smax;
  T* vout;        // (n, smax, b), zeroed by the caller
  int* progress;  // (n,) finished ops per sweep, zeroed by the caller
};

template <typename T>
__global__ void __launch_bounds__(kL2Threads) chase_l2(ChaseArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kL2Warps];
  const int n = g.n, b = g.b, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  T* v = reinterpret_cast<T*>(smem_raw);  // reflector, v[0] = 1
  T* y1 = v + b;                          // v^T L1
  T* u = y1 + b;                          // S v
  T* z = u + b;                           // B v
  T* w = z + b;                           // rank-2 vector of S
  T* colpart = w + b;                     // (2, gcount, b) column partials
  // column sums: thread t takes column t % cw of row group t / cw
  const int cw = b < kL2Threads ? b : kL2Threads;
  const int gcount = b < kL2Threads ? kL2Threads / b : 1;
  const int grp = tid / cw, col0 = tid % cw;

  // A[r, c] of the lower triangle, zero at or past row n
  auto ld = [&](int r, int c) -> T {
    return r < n ? __ldcg(g.A + static_cast<long long>(r) * n + c) : T(0);
  };

  for (int j = blockIdx.x; j < n - 2; j += gridDim.x) {
    const int nops = sweep_ops(n, b, g.smax, j);
    const int prev_ops = j > 0 ? sweep_ops(n, b, g.smax, j - 1) : 0;
    for (int s = 0; s < nops; ++s) {
      const int r0 = j + 1 + s * b;
      const int l0 = r0 - b;
      const int ce = s == 0 ? j : l0;
      if (j > 0) {
        if (tid == 0) {
          const int target = min(s + 3, prev_ops);
          while (ld_acquire(g.progress + j - 1) < target) __nanosleep(100);
        }
        __syncthreads();
      }

      // ---- Householder of x = A[W, ce]
      T part = T(0);
      for (int i = tid; i < b; i += kL2Threads) {
        const T x = ld(r0 + i, ce);
        v[i] = x;
        if (i > 0) part += x * x;
      }
      const T sigma2 = block_sum<kL2Warps>(part, red);  // also publishes v[] (x)
      const T alpha = v[0];
      const T norm = sqrt(alpha * alpha + sigma2);
      const T beta0 = alpha < T(0) ? norm : -norm;
      const bool trivial = sigma2 == T(0);
      const T denom = trivial ? T(1) : alpha - beta0;
      const T tau =
          trivial ? T(0) : (beta0 - alpha) / (beta0 == T(0) ? T(1) : beta0);
      const T beta = trivial ? alpha : beta0;
      __syncthreads();  // every thread has read v[0] as alpha
      for (int i = tid; i < b; i += kL2Threads)
        v[i] = i == 0 ? T(1) : (trivial ? T(0) : v[i] / denom);
      __syncthreads();

      // ---- column sums: y1 = v^T L1, lt = strictly-lower(S)^T v
      {
        T* py = colpart;
        T* pl = colpart + gcount * b;
        if (grp < gcount) {
          for (int c = col0; c < b; c += cw) {
            T sy = T(0), sl = T(0);
            const bool lcol = l0 + c >= 0;
            for (int i = grp; i < b; i += gcount) {
              if (lcol) sy += v[i] * ld(r0 + i, l0 + c);
              if (i > c) sl += v[i] * ld(r0 + i, r0 + c);
            }
            py[grp * b + c] = sy;
            pl[grp * b + c] = sl;
          }
        }
      }
      // ---- row sums (a warp per row): lower(S) v and z = B v
      for (int t = warp; t < 2 * b; t += kL2Warps) {
        const bool srow = t < b;
        const int i = srow ? t : t - b;
        const int r = srow ? r0 + i : r0 + b + i;
        const int kend = srow ? i + 1 : b;
        T acc = T(0);
        for (int k = lane; k < kend; k += 32) acc += ld(r, r0 + k) * v[k];
        for (int o = 16; o > 0; o /= 2)
          acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) (srow ? u : z)[i] = acc;
      }
      __syncthreads();
      for (int c = tid; c < b; c += kL2Threads) {
        T sy = T(0), sl = T(0);
        for (int q = 0; q < gcount; ++q) {
          sy += colpart[q * b + c];
          sl += colpart[(gcount + q) * b + c];
        }
        y1[c] = sy;
        u[c] += sl;
      }
      part = T(0);
      __syncthreads();
      for (int i = tid; i < b; i += kL2Threads) part += v[i] * u[i];
      const T coef = tau * T(0.5) * block_sum<kL2Warps>(part, red);
      for (int i = tid; i < b; i += kL2Threads) w[i] = tau * (u[i] - coef * v[i]);
      __syncthreads();

      // ---- updates of L1 (with the eliminated column), S and B
      for (int e = tid; e < b * b; e += kL2Threads) {
        const int i = e / b, c = e % b;
        const long long row = r0 + i;
        if (row < n) {
          if (l0 + c >= 0) {
            T* p = g.A + row * n + l0 + c;
            *p = l0 + c == ce ? (i == 0 ? beta : T(0))
                              : __ldcg(p) - tau * v[i] * y1[c];
          }
          if (c <= i) {
            T* p = g.A + row * n + r0 + c;
            *p = __ldcg(p) - (v[i] * w[c] + w[i] * v[c]);
          }
        }
        const long long brow = r0 + b + i;
        if (brow < n) {
          T* p = g.A + brow * n + r0 + c;
          *p = __ldcg(p) - tau * z[i] * v[c];
        }
      }
      T* rec = g.vout + (static_cast<long long>(j) * g.smax + s) * b;
      for (int i = tid; i < b; i += kL2Threads) rec[i] = i == 0 ? tau : v[i];
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(g.progress + j, s + 1);
    }
  }
}

template <typename T>
cudaError_t launch_l2(ChaseArgs<T> g, cudaStream_t st) {
  if (g.n <= 2) return cudaSuccess;
  int dev = 0, sms = 0, coop = 0, per_sm = 0, max_smem = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  ELX_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const int gcount = g.b < kL2Threads ? kL2Threads / g.b : 1;
  const size_t smem = static_cast<size_t>(5 + 2 * gcount) * g.b * sizeof(T);
  if (smem + 4096 > static_cast<size_t>(max_smem))
    return cudaErrorInvalidValue;
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      chase_l2<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chase_l2<T>, kL2Threads, smem));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms < g.n - 2 ? sms : g.n - 2;
  void* args[] = {&g};
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chase_l2<T>), dim3(grid), dim3(kL2Threads),
      args, smem, st));
  return cudaGetLastError();
}

}  // namespace

// route: 0 "l2", 1 "cluster" (csize CTAs a cluster, 1..16). dtype: 0
// float, 1 double. A: (n, n) row-major, chased in place (lower
// triangle); vout: (n, smax, b) zeroed; flags: (2n + 1) int32 zeroed.
// Needs b >= 2 and smax >= the largest sweep's op count.
extern "C" int elx_sb2tr(int route, int csize, int dtype, int n, int b,
                         int smax, void* A, void* vout, void* flags,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || b < 2 || smax < 1) return cudaErrorInvalidValue;
  int* fl = static_cast<int*>(flags);
  if (route == 0) {
    if (dtype == 0)
      return launch_l2<float>(ChaseArgs<float>{static_cast<float*>(A), n, b,
                                               smax,
                                               static_cast<float*>(vout), fl},
                              st);
    if (dtype == 1)
      return launch_l2<double>(
          ChaseArgs<double>{static_cast<double*>(A), n, b, smax,
                            static_cast<double*>(vout), fl},
          st);
    return cudaErrorInvalidValue;
  }
  if (route != 1 || csize < 1 || csize > 16) return cudaErrorInvalidValue;
  const int rows = (b + csize - 1) / csize;
  if (dtype == 0)
    return launch_cluster<float>(
        ClusterArgs<float>{static_cast<float*>(A), n, b, smax,
                           static_cast<float*>(vout), fl, fl + n,
                           fl + 2 * n, rows},
        csize, st);
  if (dtype == 1)
    return launch_cluster<double>(
        ClusterArgs<double>{static_cast<double*>(A), n, b, smax,
                            static_cast<double*>(vout), fl, fl + n,
                            fl + 2 * n, rows},
        csize, st);
  return cudaErrorInvalidValue;
}
