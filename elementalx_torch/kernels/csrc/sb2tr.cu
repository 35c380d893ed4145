// K6: band -> tridiagonal bulge chase (stage 2 of the SBR reduction).
//
//   A: (n, n) row-major, symmetric with bandwidth b, lower triangle read
//   and updated in place; vout: (n, smax, b), vout[j, s] = [tau | v[1:]]
//
// The chase runs the ops of elementalx/lapack/sbr.py:_sb2tr_dense in its
// order and windows. Sweep j, op s (s < n_j, n_j = min(max(1,
// ceil((n-2-j)/b) + 1), smax)) works on the window W = [r0, r0 + b),
// r0 = j + 1 + s b, eliminating column ce (j at s = 0, r0 - b after):
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
// blocks in one core's sequential grid. An op touches three b x b blocks,
// 768 KB at b=256 in f32, more than an SM's 227 KB of shared memory; the
// band (n x 3b, about 25 MB) fits in the 50 MB L2. So the matrix stays in
// global memory in its plain dense layout (the layout _sb2tr_dense and
// band_reduce use, no conversion), and the chase is spread over SMs.
//
// Design (b): a pipeline of sweeps. One block per sweep in flight: a
// cooperative launch of one block per SM (so all are resident), block p
// taking sweeps p, p + P, ... in order. Op (j, s) touches rows [r0, r0+2b)
// x columns [r0-b, r0+b). Op (j+1, s') has r0' = r0 + 1 + (s'-s) b and
// overlaps (j, s) exactly when |1 + (s'-s) b| < 2b, i.e. s in {s'-1, s',
// s'+1, s'+2} (b >= 2). So op (j, s) may start once sweep j-1 has finished
// its ops 0..s+2 (or all of them), and no op it overlaps runs beside it:
// (j-1, s+3) and later are disjoint from it, and by induction sweep j-k
// is at least 2k ops ahead. Each sweep publishes its finished-op count in
// progress[j] (a release store after a block barrier); the next sweep's
// block waits on it with an acquire load. No float atomics: every sum has
// a fixed order, so the result does not change from run to run.
//
// What bounds it: the chain of dependent ops (about n^2 / (2b) of them)
// with only about n_j / 3 sweeps in flight, each op a few passes over
// 3 b^2 words of L2. What it gives up: shared-memory blocking of the
// window, overlap of one op's Householder with the previous op's update,
// and more than one block per sweep.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
struct ChaseArgs {
  T* A;           // (n, n) row-major
  int n, b, smax;
  T* vout;        // (n, smax, b), zeroed by the caller
  int* progress;  // (n,) finished ops per sweep, zeroed by the caller
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Ops in sweep j.
__device__ __forceinline__ int sweep_ops(int n, int b, int smax, int j) {
  const int s = max(1, (n - 2 - j + b - 1) / b + 1);
  return min(s, smax);
}

// Sum over the block; every thread gets the same value (fixed order).
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = T(0);
  for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chase_kernel(ChaseArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kWarps];
  const int n = g.n, b = g.b, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  T* v = reinterpret_cast<T*>(smem_raw);  // reflector, v[0] = 1
  T* y1 = v + b;                          // v^T L1
  T* u = y1 + b;                          // S v
  T* z = u + b;                           // B v
  T* w = z + b;                           // rank-2 vector of S
  T* colpart = w + b;                     // (2, gcount, b) column partials
  // column sums: thread t takes column t % cw of row group t / cw
  const int cw = b < kThreads ? b : kThreads;
  const int gcount = b < kThreads ? kThreads / b : 1;
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
      for (int i = tid; i < b; i += kThreads) {
        const T x = ld(r0 + i, ce);
        v[i] = x;
        if (i > 0) part += x * x;
      }
      const T sigma2 = block_sum(part, red);  // also publishes v[] (x)
      const T alpha = v[0];
      const T norm = sqrt(alpha * alpha + sigma2);
      const T beta0 = alpha < T(0) ? norm : -norm;
      const bool trivial = sigma2 == T(0);
      const T denom = trivial ? T(1) : alpha - beta0;
      const T tau =
          trivial ? T(0) : (beta0 - alpha) / (beta0 == T(0) ? T(1) : beta0);
      const T beta = trivial ? alpha : beta0;
      __syncthreads();  // every thread has read v[0] as alpha
      for (int i = tid; i < b; i += kThreads)
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
      for (int t = warp; t < 2 * b; t += kWarps) {
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
      for (int c = tid; c < b; c += kThreads) {
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
      for (int i = tid; i < b; i += kThreads) part += v[i] * u[i];
      const T coef = tau * T(0.5) * block_sum(part, red);
      for (int i = tid; i < b; i += kThreads) w[i] = tau * (u[i] - coef * v[i]);
      __syncthreads();

      // ---- updates of L1 (with the eliminated column), S and B
      for (int e = tid; e < b * b; e += kThreads) {
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
      for (int i = tid; i < b; i += kThreads) rec[i] = i == 0 ? tau : v[i];
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(g.progress + j, s + 1);
    }
  }
}

template <typename T>
cudaError_t launch(ChaseArgs<T> g, cudaStream_t st) {
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
  const int gcount = g.b < kThreads ? kThreads / g.b : 1;
  const size_t smem = static_cast<size_t>(5 + 2 * gcount) * g.b * sizeof(T);
  if (smem + 4096 > static_cast<size_t>(max_smem))
    return cudaErrorInvalidValue;
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      chase_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chase_kernel<T>, kThreads, smem));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms < g.n - 2 ? sms : g.n - 2;
  void* args[] = {&g};
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chase_kernel<T>), dim3(grid), dim3(kThreads),
      args, smem, st));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float, 1 double. A: (n, n) row-major, chased in place (lower
// triangle); vout: (n, smax, b) zeroed; progress: (n,) int32 zeroed.
// Needs b >= 2 and smax >= the largest sweep's op count.
extern "C" int elx_sb2tr(int dtype, int n, int b, int smax, void* A,
                         void* vout, void* progress, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || b < 2 || smax < 1) return cudaErrorInvalidValue;
  int* pr = static_cast<int*>(progress);
  if (dtype == 0)
    return launch<float>(ChaseArgs<float>{static_cast<float*>(A), n, b, smax,
                                          static_cast<float*>(vout), pr},
                         st);
  if (dtype == 1)
    return launch<double>(ChaseArgs<double>{static_cast<double*>(A), n, b,
                                            smax, static_cast<double*>(vout),
                                            pr},
                          st);
  return cudaErrorInvalidValue;
}
