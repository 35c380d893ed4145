// K1's skinny route: C = A * B for N <= 16 columns, float32 or float64,
// any strides and any alignment (kernels/matmul.py:route "skinny").
//
// Replaces, for these shapes, the same TPU kernel as matmul.cu
// (elementalx/kernels/matmul.py:matmul_pallas, line 39; pallas_call at
// line 58). The main paths give it the distributed step's SUMMA products:
// (8192 x 128) (128 x 2) float32 k-panels of SUMMA_C, 512 of them, and
// (16384 x 8192) (8192 x 2), (8192 x 8192) (8192 x 4) of SUMMA_B and
// SUMMA_A. A 128 x 128 tile core computes 2 of each tile's 128 columns
// there, on 64 blocks for 132 SMs.
//
// Bound on the H100: A's bytes (and C's) at 3.35 TB/s; 2 N FLOP a word of
// A is far below the FP32 rate. So A is streamed once, with many loads in
// flight, and the work is spread over the whole card:
//
//   - "rows" (A's k stride no larger than its m stride, such as row-major
//     A): a warp owns a row of C, its lanes walk the row's k with 16-byte
//     loads where A's base and row stride allow (else 4- or 8-byte ones),
//     kUnroll loads in flight a lane; the lanes' sums meet in an xor
//     butterfly (x + y and y + x are the same bits, so every lane ends
//     with the same total);
//   - "cols" (A's m stride the smaller, such as A.mT): a thread owns a row
//     of C and walks its k in order, so a warp's loads of one k are
//     neighbouring words of A;
//   - B's k x N panel is staged in shared memory a chunk of k at a time
//     (sB[n][k] for "rows", read as one vector a lane; sB[k][n] for
//     "cols", a broadcast);
//   - where the rows alone give fewer blocks than 132 SMs x 4 (the blocks
//     an SM holds, by the launch bounds), the wrapper splits K into S
//     slices (blockIdx.y); each slice writes its partial C to a workspace
//     and a second pass adds the S partials in slice order.
//
// Every sum has a fixed order and no atomics are used: two runs give the
// same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads in flight a lane ("rows")
constexpr int kColsChunk = 256;

template <typename T>
struct SkinnyArgs {
  int M, N, K;
  const T* A;
  long long sam, sak;
  const T* B;
  long long sbk, sbn;
  T* C;
  long long scm, scn;
  T* ws;       // (S, M, N) partial C of each k slice when S > 1
  int kslice;  // k of a slice (K when S == 1)
  int S;
};

template <typename T, int kV>
struct Vec;
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

template <typename T, int kV>
__device__ __forceinline__ void load_vec(T (&v)[kV], const T* p) {
  if constexpr (kV == 1) {
    v[0] = *p;
  } else {
    const typename Vec<T, kV>::type q =
        *reinterpret_cast<const typename Vec<T, kV>::type*>(p);
    if constexpr (kV == 4) {
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = q.x;
      v[1] = q.y;
    }
  }
}

// This block's k range [kb, ke) (slice blockIdx.y).
template <typename T>
__device__ __forceinline__ void slice(const SkinnyArgs<T>& g, long long& kb,
                                      long long& ke) {
  kb = static_cast<long long>(blockIdx.y) * g.kslice;
  ke = min(static_cast<long long>(g.K), kb + g.kslice);
}

// The row's N sums: into C, or into the slice's partials.
template <typename T>
__device__ __forceinline__ void put(const SkinnyArgs<T>& g, int m, int n,
                                    T v) {
  if (g.S == 1)
    g.C[m * g.scm + n * g.scn] = v;
  else
    g.ws[(static_cast<long long>(blockIdx.y) * g.M + m) * g.N + n] = v;
}

// "rows": warp w of block b owns row m = kWarps b + w. kN >= N columns
// (a power of 2), kV elements a load (kV > 1: A's rows start 16-byte
// aligned and its k stride is 1).
template <typename T, int kN, int kV>
__global__ void __launch_bounds__(kThreads, 4) skinny_rows(SkinnyArgs<T> g) {
  constexpr int kChunk = 32 * kV * kUnroll;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // [kN][kChunk]
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  // a row past M (the last block's) reads row M - 1 and writes nothing
  const T* arow = g.A + static_cast<long long>(min(m, g.M - 1)) * g.sam;
  long long kb, ke;
  slice(g, kb, ke);
  T acc[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n] = T(0);
  for (long long k0 = kb; k0 < ke; k0 += kChunk) {
    const int kc = static_cast<int>(min(static_cast<long long>(kChunk),
                                        ke - k0));
    // A's loads first, so that they are in flight while B is staged
    T a[kUnroll][kV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = (u * 32 + lane) * kV;
      if (kV > 1 && kk + kV <= kc) {
        load_vec<T, kV>(a[u], arow + k0 + kk);
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j)
          a[u][j] = kk + j < kc ? arow[(k0 + kk + j) * g.sak] : T(0);
      }
    }
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = threadIdx.x; e < kN * kChunk; e += kThreads) {
      const int n = e / kChunk, k = e % kChunk;
      sB[e] = n < g.N && k < kc ? g.B[(k0 + k) * g.sbk + n * g.sbn] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = (u * 32 + lane) * kV;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        T b[kV];
        load_vec<T, kV>(b, sB + n * kChunk + kk);
#pragma unroll
        for (int j = 0; j < kV; ++j) acc[n] = fma(a[u][j], b[j], acc[n]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
#pragma unroll
    for (int n = 0; n < kN; ++n)
      acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], o);
  T mine = acc[0];
#pragma unroll
  for (int n = 1; n < kN; ++n)
    if (lane == n) mine = acc[n];
  if (m < g.M && lane < g.N) put(g, m, lane, mine);
}

// "cols": thread t of block b owns row m = kThreads b + t and walks its k
// in order.
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads, 4) skinny_cols(SkinnyArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // [kColsChunk][kN]
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const T* arow = g.A + static_cast<long long>(min(m, g.M - 1)) * g.sam;
  long long kb, ke;
  slice(g, kb, ke);
  T acc[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n] = T(0);
  for (long long k0 = kb; k0 < ke; k0 += kColsChunk) {
    const int kc = static_cast<int>(min(static_cast<long long>(kColsChunk),
                                        ke - k0));
    __syncthreads();
    for (int e = threadIdx.x; e < kN * kColsChunk; e += kThreads) {
      const int k = e / kN, n = e % kN;
      sB[e] = n < g.N && k < kc ? g.B[(k0 + k) * g.sbk + n * g.sbn] : T(0);
    }
    __syncthreads();
    for (int k = 0; k < kc; k += 8) {
      T a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = k + u < kc ? arow[(k0 + k + u) * g.sak] : T(0);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int n = 0; n < kN; ++n)
          acc[n] = fma(a[u], sB[(k + u) * kN + n], acc[n]);
    }
  }
  if (m < g.M)
#pragma unroll
    for (int n = 0; n < kN; ++n)
      if (n < g.N) put(g, m, n, acc[n]);
}

// The second pass of a split K: C = the S partials added in slice order.
template <typename T>
__global__ void __launch_bounds__(kThreads) skinny_sum(SkinnyArgs<T> g) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= static_cast<long long>(g.M) * g.N) return;
  const int m = static_cast<int>(e / g.N), n = static_cast<int>(e % g.N);
  T s = T(0);
  for (int t = 0; t < g.S; ++t)
    s += g.ws[(static_cast<long long>(t) * g.M + m) * g.N + n];
  g.C[m * g.scm + n * g.scn] = s;
}

template <typename T, int kN>
cudaError_t launch_n(const SkinnyArgs<T>& g, int cols, int vec,
                     cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  if (cols) {
    const int blocks = (g.M + kThreads - 1) / kThreads;
    skinny_cols<T, kN><<<dim3(blocks, g.S), kThreads,
                         kColsChunk * kN * sizeof(T), st>>>(g);
  } else {
    const int blocks = (g.M + kWarps - 1) / kWarps;
    if (vec)
      skinny_rows<T, kN, kV><<<dim3(blocks, g.S), kThreads,
                               32 * kV * kUnroll * kN * sizeof(T), st>>>(g);
    else
      skinny_rows<T, kN, 1><<<dim3(blocks, g.S), kThreads,
                              32 * kUnroll * kN * sizeof(T), st>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.S == 1) return err;
  const long long n = static_cast<long long>(g.M) * g.N;
  skinny_sum<T><<<static_cast<int>((n + kThreads - 1) / kThreads), kThreads,
                  0, st>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const SkinnyArgs<T>& g, int cols, int vec,
                   cudaStream_t st) {
  if (g.N <= 2) return launch_n<T, 2>(g, cols, vec, st);
  if (g.N <= 4) return launch_n<T, 4>(g, cols, vec, st);
  if (g.N <= 8) return launch_n<T, 8>(g, cols, vec, st);
  return launch_n<T, 16>(g, cols, vec, st);
}

}  // namespace

// dtype: 0 float, 1 double. cols: the "cols" layout, else "rows"; vec:
// 16-byte loads of A ("rows" only: A's base and row stride multiples of
// 16 bytes, sak = 1; with S > 1, kslice a multiple of 128). S > 1: K cut
// into slices of kslice k, ws holding S x M x N partials. 1 <= N <= 16.
extern "C" int elx_matmul_skinny(int dtype, int cols, int vec, int M, int N,
                                 int K, const void* A, long long sam,
                                 long long sak, const void* B, long long sbk,
                                 long long sbn, void* C, long long scm,
                                 long long scn, void* ws, int S, int kslice,
                                 void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (N > 16 || S < 1 || kslice < 1 ||
      static_cast<long long>(S) * kslice < K || (S > 1 && !ws) ||
      (vec && (cols || sak != 1 || (S > 1 && kslice % 128))))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(
        SkinnyArgs<float>{M, N, K, static_cast<const float*>(A), sam, sak,
                          static_cast<const float*>(B), sbk, sbn,
                          static_cast<float*>(C), scm, scn,
                          static_cast<float*>(ws), kslice, S},
        cols, vec, st);
  if (dtype == 1)
    return launch<double>(
        SkinnyArgs<double>{M, N, K, static_cast<const double*>(A), sam, sak,
                           static_cast<const double*>(B), sbk, sbn,
                           static_cast<double*>(C), scm, scn,
                           static_cast<double*>(ws), kslice, S},
        cols, vec, st);
  return cudaErrorInvalidValue;
}
