// K9: the level-1 elementwise kernels and the tiled transpose.
//
//   axpby:     out = beta * y + alpha * x   (Axpy is beta = 1)
//   scale:     out = alpha * x
//   hadamard:  out = x .* y
//   fill:      out = alpha on the logical m x n region of an M x N array,
//              0 in its padding
//   transpose: out = x^T (also x^H for real x)
//
// all through one C entry, elx_ew, which takes the call's arguments packed
// into one struct (EwCall): a host-bound call at 16384 x 256 costs the
// host one argument's conversion, not fifteen.
//
// x and y are m x n, each read through its own two strides (a .mT view
// or a slice is read in place); out is a fresh contiguous array that the
// wrapper allocates, so nothing is in place, as in the TPU kernels. alpha
// and beta come by value (a double holding the scalar already rounded to
// out's type on the host, so a call launches one kernel) or, for a scalar
// that lives on the card, through a device pointer to one element of out's
// type (no host synchronisation).
//
// Replaces the TPU kernels of elementalx/kernels/elementwise.py: axpy,
// scale and hadamard (through _ew_call), fill and transpose, the Pallas
// counterparts of Hydrogen's gpu/{Axpy,Scale,Hadamard,Fill,Transpose}.cu.
// Those stream (bm, bn) VMEM blocks of (8, 128)-tileable real arrays and
// bake the scalar into the kernel body (a traced scalar falls back to
// jnp); the transpose reads (b, b) blocks and writes them transposed.
//
// Arithmetic: float in float, double in double, bfloat16 in float with one
// rounding of the result (nearest even). Every product and sum is rounded
// on its own (__fmul_rn, __fadd_rn: no fused multiply-add), so the result
// equals the plain PyTorch version's, which computes the same operations
// one at a time, bit for bit.
//
// What bounds them: bytes. axpby and hadamard read two arrays and write
// one, scale and transpose read one and write one, fill writes one: at
// 16384^2 float that is 3.2, 2.1 and 1.1 GB, 0.96, 0.64 and 0.32 ms at
// 3.35 TB/s. When every array is contiguous and 16-byte aligned (the main
// paths' case) the streaming kernels move 16-byte vectors over the flat
// arrays, kUnroll of them a thread (loads before stores), in a grid sized
// to the work: one vector a thread measured best (probes/k7_k9.py).
// Otherwise they run a grid-stride loop sized to fill every SM and walk
// out in row-major order (one 64-bit division a thread, then the row and
// column are stepped by adds), so writes coalesce, and reads coalesce
// for inputs with a unit column stride. The transpose reads a
// 32 x 32 tile of x into shared memory along x's rows and writes it along
// out's rows; the tile is padded by one column, so reading it by columns
// hits 32 distinct banks, and both the global reads and the global writes
// coalesce. What they give up: coalesced reads of a column-major input in
// the streaming kernels, and vector accesses in the transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2 };
enum Op { kAxpby, kScale, kHadamard, kFill, kTranspose };

constexpr int kThreads = 256;      // threads of a streaming block
constexpr int kBlocksPerSM = 8;    // 2048 resident threads per SM
#ifndef ELX_EW_UNROLL
#define ELX_EW_UNROLL 1
#endif
constexpr int kUnroll = ELX_EW_UNROLL;  // 16-byte vectors a thread (flat)
constexpr int kTile = 32;          // transpose tile (kTile x kTile)
constexpr int kTileRows = 8;       // rows of threads of a transpose block

// Storage type T, arithmetic type A, the rounding conversions and the
// separately rounded product and sum.
template <typename T>
struct Ew;

template <>
struct Ew<float> {
  using A = float;
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Ew<double> {
  using A = double;
  __device__ static double in(double x) { return x; }
  __device__ static double out(double x) { return x; }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

template <>
struct Ew<__nv_bfloat16> {
  using A = float;
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <typename T>
struct EwArgs {
  int m, n;           // out's shape (fill: the padded M x N)
  int mv, nv;         // fill: the logical region
  const T* x;
  long long sx0, sx1;
  const T* y;
  long long sy0, sy1;
  const T* alpha;     // on the device, or nullptr: alpha_v
  const T* beta;
  double alpha_v, beta_v;
  T* out;             // contiguous m x n
};

__host__ __device__ constexpr bool uses_x(int op) { return op != kFill; }
__host__ __device__ constexpr bool uses_y(int op) {
  return op == kAxpby || op == kHadamard;
}

// One output element from its inputs (fill: a, masked by the caller).
template <typename T, int OP>
__device__ inline typename Ew<T>::A element(typename Ew<T>::A a,
                                            typename Ew<T>::A b, T xv,
                                            T yv) {
  using E = Ew<T>;
  if (OP == kAxpby)
    return E::add(E::mul(b, E::in(yv)), E::mul(a, E::in(xv)));
  if (OP == kScale) return E::mul(a, E::in(xv));
  if (OP == kHadamard) return E::mul(E::in(xv), E::in(yv));
  return a;
}

template <typename T, int OP>
__device__ inline void load_scalars(const EwArgs<T>& g, typename Ew<T>::A* a,
                                    typename Ew<T>::A* b) {
  using A = typename Ew<T>::A;
  if (OP == kAxpby || OP == kScale || OP == kFill)
    *a = g.alpha ? Ew<T>::in(*g.alpha) : static_cast<A>(g.alpha_v);
  if (OP == kAxpby)
    *b = g.beta ? Ew<T>::in(*g.beta) : static_cast<A>(g.beta_v);
}

// Any strides: out in row-major order, (i, j) stepped without division.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ew_kernel(EwArgs<T> g) {
  using A = typename Ew<T>::A;
  const long long n = g.n;
  const long long total = static_cast<long long>(g.m) * n;
  const long long S = static_cast<long long>(gridDim.x) * blockDim.x;
  long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= total) return;
  // (i, j) of k, then stepped by (di, dj) = divmod(S, n) with one carry
  long long i = k / n, j = k - i * n;
  const long long di = S / n, dj = S - di * n;
  A a = A(0), b = A(0);
  load_scalars<T, OP>(g, &a, &b);
  const T* __restrict__ x = g.x;
  const T* __restrict__ y = g.y;
  T* __restrict__ out = g.out;
#pragma unroll 4
  for (; k < total; k += S) {
    const T xv = uses_x(OP) ? x[i * g.sx0 + j * g.sx1] : T();
    const T yv = uses_y(OP) ? y[i * g.sy0 + j * g.sy1] : T();
    A v = element<T, OP>(a, b, xv, yv);
    if (OP == kFill && !(i < g.mv && j < g.nv)) v = A(0);
    out[k] = Ew<T>::out(v);
    i += di;
    j += dj;
    if (j >= n) {
      j -= n;
      ++i;
    }
  }
}

// 16 bytes of T, loaded and stored as one vector.
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// Contiguous, 16-byte aligned arrays (fill over the whole array): flat
// 16-byte vectors, kUnroll a thread (block-strided, so a warp's accesses
// coalesce), then the tail of total mod V elements in the last block.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ew_flat_kernel(EwArgs<T> g) {
  using A = typename Ew<T>::A;
  constexpr int V = 16 / sizeof(T);
  const long long total = static_cast<long long>(g.m) * g.n;
  const long long nvec = total / V;
  const long long k0 =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  A a = A(0), b = A(0);
  load_scalars<T, OP>(g, &a, &b);
  const Pack<T>* __restrict__ xp = reinterpret_cast<const Pack<T>*>(g.x);
  const Pack<T>* __restrict__ yp = reinterpret_cast<const Pack<T>*>(g.y);
  Pack<T>* __restrict__ op = reinterpret_cast<Pack<T>*>(g.out);
  Pack<T> xv[kUnroll], yv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = k0 + u * kThreads;
    if (k < nvec) {
      if (uses_x(OP)) xv[u] = xp[k];
      if (uses_y(OP)) yv[u] = yp[k];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = k0 + u * kThreads;
    if (k < nvec) {
      Pack<T> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = Ew<T>::out(element<T, OP>(a, b,
                                           uses_x(OP) ? xv[u].v[e] : T(),
                                           uses_y(OP) ? yv[u].v[e] : T()));
      op[k] = o;
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long k = nvec * V + threadIdx.x;
    if (k < total)
      g.out[k] = Ew<T>::out(element<T, OP>(a, b, uses_x(OP) ? g.x[k] : T(),
                                           uses_y(OP) ? g.y[k] : T()));
  }
}

// x (m x n, strides s0, s1) -> out (n x m, contiguous). Block (kTile,
// kTileRows); each block moves the tiles of one tile column of x, walking
// down x's tile rows with a grid stride.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(int m, int n, const T* __restrict__ x, long long s0,
                     long long s1, T* __restrict__ out) {
  using E = Ew<T>;
  // bfloat16 is held as float, so every element is one 4-byte bank word
  __shared__ typename E::A tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  for (long long i0 = static_cast<long long>(blockIdx.y) * kTile; i0 < m;
       i0 += static_cast<long long>(gridDim.y) * kTile) {
#pragma unroll
    for (int r = 0; r < kTile; r += kTileRows) {
      const long long i = i0 + ty + r, j = j0 + tx;
      if (i < m && j < n) tile[ty + r][tx] = E::in(x[i * s0 + j * s1]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTile; r += kTileRows) {
      const long long j = j0 + ty + r, i = i0 + tx;
      if (j < n && i < m) out[j * m + i] = E::out(tile[tx][ty + r]);
    }
    __syncthreads();
  }
}

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// SMs of the current device, queried once per device.
cudaError_t sm_count(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0;
    ELX_RETURN_IF_ERROR(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    cached[dev] = sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

// A row-major contiguous m x n array at a 16-byte aligned address.
bool flat_ok(const void* p, long long s0, long long s1, int m, int n) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s1 == 1 &&
         (s0 == n || m <= 1);
}

template <typename T, int OP>
cudaError_t launch_ew(const EwArgs<T>& g, cudaStream_t st) {
  const long long total = static_cast<long long>(g.m) * g.n;
  if (total == 0) return cudaSuccess;
  const bool flat =
      flat_ok(g.out, g.n, 1, g.m, g.n) &&
      (!uses_x(OP) || flat_ok(g.x, g.sx0, g.sx1, g.m, g.n)) &&
      (!uses_y(OP) || flat_ok(g.y, g.sy0, g.sy1, g.m, g.n)) &&
      (OP != kFill || (g.mv >= g.m && g.nv >= g.n));
  if (flat) {
    // one thread for every kUnroll vectors; at least one block, whose
    // threads take the tail
    const long long per_block = static_cast<long long>(kThreads) * kUnroll;
    const long long nvec = total / (16 / sizeof(T));
    long long blocks = (nvec + per_block - 1) / per_block;
    if (blocks < 1) blocks = 1;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    ew_flat_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        g);
    return cudaGetLastError();
  }
  long long blocks = (total + kThreads - 1) / kThreads;
  int sms = 0;
  ELX_RETURN_IF_ERROR(sm_count(&sms));
  const long long most = static_cast<long long>(sms) * kBlocksPerSM;
  if (blocks > most) blocks = most;
  ew_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

template <int OP>
cudaError_t dispatch_ew(int dtype, int m, int n, int mv, int nv,
                        const void* x, long long sx0, long long sx1,
                        const void* y, long long sy0, long long sy1,
                        const void* alpha, double alpha_v, const void* beta,
                        double beta_v, void* out, void* stream) {
  if (m < 0 || n < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ELX_EW_CASE(CODE, T)                                              \
  if (dtype == CODE)                                                      \
    return launch_ew<T, OP>(                                              \
        EwArgs<T>{m, n, mv, nv, static_cast<const T*>(x), sx0, sx1,       \
                  static_cast<const T*>(y), sy0, sy1,                     \
                  static_cast<const T*>(alpha), static_cast<const T*>(beta), \
                  alpha_v, beta_v, static_cast<T*>(out)},                 \
        st);
  ELX_EW_CASE(kF32, float)
  ELX_EW_CASE(kF64, double)
  ELX_EW_CASE(kBF16, __nv_bfloat16)
#undef ELX_EW_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_transpose(int m, int n, const void* x, long long s0,
                             long long s1, void* out, cudaStream_t st) {
  if (m == 0 || n == 0) return cudaSuccess;
  const long long gx = (static_cast<long long>(n) + kTile - 1) / kTile;
  long long gy = (static_cast<long long>(m) + kTile - 1) / kTile;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (gy > 65535) gy = 65535;
  transpose_kernel<T><<<dim3(static_cast<unsigned>(gx),
                             static_cast<unsigned>(gy)),
                        dim3(kTile, kTileRows), 0, st>>>(
      m, n, static_cast<const T*>(x), s0, s1, static_cast<T*>(out));
  return cudaGetLastError();
}

// One call of a K9 entry, packed by the caller into consecutive 8-byte
// fields (Python's struct.pack "<6qQdQ2qQdQ2q2Q"), so that a call crosses
// from the host language with one argument.
struct EwCall {
  long long op;        // kAxpby, kScale, kHadamard, kFill, or kTranspose
  long long dtype;     // 0 float, 1 double, 2 bfloat16, for every array
  long long m, n;      // out's shape (transpose: x's shape; fill: M x N)
  long long mv, nv;    // fill: the logical region
  const void* alpha;   // one element on the device, or nullptr: alpha_v
  double alpha_v;      // already rounded to dtype
  const void* x;
  long long sx0, sx1;
  const void* beta;
  double beta_v;
  const void* y;
  long long sy0, sy1;
  void* out;           // contiguous
  void* stream;
};

}  // namespace

// x, y: m x n through strides (sx0, sx1), (sy0, sy1); out: m x n
// contiguous (transpose: n x m); the fields an op does not use are
// ignored. Returns a cudaError_t.
extern "C" int elx_ew(const void* packed) {
  EwCall c;
  memcpy(&c, packed, sizeof c);
  if (c.m < 0 || c.n < 0 || c.m > 0x7fffffffLL || c.n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int m = static_cast<int>(c.m), n = static_cast<int>(c.n);
  const int dtype = static_cast<int>(c.dtype);
  if (c.op == kTranspose) {
    const cudaStream_t st = static_cast<cudaStream_t>(c.stream);
    if (dtype == kF32)
      return launch_transpose<float>(m, n, c.x, c.sx0, c.sx1, c.out, st);
    if (dtype == kF64)
      return launch_transpose<double>(m, n, c.x, c.sx0, c.sx1, c.out, st);
    if (dtype == kBF16)
      return launch_transpose<__nv_bfloat16>(m, n, c.x, c.sx0, c.sx1, c.out,
                                             st);
    return cudaErrorInvalidValue;
  }
  const int mv = static_cast<int>(c.mv), nv = static_cast<int>(c.nv);
#define ELX_EW_OP(OP)                                                       \
  if (c.op == OP)                                                           \
    return dispatch_ew<OP>(dtype, m, n, mv, nv, c.x, c.sx0, c.sx1, c.y,      \
                           c.sy0, c.sy1, c.alpha, c.alpha_v, c.beta,         \
                           c.beta_v, c.out, c.stream);
  ELX_EW_OP(kAxpby)
  ELX_EW_OP(kScale)
  ELX_EW_OP(kHadamard)
  ELX_EW_OP(kFill)
#undef ELX_EW_OP
  return cudaErrorInvalidValue;
}
