// The FP64 tensor cores' issue rate by mma.sync shape, from a loop of
// independent mma.sync f64 on registers only (no memory in the loop):
// what each shape can give K1's "dmma" core at best on this card.
// Built and timed by probes/dmma_rate.py.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;  // independent accumulators a warp

template <int kShape>
struct Atom;
// m8n8k4 (sm_80): a 1, b 1, d 2 doubles a thread
template <>
struct Atom<0> {
  static constexpr int A = 1, B = 1, D = 2, kFlop = 2 * 8 * 8 * 4;
  __device__ static void mma(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  }
};
// m16n8k4 (sm_90)
template <>
struct Atom<1> {
  static constexpr int A = 2, B = 1, D = 4, kFlop = 2 * 16 * 8 * 4;
  __device__ static void mma(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
// m16n8k8 (sm_90): K1's core
template <>
struct Atom<2> {
  static constexpr int A = 4, B = 2, D = 4, kFlop = 2 * 16 * 8 * 8;
  __device__ static void mma(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
// m16n8k16 (sm_90)
template <>
struct Atom<3> {
  static constexpr int A = 8, B = 4, D = 4, kFlop = 2 * 16 * 8 * 16;
  __device__ static void mma(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

template <int kShape>
__global__ void rate(double* out, int iters) {
  using At = Atom<kShape>;
  double a[At::A], b[At::B], d[kChains][At::D];
  for (int i = 0; i < At::A; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < At::B; ++i) b[i] = 1e-3 * (blockIdx.x + i);
  for (int c = 0; c < kChains; ++c)
    for (int i = 0; i < At::D; ++i) d[c][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < kChains; ++c) At::mma(d[c], a, b);
  double s = 0.0;
  for (int c = 0; c < kChains; ++c)
    for (int i = 0; i < At::D; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// FLOP of one launch of shape `shape` (0: m8n8k4, 1: m16n8k4, 2: m16n8k8,
// 3: m16n8k16) with blocks x threads, iters rounds of 8 mma a warp; the
// launch itself when out is not null.
extern "C" double dmma_rate(int shape, int blocks, int threads, int iters,
                            double* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double warps = static_cast<double>(blocks) * threads / 32;
  double flop = 0;
  switch (shape) {
    case 0:
      if (out) rate<0><<<blocks, threads, 0, s>>>(out, iters);
      flop = Atom<0>::kFlop;
      break;
    case 1:
      if (out) rate<1><<<blocks, threads, 0, s>>>(out, iters);
      flop = Atom<1>::kFlop;
      break;
    case 2:
      if (out) rate<2><<<blocks, threads, 0, s>>>(out, iters);
      flop = Atom<2>::kFlop;
      break;
    default:
      if (out) rate<3><<<blocks, threads, 0, s>>>(out, iters);
      flop = Atom<3>::kFlop;
  }
  return flop * kChains * iters * warps;
}
