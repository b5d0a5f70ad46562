// Activation bit-plane packing (TLMAC, paper Eq. 3) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/bitplanes.py::pack_bitplanes_pallas
// (body _kernel).  Computes, for B_a-bit activation codes a [M, K] (int8
// storage, read as unsigned bytes),
//
//   out[b, m, j] = sum_g bit_b(a[m, j*G + g]) << g      (b < B_a, j < K/G)
//
// and writes int8 group codes [B_a, M, K/G] (values < 2^G <= 64; the Pallas
// kernel writes the same values as int32).  The lookup-GEMM kernels read int8.
//
// Bound.  Pure data movement: M*K bytes in, B_a*M*K/G bytes out, a handful
// of shifts per byte; bytes bound it on any card.  Design: one thread per
// (m, group) reads its G consecutive codes and writes its B_a plane codes;
// neighbouring threads own neighbouring groups, so the reads of a warp cover
// one contiguous 32*G-byte span and each plane's writes one 32-byte span.
// A grid-stride loop covers any M*K/G.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BA = 8;

__global__ void __launch_bounds__(THREADS) pack_bitplanes_kernel(
    const int8_t* __restrict__ a,  // [M, K]
    int8_t* __restrict__ out,      // [B_a, M, K/G]
    long long total, int K, int kg, int B_a, int G) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const long long m = i / kg;
    const int j = (int)(i - m * kg);
    const int8_t* src = a + m * K + (long long)j * G;
    int code[MAX_BA];
#pragma unroll
    for (int b = 0; b < MAX_BA; ++b) code[b] = 0;
    for (int g = 0; g < G; ++g) {
      const int v = (uint8_t)src[g];
#pragma unroll
      for (int b = 0; b < MAX_BA; ++b) code[b] |= ((v >> b) & 1) << g;
    }
#pragma unroll
    for (int b = 0; b < MAX_BA; ++b)
      if (b < B_a) out[(long long)b * total + i] = (int8_t)code[b];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int pack_bitplanes_launch(const void* a, void* out, long long M, int K,
                                     int B_a, int G, void* stream) {
  if (M < 1 || K < 1 || G < 1 || G > 6 || K % G != 0 || B_a < 1 || B_a > MAX_BA)
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  const int kg = K / G;
  const long long total = M * kg;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 32LL * n_sm) blocks = 32LL * n_sm;
  pack_bitplanes_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<int8_t*>(out), total, K, kg, B_a, G);
  return (int)cudaGetLastError();
}
