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
// Bound.  Bytes: M*K in, B_a*M*K/G out, a few word operations per byte.
// Since G divides K, the input is one flat stream of M*K/G groups of G
// bytes and each output plane one flat stream of M*K/G bytes, so no row
// index is ever computed.  Design: a thread owns 16 consecutive groups; it
// reads their 16*G bytes as G 16-byte loads (byte loads where the input is
// not 16-byte aligned), gathers byte g of its 16 groups into four words
// X_g, forms each plane's 16 codes four at a time as
// sum_g ((X_g >> b) & 0x01010101) << g, and writes each plane with one
// 16-byte store (byte stores where M*K/G is not a multiple of 16, so a
// plane's start is not aligned).  G is a template parameter: every index
// is a constant and the byte gathers are permutes.  The last thread takes
// the tail of fewer than 16 groups one byte at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BA = 8;
constexpr int GPT = 16;   // groups per thread

template <int G, bool VIN>
__global__ void __launch_bounds__(THREADS) pack_bitplanes_kernel(
    const uint8_t* __restrict__ a,  // [M*K] = [total][G]
    int8_t* __restrict__ out,       // [B_a][total]
    long long total, int B_a, int vout) {
  const long long n_full = total / GPT;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t * GPT < total;
       t += stride) {
    if (t < n_full) {
      // the 16*G input bytes as 4*G words, little-endian
      uint32_t in[4 * G];
      const uint8_t* src = a + t * GPT * G;
      if constexpr (VIN) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + j);
          in[4 * j] = v.x; in[4 * j + 1] = v.y; in[4 * j + 2] = v.z; in[4 * j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < 4 * G; ++w)
          in[w] = (uint32_t)__ldg(src + 4 * w) | (uint32_t)__ldg(src + 4 * w + 1) << 8 |
                  (uint32_t)__ldg(src + 4 * w + 2) << 16 | (uint32_t)__ldg(src + 4 * w + 3) << 24;
      }
      // X[g][w]: byte k is byte g of group 4w + k
      uint32_t X[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t x = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = (4 * w + k) * G + g;
            x |= ((in[i >> 2] >> (8 * (i & 3))) & 0xffu) << (8 * k);
          }
          X[g][w] = x;
        }
#pragma unroll
      for (int b = 0; b < MAX_BA; ++b) {
        if (b >= B_a) break;
        uint32_t o[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t v = 0;
#pragma unroll
          for (int g = 0; g < G; ++g) v |= ((X[g][w] >> b) & 0x01010101u) << g;
          o[w] = v;
        }
        int8_t* dst = out + b * total + t * GPT;
        if (vout) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int j = 0; j < GPT; ++j) dst[j] = (int8_t)(o[j >> 2] >> (8 * (j & 3)));
        }
      }
    } else {
      for (long long j = t * GPT; j < total; ++j) {
        uint32_t v[G];
#pragma unroll
        for (int g = 0; g < G; ++g) v[g] = a[j * G + g];
        for (int b = 0; b < B_a; ++b) {
          uint32_t code = 0;
#pragma unroll
          for (int g = 0; g < G; ++g) code |= ((v[g] >> b) & 1u) << g;
          out[b * total + j] = (int8_t)code;
        }
      }
    }
  }
}

template <int G>
int launch_g(const uint8_t* a, int8_t* out, long long total, int B_a, int blocks, cudaStream_t s) {
  // 16-byte output stores need every plane's start aligned: total % 16 == 0
  const int vout = total % GPT == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(a) % 16 == 0)
    pack_bitplanes_kernel<G, true><<<blocks, THREADS, 0, s>>>(a, out, total, B_a, vout);
  else
    pack_bitplanes_kernel<G, false><<<blocks, THREADS, 0, s>>>(a, out, total, B_a, vout);
  return (int)cudaGetLastError();
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
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  const long long total = M * (K / G);
  const long long threads = (total + GPT - 1) / GPT;
  long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 64LL * n_sm) blocks = 64LL * n_sm;
  const uint8_t* src = static_cast<const uint8_t*>(a);
  int8_t* dst = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_g<1>(src, dst, total, B_a, (int)blocks, s);
    case 2: return launch_g<2>(src, dst, total, B_a, (int)blocks, s);
    case 3: return launch_g<3>(src, dst, total, B_a, (int)blocks, s);
    case 4: return launch_g<4>(src, dst, total, B_a, (int)blocks, s);
    case 5: return launch_g<5>(src, dst, total, B_a, (int)blocks, s);
    default: return launch_g<6>(src, dst, total, B_a, (int)blocks, s);
  }
}
