// Expert-stacked int8 x int8 -> int32 product for Hopper.
//
// Replaces no Pallas kernel: the reference runs the int8 serve layout's
// expert stacks as a jax.vmap of an int8 dot_general
// (src/repro/models/nn.py::serve_linear_apply under moe.py's vmap over
// experts).  cuBLASLt has no batched int8 GEMM and a launch per expert is
// not taken, so one launch covers the whole stack.  Computes, exactly,
//
//   out[e, m, n] = sum_k a[e, m, k] * w[e, k, n]      (int8 operands, int32)
//
// for a [E, M, K], w [E, K, N] (row-major, N contiguous), out [E, M, N].
//
// Bound.  Bytes: the weights, E*K*N, dwarf the activations (E*M*K) and the
// output (4*E*M*N) at serve shapes, where M = groups x capacity is 2-8
// rows; the products (2*E*M*K*N) are far below the int8 peak.  Design: a
// block owns one expert, 256 output columns and MT rows; its 256 threads
// are 16 column groups x 16 k lanes.  A thread reads 4 consecutive k rows
// of its 16 columns as four 16-byte loads (16 threads of a k row read 256
// contiguous bytes), transposes them with byte permutes into one word of 4
// k values per column, and accumulates MT x 16 sums with __dp4a against
// the rows' activations, staged in shared memory KC bytes of k at a time.
// The k lanes' partial sums meet in shared memory through integer atomics
// (exact in any order).  Rows past MT take more blocks on grid x, the
// fastest-varying axis, so the blocks that reread a weight tile run side
// by side and find it in L2.  Where N is not a multiple of 16, K not a
// multiple of 4 or the weights are not 16-byte aligned, the GENERIC
// instance reads bytes with bounds checks and zeros past the edges.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 16;                 // columns a thread owns
constexpr int NGROUPS = 16;              // column groups a block
constexpr int KLANES = THREADS / NGROUPS;
constexpr int BN = COLS * NGROUPS;       // 256 columns a block
constexpr int MT = 4;                    // rows a block
constexpr int KC = 2048;                 // k bytes of activations staged

__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, int32_t* col) {
  // byte c of r_i is w[k + i, n + c]; col[c] packs w[k .. k + 3, n + c]
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  col[0] = (int32_t)__byte_perm(lo01, lo23, 0x5410);
  col[1] = (int32_t)__byte_perm(lo01, lo23, 0x7632);
  col[2] = (int32_t)__byte_perm(hi01, hi23, 0x5410);
  col[3] = (int32_t)__byte_perm(hi01, hi23, 0x7632);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_experts_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ w,
    int32_t* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t a_s[MT][KC];
  __shared__ int32_t red[MT][BN];
  const int e = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.x * MT;
  const int tid = threadIdx.x;
  const int cg = tid % NGROUPS;
  const int kl = tid / NGROUPS;
  const int nc = n0 + cg * COLS;          // this thread's first column
  const int8_t* ae = a + (long long)e * M * K;
  const int8_t* we = w + (long long)e * K * N;

  for (int i = tid; i < MT * BN; i += THREADS) red[i / BN][i % BN] = 0;
  int32_t acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = i / KC, k = k0 + i % KC;
      a_s[m][i % KC] = (m0 + m < M && k < K) ? ae[(long long)(m0 + m) * K + k] : 0;
    }
    __syncthreads();
    const int kend = min(KC, K - k0);
    if (VEC && nc >= N) continue;
#pragma unroll 2
    for (int kk = 4 * kl; kk < kend; kk += 4 * KLANES) {
      const int k = k0 + kk;
      int32_t col[COLS];
      if constexpr (VEC) {
        const int8_t* src = we + (long long)k * N + nc;
        const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(src));
        const uint4 r1 = __ldg(reinterpret_cast<const uint4*>(src + N));
        const uint4 r2 = __ldg(reinterpret_cast<const uint4*>(src + 2 * (long long)N));
        const uint4 r3 = __ldg(reinterpret_cast<const uint4*>(src + 3 * (long long)N));
        transpose4(r0.x, r1.x, r2.x, r3.x, col);
        transpose4(r0.y, r1.y, r2.y, r3.y, col + 4);
        transpose4(r0.z, r1.z, r2.z, r3.z, col + 8);
        transpose4(r0.w, r1.w, r2.w, r3.w, col + 12);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          uint32_t v = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = nc + c;
            const uint32_t b = (k + i < K && n < N)
                ? (uint32_t)(uint8_t)__ldg(we + (long long)(k + i) * N + n) : 0u;
            v |= b << (8 * i);
          }
          col[c] = (int32_t)v;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int32_t av = *reinterpret_cast<const int32_t*>(&a_s[m][kk]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[m][c] = __dp4a(av, col[c], acc[m][c]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (acc[m][c]) atomicAdd(&red[m][cg * COLS + c], acc[m][c]);
  __syncthreads();
  int32_t* oe = out + (long long)e * M * N;
  for (int i = tid; i < MT * BN; i += THREADS) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < M && n < N) oe[(long long)m * N + n] = red[i / BN][i % BN];
  }
}

}  // namespace

extern "C" int int8_experts_launch(const void* a, const void* w, void* out, int E,
                                   int M, int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const dim3 grid((M + MT - 1) / MT, (N + BN - 1) / BN, E);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = N % 16 == 0 && K % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    int8_experts_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
        static_cast<int32_t*>(out), M, K, N);
  else
    int8_experts_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
        static_cast<int32_t*>(out), M, K, N);
  return (int)cudaGetLastError();
}
