// Table-lookup GEMM on pre-packed bit-plane codes (TLMAC PE) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/tlmac_gemm.py::tlmac_gemm
// (body _kernel, gather 'take' and 'onehot').  Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_b 2^b sum_kg table2d[rowbase[nt, kg, p], codes[b, m, kg]]
//
// from codes [B_a, M, KG] int8 (the group codes of bitplanes.cu, < 2^G),
// rowbase [n_tiles, KG, dp] int32 (= step_cluster * N_arr + exec_idx) and
// table2d [R, 2^G] int32, for every G of 1..6 (rows of 2 to 64 entries) and
// any dp.  Ragged KG needs no zero-row padding: the loops stop at KG.
//
// Bound.  M*B_a*KG*N lookup-adds against (B_a*M*KG + 4*N*KG + 4*M*N) bytes:
// at the conv shapes of ResNet-18 (M = 1.6k-100k) the operations bound it.
// What limits a lookup kernel in practice is the number of L1 wavefronts
// the table reads take.  Design:
//   - lanes of a warp own 32 consecutive rows m and a warp owns whole output
//     columns, so the 32 lookups of one load instruction all fall in ONE
//     table row (at most 2^G <= 64 distinct ints, 1-2 sectors): a random
//     row read costs one wavefront for 32 lookups, not 32 wavefronts;
//   - a block owns a 64-row x 64-column output tile of one n-tile and a
//     kg slice; per 32-group step it stages the row offsets rowbase*2^G
//     (coalesced along p) and the B_a code planes of its 64 rows in shared
//     memory; each lane keeps its B_a x 2 codes of a group in registers and
//     reuses them across the warp's 8 columns; B_a is a template parameter,
//     so the plane loop is unrolled to exactly B_a lookups (no predicated
//     iterations up to the largest B_a);
//   - the table stays in device memory: a compiled layer's table (<= 131 KB
//     for ResNet-18) is read through L1/L2; the cluster-scheduled kernel
//     (tlmac_clustered.cu) is the variant that stages table slices in
//     shared memory;
//   - the TPU kernel's sequential kg grid axis (accumulating in out_ref)
//     becomes a third grid axis sized for ~4 blocks per SM; slice partial
//     sums meet in a zeroed output through int32 atomics (exact, order-free);
//   - the 64x64 tile is transposed through shared memory so that the
//     output is written (or atomically added) coalesced along p.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;           // groups staged per step
constexpr int MAX_BA = 8;        // activation bit-planes
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MR = 2;            // rows per lane
constexpr int BM = 32 * MR;      // rows per block
constexpr int CPW = 8;           // columns per warp
constexpr int BP = WARPS * CPW;  // columns per block

template <int BA>
__global__ void __launch_bounds__(THREADS) tlmac_gemm_kernel(
    const int8_t* __restrict__ codes,     // [B_a, M, KG]
    const int32_t* __restrict__ rowbase,  // [n_tiles, KG, dp]
    const int32_t* __restrict__ table,    // [R, C]
    int32_t* __restrict__ out,            // [M, n_tiles * dp]
    int M, int KG, int dp, int n_chunks, int C, int kg_per) {
  __shared__ int32_t s_row[KC][BP];             // row offsets rowbase * C
  __shared__ uint8_t s_code[BA][KC][BM];        // code planes of the tile's rows
  __shared__ int32_t s_out[BM][BP + 1];         // output tile, for coalesced stores

  const int nt = blockIdx.x / n_chunks;
  const int p0 = (blockIdx.x - nt * n_chunks) * BP;
  const int np = min(BP, dp - p0);
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t N = (size_t)(gridDim.x / n_chunks) * dp;

  int32_t acc[CPW][MR];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0;

  const int32_t* rb_tile = rowbase + (size_t)nt * KG * dp;
  const int k_beg = blockIdx.z * kg_per;
  const int k_end = min(KG, k_beg + kg_per);

  for (int k0 = k_beg; k0 < k_end; k0 += KC) {
    const int kc_n = min(KC, k_end - k0);
    __syncthreads();  // the previous step is consumed
    for (int i = tid; i < KC * BP; i += THREADS) {
      const int kc = i / BP, pp = i - kc * BP;
      s_row[kc][pp] = (kc < kc_n && pp < np)
                          ? rb_tile[(size_t)(k0 + kc) * dp + p0 + pp] * C : 0;
    }
    for (int i = tid; i < BA * BM * KC; i += THREADS) {
      const int kc = i % KC, rest = i / KC;
      const int mm = rest % BM, b = rest / BM;
      const int m = m0 + mm;
      s_code[b][kc][mm] = (m < M && kc < kc_n)
                              ? (uint8_t)codes[((size_t)b * M + m) * KG + k0 + kc] : 0;
    }
    __syncthreads();
    for (int kc = 0; kc < kc_n; ++kc) {
      int code[BA][MR];
#pragma unroll
      for (int b = 0; b < BA; ++b)
#pragma unroll
        for (int r = 0; r < MR; ++r) code[b][r] = s_code[b][kc][lane + 32 * r];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int pp = warp * CPW + c;  // warp-uniform column
        if (pp < np) {
          const int32_t* row = table + s_row[kc][pp];
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            int32_t sum = 0;
#pragma unroll
            for (int b = 0; b < BA; ++b) sum += __ldg(row + code[b][r]) << b;
            acc[c][r] += sum;
          }
        }
      }
    }
  }

  // transpose the tile through shared memory: coalesced along p
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) s_out[lane + 32 * r][warp * CPW + c] = acc[c][r];
  __syncthreads();
  for (int i = tid; i < BM * BP; i += THREADS) {
    const int mm = i / BP, pp = i - mm * BP;
    const int m = m0 + mm;
    if (m >= M || pp >= np) continue;
    int32_t* dst = out + (size_t)m * N + (size_t)nt * dp + p0 + pp;
    if (gridDim.z == 1)
      *dst = s_out[mm][pp];
    else
      atomicAdd(dst, s_out[mm][pp]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int tlmac_gemm_launch(const void* codes, const void* rowbase, const void* table,
                                 void* out, int M, int KG, int n_tiles, int dp, int C,
                                 int B_a, void* stream) {
  if (M < 1 || KG < 1 || n_tiles < 1 || dp < 1 || B_a < 1 || B_a > MAX_BA ||
      C < 2 || C > 64 || (C & (C - 1)) != 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (dp + BP - 1) / BP;
  const int m_blocks = (M + BM - 1) / BM;
  // kg slices: enough blocks for ~4 per SM, whole KC-group steps each
  const int steps = (KG + KC - 1) / KC;
  const int base = n_tiles * n_chunks * m_blocks;
  int z = (4 * n_sm + base - 1) / base;
  z = z < 1 ? 1 : (z > steps ? steps : z);
  const int kg_per = (steps + z - 1) / z * KC;
  z = (KG + kg_per - 1) / kg_per;
  if (z > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)M * n_tiles * dp * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_tiles * n_chunks, m_blocks, z);
  const int8_t* c8 = static_cast<const int8_t*>(codes);
  const int32_t* rb = static_cast<const int32_t*>(rowbase);
  const int32_t* t = static_cast<const int32_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
#define TLMAC_GEMM_CASE(BA)                                                          \
  case BA:                                                                           \
    tlmac_gemm_kernel<BA><<<grid, THREADS, 0, s>>>(c8, rb, t, o, M, KG, dp, n_chunks, \
                                                   C, kg_per);                       \
    break;
  switch (B_a) {
    TLMAC_GEMM_CASE(1) TLMAC_GEMM_CASE(2) TLMAC_GEMM_CASE(3) TLMAC_GEMM_CASE(4)
    TLMAC_GEMM_CASE(5) TLMAC_GEMM_CASE(6) TLMAC_GEMM_CASE(7) TLMAC_GEMM_CASE(8)
  }
#undef TLMAC_GEMM_CASE
  return (int)cudaGetLastError();
}
