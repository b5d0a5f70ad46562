// Fused bit-plane pack + table-lookup GEMM (TLMAC, paper Eq. 3) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/tlmac_fused.py::tlmac_gemm_fused
// (body _kernel; plan wrapper tlmac_matmul_fused).  Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_b 2^b sum_kg table[cl[nt,kg], idx[nt,kg,p], code_b(m,kg)]
//   code_b(m,kg)      = sum_g bit_b(a[m, kg*G + g]) << g
//
// from the raw activation codes a [M, K] int8, the plan's exec_idx
// [n_tiles, kg, dp] in its stored dtype (uint8 when N_arr <= 256, else int16),
// step_cluster [n_tiles, kg] int8 and table [n_clus, N_arr, 2^G] int32.  The
// table row cl*N_arr + idx is formed in-register: no int32 rowbase array is
// ever materialised.
//
// Bound.  Each input read once and the output written once: at decode
// (M <= 4) the exec_idx stream dominates (8 MiB for a 4096x4096 layer at
// int16) and the kernel is bound by device-memory bytes; at prefill
// (M = 64) the M*B_a*kg*N lookup-adds dominate and it is bound by
// operations.  What actually limits a gather kernel on Hopper is neither:
// a random 4-byte load costs one L1 wavefront per thread.  Design:
//   - a block owns one (m-block, output tile, kg slice): the TPU kernel's
//     sequential k grid axis (accumulating in out_ref) becomes a third
//     grid axis sized so that ~4 blocks per SM are in flight, and the
//     slices' partial sums are added into a zeroed output with int32
//     atomics (exact and order-free, so the result is deterministic);
//   - per 32-group tile the block stages the row ids cl*N_arr + idx of
//     all its (group, column) pairs in shared memory (coalesced reads of
//     the stored uint8/int16 indices: no int32 rowbase array is ever
//     materialised in device memory) and the per-plane G-bit group codes
//     of its BM activation rows (the fused Eq. 3 packing);
//   - a half-warp loads one 16-entry table row as 16 coalesced lanes (one
//     wavefront per (group, column), not one per lookup) and every lane m
//     < BM picks its B_a entries with __shfl_sync, so one row load serves
//     B_a * BM lookups; a half-warp owns its output columns across the
//     whole slice, so each (row, column) sum lives in one register;
//   - the table (1 MiB at full width) does not fit the 227 KB of shared
//     memory that the TPU's VMEM-resident copy assumed; rows come through
//     L1/L2, and a layer's table stays in the 50 MB L2.
// Ragged kg is handled by the tile bounds; dp need not be a power of two
// (120 for a 13440-wide layer).  G <= 4 (rows of at most 16 entries).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;       // groups staged per tile
constexpr int MAX_BA = 8;    // activation bit-planes
constexpr int MAX_DP = 128;  // output columns per tile (_pick_dp's limit)
constexpr int THREADS = 512;
constexpr int HALF_WARPS = THREADS / 16;
constexpr int MAX_COLS = MAX_DP / HALF_WARPS;  // columns per half-warp
constexpr int UNROLL = 4;    // groups whose row loads are in flight together

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

template <int BM, typename IdxT>
__global__ void __launch_bounds__(THREADS) tlmac_fused_kernel(
    const int8_t* __restrict__ a,             // [M, K]
    const IdxT* __restrict__ exec_idx,        // [n_tiles, kg, dp]
    const int8_t* __restrict__ step_cluster,  // [n_tiles, kg]
    const int32_t* __restrict__ table,        // [n_clus * n_arr, 2^G]
    int32_t* __restrict__ out,                // [M, n_tiles * dp]
    int M, int K, int kg, int kg_per, int dp, int n_arr, int B_a, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_row = reinterpret_cast<int32_t*>(smem);       // [KC][dp]
  uint8_t* s_code = smem + align16(KC * dp * 4);           // [B_a][KC][BM]

  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 15;       // lane in the half-warp == activation row
  const int hw = tid >> 4;
  const int C = 1 << G;
  const int n_cols = (dp + HALF_WARPS - 1) / HALF_WARPS;
  const size_t N = (size_t)gridDim.x * dp;

  int32_t acc[MAX_COLS];
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) acc[c] = 0;

  const IdxT* idx_tile = exec_idx + (size_t)nt * kg * dp;
  const int8_t* cl_tile = step_cluster + (size_t)nt * kg;
  const int k_beg = blockIdx.z * kg_per;
  const int k_end = min(kg, k_beg + kg_per);

  for (int k0 = k_beg; k0 < k_end; k0 += KC) {
    const int kc_n = min(KC, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kc_n * dp; i += THREADS) {
      const int kc = i / dp, p = i - kc * dp;
      const int k = k0 + kc;
      s_row[i] = (int)cl_tile[k] * n_arr + (int)idx_tile[(size_t)k * dp + p];
    }
    for (int i = tid; i < KC * BM; i += THREADS) {
      const int kc = i / BM, mm = i - kc * BM;
      const int m = m0 + mm;
      int code[MAX_BA];
#pragma unroll
      for (int b = 0; b < MAX_BA; ++b) code[b] = 0;
      if (m < M && kc < kc_n) {
        const int8_t* src = a + (size_t)m * K + (size_t)(k0 + kc) * G;
        for (int g = 0; g < G; ++g) {
          const int v = (uint8_t)src[g];
#pragma unroll
          for (int b = 0; b < MAX_BA; ++b) code[b] |= ((v >> b) & 1) << g;
        }
      }
#pragma unroll
      for (int b = 0; b < MAX_BA; ++b)
        if (b < B_a) s_code[(b * KC + kc) * BM + mm] = (uint8_t)code[b];
    }
    __syncthreads();
    for (int kc0 = 0; kc0 < kc_n; kc0 += UNROLL) {
      // issue every row load of UNROLL groups first (latency hiding),
      // then select and accumulate
      int32_t v[UNROLL][MAX_COLS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c) {
          const int p = hw + c * HALF_WARPS;
          const bool ok = kc0 + u < kc_n && c < n_cols && p < dp;
          const int row = ok ? s_row[(kc0 + u) * dp + p] : 0;
          v[u][c] = lane < C ? __ldg(table + (size_t)row * C + lane) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kc = kc0 + u;
        int code[MAX_BA];
#pragma unroll
        for (int b = 0; b < MAX_BA; ++b)
          code[b] = (b < B_a && lane < BM && kc < kc_n)
                        ? s_code[(b * KC + kc) * BM + lane] : 0;
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c) {
          int32_t sum = 0;
#pragma unroll
          for (int b = 0; b < MAX_BA; ++b)
            if (b < B_a) sum += __shfl_sync(0xffffffffu, v[u][c], code[b], 16) << b;
          if (kc < kc_n) acc[c] += sum;
        }
      }
    }
  }
  // each (row m0 + lane, column p) sum is owned by exactly one thread
  if (lane >= BM || m0 + lane >= M) return;
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int p = hw + c * HALF_WARPS;
    if (c >= n_cols || p >= dp) break;
    int32_t* dst = out + (size_t)(m0 + lane) * N + (size_t)nt * dp + p;
    if (gridDim.z == 1)
      *dst = acc[c];
    else
      atomicAdd(dst, acc[c]);
  }
}

template <int BM, typename IdxT>
cudaError_t launch(const int8_t* a, const IdxT* idx, const int8_t* cl,
                   const int32_t* table, int32_t* out, int M, int K,
                   int n_tiles, int kg, int dp, int n_arr, int B_a, int G,
                   cudaStream_t stream) {
  const int m_blocks = (M + BM - 1) / BM;
  // kg slices: enough blocks for ~4 per SM, whole 32-group tiles each
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return cudaGetLastError();
  }
  const int tiles = (kg + KC - 1) / KC;
  const int base = n_tiles * m_blocks;
  int z = (4 * n_sm + base - 1) / base;
  z = z < 1 ? 1 : (z > tiles ? tiles : z);
  const int kg_per = (tiles + z - 1) / z * KC;
  z = (kg + kg_per - 1) / kg_per;
  const dim3 grid(n_tiles, m_blocks, z);
  const dim3 block(THREADS);
  if (z > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)M * n_tiles * dp * sizeof(int32_t), stream);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = align16(KC * dp * 4) + (size_t)B_a * KC * BM;
  tlmac_fused_kernel<BM, IdxT><<<grid, block, smem, stream>>>(
      a, idx, cl, table, out, M, K, kg, kg_per, dp, n_arr, B_a, G);
  return cudaGetLastError();
}

template <typename IdxT>
cudaError_t dispatch_m(const int8_t* a, const IdxT* idx, const int8_t* cl,
                       const int32_t* table, int32_t* out, int M, int K,
                       int n_tiles, int kg, int dp, int n_arr, int B_a, int G,
                       cudaStream_t s) {
  if (M <= 1) return launch<1>(a, idx, cl, table, out, M, K, n_tiles, kg, dp, n_arr, B_a, G, s);
  if (M <= 4) return launch<4>(a, idx, cl, table, out, M, K, n_tiles, kg, dp, n_arr, B_a, G, s);
  if (M <= 8) return launch<8>(a, idx, cl, table, out, M, K, n_tiles, kg, dp, n_arr, B_a, G, s);
  return launch<16>(a, idx, cl, table, out, M, K, n_tiles, kg, dp, n_arr, B_a, G, s);
}

}  // namespace

// idx_bytes: 1 = uint8 exec_idx, 2 = int16 exec_idx.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tlmac_fused_launch(const void* a, const void* exec_idx, int idx_bytes,
                                  const void* step_cluster, const void* table, void* out,
                                  int M, int K, int n_tiles, int kg, int dp, int n_arr,
                                  int B_a, int G, void* stream) {
  if (M < 1 || B_a < 1 || B_a > MAX_BA || G < 1 || G > 4 || K != kg * G ||
      dp < 1 || dp > MAX_DP || n_tiles < 1 ||
      (M + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* cl = static_cast<const int8_t*>(step_cluster);
  const int32_t* t = static_cast<const int32_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 1)
    return (int)dispatch_m(a8, static_cast<const uint8_t*>(exec_idx), cl, t, o, M, K,
                           n_tiles, kg, dp, n_arr, B_a, G, s);
  if (idx_bytes == 2)
    return (int)dispatch_m(a8, static_cast<const int16_t*>(exec_idx), cl, t, o, M, K,
                           n_tiles, kg, dp, n_arr, B_a, G, s);
  return (int)cudaErrorInvalidValue;
}
