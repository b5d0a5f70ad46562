// Cluster-scheduled table-lookup GEMM (the paper's PE control structure)
// for Hopper: one kernel for both TPU kernels of
// src/repro/kernels/tlmac_clustered.py,
//   tlmac_gemm_clustered        (body _kernel, one output tile)   -> n_tiles = 1
//   tlmac_gemm_clustered_multi  (body _kernel_multi, every tile)  -> n_tiles >= 1
// Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_b 2^b sum_c sum_i
//       table_pad[c, idx_sorted[nt, c, i, p], codes_sorted[b, m, (nt*n_clus + c)*ms + i]]
//
// from codes_sorted [B_a, M, n_tiles*n_clus*ms] int8 (group codes gathered
// into cluster order), idx_sorted [n_tiles, n_clus, ms, dp] int32 (LUT-array
// id within the cluster; N_arr on padding steps, the zero row) and
// table_pad [n_clus, N_arr+1, 2^G] int32.
//
// The TPU design streams only cluster c's table slice into VMEM at grid step
// c (the grid coordinate is the paper's mapping-memory select signal).  Here
// the slice goes into SHARED memory, the VMEM of an SM:
//   - a block owns (output tile nt, 64-column chunk, 64-row block) and walks
//     the clusters in order; slice c+1 is copied in with cp.async while the
//     steps of cluster c run on slice c (double buffer), so the select signal
//     is the loop index and every lookup is a shared-memory read;
//   - as in tlmac_gemm.cu, lanes own 32 consecutive rows and a warp whole
//     columns, so the 32 lookups of one read fall in one slice row (at most
//     2^G <= 64 ints): conflict-free for G <= 5, at most 2-way for G = 6;
//   - per 32-step run the block stages idx_sorted rows (coalesced along p,
//     pre-scaled by 2^G) and the code planes of its rows in shared memory;
//   - a run of a (tile, cluster) ends after its last step that selects a
//     real row in the block's columns: the padding steps of the schedule
//     (zero row) are skipped, not looked up;
//   - B_a is a template parameter: the plane loop is exactly B_a lookups;
//   - every cluster of a tile is walked by the same block, so no atomics:
//     the tile is transposed through shared memory and stored coalesced.
// Bound.  M*B_a*D_s*dp lookup-adds for the live steps, against the bytes of
// the three inputs and the output; the operations bound it at conv shapes.
// Capacity.  Two slices of (N_arr+1)*2^G int32 must fit the block's shared
// memory next to 41 KB of staging: the wrapper rejects larger plans (a G=4
// plan at N_arr=4096 has a 262 KB slice) with a ValueError before launching.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;           // steps staged per run
constexpr int MAX_BA = 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MR = 2;
constexpr int BM = 32 * MR;
constexpr int CPW = 8;
constexpr int BP = WARPS * CPW;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BA>
__global__ void __launch_bounds__(THREADS) tlmac_clustered_kernel(
    const int8_t* __restrict__ codes,      // [B_a, M, n_tiles*n_clus*ms]
    const int32_t* __restrict__ idx,       // [n_tiles, n_clus, ms, dp]
    const int32_t* __restrict__ table,     // [n_clus, n_arr1, C]
    int32_t* __restrict__ out,             // [M, n_tiles*dp]
    int M, int n_tiles, int n_clus, int ms, int dp, int n_chunks, int n_arr1,
    int C) {
  extern __shared__ __align__(16) int32_t s_tab[];  // [2][n_arr1 * C]
  __shared__ int32_t s_row[KC][BP];
  __shared__ uint8_t s_code[BA][KC][BM];
  __shared__ int32_t s_out[BM][BP + 1];
  __shared__ int s_live;

  const int nt = blockIdx.x / n_chunks;
  const int p0 = (blockIdx.x - nt * n_chunks) * BP;
  const int np = min(BP, dp - p0);
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slice = n_arr1 * C;                   // ints, a multiple of 4
  const size_t L = (size_t)n_tiles * n_clus * ms; // code columns per row

  auto load_slice = [&](int c, int buf) {
    const int4* src = reinterpret_cast<const int4*>(table + (size_t)c * slice);
    int32_t* dst = s_tab + buf * slice;
    for (int i = tid; i < slice / 4; i += THREADS) cp_async16(dst + 4 * i, src + i);
    cp_async_commit();
  };

  int32_t acc[CPW][MR];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0;

  load_slice(0, 0);
  for (int cl = 0; cl < n_clus; ++cl) {
    const int buf = cl & 1;
    if (cl + 1 < n_clus) {
      load_slice(cl + 1, buf ^ 1);  // in flight while cluster cl runs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice cl is visible to every thread
    const int32_t* tab = s_tab + buf * slice;
    const size_t run = (size_t)nt * n_clus + cl;
    const int32_t* idx_run = idx + run * ms * dp;
    const size_t col0 = run * ms;
    // steps after the last one that selects a real row in this block's
    // columns read only the zero row: the run ends there (the schedule
    // pads every run to ms with such steps)
    if (tid == 0) s_live = 0;
    __syncthreads();
    int last = 0;
    for (int i = tid; i < ms * np; i += THREADS) {
      const int step = i / np;
      if (idx_run[(size_t)step * dp + p0 + (i - step * np)] != n_arr1 - 1)
        last = step + 1;
    }
    if (last) atomicMax(&s_live, last);
    __syncthreads();
    const int live = s_live;
    for (int i0 = 0; i0 < live; i0 += KC) {
      const int kc_n = min(KC, live - i0);
      __syncthreads();  // the previous run's staging is consumed
      for (int i = tid; i < KC * BP; i += THREADS) {
        const int kc = i / BP, pp = i - kc * BP;
        s_row[kc][pp] = (kc < kc_n && pp < np)
                            ? idx_run[(size_t)(i0 + kc) * dp + p0 + pp] * C : 0;
      }
      for (int i = tid; i < BA * BM * KC; i += THREADS) {
        const int kc = i % KC, rest = i / KC;
        const int mm = rest % BM, b = rest / BM;
        const int m = m0 + mm;
        s_code[b][kc][mm] = (m < M && kc < kc_n)
                                ? (uint8_t)codes[((size_t)b * M + m) * L + col0 + i0 + kc]
                                : 0;
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
            const int32_t* row = tab + s_row[kc][pp];
#pragma unroll
            for (int r = 0; r < MR; ++r) {
              int32_t sum = 0;
#pragma unroll
              for (int b = 0; b < BA; ++b) sum += row[code[b][r]] << b;
              acc[c][r] += sum;
            }
          }
        }
      }
    }
    __syncthreads();  // slice buf is consumed before it is refilled
  }

#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) s_out[lane + 32 * r][warp * CPW + c] = acc[c][r];
  __syncthreads();
  const size_t N = (size_t)n_tiles * dp;
  for (int i = tid; i < BM * BP; i += THREADS) {
    const int mm = i / BP, pp = i - mm * BP;
    const int m = m0 + mm;
    if (m < M && pp < np) out[(size_t)m * N + (size_t)nt * dp + p0 + pp] = s_out[mm][pp];
  }
}

// Dynamic shared memory a block of the BA instance may take beside its
// static staging buffers (raised to that limit once); -1 if a device query
// fails.
template <int BA>
int max_dynamic_smem() {
  static int max_dyn = -1;
  if (max_dyn < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&fa, tlmac_clustered_kernel<BA>) != cudaSuccess)
      return -1;
    const int limit = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(tlmac_clustered_kernel<BA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, limit) !=
        cudaSuccess)
      return -1;
    max_dyn = limit;
  }
  return max_dyn;
}

template <int BA>
int launch_ba(const void* codes, const void* idx, const void* table, void* out, int M,
              int n_tiles, int n_clus, int ms, int dp, int n_arr1, int C,
              cudaStream_t stream) {
  const size_t dyn = 2 * sizeof(int32_t) * (size_t)n_arr1 * C;
  const int max_dyn = max_dynamic_smem<BA>();
  if (max_dyn < 0) return (int)cudaGetLastError();
  if (dyn > (size_t)max_dyn) return (int)cudaErrorInvalidValue;
  const int n_chunks = (dp + BP - 1) / BP;
  const dim3 grid(n_tiles * n_chunks, (M + BM - 1) / BM);
  tlmac_clustered_kernel<BA><<<grid, THREADS, dyn, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), M, n_tiles, n_clus,
      ms, dp, n_chunks, n_arr1, C);
  return (int)cudaGetLastError();
}

int launch(const void* codes, const void* idx, const void* table, void* out, int M,
           int n_tiles, int n_clus, int ms, int dp, int n_arr1, int C, int B_a,
           void* stream) {
  if (M < 1 || n_tiles < 1 || n_clus < 1 || ms < 1 || dp < 1 || n_arr1 < 1 ||
      B_a < 1 || B_a > MAX_BA || C < 4 || C > 64 || (C & (C - 1)) != 0 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B_a) {
#define TLMAC_CLUSTERED_CASE(BA) \
  case BA:                       \
    return launch_ba<BA>(codes, idx, table, out, M, n_tiles, n_clus, ms, dp, n_arr1, C, s);
    TLMAC_CLUSTERED_CASE(1) TLMAC_CLUSTERED_CASE(2) TLMAC_CLUSTERED_CASE(3)
    TLMAC_CLUSTERED_CASE(4) TLMAC_CLUSTERED_CASE(5) TLMAC_CLUSTERED_CASE(6)
    TLMAC_CLUSTERED_CASE(7) TLMAC_CLUSTERED_CASE(8)
#undef TLMAC_CLUSTERED_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Largest table slice, in bytes, that the kernel can double-buffer at
// every B_a (the instance with the most staging memory, B_a = 8).
extern "C" int tlmac_clustered_max_slice_bytes() {
  const int max_dyn = max_dynamic_smem<MAX_BA>();
  return max_dyn < 0 ? -1 : max_dyn / 2;
}

// Kernel 5: one output tile (codes_sorted [B_a, M, n_clus*ms],
// idx_sorted [n_clus, ms, dp]).
extern "C" int tlmac_clustered_launch(const void* codes, const void* idx, const void* table,
                                      void* out, int M, int n_clus, int ms, int dp,
                                      int n_arr1, int C, int B_a, void* stream) {
  return launch(codes, idx, table, out, M, 1, n_clus, ms, dp, n_arr1, C, B_a, stream);
}

// Kernel 6: every output tile of a layer in one launch.
extern "C" int tlmac_clustered_multi_launch(const void* codes, const void* idx,
                                            const void* table, void* out, int M,
                                            int n_tiles, int n_clus, int ms, int dp,
                                            int n_arr1, int C, int B_a, void* stream) {
  return launch(codes, idx, table, out, M, n_tiles, n_clus, ms, dp, n_arr1, C, B_a, stream);
}
