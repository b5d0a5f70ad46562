// Fused bit-plane pack + table-lookup GEMM (TLMAC, paper Eq. 3) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/tlmac_fused.py::tlmac_gemm_fused
// (body _kernel; plan wrapper tlmac_matmul_fused).  Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_b 2^b sum_kg T[cl[nt,kg], idx[nt,kg,p], code_b(m,kg)]
//   code_b(m,kg)      = sum_g bit_b(a[m, kg*G + g]) << g
//
// from the raw activation codes a [M, K] int8, the plan's exec_idx
// [n_tiles, kg, dp] in its stored dtype (uint8 or int16), step_cluster
// [n_tiles, kg] int8 and a narrow table [n_clus, N_arr, 2^G] (int8 rows, or
// int16 where an entry leaves int8; see kernels/tlmac_fused.py::narrow_table).
//
// One-hot coefficient form (the TPU kernel's 'onehot' formulation,
// src/repro/kernels/tlmac_gemm.py:62-94).  The sum over the B_a planes is a
// small integer dot product per table row:
//
//   out[m, p] = sum_kg sum_c T[r(kg, p), c] * coef[m, kg, c]
//   coef[m, kg, c] = sum_b 2^b [code_b(m, kg) == c]   (0 <= coef <= 2^B_a - 1)
//
// A block builds the coef tile of its rows once per group step in shared
// memory (the fused Eq. 3 pack, 2^G bytes per (m, kg)); B_a then leaves the
// inner loop.  Each gathered row is reduced against the coef vectors:
//   - small M (decode, M <= 16; and every int16 table): a thread owns one
//     output column p, gathers its row as one vector load (16 B at G = 4)
//     and reduces it with dp4a (s8 rows x u8 coef; dp2a for int16 rows)
//     against the warp-uniform coef vectors of its BM rows;
//   - larger M (prefill chunks, ResNet row plans): 8-bit mma.sync
//     m16n8k32 (u8 coef x s8 rows, s32 accumulate), the coef tile as the A
//     operand and the gathered rows, staged in shared memory, as B: the TPU
//     kernel's one_hot @ gathered-table product on the tensor cores.
//
// Bound.  Each input read once and the output written once: at decode the
// exec_idx stream dominates (8 MiB for a 4096x4096 layer at int16) and the
// work is bound by device-memory bytes; the one-hot product is
// 2*M*2^G*kg*N integer operations, far below the int8 tensor-core rate.
// What limits a gather kernel on Hopper is neither: every (kg, p) pair
// gathers one random table row, and a random row costs about one L1
// wavefront (measured: about one row per clock per SM at best).  Narrow rows
// make that one 16-byte load per pair where the int32 rows of the first
// version needed 64 bytes and a shuffle per lookup.  A serve linear's int8
// table is 256 KB (4 clusters x 4096 rows x 16 B), too much for L1, but each
// block walks its steps cluster by cluster (steps_by_cluster), so the blocks
// of a wave gather from one 64 KB cluster slice at a time and hit L1.
// exec_idx is staged with cp.async (16-byte chunks through L2 only,
// double-buffered) in the small-M kernel so that its HBM stream overlaps
// the gathers of the previous step.
//
// Grids: (n_tiles x column tiles, m-blocks, kg slices).  A block covers at
// most COLS = 128 of a tile's dp columns (the small-M kernel one column per
// thread, the mma kernel 64 * WN), so a tile of dp > 128 columns runs as
// ceil(dp / 128) column tiles, each staging only its own columns' indices.
// The kg axis is split until the grid holds about four blocks per SM (one
// wave) and no slice exceeds MAX_SLICE groups; the slices' partial sums are
// added into a zeroed output with int32 atomics (exact and order-free).
// Ragged kg and any dp are handled by bounds; G in 1..6 (2^G one-hot entries
// per group: 64 at G = 6, rows of 64 bytes as int8 and 128 as int16).
//
// Expert axis (the reference's jax.vmap over an expert-stacked linear,
// src/repro/models/nn.py::serve_expert_linear_apply): E experts' operands
// a [E, M, K], exec_idx [E, n_tiles, kg, dp], step_cluster [E, n_tiles, kg]
// and table [E, n_clus, N_arr, 2^G] -> out [E, M, N] in one launch.  The
// grid's z axis runs over (expert, kg slice); a block offsets every operand
// by its expert's stride and then computes what the single-linear kernel
// computes.  The expert instances are separate kernels
// (tlmac_fused_expert_*), so E = 1 launches the same code as before and a
// profile tells the two apart.  One instance set that always applies the
// offsets (E = 1: expert 0) ran a codeqwen decode layer's single linears
// 2-3% slower at M = 4 and 9-12% at M = 20 and 64 on an H100
// (chip_smoke.py --only k12): the offset pointers then live in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int COLS = 128;   // output columns per block (a column tile of dp)

// ---------------------------------------------------------------------------
// small pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ int dp4a_su(uint32_t a_s8x4, uint32_t b_u8x4, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a_s8x4), "r"(b_u8x4), "r"(c));
  return d;
}

__device__ __forceinline__ int dp2a_lo_su(uint32_t a_s16x2, uint32_t b_u8x4, int c) {
  int d;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a_s16x2), "r"(b_u8x4), "r"(c));
  return d;
}

__device__ __forceinline__ int dp2a_hi_su(uint32_t a_s16x2, uint32_t b_u8x4, int c) {
  int d;
  asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a_s16x2), "r"(b_u8x4), "r"(c));
  return d;
}

// streamed data (the indices): 16 bytes through L2 only, keeping L1 for
// the table rows
__device__ __forceinline__ void cp_async_stream16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// gathered table rows: through L1, where a cluster's rows are reused
template <int BYTES>
__device__ __forceinline__ void cp_async_row(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

// one gathered row of C int8 entries into shared memory (C >= 4: cp.async in
// pieces of at most 16 bytes; C = 2: a plain 2-byte copy)
template <int C>
__device__ __forceinline__ void copy_row(uint8_t* dst, const int8_t* src) {
  if constexpr (C > 16) {
#pragma unroll
    for (int i = 0; i < C / 16; ++i) cp_async_row<16>(dst + 16 * i, src + 16 * i);
  } else if constexpr (C >= 4) {
    cp_async_row<C>(dst, src);
  } else {
    *reinterpret_cast<uint16_t*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

// The coefficient bytes of one (m, kg): byte c of the C = 2^G bytes is
// sum_b 2^b [code_b == c], packed little-endian into CW 32-bit words (a
// G = 1 pair fills the low half of one word).  Bits of a code above B_a are
// ignored, as in the reference's packing.
template <int G>
__device__ __forceinline__ void build_coef(const int8_t* src, int B_a,
                                           uint32_t (&w)[(1 << G) >= 4 ? (1 << G) / 4 : 1]) {
  constexpr int CW = (1 << G) >= 4 ? (1 << G) / 4 : 1;
  uint32_t v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = (uint8_t)src[g];
#pragma unroll
  for (int j = 0; j < CW; ++j) w[j] = 0;
  for (int b = 0; b < B_a; ++b) {
    uint32_t code = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) code |= ((v[g] >> b) & 1u) << g;
    const uint32_t add = (1u << b) << (8 * (code & 3u));
#pragma unroll
    for (int j = 0; j < CW; ++j) w[j] += (code >> 2) == (uint32_t)j ? add : 0u;
  }
}

// one table row of RB bytes as NW 32-bit words (RB = 2 fills the low half)
template <int RB>
struct Row {
  static constexpr int NW = RB >= 4 ? RB / 4 : 1;
  uint32_t w[NW];
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (RB >= 16) {
#pragma unroll
      for (int i = 0; i < RB / 16; ++i) {
        const uint4 x = __ldg(static_cast<const uint4*>(p) + i);
        w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
      }
    } else if constexpr (RB == 8) {
      const uint2 x = __ldg(static_cast<const uint2*>(p));
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (RB == 4) {
      w[0] = __ldg(static_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(static_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = 0;
  }
};

// sum_c row[c] * coef[c] for a row of C entries of type T
template <typename T, int C>
__device__ __forceinline__ int row_dot(const uint32_t* row, const uint32_t* coef, int acc) {
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int j = 0; j < (C >= 4 ? C / 4 : 1); ++j) acc = dp4a_su(row[j], coef[j], acc);
  } else {
    // int16 rows: word q holds entries 2q, 2q+1; coef word q/2 holds them
    // in its low (q even) or high (q odd) byte pair
#pragma unroll
    for (int q = 0; q < C / 2; ++q)
      acc = (q & 1) ? dp2a_hi_su(row[q], coef[q >> 1], acc)
                    : dp2a_lo_su(row[q], coef[q >> 1], acc);
  }
  return acc;
}

__device__ __forceinline__ int load_idx(const uint8_t* s_idx, int ib, int i) {
  return ib == 1 ? (int)s_idx[i] : (int)reinterpret_cast<const int16_t*>(s_idx)[i];
}

constexpr int MAX_SLICE = 1024;   // steps a block walks (one kg slice)

// The steps [k_beg, k_end) of a block's kg slice in cluster order (offsets
// from k_beg, by a counting sort of step_cluster in shared memory).  Every
// block of a wave then walks cluster 0's steps, then cluster 1's, and so on
// at about the same time, so the rows an SM gathers at a time come from one
// cluster's slice of the table (64 KB of int8 rows at G = 4, N_arr = 4096)
// and stay in L1.  The sum is exact, so the order changes nothing.
__device__ void steps_by_cluster(const int8_t* cl_tile, int k_beg, int k_end, int16_t* s_order,
                                 int* s_cnt) {
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int k = k_beg + threadIdx.x; k < k_end; k += blockDim.x)
    atomicAdd(&s_cnt[cl_tile[k] & 127], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c < 128; ++c) {
      const int t = s_cnt[c];
      s_cnt[c] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int k = k_beg + threadIdx.x; k < k_end; k += blockDim.x)
    s_order[atomicAdd(&s_cnt[cl_tile[k] & 127], 1)] = (int16_t)(k - k_beg);
  __syncthreads();
}

__device__ __forceinline__ void store_out(int32_t* dst, int32_t v, bool atomic) {
  if (atomic)
    atomicAdd(dst, v);
  else
    *dst = v;
}

// ---------------------------------------------------------------------------
// small M: a thread owns a column, dp4a/dp2a against the coef vectors
// ---------------------------------------------------------------------------

constexpr int DOT_THREADS = COLS;  // one output column per thread
constexpr int DOT_KC = 16;         // groups per staged step

// TILED: dp > COLS, the grid's x axis runs over (tile, column tile); the
// serve path's dp <= 128 takes the instance without it (no index division).
// Per-expert operand strides of an expert-stacked launch (elements of a,
// step_cluster, table and out; bytes of exec_idx) and the kg slices of one
// expert (the grid's z axis is expert x slice).
struct ExpertStrides {
  long long a, idx, cl, tab, out;
  int zs;
};

// Sets `zsl` (the block's kg slice) and `split` (whether slices share the
// output), and moves an expert-stacked launch's operands to the block's
// expert.
#define REPRO_EXPERT_SLICE()                                 \
  int zsl = blockIdx.z;                                      \
  bool split = gridDim.z > 1;                                \
  if constexpr (EXPERT) {                                    \
    const int e = blockIdx.z / es.zs;                        \
    zsl = blockIdx.z - e * es.zs;                            \
    split = es.zs > 1;                                       \
    a += e * es.a;                                           \
    exec_idx += e * es.idx;                                  \
    step_cluster += e * es.cl;                               \
    table += e * es.tab;                                     \
    out += e * es.out;                                       \
  }

template <int G, typename T, int BM, bool TILED, bool EXPERT>
__device__ __forceinline__ void tlmac_fused_dot_body(
    const int8_t* __restrict__ a,             // [M, K]
    const uint8_t* __restrict__ exec_idx,     // [n_tiles, kg, dp] of ib bytes each
    int ib, int vec_idx,
    const int8_t* __restrict__ step_cluster,  // [n_tiles, kg]
    const T* __restrict__ table,              // [n_clus * n_arr, 2^G]
    int32_t* __restrict__ out,                // [M, n_tiles * dp]
    int M, int K, int kg, int kg_per, int dp, int n_pc, int n_arr, int B_a,
    const ExpertStrides& es) {
  constexpr int C = 1 << G;
  constexpr int CW = C >= 4 ? C / 4 : 1;      // coef words per (m, kg)
  constexpr int RB = C * (int)sizeof(T);      // row bytes
  using R = Row<RB>;
  constexpr int U = R::NW >= 16 ? 2 : R::NW >= 8 ? 4 : 8;   // rows in flight per thread
  constexpr int IDX_BUF = DOT_KC * COLS * 2;

  __shared__ __align__(16) uint8_t s_idx[2][IDX_BUF];
  __shared__ __align__(16) uint32_t s_coef[DOT_KC][BM][CW];
  __shared__ int s_clbase[DOT_KC];
  __shared__ int16_t s_order[MAX_SLICE];
  __shared__ int s_cnt[128];

  const int nt = TILED ? blockIdx.x / n_pc : blockIdx.x;
  const int c0 = TILED ? (blockIdx.x - nt * n_pc) * COLS : 0;  // first column
  const int dpb = TILED ? min(COLS, dp - c0) : dp;            // the block's columns
  const int m0 = blockIdx.y * BM;
  const int p = threadIdx.x;
  const size_t N = (size_t)(TILED ? gridDim.x / n_pc : gridDim.x) * dp;
  REPRO_EXPERT_SLICE();
  const int k_beg = zsl * kg_per;
  const int k_end = min(kg, k_beg + kg_per);
  const uint8_t* idx_tile = exec_idx + ((size_t)nt * kg * dp + c0) * ib;
  const int8_t* cl_tile = step_cluster + (size_t)nt * kg;

  steps_by_cluster(cl_tile, k_beg, k_end, s_order, s_cnt);
  // the j-th step of the slice in cluster order
  auto step = [&](int j) { return k_beg + (int)s_order[j - k_beg]; };
  const int rowb = dp * ib;    // bytes of one step's exec_idx row
  const int rowbb = dpb * ib;  // the block's bytes of it (staged rows)
  // stage the block's exec_idx columns of slice positions [j0, j0 + kc_n)
  // into `buf`
  auto stage = [&](int j0, int buf) {
    const int kc_n = min(DOT_KC, k_end - j0);
    if (vec_idx) {
      const int cps = rowbb / 16;
      for (int c = threadIdx.x; c < kc_n * cps; c += DOT_THREADS) {
        const int kc = c / cps, off = (c - kc * cps) * 16;
        cp_async_stream16(&s_idx[buf][kc * rowbb + off],
                          idx_tile + (size_t)step(j0 + kc) * rowb + off);
      }
    } else {
      for (int i = threadIdx.x; i < kc_n * rowbb; i += DOT_THREADS) {
        const int kc = i / rowbb, off = i - kc * rowbb;
        s_idx[buf][i] = idx_tile[(size_t)step(j0 + kc) * rowb + off];
      }
    }
    cp_async_commit();
  };

  int acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0;

  if (k_beg < k_end) stage(k_beg, 0);
  int buf = 0;
  for (int k0 = k_beg; k0 < k_end; k0 += DOT_KC, buf ^= 1) {
    const int kc_n = min(DOT_KC, k_end - k0);
    if (k0 + DOT_KC < k_end) stage(k0 + DOT_KC, buf ^ 1);
    // coef tile and cluster row bases of this step
    for (int i = threadIdx.x; i < DOT_KC * BM; i += DOT_THREADS) {
      const int kc = i / BM, mm = i - kc * BM;
      const int m = m0 + mm;
      uint32_t w[CW];
      if (m < M && kc < kc_n) {
        build_coef<G>(a + (size_t)m * K + (size_t)step(k0 + kc) * G, B_a, w);
      } else {
#pragma unroll
        for (int j = 0; j < CW; ++j) w[j] = 0;
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) s_coef[kc][mm][j] = w[j];
    }
    for (int kc = threadIdx.x; kc < kc_n; kc += DOT_THREADS)
      s_clbase[kc] = (int)cl_tile[step(k0 + kc)] * n_arr;
    if (k0 + DOT_KC < k_end)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    for (int kc0 = 0; kc0 < kc_n; kc0 += U) {
      R rows[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kc = kc0 + u;
        if (kc < kc_n && p < dpb) {
          const int r = s_clbase[kc] + load_idx(s_idx[buf], ib, kc * dpb + p);
          rows[u].load(table + (size_t)r * C);
        } else {
          rows[u].zero();   // adds nothing, whatever the coef slot holds
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kc = min(kc0 + u, DOT_KC - 1);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          uint32_t cw[CW];
#pragma unroll
          for (int j = 0; j < CW; ++j) cw[j] = s_coef[kc][m][j];
          acc[m] = row_dot<T, C>(rows[u].w, cw, acc[m]);
        }
      }
    }
    __syncthreads();   // s_coef, s_clbase and s_idx[buf] are consumed
  }
  if (p >= dpb) return;
#pragma unroll
  for (int m = 0; m < BM; ++m)
    if (m0 + m < M)
      store_out(out + (size_t)(m0 + m) * N + (size_t)nt * dp + c0 + p, acc[m], split);
}

#define REPRO_DOT_PARAMS                                                                   \
  const int8_t *__restrict__ a, const uint8_t *__restrict__ exec_idx, int ib, int vec_idx, \
      const int8_t *__restrict__ step_cluster, const T *__restrict__ table,                \
      int32_t *__restrict__ out, int M, int K, int kg, int kg_per, int dp, int n_pc,       \
      int n_arr, int B_a, ExpertStrides es
#define REPRO_DOT_ARGS \
  a, exec_idx, ib, vec_idx, step_cluster, table, out, M, K, kg, kg_per, dp, n_pc, n_arr, B_a, es

template <int G, typename T, int BM, bool TILED>
__global__ void __launch_bounds__(DOT_THREADS) tlmac_fused_dot_kernel(REPRO_DOT_PARAMS) {
  tlmac_fused_dot_body<G, T, BM, TILED, false>(REPRO_DOT_ARGS);
}

template <int G, typename T, int BM, bool TILED>
__global__ void __launch_bounds__(DOT_THREADS) tlmac_fused_expert_dot_kernel(REPRO_DOT_PARAMS) {
  tlmac_fused_dot_body<G, T, BM, TILED, true>(REPRO_DOT_ARGS);
}

// ---------------------------------------------------------------------------
// larger M: mma.sync m16n8k32 on the coef tile (A) and gathered rows (B)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;   // 8 warps
constexpr int MMA_KB = 128;        // k' bytes (coef bytes of a row) per step
constexpr int MMA_LD = MMA_KB + 16;  // smem row stride: conflict-free fragments

// WN = 1: 8 warps over 8 m16 tiles, each all n8 tiles of dp <= 64.
// WN = 2: 4 m16 tiles x 2 column halves of a 128-column tile of dp.
template <int G, int WN, bool TILED, bool EXPERT>
__device__ __forceinline__ void tlmac_fused_mma_body(
    const int8_t* __restrict__ a, const uint8_t* __restrict__ exec_idx, int ib,
    const int8_t* __restrict__ step_cluster, const int8_t* __restrict__ table,
    int32_t* __restrict__ out, int M, int K, int kg, int kg_per, int dp, int n_pc, int n_arr,
    int B_a, const ExpertStrides& es) {
  constexpr int C = 1 << G;
  constexpr int CW = C >= 4 ? C / 4 : 1;
  constexpr int KC = MMA_KB / C;    // groups per step
  constexpr int BM = 128 / WN;      // rows per block
  constexpr int NP = 64 * WN;       // columns per block (padded)

  __shared__ __align__(16) uint8_t s_a[BM * MMA_LD];   // coef [m][kc*C + c]
  __shared__ __align__(16) uint8_t s_b[NP * MMA_LD];   // rows [p][kc*C + c]
  __shared__ int16_t s_order[MAX_SLICE];
  __shared__ int s_cnt[128];

  const int nt = TILED ? blockIdx.x / n_pc : blockIdx.x;
  const int c0 = TILED ? (blockIdx.x - nt * n_pc) * NP : 0;   // first column
  const int dpb = TILED ? min(NP, dp - c0) : dp;              // the block's columns
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = WN == 1 ? warp : (warp & 3);
  const int wn = WN == 1 ? 0 : (warp >> 2);
  const int nt8 = (dpb + 7) / 8;
  const size_t N = (size_t)(TILED ? gridDim.x / n_pc : gridDim.x) * dp;
  REPRO_EXPERT_SLICE();
  const int k_beg = zsl * kg_per;
  const int k_end = min(kg, k_beg + kg_per);
  const uint8_t* idx_tile = exec_idx + (size_t)nt * kg * dp * ib;
  const int8_t* cl_tile = step_cluster + (size_t)nt * kg;

  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  steps_by_cluster(cl_tile, k_beg, k_end, s_order, s_cnt);
  auto step = [&](int j) { return k_beg + (int)s_order[j - k_beg]; };
  for (int k0 = k_beg; k0 < k_end; k0 += KC) {
    const int kc_n = min(KC, k_end - k0);
    // B: gather the rows of this step's (kc, p) pairs
    for (int i = tid; i < kc_n * dpb; i += MMA_THREADS) {
      const int kc = i / dpb, pp = i - kc * dpb;
      const int k = step(k0 + kc);
      const size_t e = (size_t)k * dp + c0 + pp;
      const int ix = ib == 1 ? (int)idx_tile[e] : (int)reinterpret_cast<const int16_t*>(idx_tile)[e];
      const int r = (int)cl_tile[k] * n_arr + ix;
      copy_row<C>(s_b + pp * MMA_LD + kc * C, table + (size_t)r * C);
    }
    cp_async_commit();
    // A: the coef tile; steps past kc_n are zero so stale B rows add nothing
    for (int i = tid; i < BM * KC; i += MMA_THREADS) {
      const int mm = i / KC, kc = i - mm * KC;
      const int m = m0 + mm;
      uint32_t w[CW];
      if (m < M && kc < kc_n) {
        build_coef<G>(a + (size_t)m * K + (size_t)step(k0 + kc) * G, B_a, w);
      } else {
#pragma unroll
        for (int j = 0; j < CW; ++j) w[j] = 0;
      }
      uint8_t* dst = s_a + mm * MMA_LD + kc * C;
      if constexpr (C >= 4) {
#pragma unroll
        for (int j = 0; j < CW; ++j) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
      } else {
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w[0];
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MMA_KB / 32; ++ks) {
      const uint8_t* ap = s_a + (wm * 16 + grp) * MMA_LD + ks * 32 + tig * 4;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(ap);
      af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * MMA_LD);
      af[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * MMA_LD + 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n8 = wn * 8 + j;
        if (n8 < nt8) {
          const uint8_t* bp = s_b + (n8 * 8 + grp) * MMA_LD + ks * 32 + tig * 4;
          mma_u8s8(acc[j], af, *reinterpret_cast<const uint32_t*>(bp),
                   *reinterpret_cast<const uint32_t*>(bp + 16));
        }
      }
    }
    __syncthreads();
  }
  const int r0 = m0 + wm * 16 + grp;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n8 = wn * 8 + j;
    if (n8 >= nt8) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8;
      const int col = n8 * 8 + tig * 2 + (e & 1);
      if (row < M && col < dpb)
        store_out(out + (size_t)row * N + (size_t)nt * dp + c0 + col, acc[j][e], split);
    }
  }
}

#define REPRO_MMA_PARAMS                                                            \
  const int8_t *__restrict__ a, const uint8_t *__restrict__ exec_idx, int ib,       \
      const int8_t *__restrict__ step_cluster, const int8_t *__restrict__ table,    \
      int32_t *__restrict__ out, int M, int K, int kg, int kg_per, int dp, int n_pc, \
      int n_arr, int B_a, ExpertStrides es
#define REPRO_MMA_ARGS \
  a, exec_idx, ib, step_cluster, table, out, M, K, kg, kg_per, dp, n_pc, n_arr, B_a, es

template <int G, int WN, bool TILED>
__global__ void __launch_bounds__(MMA_THREADS) tlmac_fused_mma_kernel(REPRO_MMA_PARAMS) {
  tlmac_fused_mma_body<G, WN, TILED, false>(REPRO_MMA_ARGS);
}

template <int G, int WN, bool TILED>
__global__ void __launch_bounds__(MMA_THREADS) tlmac_fused_expert_mma_kernel(REPRO_MMA_PARAMS) {
  tlmac_fused_mma_body<G, WN, TILED, true>(REPRO_MMA_ARGS);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 132;
  }
  return n_sm;
}

// kg slices: split while the (tile x m-block) grid is below `target`
// blocks (about four per SM: one wave, so that the blocks walk the clusters
// together), and until a slice holds at most MAX_SLICE groups; whole steps of
// kc groups each.  Returns z and sets kg_per.
int kg_slices(int kg, int kc, int base, int target, int* kg_per) {
  const int steps = (kg + kc - 1) / kc;
  int z = (target + base - 1) / base;
  const int z_min = (kg + MAX_SLICE - 1) / MAX_SLICE;
  z = z < z_min ? z_min : z;
  z = z > steps ? steps : z;
  *kg_per = (steps + z - 1) / z * kc;
  return (kg + *kg_per - 1) / *kg_per;
}

cudaError_t zero_if(bool split, int32_t* out, size_t n, cudaStream_t s) {
  return split ? cudaMemsetAsync(out, 0, n * sizeof(int32_t), s) : cudaSuccess;
}

// The launch geometry shared by both kernels: E experts of n_tiles x n_pc
// column tiles x m_blocks, kg split into z slices per expert (the grid's z
// axis is E x z, at most 65535).  Zeroes the output when slices share it.
struct Geometry {
  dim3 grid;
  int kg_per;
  ExpertStrides es;
  cudaError_t err;
};

Geometry geometry(int E, int n_tiles, int n_pc, int m_blocks, int kg, int kc, int M, int K,
                  int dp, int ib, int n_clus, int n_arr, int C, int32_t* out, cudaStream_t s) {
  Geometry g{};
  const int z = kg_slices(kg, kc, n_tiles * n_pc * m_blocks * E, 4 * sm_count(), &g.kg_per);
  if ((long long)z * E > 65535) {
    g.err = cudaErrorInvalidValue;
    return g;
  }
  g.grid = dim3(n_tiles * n_pc, m_blocks, z * E);
  g.es = ExpertStrides{(long long)M * K, (long long)n_tiles * kg * dp * ib,
                       (long long)n_tiles * kg, (long long)n_clus * n_arr * C,
                       (long long)M * n_tiles * dp, z};
  g.err = zero_if(z > 1, out, (size_t)E * M * n_tiles * dp, s);
  return g;
}

template <int G, typename T, int BM>
cudaError_t launch_dot(const int8_t* a, const uint8_t* idx, int ib, const int8_t* cl,
                       const void* table, int32_t* out, int M, int K, int n_tiles, int kg,
                       int dp, int n_clus, int n_arr, int B_a, int E, cudaStream_t s) {
  const int m_blocks = (M + BM - 1) / BM;
  const int n_pc = (dp + COLS - 1) / COLS;
  const Geometry g =
      geometry(E, n_tiles, n_pc, m_blocks, kg, DOT_KC, M, K, dp, ib, n_clus, n_arr, 1 << G, out, s);
  if (g.err != cudaSuccess) return g.err;
  // 16-byte cp.async of the index rows needs every step's row, and every
  // column tile's part of it, aligned (an expert's indices start on a row)
  const int vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 && (dp * ib) % 16 == 0 &&
                  ((dp % COLS) * ib) % 16 == 0;
  const T* tab = static_cast<const T*>(table);
#define REPRO_LAUNCH(KERNEL, TILED)                                                     \
  KERNEL<G, T, BM, TILED><<<g.grid, DOT_THREADS, 0, s>>>(a, idx, ib, vec, cl, tab, out, M, K, \
                                                         kg, g.kg_per, dp, n_pc, n_arr, B_a, g.es)
  if (E > 1) {
    if (n_pc > 1)
      REPRO_LAUNCH(tlmac_fused_expert_dot_kernel, true);
    else
      REPRO_LAUNCH(tlmac_fused_expert_dot_kernel, false);
  } else if (n_pc > 1) {
    REPRO_LAUNCH(tlmac_fused_dot_kernel, true);
  } else {
    REPRO_LAUNCH(tlmac_fused_dot_kernel, false);
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

template <int G, int WN>
cudaError_t launch_mma(const int8_t* a, const uint8_t* idx, int ib, const int8_t* cl,
                       const void* table, int32_t* out, int M, int K, int n_tiles, int kg,
                       int dp, int n_clus, int n_arr, int B_a, int E, cudaStream_t s) {
  constexpr int BM = 128 / WN;
  const int m_blocks = (M + BM - 1) / BM;
  const int n_pc = (dp + 64 * WN - 1) / (64 * WN);
  const Geometry g = geometry(E, n_tiles, n_pc, m_blocks, kg, MMA_KB >> G, M, K, dp, ib, n_clus,
                              n_arr, 1 << G, out, s);
  if (g.err != cudaSuccess) return g.err;
  const int8_t* tab = static_cast<const int8_t*>(table);
#define REPRO_LAUNCH(KERNEL, TILED)                                                      \
  KERNEL<G, WN, TILED><<<g.grid, MMA_THREADS, 0, s>>>(a, idx, ib, cl, tab, out, M, K, kg, \
                                                      g.kg_per, dp, n_pc, n_arr, B_a, g.es)
  // WN = 1 takes dp <= 64 only (dispatch), so it never tiles
  const bool tiled = WN > 1 && n_pc > 1;
  if (E > 1) {
    if (tiled)
      REPRO_LAUNCH(tlmac_fused_expert_mma_kernel, (WN > 1));
    else
      REPRO_LAUNCH(tlmac_fused_expert_mma_kernel, false);
  } else if (tiled) {
    REPRO_LAUNCH(tlmac_fused_mma_kernel, (WN > 1));
  } else {
    REPRO_LAUNCH(tlmac_fused_mma_kernel, false);
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

template <int G>
cudaError_t dispatch(const int8_t* a, const uint8_t* idx, int ib, const int8_t* cl,
                     const void* table, int tb, int32_t* out, int M, int K, int n_tiles,
                     int kg, int dp, int n_clus, int n_arr, int B_a, int E, cudaStream_t s) {
#define REPRO_ARGS a, idx, ib, cl, table, out, M, K, n_tiles, kg, dp, n_clus, n_arr, B_a, E, s
  if (tb == 2) return launch_dot<G, int16_t, 16>(REPRO_ARGS);
  if (M <= 4) return launch_dot<G, int8_t, 4>(REPRO_ARGS);
  if (M <= 8) return launch_dot<G, int8_t, 8>(REPRO_ARGS);
  if (M <= 16) return launch_dot<G, int8_t, 16>(REPRO_ARGS);
  if (dp <= 64) return launch_mma<G, 1>(REPRO_ARGS);
  return launch_mma<G, 2>(REPRO_ARGS);
#undef REPRO_ARGS
}

}  // namespace

// idx_bytes: 1 = uint8 exec_idx, 2 = int16; table_bytes: 1 = int8 rows,
// 2 = int16 rows.  E > 1 stacks E experts: a [E, M, K], exec_idx [E, n_tiles,
// kg, dp], step_cluster [E, n_tiles, kg], table [E, n_clus, n_arr, 2^G] and
// out [E, M, N], contiguous.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tlmac_fused_launch(const void* a, const void* exec_idx, int idx_bytes,
                                  const void* step_cluster, const void* table,
                                  int table_bytes, void* out, int M, int K, int n_tiles,
                                  int kg, int dp, int n_clus, int n_arr, int B_a, int G, int E,
                                  void* stream) {
  if (M < 1 || B_a < 1 || B_a > 8 || G < 1 || G > 6 || K != kg * G || kg < 1 || dp < 1 ||
      n_tiles < 1 || (long long)n_tiles * (dp + COLS - 1) > 2147483647LL ||
      (idx_bytes != 1 && idx_bytes != 2) || (table_bytes != 1 && table_bytes != 2) ||
      (M + 15) / 16 > 65535 || reinterpret_cast<uintptr_t>(table) % 16 != 0 || E < 1 ||
      E > 65535 || n_clus < 1)
    return (int)cudaErrorInvalidValue;
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const uint8_t* ix = static_cast<const uint8_t*>(exec_idx);
  const int8_t* cl = static_cast<const int8_t*>(step_cluster);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS a8, ix, idx_bytes, cl, table, table_bytes, o, M, K, n_tiles, kg, dp, n_clus, \
                   n_arr, B_a, E, s
  switch (G) {
    case 1: return (int)dispatch<1>(REPRO_ARGS);
    case 2: return (int)dispatch<2>(REPRO_ARGS);
    case 3: return (int)dispatch<3>(REPRO_ARGS);
    case 4: return (int)dispatch<4>(REPRO_ARGS);
    case 5: return (int)dispatch<5>(REPRO_ARGS);
    default: return (int)dispatch<6>(REPRO_ARGS);
  }
#undef REPRO_ARGS
}
