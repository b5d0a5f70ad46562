// Cluster-scheduled table-lookup GEMM (the paper's PE control structure)
// for Hopper: one kernel for both TPU kernels of
// src/repro/kernels/tlmac_clustered.py,
//   tlmac_gemm_clustered        (body _kernel, one output tile)   -> n_tiles = 1
//   tlmac_gemm_clustered_multi  (body _kernel_multi, every tile)  -> n_tiles >= 1
// Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_c sum_i sum_e T_c[idx[nt, c, i, p], e] * coef[m, (nt, c, i), e]
//   coef[m, s, e]     = sum_b 2^b [codes_sorted[b, m, s] == e]     (0 <= coef <= 2^B_a - 1)
//
// from codes_sorted [B_a, M, n_tiles*n_clus*ms] int8 (group codes gathered
// into cluster order), idx_sorted [n_tiles, n_clus, ms, dp] int32 (LUT-array
// id within the cluster; N_arr on padding steps, the zero row) and
// table_pad [n_clus, N_arr+1, 2^G] as narrow rows: int8, or int16 where an
// entry leaves int8 (kernels/tlmac_fused.py::narrow_table).
//
// The TPU kernel runs two MXU products per grid step: the switch,
// one_hot(idx) @ slice, builds the gathered rows from the resident cluster
// slice, and the PE, sel_b @ rows, sums the B_a planes with weight 2^b.
// Here the same algebra runs on one SM:
//   - select signal: a block of 8 warps owns (output tile nt, 64 rows, up
//     to 192 columns) and walks the chunks of its tile's (cluster) runs in
//     order; the slice of the running cluster sits in dynamic shared
//     memory, and the next run's slice arrives by cp.async into the other
//     buffer (an int8 slice at ResNet-18's conv plans is 1.5-4 KB).  Two
//     blocks share an SM, so one block's barriers and stores overlap the
//     other's products;
//   - a slice too large for two buffers (G = 6 at N_arr 4096 is 262 KB
//     even as int8) runs the same kernel with PARTIAL set: each buffer
//     holds the slice's first `fit` bytes (as many as two buffers leave
//     room for), and a B word at a row past them is read from device
//     memory instead (through L1/L2; one branch per B word, warp-divergent
//     only where a warp's rows straddle the boundary);
//   - PE: per chunk of 64 coef bytes (two k32 slices: 8 steps at G = 3,
//     32 at G = 1)
//     the block builds its coef tile once in shared memory from the B_a
//     code planes (they fold into one u8 per table entry), and the product
//     is int8 mma.sync m16n8k32 (u8 coef x s8 rows, s32 accumulate);
//   - switches: each B fragment is read straight from the resident slice
//     through the staged idx_sorted rows (row id * 2^G + entry offset); no
//     gathered [steps*2^G, dp] copy exists anywhere;
//   - the mma k order is permuted so that a thread's two B words are eight
//     consecutive bytes of one table row (one 8-byte shared load for
//     G >= 3), and its A words eight consecutive coef bytes: k = 4t + j is
//     coef/table byte 8t + j, k = 16 + 4t + j is byte 8t + 4 + j (at G = 2
//     and G = 1 the eight bytes span two and four rows);
//   - int16 rows split exactly into a low u8 and a high s8 byte: two mma
//     per fragment (u8 x u8 and u8 x s8), summed as hi * 256 + lo (exact
//     mod 2^32, so exact wherever the int32 result is);
//   - padding is skipped before it is staged: a pre-pass launch
//     (tlmac_clustered_live_kernel) finds, per (tile, cluster) run and
//     64-column group, the run's last step that selects a real row (the
//     schedule pads every run to ms with zero-row steps); a block walks only
//     the chunks up to its columns' last real step, and a chunk's product
//     ends at the next k32 edge (steps past the end have zero coef);
//   - a run holds only 8-16 live steps at the conv plans, so staging, not
//     the mma, sets the pace.  The chunks are pipelined: while chunk j is
//     built and multiplied, chunk j+1's idx rows, code bytes (where 4-byte
//     aligned) and, at a run's first chunk, its slice are in flight by
//     cp.async; two barriers per chunk; G is a template parameter, so the
//     index arithmetic of staging is shifts and masks;
//   - every cluster of a tile is walked by the same block, so there are no
//     atomics: each warp stores its accumulators once, in full 32-byte
//     sectors (8-byte stores where dp is even).
// Bound.  Bytes: the code bytes of the live steps (those up to each run's
// last real step; the padding after it is never read), idx_sorted, the
// table and the int32 output, each once; operations: the one-hot product,
// 2 * M * 2^G * (live steps) * dp, at the int8 tensor-core rate.  The bytes
// bound it at conv shapes.
// Capacity.  Two slices of (N_arr+1)*2^G narrow entries share a block's
// shared memory with 6 KB of coef tile, the double-buffered idx rows and
// code bytes of a chunk (G- and B_a-dependent: 1.6-51 KB and 0-32 KB) and
// one int per cluster (the live steps); tlmac_clustered_max_slice_bytes(B_a,
// G) gives the largest slice held whole (by G and B_a).  A larger slice is
// held in part (PARTIAL above); any number of clusters and G in 1..6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int MAX_BA = 8;
constexpr int WARPS_M = 1;              // warps along the rows
constexpr int WARPS_N = 8;              // warps along the columns
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MI = 4;                   // m16 tiles per warp
constexpr int BM = WARPS_M * MI * 16;   // 64 rows per block
constexpr int KB = 64;                  // coef bytes of a row per chunk (2 k32)
constexpr int A_LD = KB + 32;           // row stride: conflict-free 8-byte A loads
constexpr int NP_MAX = 192;             // columns per block at WN = 3
constexpr int IDX_LD = NP_MAX + 8;      // idx row stride (ints): four steps on distinct banks
constexpr int PGROUP = 64;              // columns per live-length group (the narrowest block)

// cp.async of `bytes` (0..size) of src, the rest of the size zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The 2^G coef bytes of one (m, step), sum_b 2^b [code_b == e], from its
// B_a codes code(b), stored at dst (2^G / 4 words; two bytes at G = 1).
template <int G, typename Code>
__device__ __forceinline__ void build_coef(Code code, int B_a, uint8_t* dst) {
  constexpr int C = 1 << G, CW = C / 4;
  if constexpr (G <= 3) {
    // the 2^G bytes fit one 64-bit word: byte e gets 2^b from each plane
    // whose code is e
    uint64_t w = 0;
    for (int b = 0; b < B_a; ++b) w += (uint64_t)(1u << b) << (8 * (code(b) & (C - 1)));
    if constexpr (G == 1) {
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w;
    } else {
#pragma unroll
      for (int j = 0; j < CW; ++j) reinterpret_cast<uint32_t*>(dst)[j] = (uint32_t)(w >> (32 * j));
    }
  } else {
    uint32_t w[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) w[j] = 0;
    for (int b = 0; b < B_a; ++b) {
      const uint32_t c = code(b) & (C - 1);
      const uint32_t add = (1u << b) << (8 * (c & 3u));
#pragma unroll
      for (int j = 0; j < CW; ++j) w[j] += (c >> 2) == (uint32_t)j ? add : 0u;
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
  }
}

// zero coef bytes of one (m, step)
template <int G>
__device__ __forceinline__ void zero_coef(uint8_t* dst) {
  if constexpr (G == 1) {
    *reinterpret_cast<uint16_t*>(dst) = 0;
  } else {
#pragma unroll
    for (int w = 0; w < (1 << G) / 4; ++w) reinterpret_cast<uint32_t*>(dst)[w] = 0;
  }
}

// One load of V from the running slice at byte `off`: from the shared
// buffer `s`, or (PARTIAL, a row past the `fit` bytes the buffer holds)
// from the slice `g` in device memory.  Loads are naturally aligned and at
// most 16 bytes, and fit is a multiple of 16, so none straddles the edge.
template <bool PARTIAL, typename V>
__device__ __forceinline__ V ld_tab(const uint8_t* s, const uint8_t* g, int fit, int off) {
  if constexpr (PARTIAL) {
    if (off >= fit) return __ldg(reinterpret_cast<const V*>(g + off));
  }
  return *reinterpret_cast<const V*>(s + off);
}

// The B words of one thread for k32 slice position q (its eight bytes
// q .. q+7 in natural (step, entry) order) in column pp: eight consecutive
// entries of one row for G >= 3, the four entries of two rows for G = 2,
// the two entries of four rows for G = 1.  int8 rows give (b0, b1); int16
// rows give their low bytes (b0, b1, u8) and high bytes (h0, h1, s8).
struct BWords {
  uint32_t b0, b1, h0, h1;
};

template <int G, typename T, bool PARTIAL>
__device__ __forceinline__ BWords b_words(const uint8_t* tab, const uint8_t* gtab, int fit,
                                          const int* s_idx, int q, int pp) {
  BWords r;
  if constexpr (G >= 3) {
    const int off = (s_idx[(q >> G) * IDX_LD + pp] << G) + (q & ((1 << G) - 1));
    if constexpr (sizeof(T) == 1) {
      const uint2 v = ld_tab<PARTIAL, uint2>(tab, gtab, fit, off);
      r.b0 = v.x; r.b1 = v.y;
    } else {
      const uint4 v = ld_tab<PARTIAL, uint4>(tab, gtab, fit, 2 * off);
      r.b0 = __byte_perm(v.x, v.y, 0x6420); r.h0 = __byte_perm(v.x, v.y, 0x7531);
      r.b1 = __byte_perm(v.z, v.w, 0x6420); r.h1 = __byte_perm(v.z, v.w, 0x7531);
    }
  } else if constexpr (G == 2) {
    const int s = q >> 2;
    const int o0 = s_idx[s * IDX_LD + pp] << 2;
    const int o1 = s_idx[(s + 1) * IDX_LD + pp] << 2;
    if constexpr (sizeof(T) == 1) {
      r.b0 = ld_tab<PARTIAL, uint32_t>(tab, gtab, fit, o0);
      r.b1 = ld_tab<PARTIAL, uint32_t>(tab, gtab, fit, o1);
    } else {
      const uint2 v = ld_tab<PARTIAL, uint2>(tab, gtab, fit, 2 * o0);
      const uint2 u = ld_tab<PARTIAL, uint2>(tab, gtab, fit, 2 * o1);
      r.b0 = __byte_perm(v.x, v.y, 0x6420); r.h0 = __byte_perm(v.x, v.y, 0x7531);
      r.b1 = __byte_perm(u.x, u.y, 0x6420); r.h1 = __byte_perm(u.x, u.y, 0x7531);
    }
  } else {
    const int s = q >> 1;   // four rows of two entries
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = s_idx[(s + j) * IDX_LD + pp] << 1;
    if constexpr (sizeof(T) == 1) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ld_tab<PARTIAL, unsigned short>(tab, gtab, fit, o[j]);
      r.b0 = w[0] | (w[1] << 16);
      r.b1 = w[2] | (w[3] << 16);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ld_tab<PARTIAL, uint32_t>(tab, gtab, fit, 2 * o[j]);
      r.b0 = __byte_perm(v[0], v[1], 0x6420); r.h0 = __byte_perm(v[0], v[1], 0x7531);
      r.b1 = __byte_perm(v[2], v[3], 0x6420); r.h1 = __byte_perm(v[2], v[3], 0x7531);
    }
  }
  return r;
}

// Shared-memory plan of one launch (bytes): two slice buffers of `held`
// bytes each (the whole slice, or its first `fit` bytes), two idx chunks
// [steps][IDX_LD] int32, two code chunks [B_a][BM][steps] (only where the
// code bytes are copied by cp.async), and the live steps of every run.
struct Smem {
  int slice, idx, codes, live;
  __host__ __device__ Smem(int held, int G, int B_a, bool copy_codes, int n_clus) {
    slice = (held + 15) & ~15;
    idx = (KB >> G) * IDX_LD * 4;
    codes = copy_codes ? (B_a * BM * (KB >> G) + 15) & ~15 : 0;
    live = (n_clus * 4 + 15) & ~15;
  }
  __host__ __device__ int total() const { return 2 * (slice + idx + codes) + live; }
};

// Pre-pass: live[(nt * n_clus + c) * n_groups + g] = 1 + the last step of
// run (nt, c) that selects a real row (not the zero row n_arr1 - 1) in
// column group g (PGROUP columns), 0 if none.  One block per run and group.
__global__ void __launch_bounds__(256) tlmac_clustered_live_kernel(
    const int32_t* __restrict__ idx, int32_t* __restrict__ live, int ms, int dp, int n_arr1) {
  __shared__ int s_last;
  const int g = blockIdx.y;
  const int p0 = g * PGROUP, np = min(PGROUP, dp - p0);
  const int32_t* run = idx + (size_t)blockIdx.x * ms * dp + p0;
  if (threadIdx.x == 0) s_last = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < ms * PGROUP; i += blockDim.x) {
    const int step = i / PGROUP, pp = i - step * PGROUP;
    if (pp < np && __ldg(run + (size_t)step * dp + pp) != n_arr1 - 1) last = step + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0 && last) atomicMax(&s_last, last);
  __syncthreads();
  if (threadIdx.x == 0) live[(size_t)blockIdx.x * gridDim.y + g] = s_last;
}

// Phase timers, compiled in only with -DTLMAC_CLUSTERED_PHASES (by
// tools/clustered_phases.py): thread 0 of each block adds the clock64
// cycles since the previous mark to phase k at PHASE_MARK(k), and at the
// end adds its six phases and a block count to g_phases.
#ifdef TLMAC_CLUSTERED_PHASES
__device__ unsigned long long g_phases[8];
#define PHASE_START                   \
  long long t_mark_ = clock64();      \
  unsigned long long phase_[6] = {};
#define PHASE_MARK(k)                                               \
  if (tid == 0) {                                                   \
    const long long t_ = clock64();                                 \
    phase_[k] += t_ - t_mark_;                                      \
    t_mark_ = t_;                                                   \
  }
#define PHASE_END                                                   \
  __syncthreads();                                                  \
  PHASE_MARK(5)                                                     \
  if (tid == 0) {                                                   \
    for (int k_ = 0; k_ < 6; ++k_) atomicAdd(&g_phases[k_], phase_[k_]); \
    atomicAdd(&g_phases[7], 1ull);                                  \
  }
#else
#define PHASE_START
#define PHASE_MARK(k)
#define PHASE_END
#endif

// WN n8 tiles per warp: a block covers 64 * WN columns of a tile.
// copy_codes: the code bytes of a chunk are 4-byte aligned (ms and the
// chunk's steps are multiples of 4) and are copied by cp.async; otherwise
// the coef build reads them from device memory.  fit: the bytes of a
// slice each buffer holds (the whole slice unless PARTIAL).
template <int G, int WN, typename T, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, 2) tlmac_clustered_kernel(
    const int8_t* __restrict__ codes,      // [B_a, M, n_tiles*n_clus*ms]
    const int32_t* __restrict__ idx,       // [n_tiles, n_clus, ms, dp]
    const T* __restrict__ table,           // [n_clus, n_arr1, 2^G]
    const int32_t* __restrict__ live,      // [n_tiles, n_clus, n_groups] (pre-pass)
    int32_t* __restrict__ out,             // [M, n_tiles*dp]
    int M, int n_clus, int ms, int dp, int n_chunks, int n_arr1, int B_a, int vec_idx,
    int copy_codes, int fit) {
  constexpr int C = 1 << G;
  constexpr int KS = KB >> G;                       // steps per chunk
  constexpr int NP = WARPS_N * 8 * WN;
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ __align__(16) uint8_t s_a[BM * A_LD];   // coef [m][step*2^G + e]

  const int m0 = blockIdx.x * BM;
  const int nt = blockIdx.y / n_chunks;
  const int p0 = (blockIdx.y - nt * n_chunks) * NP;
  const int np = min(NP, dp - p0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;
  const int n_tiles = gridDim.y / n_chunks;
  const size_t L = (size_t)n_tiles * n_clus * ms;   // code columns per row
  const size_t plane = (size_t)M * L;
  const Smem sm(fit, G, B_a, copy_codes, n_clus);
  const int slice_bytes = n_arr1 * C * (int)sizeof(T);
  uint8_t* s_tab = s_dyn;                                            // [2][sm.slice]
  int* s_idx0 = reinterpret_cast<int*>(s_dyn + 2 * sm.slice);        // [2][KS][IDX_LD]
  uint8_t* s_code0 = s_dyn + 2 * (sm.slice + sm.idx);                // [2][B_a][BM][KS]
  int* s_live = reinterpret_cast<int*>(s_dyn + 2 * (sm.slice + sm.idx + sm.codes));
                                                                     // [n_clus] live steps

  // live steps of each run in this block's columns: the most over its groups
  {
    const int n_groups = (dp + PGROUP - 1) / PGROUP;
    const int g0 = p0 / PGROUP, g1 = (p0 + np + PGROUP - 1) / PGROUP;
    for (int c = tid; c < n_clus; c += THREADS) {
      const int32_t* lv = live + ((size_t)nt * n_clus + c) * n_groups;
      int v = 0;
      for (int g = g0; g < g1; ++g) v = max(v, __ldg(lv + g));
      s_live[c] = v;
    }
  }

  // issue chunk (cl, i0)'s copies into buffer `buf` (and, with `slice`
  // >= 0, the run's slice into slice buffer `slice`)
  auto prefetch = [&](int cl, int i0, int buf, int slice) {
    const int kc_n = min(KS, s_live[cl] - i0);
    const size_t run = (size_t)nt * n_clus + cl;
    if (slice >= 0) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(table) + (size_t)cl * slice_bytes;
      uint8_t* dst = s_tab + slice * sm.slice;
      if (slice_bytes % 16 == 0) {
        for (int i = tid; i < fit / 16; i += THREADS) cp_async16(dst + 16 * i, src + 16 * i, 16);
      } else if (slice_bytes % 4 == 0) {
        for (int i = tid; i < fit / 4; i += THREADS) cp_async4(dst + 4 * i, src + 4 * i, 4);
      } else {
        // G = 1 int8 slices of an odd row count: 2-byte pieces, by plain
        // loads (visible after the barrier that precedes the slice's use)
        for (int i = tid; i < fit / 2; i += THREADS)
          reinterpret_cast<uint16_t*>(dst)[i] =
              __ldg(reinterpret_cast<const unsigned short*>(src) + i);
      }
    }
    // idx rows: steps past the live ones and columns past np are
    // zero-filled (row 0: zero coef, or outputs that are not stored)
    int* d_idx = s_idx0 + buf * (sm.idx / 4);
    const int32_t* idx_run = idx + (run * ms + i0) * dp + p0;
    if (vec_idx) {
      constexpr int NQ = NP / 4;
      for (int i = tid; i < KS * NQ; i += THREADS) {
        const int kc = i / NQ, pp = 4 * (i - kc * NQ);
        const bool ok = kc < kc_n && pp < np;
        cp_async16(d_idx + kc * IDX_LD + pp, ok ? idx_run + (size_t)kc * dp + pp : idx,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < KS * NP; i += THREADS) {
        const int kc = i / NP, pp = i - kc * NP;
        const bool ok = kc < kc_n && pp < np;
        cp_async4(d_idx + kc * IDX_LD + pp, ok ? idx_run + (size_t)kc * dp + pp : idx,
                  ok ? 4 : 0);
      }
    }
    if constexpr (KS % 4 == 0) {
      if (copy_codes) {
        // per (plane, row) the chunk's KS code bytes, four per copy; bytes
        // past the live steps or below the last row are zero-filled
        constexpr int W = KS / 4;
        uint8_t* d_code = s_code0 + buf * sm.codes;
        const int8_t* c_run = codes + run * ms + i0;
        for (int i = tid; i < B_a * BM * W; i += THREADS) {
          const int w = i % W, r = i / W;
          const int mm = r % BM, b = r / BM;
          const int n = m0 + mm < M ? min(4, max(0, kc_n - 4 * w)) : 0;
          cp_async4(d_code + 4 * i, n ? c_run + b * plane + (size_t)(m0 + mm) * L + 4 * w : codes,
                    n);
        }
      }
    }
    cp_async_commit();
  };
  // the chunk after (cl, i0): the next one of the run, else the first of
  // the next run with a live step; cl == n_clus when there is none
  auto advance = [&](int& cl, int& i0) {
    i0 += KS;
    while (cl < n_clus && i0 >= s_live[cl]) {
      ++cl;
      i0 = 0;
    }
  };

  int acc[MI][WN][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nt8 = (np + 7) / 8;   // n8 tiles with a real column
  __syncthreads();                // s_live is set
  PHASE_START
  int cl = 0, i0 = -KS;
  advance(cl, i0);
  int buf = 0, sbuf = 0;          // idx/code buffer, slice buffer of the chunk
  if (cl < n_clus) prefetch(cl, i0, 0, 0);
  while (cl < n_clus) {
    const int kc_n = min(KS, s_live[cl] - i0);
    cp_async_wait<0>();
    // the chunk's copies are visible; every warp is done with the previous
    // chunk's product, so its buffers (and s_a) may be refilled
    __syncthreads();
    PHASE_MARK(0)   // the previous chunk's product, this chunk's wait and barrier
    int ncl = cl, ni0 = i0;
    advance(ncl, ni0);
    if (ncl < n_clus) prefetch(ncl, ni0, buf ^ 1, ni0 == 0 ? sbuf ^ 1 : -1);
    PHASE_MARK(1)   // issuing the next chunk's copies
    const uint8_t* tab = s_tab + sbuf * sm.slice;
    const uint8_t* gtab = reinterpret_cast<const uint8_t*>(table) + (size_t)cl * slice_bytes;
    const int* s_idx = s_idx0 + buf * (sm.idx / 4);
    // the coef tile, one (row, step) per thread and round, steps fastest;
    // steps past the live ones are zero, rows past M are not stored
    const uint8_t* s_code = s_code0 + buf * sm.codes;
    const int8_t* c_run = codes + ((size_t)nt * n_clus + cl) * ms + i0;
    for (int i = tid; i < BM * KS; i += THREADS) {
      const int mm = i / KS, kc = i - mm * KS;
      uint8_t* dst = s_a + mm * A_LD + kc * C;
      if (kc >= kc_n || m0 + mm >= M) {
        zero_coef<G>(dst);
      } else if (KS % 4 == 0 && copy_codes) {
        build_coef<G>([&](int b) { return (uint32_t)s_code[(b * BM + mm) * KS + kc]; }, B_a, dst);
      } else {
        const int8_t* src = c_run + (size_t)(m0 + mm) * L + kc;
        build_coef<G>([&](int b) { return (uint32_t)(uint8_t)__ldg(src + b * plane); }, B_a, dst);
      }
    }
    PHASE_MARK(2)      // the coef build
    __syncthreads();   // the coef tile is ready
    PHASE_MARK(3)      // waiting at that barrier
    const int nk = (kc_n * C + 31) >> 5;   // k32 slices up to the last live step
    for (int kk = 0; kk < nk; ++kk) {
      const int q = kk * 32 + tig * 8;
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint8_t* ap = s_a + (wm * MI * 16 + i * 16 + grp) * A_LD + q;
        const uint2 lo = *reinterpret_cast<const uint2*>(ap);
        const uint2 hi = *reinterpret_cast<const uint2*>(ap + 8 * A_LD);
        af[i][0] = lo.x; af[i][1] = hi.x; af[i][2] = lo.y; af[i][3] = hi.y;
      }
#pragma unroll
      for (int jn = 0; jn < WN; ++jn) {
        const int n8 = wn * WN + jn;
        if (n8 >= nt8) continue;   // warp-uniform
        const BWords b = b_words<G, T, PARTIAL>(tab, gtab, fit, s_idx, q, n8 * 8 + grp);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if constexpr (sizeof(T) == 1) {
            mma_u8s8(acc[i][jn], af[i], b.b0, b.b1);
          } else {
            int hi[4] = {0, 0, 0, 0};
            mma_u8s8(hi, af[i], b.h0, b.h1);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][jn][e] = (int)((uint32_t)acc[i][jn][e] + ((uint32_t)hi[e] << 8));
            mma_u8u8(acc[i][jn], af[i], b.b0, b.b1);
          }
        }
      }
    }
    if (ncl != cl) sbuf ^= 1;
    buf ^= 1;
    cl = ncl;
    i0 = ni0;
  }

  PHASE_MARK(4)   // the last chunk's product
  // each thread holds two adjacent columns per row: one 8-byte store where
  // dp is even (so every row offset is), four lanes then fill a sector
  const size_t N = (size_t)n_tiles * dp;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int jn = 0; jn < WN; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MI * 16 + i * 16 + grp + h * 8;
        const int pp = (wn * WN + jn) * 8 + tig * 2;
        if (m >= M || pp >= np) continue;
        int32_t* o = out + (size_t)m * N + (size_t)nt * dp + p0 + pp;
        if (dp % 2 == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
        } else {
          o[0] = acc[i][jn][2 * h];
          if (pp + 1 < np) o[1] = acc[i][jn][2 * h + 1];
        }
      }
  PHASE_END       // phase 5: the epilogue
}

// Dynamic shared memory the instance may take beside its static staging
// (raised to that limit once); -1 if a device query fails.
template <int G, int WN, typename T, bool PARTIAL>
int max_dynamic_smem() {
  static int max_dyn = -1;
  if (max_dyn < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&fa, tlmac_clustered_kernel<G, WN, T, PARTIAL>) != cudaSuccess)
      return -1;
    const int limit = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(tlmac_clustered_kernel<G, WN, T, PARTIAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, limit) !=
        cudaSuccess)
      return -1;
    max_dyn = limit;
  }
  return max_dyn;
}

// the least dynamic shared memory over the instances of G (all have the
// same static staging); -1 if a device query fails
template <int G>
int max_dynamic_smem_g() {
  const int lim[] = {max_dynamic_smem<G, 1, int8_t, false>(),
                     max_dynamic_smem<G, 3, int8_t, false>(),
                     max_dynamic_smem<G, 1, int16_t, false>(),
                     max_dynamic_smem<G, 3, int16_t, false>()};
  int m = lim[0];
  for (int v : lim) m = v < m ? v : m;
  return m;
}

int max_dynamic_smem_of(int G) {
  switch (G) {
    case 1: return max_dynamic_smem_g<1>();
    case 2: return max_dynamic_smem_g<2>();
    case 3: return max_dynamic_smem_g<3>();
    case 4: return max_dynamic_smem_g<4>();
    case 5: return max_dynamic_smem_g<5>();
    default: return max_dynamic_smem_g<6>();
  }
}

struct Args {
  const void *codes, *idx, *table;
  void *live, *out;
  int M, n_tiles, n_clus, ms, dp, n_arr1, B_a;
  cudaStream_t stream;
};

template <int G, int WN, typename T, bool PARTIAL>
int launch_wn(const Args& a, bool copy_codes, int fit) {
  const Smem sm(fit, G, a.B_a, copy_codes, a.n_clus);
  const int n_chunks = (a.dp + 64 * WN - 1) / (64 * WN);
  const int n_groups = (a.dp + PGROUP - 1) / PGROUP;
  if ((size_t)a.n_tiles * n_chunks > 65535 || n_groups > 65535) return (int)cudaErrorInvalidValue;
  tlmac_clustered_live_kernel<<<dim3(a.n_tiles * a.n_clus, n_groups), 256, 0, a.stream>>>(
      static_cast<const int32_t*>(a.idx), static_cast<int32_t*>(a.live), a.ms, a.dp, a.n_arr1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.M + BM - 1) / BM, a.n_tiles * n_chunks);
  // whole 16-byte copies of idx rows need dp and the base 16-byte aligned
  const int vec_idx = a.dp % 4 == 0 && reinterpret_cast<uintptr_t>(a.idx) % 16 == 0;
  tlmac_clustered_kernel<G, WN, T, PARTIAL><<<grid, THREADS, sm.total(), a.stream>>>(
      static_cast<const int8_t*>(a.codes), static_cast<const int32_t*>(a.idx),
      static_cast<const T*>(a.table), static_cast<const int32_t*>(a.live),
      static_cast<int32_t*>(a.out), a.M, a.n_clus, a.ms, a.dp, n_chunks, a.n_arr1, a.B_a,
      vec_idx, copy_codes, fit);
  return (int)cudaGetLastError();
}

// The whole slice double-buffered where it fits; else PARTIAL, each buffer
// holding as much of the slice's head as the rest of shared memory leaves.
template <int G, int WN, typename T>
int launch_fit(const Args& a) {
  // code bytes by cp.async need every chunk's bytes 4-byte aligned
  const bool copy_codes = a.ms % 4 == 0 && (KB >> G) % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(a.codes) % 4 == 0;
  const int slice_bytes = a.n_arr1 * (1 << G) * (int)sizeof(T);
  const int max_dyn = max_dynamic_smem<G, WN, T, false>();
  if (max_dyn < 0) return (int)cudaGetLastError();
  if (Smem(slice_bytes, G, a.B_a, copy_codes, a.n_clus).total() <= max_dyn)
    return launch_wn<G, WN, T, false>(a, copy_codes, slice_bytes);
  const int max_part = max_dynamic_smem<G, WN, T, true>();
  if (max_part < 0) return (int)cudaGetLastError();
  const int fit = ((max_part - Smem(0, G, a.B_a, copy_codes, a.n_clus).total()) / 2) & ~15;
  if (fit < 16) return (int)cudaErrorInvalidValue;   // the clusters' live table alone fills it
  return launch_wn<G, WN, T, true>(a, copy_codes, fit);
}

template <int G, typename T>
int launch_gt(const Args& a) {
  return a.dp <= 64 ? launch_fit<G, 1, T>(a) : launch_fit<G, 3, T>(a);
}

template <typename T>
int launch_t(const Args& a, int G) {
  switch (G) {
    case 1: return launch_gt<1, T>(a);
    case 2: return launch_gt<2, T>(a);
    case 3: return launch_gt<3, T>(a);
    case 4: return launch_gt<4, T>(a);
    case 5: return launch_gt<5, T>(a);
    default: return launch_gt<6, T>(a);
  }
}

int launch(const Args& a, int G, int table_bytes) {
  if (a.M < 1 || a.n_tiles < 1 || a.n_clus < 1 || a.ms < 1 || a.dp < 1 ||
      a.n_arr1 < 1 || a.B_a < 1 || a.B_a > MAX_BA || G < 1 || G > 6 ||
      (table_bytes != 1 && table_bytes != 2) || reinterpret_cast<uintptr_t>(a.table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return table_bytes == 1 ? launch_t<int8_t>(a, G) : launch_t<int16_t>(a, G);
}

}  // namespace

// Largest table slice, in bytes, that the kernel holds whole (double-
// buffered) beside a chunk's staging at this B_a and G and one cluster
// (counting the code bytes' buffers whether or not a launch copies them);
// a larger slice runs PARTIAL.  -1 if a device query fails.
extern "C" int tlmac_clustered_max_slice_bytes(int B_a, int G) {
  if (B_a < 1 || B_a > MAX_BA || G < 1 || G > 6) return 0;
  const int max_dyn = max_dynamic_smem_of(G);
  if (max_dyn < 0) return -1;
  const Smem sm(0, G, B_a, true, 1);
  return ((max_dyn - sm.total()) / 2) & ~15;
}

// Scratch ints the launch needs for the pre-pass (live steps per run and
// 64-column group).
extern "C" int tlmac_clustered_scratch_ints(int n_tiles, int n_clus, int dp) {
  return n_tiles * n_clus * ((dp + PGROUP - 1) / PGROUP);
}

// Kernel 5: one output tile (codes_sorted [B_a, M, n_clus*ms],
// idx_sorted [n_clus, ms, dp]).  table_bytes: 1 = int8 rows, 2 = int16;
// scratch: tlmac_clustered_scratch_ints(1, n_clus, dp) int32.
extern "C" int tlmac_clustered_launch(const void* codes, const void* idx, const void* table,
                                      int table_bytes, void* scratch, void* out, int M,
                                      int n_clus, int ms, int dp, int n_arr1, int G, int B_a,
                                      void* stream) {
  return launch({codes, idx, table, scratch, out, M, 1, n_clus, ms, dp, n_arr1, B_a,
                 static_cast<cudaStream_t>(stream)},
                G, table_bytes);
}

// Kernel 6: every output tile of a layer in one launch.
extern "C" int tlmac_clustered_multi_launch(const void* codes, const void* idx,
                                            const void* table, int table_bytes, void* scratch,
                                            void* out, int M, int n_tiles, int n_clus, int ms,
                                            int dp, int n_arr1, int G, int B_a, void* stream) {
  return launch({codes, idx, table, scratch, out, M, n_tiles, n_clus, ms, dp, n_arr1, B_a,
                 static_cast<cudaStream_t>(stream)},
                G, table_bytes);
}

#ifdef TLMAC_CLUSTERED_PHASES
// The phase sums since the last read (cycles of phases 0-5, slot 7 the
// block count) into h[8], then zeroed.
extern "C" int tlmac_clustered_read_phases(unsigned long long* h) {
  cudaDeviceSynchronize();
  const int e = (int)cudaMemcpyFromSymbol(h, g_phases, sizeof(g_phases));
  const unsigned long long z[8] = {};
  cudaMemcpyToSymbol(g_phases, z, sizeof(z));
  return e;
}
#endif
