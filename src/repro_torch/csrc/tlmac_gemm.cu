// Table-lookup GEMM on pre-packed bit-plane codes (TLMAC PE) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/tlmac_gemm.py::tlmac_gemm
// (body _kernel, gather 'take' and 'onehot').  Computes, exactly in int32,
//
//   out[m, nt*dp + p] = sum_b 2^b sum_kg T[rowbase[nt, kg, p], codes[b, m, kg]]
//
// from codes [B_a, M, KG] int8 (the group codes of bitplanes.cu, < 2^G),
// rowbase [n_tiles, KG, dp] int32 (= step_cluster * N_arr + exec_idx) and
// the table T [R, 2^G] as narrow rows: int8, or int16 where an entry leaves
// int8 (kernels/tlmac_fused.py::narrow_table).  Every G of 1..6, B_a of
// 1..8, any dp, ragged KG and ragged M.
//
// The TPU kernel gathers t_cols = table[rowbase] once per grid step and
// contracts one_hot(code_b) @ t_cols on the MXU, once per plane.  Here a
// block owns 128 rows x 64 columns of one n-tile and:
//   - folds the planes into the A operand: coef[m, kg, e] = sum_b 2^b
//     [code_b(m, kg) == e] (0 <= coef <= 2^B_a - 1, one u8 per table
//     entry; the algebra of kernels 1 and 5-6).  Each thread builds its
//     own A fragments in registers from the code planes staged in shared
//     memory, so B_a leaves the product and no coef tile exists;
//   - keeps the B operand stationary: the table rows that rowbase selects
//     for the block's columns are gathered into shared memory as a dense
//     [64 columns][kg * 2^G] byte tile, once per block where the block's
//     whole kg range fits (resident: 32 KB at ResNet-18's stage 1, 128 KB
//     at stage 3), and the block then sweeps its row tiles through it;
//     otherwise chunk by chunk with the codes (streaming).  A random table
//     row costs an L1 wavefront, so the gather, not the bytes, is what a
//     row tile pays for B: resident B pays it once per block;
//   - multiplies on wgmma m64n64k32 (u8 coef from registers x s8 rows from
//     shared memory, s32 accumulate), one warpgroup per 64 rows, the
//     chunk's k32 steps issued back to back after its A fragments are
//     built (the block's other warpgroup and the SM's other block overlap
//     their builds with them).  The k order is permuted (see build_a) so
//     that a lane's codes for a chunk are one load per plane and row and
//     every gathered 8-byte piece of a row lands as 8 contiguous bytes of
//     B in wgmma's K-major no-swizzle layout;
//   - splits int16 rows at the gather into a u8 low-byte and an s8
//     high-byte plane: two products into two accumulators, combined as
//     lo + hi * 256 modulo 2^32 (exact wherever the int32 result is);
//   - stages the code planes (and, streaming, the gathered rows) through a
//     ring of up to four cp.async chunks of 256 coef bytes (128 for
//     G = 1-2), one barrier per chunk;
//   - fills the grid from M: kg is split (int32 atomics into a zeroed
//     output, exact and order-free) only when the 128 x 64 tiles cannot
//     give every SM a block (ResNet-18's stage 4, small TLMACLinear calls).
// Bound.  Bytes: the code planes (B_a*M*KG), rowbase, the narrow table and
// the int32 output, each once; the one-hot product, 2*M*2^G*KG*N
// operations, at the int8 tensor-core rate takes about half that time at
// ResNet-18's conv row plans, so the bytes bound it.  What holds the kernel
// above the bound is per chunk: the A build, the products and the code
// staging each take a similar share (tools/lookup_gemm_cuts.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int MAX_BA = 8;
constexpr int THREADS = 256;                 // two warpgroups
constexpr int BM = 128;                      // rows per tile (two warpgroups of 64)
constexpr int NP = 64;                       // columns per block
constexpr int BPS = 2;                       // blocks per SM the launch plans for

// coef bytes of a row per chunk: 256 (8 k32 steps) where 2^G >= 8, 128
// for G = 1-2, whose chunks hold 64-128 groups already
__host__ __device__ constexpr int kb_of(int G) { return G >= 3 ? 256 : 128; }

// bytes of one byte plane of a B chunk: 64 columns x KB k-bytes in
// wgmma's K-major no-swizzle layout [column / 8][k / 16][column % 8][16]
__host__ __device__ constexpr int b_chunk(int G) { return NP * kb_of(G); }

// dynamic shared memory of a launch: the B chunks (resident: every chunk
// of the block's kg range; streaming: a ring of `stages`; int16 rows two
// byte planes each) and a ring of `stages` code buffers
__host__ __device__ constexpr int smem_bytes(int G, int tb, int B_a, int groups, bool resident,
                                             int stages) {
  return (resident ? groups / (kb_of(G) >> G) : stages) * tb * b_chunk(G) +
         stages * B_a * BM * (kb_of(G) >> G);
}

// cp.async of `bytes` (0..PS) of src, the rest of the PS bytes zero-filled
template <int PS>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if constexpr (PS == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(PS), "r"(bytes)
                 : "memory");
}

// The code bytes of rows m0.. (BM of them) and groups k0 .. k0+kc_n of every
// plane into dst [B_a][BM][KC], zero past kc_n and below row M: PS-byte
// cp.async pieces, or (PS = 1) byte loads for unaligned rows.
template <int PS, int KC>
__device__ __forceinline__ void stage_codes(uint8_t* dst, const int8_t* codes, int M, int KG,
                                            int B_a, int m0, int k0, int kc_n, int tid) {
  const size_t plane = (size_t)M * KG;
  if constexpr (PS == 1) {
    for (int i = tid; i < B_a * BM * KC; i += THREADS) {
      const int kc = i % KC, r = i / KC;
      const int mm = r % BM, b = r / BM;
      const int m = m0 + mm;
      dst[i] = (m < M && kc < kc_n) ? (uint8_t)__ldg(codes + b * plane + (size_t)m * KG + k0 + kc)
                                    : (uint8_t)0;
    }
  } else {
    constexpr int NPC = KC / PS;
    for (int i = tid; i < B_a * BM * NPC; i += THREADS) {
      const int pc = i % NPC, r = i / NPC;
      const int mm = r % BM, b = r / BM;
      const int m = m0 + mm;
      const int n = m < M ? min(PS, max(0, kc_n - pc * PS)) : 0;
      const int8_t* src = n ? codes + b * plane + (size_t)m * KG + k0 + pc * PS : codes;
      cp_async<PS>(dst + (size_t)r * KC + pc * PS, src, n);
    }
  }
}

// x << n with PTX's clamp: 0 for n >= 32
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps a register live and unmoved up to this point (the asynchronous
// product reads the A fragments and writes the accumulators)
template <typename R>
__device__ __forceinline__ void keep(R& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma m64n64k32, A (u8 coef) from registers, B (s8 or u8) from shared
// memory, s32 accumulators added to
__device__ __forceinline__ void wgmma_u8s8(int (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_u8u8(int (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// The k order of a chunk.  Its KB coef bytes per row (natural order:
// group-major, entries within a group) are cut into 8-byte pieces; piece
// P = pr * 2NK + h * NK + kk goes to k32 step kk, 16-byte k block h of the
// step (the A words a0/a1 for h = 0, a2/a3 for h = 1), bytes 8 pr .. +7 of
// the block: lanes with tig = 2 pr and 2 pr + 1 hold its two halves.  So a
// lane's pieces for one h are NK consecutive ones (its codes are one load
// per plane and row), and each piece lands as 8 contiguous bytes of B.

// A lane's A fragments of k32 steps K0 .. K1 - 1 of one chunk, a[kk][2h + r]
// (rows row0, row0 + 8):
// coef bytes sum_b 2^b [code_b == e] for the four entries e of its half of
// each piece.  sc: the chunk's staged codes of row row0, planes pstride
// apart, row0 + 8 at 8 * KC; groups from kc_n on give 0.
template <int G, int NK, int K0, int K1>
__device__ __forceinline__ void build_a(uint32_t (&a)[NK][4], const uint8_t* sc, int pstride,
                                        int B_a, int tig, int kc_n) {
  constexpr int KC = kb_of(G) >> G;
  constexpr int L = NK * 8 >> G;            // code bytes of a lane's NK pieces (G >= 3: groups)
  const int half = tig & 1, pr = tig >> 1;
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = 0u;
#pragma unroll 1
  for (int b = 0; b < B_a; ++b) {
    const uint32_t one = 1u << b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p0 = pr * 2 * NK + h * NK;   // the lane's first piece for this h
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint8_t* src = sc + b * pstride + r * 8 * KC;
        if constexpr (G >= 3) {
          // NK pieces = NK >> (G - 3) groups, from group p0 >> (G - 3)
          constexpr int NG = NK >> (G - 3);
          const int g0 = p0 >> (G - 3);
          uint64_t w;
          if constexpr (NG == 8) w = *reinterpret_cast<const uint64_t*>(src + g0);
          else if constexpr (NG == 4) w = *reinterpret_cast<const uint32_t*>(src + g0);
          else if constexpr (NG == 2) w = *reinterpret_cast<const uint16_t*>(src + g0);
          else w = src[g0];
#pragma unroll
          for (int kk = K0; kk < K1; ++kk) {
            const int gi = kk >> (G - 3);
            if (g0 + gi >= kc_n) continue;
            const uint32_t c = (uint32_t)(w >> (8 * gi)) & 0xFFu;
            const uint32_t e0 = (uint32_t)((kk & ((1 << (G - 3)) - 1)) * 8 + half * 4);
            // entries outside the word wrap to shifts >= 32, which give 0
            a[kk][2 * h + r] += shl_clamp(one, 8u * (c - e0));
          }
        } else if constexpr (G == 2) {
          // piece p = groups 2p, 2p + 1; the lane's half is group 2p + half
          const uint64_t w = *reinterpret_cast<const uint64_t*>(src + 2 * p0);
#pragma unroll
          for (int kk = K0; kk < K1; ++kk) {
            const int g = 2 * kk + half;
            if (2 * p0 + g >= kc_n) continue;
            const uint32_t c = (uint32_t)(w >> (8 * g)) & 3u;
            a[kk][2 * h + r] += one << (8 * c);
          }
        } else {
          // piece p = groups 4p .. 4p + 3; the lane's half is groups
          // 4p + 2 half and 4p + 2 half + 1, two entries each
          const uint4 w = *reinterpret_cast<const uint4*>(src + 4 * p0);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int kk = K0; kk < K1; ++kk)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int g = 4 * kk + 2 * half + q;
              if (4 * p0 + g >= kc_n) continue;
              const uint32_t c = (ws[g >> 2] >> (8 * (g & 3))) & 1u;
              a[kk][2 * h + r] += one << (16 * q + 8 * c);
            }
        }
      }
    }
  }
  (void)L;
}

// Issues the products of k32 steps K0 .. K1 - 1 of a chunk as one wgmma
// commit group: B of step kk starts kk * 256 bytes into the chunk at
// b_addr; int16 rows multiply their low-byte plane (u8) into acc and
// their high-byte plane (s8, bch bytes on) into acc_hi.
template <int K0, int K1, int TB, int NK>
__device__ __forceinline__ void products(int (&acc)[32], int (&acc_hi)[32],
                                         const uint32_t (&a)[NK][4], uint64_t desc0,
                                         uint32_t b_addr, int bch) {
  wgmma_fence();
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    const uint64_t desc = desc0 | ((b_addr + kk * 256) >> 4);
    if constexpr (TB == 1) {
      wgmma_u8s8(acc, a[kk], desc);
    } else {
      wgmma_u8u8(acc, a[kk], desc);
      wgmma_u8s8(acc_hi, a[kk], desc + (bch >> 4));
    }
  }
  wgmma_commit();
}

// Gathers the table rows of groups k0 .. k0+kc_n for the block's columns
// into one B chunk at dst, in the k order above: piece P of column n is
// the 8 bytes of its row(s) at dst + (n / 8) * SBO + (2 kk + h) * 128 +
// (n % 8) * 16 + 8 pr.  int16 rows go split: low bytes into the plane at
// dst, high bytes into the plane b_chunk bytes on.  The rowbase loads of a
// thread's tasks are issued before any copy.
template <int G, typename T>
__device__ __forceinline__ void gather_chunk(uint8_t* dst, const T* __restrict__ table,
                                             const int32_t* __restrict__ rb_cols, int dp,
                                             int np, int k0, int kc_n, int tid) {
  constexpr int C = 1 << G, KB = kb_of(G), NK = KB / 32, SBO = KB * 8;
  constexpr int TPT = NP * KB / 8 / THREADS;     // (column, piece) tasks per thread
  constexpr int RPP = G >= 3 ? 1 : (G == 2 ? 2 : 4);   // table rows per piece
  constexpr int BCH = b_chunk(G);
  int r[TPT][RPP];
  // task i: pr = i & 1 and n % 8 = (i >> 1) & 7 fastest, so that 16 lanes
  // fill 128 contiguous bytes; then kk, h, n / 8
#pragma unroll
  for (int t = 0; t < TPT; ++t) {
    const int i = tid + t * THREADS;
    const int pr = i & 1, nl = (i >> 1) & 7, kk = (i >> 4) % NK, h = (i >> 4) / NK & 1;
    const int n = (i >> 4) / (2 * NK) * 8 + nl, P = pr * 2 * NK + h * NK + kk;
#pragma unroll
    for (int q = 0; q < RPP; ++q) {
      const int g = G >= 3 ? (P >> (G - 3)) : P * RPP + q;
      r[t][q] = (n < np && g < kc_n) ? __ldg(rb_cols + (size_t)(k0 + g) * dp + n) : -1;
    }
  }
#pragma unroll
  for (int t = 0; t < TPT; ++t) {
    const int i = tid + t * THREADS;
    const int pr = i & 1, nl = (i >> 1) & 7, kk = (i >> 4) % NK, h = (i >> 4) / NK & 1;
    const int n8 = (i >> 4) / (2 * NK), P = pr * 2 * NK + h * NK + kk;
    uint8_t* d = dst + n8 * SBO + (2 * kk + h) * 128 + nl * 16 + pr * 8;
    if constexpr (sizeof(T) == 1) {
      const uint8_t* tb = reinterpret_cast<const uint8_t*>(table);
      if constexpr (G >= 3) {
        if (r[t][0] >= 0)
          cp_async<8>(d, tb + (size_t)r[t][0] * C + (P & ((1 << (G - 3)) - 1)) * 8, 8);
      } else if constexpr (G == 2) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (r[t][q] >= 0) cp_async<4>(d + 4 * q, tb + (size_t)r[t][q] * 4, 4);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = r[t][q] >= 0
                     ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(tb) + r[t][q])
                     : 0u;
        *reinterpret_cast<uint2*>(d) = make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
      }
    } else {
      if constexpr (G >= 3) {
        if (r[t][0] >= 0) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              table + (size_t)r[t][0] * C + (P & ((1 << (G - 3)) - 1)) * 8));
          *reinterpret_cast<uint2*>(d) =
              make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
          *reinterpret_cast<uint2*>(d + BCH) =
              make_uint2(__byte_perm(v.x, v.y, 0x7531), __byte_perm(v.z, v.w, 0x7531));
        }
      } else if constexpr (G == 2) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (r[t][q] >= 0) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(table + (size_t)r[t][q] * 4));
            *reinterpret_cast<uint32_t*>(d + 4 * q) = __byte_perm(v.x, v.y, 0x6420);
            *reinterpret_cast<uint32_t*>(d + BCH + 4 * q) = __byte_perm(v.x, v.y, 0x7531);
          }
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = r[t][q] >= 0
                     ? __ldg(reinterpret_cast<const unsigned int*>(table) + r[t][q])
                     : 0u;
        *reinterpret_cast<uint2*>(d) =
            make_uint2(__byte_perm(v[0], v[1], 0x6420), __byte_perm(v[2], v[3], 0x6420));
        *reinterpret_cast<uint2*>(d + BCH) =
            make_uint2(__byte_perm(v[0], v[1], 0x7531), __byte_perm(v[2], v[3], 0x7531));
      }
    }
  }
}

// A block: 128-row tiles x 64 columns, each warpgroup 64 rows (m64n64).
// PS: the code-staging piece (cp.async bytes; 1 = byte loads).  RES: the
// block's whole kg range of B is gathered once and every row tile streams
// through it; else each chunk's rows are gathered with its codes.
// stages: depth of the cp.async ring (2-4 chunks in flight).  atomic: kg
// is split over gridDim.z and the slices add into a zeroed out.
template <int G, typename T, int PS, bool RES>
__global__ void __launch_bounds__(THREADS, BPS) tlmac_gemm_kernel(
    const int8_t* __restrict__ codes,     // [B_a, M, KG]
    const int32_t* __restrict__ rowbase,  // [n_tiles, KG, dp]
    const T* __restrict__ table,          // [R, 2^G] narrow rows
    int32_t* __restrict__ out,            // [M, n_tiles * dp]
    int M, int KG, int dp, int n_pb, int B_a, int kg_per, int stages, int atomic) {
  constexpr int KB = kb_of(G), KC = KB >> G, NK = KB / 32;
  constexpr int NACC = NP / 2;               // accumulators per thread (m64n64)
  constexpr int TB = (int)sizeof(T);
  constexpr int BCH = b_chunk(G);
  constexpr int SBO = KB * 8;                // between 8-column groups of a B chunk
  extern __shared__ __align__(128) uint8_t s_dyn[];

  const int nt = blockIdx.x / n_pb;
  const int p0 = (blockIdx.x - nt * n_pb) * NP;
  const int np = min(NP, dp - p0);
  const size_t N = (size_t)(gridDim.x / n_pb) * dp;
  const int kb = blockIdx.z * kg_per;
  const int ke = min(KG, kb + kg_per);
  const int n_ch = (ke - kb + KC - 1) / KC;
  const int m_tiles = (M + BM - 1) / BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16 + grp;          // the thread's rows row0, row0 + 8

  uint8_t* s_b = s_dyn;                                      // B chunks [.][TB][BCH]
  uint8_t* s_c = s_b + (RES ? n_ch : stages) * TB * BCH;     // [stages][B_a][BM][KC] codes
  const int c_buf = B_a * BM * KC;
  const int32_t* rb_cols = rowbase + (size_t)nt * KG * dp + p0;

  if constexpr (RES)
    for (int c = 0; c < n_ch; ++c)
      gather_chunk<G, T>(s_b + c * TB * BCH, table, rb_cols, dp, np, kb + c * KC,
                         min(KC, ke - kb - c * KC), tid);

  // work items of this block: its row tiles blockIdx.y + t * gridDim.y,
  // n_ch chunks each
  const int n_items = (m_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y * n_ch;
  auto item = [&](int it, int& m0, int& k0, int& kc_n) {
    const int t = it / n_ch, ch = it - t * n_ch;
    m0 = ((int)blockIdx.y + t * (int)gridDim.y) * BM;
    k0 = kb + ch * KC;
    kc_n = min(KC, ke - k0);
    return ch;
  };
  auto issue = [&](int it) {
    int m0, k0, kc_n;
    item(it, m0, k0, kc_n);
    stage_codes<PS, KC>(s_c + (it % stages) * c_buf, codes, M, KG, B_a, m0, k0, kc_n, tid);
    if constexpr (!RES)
      gather_chunk<G, T>(s_b + (it % stages) * TB * BCH, table, rb_cols, dp, np, k0, kc_n, tid);
  };

  int acc[NACC], acc_hi[NACC];   // int16 rows: the high bytes' product in acc_hi
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = acc_hi[j] = 0;
  // B descriptors: start address / 16 in bits 0-13, LBO (between the two
  // 16-byte k blocks of a k32 step) 128 bytes in bits 16-29, SBO in bits
  // 32-45, no swizzle
  const uint32_t sb_addr = smem_addr(s_b);
  const uint64_t desc0 = ((uint64_t)(SBO >> 4) << 32) | ((uint64_t)(128 >> 4) << 16);

  // the first stages - 1 items; one commit group per item, empty past the
  // last, so that group it always holds item it
  for (int it = 0; it < stages - 1; ++it) {
    if (it < n_items) issue(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_items; ++it) {
    if (stages == 4) cp_async_wait<2>();
    else if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    // item it's copies are visible to the tensor cores too; every
    // warpgroup is done with item it - 1, so its buffers (those of item
    // it + stages - 1) may be refilled
    fence_proxy_async();
    __syncthreads();
    const int nx = it + stages - 1;
    if (nx < n_items) issue(nx);
    cp_async_commit();
    int m0, k0, kc_n;
    const int ch = item(it, m0, k0, kc_n);
    const uint8_t* sc = s_c + (it % stages) * c_buf;
    const uint32_t b_addr = sb_addr + (RES ? ch : it % stages) * TB * BCH;
    // the chunk's A fragments, then its NK products issued back to back;
    // the other warpgroups' builds overlap them
    uint32_t a[NK][4];
    // the second half's A fragments are built while the first half's
    // products run
    build_a<G, NK, 0, NK / 2>(a, sc + row0 * KC, BM * KC, B_a, tig, kc_n);
    products<0, NK / 2, TB>(acc, acc_hi, a, desc0, b_addr, BCH);
    build_a<G, NK, NK / 2, NK>(a, sc + row0 * KC, BM * KC, B_a, tig, kc_n);
    products<NK / 2, NK, TB>(acc, acc_hi, a, desc0, b_addr, BCH);
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) keep(a[kk][j]);
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      keep(acc[j]);
      if constexpr (TB == 2) keep(acc_hi[j]);
    }
    if (ch != n_ch - 1) continue;
    // the row tile is complete: each thread holds two adjacent columns per
    // row, one 8-byte store where dp is even (four lanes fill a sector)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + h * 8;
        const int pp = j * 8 + tig * 2;
        if (m >= M || pp >= np) continue;
        int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (TB == 2) {
          v0 = (int)((uint32_t)v0 + ((uint32_t)acc_hi[4 * j + 2 * h] << 8));
          v1 = (int)((uint32_t)v1 + ((uint32_t)acc_hi[4 * j + 2 * h + 1] << 8));
        }
        int32_t* o = out + (size_t)m * N + (size_t)nt * dp + p0 + pp;
        if (atomic) {
          atomicAdd(o, v0);
          if (pp + 1 < np) atomicAdd(o + 1, v1);
        } else if (dp % 2 == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (pp + 1 < np) o[1] = v1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = acc_hi[j] = 0;
  }
}

struct Args {
  const void *codes, *rowbase, *table;
  void* out;
  int M, KG, n_tiles, dp, B_a;
  cudaStream_t stream;
};

struct Device {
  int n_sm = 0, optin = 0, per_sm = 0, reserved = 0;
};

// the card's SM count and shared-memory limits, queried once
const Device* device() {
  static Device d;
  if (d.n_sm == 0) {
    int dev = 0;
    Device q;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&q.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&q.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&q.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&q.n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return nullptr;
    d = q;
  }
  return &d;
}

template <int G, typename T, int PS, bool RES>
int launch_k(const Args& a, dim3 grid, int smem, int n_pb, int kg_per, int stages, int atomic) {
  static bool raised = false;
  if (!raised) {
    const Device* d = device();
    if (d == nullptr ||
        cudaFuncSetAttribute(tlmac_gemm_kernel<G, T, PS, RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, d->optin) !=
            cudaSuccess)
      return (int)cudaGetLastError();
    raised = true;
  }
  tlmac_gemm_kernel<G, T, PS, RES><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const int8_t*>(a.codes), static_cast<const int32_t*>(a.rowbase),
      static_cast<const T*>(a.table), static_cast<int32_t*>(a.out), a.M, a.KG, a.dp, n_pb, a.B_a,
      kg_per, stages, atomic);
  return (int)cudaGetLastError();
}

// the code-staging piece: min(16, KC) bytes by cp.async where every row's
// chunk is that aligned, else byte loads
template <int G>
constexpr int piece() {
  return (kb_of(G) >> G) < 16 ? (kb_of(G) >> G) : 16;
}

template <int G, typename T>
int launch_gt(const Args& a, bool vec, bool resident, dim3 grid, int smem, int n_pb, int kg_per,
              int stages, int atomic) {
  constexpr int PS = piece<G>();
  if (vec)
    return resident ? launch_k<G, T, PS, true>(a, grid, smem, n_pb, kg_per, stages, atomic)
                    : launch_k<G, T, PS, false>(a, grid, smem, n_pb, kg_per, stages, atomic);
  return resident ? launch_k<G, T, 1, true>(a, grid, smem, n_pb, kg_per, stages, atomic)
                  : launch_k<G, T, 1, false>(a, grid, smem, n_pb, kg_per, stages, atomic);
}

template <int G, typename T>
int launch_g(const Args& a) {
  constexpr int KC = kb_of(G) >> G;
  constexpr int TB = (int)sizeof(T);
  const Device* d = device();
  if (d == nullptr) return (int)cudaGetLastError();
  const int n_pb = (a.dp + NP - 1) / NP;
  const long long x = (long long)a.n_tiles * n_pb;
  const int chunks = (a.KG + KC - 1) / KC;
  const int m_tiles = (a.M + BM - 1) / BM;
  // split kg only where the tiles cannot give every SM a block
  int z = 1;
  if (x * m_tiles < d->n_sm)
    z = (int)(((long long)BPS * d->n_sm + x * m_tiles - 1) / (x * m_tiles));
  z = z < 1 ? 1 : (z > chunks ? chunks : z);
  const int kg_per = (chunks + z - 1) / z * KC;
  z = (a.KG + kg_per - 1) / kg_per;
  if (x > 0x7fffffffLL || z > 65535) return (int)cudaErrorInvalidValue;
  // B resident where the block's kg range fits beside a ring of 3-4 code
  // chunks at BPS blocks per SM (where they fill the card), else at one:
  // a random table row costs an L1 wavefront, so gathering B once per
  // block beats gathering it per row tile even with half the blocks.  Each
  // block then sweeps the same number of row tiles (one wave).  Else
  // streamed, with the deepest ring that keeps BPS blocks per SM (2 stages
  // at the least).
  const int depths[] = {4, 3};
  int resident = 0, stages = 2, y = m_tiles;
  for (int bps = BPS; bps >= 1 && !resident; --bps) {
    const long long slots = (long long)bps * d->n_sm / (x * z);
    const int per = slots >= 1 ? (int)((m_tiles + slots - 1) / slots) : m_tiles;
    const int y1 = (m_tiles + per - 1) / per;
    // a wave that leaves many SMs one block of BPS runs slower than one
    // block on every SM
    if (bps > 1 && 10 * x * y1 * z < 9LL * bps * d->n_sm) continue;
    for (int s : depths)
      if (!resident &&
          smem_bytes(G, TB, a.B_a, kg_per, true, s) <= d->per_sm / bps - d->reserved) {
        resident = 1;
        stages = s;
        y = y1;
      }
  }
  if (!resident)
    for (int s : depths)
      if (stages == 2 &&
          smem_bytes(G, TB, a.B_a, KC, false, s) <= d->per_sm / BPS - d->reserved)
        stages = s;
  const int smem = smem_bytes(G, TB, a.B_a, resident ? kg_per : KC, resident, stages);
  if (smem > d->optin) return (int)cudaErrorInvalidValue;
  y = y > 65535 ? 65535 : y;
  const int atomic = z > 1;
  if (atomic) {
    const cudaError_t e = cudaMemsetAsync(
        a.out, 0, (size_t)a.M * a.n_tiles * a.dp * sizeof(int32_t), a.stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int ps = piece<G>();
  const bool vec = a.KG % ps == 0 && reinterpret_cast<uintptr_t>(a.codes) % ps == 0;
  const dim3 grid((unsigned)x, y, z);
  return launch_gt<G, T>(a, vec, resident, grid, smem, n_pb, kg_per, stages, atomic);
}

template <typename T>
int launch_t(const Args& a, int G) {
  switch (G) {
    case 1: return launch_g<1, T>(a);
    case 2: return launch_g<2, T>(a);
    case 3: return launch_g<3, T>(a);
    case 4: return launch_g<4, T>(a);
    case 5: return launch_g<5, T>(a);
    default: return launch_g<6, T>(a);
  }
}

}  // namespace

// table_bytes: 1 = int8 rows, 2 = int16 rows.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int tlmac_gemm_launch(const void* codes, const void* rowbase, const void* table,
                                 int table_bytes, void* out, int M, int KG, int n_tiles, int dp,
                                 int G, int B_a, void* stream) {
  if (M < 1 || KG < 1 || n_tiles < 1 || dp < 1 || B_a < 1 || B_a > MAX_BA || G < 1 || G > 6 ||
      (table_bytes != 1 && table_bytes != 2) || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{codes, rowbase, table, out, M, KG, n_tiles, dp, B_a,
               static_cast<cudaStream_t>(stream)};
  return table_bytes == 1 ? launch_t<int8_t>(a, G) : launch_t<int16_t>(a, G);
}
