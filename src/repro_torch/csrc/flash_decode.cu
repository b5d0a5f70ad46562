// Split-K paged flash-decode (FlashDecoding over a paged KV pool) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode.py::flash_decode
// (body _kernel).  One query token per slot; the rep query heads that share a
// kv head are packed as the rows of one [rep, hd] operand.  For block
// (b, g, s) the kernel walks split s's logical blocks blk = s*bps + i of
// slot b while blk*P < lengths[b], reads the physical page bt[b, blk], and
// runs the online softmax; it writes the split's partial (acc, m, l).  An
// empty split writes (0, -1e30, 0).  The partials are combined outside the
// kernel, as in the JAX package.
//
// Pools: fp (bf16 pages), int8 (codes x bf16 scale) and int4 (two codes per
// byte, low nibble = even element, sign-extended by shifts), the scales
// [n_pages, P, KV] fetched through the same page id as their codes.  Keys are
// visible iff j < L and, with a window, j > L - 1 - window; masked
// probabilities are zeroed explicitly, so a fully masked page never poisons
// the running max.  Idle slots carry a block-table row of zeros and
// lengths = 1: they read the scratch page 0.
//
// Bound.  Each visited page is read once (bytes of the live K/V pages plus
// their scales, the query and the partials): decode attention does ~1 flop
// per byte and is bound by device-memory bytes.  Design against that bound:
// a block reads its own block-table row and walks only its valid pages (the
// TPU kernel's scalar prefetch and page-0 revisits are gone), each page's
// head-g rows are read once with neighbouring threads on neighbouring
// elements, dequantised into shared memory, and reused by all rep query
// heads; the (B, KV, n_splits) grid spreads a short batch over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ inline float load_elem_fp(const void* pages, size_t row, int hdc, int h) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(pages)[row * hdc + h]);
}

template <int KIND>  // 0: fp bf16, 1: int8, 2: int4 packed
__device__ inline float load_elem(const void* pages, const __nv_bfloat16* scales,
                                  size_t row, int hdc, int h) {
  if (KIND == 0) return load_elem_fp(pages, row, hdc, h);
  const int8_t* codes = static_cast<const int8_t*>(pages);
  int code;
  if (KIND == 1) {
    code = codes[row * hdc + h];
  } else {
    const int v = codes[row * hdc + (h >> 1)];
    code = (h & 1) ? ((int)((unsigned)v << 24) >> 28) : ((int)((unsigned)v << 28) >> 28);
  }
  return (float)code * __bfloat162float(scales[row]);
}

template <int KIND>
__global__ void flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, KV, rep, hd]
    const void* __restrict__ k_pages,      // [n_pages, P, KV, hdc]
    const void* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_scales,  // [n_pages, P, KV] (quantised)
    const __nv_bfloat16* __restrict__ v_scales,
    const int32_t* __restrict__ block_table,     // [B, MB]
    const int32_t* __restrict__ lengths,         // [B]
    float* __restrict__ o_part,                  // [B, KV, S, rep, hd]
    float* __restrict__ m_part,                  // [B, KV, S, rep]
    float* __restrict__ l_part,                  // [B, KV, S, rep]
    int KV, int rep, int hd, int hdc, int P, int MB, int bps, int window,
    float scale) {
  extern __shared__ float sm[];
  float* s_q = sm;                       // [rep, hd]
  float* s_k = s_q + rep * hd;           // [P, hd + 1] (padded: no bank conflicts)
  float* s_v = s_k + P * (hd + 1);       // [P, hd]
  float* s_p = s_v + P * hd;             // [rep, P] scores, then probabilities
  float* s_acc = s_p + rep * P;          // [rep, hd]
  float* s_m = s_acc + rep * hd;         // [rep]
  float* s_l = s_m + rep;                // [rep]
  float* s_corr = s_l + rep;             // [rep]

  const int b = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int L = lengths[b];

  const __nv_bfloat16* qb = q + ((size_t)b * KV + g) * rep * hd;
  for (int i = tid; i < rep * hd; i += THREADS) {
    s_q[i] = __bfloat162float(qb[i]);
    s_acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    s_m[r] = NEG_INF;
    s_l[r] = 0.f;
  }

  for (int i = 0; i < bps; ++i) {
    const int blk = s * bps + i;
    if (blk * P >= L) break;  // every later block of the split is invalid too
    const int pid = block_table[(size_t)b * MB + min(blk, MB - 1)];
    __syncthreads();  // previous page fully consumed
    for (int e = tid; e < P * hd; e += THREADS) {
      const int j = e / hd, h = e % hd;
      const size_t row = ((size_t)pid * P + j) * KV + g;
      s_k[j * (hd + 1) + h] = load_elem<KIND>(k_pages, k_scales, row, hdc, h);
      s_v[j * hd + h] = load_elem<KIND>(v_pages, v_scales, row, hdc, h);
    }
    __syncthreads();
    for (int e = tid; e < rep * P; e += THREADS) {
      const int r = e / P, j = e % P;
      float dot = 0.f;
      for (int h = 0; h < hd; ++h) dot += s_q[r * hd + h] * s_k[j * (hd + 1) + h];
      s_p[e] = dot * scale;
    }
    __syncthreads();
    for (int r = tid; r < rep; r += THREADS) {
      const float m_old = s_m[r];
      float row_max = NEG_INF;
      for (int j = 0; j < P; ++j) {
        const int jpos = blk * P + j;
        const bool msk = jpos < L && (window < 0 || jpos > L - 1 - window);
        if (msk) row_max = fmaxf(row_max, s_p[r * P + j]);
      }
      const float m_new = fmaxf(m_old, row_max);
      float sum = 0.f;
      for (int j = 0; j < P; ++j) {
        const int jpos = blk * P + j;
        const bool msk = jpos < L && (window < 0 || jpos > L - 1 - window);
        const float pr = msk ? expf(s_p[r * P + j] - m_new) : 0.f;
        s_p[r * P + j] = pr;
        sum += pr;
      }
      const float corr = expf(m_old - m_new);
      s_l[r] = s_l[r] * corr + sum;
      s_m[r] = m_new;
      s_corr[r] = corr;
    }
    __syncthreads();
    for (int e = tid; e < rep * hd; e += THREADS) {
      const int r = e / hd, h = e % hd;
      float pv = 0.f;
      for (int j = 0; j < P; ++j) pv += s_p[r * P + j] * s_v[j * hd + h];
      s_acc[e] = s_acc[e] * s_corr[r] + pv;
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * KV + g) * S + s;
  for (int e = tid; e < rep * hd; e += THREADS) o_part[part * rep * hd + e] = s_acc[e];
  for (int r = tid; r < rep; r += THREADS) {
    m_part[part * rep + r] = s_m[r];
    l_part[part * rep + r] = s_l[r];
  }
}

}  // namespace

// kind: 0 fp (bf16 pages), 1 int8, 2 int4.  window < 0 means no window.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scales, const void* v_scales,
                                   const void* block_table, const void* lengths,
                                   void* o_part, void* m_part, void* l_part,
                                   int B, int KV, int rep, int hd, int hdc, int P, int MB,
                                   int n_splits, int bps, int window, int kind, float scale,
                                   void* stream) {
  if (B < 1 || KV < 1 || KV > 65535 || n_splits < 1 ||
      n_splits > 65535 || rep < 1 || hd < 1 || P < 1 || MB < 1 || bps < 1 ||
      kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)2 * rep * hd + (size_t)P * (hd + 1) + (size_t)P * hd +
                       (size_t)rep * P + 3 * (size_t)rep);
  const dim3 grid(B, KV, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scales);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scales);
  const int32_t* bt = static_cast<const int32_t*>(block_table);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
#define REPRO_FD_LAUNCH(K)                                                                \
  do {                                                                                    \
    if (smem > 48 * 1024) {                                                               \
      cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<K>,                        \
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                                           (int)smem);                                    \
      if (e != cudaSuccess) return (int)e;                                                \
    }                                                                                     \
    flash_decode_kernel<K><<<grid, THREADS, smem, st>>>(qq, k_pages, v_pages, ks, vs, bt, \
                                                        ln, o, m, l, KV, rep, hd, hdc, P, \
                                                        MB, bps, window, scale);          \
  } while (0)
  if (kind == 0)
    REPRO_FD_LAUNCH(0);
  else if (kind == 1)
    REPRO_FD_LAUNCH(1);
  else
    REPRO_FD_LAUNCH(2);
#undef REPRO_FD_LAUNCH
  return (int)cudaGetLastError();
}
