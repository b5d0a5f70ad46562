// Split-K paged flash-decode (FlashDecoding over a paged KV pool) for Hopper,
// with the split combine in the same launch.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode.py::flash_decode
// (body _kernel) and the lax combine that follows it.  One query token per
// slot; the rep query heads that share a kv head are handled by one block
// (REPT heads at a time; more than 8 take several rep chunks).  Output f32
// [B, KV, rep, hd].
//
// Pools: fp (bf16 pages), int8 (codes x bf16 scale) and int4 (two codes per
// byte, low nibble = even element, sign-extended by shifts), the scales
// [n_pages, P, KV] fetched through the same page id as their codes.  Keys are
// visible iff j < L and, with a window, j > L - 1 - window.  Idle slots carry
// a block-table row of zeros and lengths = 1: they read the scratch page 0.
//
// Bound.  Each visible key's K and V row is read once (plus its scales, the
// block-table entries, q and the output): decode attention does ~1 flop per
// byte and is bound by device-memory bytes; at the serve shape (4 slots,
// a few hundred keys) it is bound by latency.  Design:
//   - block (b, kv head, split) walks its share of the slot's visible keys
//     [max(0, L - window), L): the split boundaries come from the slot's own
//     length, so every split of a short and of a long slot has equal work;
//   - warps own key rows: a row of hd elements is read by hd/8 lanes, each
//     one 16-byte (bf16), 8-byte (int8) or 4-byte (int4) piece, dequantised
//     in registers (the scale multiplies the reduced dot product);
//   - q . k is a warp-shuffle reduction; the online max and sum per query
//     head live in registers (warp-uniform), and the warps of a block merge
//     through shared memory once, at the end of the block's keys;
//   - the split's block-table entries are read into shared memory once;
//     each lane then prefetches its rows of the next STAGES-1 iterations
//     with cp.async into a warp-private ring in shared memory, so the loads
//     of later pages overlap the math of the current one;
//   - with more than one split, each block writes its partial (acc, max,
//     sum) and takes a ticket; the last block of a (slot, kv head) to finish
//     merges the partials (the FlashDecoding combine) and writes the output,
//     then resets the ticket for the next launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int STAGES = 4;       // iterations whose loads are in flight per lane
constexpr int MAX_HD = 256;
constexpr int BT_SMEM = 512;    // block-table entries of a split held in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// bytes of one lane's 8 elements: bf16 / int8 / packed int4
template <int KIND>
struct Piece {
  static constexpr int BYTES = KIND == 0 ? 16 : (KIND == 1 ? 8 : 4);
  static constexpr int WORDS = BYTES / 4;
};

// 8 elements of a piece as floats (codes for the quantised kinds)
template <int KIND>
__device__ __forceinline__ void unpack8(const uint32_t* w, float (&x)[8]) {
  if constexpr (KIND == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (KIND == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = (float)((int)(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = (float)((int)(w[0] << (28 - 8 * i)) >> 28);
      x[2 * i + 1] = (float)((int)(w[0] << (24 - 8 * i)) >> 28);
    }
  }
}

template <int KIND, int REPT>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,         // [B, KV, rep, hd]
    const uint8_t* __restrict__ k_pages,         // [n_pages, P, KV, row bytes]
    const uint8_t* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_scales,  // [n_pages, P, KV] (quantised)
    const __nv_bfloat16* __restrict__ v_scales,
    const int32_t* __restrict__ block_table,     // [B, MB]
    const int32_t* __restrict__ lengths,         // [B]
    float* __restrict__ out,                     // [B, KV, rep, hd]
    float* __restrict__ ws_acc,                  // [B*KV*n_rc, S, REPT, hd]
    float* __restrict__ ws_ml,                   // [B*KV*n_rc, S, REPT, 2]
    int* __restrict__ tickets,                   // [B*KV*n_rc], zero between launches
    int KV, int rep, int n_rc, int hd, int P, int MB, int window, int lpr_log,
    float scale) {
  using PC = Piece<KIND>;
  constexpr int EB = PC::BYTES;
  __shared__ __align__(16) uint8_t s_k[NW][STAGES][32][EB];
  __shared__ __align__(16) uint8_t s_v[NW][STAGES][32][EB];
  extern __shared__ float s_merge[];   // [NW][REPT][hd] then [NW][REPT][2]
  __shared__ int s_bt[BT_SMEM];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int g = blockIdx.y / n_rc, rc = blockIdx.y - g * n_rc;
  const int s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int lpr = 1 << lpr_log;              // lanes per key row
  const int rpw = 32 >> lpr_log;             // key rows per warp per iteration
  const int kpi = NW * rpw;                  // keys per iteration
  const int sub = lane & (lpr - 1), grp = lane >> lpr_log;
  const int e0 = sub * 8;
  const bool lane_on = e0 < hd;
  const int row_bytes = KIND == 0 ? hd * 2 : (KIND == 1 ? hd : hd / 2);

  // this split's keys: an equal share of the visible range, whole iterations
  const int L = min(lengths[b], MB * P);
  const int lo = window < 0 ? 0 : max(0, L - window);
  const int per_split = ((L - lo + S - 1) / S + kpi - 1) / kpi * kpi;
  const int k_beg = lo + s * per_split;
  const int k_end = min(L, k_beg + per_split);
  const int n_iter = k_end > k_beg ? (k_end - k_beg + kpi - 1) / kpi : 0;

  // the split's block-table entries, read once: the prefetch of a row then
  // waits on no dependent global load (a split longer than BT_SMEM pages
  // reads its entries from global memory instead)
  const int p_lo = k_beg / P;
  const int n_pg = n_iter ? (k_end - 1) / P - p_lo + 1 : 0;
  const bool bt_in_smem = n_pg <= BT_SMEM;
  if (bt_in_smem)
    for (int i = tid; i < n_pg; i += THREADS) s_bt[i] = block_table[(size_t)b * MB + p_lo + i];
  __syncthreads();

  float qv[REPT][8];
#pragma unroll
  for (int r = 0; r < REPT; ++r) {
    const int h = rc * REPT + r;
    if (lane_on && h < rep) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + (((size_t)b * KV + g) * rep + h) * hd + e0);
      const uint32_t ww[4] = {raw.x, raw.y, raw.z, raw.w};
      unpack8<0>(ww, qv[r]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[r][i] = 0.f;
    }
  }

  float m[REPT], l[REPT], acc[REPT][8];
#pragma unroll
  for (int r = 0; r < REPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }
  float ksc[STAGES] = {}, vsc[STAGES] = {};

  // start iteration `it`'s loads of this lane into ring slot `st`
  auto load_ahead = [&](int it, int st) {
    const int key = k_beg + it * kpi + w * rpw + grp;
    if (it < n_iter && key < k_end) {
      const int pid = bt_in_smem ? s_bt[key / P - p_lo]
                                 : __ldg(block_table + (size_t)b * MB + key / P);
      const size_t row = ((size_t)pid * P + (key % P)) * KV + g;
      if (lane_on) {
        cp_async<EB>(&s_k[w][st][lane][0], k_pages + row * row_bytes + sub * EB);
        cp_async<EB>(&s_v[w][st][lane][0], v_pages + row * row_bytes + sub * EB);
      }
      if (KIND != 0) {   // one scale per row, the same for all its lanes
        ksc[st] = __bfloat162float(k_scales[row]);
        vsc[st] = __bfloat162float(v_scales[row]);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load_ahead(st, st);

  for (int base = 0; base < n_iter; base += STAGES) {
#pragma unroll
    for (int u = 0; u < STAGES; ++u) {
      const int it = base + u;
      if (it >= n_iter) break;
      load_ahead(it + STAGES - 1, (u + STAGES - 1) % STAGES);
      cp_async_wait_stages();
      const int key = k_beg + it * kpi + w * rpw + grp;
      const bool valid = key < k_end;
      float kx[8], vx[8];
      if (valid && lane_on) {
        uint32_t kw[PC::WORDS], vw[PC::WORDS];
#pragma unroll
        for (int i = 0; i < PC::WORDS; ++i) {
          kw[i] = reinterpret_cast<const uint32_t*>(&s_k[w][u][lane][0])[i];
          vw[i] = reinterpret_cast<const uint32_t*>(&s_v[w][u][lane][0])[i];
        }
        unpack8<KIND>(kw, kx);
        unpack8<KIND>(vw, vx);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kx[i] = vx[i] = 0.f;
      }
      const float ks = KIND != 0 ? ksc[u] : 1.f;
      const float vs = KIND != 0 ? vsc[u] : 1.f;
#pragma unroll
      for (int r = 0; r < REPT; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot += qv[r][i] * kx[i];
        for (int off = lpr >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float sc = dot * ks * scale;
        float mx = valid ? sc : NEG_INF;
        for (int off = 16; off >= lpr; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float p = valid ? expf(sc - m_new) : 0.f;
        float psum = p;
        for (int off = 16; off >= lpr; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + psum;
        const float pv = p * vs;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = acc[r][i] * corr + pv * vx[i];
        m[r] = m_new;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the warp's rows: sum the lane groups' partial accumulators
#pragma unroll
  for (int r = 0; r < REPT; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      for (int off = 16; off >= lpr; off >>= 1)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);

  float* s_acc = s_merge;                       // [NW][REPT][hd]
  float* s_ml = s_merge + NW * REPT * hd;       // [NW][REPT][2]
  if (grp == 0 && lane_on) {
#pragma unroll
    for (int r = 0; r < REPT; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) s_acc[(w * REPT + r) * hd + e0 + i] = acc[r][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      s_ml[(w * REPT + r) * 2] = m[r];
      s_ml[(w * REPT + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();

  const int bg = b * gridDim.y + blockIdx.y;
  const size_t part = (size_t)bg * S + s;
  for (int e = tid; e < REPT * hd; e += THREADS) {
    const int r = e / hd, i = e - r * hd;
    float M = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, s_ml[(ww * REPT + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float f = expf(s_ml[(ww * REPT + r) * 2] - M);
      lsum += s_ml[(ww * REPT + r) * 2 + 1] * f;
      a += s_acc[(ww * REPT + r) * hd + i] * f;
    }
    const int h = rc * REPT + r;
    if (S == 1) {
      if (h < rep) out[(((size_t)b * KV + g) * rep + h) * hd + i] = a / fmaxf(lsum, 1e-30f);
    } else {
      ws_acc[(part * REPT + r) * hd + i] = a;
      if (i == 0) {
        ws_ml[(part * REPT + r) * 2] = M;
        ws_ml[(part * REPT + r) * 2 + 1] = lsum;
      }
    }
  }
  if (S == 1) return;

  // the last split of (b, g, rc) to finish combines all S partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[bg], 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < REPT * hd; e += THREADS) {
    const int r = e / hd, i = e - r * hd;
    const int h = rc * REPT + r;
    if (h >= rep) continue;
    float M = NEG_INF;
    for (int ss = 0; ss < S; ++ss)
      M = fmaxf(M, __ldcg(&ws_ml[(((size_t)bg * S + ss) * REPT + r) * 2]));
    float lsum = 0.f, a = 0.f;
    for (int ss = 0; ss < S; ++ss) {
      const size_t pp = (size_t)bg * S + ss;
      const float f = expf(__ldcg(&ws_ml[(pp * REPT + r) * 2]) - M);
      lsum += __ldcg(&ws_ml[(pp * REPT + r) * 2 + 1]) * f;
      a += __ldcg(&ws_acc[(pp * REPT + r) * hd + i]) * f;
    }
    out[(((size_t)b * KV + g) * rep + h) * hd + i] = a / fmaxf(lsum, 1e-30f);
  }
  if (tid == 0) tickets[bg] = 0;
}

template <int KIND, int REPT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st, const __nv_bfloat16* q,
                   const uint8_t* kp, const uint8_t* vp, const __nv_bfloat16* ks,
                   const __nv_bfloat16* vs, const int32_t* bt, const int32_t* ln, float* out,
                   float* ws_acc, float* ws_ml, int* tickets, int KV, int rep, int n_rc, int hd,
                   int P, int MB, int window, int lpr_log, float scale) {
  if (smem > 32 * 1024) {   // beside up to 16 KB of static ring buffers
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<KIND, REPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_decode_kernel<KIND, REPT><<<grid, THREADS, smem, st>>>(
      q, kp, vp, ks, vs, bt, ln, out, ws_acc, ws_ml, tickets, KV, rep, n_rc, hd, P, MB, window,
      lpr_log, scale);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch_rep(int rept, dim3 grid, size_t smem, cudaStream_t st,
                         const __nv_bfloat16* q, const uint8_t* kp, const uint8_t* vp,
                         const __nv_bfloat16* ks, const __nv_bfloat16* vs, const int32_t* bt,
                         const int32_t* ln, float* out, float* ws_acc, float* ws_ml,
                         int* tickets, int KV, int rep, int n_rc, int hd, int P, int MB,
                         int window, int lpr_log, float scale) {
#define REPRO_FD_ARGS grid, smem, st, q, kp, vp, ks, vs, bt, ln, out, ws_acc, ws_ml, tickets, \
                      KV, rep, n_rc, hd, P, MB, window, lpr_log, scale
  if (rept == 1) return launch<KIND, 1>(REPRO_FD_ARGS);
  if (rept == 4) return launch<KIND, 4>(REPRO_FD_ARGS);
  return launch<KIND, 8>(REPRO_FD_ARGS);
#undef REPRO_FD_ARGS
}

}  // namespace

// Query heads per block for `rep` heads per kv head: 1, 4 or 8 (rep > 8
// takes ceil(rep / 8) rep chunks).
extern "C" int flash_decode_rep_tile(int rep) { return rep == 1 ? 1 : (rep <= 4 ? 4 : 8); }

// kind: 0 fp (bf16 pages), 1 int8, 2 int4.  window < 0 means no window.
// n_splits > 1 needs ws_acc [B*KV*n_rc*n_splits*REPT*hd], ws_ml
// [B*KV*n_rc*n_splits*REPT*2] f32 and tickets [B*KV*n_rc] int32 holding
// zeros (the kernel leaves them zero).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int flash_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scales, const void* v_scales,
                                   const void* block_table, const void* lengths, void* out,
                                   void* ws_acc, void* ws_ml, void* tickets, int B, int KV,
                                   int rep, int hd, int P, int MB, int n_splits, int window,
                                   int kind, float scale, void* stream) {
  if (B < 1 || KV < 1 || rep < 1 || hd < 8 || hd > MAX_HD || hd % 8 != 0 || P < 1 ||
      MB < 1 || n_splits < 1 || n_splits > 65535 || kind < 0 || kind > 2 ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rept = flash_decode_rep_tile(rep);
  const int n_rc = (rep + rept - 1) / rept;
  if ((long long)KV * n_rc > 65535) return (int)cudaErrorInvalidValue;
  int lpr_log = 0;
  while ((8 << lpr_log) < hd) ++lpr_log;    // lanes per row: next power of 2 >= hd/8
  const size_t smem = sizeof(float) * ((size_t)NW * rept * hd + (size_t)NW * rept * 2);
  const dim3 grid(B, KV * n_rc, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const uint8_t* kp = static_cast<const uint8_t*>(k_pages);
  const uint8_t* vp = static_cast<const uint8_t*>(v_pages);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scales);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scales);
  const int32_t* bt = static_cast<const int32_t*>(block_table);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  float* o = static_cast<float*>(out);
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  int* tk = static_cast<int*>(tickets);
#define REPRO_FD_ARGS rept, grid, smem, st, qq, kp, vp, ks, vs, bt, ln, o, wa, wm, tk, KV, rep, \
                      n_rc, hd, P, MB, window, lpr_log, scale
  cudaError_t e;
  if (kind == 0)
    e = dispatch_rep<0>(REPRO_FD_ARGS);
  else if (kind == 1)
    e = dispatch_rep<1>(REPRO_FD_ARGS);
  else
    e = dispatch_rep<2>(REPRO_FD_ARGS);
#undef REPRO_FD_ARGS
  return (int)e;
}
