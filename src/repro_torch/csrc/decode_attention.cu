// decode_attention for Hopper: one query token per sequence against its KV
// cache, with GQA, per-sequence lengths, a sliding window with an
// always-visible prefix, and logit soft-capping.  Two layouts share one
// body: a dense (B, T, KV, D) cache, and a shared pool of pages
// (P, KV, page_size, D) that each sequence names through a page table.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel) and ::paged_decode_attention (_paged_decode_kernel).
//
// What bounds it on the H100: every cache byte of the visible range is read
// once per query head group and used for two multiply-adds, so it is
// memory-bound (3.35 TB/s) at any batch.
//
// Design: one warp per (sequence, query head); the query head's KV head is
// h / (H / KV).  Each lane holds D / 32 elements of q (pre-scaled) and of
// the output accumulator in registers, the warp walks the visible keys one
// at a time, reads each key row and value row coalesced (lane d reads
// element d), reduces the score with shuffles and keeps the online-softmax
// running max and denominator.  Masked keys are skipped without being read:
// the visible keys are at most two ranges, [0, prefix) and
// [length - window, length), and once one visible key has been seen a
// masked key's weight is exactly zero (before that the reference's
// rescaling factor exp(-big) zeroes it).  A row with no visible key at all
// gets the reference's answer, the uniform average of v over every row of
// the (gathered) cache.
//
// The TPU kernel's grid walks one page per step; here the walk over keys
// is split into runs of rows that are contiguous in memory: the whole
// range for the dense cache, one page for the pool.  Only the address of
// key t differs: ((b*T + t)*KV + kvh)*D in the dense cache,
// ((table[b, t/ps]*KV + kvh)*ps + t%ps)*D in the pool.  The table entry is
// read once per page, and an entry outside [0, P) that would be read stops
// the kernel (__trap) instead of being clamped.  The arithmetic of every
// key is the same in both layouts, so the paged result equals the dense
// one bit for bit on the same logical cache.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPerLane = 8;  // D <= 256

// Key and value rows of one (sequence, KV head) in the dense cache.
template <typename KT>
struct DenseRows {
  const KT* k;
  const KT* v;
  int T;
  size_t step;  // KV * D: from key t to key t + 1

  __device__ int rows() const { return T; }
  // The run of rows that starts at key t and ends before `end`.
  __device__ int run(int t, int end, const KT** kr, const KT** vr) const {
    *kr = k + t * step;
    *vr = v + t * step;
    return end;
  }
};

// Key and value rows of one (sequence, KV head) in the page pool.
template <typename KT>
struct PagedRows {
  const KT* k;  // pool + kvh * ps * D
  const KT* v;
  const int* table;  // the sequence's row of the page table
  int NP, ps, P;
  size_t page_step;  // KV * ps * D
  size_t step;       // D

  __device__ int rows() const { return NP * ps; }
  __device__ int run(int t, int end, const KT** kr, const KT** vr) const {
    const int blk = t / ps;
    const int page = table[blk];
    if ((unsigned)page >= (unsigned)P) __trap();
    const size_t off = page * page_step + (size_t)(t - blk * ps) * step;
    *kr = k + off;
    *vr = v + off;
    return min(end, (blk + 1) * ps);
  }
};

template <typename KT, typename Rows>
__device__ __forceinline__ void walk(const Rows& rows, int lo, int hi,
                                     const float* qr, float* acc, float& m,
                                     float& l, int lane, int D,
                                     float softcap) {
  for (int t = lo; t < hi;) {
    const KT *kr, *vr;
    const int end = rows.run(t, hi, &kr, &vr);
    for (; t < end; ++t, kr += rows.step, vr += rows.step) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s = fmaf(qr[i], repro::to_f32(kr[d]), s);
      }
      s = repro::warp_sum(s);
      if (softcap != 0.f) s = tanhf(s / softcap) * softcap;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new), p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(p, repro::to_f32(vr[d]), acc[i] * alpha);
      }
      m = m_new;
    }
  }
}

// One warp: query row `wid` (sequence b) against `rows`.
template <typename QT, typename KT, typename Rows>
__device__ __forceinline__ void attend(const QT* __restrict__ q,
                                       QT* __restrict__ out, const Rows& rows,
                                       int wid, int len, int D, float scale,
                                       int window, float softcap,
                                       int prefix) {
  const int lane = threadIdx.x & 31;
  float qr[kMaxPerLane], acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? repro::to_f32(q[(size_t)wid * D + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  const int n = rows.rows();
  const int t_hi = min(len, n);
  // Visible keys: [0, t_hi), or with a window [0, a_hi) then [b_lo, t_hi).
  int a_hi = t_hi, b_lo = t_hi;
  if (window) {
    a_hi = min(prefix, t_hi);
    b_lo = max(len - window, a_hi);
  }
  float m = repro::kNegInf, l = 0.f;
  walk<KT>(rows, 0, a_hi, qr, acc, m, l, lane, D, softcap);
  walk<KT>(rows, b_lo, t_hi, qr, acc, m, l, lane, D, softcap);
  if (l == 0.f) {  // nothing visible: softmax of an all-masked row
    for (int t = 0; t < n;) {
      const KT *kr, *vr;
      const int end = rows.run(t, n, &kr, &vr);
      for (; t < end; ++t, vr += rows.step) {
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] += repro::to_f32(vr[d]);
        }
      }
    }
    l = (float)n;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[(size_t)wid * D + d] = repro::from_f32<QT>(acc[i] * inv);
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
decode_attn(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ lengths,
            QT* __restrict__ out, int B, int H, int KV, int T, int D,
            float scale, int window, float softcap, int prefix) {
  const int wid = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= B * H) return;
  const int b = wid / H, kvh = (wid - b * H) / (H / KV);
  const size_t step = (size_t)KV * D;
  const size_t base = (size_t)b * T * step + (size_t)kvh * D;
  const DenseRows<KT> rows{k + base, v + base, T, step};
  attend<QT, KT>(q, out, rows, wid, lengths[b], D, scale, window, softcap,
                 prefix);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
paged_decode_attn(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const int* __restrict__ table,
                  const int* __restrict__ lengths, QT* __restrict__ out,
                  int B, int H, int KV, int P, int ps, int NP, int D,
                  float scale, int window, float softcap, int prefix) {
  const int wid = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= B * H) return;
  const int b = wid / H, kvh = (wid - b * H) / (H / KV);
  const size_t base = (size_t)kvh * ps * D;
  const PagedRows<KT> rows{k + base, v + base, table + (size_t)b * NP, NP,
                           ps, P, (size_t)KV * ps * D, (size_t)D};
  attend<QT, KT>(q, out, rows, wid, lengths[b], D, scale, window, softcap,
                 prefix);
}

int grid(int B, int H) { return (B * H + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int H, int KV, int T, int D, float scale,
           int window, float softcap, int prefix, cudaStream_t st) {
  decode_attn<QT, KT><<<grid(B, H), 32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, static_cast<QT*>(out), B, H, KV,
      T, D, scale, window, softcap, prefix);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_paged(const void* q, const void* k, const void* v,
                 const int* table, const int* lengths, void* out, int B,
                 int H, int KV, int P, int ps, int NP, int D, float scale,
                 int window, float softcap, int prefix, cudaStream_t st) {
  paged_decode_attn<QT, KT><<<grid(B, H), 32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), table, lengths, static_cast<QT*>(out), B,
      H, KV, P, ps, NP, D, scale, window, softcap, prefix);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, D); k, v: (B, T, KV, D); lengths: (B,) int32; out: (B, H, D)
// in q's type.  The caller guarantees H % KV == 0, D <= 256, T >= 1.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int q_bf16, int kv_bf16,
                                       int B, int H, int KV, int T, int D,
                                       float scale, int window, float softcap,
                                       int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, out, B, H, KV,
        T, D, scale, window, softcap, prefix, st);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, lens, out, B, H, KV, T, D,
        scale, window, softcap, prefix, st);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, lens, out, B, H, KV, T, D,
        scale, window, softcap, prefix, st);
  return launch<float, float>(q, k, v, lens, out, B, H, KV, T, D, scale,
                              window, softcap, prefix, st);
}

// q: (B, H, D); k, v pages: (P, KV, ps, D); table: (B, NP) int32; lengths:
// (B,) int32; out: (B, H, D) in q's type.  The caller guarantees
// H % KV == 0, D <= 256, P, ps, NP >= 1.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, int q_bf16, int kv_bf16, int B, int H,
    int KV, int P, int ps, int NP, int D, float scale, int window,
    float softcap, int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  if (q_bf16 && kv_bf16)
    return launch_paged<__nv_bfloat16, __nv_bfloat16>(q, k, v, tab, lens,
        out, B, H, KV, P, ps, NP, D, scale, window, softcap, prefix, st);
  if (q_bf16)
    return launch_paged<__nv_bfloat16, float>(q, k, v, tab, lens, out, B, H,
        KV, P, ps, NP, D, scale, window, softcap, prefix, st);
  if (kv_bf16)
    return launch_paged<float, __nv_bfloat16>(q, k, v, tab, lens, out, B, H,
        KV, P, ps, NP, D, scale, window, softcap, prefix, st);
  return launch_paged<float, float>(q, k, v, tab, lens, out, B, H, KV, P,
                                    ps, NP, D, scale, window, softcap,
                                    prefix, st);
}
