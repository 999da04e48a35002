// decode_attention for Hopper: one query token per sequence against a
// dense (B, T, KV, D) cache, with GQA, per-sequence lengths, a sliding
// window with an always-visible prefix, and logit soft-capping.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel); the paged variant is not ported here.
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
// once one visible key has been seen a masked key's weight is exactly zero,
// and before that the reference's rescaling factor exp(-big) zeroes it.  A
// row with no visible key at all gets the reference's answer, the uniform
// average of v over all T.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxPerLane = 8;  // D <= 256

template <typename QT, typename KT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
decode_attn(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ lengths,
            QT* __restrict__ out, int B, int H, int KV, int T, int D,
            float scale, int window, float softcap, int prefix) {
  const int wid = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= B * H) return;
  const int lane = threadIdx.x & 31;
  const int b = wid / H, h = wid - b * H;
  const int kvh = h / (H / KV);

  float qr[kMaxPerLane], acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? repro::to_f32(q[(size_t)wid * D + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  const size_t tstride = (size_t)KV * D;
  const KT* kb = k + (size_t)b * T * tstride + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * T * tstride + (size_t)kvh * D;
  const int len = lengths[b];
  const int t_hi = min(len, T);

  float m = repro::kNegInf, l = 0.f;
  for (int t = 0; t < t_hi; ++t) {
    if (window && t < len - window && t >= prefix) continue;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) s = fmaf(qr[i], repro::to_f32(kb[t * tstride + d]), s);
    }
    s = repro::warp_sum(s);
    if (softcap != 0.f) s = tanhf(s / softcap) * softcap;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(p, repro::to_f32(vb[t * tstride + d]),
                               acc[i] * alpha);
    }
    m = m_new;
  }
  if (l == 0.f) {  // nothing visible: softmax of an all-masked row
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += repro::to_f32(vb[t * tstride + d]);
      }
    }
    l = (float)T;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[(size_t)wid * D + d] = repro::from_f32<QT>(acc[i] * inv);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int H, int KV, int T, int D, float scale,
           int window, float softcap, int prefix, cudaStream_t st) {
  const int blocks = (B * H + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_attn<QT, KT><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, static_cast<QT*>(out), B, H, KV,
      T, D, scale, window, softcap, prefix);
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
