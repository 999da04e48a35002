// flash_attention for Hopper: prefill attention of (B, S, H, D) queries
// against (B, T, KV, D) keys and values, with GQA, a causal mask, a sliding
// window with an always-visible prefix, logit soft-capping and q_offset
// (the absolute position of query 0).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).
//
// What bounds it on the H100: at the main path's prompt lengths (a few to a
// few hundred tokens) the work is small and the kernel is bound by reading
// q, k and v once (bytes); at long prompts it becomes bound by the
// S * T * D multiply-adds, which this simple kernel does on the f32 units,
// not on the tensor cores.
//
// Design: one block per (query tile of 32 rows, head, sequence), 128
// threads, four threads per query row, each holding a quarter of the row's
// D elements of q (pre-scaled) and of the output accumulator in registers.
// The block walks the key range that any of its rows can see in tiles of
// 32 keys: the tile's keys and values are converted to f32 into shared
// memory, where the rows read them as broadcasts, and each row runs the
// online softmax over them.  No mask or score tensor exists in device
// memory.  Masked keys are skipped: their weight is exactly zero (see
// decode_attention.cu).  A row with no visible key gets the reference's
// answer, the uniform average of v over all T.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;   // query rows per block
constexpr int kSub = 4;   // threads per query row
constexpr int kBK = 32;   // keys per shared-memory tile
constexpr int kThreads = kBQ * kSub;

template <typename QT, typename KT, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attn(const QT* __restrict__ q, const KT* __restrict__ k,
           const KT* __restrict__ v, QT* __restrict__ out, int S, int T,
           int H, int KV, int D, float scale, int causal, int window,
           float softcap, int prefix, int q_offset) {
  extern __shared__ float smem[];
  float* ks = smem;            // [kBK][D]
  float* vs = smem + kBK * D;  // [kBK][D]
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int row = threadIdx.x / kSub, sub = threadIdx.x % kSub;
  const int i = tile * kBQ + row;
  const bool live = i < S;
  const int q_pos = q_offset + i;
  const int kvh = h / (H / KV);

  float qr[DPT], acc[DPT];
  const QT* qp = q + (((size_t)b * S + (live ? i : 0)) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + kSub * j;
    qr[j] = (live && d < D) ? repro::to_f32(qp[d]) * scale : 0.f;
    acc[j] = 0.f;
  }

  // Keys that some row of this tile can see.
  const int last_q = q_offset + min(S, (tile + 1) * kBQ) - 1;
  const int kv_hi = causal ? min(T, last_q + 1) : T;
  const int kv_lo = (window && !prefix)
      ? max(0, q_offset + tile * kBQ - window + 1) : 0;

  const size_t tstride = (size_t)KV * D;
  const KT* kb = k + (size_t)b * T * tstride + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * T * tstride + (size_t)kvh * D;

  float m = repro::kNegInf, l = 0.f;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBK) {
    const int nt = min(kBK, kv_hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * D; e += kThreads) {
      const int tt = e / D, d = e - tt * D;
      const size_t g = (size_t)(t0 + tt) * tstride + d;
      ks[e] = repro::to_f32(kb[g]);
      vs[e] = repro::to_f32(vb[g]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float* kr = ks + tt * D;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + kSub * j;
        if (d < D) s = fmaf(qr[j], kr[d], s);
      }
      // Every lane takes part in the shuffles; masking comes after.
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int t = t0 + tt;
      bool ok = live;
      if (causal) ok = ok && t <= q_pos;
      if (window) ok = ok && (t > q_pos - window || t < prefix);
      if (!ok) continue;
      if (softcap != 0.f) s = tanhf(s / softcap) * softcap;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new), p = expf(s - m_new);
      l = l * alpha + p;
      const float* vr = vs + tt * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + kSub * j;
        if (d < D) acc[j] = fmaf(p, vr[d], acc[j] * alpha);
      }
      m = m_new;
    }
  }
  if (!live) return;
  if (l == 0.f) {  // nothing visible: softmax of an all-masked row
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = sub + kSub * j;
        if (d < D) acc[j] += repro::to_f32(vb[(size_t)t * tstride + d]);
      }
    }
    l = (float)T;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  QT* op = out + (((size_t)b * S + i) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = sub + kSub * j;
    if (d < D) op[d] = repro::from_f32<QT>(acc[j] * inv);
  }
}

template <typename QT, typename KT, int DPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int KV, int D, float scale, int causal,
           int window, float softcap, int prefix, int q_offset,
           cudaStream_t st) {
  auto kernel = flash_attn<QT, KT, DPT>;
  const size_t smem = 2 * kBK * (size_t)D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), S, T, H, KV, D,
      scale, causal, window, softcap, prefix, q_offset);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T, int H, int KV, int D, float scale, int causal,
             int window, float softcap, int prefix, int q_offset,
             cudaStream_t st) {
  if (D <= 32)
    return launch<QT, KT, 8>(q, k, v, out, B, S, T, H, KV, D, scale, causal,
                             window, softcap, prefix, q_offset, st);
  if (D <= 64)
    return launch<QT, KT, 16>(q, k, v, out, B, S, T, H, KV, D, scale, causal,
                              window, softcap, prefix, q_offset, st);
  if (D <= 128)
    return launch<QT, KT, 32>(q, k, v, out, B, S, T, H, KV, D, scale, causal,
                              window, softcap, prefix, q_offset, st);
  return launch<QT, KT, 64>(q, k, v, out, B, S, T, H, KV, D, scale, causal,
                            window, softcap, prefix, q_offset, st);
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); out: (B, S, H, D) in q's type.
// The caller guarantees H % KV == 0, D <= 256, S >= 1, T >= 1.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int q_bf16,
                                      int kv_bf16, int B, int S, int T, int H,
                                      int KV, int D, float scale, int causal,
                                      int window, float softcap, int prefix,
                                      int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, B, S, T, H,
        KV, D, scale, causal, window, softcap, prefix, q_offset, st);
  if (q_bf16)
    return launch_d<__nv_bfloat16, float>(q, k, v, out, B, S, T, H, KV, D,
        scale, causal, window, softcap, prefix, q_offset, st);
  if (kv_bf16)
    return launch_d<float, __nv_bfloat16>(q, k, v, out, B, S, T, H, KV, D,
        scale, causal, window, softcap, prefix, q_offset, st);
  return launch_d<float, float>(q, k, v, out, B, S, T, H, KV, D, scale,
                                causal, window, softcap, prefix, q_offset, st);
}
