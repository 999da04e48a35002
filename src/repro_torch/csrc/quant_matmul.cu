// quant_matmul for Hopper: y = x @ (w_q * scale), f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (body _qmm_kernel).  Weights are int8 storage holding 8- or 4-bit values,
// with one f32 scale per (K-group, N-column).
//
// What bounds it on the H100: at decode M is the batch (<= 4 on the main
// path), so each weight byte is used M times and the kernel streams the
// weights from device memory: it is memory-bound (3.35 TB/s).  At prefill
// M = B*S (<= 48 on the main path) it is still far below the card's
// operations-per-byte ridge.
//
// Design: threads walk the N columns, four columns each, so a warp reads
// 128 consecutive int8 weights of one K row in one coalesced 128-byte
// load.  Each warp takes a slice of the block's K range and issues the
// loads of eight rows before it uses any of them, so that enough bytes are
// in flight to cover the memory latency; the scales are read once per
// group.  Each thread dequantizes w_q[k, n] * s[k / group, n] in registers
// and accumulates MT rows of x in f32 (MT = 4 at decode, where M <= 4, so
// no multiply-adds go to padding; 8 otherwise); the x rows of the block's
// K range sit in shared memory and are read as broadcasts.  There are few
// columns per layer (256 to 5632), so the K range is split across blocks
// (grid.y) until the card holds about four blocks per SM: each split
// writes an f32 partial sum, and a second, small kernel adds the partials
// in a fixed order (deterministic) and casts to the output type.
#include "common.cuh"

namespace {

constexpr int kCols = 4;             // columns per thread: one char4
constexpr int kWarps = 8;            // warps per block, each a slice of K
constexpr int kMTMax = 8;            // rows of x per block, at most
constexpr int kBN = 32 * kCols;      // columns per block
constexpr int kKcMax = 256;          // rows of K staged per block
constexpr int kUnroll = 8;           // K rows whose loads a warp issues at once

template <typename XT, int MT>
__global__ void __launch_bounds__(32 * kWarps)
qmm_partial(const XT* __restrict__ x, const int8_t* __restrict__ wq,
            const float* __restrict__ scales, float* __restrict__ part,
            int M, int K, int N, int group, int kc) {
  __shared__ float xs[kKcMax][MT];
  __shared__ float red[kWarps][MT][kBN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBN + lane * kCols;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  const int rows = k1 - k0;
  const int m0 = blockIdx.z * MT;

  // Stage x[m0:m0+MT, k0:k1] as f32 (rows past M read as zero).
  for (int i = threadIdx.x; i < rows * MT; i += blockDim.x) {
    const int m = i / rows, kk = i - m * rows;
    xs[kk][m] = (m0 + m < M)
        ? repro::to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  if (n0 < N) {  // N % 4 == 0, so all four columns are in range
    const int per = (rows + kWarps - 1) / kWarps;
    const int ka = k0 + warp * per, kb = min(k1, ka + per);
    float sc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int k = ka; k < kb; k += kUnroll) {
      char4 q4[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q4[u] = (k + u < kb)
            ? __ldg(reinterpret_cast<const char4*>(wq + (size_t)(k + u) * N + n0))
            : make_char4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + u;
        if (kk >= kb) break;
        if (kk == ka || kk % group == 0) {
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(
              scales + (size_t)(kk / group) * N + n0));
          sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
        }
        const float w[kCols] = {(float)q4[u].x * sc[0], (float)q4[u].y * sc[1],
                                (float)q4[u].z * sc[2], (float)q4[u].w * sc[3]};
        const float* xr = xs[kk - k0];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[m][j] = fmaf(xr[m], w[j], acc[m][j]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[warp][m][lane * kCols + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kBN; i += blockDim.x) {
    const int m = i / kBN, c = i - m * kBN;
    const int n = blockIdx.x * kBN + c;
    if (m0 + m < M && n < N) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][m][c];
      part[((size_t)blockIdx.y * M + m0 + m) * N + n] = v;
    }
  }
}

template <typename XT>
void launch_partial(const XT* x, const int8_t* w, const float* s, float* p,
                    int M, int K, int N, int group, int splits, int kc,
                    cudaStream_t st) {
  // MT = 4 when M <= 4 (decode), else 8; the wrapper tiles M the same way.
  if (M <= 4) {
    const dim3 grid((N + kBN - 1) / kBN, splits, (M + 3) / 4);
    qmm_partial<XT, 4><<<grid, 32 * kWarps, 0, st>>>(x, w, s, p, M, K, N,
                                                      group, kc);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, splits, (M + kMTMax - 1) / kMTMax);
    qmm_partial<XT, kMTMax><<<grid, 32 * kWarps, 0, st>>>(x, w, s, p, M, K,
                                                           N, group, kc);
  }
}

template <typename OT>
__global__ void qmm_reduce(const float* __restrict__ part, OT* __restrict__ out,
                           int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(size_t)s * MN + i];
  out[i] = repro::from_f32<OT>(v);
}

}  // namespace

// x: (M, K) f32 or bf16; wq: (K, N) int8; scales: (K / group, N) f32;
// part: (splits, M, N) f32 scratch; out: (M, N) f32 or bf16.  The caller
// guarantees N % 4 == 0, K % group == 0, kc <= 256 and splits * kc >= K.
extern "C" int quant_matmul_launch(const void* x, int x_bf16, const void* wq,
                                   const void* scales, void* part, void* out,
                                   int out_bf16, int M, int K, int N,
                                   int group, int splits, int kc,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* s = static_cast<const float*>(scales);
  auto* p = static_cast<float*>(part);
  if (x_bf16)
    launch_partial(static_cast<const __nv_bfloat16*>(x), w, s, p, M, K, N,
                   group, splits, kc, st);
  else
    launch_partial(static_cast<const float*>(x), w, s, p, M, K, N, group,
                   splits, kc, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int MN = M * N;
  const int threads = 256, blocks = (MN + threads - 1) / threads;
  if (out_bf16)
    qmm_reduce<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(out), MN, splits);
  else
    qmm_reduce<float><<<blocks, threads, 0, st>>>(
        p, static_cast<float*>(out), MN, splits);
  return (int)cudaGetLastError();
}
