// ssd_scan for Hopper: the Mamba-2 state-space-duality scan,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
//   y_t = C_t · h_t + D * x_t,
// over x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N), all four in one
// type (float32 or bfloat16), each group of B and C shared by H/G heads;
// A and D (H,) float32; an optional initial state (B, H, P, N) float32.
// Writes y (B, S, H, P) in x's type and, when asked, the final state
// (B, H, P, N) float32.  All arithmetic is float32.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).
//
// What bounds it on the H100: at a serving prefill (a few to a few tens of
// tokens) the bytes, and of those mostly the (P, N) float32 state written
// for every (sequence, head); at long prompts the operations, the chunked
// form's 2Q^2 N per (sequence, group, chunk) plus 2Q^2 P + 4QPN per
// (sequence, head, chunk).  This kernel does them on the float32 units:
// TF32 tensor cores would miss the reference's 2e-4 tolerance.
//
// Design: one block per (head, sequence), 256 threads.  The (P, N) state
// stays in shared memory through the whole chunk loop, as it stays in the
// TPU kernel's VMEM scratch, and goes to device memory once at the end.
// The chunk is kQ = 64 tokens, whatever the model's chunk (256 for
// mamba2-780m): at 256 the (Q, Q) float32 decay block alone would be
// 256 KB, more than an SM has, and the result depends on the chunk length
// only through rounding.  Per chunk:
//   1. stage x, dt, B and C as float32 in shared memory; the rows past a
//      ragged tail are zeros with dt = 0, which is exact (decay 1, no
//      contribution), as in the reference's padding;
//   2. a_cum = inclusive cumulative sum of dt * A over the chunk;
//   3. M[i][j] = (C_i · B_j) exp(a_cum_i - a_cum_j) dt_j for j <= i, and 0
//      above the diagonal by selection: the exponent overflows there, and
//      a product would turn the overflow into NaN;
//   4. y_i = sum_j M[i][j] x_j + exp(a_cum_i) (C_i · state) + D x_i;
//   5. state = exp(a_end) state + sum_j x_j ⊗ B_j exp(a_end - a_cum_j) dt_j.
// Each phase gives every thread a small register tile (4x4 or 8x4 outputs)
// so that shared-memory loads are shared by several multiply-adds; rows of
// B, C and the state are padded to an odd length so that a warp reading
// one column of 16 or 32 rows hits as many banks.  x, dt, B and C are read
// in their native (B, S, ...) layout with a row stride: the model's column
// slices of one projection need no copy.  The decay block for all heads of
// a group is recomputed per head (H/G times): simple, and cheap next to
// phases 4 and 5 at P = 64.
#include "common.cuh"

namespace {

constexpr int kQ = 64;         // tokens per chunk
constexpr int kThreads = 256;  // 16 x 16 tiles in phases 3-4, 8 x 32 in 5
constexpr int kMaxP = 64;      // columns of y / rows of the state held
constexpr int kMaxN = 128;     // state width held

__host__ __device__ inline int odd(int n) { return n | 1; }

size_t smem_bytes(int P, int N) {
  const size_t ldn = odd(N);
  return sizeof(float) * (P * ldn            // state [P][ldn]
                          + kQ * (size_t)P   // x [kQ][P]
                          + 2 * kQ * ldn     // B, C [kQ][ldn]
                          + kQ * (kQ + 1)    // M [kQ][kQ + 1]
                          + 3 * kQ);         // dt, a_cum, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunked(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Dskip,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const float* __restrict__ init, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H, int P, int G, int N,
            long long x_rs, long long dt_rs, long long b_rs,
            long long c_rs) {
  extern __shared__ float smem[];
  const int ldn = odd(N), ldm = kQ + 1;
  float* st = smem;             // [P][ldn]
  float* xs = st + P * ldn;     // [kQ][P]
  float* bs = xs + kQ * P;      // [kQ][ldn]
  float* cs = bs + kQ * ldn;    // [kQ][ldn]
  float* ms = cs + kQ * ldn;    // [kQ][ldm]
  float* dts = ms + kQ * ldm;   // [kQ]
  float* acum = dts + kQ;       // [kQ]
  float* wv = acum + kQ;        // [kQ]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / (H / G);
  const float a_h = A[h], d_h = Dskip[h];
  const size_t soff = ((size_t)b * H + h) * P * N;
  const T* xb = x + (size_t)b * S * x_rs + (size_t)h * P;
  const T* dtb = dt + (size_t)b * S * dt_rs + h;
  const T* bb = Bm + (size_t)b * S * b_rs + (size_t)g * N;
  const T* cb = Cm + (size_t)b * S * c_rs + (size_t)g * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    st[p * ldn + n] = init ? init[soff + e] : 0.f;
  }

  // Tile coordinates: phases 3-4 give a thread rows r16 + 16a (a < 4) and
  // columns c16 + 16c (c < 4); phase 5 state rows p8 + 8a (a < 8) and
  // columns n32 + 32c (c < 4).
  const int r16 = tid >> 4, c16 = tid & 15;
  const int p8 = tid >> 5, n32 = tid & 31;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int i = e / P, p = e - i * P;
      xs[e] = i < nq ? repro::to_f32(xb[(size_t)(c0 + i) * x_rs + p]) : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      const bool ok = i < nq;
      bs[i * ldn + n] = ok ? repro::to_f32(bb[(size_t)(c0 + i) * b_rs + n])
                           : 0.f;
      cs[i * ldn + n] = ok ? repro::to_f32(cb[(size_t)(c0 + i) * c_rs + n])
                           : 0.f;
    }
    for (int i = tid; i < kQ; i += kThreads)
      dts[i] = i < nq ? repro::to_f32(dtb[(size_t)(c0 + i) * dt_rs]) : 0.f;
    __syncthreads();
    if (tid == 0) {  // 2. the cumulative log decay, in token order
      float s = 0.f;
      for (int i = 0; i < kQ; ++i) {
        s = fmaf(dts[i], a_h, s);
        acum[i] = s;
      }
    }
    __syncthreads();
    const float a_end = acum[kQ - 1];  // = a_cum of the last valid token
    for (int i = tid; i < kQ; i += kThreads)
      wv[i] = expf(a_end - acum[i]) * dts[i];

    // 3. M = (C B^T) ⊙ L ⊙ dt_key over the rows that exist.
    const int na = max(0, (nq - r16 + 15) >> 4);  // rows r16 + 16a < nq
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(r16 + 16 * a) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(c16 + 16 * c) * ldn + n];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (a >= na) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r16 + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c16 + 16 * c;
          ms[i * ldm + j] = (j <= i && i < nq)
              ? acc[a][c] * expf(acum[i] - acum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = M x + exp(a_cum) (C state^T) + D x, on the state at the
    // chunk's start.
    {
      float s1[4][4] = {}, s2[4][4] = {};
      for (int j = 0; j < nq; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = ms[(r16 + 16 * a) * ldm + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = c16 + 16 * c;
          xv[c] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (a >= na) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) s1[a][c] = fmaf(mv[a], xv[c], s1[a][c]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(r16 + 16 * a) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = c16 + 16 * c;
          sv[c] = p < P ? st[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (a >= na) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) s2[a][c] = fmaf(cv[a], sv[c], s2[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r16 + 16 * a;
        if (i >= nq) continue;
        const float e_i = expf(acum[i]);
        T* yr = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = c16 + 16 * c;
          if (p < P)
            yr[p] = repro::from_f32<T>(s1[a][c] + e_i * s2[a][c]
                                       + d_h * xs[i * P + p]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // 5. Decay the state to the chunk's end and add the chunk's inputs.
    {
      float acc[8][4] = {};
      for (int j = 0; j < nq; ++j) {
        const float w = wv[j];
        float xw[8], bv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int p = p8 + 8 * a;
          xw[a] = p < P ? xs[j * P + p] * w : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n32 + 32 * c;
          bv[c] = n < N ? bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xw[a], bv[c], acc[a][c]);
      }
      const float dec = expf(a_end);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int p = p8 + 8 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n32 + 32 * c;
          if (p < P && n < N)
            st[p * ldn + n] = fmaf(dec, st[p * ldn + n], acc[a][c]);
        }
      }
    }
  }
  if (state_out) {
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      state_out[soff + e] = st[p * ldn + n];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const float* D,
           const void* Bm, const void* Cm, const float* init, void* y,
           float* state_out, int B, int S, int H, int P, int G, int N,
           long long x_rs, long long dt_rs, long long b_rs, long long c_rs,
           cudaStream_t st) {
  auto kernel = ssd_chunked<T>;
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, D,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), init,
      static_cast<T*>(y), state_out, S, H, P, G, N, x_rs, dt_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N): element [b, s, ...]
// of each at row (b * S + s) times its row stride (in elements), the rest
// of the row contiguous.  A, D (H,) float32; init (B, H, P, N) float32 or
// null; y (B, S, H, P) contiguous; state_out (B, H, P, N) or null.  The
// caller guarantees H % G == 0, 1 <= P <= 64, 1 <= N <= 128, S >= 1.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* D, const void* Bm, const void* Cm,
                               const void* init, void* y, void* state_out,
                               int bf16, int B, int S, int H, int P, int G,
                               int N, long long x_rs, long long dt_rs,
                               long long b_rs, long long c_rs, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  const float* i0 = static_cast<const float*>(init);
  float* so = static_cast<float*>(state_out);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, d, Bm, Cm, i0, y, so, B, S, H, P,
                                 G, N, x_rs, dt_rs, b_rs, c_rs, st);
  return launch<float>(x, dt, a, d, Bm, Cm, i0, y, so, B, S, H, P, G, N,
                       x_rs, dt_rs, b_rs, c_rs, st);
}
