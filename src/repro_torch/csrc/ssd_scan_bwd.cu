// ssd_scan_bwd for Hopper: the gradients of the Mamba-2 state-space-duality
// scan that ssd_scan.cu computes,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
//   y_t = C_t · h_t + D * x_t,
// for x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) in one type
// (float32 or bfloat16), each group of B and C shared by H/G heads; A and D
// (H,) float32; an optional initial state (B, H, P, N) float32.  Given dy
// (B, S, H, P) in x's type and, optionally, the cotangent of the final
// state (B, H, P, N) float32, it writes dx, ddt, dB and dC in the inputs'
// type, dA and dD float32, and the initial state's gradient float32.  All
// arithmetic is float32 on the CUDA cores: TF32 would miss the scan's 2e-4.
//
// The function it differentiates is src/repro/kernels/ssd_scan.py:83
// ssd_scan (its Pallas kernel, pallas_call at :137, has no backward; the
// reference trains through jax.grad of the chunked form,
// src/repro/kernels/ref.py ssd_scan_chunked).  The port's models run their
// scan through ssd_scan.cu, so training on the card needs its gradient
// from a kernel too.
//
// What bounds it on the H100: operations.  The least work is the
// sequential form's backward, per token and head: the state cotangent's
// step g = e^a g' + dy ⊗ C (3 P N), dC = h^T dy, dx = dt g B, dB = dt g^T x
// and d(a) = e^a <g, h> (2 P N each), and dx's skip term, dD and ddt's
// x . (g B) (2 P each): 11 P N + 6 P; plus the sums of dB and dC over the
// H/G heads of a group, 2 N (H - G) a token.  At mamba2-780m's training
// shape (4 x 1024 tokens, 48 heads, P 64, N 128) that is 17.8 GFLOP a
// layer, 0.27 ms at 67 TFLOP/s float32; the bytes (x, dt, B, C and dy read,
// the gradients written) are 80 MB in bf16, 0.024 ms.  At hymba-1.5b's (1 x
// 2176, 25 heads, N 16) the 0.64 GFLOP take 9.5 us and its 21 MB of bytes
// 6.4 us.
//
// Design (a first version: right and simple, every product a scalar loop
// over float32 tiles in shared memory, two shared loads a multiply-add, one
// of them a broadcast).
// One block per (head, sequence), 256 threads, holding all P columns of the
// head, so every sum over P stays inside the block.  The chunk is kQ rows
// (16, 32 or 64; kernels/ssd_scan.py::ssd_bwd_plan takes the largest whose
// block still lets two share an SM: 16 at N = 128, 32 at hymba's N = 16).
//   Pass 1, over chunks in order: the state entering each chunk, written to
//     a scratch buffer (B, H, chunks, P, N) float32 that the wrapper
//     allocates, then the state update of the forward,
//       h = e^{a_end} h + sum_j w_j x_j ⊗ B_j,  w_j = e^{a_end - a_j} dt_j,
//     with a = cumsum(dt A) inside the chunk and a_end its last valid row.
//   Pass 2, over chunks in reverse, with the state cotangent g (P, N) in
//     shared memory, seeded with the final state's cotangent or zero, and h
//     the chunk's entry state:
//     A. CB_ij = C_i . B_j and dM_ij = dy_i . x_j over the chunk's rows;
//        gB_jp = sum_n g_pn B_jn; Z_in = sum_p dy_ip h_pn.
//     B. For j <= i, with L_ij = e^{a_i - a_j} (selected, never multiplied
//        by a mask: the exponent overflows above the diagonal), M = CB L dt_j,
//        W = dM L dt_j and F = dM CB L; zero above the diagonal.  Per row,
//        C_i . Z_i and x_j . gB_j.
//     C. dx_j = sum_i M_ij dy_i + D dy_j + w_j gB_j (written in x's type);
//        dC_i = sum_j W_ij B_j + e^{a_i} Z_i (a per-head float32 partial);
//        the row sums of F dt and the column sums of F; <g, h>.
//     D. d(a) per row: the decay block's sum_j F_ij dt_j - dt_i sum_k F_ki,
//        e^{a_i} C_i . Z_i from the carried state's read-out, -w_i x_i . gB_i
//        from the update, and on the last valid row e^{a_end} <g, h> and
//        the sum of the w_j x_j . gB_j.  A reverse cumulative sum R turns it
//        into ddt_m = sum_i F_im + e^{a_end - a_m} x_m . gB_m + A R_m (dt
//        enters as the key factor of M and w, and through a), and dA, dD
//        gather dt_m R_m and dy_i . x_i over the chunks.  Xg_jn =
//        sum_p x_jp g_pn replaces Z.
//     E. dB_j = sum_i W_ij C_i + w_j Xg_j (a per-head partial), and the
//        state cotangent steps back: g = e^{a_end} g + sum_i e^{a_i} dy_i ⊗
//        C_i.  After the first chunk g is the initial state's gradient.
//   A second kernel sums the per-head partials of dB and dC over the heads
//   of each group, and dA and dD over the sequences, in a fixed order.
// Rows past a ragged tail are never read: every product stops at the
// chunk's valid rows (the reference pads them with dt = 0, which gives them
// no gradient).  No atomics: every sum runs in a fixed order, so two calls
// are bit-equal.  Row strides of shared tiles are odd, so that threads
// reading down a column fall in distinct banks.  x, dt, B and C are read
// in their native (B, S, ...) layout with a row stride, as the forward
// reads them (the model's column slices of one projection need no copy).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kVecs = 10;  // per-row vectors of kQ floats

// Float offsets of a block's shared memory; kernels/ssd_scan.py::_bwd_smem
// mirrors the total, and the launcher refuses a plan that disagrees.
struct Layout {
  int lq, lp, ln;  // odd row strides of (., kQ), (., P) and (., N) tiles
  size_t h, g, xs, dys, gb, bs, cs, t1, mb, wb, fb, vec, red, total;
};

__host__ __device__ inline Layout layout(int kq, int P, int N) {
  Layout L;
  L.lq = kq | 1;
  L.lp = P | 1;
  L.ln = N | 1;
  size_t o = 0;
  L.h = o;   o += (size_t)P * L.ln;    // the chunk's entry state
  L.g = o;   o += (size_t)P * L.ln;    // the state cotangent
  L.xs = o;  o += (size_t)kq * L.lp;   // x
  L.dys = o; o += (size_t)kq * L.lp;   // dy
  L.gb = o;  o += (size_t)kq * L.lp;   // g B
  L.bs = o;  o += (size_t)kq * L.ln;   // B
  L.cs = o;  o += (size_t)kq * L.ln;   // C
  L.t1 = o;  o += (size_t)kq * L.ln;   // Z, then x^T g
  L.mb = o;  o += (size_t)kq * L.lq;   // C B^T, then M
  L.wb = o;  o += (size_t)kq * L.lq;   // dy x^T, then W
  L.fb = o;  o += (size_t)kq * L.lq;   // F
  L.vec = o; o += (size_t)kVecs * kq;
  L.red = o; o += 64;
  L.total = o * sizeof(float);
  return L;
}

// The per-row vectors, kQ floats each, at L.vec + k * kQ.
enum Vec { kDt, kAcum, kEa, kW, kEd, kDmd, kXgb, kZc, kRowE, kColF };

template <typename T>
struct Args {
  const T* x;
  const T* dt;
  const float* A;
  const float* D;
  const T* Bm;
  const T* Cm;
  const float* init;
  const T* dy;
  const float* dstate;
  float* states;
  T* dx;
  T* ddt;
  float* dBp;
  float* dCp;
  float* dAp;
  float* dDp;
  float* dinit;
  int S, H, P, G, N, kq;
  long long x_rs, dt_rs, b_rs, c_rs;
};

// out(r, c) = sum_{k < K} fa(r, k) fb(k, c) for every r < R, c < C, in k
// order; one output a thread at a time, c fastest across threads (so a
// warp reads fa(r, k) once, broadcast, and fb along a row).
template <class FA, class FB, class FO>
__device__ __forceinline__ void product(int R, int C, int K, FA fa, FB fb,
                                        FO fo) {
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(fa(r, k), fb(k, c), s);
    fo(r, c, s);
  }
}

// out[r] = sum_{k < K} f(r, k) for every r < R: a warp a row, lanes
// strided over k, summed by a fixed butterfly.
template <class F>
__device__ __forceinline__ void row_sums(int R, int K, F f, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += f(r, k);
    s = repro::warp_sum(s);
    if (lane == 0) out[r] = s;
  }
}

// Rows [c0, c0 + nq) of a (B, S, ...) operand, `width` elements from
// `src` (this block's head or group), as float32 rows of stride ld.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long rs, int c0, int nq,
                                      int width) {
  for (int e = threadIdx.x; e < nq * width; e += kThreads) {
    const int i = e / width, k = e - i * width;
    dst[i * ld + k] = repro::to_f32(src[(size_t)(c0 + i) * rs + k]);
  }
}

// Thread 0: a = cumsum(dt A) over the chunk's nq rows, e^a, e^{a_end - a}
// and w = e^{a_end - a} dt.  Returns a_end.
__device__ __forceinline__ float decays(float* v, int kq, int nq, float a_h) {
  float* dts = v + kDt * kq;
  float* acum = v + kAcum * kq;
  float s = 0.f;
  for (int i = 0; i < nq; ++i) {
    s += dts[i] * a_h;
    acum[i] = s;
  }
  for (int i = 0; i < nq; ++i) {
    const float ed = expf(s - acum[i]);
    v[kEa * kq + i] = expf(acum[i]);
    v[kEd * kq + i] = ed;
    v[kW * kq + i] = ed * dts[i];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunks(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.kq;
  const Layout L = layout(Q, P, N);
  const int lq = L.lq, lp = L.lp, ln = L.ln;
  float* hs = sm + L.h;
  float* gs = sm + L.g;
  float* xs = sm + L.xs;
  float* dys = sm + L.dys;
  float* gb = sm + L.gb;
  float* bs = sm + L.bs;
  float* cs = sm + L.cs;
  float* t1 = sm + L.t1;
  float* mb = sm + L.mb;
  float* wb = sm + L.wb;
  float* fb = sm + L.fb;
  float* v = sm + L.vec;
  float* red = sm + L.red;
  float* dts = v + kDt * Q;
  float* acum = v + kAcum * Q;
  float* ea = v + kEa * Q;
  float* wv = v + kW * Q;
  float* ed = v + kEd * Q;
  float* dmd = v + kDmd * Q;
  float* xgb = v + kXgb * Q;
  float* zc = v + kZc * Q;
  float* rowe = v + kRowE * Q;
  float* colf = v + kColF * Q;

  const int grp = h / (H / a.G);
  const float a_h = a.A[h], d_h = a.D[h];
  const T* xb = a.x + (size_t)b * S * a.x_rs + (size_t)h * P;
  const T* dtb = a.dt + (size_t)b * S * a.dt_rs + h;
  const T* bb = a.Bm + (size_t)b * S * a.b_rs + (size_t)grp * N;
  const T* cb = a.Cm + (size_t)b * S * a.c_rs + (size_t)grp * N;
  const long long y_rs = (long long)H * P;
  const T* dyb = a.dy + (size_t)b * S * y_rs + (size_t)h * P;
  const size_t soff = ((size_t)b * H + h) * P * N;
  const int nc = (S + Q - 1) / Q;
  float* stb = a.states + soff * nc;

  // Pass 1: the state entering each chunk.
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    hs[p * ln + n] = a.init ? a.init[soff + e] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q, nq = min(Q, S - c0);
    __syncthreads();  // the last update of hs done; staging buffers free
    float* out = stb + (size_t)c * P * N;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      out[e] = hs[p * ln + n];
    }
    if (c + 1 == nc) break;  // the last chunk's update is never read
    stage(xs, lp, xb, a.x_rs, c0, nq, P);
    stage(bs, ln, bb, a.b_rs, c0, nq, N);
    if (tid < nq) dts[tid] = repro::to_f32(dtb[(size_t)(c0 + tid) * a.dt_rs]);
    __syncthreads();
    if (tid == 0) red[0] = decays(v, Q, nq, a_h);
    __syncthreads();
    const float dec = expf(red[0]);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float s = 0.f;
      for (int j = 0; j < nq; ++j)
        s = fmaf(xs[j * lp + p] * wv[j], bs[j * ln + n], s);
      hs[p * ln + n] = fmaf(dec, hs[p * ln + n], s);
    }
  }

  // Pass 2: over chunks in reverse, carrying the state cotangent.
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    gs[p * ln + n] = a.dstate ? a.dstate[soff + e] : 0.f;
  }
  float dA_acc = 0.f, dD_acc = 0.f;  // thread 0's
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, nq = min(Q, S - c0);
    __syncthreads();  // the last chunk's g step done; buffers free
    stage(xs, lp, xb, a.x_rs, c0, nq, P);
    stage(dys, lp, dyb, y_rs, c0, nq, P);
    stage(bs, ln, bb, a.b_rs, c0, nq, N);
    stage(cs, ln, cb, a.c_rs, c0, nq, N);
    {
      const float* in = stb + (size_t)c * P * N;
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        hs[p * ln + n] = in[e];
      }
    }
    if (tid < nq) dts[tid] = repro::to_f32(dtb[(size_t)(c0 + tid) * a.dt_rs]);
    __syncthreads();
    if (tid == 0) red[32] = decays(v, Q, nq, a_h);
    // A. C B^T, dy x^T, g B and dy h.
    product(nq, nq, N, [&](int i, int n) { return cs[i * ln + n]; },
            [&](int n, int j) { return bs[j * ln + n]; },
            [&](int i, int j, float s) { mb[i * lq + j] = s; });
    product(nq, nq, P, [&](int i, int p) { return dys[i * lp + p]; },
            [&](int p, int j) { return xs[j * lp + p]; },
            [&](int i, int j, float s) { wb[i * lq + j] = s; });
    product(nq, P, N, [&](int j, int n) { return bs[j * ln + n]; },
            [&](int n, int p) { return gs[p * ln + n]; },
            [&](int j, int p, float s) { gb[j * lp + p] = s; });
    product(nq, N, P, [&](int i, int p) { return dys[i * lp + p]; },
            [&](int p, int n) { return hs[p * ln + n]; },
            [&](int i, int n, float s) { t1[i * ln + n] = s; });
    __syncthreads();
    const float a_end = red[32];
    // B. M, W and F; C_i . Z_i and x_j . gB_j.
    for (int e = tid; e < nq * nq; e += kThreads) {
      const int i = e / nq, j = e - i * nq;
      float m = 0.f, w = 0.f, f = 0.f;
      if (j <= i) {
        const float l = expf(acum[i] - acum[j]);
        const float cbv = mb[i * lq + j], dm = wb[i * lq + j];
        if (i == j) dmd[i] = dm;
        m = cbv * l * dts[j];
        w = dm * l * dts[j];
        f = dm * cbv * l;
      }
      mb[i * lq + j] = m;
      wb[i * lq + j] = w;
      fb[i * lq + j] = f;
    }
    row_sums(nq, N, [&](int i, int n) { return cs[i * ln + n] * t1[i * ln + n]; },
             zc);
    row_sums(nq, P, [&](int j, int p) { return xs[j * lp + p] * gb[j * lp + p]; },
             xgb);
    __syncthreads();
    // C. dx, dC, F's row and column sums, <g, h>.
    {
      T* dxo = a.dx + ((size_t)b * S + c0) * H * P + (size_t)h * P;
      product(nq, P, nq, [&](int j, int i) { return mb[i * lq + j]; },
              [&](int i, int p) { return dys[i * lp + p]; },
              [&](int j, int p, float s) {
                s = fmaf(d_h, dys[j * lp + p], s);
                s = fmaf(wv[j], gb[j * lp + p], s);
                dxo[(size_t)j * H * P + p] = repro::from_f32<T>(s);
              });
      float* dco = a.dCp + ((size_t)b * S + c0) * H * N + (size_t)h * N;
      product(nq, N, nq, [&](int i, int j) { return wb[i * lq + j]; },
              [&](int j, int n) { return bs[j * ln + n]; },
              [&](int i, int n, float s) {
                dco[(size_t)i * H * N + n] = fmaf(ea[i], t1[i * ln + n], s);
              });
    }
    row_sums(nq, nq, [&](int i, int j) { return fb[i * lq + j] * dts[j]; },
             rowe);
    row_sums(nq, nq, [&](int j, int i) { return fb[i * lq + j]; }, colf);
    {
      float s = 0.f;
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        s = fmaf(gs[p * ln + n], hs[p * ln + n], s);
      }
      s = repro::warp_sum(s);
      if ((tid & 31) == 0) red[tid >> 5] = s;
    }
    __syncthreads();
    // D. x^T g into t1 (Z is consumed); thread 0: d(a), ddt, dA and dD.
    product(nq, N, P, [&](int j, int p) { return xs[j * lp + p]; },
            [&](int p, int n) { return gs[p * ln + n]; },
            [&](int j, int n, float s) { t1[j * ln + n] = s; });
    if (tid == 0) {
      float gh = 0.f;
      for (int w = 0; w < kWarps; ++w) gh += red[w];
      float tot = 0.f;
      float* da = rowe;  // rowe[i] becomes d(a)_i in place
      for (int i = 0; i < nq; ++i) {
        const float u = wv[i] * xgb[i];
        da[i] = rowe[i] - dts[i] * colf[i] + ea[i] * zc[i] - u;
        tot += u;
      }
      da[nq - 1] += tot + expf(a_end) * gh;
      T* ddo = a.ddt + ((size_t)b * S + c0) * H + h;
      float r = 0.f;
      for (int m = nq - 1; m >= 0; --m) {
        r += da[m];
        const float g_dt = colf[m] + ed[m] * xgb[m] + a_h * r;
        ddo[(size_t)m * H] = repro::from_f32<T>(g_dt);
        dA_acc = fmaf(dts[m], r, dA_acc);
      }
      for (int i = 0; i < nq; ++i) dD_acc += dmd[i];
    }
    __syncthreads();
    // E. dB, and the state cotangent one chunk back.
    {
      float* dbo = a.dBp + ((size_t)b * S + c0) * H * N + (size_t)h * N;
      product(nq, N, nq, [&](int j, int i) { return wb[i * lq + j]; },
              [&](int i, int n) { return cs[i * ln + n]; },
              [&](int j, int n, float s) {
                dbo[(size_t)j * H * N + n] = fmaf(wv[j], t1[j * ln + n], s);
              });
    }
    const float dec = expf(a_end);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float s = 0.f;
      for (int i = 0; i < nq; ++i)
        s = fmaf(dys[i * lp + p] * ea[i], cs[i * ln + n], s);
      gs[p * ln + n] = fmaf(dec, gs[p * ln + n], s);
    }
  }
  __syncthreads();
  if (a.dinit) {
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      a.dinit[soff + e] = gs[p * ln + n];
    }
  }
  if (tid == 0) {
    a.dAp[(size_t)b * H + h] = dA_acc;
    a.dDp[(size_t)b * H + h] = dD_acc;
  }
}

// dB and dC: the per-head partials summed over the heads of each group, in
// head order, one block per (sequence, position) row; block 0 also sums dA
// and dD over the sequences, in order.
template <typename T>
__global__ void __launch_bounds__(128) ssd_bwd_reduce(
    const float* dBp, const float* dCp, const float* dAp, const float* dDp,
    T* dB, T* dC, float* dA, float* dD, int Bn, int H, int G, int N) {
  const size_t row = blockIdx.x;
  const int rep = H / G;
  for (int e = threadIdx.x; e < G * N; e += blockDim.x) {
    const int g = e / N, n = e - g * N;
    const float* pb = dBp + (row * H + (size_t)g * rep) * N + n;
    const float* pc = dCp + (row * H + (size_t)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += pb[(size_t)r * N];
      sc += pc[(size_t)r * N];
    }
    dB[row * G * N + e] = repro::from_f32<T>(sb);
    dC[row * G * N + e] = repro::from_f32<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int bb = 0; bb < Bn; ++bb) {
        sa += dAp[(size_t)bb * H + hh];
        sd += dDp[(size_t)bb * H + hh];
      }
      dA[hh] = sa;
      dD[hh] = sd;
    }
  }
}

template <typename T>
int launch(const Args<T>& a, int B, size_t smem, T* dB, T* dC, float* dA,
           float* dD, cudaStream_t st) {
  auto kernel = ssd_bwd_chunks<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.H, B), kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_reduce<T><<<(unsigned)((size_t)B * a.S), 128, 0, st>>>(
      a.dBp, a.dCp, a.dAp, a.dDp, dB, dC, dA, dD, B, a.H, a.G, a.N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N): element [b, s, ...]
// of each at row (b * S + s) times its row stride (in elements), the rest
// of the row contiguous.  A, D (H,) float32; init (B, H, P, N) float32 or
// null; dy (B, S, H, P) contiguous in x's type; dstate (B, H, P, N)
// float32 or null.  Scratch: states (B, H, chunks, P, N), dBp and dCp
// (B, S, H, N), dAp and dDp (B, H), all float32.  Outputs, contiguous: dx
// like x, ddt like dt, dB and dC (B, S, G, N) in x's type, dA and dD (H,)
// and dinit (B, H, P, N, or null) float32.  kq and smem are
// kernels/ssd_scan.py::ssd_bwd_plan's.  Returns the CUDA error of the
// launches; a shape or plan the kernel cannot take is
// cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* D,
    const void* Bm, const void* Cm, const void* init, const void* dy,
    const void* dstate, void* states, void* dx, void* ddt, void* dBp,
    void* dCp, void* dAp, void* dDp, void* dinit, void* dB, void* dC,
    void* dA, void* dD, int bf16, int B, int S, int H, int P, int G, int N,
    long long x_rs, long long dt_rs, long long b_rs, long long c_rs, int kq,
    long long smem, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G ||
      S < 1 || B < 1 || B > 65535 || H > 65535 ||
      (kq != 16 && kq != 32 && kq != 64) ||
      (size_t)smem != layout(kq, P, N).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                    static_cast<const float*>(A), static_cast<const float*>(D),
                    static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                    static_cast<const float*>(init), static_cast<const T*>(dy),
                    static_cast<const float*>(dstate),
                    static_cast<float*>(states), static_cast<T*>(dx),
                    static_cast<T*>(ddt), static_cast<float*>(dBp),
                    static_cast<float*>(dCp), static_cast<float*>(dAp),
                    static_cast<float*>(dDp), static_cast<float*>(dinit), S,
                    H, P, G, N, kq, x_rs, dt_rs, b_rs, c_rs};
    return launch<T>(a, B, (size_t)smem, static_cast<T*>(dB),
                     static_cast<T*>(dC), static_cast<float*>(dA),
                     static_cast<float*>(dD), st);
  }
  using T = float;
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(D),
                  static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                  static_cast<const float*>(init), static_cast<const T*>(dy),
                  static_cast<const float*>(dstate),
                  static_cast<float*>(states), static_cast<T*>(dx),
                  static_cast<T*>(ddt), static_cast<float*>(dBp),
                  static_cast<float*>(dCp), static_cast<float*>(dAp),
                  static_cast<float*>(dDp), static_cast<float*>(dinit), S, H,
                  P, G, N, kq, x_rs, dt_rs, b_rs, c_rs};
  return launch<T>(a, B, (size_t)smem, static_cast<T*>(dB),
                   static_cast<T*>(dC), static_cast<float*>(dA),
                   static_cast<float*>(dD), st);
}
