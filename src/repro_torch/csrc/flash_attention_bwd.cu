// flash_attention_bwd for Hopper: the gradients dQ, dK and dV of the
// prefill attention that flash_attention.cu computes, for (B, S, H, D)
// queries against (B, T, KV, D) keys and values, with GQA, a causal mask,
// a sliding window with an always-visible prefix, logit soft-capping and
// q_offset.  q and dO are float32 or bfloat16 (dQ in q's type), k and v
// float32 or bfloat16 (dK, dV in theirs); every sum is float32.
//
// The TPU kernel repro/kernels/flash_attention.py::flash_attention has no
// backward (the reference trains through inline jnp attention that XLA
// differentiates).  This is the port's own: the port's models run their
// attention through the forward kernel, so training on the card needs its
// gradient from a kernel too.
//
// What bounds it on the H100: the five products of the gradient (S = Q K^T
// and dP = dO V^T recomputed, dV += P^T dO, dK += dS^T Q, dQ += dS K), 2.5
// times the forward's operations over the visible (query, key) pairs.
// This first version runs them on the float32 units (the recomputation of
// S and dP happens in both passes, so it does seven), from float32 tiles in
// shared memory; the bf16 tensor cores (mma / wgmma) are a later step.
//
// Design: two kernels, launched in this order on one stream.
//   flash_bwd_q: one block per (tile of BIG query rows, head, sequence).
//     First Delta = rowsum(dO * O) of its rows, in float32, kept and
//     written out for the second kernel.  Then over the key tiles its rows
//     can see (the prefix before the window's range, then the range, as the
//     forward walks them) in tiles of SMALL keys: S and dP as register
//     tiles, then per element t = c tanh(s / c) under a softcap, P =
//     exp(t - lse) (the forward's log-sum-exp), dT = P (dP - Delta) and dS
//     = dT (1 - tanh^2) under a softcap; dS goes to shared memory key-major
//     and dQ += dS K accumulates in registers.  dQ is scaled once at the end.
//   flash_bwd_kv: one block per (tile of BIG keys, KV head, sequence).  It
//     walks, in a fixed order, the G query heads of its KV head and for each
//     the query rows that can see a key of its tile (p >= first key under
//     the causal mask; p <= last key + window - 1 under a window, unless the
//     tile holds a prefix key), SMALL rows a step: S and dP again, P and dS
//     to shared memory, then dV += P^T dO and dK += dS^T (q scale) in
//     registers.
// No float atomics: every sum runs in a fixed order, so a call is
// bit-identical run to run.  A masked (query, key) pair weighs exactly
// zero.  A row that sees no key at all (lse = -inf from the forward, where
// the forward answers the mean of v over all T) gets dQ = 0 and adds
// dO / T to the dV of every key, as the plain version's finite mask does;
// the wrapper says when a call can hold such a row (any_empty), and only
// then does a dK/dV block sum those rows' dO.
//
// Tiles (D padded to DP, columns past D zero): DP = 64: BIG = SMALL = 64;
// DP = 128: BIG 64, SMALL 32; DP = 256: BIG = SMALL = 32.  kernels/
// flash_attention.py::flash_bwd_plan mirrors the shared bytes, and the
// launcher refuses a plan that disagrees.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int DP>
__host__ __device__ constexpr int big_of() { return DP == 256 ? 32 : 64; }
template <int DP>
__host__ __device__ constexpr int small_of() { return DP == 64 ? 64 : 32; }

struct Layout {
  int ld, ldp;  // row strides (floats): tiles of D columns; P and dS
  size_t a, b, c, d, p, ds, lse, delta, u, total;
};

// a, b: [BIG][ld] (the dK/dV kernel's K and V; the dQ kernel's q and dO);
// c, d: [SMALL][ld] (q and dO; K and V); p, ds: [SMALL][ldp] (P and dS by
// query row; dS by key); lse, delta: [BIG]; u: [DP] (the empty rows' dO).
__host__ __device__ inline Layout layout(int dp) {
  const int big = dp == 256 ? 32 : 64, small = dp == 64 ? 64 : 32;
  Layout L;
  L.ld = dp + 4;
  L.ldp = big + 4;
  size_t o = 0;
  L.a = o;     o += sizeof(float) * big * L.ld;
  L.b = o;     o += sizeof(float) * big * L.ld;
  L.c = o;     o += sizeof(float) * small * L.ld;
  L.d = o;     o += sizeof(float) * small * L.ld;
  L.p = o;     o += sizeof(float) * small * L.ldp;
  L.ds = o;    o += sizeof(float) * small * L.ldp;
  L.lse = o;   o += sizeof(float) * big;
  L.delta = o; o += sizeof(float) * big;
  L.u = o;     o += sizeof(float) * dp;
  L.total = o;
  return L;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int q_bf16, kv_bf16, S, T, H, KV, D;
  float scale;
  int causal, window;
  float softcap;
  int prefix, q_offset, any_empty;
};

__device__ __forceinline__ float ldf(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void stf(void* p, size_t i, int bf16, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float a, float4 x, float4 b) {
  a = fmaf(x.x, b.x, a);
  a = fmaf(x.y, b.y, a);
  a = fmaf(x.z, b.z, a);
  return fmaf(x.w, b.w, a);
}

// rows [0, nrows) of a tile as float32 in shared memory (row stride ld):
// row r is src[r * stride + d] times mul, zero past `valid` rows and past
// D columns.
template <int DP>
__device__ void load_rows(float* dst, int ld, const void* src, size_t base,
                          size_t stride, int valid, int nrows, int D,
                          int bf16, float mul) {
  for (int e = threadIdx.x; e < nrows * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    float x = 0.f;
    if (r < valid && d < D) x = ldf(src, base + r * stride + d, bf16) * mul;
    dst[r * ld + d] = x;
  }
}

// s[i][j] = sum_d X[row i][d] Y[key j][d] over DP columns, for this
// thread's rows mr + (kThreads / NKP) i and keys nc + NKP j, four columns
// a load.
template <int TM, int NKP, int DP>
__device__ __forceinline__ void dot_tile(float (&s)[TM][4], const float* X,
                                         const float* Y, int ld, int mr,
                                         int nc) {
  constexpr int MSTEP = kThreads / NKP;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[TM], y[4];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = ld4(X + (mr + MSTEP * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(Y + (nc + NKP * j) * ld + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(s[i][j], x[i], y[j]);
  }
}

// acc[i][4 u + c] += sum_r A[r][i0 + i] Bm[r][4 (cg + NCG u) + c] over R
// rows r: four output rows i0.. and NC4 groups of four columns a thread.
template <int NC4, int NCG>
__device__ __forceinline__ void outer_acc(float (&acc)[4][4 * NC4],
                                          const float* A, int lda, int i0,
                                          const float* Bm, int ldb, int cg,
                                          int R) {
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    const float4 a = ld4(A + r * lda + i0);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < NC4; ++u) {
      const float4 b = ld4(Bm + r * ldb + 4 * (cg + NCG * u));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * u] = fmaf(av[i], b.x, acc[i][4 * u]);
        acc[i][4 * u + 1] = fmaf(av[i], b.y, acc[i][4 * u + 1]);
        acc[i][4 * u + 2] = fmaf(av[i], b.z, acc[i][4 * u + 2]);
        acc[i][4 * u + 3] = fmaf(av[i], b.w, acc[i][4 * u + 3]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(const Args& a, int p, int t) {
  bool ok = !a.causal || t <= p;
  if (a.window) ok = ok && (t > p - a.window || t < a.prefix);
  return ok;
}

// dS of one (query, key) pair from its raw score s (q scale . k), dP and
// the row's lse and Delta; P through *pout.  Zero where masked, and in a
// row that saw nothing (lse = -inf).
__device__ __forceinline__ float grad_score(const Args& a, bool ok, float s,
                                            float dp, float lse, float delta,
                                            float* pout) {
  if (!ok || lse == -INFINITY) {
    *pout = 0.f;
    return 0.f;
  }
  float th = 0.f, t = s;
  if (a.softcap != 0.f) {
    th = tanhf(s / a.softcap);
    t = th * a.softcap;
  }
  const float p = expf(t - lse);
  *pout = p;
  float ds = p * (dp - delta);
  if (a.softcap != 0.f) ds *= 1.f - th * th;
  return ds;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q(const Args a) {
  constexpr int BIG = big_of<DP>(), SMALL = small_of<DP>();
  constexpr int TM = BIG * SMALL / 1024, NKP = SMALL / 4;
  constexpr int MSTEP = kThreads / NKP;
  constexpr int NIG = BIG / 4, NCG = kThreads / NIG, NC4 = DP / 4 / NCG;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(DP);
  float* qs = reinterpret_cast<float*>(smem + L.a);
  float* dos = reinterpret_cast<float*>(smem + L.b);
  float* ks = reinterpret_cast<float*>(smem + L.c);
  float* vs = reinterpret_cast<float*>(smem + L.d);
  float* dst = reinterpret_cast<float*>(smem + L.ds);  // [key][row]
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BIG, h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, kvh = h / G, D = a.D, ld = L.ld, ldp = L.ldp;
  const int nrows = min(BIG, a.S - r0);
  const size_t qbase = ((size_t)b * a.S + r0) * a.H * D + (size_t)h * D;
  const size_t qstride = (size_t)a.H * D;
  load_rows<DP>(qs, ld, a.q, qbase, qstride, nrows, BIG, D, a.q_bf16,
                a.scale);
  load_rows<DP>(dos, ld, a.dout, qbase, qstride, nrows, BIG, D, a.q_bf16,
                1.f);
  __syncthreads();
  // Delta of each row, one warp a row, in a fixed order.
  for (int m = warp; m < BIG; m += kThreads / 32) {
    float sum = 0.f;
    if (m < nrows)
      for (int d = lane; d < D; d += 32)
        sum = fmaf(dos[m * ld + d], ldf(a.o, qbase + m * qstride + d,
                                        a.q_bf16), sum);
    sum = repro::warp_sum(sum);
    if (lane == 0) {
      delta_s[m] = sum;
      const size_t row = ((size_t)b * a.H + h) * a.S + r0 + m;
      lse_s[m] = m < nrows ? a.lse[row] : -INFINITY;
      if (m < nrows) a.delta[row] = sum;
    }
  }

  // The keys the rows can see, as the forward walks them.
  const int last = a.q_offset + r0 + nrows - 1;
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window ? max(0, a.q_offset + r0 - a.window + 1) : 0;
  const int a_end = a.window ? min(min(a.prefix, lo), hi) : 0;
  const int n_a = (a_end + SMALL - 1) / SMALL;
  const int n_b = hi > lo ? (hi - lo + SMALL - 1) / SMALL : 0;
  const size_t kbase = (size_t)b * a.T * a.KV * D + (size_t)kvh * D;
  const size_t kstride = (size_t)a.KV * D;
  const int nc = tid % NKP, mr = tid / NKP;
  const int ig = tid % NIG, cg = tid / NIG;
  float dq[4][4 * NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC4; ++j) dq[i][j] = 0.f;

  for (int it = 0; it < n_a + n_b; ++it) {
    int t0, t1;
    if (it < n_a) {
      t0 = it * SMALL;
      t1 = min(t0 + SMALL, a_end);
    } else {
      t0 = lo + (it - n_a) * SMALL;
      t1 = min(t0 + SMALL, hi);
    }
    __syncthreads();  // the last tile's K and dS consumed
    load_rows<DP>(ks, ld, a.k, kbase + t0 * kstride, kstride, t1 - t0,
                  SMALL, D, a.kv_bf16, 1.f);
    load_rows<DP>(vs, ld, a.v, kbase + t0 * kstride, kstride, t1 - t0,
                  SMALL, D, a.kv_bf16, 1.f);
    __syncthreads();
    float sc[TM][4], dpv[TM][4];
    dot_tile<TM, NKP, DP>(sc, qs, ks, ld, mr, nc);
    dot_tile<TM, NKP, DP>(dpv, dos, vs, ld, mr, nc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = mr + MSTEP * i, p = a.q_offset + r0 + m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + NKP * j, t = t0 + n;
        const bool ok = m < nrows && t < t1 && visible(a, p, t);
        float pr;
        dst[n * ldp + m] = grad_score(a, ok, sc[i][j], dpv[i][j], lse_s[m],
                                      delta_s[m], &pr);
      }
    }
    __syncthreads();
    outer_acc<NC4, NCG>(dq, dst, ldp, 4 * ig, ks, ld, cg, SMALL);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * ig + i;
    if (m >= nrows) continue;
#pragma unroll
    for (int u = 0; u < NC4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (cg + NCG * u) + c;
        if (d < D)
          stf(a.dq, qbase + m * qstride + d, a.q_bf16,
              dq[i][4 * u + c] * a.scale);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv(const Args a) {
  constexpr int BIG = big_of<DP>(), SMALL = small_of<DP>();
  constexpr int TM = BIG * SMALL / 1024, NKP = BIG / 4;
  constexpr int MSTEP = kThreads / NKP;
  constexpr int NIG = BIG / 4, NCG = kThreads / NIG, NC4 = DP / 4 / NCG;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(DP);
  float* ks = reinterpret_cast<float*>(smem + L.a);
  float* vs = reinterpret_cast<float*>(smem + L.b);
  float* qs = reinterpret_cast<float*>(smem + L.c);
  float* dos = reinterpret_cast<float*>(smem + L.d);
  float* ps = reinterpret_cast<float*>(smem + L.p);  // [row][key]
  float* dss = reinterpret_cast<float*>(smem + L.ds);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  float* u_s = reinterpret_cast<float*>(smem + L.u);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BIG, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, D = a.D, ld = L.ld, ldp = L.ldp;
  const int n1 = min(a.T, n0 + BIG);
  const size_t kbase = ((size_t)b * a.T + n0) * a.KV * D + (size_t)kvh * D;
  const size_t kstride = (size_t)a.KV * D;
  load_rows<DP>(ks, ld, a.k, kbase, kstride, n1 - n0, BIG, D, a.kv_bf16,
                1.f);
  load_rows<DP>(vs, ld, a.v, kbase, kstride, n1 - n0, BIG, D, a.kv_bf16,
                1.f);

  // The rows that can see a key of [n0, n1).
  const long long p_lo = a.causal ? n0 : 0;
  const long long p_hi = (a.window && n0 >= a.prefix)
                             ? (long long)n1 - 2 + a.window
                             : (long long)a.q_offset + a.S;
  const int r_lo = (int)max(0LL, p_lo - a.q_offset);
  const int r_end = (int)min((long long)a.S, p_hi - a.q_offset + 1);
  const size_t qstride = (size_t)a.H * D;
  const int nc = tid % NKP, mr = tid / NKP;
  const int ig = tid % NIG, cg = tid / NIG;
  float dk[4][4 * NC4], dv[4][4 * NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int r0 = r_lo; r0 < r_end; r0 += SMALL) {
      const int nrows = min(SMALL, a.S - r0);
      const size_t qbase = ((size_t)b * a.S + r0) * a.H * D + (size_t)h * D;
      __syncthreads();  // the last step's q, dO, P and dS consumed
      load_rows<DP>(qs, ld, a.q, qbase, qstride, nrows, SMALL, D, a.q_bf16,
                    a.scale);
      load_rows<DP>(dos, ld, a.dout, qbase, qstride, nrows, SMALL, D,
                    a.q_bf16, 1.f);
      if (tid < SMALL) {
        const size_t row = ((size_t)b * a.H + h) * a.S + r0 + tid;
        lse_s[tid] = tid < nrows ? a.lse[row] : -INFINITY;
        delta_s[tid] = tid < nrows ? a.delta[row] : 0.f;
      }
      __syncthreads();
      float sc[TM][4], dpv[TM][4];
      dot_tile<TM, NKP, DP>(sc, qs, ks, ld, mr, nc);
      dot_tile<TM, NKP, DP>(dpv, dos, vs, ld, mr, nc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = mr + MSTEP * i, p = a.q_offset + r0 + m;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nc + NKP * j, t = n0 + n;
          const bool ok = m < nrows && t < n1 && visible(a, p, t);
          float pr;
          dss[m * ldp + n] = grad_score(a, ok, sc[i][j], dpv[i][j],
                                        lse_s[m], delta_s[m], &pr);
          ps[m * ldp + n] = pr;
        }
      }
      __syncthreads();
      outer_acc<NC4, NCG>(dv, ps, ldp, 4 * ig, dos, ld, cg, SMALL);
      outer_acc<NC4, NCG>(dk, dss, ldp, 4 * ig, qs, ld, cg, SMALL);
    }
  }

  if (a.any_empty) {  // rows that saw nothing: dO / T to every key's dV
    for (int d = tid; d < DP; d += kThreads) {
      float sum = 0.f;
      if (d < D)
        for (int g = 0; g < G; ++g) {
          const int h = kvh * G + g;
          for (int r = 0; r < a.S; ++r)
            if (a.lse[((size_t)b * a.H + h) * a.S + r] == -INFINITY)
              sum += ldf(a.dout, ((size_t)b * a.S + r) * qstride +
                                     (size_t)h * D + d, a.q_bf16);
        }
      u_s[d] = sum / (float)a.T;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < NC4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dv[i][4 * u + c] += u_s[4 * (cg + NCG * u) + c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * ig + i;
    if (n0 + n >= n1) continue;
#pragma unroll
    for (int u = 0; u < NC4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (cg + NCG * u) + c;
        if (d >= D) continue;
        const size_t off = kbase + n * kstride + d;
        stf(a.dk, off, a.kv_bf16, dk[i][4 * u + c]);
        stf(a.dv, off, a.kv_bf16, dv[i][4 * u + c]);
      }
  }
}

__host__ int allow_smem(const void* kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

template <int DP>
int launch(const Args& a, int B, size_t smem, cudaStream_t st) {
  constexpr int BIG = big_of<DP>();
  int e = allow_smem((const void*)flash_bwd_q<DP>, smem);
  if (e == 0) e = allow_smem((const void*)flash_bwd_kv<DP>, smem);
  if (e != 0) return e;
  flash_bwd_q<DP><<<dim3((a.S + BIG - 1) / BIG, a.H, B), kThreads, smem,
                    st>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_kv<DP><<<dim3((a.T + BIG - 1) / BIG, a.KV, B), kThreads, smem,
                     st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, D) in q's type; k, v, dk, dv: (B, T, KV, D) in
// k's type; lse (B, H, S) float32 from the forward (-inf: a row that saw no
// key); delta (B, H, S) float32 scratch, written by the first kernel; all
// contiguous.  dp and smem are kernels/flash_attention.py::flash_bwd_plan's.
// Returns the CUDA error of the launches; a shape or plan the kernels
// cannot take is cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int q_bf16, int kv_bf16, int B, int S, int T, int H, int KV,
    int D, float scale, int causal, int window, float softcap, int prefix,
    int q_offset, int any_empty, int dp, long long smem, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV || D < 1 || D > dp ||
      q_offset < 0 || window < 0 || B > 65535 || H > 65535 ||
      (dp != 64 && dp != 128 && dp != 256) || (dp > 64 && D <= dp / 2) ||
      (size_t)smem != layout(dp).total)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, q_bf16, kv_bf16, S,
               T, H, KV, D, scale, causal, window, softcap, prefix, q_offset,
               any_empty};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 64) return launch<64>(a, B, (size_t)smem, st);
  if (dp == 128) return launch<128>(a, B, (size_t)smem, st);
  return launch<256>(a, B, (size_t)smem, st);
}
