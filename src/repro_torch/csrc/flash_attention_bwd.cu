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
// Both passes recompute S and dP, so the kernels run seven products: at
// best 5/7 of the bound.  The launcher routes by the operands' types:
//
// * q, k and v all bfloat16 (every training call): the tensor-core path.
//   Every product is mma.sync.m16n8k16 bf16 -> f32, its operands read from
//   shared memory by ldmatrix (.trans for the operand read transposed).
//   The softmax scale multiplies the f32 score accumulator (folded into
//   the exponent); P and dS are rounded to bf16 for the products that take
//   them, as FlashAttention does.  The element-wise step (mask, cap, exp,
//   dS) runs on the f32 accumulators in registers, with exp2 and a tanh
//   built from it on the MUFU; a tile whose pairs are all visible skips
//   the mask.  What bounds this path on the card: not the tensor cores
//   but the ldmatrix bytes (a warp's 16 rows reload the streamed tile's
//   fragments for each product), the element-wise step between the
//   products, and the few warps an SM holds at these register counts.
// * any float32 operand: the CUDA-core path, f32 tiles in shared memory
//   (dot_tile / outer_acc below), unchanged since it was written, whose
//   3e-5 tolerance bf16 or TF32 products would miss.
//
// Design, both paths: two kernels, launched in this order on one stream.
//   dQ kernel: one block per (tile of query rows, head, sequence).  First
//     Delta = rowsum(dO * O) of its rows, in float32, kept and written out
//     for the second kernel.  Then over the key tiles its rows can see (the
//     prefix before the window's range, then the range, as the forward
//     walks them): S and dP, then per element t = c tanh(s / c) under a
//     softcap, P = exp(t - lse) (the forward's log-sum-exp), dT = P (dP -
//     Delta) and dS = dT (1 - tanh^2) under a softcap; dQ += dS K.
//   dK/dV kernel: one block per (tile of keys, KV head, sequence).  It
//     walks, in a fixed order, the query heads of its KV head and for each
//     the query rows that can see a key of its tile (p >= first key under
//     the causal mask; p <= last key + window - 1 under a window, unless
//     the tile holds a prefix key), a tile of rows a step: S^T = K (q)^T
//     and dP^T = V dO^T, then dV += P^T dO and dK += dS^T q.
//
// The bf16 path's kernels (flash_bwd16_q, flash_bwd16_kv): each warp owns
// 16 rows of the block's own tile (query rows in the dQ kernel, keys in
// the dK/dV kernel); the own tile sits in shared memory for the whole
// block, and the streamed tiles (K and V, or q, dO, lse and Delta) come by
// 16-byte cp.async into a two-stage ring, the next tile in flight while
// this one computes.  A warp takes its share of a streamed tile 32 rows at
// a time (S, dP, the element-wise step, then the products that take P and
// dS), which keeps the D = 64 kernels within three blocks an SM without
// spilling.  The dK/dV kernel computes S^T and dP^T directly, so P^T and
// dS^T, rounded in registers, are already the A fragments of dV += P^T dO
// and dK += dS^T q (FlashAttention-2's register reuse); the dQ kernel
// reuses dS the same way.  Where a warp cannot hold its rows'
// accumulators across all D columns (D > 64), CW warps share 16 rows:
// each takes 1/CW of the streamed tile's rows for S and dP and 1/CW of
// the columns for the accumulators, and P and dS pass through shared
// memory as bf16.  Where the dK/dV grid would not give the card four
// blocks an SM (tinyllama's 256 key tiles, hymba's 170, gemma2's 264),
// the query heads of a KV head are split over a cluster of `hs` blocks
// (the smallest divisor of G, at most 8, that reaches it, else the
// largest); each sums its heads, and after a cluster barrier each block
// sums its share of the keys over the cluster's blocks in rank order,
// through distributed shared memory.  The grids run the heaviest tiles
// first under a causal mask.
//
//   D padded to  | own rows RO | streamed rows RT | CW | threads | shared
//   64 (D <= 64) |     64      |       64         |  1 |   128   |  56576 B
//   128          |     64      |       32         |  2 |   256   |  80896 B
//   256          |     64      |       64         |  2 |   256   | 223232 B
//
// The f32 path's tiles (D padded the same way): BIG (own rows) = SMALL
// (streamed rows) = 64 at D <= 64; 64 and 32 at D <= 128; 32 and 32 at
// D = 256; 256 threads; every operand converted to f32 on its way to
// shared memory, the scale applied to q there.
//
// No float atomics, on either path: every sum runs in a fixed order, so a
// call is bit-identical run to run.  A masked (query, key) pair weighs
// exactly zero.  A row that sees no key at all (lse = -inf from the
// forward, where the forward answers the mean of v over all T) gets dQ = 0
// and adds dO / T to the dV of every key, as the plain version's finite
// mask does; the wrapper says when a call can hold such a row (any_empty),
// and only then does a dK/dV block sum those rows' dO.  Columns past D and
// rows past S or T are zeros in shared memory.
//
// kernels/flash_attention.py::flash_bwd_plan mirrors the tiles, the shared
// bytes and the head split, and the launcher refuses a plan whose shared
// bytes disagree with the layout here.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// The f32 path: CUDA cores.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The bf16 path: tensor cores.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// Own rows a block (RO), streamed rows a tile (RT), warps sharing 16 rows
// by columns (CW), by D padded.
template <int DP>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int RO = 64, RT = 64, CW = 1;
};
template <>
struct Tiles<128> {
  static constexpr int RO = 64, RT = 32, CW = 2;
};
template <>
struct Tiles<256> {
  static constexpr int RO = 64, RT = 64, CW = 2;
};
template <int DP>
__host__ __device__ constexpr int threads16() {
  return 32 * (Tiles<DP>::RO / 16) * Tiles<DP>::CW;
}

struct Layout16 {
  int ldt, ldp, ldr;  // row strides: bf16 tiles; P and dS (bf16); sums (f32)
  size_t own, oth, ps, rows, u, total;
};

// own: 2 x [RO][ldt] bf16 (q and dO; K and V); oth: 2 stages x 2 x
// [RT][ldt] bf16 (K and V; q and dO); ps: 2 x [RO][ldp] bf16 (P and dS by
// own row; CW > 1 only); rows: the dQ kernel's lse and Delta [RO] each, or
// the dK/dV kernel's 2 stages x (lse, Delta) [RT]; u: [DP] f32 (the empty
// rows' dO).  After its loop a split dK/dV block writes its f32 sums, 2 x
// [RO][ldr], from offset 0 (over own and oth).
__host__ __device__ inline Layout16 layout16(int dp) {
  const int ro = dp == 64 ? Tiles<64>::RO
                 : dp == 128 ? Tiles<128>::RO : Tiles<256>::RO;
  const int rt = dp == 64 ? Tiles<64>::RT
                 : dp == 128 ? Tiles<128>::RT : Tiles<256>::RT;
  const int cw = dp == 64 ? Tiles<64>::CW
                 : dp == 128 ? Tiles<128>::CW : Tiles<256>::CW;
  Layout16 L;
  L.ldt = dp + 8;
  L.ldp = rt + 8;
  L.ldr = dp + 8;
  size_t o = 0;
  L.own = o;  o += sizeof(bf16) * 2 * ro * L.ldt;
  L.oth = o;  o += sizeof(bf16) * 2 * 2 * rt * L.ldt;
  L.ps = o;   if (cw > 1) o += sizeof(bf16) * 2 * ro * L.ldp;
  L.rows = o; o += sizeof(float) * (4 * rt > 2 * ro ? 4 * rt : 2 * ro);
  L.u = o;    o += sizeof(float) * dp;
  const size_t red = sizeof(float) * 2 * ro * L.ldr;
  L.total = o > red ? o : red;
  return L;
}

// The dK/dV kernel's head split: the smallest divisor of G (at most 8, a
// portable cluster) whose grid of `blocks` x hs reaches four blocks an SM,
// else the largest.
__host__ inline int head_split(int G, long long blocks, int sms) {
  int hs = 1;
  for (int d = 1; d <= G && d <= 8; ++d) {
    if (G % d) continue;
    hs = d;
    if (blocks * d >= 4LL * sms) break;
  }
  return hs;
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sptr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sptr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8 x 8 bf16 matrices from the shared address p (as a 32-bit shared
// window address: fewer registers than generic pointers), plain or
// transposed.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats as one bf16 pair, lo in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [0, nrows) of a bf16 tile into shared memory (row stride ldt): row
// r is src[base + r * stride ..], zero past `valid` rows and past D
// columns; by 16-byte cp.async where vec (D % 8 == 0 and 16-byte aligned
// pointers), else element by element.
template <int DP, int NT>
__device__ __forceinline__ void stage(bf16* dst, int ldt, const bf16* src,
                                      size_t base, size_t stride, int valid,
                                      int nrows, int D, int vec) {
  constexpr int CH = DP / 8;
  for (int e = threadIdx.x; e < nrows * CH; e += NT) {
    const int r = e / CH, c = (e - r * CH) * 8;
    bf16* d = dst + r * ldt + c;
    if (vec) {
      const bool ok = r < valid && c < D;
      cp16(d, ok ? src + base + r * stride + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = r < valid && c + j < D ? src[base + r * stride + c + j]
                                      : __float2bfloat16(0.f);
    }
  }
}

// The bf16 tiles below are shared addresses (uint32_t); rows are ldt
// elements apart.
// acc[j] (j < NS / 8) = X[16 own rows] . Y[NS streamed rows from yr]^T over
// DP columns: X's A fragments by ldmatrix, Y read as the col operand.
template <int DP, int NS>
__device__ __forceinline__ void scores(float (&acc)[NS / 8][4], uint32_t X,
                                       uint32_t Y, int ldt, int yr,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t xa = X + 2 * ((lane & 15) * ldt + (lane >> 4) * 8);
  const uint32_t yb = Y + 2 * ((yr + (lane & 7) + ((lane >> 4) << 3)) * ldt +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, xa + 32 * kk);
#pragma unroll
    for (int j = 0; j < NS / 16; ++j) {
      uint32_t b[4];
      ldsm(b, yb + 2 * (16 * j * ldt + kk * 16));
      mma(acc[2 * j], a, b[0], b[1]);
      mma(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (j < NC / 8) += A (16 rows x 16, fragments a) . Y[16 rows from
// Y][NC columns from c0], Y read transposed (rows are the sum's index).
template <int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[NC / 8][4],
                                         const uint32_t (&a)[4], uint32_t Y,
                                         int ldt, int c0, int lane) {
  const uint32_t yb = Y + 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * ldt +
                               c0 + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < NC / 16; ++j) {
    uint32_t b[4];
    ldsm_t(b, yb + 32 * j);
    mma(acc[2 * j], a, b[0], b[1]);
    mma(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// acc += A . Y over RT streamed rows, A the bf16 rounding of c, a warp's
// own f32 (16 x RT) tile in mma's accumulator layout, which is the A
// fragment's layout: no shared memory between the two products.
template <int RT, int NC>
__device__ __forceinline__ void accum_regs(float (&acc)[NC / 8][4],
                                           const float (&c)[RT / 8][4],
                                           uint32_t Y, int ldt, int c0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < RT / 16; ++kk) {
    const uint32_t a[4] = {pack(c[2 * kk][0], c[2 * kk][1]),
                           pack(c[2 * kk][2], c[2 * kk][3]),
                           pack(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack(c[2 * kk + 1][2], c[2 * kk + 1][3])};
    mma_rows<NC>(acc, a, Y + 32 * kk * ldt, ldt, c0, lane);
  }
}

// acc += A . Y over RT streamed rows, A a bf16 (16 x RT) tile in shared
// memory (row stride ldp).
template <int RT, int NC>
__device__ __forceinline__ void accum_smem(float (&acc)[NC / 8][4],
                                           uint32_t A, int ldp, uint32_t Y,
                                           int ldt, int c0, int lane) {
  const uint32_t aa = A + 2 * ((lane & 15) * ldp + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < RT / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, aa + 32 * kk);
    mma_rows<NC>(acc, a, Y + 32 * kk * ldt, ldt, c0, lane);
  }
}

// A warp's (16 x NS) f32 tile c as bf16 into shared memory at P (its row
// 0, column 0; row stride ldp).
template <int NS>
__device__ __forceinline__ void put_tile(bf16* P, int ldp,
                                         const float (&c)[NS / 8][4],
                                         int lane) {
  bf16* p = P + (lane >> 2) * ldp + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
    *reinterpret_cast<uint32_t*>(p + 8 * j) = pack(c[j][0], c[j][1]);
    *reinterpret_cast<uint32_t*>(p + 8 * ldp + 8 * j) =
        pack(c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The element-wise step's constants: sl2 = scale log2(e); under a softcap
// c, c2 = 2 log2(e) scale / c and cl2 = c log2(e).
struct Ew {
  float sl2, c2, cl2;
};
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ Ew ew_of(const Args& a) {
  Ew w;
  w.sl2 = a.scale * kLog2e;
  w.c2 = a.softcap != 0.f ? 2.f * kLog2e * a.scale / a.softcap : 0.f;
  w.cl2 = a.softcap * kLog2e;
  return w;
}

// One visible pair: s (the raw score q . k) becomes P = exp(t - lse) and
// dp becomes dS = P (dP - Delta), times 1 - tanh^2 under a softcap, where
// t = c tanh(s scale / c) (or s scale); lse2 = lse log2(e).  tanh is 1 -
// 2 / (e^2x + 1) from exp2 (1 at e^2x = inf, -1 at 0), near 1e-7 of it;
// every exponential is the MUFU's exp2.
template <bool CAP>
__device__ __forceinline__ void grad_pair(const Ew& w, float& s, float& dp,
                                          float lse2, float delta) {
  if (CAP) {
    const float th = fmaf(-2.f, rcp(ex2(s * w.c2) + 1.f), 1.f);
    const float p = ex2(fmaf(th, w.cl2, -lse2));
    dp = p * (dp - delta) * fmaf(-th, th, 1.f);
    s = p;
  } else {
    const float p = ex2(fmaf(s, w.sl2, -lse2));
    dp = p * (dp - delta);
    s = p;
  }
}

// A tile in which every (query, key) pair is visible: own rows [o0, o0 +
// no) against streamed rows [t0, t0 + nt), all in range (queries and keys
// as `keys_own` says).  Such a tile needs no mask, and no row of it has
// lse = -inf.
__device__ __forceinline__ bool all_visible(const Args& a, bool keys_own,
                                            int o0, int no, int t0, int nt,
                                            bool in_range) {
  const int p0 = a.q_offset + (keys_own ? t0 : o0);  // first query
  const int p1 = p0 + (keys_own ? nt : no) - 1;      // last query
  const int k0 = keys_own ? o0 : t0, k1 = k0 + (keys_own ? no : nt) - 1;
  return in_range && (!a.causal || k1 <= p0) &&
         (!a.window || k1 < a.prefix || k0 > p1 - a.window);
}

// P and dS of a warp's (16 x NS) tile in place: sc (raw scores) becomes P
// and dp becomes dS.  Own rows r (this thread's: row0 and row0 + 8) and
// streamed rows c0 + 8 j + 2 t4 + {0, 1} of the tile; query and key of
// each pair by `keys_own`; lse2 and delta of a pair's query through
// `row_of(own, col, lse2, delta)`.  Under `full` no pair is masked.
template <int NS, bool CAP, typename RowOf>
__device__ __forceinline__ void grad_tile(const Args& a, const Ew& w,
                                          float (&sc)[NS / 8][4],
                                          float (&dp)[NS / 8][4], bool full,
                                          bool keys_own, int ob, int row0,
                                          int nown, int tb, int c0,
                                          int nstr, int t4, RowOf row_of) {
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e >> 1), c = c0 + 8 * j + 2 * t4 + (e & 1);
      float lse2, delta;
      row_of(r, c, lse2, delta);
      bool ok = full;
      if (!full) {
        const int p = a.q_offset + (keys_own ? tb + c : ob + r);
        const int t = keys_own ? ob + r : tb + c;
        ok = r < nown && c < nstr && lse2 != -INFINITY && visible(a, p, t);
      }
      if (ok) {
        grad_pair<CAP>(w, sc[j][e], dp[j][e], lse2, delta);
      } else {
        sc[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
}

template <int DP>
__global__ void __launch_bounds__(threads16<DP>())
flash_bwd16_q(const Args a, const int vec) {
  constexpr int RO = Tiles<DP>::RO, RT = Tiles<DP>::RT, CW = Tiles<DP>::CW;
  constexpr int NT = threads16<DP>(), NS = RT / CW, NC = DP / CW;
  constexpr int NSC = NS < 32 ? NS : 32;  // streamed rows a score chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout16 L = layout16(DP);
  const int ldt = L.ldt, ldp = L.ldp;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.own);
  bf16* dos = qs + RO * ldt;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.oth);  // stage: K, then V
  bf16* dss = reinterpret_cast<bf16*>(smem + L.ps);
  float* lse_s = reinterpret_cast<float*>(smem + L.rows);
  float* delta_s = lse_s + RO;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* o = static_cast<const bf16*>(a.o);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / CW, wc = warp % CW, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * RO, G = a.H / a.KV, kvh = h / G, D = a.D;
  const int nrows = min(RO, a.S - r0);
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.KV * D;
  const size_t qbase = ((size_t)b * a.S + r0) * qstride + (size_t)h * D;
  const size_t kbase = (size_t)b * a.T * kstride + (size_t)kvh * D;
  stage<DP, NT>(qs, ldt, q, qbase, qstride, nrows, RO, D, vec);
  stage<DP, NT>(dos, ldt, dout, qbase, qstride, nrows, RO, D, vec);
  cp_commit();

  // The keys the rows can see, as the forward walks them.
  const int last = a.q_offset + r0 + nrows - 1;
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window ? max(0, a.q_offset + r0 - a.window + 1) : 0;
  const int a_end = a.window ? min(min(a.prefix, lo), hi) : 0;
  const int n_a = (a_end + RT - 1) / RT;
  const int n_b = hi > lo ? (hi - lo + RT - 1) / RT : 0;
  const int nt = n_a + n_b;
  auto range = [&](int it, int& t0, int& t1) {
    if (it < n_a) {
      t0 = it * RT;
      t1 = min(t0 + RT, a_end);
    } else {
      t0 = lo + (it - n_a) * RT;
      t1 = min(t0 + RT, hi);
    }
  };
  auto issue = [&](int it) {
    int t0, t1;
    range(it, t0, t1);
    bf16* ks = ring + (it & 1) * 2 * RT * ldt;
    stage<DP, NT>(ks, ldt, k, kbase + t0 * kstride, kstride, t1 - t0, RT, D,
                  vec);
    stage<DP, NT>(ks + RT * ldt, ldt, v, kbase + t0 * kstride, kstride,
                  t1 - t0, RT, D, vec);
  };
  if (nt > 0) issue(0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  // Delta of each row, one warp a row, in a fixed order.
  for (int m = warp; m < RO; m += NT / 32) {
    float sum = 0.f;
    if (m < nrows)
      for (int d = lane; d < D; d += 32)
        sum = fmaf(__bfloat162float(dos[m * ldt + d]),
                   __bfloat162float(o[qbase + m * qstride + d]), sum);
    sum = repro::warp_sum(sum);
    if (lane == 0) {
      const size_t row = ((size_t)b * a.H + h) * a.S + r0 + m;
      delta_s[m] = sum;
      lse_s[m] = m < nrows ? a.lse[row] : -INFINITY;
      if (m < nrows) a.delta[row] = sum;
    }
  }
  __syncthreads();
  const int m0 = 16 * wr + g;  // this thread's rows: m0 and m0 + 8
  const Ew w = ew_of(a);
  const float lse2_r[2] = {lse_s[m0] * kLog2e, lse_s[m0 + 8] * kLog2e};
  const float dl_r[2] = {delta_s[m0], delta_s[m0 + 8]};
  const uint32_t xq = sptr(qs + 16 * wr * ldt);
  const uint32_t xdo = sptr(dos + 16 * wr * ldt);
  const uint32_t ring_s = sptr(ring), dss_s = sptr(dss + 16 * wr * ldp);
  float acc[NC / 8][4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      issue(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    int t0, t1;
    range(it, t0, t1);
    const uint32_t ks = ring_s + 2 * (it & 1) * 2 * RT * ldt;
    const uint32_t vs = ks + 2 * RT * ldt;
    const bool full = all_visible(a, false, r0, RO, t0, RT,
                                  nrows == RO && t1 - t0 == RT);
    auto row_of = [&](int r, int, float& l2, float& dl) {
      l2 = lse2_r[r != m0];
      dl = dl_r[r != m0];
    };
#pragma unroll 1
    for (int c0 = wc * NS; c0 < (wc + 1) * NS; c0 += NSC) {
      float sc[NSC / 8][4], dp[NSC / 8][4];
      scores<DP, NSC>(sc, xq, ks, ldt, c0, lane);
      scores<DP, NSC>(dp, xdo, vs, ldt, c0, lane);
      if (a.softcap != 0.f)
        grad_tile<NSC, true>(a, w, sc, dp, full, false, r0, m0, nrows, t0,
                             c0, t1 - t0, t4, row_of);
      else
        grad_tile<NSC, false>(a, w, sc, dp, full, false, r0, m0, nrows, t0,
                              c0, t1 - t0, t4, row_of);
      if constexpr (CW == 1)
        accum_regs<NSC, NC>(acc, dp, ks + 2 * c0 * ldt, ldt, 0, lane);
      else
        put_tile<NSC>(dss + 16 * wr * ldp + c0, ldp, dp, lane);
    }
    if constexpr (CW > 1) {
      __syncthreads();
      accum_smem<RT, NC>(acc, dss_s, ldp, ks, ldt, wc * NC, lane);
    }
    __syncthreads();  // this stage and dS consumed
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * (e >> 1);
      const int d = wc * NC + 8 * j + 2 * t4 + (e & 1);
      if (m < nrows && d < D)
        dq[qbase + m * qstride + d] = __float2bfloat16(acc[j][e] * a.scale);
    }
}

template <int DP>
__global__ void __launch_bounds__(threads16<DP>())
flash_bwd16_kv(const Args a, const int vec, const int hs) {
  constexpr int RO = Tiles<DP>::RO, RT = Tiles<DP>::RT, CW = Tiles<DP>::CW;
  constexpr int NT = threads16<DP>(), NS = RT / CW, NC = DP / CW;
  constexpr int NSC = NS < 32 ? NS : 32;  // streamed rows a score chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout16 L = layout16(DP);
  const int ldt = L.ldt, ldp = L.ldp, ldr = L.ldr;
  bf16* ks = reinterpret_cast<bf16*>(smem + L.own);
  bf16* vs = ks + RO * ldt;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.oth);  // stage: q, then dO
  bf16* pss = reinterpret_cast<bf16*>(smem + L.ps);    // P^T, then dS^T
  bf16* dss = pss + RO * ldp;
  float* rows = reinterpret_cast<float*>(smem + L.rows);  // stage: lse, Delta
  float* u_s = reinterpret_cast<float*>(smem + L.u);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / CW, wc = warp % CW, g = lane >> 2, t4 = lane & 3;
  const int cl = blockIdx.x / hs, split = blockIdx.x - cl * hs;
  const int b = cl / a.KV, kvh = cl - b * a.KV;
  const int n0 = blockIdx.y * RO, n1 = min(a.T, n0 + RO);
  const int G = a.H / a.KV, gs = G / hs, h0 = kvh * G + split * gs;
  const int D = a.D;
  const size_t qstride = (size_t)a.H * D, kstride = (size_t)a.KV * D;
  const size_t kbase = ((size_t)b * a.T + n0) * kstride + (size_t)kvh * D;
  stage<DP, NT>(ks, ldt, k, kbase, kstride, n1 - n0, RO, D, vec);
  stage<DP, NT>(vs, ldt, v, kbase, kstride, n1 - n0, RO, D, vec);
  cp_commit();

  // The rows that can see a key of [n0, n1).
  const long long p_lo = a.causal ? n0 : 0;
  const long long p_hi = (a.window && n0 >= a.prefix)
                             ? (long long)n1 - 2 + a.window
                             : (long long)a.q_offset + a.S;
  const int r_lo = (int)max(0LL, p_lo - a.q_offset);
  const int r_end = (int)min((long long)a.S, p_hi - a.q_offset + 1);
  const int nrt = r_end > r_lo ? (r_end - r_lo + RT - 1) / RT : 0;
  const int nsteps = gs * nrt;
  auto issue = [&](int it) {
    const int h = h0 + it / nrt, r0 = r_lo + (it % nrt) * RT;
    const int nrows = min(RT, a.S - r0);
    const size_t qbase = ((size_t)b * a.S + r0) * qstride + (size_t)h * D;
    bf16* qst = ring + (it & 1) * 2 * RT * ldt;
    stage<DP, NT>(qst, ldt, q, qbase, qstride, nrows, RT, D, vec);
    stage<DP, NT>(qst + RT * ldt, ldt, dout, qbase, qstride, nrows, RT, D,
                  vec);
    float* lse_st = rows + (it & 1) * 2 * RT;
    const size_t row = ((size_t)b * a.H + h) * a.S + r0;
    for (int i = tid; i < 2 * RT; i += NT) {
      const int r = i < RT ? i : i - RT;
      const bool ok = r < nrows;
      const float* src = i < RT ? a.lse : a.delta;
      cp4(lse_st + i, ok ? src + row + r : src, ok);
    }
  };
  if (nsteps > 0) issue(0);
  cp_commit();
  const Ew w = ew_of(a);
  const int k0 = 16 * wr + g;  // this thread's keys: k0 and k0 + 8
  const uint32_t xk = sptr(ks + 16 * wr * ldt);
  const uint32_t xv = sptr(vs + 16 * wr * ldt);
  const uint32_t ring_s = sptr(ring), pss_s = sptr(pss + 16 * wr * ldp);
  const uint32_t dss_s = sptr(dss + 16 * wr * ldp);
  float dk[NC / 8][4], dv[NC / 8][4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    if (it + 1 < nsteps) {
      issue(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int r0 = r_lo + (it % nrt) * RT, nrows = min(RT, a.S - r0);
    const uint32_t qst = ring_s + 2 * (it & 1) * 2 * RT * ldt;
    const uint32_t dost = qst + 2 * RT * ldt;
    const float* lse_st = rows + (it & 1) * 2 * RT;
    const float* dl_st = lse_st + RT;
    const bool full = all_visible(a, true, n0, RO, r0, RT,
                                  n1 - n0 == RO && nrows == RT);
    auto row_of = [&](int, int c, float& l2, float& dl) {
      l2 = lse_st[c] * kLog2e;
      dl = dl_st[c];
    };
#pragma unroll 1
    for (int c0 = wc * NS; c0 < (wc + 1) * NS; c0 += NSC) {
      float sc[NSC / 8][4], dp[NSC / 8][4];
      scores<DP, NSC>(sc, xk, qst, ldt, c0, lane);   // S^T
      scores<DP, NSC>(dp, xv, dost, ldt, c0, lane);  // dP^T
      if (a.softcap != 0.f)
        grad_tile<NSC, true>(a, w, sc, dp, full, true, n0, k0, n1 - n0, r0,
                             c0, nrows, t4, row_of);
      else
        grad_tile<NSC, false>(a, w, sc, dp, full, true, n0, k0, n1 - n0,
                              r0, c0, nrows, t4, row_of);
      if constexpr (CW == 1) {
        accum_regs<NSC, NC>(dv, sc, dost + 2 * c0 * ldt, ldt, 0, lane);
        accum_regs<NSC, NC>(dk, dp, qst + 2 * c0 * ldt, ldt, 0, lane);
      } else {
        put_tile<NSC>(pss + 16 * wr * ldp + c0, ldp, sc, lane);
        put_tile<NSC>(dss + 16 * wr * ldp + c0, ldp, dp, lane);
      }
    }
    if constexpr (CW > 1) {
      __syncthreads();
      accum_smem<RT, NC>(dv, pss_s, ldp, dost, ldt, wc * NC, lane);
      accum_smem<RT, NC>(dk, dss_s, ldp, qst, ldt, wc * NC, lane);
    }
    __syncthreads();  // this stage, P and dS consumed
  }
  cp_wait<0>();

  if (a.any_empty) {  // rows that saw nothing: dO / T to every key's dV
    for (int d = tid; d < DP; d += NT) {
      float sum = 0.f;
      if (d < D)
        for (int h = h0; h < h0 + gs; ++h)
          for (int r = 0; r < a.S; ++r)
            if (a.lse[((size_t)b * a.H + h) * a.S + r] == -INFINITY)
              sum += __bfloat162float(
                  dout[((size_t)b * a.S + r) * qstride + (size_t)h * D + d]);
      u_s[d] = sum / (float)a.T;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[j][e] += u_s[wc * NC + 8 * j + 2 * t4 + (e & 1)];
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
  if (hs == 1) {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = k0 + 8 * (e >> 1);
        const int d = wc * NC + 8 * j + 2 * t4 + (e & 1);
        if (n0 + n < n1 && d < D) {
          dkp[kbase + n * kstride + d] = __float2bfloat16(dk[j][e] * a.scale);
          dvp[kbase + n * kstride + d] = __float2bfloat16(dv[j][e]);
        }
      }
    return;
  }
  // Split heads: this block's sums to its shared memory, then each block
  // of the cluster sums rows split, split + hs, ... over the cluster's
  // blocks in rank order.
  __syncthreads();  // every warp is past its last read of the tiles
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int hm = 0; hm < 2; ++hm) {
      const int at = (k0 + 8 * hm) * ldr + wc * NC + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(red + at) =
          make_float2(dk[j][2 * hm], dk[j][2 * hm + 1]);
      *reinterpret_cast<float2*>(red + RO * ldr + at) =
          make_float2(dv[j][2 * hm], dv[j][2 * hm + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int mine = (RO - split + hs - 1) / hs;
  for (int e = tid; e < mine * DP; e += NT) {
    const int n = split + hs * (e / DP), d = e % DP;
    if (n0 + n >= n1 || d >= D) continue;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < hs; ++r) {
      const float* rr = cluster.map_shared_rank(red, r);
      sk += rr[n * ldr + d];
      sv += rr[RO * ldr + n * ldr + d];
    }
    dkp[kbase + n * kstride + d] = __float2bfloat16(sk * a.scale);
    dvp[kbase + n * kstride + d] = __float2bfloat16(sv);
  }
  cluster.sync();  // no block leaves while another reads its sums
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

template <int DP>
int launch16(const Args& a, int B, size_t smem, int vec, cudaStream_t st) {
  constexpr int RO = Tiles<DP>::RO, NT = threads16<DP>();
  int e = allow_smem((const void*)flash_bwd16_q<DP>, smem);
  if (e == 0) e = allow_smem((const void*)flash_bwd16_kv<DP>, smem);
  if (e != 0) return e;
  const int ny = (a.S + RO - 1) / RO, nkt = (a.T + RO - 1) / RO;
  if (ny > 65535 || nkt > 65535) return (int)cudaErrorInvalidValue;
  flash_bwd16_q<DP><<<dim3(B * a.H, ny), NT, smem, st>>>(a, vec);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  int dev = 0, sms = 0;
  e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (e != 0) return e;
  const int hs = head_split(a.H / a.KV, (long long)B * a.KV * nkt, sms);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = hs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.KV * hs, nkt);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, flash_bwd16_kv<DP>, a, vec, hs);
  return e != 0 ? e : (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, D) in q's type; k, v, dk, dv: (B, T, KV, D) in
// k's type; lse (B, H, S) float32 from the forward (-inf: a row that saw no
// key); delta (B, H, S) float32 scratch, written by the first kernel; all
// contiguous.  dp and smem are kernels/flash_attention.py::flash_bwd_plan's
// (its bf16 plan where q_bf16 and kv_bf16 are both set: that call takes
// the tensor-core path; any f32 operand, the CUDA-core path).  Returns the
// CUDA error of the launches; a shape or plan the kernels cannot take is
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int q_bf16, int kv_bf16, int B, int S, int T, int H, int KV,
    int D, float scale, int causal, int window, float softcap, int prefix,
    int q_offset, int any_empty, int dp, long long smem, void* stream) {
  const bool tc = q_bf16 && kv_bf16;
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV || D < 1 || D > dp ||
      q_offset < 0 || window < 0 || B > 65535 || H > 65535 ||
      (dp != 64 && dp != 128 && dp != 256) || (dp > 64 && D <= dp / 2) ||
      (size_t)smem != (tc ? layout16(dp).total : layout(dp).total))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, q_bf16, kv_bf16, S,
               T, H, KV, D, scale, causal, window, softcap, prefix, q_offset,
               any_empty};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    const int vec = D % 8 == 0 &&
                    (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                      (uintptr_t)dout) & 15) == 0;
    if (dp == 64) return launch16<64>(a, B, (size_t)smem, vec, st);
    if (dp == 128) return launch16<128>(a, B, (size_t)smem, vec, st);
    return launch16<256>(a, B, (size_t)smem, vec, st);
  }
  if (dp == 64) return launch<64>(a, B, (size_t)smem, st);
  if (dp == 128) return launch<128>(a, B, (size_t)smem, st);
  return launch<256>(a, B, (size_t)smem, st);
}
