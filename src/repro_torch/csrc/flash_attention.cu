// flash_attention for Hopper: prefill attention of (B, S, H, D) queries
// against (B, T, KV, D) keys and values, with GQA, a causal mask, a sliding
// window with an always-visible prefix, logit soft-capping and q_offset
// (the absolute position of query 0).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).
//
// What bounds it on the H100: at the serving prompts (a dozen tokens) the
// work is tiny and a call is latency: reading q, k and v once, a few
// barriers and the launch.  At long prompts it is the 4 S T D operations
// of Q K^T and P V (half of them under a causal mask), which this kernel
// does on the float32 units: TF32 would miss the f32 tolerance, and the
// bf16 tensor cores (mma.sync with P in bf16) are a later step.
//
// Design: one block of 128 threads per (tile of query rows, head or KV
// head, sequence).  A block holds RB = 64 rows (32 at D = 256): BQ query
// positions of one head, or, where kernels/flash_attention.py::flash_plan
// groups heads, BQ = RB / G positions of all G query heads that share one
// KV head, so each K/V tile is staged once for the G heads.  q is staged
// once, pre-scaled, as float32.  The block walks the keys any of its rows
// can see (the window's range, and the prefix before it) in tiles of BK
// keys (16, 32 or 64, the plan's), K and V staged by 16-byte cp.async into
// a two-stage ring so that the next tile's copy runs under this tile's
// arithmetic; bf16 is converted at use.  Per tile:
//   1. S = Q K^T as 4 x 4 register tiles per thread, four float4 of q and
//      four of k along D for 64 multiply-adds (one shared load per 8 FFMA;
//      short tiles split D across lanes and add by a fixed butterfly),
//      written raw to shared memory;
//   2. per row, 2 or 4 threads apply softcap, then the mask (a masked
//      key's score is -inf), in a plain loop, and take the tile's max and
//      sum with shuffles:
//      m_new = max(m, max_tile), alpha = exp(m - m_new), p = exp(s -
//      m_new), l = l alpha + sum p.  A row with no visible key in the tile
//      keeps m and l (alpha = 1, p = 0): it never computes
//      exp(-inf - (-inf));
//   3. O = O alpha + P V, each thread 4 rows by D/8 (D/16 at D = 256)
//      columns of the accumulator in registers, four float4 of P and one
//      float4 of V a key for each four of its columns: at D = 256 a row is
//      spread over 16 threads, 64 accumulators a thread, no spill.
// The key loop of a tile is independent across its keys: no per-key
// dependent chain.  Code size counts as much as arithmetic at these
// sizes: with the mask and the all-masked-row path unrolled per element
// the kernel was up to 36 k instructions; in plain loops it is 5-8 k, and
// a serving call is about a quarter faster (PERF.md).  Masked keys weigh
// exactly zero, so the result matches the reference's finite mask; a row
// with no visible key at all gets the reference's answer, the uniform
// average of v over all T.  Sums run in a fixed order: calls are
// bit-identical run to run.  For training, the launcher may be given a
// buffer for each row's log-sum-exp (m + log l), from which the backward
// (flash_attention_bwd.cu) recomputes P.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// Rows a block holds, and accumulator columns a thread holds, for D padded
// to DP (32, 64, 128 or 256).
template <int DP>
__host__ __device__ constexpr int rows_of() { return DP == 256 ? 32 : 64; }
template <int DP>
__host__ __device__ constexpr int cols_of() {
  return rows_of<DP>() * DP / (kThreads * 4);
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Byte offsets of a block's shared memory; kernels/flash_attention.py::
// _smem mirrors the total, and the launcher refuses a plan that disagrees.
struct Layout {
  int ldq, ldp, ldk;  // row strides: q, P (floats); K and V (elements)
  size_t q, p, alpha, l, pos, base, k, v, total;
};

__host__ __device__ inline Layout layout(int dp, int rb, int bk, int esz,
                                         int stages) {
  Layout L;
  L.ldq = dp + 4;
  L.ldp = bk + 4;
  L.ldk = dp + 16 / esz;
  size_t o = 0;
  L.q = o;     o += sizeof(float) * rb * L.ldq;
  L.p = o;     o += sizeof(float) * rb * L.ldp;
  L.alpha = o; o += sizeof(float) * rb;
  L.l = o;     o += sizeof(float) * rb;
  L.pos = o;   o += sizeof(int) * rb;
  L.base = o;  o += sizeof(int) * rb;
  L.k = o;     o += (size_t)esz * stages * bk * L.ldk;
  L.v = o;     o += (size_t)esz * stages * bk * L.ldk;
  L.total = o;
  return L;
}

template <typename KT>
struct Args {
  const void* q;
  const KT* k;
  const KT* v;
  void* out;
  float* lse;  // (B, H, S) log-sum-exp of each row, for the backward; or null
  int q_bf16, S, T, H, KV, D;
  float scale;
  int causal, window;
  float softcap;
  int prefix, q_offset;
  int bq, gb, bk, stages, aligned, q_vec;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float dot4(float a, float4 x, float4 b) {
  a = fmaf(x.x, b.x, a);
  a = fmaf(x.y, b.y, a);
  a = fmaf(x.z, b.z, a);
  return fmaf(x.w, b.w, a);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One step of group_sum: lanes w apart swap the halves of their first
// 2 kHalf values and keep the sum of one half each.  The trip count is a
// template constant so that v stays in registers.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[16], int w, bool up) {
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    const float lo = v[e], hi = v[e + kHalf];
    const float send = up ? lo : hi, keep = up ? hi : lo;
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, w);
  }
}

// Sums the 16 values of v over a group of ks consecutive lanes (ks a power
// of two, at most 32; every lane of the warp calls it) by a butterfly that
// halves what each lane keeps at every step.  Afterwards this lane holds
// the sums of elements [*first, *first + count) in v[0..count); count is
// 16 / ks, or for ks = 32 one sum held by the lanes with bit 4 clear (the
// others hold none and return 0).  The order of the additions is fixed.
__device__ __forceinline__ int group_sum(float (&v)[16], int ks, int lane,
                                         int* first) {
  int base = 0;
  if (ks > 1) { fold<8>(v, 1, lane & 1); base += (lane & 1) ? 8 : 0; }
  if (ks > 2) { fold<4>(v, 2, lane & 2); base += (lane & 2) ? 4 : 0; }
  if (ks > 4) { fold<2>(v, 4, lane & 4); base += (lane & 4) ? 2 : 0; }
  if (ks > 8) { fold<1>(v, 8, lane & 8); base += (lane & 8) ? 1 : 0; }
  *first = base;
  if (ks == 32) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
    return (lane & 16) ? 0 : 1;
  }
  return 16 / ks;
}

__device__ __forceinline__ int split_of(int tiles) {
  int ks = 1;
  while (ks < 32 && tiles * ks * 2 <= kThreads) ks *= 2;
  return ks;
}

// Keys [t0, t1) of this block's KV head into a stage: rows past t1 and
// columns past D arrive as zeros.
template <typename KT, int DP>
__device__ void stage(const Args<KT>& a, const KT* kb, const KT* vb, int t0,
                      int t1, int ldk, KT* ks, KT* vs, int tid) {
  const size_t ts = (size_t)a.KV * a.D;  // elements between keys
  if (a.aligned) {
    constexpr int per = 16 / sizeof(KT);
    constexpr int cpr = DP / per;  // 16-byte pieces of a padded row
    for (int e = tid; e < a.bk * cpr; e += kThreads) {
      const int i = e / cpr, c = e - i * cpr;
      const bool ok = t0 + i < t1 && c * per < a.D;
      const size_t g = ok ? (size_t)(t0 + i) * ts + c * per : 0;
      cp16(ks + i * ldk + c * per, kb + g, ok);
      cp16(vs + i * ldk + c * per, vb + g, ok);
    }
    cp_commit();
    return;
  }
  const KT zero = repro::from_f32<KT>(0.f);
  for (int e = tid; e < a.bk * DP; e += kThreads) {
    const int i = e / DP, d = e - i * DP;
    const bool ok = t0 + i < t1 && d < a.D;
    const size_t g = (size_t)(t0 + i) * ts + d;
    ks[i * ldk + d] = ok ? kb[g] : zero;
    vs[i * ldk + d] = ok ? vb[g] : zero;
  }
}

template <typename KT, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_tiles(const Args<KT> a) {
  constexpr int RB = rows_of<DP>(), DT = cols_of<DP>();
  constexpr int ogs = DP / DT;        // column groups of the accumulator
  constexpr int tpr = kThreads / RB;  // threads a row in the softmax
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.z, q0 = blockIdx.x * a.bq;
  const int G = a.H / a.KV;
  const int kvh = a.gb > 1 ? blockIdx.y : blockIdx.y / G;
  const int h0 = a.gb > 1 ? blockIdx.y * G : blockIdx.y;
  const int bk = a.bk, D = a.D;
  const Layout L = layout(DP, RB, bk, sizeof(KT), a.stages);
  float* sq = reinterpret_cast<float*>(smem + L.q);  // [RB][ldq]
  float* sp = reinterpret_cast<float*>(smem + L.p);  // [RB][ldp]
  float* salpha = reinterpret_cast<float*>(smem + L.alpha);
  float* sl = reinterpret_cast<float*>(smem + L.l);
  KT* skr = reinterpret_cast<KT*>(smem + L.k);  // [stages][bk][ldk]
  KT* svr = reinterpret_cast<KT*>(smem + L.v);
  const int ldq = L.ldq, ldp = L.ldp, ldk = L.ldk;

  // Row r of the block is position q0 + r % bq of head h0 + r / bq; its
  // absolute position (-1 for a row past S or past the block's heads) and
  // the index of its (sequence, position, head) row of q and out, worked
  // out once so that no division sits on a loop's path.
  int* spos = reinterpret_cast<int*>(smem + L.pos);
  int* sbase = reinterpret_cast<int*>(smem + L.base);
  if (tid < RB) {
    const int qi = tid % a.bq, hr = tid / a.bq;
    const bool live = hr < a.gb && q0 + qi < a.S;
    spos[tid] = live ? a.q_offset + q0 + qi : -1;
    sbase[tid] = live ? ((b * a.S + q0 + qi) * a.H + h0 + hr) : -1;
  }

  const KT* kb = a.k + (size_t)b * a.T * a.KV * D + (size_t)kvh * D;
  const KT* vb = a.v + (size_t)b * a.T * a.KV * D + (size_t)kvh * D;

  // The keys any row can see: the window's range [lo, hi) and, before it,
  // the always-visible prefix [0, a_end).
  const int last = a.q_offset + min(a.S, q0 + a.bq) - 1;
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window ? max(0, a.q_offset + q0 - a.window + 1) : 0;
  const int a_end = a.window ? min(min(a.prefix, lo), hi) : 0;
  const int n_a = (a_end + bk - 1) / bk;
  const int n_b = hi > lo ? (hi - lo + bk - 1) / bk : 0;
  const int ntiles = n_a + n_b;
  auto tile_range = [&](int t, int* t0, int* t1) {
    if (t < n_a) {
      *t0 = t * bk;
      *t1 = min(*t0 + bk, a_end);
    } else {
      *t0 = lo + (t - n_a) * bk;
      *t1 = min(*t0 + bk, hi);
    }
  };

  if (ntiles > 0) {
    int t0, t1;
    tile_range(0, &t0, &t1);
    stage<KT, DP>(a, kb, vb, t0, t1, ldk, skr, svr, tid);
  }
  __syncthreads();  // the row tables
  {  // q, scaled, as float32: every load of the thread issued at once.
    constexpr int q4 = DP / 4, per = RB * q4 / kThreads;
    float4 qv[per];
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int e = tid + kThreads * u, r = e / q4, d = 4 * (e - r * q4);
      const int base = sbase[r];
      qv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base < 0 || d >= D) continue;
      const size_t off = (size_t)base * D + d;
      const float* qf = static_cast<const float*>(a.q) + off;
      const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(a.q) + off;
      if (a.q_vec) {
        qv[u] = a.q_bf16 ? ld4(qh) : ld4(qf);
      } else {
        float t[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          t[c] = d + c >= D ? 0.f : a.q_bf16 ? __bfloat162float(qh[c]) : qf[c];
        qv[u] = make_float4(t[0], t[1], t[2], t[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int e = tid + kThreads * u, r = e / q4, d = 4 * (e - r * q4);
      *reinterpret_cast<float4*>(sq + r * ldq + d) =
          make_float4(qv[u].x * a.scale, qv[u].y * a.scale,
                      qv[u].z * a.scale, qv[u].w * a.scale);
    }
  }

  // The accumulator: rows og_r + (RB/4) a, columns 4 (og_c + ogs u) + c.
  const int og_c = tid % ogs, og_r = tid / ogs;
  float acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  // The softmax state of row tid / tpr (every one of its tpr lanes).
  const int srow = tid / tpr, spart = tid % tpr;
  float m = -INFINITY, l = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int sb = a.stages == 2 ? (it & 1) : 0;
    const KT* sk = skr + (size_t)sb * bk * ldk;
    const KT* sv = svr + (size_t)sb * bk * ldk;
    int t0, t1;
    tile_range(it, &t0, &t1);
    const int nt = t1 - t0;
    cp_wait_all();
    __syncthreads();  // tile it staged; tile it-1 consumed
    if (a.stages == 1 && it > 0) {  // one buffer: stage, then wait
      stage<KT, DP>(a, kb, vb, t0, t1, ldk, skr, svr, tid);
      cp_wait_all();
      __syncthreads();
    }
    if (a.stages == 2 && it + 1 < ntiles) {
      int u0, u1;
      tile_range(it + 1, &u0, &u1);
      stage<KT, DP>(a, kb, vb, u0, u1, ldk,
                    skr + (size_t)(sb ^ 1) * bk * ldk,
                    svr + (size_t)(sb ^ 1) * bk * ldk, tid);
    }

    // 1. Raw scores q . k into sp (cap and mask come in step 2, in a
    // plain loop: the unrolled writes here stay small).
    {
      constexpr int rgs = RB / 4;
      const int cgs = bk / 4, tiles = rgs * cgs;
      const int ks = split_of(tiles), items = tiles * ks;
      for (int base = 0; base < items; base += kThreads) {
        const int item = base + tid;
        const bool active = item < items;
        const int s = item % ks, t = item / ks;
        const int rg = t % rgs, cg = t / rgs;
        float v[16] = {};
        const bool any =
            max(max(spos[rg], spos[rg + rgs]),
                max(spos[rg + 2 * rgs], spos[rg + 3 * rgs])) >= 0;
        if (active && any && cg < nt) {
#pragma unroll 4
          for (int d = 4 * s; d < DP; d += 4 * ks) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              qv[i] = ld4(sq + (rg + rgs * i) * ldq + d);
              kv[i] = ld4(sk + (cg + cgs * i) * ldk + d);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[i * 4 + j] = dot4(v[i * 4 + j], qv[i], kv[j]);
          }
        }
        int first;
        const int cnt = group_sum(v, ks, lane, &first);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (!active || e >= cnt) continue;
          const int idx = first + e;
          sp[(rg + rgs * (idx >> 2)) * ldp + cg + cgs * (idx & 3)] = v[e];
        }
      }
    }
    __syncthreads();

    // 2. Per row: softcap, then the mask (a masked key's score is -inf);
    // the tile's max and sum; P replaces the scores.
    {
      float* pr = sp + srow * ldp;
      const int p = spos[srow];  // -1: a dead row, every key masked
      float mt = -INFINITY;
      for (int j = spart; j < bk; j += tpr) {
        const int tk = t0 + j;
        bool ok = p >= 0 && j < nt;
        if (a.causal) ok = ok && tk <= p;
        if (a.window) ok = ok && (tk > p - a.window || tk < a.prefix);
        float sc = pr[j];
        if (a.softcap != 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
        sc = ok ? sc : -INFINITY;
        pr[j] = sc;
        mt = fmaxf(mt, sc);
      }
#pragma unroll
      for (int o = 1; o < tpr; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      float alpha = 1.f, sum = 0.f;
      if (mt == -INFINITY) {  // nothing visible in this tile
        for (int j = spart; j < bk; j += tpr) pr[j] = 0.f;
      } else {
        const float m_new = fmaxf(m, mt);
        alpha = expf(m - m_new);
        for (int j = spart; j < bk; j += tpr) {
          const float p = expf(pr[j] - m_new);
          pr[j] = p;
          sum += p;
        }
        m = m_new;
      }
#pragma unroll
      for (int o = 1; o < tpr; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l = fmaf(l, alpha, sum);
      if (spart == 0) salpha[srow] = alpha;
    }
    __syncthreads();

    // 3. O = O alpha + P V.
    {
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        al[i] = salpha[og_r + (RB / 4) * i];
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] *= al[i];
      }
      const int kend = round_up(nt, 4);
#pragma unroll 2
      for (int j = 0; j < kend; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = ld4(sp + (og_r + (RB / 4) * i) * ldp + j);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const KT* vr = sv + (j + t) * ldk;
#pragma unroll
          for (int u = 0; u < DT / 4; ++u) {
            const float4 vv = ld4(vr + 4 * (og_c + ogs * u));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = comp(pv[i], t);
              acc[i][4 * u] = fmaf(p, vv.x, acc[i][4 * u]);
              acc[i][4 * u + 1] = fmaf(p, vv.y, acc[i][4 * u + 1]);
              acc[i][4 * u + 2] = fmaf(p, vv.z, acc[i][4 * u + 2]);
              acc[i][4 * u + 3] = fmaf(p, vv.w, acc[i][4 * u + 3]);
            }
          }
        }
      }
    }
  }

  __shared__ int any_empty;  // a live row that saw no key
  if (tid == 0) any_empty = 0;
  __syncthreads();
  if (spart == 0) {
    sl[srow] = l;
    if (l == 0.f && spos[srow] >= 0) any_empty = 1;
    if (a.lse != nullptr && spos[srow] >= 0)  // -inf: the row saw no key
      a.lse[((size_t)b * a.H + h0 + srow / a.bq) * a.S + q0 + srow % a.bq] =
          l == 0.f ? -INFINITY : m + logf(l);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = og_r + (RB / 4) * i;
    const int base = sbase[r];
    const float den = sl[r];
    if (base < 0 || den == 0.f) continue;  // dead, or nothing visible
    const float inv = __frcp_rn(den);
    const size_t off = (size_t)base * D;
#pragma unroll
    for (int u = 0; u < DT / 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (og_c + ogs * u) + c;
        if (d >= D) continue;
        const float o = acc[i][4 * u + c] * inv;
        if (a.q_bf16)
          static_cast<__nv_bfloat16*>(a.out)[off + d] = __float2bfloat16(o);
        else
          static_cast<float*>(a.out)[off + d] = o;
      }
  }
  // A live row that saw no key gets the softmax of an all-masked row, the
  // mean of v over all T.  Rare, so one plain loop, kept out of the
  // unrolled code above.
  if (!any_empty) return;
#pragma unroll 1
  for (int e = tid; e < RB * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    if (sbase[r] < 0 || sl[r] != 0.f || d >= D) continue;
    float sum = 0.f;
    for (int t = 0; t < a.T; ++t)
      sum += repro::to_f32(vb[(size_t)t * a.KV * D + d]);
    const float o = sum / (float)a.T;
    const size_t off = (size_t)sbase[r] * D + d;
    if (a.q_bf16)
      static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16(o);
    else
      static_cast<float*>(a.out)[off] = o;
  }
}

template <typename KT, int DP>
int launch(const Args<KT>& a, int B, size_t smem, cudaStream_t st) {
  auto kernel = flash_tiles<KT, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // All of the SM's shared memory, so that the plan's blocks fit.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int heads = a.gb > 1 ? a.KV : a.H;
  kernel<<<dim3((a.S + a.bq - 1) / a.bq, heads, B), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_d(const Args<KT>& a, int B, int dp, size_t smem,
             cudaStream_t st) {
  if (dp == 32) return launch<KT, 32>(a, B, smem, st);
  if (dp == 64) return launch<KT, 64>(a, B, smem, st);
  if (dp == 128) return launch<KT, 128>(a, B, smem, st);
  return launch<KT, 256>(a, B, smem, st);
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); out: (B, S, H, D) in q's type; all
// contiguous.  lse: null, or (B, H, S) float32 that receives each row's
// log-sum-exp of its capped, masked scores (-inf for a row that saw no
// key), which flash_attention_bwd.cu reads; the serving path passes null.  The plan (dp, bq, gb, bk, stages, smem) is
// kernels/flash_attention.py::flash_plan's: D padded to dp, bq query
// positions of gb heads a block (gb = 1, or all H / KV heads of one KV
// head), tiles of bk keys.  aligned: k and v 16-byte aligned with rows of
// whole 16-byte pieces (the cp.async path); q_vec: D % 4 == 0 and q
// 16-byte aligned (q read four elements a load).  Returns the CUDA error of the
// launch; a shape or plan the kernel cannot take is cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int q_bf16,
    int kv_bf16, int B, int S, int T, int H, int KV, int D, float scale,
    int causal, int window, float softcap, int prefix, int q_offset, int dp,
    int bq, int gb, int bk, int stages, long long smem, int aligned,
    int q_vec, void* stream) {
  const int rb = dp == 256 ? 32 : 64;
  const int esz = kv_bf16 ? 2 : 4;
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV || D < 1 || D > dp ||
      (long long)B * S * H > 2147483647LL ||  // a row index is an int
      (dp != 32 && dp != 64 && dp != 128 && dp != 256) ||
      (dp > 32 && D <= dp / 2) || (bk != 16 && bk != 32 && bk != 64) ||
      (gb != 1 && gb != H / KV) || bq < 1 || bq * gb > rb ||
      (stages != 1 && stages != 2) ||
      (size_t)smem != layout(dp, rb, bk, esz, stages).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) {
    using KT = __nv_bfloat16;
    const Args<KT> a{q, static_cast<const KT*>(k), static_cast<const KT*>(v),
                     out, lse, q_bf16, S, T, H, KV, D, scale, causal, window,
                     softcap, prefix, q_offset, bq, gb, bk, stages, aligned,
                     q_vec};
    return launch_d<KT>(a, B, dp, (size_t)smem, st);
  }
  const Args<float> a{q, static_cast<const float*>(k),
                      static_cast<const float*>(v), out, lse, q_bf16, S, T,
                      H, KV, D, scale, causal, window, softcap, prefix,
                      q_offset, bq, gb, bk, stages, aligned, q_vec};
  return launch_d<float>(a, B, dp, (size_t)smem, st);
}
