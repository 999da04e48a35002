// decode_attention for Hopper: one query token per sequence against its KV
// cache, with GQA, per-sequence lengths, a sliding window with an
// always-visible prefix, and logit soft-capping.  Two layouts share one
// body: a dense (B, T, KV, D) cache, and a shared pool of pages
// (P, KV, page_size, D) that each sequence names through a page table.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel) and ::paged_decode_attention (_paged_decode_kernel).
//
// What bounds it on the H100: the visible k and v bytes, read once, at
// 3.35 TB/s.  Each cache byte feeds about G multiply-adds (G query heads
// share a KV head, at most 8 on the served models), far below the ~295
// operations a byte at which arithmetic would be the limit.
//
// Design: split-key ("flash-decoding"), against the four things that held
// a one-warp-per-head walk at 70-90x SDPA's time on long caches:
//
// 1. Too few warps (gemma2's replay: 16 warps on 132 SMs).  The keys are
//    cut into splits of `split` logical rows, and one block of kThreads
//    computes one (sequence, KV head, split): 528 blocks for gemma2 at
//    4204 keys.  kernels/decode_attention.py::split_plan picks the split
//    from the shapes and types alone, never from T, the page count, the
//    page size or the lengths, so a dense cache and its page pool are cut
//    at the same logical rows and give bit-equal results.  A split (or a
//    tile) with no visible key is skipped without reading the cache.
// 2. One serial chain per key (load, shuffle reduction, exponentials,
//    then the value row).  Tiles of `tile` key and value rows are copied
//    to shared memory with 16-byte cp.async in a ring of kStages stages,
//    so the next tiles load while this one is computed.  A tile's scores
//    are computed at once, a thread per (query head, key) pair (or R
//    threads per pair over parts of D, summed in a fixed order) against
//    the queries in shared memory; one warp per head then updates the
//    running max and denominator once per tile, and every thread its
//    slice of the heads' accumulators (RV threads per slice over every
//    RV-th key, summed in order at the end).
// 3. Each KV row read G times, once per query head.  A block holds all G
//    heads of its KV head (chunks of at most kMaxHeads), so each row is
//    read from device memory once per call.
// 4. The dense cache's KV*D stride between keys (17% on gemma2's global
//    layers).  Rows are staged one by one through a table of where each
//    row of the split starts, so the stride no longer matters.  For the
//    pool that table comes from the split's page-table entries, each read
//    once; an entry outside [0, P) that a visible row would read stops the
//    kernel (__trap) instead of being clamped.  Masked rows are
//    zero-filled, not read, and weigh 0: once one visible key has been
//    seen, the reference gives a masked key exactly zero weight too.
//
// Arithmetic is f32 on the CUDA cores: bytes are the bound, and tensor
// cores would round the 8-bit variant's f32 query.  A second kernel
// combines the splits: one block per (sequence, query head, 64 of D)
// folds the splits' (m, l, acc) in a fixed order, with no atomics and
// empty splits skipped, so two calls give bit-identical results; it is a
// programmatic dependent launch, scheduled while the split kernel ends.
// A row with nothing visible gets the reference's answer, the mean of v
// over every row of the (gathered) cache.  With one split the first kernel
// writes the output itself and the call is one launch.  The kernels
// allocate nothing: the wrapper passes the f32 partials (B, KV, splits,
// G, D) and their (m, l) pairs (B, KV, splits, G, 2).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kMinBlocks = 5;  // resident split blocks an SM, by registers
constexpr int kMaxHeads = 8;   // query heads per block
constexpr int kMaxAcc = 16;    // f32 accumulators per thread
constexpr int kLoads = 4;      // 16-byte chunks of a k tile per thread
constexpr int kCombineSlice = 64;  // elements of D a combine block sums

struct Params {
  int B, H, KV, G, n;  // n: logical rows (T, or NP * page_size)
  int D, C;            // C: 16-byte chunks per row
  int split, splits, tile, heads;
  int P, ps, NP;
  float scale, softcap;
  int window, prefix;
};

// Rows of one (sequence, KV head) in the dense cache.
struct Dense {
  static constexpr bool kPaged = false;
  size_t step;  // KV * D: from key t to key t + 1
  __device__ size_t row(int t) const { return (size_t)t * step; }
};

// Rows of one (sequence, KV head) in the page pool.
struct Paged {
  static constexpr bool kPaged = true;
  const int* table;  // the sequence's row of the page table
  int ps, P, D;
  size_t page_step;  // KV * ps * D
  __device__ int page(int blk) const {
    const int p = table[blk];
    if ((unsigned)p >= (unsigned)P) __trap();
    return p;
  }
  __device__ size_t at(int page, int t) const {
    return (size_t)page * page_step + (size_t)(t % ps) * D;
  }
  __device__ size_t row(int t) const { return at(page(t / ps), t); }
};

// The keys a row sees: [0, a_hi) and [b_lo, t_hi).
struct Visible {
  int a_hi, b_lo, t_hi;
  __device__ Visible(int len, int n, int window, int prefix) {
    t_hi = max(0, min(len, n));
    a_hi = t_hi;
    b_lo = t_hi;
    if (window) {
      a_hi = min(prefix, t_hi);
      b_lo = max(len - window, a_hi);
    }
  }
  __device__ bool operator()(int t) const {
    return t < a_hi || (t >= b_lo && t < t_hi);
  }
  // Does [lo, hi) hold a visible key?
  __device__ bool any(int lo, int hi) const {
    return lo < min(hi, a_hi) || max(lo, b_lo) < min(hi, t_hi);
  }
};

__device__ __forceinline__ float inv_l(float l) {
  return 1.f / fmaxf(l, 1e-30f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of KT as f32.
template <typename KT>
struct Chunk {
  static constexpr int E = 16 / sizeof(KT);
  float x[E];
  __device__ __forceinline__ void load(const KT* p) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(KT) == 4) {
      x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
      x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
    } else {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

// The mean of v over all n rows of one (sequence, KV head), at element d:
// the reference's softmax of a row with nothing visible.
template <typename KT, typename Layout>
__device__ float mean_v(const Layout& lay, const KT* v, int n, int d) {
  float s = 0.f;
  for (int t = 0; t < n; ++t) s += repro::to_f32(v[lay.row(t) + d]);
  return s * inv_l((float)n);
}

// One block: (split, KV head and head chunk, sequence).  Registers are
// held to what kMinBlocks blocks an SM leave (measured a little faster on
// the replay's shapes than the compiler's own choice).
template <typename QT, typename KT, typename Layout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_split(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, Layout lay,
             const int* __restrict__ lengths, QT* __restrict__ out,
             float* __restrict__ part, float* __restrict__ ml, Params p) {
  constexpr int E = Chunk<KT>::E;
  constexpr int kOut = kMaxAcc / E;  // output chunks per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, b = blockIdx.z;
  const int chunks = (p.G + p.heads - 1) / p.heads;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y - kvh * chunks) * p.heads;
  const int gn = min(p.heads, p.G - g0);
  const int TK = p.tile, C = p.C, D = p.D;
  const int RS = D + E;  // a staged row, padded by 16 bytes
  const int lo = s * p.split, hi = min(lo + p.split, p.n);
  const int pg0 = lo / p.ps;  // ps is 1 for the dense cache
  // The combine kernel may be scheduled now; it waits for this grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // Shared memory: kStages tiles of k, then of v; the queries; the
  // score partials; the weights; per-head m, l, alpha; where each row of
  // the split starts; (paged) the split's table entries.
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ks = reinterpret_cast<KT*>(smem);
  KT* vs = ks + (size_t)kStages * TK * RS;
  float* qs = reinterpret_cast<float*>(vs + (size_t)kStages * TK * RS);
  const int QS = D + 4;
  float* spart = qs + p.heads * QS;
  float* ps_ = spart + max(kThreads, p.heads * TK);
  float* m_s = ps_ + p.heads * TK;
  float* l_s = m_s + kMaxHeads;
  float* a_s = l_s + kMaxHeads;
  long long* rowoff = reinterpret_cast<long long*>(a_s + kMaxHeads);
  int* pages = reinterpret_cast<int*>(rowoff + p.split);

  // The length, the queries and (paged) the split's table entries, each
  // read once, are read side by side.
  const int len = lengths[b];
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    qs[g * QS + d] =
        repro::to_f32(q[((size_t)b * p.H + kvh * p.G + g0 + g) * D + d]) *
        p.scale;
  }
  if (tid < kMaxHeads) {
    m_s[tid] = repro::kNegInf;
    l_s[tid] = 0.f;
  }
  if constexpr (Layout::kPaged) {
    lay.table += (size_t)b * p.NP;
    const int npg = (hi - 1) / p.ps - pg0 + 1;
    for (int i = tid; i < npg; i += kThreads) pages[i] = lay.table[pg0 + i];
    const size_t base = (size_t)kvh * p.ps * D;
    k += base;
    v += base;
  } else {
    const size_t base = ((size_t)b * p.n * p.KV + kvh) * D;
    k += base;
    v += base;
  }
  const Visible vis(len, p.n, p.window, p.prefix);
  const size_t slot = ((size_t)b * p.KV + kvh) * p.splits + s;

  if (!vis.any(lo, hi)) {
    if (p.splits > 1) {  // an empty partial: l = 0
      if (tid < gn) {
        ml[(slot * p.G + g0 + tid) * 2] = repro::kNegInf;
        ml[(slot * p.G + g0 + tid) * 2 + 1] = 0.f;
      }
    } else {  // the whole row is empty
      for (int d = tid; d < D; d += kThreads) {
        const float m = mean_v<KT>(lay, v, p.n, d);
        for (int g = 0; g < gn; ++g)
          out[((size_t)b * p.H + kvh * p.G + g0 + g) * D + d] =
              repro::from_f32<QT>(m);
      }
    }
    return;
  }
  __syncthreads();
  // Each row of the split: where it starts, or -1 where it is masked
  // (past the split's end too).  A table entry is checked here, where a
  // visible row reads it.
  for (int i = tid; i < p.split; i += kThreads) {
    const int t = lo + i;
    long long off = -1;
    if (t < hi && vis(t)) {
      if constexpr (Layout::kPaged) {
        const int page = pages[t / p.ps - pg0];
        if ((unsigned)page >= (unsigned)p.P) __trap();
        off = (long long)lay.at(page, t);
      } else {
        off = (long long)lay.row(t);
      }
    }
    rowoff[i] = off;
  }
  __syncthreads();

  // The visible tiles: those of [lo, a_hi), then those of [b_lo, t_hi).
  const int e1 = min(hi, vis.a_hi);
  const int na = e1 > lo ? (e1 - lo + TK - 1) / TK : 0;
  const int s2 = max(lo, vis.b_lo), e2 = min(hi, vis.t_hi);
  const int i0b = s2 < e2 ? max((s2 - lo) / TK, na) : na;
  const int nb = s2 < e2 ? max(0, (e2 - lo + TK - 1) / TK - i0b) : 0;
  const int ntiles = na + nb;
  auto tile_at = [&](int i) { return i < na ? i : i0b + (i - na); };

  // This thread's 16-byte chunks of a tile (at most kLoads: a tile's k
  // holds at most 8 KB), the same in every tile.  Masked rows are
  // zero-filled, not read.
  int lj[kLoads], lc[kLoads];
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int x = tid + m * kThreads;
    lj[m] = x < TK * C ? x / C : -1;
    lc[m] = x < TK * C ? x - lj[m] * C : 0;
  }
  auto load = [&](int i, int st) {
    const long long* ro = rowoff + tile_at(i) * TK;
    KT* kd = ks + (size_t)st * TK * RS;
    KT* vd = vs + (size_t)st * TK * RS;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      if (lj[m] < 0) continue;
      const long long off = ro[lj[m]];
      const bool read = off >= 0;
      const size_t at = (read ? (size_t)off : 0) + lc[m] * E;
      const int dst = lj[m] * RS + lc[m] * E;
      cp_async16(kd + dst, k + at, read);
      cp_async16(vd + dst, v + at, read);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load(i, i);
    cp_async_commit();
  }

  // Values: NV chunks of the (head, D) accumulators, RV threads per
  // chunk, each over every RV-th key of a tile.
  const int NV = gn * C;
  int RV = 1;
  while (2 * RV * NV <= kThreads && 2 * RV <= TK) RV *= 2;

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + kStages - 1 < ntiles)  // into the stage tile i - 1 used
      load(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = i % kStages;
    const int t0 = lo + tile_at(i) * TK;
    const KT* kt = ks + (size_t)st * TK * RS;
    const KT* vt = vs + (size_t)st * TK * RS;
    // Rows from tk on are past the length: not computed.
    const int tk = min(TK, vis.t_hi - t0);

    // Scores: NPAIR (head, key) pairs, R threads per pair.
    const int NPAIR = gn * tk;
    int R = 1;
    while (2 * R * NPAIR <= kThreads && 2 * R <= C) R *= 2;
    for (int w = tid; w < NPAIR * R; w += kThreads) {
      const int r = w / NPAIR, pr = w - r * NPAIR;
      const int g = pr / tk, j = pr - g * tk;
      const KT* kr = kt + j * RS;
      const float4* qr = reinterpret_cast<const float4*>(qs + g * QS);
      float sc = 0.f;
#pragma unroll 4
      for (int c = r; c < C; c += R) {
        Chunk<KT> kc;
        kc.load(kr + c * E);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = qr[(c * E + e) / 4];
          sc = fmaf(qv.x, kc.x[e], sc);
          sc = fmaf(qv.y, kc.x[e + 1], sc);
          sc = fmaf(qv.z, kc.x[e + 2], sc);
          sc = fmaf(qv.w, kc.x[e + 3], sc);
        }
      }
      spart[w] = sc;
    }
    __syncthreads();

    // Softmax: one warp per head, once per tile.
    for (int g = warp; g < gn; g += kWarps) {
      float sv[2], mt = repro::kNegInf;
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        ok[h] = j < tk && vis(t0 + j);
        sv[h] = 0.f;
        if (ok[h]) {
          float sc = 0.f;
          for (int r = 0; r < R; ++r) sc += spart[r * NPAIR + g * tk + j];
          if (p.softcap != 0.f) sc = tanhf(sc / p.softcap) * p.softcap;
          sv[h] = sc;
          mt = fmaxf(mt, sc);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        const float pj = ok[h] ? expf(sv[h] - m_new) : 0.f;
        if (j < tk) ps_[g * TK + j] = pj;
        psum += pj;
      }
      psum = repro::warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Values: each thread its chunks of the (head, D) accumulators.
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int w = tid + u * kThreads;
      if (w < NV * RV) {
        const int hv = w / NV, o = w - hv * NV;
        const int g = o / C, c = o - g * C;
        const float alpha = a_s[g];
        float* a = acc + u * E;
#pragma unroll
        for (int e = 0; e < E; ++e) a[e] *= alpha;
        const float* pw = ps_ + g * TK;
#pragma unroll 4
        for (int j = hv; j < tk; j += RV) {
          Chunk<KT> vc;
          vc.load(vt + j * RS + c * E);
          const float pj = pw[j];
#pragma unroll
          for (int e = 0; e < E; ++e) a[e] = fmaf(pj, vc.x[e], a[e]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (RV > 1) {  // sum the key groups in order, through the free stages
    float* red = reinterpret_cast<float*>(smem);
    const int NVR = NV * RV;
    if (tid < NVR)
#pragma unroll
      for (int e = 0; e < E; ++e) red[e * NVR + tid] = acc[e];
    __syncthreads();
    if (tid < NV)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = red[e * NVR + tid];
        for (int hv = 1; hv < RV; ++hv) x += red[e * NVR + hv * NV + tid];
        acc[e] = x;
      }
  }
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int o = tid + u * kThreads;
    if (o < NV) {
      const int g = o / C, c = o - g * C;
      const float* a = acc + u * E;
      if (p.splits == 1) {
        const float inv = inv_l(l_s[g]);
        QT* dst = out + ((size_t)b * p.H + kvh * p.G + g0 + g) * D + c * E;
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = repro::from_f32<QT>(a[e] * inv);
      } else {
        float4* dst = reinterpret_cast<float4*>(
            part + (slot * p.G + g0 + g) * D + c * E);
#pragma unroll
        for (int e = 0; e < E; e += 4)
          dst[e / 4] = make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]);
      }
    }
  }
  if (p.splits > 1 && tid < gn) {
    ml[(slot * p.G + g0 + tid) * 2] = m_s[tid];
    ml[(slot * p.G + g0 + tid) * 2 + 1] = l_s[tid];
  }
}

// One block per (sequence, query head, slice of up to 64 of D).  Thread
// (split group sg, 4-wide chunk c) folds the splits s = sg, sg + SG, ...
// in order into a running (m, l, acc); then the groups are folded in
// order: a fixed order, no atomics.
template <typename QT, typename KT, typename Layout>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part, const float* __restrict__ ml,
               const KT* __restrict__ v, Layout lay, QT* __restrict__ out,
               Params p) {
  __shared__ float4 red[kThreads];
  __shared__ float red_m[kThreads], red_l[kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / p.G, g = h - kvh * p.G;
  const int D = p.D, S = p.splits;
  const int d0 = blockIdx.y * kCombineSlice;
  const int nc = min(kCombineSlice, D - d0) / 4;  // 4-wide chunks
  const int SG = kThreads / nc;
  const int sg = tid / nc, c = tid - sg * nc;
  const size_t first = ((size_t)b * p.KV + kvh) * S;  // split 0's slot
  const float2* mlg = reinterpret_cast<const float2*>(ml) + first * p.G + g;
  const float4* src = reinterpret_cast<const float4*>(
      part + (first * p.G + g) * D + d0) + c;
  const size_t step = (size_t)p.G * D / 4;
  // Launched as a programmatic dependent of the split kernel: wait until
  // that grid has finished and its writes are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (sg < SG) {
    float m = repro::kNegInf, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = sg; s < S; s += SG) {
      const float2 x = mlg[(size_t)s * p.G];
      const float4 y = src[s * step];
      if (x.y > 0.f) {  // skip empty partials
        const float m_new = fmaxf(m, x.x);
        const float a = expf(m - m_new), w = expf(x.x - m_new);
        l = fmaf(x.y, w, l * a);
        acc.x = fmaf(y.x, w, acc.x * a);
        acc.y = fmaf(y.y, w, acc.y * a);
        acc.z = fmaf(y.z, w, acc.z * a);
        acc.w = fmaf(y.w, w, acc.w * a);
        m = m_new;
      }
    }
    red[tid] = acc;
    if (c == 0) {
      red_m[sg] = m;
      red_l[sg] = l;
    }
  }
  __syncthreads();
  float m = repro::kNegInf;
  for (int i = 0; i < SG; ++i)
    if (red_l[i] > 0.f) m = fmaxf(m, red_m[i]);

  QT* dst = out + ((size_t)b * p.H + h) * D + d0;
  if (m == repro::kNegInf) {  // no split holds a visible key
    if constexpr (Layout::kPaged) {
      lay.table += (size_t)b * p.NP;
      v += (size_t)kvh * p.ps * D;
    } else {
      v += ((size_t)b * p.n * p.KV + kvh) * D;
    }
    for (int d = tid; d < nc * 4; d += kThreads)
      dst[d] = repro::from_f32<QT>(mean_v<KT>(lay, v, p.n, d0 + d));
    return;
  }
  if (tid < nc) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int i = 0; i < SG; ++i) {
      if (red_l[i] > 0.f) {
        const float w = expf(red_m[i] - m);
        const float4 y = red[i * nc + tid];
        l = fmaf(red_l[i], w, l);
        a.x = fmaf(y.x, w, a.x);
        a.y = fmaf(y.y, w, a.y);
        a.z = fmaf(y.z, w, a.z);
        a.w = fmaf(y.w, w, a.w);
      }
    }
    const float inv = inv_l(l);
    dst[4 * tid] = repro::from_f32<QT>(a.x * inv);
    dst[4 * tid + 1] = repro::from_f32<QT>(a.y * inv);
    dst[4 * tid + 2] = repro::from_f32<QT>(a.z * inv);
    dst[4 * tid + 3] = repro::from_f32<QT>(a.w * inv);
  }
}

size_t split_smem(const Params& p, size_t kv_size, bool paged) {
  const size_t rows = (size_t)kStages * p.tile * (p.D + 16 / kv_size);
  const size_t pages = paged ? p.split / p.ps + 2 : 0;
  return 2 * rows * kv_size +
         sizeof(float) * ((size_t)p.heads * (p.D + 4) +
                          (size_t)(p.heads * p.tile > kThreads
                                       ? p.heads * p.tile : kThreads) +
                          (size_t)p.heads * p.tile + 3 * kMaxHeads) +
         sizeof(long long) * p.split + sizeof(int) * pages;
}

template <typename QT, typename KT, typename Layout>
int launch_split(const void* q, const void* k, const void* v, Layout lay,
                 const int* lengths, void* out, float* part, float* ml,
                 const Params& p, cudaStream_t st) {
  // What a block holds: a k tile's 16-byte chunks in kLoads a thread,
  // the heads' accumulators in kMaxAcc a thread.
  if (p.tile > 64 || p.split % p.tile || p.tile * p.C > kLoads * kThreads ||
      p.heads > kMaxHeads || p.heads * p.D > kMaxAcc * kThreads)
    return (int)cudaErrorInvalidValue;
  auto kern = decode_split<QT, KT, Layout>;
  const size_t smem = split_smem(p, sizeof(KT), Layout::kPaged);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = (p.G + p.heads - 1) / p.heads;
  const dim3 grid(p.splits, p.KV * chunks, p.B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lay, lengths, static_cast<QT*>(out), part,
      ml, p);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT, typename Layout>
int launch_combine(const float* part, const float* ml, const void* v,
                   Layout lay, void* out, const Params& p, cudaStream_t st) {
  // A programmatic dependent launch: the combine's blocks are scheduled
  // while the split kernel's last blocks run, which hides a launch.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.H, (p.D + kCombineSlice - 1) / kCombineSlice);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_combine<QT, KT, Layout>, part, ml,
      static_cast<const KT*>(v), lay, static_cast<QT*>(out), p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

Params params(int B, int H, int KV, int n, int D, int kv_size, int P, int ps,
              int NP, int split, int splits, int tile, int heads,
              float scale, int window, float softcap, int prefix) {
  Params p;
  p.B = B; p.H = H; p.KV = KV; p.G = H / KV; p.n = n;
  p.D = D; p.C = D * kv_size / 16;
  p.split = split; p.splits = splits; p.tile = tile; p.heads = heads;
  p.P = P; p.ps = ps; p.NP = NP;
  p.scale = scale; p.softcap = softcap; p.window = window; p.prefix = prefix;
  return p;
}

// Calls f with the (QT, KT) pair named by the flags and the layout named
// by the table (null: the dense cache).
template <typename F>
int dispatch(int q_bf16, int kv_bf16, const int* table, const Params& p,
             F f) {
  using bf = __nv_bfloat16;
  if (table) {
    const Paged lay{table, p.ps, p.P, p.D, (size_t)p.KV * p.ps * p.D};
    if (q_bf16 && kv_bf16) return f((bf*)0, (bf*)0, lay);
    if (q_bf16) return f((bf*)0, (float*)0, lay);
    if (kv_bf16) return f((float*)0, (bf*)0, lay);
    return f((float*)0, (float*)0, lay);
  }
  const Dense lay{(size_t)p.KV * p.D};
  if (q_bf16 && kv_bf16) return f((bf*)0, (bf*)0, lay);
  if (q_bf16) return f((bf*)0, (float*)0, lay);
  if (kv_bf16) return f((float*)0, (bf*)0, lay);
  return f((float*)0, (float*)0, lay);
}

}  // namespace

// The split kernel.  q: (B, H, D); dense (table null): k, v (B, n, KV, D);
// paged: k, v pages (P, KV, ps, D), table (B, NP) int32, n = NP * ps.
// lengths: (B,) int32; out: (B, H, D) in q's type, written when splits is
// 1; else part (B, KV, splits, G, D) f32 and ml (B, KV, splits, G, 2) f32.
// The caller guarantees H % KV == 0, D <= 256 with D * element size a
// multiple of 16 bytes, tile <= 64, split a multiple of tile, heads <= 8.
extern "C" int decode_split_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* part, void* ml, int q_bf16,
    int kv_bf16, int B, int H, int KV, int n, int D, int P, int ps, int NP,
    int split, int splits, int tile, int heads, float scale, int window,
    float softcap, int prefix, void* stream) {
  const Params p = params(B, H, KV, n, D, kv_bf16 ? 2 : 4, P, ps, NP, split,
                          splits, tile, heads, scale, window, softcap,
                          prefix);
  const int* lens = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  float* m = static_cast<float*>(ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(q_bf16, kv_bf16, static_cast<const int*>(table), p,
                  [&](auto* qt, auto* kt, auto lay) {
                    using QT = std::remove_pointer_t<decltype(qt)>;
                    using KT = std::remove_pointer_t<decltype(kt)>;
                    return launch_split<QT, KT>(q, k, v, lay, lens, out, pt,
                                                m, p, st);
                  });
}

// The combine kernel: part and ml as the split kernel wrote them; v and
// table as given to it (read only for rows with nothing visible).
extern "C" int decode_combine_launch(
    const void* part, const void* ml, const void* v, const void* table,
    void* out, int q_bf16, int kv_bf16, int B, int H, int KV, int n, int D,
    int P, int ps, int NP, int splits, void* stream) {
  const Params p = params(B, H, KV, n, D, kv_bf16 ? 2 : 4, P, ps, NP, 0,
                          splits, 0, 0, 0.f, 0, 0.f, 0);
  const float* pt = static_cast<const float*>(part);
  const float* m = static_cast<const float*>(ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(q_bf16, kv_bf16, static_cast<const int*>(table), p,
                  [&](auto* qt, auto* kt, auto lay) {
                    using QT = std::remove_pointer_t<decltype(qt)>;
                    using KT = std::remove_pointer_t<decltype(kt)>;
                    return launch_combine<QT, KT>(pt, m, v, lay, out, p, st);
                  });
}
