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
// Design: one block per (slice of kPS = 16 columns of P, head, sequence),
// 128 threads at kQ = 16 (seven blocks an SM, so a serving prefill's 768
// blocks run in one wave even where clusters of four reach only 124 SMs),
// 256 above.  The slices of a head, CS = 1, 2 or 4 of them (P up to
// 16, 32 or 64), form one thread-block cluster.  A block keeps its
// (16, N) slice of the state in shared memory through the whole chunk
// loop, and it goes to device memory once at the end.  The chunk is kQ
// in {16, 32, 64} tokens (a template parameter), chosen by
// kernels/ssd_scan.py::ssd_plan from the shapes: 16 rows for a 12-token
// prompt, and at long prompts the largest chunk whose two-stage ring
// still lets two blocks share an SM.  The result depends on the chunk
// only through rounding.  Per chunk:
//   0. the next chunk's x slice, B and C are in flight (cp.async, 16 bytes
//      a thread, two stages) and its dt in registers; rows past a ragged
//      tail arrive as zeros with dt = 0, which is exact (decay 1, no
//      contribution), as in the reference's padding;
//   1. every warp scans a_cum = cumsum(dt * A) over the chunk with
//      __shfl_up_sync (no thread works alone) into its own copy;
//   2. the decay block M[i][j] = (C_i · B_j) exp(a_cum_i - a_cum_j) dt_j
//      for j <= i (0 above the diagonal by selection: the exponent
//      overflows there) is cut by rows across the cluster: rank r computes
//      rows [r kQ/CS, (r+1) kQ/CS) and writes them into the shared memory
//      of every rank of its cluster (distributed shared memory), into one
//      of two buffers (one when the prompt is one chunk), so one cluster
//      barrier a chunk both publishes M and keeps the next chunk's writes
//      off the buffer still being read.
//      Recomputing M in every slice would repeat it CS times: at 2048
//      tokens (mamba2-780m, kQ = 32, N = 128, CS = 4) M is 32 x 32 x 128
//      = 131 k multiply-adds a chunk and head, and one slice's other
//      products 147 k, so a head's chunk costs 4 x 147 k + 131 k = 719 k
//      in place of 4 x (147 k + 131 k) = 1,112 k: 35% less.  (The C B^T
//      part could still be shared by the H/G heads of a group; it is
//      not.)  On sm_90 the barrier's release is a GPU-scope fence
//      (MEMBAR.ALL.GPU): about 1,500 cycles a chunk at 2048 tokens.
//   3. y_off = exp(a_cum_i) (C_i · state), skipped while the state is
//      known to be zero (the first chunk without an initial state);
//   4. after the cluster barrier: y = M x + y_off + D x for the rows that
//      exist, and the state update
//      state = exp(a_end) state + sum_j (x_j w_j) ⊗ B_j,
//      w_j = exp(a_end - a_cum_j) dt_j (skipped after the last chunk when
//      the caller does not want the state: y does not depend on it).
// Every product is a 4 x 4 register tile per thread fed by 16-byte shared
// loads: steps 2 and 3 load four float4 of each operand along the
// reduction for 64 multiply-adds (one load per 8 FFMA), step 4's M x
// loads 4 + 4 float4 for 64 (1 per 8), and the update two float4 for 16
// (1 per 8).  A 16-byte shared load costs a warp four passes of the SM's
// 128-byte-a-cycle port whatever the broadcast, so these tiles move 2
// bytes a multiply-add where the port gives 1: shared bandwidth, not the
// FMA units, sets each phase's time (PERF.md section 6); 8 x 8 tiles
// would halve it.  Short reductions split across the lanes of a warp and are
// summed by a fixed butterfly of shuffles, so every thread has work at
// kQ = 16 and sums are the same from run to run.  Rows of B, C and the
// state are padded by 16 bytes so that eight consecutive rows fall in
// distinct banks.  Tiles and loops stop at the chunk's valid rows.  x, dt,
// B and C are read in their native (B, S, ...) layout with a row stride:
// the model's column slices of one projection need no copy; where a
// pointer or stride is not 16-byte aligned the same staging copies element
// by element.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Threads a block: 128 at kQ = 16 (a serving prompt, where seven blocks
// share an SM), 256 above (one or two blocks an SM, whose chunk loop is a
// chain of dependent phases: more warps cut each phase's latency).
__host__ __device__ constexpr int threads_of(int kq) {
  return kq == 16 ? 128 : 256;
}
constexpr int kPS = 16;        // columns of P a block takes
constexpr int kMaxP = 64;      // columns of y / rows of the state held
constexpr int kMaxN = 128;     // state width held
constexpr int kMaxCluster = kMaxP / kPS;

// Blocks an SM must hold at each chunk length (the kernel's register
// cap): kernels/ssd_scan.py owns the numbers and passes them in.
#if !defined(SSD_BLOCKS_Q16) || !defined(SSD_BLOCKS_Q32) || \
    !defined(SSD_BLOCKS_Q64)
#error "build with the -D flags of kernels/ssd_scan.py NVCC_DEFINES"
#endif
template <int kQ>
constexpr int min_blocks() {
  return kQ == 16 ? SSD_BLOCKS_Q16 : kQ == 32 ? SSD_BLOCKS_Q32
                                              : SSD_BLOCKS_Q64;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Byte offsets of a block's shared memory; kernels/ssd_scan.py::_smem
// mirrors the total, and the launcher refuses a plan that disagrees.
struct Layout {
  int lds, ldm, ldb;  // row strides: state, M (floats); B and C (elements)
  size_t st, ms, xf, xw, yacc, dts, acw, br, cr, xr, total;
};

__host__ __device__ inline Layout layout(int kq, int N, int esz,
                                         int stages) {
  Layout L;
  const int per16 = 16 / esz;
  L.lds = round_up(N, 4) + 4;
  L.ldm = kq + 4;
  L.ldb = round_up(N, per16) + per16;
  size_t o = 0;
  L.st = o;   o += sizeof(float) * kPS * L.lds;
  L.ms = o;   o += sizeof(float) * stages * kq * L.ldm;  // M's buffers
  L.xf = o;   o += sizeof(float) * kPS * (kq + 4);  // x^T
  L.xw = o;   o += sizeof(float) * kq * kPS;
  L.yacc = o; o += sizeof(float) * kq * kPS;
  L.dts = o;  o += sizeof(float) * 2 * kq;
  L.acw = o;  o += sizeof(float) * threads_of(kq) / 32 * kq;
  L.br = o;   o += (size_t)esz * stages * kq * L.ldb;
  L.cr = o;   o += (size_t)esz * stages * kq * L.ldb;
  L.xr = o;   o += (size_t)esz * stages * kq * kPS;
  L.total = o;
  return L;
}

template <typename T>
struct Args {
  const T* x;
  const T* dt;
  const float* A;
  const float* D;
  const T* Bm;
  const T* Cm;
  const float* init;
  T* y;
  float* state_out;
  int S, H, P, G, N, cs, stages, aligned;
  long long x_rs, dt_rs, b_rs, c_rs;
};

// Four consecutive staged elements as float32 (16 or 8 bytes).
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
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a += x0 b0 + x1 b1 + x2 b2 + x3 b3, in that order.
__device__ __forceinline__ float dot4(float a, float4 x, float4 b) {
  a = fmaf(x.x, b.x, a);
  a = fmaf(x.y, b.y, a);
  a = fmaf(x.z, b.z, a);
  return fmaf(x.w, b.w, a);
}
__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
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

// Lanes per tile for `tiles` 4x4 tiles over a block of `threads`: a
// power of two, 1 when the tiles alone fill the block, at most 32.
__device__ __forceinline__ int split_of(int tiles, int threads) {
  int ks = 1;
  while (ks < 32 && tiles * ks * 2 <= threads) ks *= 2;
  return ks;
}

// Stage rows [c0, c0 + nq) of the chunk (kQ rows, zeros past nq): this
// block's x slice, and B and C of its group, as the input type.  Warps
// take rows and lanes the 16-byte pieces of a row: no division.
template <typename T, int kQ>
__device__ void stage(const Args<T>& a, const T* xb, const T* bb,
                      const T* cb, int col0, int c0, int nq, int ldb, T* xr,
                      T* br, T* cr, int tid) {
  constexpr int kWarps = threads_of(kQ) / 32;
  const int lane = tid & 31, warp = tid >> 5;
  if (a.aligned) {
    constexpr int per = 16 / sizeof(T);
    const int cpr = a.N / per;  // 16-byte pieces of a B or C row
    for (int i = warp; i < kQ; i += kWarps) {
      const bool ok = i < nq;
      const size_t row = (size_t)(c0 + (ok ? i : 0));
      for (int k = lane; k < cpr; k += 32) {
        cp16(br + i * ldb + k * per, bb + row * a.b_rs + k * per, ok);
        cp16(cr + i * ldb + k * per, cb + row * a.c_rs + k * per, ok);
      }
    }
    constexpr int xc = kPS / per;  // pieces of a row of the x slice
    for (int e = tid; e < kQ * xc; e += threads_of(kQ)) {
      const int i = e / xc, k = e - i * xc;
      const int col = col0 + k * per;
      const bool ok = i < nq && col < a.P;
      const size_t row = (size_t)(c0 + (ok ? i : 0));
      cp16(xr + i * kPS + k * per, xb + row * a.x_rs + (ok ? col : 0), ok);
    }
    cp_commit();
    return;
  }
  const int n4 = round_up(a.N, 4);
  const T zero = repro::from_f32<T>(0.f);
  for (int i = warp; i < kQ; i += kWarps) {
    const size_t row = (size_t)(c0 + i);
    for (int n = lane; n < n4; n += 32) {
      const bool ok = i < nq && n < a.N;
      br[i * ldb + n] = ok ? bb[row * a.b_rs + n] : zero;
      cr[i * ldb + n] = ok ? cb[row * a.c_rs + n] : zero;
    }
  }
  for (int e = tid; e < kQ * kPS; e += threads_of(kQ)) {
    const int i = e / kPS, p = e - i * kPS;
    const bool ok = i < nq && col0 + p < a.P;
    xr[e] = ok ? xb[(size_t)(c0 + i) * a.x_rs + col0 + p] : zero;
  }
}

template <typename T, int kQ>
__global__ void __launch_bounds__(threads_of(kQ), min_blocks<kQ>())
ssd_cluster(const Args<T> a) {
  constexpr int kThreads = threads_of(kQ), kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, N = a.N, P = a.P, cs = a.cs;
  const int n4 = round_up(N, 4);
  const Layout L = layout(kQ, N, sizeof(T), a.stages);
  const int lds = L.lds, ldm = L.ldm, ldb = L.ldb;
  float* st = reinterpret_cast<float*>(smem + L.st);      // [kPS][lds]
  float* ms = reinterpret_cast<float*>(smem + L.ms);  // [stages][kQ][ldm]
  // x as float32, transposed: step 4's M x reads 16-byte pieces along j,
  // eight lanes of a quarter-warp in one row, so in distinct banks.
  float* xt = reinterpret_cast<float*>(smem + L.xf);      // [kPS][kQ + 4]
  // x_j w_j for the update, rows of 16: lanes 2 rows apart in distinct
  // banks.
  float* xw = reinterpret_cast<float*>(smem + L.xw);      // [kQ][kPS]
  constexpr int ldt = kQ + 4;
  float* yacc = reinterpret_cast<float*>(smem + L.yacc);  // [kQ][kPS]
  float* dts = reinterpret_cast<float*>(smem + L.dts);    // [2][kQ]
  float* acw = reinterpret_cast<float*>(smem + L.acw) + warp * kQ;
  T* br = reinterpret_cast<T*>(smem + L.br);  // [stages][kQ][ldb]
  T* cr = reinterpret_cast<T*>(smem + L.cr);
  T* xr = reinterpret_cast<T*>(smem + L.xr);  // [stages][kQ][kPS]
  float* rms[kMaxCluster];  // M's buffer 0 in each rank of the cluster
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    rms[r] = r < cs ? cluster.map_shared_rank(ms, r) : ms;

  const int g = h / (a.H / a.G), col0 = rank * kPS;
  const float a_h = a.A[h], d_h = a.D[h];
  const size_t soff = ((size_t)b * a.H + h) * P * N;
  const T* xb = a.x + (size_t)b * S * a.x_rs + (size_t)h * P;
  const T* dtb = a.dt + (size_t)b * S * a.dt_rs + h;
  const T* bb = a.Bm + (size_t)b * S * a.b_rs + (size_t)g * N;
  const T* cb = a.Cm + (size_t)b * S * a.c_rs + (size_t)g * N;
  const int nchunks = (S + kQ - 1) / kQ;
  const bool have_init = a.init != nullptr;

  // Every block of the cluster must run before any writes into another's
  // shared memory: arrive now, wait before the first chunk's M.
  cluster_arrive_relaxed();
  const float dt0 = tid < min(kQ, S)
      ? repro::to_f32(dtb[(size_t)tid * a.dt_rs]) : 0.f;
  stage<T, kQ>(a, xb, bb, cb, col0, 0, min(kQ, S), ldb, xr, br, cr, tid);
  if (have_init) {  // warps take rows of the slice, lanes columns
    for (int p = warp; p < kPS; p += kWarps)
      for (int n = lane; n < n4; n += 32)
        st[p * lds + n] = (col0 + p < P && n < N)
            ? a.init[soff + (size_t)(col0 + p) * N + n] : 0.f;
  }
  if (tid < kQ) dts[tid] = dt0;

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * kQ, nq = min(kQ, S - c0);
    const int sb = a.stages == 2 ? (c & 1) : 0;  // staging buffer
    const T* bsm = br + (size_t)sb * kQ * ldb;
    const T* csm = cr + (size_t)sb * kQ * ldb;
    const T* xsm = xr + (size_t)sb * kQ * kPS;
    const float* d = dts + (c & 1) * kQ;
    float* mloc = ms + (c & 1) * kQ * ldm;
    const int moff = (c & 1) * kQ * ldm;
    cp_wait_all();
    __syncthreads();  // chunk c staged; chunk c-1 consumed
    if (c == 0) cluster_wait();
    float dnext = 0.f;
    if (c + 1 < nchunks) {
      const int c1 = c0 + kQ, nq1 = min(kQ, S - c1);
      stage<T, kQ>(a, xb, bb, cb, col0, c1, nq1, ldb,
                   xr + (size_t)(sb ^ 1) * kQ * kPS,
                   br + (size_t)(sb ^ 1) * kQ * ldb,
                   cr + (size_t)(sb ^ 1) * kQ * ldb, tid);
      if (tid < nq1) dnext = repro::to_f32(dtb[(size_t)(c1 + tid) * a.dt_rs]);
    }

    // 1. The cumulative log decay, in every warp, into its own copy.
    if (kQ <= 32) {
      float v = lane < kQ ? d[lane] * a_h : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (lane < kQ) acw[lane] = v;
    } else {
      const float v0 = d[2 * lane] * a_h, v1 = d[2 * lane + 1] * a_h;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      float ex = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) ex = 0.f;
      acw[2 * lane] = ex + v0;
      acw[2 * lane + 1] = (ex + v0) + v1;
    }
    __syncwarp();
    const float a_end = acw[kQ - 1];  // = a_cum of the last valid row
    const bool zero_state = c == 0 && !have_init;

    // 2. This rank's rows of M, written into every rank's buffer.
    {
      constexpr int cgs = kQ / 4;
      const int R = kQ / cs, rgs = R / 4, tiles = rgs * cgs;
      const int ks = split_of(tiles, kThreads), items = tiles * ks;
      for (int base = 0; base < items; base += kThreads) {
        const int item = base + tid;
        const bool active = item < items;
        const int s = item % ks, t = item / ks;
        const int rg = t % rgs, cgi = t / rgs;
        const int i0 = rank * R + rg;
        float v[16] = {};
        if (active && i0 < nq && cgi < nq) {
          for (int n = 4 * s; n < n4; n += 4 * ks) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              cv[q] = ld4(csm + (i0 + rgs * q) * ldb + n);
              bv[q] = ld4(bsm + (cgi + cgs * q) * ldb + n);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                v[q * 4 + r] = dot4(v[q * 4 + r], cv[q], bv[r]);
          }
        }
        int first;
        const int cnt = group_sum(v, ks, lane, &first);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (!active || e >= cnt) continue;
          const int idx = first + e;
          const int i = i0 + rgs * (idx >> 2), j = cgi + cgs * (idx & 3);
          const float m = (j <= i && i < nq)
              ? v[e] * expf(acw[i] - acw[j]) * d[j] : 0.f;
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < cs) rms[r][moff + i * ldm + j] = m;
        }
      }
    }

    // 3. exp(a_cum_i) (C_i · state) for this block's columns.
    if (!zero_state) {
      constexpr int rgs = kQ / 4, tiles = rgs * (kPS / 4);
      constexpr int ks = kThreads / tiles;  // a constant: less code
      const int s = tid % ks, t = tid / ks;
      const int rg = t % rgs, pg = t / rgs;
      float v[16] = {};
      if (rg < nq) {
        for (int n = 4 * s; n < n4; n += 4 * ks) {
          float4 cv[4], sv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cv[q] = ld4(csm + (rg + rgs * q) * ldb + n);
            sv[q] = ld4(st + (pg + 4 * q) * lds + n);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              v[q * 4 + r] = dot4(v[q * 4 + r], cv[q], sv[r]);
        }
      }
      int first;
      const int cnt = group_sum(v, ks, lane, &first);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e >= cnt) continue;
        const int idx = first + e;
        const int i = rg + rgs * (idx >> 2), p = pg + 4 * (idx & 3);
        yacc[i * kPS + p] = expf(acw[i]) * v[e];
      }
    }

    // x as float32, and x_j w_j for the update.
    for (int e = tid; e < kQ * kPS; e += kThreads) {
      const int j = e / kPS, p = e - j * kPS;
      const float xv = repro::to_f32(xsm[e]);
      xt[p * ldt + j] = xv;
      xw[j * kPS + p] = xv * (expf(a_end - acw[j]) * d[j]);
    }
    cluster.sync();  // M published; x tiles and y_off written

    // 4a. y = M x + y_off + D x.
    {
      constexpr int rgs = kQ / 4, tiles = rgs * (kPS / 4);
      constexpr int ks = kThreads / tiles;
      const int s = tid % ks, t = tid / ks;
      const int rg = t % rgs, pg = t / rgs;
      const int jend = min(nq, rg + rgs * 3 + 1);
      float v[16] = {};
      if (rg < nq) {
        for (int j = 4 * s; j < jend; j += 4 * ks) {
          float4 mv[4], xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mv[q] = ld4(mloc + (rg + rgs * q) * ldm + j);
            xv[q] = ld4(xt + (4 * pg + q) * ldt + j);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              v[q * 4 + r] = dot4(v[q * 4 + r], mv[q], xv[r]);
        }
      }
      int first;
      const int cnt = group_sum(v, ks, lane, &first);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e >= cnt) continue;
        const int idx = first + e;
        const int i = rg + rgs * (idx >> 2), p = 4 * pg + (idx & 3);
        if (i >= nq || col0 + p >= P) continue;
        float yv = v[e];
        if (!zero_state) yv += yacc[i * kPS + p];
        yv = fmaf(d_h, xt[p * ldt + i], yv);
        a.y[(((size_t)b * S + c0 + i) * a.H + h) * P + col0 + p] =
            repro::from_f32<T>(yv);
      }
    }

    // 4b. The state, decayed to the chunk's end, plus the chunk's inputs.
    if (c + 1 < nchunks || a.state_out) {
      const float dec = expf(a_end);
      const int tiles = n4;  // 4 column groups of the slice x n4 / 4
      const int ks = split_of(tiles, kThreads), items = tiles * ks;
      for (int base = 0; base < items; base += kThreads) {
        const int item = base + tid;
        const bool active = item < items;
        const int s = item % ks, t = item / ks;
        const int pg = t & 3, ng = t >> 2;
        float v[16] = {};
        if (active) {
          for (int j = s; j < nq; j += ks) {
            const float4 xv = ld4(xw + j * kPS + 4 * pg);
            const float4 bv = ld4(bsm + j * ldb + 4 * ng);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                v[q * 4 + r] = fmaf(comp(xv, q), comp(bv, r), v[q * 4 + r]);
          }
        }
        int first;
        const int cnt = group_sum(v, ks, lane, &first);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (!active || e >= cnt) continue;
          const int idx = first + e;
          float* sp = st + (4 * pg + (idx >> 2)) * lds + 4 * ng + (idx & 3);
          *sp = zero_state ? v[e] : fmaf(dec, *sp, v[e]);
        }
      }
    }
    if (c + 1 < nchunks && tid < kQ) dts[((c + 1) & 1) * kQ + tid] = dnext;
  }
  if (a.state_out) {  // warps take rows of the slice, lanes columns
    __syncthreads();
    for (int p = warp; p < kPS && col0 + p < P; p += kWarps) {
      float* out = a.state_out + soff + (size_t)(col0 + p) * N;
      const float* src = st + p * lds;
      if (N % 4 == 0) {  // rows of whole float4: 16-byte stores
        for (int n = 4 * lane; n < N; n += 128)
          *reinterpret_cast<float4*>(out + n) = ld4(src + n);
      } else {
        for (int n = lane; n < N; n += 32) out[n] = src[n];
      }
    }
  }
}

template <typename T, int kQ>
int launch(const Args<T>& a, int B, size_t smem, cudaStream_t st) {
  auto kernel = ssd_cluster<T, kQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // All of the SM's shared memory, so that the plan's blocks fit.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs, a.H, B);
  cfg.blockDim = dim3(threads_of(kQ));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch_q(const Args<T>& a, int B, int kq, size_t smem, cudaStream_t st) {
  if (kq == 16) return launch<T, 16>(a, B, smem, st);
  if (kq == 32) return launch<T, 32>(a, B, smem, st);
  return launch<T, 64>(a, B, smem, st);
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N): element [b, s, ...]
// of each at row (b * S + s) times its row stride (in elements), the rest
// of the row contiguous.  A, D (H,) float32; init (B, H, P, N) float32 or
// null; y (B, S, H, P) contiguous; state_out (B, H, P, N) or null.  The
// plan (kq, cs, stages, smem) is kernels/ssd_scan.py::ssd_plan's; aligned:
// x, Bm and Cm, their row strides, P and N are whole multiples of 16 bytes
// (the cp.async path).  Returns the CUDA error of the launch; a shape or
// plan the kernel cannot take is cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* D, const void* Bm, const void* Cm,
                               const void* init, void* y, void* state_out,
                               int bf16, int B, int S, int H, int P, int G,
                               int N, long long x_rs, long long dt_rs,
                               long long b_rs, long long c_rs, int kq, int cs,
                               int stages, long long smem, int aligned,
                               void* stream) {
  const int esz = bf16 ? 2 : 4;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G ||
      S < 1 || B < 1 || (kq != 16 && kq != 32 && kq != 64) ||
      cs != (P <= kPS ? 1 : P <= 2 * kPS ? 2 : 4) ||
      stages != (S > kq ? 2 : 1) ||
      (size_t)smem != layout(kq, N, esz, stages).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                    static_cast<const float*>(A), static_cast<const float*>(D),
                    static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                    static_cast<const float*>(init), static_cast<T*>(y),
                    static_cast<float*>(state_out), S, H, P, G, N, cs, stages,
                    aligned, x_rs, dt_rs, b_rs, c_rs};
    return launch_q<T>(a, B, kq, (size_t)smem, st);
  }
  const Args<float> a{static_cast<const float*>(x),
                      static_cast<const float*>(dt),
                      static_cast<const float*>(A),
                      static_cast<const float*>(D),
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm),
                      static_cast<const float*>(init), static_cast<float*>(y),
                      static_cast<float*>(state_out), S, H, P, G, N, cs,
                      stages, aligned, x_rs, dt_rs, b_rs, c_rs};
  return launch_q<float>(a, B, kq, (size_t)smem, st);
}
