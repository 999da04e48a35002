// ssd_scan_bwd for Hopper: the gradients of the Mamba-2 state-space-duality
// scan that ssd_scan.cu computes,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
//   y_t = C_t · h_t + D * x_t,
// for x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) in one type
// (float32 or bfloat16), each group of B and C shared by H/G heads; A and D
// (H,) float32; an optional initial state (B, H, P, N) float32.  Given dy
// (B, S, H, P) in x's type and, optionally, the cotangent of the final
// state (B, H, P, N) float32, it writes dx, ddt, dB and dC in the inputs'
// type, dA and dD float32, and the initial state's gradient float32.  Every
// sum is float32.
//
// The function it differentiates is src/repro/kernels/ssd_scan.py:83
// ssd_scan (its Pallas kernel, pallas_call at :137, has no backward; the
// reference trains through jax.grad of the chunked form,
// src/repro/kernels/ref.py ssd_scan_chunked).  The port's models run their
// scan through ssd_scan.cu, so training on the card needs its gradient
// from a kernel too.
//
// What bounds it on the H100: the bytes.  The least work is the
// sequential form's backward, per token and head: the state cotangent's
// step g = e^a g' + dy ⊗ C (3 P N), dC = h^T dy, dx = dt g B, dB = dt g^T x
// and d(a) = e^a <g, h> (2 P N each), and dx's skip term, dD and ddt's
// x . (g B) (2 P each): 11 P N + 6 P; plus the sums of dB and dC over the
// H/G heads of a group, 2 N (H - G) a token.  At mamba2-780m's training
// shape (4 x 1024 tokens, 48 heads, P 64, N 128) that is 17.8 GFLOP, 0.018
// ms at the bf16 peak; the bytes (x, dt, B, C and dy read, the gradients
// written) are 80 MB in bf16, 0.024 ms.  The chunked form below does 29.0
// GFLOP there (the decay block's Q^2 terms; 77.3 on the tensor cores with
// the splits) and moves its chunk states through device memory.
//
// Design: the chunked form needs only two things from outside a chunk, its
// entry state h_c and the cotangent of its exit state g_{c+1}; everything
// else (a = cumsum(dt A) restarts at every chunk) is the chunk's own.  So
// a call is four kernels on one stream, none with atomics:
//   1. ssd_bwd_local, one block a (head, chunk, sequence), two an SM: a by
//      a warp scan, then the chunk's own state S_c = sum_j (w x)_j ⊗ B_j
//      (w_j = e^{a_end - a_j} dt_j) and the backward's T_c = sum_i (e^a
//      dy)_i ⊗ C_i, each (P, N) float32 into a scratch buffer, and a_end.
//   2. ssd_bwd_scan, one thread a float4 of a (sequence, head)'s (P, N),
//      sequential over chunks only, kAhead chunks' loads in flight:
//      h_{c+1} = e^{a_end} h_c + S_c seeded by the initial state, and g_c =
//      e^{a_end} g_{c+1} + T_c seeded by the final state's cotangent,
//      written in place over S and T (chunk c's slot then holds h_c and
//      g_{c+1}); g_0 is the initial state's gradient.
//   3. ssd_bwd_grads, one block a (head, chunk, sequence), one an SM, the
//      heads of a group in thread-block clusters of `cs` (the largest
//      divisor of H/G up to 8).  With h_c and g_{c+1} in shared memory:
//      A. CB = C B^T and dM = dy x^T (16 x 32 tiles, one a warp; a tile
//         above the diagonal skipped), and in the same registers, with
//         L_ij = e^{a_i - a_j} for j <= i < nq (selected, never multiplied
//         by a mask: the exponent overflows above the diagonal), M = CB L
//         dt_j and W = dM L dt_j into shared memory, and F = dM CB L summed
//         by row (times dt_j) and by column in a fixed order;
//      B. dx_j = w_j (g B)_j + sum_i M_ij dy_i + D dy_j, with x_j . (g B)_j
//         from the first product's registers;
//      C. dC_i = e^{a_i} (dy h)_i + sum_j W_ij B_j, with C_i . (dy h)_i;
//         dB_j = w_j (x g)_j + sum_i W_ij C_i; held in registers until h
//         and g are free, then written over them;
//      D. (warp 0, while the cluster's other blocks arrive) d(a) per row
//         (F's row sum minus dt_i times its column sum, e^{a_i} C_i . Z_i,
//         -w_i x_i . gB_i, and on the last valid row e^{a_end} <g, h> and
//         the sum of the w_j x_j . gB_j), its reverse cumulative sum R by a
//         warp scan, ddt_m = sum_i F_im + e^{a_end - a_m} x_m . gB_m + A
//         R_m, and the chunk's dD (dy . x) and dA partials.  dA = sum_m
//         dt_m R_m = sum_i d(a)_i c_i (c = cumsum(dt)) is taken term by
//         term: F's share as sum_{j <= i} F_ij dt_j (c_i - c_j) in A, since
//         its row sums minus dt times its column sums are terms up to 50
//         times larger than dA that cancel and take dA's last digits;
//      E. dB and dC summed over the cluster's heads through distributed
//         shared memory, in rank order, into a (B, S, H/cs, N) float32
//         partial.
//   4. ssd_bwd_reduce: the partials of dB and dC over each group's
//      clusters, dA and dD over the sequences and chunks, in a fixed order.
//
// Products.  A warp computes a tile of 16 MI x 8 NJ outputs over k in the
// registers laid out as mma.sync's accumulator (`mm` below).
// * bf16 calls: mma.sync.m16n8k16 bf16 -> f32, every fragment by ldmatrix
//   (.trans where it is read transposed).  An operand that is a bf16 input
//   (x, dy, B or C) is staged by 16-byte cp.async.  Every product has at
//   most one float32 operand (the states h and g, the decay-weighted M and
//   W, w x and e^a dy), and that operand is kept in shared memory split
//   exactly into three bf16 pieces (hi + mid + lo = its 24 significant
//   bits; split once, where it is staged or computed): each piece's
//   product with the bf16 operand is exact in the float32 accumulator, so
//   the result carries float32 rounding, not bf16's.  Three mma where an
//   operand is split, one for C B^T and dy x^T.
// * float32 calls: the same grid and kernels with the products on the
//   CUDA cores, every operand float32 in shared memory, each thread summing
//   its 4 MI NJ outputs of the warp tile across k in registers.
// The launcher routes by the call's type (a design split by type, not a
// fallback).  What holds the gradient kernel back on the card: one block
// an SM (the pieces of h, g, M and W take 160 KB at mamba2-780m's shape),
// so nothing overlaps its staging, about a quarter of its time; then the
// products, the cluster barrier and warp 0's part D.  The chunk states
// cross device memory six times (written, read and rewritten by the scans,
// read), 600 MB at mamba2-780m's shape.
//
// Rows past a ragged tail are never read: they stage as zeros with dt = 0
// (which gives them no gradient, as the reference's padding does) and are
// never written.  P and N are padded to multiples of 32 with zeros, the
// chunk to at least 32 rows.  No atomics: every sum runs in a fixed order,
// so two calls are bit-equal.  x, dt, B and C are read in their native (B,
// S, ...) layout with a row stride, as the forward reads them (the model's
// column slices of one projection need no copy).  kernels/ssd_scan.py::
// ssd_bwd_plan mirrors both chunk kernels' shared bytes, the chunk and the
// cluster, and the launcher refuses a plan that disagrees with the layouts
// here.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxCluster = 8;
constexpr int kMaxQ = 64;
constexpr int kVecs = 7;       // per-row vectors of the gradient kernel
constexpr int kLocalVecs = 6;  // of the local kernel
constexpr int kRowParts = 4;   // column tiles of a row's partial sums
// Partial sums of F's rows (by 32-column tile) and columns (by 16-row tile).
constexpr int kFRowParts = kMaxQ / 32, kFColParts = kMaxQ / 16;

__host__ __device__ inline int pad32(int n) { return (n + 31) / 32 * 32; }

// A chunk kernel's tiles: rows Qp (the chunk, at least 32), columns PP and
// NP (P and N padded to 32), and the row strides (elements) of its tiles:
// x, dy and w x, e^a dy by ldx; B and C by ldb; h and g (and, after the
// products, the dC and dB partials) by ldh; M and W by ldq.  A bf16 row of
// 16 B more than a multiple of 128 B keeps ldmatrix free of bank conflicts.
struct Geo {
  int Qp, PP, NP, ldx, ldb, ldh, ldq;
};

__host__ __device__ inline Geo geo(int kq, int P, int N) {
  Geo g;
  g.Qp = kq < 32 ? 32 : kq;
  g.PP = pad32(P);
  g.NP = pad32(N);
  g.ldx = g.PP + 8;
  g.ldb = g.NP + 8;
  g.ldh = g.NP + 8;
  g.ldq = g.Qp + 8;
  return g;
}

// Byte offsets of the gradient kernel's shared memory (esz: the inputs'
// element size); kernels/ssd_scan.py::_bwd_smem mirrors the total.  The
// float32 operands h, g (P, N) and M, W (Q, Q) are kept as three bf16
// pieces (hi, mid, lo: `piece` elements apart) on the tensor-core path
// (esz 2), as float32 on the CUDA cores; both with the row strides of
// Geo.  After the products h's and g's regions take the block's dC and dB
// as float32 (Q, ldh).
struct GradLayout {
  Geo g;
  int hpiece, mpiece;  // elements between two pieces of h (and g), M (W)
  size_t h, gs, xs, dys, bs, cs, mb, wb, vec, total;
};

__host__ __device__ inline GradLayout grads_layout(int kq, int P, int N,
                                                   int esz) {
  GradLayout L;
  L.g = geo(kq, P, N);
  const int Qp = L.g.Qp;
  const int rh = L.g.PP > Qp ? L.g.PP : Qp;  // h's rows, then dC's
  const size_t fsz = esz == 2 ? 3 * 2 : 4;   // bytes of a float32 element
  L.hpiece = rh * L.g.ldh;
  L.mpiece = Qp * L.g.ldq;
  size_t o = 0;
  L.h = o;   o += fsz * L.hpiece;
  L.gs = o;  o += fsz * L.hpiece;
  L.xs = o;  o += (size_t)esz * Qp * L.g.ldx;
  L.dys = o; o += (size_t)esz * Qp * L.g.ldx;
  L.bs = o;  o += (size_t)esz * Qp * L.g.ldb;
  L.cs = o;  o += (size_t)esz * Qp * L.g.ldb;
  L.mb = o;  o += fsz * L.mpiece;
  L.wb = o;  o += fsz * L.mpiece;
  L.vec = o;
  o += sizeof(float) * ((size_t)(kVecs + kFRowParts + kFColParts +
                                 2 * kRowParts) * Qp + 32);
  L.total = o;
  return L;
}

// The local kernel's: w x and e^a dy (Q, ldx) as three bf16 pieces (Q
// ldx elements apart) on the tensor-core path, float32 on the CUDA cores;
// x, dy (Q, ldx) and B, C (Q, ldb) in the inputs' type; the vectors.
struct LocalLayout {
  Geo g;
  int piece;  // elements between two pieces of w x (and of e^a dy)
  size_t wx, edy, xs, dys, bs, cs, vec, total;
};

__host__ __device__ inline LocalLayout local_layout(int kq, int P, int N,
                                                    int esz) {
  LocalLayout L;
  L.g = geo(kq, P, N);
  const int Qp = L.g.Qp;
  const size_t fsz = esz == 2 ? 3 * 2 : 4;
  L.piece = Qp * L.g.ldx;
  size_t o = 0;
  L.wx = o;  o += fsz * L.piece;
  L.edy = o; o += fsz * L.piece;
  L.xs = o;  o += (size_t)esz * Qp * L.g.ldx;
  L.dys = o; o += (size_t)esz * Qp * L.g.ldx;
  L.bs = o;  o += (size_t)esz * Qp * L.g.ldb;
  L.cs = o;  o += (size_t)esz * Qp * L.g.ldb;
  L.vec = o; o += sizeof(float) * (size_t)kLocalVecs * Qp;
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
  const T* dy;
  const float* dstate;
  float* st;    // (B, H, chunks, PP, NP): S_c, then h_c
  float* ct;    // the same: T_c, then g_{c+1}
  float* aend;  // (B, H, chunks)
  T* dx;
  T* ddt;
  float* dBc;  // (B, S, H / cs, N): dB summed over a cluster's heads
  float* dCc;
  float* dAp;  // (B, H, chunks)
  float* dDp;
  float* dinit;
  int S, H, P, G, N, kq, cs, nc, vec;
  long long x_rs, dt_rs, b_rs, c_rs;
};

// ---------------------------------------------------------------------------
// Shared-memory staging and the warp-level products.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sptr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
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
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The pair (x, y) as three bf16 pairs whose sum is (x, y) exactly: hi,
// then mid = bf16(x - hi), then lo = bf16(x - hi - mid); x in the low
// half.  Each residual is exact in float32, and the three pieces hold the
// 24 significant bits of a float32.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// Rows [0, rows) of `wpad` elements of a (B, S, ...) operand into shared
// memory (row stride ld): row r is src[r * rs ..], zero past `nq` rows and
// past `width` columns; by 16-byte cp.async where vec, else element by
// element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long rs, int nq, int rows,
                                      int width, int wpad, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int ch = wpad / V;
  for (int e = threadIdx.x; e < rows * ch; e += kThreads) {
    const int r = e / ch, c = (e - r * ch) * V;
    T* d = dst + r * ld + c;
    if (vec) {
      const bool ok = r < nq && c < width;
      cp16(d, ok ? src + (size_t)r * rs + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = r < nq && c + j < width ? src[(size_t)r * rs + c + j]
                                       : repro::from_f32<T>(0.f);
    }
  }
}

// The (PP, NP) float32 state of a chunk from scratch into shared memory.
__device__ __forceinline__ void stage_state(float* dst, int ld,
                                            const float* src, int PP,
                                            int NP) {
  const int ch = NP / 4;
  for (int e = threadIdx.x; e < PP * ch; e += kThreads) {
    const int r = e / ch, c = (e - r * ch) * 4;
    cp16(dst + r * ld + c, src + (size_t)r * NP + c, true);
  }
}

// A product's operand in shared memory: its element (i, j) (A: row, k; B:
// k, column) at p[i * ld + j], or at p[j * ld + i] where CM.
template <typename E, bool CM>
struct Op {
  const E* p;
  int ld;
  __device__ __forceinline__ float at(int i, int j) const {
    return repro::to_f32(CM ? p[j * ld + i] : p[i * ld + j]);
  }
};
template <bool CM, typename E>
__device__ __forceinline__ Op<E, CM> op(const E* p, int ld) {
  return Op<E, CM>{p, ld};
}
// Pieces a fragment of the operand splits into on the tensor cores.
template <class O>
struct Pieces;
template <bool CM>
struct Pieces<Op<bf16, CM>> {
  static constexpr int n = 1;
};
// A float32 operand kept as three bf16 pieces (hi, mid, lo) `ps` elements
// apart, each a tile like Op<bf16, CM>.
template <bool CM>
struct Op3 {
  const bf16* p;
  int ld, ps;
};
template <bool CM>
struct Pieces<Op3<CM>> {
  static constexpr int n = 3;
};
// The gradient kernel's float32 operands: pieces on the tensor cores,
// float32 on the CUDA cores (same region, same row stride).
template <bool TC, bool CM>
__device__ __forceinline__ auto fop(const void* p, int ld, int ps) {
  if constexpr (TC)
    return Op3<CM>{static_cast<const bf16*>(p), ld, ps};
  else
    return Op<float, CM>{static_cast<const float*>(p), ld};
}

// A's 16 x 16 fragment at (r0, k0): a bf16 operand by ldmatrix ...
template <bool CM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[1][4],
                                       const Op<bf16, CM>& A, int r0, int k0,
                                       int lane) {
  if (CM)
    ldsm_t(a[0], sptr(A.p + (k0 + (lane & 7) + (lane >> 4) * 8) * A.ld + r0 +
                      ((lane >> 3) & 1) * 8));
  else
    ldsm(a[0], sptr(A.p + (r0 + (lane & 15)) * A.ld + k0 + (lane >> 4) * 8));
}
// ... a piecewise one by ldmatrix, a piece at a time.
template <bool CM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], const Op3<CM>& A,
                                       int r0, int k0, int lane) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    uint32_t r[1][4];
    frag_a(r, Op<bf16, CM>{A.p + q * A.ps, A.ld}, r0, k0, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[q][e] = r[0][e];
  }
}
// B's fragments at (k0, c0) for NJ tiles of 8 columns: a bf16 operand by
// ldmatrix, two tiles a load ...
template <int NJ, bool CM>
__device__ __forceinline__ void frag_b(uint32_t (&b)[NJ][1][2],
                                       const Op<bf16, CM>& B, int k0, int c0,
                                       int lane) {
  static_assert(NJ % 2 == 0, "bf16 B fragments come in pairs of tiles");
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    uint32_t r[4];
    if (CM)
      ldsm(r, sptr(B.p + (c0 + 8 * j + (lane & 7) + (lane >> 4) * 8) * B.ld +
                   k0 + ((lane >> 3) & 1) * 8));
    else
      ldsm_t(r, sptr(B.p + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * B.ld +
                     c0 + 8 * j + (lane >> 4) * 8));
    b[j][0][0] = r[0];
    b[j][0][1] = r[1];
    b[j + 1][0][0] = r[2];
    b[j + 1][0][1] = r[3];
  }
}
// ... a piecewise one by ldmatrix, a piece at a time.
template <int NJ, bool CM>
__device__ __forceinline__ void frag_b(uint32_t (&b)[NJ][3][2],
                                       const Op3<CM>& B, int k0, int c0,
                                       int lane) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    uint32_t r[NJ][1][2];
    frag_b<NJ>(r, Op<bf16, CM>{B.p + q * B.ps, B.ld}, k0, c0, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      b[j][q][0] = r[j][0][0];
      b[j][q][1] = r[j][0][1];
    }
  }
}

// acc += A B for the warp's tile: rows r0 + [0, 16 MI), columns c0 + [0, 8
// NJ), k in [0, K) (a multiple of 16).  Tensor cores: the smaller pieces
// first.
template <int MI, int NJ, class OA, class OB>
__device__ __forceinline__ void mm_tc(float (&acc)[MI][NJ][4], int r0, int c0,
                                      int K, const OA& A, const OB& B) {
  constexpr int NA = Pieces<OA>::n, NB = Pieces<OB>::n;
  static_assert(NA * NB <= 3, "at most one operand is split");
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MI][NA][4], b[NJ][NB][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) frag_a(a[i], A, r0 + 16 * i, k0, lane);
    frag_b<NJ>(b, B, k0, c0, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int pa = NA - 1; pa >= 0; --pa)
#pragma unroll
          for (int pb = NB - 1; pb >= 0; --pb)
            mma(acc[i][j], a[i][pa], b[j][pb][0], b[j][pb][1]);
  }
}
// The CUDA cores: each thread sums its own outputs of the tile (the
// accumulator's layout) across k.
template <int MI, int NJ, class OA, class OB>
__device__ __forceinline__ void mm_cc(float (&acc)[MI][NJ][4], int r0, int c0,
                                      int K, const OA& A, const OB& B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[MI][2], bv[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) av[i][h] = A.at(r0 + 16 * i + g + 8 * h, k);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) bv[j][q] = B.at(k, c0 + 8 * j + 2 * t + q);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = fmaf(av[i][e >> 1], bv[j][e & 1], acc[i][j][e]);
  }
}
template <bool TC, int MI, int NJ, class OA, class OB>
__device__ __forceinline__ void mm(float (&acc)[MI][NJ][4], int r0, int c0,
                                   int K, const OA& A, const OB& B) {
  if constexpr (TC)
    mm_tc<MI, NJ>(acc, r0, c0, K, A, B);
  else
    mm_cc<MI, NJ>(acc, r0, c0, K, A, B);
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}
// f(row, column, value) for each of this thread's outputs of the tile.
template <int MI, int NJ, class F>
__device__ __forceinline__ void each(float (&acc)[MI][NJ][4], int r0, int c0,
                                     F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(r0 + 16 * i + g + 8 * (e >> 1), c0 + 8 * j + 2 * t + (e & 1),
          acc[i][j][e]);
}
// The tile as float32 pairs into out (row stride ld).
template <int MI, int NJ>
__device__ __forceinline__ void put(float (&acc)[MI][NJ][4], int r0, int c0,
                                    float* out, size_t ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            out + (size_t)(r0 + 16 * i + g + 8 * h) * ld + c0 + 8 * j +
            2 * t) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}
// out[r] = sum over the tile's columns c of f(r, c, value), for each row
// r of the tile: a thread's own columns in order, then its quad by a fixed
// butterfly.
template <int MI, int NJ, class F>
__device__ __forceinline__ void row_part(float (&acc)[MI][NJ][4], int r0,
                                         int c0, F f, float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * i + g + 8 * h;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          s += f(r, c0 + 8 * j + 2 * t + q, acc[i][j][2 * h + q]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) out[r] = s;
    }
}

// The pair (x, y) at element (i, j), (i, j + 1) of a float32 operand's
// region: three bf16 pieces `ps` apart on the tensor-core path, float32 on
// the CUDA cores; row stride ld.
template <bool TC>
__device__ __forceinline__ void put_pair(void* base, int ld, int ps, int i,
                                         int j, float x, float y) {
  if constexpr (TC) {
    uint32_t hi, mid, lo;
    split3(x, y, hi, mid, lo);
    bf16* q = static_cast<bf16*>(base) + i * ld + j;
    *reinterpret_cast<uint32_t*>(q) = hi;
    *reinterpret_cast<uint32_t*>(q + ps) = mid;
    *reinterpret_cast<uint32_t*>(q + 2 * ps) = lo;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i * ld + j) =
        make_float2(x, y);
  }
}

// Warp 0: dt of the chunk's rows (zero past nq), a = cumsum(dt A) and
// cumsum(dt) by warp scans, e^a, e^{a_end - a} and w = e^{a_end - a} dt,
// into the vectors v[0..6) (Qp floats each: dt, a, e^a, e^{a_end - a}, w,
// cumsum(dt)).
template <typename T>
__device__ __forceinline__ void decays(const T* dtb, long long rs, int nq,
                                       int Qp, float a_h, float* v) {
  const int lane = threadIdx.x & 31;
  float* vdt = v;
  float* vac = v + Qp;
  float carry = 0.f, ccarry = 0.f;
  for (int base = 0; base < Qp; base += 32) {
    const int i = base + lane;
    const float d = i < nq ? repro::to_f32(dtb[(size_t)i * rs]) : 0.f;
    float s = d * a_h, cs = d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, s, o);
      const float w = __shfl_up_sync(0xffffffffu, cs, o);
      if (lane >= o) {
        s += u;
        cs += w;
      }
    }
    s += carry;
    cs += ccarry;
    carry = __shfl_sync(0xffffffffu, s, 31);
    ccarry = __shfl_sync(0xffffffffu, cs, 31);
    vdt[i] = d;
    vac[i] = s;
    v[5 * Qp + i] = cs;
  }
  __syncwarp();
  const float a_end = vac[nq - 1];
  __syncwarp();
  for (int i = lane; i < Qp; i += 32) {
    const float ac = i < nq ? vac[i] : a_end;
    const float ed = expf(a_end - ac);
    vac[i] = ac;
    v[2 * Qp + i] = expf(ac);
    v[3 * Qp + i] = ed;
    v[4 * Qp + i] = ed * vdt[i];
  }
}

// The cluster barrier in two halves: arrive releases this thread's writes
// to shared memory to the cluster, wait acquires every thread's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Inclusive suffix sum across the warp's lanes.
__device__ __forceinline__ float suffix_sum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

// ---------------------------------------------------------------------------
// 1. The chunk's own states S_c and T_c.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_local(const Args<T> a) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.kq, nc = a.nc;
  const LocalLayout L = local_layout(Q, P, N, sizeof(T));
  const int Qp = L.g.Qp, PP = L.g.PP, NP = L.g.NP, ldx = L.g.ldx,
            ldb = L.g.ldb, ps = L.piece;
  void* wx = smem + L.wx;
  void* edy = smem + L.edy;
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* dys = reinterpret_cast<T*>(smem + L.dys);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* cs = reinterpret_cast<T*>(smem + L.cs);
  float* v = reinterpret_cast<float*>(smem + L.vec);
  const int c0 = c * Q, nq = min(Q, S - c0);
  const int grp = h / (H / a.G);
  const size_t row0 = (size_t)b * S + c0;
  const long long y_rs = (long long)H * P;
  const bool do_s = c + 1 < nc;  // the last chunk's S feeds no h
  const bool do_t = c > 0 || a.dinit != nullptr;  // T_0 only feeds g_0
  if (do_s) {
    stage<T>(xs, ldx, a.x + row0 * a.x_rs + (size_t)h * P, a.x_rs, nq, Qp, P,
             PP, a.vec);
    stage<T>(bs, ldb, a.Bm + row0 * a.b_rs + (size_t)grp * N, a.b_rs, nq, Qp,
             N, NP, a.vec);
  }
  if (do_t) {
    stage<T>(dys, ldx, a.dy + row0 * y_rs + (size_t)h * P, y_rs, nq, Qp, P,
             PP, a.vec);
    stage<T>(cs, ldb, a.Cm + row0 * a.c_rs + (size_t)grp * N, a.c_rs, nq, Qp,
             N, NP, a.vec);
  }
  cp_commit();
  if (warp == 0)
    decays<T>(a.dt + row0 * a.dt_rs + h, a.dt_rs, nq, Qp, a.A[h], v);
  cp_wait_all();
  __syncthreads();
  // w x and e^a dy, a pair of columns a thread at a time.
  const float* vea = v + 2 * Qp;
  const float* vw = v + 4 * Qp;
  for (int e = tid; e < Qp * PP / 2; e += kThreads) {
    const int j = e / (PP / 2), p = (e - j * (PP / 2)) * 2;
    if (do_s)
      put_pair<TC>(wx, ldx, ps, j, p,
                   vw[j] * repro::to_f32(xs[j * ldx + p]),
                   vw[j] * repro::to_f32(xs[j * ldx + p + 1]));
    if (do_t)
      put_pair<TC>(edy, ldx, ps, j, p,
                   vea[j] * repro::to_f32(dys[j * ldx + p]),
                   vea[j] * repro::to_f32(dys[j * ldx + p + 1]));
  }
  __syncthreads();
  // S_pn = sum_j (w x)[j][p] B[j][n]; T_pn = sum_i (e^a dy)[i][p] C[i][n].
  const size_t soff = (((size_t)b * H + h) * nc + c) * PP * NP;
  const int tcn = NP / 32, nt = (PP / 32) * tcn;
  for (int it = warp; it < 2 * nt; it += kWarps) {
    const bool second = it >= nt;
    const int tt = second ? it - nt : it;
    if (second ? !do_t : !do_s) continue;
    const int r0 = (tt / tcn) * 32, cc0 = (tt % tcn) * 32;
    float acc[2][4][4];
    zero(acc);
    if (!second)
      mm<TC>(acc, r0, cc0, Qp, fop<TC, true>(wx, ldx, ps), op<false>(bs, ldb));
    else
      mm<TC>(acc, r0, cc0, Qp, fop<TC, true>(edy, ldx, ps),
             op<false>(cs, ldb));
    put(acc, r0, cc0, (second ? a.ct : a.st) + soff, NP);
  }
  if (tid == 0) a.aend[((size_t)b * H + h) * nc + c] = v[Qp + nq - 1];
}

// ---------------------------------------------------------------------------
// 2. The two state scans over the chunks, in place.  A thread's chain is
// sequential over the chunks, so it loads kAhead chunks' states before it
// steps through them: that many loads in flight, not one.
// ---------------------------------------------------------------------------
constexpr int kAhead = 8;

__global__ void __launch_bounds__(256) ssd_bwd_scan(
    float* st, float* ct, const float* aend, const float* init,
    const float* dstate, float* dinit, int P, int N, int PP, int NP,
    int nc) {
  const int bh = blockIdx.x, e4 = blockIdx.y * blockDim.x + threadIdx.x;
  if (e4 * 4 >= PP * NP) return;
  const bool back = blockIdx.z == 1;
  const int p = e4 * 4 / NP, n0 = e4 * 4 - p * NP;
  const float* seed = back ? dstate : init;
  auto seed_at = [&](int q) {
    return seed && p < P && n0 + q < N
               ? seed[((size_t)bh * P + p) * N + n0 + q]
               : 0.f;
  };
  float4 v = make_float4(seed_at(0), seed_at(1), seed_at(2), seed_at(3));
  const size_t step = (size_t)PP * NP;
  float4* base = reinterpret_cast<float4*>(
      (back ? ct : st) + (size_t)bh * nc * step + (size_t)e4 * 4);
  const float* ae = aend + (size_t)bh * nc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // Chunk c's slot takes the state entering it (forward: h_c) or the
  // cotangent of the state leaving it (back: g_{c+1}); the last chunk's
  // S and, without dinit, the first chunk's T are never read.
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
    float4 t[kAhead];
    float e[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = back ? nc - 1 - (k0 + k) : k0 + k;
      const bool in = k0 + k < nc;
      const bool used = back ? c > 0 || dinit != nullptr : c + 1 < nc;
      t[k] = in && used ? base[c * step / 4] : zero;
      e[k] = in ? expf(ae[c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (k0 + k >= nc) break;
      const int c = back ? nc - 1 - (k0 + k) : k0 + k;
      base[c * step / 4] = v;
      v.x = fmaf(e[k], v.x, t[k].x);
      v.y = fmaf(e[k], v.y, t[k].y);
      v.z = fmaf(e[k], v.z, t[k].z);
      v.w = fmaf(e[k], v.w, t[k].w);
    }
  }
  if (back && dinit && p < P) {
    const float out[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n0 + q < N) dinit[((size_t)bh * P + p) * N + n0 + q] = out[q];
  }
}

// ---------------------------------------------------------------------------
// 3. The chunk's gradients from h_c and g_{c+1}.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_grads(const Args<T> a) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int S = a.S, H = a.H, P = a.P, N = a.N, Q = a.kq, nc = a.nc;
  const GradLayout L = grads_layout(Q, P, N, sizeof(T));
  const int Qp = L.g.Qp, PP = L.g.PP, NP = L.g.NP;
  const int ldx = L.g.ldx, ldb = L.g.ldb, ldh = L.g.ldh, ldq = L.g.ldq;
  const int hps = L.hpiece, mps = L.mpiece;
  void* hs = smem + L.h;   // h_c, then the block's dC (float32, ldh)
  void* gs = smem + L.gs;  // g_{c+1}, then its dB
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* dys = reinterpret_cast<T*>(smem + L.dys);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* cs = reinterpret_cast<T*>(smem + L.cs);
  void* mb = smem + L.mb;  // M
  void* wb = smem + L.wb;  // W
  float* v = reinterpret_cast<float*>(smem + L.vec);
  float* vdt = v;
  float* vac = v + Qp;
  float* vea = v + 2 * Qp;
  float* ved = v + 3 * Qp;
  float* vw = v + 4 * Qp;
  float* vc = v + 5 * Qp;                     // cumsum(dt)
  float* dmd = v + 6 * Qp;                    // dM's diagonal
  float* rowp = v + kVecs * Qp;               // [Qp / 32][Qp]: F dt by row
  float* colp = rowp + kFRowParts * Qp;       // [Qp / 16][Qp]: F by column
  float* xgbp = colp + kFColParts * Qp;       // [PP / 32][Qp]: x . gB
  float* zcp = xgbp + kRowParts * Qp;         // [NP / 32][Qp]: C . Z
  float* red = zcp + kRowParts * Qp;  // [2][kWarps]: <g, h>, F's share of dA
  const int c0 = c * Q, nq = min(Q, S - c0);
  const int grp = h / (H / a.G);
  const size_t row0 = (size_t)b * S + c0;
  const long long y_rs = (long long)H * P;
  stage<T>(xs, ldx, a.x + row0 * a.x_rs + (size_t)h * P, a.x_rs, nq, Qp, P,
           PP, a.vec);
  stage<T>(dys, ldx, a.dy + row0 * y_rs + (size_t)h * P, y_rs, nq, Qp, P, PP,
           a.vec);
  stage<T>(bs, ldb, a.Bm + row0 * a.b_rs + (size_t)grp * N, a.b_rs, nq, Qp, N,
           NP, a.vec);
  stage<T>(cs, ldb, a.Cm + row0 * a.c_rs + (size_t)grp * N, a.c_rs, nq, Qp, N,
           NP, a.vec);
  const size_t soff = (((size_t)b * H + h) * nc + c) * PP * NP;
  float gh = 0.f;  // this thread's share of <g, h>
  if constexpr (TC) {
    // h and g split into their pieces on the way in, every load of the
    // thread issued before the first is used.
    constexpr int kIt = kMaxP * kMaxN / 4 / kThreads;
    const int n4 = NP / 4;
    float4 hv[kIt], gv[kIt];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = tid + k * kThreads, p = e / n4, n = (e - p * n4) * 4;
      if (e < PP * n4) {
        hv[k] = *reinterpret_cast<const float4*>(a.st + soff +
                                                 (size_t)p * NP + n);
        gv[k] = *reinterpret_cast<const float4*>(a.ct + soff +
                                                 (size_t)p * NP + n);
      }
    }
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int e = tid + k * kThreads, p = e / n4, n = (e - p * n4) * 4;
      if (e < PP * n4) {
        gh = fmaf(gv[k].x, hv[k].x, gh);
        gh = fmaf(gv[k].y, hv[k].y, gh);
        gh = fmaf(gv[k].z, hv[k].z, gh);
        gh = fmaf(gv[k].w, hv[k].w, gh);
        put_pair<true>(hs, ldh, hps, p, n, hv[k].x, hv[k].y);
        put_pair<true>(hs, ldh, hps, p, n + 2, hv[k].z, hv[k].w);
        put_pair<true>(gs, ldh, hps, p, n, gv[k].x, gv[k].y);
        put_pair<true>(gs, ldh, hps, p, n + 2, gv[k].z, gv[k].w);
      }
    }
  } else {
    stage_state(static_cast<float*>(hs), ldh, a.st + soff, PP, NP);
    stage_state(static_cast<float*>(gs), ldh, a.ct + soff, PP, NP);
  }
  cp_commit();
  const float a_h = a.A[h];
  if (warp == 0)
    decays<T>(a.dt + row0 * a.dt_rs + h, a.dt_rs, nq, Qp, a_h, v);
  cp_wait_all();
  __syncthreads();
  if constexpr (!TC) {
    const float* hf = static_cast<const float*>(hs);
    const float* gf = static_cast<const float*>(gs);
    for (int e = tid; e < PP * NP; e += kThreads) {
      const int p = e / NP, n = e - p * NP;
      gh = fmaf(gf[p * ldh + n], hf[p * ldh + n], gh);
    }
  }
  gh = repro::warp_sum(gh);
  if (lane == 0) red[warp] = gh;

  // A. CB = C B^T and dM = dy x^T over the chunk's rows (16 x 32 tiles, a
  // tile above the diagonal skipped), then in the same registers, for j <=
  // i < nq with L_ij = e^{a_i - a_j}: M = CB L dt_j and W = dM L dt_j into
  // their regions, and F = dM CB L summed by row (times dt_j) and by
  // column in a fixed order, and its share of the chunk's dA, sum F_ij
  // dt_j (c_i - c_j) with c = cumsum(dt): what the row sums minus dt times
  // the column sums give once weighted by c, taken directly (that
  // difference of sums of terms up to 50 times larger than dA loses dA's
  // last digits).
  {
    const int tcn = Qp / 32, nt = (Qp / 16) * tcn;
    float fa = 0.f;
    for (int it = warp; it < nt; it += kWarps) {
      const int r0 = (it / tcn) * 16, cc0 = (it % tcn) * 32;
      float cb[1][4][4], dm[1][4][4];
      zero(cb);
      zero(dm);
      if (cc0 <= r0 + 15) {
        mm<TC>(cb, r0, cc0, NP, op<false>(cs, ldb), op<true>(bs, ldb));
        mm<TC>(dm, r0, cc0, PP, op<false>(dys, ldx), op<true>(xs, ldx));
      }
      float rs[2] = {0.f, 0.f}, cl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) cl[j][0] = cl[j][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = r0 + g4 + 8 * hh;
          float m[2], w[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int jj = cc0 + 8 * j + 2 * t4 + q;
            const float cbv = cb[0][j][2 * hh + q], dmv = dm[0][j][2 * hh + q];
            float f = 0.f;
            m[q] = w[q] = 0.f;
            if (jj <= i && i < nq) {
              const float l = expf(vac[i] - vac[jj]);
              m[q] = cbv * l * vdt[jj];
              w[q] = dmv * l * vdt[jj];
              f = dmv * cbv * l;
              fa = fmaf(f * vdt[jj], vc[i] - vc[jj], fa);
            }
            if (i == jj) dmd[i] = i < nq ? dmv : 0.f;
            rs[hh] = fmaf(f, vdt[jj], rs[hh]);
            cl[j][q] += f;
          }
          put_pair<TC>(mb, ldq, mps, i, cc0 + 8 * j + 2 * t4, m[0], m[1]);
          put_pair<TC>(wb, ldq, mps, i, cc0 + 8 * j + 2 * t4, w[0], w[1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = rs[hh];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t4 == 0) rowp[(cc0 / 32) * Qp + r0 + g4 + 8 * hh] = x;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float x = cl[j][q];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (g4 == 0) colp[(r0 / 16) * Qp + cc0 + 8 * j + 2 * t4 + q] = x;
        }
    }
    fa = repro::warp_sum(fa);
    if (lane == 0) red[kWarps + warp] = fa;
  }
  __syncthreads();

  // B. dx_j = w_j (g B)_j + sum_i M_ij dy_i + D dy_j (16 x 32 tiles), with
  // x_j . (g B)_j from the first product.
  {
    const float d_h = a.D[h];
    T* dxo = a.dx + row0 * y_rs + (size_t)h * P;
    const int tcn = PP / 32, nt = (Qp / 16) * tcn;
    for (int it = warp; it < nt; it += kWarps) {
      const int r0 = (it / tcn) * 16, cc0 = (it % tcn) * 32;
      float acc[1][4][4];
      zero(acc);
      mm<TC>(acc, r0, cc0, NP, op<false>(bs, ldb), fop<TC, true>(gs, ldh, hps));
      row_part(acc, r0, cc0,
               [&](int j, int p, float s) {
                 return repro::to_f32(xs[j * ldx + p]) * s;
               },
               xgbp + (cc0 / 32) * Qp);
      each(acc, r0, cc0, [&](int j, int, float& s) { s *= vw[j]; });
      mm<TC>(acc, r0, cc0, Qp, fop<TC, true>(mb, ldq, mps),
             op<false>(dys, ldx));
      each(acc, r0, cc0, [&](int j, int p, float& s) {
        if (j < nq && p < P)
          dxo[(size_t)j * y_rs + p] = repro::from_f32<T>(
              fmaf(d_h, repro::to_f32(dys[j * ldx + p]), s));
      });
    }
  }

  // C. dC_i = e^{a_i} (dy h)_i + sum_j W_ij B_j, with C_i . (dy h)_i; dB_j
  // = w_j (x g)_j + sum_i W_ij C_i.  32 x 32 tiles, at most one a warp,
  // held in registers until h and g are free.
  const int tcn2 = NP / 32, nt2 = (Qp / 32) * tcn2;
  const bool own = warp < nt2;
  const int rr0 = own ? (warp / tcn2) * 32 : 0;
  const int rc0 = own ? (warp % tcn2) * 32 : 0;
  float dc[2][4][4], db[2][4][4];
  zero(dc);
  zero(db);
  if (own) {
    mm<TC>(dc, rr0, rc0, PP, op<false>(dys, ldx), fop<TC, false>(hs, ldh, hps));
    row_part(dc, rr0, rc0,
             [&](int i, int n, float s) {
               return repro::to_f32(cs[i * ldb + n]) * s;
             },
             zcp + (rc0 / 32) * Qp);
    each(dc, rr0, rc0, [&](int i, int, float& s) { s *= vea[i]; });
    mm<TC>(dc, rr0, rc0, Qp, fop<TC, false>(wb, ldq, mps), op<false>(bs, ldb));
    mm<TC>(db, rr0, rc0, PP, op<false>(xs, ldx), fop<TC, false>(gs, ldh, hps));
    each(db, rr0, rc0, [&](int j, int, float& s) { s *= vw[j]; });
    mm<TC>(db, rr0, rc0, Qp, fop<TC, true>(wb, ldq, mps), op<false>(cs, ldb));
  }
  __syncthreads();  // every read of h and g done; the partials written
  float* rc = static_cast<float*>(hs);  // the block's dC, (Qp, ldh)
  float* rb = static_cast<float*>(gs);  // its dB
  if (own) {
    put(dc, rr0, rc0, rc, ldh);
    put(db, rr0, rc0, rb, ldh);
  }
  // dC and dB published to the cluster; D runs while the others arrive.
  cluster_arrive();

  // D. d(a) per row (F's row sums and dt times its column sums, e^{a_i}
  // C_i . Z_i, -w_i x_i . gB_i, and on the last valid row e^{a_end} <g, h>
  // and the sum of the w_j x_j . gB_j), its reverse cumulative sum R, ddt
  // = sum_i F_im + e^{a_end - a_m} x_m . gB_m + A R_m, and the chunk's dA
  // and dD partials: warp 0, rows lane and lane + 32.  dA = sum_m dt_m R_m
  // = sum_i d(a)_i c_i is taken term by term: F's share from A, then
  // e^{a_i} C_i . Z_i c_i, w_i x_i . gB_i (c_end - c_i) and c_end e^{a_end}
  // <g, h>.
  if (warp == 0) {
    float ghs = 0.f, sa = 0.f;
    for (int w = 0; w < kWarps; ++w) ghs += red[w];
    for (int w = 0; w < kWarps; ++w) sa += red[kWarps + w];
    const float a_end = vac[nq - 1], c_end = vc[nq - 1];
    float xg[2], da[2], cf[2], tot = 0.f, sl = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      xg[u] = da[u] = cf[u] = 0.f;
      if (i < nq) {
        float xv = 0.f, zv = 0.f, re = 0.f, co = 0.f;
        for (int k = 0; k < PP / 32; ++k) xv += xgbp[k * Qp + i];
        for (int k = 0; k < NP / 32; ++k) zv += zcp[k * Qp + i];
        for (int k = 0; k < Qp / 32; ++k) re += rowp[k * Qp + i];
        for (int k = 0; k < Qp / 16; ++k) co += colp[k * Qp + i];
        const float uu = vw[i] * xv;
        da[u] = re - vdt[i] * co + vea[i] * zv - uu;
        tot += uu;
        xg[u] = xv;
        cf[u] = co;
        sl += vea[i] * zv * vc[i] + uu * (c_end - vc[i]);
      }
    }
    tot = repro::warp_sum(tot);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (lane + 32 * u == nq - 1) da[u] += tot + expf(a_end) * ghs;
    float R[2];
    R[1] = suffix_sum(da[1]);
    R[0] = suffix_sum(da[0]) + __shfl_sync(0xffffffffu, R[1], 0);
    float sd = 0.f;
    T* ddo = a.ddt + row0 * a.H + h;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      if (i < nq) {
        ddo[(size_t)i * H] =
            repro::from_f32<T>(cf[u] + ved[i] * xg[u] + a_h * R[u]);
        sd += dmd[i];
      }
    }
    sa += repro::warp_sum(sl) + c_end * expf(a_end) * ghs;
    sd = repro::warp_sum(sd);
    if (lane == 0) {
      a.dAp[((size_t)b * H + h) * nc + c] = sa;
      a.dDp[((size_t)b * H + h) * nc + c] = sd;
    }
  }

  // E. dB and dC summed over the cluster's heads in rank order, through
  // distributed shared memory: rank r takes rows r, r + cs, ...
  cg::cluster_group cl = cg::this_cluster();
  cluster_wait();
  const int ncs = a.cs, rank = (int)cl.block_rank();
  const int hc = H / ncs, ci = h / ncs;
  const int mine = nq > rank ? (nq - rank + ncs - 1) / ncs : 0;
  const float* rbs[kMaxCluster];
  const float* rcs[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    rbs[r] = cl.map_shared_rank(rb, r < ncs ? r : 0);
    rcs[r] = cl.map_shared_rank(rc, r < ncs ? r : 0);
  }
  for (int e = tid; e < mine * N; e += kThreads) {
    const int i = rank + ncs * (e / N), n = e % N;
    float sb = 0.f, sc = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < ncs) {
        sb += rbs[r][i * ldh + n];
        sc += rcs[r][i * ldh + n];
      }
    const size_t o = ((row0 + i) * hc + ci) * N + n;
    a.dBc[o] = sb;
    a.dCc[o] = sc;
  }
  cl.sync();  // no block leaves while another reads its sums
}

// ---------------------------------------------------------------------------
// 4. dB and dC: the cluster partials summed over each group's clusters in
// order, one block per (sequence, position) row; block 0 also sums dA and
// dD over the sequences and chunks, in order.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(128) ssd_bwd_reduce(
    const float* dBc, const float* dCc, const float* dAp, const float* dDp,
    T* dB, T* dC, float* dA, float* dD, int Bn, int H, int G, int N, int cs,
    int nc) {
  const size_t row = blockIdx.x;
  const int hc = H / cs, per = hc / G;
  for (int e = threadIdx.x; e < G * N; e += blockDim.x) {
    const int g = e / N, n = e - g * N;
    const float* pb = dBc + (row * hc + (size_t)g * per) * N + n;
    const float* pc = dCc + (row * hc + (size_t)g * per) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < per; ++r) {
      sb += pb[(size_t)r * N];
      sc += pc[(size_t)r * N];
    }
    dB[row * G * N + e] = repro::from_f32<T>(sb);
    dC[row * G * N + e] = repro::from_f32<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int bb = 0; bb < Bn; ++bb)
        for (int c = 0; c < nc; ++c) {
          sa += dAp[((size_t)bb * H + hh) * nc + c];
          sd += dDp[((size_t)bb * H + hh) * nc + c];
        }
      dA[hh] = sa;
      dD[hh] = sd;
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

template <typename T>
int launch(const Args<T>& a, int B, size_t smem_local, size_t smem_grads,
           T* dB, T* dC, float* dA, float* dD, cudaStream_t st) {
  int e = allow_smem((const void*)ssd_bwd_local<T>, smem_local);
  if (e == 0) e = allow_smem((const void*)ssd_bwd_grads<T>, smem_grads);
  if (e != 0) return e;
  const Geo g = geo(a.kq, a.P, a.N);
  ssd_bwd_local<T><<<dim3(a.H, a.nc, B), kThreads, smem_local, st>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int n4 = g.PP * g.NP / 4;
  ssd_bwd_scan<<<dim3(B * a.H, (n4 + 255) / 256, 2), 256, 0, st>>>(
      a.st, a.ct, a.aend, a.init, a.dstate, a.dinit, a.P, a.N, g.PP, g.NP,
      a.nc);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.nc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_grads;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, ssd_bwd_grads<T>, a);
  if (e == 0) e = (int)cudaGetLastError();
  if (e != 0) return e;
  ssd_bwd_reduce<T><<<(unsigned)((size_t)B * a.S), 128, 0, st>>>(
      a.dBc, a.dCc, a.dAp, a.dDp, dB, dC, dA, dD, B, a.H, a.G, a.N, a.cs,
      a.nc);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* dt, const void* A, const void* D,
        const void* Bm, const void* Cm, const void* init, const void* dy,
        const void* dstate, void* st, void* ct, void* aend, void* dx,
        void* ddt, void* dBc, void* dCc, void* dAp, void* dDp, void* dinit,
        void* dB, void* dC, void* dA, void* dD, int B, int S, int H, int P,
        int G, int N, long long x_rs, long long dt_rs, long long b_rs,
        long long c_rs, int kq, int cs, size_t smem_local, size_t smem_grads,
        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = P % V == 0 && N % V == 0 && x_rs % V == 0 &&
                  b_rs % V == 0 && c_rs % V == 0 &&
                  (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm |
                    (uintptr_t)dy) & 15) == 0;
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(D),
                  static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                  static_cast<const float*>(init), static_cast<const T*>(dy),
                  static_cast<const float*>(dstate), static_cast<float*>(st),
                  static_cast<float*>(ct), static_cast<float*>(aend),
                  static_cast<T*>(dx), static_cast<T*>(ddt),
                  static_cast<float*>(dBc), static_cast<float*>(dCc),
                  static_cast<float*>(dAp), static_cast<float*>(dDp),
                  static_cast<float*>(dinit), S, H, P, G, N, kq, cs,
                  (S + kq - 1) / kq, vec, x_rs, dt_rs, b_rs, c_rs};
  return launch<T>(a, B, smem_local, smem_grads, static_cast<T*>(dB),
                   static_cast<T*>(dC), static_cast<float*>(dA),
                   static_cast<float*>(dD), stream);
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N): element [b, s, ...]
// of each at row (b * S + s) times its row stride (in elements), the rest
// of the row contiguous.  A, D (H,) float32; init (B, H, P, N) float32 or
// null; dy (B, S, H, P) contiguous in x's type; dstate (B, H, P, N)
// float32 or null.  Scratch, all float32: st and ct (B, H, chunks, PP, NP)
// with P and N padded to multiples of 32; aend, dAp and dDp (B, H, chunks);
// dBc and dCc (B, S, H / cs, N).  Outputs, contiguous: dx like x, ddt like
// dt, dB and dC (B, S, G, N) in x's type, dA and dD (H,) and dinit (B, H,
// P, N, or null) float32.  kq, cs and the two kernels' shared bytes are
// kernels/ssd_scan.py::ssd_bwd_plan's.  Returns the CUDA error of the
// launches; a shape or plan the kernels cannot take is
// cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* D,
    const void* Bm, const void* Cm, const void* init, const void* dy,
    const void* dstate, void* st, void* ct, void* aend, void* dx, void* ddt,
    void* dBc, void* dCc, void* dAp, void* dDp, void* dinit, void* dB,
    void* dC, void* dA, void* dD, int bf16, int B, int S, int H, int P,
    int G, int N, long long x_rs, long long dt_rs, long long b_rs,
    long long c_rs, int kq, int cs, long long smem_local,
    long long smem_grads, void* stream) {
  const int esz = bf16 ? 2 : 4;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G ||
      S < 1 || B < 1 || B > 65535 || H > 65535 ||
      (kq != 16 && kq != 32 && kq != 64) || (S + kq - 1) / kq > 65535 ||
      cs < 1 || cs > kMaxCluster || (H / G) % cs ||
      (size_t)smem_local != local_layout(kq, P, N, esz).total ||
      (size_t)smem_grads != grads_layout(kq, P, N, esz).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(x, dt, A, D, Bm, Cm, init, dy, dstate, st, ct,
                              aend, dx, ddt, dBc, dCc, dAp, dDp, dinit, dB,
                              dC, dA, dD, B, S, H, P, G, N, x_rs, dt_rs, b_rs,
                              c_rs, kq, cs, (size_t)smem_local,
                              (size_t)smem_grads, st_);
  return run<float>(x, dt, A, D, Bm, Cm, init, dy, dstate, st, ct, aend, dx,
                    ddt, dBc, dCc, dAp, dDp, dinit, dB, dC, dA, dD, B, S, H,
                    P, G, N, x_rs, dt_rs, b_rs, c_rs, kq, cs,
                    (size_t)smem_local, (size_t)smem_grads, st_);
}
