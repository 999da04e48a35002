// quant_matmul for Hopper: y = x @ (w_q * scale), f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (body _qmm_kernel).  Weights are int8 storage holding 8- or 4-bit values,
// with one f32 scale per (K-group, N-column).
//
// What bounds it on the H100: at decode (M <= 4 on the main path) each
// weight byte feeds 2*M operations, far below the card's ridge, so the
// bound is the weight bytes at 3.35 TB/s.  At the serving prefill (M = 48)
// the bound is the f32 multiply-adds at 67 TFLOP/s on the CUDA cores: the
// arithmetic stays f32 (no mma/wgmma), since the 8-bit variant's f32
// logits are held to 2e-4.
//
// Design: one block per (column tile of BN = 64 or 128 columns, split of
// K, chunk of at most 64 rows of x), against the four things that held
// the first design at 19% of the memory rate:
//
// 1. One load round per block, between a serial prologue and epilogue.
//    A block streams its (rows x BN) int8 slab, the scale rows it needs
//    and its rows of x through shared memory in tiles of 128 rows at
//    decode (64 above), in a ring of up to four stages (as many as let
//    the plan's blocks an SM, three at decode and two above, share its
//    shared memory).  Thread 0 asks the TMA unit for a whole stage (three 2-D boxes, counted on one
//    mbarrier) and the other threads never stall on a copy, so the
//    arithmetic on tile t overlaps the transfer of tiles t+1..t+3.  At
//    decode a split is 192-1152 rows, so a block has all or three of its
//    tiles in flight from its start: 8 KB a tile at BN = 64, 16 KB at
//    BN = 128, with two or three blocks an SM, 48 KB or more of weights
//    in flight an SM.  (16-byte cp.async from every thread would stall
//    each issuing thread until the memory system takes the request, so
//    the whole transfer would run before any arithmetic: measured on the
//    H100, PERF.md section 6.)  The weight and scale maps are encoded
//    once per weight and kept; only x's map is encoded on each call.
// 2. Two launches and a round trip through device memory.  The blocks
//    that split one column tile's K range are one thread-block cluster of
//    S in {1, 2, 4, 8} blocks.  Each block adds its slices' sums in a
//    fixed tree, then writes each float4 of the tile into the shared
//    memory of the block that owns it (rank q owns 1/S of the tile, one
//    slot per sender); after one cluster barrier rank q adds its slots in
//    rank order 0..S-1, casts and writes the output.  No atomics, no
//    global partials, no second kernel: one launch a call, bit-identical
//    from call to call.  The plan (kernels/quant_matmul.py::qmm_plan) is
//    cut from shapes alone; splits start at multiples of the group, and
//    no plan asks for more clusters than the card holds at once.
// 3. 4-byte loads.  Weights, scales and x move as TMA boxes where
//    N % 16 == 0 (every main-path width); otherwise a variant of the same
//    body (kAligned false) stages elements one by one and masks the
//    column tail, so any N is taken.
// 4. Weights read and dequantized once per 8 rows of x.  A thread holds
//    MT rows of x by 4 columns in registers (MT = 4 at decode, 16 above),
//    and the block's row groups cover its whole chunk of up to 64 rows, so
//    at M <= 64 each weight byte leaves device memory once per call; each
//    thread turns four int8 weights into f32 ((float)q * s, exact int8 to
//    f32 by a byte permute and one subtraction) and uses them for all its
//    MT rows.  Scales are kept in registers and re-read only when a row
//    crosses into the next group.  Above 64 rows the grid tiles M by 64.
#include <climits>
#include <cooperative_groups.h>
#include <cudaTypedefs.h>
#include <functional>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Rows of K a stage holds: 128 at decode (MT = 4), where a thread's work
// per tile is small, 64 above, where the tile of x is the larger part.
template <int MT>
__host__ __device__ constexpr int tile_rows() { return MT == 4 ? 128 : 64; }
constexpr int kMaxStages = 4;    // stages in the ring, at most
// How many threads a block may have and how many blocks an SM holds, at
// decode (MT = 4) and above, are the plan's: kernels/quant_matmul.py
// owns them and the build passes them in (QMM_THREADS_DECODE, ...).  They
// cap the registers (__launch_bounds__) and size the ring of stages.
#if !defined(QMM_THREADS_DECODE) || !defined(QMM_THREADS_PREFILL) || \
    !defined(QMM_BLOCKS_DECODE) || !defined(QMM_BLOCKS_PREFILL)
#error "quant_matmul.cu is built by repro_torch.kernels.build, which passes the plan's limits"
#endif
template <int MT>
__host__ __device__ constexpr int sm_blocks() {
  return MT == 4 ? QMM_BLOCKS_DECODE : QMM_BLOCKS_PREFILL;
}
template <int MT>
__host__ __device__ constexpr int max_threads() {
  return MT == 4 ? QMM_THREADS_DECODE : QMM_THREADS_PREFILL;
}
constexpr int kMaxCluster = 8;

struct Params {
  int M, K, N, group, G;
  int rows;        // rows of K a split takes (the last may be shorter)
  int S;           // splits: blocks in one cluster
  int bn, cl;      // columns of a block; threads across them (bn / 4)
  int m_chunk;     // rows of x a block takes
  int rg, ks;      // row groups of MT rows; slices of a tile's rows
  int sr;          // scale rows a stage holds
  int stages;      // stages in the ring
  int bn_sh;       // log2(bn)
  int g_sh;        // log2(group) if the group is a power of two, else -1
  int out_bf16;
};

// v / group, by a shift on the main path (groups of 32).
__device__ __forceinline__ int group_of(const Params& p, int v) {
  return p.g_sh >= 0 ? v >> p.g_sh : v / p.group;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// One transaction barrier a stage: thread 0 arms it with the stage's
// bytes and the TMA unit completes it as the tiles land.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits for the barrier's phase `parity`; a tile that never lands (a bad
// tensor map) stops the kernel after about two seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}
// A 2-D box of `map` at (column c0, row c1) into shared memory, counted
// on `bar`.  Out-of-range rows and columns arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// The two halves of a cluster barrier (cluster.sync() is both at once).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}


// Four int8 weights as f32, each times its column's scale.  The byte
// permute builds the float 2^23 + (q + 128), so the subtraction gives q
// exactly: the same products as the reference's q.float() * scale.
__device__ __forceinline__ void dequant(uint32_t q, float4 s, float* w) {
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const uint32_t u = q ^ 0x80808080u;
  w[0] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias) * s.x;
  w[1] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias) * s.y;
  w[2] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias) * s.z;
  w[3] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias) * s.w;
}

// Four consecutive elements of a staged row of x, as f32.
__device__ __forceinline__ void load_x4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_x4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

// Bytes of one stage, each part a multiple of 128 bytes: the weight tile,
// the scale rows, and mp rows of x, as the TMA boxes lay them out.
template <int MT>
__host__ __device__ inline int stage_bytes(const Params& p, int xsz) {
  constexpr int kBK = tile_rows<MT>();
  return kBK * p.bn + p.sr * p.bn * 4 + p.rg * MT * kBK * xsz;
}

// Shared memory a block takes: the ring of stages, or the slices'
// partials where larger (they reuse the ring once it is drained), then
// the slots in which the cluster's blocks leave this block's share.
template <int MT>
__host__ __device__ inline int part_offset(const Params& p, int xsz) {
  const int ring = p.stages * stage_bytes<MT>(p, xsz);
  const int part = p.ks * p.rg * MT * p.bn * 4;
  return ring > part ? ring : part;
}
template <int MT>
__host__ __device__ inline int slots_end(const Params& p, int xsz) {
  return part_offset<MT>(p, xsz) + p.rg * MT * p.bn * 4;
}
template <int MT>
__host__ __device__ inline int smem_bytes(const Params& p, int xsz) {
  return slots_end<MT>(p, xsz) + kMaxStages * (int)sizeof(uint64_t);
}

// Scale rows a tile can touch: its start is a group multiple plus a
// multiple of the tile.
template <int MT>
int scale_rows(int group, int G) {
  constexpr int kBK = tile_rows<MT>();
  const int sr = kBK % group == 0 ? kBK / group
                 : group % kBK == 0 ? 1 : (kBK - 1) / group + 2;
  return sr < G ? sr : G;
}

template <typename XT, int MT, bool kAligned>
__global__ void __launch_bounds__(max_threads<MT>(), sm_blocks<MT>())
qmm_cluster(const XT* __restrict__ x, const int8_t* __restrict__ wq,
            const float* __restrict__ sc, void* __restrict__ out, Params p,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_s,
            const __grid_constant__ CUtensorMap map_x) {
  constexpr int kBK = tile_rows<MT>();
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / p.S) * p.bn;
  const int m0 = blockIdx.y * p.m_chunk;
  const int mrows = min(p.m_chunk, p.M - m0);
  const int k0 = rank * p.rows;
  const int k1 = min(p.K, k0 + p.rows);
  const int ntiles = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
  const int mp = p.rg * MT;
  const int WS = p.bn;
  const int w_bytes = kBK * WS, s_bytes = p.sr * p.bn * 4;
  const int stage = stage_bytes<MT>(p, sizeof(XT));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + slots_end<MT>(p, sizeof(XT)));
  // Stage tile t (rows k0 + t*kBK ...) into ring slot t % stages.  Rows
  // past K, columns past N and rows of x past M arrive as zeros; scale
  // rows past G too, so a zero weight never meets a stale scale.  The
  // element-wise variant also zeroes rows past the split; the TMA boxes
  // bring the next split's rows, which the compute never reaches (splits
  // end at group multiples, and a group is a multiple of 8 there).
  auto load = [&](int t) {
    unsigned char* base = smem + (t % p.stages) * stage;
    int8_t* ws = reinterpret_cast<int8_t*>(base);
    float* ss = reinterpret_cast<float*>(base + w_bytes);
    XT* xs = reinterpret_cast<XT*>(base + w_bytes + s_bytes);
    const int kt = k0 + t * kBK;
    const int g0 = group_of(p, kt);
    if constexpr (kAligned) {
      // One thread asks for the whole stage; nobody waits on the copy.
      if (tid != 0) return;
      uint64_t* bar = &bars[t % p.stages];
      // Generic reads of this slot (tile t - stages) came before.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, stage);
      tma_load(ws, &map_w, n0, kt, bar);
      tma_load(ss, &map_s, n0, g0, bar);
      tma_load(xs, &map_x, kt, m0, bar);
    } else {
      for (int i = tid; i < kBK << p.bn_sh; i += nthreads) {
        const int r = i >> p.bn_sh, c = i & (p.bn - 1);
        const int k = kt + r, n = n0 + c;
        ws[r * WS + c] = (k < k1 && n < p.N) ? wq[(size_t)k * p.N + n]
                                             : (int8_t)0;
      }
      for (int i = tid; i < p.sr << p.bn_sh; i += nthreads) {
        const int r = i >> p.bn_sh, c = i & (p.bn - 1);
        const int g = g0 + r, n = n0 + c;
        ss[i] = (g < p.G && n < p.N) ? sc[(size_t)g * p.N + n] : 0.f;
      }
      const XT zero = repro::from_f32<XT>(0.f);
      for (int i = tid; i < mp * kBK; i += nthreads) {
        const int m = i / kBK, c = i - m * kBK;
        const int k = kt + c;
        xs[i] = (m < mrows && k < k1) ? x[(size_t)(m0 + m) * p.K + k] : zero;
      }
    }
  };

  // The first stages: thread 0 sets up the barriers and asks for them
  // before the block barrier, so the copies start at once.
  if (kAligned && tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_s) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_x) : "memory");
    for (int i = 0; i < p.stages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < p.stages - 1 && t < ntiles; ++t) load(t);
  }
  if (!kAligned)
    for (int t = 0; t < p.stages - 1 && t < ntiles; ++t) load(t);
  __syncthreads();  // the barriers are set up for every thread
  // Arrive now, wait before the first write to another block's shared
  // memory: by then every block of the cluster has started.
  cluster_arrive_relaxed();

  // This thread: columns c..c+3 of the tile, rows rgi*MT.. of the chunk,
  // and rows r0..r0+rps of every tile (its slice).
  const int slice = tid / p.cl;
  const int c = (tid - slice * p.cl) * 4;
  const int ksi = slice % p.ks, rgi = slice / p.ks;
  const int rps = kBK / p.ks;
  const int r0 = ksi * rps;
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    // Every thread is done with tile t - 1, so its slot takes tile
    // t + stages - 1; the element-wise stores of tile t are visible.
    __syncthreads();
    if (t + p.stages - 1 < ntiles) load(t + p.stages - 1);
    const int slot = t % p.stages;
    if constexpr (kAligned) mbar_wait(&bars[slot], (t / p.stages) & 1);

    const unsigned char* base = smem + slot * stage;
    const int8_t* ws = reinterpret_cast<const int8_t*>(base);
    const XT* xs = reinterpret_cast<const XT*>(base + w_bytes + s_bytes) +
                   rgi * MT * kBK;
    const int kt = k0 + t * kBK;
    const int r1 = min(r0 + rps, k1 - kt);
    if (r0 < r1) {
      // The scales of group g sit at row g - group_of(kt) of the stage;
      // gend is where the next group starts (never past the last group,
      // so zero-filled rows past K keep a staged scale).
      int g = group_of(p, kt + r0);
      int gend = g + 1 < p.G ? (g + 1) * p.group : INT_MAX;
      const float* srow = reinterpret_cast<const float*>(base + w_bytes) +
                          (g - group_of(p, kt)) * p.bn + c;
      float4 s = *reinterpret_cast<const float4*>(srow);
      auto next_group = [&] {
        ++g;
        gend = g + 1 < p.G ? gend + p.group : INT_MAX;
        srow += p.bn;
        s = *reinterpret_cast<const float4*>(srow);
      };
      for (int kb = r0; kb < r1; kb += 4) {
        uint32_t q[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          q[r] = *reinterpret_cast<const uint32_t*>(ws + (kb + r) * WS + c);
        float w[4][4];
        if (p.group % 4 == 0) {  // the four rows share one group
          if (kt + kb >= gend) next_group();
#pragma unroll
          for (int r = 0; r < 4; ++r) dequant(q[r], s, w[r]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (kt + kb + r >= gend) next_group();
            dequant(q[r], s, w[r]);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float xv[4];
          load_x4(xs + i * kBK + kb, xv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(xv[r], w[r][j], acc[i][j]);
        }
      }
    }
  }

  // The block's partial: each slice's sums, then the slices added in
  // order into slice 0's place (over the drained ring).
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);
  const int E4 = mp * p.bn / 4;  // float4s of one partial
#pragma unroll
  for (int i = 0; i < MT; ++i)
    red[ksi * E4 + ((rgi * MT + i) * p.bn + c) / 4] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  // In two levels, a fixed tree: `parts` runs of ks / parts slices each,
  // summed in order in parallel, then the runs in order.
  int parts = 1;
  while (parts * 2 <= p.ks && parts * 2 * E4 <= nthreads) parts *= 2;
  const int run = p.ks / parts;
  for (int i = tid; i < parts * E4; i += nthreads) {
    const int e = i % E4, s0 = (i / E4) * run;
    float4 v = red[s0 * E4 + e];
    for (int s = 1; s < run; ++s) {
      const float4 u = red[(s0 + s) * E4 + e];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    red[s0 * E4 + e] = v;
  }
  __syncthreads();
  // The runs in order, and each float4 straight to the block that owns it:
  // rank q owns float4s [q * share, (q + 1) * share) of the tile and
  // keeps rank r's part of them in its slot r.
  const int share = E4 / p.S;
  float4* slots = reinterpret_cast<float4*>(
      smem + part_offset<MT>(p, sizeof(XT)));
  cluster_wait();
  for (int e = tid; e < E4; e += nthreads) {
    float4 v = red[e];
    for (int q = 1; q < parts; ++q) {
      const float4 u = red[q * run * E4 + e];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int owner = e / share;
    cluster.map_shared_rank(slots, owner)[rank * share + e - owner * share] =
        v;
  }
  cluster.sync();  // every slot is written; nothing remote follows

  // Rank r: its share of the tile, summed over ranks 0..S-1 in order.
  for (int f = tid; f < share; f += nthreads) {
    float4 v = slots[f];
    for (int q = 1; q < p.S; ++q) {
      const float4 u = slots[q * share + f];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int e = rank * share + f;
    const int m = e * 4 / p.bn, n = n0 + e * 4 - m * p.bn;
    if (m >= mrows || n >= p.N) continue;
    const size_t o = (size_t)(m0 + m) * p.N + n;
    if (kAligned) {  // N % 16 == 0: all four columns are in range
      if (p.out_bf16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 pk;
        pk.x = *reinterpret_cast<const unsigned*>(&lo);
        pk.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
      }
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n + j < p.N; ++j) {
        if (p.out_bf16)
          static_cast<__nv_bfloat16*>(out)[o + j] =
              repro::from_f32<__nv_bfloat16>(vs[j]);
        else
          static_cast<float*>(out)[o + j] = vs[j];
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn), 12000,
        cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn),
        cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) fn = nullptr;
  }
  return fn;
}

// A TMA map of a row-major (rows, cols) array read in boxes of
// (box_rows, box_cols); out-of-range elements read as zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esz,
                const void* base, int rows, int cols, int box_rows,
                int box_cols) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight and scale maps, encoded once: a map holds only the address,
// the shape and the box, so one key gives one map whatever tensor lies
// there now.  Weights stay put across calls; x's map is encoded each call.
struct MapKey {
  const void* base;
  int type, rows, cols, box_rows, box_cols;
  bool operator==(const MapKey& o) const {
    return base == o.base && type == o.type && rows == o.rows &&
           cols == o.cols && box_rows == o.box_rows &&
           box_cols == o.box_cols;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.base);
    for (const int v : {k.type, k.rows, k.cols, k.box_rows, k.box_cols})
      h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

bool cached_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esz,
                       const void* base, int rows, int cols, int box_rows,
                       int box_cols) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{base, (int)type, rows, cols, box_rows, box_cols};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  if (!tensor_map(map, type, esz, base, rows, cols, box_rows, box_cols))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a bound, never reached in serving
  maps.emplace(key, *map);
  return true;
}

// Sets once per kernel and device what a launch of `smem` bytes needs.
// (Keyed by the instantiation: its variants share one function type.)
template <typename XT, int MT, bool kAligned>
cudaError_t allow_smem(size_t smem) {
  auto kern = qmm_cluster<XT, MT, kAligned>;
  constexpr int kDevices = 64;
  static std::mutex mu;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= allowed[dev]) return cudaSuccess;
  // All of the SM's 228 KB as shared memory, so that the blocks the
  // registers allow fit (the default carveout held the prefill to one
  // block an SM).
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess) allowed[dev] = smem;
  return e;
}

template <typename XT, int MT, bool kAligned>
int launch(const void* x, const void* wq, const void* sc, void* out,
           Params p, cudaStream_t st) {
  if (tile_rows<MT>() % (4 * p.ks) ||
      p.cl * p.rg * p.ks > max_threads<MT>())
    return (int)cudaErrorInvalidValue;
  p.sr = scale_rows<MT>(p.group, p.G);
  // The deepest ring that leaves room for sm_blocks() blocks an SM (of
  // its 228 KB of shared memory, 1 KB a block is the system's).
  for (p.stages = kMaxStages; p.stages > 2; --p.stages)
    if (smem_bytes<MT>(p, sizeof(XT)) <= 227 * 1024 / sm_blocks<MT>() - 1024)
      break;
  const size_t smem = smem_bytes<MT>(p, sizeof(XT));
  CUtensorMap maps[3] = {};
  if (kAligned) {
    constexpr int kBK = tile_rows<MT>();
    const CUtensorMapDataType xt = sizeof(XT) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!cached_tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq,
                           p.K, p.N, kBK, p.bn) ||
        !cached_tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc,
                           p.G, p.N, p.sr, p.bn) ||
        !tensor_map(&maps[2], xt, sizeof(XT), x, p.M, p.K, p.rg * MT, kBK))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = allow_smem<XT, MT, kAligned>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.N + p.bn - 1) / p.bn) * p.S,
                     (p.M + p.m_chunk - 1) / p.m_chunk);
  cfg.blockDim = dim3(p.cl * p.rg * p.ks);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_cluster<XT, MT, kAligned>,
                         static_cast<const XT*>(x),
                         static_cast<const int8_t*>(wq),
                         static_cast<const float*>(sc), out, p, maps[0],
                         maps[1], maps[2]);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename XT>
int launch_x(int mt, int aligned, const void* x, const void* wq,
             const void* sc, void* out, const Params& p, cudaStream_t st) {
  if (mt == 4)
    return aligned ? launch<XT, 4, true>(x, wq, sc, out, p, st)
                   : launch<XT, 4, false>(x, wq, sc, out, p, st);
  return aligned ? launch<XT, 16, true>(x, wq, sc, out, p, st)
                 : launch<XT, 16, false>(x, wq, sc, out, p, st);
}

// The call's parameters, or false for a plan the kernel cannot take.
bool make_params(Params* q, int out_bf16, int M, int K, int N, int group,
                 int bn, int S, int rows, int m_chunk, int mt, int ks) {
  Params& p = *q;
  p.M = M; p.K = K; p.N = N; p.group = group; p.G = group > 0 ? K / group : 0;
  p.rows = rows; p.S = S; p.bn = bn; p.cl = bn / 4;
  p.m_chunk = m_chunk; p.ks = ks; p.out_bf16 = out_bf16;
  p.rg = mt > 0 ? (m_chunk + mt - 1) / mt : 0;
  p.bn_sh = bn == 64 ? 6 : 7;
  p.g_sh = -1;
  for (int sh = 0; sh < 31; ++sh)
    if ((1 << sh) == group) p.g_sh = sh;
  return !((bn != 64 && bn != 128) || (mt != 4 && mt != 16) || S < 1 ||
           S > kMaxCluster || ks < 1 || m_chunk < 1 || m_chunk > 64 ||
           group < 1 || K % group || rows % group ||
           (long long)rows * S < K || M < 1);
}

}  // namespace

// x: (M, K) f32 or bf16; wq: (K, N) int8; scales: (K / group, N) f32;
// out: (M, N) f32 or bf16.  The plan (bn, S, rows, m_chunk, mt, ks) is
// kernels/quant_matmul.py::qmm_plan's.  aligned: N % 16 == 0, K and
// group multiples of 8, and x, wq, scales 16-byte aligned (the TMA
// path); otherwise the element-wise variant.  Returns the CUDA error of
// the launch; a plan the kernel cannot take is cudaErrorInvalidValue.
extern "C" int quant_matmul_launch(const void* x, int x_bf16, const void* wq,
                                   const void* scales, void* out,
                                   int out_bf16, int M, int K, int N,
                                   int group, int bn, int S, int rows,
                                   int m_chunk, int mt, int ks, int aligned,
                                   void* stream) {
  Params p;
  if (!make_params(&p, out_bf16, M, K, N, group, bn, S, rows, m_chunk, mt,
                   ks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_x<__nv_bfloat16>(mt, aligned, x, wq, scales, out, p,
                                          st)
                : launch_x<float>(mt, aligned, x, wq, scales, out, p, st);
}
