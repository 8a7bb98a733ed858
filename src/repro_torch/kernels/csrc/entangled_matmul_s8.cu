// Fused entangled integer GEMM for Hopper (sm_90a) on the s8 tensor cores:
// the dense and the grouped (per-expert, MoE) form of every call whose
// weights are int8 lanes packed 4 per int32 word.
//
// Replaces two Pallas TPU kernels: repro/kernels/entangled_matmul.py
// (entangled_matmul_pallas, body _emm_kernel) and
// repro/kernels/entangled_matmul_grouped.py (entangled_matmul_grouped_pallas,
// body _emmg_kernel), for packed weights. For c [M, E, Cg, K] int32 and g
// [E, ceil(K/4), N] (lane j of a word is k = 4q + j, bits [8j, 8j+8)) it
// computes, exactly mod 2^32, per expert e (the dense form is E = 1):
//
//   prologue  eps[m] = (c[(m-1) mod M] << l) + c[m]     (modes True/False)
//             eps = c                                    (chain modes)
//   body      acc[m] = eps[m] @ g                        (mod 2^32)
//   epilogue  out = disentangle(acc, r)                  (modes True/'chain_final')
//             out = acc                                  (modes False/'chain')
//
// Unpacked (full-range int32) weights have no s8 form; they take the
// CUDA-core kernel of entangled_matmul.cu.
//
// Exact byte limbs. eps is a full 32-bit word, but as uint32 it is
// sum_{u<4} eps_u 2^{8u} with limbs eps_u in [0, 255], and the product is
// linear, so acc = sum_u (eps_u @ g) << 8u mod 2^32. Each limb product is
// an exact u8 x s8 -> s32 tensor-core product while its depth is at most
// 65536 (255 * 128 * 65536 < 2^31, so no partial sum leaves s32). A deeper
// K is split over gridDim.z into chunks of at most MAX_K, whose recombined
// 32-bit sums add mod 2^32 (exact by linearity); the launcher refuses a
// longer chunk. All four limbs are always computed (the chain modes pass
// any word).
//
// What bounds it on an H100: at the serving shapes (a few rows per stream,
// K x N weights streamed once) the 4 (M-1) B K N limb MACs take a few
// microseconds at the int8 tensor-core rate, far below the time to read
// the packed weights once, so the kernel is bound by the weight bytes.
// The design follows from that:
//   * orientation: the MMA's 16-row side (mma.sync.m16n8k32, A from
//     registers) takes weight columns n, and its 8-column side takes
//     (stream slot, row, limb). A packed word is 4 consecutive k of one
//     column n, which is exactly one register of an s8 A fragment: the
//     weights reach the tensor core with no unpacking. The fragment row
//     <-> n mapping is free (the epilogue stages the tile through shared
//     memory), so a thread reads its 4 rows of two 16-row tiles as one
//     16-byte word of 4 consecutive n;
//   * a ring of STAGES weight tiles in shared memory (256 columns, so
//     each k-row is a 1 KB run of device memory), filled asynchronously by
//     cp.async from every thread: 16-byte copies where the row stride
//     N * 4 and the base are 16-byte aligned, 4-byte copies with zero fill
//     otherwise (ragged N), one commit group per stage and one barrier per
//     stage. The matching slice of c rides in the same stage. One bulk
//     copy (TMA) per k-row on an mbarrier was slower at the serving shapes
//     (PERF.md);
//   * eps is entangled from the staged c while the B fragments are built,
//     and split into its byte limbs with six byte permutes per 4 k;
//   * grouped form: before it issues any load of weights, a block checks
//     whether the entangled operand of every stream it computes is zero
//     over its rows and its K range (an expert no token was routed to:
//     its rows are zero); if so it skips the product, and extracting zero
//     accumulators gives zero;
//   * narrow N, or K > 65536, splits K over gridDim.z; each split recombines its limbs
//     and adds its 32-bit partial sums by atomics (exact mod 2^32), and the
//     last block of a tile to arrive runs the epilogue;
//   * epilogue: limb recombination, then disentangle_one of codec.cuh
//     (shared with the CUDA-core kernel and the codec passes), which
//     never reads stream r: in the extracting modes only the M-1 other
//     streams are computed, in the rotated order (r+1, ..., r+M-1) mod M.
//     Outputs leave in 16-byte stores where N allows.
// The MMA is the warp-level mma.sync, not the warpgroup wgmma: the shapes
// are bound by the weight bytes, so the tensor-core issue rate is not the
// limit (PERF.md has the times against both bounds).
// The ragged edges of Cg, K and N are masked here; callers pass any shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TPW = 1;                 // pairs of 16-row MMA tiles per warp
constexpr int WARP_N = 32 * TPW;       // columns per warp
constexpr int BN = WARPS * WARP_N;     // columns per block
constexpr int BKQ = 16;                // packed k-rows per stage
constexpr int BK = 4 * BKQ;            // contraction depth per stage
constexpr int STAGES = 4;              // ring depth
constexpr int WS = BN + 8;             // weight row stride (words): 8 mod 32
constexpr int CS = BK + 16;            // c row stride (words): 16 mod 32
constexpr int ES = BN + 4;             // epilogue tile row stride (words)
constexpr int MAX_K = 65536;           // deepest split: limb sums stay in s32
constexpr int MAX_PAIRS = 16;          // (slot, row) pairs of a block
constexpr int MAX_CROWS = 24;          // M * bb rows of c: (ns + 1) * bb
constexpr int HEAD = 128;              // the split-K flag, before the ring

struct Params {
  const int32_t* c;        // [M, B, K], B = E * Cg rows (expert-major)
  const int32_t* g;        // [E, ceil(K/4), N] packed
  int32_t* out;            // [M, B, N]
  int32_t* ws;             // split-K partial sums [M-1, B, N], zeroed (extract modes)
  unsigned int* counters;  // split-K arrivals, one per tile, zeroed
  int B, K, N;
  int Cg;                  // rows of one expert per stream (B when E = 1)
  int row_tiles;           // blocks along one expert's rows, ceil(Cg / bb)
  int bb;                  // rows per block
  long long g_stride;      // words from one expert's weights to the next
  int l, r;
  int entangle, extract, dualword;
  int k_chunk;             // contraction length of one split, multiple of BK
  int wvec;                // weights by 16-byte copies (16-byte aligned rows)
  int cvec;                // c by 16-byte cp.async (K % 4 == 0, aligned)
  int skip_empty;          // grouped form: skip a block whose eps is zero
};

// ---------------------------------------------------- device primitives --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// 4-byte copy; zero fill when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16-byte copy; zero fill when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// d += a (16 x 32 s8, row) * b (32 x 8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_s8u8(int32_t (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------------- the kernel --

// byte limbs of four consecutive k: limb[u] byte i = byte u of e[i]
__device__ __forceinline__ void limbs4(const uint4& e, uint32_t (&limb)[4]) {
  const uint32_t lo01 = __byte_perm(e.x, e.y, 0x5140);
  const uint32_t hi01 = __byte_perm(e.x, e.y, 0x7362);
  const uint32_t lo23 = __byte_perm(e.z, e.w, 0x5140);
  const uint32_t hi23 = __byte_perm(e.z, e.w, 0x7362);
  limb[0] = __byte_perm(lo01, lo23, 0x5410);
  limb[1] = __byte_perm(lo01, lo23, 0x7632);
  limb[2] = __byte_perm(hi01, hi23, 0x5410);
  limb[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Accumulator slot j holds stream j, or in the extracting modes stream
// (r + 1 + j) mod M.
__device__ __forceinline__ int slot_stream(const Params& p, int M, int j) {
  return p.extract ? (p.r + 1 + j) % M : j;
}

struct Tile {        // this block's place in the grid
  int n0, e, b0, rows, kbeg, kend, n_it;
};

// Fill ring stage `s` with iteration `it`: the [BKQ, BN] weight words and
// the [M, bb, BK] slice of c (zero where masked), by cp.async from every
// thread, as one commit group per thread.
template <int M>
__device__ __forceinline__ void fill(const Params& p, const Tile& t,
                                     uint32_t* w_ring, uint32_t* c_ring,
                                     int s, int it) {
  const int tid = threadIdx.x;
  const int kbase = t.kbeg + it * BK;
  const int kq0 = kbase >> 2;
  const int kq_end = min(kq0 + BKQ, (t.kend + 3) >> 2);
  const int ncols = min(BN, p.N - t.n0);
  uint32_t* wst = w_ring + (size_t)s * BKQ * WS;
  uint32_t* cst = c_ring + (size_t)s * M * p.bb * CS;
  const int32_t* g = p.g + (size_t)t.e * p.g_stride;
  // c: row (m, b) of the stage is c[m, b0 + b, kbase : kbase + BK]
  const int crow = M * p.bb;
  if (p.cvec) {
    for (int i = tid; i < crow * (BK / 4); i += THREADS) {
      const int row = i / (BK / 4), k = 4 * (i % (BK / 4));
      const int m = row / p.bb, b = row % p.bb;
      const bool ok = b < t.rows && kbase + k < t.kend;
      const int32_t* src = ok
          ? p.c + ((size_t)m * p.B + t.b0 + b) * p.K + kbase + k : p.c;
      cp_async16(cst + row * CS + k, src, ok);
    }
  } else {
    for (int i = tid; i < crow * BK; i += THREADS) {
      const int row = i / BK, k = i % BK;
      const int m = row / p.bb, b = row % p.bb;
      const bool ok = b < t.rows && kbase + k < t.kend;
      const int32_t* src = ok
          ? p.c + ((size_t)m * p.B + t.b0 + b) * p.K + kbase + k : p.c;
      cp_async4(cst + row * CS + k, src, ok);
    }
  }
  // weights: row q of the stage is g[kq0 + q, n0 : n0 + BN]
  if (p.wvec) {
    for (int i = tid; i < BKQ * (BN / 4); i += THREADS) {
      const int q = i / (BN / 4), n = 4 * (i % (BN / 4));
      const bool ok = kq0 + q < kq_end && n < ncols;
      const int32_t* src = ok ? g + (size_t)(kq0 + q) * p.N + t.n0 + n : g;
      cp_async16(wst + q * WS + n, src, ok);
    }
  } else {
    for (int i = tid; i < BKQ * BN; i += THREADS) {
      const int q = i / BN, n = i % BN;
      const bool ok = kq0 + q < kq_end && n < ncols;
      const int32_t* src = ok ? g + (size_t)(kq0 + q) * p.N + t.n0 + n : g;
      cp_async4(wst + q * WS + n, src, ok);
    }
  }
}

// Is the entangled operand of every computed stream zero over this block's
// rows and K range? Each thread keeps U positions' loads of all M streams
// in flight at once (one L2 round trip per U positions).
template <int M>
__device__ __forceinline__ uint32_t eps_or(const Params& p, const uint32_t (&cv)[M]) {
  uint32_t any = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {  // every stream but r when extracting
    if (p.extract && m == p.r) continue;
    any |= p.entangle ? (cv[(m + M - 1) % M] << p.l) + cv[m] : cv[m];
  }
  return any;
}

template <int M>
__device__ __forceinline__ bool eps_all_zero(const Params& p, const Tile& t) {
  constexpr int U = M <= 4 ? 4 : 2;
  const int span = t.kend - t.kbeg;
  uint32_t any = 0;
  if (p.cvec) {
    const int quads = span / 4, n = t.rows * quads;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
      uint4 cv[U][M];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
        const int b = i / quads, k = t.kbeg + 4 * (i % quads);
#pragma unroll
        for (int m = 0; m < M; ++m)
          cv[u][m] = i < n ? __ldg(reinterpret_cast<const uint4*>(
                                 p.c + ((size_t)m * p.B + t.b0 + b) * p.K + k))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        uint32_t x[M], y[M], z[M], w[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          x[m] = cv[u][m].x; y[m] = cv[u][m].y;
          z[m] = cv[u][m].z; w[m] = cv[u][m].w;
        }
        any |= eps_or<M>(p, x) | eps_or<M>(p, y) | eps_or<M>(p, z)
             | eps_or<M>(p, w);
      }
    }
  } else {
    const int n = t.rows * span;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
      uint32_t cv[U][M];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
        const int b = i / span, k = t.kbeg + i % span;
#pragma unroll
        for (int m = 0; m < M; ++m)
          cv[u][m] = i < n ? (uint32_t)__ldg(
                                 p.c + ((size_t)m * p.B + t.b0 + b) * p.K + k)
                           : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) any |= eps_or<M>(p, cv[u]);
    }
  }
  return !__syncthreads_or(any != 0);
}

// Write the block's outputs from the staged tile e_t[pair][n] (pair j*bb+b
// holds slot j of row b): disentangled in the extracting modes.
template <int M>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& t,
                                           const uint32_t* e_t) {
  const bool vec = (p.N & 3) == 0;
  for (int i = threadIdx.x; i < t.rows * (BN / 4); i += THREADS) {
    const int b = i / (BN / 4), nl = 4 * (i % (BN / 4));
    const int n = t.n0 + nl;
    if (n >= p.N) continue;
    const int gb = t.b0 + b;
    uint32_t a[M][4];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < M - p.extract) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            e_t + (j * p.bb + b) * ES + nl);
        a[j][0] = v.x; a[j][1] = v.y; a[j][2] = v.z; a[j][3] = v.w;
      } else {
        a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0u;
      }
    }
    uint32_t o[M][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      uint32_t rot[M], ox[M];
#pragma unroll
      for (int j = 0; j < M; ++j) rot[j] = a[j][x];
      if (p.extract) {
        disentangle_one<M>(rot, ox, p.l, p.dualword);
#pragma unroll
        for (int j = 0; j < M; ++j) o[j][x] = ox[j];
      } else {
#pragma unroll
        for (int j = 0; j < M; ++j) o[j][x] = rot[j];
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      // row j of o is stream (r + j) mod M when extracting, else stream j
      const int m = p.extract ? (p.r + j) % M : j;
      int32_t* dst = p.out + ((size_t)m * p.B + gb) * p.N + n;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (n + x < p.N) dst[x] = (int32_t)o[j][x];
      }
    }
  }
}

// PG groups of 8 (slot, row) pairs: PG * 8 >= ns * bb.
template <int M, int PG>
__global__ void __launch_bounds__(THREADS) emm_kernel_s8(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  int* s_last = reinterpret_cast<int*>(smem);
  uint32_t* w_ring = reinterpret_cast<uint32_t*>(smem + HEAD);
  uint32_t* c_ring = w_ring + (size_t)STAGES * BKQ * WS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the MMA's group / thread-in-group
  Tile t;
  t.n0 = blockIdx.x * BN;
  t.e = blockIdx.y / p.row_tiles;
  const int eb0 = (blockIdx.y % p.row_tiles) * p.bb;
  t.b0 = t.e * p.Cg + eb0;
  t.rows = min(p.bb, p.Cg - eb0);
  t.kbeg = blockIdx.z * p.k_chunk;
  t.kend = min(p.K, t.kbeg + p.k_chunk);
  t.n_it = (t.kend - t.kbeg + BK - 1) / BK;
  const int ns = M - p.extract;

  // per pair group: this thread's B column (pair gq of the group) reads c
  // rows rc (stream) and rp (its predecessor) of the staged slice
  int rc[PG], rp[PG];
  bool live[PG];
#pragma unroll
  for (int pg = 0; pg < PG; ++pg) {
    const int q = pg * 8 + gq;
    live[pg] = q < ns * p.bb;
    const int j = live[pg] ? q / p.bb : 0, b = live[pg] ? q % p.bb : 0;
    const int m = slot_stream(p, M, j);
    rc[pg] = m * p.bb + b;
    rp[pg] = ((m + M - 1) % M) * p.bb + b;
  }

  int32_t acc[2 * TPW][PG][4][4];
#pragma unroll
  for (int T = 0; T < 2 * TPW; ++T)
#pragma unroll
    for (int pg = 0; pg < PG; ++pg)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[T][pg][u][x] = 0;

  const bool empty = p.skip_empty && eps_all_zero<M>(p, t);
  if (!empty) {
    // the ring: one commit group per stage (empty past the block's last
    // stage, so that group i is always stage i)
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < t.n_it) fill<M>(p, t, w_ring, c_ring, s, s);
      cp_async_commit();
    }
    // this thread's columns: 4 consecutive n from nw + 32 tp per tile pair
    const int nw = warp * WARP_N + 4 * gq;
#pragma unroll 1
    for (int it = 0; it < t.n_it; ++it) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage it
      __syncthreads();  // everyone's copies landed; stage it - 1 is free
      const int nxt = it + STAGES - 1;
      if (nxt < t.n_it) fill<M>(p, t, w_ring, c_ring, nxt % STAGES, nxt);
      cp_async_commit();
      const int s = it % STAGES;
      const uint32_t* wst = w_ring + (size_t)s * BKQ * WS;
      const uint32_t* cst = c_ring + (size_t)s * M * p.bb * CS;
#pragma unroll
      for (int ks = 0; ks < BKQ / 8; ++ks) {
        // A: k-rows q0 = 8 ks + tq (registers a0, a1) and q0 + 4 (a2, a3)
        const int q0 = ks * 8 + tq;
        uint32_t a[2 * TPW][4];
#pragma unroll
        for (int tp = 0; tp < TPW; ++tp) {
          const uint4 wa = *reinterpret_cast<const uint4*>(
              wst + q0 * WS + nw + 32 * tp);
          const uint4 wb = *reinterpret_cast<const uint4*>(
              wst + (q0 + 4) * WS + nw + 32 * tp);
          a[2 * tp][0] = wa.x; a[2 * tp][1] = wa.y;
          a[2 * tp][2] = wb.x; a[2 * tp][3] = wb.y;
          a[2 * tp + 1][0] = wa.z; a[2 * tp + 1][1] = wa.w;
          a[2 * tp + 1][2] = wb.z; a[2 * tp + 1][3] = wb.w;
        }
#pragma unroll
        for (int pg = 0; pg < PG; ++pg) {
          uint32_t la[4] = {0u, 0u, 0u, 0u}, lb[4] = {0u, 0u, 0u, 0u};
          if (live[pg]) {
            uint4 ea = *reinterpret_cast<const uint4*>(cst + rc[pg] * CS + 4 * q0);
            uint4 eb = *reinterpret_cast<const uint4*>(
                cst + rc[pg] * CS + 4 * (q0 + 4));
            if (p.entangle) {
              const uint4 pa = *reinterpret_cast<const uint4*>(
                  cst + rp[pg] * CS + 4 * q0);
              const uint4 pb = *reinterpret_cast<const uint4*>(
                  cst + rp[pg] * CS + 4 * (q0 + 4));
              ea.x += pa.x << p.l; ea.y += pa.y << p.l;
              ea.z += pa.z << p.l; ea.w += pa.w << p.l;
              eb.x += pb.x << p.l; eb.y += pb.y << p.l;
              eb.z += pb.z << p.l; eb.w += pb.w << p.l;
            }
            limbs4(ea, la);
            limbs4(eb, lb);
          }
#pragma unroll
          for (int T = 0; T < 2 * TPW; ++T)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              mma_s8u8(acc[T][pg][u], a[T], la[u], lb[u]);
        }
      }
    }
  }
  __syncthreads();  // the ring is free: stage the recombined tile in it

  // recombine the limbs and stage: fragment entry x of tile T (of tile
  // pair T / 2) is column n = nw + 32 (T / 2) + 2 (T % 2) + (x >> 1) and
  // pair 8 pg + 2 tq + (x & 1)
  uint32_t* e_t = w_ring;
  {
    const int nw = warp * WARP_N + 4 * gq;
#pragma unroll
    for (int T = 0; T < 2 * TPW; ++T)
#pragma unroll
      for (int pg = 0; pg < PG; ++pg)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const uint32_t v = (uint32_t)acc[T][pg][0][x]
              + ((uint32_t)acc[T][pg][1][x] << 8)
              + ((uint32_t)acc[T][pg][2][x] << 16)
              + ((uint32_t)acc[T][pg][3][x] << 24);
          e_t[(pg * 8 + 2 * tq + (x & 1)) * ES + nw + 32 * (T / 2)
              + 2 * (T % 2) + (x >> 1)] = v;
        }
  }
  __syncthreads();

  if (gridDim.z == 1) {
    store_tile<M>(p, t, e_t);
    return;
  }

  // split-K: add the partial sums where they meet, mod 2^32 (the
  // extracting modes meet in the [M-1, B, N] workspace, slot by slot)
  const int ncols = min(BN, p.N - t.n0);
  if (!empty) {
    int32_t* dst = p.extract ? p.ws : p.out;
    for (int i = tid; i < ns * t.rows * ncols; i += THREADS) {
      const int j = i / (t.rows * ncols), b = (i / ncols) % t.rows;
      const int nl = i % ncols;
      atomicAdd(reinterpret_cast<unsigned int*>(
                    &dst[((size_t)j * p.B + t.b0 + b) * p.N + t.n0 + nl]),
                e_t[(j * p.bb + b) * ES + nl]);
    }
  }
  if (!p.extract) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
    *s_last = atomicAdd(&p.counters[tile], 1u) == gridDim.z - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  // the last split of this tile: read the finished sums from L2 and run
  // the epilogue
  __threadfence();
  for (int i = tid; i < ns * t.rows * ncols; i += THREADS) {
    const int j = i / (t.rows * ncols), b = (i / ncols) % t.rows;
    const int nl = i % ncols;
    e_t[(j * p.bb + b) * ES + nl] = (uint32_t)__ldcg(
        &p.ws[((size_t)j * p.B + t.b0 + b) * p.N + t.n0 + nl]);
  }
  __syncthreads();
  store_tile<M>(p, t, e_t);
}

size_t smem_bytes(int crows) {
  return HEAD + (size_t)STAGES * (BKQ * WS + (size_t)crows * CS) * 4;
}

template <int M, int PG>
int launch_mp(const Params& p, dim3 grid, cudaStream_t s) {
  static bool sized = false;  // raise the dynamic shared memory cap once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        emm_kernel_s8<M, PG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_CROWS));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  emm_kernel_s8<M, PG><<<grid, THREADS, smem_bytes(M * p.bb), s>>>(p);
  return 0;
}

template <int M>
int launch_m(const Params& p, int pg, dim3 grid, cudaStream_t s) {
  return pg == 1 ? launch_mp<M, 1>(p, grid, s) : launch_mp<M, 2>(p, grid, s);
}

}  // namespace

extern "C" {

// Geometry the Python wrapper needs to size the grid and split K.
int emm_s8_block_n() { return BN; }
int emm_s8_block_k() { return BK; }

const char* emm_s8_error_string(int code) {
  if (code == -1) return "unsupported stream count M (need 3 <= M <= 8)";
  if (code == -2) return "unsupported rows per block bb";
  if (code == -3) return "invalid shape or split";
  if (code == -4) return "K split too deep for the s8 limbs (need k_chunk <= 65536)";
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the kernel on `stream`: c [M, E, Cg, K], packed g [E, ceil(K/4),
// N], out [M, E, Cg, N]; the dense form passes E = 1, Cg = B. ws and
// counters are sized by the wrapper for split-K (null when splits == 1).
// Returns 0, a negative code for a configuration the kernel does not take,
// or the cudaError_t of the launch.
int emm_s8_launch(const void* c, const void* g, void* out, void* ws,
                  void* counters, int M, int E, int Cg, int K, int N,
                  int entangle, int extract, int dualword, int l, int r,
                  int bb, int splits, int k_chunk, void* stream) {
  if (M < 3 || M > 8) return -1;
  if (k_chunk > MAX_K) return -4;
  if (E < 1 || Cg < 1 || K < 1 || N < 1 || splits < 1 ||
      k_chunk < BK || k_chunk % BK != 0 ||
      (long long)k_chunk * (splits - 1) >= K ||
      (long long)E * Cg > 0x7fffffff)
    return -3;
  const int ns = M - (extract ? 1 : 0);
  if (bb < 1 || ns * bb > MAX_PAIRS || M * bb > MAX_CROWS) return -2;
  const int row_tiles = (Cg + bb - 1) / bb;
  if ((long long)E * row_tiles > 65535 || splits > 65535) return -3;
  Params p;
  p.c = static_cast<const int32_t*>(c);
  p.g = static_cast<const int32_t*>(g);
  p.out = static_cast<int32_t*>(out);
  p.ws = static_cast<int32_t*>(ws);
  p.counters = static_cast<unsigned int*>(counters);
  p.B = E * Cg; p.K = K; p.N = N;
  p.Cg = Cg; p.row_tiles = row_tiles; p.bb = bb;
  p.g_stride = (long long)((K + 3) / 4) * N;
  p.l = l; p.r = r;
  p.entangle = entangle; p.extract = extract; p.dualword = dualword;
  p.k_chunk = k_chunk;
  p.wvec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  p.cvec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
  p.skip_empty = E > 1;
  const dim3 grid((N + BN - 1) / BN, E * row_tiles, splits);
  const int pg = ns * bb <= 8 ? 1 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (M) {
    case 3: rc = launch_m<3>(p, pg, grid, s); break;
    case 4: rc = launch_m<4>(p, pg, grid, s); break;
    case 5: rc = launch_m<5>(p, pg, grid, s); break;
    case 6: rc = launch_m<6>(p, pg, grid, s); break;
    case 7: rc = launch_m<7>(p, pg, grid, s); break;
    case 8: rc = launch_m<8>(p, pg, grid, s); break;
    default: return -1;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
