// Depthwise causal integer conv1d for Hopper (sm_90a): the plain form and
// the entangled form (entangle on load, optional fused extraction), on two
// hand-written routes in one source.
//
// Replaces two Pallas TPU kernels:
//   repro/kernels/conv1d.py (conv1d_causal_pallas, body _conv1d_kernel):
//       out[b,d,t] = sum_j w[d,j] * x[b,d,t-Kf+1+j], zero left padding, for
//       x [B, D, T] and w [D, Kf];
//   repro/kernels/entangled_conv1d.py (entangled_conv1d_pallas, body
//       _econv_kernel): the same conv of the M entangled streams
//       eps_m = (x_{(m-1) mod M} << l) + x_m of x [M, B, D, T] (the halo
//       entangled too), with taps w [D, Kf] or int8 lanes packed 4 per int32
//       word along D ([ceil(D/4), Kf], lane d % 4 in bits [8(d%4), 8(d%4)+8)),
//       and optionally the disentangled true outputs (eq. 16-19).
// The plain form is the instance M = 1 without the codec. Every value is a
// uint32 in ring arithmetic mod 2^32: the entangled products wrap by design.
// Both routes take any int32 words and taps, any Kf >= 1 and any T (ragged
// edges masked here), M = 1 or 3 <= M <= 8, packed or unpacked taps, both
// modes and every failed stream r, and give the same bits.
//
// Route s8: the int8 tensor cores. What bounds the conv at the paper's
// stream shapes (D = 1, T about 1e6, Kf up to 4500) is the Kf
// multiply-adds per output, and an int32 product mod 2^32 is exact as a sum
// of byte-limb products, so they run as warpgroup MMAs
// (wgmma.m64nNk32.s32.s8.u8, N = 48, or 8 when T is short):
//   * the conv of one row as a Toeplitz x Hankel product: outputs in blocks
//     of P = 64, out[t0 + jP + p] = sum_k W[p,k] X[k,j] with W[p,k] =
//     w[k - p] (the taps, zero outside [0, Kf)) and X[k,j] = eps[t0 + jP + k
//     - (Kf-1)] (overlapping windows of one staged segment); depth Kf + P -
//     1 rounded to 32, so at most (Kf + 94) / Kf of the T Kf multiply-adds:
//     1.7% more at Kf = 4500;
//   * exact limbs: eps as uint32 is sum_u eps_u 2^(8u) (u8 limbs, limbs4 of
//     codec.cuh), the taps take balanced signed limbs w = sum_v w_v 2^(8v),
//     w_v in [-128, 127]; only u + v <= 3 matters mod 2^32, one s32
//     accumulator per shift u + v holds at most 4 products of 255 x 128, so
//     taps are staged in chunks of at most KC_MAX = 4608 (< 16,448) and each
//     chunk's accumulators are folded, shifted, into the uint32 result;
//   * the tap limb planes above the highest one that is nonzero over the
//     chunk are skipped, decided in the block (no host read, so a CUDA
//     graph can capture the launch): taps in [-128, 128) take 4 limb
//     products, full-range taps 10. The data limbs are always all four;
//   * the window of one stream slot is entangled while it is staged
//     (eps = (x_{m-1} << l) + x_m) as four u8 limb planes in shared memory
//     that are the MMA's B operand as they lie, with no copy (each thread
//     fences its stores to the async proxy, fence.proxy.async, before the
//     barrier that precedes the MMAs): Hankel row j
//     at depth k is byte j P + k, and with the plane's 16-byte segments
//     kept by residue mod 4 (segment s in block s % 4, slot s / 4) the 8
//     rows of a core matrix sit 16 bytes apart, the next 8 rows 128 bytes
//     on and the next 16 of depth one block on: a K-major layout without
//     swizzle (stride 128, leading offset one block);
//   * the taps are the A operand, from registers: a lane's fragment of row
//     p at depth k is the tap bytes k - p, eight words of a tap limb plane
//     funnel-shifted by (-p) mod 4 bytes; the planes are staged once per
//     chunk for every slot. All MMAs of a step are issued with no branch
//     between them (a branch there makes ptxas serialize every wgmma of
//     the kernel), then waited for;
//   * a block (one warpgroup) owns one (b, d) row and N Hankel rows (3072
//     or 512 outputs), and runs the stream slots one after the other: with
//     extraction only the M - 1 slots (r+1, ..., r+M-1) mod M, stream r is
//     never staged or computed. Each slot's folded tile leaves through
//     shared memory in coalesced stores (16-byte where the row is aligned)
//     into its stream's plane of `out`; with extraction the block then
//     reads its own tile's M - 1 entangled values back and writes the M
//     disentangled streams (disentangle_one of codec.cuh).
// A first form on the warp-level mma.sync (the Hankel data as A through
// ldmatrix, the taps as B) was slower on the H100: its MMA loop alone ran
// above twice the limb-product bound (PERF.md has both forms' times).
//
// Route cuda_core: int32 multiply-adds on the CUDA cores, the route of
// short filters, where the conv is bound by device-memory bytes (the
// depthwise model shape: D = 8192, T = 512, Kf = 4). A thread owns R = 4
// consecutive outputs of each stream (one 16-byte store per stream where
// the row is aligned; a warp's stores cover 512 contiguous bytes); a block
// owns 256 / tpr rows (b, d) of tpr threads, the time tile tpr * R fitted
// to T (32 <= tpr <= 256); taps are staged in chunks of multiples of 4
// (Kf = 4 is one group of four, not padded); the window of the M streams
// is entangled while it is staged (entangle_one of codec.cuh, all M words
// of a position in registers; 16-byte loads where T and x allow); with
// extraction stream r is neither staged nor computed and the M - 1 others
// are accumulated in the rotated order that disentangle_one consumes at
// the flush.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

struct Params {
  const int32_t* x;   // [M, B, D, T] (M = 1: [B, D, T])
  const int32_t* w;   // [D, Kf], or [ceil(D/4), Kf] packed
  int32_t* out;       // [M, B, D, T]
  long long T;
  long long plane;    // B * D * T: words of one stream
  long long rows;     // B * D
  long long tiles;    // time tiles per row
  int D, Kf, M;
  int l, r, extract, dualword, packed;
  int vec;            // 16-byte stores: T % 4 == 0 and out 16-byte aligned
  int vecx;           // 16-byte loads: T % 4 == 0 and x 16-byte aligned
  int kc;             // taps per chunk
  int tpr, rb, tt, ws;       // cuda_core: threads per row, rows per block,
                             // time tile, window stride (words)
  int nj, tb, tlen, wlen;    // s8: Hankel rows and outputs per block, tap
                             // plane stride, window residue block (bytes)
};

// Tap j of depth d as a uint32 (a packed int8 lane sign-extended).
__device__ __forceinline__ uint32_t load_tap(const Params& p, int d, int j) {
  if (p.packed)
    return lane_s8(
        (uint32_t)__ldg(p.w + (long long)(d >> 2) * p.Kf + j), d & 3);
  return (uint32_t)__ldg(p.w + (long long)d * p.Kf + j);
}

// ------------------------------------------------------ route cuda_core --

namespace core {

constexpr int R = 4;               // consecutive outputs per thread
constexpr int MAX_THREADS = 256;   // rb * tpr

// Four outputs from t on: one 16-byte store when allowed, else masked words.
__device__ __forceinline__ void store4(int32_t* dst, long long t, long long T,
                                       const uint32_t (&v)[R], int vec) {
  if (vec && t + R <= T) {
    *reinterpret_cast<uint4*>(dst + t) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (t + i < T) dst[t + i] = (int32_t)v[i];
}

template <int M>
__global__ void __launch_bounds__(MAX_THREADS) conv_core(Params p) {
  constexpr bool ENT = M > 1;
  extern __shared__ __align__(16) uint32_t smem[];
  // slot s holds stream (base + s) mod M: stream s, or with extraction
  // stream (r + 1 + s) mod M, and slot M-1 (stream r) is then neither
  // staged nor computed. Entanglement is cyclic, so entangling a position's
  // words in slot order gives each slot its own stream's eps.
  const bool skip_last = ENT && p.extract;
  const int base = skip_last ? p.r + 1 : 0;
  uint32_t* s_w = smem;                  // [rb][kc] taps
  uint32_t* s_x = smem + p.rb * p.kc;    // [slot][rb][ws] windows
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long tile = blockIdx.x % p.tiles;
  const long long row0 = (blockIdx.x / p.tiles) * p.rb;
  const int nrows = (int)min((long long)p.rb, p.rows - row0);
  const long long t0 = tile * p.tt;
  const int rl = tid / p.tpr;            // row of the block
  const int i0 = (tid % p.tpr) * R;      // first output of the thread

  uint32_t acc[M][R];
#pragma unroll
  for (int s = 0; s < M; ++s)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[s][i] = 0u;

  for (int j0 = 0; j0 < p.Kf; j0 += p.kc) {
    const int kc = min(p.kc, p.Kf - j0);
    const int kcp = (kc + 3) & ~3;       // zero taps fill the last group
    const int wl = p.tt + kcp;           // window positions read
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < nrows * kcp; i += nthr) {
      const int rr = i / kcp, jj = i - rr * kcp;
      s_w[rr * p.kc + jj] =
          jj < kc ? load_tap(p, (int)((row0 + rr) % p.D), j0 + jj) : 0u;
    }
    // window position q of a row holds input time x0 + q
    const long long x0 = t0 - (p.Kf - 1) + j0;
    if (p.vecx) {
      // groups of four aligned times from x0 rounded down: one 16-byte
      // load per stream where the group lies inside [0, T)
      const long long xa = x0 & ~3LL;
      const int ng = (int)((x0 + wl - xa + 3) >> 2);
      for (int i = tid; i < nrows * ng; i += nthr) {
        const int rr = i / ng, gi = i - rr * ng;
        const long long ta = xa + 4 * gi;
        const int32_t* xr = p.x + (row0 + rr) * p.T + ta;
        uint32_t v[4][M];
        if (ta >= 0 && ta + 4 <= p.T) {
#pragma unroll
          for (int s = 0; s < M; ++s) {
            const uint4 q4 = __ldg(reinterpret_cast<const uint4*>(
                xr + ((base + s) % M) * p.plane));
            v[0][s] = q4.x; v[1][s] = q4.y; v[2][s] = q4.z; v[3][s] = q4.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = ta + e >= 0 && ta + e < p.T;
#pragma unroll
            for (int s = 0; s < M; ++s)
              v[e][s] = in ? (uint32_t)__ldg(xr + ((base + s) % M) * p.plane + e)
                           : 0u;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long q = ta + e - x0;
          if (q < 0 || q >= wl) continue;
          if constexpr (ENT) {
            uint32_t en[M];
            entangle_one<M>(v[e], en, p.l);
#pragma unroll
            for (int s = 0; s < M; ++s) {
              if (s == M - 1 && skip_last) continue;
              s_x[(s * p.rb + rr) * p.ws + q] = en[s];
            }
          } else {
            s_x[rr * p.ws + q] = v[e][0];
          }
        }
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < nrows * wl; i += nthr) {
        const int rr = i / wl, q = i - rr * wl;
        const long long t = x0 + q;
        const bool in = t >= 0 && t < p.T;
        const int32_t* xr = p.x + (row0 + rr) * p.T + t;
        uint32_t v[M];
#pragma unroll
        for (int s = 0; s < M; ++s)
          v[s] = in ? (uint32_t)__ldg(xr + ((base + s) % M) * p.plane) : 0u;
        if constexpr (ENT) {
          uint32_t e[M];
          entangle_one<M>(v, e, p.l);
#pragma unroll
          for (int s = 0; s < M; ++s) {
            if (s == M - 1 && skip_last) continue;
            s_x[(s * p.rb + rr) * p.ws + q] = e[s];
          }
        } else {
          s_x[rr * p.ws + q] = v[0];
        }
      }
    }
    __syncthreads();
    if (rl < nrows) {
      const uint32_t* wr = s_w + rl * p.kc;
      for (int jg = 0; jg < kcp; jg += 4) {
        const uint4 wv = *reinterpret_cast<const uint4*>(wr + jg);
        const uint32_t w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int s = 0; s < M; ++s) {
          if (s == M - 1 && skip_last) continue;
          const uint32_t* xs = s_x + (s * p.rb + rl) * p.ws + i0 + jg;
          const uint4 a = *reinterpret_cast<const uint4*>(xs);
          const uint4 b = *reinterpret_cast<const uint4*>(xs + 4);
          const uint32_t xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < R; ++i) acc[s][i] += w4[k] * xv[i + k];
        }
      }
    }
  }

  // flush: R outputs per stream, ragged end of T masked
  const long long t = t0 + i0;
  if (rl >= nrows || t >= p.T) return;
  int32_t* out = p.out + (row0 + rl) * p.T;
  if constexpr (ENT) {
    if (skip_last) {
      uint32_t o[M][R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        uint32_t rot[M], ox[M];
#pragma unroll
        for (int s = 0; s < M; ++s) rot[s] = acc[s][i];
        disentangle_one<M>(rot, ox, p.l, p.dualword);
#pragma unroll
        for (int q = 0; q < M; ++q) o[q][i] = ox[q];
      }
#pragma unroll
      for (int q = 0; q < M; ++q)
        store4(out + (long long)((p.r + q) % M) * p.plane, t, p.T, o[q], p.vec);
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    store4(out + (long long)m * p.plane, t, p.T, acc[m], p.vec);
}

// Geometry: the time tile fitted to T, several rows per block when T is
// short, tap chunks of at most tpr (so rb * kc <= 256 words); every buffer
// stays within the 48 KB of static shared memory.
void geometry(Params& p) {
  int tpr = 32;
  while (tpr < MAX_THREADS && (long long)tpr * R < p.T) tpr *= 2;
  p.tpr = tpr;
  p.rb = (int)min((long long)(MAX_THREADS / tpr), p.rows);
  p.tt = tpr * R;
  p.kc = min((p.Kf + 3) & ~3, tpr);
  p.ws = p.tt + p.kc;
  p.tiles = (p.T + p.tt - 1) / p.tt;
}

size_t smem_bytes(const Params& p, int slots) {
  return ((size_t)p.rb * p.kc + (size_t)slots * p.rb * p.ws) * 4;
}

template <int M>
void launch(const Params& p, unsigned int grid, int slots, cudaStream_t s) {
  conv_core<M><<<grid, p.rb * p.tpr, smem_bytes(p, slots), s>>>(p);
}

}  // namespace core

// ------------------------------------------------------------ route s8 --

namespace s8 {

constexpr int P = 64;             // outputs per Hankel row: the wgmma's M
constexpr int NJ_LONG = 48;       // Hankel rows per block (the wgmma's N)
constexpr int NJ_SHORT = 8;       // ... for T below one NJ_LONG tile
constexpr int THREADS = 128;      // one warpgroup
constexpr int KC_MAX = 4608;      // taps per chunk; s32 sums exact to 16,447
constexpr int LEAD = 80;          // zero bytes before tap 0 of a tap plane
constexpr int STAGE = 4;          // window groups a thread loads at once

__host__ __device__ constexpr int depth32(int kc) {
  return (P - 1 + kc + 31) / 32 * 32;
}

// Bytes of one residue block of a window plane: the chunk's window
// (NJ - 1) P + d32 bytes in 16-byte segments, a quarter of them per block.
__host__ __device__ constexpr int segblk(int nj, int d32) {
  return ((nj - 1) * P + d32 + 63) / 64 * 16;
}

// Window position q of a limb plane: its 16-byte segment s = q / 16 sits in
// residue block s % 4, at slot s / 4. Hankel row j at depth k is position
// j P + k, segment 4 j + k / 16: the 8 rows of a core matrix are then 16
// bytes apart, 8 rows on 128 bytes, the next 16 of depth one block on.
__device__ __forceinline__ int win_off(int q, int segb) {
  return ((q >> 4) & 3) * segb + (q >> 6) * 16 + (q & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Shared memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices along K), stride byte offset (along
// N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
      | ((uint64_t)(sbo >> 4) << 32);
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy, through which wgmma reads its B operand (descriptor)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep a register where it is until here (the async MMA reads or writes it)
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 8 s32) += a (64 x 32 s8, registers) * b (32 x 8 u8, shared)
__device__ __forceinline__ void wgmma_s8u8(uint32_t (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.u8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 48 s32) += a (64 x 32 s8, registers) * b (32 x 48 u8, shared)
__device__ __forceinline__ void wgmma_s8u8(uint32_t (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Balanced signed byte limbs: w = sum_v l_v 2^(8v) mod 2^32, l_v in
// [-128, 127], returned as their bytes. In 32-bit ring arithmetic: after v
// limbs the rest is only needed mod 2^(32 - 8v), which the wrapped
// difference and the arithmetic shift keep.
__device__ __forceinline__ void tap_limbs(uint32_t w, uint32_t (&l)[4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    l[v] = w & 0xffu;
    w = (uint32_t)((int32_t)(w - (uint32_t)(int32_t)(int8_t)l[v]) >> 8);
  }
}

// The k loop of one slot and chunk: acc[u + v] += limb v of the taps (the
// Toeplitz A, rows p, from registers) x limb u of the windows (the Hankel
// B, columns j, from shared memory), tap limb planes v < NV. A lane's A
// fragment of row p at depth k is the tap bytes k - p: 8 consecutive words
// of the plane, funnel-shifted by (-p) mod 4 bytes. Every MMA of a step is
// issued unconditionally (a branch between them makes ptxas serialize all
// of the kernel's wgmma).
template <int NV, int NA>
__device__ __forceinline__ void kloop(uint32_t (&acc)[4][NA], uint32_t win,
                                      int segb, const uint32_t* taps,
                                      int tlen_w, int tb, int sh, int d32) {
  const uint32_t plane = 4 * segb;
#pragma unroll 1
  for (int kk = 0; kk < d32; kk += 32) {
    uint32_t a[NV][4];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint32_t* tw = taps + v * tlen_w + (kk >> 2) + tb;
      uint32_t wd[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) wd[e] = tw[e];
      a[v][1] = __funnelshift_r(wd[0], wd[1], sh);  // row p + 8, k
      a[v][0] = __funnelshift_r(wd[2], wd[3], sh);  // row p, k
      a[v][3] = __funnelshift_r(wd[4], wd[5], sh);  // row p + 8, k + 16
      a[v][2] = __funnelshift_r(wd[6], wd[7], sh);  // row p, k + 16
    }
    // depth kk of Hankel row 0 is segment kk / 16: residue block, slot
    const int e = kk >> 4;
    const uint32_t b0 = win + (e & 3) * segb + (e >> 2) * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int x = 0; x < NA; ++x) pin(acc[q][x]);
    wg_fence();
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int u = 0; u < 4 - v; ++u)
        wgmma_s8u8(acc[u + v], a[v], smem_desc(b0 + u * plane, segb, 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int x = 0; x < 4; ++x) pin(a[v][x]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int x = 0; x < NA; ++x) pin(acc[q][x]);
  }
}

// Extraction of the block's tile: the M - 1 entangled slots were written to
// their streams' planes of out; read them back and write the M streams.
template <int M>
__device__ __forceinline__ void flush(const Params& p, int32_t* orow,
                                      long long t0) {
  for (int i = threadIdx.x; i < p.tb; i += THREADS) {
    const long long t = t0 + i;
    if (t >= p.T) break;
    uint32_t rot[M], o[M];
#pragma unroll
    for (int s = 0; s < M - 1; ++s)
      rot[s] = (uint32_t)orow[(long long)((p.r + 1 + s) % M) * p.plane + t];
    rot[M - 1] = 0u;
    disentangle_one<M>(rot, o, p.l, p.dualword);
#pragma unroll
    for (int q = 0; q < M; ++q)
      orow[(long long)((p.r + q) % M) * p.plane + t] = (int32_t)o[q];
  }
}

template <int NJ>
__global__ void __launch_bounds__(THREADS) conv_s8(Params p) {
  constexpr int TB = NJ * P;
  extern __shared__ __align__(128) uint8_t smem8[];
  uint8_t* s_taps = smem8;                       // 4 planes x tlen bytes
  uint8_t* s_win = smem8 + 4 * p.tlen;           // 4 planes x 4 segb bytes
  uint32_t* st = reinterpret_cast<uint32_t*>(s_win + 16 * p.wlen);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;        // the MMA's group / thread
  const long long row = blockIdx.x / p.tiles;
  const long long t0 = (blockIdx.x % p.tiles) * TB;
  const int d = (int)(row % p.D);
  const bool skip_last = p.M > 1 && p.extract;
  const int ns = skip_last ? p.M - 1 : p.M;
  const int base = skip_last ? p.r + 1 : 0;
  const int32_t* xrow = p.x + row * p.T;
  int32_t* orow = p.out + row * p.T;
  const int segb = p.wlen;
  const uint32_t win = smem_addr(s_win);
  // this lane's A rows are p = 16 warp + g (+ 8); the tap bytes k - p of
  // row p + 8 at depth kk + 4 tq sit at byte LEAD + kk + 4 tq - p - 8 of a
  // plane: word kk / 4 + tb, shifted by sh bits
  const int tb = tq - 4 * warp + (LEAD - 8) / 4 - ((g + 3) >> 2);
  const int sh = 8 * ((4 - (g & 3)) & 3);
  const uint32_t* taps = reinterpret_cast<const uint32_t*>(s_taps);

  for (int j0 = 0, c = 0; j0 < p.Kf; j0 += p.kc, ++c) {
    const int kc = min(p.kc, p.Kf - j0);
    const int d32 = depth32(kc);
    const int wln = (NJ - 1) * P + d32;  // window positions read
    __syncthreads();  // the previous chunk's readers are done
    // tap limb planes: byte LEAD + y of plane v = limb v of tap j0 + y
    // (clamped loads, masked values, as the window's)
    uint32_t any = 0u;
    for (int wi = tid; wi < p.tlen / 4; wi += THREADS) {
      uint32_t tap[4], word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int y = 4 * wi - LEAD + b;
        tap[b] = load_tap(p, d, j0 + (y < 0 ? 0 : (y < kc ? y : kc - 1)));
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int y = 4 * wi - LEAD + b;
        uint32_t l[4];
        tap_limbs(y >= 0 && y < kc ? tap[b] : 0u, l);
#pragma unroll
        for (int v = 0; v < 4; ++v) word[v] |= l[v] << (8 * b);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        reinterpret_cast<uint32_t*>(s_taps + v * p.tlen)[wi] = word[v];
        any |= (word[v] != 0u ? 1u : 0u) << v;
      }
    }
    // the tap limb planes up to the highest one nonzero over the chunk
    int nv = 1;
    if (__syncthreads_or(any & 2u)) nv = 2;
    if (__syncthreads_or(any & 4u)) nv = 3;
    if (__syncthreads_or(any & 8u)) nv = 4;
    const long long x0 = t0 - (p.Kf - 1) + j0;
    for (int s = 0; s < ns; ++s) {
      const int m = (base + s) % p.M;
      const int32_t* xm = xrow + (long long)m * p.plane;
      const int32_t* xp = xrow + (long long)((m + p.M - 1) % p.M) * p.plane;
      if (s > 0) __syncthreads();  // the previous slot's readers are done
      // the slot's window, entangled, as four u8 limb planes; a thread
      // keeps STAGE groups of four positions' loads in flight at once
      // (clamped addresses, masked values: no load waits on a branch)
      const int ng = wln / 4;
      for (int g0 = tid; g0 < ng; g0 += STAGE * THREADS) {
        uint32_t e[STAGE][4];
#pragma unroll
        for (int r = 0; r < STAGE; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const long long t = x0 + 4 * (g0 + r * THREADS) + k;
            const long long tc = t < 0 ? 0 : (t < p.T ? t : p.T - 1);
            uint32_t v = (uint32_t)__ldg(xm + tc);
            if (p.M > 1) v += (uint32_t)__ldg(xp + tc) << p.l;
            e[r][k] = t >= 0 && t < p.T ? v : 0u;
          }
#pragma unroll
        for (int r = 0; r < STAGE; ++r) {
          const int gi = g0 + r * THREADS;
          if (gi >= ng) break;
          uint32_t limb[4];
          limbs4(make_uint4(e[r][0], e[r][1], e[r][2], e[r][3]), limb);
          const int off = win_off(4 * gi, segb);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            *reinterpret_cast<uint32_t*>(s_win + u * 4 * segb + off) = limb[u];
        }
      }
      fence_async_shared();  // the window is read by wgmma, not by loads
      __syncthreads();

      constexpr int NA = NJ / 2;  // accumulator registers per shift
      uint32_t acc[4][NA];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < NA; ++x) acc[q][x] = 0u;
      const int tlen_w = p.tlen / 4;
      switch (nv) {
        case 4: kloop<4>(acc, win, segb, taps, tlen_w, tb, sh, d32); break;
        case 3: kloop<3>(acc, win, segb, taps, tlen_w, tb, sh, d32); break;
        case 2: kloop<2>(acc, win, segb, taps, tlen_w, tb, sh, d32); break;
        default: kloop<1>(acc, win, segb, taps, tlen_w, tb, sh, d32);
      }

      // fold the shifts mod 2^32 into the block's tile: entry 4 i + x is
      // row p = 16 warp + g + 8 (x / 2), Hankel row j = 8 i + 2 tq + x % 2,
      // output j P + p
#pragma unroll
      for (int i = 0; i < NJ / 8; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int n = 4 * i + x;
          st[(8 * i + 2 * tq + (x & 1)) * P + 16 * warp + g + 8 * (x >> 1)] =
              acc[0][n] + (acc[1][n] << 8) + (acc[2][n] << 16)
              + (acc[3][n] << 24);
        }
      __syncthreads();
      // into the stream's plane, added to the earlier chunks' sums
      int32_t* dst = orow + (long long)m * p.plane;
      if (p.vec) {
        for (int i = 4 * tid; i < TB; i += 4 * THREADS) {
          const long long t = t0 + i;
          if (t >= p.T) break;
          uint4 v = *reinterpret_cast<const uint4*>(st + i);
          if (c > 0) {
            const uint4 o = *reinterpret_cast<const uint4*>(dst + t);
            v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
          }
          *reinterpret_cast<uint4*>(dst + t) = v;
        }
      } else {
        for (int i = tid; i < TB; i += THREADS) {
          const long long t = t0 + i;
          if (t >= p.T) break;
          uint32_t v = st[i];
          if (c > 0) v += (uint32_t)dst[t];
          dst[t] = (int32_t)v;
        }
      }
    }
  }
  if (!skip_last) return;
  __syncthreads();  // every slot of the tile is in out
  switch (p.M) {
    case 3: flush<3>(p, orow, t0); break;
    case 4: flush<4>(p, orow, t0); break;
    case 5: flush<5>(p, orow, t0); break;
    case 6: flush<6>(p, orow, t0); break;
    case 7: flush<7>(p, orow, t0); break;
    case 8: flush<8>(p, orow, t0); break;
  }
}

// Geometry: one warpgroup per NJ P outputs of a row, NJ = 48 (3072
// outputs) unless T is shorter than that, then 8 (512 outputs: the
// depthwise shape's T); one chunk up to KC_MAX taps.
void geometry(Params& p) {
  p.nj = p.T >= (long long)NJ_LONG * P ? NJ_LONG : NJ_SHORT;
  p.tb = p.nj * P;
  p.tiles = (p.T + p.tb - 1) / p.tb;
  p.kc = min(p.Kf, KC_MAX);
  const int d32 = depth32(p.kc);
  p.wlen = segblk(p.nj, d32);
  p.tlen = LEAD + d32 + 16;
}

size_t smem_bytes(int nj, int tlen, int wlen) {
  return 4 * (size_t)tlen + 16 * (size_t)wlen + 4 * (size_t)nj * P;
}

template <int NJ>
int launch_nj(const Params& p, unsigned int grid, cudaStream_t s) {
  static bool sized[SMEM_CAP_DEVICES] = {};
  const int d32 = depth32(KC_MAX);
  const cudaError_t e = raise_smem_cap(
      conv_s8<NJ>, (int)smem_bytes(NJ, LEAD + d32 + 16, segblk(NJ, d32)),
      sized);
  if (e != cudaSuccess) return (int)e;
  conv_s8<NJ><<<grid, THREADS, smem_bytes(NJ, p.tlen, p.wlen), s>>>(p);
  return 0;
}

int launch(const Params& p, unsigned int grid, cudaStream_t s) {
  return p.nj == NJ_LONG ? launch_nj<NJ_LONG>(p, grid, s)
                         : launch_nj<NJ_SHORT>(p, grid, s);
}

}  // namespace s8

}  // namespace

extern "C" {

const char* conv1d_error_string(int code) {
  if (code == -1)
    return "unsupported stream count M (need M = 1 for the plain conv, "
           "3 <= M <= 8 for the entangled one)";
  if (code == -2) return "unknown route (0: cuda_core, 1: s8)";
  if (code == -3) return "invalid shape, plan or failed stream";
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the conv on `stream`: x, out [M, B, D, T] int32 (contiguous,
// distinct), w [D, Kf] or packed [ceil(D/4), Kf] int32. M = 1 is the plain
// conv (no codec, unpacked taps); 3 <= M <= 8 entangles on load, and with
// extract = 1 disentangles at the flush without computing stream r (plan
// shift l, dual-word temporary when dualword = 1). route 0 runs the
// CUDA-core kernel, route 1 the s8 tensor-core kernel. Returns 0, a
// negative code for a configuration the kernel does not take, or the
// cudaError_t of the launch.
int conv1d_launch(const void* x, const void* w, void* out, int M, int B,
                  int D, long long T, int Kf, int packed, int l, int r,
                  int extract, int dualword, int route, void* stream) {
  if (M != 1 && (M < 3 || M > 8)) return -1;
  if (route != 0 && route != 1) return -2;
  if (B < 1 || D < 1 || T < 1 || Kf < 1) return -3;
  if (M == 1 && (packed || extract)) return -3;
  if (extract && (r < 0 || r >= M || (M - 1) * l > 31)) return -3;
  Params p;
  p.x = static_cast<const int32_t*>(x);
  p.w = static_cast<const int32_t*>(w);
  p.out = static_cast<int32_t*>(out);
  p.T = T;
  p.rows = (long long)B * D;
  p.plane = p.rows * T;
  p.D = D; p.Kf = Kf; p.M = M;
  p.l = l; p.r = r; p.extract = extract; p.dualword = dualword;
  p.packed = packed;
  p.vec = (T % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  p.vecx = (T % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int slots = (M > 1 && extract) ? M - 1 : M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    s8::geometry(p);
    const long long blocks = p.rows * p.tiles;
    if (blocks > 0x7fffffffLL) return -3;
    const int rc = s8::launch(p, (unsigned int)blocks, s);
    if (rc) return rc;
    return (int)cudaGetLastError();
  }
  core::geometry(p);
  const long long blocks = (p.rows + p.rb - 1) / p.rb * p.tiles;
  if (blocks > 0x7fffffffLL) return -3;
  const unsigned int grid = (unsigned int)blocks;
  switch (M) {
    case 1: core::launch<1>(p, grid, slots, s); break;
    case 3: core::launch<3>(p, grid, slots, s); break;
    case 4: core::launch<4>(p, grid, slots, s); break;
    case 5: core::launch<5>(p, grid, slots, s); break;
    case 6: core::launch<6>(p, grid, slots, s); break;
    case 7: core::launch<7>(p, grid, slots, s); break;
    case 8: core::launch<8>(p, grid, slots, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
