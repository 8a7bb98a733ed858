// Fused entangled integer GEMM for Hopper (sm_90a), CUDA cores: the dense
// form and the grouped (per-expert, MoE) form in one kernel. It is the
// route for unpacked, full-range int32 weights, which have no s8 form;
// packed int8 weights take the tensor-core kernel of
// entangled_matmul_s8.cu (this one still takes them when called directly,
// so the two designs can be timed side by side).
//
// Replaces two Pallas TPU kernels: repro/kernels/entangled_matmul.py
// (entangled_matmul_pallas, body _emm_kernel) and
// repro/kernels/entangled_matmul_grouped.py (entangled_matmul_grouped_pallas,
// body _emmg_kernel). For c [M, B, K] int32 and g [K, N] int32 (or
// [ceil(K/4), N] int8 lanes packed 4 per int32 word along K, lane j in bits
// [8j, 8j+8)) it computes, exactly mod 2^32:
//
//   prologue  eps[m] = (c[(m-1) mod M] << l) + c[m]     (modes True/False)
//             eps = c                                    (chain modes)
//   body      acc[m] += eps[m] @ g                       (uint32 multiply-add)
//   epilogue  out = disentangle(acc, r)                  (modes True/'chain_final')
//             out = acc                                  (modes False/'chain')
//
// The grouped form runs E such products at once, expert e's rows against
// expert e's weights: c [M, E, Cg, K], g [E, K, N] (packed [E, ceil(K/4), N])
// -> out [M, E, Cg, N]. The expert is one more grid coordinate: each block
// owns rows of one expert only and reads that expert's weights, and the
// dense form is the case E = 1, Cg = B (the two forms share
// every line of the kernel and its one launch function).
//
// The epilogue is eq. (16-19) of the paper: Horner telescoping of the M-1
// accumulators other than stream r (in one 32-bit word, or in a native
// 64-bit word for the dual-word plans), the sign-extended bit-field split
// of d_r and d_q, and the eq. (19) chain — disentangle_one of codec.cuh,
// which the standalone disentangle pass (codec_pass.cu) shares. In the extracting modes stream r
// is not computed at all: the block stages and accumulates only the M-1
// other streams, in the rotated order (r+1, ..., r+M-1) mod M that the
// telescoping consumes, so those modes do (M-1)/M of the multiply-adds.
//
// What bounds it on an H100: with full-range int32 weights the product
// has no tensor-core form (the byte-limb split of entangled_matmul_s8.cu
// needs s8 weights), so it runs as 32-bit integer multiply-adds on the
// CUDA cores, about half the fp32 issue rate. At the serving shapes (a few
// rows per stream, K x N weights streamed once) those MACs take longer
// than reading packed weights, so this kernel is bound by operations, not
// bytes. The design follows from that:
//   * one thread owns TN columns of N and the M x BB accumulators of them
//     in registers, so every packed weight word is loaded once from device
//     memory (coalesced across the warp) and feeds 4 x M x BB MACs;
//   * the [M, BB, BK] slice of c is entangled while it is staged in shared
//     memory, and read back as 16-byte broadcasts (every thread of a warp
//     reads the same address);
//   * a packed word becomes its four sign-extended lanes with one PRMT each
//     (lane_s8 of codec.cuh, shared with the packed entangled conv);
//   * narrow-N shapes split K over gridDim.z so the card has enough blocks;
//     the partial sums meet by 32-bit atomic adds (exact and
//     order-independent mod 2^32), and the last block of a tile to arrive
//     runs the epilogue.
// The ragged edges of Cg (B), K and N are masked here, so callers pass any
// shape unpadded. This simple design does not reach the MAC bound: the
// weight loads are not pipelined, and with up to 168 registers per thread
// few blocks fit an SM to hide their latency (PERF.md has its times
// against the bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

constexpr int THREADS = 128;          // threads per block
constexpr int TN = 2;                 // columns per thread, THREADS apart
constexpr int BN = THREADS * TN;      // columns per block
constexpr int BK = 32;                // contraction depth per staged tile

struct Params {
  const int32_t* c;        // [M, B, K], B = E * Cg rows (expert-major)
  const int32_t* g;        // [E, K, N], or [E, ceil(K/4), N] packed
  int32_t* out;            // [M, B, N]
  int32_t* ws;             // split-K partial sums [M-1, B, N], zeroed (extract modes)
  unsigned int* counters;  // split-K arrivals, one per (n, expert, b) tile, zeroed
  int B, K, N;
  int Cg;                  // rows of one expert per stream (B when E = 1)
  int row_tiles;           // blocks along one expert's rows, ceil(Cg / BB)
  long long g_stride;      // int32 words from one expert's weights to the next
  int l, r;
  int entangle, extract, dualword;
  int k_chunk;             // contraction length of one split, multiple of BK
};

// Accumulator slot j holds stream j, or in the extracting modes stream
// (r + 1 + j) mod M, and slot M-1 is then unused.
__device__ __forceinline__ int slot_stream(const Params& p, int M, int j) {
  return p.extract ? (p.r + 1 + j) % M : j;
}

template <int M, int BB>
__device__ __forceinline__ void store_tile(const Params& p,
                                           uint32_t (&acc)[M][BB][TN],
                                           int b0, int rows, int n0) {
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const int gb = b0 + b;
    if (b >= rows) continue;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int n = n0 + t * THREADS;
      if (n >= p.N) continue;
      uint32_t a[M], o[M];
#pragma unroll
      for (int j = 0; j < M; ++j) a[j] = acc[j][b][t];
      if (p.extract) {
        disentangle_one<M>(a, o, p.l, p.dualword);
#pragma unroll
        for (int i = 0; i < M; ++i)
          p.out[((size_t)((p.r + i) % M) * p.B + gb) * p.N + n] =
              (int32_t)o[i];
      } else {
#pragma unroll
        for (int m = 0; m < M; ++m)
          p.out[((size_t)m * p.B + gb) * p.N + n] = (int32_t)a[m];
      }
    }
  }
}

template <int M, int BB, bool PACKED>
__global__ void __launch_bounds__(THREADS) emm_kernel(Params p) {
  __shared__ __align__(16) uint32_t s_eps[M][BB][BK];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN + tid;
  // blockIdx.y walks the experts, and within one expert its row tiles
  const int e = blockIdx.y / p.row_tiles;
  const int eb0 = (blockIdx.y % p.row_tiles) * BB;  // first row within e
  const int b0 = e * p.Cg + eb0;                     // first row of c / out
  const int rows = min(BB, p.Cg - eb0);              // rows of the tile
  const int32_t* __restrict__ g = p.g + (size_t)e * p.g_stride;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);

  uint32_t acc[M][BB][TN];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[m][b][t] = 0u;

  // accumulator slots in use: the extracting modes skip stream r
  const int ns = M - p.extract;
  for (int kt = kbeg; kt < kend; kt += BK) {
    // prologue: stage the [ns, BB, BK] slice of c, entangled on load;
    // rows past the expert's Cg and depths past the split's end stage as
    // zeros
    for (int i = tid; i < ns * BB * BK; i += THREADS) {
      const int j = i / (BB * BK);
      const int m = slot_stream(p, M, j);
      const int b = (i / BK) % BB;
      const int k = i % BK;
      const int gb = b0 + b, gk = kt + k;
      uint32_t v = 0;
      if (b < rows && gk < kend) {
        v = (uint32_t)p.c[((size_t)m * p.B + gb) * p.K + gk];
        if (p.entangle) {
          const int pm = (m + M - 1) % M;
          const uint32_t cp = (uint32_t)p.c[((size_t)pm * p.B + gb) * p.K + gk];
          v = (cp << p.l) + v;
        }
      }
      s_eps[j][b][k] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      uint32_t w[TN][4];
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int n = n0 + t * THREADS;
        if (PACKED) {
          uint32_t word = 0;
          if (n < p.N && kt + kk < kend)
            word = (uint32_t)g[(size_t)((kt + kk) >> 2) * p.N + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[t][j] = lane_s8(word, j);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kt + kk + j;
            w[t][j] = (n < p.N && k < kend)
                          ? (uint32_t)g[(size_t)k * p.N + n] : 0u;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m == M - 1 && p.extract) continue;  // no slot for stream r
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          const uint4 e = *reinterpret_cast<const uint4*>(&s_eps[m][b][kk]);
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            uint32_t s = acc[m][b][t];
            s += e.x * w[t][0];
            s += e.y * w[t][1];
            s += e.z * w[t][2];
            s += e.w * w[t][3];
            acc[m][b][t] = s;
          }
        }
      }
    }
    __syncthreads();
  }

  if (gridDim.z == 1) {
    store_tile<M, BB>(p, acc, b0, rows, n0);
    return;
  }

  // split-K: add the partial sums where they meet, mod 2^32 (the
  // extracting modes meet in the [M-1, B, N] workspace, slot by slot)
  int32_t* dst = p.extract ? p.ws : p.out;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int gb = b0 + b, n = n0 + t * THREADS;
        if (m < ns && b < rows && n < p.N)
          atomicAdd(reinterpret_cast<unsigned int*>(
                        &dst[((size_t)m * p.B + gb) * p.N + n]),
                    acc[m][b][t]);
      }
  if (!p.extract) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
    s_last = atomicAdd(&p.counters[tile], 1u) == gridDim.z - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last split of this tile: read the finished sums from L2 and run
  // the epilogue
  __threadfence();
#pragma unroll
  for (int m = 0; m < M - 1; ++m)
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int gb = b0 + b, n = n0 + t * THREADS;
        acc[m][b][t] = (b < rows && n < p.N)
            ? (uint32_t)__ldcg(&p.ws[((size_t)m * p.B + gb) * p.N + n]) : 0u;
      }
  store_tile<M, BB>(p, acc, b0, rows, n0);
}

template <int M, int BB>
void launch_mb(const Params& p, int packed, dim3 grid, cudaStream_t s) {
  if (packed)
    emm_kernel<M, BB, true><<<grid, THREADS, 0, s>>>(p);
  else
    emm_kernel<M, BB, false><<<grid, THREADS, 0, s>>>(p);
}

// bb (rows per block) is 1, 2, 4, or 8 (8 only for M <= 4, which keeps the
// M x BB x TN accumulators at <= 64 registers)
template <int M>
int launch_m(const Params& p, int bb, int packed, dim3 grid, cudaStream_t s) {
  switch (bb) {
    case 1: launch_mb<M, 1>(p, packed, grid, s); return 0;
    case 2: launch_mb<M, 2>(p, packed, grid, s); return 0;
    case 4: launch_mb<M, 4>(p, packed, grid, s); return 0;
    case 8:
      if constexpr (M <= 4) {
        launch_mb<M, 8>(p, packed, grid, s);
        return 0;
      }
      return -2;
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Geometry the Python wrapper needs to size the grid and split K.
int emm_threads() { return THREADS; }
int emm_block_n() { return BN; }
int emm_block_k() { return BK; }

const char* emm_error_string(int code) {
  if (code == -1) return "unsupported stream count M (need 3 <= M <= 8)";
  if (code == -2) return "unsupported rows per block bb";
  if (code == -3) return "invalid shape or split";
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the kernel on `stream`: c [M, E, Cg, K], g [E, K, N] (packed
// [E, ceil(K/4), N]), out [M, E, Cg, N]; the dense form passes E = 1,
// Cg = B. ws and counters are sized by the wrapper for split-K (null when
// splits == 1). Returns 0, a negative code for a configuration the kernel
// does not take, or the cudaError_t of the launch.
int emmg_launch(const void* c, const void* g, void* out, void* ws,
                void* counters, int M, int E, int Cg, int K, int N,
                int packed, int entangle, int extract, int dualword, int l,
                int r, int bb, int splits, int k_chunk, void* stream) {
  if (E < 1 || Cg < 1 || K < 1 || N < 1 || bb < 1 || splits < 1 ||
      k_chunk < BK || k_chunk % BK != 0 ||
      (long long)k_chunk * (splits - 1) >= K ||
      (long long)E * Cg > 0x7fffffff)
    return -3;
  const int row_tiles = (Cg + bb - 1) / bb;
  if ((long long)E * row_tiles > 65535 || splits > 65535) return -3;
  Params p;
  p.c = static_cast<const int32_t*>(c);
  p.g = static_cast<const int32_t*>(g);
  p.out = static_cast<int32_t*>(out);
  p.ws = static_cast<int32_t*>(ws);
  p.counters = static_cast<unsigned int*>(counters);
  p.B = E * Cg; p.K = K; p.N = N;
  p.Cg = Cg; p.row_tiles = row_tiles;
  p.g_stride = (long long)(packed ? (K + 3) / 4 : K) * N;
  p.l = l; p.r = r;
  p.entangle = entangle; p.extract = extract; p.dualword = dualword;
  p.k_chunk = k_chunk;
  const dim3 grid((N + BN - 1) / BN, E * row_tiles, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (M) {
    case 3: rc = launch_m<3>(p, bb, packed, grid, s); break;
    case 4: rc = launch_m<4>(p, bb, packed, grid, s); break;
    case 5: rc = launch_m<5>(p, bb, packed, grid, s); break;
    case 6: rc = launch_m<6>(p, bb, packed, grid, s); break;
    case 7: rc = launch_m<7>(p, bb, packed, grid, s); break;
    case 8: rc = launch_m<8>(p, bb, packed, grid, s); break;
    default: return -1;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
