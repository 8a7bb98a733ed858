// Depthwise causal integer conv1d for Hopper (sm_90a), CUDA cores: the plain
// form and the entangled form (entangle on load, optional fused extraction)
// in one kernel.
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
//
// What bounds it on an H100. Two shapes use it: the paper's stream conv
// (D = 1, T about 1e6 samples, Kf up to 4500, the streams on B), where the
// Kf multiply-adds per output on the CUDA cores (int32 has no tensor-core
// form) take far longer than moving the bytes, so it is bound by
// operations; and the depthwise model shape (D = 8192, Kf = 4), bound by
// bytes. The design:
//   * a block owns one (b, d) row and a tile of TT = THREADS * R outputs in
//     time, for all M streams of the row; a thread owns R consecutive
//     outputs of each stream in registers. No depth tile (the TPU kernel's
//     128-deep one would be 127/128 padding at D = 1);
//   * the taps are staged in chunks of KC through shared memory, so any Kf
//     runs (the TPU kernel needs Kf <= its time tile), and with each chunk
//     the TT + KC - 1 input window it needs: only the Kf - 1 halo columns
//     beyond the tile are read, not a whole predecessor tile. The window of
//     the M streams is entangled while it is staged (all M words of a
//     column in registers, entangle_one of codec.cuh), zeros outside
//     [0, T);
//   * the inner loop takes R taps at a time: R tap values (one shared
//     broadcast, read once for all M streams) and 2R - 1 window values per
//     stream (16-byte shared loads) feed R x R multiply-adds per stream;
//   * with extraction, stream r is neither staged nor computed: the M - 1
//     other streams are accumulated in the rotated order (r+1, ..., r+M-1)
//     mod M that disentangle_one of codec.cuh consumes at the flush, as in
//     entangled_matmul.cu.
// Ragged T is masked here, so callers pass any shape unpadded. Not done in
// this simple form: the window's 16-byte shared loads conflict two ways
// (a thread's R outputs are adjacent), and stores are 4 bytes a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

constexpr int THREADS = 128;        // threads per block
constexpr int R = 8;                // consecutive outputs per thread
constexpr int TT = THREADS * R;     // outputs per block (time tile)
constexpr int KC = 256;             // taps staged per chunk (multiple of R)

struct Params {
  const int32_t* x;   // [M, B, D, T] (M = 1: [B, D, T])
  const int32_t* w;   // [D, Kf], or [ceil(D/4), Kf] packed
  int32_t* out;       // [M, B, D, T]
  long long T;
  long long plane;    // B * D * T: words of one stream
  long long tiles;    // ceil(T / TT)
  int D, Kf;
  int l, r, extract, dualword;
};

template <int M, bool PACKED>
__global__ void __launch_bounds__(THREADS) conv_kernel(Params p) {
  constexpr bool ENT = M > 1;
  __shared__ __align__(16) uint32_t s_x[M][TT + KC];
  __shared__ __align__(16) uint32_t s_w[KC];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / p.tiles;  // b * D + d
  const long long t0 = (blockIdx.x % p.tiles) * TT;
  const int d = (int)(row % p.D);
  const int32_t* __restrict__ x = p.x + row * p.T;
  // slot s holds stream (base + s) mod M: stream s, or with extraction
  // stream (r + 1 + s) mod M, and slot M-1 (stream r) is then neither
  // staged nor computed. Entanglement is cyclic, so entangling the window's
  // words in slot order gives each slot its own stream's eps.
  const bool skip_last = ENT && p.extract;
  const int base = skip_last ? p.r + 1 : 0;

  uint32_t acc[M][R];
#pragma unroll
  for (int s = 0; s < M; ++s)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[s][i] = 0u;

  for (int j0 = 0; j0 < p.Kf; j0 += KC) {
    const int kc = min(KC, p.Kf - j0);
    const int kcp = (kc + R - 1) / R * R;  // zero taps pad the last group
    __syncthreads();  // the previous chunk's readers are done
    for (int jj = tid; jj < kcp; jj += THREADS) {
      uint32_t v = 0u;
      if (jj < kc) {
        if (PACKED)
          v = lane_s8((uint32_t)__ldg(p.w + (long long)(d >> 2) * p.Kf + j0 + jj),
                      d & 3);
        else
          v = (uint32_t)__ldg(p.w + (long long)d * p.Kf + j0 + jj);
      }
      s_w[jj] = v;
    }
    // window position q holds input time x0 + q
    const long long x0 = t0 - (p.Kf - 1) + j0;
    for (int q = tid; q < TT + kcp; q += THREADS) {
      const long long t = x0 + q;
      const bool in = t >= 0 && t < p.T;
      uint32_t v[M];
#pragma unroll
      for (int s = 0; s < M; ++s)
        v[s] = in ? (uint32_t)__ldg(x + ((base + s) % M) * p.plane + t) : 0u;
      if constexpr (ENT) {
        uint32_t e[M];
        entangle_one<M>(v, e, p.l);
#pragma unroll
        for (int s = 0; s < M; ++s) {
          if (s == M - 1 && skip_last) continue;
          s_x[s][q] = e[s];
        }
      } else {
        s_x[0][q] = v[0];
      }
    }
    __syncthreads();
    for (int jg = 0; jg < kcp; jg += R) {
      uint32_t wr[R];
#pragma unroll
      for (int k = 0; k < R; k += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(&s_w[jg + k]);
        wr[k] = v.x; wr[k + 1] = v.y; wr[k + 2] = v.z; wr[k + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (s == M - 1 && skip_last) continue;
        uint32_t xr[2 * R];
#pragma unroll
        for (int k = 0; k < 2 * R; k += 4) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(&s_x[s][tid * R + jg + k]);
          xr[k] = v.x; xr[k + 1] = v.y; xr[k + 2] = v.z; xr[k + 3] = v.w;
        }
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int i = 0; i < R; ++i) acc[s][i] += wr[jj] * xr[i + jj];
      }
    }
  }

  // flush: R outputs per stream, ragged end of T masked
  const long long tb = t0 + (long long)tid * R;
  int32_t* __restrict__ out = p.out + row * p.T;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long t = tb + i;
    if (t >= p.T) break;
    if constexpr (ENT) {
      if (skip_last) {
        uint32_t rot[M], o[M];
#pragma unroll
        for (int s = 0; s < M; ++s) rot[s] = acc[s][i];
        disentangle_one<M>(rot, o, p.l, p.dualword);
#pragma unroll
        for (int q = 0; q < M; ++q)
          out[(long long)((p.r + q) % M) * p.plane + t] = (int32_t)o[q];
        continue;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      out[(long long)m * p.plane + t] = (int32_t)acc[m][i];
  }
}

template <int M>
void launch_m(const Params& p, int packed, unsigned int grid, cudaStream_t s) {
  if (packed)
    conv_kernel<M, true><<<grid, THREADS, 0, s>>>(p);
  else
    conv_kernel<M, false><<<grid, THREADS, 0, s>>>(p);
}

}  // namespace

extern "C" {

const char* conv1d_error_string(int code) {
  if (code == -1)
    return "unsupported stream count M (need M = 1 for the plain conv, "
           "3 <= M <= 8 for the entangled one)";
  if (code == -3) return "invalid shape, plan or failed stream";
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the conv on `stream`: x, out [M, B, D, T] int32 (contiguous,
// distinct), w [D, Kf] or packed [ceil(D/4), Kf] int32. M = 1 is the plain
// conv (no codec, unpacked taps); 3 <= M <= 8 entangles on load, and with
// extract = 1 disentangles at the flush without computing stream r (plan
// shift l, dual-word temporary when dualword = 1). Returns 0, a negative
// code for a configuration the kernel does not take, or the cudaError_t of
// the launch.
int conv1d_launch(const void* x, const void* w, void* out, int M, int B,
                  int D, long long T, int Kf, int packed, int l, int r,
                  int extract, int dualword, void* stream) {
  if (M != 1 && (M < 3 || M > 8)) return -1;
  if (B < 1 || D < 1 || T < 1 || Kf < 1) return -3;
  if (M == 1 && (packed || extract)) return -3;
  if (extract && (r < 0 || r >= M || (M - 1) * l > 31)) return -3;
  Params p;
  p.x = static_cast<const int32_t*>(x);
  p.w = static_cast<const int32_t*>(w);
  p.out = static_cast<int32_t*>(out);
  p.T = T;
  p.plane = (long long)B * D * T;
  p.tiles = (T + TT - 1) / TT;
  p.D = D; p.Kf = Kf;
  p.l = l; p.r = r; p.extract = extract; p.dualword = dualword;
  const long long blocks = (long long)B * D * p.tiles;
  if (blocks > 0x7fffffffLL) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = (unsigned int)blocks;
  switch (M) {
    case 1: conv_kernel<1, false><<<grid, THREADS, 0, s>>>(p); break;
    case 3: launch_m<3>(p, packed, grid, s); break;
    case 4: launch_m<4>(p, packed, grid, s); break;
    case 5: launch_m<5>(p, packed, grid, s); break;
    case 6: launch_m<6>(p, packed, grid, s); break;
    case 7: launch_m<7>(p, packed, grid, s); break;
    case 8: launch_m<8>(p, packed, grid, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
