// Standalone codec passes for Hopper (sm_90a): entangle and disentangle of
// M int32 streams laid out as rows of [M, N], and the checksum-ABFT
// baseline's checksum stream, the sum of the M rows.
//
// Replaces three Pallas TPU kernels:
//   repro/kernels/entangle.py    (entangle_pallas, body _entangle_kernel):
//       eps_m = (c_{(m-1) mod M} << l) + c_m, wrapping mod 2^32;
//   repro/kernels/disentangle.py (disentangle_pallas, body
//       _disentangle_kernel): recover all M rows from the entangled rows,
//       never reading row r (the fail-stopped stream), with the int32 or
//       dual-word temporary the plan asks for;
//   repro/kernels/checksum.py    (checksum_pallas, body _checksum_kernel):
//       r = sum_m c_m, wrapping mod 2^32 (paper eq. 4).
// The arithmetic is codec.cuh's (entangle_one, disentangle_one), the copy
// the fused GEMM's epilogue runs too.
//
// What bounds them on an H100: a few integer operations per word against
// one 4-byte load and one 4-byte store per word (the checksum: M loads and
// one store per column), so all three are bound by device-memory bytes
// (3.35 TB/s). The design follows from that: each
// thread owns one column n at a time and walks the columns with a
// grid-stride loop; a warp's loads of one row are 32 consecutive words
// (coalesced), and the M loads of a column are independent, so they are in
// flight together. The disentangle pass loads only the M-1 rows it needs,
// (r+1+j) mod M for j < M-1, so it moves (M-1)/M of the entangle pass's
// input bytes: row r is never read, which is the point of the fail-stop
// guarantee and what the poison check on the card tests. Columns past N are
// masked by the loop bound, so callers pass any N unpadded, and indices are
// 64-bit (a stacked gradient leaf holds up to a few hundred million words).

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block

template <int M>
__global__ void __launch_bounds__(THREADS)
    entangle_kernel(const int32_t* __restrict__ c, int32_t* __restrict__ out,
                    long long N, int l) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long n = (long long)blockIdx.x * THREADS + threadIdx.x; n < N;
       n += stride) {
    uint32_t v[M], e[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = (uint32_t)__ldg(c + m * N + n);
    entangle_one<M>(v, e, l);
#pragma unroll
    for (int m = 0; m < M; ++m) out[m * N + n] = (int32_t)e[m];
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS)
    disentangle_kernel(const int32_t* __restrict__ delta,
                       int32_t* __restrict__ out, long long N, int l, int r,
                       int dualword) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long n = (long long)blockIdx.x * THREADS + threadIdx.x; n < N;
       n += stride) {
    uint32_t rot[M], o[M];
#pragma unroll
    for (int j = 0; j < M - 1; ++j)  // never row r
      rot[j] = (uint32_t)__ldg(delta + (long long)((r + 1 + j) % M) * N + n);
    rot[M - 1] = 0u;
    disentangle_one<M>(rot, o, l, dualword);
#pragma unroll
    for (int i = 0; i < M; ++i)
      out[(long long)((r + i) % M) * N + n] = (int32_t)o[i];
  }
}

// out[n] = sum_m c[m, n]: the M loads of a column are independent (the loop
// is unrolled), coalesced across the warp along N.
__global__ void __launch_bounds__(THREADS)
    checksum_kernel(const int32_t* __restrict__ c, int32_t* __restrict__ out,
                    int M, long long N) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long n = (long long)blockIdx.x * THREADS + threadIdx.x; n < N;
       n += stride) {
    uint32_t s = 0u;
#pragma unroll 8
    for (int m = 0; m < M; ++m) s += (uint32_t)__ldg(c + m * N + n);
    out[n] = (int32_t)s;
  }
}

int check(int M, long long N, int grid) {
  if (M < 3 || M > 8) return -1;
  if (N < 1 || grid < 1) return -3;
  return 0;
}

}  // namespace

extern "C" {

int codec_threads() { return THREADS; }

const char* codec_error_string(int code) {
  if (code == -1) return "unsupported stream count M (need 3 <= M <= 8)";
  if (code == -3) return "invalid shape or grid";
  return cudaGetErrorString((cudaError_t)code);
}

// out = entangle(c) for c, out [M, N] int32 (contiguous, distinct), on
// `stream` with `grid` blocks. Returns 0, a negative code for a
// configuration the kernel does not take, or the cudaError_t of the launch.
int codec_entangle_launch(const void* c, void* out, int M, long long N,
                          int l, int grid, void* stream) {
  if (int rc = check(M, N, grid)) return rc;
  const auto* src = static_cast<const int32_t*>(c);
  auto* dst = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define CODEC_CASE(MM)                                                      \
  case MM:                                                                  \
    entangle_kernel<MM><<<grid, THREADS, 0, s>>>(src, dst, N, l);           \
    break;
    CODEC_CASE(3) CODEC_CASE(4) CODEC_CASE(5) CODEC_CASE(6) CODEC_CASE(7)
    CODEC_CASE(8)
#undef CODEC_CASE
  }
  return (int)cudaGetLastError();
}

// out = disentangle(delta) for delta, out [M, N] int32 (contiguous,
// distinct), never reading row r (0 <= r < M) of delta.
int codec_disentangle_launch(const void* delta, void* out, int M, long long N,
                             int l, int r, int dualword, int grid,
                             void* stream) {
  if (int rc = check(M, N, grid)) return rc;
  if (r < 0 || r >= M || (M - 1) * l > 31) return -3;
  const auto* src = static_cast<const int32_t*>(delta);
  auto* dst = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define CODEC_CASE(MM)                                                      \
  case MM:                                                                  \
    disentangle_kernel<MM><<<grid, THREADS, 0, s>>>(src, dst, N, l, r,      \
                                                    dualword);              \
    break;
    CODEC_CASE(3) CODEC_CASE(4) CODEC_CASE(5) CODEC_CASE(6) CODEC_CASE(7)
    CODEC_CASE(8)
#undef CODEC_CASE
  }
  return (int)cudaGetLastError();
}

// out = sum over the M rows of c [M, N] int32 (contiguous), out [N] int32,
// for any M >= 1.
int codec_checksum_launch(const void* c, void* out, int M, long long N,
                          int grid, void* stream) {
  if (M < 1 || N < 1 || grid < 1) return -3;
  checksum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), static_cast<int32_t*>(out), M, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
