// The paper's codec as CUDA device code, shared by the fused entangled GEMM
// (entangled_matmul.cu, its epilogue), the standalone codec passes
// (codec_pass.cu) and the entangled conv (conv1d.cu), so all run one copy
// of the arithmetic. It is the device form of repro_torch/kernels/codec.py
// (entangle_block, disentangle_rows, unpack_int8) and must stay bit for bit
// equal to it: every value is a uint32 in two's-complement ring arithmetic
// mod 2^32, and the dual-word temporary of the plans whose telescoping sum
// needs more than 32 bits is a native 64-bit word, with the same ring
// semantics as the reference's (hi: int32, lo: uint32) pair.
#pragma once

#include <stdint.h>

// Sign-extended int8 lane j of a packed word (lane j in bits [8j, 8j+8), the
// layout of repro_torch/kernels/codec.py::pack_int8): PRMT copies byte j into
// the low byte and replicates its sign bit over the three upper bytes.
__device__ __forceinline__ uint32_t lane_s8(uint32_t w, int j) {
  uint32_t d;
  const uint32_t sel = j | ((8 | j) << 4) | ((8 | j) << 8) | ((8 | j) << 12);
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(d) : "r"(w), "r"(sel));
  return d;
}

// eq. (14/15) for one position: eps_m = (c_{(m-1) mod M} << l) + c_m.
template <int M>
__device__ __forceinline__ void entangle_one(const uint32_t (&c)[M],
                                             uint32_t (&eps)[M], int l) {
#pragma unroll
  for (int m = 0; m < M; ++m) eps[m] = (c[(m + M - 1) % M] << l) + c[m];
}

// eq. (16-19): disentangle one output position from the M-1 surviving
// entangled values in rotated order, rot[j] = stream (r + 1 + j) mod M
// (rot[M-1] is not read); o_rot[i] receives the recovered value of stream
// (r + i) mod M. Horner telescoping of the M-1 values (in one 32-bit word,
// or in a 64-bit word when dualword), the sign-extended bit-field split of
// d_r and d_q, and the eq. (19) chain.
template <int M>
__device__ __forceinline__ void disentangle_one(const uint32_t (&rot)[M],
                                                uint32_t (&o_rot)[M], int l,
                                                int dualword) {
  const int B = (M - 1) * l;  // d_r sits above bit B of d_temp; B <= 31
  uint32_t d_r, d_q;
  if (dualword) {
    uint64_t t = (uint64_t)(int64_t)(int32_t)rot[0];
#pragma unroll
    for (int i = 1; i < M - 1; ++i) {
      const uint64_t d = (uint64_t)(int64_t)(int32_t)rot[i];
      t = (t << l);
      t = (i & 1) ? t - d : t + d;  // sign (-1)^i of the telescoping sum
    }
    const int64_t t_lo = ((int64_t)(t << (64 - B))) >> (64 - B);
    d_q = (M & 1) ? (uint32_t)(0ull - (uint64_t)t_lo) : (uint32_t)t_lo;
    d_r = (uint32_t)((t - (uint64_t)t_lo) >> B);  // bits [B, B+32)
  } else {
    uint32_t t = rot[0];
#pragma unroll
    for (int i = 1; i < M - 1; ++i) {
      t = (t << l);
      t = (i & 1) ? t - rot[i] : t + rot[i];
    }
    const int sh = 32 - B;
    const int32_t t_lo = ((int32_t)(t << sh)) >> sh;
    d_q = (M & 1) ? 0u - (uint32_t)t_lo : (uint32_t)t_lo;
    d_r = (uint32_t)(((int32_t)(t - (uint32_t)t_lo)) >> B);
  }
  // eq. (19) chain from d_r
  uint32_t prev = d_r;
  o_rot[0] = d_r;
  o_rot[M - 1] = d_q;
#pragma unroll
  for (int i = 1; i < M - 1; ++i) {
    prev = rot[i - 1] - (prev << l);
    o_rot[i] = prev;
  }
}
