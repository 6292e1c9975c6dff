// Pieces shared by the bf16 flash-attention kernels (flash_decode.cu and
// flash_prefill.cu): which key tiles a query range can see, given the keys'
// absolute positions (kv_pos, or the key index where kv_pos is null), and
// the asynchronous copies that bring a tile into shared memory.
#pragma once
#include "common.cuh"

namespace flash {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

// Smallest and largest position of the keys [kt, min(kt + BK, Skv)). Every
// lane of every warp gets the same two values. Reads kv_pos from device
// memory: it is called before the tile is loaded, to decide whether to load.
template <int BK>
__device__ __forceinline__ void tile_span(const int* __restrict__ kv_pos, int kt, int Skv,
                                          int& kmin, int& kmax) {
  if (!kv_pos) {
    kmin = kt;
    kmax = min(kt + BK, Skv) - 1;
    return;
  }
  kmin = INT_MAX;
  kmax = INT_MIN;
#pragma unroll
  for (int j = threadIdx.x & 31; j < BK; j += 32) {
    if (kt + j < Skv) {
      const int p = kv_pos[kt + j];
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
  }
}

// True when no query with a position in [q_lo, q_hi] sees any key with a
// position in [kmin, kmax]: the tile is neither loaded nor computed.
__device__ __forceinline__ bool tile_hidden(int kmin, int kmax, int q_lo, int q_hi,
                                            int causal, int window) {
  return (causal && kmin > q_hi) || (window > 0 && kmax <= q_lo - window);
}

// cap * tanh(x / cap), given inv_cap = 1 / cap, as 1 - 2 / (exp(2y) + 1):
// an ex2 and a fast divide where tanhf takes a long polynomial. Its absolute
// error (~1e-7, times cap) is far below a bf16 score's rounding.
__device__ __forceinline__ float softcap_tanh(float x, float cap, float inv_cap) {
  const float e = __expf(2.f * x * inv_cap);
  return cap * (1.f - __fdividef(2.f, e + 1.f));
}

// Whether the query at position qp sees key kidx, at position kp.
__device__ __forceinline__ bool key_visible(int kidx, int Skv, int kp, int qp, int causal,
                                            int window) {
  return kidx < Skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// cp.async rows [r0, r0 + ROWS) of a (n, HD) bf16 matrix with row stride
// `stride` into shared rows of RS elements, 16 bytes a thread; rows at or
// past n are zero-filled (from a clamped, valid source address).
template <int ROWS, int HD, int RS, int NTHREADS>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ g, long long stride,
                                          int r0, int n, bf16* s) {
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = r0 + r < n;
    cp_async16(s + r * RS + cc * 8, g + (ok ? (long long)(r0 + r) : 0ll) * stride + cc * 8, ok);
  }
}

// Stage the positions of keys [kt, kt + BK) into shared memory (threads
// below BK copy one each; positions past Skv are never read as visible).
template <int BK>
__device__ __forceinline__ void stage_positions(const int* __restrict__ kv_pos, int kt,
                                                int Skv, int* dst) {
  const int j = threadIdx.x;
  if (j >= BK) return;
  if (kv_pos)
    cp_async4(dst + j, kv_pos + (kt + j < Skv ? kt + j : 0), kt + j < Skv);
  else
    dst[j] = kt + j;
}

}  // namespace flash
