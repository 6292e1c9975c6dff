// Mamba selective scan for Hopper:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) b_t^T,   y_t = h_t c_t + D * u_t,
// with f32 state and the final state hT returned in f32.
//
// Replaces src/repro/kernels/selective_scan/selective_scan.py::
// selective_scan_pallas (_scan_kernel). The TPU kernel carries a (bd x
// d_state) state block in VMEM across a sequential grid axis over S. Here
// one thread owns one (batch, channel): it keeps that channel's d_state
// (<= 16) f32 states in registers and loops over S itself, so no state ever
// leaves the SM until hT is written. A block of 128 threads covers 128
// neighbouring channels of one batch row. Per chunk of 32 steps it stages u
// and dt (each thread its own channel, loads coalesced across the block) and
// b_t, c_t (shared by every channel of the row) in shared memory, then runs
// the recurrence from there. y_t = sum_s h*c is a per-thread sum: no
// cross-thread reduction. D*u is folded in before y is rounded once.
//
// What bounds it on the H100: the bytes of u, dt, y (B*S*di each) and of
// h0, hT (B*di*d_state f32) against 3.35 TB/s, and the B*S*di*d_state
// exp()s, which run on the SFU. The sequence is sequential per channel; the
// parallelism is B*di threads (32,768 at B 4, di 8192).
//
// Layouts: u, dt, y (B, S, di) contiguous; A (di, st) f32 contiguous;
// b, c (B, S, st) with any batch/seq strides and the last dim contiguous;
// d_skip (di,); h0, hT (B, di, st) f32 contiguous. u, dt, b, c, d_skip and y
// share one dtype. st <= 16: states past st are padded with zeros (A = 0,
// b = c = h = 0), which keeps them zero and out of y.
//
// The slot case (rows_per_a > 0), the population engine's: A is (B /
// rows_per_a, di, st) and d_skip (B / rows_per_a, di), contiguous, and batch
// row b reads row b / rows_per_a of each (its trial's own), as the TPU
// kernel does under jax.vmap over a population's slots. rows_per_a = 0 is
// the one (di, st) A and (di,) d_skip above.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 32;      // time steps staged per pass

template <typename T, int ST>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ bm,
            const T* __restrict__ cm, const T* __restrict__ dskip,
            const float* __restrict__ h0, T* __restrict__ y,
            float* __restrict__ hT, int S, int di, int st,
            long long b_sb, long long b_ss, long long c_sb, long long c_ss,
            long long rows_per_a) {
  __shared__ float us[kChunk][kThreads];
  __shared__ float dts[kChunk][kThreads];
  __shared__ float bs[kChunk][ST];
  __shared__ float cs[kChunk][ST];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < di;

  if (rows_per_a) {               // this row's trial's A and D
    const long long slot = b / rows_per_a;
    A += slot * di * st;
    dskip += slot * di;
  }
  float a[ST], h[ST];
  const long long hoff = ((long long)b * di + d) * st;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const bool on = active && s < st;
    a[s] = on ? A[(long long)d * st + s] : 0.f;
    h[s] = on ? h0[hoff + s] : 0.f;
  }
  const float dsk = active ? to_f32(dskip[d]) : 0.f;
  const long long row = (long long)b * S * di;
  const T* ub = u + row + d;
  const T* dtb = dt + row + d;
  T* yb = y + row + d;
  const T* bb = bm + (long long)b * b_sb;
  const T* cb = cm + (long long)b * c_sb;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();    // the previous chunk's b/c are no longer read
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < n) {
        const long long o = (long long)(t0 + i) * di;
        us[i][tid] = active ? to_f32(ub[o]) : 0.f;
        dts[i][tid] = active ? to_f32(dtb[o]) : 0.f;
      }
    }
    for (int e = tid; e < n * ST; e += kThreads) {
      const int i = e / ST, s = e % ST;
      bs[i][s] = s < st ? to_f32(bb[(long long)(t0 + i) * b_ss + s]) : 0.f;
      cs[i][s] = s < st ? to_f32(cb[(long long)(t0 + i) * c_ss + s]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const float dtv = dts[i][tid], uv = us[i][tid];
      const float dtu = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        h[s] = expf(dtv * a[s]) * h[s] + dtu * bs[i][s];
        acc += h[s] * cs[i][s];
      }
      yb[(long long)(t0 + i) * di] = from_f32<T>(acc + uv * dsk);
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < ST; ++s)
      if (s < st) hT[hoff + s] = h[s];
  }
}

template <typename T, int ST>
cudaError_t launch(const void* u, const void* dt, const float* A, const void* b,
                   const void* c, const void* dskip, const float* h0, void* y,
                   float* hT, int B, int S, int di, int st, long long b_sb,
                   long long b_ss, long long c_sb, long long c_ss, long long rpa,
                   cudaStream_t stream) {
  dim3 grid((di + kThreads - 1) / kThreads, B);
  scan_kernel<T, ST><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(dskip), h0, static_cast<T*>(y), hT, S, di, st,
      b_sb, b_ss, c_sb, c_ss, rpa);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_st(const void* u, const void* dt, const float* A, const void* b,
                      const void* c, const void* dskip, const float* h0, void* y,
                      float* hT, int B, int S, int di, int st, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss, long long rpa,
                      cudaStream_t s) {
  if (st <= 4)
    return launch<T, 4>(u, dt, A, b, c, dskip, h0, y, hT, B, S, di, st, b_sb, b_ss, c_sb, c_ss,
                        rpa, s);
  if (st <= 8)
    return launch<T, 8>(u, dt, A, b, c, dskip, h0, y, hT, B, S, di, st, b_sb, b_ss, c_sb, c_ss,
                        rpa, s);
  return launch<T, 16>(u, dt, A, b, c, dskip, h0, y, hT, B, S, di, st, b_sb, b_ss, c_sb, c_ss,
                       rpa, s);
}

}  // namespace

// Strides of b and c are in elements. rows_per_a: 0, or the batch rows
// that share each row of a (B / rows_per_a, di, st) A and (B / rows_per_a,
// di) d_skip (B a multiple of it). dtype: ReproDtype of u, dt, b, c, d_skip
// and y. 1 <= st <= 16.
extern "C" int selective_scan_launch(
    const void* u, const void* dt, const void* A, const void* b, const void* c,
    const void* dskip, const void* h0, void* y, void* hT, int B, int S, int di,
    int st, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long rows_per_a, int dtype, void* stream) {
  if (st < 1 || st > 16) return cudaErrorInvalidValue;
  if (rows_per_a < 0 || (rows_per_a && B % rows_per_a)) return cudaErrorInvalidValue;
  if (B == 0 || di == 0) return 0;
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_st<float>(u, dt, Af, b, c, dskip, h0f, y, hTf, B, S, di, st, b_sb, b_ss,
                            c_sb, c_ss, rows_per_a, s);
  if (dtype == kBFloat16)
    return launch_st<__nv_bfloat16>(u, dt, Af, b, c, dskip, h0f, y, hTf, B, S, di, st, b_sb,
                                    b_ss, c_sb, c_ss, rows_per_a, s);
  return cudaErrorInvalidValue;
}
