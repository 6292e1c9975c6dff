// Fused RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel). The TPU kernel tiles 128 rows into VMEM; here one
// block of 256 threads owns one row. The work is a few operations per byte,
// so the H100 bounds it by memory (3.35 TB/s): the row is read from device
// memory once (16-byte vector loads where the row allows them) into shared
// memory as f32, the sum of squares is reduced with warp shuffles, and the
// normalised row is written once in x's dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, float* row,
                                         int D, bool vec, float& ss) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int c = threadIdx.x; c < D / V; c += blockDim.x) {
      uint4 u = xv[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float f = to_f32(e[i]);
        row[c * V + i] = f;
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      float f = to_f32(xr[i]);
      row[i] = f;
      ss += f * f;
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int D, long long x_row_stride, float eps,
               bool vec) {
  extern __shared__ float smem[];
  float* row = smem;               // D floats
  float* part = smem + D;          // one partial per warp
  const long long r = blockIdx.x;
  const T* xr = x + r * x_row_stride;
  T* orow = out + r * D;

  float ss = 0.f;
  load_row(xr, row, D, vec, ss);
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < blockDim.x / 32 ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float rs = rsqrtf(part[0] / D + eps);
  // each thread reads back only the row entries it wrote itself
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int c = threadIdx.x; c < D / V; c += blockDim.x) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i)
        e[i] = from_f32<T>(row[c * V + i] * rs * to_f32(scale[c * V + i]));
      ov[c] = u;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      orow[i] = from_f32<T>(row[i] * rs * to_f32(scale[i]));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows,
                   int D, long long x_row_stride, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && x_row_stride % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = (size_t)D * sizeof(float) + (kThreads / 32) * sizeof(float);
  auto kern = rmsnorm_kernel<T, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      D, x_row_stride, eps, vec);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, D) with rows x_row_stride elements apart; out: (rows, D)
// contiguous; scale: (D,). x_dtype/s_dtype: ReproDtype.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long rows, int D, long long x_row_stride,
                              float eps, int x_dtype, int s_dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && s_dtype == kFloat32)
    return launch<float, float>(x, scale, out, rows, D, x_row_stride, eps, st);
  if (x_dtype == kFloat32 && s_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, D, x_row_stride, eps, st);
  if (x_dtype == kBFloat16 && s_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, D, x_row_stride, eps, st);
  if (x_dtype == kBFloat16 && s_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, x_row_stride, eps, st);
  return cudaErrorInvalidValue;
}
