// Fused RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel). The TPU kernel tiles 128 rows into VMEM. The work is a
// few operations per byte, so the H100 bounds it by memory (3.35 TB/s): each
// row is read from device memory once and written once. Two kernels:
//
//  * warp (rmsnorm_warp_kernel): bf16 rows of the widths the configs use
//    (RMSNORM_WARP_WIDTHS), 16-byte aligned and evenly strided. One warp
//    owns one row, kRowsPerBlock rows a block. Each lane holds its share of
//    the row in registers as VPL 16-byte vectors (lane l takes vectors l,
//    l + 32, ..., so every load of the warp is 512 contiguous bytes), sums
//    squares in f32, reduces them with warp shuffles and writes its vectors
//    back, reading scale as 16-byte vectors that every row shares from
//    L1/L2. No shared memory and no block barrier: a row costs one DRAM
//    round trip.
//  * block (rmsnorm_kernel): every other call (f32 x, other widths,
//    unaligned or oddly strided rows). One block of 256 threads owns one
//    row, staged in shared memory as f32 (16-byte loads where the row allows
//    them), with a block reduction. With rows_per_scale > 0 it is also the
//    slot case (kernels/rmsnorm/rmsnorm.py::rmsnorm_slots_cuda): scale holds
//    one row of D a slot, and row r reads row r / rows_per_scale of it. That
//    is the reference's rmsnorm_pallas under jax.vmap over a population's
//    slots (src/repro/population/engine.py), where each trial has its own
//    scale. Every slot's scale row is read by rows_per_scale blocks, from
//    L2 after the first.
//
// Which one serves a call is kernels/rmsnorm/rmsnorm.py::kernel_for's choice.
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
               bool vec, long long rows_per_scale) {
  extern __shared__ float smem[];
  float* row = smem;               // D floats
  float* part = smem + D;          // one partial per warp
  const long long r = blockIdx.x;
  const T* xr = x + r * x_row_stride;
  T* orow = out + r * D;
  // the slot case: this row's slot's scale row (0: one scale for every row)
  if (rows_per_scale) scale += (r / rows_per_scale) * D;

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
                   int D, long long x_row_stride, float eps, long long rows_per_scale,
                   cudaStream_t stream) {
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
      D, x_row_stride, eps, vec, rows_per_scale);
  return cudaGetLastError();
}

constexpr int kRowsPerBlock = 4;            // warps (rows) a block of the warp kernel
constexpr int kWarpThreads = 32 * kRowsPerBlock;

// 8 consecutive elements of scale as f32 (one or two 16-byte loads)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// x: bf16 rows of D = VPL * 256 elements, x_row_stride apart (a multiple of
// 8); out contiguous. A warp past the last row returns at once: there is no
// barrier to keep it for.
template <typename S, int VPL>
__global__ void __launch_bounds__(kWarpThreads)
rmsnorm_warp_kernel(const __nv_bfloat16* __restrict__ x, const S* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, long long rows,
                    long long x_row_stride, float eps) {
  constexpr int D = VPL * 256;
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= rows) return;
  const uint4* xv = reinterpret_cast<const uint4*>(x + r * x_row_stride);
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = xv[lane + 32 * i];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  const float rs = rsqrtf(warp_sum(ss) / D + eps);
  uint4* ov = reinterpret_cast<uint4*>(out + r * D);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    float sc[8];
    load8(scale + c * 8, sc);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      oh[k] = __floats2bfloat162_rn(f.x * rs * sc[2 * k], f.y * rs * sc[2 * k + 1]);
    }
    ov[c] = o;
  }
}

template <typename S, int VPL>
cudaError_t launch_warp(const void* x, const void* scale, void* out, long long rows,
                        long long x_row_stride, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_warp_kernel<S, VPL><<<(unsigned)blocks, kWarpThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const S*>(scale),
      static_cast<__nv_bfloat16*>(out), rows, x_row_stride, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the widths the warp kernel is built for: gemma2-2b's 2304 and jamba's 4096
// (kernels/rmsnorm/rmsnorm.py::WARP_WIDTHS)
#define RMSNORM_WARP_WIDTHS(X) X(9) X(16)

}  // namespace

// x: (rows, D) with rows x_row_stride elements apart; out: (rows, D)
// contiguous; x_dtype/s_dtype: ReproDtype. rows_per_scale 0: scale is (D,),
// one for every row; > 0: scale is (rows / rows_per_scale, D) contiguous,
// row r scaled by its row r / rows_per_scale (rows must be a multiple).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long rows, int D, long long x_row_stride,
                              float eps, int x_dtype, int s_dtype,
                              long long rows_per_scale, void* stream) {
  if (rows == 0) return 0;
  if (rows_per_scale < 0 || (rows_per_scale && rows % rows_per_scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rps = rows_per_scale;
  if (x_dtype == kFloat32 && s_dtype == kFloat32)
    return launch<float, float>(x, scale, out, rows, D, x_row_stride, eps, rps, st);
  if (x_dtype == kFloat32 && s_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, D, x_row_stride, eps, rps, st);
  if (x_dtype == kBFloat16 && s_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, D, x_row_stride, eps, rps, st);
  if (x_dtype == kBFloat16 && s_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, x_row_stride, eps,
                                                 rps, st);
  return cudaErrorInvalidValue;
}

// The warp kernel: x (rows, D) bf16, rows x_row_stride elements apart;
// scale (D,) bf16 or f32; out (rows, D) bf16 contiguous. D must be one of
// the built widths, x_row_stride a multiple of 8 and every pointer 16-byte
// aligned; anything else is refused (kernel_for sends it to the block kernel).
extern "C" int rmsnorm_warp_launch(const void* x, const void* scale, void* out,
                                   long long rows, int D, long long x_row_stride,
                                   float eps, int s_dtype, void* stream) {
  if (rows == 0) return 0;
  if (x_row_stride % 8 || !aligned16(x) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RMSNORM_WARP_CASE(VPL)                                                        \
  if (D == (VPL) * 256) {                                                             \
    if (s_dtype == kBFloat16)                                                         \
      return launch_warp<__nv_bfloat16, VPL>(x, scale, out, rows, x_row_stride, eps, st); \
    if (s_dtype == kFloat32)                                                          \
      return launch_warp<float, VPL>(x, scale, out, rows, x_row_stride, eps, st);     \
    return cudaErrorInvalidValue;                                                     \
  }
  RMSNORM_WARP_WIDTHS(RMSNORM_WARP_CASE)
#undef RMSNORM_WARP_CASE
  return cudaErrorInvalidValue;
}

// The warp kernel at width D with a bf16 scale: kernel_attrs' out[0..2], then
// in out[3] its dynamic shared memory (none).
extern "C" int rmsnorm_warp_attrs(int D, int* out) {
  out[3] = 0;
#define RMSNORM_WARP_ATTRS(VPL) \
  if (D == (VPL) * 256) return kernel_attrs(rmsnorm_warp_kernel<__nv_bfloat16, VPL>, out);
  RMSNORM_WARP_WIDTHS(RMSNORM_WARP_ATTRS)
#undef RMSNORM_WARP_ATTRS
  return cudaErrorInvalidValue;
}
