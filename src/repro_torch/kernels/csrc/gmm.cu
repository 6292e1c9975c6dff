// Grouped matmul for Hopper: rows of x sorted by group, each row times its
// group's (D, F) weight, f32 accumulation, output in x's dtype. Ragged in,
// ragged out: out[r] = x[r] @ w[g(r)], and rows past the last group are 0
// (as lax.ragged_dot gives them). This is the kernel for every f32 call and
// for the bf16 calls that neither the 128-row tensor-core kernel
// (gmm_prefill.cu) nor the decode kernel (gmm_decode.cu) can take: widths
// that are not a multiple of 8, or x or w not 16-byte aligned, which those
// two copy 16 bytes at a time (kernels/gmm/gmm.py::kernel_for).
//
// Replaces src/repro/kernels/gmm/gmm.py::gmm_pallas (_gmm_kernel) and its
// wrapper's pad_groups for those calls. The TPU kernel needs every group
// padded to whole row tiles, which needs the group sizes on the host
// (gmm.py:66): on the card that is a host sync per MoE layer in every
// decode step. Here every block maps itself to (group, rows) from
// group_sizes on the device (gmm.cuh), with 64-row tiles. Rows are read and
// written at their own positions, with bounds masks: no padded copy of x,
// no scatter, no gather.
//
// A block computes a (BM x BN) = (64 x 64) tile with a K loop over D in
// steps of 32 through shared memory (16-byte loads where D, F and the
// pointers allow it). bf16 runs on the tensor cores through WMMA (16x16x16,
// f32 accumulators, each of 4 warps owns 32 x 32); f32 runs as f32 FMAs, 32
// outputs per thread. Results go through shared memory to coalesced stores.
//
// What bounds it on the H100: at few rows the weight bytes alone; each
// active group's column panel is streamed by its own blocks, F / BN of
// them. This kernel has no cp.async or TMA pipeline: one K step is in
// flight per block, so it reads weights at about a third of the card's
// rate (PERF.md); the bf16 calls it serves are off the main path.
#include "gmm.cuh"
#include <mma.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;

template <typename T>
struct Smem {
  static constexpr int V = 16 / (int)sizeof(T);    // elements per 16-byte load
  static constexpr int LDA = kBK + V;              // padded rows, 16-byte aligned
  static constexpr int LDB = kBN + V;
  static constexpr int LDC = kBN + 4;
  static constexpr int ab_bytes = (kBM * LDA + kBK * LDB) * (int)sizeof(T);
  static constexpr int c_bytes = kBM * LDC * (int)sizeof(float);
  static constexpr int bytes = ab_bytes > c_bytes ? ab_bytes : c_bytes;
};

// s[r * LD + c] = g[r * ld_g + c] for r < rows, c < cols, else 0.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, long long ld_g,
                                          int rows, int cols, bool vec, T* s) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec) {    // cols is a multiple of V here
    for (int i = threadIdx.x; i < ROWS * COLS / V; i += kThreads) {
      const int r = i / (COLS / V), c = (i % (COLS / V)) * V;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < cols) u = *reinterpret_cast<const uint4*>(g + r * ld_g + c);
      *reinterpret_cast<uint4*>(s + r * LD + c) = u;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      s[r * LD + c] = (r < rows && c < cols) ? g[r * ld_g + c] : from_f32<T>(0.f);
    }
  }
}

// acc (f32, LDC-strided in shared memory) += A (BM x BK) @ B (BK x BN).
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                         nvcuda::wmma::fragment<nvcuda::wmma::accumulator,
                                                                16, 16, 16, float> (&acc)[2][2]) {
  using namespace nvcuda;
  using L = Smem<__nv_bfloat16>;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * L::LDA + kk, L::LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + kk * L::LDB + wn * 32 + j * 16, L::LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ gs,
           T* __restrict__ out, int Tn, int D, int F, int E, bool vec_a, bool vec_b,
           bool vec_o) {
  using L = Smem<T>;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  const int tid = threadIdx.x;

  // -- which group and rows this block owns --------------------------------
  const gmm::Tile tile = gmm::block_tile<kBM>(gs, Tn, E, blockIdx.x);
  if (tile.rows <= 0) return;
  const int e = tile.group, r0 = tile.r0, rows = tile.rows;
  const int n0 = blockIdx.y * kBN;

  float* Cs = reinterpret_cast<float*>(smem);
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * L::LDA;

  if (e >= 0) {
    const T* xa = x + (long long)r0 * D;
    const T* wb = w + (long long)e * D * F + n0;
    if constexpr (sizeof(T) == 2) {
      using namespace nvcuda;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int k0 = 0; k0 < D; k0 += kBK) {
        load_tile<T, kBM, kBK, L::LDA>(xa + k0, D, rows, D - k0, vec_a, As);
        load_tile<T, kBK, kBN, L::LDB>(wb + (long long)k0 * F, F, D - k0, F - n0, vec_b, Bs);
        __syncthreads();
        tile_mma(As, Bs, acc);
        __syncthreads();
      }
      const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * L::LDC + wn * 32 + j * 16,
                                  acc[i][j], L::LDC, wmma::mem_row_major);
    } else {
      // f32: thread (ty, tx) owns rows 8 ty .. 8 ty + 7, columns 4 tx .. 4 tx + 3
      const int ty = tid / 16, tx = tid % 16;
      float acc[8][4] = {};
      for (int k0 = 0; k0 < D; k0 += kBK) {
        load_tile<T, kBM, kBK, L::LDA>(xa + k0, D, rows, D - k0, vec_a, As);
        load_tile<T, kBK, kBN, L::LDB>(wb + (long long)k0 * F, F, D - k0, F - n0, vec_b, Bs);
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = to_f32(Bs[k * L::LDB + tx * 4 + j]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = to_f32(As[(ty * 8 + i) * L::LDA + k]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * L::LDC + tx * 4 + j] = acc[i][j];
    }
  } else {      // the tail past the last group is zero
    for (int i = tid; i < kBM * kBN; i += kThreads) Cs[(i / kBN) * L::LDC + i % kBN] = 0.f;
  }
  __syncthreads();

  // -- epilogue: rows r0 .. r0 + rows - 1, columns n0 .. min(n0 + BN, F) - 1
  const int cols = min(kBN, F - n0);
  T* o = out + (long long)r0 * F + n0;
  if (vec_o) {     // cols is a multiple of V here
    constexpr int V = L::V;
    for (int i = tid; i < kBM * kBN / V; i += kThreads) {
      const int r = i / (kBN / V), c = (i % (kBN / V)) * V;
      if (r >= rows || c >= cols) continue;
      uint4 u;
      T* ev = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int v = 0; v < V; ++v) ev[v] = from_f32<T>(Cs[r * L::LDC + c + v]);
      *reinterpret_cast<uint4*>(o + (long long)r * F + c) = u;
    }
  } else {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      if (r < rows && c < cols) o[(long long)r * F + c] = from_f32<T>(Cs[r * L::LDC + c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* gs, void* out, int Tn,
                   int D, int F, int E, cudaStream_t stream) {
  constexpr int V = Smem<T>::V;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_a = D % V == 0 && aligned(x);
  const bool vec_b = F % V == 0 && aligned(w);
  const bool vec_o = F % V == 0 && aligned(out);
  dim3 grid(gmm::grid_rows<kBM>(Tn, E), (F + kBN - 1) / kBN);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gs, static_cast<T*>(out),
      Tn, D, F, E, vec_a, vec_b, vec_o);
  return cudaGetLastError();
}

}  // namespace

// x: (T, D) rows sorted by group; w: (E, D, F); group_sizes: (E,) int32 on
// the device; out: (T, F). All contiguous. dtype: ReproDtype of x, w, out.
extern "C" int gmm_launch(const void* x, const void* w, const void* group_sizes,
                          void* out, int T, int D, int F, int E, int dtype,
                          void* stream) {
  if (T == 0 || F == 0) return 0;
  if (E < 0) return cudaErrorInvalidValue;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, w, gs, out, T, D, F, E, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, gs, out, T, D, F, E, s);
  return cudaErrorInvalidValue;
}
