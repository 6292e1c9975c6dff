// Weight-streaming grouped matmul for Hopper (bf16): the decode path. Rows
// of x sorted by group, out[r] = x[r] @ w[g(r)] with f32 accumulation,
// output in bf16, rows past the last group 0 (as lax.ragged_dot gives them).
//
// Replaces src/repro/kernels/gmm/gmm.py::gmm_pallas (_gmm_kernel) and its
// wrapper's pad_groups for bf16 calls with fewer rows than one of the tiled
// kernel's 128-row tiles and D, F and pointers that allow 16-byte copies
// (kernels/gmm/gmm.py::kernel_for): every decode step of a MoE layer. As in
// gmm_prefill.cu, each block maps itself to (group, rows) from group_sizes
// on the device (gmm.cuh), so a call never waits on the host.
//
// What bounds it on the H100: the weight bytes. A decode step of jamba
// (batch 4, top-2) routes 8 rows to 8 of 16 experts, one row each, and must
// read those 8 (4096 x 14336) bf16 panels: 939.5 MB, 280.5 us at 3.35 TB/s,
// for about 8 operations a weight byte, far below the 295 at which bf16 on
// the tensor cores becomes bound by operations. The design streams every
// active group's panel once, with enough bytes in flight:
//   * a block is one slot of at most 16 rows of one group (block_tile<16>;
//     a group of more rows takes more slots, each reading the panel again)
//     by BN = 128 columns of F; at jamba's decode that is 8 x 112 working
//     blocks at up/gate and 8 x 32 = 256 at down, one wave at 2 blocks an
//     SM. A weight tile's rows are 256 contiguous bytes;
//   * the product is taken transposed, out^T = w^T x^T, on mma.sync.m16n8k16
//     (bf16 in, f32 accumulate): F is M, so each of 4 warps owns two m16
//     tiles (32 columns) of F, and the slot's 16 rows are N, two n8 halves. w is
//     (E, D, F) row-major, so a weight tile is K x F with F contiguous and
//     w^T's A fragments come from ldmatrix.trans; x is (T, D) row-major,
//     which is the .col B operand, so its fragments come from ldmatrix;
//   * a K step of 64 through a 4-stage cp.async ring of 16-byte copies
//     (64 x 128 weights and 16 x 64 of x a stage), so three steps (48 KB of
//     weights) are in flight per block while one is multiplied: about 96 KB
//     an SM at 2 blocks, over the ~25 KB that 3.35 TB/s times ~1 us of
//     latency needs. Rows past the slot's end and K past D are zero-filled
//     through cp.async's source size; shared rows are padded by 8 bf16 (an
//     odd count of 16-byte units), so ldmatrix is free of bank conflicts;
//   * the epilogue rounds each f32 sum to bf16 once, transposes the tile
//     through the ring's shared memory and stores the slot's rows 16 bytes
//     a thread; a slot past the last group (group -1) writes zeros.
// Tensor cores are not needed for speed here: they keep the instructions
// per weight element far below what FMAs on the CUDA cores would take.
#include "gmm.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The column tile, K step, ring depth and blocks an SM must hold (the
// launch bound) are macros so that kernels/gmm/sweep.py can build and time
// other values of them; the defaults are the design above, which the port
// builds.
#ifndef GMM_DECODE_BN
#define GMM_DECODE_BN 128
#endif
#ifndef GMM_DECODE_BK
#define GMM_DECODE_BK 64
#endif
#ifndef GMM_DECODE_STAGES
#define GMM_DECODE_STAGES 4
#endif
#ifndef GMM_DECODE_MIN_BLOCKS
#define GMM_DECODE_MIN_BLOCKS 2
#endif

constexpr int kRows = 16;                         // a slot's rows: N of the product
constexpr int kBN = GMM_DECODE_BN, kBK = GMM_DECODE_BK;
constexpr int kStages = GMM_DECODE_STAGES;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMT = kBN / (16 * kWarps);          // a warp's m16 tiles of F
constexpr int kLDW = kBN + 8;    // bf16 a shared row: an odd count of 16-byte units
constexpr int kLDX = kBK + 8;
constexpr int kLDC = kBN + 8;
constexpr int kStageW = kBK * kLDW, kStageX = kRows * kLDX;   // elements
constexpr int kStage = kStageW + kStageX;
constexpr int kWChunks = kBK * kBN / 8, kXChunks = kRows * kBK / 8;   // 16-byte copies
constexpr size_t kRingBytes = (size_t)kStages * kStage * sizeof(bf16);
constexpr size_t kOutBytes = (size_t)kRows * kLDC * sizeof(bf16);
constexpr size_t kSmemBytes = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;

static_assert(kBN % (16 * kWarps) == 0 && kBK % 16 == 0 && kStages >= 2,
              "whole m16 tiles a warp, whole k16 steps, a ring of two stages or more");
static_assert(kWChunks % kThreads == 0, "whole passes of weight copies");

__global__ void __launch_bounds__(kThreads, GMM_DECODE_MIN_BLOCKS)
gmm_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ gs, bf16* __restrict__ out, int Tn, int D, int F,
                  int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const gmm::Tile tile = gmm::block_tile<kRows>(gs, Tn, E, blockIdx.x);
  if (tile.rows <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * kBN;
  // a slot past the last group multiplies nothing: its output is zero
  const int n_k = tile.group >= 0 ? (D + kBK - 1) / kBK : 0;
  const bf16* wg = w + (long long)max(tile.group, 0) * D * F + n0;
  const bf16* xs = x + (long long)tile.r0 * D;

  auto load = [&](int stage, int kt) {
    bf16* ws = ring + stage * kStage;
    bf16* xt = ws + kStageW;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kWChunks / kThreads; ++j) {
      const int i = tid + j * kThreads, k = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + k < D && n0 + c < F;
      cp_async16(ws + k * kLDW + c, ok ? wg + (long long)(k0 + k) * F + c : w, ok);
    }
#pragma unroll
    for (int j = 0; j < (kXChunks + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads, r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      if (kXChunks % kThreads && i >= kXChunks) break;
      const bool ok = r < tile.rows && k0 + c < D;
      cp_async16(xt + r * kLDX + c, ok ? xs + (long long)r * D + k0 + c : x, ok);
    }
  };

  // acc[i][h]: outputs at F columns 16 (kWarps i + warp) + {g, g + 8} and
  // slot rows 8 h + 2 tg + {0, 1} (the m16n8 C fragment of out^T)
  float acc[kMT][2][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[i][h][0] = acc[i][h][1] = acc[i][h][2] = acc[i][h][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();    // step kt has landed
    __syncthreads();                 // and every warp is done with step kt - 1's stage
    const int next = kt + kStages - 1;
    if (next < n_k) load(next % kStages, next);
    cp_async_commit();

    const bf16* ws = ring + (kt % kStages) * kStage;
    const bf16* xt = ws + kStageW;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B = x^T (k16 x n16): matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
      // (n 8-15, k 0-7), (n 8-15, k 8-15) of x's rows
      uint32_t b[4];
      ldsm_x4(b, xt + ((lane & 7) + ((lane >> 4) << 3)) * kLDX + kk * 16 +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // A = w^T (m16 x k16) from the K x F tile: matrices (m 0-7, k 0-7),
        // (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15), transposed
        uint32_t a[4];
        ldsm_x4_trans(a, ws + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLDW +
                             (i * kWarps + warp) * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[i][0], a, b[0], b[1]);
        mma_bf16(acc[i][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: stage the tile in it

  // transpose: cs[row][column], each f32 sum rounded to bf16 once
  const int g = lane >> 2, tg = lane & 3;
  bf16* cs = ring;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (i * kWarps + warp) * 16 + g, r = h * 8 + 2 * tg;
      cs[r * kLDC + m] = __float2bfloat16(acc[i][h][0]);
      cs[(r + 1) * kLDC + m] = __float2bfloat16(acc[i][h][1]);
      cs[r * kLDC + m + 8] = __float2bfloat16(acc[i][h][2]);
      cs[(r + 1) * kLDC + m + 8] = __float2bfloat16(acc[i][h][3]);
    }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < kRows * kBN / 8; i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    if (r < tile.rows && n0 + c < F)
      *reinterpret_cast<uint4*>(out + (long long)(tile.r0 + r) * F + n0 + c) =
          *reinterpret_cast<const uint4*>(cs + r * kLDC + c);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (T, D) bf16 rows sorted by group; w: (E, D, F) bf16; group_sizes: (E,)
// int32 on the device; out: (T, F) bf16. All contiguous, 16-byte aligned,
// D and F multiples of 8. The grid comes from shapes alone (no host sync).
extern "C" int gmm_decode_launch(const void* x, const void* w, const void* group_sizes,
                                 void* out, int T, int D, int F, int E, void* stream) {
  if (T == 0 || F == 0) return 0;
  if (E < 0 || D % 8 || F % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opts in
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(gmm::grid_rows<kRows>(T, E), (F + kBN - 1) / kBN);
  gmm_decode_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), T, D, F, E);
  return cudaGetLastError();
}

// kernel_attrs' out[0..2] of the kernel, then in out[3] the dynamic shared
// memory its launch asks for.
extern "C" int gmm_decode_attrs(int* out) {
  out[3] = (int)kSmemBytes;
  return kernel_attrs(gmm_decode_kernel, out);
}
