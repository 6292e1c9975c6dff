// Tensor-core grouped matmul for Hopper (bf16): the prefill path. Rows of x
// sorted by group, out[r] = x[r] @ w[g(r)] with f32 accumulation, output in
// bf16, rows past the last group 0 (as lax.ragged_dot gives them).
//
// Replaces src/repro/kernels/gmm/gmm.py::gmm_pallas (_gmm_kernel) and its
// wrapper's pad_groups for bf16 calls with at least one 128-row tile of rows
// and D, F and pointers that allow 16-byte copies (kernels/gmm/gmm.py::
// kernel_for); every other call runs gmm.cu. The TPU kernel pads every group
// to whole 128-row tiles on the host; here each block maps itself to
// (group, rows) from group_sizes on the device (gmm.cuh), so a call never
// waits on the host, and masks its rows instead of padding them.
//
// What bounds it on the H100: jamba's experts at prefill (4,096 rows over
// 16 groups, 4096 -> 14336 or back) are 481 GFLOP on 1.9 GB of weights,
// 0.49 ms at the bf16 tensor-core peak and 0.56 ms at 3.35 TB/s, so both
// the tensor cores and the weight stream matter. The design:
//   * 128 x 128 output tiles, so each weight panel (D x 128) is read by
//     ceil(group / 128) row tiles of its group (2-3 at jamba's routing), and
//     x by F / 128 column tiles, mostly from L2;
//   * 8 warps in 2 x 4, each owning 64 x 32 outputs: 64 f32 accumulators a
//     thread, with mma.sync.m16n8k16 (bf16 in, f32 accumulate). A's
//     fragments come from ldmatrix on x's row-major tile; w is (E, D, F)
//     row-major, so a B tile is K x N with N contiguous and its fragments
//     come from ldmatrix.trans, as V's in flash_prefill.cu's PV product;
//   * a K step of 32 through a 4-stage cp.async ring (16-byte copies), so
//     three steps' bytes are in flight while one is multiplied. Rows outside
//     the block's group and K past D are zero-filled by cp.async's source
//     size, not branched around. Shared rows are padded by 8 bf16 (an odd
//     count of 16-byte units), so ldmatrix is free of bank conflicts;
//   * 74 KB of shared memory and at most 128 registers a thread, so two
//     blocks (16 warps) fit an SM;
//   * the epilogue rounds each f32 sum to bf16 once, stages the tile through
//     the ring's shared memory and stores it 16 bytes a thread, rows past
//     the group's end masked.
// A 128 x 128 tile reads (128 + 128) x D x 2 bytes from L2 for
// 2 x 128 x 128 x D operations, 64 a byte: about 8.7 GB of L2 reads a call
// at jamba's prefill, so the L2's bandwidth, not device memory's, may set
// the pace (measured times: PERF.md). wgmma, TMA, warp specialisation and
// persistent blocks are later work.
#include "gmm.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The K step, ring depth, warp piece and blocks an SM must hold (the launch
// bound) are macros so that kernels/gmm/sweep.py can build and time other
// values of them; the defaults are the design above, which the port builds.
#ifndef GMM_PREFILL_BK
#define GMM_PREFILL_BK 32
#endif
#ifndef GMM_PREFILL_STAGES
#define GMM_PREFILL_STAGES 4
#endif
#ifndef GMM_PREFILL_WM
#define GMM_PREFILL_WM 64
#endif
#ifndef GMM_PREFILL_WN
#define GMM_PREFILL_WN 32
#endif
#ifndef GMM_PREFILL_MIN_BLOCKS
#define GMM_PREFILL_MIN_BLOCKS 2
#endif

constexpr int kBM = 128, kBN = 128, kBK = GMM_PREFILL_BK;   // output tile, K step
constexpr int kStages = GMM_PREFILL_STAGES;                 // cp.async ring depth
constexpr int kWM = GMM_PREFILL_WM, kWN = GMM_PREFILL_WN;   // a warp's piece: 2 x 4 warps
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kMT = kWM / 16, kNT = kWN / 8;     // its m16 and n8 tiles
constexpr int kAStep = kThreads / (kBK / 8);     // rows between a thread's copies of A
constexpr int kBStep = kThreads / (kBN / 8);     // rows between its copies of B
constexpr int kLDA = kBK + 8;    // bf16 a shared row: an odd count of 16-byte units
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 8;
constexpr int kStageA = kBM * kLDA, kStageB = kBK * kLDB;   // elements
constexpr int kStage = kStageA + kStageB;
constexpr size_t kRingBytes = (size_t)kStages * kStage * sizeof(bf16);
constexpr size_t kOutBytes = (size_t)kBM * kLDC * sizeof(bf16);
constexpr size_t kSmemBytes = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;

static_assert(kBM % kAStep == 0 && kBK % kBStep == 0, "whole passes of copies");
static_assert(kStages >= 2 && kBK % 16 == 0 && kWM % 16 == 0 && kWN % 16 == 0,
              "a ring of two stages or more, whole m16n8k16 steps");

__global__ void __launch_bounds__(kThreads, GMM_PREFILL_MIN_BLOCKS)
gmm_prefill_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ gs, bf16* __restrict__ out, int Tn, int D,
                   int F, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const gmm::Tile tile = gmm::block_tile<kBM>(gs, Tn, E, blockIdx.x);
  if (tile.rows <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.y * kBN;
  // the tail past the last group multiplies nothing: its output is zero
  const int n_k = tile.group >= 0 ? (D + kBK - 1) / kBK : 0;

  // this thread's copies of a stage: A rows ra + kAStep j at columns
  // ca .. ca + 7 of the step; B rows kb + kBStep j at columns cb .. cb + 7
  const int ra = tid / (kBK / 8), ca = (tid % (kBK / 8)) * 8;
  const int kb = tid / (kBN / 8), cb = (tid % (kBN / 8)) * 8;
  const bf16* a_src = x + (long long)(tile.r0 + ra) * D + ca;
  const bool b_col = n0 + cb < F;
  const bf16* b_src = w + (long long)max(tile.group, 0) * D * F + (long long)kb * F + n0 + cb;

  auto load = [&](int stage, int kt) {
    bf16* as = ring + stage * kStage;
    bf16* bs = as + kStageA;
    const int k0 = kt * kBK;
    const bool a_k = k0 + ca < D;
#pragma unroll
    for (int j = 0; j < kBM / kAStep; ++j) {
      const bool ok = ra + kAStep * j < tile.rows && a_k;
      cp_async16(as + (ra + kAStep * j) * kLDA + ca,
                 ok ? a_src + (long long)kAStep * j * D + k0 : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kBK / kBStep; ++j) {
      const int k = k0 + kb + kBStep * j;
      const bool ok = b_col && k < D;
      cp_async16(bs + (kb + kBStep * j) * kLDB + cb,
                 ok ? b_src + (long long)(k0 + kBStep * j) * F : w, ok);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

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

    const bf16* as = ring + (kt % kStages) * kStage;
    const bf16* bs = as + kStageA;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4], b[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldsm_x4(a[i], as + (wm * kWM + i * 16 + (lane & 15)) * kLDA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp)
        ldsm_x4_trans(b[jp], bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDB +
                                 wn * kWN + jp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          mma_bf16(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: stage the tile in it

  // element e of accumulator (i, j) is row 16 i + g + 8 (e >> 1), column
  // 8 j + 2 tg + (e & 1) of the warp's piece
  const int g = lane >> 2, tg = lane & 3;
  bf16* cs = ring;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int r = wm * kWM + i * 16 + g, c = wn * kWN + j * 8 + 2 * tg;
      *reinterpret_cast<uint32_t*>(cs + r * kLDC + c) = pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(cs + (r + 8) * kLDC + c) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < kBM * kBN / 8; i += kThreads) {
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
// D and F multiples of 8.
extern "C" int gmm_prefill_launch(const void* x, const void* w, const void* group_sizes,
                                  void* out, int T, int D, int F, int E, void* stream) {
  if (T == 0 || F == 0) return 0;
  if (E < 0 || D % 8 || F % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opts in
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(gmm::grid_rows<kBM>(T, E), (F + kBN - 1) / kBN);
  gmm_prefill_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), T, D, F, E);
  return cudaGetLastError();
}

// kernel_attrs' out[0..2] of the kernel, then in out[3] the dynamic shared
// memory its launch asks for.
extern "C" int gmm_prefill_attrs(int* out) {
  out[3] = (int)kSmemBytes;
  return kernel_attrs(gmm_prefill_kernel, out);
}
