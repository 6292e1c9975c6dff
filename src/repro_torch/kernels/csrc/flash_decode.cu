// Split-KV flash attention for decode on Hopper (bf16): the query rows of a
// step (Sq x G <= 16 of them per kv head) against a long ring cache.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel) where the whole query of one kv
// head fits one 16-row tile, which is every decode step. The TPU kernel
// walks the KV blocks of one q-tile in order on one core. Here the keys are
// cut into n_split contiguous ranges of 64-key tiles, and each range is one
// block: grid (n_split, Hkv, B). A block keeps a running max, sum and
// accumulator over its tiles and writes them unnormalised, in f32, as a
// partial (m, l, o); a second kernel rescales the partials by exp(m - max m)
// and sums them into the bf16 output. n_split comes from B, Hkv and Skv
// alone (the wrapper's split_kv_plan), never from kv_pos, so choosing it
// needs no host sync.
//
// What bounds it on the H100: bytes. A decode step reads each written K/V
// row once and does 4 x hd operations per key and query row on it: with
// G = 2 or 4 rows that is about one operation per byte, far below the
// ~295 the tensor cores need. So the design is about bytes in flight, not
// arithmetic: B x Hkv x n_split blocks (256 at both served shapes, all
// resident at once, two per SM) each stream their tiles through a cp.async
// ring (16 bytes a thread, zero-filled past Skv), and a tile whose positions
// no query can see (unwritten ring slots hold 2**30, outside a causal bound
// or the window) is skipped before any of its bytes are requested. The ring
// has two stages when a split has two tiles or more, and one when it has
// one (gemma2's 16 splits of 1024 slots): a second stage could never be
// used there, and leaving it out halves a block's shared memory at hd 256,
// which is what lets two blocks share an SM. Q comes in by cp.async with the
// first tile. The products are f32 FMAs from shared memory: with 2-4 real
// rows, mma.sync would pad them to 16 and do 4-8x the arithmetic for the
// same bytes, and FMA issue is not the limit.
//
// Head dims: 16, 32, 64, 96, 112, 128 and 256 (multiples of 8: 16-byte
// copies and dot products in steps of 8).
//
// Layouts: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), any strides with the
// last dim contiguous and rows 16-byte aligned; kv_pos (Skv,) int32 or null
// (iota); partials o (B, Sq*Hq, n_split, hd), m and l (B, Sq*Hq, n_split),
// row index qi * Hq + head; out (B, Sq, Hq, hd) contiguous.
#include "flash.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

constexpr int kBK = 64;          // keys per tile
constexpr int kRows = 16;        // query rows per block at most (Sq x G)
constexpr int kThreads = 128;

// Q rows (bf16), scores, per-row (m, l, correction), then one or two stages
template <int HD>
struct SplitLayout {
  static constexpr int RS = HD + 8;   // bf16 per K/V row: an odd count of 16-byte units
  static constexpr int SS = kBK + 1;  // f32 per score row
  static constexpr size_t q_bytes = (size_t)kRows * HD * 2;
  static constexpr size_t s_bytes = (size_t)kRows * SS * 4;
  static constexpr size_t head_bytes = q_bytes + s_bytes + 3 * kRows * 4;
  static constexpr size_t tile_bytes = (size_t)kBK * RS * 2;       // one K or V tile
  static constexpr size_t stage_bytes = 2 * tile_bytes + kBK * 4;  // K, V, positions
  static constexpr size_t bytes(int stages) { return head_bytes + stages * stage_bytes; }
};

// eight bf16 (one 16-byte load) as f32
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(e2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ kv_pos,
                   float* __restrict__ o_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, int Sq, int Skv, int Hq, int G,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   int q_offset, int causal, int window, float softcap, float scale,
                   int tiles_per_split) {
  using L = SplitLayout<HD>;
  constexpr int NCP = HD / 2;              // column pairs of the output
  constexpr int RSTEP = kThreads / NCP;    // threads sharing a column pair
  constexpr int NR = kRows / RSTEP;        // output rows per thread at most
  static_assert(RSTEP >= 1 && kRows % RSTEP == 0, "head dim: rows split evenly over threads");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* sc = reinterpret_cast<float*>(smem + L::q_bytes);
  float* m_s = sc + kRows * L::SS;         // running max, sum and last correction per row
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  unsigned char* stages = smem + L::head_bytes;

  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = Sq * G;

  // Q rows, in the first cp.async group: row r is position r / G of head
  // hkv * G + r % G
  for (int c = tid; c < R * (HD / 8); c += kThreads) {
    const int r = c / (HD / 8), cc = c % (HD / 8);
    cp_async16(qs + r * HD + cc * 8,
               q + b * qsb + (long long)(r / G) * qss + (long long)(hkv * G + r % G) * qsh +
                   cc * 8, true);
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int q_lo = q_offset, q_hi = q_offset + Sq - 1;
  const int n_tiles = (Skv + kBK - 1) / kBK;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  const bf16* kb = k + b * ksb + hkv * ksh;
  const bf16* vb = v + b * vsb + hkv * vsh;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  auto next_tile = [&](int t) {
    for (; t < t_end; ++t) {
      int kmin, kmax;
      flash::tile_span<kBK>(kv_pos, t * kBK, Skv, kmin, kmax);
      if (!flash::tile_hidden(kmin, kmax, q_lo, q_hi, causal, window)) break;
    }
    return t;
  };
  auto load = [&](int t, int s) {
    unsigned char* p = stages + s * L::stage_bytes;
    flash::load_rows<kBK, HD, L::RS, kThreads>(kb, kss, t * kBK, Skv, reinterpret_cast<bf16*>(p));
    flash::load_rows<kBK, HD, L::RS, kThreads>(vb, vss, t * kBK, Skv,
                                              reinterpret_cast<bf16*>(p + L::tile_bytes));
    flash::stage_positions<kBK>(kv_pos, t * kBK, Skv, reinterpret_cast<int*>(p + 2 * L::tile_bytes));
  };

  float acc[NR][2];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i][0] = acc[i][1] = 0.f;
  // at hd 96 and 112, 48 and 56 column pairs do not divide 128 threads: the
  // 32 and 16 threads past RSTEP x NCP take no part in the PV product
  const int cp = tid % NCP, rg = tid / NCP;
  const bool pv_thread = rg < RSTEP;

  int cur = next_tile(split * tiles_per_split), st = 0;
  if (cur < t_end) load(cur, 0);
  cp_async_commit();                         // Q and the first tile
  while (cur < t_end) {
    const int nxt = next_tile(cur + 1);     // the next tile's bytes fly during this one
    if (nxt < t_end) load(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* p = stages + st * L::stage_bytes;
    const bf16* ks = reinterpret_cast<const bf16*>(p);
    const bf16* vs = reinterpret_cast<const bf16*>(p + L::tile_bytes);
    const int* ps = reinterpret_cast<const int*>(p + 2 * L::tile_bytes);
    const int kt = cur * kBK;

    // scores: the R x 64 (row, key) pairs in passes of 128, one dot product
    // a thread, so only real rows cost work. A warp's 32 keys share one row
    // (Q reads broadcast); K rows sit an odd count of 16-byte units apart, so
    // no bank conflicts. Four partial sums keep the FMA chains short.
    for (int item = tid; item < R * kBK; item += kThreads) {
      const int r = item / kBK, j = item % kBK;
      const bf16* kr = ks + j * L::RS;
      const bf16* qr = qs + r * HD;
      float x4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        float kf[8], qf[8];
        unpack8(*reinterpret_cast<const uint4*>(kr + d), kf);
        unpack8(*reinterpret_cast<const uint4*>(qr + d), qf);
#pragma unroll
        for (int e = 0; e < 8; ++e) x4[e & 3] = fmaf(qf[e], kf[e], x4[e & 3]);
      }
      float x = ((x4[0] + x4[1]) + (x4[2] + x4[3])) * scale;
      if (softcap > 0.f) x = flash::softcap_tanh(x, softcap, inv_cap);   // then mask
      const bool ok = flash::key_visible(kt + j, Skv, ps[j], q_offset + r / G, causal, window);
      sc[r * L::SS + j] = ok ? x : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      const float x0 = sc[r * L::SS + lane], x1 = sc[r * L::SS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      // fully-masked rows keep p = 0 (avoid exp(-inf - -inf) = 1)
      const bool any = m_new > kNegInf / 2;
      const float p0 = any ? expf(x0 - m_new) : 0.f, p1 = any ? expf(x1 - m_new) : 0.f;
      sc[r * L::SS + lane] = p0;
      sc[r * L::SS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(fminf(m_old - m_new, 0.f));
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for this thread's column pair and rows
    const bf16* vc = vs + 2 * cp;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rg + RSTEP * i;
      if (!pv_thread || r >= R) break;
      const float* pr = sc + r * L::SS;
      // even and odd keys in separate sums: half-length FMA chains
      float a[2][2] = {{acc[i][0] * c_s[r], acc[i][1] * c_s[r]}, {0.f, 0.f}};
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float2 vv = ld2(vc + j * L::RS);
        a[j & 1][0] = fmaf(pr[j], vv.x, a[j & 1][0]);
        a[j & 1][1] = fmaf(pr[j], vv.y, a[j & 1][1]);
      }
      acc[i][0] = a[0][0] + a[1][0];
      acc[i][1] = a[0][1] + a[1][1];
    }
    __syncthreads();     // the stage is free for the load issued next round
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

  // the partial of this split; a split whose tiles were all hidden writes
  // m = -1e30, l = 0, o = 0
  const long long row0 = (long long)b * Sq * Hq;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + RSTEP * i;
    if (pv_thread && r < R) {
      const long long row = row0 + (r / G) * Hq + hkv * G + r % G;
      *reinterpret_cast<float2*>(o_part + (row * n_split + split) * HD + 2 * cp) =
          make_float2(acc[i][0], acc[i][1]);
    }
  }
  if (tid < R) {
    const long long row = row0 + (tid / G) * Hq + hkv * G + tid % G;
    m_part[row * n_split + split] = m_s[tid];
    l_part[row * n_split + split] = l_s[tid];
  }
}

// out[row] = sum_s w_s o_s / sum_s w_s l_s with w_s = exp(m_s - max m); a
// row that saw no visible key anywhere gives 0. One block per output row:
// warp 0 turns the row's (m, l) into the weights w_s / sum_s w_s l_s in
// shared memory (n_split + 1 floats), then every thread sums its columns.
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                     const float* __restrict__ l_part, bf16* __restrict__ out,
                     int n_split, int HD) {
  extern __shared__ float w[];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const float* mr = m_part + row * n_split;
    const float* lr = l_part + row * n_split;
    float M = kNegInf;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, mr[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float total = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float ws = M > kNegInf / 2 ? expf(mr[s] - M) : 0.f;
      w[s] = ws;
      total += ws * lr[s];
    }
    total = warp_sum(total);
    if (lane == 0) w[n_split] = total > 0.f ? 1.f / total : 0.f;
  }
  __syncthreads();
  const float inv = w[n_split];
  const float* orow = o_part + row * n_split * HD;
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) a = fmaf(w[s], orow[s * HD + d], a);
    out[row * HD + d] = __float2bfloat16(a * inv);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_pos, void* out,
                   float* o_part, float* m_part, float* l_part, int B, int Sq, int Skv,
                   int Hq, int Hkv, const long long* st, int q_offset, int causal,
                   int window, float softcap, int n_split, int tiles_per_split,
                   cudaStream_t stream) {
  using L = SplitLayout<HD>;
  auto kern = flash_split_kernel<HD>;
  // one stage when no split has a second tile to prefetch
  const size_t smem = L::bytes(tiles_per_split > 1 ? 2 : 1);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes(2));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_split, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_pos, o_part, m_part, l_part, Sq, Skv, Hq, Hq / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      q_offset, causal, window, softcap, (float)(1.0 / sqrt((double)HD)), tiles_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_combine_kernel<<<B * Sq * Hq, HD < 32 ? 32 : HD < 128 ? HD : 128,
                         (n_split + 1) * sizeof(float), stream>>>(
      o_part, m_part, l_part, static_cast<bf16*>(out), n_split, HD);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements. kv_pos may be null (iota). o_part, m_part and
// l_part are f32 scratch of B*Sq*Hq*n_split*hd and B*Sq*Hq*n_split elements;
// split s covers tiles [s * tiles_per_split, (s + 1) * tiles_per_split).
extern "C" int flash_split_kv_launch(
    const void* q, const void* k, const void* v, const void* kv_pos, void* out,
    void* o_part, void* m_part, void* l_part,
    int B, int Sq, int Skv, int Hq, int Hkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int q_offset, int causal, int window, float softcap,
    int n_split, int tiles_per_split, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Sq * (Hq / Hkv) > kRows) return cudaErrorInvalidValue;
  if (n_split < 1 || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split * kBK < Skv)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* kp = static_cast<const int*>(kv_pos);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SPLIT(HD) \
  launch<HD>(q, k, v, kp, out, o, m, l, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, \
             softcap, n_split, tiles_per_split, s)
  switch (hd) {
    case 16: return REPRO_SPLIT(16);
    case 32: return REPRO_SPLIT(32);
    case 64: return REPRO_SPLIT(64);
    case 96: return REPRO_SPLIT(96);
    case 112: return REPRO_SPLIT(112);
    case 128: return REPRO_SPLIT(128);
    case 256: return REPRO_SPLIT(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT
}

// The split kernel at head dim hd: kernel_attrs' out[0..2], then in out[3]
// and out[4] the dynamic shared memory of a launch with a one- and a
// two-stage ring.
extern "C" int flash_split_kv_attrs(int hd, int* out) {
#define REPRO_ATTRS(HD)                                                      \
  (out[3] = (int)SplitLayout<HD>::bytes(1), out[4] = (int)SplitLayout<HD>::bytes(2), \
   kernel_attrs(flash_split_kernel<HD>, out))
  switch (hd) {
    case 16: return REPRO_ATTRS(16);
    case 32: return REPRO_ATTRS(32);
    case 64: return REPRO_ATTRS(64);
    case 96: return REPRO_ATTRS(96);
    case 112: return REPRO_ATTRS(112);
    case 128: return REPRO_ATTRS(128);
    case 256: return REPRO_ATTRS(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ATTRS
}

// The combine kernel: kernel_attrs' out[0..2] (its dynamic shared memory is
// n_split + 1 floats).
extern "C" int flash_combine_attrs(int* out) {
  return kernel_attrs(flash_combine_kernel, out);
}
