// Tensor-core flash attention for Hopper (bf16): prefill, and every call
// whose query does not fit one 16-row tile per kv head.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel) for those calls. The TPU kernel
// walks KV blocks on a sequential grid axis with (m, l, acc) in VMEM
// scratch. Here, in the FlashAttention-2 pattern, one block of 4 warps owns
// a 64-row q-tile of one (batch, q-head), 16 rows a warp, and loops over
// K/V tiles itself: grid (ceil(Sq / 64), Hq, B). The G q-heads of a
// kv head each read its K/V, mostly from L2 (a prefill layer's K/V is a few
// MB against 50 MB of L2).
//
// What bounds it on the H100: at the serving shapes (S 512, hd 96-256) a
// layer is 4-15 GFLOP on 8-16 MB, hundreds of operations per byte, so the
// tensor cores. The products are warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulators): S = Q K^T with Q and K fragments from ldmatrix (K stored
// row-major is the col-major B operand), then O += P V with V through
// ldmatrix.trans. The softmax stays in registers: S's accumulators are
// scaled, softcapped (tanh) and masked in place, each row's max and sum are
// reduced over the quad of lanes that holds it, and P goes to the PV product
// from the accumulator layout, which is the A-operand layout of mma.sync, as
// two bf16 parts: hi = bf16(p) and lo = bf16(p - hi), each multiplied by the
// same V fragments. The reference multiplies an f32 p by V. p rounded to
// bf16 alone is off by up to 2^-9 of itself, and a few keys with large |v|
// carry that into the output beside its own rounding: half a bf16 ulp, which
// at |out| in [4, 8) is 1.5625e-2 and leaves 4.4e-3 of the 2e-2 limit.
// hi + lo carries p to about 2^-17 of itself, for twice the PV products: 8-9 %
// more time at the served prefill shapes on an H100 (PERF.md §6).
// K/V tiles stream through a two-stage cp.async ring, so the next tile's
// bytes are in flight during this tile's products. A tile is 64 keys, 32 at
// hd 256: there 64 would need 169 KB of shared memory, one block (4 warps)
// per SM, too few to hide the latency of each warp's dependent
// ldmatrix/mma chain; 32 keys take 101 KB, two blocks per SM, and half the
// S registers. Shared-memory rows are padded by 8 bf16 (an odd count of
// 16-byte units), so ldmatrix's eight row addresses fall in distinct banks.
// The softcap's tanh is computed through one ex2. Q stays in shared memory and its
// fragments are reloaded per key tile, which keeps the 16 x hd f32 output
// accumulator (128 registers a thread at hd 256) clear of spills. Causal
// and window bounds start and end the key loop at the visible tiles where
// positions are indices; with kv_pos, a tile no row can see is skipped
// before it is loaded. Within a tile, a warp whose 16 rows see none of it
// skips the products, and one whose rows see all of it skips the mask.
// wgmma, TMA and warp specialisation are later work.
//
// Head dims: 16, 32, 64, 96, 112, 128 and 256. Each is a multiple of 16 (the
// k-step of S = Q K^T, HD / 16 of them) with HD / 8 even (PV takes V's 8-wide
// column tiles in pairs: 6 and 7 pairs at 96 and 112).
//
// Layouts: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), any strides with the
// last dim contiguous and rows 16-byte aligned; out (B, Sq, Hq, hd)
// contiguous; kv_pos (Skv,) int32 absolute positions, or null for iota.
#include "flash.cuh"
#include "mma.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

constexpr int kBQ = 64;          // q rows per block, 16 per warp
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct PrefillLayout {
  static constexpr int BK = HD >= 256 ? 32 : 64;   // keys per tile
  static constexpr int RS = HD + 8;   // bf16 per smem row: an odd count of 16-byte units
  static constexpr size_t q_bytes = (size_t)kBQ * RS * 2;
  static constexpr size_t tile_bytes = (size_t)BK * RS * 2;       // one K or V tile
  static constexpr size_t stage_bytes = 2 * tile_bytes + BK * 4;  // K, V, positions
  static constexpr size_t total = q_bytes + 2 * stage_bytes;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_pos,
                     bf16* __restrict__ out, int Sq, int Skv, int Hq, int G,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     int q_offset, int causal, int window, float softcap, float scale) {
  using L = PrefillLayout<HD>;
  constexpr int RS = L::RS, kBK = L::BK;
  constexpr int NT = kBK / 8;     // 8-key column tiles of S per warp
  constexpr int DT = HD / 8;      // 8-wide column tiles of O per warp
  static_assert(HD % 16 == 0 && DT % 2 == 0, "head dim: k-steps of 16, column tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + L::q_bytes;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;   // accumulator row (and row + 8), column pair

  flash::load_rows<kBQ, HD, RS, kThreads>(q + b * qsb + h * qsh, qss, q0, Sq, qs);

  // positions of the block's rows, of this warp's rows, of this thread's two rows
  const int q_lo = q_offset + q0, q_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  const bool warp_rows = q0 + warp * 16 < Sq;
  const int w_lo = q_lo + warp * 16, w_hi = min(w_lo + 15, q_hi);
  const int qp0 = w_lo + g, qp1 = qp0 + 8;

  const int n_tiles = (Skv + kBK - 1) / kBK;
  int t_begin = 0, t_end = n_tiles;
  if (!kv_pos) {      // positions are key indices: bound the loop directly
    if (causal) t_end = min(t_end, (q_hi + kBK) / kBK);
    if (window > 0) t_begin = max(0, (q_lo - window + 1) / kBK);
  }
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
    flash::load_rows<kBK, HD, RS, kThreads>(kb, kss, t * kBK, Skv, reinterpret_cast<bf16*>(p));
    flash::load_rows<kBK, HD, RS, kThreads>(vb, vss, t * kBK, Skv,
                                           reinterpret_cast<bf16*>(p + L::tile_bytes));
    flash::stage_positions<kBK>(kv_pos, t * kBK, Skv, reinterpret_cast<int*>(p + 2 * L::tile_bytes));
  };

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int cur = next_tile(t_begin), st = 0;
  if (cur < t_end) load(cur, 0);
  cp_async_commit();                         // Q and the first tile
  while (cur < t_end) {
    const int nxt = next_tile(cur + 1);
    if (nxt < t_end) load(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* p = stages + st * L::stage_bytes;
    const bf16* ks = reinterpret_cast<const bf16*>(p);
    const bf16* vs = reinterpret_cast<const bf16*>(p + L::tile_bytes);
    const int* ps = reinterpret_cast<const int*>(p + 2 * L::tile_bytes);
    const int kt = cur * kBK;

    // this warp's view of the tile: none of it visible, or all of it
    int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int j = lane; j < kBK; j += 32) {
      if (kt + j < Skv) {
        kmin = min(kmin, ps[j]);
        kmax = max(kmax, ps[j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    const bool skip = !warp_rows || flash::tile_hidden(kmin, kmax, w_lo, w_hi, causal, window);
    const bool whole = kt + kBK <= Skv && (!causal || kmax <= w_lo) &&
                       (window <= 0 || kmin > w_hi - window);

    if (!skip) {
      // S = Q K^T: 16 rows x 64 keys per warp
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, softcap, then mask; element e of column tile j is row
      // g + 8 * (e >> 1), key j * 8 + 2 * tg + (e & 1)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = flash::softcap_tanh(x, softcap, inv_cap);
          if (!whole) {
            const int col = j * 8 + 2 * tg + (e & 1);
            if (!flash::key_visible(kt + col, Skv, ps[col], e < 2 ? qp0 : qp1, causal, window))
              x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m[e >> 1];
          // fully-masked rows keep p = 0 (avoid exp(-inf - -inf) = 1)
          const float pv = mr > kNegInf / 2 ? exp2f((s[j][e] - mr) * kLog2e) : 0.f;
          s[j][e] = pv;
          rsum[e >> 1] += pv;
        }
      }
      // l stays a per-lane partial sum (its quad shares m); reduced at the end
      l[0] = l[0] * corr[0] + rsum[0];
      l[1] = l[1] * corr[1] + rsum[1];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }

      // O += P V: P's accumulators, as bf16 parts hi and lo, are the A
      // fragments; each V fragment is loaded once for both parts
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = pack_bf16_split(s[2 * kk + (i >> 1)][2 * (i & 1)],
                                 s[2 * kk + (i >> 1)][2 * (i & 1) + 1], al[i]);
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], a, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
          mma_bf16(o[2 * dp], al, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], al, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();     // the stage is free for the load issued next round
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

  // normalise and store; a row that saw no key gives 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* orow = out + (((long long)b * Sq + qi) * Hq + h) * HD + 2 * tg;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_pos, void* out,
                   int B, int Sq, int Skv, int Hq, int Hkv, const long long* st,
                   int q_offset, int causal, int window, float softcap, cudaStream_t stream) {
  using L = PrefillLayout<HD>;
  auto kern = flash_prefill_kernel<HD>;
  if (L::total > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, L::total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_pos, static_cast<bf16*>(out), Sq, Skv, Hq, Hq / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      q_offset, causal, window, softcap, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements. kv_pos may be null (iota).
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, const void* kv_pos, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int q_offset, int causal, int window, float softcap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL(HD) \
  launch<HD>(q, k, v, kp, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s)
  switch (hd) {
    case 16: return REPRO_PREFILL(16);
    case 32: return REPRO_PREFILL(32);
    case 64: return REPRO_PREFILL(64);
    case 96: return REPRO_PREFILL(96);
    case 112: return REPRO_PREFILL(112);
    case 128: return REPRO_PREFILL(128);
    case 256: return REPRO_PREFILL(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PREFILL
}

// The prefill kernel at head dim hd: kernel_attrs' out[0..2], then in
// out[3] the dynamic shared memory its launch asks for.
extern "C" int flash_prefill_attrs(int hd, int* out) {
#define REPRO_ATTRS(HD) \
  (out[3] = (int)PrefillLayout<HD>::total, kernel_attrs(flash_prefill_kernel<HD>, out))
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
