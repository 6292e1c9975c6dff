// Forward flash attention for Hopper in f32: causal / sliding-window / tanh
// softcap, GQA, runtime q_offset, masking from a kv_pos position vector.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel) for f32 inputs. bf16 inputs, which
// is everything the served models run, go to flash_decode.cu (split-KV,
// when the query fits one 16-row tile per kv head) and flash_prefill.cu
// (tensor cores, every other call). The TPU kernel walks KV blocks on a
// sequential grid axis with (m, l, acc) in VMEM scratch. Here one block of
// 128 threads owns one (b, kv-head, q-tile) and loops over KV tiles itself,
// keeping the running max, sum and accumulator in f32 registers. A q-tile
// holds 16 rows: q positions x the G query heads that share this kv head, so
// each K/V tile is loaded from device memory once for the whole group (GQA).
//
// What bounds it on the H100: its products are f32 FMAs from shared memory,
// so it is bound by shared-memory and FMA issue. f32 stays on FMAs because
// TF32 tensor cores would miss the f32 tolerance (1e-4), and nothing serves
// in f32. Tiles that are fully masked (causal or window, decided from kv_pos
// per tile) are skipped before their K/V is loaded.
//
// Layouts: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), any strides with the
// last dim contiguous (k/v rows 16-byte aligned); out (B, Sq, Hq, hd)
// contiguous; kv_pos (Skv,) int32 absolute positions, or null for iota.
#include "common.cuh"

namespace {

constexpr int kBQ = 16;        // q rows per block (positions x grouped heads)
constexpr int kBK = 32;        // kv rows per tile: one kv_pos per lane
constexpr int kThreads = 128;  // 8 row pairs x 16 column lanes
constexpr float kNegInf = -1e30f;

template <typename T, int HD>
struct Layout {
  static constexpr int QS = HD + 4;   // f32 per q row: 16-byte rows, banks shifted
  static constexpr int KS = HD + 2;   // T per k/v row: odd word stride, no conflicts
  static constexpr size_t q_bytes = (size_t)kBQ * QS * sizeof(float);
  static constexpr size_t kv_bytes = (size_t)kBK * KS * sizeof(T);
  static constexpr size_t p_bytes = (size_t)kBQ * kBK * sizeof(float);
  static constexpr size_t total = q_bytes + 2 * kv_bytes + p_bytes;
};

// Copy `rows` rows of a (kBK, HD) tile from device memory (16-byte loads)
// into padded shared memory; rows past the end are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, long long row_stride,
                                          int rows, T* s) {
  constexpr int CPR = HD * (int)sizeof(T) / 16;          // 16-byte chunks per row
  constexpr int WS = Layout<T, HD>::KS * (int)sizeof(T) / 4;  // words per smem row
  uint32_t* sw = reinterpret_cast<uint32_t*>(s);
  for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      u = *reinterpret_cast<const uint4*>(g + r * row_stride + cc * (16 / (int)sizeof(T)));
    uint32_t* d = sw + r * WS + cc * 4;
    d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kv_pos, T* __restrict__ out,
             int Sq, int Skv, int Hq, int G,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int q_offset, int causal, int window, float softcap, float scale) {
  using L = Layout<T, HD>;
  constexpr int NC = HD / 16;                     // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::q_bytes);
  T* vs = reinterpret_cast<T*>(smem + L::q_bytes + L::kv_bytes);
  float* ps = reinterpret_cast<float*>(smem + L::q_bytes + 2 * L::kv_bytes);

  const int PQ = kBQ / G;                         // q positions per block
  const int q0 = blockIdx.x * PQ;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid >> 4, cg = tid & 15;         // row pair, column lane

  // Q tile, scaled in f32: row r is position q0 + r / G of head hkv*G + r % G
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, qi = q0 + r / G;
    float val = 0.f;
    if (r < PQ * G && qi < Sq)
      val = to_f32(q[b * qsb + qi * qss + (long long)(hkv * G + r % G) * qsh + d]) * scale;
    qs[r * L::QS + d] = val;
  }
  const int q_first = q_offset + q0;
  const int q_last = q_first + min(PQ, Sq - q0) - 1;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q_offset + q0 + (2 * rg + i) / G;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const T* kb = k + b * ksb + hkv * ksh;
  const T* vb = v + b * vsb + hkv * vsh;

  for (int kt = 0; kt < Skv; kt += kBK) {
    const int kidx = kt + lane;
    const bool kvalid = kidx < Skv;
    const int kp = kvalid ? (kv_pos ? kv_pos[kidx] : kidx) : 0;
    // every warp derives the same skip decision from the tile's positions
    int kmin = kvalid ? kp : INT_MAX, kmax = kvalid ? kp : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    if ((causal && kmin > q_last) || (window > 0 && kmax <= q_first - window)) continue;

    const int rows = min(kBK, Skv - kt);
    load_tile<T, HD>(kb + kt * kss, kss, rows, ks);
    load_tile<T, HD>(vb + kt * vss, vss, rows, vs);
    __syncthreads();

    // scores for rows 2rg+i, columns cg + 16c
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const float* qr0 = qs + (2 * rg) * L::QS;
    const float* qr1 = qr0 + L::QS;
    const T* kr0 = ks + cg * L::KS;
    const T* kr1 = ks + (cg + 16) * L::KS;
#pragma unroll 8
    for (int d = 0; d < HD; d += 2) {
      const float2 a0 = ld2(qr0 + d), a1 = ld2(qr1 + d);
      const float2 b0 = ld2(kr0 + d), b1 = ld2(kr1 + d);
      s[0][0] = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y, s[0][0]));
      s[0][1] = fmaf(a0.x, b1.x, fmaf(a0.y, b1.y, s[0][1]));
      s[1][0] = fmaf(a1.x, b0.x, fmaf(a1.y, b0.y, s[1][0]));
      s[1][1] = fmaf(a1.x, b1.x, fmaf(a1.y, b1.y, s[1][1]));
    }

    // softcap, then mask, then the online softmax update
    int kpc[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) kpc[c] = __shfl_sync(0xffffffffu, kp, cg + 16 * c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[i][c];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kt + cg + 16 * c < Skv;
        if (causal) ok = ok && kpc[c] <= qpos[i];
        if (window > 0) ok = ok && kpc[c] > qpos[i] - window;
        s[i][c] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // fully-masked rows keep p = 0 (avoid exp(-inf - -inf) = 1)
        const float p = m_new > kNegInf / 2 ? expf(s[i][c] - m_new) : 0.f;
        ps[(2 * rg + i) * kBK + cg + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(fminf(m[i] - m_new, 0.f));
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V for this thread's rows and columns cg + 16c
    const float* p0r = ps + (2 * rg) * kBK;
    const float* p1r = p0r + kBK;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p0 = p0r[j], p1 = p1r[j];
      const T* vr = vs + j * L::KS + cg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = to_f32(vr[16 * c]);
        acc[0][c] = fmaf(p0, vv, acc[0][c]);
        acc[1][c] = fmaf(p1, vv, acc[1][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * rg + i, qi = q0 + r / G;
    if (r >= PQ * G || qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * Sq + qi) * Hq + hkv * G + r % G) * HD + cg;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_pos,
                   void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                   const long long* st, int q_offset, int causal, int window,
                   float softcap, cudaStream_t stream) {
  using L = Layout<T, HD>;
  auto kern = flash_kernel<T, HD>;
  if (L::total > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (e != cudaSuccess) return e;
  }
  const int G = Hq / Hkv, PQ = kBQ / G;
  dim3 grid((Sq + PQ - 1) / PQ, Hkv, B);
  kern<<<grid, kThreads, L::total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_pos, static_cast<T*>(out), Sq, Skv, Hq, G,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      q_offset, causal, window, softcap, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int hd, const void* q, const void* k, const void* v,
                         const int* kv_pos, void* out, int B, int Sq, int Skv,
                         int Hq, int Hkv, const long long* st, int q_offset,
                         int causal, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 96: return launch<T, 96>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 112: return launch<T, 112>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    case 256: return launch<T, 256>(q, k, v, kv_pos, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements. dtype: ReproDtype, kFloat32 only. kv_pos may be
// null (iota).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_pos, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int q_offset, int causal, int window, float softcap, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kBQ) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dtype<float>(hd, q, k, v, kp, out, B, Sq, Skv, Hq, Hkv, st, q_offset, causal, window, softcap, s);
  return cudaErrorInvalidValue;
}

// The f32 kernel at head dim hd: kernel_attrs' out[0..2], then in out[3]
// the dynamic shared memory its launch asks for.
extern "C" int flash_attention_attrs(int hd, int* out) {
#define REPRO_ATTRS(HD) \
  (out[3] = (int)Layout<float, HD>::total, kernel_attrs(flash_kernel<float, HD>, out))
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
