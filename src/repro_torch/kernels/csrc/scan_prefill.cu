// Mamba selective scan for Hopper, prefill: the associative form across a warp.
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) b_t^T,   y_t = h_t c_t + D * u_t,
// with f32 state, the final state hT returned in f32 and D * u folded into y
// before its one rounding.
//
// Replaces src/repro/kernels/selective_scan/selective_scan.py::
// selective_scan_pallas (_scan_kernel), which carries a (bd x d_state) state
// block in VMEM along a sequential grid axis over S. The JAX package's own
// prefill path runs the associative form instead (src/repro/models/ssm.py::
// selective_scan_assoc): h -> A h + B composes as (A, B) o (A', B') =
// (A'A, A'B + B'). This kernel is that form, cut to a group of lanes:
//
//  * A warp's 32 lanes are kChPerWarp = 8 channels x kRuns = 4 runs: lane
//    (c, r) owns channel c's r-th run of lr consecutive steps (lr =
//    min(kLaneSteps, ceil(S / kRuns)), 16 from S = 64 on), so a tile is kRuns
//    x lr steps. An item is kChannels = 64 neighbouring channels of one batch
//    row (128 bytes of bf16 a step) in a block of 8 warps. Blocks are
//    persistent, two an SM for bf16 (a lane's run of 16 steps takes up to
//    128 registers, so an SM holds 16 warps; f32 leaves room for one): each
//    walks a contiguous range of items tile by tile, and while one block
//    copies, converts or stores, the other computes.
//  * A tile's u and dt columns and its b, c rows (b and c keep their strided
//    layout: the model slices them out of one projection), and at an item's
//    first tile its h0, A and D, are copied into shared memory with cp.async,
//    the block's next tile while this one is computed (two stages). b and c
//    are then turned into f32 rows by state, swizzled so that the runs of a
//    state are read with conflict-free 16-byte loads; the kChPerWarp lanes of
//    a warp that share a run read the same address, once.
//  * For each state s, each lane computes da = 2^(dt * a_s * log2 e) once a
//    step (ex2.approx, on the SFU) and bu = dt * u * b, folds its run into
//    one (A, B), joins an inclusive scan of its channel's kRuns aggregates
//    with __shfl_up_sync (two levels), applies its exclusive prefix to the
//    tile's carry-in (h0, then the previous tile's) and walks its run again
//    from registers, adding h * c into its per-step y. The exponentials of
//    the steps are computed once per (t, s).
//  * A run's A is one exponential of a_s log2 e * sum dt, computed on the
//    FMA pipe within an ulp (one per run and state, 1/16 of the work), and
//    the carry to the next tile is the last run's inclusive (A, B) applied
//    to the carry-in, not its walked state. So a state's decay over many
//    tiles is a product of kRuns accurate factors a tile, and the SFU's
//    error of an ulp or two in each step's da reaches only the steps of one
//    run: where states barely decay (da near 1) over hundreds of steps, a
//    product of 16 SFU factors a tile would accumulate it past the f32
//    limit.
//  * y is written into the tile's u slots in shared memory (each lane over
//    the slots it read) and stored from there in 16-byte pieces; hT is the
//    last tile's carry, kept in shared memory per (channel, state).
//
// What bounds it on the H100: the B*S*di*d_state exponentials on the SFU (16
// a clock an SM), above the bytes of u, dt, y and the states; then issue
// (about ten instructions per (t, s)), with 4 warps a scheduler to hide each
// state's chain of exponentials, shuffles and FMAs. Fewer runs a channel
// shorten that chain (log2 kRuns shuffle levels) and spread each state's
// fixed cost over fewer lanes; at 2 runs a lane's state outgrows 128
// registers and spills.
//
// Layouts as csrc/selective_scan.cu: u, dt, y (B, S, di) contiguous; A (di,
// st) f32 contiguous; b, c (B, S, st) with any batch/seq strides and the last
// dim contiguous; d_skip (di,); h0, hT (B, di, st) f32 contiguous. u, dt, b,
// c, d_skip and y share one dtype; 1 <= st <= 16. The slot case (rows_per_a
// > 0) as csrc/selective_scan.cu's: A (B / rows_per_a, di, st) and d_skip
// (B / rows_per_a, di), batch row b reading row b / rows_per_a of each; an
// item loads its batch row's trial's rows at its first tile.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kRuns = 4;                         // lanes (runs) a channel: the scan's width
constexpr int kChPerWarp = kLanes / kRuns;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;        // 256
constexpr int kChannels = kWarps * kChPerWarp;   // channels an item
constexpr int kLaneSteps = 16;                   // step slots a lane
constexpr int kSlots = kRuns * kLaneSteps;       // step slots a tile
constexpr int kMaxState = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kGroups = kLaneSteps / 4;          // float4 a run of one state
constexpr int kMinBlocks = 2;                    // bf16; f32's tiles leave shared memory for one
constexpr int kMaxDevices = 64;

// One stage in shared memory: a tile's u, dt, b and c, and at an item's first
// tile its h0, A and D. Slot (r, j) (run r's j-th step) is row r * kLaneSteps
// + j of each array. A u or dt row is the item's channels; run r's rows start
// 16 bytes further on (one pad a run), so that the lanes reading one channel
// group at their j-th step spread over the banks. A b or c row holds
// kMaxState elements, of which st are written. h0 and A are the item's rows as
// they lie (channel by channel, st floats each).
template <typename T>
struct Stage {
  static constexpr int kRowBytes = kChannels * sizeof(T);
  static constexpr int kUBytes = kSlots * kRowBytes + kRuns * 16;
  static constexpr int kBCBytes = kSlots * kMaxState * sizeof(T);
  static constexpr int kBOff = 2 * kUBytes;                   // after u, dt
  static constexpr int kH0Off = kBOff + 2 * kBCBytes;         // after b, c
  static constexpr int kAOff = kH0Off + kChannels * kMaxState * 4;
  static constexpr int kDOff = kAOff + kChannels * kMaxState * 4;
  static constexpr int kDChunks = kChannels * sizeof(T) / 16;   // 16-byte pieces of D
  static constexpr int kBytes = kDOff + 16 * kDChunks;
  static constexpr int kVec = 16 / sizeof(T);                 // elements a 16-byte copy
  static constexpr int kUChunks = kRowBytes / 16;             // 16-byte copies a u row

  __device__ static int u_off(int slot) {
    return slot * kRowBytes + (slot / kLaneSteps) * 16;
  }
};

// Which float4 of run r holds its g-th: the kGroups float4 of a run are
// rotated by run so that the 8 runs of a 16-byte load phase cover all 32
// banks.
__device__ __forceinline__ int bc_group(int r, int g) {
  return (g ^ (r / (8 / kGroups))) & (kGroups - 1);
}
// Position of slot (r, j) in an f32 row of one state.
__device__ __forceinline__ int bc_pos(int r, int j) {
  return r * kLaneSteps + (bc_group(r, j >> 2) << 2) + (j & 3);
}

__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the FMA pipe, within an ulp: x = n + f with n = rint(x), |f| <= 1/2,
// 2^f by its Taylor polynomial of degree 7 (remainder below 6e-9), times 2^n
// (x is clamped to [-126, 126], where 2^n is a normal float).
__device__ __forceinline__ float ex2_fma(float x) {
  x = fminf(fmaxf(x, -126.f), 126.f);
  const float n = rintf(x), f = x - n;
  float t = fmaf(f, 1.5252734e-5f, 1.5403530e-4f);
  t = fmaf(f, t, 1.3333558e-3f);
  t = fmaf(f, t, 9.6181291e-3f);
  t = fmaf(f, t, 5.5504109e-2f);
  t = fmaf(f, t, 2.4022651e-1f);
  t = fmaf(f, t, 6.9314718e-1f);
  return fmaf(f, t, 1.f) * __int_as_float((__float2int_rn(n) + 127) << 23);
}

// nbytes (<= 16) from src into the 16 bytes at dst, the rest zero-filled;
// src 16-byte aligned
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(nbytes) : "memory");
}

struct Args {
  const void* u;
  const void* dt;
  const float* A;
  const void* b;
  const void* c;
  const void* dskip;
  const float* h0;
  void* y;
  float* hT;
  int B, S, di, st, lr;
  long long b_sb, b_ss, c_sb, c_ss;
  long long rows_per_a;   // 0: one A and D; else batch rows a row of A and D
  bool vec_u;       // u, dt, y rows copied 16 bytes at a time
  bool vec_bc;      // b, c rows copied 16 bytes at a time
  bool vec_state;   // h0, A and D copied 16 bytes at a time
};

// Copy tile t0 (lr steps a run) of the item (bat, d0) into one stage, and at
// t0 = 0 its h0, A and D: cp.async where the rows allow 16-byte pieces, else
// element by element. Slots past the run or past S, channels past di and
// states past st are zeros (identity steps: 2^0 = 1, bu = 0).
template <typename T>
__device__ void load_tile(unsigned char* stage, const Args& p, int bat, int d0, int t0) {
  using St = Stage<T>;
  constexpr int V = St::kVec;
  const T* u = static_cast<const T*>(p.u);
  const T* dt = static_cast<const T*>(p.dt);
  for (int i = threadIdx.x; i < kSlots * St::kUChunks; i += kThreads) {
    const int slot = i / St::kUChunks, ch = i % St::kUChunks;
    const int r = slot / kLaneSteps, j = slot % kLaneSteps;
    const int t = t0 + r * p.lr + j;
    const bool on = j < p.lr && t < p.S;
    const int d = d0 + ch * V;
    const long long g = ((long long)bat * p.S + t) * p.di + d;
    unsigned char* su = stage + St::u_off(slot) + ch * 16;
    if (p.vec_u) {
      const bool v = on && d < p.di;
      cp_async16(su, v ? u + g : u, v);
      cp_async16(su + St::kUBytes, v ? dt + g : dt, v);
    } else {
      T* eu = reinterpret_cast<T*>(su);
      T* edt = reinterpret_cast<T*>(su + St::kUBytes);
      for (int e = 0; e < V; ++e) {
        const bool v = on && d + e < p.di;
        eu[e] = v ? u[g + e] : from_f32<T>(0.f);
        edt[e] = v ? dt[g + e] : from_f32<T>(0.f);
      }
    }
  }
  const T* bm = static_cast<const T*>(p.b) + bat * p.b_sb;
  const T* cm = static_cast<const T*>(p.c) + bat * p.c_sb;
  const int nchunks = (p.st + V - 1) / V;
  for (int i = threadIdx.x; i < kSlots * nchunks; i += kThreads) {
    const int slot = i / nchunks, ch = i % nchunks;
    const int r = slot / kLaneSteps, j = slot % kLaneSteps;
    const int t = t0 + r * p.lr + j;
    const bool on = j < p.lr && t < p.S;
    const int s0 = ch * V;
    unsigned char* db = stage + St::kBOff + (slot * kMaxState + s0) * sizeof(T);
    if (p.vec_bc) {
      cp_async16(db, on ? bm + t * p.b_ss + s0 : bm, on);
      cp_async16(db + St::kBCBytes, on ? cm + t * p.c_ss + s0 : cm, on);
    } else {
      T* eb = reinterpret_cast<T*>(db);
      T* ec = reinterpret_cast<T*>(db + St::kBCBytes);
      for (int e = 0; e < V; ++e) {
        const bool v = on && s0 + e < p.st;
        eb[e] = v ? bm[t * p.b_ss + s0 + e] : from_f32<T>(0.f);
        ec[e] = v ? cm[t * p.c_ss + s0 + e] : from_f32<T>(0.f);
      }
    }
  }
  if (t0 != 0) return;
  const int nch = min(kChannels, p.di - d0), nf = nch * p.st;
  const long long slot = p.rows_per_a ? bat / p.rows_per_a : 0;   // the row's trial
  const float* h0 = p.h0 + ((long long)bat * p.di + d0) * p.st;
  const float* A = p.A + (slot * p.di + d0) * p.st;
  const T* dsk = static_cast<const T*>(p.dskip) + slot * p.di + d0;
  float* sh0 = reinterpret_cast<float*>(stage + St::kH0Off);
  float* sA = reinterpret_cast<float*>(stage + St::kAOff);
  T* sD = reinterpret_cast<T*>(stage + St::kDOff);
  if (p.vec_state) {
    const int nq = (nf + 3) / 4;          // 16-byte pieces of h0's rows, and of A's
    for (int i = threadIdx.x; i < 2 * nq + St::kDChunks; i += kThreads) {
      if (i < 2 * nq) {
        const int q = i >> 1, n = min(16, (nf - 4 * q) * 4);
        if (i & 1) cp_async16_n(sA + 4 * q, A + 4 * q, n);
        else cp_async16_n(sh0 + 4 * q, h0 + 4 * q, n);
      } else {
        const int q = i - 2 * nq, n = nch * (int)sizeof(T) - 16 * q;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(dsk);
        cp_async16_n(reinterpret_cast<unsigned char*>(sD) + 16 * q, n > 0 ? src + 16 * q : src,
                     max(0, min(16, n)));
      }
    }
  } else {
    for (int i = threadIdx.x; i < nf; i += kThreads) {
      sh0[i] = h0[i];
      sA[i] = A[i];
    }
    if (threadIdx.x < nch) sD[threadIdx.x] = dsk[threadIdx.x];
  }
}

// A run of one state row (bc_pos's order undone).
__device__ __forceinline__ void load_run(const float* row, int r, float v[kLaneSteps]) {
  const float4* q = reinterpret_cast<const float4*>(row + r * kLaneSteps);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float4 f = q[bc_group(r, g)];
    v[4 * g] = f.x;
    v[4 * g + 1] = f.y;
    v[4 * g + 2] = f.z;
    v[4 * g + 3] = f.w;
  }
}

// Pass 1 of one state: da and bu a step, and the run folded into (agA, agB).
// FULL: the run has all kLaneSteps steps (no step past lr to skip).
template <bool FULL>
__device__ __forceinline__ void fold_run(const float dtv[kLaneSteps], const float dtu[kLaneSteps],
                                         const float bv[kLaneSteps], float a2, float dtsum,
                                         int lr, float da[kLaneSteps], float bu[kLaneSteps],
                                         float& agA, float& agB) {
#pragma unroll
  for (int j = 0; j < kLaneSteps; ++j) {
    if (FULL || j < lr) {
      da[j] = ex2_sfu(dtv[j] * a2);
      bu[j] = dtu[j] * bv[j];
      agB = fmaf(da[j], agB, bu[j]);
    }
  }
  agA = ex2_fma(a2 * dtsum);            // the product of the run's da
}

// Every state of one tile for this lane's run r of its channel ch.
template <bool FULL>
__device__ __forceinline__ void scan_states(const float dtv[kLaneSteps],
                                            const float dtu[kLaneSteps], float yv[kLaneSteps],
                                            float dtsum, const float* bs, const float* cs,
                                            const float* a2row, float* carry, int st, int lr,
                                            int r) {
  for (int s = 0; s < st; ++s) {
    const float a2 = a2row[s];
    const float hin = carry[s];
    float bv[kLaneSteps], da[kLaneSteps], bu[kLaneSteps];
    load_run(bs + s * kSlots, r, bv);
    float agA, agB = 0.f;             // this lane's run as h -> agA h + agB
    fold_run<FULL>(dtv, dtu, bv, a2, dtsum, lr, da, bu, agA, agB);
    // inclusive scan of the channel's aggregates over its runs
#pragma unroll
    for (int off = 1; off < kRuns; off <<= 1) {
      const float pA = __shfl_up_sync(0xffffffffu, agA, off, kRuns);
      const float pB = __shfl_up_sync(0xffffffffu, agB, off, kRuns);
      if (r >= off) {
        agB = fmaf(agA, pB, agB);
        agA *= pA;
      }
    }
    // the exclusive prefix, applied to the tile's carry-in
    const float eA = __shfl_up_sync(0xffffffffu, agA, 1, kRuns);
    const float eB = __shfl_up_sync(0xffffffffu, agB, 1, kRuns);
    float h = r == 0 ? hin : fmaf(eA, hin, eB);
    float cv[kLaneSteps];
    load_run(cs + s * kSlots, r, cv);
#pragma unroll
    for (int j = 0; j < kLaneSteps; ++j) {
      if (FULL || j < lr) {
        h = fmaf(da[j], h, bu[j]);
        yv[j] = fmaf(h, cv[j], yv[j]);
      }
    }
    __syncwarp();             // every lane has read carry[s]
    if (r == kRuns - 1) carry[s] = fmaf(agA, hin, agB);   // the tile's (A, B) on the carry-in
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? kMinBlocks : 1)
scan_prefill_kernel(const Args p) {
  using St = Stage<T>;
  constexpr int V = St::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float carry[kChannels][kMaxState];     // each channel's state in
  __shared__ float a2s[kChannels][kMaxState];       // A * log2 e of the item
  float* bs = reinterpret_cast<float*>(smem + 2 * St::kBytes);
  float* cs = bs + kMaxState * kSlots;
  const int w = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int r = lane % kRuns, cl = w * kChPerWarp + lane / kRuns;   // run, item channel
  const int tile = kRuns * p.lr;
  const int ntiles = (p.S + tile - 1) / tile;
  const int nd = (p.di + kChannels - 1) / kChannels;
  const long long items = (long long)nd * p.B;
  // this block's items: a contiguous range
  const int first = (int)(blockIdx.x * items / gridDim.x);
  const int jobs = ((int)((blockIdx.x + 1) * items / gridDim.x) - first) * ntiles;
  if (jobs <= 0) return;
  auto item_of = [&](int j) { return first + j / ntiles; };

  load_tile<T>(smem, p, item_of(0) / nd, item_of(0) % nd * kChannels, 0);
  cp_async_commit();
  float dsk = 0.f;
  for (int j = 0; j < jobs; ++j) {
    const int item = item_of(j), k = j % ntiles;
    const int bat = item / nd, d0 = item % nd * kChannels, d = d0 + cl;
    const bool active = d < p.di;
    unsigned char* stage = smem + (j & 1) * St::kBytes;
    if (j + 1 < jobs) {         // the next job's tile into the other stage
      const int nx = item_of(j + 1);
      load_tile<T>(smem + ((j + 1) & 1) * St::kBytes, p, nx / nd, nx % nd * kChannels,
                   (j + 1) % ntiles * tile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();            // the tile has landed

    if (k == 0) {               // a new item: this warp's channels' h0, A and D
      if (lane < kMaxState) {
        for (int c = 0; c < kChPerWarp; ++c) {
          const int ci = w * kChPerWarp + c;
          const bool on = d0 + ci < p.di && lane < p.st;
          const float* sh0 = reinterpret_cast<const float*>(stage + St::kH0Off);
          const float* sA = reinterpret_cast<const float*>(stage + St::kAOff);
          carry[ci][lane] = on ? sh0[ci * p.st + lane] : 0.f;
          a2s[ci][lane] = on ? sA[ci * p.st + lane] * kLog2e : 0.f;
        }
      }
      dsk = active ? to_f32(reinterpret_cast<const T*>(stage + St::kDOff)[cl]) : 0.f;
    }
    // b, c to f32 rows by state: a thread reads V states of one step (16
    // bytes) and writes them to V rows, neighbouring threads neighbouring steps
    const int nchunks = (p.st + V - 1) / V;
    for (int i = threadIdx.x; i < 2 * nchunks * kSlots; i += kThreads) {
      const int slot = i % kSlots, ch = i / kSlots % nchunks, which = i / (kSlots * nchunks);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          stage + St::kBOff + which * St::kBCBytes + (slot * kMaxState + ch * V) * sizeof(T));
      const T* e = reinterpret_cast<const T*>(&raw);
      float* row = (which ? cs : bs) + ch * V * kSlots +
                   bc_pos(slot / kLaneSteps, slot % kLaneSteps);
#pragma unroll
      for (int q = 0; q < V; ++q) row[q * kSlots] = to_f32(e[q]);
    }
    // this lane's run of its channel
    float dtv[kLaneSteps], dtu[kLaneSteps], yv[kLaneSteps];
    float dtsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kLaneSteps; ++jj) {
      const int off = St::u_off(r * kLaneSteps + jj) + cl * (int)sizeof(T);
      const float uu = to_f32(*reinterpret_cast<const T*>(stage + off));
      dtv[jj] = to_f32(*reinterpret_cast<const T*>(stage + St::kUBytes + off));
      dtu[jj] = dtv[jj] * uu;
      yv[jj] = uu * dsk;        // y = D u + sum_s h c
      if (jj < p.lr) dtsum += dtv[jj];
    }
    __syncthreads();            // bs, cs and the item's states are in place

    if (p.lr == kLaneSteps)
      scan_states<true>(dtv, dtu, yv, dtsum, bs, cs, a2s[cl], carry[cl], p.st, p.lr, r);
    else
      scan_states<false>(dtv, dtu, yv, dtsum, bs, cs, a2s[cl], carry[cl], p.st, p.lr, r);

    // y over this lane's u slots, then out in 16-byte pieces
#pragma unroll
    for (int jj = 0; jj < kLaneSteps; ++jj) {
      if (jj < p.lr)
        *reinterpret_cast<T*>(stage + St::u_off(r * kLaneSteps + jj) + cl * (int)sizeof(T)) =
            from_f32<T>(yv[jj]);
    }
    __syncthreads();
    T* y = static_cast<T*>(p.y);
    for (int i = threadIdx.x; i < kSlots * St::kUChunks; i += kThreads) {
      const int slot = i / St::kUChunks, ch = i % St::kUChunks;
      const int rr = slot / kLaneSteps, jj = slot % kLaneSteps;
      const int t = k * tile + rr * p.lr + jj;
      const int dd = d0 + ch * V;
      if (jj >= p.lr || t >= p.S || dd >= p.di) continue;
      const unsigned char* src = stage + St::u_off(slot) + ch * 16;
      const long long g = ((long long)bat * p.S + t) * p.di + dd;
      if (p.vec_u) {
        *reinterpret_cast<uint4*>(y + g) = *reinterpret_cast<const uint4*>(src);
      } else {
        const T* e = reinterpret_cast<const T*>(src);
        for (int q = 0; q < V && dd + q < p.di; ++q) y[g + q] = e[q];
      }
    }
    if (k == ntiles - 1) {      // the item's last tile: its final states
      for (int i = threadIdx.x; i < kChannels * kMaxState; i += kThreads) {
        const int ci = i / kMaxState, s = i % kMaxState;
        if (d0 + ci < p.di && s < p.st)
          p.hT[((long long)bat * p.di + d0 + ci) * p.st + s] = carry[ci][s];
      }
    }
    __syncthreads();            // the stage, bs, cs and carry are free again
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)2 * Stage<T>::kBytes + 2 * kMaxState * kSlots * sizeof(float);
}

template <typename T>
cudaError_t launch(Args p, cudaStream_t stream) {
  constexpr int V = Stage<T>::kVec;
  constexpr long long E = sizeof(T);
  p.lr = p.S < kSlots ? (p.S + kRuns - 1) / kRuns : kLaneSteps;
  p.vec_u = p.di % V == 0 && aligned16(p.u) && aligned16(p.dt) && aligned16(p.y);
  p.vec_bc = p.st % V == 0 && (p.b_sb * E) % 16 == 0 && (p.b_ss * E) % 16 == 0 &&
             (p.c_sb * E) % 16 == 0 && (p.c_ss * E) % 16 == 0 && aligned16(p.b) &&
             aligned16(p.c);
  // a trial's A rows start di * st floats apart and its D row di elements
  // apart: 16-byte pieces need both to keep the base's alignment
  p.vec_state = (long long)p.di * p.st % 4 == 0 && aligned16(p.h0) && aligned16(p.A) &&
                aligned16(p.dskip) && (p.rows_per_a == 0 || p.di * E % 16 == 0);
  auto kern = scan_prefill_kernel<T>;
  constexpr int smem = (int)smem_bytes<T>();
  // blocks one wave holds, read once a device (0: not yet)
  static std::atomic<int> wave[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (wave[dev].load() == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return e;
    wave[dev].store(sms * (per_sm > 0 ? per_sm : 1));
  }
  const long long slots = wave[dev].load();
  const long long items = (long long)((p.di + kChannels - 1) / kChannels) * p.B;
  const int grid = (int)(items < slots ? items : slots);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Arguments as selective_scan_launch (csrc/selective_scan.cu); S >= 1.
extern "C" int selective_scan_prefill_launch(
    const void* u, const void* dt, const void* A, const void* b, const void* c,
    const void* dskip, const void* h0, void* y, void* hT, int B, int S, int di,
    int st, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long rows_per_a, int dtype, void* stream) {
  if (st < 1 || st > kMaxState || S < 1) return cudaErrorInvalidValue;
  if (rows_per_a < 0 || (rows_per_a && B % rows_per_a)) return cudaErrorInvalidValue;
  if (B == 0 || di == 0) return 0;
  Args p{u, dt, static_cast<const float*>(A), b, c, dskip, static_cast<const float*>(h0),
         y, static_cast<float*>(hT), B, S, di, st, 0, b_sb, b_ss, c_sb, c_ss, rows_per_a,
         false, false, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// The kernel for dtype (ReproDtype): kernel_attrs' out[0..2], then in out[3]
// the dynamic shared memory its launch asks for.
extern "C" int selective_scan_prefill_attrs(int dtype, int* out) {
  if (dtype == kFloat32) {
    out[3] = (int)smem_bytes<float>();
    return kernel_attrs(scan_prefill_kernel<float>, out);
  }
  if (dtype == kBFloat16) {
    out[3] = (int)smem_bytes<__nv_bfloat16>();
    return kernel_attrs(scan_prefill_kernel<__nv_bfloat16>, out);
  }
  return cudaErrorInvalidValue;
}
