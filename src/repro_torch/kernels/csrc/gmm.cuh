// The device-side group map shared by the grouped-matmul kernels (gmm.cu,
// gmm_prefill.cu). Rows of x are sorted by group; every group is cut into
// ceil(size / BM) row tiles in group order, and the rows past the last group
// into more BM-row tiles whose output is zero. A block maps its x-index to
// one such tile by reading group_sizes (a device tensor) itself, so a launch
// never waits on the host: warp 0 takes an exclusive prefix of the sizes and
// of their tile counts with shuffles. The grid's x-extent
// ceil(T / BM) + E + 1 bounds the tile count from above, from shapes alone;
// blocks past the real count get no tile and exit.
#pragma once
#include "common.cuh"

namespace gmm {

struct Tile {
  int group;   // >= 0: a group's rows; -1: rows past the last group (output 0)
  int r0;      // first row
  int rows;    // rows of the tile, 1..BM; 0 when the block has no tile
};

template <int BM>
__host__ __device__ constexpr int grid_rows(int Tn, int E) {
  return (Tn + BM - 1) / BM + E + 1;
}

// Every thread of the block calls it; it holds two __syncthreads.
template <int BM>
__device__ __forceinline__ Tile block_tile(const int* __restrict__ gs, int Tn, int E, int bx) {
  __shared__ int s_group, s_r0, s_r1;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_group = -2;        // -2: no tile
  __syncthreads();
  if (threadIdx.x < 32) {
    int tile_base = 0, row_base = 0;
    for (int c0 = 0; c0 < E; c0 += 32) {
      const int g = c0 + lane < E ? max(gs[c0 + lane], 0) : 0;
      const int tiles = (g + BM - 1) / BM;
      int gi = g, ti = tiles;        // inclusive prefix over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int gn = __shfl_up_sync(0xffffffffu, gi, off);
        const int tn = __shfl_up_sync(0xffffffffu, ti, off);
        if (lane >= off) { gi += gn; ti += tn; }
      }
      const int t0 = tile_base + ti - tiles, r0 = row_base + gi - g;
      if (bx >= t0 && bx < t0 + tiles) {     // at most one lane
        s_group = c0 + lane;
        s_r0 = r0 + (bx - t0) * BM;
        s_r1 = min(r0 + g, s_r0 + BM);
      }
      tile_base += __shfl_sync(0xffffffffu, ti, 31);
      row_base += __shfl_sync(0xffffffffu, gi, 31);
    }
    if (lane == 0 && bx >= tile_base && row_base < Tn) {
      const int r0 = row_base + (bx - tile_base) * BM;
      if (r0 < Tn) { s_group = -1; s_r0 = r0; s_r1 = min(r0 + BM, Tn); }
    }
  }
  __syncthreads();
  Tile t{s_group, 0, 0};
  if (t.group != -2) {
    t.r0 = min(s_r0, Tn);
    t.rows = max(min(s_r1, Tn) - t.r0, 0);
  }
  return t;
}

}  // namespace gmm
