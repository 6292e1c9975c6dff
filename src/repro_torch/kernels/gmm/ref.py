"""Plain PyTorch grouped matmul: the CPU path and the kernels' yardstick, and
the plain twin of the tiled kernel's block schedule."""
import torch

# the tiled kernel's output tile and K step (kBM, kBN, kBK in csrc/gmm_prefill.cu)
TILE_M, TILE_N, TILE_K = 128, 128, 32


def gmm_ref(x, w, group_sizes):
    """x: (T, D) rows sorted by group; w: (E, D, F); group_sizes: (E,) int.

    One ``x[rows_e] @ w[e]`` per group in f32, output in x's dtype; rows past
    the last group are zero (as ``lax.ragged_dot`` gives them). Reads the
    group sizes on the host, so it is no path for the card.
    """
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    r0 = 0
    for e, g in enumerate(group_sizes.tolist()):
        if g:
            out[r0:r0 + g] = (x[r0:r0 + g].float() @ w[e].float()).to(x.dtype)
        r0 += g
    return out


def grid_rows(T, E):
    """The x-extent of the tiled kernel's grid: an upper bound on its row
    tiles from shapes alone (``csrc/gmm.cuh::grid_rows``)."""
    return -(-T // TILE_M) + E + 1


def tile_map(sizes, T):
    """The tiled kernel's block schedule (``csrc/gmm.cuh::block_tile`` with
    TILE_M-row tiles), walked on the host: for each x-index of the grid, the
    (group, first row, rows) its block computes, with group -1 for rows past
    the last group (output zero), or None for a block past the real tile
    count, which exits."""
    bm = TILE_M
    sizes = [max(int(g), 0) for g in sizes]
    tiles = []
    for bx in range(grid_rows(T, len(sizes))):
        tile, tile_base, row_base = None, 0, 0
        for e, g in enumerate(sizes):
            n = -(-g // bm)
            if tile_base <= bx < tile_base + n:
                r0 = row_base + (bx - tile_base) * bm
                tile = (e, r0, min(row_base + g, r0 + bm))
            tile_base += n
            row_base += g
        if tile is None and bx >= tile_base and row_base < T:
            r0 = row_base + (bx - tile_base) * bm
            if r0 < T:
                tile = (-1, r0, min(r0 + bm, T))
        rows = 0 if tile is None else min(tile[2], T) - min(tile[1], T)
        tiles.append((tile[0], min(tile[1], T), rows) if rows > 0 else None)
    return tiles


def gmm_tiled_ref(x, w, group_sizes):
    """``gmm_ref`` computed the way the tiled kernel (``csrc/gmm_prefill.cu``)
    walks it: ``tile_map``'s row tiles by TILE_N-column tiles, each a sum
    over K steps of TILE_K in f32 from an A tile whose rows outside the group
    are zero, rounded to x's dtype once, and only the tile's own rows
    stored. Every output row is written by exactly one tile: a row no tile
    covers stays NaN."""
    bm, bn, bk = TILE_M, TILE_N, TILE_K
    T, D = x.shape
    F = w.shape[-1]
    out = torch.full((T, F), float("nan"), dtype=x.dtype, device=x.device)
    for tile in tile_map(group_sizes.tolist(), T):
        if tile is None:
            continue
        e, r0, rows = tile
        a = torch.zeros((bm, D), dtype=torch.float32, device=x.device)
        if e >= 0:
            a[:rows] = x[r0:r0 + rows].float()
        for n0 in range(0, F, bn):
            acc = torch.zeros((bm, min(bn, F - n0)), dtype=torch.float32, device=x.device)
            if e >= 0:
                for k0 in range(0, D, bk):
                    acc += a[:, k0:k0 + bk] @ w[e, k0:k0 + bk, n0:n0 + bn].float()
            out[r0:r0 + rows, n0:n0 + bn] = acc[:rows].to(x.dtype)
    return out
