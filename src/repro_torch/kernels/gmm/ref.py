"""Plain PyTorch grouped matmul: the CPU path and the kernels' yardstick, and
the plain twins of the tiled and the decode kernel's block schedules."""
import torch

# the tiled kernel's output tile and K step (kBM, kBN, kBK in csrc/gmm_prefill.cu)
TILE_M, TILE_N, TILE_K = 128, 128, 32
# the decode kernel's slot rows, column tile and K step (kRows, kBN, kBK in
# csrc/gmm_decode.cu)
DECODE_ROWS, DECODE_N, DECODE_K = 16, 128, 64


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


def grid_rows(T, E, bm=TILE_M):
    """The x-extent of a kernel's grid with ``bm``-row tiles: an upper bound
    on its row tiles from shapes alone (``csrc/gmm.cuh::grid_rows``)."""
    return -(-T // bm) + E + 1


def tile_map(sizes, T, bm=TILE_M):
    """A kernel's block schedule (``csrc/gmm.cuh::block_tile`` with
    ``bm``-row tiles: TILE_M for the tiled kernel, DECODE_ROWS for the
    decode kernel's slots), walked on the host: for each x-index of the
    grid, the (group, first row, rows) its block computes, with group -1
    for rows past the last group (output zero), or None for a block past
    the real tile count, which exits."""
    sizes = [max(int(g), 0) for g in sizes]
    tiles = []
    for bx in range(grid_rows(T, len(sizes), bm)):
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


def _walk_tiles(x, w, group_sizes, bm, bn, bk):
    """``gmm_ref`` computed tile by tile: ``tile_map``'s ``bm``-row tiles by
    ``bn``-column tiles, each a sum over K steps of ``bk`` in f32, rounded
    to x's dtype once, with only the tile's own rows stored. A row no tile
    covers stays NaN."""
    T, D = x.shape
    F = w.shape[-1]
    out = torch.full((T, F), float("nan"), dtype=x.dtype, device=x.device)
    for tile in tile_map(group_sizes.tolist(), T, bm):
        if tile is None:
            continue
        e, r0, rows = tile
        a = x[r0:r0 + rows].float()
        for n0 in range(0, F, bn):
            acc = torch.zeros((rows, min(bn, F - n0)), dtype=torch.float32, device=x.device)
            if e >= 0:
                for k0 in range(0, D, bk):
                    acc += a[:, k0:k0 + bk] @ w[e, k0:k0 + bk, n0:n0 + bn].float()
            out[r0:r0 + rows, n0:n0 + bn] = acc.to(x.dtype)
    return out


def gmm_tiled_ref(x, w, group_sizes):
    """``gmm_ref`` computed the way the tiled kernel (``csrc/gmm_prefill.cu``)
    walks it: TILE_M-row tiles by TILE_N-column tiles, K steps of TILE_K.
    Every output row is written by exactly one tile: a row no tile covers
    stays NaN."""
    return _walk_tiles(x, w, group_sizes, TILE_M, TILE_N, TILE_K)


def gmm_decode_ref(x, w, group_sizes):
    """``gmm_ref`` computed the way the decode kernel (``csrc/gmm_decode.cu``)
    walks it: slots of DECODE_ROWS rows by DECODE_N-column tiles, K steps of
    DECODE_K, each slot's sums rounded once. The kernel multiplies the
    transpose, out^T = w^T x^T; the sums are the same. A row no slot covers
    stays NaN. For the tests; the main path never calls it."""
    return _walk_tiles(x, w, group_sizes, DECODE_ROWS, DECODE_N, DECODE_K)
