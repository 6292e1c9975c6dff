"""Plain PyTorch grouped matmul: the CPU path and the kernel's yardstick."""
import torch


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
