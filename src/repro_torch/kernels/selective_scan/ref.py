"""Plain PyTorch selective scan: the CPU path and the kernel's yardstick."""
import torch


def selective_scan_ref(u, dt, a, b, c, d_skip, h0):
    """Sequential scan over S (port of ``repro/models/ssm.py::selective_scan_ref``).

    u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st). The state is f32; returns y (B, S, di) in u's dtype and
    hT (B, di, st) f32.
    """
    uf, dtf, bf, cf = u.float(), dt.float(), b.float(), c.float()
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * a)                   # (B, di, st)
        h = da * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cf[:, t]))
    y = torch.stack(ys, 1) + uf * d_skip
    return y.to(u.dtype), h
