"""Plain PyTorch selective scan: the CPU path and the kernel's yardstick."""
import torch


def selective_scan_ref(u, dt, a, b, c, d_skip, h0):
    """Sequential scan over S (port of ``repro/models/ssm.py::selective_scan_ref``).

    u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st). The state is f32 (f64 where u is f64: the exact scan
    that ``chip_smoke.py`` and the card's tests hold the prefill kernel to);
    returns y (B, S, di) in u's dtype and hT (B, di, st) in the state's.
    """
    return _scan(u, dt, a, b, c, d_skip, h0)


def selective_scan_slots_ref(u, dt, a, b, c, d_skip, h0):
    """``selective_scan_ref`` of S trials at once, the reference's scan under
    ``jax.vmap`` over a population's slots: u, dt (S*B, T, di), b, c (S*B, T,
    st), h0 (S*B, di, st), each group of B consecutive rows one slot's; a
    (S, di, st) f32 and d_skip (S, di), one row a slot. Returns y (S*B, T,
    di) and hT (S*B, di, st), as ``selective_scan_ref``."""
    rows = u.shape[0] // a.shape[0]
    return _scan(u, dt, a.repeat_interleave(rows, 0), b, c,
                 d_skip.repeat_interleave(rows, 0)[:, None], h0)


def _scan(u, dt, a, b, c, d_skip, h0):
    """The recurrence, with ``a`` broadcasting against (B, di, st) and
    ``d_skip`` against (B, S, di)."""
    ct = torch.float64 if u.dtype == torch.float64 else torch.float32
    uf, dtf, bf, cf = u.to(ct), dt.to(ct), b.to(ct), c.to(ct)
    a, h = a.to(ct), h0.to(ct)
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * a)                   # (B, di, st)
        h = da * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cf[:, t]))
    y = torch.stack(ys, 1) + uf * d_skip.to(ct)
    return y.to(u.dtype), h


# the prefill kernel's runs (lanes) a channel and step slots a lane (kRuns,
# kLaneSteps in csrc/scan_prefill.cu)
RUNS, LANE_STEPS = 4, 16
LOG2E = 1.4426950408889634


def lane_steps(S: int) -> int:
    """Steps each run of the prefill kernel owns: as few as cover S, at most
    ``LANE_STEPS``. A tile is ``RUNS * lane_steps(S)`` consecutive steps."""
    return min(LANE_STEPS, -(-S // RUNS))


def selective_scan_tiled(u, dt, a, b, c, d_skip, h0):
    """Plain twin of the prefill kernel (``csrc/scan_prefill.cu``): the scan
    as the kernel computes it, in the associative form of
    ``repro/models/ssm.py::selective_scan_assoc``, under
    (A, B) o (A', B') = (A'A, A'B + B') for h -> A h + B.

    The sequence is cut into tiles of ``RUNS`` runs x ``lane_steps(S)``
    steps; run r owns the r-th stretch of consecutive steps (steps past S are
    identity steps: dt = u = b = c = 0). In each tile, for every channel and
    state: each run computes ``da = exp2(dt * a * log2 e)`` once a step and
    ``bu = dt * u * b``, folds itself into one (A, B), with A = exp2(a *
    log2 e * sum of dt) in one exponential, joins an inclusive scan of the
    channel's aggregates across its runs (the steps of ``__shfl_up_sync`` by
    1, 2, ...), applies its exclusive prefix to the tile's carry-in and walks
    its steps again from that state, adding ``h * c`` into y. The carry-in is
    h0 in the first tile and after that the previous tile's inclusive (A, B)
    applied to its carry-in (not the last run's walked state: so a state's
    decay across tiles is a product of one-exponential factors). Same
    arguments and results as ``selective_scan_ref``.
    """
    B, S, di = u.shape
    uf, dtf, bf, cf = u.float(), dt.float(), b.float(), c.float()
    a2 = a.float() * LOG2E
    lr = lane_steps(S)
    tile = RUNS * lr
    carry = h0.float()
    ys = []
    for t0 in range(0, S, tile):
        n = min(tile, S - t0)

        def runs(x):            # (B, S, k) -> the tile as (B, runs, lr, k)
            part = x[:, t0:t0 + n]
            part = torch.cat([part, part.new_zeros((B, tile - n, x.shape[-1]))], 1)
            return part.reshape(B, RUNS, lr, x.shape[-1])

        dtr, ur, br, cr = runs(dtf), runs(uf), runs(bf), runs(cf)
        da = torch.exp2(dtr[..., None] * a2)                 # (B, runs, lr, di, st)
        bu = (dtr * ur)[..., None] * br[:, :, :, None, :]
        Bv = torch.zeros_like(bu[:, :, 0])
        for j in range(lr):                                  # each run's aggregate
            Bv = da[:, :, j] * Bv + bu[:, :, j]
        A = torch.exp2(dtr.sum(2)[..., None] * a2)           # (B, runs, di, st)
        off = 1
        while off < RUNS:       # inclusive scan; runs below off keep theirs
            Ap = torch.cat([torch.ones_like(A[:, :off]), A[:, :-off]], 1)
            Bp = torch.cat([torch.zeros_like(Bv[:, :off]), Bv[:, :-off]], 1)
            Bv, A = A * Bp + Bv, A * Ap
            off *= 2
        Ae = torch.cat([torch.ones_like(A[:, :1]), A[:, :-1]], 1)    # exclusive
        Be = torch.cat([torch.zeros_like(Bv[:, :1]), Bv[:, :-1]], 1)
        h = Ae * carry[:, None] + Be                         # each run's state in
        yt = []
        for j in range(lr):
            h = da[:, :, j] * h + bu[:, :, j]
            yt.append((h * cr[:, :, j, None, :]).sum(-1))    # (B, runs, di)
        carry = A[:, -1] * carry + Bv[:, -1]                 # the tile's (A, B)
        ys.append(torch.stack(yt, 2).reshape(B, tile, di)[:, :n])
    y = torch.cat(ys, 1) + uf * d_skip.float()
    return y.to(u.dtype), carry
