"""The A3C/GA3C DNN (Mnih et al. 2016, scaled to the grid observations; port
of ``repro/rl/network.py``): two conv layers + one fully-connected layer,
with a policy softmax head and a linear value head.

Precision: the whole RL path computes in full f32 on every device. Each
convolution is a copy of its windows and one f32 matmul, not cuDNN: cuDNN's
f32 convolutions round to TF32 unless the process-global
``torch.backends.cudnn.allow_tf32`` is cleared, a flag that every other path
and every trial thread shares, and its weight-gradient algorithms may sum
with atomics. The matmuls follow ``torch.backends.cuda.matmul.allow_tf32``,
off by default and never set by the port, so the forward and backward are
f32 and repeat bit for bit.

``apply_net_slots`` runs S trials' nets at once for the population engine:
each weight stacked on a leading slot axis, each layer one batched matmul
(``baddbmm``, which follows the same flag) over the same window copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class A3CNetConfig:
    grid: int = 16
    frames: int = 2
    n_actions: int = 4
    c1: int = 16
    c2: int = 32
    fc: int = 128


def _conv_out(g, k, s):
    return (g - k) // s + 1


def param_shapes(cfg: A3CNetConfig) -> dict:
    """Each weight's shape, named as the reference's leaves. Convolutions are
    OIHW, as the reference's; the linear weights are (out, in), the
    transpose of the reference's (in, out) leaves, as ``F.linear`` takes
    them."""
    g2 = _conv_out(_conv_out(cfg.grid, 4, 2), 3, 1)
    flat = cfg.c2 * g2 * g2
    return {"c1w": (cfg.c1, cfg.frames, 4, 4), "c1b": (cfg.c1,),
            "c2w": (cfg.c2, cfg.c1, 3, 3), "c2b": (cfg.c2,),
            "fcw": (cfg.fc, flat), "fcb": (cfg.fc,),
            "pw": (cfg.n_actions, cfg.fc), "pb": (cfg.n_actions,),
            "vw": (1, cfg.fc), "vb": (1,)}


LINEAR = ("fcw", "pw", "vw")


def _conv(x, w, b, stride):
    """VALID convolution, NCHW by OIHW: the k x k windows as a strided view
    (``Tensor.unfold``), one copy into rows and one matmul with the bias.
    Returns an NCHW view of NHWC memory."""
    n, c, h, _ = x.shape
    o, _, k, _ = w.shape
    g = _conv_out(h, k, stride)
    win = x.unfold(2, k, stride).unfold(3, k, stride)       # (n, c, g, g, k, k)
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(n * g * g, c * k * k)
    return torch.addmm(b, cols, w.reshape(o, -1).t()).view(n, g, g, o).permute(0, 3, 1, 2)


class A3CNet(nn.Module):
    """``forward(obs (B, frames, G, G)) -> (logits (B, A), value (B,))``.

    ``gen`` draws the reference's He init (``pw`` scaled by 0.01, biases
    zero) on its own device; without one the weights are zeros on
    ``device``, for ``models/convert.py`` to fill."""

    def __init__(self, cfg: A3CNetConfig, gen: torch.Generator = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = gen.device if gen is not None else resolve_device(device)
        for name, shape in param_shapes(cfg).items():
            if gen is None or name.endswith("b"):
                t = torch.zeros(shape, device=dev)
            else:
                fan_in = math.prod(shape[1:])
                t = torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)
                if name == "pw":
                    t = t * 0.01
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, obs):
        return apply_net(self._parameters, obs)


def apply_net(params, obs):
    """``A3CNet.forward`` on a mapping of ``param_shapes``' names to weights:
    ``obs (B, frames, G, G) -> (logits (B, A), value (B,))``."""
    x = obs.float()
    x = F.relu(_conv(x, params["c1w"], params["c1b"], 2))
    x = F.relu(_conv(x, params["c2w"], params["c2b"], 1))
    x = F.relu(F.linear(x.flatten(1), params["fcw"], params["fcb"]))
    return F.linear(x, params["pw"], params["pb"]), F.linear(x, params["vw"], params["vb"])[:, 0]


def _conv_slots(x, w, b, stride):
    """``_conv`` over a leading slot axis of S weight sets: x (S·N, C, H, W)
    holds slot s's N inputs at rows s·N to (s+1)·N, w is (S, O, C, k, k), b
    (S, O). The same copy of the windows, then one ``baddbmm`` for every
    slot in place of ``addmm``."""
    s, o, _, k, _ = w.shape
    sn, c, h, _ = x.shape
    g = _conv_out(h, k, stride)
    win = x.unfold(2, k, stride).unfold(3, k, stride)       # (S·N, c, g, g, k, k)
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(s, sn // s * g * g, c * k * k)
    out = torch.baddbmm(b[:, None], cols, w.reshape(s, o, -1).transpose(1, 2))
    return out.view(sn, g, g, o).permute(0, 3, 1, 2)


def _linear_slots(x, w, b):
    """x (S, N, in) by w (S, out, in) plus b (S, out): ``F.linear`` a slot."""
    return torch.baddbmm(b[:, None], x, w.transpose(1, 2))


def apply_net_slots(params, obs):
    """``apply_net`` for S trials at once: every weight carries a leading
    slot axis (``(S,) + param_shapes[name]``) and ``obs (S, N, frames, G,
    G) -> (logits (S, N, A), value (S, N))``, slot s's inputs through slot
    s's weights. Each layer is one batched matmul whatever S is; a slot's
    numbers are its own (``bmm`` may sum in another order than ``addmm``)."""
    s, n = obs.shape[:2]
    x = obs.float().flatten(0, 1)
    x = F.relu(_conv_slots(x, params["c1w"], params["c1b"], 2))
    x = F.relu(_conv_slots(x, params["c2w"], params["c2b"], 1))
    x = F.relu(_linear_slots(x.reshape(s, n, -1), params["fcw"], params["fcb"]))
    return (_linear_slots(x, params["pw"], params["pb"]),
            _linear_slots(x, params["vw"], params["vb"])[..., 0])
