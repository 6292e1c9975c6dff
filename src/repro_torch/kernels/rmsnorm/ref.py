"""Plain PyTorch RMSNorm: the CPU path and the kernel's yardstick."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_slots_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x: (S, ..., D), scale: (S, D): slot s's rows scaled by ``scale[s]``."""
    return rmsnorm_ref(x, scale.view(scale.shape[:1] + (1,) * (x.dim() - 2) + scale.shape[1:]),
                       eps)
