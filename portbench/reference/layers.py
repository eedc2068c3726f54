"""Float32 pieces the archs' references share: TF32 off, RMSNorm, RoPE
and causal softmax attention."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over the last axis of ``x (B, S, H, r)`` at positions 0..S-1:
    frequencies ``theta^(-i / (r/2))``, the first half rotated against
    the second."""
    S, r = x.shape[1], x.shape[-1]
    half = r // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention: ``q, k (B, S, H, dk)``, ``v (B, S, H, dv)``."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
