"""PyTorch / CUDA twin of `repro` on one NVIDIA H100: the Fed-Sophia
rounds (direct and compressed), the virtual-time scheduler and the
adversarial fleet, with every Pallas kernel of the JAX package as a
hand-written CUDA kernel for ``sm_90a``.

The package imports torch, numpy and the standard library only — never
JAX and nothing of the `repro` package.  Module names mirror `repro`'s,
so the counterpart of ``repro.core.fed`` is ``repro_torch.core.fed``.

Every entry point takes ``device=None``, which means ``"cuda"``; it
raises when no card is present unless the caller asks for the CPU
(``device="cpu"``), where each kernel wrapper runs its plain PyTorch
version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises on a CUDA device when no card is
    present: there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda or "
                         "cpu)")
    return dev
