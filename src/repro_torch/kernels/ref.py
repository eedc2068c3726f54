"""Plain PyTorch versions of the kernels: the CPU path of each wrapper,
and what `chip_smoke.py` holds each kernel against on the card.

Dtype contract (as the JAX package's): every ref upcasts its operands to
fp32, computes in fp32, and stores each output in the corresponding
input's dtype.  The ops run one by one in the JAX reference's order, so
at fp32 on the CPU the result is bitwise the JAX package's eager
``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def sophia_update_ref(theta, m, h, g, h_hat, do_h, *, lr, beta1, beta2,
                      rho, eps, weight_decay):
    """Reference semantics of the fused Sophia update.  Returns
    ``(theta, m, h)`` in their input dtypes.

    ``(1.0 - beta1)`` and ``(1.0 - beta2)`` are Python doubles rounded
    to fp32 once; the decay is ``(lr * weight_decay)`` in fp32, then
    ``* theta``; ``clamp`` propagates NaN as ``jnp.maximum`` /
    ``jnp.clip`` do."""
    out_dt = (theta.dtype, m.dtype, h.dtype)
    do_h = torch.as_tensor(do_h, dtype=torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    theta, m, h, g, h_hat = (x.to(torch.float32)
                             for x in (theta, m, h, g, h_hat))
    m = beta1 * m + (1.0 - beta1) * g                              # Eq. 9
    h_new = beta2 * h + (1.0 - beta2) * h_hat                      # Eq. 10
    h = do_h * h_new + (1.0 - do_h) * h
    theta = theta - lr * weight_decay * theta                      # line 15
    step = torch.clamp(m / torch.clamp(h, min=eps), -rho, rho)     # Eq. 11
    return ((theta - lr * step).to(out_dt[0]), m.to(out_dt[1]),    # line 16
            h.to(out_dt[2]))


def quant_roundtrip_ref(x, noise, scale, *, qmax):
    """Per-row-scale stochastic quantize then dequantize, in ``x``'s
    dtype: ``clip(floor(x / safe + u), -qmax, qmax) * scale`` with
    ``safe = scale`` where positive, else 1.  ``scale`` broadcasts
    against ``x`` (``(..., R, 1)``); noise and scale are fp32."""
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.floor(x.to(torch.float32) / safe + noise),
                    -qmax, qmax)
    return (q * scale).to(x.dtype)


def uplink_roundtrip_ref(theta, start, ef, noise, scale, *, qmax):
    """EF-corrected uplink delta ``d = (theta - start) + ef``, its quant
    round-trip ``xhat`` and the new residual ``d - xhat``; both outputs
    in theta's dtype.  ``start`` may be one ``(R, C)`` model shared by
    every client of a ``(N, R, C)`` stack."""
    d = (theta.to(torch.float32) - start.to(torch.float32)) \
        + ef.to(torch.float32)
    xhat = quant_roundtrip_ref(d, noise, scale, qmax=qmax)
    return xhat.to(theta.dtype), (d - xhat).to(theta.dtype)


def broadcast_roundtrip_ref(theta, ref, ef, noise, scale, *, qmax):
    """Delta-coded broadcast: ``d = (theta - ref) + ef``, quant
    round-trip ``xhat``; returns the new replica ``ref + xhat`` and the
    new residual ``d - xhat``, both in theta's dtype.  ``theta`` may be
    the one ``(R, C)`` server model shared by a ``(N, R, C)`` stack."""
    r = ref.to(torch.float32)
    d = (theta.to(torch.float32) - r) + ef.to(torch.float32)
    xhat = quant_roundtrip_ref(d, noise, scale, qmax=qmax)
    return (r + xhat).to(theta.dtype), (d - xhat).to(theta.dtype)
