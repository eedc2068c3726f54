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


def _per_client(s, x):
    """Align a scalar (2D launch) or ``(N,)`` per-client (batched
    launch) fp32 scale against ``x`` for broadcasting."""
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device)
    return s.reshape(s.shape + (1,) * (x.ndim - s.ndim))


def sign(x):
    """``jnp.sign``'s semantics: NaN and +-0 pass through as they are
    (``torch.sign`` gives 0 for NaN and +0 for -0), else +-1."""
    return torch.where((x == 0) | torch.isnan(x), x,
                       torch.copysign(torch.ones_like(x), x))


def sign_roundtrip_ref(x, scale):
    """``scale * sign(x)`` in x's dtype; ``scale`` a scalar, or ``(N,)``
    per client of a ``(N, R, C)`` stack."""
    return (_per_client(scale, x) * sign(x.to(torch.float32))).to(x.dtype)


def topk_threshold_ref(x, thr):
    """Magnitude sparsifier in x's dtype: the fp32 upcast of x where
    ``|x| >= thr``, 0 elsewhere (NaN compares false and becomes 0);
    ``thr`` a scalar, or ``(N,)`` per client."""
    xf = x.to(torch.float32)
    return torch.where(xf.abs() >= _per_client(thr, x), xf, 0.0).to(x.dtype)


def stale_accum_ref(wires, weights, inv_norm):
    """Staleness-weighted accumulate of K arrival wires, fp32 out:
    ``inv_norm * (((0 + w_0*x_0) + w_1*x_1) + ...)``, the sum taken in
    ascending k as the kernel takes it.  ``wires`` ``(K, R, C)`` in any
    kernel dtype (upcast to fp32), ``weights`` ``(K,)``, ``inv_norm`` a
    scalar or a one-element tensor."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=wires.device)
    s = torch.as_tensor(inv_norm, dtype=torch.float32,
                        device=wires.device).reshape(())
    acc = torch.zeros(wires.shape[1:], dtype=torch.float32,
                      device=wires.device)
    for k in range(wires.shape[0]):
        acc = acc + w[k] * wires[k].to(torch.float32)
    return s * acc


#: the fill of removed entries in the survivor search (``-FLT_MAX``): a
#: surviving ``-inf`` loses to it, so a pass may hit a removed entry
_BIG = torch.finfo(torch.float32).max


def survivor_mask(xs, trim: int):
    """``(K, R, C)`` bool survivors of ``xs`` (fp32) after removing
    ``trim`` extremes per side per coordinate, one occurrence per pass:
    ``trim`` argmax passes over ``xs``, then ``trim`` over ``-xs``, each
    over the survivors with removed entries filled with ``-FLT_MAX``.
    ``torch.argmax`` takes the first index among equal maxima and counts
    a NaN as the maximum (the first NaN wins), as ``jnp.argmax`` does."""
    mask = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    if trim == 0:
        return mask
    iota = torch.arange(xs.shape[0], device=xs.device).reshape(
        (-1,) + (1,) * (xs.ndim - 1))
    for sign in (1.0, -1.0):
        for _ in range(trim):
            cand = torch.where(mask, sign * xs, -_BIG)
            hit = torch.argmax(cand, dim=0)
            mask = mask & (iota != hit.unsqueeze(0))
    return mask


def robust_agg_ref(wires, weights, scales, *, trim: int,
                   normalize: bool = True):
    """Sort-free trimmed / clipped weighted combine of K arrival wires,
    fp32 out.  ``xs_k = scales_k * x_k``; survivors by `survivor_mask`;
    ``num = sum_k xs_k * wm_k`` over ALL k in ascending order, with
    ``wm_k = weights_k`` for a survivor and 0 for a removed entry (so a
    removed inf or NaN still makes the sum NaN, as in the JAX package);
    ``num / sum_k wm_k`` when ``normalize``."""
    K = wires.shape[0]
    dev = wires.device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    xs = s.reshape(K, 1, 1) * wires.to(torch.float32)
    mask = survivor_mask(xs, trim)
    wm = torch.where(mask, w.reshape(K, 1, 1), 0.0)
    num = torch.zeros(wires.shape[1:], dtype=torch.float32, device=dev)
    den = torch.zeros_like(num)
    for k in range(K):
        num = num + xs[k] * wm[k]
        den = den + wm[k]
    return num / den if normalize else num
