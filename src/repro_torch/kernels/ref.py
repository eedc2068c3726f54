"""Plain PyTorch versions of the kernels: the CPU path of each wrapper,
and what `chip_smoke.py` holds each kernel against on the card.

Dtype contract (as the JAX package's): every ref upcasts its operands to
fp32, computes in fp32, and stores each output in the corresponding
input's dtype by `store_as`.  The ops run one by one in the JAX
reference's order, so at fp32 on the CPU the result is bitwise the JAX
package's eager ``kernels/ref.py``.

`dtype_steps` and `outside_band` hold two runs' narrow resident buffers
to a few steps of their dtype: the one band rule of the tests and of
`chip_smoke.py`.
"""
from __future__ import annotations

import torch

#: e4m3's overflow bound: ml_dtypes (the JAX package's fp8 type) rounds
#: magnitudes up to it to at most 448 and stores NaN past it, as the
#: kernels do (``csrc/dtype_io.cuh``)
E4M3_OVERFLOW = 464.0


def store_as(x, dtype):
    """``x`` stored in ``dtype`` by ml_dtypes' rule, as the JAX package
    stores it: round to nearest even; NaN stays NaN.  For e4m3, NaN with
    x's sign past +-464 and for +-inf: those values are masked before
    ``Tensor.to``, which saturates them to +-448 in some torch versions
    and not in others.  bf16 and e5m2 by ``Tensor.to``; ``x`` itself
    when it is already stored as ``dtype``."""
    if x.dtype == dtype:
        return x
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > E4M3_OVERFLOW,
                        torch.copysign(torch.full_like(x, float("nan")), x),
                        x)
    return x.to(dtype)


#: integer view and magnitude bits of each narrow resident dtype
_ORDINAL = {torch.bfloat16: (torch.int16, 0x7FFF),
            torch.float8_e4m3fn: (torch.uint8, 0x7F),
            torch.float8_e5m2: (torch.uint8, 0x7F)}


def dtype_steps(a, b):
    """Elementwise, how many steps of their narrow dtype ``a`` and ``b``
    lie apart: the distance of their ordinals (sign and magnitude bits,
    +0 and -0 one value), as int32 on ``a``'s device."""
    assert a.dtype == b.dtype and a.dtype in _ORDINAL, (a.dtype, b.dtype)
    view, mag = _ORDINAL[a.dtype]

    def ordinal(x):
        bits = x.contiguous().view(view).to(torch.int32)
        m = bits & mag
        return torch.where(bits != m, -m, m)
    return (ordinal(a) - ordinal(b.to(a.device))).abs()


#: narrow dtype -> (steps, outlier steps): how far apart two runs of one
#: round may leave a narrow resident buffer whose fp32 arithmetic differs
#: in the last ulps (another summation order, another device): each
#: coordinate within ``steps`` of its dtype, a few within ``outlier
#: steps`` (an EMA whose terms cancel carries a step of the larger term
#: into several of the smaller result's).  Measured in
#: tests/test_torch_residency.py and by chip_smoke.py.
NARROW_STEPS = {torch.bfloat16: (2, 4), torch.float8_e4m3fn: (1, 2),
                torch.float8_e5m2: (1, 2)}


def outside_band(got, want, *, rtol, atol, outliers=False):
    """Coordinates of ``got`` outside the band around ``want``: more
    than ``atol + rtol * |want|`` apart in fp32 and, for a narrow dtype,
    more than its `NARROW_STEPS` steps (the outlier steps with
    ``outliers``) apart.  A bool tensor on ``got``'s device."""
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    want = want.to(got.device)
    x, y = got.float(), want.float()
    out = ~((x - y).abs() <= atol + rtol * y.abs())
    if got.dtype in NARROW_STEPS:
        out &= dtype_steps(got, want) > NARROW_STEPS[got.dtype][int(outliers)]
    return out


#: coordinates of one buffer that may lie out to the outlier steps
MAX_OUTLIERS = 16


def band_breach(got, want, *, rtol, atol):
    """Why a whole buffer ``got`` is outside the band around ``want``
    (a coordinate past the outlier steps, or more than `MAX_OUTLIERS`
    past the steps), or None when it is within it."""
    far = int(outside_band(got, want, rtol=rtol, atol=atol,
                           outliers=True).sum())
    out = int(outside_band(got, want, rtol=rtol, atol=atol).sum())
    if far or out > MAX_OUTLIERS:
        return (f"{out} coordinates past the band, {far} past its "
                f"outliers' ({got.dtype}, {MAX_OUTLIERS} outliers allowed)")
    return None


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
    return (store_as(theta - lr * step, out_dt[0]),               # line 16
            store_as(m, out_dt[1]), store_as(h, out_dt[2]))


def quant_roundtrip_ref(x, noise, scale, *, qmax):
    """Per-row-scale stochastic quantize then dequantize, in ``x``'s
    dtype: ``clip(floor(x / safe + u), -qmax, qmax) * scale`` with
    ``safe = scale`` where positive, else 1.  ``scale`` broadcasts
    against ``x`` (``(..., R, 1)``); noise and scale are fp32."""
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.floor(x.to(torch.float32) / safe + noise),
                    -qmax, qmax)
    return store_as(q * scale, x.dtype)


def uplink_roundtrip_ref(theta, start, ef, noise, scale, *, qmax):
    """EF-corrected uplink delta ``d = (theta - start) + ef``, its quant
    round-trip ``xhat`` and the new residual ``d - xhat``; both outputs
    in theta's dtype.  ``start`` may be one ``(R, C)`` model shared by
    every client of a ``(N, R, C)`` stack."""
    d = (theta.to(torch.float32) - start.to(torch.float32)) \
        + ef.to(torch.float32)
    xhat = quant_roundtrip_ref(d, noise, scale, qmax=qmax)
    return store_as(xhat, theta.dtype), store_as(d - xhat, theta.dtype)


def broadcast_roundtrip_ref(theta, ref, ef, noise, scale, *, qmax):
    """Delta-coded broadcast: ``d = (theta - ref) + ef``, quant
    round-trip ``xhat``; returns the new replica ``ref + xhat`` and the
    new residual ``d - xhat``, both in theta's dtype.  ``theta`` may be
    the one ``(R, C)`` server model shared by a ``(N, R, C)`` stack."""
    r = ref.to(torch.float32)
    d = (theta.to(torch.float32) - r) + ef.to(torch.float32)
    xhat = quant_roundtrip_ref(d, noise, scale, qmax=qmax)
    return (store_as(r + xhat, theta.dtype),
            store_as(d - xhat, theta.dtype))


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
    return store_as(_per_client(scale, x) * sign(x.to(torch.float32)),
                    x.dtype)


def topk_threshold_ref(x, thr):
    """Magnitude sparsifier in x's dtype: the fp32 upcast of x where
    ``|x| >= thr``, 0 elsewhere (NaN compares false and becomes 0);
    ``thr`` a scalar, or ``(N,)`` per client."""
    xf = x.to(torch.float32)
    return store_as(torch.where(xf.abs() >= _per_client(thr, x), xf, 0.0),
                    x.dtype)


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
