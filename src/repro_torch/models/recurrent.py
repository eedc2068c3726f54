"""Recurrent sequence mixers of the LM zoo: the port of the JAX package's
``models/recurrent.py`` for full sequences (train): RG-LRU with its
causal depthwise conv (Griffin / recurrentgemma), the chunkwise mLSTM
and the sequential sLSTM (xLSTM).  The decode caches (``cache=``) wait
for ROADMAP queue 1 (g) 4.

The reference is plain ``jnp`` with ``lax.associative_scan`` and
``lax.scan``, and so is this port plain PyTorch: `associative_scan` is
``lax.associative_scan``'s recursion (pairs combined, the reduced
sequence scanned, the even elements fixed up, the two interleaved), so
the RG-LRU recurrence associates as in JAX and is bitwise it on the
same inputs; the mLSTM's chunks and the sLSTM's steps are Python loops
where JAX scans.  `causal_conv1d` adds its taps in order from Python's
``sum`` (``0 + t0 + t1 ...``), each product and add rounded in the
operand dtype, as eager JAX does.  The mLSTM's in-chunk ``cumsum`` of
log forget gates is ``torch.cumsum``: XLA:CPU adds ``jnp.cumsum``
neither in sequence (past 8 elements) nor by the scan's recursion, so
no order reproduces it and the tests hold it in their band.

Layouts as in `repro_torch.models.layers`: activations ``(*lead, B, S,
D)``, weights ``(*lead, d_in, d_out)``, vectors ``(*lead, D)``, where
``lead`` is the federated engine's client axis (or none).  Dtypes as in
JAX: ``lam``, ``w_if``, ``b_if`` and ``b_gates`` are fp32 in a bf16
model, the RG-LRU's gate GEMMs and the sLSTM's recurrence run in fp32,
the mLSTM's carries are fp32 and its chunk operands are rounded to
``cfg.scan_compute_dtype`` with fp32 products.  A Python float that
scales a narrow tensor is rounded to that dtype first
(`repro_torch.models.layers.scalar`), as JAX rounds a weak-typed
scalar; the sigmoids and GeLUs are `layers`' JAX forms.

Each mixer's recurrence runs inside a `torch.profiler.record_function`
range (`RGLRU_SPAN`, `MLSTM_SPAN`, `SLSTM_SPAN`), forward and backward
(`_spanned`), so a profile reads each scan's share of a round.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.Params

RG_LRU_C = 8.0
#: the mLSTM's chunk length (a sequence is a whole number of chunks)
MLSTM_CHUNK = 128

#: the profiler ranges around each mixer's recurrence, forward and
#: backward (`chip_smoke.py` reads their shares of a round)
RGLRU_SPAN = "rglru_scan"
MLSTM_SPAN = "mlstm_chunk_scan"
SLSTM_SPAN = "slstm_scan"


# --------------------------------------------------------------------------
# profiler ranges over a scan, forward and backward
# --------------------------------------------------------------------------

def _spanned(name: str, fn: Callable, inputs: Sequence[torch.Tensor]):
    """``fn(*inputs)`` inside the range ``name``, and its backward too:
    tensor hooks open the range when the grad of ``fn``'s output
    arrives and close it when the last of ``inputs``' grads is made
    (the backward runs every node of the scan between the two, as each
    has a later sequence number than any node before the scan).  Each
    backward pass opens and closes it once."""
    with torch.profiler.record_function(name):
        out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    ins = [t for t in inputs if t.requires_grad]
    if not (torch.is_grad_enabled() and ins
            and any(o.requires_grad for o in outs)):
        return out
    # the hooks hold no tensor: a hook is kept by its tensor's autograd
    # node, so a tensor in a hook's closure would never be freed
    n_in = len(ins)
    state = {"range": None, "left": n_in}

    def opened(grad):
        if state["range"] is None:
            state["range"] = torch.profiler.record_function(name)
            state["range"].__enter__()

    def closed(grad):
        state["left"] -= 1
        if state["left"] == 0:
            state["left"] = n_in
            if state["range"] is not None:
                state["range"].__exit__(None, None, None)
                state["range"] = None

    for o in outs:
        if o.requires_grad:
            o.register_hook(opened)
    for t in ins:
        t.register_hook(closed)
    return out


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _sl(x: torch.Tensor, dim: int, start, stop=None, step=None):
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``a0 b0 a1 b1 ...`` along ``dim`` (``a`` as long as ``b`` or one
    longer)."""
    n = a.shape[dim] + b.shape[dim]
    if a.shape[dim] > b.shape[dim]:
        b = torch.cat([b, torch.zeros_like(_sl(b, dim, 0, 1))], dim)
    return _sl(torch.stack([a, b], dim + 1).flatten(dim, dim + 1), dim, 0, n)


def associative_scan(combine: Callable, elems: Sequence[torch.Tensor],
                     dim: int) -> Tuple[torch.Tensor, ...]:
    """``jax.lax.associative_scan(combine, elems, axis=dim)`` for a tuple
    of tensors: ``combine(a, b)`` takes two tuples (``a`` the earlier
    elements) and returns one.  The JAX recursion, so the same
    association of every element: combine adjacent pairs, scan those,
    combine the scanned pairs with the even elements, interleave."""
    elems = tuple(elems)
    dim = dim % elems[0].ndim
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_sl(e, dim, 0, -1, 2) for e in elems),
                      tuple(_sl(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    evens = tuple(_sl(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_sl(e, dim, 0, -1) for e in odd), evens)
    else:
        even = combine(odd, evens)
    even = tuple(torch.cat([_sl(e, dim, 0, 1), r], dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def causal_conv1d(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``u (*lead, B, S, W)``, taps ``w (*lead,
    cw, W)``; ``out[t] = sum_i u[t - cw + 1 + i] * w[i]`` over a zero
    past, the taps added in ``i`` order from Python's ``sum``."""
    cw, S = w.shape[-2], u.shape[-2]
    past = torch.zeros(u.shape[:-2] + (cw - 1, u.shape[-1]), dtype=u.dtype,
                       device=u.device)
    padded = torch.cat([past, u], dim=-2)
    return sum(padded[..., i:i + S, :] * L._vec(w.select(-2, i), u)
               for i in range(cw))


def _no_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)`` as JAX writes it
    (``max(x, 0) + log1p(exp(-|x|))``, NaN kept), with JAX's tangent
    ``exp(x - out)`` (infinities read as 0).  Not ``F.softplus``, whose
    ``threshold=20`` returns ``x``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.where(torch.isnan(x), x,
                          torch.clamp(x, min=0)
                          + torch.log1p(torch.exp(-torch.abs(x))))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_no_inf(x) - _no_inf(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# --------------------------------------------------------------------------
# RG-LRU block
# --------------------------------------------------------------------------

def init_rglru(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """The JAX package's ``init_rglru`` layout and scales (the values are
    the generator's own): ``lam`` (fp32) such that ``a = exp(-c *
    softplus(lam))`` lands in [0.9, 0.999]."""
    D = cfg.d_model
    W = cfg.lru_width or D
    dev = generator.device
    u = torch.empty(W, device=dev).uniform_(0.9 ** 2, 0.999 ** 2,
                                           generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * RG_LRU_C)))
    return {
        "w_in": L.dense_init(generator, D, W, dtype),
        "w_gate_in": L.dense_init(generator, D, W, dtype),
        "conv_w": (torch.randn(cfg.conv_width, W, generator=generator,
                               device=dev) * 0.1).to(dtype),
        "w_a": L.dense_init(generator, W, W, dtype),
        "b_a": torch.zeros(W, dtype=dtype, device=dev),
        "w_x": L.dense_init(generator, W, W, dtype),
        "b_x": torch.zeros(W, dtype=dtype, device=dev),
        "lam": lam.to(torch.float32),
        "w_out": L.dense_init(generator, W, D, dtype),
    }


def _rglru_gates(p: Params, u: torch.Tensor):
    """``u (*lead, B, S, W)`` -> ``(log_a, scaled_input)`` in fp32 (the
    gate GEMMs in fp32)."""
    uf = u.to(torch.float32)
    r = L.sigmoid(L.matmul(uf, p["w_a"].to(torch.float32))
                + L._vec(p["b_a"].to(torch.float32), uf))
    i = L.sigmoid(L.matmul(uf, p["w_x"].to(torch.float32))
                + L._vec(p["b_x"].to(torch.float32), uf))
    log_a = -RG_LRU_C * softplus(L._vec(p["lam"], uf)) * r
    scaled = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-9)) * (i * uf)
    return log_a, scaled


def _lru_combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def _lru_scan(a: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    return associative_scan(_lru_combine, (a, scaled), dim=-2)[1]


def rglru_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x ``(*lead, B, S, D)``; full sequence.  ``h_t = a_t h_{t-1} +
    sqrt(1 - a_t^2) (i_t u_t)`` by `associative_scan` (`RGLRU_SPAN`),
    gated by ``gelu(x W_gate)``.  Returns the mixer output."""
    gate = L.gelu_tanh(L.matmul(x, p["w_gate_in"]))
    u = causal_conv1d(L.matmul(x, p["w_in"]), p["conv_w"])
    log_a, scaled = _rglru_gates(p, u)
    h = _spanned(RGLRU_SPAN, _lru_scan, (torch.exp(log_a), scaled))
    return L.matmul(h.to(x.dtype) * gate, p["w_out"])


# --------------------------------------------------------------------------
# mLSTM block (chunkwise-parallel matrix memory)
# --------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    if inner % H:
        raise ValueError(f"{cfg.name}: mLSTM width {inner} is not a "
                         f"multiple of {H} heads")
    return inner, H, inner // H


def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """``w_if`` and ``b_if`` fp32 whatever the model's dtype; ``b_if`` is
    0 for the input gates and 3 for the forget gates, as in JAX."""
    D = cfg.d_model
    inner, H, _ = _mlstm_dims(cfg)
    dev = generator.device
    return {
        "w_up": L.dense_init(generator, D, inner, dtype),
        "w_up_gate": L.dense_init(generator, D, inner, dtype),
        "conv_w": (torch.randn(cfg.conv_width, inner, generator=generator,
                               device=dev) * 0.1).to(dtype),
        "wq": L.dense_init(generator, inner, inner, dtype),
        "wk": L.dense_init(generator, inner, inner, dtype),
        "wv": L.dense_init(generator, inner, inner, dtype),
        "w_if": L.dense_init(generator, inner, 2 * H, torch.float32),
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           3.0 * torch.ones(H, device=dev)]),
        "w_down": L.dense_init(generator, inner, D, dtype),
    }


def _f32(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """An einsum operand rounded to ``cdt``, then widened: JAX's
    ``preferred_element_type=float32`` products of ``cdt`` operands."""
    return t.to(cdt).to(torch.float32)


def _mlstm_chunk_scan(q, k, v, li, lf, cdt=torch.float32):
    """Chunkwise stabilized mLSTM recurrence (the JAX package's
    ``_mlstm_chunk_scan`` from a zero state).

    q, k, v: ``(..., S, dh)`` with k pre-scaled by 1/sqrt(dh); li, lf:
    ``(..., S)`` log input / forget gates (fp32).  ``cdt``: the chunk
    operands' dtype (fp32 products, fp32 carries).  Returns ``(h (...,
    S, dh), (C, n, m))``.  The three-operand ``bhj,bhjd,bhje->bhde`` is
    JAX's contraction path: ``w_kv`` times ``k`` first, then the
    product over j with ``v``."""
    *lead, S, dh = q.shape
    Lc = min(MLSTM_CHUNK, S)
    if S % Lc:
        raise ValueError(f"sequence {S} must be divisible by the mLSTM "
                         f"chunk {Lc}")
    dev = q.device
    C = torch.zeros(tuple(lead) + (dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros(tuple(lead) + (dh,), dtype=torch.float32, device=dev)
    m = torch.full(tuple(lead), -1e30, dtype=torch.float32, device=dev)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), -math.inf, dtype=torch.float32, device=dev)
    hs = []
    for qb, kb, vb, lib, lfb in zip(q.split(Lc, -2), k.split(Lc, -2),
                                    v.split(Lc, -2), li.split(Lc, -1),
                                    lf.split(Lc, -1)):
        b = torch.cumsum(lfb, dim=-1)        # inclusive cumsum of log-f
        # decay from j to i (j <= i): b_i - b_j, plus j's input gate
        Dm = torch.where(mask, b[..., :, None] - b[..., None, :]
                         + lib[..., None, :], neg_inf)
        inter_log = m[..., None] + b         # decay of the carry-in
        m_i = torch.maximum(torch.amax(Dm, dim=-1), inter_log)
        W = torch.exp(Dm - m_i[..., None])
        qf, kf, vf = _f32(qb, cdt), _f32(kb, cdt), _f32(vb, cdt)
        qk = qf @ kf.transpose(-1, -2)
        Wqk = W * qk
        intra_num = _f32(Wqk, cdt) @ vf
        intra_den = torch.sum(Wqk, dim=-1)
        w_inter = torch.exp(inter_log - m_i)
        inter_num = (qf @ _f32(C, cdt)) * w_inter[..., None]
        inter_den = (qf @ _f32(n, cdt)[..., None])[..., 0] * w_inter
        num = intra_num + inter_num
        den = torch.maximum(torch.abs(intra_den + inter_den),
                            torch.exp(-m_i))
        hs.append(num / den[..., None])
        # carry update to the chunk's end
        btot = b[..., -1]
        tail = btot[..., None] - b + lib
        m_new = torch.maximum(m + btot, torch.amax(tail, dim=-1))
        w_kv = torch.exp(tail - m_new[..., None])
        decay = torch.exp(m + btot - m_new)
        kw = _f32(w_kv, cdt)[..., None] * kf
        C = C * decay[..., None, None] + kw.transpose(-1, -2) @ vf
        n = n * decay[..., None] + torch.sum(kw, dim=-2)
        m = m_new
    return torch.cat(hs, dim=-2), (C, n, m)


def mlstm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x ``(*lead, B, S, D)``; full sequence, S a whole number of
    `MLSTM_CHUNK` chunks (or shorter).  Up-projection, causal conv and
    SiLU, q / k / v heads, exponential input and sigmoid forget gates
    (fp32), the chunk scan (`MLSTM_SPAN`) in ``cfg.scan_compute_dtype``,
    the SiLU output gate and the down-projection."""
    S = x.shape[-2]
    inner, H, dh = _mlstm_dims(cfg)
    z = L.matmul(x, p["w_up"])
    og = L.silu(L.matmul(x, p["w_up_gate"]))
    zc = L.silu(causal_conv1d(z, p["conv_w"]))

    def heads(t):                       # (..., S, H*dh) -> (..., H, S, dh)
        return t.reshape(t.shape[:-1] + (H, dh)).transpose(-3, -2)
    q = heads(L.matmul(zc, p["wq"]))
    k = heads(L.matmul(zc, p["wk"])) / L.scalar(math.sqrt(dh), zc)
    v = heads(L.matmul(z, p["wv"]))
    gates = (L.matmul(zc.to(torch.float32), p["w_if"])
             + L._vec(p["b_if"], zc))
    li = gates[..., :H].transpose(-1, -2)           # (..., H, S)
    lf = log_sigmoid(gates[..., H:]).transpose(-1, -2)
    cdt = getattr(torch, cfg.scan_compute_dtype)
    h = _spanned(MLSTM_SPAN,
                 lambda *a: _mlstm_chunk_scan(*a, cdt=cdt)[0],
                 (q, k, v, li, lf))
    h = h.transpose(-3, -2).reshape(x.shape[:-2] + (S, inner)).to(x.dtype)
    return L.matmul(h * og, p["w_down"])


# --------------------------------------------------------------------------
# sLSTM block (strictly sequential nonlinear recurrence)
# --------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """``b_gates`` fp32: 0 for z and i, 3 for f, 0 for o, as in JAX;
    ``r_gates (4, H, dh, dh)`` N(0, 1/dh)."""
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    d_up = int(cfg.slstm_proj_factor * D)
    dev = generator.device
    return {
        "w_gates": L.dense_init(generator, D, 4 * D, dtype),     # z,i,f,o
        "b_gates": torch.cat([torch.zeros(2 * D, device=dev),
                              3.0 * torch.ones(D, device=dev),
                              torch.zeros(D, device=dev)]),
        "r_gates": (torch.randn(4, H, dh, dh, generator=generator,
                                device=dev) / math.sqrt(dh)).to(dtype),
        "gn": torch.ones(D, dtype=dtype, device=dev),
        "w_up": L.dense_init(generator, D, d_up, dtype),
        "w_up_gate": L.dense_init(generator, D, d_up, dtype),
        "w_down": L.dense_init(generator, d_up, D, dtype),
    }


def _slstm_step(rg4, carry, wx_t):
    """One step.  carry: ``(h, c, n, m)`` each ``(..., H, B, dh)``;
    ``rg4 (..., H, dh, 4 dh)`` the recurrent weights of z, i, f, o side
    by side; ``wx_t (..., 4, H, B, dh)`` the step's ``W x + b``."""
    h, c, n, m = carry
    dh = h.shape[-1]
    rh = (h @ rg4).unflatten(-1, (4, dh))      # (..., H, B, 4, dh)

    def pre(g):
        return wx_t.select(-4, g) + rh.select(-2, g)
    z = torch.tanh(pre(0))
    it = pre(1)
    ft = pre(2)
    o = L.sigmoid(pre(3))
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h = o * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def _slstm_scan(wx: torch.Tensor, rg4: torch.Tensor) -> torch.Tensor:
    """The steps over ``wx (..., S, 4, H, B, dh)``; returns the hidden
    states ``(..., S, H, B, dh)`` (fp32)."""
    S = wx.shape[-5]
    state = torch.zeros(wx.shape[:-5] + wx.shape[-3:], dtype=torch.float32,
                        device=wx.device)
    carry = (state, state, state, torch.full_like(state, -1e30))
    hs = []
    for t in range(S):
        carry = _slstm_step(rg4, carry, wx.select(-5, t))
        hs.append(carry[0])
    return torch.stack(hs, dim=-4)


def slstm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x ``(*lead, B, S, D)``; full sequence.  The gate pre-activations
    ``W x + b`` for every step at once (fp32), then the steps in order
    (`SLSTM_SPAN`; ``cfg.slstm_unroll`` changes nothing, as in JAX), the
    gn RMSNorm and the GeGLU-style up / down projection."""
    *lead, B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    nl = len(lead)
    wx = (L.matmul(x.to(torch.float32), p["w_gates"].to(torch.float32))
          + L._vec(p["b_gates"], x))
    # (*lead, B, S, 4, H, dh) -> (*lead, S, 4, H, B, dh)
    wx = wx.reshape(tuple(lead) + (B, S, 4, H, dh)).permute(
        *range(nl), nl + 1, nl + 2, nl + 3, nl, nl + 4)
    # (*lead, 4, H, dh, dh) -> (*lead, H, dh, 4 dh)
    rg4 = p["r_gates"].to(torch.float32).permute(
        *range(nl), nl + 1, nl + 2, nl, nl + 3).reshape(
        tuple(lead) + (H, dh, 4 * dh))
    hs = _spanned(SLSTM_SPAN, _slstm_scan, (wx, rg4))
    # (*lead, S, H, B, dh) -> (*lead, B, S, D)
    h_seq = hs.permute(*range(nl), nl + 2, nl, nl + 1, nl + 3).reshape(
        tuple(lead) + (B, S, D))
    h_seq = L.rms_norm(h_seq.to(x.dtype), p["gn"])
    up = L.gelu_tanh(L.matmul(h_seq, p["w_up"])) * L.matmul(
        h_seq, p["w_up_gate"])
    return L.matmul(up, p["w_down"])
