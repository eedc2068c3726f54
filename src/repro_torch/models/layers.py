"""Neural-net primitives of the LM zoo: the port of the JAX package's
``models/layers.py`` (GQA / MHA attention with RoPE or M-RoPE, qk-norm,
a sliding window and a logit softcap; DeepSeek-V2's MLA attention;
swiglu / geglu / gelu FFN; the capacity-routed MoE FFN with shared
experts; RMSNorm), and the attention and MLA decode caches: a
full-sequence call returns its k / v (or latent) cache on request, a
one-token decode call at a position writes its slot of the cache in
place (`write_slot`: ``jax.lax.dynamic_update_slice``'s clamp) and
attends over the valid slots.

Everything is functional.  A parameter tree is a flat
``dict[str, Tensor]`` keyed by ``/``-joined paths (``"mixer/wq"``),
the keys the JAX package's checkpoints use; sorted, they are the order
`jax.tree_util.tree_flatten` gives the nested dicts, so
`repro_torch.comm.flat` packs them bitwise as the JAX ``FlatSpec``
does.  ``init_*`` builds such a dict from a `torch.Generator`,
``*_apply`` consumes it.

Layouts: activations ``(*lead, B, S, D)``, attention tensors ``(*lead,
B, S, H, hd)``.  ``lead`` is the leading client axis of the federated
engine (or none): every weight then carries it too, ``(*lead, d_in,
d_out)``, and each client's activations meet only its own weights.
The ops mirror the JAX ones one for one, in the same dtypes and order;
attention is plain ops (no fused attention call), as the reference is.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

# Neg-inf substitute that is safe in bf16 softmax arithmetic.
MASK_VALUE = -1e9

# Materialised attention scores above this seq length use the chunked
# online-softmax path (memory: O(S * KV_CHUNK) instead of O(S^2)).
CHUNK_ATTN_THRESHOLD = 2048
KV_CHUNK = 1024


# --------------------------------------------------------------------------
# trees and leading axes
# --------------------------------------------------------------------------

def subtree(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix`` (``"mixer"``), keyed relative to it."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


def prefixed(prefix: str, params: Params) -> Params:
    """``params`` keyed under ``prefix``: the inverse of `subtree`."""
    return {f"{prefix}/{k}": v for k, v in params.items()}


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x (*lead, ..., d_in)`` and ``w (*lead, d_in,
    d_out)``: the token axes fold into one, so each client is one GEMM
    of its own weights (no broadcast copy of ``w``)."""
    n_lead = w.ndim - 2
    if n_lead == 0:
        return x @ w
    out = x.flatten(n_lead, -2) @ w
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _vec(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(*lead, D)`` vector shaped to broadcast against ``x (*lead,
    ..., D)``."""
    n_lead = w.ndim - 1
    return w.reshape(w.shape[:n_lead] + (1,) * (x.ndim - n_lead - 1)
                     + w.shape[-1:])


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/d_in) weights drawn in fp32 on the generator's device, then
    stored as ``dtype`` (the JAX package's ``dense_init``)."""
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn(d_in, d_out, generator=generator,
                        device=generator.device) * scale).to(dtype)


def stacked_dense_init(generator: torch.Generator, n: int, d_in: int,
                       d_out: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (torch.randn(n, d_in, d_out, generator=generator,
                        device=generator.device) * scale).to(dtype)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * _vec(weight, x).to(torch.float32)
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype (on the CPU, where
    it acts as a scalar of any device's op): the value rounded to that
    dtype first, as JAX rounds a weak-typed Python scalar before it
    meets a bf16 array (torch would compute with the unrounded value in
    fp32)."""
    return torch.tensor(value, dtype=like.dtype)


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``), the form nearest XLA's in
    each dtype: at bf16 XLA's expansion ``1 / (1 + exp(-x))`` with each
    op rounded (JAX's bits; ``torch.sigmoid`` rounds once, a third of
    bf16 values a step off), at fp32 ``torch.sigmoid`` (334 of 100,000
    values an ulp from XLA's, the expansion with torch's ``exp`` 3,964);
    JAX's tangent ``y (1 - y)`` (no overflow of ``exp(-x)`` reaches the
    gradient)."""

    @staticmethod
    def forward(ctx, x):
        y = (torch.sigmoid(x) if x.dtype == torch.float32
             else 1 / (1 + torch.exp(-x)))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: at bf16 op by op, each
    constant and op rounded, ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x +
    0.044715 x^3))))`` (JAX's bits; ``F.gelu`` rounds once, 42% of bf16
    values a step off); at fp32 ``F.gelu``, the nearer XLA's there."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    cdf = scalar(0.5, x) * (1 + torch.tanh(
        scalar(math.sqrt(2 / math.pi), x)
        * (x + scalar(0.044715, x) * x ** 3)))
    return x * cdf


def ffn_act(kind: str, gate, up):
    """The FFN activations of ``jax.nn`` in each dtype: swiglu at bf16
    is `silu` op by op (JAX's bits; ``F.silu`` rounds once, a third of
    bf16 values a step off), at fp32 ``F.silu`` (nearer XLA's than ``x *
    torch.sigmoid(x)``); the GeLU kinds `gelu_tanh`."""
    if kind == "swiglu":
        act = F.silu(gate) if gate.dtype == torch.float32 else silu(gate)
        return act * up
    if kind == "geglu":
        return gelu_tanh(gate) * up
    if kind == "gelu":
        return gelu_tanh(gate)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# RoPE (standard / partial / M-RoPE)
# --------------------------------------------------------------------------

def _rope_sin_cos(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (...,) -> sin/cos (..., rot_dim//2) in fp32."""
    half = rot_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def _mrope_sin_cos(positions: torch.Tensor, sections, half: int,
                   theta: float):
    """M-RoPE: the ``half`` frequency slots split into (t, h, w)
    sections, each section's angles from its own channel of
    ``positions (3, B, S)``; sin/cos (B, S, half) in fp32."""
    sins, coss, start = [], [], 0
    for sec, pos_c in zip(sections, positions):
        idx = torch.arange(start, start + sec, dtype=torch.float32,
                           device=positions.device)
        inv = 1.0 / (theta ** (idx / half))
        ang = pos_c.to(torch.float32)[..., None] * inv
        sins.append(torch.sin(ang))
        coss.append(torch.cos(ang))
        start += sec
    return torch.cat(sins, dim=-1), torch.cat(coss, dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               rot_dim: Optional[int] = None) -> torch.Tensor:
    """x: (*lead, B, S, H, hd).  positions: (B, S), or (3, B, S) for
    M-RoPE (``cfg.mrope_sections``; without sections the three channels
    collapse to the first, a text-only input)."""
    hd = x.shape[-1]
    if rot_dim is None:
        rot_dim = int(hd * cfg.rotary_pct)
        rot_dim -= rot_dim % 2
    half = rot_dim // 2
    if cfg.mrope_sections is not None and positions.ndim == 3:
        sin, cos = _mrope_sin_cos(positions, cfg.mrope_sections, half,
                                  cfg.rope_theta)
    else:
        if positions.ndim == 3:
            positions = positions[0]
        sin, cos = _rope_sin_cos(positions, rot_dim, cfg.rope_theta)
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    r1, r2 = rot[..., :half], rot[..., half:]
    r1f, r2f = r1.to(torch.float32), r2.to(torch.float32)
    out = torch.cat([r1f * cos - r2f * sin, r2f * cos + r1f * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


def seq_positions(positions: torch.Tensor) -> torch.Tensor:
    """The ``(S,)`` positions of a full-sequence mask: the first row of
    ``positions (B, S)``, or of its first channel ``(3, B, S)``."""
    while positions.ndim > 1:
        positions = positions[0]
    return positions


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (*lead,B,Sq,H,hd), k (*lead,B,Sk,K,hd) -> (*lead,B,H,Sq,Sk)."""
    Sq, H, hd = q.shape[-3:]
    K = k.shape[-2]
    q = q.reshape(q.shape[:-2] + (K, H // K, hd))
    s = torch.einsum("...qkgh,...skh->...kgqs", q, k)
    return s.reshape(s.shape[:-4] + (H, Sq, k.shape[-3]))


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (*lead,B,H,Sq,Sk), v (*lead,B,Sk,K,hd) -> (*lead,B,Sq,H,hd)."""
    H, Sq, Sk = probs.shape[-3:]
    K = v.shape[-2]
    p = probs.reshape(probs.shape[:-3] + (K, H // K, Sq, Sk))
    o = torch.einsum("...kgqs,...skh->...qkgh", p, v)
    return o.reshape(o.shape[:-3] + (H, v.shape[-1]))


def attn_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive bias (Sq, Sk) in fp32."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    if k_valid is not None:
        ok &= k_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, MASK_VALUE))


def attention_dense(q, k, v, bias, scale: float, softcap_val=None):
    """Reference full-materialisation attention.  bias (Sq, Sk)."""
    s = _gqa_scores(q, k).to(torch.float32) * scale
    s = softcap(s, softcap_val)
    s = s + bias
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p.to(v.dtype), v)


def attention_chunked(q, k, v, *, q_pos, k_pos, causal, window, scale,
                      softcap_val=None, k_valid=None,
                      kv_chunk: int = KV_CHUNK):
    """Online-softmax attention over KV chunks: the JAX package's
    ``lax.scan`` body as a loop, chunk by chunk in order.  Memory is
    O(Sq * kv_chunk) per head instead of O(Sq * Sk)."""
    Sq, H = q.shape[-3], q.shape[-2]
    Sk = k.shape[-3]
    n_chunks = -(-Sk // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    kv_ok = (k_valid if k_valid is not None
             else torch.ones((Sk,), dtype=torch.bool, device=k.device))
    if pad:
        # pad the Sk axis (-3) of k and v; padded keys are invalid
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        kv_ok = F.pad(kv_ok, (0, pad), value=False)
    m = torch.full(q.shape[:-3] + (H, Sq), -math.inf,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kb, vb = k[..., sl, :, :], v[..., sl, :, :]
        s = _gqa_scores(q, kb).to(torch.float32) * scale   # (..,H,Sq,ck)
        s = softcap(s, softcap_val)
        s = s + attn_mask_bias(q_pos, k_pos[sl], causal=causal,
                               window=window, k_valid=kv_ok[sl])
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = _gqa_out(p.to(torch.float32), vb.to(torch.float32))
        acc = acc * corr[..., None] + pv.transpose(-3, -2)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(-3, -2).to(q.dtype)          # (..., Sq, H, hd)


def attention(q, k, v, *, q_pos, k_pos, causal, window=None, scale=None,
              softcap_val=None, k_valid=None, chunk_threshold=None,
              kv_chunk=None):
    """Dispatch between dense and chunked attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if chunk_threshold is None:
        chunk_threshold = CHUNK_ATTN_THRESHOLD
    Sq, Sk = q.shape[-3], k.shape[-3]
    if max(Sq, Sk) > chunk_threshold and Sq > 1:
        return attention_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                 causal=causal, window=window, scale=scale,
                                 softcap_val=softcap_val, k_valid=k_valid,
                                 kv_chunk=kv_chunk or KV_CHUNK)
    bias = attn_mask_bias(q_pos, k_pos, causal=causal, window=window,
                          k_valid=k_valid)
    return attention_dense(q, k, v, bias, scale, softcap_val)


# --------------------------------------------------------------------------
# GQA attention block (the 'attn', 'local' and 'global' kinds)
# --------------------------------------------------------------------------

def pad_head_mask(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Bool (Hp*hd,) — True where the flattened q/o dim holds a REAL head;
    padded heads sit at the end of each KV group (the JAX package's
    layout, which keeps every real head's kv pairing)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Hp = max(cfg.pad_attn_heads, H)
    assert K < H and Hp % K == 0, (
        "pad_attn_heads requires GQA (K < H) and padded count divisible "
        f"by kv heads; got H={H} K={K} Hp={Hp}")
    g_old, g_new = H // K, Hp // K
    real = (torch.arange(Hp, device=device) % g_new) < g_old
    return torch.repeat_interleave(real, hd)


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Params:
    D, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    Hp = max(cfg.pad_attn_heads, H) if cfg.pad_attn_heads else H
    p = {
        "wq": dense_init(generator, D, Hp * hd, dtype),
        "wk": dense_init(generator, D, K * hd, dtype),
        "wv": dense_init(generator, D, K * hd, dtype),
        "wo": dense_init(generator, Hp * hd, D, dtype),
    }
    if Hp != H:
        # zeroed padded heads: exact no-op heads (zero output, zero
        # gradient), group-interleaved so real heads keep their kv pairs
        col = pad_head_mask(cfg, generator.device).to(dtype)
        p["wq"] = p["wq"] * col[None, :]
        p["wo"] = p["wo"] * col[:, None]
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=generator.device)
    return p


def write_slot(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``jax.lax.dynamic_update_slice`` of a one-position update along
    ``buf``'s axis 1 (the sequence axis of a ``(B, L, ...)`` cache), in
    place: a negative start counted from the end, then clamped into
    ``[0, L - 1]``, as JAX does so that the update fits (an indexed
    write would raise past the end)."""
    n = buf.shape[1]
    start = int(start)
    slot = min(max(start + n if start < 0 else start, 0), n - 1)
    buf[:, slot:slot + 1] = new


def attention_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, kind: str, cache=None,
                    pos: Optional[int] = None, want_cache: bool = False):
    """x (*lead, B, S, D), positions (B, S) or (3, B, S).  A ``local``
    block attends within ``cfg.window``; with ``cfg.qk_norm`` q and k are
    RMS-normed over the head dim before RoPE.  Returns the mixer output,
    or ``(out, cache)`` with ``want_cache`` or a ``cache``.

    Full sequence (``cache`` None): the cache is ``{"k", "v"}``, each
    ``(B, S, K, hd)``.  Decode (``cache`` of `init_attention_cache`'s
    layout, S == 1 at the absolute position ``pos``): this token's k and
    v are written into the cache in place, at ``pos % W`` in a ``local``
    block's rolling buffer of W slots and at ``min(pos, W - 1)`` in a
    full one (`write_slot`), and the query attends to every valid slot
    (non-causal, ``k_valid``), as the JAX package's decode branch."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.pad_attn_heads:
        H = max(cfg.pad_attn_heads, H)      # zero no-op heads (see init)
    window = cfg.window if kind == "local" else None
    tok = x.shape[:-1]
    q = matmul(x, p["wq"]).reshape(tok + (H, hd))
    k = matmul(x, p["wk"]).reshape(tok + (K, hd))
    v = matmul(x, p["wv"]).reshape(tok + (K, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    if cache is None:
        q_pos = seq_positions(positions)
        out = attention(q, k, v, q_pos=q_pos, k_pos=q_pos,
                        causal=cfg.causal, window=window,
                        softcap_val=cfg.softcap_attn,
                        chunk_threshold=cfg.attn_chunk_threshold,
                        kv_chunk=cfg.attn_kv_chunk)
        new_cache = {"k": k, "v": v}
    else:
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[1]
        slot = pos % W if window is not None else min(pos, W - 1)
        write_slot(ck, k, slot)
        write_slot(cv, v, slot)
        idx = torch.arange(W, device=x.device)
        if window is not None:
            # the rolling buffer's absolute positions
            k_pos = torch.where(idx <= slot, pos - (slot - idx),
                                pos - (slot - idx) - W)
            k_valid = k_pos >= 0
        else:
            k_pos = idx
            k_valid = k_pos <= pos
        out = attention(q, ck, cv, q_pos=torch.full((1,), pos,
                                                    device=x.device),
                        k_pos=k_pos, causal=False, window=None,
                        softcap_val=cfg.softcap_attn, k_valid=k_valid)
        new_cache = cache
    if cfg.pad_attn_heads:
        # zero the padded heads' outputs, so the zero wo rows get no
        # gradient either
        out = out * pad_head_mask(cfg, x.device).reshape(H, hd).to(
            out.dtype)
    out = matmul(out.reshape(tok + (H * hd,)), p["wo"])
    return (out, new_cache) if want_cache or cache is not None else out


def init_attention_cache(cfg: ModelConfig, kind: str, batch: int,
                         max_len: int, dtype: torch.dtype,
                         device=None) -> Params:
    """Zero k and v ``(batch, L, K, hd)``: L = ``min(window, max_len)``
    for a ``local`` block (its rolling buffer), else ``max_len``."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n = (min(cfg.window, max_len) if kind == "local" and cfg.window
         else max_len)
    return {name: torch.zeros(batch, n, K, hd, dtype=dtype, device=device)
            for name in ("k", "v")}


# --------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): q per head, k and v up-projected from a
# normed latent, a RoPE key shared by the heads
# --------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(generator, D, H * qk_dim, dtype),
        "w_dkv": dense_init(generator, D,
                            m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=dtype,
                              device=generator.device),
        "w_ukv": dense_init(generator, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": dense_init(generator, H * m.v_head_dim, D, dtype),
    }


def _mla_kv(p: Params, cfg: ModelConfig, ckv_norm: torch.Tensor,
            kpe: torch.Tensor, H: int):
    """Up-project the latent to per-head k and v: ``ckv_norm (*lead, B,
    S, rank)``, ``kpe (*lead, B, S, rd)`` -> k ``(..., H, nope + rd)``,
    v ``(..., H, v_head_dim)``; the RoPE key is broadcast to every
    head."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    kv = matmul(ckv_norm, p["w_ukv"]).reshape(
        ckv_norm.shape[:-1] + (H, nope + m.v_head_dim))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_pe = kpe[..., None, :].expand(kpe.shape[:-1]
                                    + (H, m.qk_rope_head_dim))
    return torch.cat([k_nope, k_pe], dim=-1), v


def mla_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, cache=None,
              pos: Optional[int] = None, want_cache: bool = False):
    """x (*lead, B, S, D), positions (B, S) or (3, B, S).  Scores are
    scaled by ``1/sqrt(nope + rope)``, and the dispatcher gets no
    chunking options of the config (the JAX package's MLA passes none).
    Returns the mixer output, or ``(out, cache)`` with ``want_cache`` or
    a ``cache``.

    The cache is the normed latent and the RoPE key, ``{"ckv" (B, L,
    rank), "kpe" (B, L, rope)}``.  Decode (S == 1 at ``pos``) writes
    them at ``pos`` in place (`write_slot`'s clamp) and up-projects the
    whole cache to k and v each step, as JAX does."""
    m = cfg.mla
    H = cfg.num_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    tok = x.shape[:-1]
    q = matmul(x, p["wq"]).reshape(tok + (H, nope + rope))
    q_pe = apply_rope(q[..., nope:], positions, cfg, rot_dim=rope)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)

    dkv = matmul(x, p["w_dkv"])
    ckv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"])
    kpe = apply_rope(dkv[..., None, m.kv_lora_rank:], positions, cfg,
                     rot_dim=rope)[..., 0, :]
    scale = 1.0 / math.sqrt(nope + rope)
    if cache is None:
        k, v = _mla_kv(p, cfg, ckv, kpe, H)
        q_pos = seq_positions(positions)
        out = attention(q, k, v, q_pos=q_pos, k_pos=q_pos,
                        causal=cfg.causal, scale=scale)
        new_cache = {"ckv": ckv, "kpe": kpe}
    else:
        write_slot(cache["ckv"], ckv, pos)
        write_slot(cache["kpe"], kpe, pos)
        k, v = _mla_kv(p, cfg, cache["ckv"], cache["kpe"], H)
        k_pos = torch.arange(k.shape[-3], device=x.device)
        out = attention(q, k, v, q_pos=torch.full((1,), pos,
                                                  device=x.device),
                        k_pos=k_pos, causal=False, scale=scale,
                        k_valid=k_pos <= pos)
        new_cache = cache
    out = matmul(out.reshape(tok + (H * m.v_head_dim,)), p["wo"])
    return (out, new_cache) if want_cache or cache is not None else out


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device=None) -> Params:
    m = cfg.mla
    return {"ckv": torch.zeros(batch, max_len, m.kv_lora_rank, dtype=dtype,
                               device=device),
            "kpe": torch.zeros(batch, max_len, m.qk_rope_head_dim,
                               dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# dense FFN + MoE
# --------------------------------------------------------------------------

def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype: torch.dtype) -> Params:
    p = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    p["w_up"] = dense_init(generator, d_model, d_ff, dtype)
    p["w_down"] = dense_init(generator, d_ff, d_model, dtype)
    return p


def ffn_apply(p: Params, kind: str, x: torch.Tensor) -> torch.Tensor:
    gate = matmul(x, p["w_gate"]) if "w_gate" in p else None
    up = matmul(x, p["w_up"])
    return matmul(ffn_act(kind, gate if gate is not None else up, up),
                  p["w_down"])


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The router (fp32 whatever the model's dtype, as in JAX), the
    experts' weights stacked ``(E, d_in, d_out)``, and the shared
    experts as one dense FFN under ``shared/``."""
    mo = cfg.moe
    D, E, F_ = cfg.d_model, mo.num_experts, mo.d_ff_expert
    p = {
        "router": dense_init(generator, D, E, torch.float32),
        "w_gate": stacked_dense_init(generator, E, D, F_, dtype),
        "w_up": stacked_dense_init(generator, E, D, F_, dtype),
        "w_down": stacked_dense_init(generator, E, F_, D, dtype),
    }
    if mo.num_shared:
        p.update(prefixed("shared", init_ffn(
            generator, D, mo.num_shared * mo.d_ff_shared, cfg.ffn_kind,
            dtype)))
    return p


#: the profiler range around the MoE's one-hot dispatch and combine
#: einsums, forward and backward (`chip_smoke.py` reads its share)
ROUTE_SPAN = "moe dispatch/combine"


class _RouteEinsum(torch.autograd.Function):
    """``torch.einsum("A,B->O", a, b)`` inside `ROUTE_SPAN`, its two
    gradients ``einsum("O,B->A")`` and ``einsum("A,O->B")`` too (every
    index of each operand appears in the other or in the output)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.save_for_backward(a, b)
        ctx.eq = eq
        with torch.profiler.record_function(ROUTE_SPAN):
            return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, o = ctx.eq.split("->")
        ia, ib = ins.split(",")
        ga = gb = None
        with torch.profiler.record_function(ROUTE_SPAN):
            if ctx.needs_input_grad[1]:
                ga = torch.einsum(f"{o},{ib}->{ia}", g, b)
            if ctx.needs_input_grad[2]:
                gb = torch.einsum(f"{ia},{o}->{ib}", a, g)
        return None, ga, gb


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest in
    descending order, ties to the lower index (a stable descending sort;
    `torch.topk` promises no order among ties).  Returns (values,
    indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(cfg: ModelConfig, probs: torch.Tensor,
              expert_idx: Optional[torch.Tensor] = None):
    """The router's choices from its probabilities ``probs (*lead, B, S,
    E)``: ``expert_idx`` ``(*lead, B, S, K)`` (top-k) and the ``(*lead,
    B, S, E, C)`` ``combine`` weights, each kept choice's renormalised
    gate at its capacity slot.  Selections are taken in ``kk`` order,
    each expert's slots filled along the sequence; a choice past its
    expert's capacity C is dropped (a zero row).  The JAX package's
    ``moe_apply`` bookkeeping, a client axis in front.

    ``expert_idx`` given (the seam of the tests: the JAX package's own
    choices, in its order) takes the place of the top-k; the gates are
    then ``probs`` at those choices, which the top-k's values are."""
    mo = cfg.moe
    S, E = probs.shape[-2:]
    K = mo.top_k
    C = max(int(S * K / E * mo.capacity_factor), 1)
    if expert_idx is None:
        gate_vals, expert_idx = top_k(probs, K)
    else:
        gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    combine = torch.zeros(probs.shape + (C,), dtype=torch.float32,
                          device=probs.device)
    fill = torch.zeros(probs.shape[:-2] + (E,), dtype=torch.float32,
                       device=probs.device)                  # tokens/expert
    slots = torch.arange(C, device=probs.device)
    for kk in range(K):
        mask_k = F.one_hot(expert_idx[..., kk], E).to(torch.float32)
        pos_in_e = (torch.cumsum(mask_k, dim=-2) - mask_k
                    + fill[..., None, :])
        keep = (pos_in_e < C) * mask_k
        # jax.nn.one_hot's rule: a position >= C has no slot (a zero
        # row), where F.one_hot would raise
        slot = (pos_in_e.to(torch.int32)[..., None] == slots).to(
            torch.float32)
        combine = combine + (gate_vals[..., kk, None, None]
                             * keep[..., None] * slot)
        fill = fill + torch.sum(mask_k, dim=-2)
    return expert_idx, combine


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Capacity-based top-k routing with one-hot dispatch and combine
    einsums (the JAX package's ``moe_apply``), for ``x (*lead, B, S,
    D)`` and weights ``(*lead, ...)``; each expert is one GEMM of its
    ``(B*C, D)`` slots (E acts as one more leading axis of `matmul`).
    Returns ``(out, aux)``: ``aux`` the Switch-style load-balance loss,
    one a leading index ``(*lead,)``."""
    mo = cfg.moe
    E = mo.num_experts
    logits = matmul(x.to(torch.float32), p["router"])       # (.., B, S, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx, combine = moe_route(cfg, probs)
    # Switch-style load-balance auxiliary loss, per leading index; taken
    # before the expert GEMMs so that under remat the backward's
    # recompute stops at the last product it needs (the shared experts'
    # down projection's output is never read)
    frac_tokens = torch.mean(torch.sum(F.one_hot(expert_idx, E).to(
        torch.float32), dim=-2), dim=(-3, -2))
    frac_probs = torch.mean(probs, dim=(-3, -2))
    aux = mo.aux_loss_coef * E * torch.sum(frac_tokens * frac_probs,
                                           dim=-1)
    dispatch = (combine > 0).to(x.dtype)

    xin = _RouteEinsum.apply("...bsec,...bsd->...ebcd", dispatch, x)
    h_gate = matmul(xin, p["w_gate"])                        # (.., E, B, C, F)
    h_up = matmul(xin, p["w_up"])
    eout = matmul(ffn_act(cfg.ffn_kind, h_gate, h_up), p["w_down"])
    out = _RouteEinsum.apply("...bsec,...ebcd->...bsd", combine.to(x.dtype),
                             eout)
    if mo.num_shared:
        out = out + ffn_apply(subtree(p, "shared"), cfg.ffn_kind, x)
    return out, aux
