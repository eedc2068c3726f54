"""Neural-net primitives of the LM zoo, the dense subset: the port of
the JAX package's ``models/layers.py`` for the dense decoder (GQA / MHA
attention with RoPE, qk-norm, a sliding window and a logit softcap;
swiglu / geglu / gelu FFN, RMSNorm).

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


def ffn_act(kind: str, gate, up):
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(kind)


# --------------------------------------------------------------------------
# RoPE (standard / partial)
# --------------------------------------------------------------------------

def _rope_sin_cos(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (...,) -> sin/cos (..., rot_dim//2) in fp32."""
    half = rot_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               rot_dim: Optional[int] = None) -> torch.Tensor:
    """x: (*lead, B, S, H, hd).  positions: (B, S)."""
    if cfg.mrope_sections is not None or positions.ndim == 3:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP queue 1 (g)")
    hd = x.shape[-1]
    if rot_dim is None:
        rot_dim = int(hd * cfg.rotary_pct)
        rot_dim -= rot_dim % 2
    half = rot_dim // 2
    sin, cos = _rope_sin_cos(positions, rot_dim, cfg.rope_theta)
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    r1, r2 = rot[..., :half], rot[..., half:]
    r1f, r2f = r1.to(torch.float32), r2.to(torch.float32)
    out = torch.cat([r1f * cos - r2f * sin, r2f * cos + r1f * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


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


def attention_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, kind: str) -> torch.Tensor:
    """x (*lead, B, S, D), positions (B, S); full sequence (no cache:
    decode comes with the serving slice).  A ``local`` block attends
    within ``cfg.window``; with ``cfg.qk_norm`` q and k are RMS-normed
    over the head dim before RoPE.  Returns the mixer output."""
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
    q_pos = positions[0]                    # (S,)
    out = attention(q, k, v, q_pos=q_pos, k_pos=q_pos, causal=cfg.causal,
                    window=window, softcap_val=cfg.softcap_attn,
                    chunk_threshold=cfg.attn_chunk_threshold,
                    kv_chunk=cfg.attn_kv_chunk)
    if cfg.pad_attn_heads:
        # zero the padded heads' outputs, so the zero wo rows get no
        # gradient either
        out = out * pad_head_mask(cfg, x.device).reshape(H, hd).to(
            out.dtype)
    return matmul(out.reshape(tok + (H * hd,)), p["wo"])


# --------------------------------------------------------------------------
# dense FFN
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
